"""The port's MNIST models and ViT against the JAX package's.

Weights are the flax modules' parameter trees with values drawn from a numpy
seed, carried across with ``kubeflow_tpu_torch.convert``; inputs are seeded
numpy images. ViT is the tiny config (32² images, 8² patches: 17 tokens, a
ragged sequence for the flash path, whose JAX side runs its Pallas kernel
in interpret mode on the CPU).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from kubeflow_tpu.models import mnist as jmn
from kubeflow_tpu.models import vit as jv
from kubeflow_tpu.parallel import MeshConfig, build_mesh
from kubeflow_tpu.train import trainer as jt
from kubeflow_tpu_torch.convert import flax_params_from, params_from_flax
from kubeflow_tpu_torch.models import mnist as tmn
from kubeflow_tpu_torch.models import vit as tv
from kubeflow_tpu_torch.train import data as td
from kubeflow_tpu_torch.train import trainer as tt

try:  # one intra-op thread: the suite shares the machine with timing gates
    torch.set_num_threads(1)
    torch.set_num_interop_threads(1)
except RuntimeError:  # the interop pool can be sized once per process
    pass


def seeded_flat(jmodel, x, seed=0, std=0.2) -> dict:
    """The flax module's parameters, values from a numpy seed."""
    shapes = traverse_util.flatten_dict(jax.eval_shape(
        lambda: jmodel.init(jax.random.PRNGKey(0), jnp.asarray(x)))
        ["params"], sep="/")
    rng = np.random.RandomState(seed)
    out = {}
    for k, v in sorted(shapes.items()):
        if k.endswith("scale"):
            a = rng.uniform(0.5, 1.5, v.shape)
        else:
            a = rng.normal(0, 0.1 if k.endswith("bias") else std, v.shape)
        out[k] = a.astype(np.float32)
    return out


def as_params(flat):
    return {"params": traverse_util.unflatten_dict(
        {k: jnp.asarray(v) for k, v in flat.items()}, sep="/")}


def port(model, flat):
    model.load_state_dict(params_from_flax(flat, model))
    return model.eval()


def images(shape, seed=1):
    return np.random.RandomState(seed).normal(0, 1, shape).astype(np.float32)


@pytest.mark.parametrize("kind,shape", [
    ("mlp", (3, 64)), ("mlp", (3, 28, 28, 1)),
    ("cnn", (3, 28, 28, 1)), ("cnn", (3, 64))])
def test_mnist_logits_match_jax(kind, shape):
    x = images(shape)
    if kind == "mlp":
        jm = jmn.MnistMLP()
        tm = tmn.MnistMLP(int(np.prod(shape[1:])), device="cpu")
    else:
        jm = jmn.MnistCNN()
        tm = tmn.MnistCNN(shape[1:], device="cpu")
    flat = seeded_flat(jm, x)
    want = np.asarray(jax.jit(jm.apply)(as_params(flat), jnp.asarray(x)))
    model = port(tm, flat)
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    assert got.shape == (3, 10) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    assert flax_params_from(model.state_dict()).keys() == flat.keys()


@pytest.mark.parametrize("attention,dtype", [
    ("dense", "float32"), ("flash", "float32"), ("dense", "bfloat16")])
def test_vit_logits_match_jax(attention, dtype):
    x = images((2, 32, 32, 3), seed=2)
    jcfg = jv.ViTConfig.tiny(attention=attention, dtype=getattr(jnp, dtype),
                             attention_block=8)
    flat = seeded_flat(jv.ViTClassifier(jv.ViTConfig.tiny()), x)
    want = np.asarray(jv.ViTClassifier(jcfg).apply(as_params(flat),
                                                   jnp.asarray(x)))
    model = port(tv.ViTClassifier(tv.ViTConfig.tiny(
        attention=attention, dtype=dtype, attention_block=8), device="cpu"),
        flat)
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    assert got.shape == (2, 10) and got.dtype == np.float32
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)
    else:  # bf16 compute: within 8 bf16 ulps of the largest logit
        ulps = np.abs(got - want).max() / (2.0 ** -8 * np.abs(want).max())
        print(f"vit bf16 logits: {ulps:.2f} ulps")
        assert ulps <= 8, ulps


def test_vit_config_and_refusals():
    for size in ("base", "tiny"):
        j, t = getattr(jv.ViTConfig, size)(), getattr(tv.ViTConfig, size)()
        for f in ("image_size", "patch_size", "num_classes", "hidden_size",
                  "num_layers", "num_heads", "mlp_dim", "dropout_rate"):
            assert getattr(t, f) == getattr(j, f), (size, f)
        assert t.num_patches == j.num_patches
        assert t.encoder_config().max_len == j.encoder_config().max_len
    assert tv.ViTConfig.base().num_patches + 1 == 197
    with pytest.raises(ValueError, match="not divisible"):
        tv.ViTConfig(image_size=30, patch_size=8)
    with pytest.raises(ValueError, match="dense|flash"):
        tv.ViTClassifier(tv.ViTConfig.tiny(attention="ring"), device="cpu")
    model = tv.ViTClassifier(tv.ViTConfig.tiny(), device="cpu").init_weights(
        torch.Generator().manual_seed(0))
    assert not model.cls_token.detach().any()
    with pytest.raises(ValueError, match="expected 32x32"):
        model(torch.zeros(1, 16, 16, 3))
    # train mode draws dropout from the generator
    x = torch.from_numpy(images((2, 32, 32, 3)))
    a, b = (model(x, train=True, generator=torch.Generator().manual_seed(s))
            for s in (0, 1))
    assert not torch.allclose(a, b)


def jax_state(jtr, flat):
    """The JAX Trainer's TrainState over given weights, placed on its mesh
    as its own steps leave it (so its step compiles once)."""
    from jax.sharding import NamedSharding, PartitionSpec

    params = as_params(flat)["params"]
    state = jt.TrainState(step=jnp.zeros((), jnp.int32), params=params,
                          opt_state=jtr.tx.init(params),
                          rng=jax.random.PRNGKey(0))
    return jax.device_put(state, NamedSharding(jtr.mesh, PartitionSpec()))


def test_mlp_trainer_steps_match_jax_trainer():
    """3 Trainer steps of MnistMLP on synthetic 8x8 digits: losses and
    parameters within 1e-4 of the JAX Trainer's; AUTO stays float32 (the
    model prefers no compute dtype)."""
    steps, batch = 3, 8
    ds = td.synthetic_image_dataset(n_train=24, n_test=8, shape=(64,))
    jm = jmn.MnistMLP()
    flat = seeded_flat(jm, ds.x_train[:batch], seed=4, std=0.1)
    cfg = dict(batch_size=batch, steps=steps, learning_rate=1e-3)
    jtr = jt.Trainer(jm, jt.TrainerConfig(**cfg), mesh=build_mesh(
        MeshConfig(data=1), devices=jax.devices()[:1]))
    jstate = jax_state(jtr, flat)
    ttr = tt.Trainer(port(tmn.MnistMLP(64, device="cpu"), flat),
                     tt.TrainerConfig(**cfg))
    tstate = ttr.init_state()
    for step, (bx, by) in enumerate(td.batches(ds.x_train, ds.y_train, batch,
                                               seed=0)):
        if step == steps:
            break
        jstate, jmet = jtr.train_step(jstate, (bx, by))
        tstate, tmet = ttr.train_step(tstate, (bx, by))
        for key in ("loss", "grad_norm", "accuracy"):
            assert float(tmet[key]) == pytest.approx(
                float(jmet[key]), rel=1e-4, abs=1e-4), (step, key)
    after = flax_params_from(tstate.model.state_dict())
    for k, v in traverse_util.flatten_dict(jax.device_get(jstate.params),
                                           sep="/").items():
        np.testing.assert_allclose(after[k], np.asarray(v), atol=1e-4,
                                   rtol=1e-4, err_msg=k)
    _, dt = tt.Trainer.resolve_compute_dtype(tstate.model, tt.TrainerConfig(),
                                             device_type="cuda")
    assert dt == torch.float32
