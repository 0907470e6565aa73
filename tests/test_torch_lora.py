"""The port's LoRA (train/lora.py) against the JAX package's.

The counterparts of tests/test_lora.py's numerics, training, optimizer
state, attention-kernel and checkpoint tests, for the BERT classifier, ViT
and the GPT decoder alike: tiny configs, base weights drawn from a numpy
seed into the flax tree and carried across with
``kubeflow_tpu_torch.convert``, the same adapters (flax paths) on both
sides. f32, dropout 0; logits and 3 Trainer steps within 1e-4.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from kubeflow_tpu.models import bert as jb
from kubeflow_tpu.models import gpt as jg
from kubeflow_tpu.models import vit as jv
from kubeflow_tpu.parallel import MeshConfig, build_mesh
from kubeflow_tpu.train import lora as jl
from kubeflow_tpu.train import trainer as jt
from kubeflow_tpu_torch.convert import gpt_params_from_flax, params_from_flax
from kubeflow_tpu_torch.models import bert as tb
from kubeflow_tpu_torch.models import gpt as tg
from kubeflow_tpu_torch.models import vit as tv
from kubeflow_tpu_torch.train import lora as tl
from kubeflow_tpu_torch.train import trainer as tt
from kubeflow_tpu_torch.train.checkpoint import Checkpointer

try:  # one intra-op thread: the suite shares the machine with timing gates
    torch.set_num_threads(1)
    torch.set_num_interop_threads(1)
except RuntimeError:  # the interop pool can be sized once per process
    pass

TOL = dict(atol=1e-4, rtol=1e-4)
BATCH, RANK = 4, 4
FAMILIES = ("bert", "vit", "gpt")


def family(name, **kw):
    """(JAX module, port module built on the CPU, inputs (8 rows), labels,
    JAX loss, port loss) of one family at its tiny config, dropout 0."""
    rng = np.random.RandomState(3)
    if name == "bert":
        x = rng.randint(1, 1024, (2 * BATCH, 16)).astype(np.int32)
        x[0, 10:] = 0
        y = rng.randint(0, 3, 2 * BATCH).astype(np.int32)
        return (jb.BertForSequenceClassification(
                    jb.BertConfig.tiny(dropout_rate=0.0), num_classes=3),
                tb.BertForSequenceClassification(
                    tb.BertConfig.tiny(dropout_rate=0.0, **kw), 3,
                    device="cpu"),
                x, y, jt.cross_entropy_loss, tt.cross_entropy_loss)
    if name == "vit":
        x = rng.normal(0, 1, (2 * BATCH, 32, 32, 3)).astype(np.float32)
        y = rng.randint(0, 10, 2 * BATCH).astype(np.int32)
        return (jv.ViTClassifier(jv.ViTConfig.tiny(dropout_rate=0.0)),
                tv.ViTClassifier(tv.ViTConfig.tiny(dropout_rate=0.0, **kw),
                                 device="cpu"),
                x, y, jt.cross_entropy_loss, tt.cross_entropy_loss)
    cfg = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=2,
               mlp_dim=64, max_len=16, dropout_rate=0.0)
    x = rng.randint(1, 64, (2 * BATCH, 16)).astype(np.int32)
    return (jg.GPTLM(jg.GPTConfig.tiny(**cfg)),
            tg.GPTLM(tg.GPTConfig.tiny(**cfg, **kw), device="cpu"),
            x, x, jg.causal_lm_loss, tg.causal_lm_loss)


def seeded_flat(jmodel, x, seed=0, std=0.1) -> dict:
    """The flax module's parameters, from a numpy seed: weights N(0, std),
    biases N(0, 0.05), norm scales in [0.5, 1.5)."""
    shapes = traverse_util.flatten_dict(jax.eval_shape(
        lambda: jmodel.init(jax.random.PRNGKey(0), jnp.asarray(x)))
        ["params"], sep="/")
    rng = np.random.RandomState(seed)
    out = {}
    for k, v in sorted(shapes.items()):
        if k.endswith("scale"):
            a = rng.uniform(0.5, 1.5, v.shape)
        else:
            a = rng.normal(0, 0.05 if k.endswith("bias") else std, v.shape)
        out[k] = a.astype(np.float32)
    return out


def load_port(module, flat):
    sd = (gpt_params_from_flax(flat, module.cfg)
          if isinstance(module, tg.GPTLM) else params_from_flax(flat, module))
    module.load_state_dict(sd)
    return module


def seeded_adapters(lora: tl.LoraModel, seed=1) -> dict:
    """Non-zero adapters (A and B both N(0, 0.02)) written into the port's
    model; returned by flax path for the JAX side."""
    rng = np.random.RandomState(seed)
    out = {}
    with torch.no_grad():
        for path, p in lora.lora.items():
            a = rng.normal(0, 0.02, tuple(p.shape)).astype(np.float32)
            p.copy_(torch.from_numpy(a))
            out[path] = a
    return out


def jax_variables(flat, adapters) -> dict:
    return {"params": {
        "base": traverse_util.unflatten_dict(
            {k: jnp.asarray(v) for k, v in flat.items()}, sep="/"),
        "lora": traverse_util.unflatten_dict(
            {k: jnp.asarray(v) for k, v in adapters.items()}, sep="/")}}


def pair(name, **kw):
    jm, tm, x, y, jloss, tloss = family(name, **kw)
    flat = seeded_flat(jm, x)
    base = load_port(tm, flat)
    lora = tl.LoraModel(base, rank=RANK,
                        generator=torch.Generator().manual_seed(0))
    return jm, lora, flat, x, y, jloss, tloss


@pytest.mark.parametrize("name", FAMILIES)
def test_zero_init_matches_base_model(name):
    """B = 0 at init: the adapted model is the base model, bit for bit;
    A is N(0, 0.02) and B zero, in the JAX package's shapes."""
    jm, lora, flat, x, *_ = pair(name)
    xt = torch.from_numpy(x)
    with torch.no_grad():
        assert torch.equal(lora(xt), lora.base(xt))
    jlora = jl.LoraModel(jm, rank=RANK)
    jvars = jax.eval_shape(lambda: jlora.init(jax.random.PRNGKey(0),
                                              jnp.asarray(x)))
    want = traverse_util.flatten_dict(jvars["params"]["lora"], sep="/")
    assert {k: tuple(v.shape) for k, v in want.items()} == {
        k: tuple(p.shape) for k, p in lora.lora.items()}
    a = torch.cat([p.flatten() for k, p in lora.lora.items()
                   if k.endswith("lora_a")])
    assert abs(a.std().item() - 0.02) < 2e-3
    assert not any(p.any() for k, p in lora.lora.items()
                   if k.endswith("lora_b"))


@pytest.mark.parametrize("name", FAMILIES)
def test_adapted_logits_match_jax(name):
    """The same non-zero adapters on the same base: logits within 1e-4 of
    the JAX LoraModel's; lora_merge of the flax trees equals
    merged_params in the port's layout."""
    jm, lora, flat, x, *_ = pair(name)
    adapters = seeded_adapters(lora)
    jlora = jl.LoraModel(jm, rank=RANK)
    want = np.asarray(jax.jit(jlora.apply)(jax_variables(flat, adapters),
                                           jnp.asarray(x)))
    with torch.no_grad():
        got = lora(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    merged = tl.lora_merge({k: torch.from_numpy(v) for k, v in flat.items()},
                           {k: torch.from_numpy(v)
                            for k, v in adapters.items()}, lora.alpha)
    jmerged = traverse_util.flatten_dict(jl.lora_merge(
        jax_variables(flat, adapters)["params"]["base"],
        jax_variables(flat, adapters)["params"]["lora"], lora.alpha),
        sep="/")
    for k, v in jmerged.items():
        np.testing.assert_allclose(merged[k].numpy(), np.asarray(v),
                                   atol=1e-6, err_msg=k)
    # merged(): a plain base module with the deltas folded in
    plain = lora.merged()
    with torch.no_grad():
        np.testing.assert_allclose(plain(torch.from_numpy(x)).numpy(), got,
                                   atol=1e-5)
    assert all(p.requires_grad for p in plain.parameters())
    assert not any(p.requires_grad for p in lora.base.parameters())


@pytest.mark.parametrize("name", FAMILIES)
def test_adapter_count_is_small(name):
    _, lora, flat, *_ = pair(name)
    n_base = sum(v.size for v in flat.values())
    n_lora = sum(p.numel() for p in lora.lora.values())
    assert 0 < n_lora < n_base / 5, (n_lora, n_base)


def test_attention_kernels_are_adapted():
    """DenseGeneral q/k/v ((in, H, D)) and attn_out ((H, D, out)) adapt via
    their logical (in, out) flattening; GPT's (out, in) weights get the
    same adapter shapes from their flax paths."""
    _, lora, *_ = pair("bert")
    att = "encoder/layer_0/attention/"
    assert lora.lora[att + "query/kernel/lora_a"].shape == (64, RANK)
    assert lora.lora[att + "query/kernel/lora_b"].shape == (RANK, 64)
    assert lora.lora[att + "attn_out/kernel/lora_a"].shape == (64, RANK)
    assert lora.lora[att + "attn_out/kernel/lora_b"].shape == (RANK, 64)
    _, glora, *_ = pair("gpt")
    assert glora.lora["layer_1/mlp_up/kernel/lora_a"].shape == (32, RANK)
    assert glora.lora["layer_1/mlp_up/kernel/lora_b"].shape == (RANK, 64)
    assert "token_embed/embedding/lora_a" not in glora.lora
    with pytest.raises(ValueError, match="no kernels matched"):
        tl.LoraModel(glora.base, targets="nothing$",
                     generator=torch.Generator())


def jax_trainer(jlora, cfg, jloss):
    mesh = build_mesh(MeshConfig(data=1), devices=jax.devices()[:1])
    return jt.Trainer(jlora, jt.TrainerConfig(**cfg), tx=jl.lora_tx,
                      loss_fn=jloss, mesh=mesh)


def jax_state(jtr, variables):
    from jax.sharding import NamedSharding, PartitionSpec

    params = variables["params"]
    state = jt.TrainState(step=jnp.zeros((), jnp.int32), params=params,
                          opt_state=jtr.tx.init(params),
                          rng=jax.random.PRNGKey(0))
    return jax.device_put(state, NamedSharding(jtr.mesh, PartitionSpec()))


@pytest.mark.parametrize("name", FAMILIES)
def test_trainer_steps_match_jax_trainer(name):
    """3 Trainer steps of the adapted model against JAX
    Trainer(lora, tx=lora_tx): losses and adapters within 1e-4, the base
    bit-unchanged, and the optimizer holding state for the adapters
    only."""
    jm, lora, flat, x, y, jloss, tloss = pair(name)
    adapters = seeded_adapters(lora)
    base_before = {k: v.clone() for k, v in lora.base.state_dict().items()}
    cfg = dict(batch_size=BATCH, steps=3, learning_rate=1e-3)
    jtr = jax_trainer(jl.LoraModel(jm, rank=RANK), cfg, jloss)
    jstate = jax_state(jtr, jax_variables(flat, adapters))
    ttr = tt.Trainer(lora, tt.TrainerConfig(**cfg), loss_fn=tloss)
    tstate = ttr.init_state()
    held = {id(p) for p in tstate.optimizer.param_groups[0]["params"]}
    assert held == {id(p) for p in lora.lora.values()}
    for step in range(3):
        rows = slice((step % 2) * BATCH, (step % 2 + 1) * BATCH)
        jstate, jmet = jtr.train_step(jstate, (x[rows], y[rows]))
        tstate, tmet = ttr.train_step(tstate, (x[rows], y[rows]))
        assert float(tmet["loss"]) == pytest.approx(
            float(jmet["loss"]), rel=1e-4, abs=1e-4), step
    want = traverse_util.flatten_dict(
        jax.device_get(jstate.params["lora"]), sep="/")
    for k, v in want.items():
        np.testing.assert_allclose(lora.lora[k].detach().numpy(),
                                   np.asarray(v), err_msg=k, **TOL)
    assert not all(np.array_equal(lora.lora[k].detach().numpy(), adapters[k])
                   for k in adapters)
    for k, v in lora.base.state_dict().items():
        assert torch.equal(v, base_before[k]), k
    # Adam's moments exist for the adapters only
    n_lora = sum(p.numel() for p in lora.lora.values())
    n_opt = sum(t.numel() for st in tstate.optimizer.state.values()
                for t in st.values() if torch.is_tensor(t) and t.ndim)
    assert n_opt == 2 * n_lora


def test_checkpoint_round_trip(tmp_path):
    """The adapted model's state (base and adapters) and its adapter-only
    optimizer state survive a checkpoint save and restore."""
    _, lora, flat, x, y, _, tloss = pair("bert")
    cfg = tt.TrainerConfig(batch_size=BATCH, steps=1, learning_rate=1e-3)
    ttr = tt.Trainer(lora, cfg, loss_fn=tloss)
    state, _ = ttr.train_step(ttr.init_state(), (x[:BATCH], y[:BATCH]))
    Checkpointer(str(tmp_path)).save(1, state)
    _, other, *_ = pair("bert")
    fresh = tt.Trainer(other, cfg, loss_fn=tloss)
    step, restored = Checkpointer(str(tmp_path)).restore_latest(
        fresh.init_state())
    assert step == 1
    for (k, a), b in zip(state.model.state_dict().items(),
                         restored.model.state_dict().values()):
        assert torch.equal(a, b), k
    for a, b in zip(state.optimizer.state.values(),
                    restored.optimizer.state.values()):
        assert all(torch.equal(a[key], b[key]) for key in a)


@pytest.mark.parametrize("name", ("bert", "gpt"))
def test_remat_grads_equal_with_dropout(name):
    """remat recomputes each block over the merged weights (not the base's)
    and redraws its dropout masks from its seed: the adapters' grads with
    remat equal those without, under dropout."""
    grads = []
    for remat in (False, True):
        jm, tm, x, y, _, tloss = family(name, remat=remat)
        base = load_port(tm, seeded_flat(jm, x))
        base.cfg = dataclasses.replace(base.cfg, dropout_rate=0.2)
        for m in base.modules():
            if hasattr(m, "cfg"):
                m.cfg = base.cfg if name == "gpt" else dataclasses.replace(
                    m.cfg, dropout_rate=0.2)
        lora = tl.LoraModel(base, rank=RANK,
                            generator=torch.Generator().manual_seed(0))
        seeded_adapters(lora)
        loss = tloss(lora(torch.from_numpy(x), train=True,
                          generator=torch.Generator().manual_seed(7)),
                     torch.from_numpy(y))
        loss.backward()
        grads.append({k: p.grad.clone() for k, p in lora.lora.items()})
    for k, g in grads[0].items():
        torch.testing.assert_close(grads[1][k], g, atol=0, rtol=1e-5,
                                   msg=k)
        assert g.abs().max() > 0, k
