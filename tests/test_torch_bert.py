"""The port's BERT family against the JAX package's.

Tiny configs (2 layers, hidden 64, 4 heads, vocab 1024), sequences of 16
tokens with padded rows, weights drawn from a numpy seed into the flax
parameter tree and carried across with ``kubeflow_tpu_torch.convert``. The
JAX flash path runs its Pallas kernel in interpret mode on the CPU, as its
own tests run it; the port's runs its plain version (the card's kernels are
held against that in chip_smoke.py). f32 unless stated.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from kubeflow_tpu.models import bert as jb
from kubeflow_tpu.parallel import MeshConfig, build_mesh
from kubeflow_tpu.train import trainer as jt
from kubeflow_tpu_torch.convert import flax_params_from, params_from_flax
from kubeflow_tpu_torch.models import bert as tb
from kubeflow_tpu_torch.train import data as td
from kubeflow_tpu_torch.train import trainer as tt

try:  # one intra-op thread: the suite shares the machine with timing gates
    torch.set_num_threads(1)
    torch.set_num_interop_threads(1)
except RuntimeError:  # the interop pool can be sized once per process
    pass

L, BATCH = 16, 4
TOL = dict(atol=1e-4, rtol=1e-4)
TINY = dict(attention_block=8)


def token_ids(seed=0, n=BATCH):
    """Rows of 8-16 tokens, right-padded with 0 (synthetic_text_dataset's
    length law at seq 16)."""
    rng = np.random.RandomState(seed)
    x = rng.randint(1, 1024, (n, L)).astype(np.int32)
    for i in range(n):
        x[i, rng.randint(L // 2, L + 1):] = 0
    x[0, L // 2:] = 0  # one row half padding
    return x


def seeded_flat(jmodel, x, seed=0, std=0.3) -> dict:
    """The flax module's parameters, values from a numpy seed: weights
    N(0, std), biases N(0, 0.1), norm scales in [0.5, 1.5)."""
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


def pair(kind, attention="dense", **kw):
    """(JAX module, port module ctor) of one head at the tiny config."""
    jcfg = jb.BertConfig.tiny(attention=attention, **TINY, **kw)
    tcfg = tb.BertConfig.tiny(attention=attention, **TINY, **kw)
    if kind == "cls":
        return (jb.BertForSequenceClassification(jcfg, num_classes=3),
                lambda: tb.BertForSequenceClassification(tcfg, 3,
                                                         device="cpu"))
    return (jb.BertForMaskedLM(jcfg),
            lambda: tb.BertForMaskedLM(tcfg, device="cpu"))


def port(ctor, flat):
    m = ctor()
    m.load_state_dict(params_from_flax(flat, m))
    return m.eval()


@pytest.mark.parametrize("kind,attention", [
    (k, a) for k in ("cls", "mlm") for a in ("dense", "flash")])
def test_logits_match_jax(kind, attention):
    x = token_ids(1)
    jm, ctor = pair(kind, attention)
    flat = seeded_flat(pair(kind)[0], x)
    want = np.asarray(jax.jit(jm.apply)(as_params(flat), jnp.asarray(x)))
    model = port(ctor, flat)
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, **TOL)
    back = flax_params_from(model.state_dict())
    assert back.keys() == flat.keys()  # the MLM table once, at the top


def test_bf16_logits_within_8_ulps():
    x = token_ids(2)
    jm, ctor = pair("cls", dtype="bfloat16")
    jm = jb.BertForSequenceClassification(
        jb.BertConfig.tiny(dtype=jnp.bfloat16, **TINY), num_classes=3)
    flat = seeded_flat(jm, x)
    # flax's own rounding, op by op: under jit, XLA:CPU computes bf16 dots
    # in f32 and drops convert pairs, so its logits move by up to 7 ulps
    # from the module's definition (the bias added to the rounded product)
    want = np.asarray(jm.apply(as_params(flat), jnp.asarray(x)))
    model = port(ctor, flat)
    assert {p.dtype for p in model.parameters()} == {torch.float32}
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    ulps = np.abs(got - want).max() / (2.0 ** -8 * np.abs(want).max())
    print(f"bert bf16 logits: {ulps:.2f} ulps")
    assert ulps <= 8, ulps


def test_dense_attention_dropout_by_statistics():
    """The mask bits cannot match jax.random, so both sides are held by
    statistics at rate 0.1: each draw zeroes about a tenth of the
    probabilities and scales the rest by 1/0.9, and the mean over draws
    approaches the attention without dropout."""
    rng = np.random.RandomState(3)
    q, k, v = (rng.normal(0, 1, (2, L, 4, 16)).astype(np.float32)
               for _ in range(3))
    bias = np.zeros((2, 1, 1, L), np.float32)
    bias[1, ..., 12:] = -1e9
    tq, tk, tv, tbias = (torch.from_numpy(a) for a in (q, k, v, bias))
    exact = tb.dense_attention(tq, tk, tv, tbias).numpy()
    np.testing.assert_allclose(
        exact, np.asarray(jax.jit(jb.dense_attention)(
            *map(jnp.asarray, (q, k, v, bias)))),
        atol=1e-5)
    n, rate = 100, 0.1
    gen = torch.Generator().manual_seed(0)
    draws = np.stack([tb.dense_attention(tq, tk, tv, tbias, gen, rate).numpy()
                      for _ in range(n)])
    jdrawn = jax.jit(lambda key: jb.dense_attention(
        *map(jnp.asarray, (q, k, v, bias)), dropout_rng=key,
        dropout_rate=rate))
    jdraws = np.stack([np.asarray(jdrawn(key)) for key in
                       jax.random.split(jax.random.PRNGKey(0), n)])
    # the drop fraction of one draw's probabilities: ones through v = I
    eye = torch.eye(L)[None, :, None, :].expand(2, L, 4, L).contiguous()
    probs = tb.dense_attention(tq, tk, eye, tbias, gen, rate)
    live = torch.from_numpy(np.array(jax.nn.softmax(
        np.einsum("blhd,bmhd->bhlm", q, k) / 4 + bias, -1))
        ).permute(0, 2, 1, 3) > 1e-6
    dropped = ((probs == 0) & live).sum().item() / live.sum().item()
    sigma = np.sqrt(rate * (1 - rate) / live.sum().item())
    assert abs(dropped - rate) < 5 * sigma
    for d in (draws, jdraws):
        err = np.abs(d.mean(0) - exact).max()
        spread = d.std(0).max() / np.sqrt(n)
        assert err < 6 * spread, (err, spread)
        assert not np.allclose(d[0], exact)
    # the port's and JAX's draws spread alike
    np.testing.assert_allclose(draws.std(0).mean(), jdraws.std(0).mean(),
                               rtol=0.1)


def test_flash_with_dropout_raises_as_jax():
    x = token_ids(4)
    jm, ctor = pair("cls", "flash", dropout_rate=0.1)
    flat = seeded_flat(pair("cls")[0], x)
    with pytest.raises(NotImplementedError, match="dropout"):
        jax.eval_shape(lambda: jm.apply(
            as_params(flat), jnp.asarray(x), train=True,
            rngs={"dropout": jax.random.PRNGKey(0)}))
    model = port(ctor, flat)
    with pytest.raises(NotImplementedError, match="dropout"):
        model(torch.from_numpy(x), train=True,
              generator=torch.Generator().manual_seed(0))
    with torch.no_grad():  # eval runs no dropout
        assert model(torch.from_numpy(x)).shape == (BATCH, 3)


def test_train_forward_dropout_and_remat():
    """train=True draws its masks from the generator (same seed, same
    logits; another seed, others); remat recomputes each block with the
    same masks, so its grads equal the plain backward's."""
    x = torch.from_numpy(token_ids(5))
    cfg = tb.BertConfig.tiny(**TINY)
    model = tb.BertForSequenceClassification(cfg, 3, device="cpu"
                                             ).init_weights(
        torch.Generator().manual_seed(0))
    rematted = tb.BertForSequenceClassification(
        dataclasses.replace(cfg, remat=True), 3, device="cpu")
    rematted.load_state_dict(model.state_dict())

    def run(m, seed):
        m.zero_grad()
        out = m(x, train=True, generator=torch.Generator().manual_seed(seed))
        out.sum().backward()
        return out.detach(), [p.grad.clone() for p in m.parameters()]

    a, ga = run(model, 1)
    b, _ = run(model, 1)
    c, _ = run(model, 2)
    r, gr = run(rematted, 1)
    torch.testing.assert_close(a, b)
    assert not torch.allclose(a, c)
    torch.testing.assert_close(r, a)
    for u, w in zip(gr, ga):
        torch.testing.assert_close(u, w, atol=1e-6, rtol=1e-5)
    with pytest.raises(ValueError, match="needs a generator"):
        model(x, train=True)


def test_refusals_and_config():
    # the MoE encoder builds (tests/test_torch_moe.py)
    assert tb.BertEncoder(tb.BertConfig.tiny(moe_experts=4),
                          device="cpu").layer_0.moe.num_experts == 4
    # ring and Ulysses build and shard the sequence over an entered
    # context axis (tests/test_torch_context.py), where dense and flash
    # attention are refused
    from kubeflow_tpu_torch.parallel.mesh import ContextAxis, context_axis

    for kind in ("ring", "ulysses"):
        assert tb.BertEncoder(tb.BertConfig.tiny(attention=kind),
                              device="cpu").shards_sequence
    for kind in ("dense", "flash"):
        model = tb.BertEncoder(tb.BertConfig.tiny(attention=kind),
                               device="cpu")
        assert not model.shards_sequence
        with context_axis(ContextAxis(0, 2, None, (0, 1))), \
                pytest.raises(NotImplementedError, match="ring and ulysses"):
            model(torch.ones((1, 4), dtype=torch.long))
    with pytest.raises(ValueError, match="not divisible"):
        tb.BertConfig(hidden_size=100, num_heads=12)
    assert tb.BertConfig.base() == tb.BertConfig()
    for f in ("vocab_size", "hidden_size", "num_layers", "num_heads",
              "mlp_dim", "max_len", "dropout_rate", "pad_token_id"):
        for size in ("base", "tiny"):
            assert getattr(getattr(tb.BertConfig, size)(), f) == getattr(
                getattr(jb.BertConfig, size)(), f), (size, f)


def test_masked_lm_loss_and_metrics_match_jax():
    rng = np.random.RandomState(6)
    logits = rng.normal(0, 2, (3, L, 50)).astype(np.float32)
    labels = np.full((3, L), td.IGNORE_LABEL, np.int32)
    labels[0, :4] = rng.randint(0, 50, 4)
    labels[1, 5] = int(np.argmax(logits[1, 5]))  # one right guess
    # row 2: nothing masked
    jl, tl = jnp.asarray(logits), torch.from_numpy(logits)
    ja, ta = jnp.asarray(labels), torch.from_numpy(labels)
    assert float(tb.masked_lm_loss(tl, ta)) == pytest.approx(
        float(jax.jit(jb.masked_lm_loss)(jl, ja)), rel=1e-6)
    for got, want in zip(tb.masked_lm_eval_metrics(tl, ta),
                         jax.jit(jb.masked_lm_eval_metrics)(jl, ja)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                                   atol=1e-7)


def jax_state(jtr, flat):
    """The JAX Trainer's TrainState over given weights, placed on its mesh
    as its own steps leave it (so its step compiles once)."""
    from jax.sharding import NamedSharding, PartitionSpec

    params = as_params(flat)["params"]
    state = jt.TrainState(step=jnp.zeros((), jnp.int32), params=params,
                          opt_state=jtr.tx.init(params),
                          rng=jax.random.PRNGKey(0))
    return jax.device_put(state, NamedSharding(jtr.mesh, PartitionSpec()))


def test_trainer_steps_match_jax_trainer():
    """3 Trainer steps of the tiny classifier (dense, dropout 0) from
    BERT-scale weights (N(0, 0.05)), on the same batches of synthetic_text_dataset: losses and
    parameters within 1e-4 of the JAX Trainer's — all but the key
    projection's bias, whose gradient is 0 in exact arithmetic (softmax
    ignores a shift shared by a query's scores), so Adam turns each side's
    rounding into ±lr steps there."""
    steps = 3
    ds = td.synthetic_text_dataset(n_train=12, n_test=4, seq_len=L,
                                   vocab_size=1024, num_classes=3)
    jm, ctor = pair("cls", dropout_rate=0.0)
    flat = seeded_flat(jm, ds.x_train[:BATCH], seed=8, std=0.05)
    cfg = dict(batch_size=BATCH, steps=steps, learning_rate=1e-3)
    jtr = jt.Trainer(jm, jt.TrainerConfig(**cfg), mesh=build_mesh(
        MeshConfig(data=1), devices=jax.devices()[:1]))
    jstate = jax_state(jtr, flat)
    ttr = tt.Trainer(port(ctor, flat), tt.TrainerConfig(**cfg))
    tstate = ttr.init_state()
    for step, (bx, by) in enumerate(td.batches(ds.x_train, ds.y_train, BATCH,
                                               seed=0)):
        if step == steps:
            break
        jstate, jmet = jtr.train_step(jstate, (bx, by))
        tstate, tmet = ttr.train_step(tstate, (bx, by))
        for key in ("loss", "grad_norm", "accuracy"):
            assert float(tmet[key]) == pytest.approx(
                float(jmet[key]), rel=1e-4, abs=1e-4), (step, key)
    after = flax_params_from(tstate.model.state_dict())
    want = traverse_util.flatten_dict(jax.device_get(jstate.params), sep="/")
    assert want.keys() == after.keys()
    for k, v in want.items():
        if not k.endswith("attention/key/bias"):
            np.testing.assert_allclose(after[k], np.asarray(v), err_msg=k,
                                       **TOL)
    # AUTO on the card: bf16 compute over the same f32 parameters
    clone, dt = tt.Trainer.resolve_compute_dtype(
        tstate.model, tt.TrainerConfig(), device_type="cuda")
    assert dt == torch.bfloat16 and clone.cfg.dtype == "bfloat16"
    assert clone.pooler.kernel is tstate.model.pooler.kernel
