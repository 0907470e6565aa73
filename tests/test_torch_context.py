"""Context-parallel attention and training through the port on the CPU.

Blockwise attention's FA2 custom backward against the JAX package's
(f32 forward 1e-5 and grads 1e-4; bf16 custom against autodiff at the JAX
package's 6e-2/5e-2) and ``KFT_BLOCKWISE_VJP``'s import-time check. One
gloo gang (``tests/torch_gang.py``), a module fixture, of 4 processes:

  - as a world of 4: ring and Ulysses on context=4 under a window that
    shortens the ring to 2 hops of 4, GPT-tiny ring and Ulysses fits on
    data=2 x context=2, and ``process_local`` shards and fit under it;
  - then ranks 0 and 1 as a world of 2: ring and Ulysses attention on
    context=2 (causal, window, rope inside, padded bias; the ring's
    autodiff backward), GPT-tiny fits with ring, Ulysses, ring + rope and
    ring + dropout under remat, and BERT-tiny classifier and MLM fits with
    ring.

Attention is held against the JAX function on a virtual CPU mesh of the
same shape and against dense attention (forward 2e-5, grads 1e-4); every
fit's 3 steps' losses, accuracies and grad norms against the JAX Trainer
on the same virtual mesh (1e-4) and one process (1e-5), with pad rows in
the batches, and a spy shows each rank's attention saw L/ctx positions.
A ring-configured GPT served by the port's engine gives the JAX engine's
greedy tokens.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from kubeflow_tpu_torch.models import bert as tb
from kubeflow_tpu_torch.models import gpt as tg
from kubeflow_tpu_torch.parallel import ring_attention as tra
from kubeflow_tpu_torch.parallel.mesh import MeshConfig, build_mesh, \
    context_axis
from kubeflow_tpu_torch.parallel.sharding import context_axis_of
from kubeflow_tpu_torch.runtime import distributed as rd
from kubeflow_tpu_torch.train import data as td
from kubeflow_tpu_torch.train import trainer as tt
from tests.torch_gang import ROOT, free_port, run_gang

try:  # one intra-op thread: the suite shares the machine with timing gates
    torch.set_num_threads(1)
    torch.set_num_interop_threads(1)
except RuntimeError:  # the interop pool can be sized once per process
    pass

FWD_TOL = dict(atol=2e-5, rtol=0)      # tests/test_ring_attention.py's
GRAD_TOL = dict(atol=1e-4, rtol=0)
JAX_TOL = dict(atol=1e-4, rtol=1e-4)   # a fit against the JAX Trainer
ONE_TOL = dict(atol=1e-5, rtol=1e-5)   # a gang fit against one process

# ----------------------------------------------------------- the inputs

AB, AL, AH, AD = 2, 16, 4, 8
# the second row's last keys carry the -1e9 pad bias; every query keeps a
# key without it under each window (a query that sees none gets a
# tiling-dependent answer in both packages)
PAD_KEYS = 2
ATTN_BLOCK = 4
ROPE = 10000.0
#: (name, keyword arguments) of the attention cases on context=2
ATTN_CASES = (("causal", dict(causal=True)),
              ("window", dict(causal=True, window=5)),
              ("rope", dict(causal=True, rope_theta=ROPE)),
              ("padded", dict(causal=False)))
#: on context=4 (4 positions a rank) a window of 3 needs 2 hops of 4
RING4_CASES = (("window", dict(causal=True, window=3)),)

BATCH, STEPS, SEQ, VOCAB = 8, 3, 16, 64
GPT_TINY = dict(vocab_size=VOCAB, hidden_size=64, num_layers=2,
                num_heads=4, mlp_dim=128, max_len=SEQ, dropout_rate=0.0,
                attention_block=8)
BERT_TINY = dict(vocab_size=256, max_len=SEQ, dropout_rate=0.0,
                 attention_block=8)
GPT_KINDS = {"ring": dict(attention="ring"),
             "ulysses": dict(attention="ulysses"),
             "ring_rope": dict(attention="ring", position_embedding="rope"),
             "ring_dropout_remat": dict(attention="ring", dropout_rate=0.1,
                                        remat=True)}
MESHES = {"c2": MeshConfig(data=1, context=2),
          "d2c2": MeshConfig(data=2, context=2)}


def attn_inputs(seed=0):
    rng = np.random.RandomState(seed)
    q, k, v, w = (rng.normal(0, 1, (AB, AL, AH, AD)).astype(np.float32)
                  for _ in range(4))
    bias = np.zeros((AB, 1, 1, AL), np.float32)
    bias[1, ..., AL - PAD_KEYS:] = -1e9
    return q, k, v, bias, w


def lm_data() -> td.Dataset:
    """synthetic_lm_dataset's rows with pad tails: in each batch of 8 three
    rows end early, so the ranks' weighted counts differ."""
    ds = td.synthetic_lm_dataset(n_train=BATCH * STEPS, n_test=BATCH,
                                 seq_len=SEQ, vocab_size=VOCAB)
    x_tr, x_te = ds.x_train.copy(), ds.x_test.copy()
    rng = np.random.RandomState(5)
    for x in (x_tr, x_te):
        for i in range(0, len(x), BATCH):
            for r in rng.choice(BATCH, 3, replace=False):
                x[i + r, rng.randint(4, SEQ - 1):] = 0
    return td.Dataset(x_tr, x_tr.copy(), x_te, x_te.copy(),
                      num_classes=VOCAB)


def text_data(kind: str) -> td.Dataset:
    """synthetic_text_dataset's padded rows; for "mlm" the masked tokens
    and their labels (mask_tokens_for_mlm)."""
    ds = td.synthetic_text_dataset(n_train=BATCH * STEPS, n_test=BATCH,
                                   seq_len=SEQ, vocab_size=255,
                                   num_classes=3)
    if kind == "cls":
        return ds
    x_tr, y_tr = td.mask_tokens_for_mlm(ds.x_train, 255, 255, seed=1)
    x_te, y_te = td.mask_tokens_for_mlm(ds.x_test, 255, 255, seed=2)
    return td.Dataset(x_tr, y_tr, x_te, y_te, num_classes=256)


def global_batches(ds: td.Dataset):
    return [(ds.x_train[i * BATCH:(i + 1) * BATCH],
             ds.y_train[i * BATCH:(i + 1) * BATCH]) for i in range(STEPS)]


def gpt_model(kind: str):
    return tg.GPTLM(tg.GPTConfig.tiny(**{**GPT_TINY, **GPT_KINDS[kind]}),
                    device="cpu").init_weights(
        torch.Generator().manual_seed(0))


def bert_model(kind: str, attention: str = "ring"):
    cfg = tb.BertConfig.tiny(attention=attention, **BERT_TINY)
    model = (tb.BertForSequenceClassification(cfg, 3, device="cpu")
             if kind == "cls" else tb.BertForMaskedLM(cfg, device="cpu"))
    return model.init_weights(torch.Generator().manual_seed(0))


def trainer_for(family: str, kind: str, mesh=None, **kw):
    if family == "gpt":
        model = gpt_model(kind)
        fns = dict(loss_fn=tg.causal_lm_loss,
                   eval_metrics_fn=tg.causal_lm_eval_metrics)
    elif kind == "mlm":
        model = bert_model(kind)
        fns = dict(loss_fn=tb.masked_lm_loss,
                   eval_metrics_fn=tb.masked_lm_eval_metrics)
    else:
        model = bert_model(kind)
        fns = {}
    return tt.Trainer(model, tt.TrainerConfig(**{
        "batch_size": BATCH, "steps": STEPS, "log_every_steps": 1,
        "mesh": mesh, **kw}), **fns)


def data_for(family: str, kind: str) -> td.Dataset:
    return lm_data() if family == "gpt" else text_data(kind)


def stepped(trainer, batches, state=None):
    """The steps' (loss, accuracy, grad norm) rows and the final state, of
    the port's Trainer or the JAX package's."""
    state = state or trainer.init_state()
    rows = []
    for b in batches:
        state, m = trainer.train_step(state, b)
        rows.append([float(m["loss"]), float(m["accuracy"]),
                     float(m["grad_norm"])])
    return state, rows


# ------------------------------------------------------------ the gangs


def spy_lengths(seen: list) -> None:
    """Record the sequence length of every ring/Ulysses call's q."""
    for name in ("ring_attention", "ulysses_attention"):
        fn = getattr(tra, name)

        def spy(q, *a, _fn=fn, **kw):
            seen.append(q.shape[1])
            return _fn(q, *a, **kw)

        setattr(tra, name, spy)


def attention_results(mesh_cfg: MeshConfig, cases) -> dict:
    """Every case's (out, dq, dk, dv, dbias) of this rank's chunk."""
    axis = context_axis_of(build_mesh(mesh_cfg))

    def chunk(t):  # positions: dim 1 of q/k/v/w, the key dim of the bias
        dim = 1 if t.shape[1] == AL else -1
        return t.chunk(axis.size, dim=dim)[axis.index]

    q, k, v, bias, w = (torch.from_numpy(a) for a in attn_inputs())
    out = {}
    runs = [(kind, name, kw) for kind in ("ring", "ulysses")
            for name, kw in cases]
    if mesh_cfg.context == 2:
        runs.append(("ring", "autodiff", dict(causal=True, vjp="autodiff")))
    for kind, name, kw in runs:
        fn = getattr(tra, f"{kind}_attention")
        leaves = [chunk(t).clone().requires_grad_() for t in (q, k, v)]
        leaves.append(chunk(bias).clone().requires_grad_())
        with context_axis(axis):
            o = fn(*leaves, block=ATTN_BLOCK, **kw)
            (o * chunk(w)).sum().backward()
        out[(kind, name)] = [o.detach()] + [t.grad for t in leaves]
    return out


def fit_rows(family: str, kind: str, mesh_cfg: MeshConfig) -> tuple:
    """3 steps' rows and the final state's eval of one fit on the gang."""
    ds = data_for(family, kind)
    trainer = trainer_for(family, kind, mesh_cfg)
    state, rows = stepped(trainer, global_batches(ds))
    ev = trainer.evaluate(state, ds)
    return rows, [ev["loss"], ev["accuracy"]]


def refusals(rank) -> dict:
    """What a context gang refuses, message by message."""
    got = {}
    mesh = MeshConfig(data=1, context=2)
    cases = {
        "dense": lambda: tt.Trainer(
            tg.GPTLM(tg.GPTConfig.tiny(**GPT_TINY), device="cpu"),
            tt.TrainerConfig(mesh=mesh)),
        "moe": lambda: tt.Trainer(
            tg.GPTLM(tg.GPTConfig.tiny(**GPT_TINY, attention="ring",
                                       moe_experts=2), device="cpu"),
            tt.TrainerConfig(mesh=mesh)),
        "mixed": lambda: tt.Trainer(gpt_model("ring"), tt.TrainerConfig(
            mesh=mesh), loss_fn=tg.causal_lm_loss),
        "model": lambda: tt.Trainer(gpt_model("ring"), tt.TrainerConfig(
            mesh=MeshConfig(data=1, context=2, model=2))),
    }
    for name, make in cases.items():
        try:
            make()
            got[name] = None
        except (NotImplementedError, ValueError) as e:
            got[name] = f"{type(e).__name__}: {e}"
    axis = context_axis_of(build_mesh(mesh))
    x = torch.ones((2, SEQ // 2), dtype=torch.long)
    dense = tg.GPTLM(tg.GPTConfig.tiny(**GPT_TINY), device="cpu")
    ring = gpt_model("ring")
    for name, call in (("dense_forward", lambda: dense(x)),
                       ("decode", lambda: ring(x, cache=ring.init_cache(2),
                                               prefill=True))):
        try:
            with context_axis(axis):
                call()
            got[name] = None
        except NotImplementedError as e:
            got[name] = str(e)
    return got


def gang_main(out, rank):
    """The world of 4, then ranks 0 and 1 as a world of 2 (one launch)."""
    rd.initialize_from_env(backend="gloo", timeout_s=60)
    seen: list = []
    spy_lengths(seen)
    res = {("attention", 4): attention_results(
        MeshConfig(data=1, context=4), RING4_CASES)}
    for kind in ("ring", "ulysses"):
        seen.clear()
        res[("gpt", kind, "d2c2")] = fit_rows("gpt", kind, MESHES["d2c2"])
        res[("seen", "gpt", kind, "d2c2")] = sorted(set(seen))
    shards = td.load_dataset_shards(str(out / "shards"),
                                    mesh=MESHES["d2c2"])
    res["shards"] = shards.x_train
    trainer = trainer_for("gpt", "ring", MESHES["d2c2"],
                          data_placement="process_local", async_loader=False)
    res["process_local"] = trainer.fit(shards)[1]["loss"]
    rd.shutdown()
    if rank >= 2:
        return res
    os.environ.update(WORLD_SIZE="2", MASTER_PORT=os.environ["CTX2_PORT"])
    rd.initialize_from_env(backend="gloo", timeout_s=60)
    res[("attention", 2)] = attention_results(MeshConfig(data=1, context=2),
                                              ATTN_CASES)
    for kind in GPT_KINDS:
        seen.clear()
        res[("gpt", kind, "c2")] = fit_rows("gpt", kind, MESHES["c2"])
        res[("seen", "gpt", kind, "c2")] = sorted(set(seen))
    for kind in ("cls", "mlm"):
        seen.clear()
        res[("bert", kind, "c2")] = fit_rows("bert", kind, MESHES["c2"])
        res[("seen", "bert", kind, "c2")] = sorted(set(seen))
    res["refusals"] = refusals(rank)
    rd.shutdown()
    return res


@pytest.fixture(scope="module")
def gang(tmp_path_factory):
    """(the shards' directory, the 4 ranks' results); the world of 2's
    results are ranks 0 and 1's."""
    from kubeflow_tpu.train import data as jd

    out = tmp_path_factory.mktemp("ctx")
    jd.save_dataset_shards(lm_data(), str(out / "shards"), num_shards=4)
    port2 = str(free_port())
    return out, run_gang("tests.test_torch_context", "gang_main", out,
                         world=4, extra_env=lambda r: {"CTX2_PORT": port2})


@pytest.fixture(scope="module")
def gang2(gang):
    return gang[1][:2]


# ----------------------------------------------------- the JAX side


def jax_attention(kind, kw, n, cpu_devices):
    """(out, dq, dk, dv, dbias) of the JAX function on a virtual mesh of
    context n."""
    import functools

    import jax
    import jax.numpy as jnp

    from kubeflow_tpu.parallel import MeshConfig as JMesh
    from kubeflow_tpu.parallel import build_mesh as jbuild
    from kubeflow_tpu.parallel import ring_attention as jra

    q, k, v, bias, w = (jnp.asarray(a) for a in attn_inputs())
    fn = functools.partial(getattr(jra, f"{kind}_attention"),
                           block=ATTN_BLOCK, **kw)
    with jax.set_mesh(jbuild(JMesh(data=1, context=n), cpu_devices[:n])):
        o = jax.jit(fn)(q, k, v, bias)
        grads = jax.jit(jax.grad(lambda *a: (fn(*a) * w).sum(),
                                 argnums=(0, 1, 2, 3)))(q, k, v, bias)
    return [np.asarray(a) for a in (o, *grads)]


def dense_reference(kw):
    """(out, dq, dk, dv, dbias) of the port's dense attention."""
    leaves = [torch.from_numpy(a).requires_grad_()
              for a in attn_inputs()[:4]]
    q, k = leaves[:2]
    if kw.get("rope_theta"):
        pos = torch.arange(AL)
        q, k = tra._rope_qk(q, k, pos, kw["rope_theta"])
    if kw.get("causal"):
        o = tg.causal_dense_attention(q, k, leaves[2], leaves[3],
                                      window=kw.get("window", 0))
    else:
        o = tb.dense_attention(q, k, leaves[2], leaves[3])
    w = torch.from_numpy(attn_inputs()[4])
    (o * w).sum().backward()
    return [o.detach().numpy()] + [t.grad.numpy() for t in leaves]


def gathered(results, key, ctx=2):
    """A case's chunks from every rank of context ``ctx``, put back
    together."""
    parts = [r[("attention", ctx)][key] for r in results]
    return [torch.cat([p[i] for p in parts],
                      dim=-1 if i == 4 else 1).numpy() for i in range(5)]


def jax_fit(family, kind, mesh_cfg, cpu_devices):
    """The JAX Trainer's 3 steps' rows and eval on a virtual mesh."""
    from kubeflow_tpu.models import bert as jb
    from kubeflow_tpu.models import gpt as jg
    from kubeflow_tpu.parallel import MeshConfig as JMesh
    from kubeflow_tpu.parallel import build_mesh as jbuild
    from kubeflow_tpu.train import trainer as jt
    from kubeflow_tpu_torch.convert import flax_params_from, \
        flax_params_from_gpt
    from tests.test_torch_moe import jax_state

    n = mesh_cfg.data * mesh_cfg.context
    mesh = jbuild(JMesh(data=mesh_cfg.data, context=mesh_cfg.context),
                  cpu_devices[:n])
    if family == "gpt":
        model = gpt_model(kind)
        flat = flax_params_from_gpt(model.state_dict(), model.cfg)
        jmodel = jg.GPTLM(jg.GPTConfig.tiny(**GPT_TINY, **GPT_KINDS[kind]))
        fns = dict(loss_fn=jg.causal_lm_loss,
                   eval_metrics_fn=jg.causal_lm_eval_metrics)
    else:
        model = bert_model(kind)
        flat = flax_params_from(model.state_dict())
        cfg = jb.BertConfig.tiny(attention="ring", **BERT_TINY)
        jmodel = (jb.BertForSequenceClassification(cfg, num_classes=3)
                  if kind == "cls" else jb.BertForMaskedLM(cfg))
        fns = ({} if kind == "cls" else
               dict(loss_fn=jb.masked_lm_loss,
                    eval_metrics_fn=jb.masked_lm_eval_metrics))
    jtr = jt.Trainer(jmodel, jt.TrainerConfig(batch_size=BATCH,
                                              steps=STEPS), mesh=mesh, **fns)
    ds = data_for(family, kind)
    state, rows = stepped(jtr, global_batches(ds),
                          jax_state(jtr, flat))
    ev = jtr.evaluate(state, ds)
    return rows, [ev["loss"], ev["accuracy"]]


def one_process_fit(family, kind):
    ds = data_for(family, kind)
    trainer = trainer_for(family, kind)
    state, rows = stepped(trainer, global_batches(ds))
    ev = trainer.evaluate(state, ds)
    return rows, [ev["loss"], ev["accuracy"]]


# ------------------------------------------------------------ blockwise


def blockwise_inputs(L, dtype=np.float32, seed=1):
    rng = np.random.RandomState(seed)
    q, k, v, w = (rng.normal(0, 1, (AB, L, AH, AD)).astype(dtype)
                  for _ in range(4))
    bias = np.zeros((AB, 1, 1, L), dtype)
    bias[1, ..., L - 3:] = -1e9
    return q, k, v, bias, w


@pytest.mark.parametrize("vjp", ["custom", "autodiff"])
@pytest.mark.parametrize("L,causal,window,padded", [
    (16, False, 0, True), (16, True, 0, False), (16, True, 4, True),
    (20, True, 0, True), (20, False, 0, False)])
def test_blockwise_forward_and_grads_match_jax(L, causal, window, padded,
                                               vjp):
    """The port's blockwise attention and its grads (q, k, v and the bias)
    against the JAX package's, forward 1e-5 and grads 1e-4; L = 20 does
    not tile block 8, which both take as one block."""
    import jax
    import jax.numpy as jnp

    from kubeflow_tpu.parallel import ring_attention as jra

    q, k, v, bias, w = blockwise_inputs(L)
    if not padded:
        bias = np.zeros_like(bias)
    kw = dict(block=8, causal=causal, window=window, vjp=vjp)
    jin = [jnp.asarray(a) for a in (q, k, v, bias)]
    want = jra.blockwise_attention(*jin, **kw)
    want_g = jax.grad(lambda *a: (jra.blockwise_attention(*a, **kw)
                                  * w).sum(), argnums=(0, 1, 2, 3))(*jin)
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v, bias)]
    got = tra.blockwise_attention(*leaves, **kw)
    (got * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=1e-5, rtol=0)
    for name, t, g in zip("q k v bias".split(), leaves, want_g):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g),
                                   err_msg=name, **GRAD_TOL)


@pytest.mark.parametrize("causal,window", [(False, 0), (True, 0), (True, 4)])
def test_blockwise_bf16_custom_against_autodiff(causal, window):
    """In bf16 the custom backward against reverse-mode AD of the forward
    loop, at the JAX package's bounds (tests/test_ring_attention.py: atol
    6e-2, rtol 5e-2), the two forwards equal (they are one function), and
    the forward within 6e-2 of the JAX package's bf16 forward."""
    import jax.numpy as jnp

    from kubeflow_tpu.parallel import ring_attention as jra

    q, k, v, bias, w = blockwise_inputs(32, seed=3)
    kw = dict(block=8, causal=causal, window=window)
    res = {}
    for vjp in ("custom", "autodiff"):
        leaves = [torch.from_numpy(a).to(torch.bfloat16).requires_grad_()
                  for a in (q, k, v)]
        tb16 = torch.from_numpy(bias).to(torch.bfloat16)
        out = tra.blockwise_attention(*leaves, tb16, vjp=vjp, **kw)
        (out.float() * torch.from_numpy(w)).sum().backward()
        res[vjp] = [out.detach().float()] + [t.grad.float() for t in leaves]
    for a, b in zip(res["custom"][1:], res["autodiff"][1:]):
        torch.testing.assert_close(a, b, atol=6e-2, rtol=5e-2)
    assert torch.equal(res["custom"][0], res["autodiff"][0])
    want = jra.blockwise_attention(*(jnp.asarray(a, jnp.bfloat16)
                                     for a in (q, k, v, bias)), **kw)
    np.testing.assert_allclose(res["custom"][0].numpy(),
                               np.asarray(want, np.float32), atol=6e-2)


def test_blockwise_vjp_is_read_and_checked_at_import():
    """KFT_BLOCKWISE_VJP as in the JAX package: an unknown value is refused
    when the module is imported, with the JAX package's text; "autodiff"
    becomes the default path; an unknown vjp argument is refused."""
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(sys.path),
           "KFT_BLOCKWISE_VJP": "Custom"}
    name = "kubeflow_tpu_torch.parallel.ring_attention"
    code = (  # a failed import leaves no module behind: import it again
        "import importlib, os\n"
        f"try:\n    importlib.import_module({name!r})\n"
        "except ValueError as e:\n    print('refused:', e)\n"
        "os.environ['KFT_BLOCKWISE_VJP'] = 'autodiff'\n"
        f"print(importlib.import_module({name!r}).BLOCKWISE_VJP)\n")
    run = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120,
                         cwd=ROOT)
    assert run.returncode == 0, run.stderr
    assert run.stdout.splitlines() == [
        "refused: KFT_BLOCKWISE_VJP='Custom' is not 'custom' or 'autodiff'",
        "autodiff"]
    assert tra.BLOCKWISE_VJP == "custom"
    q = torch.zeros((1, 4, 1, 8))
    with pytest.raises(ValueError, match="unknown blockwise vjp"):
        tra.blockwise_attention(q, q, q, torch.zeros((1, 1, 1, 4)),
                                vjp="scan")


def test_custom_vjp_keeps_no_probability_tiles():
    """The custom backward's residuals are q, k, v, bias, out and lse: the
    autograd graph of the custom path saves O(L) tensors, the autodiff
    path's the (B, H, L, block) tiles of every block."""
    q, k, v, bias, _ = blockwise_inputs(32)
    sizes = {}
    for vjp in ("custom", "autodiff"):
        saved = []
        leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
        with torch.autograd.graph.saved_tensors_hooks(
                lambda t: saved.append(t.numel()) or t, lambda t: t):
            tra.blockwise_attention(*leaves, torch.from_numpy(bias),
                                    block=8, causal=True, vjp=vjp)
        sizes[vjp] = max(saved)
    assert sizes["custom"] == AB * 32 * AH * AD
    assert sizes["autodiff"] >= AB * AH * 32 * 8


# ---------------------------------------------------- ring and ulysses


@pytest.mark.parametrize("kind", ["ring", "ulysses"])
@pytest.mark.parametrize("name", [n for n, _ in ATTN_CASES])
def test_context2_attention_matches_jax_and_dense(gang2, cpu_devices, kind,
                                                  name):
    kw = dict(ATTN_CASES)[name]
    got = gathered(gang2, (kind, name))
    want = jax_attention(kind, kw, 2, cpu_devices)
    dense = dense_reference(kw)
    for i, what in enumerate(("out", "dq", "dk", "dv", "dbias")):
        tol = FWD_TOL if i == 0 else GRAD_TOL
        np.testing.assert_allclose(got[i], want[i], err_msg=what, **tol)
        np.testing.assert_allclose(got[i], dense[i], err_msg=what, **tol)


def test_ring_autodiff_backward_matches_custom(gang2):
    got = gathered(gang2, ("ring", "autodiff"))
    custom = gathered(gang2, ("ring", "causal"))
    for i, what in enumerate(("out", "dq", "dk", "dv", "dbias")):
        np.testing.assert_allclose(got[i], custom[i], err_msg=what,
                                   **(FWD_TOL if i == 0 else GRAD_TOL))


@pytest.mark.parametrize("kind", ["ring", "ulysses"])
def test_context4_window_shortens_ring_and_matches_jax(gang, cpu_devices,
                                                       kind):
    """On context=4 each rank holds 4 positions and a window of 3 reaches
    one shard back: the ring runs 2 hops of 4 and the accumulators take
    the closing rotation home."""
    _, results = gang
    kw = dict(RING4_CASES)["window"]
    assert tra._ring_hops(4, AL // 4, kw["window"]) == 2
    got = gathered(results, (kind, "window"), 4)
    want = jax_attention(kind, kw, 4, cpu_devices)
    dense = dense_reference(kw)
    for i, what in enumerate(("out", "dq", "dk", "dv", "dbias")):
        tol = FWD_TOL if i == 0 else GRAD_TOL
        np.testing.assert_allclose(got[i], want[i], err_msg=what, **tol)
        np.testing.assert_allclose(got[i], dense[i], err_msg=what, **tol)


# ------------------------------------------------------------ the fits


FITS = [("gpt", kind, "c2") for kind in GPT_KINDS] + \
    [("gpt", kind, "d2c2") for kind in ("ring", "ulysses")] + \
    [("bert", kind, "c2") for kind in ("cls", "mlm")]


@pytest.mark.parametrize("family,kind,mesh", FITS)
def test_context_fit_matches_jax_mesh_and_one_process(
        gang, cpu_devices, family, kind, mesh):
    """3 steps' losses, accuracies and grad norms and the eval of the
    trained state: every rank's equal to one process's on the global
    batch (1e-5) and to the JAX Trainer's on a virtual mesh of the gang's
    shape (1e-4); each rank's attention saw L / ctx positions. GPT's
    dropout fit draws its masks by the sequence's element indices, so the
    gang's are one process's, and under remat the recompute redraws them
    under the forward's context axis; the JAX package draws other masks,
    so that fit is held against one process only (BERT's attention
    dropout is refused by ring attention in both packages)."""
    results = gang[1][:2] if mesh == "c2" else gang[1]
    one_rows, one_ev = one_process_fit(family, kind)
    jax_rows = jax_ev = None
    if "dropout" not in kind:
        jax_rows, jax_ev = jax_fit(family, kind, MESHES[mesh], cpu_devices)
        np.testing.assert_allclose(one_rows, jax_rows, **JAX_TOL)
    for res in results:
        rows, ev = res[(family, kind, mesh)]
        np.testing.assert_allclose(rows, one_rows, **ONE_TOL)
        np.testing.assert_allclose(ev, one_ev, **ONE_TOL)
        if jax_rows is not None:
            np.testing.assert_allclose(rows, jax_rows, **JAX_TOL)
            np.testing.assert_allclose(ev, jax_ev, **JAX_TOL)
        assert res[("seen", family, kind, mesh)] == [SEQ // 2]


def test_process_local_under_context(gang):
    """data=2 x context=2, process_local: the context ranks of one data
    index load the same shard files (the JAX loader's for that index), and
    the gang's fit equals one process fed the global batch the two data
    indices' rows make."""
    from kubeflow_tpu.train import data as jd

    out, results = gang
    for rank, res in enumerate(results):
        want = jd.load_dataset_shards(str(out / "shards"), rank // 2, 2)
        np.testing.assert_array_equal(res["shards"], want.x_train)
    shards = [td.load_dataset_shards(str(out / "shards"), i, 2)
              for i in range(2)]
    per = [list(td.batches(s.x_train, s.y_train, BATCH // 2, seed=0))
           for s in shards]
    glob = [tuple(np.concatenate([per[i][s][j] for i in range(2)])
                  for j in range(2)) for s in range(STEPS)]
    _, want = stepped(trainer_for("gpt", "ring"), glob)
    for res in results:
        np.testing.assert_allclose(res["process_local"], want[-1][0],
                                   **ONE_TOL)


def test_context_gang_refusals(gang2):
    """A context axis refuses a model that cannot shard the sequence
    (dense attention), MoE layers (ROADMAP Queue A item 8), a weighted
    loss with other eval metrics, the model axis beside it (item 8), and
    dense attention or decoding under an entered axis."""
    got = gang2[0]["refusals"]
    assert "ring or ulysses attention" in got["dense"]
    assert "MoE" in got["moe"] and "item 8" in got["moe"]
    assert "weighted token loss" in got["mixed"]
    assert "'model'" in got["model"] and "item 8" in got["model"]
    assert "under a context axis" in got["dense_forward"]
    assert "decoding runs on one process" in got["decode"]


@pytest.mark.parametrize("ctx", [2, 4])
def test_dropout_slices_draw_the_whole_sequences_masks(ctx):
    """A context rank's dropout of its L/ctx positions (``span``) draws
    the masks the whole (B, L, H) tensor's dropout draws there, forward
    and backward (the kernels' span form: tests/test_torch_kernels.py on
    the card)."""
    from kubeflow_tpu_torch.kernels import dropout as kd

    seed = torch.tensor(2**40 + 11)
    x = torch.randn(3, 24, 20)
    whole = kd.dropout_plain(x, seed, 0.3, site=2)
    row = (24 // ctx) * 20
    for i, part in enumerate(x.chunk(ctx, dim=1)):
        leaf = part.clone().requires_grad_()
        y = kd.dropout(leaf, seed, 0.3, 2, (row, 24 * 20, i * row))
        assert torch.equal(y, whole.chunk(ctx, dim=1)[i])
        y.sum().backward()
        assert torch.equal(leaf.grad != 0, y != 0)


def test_ring_gpt_served_by_engine_matches_jax():
    """A ring-configured GPT served by the port's continuous-batching
    engine on the CPU gives the JAX engine's greedy tokens: decoding runs
    the cache path, prefill included, as in the JAX package."""
    import jax.numpy as jnp
    from flax import traverse_util

    from kubeflow_tpu.models import gpt as jg
    from kubeflow_tpu.serving.continuous import ContinuousBatcher as JaxEng
    from kubeflow_tpu_torch.convert import flax_params_from_gpt, \
        gpt_params_from_flax
    from kubeflow_tpu_torch.serving.continuous import ContinuousBatcher

    cfg = dict(max_len=48, attention="ring", attention_block=8,
               dropout_rate=0.0)
    tcfg = tg.GPTConfig.tiny(**cfg)
    template = flax_params_from_gpt(tg.GPTLM(tcfg, device="cpu")
                                    .state_dict(), tcfg)
    rng = np.random.RandomState(3)
    flat = {k: (1.0 + 0.1 * rng.normal(size=v.shape) if k.endswith("/scale")
                else 0.2 * rng.normal(size=v.shape)).astype(np.float32)
            for k, v in sorted(template.items())}
    tmodel = tg.GPTLM(tcfg, device="cpu")
    tmodel.load_state_dict(gpt_params_from_flax(flat, tcfg))
    variables = {"params": traverse_util.unflatten_dict(
        {k: jnp.asarray(v) for k, v in flat.items()}, sep="/")}
    jmodel = jg.GPTLM(jg.GPTConfig.tiny(**cfg), pad_token_id=-1)
    jobs = [(np.random.RandomState(s).randint(1, 512, n).astype(np.int32), b)
            for s, n, b in ((1, 5, 8), (2, 9, 6), (3, 3, 10))]

    def run(eng):
        reqs = [eng.submit(p, max_new_tokens=b) for p, b in jobs]
        eng.run_until_idle()
        return [list(r.result(timeout=1)) for r in reqs]

    want = run(JaxEng(jmodel, variables, max_rows=2))
    got = run(ContinuousBatcher(tmodel.eval(), max_rows=2))
    assert got == want
