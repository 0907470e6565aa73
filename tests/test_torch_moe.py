"""The port's mixture-of-experts layer and the MoE models against the JAX
package's, on the CPU.

The router's combine, dispatch and aux loss (capacity drops included);
``MoeMlp`` in its gelu/swiglu, bias/no-bias, routed/dropless forms (f32
outputs and grads within 1e-5, bf16 outputs within 8 bf16 ulps of the
largest |output|); GPT, Llama-shaped (Mixtral) and BERT MoE logits within
1e-4 on the same weights (``convert.py``); 3 Trainer steps within 1e-4 of
the JAX Trainer's with the aux loss in the objective; the engine's rows
equal to solo decode and to the JAX engine's tokens; a fused fit equal to
the per-step fit; remat counting the aux loss once. One 2-process gloo
gang (``tests/torch_gang.py``, its own 120 s timeout) trains under
``expert=2`` and ``data=2`` within 1e-4 of the JAX Trainer on a virtual
CPU mesh of the same shape, and its expert-sharded checkpoint restores on
one process bit for bit.
"""

import numpy as np
import pytest
import torch

from kubeflow_tpu_torch.convert import flax_params_from_gpt, gpt_params_from_flax
from kubeflow_tpu_torch.models import bert as tb
from kubeflow_tpu_torch.models import gpt as tg
from kubeflow_tpu_torch.parallel import moe as tmoe
from kubeflow_tpu_torch.parallel.mesh import MeshConfig
from kubeflow_tpu_torch.train import data as td
from kubeflow_tpu_torch.train import trainer as tt
from tests.torch_gang import run_gang

try:  # one intra-op thread: the suite shares the machine with timing gates
    torch.set_num_threads(1)
    torch.set_num_interop_threads(1)
except RuntimeError:  # the interop pool can be sized once per process
    pass

H, F, E, K = 8, 16, 4, 2
TOL = dict(atol=1e-5, rtol=1e-5)
MODEL_TOL = dict(atol=1e-4, rtol=1e-4)
BATCH, STEPS, LR = 8, 3, 1e-3
DATA = dict(n_train=32, n_test=8, seq_len=16, vocab_size=512)
GANG_MESHES = {"expert": dict(data=1, expert=2), "data": dict(data=2)}


def gpt_moe_cfg(**kw):
    return dict(dropout_rate=0.0, moe_experts=4, **kw)


def flax_flat(params):
    import jax
    from flax import traverse_util

    return {k: np.asarray(v) for k, v in traverse_util.flatten_dict(
        jax.device_get(params), sep="/").items()}


def as_params(flat):
    import jax.numpy as jnp
    from flax import traverse_util

    return traverse_util.unflatten_dict(
        {k: jnp.asarray(v) for k, v in flat.items()}, sep="/")


def jax_gpt_flat(jcfg, seed=0):
    import jax
    import jax.numpy as jnp

    from kubeflow_tpu.models import gpt as jg

    ids = jnp.ones((1, 8), jnp.int32)
    return flax_flat(jax.jit(jg.GPTLM(jcfg).init)(
        jax.random.PRNGKey(seed), ids)["params"])


def port_gpt(cfg, flat):
    m = tg.GPTLM(cfg, device="cpu")
    m.load_state_dict(gpt_params_from_flax(flat, cfg))
    return m


def lm_trainer(model, mesh=None, **kw):
    return tt.Trainer(
        model, tt.TrainerConfig(**{"batch_size": BATCH, "steps": STEPS,
                                   "learning_rate": LR, "mesh": mesh, **kw}),
        loss_fn=tg.causal_lm_loss, eval_metrics_fn=tg.causal_lm_eval_metrics)


def global_batches():
    ds = td.synthetic_lm_dataset(**DATA)
    return list(td.batches(ds.x_train, ds.y_train, BATCH, seed=0))[:STEPS]


def run_steps(trainer, state, batches):
    out = []
    for b in batches:
        state, m = trainer.train_step(state, b)
        out.append([float(m[k]) for k in ("loss", "grad_norm", "accuracy")])
    return state, out


# ----------------------------------------------------------------- routing


def combine_dispatch(expert, pos, keep, gates, num_experts, capacity):
    """The JAX package's (T, E, C) combine weights and 0/1 dispatch from
    the port's routing (slots by index)."""
    t, k = expert.shape
    combine = torch.zeros(t, num_experts * capacity + 1)
    dispatch = torch.zeros(t, num_experts * capacity + 1)
    slot = torch.where(keep, expert * capacity + pos,
                       num_experts * capacity)
    rows = torch.arange(t)[:, None].expand(t, k)
    combine.index_put_((rows, slot), gates * keep, accumulate=True)
    dispatch.index_put_((rows, slot), keep.float(), accumulate=True)
    shape = (t, num_experts, capacity)
    return (combine[:, :-1].reshape(shape), dispatch[:, :-1].reshape(shape))


@pytest.mark.parametrize("capacity", [3, 6, 48])
def test_route_matches_jax(capacity):
    import jax

    from kubeflow_tpu.parallel.moe import _route as jroute

    logits = np.array(jax.random.normal(jax.random.PRNGKey(0), (24, E)))
    combine, dispatch, aux = jroute(logits, K, capacity)
    expert, pos, keep, gates, taux = tmoe._route(torch.from_numpy(logits),
                                                 K, capacity)
    tc, td_ = combine_dispatch(expert, pos, keep, gates, E, capacity)
    np.testing.assert_allclose(tc.numpy(), np.asarray(combine), atol=1e-7)
    np.testing.assert_array_equal(td_.numpy(), np.asarray(dispatch))
    assert float(taux) == pytest.approx(float(aux), rel=1e-6)
    if capacity < 24 * K // E:
        assert not bool(keep.all())  # this case drops choices


MLP_CASES = [  # activation, bias, capacity factor, dropless, dtype
    ("gelu", True, 2.0, False, "float32"),
    ("gelu", True, 0.5, False, "float32"),
    ("swiglu", False, 1.0, False, "float32"),
    ("swiglu", False, 1.0, True, "float32"),
    ("gelu", True, 2.0, True, "float32"),
    ("swiglu", False, 1.0, False, "bfloat16"),
    ("gelu", True, 2.0, True, "bfloat16"),
]


@pytest.mark.parametrize("act,bias,cf,dropless,dtype", MLP_CASES)
def test_moe_mlp_matches_jax(act, bias, cf, dropless, dtype):
    import jax
    import jax.numpy as jnp

    from kubeflow_tpu.parallel.moe import MoeMlp as JMoe

    x = np.random.RandomState(0).normal(size=(3, 6, H)).astype(np.float32)
    jm = JMoe(hidden_size=H, mlp_dim=F, num_experts=E, top_k=K,
              capacity_factor=cf, activation=act, use_bias=bias)
    params = jax.jit(jm.init)(jax.random.PRNGKey(1), jnp.asarray(x))["params"]
    tm = tmoe.MoeMlp(H, F, E, K, cf, act, bias)
    assert {n for n, _ in tm.named_parameters()} == set(params)
    with torch.no_grad():
        for k, v in params.items():
            getattr(tm, k).copy_(torch.from_numpy(np.asarray(v)))
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32

    def jloss(p, xx):
        y, upd = jm.apply({"params": p}, xx, dropless=dropless,
                          mutable=["losses"])
        aux = sum(jax.tree.leaves(upd.get("losses", {})), 0.0)
        return (y.astype(jnp.float32) ** 2).sum() + aux, y

    (_, want), (gp, gx) = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(params, jnp.asarray(x, jdt))
    xt = torch.from_numpy(x).to(getattr(torch, dtype)).requires_grad_()
    with tmoe.collect_losses() as sown:
        got = tm(xt, dropless=dropless)
    assert len(sown) == (0 if dropless else 1)
    ((got.float() ** 2).sum() + sum(sown, 0.0)).backward()
    want = np.asarray(want.astype(jnp.float32))
    if dtype == "bfloat16":
        ulp = 2.0 ** -8 * np.abs(want).max()
        assert np.abs(got.detach().float().numpy() - want).max() <= 8 * ulp
        return
    np.testing.assert_allclose(got.detach().numpy(), want, **TOL)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), **TOL)
    for k, v in gp.items():
        np.testing.assert_allclose(getattr(tm, k).grad.numpy(),
                                   np.asarray(v), err_msg=k, **TOL)


def test_global_dispatch_on_one_process_is_local():
    x = torch.randn(2, 5, H, generator=torch.Generator().manual_seed(0))
    local = tmoe.MoeMlp(H, F, E, K).requires_grad_(False)
    local.init_weights(torch.Generator().manual_seed(1))
    glob = tmoe.MoeMlp(H, F, E, K, global_dispatch=True)
    glob.load_state_dict(local.state_dict())
    torch.testing.assert_close(glob(x), local(x), rtol=0, atol=0)
    glob.data_like = 2  # a gang of two data-like ranks
    with pytest.raises(NotImplementedError, match="item 8"):
        glob(x)
    with pytest.raises(ValueError, match="not divisible by expert axis 3"):
        local.shard_experts(None, 3, 0, 3)


# ------------------------------------------------------------------ models


@pytest.mark.parametrize("shape", ["gpt", "llama", "bert"])
def test_moe_model_logits_match_jax(shape):
    import jax
    import jax.numpy as jnp
    from flax import traverse_util

    from kubeflow_tpu.models import bert as jb
    from kubeflow_tpu.models import gpt as jg
    from kubeflow_tpu_torch.convert import params_from_flax

    rng = np.random.RandomState(2)
    ids = rng.randint(1, 500, (2, 24)).astype(np.int32)
    ids[1, -4:] = 0  # padded positions
    if shape == "bert":
        jm = jb.BertForSequenceClassification(
            jb.BertConfig.tiny(moe_experts=4, dropout_rate=0.0),
            num_classes=2)
        variables = jax.jit(jm.init)(jax.random.PRNGKey(3), jnp.asarray(ids))
        flat = {k: np.asarray(v) for k, v in traverse_util.flatten_dict(
            variables["params"], sep="/").items()}
        tm = tb.BertForSequenceClassification(
            tb.BertConfig.tiny(moe_experts=4, dropout_rate=0.0), 2,
            device="cpu")
        tm.load_state_dict(params_from_flax(flat, tm))
    else:
        ctor = "tiny" if shape == "gpt" else "llama"
        jcfg = getattr(jg.GPTConfig, ctor)(**gpt_moe_cfg())
        tcfg = getattr(tg.GPTConfig, ctor)(**gpt_moe_cfg())
        jm = jg.GPTLM(jcfg)
        flat = jax_gpt_flat(jcfg, seed=3)
        tm = port_gpt(tcfg, flat)
        assert flax_params_from_gpt(tm.state_dict(), tcfg).keys() == \
            flat.keys()
    want = np.asarray(jax.jit(jm.apply)({"params": as_params(flat)},
                                        jnp.asarray(ids)))
    with torch.no_grad():
        got = tm(torch.from_numpy(ids)).numpy()
    np.testing.assert_allclose(got, want, **MODEL_TOL)


def test_trainer_steps_match_jax_with_aux():
    """3 steps of the Mixtral-shaped decoder from the JAX init: loss (CE +
    the layers' aux), grad norm and accuracy within 1e-4 of the JAX
    Trainer's on one device."""
    import jax

    from kubeflow_tpu.models import gpt as jg
    from kubeflow_tpu.parallel import MeshConfig as JMesh, build_mesh
    from kubeflow_tpu.train import trainer as jt

    jcfg = jg.GPTConfig.llama(**gpt_moe_cfg())
    flat = jax_gpt_flat(jcfg)
    jtr = jt.Trainer(jg.GPTLM(jcfg), jt.TrainerConfig(
        batch_size=BATCH, steps=STEPS, learning_rate=LR),
        loss_fn=jg.causal_lm_loss, eval_metrics_fn=jg.causal_lm_eval_metrics,
        mesh=build_mesh(JMesh(data=1), devices=jax.devices()[:1]))
    _, want = run_steps(jtr, jax_state(jtr, flat), global_batches())
    model = port_gpt(tg.GPTConfig.llama(**gpt_moe_cfg()), flat)
    trainer = lm_trainer(model)
    ids = torch.from_numpy(global_batches()[0][0])
    with torch.no_grad(), tmoe.collect_losses() as sown:
        ce = tg.causal_lm_loss(model(ids), ids)
    _, got = run_steps(trainer, trainer.init_state(), global_batches())
    assert len(sown) == 2  # one aux loss a layer
    assert got[0][0] == pytest.approx(float(ce + sum(sown)), rel=1e-6)
    np.testing.assert_allclose(np.array(got), np.array(want), **MODEL_TOL)


def jax_state(jtr, flat):
    """The JAX Trainer's state over given weights, placed as its
    partitioner lays it out (so its step compiles once)."""
    import jax
    import jax.numpy as jnp

    from kubeflow_tpu.train import trainer as jt

    params = as_params(flat)
    state = jt.TrainState(step=jnp.zeros((), jnp.int32), params=params,
                          opt_state=jtr.tx.init(params),
                          rng=jax.random.PRNGKey(0))
    return jax.device_put(state, jtr.partitioner.state_shardings(state))


def test_fused_fit_equals_per_step_fit():
    ds = td.synthetic_lm_dataset(**DATA)
    cfg = tg.GPTConfig.tiny(**gpt_moe_cfg())
    out = []
    for k in (1, 2):
        model = tg.GPTLM(cfg, device="cpu").init_weights(
            torch.Generator().manual_seed(0))
        state, last = lm_trainer(model, fused_steps=k, steps=4,
                                 log_every_steps=1).fit(ds)
        out.append((last["loss"], state.model.state_dict()))
    assert out[0][0] == out[1][0]
    for k, v in out[0][1].items():
        assert torch.equal(out[1][1][k], v), k


def test_graphed_adam_in_slices_equals_one_slice(monkeypatch):
    """A CUDA graph's Adam update takes the parameters a slice at a time
    (its temporaries bounded for billion-parameter models): elementwise,
    so the step is the same bit for bit however they are sliced."""
    out = []
    for limit in (2**40, 1000):
        monkeypatch.setattr(tt, "ADAM_SLICE_ELEMENTS", limit)
        model = tg.GPTLM(tg.GPTConfig.tiny(**gpt_moe_cfg()),
                         device="cpu").init_weights(
            torch.Generator().manual_seed(0))
        trainer = lm_trainer(model)
        state = trainer.init_state()
        state, _ = trainer.train_step(state, global_batches()[0])
        row = trainer._update_scalars(state, 1)[0]
        state, _ = trainer._step(state, global_batches()[1],
                                 lambda st: tt._adam_update(st.optimizer,
                                                            row))
        out.append([p.detach().clone() for p in model.parameters()])
    assert len(list(tt._slices(out[1], 1000))) > 3
    for a, b in zip(*out):
        assert torch.equal(a, b)


def test_remat_counts_the_aux_loss_once():
    cfg = tg.GPTConfig.tiny(**gpt_moe_cfg())
    ids = torch.from_numpy(global_batches()[0][0])
    runs = []
    for remat in (False, True):
        model = tg.GPTLM(tg.GPTConfig.tiny(**gpt_moe_cfg(remat=remat)),
                         device="cpu").init_weights(
            torch.Generator().manual_seed(0))
        with tmoe.collect_losses() as sown:
            loss = tg.causal_lm_loss(model(ids), ids) + sum(sown)
            loss.backward()  # the recompute runs inside the collection
        runs.append((len(sown), loss.item(),
                     [p.grad.clone() for p in model.parameters()]))
    assert runs[0][0] == runs[1][0] == cfg.num_layers
    assert runs[0][1] == runs[1][1]
    for a, b in zip(runs[0][2], runs[1][2]):
        torch.testing.assert_close(a, b, atol=1e-7, rtol=1e-6)


# ------------------------------------------------------------------ serving


def test_engine_rows_equal_solo_decode_and_the_jax_engine(tmp_path):
    """The JAX engine test's MoE contract: prompts of 20 tokens prefill
    routed (batch 1), every decode step is dropless, so a row's tokens do
    not depend on the rows beside it. The same weights through a model
    dir and ModelServer's predictor serve the same tokens."""
    import jax.numpy as jnp

    from kubeflow_tpu.models import gpt as jg
    from kubeflow_tpu.serving.continuous import ContinuousBatcher as JEngine
    from kubeflow_tpu_torch.serving.continuous import ContinuousBatcher
    from kubeflow_tpu_torch.serving.model import TorchModel, save_predictor

    kw = gpt_moe_cfg(max_len=96)
    jcfg = jg.GPTConfig.tiny(**kw)
    flat = jax_gpt_flat(jcfg)
    model = port_gpt(tg.GPTConfig.tiny(**kw), flat).eval()
    rng = np.random.RandomState(4)
    jobs = [(rng.randint(1, 500, 20).astype(np.int32), n)
            for n in (10, 14, 6, 8)]
    eng = ContinuousBatcher(model, max_rows=2)
    reqs = [eng.submit(p, max_new_tokens=n) for p, n in jobs]
    eng.run_until_idle()
    got = [r.result(timeout=1) for r in reqs]
    jeng = JEngine(jg.GPTLM(jcfg, pad_token_id=-1),
                   {"params": as_params(flat)}, max_rows=2)
    jreqs = [jeng.submit(jnp.asarray(p), max_new_tokens=n) for p, n in jobs]
    jeng.run_until_idle()
    for (p, n), row, jr in zip(jobs, got, jreqs):
        solo = tg.generate(model, torch.from_numpy(p)[None].long(), n)[0]
        np.testing.assert_array_equal(row, solo.numpy())
        np.testing.assert_array_equal(row, jr.result(timeout=1))
    save_predictor(tmp_path / "moe", "gpt-lm", model.state_dict(),
                   jobs[0][0][None], size="tiny", config=kw,
                   generate={"continuous": True, "continuous_rows": 2,
                             "max_new_tokens": 10})
    served = TorchModel("moe", tmp_path / "moe", device="cpu")
    served.load()
    try:
        out = served.predict(np.stack([jobs[0][0], jobs[1][0]]))
    finally:
        served.close()
    np.testing.assert_array_equal(out[0], got[0])
    np.testing.assert_array_equal(out[1], got[1][:10])


# ---------------------------------------------------------------- the gang


def moe_gang_main(out, rank):
    """Every rank: the MoE decoder trained 3 steps under each gang mesh;
    the expert-sharded state saved; global dispatch refused."""
    from kubeflow_tpu_torch.runtime import initialize_from_env, shutdown

    initialize_from_env(backend="gloo", timeout_s=60)
    with np.load(out / "flat.npz") as z:
        flat = {k: z[k] for k in z.files}
    cfg = tg.GPTConfig.tiny(**gpt_moe_cfg())
    res = {}
    for name, kw in GANG_MESHES.items():
        model = port_gpt(cfg, flat)
        trainer = lm_trainer(model, MeshConfig(**kw),
                             checkpoint_dir=str(out / f"ckpt_{name}"))
        state, steps = run_steps(trainer, trainer.init_state(),
                                 global_batches())
        local = state.model.layers[0].moe.w_up.shape[0]
        trainer.checkpointer.save(state.step, state)
        sd = state.state_dict()
        res[name] = (steps, local, {k: v.clone()
                                    for k, v in sd["model"].items()})
    model = port_gpt(cfg, flat)
    trainer = lm_trainer(model, MeshConfig(data=2))
    for block in model.layers:
        block.moe.global_dispatch = True
    try:
        trainer.train_step(trainer.init_state(), global_batches()[0])
        res["global"] = "ran"
    except NotImplementedError as err:
        res["global"] = str(err)
    shutdown()
    return res


@pytest.fixture(scope="module")
def moe_gang(tmp_path_factory):
    from kubeflow_tpu.models import gpt as jg

    out = tmp_path_factory.mktemp("moe_gang")
    flat = jax_gpt_flat(jg.GPTConfig.tiny(**gpt_moe_cfg()))
    np.savez(out / "flat.npz", **flat)
    return out, flat, run_gang("tests.test_torch_moe", "moe_gang_main", out)


@pytest.mark.parametrize("name", list(GANG_MESHES))
def test_gang_moe_fit_matches_jax_mesh(moe_gang, name, cpu_devices):
    from kubeflow_tpu.models import gpt as jg
    from kubeflow_tpu.parallel import MeshConfig as JMesh, build_mesh
    from kubeflow_tpu.train import trainer as jt

    _, flat, results = moe_gang
    jtr = jt.Trainer(jg.GPTLM(jg.GPTConfig.tiny(**gpt_moe_cfg())),
                     jt.TrainerConfig(batch_size=BATCH, steps=STEPS,
                                      learning_rate=LR),
                     loss_fn=jg.causal_lm_loss,
                     eval_metrics_fn=jg.causal_lm_eval_metrics,
                     mesh=build_mesh(JMesh(**GANG_MESHES[name]),
                                     cpu_devices[:2]))
    _, want = run_steps(jtr, jax_state(jtr, flat), global_batches())
    for steps, local, _ in (r[name] for r in results):
        np.testing.assert_allclose(np.array(steps), np.array(want),
                                   **MODEL_TOL)
        assert local == (2 if name == "expert" else 4)  # experts a rank


@pytest.mark.parametrize("name", list(GANG_MESHES))
def test_gang_moe_checkpoint_restores_on_one_process(moe_gang, name):
    out, flat, results = moe_gang
    saved = results[0][name][2]
    for k, v in saved.items():
        assert torch.equal(results[1][name][2][k], v), k
    cfg = tg.GPTConfig.tiny(**gpt_moe_cfg())
    trainer = lm_trainer(port_gpt(cfg, flat),
                         checkpoint_dir=str(out / f"ckpt_{name}"))
    step, state = trainer.checkpointer.restore_latest(trainer.init_state())
    assert step == STEPS
    got = state.model.state_dict()
    assert saved["layers.0.moe.w_up"].shape[0] == cfg.moe_experts
    for k, v in saved.items():
        assert torch.equal(got[k], v), k


def test_gang_global_dispatch_refused(moe_gang):
    for res in moe_gang[2]:
        assert "global_dispatch" in res["global"] and "item 8" in \
            res["global"]
