"""The port's training path against the JAX package's.

A tiny GPT (2 layers, hidden 32, 2 heads, vocab 64, sequence 16, no
dropout) starts from the JAX Trainer's own flax init, converted across with
``kubeflow_tpu_torch.convert``; both Trainers then take the same batches of
the same ``synthetic_lm_dataset`` (bit-identical in both packages). Both
sides run f32 on the CPU (the Trainer's AUTO compute dtype there).
"""

import os
import signal

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from kubeflow_tpu.models import gpt as jg
from kubeflow_tpu.parallel import MeshConfig, build_mesh
from kubeflow_tpu.train import data as jd
from kubeflow_tpu.train import trainer as jt
from kubeflow_tpu_torch import health
from kubeflow_tpu_torch.convert import flax_params_from_gpt, gpt_params_from_flax
from kubeflow_tpu_torch.models import gpt as tg
from kubeflow_tpu_torch.parallel import mesh as tmesh
from kubeflow_tpu_torch.train import data as td
from kubeflow_tpu_torch.train import metrics as tm
from kubeflow_tpu_torch.train import trainer as tt

try:  # one intra-op thread: the suite shares the machine with timing gates
    torch.set_num_threads(1)
    torch.set_num_interop_threads(1)
except RuntimeError:  # the interop pool can be sized once per process
    pass

TINY = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=2,
            mlp_dim=64, max_len=16, dropout_rate=0.0, attention_block=8)
DATA = dict(n_train=40, n_test=8, seq_len=16, vocab_size=64)
TOL = dict(atol=1e-4, rtol=1e-4)  # f32; sums in another order
STEPS, BATCH = 5, 4


def tiny(attention="dense", **kw):
    return tg.GPTConfig.tiny(**{**TINY, "attention": attention, **kw})


def torch_model(cfg, flat=None, seed=0):
    m = tg.GPTLM(cfg, device="cpu")
    if flat is None:
        return m.init_weights(torch.Generator().manual_seed(seed))
    m.load_state_dict(gpt_params_from_flax(flat, cfg))
    return m


def jax_trainer(attention="dense", **cfg):
    """The JAX Trainer on one device, as the port trains."""
    return jt.Trainer(
        jg.GPTLM(jg.GPTConfig.tiny(**{**TINY, "attention": attention})),
        jt.TrainerConfig(**{"batch_size": BATCH, **cfg}),
        loss_fn=jg.causal_lm_loss, eval_metrics_fn=jg.causal_lm_eval_metrics,
        mesh=build_mesh(MeshConfig(data=1), devices=jax.devices()[:1]))


def flax_flat(params):
    return {k: np.asarray(v) for k, v in traverse_util.flatten_dict(
        jax.device_get(params), sep="/").items()}


def lm_trainer(model, **cfg):
    return tt.Trainer(model, tt.TrainerConfig(**{"batch_size": BATCH, **cfg}),
                      loss_fn=tg.causal_lm_loss,
                      eval_metrics_fn=tg.causal_lm_eval_metrics)


# the three optimizer settings of the JAX Trainer's _default_tx, each with
# one attention kind: adam + linear warmup + global-norm clipping (0.5 is
# below every step's grad norm, so it clips), adamw, warmup-cosine
@pytest.mark.parametrize("attention,opt", [
    ("flash", dict(warmup_steps=2, grad_clip_norm=0.5)),
    ("dense", dict(weight_decay=0.1)),
    ("flash", dict(lr_schedule="cosine", warmup_steps=1,
                   lr_final_fraction=0.1)),
])
def test_train_steps_match_jax_trainer(attention, opt):
    cfg = dict(batch_size=BATCH, learning_rate=1e-2, steps=STEPS, **opt)
    ds = jd.synthetic_lm_dataset(**DATA)
    tds = td.synthetic_lm_dataset(**DATA)
    for a, b in zip((ds.x_train, ds.y_train, ds.x_test),
                    (tds.x_train, tds.y_train, tds.x_test)):
        np.testing.assert_array_equal(a, b)
    jtr = jax_trainer(attention, **cfg)
    jstate = jtr.init_state(ds.x_train[:BATCH])
    ttr = lm_trainer(torch_model(tiny(attention), flax_flat(jstate.params)),
                     learning_rate=1e-2,
                     steps=STEPS, **opt)
    tstate = ttr.init_state()
    want, got = [], []
    pairs = zip(jd.batches(ds.x_train, ds.y_train, BATCH, seed=0),
                td.batches(tds.x_train, tds.y_train, BATCH, seed=0))
    for step, ((jx, jy), (tx, ty)) in enumerate(pairs):
        if step == STEPS:
            break
        np.testing.assert_array_equal(jx, tx)
        jstate, jm = jtr.train_step(jstate, (jx, jy))
        tstate, m = ttr.train_step(tstate, (tx, ty))
        want.append([float(jm[k]) for k in ("loss", "grad_norm",
                                             "accuracy")])
        got.append([float(m[k]) for k in ("loss", "grad_norm", "accuracy")])
        assert ttr.learning_rate(step) == pytest.approx(
            float(_jax_lr(jtr.config, step)), rel=1e-6, abs=1e-12)
    np.testing.assert_allclose(np.array(got), np.array(want), **TOL)
    assert tstate.step == STEPS
    # the parameters after five steps, too — all but the key projection's
    # bias, whose gradient is 0 in exact arithmetic (softmax is invariant to
    # a shift shared by a query's scores), so Adam turns each side's
    # rounding noise into ±lr steps
    after = flax_params_from_gpt(tstate.model.state_dict(), tiny(attention))
    for k, v in flax_flat(jstate.params).items():
        if not k.endswith("attention/key/bias"):
            np.testing.assert_allclose(after[k], v, err_msg=k, **TOL)


def _jax_lr(c, step):
    """The JAX Trainer's learning rate at a count, from optax's schedules
    as _default_tx builds them."""
    import optax

    if c.lr_schedule == "cosine":
        return optax.warmup_cosine_decay_schedule(
            0.0 if c.warmup_steps else c.learning_rate, c.learning_rate,
            c.warmup_steps, c.steps,
            c.learning_rate * c.lr_final_fraction)(step)
    if c.warmup_steps:
        return optax.linear_schedule(0.0, c.learning_rate,
                                     c.warmup_steps)(step)
    return c.learning_rate


def test_grad_accum_matches_one_step_on_doubled_batch():
    ds = td.synthetic_lm_dataset(**DATA)
    x, y = ds.x_train[:2 * BATCH], ds.y_train[:2 * BATCH]
    runs = []
    for accum in (1, 2):
        trainer = lm_trainer(torch_model(tiny()), batch_size=2 * BATCH,
                             grad_accum_steps=accum, grad_clip_norm=1.0)
        state, m = trainer.train_step(trainer.init_state(), (x, y))
        runs.append((m, state.model.state_dict()))
    (m1, p1), (m2, p2) = runs
    for k in ("loss", "grad_norm", "accuracy"):
        assert float(m2[k]) == pytest.approx(float(m1[k]), rel=1e-5), k
    for k in p1:
        torch.testing.assert_close(p2[k], p1[k], atol=1e-6, rtol=1e-5)
    with pytest.raises(ValueError, match="not divisible"):
        lm_trainer(torch_model(tiny()), grad_accum_steps=3).train_step(
            None, (x[:4], y[:4]))


def test_causal_lm_loss_and_eval_metrics_match_jax():
    rng = np.random.RandomState(4)
    logits = rng.normal(0, 2, (3, 10, 64)).astype(np.float32)
    labels = rng.randint(1, 64, (3, 10)).astype(np.int32)
    labels[1, 6:] = 0      # a padded row
    labels[2, 1:] = 0      # a row with no next-token label
    labels[0, 4] = int(np.argmax(logits[0, 3]))  # one right guess
    jl, tl = jnp.asarray(logits), torch.from_numpy(logits)
    ja, ta = jnp.asarray(labels), torch.from_numpy(labels)
    np.testing.assert_allclose(float(tg.causal_lm_loss(tl, ta)),
                               float(jg.causal_lm_loss(jl, ja)), rtol=1e-6)
    for got, want in zip(tg.causal_lm_eval_metrics(tl, ta),
                         jg.causal_lm_eval_metrics(jl, ja)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                                   atol=1e-7)
    # the Trainer's defaults: classification over the vocab, token-level
    np.testing.assert_allclose(float(tt.cross_entropy_loss(tl, ta)),
                               float(jt.cross_entropy_loss(jl, ja)),
                               rtol=1e-6)
    for got, want in zip(tt.classification_eval_metrics(tl, ta),
                         jt.classification_eval_metrics(jl, ja)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                                   atol=1e-7)


def test_evaluate_matches_jax():
    ds = jd.synthetic_lm_dataset(**{**DATA, "n_test": 10})  # a padded tail
    jtr = jax_trainer()
    jstate = jtr.init_state(ds.x_train[:BATCH])
    ttr = lm_trainer(torch_model(tiny(), flax_flat(jstate.params)))
    got = ttr.evaluate(ttr.init_state(), ds)
    want = jtr.evaluate(jstate, ds)
    assert got.keys() == want.keys()
    for k in got:
        assert got[k] == pytest.approx(want[k], rel=1e-5), k


def test_bf16_model_keeps_f32_params_and_matches_jax_bf16():
    """bf16 compute, f32 parameters, as flax. Tolerance: the two
    frameworks round to bf16 at different places (GELU's inner steps; under
    jit XLA:CPU computes bf16 dots in f32), so logits of this 2-layer model
    differ by up to a few bf16 ulps: max error at most 8 ulps of the
    largest |logit| and mean error at most 1 ulp."""
    tcfg = tiny("flash", dtype="bfloat16")
    jcfg = jg.GPTConfig.tiny(**{**TINY, "attention": "flash",
                                "dtype": jnp.bfloat16})
    rng = np.random.RandomState(1)
    template = flax_params_from_gpt(torch_model(tcfg).state_dict(), tcfg)
    flat = {k: (1.0 + 0.1 * rng.normal(size=v.shape) if k.endswith("/scale")
                else 0.2 * rng.normal(size=v.shape)).astype(np.float32)
            for k, v in sorted(template.items())}
    ids = rng.randint(1, 64, (2, 16)).astype(np.int32)
    ids[1, -3:] = 0
    variables = {"params": traverse_util.unflatten_dict(
        {k: jnp.asarray(v) for k, v in flat.items()}, sep="/")}
    jparams = jax.eval_shape(jg.GPTLM(jcfg).init, jax.random.PRNGKey(0),
                             jnp.asarray(ids))["params"]
    assert {np.dtype(x.dtype) for x in jax.tree.leaves(jparams)} == {
        np.dtype(np.float32)}
    want = np.asarray(jax.jit(jg.GPTLM(jcfg).apply)(variables,
                                                     jnp.asarray(ids)))
    model = torch_model(tcfg, flat)
    assert {p.dtype for p in model.parameters()} == {torch.float32}
    with torch.no_grad():
        got = model(torch.from_numpy(ids))
    assert got.dtype == torch.float32
    ulp = 2.0 ** -8 * np.abs(want).max()
    err = np.abs(got.numpy() - want)
    print(f"gpt bf16 logits: {err.max() / ulp:.2f} ulps max, "
          f"{err.mean() / ulp:.2f} mean")
    assert err.max() <= 8 * ulp and err.mean() <= ulp, (err.max(), ulp)
    # a float32 model's weights cross to it and back without loss
    back = flax_params_from_gpt(model.state_dict(), tcfg)
    for k in flat:
        np.testing.assert_array_equal(back[k], flat[k], err_msg=k)


def test_compute_dtype_policy():
    model = torch_model(tiny())
    c = tt.TrainerConfig()
    assert tt.Trainer.resolve_compute_dtype(model, c) == (model,
                                                          torch.float32)
    card, dt = tt.Trainer.resolve_compute_dtype(model, c, device_type="cuda")
    assert dt == torch.bfloat16 and card.cfg.dtype == "bfloat16"
    assert model.cfg.dtype == "float32"  # the model passed in is unchanged
    # ... and the module that computes in bf16 trains the same tensors
    assert all(a is b for a, b in zip(card.parameters(), model.parameters()))
    explicit = tt.TrainerConfig(compute_dtype="bfloat16")
    assert tt.Trainer.resolve_compute_dtype(
        model, explicit, device_type="cuda") == (model, torch.bfloat16)
    with torch.no_grad():
        ids = torch.from_numpy(td.synthetic_lm_dataset(
            **DATA).x_test[:2]).long()
        assert card(ids).dtype == torch.float32
        assert not torch.equal(card(ids), model(ids))


def test_remat_and_dropout_masks():
    """Dropout masks come from the step's seeds, so a block recomputed under
    remat draws the same ones: the grads with remat equal those without."""
    ds = td.synthetic_lm_dataset(**DATA)
    ids = torch.from_numpy(ds.x_train[:BATCH]).long()
    grads = []
    for remat in (False, True):
        model = torch_model(tiny(dropout_rate=0.3, remat=remat))
        loss = tg.causal_lm_loss(
            model(ids, train=True,
                  generator=torch.Generator().manual_seed(5)), ids)
        loss.backward()
        grads.append([p.grad.clone() for p in model.parameters()])
        with torch.no_grad():  # eval and train at rate 0 ignore the seeds
            assert torch.equal(model(ids), model(ids, train=False))
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, atol=0, rtol=0)
    model = torch_model(tiny(dropout_rate=0.3))
    with torch.no_grad():
        a = model(ids, train=True, generator=torch.Generator().manual_seed(1))
        b = model(ids, train=True, generator=torch.Generator().manual_seed(1))
        c = model(ids, train=True, generator=torch.Generator().manual_seed(2))
    assert torch.equal(a, b) and not torch.equal(a, c)
    with pytest.raises(ValueError, match="needs a generator"):
        model(ids, train=True)


def run_fit(tmp_path, steps, capsys, resume=True, **kw):
    ds = td.synthetic_lm_dataset(**DATA)  # 10 steps per epoch
    trainer = lm_trainer(torch_model(tiny()), learning_rate=1e-2,
                         steps=steps, log_every_steps=1,
                         checkpoint_dir=str(tmp_path), **kw)
    state, final = trainer.fit(ds, resume=resume)
    lines = [tm.parse_line(x) for x in capsys.readouterr().out.splitlines()]
    losses = {int(x["step"]): x["loss"] for x in lines if "loss" in x}
    return trainer, state, final, losses


def test_fit_checkpoint_resume_is_exact(tmp_path, capsys):
    _, whole_state, final, whole = run_fit(tmp_path / "a", 20, capsys,
                                           checkpoint_every_steps=10)
    assert sorted(whole) == list(range(1, 21))
    assert "final_loss" in final and "eval_loss" in final
    # stop at the epoch boundary, then a new trainer resumes
    run_fit(tmp_path / "b", 10, capsys, checkpoint_every_steps=10)
    _, state, _, resumed = run_fit(tmp_path / "b", 20, capsys,
                                   checkpoint_every_steps=10)
    assert sorted(resumed) == list(range(11, 21)) and state.step == 20
    for step in resumed:
        assert resumed[step] == whole[step], step
    want = whole_state.model.state_dict()
    for k, v in state.model.state_dict().items():
        assert torch.equal(v, want[k]), k  # bit-identical


def test_corrupt_newest_checkpoint_is_quarantined(tmp_path, capsys):
    trainer, state, _, _ = run_fit(tmp_path, 6, capsys,
                                   checkpoint_every_steps=2,
                                   checkpoint_max_to_keep=2)
    ck = trainer.checkpointer
    assert ck.all_steps() == [4, 6]
    saved4 = {k: v.clone() for k, v in torch.load(
        tmp_path / "4" / "state.pt", weights_only=True)["model"].items()}
    with open(tmp_path / "6" / "state.pt", "r+b") as fh:  # flip one byte
        fh.seek(200)
        b = fh.read(1)
        fh.seek(200)
        fh.write(bytes([b[0] ^ 0xFF]))
    health.reset_ckpt_verify_metrics()
    fresh = lm_trainer(torch_model(tiny(), seed=9), checkpoint_dir=str(
        tmp_path))
    step, restored = fresh.checkpointer.restore_latest(fresh.init_state())
    assert step == 4 and restored.step == 4
    for k, v in restored.model.state_dict().items():
        assert torch.equal(v, saved4[k]), k
    assert ck.all_steps() == [4]
    assert len(os.listdir(tmp_path / "quarantine")) == 1
    counts = health.ckpt_verify_snapshot()
    assert counts["steps_corrupt_total"] == 1
    assert counts["steps_quarantined_total"] == 1
    assert counts["fallback_restores_total"] == 1


@pytest.mark.parametrize("fused_steps", [1, 4])
def test_keep_best_and_preemption(tmp_path, capsys, fused_steps):
    trainer, _, _, _ = run_fit(tmp_path / "best", 20, capsys,
                               keep_best_metric="loss", best_mode="min",
                               checkpoint_max_to_keep=1,
                               fused_steps=fused_steps)
    ck = trainer.checkpointer
    assert ck.all_steps() == [ck.best_step()]
    plain = tt.Trainer(torch_model(tiny()), tt.TrainerConfig(
        checkpoint_dir=str(tmp_path / "plain")))
    with pytest.raises(ValueError, match="keep_best_metric"):
        plain.checkpointer.restore_best(plain.init_state())
    # SIGTERM mid-fit: a metric-less rescue save, then a clean return. The
    # handler fit installed is called as the signal would call it. The
    # flag is read after each dispatch: with fused_steps=4 the signal lands
    # inside the first chunk and the save on its boundary, step 4.
    ds = td.synthetic_lm_dataset(**DATA)
    trainer = lm_trainer(torch_model(tiny()), steps=20,
                         checkpoint_dir=str(tmp_path / "pre"),
                         fused_steps=fused_steps)
    real_step = trainer.train_step

    def step_then_sigterm(state, batch):
        out = real_step(state, batch)
        if state.step == 3:
            signal.getsignal(signal.SIGTERM)(signal.SIGTERM, None)
        return out

    trainer.train_step = step_then_sigterm
    before = signal.getsignal(signal.SIGTERM)
    state, final = trainer.fit(ds)
    saved = 3 if fused_steps == 1 else 4
    assert saved % fused_steps == 0
    assert final["preempted"] == 1.0 and state.step == saved
    assert trainer.checkpointer.all_steps() == [saved]
    assert not (tmp_path / "pre" / str(saved) / "metrics.json").exists()
    assert signal.getsignal(signal.SIGTERM) is before


def test_fit_heartbeats_and_final_metrics(tmp_path, capsys, monkeypatch):
    hb = tmp_path / "hb" / "beat.json"
    monkeypatch.setenv(health.ENV_HEARTBEAT_FILE, str(hb))
    trainer = lm_trainer(torch_model(tiny()), steps=3, async_loader=False)
    trainer.fit(td.synthetic_lm_dataset(**DATA))
    assert hb.exists() and '"step"' in hb.read_text()
    final = tm.extract_final_metrics(capsys.readouterr().out)
    assert set(final) == {"final_loss", "final_accuracy"}


@pytest.mark.parametrize("field,value,entry", [
    ("mesh", tmesh.MeshConfig(model=2), "item 8"),
    ("mesh", tmesh.MeshConfig(context=2, model=2), "item 8"),
    ("mesh", tmesh.MeshConfig(pipeline=2), "item 8"),
])
def test_unported_config_refused(field, value, entry):
    """The mesh axes the port does not execute are refused, beside the
    context axis too; the data, fsdp, expert and context axes and
    data_placement="process_local" train (tests/test_torch_dist.py,
    tests/test_torch_moe.py, tests/test_torch_context.py)."""
    with pytest.raises(NotImplementedError, match=entry):
        tt.Trainer(torch_model(tiny()), tt.TrainerConfig(**{field: value}))
    with pytest.raises(ValueError, match="replicated|process_local"):
        tt.Trainer(torch_model(tiny()),
                   tt.TrainerConfig(data_placement="sharded"))


def test_async_loader_order_and_errors():
    items = list(range(7))
    loader = td.AsyncLoader(iter(items), transform=lambda i: i * 10, size=2)
    assert list(loader) == [i * 10 for i in items]

    def broken():
        yield 1
        raise KeyError("boom")

    loader = td.AsyncLoader(broken())
    assert next(loader) == 1
    with pytest.raises(KeyError, match="boom"):
        next(loader)
    loader = td.AsyncLoader(iter(range(100)), size=1)
    next(loader)
    loader.close()
    assert not loader._thread.is_alive()
    with pytest.raises(StopIteration):
        next(loader)
