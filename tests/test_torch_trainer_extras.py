"""The rest of the port's Trainer against itself and the JAX package's:
``fused_steps`` chunks, ``train_steps_fused``/``train_chunk``/
``compile_fused``, the restart-warm kernel cache, the profiler trace of a
fit and its tracing spans.

On the CPU a chunk is k ``train_step``s, so a fused fit equals the per-step
fit bit for bit; against the JAX Trainer (``MnistMLP(hidden=(16,))`` from
the JAX Trainer's own init, f32 on both sides) the parameters agree within
1e-4 and the logged steps and the spans' names and attributes are equal.

Every test leaves the process as it found it: no ``KFTPU_*_DIR`` variable,
no JAX compile cache, no global tracer of either package and no profiler
left behind (``leaves_no_global_state``). A JAX run here never sees a trace
dir, a compile cache or a profile dir: its tracer is installed with
``set_tracer`` and put back in ``finally``.
"""

import json
import os
import subprocess

import jax
import jax._src.profiler as jax_profiler
import numpy as np
import pytest
import torch
from flax import traverse_util

from kubeflow_tpu.models import mnist as jmn
from kubeflow_tpu.parallel import MeshConfig, build_mesh
from kubeflow_tpu.tracing import core as jtracing
from kubeflow_tpu.train import data as jd
from kubeflow_tpu.train import trainer as jt
from kubeflow_tpu_torch.convert import params_from_flax
from kubeflow_tpu_torch.kernels import build
from kubeflow_tpu_torch.models import gpt as tg
from kubeflow_tpu_torch.models import mnist as tmn
from kubeflow_tpu_torch.tracing import core as ttracing
from kubeflow_tpu_torch.train import data as td
from kubeflow_tpu_torch.train import metrics as tm
from kubeflow_tpu_torch.train import trainer as tt
from kubeflow_tpu_torch.utils import compile_cache

try:  # one intra-op thread: the suite shares the machine with timing gates
    torch.set_num_threads(1)
    torch.set_num_interop_threads(1)
except RuntimeError:  # the interop pool can be sized once per process
    pass

DIR_ENVS = ("KFTPU_TRACE_DIR", "KFTPU_PROFILE_DIR", "KFTPU_COMPILE_CACHE_DIR",
            "KFTPU_EVENT_DIR")
TINY = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=2,
            mlp_dim=64, max_len=16, dropout_rate=0.0, attention_block=8)
LM_DATA = dict(n_train=40, n_test=8, seq_len=16, vocab_size=64)
# 12 steps an epoch; steps=11 with fused_steps=4: two chunks, then 3 steps
IMG_DATA = dict(n_train=96, n_test=16, shape=(64,))
BATCH, STEPS = 8, 11
# the spans' timing attributes: compared by presence and type, not value
TIMES = ("wait_s", "assemble_s")


def _global_state():
    return ({k: os.environ.get(k) for k in DIR_ENVS},
            jax.config.jax_compilation_cache_dir,
            jtracing.get_tracer(), ttracing.get_tracer(),
            jax_profiler._profile_state.profile_session,
            torch.autograd.profiler._is_profiler_enabled)


@pytest.fixture(autouse=True)
def leaves_no_global_state(serving_compile_cache):
    before = _global_state()
    yield
    after = _global_state()
    for a, b in zip(after, before):
        assert a is b or a == b, (after, before)


def gpt_trainer(**cfg):
    model = tg.GPTLM(tg.GPTConfig.tiny(**TINY), device="cpu").init_weights(
        torch.Generator().manual_seed(0))
    return tt.Trainer(model, tt.TrainerConfig(**{"batch_size": 4, **cfg}),
                      loss_fn=tg.causal_lm_loss,
                      eval_metrics_fn=tg.causal_lm_eval_metrics)


def mlp_trainer(flat=None, **cfg):
    model = tmn.MnistMLP(64, hidden=(16,), device="cpu")
    if flat is None:
        model.init_weights(torch.Generator().manual_seed(0))
    else:
        model.load_state_dict(params_from_flax(flat, model))
    return tt.Trainer(model, tt.TrainerConfig(**{"batch_size": BATCH, **cfg}))


def fit_logged(trainer, ds, capsys, **kw):
    state, final = trainer.fit(ds, **kw)
    lines = [tm.parse_line(x) for x in capsys.readouterr().out.splitlines()]
    return state, final, lines


def learned(lines):
    """The logged lines without their timing keys."""
    return [{k: v for k, v in x.items()
             if k not in ("images_per_sec", "steps_per_sec")} for x in lines]


@pytest.mark.parametrize("model", ["gpt", "mlp"])
def test_fused_fit_equals_per_step_fit(model, capsys):
    """fit(fused_steps=4, steps=11) is fit(fused_steps=1) bit for bit: the
    parameters and every logged line (log_every_steps=4 logs steps 4, 8 and
    11 in both: a chunk logs when its cadence boundary falls inside it)."""
    runs = []
    for k in (1, 4):
        cfg = dict(steps=STEPS, fused_steps=k, log_every_steps=4,
                   learning_rate=1e-2, warmup_steps=2, grad_clip_norm=0.5)
        if model == "gpt":
            trainer = gpt_trainer(**cfg)
            ds = td.synthetic_lm_dataset(**LM_DATA)
        else:
            trainer = mlp_trainer(**cfg)
            ds = td.synthetic_image_dataset(**IMG_DATA)
        state, _, lines = fit_logged(trainer, ds, capsys)
        runs.append((state, learned(lines)))
    (s1, l1), (s4, l4) = runs
    assert s1.step == s4.step == STEPS
    assert [x["step"] for x in l1 if "loss" in x] == [4, 8, 11]
    assert l4 == l1
    want = s1.model.state_dict()
    for k, v in s4.model.state_dict().items():
        assert torch.equal(v, want[k]), k


def test_fused_calls_equal_k_train_steps():
    """train_steps_fused (one batch n times), train_chunk (slice i at step
    i) and compile_fused's program equal k train_steps, bit for bit; the
    metrics are the last step's."""
    ds = td.synthetic_image_dataset(**IMG_DATA)
    x, y = ds.x_train[:3 * BATCH], ds.y_train[:3 * BATCH]
    stacked = (x.reshape(3, BATCH, -1), y.reshape(3, BATCH))
    batch = (x[:BATCH], y[:BATCH])

    def params(state):
        return [p.detach().clone() for p in state.model.parameters()]

    def stepped(batches_):
        tr = mlp_trainer(learning_rate=1e-2)
        state = tr.init_state()
        for b in batches_:
            state, m = tr.train_step(state, b)
        return state, m

    def compiled(tr, st):
        program, placed = tr.compile_fused(st, batch, 3)
        assert st.step == 0  # prepared, no step taken
        return program(st, placed)

    for fused, want_batches in (
            (lambda tr, st: tr.train_steps_fused(st, batch, 3), [batch] * 3),
            (lambda tr, st: tr.train_chunk(st, stacked, 3),
             [(stacked[0][i], stacked[1][i]) for i in range(3)]),
            (compiled, [batch] * 3)):
        tr = mlp_trainer(learning_rate=1e-2)
        state, m = fused(tr, tr.init_state())
        ref, rm = stepped(want_batches)
        assert state.step == ref.step == 3
        for a, b in zip(params(state), params(ref)):
            assert torch.equal(a, b)
        for key in ("loss", "accuracy", "grad_norm"):
            assert torch.equal(m[key], rm[key]), key


def test_fused_steps_clamped_to_the_epoch(capsys):
    """A chunk never exceeds an epoch: fused_steps 8 over 3 batches an
    epoch runs chunks of 3, and the steps boundary runs step by step."""
    ds = td.synthetic_image_dataset(n_train=3 * BATCH, n_test=8,
                                    shape=(64,))
    trainer = mlp_trainer(steps=7, fused_steps=8, log_every_steps=1)
    chunks, singles = [], []
    real_chunk, real_step = trainer.train_chunk, trainer.train_step

    def chunk(state, stacked, k):
        chunks.append((state.step, k, stacked[0].shape[0]))
        return real_chunk(state, stacked, k)

    def step(state, batch):
        singles.append(state.step)
        return real_step(state, batch)

    trainer.train_chunk, trainer.train_step = chunk, step
    state, _, lines = fit_logged(trainer, ds, capsys)
    assert state.step == 7
    # train_chunk's own k steps run through train_step on the CPU
    assert chunks == [(0, 3, 3), (3, 3, 3)]
    assert singles == [0, 1, 2, 3, 4, 5, 6]
    assert [x["step"] for x in lines if "loss" in x] == [3, 6, 7]


# --------------------------------------------------- against the JAX package


def span_seq(tracer):
    """(name, attributes) of every recorded span, in order; the timing
    attributes by type only."""
    return [(sp["name"], {k: (type(v).__name__ if k in TIMES else v)
                          for k, v in sp["attrs"].items()})
            for sp in tracer.snapshot()]


@pytest.fixture(scope="module")
def jax_fits(tmp_path_factory):
    """The JAX Trainer's fit of MnistMLP(hidden=(16,)) at fused_steps 1 and
    4 (steps 11, checkpoints every 4 steps), traced by a Tracer installed
    for the run: its initial and final parameters, logged lines, spans."""
    ds = jd.synthetic_image_dataset(**IMG_DATA)
    out = {}
    for k in (1, 4):
        ck = tmp_path_factory.mktemp(f"jax-ckpt-{k}")
        trainer = jt.Trainer(
            jmn.MnistMLP(hidden=(16,)),
            jt.TrainerConfig(batch_size=BATCH, steps=STEPS, fused_steps=k,
                             log_every_steps=1, learning_rate=1e-2,
                             checkpoint_dir=str(ck),
                             checkpoint_every_steps=4),
            mesh=build_mesh(MeshConfig(data=1), devices=jax.devices()[:1]))
        init = trainer.init_state(ds.x_train[:BATCH]).params
        tracer = jtracing.Tracer()
        prev = jtracing.get_tracer()
        jtracing.set_tracer(tracer)
        try:
            import contextlib
            import io

            log = io.StringIO()
            with contextlib.redirect_stdout(log):
                state, _ = trainer.fit(ds)
        finally:
            jtracing.set_tracer(None if prev is jtracing.NOOP_TRACER
                                else prev)
        flat = lambda p: {n: np.asarray(v) for n, v in  # noqa: E731
                          traverse_util.flatten_dict(
                              jax.device_get(p), sep="/").items()}
        out[k] = {"init": flat(init), "final": flat(state.params),
                  "lines": [tm.parse_line(x)
                            for x in log.getvalue().splitlines()],
                  "spans": span_seq(tracer)}
    return out


def port_fit(jax_run, k, tmp_path, capsys, tracer=None):
    trainer = mlp_trainer(jax_run["init"], steps=STEPS, fused_steps=k,
                          log_every_steps=1, learning_rate=1e-2,
                          checkpoint_dir=str(tmp_path / f"port-{k}"),
                          checkpoint_every_steps=4)
    prev = ttracing.get_tracer()
    ttracing.set_tracer(tracer)
    try:
        return fit_logged(trainer, td.synthetic_image_dataset(**IMG_DATA),
                          capsys)
    finally:
        ttracing.set_tracer(None if prev is ttracing.NOOP_TRACER else prev)


def test_fused_fit_matches_jax_trainer(jax_fits, tmp_path, capsys):
    """The port's fit(fused_steps=4, steps=11) from the JAX Trainer's init:
    parameters within 1e-4 of the JAX fit's, the same logged steps (chunk
    ends 4 and 8, then 9, 10, 11) and losses within 1e-4."""
    run = jax_fits[4]
    state, _, lines = port_fit(run, 4, tmp_path, capsys)
    got = {x["step"]: x["loss"] for x in lines if "loss" in x}
    want = {x["step"]: x["loss"] for x in run["lines"] if "loss" in x}
    assert sorted(got) == sorted(want) == [4, 8, 9, 10, 11]
    for step in want:
        assert got[step] == pytest.approx(want[step], rel=1e-4, abs=1e-4)
    params = {k: v.numpy() for k, v in state.model.state_dict().items()}
    for name, v in run["final"].items():
        layer, leaf = name.split("/")
        np.testing.assert_allclose(params[f"{layer}.{leaf}"], v, atol=1e-4,
                                   rtol=1e-4, err_msg=name)


@pytest.mark.parametrize("k", [1, 4])
def test_spans_match_jax_trainer(jax_fits, k, tmp_path, capsys):
    """checkpoint.restore, train.data_load, train.step / train.chunk,
    checkpoint.save and train.eval, in the JAX trainer's order with its
    attributes, for the same config."""
    tracer = ttracing.Tracer()
    port_fit(jax_fits[k], k, tmp_path, capsys, tracer)
    got, want = span_seq(tracer), jax_fits[k]["spans"]
    assert [n for n, _ in got] == [n for n, _ in want]
    assert got == want
    names = {n for n, _ in got}
    assert names == {"checkpoint.restore", "train.data_load", "train.step",
                     "checkpoint.save", "train.eval"} | (
        {"train.chunk"} if k > 1 else set())


def test_trace_dir_env_writes_the_fit_spans(tmp_path, monkeypatch, capsys):
    """KFTPU_TRACE_DIR installs the port's tracer for the fit
    (init_worker_from_env); flushed, its file holds the steps' spans."""
    monkeypatch.setenv("KFTPU_TRACE_DIR", str(tmp_path / "trace"))
    prev = ttracing.get_tracer()
    ttracing.set_tracer(None)  # init_worker_from_env keeps a live tracer
    try:
        gpt_trainer(steps=2).fit(td.synthetic_lm_dataset(**LM_DATA))
        tracer = ttracing.get_tracer()
        assert tracer.enabled and tracer.trace_dir == str(tmp_path / "trace")
        path = ttracing.flush(tracer)
    finally:
        ttracing.set_tracer(None if prev is ttracing.NOOP_TRACER else prev)
    body = json.loads(open(path).read())
    events = body["traceEvents"] if isinstance(body, dict) else body
    names = [e.get("name") for e in events]
    assert names.count("train.step") == 2
    assert "train.eval" in names


# ------------------------------------------------------- restart-warm cache


def test_cache_dir_resolution(monkeypatch, tmp_path):
    monkeypatch.delenv("KFTPU_COMPILE_CACHE_DIR", raising=False)
    assert compile_cache.cache_dir_from_env("") == ""
    monkeypatch.setenv("KFTPU_COMPILE_CACHE_DIR", str(tmp_path / "env"))
    assert compile_cache.cache_dir_from_env("") == str(tmp_path / "env")
    assert compile_cache.cache_dir_from_env("/x") == "/x"
    assert build.library_path("flash_fwd.cu", tmp_path).parent == tmp_path
    assert build.library_path("flash_fwd.cu").parent == build.BUILD_DIR
    assert (build.library_path("flash_fwd.cu", tmp_path).name
            == build.library_path("flash_fwd.cu").name)


def test_build_all_over_a_warm_dir_starts_no_process(monkeypatch, tmp_path):
    """Every library already in the cache dir: nothing is built, no process
    is started, no nvcc run is counted."""
    for src in build.sources():
        build.library_path(src, tmp_path).write_bytes(b"")

    def refuse(*a, **kw):
        raise AssertionError("a process was started")

    monkeypatch.setattr(subprocess, "Popen", refuse)
    before = compile_cache.compile_counts()
    assert build.build_all(build_dir=tmp_path) == {}
    assert compile_cache.compile_counts() == before
    # one library missing: its build is the only one tried
    build.library_path("flash_fwd.cu", tmp_path).unlink()
    monkeypatch.setattr(build, "_nvcc", lambda: "nvcc")
    with pytest.raises(AssertionError, match="process was started"):
        build.build_all(build_dir=tmp_path)


@pytest.mark.parametrize("fused_steps", [1, 4])
def test_cpu_fit_with_cache_records_compile_span(tmp_path, fused_steps,
                                                 capsys):
    """fit with compile_cache_dir warms up under train.compile before the
    first step: on the CPU no kernel is built or loaded and no graph is
    captured."""
    tracer = ttracing.Tracer()
    prev = ttracing.get_tracer()
    ttracing.set_tracer(tracer)
    try:
        trainer = gpt_trainer(steps=4, fused_steps=fused_steps,
                              compile_cache_dir=str(tmp_path / "cache"))
        trainer.fit(td.synthetic_lm_dataset(**LM_DATA))
    finally:
        ttracing.set_tracer(None if prev is ttracing.NOOP_TRACER else prev)
    spans = tracer.snapshot()
    compile_ = [sp for sp in spans if sp["name"] == "train.compile"]
    assert len(compile_) == 1
    attrs = compile_[0]["attrs"]
    assert attrs["enabled"] is True and attrs["builds"] == 0
    assert attrs["loaded"] == "" and "graph" not in attrs
    assert attrs["cache_dir"] == str(tmp_path / "cache")
    first_step = next(i for i, sp in enumerate(spans)
                      if sp["name"] in ("train.step", "train.chunk"))
    assert spans.index(compile_[0]) < first_step
    assert gpt_trainer().warm_start(None, None) == {"enabled": False}


# ----------------------------------------------------------------- profile


@pytest.mark.parametrize("how", ["config", "env"])
def test_profile_dir_writes_a_trace(how, tmp_path, monkeypatch, capsys):
    out = tmp_path / "prof"
    if how == "env":
        monkeypatch.setenv("KFTPU_PROFILE_DIR", str(out))
        trainer = mlp_trainer(steps=2)
    else:
        trainer = mlp_trainer(steps=2, profile_dir=str(out))
    _, _, lines = fit_logged(
        trainer, td.synthetic_image_dataset(n_train=16, n_test=8,
                                            shape=(64,)), capsys)
    assert {"profile_trace_written": 1.0} in lines
    (trace,) = out.iterdir()
    assert trace.name.endswith(".pt.trace.json")
    events = json.loads(trace.read_text())["traceEvents"]
    assert any("addmm" in e.get("name", "") or "linear" in e.get("name", "")
               for e in events)


# ----------------------------------------------------------------- refusals


@pytest.mark.parametrize("weight_decay", [0.0, 0.1])
def test_written_out_adam_update_is_torchs(weight_decay):
    """_adam_update with a row of _update_scalars repeats torch's
    multi-tensor Adam/AdamW step from the same state: the same moments
    bit for bit, and each parameter within one float32 ulp of itself and
    of the largest update (the last op's roundings). (Its last op,
    addcmul with the step size in a tensor, is the fused multiply-add of
    torch's addcdiv on the card, where tests/test_torch_graphs.py holds it
    bit for bit; the CPU's addcdiv rounds in another order.)"""
    ds = td.synthetic_image_dataset(**IMG_DATA)
    batches_ = [(ds.x_train[i * BATCH:(i + 1) * BATCH],
                 ds.y_train[i * BATCH:(i + 1) * BATCH]) for i in range(2)]
    states, before = [], None
    for written in (False, True):
        tr = mlp_trainer(learning_rate=1e-2, warmup_steps=2,
                         weight_decay=weight_decay)
        state = tr.init_state()
        state.optimizer.param_groups[0]["foreach"] = True
        state, _ = tr.train_step(state, batches_[0])  # makes Adam's state
        before = [p.detach().clone() for p in state.model.parameters()]
        if written:
            row = tr._update_scalars(state, 1)[0]
            state, _ = tr._step(state, batches_[1], lambda st: tt._adam_update(
                st.optimizer, row))
        else:
            state, _ = tr.train_step(state, batches_[1])
        states.append(state)
    eager, written = states
    for a, b, p0 in zip(eager.model.parameters(),
                        written.model.parameters(), before):
        step = (a - p0).abs().max().item()
        torch.testing.assert_close(b, a, rtol=2.0 ** -23,
                                   atol=2.0 ** -23 * step)
    for a, b in zip(eager.optimizer.state.values(),
                    written.optimizer.state.values()):
        for key in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(a[key], b[key]), key


def test_graph_capture_refusals():
    """Checked before anything reaches the card: an optimizer whose update
    the graph does not replay. Dropout is no longer refused (its masks are
    functions of seeds the host writes before each replay): a dropout
    model's capture gets past where it was refused and stops at the
    optimizer check."""
    dropout = tg.GPTLM(tg.GPTConfig.tiny(**{**TINY, "dropout_rate": 0.1}),
                       device="cpu")
    trainer = tt.Trainer(dropout, tt.TrainerConfig(batch_size=4,
                                                   fused_steps=4),
                         loss_fn=tg.causal_lm_loss)
    sample = (torch.zeros(2, 4, 16, dtype=torch.int32),) * 2
    sgd = torch.optim.SGD(dropout.parameters(), lr=0.1)
    with pytest.raises(ValueError, match="multi-tensor Adam"):
        trainer._capture(tt.TrainState(0, dropout, sgd), sample, 2, True)
    other = gpt_trainer(fused_steps=4)
    state = other.init_state()
    for opt in (torch.optim.SGD(state.model.parameters(), lr=0.1),
                torch.optim.Adam(state.model.parameters(), amsgrad=True)):
        with pytest.raises(ValueError, match="multi-tensor Adam"):
            other._capture(tt.TrainState(0, state.model, opt), sample, 2,
                           True)
