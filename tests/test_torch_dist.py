"""The port's distributed bootstrap and sharded training on the CPU.

``runtime.initialize_from_env`` against the JAX package's PyTorchJob env
contract (``envcontract.pytorch_env``), and one 2-process gloo gang
(``tests/torch_gang.py``, its own 120 s timeout) that checks, in order:
the DistContext, the heartbeat's rendezvous beats and the ``rendezvous``
span; ``data=2`` and ``fsdp=2`` fits of a tiny GPT equal to one process
on the global batch (losses and grad norms 1e-5, parameters 1e-4), their
losses and grad norms within 1e-4 of the JAX Trainer on a virtual CPU
mesh of the same shape; ``data=2`` fits under the two weighted token
losses (BERT-tiny MLM, GPT-tiny with pad rows), whose ranks' counts
differ, equal to the JAX Trainer's loss over the global batch (1e-4) and
one process's (1e-5), where the mean of the ranks' own losses is not;
a ``process_local`` fit over per-process
shard files equal to the replicated fit; a gang (fsdp=2) checkpoint
restored on one process bit for bit, and a one-process checkpoint
restored by the gang bit for bit.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from kubeflow_tpu_torch import health
from kubeflow_tpu_torch.models import bert as tb
from kubeflow_tpu_torch.models import gpt as tg
from kubeflow_tpu_torch.parallel.mesh import MeshConfig
from kubeflow_tpu_torch.runtime import distributed as rd
from kubeflow_tpu_torch.train import data as td
from kubeflow_tpu_torch.train import trainer as tt
from kubeflow_tpu_torch.utils.envvars import ENV_TRACE_DIR
from tests.torch_gang import ROOT, run_gang

try:  # one intra-op thread: the suite shares the machine with timing gates
    torch.set_num_threads(1)
    torch.set_num_interop_threads(1)
except RuntimeError:  # the interop pool can be sized once per process
    pass

TINY = dict(vocab_size=64, hidden_size=64, num_layers=2, num_heads=2,
            mlp_dim=128, max_len=16, dropout_rate=0.0)
DATA = dict(n_train=48, n_test=8, seq_len=16, vocab_size=64)
BATCH, STEPS = 8, 3
TOL = dict(atol=1e-5, rtol=1e-5)  # losses: a gang sums in another order
JAX_TOL = dict(atol=1e-4, rtol=1e-4)
# parameters: Adam moves an element whose gradient is rounding noise by up
# to its learning rate (1e-3), so one element in thousands differs by more
PARAM_TOL = dict(atol=1e-4, rtol=1e-4)


def tiny_gpt():
    return tg.GPTLM(tg.GPTConfig.tiny(**TINY), device="cpu").init_weights(
        torch.Generator().manual_seed(0))


def gpt_trainer(mesh=None, **kw):
    return tt.Trainer(
        tiny_gpt(), tt.TrainerConfig(**{"batch_size": BATCH, "steps": STEPS,
                                   "log_every_steps": 1, "mesh": mesh, **kw}),
        loss_fn=tg.causal_lm_loss, eval_metrics_fn=tg.causal_lm_eval_metrics)


def global_batches():
    ds = td.synthetic_lm_dataset(**DATA)
    return [(ds.x_train[i * BATCH:(i + 1) * BATCH],
             ds.y_train[i * BATCH:(i + 1) * BATCH]) for i in range(STEPS)]


def stepped(trainer, batches, state=None):
    """The steps' (loss, grad norm) rows, of the port's Trainer or the JAX
    package's."""
    state = state or trainer.init_state()
    rows = []
    for b in batches:
        state, m = trainer.train_step(state, b)
        rows.append([float(m["loss"]), float(m["grad_norm"])])
    return state, rows


def full_state(state) -> dict:
    """A TrainState's state_dict with every tensor on the CPU."""
    sd = state.state_dict()
    return {"model": {k: v.detach().cpu().clone()
                      for k, v in sd["model"].items()},
            "moments": {i: {k: v.detach().cpu().clone() for k, v in st.items()
                            if torch.is_tensor(v) and v.ndim}
                        for i, st in sd["optimizer"]["state"].items()},
            "step": sd["step"]}


#: the weighted token losses' fits: BERT-tiny MLM, GPT-tiny with pad rows
WEIGHTED = ("mlm", "pad")


def weighted_trainer(name, mesh=None):
    if name == "mlm":
        model = tb.BertForMaskedLM(tb.BertConfig.tiny(
            vocab_size=256, max_len=16, dropout_rate=0.0), device="cpu")
        fns = dict(loss_fn=tb.masked_lm_loss,
                   eval_metrics_fn=tb.masked_lm_eval_metrics)
        model.init_weights(torch.Generator().manual_seed(0))
    else:
        model = tiny_gpt()
        fns = dict(loss_fn=tg.causal_lm_loss,
                   eval_metrics_fn=tg.causal_lm_eval_metrics)
    return tt.Trainer(model, tt.TrainerConfig(
        batch_size=BATCH, steps=STEPS, log_every_steps=1, mesh=mesh), **fns)


def weighted_batches(name):
    """MLM: synthetic_text_dataset's padded rows masked by
    mask_tokens_for_mlm. pad: synthetic_lm_dataset's rows, three of each
    batch's eight cut short by pad ids."""
    if name == "mlm":
        ds = td.synthetic_text_dataset(n_train=BATCH * STEPS, n_test=4,
                                       seq_len=16, vocab_size=255)
        x, y = td.mask_tokens_for_mlm(ds.x_train, 255, 255, seed=2)
    else:
        x = td.synthetic_lm_dataset(**DATA).x_train[:BATCH * STEPS].copy()
        rng = np.random.RandomState(7)
        for i in range(STEPS):
            for r in rng.choice(BATCH, 3, replace=False):
                x[i * BATCH + r, rng.randint(2, 8):] = 0
        y = x.copy()
    return [(x[i * BATCH:(i + 1) * BATCH], y[i * BATCH:(i + 1) * BATCH])
            for i in range(STEPS)]


def local_batches(shard_dir, rank, world):
    ds = td.load_dataset_shards(shard_dir, rank, world)
    return list(td.batches(ds.x_train, ds.y_train, BATCH // world, seed=0))


# ---------------------------------------------------------------- the gang


def gang_main(out, rank):
    """Every rank of the gang: the bootstrap, then the fits in order."""
    from kubeflow_tpu_torch import tracing

    phases = []
    beat = health.HeartbeatWriter.beat

    def spy(self, step=-1, phase="train"):
        phases.append(phase)
        return beat(self, step, phase)

    health.HeartbeatWriter.beat = spy
    ctx = rd.initialize_from_env(backend="gloo", timeout_s=60)
    health.HeartbeatWriter.beat = beat
    tracing.flush()
    out_res = {"ctx": (ctx.process_id, ctx.num_processes, ctx.coordinator,
                       ctx.is_distributed, ctx.is_coordinator),
               "phases": phases,
               "heartbeat": json.loads(
                   open(os.environ[health.ENV_HEARTBEAT_FILE]).read())}
    for name, mesh in (("data", MeshConfig(data=2)),
                       ("fsdp", MeshConfig(data=1, fsdp=2))):
        trainer = gpt_trainer(mesh)
        state, losses = stepped(trainer, global_batches())
        out_res[name] = (losses, full_state(state))
    for name in WEIGHTED:
        trainer = weighted_trainer(name, MeshConfig(data=2))
        out_res[name] = stepped(trainer, weighted_batches(name))[1]
    # process_local: each rank's own shard files, batch BATCH / 2
    trainer = gpt_trainer(MeshConfig(data=2),
                          data_placement="process_local", async_loader=False)
    state, last = trainer.fit(td.load_dataset_shards(str(out / "shards")))
    out_res["process_local"] = (last["loss"], full_state(state))
    # a gang checkpoint for one process, and one process's for the gang
    trainer = gpt_trainer(MeshConfig(data=1, fsdp=2),
                          checkpoint_dir=str(out / "ckpt_gang"))
    state, _ = stepped(trainer, global_batches()[:2])
    trainer.checkpointer.save(state.step, state)
    out_res["saved"] = full_state(state)
    trainer = gpt_trainer(MeshConfig(data=1, fsdp=2),
                          checkpoint_dir=str(out / "ckpt_single"))
    restored = trainer.checkpointer.restore_latest(trainer.init_state())
    out_res["restored"] = full_state(restored[1])
    # the restored gang steps on as one process does
    out_res["after_restore"] = stepped(trainer, global_batches()[2:],
                                       restored[1])[1]
    rd.shutdown()
    return out_res


@pytest.fixture(scope="module")
def gang(tmp_path_factory):
    from kubeflow_tpu.train import data as jd

    out = tmp_path_factory.mktemp("gang")
    jd.save_dataset_shards(jd.synthetic_lm_dataset(**DATA),
                           str(out / "shards"), num_shards=4)
    # one process's checkpoint (2 steps) for the gang to restore
    trainer = gpt_trainer(checkpoint_dir=str(out / "ckpt_single"))
    state, _ = stepped(trainer, global_batches()[:2])
    trainer.checkpointer.save(state.step, state)
    single = full_state(state)
    results = run_gang(
        "tests.test_torch_dist", "gang_main", out,
        extra_env=lambda r: {health.ENV_HEARTBEAT_FILE: str(out / f"hb{r}"),
                             ENV_TRACE_DIR: str(out / "trace")})
    return out, results, single


def test_gang_context_heartbeat_and_span(gang):
    out, results, _ = gang
    for rank, res in enumerate(results):
        pid, n, coord, distributed, coordinator = res["ctx"]
        assert (pid, n, distributed, coordinator) == (rank, 2, True,
                                                      rank == 0)
        assert coord.startswith("127.0.0.1:")
        assert res["phases"][:2] == ["rendezvous", "rendezvous-done"]
        assert res["heartbeat"]["phase"] == "rendezvous-done"
        assert res["heartbeat"]["step"] == -1
    spans = []
    for f in (out / "trace").glob("trace-worker-*.json"):
        spans += [e for e in json.loads(f.read_text())["traceEvents"]
                  if e.get("name") == "rendezvous"]
    assert sorted(e["args"]["rank"] for e in spans) == [0, 1]
    assert all(e["args"]["world"] == 2 and e["args"]["backend"] == "gloo"
               for e in spans)


@pytest.mark.parametrize("axis", ["data", "fsdp"])
def test_gang_fit_equals_one_process(gang, axis):
    _, results, _ = gang
    trainer = gpt_trainer()
    state, want = stepped(trainer, global_batches())
    ref = full_state(state)
    for res in results:
        losses, got = res[axis]
        np.testing.assert_allclose(losses, want, **TOL)
        for k, v in ref["model"].items():
            torch.testing.assert_close(got["model"][k], v, **PARAM_TOL)


@pytest.mark.parametrize("axis", ["data", "fsdp"])
def test_gang_fit_matches_jax_mesh(gang, axis, cpu_devices):
    """The sharded fit against the JAX package's: its Trainer on a virtual
    CPU mesh of the gang's shape, from the same weights, 3 steps' losses
    and grad norms within 1e-4 (the later steps' read the parameters both
    updated; a parameter whose gradient is rounding noise moves by up to
    the learning rate in either, so the parameters are held against the
    one-process fit above, not here)."""
    from kubeflow_tpu.models import gpt as jg
    from kubeflow_tpu.parallel import MeshConfig as JMesh, build_mesh
    from kubeflow_tpu.train import trainer as jt
    from kubeflow_tpu_torch.convert import flax_params_from_gpt
    from tests.test_torch_moe import jax_state

    _, results, _ = gang
    flat = flax_params_from_gpt(tiny_gpt().state_dict(),
                                tg.GPTConfig.tiny(**TINY))
    mesh = {"data": JMesh(data=2), "fsdp": JMesh(data=1, fsdp=2)}[axis]
    jtr = jt.Trainer(jg.GPTLM(jg.GPTConfig.tiny(**TINY)),
                     jt.TrainerConfig(batch_size=BATCH, steps=STEPS),
                     loss_fn=jg.causal_lm_loss,
                     eval_metrics_fn=jg.causal_lm_eval_metrics,
                     mesh=build_mesh(mesh, cpu_devices[:2]))
    _, want = stepped(jtr, global_batches(), jax_state(jtr, flat))
    for res in results:
        np.testing.assert_allclose(res[axis][0], want, **JAX_TOL)


@pytest.mark.parametrize("name", WEIGHTED)
def test_weighted_loss_gang_matches_jax_global_loss(gang, cpu_devices, name):
    """A data=2 gang under a weighted token loss trains the JAX package's
    objective, the loss of the global batch: 3 steps' losses and grad
    norms within 1e-4 of the JAX Trainer on a 2-device virtual mesh and
    1e-5 of one process. The ranks' counts differ, so the mean of the
    ranks' own losses (the objective before the repair) misses the
    global loss by more than that tolerance."""
    from kubeflow_tpu.models import bert as jb
    from kubeflow_tpu.models import gpt as jg
    from kubeflow_tpu.parallel import MeshConfig as JMesh, build_mesh
    from kubeflow_tpu.train import trainer as jt
    from kubeflow_tpu_torch.convert import flax_params_from, \
        flax_params_from_gpt
    from tests.test_torch_moe import jax_state

    _, results, _ = gang
    batches = weighted_batches(name)
    one = weighted_trainer(name)
    model = one.model
    if name == "mlm":
        flat = flax_params_from(model.state_dict())
        jmodel = jb.BertForMaskedLM(jb.BertConfig.tiny(
            vocab_size=256, max_len=16, dropout_rate=0.0))
        fns = dict(loss_fn=jb.masked_lm_loss,
                   eval_metrics_fn=jb.masked_lm_eval_metrics)
        counts = [int((y != td.IGNORE_LABEL).sum()) for y in
                  np.split(batches[0][1], 2)]
    else:
        flat = flax_params_from_gpt(model.state_dict(), model.cfg)
        jmodel = jg.GPTLM(jg.GPTConfig.tiny(**TINY))
        fns = dict(loss_fn=jg.causal_lm_loss,
                   eval_metrics_fn=jg.causal_lm_eval_metrics)
        counts = [int((y[:, 1:] != 0).sum()) for y in
                  np.split(batches[0][1], 2)]
    assert counts[0] != counts[1], counts
    with torch.no_grad():  # the ranks' own losses at the first step
        own = [float(one.loss_fn(model(torch.from_numpy(x)),
                                 torch.from_numpy(y)))
               for x, y in zip(np.split(batches[0][0], 2),
                               np.split(batches[0][1], 2))]
    jtr = jt.Trainer(jmodel, jt.TrainerConfig(batch_size=BATCH, steps=STEPS),
                     mesh=build_mesh(JMesh(data=2), cpu_devices[:2]), **fns)
    _, want = stepped(jtr, batches, jax_state(jtr, flat))
    _, single = stepped(one, batches)
    assert abs(np.mean(own) - want[0][0]) > JAX_TOL["atol"], (own, want)
    np.testing.assert_allclose(single, want, **JAX_TOL)
    for res in results:
        np.testing.assert_allclose(res[name], want, **JAX_TOL)
        np.testing.assert_allclose(res[name], single, **TOL)


def test_gang_process_local_equals_replicated(gang):
    """Each rank fed its own shard files (BATCH / 2 rows a step): the gang
    trains on the global batch their rows make, as one process fed that
    batch whole does."""
    out, results, _ = gang
    shards = str(out / "shards")
    per_rank = [local_batches(shards, r, 2) for r in range(2)]
    glob = [tuple(np.concatenate([per_rank[r][i][j] for r in range(2)])
                  for j in range(2)) for i in range(STEPS)]
    trainer = gpt_trainer()
    state, want = stepped(trainer, glob)
    ref = full_state(state)
    for res in results:
        loss, got = res["process_local"]
        np.testing.assert_allclose(loss, want[-1][0], **TOL)
        for k, v in ref["model"].items():
            torch.testing.assert_close(got["model"][k], v, **PARAM_TOL)


def test_gang_checkpoint_restores_on_one_process_bit_for_bit(gang):
    out, results, single = gang
    saved = results[0]["saved"]
    assert all(torch.equal(results[1]["saved"]["model"][k], v)
               for k, v in saved["model"].items())
    trainer = gpt_trainer(checkpoint_dir=str(out / "ckpt_gang"))
    step, state = trainer.checkpointer.restore_latest(trainer.init_state())
    got = full_state(state)
    assert step == 2 == got["step"]
    for k, v in saved["model"].items():
        assert torch.equal(got["model"][k], v), k
    for i, st in saved["moments"].items():
        for k, v in st.items():
            assert torch.equal(got["moments"][i][k], v), (i, k)
    # and the reverse: the gang restored one process's checkpoint
    for res in results:
        for k, v in single["model"].items():
            assert torch.equal(res["restored"]["model"][k], v), k
        for i, st in single["moments"].items():
            for k, v in st.items():
                assert torch.equal(res["restored"]["moments"][i][k], v)
    want = stepped(trainer, global_batches()[2:], state)[1]
    np.testing.assert_allclose(results[0]["after_restore"], want, **TOL)


# ------------------------------------------------------- without a gang


def test_no_env_is_a_noop(monkeypatch):
    from kubeflow_tpu.runtime import distributed as jdist

    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK",
              "MEGASCALE_NUM_SLICES", "MEGASCALE_SLICE_ID"):
        monkeypatch.delenv(k, raising=False)
    ctx = rd.initialize_from_env(backend="gloo")
    assert ctx == rd.DistContext(0, 1, None)
    assert not torch.distributed.is_initialized()
    rd.shutdown()  # no group: a no-op, as in the JAX package
    j = jdist.DistContext(process_id=3, num_processes=8, coordinator="h:1",
                          num_slices=2, slice_id=0)
    t = rd.DistContext(process_id=3, num_processes=8, coordinator="h:1",
                       num_slices=2, slice_id=0)
    for prop in ("is_distributed", "is_coordinator", "is_multislice",
                 "processes_per_slice"):
        assert getattr(t, prop) == getattr(j, prop), prop


@pytest.mark.parametrize("slices,slice_id,rank,msg", [
    ("3", "0", "0", "WORLD_SIZE 4 not divisible by MEGASCALE_NUM_SLICES 3"),
    ("2", "0", "3", "MEGASCALE_SLICE_ID 0 inconsistent with process 3/4 "
     r"over 2 slices \(expected 1\)"),
])
def test_megascale_checks(monkeypatch, slices, slice_id, rank, msg):
    monkeypatch.delenv("MASTER_ADDR", raising=False)
    monkeypatch.setenv("WORLD_SIZE", "4")
    monkeypatch.setenv("RANK", rank)
    monkeypatch.setenv("MEGASCALE_NUM_SLICES", slices)
    monkeypatch.setenv("MEGASCALE_SLICE_ID", slice_id)
    with pytest.raises(ValueError, match=msg):
        rd.initialize_from_env(backend="gloo")


def test_nccl_without_a_card_raises(monkeypatch):
    monkeypatch.delenv("MASTER_ADDR", raising=False)
    with pytest.raises(RuntimeError, match="NCCL needs a CUDA device"):
        rd.initialize_from_env()
    with pytest.raises(ValueError, match="nccl|gloo"):
        rd.initialize_from_env(backend="mpi")


def test_member_without_its_gang_fails_with_the_store_error(tmp_path):
    """A worker whose master never comes up fails at the store; it does
    not carry on alone."""
    from tests.torch_gang import free_port

    env = {**os.environ, "MASTER_ADDR": "127.0.0.1",
           "MASTER_PORT": str(free_port()), "WORLD_SIZE": "2", "RANK": "1",
           "PYTHONPATH": str(ROOT), "OMP_NUM_THREADS": "1",
           health.ENV_HEARTBEAT_FILE: str(tmp_path / "hb")}
    code = ("from kubeflow_tpu_torch.runtime import initialize_from_env\n"
            "initialize_from_env(backend='gloo', timeout_s=3)\n"
            "print('carried on')\n")
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and "carried on" not in out.stdout
    assert "DistStoreError" in out.stderr or "imed out" in out.stderr, \
        out.stderr[-2000:]
    beat = json.loads((tmp_path / "hb").read_text())
    assert beat["phase"] == "rendezvous"  # it never got past it


@pytest.mark.parametrize("world", [1, 2, 3])
def test_load_dataset_shards_matches_jax(tmp_path, world):
    from kubeflow_tpu.train import data as jd

    ds = jd.synthetic_lm_dataset(n_train=50, n_test=6, seq_len=8,
                                 vocab_size=32)
    jd.save_dataset_shards(ds, str(tmp_path / "j"), num_shards=5)
    td.save_dataset_shards(ds, str(tmp_path / "t"), num_shards=5)
    assert (tmp_path / "j" / "manifest.json").read_text() == \
        (tmp_path / "t" / "manifest.json").read_text()
    for rank in range(world):
        want = jd.load_dataset_shards(str(tmp_path / "j"), rank, world)
        got = td.load_dataset_shards(str(tmp_path / "j"), rank, world)
        for f in ("x_train", "y_train", "x_test", "y_test"):
            np.testing.assert_array_equal(getattr(got, f),
                                          getattr(want, f))
    with pytest.raises(ValueError, match="BOTH"):
        td.load_dataset_shards(str(tmp_path / "t"), 0)
    with pytest.raises(ValueError, match="cannot feed"):
        td.load_dataset_shards(str(tmp_path / "t"), 0, 6)
