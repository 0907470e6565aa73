"""The port's FleetScaler against the JAX package's.

The scaler drills of tests/test_soak.py run twice on the same seeded
inputs: once on the JAX package (its FleetRouter, FleetScaler and engines)
and once on the port's, over port engines on CPU tensors (a tiny GPT with
the JAX init's weights, ``attention="flash"``). Each drill asserts its
contract on both sides and returns what it observed — every
``evaluate()`` decision record, the scaler's and router's counters, the
tokens served — and the two records must be equal: the port's scaler
makes the JAX scaler's decisions.
"""

from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from kubeflow_tpu.models import gpt as jg
from kubeflow_tpu.profiling import scaler_shape
from kubeflow_tpu.serving import continuous as jax_continuous
from kubeflow_tpu.serving import fleet as jax_fleet
from kubeflow_tpu.serving.fleet import scaler as jax_scaler_module
from kubeflow_tpu.tracing import Tracer as JaxTracer
from kubeflow_tpu_torch.convert import gpt_params_from_flax
from kubeflow_tpu_torch.models import gpt as tg
from kubeflow_tpu_torch.serving import continuous as port_continuous
from kubeflow_tpu_torch.serving import fleet as port_fleet
from kubeflow_tpu_torch.serving.fleet import scaler as port_scaler_module
from kubeflow_tpu_torch.tracing import Tracer as PortTracer

try:  # one intra-op thread: the suite shares the machine with timing gates
    torch.set_num_threads(1)
    torch.set_num_interop_threads(1)
except RuntimeError:  # the interop pool can be sized once per process
    pass

GOLDEN_SHAPE = Path(__file__).resolve().parent / "golden" / \
    "trace_shape_scaler.txt"


@pytest.fixture(scope="module")
def sides():
    """{"jax": ..., "port": ...}: each package's fleet classes and an
    engine factory over one set of weights (the JAX init's)."""
    cfg = jg.GPTConfig.tiny(dropout_rate=0.0, max_len=96)
    model = jg.GPTLM(cfg)
    variables = jax.jit(model.init)(jax.random.PRNGKey(0),
                                    jnp.zeros((1, 8), jnp.int32))
    flat = {k: np.asarray(v) for k, v in traverse_util.flatten_dict(
        variables["params"], sep="/").items()}
    tcfg = tg.GPTConfig.tiny(max_len=96, attention="flash",
                             attention_block=8)
    tmodel = tg.GPTLM(tcfg, device="cpu")
    tmodel.load_state_dict(gpt_params_from_flax(flat, tcfg))
    tmodel.eval()

    def side(fleet, continuous, scaler_module, tracer, build):
        def engine(pool=None, rows=2, **kw):
            kw.setdefault("default_max_new_tokens", 6)
            return build(continuous.ContinuousBatcher, max_rows=rows,
                         paged_kv=pool,
                         prefill_chunk=4 if pool is not None else 0, **kw)

        return SimpleNamespace(
            Router=fleet.FleetRouter, Scaler=fleet.FleetScaler,
            Config=fleet.ScalerConfig, Pool=fleet.PagedKVPool,
            Overloaded=fleet.FleetOverloaded, Tracer=tracer,
            scaler_module=scaler_module, engine=engine)

    return {
        "jax": side(jax_fleet, jax_continuous, jax_scaler_module,
                    JaxTracer,
                    lambda cls, **kw: cls(model, variables, **kw)),
        "port": side(port_fleet, port_continuous, port_scaler_module,
                     PortTracer, lambda cls, **kw: cls(tmodel, **kw)),
    }


def both(sides, drill):
    """Run `drill` on each package; the two records must be equal."""
    got = {name: drill(s) for name, s in sides.items()}
    assert got["port"] == got["jax"]
    return got["port"]


def _prompt(seed, n, vocab=512):
    rng = np.random.default_rng(seed)
    return rng.integers(1, vocab, size=(n,)).astype(np.int32)


def _tick_until(router, scaler=None, n=200):
    records = []
    for _ in range(n):
        busy = False
        for rep in list(router.replicas):
            if rep.alive:
                busy = rep.engine.tick() or busy
        if scaler is not None:
            records.append(scaler.evaluate())
        if not busy and router.queue_depth() == 0:
            return records
    raise AssertionError("fleet did not drain")


def _scripted(s, demands, config, tracer=None):
    """A scaler driven by a scripted demand sequence (these drills pin the
    LOOP, not the demand math)."""
    router = s.Router([s.engine()], tracer=tracer)
    seq = iter(demands)
    last = [1]

    def scripted():
        last[0] = next(seq, last[0])
        return last[0]

    router.demand_replicas = scripted
    return router, s.Scaler(router, lambda: s.engine(), config,
                            tracer=tracer)


def _state(router, scaler=None) -> dict:
    out = {"router": dict(router.metrics),
           "replicas": [(r.name, r.alive, r.draining)
                        for r in router.replicas]}
    if scaler is not None:
        metrics = dict(scaler.metrics)
        # the port's scaler has no chip ledger (ROADMAP A12); the JAX
        # scaler, given none, never denies
        assert metrics.pop("chip_denies_total", 0) == 0
        out["scaler"] = metrics
        out["target"] = scaler.target_replicas
    return out


# --------------------------------------------- demand-signal zero guards


def test_nonempty_queue_never_demands_zero(sides):
    def drill(s):
        router = s.Router([s.engine()])
        router.submit(_prompt(1, 6), max_new_tokens=4)
        seen = [router.demand_replicas()]
        router.begin_drain(0)  # serving set now empty, backlog remains
        seen.append(router.demand_replicas())
        router.cancel_drain(0)
        router.run_until_idle()
        seen.append(router.demand_replicas())
        assert seen[0] >= 1 and seen[1] >= 1 and seen[2] == 1
        return seen, _state(router)

    both(sides, drill)


def test_arrival_on_empty_fleet_demands_one(sides):
    def drill(s):
        router = s.Router([s.engine()])
        router.begin_drain(0)
        router.remove_replica(0)
        assert router.replicas == []
        assert router.demand_replicas() == 0  # truly idle: zero is legal
        with pytest.raises(s.Overloaded) as exc:
            router.submit(_prompt(2, 4), max_new_tokens=2)
        assert exc.value.retry_after_s > 0
        assert router.wake_pending() == 1
        assert router.demand_replicas() == 1
        router.clear_wake()
        assert router.demand_replicas() == 0
        return exc.value.retry_after_s, _state(router)

    both(sides, drill)


def test_draining_replica_excluded_from_picks(sides):
    def drill(s):
        router = s.Router([("a", s.engine()), ("b", s.engine())])
        router.begin_drain("a")
        req = router.submit(_prompt(3, 5), max_new_tokens=3)
        assert req.replica == "b"
        router.run_until_idle()
        return req.result(timeout=1).tolist(), _state(router)

    assert len(both(sides, drill)[0]) == 3


def test_remove_replica_refuses_live_work(sides):
    def drill(s):
        router = s.Router([s.engine()])
        router.submit(_prompt(4, 5), max_new_tokens=3)
        with pytest.raises(ValueError, match="drain"):
            router.remove_replica(0)
        router.begin_drain(0)
        with pytest.raises(ValueError, match="carries work"):
            router.remove_replica(0)
        router.run_until_idle()
        router.remove_replica(0)
        assert router.replicas == []
        return _state(router)

    both(sides, drill)


# ------------------------------------------------------------ the scaler


def test_scale_up_cooldown_and_step_bound(sides):
    def drill(s):
        router, scaler = _scripted(
            s, [8] * 10,
            s.Config(min_replicas=1, max_replicas=6,
                     scale_up_cooldown_evals=2, max_step_up=2))
        records, sizes = [], []
        for _ in range(6):
            records.append(scaler.evaluate())
            sizes.append(len(router._admittable()))
        # +2 (step bound), cooldown, +2, ..., clamped at max_replicas
        assert sizes == [3, 3, 5, 5, 6, 6]
        assert scaler.target_replicas == 6
        return records, _state(router, scaler)

    both(sides, drill)


def test_scale_down_needs_stable_low_demand(sides):
    def drill(s):
        router, scaler = _scripted(
            s, [3, 3, 1, 3, 1, 1, 1, 1, 1, 1],
            s.Config(min_replicas=1, max_replicas=4,
                     scale_up_cooldown_evals=1,
                     scale_down_stable_evals=3, max_step_up=3))
        records = [scaler.evaluate() for _ in range(4)]
        assert len(router._admittable()) == 3  # the dip was forgotten
        assert scaler.metrics["scale_downs_total"] == 0
        records += [scaler.evaluate() for _ in range(3)]
        assert scaler.metrics["scale_downs_total"] == 1
        assert sum(1 for r in router.replicas if r.draining) == 1
        return records, _state(router, scaler)

    both(sides, drill)


def test_graceful_drain_completes_without_requeue(sides):
    def drill(s):
        pool = s.Pool(block_size=4, capacity_blocks=256)
        released = []
        router = s.Router([("a", s.engine(pool)), ("b", s.engine(pool))])
        scaler = s.Scaler(
            router, lambda: s.engine(pool),
            s.Config(min_replicas=1, max_replicas=2,
                     scale_down_stable_evals=1, drain_grace_evals=50),
            on_release=released.append)
        reqs = [router.submit(_prompt(10 + i, 6), max_new_tokens=4)
                for i in range(4)]
        router.demand_replicas = lambda: 1  # force scale-down pressure
        records = [scaler.evaluate()]
        assert scaler.metrics["scale_downs_total"] == 1
        records += _tick_until(router, scaler)
        tokens = [r.result(timeout=1).tolist() for r in reqs]
        assert router.metrics["requests_requeued_total"] == 0
        assert scaler.metrics["drains_completed_total"] == 1
        assert scaler.metrics["drain_kills_total"] == 0
        assert len(released) == 1 and len(router.replicas) == 1
        return records, tokens, _state(router, scaler)

    both(sides, drill)


def test_drain_timeout_polite_kill_is_loss_free(sides):
    """A drain finished as a polite kill with in-flight decodes
    chain-resumes every request onto the survivor: token-identical to
    solo generation, scratch-requeue fraction 0."""
    def drill(s):
        prompts = [_prompt(40 + i, 6) for i in range(3)]
        solo = s.engine(s.Pool(block_size=4, capacity_blocks=256),
                        rows=3)
        expect = []
        for p in prompts:
            h = solo.submit(p, max_new_tokens=6)
            solo.run_until_idle()
            expect.append(h.result(timeout=0).tolist())
        pool = s.Pool(block_size=4, capacity_blocks=256)
        a, b = s.engine(pool, rows=3), s.engine(pool, rows=3)
        router = s.Router([("a", a), ("b", b)])
        scaler = s.Scaler(
            router, lambda: s.engine(pool),
            s.Config(min_replicas=1, max_replicas=2,
                     scale_down_stable_evals=1, drain_grace_evals=0))
        # b is made heavier so the drill prompts land on a, and a is
        # the least-loaded drain victim
        for i in range(2):
            b.submit(_prompt(80 + i, 5), max_new_tokens=24)
        handles = [router.submit(p, max_new_tokens=6) for p in prompts]
        assert all(h.replica == "a" for h in handles)
        for _ in range(9):
            a.tick()  # chunks admitted, first decode steps taken
        assert all(len(h.tokens) > 0 for h in handles)
        router.demand_replicas = lambda: 1
        records = [scaler.evaluate()]  # begins draining a
        assert next(r for r in router.replicas if r.name == "a").draining
        records.append(scaler.evaluate())  # grace 0: polite kill
        assert scaler.metrics["drain_kills_total"] == 1
        records += _tick_until(router, scaler)
        tokens = [h.result(timeout=1).tolist() for h in handles]
        assert tokens == expect
        requeued = router.metrics["requests_requeued_total"]
        assert requeued >= 1
        assert router.metrics["requeues_resumed_total"] == requeued
        assert router.metrics["requeue_resumed_tokens_total"] >= 1
        return records, tokens, _state(router, scaler)

    both(sides, drill)


def test_scale_to_zero_and_wake_on_arrival(sides):
    def drill(s):
        pool = s.Pool(block_size=4, capacity_blocks=256)
        router = s.Router([s.engine(pool)])
        scaler = s.Scaler(
            router, lambda: s.engine(pool),
            s.Config(min_replicas=0, max_replicas=2,
                     idle_to_zero_evals=3, scale_up_cooldown_evals=1))
        records = [scaler.evaluate() for _ in range(5)]
        assert router.replicas == []
        assert scaler.metrics["scale_to_zero_total"] == 1
        with pytest.raises(s.Overloaded):  # shed with a hint
            router.submit(_prompt(60, 5), max_new_tokens=3)
        records.append(scaler.evaluate())  # the loop answers
        assert scaler.metrics["scale_from_zero_total"] == 1
        assert len(router._admittable()) == 1
        req = router.submit(_prompt(60, 5), max_new_tokens=3)  # re-dial
        router.run_until_idle()
        return records, req.result(timeout=1).tolist(), \
            _state(router, scaler)

    assert len(both(sides, drill)[1]) == 3


def test_hang_detection_kills_and_replaces(sides):
    def drill(s):
        pool = s.Pool(block_size=4, capacity_blocks=256)
        router = s.Router([s.engine(pool)])
        scaler = s.Scaler(
            router, lambda: s.engine(pool),
            s.Config(min_replicas=1, max_replicas=3, hang_detect_evals=3))
        req = router.submit(_prompt(70, 6), max_new_tokens=4)
        # the hang: the engine is never ticked; only the scaler evaluates
        records = [scaler.evaluate() for _ in range(4)]
        assert scaler.metrics["hangs_detected_total"] == 1
        assert len(router._admittable()) >= 1
        records += _tick_until(router, scaler)
        assert req.error is None
        assert router.metrics["requests_requeued_total"] >= 1
        return records, req.result(timeout=1).tolist(), \
            _state(router, scaler)

    assert len(both(sides, drill)[1]) == 4


def test_fleet_wide_stall_never_hang_kills(sides):
    """No replica progressing is systemic: nothing is hang-killed; once
    one replica advances, the stalled peers are indicted against it and
    their work rescued."""
    def drill(s):
        pool = s.Pool(block_size=4, capacity_blocks=256)
        router = s.Router([s.engine(pool) for _ in range(3)])
        scaler = s.Scaler(
            router, lambda: s.engine(pool),
            s.Config(min_replicas=1, max_replicas=3, hang_detect_evals=3))
        reqs = [router.submit(_prompt(100 + i, 5), max_new_tokens=3)
                for i in range(6)]
        records = [scaler.evaluate() for _ in range(10)]
        assert scaler.metrics["hangs_detected_total"] == 0
        assert router.metrics["requests_failed_total"] == 0
        assert len(router._alive()) == 3
        for _ in range(6):
            router.replicas[0].engine.tick()
            records.append(scaler.evaluate())
        assert scaler.metrics["hangs_detected_total"] >= 1
        records += _tick_until(router, scaler)
        tokens = [r.result(timeout=1).tolist() for r in reqs]
        assert router.metrics["requests_failed_total"] == 0
        return records, tokens, _state(router, scaler)

    both(sides, drill)


def test_frozen_scaler_evaluates_but_never_acts(sides):
    def drill(s):
        router, scaler = _scripted(s, [5] * 4, s.Config(max_replicas=5))
        scaler.freeze()
        records = [scaler.evaluate() for _ in range(4)]
        assert len(router._admittable()) == 1
        assert scaler.metrics["frozen_evaluations_total"] == 4
        assert scaler.metrics["scale_ups_total"] == 0
        scaler.thaw()
        records.append(scaler.evaluate())
        assert scaler.metrics["scale_ups_total"] == 1
        return records, _state(router, scaler)

    both(sides, drill)


def test_undrain_is_the_cheapest_scale_up(sides):
    """Demand returning before a drain finishes cancels the drain instead
    of cold-starting a new engine."""
    def drill(s):
        builds = []

        def factory():
            builds.append(1)
            return s.engine()

        a, b = s.engine(), s.engine()
        router = s.Router([("a", a), ("b", b)])
        a.submit(_prompt(90, 6), max_new_tokens=20)
        a.submit(_prompt(91, 6), max_new_tokens=20)
        b.submit(_prompt(92, 6), max_new_tokens=4)
        demands = iter([1, 1, 2])
        last = [2]

        def scripted():
            last[0] = next(demands, last[0])
            return last[0]

        router.demand_replicas = scripted
        scaler = s.Scaler(
            router, factory,
            s.Config(min_replicas=1, max_replicas=2,
                     scale_down_stable_evals=2, scale_up_cooldown_evals=1,
                     drain_grace_evals=50, hang_detect_evals=50))
        records = [scaler.evaluate(), scaler.evaluate()]
        assert sum(1 for r in router.replicas if r.draining) == 1
        records.append(scaler.evaluate())  # undrain, not a cold start
        assert sum(1 for r in router.replicas if r.draining) == 0
        assert len(router._admittable()) == 2
        assert builds == []
        router.run_until_idle()
        return records, _state(router, scaler)

    both(sides, drill)


def test_cold_start_ewma(sides, monkeypatch):
    """Each scale-up's observed cold start feeds the EWMA (weight 0.3):
    the first reading is taken whole, later ones blend in."""
    def drill(s):
        clock = [0.0]
        monkeypatch.setattr(s.scaler_module, "time",
                            SimpleNamespace(perf_counter=lambda: clock[0]))

        def factory():
            clock[0] += 2.0 if clock[0] else 1.0  # cold starts 1 s, 2 s
            return s.engine()

        router, scaler = _scripted(
            s, [2, 2, 3], s.Config(min_replicas=1, max_replicas=3,
                                   scale_up_cooldown_evals=1))
        scaler.engine_factory = factory
        seen = []
        for _ in range(3):
            scaler.evaluate()
            seen.append(scaler.cold_start_ewma_s)
        monkeypatch.undo()
        return seen, _state(router, scaler)

    seen = both(sides, drill)[0]
    assert seen == [1.0, 1.0, pytest.approx(0.7 * 1.0 + 0.3 * 2.0)]


def test_scaler_decisions_golden_shape(sides):
    """Every fleet.scale_up/scale_down event parent-links to the
    scaler.evaluate that triggered it: the port's decision trace renders
    the JAX package's golden shape."""
    def drill(s):
        tracer = s.Tracer(capacity=512)
        router, scaler = _scripted(
            s, [3, 1, 1, 1, 0, 0, 0, 0],
            s.Config(min_replicas=0, max_replicas=4,
                     scale_up_cooldown_evals=2, scale_down_stable_evals=3,
                     idle_to_zero_evals=6, max_step_up=2),
            tracer=tracer)
        records = [scaler.evaluate() for _ in range(8)]
        assert router.replicas == []
        assert scaler.metrics["drain_kills_total"] == 0
        return scaler_shape(tracer.snapshot()), records, \
            _state(router, scaler)

    assert both(sides, drill)[0] == GOLDEN_SHAPE.read_text()
