"""The port's in-process serving fleet against the JAX package's.

A tiny GPT, initialized by the JAX package (``init`` from a seed) and handed
to the port through ``kubeflow_tpu_torch.convert``, serves behind
``kubeflow_tpu_torch.serving.fleet.FleetRouter`` over the port's engines on
CPU tensors (``attention="flash"``). The router drills of
tests/test_fleet.py and tests/test_decode.py run against it: least-loaded
routing, SLO admission sheds, the demand signal, replica kills with zero
drops (tokens equal to the JAX package's solo ``generate``), the seeded
tick-driven drill (its counts equal to the JAX router's over the JAX
engines on the same prompts), the disaggregated prefill/decode tier, and a
fleet-backed predictor behind ``ModelServer`` over HTTP.
"""

import json
import time
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from kubeflow_tpu.models import gpt as jg
from kubeflow_tpu.serving.continuous import ContinuousBatcher as JaxBatcher
from kubeflow_tpu.serving.fleet import FleetRouter as JaxRouter
from kubeflow_tpu.serving.fleet import PagedKVPool as JaxPool
from kubeflow_tpu.serving.fleet import (
    run_loadtest_sync as jax_run_loadtest_sync,
)
from kubeflow_tpu_torch.convert import gpt_params_from_flax
from kubeflow_tpu_torch.models import gpt as tg
from kubeflow_tpu_torch.serving.continuous import ContinuousBatcher
from kubeflow_tpu_torch.serving.fleet import (
    FleetOverloaded,
    FleetRouter,
    PagedKVPool,
    make_prompts,
    run_loadtest,
    run_loadtest_sync,
)
from kubeflow_tpu_torch.tracing import Tracer

try:  # one intra-op thread: the suite shares the machine with timing gates
    torch.set_num_threads(1)
    torch.set_num_interop_threads(1)
except RuntimeError:  # the interop pool can be sized once per process
    pass


@pytest.fixture(scope="module")
def lm():
    """(jax module, jax variables, port module) with the same weights."""
    jmodel = jg.GPTLM(jg.GPTConfig.tiny(dropout_rate=0.0, max_len=96),
                      pad_token_id=-1)
    variables = jax.jit(jmodel.init)(jax.random.PRNGKey(0),
                                     jnp.ones((1, 5), jnp.int32))
    flat = {k: np.asarray(v) for k, v in traverse_util.flatten_dict(
        variables["params"], sep="/").items()}
    tcfg = tg.GPTConfig.tiny(max_len=96, attention="flash",
                             attention_block=8)
    tmodel = tg.GPTLM(tcfg, device="cpu")
    tmodel.load_state_dict(gpt_params_from_flax(flat, tcfg))
    return jmodel, variables, tmodel.eval()


def prompt(seed, n, vocab=512):
    return np.random.RandomState(seed).randint(1, vocab, n).astype(np.int32)


def want(lm, p, budget):
    """The port's solo greedy decode."""
    return tg.generate(lm[2], torch.as_tensor(p[None], dtype=torch.long),
                       budget)[0].numpy()


def engines(lm, n, **kw):
    return [ContinuousBatcher(lm[2], max_rows=2, **kw) for _ in range(n)]


# -------------------------------------------------------------- router


def test_least_loaded_routing(lm):
    router = FleetRouter(engines(lm, 2))
    # park a heavy request without ticking: replica 0 carries load
    r1 = router.submit(prompt(70, 8), max_new_tokens=30)
    r2 = router.submit(prompt(71, 8), max_new_tokens=30)
    assert {r1.replica, r2.replica} == {"replica-0", "replica-1"}
    router.run_until_idle()
    assert r1.result(timeout=1).size == 30


def test_admission_shed_carries_retry_after(lm):
    router = FleetRouter(engines(lm, 1), ttft_slo_s=0.01,
                         service_rate_tokens_per_s=10.0)
    with pytest.raises(FleetOverloaded) as exc:
        router.submit(prompt(72, 8), max_new_tokens=8)
    assert exc.value.retry_after_s > 0
    assert router.metrics["requests_shed_total"] == 1
    assert router.metrics["requests_admitted_total"] == 0


def test_estimator_opens_admission_until_calibrated(lm):
    router = FleetRouter(engines(lm, 1), ttft_slo_s=0.01)
    req = router.submit(prompt(73, 6), max_new_tokens=4)
    router.run_until_idle()
    assert req.result(timeout=1).size == 4
    assert router.service_rate_tokens_per_s > 0


def test_demand_signal_tracks_backlog(lm):
    router = FleetRouter(engines(lm, 1), ttft_slo_s=0.05,
                         service_rate_tokens_per_s=100.0)
    assert router.demand_replicas() == 1
    router.ttft_slo_s = 1e9  # admit freely, then read the signal
    for i in range(6):
        router.submit(prompt(80 + i, 8), max_new_tokens=20)
    router.ttft_slo_s = 0.05
    assert router.demand_replicas() > 1
    # a burning serving SLO scales the queue signal, capped at 4x; a quiet
    # one leaves it alone
    def monitor(burn):
        return type("Monitor", (), {"describe": lambda self: [
            {"name": "serving_ttft_p99", "burn_rates": {"5m": burn}}]})()

    base = router.demand_replicas()
    assert router.demand_replicas_burn(monitor(100.0)) == 4 * base
    assert router.demand_replicas_burn(monitor(0.5)) == base
    router.ttft_slo_s = 0.0
    router.run_until_idle()
    assert router.demand_replicas() == 1


def test_drain_add_and_remove_replicas(lm):
    """begin_drain stops admission but the drained replica finishes its
    rows; a live admitting replica cannot be removed; add_replica joins
    the pool-sharing invariant."""
    pool = PagedKVPool(block_size=4, capacity_blocks=128)
    router = FleetRouter(engines(lm, 2, paged_kv=pool))
    seated = router.submit(prompt(90, 6), max_new_tokens=6)
    router.begin_drain(seated.replica)
    with pytest.raises(ValueError, match="still carries work"):
        router.remove_replica(seated.replica)
    later = router.submit(prompt(91, 6), max_new_tokens=6)
    assert later.replica != seated.replica
    router.cancel_drain(seated.replica)
    router.begin_drain(seated.replica)
    router.run_until_idle()
    for h, p in ((seated, prompt(90, 6)), (later, prompt(91, 6))):
        np.testing.assert_array_equal(h.result(timeout=1), want(lm, p, 6))
    assert router.remove_replica(seated.replica).draining
    with pytest.raises(ValueError, match="share one paged_kv"):
        router.add_replica(ContinuousBatcher(lm[2], max_rows=2))
    rep = router.add_replica(ContinuousBatcher(lm[2], max_rows=2,
                                               paged_kv=pool))
    assert rep.engine._fleet_managed and len(router.replicas) == 2


@pytest.fixture(scope="module")
def kill_prompts(lm):
    """Nine prompts and the JAX package's solo greedy decode of each."""
    jm, jv, _ = lm
    ps = [prompt(90 + i, 6 + (i % 3)) for i in range(9)]
    refs = {}
    gen = jax.jit(lambda v, x: jg.generate(jm, v, x, max_new_tokens=10))
    for n in (6, 7, 8):  # one batched call per prompt length
        rows = [i for i, p in enumerate(ps) if p.size == n]
        refs.update(zip(rows, np.asarray(gen(jv, jnp.asarray(np.stack(
            [ps[i] for i in rows]))))))
    return ps, [refs[i] for i in range(len(ps))]


def test_replica_kill_requeues_zero_drops(lm, kill_prompts):
    """The threaded drill: load on 3 replicas over one pool, the replica
    carrying the first request killed once it has its first token — every
    request completes with the JAX package's solo greedy tokens (requeued
    rows resume from their chain or re-decode exactly), zero drops."""
    prompts, jax_tokens = kill_prompts
    pool = PagedKVPool(block_size=4, capacity_blocks=256)
    router = FleetRouter(engines(lm, 3, paged_kv=pool, prefill_chunk=4))
    router.start()
    try:
        handles = [router.submit(p, max_new_tokens=10) for p in prompts]
        victim = handles[0].replica
        deadline = time.monotonic() + 30
        while handles[0].t_first is None and time.monotonic() < deadline:
            time.sleep(0.002)
        router.kill_replica(victim)
        for h in handles:
            assert h.done.wait(60), "request dropped after kill"
    finally:
        router.stop()
    m = router.metrics
    assert m["requests_completed_total"] == len(prompts)
    assert m["requests_failed_total"] == 0 and m["replica_kills_total"] == 1
    assert m["requests_requeued_total"] >= 1
    for h, ref in zip(handles, jax_tokens):
        np.testing.assert_array_equal(h.result(timeout=1), ref)
    assert all(c == 0 for c in pool.refcounts().values())


def test_seeded_sync_drill_matches_jax_router(lm):
    """The tick-driven drill with seed 7: arrivals, the kill mid-run, the
    requeues (resumed from chains or not) and the pool's reuse are the JAX
    router's over the JAX engines, count for count."""
    jm, jv, tm = lm
    prompts = make_prompts(12, seed=7, vocab=512, prompt_len=4,
                           shared_prefix=8)
    kw = dict(seed=7, mean_gap_ticks=0.7, new_tokens=6, kill_at_tick=5,
              kill_replica=1)
    pool = PagedKVPool(block_size=4, capacity_blocks=256)
    router = FleetRouter(engines(lm, 3, paged_kv=pool, prefill_chunk=4))
    s = run_loadtest_sync(router, prompts, **kw).summary()
    jpool = JaxPool(block_size=4, capacity_blocks=256)
    jrouter = JaxRouter([JaxBatcher(jm, jv, max_rows=2, paged_kv=jpool,
                                    prefill_chunk=4) for _ in range(3)])
    js = jax_run_loadtest_sync(jrouter, prompts, **kw).summary()
    keys = ("completed", "dropped", "shed", "requeued", "resumed",
            "resumed_tokens", "tokens_out", "prefill_tokens_total",
            "prefill_tokens_reused")
    assert {k: s[k] for k in keys} == {k: js[k] for k in keys}
    assert router.metrics == jrouter.metrics
    assert s["dropped"] == 0 and s["completed"] == 12
    assert s["requeued"] >= 1 and s["prefill_tokens_reused"] > 0
    assert router.metrics["replica_kills_total"] == 1
    assert pool.metrics == jpool.metrics


def test_activator_pick_is_queue_depth_aware(lm):
    """The load view an activator picks endpoints by is each live
    replica's pending tokens (queued prompt + budget, in-flight remaining
    budgets); the router's own pick is its minimum."""
    router = FleetRouter(engines(lm, 3))
    router.replicas[0].engine.submit(prompt(1, 8), max_new_tokens=40)
    router.replicas[2].engine.submit(prompt(2, 4), max_new_tokens=4)
    assert router.load_view() == {"replica-0": 48, "replica-1": 0,
                                  "replica-2": 8}
    assert router._pick().name == "replica-1"
    router.kill_replica("replica-1")
    assert "replica-1" not in router.load_view()
    assert router._pick().name == "replica-2"


# -------------------------------------------------- disaggregated tier


def disagg(lm, pool, prefill=1, decode=2):
    def mk(**kw):
        return ContinuousBatcher(lm[2], max_rows=2, paged_kv=pool,
                                 prefill_chunk=4, **kw)

    return FleetRouter(
        [(f"prefill-{i}", mk(max_chunks_per_tick=2), "prefill")
         for i in range(prefill)]
        + [(f"decode-{i}", mk(), "decode") for i in range(decode)])


def test_long_prompts_never_occupy_a_decode_slot(lm):
    """Every prompt prefills on the prefill tier, the chain hands off
    through the shared pool, and the decode tier computes ZERO prompt
    positions; tokens are solo generate's."""
    pool = PagedKVPool(block_size=4, capacity_blocks=512)
    router = disagg(lm, pool)
    prompts = [prompt(60 + i, 10 + 4 * (i % 3)) for i in range(6)]
    handles = [router.submit(p, max_new_tokens=8) for p in prompts]
    router.run_until_idle()
    for p, h in zip(prompts, handles):
        np.testing.assert_array_equal(h.result(timeout=1), want(lm, p, 8))
    assert router.metrics["prefill_handoffs_total"] == 6
    assert sum(r.engine.prefill_tokens_total for r in router.replicas
               if r.role == "decode") == 0
    assert all(c == 0 for c in pool.refcounts().values())


def test_kill_mid_decode_resumes_from_surviving_chain(lm):
    """The seeded disaggregated kill drill: dropped 0, at least one
    request resumed from its surviving blocks, fewer re-decoded from
    scratch than requeued."""
    pool = PagedKVPool(block_size=4, capacity_blocks=512)
    router = disagg(lm, pool)
    prompts = make_prompts(10, seed=7, vocab=512, prompt_len=6,
                           shared_prefix=8)
    s = run_loadtest_sync(router, prompts, seed=7, mean_gap_ticks=0.8,
                          new_tokens=8, kill_at_tick=12,
                          kill_replica="decode-0").summary()
    assert s["dropped"] == 0 and s["completed"] == 10
    assert s["requeued"] >= 1
    assert s["resumed"] >= 1 and s["resumed_tokens"] >= 1
    assert s["requeued"] - s["resumed"] < s["requeued"]


def test_kill_between_handoff_and_seating_still_resumes(lm):
    """The decode replica dies while the handed-off request is still QUEUED
    on it: the chain still resumes (judged by the router's own token
    record), and the client's stream carries no duplicate."""
    pool = PagedKVPool(block_size=4, capacity_blocks=512)
    router = disagg(lm, pool)
    pre = router.replicas[0].engine
    p = prompt(76, 10)
    streamed = []
    h = router.submit(p, max_new_tokens=6,
                      on_token=lambda _h, t: streamed.append(int(t)))
    for _ in range(12):
        pre.tick()
        if router.metrics["prefill_handoffs_total"]:
            break
    assert router.metrics["prefill_handoffs_total"] == 1
    router.kill_replica("decode-0")
    router.run_until_idle()
    ref = want(lm, p, 6)
    np.testing.assert_array_equal(h.result(timeout=1), ref)
    assert router.metrics["requeues_resumed_total"] == 1
    assert streamed == [int(t) for t in ref]
    assert all(c == 0 for c in pool.refcounts().values())


def test_frozen_prefill_chain_takes_chainless_fallback(lm):
    """A strict prefix of an in-flight prompt, ending mid-block, publishes
    a FROZEN chain: the handoff takes the chainless fallback, both
    complete exactly, and the client stream carries each position once."""
    pool = PagedKVPool(block_size=4, capacity_blocks=512)
    router = disagg(lm, pool, prefill=1, decode=1)
    a = prompt(75, 10)
    b = a[:9]
    streamed = []
    ha = router.submit(a, max_new_tokens=8)
    hb = router.submit(b, max_new_tokens=6,
                       on_token=lambda _h, t: streamed.append(int(t)))
    router.run_until_idle()
    np.testing.assert_array_equal(ha.result(timeout=1), want(lm, a, 8))
    want_b = want(lm, b, 6)
    np.testing.assert_array_equal(hb.result(timeout=1), want_b)
    assert router.metrics["prefill_handoffs_total"] == 1
    assert streamed == [int(t) for t in want_b]
    assert all(c == 0 for c in pool.refcounts().values())


def test_tier_wipe_and_mixed_kill_resume(lm):
    """Roles are routing policy: with the only prefill replica killed the
    decode tier prefills for itself. A mixed fleet's kill requeue resumes
    from the chain too."""
    pool = PagedKVPool(block_size=4, capacity_blocks=512)
    router = disagg(lm, pool)
    router.kill_replica("prefill-0")
    p = prompt(70, 12)
    h = router.submit(p, max_new_tokens=6)
    router.run_until_idle()
    np.testing.assert_array_equal(h.result(timeout=1), want(lm, p, 6))
    pool = PagedKVPool(block_size=4, capacity_blocks=512)
    router = FleetRouter(engines(lm, 3, paged_kv=pool, prefill_chunk=4))
    prompts = make_prompts(12, seed=7, vocab=512, prompt_len=4,
                           shared_prefix=8)
    s = run_loadtest_sync(router, prompts, seed=7, mean_gap_ticks=0.7,
                          new_tokens=6, kill_at_tick=5,
                          kill_replica=1).summary()
    assert s["dropped"] == 0 and s["completed"] == 12
    assert s["resumed"] >= 1
    assert router.metrics["requeue_resumed_tokens_total"] \
        == s["resumed_tokens"]


def test_disagg_guards(lm):
    def mk(**kw):
        return ContinuousBatcher(lm[2], max_rows=2, **kw)

    with pytest.raises(ValueError, match="shared paged_kv"):
        FleetRouter([("p", mk(paged_kv=PagedKVPool()), "prefill"),
                     ("d", mk(paged_kv=PagedKVPool()), "decode")])
    with pytest.raises(ValueError, match="shared paged_kv"):
        FleetRouter([("p", mk(), "prefill"), ("d", mk(), "decode")])
    pool = PagedKVPool()
    with pytest.raises(ValueError, match="decode-capable"):
        FleetRouter([("p", mk(paged_kv=pool), "prefill")])
    with pytest.raises(ValueError, match="unknown replica role"):
        FleetRouter([("x", mk(), "verifier")])
    router = FleetRouter([("p", mk(paged_kv=pool), "prefill"),
                          ("d", mk(paged_kv=pool), "decode")])
    with pytest.raises(ValueError, match="shared paged_kv"):
        router.add_replica(mk())
    with pytest.raises(ValueError, match="shared paged_kv"):
        router.add_replica(mk(paged_kv=PagedKVPool()), role="decode")
    with pytest.raises(ValueError, match="unknown replica role"):
        router.add_replica(mk(paged_kv=pool), role="verifier")
    rep = router.add_replica(mk(paged_kv=pool), role="decode")
    assert rep.role == "decode" and len(router.replicas) == 3


# ------------------------------------------------------- serving surface


def http(url, body=None):
    req = urllib.request.Request(
        url, data=None if body is None else json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, json.loads(r.read()), r.headers
    except urllib.error.HTTPError as exc:
        return exc.code, json.loads(exc.read()), exc.headers


def test_fleet_model_server_timing_and_shed(lm, tmp_path):
    """A fleet-backed predictor behind ModelServer serves v1 with the
    engine's timing block and the JAX package's greedy tokens; an
    admission shed answers 503 with Retry-After >= 1 and a body carrying
    the shed decision's trace context and request id."""
    from kubeflow_tpu_torch.serving.model import TorchModel, save_predictor
    from kubeflow_tpu_torch.serving.server import ModelServer

    jm, jv, tm = lm
    p0 = prompt(95, 8)[None]
    d = save_predictor(
        tmp_path / "fleet-gpt", "gpt-lm", tm.state_dict(), p0,
        generate={"continuous": True, "fleet_replicas": 2,
                  "prefill_chunk": 4, "paged_kv_block": 4,
                  "max_new_tokens": 6, "fleet_retry_after_s": 2.4},
        size="tiny", config={"max_len": 96})
    m = TorchModel("fleet-gpt", d, device="cpu")
    srv = ModelServer([m], port=0).start()
    try:
        assert m._fleet is not None and len(m._fleet.replicas) == 2
        assert m._engine is None
        url = f"{srv.url}/v1/models/fleet-gpt:predict"
        code, body, _ = http(url, {"instances": p0.tolist()})
        assert code == 200
        np.testing.assert_array_equal(
            np.asarray(body["predictions"])[0],
            np.asarray(jax.jit(lambda v, x: jg.generate(
                jm, v, x, max_new_tokens=6))(jv, jnp.asarray(p0)))[0])
        assert body["timing"]["ttft_s"] >= 0
        assert body["timing"]["tokens_per_s"] > 0
        # force a shed: 503 + Retry-After on the wire
        m._fleet.tracer = Tracer()
        m._fleet.ttft_slo_s = 1e-9
        m._fleet._rate = 1.0
        code, body, headers = http(url, {"instances": p0.tolist()})
        assert code == 503 and int(headers["Retry-After"]) >= 1
        assert body["request_id"] and body["trace"]
        assert "exceeds SLO" in body["error"]
        assert m._fleet.metrics["requests_shed_total"] == 1
    finally:
        srv.stop()


def test_threaded_loadtest_report(lm):
    router = FleetRouter(engines(lm, 2))
    prompts = make_prompts(6, seed=3, vocab=512, prompt_len=(4, 8))
    s = run_loadtest(router, prompts, seed=3, mean_gap_s=0.002,
                     new_tokens=5, timeout_s=60).summary()
    assert s["dropped"] == 0 and s["completed"] == 6
    assert s["ttft_p99_s"] >= s["ttft_p50_s"] > 0
    assert s["tokens_out"] == 30
    # the run started every replica's ticker and stopped it again
    assert all(r.engine._thread is None for r in router.replicas)
