"""Seeded fleet load-test harness — the serving analogue of the chaos
drills; counterpart of ``kubeflow_tpu/serving/fleet/loadtest.py``.

A recovery claim that only production traffic can falsify is
unfalsifiable; this harness makes it falsifiable for serving: OPEN-LOOP seeded
arrivals (the arrival process does not slow down because the fleet did —
the production failure mode closed-loop benchmarks hide), per-request
TTFT and tokens/sec accounting from the engine's own token timestamps,
and an optional mid-run replica kill whose acceptance bar is ZERO
dropped requests (the router requeues everything the dead replica
carried).

Two drive modes share one report shape:

  - ``run_loadtest`` (threaded): replicas tick on their serving threads,
    arrivals sleep out a seeded exponential schedule in wall seconds,
    the kill fires once enough requests are in — the integration drill.
  - ``run_loadtest_sync`` (tick-driven): no threads, no sleeps — one
    round-robin tick across live replicas per step, arrivals and the
    kill scheduled in TICK units. Everything the run does is engine
    work, so TTFT expressed in anchor units is machine-speed invariant —
    the mode a seeded drill's counts are compared in.

Requests may carry a shared prefix (`shared_prefix` tokens prepended to
every prompt) to exercise paged-KV prefix reuse under load.
"""

from __future__ import annotations

import random
import threading
import time
from dataclasses import dataclass, field

import numpy as np

from kubeflow_tpu_torch.serving.fleet.router import (
    FleetOverloaded,
    FleetRouter,
)


@dataclass
class LoadReport:
    """What a load run proved: completion accounting (dropped MUST be 0
    under a replica kill — the requeue contract), TTFT/token-rate
    percentiles, and the prefill-unit ledger backing prefix-reuse
    claims."""

    n_requests: int
    completed: int = 0
    shed: int = 0
    dropped: int = 0
    requeued: int = 0
    # the resume-from-KV rescue split: requeues that resumed from the
    # dead replica's surviving block chain vs. re-decoded from scratch
    # (requeued - resumed), plus the tokens those resumes salvaged
    resumed: int = 0
    resumed_tokens: int = 0
    ttft_s: list = field(default_factory=list)
    tokens_per_s: list = field(default_factory=list)
    # per-request shed-retry attribution (threaded mode): how many
    # submit attempts each request took and how long it spent in
    # CLIENT-side Retry-After backoff — kept apart from TTFT so the
    # harness percentiles separate server-side queueing from the
    # client's own waiting (previously conflated into wall time)
    attempts: list = field(default_factory=list)
    retry_wait_s: list = field(default_factory=list)
    wall_s: float = 0.0
    ticks: int = 0  # sync mode: round-robin loop passes driven
    tokens_out: int = 0
    prefill_tokens_total: int = 0
    prefill_tokens_reused: int = 0

    @staticmethod
    def _pct(samples: list, q: float) -> float:
        if not samples:
            return 0.0
        s = sorted(samples)
        return s[min(len(s) - 1, int(len(s) * q))]

    def summary(self) -> dict:
        return {
            "n_requests": self.n_requests,
            "completed": self.completed,
            "shed": self.shed,
            "dropped": self.dropped,
            "requeued": self.requeued,
            "resumed": self.resumed,
            "resumed_tokens": self.resumed_tokens,
            "wall_s": round(self.wall_s, 6),
            "tokens_out": self.tokens_out,
            "tokens_per_s_total": (
                round(self.tokens_out / self.wall_s, 3)
                if self.wall_s > 0 else 0.0),
            "ttft_p50_s": round(self._pct(self.ttft_s, 0.50), 6),
            "ttft_p99_s": round(self._pct(self.ttft_s, 0.99), 6),
            "row_tokens_per_s_p50": round(
                self._pct(self.tokens_per_s, 0.50), 3),
            "prefill_tokens_total": self.prefill_tokens_total,
            "prefill_tokens_reused": self.prefill_tokens_reused,
            "retried": sum(1 for a in self.attempts if a > 1),
            "attempts_mean": round(
                sum(self.attempts) / len(self.attempts), 3)
            if self.attempts else 0.0,
            "retry_wait_p50_s": round(
                self._pct(self.retry_wait_s, 0.50), 6),
            "retry_wait_p99_s": round(
                self._pct(self.retry_wait_s, 0.99), 6),
        }


def make_prompts(n: int, seed: int, vocab: int, prompt_len,
                 shared_prefix: int = 0) -> list[np.ndarray]:
    """Seeded request prompts; `prompt_len` is an int or (lo, hi). The
    first `shared_prefix` tokens are IDENTICAL across requests (the
    system-prompt shape paged KV exists for)."""
    rng = random.Random(seed)
    lo, hi = ((prompt_len, prompt_len) if isinstance(prompt_len, int)
              else prompt_len)
    prefix = np.asarray([rng.randrange(1, vocab)
                         for _ in range(shared_prefix)], np.int32)
    out = []
    for _ in range(n):
        n_tok = rng.randint(lo, hi)
        body = np.asarray([rng.randrange(1, vocab) for _ in range(n_tok)],
                          np.int32)
        out.append(np.concatenate([prefix, body]) if shared_prefix
                   else body)
    return out


def _counters(router: FleetRouter) -> dict:
    """Snapshot of the cumulative counters a run reports as DELTAS, so a
    reused router/pool (warmup traffic, back-to-back runs) can never
    inflate a report — LoadReport states what THIS run proved."""
    return {
        "requeued": router.metrics["requests_requeued_total"],
        "resumed": router.metrics["requeues_resumed_total"],
        "resumed_tokens": router.metrics["requeue_resumed_tokens_total"],
        "prefill_total": sum(r.engine.prefill_tokens_total
                             for r in router.replicas),
        "prefill_reused": sum(r.engine.prefill_tokens_reused
                              for r in router.replicas),
    }


def _collect(router: FleetRouter, report: LoadReport, handles: list,
             base: dict) -> LoadReport:
    for h in handles:
        if h is None:
            continue
        if h.error is not None or not h.done.is_set():
            report.dropped += 1
            continue
        report.completed += 1
        report.tokens_out += len(h.tokens)
        if h.ttft_s is not None:
            report.ttft_s.append(h.ttft_s)
        if h.tokens_per_s is not None:
            report.tokens_per_s.append(h.tokens_per_s)
    now = _counters(router)
    report.requeued = now["requeued"] - base["requeued"]
    report.resumed = now["resumed"] - base["resumed"]
    report.resumed_tokens = now["resumed_tokens"] - base["resumed_tokens"]
    report.prefill_tokens_total = now["prefill_total"] \
        - base["prefill_total"]
    report.prefill_tokens_reused = now["prefill_reused"] \
        - base["prefill_reused"]
    return report


def run_loadtest(router: FleetRouter, prompts: list[np.ndarray],
                 seed: int = 0, mean_gap_s: float = 0.005,
                 new_tokens: int = 8, kill_after: int = 0,
                 kill_replica=None, timeout_s: float = 120.0,
                 shed_retries: int = 2) -> LoadReport:
    """Threaded open-loop run: seeded exponential inter-arrival gaps,
    optional replica kill once `kill_after` requests have been submitted
    (0 = before the first, mirroring run_loadtest_sync's kill_at_tick).
    Shed requests re-dial after the router's Retry-After hint up to
    `shed_retries` times (the serving/client.py contract) — a shed that
    exhausts its retries counts `shed`, never silently vanishes."""
    rng = random.Random(seed)
    gaps = [rng.expovariate(1.0 / mean_gap_s) if mean_gap_s > 0 else 0.0
            for _ in prompts]
    report = LoadReport(n_requests=len(prompts))
    handles: list = [None] * len(prompts)
    base = _counters(router)
    pacer = threading.Event()  # deadline-style waits, not naked sleeps
    router.start()
    t0 = time.perf_counter()
    try:
        for i, (p, gap) in enumerate(zip(prompts, gaps)):
            pacer.wait(gap)
            if kill_replica is not None and i == kill_after:
                router.kill_replica(kill_replica)
            waited = 0.0
            for attempt in range(shed_retries + 1):
                try:
                    handles[i] = router.submit(p, max_new_tokens=new_tokens)
                    break
                except FleetOverloaded as exc:
                    if attempt == shed_retries:
                        report.shed += 1
                    else:
                        hinted = min(exc.retry_after_s, 2.0)
                        pacer.wait(hinted)
                        waited += hinted
            # recorded for EVERY request (retries or not) so the
            # percentiles line up index-free with ttft_s
            report.attempts.append(attempt + 1)
            report.retry_wait_s.append(waited)
        deadline = time.monotonic() + timeout_s
        for h in handles:
            if h is not None:
                h.done.wait(max(0.0, deadline - time.monotonic()))
    finally:
        report.wall_s = time.perf_counter() - t0
        router.stop()
    return _collect(router, report, handles, base)


def run_loadtest_sync(router: FleetRouter, prompts: list[np.ndarray],
                      seed: int = 0, mean_gap_ticks: float = 1.0,
                      new_tokens: int = 8, kill_at_tick: int = 0,
                      kill_replica=None, max_ticks: int = 100000,
                      on_tick=None) -> LoadReport:
    """Tick-driven run (no threads, no sleeps): arrivals land on seeded
    tick offsets, the kill fires at `kill_at_tick`, and every unit of
    work is an engine tick — machine-speed cancels out of anchor-relative
    ratios. `on_tick(tick, router)`, when given, runs after each
    round-robin pass — a monitoring or chaos hook (a drill can record the
    fleet's counters, or kill a replica on a condition, there)."""
    rng = random.Random(seed)
    arrivals: list[tuple[int, int]] = []  # (tick, prompt index)
    t = 0.0
    for i in range(len(prompts)):
        t += rng.expovariate(1.0 / mean_gap_ticks) if mean_gap_ticks > 0 \
            else 0.0
        arrivals.append((int(t), i))
    report = LoadReport(n_requests=len(prompts))
    handles: list = [None] * len(prompts)
    base = _counters(router)
    killed = kill_replica is None
    t0 = time.perf_counter()
    tick = 0
    while tick < max_ticks:
        if not killed and tick >= kill_at_tick:
            router.kill_replica(kill_replica)
            killed = True
        while arrivals and arrivals[0][0] <= tick:
            _, i = arrivals.pop(0)
            try:
                handles[i] = router.submit(
                    prompts[i], max_new_tokens=new_tokens)
            except FleetOverloaded:
                report.shed += 1
        busy = False
        for rep in router.replicas:
            if rep.alive:
                busy = rep.engine.tick() or busy
        if on_tick is not None:
            on_tick(tick, router)
        tick += 1
        if not busy and not arrivals and killed:
            break
    report.wall_s = time.perf_counter() - t0
    report.ticks = tick
    return _collect(router, report, handles, base)
