"""FleetScaler — the closed autoscaling loop over the demand signal;
counterpart of ``kubeflow_tpu/serving/fleet/scaler.py``.

The router produces ``demand_replicas()``; this controller closes the
loop — each ``evaluate()`` pass reads the signal and moves the fleet
toward it. (The reference's burn-rate-aware signal and its chip-ledger
claims wait for the SLO monitor's and the chip scheduler's port, ROADMAP
A12.)

  - **scale-up** builds a replica through ``engine_factory`` (the cold
    start: the factory constructs AND warms the engine — for a pod, it
    spawns and connects the worker — so a fresh replica never serves its
    first request cold; the observed duration feeds the cold-start
    EWMA); a replica still draining is un-drained first — the cheapest
    capacity;
  - **scale-down is a graceful drain**: the target replica stops
    admitting (router.begin_drain), in-flight requests finish in place,
    and the empty shell is reaped; a drain that outlives its grace
    window finishes as a *polite kill_replica* — the router's requeue
    chain-resumes every seated request onto survivors, so scale-down is
    loss-free by construction;
  - **hysteresis**: decisions are counted in EVALUATIONS, not wall
    seconds (machine-invariant in a tick-driven drill): scale-up obeys
    a cooldown, scale-down needs the demand to sit low for
    ``scale_down_stable_evals`` consecutive passes — a demand spike can
    raise the fleet but can never thrash it;
  - **scale-to-zero / wake-on-arrival**: with ``min_replicas=0`` an
    idle fleet drains to nothing after ``idle_to_zero_evals``; the
    first arrival is shed with Retry-After but stamps the router's wake
    signal (`_pick`), which the next evaluation answers with a
    cold-started replica;
  - **hang detection**: a replica holding work whose engine makes no
    step progress across ``hang_detect_evals`` passes — or, for a pod,
    whose worker heartbeat is older than ``heartbeat_max_age_s`` (a
    SIGSTOPped process keeps its socket and its mirrored counters) — is
    declared hung and politely killed, after a replacement is up if it
    was the last. Indictment requires PEER progress (some other replica
    advanced, or the suspect is the only one): a fleet-WIDE stall is
    systemic and killing through it converts the stall into dropped
    requests. Corollary: the caller's scheduler must drive every live
    replica each pass — a caller that starves a subset is
    indistinguishable from real hangs on exactly that subset.

Every decision is traced: a ``scaler.evaluate`` event carries the
demand input, and the ``fleet.scale_up`` / ``fleet.scale_down``
events (and any drain-timeout ``fleet.replica_kill``) parent-link to the
evaluation that triggered them.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass

from kubeflow_tpu_torch.tracing.core import armed_tracer

#: EWMA weight of each observed cold-start duration
_COLD_ALPHA = 0.3


@dataclass(frozen=True)
class ScalerConfig:
    """Knobs of the scaling loop. All hysteresis windows are counted in
    evaluate() passes: the caller owns the cadence (a tick-driven drill
    runs one pass per tick; a serving controller one per reconcile), so
    the loop's behavior is cadence-relative and machine-speed
    invariant."""

    min_replicas: int = 0
    max_replicas: int = 8
    #: evaluations between consecutive scale-up decisions
    scale_up_cooldown_evals: int = 2
    #: consecutive below-target evaluations before a scale-down
    scale_down_stable_evals: int = 6
    #: consecutive fully-idle evaluations before scale-to-zero
    #: (only with min_replicas == 0)
    idle_to_zero_evals: int = 12
    #: evaluations a drain may run before it finishes as a polite kill
    drain_grace_evals: int = 8
    #: evaluations a work-holding replica may sit without engine step
    #: progress before it is declared hung and killed
    hang_detect_evals: int = 6
    #: wall-clock heartbeat-age ceiling for pod-backed replicas, seconds
    #: (0 = disabled). An engine exposing heartbeat_age() whose worker
    #: has not beaten for longer than this while holding work is
    #: indicted IMMEDIATELY — a SIGSTOPped pod keeps its socket and its
    #: mirrored step_count frozen, so only the worker-side beat exposes
    #: it faster than hang_detect_evals' stall count
    heartbeat_max_age_s: float = 0.0
    #: replicas added per scale-up decision at most (the step bound the
    #: BURN_DEMAND_CAP multiplier is clamped against)
    max_step_up: int = 2

    def __post_init__(self):
        if self.min_replicas < 0 or self.max_replicas < 1 \
                or self.min_replicas > self.max_replicas:
            raise ValueError(
                f"need 0 <= min_replicas <= max_replicas (>=1), got "
                f"[{self.min_replicas}, {self.max_replicas}]")
        if self.max_step_up < 1:
            raise ValueError("max_step_up must be >= 1")


class FleetScaler:
    """One scaling loop bound to one FleetRouter (module docstring)."""

    def __init__(self, router, engine_factory, config: ScalerConfig |
                 None = None, tracer=None, on_release=None):
        """engine_factory() -> a NEW engine, constructed, warmed, and
        sharing the fleet's paged_kv pool when the fleet has one
        (router.add_replica enforces the invariant); a spawned pod's
        client is such an engine. New engines are left passive: the
        caller ticks them or start()s their serving threads. tracer:
        decision spans; defaults to the router's. on_release(engine)
        receives each GRACEFULLY-drained engine (emptied, stopped,
        healthy) — the warm-standby recycling hook; killed/hung engines
        never pass through it."""
        self.router = router
        self.engine_factory = engine_factory
        self.on_release = on_release
        self.cfg = config or ScalerConfig()
        self.tracer = tracer if tracer is not None else router.tracer
        #: chaos hook: a frozen scaler keeps evaluating — and counting —
        #: but acts on nothing, which is exactly the outage an SLO burn
        #: alert must catch
        self.frozen = False
        self._mu = threading.Lock()
        self._evals = 0
        self._last_scale_up_eval = -(10 ** 9)
        self._low_demand_evals = 0
        self._idle_evals = 0
        self._created = 0
        #: replica name -> {"since": eval index, "ctx": scale_down span
        #: context} for drains in progress
        self._draining: dict[str, dict] = {}
        #: replica name -> (last step_count, stalled evals) hang watch
        self._progress: dict[str, tuple[int, int]] = {}
        self.target_replicas = len(router._admittable())
        self.cold_start_ewma_s = 0.0
        self.metrics = {
            "evaluations_total": 0,
            "frozen_evaluations_total": 0,
            "scale_ups_total": 0,
            "scale_downs_total": 0,
            "replicas_added_total": 0,
            "replicas_removed_total": 0,
            "drains_completed_total": 0,
            "drain_kills_total": 0,
            "hangs_detected_total": 0,
            "scale_to_zero_total": 0,
            "scale_from_zero_total": 0,
        }
        router.scaler = self

    # ------------------------------------------------------------ chaos

    def freeze(self) -> None:
        self.frozen = True

    def thaw(self) -> None:
        self.frozen = False

    # ------------------------------------------------------------- loop

    def demand(self) -> int:
        """Desired replicas: the router's queue math."""
        return self.router.demand_replicas()

    def evaluate(self) -> dict:
        """One pass of the loop: reap finished work (drains, corpses),
        read the demand signal, and move the fleet toward it under the
        hysteresis rules. Returns the decision record (what a dashboard
        or a drill's journal would log)."""
        with self._mu:
            self.metrics["evaluations_total"] += 1
            self._evals += 1
            i = self._evals
        if self.frozen:
            with self._mu:
                self.metrics["frozen_evaluations_total"] += 1
            return {"eval": i, "frozen": True, "actions": []}
        tr = armed_tracer(self.tracer)
        # the evaluation event is allocated lazily: only a pass that
        # ACTS records one, so the trace carries decisions, not heartbeat
        # noise — every action of this pass parent-links to it
        ev = {"ctx": None}

        def eval_ctx(demand, decision):
            if tr is None:
                return None
            if ev["ctx"] is None:
                e = tr.event("scaler.evaluate", parent=None,
                             demand=demand, decision=decision,
                             alive=len(self.router._admittable()))
                ev["ctx"] = e.context
            return ev["ctx"]

        actions: list[str] = []
        self._reap_corpses()
        self._watch_hangs(i, tr, eval_ctx, actions)
        self._advance_drains(i, tr, actions)
        demand = self.demand()
        target = min(max(demand, self.cfg.min_replicas),
                     self.cfg.max_replicas)
        serving = self.router._admittable()
        n_serving = len(serving)

        # ---- scale-up (cooldown-gated; un-drain before cold-starting)
        if target > n_serving \
                and i - self._last_scale_up_eval \
                >= self.cfg.scale_up_cooldown_evals:
            need = min(target - n_serving, self.cfg.max_step_up)
            from_zero = n_serving == 0
            ctx = eval_ctx(demand, "scale_up")
            for _ in range(need):
                self._scale_up_one(tr, ctx, from_zero=from_zero)
                from_zero = False
            self._last_scale_up_eval = i
            self._low_demand_evals = 0
            self._idle_evals = 0
            with self._mu:
                self.metrics["scale_ups_total"] += 1
            self.router.clear_wake()
            actions.append(f"scale_up x{need}")

        # ---- scale-down (stability-gated graceful drain, one at a time)
        elif target < n_serving:
            self._low_demand_evals += 1
            if self._low_demand_evals >= self.cfg.scale_down_stable_evals \
                    and n_serving > max(target, 1):
                victim = min(serving, key=lambda r: r.pending_tokens())
                ctx = eval_ctx(demand, "scale_down")
                self._begin_drain(victim, i, tr, ctx, reason="demand")
                self._low_demand_evals = 0
                actions.append(f"drain {victim.name}")
        else:
            self._low_demand_evals = 0

        # ---- scale-to-zero (idle-gated; min_replicas == 0 only).
        # Idleness is measured on the FLEET (no seated work, no wake
        # arrivals), not on the demand signal — demand floors at 1
        # while any replica serves, by design (test_fleet pins it)
        idle = (self.router.wake_pending() == 0
                and all(r.depth() == 0 for r in self.router._alive()))
        self._idle_evals = self._idle_evals + 1 if idle else 0
        if (self.cfg.min_replicas == 0 and idle
                and self._idle_evals >= self.cfg.idle_to_zero_evals
                and self.router._admittable()):
            ctx = eval_ctx(demand, "scale_to_zero")
            for rep in list(self.router._admittable()):
                self._begin_drain(rep, i, tr, ctx, reason="scale_to_zero")
            with self._mu:
                self.metrics["scale_to_zero_total"] += 1
            self._idle_evals = 0
            actions.append("scale_to_zero")

        self.target_replicas = target
        # "burn" keeps the reference's record keys: with no SLO monitor
        # the burn input is 0
        return {"eval": i, "frozen": False, "demand": demand,
                "burn": 0.0, "target": target,
                "serving": len(self.router._admittable()),
                "draining": len(self._draining), "actions": actions}

    # -------------------------------------------------------- sub-steps

    def _scale_up_one(self, tr, ctx, from_zero: bool) -> None:
        # a draining replica is capacity we already own: cancel a drain
        # instead of paying a cold start — the one with the MOST seated
        # work (it has the most to lose to a drain-grace polite kill;
        # the emptiest is about to be reaped anyway and costs nothing).
        if self._draining:
            def seated(name):
                try:
                    return self.router._resolve(name).depth()
                except StopIteration:
                    return -1
            dname = max(self._draining, key=seated)
            self.router.cancel_drain(dname)
            self._draining.pop(dname)
            if tr is not None:
                tr.event("fleet.scale_up", parent=ctx, replica=dname,
                         undrained=True, cold_start_s=0.0)
            with self._mu:
                self.metrics["replicas_added_total"] += 1
            return
        name = f"scaled-{self._created}"
        t0 = time.perf_counter()
        engine = self.engine_factory()
        self._created += 1
        rep = self.router.add_replica(engine, name=name)
        dt = time.perf_counter() - t0
        self.cold_start_ewma_s = (
            dt if self.cold_start_ewma_s <= 0.0
            else (1 - _COLD_ALPHA) * self.cold_start_ewma_s
            + _COLD_ALPHA * dt)
        with self._mu:
            self.metrics["replicas_added_total"] += 1
            if from_zero:
                self.metrics["scale_from_zero_total"] += 1
        if tr is not None:
            tr.event("fleet.scale_up", parent=ctx, replica=rep.name,
                     from_zero=from_zero, cold_start_s=round(dt, 4))

    def _begin_drain(self, rep, eval_i: int, tr, ctx,
                     reason: str) -> None:
        self.router.begin_drain(rep.name)
        self._draining[rep.name] = {"since": eval_i, "ctx": ctx}
        with self._mu:
            self.metrics["scale_downs_total"] += 1
        if tr is not None:
            tr.event("fleet.scale_down", parent=ctx, replica=rep.name,
                     reason=reason, in_flight=rep.depth())

    def _advance_drains(self, eval_i: int, tr, actions: list) -> None:
        for name, st in list(self._draining.items()):
            try:
                rep = self.router._resolve(name)
            except StopIteration:
                self._draining.pop(name)
                continue
            if not rep.alive:
                # chaos killed it mid-drain: the requeue already rescued
                # its work — just reap the corpse
                self._remove(rep)
                self._draining.pop(name)
                continue
            if rep.depth() == 0:
                rep.engine.stop()
                self._remove(rep)
                self._draining.pop(name)
                with self._mu:
                    self.metrics["drains_completed_total"] += 1
                if self.on_release is not None:
                    self.on_release(rep.engine)
                actions.append(f"drained {name}")
            elif eval_i - st["since"] >= self.cfg.drain_grace_evals:
                # grace expired with rows still seated: finish the drain
                # as a polite kill — every request chain-resumes onto a
                # survivor (zero drops, zero re-decode when the pool
                # held its chain)
                self.router.kill_replica(name, parent=st["ctx"])
                self._remove(rep)
                self._draining.pop(name)
                with self._mu:
                    self.metrics["drain_kills_total"] += 1
                actions.append(f"drain_kill {name}")

    def _watch_hangs(self, eval_i: int, tr, eval_ctx, actions) -> None:
        cfg = self.cfg
        watched = [r for r in self.router._alive() if not r.draining]
        advanced = False
        suspects = []
        for rep in watched:
            steps = int(getattr(rep.engine, "step_count", 0))
            last, stalled = self._progress.get(rep.name, (steps, 0))
            if steps != last:
                advanced = True
            stalled = stalled + 1 if (steps == last
                                      and rep.depth() > 0) else 0
            self._progress[rep.name] = (steps, stalled)
            if stalled >= cfg.hang_detect_evals:
                suspects.append((rep, stalled))
            elif cfg.heartbeat_max_age_s > 0.0:
                # pod-backed liveness: the worker beats per tick verb;
                # an age past the ceiling with work seated means the
                # PROCESS is wedged (SIGSTOP, hard page stall) even
                # though the wire and the mirrored counters look merely
                # idle. A fresh beat, conversely, is live evidence for
                # the peer-progress guard below.
                age_fn = getattr(rep.engine, "heartbeat_age", None)
                age = age_fn() if callable(age_fn) else None
                if age is None:
                    pass
                elif age <= cfg.heartbeat_max_age_s:
                    advanced = True
                elif rep.depth() > 0:
                    suspects.append((rep, stalled))
        # the straggler contract, fleet edition: a stalled replica is
        # indicted only against PEER progress — some other replica
        # advanced this pass — or when it is the only replica (the
        # replacement becomes the reference). A fleet-WIDE stall is
        # systemic (the caller stopped ticking, a global wedge):
        # serially hang-killing healthy replicas there burns every
        # request's requeue budget and converts the stall into drops.
        if not (advanced or len(watched) == 1):
            return
        for rep, stalled in suspects:
            with self._mu:
                self.metrics["hangs_detected_total"] += 1
            ctx = eval_ctx(-1, "hang_kill")
            if tr is not None:
                tr.event("fleet.replica_hung", parent=ctx,
                         replica=rep.name, stalled_evals=stalled)
            survivors = [r for r in self.router._admittable()
                         if r.name != rep.name]
            if not survivors:
                self._scale_up_one(tr, ctx, from_zero=False)
            self.router.kill_replica(rep.name, parent=ctx)
            self._remove(rep)
            self._progress.pop(rep.name, None)
            actions.append(f"hang_kill {rep.name}")

    def _reap_corpses(self) -> None:
        """Chaos-killed replicas (router.kill_replica from a drill or
        fault plan) stay in the replica list as dead entries; the scaler
        garbage-collects them so alive == listed and scale-up names
        never collide with tombstones."""
        for rep in list(self.router.replicas):
            if not rep.alive:
                self._remove(rep)
                self._progress.pop(rep.name, None)

    def _remove(self, rep) -> None:
        try:
            self.router.remove_replica(rep.name)
        except (ValueError, StopIteration):
            return
        # every removal funnel: a reaped replica's hang-watch entry
        # must go with it, or months of scale-up/drain cycles (names
        # never reused) leak one entry per replica ever created
        self._progress.pop(rep.name, None)
        with self._mu:
            self.metrics["replicas_removed_total"] += 1
