"""Fleet router — queue-depth-aware routing + SLO admission over N engines;
counterpart of ``kubeflow_tpu/serving/fleet/router.py``, plain host code
over the port's ContinuousBatcher (serving/continuous.py).

The tier between the activator and the ContinuousBatcher replicas. One
engine per InferenceService caps throughput at one chip's decode
bandwidth; the fleet runs N replica engines behind ONE submit() surface
with three production behaviors the solo engine lacks:

  - **least-loaded routing**: every submit lands on the replica with the
    smallest pending-token load (queued prompts + in-flight remaining
    budgets), not round-robin — a replica stuck behind a 4k-token prompt
    stops receiving traffic until it drains;
  - **SLO admission control**: estimated TTFT (pending tokens ahead /
    the fleet's observed service rate) beyond `ttft_slo_s` sheds the
    request with FleetOverloaded carrying a Retry-After hint — the same
    503 + Retry-After contract the activator already speaks, so clients
    (serving/client.py `_post`) re-dial on the server's schedule instead
    of piling onto a saturated fleet;
  - **zero-drop replica kill**: when a replica dies mid-flight, every
    request it was carrying — queued or decoding — is requeued onto a
    surviving replica via the engines' on_done callbacks; nothing is
    dropped, and `requeued_total` counts the disruption. A request whose
    paged-KV chain survives the kill RESUMES from it on the survivor
    (tokens kept, zero re-prefill, zero re-decode —
    `requeues_resumed_total` / `requeue_resumed_tokens_total` count the
    rescue); only a chainless request re-decodes from scratch, and
    greedy rows then re-decode to identical tokens either way.

**Disaggregated prefill/decode** (replica `role`): tag replicas
"prefill" / "decode" (default "mixed") and the router splits the
request lifetime across tiers — new requests route least-loaded onto
the prefill tier, which runs chunked prefill (budget-1, `keep_chain`)
and publishes the finished block chain through the SHARED paged pool;
the router hands the chain to a decode replica whose resume admission
seeds its row cache from the pool and decodes from the first generated
position. Long prompts never occupy a decode slot, and pure-prefill
replicas lift the one-chunk-per-tick stall bound
(`max_chunks_per_tick`) because they have no decode rows to starve.

The demand signal (`demand_replicas()`) is the autoscaler's input:
pending tokens over (service rate x TTFT SLO), clamped to at least the
alive replica count when queues are hot — the `kftpu_fleet_*` queue and
latency families in /metrics carry the same numbers for dashboards.

Paged-KV prefix reuse composes: hand each replica engine the SAME
PagedKVPool and a system prompt prefills once per fleet, not once per
replica admission.

In one process every replica engine ticks on its own thread
(``start()``), and the threads share the interpreter lock: a replica's
decode dispatch is slower while another decodes beside it.
"""

from __future__ import annotations

import collections
import threading
import time
from dataclasses import dataclass, field

import numpy as np

from kubeflow_tpu_torch.serving.fleet.wire import PodCallError, PodDead
from kubeflow_tpu_torch.tracing.core import armed_tracer, current_context

#: EWMA weight of each completed request's observed decode rate
_RATE_ALPHA = 0.2

#: bound on the TTFT sample window backing the p50/p99 gauges
_TTFT_WINDOW = 512


class FleetOverloaded(RuntimeError):
    """Admission shed: the fleet cannot meet the TTFT SLO for this
    request. `retry_after_s` is the server-side hint the HTTP surfaces
    forward as a 503 Retry-After header. `trace_ctx`/`request_id` are
    stamped by submit() when tracing is armed, so the 503 body can carry
    the shed decision's span context back to the client
    (serving/server.py — a shed request is attributable, not just
    gone)."""

    def __init__(self, msg: str, retry_after_s: float):
        super().__init__(msg)
        self.retry_after_s = retry_after_s
        self.trace_ctx = None
        self.request_id = ""


@dataclass
class Replica:
    """One engine slot in the fleet: the ContinuousBatcher plus the
    router's liveness view of it. `role` places it in the disaggregated
    split: "mixed" (default) serves whole requests, "prefill" serves the
    chunked-prefill leg only (publishing chains through the shared
    pool), "decode" adopts published chains and decodes them."""

    name: str
    engine: object
    alive: bool = True
    role: str = "mixed"
    #: scale-down drain (the autoscaler's graceful half): a draining replica
    #: stops ADMITTING (excluded from _pick) but keeps ticking its
    #: in-flight rows until empty — a drain is a polite kill_replica,
    #: taken only when the grace window expires with work still seated
    draining: bool = False

    def pending_tokens(self) -> int:
        """The routing load signal: queued prompt+budget tokens plus the
        remaining budgets of in-flight rows. Best-effort reads of the
        ticker-private row table (same contract as the /metrics gauges —
        a mid-tick read is off by at most one row)."""
        eng = self.engine
        with eng._lock:
            queued = sum(ids.size + req.max_new_tokens
                         for ids, req in eng._queue)
        rows = sum(max(req.max_new_tokens - len(req.tokens), 1)
                   for req in eng._rows if req is not None)
        return queued + rows

    def depth(self) -> int:
        eng = self.engine
        with eng._lock:
            queued = len(eng._queue)
        return queued + sum(1 for r in eng._rows if r is not None)


@dataclass
class FleetRequest:
    """Router-level handle: survives replica kills (the engine handle it
    wraps is replaced on requeue). result() blocks for the tokens of the
    final successful attempt; TTFT is measured from fleet submission to
    the first token the CLIENT would have seen (requeues reset it —
    the wait is real)."""

    prompt: np.ndarray
    kwargs: dict
    t_submit: float
    replica: str = ""
    attempts: int = 0
    tokens: list = field(default_factory=list)
    t_first: float | None = None
    t_done: float | None = None
    error: str | None = None
    done: threading.Event = field(default_factory=threading.Event)
    on_token: object = None
    #: client-stream high-water mark: positions already forwarded to
    #: on_token — a re-dispatch re-decoding streamed positions (scratch
    #: requeue, frozen-chain fallback) must not re-deliver them
    delivered: int = 0
    # disaggregated / resume state: `stage` is the lifetime leg the next
    # dispatch serves ("" = whole request on a mixed replica, "prefill"
    # = the budget-1 chain-publishing leg, "decode" = adopt-and-decode);
    # `chain` is a surviving SequenceChain waiting to be handed to the
    # next engine (ownership passes on dispatch); `budget`/`eos` are the
    # request's resolved decode budget and stop set (the router needs
    # them to split the lifetime without re-deriving engine defaults).
    stage: str = ""
    chain: object = None
    budget: int = 0
    eos: tuple | None = None
    # request-tracing state: the router owns the `request` root span for
    # fleet requests — trace_ctx is its pre-allocated identity (engine
    # phase spans parent to it across requeues), recorded retroactively
    # when the request completes/sheds/fails
    trace_ctx: object = None
    parent_ctx: object = None
    request_id: str = ""
    _tracer: object = None
    t_submit_wall: float = 0.0

    @property
    def ttft_s(self) -> float | None:
        return None if self.t_first is None else self.t_first - self.t_submit

    @property
    def tokens_per_s(self) -> float | None:
        if self.t_first is None or self.t_done is None:
            return None
        dt = self.t_done - self.t_first
        return len(self.tokens) / dt if dt > 0 else float("inf")

    def result(self, timeout: float | None = None) -> np.ndarray:
        if not self.done.wait(timeout):
            raise TimeoutError("fleet request did not finish in time")
        if self.error is not None:
            raise RuntimeError(f"fleet request failed: {self.error}")
        return np.asarray(self.tokens, np.int32)


class FleetRouter:
    """N replica engines behind one submit() (module docstring)."""

    def __init__(self, replicas, ttft_slo_s: float = 0.0,
                 retry_after_s: float = 1.0,
                 service_rate_tokens_per_s: float = 0.0,
                 max_requeues: int = 3, tracer=None,
                 demand_tokens_per_replica: float = 0.0):
        """replicas: list of engines (named replica-<i>), (name, engine)
        pairs, or (name, engine, role) triples — role "prefill"/"decode"
        arms the disaggregated split (docstring), which requires every
        engine to share ONE paged_kv pool (the chain-handoff medium) and
        at least one replica on each side of the split. ttft_slo_s: 0
        disables admission shedding. service_rate_tokens_per_s: initial
        service-rate estimate; 0 defers admission control until the
        first completion calibrates it. tracer (tracing.Tracer):
        per-request root spans + the kill→requeue causal chain;
        propagated to replica engines that have none of their own, so
        one tracer covers the whole fleet."""
        self.tracer = tracer
        #: monitoring TSDB propagated to replica engines (set through
        #: wire_monitoring); carried here so add_replica — the
        #: autoscaler's scale-out path, active exactly when the burn
        #: monitor is — wires NEW replicas into the decode-tick/TTFT
        #: series too, not just the ones present at registration
        self.tsdb = None
        self.replicas: list[Replica] = []
        for i, r in enumerate(replicas):
            role = "mixed"
            if isinstance(r, tuple):
                name, eng = r[0], r[1]
                if len(r) > 2:
                    role = r[2]
            else:
                name, eng = f"replica-{i}", r
            if role not in ("mixed", "prefill", "decode"):
                raise ValueError(f"unknown replica role {role!r}")
            self._wire_engine(eng)
            self.replicas.append(Replica(name=name, engine=eng, role=role))
        if not self.replicas:
            raise ValueError("a fleet needs at least one replica")
        if self.disaggregated:
            pools = {id(r.engine.paged_kv): r.engine.paged_kv
                     for r in self.replicas}
            if any(p is None for p in pools.values()) or len(pools) != 1:
                raise ValueError(
                    "a disaggregated fleet needs every replica on ONE "
                    "shared paged_kv pool — it is the chain-handoff "
                    "medium")
            if not any(r.role in ("decode", "mixed") for r in self.replicas):
                raise ValueError(
                    "a disaggregated fleet needs at least one decode-"
                    "capable (decode/mixed) replica")
        #: replica name -> the fleet.replica_kill event's SpanContext —
        #: what a requeue parent-links to (the chaos.pod_kill →
        #: gang_restart chain, serving edition)
        self._kill_ctx: dict[str, object] = {}
        #: wake-on-arrival signal (for an autoscaler): arrivals
        #: that found NO admittable replica (scaled to zero, or every
        #: survivor draining) are counted here so the demand signal —
        #: whose queue-math EWMA has no live engine updating it in that
        #: state — is pinned to the arrivals themselves, never to a
        #: stale service rate
        self._wake_pending = 0
        self._wake_ts = 0.0
        #: the autoscaler, when one is driving this fleet (it sets this
        #: itself)
        self.scaler = None
        self.ttft_slo_s = float(ttft_slo_s)
        self.retry_after_s = float(retry_after_s)
        self.max_requeues = int(max_requeues)
        #: explicit per-replica capacity target for the demand signal
        #: (tokens of backlog one replica should own — the working-set
        #: form: replicas x rows x (prompt + budget) is the natural
        #: value). When set it replaces the EWMA-rate x SLO estimate in
        #: demand_replicas(): a scaling POLICY wants to add capacity
        #: BEFORE latency degrades, and the rate estimate only moves
        #: after it has (a tick-driven drill also pins this because its
        #: serialized engine loop distorts wall-clock rates).
        self.demand_tokens_per_replica = float(demand_tokens_per_replica)
        self._rate = float(service_rate_tokens_per_s)
        self._mu = threading.Lock()
        self._ttfts = collections.deque(maxlen=_TTFT_WINDOW)
        self.metrics = {
            "requests_admitted_total": 0,
            "requests_shed_total": 0,
            "requests_requeued_total": 0,
            "requeues_resumed_total": 0,
            "requeue_resumed_tokens_total": 0,
            "prefill_handoffs_total": 0,
            "requests_completed_total": 0,
            "requests_failed_total": 0,
            "replica_kills_total": 0,
        }

    @property
    def disaggregated(self) -> bool:
        return any(r.role == "prefill" for r in self.replicas)

    def _wire_engine(self, engine) -> None:
        """The ONE engine-attach path for the fleet's tracer + TSDB
        (constructor, add_replica, and wire_monitoring all funnel
        here): an engine that brought its own keeps it; any future
        replica-attach path inherits both or neither, never a drifted
        half."""
        if self.tracer is not None \
                and getattr(engine, "tracer", None) is None:
            engine.tracer = self.tracer
        if self.tsdb is not None \
                and getattr(engine, "tsdb", None) is None:
            engine.tsdb = self.tsdb
        # mark the engine router-managed: _fail_all may transfer a dying
        # row's chain to the handle ONLY when this router's requeue is
        # listening to release-or-resume it — a direct engine consumer
        # with an on_done callback would otherwise leak pinned blocks
        engine._fleet_managed = True

    def wire_monitoring(self, tracer=None, tsdb=None) -> None:
        """Late-attach monitoring to the whole fleet (in any order): set
        the fleet-level tracer/TSDB unless already present, then wire
        every current replica. Future add_replica calls inherit
        automatically."""
        if tracer is not None and self.tracer is None:
            self.tracer = tracer
        if tsdb is not None and self.tsdb is None:
            self.tsdb = tsdb
        for rep in self.replicas:
            self._wire_engine(rep.engine)

    # ----------------------------------------------------------- routing

    def _alive(self) -> list[Replica]:
        return [r for r in self.replicas if r.alive]

    def _admittable(self) -> list[Replica]:
        """Replicas a NEW dispatch may land on: alive and not draining
        (a draining replica still ticks its in-flight rows — the drain
        contract — but admits nothing)."""
        return [r for r in self.replicas if r.alive and not r.draining]

    def load_view(self) -> dict[str, int]:
        """Per-replica pending-token load — the activator's queue-depth-
        aware endpoint pick reads this."""
        return {r.name: r.pending_tokens() for r in self.replicas if r.alive}

    def queue_depth(self) -> int:
        return sum(r.depth() for r in self._alive())

    def pending_tokens(self) -> int:
        return sum(r.pending_tokens() for r in self._alive())

    def estimated_ttft_s(self, prompt_len: int) -> float | None:
        """Admission estimate: tokens ahead of this prompt's first token
        over the fleet's observed service rate. None until a completion
        has calibrated the rate (admission stays open — shedding on a
        guess would turn cold starts into outages)."""
        if self._rate <= 0.0:
            return None
        alive = self._admittable()
        if not alive:
            return float("inf")
        ahead = min(r.pending_tokens() for r in alive) + prompt_len
        return ahead / self._rate

    def admit_or_raise(self, prompt_tokens: int) -> None:
        """The admission gate alone: raises FleetOverloaded when the
        estimated TTFT for `prompt_tokens` more prompt work exceeds the
        SLO. Callers submitting a BATCH gate once with the batch total
        (then submit ungated) so a shed can never orphan half-admitted
        rows on the fleet."""
        est = self.estimated_ttft_s(prompt_tokens)
        if self.ttft_slo_s > 0.0 and est is not None \
                and est > self.ttft_slo_s:
            with self._mu:
                self.metrics["requests_shed_total"] += 1
            raise FleetOverloaded(
                f"estimated TTFT {est:.3f}s exceeds SLO "
                f"{self.ttft_slo_s:.3f}s", retry_after_s=max(
                    self.retry_after_s,
                    min(est - self.ttft_slo_s, 30.0)))

    def submit(self, prompt_ids, gate: bool = True,
               **kwargs) -> FleetRequest:
        """Admission-gate then route to the least-loaded live replica.
        Raises FleetOverloaded (with retry_after_s) on shed — including
        when no replica is alive, counted as a shed, never as an
        admission. With tracing armed every request gets a `request`
        root span (recorded retroactively at completion) whose children
        are the admission decision, per-attempt dispatches, and the
        engine's queue-wait/prefill-chunk/decode spans."""
        ids = np.asarray(prompt_ids, np.int32).reshape(-1)
        if not self.replicas:
            # scaled to zero with the replica LIST empty (the scaler
            # reaps drained shells): there is no engine to resolve
            # defaults from — shed with the wake signal stamped, the
            # same contract _pick applies when entries exist but none
            # admit.
            with self._mu:
                self._wake_pending += 1
                self._wake_ts = time.time()
                self.metrics["requests_shed_total"] += 1
            raise FleetOverloaded("no live replicas",
                                  retry_after_s=self.retry_after_s)
        on_token = kwargs.pop("on_token", None)
        rid = kwargs.pop("request_id", "")
        freq = FleetRequest(prompt=ids, kwargs=dict(kwargs),
                            t_submit=time.perf_counter(),
                            on_token=on_token)
        freq.t_submit_wall = time.time()
        # resolve the lifetime split's inputs once: the decode budget and
        # stop set (engine defaults otherwise live behind the dispatch)
        eng0 = self.replicas[0].engine
        freq.budget = int(kwargs.get("max_new_tokens")
                          or eng0.default_max_new_tokens)
        if kwargs.get("eos_token_id") is not None:
            from kubeflow_tpu_torch.serving.continuous import _eos_tuple

            freq.eos = _eos_tuple(kwargs["eos_token_id"])
        else:
            freq.eos = eng0.eos_token_id
        freq.stage = "prefill" if self.disaggregated else ""
        tr = armed_tracer(self.tracer)
        if tr is not None:
            if not rid:
                from kubeflow_tpu_torch.serving.requestid import (
                    get_request_id,
                )

                rid = get_request_id()
            freq._tracer = tr
            freq.parent_ctx = current_context()
            freq.trace_ctx = tr.allocate_context(parent=freq.parent_ctx)
        freq.request_id = rid
        try:
            if gate:
                self.admit_or_raise(ids.size)
        except FleetOverloaded as exc:
            self._trace_shed(freq, exc)
            raise
        if tr is not None:
            tr.event("request.admission", parent=freq.trace_ctx,
                     decision="admit", prompt_tokens=int(ids.size),
                     request_id=freq.request_id)
        try:
            self._dispatch(freq)
        except FleetOverloaded as exc:
            with self._mu:
                self.metrics["requests_shed_total"] += 1
            self._trace_shed(freq, exc)
            raise
        # counted only once the request is really on a replica, so
        # admitted == completed + failed + in-flight always holds
        with self._mu:
            self.metrics["requests_admitted_total"] += 1
        return freq

    def _trace_shed(self, freq: FleetRequest, exc: FleetOverloaded) -> None:
        """Record the shed decision as the request's (terminal) trace and
        hand its context to the exception so the 503 body can carry it."""
        exc.trace_ctx = freq.trace_ctx
        exc.request_id = freq.request_id
        if freq._tracer is None:
            return
        freq._tracer.event(
            "request.admission", parent=freq.trace_ctx, decision="shed",
            retry_after_s=round(exc.retry_after_s, 3),
            request_id=freq.request_id)
        freq._tracer.record_span(
            "request", freq.t_submit_wall,
            time.perf_counter() - freq.t_submit, context=freq.trace_ctx,
            parent=freq.parent_ctx, request_id=freq.request_id,
            outcome="shed")

    def record_shed(self, exc: FleetOverloaded, prompt_tokens: int,
                    request_id: str = "") -> FleetOverloaded:
        """Trace a shed decided OUTSIDE submit() — the batch-gate path
        (JaxModel gates once with the whole batch via admit_or_raise,
        then submits ungated): records the shed `request` root +
        admission event and stamps the exception's trace_ctx/request_id
        so the 503 body carries them, exactly like a submit()-path shed.
        Returns the (mutated) exception for `raise ... from` chains."""
        tr = armed_tracer(self.tracer)
        if not request_id:
            from kubeflow_tpu_torch.serving.requestid import get_request_id

            request_id = get_request_id()
        exc.request_id = request_id
        if tr is None:
            return exc
        parent = current_context()
        ctx = tr.allocate_context(parent=parent)
        tr.event("request.admission", parent=ctx, decision="shed",
                 prompt_tokens=int(prompt_tokens),
                 retry_after_s=round(exc.retry_after_s, 3),
                 request_id=request_id)
        tr.record_span("request", time.time(), 0.0, context=ctx,
                       parent=parent, request_id=request_id,
                       outcome="shed")
        exc.trace_ctx = ctx
        return exc

    def _pick(self, stage: str = "") -> Replica:
        alive = self._admittable()
        if not alive:
            # wake-on-arrival: the arrival is the scale-from-zero demand
            # signal, in-process —
            # recorded BEFORE the shed so demand_replicas() sees it even
            # though this request bounces with Retry-After
            self._wake_pending += 1
            self._wake_ts = time.time()
            raise FleetOverloaded("no live replicas",
                                  retry_after_s=self.retry_after_s)
        if self.disaggregated and stage:
            # tier-aware pick: the prefill leg lands on prefill-capable
            # replicas, the decode leg on decode-capable ones. A wiped
            # tier degrades to any live replica (every engine CAN do
            # both — the role is a routing policy, not a capability)
            want = (("prefill", "mixed") if stage == "prefill"
                    else ("decode", "mixed"))
            tier = [r for r in alive if r.role in want]
            alive = tier or alive
        return min(alive, key=lambda r: r.pending_tokens())

    def _dispatch(self, freq: FleetRequest, handoff: bool = False) -> None:
        # the fleet handle rides INSIDE the engine callbacks (partial
        # binding) — a registry keyed on the engine handle would race the
        # replica's ticker, which can emit tokens between submit() and
        # any later registration. The pick AND the enqueue happen under
        # _mu, ordered against kill_replica's alive=False flip (also
        # under _mu): either this dispatch lands before the kill — and
        # the kill's _fail_all requeues it — or the pick already excludes
        # the corpse. Without the ordering, an enqueue racing the kill
        # strands the request on a stopped ticker's queue forever.
        from functools import partial

        kwargs = dict(freq.kwargs)
        # the budget/stop set resolved at submit() govern the WHOLE
        # lifetime regardless of which replica serves a leg: engines in
        # one fleet may carry different defaults, and the split/resume
        # arithmetic (and the prefill leg's `finished` check) must not
        # shift with the replica the dispatch happens to land on
        kwargs["max_new_tokens"] = freq.budget
        if freq.eos is not None and "eos_token_id" not in kwargs:
            kwargs["eos_token_id"] = freq.eos
        chain, resume_tokens = None, None
        if freq.stage == "prefill":
            # the chain-publishing leg: emit the first token only, keep
            # the finished chain on the handle for the decode tier
            kwargs["max_new_tokens"] = 1
            kwargs["keep_chain"] = True
        elif freq.chain is not None:
            # adopt-and-decode (the disagg handoff / kill-requeue
            # resume): ownership of the chain passes to the engine
            chain, resume_tokens = freq.chain, list(freq.tokens)
            kwargs["resume_from"] = (chain, resume_tokens)
        # pod-backed replicas can die INSIDE submit (the wire fails
        # before the request ever seats): the admission-window gap the
        # in-process ordering comment above cannot cover. The dispatch
        # loop absorbs it under _mu — flip the corpse, re-pick a
        # survivor — and propagates the death (requeue callbacks for
        # whatever the corpse carried) only after _mu is released,
        # because those callbacks re-enter this very lock.
        corpses = []
        try:
            with self._mu:
                if not handoff:
                    # a handoff is one lifetime split across tiers, not
                    # a retry — attempts stays the requeue odometer
                    freq.attempts += 1
                while True:
                    rep = self._pick(freq.stage)
                    freq.replica = rep.name
                    if freq._tracer is not None:
                        freq._tracer.event(
                            "fleet.dispatch", parent=freq.trace_ctx,
                            replica=rep.name, attempt=freq.attempts,
                            stage=freq.stage or "full",
                            request_id=freq.request_id)
                    try:
                        rep.engine.submit(
                            freq.prompt,
                            on_token=partial(self._on_token, freq),
                            on_done=partial(self._on_done, freq),
                            trace_ctx=freq.trace_ctx,
                            request_id=freq.request_id, **kwargs)
                    except PodDead:
                        rep.alive = False
                        self.metrics["replica_kills_total"] += 1
                        corpses.append(rep.engine)
                        continue
                    break
                if chain is not None:
                    freq.chain = None  # the engine owns it now
        except PodCallError as exc:
            if exc.code != 409 or chain is None:
                raise
            # resume refused by the worker (chain frozen on re-insert —
            # the receiving pool could not cover every position): the
            # client already released the home chain; fall back to a
            # whole-lifetime scratch dispatch, same as the frozen-chain
            # path in _on_done. `delivered` keeps the stream single-copy
            # across the re-decode.
            freq.chain = None
            freq.tokens = []
            freq.t_first = None
            freq.stage = "prefill" if self.disaggregated else ""
            self._dispatch(freq, handoff=True)
        finally:
            for eng in corpses:
                eng._propagate_death()

    # --------------------------------------------- engine-thread callbacks

    def _on_token(self, freq: FleetRequest, handle, tok: int) -> None:
        if freq.done.is_set():
            return
        if freq.t_first is None:
            freq.t_first = time.perf_counter()
        freq.tokens.append(tok)
        # `delivered` is the client's high-water mark: a re-dispatch that
        # re-decodes already-streamed positions (scratch requeue, the
        # frozen-chain fallback) re-emits them into freq.tokens, but the
        # client's on_token must see each position ONCE (greedy re-decode
        # reproduces them identically, so skipping is exact)
        if freq.on_token is not None and len(freq.tokens) > freq.delivered:
            freq.on_token(freq, tok)
        freq.delivered = max(freq.delivered, len(freq.tokens))

    def _on_done(self, freq: FleetRequest, handle) -> None:
        """Runs on the finishing replica's engine thread. Success
        completes the fleet handle (or, on the disaggregated prefill
        leg, hands the published chain to the decode tier); a
        replica-death failure requeues onto a survivor — the zero-drop
        contract — RESUMING from the surviving paged-KV chain when one
        exists instead of re-decoding from scratch."""
        if freq.done.is_set():
            return
        if handle.error is None:
            if freq.stage == "prefill":
                freq.tokens = [int(t) for t in handle.tokens]
                chain = getattr(handle, "chain", None)
                if chain is not None and chain.frozen:
                    # insert() stopped early at admission (covered-by-
                    # sibling / partial-parent boundary), so the chain
                    # cannot cover the row's positions: nothing to hand
                    # off — release it and take the chainless fallback
                    # (a frozen chain must never reach resume_from:
                    # submit refuses it, and on this engine-thread
                    # callback that refusal would strand the client)
                    chain.release()
                    handle.chain = None
                    chain = None
                finished = (len(freq.tokens) >= freq.budget
                            or (freq.eos is not None
                                and freq.tokens[-1] in freq.eos))
                if not finished:
                    freq.stage = "decode"
                    if chain is not None:
                        # the handoff: the prefill replica published the
                        # chain through the shared pool; a decode
                        # replica adopts it and decodes from the first
                        # generated position — the prompt never touches
                        # a decode slot
                        freq.chain = chain
                        with self._mu:
                            self.metrics["prefill_handoffs_total"] += 1
                        if freq._tracer is not None:
                            freq._tracer.event(
                                "fleet.handoff", parent=freq.trace_ctx,
                                request_id=freq.request_id,
                                from_replica=freq.replica,
                                chain_blocks=len(chain.refs),
                                chain_tokens=int(chain.length))
                    else:
                        # frozen/unpublishable chain: fall back to a
                        # whole-lifetime dispatch on the decode tier
                        # (every engine CAN prefill; the split is
                        # policy, not capability). The re-decode
                        # re-emits the first token; `delivered` keeps
                        # the client stream single-copy.
                        freq.tokens = []
                    try:
                        self._dispatch(freq, handoff=True)
                    except FleetOverloaded as exc:
                        self._fail(freq, str(exc))
                    return
                if chain is not None:
                    chain.release()  # finished at the first token
            else:
                # prefill-finished fall-through already normalized above
                freq.tokens = [int(t) for t in handle.tokens]
            freq.t_done = time.perf_counter()
            with self._mu:
                self.metrics["requests_completed_total"] += 1
                if freq.ttft_s is not None:
                    self._ttfts.append(freq.ttft_s)
                self._observe_rate(freq)
            self._record_root(freq, "completed")
            freq.done.set()
            return
        chain = getattr(handle, "chain", None)
        if freq.attempts > self.max_requeues:
            if chain is not None:
                chain.release()
                handle.chain = None
            self._fail(freq, f"gave up after {freq.attempts} attempts: "
                             f"{handle.error}")
            return
        # replica died (or poisoned round): continue on a survivor. A
        # surviving chain (transferred by the dead engine's _fail_all)
        # RESUMES — emitted tokens kept, TTFT kept, zero re-prefill and
        # zero re-decode; without one, partial tokens are discarded and
        # greedy decode reproduces them exactly from scratch.
        # token record: freq.tokens is the router's own (what the client
        # already streamed) — for a request killed while still QUEUED on
        # the dead replica's resume path, handle.tokens is empty but the
        # prefill leg's first token lives in freq.tokens and the chain
        # still rescues; for a seated row the two agree (every emission
        # flowed through _on_token). The rescue also requires every live
        # replica to share the chain's pool: a mixed fleet with
        # per-replica pools (legal, pre-dating the disagg split) must
        # take the scratch path — resume_from into a different pool is
        # an engine-side refusal this engine-thread callback cannot
        # surface to the client
        resumed = (chain is not None and not chain.frozen
                   and chain.length >= freq.prompt.size
                   and len(freq.tokens) > 0
                   and all(r.engine.paged_kv is chain.pool
                           for r in self._alive()))
        if resumed:
            keep = int(chain.length) - int(freq.prompt.size) + 1
            freq.tokens = [int(t) for t in freq.tokens][:keep]
            freq.chain = chain
            freq.stage = "decode" if self.disaggregated else ""
        else:
            if chain is not None:
                chain.release()
            keep = 0
            freq.tokens = []
            freq.t_first = None
            freq.stage = "prefill" if self.disaggregated else ""
        handle.chain = None
        with self._mu:
            self.metrics["requests_requeued_total"] += 1
            if resumed:
                self.metrics["requeues_resumed_total"] += 1
                self.metrics["requeue_resumed_tokens_total"] += keep
        if freq._tracer is not None:
            # parent-linked to the replica-kill event exactly like the
            # chaos.pod_kill → job.gang_restart chain: the kill is the
            # ROOT of the disruption, each requeue a consequence of it
            # (falls back to the request's own trace for a non-kill
            # poisoned round). resumed_from_block attributes the rescue:
            # how many surviving pool blocks the requeue resumed from
            # (0 = the re-decode-from-scratch fallback).
            freq._tracer.event(
                "fleet.requeue",
                parent=self._kill_ctx.get(freq.replica) or freq.trace_ctx,
                request_id=freq.request_id, from_replica=freq.replica,
                attempt=freq.attempts,
                resumed_from_block=len(chain.refs) if resumed else 0,
                resumed_tokens=keep)
        try:
            self._dispatch(freq)
        except FleetOverloaded as exc:
            self._fail(freq, str(exc))

    def _fail(self, freq: FleetRequest, error: str) -> None:
        """Terminal failure: release any chain the request still owns,
        count, record, unblock."""
        if freq.chain is not None:
            freq.chain.release()
            freq.chain = None
        freq.error = error
        with self._mu:
            self.metrics["requests_failed_total"] += 1
        self._record_root(freq, "failed")
        freq.done.set()

    def _record_root(self, freq: FleetRequest, outcome: str) -> None:
        """Retroactively record the request's root span at its terminal
        transition (the one place done.set() is reached from)."""
        if freq._tracer is None:
            return
        end = freq.t_done if freq.t_done is not None \
            else time.perf_counter()
        attrs = {"request_id": freq.request_id, "outcome": outcome,
                 "attempts": freq.attempts, "replica": freq.replica,
                 "tokens": len(freq.tokens)}
        if freq.error is not None:
            attrs["error"] = freq.error
        freq._tracer.record_span(
            "request", freq.t_submit_wall, end - freq.t_submit,
            context=freq.trace_ctx, parent=freq.parent_ctx, **attrs)

    def _observe_rate(self, freq: FleetRequest) -> None:
        """EWMA of completed requests' SERVICE token rate — PROMPT +
        output tokens over the served window (submit-or-first-token to
        done), the same unit pending_tokens() counts (queued prompts +
        budgets). Mixing prompt/output units here would inflate
        estimated TTFT by their ratio and shed long-prompt traffic the
        fleet could comfortably serve.

        The window deliberately EXCLUDES queue wait (it starts at the
        first token when one exists): estimated TTFT divides the
        backlog by this rate, so folding queueing into the denominator
        is a positive feedback loop — a transient backlog depresses the
        "rate", which sheds admissions, which stops completions, which
        pins the rate low FOREVER (nothing completes while everything
        sheds): one congested peak and the fleet would refuse traffic it
        is idle for.
        Caller holds _mu."""
        done = freq.t_done or 0.0
        served = done - (freq.t_first
                         if freq.t_first is not None else freq.t_submit)
        if served <= 0.0:
            return
        rate = (freq.prompt.size + len(freq.tokens)) / served
        self._rate = (rate if self._rate <= 0.0
                      else (1 - _RATE_ALPHA) * self._rate
                      + _RATE_ALPHA * rate)

    @property
    def service_rate_tokens_per_s(self) -> float:
        return self._rate

    # ------------------------------------------------------------ chaos

    def kill_replica(self, name_or_idx, parent=None) -> Replica:
        """Chaos entry (the drills' mid-run kill): stop the replica's
        ticker and fail everything it carries — the on_done callbacks
        requeue every request onto the survivors. `parent` links the
        kill event under a decision span (an autoscaler's drain-timeout
        polite kill parents it to the fleet.scale_down that ordered the
        drain); None keeps the kill a root — the chaos shape."""
        rep = self._resolve(name_or_idx)
        tr = armed_tracer(self.tracer)
        if tr is not None:
            # the root of the disruption chain (the serving analogue of
            # chaos.pod_kill): every request the corpse was carrying
            # parent-links its fleet.requeue here — stamped BEFORE
            # _fail_all so the requeue callbacks can see it
            ev = tr.event("fleet.replica_kill", parent=parent,
                          replica=rep.name)
            if ev.context is not None:
                self._kill_ctx[rep.name] = ev.context
        with self._mu:
            # ordered against _dispatch (also under _mu): any dispatch
            # that won the race has ALREADY enqueued, so the _fail_all
            # below requeues it; later picks exclude the corpse
            rep.alive = False
            self.metrics["replica_kills_total"] += 1
        rep.engine.stop()
        rep.engine._fail_all("replica killed")
        return rep

    def add_replica(self, engine, name: str = "",
                    role: str = "mixed") -> Replica:
        """Scale-out entry (the autoscaler's add path). The new engine
        inherits the fleet's tracer AND monitoring TSDB (unless it
        brought its own), so scale-out replicas are visible to the SLO
        series from their first tick. On a disaggregated fleet the
        constructor's invariant holds here too: the new engine must
        share the ONE paged_kv pool (a decode-capable replica off the
        pool would crash the chain handoff/resume on an engine-thread
        callback, stranding the client)."""
        if role not in ("mixed", "prefill", "decode"):
            raise ValueError(f"unknown replica role {role!r}")
        pools = {id(r.engine.paged_kv): r.engine.paged_kv
                 for r in self.replicas}
        if self.disaggregated or role == "prefill":
            pools[id(engine.paged_kv)] = engine.paged_kv
            if any(p is None for p in pools.values()) or len(pools) != 1:
                raise ValueError(
                    "a disaggregated fleet needs every replica on ONE "
                    "shared paged_kv pool — it is the chain-handoff "
                    "medium")
        elif (len(pools) == 1
              and next(iter(pools.values())) is not None
              and engine.paged_kv is not next(iter(pools.values()))):
            # a fleet whose replicas all share one pool is resume-
            # capable: the kill-requeue guard decides "every live
            # replica shares the chain's pool" and then _pick may land
            # the resume on ANY replica — admitting an off-pool engine
            # here would let that dispatch race into an engine-side
            # refusal on the callback thread
            raise ValueError(
                "this fleet's replicas share one paged_kv pool (the "
                "resume-from-KV rescue dispatches chains to any "
                "replica) — scale-out engines must share it too")
        self._wire_engine(engine)
        rep = Replica(name=name or f"replica-{len(self.replicas)}",
                      engine=engine, role=role)
        self.replicas.append(rep)
        return rep

    def begin_drain(self, name_or_idx) -> Replica:
        """Scale-down entry (the scaler's graceful half): the replica
        stops admitting — _pick excludes it, ordered under _mu against
        in-flight dispatches exactly like kill_replica's alive flip —
        but keeps ticking its seated rows. In-flight requests finish in
        place; remove_replica() reaps the empty shell, and a drain that
        outlives its grace window is finished as a polite kill_replica
        (the kill's requeue resumes every survivor from its chain)."""
        rep = self._resolve(name_or_idx)
        with self._mu:
            rep.draining = True
        return rep

    def cancel_drain(self, name_or_idx) -> Replica:
        """Un-drain: the cheapest scale-up (no cold start) when demand
        returns before the drain finished."""
        rep = self._resolve(name_or_idx)
        with self._mu:
            rep.draining = False
        return rep

    def remove_replica(self, name_or_idx) -> Replica:
        """Reap a replica that can no longer carry work: drained empty,
        or dead (killed — _fail_all already requeued its requests). A
        live admitting replica, or a draining one with rows still
        seated, is refused — removal would strand its clients."""
        rep = self._resolve(name_or_idx)
        with self._mu:
            if rep.alive and (not rep.draining or rep.depth() > 0):
                raise ValueError(
                    f"replica {rep.name!r} still carries work (or still "
                    "admits) — drain it empty or kill_replica first")
            self.replicas.remove(rep)
        return rep

    def _resolve(self, name_or_idx) -> Replica:
        return (self.replicas[name_or_idx]
                if isinstance(name_or_idx, int)
                else next(r for r in self.replicas
                          if r.name == name_or_idx))

    # ------------------------------------------------------- autoscaling

    def demand_replicas(self) -> int:
        """Desired replica count from the queue/latency signal: pending
        tokens over what ONE replica can serve inside the TTFT SLO (the
        EWMA service rate is a per-request — i.e. per-replica-queue —
        rate, so it is NOT divided by the alive count: demand must
        depend on the backlog, not on how many replicas currently exist,
        or scale-out would raise its own demand signal). The floor is
        the number of BUSY replicas (scale-in only below actual use);
        the ceiling is the autoscaler's call.

        Scaled-to-zero guard: with no admittable replica the EWMA
        service rate has no live engine updating it, so the queue math
        is pinned instead of trusted — any queued work or any arrival
        recorded since the fleet emptied (the wake signal _pick stamps
        before shedding) demands one replica, and only a truly idle
        fleet demands zero (the scale-to-zero steady state). The signal
        can therefore never return 0 while anything is waiting."""
        alive = self._alive()
        serving = [r for r in alive if not r.draining]
        if not serving:
            backlog = sum(r.pending_tokens() for r in alive)
            return 1 if (self._wake_pending > 0 or backlog > 0) else 0
        busy = sum(1 for r in serving if r.depth() > 0)
        per_replica = (self.demand_tokens_per_replica
                       or self._rate * self.ttft_slo_s)
        if per_replica <= 0.0:
            return max(1, busy)
        import math

        return max(1, busy, math.ceil(self.pending_tokens() / per_replica))

    def wake_pending(self) -> int:
        """Arrivals shed for want of ANY admittable replica since the
        last clear — the scale-from-zero trigger the scaler consumes."""
        with self._mu:
            return self._wake_pending

    def clear_wake(self) -> None:
        """Scaler acknowledgment: capacity is being added for the
        recorded arrivals (FleetScaler's scale-from-zero path)."""
        with self._mu:
            self._wake_pending = 0

    #: the burn-rate multiplier on demand is clamped here: a saturated
    #: (capped) burn must scale the fleet decisively, not to infinity
    BURN_DEMAND_CAP = 4.0

    def demand_replicas_burn(self, monitor,
                             slos: tuple[str, ...] = (
                                 "serving_ttft_p99",
                                 "serving_decode_tick",
                                 "serving_zero_drop")) -> int:
        """Burn-rate-aware demand (the autoscaler's substrate): the
        queue-math demand signal, scaled up by the worst serving-SLO
        burn rate from the monitor's LAST evaluation. The queue signal
        alone can sit at steady state while the error budget burns (a
        decode-tick regression serves the same backlog slower); a burn
        past 1.0 means the fleet is failing its objectives at current
        size, so demand multiplies by the burn (clamped to
        BURN_DEMAND_CAP — the autoscaler's step bound, not ours). A
        quiet burn leaves the base signal untouched, so scale-IN still
        follows the queue math. Callers evaluate() the monitor on their
        own cadence; this reads state, never the TSDB."""
        base = self.demand_replicas()
        burn = 0.0
        for state in monitor.describe():
            if state["name"] in slos:
                rates = state.get("burn_rates", {})
                if rates:
                    burn = max(burn, max(rates.values()))
        if burn <= 1.0:
            return base
        import math

        return max(base, math.ceil(base * min(burn, self.BURN_DEMAND_CAP)))

    # --------------------------------------------------------- reporting

    def ttft_percentiles(self) -> dict[str, float]:
        with self._mu:
            samples = sorted(self._ttfts)
        if not samples:
            return {"p50_s": 0.0, "p99_s": 0.0}
        return {
            "p50_s": samples[len(samples) // 2],
            "p99_s": samples[min(len(samples) - 1,
                                 int(len(samples) * 0.99))],
        }

    def snapshot(self) -> dict:
        """One coherent metrics view for /metrics and the load report."""
        with self._mu:
            m = dict(self.metrics)
        m["queue_depth"] = self.queue_depth()
        m["pending_tokens"] = self.pending_tokens()
        m["replicas_alive"] = len(self._alive())
        m["demand_replicas"] = self.demand_replicas()
        m["service_rate_tokens_per_s"] = round(self._rate, 3)
        m.update({f"ttft_{k}": round(v, 6)
                  for k, v in self.ttft_percentiles().items()})
        return m

    # --------------------------------------------------------- lifecycle

    def start(self) -> "FleetRouter":
        for r in self._alive():
            r.engine.start()
        return self

    def stop(self) -> None:
        for r in self._alive():
            r.engine.stop()

    def run_until_idle(self) -> None:
        """Synchronous drive (tests, the cpu-proxy scenario): round-robin
        one tick per live replica until every queue and row is empty."""
        while True:
            busy = False
            for r in self._alive():
                busy = r.engine.tick() or busy
            if not busy:
                return
