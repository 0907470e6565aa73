"""Tracing core — spans, contextvar propagation, and the flight recorder.

The port's own copy of ``kubeflow_tpu/tracing/core.py`` (stdlib only), with
``threading.Lock`` in place of the lock-order checker's named locks and the
two environment-variable names kept here as constants.

Dependency-free (stdlib only) distributed tracing for the platform:

  - A Span is a named, timed interval with attributes, a 32-hex trace id
    shared by every span in one causal chain, and a 16-hex span id.
  - Propagation is implicit within a thread via a contextvar (entering a
    span makes it the parent of spans started under it) and explicit across
    boundaries: watch events carry the publishing write's SpanContext, pod
    env carries `KFTPU_TRACEPARENT` (W3C-traceparent-shaped), HTTP carries
    `X-Request-Id`.
  - Completed spans land in a FlightRecorder — a bounded in-memory ring
    buffer. Nothing is written anywhere until a snapshot is exported
    (export.py: Chrome trace-event JSON for Perfetto, or a text span tree),
    so always-on recording is safe in production: old spans fall off the
    ring and `spans_dropped_total` counts them.
  - Disabled tracing is the NOOP_TRACER: every call returns a shared inert
    span object, no allocation beyond the kwargs dict, no locks — cheap
    enough to leave on the trainer hot path unconditionally.

The platform side attaches a Tracer to the cluster (`cluster.tracer`,
`Platform.start_tracing`); worker processes get one from the env contract
(`init_worker_from_env`) and flush their ring to `KFTPU_TRACE_DIR` at exit,
where the drill/export side merges them into the platform's timeline.
"""

from __future__ import annotations

import contextvars
import os
import threading
import time
import uuid
from collections import deque

#: directory a worker flushes its spans to at exit
ENV_TRACE_DIR = "KFTPU_TRACE_DIR"
#: the parent span context a worker's spans join
ENV_TRACEPARENT = "KFTPU_TRACEPARENT"
#: object annotation carrying the SpanContext of the write that decided the
#: object's fate (e.g. the pod.exit span) — readable by any controller that
#: later acts on the object, independent of watch-delivery races
CARRIER_ANNOTATION = "tracing.kubeflow-tpu.org/carrier"

#: implicit parent for spans started in this thread/context
_CURRENT: contextvars.ContextVar = contextvars.ContextVar(
    "kftpu_current_span", default=None  # kftpu: allow=KFTPU-METRIC (contextvar name, not a metric)
)
#: SpanContext attached to the most recent watch event delivered on this
#: thread (set by WatchSubscription.get, consumed by informer loops)
_DELIVERED: contextvars.ContextVar = contextvars.ContextVar(
    "kftpu_delivered_event_ctx", default=None  # kftpu: allow=KFTPU-METRIC (contextvar name, not a metric)
)

#: sentinel: "inherit the parent from the current context"
_INHERIT = object()


class SpanContext:
    """The propagated reference to a span: (trace_id, span_id)."""

    __slots__ = ("trace_id", "span_id")

    def __init__(self, trace_id: str, span_id: str):
        self.trace_id = trace_id
        self.span_id = span_id

    def to_header(self) -> str:
        return f"{self.trace_id}-{self.span_id}"

    @classmethod
    def from_header(cls, header: str) -> "SpanContext | None":
        trace_id, sep, span_id = (header or "").partition("-")
        if not sep or not trace_id or not span_id:
            return None
        return cls(trace_id, span_id)

    def __repr__(self) -> str:  # debugging aid only
        return f"SpanContext({self.to_header()})"


class Span:
    """One timed interval. Context-manager entry makes it the implicit
    parent for spans started in the same thread; exit records it into the
    tracer's flight recorder (stamping an `error` attribute when exiting on
    an exception). start is wall-clock (cross-process comparable); duration
    comes from perf_counter (immune to clock steps)."""

    __slots__ = ("name", "trace_id", "span_id", "parent_id", "start",
                 "duration", "attrs", "_tracer", "_t0", "_token", "_tid")

    def __init__(self, tracer: "Tracer", name: str, trace_id: str,
                 span_id: str, parent_id: str, attrs: dict):
        self._tracer = tracer
        self.name = name
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.attrs = attrs
        self.start = time.time()
        self._t0 = time.perf_counter()
        self.duration = 0.0
        self._token = None
        self._tid = threading.get_ident()

    @property
    def context(self) -> SpanContext:
        return SpanContext(self.trace_id, self.span_id)

    def set_attribute(self, key: str, value) -> "Span":
        self.attrs[key] = value
        return self

    annotate = set_attribute

    def end(self) -> None:
        self.duration = time.perf_counter() - self._t0
        self._tracer._record(self)

    def __enter__(self) -> "Span":
        self._token = _CURRENT.set(self.context)
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        if self._token is not None:
            _CURRENT.reset(self._token)
            self._token = None
        if exc_type is not None:
            self.attrs.setdefault("error", f"{exc_type.__name__}: {exc}")
        self.end()
        return False

    def to_dict(self) -> dict:
        return {
            "name": self.name,
            "trace": self.trace_id,
            "span": self.span_id,
            "parent": self.parent_id,
            "ts": self.start,
            "dur": self.duration,
            "pid": os.getpid(),
            "tid": self._tid,
            "attrs": self.attrs,
        }


class _NoopSpan:
    """Shared inert span: the entire disabled-tracing hot path."""

    __slots__ = ()

    def __enter__(self) -> "_NoopSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def set_attribute(self, key: str, value) -> "_NoopSpan":
        return self

    annotate = set_attribute

    def end(self) -> None:
        pass

    @property
    def context(self):
        return None


_NOOP_SPAN = _NoopSpan()


class FlightRecorder:
    """Bounded ring buffer of completed spans (as plain dicts).

    The ring holds the last `capacity` finished spans; recording past a full
    ring evicts the oldest and counts it in `dropped` — the recorder never
    grows and never blocks, which is what makes always-on tracing safe."""

    def __init__(self, capacity: int = 4096):
        self.capacity = capacity
        self._ring: deque = deque(maxlen=capacity)
        self._mu = threading.Lock()
        self.started = 0
        self.finished = 0
        self.dropped = 0

    def note_started(self) -> None:
        with self._mu:
            self.started += 1

    def record(self, span_dict: dict) -> None:
        with self._mu:
            self.finished += 1
            if len(self._ring) == self.capacity:
                self.dropped += 1
            self._ring.append(span_dict)

    def snapshot(self) -> list[dict]:
        """Completed spans, oldest first — the export input."""
        with self._mu:
            return list(self._ring)

    def clear(self) -> None:
        with self._mu:
            self._ring.clear()

    def __len__(self) -> int:
        with self._mu:
            return len(self._ring)


class Tracer:
    """Span factory bound to one FlightRecorder."""

    enabled = True

    def __init__(self, capacity: int = 4096, trace_dir: str = "",
                 service: str = "platform"):
        self.recorder = FlightRecorder(capacity)
        #: when set, pods inherit it via env and flush their spans there
        self.trace_dir = trace_dir
        self.service = service
        #: parent for top-level spans when the contextvar is empty (worker
        #: processes: the controller span that created the pod)
        self.default_parent: SpanContext | None = None
        #: emission gate (Platform.stop_tracing): False freezes the ring —
        #: every span call degrades to the shared noop span, so reading or
        #: exporting a captured trace can never evict what it captured
        self.armed = True

    # --------------------------------------------------------------- spans

    def start_span(self, name: str, parent=_INHERIT, **attrs):
        """New span. `parent` may be a Span, a SpanContext, None (force a
        new root), or omitted (inherit: current context, else the tracer's
        default_parent). A disarmed tracer returns the shared noop span."""
        if not self.armed:
            return _NOOP_SPAN
        if parent is _INHERIT:
            parent = _CURRENT.get() or self.default_parent
        elif isinstance(parent, Span):
            parent = parent.context
        if parent is not None:
            trace_id, parent_id = parent.trace_id, parent.span_id
        else:
            trace_id, parent_id = uuid.uuid4().hex, ""
        self.recorder.note_started()
        return Span(self, name, trace_id, uuid.uuid4().hex[:16],
                    parent_id, attrs)

    # span() and start_span() are the same factory; span() reads better at
    # `with` sites, start_span() at manual begin/end sites
    span = start_span

    # ------------------------------------------------- retroactive recording

    def allocate_context(self, parent=_INHERIT) -> SpanContext | None:
        """Pre-allocate the identity of a span that will be recorded LATER
        with record_span(context=...). The serving data plane needs this
        shape: a request's root span can only be emitted once the request
        finishes (its duration is the whole point), but the engine spans
        recorded along the way must already parent to it. Pre-allocating
        the (trace_id, span_id) pair lets children link immediately while
        the root stays un-emitted — no open Span object rides the engine
        threads, so an error path can never leak one (the KFTPU-SPAN
        hazard class, avoided by construction). Returns None when
        disarmed."""
        if not self.armed:
            return None
        if parent is _INHERIT:
            parent = _CURRENT.get() or self.default_parent
        elif isinstance(parent, Span):
            parent = parent.context
        trace_id = parent.trace_id if parent is not None else uuid.uuid4().hex
        return SpanContext(trace_id, uuid.uuid4().hex[:16])

    def record_span(self, name: str, start: float, duration: float,
                    context: SpanContext | None = None, parent=None,
                    **attrs) -> SpanContext | None:
        """Record a COMPLETED interval retroactively: `start` is wall-clock
        seconds (time.time), `duration` perf-counter-derived seconds —
        the same clock convention live Spans use. `context` is a
        pre-allocated identity (allocate_context) whose children may
        already be in the recorder; `parent` a SpanContext (or Span) the
        recorded span links under. With no context one is derived from
        the parent. Returns the recorded span's context (None when
        disarmed)."""
        if not self.armed:
            return None
        if isinstance(parent, Span):
            parent = parent.context
        if context is None:
            trace_id = (parent.trace_id if parent is not None
                        else uuid.uuid4().hex)
            context = SpanContext(trace_id, uuid.uuid4().hex[:16])
        self.recorder.note_started()
        self.recorder.record({
            "name": name,
            "trace": context.trace_id,
            "span": context.span_id,
            "parent": parent.span_id if parent is not None else "",
            "ts": float(start),
            "dur": max(float(duration), 0.0),
            "pid": os.getpid(),
            "tid": threading.get_ident(),
            "attrs": attrs,
        })
        return context

    def event(self, name: str, parent=_INHERIT, **attrs):
        """Zero-duration span, recorded immediately (point-in-time marks:
        a kill landing, a conflict injected, a gang restart decided)."""
        sp = self.start_span(name, parent=parent, **attrs)
        sp.end()
        return sp

    def _record(self, span: Span) -> None:
        if not self.armed:
            # a span opened before disarm (e.g. a long-lived http.watch)
            # may end after it — the frozen ring must not be mutated
            return
        self.recorder.record(span.to_dict())

    # ------------------------------------------------------------- exports

    def snapshot(self) -> list[dict]:
        return self.recorder.snapshot()

    @property
    def metrics(self) -> dict[str, int]:
        r = self.recorder
        return {
            "spans_started_total": r.started,
            "spans_finished_total": r.finished,
            "spans_dropped_total": r.dropped,
        }


class NoopTracer:
    """Disabled tracing: every call lands on the shared inert span."""

    enabled = False
    recorder = None
    trace_dir = ""
    default_parent = None

    def start_span(self, name: str, parent=None, **attrs) -> _NoopSpan:
        return _NOOP_SPAN

    span = start_span

    def event(self, name: str, parent=None, **attrs) -> _NoopSpan:
        return _NOOP_SPAN

    def allocate_context(self, parent=None) -> None:
        return None

    def record_span(self, name: str, start: float, duration: float,
                    context=None, parent=None, **attrs) -> None:
        return None

    def snapshot(self) -> list[dict]:
        return []

    @property
    def metrics(self) -> dict[str, int]:
        return {}


NOOP_TRACER = NoopTracer()

# ------------------------------------------------------- ambient accessors

_GLOBAL: Tracer | NoopTracer = NOOP_TRACER


def get_tracer() -> "Tracer | NoopTracer":
    """The process-global tracer (NOOP until installed) — what worker-side
    code (the trainer) uses; platform components use the cluster-attached
    tracer instead so two platforms in one process never share a ring."""
    return _GLOBAL


def set_tracer(tracer: "Tracer | None") -> "Tracer | NoopTracer":
    global _GLOBAL
    _GLOBAL = tracer if tracer is not None else NOOP_TRACER
    return _GLOBAL


def tracer_of(obj) -> "Tracer | NoopTracer":
    """The tracer attached to a platform/cluster, else NOOP."""
    return getattr(obj, "tracer", None) or NOOP_TRACER


def armed_tracer(tracer) -> "Tracer | None":
    """`tracer` if it is a live (enabled AND armed) Tracer, else None —
    the one predicate the serving data plane uses to decide whether to
    pay for span bookkeeping on a request (None/NOOP/disarmed all mean
    'emit nothing')."""
    if tracer is None or not getattr(tracer, "enabled", False):
        return None
    return tracer if getattr(tracer, "armed", True) else None


def current_context() -> SpanContext | None:
    return _CURRENT.get()


def set_delivered_context(ctx: SpanContext | None) -> None:
    """Called by WatchSubscription.get: attach the publishing write's span
    context to this thread so the consumer loop can link its work to it."""
    _DELIVERED.set(ctx)


def consume_delivered_context() -> SpanContext | None:
    """Take (and clear) the last delivered event's span context."""
    ctx = _DELIVERED.get()
    if ctx is not None:
        _DELIVERED.set(None)
    return ctx


# ------------------------------------------------------- worker lifecycle


def init_worker_from_env(service: str = "worker") -> "Tracer | NoopTracer":
    """Install the process-global tracer from the pod env contract.

    No-op (returns the current global, normally NOOP) unless KFTPU_TRACE_DIR
    is set. KFTPU_TRACEPARENT, when present, becomes the default parent so
    worker spans join the controller's trace. A flush to
    `$KFTPU_TRACE_DIR/trace-<service>-<pid>.json` is registered atexit; a
    SIGKILLed incarnation simply loses its (in-memory) spans, exactly like
    a crashed process loses its flight recorder."""
    global _GLOBAL
    trace_dir = os.environ.get(ENV_TRACE_DIR, "")
    if not trace_dir or _GLOBAL.enabled:
        return _GLOBAL
    tracer = Tracer(trace_dir=trace_dir, service=service)
    tracer.default_parent = SpanContext.from_header(
        os.environ.get(ENV_TRACEPARENT, "")
    )
    _GLOBAL = tracer
    import atexit

    atexit.register(flush)
    return tracer


def flush(tracer: "Tracer | None" = None) -> str | None:
    """Write the tracer's ring to its trace_dir as Chrome trace JSON;
    returns the path (None when there is nothing to flush to). Idempotent —
    re-flushing overwrites the same per-process file."""
    t = tracer if tracer is not None else _GLOBAL
    if not t.enabled or not t.trace_dir:
        return None
    from kubeflow_tpu_torch.tracing.export import write_chrome_trace

    os.makedirs(t.trace_dir, exist_ok=True)
    path = os.path.join(t.trace_dir, f"trace-{t.service}-{os.getpid()}.json")
    write_chrome_trace(path, t.snapshot(), service=t.service)
    return path
