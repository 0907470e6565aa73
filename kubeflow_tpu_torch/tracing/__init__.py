"""kubeflow_tpu_torch.tracing — the port's copy of the span model and the
bounded in-memory flight recorder (``kubeflow_tpu/tracing``): see core.py.
The serving engine records its per-request spans through it."""

from kubeflow_tpu_torch.tracing.core import (
    CARRIER_ANNOTATION,
    ENV_TRACE_DIR,
    ENV_TRACEPARENT,
    NOOP_TRACER,
    FlightRecorder,
    NoopTracer,
    Span,
    SpanContext,
    Tracer,
    armed_tracer,
    consume_delivered_context,
    current_context,
    flush,
    get_tracer,
    init_worker_from_env,
    set_delivered_context,
    set_tracer,
    tracer_of,
)
from kubeflow_tpu_torch.tracing.export import (
    to_chrome_trace,
    write_chrome_trace,
)

__all__ = [
    "CARRIER_ANNOTATION",
    "ENV_TRACE_DIR",
    "ENV_TRACEPARENT",
    "NOOP_TRACER",
    "FlightRecorder",
    "NoopTracer",
    "Span",
    "SpanContext",
    "Tracer",
    "armed_tracer",
    "consume_delivered_context",
    "current_context",
    "flush",
    "get_tracer",
    "init_worker_from_env",
    "set_delivered_context",
    "set_tracer",
    "to_chrome_trace",
    "tracer_of",
    "write_chrome_trace",
]
