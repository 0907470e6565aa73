"""X-Request-Id propagation for the model server.

The port's own copy of ``kubeflow_tpu/serving/requestid.py``: the HTTP
handler assigns (or echoes) the id and parks it in a contextvar, and error
bodies on the same request thread read it back. Handler threads are
per-request (ThreadingHTTPServer), so the id never leaks across concurrent
requests.
"""

from __future__ import annotations

import contextvars
import uuid

_REQUEST_ID: contextvars.ContextVar = contextvars.ContextVar(
    "serving_request_id", default="")


def new_request_id() -> str:
    """A fresh id (16 hex chars)."""
    return uuid.uuid4().hex[:16]


def set_request_id(rid: str) -> None:
    _REQUEST_ID.set(rid or "")


def get_request_id() -> str:
    """The current request's id ("" outside a serving request)."""
    return _REQUEST_ID.get()
