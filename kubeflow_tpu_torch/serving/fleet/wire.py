"""Pod wire protocol, the failure ladder only — counterpart of
``kubeflow_tpu/serving/fleet/wire.py``.

The pod tier (a worker subprocess per replica, spoken to over a local
socket) raises these four exceptions, and the in-process router
(router.py) already catches two of them: a replica that dies inside
``submit`` (``PodDead``) is flipped dead and another is picked, and a
resume refused by the worker (``PodCallError`` with code 409) falls back
to a chainless dispatch. In-process engines raise neither. The frames,
transports, envelope registry and chain-handoff codec of the reference
module come with the pod slice (ROADMAP Queue A item 5).
"""

from __future__ import annotations


class PodWireError(RuntimeError):
    """A wire-level failure talking to a pod: connection reset, torn
    frame, truncated read. Retryable by policy — the client redials and
    retries; exhaustion escalates to pod death."""


class PodDead(RuntimeError):
    """The pod is gone (process exited, marked dead, or retries
    exhausted). Deliberately NOT a PodWireError: a client's retry on
    wire errors must never spin against a corpse — the router re-picks a
    replica instead."""


class PodDeadlineExpired(RuntimeError):
    """The propagated deadline was already spent when the worker saw
    the envelope (a 504-shaped reply). Not retryable: the budget is
    gone no matter how healthy the wire is."""


class PodCallError(RuntimeError):
    """An application-level refusal from the worker (bad verb, poisoned
    engine, resume-chain refusal). Carries the reply's `code`; not
    retryable at the transport layer."""

    def __init__(self, code: int, msg: str):
        super().__init__(msg)
        self.code = int(code)
