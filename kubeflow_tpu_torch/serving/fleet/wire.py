"""Pod wire protocol — framing, envelopes, and the KV-chain handoff codec;
counterpart of ``kubeflow_tpu/serving/fleet/wire.py``.

The pod tier (podworker.py / podclient.py) speaks length-prefixed JSON
over a local AF_UNIX socket or loopback TCP: a 4-byte big-endian length
followed by one UTF-8 JSON object per frame, with an explicit length
prefix so a torn partial read is DETECTABLE instead of silently
resynchronized. This module is the transport's pure half: no sockets are
owned here and no engine is imported — the router imports the exception
types without dragging a worker runtime into its process. The frames are
the reference's byte for byte, so a port client can dial a JAX worker.

Envelope contract (client -> worker):

    {"verb": str, "seq": int, "deadline_s": float|null, ...payload}

`deadline_s` is the REMAINING budget at send time (a wall-clock instant
would not survive clock skew between processes). The worker re-anchors it
on receipt and rejects already-expired work with a 504-shaped error reply
instead of burning ticks on an answer nobody is waiting for.

Reply contract (worker -> client):

    {"seq": int, "ok": true,  ...result}
    {"seq": int, "ok": false, "code": int, "error": str,
     "retry_after_s": float?}        # 503 carries Retry-After

Chain handoff codec: a finished prefill chain crosses the process
boundary as its token ids + per-leaf K/V (base64 of the raw array
bytes) + the pool's OWN content digests for every block + a sha256 over
the raw bytes. The port's pool holds CPU torch tensors in the cache's
dtype: a bfloat16 leaf (which numpy cannot hold) travels as the raw bytes
of its int16 view, tagged ``"bfloat16"``; a float32 leaf is tagged
``"float32"`` and is byte for byte the reference codec's payload.
Deserialization re-inserts into the receiving pool and then cross-checks
the refs the local insert produced against the refs the sender claimed —
the chain digests are content-derived (sha1(parent + ids)), so any
corruption of ids in flight shows up as a digest mismatch even before the
sha256 of the K/V bytes is consulted.

The failure ladder: a replica that dies inside ``submit`` raises
``PodDead`` (the router flips it dead and re-picks), a resume refused by
the worker raises ``PodCallError`` with code 409 (the router falls back to
a chainless dispatch).
"""

from __future__ import annotations

import base64
import hashlib
import json
import socket
import struct
from typing import Any

import numpy as np
import torch

#: frame length prefix: 4-byte big-endian unsigned
_LEN = struct.Struct(">I")

#: hard per-frame ceiling — a corrupt length prefix must not convince the
#: reader to allocate gigabytes (one 128-token bf16 chain of GPT-2 small
#: is about 6 MiB of base64)
MAX_FRAME_BYTES = 256 * 1024 * 1024


class PodWireError(RuntimeError):
    """A wire-level failure talking to a pod: connection reset, torn
    frame, truncated read. Retryable by policy — the client redials and
    retries; exhaustion escalates to pod death."""


class PodDead(RuntimeError):
    """The pod is gone (process exited, marked dead, or retries
    exhausted). Deliberately NOT a PodWireError: the client's
    retry_on=(PodWireError,) must never spin against a corpse — the
    router re-picks a replica instead."""


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


# ---------------------------------------------------- the wire registry
#
# Every verb name, error code, and envelope/reply/event field name the
# two endpoints exchange, spelled out ONCE: podclient.py and podworker.py
# import these instead of inlining the strings, so a client can never
# write one spelling while the worker reads another.

# verbs (envelope F_VERB values; the worker dispatches _verb_<name>)
VERB_HELLO = "hello"
VERB_SUBMIT = "submit"
VERB_TICK = "tick"
VERB_DRAIN = "drain"
VERB_HEARTBEAT = "heartbeat"
VERB_KILL = "kill"
WIRE_VERBS = frozenset({
    VERB_HELLO, VERB_SUBMIT, VERB_TICK, VERB_DRAIN, VERB_HEARTBEAT,
    VERB_KILL,
})

# error-reply codes (HTTP-shaped, carried in F_CODE)
CODE_BAD_REQUEST = 400   # unknown verb / malformed envelope
CODE_CONFLICT = 409      # resume chain frozen on re-insert
CODE_FENCED = 410        # stale epoch — terminal for that claimant
CODE_INTERNAL = 500      # worker-side exception / dying engine
CODE_BUSY = 503          # queue full; carries F_RETRY_AFTER_S
CODE_DEADLINE = 504      # propagated deadline already spent
WIRE_CODES = frozenset({
    CODE_BAD_REQUEST, CODE_CONFLICT, CODE_FENCED, CODE_INTERNAL,
    CODE_BUSY, CODE_DEADLINE,
})

# envelope fields (client -> worker)
F_VERB = "verb"
F_SEQ = "seq"
F_EPOCH = "epoch"
F_DEADLINE_S = "deadline_s"
F_ACK = "ack"
F_N = "n"
F_RID = "rid"
F_PROMPT = "prompt"
F_MAX_NEW_TOKENS = "max_new_tokens"
F_EOS = "eos"
F_TEMPERATURE = "temperature"
F_KEEP_CHAIN = "keep_chain"
F_RESUME = "resume"

# reply fields (worker -> client)
F_OK = "ok"
F_CODE = "code"
F_ERROR = "error"
F_RETRY_AFTER_S = "retry_after_s"
F_EVENTS = "events"
F_BUSY = "busy"
F_DEPTH = "depth"
F_DUP = "dup"
F_DYING = "dying"
F_PORT = "port"
F_STEP_COUNT = "step_count"
F_TICK_ERROR = "tick_error"

# outbox event fields and kinds (inside F_EVENTS / F_CHAIN payloads)
F_EV = "ev"
F_ID = "id"
F_TOK = "tok"
F_TOKENS = "tokens"
F_RESUMED = "resumed"
F_CHAIN = "chain"
EV_TOKEN = "token"
EV_DONE = "done"
WIRE_EVENT_KINDS = frozenset({EV_TOKEN, EV_DONE})

WIRE_FIELDS = frozenset({
    F_VERB, F_SEQ, F_EPOCH, F_DEADLINE_S, F_ACK, F_N, F_RID, F_PROMPT,
    F_MAX_NEW_TOKENS, F_EOS, F_TEMPERATURE, F_KEEP_CHAIN, F_RESUME,
    F_OK, F_CODE, F_ERROR, F_RETRY_AFTER_S, F_EVENTS, F_BUSY, F_DEPTH,
    F_DUP, F_DYING, F_PORT, F_STEP_COUNT, F_TICK_ERROR,
    F_EV, F_ID, F_TOK, F_TOKENS, F_RESUMED, F_CHAIN,
})


# ------------------------------------------------------------- framing


def send_frame(sock: socket.socket, obj: dict) -> int:
    """Serialize `obj` and write one length-prefixed frame; returns the
    frame size in bytes (header included). Raises OSError on a dead
    socket — callers wrap transport faults into PodWireError."""
    data = json.dumps(obj, separators=(",", ":")).encode("utf-8")
    sock.sendall(_LEN.pack(len(data)) + data)
    return _LEN.size + len(data)


def recv_exact(sock: socket.socket, n: int) -> bytes:
    """Read exactly `n` bytes or raise PodWireError: a short read IS the
    torn-frame condition the length prefix exists to expose."""
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise PodWireError(
                f"connection closed mid-frame ({len(buf)}/{n} bytes)")
        buf.extend(chunk)
    return bytes(buf)


def recv_frame(sock: socket.socket) -> dict:
    """Read one length-prefixed JSON frame. PodWireError on EOF, torn
    frame, oversized length, or undecodable payload."""
    (n,) = _LEN.unpack(recv_exact(sock, _LEN.size))
    if n > MAX_FRAME_BYTES:
        raise PodWireError(f"frame length {n} exceeds {MAX_FRAME_BYTES}")
    data = recv_exact(sock, n)
    try:
        obj = json.loads(data.decode("utf-8"))
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise PodWireError(f"undecodable frame: {e}") from e
    if not isinstance(obj, dict):
        raise PodWireError("frame payload is not an object")
    return obj


# ----------------------------------------------------------- transport


class Transport:
    """The dial-side wire seam: one object owning one stream socket,
    speaking the length-prefixed JSON framing above. The pod client holds
    a Transport instead of a raw socket so AF_UNIX (single-host) and TCP
    are the SAME code path — connect / send_frame / recv_frame / close is
    the whole contract, and every fault surfaces as OSError (dial/send)
    or PodWireError (recv), which the client's retry supervisor absorbs.

    `sock` stays a public attribute on purpose: the torn-frame chaos
    injection reads a deliberate partial frame straight off the socket,
    and tests reach in to sever a connection out from under the client."""

    #: wire kind tag ("unix" | "tcp")
    kind = "base"
    _family = -1

    def __init__(self, address):
        self.address = address
        self.sock: socket.socket | None = None

    def connect(self, timeout_s: float | None = None) -> "Transport":
        """Dial `address`; OSError propagates (the client's startup
        poll and redial supervisor own the retry decision)."""
        s = socket.socket(self._family, socket.SOCK_STREAM)
        if timeout_s is not None:
            s.settimeout(timeout_s)
        try:
            s.connect(self.address)
        except OSError:
            s.close()
            raise
        self.sock = s
        return self

    @property
    def connected(self) -> bool:
        return self.sock is not None

    def settimeout(self, timeout_s: float | None) -> None:
        if self.sock is not None:
            self.sock.settimeout(timeout_s)

    def send_frame(self, obj: dict) -> int:
        if self.sock is None:
            raise PodWireError(f"{self.kind} transport is not connected")
        return send_frame(self.sock, obj)

    def recv_frame(self) -> dict:
        if self.sock is None:
            raise PodWireError(f"{self.kind} transport is not connected")
        return recv_frame(self.sock)

    def close(self) -> None:
        s, self.sock = self.sock, None
        if s is not None:
            try:
                s.close()
            except OSError:
                pass

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        state = "connected" if self.connected else "idle"
        return f"<{type(self).__name__} {self.address!r} {state}>"


class UnixTransport(Transport):
    """AF_UNIX stream transport — the single-host wire."""

    kind = "unix"
    _family = socket.AF_UNIX

    def __init__(self, path: str):
        super().__init__(str(path))


class TcpTransport(Transport):
    """TCP transport (loopback here: the worker binds 127.0.0.1 and hands
    the kernel-chosen port back through its port file + hello echo).
    NODELAY is set because every frame is a complete request/reply —
    Nagle would serialize the tick cadence behind delayed acks."""

    kind = "tcp"
    _family = socket.AF_INET

    def __init__(self, address: tuple[str, int]):
        host, port = address
        super().__init__((str(host), int(port)))

    def connect(self, timeout_s: float | None = None) -> "Transport":
        super().connect(timeout_s)
        self.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        return self


def make_transport(kind: str, address) -> Transport:
    """Build the transport for `kind` ("unix" | "tcp"). The address is
    a socket path for unix, a (host, port) pair for tcp."""
    if kind == "unix":
        return UnixTransport(address)
    if kind == "tcp":
        return TcpTransport(address)
    raise ValueError(f"unknown pod transport kind: {kind!r}")


# --------------------------------------------------------- chain codec

#: wire dtype tag -> torch dtype of a K/V leaf (the cache dtypes)
_TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
#: dtypes numpy cannot hold travel as the raw bytes of this integer view
_INT_VIEWS = {torch.bfloat16: torch.int16}


def _raw(a) -> tuple[bytes, str, list[int]]:
    """(raw bytes, dtype tag, shape) of a numpy array or a torch tensor.
    The tag is the bare dtype name both codecs read (``"float32"``, never
    ``"torch.float32"``)."""
    if isinstance(a, torch.Tensor):
        t = a.detach().to("cpu").contiguous()
        tag = str(t.dtype).removeprefix("torch.")
        view = _INT_VIEWS.get(t.dtype)
        data = (t.view(view) if view is not None else t).numpy().tobytes()
        return data, tag, list(t.shape)
    a = np.ascontiguousarray(a)
    return a.tobytes(), str(a.dtype), list(a.shape)


def _b64(a) -> dict:
    data, tag, shape = _raw(a)
    return {"shape": shape, "dtype": tag,
            "b64": base64.b64encode(data).decode("ascii")}


def _unb64_ids(spec: dict) -> np.ndarray:
    raw = base64.b64decode(spec["b64"])
    return np.frombuffer(raw, dtype=np.dtype(spec["dtype"])).reshape(
        spec["shape"]).copy()


def _unb64_kv(spec: dict) -> torch.Tensor:
    """A K/V leaf as a CPU torch tensor in its tagged dtype (the pool's
    storage form), decoded from the raw bytes."""
    dtype = _TORCH_DTYPES.get(spec["dtype"])
    if dtype is None:
        raise PodWireError(f"chain leaf dtype {spec['dtype']!r} unknown")
    raw = base64.b64decode(spec["b64"])
    if not raw:
        return torch.empty(spec["shape"], dtype=dtype)
    return torch.frombuffer(bytearray(raw), dtype=dtype).reshape(
        spec["shape"]).clone()


def _payload_sha256(ids: np.ndarray, kv: dict) -> str:
    h = hashlib.sha256()
    h.update(np.ascontiguousarray(ids, np.int32).tobytes())
    for path in sorted(kv):
        h.update(path.encode("utf-8"))
        h.update(_raw(kv[path])[0])
    return h.hexdigest()


def serialize_chain(pool, refs: list[bytes]) -> dict:
    """Serialize a HELD chain (the caller keeps its refs until the
    receiver confirms adoption) into a JSON-safe dict: ids + per-leaf
    K/V + the pool's content digests + a sha256 over the raw bytes."""
    ids, kv = pool.gather(refs)
    return {
        "n": int(ids.size),
        "ids": _b64(np.asarray(ids, np.int32)),
        "kv": {path: _b64(a) for path, a in kv.items()},
        "refs": [d.hex() for d in refs],
        "sha256": _payload_sha256(ids, kv),
    }


def deserialize_chain(pool, payload: dict):
    """Re-insert a serialized chain into `pool` and return a
    SequenceChain holding the produced refs.

    Integrity is checked twice: the sha256 over the decoded bytes must
    match the sender's, and — when the local insert covered every
    position — the content digests the local pool produced must equal
    the digests the sender claimed. An insert that stops early
    (covered-by-sibling / partial-parent in the receiving pool) yields a
    FROZEN chain, which the engine's resume validation rejects — the
    requeue then falls back to scratch, never to silently wrong K/V.
    Raises PodWireError on integrity failure."""
    from kubeflow_tpu_torch.serving.fleet.pagedkv import SequenceChain

    ids = _unb64_ids(payload["ids"])
    if ids.size != int(payload["n"]):
        raise PodWireError(
            f"chain length mismatch: {ids.size} ids vs n={payload['n']}")
    kv = {path: _unb64_kv(spec) for path, spec in payload["kv"].items()}
    got = _payload_sha256(ids, kv)
    if got != payload["sha256"]:
        raise PodWireError(
            f"chain payload sha256 mismatch ({got[:12]} != "
            f"{str(payload['sha256'])[:12]})")
    held = pool.insert(ids, kv)
    chain = SequenceChain(pool, held, expect_length=int(payload["n"]))
    if not chain.frozen:
        claimed = list(payload.get("refs", ()))
        if claimed and [d.hex() for d in held] != claimed:
            chain.release()
            raise PodWireError("chain digest mismatch after re-insert")
    return chain


# ----------------------------------------------------------- envelopes


def error_reply(seq: int, code: int, msg: str,
                retry_after_s: float | None = None) -> dict:
    rep: dict[str, Any] = {F_SEQ: seq, F_OK: False,
                           F_CODE: int(code), F_ERROR: str(msg)}
    if retry_after_s is not None:
        rep[F_RETRY_AFTER_S] = float(retry_after_s)
    return rep


def ok_reply(seq: int, **result) -> dict:
    rep: dict[str, Any] = {F_SEQ: seq, F_OK: True}
    rep.update(result)
    return rep
