"""Pod client — the router-side engine facade over a subprocess pod;
counterpart of ``kubeflow_tpu/serving/fleet/podclient.py``.

spawn_pod() launches ``python -m kubeflow_tpu_torch.serving.fleet.podworker``
and returns a PodClient that quacks exactly like the ContinuousBatcher
surface the FleetRouter consumes (submit/tick/start/stop/_fail_all,
`_queue`/`_rows`/`paged_kv`/counter mirrors, the router's
`tracer`/`tsdb`/`_fleet_managed` assignments) — so a Replica whose engine
is a real subprocess is indistinguishable to the routing, requeue,
autoscaling, and load-test layers. What changes is the failure model:

  - every wire call rides utils/retry (BackoffPolicy + per-op Deadline
    propagated in the envelope as REMAINING seconds; 503 replies honor
    the worker's Retry-After hint via hinted_sleep); exhaustion — or a
    vanished process — escalates to pod death;
  - pod death fires `on_death` (wire_pod_deaths flips the Replica
    under router._mu) and then fails every local handle, whose on_done
    callbacks drive the router's zero-drop requeue exactly like an
    in-process _fail_all;
  - the paged-KV handoff crosses the process boundary: a prefill pod's
    finished chain arrives serialized in its done event and is
    re-inserted (digest-cross-checked) into the ROUTER-side home pool;
    a decode-leg dispatch serializes the home chain into the submit
    payload and KEEPS the home refs as the handle's recovery chain —
    on pod death that surviving chain transfers to the handle, and the
    router's token record resumes the decode with zero re-prefill.
    The home pool is shared by every PodClient of a fleet, so the
    router's resume-pool invariant holds unchanged.

Transport: the wire rides a wire.Transport — AF_UNIX or loopback TCP (the
worker binds 127.0.0.1:0, publishes the port atomically through its port
file, and echoes it in the hello). A TCP fleet inherits the network's
failure family, so the client grows three orthogonal states beyond
`dead`:

  - `partitioned`: the host is unreachable — wire ops fail without
    touching the socket, retries exhaust into death, and death paths
    SKIP the process kill (you cannot signal a host you cannot reach);
    the worker survives the partition, which is the split-brain hazard;
  - `fenced`: this client's claim on the replica identity is over (the
    scaler replaced it, or the worker answered 410 to a stale epoch).
    A fenced client refuses every late ack/token the healed wire could
    still deliver (counted in net_fenced_frames_total) — the
    router-side half of epoch fencing;
  - reconnects: _ensure_conn redials transparently inside the envelope
    Deadline; replays are exact because submits are rid-deduped and the
    outbox is cumulative-acked. Redials after an established connection
    count net_reconnects_total.

Locking: `_wire_mu` (socket) is a LEAF — nothing else is ever taken
under it; `_tick_mu` serializes tick rounds and event dispatch and may
reach router._mu through callbacks; `_lock` guards the handle table
only. submit() runs UNDER router._mu, so its failure path never fires
callbacks — it marks the pod quietly dead and raises PodDead for the
router's dispatch loop to re-pick (death propagation happens after _mu
is released).
"""

from __future__ import annotations

import json
import os
import random
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np

from kubeflow_tpu_torch.serving.fleet.wire import (
    CODE_BUSY,
    CODE_CONFLICT,
    CODE_DEADLINE,
    CODE_FENCED,
    CODE_INTERNAL,
    EV_DONE,
    EV_TOKEN,
    F_ACK,
    F_CHAIN,
    F_CODE,
    F_DEADLINE_S,
    F_DEPTH,
    F_EOS,
    F_EPOCH,
    F_ERROR,
    F_EV,
    F_EVENTS,
    F_ID,
    F_KEEP_CHAIN,
    F_MAX_NEW_TOKENS,
    F_N,
    F_OK,
    F_PORT,
    F_PROMPT,
    F_RESUME,
    F_RETRY_AFTER_S,
    F_RID,
    F_SEQ,
    F_STEP_COUNT,
    F_TEMPERATURE,
    F_TICK_ERROR,
    F_TOK,
    F_TOKENS,
    F_VERB,
    F_BUSY,
    PodCallError,
    PodDead,
    PodDeadlineExpired,
    PodWireError,
    Transport,
    VERB_HELLO,
    VERB_KILL,
    VERB_SUBMIT,
    VERB_TICK,
    make_transport,
    serialize_chain,
)
from kubeflow_tpu_torch.utils.envvars import (
    ENV_HEARTBEAT_FILE,
    ENV_POD_NAME,
    ENV_POD_PORT_FILE,
    ENV_POD_SOCKET,
    ENV_POD_SPEC,
    ENV_POD_TRANSPORT,
)
from kubeflow_tpu_torch.utils.retry import (
    BackoffPolicy,
    Deadline,
    hinted_sleep,
    poll_until,
    retry_call,
)

#: the checkout the worker subprocess imports
_REPO_ROOT = Path(__file__).resolve().parents[3]

#: default wire retry shape: fast, bounded — exhaustion must surface as
#: pod death within a few hundred ms, not park the dispatch path
DEFAULT_WIRE_POLICY = BackoffPolicy(
    base_s=0.02, max_s=0.25, multiplier=2.0, jitter=1.0, max_attempts=5)


# ------------------------------------------------- kftpu_pod_* registry

#: process-global pod metric families (the reference exposes them as
#: kftpu_pod_*) — module-global like the checkpoint-verify counters in
#: health.py: pods outlive any single router, and a dead pod's kill must
#: stay counted after its client is garbage
_POD_METRICS = {
    "spawns_total": 0,
    "kills_total": 0,
    "wire_retries_total": 0,
    "wire_retries_exhausted_total": 0,
    "wire_resets_total": 0,
    "deadline_rejects_total": 0,
    "handoff_bytes_total": 0,
    "net_reconnects_total": 0,
    "net_fenced_frames_total": 0,
    "net_duplicate_acks_refused_total": 0,
    "net_partitions_injected_total": 0,
}
_POD_METRICS_MU = threading.Lock()
#: live clients, for the heartbeat-age gauge (discarded on death)
_LIVE_CLIENTS: list["PodClient"] = []

#: the fleet-wide fence epoch — monotonic across every spawn in this
#: controller process, NEVER reset (a reset could hand a replacement an
#: epoch its fenced predecessor already used, which is exactly the
#: split-brain the fence exists to prevent)
_FENCE_EPOCH = 0


def next_fence_epoch() -> int:
    """Claim the next fence epoch. Every spawn_pod takes one, so a
    scaler replacement is BORN with a higher epoch than its victim."""
    global _FENCE_EPOCH
    with _POD_METRICS_MU:
        _FENCE_EPOCH += 1
        return _FENCE_EPOCH


def pod_metric_bump(name: str, n: int = 1) -> None:
    with _POD_METRICS_MU:
        _POD_METRICS[name] = _POD_METRICS.get(name, 0) + int(n)


def pod_metrics_snapshot() -> dict[str, int]:
    with _POD_METRICS_MU:
        return dict(_POD_METRICS)


def reset_pod_metrics() -> None:
    """Test isolation (the golden-exposition reset path)."""
    with _POD_METRICS_MU:
        for k in _POD_METRICS:
            _POD_METRICS[k] = 0
        del _LIVE_CLIENTS[:]


def pod_heartbeat_age_max_s() -> float:
    """Oldest live pod heartbeat in seconds — 0.0 with no live pods or
    no heartbeat contract armed (zero-valued-stable for /metrics)."""
    with _POD_METRICS_MU:
        clients = list(_LIVE_CLIENTS)
    ages = [a for a in (c.heartbeat_age() for c in clients)
            if a is not None]
    return round(max(ages), 6) if ages else 0.0


def _register_live(client: "PodClient") -> None:
    with _POD_METRICS_MU:
        if client not in _LIVE_CLIENTS:
            _LIVE_CLIENTS.append(client)


def _unregister_live(client: "PodClient") -> None:
    with _POD_METRICS_MU:
        if client in _LIVE_CLIENTS:
            _LIVE_CLIENTS.remove(client)


def _chain_payload_bytes(ser: dict) -> int:
    """Approximate wire size of a serialized chain (the b64 bodies are
    >99% of the frame) — the kftpu_pod_handoff_bytes_total unit."""
    n = len(ser.get("ids", {}).get("b64", ""))
    for spec in ser.get("kv", {}).values():
        n += len(spec.get("b64", ""))
    return n


# ------------------------------------------------------------- handles


class PodHandle:
    """The client-side mirror of a worker _InFlight row: same streaming
    and timing surface (the router's callbacks and the load-test
    collector read these), fed from the pod's event stream."""

    __slots__ = (
        "slot", "request_id", "rid", "max_new_tokens", "tokens", "done",
        "error", "t_submit", "t_first", "t_done", "on_token", "on_done",
        "trace_ctx", "chain", "resumed", "recovery_chain",
    )

    def __init__(self, rid: str, max_new_tokens: int,
                 on_token=None, on_done=None, trace_ctx=None,
                 request_id: str = ""):
        self.slot = -1
        self.rid = rid
        self.request_id = request_id
        self.max_new_tokens = int(max_new_tokens)
        self.tokens: list[int] = []
        self.done = threading.Event()
        self.error: str | None = None
        self.t_submit = time.perf_counter()
        self.t_first: float | None = None
        self.t_done: float | None = None
        self.on_token = on_token
        self.on_done = on_done
        self.trace_ctx = trace_ctx
        #: a chain whose ownership transferred TO this handle (adopted
        #: prefill handoff, or the recovery chain on pod death) — the
        #: router's _on_done consumes or releases it
        self.chain = None
        self.resumed = False
        #: the HOME-pool chain backing a decode-leg resume: held (not
        #: released) until the pod finishes, so a SIGKILL mid-decode
        #: still has the surviving blocks to resume from
        self.recovery_chain = None

    def push(self, tok: int) -> None:
        if not self.tokens:
            self.t_first = time.perf_counter()
        self.tokens.append(int(tok))
        if self.on_token is not None:
            self.on_token(self, tok)

    def finish(self, error: str | None = None) -> None:
        if self.done.is_set():
            return
        self.error = error if self.error is None else self.error
        self.t_done = time.perf_counter()
        self.done.set()
        if self.on_done is not None:
            self.on_done(self)

    @property
    def ttft_s(self) -> float | None:
        return None if self.t_first is None \
            else self.t_first - self.t_submit

    @property
    def tokens_per_s(self) -> float | None:
        if self.t_first is None or self.t_done is None:
            return None
        dt = self.t_done - self.t_first
        return len(self.tokens) / dt if dt > 0 else float("inf")

    def result(self, timeout: float | None = None) -> np.ndarray:
        if not self.done.wait(timeout):
            raise TimeoutError("generation did not finish in time")
        if self.error is not None:
            raise RuntimeError(f"generation failed: {self.error}")
        return np.asarray(self.tokens, np.int32)


# -------------------------------------------------------------- client


class PodClient:
    """Engine facade over one worker process (see module docstring)."""

    def __init__(self, name: str, socket_path: str, *,
                 proc: "subprocess.Popen | None" = None,
                 heartbeat_path: str | None = None,
                 stderr_path: str | None = None,
                 policy: BackoffPolicy | None = None,
                 op_timeout_s: float = 30.0,
                 ticks_per_call: int = 1,
                 chaos=None,
                 transport: str = "unix",
                 port_file: str | None = None,
                 epoch: int = 0):
        self.name = name
        self.socket_path = socket_path
        self.transport_kind = transport
        self.port_file = port_file
        self.epoch = int(epoch)
        self.proc = proc
        self.heartbeat_path = heartbeat_path
        self.stderr_path = stderr_path
        self.policy = policy or DEFAULT_WIRE_POLICY
        self.op_timeout_s = float(op_timeout_s)
        self.ticks_per_call = max(int(ticks_per_call), 1)
        self.chaos = chaos
        self._rng = random.Random(f"kftpu-pod-{name}")
        # --- engine facade surface the Replica/router reads
        self._queue: list = []          # always empty: rows seat remotely
        self._rows: list[PodHandle] = []
        self._lock = threading.Lock()
        self.paged_kv = None            # the router-side HOME pool
        self.tracer = None
        self.tsdb = None
        self._fleet_managed = False
        self.step_count = 0
        self.prefill_tokens_total = 0
        self.prefill_tokens_reused = 0
        self.default_max_new_tokens = 32
        self.eos_token_id: tuple[int, ...] | None = None
        self.worker_pid: int | None = None
        # --- wire state
        self._wire_mu = threading.Lock()
        self._tick_mu = threading.Lock()
        self._transport: Transport | None = None
        self._ever_connected = False
        self._port: int | None = None      # discovered TCP port
        self._seq = 0
        self._acked = 0
        self._rid_counter = 0
        self._by_rid: dict[str, PodHandle] = {}
        self._worker_depth = 0
        # --- death state
        self.dead = False
        self.dead_reason: str | None = None
        self._death_propagated = False
        self.on_death = None
        # --- network state (module docstring: the TCP failure family)
        self.partitioned = False
        self.fenced = False
        self.fence_reason: str | None = None
        #: the worker process belongs to a SUCCESSOR's claim (fenced by
        #: a 410) — death paths must not kill it out from under the new
        #: owner. Distinct from `fenced`: a local _fail_all fences too,
        #: but the process is ours and reachable, so it still dies.
        self._disowned = False
        self._stop_evt = threading.Event()
        self._thread: threading.Thread | None = None

    # --------------------------------------------------------- wire ops

    def _close_socket(self) -> None:
        t, self._transport = self._transport, None
        if t is not None:
            t.close()

    def _resolve_port(self) -> int:
        """Discover the TCP port the worker published (its port file is
        written atomically AFTER the bind, so a readable file IS a
        listening socket)."""
        if self._port is not None:
            return self._port
        if not self.port_file:
            raise PodWireError(
                f"pod {self.name}: tcp transport without a port file")
        try:
            with open(self.port_file, encoding="utf-8") as fh:
                self._port = int(fh.read().strip())
        except (OSError, ValueError) as e:
            raise PodWireError(f"port file unreadable: {e}") from e
        return self._port

    def _ensure_conn(self, timeout_s: float) -> Transport:
        """The connection supervisor: dial (or redial) the worker. A
        redial after an ESTABLISHED connection is a reconnect — counted,
        because every one of them exercised the replay contract."""
        if self._transport is None:
            if self.transport_kind == "tcp":
                address = ("127.0.0.1", self._resolve_port())
            else:
                address = self.socket_path
            t = make_transport(self.transport_kind, address)
            try:
                t.connect(timeout_s)
            except OSError as e:
                raise PodWireError(f"connect failed: {e}") from e
            self._transport = t
            if self._ever_connected:
                pod_metric_bump("net_reconnects_total")
            self._ever_connected = True
        else:
            self._transport.settimeout(timeout_s)
        return self._transport

    def _attempt(self, verb: str, payload: dict,
                 deadline: Deadline | None, timeout_s: float,
                 bypass_fence: bool = False) -> dict:
        if (self.dead or self.fenced) and not bypass_fence:
            raise PodDead(self.dead_reason or self.fence_reason
                          or f"pod {self.name} dead")
        if self.partitioned:
            # unreachable host: nothing crosses the wire in either
            # direction — the retry layer backs off and (inside the
            # Deadline) either outlives the partition or exhausts
            raise PodWireError(
                f"pod {self.name} unreachable (partitioned)")
        fault = self.chaos.on_wire_op() if self.chaos is not None \
            else None
        if isinstance(fault, tuple):  # ("delay", s): stall in flight
            # deliberately unclamped by the deadline — the fault MODELS
            # a stall that overshoots the budget, so the envelope's
            # remaining_s goes non-positive and the worker 504s
            hinted_sleep(fault[1])
        with self._wire_mu:
            if fault == "reset":
                self._close_socket()
                pod_metric_bump("wire_resets_total")
                raise PodWireError("chaos: connection reset")
            if fault in ("partition", "blackhole"):
                # the frame is lost BEFORE delivery (a black hole eats
                # it; a partition never carries it) — the worker sees
                # nothing, so the replay after reconnect is the first
                # delivery, not a duplicate
                self._close_socket()
                raise PodWireError(f"chaos: {fault} (frame lost)")
            self._seq += 1
            env = {F_VERB: verb, F_SEQ: self._seq, F_EPOCH: self.epoch,
                   F_DEADLINE_S: (deadline.remaining()
                                  if deadline is not None else None)}
            env.update(payload)
            if fault == "dup" and F_ACK in payload:
                # duplicate delivery, modeled at its true cause: the
                # previous ack is lost in flight, so the worker's outbox
                # keeps everything the client already applied and
                # redelivers it — the id-filter refuses every copy
                # (kftpu_pod_net_duplicate_acks_refused_total)
                env[F_ACK] = 0
            try:
                tr = self._ensure_conn(timeout_s)
                tr.send_frame(env)
                if fault == "halfopen":
                    # half-open connection: the frame WAS delivered (the
                    # worker processes it) but the reply never comes —
                    # the retry replays the verb, and only rid-dedup +
                    # cumulative acks keep that replay exact
                    self._close_socket()
                    raise PodWireError(
                        "chaos: half-open connection (reply lost)")
                if fault == "torn":
                    # truncate the reply mid-read, then drop the
                    # connection: exactly the partial frame the length
                    # prefix exists to detect
                    tr.sock.recv(2)
                    self._close_socket()
                    raise PodWireError("chaos: torn frame")
                reply = tr.recv_frame()
            except OSError as e:
                self._close_socket()
                raise PodWireError(f"{type(e).__name__}: {e}") from e
            except PodWireError:
                self._close_socket()
                raise
            if int(reply.get(F_SEQ, -1)) != self._seq:
                self._close_socket()
                raise PodWireError(
                    f"reply seq {reply.get(F_SEQ)} != {self._seq}")
        if reply.get(F_OK):
            return reply
        code = int(reply.get(F_CODE, CODE_INTERNAL))
        if code == CODE_FENCED:
            # the worker adopted a NEWER epoch: this client's claim on
            # the replica identity is over. Fence (terminal — late
            # events will be refused) but never kill the process: it
            # now belongs to the successor's claim.
            pod_metric_bump("net_fenced_frames_total")
            self._disowned = True
            # free the wire at once: the worker serves one connection
            # at a time, and holding this one would starve the very
            # successor whose epoch just outranked us
            self._close_socket()
            self.fence(f"worker refused stale epoch {self.epoch}: "
                       f"{reply.get(F_ERROR, code)}")
            raise PodDead(
                f"pod {self.name} fenced: {reply.get(F_ERROR, code)}")
        if code == CODE_BUSY:
            # server-side backpressure: honor Retry-After within the
            # caller's budget, then let the retry layer re-dial
            if hinted_sleep(float(reply.get(F_RETRY_AFTER_S, 0.05)),
                            cap_s=1.0, deadline=deadline):
                raise PodWireError("overloaded (retry-after taken)")
            raise PodDeadlineExpired(
                "overloaded and no budget left for Retry-After")
        if code == CODE_DEADLINE:
            pod_metric_bump("deadline_rejects_total")
            raise PodDeadlineExpired(reply.get(F_ERROR, "deadline"))
        raise PodCallError(code, reply.get(F_ERROR, "pod call failed"))

    def call(self, verb: str, payload: dict | None = None, *,
             deadline: Deadline | None = None,
             timeout_s: float | None = None,
             _bypass_fence: bool = False) -> dict:
        """One wire verb under the retry policy. Raises PodWireError on
        exhausted transport faults, PodDeadlineExpired on a spent
        budget, PodCallError on an application refusal, PodDead once
        the pod is marked dead."""
        attempts = 0
        t = timeout_s if timeout_s is not None else self.op_timeout_s

        def attempt():
            nonlocal attempts
            attempts += 1
            return self._attempt(verb, dict(payload or {}), deadline, t,
                                 bypass_fence=_bypass_fence)

        try:
            out = retry_call(attempt, policy=self.policy,
                             retry_on=(PodWireError,), rng=self._rng)
        except PodWireError:
            # exhaustion escalating to pod death: the N absorbed faults
            # stay OUT of wire_retries (that family counts only faults
            # the retry layer actually rode through — a healthy run
            # keeps it 0) but the give-up itself must be visible, not
            # just as a kills_total increment with no cause attached
            pod_metric_bump("wire_retries_exhausted_total")
            raise
        if attempts > 1:
            pod_metric_bump("wire_retries_total", attempts - 1)
        return out

    # ---------------------------------------------------------- spawn

    def connect(self, timeout_s: float = 180.0) -> "PodClient":
        """Wait for the worker's rendezvous artifact — the AF_UNIX
        socket path, or the TCP port file (both appear only after the
        in-process warmup) — and complete the hello handshake. On TCP
        the hello echoes the worker's bound port, which must match the
        discovered one (a stale port file from a previous incarnation
        would otherwise silently dial a stranger)."""
        rendezvous = (self.port_file if self.transport_kind == "tcp"
                      else self.socket_path)

        def ready():
            if self.proc is not None and self.proc.poll() is not None:
                raise PodDead(
                    f"pod {self.name} exited rc={self.proc.returncode} "
                    f"before ready (stderr: {self.stderr_path})")
            return True if (rendezvous
                            and os.path.exists(rendezvous)) else None

        poll_until(ready, timeout_s=timeout_s,
                   describe=f"pod {self.name} {self.transport_kind} "
                            f"rendezvous")
        hello = self.call(VERB_HELLO,
                          timeout_s=max(self.op_timeout_s, 10.0))
        if self.transport_kind == "tcp":
            echoed = hello.get(F_PORT)
            if echoed is not None and self._port is not None \
                    and int(echoed) != self._port:
                raise PodDead(
                    f"pod {self.name} hello port {echoed} != "
                    f"discovered {self._port}")
        self.worker_pid = int(hello["pid"])
        self.default_max_new_tokens = int(
            hello["default_max_new_tokens"])
        eos = hello.get("eos_token_id")
        self.eos_token_id = tuple(int(t) for t in eos) if eos else None
        _register_live(self)
        return self

    @property
    def pid(self) -> int | None:
        if self.worker_pid is not None:
            return self.worker_pid
        return self.proc.pid if self.proc is not None else None

    def heartbeat_age(self) -> float | None:
        """Seconds since the worker's last liveness beat (None without a
        heartbeat contract or before the first beat) — what the
        scaler's hang watch consumes: a SIGSTOPped pod stays alive and
        connected but this age grows without bound."""
        if self.heartbeat_path is None:
            return None
        from kubeflow_tpu_torch.health import read_heartbeat

        hb = read_heartbeat(self.heartbeat_path)
        if hb is None:
            return None
        return max(time.time() - hb.ts, 0.0)

    # -------------------------------------------------- engine facade

    def submit(self, prompt_ids, max_new_tokens: int | None = None,
               eos_token_id=None, temperature: float = 0.0,
               key=None, on_token=None, on_done=None,
               trace_ctx=None, request_id: str = "",
               keep_chain: bool = False, resume_from=None) -> PodHandle:
        """Mirror of ContinuousBatcher.submit over the wire. Runs UNDER
        router._mu on the dispatch path: a wire failure here must not
        fire callbacks (the router holds its own lock) — the pod is
        marked quietly dead and PodDead raised; the router's dispatch
        loop re-picks and propagates the death after releasing _mu."""
        if self.dead or self.fenced:
            raise PodDead(self.dead_reason or self.fence_reason
                          or f"pod {self.name} dead")
        ids = np.asarray(prompt_ids, np.int32).reshape(-1)
        budget = int(max_new_tokens or self.default_max_new_tokens)
        with self._lock:
            self._rid_counter += 1
            rid = f"{self.name}-{self._rid_counter}"
        eos = eos_token_id
        if eos is not None and not isinstance(eos, (int, np.integer)):
            eos = [int(t) for t in np.asarray(eos).reshape(-1)]
        elif eos is not None:
            eos = int(eos)
        payload = {
            F_RID: rid,
            F_PROMPT: [int(t) for t in ids],
            F_MAX_NEW_TOKENS: budget,
            F_EOS: eos,
            F_TEMPERATURE: float(temperature),
            F_KEEP_CHAIN: bool(keep_chain),
            F_RESUME: None,
        }
        handle = PodHandle(rid, budget, on_token=on_token,
                           on_done=on_done, trace_ctx=trace_ctx,
                           request_id=request_id)
        if resume_from is not None:
            chain, toks = resume_from
            if chain.frozen:
                raise ValueError("cannot resume from a frozen chain")
            if self.paged_kv is not None \
                    and chain.pool is not self.paged_kv:
                raise ValueError(
                    "resume chain lives in a different pool than this "
                    "pod's home pool")
            ser = serialize_chain(chain.pool, chain.refs)
            payload[F_RESUME] = {F_CHAIN: ser,
                                 F_TOKENS: [int(t) for t in toks]}
            pod_metric_bump("handoff_bytes_total",
                            _chain_payload_bytes(ser))
            # the zero-drop collateral: the HOME chain stays held on
            # the handle — a pod death mid-decode transfers it back to
            # the router's requeue instead of losing the blocks
            handle.recovery_chain = chain
            handle.tokens = [int(t) for t in toks]  # pre-fed, no cbs
            handle.resumed = True
            handle.t_first = time.perf_counter()
        try:
            self.call(VERB_SUBMIT, payload)
        except (PodWireError, PodDead, OSError) as e:
            self._quiet_dead(f"wire failure during submit: {e}")
            raise PodDead(
                f"pod {self.name} died during submit: {e}") from e
        except PodCallError as e:
            if e.code == CODE_CONFLICT and resume_from is not None:
                # resume refusal (frozen on re-insert in the worker
                # pool): release the recovery hold and fall back to
                # scratch via the router's requeue arithmetic
                handle.recovery_chain = None
                resume_from[0].release()
            raise
        with self._lock:
            self._by_rid[rid] = handle
            self._rows = self._rows + [handle]
        return handle

    def tick(self) -> bool:
        """One tick round-trip: drive the worker's engine, drain its
        event outbox (deduped by cumulative ack — a redelivered event
        after a torn frame is skipped, never double-pushed), mirror its
        counters. Event callbacks run OUTSIDE every client lock."""
        if self.dead:
            return False
        with self._tick_mu:
            if self.dead:
                return False
            try:
                reply = self.call(
                    VERB_TICK,
                    {F_ACK: self._acked, F_N: self.ticks_per_call})
            except (PodWireError, OSError) as e:
                self._mark_dead(f"wire failure during tick: {e}")
                return False
            except PodDead as e:
                if self.fenced and not self.dead:
                    # fenced mid-tick (410): terminal for the replica,
                    # but the PROCESS belongs to the successor now —
                    # _quiet_dead's fenced guard skips the kill
                    self._mark_dead(f"fenced: {e}")
                else:
                    self._propagate_death()
                return False
            if self.fenced or self.dead:
                # the fence raced the round-trip: a kill/replace landed
                # while this frame was in flight. Whatever the reply
                # carries is a LATE delivery from a superseded claim —
                # refuse every event, ack nothing (the router-side half
                # of epoch fencing).
                late = list(reply.get(F_EVENTS, ()))
                if late:
                    pod_metric_bump("net_fenced_frames_total",
                                    len(late))
                return False
            self.step_count = int(
                reply.get(F_STEP_COUNT, self.step_count))
            self.prefill_tokens_total = int(
                reply.get("prefill_tokens_total",
                          self.prefill_tokens_total))
            self.prefill_tokens_reused = int(
                reply.get("prefill_tokens_reused",
                          self.prefill_tokens_reused))
            self._worker_depth = int(reply.get(F_DEPTH, 0))
            raw = list(reply.get(F_EVENTS, ()))
            events = [e for e in raw
                      if int(e.get(F_ID, 0)) > self._acked]
            if len(raw) > len(events):
                # redelivery of already-acked events (a lost ack, a
                # replayed tick after reconnect): each copy is refused
                # by the cumulative-ack filter, never double-pushed
                pod_metric_bump("net_duplicate_acks_refused_total",
                                len(raw) - len(events))
            if events:
                self._acked = int(events[-1][F_ID])
            for ev in events:
                self._apply_event(ev)
            if reply.get(F_TICK_ERROR):
                # poisoned engine: its _fail_all events just drained
                # above; the process itself is now useless — reap it
                self._mark_dead(
                    f"worker engine poisoned: {reply[F_TICK_ERROR]}")
                return False
            return bool(reply.get(F_BUSY)) or bool(self._rows)

    def _apply_event(self, ev: dict) -> None:
        h = self._by_rid.get(str(ev.get(F_RID, "")))
        if h is None or h.done.is_set():
            return
        if ev.get(F_EV) == EV_TOKEN:
            h.push(int(ev[F_TOK]))
            return
        if ev.get(F_EV) != EV_DONE:
            return
        # reconcile: the done event's token list is authoritative; any
        # suffix the stream hasn't delivered yet (lost with a torn
        # frame, redelivered here) pushes now
        final = [int(t) for t in ev.get(F_TOKENS, ())]
        for tok in final[len(h.tokens):]:
            h.push(tok)
        error = ev.get(F_ERROR)
        if error is None and ev.get(F_CHAIN) is not None \
                and self.paged_kv is not None:
            from kubeflow_tpu_torch.serving.fleet.wire import deserialize_chain

            try:
                h.chain = deserialize_chain(self.paged_kv, ev[F_CHAIN])
                pod_metric_bump("handoff_bytes_total",
                                _chain_payload_bytes(ev[F_CHAIN]))
            except (PodWireError, KeyError, ValueError):
                h.chain = None  # integrity refusal → scratch fallback
        if error is None and h.recovery_chain is not None:
            # the resumed decode finished — the home-pool hold served
            # its purpose
            h.recovery_chain.release()
            h.recovery_chain = None
        if error is not None:
            self._transfer_recovery(h)
        with self._lock:
            self._by_rid.pop(h.rid, None)
            self._rows = [r for r in self._rows if r is not h]
        h.finish(error=error)

    def _transfer_recovery(self, h: PodHandle) -> None:
        """A failing handle's home-pool recovery chain transfers to
        `h.chain` when the router's requeue is listening (the same
        conditions ContinuousBatcher._fail_all applies) — otherwise the
        hold releases so blocks never leak."""
        chain, h.recovery_chain = h.recovery_chain, None
        if chain is None:
            return
        if h.on_done is not None and self._fleet_managed \
                and not chain.frozen and h.chain is None:
            h.chain = chain
        else:
            chain.release()

    # -------------------------------------------------------- lifecycle

    def start(self) -> "PodClient":
        if self._thread is None or not self._thread.is_alive():
            self._stop_evt.clear()
            self._thread = threading.Thread(
                target=self._loop, name=f"pod-client-{self.name}",
                daemon=True)
            self._thread.start()
        return self

    def _loop(self) -> None:
        while not self._stop_evt.is_set():
            busy = self.tick()
            if self.dead:
                return
            if not busy:
                self._stop_evt.wait(0.002)

    def stop(self) -> None:
        """Stop the client ticker thread. Does NOT kill the pod — the
        router's kill path continues into _fail_all, and a drill's
        clean shutdown uses kill()/drain() explicitly."""
        self._stop_evt.set()
        t = self._thread
        if t is not None and t is not threading.current_thread():
            t.join(timeout=5.0)
        self._thread = None

    def drain(self, timeout_s: float = 30.0) -> bool:
        """Tick until the worker and the local handle table are empty.
        True on drained; False when the budget ran out first."""
        deadline = Deadline(timeout_s)
        while not self.dead:
            self.tick()
            with self._lock:
                local = len(self._rows)
            if local == 0 and self._worker_depth == 0:
                return True
            if deadline.expired():
                return False
        return False

    def kill(self, timeout_s: float = 5.0) -> None:
        """Graceful shutdown: ask the worker to exit, reap, mark dead
        quietly (no requeue callbacks — drain first if rows matter)."""
        try:
            self.call(VERB_KILL, timeout_s=timeout_s)
        except (PodWireError, PodDead, PodDeadlineExpired,
                PodCallError, OSError):
            pass
        self._quiet_dead("killed (graceful)")

    # ------------------------------------------------------------ death

    def _kill_process(self) -> None:
        p = self.proc
        if p is None:
            return
        if p.poll() is None:
            try:
                p.kill()
            except OSError:
                pass
        try:
            p.wait(timeout=5.0)
        except (subprocess.TimeoutExpired, OSError):
            pass

    def _quiet_dead(self, reason: str) -> bool:
        """Flip dead, close the wire, reap the process — NO callbacks
        (safe under router._mu). Returns True on the first flip.

        The process kill is SKIPPED for a partitioned or disowned pod:
        an unreachable host cannot be signaled, and a 410-fenced
        worker is already serving its successor's claim — in both
        cases the worker SURVIVES this death, which is exactly the
        split-brain hazard the epoch fence exists to neutralize. (A
        LOCAL fence — _fail_all on a reachable host — still kills: the
        process is ours.)"""
        with self._lock:
            if self.dead:
                return False
            self.dead, self.dead_reason = True, reason
        self._stop_evt.set()
        self._close_socket()
        if self.partitioned or self._disowned:
            # the worker outlives this death — whatever it still holds
            # is a superseded claim and must be refused if the wire
            # ever heals
            self.fence(reason)
        else:
            self._kill_process()
        _unregister_live(self)
        pod_metric_bump("kills_total")
        return True

    def _propagate_death(self) -> None:
        """Fire on_death (the Replica alive flip) then fail every local
        handle — their on_done callbacks drive the router requeue.
        Must be called with NO client or router locks held."""
        with self._lock:
            if self._death_propagated or not self.dead:
                return
            self._death_propagated = True
        if self.on_death is not None:
            self.on_death(self)
        self._fail_local(self.dead_reason or "pod died")

    def _fail_local(self, reason: str) -> None:
        with self._lock:
            rows, self._rows = self._rows, []
            self._by_rid = {}
        for h in rows:
            self._transfer_recovery(h)
            h.finish(error=reason)

    def _mark_dead(self, reason: str) -> None:
        self._quiet_dead(reason)
        self._propagate_death()

    def _fail_all(self, reason: str) -> None:
        """The router's kill_replica contract (after its alive flip):
        terminate the pod and requeue everything it carried. The kill
        decision FENCES first — from this point every late ack/token
        the wire could still deliver (a partition healing after the
        scaler replaced this replica) is a superseded claim and will be
        refused, so the requeued rids can never stream twice."""
        self.fence(reason)
        self._quiet_dead(reason)
        self._propagate_death()

    # ---------------------------------------------------------- fencing

    def fence(self, reason: str) -> None:
        """Permanently fence this client: its claim on the replica
        identity is over (scaler replacement, or a worker 410).
        Idempotent; fencing itself touches no process — whether the
        worker dies is _quiet_dead's decision (it spares partitioned
        and disowned workers). A fenced client refuses every event the
        wire still delivers (net_fenced_frames_total counts each)."""
        with self._lock:
            if self.fenced:
                return
            self.fenced = True
            self.fence_reason = reason

    def set_partitioned(self, value: bool) -> None:
        """Model a network partition to this pod's host: wire ops fail
        without touching the socket (nothing crosses in either
        direction) and death paths skip the process kill — the worker
        keeps running, unreachable. Healing (False) restores the wire;
        whether frames are then ACCEPTED is the fence's decision."""
        if value and not self.partitioned:
            pod_metric_bump("net_partitions_injected_total")
        self.partitioned = bool(value)
        if value:
            with self._wire_mu:
                self._close_socket()

    def fenced_poll(self, timeout_s: float | None = None) -> dict:
        """The split-brain drill's heal probe: one tick round-trip
        against a FENCED pod's still-running worker (bypassing the dead
        gate), receiving whatever late events its outbox holds — and
        refusing every one of them. Nothing is acked, no handle is
        touched; the return value reports what the fenced claim WOULD
        have delivered, which the drill pins as its zero-duplicate
        proof. Raises if the pod is not fenced, PodWireError if the
        worker is unreachable."""
        if not self.fenced:
            raise RuntimeError(f"pod {self.name} is not fenced")
        with self._tick_mu:
            reply = self.call(VERB_TICK, {F_ACK: self._acked, F_N: 1},
                              timeout_s=timeout_s, _bypass_fence=True)
            late = [e for e in reply.get(F_EVENTS, ())
                    if int(e.get(F_ID, 0)) > self._acked]
            if late:
                pod_metric_bump("net_fenced_frames_total", len(late))
            return {
                "late_events": len(late),
                "late_tokens": sum(1 for e in late
                                   if e.get(F_EV) == EV_TOKEN),
                "late_done": sum(1 for e in late
                                 if e.get(F_EV) == EV_DONE),
                "refused": len(late),
            }


# ----------------------------------------------------------- fleet glue


def attach_router_death(client: PodClient, router) -> None:
    """Wire a pod's death to its Replica: flip alive under router._mu
    (by engine identity — survives renames and scaler replacements) so
    _pick and the tick loops exclude the corpse before the requeue
    callbacks start re-dispatching."""

    def on_death(c):
        with router._mu:
            for rep in router.replicas:
                if rep.engine is c and rep.alive:
                    rep.alive = False
                    router.metrics["replica_kills_total"] += 1
                    break

    client.on_death = on_death


def wire_pod_deaths(router) -> None:
    """attach_router_death over every current PodClient replica."""
    for rep in router.replicas:
        if isinstance(rep.engine, PodClient):
            attach_router_death(rep.engine, router)


def spawn_pod(name: str, spec: dict, state_dir: str, *,
              home_pool=None, policy: BackoffPolicy | None = None,
              op_timeout_s: float = 30.0, chaos=None,
              startup_timeout_s: float = 240.0,
              env_extra: dict | None = None,
              connect: bool = True,
              transport: str = "unix") -> PodClient:
    """Launch one worker subprocess and return its connected client.

    The pod env contract rides os.environ (KFTPU_TRACE_DIR /
    KFTPU_TRACEPARENT pass through untouched, so worker spans land in
    the same trace dir the controller merges) plus the pod's own
    socket/name/spec variables and a per-pod heartbeat file; stderr
    goes to `<state_dir>/<name>.stderr.log` for post-mortems.

    transport="tcp" puts the wire on 127.0.0.1 TCP: the worker binds an
    ephemeral port, publishes it through `<state_dir>/<name>.port`, and
    echoes it in the hello. Every spawn claims the next fence epoch, so
    a scaler replacement is born with a higher epoch than its victim —
    the split-brain fence's foundation.

    The spec is the reference worker's (``model``, ``pool``,
    ``max_rows``, ...) plus the port's ``device`` ("cuda" unless "cpu")
    and ``params`` (a flax-layout ``.npz`` every pod loads; without it
    each pod draws the weights from ``init_seed``). The worker runs from
    the repository root, so `state_dir` and ``params`` are made absolute
    here."""
    state_dir = os.path.abspath(state_dir)
    if spec.get("params"):
        spec = {**spec, "params": os.path.abspath(spec["params"])}
    os.makedirs(state_dir, exist_ok=True)
    spec_path = os.path.join(state_dir, f"{name}.spec.json")
    with open(spec_path, "w", encoding="utf-8") as fh:
        json.dump(spec, fh)
    sock_path = os.path.join(state_dir, f"{name}.sock")
    port_file = os.path.join(state_dir, f"{name}.port")
    for stale in (sock_path, port_file):
        try:
            os.unlink(stale)
        except OSError:
            pass
    hb_path = os.path.join(state_dir, f"{name}.hb")
    stderr_path = os.path.join(state_dir, f"{name}.stderr.log")
    env = dict(os.environ)
    env[ENV_POD_SOCKET] = sock_path
    env[ENV_POD_NAME] = name
    env[ENV_POD_SPEC] = spec_path
    env[ENV_POD_TRANSPORT] = transport
    if transport == "tcp":
        env[ENV_POD_PORT_FILE] = port_file
    env[ENV_HEARTBEAT_FILE] = hb_path
    env.update(env_extra or {})
    # the worker imports THIS tree: it starts in the repository root,
    # which also heads its import path
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (str(_REPO_ROOT), env.get("PYTHONPATH", "")) if p)
    with open(stderr_path, "ab") as errf:
        proc = subprocess.Popen(
            [sys.executable, "-m",
             "kubeflow_tpu_torch.serving.fleet.podworker"],
            env=env, cwd=_REPO_ROOT, stdin=subprocess.DEVNULL,
            stdout=errf, stderr=errf)
    pod_metric_bump("spawns_total")
    client = PodClient(name, sock_path, proc=proc,
                       heartbeat_path=hb_path, stderr_path=stderr_path,
                       policy=policy, op_timeout_s=op_timeout_s,
                       chaos=chaos, transport=transport,
                       port_file=(port_file if transport == "tcp"
                                  else None),
                       epoch=next_fence_epoch())
    client.paged_kv = home_pool
    if connect:
        try:
            client.connect(timeout_s=startup_timeout_s)
        except BaseException:
            client._quiet_dead("startup failed")
            raise
    return client
