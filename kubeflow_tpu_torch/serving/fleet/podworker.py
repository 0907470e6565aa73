"""Pod worker — one ContinuousBatcher behind a wire socket; counterpart of
``kubeflow_tpu/serving/fleet/podworker.py``.

``python -m kubeflow_tpu_torch.serving.fleet.podworker`` is the serving
tier's real process boundary: the fleet spawns one of these per replica
(podclient.spawn_pod), each hosting its own model, paged-KV pool, and
engine, reachable only through the length-prefixed JSON protocol in
wire.py — over AF_UNIX, or TCP (KFTPU_POD_TRANSPORT=tcp: bind
127.0.0.1:0, write the kernel-chosen port atomically to
KFTPU_POD_NET_PORT_FILE, and echo it back through the hello so the dial
side can cross-check discovery). The worker is deliberately
SINGLE-THREADED — one connection, one verb at a time, engine ticks driven
by the client's `tick` verb — so the process owns no locks and a SIGKILL
can never leave a half-updated shared structure behind; all
cross-request state the router needs to survive a kill lives on the
CLIENT side (the router's token record), which is exactly the zero-drop
contract. One engine a process also gives each engine an interpreter
lock of its own.

The model runs on the card: the spec's ``"device"`` is ``"cuda"`` unless
it says ``"cpu"``, and a worker asked for the card on a machine without
one fails at startup (it never carries on on the CPU). Its weights come
from the spec's ``"params"`` (a flax-layout ``.npz``, as a model dir's
``params.npz``), or else from ``init_seed`` through a CPU
``torch.Generator`` — either way every pod of a fleet holds the same
weights on any device. A spec's ``"compile_cache_dir"`` holds the kernel
libraries: the worker builds what is missing there and loads them from
it, so a respawned pod runs nvcc zero times; its ready line on stderr
carries ``compile_counts`` (utils/compile_cache.py).

Env contract (utils/envvars.py): KFTPU_POD_SOCKET (bind path),
KFTPU_POD_NAME (trace service / heartbeat identity), KFTPU_POD_SPEC
(JSON engine spec), plus the pod contract — KFTPU_TRACE_DIR /
KFTPU_TRACEPARENT ride through tracing.init_worker_from_env (the worker
flushes its spans every tick, with the kernels' launch counts beside
them as ``pod.kernel_launches`` events), and KFTPU_HEARTBEAT_FILE arms
the per-tick liveness beat the scaler's hang watch consumes (SIGSTOP =
alive-but-silent, detectable only by heartbeat age).

Delivery reliability: every token/done event enters a monotonic-id
OUTBOX and is re-sent on every tick reply until the client's cumulative
ack prunes it — a torn frame or connection reset loses no tokens, it
just redelivers (the client dedups by event id). Submits are idempotent
by request id for the same reason. Backpressure is HTTP-shaped: a full
queue answers 503 with retry_after_s, an expired propagated deadline
answers 504 — the client's retry policy (utils/retry) honors both.

Epoch fencing: every envelope carries the sender's fence epoch. A hello
with a HIGHER epoch adopts it (a replacement taking over the replica
identity); any frame with a LOWER epoch than the adopted one answers 410
— a partitioned client that resurfaces after its replacement attached
can neither submit nor tick, so a partition heal can never produce two
replicas serving the same rid. The client fences itself on the first 410
and refuses the worker's late acks/tokens (podclient.py).
"""

from __future__ import annotations

import json
import os
import socket
import sys
import time

from kubeflow_tpu_torch.serving.fleet.wire import (
    CODE_BAD_REQUEST,
    CODE_BUSY,
    CODE_CONFLICT,
    CODE_DEADLINE,
    CODE_FENCED,
    CODE_INTERNAL,
    EV_DONE,
    EV_TOKEN,
    F_ACK,
    F_CHAIN,
    F_DEADLINE_S,
    F_DYING,
    F_EOS,
    F_EPOCH,
    F_ERROR,
    F_EV,
    F_ID,
    F_KEEP_CHAIN,
    F_MAX_NEW_TOKENS,
    F_N,
    F_PROMPT,
    F_RESUME,
    F_RESUMED,
    F_RID,
    F_SEQ,
    F_TEMPERATURE,
    F_TOK,
    F_TOKENS,
    F_VERB,
    PodWireError,
    error_reply,
    ok_reply,
    recv_frame,
    send_frame,
    serialize_chain,
)
from kubeflow_tpu_torch.utils.envvars import (
    ENV_POD_NAME,
    ENV_POD_PORT_FILE,
    ENV_POD_SOCKET,
    ENV_POD_SPEC,
    ENV_POD_TRANSPORT,
)


class PodServer:
    """The worker-side protocol state machine around one engine."""

    def __init__(self, name: str, spec: dict, tracer=None):
        self.name = name
        self.spec = spec
        self.tracer = tracer
        self._events: list[dict] = []        # outbox, pruned by acks
        self._next_event_id = 1
        self._seen_rids: set[str] = set()    # submit idempotency
        self._dying: str | None = None       # poisoned-engine reason
        self._epoch = 0                      # adopted fence epoch
        self._port: int | None = None        # bound TCP port (tcp only)
        self.engine, self.pool = self._build_engine()
        from kubeflow_tpu_torch.health import HeartbeatWriter

        self.hb = HeartbeatWriter.from_env()
        self._warmup()
        # the kernels' launches are counted from here: what the warmup
        # launched is not the serve phase's
        self._launch_base = self._launch_counts()
        self._launches_seen: dict[str, int] | None = None

    # ------------------------------------------------------------ build

    def _build_engine(self):
        import numpy as np
        import torch

        from kubeflow_tpu_torch.convert import gpt_params_from_flax
        from kubeflow_tpu_torch.models.gpt import GPTConfig, GPTLM
        from kubeflow_tpu_torch.serving.continuous import ContinuousBatcher
        from kubeflow_tpu_torch.serving.fleet.pagedkv import PagedKVPool

        spec = self.spec
        device = torch.device(spec.get("device", "cuda"))
        if spec.get("compile_cache_dir") and device.type == "cuda":
            # every pod of a fleet runs the same kernels: build them into
            # the spec's dir once and load them from it, so a respawned pod
            # runs nvcc zero times (on the CPU the plain versions run and
            # there is nothing to build)
            from kubeflow_tpu_torch.kernels.build import load_all

            load_all(spec["compile_cache_dir"])
        # a spec key of the reference worker the port cannot honour yet
        if int(spec.get("chaos_decode_repeats", 1)) > 1:
            raise NotImplementedError(
                "pod spec 'chaos_decode_repeats' > 1: the cpu-proxy "
                "gate's decode chaos is ported with the harness (ROADMAP "
                "Queue A item 11)")
        cfg = GPTConfig(**spec["model"])
        model = GPTLM(cfg, device=device)
        if spec.get("params"):
            # the fleet's weights from one file: every pod and the
            # spawner's own reference path hold the same parameters
            with np.load(spec["params"]) as z:
                flat = {k: z[k] for k in z.files}
            model.load_state_dict(gpt_params_from_flax(flat, cfg))
        else:
            # deterministic weights from the spec's init seed, drawn on
            # the CPU and copied to the device: the same on any device
            model.init_weights(torch.Generator().manual_seed(
                int(spec.get("init_seed", 0))))
        model.eval()
        pool_spec = spec.get("pool") or {}
        pool = PagedKVPool(
            block_size=int(pool_spec.get("block_size", 8)),
            capacity_blocks=int(pool_spec.get("capacity_blocks", 1024)))
        eng = ContinuousBatcher(
            model,
            max_rows=int(spec.get("max_rows", 4)),
            default_max_new_tokens=int(
                spec.get("default_max_new_tokens", 32)),
            eos_token_id=spec.get("eos_token_id"),
            seed=int(spec.get("seed", 0)),
            prefill_chunk=int(spec.get("prefill_chunk", 0)),
            paged_kv=pool,
            block_budget=bool(spec.get("block_budget", False)),
            max_chunks_per_tick=int(spec.get("max_chunks_per_tick", 1)),
            tracer=(self.tracer
                    if getattr(self.tracer, "enabled", False) else None),
        )
        return eng, pool

    def _warmup(self) -> None:
        """Run every dispatch shape the serve phase takes BEFORE the
        socket goes live: the first call of each pays for the device's
        one-time setup (library loads, allocator growth), not a request."""
        import numpy as np

        prompts = self.spec.get("warmup_prompts") or []
        new_toks = int(self.spec.get("warmup_new_tokens", 2))
        repeats = int(self.spec.get("warmup_repeats", 2))
        for prompt in prompts:
            ids = np.asarray(prompt, np.int32)
            for _ in range(max(repeats, 1)):
                self.engine.submit(ids, max_new_tokens=new_toks)
                self.engine.run_until_idle()
        if self.spec.get("warmup_resume") and prompts:
            # the decode-leg shapes: keep_chain retire (chain-append
            # extraction window) and the resume-admission splice
            ids = np.asarray(prompts[0], np.int32)
            req = self.engine.submit(ids, max_new_tokens=new_toks,
                                     keep_chain=True)
            self.engine.run_until_idle()
            chain = getattr(req, "chain", None)
            if chain is not None and not chain.frozen:
                keep = int(chain.length) - int(ids.size) + 1
                if 0 < keep <= len(req.tokens) and keep < new_toks:
                    req.chain = None
                    self.engine.submit(
                        ids, max_new_tokens=new_toks,
                        resume_from=(chain, [int(t) for t
                                             in req.tokens[:keep]]))
                    self.engine.run_until_idle()
                else:
                    chain.release()
                    req.chain = None

    @staticmethod
    def _launch_counts() -> dict[str, int]:
        from kubeflow_tpu_torch.kernels import KERNELS

        return {n: k.launches for n, k in KERNELS.items()}

    def _trace_launches(self) -> None:
        """Record this process's kernel launches since serving began as a
        ``pod.kernel_launches`` event whenever they changed: the span file
        then shows which kernels ran inside the pod, beside the engine's
        prefill spans."""
        counts = {n: c - self._launch_base.get(n, 0)
                  for n, c in self._launch_counts().items()}
        if counts != self._launches_seen:
            self._launches_seen = counts
            self.tracer.event("pod.kernel_launches", **counts)

    def _flush_trace(self) -> None:
        if self.tracer is not None and getattr(self.tracer, "enabled",
                                               False):
            from kubeflow_tpu_torch.tracing.core import flush

            self._trace_launches()
            # idempotent per-pid file: a SIGKILL between flushes loses
            # at most one tick batch of spans, never the file
            flush(self.tracer)

    # ----------------------------------------------------------- events

    def _emit(self, ev: dict) -> None:
        ev[F_ID] = self._next_event_id
        self._next_event_id += 1
        self._events.append(ev)

    def _on_token(self, req, tok: int) -> None:
        self._emit({F_EV: EV_TOKEN, F_RID: req.request_id,
                    F_TOK: int(tok)})

    def _on_done(self, req) -> None:
        ev = {
            F_EV: EV_DONE,
            F_RID: req.request_id,
            F_ERROR: req.error,
            F_TOKENS: [int(t) for t in req.tokens],
            F_RESUMED: bool(req.resumed),
            "ttft_s": req.ttft_s,
            "tps": req.tokens_per_s,
            F_CHAIN: None,
        }
        chain = getattr(req, "chain", None)
        if chain is not None and chain.refs and not chain.frozen:
            # keep_chain retire: the finished chain crosses the wire as
            # serialized blocks; the local refs release immediately —
            # the payload carries everything the adopter needs
            ev[F_CHAIN] = serialize_chain(self.pool, chain.refs)
        if chain is not None:
            chain.release()
            req.chain = None
        self._emit(ev)

    # ------------------------------------------------------------ verbs

    def handle(self, env: dict) -> dict:
        seq = int(env.get(F_SEQ, 0))
        verb = env.get(F_VERB, "")
        deadline_s = env.get(F_DEADLINE_S)
        if deadline_s is not None and float(deadline_s) <= 0.0:
            return error_reply(seq, CODE_DEADLINE,
                               f"deadline expired before {verb!r}")
        # fence gate: stale epochs are refused on EVERY verb — a
        # presumed-dead client resurfacing after its replacement adopted
        # a higher epoch can neither submit nor tick (410, terminal on
        # the client side). A hello with a higher epoch is the adoption
        # itself (done in _verb_hello so its echo carries the result).
        env_epoch = int(env.get(F_EPOCH, 0))
        if env_epoch < self._epoch:
            return error_reply(
                seq, CODE_FENCED,
                f"stale epoch {env_epoch} < {self._epoch}: "
                f"{verb!r} refused (fenced)")
        fn = getattr(self, f"_verb_{verb}", None)
        if fn is None:
            return error_reply(seq, CODE_BAD_REQUEST,
                               f"unknown verb {verb!r}")
        try:
            return fn(seq, env)
        except Exception as e:  # noqa: BLE001 — protocol boundary
            return error_reply(seq, CODE_INTERNAL,
                               f"{type(e).__name__}: {e}")

    def _verb_hello(self, seq: int, env: dict) -> dict:
        eng = self.engine
        # epoch adoption: handle() already refused anything stale, so
        # this hello is the newest claimant — adopt its epoch and echo
        # it (with the bound TCP port) so the dial side can cross-check
        # discovery against what the worker actually serves
        env_epoch = int(env.get(F_EPOCH, 0))
        if env_epoch > self._epoch:
            # a STRICTLY newer claim starts from a clean slate: the
            # superseded claim's undelivered events and rid-dedup
            # entries must never leak into the successor's streams (a
            # same-epoch hello is a reconnect of the same claim, where
            # redelivery IS the replay contract — keep everything)
            self._events.clear()
            self._seen_rids.clear()
        self._epoch = max(self._epoch, env_epoch)
        return ok_reply(
            seq, name=self.name, pid=os.getpid(),
            default_max_new_tokens=eng.default_max_new_tokens,
            eos_token_id=(list(eng.eos_token_id)
                          if eng.eos_token_id else None),
            block_size=self.pool.block_size,
            epoch=self._epoch, port=self._port)

    def _depth(self) -> int:
        eng = self.engine
        return (len(eng._queue)
                + sum(1 for r in eng._rows if r is not None))

    def _verb_submit(self, seq: int, env: dict) -> dict:
        import numpy as np

        from kubeflow_tpu_torch.serving.fleet.wire import deserialize_chain

        if self._dying is not None:
            return error_reply(seq, CODE_INTERNAL,
                               f"engine poisoned: {self._dying}")
        rid = str(env.get(F_RID, ""))
        if rid and rid in self._seen_rids:
            # redelivery after a torn ack: the original submit landed
            return ok_reply(seq, dup=True, depth=self._depth())
        max_queue = int(self.spec.get("max_queue", 0))
        if max_queue and len(self.engine._queue) >= max_queue:
            return error_reply(seq, CODE_BUSY, "queue full",
                               retry_after_s=0.05)
        resume = None
        if env.get(F_RESUME) is not None:
            chain = deserialize_chain(self.pool, env[F_RESUME][F_CHAIN])
            if chain.frozen:
                # the receiving pool could not cover every position
                # (covered-by-sibling) — refuse rather than resume on
                # silently wrong K/V; the client falls back to scratch
                chain.release()
                return error_reply(
                    seq, CODE_CONFLICT, "resume chain frozen on re-insert")
            resume = (chain, [int(t) for t in env[F_RESUME][F_TOKENS]])
        req = self.engine.submit(
            np.asarray(env[F_PROMPT], np.int32),
            max_new_tokens=env.get(F_MAX_NEW_TOKENS),
            eos_token_id=env.get(F_EOS),
            temperature=float(env.get(F_TEMPERATURE, 0.0)),
            on_token=self._on_token,
            on_done=self._on_done,
            request_id=rid,
            keep_chain=bool(env.get(F_KEEP_CHAIN, False)),
            resume_from=resume)
        # request_id normally only sticks under an armed tracer; the
        # event stream is keyed by it, so pin it unconditionally
        req.request_id = rid
        if rid:
            self._seen_rids.add(rid)
        return ok_reply(seq, depth=self._depth())

    def _verb_tick(self, seq: int, env: dict) -> dict:
        ack = int(env.get(F_ACK, 0))
        if ack:
            self._events = [e for e in self._events if e[F_ID] > ack]
        busy = False
        n = max(int(env.get(F_N, 1)), 1)
        if self._dying is None:
            try:
                for _ in range(n):
                    busy = self.engine.tick()
                    if not busy:
                        break
            except Exception as e:  # noqa: BLE001 — poisoned engine
                self._dying = f"{type(e).__name__}: {e}"
                self.engine._fail_all(
                    f"worker tick failed: {self._dying}")
                busy = False
        if self.hb is not None:
            self.hb.beat(step=self.engine.step_count, phase="serve")
        self._flush_trace()
        eng = self.engine
        return ok_reply(
            seq, events=list(self._events), busy=busy,
            depth=self._depth(), step_count=eng.step_count,
            prefill_tokens_total=eng.prefill_tokens_total,
            prefill_tokens_reused=eng.prefill_tokens_reused,
            tick_error=self._dying)

    def _verb_drain(self, seq: int, env: dict) -> dict:
        return ok_reply(seq, depth=self._depth())

    def _verb_heartbeat(self, seq: int, env: dict) -> dict:
        if self.hb is not None:
            self.hb.beat(step=self.engine.step_count, phase="serve")
        return ok_reply(seq, pid=os.getpid())

    def _verb_kill(self, seq: int, env: dict) -> dict:
        return ok_reply(seq, dying=True)

    # ------------------------------------------------------------ serve

    def serve(self, sock_path: str, transport: str = "unix",
              port_file: str | None = None) -> None:
        if transport == "tcp":
            # bind loopback on a kernel-chosen port and publish it
            # ATOMICALLY (write-then-rename) — the dial side polls the
            # port file the way it polls the AF_UNIX socket path, and a
            # torn partial write must never read as a port
            srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            srv.bind(("127.0.0.1", 0))
            self._port = int(srv.getsockname()[1])
            if port_file:
                tmp = f"{port_file}.{os.getpid()}.tmp"
                with open(tmp, "w", encoding="utf-8") as fh:
                    fh.write(str(self._port))
                os.replace(tmp, port_file)
        else:
            try:
                os.unlink(sock_path)
            except OSError:
                pass
            srv = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
            srv.bind(sock_path)
        srv.listen(1)
        if self.hb is not None:
            self.hb.beat(step=0, phase="serve")
        while True:
            conn, _addr = srv.accept()
            try:
                self._serve_conn(conn)
            except (PodWireError, OSError):
                pass  # client went away: re-accept (the client redials)
            finally:
                try:
                    conn.close()
                except OSError:
                    pass

    def _serve_conn(self, conn: socket.socket) -> None:
        while True:
            env = recv_frame(conn)
            reply = self.handle(env)
            send_frame(conn, reply)
            if reply.get(F_DYING):
                self._flush_trace()
                conn.close()
                os._exit(0)


def _arm_orphan_watchdog() -> None:
    """A pod must never outlive its spawner. The client process owns the
    lifecycle, but a SIGKILLed spawner (a timed-out run, an OOM kill)
    runs no teardown — without this, the worker parks on accept() and
    holds its device memory forever. PR_SET_PDEATHSIG asks the kernel to
    SIGKILL this process the moment the spawning thread exits;
    Linux-only, best-effort."""
    if sys.platform != "linux":
        return
    try:
        import ctypes
        import signal as _signal

        libc = ctypes.CDLL(None, use_errno=True)
        libc.prctl(1, _signal.SIGKILL, 0, 0, 0)  # 1 = PR_SET_PDEATHSIG
    except (OSError, AttributeError, TypeError):
        return
    # close the arming race: the parent may have died between fork and
    # prctl, in which case we are already reparented and no signal comes
    if os.getppid() == 1:
        os._exit(0)


def main() -> int:
    _arm_orphan_watchdog()
    name = os.environ.get(ENV_POD_NAME, "pod")
    transport = os.environ.get(ENV_POD_TRANSPORT, "unix")
    sock_path = os.environ.get(ENV_POD_SOCKET, "")
    port_file = os.environ.get(ENV_POD_PORT_FILE) or None
    if transport != "tcp" and not sock_path:
        raise KeyError(ENV_POD_SOCKET)
    with open(os.environ[ENV_POD_SPEC], encoding="utf-8") as fh:
        spec = json.load(fh)
    from kubeflow_tpu_torch.tracing.core import init_worker_from_env

    tracer = init_worker_from_env(service=name)
    t0 = time.perf_counter()
    server = PodServer(name, spec, tracer=tracer)
    from kubeflow_tpu_torch.utils.compile_cache import compile_counts

    print(f"[podworker {name}] ready in {time.perf_counter() - t0:.2f}s "
          f"pid={os.getpid()} device={server.engine.device} "
          f"compile_counts={json.dumps(compile_counts())}",
          file=sys.stderr, flush=True)
    server.serve(sock_path, transport=transport, port_file=port_file)
    return 0


if __name__ == "__main__":
    sys.exit(main())
