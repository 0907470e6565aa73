"""Serving agent capabilities: request logging and adaptive
micro-batching — the port's own copy of ``kubeflow_tpu/serving/agent.py``,
with the Prometheus histogram helpers it needs.

Both are in-process features of the model server, next to the model:
concatenating concurrent requests into one forward pass pays a forward's
host work and launches once for the whole batch. The multi-model
repository API lives in server.py (/v2/repository/*).
"""

from __future__ import annotations

import json
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np


def _observe(buckets: tuple[float, ...], counts: list[int],
             value: float) -> None:
    """Record one observation into per-bucket counts (+Inf in the last
    slot). Caller owns locking."""
    for i, le in enumerate(buckets):
        if value <= le:
            counts[i] += 1
            return
    counts[-1] += 1


def _render_histogram(lines: list[str], name: str,
                      buckets: tuple[float, ...], counts: list[int],
                      total_sum: float, labels: str) -> None:
    """Exposition-format histogram lines: cumulative le buckets, _sum and
    _count. `labels` is a pre-rendered 'key="value",' prefix."""
    cum = 0
    for le, n in zip(buckets, counts):
        cum += n
        lines.append(f'{name}_bucket{{{labels}le="{le}"}} {cum}')
    cum += counts[-1]
    lines.append(f'{name}_bucket{{{labels}le="+Inf"}} {cum}')
    lines.append(f"{name}_sum{{{labels[:-1]}}} {total_sum:.6f}")
    lines.append(f"{name}_count{{{labels[:-1]}}} {cum}")


class RequestLogger:
    """JSONL request/response log + Prometheus-style counters.

    One line per request: ts, model, protocol, code, latency_ms, and
    request/response byte sizes.
    """

    def __init__(self, path: str | None = None):
        self.path = Path(path) if path else None
        self._mu = threading.Lock()
        self._fh = None
        if self.path is not None:
            self.path.parent.mkdir(parents=True, exist_ok=True)
            self._fh = open(self.path, "a", encoding="utf-8")
        # (model, protocol, code) -> count; model -> [latency_sum_s, count]
        self.requests_total: dict[tuple[str, str, int], int] = {}
        self.latency: dict[str, list[float]] = {}
        self.latency_buckets: tuple[float, ...] = (
            0.005, 0.025, 0.1, 0.25, 1.0, 2.5, 10.0)
        self.latency_hist: dict[str, list[int]] = {}

    def log(self, model: str, protocol: str, code: int, latency_s: float,
            req_bytes: int, resp_bytes: int) -> None:
        with self._mu:
            key = (model, protocol, code)
            self.requests_total[key] = self.requests_total.get(key, 0) + 1
            agg = self.latency.setdefault(model, [0.0, 0])
            agg[0] += latency_s
            agg[1] += 1
            hist = self.latency_hist.setdefault(
                model, [0] * (len(self.latency_buckets) + 1))
            _observe(self.latency_buckets, hist, latency_s)
            if self._fh is not None:
                self._fh.write(json.dumps({
                    "ts": time.time(),
                    "model": model,
                    "protocol": protocol,
                    "code": code,
                    "latency_ms": round(latency_s * 1e3, 3),
                    "request_bytes": req_bytes,
                    "response_bytes": resp_bytes,
                }) + "\n")
                self._fh.flush()

    def render_metrics(self) -> str:
        with self._mu:
            lines = ["# TYPE kfserving_requests_total counter"]
            for (model, proto, code), n in sorted(self.requests_total.items()):
                lines.append(
                    f'kfserving_requests_total{{model="{model}",'
                    f'protocol="{proto}",code="{code}"}} {n}'
                )
            lines.append("# TYPE kfserving_request_latency_seconds histogram")
            for model, (s, _) in sorted(self.latency.items()):
                _render_histogram(
                    lines, "kfserving_request_latency_seconds",
                    self.latency_buckets, self.latency_hist[model], s,
                    labels=f'model="{model}",')
            return "\n".join(lines) + "\n"

    def close(self) -> None:
        with self._mu:
            if self._fh is not None:
                self._fh.close()
                self._fh = None


@dataclass
class _Pending:
    arr: np.ndarray
    event: threading.Event = field(default_factory=threading.Event)
    result: object = None
    error: BaseException | None = None


class MicroBatcher:
    """Adaptive micro-batching around one model.

    Concurrent requests queue up; a worker flushes when either
    `max_batch_size` rows are waiting or the oldest request has waited
    `max_latency_ms` — the kserve agent batcher's knobs. Requests are
    concatenated on the leading (batch) dim, run as ONE forward pass, and
    the outputs are split back per request.
    """

    def __init__(self, model, max_batch_size: int = 32,
                 max_latency_ms: float = 5.0, timeout_s: float = 60.0):
        self.model = model
        self.max_batch_size = max_batch_size
        self.max_latency_s = max_latency_ms / 1e3
        self.timeout_s = timeout_s
        self.batches_run = 0
        self.requests_batched = 0
        self._q: deque[_Pending] = deque()
        self._cv = threading.Condition()
        self._stop = False
        self._worker = threading.Thread(
            target=self._loop, name=f"batcher-{getattr(model, 'name', '?')}",
            daemon=True,
        )
        self._worker.start()

    # --------------------------------------------------------------- client

    def __call__(self, arr: np.ndarray):
        # a 0-d input would crash the shared worker (len() of an unsized
        # object): normalize here so one bad request cannot kill it
        p = _Pending(arr=np.atleast_1d(np.asarray(arr)))
        with self._cv:
            if self._stop:
                raise RuntimeError("batcher stopped")
            self._q.append(p)
            self._cv.notify()
        if not p.event.wait(self.timeout_s):
            raise TimeoutError("batched predict timed out")
        if p.error is not None:
            raise p.error
        return p.result

    # --------------------------------------------------------------- worker

    def _loop(self) -> None:
        while True:
            with self._cv:
                while not self._q and not self._stop:
                    self._cv.wait(timeout=0.5)
                if self._stop and not self._q:
                    return  # drained: in-flight requests flushed before exit
                if not self._stop:
                    deadline = time.monotonic() + self.max_latency_s
                    while (
                        sum(len(p.arr) for p in self._q) < self.max_batch_size
                        and time.monotonic() < deadline
                    ):
                        self._cv.wait(
                            timeout=max(deadline - time.monotonic(), 0.001)
                        )
                items: list[_Pending] = []
                rows = 0
                while self._q and rows < self.max_batch_size:
                    items.append(self._q.popleft())
                    rows += len(items[-1].arr)
            try:
                self._run(items)
            except Exception:  # noqa: BLE001 — the worker must not die
                for p in items:
                    p.event.set()

    def _run(self, items: list[_Pending]) -> None:
        try:
            batch = np.concatenate([p.arr for p in items], axis=0)
            out = self.model(batch)
            offsets = np.cumsum([0] + [len(p.arr) for p in items])
            for i, p in enumerate(items):
                lo, hi = offsets[i], offsets[i + 1]
                if isinstance(out, dict):
                    p.result = {
                        k: np.asarray(v)[lo:hi] for k, v in out.items()
                    }
                else:
                    p.result = np.asarray(out)[lo:hi]
        except BaseException as exc:  # noqa: BLE001 — deliver to every waiter
            for p in items:
                p.error = exc
        finally:
            self.batches_run += 1
            self.requests_batched += len(items)
            for p in items:
                p.event.set()

    def stop(self) -> None:
        """Stop after draining: queued requests are flushed through the
        model, not abandoned to their timeouts."""
        with self._cv:
            self._stop = True
            self._cv.notify_all()
        self._worker.join(timeout=10.0)
