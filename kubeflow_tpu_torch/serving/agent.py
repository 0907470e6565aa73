"""Request logging for the model server — the port's own copy of
``RequestLogger`` from ``kubeflow_tpu/serving/agent.py``, with the
Prometheus histogram helpers it needs. Micro-batching waits for a later
slice.
"""

from __future__ import annotations

import json
import threading
import time
from pathlib import Path


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
