"""Metrics emission in the sweep-collector contract — own copy of
``kubeflow_tpu/train/metrics.py``.

Trainers print ``name=value`` lines (Katib's stdout collector contract), so
the platform's sweep engine and any log scraper collect objectives from a
port trainer exactly as from a JAX one.
"""

from __future__ import annotations

import re
import sys
import time

# The collector's parse regex: `<name>=<float>` tokens on a line.
METRIC_RE = re.compile(
    r"([A-Za-z_][A-Za-z0-9_./-]*)=(-?\d+(?:\.\d+)?(?:[eE][+-]?\d+)?)"
)


def emit(step: int | None = None, file=None, **metrics: float) -> str:
    """Print one metrics line: `step=3 loss=0.123 accuracy=0.98`."""
    parts = []
    if step is not None:
        parts.append(f"step={step}")
    for k, v in metrics.items():
        parts.append(f"{k}={float(v):.6g}")
    line = " ".join(parts)
    print(line, file=file or sys.stdout, flush=True)
    return line


def parse_line(line: str) -> dict[str, float]:
    """Collector side: extract all name=value pairs from one log line."""
    return {m.group(1): float(m.group(2)) for m in METRIC_RE.finditer(line)}


def extract_final_metrics(log_text: str) -> dict[str, float]:
    """final_* scalars from a worker log (the train() helpers' contract)."""
    final: dict[str, float] = {}
    for line in log_text.splitlines():
        final.update(
            {k: v for k, v in parse_line(line).items() if k.startswith("final_")}
        )
    return final


class TfEventsWriter:
    """Scalar tfevents emission for TensorBoard, through tensorboard's own
    writer (imported when a writer is made, never with this module)."""

    def __init__(self, logdir: str):
        from tensorboard.summary.writer.event_file_writer import EventFileWriter

        self._writer = EventFileWriter(logdir)
        self.logdir = logdir

    def scalars(self, step: int, **metrics: float) -> None:
        from tensorboard.compat.proto.event_pb2 import Event
        from tensorboard.compat.proto.summary_pb2 import Summary

        summary = Summary(
            value=[
                Summary.Value(tag=k, simple_value=float(v))
                for k, v in metrics.items()
            ]
        )
        self._writer.add_event(
            Event(step=step, wall_time=time.time(), summary=summary)
        )

    def flush(self) -> None:
        self._writer.flush()

    def close(self) -> None:
        self._writer.close()


class Timer:
    """Wall-clock throughput meter (images/sec, steps/sec)."""

    def __init__(self) -> None:
        self.reset()

    def reset(self) -> None:
        self._t0 = time.perf_counter()
        self._items = 0
        self._steps = 0

    def tick(self, items: int = 0, steps: int = 1) -> None:
        self._items += items
        self._steps += steps

    @property
    def elapsed(self) -> float:
        return time.perf_counter() - self._t0

    @property
    def items_per_sec(self) -> float:
        return self._items / max(self.elapsed, 1e-9)

    @property
    def steps_per_sec(self) -> float:
        return self._steps / max(self.elapsed, 1e-9)
