"""Liveness and checkpoint-integrity contract — own copy of the parts of
``kubeflow_tpu/health.py`` a port trainer speaks.

A port worker is judged by the platform exactly as a JAX worker is: it
beats the heartbeat file the pod env names (``KFTPU_HEARTBEAT_FILE``), and
its checkpoint steps carry the same integrity manifest
(``kftpu-manifest.json``), whose verification outcomes count into the
``ckpt_verify_*`` registry. ``read_heartbeat`` is the reader side a pod
client's heartbeat age comes from.
"""

from __future__ import annotations

import json
import os
import random
import threading
import time
from dataclasses import dataclass

from kubeflow_tpu_torch.utils.envvars import (
    ENV_HEARTBEAT_DROP,
    ENV_HEARTBEAT_FILE,
)

#: filename of the per-step integrity manifest train/checkpoint.py writes
#: inside each committed checkpoint step directory
CKPT_MANIFEST_NAME = "kftpu-manifest.json"


@dataclass(frozen=True)
class Heartbeat:
    """One liveness sample: the newest progress a worker claims."""

    step: int
    phase: str
    ts: float
    pid: int


def read_heartbeat(path: str) -> Heartbeat | None:
    """Parse a heartbeat file; None when missing/partial (a torn write is
    indistinguishable from no write — the atomic-rename writer makes torn
    reads impossible in practice, but a corrupt file must not crash the
    reader)."""
    try:
        with open(path, "r", encoding="utf-8") as fh:
            raw = json.load(fh)
        return Heartbeat(
            step=int(raw["step"]), phase=str(raw.get("phase", "")),
            ts=float(raw["ts"]), pid=int(raw.get("pid", 0)),
        )
    except (OSError, ValueError, KeyError, TypeError):
        return None


class HeartbeatWriter:
    """Atomic heartbeat emitter for one worker incarnation.

    Every beat() rewrites the file via tmp + os.replace, so readers always
    see a complete JSON document. Beats inside `min_interval_s` of the last
    write are throttled regardless of content — a fast training loop must
    not turn liveness into per-step fsync traffic.
    """

    def __init__(self, path: str, min_interval_s: float = 0.05):
        self.path = path
        self.min_interval_s = min_interval_s
        self._last_ts = 0.0
        self.written = 0
        self.dropped = 0
        self._drop_rng: random.Random | None = None
        self._drop_rate = 0.0
        self._drop_budget = 0
        try:  # once, not per beat; re-attempted in beat() if racing cleanup
            os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        except OSError:
            pass

    @classmethod
    def from_env(cls) -> "HeartbeatWriter | None":
        """Writer per the pod env contract; None when the pod carries no
        heartbeat path (standalone runs). KFTPU_HB_DROP ("rate:seed:count")
        arms deterministic chaos drops for subprocess workers."""
        path = os.environ.get(ENV_HEARTBEAT_FILE, "")
        if not path:
            return None
        w = cls(path)
        drop = os.environ.get(ENV_HEARTBEAT_DROP, "")
        if drop:
            try:
                rate, seed, count = drop.split(":")
                w._drop_rate = float(rate)
                w._drop_rng = random.Random(int(seed))
                w._drop_budget = int(count)
            except ValueError:
                pass  # malformed chaos carrier: drops simply stay unarmed
        return w

    def _dropped_by_chaos(self) -> bool:
        if (
            self._drop_rng is not None
            and self._drop_budget > 0
            and self._drop_rng.random() < self._drop_rate
        ):
            self._drop_budget -= 1
            return True
        return False

    def beat(self, step: int = -1, phase: str = "train") -> bool:
        """Record liveness; returns True when a write actually landed."""
        now = time.time()
        if now - self._last_ts < self.min_interval_s:
            return False
        if self._dropped_by_chaos():
            self.dropped += 1
            return False
        payload = json.dumps(
            {"step": step, "phase": phase, "ts": now, "pid": os.getpid()}
        )
        tmp = f"{self.path}.tmp.{os.getpid()}"
        try:
            try:
                with open(tmp, "w", encoding="utf-8") as fh:
                    fh.write(payload)
            except FileNotFoundError:  # parent dir raced away post-__init__
                os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
                with open(tmp, "w", encoding="utf-8") as fh:
                    fh.write(payload)
            os.replace(tmp, self.path)
        except OSError:
            return False  # liveness reporting must never kill the worker
        self._last_ts = now
        self.written += 1
        return True


# --------------------------------------------------- checkpoint verification

_CKPT_MU = threading.Lock()
_CKPT_VERIFY_METRICS: dict[str, int] = {
    "manifests_written_total": 0,
    "steps_verified_total": 0,
    "steps_corrupt_total": 0,
    "steps_quarantined_total": 0,
    "fallback_restores_total": 0,
    "unverified_restores_total": 0,
}


def ckpt_verify_bump(name: str, n: int = 1) -> None:
    with _CKPT_MU:
        _CKPT_VERIFY_METRICS[name] = _CKPT_VERIFY_METRICS.get(name, 0) + n


def ckpt_verify_snapshot() -> dict[str, int]:
    with _CKPT_MU:
        return dict(_CKPT_VERIFY_METRICS)


def reset_ckpt_verify_metrics() -> None:
    """Test hook: the registry is process-global."""
    with _CKPT_MU:
        for k in _CKPT_VERIFY_METRICS:
            _CKPT_VERIFY_METRICS[k] = 0
