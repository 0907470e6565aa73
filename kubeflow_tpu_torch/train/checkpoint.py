"""Checkpoint/resume contract with integrity verification — counterpart of
``kubeflow_tpu/train/checkpoint.py``.

Each committed step is a directory ``<dir>/<step>/`` holding the state
(``torch.save`` of its ``state_dict()``), its eval metrics when given, and
a content-checksum manifest (``kftpu-manifest.json``, the JAX package's
format). A step is written under a temporary name and renamed into place,
so a torn save never becomes visible; the manifest then guards against a
committed step whose bytes later rot. ``restore_latest`` verifies the newest
step, quarantines a corrupt one out of the tree (moved, never deleted: the
bytes are evidence) and falls back to the previous verified step. Outcomes
count into ``kubeflow_tpu_torch.health``'s ``ckpt_verify_*`` registry.

Retention follows orbax's CheckpointManager as the JAX package configures
it: the ``max_to_keep`` newest steps, or with ``keep_best_metric`` the
``max_to_keep`` best by that metric plus every metric-less (rescue) step;
a save at or below the newest step is skipped. Saves are synchronous.
In a gang every member calls ``save`` (a sharded state gathers its full
tensors then) and rank 0 writes; every member restores from the files.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading
import time
from typing import Any

import torch

from kubeflow_tpu_torch.health import CKPT_MANIFEST_NAME, ckpt_verify_bump

STATE_FILE = "state.pt"
METRICS_FILE = "metrics.json"


class Checkpointer:
    """Per-step torch checkpoints of any object with ``state_dict()`` and
    ``load_state_dict()`` (the Trainer's TrainState, a module)."""

    def __init__(self, directory: str, max_to_keep: int = 3,
                 keep_best_metric: str | None = None,
                 best_mode: str = "max"):
        """keep_best_metric: retain the max_to_keep BEST checkpoints by this
        eval-metric key (passed via save(metrics=...)) instead of the newest
        — the model-selection contract (restore_best serves the winner)."""
        if best_mode not in ("max", "min"):
            raise ValueError(f"best_mode {best_mode!r} is not max|min")
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        self.keep_best_metric = keep_best_metric
        self.best_mode = best_mode
        self._mu = threading.Lock()
        os.makedirs(self.directory, exist_ok=True)

    # --------------------------------------------------------------- steps

    def all_steps(self) -> list[int]:
        """Committed steps, from the directory: a step is committed by an
        atomic rename to its bare number, so a numeric dir IS complete."""
        try:
            return sorted(
                int(n) for n in os.listdir(self.directory)
                if n.isdigit()
                and os.path.isdir(os.path.join(self.directory, n)))
        except OSError:
            return []

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def _metrics(self, step: int) -> dict | None:
        try:
            with open(os.path.join(self._step_dir(step), METRICS_FILE),
                      encoding="utf-8") as fh:
                return json.load(fh)
        except (OSError, ValueError):
            return None

    def _ranked(self) -> list[int]:
        """Steps with metrics, worst first (best last)."""
        key = self.keep_best_metric
        scored = [(float(m[key]), s) for s in self.all_steps()
                  if (m := self._metrics(s)) is not None and key in m]
        scored.sort(reverse=self.best_mode == "min")
        return [s for _, s in scored]

    def best_step(self) -> int | None:
        """The best step by keep_best_metric; without best tracking, the
        newest (orbax's behaviour)."""
        if not self.keep_best_metric:
            return self.latest_step()
        ranked = self._ranked()
        return ranked[-1] if ranked else None

    # ---------------------------------------------------------------- save

    def save(self, step: int, state: Any,
             metrics: dict | None = None) -> bool:
        """Commit ``state.state_dict()`` as ``step``. metrics participate in
        best-ranking (keep_best_metric mode); metric-LESS saves are kept
        outside the ranking (rescue/resume saves) and never become
        best_step. Returns False when the step was skipped (at or below the
        newest committed step)."""
        if (metrics is not None and self.keep_best_metric
                and self.keep_best_metric not in metrics):
            raise ValueError(
                f"keep_best_metric {self.keep_best_metric!r} not in metrics "
                f"{sorted(metrics)} — fix TrainerConfig.keep_best_metric"
            )
        rank = _gang_rank()
        if rank is not None:
            _barrier()  # every member reads the same newest step
        latest = self.latest_step()
        if latest is not None and step <= latest:
            return False
        payload = state.state_dict()  # a sharded state gathers here
        if rank:
            _barrier()  # rank 0 writes; the step is committed after this
            return True
        tmp = os.path.join(self.directory, f".tmp-{step}-{os.getpid()}")
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        torch.save(payload, os.path.join(tmp, STATE_FILE))
        if metrics is not None:
            with open(os.path.join(tmp, METRICS_FILE), "w",
                      encoding="utf-8") as fh:
                json.dump({k: float(v) for k, v in metrics.items()}, fh)
        os.replace(tmp, self._step_dir(step))
        with self._mu:
            self._write_manifest(step)
            self._collect_garbage()
        if rank is not None:
            _barrier()
        return True

    def _collect_garbage(self) -> None:
        if self.max_to_keep is None:
            return
        if self.keep_best_metric:
            drop = self._ranked()[:-self.max_to_keep or None]
        else:
            drop = self.all_steps()[:-self.max_to_keep or None]
        for step in drop:
            shutil.rmtree(self._step_dir(step), ignore_errors=True)

    # ------------------------------------------------------------- restore

    def _load(self, step: int, state: Any) -> Any:
        payload = torch.load(os.path.join(self._step_dir(step), STATE_FILE),
                             map_location="cpu", weights_only=True)
        state.load_state_dict(payload)
        return state

    def restore_best(self, state: Any) -> tuple[int, Any] | None:
        """Restore the best-metric checkpoint into ``state``.

        Verification applies but fallback does not: "second-best" is not a
        meaningful stand-in for a corrupt best — the step is quarantined and
        None returned so the caller decides."""
        if not self.keep_best_metric:
            raise ValueError(
                "restore_best requires a Checkpointer constructed with "
                "keep_best_metric (the mode is not persisted in the "
                "checkpoint directory)"
            )
        step = self.best_step()
        if step is None:
            return None
        verdict = self._verify_step(step)
        if verdict is False:
            self._quarantine(step)
            return None
        ckpt_verify_bump("steps_verified_total" if verdict
                         else "unverified_restores_total")
        return step, self._load(step, state)

    def restore_latest(self, state: Any) -> tuple[int, Any] | None:
        """Restore the newest VERIFIED checkpoint into ``state``. A newest
        step that fails its manifest is quarantined and the next-newest
        verified step served instead, so a corrupt save can cost at most
        one checkpoint interval, never the whole run. None if empty."""
        steps = self.all_steps()
        fell_back = False
        while steps:
            step = steps.pop()
            verdict = self._verify_step(step)
            if verdict is False:
                # skipped even when the move fails: flipped bytes are never
                # served
                self._quarantine(step)
                fell_back = True
                continue
            ckpt_verify_bump("steps_verified_total" if verdict
                             else "unverified_restores_total")
            if fell_back:
                ckpt_verify_bump("fallback_restores_total")
            return step, self._load(step, state)
        return None

    # ----------------------------------------------------------- integrity

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.directory, str(step))

    def _step_files(self, step: int) -> list[str]:
        """Relative paths of one committed step's payload files (manifest
        and tmp files excluded), sorted for a stable manifest."""
        root = self._step_dir(step)
        out: list[str] = []
        for dirpath, _dirnames, filenames in os.walk(root):
            for name in filenames:
                if name == CKPT_MANIFEST_NAME or name.endswith(".tmp"):
                    continue
                out.append(os.path.relpath(os.path.join(dirpath, name), root))
        return sorted(out)

    def _write_manifest(self, step: int) -> None:
        root = self._step_dir(step)
        manifest = os.path.join(root, CKPT_MANIFEST_NAME)
        files = {}
        for rel in self._step_files(step):
            path = os.path.join(root, rel)
            files[rel] = {"sha256": _sha256(path),
                          "size": os.path.getsize(path)}
        tmp = manifest + ".tmp"
        with open(tmp, "w", encoding="utf-8") as fh:
            json.dump({"step": step, "files": files,
                       "created": time.time()}, fh)
        os.replace(tmp, manifest)
        ckpt_verify_bump("manifests_written_total")

    def _verify_step(self, step: int) -> bool | None:
        """True = checksums match, False = corrupt, None = no manifest."""
        root = self._step_dir(step)
        manifest = os.path.join(root, CKPT_MANIFEST_NAME)
        try:
            with open(manifest, "r", encoding="utf-8") as fh:
                want = json.load(fh)["files"]
        except (OSError, ValueError, KeyError):
            if not os.path.exists(manifest):
                return None
            ckpt_verify_bump("steps_corrupt_total")
            return False  # unreadable manifest IS corruption
        if set(want) - set(self._step_files(step)):  # missing payload files
            ckpt_verify_bump("steps_corrupt_total")
            return False
        for rel, meta in want.items():
            path = os.path.join(root, rel)
            try:
                if (os.path.getsize(path) != meta["size"]
                        or _sha256(path) != meta["sha256"]):
                    ckpt_verify_bump("steps_corrupt_total")
                    return False
            except OSError:
                ckpt_verify_bump("steps_corrupt_total")
                return False
        return True

    def _quarantine(self, step: int) -> bool:
        """Move a corrupt step out of the checkpoint tree (never delete: the
        bytes are evidence). Returns False when the move itself failed."""
        with self._mu:
            dst = os.path.join(self.directory, "quarantine",
                               f"{step}-{int(time.time() * 1000)}")
            try:
                os.makedirs(os.path.dirname(dst), exist_ok=True)
                shutil.move(self._step_dir(step), dst)
            except OSError:
                return False
            ckpt_verify_bump("steps_quarantined_total")
        return True


def _gang_rank() -> int | None:
    """This process's rank in a live torch.distributed gang of more than
    one, else None."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized() \
            and dist.get_world_size() > 1:
        return dist.get_rank()
    return None


def _barrier() -> None:
    import torch.distributed as dist

    dist.barrier()


def _sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as fh:
        for chunk in iter(lambda: fh.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()
