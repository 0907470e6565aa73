"""The restart-warm kernel cache — counterpart of
``kubeflow_tpu/utils/compile_cache.py``.

In the JAX package a restarted incarnation reloads its compiled train step
from a persistent cache instead of compiling it again. The port's compiles
are the nvcc builds of its hand-written kernels (``kernels/build.py``):
libraries named by a hash of their sources and flags. When a cache dir
resolves (``cache_dir_from_env``), the trainer builds the libraries into it
and loads them from it, so an incarnation that finds them there runs nvcc
zero times. The process-global counters below are the proof: subtract two
``compile_counts()`` snapshots to get the builds and loads a region caused.
"""

from __future__ import annotations

import os
import threading

from kubeflow_tpu_torch.utils.envvars import ENV_COMPILE_CACHE_DIR

_MU = threading.Lock()
_COUNTS = {
    "nvcc_runs_total": 0,        # nvcc processes started (one a source)
    "libraries_loaded_total": 0,  # kernel libraries loaded with ctypes
}


def cache_dir_from_env(explicit: str = "") -> str:
    """The effective cache dir: an explicit config value wins, else the pod
    env contract (ENV_COMPILE_CACHE_DIR), else "" (no cache)."""
    return explicit or os.environ.get(ENV_COMPILE_CACHE_DIR, "")


def count(name: str, n: int = 1) -> None:
    with _MU:
        _COUNTS[name] += n


def compile_counts() -> dict[str, int]:
    """Snapshot of the process-global counters."""
    with _MU:
        return dict(_COUNTS)
