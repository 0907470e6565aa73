"""Build the port's CUDA sources with nvcc and load them with ctypes.

Each source in ``kubeflow_tpu_torch/csrc/`` is compiled on first use into a
shared library with a plain C interface, under ``kubeflow_tpu_torch/_build/``
(listed in .gitignore), named by a hash of the source and the flags so an
edited source is rebuilt. The target is ``sm_90a`` (Hopper). No build error
is swallowed: a failed compile raises with nvcc's output.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from dataclasses import dataclass, field
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
_CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


@dataclass
class Kernel:
    """One hand-written kernel: its source, the TPU kernel it replaces and
    the number of times its wrapper has launched it."""

    name: str
    source: str        # file under csrc/
    replaces: str      # file:line of the Pallas kernel body
    launches: int = 0
    _lock: threading.Lock = field(default_factory=threading.Lock,
                                  repr=False, compare=False)

    def count_launch(self) -> None:
        with self._lock:
            self.launches += 1

    @property
    def source_path(self) -> Path:
        return _CSRC / self.source


KERNELS: dict[str, Kernel] = {
    "flash_fwd": Kernel(
        "flash_fwd", "flash_fwd.cu",
        "kubeflow_tpu/parallel/ring_attention.py:584"),
}

_loaded: dict[str, ctypes.CDLL] = {}
_load_lock = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise FileNotFoundError(
        "nvcc not found on PATH or at /usr/local/cuda/bin/nvcc; the port's "
        "CUDA kernels are built on the machine with the card")


def library_path(name: str) -> Path:
    k = KERNELS[name]
    digest = hashlib.sha256(
        k.source_path.read_bytes() + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build_all(names: list[str] | None = None) -> dict[str, float]:
    """Compile every missing library, one nvcc per source, all started
    together. Returns {name: seconds} for the ones built. The ptxas report
    (registers, shared memory, spills) is kept beside each library."""
    names = list(KERNELS) if names is None else names
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    todo = [n for n in names if not library_path(n).exists()]
    if not todo:
        return {}
    nvcc = _nvcc()
    t0 = time.perf_counter()
    procs = {}
    for n in todo:
        tmp = library_path(n).with_suffix(f".{os.getpid()}.tmp")
        procs[n] = (tmp, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(KERNELS[n].source_path)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    took, failed = {}, []
    for n, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        took[n] = time.perf_counter() - t0
        (BUILD_DIR / f"{n}.nvcc.txt").write_text(out)
        if proc.returncode != 0:
            failed.append(f"{n} (nvcc exit {proc.returncode}):\n{out}")
            continue
        os.replace(tmp, library_path(n))
    if failed:
        raise RuntimeError("kernel build failed: " + "\n".join(failed))
    return took


def load(name: str) -> ctypes.CDLL:
    """The kernel's shared library, built first if it is missing."""
    with _load_lock:
        lib = _loaded.get(name)
        if lib is None:
            build_all([name])
            lib = ctypes.CDLL(str(library_path(name)))
            _loaded[name] = lib
        return lib
