"""Build the port's CUDA sources with nvcc and load them with ctypes.

Each source in ``kubeflow_tpu_torch/csrc/`` is compiled on first use into one
shared library with a plain C interface, under ``kubeflow_tpu_torch/_build/``
(listed in .gitignore), named by a hash of the source, the shared headers
(``csrc/*.cuh``) and the flags so an edited source or header is rebuilt.
Kernels that share a source (the three backward kernels of
``flash_bwd.cu``) share its library. The target is ``sm_90a`` (Hopper). No
build error is swallowed: a failed compile raises with nvcc's output.
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
    """One hand-written kernel: its source, the TPU kernel it replaces, the
    number of times its wrapper has launched it and, for a kernel with more
    than one form, the launches of each form."""

    name: str
    source: str        # file under csrc/
    replaces: str      # file:line of the Pallas kernel body
    launches: int = 0
    forms: dict[str, int] = field(default_factory=dict)
    _lock: threading.Lock = field(default_factory=threading.Lock,
                                  repr=False, compare=False)

    def count_launch(self, form: str | None = None) -> None:
        with self._lock:
            self.launches += 1
            if form is not None:
                self.forms[form] = self.forms.get(form, 0) + 1

    @property
    def source_path(self) -> Path:
        return _CSRC / self.source


KERNELS: dict[str, Kernel] = {
    "flash_fwd": Kernel(
        "flash_fwd", "flash_fwd.cu",
        "kubeflow_tpu/parallel/ring_attention.py:584"),
    "flash_bwd_dd": Kernel(
        "flash_bwd_dd", "flash_bwd.cu",
        "kubeflow_tpu/parallel/ring_attention.py:1279"),
    "flash_bwd_dq": Kernel(
        "flash_bwd_dq", "flash_bwd.cu",
        "kubeflow_tpu/parallel/ring_attention.py:748"),
    "flash_bwd_dkv": Kernel(
        "flash_bwd_dkv", "flash_bwd.cu",
        "kubeflow_tpu/parallel/ring_attention.py:786"),
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


def sources(names: list[str] | None = None) -> list[str]:
    """The distinct sources of the named kernels (all by default)."""
    names = list(KERNELS) if names is None else names
    return sorted({KERNELS[n].source for n in names})


def library_path(source: str) -> Path:
    """The library built from one source under csrc/ (named by a hash of it,
    the headers under csrc/ and the flags)."""
    parts = [(_CSRC / source).read_bytes()]
    parts += [h.read_bytes() for h in sorted(_CSRC.glob("*.cuh"))]
    digest = hashlib.sha256(
        b"".join(parts) + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{Path(source).stem}-{digest}.so"


def report_path(source: str) -> Path:
    """nvcc's output (the ptxas report: registers, shared memory, spills)
    for one source, kept beside its library."""
    return BUILD_DIR / f"{Path(source).stem}.nvcc.txt"


def build_all(names: list[str] | None = None) -> dict[str, float]:
    """Compile every missing library of the named kernels, one nvcc per
    source, all started together. Returns {source: seconds} for the ones
    built."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    todo = [s for s in sources(names) if not library_path(s).exists()]
    if not todo:
        return {}
    nvcc = _nvcc()
    t0 = time.perf_counter()
    procs = {}
    for src in todo:
        tmp = library_path(src).with_suffix(f".{os.getpid()}.tmp")
        procs[src] = (tmp, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(_CSRC / src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    took, failed = {}, []
    for src, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        took[src] = time.perf_counter() - t0
        report_path(src).write_text(out)
        if proc.returncode != 0:
            failed.append(f"{src} (nvcc exit {proc.returncode}):\n{out}")
            continue
        os.replace(tmp, library_path(src))
    if failed:
        raise RuntimeError("kernel build failed: " + "\n".join(failed))
    return took


def load(name: str) -> ctypes.CDLL:
    """The shared library of the named kernel, built first if it is
    missing. Kernels of one source get the same handle."""
    source = KERNELS[name].source
    with _load_lock:
        lib = _loaded.get(source)
        if lib is None:
            build_all([name])
            lib = ctypes.CDLL(str(library_path(source)))
            _loaded[source] = lib
        return lib
