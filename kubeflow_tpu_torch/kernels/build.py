"""Build the port's CUDA sources with nvcc and load them with ctypes.

Each source in ``kubeflow_tpu_torch/csrc/`` is compiled on first use into one
shared library with a plain C interface, under ``kubeflow_tpu_torch/_build/``
(listed in .gitignore) or a restart-warm cache dir the caller names
(``utils/compile_cache.py``), named by a hash of the source, the shared
headers (``csrc/*.cuh``) and the flags so an edited source or header is
rebuilt. Kernels that share a source (the three backward kernels of
``flash_bwd.cu``) share its library. The target is ``sm_90a`` (Hopper). No
build error is swallowed: a failed compile raises with nvcc's output.

A launch captured into a CUDA graph runs on every replay, not at capture:
``launch_counts``/``launches_since``/``add_launches`` let the graph's owner
take the capture's counts back and add them again on each replay.
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

from kubeflow_tpu_torch.utils import compile_cache

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
        self.add(1, {form: 1} if form is not None else {})

    def add(self, n: int, forms: dict[str, int]) -> None:
        """Add n launches (negative: take them back), ``forms`` of them by
        form."""
        with self._lock:
            self.launches += n
            for form, k in forms.items():
                self.forms[form] = self.forms.get(form, 0) + k

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
    # port-only: the JAX package draws dropout masks in XLA
    # (jax.random.bernoulli), so these replace no Pallas kernel
    "dropout_fwd": Kernel(
        "dropout_fwd", "dropout.cu",
        "none (kubeflow_tpu/models/gpt.py:218 draws masks in XLA)"),
    "dropout_bwd": Kernel(
        "dropout_bwd", "dropout.cu",
        "none (kubeflow_tpu/models/gpt.py:218 draws masks in XLA)"),
}

_loaded: dict[str, ctypes.CDLL] = {}
_load_lock = threading.Lock()


def launch_counts() -> dict[str, tuple[int, dict[str, int]]]:
    """Every kernel's (launches, launches by form), a snapshot."""
    return {n: (k.launches, dict(k.forms)) for n, k in KERNELS.items()}


def launches_since(before: dict) -> dict[str, tuple[int, dict[str, int]]]:
    """The launches of each kernel since the ``launch_counts()`` snapshot
    ``before``."""
    out = {}
    for n, (count, forms) in launch_counts().items():
        was, was_forms = before[n]
        out[n] = (count - was, {f: c - was_forms.get(f, 0)
                                for f, c in forms.items()
                                if c != was_forms.get(f, 0)})
    return out


def add_launches(delta: dict, sign: int = 1) -> None:
    """Add a ``launches_since`` delta to the counts (sign -1: take it
    back)."""
    for n, (count, forms) in delta.items():
        KERNELS[n].add(sign * count, {f: sign * c for f, c in forms.items()})


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


def library_path(source: str, build_dir: str | Path | None = None) -> Path:
    """The library built from one source under csrc/ (named by a hash of it,
    the headers under csrc/ and the flags), in ``build_dir`` (default
    BUILD_DIR)."""
    parts = [(_CSRC / source).read_bytes()]
    parts += [h.read_bytes() for h in sorted(_CSRC.glob("*.cuh"))]
    digest = hashlib.sha256(
        b"".join(parts) + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return Path(build_dir or BUILD_DIR) / f"lib{Path(source).stem}-{digest}.so"


def report_path(source: str, build_dir: str | Path | None = None) -> Path:
    """nvcc's output (the ptxas report: registers, shared memory, spills)
    for one source, kept beside its library."""
    return Path(build_dir or BUILD_DIR) / f"{Path(source).stem}.nvcc.txt"


def build_all(names: list[str] | None = None,
              build_dir: str | Path | None = None) -> dict[str, float]:
    """Compile every library of the named kernels missing from
    ``build_dir`` (default BUILD_DIR), one nvcc per source, all started
    together. Returns {source: seconds} for the ones built."""
    Path(build_dir or BUILD_DIR).mkdir(parents=True, exist_ok=True)
    todo = [s for s in sources(names)
            if not library_path(s, build_dir).exists()]
    if not todo:
        return {}
    nvcc = _nvcc()
    t0 = time.perf_counter()
    procs = {}
    for src in todo:
        tmp = library_path(src, build_dir).with_suffix(
            f".{os.getpid()}.tmp")
        procs[src] = (tmp, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(_CSRC / src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        compile_cache.count("nvcc_runs_total")
    took, failed = {}, []
    for src, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        took[src] = time.perf_counter() - t0
        report_path(src, build_dir).write_text(out)
        if proc.returncode != 0:
            failed.append(f"{src} (nvcc exit {proc.returncode}):\n{out}")
            continue
        os.replace(tmp, library_path(src, build_dir))
    if failed:
        raise RuntimeError("kernel build failed: " + "\n".join(failed))
    return took


def load(name: str, build_dir: str | Path | None = None) -> ctypes.CDLL:
    """The shared library of the named kernel, built into ``build_dir``
    (default BUILD_DIR) first if it is missing there. Kernels of one source
    get the same handle: a library loaded once serves the process."""
    source = KERNELS[name].source
    with _load_lock:
        lib = _loaded.get(source)
        if lib is None:
            build_all([name], build_dir)
            lib = ctypes.CDLL(str(library_path(source, build_dir)))
            _loaded[source] = lib
            compile_cache.count("libraries_loaded_total")
        return lib


def load_all(build_dir: str | Path | None = None) -> list[str]:
    """Build (into ``build_dir``) what is missing and load every kernel's
    library that this process has not loaded yet. Returns the sources
    loaded now."""
    build_all(None, build_dir)
    fresh = [s for s in sources() if s not in _loaded]
    for src in fresh:
        load(next(n for n, k in KERNELS.items() if k.source == src),
             build_dir)
    return fresh
