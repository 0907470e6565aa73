"""Wrappers of the hand-written flash-attention backward (csrc/flash_bwd.cu).

Three kernels, one library, replacing the Pallas TPU backward of
kubeflow_tpu/parallel/ring_attention.py:

  flash_bwd_dd   D = Σ_d dO∘O -> (B, H, Lq) f32    (`_dd_prekernel`, :1279)
  flash_bwd_dq   dq from q, k, v, bias, dO, lse and D (or O)
                 (`_flash_dq_kernel` :748 and its loop/loop2 forms)
  flash_bwd_dkv  dk, dv and the per-head dbias row from the same
                 (`_flash_dkv_kernel` :786 and its loop/loop2 forms)

dq and dkv are bound by operations on the H100. In bfloat16 they run on the
tensor cores: FlashAttention-2-style mma.sync m16n8k16
products with f32 accumulation, fed by ldmatrix from shared-memory tiles
that 16-byte cp.async copies fill two stages ahead, with p and ds rounded to
bf16 where the TPU kernels round them. In float32 they stay f32 FMA on the
CUDA cores, level with SDPA's f32 backward. Both are two deterministic
passes (no atomics); csrc/flash_bwd.cu says more. flash_bwd_dd is bound by
bytes: it reads O and dO 16 bytes a lane where their rows allow it, one
element a lane otherwise (``FLASH_BWD_DD.forms`` counts which form ran).

Inputs are the public layout: q, o, dO (B, Lq, H, D), k, v (B, Lk, H, D),
one dtype (float32 or bfloat16), read by stride with a unit stride on D (so
dO may come as autograd hands it over); in bfloat16 the tensors copied by
16-byte cp.async also need a 16-byte-aligned start and batch, position and
head strides that are multiples of 8 elements (``readable_in_place`` of
kernels/_layout.py; the autograd backward copies a dO that lacks them).
bias (B, 1, 1, Lk) of the same dtype, contiguous; lse and D (B, H, Lq)
float32, contiguous. dq, dk and dv come back contiguous in the input
dtype, dbias per (b·h, key) in float32. Every launch is on the current stream and does not synchronise.
The plain PyTorch version of the same functions is
``parallel.ring_attention.flash_backward_plain``.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from kubeflow_tpu_torch.kernels._layout import (  # noqa: F401
    async_copy_fault,
    readable_in_place,  # re-exported for callers of the backward
)
from kubeflow_tpu_torch.kernels.build import KERNELS, load

FLASH_BWD_DD = KERNELS["flash_bwd_dd"]
FLASH_BWD_DQ = KERNELS["flash_bwd_dq"]
FLASH_BWD_DKV = KERNELS["flash_bwd_dkv"]
SUPPORTED_HEAD_DIMS = (16, 32, 64, 128)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_GRID_Y = 65535

_p, _i, _ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


class _BwdArgs(ctypes.Structure):
    """``BwdArgs`` of csrc/flash_bwd.cu, field for field."""

    _fields_ = (
        [(n, _p) for n in ("q", "k", "v", "bias", "o", "dout", "lse", "dd",
                           "dq", "dk", "dv", "dbias", "dd_out")]
        + [(n, _ll * 3) for n in ("sq", "sk", "sv", "so", "sdo")]
        + [(n, _i) for n in ("B", "H", "Lq", "Lk", "D", "dtype", "causal",
                             "window")]
        + [("scale", ctypes.c_float)])


@functools.cache
def _lib() -> ctypes.CDLL:
    """Build (at first use), load and declare the C entry points."""
    lib = load("flash_bwd_dq")
    args = ctypes.POINTER(_BwdArgs)
    lib.kft_flash_bwd_dd.argtypes = [args, _i, _p]
    lib.kft_flash_bwd_dd.restype = _i
    for fn in (lib.kft_flash_bwd_dq, lib.kft_flash_bwd_dkv):
        fn.argtypes = [args, _i, _p]
        fn.restype = _i
    lib.kft_flash_bwd_smem.argtypes = [_i, _i, _i, _i]
    lib.kft_flash_bwd_smem.restype = _ll
    lib.kft_cuda_error_string.argtypes = [_i]
    lib.kft_cuda_error_string.restype = ctypes.c_char_p
    return lib


def smem_bytes(kernel: str, dtype: torch.dtype, head_dim: int,
               from_o: bool) -> int:
    """The dynamic shared memory one launch of ``kernel`` ("flash_bwd_dq"
    or "flash_bwd_dkv") takes, as the library computes it."""
    which = {"flash_bwd_dq": 0, "flash_bwd_dkv": 1}[kernel]
    n = _lib().kft_flash_bwd_smem(which, _DTYPES[dtype], head_dim,
                                  int(from_o))
    if n < 0:
        raise ValueError(f"{kernel} has no kernel for {dtype}, head_dim "
                         f"{head_dim}")
    return n


def _ptr(t: torch.Tensor | None) -> int | None:
    return None if t is None else t.data_ptr()


def _strides(name: str, t: torch.Tensor) -> tuple[int, int, int]:
    """(batch, position, head) element strides; D's must be 1."""
    if t.stride(3) != 1 and t.shape[3] != 1:
        raise ValueError(f"flash backward: {name} has stride {t.stride(3)} "
                         "on head_dim; the kernels read it with stride 1")
    return t.stride(0), t.stride(1), t.stride(2)


def _check_async_copies(name: str, t: torch.Tensor) -> None:
    fault = async_copy_fault(t)
    if fault:
        raise ValueError(f"flash backward: {name} {fault}; the bf16 kernels "
                         "copy it 16 bytes at a time")


def _args(q, k, v, bias, o, do, lse, dd, causal: bool,
          window: int) -> _BwdArgs:
    """Check every input the kernels read and fill their argument block."""
    if window and not causal:
        raise ValueError("attention window requires causal=True")
    if window < 0:
        raise ValueError(f"window {window} must be >= 0")
    named = [("q", q), ("k", k), ("v", v), ("bias", bias), ("o", o),
             ("dO", do), ("lse", lse)] + ([("D", dd)] if dd is not None
                                          else [])
    for name, t in named:
        if not t.is_cuda:
            raise ValueError(f"flash backward: {name} is on {t.device}, "
                             "not CUDA")
        if t.device != q.device:
            raise ValueError(f"flash backward: {name} on {t.device}, q on "
                             f"{q.device}")
    if q.dtype not in _DTYPES:
        raise TypeError(f"flash backward takes float32 or bfloat16, not "
                        f"{q.dtype}")
    for name, t in (("k", k), ("v", v), ("bias", bias), ("o", o),
                    ("dO", do)):
        if t.dtype != q.dtype:
            raise TypeError(f"flash backward: {name} is {t.dtype}, q is "
                            f"{q.dtype}")
    if q.ndim != 4 or k.ndim != 4 or v.shape != k.shape:
        raise ValueError(f"flash backward: shapes q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    b, lq, h, d = q.shape
    lk = k.shape[1]
    if k.shape[0] != b or k.shape[2] != h or k.shape[3] != d:
        raise ValueError(f"flash backward: k {tuple(k.shape)} does not "
                         f"match q {tuple(q.shape)}")
    for name, t in (("o", o), ("dO", do)):
        if t.shape != q.shape:
            raise ValueError(f"flash backward: {name} {tuple(t.shape)} is "
                             f"not q's {tuple(q.shape)}")
    if tuple(bias.shape) != (b, 1, 1, lk) or not bias.is_contiguous():
        raise ValueError(f"flash backward: bias {tuple(bias.shape)} is not a "
                         f"contiguous {(b, 1, 1, lk)}")
    for name, t in (("lse", lse), ("D", dd)):
        if t is None:
            continue
        if (tuple(t.shape) != (b, h, lq) or t.dtype != torch.float32
                or not t.is_contiguous()):
            raise ValueError(f"flash backward: {name} must be a contiguous "
                             f"float32 {(b, h, lq)}, not {t.dtype} "
                             f"{tuple(t.shape)}")
    if d not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"flash backward: head_dim {d} not in "
                         f"{SUPPORTED_HEAD_DIMS}")
    if lq < 1 or lk < 1:
        raise ValueError(f"flash backward: empty sequence (Lq {lq}, Lk {lk})")
    if b * h > _MAX_GRID_Y:
        raise ValueError(f"flash backward: B*H = {b * h} > {_MAX_GRID_Y}")
    if q.dtype == torch.bfloat16:
        for name, t in (("q", q), ("k", k), ("v", v), ("dO", do)) + (
                (("o", o),) if dd is None else ()):
            _check_async_copies(name, t)
    return _BwdArgs(
        q=_ptr(q), k=_ptr(k), v=_ptr(v), bias=_ptr(bias), o=_ptr(o),
        dout=_ptr(do), lse=_ptr(lse), dd=_ptr(dd),
        sq=(_ll * 3)(*_strides("q", q)), sk=(_ll * 3)(*_strides("k", k)),
        sv=(_ll * 3)(*_strides("v", v)), so=(_ll * 3)(*_strides("o", o)),
        sdo=(_ll * 3)(*_strides("dO", do)),
        B=b, H=h, Lq=lq, Lk=lk, D=d, dtype=_DTYPES[q.dtype],
        causal=int(causal), window=int(window), scale=1.0 / math.sqrt(d))


def _launch(lib, fn, kernel, device, *call_args, form=None) -> None:
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(*call_args, stream)
    if err != 0:
        raise RuntimeError(
            f"{kernel.name} launch failed: CUDA error {err} "
            f"({lib.kft_cuda_error_string(err).decode()})")
    kernel.count_launch(form)


def _dd_path(o: torch.Tensor, do: torch.Tensor) -> str:
    """"vector" where flash_bwd_dd can read both tensors 16 bytes a lane (a
    supported head_dim with unit stride, rows fit for 16-byte loads), else
    "scalar"."""
    if o.shape[3] in SUPPORTED_HEAD_DIMS and all(
            t.stride(3) == 1 and async_copy_fault(t) is None for t in (o, do)):
        return "vector"
    return "scalar"


def flash_bwd_dd(o: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """D = Σ_d dO∘O in float32, (B, H, Lq). Reads 16 bytes a lane where o's
    and dO's rows allow it ("vector"), one element a lane otherwise
    ("scalar"); ``FLASH_BWD_DD.forms`` counts the launches of each."""
    for name, t in (("o", o), ("dO", do)):
        if not t.is_cuda or t.device != o.device:
            raise ValueError(f"flash_bwd_dd: {name} is on {t.device}, not "
                             "the CUDA device of o")
    if o.dtype not in _DTYPES or do.dtype != o.dtype:
        raise TypeError(f"flash_bwd_dd takes o and dO of one dtype, float32 "
                        f"or bfloat16, not {o.dtype} and {do.dtype}")
    if o.ndim != 4 or do.shape != o.shape:
        raise ValueError(f"flash_bwd_dd: o {tuple(o.shape)}, dO "
                         f"{tuple(do.shape)}")
    b, lq, h, d = o.shape
    dd = torch.empty((b, h, lq), dtype=torch.float32, device=o.device)
    a = _BwdArgs(o=_ptr(o), dout=_ptr(do), dd_out=_ptr(dd),
                 so=(_ll * 3)(*_strides("o", o)),
                 sdo=(_ll * 3)(*_strides("dO", do)),
                 B=b, H=h, Lq=lq, D=d, dtype=_DTYPES[o.dtype])
    path = _dd_path(o, do)
    lib = _lib()
    _launch(lib, lib.kft_flash_bwd_dd, FLASH_BWD_DD, o.device,
            ctypes.byref(a), int(path == "vector"), form=path)
    return dd


def flash_bwd_dq(q, k, v, bias, o, do, lse, dd, causal: bool,
                 window: int = 0) -> torch.Tensor:
    """dq. With ``dd`` None, D is computed per tile from ``o`` (the loop2
    form); otherwise ``dd`` is D and ``o`` is not read."""
    a = _args(q, k, v, bias, o, do, lse, dd, causal, window)
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    a.dq = _ptr(dq)
    lib = _lib()
    _launch(lib, lib.kft_flash_bwd_dq, FLASH_BWD_DQ, q.device,
            ctypes.byref(a), int(dd is None))
    return dq


def flash_bwd_dkv(q, k, v, bias, o, do, lse, dd, causal: bool,
                  window: int = 0, want_dbias: bool = True
                  ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor | None]:
    """(dk, dv, dbias_bh (B·H, Lk) float32 or None). With ``dd`` None, D is
    computed per tile from ``o`` (the loop2 form)."""
    a = _args(q, k, v, bias, o, do, lse, dd, causal, window)
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    dbias = (torch.empty((q.shape[0] * q.shape[2], k.shape[1]),
                         dtype=torch.float32, device=q.device)
             if want_dbias else None)
    a.dk, a.dv, a.dbias = _ptr(dk), _ptr(dv), _ptr(dbias)
    lib = _lib()
    _launch(lib, lib.kft_flash_bwd_dkv, FLASH_BWD_DKV, q.device,
            ctypes.byref(a), int(dd is None))
    return dk, dv, dbias
