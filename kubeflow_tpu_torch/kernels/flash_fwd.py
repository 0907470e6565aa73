"""Wrapper of the hand-written flash-attention forward (csrc/flash_fwd.cu).

Takes the public layout — q (B, Lq, H, D), k/v (B, Lk, H, D), bias
(B, 1, 1, Lk), one dtype (float32 or bfloat16), contiguous, on one CUDA
device — and returns (O (B, Lq, H, D), lse (B, H, Lq) float32). It launches
on the current stream and does not synchronise. float32 runs f32 FMA on the
CUDA cores; bfloat16 runs on the tensor cores (mma.sync, fed by 16-byte
cp.async copies, so q, k and v must also start 16-byte aligned:
``readable_in_place`` of kernels/_layout.py, which the autograd forward
ensures with a copy). The plain PyTorch version of the same function is
``parallel.ring_attention.flash_forward_plain``.

``flash_fwd_op`` (``torch.ops.kftpu.flash_fwd``) is the launch as a torch
custom op, so that ``torch.export`` can trace through it (a FakeTensor has
no storage to hand the library): its CUDA implementation copies q, k and v
the kernel cannot read in place and calls ``flash_fwd``; its CPU
implementation is the plain version; its fake implementation gives the
shapes. ``parallel.ring_attention.flash_forward`` calls it, eager, captured
in a CUDA graph or inside an exported program alike. Registering it builds
nothing: the library is built at the first CUDA call.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from kubeflow_tpu_torch.kernels._layout import async_copy_fault, readable
from kubeflow_tpu_torch.kernels.build import KERNELS, load

FLASH_FWD = KERNELS["flash_fwd"]
SUPPORTED_HEAD_DIMS = (16, 32, 64, 128)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_GRID_Y = 65535


@functools.cache
def _lib() -> ctypes.CDLL:
    """Build (at first use), load and declare the C entry points."""
    lib = load("flash_fwd")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.kft_flash_fwd.argtypes = [p, p, p, p, p, p, i, i, i, i, i, i, i, i,
                                  ctypes.c_float, p]
    lib.kft_flash_fwd.restype = i
    lib.kft_flash_fwd_smem.argtypes = [i, i]
    lib.kft_flash_fwd_smem.restype = ctypes.c_longlong
    lib.kft_cuda_error_string.argtypes = [i]
    lib.kft_cuda_error_string.restype = ctypes.c_char_p
    return lib


def smem_bytes(dtype: torch.dtype, head_dim: int) -> int:
    """The dynamic shared memory one launch takes, as the library computes
    it."""
    n = _lib().kft_flash_fwd_smem(_DTYPES[dtype], head_dim)
    if n < 0:
        raise ValueError(f"flash_fwd has no kernel for {dtype}, head_dim "
                         f"{head_dim}")
    return n


def flash_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              bias: torch.Tensor, causal: bool,
              window: int = 0) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the kernel; raises on any input it does not take."""
    if window and not causal:
        raise ValueError("attention window requires causal=True")
    if window < 0:
        raise ValueError(f"window {window} must be >= 0")
    for name, t in (("q", q), ("k", k), ("v", v), ("bias", bias)):
        if not t.is_cuda:
            raise ValueError(f"flash_fwd: {name} is on {t.device}, not CUDA")
        if t.device != q.device:
            raise ValueError(f"flash_fwd: {name} on {t.device}, q on "
                             f"{q.device}")
        if t.dtype != q.dtype:
            raise TypeError(f"flash_fwd: {name} is {t.dtype}, q is {q.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"flash_fwd: {name} is not contiguous")
    if q.dtype not in _DTYPES:
        raise TypeError(f"flash_fwd takes float32 or bfloat16, not {q.dtype}")
    if q.ndim != 4 or k.ndim != 4 or v.shape != k.shape:
        raise ValueError(f"flash_fwd: shapes q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    b, lq, h, d = q.shape
    lk = k.shape[1]
    if k.shape[0] != b or k.shape[2] != h or k.shape[3] != d:
        raise ValueError(f"flash_fwd: k {tuple(k.shape)} does not match q "
                         f"{tuple(q.shape)}")
    if tuple(bias.shape) != (b, 1, 1, lk):
        raise ValueError(f"flash_fwd: bias {tuple(bias.shape)} is not "
                         f"{(b, 1, 1, lk)}")
    if d not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"flash_fwd: head_dim {d} not in "
                         f"{SUPPORTED_HEAD_DIMS}")
    if lq < 1 or lk < 1:
        raise ValueError(f"flash_fwd: empty sequence (Lq {lq}, Lk {lk})")
    if b * h > _MAX_GRID_Y:
        raise ValueError(f"flash_fwd: B*H = {b * h} > {_MAX_GRID_Y}")
    if q.dtype == torch.bfloat16:
        for name, t in (("q", q), ("k", k), ("v", v)):
            fault = async_copy_fault(t)
            if fault:
                raise ValueError(f"flash_fwd: {name} {fault}; the bf16 kernel "
                                 "copies it 16 bytes at a time")
    lib = _lib()
    o = torch.empty_like(q)
    lse = torch.empty((b, h, lq), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.kft_flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
            o.data_ptr(), lse.data_ptr(), b, h, lq, lk, d, _DTYPES[q.dtype],
            int(causal), int(window), 1.0 / math.sqrt(d), stream)
    if err != 0:
        raise RuntimeError(
            f"flash_fwd launch failed: CUDA error {err} "
            f"({lib.kft_cuda_error_string(err).decode()})")
    FLASH_FWD.count_launch()
    return o, lse


# The op's schema, and its CPU, CUDA and fake implementations, registered
# through torch.library.Library: the first call of a
# torch.library.custom_op imports torch._dynamo and torch.distributed.tensor
# (seconds of a process's cold start), and each call pays a Python layer
# more.
_LIB = torch.library.Library("kftpu", "DEF")
_LIB.define("flash_fwd(Tensor q, Tensor k, Tensor v, Tensor bias, "
            "bool causal, int window, int block_k) -> (Tensor, Tensor)")


def _flash_fwd_cpu(q, k, v, bias, causal, window, block_k):
    """The plain version with ``block_k``-wide KV blocks (the CUDA kernel
    tiles for itself and ignores block_k)."""
    from kubeflow_tpu_torch.parallel.ring_attention import flash_forward_plain

    return flash_forward_plain(q, k, v, bias, block_k, causal, window)


def _flash_fwd_cuda(q, k, v, bias, causal, window, block_k):
    return flash_fwd(readable(q), readable(k), readable(v),
                     bias.contiguous(), causal, window)


def _flash_fwd_fake(q, k, v, bias, causal, window, block_k):
    b, lq, h, _ = q.shape
    return (q.new_empty(q.shape),
            q.new_empty((b, h, lq), dtype=torch.float32))


_LIB.impl("flash_fwd", _flash_fwd_cpu, "CPU")
_LIB.impl("flash_fwd", _flash_fwd_cuda, "CUDA")
torch.library.register_fake("kftpu::flash_fwd", _flash_fwd_fake, lib=_LIB)
#: (O, lse) of flash attention: ``torch.ops.kftpu.flash_fwd``
flash_fwd_op = torch.ops.kftpu.flash_fwd.default
