"""Dropout with its mask drawn on the device: the wrapper of the
hand-written kernels in csrc/dropout.cu, their plain PyTorch version, and
the autograd function the models call.

The mask of element i of a contiguous tensor is a function of (seed, site,
i) alone: Philox4x32-10 keyed by the 64-bit ``seed``, counter (i // 4, site,
0), word i % 4, kept where it is below ``ceil(keep * 2^32)``. A tensor that
is a slice of a larger one (a context rank's positions of every sequence)
takes ``span`` = (row, row_stride, offset): its rows of ``row`` elements sit
``row_stride`` apart in the whole, from ``offset``, and element i draws the
whole's element (i // row) * row_stride + offset + i % row, so the slices'
masks are the whole's. A kept element
becomes ``x * scale`` (scale the float32 1 / keep, the product in float32,
rounded to x's dtype), a dropped one 0. The seed is a 0-dim int64 tensor on
x's device, read by pointer when the kernel runs, so a CUDA graph that
captured the launch draws a new mask at each replay once the host has
written a new seed into that tensor (``train/trainer.py``), and a block
recomputed under remat, reading the same seed, redraws the same mask.

``dropout_plain`` is the same function in PyTorch integer ops: every
32x32-bit multiply of the Philox rounds is split into 16-bit halves, so no
int64 product overflows, and the masks are bit for bit the kernel's. The
CPU path uses it; on CUDA tensors ``dropout`` launches the kernels
(``dropout_fwd``, and ``dropout_bwd`` in the backward, which recomputes the
mask) or raises.

No Pallas kernel is replaced: the JAX package draws its masks with
jax.random.bernoulli in XLA, so the two packages' masks differ and the
tests hold them by statistics.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from kubeflow_tpu_torch.kernels.build import KERNELS, load

DROPOUT_FWD = KERNELS["dropout_fwd"]
DROPOUT_BWD = KERNELS["dropout_bwd"]
_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_MASK32 = 0xFFFFFFFF
# Philox4x32's multipliers and key increments (Random123)
PHILOX_M = (0xD2511F53, 0xCD9E8D57)
PHILOX_W = (0x9E3779B9, 0xBB67AE85)
PHILOX_ROUNDS = 10


@functools.cache
def _lib() -> ctypes.CDLL:
    """Build (at first use), load and declare the C entry points."""
    lib = load("dropout_fwd")
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    for fn in (lib.kft_dropout_fwd, lib.kft_dropout_bwd):
        fn.argtypes = [p, p, p, ll, ll, ll, ll, i, i, ctypes.c_ulonglong,
                       ctypes.c_float, i, p]
        fn.restype = i
    lib.kft_cuda_error_string.argtypes = [i]
    lib.kft_cuda_error_string.restype = ctypes.c_char_p
    return lib


def keep_threshold(rate: float) -> int:
    """The kept draws are those below this: ceil((1 - rate) * 2^32), so a
    32-bit draw r is kept iff r / 2^32 < 1 - rate."""
    return math.ceil((1.0 - rate) * 2.0 ** 32)


def keep_scale(rate: float) -> float:
    """1 / (1 - rate) rounded to float32: the factor of a kept element."""
    return float(torch.tensor(1.0 / (1.0 - rate), dtype=torch.float32))


def _check_rate(rate: float) -> None:
    if not 0.0 < rate < 1.0:
        raise ValueError(f"dropout rate {rate} is not in (0, 1)")


def _mulhilo(a: torch.Tensor, m: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(high, low) 32 bits of the 64-bit product a * m, for int64 ``a``
    holding 32-bit values and a 32-bit constant m, without an int64
    product above 2^49."""
    t1 = a * (m & 0xFFFF)           # < 2^48
    t2 = a * (m >> 16)              # < 2^48
    hi = (t2 + (t1 >> 16)) >> 16
    lo = (t1 + ((t2 & 0xFFFF) << 16)) & _MASK32
    return hi, lo


def philox4x32_10(c0, c1, c2, c3, k0, k1):
    """Philox4x32-10 on int64 tensors (broadcastable) of 32-bit values:
    counter (c0, c1, c2, c3), key (k0, k1). Returns the four output words."""
    for r in range(PHILOX_ROUNDS):
        if r:
            k0 = (k0 + PHILOX_W[0]) & _MASK32
            k1 = (k1 + PHILOX_W[1]) & _MASK32
        hi0, lo0 = _mulhilo(c0, PHILOX_M[0])
        hi1, lo1 = _mulhilo(c2, PHILOX_M[1])
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def dropout_draws(seed: torch.Tensor, site: int, n: int,
                  span: tuple[int, int, int] | None = None) -> torch.Tensor:
    """The n 32-bit draws (int64) of elements 0..n-1 at ``site``, on the
    seed's device; with ``span`` those of the whole's elements they are
    (the module docstring)."""
    dev = seed.device
    s = seed.reshape(()).to(torch.int64)
    key = (s & _MASK32, (s >> 32) & _MASK32)
    if span is None:
        g = torch.arange((n + 3) // 4, dtype=torch.int64, device=dev)
        words = philox4x32_10(g & _MASK32, g >> 32, torch.full_like(g, site),
                              torch.zeros_like(g), *key)
        return torch.stack(words, dim=1).reshape(-1)[:n]
    row, stride, offset = span
    i = torch.arange(n, dtype=torch.int64, device=dev)
    e = (i // row) * stride + offset + i % row
    g = e // 4
    words = torch.stack(philox4x32_10(
        g & _MASK32, g >> 32, torch.full_like(g, site), torch.zeros_like(g),
        *key), dim=1)
    return words.gather(1, (e % 4)[:, None])[:, 0]


def dropout_mask(seed: torch.Tensor, site: int, rate: float, shape,
                 span: tuple[int, int, int] | None = None) -> torch.Tensor:
    """The boolean keep-mask of a tensor of ``shape``."""
    n = math.prod(shape)
    return (dropout_draws(seed, site, n, span) < keep_threshold(rate)
            ).reshape(shape)


def dropout_plain(x: torch.Tensor, seed: torch.Tensor, rate: float,
                  site: int = 0, span: tuple[int, int, int] | None = None
                  ) -> torch.Tensor:
    """The kernels' function in PyTorch: kept elements x * scale (in
    float32, rounded to x's dtype), the others 0."""
    _check_rate(rate)
    keep = dropout_mask(seed, site, rate, x.shape, span)
    scaled = (x.float() * keep_scale(rate)).to(x.dtype)
    return torch.where(keep, scaled, torch.zeros((), dtype=x.dtype,
                                                 device=x.device))


def _launch(kernel, fn_name: str, x: torch.Tensor, seed: torch.Tensor,
            rate: float, site: int, span: tuple[int, int, int] | None
            ) -> torch.Tensor:
    """One launch of the forward or backward kernel; raises on any input
    it does not take."""
    _check_rate(rate)
    if not x.is_cuda:
        raise ValueError(f"{kernel.name}: x is on {x.device}, not CUDA")
    if x.dtype not in _DTYPES:
        raise TypeError(f"{kernel.name} takes float32, bfloat16 or float16, "
                        f"not {x.dtype}")
    if not x.is_contiguous():
        raise ValueError(f"{kernel.name}: x is not contiguous")
    if seed.device != x.device or seed.dtype != torch.int64 \
            or seed.numel() != 1:
        raise ValueError(f"{kernel.name}: the seed must be one int64 on "
                         f"{x.device}, not {seed.dtype} {tuple(seed.shape)} "
                         f"on {seed.device}")
    if not 0 <= site <= _MASK32:
        raise ValueError(f"{kernel.name}: site {site} is not a 32-bit value")
    n = x.numel()
    row, stride, offset = span or (n, n, 0)
    if n and (row <= 0 or n % row or offset % 4
              or (row != n and (row % 4 or stride % 4))):
        raise ValueError(
            f"{kernel.name}: span (row {row}, row_stride {stride}, offset "
            f"{offset}) of {n} elements: the kernel takes rows that divide "
            "the input, and rows, strides and offsets in multiples of 4")
    y = torch.empty_like(x)
    if n == 0:
        return y
    lib = _lib()
    vec = int(x.data_ptr() % 16 == 0 and y.data_ptr() % 16 == 0)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = getattr(lib, fn_name)(
            x.data_ptr(), y.data_ptr(), seed.data_ptr(), n, row, stride,
            offset, _DTYPES[x.dtype], site, keep_threshold(rate),
            keep_scale(rate), vec, stream)
    if err != 0:
        raise RuntimeError(
            f"{kernel.name} launch failed: CUDA error {err} "
            f"({lib.kft_cuda_error_string(err).decode()})")
    kernel.count_launch()
    return y


def dropout_fwd(x: torch.Tensor, seed: torch.Tensor, rate: float,
                site: int = 0, span: tuple[int, int, int] | None = None
                ) -> torch.Tensor:
    """Launch the forward kernel on a contiguous CUDA tensor."""
    return _launch(DROPOUT_FWD, "kft_dropout_fwd", x, seed, rate, site,
                   span)


def dropout_bwd(dy: torch.Tensor, seed: torch.Tensor, rate: float,
                site: int = 0, span: tuple[int, int, int] | None = None
                ) -> torch.Tensor:
    """Launch the backward kernel: dx from dy under the recomputed mask."""
    return _launch(DROPOUT_BWD, "kft_dropout_bwd", dy, seed, rate, site,
                   span)


class _Dropout(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, seed, rate, site, span):
        ctx.save_for_backward(seed)
        ctx.rate, ctx.site, ctx.span = rate, site, span
        if x.is_cuda:
            return dropout_fwd(x.contiguous(), seed, rate, site, span)
        return dropout_plain(x, seed, rate, site, span)

    @staticmethod
    def backward(ctx, g):
        (seed,) = ctx.saved_tensors
        if g.is_cuda:
            dx = dropout_bwd(g.contiguous(), seed, ctx.rate, ctx.site,
                             ctx.span)
        else:
            dx = dropout_plain(g, seed, ctx.rate, ctx.site, ctx.span)
        return dx, None, None, None, None


def dropout(x: torch.Tensor, seed: torch.Tensor, rate: float,
            site: int = 0, span: tuple[int, int, int] | None = None
            ) -> torch.Tensor:
    """Dropout of x at ``rate`` (in (0, 1)) under the mask of (seed, site)
    (and ``span``, the whole x is a slice of): the kernels on a CUDA
    tensor, the plain version on a CPU one; the backward recomputes the
    mask."""
    return _Dropout.apply(x, seed, rate, site, span)
