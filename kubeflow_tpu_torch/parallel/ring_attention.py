"""Single-device attention — counterpart of
``kubeflow_tpu/parallel/ring_attention.py``.

The single-device flash path, forward and backward:

  blockwise_attention   the plain online-softmax scan over KV blocks (the
                        numerics reference of the flash forward; forward only:
                        its FA2 custom backward is not ported yet)
  flash_attention       the public flash entry point, differentiable: on CUDA
                        tensors its forward launches the hand-written Hopper
                        kernel (csrc/flash_fwd.cu) and its backward the three
                        backward kernels (csrc/flash_bwd.cu); on CPU tensors
                        both run their plain versions
  flash_forward         (out, lse), the raw forward
  flash_backward        (dq, dk, dv, dbias) from the forward's residuals

All take the JAX package's layout: q/k/v (B, L, H, D), bias (B, 1, 1, Lk)
additive, out (B, L, H, D), lse (B, H, Lq) float32. Ring and Ulysses
attention and the KFT_FLASH_BLOCK_Q/K and KFT_FLASH_DIMSEM tuning variables
come with later slices.
"""

from __future__ import annotations

import math
import os

import torch

from kubeflow_tpu_torch.kernels._layout import readable, readable_in_place
from kubeflow_tpu_torch.kernels.flash_fwd import flash_fwd_op

NEG_INF = -1e9

# Backward selector, read at import like the JAX package's
# KFT_FLASH_BWD_IMPL (ring_attention.py:879-885), with the same names and the
# same refusal of an unknown one. On CUDA tensors "loop2" launches the dq and
# dkv kernels in their D-from-O form and every other name launches the D
# pre-kernel, then dq and dkv reading D; on CPU tensors every name runs the
# plain version. The JAX default "xla" only kept Pallas out of the TPU's
# gradient path (Mosaic NaN'd it); the port's default is the kernel path.
_FLASH_BWD_IMPLS = ("xla", "loop2", "ddpre", "loop", "scratch")
FLASH_BWD_IMPL = os.environ.get("KFT_FLASH_BWD_IMPL", "ddpre")
if FLASH_BWD_IMPL not in _FLASH_BWD_IMPLS:
    raise ValueError(
        f"KFT_FLASH_BWD_IMPL={FLASH_BWD_IMPL!r} is not one of "
        f"{_FLASH_BWD_IMPLS} — refusing to fall through to an arbitrary "
        "backward")


def _refuse_grad(what: str, *tensors: torch.Tensor) -> None:
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise NotImplementedError(what)


def flash_forward_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        bias: torch.Tensor, block: int = 256,
                        causal: bool = False, window: int = 0
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """Online-softmax scan over KV blocks -> (out, lse (B, H, Lq) f32).

    The plain version of the flash kernel: f32 scores and accumulators, p
    rounded to the value dtype before p·v, as the TPU kernel does. A block
    that does not tile Lk becomes one block (the JAX package's rule).
    causal masks key positions after the query's; window > 0 (with
    causal) also masks keys window or more positions older."""
    b, lq, h, d = q.shape
    lk = k.shape[1]
    block = min(block, lk)
    if lk % block:
        block = lk
    scale = 1.0 / math.sqrt(d)
    qf = q.float()
    o = torch.zeros((b, lq, h, d), dtype=torch.float32, device=q.device)
    m = torch.full((b, h, lq, 1), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((b, h, lq, 1), dtype=torch.float32, device=q.device)
    q_pos = torch.arange(lq, device=q.device)
    for start in range(0, lk, block):
        kb = k[:, start:start + block].float()
        vb = v[:, start:start + block]
        s = torch.einsum("blhd,bmhd->bhlm", qf, kb) * scale
        s = s + bias[..., start:start + block].float()
        if causal:
            k_pos = torch.arange(start, start + block, device=q.device)
            masked = k_pos[None, :] > q_pos[:, None]
            if window:
                masked = masked | (q_pos[:, None] - k_pos[None, :] >= window)
            s = s + torch.where(masked, NEG_INF, 0.0)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        corr = torch.exp(m - m_new)
        p = torch.exp(s - m_new)
        l = l * corr + p.sum(-1, keepdim=True)
        pv = torch.einsum("bhlm,bmhd->blhd", p.to(v.dtype).float(), vb.float())
        o = o * corr.transpose(1, 2) + pv
        m = m_new
    out = (o / l.transpose(1, 2)).to(q.dtype)
    lse = (m + torch.log(torch.clamp_min(l, 1e-30)))[..., 0]
    return out, lse


def blockwise_attention(q, k, v, bias, block: int = 256, causal: bool = False,
                        window: int = 0) -> torch.Tensor:
    """Memory-efficient attention: online softmax over KV blocks (forward
    only in this slice). window > 0 requires causal: query i sees keys in
    (i - window, i]."""
    if window and not causal:
        raise ValueError("attention window requires causal=True")
    _refuse_grad(
        "blockwise_attention has no backward yet: its FA2 custom backward "
        "is not ported (ROADMAP Queue A item 2); train through "
        "flash_attention, or call under torch.no_grad()", q, k, v, bias)
    return flash_forward_plain(q, k, v, bias, block, causal, window)[0]


def flash_forward(q, k, v, bias, block_q: int = 128, block_k: int = 128,
                  causal: bool = False, window: int = 0
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """The dispatch of the JAX package's ``_flash_forward``: (out, lse).

    One path, eager or exported: the custom op ``kftpu::flash_fwd``
    (``kernels/flash_fwd.py``). On CUDA tensors it launches the
    hand-written kernel, which tiles any shape itself; on CPU tensors it
    runs the plain version with the JAX package's geometry: block_k-wide KV
    blocks when block_q and block_k tile the sequences, else the blockwise
    fallback's default block. The raw forward has no gradient of its own:
    differentiate ``flash_attention``."""
    _refuse_grad(
        "flash_forward is the raw forward and records no gradient; "
        "differentiate flash_attention, whose backward is the flash "
        "backward", q, k, v, bias)
    lq, lk = q.shape[1], k.shape[1]
    block_q, block_k = min(block_q, lq), min(block_k, lk)
    if lq % block_q or lk % block_k:
        block_k = 256
    return flash_fwd_op(q, k, v, bias, causal, window, block_k)


def flash_backward_plain(q, k, v, bias, o, lse, g, block_k: int = 128,
                         causal: bool = False, window: int = 0,
                         want_dbias: bool = True):
    """The plain version of the flash backward: the JAX package's
    ``_flash_backward_xla`` (ring_attention.py:899) on the public layout.

    Loops over block_k-wide KV blocks (one block when block_k does not tile
    Lk), rebuilding p = exp(s − lse) from the forward's logsumexp; scores,
    D = Σ dO∘O, ds and every sum are float32, and p and ds are rounded to
    the input dtype before their products, as the kernels do. Returns
    (dq, dk, dv, dbias (B, 1, 1, Lk) or None) in the inputs' dtypes."""
    b, lq, h, d = q.shape
    lk = k.shape[1]
    block = min(block_k, lk)
    if lk % block:
        block = lk
    scale = 1.0 / math.sqrt(d)
    qf, gf = q.float(), g.float()
    lse4 = lse[..., None]                                    # (B, H, Lq, 1)
    dd = torch.einsum("blhd,blhd->bhl", gf, o.float())[..., None]
    rows = torch.arange(lq, device=q.device)[:, None]
    dq = torch.zeros((b, lq, h, d), dtype=torch.float32, device=q.device)
    dks, dvs, dbs = [], [], []
    for start in range(0, lk, block):
        kj = k[:, start:start + block].float()
        vj = v[:, start:start + block].float()
        s = torch.einsum("blhd,bmhd->bhlm", qf, kj) * scale
        s = s + bias[..., start:start + block].float()
        if causal:
            cols = torch.arange(start, start + block, device=q.device)[None]
            masked = cols > rows
            if window:
                masked = masked | (rows - cols >= window)
            s = s + torch.where(masked, NEG_INF, 0.0)
        p = torch.exp(s - lse4)                              # (B, H, Lq, bk)
        dp = torch.einsum("blhd,bmhd->bhlm", gf, vj)
        ds32 = p * (dp - dd)
        ds = ds32.to(q.dtype).float()  # onto the product in the input dtype
        p16 = p.to(q.dtype).float()
        dq += torch.einsum("bhlm,bmhd->blhd", ds, kj)
        dks.append(torch.einsum("bhlm,blhd->bmhd", ds, qf) * scale)
        dvs.append(torch.einsum("bhlm,blhd->bmhd", p16, gf))
        # bias is (B, 1, 1, Lk): reduce rows AND heads, in f32
        dbs.append(ds32.sum(2).sum(1))
    dbias = None
    if want_dbias:
        dbias = torch.cat(dbs, 1)[:, None, None, :].to(bias.dtype)
    return ((dq * scale).to(q.dtype), torch.cat(dks, 1).to(k.dtype),
            torch.cat(dvs, 1).to(v.dtype), dbias)


def flash_backward(q, k, v, bias, o, lse, g, block_q: int = 128,
                   block_k: int = 128, causal: bool = False,
                   impl: str | None = None, window: int = 0,
                   want_dbias: bool = True):
    """The dispatch of the JAX package's ``_flash_backward`` (:1296):
    (dq, dk, dv, dbias (B, 1, 1, Lk) or None).

    ``impl`` (default: KFT_FLASH_BWD_IMPL) takes the JAX package's names.
    CUDA tensors go to the hand-written kernels, which tile any shape
    themselves: "loop2" computes D inside dq and dkv from O, every other
    name computes it first with the D pre-kernel. CPU tensors run the plain
    version with block_k-wide KV blocks whatever the name."""
    impl = impl or FLASH_BWD_IMPL
    if impl not in _FLASH_BWD_IMPLS:
        raise ValueError(
            f"unknown flash backward impl {impl!r} (one of "
            f"{_FLASH_BWD_IMPLS})")
    if not q.is_cuda:
        return flash_backward_plain(q, k, v, bias, o, lse, g, block_k,
                                    causal, window, want_dbias)
    from kubeflow_tpu_torch.kernels.flash_bwd import (
        flash_bwd_dd,
        flash_bwd_dkv,
        flash_bwd_dq,
    )

    dd = None if impl == "loop2" else flash_bwd_dd(o, g)
    dq = flash_bwd_dq(q, k, v, bias, o, g, lse, dd, causal, window)
    dk, dv, dbias_bh = flash_bwd_dkv(q, k, v, bias, o, g, lse, dd, causal,
                                     window, want_dbias)
    dbias = None
    if want_dbias:  # summed over heads outside the kernels, as :1411-1413
        b, lk = bias.shape[0], bias.shape[-1]
        dbias = dbias_bh.view(b, -1, lk).sum(1)[:, None, None, :]
        dbias = dbias.to(bias.dtype)
    return dq, dk, dv, dbias


def _readable(*ts: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """The forward kernels take contiguous q, k, v whose rows they can copy
    16 bytes at a time; others get a copy (clone also realigns). Under
    torch.export a FakeTensor has no address to check: the custom op's
    CUDA implementation makes the same copies when the program runs."""
    if torch.compiler.is_exporting():
        return ts
    return tuple(readable(t) for t in ts)


class _FlashAttention(torch.autograd.Function):
    """``_flash`` with its custom VJP (``_flash_fwd``/``_flash_bwd``,
    :1416-1449): the forward saves q, k, v, bias, O and lse; the backward
    rebuilds p from lse, with no forward replay and no O(L²) residual. q,
    k, v and dO that the kernels cannot read in place are copied first
    (``kernels/_layout.readable_in_place``)."""

    @staticmethod
    def forward(ctx, q, k, v, bias, block_q, block_k, causal, window):
        q, k, v = _readable(q, k, v)
        out, lse = flash_forward(q, k, v, bias, block_q, block_k, causal,
                                 window)
        ctx.save_for_backward(q, k, v, bias, out, lse)
        ctx.geometry = (block_q, block_k, causal, window)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, bias, out, lse = ctx.saved_tensors
        block_q, block_k, causal, window = ctx.geometry
        if not readable_in_place(g):  # a copy the kernels can read
            g = g.clone(memory_format=torch.contiguous_format)
        dq, dk, dv, dbias = flash_backward(
            q, k, v, bias, out, lse, g, block_q, block_k, causal,
            window=window, want_dbias=ctx.needs_input_grad[3])
        return dq, dk, dv, dbias, None, None, None, None


def flash_attention(q, k, v, bias, dropout_rng=None, dropout_rate=0.0,
                    block: int = 128, causal: bool = False,
                    window: int = 0) -> torch.Tensor:
    """Flash attention (single device), forward and backward. Attention
    dropout is refused; window > 0 (requires causal) is the Mistral sliding
    window, whose wholly out-of-window tiles the kernels skip in forward
    and backward."""
    if dropout_rate:
        raise NotImplementedError(
            "attention dropout unsupported in flash path")
    if window and not causal:
        raise ValueError("attention window requires causal=True")
    if not (torch.is_grad_enabled()
            and any(t.requires_grad for t in (q, k, v, bias))):
        # nothing to differentiate (serving, an exported predictor): the
        # forward alone, with no autograd.Function for torch.export to trace
        q, k, v = _readable(q, k, v)
        return flash_forward(q, k, v, bias, block, block, causal, window)[0]
    return _FlashAttention.apply(q, k, v, bias, block, block, causal, window)
