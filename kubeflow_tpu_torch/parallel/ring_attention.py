"""Single-device attention — counterpart of
``kubeflow_tpu/parallel/ring_attention.py``.

This slice ports the forward surface that serving reaches:

  blockwise_attention  the plain online-softmax scan over KV blocks (the
                       numerics reference of the flash kernel)
  flash_attention      the public flash entry point; on CUDA tensors it
                       launches the hand-written Hopper kernel
                       (csrc/flash_fwd.cu), on CPU tensors it runs the plain
                       version

All take the JAX package's layout: q/k/v (B, L, H, D), bias (B, 1, 1, Lk)
additive, out (B, L, H, D). Ring and Ulysses attention, the backward
kernels and the KFT_FLASH_* tuning variables come with later slices; until
the training slice, an input that requires grad is refused.
"""

from __future__ import annotations

import math

import torch

NEG_INF = -1e9


def _refuse_grad(*tensors: torch.Tensor) -> None:
    if any(t.requires_grad for t in tensors):
        raise NotImplementedError(
            "flash attention backward is not ported yet: the backward kernels"
            " come with the training slice (ROADMAP Queue B). Call under "
            "torch.no_grad() or torch.inference_mode().")


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
    _refuse_grad(q, k, v, bias)
    return flash_forward_plain(q, k, v, bias, block, causal, window)[0]


def flash_forward(q, k, v, bias, block_q: int = 128, block_k: int = 128,
                  causal: bool = False, window: int = 0
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """The dispatch of the JAX package's ``_flash_forward``: (out, lse).

    CUDA tensors go to the hand-written kernel, which tiles any shape
    itself. CPU tensors run the plain version with the JAX package's
    geometry: block_k-wide KV blocks when block_q and block_k tile the
    sequences, else the blockwise fallback's default block."""
    _refuse_grad(q, k, v, bias)
    if q.is_cuda:
        from kubeflow_tpu_torch.kernels.flash_fwd import flash_fwd

        return flash_fwd(q, k, v, bias, causal, window)
    lq, lk = q.shape[1], k.shape[1]
    block_q, block_k = min(block_q, lq), min(block_k, lk)
    if lq % block_q or lk % block_k:
        block_k = 256
    return flash_forward_plain(q, k, v, bias, block_k, causal, window)


def flash_attention(q, k, v, bias, dropout_rng=None, dropout_rate=0.0,
                    block: int = 128, causal: bool = False,
                    window: int = 0) -> torch.Tensor:
    """Flash attention (single device). Attention dropout is refused;
    window > 0 (requires causal) is the Mistral sliding window, whose
    wholly out-of-window KV tiles the kernel skips."""
    if dropout_rate:
        raise NotImplementedError(
            "attention dropout unsupported in flash path")
    if window and not causal:
        raise ValueError("attention window requires causal=True")
    return flash_forward(q, k, v, bias, block, block, causal, window)[0]
