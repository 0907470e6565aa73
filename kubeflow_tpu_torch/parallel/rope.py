"""Rotary position embedding — counterpart of
``kubeflow_tpu/parallel/rope.py``."""

from __future__ import annotations

import torch


def apply_rope(x: torch.Tensor, pos: torch.Tensor,
               theta: float = 10000.0) -> torch.Tensor:
    """Rotary position embedding (half-split convention): rotate each
    head-dim pair by pos * theta^(-2i/d), computed in f32.

    x: (B, L, H, D); pos: (L,) shared across the batch, or (B, L) per row
    (decode, where rows may sit at different depths)."""
    d = x.shape[-1]
    freqs = theta ** (-torch.arange(0, d, 2, dtype=torch.float32,
                                    device=x.device) / d)
    ang = pos.to(torch.float32)[..., None] * freqs    # (..., L, D/2)
    if ang.ndim == 2:                                 # shared (L, D/2)
        ang = ang[None]
    cos = torch.cos(ang)[:, :, None, :]               # (B|1, L, 1, D/2)
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x.to(torch.float32).chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)
