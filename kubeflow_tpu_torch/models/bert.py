"""The parts of ``kubeflow_tpu/models/bert.py`` that the GPT family imports.

``VocabEmbed`` (token/position lookup plus ``attend`` for the tied head),
``dense_attention`` and ``_resolve_attention``. The JAX package's
``constrain`` is a sharding pin that is a no-op without a mesh; the port has
no mesh yet, so it has no counterpart. The BERT encoder itself is a later
slice.
"""

from __future__ import annotations

import math
from typing import Callable

import torch
from torch import nn


class VocabEmbed(nn.Embedding):
    """flax ``nn.Embed(dtype=compute_dtype)``: a float32 table
    (num_embeddings, features), looked up and returned in the compute
    dtype, and ``attend`` (x @ tableᵀ, both in the compute dtype) for a
    weight-tied output head."""

    def __init__(self, num_embeddings: int, features: int,
                 compute_dtype: torch.dtype = torch.float32,
                 device: torch.device | None = None):
        super().__init__(num_embeddings, features, device=device,
                         dtype=torch.float32)
        self.compute_dtype = compute_dtype

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        # gather, then cast: the same values as casting the whole table
        return super().forward(ids).to(self.compute_dtype)

    def attend(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        return x.to(dt) @ self.weight.to(dt).T


def dense_attention(q, k, v, bias, dropout_rng=None, dropout_rate=0.0,
                    block=None):
    """Reference softmax attention: (B, L, H, D) tensors, additive bias."""
    if dropout_rate:
        raise NotImplementedError("attention dropout is a training feature")
    scores = torch.einsum("blhd,bmhd->bhlm", q, k) / math.sqrt(q.shape[-1])
    if bias is not None:
        scores = scores + bias
    probs = torch.softmax(scores.float(), dim=-1).to(q.dtype)
    return torch.einsum("bhlm,bmhd->blhd", probs, v)


def _resolve_attention(kind: str) -> Callable:
    if kind == "dense":
        return dense_attention
    if kind == "flash":
        from kubeflow_tpu_torch.parallel.ring_attention import flash_attention

        return flash_attention
    if kind in ("ring", "ulysses"):
        raise NotImplementedError(
            f"{kind} attention shards the sequence over a device mesh; it is "
            "ported with the parallelism slice (ROADMAP Queue A item 8)")
    raise ValueError(f"unknown attention kind {kind!r}")
