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
    """Embedding table (num_embeddings, features): lookup, and ``attend``
    (x @ tableᵀ) for a weight-tied output head."""

    def attend(self, x: torch.Tensor) -> torch.Tensor:
        return x @ self.weight.to(x.dtype).T


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
