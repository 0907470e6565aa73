"""The (sum, count) form of a weighted token loss, which a gang reduces.

A token loss such as ``causal_lm_loss`` (pad labels weigh 0) or
``masked_lm_loss`` (only masked positions weigh) is a weighted mean: Σ
per-token loss · w / Σ w over the whole batch. The JAX package computes it
once over the global batch. A gang member holds only some of the tokens
(its rows on the data-like axes, its chunk of every row on the context
axis), so the mean of the members' own means is another objective whenever
their weights differ. ``WeightedTokens`` gives the Trainer the parts a gang
reduces instead: per-row sums of the loss, of the hits and of the weights
over this member's positions, on labels aligned to the logits' positions.

The plain functions (``causal_lm_loss(logits, labels)``) keep their value;
the form is an attribute, ``fn.weighted``, shared by a loss and its eval
twin.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch


@dataclass(frozen=True)
class WeightedTokens:
    """``sums(logits, aligned)`` -> (loss, hits, weight), each (B,): the
    per-row sums of per-token loss · w, hit · w and w over the positions
    this member holds. ``aligned`` are the labels of the logits' own
    positions: ``align(labels)`` shifts the batch's labels left by
    ``shift`` positions (a causal LM's next token) over the whole sequence,
    filling the end with ``fill``, a label of weight 0, so that a chunk of
    the aligned labels goes with the same chunk of the sequence."""

    sums: Callable
    shift: int = 0
    fill: int = 0

    def align(self, labels, dim: int = 1) -> torch.Tensor:
        labels = torch.as_tensor(labels)
        if not self.shift:
            return labels
        n = labels.shape[dim]
        tail = torch.full_like(labels.narrow(dim, 0, self.shift), self.fill)
        return torch.cat([labels.narrow(dim, self.shift, n - self.shift),
                          tail], dim=dim)


__all__ = ["WeightedTokens"]
