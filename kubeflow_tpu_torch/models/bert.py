"""BERT encoder family — counterpart of ``kubeflow_tpu/models/bert.py``.

Post-LN encoder blocks with pluggable attention: "dense" (this file, with
attention dropout under a per-block device seed), "flash"
(``parallel/ring_attention.flash_attention``: on the card the hand-written
kernels, non-causal, under the padding bias), or "ring"/"ulysses", which
shard the sequence over a gang's context axis (``parallel.mesh.
context_axis``): a rank then holds L/ctx positions of every row, numbered
globally, the padding bias of its keys travels with them, and the
classifier's [CLS] row, which context rank 0 holds, is broadcast to the
axis. Padding is derived inside the model (``pad_token_id``), as an
additive −1e9 bias of shape (B, 1, 1, L).

Parameters are float32 in flax's names and layouts (``encoder/layer_0/
attention/query/kernel`` (hidden, heads, head_dim), ...; ``convert.py``);
each layer computes in ``cfg.dtype``. ``train=True`` applies dropout at
``cfg.dropout_rate`` with masks that are functions of device seeds
(``layers.dropout``; the hand-written kernel on the card), one per block
and one each for the embedding and the pooler, taken from the step's
``layers.DropoutSeeds`` or drawn from a CPU generator. With
``moe_experts`` every block's MLP is an ``MoeMlp`` (``parallel/moe.py``).
The JAX package's ``constrain`` pins activations to the batch split for
XLA; a gang member here holds its own rows only, so it has no
counterpart. GPT imports ``_resolve_attention`` from here.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable

import torch
import torch.nn.functional as F
from torch import nn

from kubeflow_tpu_torch.parallel.mesh import (
    AXIS_FSDP,
    AXIS_MODEL,
    ContextAxis,
    current_context_axis,
)
from kubeflow_tpu_torch.parallel.moe import MOE_PARTITION_RULES, MoeMlp
from kubeflow_tpu_torch.parallel.partitioner import P
from kubeflow_tpu_torch.models.layers import (
    DTYPES,
    Dense,
    DenseGeneral,
    LayerNorm,
    VocabEmbed,
    block_seeds,
    dropout,
    init_module_weights,
    remat,
    with_compute_dtype,
)
from kubeflow_tpu_torch.train.data import IGNORE_LABEL
from kubeflow_tpu_torch.train.losses import WeightedTokens
from kubeflow_tpu_torch.utils.device import select_device

#: the JAX package's rules, on flax paths (``parallel/partitioner.py``)
PARTITION_RULES: list[tuple[str, P]] = [
    (r"(query|key|value)/kernel$", P(AXIS_FSDP, AXIS_MODEL)),
    (r"attn_out/kernel$", P(AXIS_MODEL, AXIS_FSDP)),
    (r"mlp_up/kernel$", P(AXIS_FSDP, AXIS_MODEL)),
    (r"mlp_down/kernel$", P(AXIS_MODEL, AXIS_FSDP)),
    (r"token_embed/embedding$", P(AXIS_MODEL, AXIS_FSDP)),
    (r"(position_embed|type_embed)/embedding$", P(None, AXIS_FSDP)),
    (r"pooler/kernel$", P(AXIS_FSDP, AXIS_MODEL)),
    (r"mlm_dense/kernel$", P(AXIS_FSDP, AXIS_MODEL)),
    *MOE_PARTITION_RULES,
]


def dense_attention(q, k, v, bias, dropout_rng=None, dropout_rate=0.0,
                    block=None):
    """Reference softmax attention: (B, L, H, D) tensors, additive bias.
    With a seed or generator (``dropout_rng``) and dropout_rate > 0 the
    probabilities are dropped out (``layers.dropout``, the seed's site
    0)."""
    scores = torch.einsum("blhd,bmhd->bhlm", q, k) / math.sqrt(q.shape[-1])
    if bias is not None:
        scores = scores + bias
    probs = torch.softmax(scores.float(), dim=-1).to(q.dtype)
    if dropout_rng is not None and dropout_rate > 0.0:
        probs = dropout(probs, dropout_rate, dropout_rng)
    return torch.einsum("bhlm,bmhd->blhd", probs, v)


def _resolve_attention(kind: str) -> Callable:
    if kind == "dense":
        return dense_attention
    if kind == "flash":
        from kubeflow_tpu_torch.parallel.ring_attention import flash_attention

        return flash_attention
    if kind in ("ring", "ulysses"):
        from kubeflow_tpu_torch.parallel import ring_attention as ra

        return {"ring": ra.ring_attention,
                "ulysses": ra.ulysses_attention}[kind]
    raise ValueError(f"unknown attention kind {kind!r}")


@dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    mlp_dim: int = 3072
    max_len: int = 512
    dropout_rate: float = 0.1
    pad_token_id: int = 0
    dtype: str = "float32"      # compute dtype: float32 | bfloat16
    attention: str = "dense"    # dense | flash | ring | ulysses
    attention_block: int = 128
    # recompute each encoder block in the backward (torch.utils.checkpoint)
    remat: bool = False
    moe_experts: int = 0        # > 0: every block's MLP an MoeMlp
    moe_top_k: int = 2
    moe_capacity_factor: float = 2.0

    def __post_init__(self):
        # fail fast on malformed architectures: a non-dividing head count
        # would silently train a truncated model (head_dim floor-divides)
        if self.hidden_size % self.num_heads:
            raise ValueError(
                f"hidden_size {self.hidden_size} not divisible by "
                f"num_heads {self.num_heads}"
            )
        if self.dtype not in DTYPES:
            raise ValueError(
                f"dtype {self.dtype!r} is not one of {sorted(DTYPES)}")

    @property
    def torch_dtype(self) -> torch.dtype:
        return DTYPES[self.dtype]

    @staticmethod
    def base(**kw) -> "BertConfig":
        return BertConfig(**kw)

    @staticmethod
    def tiny(**kw) -> "BertConfig":
        d = dict(vocab_size=1024, hidden_size=64, num_layers=2, num_heads=4,
                 mlp_dim=128, max_len=128)
        d.update(kw)
        return BertConfig(**d)


def padding_bias(mask: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """(B, L) keep-mask -> the additive (B, 1, 1, L) bias: 0 where kept,
    −1e9 where padded, in the compute dtype."""
    return torch.where(mask[:, None, None, :], 0.0, -1e9).to(dtype)


class SelfAttention(nn.Module):
    def __init__(self, c: BertConfig, device: torch.device):
        super().__init__()
        self.cfg = c
        dt, hd = c.torch_dtype, c.hidden_size // c.num_heads
        for name in ("query", "key", "value"):
            self.add_module(name, DenseGeneral(
                c.hidden_size, (c.num_heads, hd), True, dt, device))
        self.attn_out = DenseGeneral((c.num_heads, hd), c.hidden_size, True,
                                     dt, device)

    def forward(self, x, bias, train: bool, generator=None):
        c = self.cfg
        q, k, v = self.query(x), self.key(x), self.value(x)
        attn_fn = _resolve_attention(c.attention)
        y = attn_fn(q, k, v, bias, dropout_rng=generator,
                    dropout_rate=c.dropout_rate if train else 0.0,
                    block=c.attention_block)
        return self.attn_out(y)


class BertLayer(nn.Module):
    """Post-LN transformer block (original BERT residual structure)."""

    def __init__(self, c: BertConfig, device: torch.device):
        super().__init__()
        self.cfg = c
        dt = c.torch_dtype
        self.attention = SelfAttention(c, device)
        self.ln_attn = LayerNorm(c.hidden_size, compute_dtype=dt,
                                 device=device)
        if c.moe_experts:
            self.moe = MoeMlp(c.hidden_size, c.mlp_dim, c.moe_experts,
                              c.moe_top_k, c.moe_capacity_factor,
                              device=device)
        else:
            self.mlp_up = Dense(c.hidden_size, c.mlp_dim, True, dt, device)
            self.mlp_down = Dense(c.mlp_dim, c.hidden_size, True, dt,
                                  device)
        self.ln_mlp = LayerNorm(c.hidden_size, compute_dtype=dt,
                                device=device)

    def forward(self, x, bias, train: bool = False,
                seed: torch.Tensor | None = None):
        """seed (training with dropout, a 0-dim int64 on x's device): the
        block's masks are functions of it — dense attention's
        probabilities' (site 0), the attention output's (1) and the MLP
        output's (2)."""
        rate = self.cfg.dropout_rate if train else 0.0
        y = self.attention(x, bias, train, seed)
        x = self.ln_attn(x + dropout(y, rate, seed, site=1, sequence=True))
        if self.cfg.moe_experts:
            y = self.moe(x)
        else:
            y = F.gelu(self.mlp_up(x), approximate="tanh")  # flax nn.gelu
            y = self.mlp_down(y)
        return self.ln_mlp(x + dropout(y, rate, seed, site=2, sequence=True))


class BertEmbeddings(nn.Module):
    """Token + position + type embeddings with the post-embedding LN.
    ``token_embed`` may be a VocabEmbed owned elsewhere (the MLM head's
    tied table): it is then used here but not registered here."""

    def __init__(self, c: BertConfig, device: torch.device,
                 token_embed: VocabEmbed | None = None):
        super().__init__()
        self.cfg = c
        dt = c.torch_dtype
        if token_embed is None:
            self.token_embed = VocabEmbed(c.vocab_size, c.hidden_size, dt,
                                          device)
        else:
            self._shared = (token_embed,)  # a tuple: not a submodule
        self.position_embed = VocabEmbed(c.max_len, c.hidden_size, dt, device)
        self.type_embed = VocabEmbed(2, c.hidden_size, dt, device)
        self.ln_embed = LayerNorm(c.hidden_size, compute_dtype=dt,
                                  device=device)

    def tokens(self) -> VocabEmbed:
        return self._shared[0] if "token_embed" not in self._modules \
            else self.token_embed

    def forward(self, input_ids, train: bool = False, token_type_ids=None,
                seed: torch.Tensor | None = None):
        x = self.tokens()(input_ids)
        axis = current_context_axis()
        l, dev = input_ids.shape[1], input_ids.device
        pos = (torch.arange(l, device=dev) if axis is None
               else axis.positions(l, dev))
        x = x + self.position_embed(pos[None, :])
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        x = x + self.type_embed(token_type_ids)
        x = self.ln_embed(x)
        rate = self.cfg.dropout_rate if train else 0.0
        return dropout(x, rate, seed, sequence=True)


class BertEncoder(nn.Module):
    """Embeddings + transformer stack; returns (B, L, H) hidden states.

    forward(input_ids, train, token_type_ids, generator): with ``train``
    and dropout, seeds for the embedding and each block are taken from
    ``generator`` (``layers.block_seeds``); with ``cfg.remat`` each block
    is recomputed in the backward (torch.utils.checkpoint)."""

    PREFERRED_COMPUTE_DTYPE = "bfloat16"

    def __init__(self, cfg: BertConfig, device: str | torch.device = "cuda",
                 token_embed: VocabEmbed | None = None):
        super().__init__()
        _resolve_attention(cfg.attention)  # refuses an unknown kind
        dev = select_device(device)
        self.cfg = cfg
        self.embeddings = BertEmbeddings(cfg, dev, token_embed)
        for i in range(cfg.num_layers):
            self.add_module(f"layer_{i}", BertLayer(cfg, dev))

    def init_weights(self, generator: torch.Generator) -> "BertEncoder":
        init_module_weights(self, generator)
        return self

    def layers(self) -> list[BertLayer]:
        return [getattr(self, f"layer_{i}") for i in range(self.cfg.num_layers)]

    def forward(self, input_ids, train: bool = False, token_type_ids=None,
                generator=None):
        c = self.cfg
        if current_context_axis() is not None:
            from kubeflow_tpu_torch.models.gpt import refuse_context

            refuse_context(c.attention)
        seeds = block_seeds(c.num_layers + 1, train, c.dropout_rate,
                            generator, input_ids.device)
        x = self.embeddings(input_ids, train, token_type_ids, seeds[0])
        bias = padding_bias(input_ids != c.pad_token_id, x.dtype)
        for layer, seed in zip(self.layers(), seeds[1:]):
            if c.remat and torch.is_grad_enabled():
                x = remat(layer, x, bias, train, seed)
            else:
                x = layer(x, bias, train, seed)
        return x

    with_compute_dtype = with_compute_dtype


class BertForSequenceClassification(nn.Module):
    """[CLS]-pooled classifier (tanh pooler) -> (B, num_classes) float32
    logits — the fine-tune head."""

    PREFERRED_COMPUTE_DTYPE = "bfloat16"

    def __init__(self, cfg: BertConfig, num_classes: int = 2,
                 device: str | torch.device = "cuda"):
        super().__init__()
        self.cfg = cfg
        dev, dt = select_device(device), cfg.torch_dtype
        self.encoder = BertEncoder(cfg, dev)
        self.pooler = Dense(cfg.hidden_size, cfg.hidden_size, True, dt, dev)
        self.classifier = Dense(cfg.hidden_size, num_classes, True, dt, dev)

    def init_weights(self, generator: torch.Generator
                     ) -> "BertForSequenceClassification":
        init_module_weights(self, generator)
        return self

    with_compute_dtype = with_compute_dtype

    def forward(self, input_ids, train: bool = False,
                generator=None) -> torch.Tensor:
        seed = block_seeds(1, train, self.cfg.dropout_rate, generator,
                           input_ids.device)[0]
        x = self.encoder(input_ids, train, generator=generator)
        cls = x[:, 0]
        axis = current_context_axis()
        if axis is not None:  # [CLS] is position 0: context rank 0's
            cls = _FromFirst.apply(cls, axis)
        pooled = torch.tanh(self.pooler(cls))
        pooled = dropout(pooled, self.cfg.dropout_rate if train else 0.0,
                         seed)
        return self.classifier(pooled).float()


class _FromFirst(torch.autograd.Function):
    """The tensor of the context axis' first rank on every rank (a
    broadcast in the context group); the backward sums the ranks'
    cotangents onto the first rank, whose input alone was used."""

    @staticmethod
    def forward(ctx, x, axis: ContextAxis):
        import torch.distributed as dist

        ctx.axis = axis
        x = x.contiguous().clone()
        dist.broadcast(x, axis.ranks[0], group=axis.group)
        return x

    @staticmethod
    def backward(ctx, g):
        import torch.distributed as dist

        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.axis.group)
        return (g if ctx.axis.index == 0 else torch.zeros_like(g)), None


class BertForMaskedLM(nn.Module):
    """MLM head with tied input embeddings -> (B, L, vocab) float32
    logits."""

    PREFERRED_COMPUTE_DTYPE = "bfloat16"

    def __init__(self, cfg: BertConfig, device: str | torch.device = "cuda"):
        super().__init__()
        self.cfg = cfg
        dev, dt = select_device(device), cfg.torch_dtype
        self.token_embed = VocabEmbed(cfg.vocab_size, cfg.hidden_size, dt,
                                      dev)
        self.encoder = BertEncoder(cfg, dev, token_embed=self.token_embed)
        self.mlm_dense = Dense(cfg.hidden_size, cfg.hidden_size, True, dt,
                               dev)
        self.mlm_ln = LayerNorm(cfg.hidden_size, compute_dtype=dt,
                                device=dev)
        self.mlm_bias = nn.Parameter(torch.zeros(cfg.vocab_size, device=dev))
        self.compute_dtype = dt

    def init_weights(self, generator: torch.Generator) -> "BertForMaskedLM":
        init_module_weights(self, generator)
        with torch.no_grad():
            self.mlm_bias.zero_()
        return self

    with_compute_dtype = with_compute_dtype

    def forward(self, input_ids, train: bool = False,
                generator=None) -> torch.Tensor:
        x = self.encoder(input_ids, train, generator=generator)
        x = F.gelu(self.mlm_dense(x), approximate="tanh")
        x = self.mlm_ln(x)
        logits = self.token_embed.attend(x)  # tied output projection
        return (logits + self.mlm_bias.to(self.compute_dtype)).float()


# --------------------------------------------------------------- MLM training


def _masked_token_losses(logits, labels):
    w = (labels != IGNORE_LABEL).float()
    safe = torch.where(labels == IGNORE_LABEL, 0, labels).long()
    per_tok = F.cross_entropy(logits.float().reshape(-1, logits.shape[-1]),
                              safe.reshape(-1), reduction="none")
    return per_tok.view(labels.shape), w, safe


def masked_lm_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """BERT pretraining objective: cross entropy at masked positions only.

    labels: (B, L) int — original token ids at masked positions,
    IGNORE_LABEL elsewhere (train/data.py mask_tokens_for_mlm builds them)."""
    per_tok, w, _ = _masked_token_losses(logits, labels)
    return (per_tok * w).sum() / w.sum().clamp_min(1.0)


def masked_lm_eval_metrics(logits: torch.Tensor, labels: torch.Tensor):
    """Per-example (masked loss, masked accuracy) — the Trainer's eval
    contract."""
    per_tok, w, safe = _masked_token_losses(logits, labels)
    denom = w.sum(-1).clamp_min(1.0)
    per_ex = (per_tok * w).sum(-1) / denom
    acc = ((logits.argmax(-1) == safe).float() * w).sum(-1) / denom
    return per_ex, acc


def _masked_token_sums(logits, labels):
    """The per-row (Σ loss·w, Σ hit·w, Σ w) over the masked positions."""
    per_tok, w, safe = _masked_token_losses(logits, labels)
    hit = (logits.argmax(-1) == safe).float()
    return (per_tok * w).sum(-1), (hit * w).sum(-1), w.sum(-1)


# the gang's form of both (train/losses.py): MLM labels are the positions'
# own, so they need no shift
masked_lm_loss.weighted = masked_lm_eval_metrics.weighted = WeightedTokens(
    _masked_token_sums, shift=0, fill=IGNORE_LABEL)


def _shards_sequence(self) -> bool:
    """Whether the model trains under a context axis: its attention is
    ring or Ulysses attention."""
    return self.cfg.attention in ("ring", "ulysses")


for _cls in (BertEncoder, BertForSequenceClassification, BertForMaskedLM):
    _cls.PARTITION_RULES = PARTITION_RULES
    _cls.shards_sequence = property(_shards_sequence)
