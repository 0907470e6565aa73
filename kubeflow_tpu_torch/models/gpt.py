"""GPT, the decoder-only causal LM — counterpart of
``kubeflow_tpu/models/gpt.py``.

Pre-LN transformer decoder (GPT-2 shape), learned OR rotary positions,
optional grouped-query attention (num_kv_heads), sliding-window attention,
LayerNorm/GELU or RMSNorm/SwiGLU, tied or untied head; inference and
training (``train=True``: residual, embedding and dense-attention dropout
whose masks are functions of per-block device seeds, ``remat`` per block).

Parameters are float32 whatever ``cfg.dtype``, as flax keeps them
(``param_dtype``); each layer casts its weight and its input to the compute
dtype ``cfg.dtype`` at use, as ``nn.Dense(dtype=...)`` and
``nn.Embed(dtype=...)`` do, and the norms take their statistics in float32
and return the compute dtype.

Under a gang's context axis (``parallel.mesh.context_axis``) a rank holds
L/ctx positions of every row, from the embedding to the logits: learned
positions and rope take global positions, and only ring or Ulysses
attention communicates.

Decoding keeps the JAX package's static-shape cache: one (B, C, KVH, D)
buffer per layer written at a per-row index and attended under a position
mask. The port updates the cache in place (the JAX package returns a new
one), which is what lets a decode step allocate nothing.
"""

from __future__ import annotations

import copy
import dataclasses
import itertools
import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from kubeflow_tpu_torch.models.bert import _resolve_attention
from kubeflow_tpu_torch.models.layers import (
    DTYPES,
    VocabEmbed,
    block_seeds,
    dropout,
    linear_then_bias,
    remat,
)
from kubeflow_tpu_torch.parallel.mesh import (
    AXIS_FSDP,
    AXIS_MODEL,
    current_context_axis,
)
from kubeflow_tpu_torch.parallel.moe import MOE_PARTITION_RULES, MoeMlp
from kubeflow_tpu_torch.parallel.partitioner import P
from kubeflow_tpu_torch.parallel.rope import apply_rope
from kubeflow_tpu_torch.train.losses import WeightedTokens
from kubeflow_tpu_torch.utils.device import select_device

#: the JAX package's rules, on flax paths (``parallel/partitioner.py``)
PARTITION_RULES: list[tuple[str, P]] = [
    (r"(query|key|value)/kernel$", P(AXIS_FSDP, AXIS_MODEL)),
    (r"attn_out/kernel$", P(AXIS_MODEL, AXIS_FSDP)),
    (r"(mlp_up|mlp_gate)/kernel$", P(AXIS_FSDP, AXIS_MODEL)),
    (r"mlp_down/kernel$", P(AXIS_MODEL, AXIS_FSDP)),
    (r"token_embed/embedding$", P(AXIS_MODEL, AXIS_FSDP)),
    (r"lm_head/kernel$", P(AXIS_FSDP, AXIS_MODEL)),
    (r"position_embed/embedding$", P(None, AXIS_FSDP)),
    *MOE_PARTITION_RULES,
]

# Decode blocks at or under this many tokens route MoE DROPLESS (every
# expert on every token: row-independent, exact for continuous batching);
# longer blocks (prompt prefill) keep the routed capacity dispatch, whose
# FLOPs scale with top_k, not num_experts. The engine prefills batch-1, so
# a routed prefill is row-independent there, and solo generate() takes the
# same branch per shape.
MOE_DROPLESS_MAX_LEN = 16


@dataclass(frozen=True)
class GPTConfig:
    vocab_size: int = 50257
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    # grouped-query attention: K/V projected to this many heads, each
    # shared by num_heads/num_kv_heads query heads. 0 = num_heads (MHA)
    num_kv_heads: int = 0
    position_embedding: str = "learned"   # learned (GPT-2) | rope
    rope_theta: float = 10000.0
    # rolling decode cache of this many slots (requires attention_window);
    # 0 = a full max_len-deep cache
    kv_cache_capacity: int = 0
    # sliding window: each query sees at most this many positions (itself
    # included); 0 = full causal
    attention_window: int = 0
    mlp_dim: int = 3072
    max_len: int = 1024
    dropout_rate: float = 0.1   # applied only with train=True
    dtype: str = "float32"      # compute dtype: float32 | bfloat16
    attention: str = "dense"    # dense | flash | ring | ulysses
    attention_block: int = 128
    norm: str = "layernorm"     # layernorm | rmsnorm
    activation: str = "gelu"    # gelu | swiglu
    use_bias: bool = True
    tie_embeddings: bool = True
    norm_eps: float = 1e-6
    remat: bool = False
    moe_experts: int = 0
    moe_top_k: int = 2
    moe_capacity_factor: float = 2.0

    def __post_init__(self):
        if self.hidden_size % self.num_heads:
            raise ValueError(
                f"hidden_size {self.hidden_size} not divisible by "
                f"num_heads {self.num_heads}"
            )
        if self.num_kv_heads and (
                self.num_kv_heads < 0
                or self.num_heads % self.num_kv_heads):
            raise ValueError(
                f"num_kv_heads {self.num_kv_heads} must be a positive "
                f"divisor of num_heads {self.num_heads} (or 0 for MHA)"
            )
        if self.position_embedding not in ("learned", "rope"):
            raise ValueError(
                f"position_embedding {self.position_embedding!r} "
                "(learned|rope)")
        if self.position_embedding == "rope":
            if (self.hidden_size // self.num_heads) % 2:
                raise ValueError(
                    "rope needs an even head_dim "
                    f"(got {self.hidden_size // self.num_heads})")
        if self.attention_window:
            if self.attention_window < 1:
                raise ValueError(
                    f"attention_window {self.attention_window} must be "
                    ">= 1 (or 0 for full causal)")
            if self.attention not in ("dense", "flash", "ring", "ulysses"):
                raise ValueError(
                    "attention_window composes with dense/flash/ring/"
                    f"ulysses + decode (got attention={self.attention!r})")
        if self.kv_cache_capacity:
            if not self.attention_window:
                raise ValueError(
                    "kv_cache_capacity (rolling decode cache) requires "
                    "attention_window — without a window, arbitrarily old "
                    "keys stay visible and may never be evicted")
            if self.kv_cache_capacity < self.attention_window:
                raise ValueError(
                    f"kv_cache_capacity {self.kv_cache_capacity} < "
                    f"attention_window {self.attention_window}: a slot "
                    "would be evicted while still inside every query's "
                    "window")
            if self.kv_cache_capacity >= self.max_len:
                raise ValueError(
                    f"kv_cache_capacity {self.kv_cache_capacity} >= "
                    f"max_len {self.max_len}: rolling would only cost "
                    "masking math — leave it 0 for the plain full cache")
        if self.moe_experts and self.moe_top_k > self.moe_experts:
            raise ValueError(
                f"moe_top_k {self.moe_top_k} > moe_experts "
                f"{self.moe_experts}"
            )
        if self.norm not in ("layernorm", "rmsnorm"):
            raise ValueError(f"norm {self.norm!r} is not layernorm|rmsnorm")
        if self.activation not in ("gelu", "swiglu"):
            raise ValueError(
                f"activation {self.activation!r} is not gelu|swiglu")
        if self.dtype not in DTYPES:
            raise ValueError(
                f"dtype {self.dtype!r} is not one of {sorted(DTYPES)}")

    @property
    def torch_dtype(self) -> torch.dtype:
        return DTYPES[self.dtype]

    @staticmethod
    def small(**kw) -> "GPTConfig":
        return GPTConfig(**kw)  # GPT-2 small shape

    @staticmethod
    def tiny(**kw) -> "GPTConfig":
        d = dict(vocab_size=512, hidden_size=64, num_layers=2, num_heads=4,
                 mlp_dim=128, max_len=256)
        d.update(kw)
        return GPTConfig(**d)

    @staticmethod
    def llama(**kw) -> "GPTConfig":
        """Llama/Mistral-shaped decoder: RMSNorm, SwiGLU, rope, GQA,
        bias-free, untied head, at a test size unless real dims are given."""
        d = dict(vocab_size=512, hidden_size=64, num_layers=2, num_heads=4,
                 num_kv_heads=2, mlp_dim=176, max_len=256,
                 norm="rmsnorm", activation="swiglu", use_bias=False,
                 tie_embeddings=False, position_embedding="rope",
                 dropout_rate=0.0)
        d.update(kw)
        return GPTConfig(**d)


def causal_dense_attention(q, k, v, bias, dropout_rng=None, dropout_rate=0.0,
                           block=None, window: int = 0):
    """Reference causal softmax attention (numerics baseline). window > 0
    adds sliding-window masking: query i sees keys in (i - window, i].
    With a seed or generator (``dropout_rng``, as ``layers.dropout`` takes
    it) and dropout_rate > 0 the attention probabilities are dropped out
    (the seed's site 0), as in the JAX package."""
    s = torch.einsum("blhd,bmhd->bhlm", q, k) / math.sqrt(q.shape[-1])
    if bias is not None:
        s = s + bias
    lq, lk = q.shape[1], k.shape[1]
    mask = torch.tril(torch.ones((lq, lk), dtype=torch.bool, device=q.device))
    if window:
        rows = torch.arange(lq, device=q.device)[:, None]
        cols = torch.arange(lk, device=q.device)[None, :]
        mask = mask & (rows - cols < window)
    s = torch.where(mask[None, None], s.float(), -1e9)
    probs = torch.softmax(s, dim=-1).to(q.dtype)
    probs = dropout(probs, dropout_rate, dropout_rng)
    return torch.einsum("bhlm,bmhd->blhd", probs, v)


class Dense(nn.Linear):
    """flax ``nn.Dense(dtype=compute_dtype)``: float32 parameters; the input,
    the weight and the bias are cast to the compute dtype at use, and the
    bias is added after the product is rounded (``linear_then_bias``)."""

    def __init__(self, in_features: int, out_features: int, bias: bool,
                 compute_dtype: torch.dtype, device: torch.device):
        super().__init__(in_features, out_features, bias=bias, device=device,
                         dtype=torch.float32)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        return linear_then_bias(
            x.to(dt), self.weight.to(dt),
            None if self.bias is None else self.bias.to(dt))


class DecoderNorm(nn.Module):
    """The block norm: LayerNorm (GPT-2) or scale-only RMSNorm (Llama),
    computed in f32 and returned in the compute dtype, as flax's
    ``nn.LayerNorm(dtype=...)`` does; float32 parameters."""

    def __init__(self, c: GPTConfig, device: torch.device):
        super().__init__()
        self.kind, self.eps = c.norm, c.norm_eps
        self.compute_dtype = c.torch_dtype
        self.weight = nn.Parameter(torch.ones(c.hidden_size, device=device))
        self.bias = (nn.Parameter(torch.zeros(c.hidden_size, device=device))
                     if c.norm == "layernorm" and c.use_bias else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        if self.kind == "rmsnorm":
            y = xf * torch.rsqrt(xf.pow(2).mean(-1, keepdim=True) + self.eps)
            y = y * self.weight.float()
        else:
            y = F.layer_norm(
                xf, xf.shape[-1:], self.weight.float(),
                None if self.bias is None else self.bias.float(), self.eps)
        return y.to(self.compute_dtype)


@dataclass
class KVCache:
    """Decode state: per-layer (B, C, KVH, D) key/value buffers and the
    per-row count of positions written so far."""

    key: list[torch.Tensor]
    value: list[torch.Tensor]
    index: torch.Tensor   # (B,) int64

    @property
    def capacity(self) -> int:
        return self.key[0].shape[1]


def new_cache(c: GPTConfig, batch: int, device) -> KVCache:
    """An empty KV cache of configuration ``c`` for ``batch`` rows."""
    cap = c.kv_cache_capacity or c.max_len
    shape = (batch, cap, c.num_kv_heads or c.num_heads,
             c.hidden_size // c.num_heads)
    kw = {"dtype": c.torch_dtype, "device": device}
    return KVCache(
        key=[torch.zeros(shape, **kw) for _ in range(c.num_layers)],
        value=[torch.zeros(shape, **kw) for _ in range(c.num_layers)],
        index=torch.zeros((batch,), dtype=torch.int64, device=device))


class CausalSelfAttention(nn.Module):
    def __init__(self, c: GPTConfig, device: torch.device):
        super().__init__()
        self.cfg = c
        self.head_dim = c.hidden_size // c.num_heads
        self.kv_heads = c.num_kv_heads or c.num_heads
        hd, dt = self.head_dim, c.torch_dtype
        self.query = Dense(c.hidden_size, c.num_heads * hd, c.use_bias, dt,
                           device)
        self.key = Dense(c.hidden_size, self.kv_heads * hd, c.use_bias, dt,
                         device)
        self.value = Dense(c.hidden_size, self.kv_heads * hd, c.use_bias, dt,
                           device)
        self.attn_out = Dense(c.num_heads * hd, c.hidden_size, c.use_bias,
                              dt, device)
        # dense is the causal reference below; other kinds resolve when
        # the model is built
        self.attn_fn = (None if c.attention == "dense"
                        else _resolve_attention(c.attention))

    def _repeat_kv(self, k, v):
        # broadcast KV groups up to full heads before a single-shape kernel
        group = self.cfg.num_heads // self.kv_heads
        if group == 1:
            return k, v
        return (k.repeat_interleave(group, dim=2),
                v.repeat_interleave(group, dim=2))

    def _attend(self, q, k, v, bias, dropout_rng=None, **kw):
        c = self.cfg
        k, v = self._repeat_kv(k, v)
        if self.attn_fn is None:
            return causal_dense_attention(
                q, k, v, bias, dropout_rng=dropout_rng,
                dropout_rate=c.dropout_rate if dropout_rng is not None
                else 0.0, window=c.attention_window)
        if c.attention_window:
            kw["window"] = c.attention_window
        return self.attn_fn(q, k, v, bias, dropout_rng=None, dropout_rate=0.0,
                            block=c.attention_block, causal=True, **kw)

    def forward(self, x, bias, cache: KVCache | None = None, layer: int = 0,
                prefill: bool = False, dropout_rng=None):
        c = self.cfg
        b, l, _ = x.shape
        q = self.query(x).view(b, l, c.num_heads, self.head_dim)
        k = self.key(x).view(b, l, self.kv_heads, self.head_dim)
        v = self.value(x).view(b, l, self.kv_heads, self.head_dim)
        if cache is not None:
            y = self._cached_attention(q, k, v, cache, layer, prefill)
        elif c.position_embedding == "rope" and c.attention in ("ring",
                                                               "ulysses"):
            # ring and Ulysses shard the sequence: they rotate, by global
            # position, inside their exchange (JAX gpt.py:248-253)
            y = self._attend(q, k, v, bias, dropout_rng,
                             rope_theta=c.rope_theta)
        else:
            if c.position_embedding == "rope":
                pos = torch.arange(l, device=x.device)
                q = apply_rope(q, pos, c.rope_theta)
                k = apply_rope(k, pos, c.rope_theta)
            y = self._attend(q, k, v, bias, dropout_rng)
        return self.attn_out(y.reshape(b, l, c.num_heads * self.head_dim))

    def _cached_attention(self, q, k, v, cache: KVCache, layer: int,
                          prefill: bool):
        """KV-cache attention: one code path for prefill (L = prompt) and
        decode (L = 1) over the fixed buffer under a position mask, as in
        the JAX package. With prefill=True (generate's first pass: every
        row starts at index 0 with an unpadded prompt) and flash attention
        on a full cache, the prompt attends through the flash kernel over
        its own K/V instead: unwritten slots carry -1e9, whose softmax
        weight underflows to exactly 0, so the function is the same."""
        c = self.cfg
        b, l, h, d = q.shape
        kvh = k.shape[2]
        C = cache.capacity
        rolling = C < c.max_len
        cur = cache.index                                        # (B,)
        q_pos = cur[:, None] + torch.arange(l, device=q.device)  # (B, L)
        if c.position_embedding == "rope":
            # rotate by absolute position before the cache write
            q = apply_rope(q, q_pos, c.rope_theta)
            k = apply_rope(k, q_pos, c.rope_theta)
        if rolling and l > C - c.attention_window + 1:
            raise ValueError(
                f"prompt/block of {l} positions exceeds the rolling "
                f"cache's budget (capacity {C} - window "
                f"{c.attention_window} + 1 = {C - c.attention_window + 1})"
                " — raise kv_cache_capacity")
        ck, cv = cache.key[layer], cache.value[layer]
        if l == 1:
            rows = torch.arange(b, device=q.device)
            ck[rows, cur % C] = k[:, 0]
            cv[rows, cur % C] = v[:, 0]
        elif rolling:
            slots = (cur[0] + torch.arange(l, device=q.device)) % C
            ck[:, slots] = k
            cv[:, slots] = v
        else:
            # per-row block write; the start clamps so the block fits, as
            # dynamic_update_slice does
            start = cur.clamp(0, C - l)
            idx = (start[:, None] + torch.arange(l, device=q.device))
            idx = idx[:, :, None, None].expand(b, l, kvh, d)
            ck.scatter_(1, idx, k)
            cv.scatter_(1, idx, v)
        if prefill and c.attention == "flash" and not rolling:
            zero = torch.zeros((b, 1, 1, l), dtype=q.dtype, device=q.device)
            return self._attend(q, k, v, zero)
        qg = q.reshape(b, l, kvh, h // kvh, d)
        s = torch.einsum("blkgd,bmkd->bkglm", qg, ck).float()
        s = s / math.sqrt(d)
        if rolling:
            # slot j holds the newest position p ≡ j (mod C) written so far;
            # unwritten slots reconstruct to p_j < 0
            j = torch.arange(C, device=q.device)
            last = (cur + l - 1)[:, None]                        # (B, 1)
            p_j = last - ((last - j[None, :]) % C)               # (B, C)
            visible = (
                (p_j[:, None, :] >= 0)
                & (p_j[:, None, :] <= q_pos[:, :, None])
                & (q_pos[:, :, None] - p_j[:, None, :] < c.attention_window)
            )
        else:
            k_pos = torch.arange(C, device=q.device)
            visible = k_pos[None, None, :] <= q_pos[:, :, None]
            if c.attention_window:
                visible = visible & (
                    q_pos[:, :, None] - k_pos[None, None, :]
                    < c.attention_window)
        s = torch.where(visible[:, None, None], s, -1e9)
        p = torch.softmax(s, dim=-1).to(q.dtype)
        y = torch.einsum("bkglm,bmkd->blkgd", p, cv)
        return y.reshape(b, l, h, d)


class GPTBlock(nn.Module):
    """Pre-LN decoder block (GPT-2 residual structure)."""

    def __init__(self, c: GPTConfig, device: torch.device):
        super().__init__()
        self.cfg = c
        dt = c.torch_dtype
        self.ln_attn = DecoderNorm(c, device)
        self.attention = CausalSelfAttention(c, device)
        self.ln_mlp = DecoderNorm(c, device)
        if c.moe_experts:
            # the Mixtral shape: every block's MLP an MoeMlp of experts
            # with the block's activation and bias setting
            self.moe = MoeMlp(c.hidden_size, c.mlp_dim, c.moe_experts,
                              c.moe_top_k, c.moe_capacity_factor,
                              c.activation, c.use_bias, device=device)
            return
        if c.activation == "swiglu":
            self.mlp_gate = Dense(c.hidden_size, c.mlp_dim, c.use_bias, dt,
                                  device)
        self.mlp_up = Dense(c.hidden_size, c.mlp_dim, c.use_bias, dt, device)
        self.mlp_down = Dense(c.mlp_dim, c.hidden_size, c.use_bias, dt,
                              device)

    def forward(self, x, bias, cache: KVCache | None = None, layer: int = 0,
                prefill: bool = False, seed: torch.Tensor | None = None):
        """seed (training with dropout, a 0-dim int64 on x's device): the
        block's masks are functions of it — dense attention's
        probabilities' (site 0), the attention output's (1) and the MLP
        output's (2). An MoE block routes a decode block of at most
        MOE_DROPLESS_MAX_LEN tokens dropless, anything else by capacity."""
        c = self.cfg
        y = self.attention(self.ln_attn(x), bias, cache, layer, prefill, seed)
        x = x + dropout(y, c.dropout_rate, seed, site=1, sequence=True)
        h = self.ln_mlp(x)
        if c.moe_experts:
            h = self.moe(h, dropless=cache is not None
                         and h.shape[1] <= MOE_DROPLESS_MAX_LEN)
            return x + dropout(h, c.dropout_rate, seed, site=2,
                               sequence=True)
        if c.activation == "swiglu":
            h = F.silu(self.mlp_gate(h)) * self.mlp_up(h)
        else:
            h = F.gelu(self.mlp_up(h), approximate="tanh")  # flax nn.gelu
        return x + dropout(self.mlp_down(h), c.dropout_rate, seed, site=2,
                           sequence=True)


class GPTLM(nn.Module):
    """Causal language model: logits over the next token at every position.

    forward(input_ids (B, L)) -> (B, L, vocab) f32 logits; pad positions
    carry a -1e9 additive bias so they are never attended to. With a
    ``cache`` it runs one decode pass (see ``generate``); with
    ``train=True`` it applies dropout, its seeds from ``generator``.
    """

    #: the Trainer's AUTO compute dtype on the card (its counterpart in the
    #: JAX package: PREFERRED_COMPUTE_DTYPE = jnp.bfloat16)
    PREFERRED_COMPUTE_DTYPE = "bfloat16"
    PARTITION_RULES = PARTITION_RULES

    def __init__(self, cfg: GPTConfig, pad_token_id: int = 0,
                 device: str | torch.device = "cuda"):
        super().__init__()
        self.cfg = cfg
        self.pad_token_id = pad_token_id
        dev, dt = select_device(device), cfg.torch_dtype
        self.token_embed = VocabEmbed(cfg.vocab_size, cfg.hidden_size, dt,
                                      dev)
        if cfg.position_embedding == "learned":
            self.position_embed = VocabEmbed(cfg.max_len, cfg.hidden_size,
                                             dt, dev)
        self.layers = nn.ModuleList(
            GPTBlock(cfg, dev) for _ in range(cfg.num_layers))
        self.ln_final = DecoderNorm(cfg, dev)
        if not cfg.tie_embeddings:
            self.lm_head = Dense(cfg.hidden_size, cfg.vocab_size, False, dt,
                                 dev)

    @property
    def device(self) -> torch.device:
        return self.token_embed.weight.device

    @property
    def shards_sequence(self) -> bool:
        """Whether the model trains under a context axis: its attention
        is ring or Ulysses attention."""
        return self.cfg.attention in ("ring", "ulysses")

    def with_compute_dtype(self, dtype: str) -> "GPTLM":
        """This model computing in ``dtype``: a module that shares this
        one's parameters (the same float32 tensors, so training either
        trains both) and casts to ``dtype`` at use — the counterpart of
        flax's ``model.clone(cfg=replace(cfg, dtype=...))``."""
        cfg = dataclasses.replace(self.cfg, dtype=dtype)
        shared = {id(t): t for t in itertools.chain(self.parameters(),
                                                    self.buffers())}
        clone = copy.deepcopy(self, shared)
        for m in clone.modules():
            if hasattr(m, "cfg"):
                m.cfg = cfg
            if hasattr(m, "compute_dtype"):
                m.compute_dtype = cfg.torch_dtype
        return clone

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator,
                     std: float = 0.02) -> "GPTLM":
        """Seeded random init: N(0, std) weights, embeddings, MoE routers
        and experts, zero biases, unit norm scales. Draws on the generator's
        device (CPU for a CPU generator) in parameter order, so a seed
        gives the same weights on any card."""
        for name, p in self.named_parameters():
            if name.endswith("bias") or ".moe.b_" in name:
                p.zero_()
            elif ".ln_" in name or name.startswith("ln_"):
                p.fill_(1.0)
            else:
                p.copy_(torch.randn(p.shape, generator=generator,
                                    device=generator.device) * std)
        return self

    def init_cache(self, batch: int) -> KVCache:
        return new_cache(self.cfg, batch, self.device)

    def forward(self, input_ids: torch.Tensor, cache: KVCache | None = None,
                prefill: bool = False, train: bool = False,
                generator=None) -> torch.Tensor:
        """train=True applies dropout at ``cfg.dropout_rate`` (embedding,
        each block's attention and MLP outputs, and dense attention's
        probabilities); its masks are functions of device seeds, one per
        block and one for the embedding, taken from ``generator``: the
        step's ``layers.DropoutSeeds`` (the Trainer's) or a CPU
        torch.Generator they are drawn from.
        With ``cfg.remat`` each block is recomputed in the backward
        (torch.utils.checkpoint); the decode path is never wrapped."""
        c = self.cfg
        l = input_ids.shape[1]
        axis = current_context_axis()
        if axis is not None:
            refuse_context(c.attention, cache is not None)
        seeds = block_seeds(c.num_layers + 1, train, c.dropout_rate,
                            generator, input_ids.device)
        x = self.token_embed(input_ids)
        if cache is not None:
            # positions continue from each row's cache index; masking is
            # positional (generation prompts are unpadded)
            pos = cache.index[:, None] + torch.arange(l, device=x.device)
            bias = None
        else:
            # under a context axis this rank's chunk of global positions
            pos = (torch.arange(l, device=x.device) if axis is None
                   else axis.positions(l, x.device))[None, :]
            mask = input_ids != self.pad_token_id
            bias = torch.where(mask[:, None, None, :], 0.0, -1e9).to(x.dtype)
        if c.position_embedding == "learned":
            x = x + self.position_embed(pos)
        x = dropout(x, c.dropout_rate, seeds[0], sequence=True)
        for i, block in enumerate(self.layers):
            if c.remat and cache is None:
                x = remat(block, x, bias, None, i, False, seeds[i + 1])
            else:
                x = block(x, bias, cache, i, prefill, seeds[i + 1])
        if cache is not None:
            cache.index += l
        x = self.ln_final(x)
        if c.tie_embeddings:
            logits = self.token_embed.attend(x)  # weight-tied head (GPT-2)
        else:
            logits = self.lm_head(x)
        return logits.float()


def refuse_context(attention: str, decoding: bool = False) -> None:
    """Raise when a forward under a context axis of more than one rank
    cannot shard the sequence: only ring and Ulysses attention exchange
    keys across the axis, and decoding is one process's."""
    if decoding:
        raise NotImplementedError(
            "a KV-cache forward under a context axis: decoding runs on one "
            "process")
    if attention not in ("ring", "ulysses"):
        raise NotImplementedError(
            f"attention {attention!r} under a context axis: each rank holds "
            "a chunk of the sequence, and only ring and ulysses attention "
            "exchange keys across the axis")


def causal_lm_loss(logits: torch.Tensor,
                   labels: torch.Tensor) -> torch.Tensor:
    """Next-token cross entropy; labels == input_ids (the shift happens
    here), pad labels (0) are masked out of the mean."""
    per_tok, w = _shifted_token_loss(logits, labels)
    return (per_tok * w).sum() / w.sum().clamp_min(1.0)


def causal_lm_eval_metrics(logits: torch.Tensor, labels: torch.Tensor):
    """Per-example (next-token loss, next-token accuracy), each (B,) — the
    eval twin of causal_lm_loss, shifted the same way (Trainer
    eval_metrics_fn contract)."""
    per_tok, w = _shifted_token_loss(logits, labels)
    denom = w.sum(-1).clamp_min(1.0)
    hit = (logits[:, :-1].argmax(-1) == labels[:, 1:].long()).float()
    return (per_tok * w).sum(-1) / denom, (hit * w).sum(-1) / denom


def _causal_token_sums(logits, aligned):
    """The per-row (Σ loss·w, Σ hit·w, Σ w) of next-token labels already
    aligned to the logits' positions (``WeightedTokens.align``)."""
    per_tok = F.cross_entropy(
        logits.float().reshape(-1, logits.shape[-1]),
        aligned.reshape(-1).long(), reduction="none").view(aligned.shape)
    w = (aligned != 0).float()
    hit = (logits.argmax(-1) == aligned.long()).float()
    return (per_tok * w).sum(-1), (hit * w).sum(-1), w.sum(-1)


# the gang's form of both (train/losses.py): labels shift left by one over
# the whole sequence, the last position's label is the pad id 0
causal_lm_loss.weighted = causal_lm_eval_metrics.weighted = WeightedTokens(
    _causal_token_sums, shift=1, fill=0)


def _shifted_token_loss(logits, labels):
    """(per-token cross entropy (B, L-1) of position t predicting label
    t+1, its weight: 1 where that label is not the pad id 0)."""
    shift_logits = logits[:, :-1].float()
    shift_labels = labels[:, 1:].long()
    per_tok = F.cross_entropy(
        shift_logits.reshape(-1, shift_logits.shape[-1]),
        shift_labels.reshape(-1), reduction="none").view(shift_labels.shape)
    return per_tok, (shift_labels != 0).float()


def set_cache_indices(cache: KVCache, values=None, active=None) -> KVCache:
    """Rewrite the cache's per-row index in place and return the cache.

    The one owner of the cache-index contract (the continuous engine's row
    parking and the bucketed prefill's rewind route here), as in the JAX
    package, where it rewrites every layer's ``cache_index`` and the LM's
    ``pos_index``; the port keeps one (B,) index for all of them. values:
    a scalar or (B,) replacement, None keeps the index. active: a (B,)
    bool mask; rows where it is False park at 0, so a free row's garbage
    decode never creeps its index past max_len."""
    idx = cache.index
    vals = (idx if values is None else torch.as_tensor(
        values, dtype=idx.dtype, device=idx.device).expand(idx.shape))
    if active is not None:
        active = torch.as_tensor(active, dtype=torch.bool, device=idx.device)
        vals = torch.where(active, vals, torch.zeros_like(vals))
    idx.copy_(vals)
    return cache


def cache_paths(num_layers: int) -> list[str]:
    """The names of a cache's K/V buffers, ``layer_{i}/key`` then
    ``layer_{i}/value`` per layer: the keys of ``gather_kv_rows`` and of
    the paged pool's blocks."""
    return [f"layer_{i}/{kind}" for i in range(num_layers)
            for kind in ("key", "value")]


def cache_buffers(cache: KVCache) -> list[torch.Tensor]:
    """The cache's K/V buffers in ``cache_paths`` order."""
    return [buf for pair in zip(cache.key, cache.value) for buf in pair]


def gather_kv_rows(cache: KVCache, starts, window: int
                   ) -> dict[str, torch.Tensor]:
    """Every K/V buffer's per-row slice ``[starts[b] : starts[b] + window]``
    -> {``layer_{i}/key|value``: (B, window, kv_heads, head_dim)}.

    The read-side twin of the per-row block write: rows sit at different
    depths (continuous batching), so each row is read at its own start;
    a start past ``capacity - window`` clamps, as ``dynamic_slice`` does.
    The serving engine uses it to extract a decode dispatch's freshly
    written K/V for the paged pool's block chains."""
    b, cap = cache.index.shape[0], cache.capacity
    starts = torch.as_tensor(starts, dtype=torch.int64,
                             device=cache.index.device).clamp(0, cap - window)
    idx = starts[:, None] + torch.arange(window, device=starts.device)
    kvh, d = cache.key[0].shape[2:]
    idx = idx[:, :, None, None].expand(b, window, kvh, d)
    return {path: buf.gather(1, idx) for path, buf in zip(
        cache_paths(len(cache.key)), cache_buffers(cache))}


def splice_cache_row(cache: KVCache, row: KVCache, slot: int) -> None:
    """Copy the batch-1 cache ``row`` (every buffer and its index) into row
    ``slot`` of the batch cache ``cache``, in place: the continuous
    engine's admission of a prefilled row into the live batch."""
    for dst, src in zip(cache_buffers(cache), cache_buffers(row)):
        dst[slot].copy_(src[0])
    cache.index[slot] = row.index[0]


def eos_id_array(eos_token_id, device=None) -> torch.Tensor | None:
    """Normalize an eos spec — int, or a sequence of stop ids — to a 1-D
    int64 tensor, or None. The FIRST id is the clamp token every decode path
    emits after a row finishes."""
    if eos_token_id is None:
        return None
    ids = torch.atleast_1d(torch.as_tensor(eos_token_id, dtype=torch.int64,
                                           device=device))
    if ids.numel() == 0:
        return None
    return ids


@torch.inference_mode()
def generate(
    model: GPTLM,
    prompt_ids: torch.Tensor,
    max_new_tokens: int,
    temperature: float = 0.0,
    top_k: int = 0,
    generator: torch.Generator | None = None,
    eos_token_id=None,
) -> torch.Tensor:
    """``decode_tokens`` under inference mode."""
    return decode_tokens(model, prompt_ids, max_new_tokens, temperature,
                         top_k, generator, eos_token_id)


def decode_tokens(
    model: GPTLM,
    prompt_ids: torch.Tensor,
    max_new_tokens: int,
    temperature: float = 0.0,
    top_k: int = 0,
    generator: torch.Generator | None = None,
    eos_token_id=None,
) -> torch.Tensor:
    """Autoregressive generation with the KV cache (``generate`` without
    inference mode: the function ``torch.export`` traces under no_grad).

    prompt_ids: (B, prompt_len) integer ids, UNPADDED (all prompts the same
    length; masking is by cache index, not pad id). Returns
    (B, max_new_tokens) int32. temperature == 0 -> greedy; otherwise
    multinomial over softmax(logits / temperature), restricted to the top_k
    logits when top_k > 0, drawing from ``generator``.

    eos_token_id: an int or a sequence of stop ids; once a row emits one,
    every later position of that row is the FIRST stop id.
    """
    b, prompt_len = prompt_ids.shape
    if max_new_tokens < 1:
        raise ValueError(f"max_new_tokens must be >= 1, got {max_new_tokens}")
    if prompt_len + max_new_tokens > model.cfg.max_len:
        raise ValueError(
            f"prompt {prompt_len} + {max_new_tokens} new tokens exceeds "
            f"max_len {model.cfg.max_len}"
        )
    if temperature != 0.0 and generator is None:
        raise ValueError("sampling (temperature > 0) needs a generator")

    def sample(logits: torch.Tensor) -> torch.Tensor:
        if temperature == 0.0:
            return torch.argmax(logits, dim=-1)
        logits = logits / temperature
        if top_k > 0:
            kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
            logits = torch.where(logits < kth, -torch.inf, logits)
        probs = torch.softmax(logits, dim=-1)
        return torch.multinomial(probs, 1, generator=generator)[:, 0]

    cache = model.init_cache(b)
    # prefill: one pass over the whole prompt from cache index 0
    logits = model(prompt_ids, cache=cache, prefill=True)
    tok = sample(logits[:, -1])
    stops = eos_id_array(eos_token_id, device=tok.device)
    done = None if stops is None else torch.isin(tok, stops)
    out = [tok]
    for _ in range(max_new_tokens - 1):
        logits = model(tok[:, None], cache=cache)
        tok = sample(logits[:, 0])
        if stops is not None:
            tok = torch.where(done, stops[0], tok)
            done = done | torch.isin(tok, stops)
        out.append(tok)
    return torch.stack(out, dim=1).to(torch.int32)


@torch.inference_mode()
def beam_search(
    model: GPTLM,
    prompt_ids: torch.Tensor,
    max_new_tokens: int,
    num_beams: int = 4,
) -> tuple[torch.Tensor, torch.Tensor]:
    """``decode_beams`` under inference mode."""
    return decode_beams(model, prompt_ids, max_new_tokens, num_beams)


def decode_beams(
    model: GPTLM,
    prompt_ids: torch.Tensor,
    max_new_tokens: int,
    num_beams: int = 4,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Beam-search decoding with the KV cache (``beam_search`` without
    inference mode: the function ``torch.export`` traces): beams ride the batch dim,
    and each step reorders the cache rows by beam parent.

    Returns (ids (B, max_new_tokens) int32, scores (B,) float32) for the
    best beam per input, scores being exact sequence log-probs. All beams
    decode exactly max_new_tokens tokens (no EOS), so no length penalty is
    offered: with equal lengths it could never change the winner.
    Unpadded prompts, as in generate()."""
    b, prompt_len = prompt_ids.shape
    k = num_beams
    if max_new_tokens < 1:
        raise ValueError(f"max_new_tokens must be >= 1, got {max_new_tokens}")
    if prompt_len + max_new_tokens > model.cfg.max_len:
        raise ValueError(
            f"prompt {prompt_len} + {max_new_tokens} new tokens exceeds "
            f"max_len {model.cfg.max_len}"
        )

    def take_rows(cache: KVCache, rows: torch.Tensor) -> None:
        cache.key[:] = [t.index_select(0, rows) for t in cache.key]
        cache.value[:] = [t.index_select(0, rows) for t in cache.value]
        cache.index = cache.index.index_select(0, rows)

    # prefill ONCE per input, then expand the cache to (B*K) rows: the K
    # beams of an input are identical until the first top-k
    cache = model.init_cache(b)
    logits = model(prompt_ids, cache=cache, prefill=True)
    dev = logits.device
    take_rows(cache, torch.arange(b, device=dev).repeat_interleave(k))
    log_p = torch.log_softmax(logits[:, -1].float(), dim=-1)
    vocab = log_p.shape[-1]
    # all beams of an input start identical, so all but beam 0 get -inf
    # initial score (else top-k picks K copies of the same continuation)
    scores = torch.tensor([0.0] + [-math.inf] * (k - 1),
                          device=dev).repeat(b)                  # (B*K,)
    log_p = log_p.repeat_interleave(k, dim=0)                    # (B*K, V)
    base = torch.arange(b, device=dev)[:, None] * k
    toks, parents = [], []
    for t in range(max_new_tokens):
        if t:
            log_p = torch.log_softmax(
                model(tok[:, None], cache=cache)[:, 0].float(), dim=-1)
        joint = (scores[:, None] + log_p).reshape(b, k * vocab)
        top_scores, top_idx = torch.topk(joint, k, dim=-1)       # (B, K)
        rows = (base + top_idx // vocab).reshape(b * k)
        tok = (top_idx % vocab).reshape(b * k)
        take_rows(cache, rows)
        scores = top_scores.reshape(b * k)
        toks.append(tok)
        parents.append(rows)
    # backtrack: walk parent pointers from the best final beam
    row = base[:, 0] + scores.reshape(b, k).argmax(-1)           # (B,)
    best = scores[row]
    out = []
    for tok_t, parent_t in zip(reversed(toks), reversed(parents)):
        out.append(tok_t[row])
        row = parent_t[row]
    return torch.stack(out[::-1], dim=1).to(torch.int32), best
