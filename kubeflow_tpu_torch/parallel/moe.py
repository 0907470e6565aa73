"""Expert parallelism — counterpart of ``kubeflow_tpu/parallel/moe.py``:
mixture-of-experts dispatch over the ``expert`` axis.

  - Top-k softmax router in float32, gates renormalised over the k chosen
    experts, a Switch-style load-balance aux loss, slot priority by a
    cumulative sum in (token-major, then k) order, tokens beyond an
    expert's capacity dropped (zero combine weight; the residual carries
    them).
  - Local dispatch: each rank of a gang routes its own tokens with capacity
    C = ceil(k · t_local · cf / E), so the slot cumsum never spans ranks.
    Expert parallelism subdivides data parallelism: the stacked expert
    weights are sharded over ``expert`` on dim 0 (``shard_experts``) and
    the token slots cross the expert group in two all-to-alls, each with
    its backward. The aux loss of a rank is its own tokens'; the gang's
    objective is the mean over its data-like ranks (``parallel/
    sharding.py``), which is the JAX package's ``pmean``.
  - Dropless routing (the decode path): every token gets its full top-k
    combine and every expert runs on every token, so rows never couple.

The dispatch and the combine are computed by index (a scatter into (E, C,
H) slots, a gather back), not by the JAX package's (T, E, C) one-hot
products, which are exact, so the results agree; like them, the combine
weights are rounded to the activation dtype before use, and the k terms of
a token are summed in float32 and rounded once. No shape depends on the
data, so a CUDA graph can capture the dispatch.
"""

from __future__ import annotations

import math
from contextlib import contextmanager
import contextvars

import torch
import torch.nn.functional as F
from torch import nn

from kubeflow_tpu_torch.parallel.mesh import (
    AXIS_EXPERT,
    AXIS_FSDP,
    AXIS_MODEL,
    in_manual_region,
)
from kubeflow_tpu_torch.parallel.partitioner import P

# Param-path regex -> spec for MoE params (merged into model rules).
MOE_PARTITION_RULES: list[tuple[str, P]] = [
    (r"moe/(w_up|w_gate)$", P(AXIS_EXPERT, AXIS_FSDP, AXIS_MODEL)),
    (r"moe/(b_up|b_gate)$", P(AXIS_EXPERT, AXIS_MODEL)),
    (r"moe/w_down$", P(AXIS_EXPERT, AXIS_MODEL, AXIS_FSDP)),
    (r"moe/b_down$", P(AXIS_EXPERT, AXIS_FSDP)),
]

#: the stacked expert parameters, in creation order (after ``router``)
EXPERT_PARAMS = ("w_up", "b_up", "w_down", "b_down", "w_gate", "b_gate")

#: forwards of every MoeMlp in this process by dispatch: host counts taken
#: where the forward runs (a CUDA graph's replays add none)
DISPATCH_CALLS = {"routed": 0, "dropless": 0}

# ------------------------------------------------------ the losses collection

_SOWN = contextvars.ContextVar("kft_sown_losses", default=None)


@contextmanager
def collect_losses():
    """Collect the auxiliary losses sown while the body runs (flax's
    ``losses`` collection): yields the list they are appended to. A
    forward recomputed by remat in the backward sows nothing, so each
    loss counts once."""
    bag: list = []
    tok = _SOWN.set(bag)
    try:
        yield bag
    finally:
        _SOWN.reset(tok)


def sow_loss(value: torch.Tensor) -> None:
    """Append ``value`` to the open ``collect_losses`` list, if any; a
    forward recomputed inside the backward (remat) appends nothing."""
    bag = _SOWN.get()
    if bag is not None and torch._C._current_graph_task_id() == -1:
        bag.append(value)


# ------------------------------------------------------------------ routing


def _route(logits: torch.Tensor, top_k: int, capacity: int):
    """Routing of (T, E) float32 logits -> (expert (T, K) int64, slot
    position (T, K) int64, keep (T, K) bool, gates (T, K) float32, aux
    loss). Token t's k-th choice sits in slot pos[t, k] of expert
    expert[t, k] when keep[t, k]: the JAX package's (T, E, C) combine and
    dispatch tensors are one-hot scatters of them."""
    t, e = logits.shape
    probs = torch.softmax(logits, dim=-1)
    gates, idx = torch.topk(probs, top_k, dim=-1)              # (T, K)
    gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)
    onehot = F.one_hot(idx, e)                                  # (T, K, E)
    # Switch load balance: E * Σ_e fraction_of_tokens_e · mean_prob_e
    frac = onehot[:, 0].to(logits.dtype).mean(dim=0)  # top-1 share
    aux = e * torch.sum(frac * probs.mean(dim=0))
    # slot position: cumsum priority in (token-major, then k) order
    flat = onehot.reshape(t * top_k, e)
    before = torch.cumsum(flat, dim=0) - flat
    pos = (before * flat).sum(-1).reshape(t, top_k)
    return idx, pos, pos < capacity, gates, aux


class _AllToAll(torch.autograd.Function):
    """``all_to_all_single`` over ``group`` with equal splits on dim 0; its
    backward is the same exchange of the cotangent."""

    @staticmethod
    def forward(ctx, x, group):
        import torch.distributed as dist

        ctx.group = group
        x = x.contiguous()
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        import torch.distributed as dist

        g = g.contiguous()
        out = torch.empty_like(g)
        dist.all_to_all_single(out, g, group=ctx.group)
        return out, None


class MoeMlp(nn.Module):
    """Drop-in MoE replacement for a transformer MLP block.

    forward(x (B, L, H), dropless=False) -> (B, L, H) in x's dtype; the
    load-balance aux loss is sown (``collect_losses``; the Trainer adds
    every sown loss to the objective). Parameters are float32 in flax's
    names, order and stacked layouts: ``router`` (H, E), ``w_up`` (E, H,
    F), ``b_up`` (E, F), ``w_down`` (E, F, H), ``b_down`` (E, H),
    ``w_gate``/``b_gate`` (SwiGLU); ``use_bias=False`` drops the biases."""

    def __init__(self, hidden_size: int, mlp_dim: int, num_experts: int,
                 top_k: int = 2, capacity_factor: float = 2.0,
                 activation: str = "gelu", use_bias: bool = True,
                 global_dispatch: bool = False, device=None):
        super().__init__()
        if activation not in ("gelu", "swiglu"):
            raise ValueError(
                f"activation {activation!r} is not gelu|swiglu")
        h, f, e = hidden_size, mlp_dim, num_experts
        self.hidden_size, self.mlp_dim, self.num_experts = h, f, e
        self.top_k, self.capacity_factor = top_k, capacity_factor
        self.activation, self.use_bias = activation, use_bias
        self.global_dispatch = global_dispatch
        kw = {"device": device, "dtype": torch.float32}
        self.router = nn.Parameter(torch.empty(h, e, **kw))
        self.w_up = nn.Parameter(torch.empty(e, h, f, **kw))
        if use_bias:
            self.b_up = nn.Parameter(torch.zeros(e, f, **kw))
        self.w_down = nn.Parameter(torch.empty(e, f, h, **kw))
        if use_bias:
            self.b_down = nn.Parameter(torch.zeros(e, h, **kw))
        if activation == "swiglu":
            self.w_gate = nn.Parameter(torch.empty(e, h, f, **kw))
            if use_bias:
                self.b_gate = nn.Parameter(torch.zeros(e, f, **kw))
        # expert parallelism (shard_experts): this rank's expert group and
        # its place in it, and the gang's data-like extent
        self.expert_group = None
        self.ep, self.ep_index, self.data_like = 1, 0, 1

    def expert_weights(self) -> dict[str, nn.Parameter]:
        return {n: getattr(self, n) for n in EXPERT_PARAMS
                if hasattr(self, n)}

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """flax's initializers: router N(0, 0.02); the stacked kernels
        lecun-normal over flax's fan-in (in dim x experts); biases 0."""
        from kubeflow_tpu_torch.models.layers import _lecun_normal_

        dev = generator.device
        self.router.copy_(torch.randn(self.router.shape, generator=generator,
                                      device=dev) * 0.02)
        for name, p in self.expert_weights().items():
            if name.startswith("b_"):
                p.zero_()
            else:
                _lecun_normal_(p, p.shape[-2] * self.num_experts, generator)

    @torch.no_grad()
    def shard_experts(self, group, ep: int, index: int,
                      data_like: int) -> None:
        """Keep only this rank's E/ep experts (``index`` of ``ep`` in the
        expert group ``group``) as the stacked parameters' dim 0, and
        record the gang's data-like extent. Call before the optimizer is
        built: the parameters are replaced."""
        e = self.num_experts
        if e % ep:
            raise ValueError(
                f"num_experts {e} not divisible by expert axis {ep}")
        if self.ep != 1:
            raise ValueError("the experts are sharded already")
        n = e // ep
        for name, p in self.expert_weights().items():
            setattr(self, name, nn.Parameter(
                p.detach()[index * n:(index + 1) * n].clone()))
        self.expert_group, self.ep, self.ep_index = group, ep, index
        self.data_like = data_like

    def _ffn(self, xin: torch.Tensor) -> torch.Tensor:
        """Per-expert FFN: xin (E', S, H) against the stacked weights, in
        xin's dtype; each bias is added to the rounded product."""
        dt = xin.dtype
        up = torch.bmm(xin, self.w_up.to(dt))
        if self.use_bias:
            up = up + self.b_up.to(dt)[:, None, :]
        if self.activation == "swiglu":
            gate = torch.bmm(xin, self.w_gate.to(dt))
            if self.use_bias:
                gate = gate + self.b_gate.to(dt)[:, None, :]
            act = F.silu(gate) * up
        else:
            act = F.gelu(up, approximate="tanh")  # flax nn.gelu
        y = torch.bmm(act, self.w_down.to(dt))
        if self.use_bias:
            y = y + self.b_down.to(dt)[:, None, :]
        return y

    def forward(self, x: torch.Tensor, dropless: bool = False
                ) -> torch.Tensor:
        b, l, h = x.shape
        e, k = self.num_experts, self.top_k
        xt = x.reshape(b * l, h)
        logits = xt.float() @ self.router                    # (T, E)
        DISPATCH_CALLS["dropless" if dropless else "routed"] += 1
        if dropless:
            return self._dropless(xt, logits).reshape(b, l, h)
        if self.global_dispatch and self.data_like > 1:
            raise NotImplementedError(
                "global_dispatch over a gang of more than one data-like "
                "rank (one capacity pool, a cross-rank slot cumsum) is not "
                "ported (ROADMAP Queue A item 8); local dispatch is the "
                "default")
        t = b * l
        cap = int(math.ceil(k * t * self.capacity_factor / e))
        expert, pos, keep, gates, aux = _route(logits, k, cap)
        # combine weights rounded to the activation dtype, as the JAX
        # package casts its combine tensor
        weight = (gates * keep).to(x.dtype)
        slot = torch.where(keep, expert * cap + pos, e * cap).reshape(-1)
        # dispatch: token t's k-th choice into its slot; dropped choices
        # land in one spare row past the E * C slots
        src = xt[:, None, :].expand(t, k, h).reshape(t * k, h)
        expert_in = xt.new_zeros(e * cap + 1, h).index_add(0, slot, src)
        expert_in = expert_in[:-1].view(e, cap, h)
        ep = self.ep
        exchange = ep > 1 and not in_manual_region()
        if ep > 1 and not exchange:
            raise NotImplementedError(
                "expert-sharded weights inside a pipeline stage are not "
                "ported (ROADMAP Queue A item 8)")
        if exchange:
            # (E, C, H) -> (E/ep, ep*C, H): every rank's slots for this
            # rank's experts, source ranks along C in rank order
            got = _AllToAll.apply(expert_in, self.expert_group)
            expert_in = got.view(ep, e // ep, cap, h).transpose(0, 1) \
                .reshape(e // ep, ep * cap, h)
        out = self._ffn(expert_in)
        if exchange:
            back = out.view(e // ep, ep, cap, h).transpose(0, 1) \
                .reshape(e, cap, h)
            out = _AllToAll.apply(back, self.expert_group)
        out = torch.cat([out.reshape(e * cap, h),
                         out.new_zeros(1, h)])[slot].view(t, k, h)
        y = (weight.float()[..., None] * out.float()).sum(1).to(x.dtype)
        sow_loss(aux)
        return y.reshape(b, l, h)

    def _dropless(self, xt: torch.Tensor, logits: torch.Tensor
                  ) -> torch.Tensor:
        """Every token's full top-k combine over every expert: rows are
        independent, so continuous batching composes exactly. No aux
        loss: decode never trains."""
        if self.ep > 1:
            raise NotImplementedError(
                "dropless routing over expert-sharded weights is not "
                "ported (ROADMAP Queue A item 8)")
        e = self.num_experts
        probs = torch.softmax(logits, dim=-1)
        gates, idx = torch.topk(probs, self.top_k, dim=-1)
        gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)
        weight = torch.zeros_like(probs).scatter_add(1, idx, gates)  # (T, E)
        down = self._ffn(xt[None].expand(e, *xt.shape))
        y = torch.einsum("te,eth->th", weight.to(xt.dtype).float(),
                         down.float())
        return y.to(xt.dtype)
