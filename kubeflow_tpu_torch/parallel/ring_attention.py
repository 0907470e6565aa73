"""Attention — counterpart of ``kubeflow_tpu/parallel/ring_attention.py``.

  blockwise_attention   online softmax over KV blocks in plain PyTorch, with
                        the JAX package's FA2 custom backward (recomputing
                        p = exp(s − lse) block by block from the saved
                        logsumexp) or reverse-mode autodiff of the forward
                        loop (``vjp``, default KFT_BLOCKWISE_VJP)
  ring_attention        context parallelism: each rank of the context axis
                        holds L/ctx positions of every row; K, V and the
                        padding bias travel the ring of ranks one hop a step
                        (``torch.distributed`` P2P: gloo on the CPU, NCCL on
                        the card) while each rank accumulates its queries'
                        online softmax; the custom backward sends dk/dv/dbias
                        accumulators round the same ring
  ulysses_attention     context parallelism by two all-to-alls: sequence
                        shards become head shards, blockwise attention runs
                        over the full sequence of ctx-th of the heads, and
                        the output goes back
  flash_attention       the public flash entry point, differentiable: on CUDA
                        tensors its forward launches the hand-written Hopper
                        kernel (csrc/flash_fwd.cu) and its backward the three
                        backward kernels (csrc/flash_bwd.cu); on CPU tensors
                        both run their plain versions
  flash_forward         (out, lse), the raw forward
  flash_backward        (dq, dk, dv, dbias) from the forward's residuals

All take the JAX package's layout: q/k/v (B, L, H, D), bias (B, 1, 1, Lk)
additive, out (B, L, H, D), lse (B, H, Lq) float32 (the blockwise and ring
functions keep (B, H, Lq, 1) internally, as the JAX package does). The
context axis is the one ``parallel.mesh.context_axis`` has entered (the
Trainer enters its gang's); without one, or with one rank on it, ring and
Ulysses attention are blockwise attention over the whole sequence, as in
the JAX package. The JAX package computes blockwise, ring and Ulysses
attention outside Pallas; so does the port: they run no hand-written
kernel. The KFT_FLASH_BLOCK_Q/K and KFT_FLASH_DIMSEM tuning variables come
with a kernel that takes a tile size.
"""

from __future__ import annotations

import math
import os

import torch

from kubeflow_tpu_torch.kernels._layout import readable, readable_in_place
from kubeflow_tpu_torch.kernels.flash_fwd import flash_fwd_op
from kubeflow_tpu_torch.parallel.mesh import (
    AXIS_CONTEXT,
    ContextAxis,
    current_context_axis,
    in_manual_region,
)
from kubeflow_tpu_torch.parallel.rope import apply_rope

NEG_INF = -1e9

# Gradient path of blockwise_attention (and so of ring and Ulysses
# attention), read and validated once at import with the JAX package's
# text (ring_attention.py:66-69), like KFT_FLASH_BWD_IMPL below.
BLOCKWISE_VJP = os.environ.get("KFT_BLOCKWISE_VJP", "custom")
if BLOCKWISE_VJP not in ("custom", "autodiff"):
    raise ValueError(
        f"KFT_BLOCKWISE_VJP={BLOCKWISE_VJP!r} is not 'custom' or 'autodiff'")

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

    The plain version of the flash kernel, which is blockwise attention's
    forward: f32 scores and accumulators, p rounded to the input dtype
    before p·v, as the TPU kernel does. A block that does not tile Lk
    becomes one block (the JAX package's rule). causal masks key
    positions after the query's; window > 0 (with causal) also masks keys
    window or more positions older."""
    out, lse = _blockwise_fwd_impl(q, k, v, bias, block, causal, window)
    return out, lse[..., 0]


# ------------------------------------------------------------ blockwise core


def _online_block(carry, kv, q, scale, q_pos=None, k_pos=None,
                  window: int = 0):
    """One online-softmax accumulation step against a KV block (JAX
    ``_online_block``).

    carry: (o_acc f32 (B, Lq, H, D), m (B, H, Lq, 1) running max, l (B, H,
    Lq, 1) running sum); kv: (k_blk, v_blk, bias_blk (B, 1, 1, Lk)).
    q_pos/k_pos: global positions (Lq,)/(Lk,) for the causal mask, so the
    mask holds when the blocks live on different ranks; window > 0 also
    hides keys window or more positions older."""
    o_acc, m, l = carry
    k_blk, v_blk, bias_blk = kv
    s = _block_scores(q, k_blk, bias_blk, scale, q_pos, k_pos, window)
    m_new = torch.maximum(m, s.amax(-1, keepdim=True))
    corr = torch.exp(m - m_new)
    p = torch.exp(s - m_new)
    l_new = l * corr + p.sum(-1, keepdim=True)
    pv = torch.einsum("bhlm,bmhd->blhd", p.to(q.dtype).float(),
                      v_blk.float())
    o_new = o_acc * corr.transpose(1, 2) + pv
    return o_new, m_new, l_new


def _finalize(o_acc, m, l, dtype):
    return (o_acc / l.transpose(1, 2)).to(dtype)


def _init_carry(q):
    b, lq, h, d = q.shape
    kw = {"dtype": torch.float32, "device": q.device}
    return (torch.zeros((b, lq, h, d), **kw),
            torch.full((b, h, lq, 1), NEG_INF, **kw),
            torch.zeros((b, h, lq, 1), **kw))


def _kv_blocks(k, v, bias, block):
    """KV (+ bias + key positions) split into blocks of ``block`` keys:
    [(k_blk, v_blk, bias_blk, k_pos)]; a block that does not tile Lk
    becomes one block (the JAX package's ragged-tail rule)."""
    lk = k.shape[1]
    block = min(block, lk)
    if lk % block:
        block = lk
    return [(k[:, s:s + block], v[:, s:s + block], bias[..., s:s + block],
             torch.arange(s, s + block, device=k.device))
            for s in range(0, lk, block)]


def _block_scores(q, k_blk, bias_blk, scale, q_pos, kp, window):
    """The one score computation the forward and the custom backward
    share: the recompute is bit-identical, so exp(s − lse) stays
    consistent with the lse the forward saved. Like every product here
    (and like the flash kernels), the scores are summed and kept in f32
    from operands in the input dtype; the JAX package's bf16 einsums round
    s and p·v to bf16 first, which in bf16 puts its blockwise attention a
    few bf16 ulps from the flash kernels (tests hold the two at the JAX
    package's bf16 bounds)."""
    s = torch.einsum("blhd,bmhd->bhlm", q.float(), k_blk.float()) * scale
    s = s + bias_blk.float()
    if q_pos is not None:
        masked = kp[None, :] > q_pos[:, None]
        if window:
            masked = masked | (q_pos[:, None] - kp[None, :] >= window)
        s = s + torch.where(masked, NEG_INF, 0.0)[None, None]
    return s


def _blockwise_fwd_impl(q, k, v, bias, block, causal, window):
    """Online-softmax loop over KV blocks -> (out, lse (B, H, Lq, 1) f32)."""
    scale = 1.0 / (q.shape[-1] ** 0.5)
    q_pos = torch.arange(q.shape[1], device=q.device) if causal else None
    carry = _init_carry(q)
    for k_blk, v_blk, bias_blk, kp in _kv_blocks(k, v, bias, block):
        carry = _online_block(carry, (k_blk, v_blk, bias_blk), q, scale,
                              q_pos, kp if causal else None, window)
    o_acc, m, l = carry
    return _finalize(o_acc, m, l, q.dtype), m + torch.log(l)


def _block_grads(q, k_blk, v_blk, bias_blk, g, gf, dd, lse, scale, q_pos,
                 k_pos, window):
    """FA2 per-block gradients, the one implementation the blockwise and
    ring custom backwards share. The products take operands in the input
    dtype and sum in f32, as the JAX package's ``preferred_element_type``
    products do. Returns (dq_blk, dk_blk, dv_blk, dbias_rows (B, Lk_blk)),
    f32."""
    s = _block_scores(q, k_blk, bias_blk, scale, q_pos, k_pos, window)
    p = torch.exp(s - lse)
    dp = torch.einsum("blhd,bmhd->bhlm", gf, v_blk.float())
    ds = p * (dp - dd)
    dsq = ds.to(q.dtype).float()
    dq_blk = torch.einsum("bhlm,bmhd->blhd", dsq, k_blk.float()) * scale
    dk_blk = torch.einsum("bhlm,blhd->bmhd", dsq, q.float()) * scale
    dv_blk = torch.einsum("bhlm,blhd->bmhd", p.to(q.dtype).float(),
                          g.float())
    dbias_rows = ds.sum(dim=(1, 2))  # bias (B, 1, 1, Lk) broadcasts h, Lq
    return dq_blk, dk_blk, dv_blk, dbias_rows


def _row_stat(gf, out):
    """D_i = Σ_d dO∘O (B, H, Lq, 1): the dv-free half of ds = p·(dp − D)."""
    return torch.einsum("blhd,blhd->bhl", gf, out.float())[..., None]


def _bias_grad(dbias_rows, bias):
    """(B, Lk) rows as the bias' gradient, summed over a broadcast batch."""
    db = dbias_rows[:, None, None, :]
    if bias.shape[0] != db.shape[0]:
        db = db.sum(0, keepdim=True)
    return db.to(bias.dtype)


def _blockwise_bwd_impl(q, k, v, bias, out, lse, g, block, causal, window):
    """FlashAttention-2-style backward: p = exp(s − lse) recomputed block by
    block from the saved logsumexp, so the residuals are O(L), not the
    probability tiles reverse-mode AD of the forward loop keeps."""
    scale = 1.0 / (q.shape[-1] ** 0.5)
    q_pos = torch.arange(q.shape[1], device=q.device) if causal else None
    gf = g.float()
    dd = _row_stat(gf, out)
    dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    dks, dvs, dbs = [], [], []
    for k_blk, v_blk, bias_blk, kp in _kv_blocks(k, v, bias, block):
        dq_blk, dk_blk, dv_blk, db = _block_grads(
            q, k_blk, v_blk, bias_blk, g, gf, dd, lse, scale, q_pos,
            kp if causal else None, window)
        dq = dq + dq_blk
        dks.append(dk_blk)
        dvs.append(dv_blk)
        dbs.append(db)
    return (dq.to(q.dtype), torch.cat(dks, 1).to(k.dtype),
            torch.cat(dvs, 1).to(v.dtype), _bias_grad(torch.cat(dbs, 1), bias))


class _BlockwiseAttention(torch.autograd.Function):
    """``_blockwise_cvjp`` (JAX :235-252): the forward saves q, k, v, bias,
    out and lse; the backward recomputes the probabilities from lse."""

    @staticmethod
    def forward(ctx, q, k, v, bias, block, causal, window):
        out, lse = _blockwise_fwd_impl(q, k, v, bias, block, causal, window)
        ctx.save_for_backward(q, k, v, bias, out, lse)
        ctx.geometry = (block, causal, window)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, bias, out, lse = ctx.saved_tensors
        dq, dk, dv, dbias = _blockwise_bwd_impl(q, k, v, bias, out, lse, g,
                                                *ctx.geometry)
        return (dq, dk, dv, dbias if ctx.needs_input_grad[3] else None,
                None, None, None)


def _wants_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def blockwise_attention(q, k, v, bias, block: int = 256, causal: bool = False,
                        window: int = 0, vjp: str | None = None
                        ) -> torch.Tensor:
    """Memory-efficient attention: online softmax over KV blocks.

    The numerics reference of the ring path. causal masks keys after the
    query; window > 0 (requires causal) is the Mistral sliding window:
    query i sees keys in (i - window, i].

    vjp selects the gradient path (default: KFT_BLOCKWISE_VJP, validated
    at import): "custom", the FlashAttention-2-style backward that
    recomputes the probabilities from the saved logsumexp (O(L)
    residuals), or "autodiff", reverse-mode AD through the forward loop."""
    if window and not causal:
        raise ValueError("attention window requires causal=True")
    if vjp is None:
        vjp = BLOCKWISE_VJP
    if vjp not in ("custom", "autodiff"):
        raise ValueError(f"unknown blockwise vjp {vjp!r}")
    if vjp == "autodiff" or not _wants_grad(q, k, v, bias):
        return _blockwise_fwd_impl(q, k, v, bias, block, causal, window)[0]
    return _BlockwiseAttention.apply(q, k, v, bias, block, causal, window)


# ------------------------------------------------------------------ the ring


def _context_axis(axis_name: str) -> ContextAxis | None:
    """The entered context axis of more than one rank (None: one rank or
    none entered)."""
    if axis_name != AXIS_CONTEXT:
        raise ValueError(f"the port shards sequences over the "
                         f"{AXIS_CONTEXT!r} axis only, not {axis_name!r}")
    return current_context_axis()


def _rope_qk(q, k, pos, theta):
    """Rotate q and k by the given (global) positions: the one rope
    application the context-parallel paths share."""
    return apply_rope(q, pos, theta), apply_rope(k, pos, theta)


def _ring_hops(ring: int, l_loc: int, window: int) -> int:
    """Ring steps that can contribute under a causal sliding window: the
    oldest key any query of shard i can see is position i·l_loc − window +
    1, so the largest useful hop is ceil(window / l_loc), the same on every
    shard."""
    if not window:
        return ring
    return min(ring, -(-window // l_loc) + 1)


def _rotate(tensors, axis: ContextAxis, shift: int) -> list:
    """Every tensor sent ``shift`` hops along the ring (to the rank at index
    + shift) and the one from the rank ``shift`` hops behind received in
    its place: JAX's ppermute. One batch of P2P operations, posted in the
    same order on every rank, one tag per tensor; each receive gets a
    fresh buffer, read only after every request has completed."""
    import torch.distributed as dist

    shift %= axis.size
    if not shift:
        return list(tensors)
    dst = axis.ranks[(axis.index + shift) % axis.size]
    src = axis.ranks[(axis.index - shift) % axis.size]
    ops, outs = [], []
    for tag, t in enumerate(tensors):
        t = t.contiguous()
        r = torch.empty_like(t)
        ops.append(dist.P2POp(dist.isend, t, dst, group=axis.group,
                              tag=tag))
        ops.append(dist.P2POp(dist.irecv, r, src, group=axis.group,
                              tag=tag))
        outs.append(r)
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return outs


class _Rotate(torch.autograd.Function):
    """``_rotate`` of several tensors as one differentiable step (the
    autodiff ring): its backward rotates the cotangents back."""

    @staticmethod
    def forward(ctx, axis, shift, *tensors):
        ctx.axis, ctx.shift = axis, shift
        return tuple(_rotate(tensors, axis, shift))

    @staticmethod
    def backward(ctx, *grads):
        grads = [torch.zeros_like(g) if g is None else g for g in grads]
        return (None, None, *_rotate(grads, ctx.axis, -ctx.shift))


def _ring_fwd_impl(axis: ContextAxis, causal, window, scale, q, k, v, bias,
                   differentiable: bool = False):
    """The ring forward: per-hop online-softmax accumulation against the
    visiting KV block, (k, v, bias) rotated one hop a step. Returns (out,
    lse (B, H, Lq, 1) f32), lse the residual of the custom backward. The
    rotation after the last hop, whose result the JAX package discards, is
    not made."""
    ring, idx = axis.size, axis.index
    l_loc = q.shape[1]
    q_pos = axis.positions(l_loc, q.device) if causal else None
    hops = _ring_hops(ring, l_loc, window) if causal else ring
    carry = _init_carry(q)
    kv = (k, v, bias)
    for i in range(hops):
        if causal:
            src = (idx - i) % ring  # the shard this KV block started on
            k_pos = src * l_loc + torch.arange(l_loc, device=q.device)
            carry = _online_block(carry, kv, q, scale, q_pos, k_pos, window)
        else:
            carry = _online_block(carry, kv, q, scale)
        if i + 1 < hops:
            kv = (_Rotate.apply(axis, 1, *kv) if differentiable
                  else tuple(_rotate(kv, axis, 1)))
    o_acc, m, l = carry
    return _finalize(o_acc, m, l, q.dtype), m + torch.log(l)


def _ring_core_bwd(axis: ContextAxis, causal, window, scale, q, k, v, bias,
                   out, lse, g):
    """Ring-rotating FlashAttention-2-style backward (JAX
    ``_ring_core_bwd``). The KV blocks travel the forward's ring and a
    zero-initialised (dk, dv, dbias) accumulator travels with each: a rank
    attending the block that started on shard i − s adds that hop's
    contribution to the visiting accumulator before both move on. dq
    accumulates at home. The last hop rotates the accumulators only, and
    one closing rotation by −(hops − 1) brings each home with every query
    shard's contribution on board."""
    ring, idx = axis.size, axis.index
    l_loc = q.shape[1]
    q_pos = axis.positions(l_loc, q.device) if causal else None
    hops = _ring_hops(ring, l_loc, window) if causal else ring
    gf = g.float()
    dd = _row_stat(gf, out)
    f32 = {"dtype": torch.float32, "device": q.device}
    dq = torch.zeros(q.shape, **f32)
    kvb = (k, v, bias)
    acc = (torch.zeros(k.shape, **f32), torch.zeros(v.shape, **f32),
           torch.zeros((bias.shape[0], 1, 1, bias.shape[-1]), **f32))
    for i in range(hops):
        k_pos = None
        if causal:
            src = (idx - i) % ring
            k_pos = src * l_loc + torch.arange(l_loc, device=q.device)
        dq_blk, dk_blk, dv_blk, dbias_rows = _block_grads(
            q, *kvb, g, gf, dd, lse, scale, q_pos, k_pos, window)
        dq = dq + dq_blk
        acc = (acc[0] + dk_blk, acc[1] + dv_blk,
               acc[2] + dbias_rows[:, None, None, :])
        if i + 1 < hops:
            moved = _rotate((*kvb, *acc), axis, 1)
            kvb, acc = tuple(moved[:3]), tuple(moved[3:])
    dk, dv, dbias = _rotate(acc, axis, -(hops - 1))
    return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype),
            _bias_grad(dbias[:, 0, 0], bias))


class _RingCore(torch.autograd.Function):
    """``_ring_core`` with its custom VJP (JAX :432-501)."""

    @staticmethod
    def forward(ctx, q, k, v, bias, axis, causal, window, scale):
        out, lse = _ring_fwd_impl(axis, causal, window, scale, q, k, v, bias)
        ctx.save_for_backward(q, k, v, bias, out, lse)
        ctx.geometry = (axis, causal, window, scale)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, bias, out, lse = ctx.saved_tensors
        dq, dk, dv, dbias = _ring_core_bwd(*ctx.geometry, q, k, v, bias, out,
                                           lse, g.contiguous())
        return (dq, dk, dv, dbias if ctx.needs_input_grad[3] else None,
                None, None, None, None)


def ring_attention(q, k, v, bias, dropout_rng=None, dropout_rate=0.0,
                   block: int = 256, axis_name: str = AXIS_CONTEXT,
                   causal: bool = False, rope_theta: float | None = None,
                   window: int = 0, vjp: str | None = None) -> torch.Tensor:
    """Ring attention over the context axis (JAX ``ring_attention``).

    q/k/v are this rank's L_loc positions of every row, bias (B, 1, 1,
    L_loc) its keys' padding bias. Each rank accumulates its queries'
    online softmax against its own KV block, then (k, v, bias) move one
    hop round the ring; after the ring every query has seen every key, and
    (m, l) make the result dense attention's. causal masks by global
    position: the block at hop s started on shard (i − s) mod ring. Under
    a window (requires causal) the ring runs only the hops whose keys a
    local query can still see (``_ring_hops``). rope_theta rotates q and k
    by global position before the ring. vjp: "custom" (default
    KFT_BLOCKWISE_VJP) is the ring-rotating FA2 backward, "autodiff"
    reverse-mode AD of the forward ring. With no context axis (or one
    rank) this is blockwise attention over the whole sequence."""
    if dropout_rate:
        raise NotImplementedError("attention dropout unsupported in ring path")
    if window and not causal:
        raise ValueError("attention window requires causal=True")
    axis = _context_axis(axis_name)
    if axis is None or in_manual_region():
        if rope_theta is not None:
            q, k = _rope_qk(q, k, torch.arange(q.shape[1], device=q.device),
                            rope_theta)
        return blockwise_attention(q, k, v, bias, block, causal=causal,
                                   window=window, vjp=vjp)
    scale = 1.0 / (q.shape[-1] ** 0.5)
    if vjp is None:
        vjp = BLOCKWISE_VJP
    if vjp not in ("custom", "autodiff"):
        raise ValueError(f"unknown ring vjp {vjp!r}")
    if rope_theta is not None:
        # each shard rotates its local q and k by global position once;
        # rotated K blocks then travel the ring carrying their rotation
        q, k = _rope_qk(q, k, axis.positions(q.shape[1], q.device),
                        rope_theta)
    if vjp == "autodiff":
        return _ring_fwd_impl(axis, causal, window, scale, q, k, v, bias,
                              differentiable=True)[0]
    if not _wants_grad(q, k, v, bias):
        return _ring_fwd_impl(axis, causal, window, scale, q, k, v, bias)[0]
    return _RingCore.apply(q, k, v, bias, axis, causal, window, scale)


# ------------------------------------------------------------------- ulysses


class _GatherKeys(torch.autograd.Function):
    """The padding bias' key chunks gathered from the context axis (JAX's
    tiled ``all_gather`` on the key dim); its backward sums the ranks'
    cotangents and keeps this rank's chunk."""

    @staticmethod
    def forward(ctx, bias, axis):
        import torch.distributed as dist

        ctx.axis = axis
        bias = bias.contiguous()
        parts = [torch.empty_like(bias) for _ in range(axis.size)]
        dist.all_gather(parts, bias, group=axis.group)
        return torch.cat(parts, dim=-1)

    @staticmethod
    def backward(ctx, g):
        import torch.distributed as dist

        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.axis.group)
        return g.chunk(ctx.axis.size, dim=-1)[ctx.axis.index].contiguous(), \
            None


def _seq_to_heads(x, axis: ContextAxis):
    """(B, L_loc, H, D) -> (B, L, H/ctx, D): this rank's sequence chunk of
    every head for every rank's chunk of its head group (JAX's tiled
    all_to_all, split_axis=2, concat_axis=1)."""
    from kubeflow_tpu_torch.parallel.moe import _AllToAll

    b, l, h, d = x.shape
    n = axis.size
    parts = x.reshape(b, l, n, h // n, d).permute(2, 0, 1, 3, 4)
    got = _AllToAll.apply(parts, axis.group)           # (n, B, L_loc, H/n, D)
    return got.permute(1, 0, 2, 3, 4).reshape(b, n * l, h // n, d)


def _heads_to_seq(x, axis: ContextAxis):
    """The inverse exchange: (B, L, H/ctx, D) -> (B, L_loc, H, D)."""
    from kubeflow_tpu_torch.parallel.moe import _AllToAll

    b, big_l, hc, d = x.shape
    n = axis.size
    parts = x.reshape(b, n, big_l // n, hc, d).permute(1, 0, 2, 3, 4)
    got = _AllToAll.apply(parts, axis.group)           # (n, B, L_loc, H/n, D)
    return got.permute(1, 2, 0, 3, 4).reshape(b, big_l // n, n * hc, d)


def ulysses_attention(q, k, v, bias, dropout_rng=None, dropout_rate=0.0,
                      block: int = 256, axis_name: str = AXIS_CONTEXT,
                      causal: bool = False, rope_theta: float | None = None,
                      window: int = 0) -> torch.Tensor:
    """Ulysses context parallelism (JAX ``ulysses_attention``): an
    all-to-all trades each rank's sequence shard for a head shard, every
    rank runs blockwise attention over the full sequence of its heads
    (the ordinary causal mask and rope by the ordinary positions), and a
    second all-to-all scatters the output back. The padding bias is
    gathered whole. With no context axis (or one rank) this is blockwise
    attention over the whole sequence."""
    if dropout_rate:
        raise NotImplementedError(
            "attention dropout unsupported in ulysses path")
    if window and not causal:
        raise ValueError("attention window requires causal=True")
    axis = _context_axis(axis_name)
    if axis is None or in_manual_region():
        if rope_theta is not None:
            q, k = _rope_qk(q, k, torch.arange(q.shape[1], device=q.device),
                            rope_theta)
        return blockwise_attention(q, k, v, bias, block, causal=causal,
                                   window=window)
    ctx, model = axis.size, 1  # the port executes no model axis
    heads = q.shape[2]
    if (heads // model) % ctx:
        raise ValueError(
            f"ulysses needs heads/model_parallel ({heads}/{model}) divisible "
            f"by context axis size {ctx}; use ring attention instead"
        )
    qg, kg, vg = (_seq_to_heads(t, axis) for t in (q, k, v))
    bias_g = _GatherKeys.apply(bias, axis)
    if rope_theta is not None:
        qg, kg = _rope_qk(qg, kg, torch.arange(qg.shape[1], device=q.device),
                          rope_theta)
    o = blockwise_attention(qg, kg, vg, bias_g, block, causal=causal,
                            window=window)
    return _heads_to_seq(o, axis)


# ------------------------------------------------------------------- flash


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
