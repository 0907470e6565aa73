"""Layers of the port's encoder and vision families, each the counterpart of
the ``flax.linen`` layer the JAX package builds them from.

Every layer keeps its parameters in float32 and in flax's own names and
layouts: a ``DenseGeneral`` kernel is (in..., out...), a conv kernel HWIO
(``models/conv.py``), an embedding table (vocab, features) (torch's
``weight``, flax's ``embedding``), a norm has ``scale`` and ``bias``, and a
BatchNorm's running averages are the buffers ``mean`` and ``var`` (flax's
``batch_stats``). A module's ``state_dict`` key is then its flax path with
``.`` for ``/`` (``convert.py``). Each layer casts its input and parameters
to the compute dtype at use and returns that dtype, as flax's
``dtype=...`` layers do; the norms take their statistics in float32.
"""

from __future__ import annotations

import copy
import dataclasses
import itertools
import math
import sys

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from kubeflow_tpu_torch.kernels.dropout import dropout as device_dropout
from kubeflow_tpu_torch.models.conv import Conv

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def as_torch_dtype(dtype) -> torch.dtype:
    """A dtype name ("float32" | "bfloat16") or torch dtype -> torch dtype."""
    if isinstance(dtype, torch.dtype):
        return dtype
    if dtype not in DTYPES:
        raise ValueError(f"dtype {dtype!r} is not one of {sorted(DTYPES)}")
    return DTYPES[dtype]


def dtype_name(dtype) -> str:
    dt = as_torch_dtype(dtype)
    return next(k for k, v in DTYPES.items() if v == dt)


#: the dropout seeds one training step holds (``DropoutSeeds``): a
#: GPT-2 small step takes 13 (the embedding's and one a block), a BERT
#: classifier's 14, times the microbatches of a step
DROPOUT_SEEDS_PER_STEP = 1024


class DropoutSeeds:
    """The dropout seeds of one training step, which its forwards take in
    order (``block_seeds``): a 1-D int64 tensor of seeds, moved to the
    device at the first take. The Trainer makes one a step from (seed,
    step); a CUDA graph's is a row of a device buffer that the host refills
    before each replay, so every replay draws its own step's masks."""

    def __init__(self, seeds: torch.Tensor):
        self.seeds = seeds
        self.used = 0

    def take(self, n: int, device: torch.device) -> torch.Tensor:
        """The next n seeds, on ``device``."""
        if self.used + n > self.seeds.numel():
            raise ValueError(
                f"a step took more than {self.seeds.numel()} dropout seeds")
        if self.seeds.device != device:
            src = self.seeds
            if device.type == "cuda":
                src = src.pin_memory()
            self.seeds = src.to(device, non_blocking=True)
        out = self.seeds[self.used:self.used + n]
        self.used += n
        return out


def _host_seeds(n: int, generator: torch.Generator) -> torch.Tensor:
    """n seeds drawn from a CPU generator."""
    return torch.randint(0, 2**62, (n,), generator=generator)


def dropout(x: torch.Tensor, rate: float, rng, site: int = 0,
            sequence: bool = False) -> torch.Tensor:
    """flax ``nn.Dropout``: keep each element with probability 1 - rate and
    scale it by 1 / (1 - rate); the identity without ``rng`` or at rate 0,
    zeros at rate 1. ``rng`` is a 0-dim int64 seed on x's device (the mask
    is a function of (seed, site, element index): ``kernels/dropout.py``,
    the hand-written kernel on the card) or a CPU ``torch.Generator``, from
    which one seed is drawn. ``site`` tells apart the masks of the sites
    that share one seed. ``sequence``: x is (B, L, ...) positions of its
    rows; under a context axis its element indices are those of the whole
    sequence's tensor, so a context gang draws one process's masks."""
    if rng is None or not rate:
        return x
    if rate >= 1.0:
        return torch.zeros_like(x)
    if isinstance(rng, torch.Generator):
        rng = _host_seeds(1, rng)[0].to(x.device)
    span = None
    if sequence:
        from kubeflow_tpu_torch.parallel.mesh import current_context_axis

        axis = current_context_axis()
        if axis is not None:  # this rank's rows of L/ctx positions
            row = x[0].numel()
            span = (row, row * axis.size, row * axis.index)
    return device_dropout(x, rng, rate, site, span)


def block_seeds(n: int, train: bool, rate: float, generator,
                device: torch.device) -> list:
    """n dropout seeds (0-dim int64 tensors on ``device``) when training
    with dropout, else n Nones. ``generator`` is the step's
    ``DropoutSeeds``, whose next n seeds are taken, or a CPU
    ``torch.Generator``, from which n are drawn. A block hands its seed to
    each of its dropout sites, so a block recomputed under remat redraws
    its masks."""
    if not (train and rate):
        return [None] * n
    if generator is None:
        raise ValueError("train=True with dropout_rate > 0 needs a generator")
    if isinstance(generator, DropoutSeeds):
        seeds = generator.take(n, device)
    else:
        seeds = _host_seeds(n, generator).to(device)
    return list(seeds.unbind(0))


def remat(block: nn.Module, *args):
    """``block(*args)`` under torch.utils.checkpoint (non-reentrant): its
    activations are recomputed in the backward. The recompute runs with the
    parameter tensors this forward saw: under ``torch.func.functional_call``
    (``train/lora.py``'s merged weights) the module's own parameters are
    back in place by the time the backward runs, so the tensors are bound
    again for the recompute; an FSDP2 unit (``parallel/sharding.py``)
    gathers its own parameters again instead. It also runs under the
    context axis this forward saw: on the card autograd recomputes on its
    device thread, which sees none of the caller's context variables. A
    seed among ``args`` redraws its masks."""
    from kubeflow_tpu_torch.parallel.mesh import context_axis, \
        current_context_axis

    axis = current_context_axis()
    fsdp = sys.modules.get("torch.distributed.fsdp")  # loaded if in use
    if fsdp is not None and isinstance(block, fsdp.FSDPModule):
        call = block
    else:
        tensors = dict(block.named_parameters())

        def call(*a):
            return torch.func.functional_call(block, tensors, a)

    def run(*a):
        with context_axis(axis):
            return call(*a)

    return checkpoint(run, *args, use_reentrant=False)


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


def linear_then_bias(x: torch.Tensor, w: torch.Tensor,
                     b: torch.Tensor | None) -> torch.Tensor:
    """``F.linear(x, w, b)`` with flax's rounding: below float32 the
    product is rounded to the compute dtype before the bias is added (flax
    adds the bias to the rounded product); float32 keeps one call."""
    if b is None or x.dtype == torch.float32:
        return F.linear(x, w, b)
    return F.linear(x, w) + b


class DenseGeneral(nn.Module):
    """flax ``nn.DenseGeneral`` (and ``nn.Dense``, one input and one output
    dim): contracts the last ``len(in_shape)`` dims of x with a float32
    kernel of shape in_shape + out_shape, adds the bias after the product
    is rounded, in the compute dtype."""

    def __init__(self, in_shape, out_shape, use_bias: bool = True,
                 compute_dtype: torch.dtype = torch.float32,
                 device: torch.device | None = None):
        super().__init__()
        self.in_shape = tuple(in_shape) if isinstance(in_shape, (tuple, list)) \
            else (in_shape,)
        self.out_shape = tuple(out_shape) if isinstance(
            out_shape, (tuple, list)) else (out_shape,)
        self.compute_dtype = compute_dtype
        self.kernel = nn.Parameter(torch.empty(
            self.in_shape + self.out_shape, device=device))
        self.bias = (nn.Parameter(torch.zeros(self.out_shape, device=device))
                     if use_bias else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        n_in, n_out = math.prod(self.in_shape), math.prod(self.out_shape)
        lead = x.shape[:x.ndim - len(self.in_shape)]
        w = self.kernel.to(dt).reshape(n_in, n_out)
        b = None if self.bias is None else self.bias.to(dt).reshape(n_out)
        # F.linear takes (out, in): the kernel's transpose is a view
        y = linear_then_bias(x.to(dt).reshape(*lead, n_in), w.T, b)
        return y.reshape(*lead, *self.out_shape)


def Dense(in_features: int, out_features: int, use_bias: bool = True,
          compute_dtype: torch.dtype = torch.float32,
          device: torch.device | None = None) -> DenseGeneral:
    """flax ``nn.Dense``: a DenseGeneral with one input and one output dim."""
    return DenseGeneral(in_features, out_features, use_bias, compute_dtype,
                        device)


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm`` (epsilon 1e-6): statistics and normalization in
    float32 over the last dim, the result in the compute dtype."""

    def __init__(self, features: int, eps: float = 1e-6,
                 compute_dtype: torch.dtype = torch.float32,
                 device: torch.device | None = None):
        super().__init__()
        self.eps = eps
        self.compute_dtype = compute_dtype
        self.scale = nn.Parameter(torch.ones(features, device=device))
        self.bias = nn.Parameter(torch.zeros(features, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        return F.layer_norm(xf, xf.shape[-1:], self.scale, self.bias,
                            self.eps).to(self.compute_dtype)


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm`` over the last (channel) dim of NHWC tensors.

    Training (``train=True``) normalizes with the batch's statistics, taken
    in float32 as flax takes them (mean, and E[x²] − mean², the biased
    variance, clipped at 0), and moves the running averages in place:
    ``avg = momentum·avg + (1 − momentum)·stat`` with flax's momentum (0.9
    here is torch's 0.1). Eval normalizes with the running averages. The
    normalization runs in float32 and returns the compute dtype."""

    def __init__(self, features: int, momentum: float = 0.9,
                 eps: float = 1e-5, compute_dtype: torch.dtype = torch.float32,
                 zero_scale: bool = False, device: torch.device | None = None):
        super().__init__()
        self.momentum, self.eps = momentum, eps
        self.compute_dtype = compute_dtype
        self.zero_scale = zero_scale  # scale_init=zeros (the init below)
        self.scale = nn.Parameter(torch.ones(features, device=device))
        self.bias = nn.Parameter(torch.zeros(features, device=device))
        self.register_buffer("mean", torch.zeros(features, device=device))
        self.register_buffer("var", torch.ones(features, device=device))

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        xf = x.float()
        if train:
            dims = tuple(range(x.ndim - 1))
            mean = xf.mean(dims)
            var = (xf.square().mean(dims) - mean.square()).clamp_min(0.0)
            with torch.no_grad():
                m = self.momentum
                self.mean.copy_(m * self.mean + (1.0 - m) * mean)
                self.var.copy_(m * self.var + (1.0 - m) * var)
        else:
            mean, var = self.mean, self.var
        mul = torch.rsqrt(var + self.eps) * self.scale
        return ((xf - mean) * mul + self.bias).to(self.compute_dtype)


def _lecun_normal_(t: torch.Tensor, fan_in: int,
                   generator: torch.Generator) -> None:
    """flax's ``lecun_normal``: a normal truncated at ±2σ whose variance
    is 1/fan_in, drawn on the generator's device and copied in."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    draw = torch.empty(t.shape, device=generator.device)
    nn.init.trunc_normal_(draw, 0.0, std, -2 * std, 2 * std,
                          generator=generator)
    t.copy_(draw)


@torch.no_grad()
def init_module_weights(module: nn.Module,
                        generator: torch.Generator) -> None:
    """Seeded random init of every layer of ``module`` with flax's defaults:
    Dense and conv kernels lecun-normal over their fan-in, embeddings a
    truncated normal of variance 1/features, biases 0, norm scales 1 (a
    BatchNorm made with ``zero_scale`` 0), an MoE block's router and
    experts as ``MoeMlp.init_weights``. Draws in module order on the
    generator's device (CPU for a CPU generator), so a seed gives the same
    weights on any card. Parameters of other modules are left as they are."""
    from kubeflow_tpu_torch.parallel.moe import MoeMlp

    for m in module.modules():
        if isinstance(m, MoeMlp):
            m.init_weights(generator)
            continue
        if isinstance(m, DenseGeneral):
            _lecun_normal_(m.kernel, math.prod(m.in_shape), generator)
        elif isinstance(m, Conv):
            kh, kw, cin, _ = m.kernel.shape
            _lecun_normal_(m.kernel, kh * kw * cin, generator)
        elif isinstance(m, VocabEmbed):
            _lecun_normal_(m.weight, m.weight.shape[1], generator)
        elif isinstance(m, (LayerNorm, BatchNorm)):
            m.scale.fill_(0.0 if getattr(m, "zero_scale", False) else 1.0)
        else:
            continue
        if getattr(m, "bias", None) is not None:
            m.bias.zero_()


def with_compute_dtype(module: nn.Module, dtype) -> nn.Module:
    """``module`` computing in ``dtype``: a module that shares its parameters
    and buffers (the same float32 tensors, so training either trains both,
    and BatchNorm's running averages move in both) and casts to ``dtype``
    at use — the counterpart of flax's ``model.clone(dtype=...)``. Every
    submodule's ``compute_dtype`` and the ``dtype`` of every ``cfg`` change."""
    name = dtype_name(dtype)
    shared = {id(t): t for t in itertools.chain(module.parameters(),
                                                module.buffers())}
    clone = copy.deepcopy(module, shared)
    for m in clone.modules():
        cfg = getattr(m, "cfg", None)
        if dataclasses.is_dataclass(cfg) and hasattr(cfg, "dtype"):
            m.cfg = dataclasses.replace(cfg, dtype=name)
        if hasattr(m, "compute_dtype"):
            m.compute_dtype = DTYPES[name]
    return clone
