"""LoRA — low-rank adaptation for parameter-efficient fine-tuning;
counterpart of ``kubeflow_tpu/train/lora.py``.

The base weights are frozen and only low-rank deltas A·B on the attention
and MLP kernels train (Hu et al. 2021). As in the JAX package:

  - the merge W + (alpha/r)·A@B happens functionally on every forward
    (``torch.func.functional_call`` over the merged tensors), so the base
    module is never edited and one wrapper adapts ``GPTLM``, the BERT
    models and ViT alike;
  - the adapters sit in flax's layout, keyed by the flax path of the
    kernel they adapt (``layer_0/attention/query/kernel/lora_a``): A is
    (in, r), drawn N(0, 0.02) from an explicit generator, and B is (r, out)
    and starts at zero, so step 0 reproduces the base model. A kernel's
    (in, out) is its logical flattening (q/k/v project hidden -> (heads,
    head_dim); attn_out contracts (heads, head_dim) -> hidden). ``GPTLM``
    keeps torch's (out, in) weights, so the targets are matched on the
    flax paths of ``convert._param_map`` and the delta is transposed to the
    weight's layout; the other families keep flax's layout already;
  - optimizer state exists for the adapters only. The JAX package needs
    ``lora_labels``/``lora_tx`` (optax.multi_transform) for that; here the
    base parameters get ``requires_grad=False`` and the port's
    ``Trainer.init_state`` builds Adam over the parameters that require
    grad, so those two have no twin.

Pipeline-stacked kernels (the JAX package's ``stages/`` layout) wait for
the pipeline axis (ROADMAP Queue A item 8). A context axis trains the
models themselves (their ``shards_sequence``), not a LoraModel over them.

Usage:
    lora = LoraModel(GPTLM(cfg), rank=8, generator=torch.Generator()
                     .manual_seed(0))
    trainer = Trainer(lora, config, loss_fn=causal_lm_loss)
"""

from __future__ import annotations

import copy
import inspect
import math
import re

import torch
from torch import nn

from kubeflow_tpu_torch.convert import _param_map, flax_key
from kubeflow_tpu_torch.models.gpt import GPTLM

# attention + MLP kernels: the standard LoRA target set
DEFAULT_TARGETS = (
    r"(query|key|value|attn_out|mlp_up|mlp_down)/kernel$"
)


def _kernel_layout(path: str, shape: tuple[int, ...]
                   ) -> tuple[int, int] | None:
    """A kernel's logical (in, out) from its flax path and shape, or None
    for shapes LoRA cannot adapt. DenseGeneral kernels are >2-D: q/k/v
    project hidden -> (heads, head_dim), so every dim after the first is
    output; attn_out contracts (heads, head_dim) -> hidden, so every dim
    before the last is input."""
    if len(shape) < 2:
        return None
    if re.search(r"attn_out/kernel", path):
        return math.prod(shape[:-1]), shape[-1]
    return shape[0], math.prod(shape[1:])


def _flax_layout(module: nn.Module) -> dict[str, tuple[str, tuple, int]]:
    """{flax path: (parameter name, flax shape, leading input dims)} of
    every parameter of ``module``: for a GPTLM its kernels' flax shapes
    (its weights are torch's (out, in); leading input dims > 0 marks a
    kernel to transpose), for the other families their own (flax's layout
    already, 0)."""
    if isinstance(module, GPTLM):
        return {fk: (tk, shape, n_in)
                for fk, tk, shape, n_in in _param_map(module.cfg)}
    return {flax_key(name): (name, tuple(p.shape), 0)
            for name, p in module.named_parameters()}


def lora_init(generator: torch.Generator, params: dict, rank: int = 8,
              targets: str = DEFAULT_TARGETS) -> dict[str, torch.Tensor]:
    """Adapters for every kernel of ``params`` ({flax path: array or
    shape}) that matches ``targets``: {path + "/lora_a": A (in, r) ~
    N(0, 0.02), path + "/lora_b": B = 0 (r, out)}, float32, A drawn in
    sorted path order from ``generator`` on its device. Raises when no
    kernel matches."""
    lora: dict[str, torch.Tensor] = {}
    for path in sorted(params):
        if not re.search(targets, path):
            continue
        shape = params[path]
        shape = tuple(shape if isinstance(shape, (tuple, list))
                      else shape.shape)
        layout = _kernel_layout(path, shape)
        if layout is None:
            continue
        n_in, n_out = layout
        lora[path + "/lora_a"] = torch.randn(
            (n_in, rank), generator=generator, device=generator.device) * 0.02
        lora[path + "/lora_b"] = torch.zeros((rank, n_out),
                                             device=generator.device)
    if not lora:
        raise ValueError(f"no kernels matched LoRA targets {targets!r}")
    return lora


def lora_merge(params: dict[str, torch.Tensor],
               lora: dict[str, torch.Tensor],
               alpha: float) -> dict[str, torch.Tensor]:
    """W + (alpha/r)·A@B for every adapted kernel of the flax-layout
    ``params`` (the delta reshaped to the kernel's shape); other entries
    pass through untouched. Purely functional: safe under autograd."""
    out = dict(params)
    for path, a in lora.items():
        if not path.endswith("/lora_a"):
            continue
        base_path = path[:-len("/lora_a")]
        b = lora[base_path + "/lora_b"]
        w = params[base_path]
        delta = (alpha / a.shape[-1]) * (a @ b)
        out[base_path] = w + delta.reshape(w.shape).to(w.dtype)
    return out


class LoraModel(nn.Module):
    """``model`` with LoRA adapters on the kernels matching ``targets``.
    The base module's parameters are frozen (``requires_grad=False``) and
    never edited; the adapters are the ``nn.ParameterDict`` ``lora``, keyed
    by flax path, so a checkpoint holds ``base.*`` and ``lora.*``.
    ``forward`` takes what the base's forward takes (``train`` and
    ``generator`` are passed on where it accepts them)."""

    def __init__(self, model: nn.Module, rank: int = 8, alpha: float = 16.0,
                 targets: str = DEFAULT_TARGETS, *,
                 generator: torch.Generator):
        super().__init__()
        layout = _flax_layout(model)
        dev = next(model.parameters()).device
        adapters = lora_init(generator, {fk: shape for fk, (_, shape, _)
                                         in layout.items()}, rank, targets)
        for p in model.parameters():
            p.requires_grad_(False)
        self._setup(model, nn.ParameterDict(
            {k: nn.Parameter(v.to(dev)) for k, v in adapters.items()}),
            rank, alpha, targets)

    def _setup(self, model, lora, rank, alpha, targets) -> None:
        self.base = model
        self.lora = lora
        self.rank, self.alpha, self.targets = rank, alpha, targets
        self._layout = _flax_layout(model)
        params = inspect.signature(model.forward).parameters
        self._accepts_train = "train" in params
        self._accepts_generator = "generator" in params
        pref = getattr(model, "PREFERRED_COMPUTE_DTYPE", None)
        if pref is not None:
            self.PREFERRED_COMPUTE_DTYPE = pref

    def with_compute_dtype(self, dtype: str) -> "LoraModel":
        """This model computing in ``dtype``: the base's
        ``with_compute_dtype`` clone (the same float32 parameters) under
        the same adapters."""
        clone = LoraModel.__new__(LoraModel)
        nn.Module.__init__(clone)
        clone._setup(self.base.with_compute_dtype(dtype), self.lora,
                     self.rank, self.alpha, self.targets)
        return clone

    def merged_params(self) -> dict[str, torch.Tensor]:
        """{parameter name of the base: W + (alpha/r)·A@B} for every
        adapted kernel, each in the base parameter's layout."""
        out = {}
        for path, a in self.lora.items():
            if not path.endswith("/lora_a"):
                continue
            fk = path[:-len("/lora_a")]
            name, shape, n_in = self._layout[fk]
            w = self.base.get_parameter(name)
            delta = ((self.alpha / self.rank)
                     * (a @ self.lora[fk + "/lora_b"])).reshape(shape)
            if n_in:  # a GPTLM kernel: flax (in..., out...) -> (out, in)
                delta = delta.reshape(math.prod(shape[:n_in]), -1).T
            out[name] = w + delta.to(w.dtype)
        return out

    def forward(self, x, train: bool = False, generator=None, **kw):
        if self._accepts_train:
            kw["train"] = train
        if self._accepts_generator and generator is not None:
            kw["generator"] = generator
        return torch.func.functional_call(self.base, self.merged_params(),
                                          (x,), kw)

    @torch.no_grad()
    def merged(self) -> nn.Module:
        """A copy of the base module with the deltas folded into its
        weights (trainable again), e.g. for ``serving.model.save_predictor``;
        this model is unchanged."""
        out = copy.deepcopy(self.base)
        for name, t in self.merged_params().items():
            out.get_parameter(name).copy_(t)
        for p in out.parameters():
            p.requires_grad_(True)
        return out
