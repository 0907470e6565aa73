"""T5X-style partitioner — counterpart of
``kubeflow_tpu/parallel/partitioner.py``: one derivation owns every
parameter's placement, in three tiers (first hit wins):

  1. explicit path rules   (regex → spec; the models' PARTITION_RULES)
  2. logical axis rules    (path → logical dim names → mesh axes)
  3. FSDP heuristic        (largest divisible dim over `fsdp`)

A spec is the value a JAX ``PartitionSpec`` holds: a tuple with one entry a
dimension, each None (replicated), a mesh axis name, or a tuple of them
(``PartitionSpec`` here is that tuple). Paths and shapes are the flax
layout's (``convert.py``), so a port model gets the very specs the JAX
package derives for its twin; ``placements`` turns a spec into the DTensor
placements over a ``DeviceMesh``. A named dim that does not divide its
mesh-axis product is replicated (that dim drops to None).

The JAX partitioner's two step-level hooks map onto torch so:
``constrain_grads`` is the identity (there is no compiler to pin a layout
for: the gradient collectives are issued where the backward produces the
grads, ``parallel/sharding.py``), and ``deterministic_rng`` is the rule
that a model is initialised whole from one generator and sharded after, so
every layout starts from the same weights.
"""

from __future__ import annotations

import math
import re
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Any, Sequence

from kubeflow_tpu_torch.parallel.mesh import (
    AXIS_CONTEXT,
    AXIS_DATA,
    AXIS_EXPERT,
    AXIS_FSDP,
    AXIS_MODEL,
    AXIS_PIPELINE,
    CANONICAL_ORDER,
    Mesh,
    MeshConfig,
    build_mesh,
    build_multislice_mesh,
)


class PartitionSpec(tuple):
    """``jax.sharding.PartitionSpec``'s value: one entry a dimension."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec

#: params with fewer elements than this replicate under the heuristic
#: (sharding a 128-float bias wastes a collective)
DEFAULT_MIN_SIZE = 2**12

#: accepted spellings for mesh axes in logical rules — "tensor" is the
#: T5X/Megatron name for what the mesh calls `model`
AXIS_ALIASES = {"tensor": AXIS_MODEL}

LogicalAxisRules = Sequence[tuple[str, Any]]
PathLogicalRules = Sequence[tuple[str, tuple]]
PathSpecRules = Sequence[tuple[str, PartitionSpec]]

#: The default logical vocabulary (the JAX package's).
DEFAULT_LOGICAL_AXIS_RULES: tuple[tuple[str, Any], ...] = (
    ("batch", (AXIS_DATA, AXIS_FSDP, AXIS_EXPERT)),
    ("embed", AXIS_FSDP),
    ("heads", "tensor"),
    ("mlp", "tensor"),
    ("vocab", "tensor"),
    ("expert", AXIS_EXPERT),
    ("length", AXIS_CONTEXT),
    ("stage", AXIS_PIPELINE),
    ("kv", None),
    ("stack", None),
    ("norm", None),
    ("pos", None),
)

#: Param-path → logical names for the in-tree transformer families; rank-
#: aware (the first pattern whose arity equals the param's rank wins).
DEFAULT_PATH_LOGICAL_RULES: tuple[tuple[str, tuple], ...] = (
    (r"(query|key|value)/kernel$", ("embed", "heads", "kv")),
    (r"(query|key|value)/kernel$", ("embed", "heads")),
    (r"attn_out/kernel$", ("heads", "kv", "embed")),
    (r"attn_out/kernel$", ("heads", "embed")),
    (r"(mlp_up|mlp_gate)/kernel$", ("embed", "mlp")),
    (r"mlp_down/kernel$", ("mlp", "embed")),
    (r"token_embed/embedding$", ("vocab", "embed")),
    (r"(position_embed|type_embed)/embedding$", ("pos", "embed")),
    (r"lm_head/kernel$", ("embed", "vocab")),
    (r"(pooler|mlm_dense)/kernel$", ("embed", "mlp")),
    (r"moe/(w_up|w_gate)$", ("expert", "embed", "mlp")),
    (r"moe/(b_up|b_gate)$", ("expert", "mlp")),
    (r"moe/w_down$", ("expert", "mlp", "embed")),
    (r"moe/b_down$", ("expert", "embed")),
)


def _axes(entry) -> tuple:
    return entry if isinstance(entry, tuple) else (entry,)


def heuristic_pspec(shape: tuple[int, ...], fsdp_size: int,
                    min_size: int = DEFAULT_MIN_SIZE) -> PartitionSpec:
    """The FSDP fallback: shard the largest dim divisible by fsdp_size;
    tiny params replicate."""
    if fsdp_size <= 1 or math.prod(shape) < min_size:
        return P()
    candidates = [i for i, d in enumerate(shape) if d % fsdp_size == 0]
    if not candidates:
        return P()
    dim = max(candidates, key=lambda i: shape[i])
    spec: list[Any] = [None] * len(shape)
    spec[dim] = AXIS_FSDP
    return P(*spec)


def _axes_size(entry, mesh: Mesh) -> int:
    return math.prod(mesh.shape[a] for a in _axes(entry))


def spec_fits(spec, shape: tuple[int, ...], mesh: Mesh) -> bool:
    """All-or-nothing divisibility check: rank must not exceed the shape's
    and every named dim must divide its mesh-axis product."""
    if len(spec) > len(shape):
        return False
    for dim, axes in enumerate(spec):
        if axes is not None and shape[dim] % _axes_size(axes, mesh) != 0:
            return False
    return True


def fit_spec(spec, shape: tuple[int, ...], mesh: Mesh) -> PartitionSpec:
    """Per-dimension fallback: a named dim whose size does not divide its
    mesh-axis product replicates; a spec longer than the shape's rank
    replicates entirely."""
    if len(spec) > len(shape):
        return P()
    out: list[Any] = []
    for dim, axes in enumerate(spec):
        if axes is None:
            out.append(None)
            continue
        size = _axes_size(axes, mesh)
        out.append(axes if size and shape[dim] % size == 0 else None)
    return P(*out)


def resolve_pspec(path_str: str, shape: tuple[int, ...], mesh: Mesh,
                  rules: PathSpecRules | None,
                  min_size: int = DEFAULT_MIN_SIZE) -> PartitionSpec:
    """The legacy derivation: explicit path rules with all-or-nothing fit,
    then the heuristic."""
    if len(shape) == 0:
        return P()
    if rules:
        for pattern, spec in rules:
            if re.search(pattern, path_str) and spec_fits(spec, shape, mesh):
                return P(*spec)
    return heuristic_pspec(shape, mesh.shape[AXIS_FSDP], min_size)


def path_str_of(path) -> str:
    """'/'-joined tree path of keys, attribute names or indices."""
    parts = []
    for k in path:
        for attr in ("key", "name", "idx"):
            if hasattr(k, attr):
                parts.append(str(getattr(k, attr)))
                break
        else:
            parts.append(str(k))
    return "/".join(parts)


def placements(spec, mesh: Mesh) -> list:
    """A spec as DTensor placements over ``mesh`` (one a mesh axis, in
    CANONICAL_ORDER): Shard(d) on each axis that splits dim d, Replicate
    elsewhere. Several axes on one dim split it in mesh order, as a JAX
    spec's tuple entry does."""
    from torch.distributed.tensor import Replicate, Shard

    where = {}
    for dim, entry in enumerate(spec):
        if entry is not None:
            for a in _axes(entry):
                where[a] = dim
    return [Shard(where[a]) if a in where else Replicate()
            for a in CANONICAL_ORDER if a in mesh.shape]


# --------------------------------------------------------- comm accounting

#: process-global gradient-communication ledger: host seconds blocked on
#: gradient collectives, and the latest overlapped/serialized step-time
#: ratio measured (1.0 = no overlap won)
_COMM_METRICS = {
    "comm_seconds_total": 0.0,
    "overlap_measurements_total": 0,
}
_LAST_OVERLAP_RATIO = 0.0


def record_comm(seconds: float, overlap_ratio: float | None = None) -> None:
    """Account gradient-communication wall time (and optionally a new
    overlap-ratio measurement) into the process-global ledger."""
    global _LAST_OVERLAP_RATIO
    _COMM_METRICS["comm_seconds_total"] += float(seconds)
    if overlap_ratio is not None:
        _COMM_METRICS["overlap_measurements_total"] += 1
        _LAST_OVERLAP_RATIO = float(overlap_ratio)


def comm_metrics_snapshot() -> dict:
    return dict(_COMM_METRICS, overlap_ratio=_LAST_OVERLAP_RATIO)


def reset_comm_metrics() -> None:
    global _LAST_OVERLAP_RATIO
    _COMM_METRICS["comm_seconds_total"] = 0.0
    _COMM_METRICS["overlap_measurements_total"] = 0
    _LAST_OVERLAP_RATIO = 0.0


@dataclass
class Partitioner:
    """Derives every spec the trainer needs from one rule set.

    Pass a ready ``mesh``, or a ``mesh_config`` (+ ``num_slices`` > 1 for
    the multislice mesh and its guard). Derivation order for a leaf:
      1. ``path_specs`` — explicit regex → spec, fitted per dim;
      2. ``path_logical`` + ``logical_rules`` — path → logical names →
         mesh axes (unknown names replicate, or raise under ``strict``);
      3. the FSDP heuristic."""

    mesh: Mesh | None = None
    mesh_config: MeshConfig | None = None
    num_slices: int = 1
    path_specs: PathSpecRules | None = None
    path_logical: PathLogicalRules = DEFAULT_PATH_LOGICAL_RULES
    logical_rules: LogicalAxisRules = DEFAULT_LOGICAL_AXIS_RULES
    min_size: int = DEFAULT_MIN_SIZE
    strict: bool = False
    _logical_map: dict = field(init=False, repr=False, default_factory=dict)

    def __post_init__(self):
        if self.mesh is None:
            cfg = self.mesh_config or MeshConfig()
            self.mesh = (build_multislice_mesh(self.num_slices, cfg)
                         if self.num_slices > 1 else build_mesh(cfg))
        for name, axes in self.logical_rules:
            if name not in self._logical_map:
                self._logical_map[name] = self._canon(axes)

    @staticmethod
    def _canon(axes):
        if axes is None:
            return None
        if isinstance(axes, (tuple, list)):
            return tuple(AXIS_ALIASES.get(a, a) for a in axes)
        return AXIS_ALIASES.get(axes, axes)

    def mesh_axes_for(self, logical: str):
        """Mesh axis (or tuple, or None) for one logical dim name."""
        if logical in self._logical_map:
            return self._logical_map[logical]
        if self.strict:
            raise ValueError(
                f"no logical axis rule for {logical!r} "
                f"(rules: {[n for n, _ in self.logical_rules]})")
        return None

    def logical_to_spec(self, logical_axes, shape) -> PartitionSpec:
        spec = P(*(None if name is None else self.mesh_axes_for(name)
                   for name in logical_axes))
        return fit_spec(spec, shape, self.mesh)

    def logical_axes_for_path(self, path_str: str,
                              rank: int | None = None) -> tuple | None:
        for pattern, names in self.path_logical:
            if re.search(pattern, path_str) and (
                    rank is None or len(names) == rank):
                return tuple(names)
        return None

    def spec_for(self, path_str: str, shape: tuple[int, ...]
                 ) -> PartitionSpec:
        """The full three-tier derivation for one leaf (flax path and
        shape)."""
        shape = tuple(shape)
        if len(shape) == 0:
            return P()
        if self.path_specs:
            for pattern, spec in self.path_specs:
                if re.search(pattern, path_str):
                    return fit_spec(spec, shape, self.mesh)
        logical = self.logical_axes_for_path(path_str, rank=len(shape))
        if logical is not None:
            return self.logical_to_spec(logical, shape)
        return heuristic_pspec(shape, self.mesh.shape[AXIS_FSDP],
                               self.min_size)

    def state_shardings(self, leaves: dict) -> dict:
        """{path: (spec, placements)} for a flat {path: shape-or-tensor}
        state: what a sharded state and its checkpoint restore target
        hold."""
        out = {}
        for path, leaf in leaves.items():
            spec = self.spec_for(path, tuple(getattr(leaf, "shape", leaf)))
            out[path] = (spec, placements(spec, self.mesh))
        return out

    def grad_specs(self, leaves: dict) -> dict:
        """{path: spec}: gradients share the parameter layout."""
        return {path: self.spec_for(path, tuple(getattr(leaf, "shape", leaf)))
                for path, leaf in leaves.items()}

    def constrain_grads(self, grads):
        """The identity: the port issues each gradient's collective where
        its backward produces it (``parallel/sharding.py``)."""
        return grads

    @contextmanager
    def deterministic_rng(self):
        """Layout-invariant random init: the port initialises a model whole
        from one generator and shards it after, so nothing is drawn per
        layout; the context exists for the JAX call sites' shape."""
        yield

    def key_fields(self) -> dict:
        """Everything about this partitioner that changes the step, in
        stable string form."""
        def spec_s(spec):
            return repr(tuple(spec))

        return {
            "mesh": tuple(sorted(self.mesh.shape.items())),
            "num_slices": self.num_slices,
            "path_specs": tuple(
                (p, spec_s(s)) for p, s in (self.path_specs or ())),
            "path_logical": tuple(
                (p, tuple(n)) for p, n in self.path_logical),
            "logical_rules": tuple(sorted(
                (k, "+".join(v) if isinstance(v, tuple) else str(v))
                for k, v in self._logical_map.items())),
            "min_size": self.min_size,
        }
