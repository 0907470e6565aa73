"""Device mesh construction — counterpart of ``kubeflow_tpu/parallel/mesh.py``.

The canonical axis vocabulary:
  data     pure data parallel (gradient all-reduce)
  fsdp     data parallel with sharded params/optimizer (ZeRO-3; FSDP2)
  model    tensor parallel (not executed yet: ROADMAP Queue A item 8)
  context  sequence/context parallel (ring and Ulysses attention)
  pipeline pipeline stages (not executed yet: item 8)
  expert   MoE expert parallel (all-to-all dispatch)

Axes are ordered outer to inner as in the JAX package. A rank of a
``torch.distributed`` gang plays the part of a JAX device: one process
drives one card (or, on the CPU, one gloo rank), and the mesh lays the
gang's ranks out over the six axes in the JAX package's device order.
``mesh_device_array`` is that arithmetic alone, with no process group, so
that it can be held against the JAX package's device arrays; ``Mesh`` wraps
the array and builds the ``torch.distributed.device_mesh.DeviceMesh`` over
the live process group when one is asked for.

``context_axis`` plays the part of the JAX package's ambient mesh for the
context axis: while it is entered, ring and Ulysses attention
(``ring_attention.py``) exchange over its group and the models number
their positions from its chunk, as ``jax.set_mesh`` makes the context
axis visible to ``shard_map`` and the partitioner.
"""

from __future__ import annotations

import contextvars
import math
from dataclasses import dataclass
from typing import Any

import numpy as np

AXIS_DATA = "data"
AXIS_FSDP = "fsdp"
AXIS_MODEL = "model"
AXIS_CONTEXT = "context"
AXIS_PIPELINE = "pipeline"
AXIS_EXPERT = "expert"

# Outer-to-inner canonical order: data-like axes outermost, model innermost.
CANONICAL_ORDER = [AXIS_DATA, AXIS_FSDP, AXIS_PIPELINE, AXIS_EXPERT,
                   AXIS_CONTEXT, AXIS_MODEL]

#: the axes a batch is split over (expert parallelism subdivides data
#: parallelism, ``parallel/moe.py``)
DATA_LIKE_AXES = (AXIS_DATA, AXIS_FSDP, AXIS_EXPERT)


@dataclass
class MeshConfig:
    """Sizes per axis; -1 on at most one axis means 'all remaining devices'."""

    data: int = -1
    fsdp: int = 1
    model: int = 1
    context: int = 1
    pipeline: int = 1
    expert: int = 1

    def sizes(self) -> dict[str, int]:
        return {
            AXIS_DATA: self.data,
            AXIS_FSDP: self.fsdp,
            AXIS_PIPELINE: self.pipeline,
            AXIS_EXPERT: self.expert,
            AXIS_CONTEXT: self.context,
            AXIS_MODEL: self.model,
        }


def resolve_sizes(config: MeshConfig, n: int) -> dict[str, int]:
    """The axis sizes of ``config`` over ``n`` devices, the -1 axis filled
    in, with the JAX package's checks and error texts."""
    sizes = config.sizes()
    wild = [a for a, s in sizes.items() if s == -1]
    if len(wild) > 1:
        raise ValueError(f"at most one axis may be -1, got {wild}")
    fixed = math.prod(s for s in sizes.values() if s != -1)
    if wild:
        if n % fixed != 0:
            raise ValueError(
                f"{n} devices not divisible by fixed axes product {fixed}"
            )
        sizes[wild[0]] = n // fixed
    elif fixed != n:
        raise ValueError(f"axis sizes {sizes} product {fixed} != {n} devices")
    return sizes


def mesh_device_array(config: MeshConfig | None, devices) -> np.ndarray:
    """The devices (ranks) laid out over the canonical axes: ``devices`` in
    order reshaped to the six axis sizes, as the JAX package's
    ``build_mesh`` reshapes ``jax.devices()``. Needs no process group."""
    config = config or MeshConfig()
    devices = list(devices)
    sizes = resolve_sizes(config, len(devices))
    shape = tuple(sizes[a] for a in CANONICAL_ORDER)
    return np.asarray(devices).reshape(shape)


def _world() -> tuple[int, int]:
    """(world size, rank) of the live process group; (1, 0) without one."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


class Mesh:
    """A mesh of gang ranks over the canonical axes: ``devices`` the
    (data, fsdp, pipeline, expert, context, model) array of ranks,
    ``shape`` the axis sizes (``jax.sharding.Mesh.shape``), and
    ``device_mesh`` the ``DeviceMesh`` over the live process group."""

    def __init__(self, devices: np.ndarray, device_type: str | None = None):
        self.devices = np.asarray(devices)
        self.axis_names = tuple(CANONICAL_ORDER)
        self.shape = dict(zip(self.axis_names, self.devices.shape))
        self.device_type = device_type
        self._device_mesh = None

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def coords(self, rank: int) -> dict[str, int]:
        """The axis coordinates of ``rank`` in this mesh."""
        where = np.argwhere(self.devices == rank)
        if not len(where):
            raise ValueError(f"rank {rank} is not in the mesh")
        return dict(zip(self.axis_names, (int(i) for i in where[0])))

    def axis_ranks(self, axes, rank: int) -> list[int]:
        """The ranks that share every coordinate of ``rank`` except those
        along ``axes``: the group a collective over ``axes`` spans, in
        mesh order."""
        keep = self.coords(rank)
        index = tuple(slice(None) if a in axes else keep[a]
                      for a in self.axis_names)
        return [int(r) for r in np.asarray(self.devices[index]).reshape(-1)]

    def axis_index(self, axes, rank: int) -> int:
        """The position of ``rank`` in its group over ``axes``."""
        return self.axis_ranks(axes, rank).index(rank)

    @property
    def device_mesh(self):
        """The ``DeviceMesh`` of this mesh over the live process group
        (built at first use; every rank must ask for it)."""
        if self._device_mesh is None:
            from torch.distributed.device_mesh import DeviceMesh

            world, _ = _world()
            if world != self.size:
                raise RuntimeError(
                    f"a DeviceMesh of {self.size} ranks needs a process "
                    f"group of that size (world {world}): run "
                    "runtime.initialize_from_env first")
            self._device_mesh = DeviceMesh(
                self.device_type or _default_device_type(), self.devices,
                mesh_dim_names=self.axis_names)
        return self._device_mesh

    def __repr__(self) -> str:
        return f"Mesh({self.shape})"


def _default_device_type() -> str:
    import torch.distributed as dist

    return ("cuda" if dist.is_initialized()
            and dist.get_backend() == "nccl" else "cpu")


def build_mesh(config: MeshConfig | None = None, devices=None,
               device_type: str | None = None) -> Mesh:
    """Build a Mesh over ``devices`` (default: every rank of the live
    process group, or the one process without one).

    Axes of size 1 are kept in the mesh so sharding specs can always name
    them."""
    if devices is None:
        devices = range(_world()[0])
    return Mesh(mesh_device_array(config, devices), device_type)


def single_device_mesh() -> Mesh:
    """1-device mesh with the full axis vocabulary (all sizes 1)."""
    return build_mesh(MeshConfig(), [_world()[1]])


def build_multislice_mesh(num_slices: int, config: MeshConfig | None = None,
                          devices=None, device_type: str | None = None
                          ) -> Mesh:
    """Mesh for a multislice job: ranks arrive slice-major (slices are
    contiguous rank ranges, ``runtime.distributed``), so the data-like
    outer axes span slices while the inner axes stay inside one. The
    outermost data x fsdp extent must be a multiple of num_slices so no
    inner axis straddles a slice boundary."""
    mesh = build_mesh(config, devices, device_type)
    dcn = mesh.shape[AXIS_DATA] * mesh.shape[AXIS_FSDP]
    if dcn % num_slices != 0:
        raise ValueError(
            f"mesh {dict(mesh.shape)}: data×fsdp = {dcn} is not a multiple "
            f"of num_slices {num_slices}; an ICI-class axis would straddle "
            f"the DCN slice boundary"
        )
    return mesh


# ---------------------------------------------------------------- context axis


@dataclass(frozen=True)
class ContextAxis:
    """This rank's place on a gang's context axis: its position ``index``
    among the ``size`` ranks that split every sequence, the process group
    over them and their global ranks in axis order (the ring's order). A
    rank holds positions [index·L_loc, (index + 1)·L_loc) of each row."""

    index: int
    size: int
    group: Any
    ranks: tuple[int, ...]

    def positions(self, l_loc: int, device=None):
        """The global positions of this rank's L_loc-long chunk: the one
        definition the models' positions, rope and the ring's causal
        masks share (JAX ``_ring_positions``)."""
        import torch

        return torch.arange(self.index * l_loc, (self.index + 1) * l_loc,
                            device=device)


_CONTEXT_AXIS = contextvars.ContextVar("kft_context_axis", default=None)


class context_axis:
    """Context manager making ``axis`` (a ContextAxis, or None for no
    context axis) the one the attention and the models see."""

    def __init__(self, axis: ContextAxis | None):
        self.axis = axis

    def __enter__(self):
        self._tok = _CONTEXT_AXIS.set(self.axis)
        return self.axis

    def __exit__(self, *exc):
        _CONTEXT_AXIS.reset(self._tok)
        return False


def current_context_axis() -> ContextAxis | None:
    """The entered context axis of more than one rank, else None."""
    axis = _CONTEXT_AXIS.get()
    return axis if axis is not None and axis.size > 1 else None


# ---------------------------------------------------------------- manual region

# Marks code running inside a pipeline stage body, where the collective
# constructs (MoE dispatch, ring and Ulysses attention) take their
# single-group form instead of opening their own exchange; the JAX package's
# marker around gpipe's shard_map bodies. No pipeline runs in the port yet
# (ROADMAP Queue A item 8), so nothing sets it but the tests.
_IN_MANUAL_REGION = contextvars.ContextVar("kft_in_manual_region",
                                           default=False)


class manual_region:
    """Context manager marking 'running inside a manual stage body'."""

    def __enter__(self):
        self._tok = _IN_MANUAL_REGION.set(True)
        return self

    def __exit__(self, *exc):
        _IN_MANUAL_REGION.reset(self._tok)
        return False


def in_manual_region() -> bool:
    """True while inside a ``manual_region``."""
    return _IN_MANUAL_REGION.get()
