"""Parallelism layer of the port — counterpart of
``kubeflow_tpu/parallel``: mesh building (``mesh.py``, a gang's ranks over
the JAX package's named axes), the partitioner and sharding rules, expert
dispatch (``moe.py``) and attention (``ring_attention.py``: flash,
blockwise, and the context axis' ring and Ulysses attention). The data,
fsdp, expert and context axes execute; model and pipeline are ROADMAP
Queue A item 8. ``ring_attention`` loads the kernels' wrappers, so it is
imported when first named."""

from kubeflow_tpu_torch.parallel.mesh import (
    AXIS_CONTEXT,
    AXIS_DATA,
    AXIS_EXPERT,
    AXIS_FSDP,
    AXIS_MODEL,
    AXIS_PIPELINE,
    MeshConfig,
    build_mesh,
)
from kubeflow_tpu_torch.parallel.partitioner import Partitioner

__all__ = [
    "MeshConfig",
    "Partitioner",
    "build_mesh",
    "ring_attention",
    "AXIS_DATA",
    "AXIS_FSDP",
    "AXIS_MODEL",
    "AXIS_CONTEXT",
    "AXIS_EXPERT",
    "AXIS_PIPELINE",
]


def __getattr__(name):
    if name == "ring_attention":
        import importlib

        return importlib.import_module(f"{__name__}.ring_attention")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
