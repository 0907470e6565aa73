"""What the kernels' 16-byte copies need of a (B, L, H, D) tensor.

The bf16 tensor-core kernels (forward and backward) copy rows into shared
memory 16 bytes at a time (cp.async), and flash_bwd_dd reads them 16 bytes at
a time: the tensor has to start 16-byte aligned and its batch, position and
head strides have to be whole 16-byte groups. One predicate, shared by every
wrapper that checks it and by the autograd function that copies a tensor
the kernels cannot read in place.
"""

from __future__ import annotations

import torch


def async_copy_fault(t: torch.Tensor) -> str | None:
    """What a (B, L, H, D) tensor lacks for 16-byte copies of its rows (a
    16-byte-aligned start, and batch, position and head strides that are
    multiples of 16 bytes on dims longer than 1), or None."""
    if t.data_ptr() % 16:
        return ("starts at an address that is not 16-byte aligned (storage "
                f"offset {t.storage_offset()})")
    per = 16 // t.element_size()
    for dim, what in enumerate(("batch", "position", "head")):
        if t.shape[dim] > 1 and t.stride(dim) % per:
            return (f"has {what} stride {t.stride(dim)}, not a multiple of "
                    f"{per} elements")
    return None


def readable_in_place(t: torch.Tensor) -> bool:
    """Whether the kernels can read the (B, L, H, D) tensor ``t`` as it is:
    a unit head_dim stride and, in bfloat16, what the 16-byte copies need.
    Where not, a contiguous copy (``clone``, which also realigns) can."""
    if t.stride(3) != 1 and t.shape[3] != 1:
        return False
    return t.dtype != torch.bfloat16 or async_copy_fault(t) is None


def readable(t: torch.Tensor) -> torch.Tensor:
    """``t`` if the forward kernels can read it as it is (contiguous and
    ``readable_in_place``), else a contiguous copy."""
    if t.is_contiguous() and readable_in_place(t):
        return t
    return t.clone(memory_format=torch.contiguous_format)
