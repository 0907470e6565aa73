"""Device selection — the counterpart of ``kubeflow_tpu/utils/device.py``.

The JAX package pins a JAX platform from a ``--device=tpu|cpu`` flag; the
port resolves ``--device=cuda|cpu`` to a ``torch.device``. ``cuda`` is the
default, and asking for it on a machine without a card raises: a port entry
point never carries on quietly on the CPU.
"""

from __future__ import annotations

import torch


def select_device(device: str | torch.device = "cuda") -> torch.device:
    """Resolve ``"cuda"`` (default, also ``"cuda:N"``) or ``"cpu"``.

    Raises ValueError for any other name and RuntimeError when a card is
    asked for and none is visible."""
    dev = torch.device(device)
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise ValueError(f"unknown device {str(device)!r}; expected cuda|cpu")
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but torch sees no CUDA device;"
            " pass device='cpu' to run on the CPU")
    return dev
