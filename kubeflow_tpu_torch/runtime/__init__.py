"""Runtime layer of the port: the worker side of the gang contract
(``runtime/distributed.py``). The JAX package's process launcher
(``runtime/local.py``) is a control-plane module of a later slice (ROADMAP
Queue A item 12)."""

from kubeflow_tpu_torch.runtime.distributed import (
    DistContext,
    initialize_from_env,
    shutdown,
)

__all__ = ["DistContext", "initialize_from_env", "shutdown"]
