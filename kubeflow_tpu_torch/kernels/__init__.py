"""Hand-written Hopper kernels of the port: build, binding, wrappers.

Each kernel has a ``Kernel`` record (name, CUDA source, the TPU kernel it
replaces, a launch count) in ``KERNELS``; its wrapper launches it on CUDA
tensors and its plain PyTorch version lives beside its caller (for the
flash-attention kernels, forward and backward:
``parallel/ring_attention.py``) or beside the wrapper (dropout:
``kernels/dropout.py``).
"""

from kubeflow_tpu_torch.kernels.build import KERNELS, Kernel, build_all

__all__ = ["KERNELS", "Kernel", "build_all"]
