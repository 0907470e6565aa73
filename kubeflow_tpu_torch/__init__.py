"""kubeflow_tpu_torch — the PyTorch/CUDA port of kubeflow_tpu for Hopper.

Module names mirror the JAX package (``kubeflow_tpu``), which stays the
numerics reference: ``models/gpt.py`` here is the counterpart of
``kubeflow_tpu/models/gpt.py`` there, and so on. The port imports torch and
never JAX or anything of the JAX package. Entry points run on the card
(``device="cuda"``) unless the caller asks for ``device="cpu"``.

Hand-written kernels live in ``csrc/`` (CUDA C++ for sm_90a) and are built
and bound by ``kernels/``; each has a plain PyTorch version beside it that
the CPU path and the tests use.
"""
