"""The port's flash attention against the JAX package's.

On the CPU the port's ``flash_attention`` runs its plain version; the JAX
package's runs its Pallas kernel in interpret mode, as its own tests do. The
same inputs, made from a numpy seed, go through both. The hand-written
kernel is held against the plain version on a card in
``test_torch_kernels.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeflow_tpu.parallel import ring_attention as jra
from kubeflow_tpu_torch.parallel import ring_attention as tra

try:  # one intra-op thread: the suite shares the machine with timing gates
    torch.set_num_threads(1)
    torch.set_num_interop_threads(1)
except RuntimeError:  # the interop pool can be sized once per process
    pass

B, H, D = 2, 2, 16
PAD = 3  # the last keys of the second row carry the -1e9 pad bias


def make_inputs(L, seed=0):
    rng = np.random.RandomState(seed)
    q, k, v = (rng.normal(0, 1, (B, L, H, D)).astype(np.float32)
               for _ in range(3))
    bias = np.zeros((B, 1, 1, L), np.float32)
    bias[1, ..., L - PAD:] = -1e9
    return q, k, v, bias


# (L, block): two tilings and a ragged L that takes the JAX blockwise fallback
CASES = [(L, block, causal, window)
         for L, block in ((16, 8), (32, 16), (20, 8))
         for causal, window in ((False, 0), (True, 0), (True, 5), (True, 20))]


@pytest.mark.parametrize("L,block,causal,window", CASES)
def test_flash_matches_jax(L, block, causal, window):
    q, k, v, bias = make_inputs(L)
    want, want_lse = jra._flash_forward(
        *(jnp.asarray(a) for a in (q, k, v, bias)), block, block, causal,
        want_lse=True, window=window)
    tq, tk, tv, tb = (torch.from_numpy(a) for a in (q, k, v, bias))
    got = tra.flash_attention(tq, tk, tv, tb, block=block, causal=causal,
                              window=window)
    # f32 throughout; the tolerance of tests/test_ring_attention.py
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)
    _, lse = tra.flash_forward(tq, tk, tv, tb, block, block, causal, window)
    assert lse.shape == (B, H, L) and lse.dtype == torch.float32
    if want_lse is not None:  # the tiled cases: the kernel's logsumexp
        np.testing.assert_allclose(
            lse.reshape(B * H, L).numpy(), np.asarray(want_lse)[..., 0],
            atol=1e-5)


@pytest.mark.parametrize("causal,window", [(False, 0), (True, 0), (True, 5)])
def test_blockwise_matches_jax(causal, window):
    q, k, v, bias = make_inputs(32, seed=1)
    want = jra.blockwise_attention(*(jnp.asarray(a) for a in (q, k, v, bias)),
                                   block=8, causal=causal, window=window)
    got = tra.blockwise_attention(*(torch.from_numpy(a)
                                    for a in (q, k, v, bias)),
                                  block=8, causal=causal, window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)


def test_refusals():
    q, k, v, bias = (torch.from_numpy(a) for a in make_inputs(16))
    with pytest.raises(NotImplementedError, match="dropout"):
        tra.flash_attention(q, k, v, bias, dropout_rate=0.1)
    with pytest.raises(ValueError, match="requires causal"):
        tra.flash_attention(q, k, v, bias, window=4)
    with pytest.raises(ValueError, match="requires causal"):
        tra.blockwise_attention(q, k, v, bias, window=4)
    # inputs that require grad are taken: the backward is the flash backward
    out = tra.flash_attention(q.requires_grad_(), k, v, bias, causal=True)
    out.sum().backward()
    assert q.grad.shape == q.shape and torch.isfinite(q.grad).all()


def test_kernel_wrapper_refuses_cpu_tensors():
    from kubeflow_tpu_torch.kernels.flash_fwd import FLASH_FWD, flash_fwd

    q, k, v, bias = (torch.from_numpy(a) for a in make_inputs(16))
    before = FLASH_FWD.launches
    with pytest.raises(ValueError, match="not CUDA"):
        flash_fwd(q, k, v, bias, causal=True)
    # the CPU path runs the plain version and never counts a launch
    tra.flash_attention(q, k, v, bias, causal=True)
    assert FLASH_FWD.launches == before
