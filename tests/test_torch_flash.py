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


def _flat_view(dtype, offset=0, row=32, head_dim=32, transpose=False):
    """A (1, 4, 1, head_dim) view of a flat buffer: rows `row` elements
    apart from `offset` on, or head_dim-major when `transpose`."""
    flat = torch.zeros(offset + 4 * max(row, head_dim), dtype=dtype)
    if transpose:
        return flat[offset:offset + 4 * head_dim].view(
            1, head_dim, 1, 4).transpose(1, 3)
    return flat[offset:offset + 4 * row].view(1, 4, 1, row)[..., :head_dim]


# the backward's answers since it first needed the predicate: bf16 rows go
# to the card 16 bytes at a time, f32 rows are read by stride as they come
LAYOUTS = [
    (torch.bfloat16, {}, True),
    (torch.bfloat16, {"offset": 8}, True),
    (torch.bfloat16, {"offset": 1}, False),
    (torch.bfloat16, {"row": 36}, False),
    (torch.bfloat16, {"row": 40}, True),
    (torch.bfloat16, {"transpose": True}, False),
    (torch.float32, {"offset": 1, "row": 33}, True),
    (torch.float32, {"transpose": True}, False),
]


@pytest.mark.parametrize("dtype,view,readable", LAYOUTS)
def test_shared_readable_in_place(dtype, view, readable):
    """One predicate for the forward and the backward, with the answers the
    backward gave before it was shared."""
    from kubeflow_tpu_torch.kernels import _layout
    from kubeflow_tpu_torch.kernels import flash_bwd as kb

    assert kb.readable_in_place is _layout.readable_in_place
    assert _layout.readable_in_place(_flat_view(dtype, **view)) is readable


@pytest.mark.parametrize("dtype,view,form", [
    (torch.bfloat16, {}, "vector"),
    (torch.bfloat16, {"offset": 1}, "scalar"),
    (torch.bfloat16, {"row": 36}, "scalar"),
    (torch.float32, {"row": 36}, "vector"),   # 144-byte rows: whole 16s
    (torch.float32, {"offset": 1, "row": 33}, "scalar"),
    (torch.float32, {"transpose": True}, "scalar"),
    (torch.bfloat16, {"row": 48, "head_dim": 48}, "scalar"),  # no such D
])
def test_dd_form(dtype, view, form):
    """flash_bwd_dd reads 16 bytes a lane only where both tensors' rows
    allow it; every other layout takes the scalar form."""
    from kubeflow_tpu_torch.kernels import flash_bwd as kb

    x = _flat_view(dtype, **view)
    aligned = torch.zeros(x.shape, dtype=dtype)
    assert kb._dd_path(aligned, x) == form
    assert kb._dd_path(x, aligned) == form


def test_forward_hands_the_kernel_readable_inputs(monkeypatch):
    """q, k, v that the kernel cannot copy 16 bytes at a time (a misaligned
    bf16 view) or read as contiguous (a transposed view) reach the forward
    as contiguous copies with the same values; readable ones as they are."""
    from kubeflow_tpu_torch.kernels._layout import readable_in_place

    seen = []

    def capture(q, k, v, bias, *args):
        seen.append((q, k, v))
        return (torch.zeros_like(q),
                torch.zeros(q.shape[0], q.shape[2], q.shape[1]))

    monkeypatch.setattr(tra, "flash_forward", capture)
    q, k, v, bias = (torch.from_numpy(a).to(torch.bfloat16)
                     for a in make_inputs(8))
    shifted = torch.zeros(1 + k.numel(), dtype=k.dtype)[1:].view(k.shape)
    shifted.copy_(k)
    swapped = v.transpose(1, 2).contiguous().transpose(1, 2)
    assert not readable_in_place(shifted) and not swapped.is_contiguous()
    tra.flash_attention(q, shifted, swapped, bias, causal=True)
    got_q, got_k, got_v = seen[0]
    assert got_q is q
    for got, want in ((got_k, shifted), (got_v, swapped)):
        assert got.is_contiguous() and readable_in_place(got)
        assert torch.equal(got, want)


def test_kernel_record_counts_forms():
    """A launch counts once in ``launches`` and, when it names a form, once
    for that form (flash_bwd_dd's 16-byte and scalar forms)."""
    from kubeflow_tpu_torch.kernels.build import Kernel

    kern = Kernel("flash_bwd_dd", "flash_bwd.cu", "ring_attention.py:1279")
    kern.count_launch()
    kern.count_launch("vector")
    kern.count_launch("vector")
    kern.count_launch("scalar")
    assert kern.launches == 4 and kern.forms == {"vector": 2, "scalar": 1}
