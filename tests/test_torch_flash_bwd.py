"""The port's flash-attention backward against the JAX package's.

On the CPU the port's backward runs its plain version (the counterpart of
``_flash_backward_xla``); the JAX package's runs its Pallas backward kernels
in interpret mode, as ``tests/test_ring_attention.py`` does. Inputs come from
a numpy seed: q/k/v/dO normal, a bias of 0.3·normal (the JAX test's), and
every query row keeps at least one visible key. The hand-written kernels are
held against the plain version on a card in ``test_torch_kernels.py``.
"""

import os
import subprocess
import sys

import jax
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

B, H, D, BLOCK = 2, 4, 16, 8
TOL = dict(atol=1e-5, rtol=1e-5)  # f32 on both sides, sums in another order
NAMES = ("dq", "dk", "dv", "dbias")


def make_inputs(lq, lk, seed=0):
    rng = np.random.RandomState(seed)
    q = rng.normal(size=(B, lq, H, D)).astype(np.float32)
    k, v = (rng.normal(size=(B, lk, H, D)).astype(np.float32)
            for _ in range(2))
    bias = (0.3 * rng.normal(size=(B, 1, 1, lk))).astype(np.float32)
    g = rng.normal(size=(B, lq, H, D)).astype(np.float32)
    return q, k, v, bias, g


# each JAX backward impl meets each mask at least once; (Lq, Lk) = (16, 32)
# is the Lq ≠ Lk case (rows and cols both counted from 0)
CASES = [
    ("xla", 32, 32, False, 0), ("scratch", 32, 32, True, 0),
    ("loop2", 32, 32, True, 5), ("ddpre", 32, 32, True, 40),
    ("scratch", 16, 32, False, 0), ("xla", 16, 32, True, 5),
    ("loop2", 16, 32, True, 0), ("ddpre", 16, 32, True, 40),
]


@pytest.mark.parametrize("impl,lq,lk,causal,window", CASES)
def test_backward_matches_jax(impl, lq, lk, causal, window):
    q, k, v, bias, g = make_inputs(lq, lk)
    jq, jk, jv, jb, jg = (jnp.asarray(a) for a in (q, k, v, bias, g))
    out, lse = jra._flash_forward(jq, jk, jv, jb, BLOCK, BLOCK, causal,
                                  want_lse=True, window=window)
    want = jra._flash_backward(jq, jk, jv, jb, out, lse, jg, BLOCK, BLOCK,
                               causal, impl=impl, window=window)
    tq, tk, tv, tb, tg = (torch.from_numpy(a) for a in (q, k, v, bias, g))
    with torch.no_grad():
        t_out, t_lse = tra.flash_forward(tq, tk, tv, tb, BLOCK, BLOCK,
                                         causal, window)
    got = tra.flash_backward(tq, tk, tv, tb, t_out, t_lse, tg, BLOCK, BLOCK,
                             causal, impl=impl, window=window)
    for name, a, w in zip(NAMES, got, want):
        assert a.shape == w.shape and a.dtype == torch.float32, name
        np.testing.assert_allclose(a.numpy(), np.asarray(w), err_msg=name,
                                   **TOL)
    plain = tra.flash_backward_plain(tq, tk, tv, tb, t_out, t_lse, tg, BLOCK,
                                     causal, window, want_dbias=False)
    assert plain[3] is None  # dbias only when asked for
    for a, b in zip(plain[:3], got[:3]):
        torch.testing.assert_close(a, b, atol=0, rtol=0)


def _jax_grads(fn, q, k, v, bias, w):
    def loss(q, k, v, bias):
        return (fn(q, k, v, bias) * w).sum()

    return jax.grad(loss, argnums=(0, 1, 2, 3))(
        *(jnp.asarray(a) for a in (q, k, v, bias)))


def _torch_grads(q, k, v, bias, w, **kw):
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v, bias)]
    out = tra.flash_attention(*leaves, **kw)
    return torch.autograd.grad((out * torch.from_numpy(w)).sum(), leaves)


# (L, causal, window): the fused path's tilings, and L = 36, which block 8
# does not tile: JAX falls back to blockwise attention and its FA2 custom
# backward, the port to one plain block
@pytest.mark.parametrize("L,causal,window", [(32, False, 0), (32, True, 5),
                                             (36, True, 0), (36, True, 9)])
def test_autograd_matches_jax_grad(L, causal, window):
    q, k, v, bias, w = make_inputs(L, L, seed=1)
    want = _jax_grads(
        lambda *a: jra.flash_attention(*a, block=BLOCK, causal=causal,
                                       window=window), q, k, v, bias, w)
    got = _torch_grads(q, k, v, bias, w, block=BLOCK, causal=causal,
                       window=window)
    for name, a, b in zip(NAMES, got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), err_msg=name,
                                   **TOL)


def test_dbias_only_when_bias_needs_grad():
    q, k, v, bias, w = make_inputs(16, 16, seed=2)
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    tb = torch.from_numpy(bias)  # no grad: the backward skips dbias
    out = tra.flash_attention(*leaves, tb, block=BLOCK, causal=True)
    (out * torch.from_numpy(w)).sum().backward()
    assert all(t.grad is not None for t in leaves) and tb.grad is None


def test_refusals():
    q, k, v, bias, g = (torch.from_numpy(a) for a in make_inputs(16, 16))
    with torch.no_grad():
        out, lse = tra.flash_forward(q, k, v, bias, BLOCK, BLOCK, True)
    with pytest.raises(ValueError, match="unknown flash backward impl"):
        tra.flash_backward(q, k, v, bias, out, lse, g, BLOCK, BLOCK, True,
                           impl="Loop2")
    with pytest.raises(NotImplementedError, match="raw forward"):
        tra.flash_forward(q.requires_grad_(), k, v, bias)
    # blockwise attention trains: its FA2 custom backward
    # (tests/test_torch_context.py holds it against the JAX package's)
    tra.blockwise_attention(q, k, v, bias).sum().backward()
    assert q.grad is not None and torch.isfinite(q.grad).all()
    # the env override is validated when the module is imported
    proc = subprocess.run(
        [sys.executable, "-c",
         "import kubeflow_tpu_torch.parallel.ring_attention"],
        env={**os.environ, "KFT_FLASH_BWD_IMPL": "Loop2",
             "PYTHONPATH": os.pathsep.join(sys.path)},
        capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and "KFT_FLASH_BWD_IMPL" in proc.stderr


def test_kernel_wrappers_refuse_cpu_tensors():
    from kubeflow_tpu_torch.kernels import flash_bwd as kb

    q, k, v, bias, g = (torch.from_numpy(a) for a in make_inputs(16, 16))
    lse = torch.zeros((B, H, 16))
    before = [x.launches for x in (kb.FLASH_BWD_DD, kb.FLASH_BWD_DQ,
                                   kb.FLASH_BWD_DKV)]
    with pytest.raises(ValueError, match="not CUDA|not the CUDA device"):
        kb.flash_bwd_dd(q, g)
    with pytest.raises(ValueError, match="not CUDA"):
        kb.flash_bwd_dq(q, k, v, bias, q, g, lse, lse, True)
    with pytest.raises(ValueError, match="not CUDA"):
        kb.flash_bwd_dkv(q, k, v, bias, q, g, lse, None, True)
    assert [x.launches for x in (kb.FLASH_BWD_DD, kb.FLASH_BWD_DQ,
                                 kb.FLASH_BWD_DKV)] == before


def _view(dtype, offset=0, row=32, head_dim=32, transpose=False):
    """A (1, 4, 1, head_dim) view of a flat buffer: rows `row` elements
    apart from `offset` on, or head_dim-major when `transpose`."""
    flat = torch.zeros(offset + 4 * max(row, head_dim), dtype=dtype)
    if transpose:
        return flat[offset:offset + 4 * head_dim].view(
            1, head_dim, 1, 4).transpose(1, 3)
    return flat[offset:offset + 4 * row].view(1, 4, 1, row)[..., :head_dim]


# bf16 rows go to the card 16 bytes at a time: a 16-byte-aligned start and
# strides of whole 8-element groups; f32 is read by stride as it comes
@pytest.mark.parametrize("dtype,view,readable", [
    (torch.bfloat16, {}, True),
    (torch.bfloat16, {"offset": 8}, True),
    (torch.bfloat16, {"offset": 1}, False),
    (torch.bfloat16, {"row": 36}, False),
    (torch.bfloat16, {"row": 40}, True),
    (torch.bfloat16, {"transpose": True}, False),
    (torch.float32, {"offset": 1, "row": 33}, True),
    (torch.float32, {"transpose": True}, False),
])
def test_readable_in_place(dtype, view, readable):
    from kubeflow_tpu_torch.kernels import flash_bwd as kb

    assert kb.readable_in_place(_view(dtype, **view)) is readable


def test_backward_hands_the_kernels_a_readable_grad(monkeypatch):
    """autograd may hand over dO as a misaligned view: the backward copies
    it (values unchanged) instead of letting the kernel wrappers refuse it."""
    from kubeflow_tpu_torch.kernels import flash_bwd as kb

    seen = []

    def capture(q, k, v, bias, o, lse, g, *args, **kwargs):
        seen.append(g)
        return (torch.zeros_like(q), torch.zeros_like(k),
                torch.zeros_like(v), None)

    monkeypatch.setattr(tra, "flash_backward", capture)
    q, k, v, bias, _ = (torch.from_numpy(a).to(torch.bfloat16)
                        for a in make_inputs(4, 4))
    leaves = [t.requires_grad_() for t in (q, k, v)]
    out = tra.flash_attention(*leaves, bias, block=BLOCK, causal=True)
    g = torch.randn(1 + out.numel()).to(out.dtype)[1:].view(out.shape)
    assert not kb.readable_in_place(g)
    torch.autograd.grad(out, leaves, g)
    assert kb.readable_in_place(seen[0]) and torch.equal(seen[0], g)
