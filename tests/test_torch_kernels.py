"""The hand-written CUDA kernels against their plain versions, on a card.

Marked ``cuda``: each test decides inside itself whether a card is there
and skips without one (a CUDA kernel has no CPU mode). No JAX here, so the
file runs on the machine with the card:

    python -m pytest tests/test_torch_kernels.py -m cuda
"""

import pytest
import torch

from kubeflow_tpu_torch.parallel import ring_attention as tra

try:  # one intra-op thread: the suite shares the machine with timing gates
    torch.set_num_threads(1)
    torch.set_num_interop_threads(1)
except RuntimeError:  # the interop pool can be sized once per process
    pass


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
def test_kernel_matches_plain_on_card(dtype, tol):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from kubeflow_tpu_torch.kernels.flash_fwd import FLASH_FWD, flash_fwd

    torch.backends.cuda.matmul.allow_tf32 = False  # the plain version in f32
    gen = torch.Generator(device="cuda").manual_seed(0)
    for d in (16, 32, 64, 128):
        for lq, lk, causal, window in ((1, 1, True, 0), (70, 70, True, 0),
                                       (65, 130, False, 0),
                                       (200, 200, True, 33)):
            q = torch.randn((3, lq, 5, d), generator=gen, device="cuda")
            k, v = (torch.randn((3, lk, 5, d), generator=gen, device="cuda")
                    for _ in range(2))
            bias = torch.zeros((3, 1, 1, lk), device="cuda")
            bias[2, ..., lk - lk // 10:] = -1e9  # key 0 stays visible
            q, k, v, bias = (t.to(dtype) for t in (q, k, v, bias))
            before = FLASH_FWD.launches
            o, lse = flash_fwd(q, k, v, bias, causal, window)
            torch.cuda.synchronize()
            assert FLASH_FWD.launches == before + 1
            o_p, lse_p = tra.flash_forward_plain(q, k, v, bias, 64, causal,
                                                 window)
            err = (o.float() - o_p.float()).abs().max().item()
            assert err <= tol, (d, lq, lk, causal, window, err)
            assert (lse - lse_p).abs().max().item() <= tol
    with pytest.raises(ValueError, match="head_dim"):
        x = torch.zeros((1, 4, 1, 48), device="cuda", dtype=dtype)
        flash_fwd(x, x, x, torch.zeros((1, 1, 1, 4), device="cuda",
                                       dtype=dtype), True)
