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


# per block of one batch row, head and 64 positions, ||got - ref|| / ||ref||
# (chip_smoke.py's TILE_TOL): a wrong tile of small values fails it too
TILE_TOL = {torch.float32: 1e-5, torch.bfloat16: 2.0 ** -8}


def worst_block(got, ref, tile=64):
    """The largest ||got - ref|| / ||ref|| over blocks of one batch row, one
    head and `tile` positions of (B, L, H, D) tensors."""
    def blocks(x):
        x = x.float().transpose(1, 2)
        x = torch.nn.functional.pad(x, (0, 0, 0, -x.shape[2] % tile))
        return x.reshape(x.shape[0], x.shape[1], -1, tile * x.shape[3])

    g, r = blocks(got), blocks(ref)
    return ((g - r).norm(dim=-1)
            / r.norm(dim=-1).clamp_min(1e-30)).max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
def test_kernel_matches_plain_on_card(dtype, tol):
    """flash_fwd against flash_forward_plain: the f32 FMA kernel in f32, the
    tensor-core kernel in bf16. Max-abs within tol, every 64-position block
    within TILE_TOL of its own norm, a second call bit-equal (no atomics);
    L = 333 is a multiple of no tile, Lq != Lk takes the JAX causal
    convention; in bf16 a misaligned view is refused."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from kubeflow_tpu_torch.kernels.flash_fwd import FLASH_FWD, flash_fwd

    torch.backends.cuda.matmul.allow_tf32 = False  # the plain version in f32
    gen = torch.Generator(device="cuda").manual_seed(0)
    for d in (16, 32, 64, 128):
        for lq, lk, causal, window in ((1, 1, True, 0), (70, 70, True, 0),
                                       (65, 130, False, 0),
                                       (200, 200, True, 33),
                                       (333, 333, True, 0),
                                       (150, 200, True, 100),
                                       (200, 150, True, 0)):
            q = torch.randn((3, lq, 5, d), generator=gen, device="cuda")
            k, v = (torch.randn((3, lk, 5, d), generator=gen, device="cuda")
                    for _ in range(2))
            bias = torch.zeros((3, 1, 1, lk), device="cuda")
            bias[2, ..., lk - lk // 10:] = -1e9  # key 0 stays visible
            q, k, v, bias = (t.to(dtype) for t in (q, k, v, bias))
            case = (d, lq, lk, causal, window)
            before = FLASH_FWD.launches
            o, lse = flash_fwd(q, k, v, bias, causal, window)
            o_2, lse_2 = flash_fwd(q, k, v, bias, causal, window)
            torch.cuda.synchronize()
            assert FLASH_FWD.launches == before + 2
            assert torch.equal(o, o_2) and torch.equal(lse, lse_2), case
            o_p, lse_p = tra.flash_forward_plain(q, k, v, bias, 64, causal,
                                                 window)
            err = (o.float() - o_p.float()).abs().max().item()
            assert err <= tol, (case, err)
            assert (lse - lse_p).abs().max().item() <= tol
            block = worst_block(o, o_p)
            assert block <= TILE_TOL[dtype], (case, block)
    with pytest.raises(ValueError, match="head_dim"):
        x = torch.zeros((1, 4, 1, 48), device="cuda", dtype=dtype)
        flash_fwd(x, x, x, torch.zeros((1, 1, 1, 4), device="cuda",
                                       dtype=dtype), True)
    if dtype == torch.bfloat16:  # 16-byte cp.async needs aligned rows
        x = torch.zeros((1, 4, 1, 32), device="cuda", dtype=dtype)
        flat = torch.zeros(1 + 4 * 32, device="cuda", dtype=dtype)
        shifted = flat[1:].view(1, 4, 1, 32)   # storage offset 1: 2 bytes
        with pytest.raises(ValueError, match="k starts at an address"):
            flash_fwd(x, shifted, x, torch.zeros((1, 1, 1, 4), device="cuda",
                                                 dtype=dtype), True)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dd_kernel_forms_on_card(dtype):
    """flash_bwd_dd's 16-byte-load form (a strided dO whose rows it can
    read) and its scalar form (a dO at storage offset 1) against
    (dO * O).sum(-1) in f32, within 1e-5 of the largest |D| (sums of D
    products in another order)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from kubeflow_tpu_torch.kernels import flash_bwd as kb

    gen = torch.Generator(device="cuda").manual_seed(2)
    for d in (16, 32, 64, 128):
        for lq in (1, 77, 256):
            o = torch.randn((2, lq, 3, d), generator=gen,
                            device="cuda").to(dtype)
            g = torch.randn((2, lq, 3, d), generator=gen,
                            device="cuda").to(dtype)
            want = (g.float() * o.float()).sum(-1).transpose(1, 2)
            strided = g.transpose(1, 2).contiguous().transpose(1, 2)
            flat = torch.zeros(1 + g.numel(), device="cuda", dtype=dtype)
            shifted = flat[1:].view(g.shape)
            shifted.copy_(g)
            for form, do in (("vector", strided), ("scalar", shifted)):
                before = kb.FLASH_BWD_DD.forms.get(form, 0)
                dd = kb.flash_bwd_dd(o, do)
                torch.cuda.synchronize()
                assert kb.FLASH_BWD_DD.forms[form] == before + 1, (form, d,
                                                                  lq)
                err = (dd - want).abs().max().item()
                assert err <= 1e-5 * (1 + want.abs().max().item()), (
                    form, d, lq, err)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_backward_kernels_match_plain_on_card(dtype):
    """flash_bwd_dd, flash_bwd_dq and flash_bwd_dkv (both D forms) against
    flash_backward_plain: the f32 FMA kernels in f32, the tensor-core
    kernels in bf16. Tolerance: 1e-4 plus, of the grad's largest magnitude,
    1e-4 in f32 (sums in another order) or four bf16 ulps in bf16 (p and ds
    are rounded to bf16 before their products on both sides, and an f32
    difference in the last bit can round them one ulp apart). A second call
    on the same inputs must agree bit for bit (no atomics); L = 333 is a
    multiple of no tile; in bf16 a misaligned view is refused."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from kubeflow_tpu_torch.kernels import flash_bwd as kb
    from kubeflow_tpu_torch.kernels.flash_fwd import flash_fwd

    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(1)
    counters = (kb.FLASH_BWD_DD, kb.FLASH_BWD_DQ, kb.FLASH_BWD_DKV)

    def close(name, got, want, case):
        want = want.float()
        rel = 1e-4 if dtype == torch.float32 else 4 * 2.0 ** -8
        tol = 1e-4 + rel * want.abs().max().item()
        err = (got.float() - want).abs().max().item()
        assert err <= tol, (name, case, err, tol)

    for d in (16, 32, 64, 128):
        for lq, lk, causal, window in ((1, 1, True, 0), (70, 70, True, 0),
                                       (65, 130, False, 0),
                                       (130, 65, False, 0),
                                       (200, 200, True, 33),
                                       (150, 200, True, 100),
                                       (333, 333, True, 0)):
            q = torch.randn((2, lq, 3, d), generator=gen, device="cuda")
            k, v = (torch.randn((2, lk, 3, d), generator=gen, device="cuda")
                    for _ in range(2))
            g = torch.randn((2, lq, 3, d), generator=gen, device="cuda")
            bias = 0.3 * torch.randn((2, 1, 1, lk), generator=gen,
                                     device="cuda")
            bias[1, ..., lk - lk // 10:] = -1e9  # key 0 stays visible
            q, k, v, g, bias = (t.to(dtype) for t in (q, k, v, g, bias))
            o, lse = flash_fwd(q, k, v, bias, causal, window)
            # dO as autograd may hand it over: a strided view, unit D stride
            g_view = g.transpose(1, 2).contiguous().transpose(1, 2)
            want = tra.flash_backward_plain(q, k, v, bias, o, lse, g, 64,
                                            causal, window)
            case = (d, lq, lk, causal, window)
            before = [c.launches for c in counters]
            dd = kb.flash_bwd_dd(o, g_view)
            dd_want = (g.float() * o.float()).sum(-1).transpose(1, 2)
            assert (dd - dd_want).abs().max().item() <= (
                1e-5 * (1 + dd_want.abs().max().item())), case
            for form, dd_in in (("ddpre", dd), ("loop2", None)):
                for want_dbias in (True, False):
                    dq = kb.flash_bwd_dq(q, k, v, bias, o, g_view, lse,
                                         dd_in, causal, window)
                    dk, dv, dbh = kb.flash_bwd_dkv(
                        q, k, v, bias, o, g_view, lse, dd_in, causal,
                        window, want_dbias)
                    torch.cuda.synchronize()
                    for name, got, w in (("dq", dq, want[0]),
                                         ("dk", dk, want[1]),
                                         ("dv", dv, want[2])):
                        assert got.dtype == dtype and got.shape == w.shape
                        close(name, got, w, case + (form,))
                    if want_dbias:
                        dbias = dbh.view(2, 3, lk).sum(1)[:, None, None]
                        close("dbias", dbias, want[3], case + (form,))
                        again = (kb.flash_bwd_dq(q, k, v, bias, o, g_view,
                                                 lse, dd_in, causal, window),
                                 *kb.flash_bwd_dkv(q, k, v, bias, o, g_view,
                                                   lse, dd_in, causal,
                                                   window))
                        for name, x, y in zip(("dq", "dk", "dv", "dbias"),
                                              (dq, dk, dv, dbh), again):
                            assert torch.equal(x, y), (name, case, form)
                    else:
                        assert dbh is None
            assert [c.launches for c in counters] == [
                before[0] + 1, before[1] + 6, before[2] + 6]
    with pytest.raises(ValueError, match="stride"):
        x = torch.zeros((1, 4, 1, 32), device="cuda", dtype=dtype)
        lse = torch.zeros((1, 1, 4), device="cuda")
        strided = torch.zeros((1, 4, 1, 64), device="cuda",
                              dtype=dtype)[..., ::2]
        kb.flash_bwd_dq(x, x, x, torch.zeros((1, 1, 1, 4), device="cuda",
                                            dtype=dtype),
                        x, strided, lse, lse, True)
    if dtype == torch.bfloat16:  # 16-byte cp.async needs aligned rows
        flat = torch.zeros(1 + 4 * 32, device="cuda", dtype=dtype)
        shifted = flat[1:].view(1, 4, 1, 32)   # storage offset 1: 2 bytes
        with pytest.raises(ValueError, match="16-byte aligned"):
            kb.flash_bwd_dkv(x, x, x, torch.zeros((1, 1, 1, 4), device="cuda",
                                                  dtype=dtype),
                             x, shifted, lse, lse, True)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
def test_custom_op_under_export_launches_kernel(dtype, tol):
    """flash_forward traced by torch.export holds the custom op
    kftpu::flash_fwd; the saved and reloaded program launches the
    hand-written kernel once a call (the count moves), equals the eager
    op bit for bit and the plain version within phase 3's limits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    import io

    from kubeflow_tpu_torch.kernels.flash_fwd import FLASH_FWD

    class Attend(torch.nn.Module):
        def forward(self, q, k, v, bias):
            return tra.flash_forward(q, k, v, bias, causal=True)

    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(3)
    q, k, v = (torch.randn((2, 200, 4, 64), generator=gen, device="cuda",
                           dtype=dtype) for _ in range(3))
    bias = torch.zeros((2, 1, 1, 200), device="cuda", dtype=dtype)
    bias[1, ..., 150:] = -1e9
    with torch.no_grad():
        program = torch.export.export(Attend(), (q, k, v, bias),
                                      strict=False)
    assert sum("kftpu.flash_fwd" in str(n.target)
               for n in program.graph.nodes) == 1
    buf = io.BytesIO()
    torch.export.save(program, buf)
    buf.seek(0)
    call = torch.export.load(buf).module()
    before = FLASH_FWD.launches
    o, lse = call(q, k, v, bias)
    torch.cuda.synchronize()
    assert FLASH_FWD.launches == before + 1
    o_e, lse_e = torch.ops.kftpu.flash_fwd(q, k, v, bias, True, 0, 128)
    assert torch.equal(o, o_e) and torch.equal(lse, lse_e)
    o_p, lse_p = tra.flash_forward_plain(q, k, v, bias, 64, True)
    assert (o.float() - o_p.float()).abs().max().item() <= tol
    assert (lse - lse_p).abs().max().item() <= tol
    assert worst_block(o, o_p) <= TILE_TOL[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_dropout_kernels_bit_equal_plain_on_card(dtype):
    """dropout_fwd and dropout_bwd against dropout_plain: outputs and
    grads bit-equal (the same Philox draws, the same f32 product rounded
    to the dtype) at GPT-2 small's residual width, a ragged size (a
    multiple of none of 4, 16, 128) and a misaligned view (the kernels'
    element path); two calls bit-equal; another seed or site another mask;
    the kernel's launches counted, the plain version's not."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from kubeflow_tpu_torch.kernels import dropout as kd

    gen = torch.Generator(device="cuda").manual_seed(0)
    seeds = torch.tensor([12345, 2**61 + 7], dtype=torch.int64,
                         device="cuda")
    base = torch.randn(3 * 1024 * 768 + 3, generator=gen, device="cuda")
    cases = [base[:3 * 1024 * 768].view(3, 1024, 768),
             base[:1000003].view(1000003), base[1:1000004]]
    for x in cases:
        x = x.to(dtype)
        for seed, site, rate in ((seeds[0], 0, 0.1), (seeds[1], 2, 0.5)):
            fwd, bwd = kd.DROPOUT_FWD.launches, kd.DROPOUT_BWD.launches
            got = kd.dropout_fwd(x.contiguous(), seed, rate, site)
            again = kd.dropout_fwd(x.contiguous(), seed, rate, site)
            gx = kd.dropout_bwd(x.contiguous(), seed, rate, site)
            want = kd.dropout_plain(x, seed, rate, site)
            torch.cuda.synchronize()
            assert kd.DROPOUT_FWD.launches == fwd + 2
            assert kd.DROPOUT_BWD.launches == bwd + 1
            bits = {torch.float32: torch.int32}.get(dtype, torch.int16)
            assert torch.equal(got.view(bits), want.view(bits))
            assert torch.equal(again.view(bits), got.view(bits))
            assert torch.equal(gx.view(bits), want.view(bits))
            kept = (got != 0).float().mean().item()
            n = x.numel()
            assert abs(kept - (1 - rate)) < 4 * (rate * (1 - rate) / n) ** .5
        other = kd.dropout_fwd(x.contiguous(), seeds[0], 0.1, 1)
        assert not torch.equal(other != 0, got != 0)
    # through autograd: the backward launches dropout_bwd
    x = torch.randn(8, 1024, 768, device="cuda", dtype=dtype,
                    requires_grad=True)
    y = kd.dropout(x, seeds[0], 0.1, 1)
    g = torch.randn_like(y)
    y.backward(g)
    assert torch.equal(x.grad, kd.dropout_plain(g, seeds[0], 0.1, 1))
    assert torch.equal(y.detach(), kd.dropout_plain(x.detach(), seeds[0],
                                                    0.1, 1))
    with pytest.raises(ValueError, match="not contiguous"):
        kd.dropout_fwd(x.detach().transpose(0, 1), seeds[0], 0.1)
    with pytest.raises(ValueError, match="int64"):
        kd.dropout_fwd(x.detach(), seeds[:1].float(), 0.1)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dropout_span_is_the_whole_tensors_mask_on_card(dtype):
    """A context rank's slice of L/ctx positions (``span``): dropout_fwd
    and dropout_bwd on the slice equal the whole (4, 2048, 768) tensor's
    outputs there bit for bit, and the plain version's; a layout the
    kernel cannot take (a row or offset not a multiple of 4) is refused."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from kubeflow_tpu_torch.kernels import dropout as kd

    gen = torch.Generator(device="cuda").manual_seed(1)
    seed = torch.tensor(2**45 + 3, dtype=torch.int64, device="cuda")
    x = torch.randn((4, 2048, 768), generator=gen, device="cuda").to(dtype)
    bits = {torch.float32: torch.int32}.get(dtype, torch.int16)
    whole = kd.dropout_fwd(x, seed, 0.1, 1)
    whole_b = kd.dropout_bwd(x, seed, 0.1, 1)
    for ctx in (2, 4):
        row = (2048 // ctx) * 768
        for i, part in enumerate(x.chunk(ctx, dim=1)):
            span = (row, 2048 * 768, i * row)
            got = kd.dropout_fwd(part.contiguous(), seed, 0.1, 1, span)
            got_b = kd.dropout_bwd(part.contiguous(), seed, 0.1, 1, span)
            plain = kd.dropout_plain(part, seed, 0.1, 1, span)
            want = whole.chunk(ctx, dim=1)[i]
            assert torch.equal(got.view(bits), want.view(bits))
            assert torch.equal(got.view(bits), plain.view(bits))
            assert torch.equal(got_b.view(bits),
                               whole_b.chunk(ctx, dim=1)[i].view(bits))
    with pytest.raises(ValueError, match="multiples of 4"):
        kd.dropout_fwd(x[:, :3].contiguous(), seed, 0.1, 1,
                       (3 * 768, 2048 * 768, 2))
