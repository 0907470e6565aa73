#!/usr/bin/env python3
"""Drive the PyTorch port (kubeflow_tpu_torch) on one NVIDIA card, end to end.

    python3 chip_smoke.py            # from the repository root, one card

Phases, each fatal on failure:
  1. the card: name and power limit (nvidia-smi); TF32 off for f32 matmuls
  2. build every hand-written kernel from csrc/ (one nvcc per source, all
     started together)
  3. the forward kernel against its plain PyTorch version on the card, at
     the serving path's shapes, the training shape and a sweep (L
     17/128/1024, window 0/100, f32 and bf16), with times of the kernel, the
     plain version and one PyTorch library call beside the kernel's bound
  4. the serving path: GPT-2 small (GPTConfig.small(), full width, seeded
     random weights) behind the port's ModelServer, two generate-mode and
     two logits-mode v1 requests over HTTP, launch counts checked per
     request, outputs checked against the plain attention path on the card
  5. the three backward kernels (D pre-kernel, dq, dkv; D read and D from
     O) against the plain backward at (2, 1024, 12, 64) and the training
     shape (4, 2048, 12, 64), f32 and bf16, causal, window 0/100, pad bias,
     with their times, bounds, the plain time and SDPA's backward; besides
     the max-abs limit, every block of one batch row, head and 64 positions
     must agree within TILE_TOL of its own norm, so a wrong tile of small
     grads fails too; dq and dkv called twice at the training shape must
     agree bit for bit. dq and dkv compute on the tensor cores in bf16 and
     by f32 FMA in f32 (each route is printed, read from the names of the
     kernels the build holds), and phase 2 prints ptxas's registers and
     spills and the shared memory of every tensor-core instantiation
  6. the training path: GPT-2 small (full width and depth, seeded random
     init, f32 parameters, bf16 compute) trained by the port's Trainer.fit
     at batch 4 x 2048 tokens, launches checked per step, loss finite and
     falling; then one f32 step's loss and grads through the kernels
     against the plain attention path (the f32 FMA backward kernels; the
     bf16 tensor-core kernels that training runs are held by phase 5), and
     a checkpoint round trip

The line before last is the kernels' JSON record, the last line
{"ok": true, "device": {...}}. Every number is printed beside the card's
name and power limit. Without a CUDA device it exits nonzero and prints no
result.
"""

from __future__ import annotations

import functools
import gc
import json
import math
import subprocess
import sys
import tempfile
import time
import urllib.error
import urllib.request

import numpy as np

SEED = 0
GEN_BATCH, GEN_PROMPT, GEN_NEW = 4, 128, 32
LOGITS_BATCH, LOGITS_LEN, LOGITS_PAD = 2, 16, 4
# the training path: bench.py's gpt2s_flash_2k shape
TRAIN_BATCH, TRAIN_LEN, TRAIN_STEPS, TRAIN_WARMUP = 4, 2048, 20, 2
# phase 5's second limit, per block of one batch row, head and 64 positions:
# ||got - ref|| / ||ref||, set from the readings of sound kernels on the card
TILE_TOL = {"float32": 1e-5, "bfloat16": 2.0 ** -8}
# H100 peaks (NVIDIA data sheet, dense): flops by input type, and HBM bytes/s
PEAKS = {
    "sxm": {"float32": 67e12, "bfloat16": 989e12, "bytes": 3.35e12},
    "pcie": {"float32": 51e12, "bfloat16": 756e12, "bytes": 2.0e12},
}


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip()


def ptxas_kernels(report: str) -> dict:
    """{mangled kernel name: (registers, spill store bytes, spill load
    bytes)} from an nvcc -Xptxas -v report."""
    import re

    out, name, spills = {}, None, (0, 0)
    for line in report.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            name, spills = m.group(1), (0, 0)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spills = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and name is not None:
            out[name] = (int(m.group(1)), *spills)
            name = None
    return out


def ptxas_summary(report: str) -> str:
    """Kernels, registers and spills from an nvcc -Xptxas -v report."""
    kernels = ptxas_kernels(report).values()
    if not kernels:
        return "no ptxas report"
    regs = [r for r, _, _ in kernels]
    spills = sum(st for _, st, _ in kernels)
    return (f"{len(regs)} kernels, {min(regs)}-{max(regs)} registers, "
            f"{spills} bytes of spill stores")


# each dtype's route, read from the mangled names of the built kernels:
# (pattern; group 1 the kernel, group 2 the dtype it is templated on, empty
# for the tensor-core kernels, which take bfloat16 only; route)
ROUTE_PATTERNS = (
    (r"(flash_fwd)_kernelI(f|13__nv_bfloat16)L", "CUDA-core FMA"),
    (r"(flash_fwd)_tc_kernelIL()", "tensor cores (mma.sync)"),
    (r"(flash_bwd_dd)_kernelI(f|13__nv_bfloat16)E",
     "CUDA cores, element loads"),
    (r"(flash_bwd_dd)_vec_kernelI(f|13__nv_bfloat16)L",
     "CUDA cores, 16-byte loads"),
    (r"(flash_bwd_(?:dq|dkv))_kernelI(f|13__nv_bfloat16)L", "CUDA-core FMA"),
    (r"(flash_bwd_(?:dq|dkv))_tc_kernelIL()", "tensor cores (mma.sync)"),
)
_DTYPE_OF = {"f": "float32", "13__nv_bfloat16": "bfloat16", "": "bfloat16"}
# the tensor-core instantiations each source must hold: (source, pattern;
# groups kernel, head_dim, D-from-O flag (backward only), expected count)
TC_INSTANTIATIONS = (
    ("flash_fwd.cu", r"(flash_fwd)_tc_kernelILi(\d+)E()", 4),
    ("flash_bwd.cu", r"(flash_bwd_(?:dq|dkv))_tc_kernelILi(\d+)ELb([01])E",
     16),
)


def tensor_core_report(card: str) -> tuple[int, dict]:
    """Print registers, spills and shared memory of every tensor-core
    instantiation of the forward and of dq/dkv, from nvcc's ptxas reports.
    Return the spill bytes at D = 64, the training head_dim, and each
    dtype's routes as the built libraries hold them: {dtype: {kernel:
    {route: instantiations}}}."""
    import re

    import torch

    from kubeflow_tpu_torch.kernels import flash_bwd as kb
    from kubeflow_tpu_torch.kernels import flash_fwd as kf
    from kubeflow_tpu_torch.kernels.build import report_path

    spill64 = 0
    rows = []
    routes: dict = {}
    for source, pattern, expected in TC_INSTANTIATIONS:
        found = 0
        for name, (regs, st, ld) in ptxas_kernels(
                report_path(source).read_text()).items():
            for route_pattern, route in ROUTE_PATTERNS:
                m = re.search(route_pattern, name)
                if m:
                    per = routes.setdefault(_DTYPE_OF[m.group(2)], {})
                    per = per.setdefault(m.group(1), {})
                    per[route] = per.get(route, 0) + 1
            m = re.search(pattern, name)
            if not m:
                continue
            kernel, d, form = m.group(1), int(m.group(2)), m.group(3)
            smem = (kf.smem_bytes(torch.bfloat16, d) if kernel == "flash_fwd"
                    else kb.smem_bytes(kernel, torch.bfloat16, d,
                                       form == "1"))
            rows.append((kernel, d, {"": "", "0": "ddpre", "1": "loop2"}[form],
                         regs, st, ld, smem))
            found += 1
            if d == 64:
                spill64 += st + ld
        if found != expected:
            raise AssertionError(f"ptxas reported {found} tensor-core "
                                 f"instantiations in {source}, expected "
                                 f"{expected}")
    for kernel, d, form, regs, st, ld, smem in sorted(rows):
        print(f"  {kernel:13s} bf16 D={d:3d} {form:5s}: {regs} registers, "
              f"{st} bytes spill stores, {ld} bytes spill loads, {smem} bytes "
              f"shared memory [{card}]")
    return spill64, routes


def route_line(routes: dict, dtype: str, kernels) -> str:
    """`kernel on route (n built)` for each kernel, from tensor_core_report's
    routes."""
    return ", ".join(
        f"{k} on " + " + ".join(f"{r} ({n} built)"
                                for r, n in sorted(routes[dtype][k].items()))
        for k in kernels)


def tile_error(got, ref, tile: int = 64) -> float:
    """The largest ||got - ref|| / ||ref|| over blocks of one batch row,
    one head and `tile` positions of (B, H, L, D) tensors: a kernel that
    gets one tile wrong fails this, however small that tile's values are
    beside the tensor's largest."""
    import torch

    def blocks(x):
        x = torch.nn.functional.pad(x.float(), (0, 0, 0, -x.shape[2] % tile))
        return x.reshape(x.shape[0], x.shape[1], -1, tile * x.shape[3])

    g, r = blocks(got), blocks(ref)
    return ((g - r).norm(dim=-1)
            / r.norm(dim=-1).clamp_min(1e-30)).max().item()


def time_ms(fn, iters: int) -> float:
    """Mean device time of fn() over iters launches, after a warmup."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_events(fn, iters: int) -> tuple[list, float]:
    """The device activities (kernels, copies, fills) of iters calls of
    fn(), after a warmup, from a torch.profiler trace: ([(name, start_us,
    duration_us)], host seconds of the traced calls to their last
    synchronize). CUPTI records every launch on the card, the ctypes
    wrappers' included. Raises if the trace holds none."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = [(e.name, e.time_range.start, e.time_range.elapsed_us())
              for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    if not events:
        raise AssertionError("torch.profiler recorded no device activity")
    return events, wall


def device_ms(fn, iters: int, attempts: int = 3) -> float:
    """Device time of one fn() call: for each activity name in a trace of
    iters calls, its mean duration times the times a call runs it
    (round(count / iters)), summed. A trace can lose an activity at its
    edge (19 of 20 on the card, and once none), which this rounding
    absorbs; an empty trace is retried, up to `attempts` times."""
    for attempt in range(attempts):
        try:
            events, _ = device_events(fn, iters)
            break
        except AssertionError:
            if attempt == attempts - 1:
                raise
    by_name: dict = {}
    for name, _, dur in events:
        by_name.setdefault(name, []).append(dur)
    return sum(sum(d) / len(d) * round(len(d) / iters)
               for d in by_name.values()) / 1e3


def busy_us(events) -> float:
    """The time the device was busy: the union of the activities'
    intervals."""
    busy, end = 0.0, -math.inf
    for _, start, dur in sorted(events, key=lambda e: e[1]):
        stop = start + dur
        if stop > end:
            busy += stop - max(start, end)
            end = stop
    return busy


def live_pairs(lq, lk, causal, window) -> int:
    """(query, key) pairs the mask leaves visible: the work this input
    needs."""
    if not causal:
        return lq * lk
    rows = np.arange(lq)
    seen = rows + 1 if not window else np.minimum(rows + 1, window)
    return int(np.minimum(seen, lk).sum())


def bound(flops, nbytes, dtype, peaks):
    """(bound_ms, bound_by): the larger of the operations over the type's
    peak and the bytes over the HBM rate."""
    t_ops = flops / peaks[dtype]
    t_bytes = nbytes / peaks["bytes"]
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def attention_bound(b, h, lq, lk, d, dtype, causal, window, peaks):
    """The forward's bound: 4·D operations per live pair (q·kᵀ, p·v); q, k,
    v, bias read and O, lse written once."""
    flops = 4.0 * b * h * d * live_pairs(lq, lk, causal, window)
    size = 4 if dtype == "float32" else 2
    nbytes = (size * b * h * d * (2 * lq + 2 * lk)   # q, o, k, v
              + size * b * lk + 4 * b * h * lq)      # bias, lse
    return bound(flops, nbytes, dtype, peaks)


def backward_bounds(b, h, lq, lk, d, dtype, causal, window, peaks,
                    from_o: bool, want_dbias: bool) -> dict:
    """Each backward kernel's bound. dd: 2 operations per element of dO,
    reads dO and O, writes D. dq: 6·D per live pair (q·kᵀ, dO·vᵀ, ds·k),
    reads q, k, v, dO, bias, lse and D (O when D is computed from it, plus
    its 2·D per row), writes dq. dkv: 8·D per live pair (q·kᵀ, dO·vᵀ, pᵀ·dO,
    dsᵀ·q), the same reads, writes dk, dv and dbias_bh when wanted."""
    size = 4 if dtype == "float32" else 2
    pairs = b * h * live_pairs(lq, lk, causal, window)
    rows = b * h * lq
    q_side = size * rows * d                   # one (B, Lq, H, D) tensor
    k_side = size * b * h * lk * d             # one (B, Lk, H, D) tensor
    stats = size * b * lk + 4 * rows            # bias, lse
    d_in = q_side if from_o else 4 * rows      # O, or D
    d_ops = 2.0 * rows * d if from_o else 0.0
    return {
        "flash_bwd_dd": bound(2.0 * rows * d, 2 * q_side + 4 * rows, dtype,
                              peaks),
        "flash_bwd_dq": bound(6.0 * d * pairs + d_ops,
                              3 * q_side + 2 * k_side + stats + d_in,
                              dtype, peaks),
        "flash_bwd_dkv": bound(8.0 * d * pairs + d_ops,
                               2 * q_side + 4 * k_side + stats + d_in
                               + (4 * b * h * lk if want_dbias else 0),
                               dtype, peaks),
    }


def make_attention_inputs(b, l, h, d, dtype, pad, gen):
    import torch

    q, k, v = (torch.randn((b, l, h, d), generator=gen, device="cuda")
               .to(dtype) for _ in range(3))
    bias = torch.zeros((b, 1, 1, l), device="cuda", dtype=dtype)
    if pad:
        bias[-1, ..., l - pad:] = -1e9
    return q, k, v, bias


def sdpa_call(q, k, v, bias, causal, window):
    """One PyTorch library call for the same function (yardstick only): the
    bias, causal mask and window folded into an additive mask."""
    import torch
    import torch.nn.functional as F

    lq, lk = q.shape[1], k.shape[1]
    rows = torch.arange(lq, device="cuda")[:, None]
    cols = torch.arange(lk, device="cuda")[None, :]
    masked = (cols > rows) if causal else torch.zeros_like(cols > rows)
    if window:
        masked = masked | (rows - cols >= window)
    mask = (bias.float() + torch.where(masked, -1e9, 0.0)).to(q.dtype)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    return lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask)


def sdpa_causal_call(q, k, v):
    """SDPA with is_causal=True and no mask (yardstick only): the same
    function where the bias is zero and there is no window, and SDPA's
    fastest backend."""
    import torch.nn.functional as F

    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    return lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)


def phase_kernels(peaks, card: str, routes: dict) -> dict:
    """Kernel vs plain version on the card. Returns the record of the
    training path's shape (bf16). `routes` is tensor_core_report's."""
    import torch

    from kubeflow_tpu_torch.kernels.flash_fwd import flash_fwd
    from kubeflow_tpu_torch.parallel.ring_attention import flash_forward_plain

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    tol = {"float32": 1e-4, "bfloat16": 2e-2}
    cases = [  # (tag, B, L, window, dtype, pad): the main paths first
        ("prefill", GEN_BATCH, GEN_PROMPT, 0, "float32", 0),
        ("logits", LOGITS_BATCH, LOGITS_LEN, 0, "float32", LOGITS_PAD),
        ("train", TRAIN_BATCH, TRAIN_LEN, 0, "bfloat16", 0),
        ("train", TRAIN_BATCH, TRAIN_LEN, 0, "float32", 0),
    ]
    for l in (17, 128, 1024):
        for window in (0, 100):
            for dt in ("float32", "bfloat16"):
                cases.append(("sweep", 2, l, window, dt,
                              max(1, min(16, l // 8))))
    h, d = 12, 64
    print("phase 3: flash_fwd kernel vs plain version (B, L, H=12, D=64, "
          "causal, pad bias on the last keys of the last row; max-abs "
          "tolerance f32 1e-4, bf16 2e-2; per block of one batch row, head "
          f"and 64 positions ||got - ref|| within {TILE_TOL['float32']:g} "
          f"(f32) or {TILE_TOL['bfloat16']:g} (bf16) of ||ref||; times: the "
          "loop's ms per call by CUDA events, dev the device time per call "
          "from a torch.profiler trace)", flush=True)
    for dt in ("bfloat16", "float32"):
        print(f"  route {dt} (the built library's instantiations): "
              + route_line(routes, dt, ["flash_fwd"]), flush=True)
    records = {}
    for tag, b, l, window, dt, pad in cases:
        dtype = getattr(torch, dt)
        q, k, v, bias = make_attention_inputs(b, l, h, d, dtype, pad, gen)
        o_k, lse_k = flash_fwd(q, k, v, bias, True, window)
        o_p, lse_p = flash_forward_plain(q, k, v, bias, 128, True, window)
        torch.cuda.synchronize()
        err_o = (o_k.float() - o_p.float()).abs().max().item()
        err_l = (lse_k - lse_p).abs().max().item()
        tile = tile_error(o_k.transpose(1, 2), o_p.transpose(1, 2))
        typical = o_p.float().abs().median().item()
        same = None
        if tag == "train":  # no atomics: a second call agrees bit for bit
            o_2, lse_2 = flash_fwd(q, k, v, bias, True, window)
            same = torch.equal(o_k, o_2) and torch.equal(lse_k, lse_2)
        ok = (math.isfinite(err_o) and err_o <= tol[dt] and err_l <= tol[dt]
              and tile <= TILE_TOL[dt] and same is not False)
        iters = 20 if l >= 1024 else 50
        kernel = functools.partial(flash_fwd, q, k, v, bias, True, window)
        plain = functools.partial(flash_forward_plain, q, k, v, bias, 128,
                                  True, window)
        ms, dev = time_ms(kernel, iters), device_ms(kernel, iters)
        plain_ms = time_ms(plain, iters)
        lib = lib_dev = causal = causal_dev = None
        if tag != "logits" and (tag != "sweep" or l == 1024):
            call = sdpa_call(q, k, v, bias, True, window)
            lib, lib_dev = time_ms(call, iters), device_ms(call, iters)
        if pad == 0 and window == 0:
            call = sdpa_causal_call(q, k, v)
            causal, causal_dev = time_ms(call, iters), device_ms(call, iters)
        bound_ms, bound_by = attention_bound(b, h, l, l, d, dt, True, window,
                                             peaks)
        lib_s, lib_dev_s, causal_s, causal_dev_s = (
            "-" if x is None else f"{x:.5f}"
            for x in (lib, lib_dev, causal, causal_dev))
        print(f"  {tag:8s} B={b} L={l:5d} window={window:3d} {dt:9s} "
              f"err_o={err_o:.3e} err_lse={err_l:.3e} (tol {tol[dt]:g}) "
              f"kernel_ms={ms:.5f} dev={dev:.5f} plain_ms={plain_ms:.5f} "
              f"sdpa_masked_ms={lib_s} dev={lib_dev_s} "
              f"sdpa_causal_ms={causal_s} dev={causal_dev_s} "
              f"bound_ms={bound_ms:.5f} ({bound_by}) [{card}]", flush=True)
        print(f"  {'':8s} worst 64-position block: ||err||/||ref|| = "
              f"{tile:.3e} (limit {TILE_TOL[dt]:g}); median |O| "
              f"{typical:.3g}"
              + ("" if same is None else
                 f"; O and lse bit-equal over two calls: {same}")
              + f" [{card}]", flush=True)
        if not ok:
            raise AssertionError(
                f"flash_fwd disagrees with the plain version: {tag} B={b} "
                f"L={l} window={window} {dt}: O {err_o}, lse {err_l}, worst "
                f"block {tile}, bit-equal over two calls {same}")
        records[(tag, l, window, dt)] = {
            "max_abs_err": err_o, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": lib,
            "device_ms": dev, "library_device_ms": lib_dev,
            "library_causal_ms": causal, "library_causal_device_ms":
                causal_dev,
        }
    return records[("train", TRAIN_LEN, 0, "bfloat16")]


def sdpa_backward_call(q, k, v, bias, g, causal, window):
    """SDPA forward+backward on the same function (yardstick only), and its
    forward alone: the backward's time is the difference."""
    import torch

    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    fwd = sdpa_call(*leaves, bias, causal, window)

    def fwd_bwd():
        torch.autograd.grad(fwd(), leaves, g.transpose(1, 2))

    def fwd_only():
        with torch.no_grad():
            fwd()

    return fwd_bwd, fwd_only


def phase_backward(peaks, card: str, routes: dict) -> dict:
    """The backward kernels against the plain backward on the card. Returns
    each kernel's record at the training shape in bf16 (window 0, D read
    from the pre-kernel). `routes` is tensor_core_report's."""
    import torch

    from kubeflow_tpu_torch.kernels import flash_bwd as kb
    from kubeflow_tpu_torch.kernels.flash_fwd import flash_fwd
    from kubeflow_tpu_torch.parallel.ring_attention import (
        flash_backward_plain,
    )

    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    h, d = 12, 64
    print("phase 5: flash backward kernels vs plain version (B, L, H=12, "
          "D=64, causal, pad bias on the last keys of the last row; "
          "tolerance: f32 1e-4 of max(1, the grad's largest |value|), bf16 "
          "4 bf16 ulps of it; and per block of one batch row, head and 64 "
          f"positions, ||got - ref|| within {TILE_TOL['float32']:g} (f32) "
          f"or {TILE_TOL['bfloat16']:g} (bf16) of ||ref||)", flush=True)
    for dt in ("bfloat16", "float32"):
        print(f"  route {dt} (the built library's instantiations): "
              + route_line(routes, dt, ["flash_bwd_dd", "flash_bwd_dq",
                                        "flash_bwd_dkv"]), flush=True)
    records = {}
    kb.FLASH_BWD_DD.forms.clear()
    for b, l in ((2, 1024), (TRAIN_BATCH, TRAIN_LEN)):
        for dt in ("float32", "bfloat16"):
            for window in (0, 100):
                dtype = getattr(torch, dt)
                q, k, v, bias = make_attention_inputs(b, l, h, d, dtype,
                                                      16, gen)
                g = torch.randn((b, l, h, d), generator=gen,
                                device="cuda").to(dtype)
                o, lse = flash_fwd(q, k, v, bias, True, window)
                want = flash_backward_plain(q, k, v, bias, o, lse, g, 128,
                                            True, window)
                dd = kb.flash_bwd_dd(o, g)
                runs = {"ddpre": dd, "loop2": None}
                errs = {"flash_bwd_dd": (dd - (g.float() * o.float()).sum(
                    -1).transpose(1, 2)).abs().max().item()}
                scales = {"flash_bwd_dd": 1.0}
                tiles = {}  # key: (worst block error, output, median |ref|)
                for form, dd_in in runs.items():
                    dq = kb.flash_bwd_dq(q, k, v, bias, o, g, lse, dd_in,
                                         True, window)
                    dk, dv, dbh = kb.flash_bwd_dkv(q, k, v, bias, o, g, lse,
                                                   dd_in, True, window)
                    dbias = dbh.view(b, h, l).sum(1)[:, None, None]
                    if l == TRAIN_LEN:  # no atomics: a second call agrees
                        again = (kb.flash_bwd_dq(q, k, v, bias, o, g, lse,
                                                 dd_in, True, window),
                                 *kb.flash_bwd_dkv(q, k, v, bias, o, g, lse,
                                                   dd_in, True, window))
                        same = all(torch.equal(x, y) for x, y in zip(
                            (dq, dk, dv, dbh), again))
                        print(f"  determinism B={b} L={l} window={window} "
                              f"{dt} {form}: dq, dk, dv, dbias bit-equal "
                              f"over two calls: {same} [{card}]", flush=True)
                        if not same:
                            raise AssertionError(
                                f"dq/dkv differ between two calls on the "
                                f"same inputs ({dt}, window {window}, "
                                f"{form})")
                    torch.cuda.synchronize()
                    for name, out, got, ref in (
                            ("flash_bwd_dq", "dq", dq, want[0]),
                            ("flash_bwd_dkv", "dk", dk, want[1]),
                            ("flash_bwd_dkv", "dv", dv, want[2]),
                            ("flash_bwd_dkv", "dbias", dbias, want[3])):
                        ref = ref.float()
                        scale = max(1.0, ref.abs().max().item())
                        err = (got.float() - ref).abs().max().item()
                        key = f"{name}/{form}"
                        as_bhld = ((lambda x: x.view(b, 1, l, 1))
                                   if ref.shape[1] == 1
                                   else (lambda x: x.transpose(1, 2)))
                        tile = tile_error(as_bhld(got), as_bhld(ref))
                        if tile >= tiles.get(key, (-1.0,))[0]:
                            tiles[key] = (tile, out,
                                          ref.abs().median().item())
                        if err / scale > errs.get(key, 0.0) / scales.get(
                                key, 1.0):
                            errs[key], scales[key] = err, scale
                rel_tol = 1e-4 if dt == "float32" else 4 * 2.0 ** -8
                bad = {n: e for n, e in errs.items()
                       if not math.isfinite(e) or e > rel_tol * scales[n]}
                bad.update({f"{n} block": t for n, (t, _, _) in tiles.items()
                            if not t <= TILE_TOL[dt]})
                iters = 10 if l >= TRAIN_LEN else 20
                calls = {"flash_bwd_dd": functools.partial(kb.flash_bwd_dd,
                                                           o, g)}
                for form, dd_in in runs.items():
                    calls[f"flash_bwd_dq/{form}"] = functools.partial(
                        kb.flash_bwd_dq, q, k, v, bias, o, g, lse, dd_in,
                        True, window)
                    calls[f"flash_bwd_dkv/{form}"] = functools.partial(
                        kb.flash_bwd_dkv, q, k, v, bias, o, g, lse, dd_in,
                        True, window, False)
                times = {n: time_ms(f, iters) for n, f in calls.items()}
                devs = {n: device_ms(f, iters) for n, f in calls.items()}
                t_dd = times["flash_bwd_dd"]
                plain_dd = time_ms(
                    lambda: torch.einsum("blhd,blhd->bhl", g.float(),
                                         o.float()), iters)
                plain_ms = time_ms(
                    lambda: flash_backward_plain(q, k, v, bias, o, lse, g,
                                                 128, True, window, False),
                    max(3, iters // 4))
                def lib_dd_call():
                    return (g * o).sum(-1)

                lib_dd = time_ms(lib_dd_call, iters)
                lib_dd_dev = device_ms(lib_dd_call, iters)
                fwd_bwd, fwd_only = sdpa_backward_call(q, k, v, bias, g,
                                                       True, window)
                lib_bwd = time_ms(fwd_bwd, iters) - time_ms(fwd_only, iters)
                lib_bwd_dev = (device_ms(fwd_bwd, iters)
                               - device_ms(fwd_only, iters))
                for form, from_o in (("ddpre", False), ("loop2", True)):
                    bounds = backward_bounds(b, h, l, l, d, dt, True, window,
                                             peaks, from_o, False)
                    for name in ("flash_bwd_dd", "flash_bwd_dq",
                                 "flash_bwd_dkv"):
                        if name == "flash_bwd_dd" and from_o:
                            continue  # loop2 computes D inside dq and dkv
                        key = (name if name == "flash_bwd_dd"
                               else f"{name}/{form}")
                        bound_ms, bound_by = bounds[name]
                        is_dd = name == "flash_bwd_dd"
                        rec = {
                            "max_abs_err": errs[key], "ms": times[key],
                            "plain_ms": plain_dd if is_dd else plain_ms,
                            "bound_ms": bound_ms, "bound_by": bound_by,
                            "library_ms": lib_dd if is_dd else lib_bwd,
                            "device_ms": devs[key],
                            "library_device_ms": (lib_dd_dev if is_dd
                                                  else lib_bwd_dev),
                        }
                        records[(name, form, b, l, dt, window)] = rec
                        print(f"  {key:20s} B={b} L={l:5d} window={window:3d}"
                              f" {dt:9s} err={errs[key]:.3e} (scale "
                              f"{scales[key]:.3g}) ms={times[key]:.5f} "
                              f"dev={devs[key]:.5f} bound_ms={bound_ms:.5f} "
                              f"({bound_by}) plain_ms={rec['plain_ms']:.5f} "
                              f"library_ms={rec['library_ms']:.5f} dev="
                              f"{rec['library_device_ms']:.5f} [{card}]",
                              flush=True)
                        if key in tiles:
                            tile, out, typical = tiles[key]
                            print(f"  {'':20s} worst 64-position block: "
                                  f"||err||/||ref|| = {tile:.3e} ({out}; "
                                  f"limit {TILE_TOL[dt]:g}); median |ref| "
                                  f"{typical:.3g} [{card}]", flush=True)
                pair = (times['flash_bwd_dq/ddpre']
                        + times['flash_bwd_dkv/ddpre'])
                pair_dev = (devs['flash_bwd_dq/ddpre']
                            + devs['flash_bwd_dkv/ddpre'])
                print(f"  B={b} L={l} window={window} {dt}: dq+dkv "
                      f"{pair:.5f} ms ({pair / lib_bwd:.2f}x SDPA's "
                      f"backward; device {pair_dev:.5f} ms, "
                      f"{pair_dev / lib_bwd_dev:.2f}x) (+dd {t_dd:.5f}, "
                      f"device {devs['flash_bwd_dd']:.5f} vs "
                      f"{lib_dd_dev:.5f} for (dO*O).sum(-1)), loop2 "
                      f"{times['flash_bwd_dq/loop2'] + times['flash_bwd_dkv/loop2']:.5f}"
                      f" ms; SDPA backward {lib_bwd:.5f} ms; plain backward "
                      f"{plain_ms:.5f} ms [{card}]", flush=True)
                if bad:
                    raise AssertionError(
                        f"backward kernels disagree with the plain version "
                        f"at B={b} L={l} window={window} {dt}: {bad}")
    forms = kb.FLASH_BWD_DD.forms
    print(f"  flash_bwd_dd launches by form over phase 5: {forms} "
          f"(contiguous inputs: the 16-byte-load form) [{card}]", flush=True)
    if set(forms) != {"vector"}:
        raise AssertionError(f"flash_bwd_dd ran other than its 16-byte-load "
                             f"form on contiguous inputs: {forms}")
    return {name: records[(name, "ddpre", TRAIN_BATCH, TRAIN_LEN,
                           "bfloat16", 0)]
            for name in ("flash_bwd_dd", "flash_bwd_dq", "flash_bwd_dkv")}


def phase_train(card: str) -> tuple[dict, float]:
    """GPT-2 small trained by the port's Trainer.fit on the card. Returns
    each kernel's launches over the fit and the median step time (ms)."""
    import contextlib
    import io

    import torch

    from kubeflow_tpu_torch.kernels import KERNELS
    from kubeflow_tpu_torch.models.gpt import (
        GPTConfig,
        GPTLM,
        causal_lm_eval_metrics,
        causal_lm_loss,
    )
    from kubeflow_tpu_torch.train import metrics
    from kubeflow_tpu_torch.train.checkpoint import Checkpointer
    from kubeflow_tpu_torch.train.data import synthetic_lm_dataset
    from kubeflow_tpu_torch.train.trainer import Trainer, TrainerConfig

    cfg = GPTConfig.small(attention="flash", dropout_rate=0.0,
                          max_len=TRAIN_LEN)
    t0 = time.perf_counter()
    ds = synthetic_lm_dataset(n_train=TRAIN_BATCH * TRAIN_STEPS,
                              n_test=TRAIN_BATCH, seq_len=TRAIN_LEN,
                              vocab_size=cfg.vocab_size, seed=SEED)
    model = GPTLM(cfg, device="cuda").init_weights(
        torch.Generator().manual_seed(SEED))
    trainer = Trainer(model, TrainerConfig(
        batch_size=TRAIN_BATCH, steps=TRAIN_STEPS, learning_rate=3e-4,
        warmup_steps=TRAIN_WARMUP, log_every_steps=1, seed=SEED),
        loss_fn=causal_lm_loss, eval_metrics_fn=causal_lm_eval_metrics)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"phase 6: GPT-2 small, {n_params} params "
          f"({sorted({str(p.dtype) for p in model.parameters()})}), compute "
          f"{trainer.compute_dtype}, batch {TRAIN_BATCH} x {TRAIN_LEN} "
          f"tokens, {TRAIN_STEPS} steps, set up in "
          f"{time.perf_counter() - t0:.2f}s [{card}]", flush=True)
    if trainer.compute_dtype != torch.bfloat16:
        raise AssertionError(f"AUTO resolved to {trainer.compute_dtype}")

    step_ends = []
    real_step = trainer.train_step

    def timed_step(state, batch):
        out = real_step(state, batch)
        torch.cuda.synchronize()
        step_ends.append(time.perf_counter())
        return out

    trainer.train_step = timed_step
    # the peak is the fit's: what earlier phases left for the collector
    # (phase 4's models) goes first
    held = torch.cuda.memory_allocated() / 2**30
    gc.collect()
    print(f"  device memory allocated before the fit: {held:.2f} GiB, "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB after "
          f"gc.collect() [{card}]", flush=True)
    torch.cuda.reset_peak_memory_stats()
    log = io.StringIO()
    for kern in KERNELS.values():
        kern.launches = 0      # the training path's run starts here
        kern.forms.clear()
    t_fit = time.perf_counter()
    with contextlib.redirect_stdout(log):
        state, final = trainer.fit(ds)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t_fit
    launches = {name: kern.launches for name, kern in KERNELS.items()}
    dd_forms = dict(KERNELS["flash_bwd_dd"].forms)
    peak = torch.cuda.max_memory_allocated() / 2**30
    lines = [metrics.parse_line(x) for x in log.getvalue().splitlines()]
    losses = [x["loss"] for x in lines if "loss" in x]
    steady = np.diff(step_ends[2:])          # past the first two steps
    step_ms = float(np.median(steady)) * 1e3
    print(f"  fit: {fit_s:.2f}s; losses {' '.join(f'{x:.4f}' for x in losses)}"
          f"; final eval loss {final['final_loss']:.4f} [{card}]", flush=True)
    print(f"  step time {step_ms:.2f} ms (median of steps 4..{TRAIN_STEPS}, "
          f"min {steady.min() * 1e3:.2f}, max {steady.max() * 1e3:.2f}); "
          f"{TRAIN_BATCH * TRAIN_LEN / step_ms * 1e3:.1f} tokens/s; first "
          f"step {(step_ends[0] - t_fit) * 1e3:.1f} ms; peak memory "
          f"{peak:.2f} GiB; launches {launches}; flash_bwd_dd by form "
          f"{dd_forms} [{card}]", flush=True)
    n_eval = 2 * cfg.num_layers   # the epoch's eval and the final eval
    want = {"flash_fwd": cfg.num_layers * TRAIN_STEPS + n_eval,
            **{n: cfg.num_layers * TRAIN_STEPS
               for n in ("flash_bwd_dd", "flash_bwd_dq", "flash_bwd_dkv")}}
    if launches != want:
        raise AssertionError(f"launches {launches}, expected {want}")
    if len(losses) != TRAIN_STEPS or not all(map(math.isfinite, losses)) \
            or not losses[-1] < losses[0]:
        raise AssertionError(f"training did not run clean: losses {losses}")

    # ---- checkpoint round trip on the card
    saved = {k: v.clone() for k, v in state.model.state_dict().items()}
    with tempfile.TemporaryDirectory() as tmp:
        Checkpointer(tmp).save(state.step, state)
        other = GPTLM(cfg, device="cuda").init_weights(
            torch.Generator().manual_seed(SEED + 7))
        fresh = Trainer(other, TrainerConfig(batch_size=TRAIN_BATCH),
                        loss_fn=causal_lm_loss)
        step, restored = Checkpointer(tmp).restore_latest(fresh.init_state())
    same = all(torch.equal(v, saved[k])
               for k, v in restored.model.state_dict().items())
    print(f"  checkpoint round trip: step {step}, params bit-equal {same} "
          f"[{card}]", flush=True)
    if step != TRAIN_STEPS or not same:
        raise AssertionError("checkpoint round trip changed the params")
    batch = tuple(torch.as_tensor(a[:TRAIN_BATCH], device="cuda")
                  for a in (ds.x_train, ds.y_train))
    profile_step(lambda: real_step(state, batch), step_ms, card)
    del state, restored, fresh, other, trainer, model
    torch.cuda.empty_cache()
    phase_grad_check(cfg, ds, card)
    return launches, step_ms


def profile_step(step, step_ms: float, card: str) -> None:
    """One training step under torch.profiler (device activity only): the
    ten device ops that take the most time, each hand-written kernel's
    device time per launch, and the device's idle share of the step."""
    import re

    events, wall = device_events(step, 1)
    by_name: dict = {}
    for name, _, dur in events:
        total, n = by_name.get(name, (0.0, 0))
        by_name[name] = (total + dur, n + 1)
    busy = busy_us(events)
    print(f"  profiled step: {wall * 1e3:.2f} ms host wall (unprofiled "
          f"median {step_ms:.2f} ms), device busy {busy / 1e3:.2f} ms, idle "
          f"share {100 * (1 - busy / (wall * 1e6)):.1f}%, {len(events)} "
          f"device activities [{card}]", flush=True)
    print("  top ten device ops of the step (ms, launches, share of the "
          "busy time):")
    for name, (total, n) in sorted(by_name.items(),
                                   key=lambda x: -x[1][0])[:10]:
        print(f"    {total / 1e3:9.4f} ms {n:4d}x {100 * total / busy:5.1f}% "
              f"{name[:110]}")
    ours: dict = {}
    for name, (total, n) in by_name.items():
        m = re.search(r"(flash_fwd|flash_bwd_dd|flash_bwd_dq|flash_bwd_dkv)"
                      r"(?:_vec|_tc)?_kernel", name)
        if m and "pytorch_flash" not in name:
            t, c = ours.get(m.group(1), (0.0, 0))
            ours[m.group(1)] = (t + total, c + n)
    print("  hand-written kernels in the step: " + ", ".join(
        f"{k} {t / c / 1e3:.5f} ms x {c} = {t / 1e3:.3f} ms "
        f"({100 * t / busy:.1f}% of busy)" for k, (t, c) in sorted(
            ours.items())) + f" [{card}]", flush=True)


def phase_grad_check(cfg, ds, card: str) -> None:
    """One f32 train_step at full width and depth through the kernels
    (attention="flash") against the plain attention path (dense), same
    params and batch. Tolerance: loss 1e-5 relative; each parameter's grad
    within 1e-3 of its largest |value| (sums over 2048 keys in other
    orders), that value floored at 1e-3 of the largest |grad| of the model:
    the key projection's bias has a gradient of 0 in exact arithmetic
    (softmax ignores a shift shared by a query's scores), so only rounding
    noise is left to compare there."""
    import dataclasses

    import torch

    from kubeflow_tpu_torch.kernels import KERNELS
    from kubeflow_tpu_torch.models.gpt import GPTLM, causal_lm_loss
    from kubeflow_tpu_torch.train.trainer import Trainer, TrainerConfig

    runs = {}
    sd = None
    for attention in ("flash", "dense"):
        model = GPTLM(dataclasses.replace(cfg, attention=attention),
                      device="cuda")
        if sd is None:
            model.init_weights(torch.Generator().manual_seed(SEED + 3))
            sd = model.state_dict()
        else:
            model.load_state_dict(sd)
        trainer = Trainer(model, TrainerConfig(
            batch_size=TRAIN_BATCH, compute_dtype="float32",
            learning_rate=0.0), loss_fn=causal_lm_loss)
        before = KERNELS["flash_bwd_dq"].launches
        state, m = trainer.train_step(
            trainer.init_state(),
            (ds.x_train[:TRAIN_BATCH], ds.y_train[:TRAIN_BATCH]))
        torch.cuda.synchronize()
        runs[attention] = (float(m["loss"]), {
            n: p.grad.detach().clone() for n, p in model.named_parameters()},
            KERNELS["flash_bwd_dq"].launches - before)
        del state, trainer, model
        torch.cuda.empty_cache()
    (loss_k, grads_k, n_k), (loss_p, grads_p, n_p) = runs["flash"], \
        runs["dense"]
    top = max(g.abs().max().item() for g in grads_p.values())
    worst = max(((grads_k[n] - g).abs().max().item()
                 / max(g.abs().max().item(), 1e-3 * top), n)
                for n, g in grads_p.items())
    print(f"  f32 grad check (the f32 FMA backward kernels; phase 5 holds "
          f"the bf16 tensor-core ones), flash kernels vs dense: loss "
          f"{loss_k:.6f} vs "
          f"{loss_p:.6f}; worst grad error {worst[0]:.3e} of its scale "
          f"({worst[1]}); dq launches {n_k} vs {n_p} [{card}]", flush=True)
    if (abs(loss_k - loss_p) > 1e-5 * abs(loss_p) or worst[0] > 1e-3
            or n_k != cfg.num_layers or n_p != 0):
        raise AssertionError(f"flash grads disagree with dense: {worst}")


def post(url: str, body: dict) -> tuple[int, dict, float]:
    data = json.dumps(body).encode()
    req = urllib.request.Request(
        url, data=data, headers={"Content-Type": "application/json"})
    t0 = time.perf_counter()
    try:
        with urllib.request.urlopen(req, timeout=600) as resp:
            code, raw = resp.status, resp.read()
    except urllib.error.HTTPError as exc:
        code, raw = exc.code, exc.read()
    return code, json.loads(raw), time.perf_counter() - t0


def phase_serve(card: str) -> int:
    """GPT-2 small behind the port's ModelServer. Returns the kernel's
    launch count over the main path's run."""
    import torch

    from kubeflow_tpu_torch.kernels.flash_fwd import FLASH_FWD
    from kubeflow_tpu_torch.models.gpt import GPTConfig, GPTLM, generate
    from kubeflow_tpu_torch.serving.model import TorchModel, save_predictor
    from kubeflow_tpu_torch.serving.server import ModelServer

    cfg = GPTConfig.small(attention="flash", dtype="float32")
    n_layers = cfg.num_layers
    t0 = time.perf_counter()
    flash_lm = GPTLM(cfg, device="cuda").init_weights(
        torch.Generator().manual_seed(SEED))
    sd = flash_lm.state_dict()
    n_params = sum(p.numel() for p in flash_lm.parameters())
    rng = np.random.RandomState(SEED)
    prompts = [rng.randint(1, cfg.vocab_size, (GEN_BATCH, GEN_PROMPT))
               .astype(np.int32) for _ in range(2)]
    logit_ids = []
    for _ in range(2):
        ids = rng.randint(1, cfg.vocab_size, (LOGITS_BATCH, LOGITS_LEN))
        ids[-1, -LOGITS_PAD:] = 0  # right-padded row
        logit_ids.append(ids.astype(np.int32))
    kw = {"size": "small", "config": {"attention": "flash",
                                      "dtype": "float32"}}
    with tempfile.TemporaryDirectory() as tmp:
        save_predictor(f"{tmp}/gen", "gpt-lm", sd, prompts[0],
                       generate={"max_new_tokens": GEN_NEW,
                                 "temperature": 0.0}, **kw)
        save_predictor(f"{tmp}/logits", "gpt-lm", sd, logit_ids[0], **kw)
        print(f"phase 4: GPT-2 small, {n_params} params, seeded random "
              f"weights, model dirs written in "
              f"{time.perf_counter() - t0:.2f}s [{card}]", flush=True)
        models = [TorchModel("gpt2", f"{tmp}/gen", device="cuda"),
                  TorchModel("gpt2-logits", f"{tmp}/logits", device="cuda")]
        srv = ModelServer(models, port=0, host="127.0.0.1")
        FLASH_FWD.launches = 0   # the main path's run starts here
        try:
            t0 = time.perf_counter()
            srv.start()
            load_launches = FLASH_FWD.launches
            print(f"  server up at {srv.url} in "
                  f"{time.perf_counter() - t0:.2f}s (load + warmup; "
                  f"{load_launches} launches) [{card}]", flush=True)
            if load_launches != 2 * n_layers:
                raise AssertionError(
                    f"warmup launched flash_fwd {load_launches} times, "
                    f"expected {2 * n_layers}")
            results = []
            for kind, name, ids in (("generate", "gpt2", prompts[0]),
                                    ("logits", "gpt2-logits", logit_ids[0]),
                                    ("generate", "gpt2", prompts[1]),
                                    ("logits", "gpt2-logits", logit_ids[1])):
                before = FLASH_FWD.launches
                code, body, wall = post(
                    f"{srv.url}/v1/models/{name}:predict",
                    {"instances": ids.tolist()})
                delta = FLASH_FWD.launches - before
                print(f"  v1 :predict {kind:8s} {ids.shape} -> {code} in "
                      f"{wall * 1e3:.1f} ms wall, flash_fwd launches "
                      f"+{delta} [{card}]", flush=True)
                if code != 200:
                    raise AssertionError(f"{kind} request failed: {body}")
                if delta != n_layers:
                    raise AssertionError(
                        f"{kind} request launched flash_fwd {delta} times, "
                        f"expected {n_layers} (one per layer of one "
                        "prefill/logits forward, none per decode step)")
                results.append((kind, ids, body, wall))
            launches = FLASH_FWD.launches
        finally:
            srv.stop()

    # ---- outputs against the plain attention path on the card
    dense_lm = GPTLM(GPTConfig.small(attention="dense", dtype="float32"),
                     device="cuda")
    dense_lm.load_state_dict(sd)
    for kind, ids, body, wall in results:
        x = torch.as_tensor(ids, device="cuda")
        if kind == "logits":
            got = np.asarray(body["logits"], dtype=np.float32)
            if got.shape != (*ids.shape, cfg.vocab_size) \
                    or not np.isfinite(got).all():
                raise AssertionError(f"logits response shape {got.shape}")
            with torch.inference_mode():
                want = dense_lm(x).cpu().numpy()
            err = float(np.abs(got - want).max())
            print(f"  logits response vs plain path: max abs err {err:.3e}"
                  f" [{card}]")
            if err > 1e-3:
                raise AssertionError(f"served logits off by {err}")
            continue
        toks = np.asarray(body["predictions"])
        if toks.shape != (GEN_BATCH, GEN_NEW) or toks.min() < 0 \
                or toks.max() >= cfg.vocab_size:
            raise AssertionError(f"generate response {toks.shape}")
        with torch.inference_mode():
            pre_k = flash_lm(x, cache=flash_lm.init_cache(GEN_BATCH),
                             prefill=True)
            # teacher-force the plain path (dense cached attention) on the
            # served tokens, step by step as generate() decodes
            cache = dense_lm.init_cache(GEN_BATCH)
            pre_p = dense_lm(x, cache=cache, prefill=True)
            err = (pre_k - pre_p).abs().max().item()
            toks_t = torch.as_tensor(toks, device="cuda")
            steps = [pre_p[:, -1]]
            for t in range(GEN_NEW - 1):
                steps.append(dense_lm(toks_t[:, t:t + 1], cache=cache)[:, 0])
            forced = torch.stack(steps, dim=1)                # (B, NEW, V)
            chosen = forced.gather(-1, toks_t[..., None])[..., 0]
            gap = (forced.max(-1).values - chosen).max().item()
        print(f"  prefill logits kernel vs plain path: max abs err "
              f"{err:.3e}; teacher-forced plain path: chosen token at most "
              f"{gap:.3e} below the step max [{card}]")
        if err > 1e-3 or gap > 1e-3:
            raise AssertionError(
                f"generate disagrees with the plain path: prefill {err}, "
                f"teacher-forced gap {gap}")

    # ---- serving timings through the public generate()
    x = torch.as_tensor(prompts[0], device="cuda")

    def timed(n):
        torch.cuda.synchronize()
        t = time.perf_counter()
        generate(flash_lm, x, n)
        torch.cuda.synchronize()
        return time.perf_counter() - t

    ttft = float(np.median([timed(1) for _ in range(5)]))
    full = float(np.median([timed(GEN_NEW) for _ in range(3)]))
    rate = GEN_BATCH * (GEN_NEW - 1) / (full - ttft)
    gen_wall = [w for kind, _, _, w in results if kind == "generate"]
    print(f"  TTFT (prefill {GEN_BATCH}x{GEN_PROMPT} + first token) "
          f"{ttft * 1e3:.2f} ms; decode {rate:.1f} tokens/s at batch "
          f"{GEN_BATCH}; generate request wall "
          f"{', '.join(f'{w * 1e3:.1f}' for w in gen_wall)} ms; peak "
          f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
          f"[{card}]", flush=True)
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device; this script runs on "
              "the card", file=sys.stderr)
        return 2
    from kubeflow_tpu_torch.kernels import KERNELS, build_all
    from kubeflow_tpu_torch.kernels.build import report_path, sources

    card = card_line()
    print(card, flush=True)
    peaks = PEAKS["pcie" if "pcie" in card.lower() else "sxm"]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; "
          "TF32 off for f32 matmuls and convolutions", flush=True)

    took = build_all()
    print(f"phase 2: built {sorted(took)} in "
          f"{max(took.values(), default=0.0):.2f}s [{card}]", flush=True)
    for src in sources():
        report = report_path(src)
        if report.exists():
            print(f"  {src}: {ptxas_summary(report.read_text())}")
    spill64, routes = tensor_core_report(card)

    timings = {"flash_fwd": phase_kernels(peaks, card, routes)}
    serve_launches = phase_serve(card)
    print(f"  serving path: flash_fwd launches {serve_launches} [{card}]",
          flush=True)
    timings.update(phase_backward(peaks, card, routes))
    launches, step_ms = phase_train(card)
    per_step = launches["flash_bwd_dq"] // TRAIN_STEPS  # one per layer
    attn_ms = per_step * sum(t["ms"] for t in timings.values())
    # SDPA's backward stands beside dq and dkv together: count it once
    lib_ms = per_step * sum(timings[n]["library_ms"] for n in (
        "flash_fwd", "flash_bwd_dd", "flash_bwd_dq"))
    print(f"where the training step goes: the four kernels take "
          f"{attn_ms:.2f} ms of the {step_ms:.2f} ms step "
          f"({100 * attn_ms / step_ms:.1f}%) at their phase 3/5 times "
          f"x {per_step} launches each; SDPA forward + backward and "
          f"(dO*O).sum(-1) would take {lib_ms:.2f} ms. Share of the bound: "
          + ", ".join(f"{n} {100 * t['bound_ms'] / t['ms']:.2f}%"
                      for n, t in timings.items()) + "; by device time: "
          + ", ".join(f"{n} {t['device_ms']:.5f} ms "
                      f"({100 * t['bound_ms'] / t['device_ms']:.2f}% of the "
                      f"bound; library {t['library_device_ms']:.5f} ms)"
                      for n, t in timings.items()) + f" [{card}]",
          flush=True)

    if spill64:
        raise AssertionError(f"the bf16 tensor-core kernels spill {spill64} "
                             "bytes at D = 64")

    record = {"kernels": [{
        "name": name,
        "route": "cuda",
        "source": "kubeflow_tpu_torch/csrc/" + KERNELS[name].source,
        "replaces": KERNELS[name].replaces,
        "launches": launches[name],
        **timings[name],
    } for name in ("flash_fwd", "flash_bwd_dd", "flash_bwd_dq",
                   "flash_bwd_dkv")]}
    print(card)
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
