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
  7. the engine (run after phase 4): GPT-2 small in bf16 compute with f32
     parameters served through the continuous-batching engine over a paged
     KV pool (8 rows, block 16) behind ModelServer; 16 requests of 128
     tokens (8 sharing a 64-token system prefix, 2 sampled at temperature
     0.8 with top_k 50 through a second model dir) from 8 client threads,
     128 new tokens each; checks (a) every greedy token against the plain
     path under teacher forcing (within 8 bf16 ulps of its step's largest
     logit), (b) flash_fwd launches exactly 12 per prefill from position
     0, (c) pool reuse of the shared prefix, (d) a keep_chain chain resumed
     on a second engine continues token-identical, (e) a beam predictor's
     score against the winning beam's log-prob from a plain forward, (f) a
     sampled request repeated with its seed repeats; prints TTFT p50/p99,
     aggregate tokens/s, dispatches, prefill counts, peak memory and
     flash_fwd at the engine's prefill shape
  8. speculative decoding and the in-process fleet (run last, beside
     phase 7's figures):
     (a) speculative_generate on GPT-2 small in f32, the draft the target's
     weights in a second module, 128-token prompt, 64 new tokens, gamma 4:
     every rejection at a near-tie of the target's top two logits (1e-4),
     every token within 1e-3 of its step's max under teacher forcing, 24
     flash_fwd launches (both prompts' prefills, no verify block); (b) the
     speculative engine behind ModelServer through continuous_draft_dir, a
     6-layer draft (distilgpt2's shapes, the target's first blocks), bf16,
     phase 7's 16 greedy requests plus one sampled: greedy tokens as phase
     7's check (a), flash_fwd launches = 12 x target + 6 x draft prefills
     from position 0 (spec rounds none), the sampled request repeats with
     its key; acceptance, tokens per dispatch, tokens/s, TTFT and memory
     beside phase 7's; (c) fleet_replicas 2 over one pool behind
     ModelServer: decode dispatch per engine while both decode, then phase
     7's greedy traffic with the replica carrying the first request killed
     at its first token (dropped 0, no failure, >= 1 requeue resumed from
     its chain, tokens as (a)), then a tightened TTFT SLO answers 503 with
     Retry-After >= 1; (d) a disaggregated prefill/decode pair over one
     pool under run_loadtest_sync (8 prompts, 4 longer than the prefill
     chunk): all complete, no prompt position computed on the decode
     replica, tokens as (a)

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
# the engine path (phase 7): bench.py's gpt2s_decode row (bf16, 8 rows,
# 128 + 128 tokens) as continuous-batching traffic
ENGINE_ROWS, ENGINE_PROMPT, ENGINE_NEW, ENGINE_BLOCK = 8, 128, 128, 16
ENGINE_PREFIX, ENGINE_SHARED, ENGINE_REQUESTS, ENGINE_CLIENTS = 64, 8, 16, 8
ENGINE_SAMPLED, ENGINE_TEMP, ENGINE_TOP_K = 2, 0.8, 50
ENGINE_RESUME_AT, ENGINE_RESUME_NEW, ENGINE_BEAMS, ENGINE_BEAM_NEW = \
    16, 48, 4, 16
# phase 8: speculative decoding (a 6-layer draft: distilgpt2's shapes), the
# two-replica fleet (its both-decoding warm-up of FLEET_WARM_NEW tokens), and
# the disaggregated pair (prompts either side of its prefill chunk)
SPEC_GAMMA, SPEC_NEW, SPEC_DRAFT_LAYERS = 4, 64, 6
FLEET_REPLICAS, FLEET_WARM_NEW = 2, 32
DISAGG_PROMPTS, DISAGG_SHORT, DISAGG_LONG, DISAGG_NEW = 8, 48, 192, 32
DISAGG_CHUNK, DISAGG_CHUNKS_PER_TICK = 64, 4
# bf16 logits: one ulp is 2^-8 of the largest |logit| (the limit of
# tests/test_torch_train.py: 8 ulps)
BF16_ULP, BF16_ULPS = 2.0 ** -8, 8
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


def device_ms(fn, iters: int, attempts: int = 5) -> float:
    """Device time of one fn() call: for each activity name in a trace of
    iters calls, its mean duration times the times a call runs it
    (round(count / iters)), summed. A trace can lose an activity at its
    edge (19 of 20 on the card), which this rounding absorbs. A trace
    that holds nothing, or holds some activity in fewer than half of the
    calls (the card has lost most of one kernel's launches from a 10-call
    trace, which reads as 0), is retried, up to `attempts` times; then the
    largest reading stands, and none above 0 raises."""
    best = 0.0
    for _ in range(attempts):
        try:
            events, _ = device_events(fn, iters)
        except AssertionError:
            continue
        by_name: dict = {}
        for name, _, dur in events:
            by_name.setdefault(name, []).append(dur)
        ms = sum(sum(d) / len(d) * round(len(d) / iters)
                 for d in by_name.values()) / 1e3
        if all(round(len(d) / iters) for d in by_name.values()):
            return ms
        best = max(best, ms)
    if best > 0:
        return best
    raise AssertionError(f"torch.profiler recorded no device time of the "
                         f"call in {attempts} traces")


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


def engine_prompts(vocab: int) -> tuple[list, list]:
    """Phase 7's traffic from the seed: (prompts, sampled flags). The first
    ENGINE_SHARED prompts share an ENGINE_PREFIX-token system prefix; the
    last ENGINE_SAMPLED are sampled."""
    rng = np.random.RandomState(SEED + 7)
    prefix = rng.randint(1, vocab, ENGINE_PREFIX)
    prompts = []
    for i in range(ENGINE_REQUESTS):
        if i < ENGINE_SHARED:
            tail = rng.randint(1, vocab, ENGINE_PROMPT - ENGINE_PREFIX)
            prompts.append(np.concatenate([prefix, tail]).astype(np.int32))
        else:
            prompts.append(rng.randint(1, vocab, ENGINE_PROMPT)
                           .astype(np.int32))
    sampled = [i >= ENGINE_REQUESTS - ENGINE_SAMPLED
               for i in range(ENGINE_REQUESTS)]
    return prompts, sampled


def teacher_forced_gap(model, prompts, tokens) -> tuple[float, float]:
    """Each generated token against the plain path: the model (dense
    attention) prefills the prompts, then reads the generated tokens in one
    block through its cache, and each step's chosen logit is compared with
    its largest. Returns (largest gap, largest gap in units of that step's
    bf16 ulp, 2^-8 of its largest |logit|)."""
    import torch

    x = torch.as_tensor(np.stack(prompts), device="cuda").long()
    y = torch.as_tensor(np.stack(tokens), device="cuda").long()
    with torch.inference_mode():
        cache = model.init_cache(x.shape[0])
        first = model(x, cache=cache)[:, -1:]
        rest = model(y[:, :-1], cache=cache)
        logits = torch.cat([first, rest], dim=1)          # (B, NEW, V)
        top = logits.max(-1).values
        gap = top - logits.gather(-1, y[..., None])[..., 0]
        ulp = BF16_ULP * logits.abs().max(-1).values
    return gap.max().item(), (gap / ulp).max().item()


class Samples:
    """The engines' time-series hook (any object with .record(name,
    value)): every decode tick's seconds and every request's TTFT, with
    the thread that recorded it."""

    def __init__(self):
        import threading

        self.lock = threading.Lock()
        self.rows: list = []

    def record(self, name: str, value: float) -> None:
        with self.lock:
            self.rows.append((name, value, time.perf_counter()))


def engine_tick_profile(module, card: str) -> None:
    """Where an engine tick goes on the card, with no other thread in the
    process: the 8-row decode forward alone (loop time), ten steady ticks
    of one engine of ENGINE_ROWS busy rows over a paged pool timed on the
    host clock, then ten more under torch.profiler (device busy per tick,
    top device ops; the profiler adds host time to every launch, so the
    idle share divides by the unprofiled ticks)."""
    import torch

    from kubeflow_tpu_torch.serving.continuous import ContinuousBatcher
    from kubeflow_tpu_torch.serving.fleet import PagedKVPool

    x = torch.ones((ENGINE_ROWS, 1), dtype=torch.long, device="cuda")
    cache = module.init_cache(ENGINE_ROWS)

    def step():
        with torch.inference_mode():
            module(x, cache=cache)
            cache.index.fill_(ENGINE_PROMPT)

    forward_ms = time_ms(step, 20)
    rng = np.random.RandomState(SEED + 12)
    eng = ContinuousBatcher(module, max_rows=ENGINE_ROWS,
                            paged_kv=PagedKVPool(ENGINE_BLOCK, 1024))
    for _ in range(ENGINE_ROWS):
        eng.submit(rng.randint(1, module.cfg.vocab_size, ENGINE_PROMPT),
                   max_new_tokens=ENGINE_NEW)
    for _ in range(4):       # admission, then steady decode ticks
        eng.tick()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(10):
        eng.tick()
    torch.cuda.synchronize()
    tick_ms = (time.perf_counter() - t0) * 1e2
    events, wall = device_events(eng.tick, 10)
    busy_ms = busy_us(events) / 1e4
    by_name: dict = {}
    for name, _, dur in events:
        by_name[name] = by_name.get(name, 0.0) + dur
    print(f"  a steady engine tick ({ENGINE_ROWS} rows, paged, no other "
          f"thread): {tick_ms:.3f} ms host wall, device busy {busy_ms:.3f} "
          f"ms (profiled: {wall * 1e2:.3f} ms wall), idle share "
          f"{100 * (1 - busy_ms / tick_ms):.1f}%; the {ENGINE_ROWS}-row "
          f"decode forward alone {forward_ms:.3f} ms loop, "
          f"{device_ms(step, 20):.3f} ms device; top device ops of ten "
          "ticks: " + "; ".join(
              f"{d / 1e3:.3f} ms {n[:60]}" for n, d in sorted(
                  by_name.items(), key=lambda x: -x[1])[:4])
          + f" [{card}]", flush=True)
    eng.run_until_idle()


def phase_engine(peaks, card: str) -> tuple[int, dict]:
    """GPT-2 small served through the continuous-batching engine in bf16.
    Returns flash_fwd's launches over the engine path's run, and the
    engine's figures phase 8 prints its own beside."""
    import threading

    import torch

    from kubeflow_tpu_torch.kernels import KERNELS
    from kubeflow_tpu_torch.kernels.flash_fwd import FLASH_FWD, flash_fwd
    from kubeflow_tpu_torch.models.gpt import GPTConfig, GPTLM, beam_search
    from kubeflow_tpu_torch.parallel.ring_attention import (
        flash_forward_plain,
    )
    from kubeflow_tpu_torch.serving.continuous import ContinuousBatcher
    from kubeflow_tpu_torch.serving.model import TorchModel, save_predictor
    from kubeflow_tpu_torch.serving.server import ModelServer
    from kubeflow_tpu_torch.tracing import Tracer

    cfg = GPTConfig.small(attention="flash", dtype="bfloat16")
    n_layers = cfg.num_layers
    t0 = time.perf_counter()
    sd = GPTLM(cfg, device="cuda").init_weights(
        torch.Generator().manual_seed(SEED + 5)).state_dict()
    prompts, sampled = engine_prompts(cfg.vocab_size)
    kw = {"size": "small", "config": {"attention": "flash",
                                      "dtype": "bfloat16"}}
    gen = {"continuous": True, "continuous_rows": ENGINE_ROWS,
           "paged_kv_block": ENGINE_BLOCK, "max_new_tokens": ENGINE_NEW,
           "temperature": 0.0}
    example = np.stack(prompts[:1])
    with tempfile.TemporaryDirectory() as tmp:
        save_predictor(f"{tmp}/greedy", "gpt-lm", sd, example,
                       generate=gen, **kw)
        save_predictor(f"{tmp}/sampled", "gpt-lm", sd, example,
                       generate={**gen, "temperature": ENGINE_TEMP,
                                 "top_k": ENGINE_TOP_K, "seed": SEED},
                       **kw)
        save_predictor(f"{tmp}/beam", "gpt-lm", sd, example,
                       generate={"num_beams": ENGINE_BEAMS,
                                 "max_new_tokens": ENGINE_BEAM_NEW}, **kw)
        models = {name: TorchModel(f"gpt2-{name}", f"{tmp}/{name}",
                                   device="cuda")
                  for name in ("greedy", "sampled", "beam")}
        srv = ModelServer(list(models.values()), port=0, host="127.0.0.1")
        srv.start()
    try:
        engines = {n: models[n]._engine for n in ("greedy", "sampled")}
        tracer, samples = Tracer(), {n: Samples() for n in engines}
        for n, eng in engines.items():
            eng.tracer = tracer    # the engine's spans count the prefills
            eng.tsdb = samples[n]  # its decode-tick and TTFT samples
        print(f"phase 7: GPT-2 small, bf16 compute, f32 params, engine "
              f"{ENGINE_ROWS} rows, paged KV block {ENGINE_BLOCK}; server up "
              f"with the greedy, sampled and beam predictors in "
              f"{time.perf_counter() - t0:.2f}s [{card}]", flush=True)
        results = [None] * ENGINE_REQUESTS

        def client(c):
            for i in range(c, ENGINE_REQUESTS, ENGINE_CLIENTS):
                name = "sampled" if sampled[i] else "greedy"
                results[i] = post(f"{srv.url}/v1/models/gpt2-{name}:predict",
                                  {"instances": [prompts[i].tolist()]})

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for kern in KERNELS.values():
            kern.launches = 0      # the engine path's run starts here
        t_run = time.perf_counter()
        threads = [threading.Thread(target=client, args=(c,))
                   for c in range(ENGINE_CLIENTS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        wall = time.perf_counter() - t_run
        launches = {n: k.launches for n, k in KERNELS.items()}
        peak = torch.cuda.max_memory_allocated() / 2**30
        if any(t.is_alive() for t in threads):
            raise AssertionError("an engine client did not finish")
        tokens = []
        for i, (code, body, _) in enumerate(results):
            if code != 200:
                raise AssertionError(f"engine request {i} failed: {body}")
            toks = np.asarray(body["predictions"])
            if toks.shape != (1, ENGINE_NEW) or toks.min() < 0 \
                    or toks.max() >= cfg.vocab_size:
                raise AssertionError(f"engine response {i}: {toks.shape}")
            tokens.append(toks[0])
        ttft = np.array([body["timing"]["ttft_s"]
                         for _, body, _ in results]) * 1e3
        prefills = [s for s in tracer.snapshot()
                    if s["name"] == "engine.prefill_chunk"]
        from_zero = sum(s["attrs"]["tokens_reused"] == 0 for s in prefills)
        g = engines["greedy"]
        dispatches = {n: e.step_count for n, e in engines.items()}
        total = ENGINE_REQUESTS * ENGINE_NEW
        print(f"  {ENGINE_REQUESTS} requests x {ENGINE_PROMPT} tokens from "
              f"{ENGINE_CLIENTS} client threads, {ENGINE_NEW} new tokens "
              f"each: {wall:.3f}s wall, {total / wall:.1f} tokens/s "
              f"aggregate, {(total - ENGINE_REQUESTS) / wall:.1f} decode "
              f"tokens/s (first tokens excluded); TTFT (engine) p50 "
              f"{np.percentile(ttft, 50):.2f} ms, p99 "
              f"{np.percentile(ttft, 99):.2f} ms, min {ttft.min():.2f}, max "
              f"{ttft.max():.2f}; dispatches {dispatches}; greedy engine "
              f"prefill_tokens_total {g.prefill_tokens_total}, "
              f"prefill_tokens_reused {g.prefill_tokens_reused}; pool "
              f"{g.paged_kv.metrics}; peak memory {peak:.2f} GiB; launches "
              f"{launches} [{card}]", flush=True)
        # decode ticks: while the sampled engine also decodes (the second
        # wave), the two engine threads share the interpreter lock
        ticks = {n: [(v, t) for name, v, t in smp.rows
                     if name == "serving.decode_tick_s"]
                 for n, smp in samples.items()}
        both = (min(t for _, t in ticks["sampled"]),
                max(t for _, t in ticks["sampled"]))
        alone = [v for v, t in ticks["greedy"] if not both[0] <= t <= both[1]]
        shared = [v for v, t in ticks["greedy"] if both[0] <= t <= both[1]]
        greedy_n = ENGINE_REQUESTS - ENGINE_SAMPLED
        figures = {
            "tokens_per_s": total / wall, "wall_s": wall,
            "ttft_p50_ms": np.percentile(ttft, 50),
            "ttft_p99_ms": np.percentile(ttft, 99),
            "dispatches": dispatches["greedy"],
            "tokens_per_dispatch": (greedy_n * (ENGINE_NEW - 1)
                                    / dispatches["greedy"]),
            "peak_gib": peak, "tick_ms_alone": np.median(alone) * 1e3,
            "tick_ms_two_engines": np.median(shared) * 1e3}
        print(f"  decode dispatch (forward to read-back) median: greedy "
              f"engine alone {np.median(alone) * 1e3:.2f} ms over "
              f"{len(alone)}, beside the sampled engine "
              f"{np.median(shared) * 1e3:.2f} ms over {len(shared)}; "
              f"sampled engine {np.median([v for v, _ in ticks['sampled']]) * 1e3:.2f}"
              f" ms; engine TTFT samples {sum(name == 'serving.ttft_s' for smp in samples.values() for name, _, _ in smp.rows)}"
              f" [{card}]", flush=True)
        # (b) the flash kernel ran on every prefill from position 0, and
        # on nothing else
        if len(prefills) != ENGINE_REQUESTS \
                or launches["flash_fwd"] != n_layers * from_zero:
            raise AssertionError(
                f"flash_fwd launched {launches['flash_fwd']} times over "
                f"{len(prefills)} prefills, {from_zero} from position 0; "
                f"expected {n_layers} per prefill from position 0")
        # (c) the shared prefix seeds from the pool
        want_reused = ENGINE_PREFIX * (ENGINE_SHARED - 1)
        if g.prefill_tokens_reused < want_reused:
            raise AssertionError(f"pool reuse {g.prefill_tokens_reused} < "
                                 f"{want_reused}")
        # (a) greedy tokens against the plain path under teacher forcing
        dense = GPTLM(GPTConfig.small(attention="dense", dtype="bfloat16"),
                      device="cuda")
        dense.load_state_dict(sd)
        greedy = [i for i in range(ENGINE_REQUESTS) if not sampled[i]]
        gap, ulps = teacher_forced_gap(dense, [prompts[i] for i in greedy],
                                       [tokens[i] for i in greedy])
        print(f"  (a) {len(greedy)} greedy requests under teacher forcing on "
              f"the plain path: chosen logit at most {gap:.4e} below its "
              f"step's max, {ulps:.2f} bf16 ulps (limit {BF16_ULPS}) "
              f"[{card}]", flush=True)
        if not ulps <= BF16_ULPS:
            raise AssertionError(f"engine tokens off the plain path by "
                                 f"{ulps} ulps")
        # (d) a keep_chain chain, resumed on a second engine over the same
        # pool, continues as an uninterrupted run of that prompt (both
        # engines ENGINE_ROWS wide: the same decode shapes)
        rng = np.random.RandomState(SEED + 8)
        p = rng.randint(1, cfg.vocab_size, ENGINE_PROMPT).astype(np.int32)
        module = g.module
        kept = g.submit(p, max_new_tokens=ENGINE_RESUME_AT, keep_chain=True)
        kept.result(timeout=300)
        chain = kept.chain
        chain_len = chain.length
        keep = chain_len - p.size + 1
        second = ContinuousBatcher(module, max_rows=ENGINE_ROWS,
                                   paged_kv=g.paged_kv)
        resumed = second.submit(p, max_new_tokens=ENGINE_RESUME_NEW,
                                resume_from=(chain, kept.tokens[:keep]))
        second.run_until_idle()
        straight = ContinuousBatcher(module, max_rows=ENGINE_ROWS)
        whole = straight.submit(p, max_new_tokens=ENGINE_RESUME_NEW)
        straight.run_until_idle()
        same = np.array_equal(resumed.result(1), whole.result(1))
        print(f"  (d) keep_chain after {ENGINE_RESUME_AT} tokens: chain of "
              f"{chain_len} positions, resumed with {keep} tokens on a "
              f"second engine (prefill_tokens_total "
              f"{second.prefill_tokens_total}) to {ENGINE_RESUME_NEW}: equal "
              f"to an uninterrupted run {same} [{card}]", flush=True)
        if not same or not resumed.resumed or second.prefill_tokens_total:
            raise AssertionError("the resumed chain diverged")
        # (e) beam search through the predictor, its score from a plain
        # forward
        code, body, _ = post(f"{srv.url}/v1/models/gpt2-beam:predict",
                             {"instances": [prompts[0].tolist()]})
        if code != 200:
            raise AssertionError(f"beam request failed: {body}")
        beam_ids = np.asarray(body["predictions"])
        x = torch.as_tensor(np.stack(prompts[:1]), device="cuda").long()
        ids, score = beam_search(module, x, ENGINE_BEAM_NEW, ENGINE_BEAMS)
        y = ids.long()
        with torch.inference_mode():
            cache = dense.init_cache(1)
            logits = torch.cat([dense(x, cache=cache)[:, -1:],
                                dense(y[:, :-1], cache=cache)], dim=1)
        logp = torch.log_softmax(logits.float(), dim=-1)
        exact = logp.gather(-1, y[..., None]).sum().item()
        # |d log_softmax| <= 2 max |d logit| a step: 8 ulps each
        tol = (2 * BF16_ULPS * BF16_ULP
               * logits.abs().max(-1).values.sum()).item()
        err = abs(score.item() - exact)
        print(f"  (e) beam search ({ENGINE_BEAMS} beams, "
              f"{ENGINE_BEAM_NEW} tokens) through the predictor: ids equal "
              f"to a direct call {np.array_equal(beam_ids, ids.cpu().numpy())}; "
              f"score {score.item():.4f} vs plain forward {exact:.4f}, "
              f"|diff| {err:.3e} (limit {tol:.3e}) [{card}]", flush=True)
        if not np.array_equal(beam_ids, ids.cpu().numpy()) or err > tol:
            raise AssertionError("beam search disagrees with the plain "
                                 "forward")
        # (f) a sampled request repeated with its seed repeats
        s_eng = engines["sampled"]
        draws = [s_eng.submit(prompts[-1], temperature=ENGINE_TEMP,
                              key=SEED + 9) for _ in range(2)]
        a, b = (r.result(timeout=300) for r in draws)
        other = s_eng.submit(prompts[-1], temperature=ENGINE_TEMP,
                             key=SEED + 10).result(timeout=300)
        print(f"  (f) sampled (temperature {ENGINE_TEMP}, top_k "
              f"{ENGINE_TOP_K}) twice with one seed: equal "
              f"{np.array_equal(a, b)}; another seed differs "
              f"{not np.array_equal(a, other)} [{card}]", flush=True)
        if not np.array_equal(a, b) or np.array_equal(a, other):
            raise AssertionError("sampling is not deterministic per seed")
    finally:
        srv.stop()
    engine_tick_profile(module, card)
    # flash_fwd at the engine's prefill shape, against its plain version
    gen_ = torch.Generator(device="cuda").manual_seed(SEED + 11)
    q, k, v, bias = make_attention_inputs(1, ENGINE_PROMPT, 12, 64,
                                          torch.bfloat16, 0, gen_)
    o_k, _ = flash_fwd(q, k, v, bias, True, 0)
    o_p, _ = flash_forward_plain(q, k, v, bias, 128, True, 0)
    err_o = (o_k.float() - o_p.float()).abs().max().item()
    kernel = functools.partial(flash_fwd, q, k, v, bias, True, 0)
    ms, dev = time_ms(kernel, 50), device_ms(kernel, 50)
    bound_ms, bound_by = attention_bound(1, 12, ENGINE_PROMPT, ENGINE_PROMPT,
                                         64, "bfloat16", True, 0, peaks)
    causal = sdpa_causal_call(q, k, v)
    print(f"  flash_fwd at the engine's prefill shape (1, {ENGINE_PROMPT}, "
          f"12, 64) bf16 causal: err_o {err_o:.3e} (tol 2e-2), "
          f"kernel_ms={ms:.5f} dev={dev:.5f} bound_ms={bound_ms:.5f} "
          f"({bound_by}) sdpa_causal dev={device_ms(causal, 50):.5f} "
          f"[{card}]", flush=True)
    if not err_o <= 2e-2:
        raise AssertionError(f"flash_fwd at the prefill shape: {err_o}")
    del models, engines, srv, dense, module, second, straight
    gc.collect()
    torch.cuda.empty_cache()
    return launches["flash_fwd"], figures


# ------------------------------------------------------------- phase 8


def zero_launches() -> None:
    """Every kernel's launch count to 0: a path's run starts here."""
    from kubeflow_tpu_torch.kernels import KERNELS

    for kern in KERNELS.values():
        kern.launches = 0


def flash_launches() -> int:
    from kubeflow_tpu_torch.kernels import KERNELS

    return KERNELS["flash_fwd"].launches


def prefills_from_zero(tracer) -> tuple[int, int]:
    """(target, draft) prefill chunks that started at position 0, from the
    engines' spans: the chunks that run the flash kernel."""
    def from_zero(attrs):
        return (attrs.get("tokens_reused", 0) == 0
                and attrs["pos"] == attrs["tokens_computed"])

    spans = tracer.snapshot()
    return tuple(sum(1 for s in spans if s["name"] == name
                     and from_zero(s["attrs"]))
                 for name in ("engine.prefill_chunk",
                              "engine.draft_prefill_chunk"))


def post_headers(url: str, body: dict) -> tuple[int, dict, dict]:
    """POST JSON: (status, body, response headers), errors included."""
    req = urllib.request.Request(
        url, data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=600) as resp:
            return resp.status, json.loads(resp.read()), dict(resp.headers)
    except urllib.error.HTTPError as exc:
        return exc.code, json.loads(exc.read()), dict(exc.headers)


def serve_traffic(url: str, prompts: list) -> tuple[list, float]:
    """Phase 7's client pattern: ENGINE_CLIENTS threads send the prompts in
    turn, one v1 request each, to `url`. Returns ([(code, body)], wall)."""
    import threading

    results = [None] * len(prompts)

    def client(c):
        for i in range(c, len(prompts), ENGINE_CLIENTS):
            code, body, _ = post(url, {"instances": [prompts[i].tolist()]})
            results[i] = (code, body)

    t0 = time.perf_counter()
    threads = [threading.Thread(target=client, args=(c,))
               for c in range(ENGINE_CLIENTS)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    if any(t.is_alive() for t in threads):
        raise AssertionError("a client did not finish")
    return results, time.perf_counter() - t0


def served_tokens(results, vocab: int, what: str) -> list:
    """The (ENGINE_NEW,) token rows of 200 answers; raises on any other."""
    tokens = []
    for i, (code, body) in enumerate(results):
        if code != 200:
            raise AssertionError(f"{what} request {i} failed: {body}")
        toks = np.asarray(body["predictions"])
        if toks.shape != (1, ENGINE_NEW) or toks.min() < 0 \
                or toks.max() >= vocab:
            raise AssertionError(f"{what} response {i}: {toks.shape}")
        tokens.append(toks[0])
    return tokens


def check_greedy(dense, prompts, tokens, what: str, card: str) -> None:
    """Phase 7's check (a): every token within BF16_ULPS of its step's
    largest logit under teacher forcing on the plain path (prompts grouped
    by length)."""
    worst = (0.0, 0.0)
    for n in sorted({p.size for p in prompts}):
        idx = [i for i, p in enumerate(prompts) if p.size == n]
        gap, ulps = teacher_forced_gap(dense, [prompts[i] for i in idx],
                                       [tokens[i] for i in idx])
        worst = max(worst, (ulps, gap))
    print(f"  {what}: {len(tokens)} greedy requests under teacher forcing "
          f"on the plain path: chosen logit at most {worst[1]:.4e} below "
          f"its step's max, {worst[0]:.2f} bf16 ulps (limit {BF16_ULPS}) "
          f"[{card}]", flush=True)
    if not worst[0] <= BF16_ULPS:
        raise AssertionError(f"{what} tokens off the plain path by "
                             f"{worst[0]} ulps")


def tick_overlap(samples: dict) -> dict:
    """Each engine's decode-dispatch samples (ms) taken while every other
    engine was also decoding: inside the window all of them span."""
    ticks = {n: [(v, t) for name, v, t in smp.rows
                 if name == "serving.decode_tick_s"]
             for n, smp in samples.items()}
    lo = max(min(t for _, t in tk) for tk in ticks.values())
    hi = min(max(t for _, t in tk) for tk in ticks.values())
    return {n: [v * 1e3 for v, t in tk if lo <= t <= hi]
            for n, tk in ticks.items()}


def phase_spec_solo(card: str) -> int:
    """Phase 8 (a): speculative_generate on GPT-2 small in f32 with the
    target's weights in a second module as the draft. Returns flash_fwd's
    launches over the call."""
    import torch

    from kubeflow_tpu_torch.models.gpt import GPTConfig, GPTLM
    from kubeflow_tpu_torch.models.speculative import speculative_generate

    cfg = GPTConfig.small(attention="flash", dtype="float32")
    sd = GPTLM(cfg, device="cuda").init_weights(
        torch.Generator().manual_seed(SEED + 20)).state_dict()
    target, draft = (GPTLM(cfg, device="cuda") for _ in range(2))
    for m in (target, draft):
        m.load_state_dict(sd)
        m.eval()
    p = np.random.RandomState(SEED + 21).randint(1, cfg.vocab_size,
                                                 ENGINE_PROMPT)
    x = torch.as_tensor(p[None], device="cuda").long()
    # record every verify block (cached, not a prefill) and its logits
    verifies = []
    forward = target.forward

    def recording(ids, cache=None, prefill=False, **kw):
        out = forward(ids, cache=cache, prefill=prefill, **kw)
        if cache is not None and not prefill:
            verifies.append((ids[0, 1:].clone(), out[0].clone()))
        return out

    target.forward = recording
    speculative_generate(target, draft, x, 8, gamma=SPEC_GAMMA)  # warm
    verifies.clear()
    torch.cuda.synchronize()
    zero_launches()          # the solo speculative path's run starts here
    t0 = time.perf_counter()
    out, stats = speculative_generate(target, draft, x, SPEC_NEW,
                                      gamma=SPEC_GAMMA)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = flash_launches()
    del target.forward
    tokens = out[0].cpu().numpy()
    # each round's accept count from its verify block; at a rejection, the
    # gap between the target's two largest logits at that step
    accepts, rejections = [], []
    for props, logits in verifies:
        picks = logits.argmax(-1)
        a = int((props == picks[:SPEC_GAMMA]).long().cumprod(0).sum())
        accepts.append(a)
        if a < SPEC_GAMMA:
            top2 = logits[a].topk(2).values
            rejections.append((len(accepts), a, (top2[0] - top2[1]).item()))
    dense = GPTLM(GPTConfig.small(attention="dense", dtype="float32"),
                  device="cuda")
    dense.load_state_dict(sd)
    gap, _ = teacher_forced_gap(dense, [p], [tokens])
    print(f"phase 8 (a): speculative_generate, GPT-2 small f32, the draft "
          f"the target's weights in a second module, {ENGINE_PROMPT}-token "
          f"prompt, {SPEC_NEW} new tokens, gamma {SPEC_GAMMA}: {stats}, "
          f"{wall:.3f}s ({SPEC_NEW / wall:.1f} tokens/s); rejections (round, "
          f"step, the target's top-two logit gap there) {rejections}; "
          f"flash_fwd launches {launches}; teacher-forced gap {gap:.3e} "
          f"(limit 1e-3) [{card}]", flush=True)
    if stats["tokens"] != SPEC_NEW or tokens.shape != (SPEC_NEW,):
        raise AssertionError(f"speculative_generate gave {tokens.shape}")
    if len(accepts) != stats["rounds"] \
            or sum(accepts) != stats["drafted_accepted"]:
        raise AssertionError(f"the verify blocks' accept counts {accepts} "
                             f"disagree with {stats}")
    if any(g > 1e-4 for _, _, g in rejections):
        raise AssertionError(f"a self-draft proposal was rejected away from "
                             f"a near-tie: {rejections}")
    if not gap <= 1e-3:
        raise AssertionError(f"speculative tokens off the plain path: {gap}")
    if launches != 2 * cfg.num_layers:
        raise AssertionError(
            f"flash_fwd launched {launches} times; expected "
            f"{2 * cfg.num_layers} (both prompts' prefills, no verify)")
    del target, draft, dense
    return launches


def phase_spec_engine(sd, prompts, tmp: str, card: str, plain: dict) -> int:
    """Phase 8 (b): the speculative engine behind ModelServer, its draft
    the target's first SPEC_DRAFT_LAYERS blocks through
    continuous_draft_dir. Returns flash_fwd's launches over the run."""
    import torch

    from kubeflow_tpu_torch.models.gpt import GPTConfig, GPTLM
    from kubeflow_tpu_torch.serving.model import TorchModel, save_predictor
    from kubeflow_tpu_torch.serving.server import ModelServer
    from kubeflow_tpu_torch.tracing import Tracer

    cfg = {"attention": "flash", "dtype": "bfloat16"}
    # distilgpt2's shapes; its weights: the target's embeddings, first
    # blocks and final norm (the published weights are not in the repo)
    draft_sd = {k: v for k, v in sd.items() if not k.startswith("layers.")
                or int(k.split(".")[1]) < SPEC_DRAFT_LAYERS}
    example = np.stack(prompts[:1])
    save_predictor(f"{tmp}/spec/draft", "gpt-lm", draft_sd, example,
                   generate={"max_new_tokens": ENGINE_NEW}, size="small",
                   config={**cfg, "num_layers": SPEC_DRAFT_LAYERS})
    save_predictor(f"{tmp}/spec", "gpt-lm", sd, example, generate={
        "continuous": True, "continuous_rows": ENGINE_ROWS,
        "paged_kv_block": ENGINE_BLOCK, "max_new_tokens": ENGINE_NEW,
        "continuous_draft_dir": "draft", "speculative_gamma": SPEC_GAMMA},
        size="small", config=cfg)
    model = TorchModel("gpt2-spec", f"{tmp}/spec", device="cuda")
    t0 = time.perf_counter()
    srv = ModelServer([model], port=0, host="127.0.0.1").start()
    try:
        eng = model._engine
        n_t = eng.module.cfg.num_layers
        n_d = eng.draft_module.cfg.num_layers
        tracer, smp = Tracer(), Samples()
        eng.tracer, eng.tsdb = tracer, smp
        print(f"phase 8 (b): the speculative engine, GPT-2 small target "
              f"({n_t} layers) and a {n_d}-layer draft (distilgpt2's "
              f"shapes), bf16 compute, gamma {eng.gamma}, {ENGINE_ROWS} "
              f"rows, paged KV block {ENGINE_BLOCK}; server up in "
              f"{time.perf_counter() - t0:.2f}s [{card}]", flush=True)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_launches()      # the speculative engine's run starts here
        t_run = time.perf_counter()
        sampled = eng.submit(prompts[-1], max_new_tokens=ENGINE_NEW,
                             temperature=ENGINE_TEMP, key=SEED + 9)
        results, _ = serve_traffic(
            f"{srv.url}/v1/models/gpt2-spec:predict", prompts)
        first = sampled.result(timeout=600)
        wall = time.perf_counter() - t_run
        launches = flash_launches()
        peak = torch.cuda.max_memory_allocated() / 2**30
        tokens = served_tokens(results, eng.module.cfg.vocab_size,
                               "speculative engine")
        t_zero, d_zero = prefills_from_zero(tracer)
        ttft = np.array([body["timing"]["ttft_s"]
                         for _, body in results]) * 1e3
        total = (len(prompts) + 1) * ENGINE_NEW
        ticks = [v * 1e3 for name, v, _ in smp.rows
                 if name == "serving.decode_tick_s"]
        rate = eng.spec_accepted / max(eng.spec_proposed, 1)
        per_dispatch = (total - len(prompts) - 1) / eng.step_count
        print(f"  {len(prompts)} greedy requests from {ENGINE_CLIENTS} "
              f"client threads and 1 sampled, {ENGINE_NEW} new tokens each: "
              f"{wall:.3f}s wall; acceptance {eng.spec_accepted}/"
              f"{eng.spec_proposed} = {rate:.4f}; tokens per dispatch "
              f"{per_dispatch:.3f} (phase 7 "
              f"{plain['tokens_per_dispatch']:.3f}); dispatches "
              f"{eng.step_count} (phase 7 {plain['dispatches']}); "
              f"{total / wall:.1f} tokens/s aggregate (phase 7 "
              f"{plain['tokens_per_s']:.1f}); TTFT p50 "
              f"{np.percentile(ttft, 50):.2f} ms, p99 "
              f"{np.percentile(ttft, 99):.2f} ms (phase 7 "
              f"{plain['ttft_p50_ms']:.2f}, {plain['ttft_p99_ms']:.2f}); "
              f"decode dispatch (a spec round) median "
              f"{np.median(ticks):.2f} ms (phase 7's plain step "
              f"{plain['tick_ms_alone']:.2f}); peak memory {peak:.2f} GiB "
              f"(phase 7 {plain['peak_gib']:.2f}); prefill_tokens_total "
              f"{eng.prefill_tokens_total}, reused "
              f"{eng.prefill_tokens_reused}; flash_fwd launches {launches} "
              f"over {t_zero} target and {d_zero} draft prefills from "
              f"position 0 [{card}]", flush=True)
        if launches != n_t * t_zero + n_d * d_zero \
                or d_zero != len(prompts) + 1:
            raise AssertionError(
                f"flash_fwd launched {launches} times; expected {n_t} x "
                f"{t_zero} target + {n_d} x {d_zero} draft prefills from "
                "position 0 and none in a spec round")
        dense = GPTLM(GPTConfig.small(attention="dense", dtype="bfloat16"),
                      device="cuda")
        dense.load_state_dict(sd)
        check_greedy(dense, prompts, tokens, "(b) speculative engine", card)
        # repeated now, the prompt's K/V come from the pool and its last
        # position runs the masked path where the traffic's admission ran
        # the flash kernel: the repeats are held against each other
        a, b, other = (eng.submit(
            prompts[-1], max_new_tokens=ENGINE_NEW, temperature=ENGINE_TEMP,
            key=key) for key in (SEED + 9, SEED + 9, SEED + 10))
        a, b, other = (r.result(timeout=600) for r in (a, b, other))
        print(f"  sampled (temperature {ENGINE_TEMP}, engine top_k 0) twice "
              f"with one key: equal {np.array_equal(a, b)}; another key "
              f"differs {not np.array_equal(a, other)}; equal to the "
              f"traffic's draw (prefilled through the kernel) "
              f"{np.array_equal(a, first)} [{card}]", flush=True)
        if not np.array_equal(a, b) or np.array_equal(a, other):
            raise AssertionError("speculative sampling is not "
                                 "deterministic per key")
    finally:
        srv.stop()
    return launches


def phase_fleet(sd, prompts, tmp: str, card: str, plain: dict) -> int:
    """Phase 8 (c): a two-replica fleet over one pool behind ModelServer,
    a replica killed at the first token, then an admission shed. Returns
    flash_fwd's launches over the drill."""
    import threading

    from kubeflow_tpu_torch.models.gpt import GPTConfig, GPTLM
    from kubeflow_tpu_torch.serving.model import TorchModel, save_predictor
    from kubeflow_tpu_torch.serving.server import ModelServer
    from kubeflow_tpu_torch.tracing import Tracer

    save_predictor(f"{tmp}/fleet", "gpt-lm", sd, np.stack(prompts[:1]),
                   generate={"continuous": True,
                             "continuous_rows": ENGINE_ROWS,
                             "paged_kv_block": ENGINE_BLOCK,
                             "max_new_tokens": ENGINE_NEW,
                             "fleet_replicas": FLEET_REPLICAS},
                   size="small", config={"attention": "flash",
                                         "dtype": "bfloat16"})
    model = TorchModel("gpt2-fleet", f"{tmp}/fleet", device="cuda")
    srv = ModelServer([model], port=0, host="127.0.0.1").start()
    url = f"{srv.url}/v1/models/gpt2-fleet:predict"
    try:
        router = model._fleet
        n_layers = router.replicas[0].engine.module.cfg.num_layers
        samples = {r.name: Samples() for r in router.replicas}
        for r in router.replicas:
            r.engine.tsdb = samples[r.name]
        # both replicas decoding at once, away from the drill's prompts
        rng = np.random.RandomState(SEED + 31)
        vocab = router.replicas[0].engine.module.cfg.vocab_size
        warm = [router.submit(rng.randint(1, vocab, ENGINE_PROMPT),
                              max_new_tokens=FLEET_WARM_NEW)
                for _ in range(2 * ENGINE_ROWS)]
        for h in warm:
            h.result(timeout=600)
        both = tick_overlap(samples)
        print(f"phase 8 (c): a {FLEET_REPLICAS}-replica fleet over one "
              f"pool, GPT-2 small bf16; {2 * ENGINE_ROWS} requests of "
              f"{FLEET_WARM_NEW} tokens with both replicas decoding: decode "
              f"dispatch median " + ", ".join(
                  f"{n} {np.median(v):.2f} ms over {len(v)}"
                  for n, v in both.items())
              + f" (phase 7: one engine alone "
              f"{plain['tick_ms_alone']:.2f} ms, two engine threads "
              f"{plain['tick_ms_two_engines']:.2f} ms) [{card}]", flush=True)
        tracer = Tracer()
        router.wire_monitoring(tracer=tracer)
        base = dict(router.metrics)
        killed = {}

        def killer():
            # the replica carrying the first request to have its first
            # token is killed then and there
            deadline = time.monotonic() + 300
            while time.monotonic() < deadline:
                for rep in router.replicas:
                    if any(r is not None and r.tokens
                           for r in list(rep.engine._rows)):
                        killed["at"] = time.perf_counter()
                        killed["name"] = rep.name
                        router.kill_replica(rep.name)
                        return
                time.sleep(0.0005)

        zero_launches()      # the fleet drill's run starts here
        watcher = threading.Thread(target=killer)
        t_run = time.perf_counter()
        watcher.start()
        results, wall = serve_traffic(url, prompts)
        watcher.join(timeout=600)
        launches = flash_launches()
        m = {k: v - base.get(k, 0) for k, v in router.metrics.items()}
        t_zero, _ = prefills_from_zero(tracer)
        dropped = sum(code != 200 for code, _ in results)
        ttft = np.array([body["timing"]["ttft_s"] for code, body in results
                         if code == 200]) * 1e3
        print(f"  {len(prompts)} requests from {ENGINE_CLIENTS} client "
              f"threads, {killed.get('name')} killed at the first token "
              f"{killed.get('at', t_run) - t_run:.3f}s into the run: "
              f"dropped {dropped}; {wall:.3f}s wall, "
              f"{len(prompts) * ENGINE_NEW / wall:.1f} tokens/s (phase 7 "
              f"{plain['tokens_per_s']:.1f}); TTFT p50 "
              f"{np.percentile(ttft, 50):.2f} ms, p99 "
              f"{np.percentile(ttft, 99):.2f} ms (phase 7 "
              f"{plain['ttft_p50_ms']:.2f}, {plain['ttft_p99_ms']:.2f}); "
              f"this run's counters {m}; router snapshot "
              f"{router.snapshot()}; flash_fwd launches {launches} over "
              f"{t_zero} prefills from position 0 [{card}]", flush=True)
        if dropped or m["requests_failed_total"] \
                or m["replica_kills_total"] != 1 \
                or m["requests_requeued_total"] < 1 \
                or m["requeues_resumed_total"] < 1:
            raise AssertionError(f"the kill drill: dropped {dropped}, {m}")
        if launches != n_layers * t_zero:
            raise AssertionError(
                f"flash_fwd launched {launches} times; expected {n_layers} "
                f"x {t_zero} prefills from position 0")
        dense = GPTLM(GPTConfig.small(attention="dense", dtype="bfloat16"),
                      device="cuda")
        dense.load_state_dict(sd)
        check_greedy(dense, prompts, served_tokens(
            results, dense.cfg.vocab_size, "fleet"),
            "(c) fleet after the kill", card)
        # tighten the SLO until a v1 request is shed
        slo, shed = 1.0, None
        for _ in range(12):
            router.ttft_slo_s = slo
            code, body, headers = post_headers(
                url, {"instances": [prompts[0].tolist()]})
            if code == 503:
                shed = (body, headers)
                break
            if code != 200:
                raise AssertionError(f"shed probe: {code} {body}")
            slo /= 10
        router.ttft_slo_s = 0.0
        if shed is None:
            raise AssertionError("no request was shed down to a "
                                 f"{slo * 10:.1e}s TTFT SLO")
        retry = shed[1].get("Retry-After")
        print(f"  ttft_slo_s {slo:.1e}: 503, Retry-After {retry}, body "
              f"{shed[0]} [{card}]", flush=True)
        if retry is None or int(retry) < 1 or not shed[0].get("request_id"):
            raise AssertionError(f"the shed answer lacks Retry-After or "
                                 f"its request id: {shed}")
    finally:
        srv.stop()
    return launches


def phase_disagg(module, dense, card: str) -> int:
    """Phase 8 (d): one prefill replica and one decode replica over one
    pool, driven by run_loadtest_sync. Returns flash_fwd's launches."""
    from kubeflow_tpu_torch.serving.continuous import ContinuousBatcher
    from kubeflow_tpu_torch.serving.fleet import (
        FleetRouter,
        PagedKVPool,
        run_loadtest_sync,
    )
    from kubeflow_tpu_torch.tracing import Tracer

    pool = PagedKVPool(ENGINE_BLOCK, 1024)
    pre = ContinuousBatcher(module, max_rows=ENGINE_ROWS, paged_kv=pool,
                            prefill_chunk=DISAGG_CHUNK,
                            max_chunks_per_tick=DISAGG_CHUNKS_PER_TICK)
    dec = ContinuousBatcher(module, max_rows=ENGINE_ROWS, paged_kv=pool,
                            prefill_chunk=DISAGG_CHUNK)
    tracer = Tracer()
    router = FleetRouter([("prefill-0", pre, "prefill"),
                          ("decode-0", dec, "decode")], tracer=tracer)
    rng = np.random.RandomState(SEED + 32)
    prompts = [rng.randint(1, module.cfg.vocab_size,
                           DISAGG_LONG if i % 2 else DISAGG_SHORT)
               .astype(np.int32) for i in range(DISAGG_PROMPTS)]
    handles = []
    submit = router.submit

    def keep(*a, **kw):
        handles.append(submit(*a, **kw))
        return handles[-1]

    router.submit = keep
    zero_launches()          # the disaggregated pair's run starts here
    t0 = time.perf_counter()
    report = run_loadtest_sync(router, prompts, seed=SEED + 32,
                               mean_gap_ticks=1.0, new_tokens=DISAGG_NEW)
    wall = time.perf_counter() - t0
    launches = flash_launches()
    s = report.summary()
    t_zero, _ = prefills_from_zero(tracer)
    print(f"phase 8 (d): a disaggregated pair (1 prefill replica, chunk "
          f"{DISAGG_CHUNK}, {DISAGG_CHUNKS_PER_TICK} chunks a tick; 1 "
          f"decode replica) over one pool, {DISAGG_PROMPTS} seeded prompts "
          f"of {DISAGG_SHORT} and {DISAGG_LONG} tokens, {DISAGG_NEW} new "
          f"each, run_loadtest_sync: {wall:.3f}s, {s}; handoffs "
          f"{router.metrics['prefill_handoffs_total']}; prompt positions "
          f"computed on the decode replica {dec.prefill_tokens_total}; "
          f"flash_fwd launches {launches} over {t_zero} prefill chunks from "
          f"position 0 [{card}]", flush=True)
    if s["completed"] != DISAGG_PROMPTS or s["dropped"]:
        raise AssertionError(f"the disaggregated pair: {s}")
    if dec.prefill_tokens_total or \
            router.metrics["prefill_handoffs_total"] != DISAGG_PROMPTS:
        raise AssertionError("a prompt occupied a decode slot")
    if launches != module.cfg.num_layers * t_zero \
            or t_zero != DISAGG_PROMPTS:
        raise AssertionError(
            f"flash_fwd launched {launches} times over {t_zero} prefills "
            f"from position 0; expected {module.cfg.num_layers} each")
    tokens = [next(np.asarray(h.tokens) for h in handles
                   if np.array_equal(h.prompt, p)) for p in prompts]
    check_greedy(dense, prompts, tokens, "(d) disaggregated pair", card)
    return launches


def phase_spec_fleet(peaks, card: str, plain: dict) -> int:
    """Phase 8: speculative decoding, solo (a) and in the engine (b), the
    two-replica fleet with its kill drill and shed (c), and the
    disaggregated pair (d). Returns flash_fwd's launches over their runs."""
    import torch

    from kubeflow_tpu_torch.kernels.flash_fwd import flash_fwd
    from kubeflow_tpu_torch.models.gpt import GPTConfig, GPTLM
    from kubeflow_tpu_torch.parallel.ring_attention import (
        flash_forward_plain,
    )

    t0 = time.perf_counter()
    launches = phase_spec_solo(card)
    gc.collect()
    torch.cuda.empty_cache()
    # phase 7's weights and greedy traffic
    cfg = GPTConfig.small(attention="flash", dtype="bfloat16")
    sd = GPTLM(cfg, device="cuda").init_weights(
        torch.Generator().manual_seed(SEED + 5)).state_dict()
    prompts, _ = engine_prompts(cfg.vocab_size)
    with tempfile.TemporaryDirectory() as tmp:
        launches += phase_spec_engine(sd, prompts, tmp, card, plain)
        gc.collect()
        torch.cuda.empty_cache()
        launches += phase_fleet(sd, prompts, tmp, card, plain)
    gc.collect()
    torch.cuda.empty_cache()
    module = GPTLM(cfg, device="cuda")
    module.load_state_dict(sd)
    dense = GPTLM(GPTConfig.small(attention="dense", dtype="bfloat16"),
                  device="cuda")
    dense.load_state_dict(sd)
    launches += phase_disagg(module.eval(), dense, card)
    # flash_fwd at the disaggregated prefill chunk's shape
    gen_ = torch.Generator(device="cuda").manual_seed(SEED + 33)
    q, k, v, bias = make_attention_inputs(1, DISAGG_CHUNK, 12, 64,
                                          torch.bfloat16, 0, gen_)
    o_k, _ = flash_fwd(q, k, v, bias, True, 0)
    o_p, _ = flash_forward_plain(q, k, v, bias, 128, True, 0)
    err_o = (o_k.float() - o_p.float()).abs().max().item()
    kernel = functools.partial(flash_fwd, q, k, v, bias, True, 0)
    bound_ms, bound_by = attention_bound(1, 12, DISAGG_CHUNK, DISAGG_CHUNK,
                                         64, "bfloat16", True, 0, peaks)
    print(f"  flash_fwd at the prefill chunk's shape (1, {DISAGG_CHUNK}, "
          f"12, 64) bf16 causal: err_o {err_o:.3e} (tol 2e-2), "
          f"kernel_ms={time_ms(kernel, 50):.5f} "
          f"dev={device_ms(kernel, 50):.5f} bound_ms={bound_ms:.5f} "
          f"({bound_by}) sdpa_causal "
          f"dev={device_ms(sdpa_causal_call(q, k, v), 50):.5f} [{card}]",
          flush=True)
    if not err_o <= 2e-2:
        raise AssertionError(f"flash_fwd at the chunk shape: {err_o}")
    print(f"phase 8 took {time.perf_counter() - t0:.1f}s [{card}]",
          flush=True)
    del module, dense
    gc.collect()
    torch.cuda.empty_cache()
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
    engine_launches, plain = phase_engine(peaks, card)
    print(f"  engine path: flash_fwd launches {engine_launches} [{card}]",
          flush=True)
    timings.update(phase_backward(peaks, card, routes))
    launches, step_ms = phase_train(card)
    # phase 8 comes last: run between phases 7 and 5, it was followed by
    # torch.profiler traces that lost a kernel's launches at the training
    # shape (see PERF.md, Open questions)
    spec_launches = phase_spec_fleet(peaks, card, plain)
    print(f"  speculative and fleet paths: flash_fwd launches "
          f"{spec_launches} [{card}]", flush=True)
    engine_launches += spec_launches
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

    # flash_fwd's launches: the training path's and the engine paths'
    launches["flash_fwd"] += engine_launches
    print(f"flash_fwd launches: training "
          f"{launches['flash_fwd'] - engine_launches}, engine, speculative "
          f"and fleet paths (phases 7-8) {engine_launches} [{card}]",
          flush=True)
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
