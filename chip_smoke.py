#!/usr/bin/env python3
"""Drive the PyTorch port (kubeflow_tpu_torch) on one NVIDIA card, end to end.

    python3 chip_smoke.py            # from the repository root, one card

Phases, each fatal on failure:
  1. the card: name and power limit (nvidia-smi); TF32 off for f32 matmuls
  2. build every hand-written kernel from csrc/ (one nvcc per source)
  3. each kernel against its plain PyTorch version on the card, at the
     serving path's shapes and a sweep (L 17/128/1024, window 0/100, f32 and
     bf16), with times of the kernel, the plain version and one PyTorch
     library call beside the kernel's bound
  4. the main path: GPT-2 small (GPTConfig.small(), full width, seeded random
     weights) behind the port's ModelServer, two generate-mode and two
     logits-mode v1 requests over HTTP, launch counts checked per request,
     outputs checked against the plain attention path on the card

The line before last is the kernels' JSON record, the last line
{"ok": true, "device": {...}}. Without a CUDA device it exits nonzero and
prints no result.
"""

from __future__ import annotations

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


def attention_bound(b, h, lq, lk, d, dtype, causal, window, peaks):
    """(bound_ms, bound_by): the larger of the operations this input needs
    over the type's peak and the bytes it must move over the HBM rate."""
    if causal:
        rows = np.arange(lq)
        seen = rows + 1 if not window else np.minimum(rows + 1, window)
        pairs = int(np.minimum(seen, lk).sum())
    else:
        pairs = lq * lk
    flops = 4.0 * b * h * d * pairs
    size = 4 if dtype == "float32" else 2
    nbytes = (size * b * h * d * (2 * lq + 2 * lk)   # q, o, k, v
              + size * b * lk + 4 * b * h * lq)      # bias, lse
    t_ops = flops / peaks[dtype]
    t_bytes = nbytes / peaks["bytes"]
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def make_attention_inputs(b, l, h, d, dtype, pad, gen):
    import torch

    q, k, v = (torch.randn((b, l, h, d), generator=gen, device="cuda")
               .to(dtype) for _ in range(3))
    bias = torch.zeros((b, 1, 1, l), device="cuda", dtype=dtype)
    if pad:
        bias[-1, ..., l - pad:] = -1e9
    return q, k, v, bias


def sdpa_call(q, k, v, bias, causal, window):
    """One PyTorch library call for the same function (yardstick only)."""
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


def phase_kernels(peaks) -> dict:
    """Kernel vs plain version on the card. Returns the record of the
    serving path's prefill shape."""
    import torch

    from kubeflow_tpu_torch.kernels.flash_fwd import flash_fwd
    from kubeflow_tpu_torch.parallel.ring_attention import flash_forward_plain

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    tol = {"float32": 1e-4, "bfloat16": 2e-2}
    cases = [  # (tag, B, L, window, dtype, pad): the serving path first
        ("prefill", GEN_BATCH, GEN_PROMPT, 0, "float32", 0),
        ("logits", LOGITS_BATCH, LOGITS_LEN, 0, "float32", LOGITS_PAD),
    ]
    for l in (17, 128, 1024):
        for window in (0, 100):
            for dt in ("float32", "bfloat16"):
                cases.append(("sweep", 2, l, window, dt,
                              max(1, min(16, l // 8))))
    h, d = 12, 64
    print("phase 3: flash_fwd kernel vs plain version (B, L, H=12, D=64, "
          "causal, pad bias on the last keys of the last row)")
    records = {}
    for tag, b, l, window, dt, pad in cases:
        dtype = getattr(torch, dt)
        q, k, v, bias = make_attention_inputs(b, l, h, d, dtype, pad, gen)
        o_k, lse_k = flash_fwd(q, k, v, bias, True, window)
        o_p, lse_p = flash_forward_plain(q, k, v, bias, 128, True, window)
        torch.cuda.synchronize()
        err_o = (o_k.float() - o_p.float()).abs().max().item()
        err_l = (lse_k - lse_p).abs().max().item()
        ok = math.isfinite(err_o) and err_o <= tol[dt] and err_l <= tol[dt]
        iters = 20 if l >= 1024 else 50
        ms = time_ms(lambda: flash_fwd(q, k, v, bias, True, window), iters)
        plain_ms = time_ms(
            lambda: flash_forward_plain(q, k, v, bias, 128, True, window),
            iters)
        lib_ms = None
        if tag == "prefill" or l == 1024:
            lib_ms = time_ms(sdpa_call(q, k, v, bias, True, window), iters)
        bound_ms, bound_by = attention_bound(b, h, l, l, d, dt, True, window,
                                             peaks)
        print(f"  {tag:8s} B={b} L={l:5d} window={window:3d} {dt:9s} "
              f"err_o={err_o:.3e} err_lse={err_l:.3e} (tol {tol[dt]:g}) "
              f"kernel_ms={ms:.5f} plain_ms={plain_ms:.5f} "
              f"library_ms={lib_ms if lib_ms is None else f'{lib_ms:.5f}'} "
              f"bound_ms={bound_ms:.5f} ({bound_by})", flush=True)
        if not ok:
            raise AssertionError(
                f"flash_fwd disagrees with the plain version: {tag} B={b} "
                f"L={l} window={window} {dt}: O {err_o}, lse {err_l}")
        records[(tag, l, window, dt)] = {
            "max_abs_err": err_o, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": lib_ms,
        }
    return records[("prefill", GEN_PROMPT, 0, "float32")]


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
              f"{time.perf_counter() - t0:.2f}s", flush=True)
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
                  f"{load_launches} launches)", flush=True)
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
            print(f"  logits response vs plain path: max abs err {err:.3e}")
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
              f"{gap:.3e} below the step max")
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
    from kubeflow_tpu_torch.kernels.build import BUILD_DIR

    card = card_line()
    print(card, flush=True)
    peaks = PEAKS["pcie" if "pcie" in card.lower() else "sxm"]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; "
          "TF32 off for f32 matmuls and convolutions", flush=True)

    took = build_all()
    print(f"phase 2: built {sorted(took)} in "
          f"{max(took.values(), default=0.0):.2f}s", flush=True)
    for name in KERNELS:
        report = BUILD_DIR / f"{name}.nvcc.txt"
        if report.exists():
            print(report.read_text().strip())

    flash = phase_kernels(peaks)
    launches = phase_serve(card)

    record = {"kernels": [{
        "name": "flash_fwd",
        "route": "cuda",
        "source": "kubeflow_tpu_torch/csrc/" + KERNELS["flash_fwd"].source,
        "replaces": KERNELS["flash_fwd"].replaces,
        "launches": launches,
        **flash,
    }]}
    print(card)
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
