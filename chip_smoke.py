#!/usr/bin/env python3
"""Drive the PyTorch port (kubeflow_tpu_torch) on one NVIDIA card, end to end.

    python3 chip_smoke.py            # from the repository root, one card

Phases, each fatal on failure:
  1. the card: name and power limit (nvidia-smi); TF32 off for f32 matmuls
  2. build every hand-written kernel from csrc/ (one nvcc per source, all
     started together)
  3. the forward kernel against its plain PyTorch version on the card, at
     the serving path's shapes, the training shape and a sweep (L
     17/128/1024, window 0/100, f32 and bf16), and phase 10's encoder forms
     non-causal (BERT (16, 128) and (16, 512) under the padding bias of
     row lengths L/2..L, ViT (32, 197) under a zero bias; f32 and bf16),
     with times of the kernel, the plain version and one PyTorch library
     call (SDPA, masked) beside the kernel's bound
  4. the serving path: GPT-2 small (GPTConfig.small(), full width, seeded
     random weights) behind the port's ModelServer, two generate-mode and
     two logits-mode v1 requests over HTTP, launch counts checked per
     request, outputs checked against the plain attention path on the card
  5. the three backward kernels (D pre-kernel, dq, dkv; D read and D from
     O) against the plain backward at (2, 1024, 12, 64) and the training
     shape (4, 2048, 12, 64), f32 and bf16, causal, window 0/100, pad bias,
     and at phase 3's encoder forms, non-causal and without the bias
     gradient, with their times, bounds, the plain time and SDPA's
     backward; besides
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
     falling; a checkpoint round trip and a profiled step; then the same fit
     graphed from the same weights (fused_steps=TRAIN_FUSED: three chunks,
     each one CUDA graph replay, and a two-step tail): launches checked per
     dispatch (a replay's from its capture, the warm-up step's counted),
     every logged loss within GRAPH_LOSS_RTOL of the eager fit's at its step,
     the final parameters' largest difference, step time, tokens/s, peak
     memory and a profiled chunk's idle share beside the eager fit's; the
     checkpoint crossing (graphed -> eager -> graphed: the next two losses
     equal on both sides, then a chunk captured over the restored state);
     one graphed chunk under profile_dir (each flash kernel's launches in
     the written trace against the counters: what the trace lost); one f32
     step's loss and grads through the kernels against the plain attention
     path (the f32 FMA backward kernels; the bf16 tensor-core kernels that
     training runs are held by phase 5); then the restart-warm check: two
     processes in turn run a short graphed fit over one fresh
     compile_cache_dir, the first building every kernel library into it,
     the second running nvcc zero times, both logging the same losses
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
  8. speculative decoding and the in-process fleet (run after phase 6,
     beside phase 7's figures):
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
  9. the pod tier (run last): phase 7's weights written once as a
     flax-layout params.npz that four worker processes load (python -m
     kubeflow_tpu_torch.serving.fleet.podworker, one engine each, on the
     card), spawned together: (a) prefill-0 (chunk 64, 4 chunks a tick),
     decode-0 and decode-1 behind the router over one home pool, phase 7's
     16 prompts, 64 new tokens each, under run_loadtest_sync, decode-0
     SIGKILLed at the first tick at which a row of it has decoded a token:
     16 of 16 completed, dropped 0, every requeue resumed from its chain,
     16 handoffs, no prompt position computed on a decode pod, tokens as
     phase 7's check (a), the victim's process gone and the others alive;
     (b) the prefill pod maps libflash_fwd and its span file counts 12
     flash_fwd launches per prefill from position 0 (the launches join the
     JSON record); (c) prefill-0, decode-1 and the spare decode-2 with every
     client ticking from its own thread: the client-side tick round trip
     while both decode pods hold rows beside phase 8 (c)'s and phase 7's
     dispatch, tokens/s, TTFT, each pod's ready time, the handoff bytes,
     one chain's host time on the wire and each pod's card memory; every
     pod is killed at the end

  10. the BASELINE families (run after phase 6, before phase 8), each
     trained by the port's Trainer.fit and served by its ModelServer:
     (a) ResNet-50 (1000 classes, 224², 7x7 stem, f32 parameters, bf16
     compute) at batch 128 for 10 steps over 256 synthetic images: loss
     finite and falling, every BatchNorm running average moved, images/s;
     the s2d stem's f32 logits against the 7x7 stem's (1e-4); served as
     resnet50, v1 logits against the module's eval forward; (b) BERT-base
     classifier, flash, dropout 0, bf16, 16 x 128 with padded rows, 10
     steps: each step launches each flash kernel 12 times, steps/s; one f32
     step's loss and grads through the kernels against the plain attention
     path (as phase 6); the same fit graphed (fused_steps=FAM_BERT_FUSED,
     checked and compared as phase 6's); served as bert-classifier (base),
     logits within 8
     bf16 ulps of the plain path; BertForMaskedLM for 3 steps, masked loss
     finite; (c) ViT-B/16 (197 tokens), flash, bf16, batch 32, 5 steps,
     served, logits against the plain path; (d) MnistMLP and MnistCNN on
     synthetic 28x28x1, eval accuracy at least 3x chance, both served
  11. the predictor's artifacts (run last): (a) int8: GPT-2 small (phase
     4's f32 weights) written as a float and a quantize=True model dir
     (the params.npz bytes of both), both served on the card: every int8
     weight read back within half an int8 step of the float one, 12
     flash_fwd launches a forward, the logits of 4 x 128 prompts' max
     relative error and top-1 agreement (printed: the logits of random
     weights have no margins); then the JAX package's test's setting, an
     MnistMLP trained one epoch: the int8 dir under 1/2.5 of the float
     one, the served classes agreeing on >= ART_TOP1 of the test images; (b) AOT: export_predictor of GPT-2
     small's greedy generate (phase 4's 4 x 128 prompts, 32 new tokens) and
     of the BERT-base classifier (bf16, 16 x 128) with compile_cache a
     fresh dir (export seconds, artifact bytes), then a new process with
     KFT_COMPILE_CACHE set serves both artifacts: nvcc runs 0, its
     libflash_fwd mapped from the cache dir, 12 launches a prefill inside
     the exported program, tokens equal to the eager predictor's, BERT's
     logits within BF16_ULPS of the eager path's, cold start of the
     artifact against a rebuild; (c) python -m
     kubeflow_tpu_torch.serving.server --storage-uri pvc://... (
     KFTPU_PVC_ROOT and KFT_COMPILE_CACHE set) --aot --max-batch-size 8 as
     a subprocess: 8 concurrent one-row BERT requests coalesce into fewer
     batches, 12 launches a coalesced forward (its /metrics counters), the
     logits (b)'s; a continuous GPT-2 small loaded through the repository
     API shows the kfserving_engine_* gauges on /metrics until unloaded;
     (d) a pod spawned twice over one fresh compile_cache_dir: the first
     builds the libraries, the respawn runs nvcc 0 times and maps them
     from the dir
  12. the LLM lifecycle (run last), every model written from a seed at
     published shapes and every step through the port's own entry points:
     (a) a GPT2LMHeadModel-layout checkpoint at GPT-2 small's shapes and a
     byte-level BPE made here (the 256 byte symbols, merges learned from
     LLM_CORPUS, <|endoftext|>) through `python -m kubeflow_tpu_torch
     import-gpt2`; the dir's model (flash_fwd, f32) against GPT-2's
     forward written out over the checkpoint, within 1e-3; (b) LoRA (rank
     8, alpha 16) on the imported model, flash, bf16 compute, f32 params,
     GPT-2's dropout 0.1, 12 steps at 8 x 1024 eagerly and graphed
     (fused_steps 4: three replays): graphed losses against the eager
     ones (GRAPH_LOSS_RTOL; bit-equal is the target), the base weights
     bit-unchanged, the optimizer's state the adapters' only, each flash
     kernel 12 launches and dropout_fwd 25 / dropout_bwd 24 a step (the
     frozen embedding's dropout has no backward) in every dispatch, one
     site's kept share within 4 sigma of 0.9, two steps' masks differing,
     remat's loss and adapter grads within 1e-5 of the plain step's; step
     times, tokens/s, idle shares, peak memory and optimizer bytes beside
     one full-parameter step's; (c) the merged model written with
     save_predictor (flash) and served by `python -m kubeflow_tpu_torch
     generate --prompt TEXT`: its tokens (stderr) within 1e-3 of the
     step's max under teacher forcing on the plain path, 12 flash_fwd
     launches in that process; (d) import-llama at TinyLlama-1.1B's widths
     cut to LLAMA_LAYERS of 22 layers, served bf16 through generate with
     flash_fwd on the GQA-repeated heads (tokens within BF16_ULPS under
     teacher forcing), and import-bert at BERT-base's shapes served bf16
     flash within BF16_ULPS of the plain path; (e) the dropout kernels
     against their plain version at (8, 1024, 768) bf16 and f32 and a
     ragged size (outputs, grads and masks bit-equal, two calls
     bit-equal), their loop and device times beside the bound, the plain
     version and torch's dropout

  13. sharded and MoE training and MoE serving ((b)-(c) run first, on
     an empty card; (a) and (d) last), at
     Mixtral-8x7B's published widths (32 heads, 8 KV heads, head_dim 128,
     8 experts top-2, SwiGLU, seeded weights): (a) flash_fwd, dd, dq and
     dkv at head_dim 128 against their plain versions, (4, 1024, 32, 128)
     causal bf16 and f32 and the (1, 128) prefill, phase 3's and 5's
     limits, their loop and device times beside the bound and SDPA's; (b)
     a child process given the PyTorchJob env of a world of one runs
     runtime.initialize_from_env over NCCL: its heartbeat's rendezvous and
     rendezvous-done beats, its rendezvous span, an all_reduce; (c) in that
     child, MOE_TRAIN_LAYERS layers at MOE_BATCH x MOE_LEN fitted from the
     same weights eagerly, under MeshConfig(fsdp=1) over the NCCL group
     (losses within MOE_MESH_RTOL of the eager fit's; a world of one: no
     FSDP2 code and no collective runs in its steps, which only the CPU
     gloo gangs of the tests exercise) and graphed
     (fused_steps=MOE_FUSED, within GRAPH_LOSS_RTOL): launches checked per
     dispatch, the loss finite and falling and its first value the cross
     entropy plus the layers' aux losses; step time, tokens/s, peak memory
     and a profiled step's or chunk's idle share; (d) MOE_SERVE_LAYERS
     layers in bf16 served by the continuous-batching engine behind
     ModelServer: MOE_ROWS requests of MOE_PROMPT tokens, MOE_NEW new
     tokens each: every greedy token within BF16_ULPS of its step's max
     under teacher forcing on the plain path (dense attention, no cache,
     each MoE layer a plain loop over the experts that the engine's
     arithmetic chose, so a near-tie that rounds the other way cannot
     move a token to another expert) and of the engine's arithmetic run
     a request at a time, flash_fwd launches = layers x prefills, MoE forwards routed only in prefills and dropless only in
     decode ticks; TTFT, decode tokens/s, the tick and what bounds it

  14. context-parallel training's local attention (run after phase 6's
     restart-warm check): (a) blockwise attention (plain PyTorch, the ring
     and Ulysses paths' attention on each rank; vjp "custom", the FA2
     backward from the saved logsumexp) against the flash kernels at (4,
     2048, 12, 64) causal, f32 and bf16, window 0 and 256 (bench.py's
     gpt2s_swa_2k): phase 3's and 5's limits and TILE_TOL, custom against
     "autodiff" at the JAX package's bounds, loop and device times beside
     the kernels'; (b) the peak memory of one attention's forward and
     backward at (1, 8192, 12, 64) bf16 causal: custom below autodiff; (c)
     GPT-2 small at 4 x 2048, f32 parameters, bf16 compute, on a context
     mesh of one, CTX_STEPS steps each with attention ring, Ulysses and
     flash from the same weights and batches: losses within 2e-3 and grad
     norms within 1% of the flash fit's, the flash fit 12 launches of each
     flash kernel a step, ring and Ulysses none; step times; and the
     dropout kernels' slice form (a context rank's positions of GPT-2
     small's (4, 2048, 768) residual, ctx 2 and 4) bit-equal to the whole
     tensor's masks

Device times (phases 3, 5 and 14) carry a second reading of the same
launches, CUDA events on the stream around the profiled calls, printed as
"(events ...)" beside the profiler's.

The line before last is the kernels' JSON record, the last line
{"ok": true, "device": {...}}. Every number is printed beside the card's
name and power limit. Without a CUDA device it exits nonzero and prints no
result.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import gc
import json
import math
import os
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
# phase 9: the pod tier (one prefill pod and two decode pods for (a)/(b),
# traced, and three untraced for (c); each a worker process hosting one
# engine), POD_NEW new tokens a request; decode-0 is SIGKILLed once it holds
# POD_KILL_ROWS rows that have decoded POD_KILL_DECODED tokens each on it;
# a chain's wire-time sample count
POD_NEW, POD_KILL_ROWS, POD_KILL_DECODED, POD_CODEC_REPEATS = 64, 2, 8, 5
# bf16 logits: one ulp is 2^-8 of the largest |logit| (the limit of
# tests/test_torch_train.py: 8 ulps)
BF16_ULP, BF16_ULPS = 2.0 ** -8, 8
# the training path: bench.py's gpt2s_flash_2k shape; the graphed fit's
# chunk (TRAIN_STEPS = 3 chunks and a two-step tail), BERT's (phase 10), and
# how far a graphed fit's logged loss may sit from the eager fit's at the
# same step (the graph replays the eager steps' arithmetic, optimizer
# update included, so it reads 0)
TRAIN_BATCH, TRAIN_LEN, TRAIN_STEPS, TRAIN_WARMUP = 4, 2048, 20, 2
TRAIN_FUSED, FAM_BERT_FUSED, GRAPH_LOSS_RTOL = 6, 4, 2e-3
# the restart-warm check: two incarnations of a short graphed GPT-2 small
# fit (batch x length, steps, chunk) over one fresh compile_cache_dir
RESTART_BATCH, RESTART_LEN, RESTART_STEPS, RESTART_FUSED = 2, 256, 3, 2
# the encoder families' attention (phase 10's shapes), non-causal, for
# phases 3 and 5: (tag, B, L, padded) — BERT-base at bench.py's 16 x 128 and
# at 16 x 512 under the padding bias of synthetic_text_dataset's row lengths
# (L/2..L tokens), ViT-B/16 at 224² (197 tokens: a ragged last tile) under a
# zero bias
ENCODER_FORMS = (("bert", 16, 128, True), ("bert", 16, 512, True),
                 ("vit", 32, 197, False))
# phase 10: the BASELINE families at bench.py's shapes — ResNet-50 at batch
# 128 x 224² (FAM_RESNET_IMAGES distinct images, so the steps revisit them),
# BERT-base at 16 x 128 (and MLM), ViT-B/16 at batch 32 on ResNet's images,
# MNIST at 28x28x1
FAM_RESNET_BATCH, FAM_RESNET_STEPS, FAM_RESNET_IMAGES = 128, 10, 256
FAM_BERT_BATCH, FAM_BERT_LEN, FAM_BERT_STEPS, FAM_MLM_STEPS = 16, 128, 10, 3
FAM_VIT_BATCH, FAM_VIT_STEPS = 32, 5
FAM_MNIST_TRAIN, FAM_MNIST_TEST = 2048, 512
# phase 11: the server subprocess's one-row BERT requests, its batcher's
# size and wait, and a trained classifier's least top-1 agreement between
# its int8 and float artifacts (the JAX package's test's limit)
ART_REQUESTS, ART_MAX_BATCH, ART_BATCH_WAIT_MS, ART_TOP1 = 8, 8, 50.0, 0.95
# phase 12: the LLM lifecycle. A GPT-2 small checkpoint imported with a
# byte-level BPE whose merges are learned from LLM_CORPUS (LLM_MERGES of
# them); the imported model's logits on LLM_PROMPT-token prompts; LoRA
# (rank, alpha) fine-tuning at batch x length for LORA_STEPS steps with
# GPT-2's published dropout, eagerly and graphed (LORA_FUSED steps a
# chunk); the merged model served through the CLI's generate (LLM_NEW new
# tokens); TinyLlama-1.1B's widths cut to LLAMA_LAYERS of its 22 layers;
# BERT-base; the dropout kernels at the LoRA fit's residual shape and a
# ragged size
LLM_PROMPT, LLM_NEW, LLM_MERGES = 64, 32, 64
LORA_BATCH, LORA_LEN, LORA_STEPS, LORA_FUSED = 8, 1024, 12, 4
LORA_RANK, LORA_ALPHA, LORA_DROPOUT = 8, 16.0, 0.1
LLAMA_LAYERS, LLAMA_NEW, BERT_BATCH, BERT_LEN = 4, 16, 4, 128
# TinyLlama-1.1B's published widths (HF config.json) and BERT-base's
LLAMA_DIMS = dict(hidden=2048, heads=32, kv_heads=4, mlp=5632, vocab=32000,
                  rope_theta=10000.0, rms_eps=1e-5, positions=2048)
BERT_DIMS = dict(hidden=768, heads=12, layers=12, mlp=3072, vocab=30522,
                 positions=512)
DROPOUT_RAGGED = 1_000_003
LLM_CORPUS = (
    "the platform trains and serves models on one card; a model is a "
    "directory of weights and a configuration, and the server answers "
    "requests for it. training takes steps over batches of tokens, "
    "serving takes prompts and returns the tokens that follow them. "
    "low-rank adapters train a few weights and leave the rest frozen, "
    "so the optimizer holds state for the adapters alone.")
# the four flash kernels, which every earlier phase checks per dispatch
FLASH_KERNELS = ("flash_fwd", "flash_bwd_dd", "flash_bwd_dq",
                 "flash_bwd_dkv")
DROPOUT_KERNELS = ("dropout_fwd", "dropout_bwd")
# idle host time (s) on either side of a profiled window, doubled on each
# retry of a trace that lost activities (device_events)
PROFILE_PAD = 0.05
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
    Return the spill bytes by head_dim ({D: bytes}; phase 6 trains at D =
    64, phase 13 at 128), and each dtype's routes as the built libraries
    hold them: {dtype: {kernel: {route: instantiations}}}."""
    import re

    import torch

    from kubeflow_tpu_torch.kernels import flash_bwd as kb
    from kubeflow_tpu_torch.kernels import flash_fwd as kf
    from kubeflow_tpu_torch.kernels.build import report_path

    spills: dict = {}
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
            spills[d] = spills.get(d, 0) + st + ld
        if found != expected:
            raise AssertionError(f"ptxas reported {found} tensor-core "
                                 f"instantiations in {source}, expected "
                                 f"{expected}")
    for kernel, d, form, regs, st, ld, smem in sorted(rows):
        print(f"  {kernel:13s} bf16 D={d:3d} {form:5s}: {regs} registers, "
              f"{st} bytes spill stores, {ld} bytes spill loads, {smem} bytes "
              f"shared memory [{card}]")
    return spills, routes


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


def device_events(fn, iters: int, pad: float = PROFILE_PAD,
                  stamps: list | None = None) -> tuple[list, float]:
    """The device activities (kernels, copies, fills) of iters calls of
    fn(), after a warmup, from a torch.profiler trace: ([(name, start_us,
    duration_us)], host seconds of the traced calls to their last
    synchronize). CUPTI records every launch on the card, the ctypes
    wrappers' included. The trace's window holds `pad` seconds of idle host
    time before and after the calls: the profiler drops a device activity
    whose timestamp falls outside its window, and on the card's machine a
    short window has lost every activity, traces after traces (PERF.md
    §7). CUDA events recorded on the stream bracket the same calls: their
    ms per call is appended to ``stamps`` before a trace that holds
    nothing raises."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        time.sleep(pad)
        t0 = time.perf_counter()
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        time.sleep(pad)
    if stamps is not None:
        stamps.append(start.elapsed_time(end) / iters)
    events = [(e.name, e.time_range.start, e.time_range.elapsed_us())
              for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    if not events:
        raise AssertionError("torch.profiler recorded no device activity")
    return events, wall


class DeviceTime(float):
    """A call's device time from the profiler (``device_ms``), carrying a
    second reading of the same launches: ``events_ms``, CUDA events on the
    stream around the traced calls (the device's time from the first
    call's start to the last call's end, gaps between launches included).
    A call the profiler loses (NaN) still has that reading."""

    events_ms: float = math.nan


def device_ms(fn, iters: int, attempts: int = 6) -> DeviceTime:
    """Device time of one fn() call: for each activity name in a trace of
    iters calls, its mean duration times the times a call runs it
    (round(count / iters)), summed. A trace can lose an activity at its
    edge (19 of 20 on the card), which this rounding absorbs. A trace
    that holds nothing, or holds some activity in fewer than half of the
    calls (the card has lost most of one kernel's launches from a 10-call
    trace, which reads as 0), is retried with twice the window's padding,
    up to `attempts` times; then the largest reading stands. With none
    above 0 the device time is not measured (NaN, printed as such): the
    profiler's loss of every activity (PERF.md §7) says nothing of the
    kernel, whose loop time and agreement are checked apart. The result
    carries the CUDA events' reading of the same launches (``DeviceTime``:
    the last trace's)."""
    best, stamps = 0.0, []

    def reading(ms: float) -> DeviceTime:
        out = DeviceTime(ms)
        out.events_ms = stamps[-1] if stamps else math.nan
        return out

    for attempt in range(attempts):
        try:
            events, _ = device_events(fn, iters, PROFILE_PAD * 2 ** attempt,
                                      stamps)
        except AssertionError:
            continue
        by_name: dict = {}
        for name, _, dur in events:
            by_name.setdefault(name, []).append(dur)
        ms = sum(sum(d) / len(d) * round(len(d) / iters)
                 for d in by_name.values()) / 1e3
        if all(round(len(d) / iters) for d in by_name.values()):
            return reading(ms)
        best = max(best, ms)
    if best > 0:
        return reading(best)
    print(f"  device time not measured: torch.profiler recorded no device "
          f"time of the call in {attempts} traces; CUDA events read "
          f"{stamps[-1]:.5f} ms a call", flush=True)
    return reading(math.nan)


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
    """q, k, v ~ N(0, 1) and the additive bias: pad > 0 masks the last pad
    keys of the last row; pad == "rows" masks each row past a length drawn
    as synthetic_text_dataset draws it (L/2..L tokens)."""
    import torch

    q, k, v = (torch.randn((b, l, h, d), generator=gen, device="cuda")
               .to(dtype) for _ in range(3))
    bias = torch.zeros((b, 1, 1, l), device="cuda", dtype=dtype)
    if pad == "rows":
        lengths = np.random.RandomState(SEED + l).randint(l // 2, l + 1, b)
        for i, n in enumerate(lengths):
            bias[i, ..., int(n):] = -1e9
    elif pad:
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


def op_vs_wrapper(q, k, v, bias, causal, window, iters, wrapper) -> dict:
    """The loop time a call of the ctypes wrapper, of the custom op
    kftpu::flash_fwd that wraps it (one dispatcher hop more) and of
    ring_attention.flash_forward (the op behind the models' checks), each
    the mean of two reads taken in turns."""
    import torch

    from kubeflow_tpu_torch.parallel.ring_attention import flash_forward

    op = functools.partial(torch.ops.kftpu.flash_fwd, q, k, v, bias, causal,
                           window, 128)
    forward = functools.partial(flash_forward, q, k, v, bias, causal=causal,
                                window=window)
    reads = [time_ms(f, iters) for f in (wrapper, op, forward, forward, op,
                                         wrapper)]
    return {"wrapper_ms": (reads[0] + reads[5]) / 2,
            "op_ms": (reads[1] + reads[4]) / 2,
            "forward_ms": (reads[2] + reads[3]) / 2}


def phase_kernels(peaks, card: str, routes: dict) -> dict:
    """Kernel vs plain version on the card. Returns the record of the
    training path's shape (bf16). `routes` is tensor_core_report's."""
    import torch

    from kubeflow_tpu_torch.kernels.flash_fwd import flash_fwd
    from kubeflow_tpu_torch.parallel.ring_attention import flash_forward_plain

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    tol = {"float32": 1e-4, "bfloat16": 2e-2}
    cases = [  # (tag, B, L, window, dtype, pad, causal): main paths first
        ("prefill", GEN_BATCH, GEN_PROMPT, 0, "float32", 0, True),
        ("logits", LOGITS_BATCH, LOGITS_LEN, 0, "float32", LOGITS_PAD, True),
        ("train", TRAIN_BATCH, TRAIN_LEN, 0, "bfloat16", 0, True),
        ("train", TRAIN_BATCH, TRAIN_LEN, 0, "float32", 0, True),
    ]
    for l in (17, 128, 1024):
        for window in (0, 100):
            for dt in ("float32", "bfloat16"):
                cases.append(("sweep", 2, l, window, dt,
                              max(1, min(16, l // 8)), True))
    for tag, b, l, padded in ENCODER_FORMS:  # phase 10's, non-causal
        for dt in ("bfloat16", "float32"):
            cases.append((tag, b, l, 0, dt, "rows" if padded else 0, False))
    h, d = 12, 64
    print("phase 3: flash_fwd kernel vs plain version (B, L, H=12, D=64, "
          "causal, pad bias on the last keys of the last row; the encoder "
          "forms bert/vit non-causal, bert's rows padded past lengths of "
          "L/2..L, vit's bias zero; max-abs "
          "tolerance f32 1e-4, bf16 2e-2; per block of one batch row, head "
          f"and 64 positions ||got - ref|| within {TILE_TOL['float32']:g} "
          f"(f32) or {TILE_TOL['bfloat16']:g} (bf16) of ||ref||; times: the "
          "loop's ms per call by CUDA events, dev the device time per call "
          "from a torch.profiler trace)", flush=True)
    for dt in ("bfloat16", "float32"):
        print(f"  route {dt} (the built library's instantiations): "
              + route_line(routes, dt, ["flash_fwd"]), flush=True)
    records = {}
    for tag, b, l, window, dt, pad, causal in cases:
        dtype = getattr(torch, dt)
        q, k, v, bias = make_attention_inputs(b, l, h, d, dtype, pad, gen)
        o_k, lse_k = flash_fwd(q, k, v, bias, causal, window)
        o_p, lse_p = flash_forward_plain(q, k, v, bias, 128, causal, window)
        torch.cuda.synchronize()
        err_o = (o_k.float() - o_p.float()).abs().max().item()
        err_l = (lse_k - lse_p).abs().max().item()
        tile = tile_error(o_k.transpose(1, 2), o_p.transpose(1, 2))
        typical = o_p.float().abs().median().item()
        same = None
        if tag == "train":  # no atomics: a second call agrees bit for bit
            o_2, lse_2 = flash_fwd(q, k, v, bias, causal, window)
            same = torch.equal(o_k, o_2) and torch.equal(lse_k, lse_2)
        ok = (math.isfinite(err_o) and err_o <= tol[dt] and err_l <= tol[dt]
              and tile <= TILE_TOL[dt] and same is not False)
        iters = 20 if l >= 1024 else 50
        kernel = functools.partial(flash_fwd, q, k, v, bias, causal, window)
        plain = functools.partial(flash_forward_plain, q, k, v, bias, 128,
                                  causal, window)
        ms, dev = time_ms(kernel, iters), device_ms(kernel, iters)
        plain_ms = time_ms(plain, iters)
        lib = lib_dev = lib_c = lib_c_dev = None
        if tag != "logits" and (tag != "sweep" or l == 1024):
            call = sdpa_call(q, k, v, bias, causal, window)
            lib, lib_dev = time_ms(call, iters), device_ms(call, iters)
        if pad == 0 and window == 0 and causal:
            call = sdpa_causal_call(q, k, v)
            lib_c, lib_c_dev = time_ms(call, iters), device_ms(call, iters)
        op = None
        if dt == "bfloat16" and (tag == "train" or (tag, l) == ("bert", 128)):
            op = op_vs_wrapper(q, k, v, bias, causal, window, iters, kernel)
            print(f"  {tag:8s} B={b} L={l:5d} loop ms a call, taken in "
                  f"turns (wrapper, op, op, wrapper): the ctypes wrapper "
                  f"{op['wrapper_ms']:.5f}, the custom op "
                  f"torch.ops.kftpu.flash_fwd {op['op_ms']:.5f}, "
                  f"ring_attention.flash_forward (the models' call) "
                  f"{op['forward_ms']:.5f}; device {dev:.5f} [{card}]",
                  flush=True)
        bound_ms, bound_by = attention_bound(b, h, l, l, d, dt, causal,
                                             window, peaks)
        lib_s, lib_dev_s, causal_s, causal_dev_s = (
            "-" if x is None else f"{x:.5f}"
            for x in (lib, lib_dev, lib_c, lib_c_dev))
        form = "causal" if causal else "non-causal"
        print(f"  {tag:8s} B={b} L={l:5d} {form} window={window:3d} {dt:9s} "
              f"err_o={err_o:.3e} err_lse={err_l:.3e} (tol {tol[dt]:g}) "
              f"kernel_ms={ms:.5f} dev={dev:.5f} (events "
              f"{dev.events_ms:.5f}) plain_ms={plain_ms:.5f} "
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
                f"L={l} {form} window={window} {dt}: O {err_o}, lse {err_l}, "
                f"worst block {tile}, bit-equal over two calls {same}")
        records[(tag, l, window, dt)] = {
            **(op or {}),
            "max_abs_err": err_o, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": lib,
            "device_ms": dev, "library_device_ms": lib_dev,
            "library_causal_ms": lib_c, "library_causal_device_ms":
                lib_c_dev,
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
          "D=64, causal, pad bias on the last keys of the last row; the "
          "encoder forms non-causal without dbias, as phase 3's; "
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
    # (B, L, dtype, window, pad, causal, dbias): the decoder's causal forms
    # with the bias gradient, then phase 10's encoder forms, non-causal and
    # without it (their bias comes from the mask and takes no gradient)
    cases = [(b, l, dt, window, 16, True, True)
             for b, l in ((2, 1024), (TRAIN_BATCH, TRAIN_LEN))
             for dt in ("float32", "bfloat16") for window in (0, 100)]
    cases += [(b, l, dt, 0, "rows" if padded else 0, False, False)
              for _, b, l, padded in ENCODER_FORMS
              for dt in ("bfloat16", "float32")]
    for b, l, dt, window, pad, causal, want_dbias in cases:
        dtype = getattr(torch, dt)
        q, k, v, bias = make_attention_inputs(b, l, h, d, dtype,
                                              pad, gen)
        g = torch.randn((b, l, h, d), generator=gen,
                        device="cuda").to(dtype)
        o, lse = flash_fwd(q, k, v, bias, causal, window)
        want = flash_backward_plain(q, k, v, bias, o, lse, g, 128,
                                    causal, window, want_dbias)
        dd = kb.flash_bwd_dd(o, g)
        runs = {"ddpre": dd, "loop2": None}
        errs = {"flash_bwd_dd": (dd - (g.float() * o.float()).sum(
            -1).transpose(1, 2)).abs().max().item()}
        scales = {"flash_bwd_dd": 1.0}
        tiles = {}  # key: (worst block error, output, median |ref|)
        for form, dd_in in runs.items():
            dq = kb.flash_bwd_dq(q, k, v, bias, o, g, lse, dd_in,
                                 causal, window)
            dk, dv, dbh = kb.flash_bwd_dkv(q, k, v, bias, o, g, lse,
                                           dd_in, causal, window,
                                           want_dbias)
            dbias = (dbh.view(b, h, l).sum(1)[:, None, None]
                     if want_dbias else None)
            if l == TRAIN_LEN:  # no atomics: a second call agrees
                again = (kb.flash_bwd_dq(q, k, v, bias, o, g, lse,
                                         dd_in, causal, window),
                         *kb.flash_bwd_dkv(q, k, v, bias, o, g, lse,
                                           dd_in, causal, window))
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
                if ref is None:  # no bias gradient asked for
                    continue
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
                causal, window)
            calls[f"flash_bwd_dkv/{form}"] = functools.partial(
                kb.flash_bwd_dkv, q, k, v, bias, o, g, lse, dd_in,
                causal, window, False)
        times = {n: time_ms(f, iters) for n, f in calls.items()}
        devs = {n: device_ms(f, iters) for n, f in calls.items()}
        t_dd = times["flash_bwd_dd"]
        plain_dd = time_ms(
            lambda: torch.einsum("blhd,blhd->bhl", g.float(),
                                 o.float()), iters)
        plain_ms = time_ms(
            lambda: flash_backward_plain(q, k, v, bias, o, lse, g,
                                         128, causal, window, False),
            max(3, iters // 4))
        def lib_dd_call():
            return (g * o).sum(-1)

        lib_dd = time_ms(lib_dd_call, iters)
        lib_dd_dev = device_ms(lib_dd_call, iters)
        fwd_bwd, fwd_only = sdpa_backward_call(q, k, v, bias, g,
                                               causal, window)
        lib_bwd = time_ms(fwd_bwd, iters) - time_ms(fwd_only, iters)
        lib_bwd_dev = (device_ms(fwd_bwd, iters)
                       - device_ms(fwd_only, iters))
        for form, from_o in (("ddpre", False), ("loop2", True)):
            bounds = backward_bounds(b, h, l, l, d, dt, causal,
                                     window, peaks, from_o, False)
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
                print(f"  {key:20s} B={b} L={l:5d} "
                      f"{'causal' if causal else 'non-causal'} "
                      f"window={window:3d}"
                      f" {dt:9s} err={errs[key]:.3e} (scale "
                      f"{scales[key]:.3g}) ms={times[key]:.5f} "
                      f"dev={devs[key]:.5f} (events "
                      f"{devs[key].events_ms:.5f}) bound_ms={bound_ms:.5f} "
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
        print(f"  B={b} L={l} {'causal' if causal else 'non-causal'} "
              f"window={window} {dt}: dq+dkv "
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
                f"at B={b} L={l} causal={causal} window={window} "
                f"{dt}: {bad}")
    forms = kb.FLASH_BWD_DD.forms
    print(f"  flash_bwd_dd launches by form over phase 5: {forms} "
          f"(contiguous inputs: the 16-byte-load form) [{card}]", flush=True)
    if set(forms) != {"vector"}:
        raise AssertionError(f"flash_bwd_dd ran other than its 16-byte-load "
                             f"form on contiguous inputs: {forms}")
    return {name: records[(name, "ddpre", TRAIN_BATCH, TRAIN_LEN,
                           "bfloat16", 0)]
            for name in ("flash_bwd_dd", "flash_bwd_dq", "flash_bwd_dkv")}


def gpt_trainer(cfg, seed: int, model=None, **kw):
    """GPT-2 small at cfg with seeded weights (or ``model``), and the
    Trainer of phase 6's config (kw overrides it)."""
    import torch

    from kubeflow_tpu_torch.models.gpt import (
        GPTLM,
        causal_lm_eval_metrics,
        causal_lm_loss,
    )
    from kubeflow_tpu_torch.train.trainer import Trainer, TrainerConfig

    if model is None:
        model = GPTLM(cfg, device="cuda").init_weights(
            torch.Generator().manual_seed(seed))
    config = {"batch_size": TRAIN_BATCH, "steps": TRAIN_STEPS,
              "learning_rate": 3e-4, "warmup_steps": TRAIN_WARMUP,
              "log_every_steps": 1, "seed": SEED, **kw}
    return Trainer(model, TrainerConfig(**config), loss_fn=causal_lm_loss,
                   eval_metrics_fn=causal_lm_eval_metrics)


def share(x: float) -> str:
    """An idle share for printing; a NaN one was not measured."""
    return "not measured" if math.isnan(x) else f"{100 * x:.1f}%"


def check_logged_against(graphed: dict, eager: dict, what: str,
                         card: str) -> None:
    """Every loss the graphed fit logged (at chunk ends and tail steps)
    within GRAPH_LOSS_RTOL of the eager fit's at the same step."""
    worst = max((abs(loss - eager["logged"][step])
                 / abs(eager["logged"][step]), step)
                for step, loss in graphed["logged"].items())
    print(f"  {what}: graphed losses at steps {sorted(graphed['logged'])} "
          f"vs eager: worst relative difference {worst[0]:.3e} at step "
          f"{worst[1]} (limit {GRAPH_LOSS_RTOL}) [{card}]", flush=True)
    if worst[0] > GRAPH_LOSS_RTOL or len(graphed["logged"]) < 3:
        raise AssertionError(f"{what}: graphed losses {graphed['logged']} "
                             f"vs eager {eager['logged']}")


def max_param_diff(model, want: dict) -> str:
    """The largest difference of the model's parameters from ``want`` and
    how many elements differ at all."""
    sd = model.state_dict()
    worst = max(((v - want[k]).abs().max().item(), k) for k, v in sd.items())
    n = sum(int((v != want[k]).sum()) for k, v in sd.items())
    total = sum(v.numel() for v in sd.values())
    return f"{worst[0]:.3e} ({worst[1]}), {n} of {total} elements differ"


def phase_train(card: str) -> tuple[dict, float]:
    """GPT-2 small trained by the port's Trainer.fit on the card, eagerly
    and then graphed (fused_steps=TRAIN_FUSED: each chunk one CUDA graph
    replay) from the same weights; a checkpoint round trip, the checkpoint
    crossing between graphed and eager fits both ways, one graphed chunk
    under profile_dir, and the f32 grad check. Returns each kernel's
    launches over the two fits and the eager median step time (ms)."""
    import torch

    from kubeflow_tpu_torch.kernels import KERNELS
    from kubeflow_tpu_torch.models.gpt import GPTConfig
    from kubeflow_tpu_torch.train.checkpoint import Checkpointer
    from kubeflow_tpu_torch.train.data import synthetic_lm_dataset

    cfg = GPTConfig.small(attention="flash", dropout_rate=0.0,
                          max_len=TRAIN_LEN)
    t0 = time.perf_counter()
    ds = synthetic_lm_dataset(n_train=TRAIN_BATCH * TRAIN_STEPS,
                              n_test=TRAIN_BATCH, seq_len=TRAIN_LEN,
                              vocab_size=cfg.vocab_size, seed=SEED)
    trainer = gpt_trainer(cfg, SEED)
    model = trainer.model
    init = {k: v.clone() for k, v in model.state_dict().items()}
    n_params = sum(p.numel() for p in model.parameters())
    print(f"phase 6: GPT-2 small, {n_params} params "
          f"({sorted({str(p.dtype) for p in model.parameters()})}), compute "
          f"{trainer.compute_dtype}, batch {TRAIN_BATCH} x {TRAIN_LEN} "
          f"tokens, {TRAIN_STEPS} steps, set up in "
          f"{time.perf_counter() - t0:.2f}s [{card}]", flush=True)
    if trainer.compute_dtype != torch.bfloat16:
        raise AssertionError(f"AUTO resolved to {trainer.compute_dtype}")

    # the peak is the fit's: what earlier phases left for the collector
    # (phase 4's models) goes first
    held = torch.cuda.memory_allocated() / 2**30
    gc.collect()
    print(f"  device memory allocated before the fit: {held:.2f} GiB, "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB after "
          f"gc.collect() [{card}]", flush=True)
    torch.cuda.reset_peak_memory_stats()
    eager = fit_timed(trainer, ds)  # the training path's run starts here
    state = eager["state"]
    peak = torch.cuda.max_memory_allocated() / 2**30
    launches = dict(eager["launches"])
    losses = eager["losses"]
    step_ms = eager["step_ms"]
    first_ms = (eager["dispatches"][0]["end"] - eager["start"]) * 1e3
    print(f"  eager fit: {eager['wall']:.2f}s; losses "
          f"{' '.join(f'{x:.4f}' for x in losses)}; final eval loss "
          f"{eager['final']['final_loss']:.4f} [{card}]", flush=True)
    print(f"  eager step time {step_ms:.2f} ms (median of steps "
          f"4..{TRAIN_STEPS}); {TRAIN_BATCH * TRAIN_LEN / step_ms * 1e3:.1f} "
          f"tokens/s; first step {first_ms:.1f} ms; peak memory "
          f"{peak:.2f} GiB; launches {launches}; "
          f"flash_bwd_dd by form "
          f"{dict(KERNELS['flash_bwd_dd'].forms)} [{card}]", flush=True)
    n_eval = 2 * cfg.num_layers   # the epoch's eval and the final eval
    want = {"flash_fwd": cfg.num_layers * TRAIN_STEPS + n_eval,
            **{n: cfg.num_layers * TRAIN_STEPS
               for n in ("flash_bwd_dd", "flash_bwd_dq", "flash_bwd_dkv")}}
    if launches != want:
        raise AssertionError(f"launches {launches}, expected {want}")
    check_flash_steps(eager, cfg.num_layers, "GPT-2 small, eager")
    if len(losses) != TRAIN_STEPS or not all(map(math.isfinite, losses)) \
            or not losses[-1] < losses[0]:
        raise AssertionError(f"training did not run clean: losses {losses}")

    # ---- checkpoint round trip on the card
    saved = {k: v.clone() for k, v in state.model.state_dict().items()}
    with tempfile.TemporaryDirectory() as tmp:
        Checkpointer(tmp).save(state.step, state)
        fresh = gpt_trainer(cfg, SEED + 7)
        step, restored = Checkpointer(tmp).restore_latest(fresh.init_state())
    same = all(torch.equal(v, saved[k])
               for k, v in restored.model.state_dict().items())
    print(f"  checkpoint round trip: step {step}, params bit-equal {same} "
          f"[{card}]", flush=True)
    if step != TRAIN_STEPS or not same:
        raise AssertionError("checkpoint round trip changed the params")
    batch = tuple(torch.as_tensor(a[:TRAIN_BATCH], device="cuda")
                  for a in (ds.x_train, ds.y_train))
    eager_idle = profile_step(lambda: trainer.train_step(state, batch),
                              step_ms, card)
    del state, restored, fresh, trainer, model, eager["state"]
    torch.cuda.empty_cache()

    # ---- the same fit graphed, from the same weights
    gtrainer = gpt_trainer(cfg, SEED, fused_steps=TRAIN_FUSED)
    gtrainer.model.load_state_dict(init)
    torch.cuda.reset_peak_memory_stats()
    graphed = fit_timed(gtrainer, ds)
    gpeak = torch.cuda.max_memory_allocated() / 2**30
    gstate = graphed["state"]
    warm = gtrainer.graph_warmups
    gwant = {"flash_fwd": cfg.num_layers * (TRAIN_STEPS + warm) + n_eval,
             **{n: cfg.num_layers * (TRAIN_STEPS + warm)
                for n in ("flash_bwd_dd", "flash_bwd_dq", "flash_bwd_dkv")}}
    print(f"  graphed fit (fused_steps={TRAIN_FUSED}): {graphed['wall']:.2f}"
          f"s; dispatches of "
          f"{[d['steps'] for d in graphed['dispatches']]} steps, the first "
          f"after {warm} warm-up step(s) and the capture; launches "
          f"{graphed['launches']} (expected {gwant}) [{card}]", flush=True)
    if graphed["launches"] != gwant:
        raise AssertionError(f"graphed launches {graphed['launches']}, "
                             f"expected {gwant}")
    check_flash_steps(graphed, cfg.num_layers, "GPT-2 small, graphed")
    check_logged_against(graphed, eager, "GPT-2 small", card)
    diff = max_param_diff(gstate.model, saved)
    k = TRAIN_FUSED
    stacked = tuple(np.stack([a[i * TRAIN_BATCH:(i + 1) * TRAIN_BATCH]
                              for i in range(k)])
                    for a in (ds.x_train, ds.y_train))
    graphed_idle = profile_step(
        lambda: gtrainer.train_chunk(gstate, stacked, k),
        graphed["chunk_ms"], card, what=f"chunk of {k} steps")
    gms = graphed["chunk_ms"]
    print(f"  graphed vs eager, GPT-2 small at {TRAIN_BATCH} x {TRAIN_LEN}: "
          f"step {gms:.2f} vs {step_ms:.2f} ms (graphed: a chunk's time over "
          f"its {k} steps, chunks 2..; eager: median of steps 4..), "
          f"{TRAIN_BATCH * TRAIN_LEN / gms * 1e3:.1f} vs "
          f"{TRAIN_BATCH * TRAIN_LEN / step_ms * 1e3:.1f} tokens/s, peak "
          f"memory {gpeak:.2f} vs {peak:.2f} GiB, idle share of a profiled "
          f"chunk {share(graphed_idle)} vs a profiled step "
          f"{share(eager_idle)}; largest final parameter difference "
          f"{diff} [{card}]", flush=True)
    for name, n in graphed["launches"].items():
        launches[name] += n

    phase_crossing(cfg, ds, gtrainer, gstate, card)
    del gstate, gtrainer, graphed
    gc.collect()
    torch.cuda.empty_cache()
    phase_profile_chunk(cfg, ds, card)
    phase_grad_check(cfg, ds, card)
    return launches, step_ms


def phase_crossing(cfg, ds, gtrainer, gstate, card: str) -> None:
    """A graphed fit's checkpoint restores into an eager trainer, and the
    eager one's into a fresh graphed trainer. Across each crossing the next
    two steps' losses are the same on both sides, bit for bit (the same
    parameters, Adam moments and counts, batch and kernels); the graphed
    side then captures and replays a chunk over the restored state."""
    import torch

    from kubeflow_tpu_torch.train.checkpoint import Checkpointer

    b = TRAIN_BATCH
    two = [tuple(torch.as_tensor(a[i * b:(i + 1) * b], device="cuda")
                 for a in (ds.x_train, ds.y_train)) for i in (3, 4)]

    def next_two(tr_a, st_a, tr_b, st_b):
        got = []
        for batch in two:
            st_a, ma = tr_a.train_step(st_a, batch)
            st_b, mb = tr_b.train_step(st_b, batch)
            got.append((float(ma["loss"]), float(mb["loss"])))
        return st_a, st_b, got

    with tempfile.TemporaryDirectory() as tmp:
        Checkpointer(f"{tmp}/graphed").save(gstate.step, gstate)
        eager = gpt_trainer(cfg, SEED + 11)
        step_e, est = Checkpointer(f"{tmp}/graphed").restore_latest(
            eager.init_state())
        gstate, est, there = next_two(gtrainer, gstate, eager, est)
        Checkpointer(f"{tmp}/eager").save(est.step, est)
        graphed = gpt_trainer(cfg, SEED + 12, fused_steps=TRAIN_FUSED)
        step_g, gst2 = Checkpointer(f"{tmp}/eager").restore_latest(
            graphed.init_state())
        est, gst2, back = next_two(eager, est, graphed, gst2)
    k = TRAIN_FUSED
    stacked = tuple(np.stack([a[i * b:(i + 1) * b] for i in range(k)])
                    for a in (ds.x_train, ds.y_train))
    gst2, m = graphed.train_chunk(gst2, stacked, k)
    chunk_loss = float(m["loss"])
    print(f"  checkpoint crossing: graphed step {step_e} -> eager, next two "
          f"losses (graphed, eager) {there}; eager step {step_g} -> graphed, "
          f"next two (eager, graphed) {back}, then a chunk of {k} captured "
          f"and replayed over the restored state, last loss "
          f"{chunk_loss:.4f} [{card}]", flush=True)
    if any(a != b for a, b in there + back):
        raise AssertionError(f"checkpoint crossing: {there} {back}")
    if not math.isfinite(chunk_loss) or gst2.step != step_g + 2 + k:
        raise AssertionError(f"graphed after crossing: {chunk_loss}, step "
                             f"{gst2.step}")


def trace_kernel_counts(events: list) -> dict:
    """Launches of each hand-written kernel in a Chrome trace's events."""
    import re

    out = {n: 0 for n in ("flash_fwd", "flash_bwd_dd", "flash_bwd_dq",
                          "flash_bwd_dkv")}
    for e in events:
        if e.get("cat") != "kernel":
            continue
        m = re.search(r"(flash_fwd|flash_bwd_dd|flash_bwd_dq|flash_bwd_dkv)"
                      r"(?:_vec|_tc)?_kernel", e.get("name", ""))
        if m and "pytorch_flash" not in e["name"]:
            out[m.group(1)] += 1
    return out


def phase_profile_chunk(cfg, ds, card: str) -> None:
    """One graphed chunk of GPT-2 small under TrainerConfig.profile_dir (a
    fit of TRAIN_FUSED steps: the warm-up step, the capture, one replay and
    the evals): each flash kernel's launches in the written Chrome trace
    against the counters, and how many the trace lost, split into the
    eager launches and the graph's."""
    import contextlib
    import glob
    import io

    with tempfile.TemporaryDirectory() as tmp:
        trainer = gpt_trainer(cfg, SEED, steps=TRAIN_FUSED,
                              fused_steps=TRAIN_FUSED, profile_dir=tmp)
        log = io.StringIO()
        zero_launches()
        with contextlib.redirect_stdout(log):
            trainer.fit(ds)
        counted = _launch_counts()
        (path,) = glob.glob(f"{tmp}/*.pt.trace.json")
        size = os.path.getsize(path)
        with open(path) as fh:
            events = json.load(fh)["traceEvents"]
    if "profile_trace_written=1" not in log.getvalue():
        raise AssertionError("the fit wrote no profile_trace_written line")
    in_trace = trace_kernel_counts(events)
    # a graph's kernels share the correlation id of its cudaGraphLaunch
    replays = {(e.get("args") or {}).get("correlation") for e in events
               if e.get("name") == "cudaGraphLaunch"}
    graph_kernels = [e for e in events if e.get("cat") == "kernel"
                     and (e.get("args") or {}).get("correlation") in replays]
    in_graph = trace_kernel_counts(graph_kernels)
    n_layers, steps = cfg.num_layers, TRAIN_FUSED
    replayed = {n: n_layers * steps for n in in_trace}
    print(f"  profile_dir: one graphed chunk of {steps} steps (fit with "
          f"{trainer.graph_warmups} warm-up step, capture, replay, evals), "
          f"trace {size / 2**20:.1f} MiB, {len(events)} events, "
          f"{sum(1 for e in events if e.get('cat') == 'kernel')} kernel "
          f"records ({len(graph_kernels)} from {len(replays - {None})} "
          f"graph replay(s)) [{card}]", flush=True)
    for n in in_trace:
        print(f"    {n}: counted {counted[n]} (of them {replayed[n]} in the "
              f"graph replay), in the trace {in_trace[n]} (from the graph "
              f"{in_graph[n]}), lost {counted[n] - in_trace[n]} [{card}]",
              flush=True)
    over = {n: c for n, c in in_trace.items() if c > counted[n]}
    if over:
        raise AssertionError(f"the trace holds more launches than were "
                             f"counted: {over} vs {counted}")


def restart_child(cache_dir: str) -> None:
    """One incarnation of the restart-warm check, run in its own process by
    phase_restart_warm: a short graphed GPT-2 small fit with
    compile_cache_dir, traced. Its last line: the train.compile span's
    attributes, the process's nvcc runs and library loads, the logged
    losses."""
    import contextlib
    import io

    import torch

    from kubeflow_tpu_torch.models.gpt import GPTConfig
    from kubeflow_tpu_torch.tracing.core import Tracer, set_tracer
    from kubeflow_tpu_torch.train import metrics
    from kubeflow_tpu_torch.train.data import synthetic_lm_dataset
    from kubeflow_tpu_torch.utils.compile_cache import compile_counts

    torch.backends.cuda.matmul.allow_tf32 = False
    tracer = set_tracer(Tracer())
    cfg = GPTConfig.small(attention="flash", dropout_rate=0.0,
                          max_len=RESTART_LEN)
    ds = synthetic_lm_dataset(n_train=RESTART_BATCH * RESTART_STEPS,
                              n_test=RESTART_BATCH, seq_len=RESTART_LEN,
                              vocab_size=cfg.vocab_size, seed=SEED)
    trainer = gpt_trainer(cfg, SEED, batch_size=RESTART_BATCH,
                          steps=RESTART_STEPS, fused_steps=RESTART_FUSED,
                          compile_cache_dir=cache_dir)
    log = io.StringIO()
    with contextlib.redirect_stdout(log):
        trainer.fit(ds)
    (span,) = [sp for sp in tracer.snapshot()
               if sp["name"] == "train.compile"]
    lines = [metrics.parse_line(x) for x in log.getvalue().splitlines()]
    print(json.dumps({"compile": span["attrs"], "counts": compile_counts(),
                      "logged": [[x["step"], x["loss"]] for x in lines
                                 if "loss" in x]}))


def phase_restart_warm(card: str) -> None:
    """Two incarnations (fresh processes) of a short graphed GPT-2 small fit
    over one fresh compile_cache_dir: the first builds every kernel library
    into it (its train.compile span says so), the second runs nvcc zero
    times, loads the libraries from it and captures its graph; both log the
    same losses."""
    from kubeflow_tpu_torch.kernels.build import sources

    here = os.path.dirname(os.path.abspath(__file__))
    runs = []
    with tempfile.TemporaryDirectory() as cache:
        for _ in range(2):
            t0 = time.perf_counter()
            proc = subprocess.run(
                [sys.executable, "-c",
                 f"import chip_smoke as c; c.restart_child({cache!r})"],
                cwd=here, capture_output=True, text=True, timeout=900)
            if proc.returncode != 0:
                raise AssertionError(
                    f"restart-warm incarnation failed: {proc.stderr[-3000:]}")
            runs.append((json.loads(proc.stdout.strip().splitlines()[-1]),
                         time.perf_counter() - t0))
    n_src = len(sources())
    for i, (run, wall) in enumerate(runs):
        c = run["compile"]
        print(f"  restart-warm incarnation {i + 1}: train.compile builds "
              f"{c['builds']}, loaded {c['loaded']!r}, graph "
              f"{c.get('graph')!r}, {c['seconds']:.2f}s; the process ran "
              f"nvcc {run['counts']['nvcc_runs_total']} times and loaded "
              f"{run['counts']['libraries_loaded_total']} libraries; logged "
              f"{run['logged']}; {wall:.1f}s with the interpreter [{card}]",
              flush=True)
    (first, _), (second, _) = runs
    if (first["compile"]["builds"] != n_src
            or second["compile"]["builds"] != 0
            or second["counts"]["nvcc_runs_total"] != 0
            or second["counts"]["libraries_loaded_total"] != n_src
            or first["compile"].get("graph") != f"train_chunk_"
            f"{RESTART_FUSED}" or second["compile"].get("graph")
            != first["compile"]["graph"]
            or first["logged"] != second["logged"]):
        raise AssertionError(f"restart-warm: {runs}")


def profile_step(step, step_ms: float, card: str, what: str = "step") -> float:
    """One training step (or chunk: ``what``) under torch.profiler (device
    activity only): the ten device ops that take the most time, each
    hand-written kernel's device time per launch, and the device's idle
    share of the step, which it returns."""
    import re

    events = None
    for attempt in range(4):
        try:
            events, wall = device_events(step, 1, 4 * PROFILE_PAD * 2 ** attempt)
            break
        except AssertionError:
            continue
    if events is None:
        print(f"  profiled {what}: not measured (four traces held no device "
              f"activity) [{card}]", flush=True)
        return float("nan")
    by_name: dict = {}
    for name, _, dur in events:
        total, n = by_name.get(name, (0.0, 0))
        by_name[name] = (total + dur, n + 1)
    busy = busy_us(events)
    idle = 1 - busy / (wall * 1e6)
    print(f"  profiled {what}: {wall * 1e3:.2f} ms host wall (unprofiled "
          f"median {step_ms:.2f} ms a step), device busy {busy / 1e3:.2f} "
          f"ms, idle share {100 * idle:.1f}%, {len(events)} device "
          f"activities [{card}]", flush=True)
    print(f"  top ten device ops of the {what} (ms, launches, share of the "
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
    print(f"  hand-written kernels in the {what}: " + ", ".join(
        f"{k} {t / c / 1e3:.5f} ms x {c} = {t / 1e3:.3f} ms "
        f"({100 * t / busy:.1f}% of busy)" for k, (t, c) in sorted(
            ours.items())) + f" [{card}]", flush=True)
    return idle


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


# ------------------------------------------------------------- phase 10


def fit_timed(trainer, ds, names=FLASH_KERNELS) -> dict:
    """trainer.fit(ds) with each dispatch (a step, or a chunk of fused
    steps: one CUDA graph replay) synchronised and timed, and its kernel
    launches and the warm-up steps it took before a capture recorded.
    Returns the state, the final metrics, the logged losses (in order and
    by step), the median step time (ms) of steps 4..N one by one, the step
    time of the chunks (a chunk's time over its steps, from the second
    chunk on; None without chunks), per dispatch its steps, launches and
    warm-up steps, the launches of the whole fit (evals included), and the
    wall. Launches are of the ``names`` kernels (``_launch_counts``)."""
    import contextlib
    import io

    import torch

    from kubeflow_tpu_torch.train import metrics

    dispatches = []
    real = {"train_step": trainer.train_step,
            "train_chunk": trainer.train_chunk}

    def timed(fn):
        def call(state, batch, *k):
            before, warm = _launch_counts(names), trainer.graph_warmups
            out = fn(state, batch, *k)
            torch.cuda.synchronize()
            after = _launch_counts(names)
            dispatches.append({
                "steps": k[0] if k else 1, "end": time.perf_counter(),
                "launches": {n: after[n] - before[n] for n in after},
                "warmup": trainer.graph_warmups - warm})
            return out
        return call

    for name, fn in real.items():
        setattr(trainer, name, timed(fn))
    log = io.StringIO()
    zero_launches()  # this path's run starts here
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(log):
            state, final = trainer.fit(ds)
        torch.cuda.synchronize()
    finally:
        for name, fn in real.items():
            setattr(trainer, name, fn)
    wall = time.perf_counter() - t0
    lines = [metrics.parse_line(x) for x in log.getvalue().splitlines()]
    ends = [d["end"] for d in dispatches]
    singles = [b - a for a, b, d in zip(ends, ends[1:], dispatches[1:])
               if d["steps"] == 1]
    chunks = [(b - a) / d["steps"]
              for a, b, d in zip(ends, ends[1:], dispatches[1:])
              if d["steps"] > 1]
    steady = singles[2:] if len(singles) > 3 else singles
    return {"state": state, "final": final,
            "losses": [x["loss"] for x in lines if "loss" in x],
            "logged": {int(x["step"]): x["loss"] for x in lines
                       if "loss" in x},
            "step_ms": float(np.median(steady)) * 1e3 if steady else None,
            "chunk_ms": float(np.median(chunks)) * 1e3 if chunks else None,
            "per_step": [d["launches"] for d in dispatches],
            "dispatches": dispatches, "start": t0, "wall": wall,
            "launches": _launch_counts(names)}


def check_flash_steps(run: dict, n_layers: int, what: str) -> None:
    """Every dispatch launched each flash kernel once per layer for each
    step it ran, warm-up steps before a capture included (D pre-kernel
    included: the default backward computes D first). A graph replay's
    launches are the ones its capture recorded, added by the trainer."""
    bad = []
    for i, d in enumerate(run["dispatches"]):
        n = n_layers * (d["steps"] + d["warmup"])
        want = {name: n for name in FLASH_KERNELS}
        if {name: d["launches"][name] for name in FLASH_KERNELS} != want:
            bad.append((i, d["launches"], want))
    if bad:
        raise AssertionError(f"{what}: dispatches {[b[0] for b in bad]} "
                             f"launched {bad[0][1]}, expected {bad[0][2]}")


def served_logits(srv, name: str, x: np.ndarray) -> tuple[np.ndarray, float]:
    code, body, wall = post(f"{srv.url}/v1/models/{name}:predict",
                            {"instances": x.tolist()})
    if code != 200:
        raise AssertionError(f"{name} request failed: {code} {body}")
    got = np.asarray(body["logits"], dtype=np.float32)
    if not np.isfinite(got).all() or body["predictions"] != \
            got.argmax(-1).tolist():
        raise AssertionError(f"{name}: malformed answer")
    return got, wall


def bf16_ulps(got, want) -> float:
    """|got - want| in bf16 ulps of the largest |want| (2^-8 of it)."""
    return float(np.abs(got - want).max()
                 / (BF16_ULP * max(np.abs(want).max(), 1e-30)))


def add_launches(total: dict, run: dict) -> None:
    for n, c in run.items():
        total[n] = total.get(n, 0) + c


def phase_families(card: str) -> dict:
    """Phase 10: the BASELINE families trained by the port's Trainer.fit
    and served by its ModelServer on the card. Returns each kernel's
    launches over the main path's runs (the fits and the served requests;
    not the comparisons)."""
    import torch

    launches: dict = {}
    print("phase 10: the BASELINE families on the card (ResNet-50, "
          "BERT-base classifier and MLM, ViT-B/16, MNIST MLP and CNN): "
          f"Trainer.fit and ModelServer [{card}]", flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        images = phase_resnet(tmp, card, launches)
        phase_bert(tmp, card, launches)
        phase_vit(tmp, card, launches, images)
        del images
        phase_mnist(tmp, card, launches)
    print(f"  phase 10 launches: {launches} [{card}]", flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def phase_resnet(tmp: str, card: str, launches: dict):
    """(a) ResNet-50, 1000 classes, 224², 7x7 stem, f32 parameters and
    bf16 compute (AUTO), Trainer.fit at bench.py's batch 128 for
    FAM_RESNET_STEPS steps; the s2d stem against the 7x7 stem in f32;
    served as resnet50. Returns the dataset (phase (c) reuses its images)."""
    import torch

    from kubeflow_tpu_torch.models.resnet import (
        ResNet50,
        stem_weights_7x7_to_s2d,
    )
    from kubeflow_tpu_torch.serving.model import TorchModel, save_predictor
    from kubeflow_tpu_torch.serving.server import ModelServer
    from kubeflow_tpu_torch.train.data import synthetic_image_dataset
    from kubeflow_tpu_torch.train.trainer import Trainer, TrainerConfig

    b, steps = FAM_RESNET_BATCH, FAM_RESNET_STEPS
    t0 = time.perf_counter()
    ds = synthetic_image_dataset(n_train=FAM_RESNET_IMAGES, n_test=b,
                                 shape=(224, 224, 3), num_classes=1000,
                                 seed=SEED)
    model = ResNet50(num_classes=1000, device="cuda").init_weights(
        torch.Generator().manual_seed(SEED))
    stats = {n: t.clone() for n, t in model.named_buffers()}
    trainer = Trainer(model, TrainerConfig(
        batch_size=b, steps=steps, learning_rate=1e-3, log_every_steps=1,
        seed=SEED))
    n_params = sum(p.numel() for p in model.parameters())
    print(f"  (a) ResNet-50: {n_params} params, compute "
          f"{trainer.compute_dtype}, batch {b} x 224x224x3, {steps} steps "
          f"over {FAM_RESNET_IMAGES} images, set up in "
          f"{time.perf_counter() - t0:.2f}s [{card}]", flush=True)
    if trainer.compute_dtype != torch.bfloat16:
        raise AssertionError(f"AUTO resolved to {trainer.compute_dtype}")
    gc.collect()
    torch.cuda.reset_peak_memory_stats()
    run = fit_timed(trainer, ds)
    losses = run["losses"]
    moved = sum(not torch.equal(t, stats[n])
                for n, t in model.named_buffers())
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"  (a) fit {run['wall']:.2f}s; losses "
          f"{' '.join(f'{x:.4f}' for x in losses)}; final eval loss "
          f"{run['final']['final_loss']:.4f}; step {run['step_ms']:.2f} ms "
          f"(median of steps 4..{steps}); {b / run['step_ms'] * 1e3:.1f} "
          f"images/s; BN running averages moved {moved} of "
          f"{len(stats)}; peak memory {peak:.2f} GiB; launches "
          f"{run['launches']} (ResNet's convs, BN and pools are library "
          f"calls) [{card}]", flush=True)
    if (len(losses) != steps or not all(map(math.isfinite, losses))
            or not np.mean(losses[-3:]) < np.mean(losses[:3])):
        raise AssertionError(f"ResNet-50 did not train clean: {losses}")
    if moved != len(stats):
        raise AssertionError(f"only {moved} of {len(stats)} BatchNorm "
                             "running averages moved")
    add_launches(launches, run["launches"])
    batch = tuple(torch.as_tensor(a[:b], device="cuda")
                  for a in (ds.x_train, ds.y_train))
    profile_step(lambda: trainer.train_step(run["state"], batch),
                 run["step_ms"], card)
    del trainer, run, batch
    model.eval()

    # ---- the s2d stem against the 7x7 stem, f32, on the trained weights
    x = torch.as_tensor(ds.x_test[:8], device="cuda")
    s2d = ResNet50(num_classes=1000, stem="s2d", device="cuda")
    sd = dict(model.state_dict())
    sd["conv_init.kernel"] = stem_weights_7x7_to_s2d(sd["conv_init.kernel"])
    s2d.load_state_dict(sd)
    with torch.no_grad():
        want = model(x)
        got = s2d.eval()(x)
    scale = max(1.0, want.abs().max().item())
    err = (got - want).abs().max().item()
    print(f"  (a) s2d stem vs 7x7 stem, f32 logits: max abs err {err:.3e} "
          f"(limit 1e-4 of max(1, max |logit|) = {scale:.3g}) [{card}]",
          flush=True)
    if err > 1e-4 * scale:
        raise AssertionError(f"s2d stem logits off by {err}")
    del s2d

    # ---- served as resnet50
    example = ds.x_test[:2]
    save_predictor(f"{tmp}/resnet50", "resnet50", model.state_dict(),
                   example, num_classes=1000)
    srv = ModelServer([TorchModel("resnet50", f"{tmp}/resnet50",
                                  device="cuda")], port=0, host="127.0.0.1")
    zero_launches()
    try:
        t0 = time.perf_counter()
        srv.start()
        up = time.perf_counter() - t0
        got, wall = served_logits(srv, "resnet50", example)
        add_launches(launches, _launch_counts())
    finally:
        srv.stop()
    with torch.no_grad():
        want = model(torch.as_tensor(example, device="cuda")).cpu().numpy()
    err = float(np.abs(got - want).max())
    scale = max(1.0, float(np.abs(want).max()))
    print(f"  (a) served resnet50: up in {up:.2f}s, v1 :predict of 2 images "
          f"in {wall * 1e3:.1f} ms; logits vs the module's eval forward "
          f"max abs err {err:.3e} (limit 1e-4 of {scale:.3g}) [{card}]",
          flush=True)
    if err > 1e-4 * scale:
        raise AssertionError(f"served resnet50 logits off by {err}")
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return ds


def _launch_counts(names=FLASH_KERNELS) -> dict:
    """The launch counts of the named kernels (the four flash kernels by
    default; ``None``: every kernel)."""
    from kubeflow_tpu_torch.kernels import KERNELS

    return {n: k.launches for n, k in KERNELS.items()
            if names is None or n in names}


def phase_bert(tmp: str, card: str, launches: dict) -> None:
    """(b) BERT-base with attention="flash", dropout 0, bf16 compute:
    the classifier trained at bench.py's 16 x 128 (padded rows) with the
    flash kernels' launches checked every step, one more step profiled;
    the same fit graphed (fused_steps=FAM_BERT_FUSED) from the same
    weights, its losses, launches, step time and a profiled chunk beside
    the eager fit's; one f32 step through the kernels against the plain
    attention path; served as bert-classifier (base); then BertForMaskedLM
    for a few steps at the same shape."""
    import dataclasses

    import torch

    from kubeflow_tpu_torch.models.bert import (
        BertConfig,
        BertForMaskedLM,
        BertForSequenceClassification,
        masked_lm_eval_metrics,
        masked_lm_loss,
    )
    from kubeflow_tpu_torch.serving.model import TorchModel, save_predictor
    from kubeflow_tpu_torch.serving.server import ModelServer
    from kubeflow_tpu_torch.train.data import (
        Dataset,
        mask_tokens_for_mlm,
        synthetic_text_dataset,
    )
    from kubeflow_tpu_torch.train.trainer import Trainer, TrainerConfig

    b, l, steps = FAM_BERT_BATCH, FAM_BERT_LEN, FAM_BERT_STEPS
    cfg = BertConfig.base(attention="flash", dropout_rate=0.0)
    ds = synthetic_text_dataset(n_train=b * steps, n_test=b, seq_len=l,
                                vocab_size=cfg.vocab_size, num_classes=2,
                                seed=SEED)
    model = BertForSequenceClassification(cfg, 2, device="cuda"
                                          ).init_weights(
        torch.Generator().manual_seed(SEED))
    init = {k: v.clone() for k, v in model.state_dict().items()}
    trainer = Trainer(model, TrainerConfig(
        batch_size=b, steps=steps, learning_rate=1e-4, log_every_steps=1,
        seed=SEED))
    pads = int((ds.x_train == 0).sum())
    print(f"  (b) BERT-base classifier: "
          f"{sum(p.numel() for p in model.parameters())} params, compute "
          f"{trainer.compute_dtype}, batch {b} x {l} tokens ({pads} of "
          f"{ds.x_train.size} train positions padding), {steps} steps "
          f"[{card}]", flush=True)
    if trainer.compute_dtype != torch.bfloat16:
        raise AssertionError(f"AUTO resolved to {trainer.compute_dtype}")
    run = fit_timed(trainer, ds)
    check_flash_steps(run, cfg.num_layers, "BERT-base classifier")
    n_eval = 2 * cfg.num_layers  # the epoch's eval and the final eval
    if run["launches"]["flash_fwd"] != cfg.num_layers * steps + n_eval:
        raise AssertionError(f"BERT fit launches {run['launches']}")
    losses = run["losses"]
    print(f"  (b) fit {run['wall']:.2f}s; losses "
          f"{' '.join(f'{x:.4f}' for x in losses)}; step "
          f"{run['step_ms']:.2f} ms (median of steps 4..{steps}), "
          f"{1e3 / run['step_ms']:.2f} steps/s, "
          f"{b * l / run['step_ms'] * 1e3:.0f} tokens/s; launches "
          f"{run['launches']}, each step {run['per_step'][-1]} [{card}]",
          flush=True)
    if len(losses) != steps or not all(map(math.isfinite, losses)):
        raise AssertionError(f"BERT-base did not train clean: {losses}")
    add_launches(launches, run["launches"])
    fitted = {k: v.clone() for k, v in model.state_dict().items()}
    batch = tuple(torch.as_tensor(a[:b], device="cuda")
                  for a in (ds.x_train, ds.y_train))
    eager_idle = profile_step(lambda: trainer.train_step(run["state"], batch),
                              run["step_ms"], card)
    trained = {k: v.clone() for k, v in model.state_dict().items()}
    eager = {k: run[k] for k in ("logged", "step_ms")}
    del trainer, run, model, batch
    torch.cuda.empty_cache()

    # ---- the same fit graphed (fused_steps=FAM_BERT_FUSED), same weights
    k = FAM_BERT_FUSED
    model = BertForSequenceClassification(cfg, 2, device="cuda")
    model.load_state_dict(init)
    trainer = Trainer(model, TrainerConfig(
        batch_size=b, steps=steps, learning_rate=1e-4, log_every_steps=1,
        seed=SEED, fused_steps=k))
    run = fit_timed(trainer, ds)
    check_flash_steps(run, cfg.num_layers, "BERT-base classifier, graphed")
    warm = trainer.graph_warmups
    if run["launches"]["flash_fwd"] != (cfg.num_layers * (steps + warm)
                                        + n_eval):
        raise AssertionError(f"graphed BERT fit launches {run['launches']}")
    check_logged_against(run, eager, "(b) BERT-base", card)
    diff = max_param_diff(model, fitted)
    del fitted
    stacked = tuple(np.stack([a[i * b:(i + 1) * b] for i in range(k)])
                    for a in (ds.x_train, ds.y_train))
    graphed_idle = profile_step(
        lambda: trainer.train_chunk(run["state"], stacked, k),
        run["chunk_ms"], card, what=f"chunk of {k} steps")
    gms = run["chunk_ms"]
    print(f"  (b) graphed vs eager, BERT-base at {b} x {l}: step {gms:.2f} "
          f"vs {eager['step_ms']:.2f} ms ({1e3 / gms:.2f} vs "
          f"{1e3 / eager['step_ms']:.2f} steps/s), idle share of a profiled "
          f"chunk {share(graphed_idle)} vs a profiled step "
          f"{share(eager_idle)}; dispatches of "
          f"{[d['steps'] for d in run['dispatches']]} steps after {warm} "
          f"warm-up step(s); launches {run['launches']}; largest final "
          f"parameter difference {diff} [{card}]", flush=True)
    add_launches(launches, run["launches"])
    del trainer, run, model, stacked
    torch.cuda.empty_cache()

    # ---- one f32 step through the kernels against the plain path
    grads = {}
    for attention in ("flash", "dense"):
        m = BertForSequenceClassification(
            dataclasses.replace(cfg, attention=attention), 2, device="cuda")
        m.load_state_dict(init)
        tr = Trainer(m, TrainerConfig(batch_size=b, compute_dtype="float32",
                                      learning_rate=0.0))
        before = _launch_counts()["flash_bwd_dq"]
        _, met = tr.train_step(tr.init_state(), (ds.x_train[:b],
                                                 ds.y_train[:b]))
        torch.cuda.synchronize()
        grads[attention] = (float(met["loss"]), {
            n: p.grad.detach().clone() for n, p in m.named_parameters()},
            _launch_counts()["flash_bwd_dq"] - before)
        del tr, m
    (loss_k, g_k, n_k), (loss_p, g_p, n_p) = grads["flash"], grads["dense"]
    top = max(g.abs().max().item() for g in g_p.values())
    worst = max(((g_k[n] - g).abs().max().item()
                 / max(g.abs().max().item(), 1e-3 * top), n)
                for n, g in g_p.items())
    print(f"  (b) f32 step, flash kernels vs dense: loss {loss_k:.6f} vs "
          f"{loss_p:.6f}; worst grad error {worst[0]:.3e} of its scale "
          f"({worst[1]}); dq launches {n_k} vs {n_p} [{card}]", flush=True)
    if (abs(loss_k - loss_p) > 1e-5 * abs(loss_p) or worst[0] > 1e-3
            or n_k != cfg.num_layers or n_p != 0):
        raise AssertionError(f"BERT flash grads disagree with dense: {worst}")
    del grads, g_k, g_p
    torch.cuda.empty_cache()

    # ---- served as bert-classifier (base), bf16 flash
    x = ds.x_test[:4]
    kw = {"size": "base", "num_classes": 2, "config": {
        "attention": "flash", "dtype": "bfloat16", "dropout_rate": 0.0}}
    save_predictor(f"{tmp}/bert", "bert-classifier", trained, x, **kw)
    srv = ModelServer([TorchModel("bert", f"{tmp}/bert", device="cuda")],
                      port=0, host="127.0.0.1")
    zero_launches()
    try:
        srv.start()
        warm = _launch_counts()["flash_fwd"]
        got, wall = served_logits(srv, "bert", x)
        served = _launch_counts()
        add_launches(launches, served)
    finally:
        srv.stop()
    plain = BertForSequenceClassification(
        dataclasses.replace(cfg, attention="dense", dtype="bfloat16"), 2,
        device="cuda")
    plain.load_state_dict(trained)
    with torch.no_grad():
        want = plain.eval()(torch.as_tensor(x, device="cuda")).cpu().numpy()
    ulps = bf16_ulps(got, want)
    print(f"  (b) served bert-classifier (base, bf16, flash): v1 :predict "
          f"of {x.shape} in {wall * 1e3:.1f} ms, flash_fwd launches "
          f"{warm} at load and {served['flash_fwd'] - warm} for the "
          f"request; logits vs the plain path {ulps:.2f} bf16 ulps (limit "
          f"{BF16_ULPS}) [{card}]", flush=True)
    if ulps > BF16_ULPS or served["flash_fwd"] - warm != cfg.num_layers:
        raise AssertionError(f"served BERT: {ulps} ulps, launches {served}")
    del plain, trained
    torch.cuda.empty_cache()

    # ---- BertForMaskedLM at the same shape
    data_vocab = cfg.vocab_size - 1   # the last id is [MASK]
    text = synthetic_text_dataset(n_train=b * FAM_MLM_STEPS, n_test=b,
                                  seq_len=l, vocab_size=data_vocab,
                                  seed=SEED + 1)
    xtr, ytr = mask_tokens_for_mlm(text.x_train, data_vocab, data_vocab,
                                   seed=SEED)
    xte, yte = mask_tokens_for_mlm(text.x_test, data_vocab, data_vocab,
                                   seed=SEED + 1)
    mlm = BertForMaskedLM(cfg, device="cuda").init_weights(
        torch.Generator().manual_seed(SEED + 2))
    trainer = Trainer(mlm, TrainerConfig(
        batch_size=b, steps=FAM_MLM_STEPS, learning_rate=1e-4,
        log_every_steps=1, seed=SEED), loss_fn=masked_lm_loss,
        eval_metrics_fn=masked_lm_eval_metrics)
    run = fit_timed(trainer, Dataset(xtr, ytr, xte, yte, cfg.vocab_size))
    check_flash_steps(run, cfg.num_layers, "BERT-base MLM")
    losses = run["losses"]
    print(f"  (b) MLM: {FAM_MLM_STEPS} steps, {int((ytr >= 0).sum())} "
          f"masked positions; losses {' '.join(f'{x:.4f}' for x in losses)}"
          f"; final masked eval loss {run['final']['final_loss']:.4f}; step "
          f"{run['step_ms']:.2f} ms; launches {run['launches']} [{card}]",
          flush=True)
    if len(losses) != FAM_MLM_STEPS or not all(map(math.isfinite, losses)):
        raise AssertionError(f"BERT MLM did not train clean: {losses}")
    add_launches(launches, run["launches"])
    del trainer, run, mlm
    gc.collect()
    torch.cuda.empty_cache()


def phase_vit(tmp: str, card: str, launches: dict, images) -> None:
    """(c) ViT-B/16 at 224² (197 tokens), flash, bf16 compute, batch
    FAM_VIT_BATCH, a few steps of Trainer.fit on phase (a)'s images with
    the flash launches checked every step; served as vit-classifier
    (base), logits against the plain path."""
    import dataclasses

    import torch

    from kubeflow_tpu_torch.models.vit import ViTClassifier, ViTConfig
    from kubeflow_tpu_torch.serving.model import TorchModel, save_predictor
    from kubeflow_tpu_torch.serving.server import ModelServer
    from kubeflow_tpu_torch.train.data import Dataset
    from kubeflow_tpu_torch.train.trainer import Trainer, TrainerConfig

    b, steps = FAM_VIT_BATCH, FAM_VIT_STEPS
    cfg = ViTConfig.base(attention="flash", dropout_rate=0.0)
    ds = Dataset(images.x_train, images.y_train, images.x_test[:b],
                 images.y_test[:b], 1000)
    model = ViTClassifier(cfg, device="cuda").init_weights(
        torch.Generator().manual_seed(SEED))
    trainer = Trainer(model, TrainerConfig(
        batch_size=b, steps=steps, learning_rate=1e-4, log_every_steps=1,
        seed=SEED))
    print(f"  (c) ViT-B/16: {sum(p.numel() for p in model.parameters())} "
          f"params, compute {trainer.compute_dtype}, batch {b} x 224x224x3 "
          f"({cfg.num_patches + 1} tokens), {steps} steps [{card}]",
          flush=True)
    if trainer.compute_dtype != torch.bfloat16:
        raise AssertionError(f"AUTO resolved to {trainer.compute_dtype}")
    run = fit_timed(trainer, ds)
    check_flash_steps(run, cfg.num_layers, "ViT-B/16")
    losses = run["losses"]
    print(f"  (c) fit {run['wall']:.2f}s; losses "
          f"{' '.join(f'{x:.4f}' for x in losses)}; step "
          f"{run['step_ms']:.2f} ms (median of steps 4..{steps}), "
          f"{1e3 / run['step_ms']:.2f} steps/s, "
          f"{b / run['step_ms'] * 1e3:.1f} images/s; launches "
          f"{run['launches']} [{card}]", flush=True)
    if len(losses) != steps or not all(map(math.isfinite, losses)):
        raise AssertionError(f"ViT-B/16 did not train clean: {losses}")
    add_launches(launches, run["launches"])
    trained = {k: v.clone() for k, v in model.state_dict().items()}
    del trainer, run, model
    torch.cuda.empty_cache()

    x = images.x_test[:2]
    kw = {"size": "base", "config": {"attention": "flash",
                                     "dtype": "bfloat16",
                                     "dropout_rate": 0.0}}
    save_predictor(f"{tmp}/vit", "vit-classifier", trained, x, **kw)
    srv = ModelServer([TorchModel("vit", f"{tmp}/vit", device="cuda")],
                      port=0, host="127.0.0.1")
    zero_launches()
    try:
        srv.start()
        warm = _launch_counts()["flash_fwd"]
        got, wall = served_logits(srv, "vit", x)
        served = _launch_counts()
        add_launches(launches, served)
    finally:
        srv.stop()
    plain = ViTClassifier(dataclasses.replace(cfg, attention="dense",
                                              dtype="bfloat16"),
                          device="cuda")
    plain.load_state_dict(trained)
    with torch.no_grad():
        want = plain.eval()(torch.as_tensor(x, device="cuda")).cpu().numpy()
    ulps = bf16_ulps(got, want)
    print(f"  (c) served vit-classifier (base, bf16, flash): v1 :predict of "
          f"2 images in {wall * 1e3:.1f} ms, flash_fwd launches {warm} at "
          f"load and {served['flash_fwd'] - warm} for the request; logits "
          f"vs the plain path {ulps:.2f} bf16 ulps (limit {BF16_ULPS}) "
          f"[{card}]", flush=True)
    if ulps > BF16_ULPS or served["flash_fwd"] - warm != cfg.num_layers:
        raise AssertionError(f"served ViT: {ulps} ulps, launches {served}")
    del plain, trained
    gc.collect()
    torch.cuda.empty_cache()


def phase_mnist(tmp: str, card: str, launches: dict) -> None:
    """(d) MnistMLP and MnistCNN on synthetic 28x28x1 images, one epoch
    each of Trainer.fit (f32): eval accuracy at least 3x chance; both
    served, logits equal to the module's forward."""
    import torch

    from kubeflow_tpu_torch.models.mnist import MnistCNN, MnistMLP
    from kubeflow_tpu_torch.serving.model import TorchModel, save_predictor
    from kubeflow_tpu_torch.serving.server import ModelServer
    from kubeflow_tpu_torch.train.data import synthetic_image_dataset
    from kubeflow_tpu_torch.train.trainer import Trainer, TrainerConfig

    ds = synthetic_image_dataset(n_train=FAM_MNIST_TRAIN,
                                 n_test=FAM_MNIST_TEST, shape=(28, 28, 1),
                                 num_classes=10, seed=SEED)
    x = ds.x_test[:4]
    models = {}
    for family, model in (
            ("mnist-mlp", MnistMLP(784, device="cuda")),
            ("mnist-cnn", MnistCNN((28, 28, 1), device="cuda"))):
        model.init_weights(torch.Generator().manual_seed(SEED))
        trainer = Trainer(model, TrainerConfig(batch_size=128, epochs=1,
                                               learning_rate=1e-3,
                                               seed=SEED))
        run = fit_timed(trainer, ds)
        acc = run["final"]["final_accuracy"]
        print(f"  (d) {family}: compute {trainer.compute_dtype}, "
              f"{len(run['per_step'])} steps of 128, fit {run['wall']:.2f}s, "
              f"step {run['step_ms']:.2f} ms; final eval accuracy {acc:.4f} "
              f"(chance 0.1) [{card}]", flush=True)
        if not acc >= 0.3:
            raise AssertionError(f"{family} eval accuracy {acc}")
        add_launches(launches, run["launches"])
        save_predictor(f"{tmp}/{family}", family, model.state_dict(), x)
        models[family] = model.eval()
    srv = ModelServer([TorchModel(f, f"{tmp}/{f}", device="cuda")
                       for f in models], port=0, host="127.0.0.1")
    try:
        srv.start()
        for family, model in models.items():
            got, wall = served_logits(srv, family, x)
            with torch.no_grad():
                want = model(torch.as_tensor(x, device="cuda")).cpu().numpy()
            err = float(np.abs(got - want).max())
            print(f"  (d) served {family}: v1 :predict in {wall * 1e3:.1f} "
                  f"ms; logits vs the module's forward max abs err "
                  f"{err:.3e} [{card}]", flush=True)
            if err > 1e-5 * max(1.0, float(np.abs(want).max())):
                raise AssertionError(f"served {family} logits off by {err}")
    finally:
        srv.stop()


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


def engine_prompts(vocab: int, seed: int = SEED + 7) -> tuple[list, list]:
    """Phase 7's traffic from the seed: (prompts, sampled flags). The first
    ENGINE_SHARED prompts share an ENGINE_PREFIX-token system prefix; the
    last ENGINE_SAMPLED are sampled."""
    rng = np.random.RandomState(seed)
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
        logits = model(x, cache=cache)[:, -1:]
        if y.shape[1] > 1:
            rest = model(y[:, :-1], cache=cache)
            logits = torch.cat([logits, rest], dim=1)     # (B, NEW, V)
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


def phase_fleet(sd, prompts, tmp: str, card: str,
                plain: dict) -> tuple[int, dict]:
    """Phase 8 (c): a two-replica fleet over one pool behind ModelServer,
    a replica killed at the first token, then an admission shed. Returns
    flash_fwd's launches over the drill and each replica's median decode
    dispatch (ms) while both decoded."""
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
    return launches, {n: float(np.median(v)) for n, v in both.items()}


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


def phase_spec_fleet(peaks, card: str, plain: dict) -> tuple[int, dict]:
    """Phase 8: speculative decoding, solo (a) and in the engine (b), the
    two-replica fleet with its kill drill and shed (c), and the
    disaggregated pair (d). Returns flash_fwd's launches over their runs
    and (c)'s decode dispatch medians (ms) with both replicas decoding."""
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
        fleet_launches, fleet_ticks = phase_fleet(sd, prompts, tmp, card,
                                                  plain)
        launches += fleet_launches
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
    return launches, fleet_ticks


# ------------------------------------------------------------- phase 9


def pod_trace(trace_dir: str, client) -> list[dict]:
    """A pod's spans as its worker last flushed them (every tick): the
    complete events of `<trace_dir>/trace-<name>-<pid>.json`."""
    from pathlib import Path

    path = Path(trace_dir) / f"trace-{client.name}-{client.worker_pid}.json"
    return [e for e in json.loads(path.read_text())["traceEvents"]
            if e.get("ph") == "X"]


def pod_prefills(spans: list[dict]) -> tuple[int, int]:
    """(prefill chunks that started at position 0, prompt positions
    computed) in a pod's spans."""
    chunks = [e["args"] for e in spans if e["name"] == "engine.prefill_chunk"]
    from_zero = sum(1 for a in chunks if a.get("tokens_reused", 0) == 0
                    and a["pos"] == a["tokens_computed"])
    return from_zero, sum(a["tokens_computed"] for a in chunks)


def pod_launches(spans: list[dict]) -> dict:
    """The kernels' launches inside the pod's process since it began
    serving: its newest pod.kernel_launches event."""
    events = [e["args"] for e in spans if e["name"] == "pod.kernel_launches"]
    if not events:
        return {}
    return {k: v for k, v in events[-1].items()
            if k not in ("trace_id", "span_id", "parent_id")}


def timed_ticks(client, samples: list) -> None:
    """Record each client-side tick round trip of `client` as (start,
    seconds, rows the client held) in `samples`."""
    tick = client.tick

    def timed():
        rows = len(client._rows)
        t0 = time.perf_counter()
        busy = tick()
        samples.append((t0, time.perf_counter() - t0, rows))
        return busy

    client.tick = timed


def clock_calls(targets, clock: dict):
    """Wrap each (owner, attribute, name) callable so that clock[key]
    sums (calls, seconds) of its calls from any thread; the key is the
    name, with "@<thread>" added for calls made on a pod client's own
    ticking thread. Returns the function that unwraps them."""
    import threading

    mu = threading.Lock()
    saved = []
    for owner, attr, name in targets:
        fn = getattr(owner, attr)
        saved.append((owner, attr, vars(owner).get(attr)))

        def call(*a, _fn=fn, _name=name, **kw):
            t0 = time.perf_counter()
            try:
                return _fn(*a, **kw)
            finally:
                dt = time.perf_counter() - t0
                thread = threading.current_thread().name
                key = _name + (f"@{thread[len('pod-client-'):]}"
                               if thread.startswith("pod-client-") else "")
                with mu:
                    n, sec = clock.get(key, (0, 0.0))
                    clock[key] = (n + 1, round(sec + dt, 6))

        setattr(owner, attr, call)

    def restore():
        for owner, attr, old in reversed(saved):
            if old is None:     # a method of the instance's class
                delattr(owner, attr)
            else:
                setattr(owner, attr, old)
    return restore


def ready_seconds(state_dir: str, name: str) -> float:
    """A pod's `ready in` line from its stderr log."""
    import re
    from pathlib import Path

    text = Path(state_dir, f"{name}.stderr.log").read_text()
    found = re.search(r"ready in ([0-9.]+)s", text)
    if found is None:
        raise AssertionError(f"pod {name} never reported ready: {text}")
    return float(found.group(1))


def chain_wire_ms(cfg, prompt) -> tuple[float, float, int]:
    """Host time of one prefill handoff's chain on the wire, in the
    parent: a (prompt + 1)-position bf16 chain of GPT-2 small serialized
    (serialize_chain + json.dumps) and deserialized (json.loads +
    deserialize_chain into a fresh pool). Returns (median serialize ms,
    median deserialize ms, JSON bytes)."""
    import torch

    from kubeflow_tpu_torch.models.gpt import cache_paths
    from kubeflow_tpu_torch.serving.fleet import PagedKVPool
    from kubeflow_tpu_torch.serving.fleet.wire import (
        deserialize_chain,
        serialize_chain,
    )

    n = prompt.size + 1
    gen = torch.Generator().manual_seed(SEED + 42)
    heads, hd = cfg.num_heads, cfg.hidden_size // cfg.num_heads
    kv = {p: torch.randn((n, heads, hd), generator=gen).to(torch.bfloat16)
          for p in cache_paths(cfg.num_layers)}
    ids = np.concatenate([prompt, prompt[:1]]).astype(np.int32)
    pool = PagedKVPool(ENGINE_BLOCK, 64)
    refs = pool.insert(ids, kv)
    enc, dec = [], []
    for _ in range(POD_CODEC_REPEATS):
        t0 = time.perf_counter()
        body = json.dumps(serialize_chain(pool, refs))
        t1 = time.perf_counter()
        chain = deserialize_chain(PagedKVPool(ENGINE_BLOCK, 64),
                                  json.loads(body))
        dec.append(time.perf_counter() - t1)
        enc.append(t1 - t0)
        if chain.frozen or chain.length != n:
            raise AssertionError("the chain did not cross whole")
        chain.release()
    return np.median(enc) * 1e3, np.median(dec) * 1e3, len(body)


def card_compute_apps() -> list:
    """The card's compute processes as nvidia-smi lists them ("pid, used
    memory"; its pids are the host's, which a container may not share)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-compute-apps=pid,used_memory",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    return [line.strip() for line in out.stdout.splitlines()
            if line.strip()]


def card_used_gib() -> float:
    """Memory in use on the card by every process, GiB."""
    import torch

    free, total = torch.cuda.mem_get_info()
    return (total - free) / 2**30


def phase_pods(card: str, plain: dict, fleet_ticks: dict) -> int:
    """Phase 9: the pod tier on the card — GPT-2 small served by worker
    processes, one engine each, behind the router. (a) a prefill pod and
    two decode pods under run_loadtest_sync, one decode pod SIGKILLed
    mid-decode; (b) the flash kernel ran inside the prefill pod and no
    prompt position on a decode pod (these three pods flush their spans
    every tick); (c) on three other pods, which record no spans, with
    every client ticking from its own thread: the tick round trips,
    tokens/s, TTFT, ready times, handoff bytes and the chain's host time
    on the wire. Returns flash_fwd's launches in the prefill pod over
    (a)."""
    import dataclasses
    import os
    import signal

    import torch

    from kubeflow_tpu_torch.convert import flax_params_from_gpt
    from kubeflow_tpu_torch.models.gpt import GPTConfig, GPTLM
    from kubeflow_tpu_torch.serving.fleet import (
        FleetRouter,
        PagedKVPool,
        pod_metrics_snapshot,
        run_loadtest_sync,
        spawn_pod,
        wire_pod_deaths,
    )
    from kubeflow_tpu_torch.tracing import ENV_TRACE_DIR

    t_phase = time.perf_counter()
    cfg = GPTConfig.small(attention="flash", dtype="bfloat16")
    n_layers = cfg.num_layers
    # phase 7's weights, once, in the flax layout every pod loads
    sd = GPTLM(cfg, device="cuda").init_weights(
        torch.Generator().manual_seed(SEED + 5)).state_dict()
    prompts, _ = engine_prompts(cfg.vocab_size)
    c_prompts, _ = engine_prompts(cfg.vocab_size, seed=SEED + 43)
    clients = {}
    with tempfile.TemporaryDirectory() as tmp:
        np.savez(f"{tmp}/params.npz", **flax_params_from_gpt(sd, cfg))
        state, trace_dir = f"{tmp}/pods", f"{tmp}/trace"
        spec = {"model": dataclasses.asdict(cfg), "device": "cuda",
                "params": f"{tmp}/params.npz", "max_rows": ENGINE_ROWS,
                "default_max_new_tokens": POD_NEW, "eos_token_id": None,
                "seed": SEED, "prefill_chunk": 0,
                "pool": {"block_size": ENGINE_BLOCK,
                         "capacity_blocks": 1024}}
        prefill = {**spec, "prefill_chunk": DISAGG_CHUNK,
                   "max_chunks_per_tick": DISAGG_CHUNKS_PER_TICK}
        # name -> (spec, home pool, extra environment): (a)/(b)'s pods
        # flush spans every tick, (c)'s record none
        home_a = PagedKVPool(ENGINE_BLOCK, 1024)
        home_c = PagedKVPool(ENGINE_BLOCK, 1024)
        traced = {ENV_TRACE_DIR: trace_dir}
        pods = {"prefill-0": (prefill, home_a, traced),
                "decode-0": (spec, home_a, traced),
                "decode-1": (spec, home_a, traced),
                "prefill-1": (prefill, home_c, None),
                "decode-2": (spec, home_c, None),
                "decode-3": (spec, home_c, None)}
        used0 = card_used_gib()
        try:
            t0 = time.perf_counter()
            for name, (sp, home, env) in pods.items():  # started together
                clients[name] = spawn_pod(
                    name, sp, state, home_pool=home, connect=False,
                    env_extra=env)
            for c in clients.values():
                c.connect()
            up = time.perf_counter() - t0
            ready = {n: ready_seconds(state, n) for n in clients}
            used_up = card_used_gib() - used0
            pre, victim, survivor = (
                clients[n] for n in ("prefill-0", "decode-0", "decode-1"))
            print(f"phase 9: the pod tier, GPT-2 small bf16 compute, f32 "
                  f"params from one params.npz, {ENGINE_ROWS} rows and "
                  f"paged KV block {ENGINE_BLOCK} a pod; {len(clients)} "
                  f"worker processes up in {up:.2f}s (each pod's ready "
                  f"time: {ready}) [{card}]", flush=True)
            # ------------------------------------------------- (a)
            router = FleetRouter([("prefill-0", pre, "prefill"),
                                  ("decode-0", victim, "decode"),
                                  ("decode-1", survivor, "decode")])
            wire_pod_deaths(router)
            handles = []
            submit = router.submit

            def keep(*a, **kw):
                handles.append(submit(*a, **kw))
                return handles[-1]

            router.submit = keep
            killed = {}

            def on_tick(tick, _router):
                # rows of decode-0 have decoded POD_KILL_DECODED tokens
                # each on it (the first came with the prefill handoff)
                deep = [h for h in list(victim._rows)
                        if len(h.tokens) > POD_KILL_DECODED]
                if not killed and len(deep) >= POD_KILL_ROWS:
                    killed["tick"] = tick
                    # what the client had streamed from decode-0
                    killed["streamed"] = [
                        (f, list(f.tokens)) for f in handles
                        if f.replica == "decode-0" and not f.done.is_set()]
                    os.kill(victim.worker_pid, signal.SIGKILL)

            wire0 = pod_metrics_snapshot()
            t_run = time.perf_counter()
            report = run_loadtest_sync(router, prompts, seed=SEED + 41,
                                       mean_gap_ticks=1.0,
                                       new_tokens=POD_NEW, on_tick=on_tick)
            wall = time.perf_counter() - t_run
            s = report.summary()
            m = dict(router.metrics)
            wire1 = pod_metrics_snapshot()
            spans = {n: pod_trace(trace_dir, clients[n])
                     for n in ("prefill-0", "decode-0", "decode-1")}
            from_zero, computed = pod_prefills(spans["prefill-0"])
            launches = pod_launches(spans["prefill-0"]).get("flash_fwd", 0)
            decode_computed = {n: pod_prefills(spans[n])[1]
                               for n in ("decode-0", "decode-1")}
            print(f"  (a) {len(prompts)} requests x {ENGINE_PROMPT} tokens, "
                  f"{POD_NEW} new each, run_loadtest_sync over 1 prefill "
                  f"pod (chunk {DISAGG_CHUNK}, {DISAGG_CHUNKS_PER_TICK} a "
                  f"tick) and 2 decode pods; decode-0 SIGKILLed at tick "
                  f"{killed.get('tick')}, holding "
                  f"{[len(t) for _, t in killed.get('streamed', [])]} "
                  f"streamed tokens in its rows: {wall:.3f}s, {s}; router "
                  f"{m}; handoff bytes {wire1['handoff_bytes_total'] - wire0['handoff_bytes_total']}"
                  f", wire retries "
                  f"{wire1['wire_retries_total'] - wire0['wire_retries_total']}"
                  f" [{card}]", flush=True)
            if not killed:
                raise AssertionError(
                    f"decode-0 never held {POD_KILL_ROWS} rows with "
                    f"{POD_KILL_DECODED} decoded tokens")
            if s["dropped"] or s["completed"] != len(prompts):
                raise AssertionError(f"the pod drill dropped requests: {s}")
            if s["requeued"] < POD_KILL_ROWS \
                    or s["resumed"] != s["requeued"] \
                    or s["resumed_tokens"] < s["resumed"]:
                raise AssertionError(
                    f"requeues not all resumed from their chains: {s}")
            # each killed row's decoded positions were decoded again on
            # decode-1 from the home chain: what the client had streamed
            # from decode-0 is a prefix of the answer
            deep = [f for f, t in killed["streamed"]
                    if len(t) > POD_KILL_DECODED]
            if len(deep) < POD_KILL_ROWS or any(
                    list(f.tokens)[:len(t)] != t
                    for f, t in killed["streamed"]):
                raise AssertionError(
                    "a killed row's answer disagrees with what decode-0 "
                    "had streamed")
            if m["prefill_handoffs_total"] != len(prompts) \
                    or m["replica_kills_total"] < 1:
                raise AssertionError(f"handoffs or kills: {m}")
            if any(decode_computed.values()) \
                    or survivor.prefill_tokens_total:
                raise AssertionError(
                    f"prompt positions computed on a decode pod: "
                    f"{decode_computed}, decode-1 counter "
                    f"{survivor.prefill_tokens_total}")
            victim.proc.wait(timeout=30)
            others = [c for c in clients.values() if c is not victim]
            if victim.proc.returncode != -signal.SIGKILL or any(
                    c.proc.poll() is not None for c in others):
                raise AssertionError(
                    f"process states: victim rc {victim.proc.returncode},"
                    f" survivors {[c.proc.poll() for c in others]}")
            dense = GPTLM(GPTConfig.small(attention="dense",
                                          dtype="bfloat16"), device="cuda")
            dense.load_state_dict(sd)
            tokens = [np.asarray(next(h.tokens for h in handles
                                      if np.array_equal(h.prompt, p)))
                      for p in prompts]
            if any(t.shape != (POD_NEW,) for t in tokens):
                raise AssertionError("a pod answer has the wrong length")
            check_greedy(dense, prompts, tokens, "(a) pods after the kill",
                         card)
            # ------------------------------------------------- (b)
            with open(f"/proc/{pre.worker_pid}/maps") as fh:
                maps = fh.read()
            mapped = "libflash_fwd-" in maps
            print(f"  (b) prefill-0 (pid {pre.worker_pid}) maps "
                  f"libflash_fwd: {mapped}; its spans: {from_zero} prefills "
                  f"from position 0, {computed} prompt positions computed, "
                  f"kernel launches {pod_launches(spans['prefill-0'])}; "
                  f"prompt positions computed on decode-0 / decode-1: "
                  f"{decode_computed} [{card}]", flush=True)
            if not mapped:
                raise AssertionError("the prefill pod never loaded flash_fwd")
            if from_zero < 1 or launches != n_layers * from_zero:
                raise AssertionError(
                    f"flash_fwd launched {launches} times in the prefill pod"
                    f" over {from_zero} prefills from position 0; expected "
                    f"{n_layers} each")
            del dense
            gc.collect()
            torch.cuda.empty_cache()
            # ------------------------------------------------- (c)
            router = FleetRouter([(n, clients[n], role) for n, role in (
                ("prefill-1", "prefill"), ("decode-2", "decode"),
                ("decode-3", "decode"))])
            wire_pod_deaths(router)
            samples = {n: [] for n in ("prefill-1", "decode-2", "decode-3")}
            for n, smp in samples.items():
                timed_ticks(clients[n], smp)
            wire0 = pod_metrics_snapshot()
            # the parent's share of the handoffs: the chain codec (a done
            # event's chain decoded, a decode leg's chain encoded) and the
            # decode-leg submits, whose reply waits for the decode pod to
            # decode the chain
            from kubeflow_tpu_torch.serving.fleet import podclient, wire

            clock = {}
            unwrap = clock_calls(
                [(podclient, "serialize_chain", "serialize"),
                 (wire, "deserialize_chain", "deserialize"),
                 (clients["decode-2"], "submit", "decode-leg submit"),
                 (clients["decode-3"], "submit", "decode-leg submit")],
                clock)
            router.start()
            try:
                t_run = time.perf_counter()
                reqs = [router.submit(p, max_new_tokens=POD_NEW)
                        for p in c_prompts]
                for r in reqs:
                    r.result(timeout=600)
                wall = time.perf_counter() - t_run
            finally:
                router.stop()
                unwrap()
            wire1 = pod_metrics_snapshot()
            used_c = card_used_gib() - used0
            apps = card_compute_apps()
            busy = {n: [(t, dt) for t, dt, rows in smp if rows]
                    for n, smp in samples.items()}
            pf_busy = np.array([dt for _, dt in busy.pop("prefill-1")]) * 1e3
            if any(not b for b in busy.values()):
                raise AssertionError(f"a decode pod held no rows: "
                                     f"{ {n: len(b) for n, b in busy.items()} }")
            lo = max(b[0][0] for b in busy.values())
            hi = min(b[-1][0] for b in busy.values())
            both = {n: [dt * 1e3 for t, dt in b if lo <= t <= hi]
                    for n, b in busy.items()}
            ttft = np.array([r.ttft_s for r in reqs]) * 1e3
            enc_ms, dec_ms, nbytes = chain_wire_ms(cfg, c_prompts[0])
            print(f"  (c) {len(c_prompts)} requests x {ENGINE_PROMPT} "
                  f"tokens, {POD_NEW} new each, on 3 pods that record no "
                  f"spans, every pod client ticking from its own thread: "
                  f"{wall:.3f}s, "
                  f"{len(c_prompts) * POD_NEW / wall:.1f} tokens/s "
                  f"aggregate; TTFT p50 {np.percentile(ttft, 50):.2f} ms, "
                  f"p99 {np.percentile(ttft, 99):.2f} ms; prefill-1's "
                  f"client-side tick round trips while it held rows: "
                  f"{pf_busy.size}, median {np.median(pf_busy):.2f} ms, "
                  f"max {pf_busy.max():.2f} ms, sum {pf_busy.sum():.2f} ms;"
                  f" the parent's handoff calls over (c) (calls, s; "
                  f"@thread: on that pod client's thread): {clock}; "
                  f"decode pods' client-side tick "
                  f"round trip median while both decode pods hold rows: "
                  + ", ".join(f"{n} {np.median(v):.2f} ms over {len(v)}"
                              for n, v in both.items())
                  + f" (phase 8 (c), two engine threads in one process: "
                  + ", ".join(f"{n} {v:.2f} ms"
                              for n, v in fleet_ticks.items())
                  + f"; phase 7, one engine thread alone "
                  f"{plain['tick_ms_alone']:.2f} ms); handoff bytes "
                  f"{wire1['handoff_bytes_total'] - wire0['handoff_bytes_total']}"
                  f"; one {c_prompts[0].size + 1}-position bf16 chain on "
                  f"the wire: {nbytes} JSON bytes, serialize "
                  f"{enc_ms:.2f} ms, deserialize {dec_ms:.2f} ms (host, "
                  f"median of {POD_CODEC_REPEATS}); pods' ready times "
                  f"{ready} s; card memory the pods hold beyond the "
                  f"parent's: {used_up:.2f} GiB for {len(clients)} pods "
                  f"once up, {used_c:.2f} GiB for the {len(others)} left "
                  f"after (c) ({used_c / len(others):.2f} a pod); "
                  f"nvidia-smi compute apps "
                  f"{apps} [{card}]", flush=True)
            if any(r.error is not None for r in reqs):
                raise AssertionError("a request of (c) failed")
        finally:
            for c in clients.values():
                c.kill(timeout_s=5.0)
                c._kill_process()
    if any(c.proc.poll() is None for c in clients.values()):
        raise AssertionError("a pod outlived phase 9")
    print(f"phase 9 took {time.perf_counter() - t_phase:.1f}s [{card}]",
          flush=True)
    del sd
    gc.collect()
    torch.cuda.empty_cache()
    return launches


# ------------------------------------------------------------- phase 11


def phase_artifacts(card: str) -> int:
    """Phase 11: the predictor's artifacts on the card, (a)-(d) of the
    module docstring. Returns flash_fwd's launches over the served runs:
    this process's, the AOT process's and the server subprocess's."""
    import torch

    from kubeflow_tpu_torch.models.bert import (
        BertConfig,
        BertForSequenceClassification,
    )
    from kubeflow_tpu_torch.models.gpt import GPTConfig, GPTLM
    from kubeflow_tpu_torch.serving.model import save_predictor
    from kubeflow_tpu_torch.train.data import synthetic_text_dataset

    t_phase = time.perf_counter()
    gcfg = GPTConfig.small(attention="flash", dtype="float32")
    gpt_sd = GPTLM(gcfg, device="cuda").init_weights(
        torch.Generator().manual_seed(SEED)).state_dict()  # phase 4's
    prompts = np.random.RandomState(SEED + 61).randint(
        1, gcfg.vocab_size, (GEN_BATCH, GEN_PROMPT)).astype(np.int32)
    bcfg = BertConfig.base(attention="flash", dtype="bfloat16",
                           dropout_rate=0.0)
    bert_sd = BertForSequenceClassification(bcfg, 2, device="cuda"
                                            ).init_weights(
        torch.Generator().manual_seed(SEED + 11)).state_dict()
    x_bert = synthetic_text_dataset(
        n_train=FAM_BERT_BATCH, n_test=FAM_BERT_BATCH, seq_len=FAM_BERT_LEN,
        vocab_size=bcfg.vocab_size, num_classes=2, seed=SEED + 11).x_test
    gkw = {"size": "small", "config": {"attention": "flash",
                                       "dtype": "float32"}}
    bkw = {"size": "base", "num_classes": 2, "config": {
        "attention": "flash", "dtype": "bfloat16", "dropout_rate": 0.0}}
    n_layers = gcfg.num_layers
    with tempfile.TemporaryDirectory() as tmp:
        launches = art_int8(tmp, gpt_sd, prompts, gkw, n_layers, card)
        gdir = save_predictor(f"{tmp}/gpt-aot", "gpt-lm", gpt_sd, prompts,
                              generate={"max_new_tokens": GEN_NEW,
                                        "temperature": 0.0}, **gkw)
        bdir = save_predictor(f"{tmp}/bert-aot", "bert-classifier", bert_sd,
                              x_bert, **bkw)
        eager, n = art_eager(gdir, bdir, prompts, x_bert, n_layers, card)
        launches += n
        cache = f"{tmp}/kernel-cache"
        launches += art_aot(tmp, gdir, bdir, cache, prompts, x_bert, eager,
                            n_layers, card)
        launches += art_server(tmp, gpt_sd, bert_sd, bkw, prompts, x_bert,
                               eager, cache, n_layers, card)
        art_pods(tmp, gpt_sd, prompts, card)
    del gpt_sd, bert_sd
    gc.collect()
    torch.cuda.empty_cache()
    print(f"phase 11 took {time.perf_counter() - t_phase:.1f}s; flash_fwd "
          f"launches over its served runs {launches} [{card}]", flush=True)
    return launches


def art_int8(tmp: str, sd, prompts, kw: dict, n_layers: int,
             card: str) -> int:
    """(a) int8 artifacts. GPT-2 small (phase 4's seeded random weights):
    the float and the int8 dir both served, the int8 weights read back
    within half an int8 step of the float ones, the logits' relative error
    and top-1 agreement printed (random logits have no margins: no limit
    on them); MnistMLP trained one epoch, the JAX package's test's model:
    the int8 dir under 1/2.5 of the float one and its served classes
    agreeing with the float dir's on >= ART_TOP1 of the test images."""
    import contextlib
    import io

    import torch

    from kubeflow_tpu_torch.models.mnist import MnistMLP
    from kubeflow_tpu_torch.serving.model import (
        CONFIG_FILE,
        PARAMS_FILE,
        TorchModel,
        read_params,
        save_predictor,
    )
    from kubeflow_tpu_torch.train.data import synthetic_image_dataset
    from kubeflow_tpu_torch.train.trainer import Trainer, TrainerConfig

    def served_pair(name, weights, x, example, **family_kw):
        """The float and int8 dirs of `weights`, each served: (outputs,
        params.npz bytes, load seconds, dirs)."""
        out, size, load_s, dirs = {}, {}, {}, {}
        for tag, q in (("float", False), ("int8", True)):
            dirs[tag] = save_predictor(f"{tmp}/{name}-{tag}", name, weights,
                                       example, quantize=q, **family_kw)
            size[tag] = os.path.getsize(dirs[tag] / PARAMS_FILE)
            t0 = time.perf_counter()
            m = TorchModel(tag, dirs[tag], device="cuda")
            m.load()
            load_s[tag] = time.perf_counter() - t0
            zero_launches()
            out[tag] = m.predict(x)
            out[f"{tag}_launches"] = flash_launches()
            del m
        return out, size, load_s, dirs

    # ---- GPT-2 small at full width
    out, size, load_s, dirs = served_pair("gpt-lm", sd, prompts, prompts,
                                          **kw)
    launches = out["float_launches"] + out["int8_launches"]
    f, q = out["float"], out["int8"]
    rel = float(np.abs(q - f).max() / np.abs(f).max())
    top1 = float((f.argmax(-1) == q.argmax(-1)).mean())
    float_w, int8_w = (read_params(d, json.loads(
        (d / CONFIG_FILE).read_text())) for d in dirs.values())
    worst, n_quantized = 0.0, 0
    for k, w in float_w.items():
        err = float(np.abs(int8_w[k] - w).max())
        if err:  # a quantized leaf: half a step of its scale at most
            n_quantized += 1
            worst = max(worst, err / (np.abs(w).max() / 127.0 / 2))
    print(f"phase 11 (a) int8, GPT-2 small (f32, seeded random weights): "
          f"params.npz {size['float']} bytes (f32), {size['int8']} bytes "
          f"(int8, {size['float'] / size['int8']:.2f}x smaller); load and "
          f"warm-up {load_s['float']:.2f}s / {load_s['int8']:.2f}s; "
          f"{n_quantized} leaves quantized, each read back within "
          f"{worst:.4f} half-steps of the float one (limit 1); logits of "
          f"{prompts.shape} prompts: max |int8 - f32| / max |f32| "
          f"{rel:.3e}, top-1 agreement {top1:.4f} over "
          f"{f.shape[0] * f.shape[1]} positions (near-ties of random "
          f"logits: no limit); flash_fwd launches {out['float_launches']} "
          f"+ {out['int8_launches']} [{card}]", flush=True)
    if (not np.isfinite(q).all() or q.shape != f.shape
            or worst > 1 + 1e-5 or n_quantized != 2 + 6 * n_layers
            or out["float_launches"] != n_layers
            or out["int8_launches"] != n_layers):
        raise AssertionError(f"GPT-2 int8 artifact: {worst} half-steps, "
                             f"{n_quantized} leaves, launches {launches}")
    del out, f, q, float_w, int8_w
    gc.collect()
    torch.cuda.empty_cache()
    # ---- MnistMLP, trained one epoch (the JAX package's test's setting)
    ds = synthetic_image_dataset(n_train=FAM_MNIST_TRAIN,
                                 n_test=FAM_MNIST_TEST, shape=(28, 28, 1),
                                 num_classes=10, seed=SEED + 3)
    mlp = MnistMLP(784, device="cuda").init_weights(
        torch.Generator().manual_seed(SEED + 3))
    trainer = Trainer(mlp, TrainerConfig(batch_size=128, epochs=1,
                                         learning_rate=1e-3, seed=SEED))
    with contextlib.redirect_stdout(io.StringIO()):
        _, final = trainer.fit(ds)
    out, size, _, _ = served_pair("mnist-mlp", mlp.state_dict(), ds.x_test,
                                  ds.x_test[:4])
    agree = float((out["float"].argmax(-1) == out["int8"].argmax(-1)).mean())
    print(f"  (a) int8, MnistMLP trained one epoch (eval accuracy "
          f"{final['final_accuracy']:.4f}): params.npz {size['float']} "
          f"bytes (f32), {size['int8']} bytes (int8, "
          f"{size['float'] / size['int8']:.2f}x smaller, limit 2.5x); "
          f"served classes of the {len(ds.x_test)} test images agree on "
          f"{agree:.4f} (limit {ART_TOP1}) [{card}]", flush=True)
    if agree < ART_TOP1 or size["int8"] * 2.5 >= size["float"]:
        raise AssertionError(f"MnistMLP int8 artifact: agreement {agree}, "
                             f"bytes {size}")
    return launches


def art_eager(gdir, bdir, prompts, x_bert, n_layers: int,
              card: str) -> tuple[dict, int]:
    """The eager predictors of (b)'s two dirs, before any artifact is
    written: GPT-2 small's greedy tokens and BERT-base's logits, the
    reference the artifacts must give."""
    from kubeflow_tpu_torch.serving.model import TorchModel

    out = {}
    zero_launches()
    for name, d, x in (("gpt", gdir, prompts), ("bert", bdir, x_bert)):
        m = TorchModel(name, d, device="cuda")
        m.load()
        out[name] = m.predict(x)
        del m
    launches = flash_launches()
    if launches != 4 * n_layers:  # a warm-up and a request each
        raise AssertionError(f"eager predictors launched flash_fwd "
                             f"{launches} times, expected {4 * n_layers}")
    return out, launches


def art_aot(tmp: str, gdir, bdir, cache: str, prompts, x_bert, eager: dict,
            n_layers: int, card: str) -> int:
    """(b) export both predictors with a fresh compile cache, then serve the
    artifacts from a new process pointed at the cache."""
    from kubeflow_tpu_torch.kernels.build import sources
    from kubeflow_tpu_torch.serving.aot import AOT_FILE, export_predictor
    from kubeflow_tpu_torch.utils.compile_cache import compile_counts
    from kubeflow_tpu_torch.utils.envvars import ENV_SERVING_COMPILE_CACHE

    nvcc0 = compile_counts()["nvcc_runs_total"]
    took = {}
    for name, d in (("gpt", gdir), ("bert", bdir)):
        t0 = time.perf_counter()
        export_predictor(d, compile_cache=cache, device="cuda")
        took[name] = time.perf_counter() - t0
    nvcc = compile_counts()["nvcc_runs_total"] - nvcc0
    print(f"phase 11 (b) AOT: export_predictor with a fresh compile cache: "
          f"GPT-2 small greedy generate ({prompts.shape} prompts, {GEN_NEW} "
          f"new tokens, f32) {took['gpt']:.1f}s, artifact "
          f"{os.path.getsize(gdir / AOT_FILE)} bytes; BERT-base classifier "
          f"({x_bert.shape}, bf16) {took['bert']:.1f}s, artifact "
          f"{os.path.getsize(bdir / AOT_FILE)} bytes; nvcc runs building "
          f"the cache {nvcc} [{card}]", flush=True)
    np.save(f"{tmp}/prompts.npy", prompts)
    np.save(f"{tmp}/x_bert.npy", x_bert)
    here = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-c",
         f"import chip_smoke as c; c.aot_child({str(gdir)!r}, "
         f"{str(bdir)!r}, {tmp!r})"],
        cwd=here, env={**os.environ, ENV_SERVING_COMPILE_CACHE: cache},
        capture_output=True, text=True, timeout=900)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"the AOT process failed: {proc.stderr[-4000:]}")
    run = json.loads(proc.stdout.strip().splitlines()[-1])
    tokens = np.asarray(run["tokens"])
    logits = np.asarray(run["logits"], np.float32)
    ulps = bf16_ulps(logits, eager["bert"])
    same = tokens.shape == eager["gpt"].shape and bool(
        (tokens == eager["gpt"]).all())
    mapped = run["maps"]
    from_cache = bool(mapped) and all(
        p.startswith(os.path.realpath(cache)) for p in mapped)
    print(f"  (b) a new process with {ENV_SERVING_COMPILE_CACHE} set: nvcc "
          f"runs {run['counts']['nvcc_runs_total']}, libraries loaded "
          f"{run['counts']['libraries_loaded_total']} in "
          f"{run['lib_s']:.2f}s; libflash_fwd mapped from {mapped} (the "
          f"cache dir: {from_cache}); cold start, artifact (load + warm-up "
          f"run) against a rebuild (module, params, warm-up) with the "
          f"libraries loaded: GPT-2 generate {run['gpt_load_s']:.2f}s vs "
          f"{run['gpt_rebuild_s']:.2f}s, BERT {run['bert_load_s']:.2f}s vs "
          f"{run['bert_rebuild_s']:.2f}s; flash_fwd launches: warm-up "
          f"{run['gpt_warm']} + generate request {run['gpt_req']} (one "
          f"prefill), BERT warm-up {run['bert_warm']} + request "
          f"{run['bert_req']}; generate request {run['gpt_req_s'] * 1e3:.1f}"
          f" ms (eager {run['gpt_eager_req_s'] * 1e3:.1f} ms); tokens equal "
          f"to the eager predictor's: {same}; BERT logits vs eager "
          f"{ulps:.2f} bf16 ulps (limit {BF16_ULPS}); the process took "
          f"{wall:.1f}s with the interpreter [{card}]", flush=True)
    if (run["counts"]["nvcc_runs_total"] != 0 or nvcc != len(sources())
            or run["counts"]["libraries_loaded_total"] != len(sources())
            or not from_cache or not same or ulps > BF16_ULPS
            or run["gpt_req"] != n_layers or run["bert_req"] != n_layers
            or run["gpt_warm"] != n_layers or run["bert_warm"] != n_layers):
        raise AssertionError(f"AOT artifacts: {run}")
    return sum(run[k] for k in ("gpt_warm", "gpt_req", "bert_warm",
                                "bert_req"))


def aot_child(gdir: str, bdir: str, tmp: str) -> None:
    """(b)'s serving process: the kernel libraries from the cache the
    environment names, both artifacts served (no model module built), the
    rebuilt predictors timed after them. Its last line: the counts, maps,
    launches, times and outputs as JSON."""
    import torch

    from kubeflow_tpu_torch.serving.aot import _compile_cache_on
    from kubeflow_tpu_torch.serving.model import TorchModel, _load_predict_fn
    from kubeflow_tpu_torch.utils.compile_cache import compile_counts
    from kubeflow_tpu_torch.utils.envvars import ENV_SERVING_COMPILE_CACHE

    torch.backends.cuda.matmul.allow_tf32 = False
    out = {}
    t0 = time.perf_counter()
    _compile_cache_on(os.environ[ENV_SERVING_COMPILE_CACHE])
    out["lib_s"] = time.perf_counter() - t0
    inputs = {"gpt": np.load(f"{tmp}/prompts.npy"),
              "bert": np.load(f"{tmp}/x_bert.npy")}
    for name, d in (("gpt", gdir), ("bert", bdir)):
        zero_launches()
        t0 = time.perf_counter()
        m = TorchModel(name, d, device="cuda")
        m.load()
        out[f"{name}_load_s"] = time.perf_counter() - t0
        if m._aot_batch is None:
            raise AssertionError(f"{d}: the artifact was not taken")
        out[f"{name}_warm"] = flash_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = m.predict(inputs[name])
        out[f"{name}_req_s"] = time.perf_counter() - t0
        out[f"{name}_req"] = flash_launches() - out[f"{name}_warm"]
        out["tokens" if name == "gpt" else "logits"] = got.tolist()
        del m
    out["counts"] = compile_counts()
    with open("/proc/self/maps") as fh:
        out["maps"] = sorted({line.split()[-1] for line in fh
                              if "libflash_fwd" in line})
    for name, d in (("gpt", gdir), ("bert", bdir)):
        t0 = time.perf_counter()
        fn, config, example = _load_predict_fn(d, "cuda")
        fn(torch.as_tensor(example, device="cuda"))
        torch.cuda.synchronize()
        out[f"{name}_rebuild_s"] = time.perf_counter() - t0
        if name == "gpt":
            x = torch.as_tensor(inputs["gpt"], device="cuda")
            t0 = time.perf_counter()
            fn(x).cpu()
            out["gpt_eager_req_s"] = time.perf_counter() - t0
        del fn
    print(json.dumps(out))


class _Lines:
    """A subprocess's merged output, drained by a thread into a list (a
    full pipe would stall the child), with a wait for a matching line."""

    def __init__(self, proc):
        import threading

        self.lines: list[str] = []
        self._thread = threading.Thread(target=self._drain, args=(proc,),
                                        daemon=True)
        self._thread.start()

    def _drain(self, proc) -> None:
        for line in proc.stdout:
            self.lines.append(line.rstrip())

    def wait_for(self, pattern: str, timeout_s: float):
        import re

        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            for line in list(self.lines):
                found = re.search(pattern, line)
                if found:
                    return found
            if not self._thread.is_alive():
                break
            time.sleep(0.2)
        raise AssertionError(f"no line matching {pattern!r}: "
                             f"{self.lines[-40:]}")


def metric_values(url: str, name: str) -> dict:
    """{label set: value} of one metric on a server's /metrics."""
    import re

    with urllib.request.urlopen(f"{url}/metrics", timeout=60) as resp:
        text = resp.read().decode()
    return {m.group(1): float(m.group(2)) for m in re.finditer(
        rf"^{name}\{{([^}}]*)\}} (\S+)$", text, re.MULTILINE)}


def art_server(tmp: str, gpt_sd, bert_sd, bkw: dict, prompts, x_bert,
               eager: dict, cache: str, n_layers: int, card: str) -> int:
    """(c) the model server as a subprocess: a BERT-base dir pulled from a
    PVC, exported at load (--aot), micro-batched; a continuous GPT-2 small
    loaded and unloaded through the repository API."""
    import threading

    from kubeflow_tpu_torch.serving.aot import AOT_META
    from kubeflow_tpu_torch.serving.model import save_predictor
    from kubeflow_tpu_torch.utils.envvars import (
        ENV_PVC_ROOT,
        ENV_SERVING_COMPILE_CACHE,
    )

    pvc = f"{tmp}/pvc"
    save_predictor(f"{pvc}/vol/bert", "bert-classifier", bert_sd, x_bert,
                   **bkw)
    cont_new = 8
    save_predictor(f"{pvc}/vol/gpt-cont", "gpt-lm", gpt_sd, prompts[:1],
                   generate={"max_new_tokens": cont_new, "continuous": True,
                             "continuous_rows": 4},
                   size="small", config={"attention": "flash",
                                         "dtype": "bfloat16"})
    here = os.path.dirname(os.path.abspath(__file__))
    env = {**os.environ, ENV_PVC_ROOT: pvc, ENV_SERVING_COMPILE_CACHE: cache}
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "kubeflow_tpu_torch.serving.server",
         "--model-name", "bert", "--storage-uri", "pvc://vol/bert",
         "--model-dir", f"{tmp}/served", "--repository-dir", f"{tmp}/repo",
         "--device", "cuda", "--aot", "--max-batch-size", str(ART_MAX_BATCH),
         "--batch-max-latency-ms", str(ART_BATCH_WAIT_MS), "--port", "0"],
        cwd=here, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    try:
        out = _Lines(proc)
        url = out.wait_for(r"server ready url=(\S+)", 900).group(1)
        up = time.perf_counter() - t0
        meta = json.loads(open(f"{tmp}/served/bert/{AOT_META}").read())
        with open(f"/proc/{proc.pid}/maps") as fh:
            mapped = sorted({line.split()[-1] for line in fh
                             if "libflash_fwd" in line})
        before = (metric_values(url, "kfserving_batcher_batches_total"),
                  metric_values(url, "kftpu_kernel_launches_total"))
        answers = [None] * ART_REQUESTS

        def one(i):
            answers[i] = post(f"{url}/v1/models/bert:predict",
                              {"instances": x_bert[i:i + 1].tolist()})

        threads = [threading.Thread(target=one, args=(i,))
                   for i in range(ART_REQUESTS)]
        t1 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        wall = time.perf_counter() - t1
        after = (metric_values(url, "kfserving_batcher_batches_total"),
                 metric_values(url, "kftpu_kernel_launches_total"))
        requests = metric_values(url, "kfserving_batcher_requests_total")
        key, kern = 'model="bert"', 'kernel="flash_fwd"'
        batches = after[0][key] - before[0][key]
        launches = int(after[1][kern] - before[1][kern])
        codes = [a[0] for a in answers]
        got = np.concatenate([np.asarray(a[1]["logits"], np.float32)
                              for a in answers])
        ulps = bf16_ulps(got, eager["bert"][:ART_REQUESTS])
        print(f"phase 11 (c) python -m kubeflow_tpu_torch.serving.server "
              f"--storage-uri pvc://vol/bert --aot --max-batch-size "
              f"{ART_MAX_BATCH}: ready in {up:.1f}s (pull, export, load; "
              f"aot.json platforms {meta['platforms']}), libflash_fwd "
              f"mapped from {mapped}; {ART_REQUESTS} concurrent one-row v1 "
              f"requests in {wall * 1e3:.1f} ms: codes {codes}, "
              f"{int(batches)} coalesced forwards for "
              f"{int(requests[key])} requests, flash_fwd launches "
              f"{launches}; logits vs (b)'s eager ones {ulps:.2f} bf16 ulps "
              f"[{card}]", flush=True)
        if (codes != [200] * ART_REQUESTS or not 0 < batches < ART_REQUESTS
                or launches != n_layers * batches or ulps > BF16_ULPS
                or meta["platforms"] != ["cuda"]
                or not all(p.startswith(os.path.realpath(cache))
                           for p in mapped) or not mapped):
            raise AssertionError(f"served BERT: codes {codes}, batches "
                                 f"{batches}, launches {launches}, ulps "
                                 f"{ulps}, {meta}, {mapped}")
        # ---- the repository API: a continuous GPT-2 small
        code, body, load_wall = post(
            f"{url}/v2/repository/models/gpt-cont/load",
            {"storage_uri": "pvc://vol/gpt-cont"})
        if code != 200:
            raise AssertionError(f"repository load: {code} {body}")
        code, body, req_wall = post(f"{url}/v1/models/gpt-cont:predict",
                                    {"instances": prompts[:1].tolist()})
        rows = metric_values(url, "kfserving_engine_rows_total")
        steps = metric_values(url, "kfserving_engine_decode_dispatches_total")
        code_u, _, _ = post(f"{url}/v2/repository/models/gpt-cont/unload",
                            {})
        left = metric_values(url, "kfserving_engine_rows_total")
        print(f"  (c) repository API: gpt-cont (continuous, bf16) loaded "
              f"from pvc://vol/gpt-cont in {load_wall:.1f}s; a "
              f"{prompts[:1].shape} request -> {code} in "
              f"{req_wall * 1e3:.1f} ms, {len(body['predictions'][0])} "
              f"tokens; /metrics engine gauges rows_total {rows}, "
              f"decode_dispatches_total {steps}; unload -> {code_u}, gauges "
              f"left {left} [{card}]", flush=True)
        if (code != 200 or len(body["predictions"][0]) != cont_new
                or rows != {'model="gpt-cont"': 4.0}
                or not steps.get('model="gpt-cont"') or code_u != 200
                or left):
            raise AssertionError(f"repository engine: {rows} {steps} {left}")
        return launches
    finally:
        proc.terminate()
        try:
            proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=30)


def art_pods(tmp: str, sd, prompts, card: str) -> None:
    """(d) one pod spawned, killed and spawned again over one fresh
    compile_cache_dir: the first builds the kernel libraries into it, the
    respawn runs nvcc zero times; both map libflash_fwd from it."""
    import dataclasses
    import re
    from pathlib import Path

    from kubeflow_tpu_torch.convert import flax_params_from_gpt
    from kubeflow_tpu_torch.kernels.build import sources
    from kubeflow_tpu_torch.models.gpt import GPTConfig
    from kubeflow_tpu_torch.serving.fleet import PagedKVPool, spawn_pod

    cfg = GPTConfig.small(attention="flash", dtype="bfloat16")
    np.savez(f"{tmp}/pod-params.npz", **flax_params_from_gpt(sd, cfg))
    pod_cache = f"{tmp}/pod-cache"
    spec = {"model": dataclasses.asdict(cfg), "device": "cuda",
            "params": f"{tmp}/pod-params.npz", "max_rows": 4,
            "default_max_new_tokens": 8, "eos_token_id": None, "seed": SEED,
            "prefill_chunk": 0, "compile_cache_dir": pod_cache,
            "pool": {"block_size": ENGINE_BLOCK, "capacity_blocks": 64},
            "warmup_prompts": [prompts[0].tolist()], "warmup_new_tokens": 2}
    state = f"{tmp}/pods"
    runs = []
    for i in range(2):
        name = f"cached-{i}"
        c = spawn_pod(name, spec, state,
                      home_pool=PagedKVPool(ENGINE_BLOCK, 64))
        try:
            with open(f"/proc/{c.worker_pid}/maps") as fh:
                mapped = sorted({line.split()[-1] for line in fh
                                 if "libflash_fwd" in line})
        finally:
            c.kill(timeout_s=5.0)
            c._kill_process()
        text = Path(state, f"{name}.stderr.log").read_text()
        found = re.search(r"ready in ([0-9.]+)s .*compile_counts=(\{.*\})",
                          text)
        if found is None:
            raise AssertionError(f"pod {name} never reported ready: {text}")
        runs.append((float(found.group(1)), json.loads(found.group(2)),
                     mapped))
    for i, (ready, counts, mapped) in enumerate(runs):
        print(f"phase 11 (d) pod spawn {i + 1} over one compile_cache_dir: "
              f"ready in {ready:.2f}s, nvcc runs "
              f"{counts['nvcc_runs_total']}, libraries loaded "
              f"{counts['libraries_loaded_total']}, libflash_fwd mapped "
              f"from {mapped} [{card}]", flush=True)
    n_src = len(sources())
    real = os.path.realpath(pod_cache)
    if (runs[0][1]["nvcc_runs_total"] != n_src
            or runs[1][1]["nvcc_runs_total"] != 0
            or any(counts["libraries_loaded_total"] != n_src
                   or not mapped or not all(p.startswith(real)
                                            for p in mapped)
                   for _, counts, mapped in runs)):
        raise AssertionError(f"pods over a compile cache: {runs}")

# ---------------------------------------------------------------- phase 12


def cli(*args, timeout: int = 900) -> subprocess.CompletedProcess:
    """``python -m kubeflow_tpu_torch ARGS`` from the repository root, as
    a user runs it (on the card: --device defaults to cuda); raises with
    its output if it fails."""
    root = os.path.dirname(os.path.abspath(__file__))
    out = subprocess.run([sys.executable, "-m", "kubeflow_tpu_torch",
                          *map(str, args)], cwd=root, capture_output=True,
                         text=True, timeout=timeout)
    if out.returncode != 0:
        raise AssertionError(f"kubeflow_tpu_torch {args[0]} exited "
                             f"{out.returncode}:\n{out.stdout}\n{out.stderr}")
    return out


def generate_report(out: subprocess.CompletedProcess) -> dict:
    """The CLI generate's stderr line: its tokens and kernel launches."""
    line = next(x for x in out.stderr.splitlines()
                if x.startswith("[generate] "))
    return json.loads(line[len("[generate] "):])


def seeded_normal(shape, gen, std=0.02, mean=0.0):
    import torch

    return torch.randn(shape, generator=gen) * std + mean


def gpt2_hf_state_dict(cfg, seed: int) -> dict:
    """A GPT2LMHeadModel state dict (HF's keys, Conv1D (in, out) weights,
    the head tied to wte) at cfg's shapes, from a seed: weights N(0, 0.02),
    biases N(0, 0.02), LayerNorm scales 1 + N(0, 0.02)."""
    import torch

    g = torch.Generator().manual_seed(seed)
    h, v = cfg.hidden_size, cfg.vocab_size
    sd = {"wte.weight": seeded_normal((v, h), g),
          "wpe.weight": seeded_normal((cfg.max_len, h), g)}
    for i in range(cfg.num_layers):
        p = f"h.{i}."
        for ln in ("ln_1", "ln_2"):
            sd[p + ln + ".weight"] = seeded_normal((h,), g, mean=1.0)
            sd[p + ln + ".bias"] = seeded_normal((h,), g)
        for name, (n_in, n_out) in (("attn.c_attn", (h, 3 * h)),
                                    ("attn.c_proj", (h, h)),
                                    ("mlp.c_fc", (h, cfg.mlp_dim)),
                                    ("mlp.c_proj", (cfg.mlp_dim, h))):
            sd[p + name + ".weight"] = seeded_normal((n_in, n_out), g)
            sd[p + name + ".bias"] = seeded_normal((n_out,), g)
    sd["ln_f.weight"] = seeded_normal((h,), g, mean=1.0)
    sd["ln_f.bias"] = seeded_normal((h,), g)
    out = {"transformer." + k: t for k, t in sd.items()}
    out["lm_head.weight"] = out["transformer.wte.weight"]
    return out


def gpt2_plain_logits(sd: dict, ids, n_layer: int, n_head: int,
                      eps: float = 1e-6):
    """GPT-2's forward written out over an HF GPT2LMHeadModel state dict
    (on ids' device, float32), independent of the port's modules and its
    importer: the reference the imported dir's logits are held to. eps is
    the models' LayerNorm eps (the JAX package's, and so the import's)."""
    import torch
    import torch.nn.functional as F

    w = {k.removeprefix("transformer."): t.to(ids.device)
         for k, t in sd.items()}
    b, l = ids.shape
    h = w["wte.weight"][ids] + w["wpe.weight"][:l]
    hid = h.shape[-1]
    hd = hid // n_head
    causal = torch.ones(l, l, dtype=torch.bool, device=ids.device).tril()
    for i in range(n_layer):
        p = f"h.{i}."
        a = F.layer_norm(h, (hid,), w[p + "ln_1.weight"], w[p + "ln_1.bias"],
                         eps)
        qkv = a @ w[p + "attn.c_attn.weight"] + w[p + "attn.c_attn.bias"]
        q, k, v = (t.view(b, l, n_head, hd).transpose(1, 2)
                   for t in qkv.split(hid, dim=-1))
        s = (q @ k.transpose(-1, -2)) / math.sqrt(hd)
        s = s.masked_fill(~causal, -1e9).softmax(-1)
        y = (s @ v).transpose(1, 2).reshape(b, l, hid)
        h = h + y @ w[p + "attn.c_proj.weight"] + w[p + "attn.c_proj.bias"]
        m = F.layer_norm(h, (hid,), w[p + "ln_2.weight"], w[p + "ln_2.bias"],
                         eps)
        m = F.gelu(m @ w[p + "mlp.c_fc.weight"] + w[p + "mlp.c_fc.bias"],
                   approximate="tanh")
        h = h + m @ w[p + "mlp.c_proj.weight"] + w[p + "mlp.c_proj.bias"]
    h = F.layer_norm(h, (hid,), w["ln_f.weight"], w["ln_f.bias"], eps)
    return h @ w["wte.weight"].T


def byte_bpe_files(d: str, corpus: str, n_merges: int) -> tuple[str, str]:
    """A GPT-2 vocab.json / merges.txt pair made here: the 256 byte
    symbols of bytes_to_unicode, n_merges merges learned from ``corpus``
    (most frequent pair of GPT-2's pre-tokens first, ties by the pair), and
    <|endoftext|>."""
    from collections import Counter

    from kubeflow_tpu_torch.train.bpe_gpt2 import _PRETOK, bytes_to_unicode

    b2u = bytes_to_unicode()
    vocab = {u: i for i, u in enumerate(b2u.values())}
    words = Counter(tuple(b2u[c] for c in pre.encode("utf-8"))
                    for pre in _PRETOK.findall(corpus))
    merges = []
    while len(merges) < n_merges:
        pairs = Counter()
        for w, n in words.items():
            for pair in zip(w, w[1:]):
                pairs[pair] += n
        if not pairs:
            break
        (a, b), _ = min(pairs.items(), key=lambda kv: (-kv[1], kv[0]))
        merges.append((a, b))
        vocab.setdefault(a + b, len(vocab))
        merged = Counter()
        for w, n in words.items():
            out, i = [], 0
            while i < len(w):
                if i + 1 < len(w) and (w[i], w[i + 1]) == (a, b):
                    out.append(a + b)
                    i += 2
                else:
                    out.append(w[i])
                    i += 1
            merged[tuple(out)] += n
        words = merged
    vocab["<|endoftext|>"] = len(vocab)
    with open(f"{d}/vocab.json", "w", encoding="utf-8") as fh:
        json.dump(vocab, fh)
    with open(f"{d}/merges.txt", "w", encoding="utf-8") as fh:
        fh.write("#version: 0.2\n"
                 + "".join(f"{a} {b}\n" for a, b in merges))
    return f"{d}/vocab.json", f"{d}/merges.txt"


def llama_hf_state_dict(seed: int) -> tuple[dict, dict]:
    """A LlamaForCausalLM state dict at TinyLlama-1.1B's published widths
    (hidden 2048, 32 heads, 4 KV heads, intermediate 5632, vocab 32000,
    untied head) with LLAMA_LAYERS of its 22 layers, from a seed; and the
    HF config fields the blob carries."""
    import torch

    g = torch.Generator().manual_seed(seed)
    d = LLAMA_DIMS
    h, kvh, mlp, vocab = d["hidden"], d["kv_heads"], d["mlp"], d["vocab"]
    hd = h // d["heads"]
    sd = {"model.embed_tokens.weight": seeded_normal((vocab, h), g),
          "model.norm.weight": seeded_normal((h,), g, mean=1.0),
          "lm_head.weight": seeded_normal((vocab, h), g)}
    for i in range(LLAMA_LAYERS):
        p = f"model.layers.{i}."
        for name, shape in (("self_attn.q_proj", (h, h)),
                            ("self_attn.k_proj", (kvh * hd, h)),
                            ("self_attn.v_proj", (kvh * hd, h)),
                            ("self_attn.o_proj", (h, h)),
                            ("mlp.gate_proj", (mlp, h)),
                            ("mlp.up_proj", (mlp, h)),
                            ("mlp.down_proj", (h, mlp))):
            sd[p + name + ".weight"] = seeded_normal(shape, g)
        for ln in ("input_layernorm", "post_attention_layernorm"):
            sd[p + ln + ".weight"] = seeded_normal((h,), g, mean=1.0)
    config = {"num_attention_heads": d["heads"], "num_key_value_heads": kvh,
              "hidden_act": "silu", "rope_theta": d["rope_theta"],
              "rms_norm_eps": d["rms_eps"],
              "max_position_embeddings": d["positions"],
              "tie_word_embeddings": False, "eos_token_id": 2}
    return sd, config


def bert_hf_state_dict(seed: int, classes: int = 2) -> dict:
    """A BertForSequenceClassification state dict (HF's keys, torch Linear
    (out, in)) at BERT-base's shapes, from a seed."""
    import torch

    g = torch.Generator().manual_seed(seed)
    h, mlp = BERT_DIMS["hidden"], BERT_DIMS["mlp"]
    sd = {"bert.embeddings.word_embeddings.weight":
          seeded_normal((BERT_DIMS["vocab"], h), g),
          "bert.embeddings.position_embeddings.weight":
          seeded_normal((BERT_DIMS["positions"], h), g),
          "bert.embeddings.token_type_embeddings.weight":
          seeded_normal((2, h), g),
          "bert.embeddings.LayerNorm.weight": seeded_normal((h,), g,
                                                            mean=1.0),
          "bert.embeddings.LayerNorm.bias": seeded_normal((h,), g)}
    for i in range(BERT_DIMS["layers"]):
        p = f"bert.encoder.layer.{i}."
        for name, (o, n) in (("attention.self.query", (h, h)),
                             ("attention.self.key", (h, h)),
                             ("attention.self.value", (h, h)),
                             ("attention.output.dense", (h, h)),
                             ("intermediate.dense", (mlp, h)),
                             ("output.dense", (h, mlp))):
            sd[p + name + ".weight"] = seeded_normal((o, n), g)
            sd[p + name + ".bias"] = seeded_normal((o,), g)
        for ln in ("attention.output.LayerNorm", "output.LayerNorm"):
            sd[p + ln + ".weight"] = seeded_normal((h,), g, mean=1.0)
            sd[p + ln + ".bias"] = seeded_normal((h,), g)
    sd["bert.pooler.dense.weight"] = seeded_normal((h, h), g)
    sd["bert.pooler.dense.bias"] = seeded_normal((h,), g)
    sd["classifier.weight"] = seeded_normal((classes, h), g)
    sd["classifier.bias"] = seeded_normal((classes,), g)
    return sd


def edit_model_config(model_dir: str, **config) -> None:
    """Set fields of a model dir's module config (``kwargs.config``), as a
    user picks the attention kernel and compute dtype to serve with."""
    path = f"{model_dir}/config.json"
    with open(path) as fh:
        cfg = json.load(fh)
    cfg["kwargs"].setdefault("config", {}).update(config)
    with open(path, "w") as fh:
        json.dump(cfg, fh, indent=2)


def phase_lifecycle(peaks, card: str) -> tuple[dict, dict]:
    """Phase 12: the LLM lifecycle on the card, (a)-(e) of ``lc_*``.
    Returns each kernel's launches over the path's runs (the fits, the
    CLI generate processes and the served BERT) and the dropout kernels'
    records."""
    import torch

    gc.collect()   # what earlier phases left for the collector goes first
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    launches = dict.fromkeys(FLASH_KERNELS + DROPOUT_KERNELS, 0)
    with tempfile.TemporaryDirectory() as tmp:
        gdir, prompt_text = lc_import_gpt2(tmp, card)
        lc_lora(tmp, gdir, prompt_text, launches, card)
        gc.collect()
        torch.cuda.empty_cache()
        lc_llama_bert(tmp, launches, card)
    gc.collect()
    torch.cuda.empty_cache()
    records = lc_dropout_kernels(peaks, card)
    print(f"phase 12: the LLM lifecycle in {time.perf_counter() - t_phase:.1f}"
          f"s; its path's launches {launches} [{card}]", flush=True)
    for name in launches:
        if not launches[name]:
            raise AssertionError(f"phase 12's path never launched {name}")
    return launches, records


def lc_import_gpt2(tmp: str, card: str) -> tuple[str, str]:
    """(a) A GPT2LMHeadModel-layout checkpoint at GPT-2 small's published
    shapes and a byte-level BPE made here, through ``python -m
    kubeflow_tpu_torch import-gpt2``; the dir's logits (the model built
    from it, flash_fwd, f32) against GPT-2's forward written out over the
    checkpoint, within 1e-3 (phase 4's limit). Returns the dir and a
    prompt text."""
    import dataclasses

    import torch

    from kubeflow_tpu_torch.models.gpt import GPTConfig, GPTLM
    from kubeflow_tpu_torch.serving.model import load_generative_model

    cfg = GPTConfig.small()
    t0 = time.perf_counter()
    sd = gpt2_hf_state_dict(cfg, SEED + 12)
    ckpt = f"{tmp}/gpt2.pt"
    torch.save({"state_dict": sd, "config": {
        "n_head": cfg.num_heads, "n_positions": cfg.max_len,
        "activation_function": "gelu_new"}}, ckpt)
    vocab, merges = byte_bpe_files(tmp, LLM_CORPUS, LLM_MERGES)
    made = time.perf_counter() - t0
    t0 = time.perf_counter()
    out = cli("import-gpt2", "--checkpoint", ckpt, "-o", f"{tmp}/gpt2",
              "--vocab-json", vocab, "--merges-txt", merges,
              "--max-new-tokens", LLM_NEW, "--prompt-len", LLM_PROMPT)
    took = time.perf_counter() - t0
    dense, config = load_generative_model(f"{tmp}/gpt2", device="cuda")
    flash = GPTLM(dataclasses.replace(dense.cfg, attention="flash"),
                  device="cuda")
    flash.load_state_dict(dense.state_dict())
    ids = torch.as_tensor(np.random.RandomState(SEED + 12).randint(
        1, cfg.vocab_size, (2, LLM_PROMPT)), device="cuda")
    with torch.inference_mode():
        got = flash.eval()(ids)
        want = gpt2_plain_logits(sd, ids, cfg.num_layers, cfg.num_heads)
    err = (got - want).abs().max().item()
    with open(f"{tmp}/gpt2/tokenizer.json") as fh:
        n_vocab = len(json.load(fh)["vocab"])
    print(f"phase 12 (a): GPT2LMHeadModel checkpoint at GPT-2 small's "
          f"shapes ({sum(t.numel() for t in sd.values()) - sd['lm_head.weight'].numel()}"
          f" params, made in {made:.2f}s), byte-level BPE of {n_vocab} "
          f"symbols; import-gpt2 in {took:.2f}s ({out.stdout.splitlines()[0]}"
          f"); dir config {config['kwargs']['config']['num_layers']} layers,"
          f" generate {config['generate']}; logits of 2 x {LLM_PROMPT} "
          f"tokens through flash_fwd (f32) vs GPT-2's forward over the "
          f"checkpoint: max abs err {err:.3e} (limit 1e-3) [{card}]",
          flush=True)
    if err > 1e-3 or not torch.isfinite(got).all():
        raise AssertionError(f"imported GPT-2 logits off by {err}")
    del dense, flash, sd
    return f"{tmp}/gpt2", "the server trains models and answers requests"


def lora_trainer(base, fused_steps: int, **kw):
    """LoRA (LORA_RANK, LORA_ALPHA; adapters from the seed) over ``base``
    and the Trainer of phase 12 (b)'s fit (kw overrides its config)."""
    import torch

    from kubeflow_tpu_torch.models.gpt import (
        causal_lm_eval_metrics,
        causal_lm_loss,
    )
    from kubeflow_tpu_torch.train.lora import LoraModel
    from kubeflow_tpu_torch.train.trainer import Trainer, TrainerConfig

    lora = LoraModel(base, rank=LORA_RANK, alpha=LORA_ALPHA,
                     generator=torch.Generator().manual_seed(SEED + 12))
    config = {"batch_size": LORA_BATCH, "steps": LORA_STEPS,
              "learning_rate": 1e-3, "warmup_steps": 2,
              "log_every_steps": 1, "seed": SEED,
              "fused_steps": fused_steps, **kw}
    return Trainer(lora, TrainerConfig(**config), loss_fn=causal_lm_loss,
                   eval_metrics_fn=causal_lm_eval_metrics)


def state_bytes(opt) -> int:
    """The bytes of an optimizer's state tensors."""
    import torch

    return sum(t.numel() * t.element_size() for st in opt.state.values()
               for t in st.values() if torch.is_tensor(t))


def lc_lora(tmp: str, gdir: str, prompt_text: str, launches: dict,
            card: str) -> None:
    """(b) LoRA fine-tuning of the imported model (flash, bf16 compute,
    f32 params, dropout LORA_DROPOUT) at LORA_BATCH x LORA_LEN, eagerly and
    graphed, and its checks; (c) the merged model served through ``python
    -m kubeflow_tpu_torch generate``."""
    import dataclasses

    import torch

    from kubeflow_tpu_torch.kernels import dropout as kd
    from kubeflow_tpu_torch.models.gpt import GPTLM, causal_lm_loss
    from kubeflow_tpu_torch.models.layers import DropoutSeeds
    from kubeflow_tpu_torch.serving.model import (
        load_generative_model,
        save_predictor,
    )
    from kubeflow_tpu_torch.train.data import synthetic_lm_dataset
    from kubeflow_tpu_torch.train.trainer import Trainer

    dense, config = load_generative_model(gdir, device="cuda")
    cfg = dataclasses.replace(dense.cfg, attention="flash",
                              dropout_rate=LORA_DROPOUT)
    base = GPTLM(cfg, device="cuda")
    base.load_state_dict(dense.state_dict())
    del dense
    frozen = {k: v.clone() for k, v in base.state_dict().items()}
    ds = synthetic_lm_dataset(n_train=LORA_BATCH * LORA_STEPS,
                              n_test=LORA_BATCH, seq_len=LORA_LEN,
                              vocab_size=cfg.vocab_size, seed=SEED)
    runs, trainers = {}, {}
    for fused in (1, LORA_FUSED):
        trainer = lora_trainer(base, fused)
        if trainer.compute_dtype != torch.bfloat16:
            raise AssertionError(f"AUTO resolved to {trainer.compute_dtype}")
        gc.collect()
        torch.cuda.reset_peak_memory_stats()
        zero_launches()     # the fine-tuning path's run starts here
        runs[fused] = fit_timed(trainer, ds, names=None)
        runs[fused]["peak"] = torch.cuda.max_memory_allocated() / 2**30
        add_launches(launches, runs[fused]["launches"])
        trainers[fused] = trainer
    eager, graphed = runs[1], runs[LORA_FUSED]
    n_layers = cfg.num_layers
    sites = 1 + 2 * n_layers   # the embedding's and two a block
    for what, run in (("eager", eager), ("graphed", graphed)):
        check_flash_steps(run, n_layers, f"LoRA GPT-2 small, {what}")
        for i, d in enumerate(run["dispatches"]):
            n = d["steps"] + d["warmup"]
            # the embedding's dropout has no backward: its input (frozen
            # embeddings) needs no grad
            want = {"dropout_fwd": sites * n, "dropout_bwd": (sites - 1) * n}
            got = {k: d["launches"][k] for k in want}
            if got != want:
                raise AssertionError(f"LoRA {what} dispatch {i}: dropout "
                                     f"launches {got}, expected {want}")
    equal = sum(graphed["logged"][s] == eager["logged"][s]
                for s in graphed["logged"])
    print(f"phase 12 (b): LoRA (rank {LORA_RANK}, alpha {LORA_ALPHA}) on the"
          f" imported GPT-2 small, flash, bf16 compute, f32 params, dropout "
          f"{LORA_DROPOUT}, {LORA_BATCH} x {LORA_LEN} tokens, {LORA_STEPS} "
          f"steps: eager losses {' '.join(f'{x:.4f}' for x in eager['losses'])}"
          f"; graphed (fused_steps={LORA_FUSED}) dispatches of "
          f"{[d['steps'] for d in graphed['dispatches']]} steps after "
          f"{trainers[LORA_FUSED].graph_warmups} warm-up step(s); losses "
          f"bit-equal at {equal} of {len(graphed['logged'])} logged steps; "
          f"launches per step: each flash kernel {n_layers}, dropout_fwd "
          f"{sites}, dropout_bwd {sites - 1} [{card}]", flush=True)
    check_logged_against(graphed, eager, "LoRA GPT-2 small, dropout", card)
    changed = [k for k, v in base.state_dict().items()
               if not torch.equal(v, frozen[k])]
    if changed:
        raise AssertionError(f"the fits changed base weights {changed[:3]}")
    opt_bytes = {}
    for fused, run in runs.items():
        opt = run["state"].optimizer
        lora = run["state"].model
        held = {id(p) for p in opt.state}
        if held != {id(p) for p in lora.lora.values()}:
            raise AssertionError(f"fused_steps={fused}: the optimizer holds "
                                 f"{len(held)} tensors' state, not the "
                                 f"{len(lora.lora)} adapters'")
        opt_bytes[fused] = state_bytes(opt)
    n_adapters = sum(p.numel() for p in runs[1]["state"].model.lora.values())
    tokens = LORA_BATCH * LORA_LEN
    stacked = tuple(np.stack([a[i * LORA_BATCH:(i + 1) * LORA_BATCH]
                              for i in range(LORA_FUSED)])
                    for a in (ds.x_train, ds.y_train))
    batch = tuple(torch.as_tensor(a[:LORA_BATCH], device="cuda")
                  for a in (ds.x_train, ds.y_train))
    eager_idle = profile_step(
        lambda: trainers[1].train_step(runs[1]["state"], batch),
        eager["step_ms"], card, what="LoRA step")
    graphed_idle = profile_step(
        lambda: trainers[LORA_FUSED].train_chunk(
            runs[LORA_FUSED]["state"], stacked, LORA_FUSED),
        graphed["chunk_ms"], card, what=f"LoRA chunk of {LORA_FUSED} steps")
    # one full-parameter step at the same shape, for its memory
    full = GPTLM(cfg, device="cuda")
    full.load_state_dict(frozen)
    ftrainer = Trainer(full, trainers[1].config, loss_fn=causal_lm_loss)
    gc.collect()
    torch.cuda.reset_peak_memory_stats()
    fstate, _ = ftrainer.train_step(ftrainer.init_state(), batch)
    torch.cuda.synchronize()
    full_peak = torch.cuda.max_memory_allocated() / 2**30
    full_opt = state_bytes(fstate.optimizer)
    del fstate, ftrainer, full
    print(f"  LoRA step time eager {eager['step_ms']:.2f} ms (median of "
          f"steps 4..), graphed {graphed['chunk_ms']:.2f} ms (a chunk over "
          f"its steps); {tokens / eager['step_ms'] * 1e3:.1f} vs "
          f"{tokens / graphed['chunk_ms'] * 1e3:.1f} tokens/s; idle share "
          f"of a profiled step {share(eager_idle)}, of a profiled chunk "
          f"{share(graphed_idle)}; peak memory {eager['peak']:.2f} GiB eager"
          f", {graphed['peak']:.2f} graphed; {n_adapters} adapter params, "
          f"optimizer state {opt_bytes[1]} bytes; one full-parameter step "
          f"at the same shape: peak {full_peak:.2f} GiB, optimizer state "
          f"{full_opt} bytes [{card}]", flush=True)

    # the masks: the kept share of one site, two steps' masks differ
    seeds = [DropoutSeeds(trainers[1]._step_seeds(s).cuda()).take(1, base
             .device)[0] for s in (0, 1)]
    ones = torch.ones((LORA_BATCH, LORA_LEN, cfg.hidden_size),
                      dtype=torch.bfloat16, device="cuda")
    masks = [kd.dropout_fwd(ones, s, LORA_DROPOUT, 0) != 0 for s in seeds]
    kept = masks[0].float().mean().item()
    n = masks[0].numel()
    sigma = math.sqrt(LORA_DROPOUT * (1 - LORA_DROPOUT) / n)
    differ = not torch.equal(masks[0], masks[1])
    print(f"  the embedding site's mask at steps 0 and 1: kept share "
          f"{kept:.6f} (0.9 +- 4 sigma = {4 * sigma:.6f}), the two masks "
          f"differ: {differ} [{card}]", flush=True)
    if abs(kept - (1 - LORA_DROPOUT)) > 4 * sigma or not differ:
        raise AssertionError(f"dropout masks: kept {kept}, differ {differ}")
    del masks, ones
    lc_remat_check(base, batch, trainers[1], card)

    # (c) the merged model served through the CLI
    merged = runs[1]["state"].model.merged()
    sd = {k: v.float() for k, v in merged.state_dict().items()}
    del merged
    sdir = f"{tmp}/gpt2-lora"
    kwargs = dict(config["kwargs"])
    kwargs["config"] = {**kwargs.get("config", {}), "attention": "flash"}
    save_predictor(sdir, "gpt-lm", sd, np.zeros(config["input_shape"],
                                                np.int32),
                   generate=config["generate"], **kwargs)
    with open(f"{gdir}/tokenizer.json") as src, \
            open(f"{sdir}/tokenizer.json", "w") as dst:
        dst.write(src.read())
    t0 = time.perf_counter()
    out = cli("generate", "--model-dir", sdir, "--prompt", prompt_text)
    took = time.perf_counter() - t0
    report = generate_report(out)
    toks = report["tokens"]
    from kubeflow_tpu_torch.train.bpe_gpt2 import load_any_tokenizer

    prompt = load_any_tokenizer(f"{sdir}/tokenizer.json").encode(
        prompt_text, eos=False)
    plain, _ = load_generative_model(sdir, device="cuda")
    plain = GPTLM(dataclasses.replace(plain.cfg, attention="dense"),
                  device="cuda")
    plain.load_state_dict(sd)
    gap, _ = teacher_forced_gap(plain.eval(), [np.asarray(prompt)],
                                [np.asarray(toks)])
    served = report["kernel_launches"].get("flash_fwd", 0)
    print(f"phase 12 (c): the merged model served through `python -m "
          f"kubeflow_tpu_torch generate` ({took:.2f}s): prompt of "
          f"{len(prompt)} tokens, {len(toks)} generated (eos "
          f"{config['generate'].get('eos_token_id')}), text "
          f"{out.stdout.strip()[:60]!r}; teacher-forced plain path (f32): "
          f"chosen token at most {gap:.3e} below the step max (limit 1e-3);"
          f" the process's kernel launches {report['kernel_launches']} "
          f"[{card}]", flush=True)
    if not toks or gap > 1e-3 or served != n_layers:
        raise AssertionError(f"served LoRA model: gap {gap}, tokens {toks}, "
                             f"launches {report['kernel_launches']}")
    launches["flash_fwd"] += served
    del plain, runs, trainers, base, frozen


def lc_remat_check(base, batch, trainer, card: str) -> None:
    """remat=True: one step's loss and adapter grads equal the non-remat
    step's within 1e-5 relative (the same adapters, the same seeds)."""
    import dataclasses

    import torch

    from kubeflow_tpu_torch.models.gpt import causal_lm_loss
    from kubeflow_tpu_torch.models.layers import DropoutSeeds
    from kubeflow_tpu_torch.train.lora import LoraModel

    out = {}
    for remat in (False, True):
        model = base.with_compute_dtype("bfloat16")
        model.cfg = dataclasses.replace(model.cfg, remat=remat)
        lora = LoraModel(model, rank=LORA_RANK, alpha=LORA_ALPHA,
                         generator=torch.Generator().manual_seed(SEED + 12))
        with torch.no_grad():
            for p in lora.lora.values():  # B too, so A gets grads
                p.normal_(0.0, 0.02, generator=torch.Generator(
                    device="cuda").manual_seed(SEED + 13))
        logits = lora(batch[0], train=True,
                      generator=DropoutSeeds(trainer._step_seeds(5)))
        loss = causal_lm_loss(logits.float(), batch[1])
        loss.backward()
        out[remat] = (loss.item(), {k: p.grad.float() for k, p in
                                    lora.lora.items()})
        del logits, loss, lora, model
    (l0, g0), (l1, g1) = out[False], out[True]
    rel = max((g1[k] - g0[k]).norm().item()
              / max(g0[k].norm().item(), 1e-30) for k in g0)
    lrel = abs(l1 - l0) / abs(l0)
    print(f"  remat=True vs the plain step: loss {l1:.6f} vs {l0:.6f} "
          f"(relative {lrel:.2e}), adapter grads' largest relative "
          f"difference {rel:.2e} (limit 1e-5) [{card}]", flush=True)
    if lrel > 1e-5 or rel > 1e-5:
        raise AssertionError(f"remat: loss {lrel}, grads {rel}")


def lc_llama_bert(tmp: str, launches: dict, card: str) -> None:
    """(d) import-llama at TinyLlama-1.1B's widths (LLAMA_LAYERS of 22
    layers), served bf16 through the CLI's generate with flash_fwd on its
    GQA-repeated heads, tokens within BF16_ULPS of the plain path under
    teacher forcing; import-bert at BERT-base's shapes, served (bf16,
    flash) within BF16_ULPS of the module's plain path."""
    import dataclasses

    import torch

    from kubeflow_tpu_torch.models.bert import BertForSequenceClassification
    from kubeflow_tpu_torch.models.gpt import GPTLM
    from kubeflow_tpu_torch.serving.model import (
        TorchModel,
        load_generative_model,
    )
    from kubeflow_tpu_torch.train.data import synthetic_text_dataset

    t0 = time.perf_counter()
    sd, hf_config = llama_hf_state_dict(SEED + 14)
    n_params = sum(t.numel() for t in sd.values())
    torch.save({"state_dict": sd, "config": hf_config}, f"{tmp}/llama.pt")
    del sd
    made = time.perf_counter() - t0
    t0 = time.perf_counter()
    cli("import-llama", "--checkpoint", f"{tmp}/llama.pt", "-o",
        f"{tmp}/llama", "--max-new-tokens", LLAMA_NEW, "--prompt-len",
        LLM_PROMPT)
    imported = time.perf_counter() - t0
    os.remove(f"{tmp}/llama.pt")
    edit_model_config(f"{tmp}/llama", dtype="bfloat16", attention="flash")
    prompt = np.random.RandomState(SEED + 14).randint(
        3, LLAMA_DIMS["vocab"], LLM_PROMPT)
    t0 = time.perf_counter()
    out = cli("generate", "--model-dir", f"{tmp}/llama", "--prompt",
              " ".join(map(str, prompt)))
    took = time.perf_counter() - t0
    report = generate_report(out)
    toks = report["tokens"]
    module, config = load_generative_model(f"{tmp}/llama", device="cuda")
    cfg = module.cfg
    plain = GPTLM(dataclasses.replace(cfg, attention="dense"), device="cuda")
    plain.load_state_dict(module.state_dict())
    del module
    _, ulps = teacher_forced_gap(plain.eval(), [prompt], [np.asarray(toks)])
    served = report["kernel_launches"].get("flash_fwd", 0)
    print(f"phase 12 (d): LlamaForCausalLM checkpoint at TinyLlama-1.1B's "
          f"widths (hidden {cfg.hidden_size}, {cfg.num_heads} heads, "
          f"{cfg.num_kv_heads} KV heads, intermediate {cfg.mlp_dim}, vocab "
          f"{cfg.vocab_size}, rope theta {cfg.rope_theta}, rms eps "
          f"{cfg.norm_eps}), depth cut to {cfg.num_layers} of 22 layers, "
          f"{n_params} params (made in {made:.2f}s); import-llama "
          f"{imported:.2f}s; generate (bf16, flash) {took:.2f}s: "
          f"{len(toks)} tokens, within {ulps:.2f} bf16 ulps of the plain "
          f"path's step max (limit {BF16_ULPS}); the process's kernel "
          f"launches {report['kernel_launches']} [{card}]", flush=True)
    if not toks or ulps > BF16_ULPS or served != cfg.num_layers:
        raise AssertionError(f"served Llama: {ulps} ulps, tokens {toks}, "
                             f"launches {report['kernel_launches']}")
    launches["flash_fwd"] += served
    del plain
    gc.collect()
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    torch.save({"state_dict": bert_hf_state_dict(SEED + 15),
                "config": {"num_attention_heads": BERT_DIMS["heads"]}},
               f"{tmp}/bert.pt")
    cli("import-bert", "--checkpoint", f"{tmp}/bert.pt", "-o",
        f"{tmp}/bert")
    imported = time.perf_counter() - t0
    edit_model_config(f"{tmp}/bert", dtype="bfloat16", attention="flash")
    x = synthetic_text_dataset(n_train=BERT_BATCH, n_test=BERT_BATCH,
                               seq_len=BERT_LEN,
                               vocab_size=BERT_DIMS["vocab"],
                               num_classes=2, seed=SEED + 15).x_test
    zero_launches()          # the served BERT's run starts here
    model = TorchModel("bert", f"{tmp}/bert", device="cuda")
    model.load()
    warm = _launch_counts(None)
    got = np.asarray(model(x)["logits"], np.float32)
    ran = _launch_counts(None)
    add_launches(launches, ran)
    module, _ = load_generative_model(f"{tmp}/bert", device="cuda")
    plain = BertForSequenceClassification(
        dataclasses.replace(module.cfg, attention="dense"), 2,
        device="cuda")
    plain.load_state_dict(module.state_dict())
    with torch.inference_mode():
        want = plain.eval()(torch.as_tensor(x, device="cuda")).float(
            ).cpu().numpy()
    ulps = bf16_ulps(got, want)
    request = ran["flash_fwd"] - warm["flash_fwd"]
    print(f"  BertForSequenceClassification checkpoint at BERT-base's "
          f"shapes: made and imported in {imported:.2f}s; served (bf16, "
          f"flash) logits of {x.shape} within {ulps:.2f} bf16 ulps of the "
          f"plain path (limit {BF16_ULPS}); flash_fwd launches {request} "
          f"for the request [{card}]", flush=True)
    if ulps > BF16_ULPS or request != module.cfg.num_layers \
            or not np.isfinite(got).all():
        raise AssertionError(f"served BERT: {ulps} ulps, launches {ran}")


def lc_dropout_kernels(peaks, card: str) -> dict:
    """(e) dropout_fwd and dropout_bwd against their plain version at the
    LoRA fit's residual shape in bf16 and f32 and at a ragged size: masks,
    outputs and grads bit-equal, two calls bit-equal; their loop and
    device times beside the bound (read + write bytes over the card's
    bandwidth), the plain version's time and torch's own dropout (its
    forward draws its own mask; its backward takes a stored one)."""
    import torch
    import torch.nn.functional as F

    from kubeflow_tpu_torch.kernels import dropout as kd

    gen = torch.Generator(device="cuda").manual_seed(SEED + 16)
    seed = torch.tensor(SEED + 16, dtype=torch.int64, device="cuda")
    rate, site = LORA_DROPOUT, 1
    records = {}
    shape = (LORA_BATCH, LORA_LEN, 768)   # GPT-2 small's residual
    for dt in (torch.bfloat16, torch.float32):
        for size in (shape, (DROPOUT_RAGGED,)):
            x = torch.randn(size, generator=gen, device="cuda").to(dt)
            bits = torch.int16 if dt == torch.bfloat16 else torch.int32
            y = kd.dropout_fwd(x, seed, rate, site)
            again = kd.dropout_fwd(x, seed, rate, site)
            gx = kd.dropout_bwd(x, seed, rate, site)
            ref = kd.dropout_plain(x, seed, rate, site)
            mask = kd.dropout_mask(seed, site, rate, x.shape)
            torch.cuda.synchronize()
            same = (torch.equal(y.view(bits), ref.view(bits))
                    and torch.equal(again.view(bits), y.view(bits))
                    and torch.equal(gx.view(bits), ref.view(bits))
                    and torch.equal(y != 0, mask))
            tag = f"{tuple(size)} {str(dt).split('.')[-1]}"
            if not same:
                raise AssertionError(f"dropout kernels differ from the "
                                     f"plain version at {tag}")
            if size != shape:
                print(f"  dropout kernels at {tag}: forward, backward, "
                      f"mask and a second call bit-equal to the plain "
                      f"version [{card}]", flush=True)
                continue
            nbytes = 2 * x.numel() * x.element_size() + 8
            bound_ms, bound_by = bound(0.0, nbytes, "bfloat16", peaks)
            g = torch.randn_like(x)
            _, lib_mask = torch.ops.aten.native_dropout(x, rate, True)
            libs = {"dropout_fwd": lambda: F.dropout(x, rate, True),
                    "dropout_bwd": lambda: torch.ops.aten
                    .native_dropout_backward(g, lib_mask, 1 / (1 - rate))}
            for name, fn in (("dropout_fwd", kd.dropout_fwd),
                             ("dropout_bwd", kd.dropout_bwd)):
                ms = time_ms(lambda: fn(x, seed, rate, site), 50)
                dev = device_ms(lambda: fn(x, seed, rate, site), 20)
                plain_ms = time_ms(
                    lambda: kd.dropout_plain(x, seed, rate, site), 5)
                lib = time_ms(libs[name], 50)
                lib_dev = device_ms(libs[name], 20)
                print(f"  {name} {tag}: bit-equal to the plain version; "
                      f"loop {ms:.5f} ms, device {dev:.5f} ms, bound "
                      f"{bound_ms:.5f} ms ({bound_by}; "
                      f"{100 * bound_ms / dev:.1f}% of it), plain "
                      f"{plain_ms:.5f} ms, torch's dropout {lib:.5f} ms "
                      f"(device {lib_dev:.5f} ms) [{card}]", flush=True)
                if dt == torch.bfloat16:
                    records[name] = {
                        "max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms,
                        "bound_ms": bound_ms, "bound_by": bound_by,
                        "library_ms": lib, "device_ms": dev,
                        "library_device_ms": lib_dev}
    return records


# ------------------------------------------------------------------ phase 13

#: Mixtral-8x7B's published widths (mistralai/Mixtral-8x7B-v0.1 config.json)
MOE_DIMS = dict(vocab_size=32000, hidden_size=4096, num_heads=32,
                num_kv_heads=8, mlp_dim=14336, moe_experts=8, moe_top_k=2,
                rope_theta=1e6, norm_eps=1e-5)
MOE_TRAIN_LAYERS, MOE_SERVE_LAYERS = 2, 4       # of 32: see PERF.md §4
# MOE_STEPS is a multiple of MOE_FUSED: once the graph's pool holds its
# gradients and activations, an eager tail step's own do not fit the card
MOE_BATCH, MOE_LEN, MOE_STEPS, MOE_FUSED, MOE_LR = 4, 1024, 12, 4, 1e-4
#: the training chain's ids (of the 32000): each (token, next) pair recurs
#: within a step, so 12 steps learn it; over all 32000 ids a pair is seen
#: about once in the fit and the loss stays flat
MOE_DATA_VOCAB = 64
MOE_MESH_RTOL = 1e-5
MOE_ROWS, MOE_PROMPT, MOE_NEW = 8, 128, 64
MOE_CHILD_TIMEOUT_S = 600


def mixtral_cfg(layers: int, **kw):
    """GPTConfig.llama at Mixtral-8x7B's widths, cut to ``layers``."""
    from kubeflow_tpu_torch.models.gpt import GPTConfig

    return GPTConfig.llama(**{**MOE_DIMS, "num_layers": layers,
                              "attention": "flash", "dropout_rate": 0.0,
                              **kw})


def moe_kernels(peaks, card: str) -> None:
    """Phase 13 (a): the flash kernels at head_dim 128 (32 heads, the
    Mixtral decoder's, KV heads repeated before the kernel) against their
    plain versions: the training shape (4, 1024) causal in bf16 and f32,
    forward and backward (D read), and the serving prefill (1, 128) bf16;
    phase 3's and phase 5's limits; loop and device times beside the bound
    and SDPA's."""
    import torch

    from kubeflow_tpu_torch.kernels import flash_bwd as kb
    from kubeflow_tpu_torch.kernels.flash_fwd import flash_fwd
    from kubeflow_tpu_torch.parallel.ring_attention import (
        flash_backward_plain,
        flash_forward_plain,
    )

    gen = torch.Generator(device="cuda").manual_seed(SEED + 13)
    h, d = MOE_DIMS["num_heads"], 128
    print(f"phase 13 (a): flash kernels at D={d}, H={h}, causal, pad bias "
          "on the last keys of the last row; limits as phases 3 and 5 "
          "[" + card + "]", flush=True)
    cases = [(MOE_BATCH, MOE_LEN, "bfloat16", True),
             (MOE_BATCH, MOE_LEN, "float32", True),
             (1, MOE_PROMPT, "bfloat16", False)]
    for b, l, dt, backward in cases:
        dtype = getattr(torch, dt)
        q, k, v, bias = make_attention_inputs(b, l, h, d, dtype, 16, gen)
        o, lse = flash_fwd(q, k, v, bias, True, 0)
        o_p, lse_p = flash_forward_plain(q, k, v, bias, 128, True, 0)
        o_2, lse_2 = flash_fwd(q, k, v, bias, True, 0)
        torch.cuda.synchronize()
        fwd_tol = 1e-4 if dt == "float32" else 2e-2
        err = {"flash_fwd": (o.float() - o_p.float()).abs().max().item()}
        err_l = (lse - lse_p).abs().max().item()
        tiles = {"flash_fwd": tile_error(o.transpose(1, 2),
                                         o_p.transpose(1, 2))}
        same = torch.equal(o, o_2) and torch.equal(lse, lse_2)
        bad = []
        if not (err["flash_fwd"] <= fwd_tol and err_l <= fwd_tol and same):
            bad.append(("flash_fwd", err["flash_fwd"], err_l, same))
        iters = 10 if l >= 1024 else 50
        calls = {"flash_fwd": functools.partial(flash_fwd, q, k, v, bias,
                                                True, 0)}
        fb, fb_by = attention_bound(b, h, l, l, d, dt, True, 0, peaks)
        bounds = {"flash_fwd": (fb, fb_by)}
        lib = {"flash_fwd": sdpa_call(q, k, v, bias, True, 0)}
        if backward:
            g = torch.randn((b, l, h, d), generator=gen,
                            device="cuda").to(dtype)
            want = flash_backward_plain(q, k, v, bias, o, lse, g, 128, True,
                                        0, True)
            dd = kb.flash_bwd_dd(o, g)
            dq = kb.flash_bwd_dq(q, k, v, bias, o, g, lse, dd, True, 0)
            dk, dv, dbh = kb.flash_bwd_dkv(q, k, v, bias, o, g, lse, dd,
                                           True, 0, True)
            dbias = dbh.view(b, h, l).sum(1)[:, None, None]
            torch.cuda.synchronize()
            err["flash_bwd_dd"] = (dd - (g.float() * o.float()).sum(-1)
                                   .transpose(1, 2)).abs().max().item()
            rel_tol = 1e-4 if dt == "float32" else 4 * 2.0 ** -8
            for name, got, ref in (("flash_bwd_dq", dq, want[0]),
                                   ("flash_bwd_dkv", dk, want[1]),
                                   ("flash_bwd_dkv", dv, want[2]),
                                   ("flash_bwd_dkv", dbias, want[3])):
                ref = ref.float()
                scale = max(1.0, ref.abs().max().item())
                e = (got.float() - ref).abs().max().item() / scale
                err[name] = max(err.get(name, 0.0), e)
                shaped = ((lambda x: x.view(b, 1, l, 1)) if ref.shape[1] == 1
                          else (lambda x: x.transpose(1, 2)))
                tiles[name] = max(tiles.get(name, 0.0),
                                  tile_error(shaped(got), shaped(ref)))
                if not e <= rel_tol:
                    bad.append((name, e))
            calls["flash_bwd_dd"] = functools.partial(kb.flash_bwd_dd, o, g)
            calls["flash_bwd_dq"] = functools.partial(
                kb.flash_bwd_dq, q, k, v, bias, o, g, lse, dd, True, 0)
            calls["flash_bwd_dkv"] = functools.partial(
                kb.flash_bwd_dkv, q, k, v, bias, o, g, lse, dd, True, 0,
                False)
            bounds.update(backward_bounds(b, h, l, l, d, dt, True, 0, peaks,
                                          False, False))
            fwd_bwd, fwd_only = sdpa_backward_call(q, k, v, bias, g, True, 0)
        bad += [(f"{n} block", t) for n, t in tiles.items()
                if not t <= TILE_TOL[dt]]
        for name, call in calls.items():
            ms, dev = time_ms(call, iters), device_ms(call, iters)
            bound_ms, bound_by = bounds[name]
            print(f"  {name:13s} B={b} L={l:5d} H={h} D={d} {dt:9s} "
                  f"err={err[name]:.3e} worst block {tiles.get(name, 0):.3e}"
                  f" ms={ms:.5f} dev={dev:.5f} bound_ms={bound_ms:.5f} "
                  f"({bound_by}) [{card}]", flush=True)
        sd_ms, sd_dev = (time_ms(lib["flash_fwd"], iters),
                         device_ms(lib["flash_fwd"], iters))
        causal = sdpa_causal_call(q, k, v)
        line = (f"  SDPA forward masked {sd_ms:.5f} ms (dev {sd_dev:.5f}), "
                f"is_causal {time_ms(causal, iters):.5f} ms (dev "
                f"{device_ms(causal, iters):.5f})")
        if backward:
            bwd = time_ms(fwd_bwd, iters) - time_ms(fwd_only, iters)
            bwd_dev = device_ms(fwd_bwd, iters) - device_ms(fwd_only, iters)
            line += f"; SDPA backward {bwd:.5f} ms (dev {bwd_dev:.5f})"
        print(line + f"; lse err {err_l:.3e}; two calls bit-equal {same} "
              f"[{card}]", flush=True)
        if bad:
            raise AssertionError(f"phase 13 (a): kernels disagree with the "
                                 f"plain version at B={b} L={l} D={d} {dt}: "
                                 f"{bad}")


def moe_train_child(out: str) -> None:
    """Phase 13 (b) and (c), in a process of its own with the PyTorchJob
    env of a world of one: initialize_from_env over NCCL, then the 2-layer
    Mixtral-width decoder fitted three ways from the same weights. Writes
    its readings as JSON to ``out``."""
    import torch
    import torch.distributed as dist

    from kubeflow_tpu_torch import health, tracing
    from kubeflow_tpu_torch.models.gpt import GPTLM, causal_lm_loss
    from kubeflow_tpu_torch.parallel.mesh import MeshConfig
    from kubeflow_tpu_torch.parallel.moe import collect_losses
    from kubeflow_tpu_torch.runtime import initialize_from_env, shutdown
    from kubeflow_tpu_torch.train.data import batches, synthetic_lm_dataset

    torch.backends.cuda.matmul.allow_tf32 = False
    res: dict = {}
    phases = []
    beat = health.HeartbeatWriter.beat

    def spy(self, step=-1, phase="train"):
        phases.append(phase)
        return beat(self, step, phase)

    health.HeartbeatWriter.beat = spy
    t0 = time.perf_counter()
    ctx = initialize_from_env()
    res["rendezvous_s"] = time.perf_counter() - t0
    health.HeartbeatWriter.beat = beat
    with open(os.environ[health.ENV_HEARTBEAT_FILE]) as fh:
        res["heartbeat"] = json.load(fh)
    res["phases"], res["backend"] = phases, dist.get_backend()
    one = torch.ones(1, device="cuda")
    dist.all_reduce(one)
    res["ctx"] = [ctx.process_id, ctx.num_processes, ctx.coordinator,
                  float(one.item())]
    tracing.flush()
    cfg = mixtral_cfg(MOE_TRAIN_LAYERS, max_len=MOE_LEN)
    ds = synthetic_lm_dataset(n_train=MOE_BATCH * MOE_STEPS,
                              n_test=MOE_BATCH, seq_len=MOE_LEN,
                              vocab_size=MOE_DATA_VOCAB, seed=SEED)
    first = next(batches(ds.x_train, ds.y_train, MOE_BATCH, seed=0))
    launches = dict.fromkeys(FLASH_KERNELS, 0)
    for name, kw in (("eager", {}), ("mesh", {"mesh": MeshConfig(fsdp=1)}),
                     ("graphed", {"fused_steps": MOE_FUSED})):
        gen = torch.Generator(device="cuda").manual_seed(SEED + 13)
        trainer = gpt_trainer(cfg, SEED, model=GPTLM(cfg, device="cuda")
                              .init_weights(gen), batch_size=MOE_BATCH,
                              steps=MOE_STEPS, learning_rate=MOE_LR,
                              warmup_steps=0, **kw)
        if name == "eager":
            res["params"] = sum(p.numel() for p in trainer.model.parameters())
            x = torch.as_tensor(first[0], device="cuda").long()
            with torch.no_grad(), collect_losses() as sown:
                ce = causal_lm_loss(trainer.model(x), x)
            res["first_ce"], res["first_aux"] = ce.item(), [
                a.item() for a in sown]
        if name == "mesh":
            res["mesh_backend"] = dist.get_backend(
                trainer.mesh.device_mesh.get_group("fsdp"))
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        run = fit_timed(trainer, ds)
        peak = torch.cuda.max_memory_allocated() / 2**30
        check_flash_steps(run, MOE_TRAIN_LAYERS, f"phase 13 {name} fit")
        card = card_line()
        if name == "graphed":
            k = MOE_FUSED
            stacked = tuple(np.stack([a[i * MOE_BATCH:(i + 1) * MOE_BATCH]
                                      for i in range(k)])
                            for a in (ds.x_train, ds.y_train))
            idle = profile_step(lambda: trainer.train_chunk(
                run["state"], stacked, k), run["chunk_ms"], card,
                what=f"chunk of {k} steps")
        else:
            idle = profile_step(lambda: trainer.train_step(run["state"],
                                                           first),
                                run["step_ms"], card)
        for n, c in _launch_counts().items():
            launches[n] += c
        res[name] = {"logged": run["logged"], "losses": run["losses"],
                     "step_ms": run["step_ms"], "chunk_ms": run["chunk_ms"],
                     "peak_gib": peak, "idle": idle,
                     "dispatches": [d["steps"] for d in run["dispatches"]],
                     "wall": run["wall"]}
        del trainer, run
        gc.collect()
        torch.cuda.empty_cache()
    res["launches"] = launches
    shutdown()
    with open(out, "w") as fh:
        json.dump(res, fh)


def moe_train(tmp: str, card: str) -> dict:
    """Phase 13 (b), (c): moe_train_child in a fresh process; its
    bootstrap's heartbeat and span and its fits checked here. Returns its
    flash kernels' launches."""
    import torch

    hb, traces, out = (os.path.join(tmp, n) for n in ("hb", "trace",
                                                      "train.json"))
    with __import__("socket").socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = {**os.environ, "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port),
           "WORLD_SIZE": "1", "RANK": "0", "KFTPU_HEARTBEAT_FILE": hb,
           "KFTPU_TRACE_DIR": traces}
    gc.collect()
    torch.cuda.empty_cache()   # the child needs the card's memory
    print(f"phase 13 (b): {card_used_gib():.2f} GiB of the card in use as "
          f"the child starts ({torch.cuda.memory_allocated() / 2**30:.2f} GiB "
          f"allocated by this process's torch) [{card}]", flush=True)
    here = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-c", "import chip_smoke as c; "
         f"c.moe_train_child({out!r})"], cwd=here, env=env,
        capture_output=True, text=True, timeout=MOE_CHILD_TIMEOUT_S)
    for line in proc.stdout.splitlines():
        if line.startswith("  "):
            print(line, flush=True)
    if proc.returncode:
        raise AssertionError(f"phase 13 training child failed "
                             f"({proc.returncode}):\n{proc.stderr[-4000:]}")
    with open(out) as fh:
        res = json.load(fh)
    spans = []
    for name in os.listdir(traces):
        with open(os.path.join(traces, name)) as fh:
            spans += [e for e in json.load(fh)["traceEvents"]
                      if e.get("name") == "rendezvous"]
    print(f"phase 13 (b): initialize_from_env in a child process over "
          f"{res['backend']} (world {res['ctx'][1]}, rank {res['ctx'][0]}, "
          f"{res['ctx'][2]}), rendezvous {res['rendezvous_s']:.3f} s, "
          f"all_reduce of 1 -> {res['ctx'][3]}; heartbeat phases "
          f"{res['phases']}, the file {res['heartbeat']['phase']}; rendezvous "
          f"spans {[e['args'] for e in spans]}; the mesh's fsdp group over "
          f"{res['mesh_backend']} [{card}]", flush=True)
    if (res["backend"] != "nccl" or res["phases"][:2] != [
            "rendezvous", "rendezvous-done"]
            or res["heartbeat"]["phase"] != "rendezvous-done"
            or len(spans) != 1 or spans[0]["args"]["backend"] != "nccl"
            or res["ctx"][3] != 1.0):
        raise AssertionError(f"phase 13 (b): the bootstrap {res}, {spans}")
    eager, mesh, graphed = res["eager"], res["mesh"], res["graphed"]
    tokens = MOE_BATCH * MOE_LEN
    aux = sum(res["first_aux"])
    print(f"phase 13 (c): Mixtral-8x7B widths cut to {MOE_TRAIN_LAYERS} "
          f"layers, {res['params']} params, bf16 compute, batch {MOE_BATCH} "
          f"x {MOE_LEN} (the chain over ids below {MOE_DATA_VOCAB}), "
          f"{MOE_STEPS} steps at lr {MOE_LR}; first loss "
          f"{eager['losses'][0]:.6f} = cross entropy {res['first_ce']:.6f} + "
          f"aux {res['first_aux']} [{card}]", flush=True)
    for name, r in (("eager", eager), ("mesh fsdp=1", mesh),
                    ("graphed", graphed)):
        ms = r["chunk_ms"] or r["step_ms"]
        print(f"  {name}: step {ms:.2f} ms ({tokens / ms * 1e3:.1f} tokens/s"
              f"), peak {r['peak_gib']:.2f} GiB, idle share of a profiled "
              f"{'chunk' if r['chunk_ms'] else 'step'} {share(r['idle'])}, "
              f"dispatches {r['dispatches']}, fit {r['wall']:.2f} s, losses "
              f"{[round(x, 5) for x in r['losses']]} [{card}]", flush=True)
    losses = eager["losses"]
    if not (all(math.isfinite(x) for x in losses) and losses[-1] < losses[0]):
        raise AssertionError(f"phase 13: eager losses {losses}")
    if abs(losses[0] - (res["first_ce"] + aux)) > 1e-3 * abs(losses[0]) \
            or not aux > 0:
        raise AssertionError(f"phase 13: the first loss {losses[0]} is not "
                             f"CE {res['first_ce']} + aux {aux}")
    worst = max(abs(a - b) / abs(b)
                for a, b in zip(mesh["losses"], eager["losses"]))
    print(f"  mesh fit vs eager: worst relative loss difference {worst:.3e} "
          f"(limit {MOE_MESH_RTOL}); a world of one, so its steps ran the "
          f"eager fit's code: no FSDP2 hook and no collective [{card}]",
          flush=True)
    if worst > MOE_MESH_RTOL or len(mesh["losses"]) != len(losses):
        raise AssertionError(f"phase 13: mesh losses {mesh['losses']} vs "
                             f"{losses}")
    check_logged_against(
        {"logged": {int(k): v for k, v in graphed["logged"].items()}},
        {"logged": {int(k): v for k, v in eager["logged"].items()}},
        "phase 13 graphed fit", card)
    print(f"phase 13 (b)-(c): child process {time.perf_counter() - t0:.1f} s"
          f" [{card}]", flush=True)
    return res["launches"]


def stepwise_forced_gap(model, prompts, tokens, prefill: bool = False
                        ) -> tuple[float, float]:
    """teacher_forced_gap as the engine runs an MoE model: each prompt
    prefilled alone (an MoE block's capacity is per forward) into its row
    of the batch cache (through the flash kernel with ``prefill``), then
    the generated tokens read one position at a time (one-token steps
    route dropless)."""
    import torch

    from kubeflow_tpu_torch.models.gpt import splice_cache_row

    x = torch.as_tensor(np.stack(prompts), device="cuda").long()
    y = torch.as_tensor(np.stack(tokens), device="cuda").long()
    with torch.inference_mode():
        cache, first = model.init_cache(x.shape[0]), []
        for r in range(x.shape[0]):
            row = model.init_cache(1)
            first.append(model(x[r:r + 1], cache=row,
                               prefill=prefill)[:, -1:])
            splice_cache_row(cache, row, r)
        steps = [torch.cat(first)]
        for i in range(y.shape[1] - 1):
            steps.append(model(y[:, i:i + 1], cache=cache))
        logits = torch.cat(steps, dim=1)
        top = logits.max(-1).values
        gap = top - logits.gather(-1, y[..., None])[..., 0]
        ulp = BF16_ULP * logits.abs().max(-1).values
    return gap.max().item(), (gap / ulp).max().item()


@contextlib.contextmanager
def recorded_routes():
    """A context in which every MoE forward records its top-k expert
    choices, (T, K) int64, in call order: a routed forward's from
    moe._route, a dropless one's as _dropless takes them."""
    import torch

    from kubeflow_tpu_torch.parallel import moe

    route, dropless, seen = moe._route, moe.MoeMlp._dropless, []

    def route_spy(logits, top_k, capacity):
        out = route(logits, top_k, capacity)
        seen.append(out[0])
        return out

    def dropless_spy(self, xt, logits):
        seen.append(torch.topk(torch.softmax(logits, dim=-1), self.top_k,
                               dim=-1).indices)
        return dropless(self, xt, logits)

    moe._route, moe.MoeMlp._dropless = route_spy, dropless_spy
    try:
        yield seen
    finally:
        moe._route, moe.MoeMlp._dropless = route, dropless


def pinned_moe(mlp, idx, keep, flips: list):
    """A plain forward for the SwiGLU MoE layer ``mlp`` over (T, K)
    expert choices ``idx`` kept where ``keep``: every expert run on every
    token in a loop, the gates its own router's softmax at those choices,
    renormalised; the combine weights rounded to the activation dtype and
    the terms summed in float32, as MoeMlp rounds. Appends to ``flips``
    each token's gap between its own router's k-th and (k+1)-th
    probabilities and whether that router would choose other experts."""
    import torch
    import torch.nn.functional as F

    assert mlp.activation == "swiglu" and not mlp.use_bias
    k = mlp.top_k

    def forward(x, dropless=False):
        b, l, h = x.shape
        dt, xt = x.dtype, x.reshape(b * l, h)
        probs = torch.softmax(xt.float() @ mlp.router, dim=-1)
        top = probs.topk(k + 1, dim=-1)
        own = top.indices[:, :k].sort(-1).values
        moved = (own != idx.sort(-1).values).any(-1)
        flips.append((top.values[:, k - 1] - top.values[:, k], moved))
        gates = probs.gather(1, idx)
        gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)
        weight = torch.zeros_like(probs).scatter_add(
            1, idx, gates * keep).to(dt)
        y = torch.zeros(b * l, h, device=x.device)
        for e in range(mlp.num_experts):
            up = xt @ mlp.w_up[e].to(dt)
            act = F.silu(xt @ mlp.w_gate[e].to(dt)) * up
            y += weight[:, e, None].float() * (act @ mlp.w_down[e].to(dt)
                                                ).float()
        return y.to(dt).reshape(b, l, h)

    return forward


def pinned_forced_gap(plain, prompts, tokens, routes
                      ) -> tuple[float, float, dict]:
    """teacher_forced_gap on the plain path with no cache: each prompt and
    its generated tokens read in one dense forward, every MoE layer a
    ``pinned_moe`` over the expert choices ``routes`` that
    stepwise_forced_gap recorded (each prompt's routed prefill, then one
    dropless step at a time). A prompt's choices are kept as its prefill
    kept them: each expert's first C = ceil(k * prompt * cf / E) in
    (token-major, then k) order; a generated token's all. Returns (largest
    gap, in bf16 ulps, {the routings (a token in a layer), those the plain
    path's own routers would send elsewhere, the largest gap between their
    k-th and (k+1)-th router probabilities, the median one over all})."""
    import torch

    rows, n_prompt, n_new = len(prompts), len(prompts[0]), len(tokens[0])
    layers = [block.moe for block in plain.layers]
    n = len(layers)
    flips: list = []
    for l, mlp in enumerate(layers):
        k, e = mlp.top_k, mlp.num_experts
        cap = math.ceil(k * n_prompt * mlp.capacity_factor / e)
        idx, keep = [], []
        for r in range(rows):
            pre = routes[r * n + l]
            steps = [routes[(rows + i) * n + l][r] for i in range(n_new - 1)]
            idx.append(torch.cat([pre, torch.stack(steps)]))
            count, kept = [0] * e, np.ones((n_prompt + n_new - 1, k), bool)
            for t, choice in enumerate(pre.tolist()):
                for j, ex in enumerate(choice):
                    kept[t, j] = count[ex] < cap
                    count[ex] += 1
            keep.append(torch.as_tensor(kept, device="cuda"))
        mlp.forward = pinned_moe(mlp, torch.cat(idx), torch.cat(keep), flips)
    x = torch.as_tensor(np.stack(prompts), device="cuda").long()
    y = torch.as_tensor(np.stack(tokens), device="cuda").long()
    pad, plain.pad_token_id = plain.pad_token_id, -1  # prompts: unpadded
    try:
        with torch.inference_mode():
            logits = plain(torch.cat([x, y[:, :-1]], 1))[:, n_prompt - 1:]
            top = logits.max(-1).values
            gap = top - logits.gather(-1, y[..., None])[..., 0]
            ulp = BF16_ULP * logits.abs().max(-1).values
    finally:
        plain.pad_token_id = pad
        for mlp in layers:
            del mlp.forward
    margin = torch.cat([m for m, _ in flips])
    moved = torch.cat([v for _, v in flips])
    return gap.max().item(), (gap / ulp).max().item(), {
        "routings": margin.numel(), "moved": int(moved.sum()),
        "moved_margin": margin[moved].max().item() if moved.any() else 0.0,
        "median_margin": margin.median().item()}


def moe_serve(card: str) -> dict:
    """Phase 13 (d): the 4-layer Mixtral-width decoder (bf16 compute, f32
    parameters, seeded weights held in memory: a 24 GB params.npz round
    trip is what it skips) served by the continuous-batching engine behind
    ModelServer, MOE_ROWS requests of MOE_PROMPT tokens from as many
    threads, MOE_NEW new tokens each. Returns flash_fwd's launches."""
    import dataclasses
    import threading

    import torch

    from kubeflow_tpu_torch.kernels import KERNELS
    from kubeflow_tpu_torch.models.gpt import GPTLM
    from kubeflow_tpu_torch.parallel import moe
    from kubeflow_tpu_torch.serving.continuous import ContinuousBatcher
    from kubeflow_tpu_torch.serving.model import TorchModel
    from kubeflow_tpu_torch.serving.server import ModelServer
    from kubeflow_tpu_torch.tracing import Tracer

    gc.collect()
    torch.cuda.empty_cache()
    cfg = mixtral_cfg(MOE_SERVE_LAYERS, dtype="bfloat16", max_len=256)
    t0 = time.perf_counter()
    model = GPTLM(cfg, device="cuda").init_weights(
        torch.Generator(device="cuda").manual_seed(SEED + 14)).eval()
    n_params = sum(p.numel() for p in model.parameters())
    rng = np.random.RandomState(SEED + 15)
    prompts = [rng.randint(1, cfg.vocab_size, MOE_PROMPT).astype(np.int32)
               for _ in range(MOE_ROWS)]
    with torch.inference_mode():  # cuBLAS and the kernels set up here
        model(torch.as_tensor(prompts[0][None], device="cuda").long(),
              cache=model.init_cache(1), prefill=True)
        model(torch.ones((MOE_ROWS, 1), dtype=torch.long, device="cuda"),
              cache=model.init_cache(MOE_ROWS))
    tracer, samples = Tracer(), Samples()
    engine = ContinuousBatcher(model, max_rows=MOE_ROWS,
                               default_max_new_tokens=MOE_NEW,
                               tracer=tracer, tsdb=samples)
    served = TorchModel("mixtral", ".", device="cuda")
    served.config = {"family": "gpt-lm", "input_dtype": "int32",
                     "input_shape": [1, MOE_PROMPT],
                     "generate": {"continuous": True, "temperature": 0.0,
                                  "max_new_tokens": MOE_NEW}}
    served._engine, served.ready = engine.start(), True
    srv = ModelServer([served], port=0, host="127.0.0.1")
    srv.start()
    print(f"phase 13 (d): Mixtral-8x7B widths cut to {MOE_SERVE_LAYERS} "
          f"layers, {n_params} params (f32), bf16 compute, flash prefill; "
          f"engine {MOE_ROWS} rows behind ModelServer, up in "
          f"{time.perf_counter() - t0:.2f}s [{card}]", flush=True)
    results = [None] * MOE_ROWS
    try:
        def client(i):
            results[i] = post(f"{srv.url}/v1/models/mixtral:predict",
                              {"instances": [prompts[i].tolist()]})

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_launches()
        moe.DISPATCH_CALLS.update(routed=0, dropless=0)
        t_run = time.perf_counter()
        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(MOE_ROWS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        wall = time.perf_counter() - t_run
        launches = {n: k.launches for n, k in KERNELS.items()}
        calls = dict(moe.DISPATCH_CALLS)
        peak = torch.cuda.max_memory_allocated() / 2**30
        ticks = engine.step_count
    finally:
        srv.stop()
        served.close()
    tokens = []
    for i, (code, body, _) in enumerate(results):
        toks = np.asarray(body.get("predictions"))
        if code != 200 or toks.shape != (1, MOE_NEW) or toks.min() < 0 \
                or toks.max() >= cfg.vocab_size:
            raise AssertionError(f"phase 13 (d): request {i}: {code} {body}")
        tokens.append(toks[0])
    prefills = sum(s["attrs"]["tokens_reused"] == 0
                   for s in tracer.snapshot()
                   if s["name"] == "engine.prefill_chunk")
    ttft = np.array([body["timing"]["ttft_s"] for _, body, _ in results])
    tick = np.array([v for name, v, _ in samples.rows
                     if name == "serving.decode_tick_s"]) * 1e3
    # the engine's arithmetic without the engine: each prompt prefilled
    # alone through the flash kernel, the tokens decoded one at a time
    with recorded_routes() as routes:
        gap, ulps = stepwise_forced_gap(model, prompts, tokens, prefill=True)
    # the plain path: the same weights, plain attention everywhere. With
    # its own routing (read, not held) a token whose router logits are
    # near a tie picks another expert where the prefill's rounding
    # differs; held, with each MoE layer a plain loop over the experts
    # the engine's arithmetic chose
    plain = model.with_compute_dtype("bfloat16")
    for block in plain.layers:
        block.attention.cfg = dataclasses.replace(cfg, attention="dense")
        block.attention.attn_fn = None
    own_gap, own_ulps = stepwise_forced_gap(plain, prompts, tokens)
    plain_gap, plain_ulps, flips = pinned_forced_gap(plain, prompts, tokens,
                                                     routes)
    weight_bytes = 4 * n_params
    floor = (weight_bytes + 2 * 2 * n_params) / PEAKS["sxm"]["bytes"] * 1e3
    total = MOE_ROWS * MOE_NEW
    print(f"  {MOE_ROWS} requests: {wall:.3f} s wall, TTFT (engine) p50 "
          f"{np.median(ttft) * 1e3:.2f} ms, max {ttft.max() * 1e3:.2f} ms, "
          f"{(total - MOE_ROWS) / wall:.1f} decode tokens/s, decode tick "
          f"median {np.median(tick):.2f} ms over {len(tick)}; decode "
          f"dispatches {ticks}, prefills from position 0 {prefills}; peak "
          f"{peak:.2f} GiB; launches {launches} [{card}]", flush=True)
    print(f"  what bounds a tick: it reads every f32 weight and writes and "
          f"reads its bf16 cast ({(weight_bytes + 4 * n_params) / 1e9:.1f} "
          f"GB), at least {floor:.2f} ms at the HBM rate, against the "
          f"{np.median(tick):.2f} ms median [{card}]", flush=True)
    print(f"  MoE forwards: routed {calls['routed']} (= {MOE_SERVE_LAYERS} x "
          f"{prefills} prefills), dropless {calls['dropless']} (= "
          f"{MOE_SERVE_LAYERS} x {ticks} ticks) [{card}]", flush=True)
    print(f"  every greedy token within {plain_ulps:.2f} bf16 ulps of its "
          f"step's max under teacher forcing on the plain path (dense "
          f"attention, no cache, each MoE layer a plain loop over the "
          f"experts the engine's arithmetic chose; limit {BF16_ULPS}; "
          f"largest gap {plain_gap:.4f}); its own routers would choose "
          f"other experts in {flips['moved']} of {flips['routings']} "
          f"routings (a token in a layer), their k-th and (k+1)-th router "
          f"probabilities at most {flips['moved_margin']:.3e} apart (median "
          f"over all routings {flips['median_margin']:.3e}); with that "
          f"routing "
          f"(read, not held) {own_ulps:.2f} ulps, largest gap "
          f"{own_gap:.4f}; against the engine's arithmetic run a request "
          f"at a time {ulps:.2f} ulps (limit {BF16_ULPS}; largest gap "
          f"{gap:.4f}) [{card}]", flush=True)
    if (prefills != MOE_ROWS
            or launches["flash_fwd"] != MOE_SERVE_LAYERS * prefills
            or calls != {"routed": MOE_SERVE_LAYERS * prefills,
                         "dropless": MOE_SERVE_LAYERS * ticks}
            or not ulps <= BF16_ULPS or not plain_ulps <= BF16_ULPS):
        raise AssertionError(
            f"phase 13 (d): prefills {prefills}, launches {launches}, MoE "
            f"calls {calls} over {ticks} ticks, {ulps} ulps, on the plain "
            f"path {plain_ulps} ulps")
    del plain, model, engine
    gc.collect()
    torch.cuda.empty_cache()
    return {"flash_fwd": launches["flash_fwd"]}


def phase_moe_train(card: str) -> tuple[dict, float]:
    """Phase 13 (b), (c), run first, while this process holds nothing on
    the card: the training child needs 60 of its 79 GiB. Returns the
    child's flash kernel launches and the seconds it took."""
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        launches = moe_train(tmp, card)
    return launches, time.perf_counter() - t0


def phase_moe(peaks, card: str, trained: tuple[dict, float]) -> dict:
    """Phase 13: (a) the D=128 kernels and (d) the Mixtral-width MoE
    decoder served, beside ``trained``, phase_moe_train's launches and
    seconds ((b), (c)). Returns each flash kernel's launches over the
    path's runs."""
    t_phase = time.perf_counter()
    moe_kernels(peaks, card)
    launches = dict.fromkeys(FLASH_KERNELS, 0)
    for name, n in trained[0].items():
        launches[name] += n
    launches["flash_fwd"] += moe_serve(card)["flash_fwd"]
    print(f"phase 13: sharded and MoE training and MoE serving in "
          f"{time.perf_counter() - t_phase + trained[1]:.1f}s ((b)-(c) "
          f"{trained[1]:.1f} s, first); its path's launches {launches} "
          f"[{card}]", flush=True)
    for name in FLASH_KERNELS:
        if not launches[name]:
            raise AssertionError(f"phase 13's path never launched {name}")
    return launches


# ----------------------------------------------------------------- phase 14

# phase 14: blockwise attention, the ring and Ulysses paths' local attention
# (plain PyTorch, as the JAX package computes it outside Pallas), against
# the flash kernels at the training shape and bench.py's gpt2s_swa_2k window;
# its peak memory at CTX_MEM_LEN; GPT-2 small trained CTX_STEPS steps with
# ring, Ulysses and flash attention on a context mesh of one, from the same
# weights and batches: losses within CTX_LOSS_ATOL, grad norms within
# CTX_NORM_RTOL of the flash fit's
CTX_WINDOW, CTX_MEM_LEN, CTX_STEPS = 256, 8192, 3
# the dropout kernels' slice form (a context rank's positions) over these
# context sizes
CTX_DROPOUT_SPLITS = (2, 4)
CTX_LOSS_ATOL, CTX_NORM_RTOL = 2e-3, 0.01
# custom against autodiff: the JAX package's bounds (tests/
# test_ring_attention.py TestBlockwiseCustomVJP): f32 atol 1e-4; bf16 atol
# 6e-2, rtol 5e-2
CTX_VJP_TOL = {"float32": (1e-4, 0.0), "bfloat16": (6e-2, 5e-2)}


def blockwise_call(q, k, v, bias, g, window, vjp, backward=True):
    """blockwise_attention's forward (and its backward from cotangent g)
    at phase 6's attention block, causal."""
    import torch

    from kubeflow_tpu_torch.parallel.ring_attention import blockwise_attention

    def call():
        leaves = [t.detach().requires_grad_(backward) for t in (q, k, v)]
        with torch.set_grad_enabled(backward):
            out = blockwise_attention(*leaves, bias, block=128, causal=True,
                                      window=window, vjp=vjp)
            if not backward:
                return out, None
            return out, torch.autograd.grad(out, leaves, g)

    return call


def flash_call(q, k, v, bias, g, window, backward=True):
    """The flash kernels on the same function: flash_fwd, then dd, dq and
    dkv (the default backward)."""
    from kubeflow_tpu_torch.parallel.ring_attention import (
        flash_backward,
        flash_forward,
    )

    def call():
        out, lse = flash_forward(q, k, v, bias, 128, 128, True, window)
        if not backward:
            return out, None
        dq, dk, dv, _ = flash_backward(q, k, v, bias, out, lse, g, 128, 128,
                                       True, window=window, want_dbias=False)
        return out, (dq, dk, dv)

    return call


def ctx_kernels(card: str) -> None:
    """(a) blockwise attention (vjp custom, and autodiff) against the
    Hopper kernels at (4, 2048, 12, 64) causal, f32 and bf16, window 0 and
    CTX_WINDOW: phase 3's forward and phase 5's backward limits and
    TILE_TOL; custom against autodiff at the JAX package's bounds; loop
    and device times (the profiler's, and CUDA events around the same
    launches) beside the kernels'. The kernels' launches here compare and
    are not counted."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(SEED + 14)
    b, l, h, d = TRAIN_BATCH, TRAIN_LEN, 12, 64
    fwd_tol = {"float32": 1e-4, "bfloat16": 2e-2}
    bwd_tol = {"float32": 1e-4, "bfloat16": 4 * 2.0 ** -8}
    print(f"phase 14 (a): blockwise attention (plain PyTorch; vjp custom) "
          f"against the flash kernels at B={b} L={l} H={h} D={d} causal, "
          f"attention block 128: forward max-abs f32 1e-4 / bf16 2e-2, "
          f"backward f32 1e-4 / bf16 4 ulps of max(1, max |grad|), every "
          f"64-position block within TILE_TOL; custom against autodiff at "
          f"the JAX package's bounds {CTX_VJP_TOL}; ms a call: loop (CUDA "
          f"events), device (profiler; events over the same launches) "
          f"[{card}]", flush=True)
    bad = []
    for dt in ("bfloat16", "float32"):
        for window in (0, CTX_WINDOW):
            dtype = getattr(torch, dt)
            q, k, v, bias = make_attention_inputs(b, l, h, d, dtype, 0, gen)
            g = torch.randn((b, l, h, d), generator=gen,
                            device="cuda").to(dtype)
            o_f, g_f = flash_call(q, k, v, bias, g, window)()
            o_c, g_c = blockwise_call(q, k, v, bias, g, window, "custom")()
            o_a, g_a = blockwise_call(q, k, v, bias, g, window,
                                      "autodiff")()
            torch.cuda.synchronize()
            errs = {"out": ((o_c.float() - o_f.float()).abs().max().item(),
                            fwd_tol[dt],
                            tile_error(o_c.transpose(1, 2),
                                       o_f.transpose(1, 2)))}
            for name, got, ref in zip(("dq", "dk", "dv"), g_c, g_f):
                scale = max(1.0, ref.float().abs().max().item())
                errs[name] = ((got.float() - ref.float()).abs().max().item(),
                              bwd_tol[dt] * scale,
                              tile_error(got.transpose(1, 2),
                                         ref.transpose(1, 2)))
            atol, rtol = CTX_VJP_TOL[dt]
            vjp_ok = torch.equal(o_c, o_a) and all(
                torch.allclose(c.float(), a.float(), atol=atol, rtol=rtol)
                for c, a in zip(g_c, g_a))
            vjp_err = max((c.float() - a.float()).abs().max().item()
                          for c, a in zip(g_c, g_a))
            del o_a, g_a
            times = {}
            for name, call in (
                    ("blockwise fwd", blockwise_call(q, k, v, bias, g,
                                                     window, "custom",
                                                     False)),
                    ("blockwise fwd+bwd", blockwise_call(q, k, v, bias, g,
                                                         window, "custom")),
                    ("flash fwd", flash_call(q, k, v, bias, g, window,
                                             False)),
                    ("flash fwd+bwd", flash_call(q, k, v, bias, g,
                                                 window))):
                dev = device_ms(call, 5)
                times[name] = (time_ms(call, 5), dev, dev.events_ms)
            print(f"  {dt:9s} window={window:3d}: "
                  + "; ".join(f"{n} err {e:.3e} (limit {lim:.3g}), block "
                              f"{t:.3e}" for n, (e, lim, t) in errs.items())
                  + f"; custom against autodiff (out bit-equal, grads "
                  f"within bounds) {vjp_ok}, grads' largest difference "
                  f"{vjp_err:.3e} [{card}]", flush=True)
            print(f"  {dt:9s} window={window:3d} ms loop / device (events): "
                  + "; ".join(f"{n} {lp:.5f} / {dv:.5f} ({ev:.5f})"
                              for n, (lp, dv, ev) in times.items())
                  + f"; blockwise over flash, fwd+bwd loop "
                  f"{times['blockwise fwd+bwd'][0] / times['flash fwd+bwd'][0]:.1f}x"
                  f" [{card}]", flush=True)
            for n, (e, lim, t) in errs.items():
                if not (math.isfinite(e) and e <= lim and t <= TILE_TOL[dt]):
                    bad.append((dt, window, n, e, lim, t))
            if not vjp_ok:
                bad.append((dt, window, "custom vs autodiff", vjp_err))
            del q, k, v, bias, g, o_f, g_f, o_c, g_c
            torch.cuda.empty_cache()
    if bad:
        raise AssertionError(f"phase 14 (a): blockwise attention disagrees "
                             f"with the flash kernels: {bad}")
    ctx_dropout(card)


def ctx_dropout(card: str) -> None:
    """The dropout kernels' slice form, which a context rank's residual
    dropout takes: each of CTX_DROPOUT_SPLITS ranks' L/ctx positions of
    GPT-2 small's (4, 2048, 768) bf16 residual, forward and backward, bit
    for bit the whole tensor's kernel output there and the plain
    version's (their launches compare and are not counted)."""
    import torch

    from kubeflow_tpu_torch.kernels import dropout as kd

    gen = torch.Generator(device="cuda").manual_seed(SEED + 16)
    seed = torch.tensor(SEED + 2**40, dtype=torch.int64, device="cuda")
    b, l, width = TRAIN_BATCH, TRAIN_LEN, 768
    x = torch.randn((b, l, width), generator=gen,
                    device="cuda").to(torch.bfloat16)
    whole = kd.dropout_fwd(x, seed, 0.1, 1).view(torch.int16)
    whole_b = kd.dropout_bwd(x, seed, 0.1, 1).view(torch.int16)
    same = True
    for ctx in CTX_DROPOUT_SPLITS:
        row = (l // ctx) * width
        for i, part in enumerate(x.chunk(ctx, dim=1)):
            span = (row, l * width, i * row)
            part = part.contiguous()
            got = kd.dropout_fwd(part, seed, 0.1, 1, span).view(torch.int16)
            got_b = kd.dropout_bwd(part, seed, 0.1, 1, span).view(
                torch.int16)
            plain = kd.dropout_plain(part, seed, 0.1, 1, span).view(
                torch.int16)
            same = same and torch.equal(got, whole.chunk(ctx, dim=1)[i]) \
                and torch.equal(got, plain) \
                and torch.equal(got_b, whole_b.chunk(ctx, dim=1)[i])
    print(f"phase 14 (a): dropout_fwd/dropout_bwd on each context rank's "
          f"positions of ({b}, {l}, {width}) bf16 for ctx in "
          f"{CTX_DROPOUT_SPLITS}, bit-equal to the whole tensor's kernel "
          f"output and the plain version: {same} [{card}]", flush=True)
    if not same:
        raise AssertionError("phase 14 (a): the dropout kernels' slice form "
                             "draws other masks than the whole tensor's")


def ctx_memory(card: str) -> None:
    """(b) the peak memory of one blockwise attention's forward and
    backward at (1, CTX_MEM_LEN, 12, 64) bf16 causal, custom against
    autodiff (and the flash kernels'): the custom backward keeps O(L)
    residuals and must be the lower."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(SEED + 15)
    q, k, v, bias = make_attention_inputs(1, CTX_MEM_LEN, 12, 64,
                                          torch.bfloat16, 0, gen)
    g = torch.randn(q.shape, generator=gen, device="cuda").to(q.dtype)
    peaks = {}
    for name, call in (("custom", blockwise_call(q, k, v, bias, g, 0,
                                                 "custom")),
                       ("autodiff", blockwise_call(q, k, v, bias, g, 0,
                                                   "autodiff")),
                       ("flash", flash_call(q, k, v, bias, g, 0))):
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        out = call()
        torch.cuda.synchronize()
        peaks[name] = ((torch.cuda.max_memory_allocated() - base) / 2**30,
                       time.perf_counter() - t0)
        del out
    print(f"phase 14 (b): peak device memory of one attention's forward and "
          f"backward above its inputs at (1, {CTX_MEM_LEN}, 12, 64) bf16 "
          f"causal, GiB (one call's wall s): "
          + ", ".join(f"blockwise {n} {p:.3f} ({w:.3f} s)" if n != "flash"
                      else f"the flash kernels {p:.3f} ({w:.3f} s)"
                      for n, (p, w) in peaks.items()) + f" [{card}]",
          flush=True)
    if not peaks["custom"][0] < peaks["autodiff"][0]:
        raise AssertionError(f"phase 14 (b): the custom backward's peak "
                             f"{peaks['custom'][0]:.3f} GiB is not below "
                             f"autodiff's {peaks['autodiff'][0]:.3f}")


def ctx_train(card: str) -> dict:
    """(c) GPT-2 small (f32 parameters, bf16 compute) at 4 x 2048 on a
    context mesh of one, CTX_STEPS steps with attention ring, Ulysses and
    flash from the same weights and batches: ring and Ulysses (blockwise
    attention on one rank) launch no flash kernel, flash each of the four
    12 times a step; losses within CTX_LOSS_ATOL and grad norms within
    CTX_NORM_RTOL of the flash fit's. Returns the flash fit's launches."""
    import torch

    from kubeflow_tpu_torch.models.gpt import GPTConfig, GPTLM
    from kubeflow_tpu_torch.parallel.mesh import MeshConfig
    from kubeflow_tpu_torch.train.data import synthetic_lm_dataset

    cfg = GPTConfig.small(attention="flash", dropout_rate=0.0,
                          max_len=TRAIN_LEN)
    ds = synthetic_lm_dataset(n_train=TRAIN_BATCH * CTX_STEPS,
                              n_test=TRAIN_BATCH, seq_len=TRAIN_LEN,
                              vocab_size=cfg.vocab_size, seed=SEED + 14)
    batches = [(ds.x_train[i * TRAIN_BATCH:(i + 1) * TRAIN_BATCH],
                ds.y_train[i * TRAIN_BATCH:(i + 1) * TRAIN_BATCH])
               for i in range(CTX_STEPS)]
    init = GPTLM(cfg, device="cpu").init_weights(
        torch.Generator().manual_seed(SEED + 14)).state_dict()
    runs = {}
    for kind in ("flash", "ring", "ulysses"):
        model = GPTLM(dataclasses.replace(cfg, attention=kind),
                      device="cuda")
        model.load_state_dict(init)
        trainer = gpt_trainer(cfg, SEED, model=model, steps=CTX_STEPS,
                              mesh=MeshConfig(data=1, context=1))
        state = trainer.init_state()
        rows, ms = [], []
        zero_launches()  # this path's run starts here
        for batch in batches:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, m = trainer.train_step(state, batch)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            rows.append((float(m["loss"]), float(m["grad_norm"])))
        runs[kind] = (rows, ms, _launch_counts(), trainer.compute_dtype)
        del trainer, state, model
        gc.collect()
        torch.cuda.empty_cache()
    flash_rows = runs["flash"][0]
    bad = []
    for kind, (rows, ms, launched, dtype) in runs.items():
        print(f"phase 14 (c): GPT-2 small {kind:7s} on a context mesh of "
              f"one, {TRAIN_BATCH} x {TRAIN_LEN}, {dtype} compute: losses "
              + ", ".join(f"{x:.6f}" for x, _ in rows) + "; grad norms "
              + ", ".join(f"{n:.6f}" for _, n in rows) + "; step ms "
              + ", ".join(f"{t:.2f}" for t in ms)
              + f"; flash launches {launched} [{card}]", flush=True)
        want = ({n: cfg.num_layers * CTX_STEPS for n in FLASH_KERNELS}
                if kind == "flash" else dict.fromkeys(FLASH_KERNELS, 0))
        if launched != want:
            bad.append((kind, "launches", launched, want))
        for (x, n), (xf, nf) in zip(rows, flash_rows):
            if not (math.isfinite(x) and abs(x - xf) <= CTX_LOSS_ATOL
                    and abs(n - nf) <= CTX_NORM_RTOL * nf):
                bad.append((kind, x, xf, n, nf))
    if bad:
        raise AssertionError(f"phase 14 (c): {bad}")
    return runs["flash"][2]


def phase_context(card: str) -> dict:
    """Phase 14 (a)-(c); returns the flash kernels' launches of (c)'s
    flash fit."""
    t0 = time.perf_counter()
    ctx_kernels(card)
    ctx_memory(card)
    launches = ctx_train(card)
    print(f"  phase 14 took {time.perf_counter() - t0:.1f} s [{card}]",
          flush=True)
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device; this script runs on "
              "the card", file=sys.stderr)
        return 2
    from kubeflow_tpu_torch.kernels import KERNELS, build_all
    from kubeflow_tpu_torch.kernels.build import report_path, sources

    t_main = time.perf_counter()
    t_lap = [t_main]

    def lap(what: str) -> None:
        now = time.perf_counter()
        print(f"  [{what} done: {now - t_lap[0]:.1f} s, the script "
              f"{now - t_main:.1f} s so far]", flush=True)
        t_lap[0] = now

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
    spills, routes = tensor_core_report(card)
    moe_trained = phase_moe_train(card)
    lap("phase 13 (b)-(c)")

    timings = {"flash_fwd": phase_kernels(peaks, card, routes)}
    lap("phase 3")
    serve_launches = phase_serve(card)
    lap("phase 4")
    print(f"  serving path: flash_fwd launches {serve_launches} [{card}]",
          flush=True)
    engine_launches, plain = phase_engine(peaks, card)
    lap("phase 7")
    print(f"  engine path: flash_fwd launches {engine_launches} [{card}]",
          flush=True)
    timings.update(phase_backward(peaks, card, routes))
    lap("phase 5")
    launches, step_ms = phase_train(card)
    lap("phase 6")
    phase_restart_warm(card)
    lap("phase 6 restart-warm")
    context_launches = phase_context(card)
    lap("phase 14")
    family_launches = phase_families(card)
    lap("phase 10")
    # phases 8 and 9 come after phase 6: run between phases 7 and 5, phase
    # 8 was followed by torch.profiler traces that lost a kernel's launches
    # at the training shape (see PERF.md, Open questions)
    spec_launches, fleet_ticks = phase_spec_fleet(peaks, card, plain)
    lap("phase 8")
    print(f"  speculative and fleet paths: flash_fwd launches "
          f"{spec_launches} [{card}]", flush=True)
    pod_launches = phase_pods(card, plain, fleet_ticks)
    lap("phase 9")
    print(f"  pod path: flash_fwd launches {pod_launches} (in the prefill "
          f"pod's process) [{card}]", flush=True)
    artifact_launches = phase_artifacts(card)
    lap("phase 11")
    lifecycle_launches, dropout_records = phase_lifecycle(peaks, card)
    lap("phase 12")
    print(f"  the bf16 tensor-core instantiations at D = 128 (phase 13's "
          f"head_dim) spill {spills.get(128, 0)} bytes (phase 2's rows) "
          f"[{card}]", flush=True)
    moe_launches = phase_moe(peaks, card, moe_trained)
    lap("phase 13")
    engine_launches += spec_launches + pod_launches + artifact_launches
    from kubeflow_tpu_torch.models.gpt import GPTConfig

    per_step = GPTConfig.small().num_layers  # one launch a layer a step
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

    if spills.get(64):
        raise AssertionError(f"the bf16 tensor-core kernels spill "
                             f"{spills[64]} bytes at D = 64")

    # flash_fwd's launches: the training path's and the engine paths'; every
    # kernel's: phase 10's families
    launches["flash_fwd"] += engine_launches
    print(f"flash_fwd launches: training "
          f"{launches['flash_fwd'] - engine_launches}, engine, speculative, "
          f"fleet and pod paths (phases 7-9) "
          f"{engine_launches - artifact_launches}, the predictor's "
          f"artifacts (phase 11) {artifact_launches} [{card}]", flush=True)
    for name, n in family_launches.items():
        launches[name] += n
    print(f"launches of the BASELINE families' paths (phase 10): "
          f"{family_launches} [{card}]", flush=True)
    for name, n in lifecycle_launches.items():
        launches[name] = launches.get(name, 0) + n
    print(f"launches of the LLM lifecycle's path (phase 12): "
          f"{lifecycle_launches} [{card}]", flush=True)
    for name, n in moe_launches.items():
        launches[name] += n
    print(f"launches of the sharded and MoE paths (phase 13): "
          f"{moe_launches} [{card}]", flush=True)
    for name, n in context_launches.items():
        launches[name] += n
    print(f"launches of the context path's flash fit (phase 14 (c); its "
          f"ring and Ulysses fits launch none): {context_launches}; the "
          f"whole script {time.perf_counter() - t_main:.1f} s [{card}]",
          flush=True)
    timings.update(dropout_records)   # the flash kernels' summary is above
    record = {"kernels": [{
        "name": name,
        "route": "cuda",
        "source": "kubeflow_tpu_torch/csrc/" + KERNELS[name].source,
        "replaces": KERNELS[name].replaces,
        "launches": launches[name],
        **timings[name],
    } for name in FLASH_KERNELS + DROPOUT_KERNELS]}
    print(card)
    # a time the profiler did not measure is null, not NaN (JSON has none)
    for kern in record["kernels"]:
        for key, value in kern.items():
            if isinstance(value, float) and math.isnan(value):
                kern[key] = None
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
