#!/usr/bin/env python3
"""Seconds one tree's Trainer takes to prepare a graphed fit's CUDA graph.

    python3 capture_times.py TREE_ROOT LABEL

Imports kubeflow_tpu_torch from TREE_ROOT (this repository's root, or a
`git archive` of another commit unpacked elsewhere), builds its kernels,
and for the graphed fits of chip_smoke.py's phases 6, 10 (b) and 12 (b)
(GPT-2 small at TRAIN_BATCH x TRAIN_LEN, fused_steps TRAIN_FUSED; the
BERT-base classifier at FAM_BERT_BATCH x FAM_BERT_LEN, FAM_BERT_FUSED;
LoRA over GPT-2 small at LORA_BATCH x LORA_LEN with dropout LORA_DROPOUT,
LORA_FUSED), each from seeded weights and a fresh optimizer as a fit
starts, times `Trainer.compile_fused`: the warm-up steps, the snapshot that
undoes them and the capture. Then it times one replay of the graph (CUDA
events around back-to-back replays, chip_smoke.py's `time_ms`). Prints the
card and one JSON line. To compare two commits on one card, run both trees
in one session, alternating (parent, change, change, parent).
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path


def main() -> int:
    if len(sys.argv) != 3:
        print(__doc__, file=sys.stderr)
        return 2
    root, label = Path(sys.argv[1]).resolve(), sys.argv[2]
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("capture_times: torch sees no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as c  # this directory's settings, whatever the tree

    sys.path.insert(0, str(root))
    from kubeflow_tpu_torch.kernels import build_all
    from kubeflow_tpu_torch.models.bert import (
        BertConfig,
        BertForSequenceClassification,
    )
    from kubeflow_tpu_torch.models.gpt import GPTConfig, GPTLM
    from kubeflow_tpu_torch.train.trainer import Trainer, TrainerConfig

    build_all()

    def gpt2(length, dropout=0.0):
        cfg = GPTConfig.small(max_len=length, attention="flash",
                              dropout_rate=dropout)
        return GPTLM(cfg, device="cuda").init_weights(
            torch.Generator().manual_seed(c.SEED))

    def ids(b, length, vocab):
        rng = np.random.RandomState(c.SEED)
        return rng.randint(1, vocab, (b, length)).astype(np.int32)

    def gpt_fit():
        model = gpt2(c.TRAIN_LEN)
        x = ids(c.TRAIN_BATCH, c.TRAIN_LEN, model.cfg.vocab_size)
        return (c.gpt_trainer(model.cfg, c.SEED, model=model,
                              fused_steps=c.TRAIN_FUSED), (x, x),
                c.TRAIN_FUSED)

    def bert_fit():
        cfg = BertConfig.base(attention="flash", dropout_rate=0.0)
        model = BertForSequenceClassification(cfg, 2, device="cuda"
                                              ).init_weights(
            torch.Generator().manual_seed(c.SEED))
        trainer = Trainer(model, TrainerConfig(
            batch_size=c.FAM_BERT_BATCH, steps=c.FAM_BERT_STEPS,
            learning_rate=1e-4, log_every_steps=1, seed=c.SEED,
            fused_steps=c.FAM_BERT_FUSED))
        x = ids(c.FAM_BERT_BATCH, c.FAM_BERT_LEN, cfg.vocab_size)
        y = np.arange(c.FAM_BERT_BATCH, dtype=np.int32) % 2
        return trainer, (x, y), c.FAM_BERT_FUSED

    def lora_fit():
        base = gpt2(c.LORA_LEN, c.LORA_DROPOUT)
        x = ids(c.LORA_BATCH, c.LORA_LEN, base.cfg.vocab_size)
        return c.lora_trainer(base, c.LORA_FUSED), (x, x), c.LORA_FUSED

    out = {"label": label, "tree": str(root), "card": c.card_line()}
    for name, make in (("phase 6 GPT-2 small", gpt_fit),
                       ("phase 10 BERT-base", bert_fit),
                       ("phase 12 LoRA", lora_fit)):
        trainer, batch, k = make()
        state = trainer.init_state()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        program, placed = trainer.compile_fused(state, batch, k)
        torch.cuda.synchronize()
        prepare = time.perf_counter() - t0
        out[name] = {"compile_fused_s": prepare, "steps": k,
                     "replay_ms": c.time_ms(lambda: program(state, placed),
                                            5)}
        del trainer, state, program, placed
        torch.cuda.empty_cache()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
