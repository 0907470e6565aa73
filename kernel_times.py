#!/usr/bin/env python3
"""Loop and device times of one tree's flash_fwd and flash_bwd_dd on a card.

    python3 kernel_times.py TREE_ROOT LABEL

Imports kubeflow_tpu_torch from TREE_ROOT (this repository's root, or a
`git archive` of another commit unpacked elsewhere) and times its
flash_fwd and flash_bwd_dd wrappers, and `(dO*O).sum(-1)`, at the training
shape (4, 2048, 12, 64) bf16 causal, with chip_smoke.py's `time_ms` (CUDA
events around back-to-back calls) and `device_ms` (torch.profiler) from
this directory. Prints the card and one JSON line. To compare two commits
on one card, run both trees in one session, alternating (parent, change,
change, parent).
"""

from __future__ import annotations

import json
import sys
from pathlib import Path


def main() -> int:
    if len(sys.argv) != 3:
        print(__doc__, file=sys.stderr)
        return 2
    root, label = Path(sys.argv[1]).resolve(), sys.argv[2]
    import torch

    if not torch.cuda.is_available():
        print("kernel_times: torch sees no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke  # this directory's timing code, whatever the tree

    sys.path.insert(0, str(root))
    from kubeflow_tpu_torch.kernels.flash_bwd import flash_bwd_dd
    from kubeflow_tpu_torch.kernels.flash_fwd import flash_fwd

    gen = torch.Generator(device="cuda").manual_seed(chip_smoke.SEED)
    shape = (chip_smoke.TRAIN_BATCH, chip_smoke.TRAIN_LEN, 12, 64)
    q, k, v, g = (torch.randn(shape, generator=gen, device="cuda")
                  .to(torch.bfloat16) for _ in range(4))
    bias = torch.zeros((shape[0], 1, 1, shape[1]), device="cuda",
                       dtype=torch.bfloat16)
    o, _ = flash_fwd(q, k, v, bias, True, 0)
    out = {"label": label, "tree": str(root), "card": chip_smoke.card_line()}
    for name, fn, iters in (
            ("flash_fwd", lambda: flash_fwd(q, k, v, bias, True, 0), 20),
            ("flash_bwd_dd", lambda: flash_bwd_dd(o, g), 50),
            ("(dO*O).sum(-1)", lambda: (g * o).sum(-1), 50)):
        out[name] = {"ms": chip_smoke.time_ms(fn, iters),
                     "device_ms": chip_smoke.device_ms(fn, iters)}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
