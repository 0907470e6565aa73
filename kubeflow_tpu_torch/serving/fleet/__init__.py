"""The serving fleet tier of the port — so far the paged KV pool
(pagedkv.py), which the continuous engine (serving/continuous.py) uses for
prefix reuse and per-row block chains. The router, pods, wire, load test
and scaler of ``kubeflow_tpu/serving/fleet`` are ROADMAP Queue A item 5.
"""

from kubeflow_tpu_torch.serving.fleet.pagedkv import (
    PagedKVPool,
    PrefixMatch,
    SequenceChain,
    extract_prompt_kv,
    make_row_template,
    seed_row_cache,
)

__all__ = [
    "PagedKVPool",
    "PrefixMatch",
    "SequenceChain",
    "extract_prompt_kv",
    "make_row_template",
    "seed_row_cache",
]
