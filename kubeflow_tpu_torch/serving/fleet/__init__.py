"""The serving fleet tier of the port: the paged KV pool (pagedkv.py),
which the continuous engine (serving/continuous.py) uses for prefix reuse
and per-row block chains; the in-process router over N engines with SLO
admission, replica-kill requeue and the disaggregated prefill/decode
split (router.py); the seeded load-test harness (loadtest.py); and the
pod wire's failure ladder (wire.py). The pods (cross-process replicas),
the rest of the wire and the scaler of ``kubeflow_tpu/serving/fleet``
are ROADMAP Queue A item 5.
"""

from kubeflow_tpu_torch.serving.fleet.loadtest import (
    LoadReport,
    make_prompts,
    run_loadtest,
    run_loadtest_sync,
)
from kubeflow_tpu_torch.serving.fleet.pagedkv import (
    PagedKVPool,
    PrefixMatch,
    SequenceChain,
    extract_prompt_kv,
    make_row_template,
    seed_row_cache,
)
from kubeflow_tpu_torch.serving.fleet.router import (
    FleetOverloaded,
    FleetRequest,
    FleetRouter,
    Replica,
)
from kubeflow_tpu_torch.serving.fleet.wire import (
    PodCallError,
    PodDead,
    PodDeadlineExpired,
    PodWireError,
)

__all__ = [
    "FleetOverloaded",
    "FleetRequest",
    "FleetRouter",
    "LoadReport",
    "PagedKVPool",
    "PodCallError",
    "PodDead",
    "PodDeadlineExpired",
    "PodWireError",
    "PrefixMatch",
    "Replica",
    "SequenceChain",
    "extract_prompt_kv",
    "make_prompts",
    "make_row_template",
    "run_loadtest",
    "run_loadtest_sync",
    "seed_row_cache",
]
