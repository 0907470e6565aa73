"""The serving fleet tier of the port: the paged KV pool (pagedkv.py),
which the continuous engine (serving/continuous.py) uses for prefix reuse
and per-row block chains; the in-process router over N engines with SLO
admission, replica-kill requeue and the disaggregated prefill/decode
split (router.py); the seeded load-test harness (loadtest.py); the closed
autoscaling loop (scaler.py: FleetScaler over the router's demand
signal); and cross-process pod-backed replicas (podworker.py /
podclient.py over the wire.py protocol: each replica a real subprocess
hosting one engine on the card, killed with real signals, with the
paged-KV handoff crossing the process boundary). Counterpart of
``kubeflow_tpu/serving/fleet``.
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
from kubeflow_tpu_torch.serving.fleet.podclient import (
    PodClient,
    PodHandle,
    attach_router_death,
    pod_heartbeat_age_max_s,
    pod_metrics_snapshot,
    spawn_pod,
    wire_pod_deaths,
)
from kubeflow_tpu_torch.serving.fleet.scaler import (
    FleetScaler,
    ScalerConfig,
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
    "FleetScaler",
    "LoadReport",
    "PagedKVPool",
    "PodCallError",
    "PodClient",
    "PodDead",
    "PodDeadlineExpired",
    "PodHandle",
    "PodWireError",
    "PrefixMatch",
    "Replica",
    "ScalerConfig",
    "SequenceChain",
    "attach_router_death",
    "extract_prompt_kv",
    "make_prompts",
    "make_row_template",
    "pod_heartbeat_age_max_s",
    "pod_metrics_snapshot",
    "run_loadtest",
    "run_loadtest_sync",
    "seed_row_cache",
    "spawn_pod",
    "wire_pod_deaths",
]
