"""Worker-side distributed bootstrap — counterpart of
``kubeflow_tpu/runtime/distributed.py``.

The control plane writes the PyTorchJob contract into every replica's env
(``kubeflow_tpu/controller/envcontract.py`` ``pytorch_env``): MASTER_ADDR
and MASTER_PORT (the master replica, rank 0), WORLD_SIZE and RANK, plus
the elastic ``PET_*`` keys, which are passed through untouched. A worker
calls ``initialize_from_env()`` first thing: it joins the gang with
``torch.distributed.init_process_group`` over a TCP store at the master
(NCCL when the process drives a card, gloo when the caller asks for the
CPU) and returns the process topology. Without the env it is a no-op, as
single-process runs are in the JAX package.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from datetime import timedelta

#: how long a member waits for the rest of the gang at the store before
#: it fails with the store's error
DEFAULT_RENDEZVOUS_TIMEOUT_S = 300.0


@dataclass(frozen=True)
class DistContext:
    process_id: int
    num_processes: int
    coordinator: str | None
    # multislice topology (MEGASCALE_* contract): slices are the
    # DCN-connected units; processes within a slice share the fast links
    num_slices: int = 1
    slice_id: int = 0

    @property
    def is_distributed(self) -> bool:
        return self.num_processes > 1

    @property
    def is_coordinator(self) -> bool:
        return self.process_id == 0

    @property
    def is_multislice(self) -> bool:
        return self.num_slices > 1

    @property
    def processes_per_slice(self) -> int:
        return self.num_processes // max(self.num_slices, 1)


def initialize_from_env(backend: str | None = None,
                        timeout_s: float = DEFAULT_RENDEZVOUS_TIMEOUT_S
                        ) -> DistContext:
    """Join the gang the PyTorchJob env describes.

    backend: None takes NCCL, which needs a card: without one this raises,
    it never falls back to gloo quietly; "gloo" is the CPU gang (tests, and
    processes that share one card). With MASTER_ADDR set the process group
    is initialized over ``tcp://MASTER_ADDR:MASTER_PORT`` with WORLD_SIZE
    and RANK (a world of one included); a member the gang does not meet
    within ``timeout_s`` fails with the store's error and never carries on
    alone. Heartbeats ``rendezvous`` and ``rendezvous-done`` (the pod's
    KFTPU_HEARTBEAT_FILE) bracket the rendezvous, which runs under a
    ``rendezvous`` span when the pod carries KFTPU_TRACE_DIR."""
    import torch
    import torch.distributed as dist

    from kubeflow_tpu_torch.health import HeartbeatWriter

    addr = os.environ.get("MASTER_ADDR")
    port = os.environ.get("MASTER_PORT")
    n = int(os.environ.get("WORLD_SIZE", "1"))
    pid = int(os.environ.get("RANK", "0"))
    coord = f"{addr}:{port}" if addr else None
    # liveness: announce this incarnation BEFORE anything that can wedge
    # (the rendezvous) — a worker stuck right here is the hang the lease
    # detector exists for
    hb = HeartbeatWriter.from_env()
    if hb is not None:
        hb.min_interval_s = 0.0  # both beats land, however fast the gang
        hb.beat(step=-1, phase="rendezvous")
    num_slices = int(os.environ.get("MEGASCALE_NUM_SLICES", "1"))
    slice_id = int(os.environ.get("MEGASCALE_SLICE_ID", "0"))
    if num_slices > 1:
        if n % num_slices:
            raise ValueError(
                f"WORLD_SIZE {n} not divisible by "
                f"MEGASCALE_NUM_SLICES {num_slices}"
            )
        expect = pid // (n // num_slices)
        if slice_id != expect:
            raise ValueError(
                f"MEGASCALE_SLICE_ID {slice_id} inconsistent with process "
                f"{pid}/{n} over {num_slices} slices (expected {expect})"
            )
    if backend not in (None, "nccl", "gloo"):
        raise ValueError(f"backend {backend!r} is not nccl|gloo")
    backend = backend or "nccl"
    if backend == "nccl" and not torch.cuda.is_available():
        raise RuntimeError(
            "initialize_from_env: NCCL needs a CUDA device and torch sees "
            "none; pass backend='gloo' to form a CPU gang")
    if coord and not dist.is_initialized():
        if not port:
            raise ValueError("MASTER_ADDR is set but MASTER_PORT is not")
        if backend == "nccl":
            local = int(os.environ.get(
                "LOCAL_RANK", pid % torch.cuda.device_count()))
            torch.cuda.set_device(local)
        # the gang's rendezvous is the canonical recovery-path span: a
        # restarted gang's wall-clock between rebind and first step is
        # mostly spent right here
        from kubeflow_tpu_torch.tracing import init_worker_from_env

        tracer = init_worker_from_env(service="worker")
        with tracer.span("rendezvous", coordinator=coord, world=n,
                         rank=pid, backend=backend):
            dist.init_process_group(
                backend, init_method=f"tcp://{coord}", world_size=n,
                rank=pid, timeout=timedelta(seconds=timeout_s))
    if hb is not None:
        # the gang is formed: subsequent beats come from the training loop
        hb.beat(step=-1, phase="rendezvous-done")
    return DistContext(
        process_id=pid, num_processes=n, coordinator=coord,
        num_slices=num_slices, slice_id=slice_id,
    )


def shutdown() -> None:
    """Leave the gang: destroy the process group; a no-op without one."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()
