"""Run a function of a test module in every process of a 2-process gloo
gang on the CPU, as the port's PyTorchJob workers would run.

``run_gang(module, func, tmp_path)`` writes each rank's env from the JAX
package's ``envcontract.pytorch_env`` (a master and a worker replica, the
master's container port a free local port; MASTER_ADDR is the local host,
which the DNS name of the contract stands for here), starts one ``python -m
tests.torch_gang`` process per rank, waits for both within ``timeout``
seconds (a wedged rendezvous fails the test instead of hanging the suite)
and returns what each rank's ``func(out_dir, rank)`` saved with
``save_result``. Each rank runs at a niceness of ``GANG_NICE``: the suite
shares the machine's cores with timing gates in other workers
(tests/test_prof_gate.py, tests/test_soak.py), and a gang's burst of
processes should not take their cores.
"""

from __future__ import annotations

import importlib
import os
import pickle
import socket
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
GANG_TIMEOUT_S = 120.0
GANG_NICE = 5


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def pytorch_job_env(world: int, port: int) -> list[dict[str, str]]:
    """Each rank's PyTorchJob env as the control plane writes it: a master
    replica (rank 0) and world - 1 workers."""
    from kubeflow_tpu.api import (
        JAXJobSpec,
        ObjectMeta,
        REPLICA_MASTER,
        REPLICA_WORKER,
        ReplicaSpec,
    )
    from kubeflow_tpu.api.jobs import PyTorchJob
    from kubeflow_tpu.controller import envcontract

    job = PyTorchJob(
        metadata=ObjectMeta(name="gang", namespace="default"),
        spec=JAXJobSpec(replica_specs={
            REPLICA_MASTER: ReplicaSpec(replicas=1),
            REPLICA_WORKER: ReplicaSpec(replicas=world - 1)}))
    job.spec.replica_specs[REPLICA_MASTER].template.container.ports = {
        "pytorchjob-port": port}
    envs = [envcontract.pytorch_env(job, REPLICA_MASTER, 0)] + [
        envcontract.pytorch_env(job, REPLICA_WORKER, i)
        for i in range(world - 1)]
    for env in envs:
        env["MASTER_ADDR"] = "127.0.0.1"  # the replica's DNS name, here
    return envs


def start_rank(module: str, func: str, out_dir: Path, env: dict,
               extra_env: dict | None = None) -> subprocess.Popen:
    full = {**os.environ, **env, **(extra_env or {}),
            "OMP_NUM_THREADS": "1", "PYTHONPATH": str(ROOT)}
    log = open(out_dir / f"rank{env['RANK']}.log", "w")
    return subprocess.Popen(
        [sys.executable, "-m", "tests.torch_gang", module, func,
         str(out_dir)], cwd=ROOT, env=full, stdout=log,
        stderr=subprocess.STDOUT)


def wait_gang(procs, out_dir: Path, timeout: float = GANG_TIMEOUT_S
              ) -> list:
    deadline = time.monotonic() + timeout
    for p in procs:
        try:
            p.wait(timeout=max(deadline - time.monotonic(), 0.1))
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise AssertionError(
                f"the gang did not finish in {timeout} s:\n" + logs(out_dir))
    if any(p.returncode for p in procs):
        raise AssertionError(f"a gang member failed:\n{logs(out_dir)}")
    return [load_result(out_dir, r) for r in range(len(procs))]


def logs(out_dir: Path) -> str:
    return "\n".join(f"--- {f.name}\n{f.read_text()[-4000:]}"
                     for f in sorted(out_dir.glob("rank*.log")))


def run_gang(module: str, func: str, out_dir: Path, world: int = 2,
             timeout: float = GANG_TIMEOUT_S, extra_env=None) -> list:
    """extra_env: rank -> more env for that rank's process."""
    out_dir.mkdir(parents=True, exist_ok=True)
    envs = pytorch_job_env(world, free_port())
    procs = [start_rank(module, func, out_dir, env,
                        extra_env(r) if extra_env else None)
             for r, env in enumerate(envs)]
    return wait_gang(procs, out_dir, timeout)


def save_result(out_dir, rank: int, value) -> None:
    with open(Path(out_dir) / f"result{rank}.pkl", "wb") as fh:
        pickle.dump(value, fh)


def load_result(out_dir: Path, rank: int):
    with open(out_dir / f"result{rank}.pkl", "rb") as fh:
        return pickle.load(fh)


if __name__ == "__main__":
    os.nice(GANG_NICE)
    import torch

    torch.set_num_threads(1)
    mod, fn, out = sys.argv[1:4]
    rank = int(os.environ["RANK"])
    result = getattr(importlib.import_module(mod), fn)(Path(out), rank)
    save_result(out, rank, result)
