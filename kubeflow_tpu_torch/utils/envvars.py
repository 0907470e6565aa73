"""The pod env contract of the port — own copy of the names in
``kubeflow_tpu/utils/envvars.py`` that the port's workers speak.

The controller side injects these variables (``spawn_pod``) and the worker
side reads them (``podworker``, ``tracing.init_worker_from_env``,
``health.HeartbeatWriter.from_env``, the trainer). A typo'd literal on
either side does not fail loudly — the reader just sees "unset" — so both
sides import the constant and never spell the string.
"""

from __future__ import annotations

#: directory worker processes flush their trace spans into
ENV_TRACE_DIR = "KFTPU_TRACE_DIR"
#: parent SpanContext carried into a pod ("traceid-spanid")
ENV_TRACEPARENT = "KFTPU_TRACEPARENT"
#: torch.profiler trace output dir of a training fit
ENV_PROFILE_DIR = "KFTPU_PROFILE_DIR"
#: restart-warm cache dir that survives gang restarts: the trainer builds
#: the kernels' libraries into it and loads them from it
ENV_COMPILE_CACHE_DIR = "KFTPU_COMPILE_CACHE_DIR"
#: tfevents scalar output dir for TensorBoard
ENV_EVENT_DIR = "KFTPU_EVENT_DIR"
#: per-incarnation heartbeat file one worker writes (liveness lease)
ENV_HEARTBEAT_FILE = "KFTPU_HEARTBEAT_FILE"
#: chaos carrier for seeded heartbeat-write drops ("rate:seed:count")
ENV_HEARTBEAT_DROP = "KFTPU_HB_DROP"
#: AF_UNIX socket path a serving pod worker binds (podworker/podclient)
ENV_POD_SOCKET = "KFTPU_POD_SOCKET"
#: the pod worker's replica name (trace service, heartbeat identity)
ENV_POD_NAME = "KFTPU_POD_NAME"
#: path to the JSON engine spec a pod worker builds its batcher from
ENV_POD_SPEC = "KFTPU_POD_SPEC"
#: wire transport a pod worker serves on: "unix" (default) or "tcp"
ENV_POD_TRANSPORT = "KFTPU_POD_TRANSPORT"
#: file a TCP pod worker atomically writes its bound 127.0.0.1 port to
#: (the controller polls it the way it polls the AF_UNIX socket path)
ENV_POD_PORT_FILE = "KFTPU_POD_NET_PORT_FILE"
#: PVC mount root: pvc://volume/sub -> $KFTPU_PVC_ROOT/volume/sub
ENV_PVC_ROOT = "KFTPU_PVC_ROOT"
#: local tree emulating gs://, s3://, hf://, http(s):// object stores
ENV_OBJECT_STORE_EMULATOR = "KFTPU_OBJECT_STORE_EMULATOR"
#: the model server's kernel cache dir (the JAX package's name): the
#: deploy step's export_predictor(compile_cache=...) built the kernel
#: libraries there, and a server pointed at it builds none
ENV_SERVING_COMPILE_CACHE = "KFT_COMPILE_CACHE"
