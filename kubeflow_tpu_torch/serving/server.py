"""ModelServer — REST surface speaking the v1 and v2 inference protocols;
counterpart of ``kubeflow_tpu/serving/server.py``.

Routes:
  GET  /v2                         server metadata
  GET  /v2/health/live             liveness
  GET  /v2/health/ready            readiness (all models loaded)
  GET  /v2/models/{m}              model metadata
  GET  /v2/models/{m}/ready        per-model readiness
  POST /v2/models/{m}/infer        OIP inference
  GET  /v1/models/{m}              v1 status
  POST /v1/models/{m}:predict      v1 inference ({"instances": [...]})
  POST /v1/models/{m}:explain      v1 explanation (an ExplainedModel)
  POST /v2/repository/index        the repository's models and states
  POST /v2/repository/models/{m}/load    load from repository_dir or a
                                         body {"storage_uri": ...}
  POST /v2/repository/models/{m}/unload
  GET  /metrics                    request counters and latency histograms,
                                   engine and fleet gauges, batcher and
                                   kernel launch counters

A model served by the continuous-batching engine (or a fleet of them)
answers v1 requests with the engine's own timing (``"timing": {"ttft_s",
"tokens_per_s"}``); a fleet's admission shed answers 503 with a
``Retry-After`` header and a body carrying the shed decision's span
context and request id. With ``max_batch_size`` > 0 concurrent requests
to a model coalesce into one forward pass (agent.MicroBatcher). gRPC
waits for a later slice.

Run as a pod: python -m kubeflow_tpu_torch.serving.server --model-name m
(--model-dir DIR | --storage-uri URI) [--device cuda|cpu] [--aot]
[--max-batch-size N]
"""

from __future__ import annotations

import json
import os
import re
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from kubeflow_tpu_torch.serving.agent import MicroBatcher, RequestLogger
from kubeflow_tpu_torch.serving.model import Model
from kubeflow_tpu_torch.serving.requestid import (
    get_request_id,
    new_request_id,
    set_request_id,
)

SERVER_NAME = "kubeflow-tpu-torch-modelserver"
SERVER_VERSION = "0.1"

_V2_TO_NP = {
    "FP16": np.float16, "FP32": np.float32, "FP64": np.float64,
    "INT8": np.int8, "INT16": np.int16, "INT32": np.int32, "INT64": np.int64,
    "UINT8": np.uint8, "BOOL": np.bool_,
}
_NP_TO_V2 = {np.dtype(v): k for k, v in _V2_TO_NP.items()}


def _np_to_datatype(arr: np.ndarray) -> str:
    return _NP_TO_V2.get(arr.dtype, "FP32")


class _RawJSON:
    """Pre-serialized JSON response body (serialized once), with any
    extra response headers (the fleet's 503 carries Retry-After)."""

    __slots__ = ("data", "headers")

    def __init__(self, data: bytes, headers: dict | None = None):
        self.data = data
        self.headers = headers or {}


def _retry_after(exc) -> dict:
    """The shed's Retry-After header: whole seconds, at least 1."""
    return {"Retry-After": str(max(1, int(round(exc.retry_after_s))))}


class ModelServer:
    """Hosts a repository of models behind one HTTP port.

    Agent capabilities (serving/agent.py): request/response logging
    (`request_log_path` + GET /metrics counters), adaptive micro-batching
    (`max_batch_size` > 0 enables; concurrent requests coalesce into one
    forward pass), and the v2 repository API for multi-model load/unload
    against `repository_dir`, each load a TorchModel on `device`.
    """

    def __init__(self, models: list[Model] | None = None, port: int = 8080,
                 host: str = "127.0.0.1", request_log_path: str | None = None,
                 max_batch_size: int = 0, batch_max_latency_ms: float = 5.0,
                 repository_dir: str = "", device: str = "cuda"):
        self.models: dict[str, Model] = {}
        self.host = host
        self.port = port
        self.logger = RequestLogger(request_log_path)
        self.max_batch_size = max_batch_size
        self.batch_max_latency_ms = batch_max_latency_ms
        self.repository_dir = repository_dir
        self.device = device
        self._batchers: dict[str, MicroBatcher] = {}
        self._httpd: ThreadingHTTPServer | None = None
        self._thread: threading.Thread | None = None
        for m in models or []:
            self.register(m)

    def register(self, model: Model) -> None:
        self.models[model.name] = model
        if self.max_batch_size > 0:
            old = self._batchers.pop(model.name, None)
            if old is not None:
                old.stop()
            self._batchers[model.name] = MicroBatcher(
                model, self.max_batch_size, self.batch_max_latency_ms)

    def unregister(self, name: str) -> bool:
        b = self._batchers.pop(name, None)
        if b is not None:
            b.stop()
        m = self.models.pop(name, None)
        close = getattr(m, "close", None)
        if close is not None:
            close()  # engine/fleet ticker threads die with the model
        return m is not None

    def _call_model(self, m: Model, arr):
        # dict inputs (multi-input models) cannot coalesce on a shared
        # batch axis: they bypass the batcher
        batcher = self._batchers.get(m.name)
        if batcher is not None and not isinstance(arr, dict):
            return batcher(arr)
        return m(arr)

    # ----------------------------------------------------------- lifecycle

    def start(self, block: bool = False) -> "ModelServer":
        for m in self.models.values():
            if not m.ready:
                m.load()
        self._httpd = ThreadingHTTPServer((self.host, self.port),
                                          _make_handler(self))
        self.port = self._httpd.server_address[1]  # resolve port 0
        if block:
            self._httpd.serve_forever()
        else:
            self._thread = threading.Thread(
                target=self._httpd.serve_forever, daemon=True)
            self._thread.start()
        return self

    def stop(self) -> None:
        for b in self._batchers.values():
            b.stop()
        for m in self.models.values():
            close = getattr(m, "close", None)
            if close is not None:
                close()  # engine ticker threads die with the model
        self.logger.close()
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=10.0)

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    # ------------------------------------------------------------ handlers

    def handle_get(self, path: str) -> tuple[int, object]:
        if path == "/metrics":
            # raw prometheus text, then the engines' scheduler gauges, then
            # the port's own counters (the batchers', the kernels')
            return 200, (self.logger.render_metrics() + self._engine_gauges()
                         + self._port_counters())
        if path == "/v2":
            return 200, {"name": SERVER_NAME, "version": SERVER_VERSION,
                         "extensions": []}
        if path == "/v2/health/live":
            return 200, {"live": True}
        if path == "/v2/health/ready":
            ready = all(m.ready for m in self.models.values()) \
                and bool(self.models)
            return (200 if ready else 503), {"ready": ready}
        if path.startswith("/v2/models/") and path.endswith("/ready"):
            name = path[len("/v2/models/"):-len("/ready")]
            m = self.models.get(name)
            if m is None:
                return 404, {"error": f"model {name!r} not found"}
            return (200 if m.ready else 503), {"name": name, "ready": m.ready}
        if path.startswith("/v2/models/"):
            name = path[len("/v2/models/"):]
            m = self.models.get(name)
            if m is None:
                return 404, {"error": f"model {name!r} not found"}
            meta = {"name": name, "platform": "pytorch", "versions": ["1"]}
            im = self.input_metadata(m)
            if im is not None:
                meta["inputs"] = [im]
            return 200, meta
        if path.startswith("/v1/models/"):
            name = path[len("/v1/models/"):]
            m = self.models.get(name)
            if m is None:
                return 404, {"error": f"model {name!r} not found"}
            return 200, {"name": name, "ready": m.ready}
        return 404, {"error": f"no route {path!r}"}

    def _engine_gauges(self) -> str:
        """The continuous-batching engines' and fleets' gauges, with the
        JAX package's metric names: instantaneous best-effort reads (the
        ticker moves rows and the dispatch count outside the engine's lock,
        which guards only the submit queue, so a mid-tick read can be off
        by one row or dispatch)."""
        eng_lines, fleet_lines = [], []
        for name, m in sorted(self.models.items()):
            fleet = getattr(m, "_fleet", None)
            engines = ([(name, getattr(m, "_engine", None))]
                       if fleet is None else
                       [(f"{name}:{r.name}", r.engine)
                        for r in fleet.replicas])
            if fleet is not None:
                fleet_lines += [
                    f'kfserving_fleet_{k}{{model="{name}"}} {v}'
                    for k, v in sorted(fleet.snapshot().items())
                    if isinstance(v, (int, float))
                ]
            for label, eng in engines:
                if eng is None:
                    continue
                busy = sum(1 for r in eng._rows if r is not None)
                with eng._lock:
                    queued = len(eng._queue)
                eng_lines += [
                    f'kfserving_engine_decode_dispatches_total'
                    f'{{model="{label}"}} {eng.step_count}',
                    f'kfserving_engine_rows_busy{{model="{label}"}} {busy}',
                    f'kfserving_engine_rows_total{{model="{label}"}} '
                    f'{eng.max_rows}',
                    f'kfserving_engine_queue_depth{{model="{label}"}} '
                    f'{queued}',
                ]
        text = ""
        if fleet_lines:
            text += "# TYPE kfserving_fleet gauge\n" \
                + "\n".join(fleet_lines) + "\n"
        if eng_lines:
            text += "\n".join(
                ["# TYPE kfserving_engine_decode_dispatches_total counter",
                 "# TYPE kfserving_engine_rows_busy gauge",
                 "# TYPE kfserving_engine_rows_total gauge",
                 "# TYPE kfserving_engine_queue_depth gauge"]
                + eng_lines) + "\n"
        return text

    def _port_counters(self) -> str:
        """Counters the JAX package's server has no counterpart of: each
        micro-batcher's forward passes and the requests they carried, and
        this process's launches of each hand-written kernel (a served
        forward that ran the plain path would not move them)."""
        from kubeflow_tpu_torch.kernels.build import KERNELS

        lines = []
        if self._batchers:
            for kind, attr in (("batches", "batches_run"),
                               ("requests", "requests_batched")):
                lines.append(f"# TYPE kfserving_batcher_{kind}_total counter")
                lines += [f'kfserving_batcher_{kind}_total{{model="{n}"}} '
                          f"{getattr(b, attr)}"
                          for n, b in sorted(self._batchers.items())]
        lines.append("# TYPE kftpu_kernel_launches_total counter")
        lines += [f'kftpu_kernel_launches_total{{kernel="{n}"}} {k.launches}'
                  for n, k in KERNELS.items()]
        return "\n".join(lines) + "\n"

    def handle_post(self, path: str, body: dict,
                    req_bytes: int = 0) -> tuple[int, object]:
        if path.startswith("/v1/models/") and path.endswith(":predict"):
            name = path[len("/v1/models/"):-len(":predict")]
            return self._logged(name, "v1", req_bytes, self._predict_v1, body)
        if path.startswith("/v1/models/") and path.endswith(":explain"):
            name = path[len("/v1/models/"):-len(":explain")]
            return self._logged(name, "v1-explain", req_bytes,
                                self._explain_v1, body)
        if path.startswith("/v2/models/") and path.endswith("/infer"):
            name = path[len("/v2/models/"):-len("/infer")]
            return self._logged(name, "v2", req_bytes, self._infer_v2, body)
        # ---- v2 repository API (multi-model load/unload)
        if path == "/v2/repository/index":
            return 200, [
                {"name": n, "state": "READY" if m.ready else "UNAVAILABLE",
                 "version": "1"}
                for n, m in sorted(self.models.items())
            ]
        prefix = "/v2/repository/models/"
        if path.startswith(prefix) and path.endswith("/load"):
            return self._repo_load(path[len(prefix):-len("/load")], body)
        if path.startswith(prefix) and path.endswith("/unload"):
            name = path[len(prefix):-len("/unload")]
            if not self.unregister(name):
                return 404, {"error": f"model {name!r} not found"}
            return 200, {"name": name, "state": "UNAVAILABLE"}
        return 404, {"error": f"no route {path!r}"}

    def _repo_load(self, name: str, body: dict) -> tuple[int, dict]:
        """Load (or reload) a model from the repository dir or a storage
        URI — the kserve agent's multi-model puller."""
        from kubeflow_tpu_torch.serving.model import TorchModel
        from kubeflow_tpu_torch.serving.storage import pull_model

        # the name becomes a filesystem path component: allowlist it so a
        # crafted '../..' name can never escape the repository dir
        # (pull_model rmtree's its destination)
        if not re.fullmatch(r"[A-Za-z0-9][A-Za-z0-9._-]*", name):
            return 422, {"error": f"invalid model name {name!r}"}
        uri = (body or {}).get("storage_uri", "")
        try:
            if uri:
                model_dir = pull_model(
                    uri,
                    f"{self.repository_dir or '.kubeflow_tpu/models'}/{name}")
            elif self.repository_dir:
                model_dir = f"{self.repository_dir}/{name}"
            else:
                return 400, {"error": "no storage_uri and no repository_dir"}
            model = TorchModel(name, model_dir, device=self.device)
            model.load()
        except Exception as exc:  # noqa: BLE001 — a client-visible error
            return 500, {"error": f"{type(exc).__name__}: {exc}"}
        self.register(model)
        return 200, {"name": name, "state": "READY"}

    def _logged(self, name: str, protocol: str, req_bytes: int, fn, body):
        t0 = time.perf_counter()
        # handlers return (code, payload) or (code, payload, headers) —
        # the fleet's 503 shed carries its Retry-After hint through here
        out = fn(name, body)
        code, payload = out[0], out[1]
        headers = out[2] if len(out) > 2 else None
        # error bodies carry the request id, so a logged 4xx/5xx is
        # greppable back to its X-Request-Id
        rid = get_request_id()
        if code >= 400 and isinstance(payload, dict) and rid:
            payload.setdefault("request_id", rid)
        data = json.dumps(payload).encode()
        self.logger.log(name, protocol, code, time.perf_counter() - t0,
                        req_bytes, len(data))
        return code, _RawJSON(data, headers)

    @staticmethod
    def postprocess_arrays(out) -> list[tuple[str, np.ndarray]]:
        """Normalize a model's output into named v2 tensors."""
        if isinstance(out, dict):
            if "predictions" in out and set(out) <= {"predictions", "logits"}:
                return [
                    ("predictions", np.asarray(out["predictions"])),
                    ("logits",
                     np.asarray(out.get("logits", []), dtype=np.float32)),
                ]
            return [(str(k), np.asarray(v)) for k, v in out.items()]
        return [("output-0", np.asarray(out))]

    @staticmethod
    def input_metadata(m: Model) -> dict | None:
        """v2 metadata for a model's input tensor."""
        cfg = getattr(m, "config", None)
        if not cfg:
            return None
        return {
            "name": "input-0",
            "datatype": _NP_TO_V2.get(np.dtype(cfg["input_dtype"]), "FP32"),
            "shape": [-1, *cfg["input_shape"][1:]],
        }

    @staticmethod
    def _shed_body(exc) -> dict:
        """The 503 shed response body: error + the shed decision's span
        context and request id when tracing stamped them."""
        body = {"error": str(exc)}
        ctx = getattr(exc, "trace_ctx", None)
        if ctx is not None:
            body["trace"] = ctx.to_header()
        rid = getattr(exc, "request_id", "") or get_request_id()
        if rid:
            body["request_id"] = rid
        return body

    def _get_ready_model(self, name: str) -> Model | tuple[int, dict]:
        m = self.models.get(name)
        if m is None:
            return 404, {"error": f"model {name!r} not found"}
        if not m.ready:
            return 503, {"error": f"model {name!r} not ready"}
        return m

    def _predict_v1(self, name: str, body: dict) -> tuple:
        from kubeflow_tpu_torch.serving.fleet import FleetOverloaded

        m = self._get_ready_model(name)
        if isinstance(m, tuple):
            return m
        instances = body.get("instances")
        if instances is None:
            return 400, {"error": "v1 request must carry 'instances'"}
        timing = None
        try:
            if getattr(m, "_engine", None) is not None \
                    or getattr(m, "_fleet", None) is not None:
                # engine/fleet decode: thread the streaming timing (TTFT,
                # tokens/sec) into the response so clients see engine
                # truth, not HTTP wall-time guesses
                raw, timing = m.predict_timed(
                    m.preprocess(np.asarray(instances)))
                out = m.postprocess(raw)
            else:
                out = self._call_model(m, np.asarray(instances))
        except FleetOverloaded as exc:
            # the activator's shed contract: the client re-dials after
            # the hint; the body makes the shed attributable in the trace
            return 503, self._shed_body(exc), _retry_after(exc)
        except Exception as exc:  # noqa: BLE001 — a 500, keep serving
            return 500, {"error": f"{type(exc).__name__}: {exc}"}
        if isinstance(out, dict):
            body = {k: v.tolist() if isinstance(v, np.ndarray) else v
                    for k, v in out.items()}
            if "predictions" not in body:
                body = {"predictions": body}
        else:
            body = {"predictions": np.asarray(out).tolist()}
        if timing is not None:
            body["timing"] = timing
        return 200, body

    def _explain_v1(self, name: str, body: dict) -> tuple[int, dict]:
        m = self._get_ready_model(name)
        if isinstance(m, tuple):
            return m
        # no-explainer is a routing fact, decided by type — a crashing
        # explainer (incl. a NotImplementedError from user code) is a 500
        if type(m).explain is Model.explain:
            return 404, {"error": f"model {name!r} has no explainer"}
        instances = body.get("instances")
        if instances is None:
            return 400, {"error": "v1 request must carry 'instances'"}
        try:
            out = m.explain(np.asarray(instances))
        except Exception as exc:  # noqa: BLE001 — a 500, keep serving
            return 500, {"error": f"{type(exc).__name__}: {exc}"}
        if isinstance(out, dict):
            return 200, out
        return 200, {"explanations": np.asarray(out).tolist()}

    def _infer_v2(self, name: str, body: dict) -> tuple:
        from kubeflow_tpu_torch.serving.fleet import FleetOverloaded

        m = self._get_ready_model(name)
        if isinstance(m, tuple):
            return m
        inputs = body.get("inputs") or []
        if len(inputs) != 1:
            return 400, {"error": "v2 request must carry exactly one entry "
                                  "in 'inputs'"}
        t = inputs[0]
        try:
            arr = np.asarray(
                t["data"],
                dtype=_V2_TO_NP.get(t.get("datatype", "FP32"), np.float32),
            ).reshape(t["shape"])
            out = self._call_model(m, arr)
        except FleetOverloaded as exc:
            # same shed contract as v1
            return 503, self._shed_body(exc), _retry_after(exc)
        except Exception as exc:  # noqa: BLE001
            return 500, {"error": f"{type(exc).__name__}: {exc}"}
        return 200, {
            "model_name": name,
            "model_version": "1",
            "outputs": [
                {
                    "name": k,
                    "shape": list(v.shape),
                    "datatype": _np_to_datatype(v),
                    "data": v.ravel().tolist(),
                }
                for k, v in self.postprocess_arrays(out)
            ],
        }


def _make_handler(server: ModelServer):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # route to stdout for pod logs
            print(f"[http] {fmt % args}", flush=True)

        def _assign_request_id(self) -> None:
            # assign-or-echo: the id rides a contextvar on this request
            # thread so every error body can stamp it
            set_request_id(self.headers.get("X-Request-Id")
                           or new_request_id())

        def _reply(self, code: int, payload) -> None:
            headers = {}
            if isinstance(payload, _RawJSON):
                headers = payload.headers
                data, ctype = payload.data, "application/json"
            elif isinstance(payload, str):
                data, ctype = payload.encode(), "text/plain; version=0.0.4"
            else:
                if code >= 400 and isinstance(payload, dict) \
                        and get_request_id():
                    payload.setdefault("request_id", get_request_id())
                data, ctype = json.dumps(payload).encode(), "application/json"
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(data)))
            if get_request_id():
                self.send_header("X-Request-Id", get_request_id())
            for key, value in headers.items():
                self.send_header(key, value)
            self.end_headers()
            self.wfile.write(data)

        def do_GET(self):  # noqa: N802 (http.server API)
            self._assign_request_id()
            code, payload = server.handle_get(self.path)
            self._reply(code, payload)

        def do_POST(self):  # noqa: N802
            self._assign_request_id()
            length = int(self.headers.get("Content-Length", 0))
            try:
                body = json.loads(self.rfile.read(length) or b"{}")
            except json.JSONDecodeError as exc:
                self._reply(400, {"error": f"bad json: {exc}"})
                return
            code, payload = server.handle_post(self.path, body,
                                               req_bytes=length)
            self._reply(code, payload)

    return Handler


# -------------------------------------------------------------------- main

def main(argv: list[str] | None = None) -> None:
    import argparse

    from kubeflow_tpu_torch.serving.model import (
        ExplainedModel,
        TorchModel,
        TransformedModel,
        load_model_class,
    )
    from kubeflow_tpu_torch.serving.storage import pull_model
    from kubeflow_tpu_torch.utils.device import select_device
    from kubeflow_tpu_torch.utils.envvars import ENV_SERVING_COMPILE_CACHE

    ap = argparse.ArgumentParser(description="kubeflow-tpu-torch model server")
    ap.add_argument("--model-name", required=True)
    ap.add_argument("--storage-uri", default="")
    ap.add_argument("--model-dir", default=".kubeflow_tpu/models")
    ap.add_argument("--runtime", default="torch", choices=["torch", "custom"])
    ap.add_argument("--model-class", default="")
    ap.add_argument("--transformer-class", default="")
    ap.add_argument("--explainer-class", default="")
    ap.add_argument("--port", type=int, default=8080)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--aot", action="store_true",
                    help="export the predictor at load if no artifact of "
                         "this device's platform exists; replicas then "
                         "serve the artifact (serving/aot.py)")
    ap.add_argument("--request-log", default="",
                    help="JSONL request/response log path")
    ap.add_argument("--max-batch-size", type=int, default=0,
                    help=">0 enables adaptive micro-batching")
    ap.add_argument("--batch-max-latency-ms", type=float, default=5.0)
    ap.add_argument("--repository-dir", default="",
                    help="multi-model repository root for /v2/repository API")
    args = ap.parse_args(argv)

    device = select_device(args.device)
    cache = os.environ.get(ENV_SERVING_COMPILE_CACHE, "")
    if cache and device.type == "cuda":
        # the kernel libraries the deploy step built (serving/aot.py):
        # pointed at them, a cold start runs nvcc zero times
        from kubeflow_tpu_torch.serving.aot import _compile_cache_on

        _compile_cache_on(cache)

    if args.runtime == "custom":
        model: Model = load_model_class(args.model_class)(args.model_name)
    else:
        model_dir = args.model_dir
        if args.storage_uri:
            model_dir = pull_model(args.storage_uri,
                                   f"{args.model_dir}/{args.model_name}")
        if args.aot:
            from kubeflow_tpu_torch.serving.aot import (
                aot_available,
                export_predictor,
            )

            if not aot_available(model_dir, device):
                export_predictor(model_dir, compile_cache=cache or None,
                                 device=device)
        model = TorchModel(args.model_name, model_dir, device=device)
    if args.transformer_class:
        t_cls = load_model_class(args.transformer_class)
        model = TransformedModel(args.model_name, model,
                                 t_cls(f"{args.model_name}-transformer"))
    if args.explainer_class:
        e_cls = load_model_class(args.explainer_class)
        model = ExplainedModel(args.model_name, model,
                               e_cls(f"{args.model_name}-explainer"))
    srv = ModelServer([model], port=args.port, host=args.host,
                      request_log_path=args.request_log or None,
                      max_batch_size=args.max_batch_size,
                      batch_max_latency_ms=args.batch_max_latency_ms,
                      repository_dir=args.repository_dir,
                      device=str(device))
    srv.start(block=False)
    print(f"server ready url={srv.url} model={args.model_name}", flush=True)
    threading.Event().wait()  # serve until killed


if __name__ == "__main__":
    main()
