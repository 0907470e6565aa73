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
  GET  /metrics                    request counters and latency histograms

A model served by the continuous-batching engine (or a fleet of them)
answers v1 requests with the engine's own timing (``"timing": {"ttft_s",
"tokens_per_s"}``); a fleet's admission shed answers 503 with a
``Retry-After`` header and a body carrying the shed decision's span
context and request id. Micro-batching, the v2 repository API, explain,
gRPC and engine/fleet gauges come with later slices.

Run as a pod: python -m kubeflow_tpu_torch.serving.server --model-name m
--model-dir DIR [--device cuda|cpu]
"""

from __future__ import annotations

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from kubeflow_tpu_torch.serving.agent import RequestLogger
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
    """Hosts models behind one HTTP port, with a request log
    (`request_log_path`) and the counters GET /metrics renders."""

    def __init__(self, models: list[Model] | None = None, port: int = 8080,
                 host: str = "127.0.0.1", request_log_path: str | None = None):
        self.models: dict[str, Model] = {}
        self.host = host
        self.port = port
        self.logger = RequestLogger(request_log_path)
        self._httpd: ThreadingHTTPServer | None = None
        self._thread: threading.Thread | None = None
        for m in models or []:
            self.models[m.name] = m

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
            return 200, self.logger.render_metrics()  # raw prometheus text
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

    def handle_post(self, path: str, body: dict,
                    req_bytes: int = 0) -> tuple[int, object]:
        if path.startswith("/v1/models/") and path.endswith(":predict"):
            name = path[len("/v1/models/"):-len(":predict")]
            return self._logged(name, "v1", req_bytes, self._predict_v1, body)
        if path.startswith("/v2/models/") and path.endswith("/infer"):
            name = path[len("/v2/models/"):-len("/infer")]
            return self._logged(name, "v2", req_bytes, self._infer_v2, body)
        return 404, {"error": f"no route {path!r}"}

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
                out = m(np.asarray(instances))
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
            out = m(arr)
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

    from kubeflow_tpu_torch.serving.model import TorchModel

    ap = argparse.ArgumentParser(description="kubeflow-tpu-torch model server")
    ap.add_argument("--model-name", required=True)
    ap.add_argument("--model-dir", required=True)
    ap.add_argument("--port", type=int, default=8080)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--request-log", default="",
                    help="JSONL request/response log path")
    args = ap.parse_args(argv)

    model = TorchModel(args.model_name, args.model_dir, device=args.device)
    srv = ModelServer([model], port=args.port, host=args.host,
                      request_log_path=args.request_log or None)
    srv.start(block=False)
    print(f"server ready url={srv.url} model={args.model_name}", flush=True)
    threading.Event().wait()  # serve until killed


if __name__ == "__main__":
    main()
