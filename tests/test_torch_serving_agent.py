"""The port's serving agent and the rest of its model server against the
JAX package's: micro-batching, the v2 repository API, explain and
transformer hops, request histograms and the engine and fleet gauges.

Each scenario of ``tests/test_serving_agent.py`` runs on both packages'
``MicroBatcher`` and must give equal counts; the two ``ModelServer``s
answer the same routes with the same JSON, on 127.0.0.1 at port 0 (each
stopped in its fixture's teardown, batcher threads joined). The
repository serves model dirs the JAX package wrote, on the CPU.
"""

import json
import re
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from kubeflow_tpu.serving import agent as jagent
from kubeflow_tpu.serving import model as jsm
from kubeflow_tpu.serving import server as jserver
from kubeflow_tpu_torch.serving import agent as tagent
from kubeflow_tpu_torch.serving import model as tsm
from kubeflow_tpu_torch.serving import server as tserver

try:  # one intra-op thread: the suite shares the machine with timing gates
    torch.set_num_threads(1)
    torch.set_num_interop_threads(1)
except RuntimeError:  # the interop pool can be sized once per process
    pass

# package -> (agent, model, server) modules
PACKAGES = {"jax": (jagent, jsm, jserver), "port": (tagent, tsm, tserver)}


def counting_model(base, delay_s=0.0):
    class Counting(base):
        """Doubles its input; counts forward calls and batch sizes."""

        def __init__(self, name="counter"):
            super().__init__(name)
            self.calls = 0
            self.batch_sizes = []

        def load(self):
            self.ready = True

        def predict(self, inputs):
            self.calls += 1
            self.batch_sizes.append(len(inputs))
            if delay_s:
                time.sleep(delay_s)
            return np.asarray(inputs) * 2.0

    m = Counting()
    m.load()
    return m


def boom_model(base):
    class Boom(base):
        def load(self):
            self.ready = True

        def predict(self, inputs):
            raise RuntimeError("kaput")

    m = Boom("boom")
    m.load()
    return m


def coalesce(pkg):
    """16 one-row requests from 16 threads, a batch of 16 and a long
    latency window: one forward pass, every row its own answer."""
    agent, model, _ = PACKAGES[pkg]
    m = counting_model(model.Model, delay_s=0.01)
    b = agent.MicroBatcher(m, max_batch_size=16, max_latency_ms=5000.0)
    results = {}

    def one(i):
        results[i] = b(np.full((1, 4), float(i)))

    threads = [threading.Thread(target=one, args=(i,)) for i in range(16)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    b.stop()
    for i, r in results.items():
        np.testing.assert_allclose(r, np.full((1, 4), 2.0 * i))
    return {"results": len(results), "calls": m.calls,
            "batch_sizes": m.batch_sizes, "batches_run": b.batches_run,
            "requests_batched": b.requests_batched,
            "worker_alive": b._worker.is_alive()}


def error(pkg):
    """A failing forward reaches every waiter of its batch."""
    agent, model, _ = PACKAGES[pkg]
    b = agent.MicroBatcher(boom_model(model.Model), max_batch_size=8,
                           max_latency_ms=5.0)
    errors = []

    def one():
        try:
            b(np.ones((2, 2)))
        except RuntimeError as exc:
            errors.append(str(exc))

    threads = [threading.Thread(target=one) for _ in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    b.stop()
    return {"errors": errors, "requests_batched": b.requests_batched,
            "worker_alive": b._worker.is_alive()}


def latency_flush(pkg):
    """One request far below the batch size flushes at the deadline."""
    agent, model, _ = PACKAGES[pkg]
    m = counting_model(model.Model)
    b = agent.MicroBatcher(m, max_batch_size=1024, max_latency_ms=10.0)
    out = b(np.ones((3, 2)))
    b.stop()
    np.testing.assert_allclose(out, 2.0 * np.ones((3, 2)))
    return {"calls": m.calls, "batch_sizes": m.batch_sizes,
            "batches_run": b.batches_run}


@pytest.mark.parametrize("scenario", [coalesce, error, latency_flush],
                         ids=lambda f: f.__name__)
def test_micro_batcher_counts_equal_jax(scenario):
    got, want = scenario("port"), scenario("jax")
    assert got == want
    if scenario is coalesce:
        assert got["calls"] == 1 and got["batch_sizes"] == [16]
    if scenario is error:
        assert got["errors"] == ["kaput"] * 3


def test_histogram_text_equals_jax(tmp_path):
    loggers = [pkg[0].RequestLogger(str(tmp_path / f"{name}.jsonl"))
               for name, pkg in PACKAGES.items()]
    for lg in loggers:
        for lat in (0.001, 0.01, 0.01, 0.3, 99.0):
            lg.log("m1", "v2", 200, lat, 10, 20)
        lg.log("m2", "v1", 500, 0.05, 1, 1)
    texts = [lg.render_metrics() for lg in loggers]
    for lg in loggers:
        lg.close()
    assert texts[0] == texts[1]
    m1 = re.findall(r'kfserving_request_latency_seconds_bucket\{model="m1",'
                    r'le="([^"]+)"\} (\d+)', texts[1])
    assert m1[-1] == ("+Inf", "5")


# ------------------------------------------------------------- servers

def http(url, body=None):
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(url, data=data,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            raw = resp.read().decode()
            code = resp.status
    except urllib.error.HTTPError as exc:
        raw, code = exc.read().decode(), exc.code
    try:
        return code, json.loads(raw)
    except json.JSONDecodeError:
        return code, raw


def hop_models(pkg):
    """A doubling predictor behind a transformer (+1 in, {"doubled": out}
    out) and an explainer (per-feature deltas through the predictor)."""
    _, model, _ = PACKAGES[pkg]

    class Doubler(model.Model):
        def predict(self, inputs):
            return np.asarray(inputs, np.float32) * 2.0

    class AddOne(model.Model):
        def preprocess(self, inputs):
            return np.asarray(inputs, np.float32) + 1.0

        def postprocess(self, outputs):
            return {"doubled": np.asarray(outputs).tolist()}

    class Deltas(model.Model):
        def explain(self, inputs):
            x = np.asarray(inputs, np.float32)
            base = np.asarray(self.predict_fn(x))
            return {"explanations": (np.asarray(self.predict_fn(x + 1.0))
                                     - base).tolist()}

    class Crashes(model.Model):
        def explain(self, inputs):
            raise NotImplementedError("user explainer crashed")

    return [
        model.TransformedModel("hop", Doubler("d"), AddOne("t")),
        model.ExplainedModel("why", Doubler("d"), Deltas("e")),
        model.ExplainedModel("broken", Doubler("d"), Crashes("c")),
        Doubler("plain"),
    ]


@pytest.fixture(scope="module")
def servers(tmp_path_factory):
    """Both packages' servers over the same hop models and a repository of
    two MNIST dirs the JAX package wrote."""
    import jax

    from kubeflow_tpu.models import MnistMLP

    repo = tmp_path_factory.mktemp("repository")
    x = np.zeros((1, 28, 28, 1), np.float32)
    variables = MnistMLP(hidden=(8,)).init(jax.random.PRNGKey(0), x)
    for name in ("alpha", "beta"):
        jsm.save_predictor(repo / name, "mnist-mlp", dict(variables), x,
                           hidden=[8])
    started = {}
    try:
        for pkg, (_, _, server) in PACKAGES.items():
            kw = {"device": "cpu"} if pkg == "port" else {}
            started[pkg] = server.ModelServer(
                hop_models(pkg), port=0, repository_dir=str(repo),
                max_batch_size=8, batch_max_latency_ms=2.0, **kw).start()
        yield started
    finally:
        for srv in started.values():
            srv.stop()
        for srv in started.values():
            for b in srv._batchers.values():
                assert not b._worker.is_alive()


def both(servers, path, body=None):
    return [http(servers[pkg].url + path, body) for pkg in ("port", "jax")]


def test_explain_and_transformer_routes_equal_jax(servers):
    x = {"instances": [[1.0, 2.0], [3.0, 4.0]]}
    for path in ("/v1/models/hop:predict", "/v1/models/why:explain",
                 "/v1/models/why:predict", "/v1/models/plain:explain",
                 "/v1/models/broken:explain", "/v1/models/nope:explain",
                 "/v1/models/why:explain"):
        body = {} if path.endswith("nope:explain") else x
        (code, got), (want_code, want) = both(servers, path, body)
        assert code == want_code, path
        if isinstance(got, dict):
            got.pop("request_id", None)
            want.pop("request_id", None)
        assert got == want, path
    code, got = http(servers["port"].url + "/v1/models/hop:predict", x)
    assert got == {"predictions": {"doubled": [[4.0, 6.0], [8.0, 10.0]]}}
    code, got = http(servers["port"].url + "/v1/models/why:explain", x)
    assert got == {"explanations": [[2.0, 2.0], [2.0, 2.0]]}
    assert http(servers["port"].url + "/v1/models/plain:explain", x)[0] == 404
    assert http(servers["port"].url + "/v1/models/broken:explain", x)[0] \
        == 500


def test_repository_load_and_unload_equal_jax(servers):
    image = {"inputs": [{"name": "input-0", "shape": [1, 28, 28, 1],
                         "datatype": "FP32",
                         "data": list(np.linspace(0, 1, 784))}]}
    steps = [
        ("/v2/repository/index", {}),
        ("/v2/repository/models/alpha/load", {}),
        ("/v2/repository/models/beta/load", {}),
        ("/v2/repository/index", {}),
        ("/v2/models/alpha/infer", image),
        ("/v2/repository/models/alpha/unload", {}),
        ("/v2/repository/models/alpha/unload", {}),
        ("/v1/models/alpha:predict", {"instances": [[0.0]]}),
        ("/v2/repository/models/missing/load", {}),
        ("/v2/repository/models/..%2Fetc/load", {}),
        ("/v2/repository/models/beta/unload", {}),
    ]
    for path, body in steps:
        (code, got), (want_code, want) = both(servers, path, body)
        assert code == want_code, (path, got, want)
        if path == "/v2/repository/index":
            got = [m for m in got if m["name"] in ("alpha", "beta")]
            want = [m for m in want if m["name"] in ("alpha", "beta")]
        if path.endswith("/infer"):
            outs = {o["name"]: o for o in got["outputs"]}
            wants = {o["name"]: o for o in want["outputs"]}
            np.testing.assert_allclose(outs["logits"]["data"],
                                       wants["logits"]["data"], atol=1e-5)
            assert outs["predictions"] == wants["predictions"]
            continue
        if isinstance(got, dict):
            for d in (got, want):
                d.pop("request_id", None)
                d.pop("error", None)  # the predictor's class name differs
        assert got == want, path
    assert "alpha" not in servers["port"].models
    assert "alpha" not in servers["port"]._batchers


def test_batched_http_predict_coalesces(servers):
    srv = servers["port"]
    before = srv._batchers["plain"].batches_run
    codes = []

    def one(i):
        code, out = http(f"{srv.url}/v1/models/plain:predict",
                         {"instances": [[float(i)] * 4]})
        codes.append(code)
        assert out["predictions"] == [[2.0 * i] * 4]

    threads = [threading.Thread(target=one, args=(i,)) for i in range(12)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert codes == [200] * 12
    b = srv._batchers["plain"]
    assert b.batches_run - before < 12 and b.requests_batched >= 12
    code, text = http(f"{srv.url}/metrics")
    assert f'kfserving_batcher_batches_total{{model="plain"}} ' \
        f"{b.batches_run}" in text
    assert f'kfserving_batcher_requests_total{{model="plain"}} ' \
        f"{b.requests_batched}" in text


class _FakeEngine:
    def __init__(self, busy, rows, queued, steps):
        self._rows = [object()] * busy + [None] * (rows - busy)
        self.max_rows = rows
        self._queue = [None] * queued
        self._lock = threading.Lock()
        self.step_count = steps


class _FakeFleet:
    def __init__(self):
        self.replicas = [
            type("R", (), {"name": f"r{i}", "engine": _FakeEngine(i, 4, 1, 7)})
            for i in range(2)]

    def snapshot(self):
        return {"queue_depth": 3, "replicas_alive": 2, "ttft_p50": 0.25,
                "note": "skipped: not a number"}


def test_metrics_gauges_equal_jax():
    texts = []
    for pkg in ("port", "jax"):
        _, model, server = PACKAGES[pkg]
        solo, fleet = model.Model("solo"), model.Model("fleet")
        solo._engine, fleet._fleet = _FakeEngine(3, 8, 2, 41), _FakeFleet()
        srv = server.ModelServer([solo, fleet], port=0)
        code, text = srv.handle_get("/metrics")
        assert code == 200
        texts.append(text)
    # the port's own counters follow JAX's text: each kernel's launches
    port, jax_text = texts
    assert port.startswith(jax_text)
    from kubeflow_tpu_torch.kernels import KERNELS

    assert re.fullmatch(r"# TYPE kftpu_kernel_launches_total counter\n"
                        r'(kftpu_kernel_launches_total\{kernel="\w+"\} '
                        rf"\d+\n){{{len(KERNELS)}}}", port[len(jax_text):])
    assert 'kfserving_engine_rows_busy{model="solo"} 3' in texts[0]
    assert 'kfserving_engine_queue_depth{model="fleet:r1"} 1' in texts[0]
    assert 'kfserving_fleet_replicas_alive{model="fleet"} 2' in texts[0]


def test_repository_loads_a_continuous_engine(tmp_path):
    """A continuous GPT dir loaded through the repository API publishes the
    engine gauges; unloading stops its ticker thread and drops them."""
    from kubeflow_tpu_torch.models.gpt import GPTConfig, GPTLM

    gpt = GPTLM(GPTConfig.tiny(), device="cpu")
    gpt.init_weights(torch.Generator().manual_seed(0))
    prompt = np.arange(1, 7, dtype=np.int32)[None]
    tsm.save_predictor(tmp_path / "gen", "gpt-lm", gpt.state_dict(), prompt,
                       generate={"max_new_tokens": 3, "continuous": True,
                                 "continuous_rows": 2}, size="tiny")
    srv = tserver.ModelServer([], port=0, repository_dir=str(tmp_path),
                              device="cpu").start()
    try:
        code, out = http(f"{srv.url}/v2/repository/models/gen/load", {})
        assert (code, out) == (200, {"name": "gen", "state": "READY"})
        engine = srv.models["gen"]._engine
        code, body = http(f"{srv.url}/v1/models/gen:predict",
                          {"instances": prompt.tolist()})
        assert code == 200 and len(body["predictions"][0]) == 3
        code, text = http(f"{srv.url}/metrics")
        assert 'kfserving_engine_rows_total{model="gen"} 2' in text
        assert re.search(r'kfserving_engine_decode_dispatches_total'
                         r'\{model="gen"\} [1-9]', text)
        assert http(f"{srv.url}/v2/repository/models/gen/unload", {})[0] \
            == 200
        assert engine._thread is None
        assert "kfserving_engine" not in http(f"{srv.url}/metrics")[1]
    finally:
        srv.stop()


def test_load_model_class(tmp_path, monkeypatch):
    (tmp_path / "kft_custom_models.py").write_text(
        "from kubeflow_tpu_torch.serving.model import Model\n"
        "class Echo(Model):\n"
        "    def predict(self, inputs):\n"
        "        return inputs\n"
        "class NotAModel:\n"
        "    pass\n")
    monkeypatch.syspath_prepend(str(tmp_path))
    cls = tsm.load_model_class("kft_custom_models:Echo")
    assert issubclass(cls, tsm.Model) and cls("e")([1]) == [1]
    with pytest.raises(TypeError, match="not a kubeflow_tpu_torch"):
        tsm.load_model_class("kft_custom_models:NotAModel")
    with pytest.raises(ValueError, match="module:Class"):
        tsm.load_model_class("kft_custom_models.Echo")
