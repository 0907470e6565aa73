"""The port's model server against the JAX package's predictor.

One set of tiny GPT weights, drawn from a numpy seed in the flax layout, is
written as a JAX model dir and (through ``kubeflow_tpu_torch.convert``) as a
port model dir. The port's ``ModelServer`` serves ``TorchModel(device="cpu")``
over HTTP on 127.0.0.1; ``JaxModel`` answers the same generate requests
in-process, and the JAX model's jitted forward gives the reference logits
(a JaxModel load costs seconds of eager init on the CPU).

The port serves ``attention="flash"`` (its prefill and logits forward go
through ``flash_attention``); the JAX side serves the dense config, whose
generate path is the JAX package's flash generate path exactly (decode
never reaches its kernel) and whose logits are the same function, without
tracing the Pallas kernel in interpret mode at load. The port's
continuous-engine predictor answers with the JAX package's greedy tokens,
and its beam predictor with the JAX package's ``beam_search`` ids.
"""

import json
import threading
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from kubeflow_tpu.models.gpt import GPTConfig as JaxGPTConfig
from kubeflow_tpu.models.gpt import GPTLM as JaxGPTLM
from kubeflow_tpu.models.gpt import beam_search as jax_beam_search
from kubeflow_tpu.serving.model import JaxModel
from kubeflow_tpu.serving.model import save_predictor as jax_save_predictor
from kubeflow_tpu_torch.convert import (
    flax_params_from_gpt,
    gpt_params_from_flax,
)
from kubeflow_tpu_torch.models.gpt import GPTLM, GPTConfig
from kubeflow_tpu_torch.serving import server as torch_server
from kubeflow_tpu_torch.serving.model import TorchModel, save_predictor

try:  # one intra-op thread: the suite shares the machine with timing gates
    torch.set_num_threads(1)
    torch.set_num_interop_threads(1)
except RuntimeError:  # the interop pool can be sized once per process
    pass

GEN = {"max_new_tokens": 5}
# the continuous engine over a paged pool, chunked prefill; and beam search
CONT = {**GEN, "continuous": True, "continuous_rows": 3, "prefill_chunk": 4,
        "paged_kv_block": 4}
BEAMS = 3
FLASH = {"attention": "flash", "attention_block": 8}
PROMPT = np.random.RandomState(4).randint(1, 512, (2, 6)).astype(np.int32)
IDS = np.random.RandomState(6).randint(1, 512, (2, 16)).astype(np.int32)
IDS[1, -3:] = 0  # a right-padded row


def http(url, body=None, headers=None):
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(url, data=data, headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            raw, code, hdrs = resp.read(), resp.status, resp.headers
    except urllib.error.HTTPError as exc:
        raw, code, hdrs = exc.read(), exc.code, exc.headers
    ctype = hdrs.get("Content-Type", "")
    return code, (json.loads(raw) if "json" in ctype else raw.decode()), hdrs


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_serving")
    rng = np.random.RandomState(2)
    template = flax_params_from_gpt(
        GPTLM(GPTConfig.tiny(), device="cpu").state_dict(), GPTConfig.tiny())
    flat = {k: (0.2 * rng.normal(size=v.shape)).astype(np.float32)
            for k, v in sorted(template.items())}
    variables = {"params": traverse_util.unflatten_dict(
        {k: jnp.asarray(v) for k, v in flat.items()}, sep="/")}
    sd = gpt_params_from_flax(flat, GPTConfig.tiny(**FLASH))
    jax_save_predictor(root / "jax_gen", "gpt-lm", variables, PROMPT,
                       generate=GEN, size="tiny")
    save_predictor(root / "gen", "gpt-lm", sd, PROMPT, generate=GEN,
                   size="tiny", config=FLASH)
    save_predictor(root / "logits", "gpt-lm", sd, IDS, size="tiny",
                   config=FLASH)
    save_predictor(root / "cont", "gpt-lm", sd, PROMPT, generate=CONT,
                   size="tiny", config=FLASH)
    save_predictor(root / "beam", "gpt-lm", sd, PROMPT,
                   generate={**GEN, "num_beams": BEAMS}, size="tiny",
                   config=FLASH)
    jax_gen = JaxModel("gen", root / "jax_gen")
    jax_gen.load()
    jax_logits = np.asarray(jax.jit(JaxGPTLM(JaxGPTConfig.tiny()).apply)(
        variables, jnp.asarray(IDS)))
    jax_beam = np.asarray(jax.jit(lambda v, p: jax_beam_search(
        JaxGPTLM(JaxGPTConfig.tiny()), v, p, GEN["max_new_tokens"],
        BEAMS)[0])(variables, jnp.asarray(PROMPT)))
    models = [TorchModel(name, root / name, device="cpu")
              for name in ("gen", "logits", "cont", "beam")]
    srv = torch_server.ModelServer(models, port=0, host="127.0.0.1").start()
    try:
        yield srv, {"gen": jax_gen, "logits": jax_logits,
                    "beam": jax_beam}, root
    finally:
        srv.stop()
        # stop() closed the engine: its ticker thread is gone
        assert models[2]._engine._thread is None


def test_generate_request_matches_jax(served):
    srv, jax_ref, _ = served
    code, body, _ = http(f"{srv.url}/v1/models/gen:predict",
                         {"instances": PROMPT.tolist()})
    assert code == 200, body
    assert np.asarray(body["predictions"]).shape == (2, GEN["max_new_tokens"])
    assert body["predictions"] == jax_ref["gen"](PROMPT)["predictions"]


def test_continuous_requests_match_jax(served):
    """The engine predictor over HTTP: two concurrent clients, each answer
    the JAX package's greedy tokens, with the engine's own timing; the
    repeat of a prompt seeds from the paged pool."""
    srv, jax_ref, root = served
    want = jax_ref["gen"](PROMPT)["predictions"]
    bodies = [None, None]

    def client(i):
        bodies[i] = http(f"{srv.url}/v1/models/cont:predict",
                         {"instances": PROMPT.tolist()})

    threads = [threading.Thread(target=client, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    for code, body, _ in bodies:
        assert code == 200, body
        assert body["predictions"] == want
        assert body["timing"]["ttft_s"] > 0
    engine = srv.models["cont"]._engine
    assert engine.prefill_tokens_reused > 0
    code, body, _ = http(f"{srv.url}/v1/models/cont:predict",
                         {"instances": [[5, 0, 7]]})
    assert code == 500 and "pad token" in body["error"]


def test_beam_request_matches_jax(served, tmp_path):
    srv, jax_ref, root = served
    code, body, _ = http(f"{srv.url}/v1/models/beam:predict",
                         {"instances": PROMPT.tolist()})
    assert code == 200, body
    assert body["predictions"] == jax_ref["beam"].tolist()
    sd = gpt_params_from_flax(
        dict(np.load(root / "beam" / "params.npz")), GPTConfig.tiny())
    for gen, match in (({"num_beams": 2, "continuous": True}, "beam search"),
                       ({"num_beams": 2, "temperature": 0.5},
                        "mutually exclusive"),
                       ({"num_beams": 2, "eos_token_id": 3}, "eos_token_id")):
        d = save_predictor(tmp_path / str(len(match)), "gpt-lm", sd, PROMPT,
                           generate=gen, size="tiny")
        with pytest.raises(ValueError, match=match):
            TorchModel("m", d, device="cpu").load()


def test_logits_request_matches_jax(served):
    srv, jax_ref, _ = served
    code, body, _ = http(f"{srv.url}/v1/models/logits:predict",
                         {"instances": IDS.tolist()})
    assert code == 200, body
    want = jax_ref["logits"]
    got = np.asarray(body["logits"], np.float32)
    assert got.shape == want.shape == (2, 16, 512)
    # f32 both sides; matmul order and LayerNorm variance formula differ
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)
    np.testing.assert_array_equal(body["predictions"], got.argmax(-1))


def test_pad_token_refusal_matches_jax(served):
    srv, jax_ref, _ = served
    padded = PROMPT.copy()
    padded[0, -1] = 0
    with pytest.raises(ValueError) as jax_err:
        jax_ref["gen"].predict(padded)
    code, body, hdrs = http(f"{srv.url}/v1/models/gen:predict",
                            {"instances": padded.tolist()},
                            headers={"X-Request-Id": "rid-pad-1"})
    assert code == 500
    assert body["error"] == f"ValueError: {jax_err.value}"
    assert body["request_id"] == "rid-pad-1" == hdrs["X-Request-Id"]


def test_metadata_health_v2_and_metrics(served):
    srv, _, _ = served
    assert http(f"{srv.url}/v2/health/live")[:2] == (200, {"live": True})
    assert http(f"{srv.url}/v2/health/ready")[:2] == (200, {"ready": True})
    assert http(f"{srv.url}/v1/models/gen")[1] == {"name": "gen",
                                                   "ready": True}
    code, meta, _ = http(f"{srv.url}/v2/models/logits")
    assert code == 200 and meta["inputs"] == [
        {"name": "input-0", "datatype": "INT32", "shape": [-1, 16]}]
    assert http(f"{srv.url}/v2/models/nope/ready")[0] == 404
    code, body, _ = http(f"{srv.url}/v2/models/logits/infer", {"inputs": [{
        "name": "input-0", "shape": list(IDS.shape), "datatype": "INT32",
        "data": IDS.ravel().tolist()}]})
    assert code == 200
    outs = {o["name"]: o for o in body["outputs"]}
    assert outs["logits"]["shape"] == [2, 16, 512]
    assert outs["predictions"]["shape"] == [2, 16]
    code, text, _ = http(f"{srv.url}/metrics")
    assert code == 200
    assert 'kfserving_requests_total{model="logits",protocol="v2",' \
           'code="200"}' in text
    assert 'kfserving_request_latency_seconds_count{model="logits"}' in text


def test_unported_options_and_cuda_request_raise(served, tmp_path):
    _, _, root = served
    # the card is the default; this box has none, and nothing falls back
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TorchModel("gen", root / "gen")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        torch_server.main(["--model-name", "gen", "--model-dir",
                           str(root / "gen")])
    sd = gpt_params_from_flax(
        dict(np.load(root / "gen" / "params.npz")), GPTConfig.tiny())
    # fleet_replicas and continuous_draft_dir are served now
    # (tests/test_torch_fleet.py, tests/test_torch_spec_engine.py); what
    # the engine predictor still refuses: beam search, JAX-package weights
    d = save_predictor(tmp_path / "beams", "gpt-lm", sd, PROMPT,
                       generate={"continuous": True, "num_beams": 2},
                       size="tiny")
    with pytest.raises(ValueError, match="beam search"):
        TorchModel("m", d, device="cpu").load()
    d = save_predictor(tmp_path / "jaxw", "gpt-lm", sd, PROMPT,
                       generate={"continuous": True, "fleet_replicas": 2},
                       size="tiny")
    (d / "params.npz").rename(d / "params.msgpack")
    with pytest.raises(NotImplementedError, match="JAX-package weights"):
        TorchModel("m", d, device="cpu").load()
    with pytest.raises(NotImplementedError, match="int8"):
        save_predictor(tmp_path / "q", "gpt-lm", sd, PROMPT, quantize=True,
                       size="tiny")
    with pytest.raises(NotImplementedError, match="not ported"):
        save_predictor(tmp_path / "b", "bert-classifier", sd, PROMPT)
