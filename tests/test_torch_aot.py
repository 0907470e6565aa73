"""The port's AOT artifacts (``serving/aot.py``) against its eager
predictor and the JAX package's contract.

A predictor exported with ``torch.export`` (the flash forward inside it as
the custom op ``kftpu::flash_fwd``) must answer as the eager predictor does:
logits within 1e-5, greedy tokens identical, any batch padded and chunked
to the exported one. ``aot.json`` records the platform, and a load prefers
the artifact only on that platform; the loader builds no model module.
Sampling is refused with the JAX package's message, and int8 artifacts
compose with export. The model server's ``main`` pulls a pvc:// model,
exports it (``--aot``) and serves it micro-batched, in a subprocess.
"""

import json
import os
import re
import subprocess
import sys
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

from kubeflow_tpu_torch.models import bert as tbert
from kubeflow_tpu_torch.models import gpt as tgpt
from kubeflow_tpu_torch.serving import aot
from kubeflow_tpu_torch.serving import model as tsm

try:  # one intra-op thread: the suite shares the machine with timing gates
    torch.set_num_threads(1)
    torch.set_num_interop_threads(1)
except RuntimeError:  # the interop pool can be sized once per process
    pass

ROOT = Path(__file__).resolve().parent.parent
FLASH = {"attention": "flash", "attention_block": 8}
IDS = np.random.RandomState(11).randint(1, 512, (2, 16)).astype(np.int32)
IDS[1, -5:] = 0  # a right-padded row
PROMPT = np.random.RandomState(12).randint(1, 512, (2, 6)).astype(np.int32)
GEN = {"max_new_tokens": 4}


def _weights(module, seed: int) -> dict:
    """A state_dict drawn from a numpy seed (N(0, 0.1), scales N(1, 0.1))."""
    rng = np.random.RandomState(seed)
    sd = {}
    for k, v in module.state_dict().items():
        mean = 1.0 if k.endswith(("ln_attn.weight", "ln_mlp.weight",
                                  "ln_final.weight", "scale")) else 0.0
        sd[k] = torch.from_numpy(
            (mean + 0.1 * rng.standard_normal(tuple(v.shape))).astype(
                np.float32))
    return sd


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    root = tmp_path_factory.mktemp("aot")
    gpt = tgpt.GPTLM(tgpt.GPTConfig.tiny(**FLASH), device="cpu")
    gsd = _weights(gpt, 1)
    bert = tbert.BertForSequenceClassification(
        tbert.BertConfig.tiny(**FLASH), num_classes=3, device="cpu")
    bsd = _weights(bert, 2)
    gk = {"size": "tiny", "config": FLASH}
    return {
        "greedy": tsm.save_predictor(root / "greedy", "gpt-lm", gsd, PROMPT,
                                     generate=GEN, **gk),
        "int8-greedy": tsm.save_predictor(root / "qgreedy", "gpt-lm", gsd,
                                          PROMPT, generate=GEN,
                                          quantize=True, **gk),
        "beam": tsm.save_predictor(root / "beam", "gpt-lm", gsd, PROMPT,
                                   generate={**GEN, "num_beams": 3}, **gk),
        "bert": tsm.save_predictor(root / "bert", "bert-classifier", bsd,
                                   IDS, num_classes=3, **gk),
    }


def _eager(d) -> tsm.TorchModel:
    """The rebuilt predictor of a dir, whatever artifact sits in it."""
    m = tsm.TorchModel("eager", d, device="cpu")
    predict_fn, m.config, _ = tsm._load_predict_fn(d, "cpu")
    m._predict_fn = predict_fn
    m.ready = True
    return m


@pytest.fixture(scope="module")
def exported(dirs):
    for d in dirs.values():
        aot.export_predictor(d, device="cpu")
    return dirs


def _flash_nodes(d, name=aot.AOT_FILE) -> int:
    """The custom-op calls in a saved program."""
    program = torch.export.load(d / name)
    return sum(1 for n in program.graph.nodes
               if "kftpu.flash_fwd" in str(n.target))


@pytest.mark.parametrize("kind", ["greedy", "int8-greedy", "beam", "bert"])
def test_artifact_matches_eager(exported, kind):
    d = exported[kind]
    x = IDS if kind == "bert" else PROMPT
    am = tsm.TorchModel("aot", d, device="cpu")
    am.load()
    assert am._aot_batch == 2  # the artifact path was taken
    got, want = am.predict(x), _eager(d).predict(x)
    assert got.shape == want.shape and got.dtype == want.dtype
    if kind == "bert":
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    else:
        np.testing.assert_array_equal(got, want)
    # the prefill (GPT) or the forward (BERT) runs the custom op in each of
    # its 2 layers; a decode step never does
    assert _flash_nodes(d) == 2
    if kind != "bert":
        assert _flash_nodes(d, aot.AOT_DECODE_FILE) == 0


@pytest.mark.parametrize("kind", ["greedy", "bert"])
def test_padded_chunking_covers_any_batch(exported, kind):
    d = exported[kind]
    am = tsm.TorchModel("aot", d, device="cpu")
    am.load()
    ref = _eager(d)
    base = IDS if kind == "bert" else PROMPT
    for n in range(1, 2 * am._aot_batch + 2):
        rng = np.random.RandomState(n)
        x = rng.randint(1, 512, (n, base.shape[1])).astype(np.int32)
        got, want = am.predict(x), ref.predict(x)
        assert got.shape[0] == n
        if kind == "bert":
            np.testing.assert_allclose(got, want, atol=1e-5, rtol=0,
                                       err_msg=f"batch {n}")
        else:
            np.testing.assert_array_equal(got, want, err_msg=f"batch {n}")
    if kind == "greedy":  # prompts cannot pad: the shape is the contract
        with pytest.raises(ValueError, match="fixed to prompt shape"):
            am.predict(np.ones((1, 9), np.int32))


def test_meta_records_platform(exported):
    d = exported["bert"]
    meta = json.loads((d / aot.AOT_META).read_text())
    assert meta == {"platforms": ["cpu"], "batch_size": 2,
                    "torch_version": torch.__version__,
                    "programs": [aot.AOT_FILE]}
    assert json.loads((exported["greedy"] / aot.AOT_META).read_text())[
        "programs"] == [aot.AOT_DECODE_FILE, aot.AOT_FILE]
    assert aot.aot_available(d, "cpu")
    assert not aot.aot_available(d, "cuda")
    # an artifact for another platform is not this device's: rebuild
    other = d.parent / "bert-cuda"
    other.mkdir()
    for f in d.iterdir():
        (other / f.name).write_bytes(f.read_bytes())
    (other / aot.AOT_META).write_text(json.dumps({**meta,
                                                  "platforms": ["cuda"]}))
    m = tsm.TorchModel("m", other, device="cpu")
    m.load()
    assert m._aot_batch is None
    # this platform's artifact that cannot load raises, it is not skipped
    (other / aot.AOT_META).write_text(json.dumps(meta))
    (other / aot.AOT_FILE).write_bytes(b"not an exported program")
    with pytest.raises(Exception):
        tsm.TorchModel("m", other, device="cpu").load()
    assert not aot.aot_available(d.parent / "missing", "cpu")


def test_sampling_refusal_is_jax_message(tmp_path, monkeypatch):
    from kubeflow_tpu.serving import aot as jaot
    from kubeflow_tpu.serving import model as jsm

    gen = {"max_new_tokens": 3, "temperature": 0.7, "seed": 1}
    config = {"family": "gpt-lm", "generate": gen}
    # the JAX exporter refuses after rebuilding the predictor: hand it the
    # config without a module (its refusal reads only the config)
    monkeypatch.setattr(jsm, "_load_predict_fn",
                        lambda d: (None, config, PROMPT))
    with pytest.raises(ValueError) as want:
        jaot.export_predictor(tmp_path / "j")
    gpt = tgpt.GPTLM(tgpt.GPTConfig.tiny(), device="cpu")
    d = tsm.save_predictor(tmp_path / "t", "gpt-lm", _weights(gpt, 3),
                           PROMPT, generate=gen, size="tiny")
    with pytest.raises(ValueError) as got:
        aot.export_predictor(d, device="cpu")
    assert str(got.value) == str(want.value)
    assert not (d / aot.AOT_FILE).exists()


def test_load_exported_builds_no_model_module(exported, monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("the loader built a model module")

    monkeypatch.setattr(tgpt.GPTLM, "__init__", refuse)
    monkeypatch.setattr(tbert.BertForSequenceClassification, "__init__",
                        refuse)
    monkeypatch.setattr(tsm, "_build_family", refuse)
    monkeypatch.setattr(tsm, "read_params", refuse)
    call = aot.load_exported(exported["greedy"], "cpu")
    out = aot.padded_chunk_predict(call, PROMPT, 2, "cpu")
    assert out.shape == (2, GEN["max_new_tokens"])
    m = tsm.TorchModel("bert", exported["bert"], device="cpu")
    m.load()
    assert m._aot_batch == 2 and m.predict(IDS).shape == (2, 3)


def test_server_main_pulls_exports_and_batches(tmp_path):
    """``python -m kubeflow_tpu_torch.serving.server --storage-uri pvc://...
    --aot --max-batch-size 8`` on the CPU: the model is pulled under the
    PVC root, exported at load (aot.json written, platform cpu) and its
    answers are the eager predictor's."""
    pvc = tmp_path / "pvc"
    bert = tbert.BertForSequenceClassification(
        tbert.BertConfig.tiny(**FLASH), num_classes=3, device="cpu")
    src = tsm.save_predictor(pvc / "vol" / "bert", "bert-classifier",
                             _weights(bert, 5), IDS, num_classes=3,
                             size="tiny", config=FLASH)
    want = _eager(src).predict(IDS)
    env = {**os.environ, "KFTPU_PVC_ROOT": str(pvc), "OMP_NUM_THREADS": "1"}
    proc = subprocess.Popen(
        [sys.executable, "-m", "kubeflow_tpu_torch.serving.server",
         "--model-name", "bert", "--storage-uri", "pvc://vol/bert",
         "--model-dir", str(tmp_path / "models"), "--device", "cpu",
         "--aot", "--max-batch-size", "8", "--port", "0"],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    try:
        url = None
        for line in proc.stdout:
            found = re.search(r"server ready url=(\S+)", line)
            if found:
                url = found.group(1)
                break
        assert url, "the server exited before it was ready"
        req = urllib.request.Request(
            f"{url}/v1/models/bert:predict",
            data=json.dumps({"instances": IDS.tolist()}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as resp:
            body = json.loads(resp.read())
        np.testing.assert_allclose(np.asarray(body["logits"]), want,
                                   atol=1e-5, rtol=0)
        pulled = tmp_path / "models" / "bert"
        assert json.loads((pulled / aot.AOT_META).read_text())[
            "platforms"] == ["cpu"]
    finally:
        proc.kill()
        proc.wait(timeout=30)
        proc.stdout.close()


def test_int8_dir_reads_back_dequantized(dirs):
    """An int8 dir's weights read back dequantized: each quantized leaf
    within half an int8 step of the float dir's, the rest equal."""
    def read(kind):
        d = dirs[kind]
        return tsm.read_params(
            d, json.loads((d / tsm.CONFIG_FILE).read_text()))

    flat, deq = read("greedy"), read("int8-greedy")
    assert sorted(deq) == sorted(flat)
    n_quantized = 0
    for k, w in flat.items():
        err = np.abs(deq[k] - w).max()
        if err:
            n_quantized += 1
            step = np.abs(w).max() / 127.0
            assert err <= step / 2 * (1 + 1e-5), (k, err, step)
    assert n_quantized == 14  # 2 layers x 6 kernels and 2 embeddings
