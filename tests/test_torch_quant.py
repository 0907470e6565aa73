"""The port's int8 weight-only artifacts against the JAX package's.

One tree of tiny GPT weights is drawn from a numpy seed in the flax
layout. ``kubeflow_tpu_torch.serving.quant`` must quantize it to the same
int8 leaves and scales as ``kubeflow_tpu.serving.quant``, bit for bit; a
port model dir written with ``quantize=True`` is smaller than the float
one and serves the logits ``JaxModel`` gives on the same quantized tree.
"""

import json

import numpy as np
import pytest
import torch

from kubeflow_tpu.serving import quant as jq
from kubeflow_tpu.serving.model import JaxModel
from kubeflow_tpu.serving.model import save_predictor as jax_save_predictor
from kubeflow_tpu_torch.convert import _param_map, gpt_params_from_flax
from kubeflow_tpu_torch.models.gpt import GPTConfig
from kubeflow_tpu_torch.serving import quant as tq
from kubeflow_tpu_torch.serving.model import (
    PARAMS_FILE,
    TorchModel,
    save_predictor,
)

try:  # one intra-op thread: the suite shares the machine with timing gates
    torch.set_num_threads(1)
    torch.set_num_interop_threads(1)
except RuntimeError:  # the interop pool can be sized once per process
    pass

IDS = np.random.RandomState(3).randint(1, 512, (3, 12)).astype(np.int32)
IDS[2, -4:] = 0  # a right-padded row


def gpt_flat(seed: int = 0) -> dict[str, np.ndarray]:
    """Tiny GPT weights in the flax flat layout, drawn with numpy: N(0,
    0.1) kernels and embeddings (one row of the embedding scaled up, so a
    shared scale would hurt), N(1, 0.1) norm scales, small biases."""
    rng = np.random.RandomState(seed)
    flat = {}
    for fk, _, shape, _ in _param_map(GPTConfig.tiny()):
        mean = 1.0 if fk.endswith("/scale") else 0.0
        std = 0.01 if fk.endswith("/bias") else 0.1
        flat[fk] = (mean + std * rng.standard_normal(shape)).astype(
            np.float32)
    flat["token_embed/embedding"][7] *= 40.0
    return flat


def nest(flat: dict) -> dict:
    return tq.unflatten_tree(dict(flat))


def test_quantize_is_bit_identical_to_jax():
    tree = {"params": nest(gpt_flat())}
    want = jq.quantize_variables(tree)
    got = tq.quantize_variables(tree)
    wflat = tq.flatten_tree(want)
    gflat = tq.flatten_tree(got)
    assert sorted(gflat) == sorted(wflat)
    n_int8 = 0
    for path, w in wflat.items():
        g = gflat[path]
        assert np.asarray(g).dtype == np.asarray(w).dtype, path
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w),
                                      err_msg=path)
        n_int8 += path.endswith("/q")
    # every kernel and the embedding tables are quantized: 2 layers x 6
    # kernels, token and position embeddings
    assert n_int8 == 14
    assert tq.is_quantized(got) and jq.is_quantized(want)
    assert not tq.is_quantized(tree)
    assert tq.quantization_error(tree, got) == jq.quantization_error(
        tree, want)
    assert tq.quantization_error(tree, got) < 0.01
    deq_t, deq_j = tq.dequantize_variables(got), jq.dequantize_variables(want)
    for path, w in tq.flatten_tree(deq_j).items():
        np.testing.assert_array_equal(tq.flatten_tree(deq_t)[path],
                                      np.asarray(w), err_msg=path)


def test_small_leaves_stay_float():
    tree = {"params": nest(gpt_flat(1))}
    q = tq.quantize_variables(tree)
    deq = tq.flatten_tree(tq.dequantize_variables(q))
    for path, w in tq.flatten_tree(tree).items():
        if w.size < tq.MIN_SIZE or not path.endswith(("kernel", "embedding")):
            np.testing.assert_array_equal(deq[path], w, err_msg=path)
            assert path in tq.flatten_tree(q), path


def test_embedding_rows_get_per_row_scales():
    """A huge-magnitude token must not set the resolution for rare
    small-norm rows (the weight-tied LM head reads this table); the
    counterpart of the JAX package's test."""
    table = np.full((100, 64), 0.01, np.float32)
    table[0] = 10.0
    v = {"params": {"token_embed": {"embedding": table}}}
    q = tq.quantize_variables(dict(v))
    scale = q["params"]["token_embed"]["embedding"]["scale"]
    assert scale.shape == (100, 1)
    np.testing.assert_array_equal(
        scale, jq.quantize_variables(dict(v))["params"]["token_embed"][
            "embedding"]["scale"])
    deq = tq.dequantize_variables(q)["params"]["token_embed"]["embedding"]
    row_err = np.abs(deq[50] - table[50]).max() / 0.01
    assert row_err < 0.01, f"rare-row relative error {row_err:.3f}"


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    root = tmp_path_factory.mktemp("quant")
    flat = gpt_flat(2)
    sd = gpt_params_from_flax(flat, GPTConfig.tiny())
    kw = {"size": "tiny"}
    return {
        "float": save_predictor(root / "f", "gpt-lm", sd, IDS, **kw),
        "int8": save_predictor(root / "q", "gpt-lm", sd, IDS,
                               quantize=True, **kw),
        "jax_int8": jax_save_predictor(root / "jq", "gpt-lm",
                                       {"params": nest(flat)}, IDS,
                                       quantize=True, **kw),
    }


def test_int8_dir_is_smaller_and_marked(dirs):
    f_size = (dirs["float"] / PARAMS_FILE).stat().st_size
    q_size = (dirs["int8"] / PARAMS_FILE).stat().st_size
    assert q_size < f_size / 2.5, (q_size, f_size)
    assert json.loads((dirs["int8"] / "config.json").read_text())[
        "quantized"] is True
    assert "quantized" not in json.loads(
        (dirs["float"] / "config.json").read_text())


def test_int8_predictor_matches_jax_model(dirs):
    """The port's int8 dir, dequantized at load, gives JaxModel's logits on
    the JAX int8 dir of the same weights within 1e-4 (f32); both agree
    with the float predictor on most tokens."""
    jm = JaxModel("jq", dirs["jax_int8"])
    jm.load()
    want = np.asarray(jm.predict(IDS))
    tm = TorchModel("q", dirs["int8"], device="cpu")
    tm.load()
    got = tm.predict(IDS)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    fm = TorchModel("f", dirs["float"], device="cpu")
    fm.load()
    top1 = float((fm.predict(IDS).argmax(-1) == got.argmax(-1)).mean())
    assert top1 >= 0.95, top1
