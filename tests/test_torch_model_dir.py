"""Model dirs the JAX package wrote, served by the port.

``convert.flax_msgpack_restore`` (no msgpack, no flax) must decode a
``params.msgpack`` bit for bit as ``flax.serialization.msgpack_restore``
does, for GPT, BERT and ResNet variables (``batch_stats`` included). A dir
the JAX ``save_predictor`` wrote — float or ``quantize=True`` — is served by
the port's ``TorchModel`` with JaxModel's logits (1e-4, f32) and its greedy
tokens; a ResNet's running averages come across with its params. Weights
are drawn from numpy seeds over the JAX modules' abstract variables.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization, traverse_util

from kubeflow_tpu.serving.model import JaxModel
from kubeflow_tpu.serving.model import _build_family as jax_build_family
from kubeflow_tpu.serving.model import save_predictor as jax_save_predictor
from kubeflow_tpu_torch.convert import flax_msgpack_restore, params_from_flax
from kubeflow_tpu_torch.serving import model as tsm

try:  # one intra-op thread: the suite shares the machine with timing gates
    torch.set_num_threads(1)
    torch.set_num_interop_threads(1)
except RuntimeError:  # the interop pool can be sized once per process
    pass

IDS = np.random.RandomState(7).randint(1, 512, (3, 12)).astype(np.int32)
IDS[1, -5:] = 0  # a right-padded row
PROMPT = np.random.RandomState(8).randint(1, 512, (2, 6)).astype(np.int32)
IMAGES = np.random.RandomState(9).normal(0, 1, (2, 32, 32, 3)).astype(
    np.float32)
# family -> (kwargs as config.json records them, example input)
CASES = {
    "gpt-lm": ({"size": "tiny"}, IDS),
    "bert-classifier": ({"size": "tiny", "num_classes": 3}, IDS),
    "resnet18": ({"num_classes": 10, "width": 8, "small_inputs": True},
                 IMAGES),
}


def seeded_variables(family: str, seed: int) -> dict:
    """The JAX module's variables (every collection), values drawn from a
    numpy seed: variances and scales in [0.5, 1.5], the rest N(0, 0.1)."""
    kwargs, x = CASES[family]
    jm = jax_build_family(family, dict(kwargs))
    abstract = jax.eval_shape(
        lambda: jm.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    rng = np.random.RandomState(seed)
    out = {}
    for col, tree in abstract.items():
        leaves = {}
        for k, v in sorted(traverse_util.flatten_dict(tree, sep="/").items()):
            a = (rng.uniform(0.5, 1.5, v.shape) if k.endswith(("var", "scale"))
                 else rng.normal(0, 0.1, v.shape))
            leaves[k] = a.astype(np.float32)
        out[col] = traverse_util.unflatten_dict(leaves, sep="/")
    return out


def assert_trees_bit_equal(got, want, path=""):
    if isinstance(want, dict):
        assert isinstance(got, dict) and sorted(got) == sorted(want), path
        for k in want:
            assert_trees_bit_equal(got[k], want[k], f"{path}/{k}")
        return
    assert type(got) is type(want), (path, type(got), type(want))
    if isinstance(want, np.ndarray):
        assert got.dtype == want.dtype and got.shape == want.shape, path
        assert got.tobytes() == want.tobytes(), path
    else:
        assert got == want, path


@pytest.mark.parametrize("family", sorted(CASES))
def test_msgpack_restore_is_flax_bit_for_bit(family):
    variables = seeded_variables(family, seed=len(family))
    if family == "resnet18":
        assert "batch_stats" in variables
    raw = serialization.to_bytes(variables)
    assert_trees_bit_equal(flax_msgpack_restore(raw),
                           serialization.msgpack_restore(raw))
    # the int8 artifact's tree (int8 leaves, numpy-scalar markers) too
    from kubeflow_tpu.serving.quant import quantize_variables

    raw = serialization.to_bytes(quantize_variables(variables))
    assert_trees_bit_equal(flax_msgpack_restore(raw),
                           serialization.msgpack_restore(raw))


def test_msgpack_restore_scalars_and_refusals():
    tree = {"a": {"f": 1.5, "i": -300, "big": 2**40, "t": True, "n": None,
                  "s": "x" * 40, "c": 1 + 2j, "b": b"\x00\x01",
                  "np": np.float32(2.5), "u8": np.arange(300, dtype=np.uint8),
                  "bf16": jnp.arange(4, dtype=jnp.bfloat16), "empty": {}}}
    raw = serialization.to_bytes(tree)
    got, want = flax_msgpack_restore(raw), serialization.msgpack_restore(raw)
    bf16 = got["a"].pop("bf16")
    assert bf16.dtype == np.float32  # numpy has no bfloat16: widened exactly
    np.testing.assert_array_equal(
        bf16, np.asarray(want["a"].pop("bf16"), np.float32))
    assert_trees_bit_equal(got, want)
    with pytest.raises(ValueError, match="trailing bytes"):
        flax_msgpack_restore(raw + b"\x00")
    with pytest.raises(ValueError, match="truncated"):
        flax_msgpack_restore(raw[:-3])


@pytest.fixture(scope="module")
def jax_dirs(tmp_path_factory):
    """GPT dirs the JAX package wrote: logits and greedy generate, float and
    int8, from one set of variables."""
    root = tmp_path_factory.mktemp("jax_dirs")
    variables = seeded_variables("gpt-lm", seed=1)
    dirs = {}
    for q in (False, True):
        tag = "int8" if q else "float"
        dirs[f"logits-{tag}"] = jax_save_predictor(
            root / f"l{tag}", "gpt-lm", variables, IDS, quantize=q,
            size="tiny")
        dirs[f"gen-{tag}"] = jax_save_predictor(
            root / f"g{tag}", "gpt-lm", variables, PROMPT, quantize=q,
            generate={"max_new_tokens": 4}, size="tiny")
    return dirs


@pytest.mark.parametrize("kind", ["logits-float", "logits-int8", "gen-float",
                                  "gen-int8"])
def test_jax_written_dir_serves_jax_outputs(jax_dirs, kind):
    d = jax_dirs[kind]
    assert (d / tsm.JAX_PARAMS_FILE).exists()
    assert not (d / tsm.PARAMS_FILE).exists()
    x = IDS if kind.startswith("logits") else PROMPT
    jm = JaxModel("jax", d)
    jm.load()
    want = np.asarray(jm.predict(x))
    tm = tsm.TorchModel("port", d, device="cpu")
    tm.load()
    got = tm.predict(x)
    assert got.shape == want.shape
    if kind.startswith("logits"):
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    else:
        np.testing.assert_array_equal(got, want)


def test_jax_written_resnet_carries_batch_stats(tmp_path):
    """A ResNet dir the JAX package wrote: the port's predictor equals the
    port module built from the same flat weights, running averages
    included (JAX-vs-port ResNet logits are tests/test_torch_families.py's)."""
    kwargs, x = CASES["resnet18"]
    variables = seeded_variables("resnet18", seed=5)
    d = jax_save_predictor(tmp_path / "r", "resnet18", variables, x, **kwargs)
    flat = {k: v for k, v in traverse_util.flatten_dict(
        variables["params"], sep="/").items()}
    flat.update({f"batch_stats/{k}": v for k, v in traverse_util.flatten_dict(
        variables["batch_stats"], sep="/").items()})
    module = tsm._build_family("resnet18", kwargs, "cpu", list(x.shape))
    module.load_state_dict(params_from_flax(flat, module))
    with torch.no_grad():
        want = module.eval()(torch.from_numpy(x)).numpy()
    tm = tsm.TorchModel("r", d, device="cpu")
    tm.load()
    np.testing.assert_array_equal(tm.predict(x), want)
    with pytest.raises(KeyError, match="collections"):
        (d / tsm.JAX_PARAMS_FILE).write_bytes(serialization.to_bytes(
            {**variables, "cache": {"x": np.zeros(2, np.float32)}}))
        tsm.TorchModel("bad", d, device="cpu").load()
