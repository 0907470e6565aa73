"""Int8 weight-only quantization for serving artifacts — own copy of
``kubeflow_tpu/serving/quant.py``.

Weight-only int8 cuts a model dir's params about 4x with symmetric
per-output-channel scales (per-row for embedding tables); the weights
dequantize ONCE at load to float32, so runtime numerics and speed are the
float path's: a transport and storage format, not a compute mode.

    save_predictor(..., quantize=True)       # writes int8 + scales
    TorchModel.load()                        # dequantizes transparently

Trees are nested dicts of numpy arrays in the flax layout, flattened and
unflattened with ``/``-joined keys (``flatten_tree``/``unflatten_tree``);
the numpy ops are the JAX package's, so the int8 leaves and scales are
bit-identical to its.
"""

from __future__ import annotations

import re
from typing import Any

import numpy as np

# quantize big matmul weights; leave LayerNorm/bias/small leaves float
DEFAULT_TARGETS = r"(kernel|embedding)$"
MIN_SIZE = 4096

_QKEY = "__int8__"  # marker key inside a quantized leaf's subtree


def flatten_tree(tree: dict, prefix: str = "") -> dict[str, Any]:
    """Nested dict -> {'/'-joined path: leaf}; empty dicts vanish, as in
    ``flax.traverse_util.flatten_dict``."""
    out: dict[str, Any] = {}
    for key, value in tree.items():
        path = f"{prefix}{key}"
        if isinstance(value, dict):
            out.update(flatten_tree(value, path + "/"))
        else:
            out[path] = value
    return out


def unflatten_tree(flat: dict[str, Any]) -> dict:
    """The inverse of ``flatten_tree``."""
    tree: dict = {}
    for path, value in flat.items():
        *parents, leaf = path.split("/")
        node = tree
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = value
    return tree


def quantize_variables(variables: dict, targets: str = DEFAULT_TARGETS) -> dict:
    """params tree -> same tree with matching leaves replaced by
    {_QKEY: 1, q: int8, scale: f32 per-output-channel}."""
    out: dict[str, Any] = {}
    for path, w in flatten_tree(variables).items():
        arr = np.asarray(w)
        if (re.search(targets, path) and arr.ndim >= 2
                and arr.size >= MIN_SIZE
                and arr.dtype.kind == "f"):
            a32 = arr.astype(np.float32)
            if re.search(r"embedding$", path):
                # per-ROW (per-token) scales: the weight-tied LM head reads
                # this table for logits, and a rare small-norm row must not
                # take the largest row's resolution
                absmax = np.max(np.abs(a32), axis=-1, keepdims=True)
            else:
                # symmetric per-output-channel (last dim) scales
                absmax = np.max(np.abs(a32), axis=tuple(range(arr.ndim - 1)))
            scale = np.where(absmax > 0, absmax / 127.0, 1.0).astype(np.float32)
            q = np.clip(np.rint(a32 / scale), -127, 127).astype(np.int8)
            out[path + "/" + _QKEY] = np.int8(1)
            out[path + "/q"] = q
            out[path + "/scale"] = scale
        else:
            out[path] = arr
    return unflatten_tree(out)


def dequantize_variables(variables: dict, dtype=None) -> dict:
    """Inverse of quantize_variables: int8 leaves -> float32 weights (or
    ``dtype``)."""
    flat = flatten_tree(variables)
    out: dict[str, Any] = {}
    done = set()
    for path in flat:
        if not path.endswith("/" + _QKEY):
            continue
        base = path[: -(len(_QKEY) + 1)]
        q = np.asarray(flat[base + "/q"], np.float32)
        scale = np.asarray(flat[base + "/scale"], np.float32)
        w = q * scale  # broadcast over the last dim
        out[base] = w.astype(dtype) if dtype is not None else w
        done.update({path, base + "/q", base + "/scale"})
    for path, v in flat.items():
        if path not in done:
            out[path] = v
    return unflatten_tree(out)


def is_quantized(variables: dict) -> bool:
    return any(p.endswith("/" + _QKEY) for p in flatten_tree(variables))


def quantization_error(variables: dict, quantized: dict) -> float:
    """Max relative per-tensor L2 error across quantized leaves (sanity
    metric: per-channel int8 on trained nets sits well under 1%)."""
    a = flatten_tree(variables)
    b = flatten_tree(dequantize_variables(quantized))
    worst = 0.0
    for path, w in a.items():
        w = np.asarray(w, np.float32)
        d = np.asarray(b[path], np.float32)
        denom = float(np.linalg.norm(w)) or 1.0
        worst = max(worst, float(np.linalg.norm(w - d)) / denom)
    return worst
