"""Weights between the JAX package's flax layout and the port's state_dict.

The flax layout is a flat dict keyed by the ``/``-joined param paths of the
JAX module (``token_embed/embedding``, ``layer_{i}/attention/query/kernel``
(hidden, heads, head_dim), ...), with a BatchNorm model's running averages
beside them under ``batch_stats/`` (``batch_stats/bn_init/mean``). Model
directories store it (``params.npz``) and the tests use it to hand one set of
weights to both implementations.

GPT (``gpt_params_from_flax`` / ``flax_params_from_gpt``): a flax kernel is
(in..., out...) and a torch Linear weight is (out, in), so kernels flatten
and transpose; everything else keeps its values and only flattens where flax
splits heads. An MoE block's ``moe/`` parameters keep flax's stacked layouts
(``w_up`` (E, H, F), ``w_down`` (E, F, H)) on both sides.

The other families — ResNet, MNIST, BERT, ViT (``params_from_flax`` /
``flax_params_from``) — keep flax's names and layouts in the port
(``models/layers.py``), so a key only changes its separators, an
embedding table's ``embedding`` is torch's ``weight``, and ``batch_stats/``
marks the BatchNorm buffers ``mean`` and ``var``.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from kubeflow_tpu_torch.models.gpt import GPTConfig


def _param_map(cfg: GPTConfig):
    """(flax key, state_dict key, flax shape, leading input dims of a
    kernel or 0) for every parameter of the configuration."""
    hid, hd = cfg.hidden_size, cfg.hidden_size // cfg.num_heads
    heads, kvh = cfg.num_heads, cfg.num_kv_heads or cfg.num_heads
    out = [("token_embed/embedding", "token_embed.weight",
            (cfg.vocab_size, hid), 0)]
    if cfg.position_embedding == "learned":
        out.append(("position_embed/embedding", "position_embed.weight",
                    (cfg.max_len, hid), 0))

    def norm(fk, tk):
        out.append((f"{fk}/scale", f"{tk}.weight", (hid,), 0))
        if cfg.norm == "layernorm" and cfg.use_bias:
            out.append((f"{fk}/bias", f"{tk}.bias", (hid,), 0))

    def dense(fk, tk, in_shape, out_shape):
        out.append((f"{fk}/kernel", f"{tk}.weight", in_shape + out_shape,
                    len(in_shape)))
        if cfg.use_bias:
            out.append((f"{fk}/bias", f"{tk}.bias", out_shape, 0))

    def moe(fk, tk):
        # MoeMlp keeps flax's stacked layouts and creation order
        e, mlp = cfg.moe_experts, cfg.mlp_dim
        shapes = [("router", (hid, e)), ("w_up", (e, hid, mlp)),
                  ("b_up", (e, mlp)), ("w_down", (e, mlp, hid)),
                  ("b_down", (e, hid)), ("w_gate", (e, hid, mlp)),
                  ("b_gate", (e, mlp))]
        for name, shape in shapes:
            if name.startswith("b_") and not cfg.use_bias:
                continue
            if name.endswith("_gate") and cfg.activation != "swiglu":
                continue
            out.append((f"{fk}/{name}", f"{tk}.{name}", shape, 0))

    for i in range(cfg.num_layers):
        f, t = f"layer_{i}", f"layers.{i}"
        norm(f"{f}/ln_attn", f"{t}.ln_attn")
        dense(f"{f}/attention/query", f"{t}.attention.query", (hid,),
              (heads, hd))
        dense(f"{f}/attention/key", f"{t}.attention.key", (hid,), (kvh, hd))
        dense(f"{f}/attention/value", f"{t}.attention.value", (hid,),
              (kvh, hd))
        dense(f"{f}/attention/attn_out", f"{t}.attention.attn_out",
              (heads, hd), (hid,))
        norm(f"{f}/ln_mlp", f"{t}.ln_mlp")
        if cfg.moe_experts:
            moe(f"{f}/moe", f"{t}.moe")
            continue
        if cfg.activation == "swiglu":
            dense(f"{f}/mlp_gate", f"{t}.mlp_gate", (hid,), (cfg.mlp_dim,))
        dense(f"{f}/mlp_up", f"{t}.mlp_up", (hid,), (cfg.mlp_dim,))
        dense(f"{f}/mlp_down", f"{t}.mlp_down", (cfg.mlp_dim,), (hid,))
    norm("ln_final", "ln_final")
    if not cfg.tie_embeddings:
        out.append(("lm_head/kernel", "lm_head.weight",
                    (hid, cfg.vocab_size), 1))
    return out


def gpt_params_from_flax(flat: dict[str, np.ndarray],
                         cfg: GPTConfig) -> dict[str, torch.Tensor]:
    """Flax flat params -> a state_dict for ``GPTLM(cfg)``: float32 CPU
    tensors, as both packages keep their parameters whatever the compute
    dtype, so float32 params cross without loss. Raises on missing,
    unexpected or misshapen keys."""
    table = _param_map(cfg)
    want = {fk for fk, _, _, _ in table}
    if set(flat) != want:
        raise KeyError(
            f"flax params do not match the config: missing "
            f"{sorted(want - set(flat))}, unexpected "
            f"{sorted(set(flat) - want)}")
    sd = {}
    for fk, tk, shape, n_in in table:
        a = np.asarray(flat[fk])
        if a.shape != shape:
            raise ValueError(f"{fk}: shape {a.shape}, expected {shape}")
        if n_in:
            a = a.reshape(math.prod(shape[:n_in]), -1).T
        else:
            a = a.reshape(-1) if fk.endswith("/bias") else a
        sd[tk] = torch.from_numpy(np.array(a, dtype=np.float32))  # a copy
    return sd


def flax_params_from_gpt(state_dict: dict[str, torch.Tensor],
                         cfg: GPTConfig) -> dict[str, np.ndarray]:
    """The inverse: a ``GPTLM(cfg)`` state_dict -> flax flat params, as
    float32 numpy arrays."""
    flat = {}
    for fk, tk, shape, n_in in _param_map(cfg):
        a = state_dict[tk].detach().to("cpu", torch.float32).numpy()
        flat[fk] = np.ascontiguousarray(a.T if n_in else a).reshape(shape)
    return flat


def flax_layout(module: torch.nn.Module
                ) -> dict[str, tuple[str, tuple, list[int]]]:
    """{parameter name: (flax path, flax shape, the port dim each flax dim
    lies in)} for a port model: the partitioner derives a parameter's spec
    on its flax path and shape (``parallel/partitioner.py``), and the dims
    carry the spec over to the port's layout. A GPT kernel's input dims
    lie in the torch weight's dim 1 and its output dims in dim 0; the
    other families keep flax's layouts."""
    cfg = getattr(module, "cfg", None)
    if isinstance(cfg, GPTConfig) and hasattr(module, "layers"):
        out = {}
        for fk, tk, shape, n_in in _param_map(cfg):
            if n_in:
                dims = [1] * n_in + [0] * (len(shape) - n_in)
            elif fk.endswith("/bias"):
                dims = [0] * len(shape)   # flattened where flax splits heads
            else:
                dims = list(range(len(shape)))
            out[tk] = (fk, shape, dims)
        return out
    return {name: (flax_key(name), tuple(p.shape), list(range(p.ndim)))
            for name, p in module.named_parameters()}


BATCH_STATS = "batch_stats/"
_BATCH_STATS_NAMES = ("mean", "var")   # BatchNorm's buffers
_EMBED_WEIGHT = "_embed.weight"        # a VocabEmbed table's torch name


def flax_key(torch_key: str) -> str:
    """A state_dict key of a ResNet, MNIST, BERT or ViT module -> its flax
    flat key."""
    key = torch_key.replace(".", "/")
    if torch_key.endswith(_EMBED_WEIGHT):
        return key[:-len("weight")] + "embedding"
    if torch_key.rsplit(".", 1)[-1] in _BATCH_STATS_NAMES:
        return BATCH_STATS + key
    return key


def params_from_flax(flat: dict[str, np.ndarray],
                     module: torch.nn.Module) -> dict[str, torch.Tensor]:
    """Flax flat params (and ``batch_stats/``) -> a state_dict for
    ``module`` (a ResNet, MNIST, BERT or ViT model): float32 CPU tensors.
    Raises on missing, unexpected or misshapen keys."""
    want = {flax_key(k): (k, tuple(v.shape))
            for k, v in module.state_dict().items()}
    if set(flat) != set(want):
        raise KeyError(
            f"flax params do not match the module: missing "
            f"{sorted(set(want) - set(flat))}, unexpected "
            f"{sorted(set(flat) - set(want))}")
    sd = {}
    for fk, (tk, shape) in want.items():
        a = np.asarray(flat[fk])
        if a.shape != shape:
            raise ValueError(f"{fk}: shape {a.shape}, expected {shape}")
        sd[tk] = torch.from_numpy(np.array(a, dtype=np.float32))  # a copy
    return sd


def flax_params_from(state_dict: dict[str, torch.Tensor]
                     ) -> dict[str, np.ndarray]:
    """The inverse: a ResNet, MNIST, BERT or ViT state_dict -> flax flat
    params (and ``batch_stats/``), as float32 numpy arrays."""
    return {flax_key(k): v.detach().to("cpu", torch.float32).numpy()
            for k, v in state_dict.items()}


# ------------------------------------------------ flax msgpack (params.msgpack)

# flax.serialization's ext type codes: an ndarray packed as the msgpack
# triple (shape, dtype name, C-order bytes), a Python complex as (re, im),
# a numpy scalar as a 0-d ndarray
_EXT_NDARRAY, _EXT_COMPLEX, _EXT_NPSCALAR = 1, 2, 3
# flax splits an array over 2**30 bytes into a dict of flat chunks
_CHUNKED = "__msgpack_chunked_array__"


class _MsgpackReader:
    """A decoder of the msgpack subset that ``flax.serialization.to_bytes``
    writes: maps, arrays, str, bin, ints, floats, nil, bool and the ext
    types above. Arrays are views of the input buffer (no copy)."""

    def __init__(self, raw):
        self.buf = memoryview(raw)
        self.pos = 0

    def _take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise ValueError("truncated msgpack data")
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def _uint(self, n: int) -> int:
        return int.from_bytes(self._take(n), "big")

    def _int(self, n: int) -> int:
        return int.from_bytes(self._take(n), "big", signed=True)

    def read(self):
        b = self._uint(1)
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self._map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self._array(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return str(self._take(b & 0x1F), "utf-8")
        if b == 0xC0:
            return None
        if b in (0xC2, 0xC3):
            return b == 0xC3
        if b in (0xC4, 0xC5, 0xC6):
            return self._take(self._uint(1 << (b - 0xC4)))
        if b in (0xC7, 0xC8, 0xC9):
            n = self._uint(1 << (b - 0xC7))
            return self._ext(self._int(1), self._take(n))
        if b == 0xCA:
            return float(np.frombuffer(self._take(4), ">f4")[0])
        if b == 0xCB:
            return float(np.frombuffer(self._take(8), ">f8")[0])
        if 0xCC <= b <= 0xCF:
            return self._uint(1 << (b - 0xCC))
        if 0xD0 <= b <= 0xD3:
            return self._int(1 << (b - 0xD0))
        if 0xD4 <= b <= 0xD8:
            code = self._int(1)
            return self._ext(code, self._take(1 << (b - 0xD4)))
        if b in (0xD9, 0xDA, 0xDB):
            return str(self._take(self._uint(1 << (b - 0xD9))), "utf-8")
        if b in (0xDC, 0xDD):
            return self._array(self._uint(2 << (b - 0xDC)))
        if b in (0xDE, 0xDF):
            return self._map(self._uint(2 << (b - 0xDE)))
        raise ValueError(f"msgpack type byte 0x{b:02x} is not supported")

    def _array(self, n: int) -> list:
        return [self.read() for _ in range(n)]

    def _map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.read()
            out[key] = self.read()
        return out

    @staticmethod
    def _ext(code: int, data: memoryview):
        if code == _EXT_NDARRAY:
            return _ndarray_from(data)
        if code == _EXT_NPSCALAR:
            return _ndarray_from(data)[()]
        if code == _EXT_COMPLEX:
            re_, im = _MsgpackReader(data).read()
            return complex(re_, im)
        raise ValueError(f"msgpack ext type {code} is not flax's")


def _ndarray_from(data: memoryview) -> np.ndarray:
    """flax's packed (shape, dtype name, bytes) -> a read-only ndarray view.
    bfloat16, which numpy lacks, widens exactly to float32."""
    shape, name, buffer = _MsgpackReader(data).read()
    name = bytes(name).decode() if not isinstance(name, str) else name
    if name == "bfloat16":
        bits = np.frombuffer(buffer, np.uint16).astype(np.uint32) << 16
        return bits.view(np.float32).reshape(shape)
    return np.frombuffer(buffer, dtype=np.dtype(name)).reshape(shape)


def _unchunk(tree):
    if isinstance(tree, memoryview):  # a bin leaf: bytes, as msgpack's
        return bytes(tree)
    if isinstance(tree, dict):
        if _CHUNKED in tree:
            shape = [tree["shape"][str(i)] for i in range(len(tree["shape"]))]
            chunks = [tree["chunks"][str(i)]
                      for i in range(len(tree["chunks"]))]
            return np.concatenate(chunks).reshape(shape)
        return {k: _unchunk(v) for k, v in tree.items()}
    return tree


def flax_msgpack_restore(raw: bytes) -> dict:
    """``flax.serialization.msgpack_restore`` without msgpack or flax: the
    nested dict of a ``params.msgpack`` (the JAX package's model dir), its
    arrays numpy views of ``raw``, chunked arrays joined."""
    reader = _MsgpackReader(raw)
    tree = reader.read()
    if reader.pos != len(reader.buf):
        raise ValueError(f"{len(reader.buf) - reader.pos} trailing bytes "
                         "after the msgpack object")
    return _unchunk(tree)
