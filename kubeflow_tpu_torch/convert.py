"""GPT weights between the JAX package's flax layout and the port's state_dict.

The flax layout is a flat dict keyed by the ``/``-joined param paths of
``kubeflow_tpu.models.gpt.GPTLM`` (``token_embed/embedding``,
``layer_{i}/attention/query/kernel`` (hidden, heads, head_dim), ...). Model
directories store it (``params.npz``) and the tests use it to hand one set of
weights to both implementations. A flax kernel is (in..., out...) and a torch
Linear weight is (out, in), so kernels flatten and transpose; everything
else keeps its values and only flattens where flax splits heads.
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
