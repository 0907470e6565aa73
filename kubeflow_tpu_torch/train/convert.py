"""Checkpoint import — HF/torch GPT-2, Llama and BERT weights into the
port's model dirs; counterpart of ``kubeflow_tpu/train/convert.py``.

A user of the reference stack arrives with torch checkpoints; this converts
an HF ``GPT2LMHeadModel``, ``LlamaForCausalLM`` / ``MistralForCausalLM`` or
``BertForSequenceClassification`` state dict into the flax-layout variables
the JAX package's importer builds, array for array, and writes them as a
serving-ready predictor dir through the port's ``save_predictor``
(``python -m kubeflow_tpu_torch import-gpt2`` and its siblings): the dir's
``params.npz`` holds the arrays the JAX importer's ``params.msgpack`` holds,
bit for bit, and its ``config.json`` is the same. Weights are read only
from files already on local disk, with ``torch.load(weights_only=True)``.

Architecture mapping (GPT-2; both sides are pre-LN GPT-2):

  wte.weight (V,H)           -> token_embed.embedding  (tied LM head too)
  wpe.weight (P,H)           -> position_embed.embedding
  h.N.ln_1 {weight,bias}     -> layer_N.ln_attn {scale,bias}
  h.N.attn.c_attn (H,3H)+3H  -> query/key/value kernels (H,heads,hd)+bias
                                (HF Conv1D stores (in,out) — no transpose)
  h.N.attn.c_proj (H,H)+H    -> attn_out kernel (heads,hd,H)+bias
  h.N.ln_2                   -> layer_N.ln_mlp
  h.N.mlp.c_fc (H,4H)        -> mlp_up; h.N.mlp.c_proj (4H,H) -> mlp_down
  ln_f                       -> ln_final

HF's gelu_new is the tanh approximation, the models' GELU. torch Linear
(Llama, BERT) stores (out, in), so those kernels transpose.
"""

from __future__ import annotations

import numpy as np

from kubeflow_tpu_torch.models.gpt import GPTConfig
from kubeflow_tpu_torch.models.layers import dtype_name
from kubeflow_tpu_torch.serving.quant import flatten_tree


def _np(t) -> np.ndarray:
    return np.asarray(t.detach().cpu().numpy() if hasattr(t, "detach")
                      else t, np.float32)


def _strip(state_dict: dict,
           prefixes: tuple = ("module.", "transformer.")) -> dict:
    """Normalize HF key prefixes (task models nest the backbone —
    'transformer.' for GPT-2, 'bert.' for BERT; DDP saves add 'module.')
    — the ONE place prefix handling lives."""
    out = {}
    for k, v in state_dict.items():
        for p in prefixes:
            k = k.removeprefix(p)
        out[k] = v
    return out


def torch_gpt2_to_variables(state_dict: dict, cfg: GPTConfig) -> dict:
    """HF GPT2LMHeadModel (or GPT2Model) state dict -> GPTLM variables."""
    sd = _strip(state_dict)
    h, heads = cfg.hidden_size, cfg.num_heads
    hd = h // heads
    if cfg.num_kv_heads and cfg.num_kv_heads != heads:
        raise ValueError(
            "GPT-2 checkpoints are MHA — convert with num_kv_heads=0")
    if cfg.position_embedding != "learned":
        raise ValueError("GPT-2 checkpoints carry learned positions")

    def need(key: str) -> np.ndarray:
        if key not in sd:
            raise KeyError(
                f"checkpoint is missing {key!r} — not a GPT-2 state dict?")
        return _np(sd[key])

    wte = need("wte.weight")
    if wte.shape != (cfg.vocab_size, h):
        raise ValueError(
            f"wte {wte.shape} != (vocab_size {cfg.vocab_size}, "
            f"hidden {h}) — config does not match the checkpoint")
    wpe = need("wpe.weight")
    if wpe.shape[0] < cfg.max_len:
        raise ValueError(
            f"checkpoint has {wpe.shape[0]} positions < max_len "
            f"{cfg.max_len}")
    params: dict = {
        "token_embed": {"embedding": wte},
        "position_embed": {"embedding": wpe[: cfg.max_len]},
        "ln_final": {"scale": need("ln_f.weight"),
                     "bias": need("ln_f.bias")},
    }
    for i in range(cfg.num_layers):
        p = f"h.{i}."
        ca_w = need(p + "attn.c_attn.weight")      # (H, 3H), (in, out)
        ca_b = need(p + "attn.c_attn.bias")        # (3H,)
        qw, kw, vw = np.split(ca_w, 3, axis=1)
        qb, kb, vb = np.split(ca_b, 3)
        proj_w = need(p + "attn.c_proj.weight")    # (H, H)
        params[f"layer_{i}"] = {
            "ln_attn": {"scale": need(p + "ln_1.weight"),
                        "bias": need(p + "ln_1.bias")},
            "ln_mlp": {"scale": need(p + "ln_2.weight"),
                       "bias": need(p + "ln_2.bias")},
            "attention": {
                "query": {"kernel": qw.reshape(h, heads, hd),
                          "bias": qb.reshape(heads, hd)},
                "key": {"kernel": kw.reshape(h, heads, hd),
                        "bias": kb.reshape(heads, hd)},
                "value": {"kernel": vw.reshape(h, heads, hd),
                          "bias": vb.reshape(heads, hd)},
                "attn_out": {"kernel": proj_w.reshape(heads, hd, h),
                             "bias": need(p + "attn.c_proj.bias")},
            },
            "mlp_up": {"kernel": need(p + "mlp.c_fc.weight"),
                       "bias": need(p + "mlp.c_fc.bias")},
            "mlp_down": {"kernel": need(p + "mlp.c_proj.weight"),
                         "bias": need(p + "mlp.c_proj.bias")},
        }
    return {"params": params}


def torch_llama_to_variables(state_dict: dict, cfg: GPTConfig) -> dict:
    """HF LlamaForCausalLM / MistralForCausalLM state dict -> GPTLM
    variables (the GPTConfig.llama family). torch Linear stores
    (out, in), so every projection transposes. No rope permutation is
    needed: apply_rope (parallel/rope.py) uses the same half-split
    rotate-half convention as transformers' Llama."""
    sd = _strip(state_dict, prefixes=("module.", "model."))
    h, heads = cfg.hidden_size, cfg.num_heads
    hd = h // heads
    kvh = cfg.num_kv_heads or heads
    if cfg.position_embedding != "rope" or cfg.norm != "rmsnorm" \
            or cfg.activation != "swiglu":
        raise ValueError(
            "llama checkpoints need a llama-shaped config "
            "(GPTConfig.llama: rope + rmsnorm + swiglu); got "
            f"position_embedding={cfg.position_embedding!r} "
            f"norm={cfg.norm!r} activation={cfg.activation!r}")

    def need(key: str) -> np.ndarray:
        if key not in sd:
            raise KeyError(
                f"checkpoint is missing {key!r} — not a Llama/Mistral "
                "state dict?")
        return _np(sd[key])

    emb = need("embed_tokens.weight")
    if emb.shape != (cfg.vocab_size, h):
        raise ValueError(
            f"embed_tokens {emb.shape} != (vocab_size {cfg.vocab_size}, "
            f"hidden {h}) — config does not match the checkpoint")
    params: dict = {
        "token_embed": {"embedding": emb},
        "ln_final": {"scale": need("norm.weight")},
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = {"kernel": need("lm_head.weight").T}
    elif "lm_head.weight" in sd and not np.allclose(
            _np(sd["lm_head.weight"]), emb):
        raise ValueError(
            "config says tie_embeddings but the checkpoint's lm_head "
            "differs from embed_tokens — convert with "
            "tie_embeddings=False")
    for i in range(cfg.num_layers):
        p = f"layers.{i}."
        attn = {
            "query": {"kernel":
                      need(p + "self_attn.q_proj.weight").T.reshape(
                          h, heads, hd)},
            "key": {"kernel":
                    need(p + "self_attn.k_proj.weight").T.reshape(
                        h, kvh, hd)},
            "value": {"kernel":
                      need(p + "self_attn.v_proj.weight").T.reshape(
                          h, kvh, hd)},
            "attn_out": {"kernel":
                         need(p + "self_attn.o_proj.weight").T.reshape(
                             heads, hd, h)},
        }
        layer = {
            "ln_attn": {"scale": need(p + "input_layernorm.weight")},
            "ln_mlp": {"scale":
                       need(p + "post_attention_layernorm.weight")},
            "attention": attn,
            "mlp_gate": {"kernel": need(p + "mlp.gate_proj.weight").T},
            "mlp_up": {"kernel": need(p + "mlp.up_proj.weight").T},
            "mlp_down": {"kernel": need(p + "mlp.down_proj.weight").T},
        }
        if cfg.use_bias:
            attn["query"]["bias"] = need(
                p + "self_attn.q_proj.bias").reshape(heads, hd)
            attn["key"]["bias"] = need(
                p + "self_attn.k_proj.bias").reshape(kvh, hd)
            attn["value"]["bias"] = need(
                p + "self_attn.v_proj.bias").reshape(kvh, hd)
            attn["attn_out"]["bias"] = need(p + "self_attn.o_proj.bias")
            layer["mlp_gate"]["bias"] = need(p + "mlp.gate_proj.bias")
            layer["mlp_up"]["bias"] = need(p + "mlp.up_proj.bias")
            layer["mlp_down"]["bias"] = need(p + "mlp.down_proj.bias")
        params[f"layer_{i}"] = layer
    return {"params": params}


def torch_bert_to_variables(state_dict: dict, cfg, num_classes: int) -> dict:
    """HF BertForSequenceClassification (or BertModel + a classifier head)
    state dict -> BertForSequenceClassification variables. torch Linear
    stores (out, in) — every kernel transposes (unlike GPT-2's Conv1D)."""
    sd = _strip(state_dict, ("module.", "bert."))
    h, heads = cfg.hidden_size, cfg.num_heads
    hd = h // heads

    def need(key: str) -> np.ndarray:
        if key not in sd:
            raise KeyError(
                f"checkpoint is missing {key!r} — not a BERT state dict?")
        return _np(sd[key])

    def lin(prefix: str):
        """torch Linear (out,in)+bias -> flax (in,out) kernel + bias."""
        return need(prefix + ".weight").T, need(prefix + ".bias")

    wte = need("embeddings.word_embeddings.weight")
    if wte.shape != (cfg.vocab_size, h):
        raise ValueError(
            f"word_embeddings {wte.shape} != (vocab_size "
            f"{cfg.vocab_size}, hidden {h})")
    wpe = need("embeddings.position_embeddings.weight")
    if wpe.shape[0] < cfg.max_len:
        raise ValueError(
            f"checkpoint has {wpe.shape[0]} positions < max_len "
            f"{cfg.max_len}")
    enc: dict = {
        "embeddings": {
            "token_embed": {"embedding": wte},
            "position_embed": {"embedding": wpe[: cfg.max_len]},
            "type_embed": {
                "embedding":
                    need("embeddings.token_type_embeddings.weight")},
            "ln_embed": {
                "scale": need("embeddings.LayerNorm.weight"),
                "bias": need("embeddings.LayerNorm.bias")},
        },
    }
    for i in range(cfg.num_layers):
        p = f"encoder.layer.{i}."
        qw, qb = lin(p + "attention.self.query")
        kw, kb = lin(p + "attention.self.key")
        vw, vb = lin(p + "attention.self.value")
        ow, ob = lin(p + "attention.output.dense")
        up_w, up_b = lin(p + "intermediate.dense")
        dn_w, dn_b = lin(p + "output.dense")
        enc[f"layer_{i}"] = {
            "attention": {
                "query": {"kernel": qw.reshape(h, heads, hd),
                          "bias": qb.reshape(heads, hd)},
                "key": {"kernel": kw.reshape(h, heads, hd),
                        "bias": kb.reshape(heads, hd)},
                "value": {"kernel": vw.reshape(h, heads, hd),
                          "bias": vb.reshape(heads, hd)},
                "attn_out": {"kernel": ow.reshape(heads, hd, h),
                             "bias": ob},
            },
            "ln_attn": {
                "scale": need(p + "attention.output.LayerNorm.weight"),
                "bias": need(p + "attention.output.LayerNorm.bias")},
            "mlp_up": {"kernel": up_w, "bias": up_b},
            "mlp_down": {"kernel": dn_w, "bias": dn_b},
            "ln_mlp": {"scale": need(p + "output.LayerNorm.weight"),
                       "bias": need(p + "output.LayerNorm.bias")},
        }
    pool_w, pool_b = lin("pooler.dense")
    params = {"encoder": enc,
              "pooler": {"kernel": pool_w, "bias": pool_b}}
    if "classifier.weight" in sd:
        cw, cb = need("classifier.weight").T, need("classifier.bias")
        if cw.shape != (h, num_classes):
            raise ValueError(
                f"classifier head is {tuple(cw.shape[::-1])}, expected "
                f"({num_classes} classes, hidden {h})")
        params["classifier"] = {"kernel": cw, "bias": cb}
    else:
        # BertModel checkpoint without a task head: fresh zero head (the
        # fine-tune-from-pretrained shape)
        params["classifier"] = {
            "kernel": np.zeros((h, num_classes), np.float32),
            "bias": np.zeros((num_classes,), np.float32)}
    return {"params": params}


def _save(out_dir: str, family: str, variables: dict, model, example,
          **kwargs):
    """The JAX importer's ``save_predictor`` call, made through the port's:
    the flax-layout ``variables`` become the state_dict of the family's
    module (``model``: the GPTConfig for gpt-lm, else a module with the
    family's parameter names and shapes), which ``save_predictor`` writes
    back in the flax layout, array for array."""
    from kubeflow_tpu_torch.convert import (
        gpt_params_from_flax,
        params_from_flax,
    )
    from kubeflow_tpu_torch.serving.model import save_predictor

    flat = flatten_tree(variables["params"])
    sd = (gpt_params_from_flax(flat, model) if family == "gpt-lm"
          else params_from_flax(flat, model))
    return save_predictor(out_dir, family, sd, example, **kwargs)


def import_bert(checkpoint_path: str, out_dir: str,
                num_heads: int | None = None,
                num_classes: int | None = None,
                max_len: int | None = None) -> str:
    """torch .pt/.bin BERT checkpoint -> serving-ready bert-classifier
    predictor dir. Dimensions read off the tensors; the head count must
    come from the caller or a 'config' entry (same contract as
    import_gpt2); num_classes defaults to the checkpoint's classifier
    head (required when importing a headless BertModel)."""
    from kubeflow_tpu_torch.models.bert import (
        BertConfig,
        BertForSequenceClassification,
    )

    state_dict, cfg_d = _load_torch_blob(checkpoint_path)
    # the same fail-fast bert_config_from_hf performs: a variant the
    # encoder does not implement must not import into garbage logits
    act = cfg_d.get("hidden_act", "gelu")
    if act not in ("gelu", "gelu_new"):
        raise ValueError(
            f"unsupported hidden_act {act!r}: the in-tree encoder is "
            "gelu-only")
    pet = cfg_d.get("position_embedding_type", "absolute")
    if pet != "absolute":
        raise ValueError(
            f"unsupported position_embedding_type {pet!r}: the in-tree "
            "encoder uses absolute learned positions")
    sd = _strip(state_dict, ("module.", "bert."))
    wte = _np(sd["embeddings.word_embeddings.weight"])
    wpe = _np(sd["embeddings.position_embeddings.weight"])
    n_layer = 1 + max(int(k.split(".")[2]) for k in sd
                      if k.startswith("encoder.layer."))
    hidden = wte.shape[1]
    n_head = num_heads or int(cfg_d.get("num_attention_heads", 0))
    if not n_head:
        raise ValueError(
            "num_heads is required: a bare state dict does not determine "
            "the head count (pass --num-heads, or save the checkpoint as "
            "{'state_dict': ..., 'config': {'num_attention_heads': N}})")
    if hidden % n_head:
        raise ValueError(
            f"hidden {hidden} not divisible by num_heads {n_head}")
    if num_classes is None:
        if "classifier.weight" not in sd:
            raise ValueError(
                "num_classes is required for a headless BertModel "
                "checkpoint (no classifier.weight)")
        num_classes = _np(sd["classifier.weight"]).shape[0]
    cfg = BertConfig(
        vocab_size=wte.shape[0], hidden_size=hidden, num_layers=n_layer,
        num_heads=n_head,
        mlp_dim=_np(sd["encoder.layer.0.intermediate.dense.weight"]).shape[0],
        max_len=min(max_len or wpe.shape[0], wpe.shape[0]),
        dropout_rate=0.0,
    )
    variables = torch_bert_to_variables(sd, cfg, num_classes=num_classes)
    example = np.zeros((1, min(16, cfg.max_len)), np.int32)
    module = BertForSequenceClassification(cfg, num_classes, device="cpu")
    return str(_save(
        out_dir, "bert-classifier", variables, module, example,
        size="base", num_classes=num_classes,
        config={
            "vocab_size": cfg.vocab_size, "hidden_size": cfg.hidden_size,
            "num_layers": cfg.num_layers, "num_heads": cfg.num_heads,
            "mlp_dim": cfg.mlp_dim, "max_len": cfg.max_len,
            "dropout_rate": 0.0,
        },
    ))


def bert_config_from_hf(hf_config, max_len: int | None = None, dtype=None):
    """BertConfig mirroring a transformers BertConfig. Fails fast on
    architectural variants the in-tree encoder does not implement — a
    silent convert of those would produce garbage logits."""
    from kubeflow_tpu_torch.models.bert import BertConfig

    act = getattr(hf_config, "hidden_act", "gelu")
    if act not in ("gelu", "gelu_new"):
        raise ValueError(
            f"unsupported hidden_act {act!r}: the in-tree encoder is "
            "gelu-only (transformers' erf-gelu vs flax's tanh approx "
            "differ only at fp tolerance; other activations do not)")
    pet = getattr(hf_config, "position_embedding_type", "absolute")
    if pet != "absolute":
        raise ValueError(
            f"unsupported position_embedding_type {pet!r}: the in-tree "
            "encoder uses absolute learned positions")
    return BertConfig(
        vocab_size=hf_config.vocab_size,
        hidden_size=hf_config.hidden_size,
        num_layers=hf_config.num_hidden_layers,
        num_heads=hf_config.num_attention_heads,
        mlp_dim=hf_config.intermediate_size,
        max_len=min(max_len or hf_config.max_position_embeddings,
                    hf_config.max_position_embeddings),
        dropout_rate=0.0,
        pad_token_id=hf_config.pad_token_id or 0,
        dtype=dtype_name(dtype or "float32"),
    )


def config_from_hf(hf_config, max_len: int | None = None,
                   dtype=None) -> GPTConfig:
    """GPTConfig mirroring a transformers GPT2Config."""
    return GPTConfig(
        vocab_size=hf_config.vocab_size,
        hidden_size=hf_config.n_embd,
        num_layers=hf_config.n_layer,
        num_heads=hf_config.n_head,
        mlp_dim=4 * hf_config.n_embd,
        max_len=min(max_len or hf_config.n_positions,
                    hf_config.n_positions),
        dropout_rate=0.0,
        dtype=dtype_name(dtype or "float32"),
    )


def llama_config_from_hf(hf_config, max_len: int | None = None,
                         dtype=None) -> GPTConfig:
    """GPTConfig.llama mirroring a transformers LlamaConfig /
    MistralConfig (accepts the config object or a plain field dict).
    Fails fast on variants the in-tree decoder does not implement."""
    get = (hf_config.get if isinstance(hf_config, dict)
           else lambda k, d=None: getattr(hf_config, k, d))
    act = get("hidden_act", "silu")
    if act != "silu":
        raise ValueError(
            f"unsupported hidden_act {act!r}: llama-family conversion "
            "targets swiglu (silu) MLPs")
    scaling = get("rope_scaling", None)
    if scaling:
        # Llama-3.1+ long-context checkpoints rescale rope frequencies;
        # converting with plain rope would serve silently-wrong logits at
        # every position — fail fast instead (same contract as hidden_act)
        raise ValueError(
            f"rope_scaling {scaling!r} is not implemented by the in-tree "
            "rope (parallel/rope.py applies plain theta frequencies); "
            "converting would produce numerically wrong attention")
    attn_bias = bool(get("attention_bias", False))
    mlp_bias = bool(get("mlp_bias", False))
    if attn_bias != mlp_bias:
        raise ValueError(
            "attention_bias != mlp_bias is not representable: the "
            "in-tree use_bias knob covers every projection")
    heads = get("num_attention_heads")
    hf_max = get("max_position_embeddings", 2048)
    final_max = min(max_len or hf_max, hf_max)
    window = get("sliding_window", None) or 0
    return GPTConfig.llama(
        vocab_size=get("vocab_size"),
        hidden_size=get("hidden_size"),
        num_layers=get("num_hidden_layers"),
        num_heads=heads,
        num_kv_heads=get("num_key_value_heads", heads) or heads,
        mlp_dim=get("intermediate_size"),
        max_len=final_max,
        rope_theta=float(get("rope_theta", 10000.0)),
        norm_eps=float(get("rms_norm_eps", 1e-6)),
        use_bias=attn_bias,
        tie_embeddings=bool(get("tie_word_embeddings", False)),
        # a window >= the served context is pure masking overhead
        attention_window=(window if window and window < final_max else 0),
        dtype=dtype_name(dtype or "float32"),
    )


def _load_torch_blob(checkpoint_path: str) -> tuple[dict, dict]:
    """(state_dict, config_dict) from a torch checkpoint, loaded with
    weights_only (checkpoint pickles are never executed) — the one
    loader both importers share."""
    import pickle

    import torch

    try:
        blob = torch.load(checkpoint_path, map_location="cpu",
                          weights_only=True)
    except (pickle.UnpicklingError, RuntimeError) as exc:
        raise ValueError(
            "checkpoint is not loadable as plain tensors (weights_only) — "
            "save it as torch.save(model.state_dict()), not the whole "
            f"module: {exc}") from exc
    if not isinstance(blob, dict):
        raise ValueError(
            "checkpoint must be a state dict (torch.save(model."
            "state_dict())) or {'state_dict': ..., 'config': {...}}, "
            f"got {type(blob).__name__}")
    if "state_dict" in blob:
        state_dict, cfg_d = blob["state_dict"], blob.get("config", {})
        if not isinstance(cfg_d, dict):
            raise ValueError(
                "'config' entry must be a plain dict of HF config "
                f"fields, got {type(cfg_d).__name__}")
        return state_dict, cfg_d
    return blob, {}


def import_llama(checkpoint_path: str, out_dir: str,
                 num_heads: int | None = None,
                 max_new_tokens: int = 32, max_len: int | None = None,
                 prompt_len: int = 16,
                 continuous_rows: int = 0) -> str:
    """torch .pt/.bin Llama/Mistral checkpoint -> serving-ready gpt-lm
    predictor dir (GPTConfig.llama family: rope + GQA + RMSNorm + SwiGLU,
    untied or tied head, optional sliding window from the HF config).

    Every dimension except the head count is read off the tensors —
    including num_kv_heads (k_proj rows / head_dim). ``num_heads`` must
    come from the caller or a 'config' entry in the blob
    ({'state_dict': ..., 'config': {'num_attention_heads': N, ...}})."""
    state_dict, cfg_d = _load_torch_blob(checkpoint_path)
    sd = _strip(state_dict, prefixes=("module.", "model."))
    if "embed_tokens.weight" not in sd:
        raise ValueError(
            "checkpoint has no 'embed_tokens.weight' — not a "
            "Llama/Mistral state dict? (GPT-2 checkpoints go through "
            "import-gpt2)")
    emb = _np(sd["embed_tokens.weight"])
    layer_ids = [int(k.split(".")[1]) for k in sd
                 if k.startswith("layers.")]
    if not layer_ids:
        raise ValueError(
            "checkpoint has no 'layers.N.*' keys — not a Llama/Mistral "
            "state dict?")
    n_layer = 1 + max(layer_ids)
    hidden = emb.shape[1]
    n_head = num_heads or int(cfg_d.get("num_attention_heads", 0))
    if not n_head:
        raise ValueError(
            "num_heads is required: a bare state dict does not determine "
            "the head count (pass --num-heads, or save the checkpoint as "
            "{'state_dict': ..., 'config': {'num_attention_heads': N}})")
    if hidden % n_head:
        raise ValueError(
            f"hidden {hidden} not divisible by num_heads {n_head}")
    hd = hidden // n_head
    cfg_hd = cfg_d.get("head_dim")
    if cfg_hd and int(cfg_hd) != hd:
        raise ValueError(
            f"explicit head_dim {cfg_hd} != hidden/num_heads {hd}: "
            "decoupled-head-dim variants (Mistral-Nemo-style) are not "
            "representable by the in-tree family")
    kv_rows = _np(sd["layers.0.self_attn.k_proj.weight"]).shape[0]
    if kv_rows % hd:
        raise ValueError(
            f"k_proj rows {kv_rows} not divisible by head_dim {hd} — "
            "wrong num_heads for this checkpoint?")
    hf_fields = dict(cfg_d)
    hf_fields.setdefault("vocab_size", emb.shape[0])
    hf_fields.setdefault("hidden_size", hidden)
    hf_fields.setdefault("num_hidden_layers", n_layer)
    hf_fields.setdefault("num_attention_heads", n_head)
    hf_fields.setdefault("num_key_value_heads", kv_rows // hd)
    hf_fields.setdefault(
        "intermediate_size",
        _np(sd["layers.0.mlp.gate_proj.weight"]).shape[0])
    hf_fields.setdefault("attention_bias",
                         "layers.0.self_attn.q_proj.bias" in sd)
    hf_fields.setdefault("mlp_bias", "layers.0.mlp.gate_proj.bias" in sd)
    hf_fields.setdefault("tie_word_embeddings", "lm_head.weight" not in sd)
    cfg = llama_config_from_hf(hf_fields, max_len=max_len)
    variables = torch_llama_to_variables(sd, cfg)
    example = np.zeros((1, prompt_len), np.int32)
    gen_cfg: dict = {"max_new_tokens": max_new_tokens, "pad_token_id": -1}
    if continuous_rows:
        gen_cfg["continuous"] = True
        gen_cfg["continuous_rows"] = int(continuous_rows)
    eos = cfg_d.get("eos_token_id")
    if isinstance(eos, (list, tuple)):
        # Llama-3-style configs list several stop ids — the decode paths
        # stop on ANY of them (generate/speculative/continuous all take
        # the full set; the first id is the post-stop clamp token)
        eos = [int(x) for x in eos] or None
    elif eos is not None:
        eos = int(eos)
    if eos is not None:
        gen_cfg["eos_token_id"] = eos
    return str(_save(
        out_dir, "gpt-lm", variables, cfg, example,
        generate=gen_cfg,
        size="small",
        config={
            "vocab_size": cfg.vocab_size, "hidden_size": cfg.hidden_size,
            "num_layers": cfg.num_layers, "num_heads": cfg.num_heads,
            "num_kv_heads": cfg.num_kv_heads, "mlp_dim": cfg.mlp_dim,
            "max_len": cfg.max_len, "dropout_rate": 0.0,
            "position_embedding": "rope", "rope_theta": cfg.rope_theta,
            "norm": "rmsnorm", "activation": "swiglu",
            "use_bias": cfg.use_bias,
            "tie_embeddings": cfg.tie_embeddings,
            "norm_eps": cfg.norm_eps,
            "attention_window": cfg.attention_window,
        },
    ))


def import_gpt2(checkpoint_path: str, out_dir: str,
                num_heads: int | None = None,
                max_new_tokens: int = 32, max_len: int | None = None,
                prompt_len: int = 16, vocab_json: str | None = None,
                merges_txt: str | None = None,
                continuous_rows: int = 0) -> str:
    """torch .pt/.bin GPT-2 checkpoint -> serving-ready gpt-lm predictor
    dir. Every dimension except the head count is read off the tensors;
    ``num_heads`` must come from the caller or a 'config' entry in the
    blob ({'state_dict': ..., 'config': {'n_head': N, ...}}) — a bare
    state dict does NOT determine it, and a wrong head split converts to
    a numerically wrong model."""
    state_dict, cfg_d = _load_torch_blob(checkpoint_path)
    act = cfg_d.get("activation_function", "gelu_new")
    if act not in ("gelu", "gelu_new"):
        raise ValueError(
            f"unsupported activation_function {act!r}: the in-tree "
            "decoder is gelu-only")
    sd = _strip(state_dict)
    wte = _np(sd["wte.weight"])
    wpe = _np(sd["wpe.weight"])
    n_layer = 1 + max(
        int(k.split(".")[1]) for k in sd if k.startswith("h."))
    hidden = _np(sd["h.0.attn.c_attn.weight"]).shape[0]
    n_head = num_heads or int(cfg_d.get("n_head", 0))
    if not n_head:
        raise ValueError(
            "num_heads is required: a bare state dict does not determine "
            "the head count (pass --num-heads, or save the checkpoint as "
            "{'state_dict': ..., 'config': {'n_head': N}})")
    if hidden % n_head:
        raise ValueError(
            f"hidden {hidden} not divisible by num_heads {n_head}")
    cfg = GPTConfig(
        vocab_size=wte.shape[0], hidden_size=hidden, num_layers=n_layer,
        num_heads=n_head, mlp_dim=_np(sd["h.0.mlp.c_fc.weight"]).shape[1],
        max_len=min(max_len or wpe.shape[0], wpe.shape[0]),
        dropout_rate=0.0,
    )
    # tokenizer validation happens BEFORE any weight conversion and any
    # artifact write — an invalid pair must not leave a predictor dir
    # behind that silently serves raw ids
    if (vocab_json is None) != (merges_txt is None):
        raise ValueError(
            "pass BOTH --vocab-json and --merges-txt (the HF checkpoint's "
            "tokenizer files) or neither")
    tok = None
    if vocab_json is not None:
        from kubeflow_tpu_torch.train.bpe_gpt2 import Gpt2Tokenizer

        tok = Gpt2Tokenizer.load(vocab_json, merges_txt)
        max_id = max(tok.vocab.values(), default=-1)
        if max_id >= cfg.vocab_size:
            raise ValueError(
                f"tokenizer ids reach {max_id} but the model's vocab is "
                f"{cfg.vocab_size} — wrong vocab.json for this checkpoint")
    variables = torch_gpt2_to_variables(sd, cfg)
    example = np.zeros((1, prompt_len), np.int32)
    gen_cfg = {"max_new_tokens": max_new_tokens, "pad_token_id": -1}
    if continuous_rows:
        # serve through the continuous-batching engine (iteration-level
        # scheduling, serving/continuous.py): the imported checkpoint is
        # production-serving-ready out of the box
        gen_cfg["continuous"] = True
        gen_cfg["continuous_rows"] = int(continuous_rows)
    # GPT-2 has no pad token ('!' is legitimately id 0): -1 disables the
    # served pad-in-prompt rejection. When the tokenizer is bundled, its
    # <|endoftext|> becomes the served eos (rows clamp; generate trims).
    if tok is not None and "<|endoftext|>" in tok.vocab:
        gen_cfg["eos_token_id"] = int(tok.vocab["<|endoftext|>"])
    out = str(_save(
        out_dir, "gpt-lm", variables, cfg, example,
        generate=gen_cfg,
        size="small",
        config={
            "vocab_size": cfg.vocab_size, "hidden_size": cfg.hidden_size,
            "num_layers": cfg.num_layers, "num_heads": cfg.num_heads,
            "mlp_dim": cfg.mlp_dim, "max_len": cfg.max_len,
            "dropout_rate": 0.0,
        },
    ))
    if tok is not None:
        from pathlib import Path

        tok.save(Path(out) / "tokenizer.json")
    return out
