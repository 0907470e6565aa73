"""The port's checkpoint importers (train/convert.py) against the JAX
package's.

Synthetic state dicts with HF's keys, drawn from a numpy seed (no
transformers needed): each importer's model dir holds a ``params.npz``
whose arrays equal, bit for bit, those of the JAX importer's
``params.msgpack``, and the same ``config.json``. With transformers
installed, the served dirs of tiny ``GPT2LMHeadModel`` /
``LlamaForCausalLM`` (GQA) / ``BertForSequenceClassification``
checkpoints give logits within 1e-4 of the JAX package's model on the
same checkpoint, and within the JAX package's own limits of transformers'
(1e-4 for Llama; 6e-3 for GPT-2 and BERT, whose LayerNorm eps the models
do not take). Every refusal of the JAX importers raises the same error,
with the same text, in the port's.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from kubeflow_tpu.train import convert as jc
from kubeflow_tpu_torch.convert import flax_msgpack_restore
from kubeflow_tpu_torch.serving.model import (
    TorchModel,
    load_generative_model,
)
from kubeflow_tpu_torch.serving.quant import flatten_tree
from kubeflow_tpu_torch.train import convert as tc

try:  # one intra-op thread: the suite shares the machine with timing gates
    torch.set_num_threads(1)
    torch.set_num_interop_threads(1)
except RuntimeError:  # the interop pool can be sized once per process
    pass

H, HEADS, KV_HEADS, LAYERS, VOCAB, POS = 32, 4, 2, 2, 96, 32


def _t(rng, *shape, std=0.05):
    return torch.from_numpy(rng.normal(0, std, shape).astype(np.float32))


def gpt2_state_dict(seed=0, prefix="transformer."):
    rng = np.random.RandomState(seed)
    sd = {"wte.weight": _t(rng, VOCAB, H), "wpe.weight": _t(rng, POS, H),
          "ln_f.weight": 1 + _t(rng, H), "ln_f.bias": _t(rng, H)}
    for i in range(LAYERS):
        p = f"h.{i}."
        sd.update({
            p + "ln_1.weight": 1 + _t(rng, H), p + "ln_1.bias": _t(rng, H),
            p + "ln_2.weight": 1 + _t(rng, H), p + "ln_2.bias": _t(rng, H),
            p + "attn.c_attn.weight": _t(rng, H, 3 * H),
            p + "attn.c_attn.bias": _t(rng, 3 * H),
            p + "attn.c_proj.weight": _t(rng, H, H),
            p + "attn.c_proj.bias": _t(rng, H),
            p + "mlp.c_fc.weight": _t(rng, H, 4 * H),
            p + "mlp.c_fc.bias": _t(rng, 4 * H),
            p + "mlp.c_proj.weight": _t(rng, 4 * H, H),
            p + "mlp.c_proj.bias": _t(rng, H)})
    return {prefix + k: v for k, v in sd.items()}


def llama_state_dict(seed=1, tied=False):
    rng = np.random.RandomState(seed)
    hd, mlp = H // HEADS, 88
    sd = {"model.embed_tokens.weight": _t(rng, VOCAB, H),
          "model.norm.weight": 1 + _t(rng, H)}
    if not tied:
        sd["lm_head.weight"] = _t(rng, VOCAB, H)
    for i in range(LAYERS):
        p = f"model.layers.{i}."
        sd.update({
            p + "input_layernorm.weight": 1 + _t(rng, H),
            p + "post_attention_layernorm.weight": 1 + _t(rng, H),
            p + "self_attn.q_proj.weight": _t(rng, H, H),
            p + "self_attn.k_proj.weight": _t(rng, KV_HEADS * hd, H),
            p + "self_attn.v_proj.weight": _t(rng, KV_HEADS * hd, H),
            p + "self_attn.o_proj.weight": _t(rng, H, H),
            p + "mlp.gate_proj.weight": _t(rng, mlp, H),
            p + "mlp.up_proj.weight": _t(rng, mlp, H),
            p + "mlp.down_proj.weight": _t(rng, H, mlp)})
    return sd


def bert_state_dict(seed=2, classes=3, head=True):
    rng = np.random.RandomState(seed)
    sd = {"bert.embeddings.word_embeddings.weight": _t(rng, VOCAB, H),
          "bert.embeddings.position_embeddings.weight": _t(rng, POS, H),
          "bert.embeddings.token_type_embeddings.weight": _t(rng, 2, H),
          "bert.embeddings.LayerNorm.weight": 1 + _t(rng, H),
          "bert.embeddings.LayerNorm.bias": _t(rng, H),
          "bert.pooler.dense.weight": _t(rng, H, H),
          "bert.pooler.dense.bias": _t(rng, H)}
    for i in range(LAYERS):
        p = f"bert.encoder.layer.{i}."
        for name, (o, n) in {"attention.self.query": (H, H),
                             "attention.self.key": (H, H),
                             "attention.self.value": (H, H),
                             "attention.output.dense": (H, H),
                             "intermediate.dense": (4 * H, H),
                             "output.dense": (H, 4 * H)}.items():
            sd[p + name + ".weight"] = _t(rng, o, n)
            sd[p + name + ".bias"] = _t(rng, o)
        for ln in ("attention.output.LayerNorm", "output.LayerNorm"):
            sd[p + ln + ".weight"] = 1 + _t(rng, H)
            sd[p + ln + ".bias"] = _t(rng, H)
    if head:
        sd["classifier.weight"] = _t(rng, classes, H)
        sd["classifier.bias"] = _t(rng, classes)
    return sd


def save(tmp_path, name, sd, config=None):
    path = tmp_path / name
    torch.save(sd if config is None else {"state_dict": sd,
                                          "config": config}, str(path))
    return str(path)


def bpe_files(tmp_path, limit=VOCAB):
    from kubeflow_tpu_torch.train.bpe_gpt2 import bytes_to_unicode

    vocab = {u: i for i, u in enumerate(bytes_to_unicode().values())
             if i < limit - 1}
    vocab["<|endoftext|>"] = limit - 1
    (tmp_path / "vocab.json").write_text(json.dumps(vocab))
    (tmp_path / "merges.txt").write_text("#version: 0.2\n")
    return str(tmp_path / "vocab.json"), str(tmp_path / "merges.txt")


def assert_same_dir(port_dir, jax_dir):
    """params.npz arrays bit-equal to the JAX dir's params.msgpack arrays,
    the same config.json, the same tokenizer.json if any."""
    with np.load(f"{port_dir}/params.npz") as z:
        got = {k: z[k] for k in z.files}
    want = flatten_tree(flax_msgpack_restore(
        (Path(jax_dir) / "params.msgpack").read_bytes())["params"])
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert got[k].dtype == v.dtype == np.float32, k
        assert got[k].shape == v.shape and np.array_equal(
            got[k].view(np.uint32), v.view(np.uint32)), k
    port_dir, jax_dir = Path(port_dir), Path(jax_dir)
    assert json.loads((port_dir / "config.json").read_text()) == \
        json.loads((jax_dir / "config.json").read_text())
    assert (port_dir / "tokenizer.json").exists() == \
        (jax_dir / "tokenizer.json").exists()
    if (jax_dir / "tokenizer.json").exists():
        assert (port_dir / "tokenizer.json").read_bytes() == \
            (jax_dir / "tokenizer.json").read_bytes()


@pytest.mark.parametrize("kw", [{}, {"max_len": 24, "continuous_rows": 4,
                                     "max_new_tokens": 8}])
def test_import_gpt2_dir_equals_jax(tmp_path, kw):
    ckpt = save(tmp_path, "g.pt", gpt2_state_dict(), {"n_head": HEADS})
    vocab, merges = bpe_files(tmp_path)
    for pkg, out in ((tc, "port"), (jc, "jax")):
        pkg.import_gpt2(ckpt, str(tmp_path / out), vocab_json=vocab,
                        merges_txt=merges, **kw)
    assert_same_dir(tmp_path / "port", tmp_path / "jax")


@pytest.mark.parametrize("tied", [False, True])
def test_import_llama_dir_equals_jax(tmp_path, tied):
    ckpt = save(tmp_path, "l.pt", llama_state_dict(tied=tied),
                {"num_attention_heads": HEADS, "rope_theta": 500.0,
                 "rms_norm_eps": 1e-5, "eos_token_id": [5, 7]})
    for pkg, out in ((tc, "port"), (jc, "jax")):
        pkg.import_llama(ckpt, str(tmp_path / out), max_len=24)
    assert_same_dir(tmp_path / "port", tmp_path / "jax")
    cfg = json.loads((tmp_path / "port" / "config.json").read_text())
    assert cfg["kwargs"]["config"]["num_kv_heads"] == KV_HEADS


@pytest.mark.parametrize("head", [True, False])
def test_import_bert_dir_equals_jax(tmp_path, head):
    ckpt = save(tmp_path, "b.pt", bert_state_dict(head=head))
    for pkg, out in ((tc, "port"), (jc, "jax")):
        pkg.import_bert(ckpt, str(tmp_path / out), num_heads=HEADS,
                        num_classes=None if head else 5)
    assert_same_dir(tmp_path / "port", tmp_path / "jax")


def test_configs_from_hf_equal_jax():
    gpt2 = type("C", (), dict(vocab_size=VOCAB, n_embd=H, n_layer=2,
                              n_head=HEADS, n_positions=POS))()
    bert = type("C", (), dict(vocab_size=VOCAB, hidden_size=H,
                              num_hidden_layers=2, num_attention_heads=HEADS,
                              intermediate_size=4 * H, pad_token_id=0,
                              max_position_embeddings=POS))()
    llama = dict(vocab_size=VOCAB, hidden_size=H, num_hidden_layers=2,
                 num_attention_heads=HEADS, num_key_value_heads=KV_HEADS,
                 intermediate_size=88, max_position_embeddings=64,
                 sliding_window=16, rope_theta=1e4, rms_norm_eps=1e-5)
    for ours, theirs in ((tc.config_from_hf(gpt2, max_len=16),
                          jc.config_from_hf(gpt2, max_len=16)),
                         (tc.bert_config_from_hf(bert),
                          jc.bert_config_from_hf(bert)),
                         (tc.llama_config_from_hf(llama, max_len=32),
                          jc.llama_config_from_hf(llama, max_len=32))):
        for field in ("vocab_size", "hidden_size", "num_layers", "num_heads",
                      "mlp_dim", "max_len", "dropout_rate"):
            assert getattr(ours, field) == getattr(theirs, field), field
        for field in ("num_kv_heads", "rope_theta", "norm_eps", "norm",
                      "activation", "attention_window", "tie_embeddings",
                      "use_bias", "position_embedding", "pad_token_id"):
            if hasattr(theirs, field):
                assert getattr(ours, field) == getattr(theirs, field), field
        assert ours.dtype == "float32"


def _refusals(tmp_path):
    """(name, callable(package)) of each refusal of the JAX importers."""
    g = gpt2_state_dict()
    vocab, merges = bpe_files(tmp_path)
    (tmp_path / "big").mkdir()
    big_vocab, big_merges = bpe_files(tmp_path / "big", limit=4 * VOCAB)
    out = str(tmp_path / "never")
    cases = {
        "gpt2 no heads": lambda p: p.import_gpt2(
            save(tmp_path, "g0.pt", g), out),
        "gpt2 heads do not divide": lambda p: p.import_gpt2(
            save(tmp_path, "g1.pt", g), out, num_heads=5),
        "gpt2 activation": lambda p: p.import_gpt2(
            save(tmp_path, "g2.pt", g, {"n_head": HEADS,
                                        "activation_function": "relu"}),
            out),
        "gpt2 one tokenizer file": lambda p: p.import_gpt2(
            save(tmp_path, "g3.pt", g), out, num_heads=HEADS,
            vocab_json=vocab),
        "gpt2 oversized tokenizer": lambda p: p.import_gpt2(
            save(tmp_path, "g4.pt", g), out, num_heads=HEADS,
            vocab_json=big_vocab, merges_txt=big_merges),
        "not a dict": lambda p: p.import_gpt2(
            save(tmp_path, "g5.pt", [torch.zeros(1)]), out, num_heads=4),
        "config not a dict": lambda p: p.import_gpt2(
            save(tmp_path, "g6.pt", g, config=[1]), out),
        "whole module": lambda p: p.import_gpt2(
            save(tmp_path, "g7.pt", torch.nn.Linear(2, 2)), out,
            num_heads=4),
        "llama not llama": lambda p: p.import_llama(
            save(tmp_path, "l0.pt", g), out, num_heads=HEADS),
        "llama no layers": lambda p: p.import_llama(
            save(tmp_path, "l1.pt", {"model.embed_tokens.weight":
                                     torch.zeros(VOCAB, H)}), out,
            num_heads=HEADS),
        "llama no heads": lambda p: p.import_llama(
            save(tmp_path, "l2.pt", llama_state_dict()), out),
        "llama head_dim": lambda p: p.import_llama(
            save(tmp_path, "l3.pt", llama_state_dict(),
                 {"num_attention_heads": HEADS, "head_dim": 16}), out),
        "llama k_proj rows": lambda p: p.import_llama(
            save(tmp_path, "l4.pt", llama_state_dict()), out, num_heads=32),
        "llama rope scaling": lambda p: p.import_llama(
            save(tmp_path, "l5.pt", llama_state_dict(),
                 {"num_attention_heads": HEADS,
                  "rope_scaling": {"type": "llama3"}}), out),
        "llama activation": lambda p: p.import_llama(
            save(tmp_path, "l6.pt", llama_state_dict(),
                 {"num_attention_heads": HEADS, "hidden_act": "gelu"}), out),
        "llama biases differ": lambda p: p.import_llama(
            save(tmp_path, "l7.pt", llama_state_dict(),
                 {"num_attention_heads": HEADS, "attention_bias": True}),
            out),
        "bert activation": lambda p: p.import_bert(
            save(tmp_path, "b0.pt", bert_state_dict(),
                 {"hidden_act": "relu"}), out, num_heads=HEADS),
        "bert positions": lambda p: p.import_bert(
            save(tmp_path, "b1.pt", bert_state_dict(),
                 {"position_embedding_type": "relative_key"}), out,
            num_heads=HEADS),
        "bert no heads": lambda p: p.import_bert(
            save(tmp_path, "b2.pt", bert_state_dict()), out),
        "bert headless": lambda p: p.import_bert(
            save(tmp_path, "b3.pt", bert_state_dict(head=False)), out,
            num_heads=HEADS),
        "bert head size": lambda p: p.import_bert(
            save(tmp_path, "b4.pt", bert_state_dict()), out,
            num_heads=HEADS, num_classes=4),
        "missing key": lambda p: p.torch_gpt2_to_variables(
            {k: v for k, v in g.items() if "ln_f" not in k},
            p.config_from_hf(type("C", (), dict(
                vocab_size=VOCAB, n_embd=H, n_layer=LAYERS, n_head=HEADS,
                n_positions=POS))())),
    }
    return cases


def test_every_refusal_raises_as_jax(tmp_path):
    cases = _refusals(tmp_path)
    for name, call in cases.items():
        errors = []
        for pkg in (jc, tc):
            with pytest.raises(Exception) as info:
                call(pkg)
            errors.append(info.value)
        assert type(errors[0]) is type(errors[1]), name
        assert isinstance(errors[1], (ValueError, KeyError)), name
        if name != "whole module":  # the text quotes torch's own message
            assert str(errors[0]) == str(errors[1]), name
    assert not (tmp_path / "never").exists()


@pytest.fixture(scope="module")
def hf():
    """transformers, imported without TensorFlow (its models here are
    torch's; the TensorFlow import costs seconds)."""
    patch = pytest.MonkeyPatch()
    patch.setenv("USE_TF", "0")
    try:
        return pytest.importorskip("transformers")
    finally:
        patch.undo()


def jax_logits(family, sd, ids, **kw):
    """The JAX package's model on the JAX converter's variables."""
    import jax.numpy as jnp

    from kubeflow_tpu.models import bert as jb
    from kubeflow_tpu.models import gpt as jg

    if family == "gpt2":
        cfg = jg.GPTConfig(vocab_size=VOCAB, hidden_size=H, num_layers=LAYERS,
                           num_heads=HEADS, mlp_dim=4 * H, max_len=POS,
                           dropout_rate=0.0)
        variables = jc.torch_gpt2_to_variables(sd, cfg)
        model = jg.GPTLM(cfg)
    elif family == "llama":
        cfg = jc.llama_config_from_hf(kw)
        variables = jc.torch_llama_to_variables(sd, cfg)
        model = jg.GPTLM(cfg)
    else:
        cfg = jb.BertConfig(vocab_size=VOCAB, hidden_size=H,
                            num_layers=LAYERS, num_heads=HEADS,
                            mlp_dim=4 * H, max_len=POS, dropout_rate=0.0)
        variables = jc.torch_bert_to_variables(sd, cfg, num_classes=3)
        model = jb.BertForSequenceClassification(cfg, num_classes=3)
    return np.asarray(model.apply(variables, jnp.asarray(ids, jnp.int32)))


def test_hf_gpt2_logits_equal_port_dir(hf, tmp_path):
    """The served dir's logits: the JAX package's model on the same
    checkpoint within 1e-4; transformers' within the JAX package's own
    limit for it (6e-3: the models' LayerNorm eps is 1e-6, GPT-2's
    1e-5)."""
    cfg = hf.GPT2Config(vocab_size=VOCAB, n_positions=POS, n_embd=H,
                        n_layer=LAYERS, n_head=HEADS, resid_pdrop=0.0,
                        embd_pdrop=0.0, attn_pdrop=0.0)
    torch.manual_seed(0)
    m = hf.GPT2LMHeadModel(cfg).eval()
    ckpt = save(tmp_path, "g.pt", m.state_dict(), {"n_head": HEADS})
    tc.import_gpt2(ckpt, str(tmp_path / "d"))
    module, _ = load_generative_model(tmp_path / "d", device="cpu")
    ids = np.random.RandomState(0).randint(1, VOCAB, (2, 12))
    with torch.no_grad():
        want = m(torch.from_numpy(ids)).logits.numpy()
        got = module(torch.from_numpy(ids)).numpy()
    np.testing.assert_allclose(got, jax_logits("gpt2", m.state_dict(), ids),
                               atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(got, want, atol=6e-3, rtol=6e-3)


def test_hf_llama_gqa_logits_equal_port_dir(hf, tmp_path):
    """GQA (4 query heads, 2 KV heads), untied head, rope: the served
    dir's logits within 1e-4 of transformers' and of the JAX package's."""
    fields = dict(vocab_size=VOCAB, hidden_size=H, intermediate_size=88,
                  num_hidden_layers=LAYERS, num_attention_heads=HEADS,
                  num_key_value_heads=KV_HEADS, max_position_embeddings=64,
                  rms_norm_eps=1e-6, tie_word_embeddings=False)
    torch.manual_seed(0)
    m = hf.LlamaForCausalLM(hf.LlamaConfig(**fields)).eval()
    ckpt = save(tmp_path, "l.pt", m.state_dict(),
                {"num_attention_heads": HEADS, "rms_norm_eps": 1e-6})
    tc.import_llama(ckpt, str(tmp_path / "d"))
    module, _ = load_generative_model(tmp_path / "d", device="cpu")
    assert module.cfg.num_kv_heads == KV_HEADS
    ids = np.random.RandomState(1).randint(1, VOCAB, (2, 12))
    with torch.no_grad():
        want = m(torch.from_numpy(ids)).logits.numpy()
        got = module(torch.from_numpy(ids)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(
        got, jax_logits("llama", m.state_dict(), ids, **fields),
        atol=1e-4, rtol=1e-4)


def test_hf_bert_logits_equal_served_dir(hf, tmp_path):
    """The served classifier's logits: the JAX package's model on the same
    checkpoint within 1e-4; transformers' within the JAX package's limit
    (6e-3: LayerNorm eps 1e-6 against BERT's 1e-12), same classes."""
    cfg = hf.BertConfig(vocab_size=VOCAB, hidden_size=H, num_hidden_layers=2,
                        num_attention_heads=HEADS, intermediate_size=4 * H,
                        max_position_embeddings=POS, hidden_dropout_prob=0.0,
                        attention_probs_dropout_prob=0.0, num_labels=3)
    torch.manual_seed(0)
    m = hf.BertForSequenceClassification(cfg).eval()
    ckpt = save(tmp_path, "b.pt", m.state_dict())
    tc.import_bert(ckpt, str(tmp_path / "d"), num_heads=HEADS)
    served = TorchModel("bert", tmp_path / "d", device="cpu")
    served.load()
    ids = np.random.RandomState(2).randint(1, VOCAB, (2, 16))
    with torch.no_grad():
        want = m(torch.from_numpy(ids)).logits.numpy()
    got = np.asarray(served(ids)["logits"], np.float32)
    np.testing.assert_allclose(got, jax_logits("bert", m.state_dict(), ids),
                               atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(got, want, atol=6e-3, rtol=6e-3)
    assert got.argmax(-1).tolist() == want.argmax(-1).tolist()
