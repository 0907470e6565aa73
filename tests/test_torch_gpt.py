"""The port's GPT family against the JAX package's.

Weights and inputs come from a numpy seed; the weights go to the JAX
package in its flax layout and to the port through
``kubeflow_tpu_torch.convert``. Both sides run
f32 on the CPU. Logits agree to atol=rtol=1e-4: the two sides order their
matmul sums differently and compute the LayerNorm variance by different
formulas (flax: E[x²] − E[x]²), which moves f32 logits by ~1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from kubeflow_tpu.models import gpt as jg
from kubeflow_tpu.parallel.rope import apply_rope as jax_rope
from kubeflow_tpu_torch.convert import (
    flax_params_from_gpt,
    gpt_params_from_flax,
)
from kubeflow_tpu_torch.models import gpt as tg
from kubeflow_tpu_torch.parallel.rope import apply_rope as torch_rope

try:  # one intra-op thread: the suite shares the machine with timing gates
    torch.set_num_threads(1)
    torch.set_num_interop_threads(1)
except RuntimeError:  # the interop pool can be sized once per process
    pass

TOL = dict(atol=1e-4, rtol=1e-4)
CONFIGS = {  # name -> config kwargs shared by both sides
    "tiny_flash": ("tiny", dict(attention="flash", attention_block=8)),
    "tiny_dense": ("tiny", {}),
    "llama_dense": ("llama", {}),
}


def configs(name):
    size, kw = CONFIGS[name]
    return getattr(jg.GPTConfig, size)(**kw), getattr(tg.GPTConfig, size)(**kw)


def seeded_params(tcfg, seed=1):
    """Flax-layout params drawn from a numpy seed: N(0, 0.2) weights and
    biases, scales 1 + N(0, 0.1) — nonzero biases and non-unit scales, so
    the converter's mapping of every tensor shows in the logits."""
    template = flax_params_from_gpt(
        tg.GPTLM(tcfg, device="cpu").state_dict(), tcfg)
    rng = np.random.RandomState(seed)
    flat = {}
    for k in sorted(template):
        shape = template[k].shape
        flat[k] = (1.0 + 0.1 * rng.normal(size=shape) if k.endswith("/scale")
                   else 0.2 * rng.normal(size=shape)).astype(np.float32)
    return flat


def jax_variables(flat):
    return {"params": traverse_util.unflatten_dict(
        {k: jnp.asarray(v) for k, v in flat.items()}, sep="/")}


def jax_generate(jcfg, variables, prompt):
    run = jax.jit(lambda v, p: jg.generate(jg.GPTLM(jcfg), v, p, 8))
    return run(variables, jnp.asarray(prompt))


def torch_model(tcfg, flat):
    m = tg.GPTLM(tcfg, device="cpu")
    m.load_state_dict(gpt_params_from_flax(flat, tcfg))
    return m.eval()


def step_logits(model, prompt, toks):
    """Per-step logits of greedy decoding, teacher-forced on `toks`."""
    with torch.inference_mode():
        cache = model.init_cache(prompt.shape[0])
        steps = [model(prompt, cache=cache, prefill=True)[:, -1]]
        for t in range(toks.shape[1] - 1):
            steps.append(model(toks[:, t:t + 1], cache=cache)[:, 0])
    return torch.stack(steps, dim=1)


@pytest.mark.parametrize("kw,msg", [
    (dict(hidden_size=66), "not divisible by num_heads"),
    (dict(num_kv_heads=3), "positive divisor"),
    (dict(position_embedding="alibi"), "learned|rope"),
    (dict(position_embedding="rope", hidden_size=12, num_heads=4),
     "even head_dim"),
    (dict(attention_window=-1), "must be >= 1"),
    (dict(attention_window=4, attention="sparse"), "composes with"),
    (dict(kv_cache_capacity=8), "requires attention_window"),
    (dict(kv_cache_capacity=8, attention_window=16), "evicted"),
    (dict(kv_cache_capacity=256, attention_window=16), ">= max_len"),
    (dict(moe_experts=2, moe_top_k=3), "moe_top_k 3 > moe_experts 2"),
    (dict(norm="batchnorm"), "layernorm|rmsnorm"),
    (dict(activation="relu"), "gelu|swiglu"),
])
def test_config_validation_matches_jax(kw, msg):
    with pytest.raises(ValueError, match=msg) as jax_err:
        jg.GPTConfig.tiny(**kw)
    with pytest.raises(ValueError, match=msg) as torch_err:
        tg.GPTConfig.tiny(**kw)
    assert str(torch_err.value) == str(jax_err.value)


def test_port_only_refusals():
    with pytest.raises(ValueError, match="dtype"):
        tg.GPTConfig.tiny(dtype="float16")
    # the MoE decoder builds (tests/test_torch_moe.py); ring and Ulysses
    # build and shard the sequence over an entered context axis
    # (tests/test_torch_context.py), where dense and flash attention are
    # refused
    from kubeflow_tpu_torch.parallel import ring_attention as tra
    from kubeflow_tpu_torch.parallel.mesh import ContextAxis, context_axis

    assert tg.GPTLM(tg.GPTConfig.tiny(moe_experts=2), device="cpu").layers[
        0].moe.num_experts == 2
    for kind in ("ring", "ulysses"):
        model = tg.GPTLM(tg.GPTConfig.tiny(attention=kind), device="cpu")
        assert model.shards_sequence
        assert model.layers[0].attention.attn_fn is getattr(
            tra, f"{kind}_attention")
    for kind in ("dense", "flash"):
        model = tg.GPTLM(tg.GPTConfig.tiny(attention=kind), device="cpu")
        assert not model.shards_sequence
        with context_axis(ContextAxis(0, 2, None, (0, 1))), \
                pytest.raises(NotImplementedError, match="ring and ulysses"):
            model(torch.ones((1, 4), dtype=torch.long))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tg.GPTLM(tg.GPTConfig.tiny())  # entry points default to the card


@pytest.mark.parametrize("pos_shape", [(12,), (2, 12)])
def test_rope_matches_jax(pos_shape):
    rng = np.random.RandomState(3)
    x = rng.normal(size=(2, 12, 4, 16)).astype(np.float32)
    pos = rng.randint(0, 200, pos_shape).astype(np.int32)
    want = jax_rope(jnp.asarray(x), jnp.asarray(pos), 10000.0)
    got = torch_rope(torch.from_numpy(x), torch.from_numpy(pos), 10000.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_logits_match_jax(name):
    jcfg, tcfg = configs(name)
    flat = seeded_params(tcfg)
    variables = jax_variables(flat)
    rng = np.random.RandomState(0)
    ids = rng.randint(1, jcfg.vocab_size, (2, 16)).astype(np.int32)
    ids[1, -3:] = 0  # a right-padded row
    want = np.asarray(jax.jit(jg.GPTLM(jcfg).apply)(variables,
                                                     jnp.asarray(ids)))
    with torch.inference_mode():
        got = torch_model(tcfg, flat)(torch.from_numpy(ids)).numpy()
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("name", ["tiny_flash", "tiny_dense"])
def test_greedy_generate_token_identical(name):
    jcfg, tcfg = configs(name)
    flat = seeded_params(tcfg)
    variables = jax_variables(flat)
    prompt = np.random.RandomState(5).randint(
        1, jcfg.vocab_size, (2, 6)).astype(np.int32)
    want = np.asarray(jax_generate(jcfg, variables, prompt))
    model = torch_model(tcfg, flat)
    got = tg.generate(model, torch.from_numpy(prompt), max_new_tokens=8)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    # the comparison is meaningful: every step's top-2 logit margin is wider
    # than the logits tolerance, so no near-tie decided the tokens
    top2 = step_logits(model, torch.from_numpy(prompt),
                       got.long()).topk(2, dim=-1).values
    margin = (top2[..., 0] - top2[..., 1]).min().item()
    assert margin > TOL["atol"], margin


def test_generate_eos_clamp():
    _, tcfg = configs("tiny_dense")
    model = torch_model(tcfg, seeded_params(tcfg))
    prompt = torch.from_numpy(np.random.RandomState(5).randint(
        1, tcfg.vocab_size, (2, 6)).astype(np.int32))
    greedy = tg.generate(model, prompt, 8)
    eos = [int(greedy[0, 2]), 1]  # a stop list: row 0 stops at step 2
    got = tg.generate(model, prompt, 8, eos_token_id=eos)
    want = greedy.clone()
    for row in range(2):
        hits = torch.isin(greedy[row].long(), torch.tensor(eos)).nonzero()
        if len(hits):  # every position after the first stop is eos[0]
            want[row, int(hits[0]) + 1:] = eos[0]
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    assert (got[0, 2:] == eos[0]).all()


def test_sampling_paths():
    _, tcfg = configs("tiny_dense")
    model = tg.GPTLM(tcfg, device="cpu").init_weights(
        torch.Generator().manual_seed(0))
    prompt = torch.from_numpy(np.random.RandomState(2).randint(
        1, tcfg.vocab_size, (2, 5)).astype(np.int32))
    greedy = tg.generate(model, prompt, 6)
    top1 = tg.generate(model, prompt, 6, temperature=0.7, top_k=1,
                       generator=torch.Generator().manual_seed(9))
    np.testing.assert_array_equal(top1.numpy(), greedy.numpy())
    with pytest.raises(ValueError, match="needs a generator"):
        tg.generate(model, prompt, 2, temperature=1.0)
    with pytest.raises(ValueError, match="exceeds max_len"):
        tg.generate(model, prompt, tcfg.max_len)


@pytest.mark.parametrize("name", ["tiny_dense", "llama_dense"])
def test_convert_round_trips(name):
    _, tcfg = configs(name)
    flat = seeded_params(tcfg)
    back = flax_params_from_gpt(torch_model(tcfg, flat).state_dict(), tcfg)
    assert set(back) == set(flat)
    for k in flat:
        np.testing.assert_array_equal(back[k], flat[k], err_msg=k)
    with pytest.raises(KeyError, match="missing"):
        gpt_params_from_flax({k: v for k, v in flat.items()
                              if "layer_1" not in k}, tcfg)
    with pytest.raises(ValueError, match="shape"):
        gpt_params_from_flax({**flat, "ln_final/scale": flat[
            "ln_final/scale"][:-1]}, tcfg)
