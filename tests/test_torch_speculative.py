"""The port's speculative decoding against the JAX package's.

Tiny GPT targets and drafts are initialized by the JAX package (``init``
from a seed) and handed to the port through ``kubeflow_tpu_torch.convert``;
the JAX side runs ``kubeflow_tpu.models.speculative.speculative_generate``
and ``generate`` jitted on the CPU, as tests/test_speculative.py runs them,
and the port runs ``kubeflow_tpu_torch.models.speculative`` on CPU tensors
(``attention="flash"``: both prompts prefill through the flash path's plain
version). Both sides run f32. Greedy tokens and the round counts must be
identical. Sampled draws cannot match ``jax.random``, so sampling is held by
its invariants (a self-draft accepts every proposal; a seed repeats) and by
its output distribution (total variation against the target's exact
next-token distributions).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from kubeflow_tpu.models import gpt as jg
from kubeflow_tpu.models.speculative import (
    speculative_generate as jax_speculative_generate,
)
from kubeflow_tpu_torch.convert import gpt_params_from_flax
from kubeflow_tpu_torch.models import gpt as tg
from kubeflow_tpu_torch.models.speculative import speculative_generate

try:  # one intra-op thread: the suite shares the machine with timing gates
    torch.set_num_threads(1)
    torch.set_num_interop_threads(1)
except RuntimeError:  # the interop pool can be sized once per process
    pass

DRAFT = dict(hidden_size=32, num_heads=2, mlp_dim=64, num_layers=1)


def pair(seed, prompt, **kw):
    """(jax module, jax variables, port module) of one tiny GPT config,
    initialized by the JAX package from `seed`; the port's copy computes
    with the flash path."""
    jmodel = jg.GPTLM(jg.GPTConfig.tiny(dropout_rate=0.0, **kw),
                      pad_token_id=-1)
    variables = jax.jit(jmodel.init)(jax.random.PRNGKey(seed),
                                     jnp.asarray(prompt))
    flat = {k: np.asarray(v) for k, v in traverse_util.flatten_dict(
        variables["params"], sep="/").items()}
    tcfg = tg.GPTConfig.tiny(attention="flash", attention_block=8, **kw)
    tmodel = tg.GPTLM(tcfg, device="cpu")
    tmodel.load_state_dict(gpt_params_from_flax(flat, tcfg))
    return jmodel, variables, tmodel.eval()


PROMPT = np.asarray(jax.random.randint(jax.random.PRNGKey(1), (1, 5), 1,
                                       512, jnp.int32))


@pytest.fixture(scope="module")
def target():
    return pair(0, PROMPT, max_len=96)


@pytest.fixture(scope="module")
def drafts():
    return {s: pair(s, np.ones((1, 4), np.int32), max_len=96, **DRAFT)
            for s in (7, 8)}


@pytest.fixture(scope="module")
def greedy20(target):
    """The JAX package's greedy decode of PROMPT, 20 tokens."""
    jm, jv, _ = target
    return jax_generate(jm, jv, PROMPT, 20)


def port_prompt(p=PROMPT):
    return torch.tensor(np.asarray(p), dtype=torch.long)


def jax_generate(jmodel, variables, prompt, n, **kw):
    """The JAX package's greedy generate, jitted (eager JAX dispatches op
    by op on the CPU)."""
    return np.asarray(jax.jit(lambda v, x: jg.generate(
        jmodel, v, x, max_new_tokens=n, **kw))(variables,
                                               jnp.asarray(prompt)))


def jax_spec(target, draft, variables, n, **kw):
    """The JAX package's speculative_generate, jitted: (tokens, stats)."""
    out, stats = jax.jit(lambda tv, dv, x: jax_speculative_generate(
        target, tv, draft, dv, x, max_new_tokens=n, **kw))(
            *variables, jnp.asarray(PROMPT))
    return np.asarray(out), {k: int(v) for k, v in stats.items()}


# ------------------------------------------------------------- exactness


def test_random_draft_matches_jax_speculative_and_generate(target, drafts,
                                                           greedy20):
    """ANY draft (an untrained 1-layer net) gives exactly the target's
    greedy decode; with draft 7 also the JAX package's speculative tokens
    and its round counts."""
    jm, jv, tm = target
    for seed, (dj, dv, dt) in drafts.items():
        got, stats = speculative_generate(tm, dt, port_prompt(), 20, gamma=3)
        np.testing.assert_array_equal(got.numpy(), greedy20)
        assert got.dtype == torch.int32 and got.shape == (1, 20)
        if seed == 7:
            jgot, jstats = jax_spec(jm, dj, (jv, dv), 20, gamma=3)
            np.testing.assert_array_equal(got.numpy(), jgot)
            assert stats == jstats


def test_self_draft_accepts_everything(target, greedy20):
    """Draft == target: every proposal accepted, so N tokens take
    ceil((N-1)/(gamma+1)) rounds after the free first token — the JAX
    package's counts exactly."""
    jm, jv, tm = target
    n, gamma = 20, 3
    jgot, jstats = jax_spec(jm, jm, (jv, jv), n, gamma=gamma)
    got, stats = speculative_generate(tm, tm, port_prompt(), n, gamma=gamma)
    np.testing.assert_array_equal(got.numpy(), jgot)
    np.testing.assert_array_equal(got.numpy(), greedy20)
    assert stats == jstats
    assert stats["rounds"] == math.ceil((n - 1) / (gamma + 1))
    assert stats["drafted_accepted"] == stats["rounds"] * gamma


def test_gqa_rope_target_with_plain_draft(drafts):
    prompt = np.array([[3, 1, 4]], np.int32)
    jm, jv, tm = pair(2, prompt, max_len=96, num_kv_heads=2,
                      position_embedding="rope")
    got, _ = speculative_generate(tm, drafts[8][2], port_prompt(prompt), 12,
                                  gamma=4)
    np.testing.assert_array_equal(got.numpy(),
                                  jax_generate(jm, jv, prompt, 12))


def test_eos_early_stop_matches_generate(target, drafts, greedy20):
    """With eos_token_id the output equals generate(..., eos_token_id) —
    clamped after the first stop id — and the loop stops speculating once
    it lands: fewer rounds than the run without it."""
    jm, jv, tm = target
    dt = drafts[7][2]
    n = 20
    eos = int(greedy20[0, 6])
    want = jax_generate(jm, jv, PROMPT, n, eos_token_id=eos)
    got, stats = speculative_generate(tm, dt, port_prompt(), n, gamma=3,
                                      eos_token_id=eos)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (got.numpy()[0] == eos).sum() > 1    # clamped after the stop
    _, plain = speculative_generate(tm, dt, port_prompt(), n, gamma=3)
    assert stats["rounds"] < plain["rounds"]


def test_prompts_take_flash_and_verify_blocks_do_not(target, drafts):
    """Both models prefill the prompt from index 0 through the flash path
    (once per layer, at the prompt's length); the draft steps and the
    gamma+1 verify blocks sit past index 0 and never reach it."""
    tm, dt = target[2], drafts[7][2]
    calls = []
    saved = []
    for name, model in (("target", tm), ("draft", dt)):
        for i, blk in enumerate(model.layers):
            fn = blk.attention.attn_fn
            saved.append((blk, fn))

            def spy(q, *a, _fn=fn, _tag=(name, i), **kw):
                calls.append(_tag + (q.shape[1],))
                return _fn(q, *a, **kw)
            blk.attention.attn_fn = spy
    try:
        speculative_generate(tm, dt, port_prompt(), 12, gamma=3)
    finally:
        for blk, fn in saved:
            blk.attention.attn_fn = fn
    assert calls == [("target", i, 5) for i in range(2)] + [("draft", 0, 5)]


# -------------------------------------------------------------- guards


@pytest.mark.parametrize("case", [
    "batch", "gamma", "budget", "max_new_tokens", "generator", "rolling"])
def test_guards(target, drafts, case):
    tm, dt = target[2], drafts[7][2]
    p = port_prompt()
    if case == "batch":
        with pytest.raises(ValueError, match="batch-1"):
            speculative_generate(tm, dt, p.repeat(2, 1), 8)
    elif case == "gamma":
        with pytest.raises(ValueError, match="gamma"):
            speculative_generate(tm, dt, p, 8, gamma=0)
    elif case == "budget":
        # 5 + 87 + 5 > 96: the gamma+1 slack counts on both models
        with pytest.raises(ValueError, match="max_len"):
            speculative_generate(tm, dt, p, 87, gamma=4)
        assert speculative_generate(tm, dt, p, 87, gamma=3)[0].shape \
            == (1, 87)
    elif case == "max_new_tokens":
        with pytest.raises(ValueError, match="max_new_tokens"):
            speculative_generate(tm, dt, p, 0)
    elif case == "generator":
        with pytest.raises(ValueError, match="needs a generator"):
            speculative_generate(tm, dt, p, 8, temperature=1.0)
    else:
        rolling = tg.GPTLM(tg.GPTConfig.tiny(
            max_len=96, attention_window=8, kv_cache_capacity=24),
            device="cpu")
        with pytest.raises(ValueError, match="rolling"):
            speculative_generate(rolling, dt, p, 8)
        with pytest.raises(ValueError, match="rolling"):
            speculative_generate(tm, rolling, p, 8)


# ------------------------------------------------------------ sampling


def test_sampling_self_draft_accepts_every_proposal(target):
    """p_t == p_d makes the acceptance ratio exactly 1: every proposal is
    accepted whatever the uniforms."""
    tm = target[2]
    out, stats = speculative_generate(
        tm, tm, port_prompt(), 12, gamma=3, temperature=1.0,
        generator=torch.Generator().manual_seed(4))
    assert stats["drafted_accepted"] == 3 * stats["rounds"]
    assert out.shape == (1, 12)


def test_sampling_deterministic_per_generator_seed(target, drafts):
    tm, dt = target[2], drafts[8][2]

    def run(seed):
        return speculative_generate(
            tm, dt, port_prompt(), 10, gamma=2, temperature=0.8,
            generator=torch.Generator().manual_seed(seed))[0].numpy()

    a = run(5)
    np.testing.assert_array_equal(a, run(5))
    assert not np.array_equal(a, run(6))
    # greedy ignores a generator it is given
    greedy, _ = speculative_generate(tm, dt, port_prompt(), 10, gamma=2)
    with_gen, _ = speculative_generate(
        tm, dt, port_prompt(), 10, gamma=2,
        generator=torch.Generator().manual_seed(99))
    np.testing.assert_array_equal(greedy.numpy(), with_gen.numpy())


def test_output_distribution_matches_direct_target_sampling():
    """The first two emitted tokens of N=800 speculative samples through a
    DIFFERENT random draft against the target's exact distributions
    (8-token vocab): the first token's softmax, and the second token's
    marginal summed over the first. One-sided against the exact law, the
    sampling noise (~0.04 TV) matches the JAX test's two-sample check at
    N=1500 each; a wrong acceptance ratio or residual shifts TV far
    beyond it."""
    cfg = tg.GPTConfig.tiny(max_len=32, vocab_size=8, hidden_size=16,
                            num_heads=2, mlp_dim=32, num_layers=1,
                            attention="flash", attention_block=8)
    tm, dt = (tg.GPTLM(cfg, device="cpu").init_weights(
        torch.Generator().manual_seed(s), std=0.5).eval() for s in (10, 11))
    x = port_prompt(np.array([[3, 5, 1]]))
    with torch.inference_mode():  # the cache path: no pad-id masking
        p1 = torch.softmax(tm(x, cache=tm.init_cache(1))[0, -1], -1)
        nxt = torch.cat([x.repeat(8, 1), torch.arange(8)[:, None]], 1)
        p2 = (p1[:, None] * torch.softmax(
            tm(nxt, cache=tm.init_cache(8))[:, -1], -1)).sum(0)
    n = 800
    gen = torch.Generator().manual_seed(12)
    spec = np.stack([speculative_generate(
        tm, dt, x, 2, gamma=2, temperature=1.0, generator=gen)[0][0].numpy()
        for _ in range(n)])
    for pos, exact in ((0, p1), (1, p2)):
        hist = np.bincount(spec[:, pos], minlength=8) / n
        tv = 0.5 * np.abs(hist - exact.numpy()).sum()
        assert tv < 0.08, (pos, tv, hist, exact)
