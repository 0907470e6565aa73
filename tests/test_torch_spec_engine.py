"""The port's speculative continuous-batching engine against the JAX
package's.

A tiny GPT target is initialized by the JAX package (``init`` from a seed)
and handed to the port through ``kubeflow_tpu_torch.convert``; its draft
has the same shape and the target's weights with 10% seeded noise, so rows
accept 0 to gamma proposals and diverge in depth from round to round. The
JAX engine (``kubeflow_tpu.serving.continuous.ContinuousBatcher`` with
``draft_module``) runs jitted on the CPU, as tests/test_continuous.py runs
it; the port's engine runs on CPU tensors (``attention="flash"``). Both
sides run f32: greedy tokens, dispatch counts, pool digests, pool metrics
and the prefill ledger must be identical. Sampled rows cannot match
``jax.random`` draw for draw; they are held by their invariants and by the
distribution of their tokens (total variation against the target's exact
law, N=400, TV < 0.12 as the JAX test's check).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from kubeflow_tpu.models import gpt as jg
from kubeflow_tpu.serving.continuous import ContinuousBatcher as JaxBatcher
from kubeflow_tpu.serving.fleet.pagedkv import PagedKVPool as JaxPool
from kubeflow_tpu_torch.convert import gpt_params_from_flax
from kubeflow_tpu_torch.models import gpt as tg
from kubeflow_tpu_torch.models.speculative import speculative_generate
from kubeflow_tpu_torch.serving.continuous import ContinuousBatcher
from kubeflow_tpu_torch.serving.fleet import PagedKVPool
from kubeflow_tpu_torch.tracing import Tracer

try:  # one intra-op thread: the suite shares the machine with timing gates
    torch.set_num_threads(1)
    torch.set_num_interop_threads(1)
except RuntimeError:  # the interop pool can be sized once per process
    pass

KV_ATOL = 1e-5
# (seed, prompt length, budget): two prompt lengths keep the JAX engine's
# compiles few; budgets differ, so rows sit at different depths and the
# later ones admit while earlier rows are mid-flight
JOBS = ((1, 4, 12), (2, 6, 20), (3, 4, 6), (4, 6, 16), (5, 4, 24),
        (6, 6, 9))


def prompt(seed, n, vocab=512):
    return np.random.RandomState(seed).randint(1, vocab, n).astype(np.int32)


def from_flat(flat, **kw):
    """(jax module, jax variables, port module) holding the flax-layout
    params `flat` of one tiny config."""
    jmodel = jg.GPTLM(jg.GPTConfig.tiny(dropout_rate=0.0, **kw),
                      pad_token_id=-1)
    variables = {"params": traverse_util.unflatten_dict(
        {k: jnp.asarray(v) for k, v in flat.items()}, sep="/")}
    tcfg = tg.GPTConfig.tiny(attention="flash", attention_block=8, **kw)
    tmodel = tg.GPTLM(tcfg, device="cpu")
    tmodel.load_state_dict(gpt_params_from_flax(flat, tcfg))
    return jmodel, variables, tmodel.eval()


def init_flat(seed, **kw):
    """The flax-layout params the JAX package's init draws from `seed`."""
    jmodel = jg.GPTLM(jg.GPTConfig.tiny(dropout_rate=0.0, **kw),
                      pad_token_id=-1)
    variables = jax.jit(jmodel.init)(jax.random.PRNGKey(seed),
                                     jnp.ones((1, 5), jnp.int32))
    return {k: np.asarray(v) for k, v in traverse_util.flatten_dict(
        variables["params"], sep="/").items()}


@pytest.fixture(scope="module")
def spec():
    """(target pair, draft pair): the draft is the target plus noise of a
    tenth of each weight's spread (norm scales and zero biases stay)."""
    flat = init_flat(0, max_len=96)
    rng = np.random.RandomState(3)
    noisy = {k: (v + 0.1 * v.std() * rng.standard_normal(v.shape)
                 ).astype(np.float32) for k, v in sorted(flat.items())}
    return from_flat(flat, max_len=96), from_flat(noisy, max_len=96)


def run(eng, jobs, **kw):
    reqs = [eng.submit(p, max_new_tokens=b, **kw) for p, b in jobs]
    eng.run_until_idle()
    return [r.result(timeout=1) for r in reqs]


def solo(model, p, budget, **kw):
    return tg.generate(model, torch.as_tensor(p[None], dtype=torch.long),
                       budget, **kw)[0].numpy()


@pytest.fixture(scope="module")
def jobs():
    return [(prompt(s, n), b) for s, n, b in JOBS]


@pytest.fixture(scope="module")
def jax_spec(spec, jobs):
    """The JAX speculative engine over JOBS: (tokens, step_count)."""
    (jm, jv, _), (_, dv, _) = spec
    eng = JaxBatcher(jm, jv, max_rows=3, draft_module=jm,
                     draft_variables=dv, gamma=3)
    return run(eng, jobs), eng.step_count


def port_spec(spec, **kw):
    (_, _, tm), (_, _, dm) = spec
    return ContinuousBatcher(tm, draft_module=dm, **kw)


# ------------------------------------------------------------- exactness


def test_rows_match_jax_engine_solo_speculative_and_greedy(spec, jobs,
                                                           jax_spec):
    """Every row of a mixed spec batch equals the JAX speculative engine's
    row, the port's solo speculative_generate and plain greedy generate,
    with rows at different depths mid-flight; and the dispatches are the
    JAX engine's."""
    (_, _, tm), (_, _, dm) = spec
    eng = port_spec(spec, max_rows=3, gamma=3)
    got = run(eng, jobs)
    want, jax_steps = jax_spec
    for (p, b), out, ref in zip(jobs, got, want):
        np.testing.assert_array_equal(out, ref)
        np.testing.assert_array_equal(out, solo(tm, p, b))
        one, _ = speculative_generate(
            tm, dm, torch.as_tensor(p[None], dtype=torch.long), b, gamma=3)
        np.testing.assert_array_equal(out, one[0].numpy())
    assert eng.step_count == jax_steps
    # the noisy draft: some proposals accepted, not all
    assert 0 < eng.spec_accepted < eng.spec_proposed


def test_dispatch_count_drops_vs_plain_engine(spec):
    """Self-draft (perfect agreement): every round emits gamma+1 tokens a
    row, so the spec engine needs a third of the plain engine's
    dispatches — the JAX engine's count exactly."""
    (jm, jv, tm), _ = spec
    prompts = [(prompt(10 + s, 5), 16) for s in range(4)]
    plain = ContinuousBatcher(tm, max_rows=2)
    run(plain, prompts)
    eng = ContinuousBatcher(tm, max_rows=2, draft_module=tm, gamma=3)
    for (p, b), out in zip(prompts, run(eng, prompts)):
        np.testing.assert_array_equal(out, solo(tm, p, b))
    jeng = JaxBatcher(jm, jv, max_rows=2, draft_module=jm,
                      draft_variables=jv, gamma=3)
    run(jeng, prompts)
    assert eng.step_count == jeng.step_count
    assert eng.step_count * 3 <= plain.step_count, (eng.step_count,
                                                    plain.step_count)
    # the acceptance counters: every proposal of every in-flight row
    assert eng.spec_accepted == eng.spec_proposed > 0


def test_spec_refusals(spec):
    (_, _, tm), (_, _, dm) = spec
    with pytest.raises(ValueError, match="steps_per_tick"):
        ContinuousBatcher(tm, max_rows=2, steps_per_tick=4, draft_module=dm)
    with pytest.raises(ValueError, match="prefill_buckets"):
        ContinuousBatcher(tm, max_rows=2, prefill_buckets=(16,),
                          draft_module=dm)
    with pytest.raises(ValueError, match="gamma"):
        ContinuousBatcher(tm, max_rows=2, draft_module=dm, gamma=0)
    eng = ContinuousBatcher(tm, max_rows=2, draft_module=dm, gamma=8)
    with pytest.raises(ValueError, match="gamma"):
        eng.submit(prompt(1, 5), max_new_tokens=85)  # 5 + 85 + 9 > 96
    small = tg.GPTLM(tg.GPTConfig.tiny(max_len=96, vocab_size=256),
                     device="cpu")
    with pytest.raises(ValueError, match="vocabulary"):
        ContinuousBatcher(tm, draft_module=small)
    rolling = tg.GPTLM(tg.GPTConfig.tiny(max_len=96, attention_window=8,
                                         kv_cache_capacity=24),
                       device="cpu")
    with pytest.raises(ValueError, match="rolling"):
        ContinuousBatcher(rolling, max_rows=2, draft_module=rolling)
    with pytest.raises(ValueError, match="rolling"):
        ContinuousBatcher(tm, max_rows=2, draft_module=rolling)


def test_top_k_refused_only_for_sampled_submit(spec):
    """Engine top_k with a draft still constructs and serves greedy
    traffic; the refusal fires at submit() for sampled rows only."""
    tm = spec[0][2]
    eng = port_spec(spec, max_rows=2, top_k=5)
    req = eng.submit(prompt(6, 4), max_new_tokens=6)
    with pytest.raises(ValueError, match="top_k"):
        eng.submit(prompt(7, 4), max_new_tokens=6, temperature=0.7)
    eng.run_until_idle()
    np.testing.assert_array_equal(req.result(timeout=1),
                                  solo(tm, prompt(6, 4), 6))


def test_eos_mid_round_retires_exactly(spec):
    """EOS landing inside an accepted block stops the row AT the eos token,
    matching generate(..., eos)'s trimmed output."""
    tm = spec[0][2]
    p = prompt(7, 5)
    plain = solo(tm, p, 16)
    eos = int(plain[4])
    first = int(np.argmax(plain == eos))
    eng = port_spec(spec, max_rows=2, eos_token_id=eos, gamma=3)
    out = run(eng, [(p, 16)])[0]
    assert out[-1] == eos and len(out) == first + 1
    np.testing.assert_array_equal(out, plain[:first + 1])


def test_predictor_with_continuous_draft_dir(spec, tmp_path):
    """{continuous: true, continuous_draft_dir: <relative>} serves through
    the speculative engine; outputs equal the plain greedy decode."""
    from kubeflow_tpu_torch.serving.model import TorchModel, save_predictor

    (_, _, tm), (_, _, dm) = spec
    cfg = {"max_len": 96}
    save_predictor(tmp_path / "gpt-spec" / "draft", "gpt-lm",
                   dm.state_dict(), np.zeros((1, 6), np.int32),
                   generate={"max_new_tokens": 8}, size="tiny", config=cfg)
    d = save_predictor(
        tmp_path / "gpt-spec", "gpt-lm", tm.state_dict(),
        np.zeros((1, 6), np.int32),
        generate={"max_new_tokens": 8, "continuous": True,
                  "continuous_rows": 2, "continuous_draft_dir": "draft",
                  "speculative_gamma": 3},
        size="tiny", config=cfg)
    m = TorchModel("gpt-spec", d, device="cpu")
    m.load()
    try:
        assert m._engine.draft_module is not None and m._engine.gamma == 3
        p = prompt(77, 6)[None]
        got = np.asarray(m(p)["predictions"])
        np.testing.assert_array_equal(got[0], solo(tm, p[0], 8))
    finally:
        m.close()


# -------------------------------------------------------------- sampling


def test_self_draft_sampled_rows_accept_everything(spec):
    """p_d == p_t makes the acceptance ratio exactly 1: 12 tokens take the
    first token plus ceil(11/4) = 3 spec rounds."""
    tm = spec[0][2]
    eng = ContinuousBatcher(tm, max_rows=2, draft_module=tm, gamma=3)
    out = run(eng, [(prompt(1, 5), 12)], temperature=1.0)[0]
    assert len(out) == 12 and eng.step_count <= 3


def test_greedy_rows_stay_exact_when_mixed_with_sampled(spec, jobs,
                                                         jax_spec):
    """Greedy rows beside a sampled row keep the JAX engine's tokens, and
    an all-greedy batch draws nothing (no softmax, no generator)."""
    eng = port_spec(spec, max_rows=3, gamma=3)
    greedy = [eng.submit(p, max_new_tokens=b) for p, b in jobs[:2]]
    sampled = eng.submit(prompt(2, 6), max_new_tokens=15, temperature=0.9)
    eng.run_until_idle()
    for r, want in zip(greedy, jax_spec[0]):
        np.testing.assert_array_equal(r.result(timeout=1), want)
    assert len(sampled.result(timeout=1)) == 15
    eng = port_spec(spec, max_rows=3, gamma=3)

    def no_draws(*a, **kw):
        raise AssertionError("an all-greedy batch drew a sample")

    eng._draws = no_draws
    for out, want in zip(run(eng, jobs[:2]), jax_spec[0]):
        np.testing.assert_array_equal(out, want)


def test_sampled_rows_deterministic_per_key(spec, jobs):
    """A sampled row's tokens depend on its key alone: not on the rows
    beside it; another key differs."""
    def sampled(key, mixed=False):
        eng = port_spec(spec, max_rows=3, gamma=2)
        if mixed:
            for p, b in jobs[:2]:
                eng.submit(p, max_new_tokens=b)
        r = eng.submit(prompt(4, 5), max_new_tokens=10, temperature=0.8,
                       key=key)
        eng.run_until_idle()
        return r.result(timeout=1)

    a = sampled(7)
    np.testing.assert_array_equal(a, sampled(7))
    np.testing.assert_array_equal(a, sampled(7, mixed=True))
    assert not np.array_equal(a, sampled(8))


def test_sampled_row_distribution_matches_direct_sampling():
    """The first two tokens of N=400 sampled spec requests through one
    engine (rows recycle; per-request keys), with a mismatched draft,
    against the target's exact laws: the first token's softmax and the
    second token's marginal."""
    cfg = tg.GPTConfig.tiny(max_len=32, vocab_size=8, hidden_size=16,
                            num_heads=2, mlp_dim=32, num_layers=1,
                            attention="flash", attention_block=8)
    tm, dm = (tg.GPTLM(cfg, device="cpu").init_weights(
        torch.Generator().manual_seed(s), std=0.5).eval() for s in (10, 11))
    p = np.array([3, 5, 1], np.int32)
    eng = ContinuousBatcher(tm, max_rows=4, draft_module=dm, gamma=2)
    n = 400
    reqs = [eng.submit(p, max_new_tokens=2, temperature=1.0, key=1000 + i)
            for i in range(n)]
    eng.run_until_idle()
    toks = np.stack([r.result(timeout=5) for r in reqs])
    x = torch.as_tensor(p[None], dtype=torch.long)
    with torch.inference_mode():  # the cache path: no pad-id masking
        p1 = torch.softmax(tm(x, cache=tm.init_cache(1))[0, -1], -1)
        nxt = torch.cat([x.repeat(8, 1), torch.arange(8)[:, None]], 1)
        p2 = (p1[:, None] * torch.softmax(
            tm(nxt, cache=tm.init_cache(8))[:, -1], -1)).sum(0)
    for pos, exact in ((0, p1), (1, p2)):
        hist = np.bincount(toks[:, pos], minlength=8) / n
        tv = 0.5 * np.abs(hist - exact.numpy()).sum()
        assert tv < 0.12, (pos, tv, hist, exact)


# ------------------------------------------- chunked prefill, paged reuse


def shared_prefix_jobs():
    """Two prompts over one 12-token system prefix, an unrelated one and a
    repeat: a fresh chunked admission, seeded suffixes and a full match."""
    sys_p = prompt(40, 12)
    a = np.concatenate([sys_p, prompt(41, 4)])
    b = np.concatenate([sys_p, prompt(42, 4)])
    return [(a, 8), (b, 10), (prompt(43, 9), 6), (a, 8)]


@pytest.fixture(scope="module")
def jax_paged(spec):
    """The JAX speculative engine with chunked prefill over a paged pool:
    (tokens, engine, pool)."""
    (jm, jv, _), (_, dv, _) = spec
    pool = JaxPool(block_size=4, capacity_blocks=128)
    eng = JaxBatcher(jm, jv, max_rows=2, prefill_chunk=4, paged_kv=pool,
                     draft_module=jm, draft_variables=dv, gamma=3)
    return run(eng, shared_prefix_jobs()), eng, pool


def test_chunked_paged_spec_matches_jax_engine_and_pool(spec, jax_paged):
    """spec x chunked x paged: the same tokens, the same prefill ledger,
    and a pool with the same chain digests, block count, metrics and K/V
    (within KV_ATOL) as the JAX engine's — each row's spec-round appends
    map exactly its accepted positions onto the chain."""
    want, jeng, jpool = jax_paged
    pool = PagedKVPool(block_size=4, capacity_blocks=128)
    eng = port_spec(spec, max_rows=2, prefill_chunk=4, paged_kv=pool,
                    gamma=3)
    appended = []
    append = eng._append_decode_kv

    def spy(win, active, window, counts=None):
        appended.extend(int(c) for c, a in zip(counts, active) if a)
        return append(win, active, window, counts)

    eng._append_decode_kv = spy
    got = run(eng, shared_prefix_jobs())
    # rows appended 1 (nothing accepted) up to gamma + 1 positions a round
    assert {1, 4} <= set(appended) and len(set(appended)) >= 3, appended
    for out, ref in zip(got, want):
        np.testing.assert_array_equal(out, ref)
    assert eng.prefill_tokens_reused == jeng.prefill_tokens_reused > 0
    assert eng.prefill_tokens_total == jeng.prefill_tokens_total
    assert eng.step_count == jeng.step_count
    assert set(pool._table) == set(jpool._table)
    assert len(pool) == len(jpool) and pool.metrics == jpool.metrics
    assert pool.blocks_in_use() == jpool.blocks_in_use() == 0
    for digest, blk in pool._table.items():
        jblk = jpool._table[digest]
        np.testing.assert_array_equal(blk.ids, jblk.ids)
        np.testing.assert_allclose(
            blk.kv["layer_1/value"].numpy(),
            np.asarray(jblk.kv["/layer_1/attention/cached_value"]),
            atol=KV_ATOL, rtol=0)


@pytest.mark.parametrize("plen,budget", [(5, 10), (17, 8), (23, 6)])
def test_chunked_spec_token_identical_to_greedy(spec, plen, budget):
    """The draft prefills over the target's chunk schedule and only ever
    shapes acceptance speed: tokens stay solo generate's."""
    tm = spec[0][2]
    p = prompt(30 + plen, plen)
    eng = port_spec(spec, max_rows=2, prefill_chunk=4, gamma=3)
    np.testing.assert_array_equal(run(eng, [(p, budget)])[0],
                                  solo(tm, p, budget))


def test_spec_rows_advance_during_chunked_admission(spec):
    """The stall bound survives: while a long prompt admits chunk by chunk
    (target and draft), an in-flight spec row emits every round."""
    tm = spec[0][2]
    eng = port_spec(spec, max_rows=2, prefill_chunk=4, gamma=3)
    fast = eng.submit(prompt(50, 4), max_new_tokens=40)
    eng.tick()
    long_req = eng.submit(prompt(51, 30), max_new_tokens=4)
    while long_req.t_first is None:
        before = len(fast.tokens)
        eng.tick()
        if fast.done.is_set():
            break
        assert len(fast.tokens) > before, "spec row stalled"
    eng.run_until_idle()
    np.testing.assert_array_equal(long_req.result(timeout=1),
                                  solo(tm, prompt(51, 30), 4))


def test_resumed_spec_row_continues_exactly(spec):
    """A keep_chain chain resumed on a speculative engine (the draft
    prefills the whole known history, chunked) continues token-identical
    to an uninterrupted run."""
    tm = spec[0][2]
    p, budget = prompt(2, 6), 20
    pool = PagedKVPool(block_size=4, capacity_blocks=128)
    first = port_spec(spec, max_rows=2, paged_kv=pool, gamma=3)
    r = first.submit(p, max_new_tokens=8, keep_chain=True)
    first.run_until_idle()
    keep = r.chain.length - p.size + 1
    second = port_spec(spec, max_rows=2, paged_kv=pool, prefill_chunk=4,
                       gamma=3)
    r2 = second.submit(p, max_new_tokens=budget,
                       resume_from=(r.chain, r.tokens[:keep]))
    second.run_until_idle()
    assert r2.resumed and second.prefill_tokens_total == 0
    np.testing.assert_array_equal(r2.result(timeout=1), solo(tm, p, budget))


# -------------------------------------------------- the flash kernel rule


def test_flash_only_at_admission_from_position_zero(spec):
    """Admissions from index 0 take the flash path once a layer for the
    target and once a layer for the draft (its first chunk); seeded
    suffixes, later chunks, draft steps and the (R, gamma+1) verify rounds
    never do. The engine's spans count the same prefills."""
    (_, _, tm), (_, _, dm) = spec
    calls = []
    saved = []
    for name, model in (("target", tm), ("draft", dm)):
        for i, blk in enumerate(model.layers):
            fn = blk.attention.attn_fn
            saved.append((blk, fn))

            def spy(q, *a, _fn=fn, _tag=(name, i), **kw):
                calls.append(_tag + (q.shape[1],))
                return _fn(q, *a, **kw)
            blk.attention.attn_fn = spy
    tracer = Tracer()
    try:
        pool = PagedKVPool(block_size=4, capacity_blocks=128)
        eng = port_spec(spec, max_rows=2, paged_kv=pool, gamma=3,
                        tracer=tracer)
        jobs = shared_prefix_jobs()
        run(eng, jobs[:1])               # 16 tokens fresh: both models
        assert calls == [("target", i, 16) for i in range(2)] + \
            [("draft", i, 16) for i in range(2)]
        calls.clear()
        run(eng, jobs[1:2])              # prefix seeded: the draft only
        assert eng.prefill_tokens_reused == 12
        assert calls == [("draft", i, 16) for i in range(2)]
        calls.clear()
        eng = port_spec(spec, max_rows=2, prefill_chunk=4, gamma=3)
        run(eng, [(prompt(60, 10), 6)])  # chunks 4, 4, 2: the first only
        assert calls == [("target", i, 4) for i in range(2)] + \
            [("draft", i, 4) for i in range(2)]
    finally:
        for blk, fn in saved:
            blk.attention.attn_fn = fn
    spans = tracer.snapshot()
    target_zero = [s for s in spans if s["name"] == "engine.prefill_chunk"
                   and s["attrs"]["tokens_reused"] == 0]
    draft_zero = [s for s in spans
                  if s["name"] == "engine.draft_prefill_chunk"
                  and s["attrs"]["pos"] == s["attrs"]["tokens_computed"]]
    assert (len(target_zero), len(draft_zero)) == (1, 2)
