"""The port's continuous-batching engine against the JAX package's.

One set of tiny GPT weights (``GPTConfig.tiny(max_len=96)``), drawn from a
numpy seed in the flax layout, goes to the JAX engine
(``kubeflow_tpu.serving.continuous.ContinuousBatcher``, dense attention,
jitted on the CPU as tests/test_continuous.py runs it) and, through
``kubeflow_tpu_torch.convert``, to the port's engine on CPU tensors
(``attention="flash"``: its prefills take the flash path's plain version,
which is the same function). Both sides run f32; greedy tokens must be
identical, and the paged pool's K/V agree within atol 1e-5 (the two sides
order their matmul sums differently).
"""

import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from kubeflow_tpu.models import gpt as jg
from kubeflow_tpu.serving.continuous import ContinuousBatcher as JaxBatcher
from kubeflow_tpu.serving.fleet.pagedkv import PagedKVPool as JaxPool
from kubeflow_tpu_torch.convert import (
    flax_params_from_gpt,
    gpt_params_from_flax,
)
from kubeflow_tpu_torch.models import gpt as tg
from kubeflow_tpu_torch.serving.continuous import ContinuousBatcher
from kubeflow_tpu_torch.serving.fleet import PagedKVPool

try:  # one intra-op thread: the suite shares the machine with timing gates
    torch.set_num_threads(1)
    torch.set_num_interop_threads(1)
except RuntimeError:  # the interop pool can be sized once per process
    pass

KV_ATOL = 1e-5
# (seed, prompt length, budget): lengths 3-9, budgets 6-24; with 3 rows the
# later ones admit while earlier rows are mid-flight
JOBS = ((1, 4, 12), (2, 7, 20), (3, 5, 6), (4, 9, 16), (5, 3, 24),
        (6, 6, 9))
PREFIX = np.random.RandomState(40).randint(1, 512, 10).astype(np.int32)


def prompt(seed, n):
    return np.random.RandomState(seed).randint(1, 512, n).astype(np.int32)


def shared_prefix_mix():
    """Prompts over one 10-token system prefix, an unrelated prompt, and a
    repeat: seeded admissions, partial tail blocks and a full match."""
    tails = [prompt(50 + i, n) for i, n in enumerate((3, 5, 2, 6))]
    ps = [np.concatenate([PREFIX, t]) for t in tails]
    return [(p, 10) for p in ps[:2]] + [(prompt(60, 7), 8)] + \
        [(p, 12) for p in ps[2:]] + [(ps[0], 10)]


@pytest.fixture(scope="module")
def lm():
    """(jax module, jax variables, port module) with the same weights."""
    tcfg = tg.GPTConfig.tiny(max_len=96, attention="flash",
                             attention_block=8)
    template = flax_params_from_gpt(
        tg.GPTLM(tcfg, device="cpu").state_dict(), tcfg)
    rng = np.random.RandomState(1)
    flat = {k: (1.0 + 0.1 * rng.normal(size=template[k].shape)
                if k.endswith("/scale")
                else 0.2 * rng.normal(size=template[k].shape)
                ).astype(np.float32) for k in sorted(template)}
    variables = {"params": traverse_util.unflatten_dict(
        {k: jnp.asarray(v) for k, v in flat.items()}, sep="/")}
    jmodel = jg.GPTLM(jg.GPTConfig.tiny(dropout_rate=0.0, max_len=96),
                      pad_token_id=-1)
    tmodel = tg.GPTLM(tcfg, device="cpu")
    tmodel.load_state_dict(gpt_params_from_flax(flat, tcfg))
    return jmodel, variables, tmodel.eval()


def run(eng, jobs, **kw):
    reqs = [eng.submit(p, max_new_tokens=b, **kw) for p, b in jobs]
    eng.run_until_idle()
    return [r.result(timeout=1) for r in reqs]


@pytest.fixture(scope="module")
def jobs():
    return [(prompt(s, n), b) for s, n, b in JOBS]


@pytest.fixture(scope="module")
def jax_tokens(lm, jobs):
    jmodel, variables, _ = lm
    return run(JaxBatcher(jmodel, variables, max_rows=3), jobs)


@pytest.fixture(scope="module")
def jax_paged(lm):
    """The JAX engine over the shared-prefix mix with chunked prefill and a
    paged pool: (tokens, engine, pool)."""
    jmodel, variables, _ = lm
    pool = JaxPool(block_size=4, capacity_blocks=256)
    eng = JaxBatcher(jmodel, variables, max_rows=2, prefill_chunk=4,
                     paged_kv=pool)
    return run(eng, shared_prefix_mix()), eng, pool


@pytest.fixture
def flash_spy(lm):
    """Records, per forward through the flash path, the query length of
    every layer's call; restores the layers after the test."""
    model = lm[2]
    calls = []
    saved = [blk.attention.attn_fn for blk in model.layers]
    for i, blk in enumerate(model.layers):
        def spy(q, *a, _fn=saved[i], _i=i, **kw):
            calls.append((_i, q.shape[1]))
            return _fn(q, *a, **kw)
        blk.attention.attn_fn = spy
    try:
        yield calls
    finally:
        for blk, fn in zip(model.layers, saved):
            blk.attention.attn_fn = fn


# ------------------------------------------------------------- exactness


def test_mixed_rows_match_jax_engine_and_generate(lm, jobs, jax_tokens):
    """Rows of different lengths and budgets, admitted while others are
    mid-flight, give the JAX engine's tokens and the port's own solo
    generate()."""
    model = lm[2]
    eng = ContinuousBatcher(model, max_rows=3)
    got = run(eng, jobs)
    for (p, b), out, want in zip(jobs, got, jax_tokens):
        np.testing.assert_array_equal(out, want)
        solo = tg.generate(model, torch.as_tensor(p[None], dtype=torch.long),
                           b)[0].numpy()
        np.testing.assert_array_equal(out, solo)
    # 6 prompts through 3 rows: readmission mid-flight, far fewer
    # dispatches than the 81 sequential decode steps
    assert eng.step_count < sum(b - 1 for _, b in jobs)
    assert eng.prefill_tokens_total == sum(p.size for p, _ in jobs)


@pytest.mark.parametrize("kw", [
    {"steps_per_tick": 3},
    {"prefill_buckets": (8, 16)},
    {"prefill_buckets": (4, 8, 16), "steps_per_tick": 3},
    {"paged_kv": True, "steps_per_tick": 2},
], ids=["ticks3", "buckets", "buckets_ticks3", "paged_ticks2"])
def test_modes_match_jax_plain_engine(lm, jobs, jax_tokens, kw):
    """Bucketed prefill and multi-step ticks give the plain engine's (T=1)
    tokens; multi-step ticks with a pool append T positions a dispatch."""
    kw = dict(kw)
    if kw.pop("paged_kv", False):
        kw["paged_kv"] = PagedKVPool(block_size=4, capacity_blocks=256)
    eng = ContinuousBatcher(lm[2], max_rows=3, **kw)
    for out, want in zip(run(eng, jobs), jax_tokens):
        np.testing.assert_array_equal(out, want)
    if kw.get("steps_per_tick", 1) > 1:
        assert eng.step_count < 34  # the T=1 dispatch count


def test_chunked_paged_matches_jax_engine_and_pool(lm, jax_paged):
    """Chunked prefill over a paged pool: the same tokens, the same reuse
    count, and every pooled block's K/V within KV_ATOL of the JAX pool's
    block of the same chain (blocks pair by chain digest)."""
    want, jeng, jpool = jax_paged
    pool = PagedKVPool(block_size=4, capacity_blocks=256)
    eng = ContinuousBatcher(lm[2], max_rows=2, prefill_chunk=4,
                            paged_kv=pool)
    got = run(eng, shared_prefix_mix())
    for out, ref in zip(got, want):
        np.testing.assert_array_equal(out, ref)
    assert eng.prefill_tokens_reused == jeng.prefill_tokens_reused > 0
    assert eng.prefill_tokens_total == jeng.prefill_tokens_total
    assert set(pool._table) == set(jpool._table)
    assert pool.metrics == jpool.metrics
    n_layers = lm[2].cfg.num_layers
    for digest, blk in pool._table.items():
        jblk = jpool._table[digest]
        np.testing.assert_array_equal(blk.ids, jblk.ids)
        assert len(blk.kv) == len(jblk.kv) == 2 * n_layers
        for i in range(n_layers):
            for kind, leaf in (("key", "cached_key"),
                               ("value", "cached_value")):
                np.testing.assert_allclose(
                    blk.kv[f"layer_{i}/{kind}"].numpy(),
                    np.asarray(jblk.kv[f"/layer_{i}/attention/{leaf}"]),
                    atol=KV_ATOL, rtol=0)


def test_keep_chain_resume_matches_uninterrupted(lm, jobs, jax_tokens):
    """A keep_chain retire hands its block chain to the handle; a second
    engine over the same pool resumes it with the tokens the chain covers
    and continues token-identical to an uninterrupted run."""
    p, budget = jobs[1]                                 # 7 + 20 tokens
    pool = PagedKVPool(block_size=4, capacity_blocks=256)
    first = ContinuousBatcher(lm[2], max_rows=2, paged_kv=pool)
    r = first.submit(p, max_new_tokens=8, keep_chain=True)
    first.run_until_idle()
    chain = r.chain
    assert chain is not None and not chain.frozen
    keep = chain.length - p.size + 1
    assert 0 < keep <= len(r.tokens)
    second = ContinuousBatcher(lm[2], max_rows=2, paged_kv=pool)
    r2 = second.submit(p, max_new_tokens=budget,
                       resume_from=(chain, r.tokens[:keep]))
    second.run_until_idle()
    assert r2.resumed and second.prefill_tokens_total == 0
    np.testing.assert_array_equal(r2.result(timeout=1), jax_tokens[1])


# ---------------------------------------------- admission and failures


def test_block_budget_admission_is_fifo_like_jax(lm):
    """Block-budgeted admission: the head of the queue waits for blocks
    and a smaller request behind it does not jump it — the same seating,
    tick by tick, as the JAX engine's, and the same tokens."""
    jmodel, variables, tmodel = lm
    jobs = [(prompt(70, 9), 15), (prompt(71, 7), 9), (prompt(72, 3), 5)]
    seats = []
    for make, pool_cls in (
            (lambda pool: JaxBatcher(jmodel, variables, max_rows=3,
                                     paged_kv=pool, block_budget=True),
             JaxPool),
            (lambda pool: ContinuousBatcher(tmodel, max_rows=3,
                                            paged_kv=pool,
                                            block_budget=True),
             PagedKVPool)):
        pool = pool_cls(block_size=4, capacity_blocks=6)
        eng = make(pool)
        with pytest.raises(ValueError, match="beyond the pool"):
            eng.submit(prompt(73, 9), max_new_tokens=20)  # 8 blocks
        reqs = [eng.submit(p, max_new_tokens=b) for p, b in jobs]
        trace = []
        while eng.tick():
            trace.append(tuple(r.slot >= 0 for r in reqs))
            assert pool.blocks_in_use() <= pool.capacity_blocks
        seats.append((trace, [r.result(timeout=1) for r in reqs]))
    (jtrace, jtoks), (trace, toks) = seats
    assert trace == jtrace
    assert trace[0] == (True, False, False)   # C fits but waits behind B
    for out, want in zip(toks, jtoks):
        np.testing.assert_array_equal(out, want)


def test_poisoned_tick_fails_requests_not_the_engine(lm):
    """An exception inside a serving-thread tick unblocks the carried
    requests with the error and leaves the engine serving fresh ones."""
    model = lm[2]
    eng = ContinuousBatcher(model, max_rows=2).start()
    try:
        boom = {"armed": True}
        orig = eng._prefill

        def exploding(ids):
            if boom["armed"]:
                boom["armed"] = False
                raise RuntimeError("injected prefill failure")
            return orig(ids)

        eng._prefill = exploding
        bad = eng.submit(prompt(81, 5), max_new_tokens=6)
        with pytest.raises(RuntimeError, match="injected"):
            bad.result(timeout=30)
        p = prompt(82, 5)
        good = eng.submit(p, max_new_tokens=6)
        want = tg.generate(model, torch.as_tensor(p[None], dtype=torch.long),
                           6)[0].numpy()
        np.testing.assert_array_equal(good.result(timeout=60), want)
    finally:
        eng.stop()


def test_threaded_engine_serves_concurrent_clients(lm, jobs, jax_tokens):
    """start(): submits from six client threads land on the engine thread,
    whose ticks enter inference mode themselves."""
    eng = ContinuousBatcher(lm[2], max_rows=3).start()
    got = [None] * len(jobs)

    def client(i):
        p, b = jobs[i]
        got[i] = eng.submit(p, max_new_tokens=b).result(timeout=60)

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(len(jobs))]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        eng.stop()
    for out, want in zip(got, jax_tokens):
        np.testing.assert_array_equal(out, want)


# -------------------------------------------------------------- sampling


def test_sampling_per_seed_and_independent_of_batch_and_ticks(lm, jobs,
                                                               jax_tokens):
    """A sampled row's tokens depend only on its seed and step: the same
    seed alone, beside greedy rows, or at 3 steps a tick gives the same
    tokens; another seed differs; greedy rows beside sampled ones stay
    the JAX engine's tokens."""
    model = lm[2]
    p, budget = prompt(90, 6), 24

    def sampled(key, steps_per_tick=1, mixed=False, top_k=0):
        eng = ContinuousBatcher(model, max_rows=4, top_k=top_k,
                                steps_per_tick=steps_per_tick)
        greedy = ([eng.submit(q, max_new_tokens=b) for q, b in jobs[:3]]
                  if mixed else [])
        r = eng.submit(p, max_new_tokens=budget, temperature=0.9, key=key)
        eng.run_until_idle()
        for g, want in zip(greedy, jax_tokens):
            np.testing.assert_array_equal(g.result(timeout=1), want)
        return r.result(timeout=1)

    alone = sampled(7)
    np.testing.assert_array_equal(sampled(7), alone)
    np.testing.assert_array_equal(sampled(7, mixed=True), alone)
    np.testing.assert_array_equal(sampled(7, steps_per_tick=3), alone)
    assert not np.array_equal(sampled(8), alone)
    greedy = tg.generate(model, torch.as_tensor(p[None], dtype=torch.long),
                         budget)[0].numpy()
    assert not np.array_equal(alone, greedy)
    # top_k is engine-static: top_k=1 leaves the argmax alone
    np.testing.assert_array_equal(sampled(7, top_k=1), greedy)


# -------------------------------------------------------------- refusals


def test_refusals(lm):
    model = lm[2]
    # speculative mode runs one round a tick (tests/test_torch_spec_engine
    # holds the rest of its refusals)
    with pytest.raises(ValueError, match="steps_per_tick"):
        ContinuousBatcher(model, draft_module=model, steps_per_tick=2)
    with pytest.raises(ValueError, match="replaces bucketed prefill"):
        ContinuousBatcher(model, prefill_chunk=4, prefill_buckets=(8,))
    with pytest.raises(ValueError, match="exceeds max_len"):
        ContinuousBatcher(model, prefill_buckets=(8, 128))
    eng = ContinuousBatcher(model, prefill_buckets=(8,))
    with pytest.raises(ValueError, match="largest prefill bucket"):
        eng.submit(prompt(1, 9))
    with pytest.raises(ValueError, match="exceeds max_len"):
        eng.submit(prompt(1, 8), max_new_tokens=90)
    with pytest.raises(ValueError, match="requires a paged_kv pool"):
        eng.submit(prompt(1, 8), resume_from=(None, [1]))


# -------------------------------------------------- the flash kernel rule


def test_prefill_routing_takes_flash_only_from_position_zero(lm, flash_spy):
    """The flash path (the kernel on the card) runs exactly where a row's
    cache index is 0: every layer once per fresh or bucketed prefill at
    the prompt's (or bucket's) length, once per FIRST chunk of an unseeded
    chunked prefill, and never for a seeded suffix, a later chunk or a
    decode step."""
    model = lm[2]
    n = model.cfg.num_layers
    p = prompt(95, 6)
    run(ContinuousBatcher(model, max_rows=2), [(p, 5), (prompt(96, 9), 5)])
    assert flash_spy == [(i, 6) for i in range(n)] + [(i, 9)
                                                      for i in range(n)]
    flash_spy.clear()
    run(ContinuousBatcher(model, prefill_buckets=(8, 16)), [(p, 4)])
    assert flash_spy == [(i, 8) for i in range(n)]
    flash_spy.clear()
    pool = PagedKVPool(block_size=4, capacity_blocks=64)
    eng = ContinuousBatcher(model, max_rows=1, prefill_chunk=4,
                            paged_kv=pool)
    mix = shared_prefix_mix()
    run(eng, mix[:1])           # 13 tokens fresh: chunks 4, 4, 4, 1
    assert flash_spy == [(i, 4) for i in range(n)]
    assert eng.prefill_tokens_reused == 0
    flash_spy.clear()
    run(eng, mix[1:2])          # the prefix seeded: suffix chunks only
    assert eng.prefill_tokens_reused > 0 and flash_spy == []
    # whole-prompt (unchunked) admission over a pool: fresh takes it,
    # seeded does not
    eng = ContinuousBatcher(model, max_rows=1, paged_kv=PagedKVPool(4, 64))
    run(eng, [(p, 3)])
    assert flash_spy == [(i, 6) for i in range(n)]
    flash_spy.clear()
    run(eng, [(np.concatenate([p, prompt(97, 3)]), 3)])
    # the first full block matches; the partial tail grew with the first
    # row's decode (a sole holder's extension replaces the block)
    assert eng.prefill_tokens_reused == 4 and flash_spy == []
