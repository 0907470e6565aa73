"""The port's KV-cache helpers and beam search against the JAX package's.

``set_cache_indices``, ``gather_kv_rows`` and the engine's row splice act
on the port's ``KVCache`` (one (B,) index; per-layer buffers updated in
place) where the JAX package rewrites a flax cache collection; parity
means the same indices and the same rows for converted weights. Beam
search must pick the JAX package's beams (ids identical) with scores
within 1e-4. Both sides run f32 on the CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from kubeflow_tpu.models import gpt as jg
from kubeflow_tpu.serving.continuous import ContinuousBatcher as JaxBatcher
from kubeflow_tpu_torch.convert import (
    flax_params_from_gpt,
    gpt_params_from_flax,
)
from kubeflow_tpu_torch.models import gpt as tg

try:  # one intra-op thread: the suite shares the machine with timing gates
    torch.set_num_threads(1)
    torch.set_num_interop_threads(1)
except RuntimeError:  # the interop pool can be sized once per process
    pass

KV_ATOL = 1e-5
SCORE_TOL = 1e-4
CONFIGS = {  # name -> (size, config kwargs) shared by both sides
    "tiny": ("tiny", dict(max_len=64)),
    "llama": ("llama", dict(max_len=64)),
}


def setup(name, seed=1):
    """(jax module, jax variables, port module) with numpy-seeded weights:
    N(0, 0.2) weights and biases, scales 1 + N(0, 0.1)."""
    size, kw = CONFIGS[name]
    jcfg = getattr(jg.GPTConfig, size)(dropout_rate=0.0, **kw)
    tcfg = getattr(tg.GPTConfig, size)(**kw)
    template = flax_params_from_gpt(
        tg.GPTLM(tcfg, device="cpu").state_dict(), tcfg)
    rng = np.random.RandomState(seed)
    flat = {k: (1.0 + 0.1 * rng.normal(size=template[k].shape)
                if k.endswith("/scale")
                else 0.2 * rng.normal(size=template[k].shape)
                ).astype(np.float32) for k in sorted(template)}
    variables = {"params": traverse_util.unflatten_dict(
        {k: jnp.asarray(v) for k, v in flat.items()}, sep="/")}
    model = tg.GPTLM(tcfg, device="cpu")
    model.load_state_dict(gpt_params_from_flax(flat, tcfg))
    return jg.GPTLM(jcfg, pad_token_id=-1), variables, model.eval()


def decoded_caches(name, prompt, steps):
    """Both sides' caches after a prefill of `prompt` (B, L) and `steps`
    greedy decode steps: (jax cache collection, port KVCache, n_layers)."""
    jmodel, variables, model = setup(name)
    _, cache = jmodel.apply(variables, jnp.asarray(prompt), decode=True,
                            mutable=["cache"])
    cache = cache["cache"]
    kv = model.init_cache(prompt.shape[0])
    with torch.inference_mode():
        logits = model(torch.as_tensor(prompt, dtype=torch.long), cache=kv)
        tok = logits[:, -1].argmax(-1)
        for _ in range(steps):
            _, new = jmodel.apply({**variables, "cache": cache},
                                  jnp.asarray(tok.numpy())[:, None],
                                  decode=True, mutable=["cache"])
            cache = new["cache"]
            tok = model(tok[:, None], cache=kv)[:, 0].argmax(-1)
    return cache, kv, model.cfg.num_layers


def jax_index(cache):
    return np.asarray(cache["layer_0"]["attention"]["cache_index"])


@pytest.fixture(scope="module")
def tiny_caches():
    prompt = np.random.RandomState(0).randint(1, 512, (3, 4)).astype(
        np.int32)
    return decoded_caches("tiny", prompt, 2)


@pytest.mark.parametrize("values,active", [
    (None, [True, False, True]),
    ([5, 7, 9], None),
    ([5, 7, 9], [False, True, True]),
    (11, [True, True, False]),
])
def test_set_cache_indices_matches_jax(tiny_caches, values, active):
    cache, kv, _ = tiny_caches
    kv = tg.KVCache(kv.key, kv.value, kv.index.clone())
    assert (kv.index == 6).all()
    want = jg.set_cache_indices(cache, values, None if active is None
                                else jnp.asarray(active))
    got = tg.set_cache_indices(kv, values, active)
    assert got is kv  # in place
    np.testing.assert_array_equal(kv.index.numpy(), jax_index(want))
    np.testing.assert_array_equal(np.asarray(want["pos_index"]),
                                  kv.index.numpy())


@pytest.mark.parametrize("name", list(CONFIGS))
def test_gather_kv_rows_matches_jax(name):
    """Per-row windows at each row's own start, one start past
    capacity - window (it clamps as dynamic_slice does)."""
    prompt = np.random.RandomState(1).randint(1, 512, (3, 6)).astype(
        np.int32)
    cache, kv, n = decoded_caches(name, prompt, 3)
    starts = np.array([0, 4, 62], np.int32)
    want = jg.gather_kv_rows(cache, jnp.asarray(starts), 3)
    got = tg.gather_kv_rows(kv, torch.as_tensor(starts), 3)
    assert set(got) == set(tg.cache_paths(n)) and len(want) == 2 * n
    for i in range(n):
        for kind, leaf in (("key", "cached_key"), ("value", "cached_value")):
            g = got[f"layer_{i}/{kind}"]
            assert g.shape == (3, 3, *kv.key[i].shape[2:])
            np.testing.assert_allclose(
                g.numpy(), np.asarray(want[f"/layer_{i}/attention/{leaf}"]),
                atol=KV_ATOL, rtol=0)


def test_row_splice_matches_jax_engine():
    """The batch-1 prefill of a prompt spliced into slot 1 of a 3-row live
    cache: the slot's buffers and index equal the JAX engine's splice; the
    other rows are untouched."""
    jmodel, variables, model = setup("tiny")
    ids = np.random.RandomState(2).randint(1, 512, 5).astype(np.int32)
    jeng = JaxBatcher(jmodel, variables, max_rows=3)
    _, jrow = jeng._prefill(ids)
    jlive = jeng._splice(jeng._cache, jrow, jnp.int32(1))
    live = model.init_cache(3)
    for buf in tg.cache_buffers(live):
        buf.fill_(7.0)
    row = model.init_cache(1)
    with torch.inference_mode():
        model(torch.as_tensor(ids[None], dtype=torch.long), cache=row,
              prefill=True)
    tg.splice_cache_row(live, row, 1)
    # the other rows keep their index (the JAX engine's live cache was
    # made by a dummy decode step, so its free rows sit at 1, the port's
    # at 0)
    np.testing.assert_array_equal(live.index.numpy(), [0, 5, 0])
    assert jax_index(jlive)[1] == 5
    for i in range(model.cfg.num_layers):
        att = jlive[f"layer_{i}"]["attention"]
        for buf, leaf in ((live.key[i], "cached_key"),
                          (live.value[i], "cached_value")):
            np.testing.assert_allclose(buf[1].numpy(),
                                       np.asarray(att[leaf])[1],
                                       atol=KV_ATOL, rtol=0)
            assert (buf[0] == 7.0).all() and (buf[2] == 7.0).all()


@pytest.mark.parametrize("name,beams", [("tiny", 3), ("llama", 4)])
def test_beam_search_matches_jax(name, beams):
    jmodel, variables, model = setup(name)
    prompt = np.random.RandomState(3).randint(1, 512, (2, 5)).astype(
        np.int32)
    run = jax.jit(lambda v, p: jg.beam_search(jmodel, v, p, 6, beams))
    want_ids, want_scores = run(variables, jnp.asarray(prompt))
    ids, scores = tg.beam_search(model, torch.as_tensor(prompt), 6, beams)
    assert ids.dtype == torch.int32 and ids.shape == (2, 6)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(want_ids))
    np.testing.assert_allclose(scores.numpy(), np.asarray(want_scores),
                               atol=SCORE_TOL, rtol=0)
    # the score is the exact log-prob of the returned ids under a plain
    # forward of the whole sequence
    full = torch.cat([torch.as_tensor(prompt).long(), ids.long()], dim=1)
    with torch.inference_mode():
        logp = torch.log_softmax(model(full)[:, 4:-1], dim=-1)
    exact = logp.gather(-1, ids.long()[..., None])[..., 0].sum(-1)
    np.testing.assert_allclose(scores.numpy(), exact.numpy(),
                               atol=SCORE_TOL, rtol=0)
    # one beam is greedy decoding
    one, _ = tg.beam_search(model, torch.as_tensor(prompt), 6, 1)
    np.testing.assert_array_equal(
        one.numpy(), tg.generate(model, torch.as_tensor(prompt), 6).numpy())
    with pytest.raises(ValueError, match="exceeds max_len"):
        tg.beam_search(model, torch.as_tensor(prompt), 60, beams)
