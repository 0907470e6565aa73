"""Speculative decoding — draft-accelerated generation, target-exact;
counterpart of ``kubeflow_tpu/models/speculative.py``.

A small DRAFT model proposes ``gamma`` tokens autoregressively, then the
TARGET model scores all of them in ONE forward pass (a ``gamma+1``-token
block over its KV cache) and accepts the longest prefix it agrees with,
emitting its own correction token at the first disagreement. Two modes,
both target-exact for ANY draft (a bad draft only costs speed): greedy
(temperature 0, acceptance is argmax-match, the output IS the target's
greedy decode) and rejection SAMPLING (temperature > 0, acceptance
probability min(1, p_t/p_d) with residual resampling — the output
DISTRIBUTION equals sampling the target directly; Leviathan et al. 2023,
Chen et al. 2023).

The variable accepted length only moves the cache index: rows past the
index are invisible under the position mask (a key is attended only at
k_pos <= q_pos), so rewinding after a rejection is one index write
(``models.gpt.set_cache_indices``). Both prompts prefill from index 0 with
``prefill=True`` — through the flash kernel on the card — while the
verify block, at an index past 0, takes the masked attention over the
whole cache. The rounds are a Python loop where the reference runs a
``lax.while_loop``; each round reads its emitted tokens and accept count
back in one copy.
"""

from __future__ import annotations

import torch

from kubeflow_tpu_torch.models.gpt import (
    GPTLM,
    eos_id_array,
    set_cache_indices,
)


def _check(target: GPTLM, draft: GPTLM, prompt_ids: torch.Tensor,
           max_new_tokens: int, gamma: int, temperature: float,
           generator) -> None:
    """The reference's guards (speculative.py:80-105)."""
    b, prompt_len = prompt_ids.shape
    if b != 1:
        raise ValueError(
            f"speculative_generate is batch-1 (got batch {b}): accepted "
            "length diverges per row; run rows as separate calls")
    if max_new_tokens < 1:
        raise ValueError(
            f"max_new_tokens must be >= 1, got {max_new_tokens}")
    if gamma < 1:
        raise ValueError(f"gamma must be >= 1, got {gamma}")
    if temperature > 0.0 and generator is None:
        raise ValueError(
            "speculative sampling (temperature > 0) needs a generator")
    for m, name in ((target, "target"), (draft, "draft")):
        if prompt_len + max_new_tokens + gamma + 1 > m.cfg.max_len:
            raise ValueError(
                f"{name}.cfg.max_len {m.cfg.max_len} < prompt {prompt_len} "
                f"+ max_new_tokens {max_new_tokens} + gamma+1 {gamma + 1}")
        if m.cfg.kv_cache_capacity:
            raise ValueError(
                f"{name} uses a rolling KV cache (kv_cache_capacity) — "
                "speculative rewind makes ring-slot identity ambiguous "
                "(a rewound index cannot tell stale newer writes from "
                "valid older ones); serve rolling models without a draft")


@torch.inference_mode()
def speculative_generate(
    target: GPTLM,
    draft: GPTLM,
    prompt_ids: torch.Tensor,
    max_new_tokens: int,
    gamma: int = 4,
    eos_token_id=None,
    temperature: float = 0.0,
    generator: torch.Generator | None = None,
):
    """Speculative decoding. Returns (tokens (1, max_new_tokens) int32 on
    the target's device, {"rounds", "drafted_accepted", "tokens"}).

    temperature == 0 (default): greedy — the output is EXACTLY the target
    model's greedy decode for ANY draft.

    temperature > 0: speculative sampling (needs ``generator``, on the
    models' device) — proposal x_i ~ p_draft is accepted with probability
    min(1, p_target(x_i)/p_draft(x_i)); the first rejection resamples
    from the normalized residual max(0, p_target − p_draft), and an
    all-accepted round samples the bonus token from p_target. The draws
    come from ``generator`` in a fixed order (the first token, then per
    round the gamma proposals, gamma uniforms and the correction), so a
    seed repeats its output.

    Batch size 1. The draft must share the target's vocabulary; nothing
    else — sizes and weights may differ. eos_token_id mirrors generate():
    the loop stops once a stop id lands in the emitted prefix, and every
    position after the first stop id is the FIRST stop id.
    """
    _check(target, draft, prompt_ids, max_new_tokens, gamma, temperature,
           generator)
    prompt_len = prompt_ids.shape[1]
    sampling = temperature > 0.0
    dev = prompt_ids.device
    prompt_ids = prompt_ids.long()

    def draw(probs: torch.Tensor) -> torch.Tensor:
        return torch.multinomial(probs, 1, generator=generator)[..., 0]

    # prefill both caches over the prompt from index 0 (the flash path);
    # the first token comes from the target alone
    t_cache, d_cache = target.init_cache(1), draft.init_cache(1)
    t_logits = target(prompt_ids, cache=t_cache, prefill=True)[:, -1]
    draft(prompt_ids, cache=d_cache, prefill=True)
    if sampling:
        first = draw(torch.softmax(t_logits / temperature, dim=-1))
    else:
        first = t_logits.argmax(-1)
    buf = [int(first[0])]
    stops = eos_id_array(eos_token_id)
    stop_set = None if stops is None else set(stops.tolist())
    rounds = accepted = 0
    G = gamma
    while len(buf) < max_new_tokens and not (
            stop_set is not None and stop_set.intersection(buf)):
        last = torch.tensor([buf[-1]], dtype=torch.long, device=dev)
        # --- draft proposes gamma tokens --------------------------------
        tok, props, d_probs = last, [], []
        for _ in range(G):
            row = draft(tok[:, None], cache=d_cache)[:, -1]      # (1, V)
            if sampling:
                probs = torch.softmax(row / temperature, dim=-1)
                tok = draw(probs)
                d_probs.append(probs[0])
            else:
                tok = row.argmax(-1)
            props.append(tok)
        # one extra draft step writes the last proposal into the draft
        # cache, so an all-accepted round leaves no unwritten row below
        # the advanced index
        draft(tok[:, None], cache=d_cache)
        proposals = torch.cat(props)                             # (G,)
        # --- target scores last + ALL proposals in ONE pass -------------
        logits = target(torch.cat([last, proposals])[None],
                        cache=t_cache)[0]                        # (G+1, V)
        if sampling:
            p_t = torch.softmax(logits / temperature, dim=-1)
            d_p = torch.stack(d_probs)                           # (G, V)
            pt_x = p_t[:G].gather(-1, proposals[:, None])[:, 0]
            pd_x = d_p.gather(-1, proposals[:, None])[:, 0]
            u = torch.rand((G,), generator=generator, device=dev)
            ok = u < torch.clamp(pt_x / pd_x.clamp_min(1e-30), max=1.0)
            a = torch.cumprod(ok.long(), 0).sum()
            residual = (p_t[:G] - d_p).clamp_min(0.0)
            rs = residual.sum(-1, keepdim=True)
            # a rejection at i implies p_t[i] != p_d[i] somewhere, so
            # rs > 0 there; the where guards underflow only
            res_norm = torch.where(rs > 0, residual / rs.clamp_min(1e-30),
                                   p_t[:G])
            corr_rows = torch.cat([res_norm, p_t[G:]])           # (G+1, V)
            corr = draw(corr_rows.index_select(0, a[None])
                        .clamp_min(1e-30))[0]
        else:
            # t_tokens[i] = the target's own choice after accepting i
            # proposals; accept while the draft matches it
            t_tokens = logits.argmax(-1)                         # (G+1,)
            a = torch.cumprod((proposals == t_tokens[:G]).long(), 0).sum()
            corr = t_tokens[a]
        # emit proposals[:a], then the correction token
        padded = torch.cat([proposals, proposals.new_zeros(1)])
        upd = torch.where(torch.arange(G + 1, device=dev) < a, padded, corr)
        host = torch.cat([upd, a[None]]).tolist()   # the round's read-back
        n_acc = host[-1]
        buf.extend(host[:n_acc + 1])
        rounds += 1
        accepted += n_acc
        # both caches wrote gamma+1 rows; only last + the accepted stay
        # valid, and rows past the index are unreachable
        base = prompt_len + len(buf) - 1
        set_cache_indices(t_cache, base)
        set_cache_indices(d_cache, base)
    n = len(buf)
    out = buf[:max_new_tokens] + [0] * max(0, max_new_tokens - n)
    if stop_set is not None:
        # clamp past the first stop id (rounds overshoot by up to gamma)
        hit = next((i for i, t in enumerate(out) if t in stop_set), None)
        if hit is not None:
            out = out[:hit + 1] + [int(stops[0])] * (len(out) - hit - 1)
    return torch.tensor([out], dtype=torch.int32, device=dev), {
        "rounds": rounds, "drafted_accepted": accepted,
        "tokens": min(n, max_new_tokens),
    }
