"""Continuous batching for generative serving — iteration-level scheduling;
counterpart of ``kubeflow_tpu/serving/continuous.py``.

Concurrent generative requests share one fixed-row decode batch instead of
serializing whole decodes behind each other. Decode is bound by the bytes
of the weights each step streams, whatever the number of rows riding it,
so a half-empty batch wastes the rate the card is bound by. The engine
(Orca-style iteration-level scheduling over row slots) keeps ONE
static-shape batch cache and splices sequences in and out BETWEEN steps:

  - admission: a queued prompt prefills into a free row (batch-1), and the
    row's cache slice and index are copied into the live batch cache
    (``models.gpt.splice_cache_row``; the cache keeps a per-row index for
    exactly this)
  - every tick advances ALL in-flight rows ``steps_per_tick`` tokens —
    rows at different depths, one batch
  - rows retire on EOS or their token budget; the slot readmits the next
    queued request without stalling the other rows

Greedy rows are EXACTLY generate()'s greedy decode for that prompt alone:
per-row position masking keeps rows independent. Sampling rows
(per-request temperature, engine-level top_k) draw from a generator
seeded from (the request's seed, the row's step), so a sampled row's
tokens depend on nothing else: not on the rows that share its batch, not
on ``steps_per_tick``; greedy and sampled rows mix in one batch.

Prefill and the flash kernel: ``GPTLM.forward(..., prefill=True)`` sends a
prompt through the flash-attention kernel over the prompt's own K/V, which
is the same function only when the row's cache index is 0. The engine
passes it for a fresh prefill, a bucketed prefill (right pads come after
every true position under a causal mask, and the index is rewound to the
true length) and the FIRST chunk of a chunked prefill with nothing seeded
from the pool; a suffix after a seeded prefix, a later chunk and every
decode step take the masked attention over the whole cache.

Speculative mode (``draft_module``, ``gamma``): a draft model proposes
gamma tokens a row, the target verifies every row's proposals in ONE
(R, gamma+1) forward, and each row accepts its own prefix and rewinds to
its own depth (the solo ``models.speculative`` scheme applied rowwise
through the per-row cache index). Greedy rows stay EXACTLY the target's
greedy decode; sampled rows run the rejection scheme with draws keyed by
(the request's key, depth*(gamma+3)+j). Both models' admission prefills
from index 0 pass ``prefill=True``; the verify block, at an index past 0,
never does.

The steps of a tick, and a spec round's draft steps, are a Python loop
where the reference scans; decode attention is plain PyTorch, as the
reference's is plain jnp.
"""

from __future__ import annotations

import hashlib
import math
import threading
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from kubeflow_tpu_torch.models.gpt import (
    cache_paths,
    gather_kv_rows,
    set_cache_indices,
    splice_cache_row,
)
from kubeflow_tpu_torch.tracing.core import armed_tracer, current_context

def _eos_tuple(eos) -> tuple[int, ...] | None:
    """Normalize an eos spec (int | sequence | None) to a tuple of stop
    ids for host-side retire checks — mirrors models.gpt.eos_id_array."""
    if eos is None:
        return None
    if isinstance(eos, (list, tuple, np.ndarray)):
        ids = tuple(int(x) for x in np.asarray(eos).reshape(-1))
        return ids or None
    return (int(eos),)


def stream_seed(key: int, step: int) -> int:
    """The seed of a sampled row's draw at `step`: a hash of (the request's
    key, the step), so the draw depends on those two alone."""
    digest = hashlib.blake2b(f"{key}:{step}".encode(), digest_size=8)
    return int.from_bytes(digest.digest(), "little") >> 1


@dataclass
class _InFlight:
    slot: int
    max_new_tokens: int
    eos_token_id: tuple[int, ...] | None
    temperature: float = 0.0
    key: int = 0  # the sampling rows' seed (stream_seed)
    tokens: list = field(default_factory=list)
    done: threading.Event = field(default_factory=threading.Event)
    error: str | None = None
    # streaming/timing surface (the fleet tier and the load-test harness
    # read these): submit/first-token/done timestamps plus optional
    # callbacks — on_token(req, tok) per emitted token, on_done(req) once
    # at retire OR failure. Callbacks run on the ENGINE thread: keep them
    # cheap and never call back into this engine under its lock.
    t_submit: float = 0.0
    t_first: float | None = None
    t_done: float | None = None
    on_token: object = None
    on_done: object = None
    # request-tracing state: trace_ctx is the `request` root span's
    # pre-allocated identity — engine spans (queue wait, prefill chunks,
    # decode window) parent to it as they complete, and the root itself
    # is recorded retroactively at finish() when this engine OWNS it
    # (own_root; a fleet-submitted request's root belongs to the router).
    # Retro recording means no open Span ever rides the ticker thread — an
    # error path cannot leak one.
    trace_ctx: object = None
    parent_ctx: object = None
    own_root: bool = False
    request_id: str = ""
    _tracer: object = None
    _tsdb: object = None
    t_submit_wall: float = 0.0
    t_first_wall: float | None = None
    # paged-KV lifetime state (fleet.pagedkv.SequenceChain): `chain` is
    # set when ownership TRANSFERS to the handle's consumer — a
    # keep_chain retire (the disaggregated prefill→decode handoff) or a
    # replica-kill _fail_all (the resume-from-KV requeue). `resumed`
    # rows continue a chain mid-decode: their pre-fed tokens never
    # re-fire callbacks and their engine-side TTFT is not a first token.
    chain: object = None
    resumed: bool = False
    _resume: object = None          # (SequenceChain, tokens) until seated
    _keep_chain: bool = False

    def push(self, tok: int) -> None:
        """Engine-side token emission — the ONE append path, so TTFT is
        stamped exactly when the first token exists."""
        if not self.tokens:
            self.t_first = time.perf_counter()
            self.t_first_wall = time.time()
        self.tokens.append(tok)
        if self.on_token is not None:
            self.on_token(self, tok)

    def finish(self, error: str | None = None) -> None:
        self.error = error if self.error is None else self.error
        self.t_done = time.perf_counter()
        if self._tsdb is not None and self.error is None \
                and self.ttft_s is not None and not self.resumed:
            # resumed rows have no first token — their t_first marks the
            # resume point and must not pollute the TTFT SLO series
            self._tsdb.record("serving.ttft_s", self.ttft_s)
        tr = self._tracer
        if tr is not None:
            if self.t_first is not None:
                attrs = {"tokens": len(self.tokens)}
                if self.resumed:
                    attrs["resumed"] = True
                if self.error is not None:
                    # a killed replica's partial decode window: real time
                    # spent, tokens discarded by the requeue contract
                    attrs["error"] = self.error
                tr.record_span(
                    "engine.decode", self.t_first_wall,
                    self.t_done - self.t_first, parent=self.trace_ctx,
                    **attrs)
            if self.own_root:
                tr.record_span(
                    "request", self.t_submit_wall,
                    self.t_done - self.t_submit, context=self.trace_ctx,
                    parent=self.parent_ctx,
                    request_id=self.request_id,
                    outcome="failed" if self.error else "completed",
                    tokens=len(self.tokens))
        self.done.set()
        if self.on_done is not None:
            self.on_done(self)

    @property
    def ttft_s(self) -> float | None:
        return None if self.t_first is None else self.t_first - self.t_submit

    @property
    def tokens_per_s(self) -> float | None:
        if self.t_first is None or self.t_done is None:
            return None
        dt = self.t_done - self.t_first
        return len(self.tokens) / dt if dt > 0 else float("inf")

    def result(self, timeout: float | None = None) -> np.ndarray:
        if not self.done.wait(timeout):
            raise TimeoutError("generation did not finish in time")
        if self.error is not None:
            raise RuntimeError(f"generation failed: {self.error}")
        return np.asarray(self.tokens, np.int32)


@dataclass
class _PendingPrefill:
    """A seated row whose prompt is still prefilling (chunked admission):
    the batch-1 row cache being built, the next position to compute, and
    the pool refs backing any reused prefix. With a draft model the
    draft's own batch-1 cache marches through the same chunk schedule
    (d_cache/d_pos) — admission completes when BOTH are done. A resume
    row (`resume`) has its target cache fully seeded from the pool and
    only waits on the draft (no draft: it never pends at all)."""

    req: _InFlight
    ids: np.ndarray
    pos: int
    cache: object
    last_logits: object = None
    match_refs: list = field(default_factory=list)
    d_cache: object = None
    d_pos: int = 0
    resume: bool = False


class ContinuousBatcher:
    """Fixed-row continuous-batching decode engine over a GPTLM.

    submit() enqueues a prompt and returns a handle whose .result() blocks
    for the generated ids; tick() runs one scheduling round (admit + one
    decode dispatch); run_until_idle() drains everything (the synchronous
    mode tests use); start()/stop() run ticks on a daemon thread (the
    serving mode). The module carries its weights (the reference's
    ``variables``) and its device; its compute dtype is the cache's.
    """

    def __init__(self, module, max_rows: int = 8,
                 default_max_new_tokens: int = 32,
                 eos_token_id=None, top_k: int = 0,
                 seed: int = 0, steps_per_tick: int = 1,
                 prefill_buckets: tuple[int, ...] | None = None,
                 draft_module=None, gamma: int = 4,
                 prefill_chunk: int = 0, paged_kv=None,
                 block_budget: bool = False, max_chunks_per_tick: int = 1,
                 tracer=None, tsdb=None):
        # tracer (tracing.Tracer): per-request spans — queue wait, one
        # span per prefill chunk (reused-vs-computed counts), decode
        # window, and a `request` root when no fleet owns one. tsdb (any
        # object with .record(name, value)): decode-tick and TTFT samples
        # for an SLO monitor. Both default off at zero cost on the tick
        # path.
        self.tracer = tracer
        self.tsdb = tsdb
        cfg = module.cfg
        # chunked prefill (prefill_chunk > 0): long prompts admit in
        # fixed-token chunks interleaved with decode ticks — at most ONE
        # chunk of prefill work per tick, so a 4k-token prompt never
        # stalls in-flight decode rows more than one chunk budget. The
        # per-row block write at each row's cache index makes the chunked
        # cache identical to a one-shot prefill's, so the first token —
        # and every token after it — is token-identical.
        # paged_kv (fleet.PagedKVPool): the pool is the KV substrate for
        # the WHOLE row lifetime — the matched prefix K/V seeds the row
        # cache at admission (only the suffix runs through the model),
        # and every decode dispatch appends its freshly-written K/V to
        # the row's block chain. block_budget=True additionally gates
        # admission on the pool's free-block count (prompt + budget
        # blocks must fit the working set) instead of row slots alone.
        # max_chunks_per_tick lifts the one-chunk stall bound for
        # PURE-PREFILL replicas (a prefill tier has no decode rows to
        # starve).
        self.prefill_chunk = int(prefill_chunk)
        self.paged_kv = paged_kv
        self.block_budget = bool(block_budget) and paged_kv is not None
        self.max_chunks_per_tick = int(max_chunks_per_tick)
        if self.prefill_chunk < 0:
            raise ValueError(
                f"prefill_chunk must be >= 0, got {prefill_chunk}")
        if self.max_chunks_per_tick < 1:
            raise ValueError(
                f"max_chunks_per_tick must be >= 1, got "
                f"{max_chunks_per_tick}")
        if self.prefill_chunk or paged_kv is not None:
            what = ("prefill_chunk" if self.prefill_chunk else "paged_kv")
            if prefill_buckets is not None:
                raise ValueError(
                    f"{what} replaces bucketed prefill — the chunk walk "
                    "already bounds the prefill shapes; configure one")
            if cfg.kv_cache_capacity:
                raise ValueError(
                    f"{what} requires the full KV cache: ring-slot "
                    "identity is ambiguous for seeded/partial prefixes")
        # speculative mode: a draft proposes gamma tokens a row, the
        # target verifies all rows' proposals in ONE (R, gamma+1) pass,
        # and each row rewinds to ITS accepted length through the per-row
        # cache index. One spec round per tick.
        self.draft_module = draft_module
        self.gamma = int(gamma)
        if draft_module is not None:
            for m, name in ((module, "target"), (draft_module, "draft")):
                if m.cfg.kv_cache_capacity:
                    raise ValueError(
                        f"{name} uses a rolling KV cache — speculative "
                        "rewind makes ring-slot identity ambiguous")
            if draft_module.cfg.vocab_size != cfg.vocab_size:
                raise ValueError("draft must share the target vocabulary")
            if prefill_buckets is not None:
                raise ValueError(
                    "speculative engine does not support prefill_buckets "
                    "yet: the draft prefill would need the same pad-rewind")
            if steps_per_tick != 1:
                raise ValueError(
                    "speculative engine runs one spec round per tick "
                    "(gamma amortizes the dispatch); steps_per_tick must "
                    "be 1")
            if self.gamma < 1:
                raise ValueError(f"gamma must be >= 1, got {gamma}")
        self.module = module
        self.max_rows = int(max_rows)
        self.max_len = int(cfg.max_len)
        # rolling-cache models bound the prefill length (models/gpt.py
        # capacity law); validate at submit() so a too-long prompt is the
        # CALLER's error, not an exception on the engine thread
        cap = int(cfg.kv_cache_capacity or 0)
        self.max_prompt_len = (
            cap - int(cfg.attention_window) + 1 if cap else self.max_len)
        # bucketed prefill: pad prompts right to the smallest bucket and
        # rewind the row's index to the true length — one prefill shape
        # per bucket instead of one per distinct prompt length. The stale
        # pad rows are invisible under the full cache's position mask; a
        # ROLLING cache cannot tell stale newer writes from valid older
        # ones, so buckets are refused there.
        if prefill_buckets is not None:
            if cap:
                raise ValueError(
                    "prefill_buckets requires the full KV cache: the pad "
                    "rewind makes rolling ring-slot identity ambiguous")
            buckets = tuple(sorted(int(x) for x in prefill_buckets))
            if not buckets or buckets[0] < 1:
                raise ValueError(f"bad prefill_buckets {prefill_buckets}")
            if buckets[-1] > self.max_len:
                raise ValueError(
                    f"prefill bucket {buckets[-1]} exceeds max_len "
                    f"{self.max_len}")
            self.prefill_buckets = buckets
        else:
            self.prefill_buckets = None
        self.default_max_new_tokens = int(default_max_new_tokens)
        self.eos_token_id = _eos_tuple(eos_token_id)
        self.top_k = int(top_k)
        # decode steps per tick: scheduling stays iteration-level at
        # granularity T, while T tokens amortize one host read-back. Rows
        # retiring mid-tick just discard their tail.
        self.steps_per_tick = max(1, int(steps_per_tick))
        self._seed = int(seed)
        self._submitted = 0
        self._lock = threading.Lock()
        self._queue: list[tuple[np.ndarray, _InFlight]] = []
        self._rows: list[_InFlight | None] = [None] * self.max_rows
        self._toks = np.zeros((self.max_rows,), np.int64)
        self._thread: threading.Thread | None = None
        self._stop = threading.Event()
        self.step_count = 0  # decode dispatches (the scheduling metric)
        self.device = module.device
        self._cache = module.init_cache(self.max_rows)
        self._sampler = torch.Generator(device=self.device)
        # chunked/seeded admission state: slot -> in-progress prefill;
        # ticker-private like _rows. _row_chains holds each DECODING
        # row's pool block chain (SequenceChain) — the pool-side twin of
        # the row's cache slice, grown per dispatch, released at retire
        # (or transferred to the handle on keep_chain/kill).
        self._pending: dict[int, _PendingPrefill] = {}
        self._row_chains: dict[int, object] = {}
        self._chunk_order: list[int] = []  # FIFO of pending slots
        self._row_template = None  # lazy batch-1 zero cache twin
        # per-row cache depth (prompt + cache-written decode positions):
        # host-side truth like _toks — the spec round's rewind base AND
        # the paged chain-append's extraction start
        self._depths = np.zeros((self.max_rows,), np.int64)
        if draft_module is not None:
            self._dcache = draft_module.init_cache(self.max_rows)
        #: prefill-unit accounting (the prefix-reuse proof reads these):
        #: tokens the model actually computed vs tokens seeded for free
        self.prefill_tokens_total = 0
        self.prefill_tokens_reused = 0
        #: speculative acceptance over the in-flight rows of every spec
        #: round: draft proposals made, and those the target accepted
        self.spec_proposed = 0
        self.spec_accepted = 0

    # ---------------------------------------------------------------- API

    def submit(self, prompt_ids, max_new_tokens: int | None = None,
               eos_token_id=None, temperature: float = 0.0,
               key: int | None = None, on_token=None, on_done=None,
               trace_ctx=None, request_id: str = "",
               keep_chain: bool = False, resume_from=None) -> _InFlight:
        # keep_chain: retire transfers the row's paged block chain to the
        # handle (handle.chain) instead of releasing it — the
        # disaggregated prefill replica's publish side. resume_from =
        # (SequenceChain, tokens): seat the row by SEEDING its cache from
        # the chain (no prefill compute) with `tokens` already emitted —
        # the decode replica's adopt side AND the kill-requeue resume;
        # max_new_tokens still bounds the TOTAL tokens, resumed included.
        # key: the sampling seed (an int); by default the engine seed
        # with the submit count.
        ids = np.asarray(prompt_ids, np.int32).reshape(-1)
        budget = int(max_new_tokens or self.default_max_new_tokens)
        if ids.size < 1:
            raise ValueError("empty prompt")
        if resume_from is not None:
            if self.paged_kv is None:
                raise ValueError("resume_from requires a paged_kv pool")
            chain, toks = resume_from
            if chain.frozen:
                raise ValueError("cannot resume from a frozen chain")
            if chain.pool is not self.paged_kv:
                raise ValueError(
                    "resume chain lives in a different pool than this "
                    "engine's")
            if not toks:
                raise ValueError("resume_from needs >= 1 emitted token")
            if chain.length != ids.size + len(toks) - 1:
                raise ValueError(
                    f"resume chain covers {chain.length} positions, "
                    f"expected prompt {ids.size} + {len(toks)} tokens "
                    f"- 1 = {ids.size + len(toks) - 1}")
            if len(toks) >= budget:
                raise ValueError(
                    "resume tokens already meet max_new_tokens")
        if self.block_budget and resume_from is None:
            need = math.ceil((ids.size + budget)
                             / self.paged_kv.block_size)
            if need > self.paged_kv.capacity_blocks:
                raise ValueError(
                    f"prompt {ids.size} + budget {budget} needs {need} "
                    f"KV blocks, beyond the pool's capacity "
                    f"{self.paged_kv.capacity_blocks}")
        if self.draft_module is not None:
            if temperature > 0 and self.top_k > 0:
                # greedy rows ignore top_k, so greedy deployments with a
                # configured top_k keep serving; a SAMPLED row's rejection
                # scheme must accept against the draft's actual proposal
                # distribution, which top_k truncation would change
                raise ValueError(
                    "sampled rows in the speculative engine do not "
                    "compose with engine-level top_k")
            lim = min(self.max_len, self.draft_module.cfg.max_len)
            if ids.size + budget + self.gamma + 1 > lim:
                raise ValueError(
                    f"prompt {ids.size} + max_new_tokens {budget} + "
                    f"gamma+1 {self.gamma + 1} exceeds max_len {lim} "
                    "(a verify block may overshoot the budget)")
        elif ids.size + budget > self.max_len:
            raise ValueError(
                f"prompt {ids.size} + max_new_tokens {budget} exceeds "
                f"max_len {self.max_len}")
        if ids.size > self.max_prompt_len:
            raise ValueError(
                f"prompt {ids.size} exceeds the rolling cache's prefill "
                f"budget {self.max_prompt_len} (capacity - window + 1)")
        if (self.prefill_buckets is not None
                and ids.size > self.prefill_buckets[-1]):
            raise ValueError(
                f"prompt {ids.size} exceeds the largest prefill bucket "
                f"{self.prefill_buckets[-1]}")
        with self._lock:
            self._submitted += 1
            if key is None:
                # per-request seed: the engine seed with a monotonically
                # advancing submit counter (the same contract as the
                # sampling predictor's per-request generators)
                key = (self._seed << 32) + self._submitted
            req = _InFlight(slot=-1, max_new_tokens=budget,
                            eos_token_id=(self.eos_token_id
                                          if eos_token_id is None
                                          else _eos_tuple(eos_token_id)),
                            temperature=float(temperature), key=int(key),
                            t_submit=time.perf_counter(),
                            on_token=on_token, on_done=on_done)
            req.t_submit_wall = time.time()
            req._tsdb = self.tsdb
            req._keep_chain = bool(keep_chain)
            if resume_from is not None:
                chain, toks = resume_from
                req._resume = (chain, [int(t) for t in toks])
                req.resumed = True
            tr = armed_tracer(self.tracer)
            if tr is not None:
                req._tracer = tr
                req.request_id = request_id
                if trace_ctx is not None:
                    # the fleet router owns the `request` root span; the
                    # engine only contributes phase spans under it
                    req.trace_ctx = trace_ctx
                else:
                    req.own_root = True
                    req.parent_ctx = current_context()
                    req.trace_ctx = tr.allocate_context(
                        parent=req.parent_ctx)
                    if not req.request_id:
                        from kubeflow_tpu_torch.serving.requestid import (
                            get_request_id,
                        )

                        req.request_id = get_request_id()
            self._queue.append((ids, req))
        return req

    # ------------------------------------------------------ device work

    def _prompt(self, ids: np.ndarray) -> torch.Tensor:
        """Token ids as the model's (1, L) input."""
        return self._to_device(ids.astype(np.int64))[None, :]

    def _to_device(self, array: np.ndarray) -> torch.Tensor:
        """A host array on the engine's device without waiting for the
        device: a blocking copy from pageable memory synchronizes the
        stream, so the tick's inputs go through pinned memory instead and
        the tick keeps its one read-back."""
        t = torch.from_numpy(np.ascontiguousarray(array))
        if self.device.type != "cuda":
            return t
        return t.pin_memory().to(self.device, non_blocking=True)

    def _prefill(self, ids: np.ndarray):
        """Whole-prompt prefill of a fresh row from position 0, through the
        flash kernel (prefill=True): (last-position logits (1, V), the
        batch-1 row cache)."""
        row = self.module.init_cache(1)
        if self.prefill_buckets is None:
            return self.module(self._prompt(ids), cache=row,
                               prefill=True)[:, -1], row
        # bucketed: pad right, take logits at the TRUE last position, and
        # rewind the index to the true length — pad rows stay invisible
        # under the position mask
        bucket = next((b for b in self.prefill_buckets if b >= ids.size),
                      None)
        if bucket is None:
            raise ValueError(
                f"prompt {ids.size} exceeds the largest prefill bucket "
                f"{self.prefill_buckets[-1]}")
        padded = np.zeros((bucket,), np.int32)
        padded[:ids.size] = ids
        logits = self.module(self._prompt(padded), cache=row, prefill=True)
        set_cache_indices(row, ids.size)
        return logits[:, ids.size - 1], row

    def _draft_prefill(self, ids: np.ndarray):
        """Whole-prompt draft prefill of a fresh row from position 0
        (prefill=True): the batch-1 draft row cache."""
        row = self.draft_module.init_cache(1)
        self.draft_module(self._prompt(ids), cache=row, prefill=True)
        return row

    def _apply_draft_chunk(self, cache, chunk: np.ndarray, prefill: bool):
        """One draft-prefill chunk on a batch-1 draft row cache, advanced
        in place (its logits are never needed at admission)."""
        self.draft_module(self._prompt(chunk), cache=cache, prefill=prefill)

    def _apply_chunk(self, cache, chunk: np.ndarray, prefill: bool):
        """One prefill chunk through the model on a batch-1 row cache,
        advanced in place: its last-position logits (1, V). prefill=True
        only where the row's index is 0 (the flash kernel's rule)."""
        return self.module(self._prompt(chunk), cache=cache,
                           prefill=prefill)[:, -1]

    def _draws(self, probs: torch.Tensor, rows: np.ndarray, keys,
               steps) -> torch.Tensor:
        """One draw per row r of `rows` from probs[i] (its distribution),
        with a generator seeded from (the row's key, steps[r])."""
        drawn = []
        for i, r in enumerate(rows):
            self._sampler.manual_seed(stream_seed(keys[r], int(steps[r])))
            drawn.append(torch.multinomial(probs[i], 1,
                                           generator=self._sampler))
        return torch.cat(drawn)

    def _pick(self, logits: torch.Tensor, temps: np.ndarray, keys,
              steps) -> torch.Tensor:
        """Per-row next token (R,): argmax where temperature == 0, else a
        draw from softmax(logits / temperature) (restricted to the top_k
        logits when the engine sets top_k) with a generator seeded from
        (the row's key, its step)."""
        nxt = logits.argmax(-1)
        rows = np.flatnonzero(temps > 0)
        if rows.size == 0:
            return nxt
        idx = self._to_device(rows)
        scaled = logits[idx] / self._to_device(temps[rows])[:, None]
        if self.top_k > 0:
            kth = torch.topk(scaled, self.top_k, dim=-1).values[..., -1:]
            scaled = torch.where(scaled < kth, -torch.inf, scaled)
        probs = torch.softmax(scaled, dim=-1)
        return nxt.index_copy(0, idx, self._draws(probs, rows, keys, steps))

    def _pick_first(self, last_logits: torch.Tensor, req: _InFlight) -> int:
        """The first token, from the prefill's (1, V) logits: step 0 of
        the row's stream."""
        return int(self._pick(last_logits,
                              np.array([req.temperature], np.float32),
                              [req.key], [0])[0])

    # -------------------------------------------- chunked/seeded prefill

    def _row_cache_template(self):
        from kubeflow_tpu_torch.serving.fleet.pagedkv import make_row_template

        if self._row_template is None:
            self._row_template = make_row_template(self._cache)
        return self._row_template

    def _begin_prefill(self, slot: int, ids: np.ndarray,
                       req: _InFlight) -> None:
        """Seat a row on the chunked/seeded admission path: reuse any
        pooled prefix, then either finish the suffix now (prefill_chunk
        == 0) or leave the row pending for chunk-per-tick advancement.
        With a draft model the draft's batch-1 cache prefills over the
        SAME chunk schedule (the pool stores only target K/V, so the
        draft computes every position — it only shapes acceptance speed,
        never the emitted tokens)."""
        from kubeflow_tpu_torch.serving.fleet.pagedkv import seed_row_cache

        template = self._row_cache_template()
        pos, kv, refs = 0, {}, []
        if self.paged_kv is not None:
            m = self.paged_kv.match(ids)
            # at least one position must run through the model — the row
            # needs the last position's logits to pick its first token
            pos = min(m.length, ids.size - 1)
            if pos > 0:
                kv, refs = m.kv, m.blocks
                self.prefill_tokens_reused += pos
            elif m.blocks:
                self.paged_kv.release(m.blocks)
        cache = seed_row_cache(template, kv, pos)
        if pos > 0 and req._tracer is not None:
            # the prefix-reuse ledger's trace form: these positions were
            # seeded from the paged pool, never computed
            req._tracer.event("engine.prefill_seed", parent=req.trace_ctx,
                              tokens_reused=pos)
        pend = _PendingPrefill(req=req, ids=ids, pos=pos, cache=cache,
                               match_refs=refs)
        if self.draft_module is not None:
            pend.d_cache = self.draft_module.init_cache(1)
        self._pending[slot] = pend
        self._chunk_order.append(slot)
        if not self.prefill_chunk:
            while slot in self._pending:  # suffix in one pass
                self._advance_prefill(slot)

    def _admit_resume(self, slot: int, ids: np.ndarray,
                      req: _InFlight) -> None:
        """Seat a row by RESUMING its paged chain: the pool's gathered
        K/V seeds the whole cache (zero prefill compute — the
        disaggregated handoff / kill-requeue admission), the emitted
        tokens are pre-fed without re-firing callbacks, and decode
        continues from the chain's end. With a draft model the draft
        cache still prefills (chunked) over the known token history —
        draft state is not pooled, but it never changes emitted tokens."""
        from kubeflow_tpu_torch.serving.fleet.pagedkv import seed_row_cache

        chain, toks = req._resume
        full_ids = (np.concatenate([ids, np.asarray(toks[:-1], np.int32)])
                    if len(toks) > 1 else ids)
        _, kv = self.paged_kv.gather(chain.refs)
        cache = seed_row_cache(self._row_cache_template(), kv,
                               chain.length)
        req.tokens = list(toks)      # pre-fed: callbacks never re-fire
        req.t_first = time.perf_counter()   # the resume point, not TTFT
        req.t_first_wall = time.time()
        if req._tracer is not None:
            req._tracer.event(
                "engine.resume", parent=req.trace_ctx,
                resumed_positions=int(chain.length),
                tokens_resumed=len(toks), slot=slot)
        if self.draft_module is not None:
            pend = _PendingPrefill(req=req, ids=full_ids,
                                   pos=len(full_ids), cache=cache,
                                   resume=True)
            pend.d_cache = self.draft_module.init_cache(1)
            self._pending[slot] = pend
            self._chunk_order.append(slot)
            self._row_chains[slot] = chain
            req._resume = None
            if not self.prefill_chunk:
                while slot in self._pending:
                    self._advance_prefill(slot)
            return
        splice_cache_row(self._cache, cache, slot)
        self._toks[slot] = int(toks[-1])
        self._depths[slot] = chain.length
        self._row_chains[slot] = chain
        req._resume = None

    def _advance_prefill(self, slot: int) -> None:
        """Run ONE chunk unit (or the whole remaining work when chunking
        is off) of a pending row: a target chunk while the prompt suffix
        remains, plus a draft chunk while the draft cache lags; completes
        admission when both are done."""
        pend = self._pending[slot]
        whole = not self.prefill_chunk
        if pend.pos < len(pend.ids):
            take = (len(pend.ids) - pend.pos if whole
                    else min(self.prefill_chunk, len(pend.ids) - pend.pos))
            chunk = pend.ids[pend.pos:pend.pos + take]
            # the FIRST computed chunk (no logits yet) carries the seeded
            # reuse count — reused-vs-computed per chunk off the ledger
            reused = pend.pos if pend.last_logits is None else 0
            w0, p0 = time.time(), time.perf_counter()
            pend.last_logits = self._apply_chunk(pend.cache, chunk,
                                                 prefill=pend.pos == 0)
            if pend.req._tracer is not None:
                pend.req._tracer.record_span(
                    "engine.prefill_chunk", w0, time.perf_counter() - p0,
                    parent=pend.req.trace_ctx, tokens_computed=take,
                    tokens_reused=reused, pos=pend.pos + take)
            pend.pos += take
            self.prefill_tokens_total += take
        if pend.d_cache is not None and pend.d_pos < len(pend.ids):
            take = (len(pend.ids) - pend.d_pos if whole
                    else min(self.prefill_chunk,
                             len(pend.ids) - pend.d_pos))
            chunk = pend.ids[pend.d_pos:pend.d_pos + take]
            w0, p0 = time.time(), time.perf_counter()
            self._apply_draft_chunk(pend.d_cache, chunk,
                                    prefill=pend.d_pos == 0)
            if pend.req._tracer is not None:
                # distinct name: draft work is acceptance fuel, not prompt
                # prefill — its tokens stay out of the reuse ledger
                pend.req._tracer.record_span(
                    "engine.draft_prefill_chunk", w0,
                    time.perf_counter() - p0, parent=pend.req.trace_ctx,
                    tokens_computed=take, pos=pend.d_pos + take)
            pend.d_pos += take
        if pend.pos >= len(pend.ids) and (
                pend.d_cache is None or pend.d_pos >= len(pend.ids)):
            self._finish_prefill(slot)

    def _finish_prefill(self, slot: int) -> None:
        """Admission completes: publish the prompt's K/V to the paged
        pool (becoming the row's lifetime block chain), splice the row
        cache into the live batch, emit the first token. Resume rows skip
        publish and first token — their chain and tokens already exist."""
        pend = self._pending.pop(slot)
        self._chunk_order.remove(slot)
        req = pend.req
        if pend.d_cache is not None:
            splice_cache_row(self._dcache, pend.d_cache, slot)
        if pend.resume:
            # the chain is already held in _row_chains; tokens pre-fed
            splice_cache_row(self._cache, pend.cache, slot)
            self._toks[slot] = int(req.tokens[-1])
            self._depths[slot] = len(pend.ids)
            return
        if self.paged_kv is not None:
            from kubeflow_tpu_torch.serving.fleet.pagedkv import (
                SequenceChain,
                extract_prompt_kv,
            )

            kv = extract_prompt_kv(pend.cache, len(pend.ids))
            held = self.paged_kv.insert(pend.ids, kv)
            # insert's refs cover (and extend) the admission match's
            self.paged_kv.release(pend.match_refs)
            # expect_length marks chains that could not cover the whole
            # prompt (insert stopped at a covered-by-sibling boundary)
            # as frozen: release-only, never appended or resumed
            self._row_chains[slot] = SequenceChain(
                self.paged_kv, held, expect_length=len(pend.ids))
        splice_cache_row(self._cache, pend.cache, slot)
        self._depths[slot] = len(pend.ids)
        first = self._pick_first(pend.last_logits, req)
        req.push(first)
        self._toks[slot] = first
        if self._finished(req):
            self._retire(slot)

    def _retire(self, slot: int) -> None:
        req = self._rows[slot]
        self._rows[slot] = None
        chain = self._row_chains.pop(slot, None)
        if chain is not None:
            if req._keep_chain:
                # ownership to the handle's consumer — the disaggregated
                # router adopts the chain for the decode tier
                req.chain = chain
            else:
                chain.release()
        req.finish()

    def _blocks_fit(self, ids: np.ndarray, req: _InFlight) -> bool:
        """Block-budgeted admission check: does the pool's free-block
        count cover this request's worst-case growth (prompt + budget;
        a resume chain already pins its blocks, so only the remaining
        budget counts)? Conservative — prefix reuse can only need
        less."""
        bs = self.paged_kv.block_size
        if req._resume is not None:
            chain, _ = req._resume
            need = math.ceil(max(
                ids.size + req.max_new_tokens - chain.length, 0) / bs)
        else:
            need = math.ceil((ids.size + req.max_new_tokens) / bs)
        return self.paged_kv.available_blocks() >= need

    def _append_decode_kv(self, win: dict[str, torch.Tensor],
                          active: np.ndarray, window: int,
                          counts=None) -> None:
        """Grow each alive row's pool block chain with the positions the
        decode dispatch just wrote: the paged pool stays the KV substrate
        for the WHOLE lifetime, so a killed replica's rows can resume
        from their surviving chains and follow-on turns match into the
        generated suffix. `win` is the dispatch's gathered per-row K/V
        window, already on the host. Rows that retired mid-dispatch
        already released their chain; frozen chains never grow. `counts`
        (a spec round): each row appends only the positions it accepted
        instead of the whole window."""
        for slot in range(self.max_rows):
            if not (active[slot] and self._rows[slot] is not None
                    and slot in self._row_chains
                    and not self._row_chains[slot].frozen):
                continue
            n = window if counts is None else int(counts[slot])
            req = self._rows[slot]
            k = len(req.tokens)
            # position p holds the KV of sequence token p; the window
            # [d, d+n) maps to emitted tokens [k-n-1, k-1) (the dispatch
            # INPUTS — the newest token's KV lands next dispatch)
            ids_seg = req.tokens[k - n - 1:k - 1]
            self._row_chains[slot].append(
                ids_seg, {p: a[slot, :n] for p, a in win.items()})

    @torch.inference_mode()
    def tick(self) -> bool:
        """One scheduling round: admit queued prompts into free rows, then
        advance every in-flight row steps_per_tick tokens. Returns True if
        any work remains.

        Locking: tick() is single-ticker by contract (run_until_idle OR
        the serving thread); rows/cache/toks are ticker-private. The lock
        guards ONLY the shared queue, so submit() from request threads
        never waits behind device work. Inference mode is thread-local,
        so the tick enters it itself."""
        # ---- admission: prefill into free rows ---------------------------
        chunked = self.prefill_chunk > 0 or self.paged_kv is not None
        for slot in range(self.max_rows):
            if self._rows[slot] is not None:
                continue
            with self._lock:
                if not self._queue:
                    break
                if self.block_budget \
                        and not self._blocks_fit(*self._queue[0]):
                    # block-budgeted admission: the pool's free-block
                    # count, not the row slot, is the admission token —
                    # FIFO preserved (head waits, nothing jumps it)
                    break
                ids, req = self._queue.pop(0)
            # seat the row BEFORE device work: a prefill failure must find
            # the request in _rows so _fail_all unblocks its caller
            req.slot = slot
            self._rows[slot] = req
            if req._tracer is not None:
                req._tracer.record_span(
                    "engine.queue_wait", req.t_submit_wall,
                    time.perf_counter() - req.t_submit,
                    parent=req.trace_ctx, slot=slot)
            if req._resume is not None:
                # resume admission: seed the whole cache from the paged
                # chain — zero prefill compute, decode continues
                self._admit_resume(slot, ids, req)
                continue
            if chunked:
                # chunked/seeded path: pooled prefix reuse + (with
                # prefill_chunk) chunk-per-tick interleaving below
                self._begin_prefill(slot, ids, req)
                continue
            w0, p0 = time.time(), time.perf_counter()
            last_logits, row_cache = self._prefill(ids)
            if req._tracer is not None:
                req._tracer.record_span(
                    "engine.prefill_chunk", w0, time.perf_counter() - p0,
                    parent=req.trace_ctx, tokens_computed=ids.size,
                    tokens_reused=0)
            self.prefill_tokens_total += ids.size
            splice_cache_row(self._cache, row_cache, slot)
            if self.draft_module is not None:
                splice_cache_row(self._dcache, self._draft_prefill(ids),
                                 slot)
            self._depths[slot] = ids.size
            first = self._pick_first(last_logits, req)
            req.push(first)
            self._toks[slot] = first
            # the prefill's first token may already finish the row
            if self._finished(req):
                self._retire(slot)
        # ---- chunked prefill: one chunk unit per tick (FIFO over pending
        # rows) so admission work interleaves with — never starves — the
        # decode dispatch below (the one-chunk-budget stall bound). A
        # pure-prefill replica raises max_chunks_per_tick: it has no
        # decode rows to starve.
        chunks = self.max_chunks_per_tick
        while self._chunk_order and chunks > 0:
            self._advance_prefill(self._chunk_order[0])
            chunks -= 1
        active = np.array(
            [r is not None and s not in self._pending
             for s, r in enumerate(self._rows)])
        if not active.any():
            with self._lock:
                return bool(self._queue) or bool(self._pending)
        if self.draft_module is not None:
            return self._spec_tick(active)
        # ---- T decode steps for every in-flight row ----------------------
        temps, keys = self._row_sampling_state()
        starts = np.array([len(r.tokens) if r is not None else 0
                           for r in self._rows], np.int64)
        depths0 = self._depths.copy()  # pre-dispatch: the append window
        # one read per tick: a live-attached tsdb is assigned from another
        # thread, and a torn double-read would record an absolute
        # perf_counter value as a decode-tick sample
        tsdb = self.tsdb
        t_dec = time.perf_counter() if tsdb is not None else 0.0
        T = self.steps_per_tick
        toks = self._to_device(self._toks)
        act = self._to_device(active)
        steps = []
        for j in range(T):
            logits = self.module(toks[:, None], cache=self._cache)[:, 0]
            toks = self._pick(logits, temps, keys, starts + j)
            steps.append(toks)
            # free rows keep decoding garbage (their slot is overwritten
            # wholesale on admission) — their index parks at 0; a row
            # that finished mid-tick decodes on, clamped inside the
            # position table
            set_cache_indices(
                self._cache, self._cache.index.clamp(max=self.max_len - 1),
                act)
        out = torch.stack(steps)                            # (T, R)
        win = None
        if self.paged_kv is not None:
            # the chain-append extraction: one gather per buffer, one
            # copy off the device after the tokens' read-back
            win = torch.stack(list(gather_kv_rows(
                self._cache, self._to_device(depths0), T).values()))
        self.step_count += 1  # dispatches (the scheduling metric)
        out = out.cpu().numpy()  # the tick's one read-back
        if tsdb is not None:
            # the decode-tick SLO series: one sample per dispatch,
            # measured to the host-visible read-back
            tsdb.record("serving.decode_tick_s",
                        time.perf_counter() - t_dec)
        for slot, req in enumerate(self._rows):
            if req is None or slot in self._pending:
                continue  # pending rows decoded garbage; discard
            for j in range(out.shape[0]):
                req.push(int(out[j, slot]))
                self._toks[slot] = int(out[j, slot])
                if self._finished(req):
                    self._retire(slot)  # discard the tick's tail
                    break
        if win is not None:
            self._append_decode_kv(
                dict(zip(cache_paths(len(self._cache.key)), win.cpu())),
                active, out.shape[0])
        self._depths[active] += out.shape[0]
        with self._lock:
            pending = bool(self._queue)
        return pending or any(r is not None for r in self._rows)

    def _spec_tick(self, active: np.ndarray) -> bool:
        """One speculative round for every in-flight row (one dispatch):
        the draft proposes G tokens a row (G chained batch-R steps, plus
        one write of the last proposal), the target verifies (R, G+1) in
        one forward at each row's own index, and each row accepts its own
        prefix and rewinds to its own depth. Greedy rows accept on
        argmax-match; sampled rows run the rejection scheme — accept with
        min(1, p_t/p_d), resample the residual at the first rejection,
        bonus token from p_t. Draws are keyed by (the request's key,
        depth*(G+3)+j): j < G the proposals, G the uniforms, G+1 the
        correction; depth grows every round, so keys never repeat. An
        all-greedy batch computes no softmax and draws nothing."""
        temps, keys = self._row_sampling_state()
        rows = np.flatnonzero(temps > 0)            # the sampled rows
        sampled = rows.size > 0
        tsdb = self.tsdb  # one read: live-attach races a torn pair
        t_dec = time.perf_counter() if tsdb is not None else 0.0
        G, R = self.gamma, self.max_rows
        depths = self._depths.copy()
        key_base = depths * (G + 3)
        dep, act = self._to_device(depths), self._to_device(active)
        # every row's index from its host depth; free and pending rows
        # park at 0 (their slot is overwritten wholesale on admission)
        set_cache_indices(self._cache, dep, act)
        set_cache_indices(self._dcache, dep, act)
        toks = self._to_device(self._toks)
        if sampled:
            idx = self._to_device(rows)
            tp = self._to_device(temps[rows])[:, None]        # (S, 1)
        # ---- the draft proposes G tokens a row -----------------------------
        tok, props, d_probs = toks, [], []
        for j in range(G):
            row = self.draft_module(tok[:, None],
                                    cache=self._dcache)[:, -1]   # (R, V)
            tok = row.argmax(-1)
            if sampled:
                probs = torch.softmax(row[idx] / tp, dim=-1)    # (S, V)
                tok = tok.index_copy(
                    0, idx, self._draws(probs, rows, keys, key_base + j))
                d_probs.append(probs)
            props.append(tok)
        # the extra draft write: an all-accepted round leaves no unwritten
        # draft row below the advanced index
        self.draft_module(tok[:, None], cache=self._dcache)
        props = torch.stack(props, 1)                           # (R, G)
        # ---- the target verifies last + all proposals in ONE pass ----------
        logits = self.module(torch.cat([toks[:, None], props], 1),
                             cache=self._cache)                 # (R, G+1, V)
        t_tokens = logits.argmax(-1)
        ok = props == t_tokens[:, :G]
        if sampled:
            p_t = torch.softmax(logits[idx] / tp[..., None], dim=-1)
            d_p = torch.stack(d_probs, 1)                       # (S, G, V)
            x = props[idx][..., None]
            pt_x = p_t[:, :G].gather(-1, x)[..., 0]
            pd_x = d_p.gather(-1, x)[..., 0]
            u = []
            for r in rows:
                self._sampler.manual_seed(
                    stream_seed(keys[r], int(key_base[r] + G)))
                u.append(torch.rand((G,), generator=self._sampler,
                                    device=self.device))
            ok_s = torch.stack(u) < torch.clamp(
                pt_x / pd_x.clamp_min(1e-30), max=1.0)
            ok = ok.index_copy(0, idx, ok_s)
        a = torch.cumprod(ok.long(), 1).sum(1)                  # (R,)
        corr = t_tokens.gather(1, a[:, None])[:, 0]
        if sampled:
            residual = (p_t[:, :G] - d_p).clamp_min(0.0)
            rs = residual.sum(-1, keepdim=True)
            res_norm = torch.where(rs > 0, residual / rs.clamp_min(1e-30),
                                   p_t[:, :G])
            corr_rows = torch.cat([res_norm, p_t[:, G:]], 1)  # (S, G+1, V)
            picked = corr_rows.gather(1, a[idx][:, None, None].expand(
                -1, 1, corr_rows.shape[-1]))[:, 0]
            corr = corr.index_copy(0, idx, self._draws(
                picked.clamp_min(1e-30), rows, keys, key_base + G + 1))
        padded = torch.cat([props, props.new_zeros((R, 1))], 1)
        upd = torch.where(
            torch.arange(G + 1, device=self.device)[None] < a[:, None],
            padded, corr[:, None])
        new_depths = dep + a + 1
        set_cache_indices(self._cache, new_depths, act)
        set_cache_indices(self._dcache, new_depths, act)
        win = None
        if self.paged_kv is not None:
            # each row's verify pass wrote [depth, depth + G + 1); the
            # accepted a + 1 of them are appended below
            win = torch.stack(list(gather_kv_rows(
                self._cache, dep, G + 1).values()))
        self.step_count += 1  # dispatches (the scheduling metric)
        host = torch.cat([upd, a[:, None]], 1).cpu().numpy()  # one read
        upd, a = host[:, :-1], host[:, -1]
        if tsdb is not None:
            tsdb.record("serving.decode_tick_s",
                        time.perf_counter() - t_dec)
        for slot, req in enumerate(self._rows):
            if req is None or slot in self._pending:
                continue  # pending rows' round output is garbage
            self.spec_proposed += G
            self.spec_accepted += int(a[slot])
            self._depths[slot] += int(a[slot]) + 1
            for j in range(int(a[slot]) + 1):
                req.push(int(upd[slot, j]))
                self._toks[slot] = int(upd[slot, j])
                if self._finished(req):
                    self._retire(slot)  # discard the round's tail
                    break
        if win is not None:
            # each alive row accepted a+1 tokens: its verify pass wrote
            # valid K/V at [depth, depth + a + 1) — append exactly that
            self._append_decode_kv(
                dict(zip(cache_paths(len(self._cache.key)), win.cpu())),
                active, G + 1, counts=a + 1)
        with self._lock:
            pending = bool(self._queue)
        return pending or any(r is not None for r in self._rows)

    def _row_sampling_state(self) -> tuple[np.ndarray, list]:
        """(temps (R,) f32, keys (R,)) from the row table — the ONE
        definition both decode paths (plain tick and _spec_tick) read."""
        temps = np.array([r.temperature if r is not None else 0.0
                          for r in self._rows], np.float32)
        keys = [r.key if r is not None else 0 for r in self._rows]
        return temps, keys

    @staticmethod
    def _finished(req: _InFlight) -> bool:
        if len(req.tokens) >= req.max_new_tokens:
            return True
        return (req.eos_token_id is not None
                and req.tokens[-1] in req.eos_token_id)

    def run_until_idle(self) -> None:
        while self.tick():
            pass

    # ------------------------------------------------------- serving mode

    def start(self) -> "ContinuousBatcher":
        self._stop.clear()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()
        return self

    def _loop(self) -> None:
        while not self._stop.is_set():
            try:
                busy = self.tick()
            except Exception as exc:  # noqa: BLE001 — the engine must
                # survive a poisoned round: fail every request it was
                # carrying (their threads unblock with the error instead
                # of hanging to timeout) and keep serving fresh ones
                self._fail_all(f"{type(exc).__name__}: {exc}")
                busy = False
            if not busy:
                self._stop.wait(0.002)  # idle: poll the queue cheaply

    def _fail_all(self, reason: str) -> None:
        with self._lock:
            queued = [req for _, req in self._queue]
            self._queue.clear()

        def hand_off(req, chain) -> None:
            # a usable chain TRANSFERS to the handle only when a fleet
            # router is listening (it wired this engine and its on_done
            # requeue resumes-or-releases every transferred chain); a
            # direct consumer's on_done has no such contract, so its
            # chain releases and the blocks become reuse inventory
            # instead of leaking pins
            if chain is None:
                return
            if req is not None and req.on_done is not None \
                    and getattr(self, "_fleet_managed", False) \
                    and not chain.frozen:
                req.chain = chain
            else:
                chain.release()

        if self.paged_kv is not None:
            for pend in self._pending.values():
                self.paged_kv.release(pend.match_refs)
            for slot, chain in self._row_chains.items():
                hand_off(self._rows[slot], chain)
            for req in queued:
                if req._resume is not None:
                    chain, _ = req._resume
                    req._resume = None
                    hand_off(req, chain)
        self._pending.clear()
        self._chunk_order.clear()
        self._row_chains.clear()
        for req in queued + [r for r in self._rows if r is not None]:
            req._resume = None
            req.finish(error=reason)
        self._rows = [None] * self.max_rows

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10.0)
            self._thread = None
