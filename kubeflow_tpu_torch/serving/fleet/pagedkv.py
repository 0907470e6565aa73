"""Paged/block KV cache — the single KV substrate for the request lifetime.

The port's own copy of ``kubeflow_tpu/serving/fleet/pagedkv.py``. What
differs: the K/V a block stores are CPU torch tensors in the cache's dtype
(numpy has no bfloat16), keyed per layer and per key/value
(``layer_{i}/key``, ``layer_{i}/value``: ``models.gpt.cache_paths``); token
ids and digests stay numpy; the three cache helpers act on the port's
``KVCache``; the lock is a ``threading.Lock`` and the protocol model
checker's event log is not kept.

Decode is HBM-bandwidth-bound, but PREFILL is compute-bound and scales
with prompt length — and production prompts share long prefixes (the
system prompt, few-shot preambles). The pool pages the K/V store the way
vLLM does, with one TPU-idiomatic twist: the in-engine decode buffer
stays a fixed-row static-shape scratch window (serving/continuous.py —
the shape XLA wants), while the POOL is the store of record for the
whole request lifetime. Prompt blocks land at admission; decode rows
append each generated position's K/V into their chain as they go
(``SequenceChain`` — allocate-on-boundary, COW preserved), so:

  - memory accounting is working-set-proportional: admission can be
    block-budgeted (``available_blocks``) instead of slot-budgeted;
  - a finished prefill's chain can be ADOPTED by another replica
    (``adopt``/``gather`` — the disaggregated prefill/decode handoff);
  - a replica killed mid-decode leaves its chain behind, and the requeue
    RESUMES from the surviving blocks instead of re-decoding from
    scratch (router.py);
  - a follow-on conversation turn whose prompt is the previous prompt +
    completion matches deep into the GENERATED chain, not just the old
    prompt.

The original prefix-reuse contract is unchanged:

  - prompts split into fixed-size BLOCKS (`block_size` tokens); each
    fully-prefilled block's K/V (every layer, rope-rotated, position
    [p0, p1)) is stored once, keyed by the CHAIN HASH of its content —
    sha1(parent_digest + token bytes) — so block identity encodes the
    whole prefix, not just the block's own tokens;
  - the block table is REFCOUNTED: a sequence holds references to the
    blocks its prompt maps to from admission to retire, and eviction
    (LRU, leaf-first) only ever removes unreferenced blocks;
  - divergence is COPY-ON-WRITE: blocks are immutable — two prompts that
    split mid-block simply stop matching at the split, and extending a
    shared partial tail block allocates a new block (``cow_copies``)
    instead of mutating the one the other sequence still references.

On admission the engine asks ``match(ids)``: the longest cached chain
comes back as gathered per-layer K/V, is written into the row cache at
positions [0, shared) with ``cache_index``/``pos_index`` seeded to
`shared`, and the model prefills ONLY the suffix — the per-row index
machinery models/gpt.py keeps for continuous batching makes the seeded
row indistinguishable from one the model prefilled itself. Position
alignment makes the reuse exact: cached K carries its absolute-position
rotation, and a prompt prefix always sits at positions [0, L).

Host-side on purpose: the pool is the fleet tier's shared store (N
engines on N threads hit one pool under one lock), and the tensors only
cross to the device when the admitting engine seeds a row cache (one copy
per admission) or leave it when a prompt or a decode window is published
(one copy each).
"""

from __future__ import annotations

import hashlib
import threading
from dataclasses import dataclass, field

import numpy as np
import torch

from kubeflow_tpu_torch.models.gpt import (
    KVCache,
    cache_buffers,
    cache_paths,
)

#: digest of the empty prefix — the chain root every block hangs off
ROOT = b"kftpu-fleet-root"


def _digest(parent: bytes, ids: np.ndarray) -> bytes:
    return hashlib.sha1(parent + ids.astype(np.int32).tobytes()).digest()


# ------------------------------------------------------ KV-cache helpers


def extract_prompt_kv(row_cache: KVCache,
                      length: int) -> dict[str, torch.Tensor]:
    """Per-position K/V of a batch-1 row cache's first `length` positions:
    {``layer_{i}/key|value`` -> (length, kv_heads, head_dim) CPU tensor},
    moved off the device in one copy. The pool stores slices of these."""
    host = torch.stack([buf[0, :length]
                        for buf in cache_buffers(row_cache)]).cpu()
    return dict(zip(cache_paths(len(row_cache.key)), host))


def make_row_template(live_cache: KVCache) -> KVCache:
    """Batch-1 zeroed twin of the engine's live cache, on its device — the
    starting point for a seeded (prefix-reused) or chunked prefill."""
    def zero(bufs):
        return [torch.zeros((1,) + b.shape[1:], dtype=b.dtype,
                            device=b.device) for b in bufs]

    return KVCache(key=zero(live_cache.key), value=zero(live_cache.value),
                   index=torch.zeros_like(live_cache.index[:1]))


def seed_row_cache(template: KVCache, kv: dict[str, torch.Tensor],
                   shared: int) -> KVCache:
    """Fresh batch-1 row cache with the pool's gathered K/V written at
    positions [0, shared) (one copy to the device) and its index set to
    `shared` — exactly the state a one-shot prefill of those tokens leaves
    behind, so the suffix prefill continues seamlessly. With shared == 0
    it is a zeroed copy of the template."""
    cache = KVCache(key=[torch.zeros_like(b) for b in template.key],
                    value=[torch.zeros_like(b) for b in template.value],
                    index=torch.full_like(template.index, shared))
    if shared:
        paths = cache_paths(len(cache.key))
        dev = torch.stack([kv[p][:shared] for p in paths]).to(
            cache.key[0].device)
        for buf, part in zip(cache_buffers(cache), dev):
            buf[0, :shared] = part
    return cache


# ------------------------------------------------------------------ pool


@dataclass
class _Block:
    digest: bytes
    parent: bytes
    ids: np.ndarray                      # (n,) int32, n <= block_size
    kv: dict[str, torch.Tensor]          # path -> (n, kvh, d), CPU
    full: bool
    refcount: int = 0
    last_used: int = 0
    children: set = field(default_factory=set)


@dataclass
class PrefixMatch:
    """Result of PagedKVPool.match: `length` cached positions, gathered
    K/V per leaf path, and the block refs the caller now holds (release
    via PagedKVPool.release when the sequence retires)."""

    length: int
    kv: dict[str, torch.Tensor]
    blocks: list[bytes]


class PagedKVPool:
    """Refcounted block table over prompt-prefix K/V (module docstring)."""

    def __init__(self, block_size: int = 8, capacity_blocks: int = 1024):
        if block_size < 1:
            raise ValueError(f"block_size must be >= 1, got {block_size}")
        if capacity_blocks < 1:
            raise ValueError(
                f"capacity_blocks must be >= 1, got {capacity_blocks}")
        self.block_size = int(block_size)
        self.capacity_blocks = int(capacity_blocks)
        self._table: dict[bytes, _Block] = {}
        self._clock = 0
        #: blocks with refcount > 0, maintained incrementally on every
        #: 0<->1 transition (_ref/_unref/_drop) — the block-budgeted
        #: admission gate and the blocks_in_use gauge read it O(1)
        #: instead of scanning the table under the shared pool lock on
        #: every admission attempt
        self._pinned = 0
        self._mu = threading.Lock()
        self.metrics = {
            "blocks_cached": 0,
            "blocks_evicted_total": 0,
            "blocks_reused_total": 0,
            "tokens_reused_total": 0,
            "cow_copies_total": 0,
        }

    # ------------------------------------------------------- block budget

    def blocks_in_use(self) -> int:
        """Blocks some live sequence still references — the pinned
        working set (the ``kftpu_fleet_kv_blocks_in_use`` gauge).
        Unreferenced cached blocks are reuse inventory, not use: they
        evict on demand."""
        with self._mu:
            return self._pinned

    def available_blocks(self) -> int:
        """Blocks a new sequence could claim right now: capacity minus
        the pinned working set (cached-but-unreferenced blocks evict on
        demand, so they count as available). The engine's block-budgeted
        admission gate reads this instead of counting row slots."""
        with self._mu:
            return max(self.capacity_blocks - self._pinned, 0)

    def _ref(self, blk: _Block) -> None:
        """Acquire one reference under self._mu (the ONE increment
        path: keeps the pinned counter exact on 0->1)."""
        blk.refcount += 1
        if blk.refcount == 1:
            self._pinned += 1
        blk.last_used = self._clock

    def _unref(self, blk: _Block) -> None:
        """Drop one reference under self._mu (exact on 1->0)."""
        if blk.refcount > 0:
            blk.refcount -= 1
            if blk.refcount == 0:
                self._pinned -= 1

    # ------------------------------------------------------------- match

    def match(self, ids) -> PrefixMatch:
        """Longest cached prefix of `ids`: full-block chain first, then at
        most one partial tail block whose content is a prefix of the
        remainder. Acquires one reference per matched block."""
        ids = np.asarray(ids, np.int32).reshape(-1)
        with self._mu:
            self._clock += 1
            parent = ROOT
            blocks: list[_Block] = []
            pos = 0
            while pos + self.block_size <= ids.size:
                d = _digest(parent, ids[pos:pos + self.block_size])
                blk = self._table.get(d)
                if blk is None or not blk.full:
                    break
                blocks.append(blk)
                parent = d
                pos += self.block_size
            # partial tail: the longest child of the last matched block
            # whose tokens prefix the remaining ids (COW keeps several
            # divergent partials alive side by side — pick the best)
            tail: _Block | None = None
            rest = ids[pos:]
            siblings = (self._root_children() if parent == ROOT
                        else self._table[parent].children)
            for child_d in list(siblings):
                child = self._table.get(child_d)
                if child is None or child.full or child.ids.size > rest.size:
                    continue
                if np.array_equal(child.ids, rest[:child.ids.size]) and (
                        tail is None or child.ids.size > tail.ids.size):
                    tail = child
            if tail is not None:
                blocks.append(tail)
                pos += tail.ids.size
            for blk in blocks:
                self._ref(blk)
            kv: dict[str, torch.Tensor] = {}
            if blocks:
                for path in blocks[0].kv:
                    kv[path] = torch.cat([b.kv[path] for b in blocks])
                self.metrics["blocks_reused_total"] += len(blocks)
                self.metrics["tokens_reused_total"] += pos
            return PrefixMatch(length=pos, kv=kv,
                               blocks=[b.digest for b in blocks])

    def _root_children(self):
        return [d for d, b in self._table.items() if b.parent == ROOT]

    # ------------------------------------------------------------ insert

    def insert(self, ids, kv: dict[str, torch.Tensor]) -> list[bytes]:
        """Store the prompt's blocks (full blocks plus one partial tail)
        from its per-position K/V, sharing any blocks already cached.
        Extending a cached partial block that other sequences still
        reference allocates a NEW block (copy-on-write) — blocks are
        immutable once published. Returns held block refs."""
        ids = np.asarray(ids, np.int32).reshape(-1)
        with self._mu:
            self._clock += 1
            parent = ROOT
            held: list[bytes] = []
            pos = 0
            while pos < ids.size:
                take = min(self.block_size, ids.size - pos)
                chunk = ids[pos:pos + take]
                d = _digest(parent, chunk)
                blk = self._table.get(d)
                if blk is None:
                    prev = self._table.get(parent)
                    if prev is not None and not prev.full:
                        # can't chain off a partial block — stop here
                        break
                    blk = _Block(
                        digest=d, parent=parent, ids=chunk.copy(),
                        kv={p: a[pos:pos + take].clone()
                            for p, a in kv.items()},
                        full=take == self.block_size,
                    )
                    if self._covered_by_sibling(blk):
                        # a longer partial with the same content prefix
                        # already exists — adding this one only splits
                        # future matches
                        break
                    if any(self._prefixed_partial(blk)):
                        # the new block EXTENDS a partial some sequence
                        # still references: publish beside it instead of
                        # mutating it — copy-on-write on divergence
                        self.metrics["cow_copies_total"] += 1
                    self._table[d] = blk
                    if parent != ROOT:
                        self._table[parent].children.add(d)
                    self.metrics["blocks_cached"] = len(self._table)
                self._ref(blk)
                held.append(d)
                if not blk.full:
                    break  # a partial tail ends the chain by definition
                parent = d
                pos += take
            self._evict_to_capacity()
            return held

    def _prefixed_partial(self, blk: _Block):
        """Live partial siblings whose content is a strict prefix of
        `blk` — the blocks a naive in-place extension would corrupt."""
        sibs = (self._table[blk.parent].children if blk.parent != ROOT
                else self._root_children())
        for d in list(sibs):
            sib = self._table.get(d)
            if sib is not None and not sib.full and sib.refcount > 0 \
                    and sib.ids.size < blk.ids.size \
                    and np.array_equal(sib.ids, blk.ids[:sib.ids.size]):
                yield sib

    def _covered_by_sibling(self, blk: _Block) -> bool:
        """True when an existing partial sibling already stores `blk`'s
        exact content as its prefix (so matching uses the longer one)."""
        sibs = (self._table[blk.parent].children if blk.parent != ROOT
                else self._root_children())
        for d in sibs:
            sib = self._table.get(d)
            if sib is not None and not sib.full \
                    and sib.ids.size >= blk.ids.size \
                    and np.array_equal(sib.ids[:blk.ids.size], blk.ids):
                return True
        return False

    def extend(self, ref: bytes, ids,
               kv: dict[str, torch.Tensor]) -> bytes:
        """Grow a held partial block with more positions. Shared blocks
        (refcount > 1) are copied first — copy-on-write on divergence —
        so the other holders keep matching the block they admitted
        against. Returns the (possibly new) held ref."""
        ids = np.asarray(ids, np.int32).reshape(-1)
        with self._mu:
            self._clock += 1
            blk = self._table.get(ref)
            if blk is None:
                raise KeyError("unknown block ref")
            if blk.full:
                raise ValueError("cannot extend a full block")
            if blk.ids.size + ids.size > self.block_size:
                raise ValueError(
                    f"extension {ids.size} overflows block "
                    f"(have {blk.ids.size}, block_size {self.block_size})")
            new_ids = np.concatenate([blk.ids, ids])
            d = _digest(blk.parent, new_ids)
            existing = self._table.get(d)
            if existing is not None:
                # the identical extension is already published (two rows
                # decoding the same continuation off a shared tail):
                # SHARE it — overwriting would orphan its holders'
                # refcounts and a later sole-holder extend would drop a
                # block someone still references
                self._ref(existing)
                if blk.refcount > 1:
                    self._unref(blk)
                else:
                    self._drop(blk)
                self.metrics["blocks_cached"] = len(self._table)
                return d
            new = _Block(
                digest=d, parent=blk.parent, ids=new_ids,
                kv={p: torch.cat([blk.kv[p], kv[p]]) for p in blk.kv},
                full=new_ids.size == self.block_size,
            )
            cow = blk.refcount > 1
            if cow:
                # shared: publish the extension beside the original
                self.metrics["cow_copies_total"] += 1
                self._unref(blk)
            else:
                # sole holder: the original entry retires with us
                self._drop(blk)
            self._table[d] = new
            self._ref(new)
            if blk.parent != ROOT:
                self._table[blk.parent].children.add(d)
            self.metrics["blocks_cached"] = len(self._table)
            self._evict_to_capacity()
            return d

    def append_child(self, parent: bytes, ids,
                     kv: dict[str, torch.Tensor]) -> bytes:
        """Publish ONE new block (partial or full) as a child of `parent`
        (a held FULL block, or ROOT) and acquire a reference on it — the
        decode-growth allocation path (SequenceChain.append calls this at
        every block boundary). An identical block already cached is
        shared instead of duplicated (two greedy decodes of the same
        prompt converge onto one chain); publishing beside a live partial
        whose content this block extends counts a COW copy exactly like
        insert()'s divergence path."""
        ids = np.asarray(ids, np.int32).reshape(-1)
        if not 0 < ids.size <= self.block_size:
            raise ValueError(
                f"block of {ids.size} tokens (block_size "
                f"{self.block_size})")
        with self._mu:
            self._clock += 1
            if parent != ROOT:
                par = self._table.get(parent)
                if par is None:
                    raise KeyError("unknown parent block ref")
                if not par.full:
                    raise ValueError("cannot chain off a partial block")
            d = _digest(parent, ids)
            blk = self._table.get(d)
            if blk is None:
                blk = _Block(
                    digest=d, parent=parent, ids=ids.copy(),
                    kv={p: a[:ids.size].clone() for p, a in kv.items()},
                    full=ids.size == self.block_size,
                )
                if any(self._prefixed_partial(blk)):
                    self.metrics["cow_copies_total"] += 1
                self._table[d] = blk
                if parent != ROOT:
                    self._table[parent].children.add(d)
                self.metrics["blocks_cached"] = len(self._table)
            self._ref(blk)
            self._evict_to_capacity()
            return d

    # ------------------------------------------------- adoption / gather

    def adopt(self, refs: list[bytes]) -> None:
        """Acquire one additional reference per block of a chain BY
        DIGEST — the disaggregated handoff's contract: a prefill replica
        publishes its finished chain, and a decode replica (in another
        process, eventually) re-acquires it from the digests alone.
        Raises KeyError if any block is gone (the publisher must hold its
        own refs until the adopter confirms)."""
        with self._mu:
            self._clock += 1
            blocks = []
            for d in refs:
                blk = self._table.get(d)
                if blk is None:
                    raise KeyError("chain block evicted before adoption")
                blocks.append(blk)
            for blk in blocks:
                self._ref(blk)

    def gather(self, refs: list[bytes]):
        """Materialize a held chain: (token ids, per-leaf concatenated
        K/V) over every position the chain covers — what seeds a decode
        replica's row cache on adoption or resume. The caller must hold
        references on every block (adopt/insert/append_child)."""
        with self._mu:
            self._clock += 1
            blocks = []
            for d in refs:
                blk = self._table.get(d)
                if blk is None:
                    raise KeyError("unknown block ref")
                blk.last_used = self._clock
                blocks.append(blk)
        if not blocks:
            return np.zeros((0,), np.int32), {}
        # concatenate OUTSIDE the pool lock: blocks are immutable once
        # published and the snapshot above keeps them alive, while this
        # copy is the largest single memory op in the pool (a whole
        # request's K/V) — holding _mu here would stall every other
        # replica's admission/append hot path behind each handoff
        ids = np.concatenate([b.ids for b in blocks])
        kv = {p: torch.cat([b.kv[p] for b in blocks]) for p in blocks[0].kv}
        return ids, kv

    def chain_info(self, refs: list[bytes]) -> tuple[int, int]:
        """(total positions, positions in the partial tail — 0 when the
        chain ends on a full block) for a held chain."""
        with self._mu:
            total = tail = 0
            for d in refs:
                blk = self._table[d]
                total += blk.ids.size
                tail = 0 if blk.full else blk.ids.size
            return total, tail

    # ----------------------------------------------------------- release

    def release(self, refs: list[bytes]) -> None:
        """Drop the references a retired sequence held; unreferenced
        blocks stay cached (that is the reuse) until LRU eviction."""
        with self._mu:
            for d in refs:
                blk = self._table.get(d)
                if blk is not None:
                    self._unref(blk)
            self._evict_to_capacity()

    def _drop(self, blk: _Block) -> None:
        if blk.refcount > 0:
            # a still-held block leaving the table (extend's sole-holder
            # retire-with-us path) leaves the pinned set too
            self._pinned -= 1
        self._table.pop(blk.digest, None)
        parent = self._table.get(blk.parent)
        if parent is not None:
            parent.children.discard(blk.digest)

    def _evict_to_capacity(self) -> None:
        """LRU, leaf-first: only unreferenced childless blocks leave, so
        a live sequence's chain (and any chain it hangs off) survives."""
        while len(self._table) > self.capacity_blocks:
            victims = [b for b in self._table.values()
                       if b.refcount == 0 and not b.children]
            if not victims:
                return  # everything evictable is pinned — over-capacity
            victim = min(victims, key=lambda b: b.last_used)
            self._drop(victim)
            self.metrics["blocks_evicted_total"] += 1
        self.metrics["blocks_cached"] = len(self._table)

    # ------------------------------------------------------------- debug

    def refcounts(self) -> dict[bytes, int]:
        with self._mu:
            return {d: b.refcount for d, b in self._table.items()}

    def __len__(self) -> int:
        with self._mu:
            return len(self._table)


# ------------------------------------------------------- sequence chains


class SequenceChain:
    """A decode row's held block chain over its WHOLE lifetime (prompt +
    generated tokens) — the per-row block table the engine keeps while
    the row is in flight.

    Ownership travels with the object: the admitting engine builds it
    from insert()'s held refs, appends each decode dispatch's new K/V
    (allocate-on-boundary: the partial tail extends via the pool's
    COW-safe ``extend`` until full, then a fresh child block via
    ``append_child``), and releases it at retire. On a replica kill the
    engine transfers the chain to the request handle instead of
    releasing, and the router hands it to the surviving replica — whose
    resume admission seeds its row cache from ``pool.gather`` and keeps
    appending to the same object.

    ``frozen`` marks a chain that could not cover every cached position
    (insert stopped early at a covered-by-sibling or partial-parent
    boundary): it releases normally but never appends and never resumes
    — the requeue path falls back to re-decoding from scratch.
    """

    def __init__(self, pool: PagedKVPool, refs: list[bytes],
                 expect_length: int | None = None):
        self.pool = pool
        self.refs = list(refs)
        self.length, self._tail_len = pool.chain_info(self.refs)
        self.frozen = (expect_length is not None
                       and self.length != expect_length)

    def append(self, ids, kv: dict[str, torch.Tensor]) -> None:
        """Append `len(ids)` generated positions' K/V to the chain —
        `kv` maps leaf path -> (n, kv_heads, head_dim). Fills the partial
        tail first (pool.extend: COW when another sequence shares it),
        then allocates fresh blocks at each boundary."""
        if self.frozen:
            raise ValueError("cannot append to a frozen chain")
        ids = np.asarray(ids, np.int32).reshape(-1)
        bs = self.pool.block_size
        i = 0
        while i < ids.size:
            if self._tail_len:
                take = min(bs - self._tail_len, ids.size - i)
                self.refs[-1] = self.pool.extend(
                    self.refs[-1], ids[i:i + take],
                    {p: a[i:i + take] for p, a in kv.items()})
                self._tail_len += take
            else:
                take = min(bs, ids.size - i)
                parent = self.refs[-1] if self.refs else ROOT
                self.refs.append(self.pool.append_child(
                    parent, ids[i:i + take],
                    {p: a[i:i + take] for p, a in kv.items()}))
                self._tail_len = take
            if self._tail_len == bs:
                self._tail_len = 0
            i += take
            self.length += take

    def release(self) -> None:
        self.pool.release(self.refs)
        self.refs = []
        self.length = 0
        self._tail_len = 0

