"""In-memory datasets and the host input pipeline — own copy of the parts of
``kubeflow_tpu/train/data.py`` the Trainer and the model families use.

Batches are host numpy, made from a seed exactly as the JAX package makes
them (every dataset, ``mask_tokens_for_mlm`` and ``batches`` give
bit-identical arrays),
and moved to the model's device at the step: pinned host memory and
``non_blocking`` copies on a card, so the copy of the next batch overlaps the
current step. A gang's processes load disjoint shard files
(``save_dataset_shards``/``load_dataset_shards``, the JAX package's format).
"""

from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Iterator

import numpy as np
import torch


@dataclass
class Dataset:
    x_train: np.ndarray
    y_train: np.ndarray
    x_test: np.ndarray
    y_test: np.ndarray
    num_classes: int

    @property
    def input_shape(self) -> tuple[int, ...]:
        return self.x_train.shape[1:]


def load_digits_dataset(test_fraction: float = 0.2, seed: int = 0) -> Dataset:
    """sklearn digits, normalized to [0,1], deterministic split (needs
    sklearn, imported here)."""
    from sklearn.datasets import load_digits

    d = load_digits()
    x = (d.data / 16.0).astype(np.float32)
    y = d.target.astype(np.int32)
    rng = np.random.RandomState(seed)
    perm = rng.permutation(len(x))
    x, y = x[perm], y[perm]
    n_test = int(len(x) * test_fraction)
    return Dataset(
        x_train=x[n_test:], y_train=y[n_test:],
        x_test=x[:n_test], y_test=y[:n_test],
        num_classes=10,
    )


def synthetic_image_dataset(
    n_train: int = 1024,
    n_test: int = 256,
    shape: tuple[int, ...] = (28, 28, 1),
    num_classes: int = 10,
    seed: int = 0,
) -> Dataset:
    """Procedural image classification set with learnable class structure:
    each class is a fixed random template + noise, so accuracy is
    meaningful."""
    rng = np.random.RandomState(seed)
    templates = rng.normal(0, 1, size=(num_classes, *shape)).astype(
        np.float32)

    def make(n: int) -> tuple[np.ndarray, np.ndarray]:
        y = rng.randint(0, num_classes, size=n).astype(np.int32)
        x = templates[y] + rng.normal(0, 0.5, size=(n, *shape)).astype(
            np.float32)
        return x.astype(np.float32), y

    x_tr, y_tr = make(n_train)
    x_te, y_te = make(n_test)
    return Dataset(x_tr, y_tr, x_te, y_te, num_classes)


def synthetic_text_dataset(
    n_train: int = 1024,
    n_test: int = 256,
    seq_len: int = 128,
    vocab_size: int = 1024,
    num_classes: int = 2,
    pad_token_id: int = 0,
    seed: int = 0,
) -> Dataset:
    """Token-sequence classification set with learnable class structure:
    each class draws tokens from its own skewed unigram distribution, with
    random-length tail padding so padding masks are exercised."""
    rng = np.random.RandomState(seed)
    # class-specific token distributions over [1, vocab) (0 reserved for pad)
    logits = rng.normal(0, 1.5, size=(num_classes, vocab_size - 1))
    probs = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)

    def make(n: int) -> tuple[np.ndarray, np.ndarray]:
        y = rng.randint(0, num_classes, size=n).astype(np.int32)
        x = np.zeros((n, seq_len), np.int32)
        for i in range(n):
            length = rng.randint(seq_len // 2, seq_len + 1)
            x[i, :length] = rng.choice(
                vocab_size - 1, size=length, p=probs[y[i]]
            ) + 1
        x[:, :] = np.where(x == 0, pad_token_id, x)
        return x, y

    x_tr, y_tr = make(n_train)
    x_te, y_te = make(n_test)
    return Dataset(x_tr, y_tr, x_te, y_te, num_classes)


def synthetic_lm_dataset(
    n_train: int = 512,
    n_test: int = 128,
    seq_len: int = 128,
    vocab_size: int = 512,
    seed: int = 0,
    noise: float = 0.1,
) -> Dataset:
    """Causal-LM set with learnable structure: a noisy affine token chain
    (next = (a·tok + b) mod (V-1) + 1), so next-token loss is reducible.
    Labels ARE the inputs — models.gpt.causal_lm_loss shifts internally."""
    rng = np.random.RandomState(seed)
    a, b = 31, 17  # coprime with vocab-1 keeps the chain full-period-ish

    def make(n: int) -> tuple[np.ndarray, np.ndarray]:
        x = np.zeros((n, seq_len), np.int32)
        x[:, 0] = rng.randint(1, vocab_size, size=n)
        for t in range(1, seq_len):
            nxt = (x[:, t - 1] * a + b) % (vocab_size - 1) + 1
            flip = rng.rand(n) < noise
            nxt[flip] = rng.randint(1, vocab_size, size=flip.sum())
            x[:, t] = nxt
        return x, x.copy()

    x_tr, y_tr = make(n_train)
    x_te, y_te = make(n_test)
    return Dataset(x_tr, y_tr, x_te, y_te, num_classes=vocab_size)


# positions excluded from token-level objectives (HF convention)
IGNORE_LABEL = -100


def mask_tokens_for_mlm(
    x: np.ndarray,
    vocab_size: int,
    mask_token_id: int,
    mask_prob: float = 0.15,
    pad_token_id: int = 0,
    seed: int = 0,
) -> tuple[np.ndarray, np.ndarray]:
    """BERT MLM corruption: of the selected positions, 80% become [MASK],
    10% a random token drawn from [1, vocab_size), 10% unchanged; labels
    carry the ORIGINAL ids at selected positions and IGNORE_LABEL
    elsewhere. Pass the DATA vocab (excluding the mask id) as vocab_size so
    random replacements never draw the sentinel."""
    rng = np.random.RandomState(seed)
    labels = np.full_like(x, IGNORE_LABEL)
    corrupted = x.copy()
    selectable = x != pad_token_id
    selected = (rng.rand(*x.shape) < mask_prob) & selectable
    labels[selected] = x[selected]
    roll = rng.rand(*x.shape)
    corrupted[selected & (roll < 0.8)] = mask_token_id
    rand_repl = selected & (roll >= 0.8) & (roll < 0.9)
    random_ids = rng.randint(1, vocab_size, size=x.shape)
    corrupted[rand_repl] = random_ids[rand_repl]
    return corrupted, labels


def batches(
    x: np.ndarray,
    y: np.ndarray,
    batch_size: int,
    *,
    seed: int | None = None,
    drop_remainder: bool = True,
) -> Iterator[tuple[np.ndarray, np.ndarray]]:
    """One epoch of (x, y) minibatches; static shapes when drop_remainder."""
    n = len(x)
    idx = np.arange(n)
    if seed is not None:
        np.random.RandomState(seed).shuffle(idx)
    stop = (n // batch_size) * batch_size if drop_remainder else n
    for i in range(0, stop, batch_size):
        sl = idx[i : i + batch_size]
        yield x[sl], y[sl]


def steps_per_epoch(n: int, batch_size: int) -> int:
    return n // batch_size


def to_device(batch, device: torch.device):
    """A tuple of host arrays as tensors on ``device``: on a card through
    pinned memory with non_blocking copies, on the CPU as views."""
    device = torch.device(device)
    out = []
    for a in batch:
        t = torch.as_tensor(a)
        if device.type == "cuda":
            t = t.pin_memory().to(device, non_blocking=True)
        out.append(t)
    return tuple(out)


def prefetch_to_device(it: Iterator, transform, size: int = 2) -> Iterator:
    """Double-buffering host->device prefetch: the copy of the next batch
    is enqueued before the current one is handed over, so it overlaps the
    step (``size=2`` is classic double buffering). ``transform`` takes a
    host batch to its part on the device (``to_device``'s copy, or the
    Trainer's ``_upload``: a gang member's rows and tokens)."""
    buf: deque = deque()
    for b in it:
        buf.append(transform(b))
        if len(buf) >= size:
            yield buf.popleft()
    while buf:
        yield buf.popleft()


class _LoaderStop(Exception):
    """Internal: consumer closed while the producer was blocked."""


class AsyncLoader:
    """Background-thread host input pipeline: batch assembly and the copy
    to the device off the step critical path.

    Pulls items from `src` on a worker thread, applies `transform` (the
    host work — e.g. ``to_device``, whose copies are non_blocking, so the
    transfer also starts ahead of consumption), and hands results over a
    bounded queue. Contract:

      - iteration order and content are EXACTLY `transform(x) for x in
        src` — the thread moves work, never semantics;
      - a producer-side exception is re-raised on the CONSUMING thread at
        the position it occurred: never swallowed;
      - `close()` (or exhaustion) joins the worker — an early-exiting
        consumer leaks no thread; idempotent, safe from `finally`;
      - per-batch timing lands on `last_wait_s` (consumer blocked time:
        what the step critical path paid) and `last_assemble_s` (producer
        host work, overlapped), which the trainer stamps on its
        `train.data_load` spans (`pop_stats`).
    """

    def __init__(
        self,
        src: Iterator,
        transform: Callable | None = None,
        size: int = 2,
        name: str = "train.loader",
    ):
        self._src = iter(src)
        self._transform = transform
        self._size = max(1, size)
        self._mu = threading.Lock()
        self._not_empty = threading.Condition(self._mu)
        self._not_full = threading.Condition(self._mu)
        self._buf: list = []          # bounded by _size
        self._done = False            # producer exhausted src
        self._stopped = False         # consumer closed
        self._exc: BaseException | None = None
        self.last_wait_s = 0.0
        self.last_assemble_s = 0.0
        self._thread = threading.Thread(
            target=self._run, name=f"kftpu-{name}", daemon=True)
        self._thread.start()

    # ------------------------------------------------------------ producer

    def _run(self) -> None:
        try:
            self._produce()
        except _LoaderStop:
            # consumer closed early — normal shutdown; still mark done so
            # a straggling next() can never block on a dead producer
            with self._mu:
                self._done = True
                self._not_empty.notify_all()
        except BaseException as e:  # noqa: BLE001 — carried to the consumer
            with self._mu:
                self._exc = e
                self._done = True
                self._not_empty.notify_all()
        else:
            with self._mu:
                self._done = True
                self._not_empty.notify_all()

    def _produce(self) -> None:
        for item in self._src:
            t0 = time.perf_counter()
            out = self._transform(item) if self._transform else item
            dt = time.perf_counter() - t0
            with self._mu:
                while len(self._buf) >= self._size and not self._stopped:
                    self._not_full.wait(timeout=0.1)
                if self._stopped:
                    raise _LoaderStop
                self._buf.append((out, dt))
                self._not_empty.notify()

    # ------------------------------------------------------------ consumer

    def __iter__(self) -> "AsyncLoader":
        return self

    def __next__(self):
        t0 = time.perf_counter()
        with self._mu:
            while not self._buf and not self._done:
                self._not_empty.wait(timeout=0.1)
            if not self._buf:
                exc = self._exc
                self._exc = None
                if exc is not None:
                    raise exc  # the producer's failure, on OUR thread
                raise StopIteration
            out, self.last_assemble_s = self._buf.pop(0)
            self._not_full.notify()
        self.last_wait_s = time.perf_counter() - t0
        return out

    def pop_stats(self) -> dict[str, float]:
        """Timing of the most recent batch: wait (on the critical path) and
        assemble (the overlapped producer work)."""
        return {"wait_s": self.last_wait_s,
                "assemble_s": self.last_assemble_s}

    def close(self) -> None:
        """Stop the producer and JOIN its thread (no daemon leak); safe to
        call repeatedly and after exhaustion. The bounded buffer is
        dropped — a closing consumer wants out, not the backlog (a
        straggling next() gets StopIteration, never a stale pre-close
        batch)."""
        with self._mu:
            self._stopped = True
            self._buf.clear()
            self._not_full.notify_all()
            self._not_empty.notify_all()
        self._thread.join(timeout=30.0)

    def __enter__(self) -> "AsyncLoader":
        return self

    def __exit__(self, *exc) -> bool:
        self.close()
        return False


# ------------------------------------------------------------- sharded files

def save_dataset_shards(ds: Dataset, out_dir: str, num_shards: int = 8) -> str:
    """Write a Dataset as numbered .npz shards + manifest: the on-disk
    contract a gang loads per process (the unit is a shard FILE, so no two
    processes read the same rows). The JAX package's format."""
    import json

    d = Path(out_dir)
    d.mkdir(parents=True, exist_ok=True)
    n = len(ds.x_train)
    num_shards = max(1, min(num_shards, n))
    bounds = np.linspace(0, n, num_shards + 1, dtype=int)
    for i in range(num_shards):
        lo, hi = bounds[i], bounds[i + 1]
        np.savez(d / f"train-{i:05d}.npz",
                 x=ds.x_train[lo:hi], y=ds.y_train[lo:hi])
    np.savez(d / "test.npz", x=ds.x_test, y=ds.y_test)
    (d / "manifest.json").write_text(json.dumps({
        "num_shards": num_shards,
        "num_classes": int(ds.num_classes),
        "n_train": int(n),
    }))
    return str(d)


def load_dataset_shards(data_dir: str, process_id: int | None = None,
                        num_processes: int | None = None,
                        mesh=None) -> Dataset:
    """Load a sharded dataset, taking only THIS process's shard files
    (round-robin by index) in a gang, each process a disjoint subset.
    Defaults to the live ``torch.distributed`` gang's rank and size; (0,
    1) outside one. With the gang's ``mesh`` (a ``MeshConfig`` or
    ``parallel.mesh.Mesh``) they default to this rank's position in the
    batch split and the split's size instead, so the context ranks of one
    data index, which split the same rows' positions, take the same files.
    Every process ends with the same row count (the smallest share), so
    the gang's step counts stay in lockstep. The test split is replicated
    to every process."""
    import json

    if (process_id is None) != (num_processes is None):
        raise ValueError(
            "pass BOTH process_id and num_processes, or neither (the live "
            "torch.distributed gang)"
        )
    if process_id is None and mesh is not None:
        from kubeflow_tpu_torch.parallel.mesh import Mesh, build_mesh
        from kubeflow_tpu_torch.parallel.sharding import data_index

        process_id, num_processes = data_index(
            mesh if isinstance(mesh, Mesh) else build_mesh(mesh))
    if process_id is None:
        import torch.distributed as dist

        gang = dist.is_available() and dist.is_initialized()
        process_id = dist.get_rank() if gang else 0
        num_processes = dist.get_world_size() if gang else 1
    d = Path(data_dir)
    meta = json.loads((d / "manifest.json").read_text())
    num_shards = int(meta["num_shards"])
    if num_shards < num_processes:
        raise ValueError(
            f"{num_shards} shard(s) cannot feed {num_processes} processes; "
            f"re-shard with num_shards >= the gang size"
        )
    bounds = np.linspace(0, int(meta["n_train"]), num_shards + 1, dtype=int)
    sizes = bounds[1:] - bounds[:-1]
    limit = min(
        int(sizes[p::num_processes].sum()) for p in range(num_processes)
    )
    xs, ys = [], []
    for i in range(process_id, num_shards, num_processes):
        with np.load(d / f"train-{i:05d}.npz") as z:
            xs.append(z["x"])
            ys.append(z["y"])
    with np.load(d / "test.npz") as test:
        x_test, y_test = test["x"], test["y"]
    return Dataset(
        np.concatenate(xs)[:limit], np.concatenate(ys)[:limit],
        x_test, y_test, int(meta["num_classes"]),
    )
