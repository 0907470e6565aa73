"""GPT-2 byte-level BPE — own copy of ``kubeflow_tpu/train/bpe_gpt2.py``.

``import-gpt2`` brings GPT-2 weights in (train/convert.py), and those
weights only mean anything on text encoded with GPT-2's exact tokenizer:
the byte-level base alphabet (no UNK ever), the bytes<->unicode remap, the
contraction-aware pre-tokenizer and the merge ranks of the checkpoint's
vocab.json + merges.txt. The stdlib ``re`` stands in for the original
\\p{L}/\\p{N} regex with the documented approximations (\\w-based
classes; identical on ASCII and common text, held against
transformers.GPT2Tokenizer in tests/test_torch_tokenizer.py). Reads files
already on local disk only.
"""

from __future__ import annotations

import json
import re
from pathlib import Path


def bytes_to_unicode() -> dict[int, str]:
    """GPT-2's reversible byte->printable-unicode remap (so merges.txt is
    a text file even for control bytes)."""
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(ord("\xa1"), ord("\xac") + 1))
          + list(range(ord("\xae"), ord("\xff") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, (chr(c) for c in cs)))


# GPT-2's pre-tokenizer pattern with stdlib-re classes: \p{L} -> [^\W\d_],
# \p{N} -> \d, and the punct run picks up '_' explicitly (it is \w, so
# [^\s\w] alone would drop it)
_PRETOK = re.compile(
    r"'s|'t|'re|'ve|'m|'ll|'d"
    r"| ?[^\W\d_]+| ?\d+| ?(?:[^\s\w]|_)+|\s+(?!\S)|\s+"
)


class Gpt2Tokenizer:
    """Encoder/decoder over a pretrained GPT-2 vocab.json + merges.txt."""

    def __init__(self, vocab: dict[str, int],
                 merges: list[tuple[str, str]]):
        self.vocab = dict(vocab)
        self._inv = {i: t for t, i in self.vocab.items()}
        self._ranks = {tuple(m): i for i, m in enumerate(merges)}
        self._b2u = bytes_to_unicode()
        self._u2b = {u: b for b, u in self._b2u.items()}
        self._cache: dict[str, tuple[str, ...]] = {}

    # ------------------------------------------------------------- loading

    @classmethod
    def load(cls, vocab_path: str | Path,
             merges_path: str | Path) -> "Gpt2Tokenizer":
        vocab = json.loads(Path(vocab_path).read_text(encoding="utf-8"))
        merges: list[tuple[str, str]] = []
        for ln in Path(merges_path).read_text(encoding="utf-8").splitlines():
            if not ln or ln.startswith("#version"):
                continue
            a, _, b = ln.partition(" ")
            if b:
                merges.append((a, b))
        return cls(vocab, merges)

    def save(self, path: str | Path) -> None:
        Path(path).write_text(json.dumps({
            "type": "gpt2_byte_bpe",
            "vocab": self.vocab,
            "merges": [list(m) for m in self._ranks],
        }))

    # --------------------------------------------------------------- bpe

    def _bpe(self, token: str) -> tuple[str, ...]:
        cached = self._cache.get(token)
        if cached is not None:
            return cached
        parts = tuple(token)
        while len(parts) > 1:
            pairs = {(parts[i], parts[i + 1])
                     for i in range(len(parts) - 1)}
            best = min(pairs,
                       key=lambda p: self._ranks.get(p, float("inf")))
            if best not in self._ranks:
                break
            merged: list[str] = []
            i = 0
            while i < len(parts):
                if (i < len(parts) - 1
                        and (parts[i], parts[i + 1]) == best):
                    merged.append(parts[i] + parts[i + 1])
                    i += 2
                else:
                    merged.append(parts[i])
                    i += 1
            parts = tuple(merged)
        self._cache[token] = parts
        return parts

    def encode(self, text: str, bos: bool = False,
               eos: bool = False) -> list[int]:
        ids: list[int] = []
        eot = self.vocab.get("<|endoftext|>")
        if bos and eot is not None:
            ids.append(eot)
        for pre in _PRETOK.findall(text):
            mapped = "".join(self._b2u[b] for b in pre.encode("utf-8"))
            for p in self._bpe(mapped):
                if p not in self.vocab:
                    raise ValueError(
                        f"token unit {p!r} is not in the vocabulary — the "
                        "no-UNK guarantee of byte-level BPE requires all "
                        "256 byte units; this vocab.json looks trimmed")
                ids.append(self.vocab[p])
        if eos and eot is not None:
            ids.append(eot)
        return ids

    def decode(self, ids) -> str:
        text = "".join(self._inv[int(i)] for i in ids
                       if int(i) in self._inv)
        data = bytes(self._u2b[u] for u in text if u in self._u2b)
        return data.decode("utf-8", errors="replace")

    @property
    def vocab_size(self) -> int:
        return len(self.vocab)


def load_any_tokenizer(path: str | Path):
    """Dispatch a saved tokenizer.json to the right implementation: the
    in-tree trainable BPE (train/tokenizer.py) or an imported GPT-2
    byte-level one (type marker 'gpt2_byte_bpe')."""
    d = json.loads(Path(path).read_text(encoding="utf-8"))
    if d.get("type") == "gpt2_byte_bpe":
        return Gpt2Tokenizer(d["vocab"], [tuple(m) for m in d["merges"]])
    from kubeflow_tpu_torch.train.tokenizer import Tokenizer

    return Tokenizer(d["vocab"], [tuple(m) for m in d["merges"]])
