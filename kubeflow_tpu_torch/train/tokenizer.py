"""BPE tokenizer — own copy of ``kubeflow_tpu/train/tokenizer.py``.

A trainable byte-pair-encoding tokenizer (Sennrich et al. 2016): a
char-level base vocabulary plus learned merges over an end-of-word marker,
deterministic and JSON-serializable, needing only numpy. Its vocabulary
follows the models' conventions: id 0 is <pad> (GPTLM/Bert pad_token_id ==
0), and encode() emits fixed-length int32 rows ready for
``synthetic_lm_dataset``-shaped training and KV-cache generation. The port
keeps its own copy, so that it imports nothing of the JAX package; the
copy trains the same merges and writes the same ``tokenizer.json``
(tests/test_torch_tokenizer.py).
"""

from __future__ import annotations

import json
from collections import Counter
from functools import lru_cache
from pathlib import Path

import numpy as np

PAD, UNK, BOS, EOS = "<pad>", "<unk>", "<bos>", "<eos>"
_EOW = "</w>"  # end-of-word marker: merges never cross word boundaries


class Tokenizer:
    def __init__(self, vocab: dict[str, int], merges: list[tuple[str, str]]):
        self.vocab = dict(vocab)
        self.merges = [tuple(m) for m in merges]
        self._ranks = {m: i for i, m in enumerate(self.merges)}
        self._inv = {i: t for t, i in self.vocab.items()}

    # ------------------------------------------------------------- training

    @classmethod
    def train(cls, texts: list[str], vocab_size: int = 512) -> "Tokenizer":
        """Learn merges until the vocabulary reaches vocab_size (specials +
        chars + merged symbols)."""
        words = Counter()
        for t in texts:
            for w in t.split():
                words[tuple(w) + (_EOW,)] += 1
        vocab = {PAD: 0, UNK: 1, BOS: 2, EOS: 3}
        for sym in sorted({c for w in words for c in w}):
            vocab.setdefault(sym, len(vocab))
        merges: list[tuple[str, str]] = []
        words = dict(words)
        while len(vocab) < vocab_size:
            pairs: Counter = Counter()
            for w, n in words.items():
                for a, b in zip(w, w[1:]):
                    pairs[(a, b)] += n
            if not pairs:
                break
            # deterministic: highest count, ties by lexicographic pair
            (a, b), _ = min(pairs.items(), key=lambda kv: (-kv[1], kv[0]))
            merges.append((a, b))
            vocab.setdefault(a + b, len(vocab))
            merged = {}
            for w, n in words.items():
                out, i = [], 0
                while i < len(w):
                    if i + 1 < len(w) and (w[i], w[i + 1]) == (a, b):
                        out.append(a + b)
                        i += 2
                    else:
                        out.append(w[i])
                        i += 1
                merged[tuple(out)] = merged.get(tuple(out), 0) + n
            words = merged
        return cls(vocab, merges)

    # ------------------------------------------------------------- encoding

    @lru_cache(maxsize=65536)  # corpora repeat words; merge search is per-word
    def _bpe_word(self, word: str) -> tuple[str, ...]:
        syms = list(word) + [_EOW]
        while len(syms) > 1:
            ranked = [
                (self._ranks[(a, b)], i)
                for i, (a, b) in enumerate(zip(syms, syms[1:]))
                if (a, b) in self._ranks
            ]
            if not ranked:
                break
            _, i = min(ranked)
            syms[i:i + 2] = [syms[i] + syms[i + 1]]
        return tuple(syms)

    def encode(self, text: str, bos: bool = True, eos: bool = True) -> list[int]:
        unk = self.vocab[UNK]
        ids = [self.vocab[BOS]] if bos else []
        for w in text.split():
            ids.extend(self.vocab.get(s, unk) for s in self._bpe_word(w))
        if eos:
            ids.append(self.vocab[EOS])
        return ids

    def decode(self, ids) -> str:
        toks = [self._inv.get(int(i), UNK) for i in ids]
        text = "".join(
            t for t in toks if t not in (PAD, UNK, BOS, EOS)
        )
        return text.replace(_EOW, " ").strip()

    def encode_batch(self, texts: list[str], seq_len: int) -> np.ndarray:
        """Fixed-length int32 rows: truncate or right-pad with <pad> (id 0,
        the models' pad_token_id) — ready for Trainer/causal_lm_loss."""
        out = np.zeros((len(texts), seq_len), np.int32)
        for r, t in enumerate(texts):
            ids = self.encode(t)[:seq_len]
            out[r, :len(ids)] = ids
        return out

    @property
    def vocab_size(self) -> int:
        return len(self.vocab)

    # ---------------------------------------------------------------- serde

    def save(self, path: str | Path) -> None:
        Path(path).write_text(json.dumps(
            {"vocab": self.vocab, "merges": self.merges}
        ))

    @classmethod
    def load(cls, path: str | Path) -> "Tokenizer":
        d = json.loads(Path(path).read_text())
        return cls(d["vocab"], [tuple(m) for m in d["merges"]])
