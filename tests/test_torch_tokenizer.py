"""The port's own copies of the tokenizers (train/tokenizer.py,
train/bpe_gpt2.py) against the JAX package's: the trainable BPE learns the
same vocabulary and merges, encodes, decodes and batches alike and saves
the same bytes; the GPT-2 byte-level BPE equals the JAX package's (and
transformers.GPT2Tokenizer's, where transformers is installed) over the
strings of tests/test_convert.py's TestGpt2ByteBpe; ``load_any_tokenizer``
dispatches to the port's classes.
"""

import json

import numpy as np
import pytest
import torch

from kubeflow_tpu.train import bpe_gpt2 as jbpe
from kubeflow_tpu.train import tokenizer as jtok
from kubeflow_tpu_torch.train import bpe_gpt2 as tbpe
from kubeflow_tpu_torch.train import tokenizer as ttok

try:  # one intra-op thread: the suite shares the machine with timing gates
    torch.set_num_threads(1)
    torch.set_num_interop_threads(1)
except RuntimeError:  # the interop pool can be sized once per process
    pass

CORPUS = [
    "the quick brown fox jumps over the lazy dog",
    "the lazy dog sleeps while the quick fox runs",
    "a tokenizer learns merges from the most frequent pairs",
    "frequent pairs become symbols and symbols become words",
    "dogs and foxes and tokenizers, all the words of the corpus",
]
TEXTS = [
    "hello world",
    "hello  world's 12 worlds!",
    "tabs\tand\nnewlines  end ",
    "under_score __dunder__",
    "unicode café — dash",
    "digits 123 4.5e6",
]


@pytest.mark.parametrize("vocab_size", [48, 96, 400])
def test_trained_tokenizer_equals_jax(vocab_size, tmp_path):
    ours = ttok.Tokenizer.train(CORPUS, vocab_size=vocab_size)
    theirs = jtok.Tokenizer.train(CORPUS, vocab_size=vocab_size)
    assert ours.vocab == theirs.vocab and ours.merges == theirs.merges
    assert ours.vocab_size == theirs.vocab_size
    for text in CORPUS + ["unseen words, zebra!", ""]:
        assert ours.encode(text) == theirs.encode(text)
        assert ours.encode(text, bos=False, eos=False) == theirs.encode(
            text, bos=False, eos=False)
        ids = ours.encode(text)
        assert ours.decode(ids) == theirs.decode(ids)
    np.testing.assert_array_equal(ours.encode_batch(CORPUS, 12),
                                  theirs.encode_batch(CORPUS, 12))
    assert ours.encode_batch(CORPUS, 12).dtype == np.int32
    ours.save(tmp_path / "ours.json")
    theirs.save(tmp_path / "theirs.json")
    assert (tmp_path / "ours.json").read_bytes() == \
        (tmp_path / "theirs.json").read_bytes()
    back = ttok.Tokenizer.load(tmp_path / "theirs.json")
    assert back.encode(CORPUS[0]) == ours.encode(CORPUS[0])


@pytest.fixture(scope="module")
def bpe_files(tmp_path_factory):
    """A handcrafted (offline) GPT-2 vocab/merges pair: the 256 byte
    symbols, a few merges, <|endoftext|>; the JAX test's pair."""
    d = tmp_path_factory.mktemp("bpe")
    vocab = {u: i for i, u in enumerate(tbpe.bytes_to_unicode().values())}
    merges = [("h", "e"), ("l", "l"), ("he", "ll"), ("Ġ", "w"),
              ("Ġw", "o"), ("o", "r"), ("Ġwo", "r"), ("Ġwor", "ld"),
              ("l", "d"), ("1", "2"), ("'", "s")]
    fixed = []
    for a, b in merges:
        if a in vocab and b in vocab:
            fixed.append((a, b))
            vocab.setdefault(a + b, len(vocab))
    vocab.setdefault("<|endoftext|>", len(vocab))
    (d / "vocab.json").write_text(json.dumps(vocab), encoding="utf-8")
    (d / "merges.txt").write_text(
        "#version: 0.2\n" + "\n".join(f"{a} {b}" for a, b in fixed) + "\n",
        encoding="utf-8")
    return d / "vocab.json", d / "merges.txt"


def test_bytes_to_unicode_equals_jax():
    assert tbpe.bytes_to_unicode() == jbpe.bytes_to_unicode()
    assert len(set(tbpe.bytes_to_unicode().values())) == 256


@pytest.mark.parametrize("text", TEXTS)
def test_gpt2_bpe_equals_jax(bpe_files, text):
    ours = tbpe.Gpt2Tokenizer.load(*bpe_files)
    theirs = jbpe.Gpt2Tokenizer.load(*bpe_files)
    assert ours.encode(text) == theirs.encode(text)
    assert ours.encode(text, bos=True, eos=True) == theirs.encode(
        text, bos=True, eos=True)
    assert ours.decode(ours.encode(text)) == theirs.decode(
        theirs.encode(text)) == text
    assert ours.vocab_size == theirs.vocab_size


@pytest.mark.parametrize("text", TEXTS)
def test_gpt2_bpe_equals_transformers(bpe_files, text):
    transformers = pytest.importorskip("transformers")
    ours = tbpe.Gpt2Tokenizer.load(*bpe_files)
    theirs = transformers.GPT2Tokenizer(vocab_file=str(bpe_files[0]),
                                        merges_file=str(bpe_files[1]))
    assert ours.encode(text) == theirs.encode(text)


def test_save_and_load_any_tokenizer(bpe_files, tmp_path):
    """The saved GPT-2 tokenizer.json is the JAX package's byte for byte;
    load_any_tokenizer gives the port's classes for both kinds."""
    ours = tbpe.Gpt2Tokenizer.load(*bpe_files)
    theirs = jbpe.Gpt2Tokenizer.load(*bpe_files)
    ours.save(tmp_path / "ours.json")
    theirs.save(tmp_path / "theirs.json")
    assert (tmp_path / "ours.json").read_bytes() == \
        (tmp_path / "theirs.json").read_bytes()
    back = tbpe.load_any_tokenizer(tmp_path / "theirs.json")
    assert isinstance(back, tbpe.Gpt2Tokenizer)
    assert back.encode("hello world") == ours.encode("hello world")
    word = jtok.Tokenizer.train(["some text here", "more text"],
                                vocab_size=64)
    word.save(tmp_path / "word.json")
    got = tbpe.load_any_tokenizer(tmp_path / "word.json")
    assert isinstance(got, ttok.Tokenizer)
    assert got.encode("some text") == word.encode("some text")
    trimmed = tbpe.Gpt2Tokenizer({"a": 0}, [])
    with pytest.raises(ValueError, match="trimmed"):
        trimmed.encode("ab")
