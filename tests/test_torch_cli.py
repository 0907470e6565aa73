"""The port's CLI (``python -m kubeflow_tpu_torch``) against the JAX
package's (``python -m kubeflow_tpu``), both called in-process through
``main(argv)`` with ``--device cpu``: import-gpt2 writes the same dir,
generate (plain and speculative, f32) prints the same tokens, tokenize
writes the same tokenizer.json, and every error case exits 2 with the
same message.
"""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from kubeflow_tpu import cli as jcli
from kubeflow_tpu_torch import cli as tcli
from kubeflow_tpu_torch.train.bpe_gpt2 import load_any_tokenizer

try:  # one intra-op thread: the suite shares the machine with timing gates
    torch.set_num_threads(1)
    torch.set_num_interop_threads(1)
except RuntimeError:  # the interop pool can be sized once per process
    pass

ROOT = Path(__file__).resolve().parent.parent
H, HEADS, LAYERS, VOCAB, POS = 32, 4, 2, 300, 32
CLIS = {"jax": jcli.main, "port": tcli.main}


def gpt2_checkpoint(path: Path, layers=LAYERS, seed=0) -> str:
    """A GPT-2 state dict with HF's keys from a numpy seed, and its head
    count in the blob's config."""
    rng = np.random.RandomState(seed)

    def t(*shape, std=0.1):
        return torch.from_numpy(rng.normal(0, std, shape).astype(np.float32))

    sd = {"wte.weight": t(VOCAB, H), "wpe.weight": t(POS, H),
          "ln_f.weight": 1 + t(H), "ln_f.bias": t(H)}
    for i in range(layers):
        p = f"h.{i}."
        sd.update({
            p + "ln_1.weight": 1 + t(H), p + "ln_1.bias": t(H),
            p + "ln_2.weight": 1 + t(H), p + "ln_2.bias": t(H),
            p + "attn.c_attn.weight": t(H, 3 * H),
            p + "attn.c_attn.bias": t(3 * H),
            p + "attn.c_proj.weight": t(H, H), p + "attn.c_proj.bias": t(H),
            p + "mlp.c_fc.weight": t(H, 4 * H), p + "mlp.c_fc.bias": t(4 * H),
            p + "mlp.c_proj.weight": t(4 * H, H),
            p + "mlp.c_proj.bias": t(H)})
    torch.save({"state_dict": sd, "config": {"n_head": HEADS}}, str(path))
    return str(path)


def tokenizer_files(d: Path) -> tuple[str, str]:
    """The 256 byte symbols, two merges and <|endoftext|> (ids < VOCAB)."""
    from kubeflow_tpu_torch.train.bpe_gpt2 import bytes_to_unicode

    vocab = {u: i for i, u in enumerate(bytes_to_unicode().values())}
    for a, b in (("h", "e"), ("l", "l")):
        vocab[a + b] = len(vocab)
    vocab["<|endoftext|>"] = len(vocab)
    (d / "vocab.json").write_text(json.dumps(vocab))
    (d / "merges.txt").write_text("#version: 0.2\nh e\nl l\n")
    return str(d / "vocab.json"), str(d / "merges.txt")


def run(which, argv, capsys):
    rc = CLIS[which](argv)
    out = capsys.readouterr()
    return rc, out.out, out.err


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    """import-gpt2 through each CLI: a tokenized target dir and an ids-only
    one-layer draft dir."""
    d = tmp_path_factory.mktemp("cli")
    ckpt = gpt2_checkpoint(d / "gpt2.pt")
    draft = gpt2_checkpoint(d / "draft.pt", layers=1, seed=1)
    vocab, merges = tokenizer_files(d)
    for which, main in CLIS.items():
        assert main(["import-gpt2", "--checkpoint", ckpt, "-o",
                     str(d / which), "--vocab-json", vocab, "--merges-txt",
                     merges, "--max-new-tokens", "6", "--prompt-len", "4",
                     "--device", "cpu"]) == 0
        assert main(["import-gpt2", "--checkpoint", draft, "-o",
                     str(d / f"{which}-draft"), "--max-new-tokens", "6",
                     "--device", "cpu"]) == 0
    return d


def test_import_gpt2_writes_the_jax_dir(dirs):
    with np.load(dirs / "port" / "params.npz") as z:
        assert set(z.files) >= {"token_embed/embedding",
                                "layer_1/attention/query/kernel"}
    for name in ("config.json", "tokenizer.json"):
        assert (dirs / "port" / name).read_text() == \
            (dirs / "jax" / name).read_text(), name


@pytest.mark.parametrize("prompt", ["hello world", "the hell"])
def test_generate_prints_the_jax_tokens(dirs, capsys, prompt):
    """f32 greedy decode of a text prompt through tokenizer.json: the same
    decoded text; the port reports the generated ids and its kernel
    launches (none on the CPU) on stderr."""
    outs = {}
    for which in CLIS:
        rc, out, err = run(which, ["generate", "--model-dir",
                                   str(dirs / which), "--prompt", prompt,
                                   "--device", "cpu"], capsys)
        assert rc == 0, err
        outs[which] = out
    assert outs["port"] == outs["jax"] and outs["port"].strip()
    _, out, err = run("port", ["generate", "--model-dir", str(dirs / "port"),
                               "--prompt", prompt, "--device", "cpu"], capsys)
    report = json.loads(err.split("[generate] ", 1)[1])
    assert report["kernel_launches"] == {}
    tok = load_any_tokenizer(dirs / "port" / "tokenizer.json")
    assert tok.decode(report["tokens"]) == out.strip("\n")


def test_speculative_generate_prints_the_jax_tokens(dirs, capsys):
    """--draft-model-dir: the target's greedy tokens for ids, and the
    same round statistics."""
    outs = {}
    for which in CLIS:
        d = dirs / f"{which}-draft"
        rc, out, err = run(which, ["generate", "--model-dir", str(d),
                                   "--prompt", "5 17 99 3", "--device",
                                   "cpu", "--draft-model-dir", str(d)],
                           capsys)
        assert rc == 0, err
        outs[which] = (out, err.splitlines()[0])
        assert len(out.split()) == 6
    assert outs["port"] == outs["jax"]


def test_tokenize_writes_the_jax_tokenizer(tmp_path, capsys):
    corpus = tmp_path / "corpus.txt"
    corpus.write_text("the quick brown fox\n\nthe lazy dog and the fox\n")
    for which in CLIS:
        rc, out, _ = run(which, ["tokenize", "--input", str(corpus),
                                 "--vocab-size", "40", "-o",
                                 str(tmp_path / f"{which}.json")], capsys)
        assert rc == 0 and out.startswith("trained vocab=40")
    assert (tmp_path / "port.json").read_bytes() == \
        (tmp_path / "jax.json").read_bytes()


def test_error_cases_exit_2_as_jax(dirs, tmp_path, capsys):
    empty = tmp_path / "empty.txt"
    empty.write_text("\n\n")
    ckpt = gpt2_checkpoint(tmp_path / "g.pt", layers=1)
    (tmp_path / "bert").mkdir()
    (tmp_path / "bert" / "config.json").write_text(json.dumps(
        {"family": "bert-classifier", "kwargs": {}, "input_shape": [1, 4],
         "input_dtype": "int32"}))
    beams = json.loads((dirs / "jax-draft" / "config.json").read_text())
    beams["generate"]["num_beams"] = 2
    (tmp_path / "beams").mkdir()
    (tmp_path / "beams" / "config.json").write_text(json.dumps(beams))
    cases = [
        ["generate", "--model-dir", "{dir}", "--prompt", ""],
        ["generate", "--model-dir", "{draft}", "--prompt", "a b"],
        ["generate", "--model-dir", str(tmp_path / "none"), "--prompt",
         "1 2"],
        ["generate", "--model-dir", str(tmp_path / "bert"), "--prompt",
         "1 2"],
        ["generate", "--model-dir", str(tmp_path / "beams"), "--prompt",
         "1 2", "--draft-model-dir", "{draft}"],
        ["tokenize", "--input", str(empty)],
        ["import-gpt2", "--checkpoint", ckpt, "-o", str(tmp_path / "x"),
         "--vocab-json", str(dirs / "vocab.json")],
        ["import-gpt2", "--checkpoint", str(tmp_path / "missing.pt"), "-o",
         str(tmp_path / "x")],
        ["import-llama", "--checkpoint", ckpt, "-o", str(tmp_path / "x")],
        ["import-bert", "--checkpoint", ckpt, "-o", str(tmp_path / "x"),
         "--num-heads", "4"],
    ]
    for argv in cases:
        errs = {}
        for which in CLIS:
            args = [a.format(dir=dirs / which, draft=dirs / f"{which}-draft")
                    for a in argv]
            if argv[0] != "tokenize":
                args += ["--device", "cpu"]
            rc, _, err = run(which, args, capsys)
            assert rc == 2, (which, argv, err)
            errs[which] = err.replace(str(dirs / f"{which}-draft"), "DRAFT")
        assert errs["port"] == errs["jax"], argv
    assert not (tmp_path / "x").exists()


def test_module_entry_point_and_default_device():
    """``python -m kubeflow_tpu_torch`` lists the five commands; --device
    defaults to cuda, which refuses a machine without a card."""
    out = subprocess.run([sys.executable, "-m", "kubeflow_tpu_torch",
                          "--help"], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0
    for cmd in ("import-gpt2", "import-llama", "import-bert", "tokenize",
                "generate"):
        assert cmd in out.stdout
    for absent in ("mpirun", "sweep", "pipeline-run", "platform"):
        assert absent not in out.stdout
    args = ["generate", "--model-dir", "x", "--prompt", "1"]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tcli.main(args)
