"""CLI — ``python -m kubeflow_tpu_torch <command>``; counterpart of the
model-facing commands of ``kubeflow_tpu/cli.py``, with its flags, exit
codes and error texts:

  import-gpt2   --checkpoint ckpt.pt -o DIR   HF/torch GPT-2 -> gpt-lm dir
  import-llama  --checkpoint ckpt.pt -o DIR   HF/torch Llama/Mistral -> gpt-lm
  import-bert   --checkpoint ckpt.pt -o DIR   HF/torch BERT -> bert-classifier
  tokenize      --input corpus.txt -o tok.json  train a BPE tokenizer
  generate      --model-dir DIR --prompt TEXT   decode from a gpt-lm dir

``--device`` is ``cuda`` (the default: the card, the hand-written kernels)
or ``cpu``. The control-plane commands (run, validate, render-env, mpirun,
sweep, profile, slo, sched, serve, pipeline-*, platform* and the remote
verbs) are not ported yet (ROADMAP Queue A item 11).
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

DEVICES = ["cuda", "cpu"]


def _report(tokens, before: dict) -> str:
    """The generated ids and the kernels launched since the
    ``launch_counts()`` snapshot, as one line for stderr."""
    from kubeflow_tpu_torch.kernels.build import launches_since

    ran = {n: c for n, (c, _) in launches_since(before).items() if c}
    return "[generate] " + json.dumps(
        {"tokens": [int(t) for t in tokens], "kernel_launches": ran},
        sort_keys=True)


def cmd_generate(args) -> int:
    """KV-cache text generation against a saved gpt-lm predictor dir
    (tokenizer.json beside it when the prompt is text rather than ids).
    --draft-model-dir switches to speculative decoding: the draft proposes,
    the target verifies — output is exactly the target's greedy decode.
    The generated ids and the kernel launches of the decode (after
    loading) go to stderr."""
    import numpy as np

    from kubeflow_tpu_torch.utils.device import select_device

    device = select_device(args.device)

    tok = None
    tok_path = Path(args.model_dir) / "tokenizer.json"
    if tok_path.exists():
        # dispatches: in-tree trainable BPE or an imported GPT-2
        # byte-level one (import-gpt2 --vocab-json/--merges-txt)
        from kubeflow_tpu_torch.train.bpe_gpt2 import load_any_tokenizer

        tok = load_any_tokenizer(tok_path)
    if tok is not None:
        try:
            encoded = tok.encode(args.prompt, eos=False)
        except ValueError as exc:
            print(f"error: {exc}", file=sys.stderr)
            return 2
        if not encoded:
            print("error: prompt encodes to zero tokens", file=sys.stderr)
            return 2
        ids = np.asarray([encoded], np.int32)
    else:
        try:
            ids = np.asarray([[int(t) for t in args.prompt.split()]],
                             np.int32)
        except ValueError:
            print("error: no tokenizer.json in the model dir — pass the "
                  "prompt as space-separated token ids", file=sys.stderr)
            return 2

    # gen-config checks come from config.json alone — no weight loading
    # before cheap validation
    try:
        tcfg = json.loads(
            (Path(args.model_dir) / "config.json").read_text())
    except OSError as exc:
        print(f"error: {exc}", file=sys.stderr)
        return 2
    gen = tcfg.get("generate")
    if gen is None:
        print("error: model dir has no generate config (not a gpt-lm "
              "generative predictor)", file=sys.stderr)
        return 2

    def trim_at_stop(out, eos):
        """Trim at the FIRST occurrence of ANY stop id (int or list)."""
        if eos is None:
            return out
        stops = [int(x) for x in eos] if isinstance(eos, list) else [int(eos)]
        toks = out.tolist()
        hits = [toks.index(s) for s in stops if s in toks]
        return out[: min(hits)] if hits else out

    from kubeflow_tpu_torch.kernels.build import launch_counts

    if args.draft_model_dir:
        import torch

        from kubeflow_tpu_torch.models.speculative import (
            speculative_generate,
        )
        from kubeflow_tpu_torch.serving.model import load_generative_model

        if int(gen.get("num_beams", 1)) > 1:
            print("error: speculative decoding is incompatible with beam "
                  "search (num_beams > 1 in the target config)",
                  file=sys.stderr)
            return 2
        temp = float(gen.get("temperature", 0.0))
        if temp > 0 and int(gen.get("top_k", 0)) > 0:
            # the continuous engine refuses the same: a sampled row's
            # rejection scheme accepts against the draft's actual proposal
            # distribution, which a top_k-truncated pair would change
            print("error: speculative decoding with temperature > 0 does "
                  "not compose with top_k > 0 in the target config",
                  file=sys.stderr)
            return 2
        tmod, _ = load_generative_model(Path(args.model_dir), device)
        dmod, _ = load_generative_model(Path(args.draft_model_dir), device)
        if tmod.cfg.vocab_size != dmod.cfg.vocab_size:
            print(f"error: draft vocab {dmod.cfg.vocab_size} != target "
                  f"vocab {tmod.cfg.vocab_size}", file=sys.stderr)
            return 2
        eos = gen.get("eos_token_id")
        before = launch_counts()
        try:
            with torch.inference_mode():
                out_ids, stats = speculative_generate(
                    tmod, dmod, torch.as_tensor(ids, device=device),
                    max_new_tokens=int(gen.get("max_new_tokens", 32)),
                    gamma=args.gamma, eos_token_id=eos, temperature=temp,
                    # temperature > 0 runs the rejection-sampling scheme;
                    # a per-invocation generator from the CLI seed
                    generator=(torch.Generator(device=device)
                               .manual_seed(args.seed) if temp > 0
                               else None))
        except ValueError as exc:
            print(f"error: {exc}", file=sys.stderr)
            return 2
        out = trim_at_stop(out_ids[0].cpu().numpy(), eos)
        rounds = int(stats["rounds"])
        accepted = int(stats["drafted_accepted"])
        print(f"[speculative] rounds={rounds} drafted_accepted={accepted} "
              f"tokens={len(out)}", file=sys.stderr)
        print(_report(out, before), file=sys.stderr)
        print(tok.decode(out) if tok is not None else
              " ".join(map(str, out)))
        return 0

    from kubeflow_tpu_torch.serving.model import TorchModel

    tm = TorchModel("cli", args.model_dir, device=device)
    tm.load()
    try:
        before = launch_counts()
        out = trim_at_stop(np.asarray(tm(ids)["predictions"])[0],
                           gen.get("eos_token_id"))
    finally:
        tm.close()  # a continuous predictor's engine thread
    print(_report(out, before), file=sys.stderr)
    print(tok.decode(out) if tok is not None else " ".join(map(str, out)))
    return 0


def cmd_import_gpt2(args) -> int:
    """HF/torch GPT-2 checkpoint -> serving-ready gpt-lm predictor dir."""
    from kubeflow_tpu_torch.train.convert import import_gpt2
    from kubeflow_tpu_torch.utils.device import select_device

    select_device(args.device)
    try:
        out = import_gpt2(
            args.checkpoint, args.out,
            num_heads=args.num_heads or None,
            max_new_tokens=args.max_new_tokens, max_len=args.max_len,
            prompt_len=args.prompt_len,
            vocab_json=args.vocab_json, merges_txt=args.merges_txt,
            continuous_rows=args.continuous_rows,
        )
    except (OSError, KeyError, ValueError) as exc:
        print(f"import error: {exc}", file=sys.stderr)
        return 2
    print(f"serving-ready predictor dir: {out}\n"
          f"  serve:    python -m kubeflow_tpu_torch.serving.server "
          f"--model-name gpt2 --model-dir {out}\n"
          f"  generate: python -m kubeflow_tpu_torch generate --model-dir "
          f"{out} --prompt '<ids or text>'")
    return 0


def cmd_import_llama(args) -> int:
    """HF/torch Llama/Mistral checkpoint -> serving-ready gpt-lm predictor
    dir (GPTConfig.llama family: rope + GQA + RMSNorm + SwiGLU)."""
    from kubeflow_tpu_torch.train.convert import import_llama
    from kubeflow_tpu_torch.utils.device import select_device

    select_device(args.device)
    try:
        out = import_llama(
            args.checkpoint, args.out,
            num_heads=args.num_heads or None,
            max_new_tokens=args.max_new_tokens, max_len=args.max_len,
            prompt_len=args.prompt_len,
            continuous_rows=args.continuous_rows,
        )
    except (OSError, KeyError, ValueError) as exc:
        print(f"import error: {exc}", file=sys.stderr)
        return 2
    print(f"serving-ready predictor dir: {out}\n"
          f"  serve:    python -m kubeflow_tpu_torch.serving.server "
          f"--model-name llama --model-dir {out}\n"
          f"  generate: python -m kubeflow_tpu_torch generate --model-dir "
          f"{out} --prompt '<ids>'")
    return 0


def cmd_import_bert(args) -> int:
    """HF/torch BERT checkpoint -> serving-ready classifier predictor."""
    from kubeflow_tpu_torch.train.convert import import_bert
    from kubeflow_tpu_torch.utils.device import select_device

    select_device(args.device)
    try:
        out = import_bert(
            args.checkpoint, args.out,
            num_heads=args.num_heads or None,
            num_classes=args.num_classes or None,
            max_len=args.max_len,
        )
    except (OSError, KeyError, ValueError) as exc:
        print(f"import error: {exc}", file=sys.stderr)
        return 2
    print(f"serving-ready predictor dir: {out}")
    return 0


def cmd_tokenize(args) -> int:
    """Train a BPE tokenizer from a text file (one document per line) and
    write tokenizer.json — pairs with `generate` and gpt-lm predictors."""
    from kubeflow_tpu_torch.train.tokenizer import Tokenizer

    texts = [
        ln.strip() for ln in Path(args.input).read_text().splitlines()
        if ln.strip()
    ]
    if not texts:
        print(f"error: {args.input} has no non-empty lines", file=sys.stderr)
        return 2
    tok = Tokenizer.train(texts, vocab_size=args.vocab_size)
    tok.save(args.output)
    print(f"trained vocab={tok.vocab_size} merges={len(tok.merges)} "
          f"-> {args.output}")
    return 0


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="kubeflow_tpu_torch",
        description="the port's model-facing CLI (PyTorch, CUDA)")
    sub = ap.add_subparsers(dest="command", required=True)

    def add(name, fn, **kwargs):
        p = sub.add_parser(name, **kwargs)
        p.set_defaults(fn=fn)
        return p

    p = add("import-gpt2", cmd_import_gpt2,
            help="convert an HF/torch GPT-2 checkpoint into a "
                 "serving-ready gpt-lm predictor dir")
    p.add_argument("--checkpoint", required=True,
                   help="torch .pt/.bin with a GPT2(LMHead)Model state dict")
    p.add_argument("-o", "--out", required=True)
    p.add_argument("--num-heads", type=int, default=0,
                   help="attention head count (required unless the "
                        "checkpoint carries config.n_head — a bare state "
                        "dict does not determine it)")
    p.add_argument("--max-new-tokens", type=int, default=32)
    p.add_argument("--max-len", type=int, default=None)
    p.add_argument("--prompt-len", type=int, default=16)
    p.add_argument("--vocab-json", default=None,
                   help="HF vocab.json — with --merges-txt, bundles the "
                        "checkpoint's byte-level BPE as tokenizer.json")
    p.add_argument("--merges-txt", default=None)
    p.add_argument("--continuous-rows", type=int, default=0,
                   help="serve through the continuous-batching engine "
                        "with this many decode rows (0 = plain decode)")
    p.add_argument("--device", default="cuda", choices=DEVICES)

    p = add("import-llama", cmd_import_llama,
            help="convert an HF/torch Llama/Mistral checkpoint into a "
                 "serving-ready gpt-lm predictor dir (rope+GQA+RMSNorm+"
                 "SwiGLU family)")
    p.add_argument("--checkpoint", required=True,
                   help="torch .pt/.bin with a Llama/MistralForCausalLM "
                        "state dict")
    p.add_argument("-o", "--out", required=True)
    p.add_argument("--num-heads", type=int, default=0,
                   help="attention head count (required unless the "
                        "checkpoint carries config.num_attention_heads; "
                        "num_kv_heads is read off k_proj)")
    p.add_argument("--max-new-tokens", type=int, default=32)
    p.add_argument("--max-len", type=int, default=None)
    p.add_argument("--prompt-len", type=int, default=16)
    p.add_argument("--continuous-rows", type=int, default=0,
                   help="serve through the continuous-batching engine "
                        "with this many decode rows (0 = plain decode)")
    p.add_argument("--device", default="cuda", choices=DEVICES)

    p = add("import-bert", cmd_import_bert,
            help="convert an HF/torch BERT checkpoint into a "
                 "serving-ready bert-classifier predictor dir")
    p.add_argument("--checkpoint", required=True)
    p.add_argument("-o", "--out", required=True)
    p.add_argument("--num-heads", type=int, default=0)
    p.add_argument("--num-classes", type=int, default=0,
                   help="required for headless BertModel checkpoints")
    p.add_argument("--max-len", type=int, default=None)
    p.add_argument("--device", default="cuda", choices=DEVICES)

    p = add("tokenize", cmd_tokenize,
            help="train a BPE tokenizer from a text file")
    p.add_argument("--input", required=True, help="one document per line")
    p.add_argument("--vocab-size", type=int, default=8192)
    p.add_argument("-o", "--output", default="tokenizer.json")

    p = add("generate", cmd_generate,
            help="generate text/ids from a saved gpt-lm predictor dir")
    p.add_argument("--model-dir", required=True)
    p.add_argument("--prompt", required=True,
                   help="text (tokenizer.json in the dir) or token ids")
    p.add_argument("--device", default="cuda", choices=DEVICES)
    p.add_argument("--draft-model-dir", default="",
                   help="speculative decoding: a small gpt-lm predictor "
                        "dir proposing tokens the target verifies. "
                        "Greedy configs emit exactly the target's greedy "
                        "decode; temperature>0 configs run rejection "
                        "sampling (target-distribution-exact)")
    p.add_argument("--gamma", type=int, default=4,
                   help="speculated tokens per round")
    p.add_argument("--seed", type=int, default=0,
                   help="PRNG seed for sampled speculative decoding")

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
