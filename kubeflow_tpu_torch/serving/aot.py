"""AOT serving artifacts — counterpart of ``kubeflow_tpu/serving/aot.py``.

Deploy time, `export_predictor(model_dir)`:
  - rebuilds the predictor once and traces it with ``torch.export`` at the
    recorded example shape, the weights inside the program, saved beside
    `aot.json` ({"platforms", "batch_size", "torch_version", "programs"}):
    no model module, no params read, no Python model code at load. A
    logits predictor is one program (`predictor.pt2`). A generative one is
    two, its prefill (`predictor.pt2`) and one decode step
    (`predictor-decode.pt2`), each taking the KV cache's buffers as inputs
    and writing them in place: the loop that calls them is the eager
    predictor's own (``decode_tokens``/``decode_beams`` over an
    ``ExportedLM``), so the programs stay one forward long however many
    tokens a request asks for. The flash kernel is in the programs as the
    custom op ``kftpu::flash_fwd`` (kernels/flash_fwd.py), so the exported
    prefill launches the same hand-written kernel as the eager one;
  - optionally builds the kernel libraries into a cache dir
    (`compile_cache=`) and runs the artifact once from it, so a serving
    process pointed at the same dir (``KFT_COMPILE_CACHE``) runs nvcc ZERO
    times on cold start (``utils.compile_cache.compile_counts()``).

Serve time, TorchModel.load() prefers the artifact when its platform is the
running device's (else it rebuilds, as the JAX package does; an artifact of
this platform that fails to load raises). Batches are padded and chunked to
the exported batch size.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch

AOT_FILE = "predictor.pt2"            # the predictor, or its prefill
AOT_DECODE_FILE = "predictor-decode.pt2"  # a generative one's decode step
AOT_META = "aot.json"


def _compile_cache_on(cache_dir: str | Path) -> None:
    """Build (what is missing) into `cache_dir` and load every kernel
    library from it: the process's later kernel calls build nothing."""
    from kubeflow_tpu_torch.kernels.build import load_all

    load_all(cache_dir)


class _Step(torch.nn.Module):
    """One cached forward of a GPTLM as a module (torch.export lifts its
    weights into the program): (ids, cache index, keys..., values...) ->
    logits, the cache buffers and index written in place."""

    def __init__(self, lm: torch.nn.Module, prefill: bool):
        super().__init__()
        self.lm = lm
        self.prefill = prefill

    def forward(self, ids, index, *buffers):
        from kubeflow_tpu_torch.models.gpt import KVCache

        n = len(buffers) // 2
        cache = KVCache(key=list(buffers[:n]), value=list(buffers[n:]),
                        index=index)
        return self.lm(ids, cache=cache, prefill=self.prefill)


def _cache_args(cache) -> tuple:
    return (cache.index, *cache.key, *cache.value)


class ExportedLM:
    """A generative artifact's two programs behind the GPTLM calls the
    decode loops make: ``cfg``, ``init_cache`` and a cached forward that
    runs the prefill program (``prefill=True``) or the decode step. It
    holds no module and no weights of its own."""

    def __init__(self, cfg, prefill, decode, device: torch.device):
        self.cfg = cfg
        self.device = device
        self._prefill, self._decode = prefill, decode

    def init_cache(self, batch: int):
        from kubeflow_tpu_torch.models.gpt import new_cache

        return new_cache(self.cfg, batch, self.device)

    def __call__(self, ids, cache, prefill: bool = False):
        program = self._prefill if prefill else self._decode
        return program(ids, *_cache_args(cache))


def export_predictor(
    model_dir: str | Path,
    compile_cache: str | Path | None = None,
    device: str | torch.device = "cuda",
) -> Path:
    """Trace and save the predictor in `model_dir` (the save_predictor
    layout) for `device`. Returns the artifact path."""
    from kubeflow_tpu_torch.serving.model import load_generative_model
    from kubeflow_tpu_torch.utils.device import select_device

    model_dir = Path(model_dir)
    device = select_device(device)
    config = json.loads((model_dir / "config.json").read_text())
    gen = config.get("generate")
    if gen is not None and float(gen.get("temperature", 0.0)) > 0.0:
        raise ValueError(
            "AOT export supports greedy decode only (temperature == 0): "
            "sampling needs a fresh per-request rng, which the single-input "
            "exported artifact cannot receive — serve sampling configs via "
            "the jit path"
        )
    if compile_cache is not None and device.type == "cuda":
        _compile_cache_on(compile_cache)
    module, config = load_generative_model(model_dir, device)
    example = torch.as_tensor(
        np.zeros(config["input_shape"], dtype=config["input_dtype"]),
        device=device)
    batch = int(example.shape[0])
    with torch.no_grad():
        if gen is None:
            programs = {AOT_FILE: torch.export.export(
                module, (example,), strict=False)}
        else:
            # the decode step runs at the beams' rows (beam search expands
            # the prefilled cache to batch x num_beams) on the int64 ids
            # the loops sample
            rows = batch * int(gen.get("num_beams", 1))
            tokens = torch.zeros((rows, 1), dtype=torch.int64, device=device)
            programs = {
                AOT_FILE: torch.export.export(
                    _Step(module, prefill=True),
                    (example, *_cache_args(module.init_cache(batch))),
                    strict=False),
                AOT_DECODE_FILE: torch.export.export(
                    _Step(module, prefill=False),
                    (tokens, *_cache_args(module.init_cache(rows))),
                    strict=False)}
    for name, program in programs.items():
        torch.export.save(program, model_dir / name)
    (model_dir / AOT_META).write_text(json.dumps({
        "platforms": [device.type],
        "batch_size": batch,
        "torch_version": torch.__version__,
        "programs": sorted(programs),
    }, indent=2))
    if compile_cache is not None:
        # run the saved artifact once, as a serving process will
        padded_chunk_predict(load_exported(model_dir, device),
                             example.cpu().numpy(), batch, device)
    return model_dir / AOT_FILE


def aot_available(model_dir: str | Path,
                  device: str | torch.device = "cuda") -> bool:
    """True when an artifact exists AND targets `device`'s platform."""
    model_dir = Path(model_dir)
    if not (model_dir / AOT_FILE).exists() \
            or not (model_dir / AOT_META).exists():
        return False
    meta = json.loads((model_dir / AOT_META).read_text())
    return torch.device(device).type in meta.get("platforms", [])


def load_exported(model_dir: str | Path,
                  device: str | torch.device = "cuda"):
    """Load the artifact -> callable on tensors of its platform. No model
    module is built and no params file is read: the programs hold both; a
    generative artifact's callable is the eager predictor's decode loop
    over its programs."""
    # the programs call kftpu::flash_fwd: register the op before loading
    import kubeflow_tpu_torch.kernels.flash_fwd  # noqa: F401
    from kubeflow_tpu_torch.serving.model import _family_config, predictor_fn

    model_dir = Path(model_dir)
    first = torch.export.load(model_dir / AOT_FILE).module()
    config = json.loads((model_dir / "config.json").read_text())
    if config.get("generate") is None:
        return first
    cfg, _ = _family_config(config["family"], config["kwargs"])
    decode = torch.export.load(model_dir / AOT_DECODE_FILE).module()
    _share_weights(first, decode)
    return predictor_fn(ExportedLM(cfg, first, decode, torch.device(device)),
                        config)


def _share_weights(source: torch.nn.Module, dest: torch.nn.Module) -> None:
    """Point `dest`'s parameters at `source`'s of the same name: the two
    programs of a generative artifact were traced from one module, so
    they load one copy of the weights, not two."""
    weights = dict(source.named_parameters())
    for name, _ in list(dest.named_parameters()):
        owner, _, leaf = name.rpartition(".")
        setattr(dest.get_submodule(owner), leaf, weights[name])


def padded_chunk_predict(call, x: np.ndarray, batch_size: int,
                         device: str | torch.device = "cpu") -> np.ndarray:
    """Run a fixed-batch exported callable over an arbitrary-length batch:
    chunk to `batch_size`, zero-pad the tail, slice real rows back out."""
    outs = []
    for i in range(0, x.shape[0], batch_size):
        part = x[i:i + batch_size]
        real = part.shape[0]
        if real < batch_size:
            part = np.concatenate(
                [part, np.zeros((batch_size - real, *part.shape[1:]),
                                part.dtype)]
            )
        with torch.inference_mode():
            out = call(torch.as_tensor(part, device=device))
        outs.append(out.cpu().numpy()[:real])
    return np.concatenate(outs) if len(outs) > 1 else outs[0]
