"""Model API + the PyTorch predictor runtime — counterpart of
``kubeflow_tpu/serving/model.py``.

The model directory keeps the JAX package's ``config.json`` schema
(``family``, ``kwargs``, ``input_shape``, ``input_dtype``, ``generate``) and
stores the weights as ``params.npz`` in the flax param layout
(``kubeflow_tpu_torch/convert.py``), so one set of weights can be served by
either implementation.
"""

from __future__ import annotations

import json
import threading
from pathlib import Path
from typing import Any, Callable

import numpy as np
import torch

from kubeflow_tpu_torch.convert import (
    flax_params_from_gpt,
    gpt_params_from_flax,
)
from kubeflow_tpu_torch.utils.device import select_device


class Model:
    """Base predictor. Subclass and override load/predict (and optionally
    preprocess/postprocess); the server drives the full chain per request."""

    def __init__(self, name: str):
        self.name = name
        self.ready = False

    def load(self) -> None:
        self.ready = True

    def preprocess(self, inputs: Any) -> Any:
        return inputs

    def predict(self, inputs: Any) -> Any:
        raise NotImplementedError

    def postprocess(self, outputs: Any) -> Any:
        return outputs

    def __call__(self, inputs: Any) -> Any:
        return self.postprocess(self.predict(self.preprocess(inputs)))


CONFIG_FILE = "config.json"
PARAMS_FILE = "params.npz"
# the JAX package's artifacts this runtime cannot read
_JAX_PARAMS_FILE = "params.msgpack"
_JAX_AOT_FILE = "predictor.jaxexport"


def _family_config(family: str, kwargs: dict):
    """(config, module kwargs) of an in-tree family: only ``gpt-lm`` (tiny
    or small) so far."""
    if family != "gpt-lm":
        raise NotImplementedError(
            f"model family {family!r} is not ported yet; the port serves "
            "gpt-lm (other families: ROADMAP Queue A item 7)")
    from kubeflow_tpu_torch.models.gpt import GPTConfig

    kwargs = dict(kwargs)
    cfg_kw = kwargs.pop("config", {})
    size = kwargs.pop("size", "tiny")
    if size not in ("tiny", "small"):
        raise ValueError(f"gpt-lm size {size!r} is not tiny|small")
    cfg = (GPTConfig.tiny(**cfg_kw) if size == "tiny"
           else GPTConfig.small(**cfg_kw))
    return cfg, kwargs


def _build_family(family: str, kwargs: dict, device="cuda"):
    """In-tree model registry of the runtime."""
    from kubeflow_tpu_torch.models.gpt import GPTLM

    cfg, module_kwargs = _family_config(family, kwargs)
    return GPTLM(cfg, device=device, **module_kwargs)


def save_predictor(
    model_dir: str | Path,
    family: str,
    state_dict: dict[str, torch.Tensor],
    example_input: np.ndarray,
    generate: dict | None = None,
    quantize: bool = False,
    **family_kwargs,
) -> Path:
    """Write the model-dir contract: config.json (family + kwargs + example
    input signature) and params.npz (the weights in the flax layout).

    generate: decode parameters (max_new_tokens, temperature, top_k,
    eos_token_id, seed, pad_token_id) — the predictor then serves token
    generation instead of logits."""
    if quantize:
        raise NotImplementedError(
            "int8 weight-only artifacts are ported with the serving-"
            "artifacts slice (ROADMAP Queue A item 9)")
    module_cfg, _ = _family_config(family, family_kwargs)
    d = Path(model_dir)
    d.mkdir(parents=True, exist_ok=True)
    example = np.asarray(example_input)
    cfg = {
        "family": family,
        "kwargs": family_kwargs,
        "input_shape": list(example.shape),
        "input_dtype": str(example.dtype),
    }
    if generate is not None:
        cfg["generate"] = generate
    (d / CONFIG_FILE).write_text(json.dumps(cfg, indent=2))
    np.savez(d / PARAMS_FILE, **flax_params_from_gpt(state_dict, module_cfg))
    return d


def load_generative_model(model_dir: str | Path, device="cuda"):
    """(module, config) rebuilt from a model dir, weights loaded, in eval
    mode on `device`."""
    model_dir = Path(model_dir)
    config = json.loads((model_dir / CONFIG_FILE).read_text())
    if config.get("quantized"):
        raise NotImplementedError(
            "int8 weight-only artifacts are ported with the serving-"
            "artifacts slice (ROADMAP Queue A item 9)")
    if not (model_dir / PARAMS_FILE).exists() \
            and (model_dir / _JAX_PARAMS_FILE).exists():
        raise NotImplementedError(
            f"{model_dir} holds JAX-package weights ({_JAX_PARAMS_FILE}); "
            f"the port reads {PARAMS_FILE} (write it with save_predictor)")
    module = _build_family(config["family"], config["kwargs"], device=device)
    with np.load(model_dir / PARAMS_FILE) as z:
        flat = {k: z[k] for k in z.files}
    module.load_state_dict(gpt_params_from_flax(flat, module.cfg))
    return module.eval(), config


def _load_predict_fn(model_dir: str | Path, device="cuda"
                     ) -> tuple[Callable, dict, np.ndarray]:
    """Rebuild the predictor from the model dir. Returns (predict_fn,
    config, example); predict_fn takes an integer id tensor on the model's
    device (and a torch.Generator when the config samples)."""
    from kubeflow_tpu_torch.models.gpt import generate as _generate

    module, config = load_generative_model(model_dir, device)
    example = np.zeros(config["input_shape"], dtype=config["input_dtype"])
    gen = config.get("generate")
    if gen is None:
        def predict_fn(x):
            with torch.inference_mode():
                return module(x)

        return predict_fn, config, example
    if gen.get("continuous") or int(gen.get("fleet_replicas", 1)) > 1:
        raise NotImplementedError(
            "continuous batching and the serving fleet are ported with the "
            "serving-engine slice (ROADMAP Queue A item 4)")
    if int(gen.get("num_beams", 1)) > 1:
        raise NotImplementedError(
            "beam search (num_beams > 1) is ported with the serving-engine "
            "slice (ROADMAP Queue A item 1)")
    eos_raw = gen.get("eos_token_id")
    eos_id = (None if eos_raw is None
              else [int(x) for x in eos_raw]
              if isinstance(eos_raw, (list, tuple)) else int(eos_raw))
    max_new = int(gen.get("max_new_tokens", 32))
    temperature = float(gen.get("temperature", 0.0))
    top_k = int(gen.get("top_k", 0))

    def predict_fn(x, generator=None):
        return _generate(module, x, max_new_tokens=max_new,
                         temperature=temperature, top_k=top_k,
                         generator=generator, eos_token_id=eos_id)

    return predict_fn, config, example


class TorchModel(Model):
    """In-tree-family predictor on one device (the card unless
    ``device="cpu"``): logits mode, or greedy/sampled generation when the
    config has a ``generate`` block."""

    def __init__(self, name: str, model_dir: str | Path,
                 device: str | torch.device = "cuda"):
        super().__init__(name)
        self.model_dir = Path(model_dir)
        self.device = select_device(device)
        self._predict_fn: Callable | None = None
        self._calls = 0
        self._calls_lock = threading.Lock()
        self.config: dict = {}

    def load(self) -> None:
        if (self.model_dir / _JAX_AOT_FILE).exists():
            raise NotImplementedError(
                f"{self.model_dir} holds a JAX AOT artifact; AOT export is "
                "ported with the serving-artifacts slice (ROADMAP Queue A "
                "item 9)")
        predict_fn, self.config, example = _load_predict_fn(
            self.model_dir, self.device)
        # warmup on the recorded signature: kernels build at load, so the
        # first request pays no build
        x = torch.as_tensor(example, device=self.device)
        if self._sampling:
            predict_fn(x, self._generator(0))
        else:
            predict_fn(x)
        self._predict_fn = predict_fn
        self.ready = True

    @property
    def _sampling(self) -> bool:
        gen = self.config.get("generate")
        return gen is not None and float(gen.get("temperature", 0.0)) > 0.0

    def _generator(self, call: int) -> torch.Generator:
        # per-request stream: the seed with the call count, so repeated
        # requests sample fresh completions
        seed = int(self.config["generate"].get("seed", 0))
        return torch.Generator(device=self.device).manual_seed(
            (seed << 32) + call)

    def predict(self, inputs: np.ndarray) -> np.ndarray:
        x = np.asarray(inputs, dtype=self.config["input_dtype"])
        gen = self.config.get("generate")
        if gen is not None:
            pad = int(gen.get("pad_token_id", 0))
            if (x == pad).any():
                # the decode path has no pad masking (positions are cache-
                # indexed); a padded prompt would write pads into the KV
                # cache and sample from a pad position — reject loudly
                raise ValueError(
                    f"generation prompts must not contain the pad token id "
                    f"{pad}: send equal-length unpadded prompts"
                )
        xt = torch.as_tensor(x, device=self.device)
        if self._sampling:
            with self._calls_lock:
                self._calls += 1
                call = self._calls
            out = self._predict_fn(xt, self._generator(call))
        else:
            out = self._predict_fn(xt)
        return out.cpu().numpy()

    def postprocess(self, outputs: np.ndarray) -> dict:
        """Classification contract: logits -> class + per-class scores.
        Generative configs return the generated token ids directly."""
        if self.config.get("generate") is not None:
            ids = np.asarray(outputs, dtype=np.int64)
            return {"predictions": ids.tolist()}
        logits = np.asarray(outputs, dtype=np.float32)
        return {
            "predictions": np.argmax(logits, axis=-1).tolist(),
            "logits": logits.tolist(),
        }
