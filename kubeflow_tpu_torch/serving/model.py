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
    from kubeflow_tpu_torch.models.gpt import beam_search as _beam_search
    from kubeflow_tpu_torch.models.gpt import generate as _generate

    module, config = load_generative_model(model_dir, device)
    example = np.zeros(config["input_shape"], dtype=config["input_dtype"])
    gen = config.get("generate")
    if gen is None:
        def predict_fn(x):
            with torch.inference_mode():
                return module(x)

        return predict_fn, config, example
    temperature = float(gen.get("temperature", 0.0))
    num_beams = int(gen.get("num_beams", 1))
    if num_beams > 1 and temperature > 0.0:
        raise ValueError(
            "generate config: num_beams > 1 and temperature > 0 are "
            "mutually exclusive (beam search is deterministic)"
        )
    eos_raw = gen.get("eos_token_id")
    eos_id = (None if eos_raw is None
              else [int(x) for x in eos_raw]
              if isinstance(eos_raw, (list, tuple)) else int(eos_raw))
    if num_beams > 1 and eos_id is not None:
        raise ValueError(
            "generate config: eos_token_id is not supported with "
            "num_beams > 1 (beam search scores full-length beams)"
        )
    max_new = int(gen.get("max_new_tokens", 32))
    top_k = int(gen.get("top_k", 0))
    if num_beams > 1:
        def predict_fn(x):
            ids, _ = _beam_search(module, x, max_new_tokens=max_new,
                                  num_beams=num_beams)
            return ids

        return predict_fn, config, example

    def predict_fn(x, generator=None):
        return _generate(module, x, max_new_tokens=max_new,
                         temperature=temperature, top_k=top_k,
                         generator=generator, eos_token_id=eos_id)

    return predict_fn, config, example


class TorchModel(Model):
    """In-tree-family predictor on one device (the card unless
    ``device="cpu"``): logits mode, or greedy/sampled/beam generation when
    the config has a ``generate`` block; with ``generate.continuous`` the
    requests share a continuous-batching engine (serving/continuous.py) on
    its own thread — or, with ``generate.fleet_replicas > 1``, a
    FleetRouter over that many engines sharing one pool; with
    ``generate.continuous_draft_dir`` every engine is speculative."""

    def __init__(self, name: str, model_dir: str | Path,
                 device: str | torch.device = "cuda"):
        super().__init__(name)
        self.model_dir = Path(model_dir)
        self.device = select_device(device)
        self._predict_fn: Callable | None = None
        self._engine = None  # continuous-batching decode engine
        self._fleet = None   # multi-replica fleet router (serving/fleet)
        self._calls = 0
        self._calls_lock = threading.Lock()
        self.config: dict = {}

    def load(self) -> None:
        config = json.loads((self.model_dir / CONFIG_FILE).read_text())
        if (config.get("generate") or {}).get("continuous"):
            self._load_engine(config["generate"])
            return
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

    def _load_engine(self, gen: dict) -> None:
        """Continuous batching: concurrent requests interleave decode steps
        on one fixed-row engine instead of serializing whole decodes.
        Greedy or sampling (per-request seeds, engine-static top_k), with
        chunked prefill and a per-model paged KV pool when configured; a
        draft model dir (``continuous_draft_dir``, relative to this model
        dir unless absolute; ``speculative_gamma``) makes the engine
        speculative, and ``fleet_replicas > 1`` puts a FleetRouter over
        that many engines sharing the pool — its SLO admission sheds
        (``fleet_ttft_slo_s``, ``fleet_retry_after_s``) surface as 503 +
        Retry-After."""
        from kubeflow_tpu_torch.serving.continuous import ContinuousBatcher

        if int(gen.get("num_beams", 1)) > 1:
            raise ValueError(
                "generate config: continuous batching does not "
                "compose with beam search (num_beams == 1)")
        module, self.config = load_generative_model(self.model_dir,
                                                    self.device)
        draft_module = None
        if gen.get("continuous_draft_dir"):
            ddir = Path(gen["continuous_draft_dir"])
            if not ddir.is_absolute():
                ddir = self.model_dir / ddir
            draft_module, _ = load_generative_model(ddir, self.device)
        rows = int(gen.get("continuous_rows", 8))
        # warmup outside the engine (its counters and pool stay untouched):
        # a batch-1 prefill of the recorded prompt shape and one decode
        # step at the engine's width, so kernels build and the card's
        # matmul shapes are set up at load, not in the first requests
        example = torch.zeros(self.config["input_shape"][1:],
                              dtype=torch.int64, device=self.device)[None]
        with torch.inference_mode():
            for m in (module, draft_module):
                if m is not None:
                    m(example, cache=m.init_cache(1), prefill=True)
                    m(example[:, :1].expand(rows, 1),
                      cache=m.init_cache(rows))
        paged_kv = None
        if int(gen.get("paged_kv_block", 0)) > 0:
            from kubeflow_tpu_torch.serving.fleet import PagedKVPool

            paged_kv = PagedKVPool(
                block_size=int(gen["paged_kv_block"]),
                capacity_blocks=int(
                    gen.get("paged_kv_capacity_blocks", 1024)))

        def build_engine():
            return ContinuousBatcher(
                module,
                max_rows=rows,
                default_max_new_tokens=int(gen.get("max_new_tokens", 32)),
                # int or stop-id list — the engine normalizes either
                eos_token_id=gen.get("eos_token_id"),
                top_k=int(gen.get("top_k", 0)),
                seed=int(gen.get("seed", 0)),
                steps_per_tick=int(gen.get("continuous_steps_per_tick", 1)),
                prefill_buckets=(
                    tuple(gen["continuous_prefill_buckets"])
                    if gen.get("continuous_prefill_buckets") else None),
                draft_module=draft_module,
                gamma=int(gen.get("speculative_gamma", 4)),
                prefill_chunk=int(gen.get("prefill_chunk", 0)),
                paged_kv=paged_kv,
            )

        n_replicas = int(gen.get("fleet_replicas", 1))
        if n_replicas > 1:
            from kubeflow_tpu_torch.serving.fleet import FleetRouter

            self._fleet = FleetRouter(
                [build_engine() for _ in range(n_replicas)],
                ttft_slo_s=float(gen.get("fleet_ttft_slo_s", 0.0)),
                retry_after_s=float(gen.get("fleet_retry_after_s", 1.0)),
            ).start()
        else:
            self._engine = build_engine().start()
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

    def _check_prompts(self, inputs: np.ndarray) -> np.ndarray:
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
        return x

    def predict(self, inputs: np.ndarray) -> np.ndarray:
        x = self._check_prompts(inputs)
        gen = self.config.get("generate")
        if self._engine is not None or self._fleet is not None:
            out, _ = self._engine_predict_timed(x, gen)
            return out
        xt = torch.as_tensor(x, device=self.device)
        if self._sampling:
            with self._calls_lock:
                self._calls += 1
                call = self._calls
            out = self._predict_fn(xt, self._generator(call))
        else:
            out = self._predict_fn(xt)
        return out.cpu().numpy()

    def _engine_predict_timed(self, x: np.ndarray, gen: dict):
        """Engine/fleet decode for a prompt batch, with the streaming
        timing the load-test client reads: (ids (B, max_new_tokens),
        {"ttft_s", "tokens_per_s"}). Fleet admission sheds
        (FleetOverloaded) propagate — the server maps them to 503 +
        Retry-After."""
        budget = int(gen.get("max_new_tokens", 32))
        eos = gen.get("eos_token_id")
        temp = float(gen.get("temperature", 0.0))
        if self._fleet is not None:
            # gate ONCE with the whole batch's prompt work, then submit
            # ungated: a shed on row k would otherwise orphan the k rows
            # already admitted. A shed here is traced like a submit()-path
            # shed (record_shed), so the 503 body carries the decision's
            # span context and request id.
            from kubeflow_tpu_torch.serving.fleet import FleetOverloaded

            batch_tokens = int(sum(len(row) for row in x))
            try:
                self._fleet.admit_or_raise(batch_tokens)
            except FleetOverloaded as exc:
                raise self._fleet.record_shed(exc, batch_tokens)

            def submit(row, **kw):
                return self._fleet.submit(row, gate=False, **kw)
        else:
            submit = self._engine.submit
        reqs = [submit(row, max_new_tokens=budget, temperature=temp)
                for row in x]
        # eos may be a stop-id LIST; the clamp token past a retired row is
        # the FIRST id — generate()'s contract
        clamp = (int(eos[0]) if isinstance(eos, (list, tuple))
                 else None if eos is None else int(eos))
        outs = []
        for r in reqs:
            ids = r.result(timeout=300.0)
            if ids.size < budget:  # pad past the stop with the clamp
                ids = np.concatenate([
                    ids, np.full((budget - ids.size,), clamp, np.int32)])
            outs.append(ids)
        ttfts = [r.ttft_s for r in reqs if r.ttft_s is not None]
        rates = [r.tokens_per_s for r in reqs
                 if r.tokens_per_s not in (None, float("inf"))]
        timing = {
            "ttft_s": round(min(ttfts), 6) if ttfts else None,
            "tokens_per_s": (round(sum(rates), 3) if rates else None),
        }
        return np.stack(outs), timing

    def predict_timed(self, inputs: np.ndarray):
        """predict() plus per-request streaming timing when an engine
        serves the model — (output, timing|None). The v1 server surfaces
        the timing so clients measure TTFT from the engine's own token
        timestamps instead of guessing from HTTP wall time."""
        if self._engine is None and self._fleet is None:
            return self.predict(inputs), None
        x = self._check_prompts(inputs)
        return self._engine_predict_timed(x, self.config["generate"])

    def close(self) -> None:
        """Stop the engine/fleet ticker threads (server shutdown path)."""
        if self._engine is not None:
            self._engine.stop()
        if self._fleet is not None:
            self._fleet.stop()

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
