"""The trainer — counterpart of ``kubeflow_tpu/train/trainer.py``.

One optimizer step per ``train_step`` on one device, eager: the model (its
float32 parameters) and a torch optimizer live in a ``TrainState`` that the
step updates in place. The semantics are the JAX Trainer's:

  - the compute dtype: AUTO resolves to the model's PREFERRED_COMPUTE_DTYPE
    (bfloat16 for GPTLM) on the card and float32 on the CPU, and the model
    then computes in it while its parameters stay float32; an explicit
    ``compute_dtype`` is honoured verbatim and only casts float inputs;
  - the optimizer: optax's adam/adamw (torch.optim.Adam/AdamW, the same
    update), its schedules evaluated at the count of updates already
    applied (the first update of a linear warmup has lr 0), and optax's
    global-norm clipping (g·max/‖g‖ only when ‖g‖ ≥ max); the step's
    ``loss``, ``accuracy`` and ``grad_norm`` come from the unclipped grads;
  - ``fit``: steps or epochs, ``name=value`` log lines, eval, checkpoint and
    early-stop cadence, resume, the SIGTERM preemption save, heartbeats.

What ``fit`` cannot honour yet raises NotImplementedError naming its
ROADMAP entry; it is never silently ignored.
"""

from __future__ import annotations

import inspect
import math
import os
import signal
from dataclasses import dataclass
from typing import Any, Callable

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from kubeflow_tpu_torch.health import HeartbeatWriter
from kubeflow_tpu_torch.train import metrics as metrics_lib
from kubeflow_tpu_torch.train.checkpoint import Checkpointer
from kubeflow_tpu_torch.train.data import (
    AsyncLoader,
    Dataset,
    batches,
    prefetch_to_device,
    to_device,
)

from kubeflow_tpu_torch.utils.envvars import (
    ENV_EVENT_DIR,
    ENV_PROFILE_DIR,
    ENV_TRACE_DIR,
)

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclass
class TrainerConfig:
    batch_size: int = 128
    epochs: int = 1
    steps: int | None = None          # overrides epochs when set
    learning_rate: float = 1e-3
    weight_decay: float = 0.0
    warmup_steps: int = 0
    # cosine decay to lr_final_fraction·lr, reaching the floor at `steps`
    # total (decay spans steps - warmup_steps); requires `steps`.
    # "constant" keeps the warmup->flat behavior
    lr_schedule: str = "constant"     # constant | cosine
    lr_final_fraction: float = 0.0
    grad_clip_norm: float = 0.0       # 0 = off (global-norm clipping)
    # accumulate this many microbatch grads per optimizer step
    grad_accum_steps: int = 1
    # optimizer steps per dispatch in fit(); only 1 is ported
    fused_steps: int = 1
    seed: int = 0                     # dropout masks and batch order
    # None = AUTO (see the module docstring); else "float32", "bfloat16"
    # or a torch dtype, honoured verbatim
    compute_dtype: Any = None
    eval_every_epochs: int = 1
    checkpoint_dir: str | None = None
    checkpoint_every_steps: int = 200
    log_every_steps: int = 50
    mesh: Any = None                  # only None (one device) is ported
    profile_dir: str = ""             # not ported: must stay ""
    # tfevents scalar output for TensorBoard; "" defers to KFTPU_EVENT_DIR
    event_dir: str = ""
    # keep the max_to_keep BEST checkpoints by this eval-metric key instead
    # of the newest; best mode saves at eval cadence plus preemption
    keep_best_metric: str | None = None
    best_mode: str = "max"            # max | min (e.g. "loss")
    checkpoint_max_to_keep: int = 3
    # stop after this many consecutive evals without improvement on
    # early_stop_metric (early_stop_mode direction); 0 = off
    early_stop_patience: int = 0
    early_stop_metric: str = "accuracy"
    early_stop_mode: str = "max"      # max | min — independent of best_mode
    early_stop_min_delta: float = 0.0
    data_placement: str = "replicated"  # only "replicated" is ported
    compile_cache_dir: str = ""       # not ported: must stay ""
    # background-thread host input pipeline (train/data.AsyncLoader); batch
    # order and content are identical either way
    async_loader: bool = True


def _refuse_unported(c: TrainerConfig) -> None:
    """Raise for every TrainerConfig value the port cannot honour yet."""
    refusals = [
        (c.mesh is not None, "mesh: sharding over a device mesh is ported "
         "with the parallelism slice (ROADMAP Queue A item 8)"),
        (c.fused_steps > 1, "fused_steps > 1: multi-step dispatch is not "
         "ported (ROADMAP Queue A item 3)"),
        (bool(c.compile_cache_dir), "compile_cache_dir: the restart-warm "
         "compile cache is not ported (ROADMAP Queue A item 3)"),
        (bool(c.profile_dir), "profile_dir: the profiler trace of fit is "
         "not ported (ROADMAP Queue A item 3)"),
        (c.data_placement != "replicated",
         f"data_placement={c.data_placement!r}: per-process data needs the "
         "distributed bootstrap (ROADMAP Queue A item 6)"),
    ]
    for hit, why in refusals:
        if hit:
            raise NotImplementedError(why)


def cross_entropy_loss(logits: torch.Tensor,
                       labels: torch.Tensor) -> torch.Tensor:
    """Mean softmax cross entropy with integer labels."""
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]).float(),
                           labels.reshape(-1).long())


def classification_eval_metrics(logits: torch.Tensor, labels: torch.Tensor):
    """Default eval contract: per-example (loss, accuracy), each (B,);
    token-level labels reduce their trailing dims to per-example."""
    per_ex = F.cross_entropy(
        logits.reshape(-1, logits.shape[-1]).float(),
        labels.reshape(-1).long(), reduction="none").view(labels.shape)
    acc = (logits.argmax(-1) == labels.long()).float()
    while per_ex.ndim > 1:
        per_ex = per_ex.mean(-1)
    while acc.ndim > 1:
        acc = acc.mean(-1)
    return per_ex, acc


@dataclass
class TrainState:
    """The step, the model (whose parameters are the trained state) and the
    optimizer (its moments and counts). ``train_step`` updates it in place;
    ``state_dict``/``load_state_dict`` are what a checkpoint holds."""

    step: int
    model: nn.Module
    optimizer: torch.optim.Optimizer

    def state_dict(self) -> dict:
        return {"step": self.step, "model": self.model.state_dict(),
                "optimizer": self.optimizer.state_dict()}

    def load_state_dict(self, sd: dict) -> None:
        self.model.load_state_dict(sd["model"])
        self.optimizer.load_state_dict(sd["optimizer"])
        self.step = int(sd["step"])


def _as_dtype(dt) -> torch.dtype:
    if isinstance(dt, torch.dtype):
        return dt
    if dt not in _DTYPES:
        raise ValueError(f"compute_dtype {dt!r} is not one of "
                         f"{sorted(_DTYPES)} or a torch dtype")
    return _DTYPES[dt]


class Trainer:
    """Trainer for a module ``model(x) -> logits`` on the device of its
    parameters. A model whose forward takes ``train`` (and ``generator``,
    for dropout) is called with them. The model arrives with its weights
    (``GPTLM.init_weights``, a converted checkpoint); ``config.seed`` seeds
    dropout and the batch order."""

    def __init__(
        self,
        model: nn.Module,
        config: TrainerConfig,
        loss_fn: Callable[[torch.Tensor, torch.Tensor],
                          torch.Tensor] = cross_entropy_loss,
        eval_metrics_fn: Callable | None = None,
    ):
        _refuse_unported(config)
        self.config = config
        self.model, self.compute_dtype = self.resolve_compute_dtype(
            model, config)
        self.device = next(model.parameters()).device
        self.loss_fn = loss_fn
        # per-example (loss, accuracy) for eval AND the train-step accuracy
        self.eval_metrics_fn = eval_metrics_fn or classification_eval_metrics
        params = inspect.signature(self.model.forward).parameters
        self._accepts_train = "train" in params
        self._accepts_generator = "generator" in params
        if config.lr_schedule == "cosine":
            if config.steps is None:
                raise ValueError(
                    "lr_schedule=cosine requires TrainerConfig.steps")
            if config.steps - config.warmup_steps <= 0:
                raise ValueError(
                    "The cosine_decay_schedule requires positive "
                    f"decay_steps, got decay_steps="
                    f"{config.steps - config.warmup_steps}.")
        self.checkpointer = (
            Checkpointer(
                config.checkpoint_dir,
                max_to_keep=config.checkpoint_max_to_keep,
                keep_best_metric=config.keep_best_metric,
                best_mode=config.best_mode,
            )
            if config.checkpoint_dir else None
        )

    # -------------------------------------------------------------- dtype

    @staticmethod
    def resolve_compute_dtype(model: nn.Module, config: TrainerConfig,
                              device_type: str | None = None):
        """(the module to train, the compute dtype).

        An explicit config.compute_dtype wins verbatim (float32 is the
        bf16 opt-out) and the module is returned unchanged. Under AUTO
        (None), a model publishing PREFERRED_COMPUTE_DTYPE gets that dtype
        on the card: the returned module shares the model's float32
        parameters and computes in it (``with_compute_dtype``). The CPU,
        and models without a preference, resolve AUTO to float32.
        ``device_type`` (default: that of the model's parameters) is
        injectable so the CPU tests can exercise the card's policy."""
        if config.compute_dtype is not None:
            return model, _as_dtype(config.compute_dtype)
        pref = getattr(model, "PREFERRED_COMPUTE_DTYPE", None)
        device_type = device_type or next(model.parameters()).device.type
        if pref is None or device_type == "cpu":
            return model, torch.float32
        if hasattr(model, "with_compute_dtype"):
            model = model.with_compute_dtype(pref)
        return model, _as_dtype(pref)

    # ----------------------------------------------------------- optimizer

    def learning_rate(self, count: int) -> float:
        """The schedule at ``count`` updates already applied, as optax
        evaluates it: linear warmup from 0 (optax.linear_schedule), then
        constant or cosine decay (optax.warmup_cosine_decay_schedule)."""
        c = self.config
        lr, warm = c.learning_rate, c.warmup_steps
        if c.lr_schedule == "cosine":
            if warm and count < warm:
                return lr * count / warm
            decay = c.steps - warm
            t = min(count - warm, decay)
            alpha = c.lr_final_fraction if lr else 0.0
            cosine = 0.5 * (1 + math.cos(math.pi * t / decay))
            return lr * ((1 - alpha) * cosine + alpha)
        if warm:
            return lr * min(max(count, 0), warm) / warm
        return lr

    def init_state(self) -> TrainState:
        """A fresh TrainState: step 0, the model as it stands, and a new
        optimizer (optax.adam, or optax.adamw when weight_decay is set)."""
        c = self.config
        params = [p for p in self.model.parameters() if p.requires_grad]
        opt = (torch.optim.AdamW(params, lr=c.learning_rate,
                                 weight_decay=c.weight_decay)
               if c.weight_decay else
               torch.optim.Adam(params, lr=c.learning_rate))
        return TrainState(step=0, model=self.model, optimizer=opt)

    # --------------------------------------------------------------- steps

    def _place(self, batch):
        return tuple(b if isinstance(b, torch.Tensor) and b.device ==
                     self.device else to_device((b,), self.device)[0]
                     for b in batch)

    def _cast(self, x: torch.Tensor) -> torch.Tensor:
        """Float inputs to the RESOLVED compute dtype; ids untouched."""
        return x.to(self.compute_dtype) if x.is_floating_point() else x

    def _apply(self, model, x, generator, train: bool):
        kw = {}
        if self._accepts_train:
            kw["train"] = train
        if self._accepts_generator and generator is not None:
            kw["generator"] = generator
        return model(x, **kw)

    def _step_generator(self, step: int) -> torch.Generator:
        """The dropout seeds of one step: a function of (seed, step) only,
        so a resumed run draws the masks the uninterrupted one drew."""
        seed = int(np.random.SeedSequence(
            [self.config.seed, step]).generate_state(1, np.uint64)[0])
        return torch.Generator().manual_seed(seed)

    def train_step(self, state: TrainState, batch) -> tuple[TrainState, dict]:
        """One optimizer step on batch (x, y) — host arrays or tensors —
        with grad_accum_steps microbatches. Returns the state and its
        metrics (0-dim tensors on the device: loss, accuracy, grad_norm)."""
        c = self.config
        x, y = self._place(batch)
        x = self._cast(x)
        n_acc = max(c.grad_accum_steps, 1)
        if x.shape[0] % n_acc:
            raise ValueError(
                f"batch {x.shape[0]} not divisible by "
                f"grad_accum_steps {n_acc}")
        opt = state.optimizer
        opt.zero_grad(set_to_none=True)
        gen = self._step_generator(state.step)
        loss_sum = acc_sum = 0.0
        for mx, my in zip(x.chunk(n_acc), y.chunk(n_acc)):
            logits = self._apply(state.model, mx, gen, True).float()
            loss = self.loss_fn(logits, my)
            loss.backward()
            with torch.no_grad():
                acc = self.eval_metrics_fn(logits.detach(), my)[1].mean()
            loss_sum = loss_sum + loss.detach()
            acc_sum = acc_sum + acc
        params = [p for g in opt.param_groups for p in g["params"]
                  if p.grad is not None]
        grads = [p.grad for p in params]
        if n_acc > 1:  # the mean of the microbatch grads
            for g in grads:
                g.div_(n_acc)
        grad_norm = torch.linalg.vector_norm(
            torch.stack([torch.linalg.vector_norm(g.float())
                         for g in grads]))
        if c.grad_clip_norm > 0:
            clip = torch.tensor(c.grad_clip_norm, device=grad_norm.device)
            factor = torch.where(grad_norm < clip, 1.0, clip / grad_norm)
            for g in grads:
                g.mul_(factor)
        lr = self.learning_rate(state.step)
        for group in opt.param_groups:
            group["lr"] = lr
        opt.step()
        state.step += 1
        return state, {"loss": loss_sum / n_acc, "accuracy": acc_sum / n_acc,
                       "grad_norm": grad_norm}

    # ---------------------------------------------------------------- eval

    @torch.no_grad()
    def evaluate(self, state: TrainState,
                 dataset: Dataset) -> dict[str, float]:
        """Mean per-example loss and accuracy over the whole test split;
        the tail batch is zero-padded to the batch size and masked."""
        c = self.config
        bs = min(c.batch_size, len(dataset.x_test))
        tot_loss, correct, count = 0.0, 0.0, 0
        for bx, by in batches(dataset.x_test, dataset.y_test, bs,
                              drop_remainder=False):
            n = len(bx)
            if n < bs:
                pad = bs - n
                bx = np.concatenate(
                    [bx, np.zeros((pad, *bx.shape[1:]), bx.dtype)])
                by = np.concatenate(
                    [by, np.zeros((pad, *by.shape[1:]), by.dtype)])
            w = (np.arange(bs) < n).astype(np.float32)
            x, y, wt = to_device((bx, by, w), self.device)
            logits = self._apply(state.model, self._cast(x), None,
                                 False).float()
            per_ex, acc = self.eval_metrics_fn(logits, y)
            tot_loss += float((per_ex * wt).sum())
            correct += float((acc * wt).sum())
            count += n
        return {"loss": tot_loss / max(count, 1),
                "accuracy": correct / max(count, 1)}

    # ----------------------------------------------------------------- fit

    def fit(
        self,
        dataset: Dataset,
        *,
        resume: bool = True,
        on_epoch_end: Callable[[int, dict], None] | None = None,
    ) -> tuple[TrainState, dict]:
        for env, entry in ((ENV_PROFILE_DIR, "ROADMAP Queue A item 3"),
                           (ENV_TRACE_DIR, "ROADMAP Queue A item 12")):
            if os.environ.get(env):
                raise NotImplementedError(
                    f"{env} is set: fit's profiler trace and tracing spans "
                    f"are not ported ({entry})")
        c = self.config
        state = self.init_state()
        event_dir = c.event_dir or os.environ.get(ENV_EVENT_DIR, "")
        events = metrics_lib.TfEventsWriter(event_dir) if event_dir else None

        start_step = 0
        if resume and self.checkpointer is not None:
            restored = self.checkpointer.restore_latest(state)
            if restored is not None:
                start_step, state = restored
                metrics_lib.emit(step=start_step, resumed=1)

        # preemption contract: on SIGTERM save a checkpoint and return
        # cleanly so the gang restart resumes instead of losing the epoch
        # (signals bind only on the main thread; elsewhere skip). The
        # previous handler is restored when fit() returns.
        preempted = {"flag": False}
        prev_handler = None
        if self.checkpointer is not None:
            def _on_term(signum, frame):
                preempted["flag"] = True

            try:
                prev_handler = signal.signal(signal.SIGTERM, _on_term)
            except ValueError:
                pass
        try:
            return self._fit_loop(dataset, c, state, start_step, events,
                                  preempted, on_epoch_end)
        finally:
            if prev_handler is not None:
                try:
                    signal.signal(signal.SIGTERM, prev_handler)
                except ValueError:
                    pass

    def _fit_loop(self, dataset, c, state, start_step, events, preempted,
                  on_epoch_end):
        # liveness contract: one heartbeat per optimizer step through the
        # pod env's KFTPU_HEARTBEAT_FILE (None for standalone runs)
        hb = HeartbeatWriter.from_env()
        if hb is not None:
            hb.beat(step=start_step, phase="fit-start")

        per_epoch = len(dataset.x_train) // c.batch_size
        if per_epoch == 0:
            raise ValueError(
                f"batch_size {c.batch_size} exceeds train set size "
                f"{len(dataset.x_train)}: no full batch can be formed"
            )
        total_steps = c.steps if c.steps is not None else c.epochs * per_epoch
        timer = metrics_lib.Timer()
        global_step = start_step
        last: dict = {}
        epoch = global_step // per_epoch
        stop = False
        es_best, es_bad = None, 0  # early-stopping plateau tracking

        def after(m) -> bool:
            """Bookkeeping after one step; True when fit must stop."""
            nonlocal global_step, last, stop
            global_step += 1
            if hb is not None:
                hb.beat(step=global_step)
            timer.tick(items=c.batch_size, steps=1)
            if (global_step % c.log_every_steps == 0
                    or global_step == total_steps):
                last = {k: float(v) for k, v in m.items()}
                metrics_lib.emit(
                    step=global_step, **last,
                    images_per_sec=timer.items_per_sec,
                    steps_per_sec=timer.steps_per_sec)
                if events is not None:
                    events.scalars(global_step, **last,
                                   images_per_sec=timer.items_per_sec)
            if preempted["flag"]:
                # rescue saves carry NO metrics: kept outside the best
                # ranking, never returned by best_step
                self.checkpointer.save(global_step, state)
                metrics_lib.emit(step=global_step, preempted=1)
                stop = True
                return True
            if (self.checkpointer is not None and not c.keep_best_metric
                    and global_step % c.checkpoint_every_steps == 0):
                self.checkpointer.save(global_step, state)
            return False

        while global_step < total_steps:
            raw = batches(dataset.x_train, dataset.y_train, c.batch_size,
                          seed=c.seed + epoch)
            loader = None
            if c.async_loader:
                loader = AsyncLoader(
                    raw, transform=lambda b: to_device(b, self.device),
                    size=2)
                batch_src = loader
            else:
                batch_src = prefetch_to_device(raw, self.device)
            try:
                for bx, by in batch_src:
                    if global_step >= total_steps or stop:
                        break
                    state, m = self.train_step(state, (bx, by))
                    if after(m):
                        break
            finally:
                # every exit path joins the loader thread
                if loader is not None:
                    loader.close()
            if stop:
                return state, {**last, "preempted": 1.0}
            epoch += 1
            if epoch % c.eval_every_epochs == 0:
                ev = self.evaluate(state, dataset)
                if hb is not None:
                    hb.beat(step=global_step, phase="eval")
                if self.checkpointer is not None and c.keep_best_metric:
                    # best-mode cadence: metrics only exist at evals
                    self.checkpointer.save(global_step, state, metrics=ev)
                metrics_lib.emit(step=global_step,
                                 **{f"eval_{k}": v for k, v in ev.items()})
                last.update({f"eval_{k}": v for k, v in ev.items()})
                if events is not None:
                    events.scalars(global_step, **{f"eval_{k}": v
                                                   for k, v in ev.items()})
                if on_epoch_end is not None:
                    on_epoch_end(epoch, ev)
                if c.early_stop_patience > 0:
                    if c.early_stop_metric not in ev:
                        raise ValueError(
                            f"early_stop_metric {c.early_stop_metric!r} "
                            f"not in eval metrics {sorted(ev)}")
                    cur = float(ev[c.early_stop_metric])
                    sign = 1.0 if c.early_stop_mode == "max" else -1.0
                    if (es_best is None or sign * cur
                            > sign * es_best + c.early_stop_min_delta):
                        es_best, es_bad = cur, 0
                    else:
                        es_bad += 1
                        if es_bad >= c.early_stop_patience:
                            metrics_lib.emit(step=global_step,
                                             early_stopped=1)
                            break

        final_eval = self.evaluate(state, dataset)
        if self.checkpointer is not None:
            self.checkpointer.save(global_step, state,
                                   metrics=dict(final_eval))
        metrics_lib.emit(step=global_step, **{f"final_{k}": v
                                              for k, v in final_eval.items()})
        if events is not None:
            events.scalars(global_step, **{f"final_{k}": v
                                           for k, v in final_eval.items()})
            events.close()
        return state, {**last, **{f"final_{k}": v
                                  for k, v in final_eval.items()}}
