"""The trainer — counterpart of ``kubeflow_tpu/train/trainer.py``.

One optimizer step per ``train_step`` on one device, eager: the model (its
float32 parameters) and a torch optimizer live in a ``TrainState`` that the
step updates in place. The semantics are the JAX Trainer's:

  - the compute dtype: AUTO resolves to the model's PREFERRED_COMPUTE_DTYPE
    (bfloat16 for GPTLM, ResNet, the BERT models and ViT; the MNIST models
    have none) on the card and float32 on the CPU, and the model then
    computes in it while its parameters stay float32; an explicit
    ``compute_dtype`` is honoured verbatim and only casts float inputs;
  - BatchNorm (ResNet): the running averages are module buffers that a
    ``train=True`` forward moves in place (the JAX Trainer threads them as
    the mutable ``batch_stats`` collection); eval (``train=False``) reads
    them, and checkpoints hold them with the parameters;
  - the optimizer: optax's adam/adamw (torch.optim.Adam/AdamW, the same
    update), its schedules evaluated at the count of updates already
    applied (the first update of a linear warmup has lr 0), and optax's
    global-norm clipping (g·max/‖g‖ only when ‖g‖ ≥ max); the step's
    ``loss``, ``accuracy`` and ``grad_norm`` come from the unclipped grads;
  - ``fit``: steps or epochs, ``name=value`` log lines, eval, checkpoint and
    early-stop cadence, resume, the SIGTERM preemption save, heartbeats;
    ``fused_steps`` chunks (the JAX package's one dispatch of k steps);
    the restart-warm kernel cache (``compile_cache_dir``); a
    torch.profiler trace of the fit (``profile_dir``); the tracing spans
    (``KFTPU_TRACE_DIR``) under the JAX trainer's names and attributes.

``fused_steps > 1`` on the card runs each full chunk of k steps as one
replay of a CUDA graph of k ``train_step``s, captured once per chunk length
(``train_chunk``): the chunk is uploaded into a static (k, B, ...) buffer.
The optimizer stays torch's Adam/AdamW; inside the graph its update is
written out (``_adam_update``) with the per-step scalars it computes on the
host (step size, bias correction, AdamW's decay) read from a static device
tensor the host fills before each replay, so a graphed step is the eager
step bit for bit. Dropout masks are functions of device seeds
(``models/layers.py`` ``DropoutSeeds``): each step's come from (seed,
step), and a graph reads its k steps' seeds from a static (k, n) device
buffer that the host refills before each replay, so a graphed step draws
the eager step's masks. Capture follows one warm-up step whose effects on
the parameters, buffers, optimizer state and step are undone. On the CPU a
chunk is k ``train_step``s in order.

Under a mesh (``TrainerConfig.mesh``, a ``MeshConfig`` over the ranks of
a ``torch.distributed`` gang, ``runtime.initialize_from_env``) the step is
the JAX package's sharded step: each rank computes the rows of the global
batch the data-like axes (data, fsdp, expert) give it (``data_placement=
"replicated"``: every process holds the whole batch; ``"process_local"``:
each holds only its own rows, ``train/data.load_dataset_shards``) and,
under a context axis, its chunk of every row's positions (a model with
ring or Ulysses attention, whose exchange the step enters:
``parallel.mesh.context_axis``); ``parallel/sharding.GangLayout`` places
the parameters by the partitioner's specs — FSDP2 over ``fsdp``, the
stacked experts over ``expert`` — and reduces the gradients over the
data-like and context ranks. The gang trains the JAX package's objective,
the loss of the global batch: a weighted token loss (``causal_lm_loss``,
``masked_lm_loss``: ``train/losses.py``) has its weights counted over the
gang before the backward, and each rank backpropagates its own sum over
that count; the logged loss and accuracy are the global batch's.
Auxiliary losses a model sows (the MoE load balance,
``parallel/moe.collect_losses``) are added to the objective, as the JAX
Trainer adds its ``losses`` collection.

What ``fit`` cannot honour yet raises NotImplementedError naming its
ROADMAP entry; it is never silently ignored.
"""

from __future__ import annotations

import contextlib
import inspect
import math
import os
import signal
import time
from dataclasses import dataclass
from typing import Any, Callable

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from kubeflow_tpu_torch.health import HeartbeatWriter
from kubeflow_tpu_torch.kernels.build import (
    add_launches,
    launch_counts,
    launches_since,
)
from kubeflow_tpu_torch.models.layers import (
    DROPOUT_SEEDS_PER_STEP,
    DropoutSeeds,
    as_torch_dtype,
)
from kubeflow_tpu_torch.parallel.mesh import (
    Mesh,
    MeshConfig,
    build_mesh,
    context_axis,
)
from kubeflow_tpu_torch.parallel.moe import collect_losses
from kubeflow_tpu_torch.parallel.partitioner import Partitioner
from kubeflow_tpu_torch.parallel.sharding import (
    GangLayout,
    LocalBatch,
    local_tensor,
    put_sequence,
    refuse_unexecuted,
    shard_batch,
)
from kubeflow_tpu_torch.train import metrics as metrics_lib
from kubeflow_tpu_torch.train.checkpoint import Checkpointer
from kubeflow_tpu_torch.train.data import (
    AsyncLoader,
    Dataset,
    batches,
    prefetch_to_device,
    to_device,
)

from kubeflow_tpu_torch.tracing.core import init_worker_from_env
from kubeflow_tpu_torch.utils import compile_cache
from kubeflow_tpu_torch.utils.envvars import ENV_EVENT_DIR, ENV_PROFILE_DIR

#: parameters' elements a CUDA graph's Adam update takes at a time
ADAM_SLICE_ELEMENTS = 2**28

#: real steps taken (and undone) before a CUDA graph of the step is captured:
#: they allocate what the step allocates once (cuBLAS workspaces, Adam's
#: moments, autograd's buffers)
GRAPH_WARMUP_STEPS = 1


def _traced_data_iter(tracer, it, stats_from=None):
    """Wrap a batch iterator so each host-side fetch is a train.data_load
    span carrying its fetch sequence number; ``stats_from`` (an
    AsyncLoader) stamps the queue wait and the producer's assemble time on
    it. The span is closed before the batch is yielded, and on every exit."""
    it = iter(it)
    seq = 0
    while True:
        sp = tracer.start_span("train.data_load", seq=seq)
        seq += 1
        try:
            batch = next(it)
            if stats_from is not None:
                st = stats_from.pop_stats()
                sp.set_attribute("wait_s", round(st["wait_s"], 9))
                sp.set_attribute("assemble_s", round(st["assemble_s"], 9))
        except StopIteration:
            return
        finally:
            sp.end()
        yield batch


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
    # optimizer steps per dispatch in fit(): full chunks of exactly this
    # many steps (one CUDA graph replay on the card), the epoch tail and
    # the `steps` boundary step by step; log, checkpoint and preemption
    # cadence becomes chunk-granular. 1 = per-step dispatch
    fused_steps: int = 1
    seed: int = 0                     # dropout masks and batch order
    # None = AUTO (see the module docstring); else "float32", "bfloat16"
    # or a torch dtype, honoured verbatim
    compute_dtype: Any = None
    eval_every_epochs: int = 1
    checkpoint_dir: str | None = None
    checkpoint_every_steps: int = 200
    log_every_steps: int = 50
    # None = one process; a MeshConfig (or a parallel.mesh.Mesh) lays the
    # gang's ranks over the named axes (data, fsdp, expert and context
    # execute)
    mesh: MeshConfig | Mesh | None = None
    # torch.profiler Chrome trace of fit; "" defers to KFTPU_PROFILE_DIR
    profile_dir: str = ""
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
    # "replicated": every process feeds the identical full batch (the
    # seed-deterministic pipeline convention); "process_local": each
    # process feeds ONLY its own rows (batch_size / its data-like extent;
    # train/data.py load_dataset_shards), the gang's global batch
    data_placement: str = "replicated"  # replicated | process_local
    # restart-warm kernel cache (utils/compile_cache.py); "" defers to
    # KFTPU_COMPILE_CACHE_DIR. When a dir resolves, fit builds and loads the
    # kernels' libraries there (and captures the chunk's CUDA graph) under a
    # train.compile span before the first step: a restarted incarnation
    # runs nvcc zero times
    compile_cache_dir: str = ""
    # background-thread host input pipeline (train/data.AsyncLoader); batch
    # order and content are identical either way
    async_loader: bool = True


def _refuse_unported(c: TrainerConfig) -> None:
    """Raise for every TrainerConfig value the port cannot honour yet: a
    mesh axis it does not execute (model, pipeline)."""
    if c.data_placement not in ("replicated", "process_local"):
        raise ValueError(f"data_placement {c.data_placement!r} is not "
                         "replicated|process_local")
    if c.mesh is not None:
        refuse_unexecuted(c.mesh.sizes() if isinstance(c.mesh, MeshConfig)
                          else c.mesh.shape)


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
    """The step, the model (whose parameters and buffers — BatchNorm's
    running averages — are the trained state) and the optimizer (its
    moments and counts). ``train_step`` updates it in place;
    ``state_dict``/``load_state_dict`` are what a checkpoint holds."""

    step: int
    model: nn.Module
    optimizer: torch.optim.Optimizer
    #: bumped by load_state_dict, which replaces the optimizer's state
    #: tensors: a CUDA graph captured over the old ones must not replay
    generation: int = 0
    #: a gang's layout: the state saves as full tensors (the one-process
    #: state_dict) and restores onto any layout; collective under a gang
    layout: GangLayout | None = None

    def state_dict(self) -> dict:
        if self.layout is not None:
            return {"step": self.step, **self.layout.state_dict(
                self.model, self.optimizer)}
        return {"step": self.step, "model": self.model.state_dict(),
                "optimizer": self.optimizer.state_dict()}

    def load_state_dict(self, sd: dict) -> None:
        if self.layout is not None:
            self.layout.load_state_dict(self.model, self.optimizer, sd)
        else:
            self.model.load_state_dict(sd["model"])
            self.optimizer.load_state_dict(sd["optimizer"])
        self.step = int(sd["step"])
        self.generation += 1


class Trainer:
    """Trainer for a module ``model(x) -> logits`` on the device of its
    parameters. A model whose forward takes ``train`` (and ``generator``,
    for dropout: the step's ``DropoutSeeds``) is called with them. The
    model arrives with its weights (``GPTLM.init_weights``, a converted
    checkpoint); ``config.seed`` seeds dropout and the batch order.

    Under ``config.mesh`` every rank of the gang builds its Trainer from
    the same weights, and the module it trains is sharded in place by the
    model's PARTITION_RULES (``parallel/sharding.GangLayout``): read the
    trained weights from ``state.state_dict()``, which gathers them."""

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
        self.mesh = self.layout = None
        if config.mesh is not None:
            self.mesh = (config.mesh if isinstance(config.mesh, Mesh)
                         else build_mesh(config.mesh,
                                         device_type=self.device.type))
            self.layout = GangLayout(self.model, self.mesh, Partitioner(
                mesh=self.mesh,
                path_specs=getattr(model, "PARTITION_RULES", None)))
            if (self.layout.sharded and config.fused_steps > 1
                    and self.device.type == "cuda"):
                raise NotImplementedError(
                    "fused_steps > 1 under an fsdp axis above 1 on the card:"
                    " FSDP2's collectives are not captured in a CUDA graph "
                    "(ROADMAP Queue A item 3)")
            if self.layout.context > 1:
                if not getattr(self.model, "shards_sequence", False):
                    raise NotImplementedError(
                        f"a context axis of {self.layout.context} splits "
                        "every sequence: the model must attend with ring or "
                        "ulysses attention (GPTLM and the BERT models with "
                        "attention='ring'|'ulysses')")
                if config.fused_steps > 1 and self.device.type == "cuda":
                    raise NotImplementedError(
                        "fused_steps > 1 under a context axis above 1 on the"
                        " card: the ring's P2P exchanges are not proven "
                        "inside a CUDA graph, which one card cannot show "
                        "(ROADMAP Queue A item 3)")
        self.loss_fn = loss_fn
        # per-example (loss, accuracy) for eval AND the train-step accuracy
        self.eval_metrics_fn = eval_metrics_fn or classification_eval_metrics
        #: the loss' (sum, count) form (train/losses.py), which a gang reduces
        self._weighted = getattr(loss_fn, "weighted", None)
        if (self._gang and self._weighted is not None and getattr(
                self.eval_metrics_fn, "weighted", None) is not self._weighted):
            raise ValueError(
                "a weighted token loss under a gang takes the eval metrics "
                "of the same weighted form (causal_lm_loss with "
                "causal_lm_eval_metrics, masked_lm_loss with "
                "masked_lm_eval_metrics): the gang counts both over its "
                "ranks")
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
        self._graphs: dict[tuple, _StepGraph] = {}
        #: real steps taken and undone before captures (their kernel
        #: launches ran on the card and are counted)
        self.graph_warmups = 0

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
            return model, as_torch_dtype(config.compute_dtype)
        pref = getattr(model, "PREFERRED_COMPUTE_DTYPE", None)
        device_type = device_type or next(model.parameters()).device.type
        if pref is None or device_type == "cpu":
            return model, torch.float32
        if hasattr(model, "with_compute_dtype"):
            model = model.with_compute_dtype(pref)
        return model, as_torch_dtype(pref)

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
        return TrainState(step=0, model=self.model, optimizer=opt,
                          layout=self.layout)

    def _optimizer_step(self, state: TrainState) -> None:
        """The optimizer's update at the schedule's learning rate."""
        lr = self.learning_rate(state.step)
        for group in state.optimizer.param_groups:
            group["lr"] = lr
        state.optimizer.step()

    def _update_scalars(self, state: TrainState, k: int) -> torch.Tensor:
        """What torch's Adam computes on the host for each of the next k
        steps, in double as it does, and hands its kernels as float32: a
        (k, 3) float32 tensor of (-lr / (1 - beta1^t), sqrt(1 - beta2^t),
        AdamW's decay 1 - lr * weight_decay)."""
        opt = state.optimizer
        group = opt.param_groups[0]
        beta1, beta2 = group["betas"]
        first = next(p for p in group["params"] if p in opt.state)
        count = float(opt.state[first]["step"])
        rows = []
        for i in range(k):
            lr, t = self.learning_rate(state.step + i), count + i + 1
            rows.append(((lr / (1 - beta1 ** t)) * -1,
                         (1 - beta2 ** t) ** 0.5,
                         1 - lr * group["weight_decay"]))
        return torch.tensor(rows, dtype=torch.float32)

    # --------------------------------------------------------------- steps

    @property
    def _process_local(self) -> bool:
        return self.config.data_placement == "process_local"

    @property
    def _gang(self) -> bool:
        """Whether a step reduces over other ranks (data-like or context)."""
        return self.layout is not None and self.layout.gang

    def _context(self):
        """The gang's context axis entered (nothing without one): ring and
        Ulysses attention exchange over it, the models number positions
        from it. Around the forward, the loss and the backward; remat
        carries the axis into its recompute itself (``layers.remat``)."""
        axis = None if self.layout is None else self.layout.context_axis
        return context_axis(axis) if axis is not None \
            else contextlib.nullcontext()

    def _per_process_batch(self) -> int:
        """Rows a process feeds a step: all of them, or its own share under
        process_local."""
        n = self.layout.size if self.layout is not None else 1
        return self.config.batch_size // (n if self._process_local else 1)

    def _local(self, batch, stacked: bool = False):
        """This rank's part of a host batch: its rows (the batch dim split
        over the data-like axes; taken as they are under process_local),
        then its tokens (``_tokens``); a ``LocalBatch`` is this rank's
        already."""
        if not self._gang or isinstance(batch, LocalBatch):
            return batch
        rows = shard_batch(batch, self.mesh, self._process_local, stacked)
        return self._tokens(rows, 2 if stacked else 1)

    def _tokens(self, batch, dim: int) -> LocalBatch:
        """Rows (x, y, ...) as this rank's tokens: a weighted loss' labels
        aligned to their positions over the whole sequence (the causal
        shift happens before the split), then under a context axis x and
        per-position labels cut to this rank's chunk of positions
        (``dim`` the sequence dim)."""
        x, y, *rest = (torch.as_tensor(a) for a in batch)
        per_position = y.ndim > dim and y.shape[dim] == x.shape[dim]
        if self._weighted is not None:
            y = self._weighted.align(y, dim)
        if self.layout.context > 1:
            x = put_sequence(x, self.mesh, dim=dim)
            if per_position:
                y = put_sequence(y, self.mesh, dim=dim)
        return LocalBatch((x, y, *rest))

    def _upload(self, batch):
        """A host batch's rows for this rank, on the device."""
        if self.layout is None:
            return to_device(batch, self.device)
        return LocalBatch(to_device(self._local(batch), self.device))

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

    def _step_seeds(self, step: int) -> torch.Tensor:
        """One step's dropout seeds on the host, DROPOUT_SEEDS_PER_STEP
        int64s: a function of (seed, step) only, so a resumed run draws the
        masks the uninterrupted one drew. The eager step takes its seeds
        from them, and a graph's seed buffer holds them for that step."""
        seed = int(np.random.SeedSequence(
            [self.config.seed, step]).generate_state(1, np.uint64)[0])
        return torch.randint(0, 2**62, (DROPOUT_SEEDS_PER_STEP,),
                             generator=torch.Generator().manual_seed(seed))

    def train_step(self, state: TrainState, batch) -> tuple[TrainState, dict]:
        """One optimizer step on batch (x, y) — host arrays or tensors —
        with grad_accum_steps microbatches. Returns the state and its
        metrics (0-dim tensors on the device: loss, accuracy, grad_norm).
        Under a gang the batch is the global one (this process's rows
        under process_local) and the metrics are the gang's."""
        return self._step(state, self._local(batch), self._optimizer_step)

    def _step(self, state: TrainState, batch,
              update: Callable[[TrainState], None],
              seeds: DropoutSeeds | None = None
              ) -> tuple[TrainState, dict]:
        """train_step, its optimizer update done by ``update(state)`` (a
        CUDA graph's reads its scalars from device tensors) and its dropout
        seeds taken from ``seeds`` (default: this step's, ``_step_seeds``;
        a graph's: a row of its device buffer). Nothing in it waits for the
        device, so a graph can capture it."""
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
        gen = seeds if seeds is not None else DropoutSeeds(
            self._step_seeds(state.step))
        gang = self._gang
        loss_sum = acc_sum = 0.0
        with self._context():
            for mx, my in zip(x.chunk(n_acc), y.chunk(n_acc)):
                with collect_losses() as sown:
                    logits = self._apply(state.model, mx, gen, True).float()
                # the model's sown aux losses join the objective
                aux = sum(a.float() for a in sown) if sown else None
                if gang:
                    loss, acc = self._gang_backward(logits, my, aux)
                else:
                    loss = self.loss_fn(logits, my)
                    if aux is not None:
                        loss = loss + aux
                    loss.backward()
                    with torch.no_grad():
                        acc = self.eval_metrics_fn(logits.detach(),
                                                   my)[1].mean()
                loss_sum = loss_sum + loss.detach()
                acc_sum = acc_sum + acc
        params = [p for g in opt.param_groups for p in g["params"]
                  if p.grad is not None]
        grads = [local_tensor(p.grad) for p in params]
        if n_acc > 1:  # the mean of the microbatch grads
            for g in grads:
                g.div_(n_acc)
        if gang:
            self.layout.sync_grads(state.model)
            grad_norm = self.layout.grad_norm(state.model)
            # the global batch's loss and accuracy: every rank's share
            loss_sum, acc_sum = self.layout.mean(
                torch.stack([loss_sum, acc_sum]), "tokens").unbind(0)
        else:
            grad_norm = torch.linalg.vector_norm(
                torch.stack([torch.linalg.vector_norm(g.float())
                             for g in grads]))
        if c.grad_clip_norm > 0:
            clip = torch.full_like(grad_norm, c.grad_clip_norm)
            factor = torch.where(grad_norm < clip, 1.0, clip / grad_norm)
            for g in grads:
                g.mul_(factor)
        update(state)
        state.step += 1
        return state, {"loss": loss_sum / n_acc, "accuracy": acc_sum / n_acc,
                       "grad_norm": grad_norm}

    def _gang_backward(self, logits, labels, aux):
        """A gang member's backward of the global batch's objective: (its
        share of the logged loss, of the accuracy), whose mean over the
        gang's data-like and context ranks is the global batch's.

        A weighted token loss' count is summed over the gang first; the
        member backpropagates its own sum times the data-like extent over
        that count, which ``sync_grads``' sum and division turn into the
        gradient of the global weighted mean. The accuracy is the mean over
        rows of each row's weighted hits, counted over its context ranks.
        Any other loss is each member's own over the context extent (its
        rows weigh as every other member's)."""
        lay = self.layout
        if self._weighted is None:
            loss = self.loss_fn(logits, labels)
            if aux is not None:
                loss = loss + aux
            (loss / lay.context if lay.context > 1 else loss).backward()
            with torch.no_grad():
                acc = self.eval_metrics_fn(logits.detach(), labels)[1].mean()
            return loss, acc
        num, hits, w = self._weighted.sums(logits, labels)
        total = num.sum()
        count = lay.sum(w.sum().detach(), "tokens").clamp_min(1.0)
        loss = total * (lay.size / count)
        if aux is not None:
            loss = loss + aux
        loss.backward()
        with torch.no_grad():
            hw = torch.stack([hits, w])
            if lay.context > 1:
                hw = lay.sum(hw, "context")
            acc = (hw[0] / hw[1].clamp_min(1.0)).mean()
            share = total.detach() * (lay.size * lay.context) / count
        return (share if aux is None else share + aux.detach()), acc

    # -------------------------------------------------------- fused steps

    def train_steps_fused(self, state: TrainState, batch,
                          n: int) -> tuple[TrainState, dict]:
        """n optimizer steps on one constant batch; the last step's metrics.
        On the card one replay of the n-step CUDA graph (captured at first
        use, or by ``compile_fused``); on the CPU n ``train_step``s."""
        batch = self._local(batch)
        if self.device.type != "cuda":
            return self._eager_steps(state, [batch] * n)
        return self._replay(state, batch, n, scanned=False)

    def train_chunk(self, state: TrainState, stacked,
                    k: int) -> tuple[TrainState, dict]:
        """k optimizer steps over a host-stacked chunk (xs (k, B, ...), ys
        (k, B, ...)), step i on slice i; the last step's metrics. On the
        card one replay of the chunk's CUDA graph; on the CPU k
        ``train_step``s in order."""
        stacked = self._local(stacked, stacked=True)
        if self.device.type != "cuda":
            return self._eager_steps(
                state, [tuple(a[i] for a in stacked) for i in range(k)])
        return self._replay(state, stacked, k, scanned=True)

    def compile_fused(self, state: TrainState, batch, n: int):
        """Prepare the n-step program of ``train_steps_fused`` WITHOUT
        taking a step: on the card, the warm-up (undone) and the capture of
        its CUDA graph. Returns (program, placed_batch): ``program(state,
        placed_batch)`` runs the n steps; on the card placed_batch is the
        graph's static input buffers, already holding the batch."""
        batch = self._local(batch)
        if self.device.type == "cuda":
            graph = self._graph(state, batch, n, scanned=False)
            graph.upload(batch)
            placed = graph.inputs
        else:
            placed = self._place(batch)

        def program(st: TrainState, b):
            if self.device.type != "cuda":
                return self._eager_steps(st, [b] * n)
            return self._replay(st, b, n, scanned=False)

        return program, placed

    def _eager_steps(self, state: TrainState, batches_) -> tuple:
        """``train_step`` on each of batches that are this rank's rows
        already."""
        m: dict = {}
        for b in batches_:
            state, m = self.train_step(state, LocalBatch(b))
        return state, m

    def _replay(self, state: TrainState, batch, k: int, scanned: bool):
        graph = self._graph(state, batch, k, scanned)
        graph.upload(batch)
        graph.scalars.copy_(self._update_scalars(state, k))
        graph.seeds.copy_(self._graph_seeds(state, k))
        graph.graph.replay()
        add_launches(graph.launches)
        opt = state.optimizer
        torch._foreach_add_([opt.state[p]["step"] for p in graph.params],
                            float(k))
        state.step += k
        return state, {name: v.clone() for name, v in graph.metrics.items()}

    def _graph(self, state: TrainState, batch, k: int,
               scanned: bool) -> "_StepGraph":
        """The CUDA graph of k steps for this state and batch layout,
        captured now if there is none yet (or the state's tensors were
        replaced since)."""
        xs = tuple(torch.as_tensor(a) for a in batch)
        key = (k, scanned, tuple((tuple(t.shape), t.dtype) for t in xs))
        graph = self._graphs.get(key)
        if (graph is None or graph.state is not state
                or graph.generation != state.generation):
            self._graphs.pop(key, None)
            graph = self._capture(state, xs, k, scanned)
            self._graphs[key] = graph
        return graph

    def _graph_seeds(self, state: TrainState, k: int) -> torch.Tensor:
        """The next k steps' dropout seeds, one row a step."""
        return torch.stack([self._step_seeds(state.step + i)
                            for i in range(k)])

    def _capture(self, state: TrainState, sample, k: int,
                 scanned: bool) -> "_StepGraph":
        opt = state.optimizer
        _check_adam(opt)
        dev = self.device
        inputs = tuple(torch.empty(t.shape, dtype=t.dtype, device=dev)
                       for t in sample)
        for buf, t in zip(inputs, sample):
            buf.copy_(t)

        def step_batch(i):
            return tuple(b[i] for b in inputs) if scanned else inputs

        snap = _snapshot(state)
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):  # makes Adam's state, among others
            for i in range(GRAPH_WARMUP_STEPS):
                self._step(state, step_batch(i % k), self._optimizer_step)
        torch.cuda.current_stream(dev).wait_stream(side)
        self.graph_warmups += GRAPH_WARMUP_STEPS
        _restore(state, snap)
        del snap
        scalars = self._update_scalars(state, k).to(dev)
        seeds = self._graph_seeds(state, k).to(dev)
        opt.zero_grad(set_to_none=True)  # grads from the graph's pool
        # the eager blocks freed above cannot serve the graph's pool: at
        # billions of parameters the card holds the state only once
        torch.cuda.empty_cache()
        graph = torch.cuda.CUDAGraph()
        before = launch_counts()
        step0 = state.step
        try:
            with torch.cuda.graph(graph):
                for i in range(k):
                    state, m = self._step(
                        state, step_batch(i),
                        lambda st, i=i: _adam_update(st.optimizer,
                                                     scalars[i]),
                        DropoutSeeds(seeds[i]))
        finally:
            state.step = step0  # the capture ran no step
            captured = launches_since(before)
            add_launches(captured, -1)  # they run at each replay
        params = [p for g in opt.param_groups for p in g["params"]
                  if p.grad is not None]
        return _StepGraph(graph, inputs, scalars, seeds, params, m, captured,
                          state, state.generation)

    # ---------------------------------------------------------------- eval

    @torch.no_grad()
    def evaluate(self, state: TrainState,
                 dataset: Dataset) -> dict[str, float]:
        """Mean per-example loss and accuracy over the whole test split;
        the tail batch is zero-padded to the batch size and masked. Under a
        gang each rank evaluates its rows of every batch (the test split
        is every rank's) and the sums are the gang's."""
        c = self.config
        bs = min(c.batch_size, len(dataset.x_test))
        gang = self._gang
        sums = torch.zeros(3, dtype=torch.float64, device=self.device)
        for bx, by in batches(dataset.x_test, dataset.y_test, bs,
                              drop_remainder=False):
            n = len(bx)
            if n < bs:
                pad = bs - n
                bx = np.concatenate(
                    [bx, np.zeros((pad, *bx.shape[1:]), bx.dtype)])
                by = np.concatenate(
                    [by, np.zeros((pad, *by.shape[1:]), by.dtype)])
            batch = (bx, by, (np.arange(bs) < n).astype(np.float32))
            if gang:  # the test split is every rank's: its rows' tokens
                batch = self._tokens(shard_batch(batch, self.mesh), 1)
            x, y, wt = to_device(batch, self.device)
            with self._context():
                logits = self._apply(state.model, self._cast(x), None,
                                     False).float()
            per_ex, acc = self._eval_rows(logits, y)
            sums += torch.stack([(per_ex * wt).sum(), (acc * wt).sum(),
                                 wt.sum()]).double()
        if gang:
            sums = self.layout.sum(sums)
        loss, correct, count = sums.tolist()
        return {"loss": loss / max(count, 1.0),
                "accuracy": correct / max(count, 1.0)}

    def _eval_rows(self, logits, labels):
        """Per-example (loss, accuracy) of this rank's rows. Under a
        context axis a row's positions lie on its context ranks: a weighted
        form's sums are added over them, any other per-example value is
        their mean."""
        lay = self.layout
        if lay is None or not lay.gang:
            return self.eval_metrics_fn(logits, labels)
        if self._weighted is not None:
            parts = torch.stack(self._weighted.sums(logits, labels))
            if lay.context > 1:
                parts = lay.sum(parts, "context")
            num, hits, w = parts.unbind(0)
            return num / w.clamp_min(1.0), hits / w.clamp_min(1.0)
        per_ex, acc = self.eval_metrics_fn(logits, labels)
        if lay.context > 1:
            per_ex, acc = lay.mean(torch.stack([per_ex, acc]),
                                   "context").unbind(0)
        return per_ex, acc

    # ---------------------------------------------------------- warm start

    def warm_start(self, sample_x, sample_y, cache_dir: str = "",
                   fused_k: int = 1, state: TrainState | None = None) -> dict:
        """Make the step's programs exist before the first step, from the
        restart-warm cache (the JAX trainer's ``warm_start``).

        On the card: every kernel library missing from the cache dir is
        built into it (one nvcc a source) and every library this process
        has not loaded is loaded from it; with fused_k > 1 and a state, the
        chunk's CUDA graph is captured over ``sample`` stacked fused_k
        times. Returns the attribution fit stamps on its train.compile
        span: the nvcc builds run, the libraries loaded, the seconds and
        the graph captured; ``{"enabled": False}`` when no cache dir
        resolves."""
        cache_dir = compile_cache.cache_dir_from_env(
            cache_dir or self.config.compile_cache_dir)
        if not cache_dir:
            return {"enabled": False}
        t0 = time.perf_counter()
        before = compile_cache.compile_counts()
        loaded: list[str] = []
        info: dict = {"enabled": True, "cache_dir": cache_dir}
        if self.device.type == "cuda":
            from kubeflow_tpu_torch.kernels.build import load_all

            loaded = load_all(cache_dir)
            if fused_k > 1 and state is not None:
                stacked = tuple(np.stack([np.asarray(a)] * fused_k)
                                for a in (sample_x, sample_y))
                stacked = self._local(stacked, stacked=True)
                self._graph(state, stacked, fused_k, scanned=True)
                info["graph"] = f"train_chunk_{fused_k}"
        after = compile_cache.compile_counts()
        info.update(
            builds=after["nvcc_runs_total"] - before["nvcc_runs_total"],
            loaded=",".join(loaded),
            seconds=round(time.perf_counter() - t0, 6))
        return info

    # ----------------------------------------------------------------- fit

    def fit(
        self,
        dataset: Dataset,
        *,
        resume: bool = True,
        on_epoch_end: Callable[[int, dict], None] | None = None,
    ) -> tuple[TrainState, dict]:
        """Train over ``dataset``; returns the state and the last logged,
        eval and final metrics. With a profile dir (config, else
        KFTPU_PROFILE_DIR) the whole fit runs under torch.profiler (CPU
        activity, and CUDA on the card) and its Chrome trace is written
        there."""
        profile_dir = self.config.profile_dir or os.environ.get(
            ENV_PROFILE_DIR, "")
        if not profile_dir:
            return self._fit(dataset, resume, on_epoch_end)
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        prof = profile(activities=activities)
        prof.start()
        try:
            return self._fit(dataset, resume, on_epoch_end)
        finally:
            prof.stop()
            os.makedirs(profile_dir, exist_ok=True)
            prof.export_chrome_trace(os.path.join(
                profile_dir, f"fit-{os.getpid()}-{time.time_ns()}"
                ".pt.trace.json"))
            metrics_lib.emit(profile_trace_written=1)

    def _fit(self, dataset, resume, on_epoch_end):
        c = self.config
        cache_dir = compile_cache.cache_dir_from_env(c.compile_cache_dir)
        state = self.init_state()
        event_dir = c.event_dir or os.environ.get(ENV_EVENT_DIR, "")
        events = metrics_lib.TfEventsWriter(event_dir) if event_dir else None
        # the installed tracer, else one from the pod env contract
        # (KFTPU_TRACE_DIR); untraced runs get the NOOP tracer
        tracer = init_worker_from_env(service="trainer")

        start_step = 0
        if resume and self.checkpointer is not None:
            with tracer.span("checkpoint.restore") as sp:
                restored = self.checkpointer.restore_latest(state)
                sp.set_attribute(
                    "step", restored[0] if restored is not None else -1)
            if restored is not None:
                start_step, state = restored
                metrics_lib.emit(step=start_step, resumed=1)

        # restart-warm: with a cache dir, the kernels and the chunk's graph
        # are made ready now, under their own span, not inside step one
        if cache_dir:
            bs = self._per_process_batch()
            per_epoch = len(dataset.x_train) // bs
            with tracer.span("train.compile") as sp:
                info = self.warm_start(
                    dataset.x_train[:bs], dataset.y_train[:bs], cache_dir,
                    fused_k=min(c.fused_steps, max(per_epoch, 1)),
                    state=state)
                for k, v in info.items():
                    sp.set_attribute(k, v)

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
                                  preempted, on_epoch_end, tracer)
        finally:
            if prev_handler is not None:
                try:
                    signal.signal(signal.SIGTERM, prev_handler)
                except ValueError:
                    pass

    def _fit_loop(self, dataset, c, state, start_step, events, preempted,
                  on_epoch_end, tracer):
        # liveness contract: one heartbeat per optimizer step through the
        # pod env's KFTPU_HEARTBEAT_FILE (None for standalone runs)
        hb = HeartbeatWriter.from_env()
        if hb is not None:
            hb.beat(step=start_step, phase="fit-start")

        def save_ckpt(step, st, metrics=None):
            with tracer.span("checkpoint.save", step=step):
                self.checkpointer.save(step, st, metrics=metrics)

        # a process's batches: the global batch, or its own rows of it
        bs = self._per_process_batch()
        per_epoch = len(dataset.x_train) // bs
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

        def after(took: int, m) -> bool:
            """Bookkeeping after a dispatch of ``took`` steps; True when fit
            must stop. Log and checkpoint fire when their cadence boundary
            falls inside the dispatch."""
            nonlocal global_step, last, stop
            global_step += took
            if hb is not None:
                hb.beat(step=global_step)
            timer.tick(items=took * c.batch_size, steps=took)
            if (global_step % c.log_every_steps < took
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
                save_ckpt(global_step, state)
                metrics_lib.emit(step=global_step, preempted=1)
                stop = True
                return True
            if (self.checkpointer is not None and not c.keep_best_metric
                    and global_step % c.checkpoint_every_steps < took):
                save_ckpt(global_step, state)
            return False

        def one_step(b) -> bool:
            nonlocal state
            with tracer.span("train.step", step=global_step):
                state, m = self.train_step(state, b)
            return after(1, m)

        while global_step < total_steps:
            # a chunk never exceeds an epoch; full chunks of exactly k steps
            # are one dispatch each, the epoch tail and the total_steps
            # boundary run step by step, so the numbers never depend on the
            # chunking
            k = min(c.fused_steps, per_epoch)
            if k > 1:
                pending: list = []
                batch_src = batches(dataset.x_train, dataset.y_train,
                                    bs, seed=c.seed + epoch)
                if tracer.enabled:
                    batch_src = _traced_data_iter(tracer, batch_src)
                for b in batch_src:
                    if global_step >= total_steps or stop:
                        break
                    if total_steps - global_step >= k:
                        pending.append(b)
                        if len(pending) == k:
                            stacked = tuple(np.stack(z)
                                            for z in zip(*pending))
                            pending = []
                            with tracer.span("train.chunk",
                                             step=global_step, steps=k):
                                state, m = self.train_chunk(state, stacked,
                                                            k)
                            if after(k, m):
                                break
                    elif one_step(b):
                        break
                for b in pending:  # an epoch tail smaller than a chunk
                    if global_step >= total_steps or stop or one_step(b):
                        break
            else:
                raw = batches(dataset.x_train, dataset.y_train, bs,
                              seed=c.seed + epoch)
                loader = None
                if c.async_loader:
                    loader = AsyncLoader(raw, transform=self._upload, size=2)
                    batch_src = loader
                else:
                    batch_src = prefetch_to_device(raw, self._upload)
                if tracer.enabled:
                    batch_src = _traced_data_iter(tracer, batch_src,
                                                  stats_from=loader)
                try:
                    for b in batch_src:
                        if global_step >= total_steps or stop:
                            break
                        if one_step(b):
                            break
                finally:
                    # every exit path joins the loader thread
                    if loader is not None:
                        loader.close()
            if stop:
                return state, {**last, "preempted": 1.0}
            epoch += 1
            if epoch % c.eval_every_epochs == 0:
                with tracer.span("train.eval", step=global_step):
                    ev = self.evaluate(state, dataset)
                if hb is not None:
                    hb.beat(step=global_step, phase="eval")
                if self.checkpointer is not None and c.keep_best_metric:
                    # best-mode cadence: metrics only exist at evals
                    save_ckpt(global_step, state, metrics=ev)
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

        with tracer.span("train.eval", step=global_step, final=True):
            final_eval = self.evaluate(state, dataset)
        if self.checkpointer is not None:
            save_ckpt(global_step, state, metrics=dict(final_eval))
        metrics_lib.emit(step=global_step, **{f"final_{k}": v
                                              for k, v in final_eval.items()})
        if events is not None:
            events.scalars(global_step, **{f"final_{k}": v
                                           for k, v in final_eval.items()})
            events.close()
        return state, {**last, **{f"final_{k}": v
                                  for k, v in final_eval.items()}}


@dataclass
class _StepGraph:
    """One captured CUDA graph of k optimizer steps, and what it reads and
    writes besides the parameters and the optimizer's state: the static
    input buffers, the k steps' update scalars and dropout seeds, the last
    step's metrics, and each kernel's launches in one replay. ``state`` and
    ``generation`` name the tensors it was captured over."""

    graph: Any
    inputs: tuple
    scalars: torch.Tensor  # _update_scalars' (k, 3), on the device
    seeds: torch.Tensor    # _graph_seeds' (k, DROPOUT_SEEDS_PER_STEP)
    params: list        # the parameters its optimizer updates update
    metrics: dict
    launches: dict
    state: TrainState
    generation: int

    def upload(self, batch) -> None:
        """The batch into the static buffers (a host array through pinned
        memory)."""
        for buf, a in zip(self.inputs, batch):
            if a is buf:
                continue
            t = torch.as_tensor(a)
            if t.device.type == "cpu":
                t = t.pin_memory()
            buf.copy_(t, non_blocking=True)


def _check_adam(opt) -> None:
    """_adam_update writes out torch's multi-tensor Adam/AdamW as the
    Trainer builds it; anything else is refused."""
    if len(opt.param_groups) != 1:
        raise ValueError("a CUDA graph of the training step takes one "
                         "parameter group")
    for group in opt.param_groups:
        if (not isinstance(opt, torch.optim.Adam | torch.optim.AdamW)
                or group.get("fused") or group.get("capturable")
                or group.get("foreach") is False or group["amsgrad"]
                or group["maximize"] or group["differentiable"]):
            raise ValueError(
                f"a CUDA graph of the training step replays torch's "
                f"multi-tensor Adam/AdamW update; {type(opt).__name__} "
                f"with {dict((k, v) for k, v in group.items() if k != 'params')}"
                " is not it")


@torch.no_grad()
def _adam_update(opt, scalars: torch.Tensor) -> None:
    """torch's multi-tensor Adam/AdamW update (``torch.optim.adam.
    _multi_tensor_adam``), op for op, with the scalars it computes on the
    host for the step read from a tensor a graph can capture: ``scalars``
    is a row of ``Trainer._update_scalars``. Its last op,
    ``addcdiv_(p, m, denom, value=-step size)``, computes p + size * (m /
    denom) with one rounding (a fused multiply-add) on the card; with the
    step size in a tensor that is ``p.addcmul_(m / denom, size)``, the
    same fused multiply-add. The step counts are not advanced here: the
    replay adds k on the host."""
    for group in opt.param_groups:
        params = [p for p in group["params"] if p.grad is not None]
        if not params:
            continue
        grads = [p.grad for p in params]
        states = [opt.state[p] for p in params]
        m = [st["exp_avg"] for st in states]
        v = [st["exp_avg_sq"] for st in states]
        beta1, beta2 = group["betas"]
        wd = group["weight_decay"]
        if wd and group.get("decoupled_weight_decay",
                            isinstance(opt, torch.optim.AdamW)):
            torch._foreach_mul_(params, scalars[2])
        elif wd:
            grads = torch._foreach_add(grads, params, alpha=wd)
        torch._foreach_lerp_(m, grads, 1 - beta1)
        torch._foreach_mul_(v, beta2)
        torch._foreach_addcmul_(v, grads, grads, 1 - beta2)
        # the step's two temporaries (denom, m / denom) a slice of the
        # parameters at a time: at billions of parameters a graph's pool
        # cannot hold them for all at once
        for lo, hi in _slices(params, ADAM_SLICE_ELEMENTS):
            denom = torch._foreach_sqrt(v[lo:hi])
            torch._foreach_div_(denom, scalars[1])
            torch._foreach_add_(denom, group["eps"])
            for p, q in zip(params[lo:hi],
                            torch._foreach_div(m[lo:hi], denom)):
                p.addcmul_(q, scalars[0])
            del denom


def _slices(tensors, limit: int):
    """[lo, hi) ranges of ``tensors``, each of at most ``limit`` elements
    (or one tensor)."""
    lo = size = 0
    for i, t in enumerate(tensors):
        if size and size + t.numel() > limit:
            yield lo, i
            lo, size = i, 0
        size += t.numel()
    if lo < len(tensors):
        yield lo, len(tensors)


def _snapshot(state: TrainState) -> dict:
    """Copies of everything a step changes: the parameters, the buffers
    (BatchNorm's averages), the optimizer's state tensors and the step.
    The copies stay on the card when they and a step's gradients and Adam
    moments (three times the parameters) fit in half its free memory;
    else they are held in host memory: at billions of parameters the card
    holds the state and a warm-up step's temporaries, not a second copy."""
    tensors = [*state.model.parameters(), *state.model.buffers()]
    moments = {p: {k: v for k, v in st.items() if torch.is_tensor(v)}
               for p, st in state.optimizer.state.items()}
    to = None
    if tensors and tensors[0].is_cuda:
        nbytes = sum(t.numel() * t.element_size() for t in tensors) + sum(
            v.numel() * v.element_size()
            for st in moments.values() for v in st.values())
        nbytes += 3 * sum(p.numel() * p.element_size()
                          for p in state.model.parameters())
        if 2 * nbytes > torch.cuda.mem_get_info(tensors[0].device)[0]:
            to = "cpu"

    def copy(t):
        return t.detach().clone() if to is None else t.detach().to(
            to, copy=True)

    with torch.no_grad():
        return {
            "step": state.step,
            "tensors": [(t, copy(t)) for t in tensors],
            "opt": {p: {k: copy(v) for k, v in st.items()}
                    for p, st in moments.items()},
        }


def _restore(state: TrainState, snap: dict) -> None:
    """Undo the steps taken since ``_snapshot``, in place (a graph captures
    addresses). Optimizer state made by those steps is zeroed: what a fresh
    Adam holds before its first step."""
    with torch.no_grad():
        for t, saved in snap["tensors"]:
            t.copy_(saved)
        for p, st in state.optimizer.state.items():
            saved = snap["opt"].get(p)
            for k, v in st.items():
                if torch.is_tensor(v):
                    if saved is None:
                        v.zero_()
                    else:
                        v.copy_(saved[k])
    state.step = snap["step"]
