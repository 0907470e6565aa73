"""Sharding rules and the gang's training layout — counterpart of
``kubeflow_tpu/parallel/sharding.py``.

DP:   the batch split over the data-like axes (data, fsdp, expert);
      gradients all-reduced.
FSDP: parameters, gradients and Adam state sharded over ``fsdp`` on the dim
      the partitioner names (FSDP2 ``fully_shard`` per block, placed by
      ``shard_placement_fn``); a parameter the spec leaves replicated is
      not sharded and its gradient is all-reduced like DP's.
EP:   the stacked expert weights sharded over ``expert`` on dim 0
      (``MoeMlp.shard_experts``); their gradients are reduced over the
      ranks that hold the same experts.
CP:   every row's sequence split over ``context`` (ring and Ulysses
      attention exchange keys across it); the ranks of one data index get
      the same rows, each its chunk of positions, and every parameter's
      gradient is summed over them too.

The specs are the JAX package's (``parallel/partitioner.py``), derived on
the flax path and shape of each parameter (``convert.flax_layout``) and
carried over to the port's layout. The gang trains the JAX package's
objective, the loss over the global batch. A weighted token loss
(``train/losses.py``) backpropagates, on each member, its own sum scaled
by the data-like extent over the gang's whole count; any other loss, its
own value over the context extent (every data-like member's rows weigh
the same). The gradient reductions below sum over the data-like and
context ranks and divide by the data-like extent. The batch helpers take
tensors: every process holding the whole global batch (``put_global``,
the seed-deterministic pipeline) or only its own rows
(``put_process_local``, ``train/data.load_dataset_shards``), then each
member's chunk of the sequence (``put_sequence``).
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Sequence

import torch

from kubeflow_tpu_torch.parallel.mesh import (
    AXIS_CONTEXT,
    AXIS_DATA,
    AXIS_EXPERT,
    AXIS_FSDP,
    AXIS_MODEL,
    AXIS_PIPELINE,
    DATA_LIKE_AXES,
    ContextAxis,
    Mesh,
)
from kubeflow_tpu_torch.parallel.partitioner import (
    P,
    Partitioner,
    heuristic_pspec,
    resolve_pspec,
)

Rules = Sequence[tuple[str, P]]

# every data-like mesh axis the batch dim is split over
BATCH_AXES = DATA_LIKE_AXES

#: the axes a batch's tokens are split over: its rows, then its positions
TOKEN_AXES = (*DATA_LIKE_AXES, AXIS_CONTEXT)

#: the axes the port does not execute yet (ROADMAP Queue A item 8)
UNEXECUTED_AXES = (AXIS_MODEL, AXIS_PIPELINE)


def batch_pspec() -> P:
    """Leading (batch) dim split over the data-like axes; rest replicated."""
    return P(BATCH_AXES)


def stacked_batch_pspec() -> P:
    """A (k, B, ...) stacked chunk: the step dim replicated, the batch dim
    split over the data-like axes."""
    return P(None, BATCH_AXES)


def fsdp_param_pspec(shape: tuple[int, ...], fsdp_size: int,
                     min_size: int = 2**12) -> P:
    """Shard the largest dim divisible by fsdp_size; tiny params
    replicate."""
    return heuristic_pspec(shape, fsdp_size, min_size)


def param_shardings(shapes: dict, mesh: Mesh, min_size: int = 2**12) -> dict:
    """{path: spec} for {path: shape} under the mesh's fsdp axis."""
    return {k: fsdp_param_pspec(tuple(s), mesh.shape[AXIS_FSDP], min_size)
            for k, s in shapes.items()}


def state_pspec(path_str: str, shape: tuple[int, ...], mesh: Mesh,
                rules: Rules | None) -> P:
    """Spec for one state leaf: rules first (all-or-nothing fit), the FSDP
    heuristic second."""
    return resolve_pspec(path_str, shape, mesh, rules)


def state_shardings(shapes: dict, mesh: Mesh, rules: Rules | None = None
                    ) -> dict:
    """{path: spec} matching a flat {path: shape} state."""
    return {k: state_pspec(k, tuple(s), mesh, rules)
            for k, s in shapes.items()}


def data_index(mesh: Mesh, rank: int | None = None) -> tuple[int, int]:
    """(this rank's position in the batch split, the split's size)."""
    rank = _rank() if rank is None else rank
    group = mesh.axis_ranks(BATCH_AXES, rank)
    return group.index(rank), len(group)


def put_global(x, mesh: Mesh, rank: int | None = None, dim: int = 0):
    """This rank's rows of a batch every process holds whole: the
    ``dim``-th dim split over the data-like axes."""
    i, n = data_index(mesh, rank)
    t = torch.as_tensor(x)
    if t.shape[dim] % n:
        raise ValueError(
            f"batch {t.shape[dim]} not divisible by the data-like mesh "
            f"extent {n}")
    return t.chunk(n, dim=dim)[i] if n > 1 else t


def put_process_local(x, mesh: Mesh, rank: int | None = None, dim: int = 0):
    """A process's own rows (disjoint per-process loading): already its
    shard of the global batch, so it is placed as it is."""
    return torch.as_tensor(x)


def context_index(mesh: Mesh, rank: int | None = None) -> tuple[int, int]:
    """(this rank's position on the context axis, the axis' size)."""
    rank = _rank() if rank is None else rank
    group = mesh.axis_ranks((AXIS_CONTEXT,), rank)
    return group.index(rank), len(group)


def put_sequence(x, mesh: Mesh, rank: int | None = None, dim: int = 1):
    """This rank's chunk of the ``dim``-th (sequence) dim of rows every
    context rank of its data index holds: positions [i·L/ctx, (i+1)·L/ctx)
    for context index i."""
    i, n = context_index(mesh, rank)
    t = torch.as_tensor(x)
    if t.shape[dim] % n:
        raise ValueError(
            f"sequence {t.shape[dim]} not divisible by the context axis "
            f"size {n}")
    return t.chunk(n, dim=dim)[i] if n > 1 else t


class LocalBatch(tuple):
    """A batch that is this rank's rows already (``shard_batch``'s
    result): the Trainer places it as it is, as the JAX package passes an
    array through that carries its sharding."""


def shard_batch(batch, mesh: Mesh, process_local: bool = False,
                stacked: bool = False) -> LocalBatch:
    """A host batch's local part: each array's batch dim (dim 1 of a
    stacked (k, B, ...) chunk) split over the data-like axes, or taken as
    this process's rows with ``process_local``."""
    if isinstance(batch, LocalBatch):
        return batch
    place = put_process_local if process_local else put_global
    return LocalBatch(place(x, mesh, dim=1 if stacked else 0)
                      for x in batch)


def _rank() -> int:
    import torch.distributed as dist

    return dist.get_rank() if dist.is_initialized() else 0


_GROUPS: dict = {}


def context_axis_of(mesh: Mesh) -> ContextAxis | None:
    """This rank's ``ContextAxis`` in ``mesh`` (None when the context axis
    has one rank). Collective like ``axis_group``."""
    if mesh.shape[AXIS_CONTEXT] == 1:
        return None
    rank = _rank()
    return ContextAxis(mesh.axis_index((AXIS_CONTEXT,), rank),
                       mesh.shape[AXIS_CONTEXT],
                       axis_group(mesh, (AXIS_CONTEXT,)),
                       tuple(mesh.axis_ranks((AXIS_CONTEXT,), rank)))


def axis_group(mesh: Mesh, axes):
    """The process group over ``axes`` that holds this rank (None when
    it has one member). Collective: every rank of the mesh calls it with
    the same axes, and each of the mesh's groups over them is made once."""
    import torch.distributed as dist

    axes = tuple(a for a in mesh.axis_names if a in axes)
    rank = _rank()
    mine = mesh.axis_ranks(axes, rank)
    if len(mine) == 1:
        return None
    key = (id(mesh), axes)
    if key not in _GROUPS:
        seen, groups = set(), {}
        for r in mesh.devices.reshape(-1).tolist():
            ranks = tuple(mesh.axis_ranks(axes, r))
            if ranks not in seen:
                seen.add(ranks)
                groups[ranks] = dist.new_group(list(ranks))
        _GROUPS[key] = (mesh, groups)
    return _GROUPS[key][1][tuple(mine)]


# --------------------------------------------------------- training layout


@dataclass
class ParamLayout:
    """One parameter's placement: its spec (on its flax path), the port
    dim the fsdp axis splits (None: not FSDP-sharded), whether the expert
    axis splits its dim 0, and the axes its gradient is all-reduced
    over."""

    spec: P
    fsdp_dim: int | None
    expert: bool
    reduce_axes: tuple


class GangLayout:
    """A model's parameters laid out over a mesh of gang ranks, and the
    collectives a training step needs: ``sync_grads`` after the backward,
    ``grad_norm``, ``mean`` of a metric, and the full-tensor
    ``state_dict``/``load_state_dict`` of a checkpoint (any layout saves
    full tensors and restores onto any other).

    Construction shards the model in place: the MoE blocks' experts over
    ``expert``, then FSDP2 over ``fsdp``. Every rank builds it at once."""

    def __init__(self, model: torch.nn.Module, mesh: Mesh,
                 partitioner: Partitioner):
        from kubeflow_tpu_torch.convert import flax_layout
        from kubeflow_tpu_torch.parallel.moe import MoeMlp

        refuse_unexecuted(mesh.shape)
        self.mesh = mesh
        self.rank = _rank()
        self.size = data_index(mesh, self.rank)[1]
        fs, ep = mesh.shape[AXIS_FSDP], mesh.shape[AXIS_EXPERT]
        self.fsdp_size, self.ep = fs, ep
        self.context = mesh.shape[AXIS_CONTEXT]
        if self.context > 1 and any(isinstance(m, MoeMlp)
                                    for m in model.modules()):
            raise NotImplementedError(
                "MoE layers under a context axis: expert dispatch over a "
                "sequence split across ranks is ROADMAP Queue A item 8")
        if mesh.size > 1:
            mesh.device_mesh  # noqa: B018 (every rank makes its groups)
        self.data_group = axis_group(mesh, BATCH_AXES)
        self.context_group = axis_group(mesh, (AXIS_CONTEXT,))
        self.token_group = (self.data_group if self.context == 1
                            else axis_group(mesh, TOKEN_AXES))
        #: what ring and Ulysses attention exchange over (the Trainer
        #: enters it around its steps); None on a context axis of one
        self.context_axis = context_axis_of(mesh)
        table = flax_layout(model)
        self.params: dict[str, ParamLayout] = {}
        for name, p in model.named_parameters():
            path, fshape, dims = table[name]
            spec = partitioner.spec_for(path, fshape)
            axis_dim = {}
            for fdim, entry in enumerate(spec):
                for a in (entry if isinstance(entry, tuple) else (entry,)):
                    if a is not None:
                        axis_dim[a] = dims[fdim]
            expert = ep > 1 and AXIS_EXPERT in axis_dim
            if expert and axis_dim[AXIS_EXPERT] != 0:
                raise ValueError(f"{name}: the expert axis splits port dim "
                                 f"{axis_dim[AXIS_EXPERT]}, not 0")
            fsdp_dim = axis_dim.get(AXIS_FSDP) if fs > 1 else None
            covered = {AXIS_FSDP} if fsdp_dim is not None else set()
            if expert:
                covered.add(AXIS_EXPERT)
            reduce_axes = tuple(a for a in TOKEN_AXES if a not in covered
                                and mesh.shape[a] > 1)
            self.params[name] = ParamLayout(spec, fsdp_dim, expert,
                                            reduce_axes)
        if ep > 1:
            e_group = axis_group(mesh, (AXIS_EXPERT,))
            e_index = mesh.axis_index((AXIS_EXPERT,), self.rank)
            for m in model.modules():
                if isinstance(m, MoeMlp):
                    m.shard_experts(e_group, ep, e_index, self.size)
            self.expert_group = e_group
        else:
            self.expert_group = None
            for m in model.modules():
                if isinstance(m, MoeMlp):
                    m.data_like = self.size
        if fs > 1:
            self._fully_shard(model)
        self._groups = {axes: axis_group(mesh, axes) for axes in
                        {pl.reduce_axes for pl in self.params.values()}}

    # ------------------------------------------------------------ FSDP2

    def _fully_shard(self, model: torch.nn.Module) -> None:
        """FSDP2 over the fsdp axis: each transformer block one unit, the
        rest the root's; a parameter's shard dim is the partitioner's, and
        the parameters it replicates are left to ``sync_grads``."""
        from torch.distributed.fsdp import fully_shard
        from torch.distributed.tensor import Shard

        sub = self.mesh.device_mesh[AXIS_FSDP]
        by_id = {id(p): self.params[n] for n, p in model.named_parameters()}
        ignored = {p for p in model.parameters()
                   if by_id[id(p)].fsdp_dim is None}

        def place(p):
            return Shard(by_id[id(p)].fsdp_dim)

        units = [m for n, m in model.named_modules()
                 if re.search(r"(^|\.)(layers\.\d+|layer_\d+)$", n)]
        for unit in units:
            fully_shard(unit, mesh=sub, shard_placement_fn=place,
                        ignored_params=ignored)
        fully_shard(model, mesh=sub, shard_placement_fn=place,
                    ignored_params=ignored)

    @property
    def sharded(self) -> bool:
        return self.fsdp_size > 1

    @property
    def gang(self) -> bool:
        """Whether a step has ranks to reduce over: more than one on the
        data-like axes or on the context axis."""
        return self.size > 1 or self.context > 1

    # ------------------------------------------------------ the step

    @torch.no_grad()
    def sync_grads(self, model: torch.nn.Module) -> None:
        """Make every gradient the gang objective's: all-reduce the local
        gradients over their groups (one flat buffer a group; the context
        ranks' contributions are summed) and divide by the data-like
        extent (FSDP2 has averaged its own axis)."""
        if not self.gang:
            return
        from torch._utils import (
            _flatten_dense_tensors,
            _unflatten_dense_tensors,
        )
        import torch.distributed as dist

        buckets: dict[tuple, list] = {}
        for n, p in model.named_parameters():
            if p.grad is None:
                continue
            pl = self.params[n]
            g = local_tensor(p.grad)
            buckets.setdefault(pl.reduce_axes, []).append((g, pl))
        for axes, items in buckets.items():
            grads = [g for g, _ in items]
            group = self._groups.get(axes)
            if group is not None:
                flat = _flatten_dense_tensors(grads)
                dist.all_reduce(flat, group=group)
                for g, r in zip(grads, _unflatten_dense_tensors(flat, grads)):
                    g.copy_(r)
            for g, pl in items:
                scale = (self.fsdp_size if pl.fsdp_dim is not None else 1)
                if scale != self.size:
                    g.mul_(scale / self.size)

    def grad_norm(self, model: torch.nn.Module) -> torch.Tensor:
        """The global norm of the gang's gradients: each local shard's
        squares counted once across the ranks that hold it (the context
        ranks hold the same gradients after ``sync_grads``, so the sum runs
        over the data-like ranks only)."""
        import torch.distributed as dist

        total = None
        for n, p in model.named_parameters():
            if p.grad is None:
                continue
            pl = self.params[n]
            holders = (self.fsdp_size if pl.fsdp_dim is not None else 1) \
                * (self.ep if pl.expert else 1)
            sq = local_tensor(p.grad).float().square().sum() * (
                holders / self.size)
            total = sq if total is None else total + sq
        if self.data_group is not None:
            dist.all_reduce(total, group=self.data_group)
        return total.sqrt()

    def _group(self, over: str):
        return {"data": (self.data_group, self.size),
                "context": (self.context_group, self.context),
                "tokens": (self.token_group, self.size * self.context)}[over]

    def mean(self, value: torch.Tensor, over: str = "data") -> torch.Tensor:
        """A per-rank metric's mean over the data-like ranks (``over=
        "context"``: the context ranks; ``"tokens"``: both)."""
        group, n = self._group(over)
        return value if group is None else self.sum(value, over) / n

    def sum(self, value: torch.Tensor, over: str = "data") -> torch.Tensor:
        """A per-rank count's sum over the data-like ranks (``over`` as in
        ``mean``)."""
        group, _ = self._group(over)
        if group is None:
            return value
        import torch.distributed as dist

        value = value.clone()
        dist.all_reduce(value, group=group)
        return value

    # ------------------------------------------------------ checkpoints

    def full(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """The full tensor of parameter ``name``'s local ``t`` (the
        parameter or a moment of it): FSDP2's gather, then the experts'."""
        import torch.distributed as dist

        pl = self.params[name]
        if hasattr(t, "full_tensor"):
            t = t.full_tensor()
        t = t.detach()
        if pl.expert:
            parts = [torch.empty_like(t) for _ in range(self.ep)]
            dist.all_gather(parts, t.contiguous(), group=self.expert_group)
            t = torch.cat(parts, dim=0)
        return t

    def local(self, name: str, full: torch.Tensor, like: torch.Tensor
              ) -> torch.Tensor:
        """This rank's part of parameter ``name``'s full tensor, shaped and
        typed as ``like`` (a DTensor for an FSDP2 parameter)."""
        pl = self.params[name]
        t = full.to(device=local_tensor(like).device, dtype=like.dtype)
        if pl.expert:
            e_index = self.mesh.axis_index((AXIS_EXPERT,), self.rank)
            t = t.chunk(self.ep, dim=0)[e_index]
        if pl.fsdp_dim is not None:
            f_index = self.mesh.axis_index((AXIS_FSDP,), self.rank)
            t = t.chunk(self.fsdp_size, dim=pl.fsdp_dim)[f_index]
        t = t.contiguous()
        if hasattr(like, "to_local"):
            from torch.distributed.tensor import DTensor

            t = DTensor.from_local(t, like.device_mesh, like.placements,
                                   run_check=False)
        return t

    def state_dict(self, model: torch.nn.Module, optimizer) -> dict:
        """The model's and the optimizer's state as full tensors, in the
        one-process layout (what ``TrainState.state_dict`` holds there)."""
        params = dict(model.named_parameters())
        msd = {}
        for k, v in model.state_dict().items():
            msd[k] = self.full(k, v) if k in params else local_tensor(v).detach()
        osd = optimizer.state_dict()
        order = _opt_names(optimizer, model)
        state = {}
        for i, st in osd["state"].items():
            name = order[i]
            state[i] = {k: (self.full(name, v) if torch.is_tensor(v)
                            and v.ndim else v) for k, v in st.items()}
        return {"model": msd, "optimizer": {"state": state,
                                            "param_groups":
                                            osd["param_groups"]}}

    @torch.no_grad()
    def load_state_dict(self, model: torch.nn.Module, optimizer,
                        sd: dict) -> None:
        """Restore full tensors (any layout's checkpoint) onto this one."""
        params = dict(model.named_parameters())
        own = model.state_dict()
        for k, v in sd["model"].items():
            if k not in own:
                raise KeyError(f"unexpected key {k!r} in the checkpoint")
            dst = local_tensor(params[k]) if k in params else own[k]
            src = self.local(k, v, params[k]) if k in params else v
            dst.copy_(local_tensor(src))
        order = _opt_names(optimizer, model)
        state = {}
        for i, st in sd["optimizer"]["state"].items():
            name = order[int(i)]
            state[int(i)] = {
                k: (self.local(name, v, params[name]) if torch.is_tensor(v)
                    and v.ndim else v) for k, v in st.items()}
        optimizer.load_state_dict({"state": state, "param_groups":
                                   sd["optimizer"]["param_groups"]})


def local_tensor(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's local shard; any other tensor itself."""
    return t.to_local() if hasattr(t, "to_local") else t


def _opt_names(optimizer, model) -> dict[int, str]:
    """The optimizer state dict's parameter indices -> parameter names."""
    by_id = {id(p): n for n, p in model.named_parameters()}
    out, i = {}, 0
    for group in optimizer.param_groups:
        for p in group["params"]:
            out[i] = by_id[id(p)]
            i += 1
    return out


def refuse_unexecuted(sizes: dict) -> None:
    """Raise for an axis of ``sizes`` (a mesh's shape, or a MeshConfig's
    sizes) that is not 1 and that the port does not execute."""
    for a in UNEXECUTED_AXES:
        if sizes[a] != 1:
            raise NotImplementedError(
                f"mesh axis {a!r} of size {sizes[a]}: only the data, "
                "fsdp, expert and context axes are executed; tensor and "
                "pipeline parallelism are ROADMAP Queue A item 8")


__all__ = [
    "AXIS_DATA", "BATCH_AXES", "GangLayout", "LocalBatch", "TOKEN_AXES",
    "axis_group", "batch_pspec", "context_axis_of", "context_index",
    "data_index", "fsdp_param_pspec", "param_shardings", "put_global",
    "put_process_local", "put_sequence", "refuse_unexecuted", "shard_batch",
    "stacked_batch_pspec", "state_pspec", "state_shardings",
]
