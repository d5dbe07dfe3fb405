"""The (data, model) process mesh and its sharding rules (counterpart of
``svit_tpu/parallel/mesh.py``).

The JAX package lays its chips out as a ``(data, model)`` mesh; here the
mesh is over processes, one per card: rank ``d * model + m`` holds data
index ``d`` and model index ``m``.  ``TPU.MESH_DATA x TPU.MESH_MODEL`` is
the world, ``MESH_DATA = -1`` meaning all ranks over the model axis.

- The batch is sharded on ``data``: each rank reads its ``1 / data``
  share of every global batch (``data_sharding``), and the gradients are
  summed over the data group inside the train step.  The step's losses
  and random draws take the rank's ``DataShare``: the losses divide by the
  global batch's denominators, and each draw is the global batch's, cut
  to the rank's rows, so the step is one process's on the whole batch.
- ``model`` > 1 shards the MLP alone, Megatron style (``_param_spec``):
  ``fc1`` by columns of its output (weight rows and bias), ``fc2`` by
  rows of its input (weight columns, not its bias); everything else is
  replicated.  A tensor whose dim does not divide replicates, and so does
  its MLP.  ``parallel/tensor.py`` runs the sharded MLP.
- Checkpoints hold full tensors (``full_state_dict``,
  ``full_optimizer_state``), gathered over the model group, so one loads
  at any mesh; loading shards them (``shard_state_dict``,
  ``shard_optimizer_state``).

With no process group there is one rank and no group, whatever
``TPU.MESH_*`` say: nothing here launches a collective.  A group of one rank (one card under NCCL) keeps
its data group, so the step's collectives run.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch
import torch.distributed as dist


@dataclasses.dataclass
class Mesh:
    data: int
    model: int
    rank: int = 0
    data_group: Optional[object] = None    # ranks of this model index
    model_group: Optional[object] = None   # ranks of this data index

    @property
    def data_index(self) -> int:
        return self.rank // self.model

    @property
    def model_index(self) -> int:
        return self.rank % self.model

    def data_share(self) -> "DataShare":
        """This rank's share of the global batch."""
        return DataShare(self.data_group, self.data_index, self.data)


@dataclasses.dataclass(frozen=True)
class DataShare:
    """This rank's share of the global batch: share ``index`` of ``count``
    equal runs of rows, summed over ``group`` (None with one process:
    nothing to sum).  The losses and the random draws of a train step take
    it, so that each rank computes its term of the global batch's step."""

    group: Optional[object] = None
    index: int = 0
    count: int = 1

    def total(self, t: torch.Tensor) -> torch.Tensor:
        """A denominator (no gradient) summed over the data group."""
        if self.group is None:
            return t
        t = t.detach().clone()
        dist.all_reduce(t, group=self.group)
        return t

    def mean(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's term of the mean of ``t``'s elements over the global
        batch (every share is the same size)."""
        return t.mean() if self.count == 1 else t.mean() / self.count

    def draws(self, generator):
        """``generator`` as the step draws from it: each draw made for the
        global batch and cut to this rank's rows (``GlobalDraws``), so that
        the masks do not depend on the mesh; the generator itself for one
        share."""
        if self.count == 1:
            return generator
        return GlobalDraws(generator, self.index, self.count)


ONE = DataShare()


@dataclasses.dataclass(frozen=True)
class GlobalDraws:
    """A generator whose draws (``rand``, ``randn``) are those of the
    global batch, ``count`` times this rank's rows on dim 0, cut to share
    ``index``: every rank draws what one process would on the
    concatenated batch (JAX draws its masks for the global array), and
    keeps its rows.  Under tensor parallelism the ranks of a model group
    draw the same."""

    generator: torch.Generator
    index: int
    count: int

    def draw(self, fn, shape, device) -> torch.Tensor:
        shape = (shape,) if isinstance(shape, int) else tuple(shape)
        n = shape[0]
        whole = fn((n * self.count, *shape[1:]), generator=self.generator,
                   device=device)
        return whole[self.index * n:(self.index + 1) * n]


def rand(shape, generator, device) -> torch.Tensor:
    """``torch.rand`` from ``generator`` (a ``torch.Generator`` or
    ``GlobalDraws``)."""
    if isinstance(generator, GlobalDraws):
        return generator.draw(torch.rand, shape, device)
    return torch.rand(shape, generator=generator, device=device)


def randn(shape, generator, device) -> torch.Tensor:
    """``torch.randn`` from ``generator`` (a ``torch.Generator`` or
    ``GlobalDraws``)."""
    if isinstance(generator, GlobalDraws):
        return generator.draw(torch.randn, shape, device)
    return torch.randn(shape, generator=generator, device=device)


def build_mesh(cfg=None, data: int = -1, model: int = 1) -> Mesh:
    """The mesh of ``cfg`` (``TPU.MESH_DATA``, ``TPU.MESH_MODEL``) over the
    process group's ranks; every rank must call it, in the same order of
    calls, as the groups are made collectively."""
    if cfg is not None:
        data, model = int(cfg.TPU.MESH_DATA), int(cfg.TPU.MESH_MODEL)
    if not dist.is_initialized():
        # one process: one rank, whatever the config asks for (the mesh of
        # a one-card run is 1 x 1)
        return Mesh(1, 1)
    n = dist.get_world_size()
    if data <= 0:
        data = n // model
    assert data * model <= n, (
        f"mesh {data}x{model} > {n} devices; set TPU.MESH_DATA/TPU.MESH_MODEL"
    )
    if data < 1 or data * model != n:
        raise ValueError(f"mesh {data}x{model} does not cover the {n} ranks")
    rank = dist.get_rank()
    data_groups = [_group([d * model + m for d in range(data)], n)
                   for m in range(model)]
    model_groups = [_group([d * model + m for m in range(model)], n)
                    for d in range(data)]
    return Mesh(data, model, rank, data_groups[rank % model],
                model_groups[rank // model] if model > 1 else None)


def _group(ranks, world):
    """A group over ``ranks``: the whole world's when it is all of it,
    none for one rank of a larger world (no collective to run)."""
    if len(ranks) == world:
        return dist.group.WORLD
    group = dist.new_group(ranks)   # every rank makes every group
    return None if len(ranks) == 1 else group


def data_sharding(mesh: Mesh):
    """This rank's share of the global batch, ``(index, count)``: rows
    ``index * b / count`` to ``(index + 1) * b / count`` of a batch padded
    to a multiple of ``count`` (``data/loader.py``)."""
    return mesh.data_index, mesh.data


def _param_spec(name: str) -> Optional[int]:
    """The dim of parameter ``name`` (PyTorch names) sharded on the model
    axis, or None (replicated): ``fc1`` weight and bias on their output
    dim, ``fc2`` weight on its input dim, its bias replicated (JAX
    ``_param_spec``: kernel ``P(None, "model")`` / ``P("model", None)`` in
    flax's [in, out] layout)."""
    keys = name.split(".")
    leaf = keys[-1]
    parent = keys[-2] if len(keys) >= 2 else ""
    if parent == "fc1":
        return 0
    if parent == "fc2":
        return 1 if leaf == "weight" else None
    return None


def param_sharding(mesh: Mesh, shapes: Dict[str, tuple]) -> Dict[str,
                                                                 Optional[int]]:
    """{name: sharded dim or None} for parameters of ``shapes``, with the
    guard: a dim that the model axis does not divide replicates."""
    out = {}
    for name, shape in shapes.items():
        dim = _param_spec(name)
        if dim is not None and (mesh.model == 1
                                or shape[dim] % mesh.model != 0):
            dim = None
        out[name] = dim
    return out


def _mlp_prefix(name: str) -> str:
    return name.rsplit(".", 2)[0]


def sharded_mlps(mesh: Mesh, model: torch.nn.Module) -> Dict[str, int]:
    """{MLP module name: its hidden width} of the MLPs the model axis
    shards: every tensor of the MLP's fc1 and fc2 weights divides."""
    shapes = {n: tuple(p.shape) for n, p in model.named_parameters()}
    spec = param_sharding(mesh, shapes)
    out = {}
    for name, dim in spec.items():
        if name.endswith("fc1.weight") and dim is not None:
            prefix = _mlp_prefix(name)
            if spec.get(prefix + ".fc2.weight") is not None:
                out[prefix] = shapes[name][0]
    return out


def _local(t: torch.Tensor, dim: int, mesh: Mesh) -> torch.Tensor:
    n = t.shape[dim] // mesh.model
    return t.narrow(dim, mesh.model_index * n, n).contiguous()


def shard_model(model: torch.nn.Module, mesh: Mesh) -> None:
    """Keep this rank's shard of every sharded MLP's ``fc1`` and ``fc2``
    (new parameters, in place of the full ones) and mark the MLP with the
    model group (``Mlp.tp``).  A no-op at ``model`` 1."""
    if mesh.model == 1:
        return
    for prefix in sharded_mlps(mesh, model):
        mlp = model.get_submodule(prefix)
        with torch.no_grad():
            mlp.fc1.weight = torch.nn.Parameter(_local(mlp.fc1.weight, 0, mesh))
            mlp.fc1.bias = torch.nn.Parameter(_local(mlp.fc1.bias, 0, mesh))
            mlp.fc2.weight = torch.nn.Parameter(_local(mlp.fc2.weight, 1, mesh))
        mlp.tp = mesh.model_group


def local_spec(mesh: Mesh, model: torch.nn.Module) -> Dict[str, int]:
    """{parameter name: sharded dim} of ``model`` after ``shard_model``."""
    out = {}
    for name, _ in model.named_parameters():
        dim = _param_spec(name)
        if dim is not None and getattr(model.get_submodule(
                _mlp_prefix(name)), "tp", None) is not None:
            out[name] = dim
    return out


def _gather(t: torch.Tensor, dim: int, mesh: Mesh) -> torch.Tensor:
    parts = [torch.empty_like(t) for _ in range(mesh.model)]
    dist.all_gather(parts, t.contiguous(), group=mesh.model_group)
    return torch.cat(parts, dim)


def full_state_dict(model: torch.nn.Module, mesh: Mesh) -> Dict[str,
                                                                torch.Tensor]:
    """The model's state dict with its sharded tensors gathered whole over
    the model group (every rank of the group must call it)."""
    spec = local_spec(mesh, model)
    return {k: (_gather(v, spec[k], mesh) if k in spec else v)
            for k, v in model.state_dict().items()}


def shard_state_dict(full: Dict[str, torch.Tensor], mesh: Mesh,
                     model: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """A full state dict cut to this rank's shards of ``model``."""
    spec = local_spec(mesh, model)
    return {k: (_local(v, spec[k], mesh) if k in spec else v)
            for k, v in full.items()}


def _optimizer_dims(tx, model, mesh):
    """{optimizer state index: sharded dim} (the optimizer numbers its
    parameters in group order)."""
    spec = local_spec(mesh, model)
    names = {id(p): n for n, p in model.named_parameters()}
    params = [p for g in tx.optimizer.param_groups for p in g["params"]]
    return {i: spec[names[id(p)]] for i, p in enumerate(params)
            if names[id(p)] in spec}


def full_optimizer_state(tx, model, mesh: Mesh) -> dict:
    """The optimizer's state dict with the moments of sharded parameters
    gathered whole (every rank of the model group must call it)."""
    sd = tx.optimizer.state_dict()
    dims = _optimizer_dims(tx, model, mesh)
    state = {}
    for i, st in sd["state"].items():
        state[i] = {k: (_gather(v, dims[i], mesh)
                        if i in dims and torch.is_tensor(v) and v.dim() > 0
                        else v) for k, v in st.items()}
    return dict(sd, state=state)


def shard_optimizer_state(full: dict, tx, model, mesh: Mesh) -> dict:
    """A full optimizer state dict cut to this rank's shards."""
    dims = _optimizer_dims(tx, model, mesh)
    state = {}
    for i, st in full["state"].items():
        i = int(i)
        state[i] = {k: (_local(v, dims[i], mesh)
                        if i in dims and torch.is_tensor(v) and v.dim() > 0
                        else v) for k, v in st.items()}
    return dict(full, state=state)


# a bucket of the gradient all-reduce: 2^22 f32 (16 MiB)
BUCKET = 1 << 22


def all_reduce_gradients(params, group) -> None:
    """Sum the gradients of ``params`` over ``group`` in place: buckets of
    at most ``BUCKET`` elements in parameter order, each flattened, summed
    by one all-reduce and copied back.  A missing gradient takes zeros
    first (as ``Transform.apply`` would), so every rank's buckets match."""
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    bucket, size = [], 0
    for p in list(params) + [None]:
        if p is not None and (not bucket or size + p.numel() <= BUCKET):
            bucket.append(p.grad)
            size += p.numel()
            continue
        if bucket:
            flat = torch.cat([g.reshape(-1) for g in bucket])
            dist.all_reduce(flat, group=group)
            torch._foreach_copy_(bucket, [v.view_as(g) for g, v in zip(
                bucket, flat.split([g.numel() for g in bucket]))])
        if p is not None:
            bucket, size = [p.grad], p.numel()


def all_reduce_scalars(values: Dict[str, torch.Tensor], group) -> Dict[
        str, torch.Tensor]:
    """A dict of 0-dim tensors summed over ``group`` (one all-reduce)."""
    keys = sorted(values)
    flat = torch.stack([values[k].detach().float() for k in keys])
    dist.all_reduce(flat, group=group)
    return dict(zip(keys, flat.unbind()))
