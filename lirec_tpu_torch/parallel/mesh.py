"""The (data, model) process mesh and its tensor-parallel plan (counterpart
of lirec_tpu/parallel/mesh.py).

The JAX package lays a ``('data', 'model')`` mesh over the devices of one
program, annotates the parameters with the plan below and lets XLA insert
the collectives. The port runs one process per card: process ``r`` of a
``D x M`` mesh sits at ``(d, m) = (r // M, r % M)``, the JAX ``make_mesh``'s
row-major grid, process-major. The ``M`` processes of a data row (ranks
``d*M ... d*M+M-1``) are a *model group*: each holds its slice of the
sharded layers and they exchange activations. The ``D`` processes of a
column (ranks ``m, M+m, ...``) are a *data group*: each holds the same
slices and computes its own block of rows of every batch, and their
gradients are summed (parallel/step.py).

* ``Mesh2D`` / ``make_mesh``: the mesh over the process group, with one
  ``new_group`` per model row and per data column (none where M = 1: the
  data axis is then the whole group).
* ``process_local_slice``: the rows of a global batch this process owns,
  by its data index ``d``.
* ``param_plan``: column, row or replicated per layer name, as the JAX
  package's ``_plan_for`` decides it (a copy of its ``_PARAM_PLAN`` names
  and stem rule).
* ``shard_model``: each process keeps its slice of every sharded layer
  (and of its Adam moments, where an optimizer already holds them). A
  column layer keeps ``weight[out/M]`` and ``bias[out/M]``, a row layer
  ``weight[:, in/M]`` and the whole bias; each such ``nn.Linear`` carries
  its ``Shard`` as ``tp_shard``, which models/layers.linear reads.
* ``gather_state``: the ``host_copy`` counterpart: the model group's
  slices all-gathered into the full, reference-named state dict (and the
  optimizer's state, Adam moments whole).
* ``copy_to_model`` / ``reduce_from_model``: the two tensor-parallel
  collectives, as autograd functions over the model group: the identity
  forward with an all-reduce of the gradient (before a column layer),
  and an all-reduce forward with the identity backward (after a row
  layer). Both are plain ``all_reduce`` calls on the current stream.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch
from torch import nn

__all__ = [
    "Mesh2D", "Shard", "COLUMN", "ROW", "REPLICATED", "make_mesh",
    "process_local_slice", "param_plan", "sharded_widths",
    "check_model_axis", "shard_model", "shard_of", "gather_state",
    "gather_grads", "copy_to_model", "reduce_from_model",
]

COLUMN, ROW, REPLICATED = "column", "row", "replicated"

# layer name -> how its weight is split over the model axis: the first
# layers column-parallel, the second layers row-parallel, the gate
# column-parallel feeding a row-parallel out_ints; out_ctx replicated
_PARAM_PLAN = {
    "txt": COLUMN, "txt2": ROW,
    "vis": COLUMN, "vis2": ROW,
    "tracks1": COLUMN, "tracks12": ROW,
    "tracks2": COLUMN, "tracks22": ROW,
    "gates_ints": COLUMN,
    "out_ints": ROW,
    "out_ctx": REPLICATED,
}


class Mesh2D(NamedTuple):
    """A ``size x model`` mesh of processes; this one is at
    ``(rank, model_rank)``. ``data_group`` holds the processes of its
    column, ``model_group`` those of its row (both None where
    ``model`` is 1: the data axis is then the whole process group)."""

    size: int  # D, the data axis
    rank: int  # d, this process's place on it
    model: int = 1  # M, the model axis
    model_rank: int = 0  # m
    data_group: Any = None
    model_group: Any = None

    @property
    def process(self) -> int:
        """This process's rank in the group: d * M + m."""
        return self.rank * self.model + self.model_rank

    @property
    def lead(self) -> bool:
        """The process that prints and writes (rank 0)."""
        return self.process == 0


class Shard(NamedTuple):
    """A layer split over the model axis: `kind` COLUMN or ROW, `size`
    slices, this process's is `index`, exchanged over `group`. The
    activation between a column layer and the row layer after it holds
    the same columns of the full width."""

    kind: str
    size: int
    index: int
    group: Any


def _td():
    import torch.distributed as td

    return td if td.is_available() and td.is_initialized() else None


def make_mesh(shape) -> Mesh2D:
    """(data, model) -> this process's place on the mesh over the process
    group, which must hold data * model processes (one per card). Every
    process of the group must call it, in the same order: it makes the
    model rows' and data columns' groups (where model > 1). A Mesh2D
    passes through."""
    if isinstance(shape, Mesh2D):
        return shape
    data, model = (int(x) for x in shape)
    td = _td()
    world = td.get_world_size() if td else 1
    if data < 1 or model < 1 or data * model != world:
        raise ValueError("a %dx%d mesh needs %d processes, one per card; "
                         "this process group has %d"
                         % (data, model, data * model, world))
    rank = td.get_rank() if td else 0
    if model == 1:
        return Mesh2D(data, rank)
    d, m = divmod(rank, model)
    rows = [td.new_group(list(range(i * model, (i + 1) * model)))
            for i in range(data)]
    cols = [td.new_group(list(range(j, data * model, model)))
            for j in range(model)]
    return Mesh2D(data, d, model, m, cols[m], rows[d])


def process_local_slice(mesh: Mesh2D, global_len: int) -> slice:
    """The rows of a length-`global_len` batch axis this process owns:
    one contiguous block per data index, in order (mesh.process_local_slice
    of the JAX package's process-major layout; the model peers of a row
    own the same block). The length must divide by the data axis, as the
    JAX package's sharding requires."""
    if global_len % mesh.size:
        raise ValueError("a batch of %d rows does not divide by the data "
                         "axis of %d" % (global_len, mesh.size))
    n = global_len // mesh.size
    return slice(mesh.rank * n, (mesh.rank + 1) * n)


def param_plan(name: str, gates: bool) -> str:
    """COLUMN, ROW or REPLICATED for the layer `name` (a top-level child
    of the model: ``txt_ints``, ``gates_ints``, ``out_ctx``, ...): the JAX
    package's ``_plan_for``. Without the gate, out_ints reads a replicated
    input and is replicated."""
    stem = name.split("_")[0] if name not in _PARAM_PLAN else name
    if name == "out_ints" and not gates:
        return REPLICATED
    return _PARAM_PLAN.get(name) or _PARAM_PLAN.get(stem) or REPLICATED


def sharded_widths(spec) -> Dict[str, int]:
    """The widths a model axis splits: {what: width}."""
    widths = {"joint_dim": spec.joint_dim,
              "tracks12's input": spec.joint_dim}
    if spec.gates and not spec.mod_check:
        widths["the gate's"] = spec.gate_out_dim
    return widths


def check_model_axis(spec, model: int) -> None:
    """Refuse a model axis that does not divide every sharded width, naming
    the widths."""
    widths = sharded_widths(spec)
    if any(w % model for w in widths.values()):
        raise ValueError(
            "a model axis of %d does not divide the sharded widths %s"
            % (model, ", ".join("%s %d" % kv for kv in widths.items())))


def _planned_layers(model: nn.Module, gates: bool):
    """(name, nn.Linear, kind) of every layer the plan splits."""
    for name, child in model.named_children():
        kind = param_plan(name, gates)
        if kind == REPLICATED:
            continue
        layer = child.fc_out if hasattr(child, "fc_out") else child
        yield name, layer, kind


def _dims(layer: nn.Linear, kind: str) -> Dict[str, Optional[int]]:
    """The axis each tensor of `layer` is split along (None: whole)."""
    if kind == COLUMN:
        return {"weight": 0, "bias": 0}
    return {"weight": 1, "bias": None}


def _slice(t: torch.Tensor, dim: int, index: int, size: int):
    n = t.shape[dim] // size
    return t.narrow(dim, index * n, n).clone()


def shard_model(model: nn.Module, mesh: Mesh2D, spec,
                optimizer: Optional[torch.optim.Optimizer] = None) -> None:
    """Keep this process's slice of every layer the plan splits, in place
    (the Parameter objects stay, so an optimizer over them stays valid;
    Adam moments it already holds are cut the same way). A model axis of
    1 changes nothing."""
    if mesh.model == 1:
        return
    check_model_axis(spec, mesh.model)
    for _, layer, kind in _planned_layers(model, spec.gates):
        if getattr(layer, "tp_shard", None) is not None:
            raise ValueError("the model is already sharded")
        for pname, dim in _dims(layer, kind).items():
            if dim is None:
                continue
            p = getattr(layer, pname)
            p.data = _slice(p.data, dim, mesh.model_rank, mesh.model)
            state = optimizer.state.get(p, {}) if optimizer else {}
            for key in ("exp_avg", "exp_avg_sq"):
                if key in state:
                    state[key] = _slice(state[key], dim, mesh.model_rank,
                                        mesh.model)
        layer.tp_shard = Shard(kind, mesh.model, mesh.model_rank,
                               mesh.model_group)


def shard_of(layer: nn.Module) -> Optional[Shard]:
    """The layer's Shard, or None where it is whole."""
    return getattr(layer, "tp_shard", None)


def _param_dims(model: nn.Module) -> Dict[int, Tuple[int, Shard]]:
    """id(parameter) -> (its split axis, its layer's Shard)."""
    out = {}
    for module in model.modules():
        shard = shard_of(module)
        if shard is None:
            continue
        for pname, dim in _dims(module, shard.kind).items():
            if dim is not None:
                out[id(getattr(module, pname))] = (dim, shard)
    return out


def _gather(t: torch.Tensor, dim: int, shard: Shard) -> torch.Tensor:
    import torch.distributed as td

    t = t.detach().contiguous()
    parts = [torch.empty_like(t) for _ in range(shard.size)]
    td.all_gather(parts, t, group=shard.group)
    return torch.cat(parts, dim)


def gather_state(model: nn.Module, mesh: Optional[Mesh2D] = None,
                 optimizer: Optional[torch.optim.Optimizer] = None):
    """(state_dict, optimizer state_dict or None) in full: the sharded
    tensors all-gathered over the model group, in the reference's names;
    what a one-process run at the same parameters holds. Every process of
    the model group must call it. The optimizer's state, where asked for,
    is ``optimizer.state_dict()`` with its Adam moments whole, for an
    optimizer of the same kind over an unsharded copy of the model."""
    dims = _param_dims(model)
    params = dict(model.named_parameters())
    full = {}
    for name, t in model.state_dict().items():
        p = params.get(name)
        hit = dims.get(id(p)) if p is not None else None
        full[name] = t if hit is None else _gather(t, *hit)
    if optimizer is None:
        return full, None
    state = optimizer.state_dict()
    ordered = [p for g in optimizer.param_groups for p in g["params"]]
    for i, st in state["state"].items():
        hit = dims.get(id(ordered[i]))
        if hit is None:
            continue
        state["state"][i] = dict(st, **{
            k: _gather(st[k], *hit) for k in ("exp_avg", "exp_avg_sq")
            if k in st})
    return full, state


def gather_grads(model: nn.Module) -> Dict[str, torch.Tensor]:
    """{parameter name: its gradient in full} (the sharded ones
    all-gathered over the model group; every process of it must call
    this); parameters without a gradient are left out."""
    dims = _param_dims(model)
    out = {}
    for name, p in model.named_parameters():
        if p.grad is None:
            continue
        hit = dims.get(id(p))
        out[name] = p.grad if hit is None else _gather(p.grad, *hit)
    return out


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        import torch.distributed as td

        g = g.contiguous().clone()
        td.all_reduce(g, group=ctx.group)
        return g, None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        import torch.distributed as td

        y = x.contiguous().clone()
        td.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_model(x: torch.Tensor, group) -> torch.Tensor:
    """`x` (the same on every process of the model group) into a column
    layer: the identity, whose gradient is summed over the group."""
    return _CopyToModel.apply(x, group)


def reduce_from_model(x: torch.Tensor, group) -> torch.Tensor:
    """A row layer's partial products summed over the model group; the
    gradient passes through unchanged."""
    return _ReduceFromModel.apply(x, group)
