"""Logical-axis parameter sharding (port of ``repro.distributed.sharding``).

Every parameter is registered with its logical axes
(``models.layers.param``, the reference's ``A``); ``param_axes`` collects
them by qualified name. ``make_specs`` maps logical names to mesh axes
through a rules table, with automatic divisibility fallback (a dimension
that does not divide over its mesh axis is replicated and the event
recorded — e.g. 8 KV heads on a 16-way model axis).

A spec is a tuple with one entry a dimension: ``None`` (replicated), a mesh
axis name, or a tuple of names — the counterpart of ``PartitionSpec``.
``spec_for`` reads only ``mesh.shape`` (a mapping or a tuple) and
``mesh.axis_names``, so specs and the dry run need no process group;
``placements``, ``local_shard``, ``shard_params`` and ``gather_params``
take a ``torch.distributed.DeviceMesh``.

Rules express the full parallelism palette:
  * TP  : "heads"/"ff"/"vocab"/... -> "model"
  * EP  : "experts"               -> "model"
  * FSDP: "embed" (the large replicated dim of every weight) -> data axes
  * DP  : activations' "batch"    -> ("pod", "data").

The reference stacks a scanned segment's layers on a leading ``"layers"``
axis (replicated); the port holds one module a layer, so its names carry
the layer index instead and no axis stands for it.
"""

from __future__ import annotations

import dataclasses
import math

import torch
from torch import nn


def param_axes(module: nn.Module) -> dict:
    """``{qualified parameter name: logical axes}`` of every parameter of
    ``module``, in ``named_parameters`` order."""
    out = {}
    mods = dict(module.named_modules())
    for name, _ in module.named_parameters():
        owner, _, leaf = name.rpartition(".")
        axes = mods[owner].__dict__.get("param_axes", {})
        if leaf not in axes:
            raise KeyError(f"parameter {name!r} was registered without "
                           f"logical axes (models.layers.param)")
        out[name] = axes[leaf]
    return out


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    """Logical-name -> mesh-axis mapping. ``data_axes`` is the DP/FSDP axis
    group (("pod","data") on the multi-pod mesh)."""
    data_axes: tuple = ("data",)
    model_axis: str = "model"
    fsdp: bool = False                 # shard the "embed" dim of weights on data
    seq_shard: bool = False            # sequence parallelism for activations

    def table(self) -> dict:
        t = {
            "batch": tuple(self.data_axes),
            "seq": None,                # inside attention: seq stays gathered
            # between-block activation carries (the remat residuals): shard
            # seq over the model axis = Megatron sequence parallelism
            "seq_act": self.model_axis if self.seq_shard else None,
            "embed": tuple(self.data_axes) if self.fsdp else None,
            "embed_act": None,          # activation d_model dim
            "embed_norm": None,         # norm scales: tiny, replicate
            "heads": self.model_axis,
            "kv_heads": self.model_axis,
            "head_dim": None,
            "ff": self.model_axis,
            "vocab": self.model_axis,
            "experts": self.model_axis,
            "expert_ff": None,
            "expert_cap": None,                    # capacity stays local
            "dispatch": tuple(self.data_axes),     # MoE dispatch groups
            "flat_tokens": tuple(self.data_axes),
            "layers": None,
            "lora": None,
            "conv_k": None,
            "stub": None,
            "seq_table": None,
        }
        return t


def mesh_sizes(mesh) -> dict:
    """``{axis name: size}`` of a DeviceMesh or of any object with
    ``axis_names`` and a ``shape`` (a tuple in axis order, or a mapping)."""
    names = tuple(getattr(mesh, "mesh_dim_names", None)
                  or mesh.axis_names)
    shape = mesh.shape
    if isinstance(shape, dict):
        return {a: int(shape[a]) for a in names}
    return dict(zip(names, (int(s) for s in shape)))


def axes_size(mesh, axes) -> int:
    """Product of the sizes of ``axes`` (a name or a tuple of names)."""
    sizes = mesh_sizes(mesh)
    axes = axes if isinstance(axes, tuple) else (axes,)
    return math.prod(sizes[a] for a in axes)


def spec_for(axes: tuple, shape: tuple, rules: ShardingRules, mesh,
             notes: list | None = None) -> tuple:
    """The spec of one param/activation: divisibility fallback to
    replication, and first-come-first-served on mesh axes (a mesh axis can
    shard only one dim — e.g. with sequence-sharded activations, 'seq' takes
    the model axis and 'heads' falls back to replicated)."""
    table = rules.table()
    entries: list = []
    used: set = set()
    for name, dim in zip(axes, shape):
        ax = table.get(name, None)
        if ax is None:
            entries.append(None)
            continue
        ax_tuple = ax if isinstance(ax, tuple) else (ax,)
        size = axes_size(mesh, ax_tuple)
        if dim % size != 0 or any(a in used for a in ax_tuple):
            if notes is not None and dim % size != 0:
                notes.append(
                    f"axis {name!r} dim {dim} % mesh {size} != 0 -> replicated")
            entries.append(None)
        else:
            # a singleton tuple is the bare axis name
            entries.append(ax_tuple[0] if len(ax_tuple) == 1 else ax)
            used.update(ax_tuple)
    return tuple(entries)


def make_specs(axes: dict, shapes: dict, rules: ShardingRules, mesh,
               notes: list | None = None) -> dict:
    """``{name: spec}`` for ``{name: shape}`` and ``{name: axes}``."""
    out = {}
    for name, shape in shapes.items():
        ax = axes[name]
        shape = tuple(shape)
        assert len(ax) == len(shape), f"{name}: axes {ax} vs shape {shape}"
        out[name] = spec_for(ax, shape, rules, mesh, notes)
    return out


def shard_factor(spec: tuple, mesh) -> int:
    """How many ways a tensor of ``spec`` is split: its per-device share is
    1/shard_factor of it."""
    n = 1
    for e in spec:
        if e is not None:
            n *= axes_size(mesh, e)
    return n


def per_device_bytes(tree: dict, specs: dict, mesh) -> int:
    """Bytes a device holds of ``{name: tensor}`` (real, fake or meta)
    laid out by ``{name: spec}``."""
    return sum(t.numel() * t.element_size() // shard_factor(specs[k], mesh)
               for k, t in tree.items())


def placements(spec: tuple, mesh) -> tuple:
    """DTensor placements on the DeviceMesh ``mesh`` for ``spec``: one a
    mesh dimension, ``Shard(d)`` where dimension ``d`` of the tensor is
    split over it, else ``Replicate()``. A dimension split over several
    mesh axes splits over them in the order the entry names them."""
    from torch.distributed.tensor import Replicate, Shard
    names = list(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for d, e in enumerate(spec):
        if e is None:
            continue
        for a in (e if isinstance(e, tuple) else (e,)):
            out[names.index(a)] = Shard(d)
    return tuple(out)


def local_shard(full: torch.Tensor, place: tuple, mesh) -> torch.Tensor:
    """This rank's shard of ``full`` under the DTensor placements
    ``place`` on ``mesh``, as ``distribute_tensor`` cuts it (``torch.chunk``
    along each split dimension, mesh dimensions in order): a copy of its
    own where something is split — so the full tensor's storage is not
    held by it — else ``full`` itself."""
    from torch.distributed.tensor import Shard
    coord = mesh.get_coordinate()
    local = full
    for i, pl in enumerate(place):
        if isinstance(pl, Shard):
            local = torch.chunk(local, mesh.size(i), dim=pl.dim)[coord[i]]
    if local is not full:
        local = local.clone(memory_format=torch.contiguous_format)
    return local


@torch.no_grad()
def shard_params(model: nn.Module, rules: ShardingRules, mesh,
                 notes: list | None = None) -> nn.Module:
    """Replace every parameter of ``model`` by a DTensor parameter laid out
    by its spec on ``mesh``, in place; returns ``model``. Every rank holds
    the full tensors (the same weights: one seed or one checkpoint), so
    each cuts its shard (``local_shard``) with no collective —
    ``distribute_tensor`` would scatter each split leaf from rank 0, which
    gloo stages through the host for a model on the card. A split leaf's
    full tensor is freed as its parameter is replaced; a replicated
    leaf's DTensor holds the full tensor's storage itself."""
    from torch.distributed.tensor import DTensor
    specs = make_specs(param_axes(model), {k: p.shape for k, p in
                                           model.named_parameters()},
                       rules, mesh, notes)
    mods = dict(model.named_modules())
    for name, spec in specs.items():
        owner, _, leaf = name.rpartition(".")
        mod = mods[owner]
        full = getattr(mod, leaf)
        place = placements(spec, mesh)
        dt = DTensor.from_local(local_shard(full.detach(), place, mesh),
                                mesh, place, run_check=False,
                                shape=full.shape, stride=full.stride())
        mod.register_parameter(leaf, nn.Parameter(
            dt, requires_grad=full.requires_grad))
    return model


def gather_params(model: nn.Module) -> dict:
    """``{name: full tensor}`` of a model whose parameters are DTensors
    (``full_tensor()``, a collective every rank joins) — for tests and
    checkpoints; plain parameters pass through detached."""
    return gather_tree(dict(model.named_parameters()))


def gather_tree(tree: dict) -> dict:
    """``{name: full tensor}`` of a dict of DTensors (the moments); plain
    tensors pass through detached."""
    from torch.distributed.tensor import DTensor
    return {k: v.detach().full_tensor() if isinstance(v, DTensor)
            else v.detach() for k, v in tree.items()}


def logical_constraint(x, axes: tuple, rules: ShardingRules, mesh):
    """Redistribute the DTensor ``x`` to the layout of its logical
    ``axes`` (the reference's ``with_sharding_constraint``); a no-op
    without a mesh."""
    if mesh is None:
        return x
    spec = spec_for(axes, tuple(x.shape), rules, mesh)
    return x.redistribute(mesh, placements(spec, mesh))
