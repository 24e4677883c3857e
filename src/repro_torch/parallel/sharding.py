"""Logical-axis -> mesh-axis sharding rules (t5x-style, divisibility-aware),
a port of ``repro.parallel.sharding`` onto ``torch.distributed``.

Every parameter carries a space-separated logical axis string (one name
per dim: ``models.axes.model_axes``). Rules map logical names to an
ordered preference of mesh axes; an assignment is dropped (replicated)
when the dim size is not divisible by the mesh axis size or the axis is
already taken by another dim of the same tensor. This is what lets one
rule set drive MQA (kv=1 -> replicated) and GQA (kv=16 -> TP) alike.

Parallelism styles expressed purely through rules:
* TP  — heads/ff/expert/vocab on "model"
* FSDP — embed (the weight dim every tensor shares) on "data"
* EP  — expert on "model"
* DP  — activation batch on ("pod", "data")
* SP  — decode-time KV/context seq on "model" (kv_seq rule)

``spec_for`` returns the reference's ``PartitionSpec`` entries as a
tuple (None, a mesh axis name, or a tuple of names; trailing Nones
trimmed). It reads a ``DeviceMesh`` (``mesh_dim_names``, ``size(i)``) or
any object with ``axis_names`` and a ``shape`` mapping. ``placements``
turns a spec into DTensor placements, one per mesh dim: ``Shard(d)``
where tensor dim d takes that mesh axis, ``Replicate()`` elsewhere and
on an axis of one rank (which splits nothing: a size-1 shard would only
stop DTensor from reshaping a dim of size 1, MQA's kv heads). A
dim sharded over several mesh axes (``"batch" -> ("pod", "data")``) is
split in mesh-dim order, as DTensor splits it; a tuple in any other
order raises instead of being reordered.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Mapping, Sequence

import torch
from torch import nn

DEFAULT_PARAM_RULES: dict[str, tuple[str, ...]] = {
    "vocab": ("model",),
    "heads": ("model",),
    "kv_heads": ("model",),
    "head_dim": (),
    "ff": ("model",),
    "expert": ("model",),
    "embed": ("data",),          # FSDP
    "embed_moe": ("data",),      # FSDP for expert weights (giants opt out)
    "layers": (),
    "conv": (),
    "state": (),
}

DEFAULT_ACT_RULES: dict[str, tuple[str, ...]] = {
    "batch": ("pod", "data"),
    "seq": (),
    "expert_cap": (),
    "embed_moe": (),
    "kv_seq": ("model",),
    "embed": (),
    "heads": ("model",),
    "kv_heads": ("model",),
    "head_dim": (),
    "ff": ("model",),
    "expert": ("model",),
    "vocab": ("model",),
    "layers": (),
    "state": (),
    "conv": (),
}


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    param: Mapping[str, tuple[str, ...]] = dataclasses.field(
        default_factory=lambda: dict(DEFAULT_PARAM_RULES)
    )
    act: Mapping[str, tuple[str, ...]] = dataclasses.field(
        default_factory=lambda: dict(DEFAULT_ACT_RULES)
    )

    def override(self, *, param=None, act=None) -> "ShardingRules":
        p = dict(self.param)
        p.update(param or {})
        a = dict(self.act)
        a.update(act or {})
        return ShardingRules(param=p, act=a)


def mesh_axes(mesh) -> dict[str, int]:
    """``{axis name: size}`` of a ``DeviceMesh`` or a duck-typed mesh
    (``axis_names`` and a ``shape`` mapping), in mesh-dim order."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return {name: int(mesh.size(i)) for i, name in enumerate(names)}
    return {name: int(mesh.shape[name]) for name in mesh.axis_names}


def spec_for(shape: Sequence[int], axes: str, mesh,
             rules: Mapping[str, tuple[str, ...]]) -> tuple:
    """The partition spec of ``shape`` with logical axes ``axes``."""
    names = axes.split() if axes else []
    if len(names) != len(shape):
        # axes annotations must line up; treat mismatch as replicated
        return ()
    sizes = mesh_axes(mesh)
    used: set[str] = set()
    out = []
    for dim, name in zip(shape, names):
        picked: list[str] = []
        prod = 1
        # a dim may absorb several mesh axes (batch -> pod x data)
        for cand in rules.get(name, ()):
            if cand in used or cand not in sizes:
                continue
            nxt = prod * sizes[cand]
            if dim % nxt == 0 and dim >= nxt:
                picked.append(cand)
                used.add(cand)
                prod = nxt
        if not picked:
            out.append(None)
        elif len(picked) == 1:
            out.append(picked[0])
        else:
            out.append(tuple(picked))
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


def placements(spec: tuple, mesh) -> list:
    """DTensor placements of ``spec`` on ``mesh``, one per mesh dim."""
    from torch.distributed.tensor import Replicate, Shard

    sizes = mesh_axes(mesh)
    order = list(sizes)
    out = [Replicate() for _ in order]
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        group = (entry,) if isinstance(entry, str) else tuple(entry)
        ranks = [order.index(a) for a in group]
        if ranks != sorted(ranks):
            raise ValueError(f"dim {d} is sharded over {group}, not in the mesh's order "
                             f"{tuple(order)}: DTensor would split it the other way")
        for r in ranks:
            if sizes[order[r]] > 1:
                out[r] = Shard(d)
    return out


def placements_for(shape: Sequence[int], axes: str, mesh, rules) -> list:
    return placements(spec_for(shape, axes, mesh, rules), mesh)


def param_shardings(axes: Mapping[str, str], shapes: Mapping, mesh,
                    rules: ShardingRules) -> dict:
    """``{name: placements}`` of a parameter set from its axes and shapes
    (tensors, ``meta`` tensors or shape tuples)."""
    return {name: placements_for(tuple(getattr(shapes[name], "shape", shapes[name])),
                                 ax, mesh, rules.param)
            for name, ax in axes.items()}


def distribute(t: torch.Tensor, mesh, place) -> torch.Tensor:
    """``t``, the whole value on every rank, as a DTensor of ``place``:
    each rank keeps its own slice, with no communication."""
    from torch.distributed.tensor import distribute_tensor

    return distribute_tensor(t, mesh, place, src_data_rank=None)


@torch.no_grad()
def shard_params(module: nn.Module, axes: Mapping[str, str], mesh, rules: ShardingRules):
    """Replace every parameter of ``module`` (the whole value on every
    rank) by a DTensor parameter placed by ``rules.param``; returns the
    module."""
    named = dict(module.named_parameters())
    plan = param_shardings(axes, named, mesh, rules)
    for name, p in named.items():
        owner, _, leaf = name.rpartition(".")
        mod = module.get_submodule(owner) if owner else module
        mod._parameters[leaf] = nn.Parameter(distribute(p.detach(), mesh, plan[name]),
                                             requires_grad=p.requires_grad)
    return module


def compute_placements(p) -> list:
    """The placements a DTensor parameter takes for a step's compute:
    shards over a data axis (FSDP: ``"data"``, ``"pod"``) of more than
    one rank are gathered whole; ``"model"`` shards (TP, EP) stay."""
    from torch.distributed.tensor import Replicate, Shard

    names = p.device_mesh.mesh_dim_names or ()
    return [Replicate() if isinstance(pl, Shard) and names[i] != "model" else pl
            for i, pl in enumerate(p.placements)]


@contextlib.contextmanager
def gathered_params(module: nn.Module):
    """Inside, every DTensor parameter of ``module`` whose compute
    placements differ from its own reads as its gathered copy (a
    differentiable ``redistribute``: autograd reduce-scatters the
    gradients back onto the shards); outside, the parameters are the
    shards again."""
    from torch.distributed.tensor import DTensor

    saved = []
    for name, p in list(module.named_parameters()):
        if not isinstance(p, DTensor):
            continue
        place = compute_placements(p)
        if place == list(p.placements):
            continue
        owner, _, leaf = name.rpartition(".")
        mod = module.get_submodule(owner) if owner else module
        saved.append((mod, leaf, p))
        mod._parameters[leaf] = p.redistribute(p.device_mesh, place)
    try:
        yield
    finally:
        for mod, leaf, p in saved:
            mod._parameters[leaf] = p


def logical_constraint(x, axes: str, mesh, rules: ShardingRules):
    """``x`` placed by its logical ``axes`` under ``rules.act`` (a no-op
    without a mesh): a DTensor is redistributed; a plain tensor is taken
    as the whole value on every rank."""
    if mesh is None:
        return x
    from torch.distributed.tensor import DTensor

    place = placements_for(x.shape, axes, mesh, rules.act)
    if isinstance(x, DTensor):
        return x.redistribute(mesh, place)
    return distribute(x, mesh, place)


__all__ = [
    "DEFAULT_ACT_RULES",
    "DEFAULT_PARAM_RULES",
    "ShardingRules",
    "compute_placements",
    "distribute",
    "gathered_params",
    "logical_constraint",
    "mesh_axes",
    "param_shardings",
    "placements",
    "placements_for",
    "shard_params",
    "spec_for",
]
