"""Sharding context of the model code, a port of ``repro.parallel.ctx``.

Model code calls ``constrain(x, "batch seq embed")`` at key activation
sites; under an active ``sharding_ctx(mesh, act_rules)`` a DTensor is
redistributed to the placements the rules give those axes, and anything
else passes unchanged, so single-device runs are untouched. The context
also turns on DTensor's implicit replication: a plain tensor that meets
a DTensor (a position table, a zero state) counts as the same value on
every rank.

``kernel_map`` is the boundary of the hand-written kernels: they take
raw pointers and never a DTensor. Under a context it runs the kernel's
wrapper on each rank's local tensors (``local_map``), with placements
that keep the kernel's reduction axes whole: batch over the mesh's batch
axes, one split dim (attention heads, scan heads or channels) over
``"model"`` where the caller allows it, every other dim replicated.
Inputs placed otherwise are redistributed first. On a one-rank mesh the
kernels launch exactly as often as without a mesh. A DTensor that
reaches ``kernel_map`` outside a context raises: the kernels would read
the wrapper, not its shards.

The context is a ``ContextVar``, which the autograd engine's device
threads do not see; a layer recomputed in the backward
(``torch.utils.checkpoint``) takes ``checkpoint_kwargs()``, which enter
the context of its forward around the recomputation.
"""
from __future__ import annotations

import contextlib
import contextvars

import torch

from .sharding import mesh_axes, placements, placements_for

_CTX: contextvars.ContextVar = contextvars.ContextVar("sharding_ctx", default=None)


@contextlib.contextmanager
def sharding_ctx(mesh, act_rules):
    from torch.distributed.tensor import DTensor

    # DTensor's implicit replication, restored to what it was on the way
    # out (``implicit_replication()`` turns it off: a recomputation's
    # context would turn it off for the rest of the backward)
    dispatcher = DTensor._op_dispatcher
    token, implicit = _CTX.set((mesh, act_rules)), dispatcher._allow_implicit_replication
    dispatcher._allow_implicit_replication = True
    try:
        yield
    finally:
        dispatcher._allow_implicit_replication = implicit
        _CTX.reset(token)


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def constrain(x, axes: str):
    ctx = _CTX.get()
    if ctx is None or not is_dtensor(x):
        return x
    mesh, rules = ctx
    place = placements_for(x.shape, axes, mesh, rules)
    if list(x.placements) == place:
        return x
    return x.redistribute(mesh, place)


def whole(x, dim: int):
    """``x`` with dim ``dim`` unsplit and no pending sum (a DTensor
    sharded on that dim is gathered along it, a partial sum reduced;
    anything else passes): for an index into that dim, which DTensor
    cannot take on a sharded or partial 3-d tensor."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Partial, Replicate, Shard

    dim %= x.ndim
    place = [Replicate() if isinstance(pl, Partial) or (isinstance(pl, Shard) and pl.dim == dim)
             else pl for pl in x.placements]
    return x if place == list(x.placements) else x.redistribute(x.device_mesh, place)


def checkpoint_kwargs() -> dict:
    """Keyword arguments of ``torch.utils.checkpoint.checkpoint`` that
    recompute under the active context (none without one)."""
    ctx = _CTX.get()
    if ctx is None:
        return {}
    return {"context_fn": lambda: (contextlib.nullcontext(), sharding_ctx(*ctx))}


def get_ctx():
    """(mesh, act_rules) of the active sharding context, or None."""
    return _CTX.get()


def batch_axes_in_mesh(batch_size: int):
    """The mesh axes the batch dim is sharded over under the active
    context (respecting divisibility), or None if no context."""
    ctx = _CTX.get()
    if ctx is None:
        return None
    mesh, rules = ctx
    sizes = mesh_axes(mesh)
    picked = []
    prod = 1
    for cand in rules.get("batch", ()):
        if cand not in sizes:
            continue
        nxt = prod * sizes[cand]
        if batch_size % nxt == 0 and batch_size >= nxt:
            picked.append(cand)
            prod = nxt
    return tuple(picked)


def model_size() -> int:
    """The size of the active mesh's ``"model"`` axis (1 without one)."""
    ctx = _CTX.get()
    return 1 if ctx is None else mesh_axes(ctx[0]).get("model", 1)


def kernel_placements(ndim: int, batch_dim, split_dim, batch: int, split: bool):
    """Placements of a kernel operand of ``ndim`` dims under the active
    context: ``batch_dim`` over the batch axes, ``split_dim`` over
    ``"model"`` when ``split``, the rest replicated."""
    mesh, _ = _CTX.get()
    spec = [None] * ndim
    axes = batch_axes_in_mesh(batch)
    if batch_dim is not None and axes:
        spec[batch_dim] = axes
    if split and split_dim is not None and "model" in mesh_axes(mesh):
        spec[split_dim] = "model"
    return placements(tuple(spec), mesh)


def kernel_map(fn, args, dims, out_dims, *, split: bool = False):
    """``fn(*args)``; under a context with a DTensor among ``args``, on
    each rank's local tensors. ``dims`` gives each argument's (batch dim,
    split dim), or None for an argument passed as it is (not a tensor);
    ``out_dims`` each output's (rank, batch dim, split dim): one triple
    for a single output, a list of them for several. A plain tensor
    argument is the whole value on every rank."""
    ctx = _CTX.get()
    if not any(is_dtensor(a) for a in args):
        return fn(*args)
    if ctx is None:
        raise RuntimeError("a DTensor reached a kernel outside a sharding context "
                           "(parallel.ctx.sharding_ctx)")
    from torch.distributed.tensor import DTensor, Replicate
    from torch.distributed.tensor.experimental import local_map

    mesh, _ = ctx
    batch = next(a.shape[d[0]] for a, d in zip(args, dims) if d is not None and d[0] is not None)
    in_pl, wrapped = [], []
    for a, d in zip(args, dims):
        if d is None or not isinstance(a, torch.Tensor):
            in_pl.append(None)
            wrapped.append(a)
            continue
        if not is_dtensor(a):
            a = DTensor.from_local(a, mesh, [Replicate()] * mesh.ndim, run_check=False)
        in_pl.append(kernel_placements(a.ndim, *d, batch, split))
        wrapped.append(a)
    single = isinstance(out_dims, tuple)
    out_pl = [kernel_placements(*d, batch, split) for d in ([out_dims] if single else out_dims)]
    mapped = local_map(fn, out_placements=out_pl[0] if single else tuple(out_pl),
                       in_placements=tuple(in_pl), device_mesh=mesh, redistribute_inputs=True)
    return mapped(*wrapped)


__all__ = [
    "batch_axes_in_mesh",
    "checkpoint_kwargs",
    "constrain",
    "get_ctx",
    "is_dtensor",
    "kernel_map",
    "kernel_placements",
    "model_size",
    "sharding_ctx",
    "whole",
]
