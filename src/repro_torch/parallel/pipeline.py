"""Pipeline parallelism (GPipe) over a mesh axis, a port of
``repro.parallel.pipeline`` onto ``torch.distributed``.

Stage s of the ``stage_axis`` holds one slice of the stacked stage
parameters; microbatches stream through with the classic GPipe schedule
(M + S - 1 ticks, bubble fraction (S-1)/(M+S-1)). At each tick every
stage runs ``stage_fn`` on its input (microbatch t on stage 0, the
activation its left neighbour sent last tick elsewhere), and the
activations move one stage right: the reference's ``ppermute``, here
``_Shift``, an autograd function over ``dist.batch_isend_irecv`` whose
backward sends the gradients one stage left. As in the reference, every
stage runs ``stage_fn`` at every tick and masks the ticks outside its
window, so that every rank builds the same graph; each tick's received
activation also enters the output with weight zero, so that every
rank's backward runs every ``_Shift`` in the same (reverse) order and
the sends meet their receives. The last stage's outputs are summed to
every rank of the axis with a differentiable all-reduce (``_SumToAll``);
its backward sums the ranks' output gradients, the convention of
``torch.distributed.nn.functional.all_reduce``, so the gradients equal
the sequential stack's when one rank takes the loss (or each takes 1/S
of it).

Not ``torch.distributed.pipelining``: that splits modules and owns the
microbatching, while this surface, as the reference's, is a stage
function.
"""
from __future__ import annotations

from typing import Callable

import torch


def _axis(mesh, stage_axis: str):
    """(group, S, this rank's stage, global ranks of the stages)."""
    import torch.distributed as dist

    group = mesh.get_group(stage_axis)
    ranks = dist.get_process_group_ranks(group)
    return group, len(ranks), dist.get_rank(group), ranks


class _Shift(torch.autograd.Function):
    """Send ``y`` to the next stage, receive the previous stage's
    (zeros on stage 0); the backward is the inverse permutation."""

    @staticmethod
    def forward(ctx, y, ranks, s):
        ctx.ranks, ctx.s = ranks, s
        return _exchange(y, ranks, s, +1)

    @staticmethod
    def backward(ctx, g):
        return _exchange(g.contiguous(), ctx.ranks, ctx.s, -1), None, None


class _SumToAll(torch.autograd.Function):
    """All-reduce (sum) over ``group``; the backward all-reduces the
    gradients."""

    @staticmethod
    def forward(ctx, x, group):
        import torch.distributed as dist

        ctx.group = group
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        import torch.distributed as dist

        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def _keep(x: torch.Tensor, keep: bool) -> torch.Tensor:
    """``x`` or zeros, with the graph kept (a zero gradient when not)."""
    return x if keep else torch.where(torch.zeros((), dtype=torch.bool), x, torch.zeros_like(x))


def _exchange(x: torch.Tensor, ranks, s: int, step: int) -> torch.Tensor:
    import torch.distributed as dist

    S = len(ranks)
    out = torch.zeros_like(x)
    ops = []
    if 0 <= s + step < S:
        ops.append(dist.P2POp(dist.isend, x.contiguous(), ranks[s + step]))
    if 0 <= s - step < S:
        ops.append(dist.P2POp(dist.irecv, out, ranks[s - step]))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return out


def gpipe(stage_fn: Callable, mesh, *, stage_axis: str = "pod",
          num_microbatches: int | None = None):
    """Build a pipelined apply: (stage_params, x) -> y.

    stage_params: a mapping of tensors stacked on a leading [S, ...]
                  axis (the whole stack on every rank: stage s uses slice
                  s), or of DTensors sharded on it over ``stage_axis``.
    x:            [M, mb, ...] microbatches, the same on every rank.
    stage_fn:     (params_slice, x_mb) -> y_mb, same shape.
    Returns y [M, mb, ...] on every rank of the axis.
    """
    group, S, s, ranks = _axis(mesh, stage_axis)

    def take(t):
        from torch.distributed.tensor import DTensor

        return t.to_local()[0] if isinstance(t, DTensor) else t[s]

    def pipelined(stage_params, x):
        M = x.shape[0]
        if num_microbatches is not None and M != num_microbatches:
            raise ValueError(f"x holds {M} microbatches, the pipeline was built for "
                             f"{num_microbatches}")
        params_s = {k: take(v) for k, v in stage_params.items()}
        buf = torch.zeros_like(x[0])
        outs, anchor = [], 0.0
        for t in range(M + S - 1):
            x_in = x[min(t, M - 1)] if s == 0 else buf
            y = _keep(stage_fn(params_s, x_in), 0 <= t - s <= M - 1)
            # the last stage retires microbatch t-(S-1)
            if 0 <= t - (S - 1) < M:
                outs.append(_keep(y, s == S - 1))
            buf = _Shift.apply(y, ranks, s)
            anchor = anchor + _keep(buf, False).sum()
        return _SumToAll.apply(torch.stack(outs), group) + anchor

    return pipelined


def bubble_fraction(num_stages: int, num_microbatches: int) -> float:
    return (num_stages - 1) / (num_microbatches + num_stages - 1)


__all__ = ["bubble_fraction", "gpipe"]
