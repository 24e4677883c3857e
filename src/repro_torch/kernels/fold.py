"""Order-fixed f32 sums for the plain versions.

The kernels fold their order-sensitive f32 sums (freed resources,
latency sums) in one fixed order, so the plain versions must add the
same terms in the same order to agree bit for bit; a ``torch.sum``
reduces in an order of its own choosing, so it cannot.

The order: a left fold over each run of :data:`CHUNK` consecutive
indices, then the runs' totals added in ascending order; for rows of up
to 32 entries, a plain left fold. It is XLA:CPU's order for a plain row
reduction of a multiple of 32 entries, and for the reference's
``fleet_tick`` freed sums at ``max_containers = 64`` (measured with jax
0.9.0), where a plain left fold differs. Inside other fusions XLA picks
other orders (an 8-way strided one for those freed sums at 32
containers), so agreement with the reference on arbitrary f32 terms is
a measured fact of the test grid, not a property of the fold.
"""
from __future__ import annotations

import torch

CHUNK = 32


def ordered_sum(values: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """For every group ``g``: ``total = 0; for each run of CHUNK indices
    in order: run = 0; for i ascending in the run: if mask[..., g, i]:
    run += values[..., i]; total += run``. ``values`` ``[F, N]``,
    ``mask`` ``[F, G, N]``; returns ``[F, G]``.

    Skipped terms would only add +0.0, which leaves every sum of
    nonnegative terms unchanged, so each run folds its masked terms
    alone: round ``r`` adds each run's ``r``-th masked term (a sum with
    exactly one nonzero term, hence exact in any order). The number of
    rounds is the largest masked count of a run, read once on the host.
    """
    n = mask.shape[-1]
    pad = (-n) % CHUNK
    if pad:
        values = torch.cat([values, values.new_zeros(values.shape[:-1] + (pad,))], -1)
        mask = torch.cat([mask, mask.new_zeros(mask.shape[:-1] + (pad,))], -1)
    runs = (n + pad) // CHUNK
    vals = values.reshape(values.shape[:-1] + (1, runs, CHUNK))
    m = mask.reshape(mask.shape[:-1] + (runs, CHUNK))            # [F, G, R, C]
    rank = torch.cumsum(m, dim=-1, dtype=torch.int32)
    part = torch.zeros(m.shape[:-1], dtype=values.dtype, device=values.device)
    rounds = int(rank[..., -1].max()) if rank.numel() else 0
    for r in range(1, rounds + 1):
        part = part + torch.where(m & (rank == r), vals, 0.0).sum(-1)
    total = torch.zeros(mask.shape[:-1], dtype=values.dtype, device=values.device)
    for c in range(runs):
        total = total + part[..., c]
    return total


__all__ = ["CHUNK", "ordered_sum"]
