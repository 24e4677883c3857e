"""Plain PyTorch version of the fused phase-1 read (``fleet_tick``).

Carries the semantics of ``repro.kernels.sim_tick.ref.fleet_tick_ref``:
for every lane of a fleet, which containers complete or OOM at ``tick``,
the cpu and RAM their retirement frees on each pool, which arrivals
are admitted, which suspended pipelines are released, and the
next-event registers over the survivors.

Shapes: F = fleet, MC = containers, MP = pipelines, NP = pools.
ctr_status/ctr_end/ctr_oom/pool [F, MC] int32; cpus/ram [F, MC] f32;
pipe_status/arrival/release [F, MP] int32; tick [F] int32.

The freed sums fold each pool's retirements in the fixed order of
``kernels/fold.py``, the order of the CUDA kernel (``csrc/sim_tick.cu``)
and of XLA:CPU's reduction in the reference.
"""
from __future__ import annotations

import torch

from ...core.types import INF_TICK, ContainerStatus, PipeStatus
from ..fold import ordered_sum

RUNNING = int(ContainerStatus.RUNNING)
EMPTY = int(ContainerStatus.EMPTY)
P_EMPTY = int(PipeStatus.EMPTY)
P_SUSPENDED = int(PipeStatus.SUSPENDED)


def fleet_tick_ref(
    ctr_status, ctr_end, ctr_oom, cpus, ram, pool,
    pipe_status, arrival, release, tick, *, num_pools: int,
):
    """Returns ``(oomed, done, new_status, freed_cpu, freed_ram, fresh,
    rel, nxt_retire, nxt_release)``: bool/int32 ``[F, MC]``, f32
    ``[F, NP]``, bool ``[F, MP]`` and int32 ``[F]``."""
    t = tick[:, None]
    running = ctr_status == RUNNING
    oomed = running & (ctr_oom <= t)
    done = running & ~oomed & (ctr_end <= t)
    retired = oomed | done
    new_status = torch.where(retired, EMPTY, ctr_status)

    pools = torch.arange(num_pools, dtype=torch.int32, device=pool.device)
    pool_oh = (pool[:, None, :] == pools[None, :, None]) & retired[:, None, :]
    freed_cpu = ordered_sum(cpus, pool_oh)
    freed_ram = ordered_sum(ram, pool_oh)

    fresh = (pipe_status == P_EMPTY) & (arrival <= t)
    suspended = pipe_status == P_SUSPENDED
    rel = suspended & (release <= t)

    still_run = running & ~retired
    nxt_retire = torch.where(
        still_run, torch.minimum(ctr_end, ctr_oom), INF_TICK
    ).amin(-1)
    nxt_release = torch.where(suspended & ~rel, release, INF_TICK).amin(-1)
    return (
        oomed, done, new_status, freed_cpu, freed_ram,
        fresh, rel, nxt_retire, nxt_release,
    )


__all__ = ["fleet_tick_ref"]
