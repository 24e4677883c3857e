"""Smallest job first, lane-major, as ``repro.core.extra_schedulers``.

``sjf`` orders the waiting queue by op count (fewest first), then
priority, then entry tick, with 25 % chunks, OOM-retry doubling capped
at 50 % and no preemption, all on pool 0. It is a point of the
parameterised family (``DEFAULT_POINTS["sjf"]``); the legacy decision
loop :func:`_sjf_like` stays registered as the ``sjf_ref`` oracle, and
:func:`_select_sjf` is the five-pass oracle of its queue head.

The data-plane schedulers ``cache_aware`` and ``locality_pool`` register
in ``scheduler.py``.
"""
from __future__ import annotations

import torch

from ..kernels.sched_select import select_sjf
from ..kernels.state_update.ref import first_true
from .params import SimParams
from .policy import DEFAULT_POINTS
from .scheduler import (
    EPS,
    decision_loop,
    empty_decision,
    get_vector_scheduler,
    onehot_add,
    onehot_set,
    policy_family_make,
    register_vector_scheduler_family,
    take,
)
from .state import SimState, Workload
from .types import INF_TICK, PipeStatus

CHUNK = 0.25
CAP = 0.50


def _select_sjf(mask, n_ops, prio, entered):
    """Fewest ops, then highest priority, then earliest entry, then pid,
    in five masked passes per lane (``[F, MP]`` -> ``[F]``, -1 where the
    mask is empty): the oracle of ``select_sjf``."""
    any_ = mask.any(-1)
    n = torch.where(mask, n_ops, 2**30)
    m1 = mask & (n_ops == n.amin(-1, keepdim=True))
    p = torch.where(m1, prio, -1)
    m2 = m1 & (prio == p.amax(-1, keepdim=True))
    e = torch.where(m2, entered, INF_TICK)
    m3 = m2 & (entered == e.amin(-1, keepdim=True))
    return torch.where(any_, first_true(m3, -1), -1).to(torch.int32)


def _sjf_like(early_exit: bool = False):
    def sjf(sched_state, sim: SimState, wl: Workload, params: SimParams,
            active: torch.Tensor):
        F = sim.tick.shape[0]
        K = params.max_assignments_per_tick
        total_cpu = sim.pool_cpu_cap.sum(-1)
        total_ram = sim.pool_ram_cap.sum(-1)
        chunk_cpu, chunk_ram = CHUNK * total_cpu, CHUNK * total_ram
        cap_cpu, cap_ram = CAP * total_cpu, CAP * total_ram

        dec = empty_decision(params, F, sim.tick.device)
        waiting0 = sim.pipe_status == int(PipeStatus.WAITING)
        reject = waiting0 & sim.pipe_fail_flag & (sim.pipe_last_ram >= (cap_ram - EPS)[:, None])
        base_mask = waiting0 & ~reject
        pool0 = torch.zeros((F,), dtype=torch.int32, device=sim.tick.device)

        def step(k, carry):
            a_pipe, a_cpus, a_ram, free_cpu, free_ram, tried = carry
            pipe = select_sjf(base_mask & ~tried, wl.n_ops, wl.prio, sim.pipe_entered)
            valid = pipe >= 0
            pipe_c = pipe.clamp_min(0)
            failed = take(sim.pipe_fail_flag, pipe_c)
            last_cpus = take(sim.pipe_last_cpus, pipe_c)
            last_ram = take(sim.pipe_last_ram, pipe_c)
            seen = last_ram > 0.0
            want_cpu = torch.where(failed, torch.minimum(2.0 * last_cpus, cap_cpu),
                                   torch.where(seen, last_cpus, chunk_cpu))
            want_ram = torch.where(failed, torch.minimum(2.0 * last_ram, cap_ram),
                                   torch.where(seen, last_ram, chunk_ram))
            fits = (free_cpu[:, 0] >= want_cpu - EPS) & (free_ram[:, 0] >= want_ram - EPS)
            do = valid & fits
            a_pipe, a_cpus, a_ram = a_pipe.clone(), a_cpus.clone(), a_ram.clone()
            a_pipe[:, k] = torch.where(do, pipe_c, -1)
            a_cpus[:, k] = want_cpu
            a_ram[:, k] = want_ram
            dv = do[:, None]
            free_cpu = torch.where(dv, onehot_add(free_cpu, pool0, -want_cpu), free_cpu)
            free_ram = torch.where(dv, onehot_add(free_ram, pool0, -want_ram), free_ram)
            tried = torch.where(valid[:, None], onehot_set(tried, pipe_c, True), tried)
            return (a_pipe, a_cpus, a_ram, free_cpu, free_ram, tried), valid

        carry0 = (dec.assign_pipe, dec.assign_cpus, dec.assign_ram,
                  sim.pool_cpu_free, sim.pool_ram_free, torch.zeros_like(waiting0))
        a_pipe, a_cpus, a_ram, *_ = decision_loop(step, K, carry0, active)
        return sched_state, dec._replace(
            reject=reject, assign_pipe=a_pipe, assign_cpus=a_cpus, assign_ram=a_ram,
        )

    return sjf


register_vector_scheduler_family("sjf", params=DEFAULT_POINTS["sjf"])(policy_family_make)
register_vector_scheduler_family("sjf_ref")(_sjf_like)
sjf_vector = get_vector_scheduler("sjf")


__all__ = ["sjf_vector"]
