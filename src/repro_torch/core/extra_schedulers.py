"""Smallest job first, lane-major, as ``repro.core.extra_schedulers``.

``sjf`` orders the waiting queue by op count (fewest first), then
priority, then entry tick, with 25 % chunks, OOM-retry doubling capped
at 50 % and no preemption, all on pool 0. It is a point of the
parameterised family (``DEFAULT_POINTS["sjf"]``); the legacy decision
loop :func:`_sjf_like` stays registered as the ``sjf_ref`` oracle, and
:func:`_select_sjf` is the five-pass oracle of its queue head.

The data-plane schedulers ``cache_aware`` and ``locality_pool`` register
in ``scheduler.py``. The Python engine's twins of all three
(``sjf_python``, ``cache_aware_python``, ``locality_pool_python``)
register here through ``algorithm.py``, as in the reference.
"""
from __future__ import annotations

from typing import List

import numpy as np
import torch

from ..kernels.sched_select import select_sjf
from ..kernels.state_update.ref import first_true
from .algorithm import register_scheduler, register_scheduler_init
from .engine_python import Scheduler, _priority_like_py
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
from .types import INF_TICK, Assignment, Failure, Pipeline, PipeStatus, Suspension

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


@register_scheduler_init(key="sjf")
def _sjf_init(sch: Scheduler) -> None:
    pass


@register_scheduler(key="sjf")
def sjf_python(sch: Scheduler, failures: List[Failure], new: List[Pipeline]):
    f32 = np.float32
    total_cpu, total_ram = sch.total_cpus, sch.total_ram_gb
    chunk_cpu, chunk_ram = f32(CHUNK) * total_cpu, f32(CHUNK) * total_ram
    cap_cpu, cap_ram = f32(CAP) * total_cpu, f32(CAP) * total_ram
    eps = f32(EPS)

    suspends: list[Suspension] = []
    assignments = []
    free_cpu = sch.pool_cpu_free.copy()
    free_ram = sch.pool_ram_free.copy()
    rejects = [
        pid for pid in sch.waiting_pids()
        if sch.pipelines[pid].failed_before
        and f32(sch.pipelines[pid].last_ram_gb) >= cap_ram - eps
    ]
    sch.data["rejects"] = rejects
    tried = set(rejects)
    for _ in range(sch.params.max_assignments_per_tick):
        cands = [
            pid for pid in sch.status
            if sch.status[pid] == PipeStatus.WAITING and pid not in tried
        ]
        if not cands:
            break
        pid = min(
            cands,
            key=lambda pid: (
                sch.pipelines[pid].num_ops,
                -int(sch.pipelines[pid].priority),
                sch.entered[pid],
                pid,
            ),
        )
        tried.add(pid)
        p = sch.pipelines[pid]
        if p.failed_before:
            want_cpu = np.minimum(f32(2.0) * f32(p.last_cpus), cap_cpu)
            want_ram = np.minimum(f32(2.0) * f32(p.last_ram_gb), cap_ram)
        elif p.last_ram_gb > 0.0:
            want_cpu, want_ram = f32(p.last_cpus), f32(p.last_ram_gb)
        else:
            want_cpu, want_ram = chunk_cpu, chunk_ram
        if free_cpu[0] >= want_cpu - eps and free_ram[0] >= want_ram - eps:
            assignments.append(Assignment(p, 0, want_cpu, want_ram))
            free_cpu[0] -= want_cpu
            free_ram[0] -= want_ram
    return suspends, assignments


# the data-plane schedulers' Python twins reuse the mirrored priority
# machinery of engine_python.py
@register_scheduler_init(key="cache_aware")
def _cache_aware_init(sch: Scheduler) -> None:
    pass


@register_scheduler(key="cache_aware")
def cache_aware_python(sch: Scheduler, failures: List[Failure], new: List[Pipeline]):
    return _priority_like_py(sch, "cache")


@register_scheduler_init(key="locality_pool")
def _locality_pool_init(sch: Scheduler) -> None:
    pass


@register_scheduler(key="locality_pool")
def locality_pool_python(sch: Scheduler, failures: List[Failure], new: List[Pipeline]):
    return _priority_like_py(sch, "locality")


__all__ = [
    "sjf_vector",
    "sjf_python",
    "cache_aware_python",
    "locality_pool_python",
]
