"""Schedulers (paper §3.2.3, §4.1.2), lane-major.

A scheduler reads the fleet's state after phase 1 and returns one
:class:`SchedDecision` per lane: containers to preempt, pipelines to fail
back to the user, and up to K new assignments.

The registered schedulers ``naive``, ``priority`` and ``priority_pool``
are points of one parameterised family (:func:`policy_family`), as in
``repro.core.scheduler``: the family evaluated at the scheduler's
``DEFAULT_POINTS`` entry. Its queue head is a masked lexicographic
selection over three keys (an f32 lead key, constant +0.0 at these
points, then -priority and the entry tick, both int32), its preemption
victim one over two int32 keys (priority, -start tick); both go through
the ``sched_select`` kernel on CUDA tensors.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from ..kernels.sched_select import masked_lex_argmin
from ..kernels.state_update.ref import first_true
from .params import SimParams
from .policy import DEFAULT_POINTS, PolicyParams
from .state import SimState, Workload
from .types import ContainerStatus, PipeStatus

EPS = 1e-5
_F32 = torch.float32


class SchedDecision(NamedTuple):
    suspend: torch.Tensor      # [F, MC] bool containers to preempt
    reject: torch.Tensor       # [F, MP] bool pipelines failed back to the user
    assign_pipe: torch.Tensor  # [F, K] int32 (-1 = unused row)
    assign_pool: torch.Tensor  # [F, K] int32
    assign_cpus: torch.Tensor  # [F, K] f32
    assign_ram: torch.Tensor   # [F, K] f32


def empty_decision(params: SimParams, F: int, device) -> SchedDecision:
    K = params.max_assignments_per_tick
    return SchedDecision(
        suspend=torch.zeros((F, params.max_containers), dtype=torch.bool, device=device),
        reject=torch.zeros((F, params.max_pipelines), dtype=torch.bool, device=device),
        assign_pipe=torch.full((F, K), -1, dtype=torch.int32, device=device),
        assign_pool=torch.zeros((F, K), dtype=torch.int32, device=device),
        assign_cpus=torch.zeros((F, K), dtype=_F32, device=device),
        assign_ram=torch.zeros((F, K), dtype=_F32, device=device),
    )


def take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[f, idx[f]]`` for every lane: ``[F, N]`` by ``[F]`` -> ``[F]``."""
    return torch.gather(x, 1, idx.long()[:, None])[:, 0]


def onehot_set(arr: torch.Tensor, idx: torch.Tensor, val) -> torch.Tensor:
    """``arr[f, idx[f]] = val[f]`` as an elementwise select (``[F, N]``)."""
    iota = torch.arange(arr.shape[-1], dtype=torch.int32, device=arr.device)
    val = val[:, None] if isinstance(val, torch.Tensor) else val
    return torch.where(iota == idx[:, None], val, arr)


def onehot_add(arr: torch.Tensor, idx: torch.Tensor, val: torch.Tensor) -> torch.Tensor:
    """``arr[f, idx[f]] += val[f]`` as an elementwise select: the one
    selected element is the single ``arr + val`` of a scatter-add."""
    iota = torch.arange(arr.shape[-1], dtype=torch.int32, device=arr.device)
    return torch.where(iota == idx[:, None], arr + val[:, None], arr)


def argmax_first(x: torch.Tensor) -> torch.Tensor:
    """First index of the maximum along the last axis (``jnp.argmax``)."""
    return first_true(x == x.amax(-1, keepdim=True), -1)


def _where_lanes(go: torch.Tensor, new: torch.Tensor, old: torch.Tensor):
    return torch.where(go.reshape(go.shape + (1,) * (new.dim() - 1)), new, old)


def decision_loop(step, K: int, carry0: tuple, go0: torch.Tensor) -> tuple:
    """Run ``step(k, carry) -> (carry, keep_going)`` over the K decision
    slots of every lane, with each lane's early exit: a lane whose
    ``keep_going`` turned False keeps its carry frozen from then on, as a
    lane of the reference's vmapped ``while_loop`` does. The loop runs
    to the largest trip count over the lanes that start with ``go0``
    (one host read of "any lane still going" per slot)."""
    carry, go = carry0, go0
    for k in range(K):
        if not bool(go.any()):
            break
        new, keep_going = step(k, carry)
        carry = tuple(_where_lanes(go, n, o) for n, o in zip(new, carry))
        go = go & keep_going
    return carry


def _pool_select(pol: PolicyParams, free_cpu, free_ram, sim: SimState, pipe_c):
    """Knob-driven pool choice: pool 0, or (``multi_pool``) the most-free
    score with the locality bonus where the pipeline has cached data and
    (``cache_pin``) the best caching pool when one exists."""
    F = free_cpu.shape[0]
    if not pol.multi_pool > 0.5:
        return torch.zeros((F,), dtype=torch.int32, device=free_cpu.device)
    score = free_cpu / sim.pool_cpu_cap.clamp_min(EPS) + (
        free_ram / sim.pool_ram_cap.clamp_min(EPS)
    )
    row = torch.gather(
        sim.cache_bytes, 2,
        pipe_c.long()[:, None, None].expand(F, sim.cache_bytes.shape[1], 1),
    )[..., 0]                                                   # [F, NP]
    bonus = torch.where(row > 0, pol.locality_bonus, 0.0)
    pool = argmax_first(score + bonus)
    if pol.cache_pin > 0.5:
        pool = torch.where(row.amax(-1) > 0, argmax_first(row), pool)
    return pool.to(torch.int32)


def policy_family(point: PolicyParams) -> Callable:
    """The parameterised scheduler at a static policy point.

    Knob values are taken as float32, as the reference bakes them in;
    the boolean knobs are static, so a disabled path (preemption off,
    pool choice off) is skipped rather than computed and discarded,
    which leaves every decision unchanged."""
    pol = PolicyParams(*(float(np.float32(v)) for v in point))
    preempt_on = pol.preempt > 0.5
    excl_on = pol.exclusive > 0.5
    grab_on = pol.grab_all > 0.5
    gate_on = pol.ram_gate > 0.5
    multi_pool = pol.multi_pool > 0.5

    def scheduler(sim: SimState, wl: Workload, params: SimParams,
                  active: torch.Tensor) -> SchedDecision:
        F = sim.tick.shape[0]
        dev = sim.tick.device
        K = params.max_assignments_per_tick
        total_cpu = sim.pool_cpu_cap.sum(-1)
        total_ram = sim.pool_ram_cap.sum(-1)
        chunk_cpu = pol.chunk_frac * total_cpu
        chunk_ram = pol.chunk_frac * total_ram
        cap_cpu = pol.cap_frac * total_cpu
        cap_ram = pol.cap_frac * total_ram

        dec = empty_decision(params, F, dev)
        live0 = sim.ctr_status == int(ContainerStatus.RUNNING)
        idle0 = ~live0.any(-1)
        waiting0 = sim.pipe_status == int(PipeStatus.WAITING)
        reject = waiting0 & sim.pipe_fail_flag
        if gate_on:
            reject = reject & (sim.pipe_last_ram >= (cap_ram - EPS)[:, None])
        dec = dec._replace(reject=reject)

        prio_f = wl.prio.to(_F32)
        lead = (
            pol.size_weight * wl.n_ops.to(_F32)
            + pol.age_weight * sim.pipe_entered.to(_F32)
            - pol.prio_weight * prio_f
        )
        head_keys = (lead, -wl.prio, sim.pipe_entered)
        victim_keys = (sim.ctr_prio, -sim.ctr_start)
        ctr_prio_f = sim.ctr_prio.to(_F32)
        base_mask = waiting0 & ~reject

        def step(k, carry):
            (suspend, a_pipe, a_pool, a_cpus, a_ram,
             free_cpu, free_ram, live, tried, assigned) = carry
            pipe = masked_lex_argmin(base_mask & ~tried, head_keys)
            valid = pipe >= 0
            pipe_c = pipe.clamp_min(0)

            failed = take(sim.pipe_fail_flag, pipe_c)
            last_cpus = take(sim.pipe_last_cpus, pipe_c)
            last_ram = take(sim.pipe_last_ram, pipe_c)
            seen = last_ram > 0.0
            want_cpu = torch.where(
                failed, torch.minimum(pol.retry_mult * last_cpus, cap_cpu),
                torch.where(seen, last_cpus, chunk_cpu),
            )
            want_ram = torch.where(
                failed, torch.minimum(pol.retry_mult * last_ram, cap_ram),
                torch.where(seen, last_ram, chunk_ram),
            )
            pool = _pool_select(pol, free_cpu, free_ram, sim, pipe_c)
            if grab_on:
                want_cpu = take(sim.pool_cpu_cap, pool)
                want_ram = take(sim.pool_ram_cap, pool)
            fits = (take(free_cpu, pool) >= want_cpu - EPS) & (
                take(free_ram, pool) >= want_ram - EPS
            )

            if preempt_on:
                pipe_prio_f = take(prio_f, pipe_c)
                can_preempt = valid & ~fits & (pipe_prio_f > pol.preempt_min_prio)
                victim = masked_lex_argmin(
                    live & (ctr_prio_f < (pipe_prio_f - pol.victim_prio_gap)[:, None]),
                    victim_keys,
                )
                has_victim = can_preempt & (victim >= 0)
                victim_c = victim.clamp_min(0)
                vpool = take(sim.ctr_pool, victim_c)
                hv = has_victim[:, None]
                free_cpu2 = torch.where(
                    hv, onehot_add(free_cpu, vpool, take(sim.ctr_cpus, victim_c)), free_cpu
                )
                free_ram2 = torch.where(
                    hv, onehot_add(free_ram, vpool, take(sim.ctr_ram, victim_c)), free_ram
                )
                live2 = torch.where(hv, onehot_set(live, victim_c, False), live)
                if multi_pool:
                    pool2 = torch.where(
                        has_victim, vpool,
                        _pool_select(pol, free_cpu2, free_ram2, sim, pipe_c),
                    )
                else:
                    pool2 = pool
                fits2 = (take(free_cpu2, pool2) >= want_cpu - EPS) & (
                    take(free_ram2, pool2) >= want_ram - EPS
                )
                do_norm = valid & (fits | (has_victim & fits2))
                use_pool = torch.where(fits, pool, pool2)
                commit = has_victim & ~fits & fits2
                cv = commit[:, None]
                suspend = torch.where(cv, onehot_set(suspend, victim_c, True), suspend)
                free_cpu = torch.where(cv, free_cpu2, free_cpu)
                free_ram = torch.where(cv, free_ram2, free_ram)
                live = torch.where(cv, live2, live)
            else:
                do_norm = valid & fits
                use_pool = pool
            do = (valid & idle0 & ~assigned) if excl_on else do_norm

            dv = do[:, None]
            free_cpu = torch.where(dv, onehot_add(free_cpu, use_pool, -want_cpu), free_cpu)
            free_ram = torch.where(dv, onehot_add(free_ram, use_pool, -want_ram), free_ram)
            a_pipe, a_pool = a_pipe.clone(), a_pool.clone()
            a_cpus, a_ram = a_cpus.clone(), a_ram.clone()
            a_pipe[:, k] = torch.where(do, pipe_c, -1)
            a_pool[:, k] = use_pool
            a_cpus[:, k] = want_cpu
            a_ram[:, k] = want_ram
            assigned = assigned | do
            tried = torch.where(valid[:, None], onehot_set(tried, pipe_c, True), tried)
            return (suspend, a_pipe, a_pool, a_cpus, a_ram,
                    free_cpu, free_ram, live, tried, assigned), valid

        carry0 = (
            dec.suspend, dec.assign_pipe, dec.assign_pool, dec.assign_cpus,
            dec.assign_ram, sim.pool_cpu_free, sim.pool_ram_free, live0,
            torch.zeros_like(waiting0), torch.zeros_like(idle0),
        )
        suspend, a_pipe, a_pool, a_cpus, a_ram, *_ = decision_loop(
            step, K, carry0, active
        )
        return dec._replace(
            suspend=suspend, assign_pipe=a_pipe, assign_pool=a_pool,
            assign_cpus=a_cpus, assign_ram=a_ram,
        )

    return scheduler


# ---------------------------------------------------------------------------
# Registry: the schedulers this slice ports, each at its policy point.
# ---------------------------------------------------------------------------
SCHEDULERS = {
    key: policy_family(DEFAULT_POINTS[key])
    for key in ("naive", "priority", "priority_pool")
}
# registered in the reference, brought by ROADMAP queue 1 item 9
_LATER = ("sjf", "cache_aware", "locality_pool", "policy")


def get_scheduler(key: str) -> Callable:
    k = key.replace("-", "_").lower()
    if k in SCHEDULERS:
        return SCHEDULERS[k]
    if k in _LATER or k.endswith("_ref"):
        raise NotImplementedError(
            f"scheduler {key!r} waits for ROADMAP queue 1, item 9 (the other "
            f"schedulers); ported: {sorted(SCHEDULERS)}"
        )
    raise KeyError(f"unknown scheduler {key!r}; ported: {sorted(SCHEDULERS)}")


def mask_down_pools(sim: SimState, tick: torch.Tensor) -> SimState:
    """The scheduler's view of ``sim`` with the free capacity of every
    down pool (``tick < pool_down_until``) zeroed: free-resource-driven
    schedulers then place elsewhere. The committed state keeps the true
    free counts; schedulers that size by caps (``naive``) are caught by
    the engine's decision filter."""
    down = tick[:, None] < sim.pool_down_until
    return sim._replace(
        pool_cpu_free=torch.where(down, 0.0, sim.pool_cpu_free),
        pool_ram_free=torch.where(down, 0.0, sim.pool_ram_free),
    )


__all__ = [
    "EPS",
    "SchedDecision",
    "SCHEDULERS",
    "argmax_first",
    "decision_loop",
    "empty_decision",
    "get_scheduler",
    "mask_down_pools",
    "onehot_add",
    "onehot_set",
    "policy_family",
    "take",
]
