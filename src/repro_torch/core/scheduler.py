"""Schedulers (paper §3.2.3, §4.1.2), lane-major.

A scheduler reads the fleet's state after phase 1 and returns one
:class:`SchedDecision` per lane: containers to preempt, pipelines to fail
back to the user, and up to K new assignments. Its signature is the
reference's with a lane axis and the mask of running lanes:
``fn(sched_state, sim, wl, params, active) -> (sched_state, decision)``.

Every named scheduler (``naive``, ``priority``, ``priority_pool``,
``cache_aware``, ``locality_pool`` and, from ``extra_schedulers``,
``sjf``) is a point of one parameterised family (:func:`policy_family`),
as in ``repro.core.scheduler``: the family at the scheduler's
``DEFAULT_POINTS`` entry. The ``"policy"`` key is the same family with
one knob vector per lane (``wl.policy``). The legacy implementations
are registered as ``*_ref`` oracles. The family's queue head is a
masked lexicographic selection over three keys (an f32 lead key, then
-priority and the entry tick, both int32), its preemption victim one
over two int32 keys (priority, -start tick); both go through the
``sched_select`` kernel on CUDA tensors.
"""
from __future__ import annotations

import functools
import warnings
from typing import Any, Callable, NamedTuple

import numpy as np
import torch

from ..kernels.sched_select import masked_lex_argmin
from ..kernels.state_update.ref import first_true
from .params import SimParams
from .policy import DEFAULT_POINTS, N_POLICY_PARAMS, PolicyParams
from .state import SimState, Workload
from .types import ContainerStatus, PipeStatus, Priority

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


# ---------------------------------------------------------------------------
# The parameterised scheduler family. A policy's knobs are f32 Python
# floats (a named scheduler's static point) or [F] f32 tensors (the
# dynamic "policy" key: one vector per lane, from ``wl.policy``). A
# switch (preemption, pool choice, cache pinning, grab-all grants,
# exclusive mode, the RAM gate) is a Python bool or an [F] bool tensor;
# the path it guards runs where some lane turns it on and is skipped
# where none does, which leaves every decision unchanged. ``_Paths``
# records that, once per point or per workload.
# ---------------------------------------------------------------------------
class _Paths(NamedTuple):
    preempt: bool
    multi_pool: bool
    cache_pin: bool
    exclusive: bool
    grab_all: bool
    ram_gate: bool


def _paths(vectors) -> _Paths:
    """The paths some lane of ``vectors`` (a ``[P]`` point or ``[F, P]``
    host array) turns on."""
    on = np.asarray(vectors, np.float32).reshape(-1, N_POLICY_PARAMS) > 0.5

    def any_on(name):
        return bool(on[:, PolicyParams._fields.index(name)].any())

    multi = any_on("multi_pool")
    return _Paths(
        preempt=any_on("preempt"), multi_pool=multi,
        cache_pin=multi and any_on("cache_pin"), exclusive=any_on("exclusive"),
        grab_all=any_on("grab_all"), ram_gate=any_on("ram_gate"),
    )


def _col(x):
    """A per-lane knob ready to broadcast against ``[F, N]``."""
    return x[:, None] if isinstance(x, torch.Tensor) else x


def _lane_where(on, a, b):
    """``a`` where the switch ``on`` holds, else ``b``: a Python bool
    picks one whole, an ``[F]`` bool tensor picks lane by lane."""
    if isinstance(on, bool):
        return a if on else b
    ref = a if isinstance(a, torch.Tensor) else b
    return torch.where(on.reshape(on.shape + (1,) * (ref.dim() - 1)), a, b)


def _gate(mask: torch.Tensor, on) -> torch.Tensor:
    """``mask`` on the lanes whose switch ``on`` holds."""
    return mask if on is True else mask & on


def _pool_select(pol: PolicyParams, paths: _Paths, free_cpu, free_ram,
                 sim: SimState, pipe_c):
    """Knob-driven pool choice: pool 0, or (``multi_pool``) the most-free
    score with the locality bonus where the pipeline has cached data and
    (``cache_pin``) the best caching pool when one exists."""
    F = free_cpu.shape[0]
    if not paths.multi_pool:
        return torch.zeros((F,), dtype=torch.int32, device=free_cpu.device)
    score = free_cpu / sim.pool_cpu_cap.clamp_min(EPS) + (
        free_ram / sim.pool_ram_cap.clamp_min(EPS)
    )
    row = torch.gather(
        sim.cache_bytes, 2,
        pipe_c.long()[:, None, None].expand(F, sim.cache_bytes.shape[1], 1),
    )[..., 0]                                                   # [F, NP]
    bonus = torch.where(row > 0, _col(pol.locality_bonus), 0.0)
    pool = argmax_first(score + bonus)
    if paths.cache_pin:
        pin = _gate(row.amax(-1) > 0, pol.cache_pin > 0.5)
        pool = torch.where(pin, argmax_first(row), pool)
    return _lane_where(pol.multi_pool > 0.5, pool, 0).to(torch.int32)


def _family_decide(pol: PolicyParams, paths: _Paths, sim: SimState,
                   wl: Workload, params: SimParams,
                   active: torch.Tensor) -> SchedDecision:
    """One decision per lane of the family at ``pol``."""
    F = sim.tick.shape[0]
    dev = sim.tick.device
    K = params.max_assignments_per_tick
    preempt_on = pol.preempt > 0.5
    excl_on = pol.exclusive > 0.5
    grab_on = pol.grab_all > 0.5
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
    # OOM fail-back: at the RAM cap already (ram_gate on), or after any
    # OOM at all (ram_gate off, the naive rule)
    reject = waiting0 & sim.pipe_fail_flag
    if paths.ram_gate:
        over_cap = sim.pipe_last_ram >= (cap_ram - EPS)[:, None]
        reject = reject & _lane_where(pol.ram_gate > 0.5, over_cap, True)
    dec = dec._replace(reject=reject)

    # three rounded f32 products, then two rounded sums, in the
    # reference's order
    prio_f = wl.prio.to(_F32)
    lead = (
        _col(pol.size_weight) * wl.n_ops.to(_F32)
        + _col(pol.age_weight) * sim.pipe_entered.to(_F32)
        - _col(pol.prio_weight) * prio_f
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
        pool = _pool_select(pol, paths, free_cpu, free_ram, sim, pipe_c)
        if paths.grab_all:
            # naive's grab-everything grant: the chosen pool's full caps
            want_cpu = _lane_where(grab_on, take(sim.pool_cpu_cap, pool), want_cpu)
            want_ram = _lane_where(grab_on, take(sim.pool_ram_cap, pool), want_ram)
        fits = (take(free_cpu, pool) >= want_cpu - EPS) & (
            take(free_ram, pool) >= want_ram - EPS
        )

        if paths.preempt:
            pipe_prio_f = take(prio_f, pipe_c)
            can_preempt = _gate(
                valid & ~fits & (pipe_prio_f > pol.preempt_min_prio), preempt_on)
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
            if paths.multi_pool:
                pool2 = _lane_where(pol.multi_pool > 0.5, torch.where(
                    has_victim, vpool,
                    _pool_select(pol, paths, free_cpu2, free_ram2, sim, pipe_c),
                ), pool)
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
        # exclusive (naive) mode: an idle cluster, one assignment, no
        # fits test (the grant is the whole pool anyway)
        do = (_lane_where(excl_on, valid & idle0 & ~assigned, do_norm)
              if paths.exclusive else do_norm)

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
    suspend, a_pipe, a_pool, a_cpus, a_ram, *_ = decision_loop(step, K, carry0, active)
    return dec._replace(
        suspend=suspend, assign_pipe=a_pipe, assign_pool=a_pool,
        assign_cpus=a_cpus, assign_ram=a_ram,
    )


def policy_family(point: PolicyParams | None) -> VectorScheduler:
    """The parameterised scheduler at a static policy point, or (``None``)
    the dynamic family that reads one vector per lane from ``wl.policy``.

    A static point's knobs are taken as f32, as the reference bakes them
    in. The dynamic family decides its paths from the host's copy of
    the vectors once per workload (one device read, when a new policy
    tensor comes in), never per event."""
    if point is not None:
        pol = PolicyParams(*(float(np.float32(v)) for v in point))
        paths = _paths(pol)

        def scheduler(sched_state, sim, wl, params, active):
            return sched_state, _family_decide(pol, paths, sim, wl, params, active)

        return scheduler

    seen: dict = {}

    def dynamic(sched_state, sim, wl, params, active):
        if wl.policy is None:
            raise ValueError(
                "scheduler 'policy' needs a workload with a policy vector "
                "attached; see sweep.attach_policies / sweep.policy_grid_workloads"
            )
        policy, paths = seen.get("last", (None, None))
        if policy is not wl.policy:
            paths = _paths(wl.policy.detach().cpu().numpy())
            seen["last"] = (wl.policy, paths)
        vec = wl.policy.to(_F32)
        pol = PolicyParams(*(vec[:, i] for i in range(N_POLICY_PARAMS)))
        return sched_state, _family_decide(pol, paths, sim, wl, params, active)

    return dynamic


def policy_family_make(point: PolicyParams | None, early_exit: bool) -> VectorScheduler:
    """Family factory for the registry: ``make(early_exit)`` with the
    policy point partially applied. The port's decision loop always
    stops each lane at its own queue's end; both variants decide alike."""
    return policy_family(point)


# ---------------------------------------------------------------------------
# The legacy implementations, registered as the ``*_ref`` oracles: the
# family at a named point must equal them bit for bit.
# ---------------------------------------------------------------------------
LOCALITY_BONUS = 1e-3


def naive_scheduler(sched_state, sim: SimState, wl: Workload, params: SimParams,
                    active: torch.Tensor):
    """One pool, everything to the queue head, only on an idle cluster;
    a pipeline that OOMed with every resource is rejected."""
    F = sim.tick.shape[0]
    dec = empty_decision(params, F, sim.tick.device)
    waiting = sim.pipe_status == int(PipeStatus.WAITING)
    reject = waiting & sim.pipe_fail_flag
    waiting = waiting & ~reject
    idle = ~(sim.ctr_status == int(ContainerStatus.RUNNING)).any(-1)
    pipe = masked_lex_argmin(waiting, (-wl.prio, sim.pipe_entered))
    do = idle & (pipe >= 0)
    a_pipe, a_pool = dec.assign_pipe.clone(), dec.assign_pool.clone()
    a_cpus, a_ram = dec.assign_cpus.clone(), dec.assign_ram.clone()
    a_pipe[:, 0] = torch.where(do, pipe, -1)
    a_pool[:, 0] = 0
    a_cpus[:, 0] = sim.pool_cpu_cap[:, 0]
    a_ram[:, 0] = sim.pool_ram_cap[:, 0]
    return sched_state, dec._replace(
        reject=reject, assign_pipe=a_pipe, assign_pool=a_pool,
        assign_cpus=a_cpus, assign_ram=a_ram,
    )


def decision_provenance(sim: SimState, wl: Workload, dec: SchedDecision):
    """``(chosen, runner_up)`` ``[F]`` pipeline ids behind each lane's
    first assignment slot — the runner-up is the pipeline the
    head-of-queue rule (priority desc, arrival asc) would have picked had
    the chosen one not been waiting. Both are -1 when not applicable.
    The telemetry recorder's SCHED_DECISION provenance; reads only,
    never part of the simulation step."""
    chosen = dec.assign_pipe[:, 0]
    waiting = sim.pipe_status == int(PipeStatus.WAITING)
    pipes = torch.arange(waiting.shape[-1], dtype=torch.int32, device=waiting.device)
    others = waiting & (pipes != chosen[:, None])
    runner = masked_lex_argmin(others, (-wl.prio, sim.pipe_entered))
    return chosen, torch.where(chosen >= 0, runner, -1)


def _legacy_pool_select(pool_mode: str, free_cpu, free_ram, sim: SimState, pipe_c):
    F = free_cpu.shape[0]
    if pool_mode == "single":
        return torch.zeros((F,), dtype=torch.int32, device=free_cpu.device)
    score = free_cpu / sim.pool_cpu_cap.clamp_min(EPS) + (
        free_ram / sim.pool_ram_cap.clamp_min(EPS)
    )
    if pool_mode == "free":
        return argmax_first(score).to(torch.int32)
    row = torch.gather(
        sim.cache_bytes, 2,
        pipe_c.long()[:, None, None].expand(F, sim.cache_bytes.shape[1], 1),
    )[..., 0]
    if pool_mode == "cache":
        return torch.where(row.amax(-1) > 0, argmax_first(row),
                           argmax_first(score)).to(torch.int32)
    if pool_mode == "locality":
        bonus = torch.where(row > 0, LOCALITY_BONUS, 0.0)
        return argmax_first(score + bonus).to(torch.int32)
    raise ValueError(f"unknown pool_mode {pool_mode!r}")


def _priority_like(pool_mode: str, early_exit: bool = False) -> VectorScheduler:
    """The legacy priority scheduler: 10 % chunks, OOM-retry doubling
    capped at 50 %, preemption of lower priorities, on the pool that
    ``pool_mode`` picks ("single", "free", "cache" or "locality")."""
    multi_pool = pool_mode != "single"

    def scheduler(sched_state, sim: SimState, wl: Workload, params: SimParams,
                  active: torch.Tensor):
        F = sim.tick.shape[0]
        K = params.max_assignments_per_tick
        total_cpu = sim.pool_cpu_cap.sum(-1)
        total_ram = sim.pool_ram_cap.sum(-1)
        chunk_cpu, chunk_ram = 0.10 * total_cpu, 0.10 * total_ram
        cap_cpu, cap_ram = 0.50 * total_cpu, 0.50 * total_ram

        dec = empty_decision(params, F, sim.tick.device)
        live0 = sim.ctr_status == int(ContainerStatus.RUNNING)
        waiting0 = sim.pipe_status == int(PipeStatus.WAITING)
        reject = waiting0 & sim.pipe_fail_flag & (sim.pipe_last_ram >= (cap_ram - EPS)[:, None])
        head_keys = (-wl.prio, sim.pipe_entered)
        victim_keys = (sim.ctr_prio, -sim.ctr_start)
        base_mask = waiting0 & ~reject

        def step(k, carry):
            suspend, a_pipe, a_pool, a_cpus, a_ram, free_cpu, free_ram, live, tried = carry
            pipe = masked_lex_argmin(base_mask & ~tried, head_keys)
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
            pool = _legacy_pool_select(pool_mode, free_cpu, free_ram, sim, pipe_c)
            fits = (take(free_cpu, pool) >= want_cpu - EPS) & (
                take(free_ram, pool) >= want_ram - EPS)

            pipe_prio = take(wl.prio, pipe_c)
            can_preempt = valid & ~fits & (pipe_prio > int(Priority.BATCH))
            victim = masked_lex_argmin(live & (sim.ctr_prio < pipe_prio[:, None]), victim_keys)
            has_victim = can_preempt & (victim >= 0)
            victim_c = victim.clamp_min(0)
            vpool = take(sim.ctr_pool, victim_c)
            hv = has_victim[:, None]
            free_cpu2 = torch.where(
                hv, onehot_add(free_cpu, vpool, take(sim.ctr_cpus, victim_c)), free_cpu)
            free_ram2 = torch.where(
                hv, onehot_add(free_ram, vpool, take(sim.ctr_ram, victim_c)), free_ram)
            live2 = torch.where(hv, onehot_set(live, victim_c, False), live)
            if multi_pool:
                pool2 = torch.where(
                    has_victim, vpool,
                    _legacy_pool_select(pool_mode, free_cpu2, free_ram2, sim, pipe_c))
            else:
                pool2 = pool
            fits2 = (take(free_cpu2, pool2) >= want_cpu - EPS) & (
                take(free_ram2, pool2) >= want_ram - EPS)

            do = valid & (fits | (has_victim & fits2))
            use_pool = torch.where(fits, pool, pool2)
            cv = (has_victim & ~fits & fits2)[:, None]
            suspend = torch.where(cv, onehot_set(suspend, victim_c, True), suspend)
            free_cpu = torch.where(cv, free_cpu2, free_cpu)
            free_ram = torch.where(cv, free_ram2, free_ram)
            live = torch.where(cv, live2, live)
            dv = do[:, None]
            free_cpu = torch.where(dv, onehot_add(free_cpu, use_pool, -want_cpu), free_cpu)
            free_ram = torch.where(dv, onehot_add(free_ram, use_pool, -want_ram), free_ram)
            a_pipe, a_pool = a_pipe.clone(), a_pool.clone()
            a_cpus, a_ram = a_cpus.clone(), a_ram.clone()
            a_pipe[:, k] = torch.where(do, pipe_c, -1)
            a_pool[:, k] = use_pool
            a_cpus[:, k] = want_cpu
            a_ram[:, k] = want_ram
            tried = torch.where(valid[:, None], onehot_set(tried, pipe_c, True), tried)
            return (suspend, a_pipe, a_pool, a_cpus, a_ram,
                    free_cpu, free_ram, live, tried), valid

        carry0 = (dec.suspend, dec.assign_pipe, dec.assign_pool, dec.assign_cpus,
                  dec.assign_ram, sim.pool_cpu_free, sim.pool_ram_free, live0,
                  torch.zeros_like(waiting0))
        suspend, a_pipe, a_pool, a_cpus, a_ram, *_ = decision_loop(step, K, carry0, active)
        return sched_state, dec._replace(
            reject=reject, suspend=suspend, assign_pipe=a_pipe, assign_pool=a_pool,
            assign_cpus=a_cpus, assign_ram=a_ram,
        )

    return scheduler


# ---------------------------------------------------------------------------
# The registry of scheduler families. A family is a factory
# ``make(early_exit: bool) -> scheduler``; a plain scheduler registers one
# function for both variants. A scheduler is lane-major:
#
#     fn(sched_state, sim: SimState, wl: Workload, params: SimParams,
#        active: [F] bool) -> (sched_state, SchedDecision)
#
# over ``[F, ...]`` tensors, ``active`` marking the lanes still running.
# ``sched_state`` starts as ``get_vector_scheduler_init(key)(params)``
# broadcast to the lanes; the engine keeps it per lane and returns it as
# ``SimResult.sched_state``. Builds are cached per (key, early_exit).
# ---------------------------------------------------------------------------
VectorScheduler = Callable[..., tuple[Any, SchedDecision]]
SchedulerFamily = Callable[[bool], VectorScheduler]

_VECTOR_FAMILIES: dict[str, SchedulerFamily] = {}
_VECTOR_INITS: dict[str, Callable[[SimParams], Any]] = {}
_BUILT: dict[tuple[str, bool], VectorScheduler] = {}
# scheduler key -> its PolicyParams point (the ``params=`` registry
# axis); the dynamic "policy" family has none
_POLICY_POINTS: dict[str, PolicyParams] = {}
# early-exit builds installed by the deprecated fleet-registry shim
_SHIM_EARLY_EXIT: dict[str, VectorScheduler] = {}


def _norm(key: str) -> str:
    return key.replace("-", "_").lower()


def _invalidate(k: str) -> None:
    _BUILT.pop((k, False), None)
    _BUILT.pop((k, True), None)
    if k in _SHIM_EARLY_EXIT:
        _BUILT[(k, True)] = _SHIM_EARLY_EXIT[k]


def register_vector_scheduler(key: str):
    """Register a plain lane-major scheduler (used for both variants)."""

    def deco(fn: VectorScheduler) -> VectorScheduler:
        k = _norm(key)
        _VECTOR_FAMILIES[k] = lambda early_exit, _fn=fn: _fn
        _invalidate(k)
        return fn

    return deco


def register_vector_scheduler_family(key: str, params: PolicyParams | None = None):
    """Register a scheduler family ``make(early_exit: bool) -> fn``. With
    ``params=`` the factory is called ``make(params, early_exit)`` (pass
    :func:`policy_family_make` to place a named scheduler at a point of
    the family) and the point is recorded for :func:`get_policy_point`."""

    def deco(make) -> SchedulerFamily:
        k = _norm(key)
        if params is not None:
            _VECTOR_FAMILIES[k] = functools.partial(make, params)
            _POLICY_POINTS[k] = params
        else:
            _VECTOR_FAMILIES[k] = make
            _POLICY_POINTS.pop(k, None)
        _invalidate(k)
        return make

    return deco


def get_policy_point(key: str) -> PolicyParams:
    """The ``PolicyParams`` point scheduler ``key`` sits at; ``KeyError``
    for schedulers registered without ``params=``."""
    k = _norm(key)
    if k not in _POLICY_POINTS:
        raise KeyError(
            f"scheduler {key!r} has no registered policy point; "
            f"pointed schedulers: {sorted(_POLICY_POINTS)}"
        )
    return _POLICY_POINTS[k]


def has_policy_point(key: str) -> bool:
    return _norm(key) in _POLICY_POINTS


def policy_points() -> dict[str, PolicyParams]:
    """Every named scheduler with a policy point."""
    return dict(_POLICY_POINTS)


def register_vector_scheduler_init(key: str):
    def deco(fn: Callable[[SimParams], Any]):
        _VECTOR_INITS[_norm(key)] = fn
        return fn

    return deco


def get_vector_scheduler(key: str, early_exit: bool = False) -> VectorScheduler:
    k = _norm(key)
    if k not in _VECTOR_FAMILIES:
        raise KeyError(
            f"unknown scheduler {key!r}; registered (ported): {sorted(_VECTOR_FAMILIES)}"
        )
    ck = (k, bool(early_exit))
    if ck not in _BUILT:
        _BUILT[ck] = _VECTOR_FAMILIES[k](bool(early_exit))
    return _BUILT[ck]


def get_vector_scheduler_init(key: str) -> Callable[[SimParams], Any]:
    return _VECTOR_INITS.get(_norm(key), lambda params: None)


def has_vector_scheduler(key: str) -> bool:
    return _norm(key) in _VECTOR_FAMILIES


def get_scheduler(key: str) -> VectorScheduler:
    """The scheduler the engine runs for ``key``."""
    return get_vector_scheduler(key, early_exit=True)


def register_fleet_vector_scheduler(key: str):
    """Deprecated: register a family with
    :func:`register_vector_scheduler_family` instead."""
    warnings.warn(
        "register_fleet_vector_scheduler is deprecated: the scheduler "
        "registries were unified — register a family with "
        "register_vector_scheduler_family(key)(make) instead",
        DeprecationWarning,
        stacklevel=2,
    )

    def deco(fn: VectorScheduler) -> VectorScheduler:
        k = _norm(key)
        # this fn is the variant the engine runs, whatever the order of
        # plain registrations
        _SHIM_EARLY_EXIT[k] = fn
        _BUILT[(k, True)] = fn
        if k not in _VECTOR_FAMILIES:
            _VECTOR_FAMILIES[k] = lambda early_exit, _fn=fn: _fn
        return fn

    return deco


def get_fleet_vector_scheduler(key: str) -> VectorScheduler:
    """Deprecated alias for ``get_vector_scheduler(key, early_exit=True)``."""
    warnings.warn(
        "get_fleet_vector_scheduler is deprecated: use "
        "get_vector_scheduler(key, early_exit=True)",
        DeprecationWarning,
        stacklevel=2,
    )
    return get_vector_scheduler(key, early_exit=True)


# the named schedulers are points of the family; the legacy
# implementations stay registered under ``*_ref`` keys as oracles (the
# sjf pair registers from extra_schedulers.py)
for _key in ("naive", "priority", "priority_pool", "cache_aware", "locality_pool"):
    register_vector_scheduler_family(_key, params=DEFAULT_POINTS[_key])(policy_family_make)
register_vector_scheduler_family("policy")(functools.partial(policy_family_make, None))
register_vector_scheduler("naive_ref")(naive_scheduler)
for _key, _mode in (("priority_ref", "single"), ("priority_pool_ref", "free"),
                    ("cache_aware_ref", "cache"), ("locality_pool_ref", "locality")):
    register_vector_scheduler_family(_key)(functools.partial(_priority_like, _mode))


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
    "LOCALITY_BONUS",
    "SchedDecision",
    "argmax_first",
    "decision_loop",
    "decision_provenance",
    "empty_decision",
    "get_fleet_vector_scheduler",
    "get_policy_point",
    "get_scheduler",
    "get_vector_scheduler",
    "get_vector_scheduler_init",
    "has_policy_point",
    "has_vector_scheduler",
    "mask_down_pools",
    "naive_scheduler",
    "onehot_add",
    "onehot_set",
    "policy_family",
    "policy_family_make",
    "policy_points",
    "register_fleet_vector_scheduler",
    "register_vector_scheduler",
    "register_vector_scheduler_family",
    "register_vector_scheduler_init",
    "take",
]
