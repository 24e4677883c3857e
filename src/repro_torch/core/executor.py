"""Executor (paper §3.2.2): the state transitions of one event, lane-major.

Order inside an event: phase 1 (arrivals, suspension releases,
completions and OOMs, from the ``fleet_tick`` masks and the
``retire_land`` landing) -> scheduler -> :func:`apply_decision`
(suspensions, rejections, assignments landed by ``assign_gather``) ->
:func:`integrate` (utilisation and cost over the jump to the next
event). Every function maps a fleet ``[F, ...]`` to a fleet.

This slice runs with the optional layers at their zero defaults: no
timeout, no cold start, no cache or scan cost. The transitions keep the
warm-slot bookkeeping and the data-plane counters the reference keeps
with those knobs at zero (``cold_starts``, ``warm_starts``,
``cache_lookups``, ``bytes_moved_gb``).
"""
from __future__ import annotations

import numpy as np
import torch

from ..kernels.fold import ordered_sum
from ..kernels.state_update import assign_gather, retire_land
from ..kernels.state_update.ref import first_true
from .params import SimParams
from .scheduler import SchedDecision
from .state import SimState, Workload, container_schedule, seconds, used_resources
from .types import INF_TICK, ContainerStatus, PipeStatus

_I32, _F32 = torch.int32, torch.float32
RUNNING = int(ContainerStatus.RUNNING)
C_EMPTY = int(ContainerStatus.EMPTY)
WAITING = int(PipeStatus.WAITING)


def _warm_until(tick: torch.Tensor, params: SimParams) -> torch.Tensor:
    """Warmth expiry tick, saturated at INF_TICK (int32-safe)."""
    window = min(int(params.container_warm_ticks), INF_TICK)
    return tick + torch.clamp_max(INF_TICK - tick, window)


def _col(x: torch.Tensor) -> torch.Tensor:
    return x[:, None]


def apply_fused_phase1(
    state: SimState, wl: Workload, tick: torch.Tensor, params: SimParams, ph
) -> SimState:
    """Apply the ``fleet_tick`` masks ``ph``: arrivals, releases and
    retirements, each field written once with its selects chained in
    that order. The retirements land on the pipeline axis through
    ``retire_land``."""
    (oomed, done, _new_status, freed_cpu, freed_ram,
     fresh, rel, nxt_retire, nxt_release) = ph
    retired = oomed | done
    (oom_hit, done_hit, _timed_hit, end_of, _wasted,
     lat_sum, lat_prio, dprio, n_done, n_oom) = retire_land(
        state.ctr_pipe, state.ctr_end, state.ctr_start, oomed, done, None,
        wl.arrival, wl.prio, tick,
    )
    t = _col(tick)
    pipe_status = torch.where(fresh, WAITING, state.pipe_status)
    pipe_entered = torch.where(fresh, wl.arrival, state.pipe_entered)
    pipe_status = torch.where(rel, WAITING, pipe_status)
    pipe_entered = torch.where(rel, state.pipe_release, pipe_entered)
    pipe_release = torch.where(rel, INF_TICK, state.pipe_release)
    pipe_status = torch.where(
        oom_hit, WAITING,
        torch.where(done_hit, int(PipeStatus.DONE), pipe_status),
    )
    pipe_entered = torch.where(oom_hit, t, pipe_entered)

    return state._replace(
        nxt_retire=nxt_retire,
        nxt_release=nxt_release,
        pipe_status=pipe_status,
        pipe_entered=pipe_entered,
        pipe_release=pipe_release,
        pipe_fail_flag=state.pipe_fail_flag | oom_hit,
        pipe_fails=state.pipe_fails + oom_hit.to(_I32),
        pipe_completion=torch.where(done_hit, end_of, state.pipe_completion),
        ctr_status=torch.where(retired, C_EMPTY, state.ctr_status),
        ctr_pipe=torch.where(retired, -1, state.ctr_pipe),
        ctr_end=torch.where(retired, INF_TICK, state.ctr_end),
        ctr_oom=torch.where(retired, INF_TICK, state.ctr_oom),
        ctr_start=torch.where(retired, INF_TICK, state.ctr_start),
        ctr_prio=torch.where(retired, -1, state.ctr_prio),
        # retired containers keep their slot warm on their pool a while
        ctr_warm=state.ctr_warm & ~retired,
        slot_warm_pool=torch.where(retired, state.ctr_pool, state.slot_warm_pool),
        slot_warm_until=torch.where(
            retired, _col(_warm_until(tick, params)), state.slot_warm_until
        ),
        pool_cpu_free=state.pool_cpu_free + freed_cpu,
        pool_ram_free=state.pool_ram_free + freed_ram,
        done_count=state.done_count + n_done,
        oom_events=state.oom_events + n_oom,
        sum_latency_s=state.sum_latency_s + lat_sum,
        sum_latency_s_prio=state.sum_latency_s_prio + lat_prio,
        done_prio=state.done_prio + dprio,
    )


def apply_decision(
    state: SimState, wl: Workload, dec: SchedDecision, tick: torch.Tensor,
    params: SimParams,
) -> SimState:
    """Apply one decision per lane: suspensions, then rejections, then
    the assignments (:func:`_apply_assignments_fused`)."""
    MP = params.max_pipelines
    NP = params.num_pools
    dev = tick.device
    t = _col(tick)

    # ---- 1. suspensions (preemptions) --------------------------------------
    running = state.ctr_status == RUNNING
    susp = dec.suspend & running
    pools = torch.arange(NP, dtype=_I32, device=dev)
    pool_oh = (state.ctr_pool[:, None, :] == pools[:, None]) & susp[:, None, :]
    freed_cpu = ordered_sum(state.ctr_cpus, pool_oh)
    freed_ram = ordered_sum(state.ctr_ram, pool_oh)
    pid = torch.where(susp, state.ctr_pipe, MP)
    susp_hit = (
        pid[:, :, None] == torch.arange(MP, dtype=_I32, device=dev)
    ).any(1)

    still = running & ~susp
    nxt_retire = torch.where(
        still, torch.minimum(state.ctr_end, state.ctr_oom), INF_TICK
    ).amin(-1)
    nxt_release = torch.where(
        susp.any(-1), torch.minimum(state.nxt_release, tick + 1),
        state.nxt_release,
    )
    state = state._replace(
        nxt_retire=nxt_retire,
        nxt_release=nxt_release,
        pipe_status=torch.where(susp_hit, int(PipeStatus.SUSPENDED), state.pipe_status),
        pipe_release=torch.where(susp_hit, t + 1, state.pipe_release),
        pipe_preempts=state.pipe_preempts + susp_hit.to(_I32),
        ctr_status=torch.where(susp, C_EMPTY, state.ctr_status),
        ctr_pipe=torch.where(susp, -1, state.ctr_pipe),
        ctr_end=torch.where(susp, INF_TICK, state.ctr_end),
        ctr_oom=torch.where(susp, INF_TICK, state.ctr_oom),
        ctr_start=torch.where(susp, INF_TICK, state.ctr_start),
        ctr_prio=torch.where(susp, -1, state.ctr_prio),
        ctr_warm=state.ctr_warm & ~susp,
        slot_warm_pool=torch.where(susp, state.ctr_pool, state.slot_warm_pool),
        slot_warm_until=torch.where(
            susp, _col(_warm_until(tick, params)), state.slot_warm_until
        ),
        pool_cpu_free=state.pool_cpu_free + freed_cpu,
        pool_ram_free=state.pool_ram_free + freed_ram,
        preempt_events=state.preempt_events + susp.sum(-1, dtype=_I32),
    )

    # ---- 2. rejections (failures returned to the user) ---------------------
    rej = dec.reject & (state.pipe_status == WAITING)
    state = state._replace(
        pipe_status=torch.where(rej, int(PipeStatus.FAILED), state.pipe_status),
        pipe_completion=torch.where(rej, t, state.pipe_completion),
        failed_count=state.failed_count + rej.sum(-1, dtype=_I32),
    )

    # ---- 3. assignments ----------------------------------------------------
    return _apply_assignments_fused(state, wl, dec, tick, params)


def _apply_assignments_fused(
    state: SimState, wl: Workload, dec: SchedDecision, tick: torch.Tensor,
    params: SimParams,
) -> SimState:
    """The assignment rows of a decision, landed through ``assign_gather``.

    * A row commits iff it is the first row of its pipeline, the pipeline
      was waiting, and its rank among such rows is within the number of
      empty slots.
    * The rank-r valid row takes the r-th lowest empty slot.
    * The order-sensitive f32 accumulators (pool frees, bytes moved) keep
      the reference's left fold over the rows in ascending order; the
      loop runs to the largest populated row over the lanes, and rows
      past a lane's own last populated row are never valid, so they
      change nothing.
    """
    MC = state.ctr_status.shape[-1]
    MP = state.pipe_status.shape[-1]
    NP = params.num_pools
    K = params.max_assignments_per_tick
    dev = tick.device
    t = _col(tick)
    ks = torch.arange(K, dtype=_I32, device=dev)

    pipe = dec.assign_pipe
    pipe_c = pipe.clamp_min(0)
    pool = dec.assign_pool
    cpus = dec.assign_cpus
    ram = dec.assign_ram
    populated = pipe >= 0

    waiting0 = state.pipe_status == WAITING
    empty0 = state.ctr_status == C_EMPTY
    n_empty = empty0.sum(-1, dtype=_I32)

    # -- closed-form validity ------------------------------------------------
    dup_before = (
        (pipe[:, None, :] == pipe[:, :, None]) & (ks[None, :] < ks[:, None])
    ).any(-1)
    pre = populated & torch.gather(waiting0, 1, pipe_c.long()) & ~dup_before
    rank = torch.cumsum(pre, -1, dtype=_I32)
    valid = pre & (rank <= _col(n_empty))

    # -- slot pick: the rank-r row lands on the r-th lowest empty slot --------
    cum = torch.cumsum(empty0, -1, dtype=_I32)
    eq = empty0[:, None, :] & (cum[:, None, :] == rank[:, :, None])
    slot_l = first_true(eq, -1)
    slot = slot_l.to(_I32)

    is_warm = (torch.gather(state.slot_warm_pool, 1, slot_l) == pool) & (
        t < torch.gather(state.slot_warm_until, 1, slot_l)
    )
    # with the cache off every pool caches nothing: no hit, and the whole
    # intermediate output is scanned (the reference's min(cached, out)
    # and max(out - cached, 0) at cached = 0)
    total_out = torch.gather(wl.pipe_out, 1, pipe_c.long())
    miss_gb = total_out

    # -- sequential walk over the populated rows -----------------------------
    pcf, prf = state.pool_cpu_free, state.pool_ram_free
    bmg = state.bytes_moved_gb
    pools = torch.arange(NP, dtype=_I32, device=dev)
    n_rows = int((torch.where(populated, ks + 1, 0)).amax()) if K else 0
    for k in range(n_rows):
        v = valid[:, k]
        vp = _col(v) & (pools == pool[:, k:k + 1])
        pcf = torch.where(vp, pcf - cpus[:, k:k + 1], pcf)
        prf = torch.where(vp, prf - ram[:, k:k + 1], prf)
        bmg = torch.where(v, bmg + miss_gb[:, k], bmg)
    dur, oom_off = container_schedule(wl, pipe_c, cpus, ram)

    # -- row timing (no cold start, no scan cost, no timeout) ----------------
    end = t + dur
    oom = torch.where(oom_off == INF_TICK, INF_TICK, t + torch.minimum(oom_off, dur))
    nxt_retire = torch.minimum(
        state.nxt_retire,
        torch.where(valid, torch.minimum(end, oom), INF_TICK).amin(-1),
    )
    n_look = (valid & (total_out > 0)).sum(-1, dtype=_I32)
    n_warm = (valid & is_warm).sum(-1, dtype=_I32)
    n_cold = (valid & ~is_warm).sum(-1, dtype=_I32)

    # -- fused landing (kernels/state_update) --------------------------------
    prio = torch.gather(wl.prio, 1, pipe_c.long())
    (hit_c, l_pipe, l_pool, l_cpus, l_ram, l_end, l_oom, l_prio, l_warm,
     _l_timed, hit_p, l_pcpus, l_pram) = assign_gather(
        valid, slot, pipe_c, pool, cpus, ram, end, oom, prio, is_warm,
        torch.zeros_like(valid), max_containers=MC, max_pipelines=MP,
    )
    return state._replace(
        nxt_retire=nxt_retire,
        pipe_status=torch.where(hit_p, int(PipeStatus.RUNNING), state.pipe_status),
        pipe_last_cpus=torch.where(hit_p, l_pcpus, state.pipe_last_cpus),
        pipe_last_ram=torch.where(hit_p, l_pram, state.pipe_last_ram),
        pipe_fail_flag=state.pipe_fail_flag & ~hit_p,
        pipe_first_start=torch.where(
            hit_p, torch.minimum(state.pipe_first_start, t), state.pipe_first_start
        ),
        ctr_status=torch.where(hit_c, RUNNING, state.ctr_status),
        ctr_pipe=torch.where(hit_c, l_pipe, state.ctr_pipe),
        ctr_pool=torch.where(hit_c, l_pool, state.ctr_pool),
        ctr_cpus=torch.where(hit_c, l_cpus, state.ctr_cpus),
        ctr_ram=torch.where(hit_c, l_ram, state.ctr_ram),
        ctr_start=torch.where(hit_c, t, state.ctr_start),
        ctr_end=torch.where(hit_c, l_end, state.ctr_end),
        ctr_oom=torch.where(hit_c, l_oom, state.ctr_oom),
        ctr_prio=torch.where(hit_c, l_prio, state.ctr_prio),
        ctr_warm=torch.where(hit_c, l_warm, state.ctr_warm),
        pool_cpu_free=pcf,
        pool_ram_free=prf,
        bytes_moved_gb=bmg,
        cache_lookups=state.cache_lookups + n_look,
        cold_starts=state.cold_starts + n_cold,
        warm_starts=state.warm_starts + n_warm,
    )


def bucket_edges(params: SimParams, device) -> torch.Tensor:
    """The ``util_log`` bucket edges of the reference, bit for bit:
    ``jnp.linspace(0.0, horizon, B + 1)`` in f32 is ``horizon * (i / B)``
    for ``i < B`` (each step rounded in f32) and ``horizon`` at ``i = B``."""
    B = params.util_log_buckets
    horizon = np.float32(max(params.horizon_ticks, 1))
    steps = np.arange(B, dtype=np.float32) / np.float32(B)
    edges = np.concatenate([horizon * steps, [horizon]]).astype(np.float32)
    return torch.from_numpy(edges).to(device)


def integrate(
    state: SimState, t0: torch.Tensor, t1: torch.Tensor, params: SimParams,
    edges: torch.Tensor,
) -> SimState:
    """Utilisation and cost integrals over ``[t0, t1)`` per lane, with the
    exact overlap of the interval with every ``util_log`` bucket
    (``edges`` from :func:`bucket_edges`)."""
    dt_s = seconds(t1 - t0)
    used_cpu, used_ram = used_resources(state)

    base_cpu = float(np.float32(params.pool_cpus))
    over = torch.clamp_min(used_cpu - base_cpu, 0.0)
    base_used = torch.clamp_max(used_cpu, base_cpu)
    rate = params.cloud_cost_per_cpu_second
    cost = (base_used + params.cloud_premium_factor * over).sum(-1) * rate * dt_s

    lo = torch.maximum(edges[None, :-1], _col(t0.to(_F32)))
    hi = torch.minimum(edges[None, 1:], _col(t1.to(_F32)))
    overlap_s = seconds(torch.clamp_min(hi - lo, 0.0))               # [F, B]
    add = overlap_s[:, :, None, None] * torch.stack(
        [used_cpu, used_ram], dim=-1
    )[:, None, :, :]
    return state._replace(
        util_cpu_s=state.util_cpu_s + used_cpu * _col(dt_s),
        util_ram_s=state.util_ram_s + used_ram * _col(dt_s),
        cost_dollars=state.cost_dollars + cost,
        util_log=state.util_log + add,
    )


__all__ = [
    "apply_fused_phase1",
    "apply_decision",
    "bucket_edges",
    "integrate",
]
