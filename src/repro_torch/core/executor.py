"""Executor (paper §3.2.2): the state transitions of one event, lane-major.

Order inside an event: phase 1 (arrivals, suspension releases,
completions, OOMs and timeouts, from the ``fleet_tick`` masks and the
``retire_land`` landing) -> the fault pass (:func:`apply_faults`:
crashes and outages, when either is on) -> scheduler ->
:func:`apply_decision` (suspensions, rejections, assignments landed by
``assign_gather``) -> :func:`integrate` (utilisation, cost and pool
downtime over the jump to the next event). Every function maps a fleet
``[F, ...]`` to a fleet.

The chaos layer (crashes, outages, stragglers, timeouts, retries) and
the data plane are ported. A new container pays a cold start unless it
lands on a slot kept warm on its pool, and scans the intermediate bytes
its pool's zero-copy cache does not hold; its pipeline's data then
enters that cache (LRU, ``state.cache_insert``). An outage flushes the
struck pool's cache. With the closed loop on, the fault pass also keeps
the overload layer's fault bookkeeping (``core/admission.py``).
"""
from __future__ import annotations

import numpy as np
import torch

from ..kernels.fold import ordered_sum
from ..kernels.state_update import assign_gather, retire_land
from ..kernels.state_update.ref import first_true
from .params import SimParams
from .scheduler import SchedDecision
from .state import (
    SimState,
    Workload,
    cache_insert,
    container_schedule,
    seconds,
    used_resources,
)
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
    timeout_on = params.timeout_ticks > 0
    (oom_hit, done_hit, timed_hit, end_of, timed_wasted,
     lat_sum, lat_prio, dprio, n_done, n_oom) = retire_land(
        state.ctr_pipe, state.ctr_end, state.ctr_start, oomed, done,
        state.ctr_timed if timeout_on else None, wl.arrival, wl.prio, tick,
        timeout_on=timeout_on,
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

    state = state._replace(
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
    if timeout_on:
        # a container killed at its deadline retires like a completion,
        # but its pipeline re-queues under the retry policy
        state = state._replace(
            ctr_timed=state.ctr_timed & ~retired,
            timeout_events=state.timeout_events
            + (done & state.ctr_timed).sum(-1, dtype=_I32),
            wasted_ticks=state.wasted_ticks + timed_wasted,
        )
        state = requeue_faulted(state, tick, params, timed_hit)
    return state


def backoff_ticks(base_ticks, attempt: torch.Tensor) -> torch.Tensor:
    """``min(base_ticks * 2**min(attempt, 30), 2**30)`` in f32, as int32.
    The product is exact: 2**k is built from its exponent bits (the
    reference's XLA ``exp2`` is off at odd k from 13, ROADMAP queue 3)."""
    pow2 = (attempt.clamp(0, 30) + 127).mul(1 << 23).view(_F32)
    base = torch.full((), float(np.float32(base_ticks)), dtype=_F32, device=attempt.device)
    return torch.clamp_max(base * pow2, float(2**30)).to(_I32)


def requeue_faulted(
    state: SimState, tick: torch.Tensor, params: SimParams, hit: torch.Tensor
) -> SimState:
    """The retry policy for the ``[F, MP]`` pipelines ``hit`` by a fault
    kill or a timeout: SUSPENDED until ``tick + max(backoff, 1)``, with
    ``backoff = min(base_backoff_ticks * 2**min(attempt, 30), 2**30)``
    in f32, or FAILED once ``max_retries`` attempts are spent."""
    attempt = state.pipe_retries
    exhausted = hit & (attempt >= params.max_retries)
    retry = hit & ~exhausted
    release = _col(tick) + torch.clamp_min(backoff_ticks(params.base_backoff_ticks, attempt), 1)
    nxt_release = torch.minimum(
        state.nxt_release, torch.where(retry, release, INF_TICK).amin(-1))
    return state._replace(
        pipe_status=torch.where(
            exhausted, int(PipeStatus.FAILED),
            torch.where(retry, int(PipeStatus.SUSPENDED), state.pipe_status),
        ),
        pipe_completion=torch.where(exhausted, _col(tick), state.pipe_completion),
        pipe_release=torch.where(retry, release, state.pipe_release),
        pipe_retries=state.pipe_retries + retry.to(_I32),
        failed_count=state.failed_count + exhausted.sum(-1, dtype=_I32),
        retry_events=state.retry_events + retry.sum(-1, dtype=_I32),
        nxt_release=nxt_release,
    )


def apply_faults(
    state: SimState, wl: Workload, tick: torch.Tensor, params: SimParams,
    with_aux: bool = False,
):
    """The crashes and outages of the fault trace due at ``tick``, for
    every lane; the engine runs it only when crashes or outages are on.

    * ``crash_cursor`` / ``outage_cursor`` move past the trace entries
      at or before ``tick``;
    * each due crash kills the longest-running container (start tick
      ascending, then slot ascending);
    * each due outage marks its pool down until its end tick, kills
      every container on it and cools the slots kept warm on it;
    * killed containers free their resources (in the fold order of
      ``kernels/fold.py``), their slots stay cold, and their pipelines
      re-queue through :func:`requeue_faulted`;
    * ``nxt_fault`` becomes the next crash, outage start or recovery.

    On a lane with nothing due (``tick < nxt_fault``) it changes
    nothing. ``with_aux=True`` also returns the telemetry recorder's
    ``fault_aux = (kill, kill_pipe, kill_pool, kill_cause, kill_wasted,
    down_new, up_now, pool_down_until)``, read out of the same pass
    (:func:`zero_fault_aux` is what it gives where nothing is due)."""
    ft = wl.faults
    MC = state.ctr_status.shape[-1]
    NP = state.pool_cpu_cap.shape[-1]
    MP = state.pipe_status.shape[-1]
    MF = ft.crash_time.shape[-1]
    dev = tick.device
    t = _col(tick)
    fidx = torch.arange(MF, dtype=_I32, device=dev)
    pools = torch.arange(NP, dtype=_I32, device=dev)
    running = state.ctr_status == RUNNING
    nxt_fault = torch.full_like(tick, INF_TICK)

    # ---- transient crashes -------------------------------------------------
    crash_cursor, k_due = state.crash_cursor, torch.zeros_like(tick)
    crash_kill = torch.zeros_like(running)
    if params.crash_mtbf_ticks > 0:
        crash_cursor = torch.searchsorted(ft.crash_time, t, right=True)[:, 0].to(_I32)
        k_due = crash_cursor - state.crash_cursor
        # rank the running containers by (start, slot); the k_due
        # longest-running are struck
        slots = torch.arange(MC, device=dev)
        s = state.ctr_start
        earlier = (s[:, None, :] < s[:, :, None]) | (
            (s[:, None, :] == s[:, :, None]) & (slots[None, :] < slots[:, None]))
        rank = (running[:, None, :] & earlier).sum(-1, dtype=_I32)
        crash_kill = running & (rank < _col(k_due))
        nxt_fault = torch.minimum(nxt_fault, torch.where(
            fidx >= _col(crash_cursor), ft.crash_time, INF_TICK).amin(-1))

    # ---- pool outages ------------------------------------------------------
    outage_cursor, n_due = state.outage_cursor, torch.zeros_like(tick)
    pool_down_until = state.pool_down_until
    out_kill = warm_down = torch.zeros_like(running)
    down_new = None
    if params.outage_mtbf_ticks > 0:
        outage_cursor = torch.searchsorted(ft.outage_start, t, right=True)[:, 0].to(_I32)
        due = (fidx >= _col(state.outage_cursor)) & (fidx < _col(outage_cursor))
        n_due = outage_cursor - state.outage_cursor
        pool_t = torch.where(due, ft.outage_pool, NP)                  # NP: no hit
        hit_oh = pool_t[:, :, None] == pools                           # [F, MF, NP]
        down_new = hit_oh.any(1)
        ends = torch.where(due, ft.outage_end, 0)[:, :, None]
        pool_down_until = torch.maximum(
            pool_down_until, torch.where(hit_oh, ends, 0).amax(1))
        # indices are clamped before they gather (an empty row's -1); the
        # masks around each gather decide, as in the reference
        on_down = torch.gather(down_new, 1, state.ctr_pool.clamp(0, NP - 1).long())
        out_kill = running & ~crash_kill & on_down
        # slots kept warm for a pool that goes down lose their warmth
        warm_down = (state.slot_warm_pool >= 0) & torch.gather(
            down_new, 1, state.slot_warm_pool.clamp(0, NP - 1).long())
        nxt_fault = torch.minimum(nxt_fault, torch.where(
            fidx >= _col(outage_cursor), ft.outage_start, INF_TICK).amin(-1))
        nxt_fault = torch.minimum(nxt_fault, torch.where(
            pool_down_until > t, pool_down_until, INF_TICK).amin(-1))
    kill = crash_kill | out_kill
    cold = kill | warm_down                    # a struck slot is cold too

    # ---- free the struck resources, clear the struck containers ------------
    pool_oh = (state.ctr_pool[:, None, :] == pools[:, None]) & kill[:, None, :]
    freed_cpu = ordered_sum(state.ctr_cpus, pool_oh)
    freed_ram = ordered_sum(state.ctr_ram, pool_oh)
    still = running & ~kill
    nxt_retire = torch.where(
        still, torch.minimum(state.ctr_end, state.ctr_oom), INF_TICK).amin(-1)
    pid = torch.where(kill, state.ctr_pipe, MP)                        # MP: no hit
    fault_hit = (pid[:, :, None] == torch.arange(MP, dtype=_I32, device=dev)).any(1)
    kill_wasted = torch.where(kill, t - state.ctr_start, 0)
    wasted = kill_wasted.sum(-1, dtype=_I32)
    if with_aux:
        # read before the state below changes; up_now marks the pools
        # recovering exactly now (a pool is down iff tick < pool_down_until)
        fault_aux = (
            kill,
            torch.where(kill, state.ctr_pipe, -1),
            torch.where(kill, state.ctr_pool, -1),
            torch.where(crash_kill, 0, 1).to(_I32),
            kill_wasted.to(_I32),
            torch.zeros_like(state.pool_down_until, dtype=torch.bool)
            if down_new is None else down_new,
            (state.pool_down_until > 0) & (state.pool_down_until == t),
            pool_down_until,
        )

    state = state._replace(
        ctr_status=torch.where(kill, C_EMPTY, state.ctr_status),
        ctr_pipe=torch.where(kill, -1, state.ctr_pipe),
        ctr_end=torch.where(kill, INF_TICK, state.ctr_end),
        ctr_oom=torch.where(kill, INF_TICK, state.ctr_oom),
        ctr_start=torch.where(kill, INF_TICK, state.ctr_start),
        ctr_prio=torch.where(kill, -1, state.ctr_prio),
        ctr_warm=state.ctr_warm & ~kill,
        ctr_timed=state.ctr_timed & ~kill,
        slot_warm_pool=torch.where(cold, -1, state.slot_warm_pool),
        slot_warm_until=torch.where(cold, 0, state.slot_warm_until),
        pool_cpu_free=state.pool_cpu_free + freed_cpu,
        pool_ram_free=state.pool_ram_free + freed_ram,
        nxt_retire=nxt_retire,
        pool_down_until=pool_down_until,
        crash_cursor=crash_cursor,
        outage_cursor=outage_cursor,
        nxt_fault=nxt_fault,
        crash_events=state.crash_events + k_due,
        outage_events=state.outage_events + n_due,
        fault_kills=state.fault_kills + kill.sum(-1, dtype=_I32),
        wasted_ticks=state.wasted_ticks + wasted,
    )
    if params.outage_mtbf_ticks > 0 and params.cache_gb_per_pool > 0:
        # an outage flushes the pool's zero-copy cache: recovery is cold
        state = state._replace(
            cache_bytes=torch.where(down_new[:, :, None], 0.0, state.cache_bytes),
            cache_last=torch.where(down_new[:, :, None], 0, state.cache_last),
            pool_cache_used=torch.where(down_new, 0.0, state.pool_cache_used),
        )
    if params.closed_loop_active:
        # overload bookkeeping: the last crash or outage tick, the backlog
        # at the first one, and drain detection re-armed by each (kills
        # never touch WAITING pipelines, so the backlog is the same
        # anywhere in this pass)
        fault_now = (k_due > 0) | (n_due > 0)
        backlog = (state.pipe_status == WAITING).sum(-1, dtype=_I32)
        state = state._replace(
            last_fault_tick=torch.where(fault_now, tick, state.last_fault_tick),
            prefault_backlog=torch.where(
                fault_now & (state.prefault_backlog < 0), backlog, state.prefault_backlog),
            drain_tick=torch.where(fault_now, INF_TICK, state.drain_tick),
        )
    state = requeue_faulted(state, tick, params, fault_hit)
    return (state, fault_aux) if with_aux else state


def zero_fault_aux(state: SimState):
    """The ``fault_aux`` of a fault pass with nothing due, built without
    running it: empty kill masks, causes 1 (= outage), no new outages or
    recoveries (a pool recovering at the step's tick makes the pass
    due), and ``pool_down_until`` as it is."""
    F, MC = state.ctr_status.shape
    dev = state.ctr_status.device
    none = torch.zeros((F, MC), dtype=torch.bool, device=dev)
    neg1 = torch.full((F, MC), -1, dtype=_I32, device=dev)
    no_pool = torch.zeros(state.pool_down_until.shape, dtype=torch.bool, device=dev)
    return (none, neg1, neg1, torch.ones((F, MC), dtype=_I32, device=dev),
            torch.zeros((F, MC), dtype=_I32, device=dev), no_pool, no_pool,
            state.pool_down_until)


def apply_decision(
    state: SimState, wl: Workload, dec: SchedDecision, tick: torch.Tensor,
    params: SimParams, with_aux: bool = False,
):
    """Apply one decision per lane: suspensions, then rejections, then
    the assignments (:func:`_apply_assignments_fused`).

    ``with_aux=True`` also returns the telemetry recorder's per-slot
    columns ``(aux_i [F, K, 4], aux_f [F, K, 5])``: int32 ``(pipe, pool,
    cold_ticks, is_warm)`` and f32 ``(cpus, ram, hit_gb, miss_gb,
    total_out)``, ``pipe = -1`` (and zeros) on the slots that assigned
    nothing. They are the intermediates of the commit, read out."""
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
    if params.timeout_ticks > 0:
        state = state._replace(ctr_timed=state.ctr_timed & ~susp)

    # ---- 2. rejections (failures returned to the user) ---------------------
    rej = dec.reject & (state.pipe_status == WAITING)
    state = state._replace(
        pipe_status=torch.where(rej, int(PipeStatus.FAILED), state.pipe_status),
        pipe_completion=torch.where(rej, t, state.pipe_completion),
        failed_count=state.failed_count + rej.sum(-1, dtype=_I32),
    )

    # ---- 3. assignments ----------------------------------------------------
    return _apply_assignments_fused(state, wl, dec, tick, params, with_aux)


def _apply_assignments_fused(
    state: SimState, wl: Workload, dec: SchedDecision, tick: torch.Tensor,
    params: SimParams, with_aux: bool = False,
):
    """The assignment rows of a decision, landed through ``assign_gather``.

    * A row commits iff it is the first row of its pipeline, the pipeline
      was waiting, and its rank among such rows is within the number of
      empty slots.
    * Slot pick: with cold starts off, the rank-r valid row takes the
      r-th lowest empty slot. With them on, each row takes the lowest
      empty slot kept warm for its pool, else the lowest empty slot,
      and a valid row's slot is no longer empty for the rows after it.
    * The order-sensitive state (pool frees, the cache's f32 sums and
      LRU inserts, the slot pick) is a walk over the rows in ascending
      order, each step one masked step batched over the lanes. It runs
      to the largest populated row over the lanes; rows past a lane's
      own last populated row are never valid, so they change nothing.
    """
    MC = state.ctr_status.shape[-1]
    MP = state.pipe_status.shape[-1]
    NP = params.num_pools
    K = params.max_assignments_per_tick
    cache_on = params.cache_gb_per_pool > 0
    cold_on = params.cold_start_ticks > 0
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
    total_out = torch.gather(wl.pipe_out, 1, pipe_c.long())

    # -- the walk over the populated rows ------------------------------------
    pcf, prf = state.pool_cpu_free, state.pool_ram_free
    chg, bmg = state.cache_hit_gb, state.bytes_moved_gb
    pools = torch.arange(NP, dtype=_I32, device=dev)
    n_rows = int((torch.where(populated, ks + 1, 0)).amax()) if K else 0
    if cold_on:
        empty = empty0
        warm_now = t < state.slot_warm_until
        slots = torch.arange(MC, device=dev)
        slot_l = torch.zeros(pipe.shape, dtype=torch.long, device=dev)
    if cache_on:
        cb, cl, pcu = state.cache_bytes, state.cache_last, state.pool_cache_used
        hit_gb = torch.zeros_like(cpus)
        miss_gb = torch.zeros_like(cpus)
    else:
        # every pool caches nothing: no hit, and the whole intermediate
        # output is scanned (the reference's min(cached, out) and
        # max(out - cached, 0) at cached = 0)
        hit_gb, miss_gb = None, total_out
    for k in range(n_rows):
        v = valid[:, k]
        p = pool[:, k:k + 1]
        vp = _col(v) & (pools == p)
        if cold_on:
            warm_ok = empty & (state.slot_warm_pool == p) & warm_now
            s = torch.where(warm_ok.any(-1), first_true(warm_ok, -1), first_true(empty, -1))
            empty = empty & ~(_col(v) & (slots == _col(s)))
            slot_l[:, k] = s
        if cache_on:
            pc, size = pipe_c[:, k], total_out[:, k]
            pl = p.long()[:, :, None].expand(-1, 1, MP)
            row_b = torch.gather(cb, 1, pl)[:, 0]
            row_l = torch.gather(cl, 1, pl)[:, 0]
            cached = torch.gather(row_b, 1, pc.long()[:, None])[:, 0]
            hg = torch.minimum(cached, size)
            mg = torch.clamp_min(size - cached, 0.0)
            new_b, new_l, used = cache_insert(
                row_b, row_l, torch.gather(pcu, 1, p.long())[:, 0], pc, size, tick,
                params.cache_gb_per_pool,
            )
            vp3 = vp[:, :, None]
            cb = torch.where(vp3, new_b[:, None, :], cb)
            cl = torch.where(vp3, new_l[:, None, :], cl)
            pcu = torch.where(vp, _col(used), pcu)
            hit_gb[:, k] = hg
            miss_gb[:, k] = mg
            chg = torch.where(v, chg + hg, chg)
        pcf = torch.where(vp, pcf - cpus[:, k:k + 1], pcf)
        prf = torch.where(vp, prf - ram[:, k:k + 1], prf)
        bmg = torch.where(v, bmg + miss_gb[:, k], bmg)
    if not cold_on:
        # every valid row takes the lowest remaining empty slot, so the
        # rank-r row lands on the r-th lowest empty slot
        cum = torch.cumsum(empty0, -1, dtype=_I32)
        eq = empty0[:, None, :] & (cum[:, None, :] == rank[:, :, None])
        slot_l = first_true(eq, -1)
    slot = slot_l.to(_I32)
    is_warm = (torch.gather(state.slot_warm_pool, 1, slot_l) == pool) & (
        t < torch.gather(state.slot_warm_until, 1, slot_l)
    )
    dur, oom_off = container_schedule(wl, pipe_c, cpus, ram)

    # -- row timing: a container starts after its cold start and its scan --
    start = t
    if cold_on:
        cold_ticks = torch.where(is_warm, 0, int(params.cold_start_ticks)).to(_I32)
        start = start + cold_ticks
    if params.scan_ticks_per_gb > 0:
        scan_rate = float(np.float32(params.scan_ticks_per_gb))
        start = start + torch.ceil(scan_rate * miss_gb).to(_I32)
    if params.straggler_prob > 0:
        # a straggler's factor (>= 1) stretches its duration and its OOM
        # offset alike: one f32 product each, then ceil
        factor = torch.gather(wl.faults.straggler, 1, pipe_c.long())

        def stretch(x):
            return torch.clamp_max(torch.ceil(x.to(_F32) * factor), float(2**30)).to(_I32)

        dur = stretch(dur)
        oom_off = torch.where(oom_off == INF_TICK, INF_TICK, stretch(oom_off))
    end = start + dur
    oom = torch.where(oom_off == INF_TICK, INF_TICK, start + torch.minimum(oom_off, dur))
    timed = torch.zeros_like(valid)
    if params.timeout_ticks > 0:
        # a container that would outlive its deadline is killed there, as
        # a timeout (an OOM due at the same tick wins)
        deadline = t + int(params.timeout_ticks)
        timed = end > deadline
        end = torch.minimum(end, deadline)
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
     l_timed, hit_p, l_pcpus, l_pram) = assign_gather(
        valid, slot, pipe_c, pool, cpus, ram, end, oom, prio, is_warm,
        timed, max_containers=MC, max_pipelines=MP,
    )
    state = state._replace(
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
    if cold_on:
        state = state._replace(cold_start_tick_total=state.cold_start_tick_total
                               + torch.where(valid, cold_ticks, 0).sum(-1, dtype=_I32))
    if cache_on:
        state = state._replace(
            cache_bytes=cb, cache_last=cl, pool_cache_used=pcu, cache_hit_gb=chg,
            cache_hits=state.cache_hits + (valid & (hit_gb > 0)).sum(-1, dtype=_I32),
        )
    if params.timeout_ticks > 0:
        state = state._replace(ctr_timed=torch.where(hit_c, l_timed, state.ctr_timed))
    if not with_aux:
        return state
    # with the cache off nothing hits; with cold starts off no start is cold
    zeros = torch.zeros_like(cpus)
    cold = cold_ticks if cold_on else torch.zeros_like(pipe)
    v = valid[:, :, None]
    aux_i = torch.where(
        v, torch.stack([pipe_c, pool, cold, is_warm.to(_I32)], dim=2),
        torch.tensor([-1, -1, 0, 0], dtype=_I32, device=dev))
    aux_f = torch.where(
        v, torch.stack([cpus, ram, zeros if hit_gb is None else hit_gb, miss_gb, total_out],
                       dim=2), 0.0)
    return state, (aux_i, aux_f)


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
    state = state._replace(
        util_cpu_s=state.util_cpu_s + used_cpu * _col(dt_s),
        util_ram_s=state.util_ram_s + used_ram * _col(dt_s),
        cost_dollars=state.cost_dollars + cost,
        util_log=state.util_log + add,
    )
    if params.outage_mtbf_ticks > 0:
        # the downtime integral: every recovery tick is an event, so a
        # pool down at t0 is down over the whole of [t0, t1)
        n_down = (_col(t0) < state.pool_down_until).to(_F32).sum(-1)
        state = state._replace(pool_down_s=state.pool_down_s + dt_s * n_down)
    return state


__all__ = [
    "apply_fused_phase1",
    "apply_faults",
    "apply_decision",
    "zero_fault_aux",
    "requeue_faulted",
    "backoff_ticks",
    "bucket_edges",
    "integrate",
]
