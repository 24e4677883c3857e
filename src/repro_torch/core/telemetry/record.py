"""Event recorder of the lane-major engine, over ``[F, ...]`` tensors.

One :class:`TraceBuffer` holds every lane's trace: a fixed-capacity
record table ``[F, capacity + scratch, RECORD_WIDTH]``, a write cursor
``count [F]`` and an overflow counter ``dropped [F]``. Each engine step
appends every event it caused on each active lane — arrivals,
retirements, preemptions, rejections, the scheduler's chosen-vs-runner-up
decision, container starts and their data-plane cost components, and,
with their knobs on, the chaos layer's and the closed loop's events.

The append follows the reference's layout exactly. Candidate events are
assembled column-wise over the candidate axis (every pipeline,
container and assignment slot — ``step_record_count`` entries), with the
tick and gauge columns held per lane and the kind column a constant. A
cumulative sum over the emit masks, searched for the ranks ``1..G``,
gives each block slot the index of its selected candidate; the block's
columns are gathered through those indices, and the ``[G,
RECORD_WIDTH]`` block lands with one indexed write at each lane's
cursor. Slots past a lane's selection count gather the last candidate
(the index is clamped to ``n - 1``): they are padding past ``count``.

The table carries ``G = step_block_rows(...)`` rows of tail scratch, so
a full buffer's writes land past ``capacity`` and fall off instead of
wrapping: earlier records are never overwritten, an overflowing trace
is a truncated prefix, and ``dropped`` counts what fell off (as well as
any burst past ``TRACE_STEP_EVENTS`` records in one step). Rows between
``count`` and ``capacity`` are padding, not events — hosts decode
``records[:count]`` only (:mod:`.decode` does).

The recorder only *reads* simulation state, which keeps traced runs
bit-equal to untraced ones.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from ..params import SimParams
from ..scheduler import SchedDecision, decision_provenance
from ..state import SimState, Workload
from ..types import INF_TICK, ContainerStatus, PipeStatus
from .schema import RECORD_WIDTH, TRACE_STEP_EVENTS, EventKind

_I32 = torch.int32


class TraceBuffer(NamedTuple):
    """The fleet's event tables. ``records[i, :count[i]]`` are lane
    ``i``'s valid, time-ordered rows; in the engine loop the table holds
    step-block scratch past ``capacity`` (see the module docstring)."""

    records: torch.Tensor  # [F, capacity + scratch, RECORD_WIDTH] int32
    count: torch.Tensor    # [F] int32 rows written (<= capacity)
    dropped: torch.Tensor  # [F] int32 rows lost to overflow


def step_record_count(max_pipelines: int, max_containers: int,
                      max_assignments: int,
                      params: SimParams | None = None) -> int:
    """Candidate records one engine step can emit: arrivals + rejects
    over pipelines, oom/complete/preempt over containers, one scheduler
    decision, and start/cold/hit/miss per assignment slot. With fault
    knobs on (``params`` given) the chaos-layer groups are appended:
    fault kills / timeouts over containers, pool-down/-up markers over
    pools, and retries over pipelines; with the closed loop on,
    admit-rejects, client retries and sheds over pipelines."""
    n = 2 * max_pipelines + 3 * max_containers + 1 + 4 * max_assignments
    if params is not None:
        if params.fault_events_active:
            n += max_containers                 # FAULT
        if params.timeout_ticks > 0:
            n += max_containers                 # TIMEOUT
        if params.outage_mtbf_ticks > 0:
            n += 2 * params.num_pools           # POOL_DOWN + POOL_UP
        if params.faults_active:
            n += max_pipelines                  # RETRY
        if params.closed_loop_active:
            n += 3 * max_pipelines              # ADMIT_REJECT + CLIENT_RETRY + SHED
    return n


def step_block_rows(max_pipelines: int, max_containers: int,
                    max_assignments: int,
                    params: SimParams | None = None) -> int:
    """Rows in the per-step write block (the buffer's tail scratch)."""
    return min(
        step_record_count(max_pipelines, max_containers, max_assignments,
                          params),
        TRACE_STEP_EVENTS,
    )


def init_trace_buffer(F: int, capacity: int, scratch: int = 0,
                      device="cpu") -> TraceBuffer:
    """An empty buffer of ``F`` lanes on ``device``."""
    return TraceBuffer(
        records=torch.zeros((F, capacity + scratch, RECORD_WIDTH), dtype=_I32, device=device),
        count=torch.zeros((F,), dtype=_I32, device=device),
        dropped=torch.zeros((F,), dtype=_I32, device=device),
    )


def _find_slots(pos: torch.Tensor, G: int) -> torch.Tensor:
    """Block slot ``j`` of each lane holds the j-th selected candidate:
    the first index whose running count ``pos`` (a sorted cumsum,
    ``[F, n]``) reaches ``j + 1``. Slots past the lane's selection count
    find ``n``, clamped to ``n - 1`` (padding rows, never decoded).
    Returns ``[F, G]`` int64 indices."""
    F, n = pos.shape
    targets = torch.arange(1, G + 1, dtype=pos.dtype, device=pos.device).expand(F, G)
    sel = torch.searchsorted(pos.contiguous(), targets.contiguous())
    return sel.clamp_max(n - 1)


def _f32_bits(x: torch.Tensor) -> torch.Tensor:
    """IEEE-754 bits of float32 values, as int32 (exact round-trip)."""
    return x.to(torch.float32).contiguous().view(_I32)


def _pool_total(x: torch.Tensor) -> torch.Tensor:
    """``x [F, NP]`` summed over the pools as a left fold from 0 (the
    order ``kernels/fold.py`` states for rows of up to 32 entries; with
    one or two pools every order gives the same bits)."""
    total = torch.zeros(x.shape[:-1], dtype=x.dtype, device=x.device)
    for p in range(x.shape[-1]):
        total = total + x[..., p]
    return total


@functools.lru_cache(maxsize=None)
def _kind_column(sizes: tuple, device) -> torch.Tensor:
    """The constant kind column: ``sizes`` is ``((kind, length), ...)``
    in group order. Built once a layout and device: a copy from host
    memory at every event would hold the host until the card caught up."""
    col = np.concatenate([np.full(m, int(k), np.int32) for k, m in sizes])
    return torch.from_numpy(col).to(device)


def record_step(
    tbuf: TraceBuffer,
    capacity: int,
    active: torch.Tensor,  # [F] bool — lane still running (gates all writes)
    pre: SimState,         # state at step entry (container identities)
    st1: SimState,         # after phase 1, the fault pass and the closed loop
    post: SimState,        # state after the full step (gauges)
    wl: Workload,
    params: SimParams,
    tick: torch.Tensor,    # [F] step entry tick
    ph,                    # fleet_tick's phase-1 masks
    dec: SchedDecision,
    aux,                   # (aux_i [F, K, 4], aux_f [F, K, 5]) from apply_decision
    fault_aux=None,        # the fault pass's step outputs (executor.apply_faults)
) -> TraceBuffer:
    """Append one engine step's events to every lane's trace. The record
    table is written in place; the returned buffer holds it with the
    new cursors."""
    (oomed, done, _st, _fc, _fr, fresh, _rel, _nr, _nl) = ph
    aux_i, aux_f = aux
    F, MP = wl.arrival.shape
    MC = pre.ctr_status.shape[-1]
    K = aux_i.shape[1]
    n = step_record_count(MP, MC, K, params)
    G = step_block_rows(MP, MC, K, params)
    dev = tick.device

    # step-wide gauges, sampled once per lane on the post-step state and
    # attached to every record of the step
    qdepth = (post.pipe_status == int(PipeStatus.WAITING)).sum(-1, dtype=_I32)
    free_cpu = _f32_bits(_pool_total(post.pool_cpu_free))
    free_ram = _f32_bits(_pool_total(post.pool_ram_free))
    cache_gb = _f32_bits(_pool_total(post.pool_cache_used))

    pipes = torch.arange(MP, dtype=_I32, device=dev).expand(F, MP)
    slots = torch.arange(MC, dtype=_I32, device=dev).expand(F, MC)
    neg1_mp = torch.full((F, MP), -1, dtype=_I32, device=dev)
    zeros_mp = torch.zeros((F, MP), dtype=_I32, device=dev)
    zeros_k = torch.zeros((F, K), dtype=_I32, device=dev)
    susp = dec.suspend & (st1.ctr_status == int(ContainerStatus.RUNNING))
    rej = dec.reject & (st1.pipe_status == int(PipeStatus.WAITING))
    chosen, runner = decision_provenance(st1, wl, dec)
    chosen_prio = torch.gather(wl.prio, 1, chosen.clamp_min(0).long()[:, None])
    runner_prio = torch.gather(wl.prio, 1, runner.clamp_min(0).long()[:, None])[:, 0]
    a_pipe, a_pool, a_cold, a_warm = aux_i.unbind(-1)
    a_cpus, a_ram, a_hit, a_miss, a_out = aux_f.unbind(-1)
    started = a_pipe >= 0

    # a timed-out retirement is a TIMEOUT record, not a COMPLETE
    if params.timeout_ticks > 0:
        timed = done & pre.ctr_timed
        done_c = done & ~timed
    else:
        done_c = done

    # candidate groups (the fixed within-step record order, schema.py):
    #   arrival[MP] oom[MC] complete[MC] preempt[MC] reject[MP]
    #   sched_decision[1] start[K] cold_start[K] cache_hit[K] cache_miss[K]
    # then, knob-gated: fault[MC] timeout[MC] pool_down[NP] pool_up[NP]
    #   retry[MP] admit_reject[MP] client_retry[MP] shed[MP]
    # each as (kind, mask, pipe, pool, a, b)
    groups = [
        (EventKind.ARRIVAL, fresh, pipes, neg1_mp, wl.prio, wl.arrival),
        (EventKind.OOM, oomed, pre.ctr_pipe, pre.ctr_pool, slots, pre.ctr_prio),
        (EventKind.COMPLETE, done_c, pre.ctr_pipe, pre.ctr_pool, slots, pre.ctr_prio),
        (EventKind.PREEMPT, susp, st1.ctr_pipe, st1.ctr_pool, slots, st1.ctr_prio),
        (EventKind.REJECT, rej, pipes, neg1_mp, wl.prio, zeros_mp),
        (EventKind.SCHED_DECISION, (chosen >= 0)[:, None], chosen[:, None],
         dec.assign_pool[:, :1], runner[:, None], chosen_prio),
        (EventKind.START, started, a_pipe, a_pool, _f32_bits(a_cpus), _f32_bits(a_ram)),
        (EventKind.COLD_START, started & (a_warm == 0), a_pipe, a_pool, a_cold, zeros_k),
        (EventKind.CACHE_HIT, started & (a_hit > 0), a_pipe, a_pool, _f32_bits(a_hit),
         zeros_k),
        (EventKind.CACHE_MISS, started & (a_out > 0) & (a_miss > 0), a_pipe, a_pool,
         _f32_bits(a_miss), zeros_k),
    ]
    # op is -1 everywhere except the decision record's runner-up priority
    # and the FAULT group's cause code (set by offset below)
    dec_at = 2 * MP + 3 * MC
    op_sets = [(slice(dec_at, dec_at + 1), torch.where(runner >= 0, runner_prio, -1)[:, None])]

    off = 2 * MP + 3 * MC + 1 + 4 * K
    if params.fault_events_active:
        (kill, kill_pipe, kill_pool, kill_cause, _kill_wasted,
         down_new, up_now, pool_down_until) = fault_aux
        # killed slots were RUNNING since step entry (phase 1 never
        # starts containers), so pre still holds their priority
        groups.append((EventKind.FAULT, kill, kill_pipe, kill_pool, slots, pre.ctr_prio))
        op_sets.append((slice(off, off + MC), kill_cause))
        off += MC
    if params.timeout_ticks > 0:
        groups.append((EventKind.TIMEOUT, timed, pre.ctr_pipe, pre.ctr_pool, slots,
                       pre.ctr_prio))
        off += MC
    if params.outage_mtbf_ticks > 0:
        NP = pool_down_until.shape[-1]
        pools = torch.arange(NP, dtype=_I32, device=dev).expand(F, NP)
        neg1_np = torch.full((F, NP), -1, dtype=_I32, device=dev)
        zeros_np = torch.zeros((F, NP), dtype=_I32, device=dev)
        groups += [
            (EventKind.POOL_DOWN, down_new, neg1_np, pools, pool_down_until, zeros_np),
            (EventKind.POOL_UP, up_now, neg1_np, pools, zeros_np, zeros_np),
        ]
        off += 2 * NP
    if params.faults_active:
        # retried = attempt counter bumped this step (fault kill or
        # timeout); the new count and the backoff release tick ride along
        retried = st1.pipe_retries > pre.pipe_retries
        groups.append((EventKind.RETRY, retried, pipes, neg1_mp, st1.pipe_retries,
                       st1.pipe_release))
        off += MP
    if params.closed_loop_active:
        # the closed-loop pass runs before the st1 snapshot, so its
        # transitions show up as pre -> st1 deltas: a bumped client
        # attempt counter is a CLIENT_RETRY; a fresh FAILED that never
        # started (first_start still INF) can only be an admission shed.
        client_retried = st1.pipe_client_attempts > pre.pipe_client_attempts
        shed_now = (
            (st1.pipe_status == int(PipeStatus.FAILED))
            & (pre.pipe_status != int(PipeStatus.FAILED))
            & (st1.pipe_first_start == INF_TICK)
        )
        groups += [
            (EventKind.ADMIT_REJECT, client_retried | shed_now, pipes, neg1_mp, wl.prio,
             zeros_mp),
            (EventKind.CLIENT_RETRY, client_retried, pipes, neg1_mp,
             st1.pipe_client_attempts, st1.pipe_release),
            (EventKind.SHED, shed_now, pipes, neg1_mp, wl.prio, zeros_mp),
        ]
        off += 3 * MP
    assert off == n

    def column(j):
        return torch.cat([g[j].to(_I32) for g in groups], dim=1)

    mask = torch.cat([g[1] for g in groups], dim=1) & active[:, None]
    kind_col = _kind_column(tuple((g[0], g[1].shape[1]) for g in groups), dev)
    op_col = torch.full((F, n), -1, dtype=_I32, device=dev)
    for idx, val in op_sets:
        op_col[:, idx] = val.to(_I32)

    # in-step compaction: the index of each selected candidate in its
    # ordered block slot, the block's columns gathered through it, and
    # ONE indexed write at each lane's cursor. The block's padding tail
    # overwrites only not-yet-valid rows, and a full buffer's writes land
    # in the tail scratch and fall off.
    pos = torch.cumsum(mask, dim=1, dtype=_I32)
    n_step = pos[:, -1]
    sel = _find_slots(pos, G)

    def pick(col):
        return torch.gather(col, 1, sel)

    def const(v):
        return v[:, None].expand(F, G)

    block = torch.stack([
        const(tick), kind_col[sel], pick(column(2)), pick(op_col), pick(column(3)),
        const(qdepth), const(free_cpu), const(free_ram), const(cache_gb),
        pick(column(4)), pick(column(5)),
    ], dim=2)
    assert block.shape == (F, G, RECORD_WIDTH)
    rows = (tbuf.count[:, None] + torch.arange(G, dtype=_I32, device=dev)).long()
    records = tbuf.records.scatter_(1, rows[:, :, None].expand(F, G, RECORD_WIDTH), block)
    count = torch.clamp_max(tbuf.count + torch.clamp_max(n_step, G), capacity)
    return TraceBuffer(
        records=records,
        count=count,
        dropped=tbuf.dropped + (tbuf.count + n_step - count),
    )


__all__ = [
    "TraceBuffer", "init_trace_buffer", "record_step",
    "step_record_count", "step_block_rows",
]
