"""Struct-of-tensors simulator state, lane-major.

The port's ``Workload`` and ``SimState`` carry the field names, dtypes
(int32 / float32 / bool) and per-lane shapes of ``repro.core.state``,
with a leading fleet axis ``[F, ...]`` on every field: a per-lane scalar
of the reference is ``[F]`` here, an ``[MP]`` column ``[F, MP]``. One
``run()`` is a fleet of one.

Capacity convention: tables are fixed-size (``max_pipelines``,
``max_ops_per_pipeline``, ``max_containers``, ``num_pools``); validity
is encoded in status columns, and ``INF_TICK`` marks "never".
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from .params import SimParams
from .types import INF_TICK, N_PRIO, TICKS_PER_SECOND, ContainerStatus, PipeStatus


class FaultTrace(NamedTuple):
    """The chaos layer's fault events of a fleet, drawn up front like the
    arrival table (``core/faults.py``). Shapes: ``[F, MF]`` (MF =
    max_fault_events) and ``[F, MP]``. Unused entries hold INF_TICK
    (times), 0 (pools) or 1.0 (stragglers), so a trace of padding is
    inert."""

    crash_time: torch.Tensor    # [F, MF] int32 sorted crash ticks (INF = unused)
    outage_start: torch.Tensor  # [F, MF] int32 sorted outage start ticks
    outage_end: torch.Tensor    # [F, MF] int32 outage recovery ticks
    outage_pool: torch.Tensor   # [F, MF] int32 struck pool per outage
    straggler: torch.Tensor     # [F, MP] f32 per-pipeline slowdown (1 = none)


class Workload(NamedTuple):
    """Arrival table of a fleet. Shapes: ``[F, MP]`` and ``[F, MP, MO]``
    (MP = max_pipelines, MO = max_ops_per_pipeline)."""

    arrival: torch.Tensor   # [F, MP] int32 arrival tick (INF_TICK = unused)
    prio: torch.Tensor      # [F, MP] int32 Priority
    n_ops: torch.Tensor     # [F, MP] int32
    op_valid: torch.Tensor  # [F, MP, MO] bool
    op_level: torch.Tensor  # [F, MP, MO] int32 topological level
    op_ram: torch.Tensor    # [F, MP, MO] f32 GB
    op_base: torch.Tensor   # [F, MP, MO] f32 runtime ticks at 1 CPU
    op_alpha: torch.Tensor  # [F, MP, MO] f32 CPU-scaling exponent
    op_out: torch.Tensor    # [F, MP, MO] f32 GB produced by each operator
    pipe_out: torch.Tensor  # [F, MP] f32 GB, Σ op_out per pipeline
    # the chaos layer's fault trace (None: no fault source)
    faults: Optional[FaultTrace] = None
    # [F, 15] f32 PolicyParams vector per lane, read by the dynamic
    # "policy" scheduler (None: named schedulers only)
    policy: Optional[torch.Tensor] = None


def workload_to(wl: Workload, device) -> Workload:
    """``wl`` on ``device``, every field contiguous (its fault trace and
    policy vectors too)."""
    return tree_map(lambda x: x.to(device).contiguous(), wl)


def workload_lane(wl: Workload, i: int) -> Workload:
    """Lane ``i`` of a fleet, lane axis dropped (per-lane shapes)."""
    return tree_map(lambda x: x[i], wl)


class SimState(NamedTuple):
    """Full dynamic state of a fleet; field comments give per-lane shapes."""

    tick: torch.Tensor               # [] int32
    # ---- pipelines ---------------------------------------------------------
    pipe_status: torch.Tensor        # [MP] int32 PipeStatus
    pipe_entered: torch.Tensor       # [MP] int32 tick it (re-)entered waiting
    pipe_fail_flag: torch.Tensor     # [MP] bool OOM-failed before
    pipe_last_cpus: torch.Tensor     # [MP] f32
    pipe_last_ram: torch.Tensor      # [MP] f32
    pipe_release: torch.Tensor       # [MP] int32 suspension release tick
    pipe_completion: torch.Tensor    # [MP] int32 (INF = not yet)
    pipe_first_start: torch.Tensor   # [MP] int32
    pipe_fails: torch.Tensor         # [MP] int32 OOM count
    pipe_preempts: torch.Tensor      # [MP] int32
    # ---- containers --------------------------------------------------------
    ctr_status: torch.Tensor         # [MC] int32 ContainerStatus
    ctr_pipe: torch.Tensor           # [MC] int32 pipeline index (-1)
    ctr_pool: torch.Tensor           # [MC] int32
    ctr_cpus: torch.Tensor           # [MC] f32
    ctr_ram: torch.Tensor            # [MC] f32
    ctr_start: torch.Tensor          # [MC] int32
    ctr_end: torch.Tensor            # [MC] int32 completion tick
    ctr_oom: torch.Tensor            # [MC] int32 OOM tick (INF = none)
    ctr_prio: torch.Tensor           # [MC] int32
    ctr_warm: torch.Tensor           # [MC] bool
    slot_warm_pool: torch.Tensor     # [MC] int32 (-1)
    slot_warm_until: torch.Tensor    # [MC] int32
    # ---- next-event registers ---------------------------------------------
    nxt_retire: torch.Tensor         # [] int32
    nxt_release: torch.Tensor        # [] int32
    nxt_arrival_cursor: torch.Tensor  # [] int32
    # ---- pools -------------------------------------------------------------
    pool_cpu_cap: torch.Tensor       # [NP] f32
    pool_ram_cap: torch.Tensor       # [NP] f32
    pool_cpu_free: torch.Tensor      # [NP] f32
    pool_ram_free: torch.Tensor      # [NP] f32
    pool_cache_used: torch.Tensor    # [NP] f32
    cache_bytes: torch.Tensor        # [NP, MP] f32
    cache_last: torch.Tensor         # [NP, MP] int32
    # ---- metrics -----------------------------------------------------------
    done_count: torch.Tensor         # [] int32
    failed_count: torch.Tensor       # [] int32
    oom_events: torch.Tensor         # [] int32
    preempt_events: torch.Tensor     # [] int32
    sum_latency_s: torch.Tensor      # [] f32
    sum_latency_s_prio: torch.Tensor  # [3] f32
    done_prio: torch.Tensor          # [3] int32
    util_cpu_s: torch.Tensor         # [NP] f32
    util_ram_s: torch.Tensor         # [NP] f32
    cost_dollars: torch.Tensor       # [] f32
    util_log: torch.Tensor           # [B, NP, 2] f32
    cache_hit_gb: torch.Tensor       # [] f32
    bytes_moved_gb: torch.Tensor     # [] f32
    cache_hits: torch.Tensor         # [] int32
    cache_lookups: torch.Tensor      # [] int32
    cold_starts: torch.Tensor        # [] int32
    warm_starts: torch.Tensor        # [] int32
    cold_start_tick_total: torch.Tensor  # [] int32
    # ---- chaos layer ---------------------------------------------------------
    pipe_retries: torch.Tensor       # [MP] int32
    ctr_timed: torch.Tensor          # [MC] bool
    pool_down_until: torch.Tensor    # [NP] int32
    crash_cursor: torch.Tensor       # [] int32
    outage_cursor: torch.Tensor      # [] int32
    nxt_fault: torch.Tensor          # [] int32
    crash_events: torch.Tensor       # [] int32
    outage_events: torch.Tensor      # [] int32
    timeout_events: torch.Tensor     # [] int32
    retry_events: torch.Tensor       # [] int32
    fault_kills: torch.Tensor        # [] int32
    wasted_ticks: torch.Tensor       # [] int32
    pool_down_s: torch.Tensor        # [] f32
    # ---- closed loop (core/admission.py; inert at their initial values
    # while every client and admission knob is off) -----------------------
    pipe_offered: torch.Tensor       # [MP] bool
    pipe_presented: torch.Tensor     # [MP] bool
    pipe_client_attempts: torch.Tensor  # [MP] int32
    offered_total: torch.Tensor      # [] int32
    offered_unique: torch.Tensor     # [] int32
    admitted_total: torch.Tensor     # [] int32
    shed_total: torch.Tensor         # [] int32
    deferred_total: torch.Tensor     # [] int32
    client_retry_events: torch.Tensor  # [] int32
    offered_prio: torch.Tensor       # [3] int32
    admitted_prio: torch.Tensor      # [3] int32
    admit_tokens: torch.Tensor       # [] f32
    admit_last_tick: torch.Tensor    # [] int32
    codel_above_since: torch.Tensor  # [] int32
    last_fault_tick: torch.Tensor    # [] int32
    prefault_backlog: torch.Tensor   # [] int32
    drain_tick: torch.Tensor         # [] int32


# the closed-loop fields, in declaration order (``repro.core.state.
# CLOSED_LOOP_FIELDS``): with the loop off a run leaves each at its
# initial value
CLOSED_LOOP_FIELDS = (
    "pipe_offered",
    "pipe_presented",
    "pipe_client_attempts",
    "offered_total",
    "offered_unique",
    "admitted_total",
    "shed_total",
    "deferred_total",
    "client_retry_events",
    "offered_prio",
    "admitted_prio",
    "admit_tokens",
    "admit_last_tick",
    "codel_above_since",
    "last_fault_tick",
    "prefault_backlog",
    "drain_tick",
)


def init_state(params: SimParams, F: int, device) -> SimState:
    """The initial state of ``F`` lanes on ``device``."""
    MP = params.max_pipelines
    MC = params.max_containers
    NP = params.num_pools
    B = params.util_log_buckets
    f32, i32, b = torch.float32, torch.int32, torch.bool

    def full(shape, value, dtype):
        return torch.full((F, *shape), value, dtype=dtype, device=device)

    def zeros(shape, dtype):
        return torch.zeros((F, *shape), dtype=dtype, device=device)

    factor = params.cloud_scale_max_factor if params.cloud_scaling else 1.0
    pool_cpu = float(torch.tensor(params.pool_cpus * factor, dtype=f32))
    pool_ram = float(torch.tensor(params.pool_ram_gb * factor, dtype=f32))
    return SimState(
        tick=zeros((), i32),
        pipe_status=full((MP,), int(PipeStatus.EMPTY), i32),
        pipe_entered=full((MP,), INF_TICK, i32),
        pipe_fail_flag=zeros((MP,), b),
        pipe_last_cpus=zeros((MP,), f32),
        pipe_last_ram=zeros((MP,), f32),
        pipe_release=full((MP,), INF_TICK, i32),
        pipe_completion=full((MP,), INF_TICK, i32),
        pipe_first_start=full((MP,), INF_TICK, i32),
        pipe_fails=zeros((MP,), i32),
        pipe_preempts=zeros((MP,), i32),
        ctr_status=full((MC,), int(ContainerStatus.EMPTY), i32),
        ctr_pipe=full((MC,), -1, i32),
        ctr_pool=zeros((MC,), i32),
        ctr_cpus=zeros((MC,), f32),
        ctr_ram=zeros((MC,), f32),
        ctr_start=full((MC,), INF_TICK, i32),
        ctr_end=full((MC,), INF_TICK, i32),
        ctr_oom=full((MC,), INF_TICK, i32),
        ctr_prio=full((MC,), -1, i32),
        ctr_warm=zeros((MC,), b),
        slot_warm_pool=full((MC,), -1, i32),
        slot_warm_until=zeros((MC,), i32),
        nxt_retire=full((), INF_TICK, i32),
        nxt_release=full((), INF_TICK, i32),
        nxt_arrival_cursor=zeros((), i32),
        pool_cpu_cap=full((NP,), pool_cpu, f32),
        pool_ram_cap=full((NP,), pool_ram, f32),
        pool_cpu_free=full((NP,), pool_cpu, f32),
        pool_ram_free=full((NP,), pool_ram, f32),
        pool_cache_used=zeros((NP,), f32),
        cache_bytes=zeros((NP, MP), f32),
        cache_last=zeros((NP, MP), i32),
        done_count=zeros((), i32),
        failed_count=zeros((), i32),
        oom_events=zeros((), i32),
        preempt_events=zeros((), i32),
        sum_latency_s=zeros((), f32),
        sum_latency_s_prio=zeros((N_PRIO,), f32),
        done_prio=zeros((N_PRIO,), i32),
        util_cpu_s=zeros((NP,), f32),
        util_ram_s=zeros((NP,), f32),
        cost_dollars=zeros((), f32),
        util_log=zeros((B, NP, 2), f32),
        cache_hit_gb=zeros((), f32),
        bytes_moved_gb=zeros((), f32),
        cache_hits=zeros((), i32),
        cache_lookups=zeros((), i32),
        cold_starts=zeros((), i32),
        warm_starts=zeros((), i32),
        cold_start_tick_total=zeros((), i32),
        pipe_retries=zeros((MP,), i32),
        ctr_timed=zeros((MC,), b),
        pool_down_until=zeros((NP,), i32),
        crash_cursor=zeros((), i32),
        outage_cursor=zeros((), i32),
        # due (0) when crashes or outages are on, so the fault pass runs
        # at the first event and sets the true register; INF_TICK otherwise
        nxt_fault=full((), 0 if params.fault_events_active else INF_TICK, i32),
        crash_events=zeros((), i32),
        outage_events=zeros((), i32),
        timeout_events=zeros((), i32),
        retry_events=zeros((), i32),
        fault_kills=zeros((), i32),
        wasted_ticks=zeros((), i32),
        pool_down_s=zeros((), f32),
        pipe_offered=zeros((MP,), b),
        pipe_presented=zeros((MP,), b),
        pipe_client_attempts=zeros((MP,), i32),
        offered_total=zeros((), i32),
        offered_unique=zeros((), i32),
        admitted_total=zeros((), i32),
        shed_total=zeros((), i32),
        deferred_total=zeros((), i32),
        client_retry_events=zeros((), i32),
        offered_prio=zeros((N_PRIO,), i32),
        admitted_prio=zeros((N_PRIO,), i32),
        admit_tokens=full((), float(params.admit_burst), f32),
        admit_last_tick=zeros((), i32),
        codel_above_since=full((), INF_TICK, i32),
        last_fault_tick=full((), INF_TICK, i32),
        prefault_backlog=full((), -1, i32),
        drain_tick=full((), INF_TICK, i32),
    )


def tree_map(fn, tree, *rest):
    """``fn`` on every leaf of ``tree`` (any nesting of named tuples,
    tuples, lists and dicts) and the matching leaves of ``rest``;
    ``None`` leaves stay ``None``."""
    if tree is None:
        return None
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, *xs) for xs in zip(tree, *rest)))
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, *xs) for xs in zip(tree, *rest))
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    return fn(tree, *rest)


def broadcast_lanes(tree, n_lanes: int):
    """Broadcast a single-lane tree (a ``SimState``, a ``Workload``, any
    nesting of named tuples, tuples, lists and dicts, ``None`` leaves
    kept) to ``n_lanes`` lane-major copies: every leaf gains a leading
    fleet axis ``[F, ...]`` as a broadcast view (``expand``)."""
    def lanes(leaf):
        x = torch.as_tensor(leaf)
        return x.expand((n_lanes,) + tuple(x.shape))

    return tree_map(lanes, tree)


# ---------------------------------------------------------------------------
# Zero-copy cache transition (data plane), one pool row per lane: the
# executor calls it once per assignment row. Every cached size lies on
# the MiB grid (``workload._op_out_gb_quantized`` and the reference's
# generator), so the f32 sums below are exact in any order while they
# stay under 2**24 MiB; ``torch.cumsum`` may then take its own order.
# ---------------------------------------------------------------------------
def cache_insert(
    row_bytes: torch.Tensor,   # [F, MP] f32 cached GB on the row's pool
    row_last: torch.Tensor,    # [F, MP] int32 last-touch ticks
    used: torch.Tensor,        # [F] f32 pool cache occupancy
    pipe: torch.Tensor,        # [F] int32 pipeline whose data is inserted
    size: torch.Tensor,        # [F] f32 dataset size (GB)
    tick: torch.Tensor,        # [F] int32 insertion tick (the new last touch)
    cap: float,                # per-pool cache capacity (GB)
):
    """Insert ``pipe``'s intermediates, evicting least recently touched
    entries first (last touch ascending, then pipe ascending) until the
    dataset fits. A dataset larger than the whole cache is never
    inserted. Returns ``(row_bytes, row_last, used)``."""
    MP = row_bytes.shape[-1]
    cap32 = float(np.float32(cap))
    p = pipe.long()[:, None]
    iota = torch.arange(MP, dtype=torch.int32, device=row_bytes.device)
    on_pipe = iota == pipe[:, None]
    cached = torch.gather(row_bytes, 1, p)[:, 0]
    fits_cache = size <= cap32
    # bytes that must be freed before the (re-)insert fits
    need = used - cached + size - cap32
    evictable = (row_bytes > 0) & ~on_pipe
    order = torch.argsort(torch.where(evictable, row_last, INF_TICK), dim=-1, stable=True)
    ev_sorted = torch.gather(evictable, 1, order)
    freed_sorted = torch.where(ev_sorted, torch.gather(row_bytes, 1, order), 0.0)
    cum = torch.cumsum(freed_sorted, -1)
    evict_sorted = ev_sorted & ((cum - freed_sorted) < need[:, None]) & (need > 0)[:, None]
    evict = torch.zeros_like(evictable).scatter(1, order, evict_sorted)
    freed_total = torch.where(evict_sorted, cum, 0.0).amax(-1)
    new_bytes = torch.where(on_pipe, size[:, None], torch.where(evict, 0.0, row_bytes))
    new_last = torch.where(on_pipe, tick[:, None], torch.where(evict, 0, row_last))
    new_used = used - freed_total - cached + size
    keep = fits_cache[:, None]
    return (
        torch.where(keep, new_bytes, row_bytes),
        torch.where(keep, new_last, row_last),
        torch.where(fits_cache, new_used, used),
    )


# ---------------------------------------------------------------------------
# Container runtime model (paper §3.2.2): at creation a container computes
# its completion and OOM ticks from its operator set and allocation. Ops
# group by topological level; same-level ops share the CPUs evenly; the
# level's RAM is the sum of its ops' RAM; the container OOMs at the start
# of the first level whose RAM exceeds the allocation.
# ---------------------------------------------------------------------------
_F32 = torch.float32


def _inv_pow(x: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    """``x ** -alpha``, correctly rounded for the exponents the generator
    draws: 1 (alpha 0), ``1 / x`` (alpha 1) and ``1 / sqrt(x)`` (alpha
    0.5, taken in f64 and rounded once more to f32).

    The reference writes ``base / x ** alpha``, and XLA rewrites that to
    ``base * x ** -alpha`` with a ``pow`` of its own, so the port takes
    the same product. IEEE ops make the CPU and the GPU agree bit for
    bit; ``torch.pow`` alone rounds differently on the two, and one ulp
    of a runtime becomes one tick after ``ceil``."""
    general = torch.pow(x, -alpha)
    rsqrt = torch.reciprocal(torch.sqrt(x.double())).to(_F32)
    return torch.where(
        alpha == 0.0, 1.0,
        torch.where(alpha == 1.0, torch.reciprocal(x),
                    torch.where(alpha == 0.5, rsqrt, general)),
    )


def container_schedule(
    wl: Workload, pipe: torch.Tensor, cpus: torch.Tensor, ram: torch.Tensor
):
    """``(duration_ticks, oom_offset_ticks)`` int32 for running pipeline
    ``pipe`` on an allocation of ``cpus`` / ``ram``, for every row of
    ``[F, K]``; ``oom_offset`` is INF_TICK when the RAM suffices.

    The per-level RAM sum is a left fold in ascending op order.
    """
    MO = wl.op_valid.shape[-1]
    idx = pipe.long()[..., None].expand(*pipe.shape, MO)   # [F, K, MO]
    valid = torch.gather(wl.op_valid, 1, idx)
    level = torch.gather(wl.op_level, 1, idx)
    ram_op = torch.gather(wl.op_ram, 1, idx)
    base = torch.gather(wl.op_base, 1, idx)
    alpha = torch.gather(wl.op_alpha, 1, idx)

    levels = torch.arange(MO, dtype=torch.int32, device=pipe.device)
    # onehot[..., l, o]: op o sits on level l
    onehot = (level[..., None, :] == levels[:, None]) & valid[..., None, :]
    width = onehot.sum(-1, dtype=torch.int32).to(_F32)        # [F, K, MO]
    has_level = width > 0
    one = torch.ones((), dtype=_F32, device=pipe.device)
    c_eff = cpus[..., None] / torch.maximum(width, one)
    c_eff = torch.maximum(c_eff, torch.full((), 1e-6, dtype=_F32, device=pipe.device))
    t_op = base * _inv_pow(torch.gather(c_eff, -1, level.long()), alpha)
    t_op = torch.where(valid, t_op, 0.0)
    t_level = torch.where(onehot, t_op[..., None, :], 0.0).amax(-1)
    t_level = torch.where(has_level, torch.ceil(torch.maximum(t_level, one)), 0.0)
    ram_level = torch.zeros_like(t_level)
    for o in range(MO):
        ram_level = ram_level + torch.where(
            onehot[..., o], ram_op[..., o:o + 1], 0.0
        )

    cum_start = torch.cumsum(t_level, -1) - t_level
    duration = torch.clamp_min(t_level.sum(-1).to(torch.int32), 1)

    oom_at = has_level & (ram_level > ram[..., None] + 1e-6)
    oom_min = torch.where(oom_at, cum_start, float("inf")).amin(-1)
    oom_offset = torch.where(
        torch.isinf(oom_min),
        INF_TICK,
        torch.clamp_min(torch.nan_to_num(oom_min, posinf=0.0).to(torch.int32), 1),
    )
    return duration, oom_offset


def used_resources(state: SimState):
    """Per-pool ``(used_cpus, used_ram)`` ``[F, NP]`` of live containers."""
    NP = state.pool_cpu_cap.shape[-1]
    live = state.ctr_status == int(ContainerStatus.RUNNING)
    pools = torch.arange(NP, dtype=torch.int32, device=live.device)
    oh = (state.ctr_pool[:, None, :] == pools[:, None]) & live[:, None, :]
    used_cpu = torch.where(oh, state.ctr_cpus[:, None, :], 0.0).sum(-1)
    used_ram = torch.where(oh, state.ctr_ram[:, None, :], 0.0).sum(-1)
    return used_cpu, used_ram


def seconds(ticks: torch.Tensor) -> torch.Tensor:
    """Ticks (int or f32) to f32 seconds, by an IEEE division. The divisor
    is a tensor on the data's device: CUDA divides by a Python scalar as
    a multiplication by its reciprocal, which can differ in the last bit
    from the division the CPU and the reference do."""
    return ticks.to(_F32) / torch.full(
        (), TICKS_PER_SECOND, dtype=_F32, device=ticks.device
    )


__all__ = [
    "CLOSED_LOOP_FIELDS",
    "FaultTrace",
    "Workload",
    "workload_to",
    "workload_lane",
    "SimState",
    "init_state",
    "broadcast_lanes",
    "cache_insert",
    "container_schedule",
    "used_resources",
    "seconds",
    "tree_map",
]
