"""Reference Python engine: the paper's exact developer experience.

This engine runs user schedulers with the paper's Listing-4 signature
(``(sch, failures, new_pipelines) -> (suspends, assignments)``) on plain
Python objects. It is event-driven but semantically identical to the
lane-major event engine (the parity suite checks builtin-for-builtin
metric equality against it), and doubles as the readable executable
specification of the simulator's semantics.

A copy of ``repro.core.engine_python``, function for function, with the
same numpy arithmetic in the same order (f32 where it takes f32). Only
the ends differ: :func:`run_python_engine` reads lane 0 of the port's
fleet-of-one workload into numpy once, wherever it lies, loops on the
host with no device traffic per event, and writes the final ``SimState``
(lane axis squeezed, as ``engine.run`` returns it) to the workload's
device once.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from .algorithm import (
    get_python_scheduler,
    get_python_scheduler_init,
    register_scheduler,
    register_scheduler_init,
)
from .params import SimParams
from .state import SimState, Workload, init_state, tree_map, workload_lane
from .types import (
    INF_TICK,
    Assignment,
    Failure,
    Operator,
    Pipeline,
    PipeStatus,
    Priority,
    Suspension,
    TICKS_PER_SECOND,
)

EPS = 1e-5


class Container:
    __slots__ = (
        "slot", "pipe", "pool", "cpus", "ram", "start", "end", "oom", "warm",
        "timed",
    )

    def __init__(self, slot, pipe, pool, cpus, ram, start, end, oom,
                 warm=False, timed=False):
        self.slot = slot
        self.pipe = pipe
        self.pool = pool
        self.cpus = cpus
        self.ram = ram
        self.start = start
        self.end = end
        self.oom = oom
        self.warm = warm  # started on a warm slot (no cold-start charge)
        self.timed = timed  # ``end`` is a timeout deadline, not completion


class Scheduler:
    """The object handed to user scheduler functions (paper Listing 4).

    Exposes the queues and pool state a policy needs; ``self.data`` is
    free storage for user state initialised by the init function.
    """

    def __init__(self, params: SimParams, pipelines: List[Pipeline]):
        self.params = params
        self.num_pools = params.num_pools
        factor = params.cloud_scale_max_factor if params.cloud_scaling else 1.0
        # all resource arithmetic is float32, bit-matching the event
        # engine (engine-equivalence property tests rely on this)
        f32 = np.float32
        self.pool_cpu_cap = np.full(params.num_pools, params.pool_cpus * factor, f32)
        self.pool_ram_cap = np.full(
            params.num_pools, params.pool_ram_gb * factor, f32
        )
        self.pool_cpu_free = self.pool_cpu_cap.copy()
        self.pool_ram_free = self.pool_ram_cap.copy()
        self.pipelines = pipelines
        self.status = {p.pid: PipeStatus.PENDING for p in pipelines}
        self.entered = {p.pid: INF_TICK for p in pipelines}
        self.running: dict[int, Container] = {}  # pid -> container
        self.data: dict = {}
        # ---- data plane: per-pool zero-copy cache + warm slots ------------
        MP, MC = params.max_pipelines, params.max_containers
        self.cache_bytes = np.zeros((params.num_pools, MP), f32)
        self.cache_last = np.zeros((params.num_pools, MP), np.int64)
        self.pool_cache_used = np.zeros((params.num_pools,), f32)
        self.slot_warm_pool = np.full((MC,), -1, np.int64)
        self.slot_warm_until = np.zeros((MC,), np.int64)

    def cached_gb(self, pool: int, pid: int) -> np.float32:
        """Bytes of ``pid``'s intermediates resident in ``pool``'s cache."""
        return self.cache_bytes[pool, pid]

    # -- queue views ------------------------------------------------------
    def waiting_pids(self) -> list[int]:
        """Waiting queue in scheduling order: priority desc, entry asc, pid.

        This sort IS the readable specification of the event
        engine's masked selection: the lane-major core picks the same
        head via ``kernels.sched_select.masked_lex_argmin`` (one
        fused lexicographic argmin over ``(-prio, entered, pid)``; the
        three-pass oracle form is
        ``kernels.sched_select.ref.select_next_pipe_ref``).
        """
        pids = [pid for pid, st in self.status.items() if st == PipeStatus.WAITING]
        pids.sort(
            key=lambda pid: (
                -int(self.pipelines[pid].priority),
                self.entered[pid],
                pid,
            )
        )
        return pids

    def pipeline(self, pid: int) -> Pipeline:
        return self.pipelines[pid]

    @property
    def total_cpus(self) -> np.float32:
        return np.sum(self.pool_cpu_cap, dtype=np.float32)

    @property
    def total_ram_gb(self) -> np.float32:
        return np.sum(self.pool_ram_cap, dtype=np.float32)


# ---------------------------------------------------------------------------
# Container runtime model: numpy mirror of state.container_schedule (f32
# math; the event engine takes ``base * x ** -alpha``, correctly rounded,
# and this ``base / x ** alpha``, so the two can part by an ulp).
# ---------------------------------------------------------------------------
def container_schedule_py(pipe: Pipeline, cpus: float, ram: float):
    f32 = np.float32
    levels: dict[int, list[Operator]] = {}
    for o in pipe.ops:
        levels.setdefault(o.level, []).append(o)
    duration = 0
    oom_offset: Optional[int] = None
    cum = f32(0.0)
    for lvl in sorted(levels):
        ops = levels[lvl]
        width = f32(len(ops))
        c_eff = max(f32(cpus) / max(width, f32(1.0)), f32(1e-6))
        t_level = f32(0.0)
        ram_level = f32(0.0)
        for o in ops:
            t_op = f32(o.base_ticks) / np.power(c_eff, f32(o.alpha), dtype=f32)
            t_level = max(t_level, f32(t_op))
            ram_level = f32(ram_level + f32(o.ram_gb))
        t_level = f32(np.ceil(max(t_level, f32(1.0))))
        if oom_offset is None and ram_level > f32(ram) + f32(1e-6):
            oom_offset = max(int(cum), 1)
        cum = f32(cum + t_level)
        duration += int(t_level)
    duration = max(duration, 1)
    if oom_offset is not None:
        oom_offset = min(oom_offset, duration)
    return duration, oom_offset


# ---------------------------------------------------------------------------
# Built-in schedulers, paper-API edition (cross-validated vs. vector ones).
# ---------------------------------------------------------------------------
@register_scheduler_init(key="naive")
def _naive_init(sch: Scheduler) -> None:
    pass


@register_scheduler(key="naive")
def _naive(sch: Scheduler, failures: List[Failure], new: List[Pipeline]):
    suspends: list[Suspension] = []
    assignments: list[Assignment] = []
    rejects = [
        pid
        for pid in sch.waiting_pids()
        if sch.pipelines[pid].failed_before
    ]
    sch.data["rejects"] = rejects
    if sch.running:
        return suspends, assignments
    for pid in sch.waiting_pids():
        if pid in rejects:
            continue
        assignments.append(
            Assignment(
                pipeline=sch.pipelines[pid],
                pool=0,
                cpus=sch.pool_cpu_cap[0],
                ram_gb=sch.pool_ram_cap[0],
            )
        )
        break
    return suspends, assignments


def _pool_select_py(pool_mode: str, free_cpu, free_ram, sch: Scheduler, pid):
    """numpy mirror of ``scheduler._pool_select`` (f32 op-for-op)."""
    if pool_mode == "single":
        return 0
    eps = np.float32(EPS)
    score = free_cpu / np.maximum(sch.pool_cpu_cap, eps) + (
        free_ram / np.maximum(sch.pool_ram_cap, eps)
    )
    if pool_mode == "free":
        return int(np.argmax(score))
    row = sch.cache_bytes[:, pid]
    if pool_mode == "cache":
        if row.max() > 0:
            return int(np.argmax(row))
        return int(np.argmax(score))
    if pool_mode == "locality":
        from .scheduler import LOCALITY_BONUS

        bonus = np.where(row > 0, np.float32(LOCALITY_BONUS), np.float32(0.0))
        return int(np.argmax(score + bonus))
    raise ValueError(f"unknown pool_mode {pool_mode!r}")


def _priority_like_py(sch: Scheduler, pool_mode: str):
    multi_pool = pool_mode != "single"
    params = sch.params
    f32 = np.float32
    K = params.max_assignments_per_tick
    total_cpu = sch.total_cpus
    total_ram = sch.total_ram_gb
    chunk_cpu, chunk_ram = f32(0.10) * total_cpu, f32(0.10) * total_ram
    cap_cpu, cap_ram = f32(0.50) * total_cpu, f32(0.50) * total_ram
    eps = f32(EPS)

    suspends: list[Suspension] = []
    assignments: list[Assignment] = []
    free_cpu = sch.pool_cpu_free.copy()
    free_ram = sch.pool_ram_free.copy()
    live = dict(sch.running)  # pid -> Container, shrinks as we preempt
    rejects = [
        pid
        for pid in sch.waiting_pids()
        if sch.pipelines[pid].failed_before
        and f32(sch.pipelines[pid].last_ram_gb) >= cap_ram - eps
    ]
    sch.data["rejects"] = rejects
    tried: set[int] = set(rejects)

    for _ in range(K):
        cands = [pid for pid in sch.waiting_pids() if pid not in tried]
        if not cands:
            break
        pid = cands[0]
        tried.add(pid)
        p = sch.pipelines[pid]
        if p.failed_before:
            want_cpu = np.minimum(f32(2.0) * f32(p.last_cpus), cap_cpu)
            want_ram = np.minimum(f32(2.0) * f32(p.last_ram_gb), cap_ram)
        elif p.last_ram_gb > 0.0:
            want_cpu, want_ram = f32(p.last_cpus), f32(p.last_ram_gb)
        else:
            want_cpu, want_ram = chunk_cpu, chunk_ram

        pool = _pool_select_py(pool_mode, free_cpu, free_ram, sch, pid)
        fits = free_cpu[pool] >= want_cpu - eps and free_ram[pool] >= want_ram - eps

        if fits:
            assignments.append(Assignment(p, pool, want_cpu, want_ram))
            free_cpu[pool] -= want_cpu
            free_ram[pool] -= want_ram
            continue

        # preemption path (high-priority arrivals only, paper §4.1.2)
        if p.priority <= Priority.BATCH:
            continue
        victims = [
            c
            for c in live.values()
            if int(sch.pipelines[c.pipe].priority) < int(p.priority)
        ]
        if not victims:
            continue
        victims.sort(
            key=lambda c: (int(sch.pipelines[c.pipe].priority), -c.start, c.slot)
        )
        v = victims[0]
        f_cpu2 = free_cpu.copy()
        f_ram2 = free_ram.copy()
        f_cpu2[v.pool] += f32(v.cpus)
        f_ram2[v.pool] += f32(v.ram)
        pool2 = v.pool if multi_pool else pool
        if f_cpu2[pool2] >= want_cpu - eps and f_ram2[pool2] >= want_ram - eps:
            suspends.append(Suspension(sch.pipelines[v.pipe]))
            del live[v.pipe]
            free_cpu, free_ram = f_cpu2, f_ram2
            assignments.append(Assignment(p, pool2, want_cpu, want_ram))
            free_cpu[pool2] -= want_cpu
            free_ram[pool2] -= want_ram
    return suspends, assignments


def _policy_like_py(sch: Scheduler, pol) -> tuple:
    """numpy mirror of the parameterised policy family
    (``scheduler._policy_family``), f32 op-for-op — the reference the
    event engine's dynamic "policy" scheduler is parity-tested against
    (tests/test_search.py). ``pol`` is a ``PolicyParams``; the knob
    semantics and association order follow the vector implementation
    exactly (lead-key composition, want sizing, preemption commit)."""
    params = sch.params
    f32 = np.float32
    K = params.max_assignments_per_tick
    total_cpu = sch.total_cpus
    total_ram = sch.total_ram_gb
    chunk_cpu = f32(pol.chunk_frac) * total_cpu
    chunk_ram = f32(pol.chunk_frac) * total_ram
    cap_cpu = f32(pol.cap_frac) * total_cpu
    cap_ram = f32(pol.cap_frac) * total_ram
    eps = f32(EPS)

    preempt_on = f32(pol.preempt) > 0.5
    excl_on = f32(pol.exclusive) > 0.5
    grab_on = f32(pol.grab_all) > 0.5
    gate_on = f32(pol.ram_gate) > 0.5
    multi_on = f32(pol.multi_pool) > 0.5
    pin_on = f32(pol.cache_pin) > 0.5
    size_w, prio_w = f32(pol.size_weight), f32(pol.prio_weight)
    age_w, loc_b = f32(pol.age_weight), f32(pol.locality_bonus)

    suspends: list[Suspension] = []
    assignments: list[Assignment] = []
    free_cpu = sch.pool_cpu_free.copy()
    free_ram = sch.pool_ram_free.copy()
    live = dict(sch.running)  # pid -> Container, shrinks as we preempt
    idle0 = not sch.running
    rejects = [
        pid
        for pid in sch.waiting_pids()
        if sch.pipelines[pid].failed_before
        and (
            not gate_on
            or f32(sch.pipelines[pid].last_ram_gb) >= cap_ram - eps
        )
    ]
    sch.data["rejects"] = rejects
    tried: set[int] = set(rejects)
    assigned = False

    def lead(pid):
        # same composition order as the vector lead key: (a + b) - c
        p = sch.pipelines[pid]
        return f32(
            f32(size_w * f32(p.num_ops))
            + f32(age_w * f32(sch.entered[pid]))
        ) - f32(prio_w * f32(int(p.priority)))

    def pool_select(f_cpu, f_ram, pid):
        score = f_cpu / np.maximum(sch.pool_cpu_cap, eps) + (
            f_ram / np.maximum(sch.pool_ram_cap, eps)
        )
        row = sch.cache_bytes[:, pid]
        bonus = np.where(row > 0, loc_b, f32(0.0))
        best = int(np.argmax(score + bonus))
        if pin_on and row.max() > 0:
            best = int(np.argmax(row))
        return best if multi_on else 0

    for _ in range(K):
        cands = [pid for pid in sch.waiting_pids() if pid not in tried]
        if not cands:
            break
        pid = min(
            cands,
            key=lambda pid: (
                lead(pid),
                -int(sch.pipelines[pid].priority),
                sch.entered[pid],
                pid,
            ),
        )
        tried.add(pid)
        p = sch.pipelines[pid]
        if p.failed_before:
            want_cpu = np.minimum(f32(pol.retry_mult) * f32(p.last_cpus), cap_cpu)
            want_ram = np.minimum(
                f32(pol.retry_mult) * f32(p.last_ram_gb), cap_ram
            )
        elif p.last_ram_gb > 0.0:
            want_cpu, want_ram = f32(p.last_cpus), f32(p.last_ram_gb)
        else:
            want_cpu, want_ram = chunk_cpu, chunk_ram

        pool = pool_select(free_cpu, free_ram, pid)
        if grab_on:
            want_cpu = sch.pool_cpu_cap[pool]
            want_ram = sch.pool_ram_cap[pool]
        fits = free_cpu[pool] >= want_cpu - eps and free_ram[pool] >= want_ram - eps

        if excl_on:
            # naive mode: idle cluster, one assignment, no fits test
            if idle0 and not assigned:
                assignments.append(Assignment(p, pool, want_cpu, want_ram))
                free_cpu[pool] -= want_cpu
                free_ram[pool] -= want_ram
                assigned = True
            continue

        if fits:
            assignments.append(Assignment(p, pool, want_cpu, want_ram))
            free_cpu[pool] -= want_cpu
            free_ram[pool] -= want_ram
            assigned = True
            continue

        # preemption path, knob-gated
        if not preempt_on or not (f32(int(p.priority)) > f32(pol.preempt_min_prio)):
            continue
        thresh = f32(int(p.priority)) - f32(pol.victim_prio_gap)
        victims = [
            c
            for c in live.values()
            if f32(int(sch.pipelines[c.pipe].priority)) < thresh
        ]
        if not victims:
            continue
        victims.sort(
            key=lambda c: (int(sch.pipelines[c.pipe].priority), -c.start, c.slot)
        )
        v = victims[0]
        f_cpu2 = free_cpu.copy()
        f_ram2 = free_ram.copy()
        f_cpu2[v.pool] += f32(v.cpus)
        f_ram2[v.pool] += f32(v.ram)
        pool2 = v.pool if multi_on else pool
        if f_cpu2[pool2] >= want_cpu - eps and f_ram2[pool2] >= want_ram - eps:
            suspends.append(Suspension(sch.pipelines[v.pipe]))
            del live[v.pipe]
            free_cpu, free_ram = f_cpu2, f_ram2
            assignments.append(Assignment(p, pool2, want_cpu, want_ram))
            free_cpu[pool2] -= want_cpu
            free_ram[pool2] -= want_ram
            assigned = True
    return suspends, assignments


@register_scheduler_init(key="policy")
def _policy_init(sch: Scheduler) -> None:
    pass


@register_scheduler(key="policy")
def _policy(sch: Scheduler, failures, new):
    vec = sch.data.get("policy")
    if vec is None:
        raise ValueError(
            "scheduler 'policy' needs a workload with a policy vector "
            "attached; see sweep.attach_policies"
        )
    from .policy import PolicyParams

    return _policy_like_py(sch, PolicyParams.from_vector(vec))


@register_scheduler_init(key="priority")
def _priority_init(sch: Scheduler) -> None:
    pass


@register_scheduler(key="priority")
def _priority(sch: Scheduler, failures, new):
    return _priority_like_py(sch, "single")


@register_scheduler_init(key="priority_pool")
def _priority_pool_init(sch: Scheduler) -> None:
    pass


@register_scheduler(key="priority_pool")
def _priority_pool(sch: Scheduler, failures, new):
    return _priority_like_py(sch, "free")


# ---------------------------------------------------------------------------
# Data-plane transitions — numpy mirrors of state.cache_insert and the
# executor's warm-slot selection (f32 math, same association order; the
# engine-equivalence suite checks bitwise agreement on cache state).
# ---------------------------------------------------------------------------
def _cache_insert_py(sch: Scheduler, pool: int, pid: int, size, tick: int,
                     cap: float) -> None:
    f32 = np.float32
    cap32 = f32(cap)
    size = f32(size)
    if not size <= cap32:  # dataset larger than the whole cache: skip
        return
    row_b = sch.cache_bytes[pool]
    row_l = sch.cache_last[pool]
    used = sch.pool_cache_used[pool]
    cached = row_b[pid]
    need = f32(f32(f32(used - cached) + size) - cap32)
    freed = f32(0.0)
    if need > 0:
        victims = sorted(
            (int(row_l[j]), j)
            for j in range(row_b.shape[0])
            if row_b[j] > 0 and j != pid
        )
        for _, j in victims:
            if not (freed < need):  # mirrors (cum - freed) < need
                break
            freed = f32(freed + row_b[j])
            row_b[j] = 0.0
            row_l[j] = 0
    row_b[pid] = size
    row_l[pid] = tick
    sch.pool_cache_used[pool] = f32(f32(f32(used - freed) - cached) + size)


def _backoff_release_py(attempt: int, tick: int, params: SimParams) -> int:
    """Backoff re-queue tick — np.float32 mirror of the event engine's
    ``executor._requeue_faulted`` arithmetic (bitwise-equal releases)."""
    backoff = np.minimum(
        np.float32(params.base_backoff_ticks)
        * np.exp2(np.float32(min(attempt, 30))),
        np.float32(2**30),
    ).astype(np.int32)
    return tick + max(int(backoff), 1)


def _pick_slot(free_slots, pool: int, tick: int, sch: Scheduler,
               prefer_warm: bool) -> int:
    """Lowest free slot, preferring warm-for-pool slots when the cold-start
    model is on (mirrors the executor's slot selection)."""
    if prefer_warm:
        warm = [
            s
            for s in free_slots
            if sch.slot_warm_pool[s] == pool and tick < sch.slot_warm_until[s]
        ]
        if warm:
            return min(warm)
    return min(free_slots)


# ---------------------------------------------------------------------------
# The engine.
# ---------------------------------------------------------------------------
def _host(x) -> np.ndarray:
    """A tensor (on any device) or an array as a numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def pipelines_from_workload(wl: Workload) -> List[Pipeline]:
    """The ``Pipeline`` records of one lane (per-lane shapes: ``[MP]``,
    ``[MP, MO]``), from tensors or numpy arrays."""
    arrival = _host(wl.arrival)
    prio = _host(wl.prio)
    n_ops = _host(wl.n_ops)
    valid = _host(wl.op_valid)
    level = _host(wl.op_level)
    ram = _host(wl.op_ram)
    base = _host(wl.op_base)
    alpha = _host(wl.op_alpha)
    out_gb = _host(wl.op_out)
    out = []
    for i in range(arrival.shape[0]):
        ops = [
            Operator(
                ram_gb=float(ram[i, j]),
                base_ticks=float(base[i, j]),
                alpha=float(alpha[i, j]),
                level=int(level[i, j]),
                out_gb=float(out_gb[i, j]),
            )
            for j in range(valid.shape[1])
            if valid[i, j]
        ]
        out.append(
            Pipeline(
                pid=i,
                priority=Priority(int(prio[i])),
                arrival_tick=int(arrival[i]),
                ops=ops,
            )
        )
    return out


def run_python_engine(params: SimParams, wl: Workload):
    """Run lane 0 of the fleet-of-one ``wl`` (``[1, ...]``, on any device)
    to the horizon on the host. Returns a ``SimResult`` whose state and
    workload have the lane axis squeezed and lie on ``wl``'s device,
    ``events`` the loop's iterations and ``sched_state`` the
    :class:`Scheduler`."""
    from .engine import SimResult

    device = wl.arrival.device
    result_wl = workload_lane(wl, 0)
    wl = tree_map(_host, result_wl)  # the one read of the workload
    horizon = params.horizon_ticks
    pipelines = pipelines_from_workload(wl)
    sch = Scheduler(params, pipelines)
    if wl.policy is not None:
        # the dynamic "policy" scheduler reads its PolicyParams vector
        # from the workload, same as the vector engine
        sch.data["policy"] = np.asarray(wl.policy, np.float32)
    algo = get_python_scheduler(params.scheduling_algo)
    get_python_scheduler_init(params.scheduling_algo)(sch)

    MP = params.max_pipelines
    MC = params.max_containers
    NP = params.num_pools
    free_slots = set(range(MC))
    release: dict[int, int] = {}  # pid -> release tick
    completion = np.full((MP,), INF_TICK, np.int64)
    first_start = np.full((MP,), INF_TICK, np.int64)
    fails = np.zeros((MP,), np.int64)
    preempts = np.zeros((MP,), np.int64)
    done_count = failed_count = oom_events = preempt_events = 0
    util_cpu_s = np.zeros((NP,))
    util_ram_s = np.zeros((NP,))
    util_log = np.zeros((params.util_log_buckets, NP, 2))
    cost = 0.0
    sum_lat = 0.0
    sum_lat_prio = np.zeros((3,))
    done_prio = np.zeros((3,), np.int64)
    # ---- data-plane metrics (f32 accumulators, assignment order — the
    # event engine accumulates identically) ------------------------------
    pipe_out = np.asarray(wl.pipe_out)
    cache_hit_gb = np.float32(0.0)
    bytes_moved_gb = np.float32(0.0)
    cache_hits = cache_lookups = cold_starts = warm_starts = 0
    cold_start_tick_total = 0
    prefer_warm = params.cold_start_ticks > 0

    # ---- chaos layer: pre-materialised fault trace + retry policy ---------
    # (docs/faults.md; mirrors executor.apply_faults / _requeue_faulted)
    ft = wl.faults
    crash_on = params.crash_mtbf_ticks > 0 and ft is not None
    outage_on = params.outage_mtbf_ticks > 0 and ft is not None
    straggler_on = params.straggler_prob > 0 and ft is not None
    if ft is not None:
        crash_time = np.asarray(ft.crash_time, np.int64)
        outage_start_t = np.asarray(ft.outage_start, np.int64)
        outage_end_t = np.asarray(ft.outage_end, np.int64)
        outage_pool_t = np.asarray(ft.outage_pool, np.int64)
        straggler = np.asarray(ft.straggler, np.float32)
    pool_down_until = np.zeros((NP,), np.int64)
    crash_cursor = outage_cursor = 0
    nxt_fault = int(INF_TICK)
    pipe_retries = np.zeros((MP,), np.int64)
    crash_events = outage_events = timeout_events = retry_events = 0
    fault_kills = 0
    wasted_ticks = 0
    pool_down_s = 0.0

    # ---- closed loop: client model + admission control --------------------
    # (docs/closed-loop.md; mirrors admission.apply_closed_loop op-for-op)
    closed_on = params.closed_loop_active
    pipe_offered = np.zeros((MP,), bool)
    pipe_presented = np.zeros((MP,), bool)
    pipe_client_attempts = np.zeros((MP,), np.int64)
    offered_total = offered_unique = admitted_total = 0
    shed_total = deferred_total = client_retry_events = 0
    offered_prio = np.zeros((3,), np.int64)
    admitted_prio = np.zeros((3,), np.int64)
    adm_regs = {
        "tokens": np.float32(params.admit_burst),
        "last_tick": 0,
        "above_since": int(INF_TICK),
    }
    last_fault_tick = int(INF_TICK)
    prefault_backlog = -1
    drain_tick = int(INF_TICK)
    if params.admission_active:
        from .admission import AdmissionView, get_admission_policy_py

        adm_policy = get_admission_policy_py(params.admission_policy)

    def _requeue_faulted_py(pid: int, t: int) -> None:
        """Retry policy for a fault-killed / timed-out pipeline: backoff
        re-queue while budget lasts, FAILED once it is exhausted. Does
        NOT set ``failed_before`` (the allocation was fine — the worker
        died), exactly like the event engine."""
        nonlocal failed_count, retry_events
        attempt = int(pipe_retries[pid])
        if attempt >= params.max_retries:
            sch.status[pid] = PipeStatus.FAILED
            completion[pid] = t
            failed_count += 1
        else:
            sch.status[pid] = PipeStatus.SUSPENDED
            release[pid] = _backoff_release_py(attempt, t, params)
            pipe_retries[pid] += 1
            retry_events += 1

    def _mark_warm(c: Container, t: int) -> None:
        sch.slot_warm_pool[c.slot] = c.pool
        sch.slot_warm_until[c.slot] = t + params.container_warm_ticks

    arrivals_sorted = sorted(
        (p.arrival_tick, p.pid) for p in pipelines if p.arrival_tick < horizon
    )
    arr_ix = 0

    tick = 0
    events = 0
    while tick < horizon:
        events += 1
        # ---- arrivals -----------------------------------------------------
        new_pipes: list[Pipeline] = []
        while arr_ix < len(arrivals_sorted) and arrivals_sorted[arr_ix][0] <= tick:
            _, pid = arrivals_sorted[arr_ix]
            arr_ix += 1
            sch.status[pid] = PipeStatus.WAITING
            sch.entered[pid] = pipelines[pid].arrival_tick
            new_pipes.append(pipelines[pid])
        # ---- suspension releases -----------------------------------------
        for pid in [p for p, r in release.items() if r <= tick]:
            sch.status[pid] = PipeStatus.WAITING
            sch.entered[pid] = release.pop(pid)
        # ---- completions / OOMs -------------------------------------------
        failures: list[Failure] = []
        for pid, c in list(sch.running.items()):
            fire_oom = c.oom is not None and c.oom <= tick
            fire_end = c.end <= tick
            if not (fire_oom or fire_end):
                continue
            sch.pool_cpu_free[c.pool] += c.cpus
            sch.pool_ram_free[c.pool] += c.ram
            free_slots.add(c.slot)
            _mark_warm(c, tick)
            del sch.running[pid]
            p = pipelines[pid]
            if fire_oom:
                sch.status[pid] = PipeStatus.WAITING
                sch.entered[pid] = tick
                p.failed_before = True
                fails[pid] += 1
                oom_events += 1
                failures.append(Failure(p, tick, c.cpus, c.ram))
            elif c.timed:
                # wall-clock timeout: the slot retires normally (it ran
                # fine until the deadline, so it stays warm) but the
                # pipeline re-queues under the retry policy
                timeout_events += 1
                wasted_ticks += tick - c.start
                _requeue_faulted_py(pid, tick)
            else:
                sch.status[pid] = PipeStatus.DONE
                completion[pid] = c.end
                done_count += 1
                lat = (c.end - p.arrival_tick) / TICKS_PER_SECOND
                sum_lat += lat
                sum_lat_prio[int(p.priority)] += lat
                done_prio[int(p.priority)] += 1

        # ---- chaos layer: crashes + pool outages due at this tick -----------
        if crash_on or outage_on:
            kills: list[Container] = []
            k_due_now = o_due_now = 0
            backlog_at_fault = sum(
                1 for s2 in sch.status.values() if s2 == PipeStatus.WAITING
            )
            if crash_on:
                new_ccur = int(np.searchsorted(crash_time, tick, side="right"))
                k_due = new_ccur - crash_cursor
                k_due_now = k_due
                crash_cursor = new_ccur
                crash_events += k_due
                if k_due > 0:
                    # each crash strikes the longest-running container
                    # (start asc, slot asc); a crash with nothing left
                    # running strikes an idle worker and kills nothing
                    victims = sorted(
                        sch.running.values(), key=lambda c: (c.start, c.slot)
                    )
                    kills.extend(victims[:k_due])
            down_new = np.zeros((NP,), bool)
            if outage_on:
                new_ocur = int(
                    np.searchsorted(outage_start_t, tick, side="right")
                )
                for i in range(outage_cursor, new_ocur):
                    p_ix = int(outage_pool_t[i])
                    down_new[p_ix] = True
                    pool_down_until[p_ix] = max(
                        pool_down_until[p_ix], int(outage_end_t[i])
                    )
                o_due_now = new_ocur - outage_cursor
                outage_events += new_ocur - outage_cursor
                outage_cursor = new_ocur
                if down_new.any():
                    struck = {c.slot for c in kills}
                    kills.extend(
                        c for c in sch.running.values()
                        if down_new[c.pool] and c.slot not in struck
                    )
            for c in kills:
                pid = c.pipe
                sch.pool_cpu_free[c.pool] += c.cpus
                sch.pool_ram_free[c.pool] += c.ram
                free_slots.add(c.slot)
                # a struck slot hands off no warmth (the worker died)
                sch.slot_warm_pool[c.slot] = -1
                sch.slot_warm_until[c.slot] = 0
                del sch.running[pid]
                fault_kills += 1
                wasted_ticks += tick - c.start
                _requeue_faulted_py(pid, tick)
            if outage_on and down_new.any():
                # a newly-down pool loses its warm slots and its cache
                for s in range(MC):
                    wp = int(sch.slot_warm_pool[s])
                    if wp >= 0 and down_new[wp]:
                        sch.slot_warm_pool[s] = -1
                        sch.slot_warm_until[s] = 0
                if params.cache_gb_per_pool > 0:
                    for p_ix in range(NP):
                        if down_new[p_ix]:
                            sch.cache_bytes[p_ix, :] = 0.0
                            sch.cache_last[p_ix, :] = 0
                            sch.pool_cache_used[p_ix] = 0.0
            # next-fault register: next crash / outage start / recovery
            nxt_fault = int(INF_TICK)
            if crash_on and crash_cursor < crash_time.shape[0]:
                nxt_fault = min(nxt_fault, int(crash_time[crash_cursor]))
            if outage_on:
                if outage_cursor < outage_start_t.shape[0]:
                    nxt_fault = min(
                        nxt_fault, int(outage_start_t[outage_cursor])
                    )
                for p_ix in range(NP):
                    if pool_down_until[p_ix] > tick:
                        nxt_fault = min(nxt_fault, int(pool_down_until[p_ix]))
            if closed_on and (k_due_now > 0 or o_due_now > 0):
                # overload bookkeeping (mirrors executor.apply_faults):
                # stamp the fault tick, snapshot the pre-fault backlog
                # once, and re-arm drain detection
                last_fault_tick = tick
                if prefault_backlog < 0:
                    prefault_backlog = backlog_at_fault
                drain_tick = int(INF_TICK)

        # ---- closed loop: client offer gate + admission (pre-scheduler) -----
        # (mirrors admission.apply_closed_loop; docs/closed-loop.md)
        if closed_on:
            fresh = [
                pid for pid in sorted(sch.status)
                if sch.status[pid] == PipeStatus.WAITING
                and first_start[pid] == INF_TICK
                and not pipe_offered[pid]
            ]
            if params.client_max_inflight > 0:
                inflight = sum(
                    1 for pid2, s2 in sch.status.items()
                    if pipe_offered[pid2]
                    and s2 in (PipeStatus.WAITING, PipeStatus.RUNNING,
                               PipeStatus.SUSPENDED)
                )
                open_slots = max(params.client_max_inflight - inflight, 0)
                offer = fresh[:open_slots]
                gate_defer = fresh[open_slots:]
            else:
                offer = fresh
                gate_defer = []
            if params.admission_active:
                adm_waiting = [
                    pid2 for pid2, s2 in sch.status.items()
                    if s2 == PipeStatus.WAITING and pipe_offered[pid2]
                ]
                view = AdmissionView(
                    admitted_waiting=len(adm_waiting),
                    oldest_admitted_entered=min(
                        (int(sch.entered[pid2]) for pid2 in adm_waiting),
                        default=int(INF_TICK),
                    ),
                    regs=adm_regs,
                )
                reject, defer, defer_ticks = adm_policy(
                    params, tick, offer, view
                )
            else:
                reject, defer, defer_ticks = [], [], 1
            bounced = set(reject) | set(defer)
            admit = [pid for pid in offer if pid not in bounced]
            offered_total += len(offer)
            for pid in offer:
                offered_prio[int(pipelines[pid].priority)] += 1
                if not pipe_presented[pid]:
                    offered_unique += 1
                    pipe_presented[pid] = True
            admitted_total += len(admit)
            for pid in admit:
                admitted_prio[int(pipelines[pid].priority)] += 1
                pipe_offered[pid] = True
            think = max(params.client_think_ticks, 1)
            for pid in gate_defer:
                sch.status[pid] = PipeStatus.SUSPENDED
                release[pid] = tick + think
            pol_delay = max(defer_ticks, 1)
            for pid in defer:
                sch.status[pid] = PipeStatus.SUSPENDED
                release[pid] = tick + pol_delay
            deferred_total += len(gate_defer) + len(defer)
            shed_total += len(reject)
            for pid in reject:
                attempt = int(pipe_client_attempts[pid])
                if attempt < params.client_max_retries:
                    # client-side capped exponential backoff (np.float32
                    # mirror of the event engine's arithmetic)
                    backoff = np.minimum(
                        np.float32(params.client_backoff_ticks)
                        * np.exp2(np.float32(min(attempt, 30))),
                        np.float32(2**30),
                    ).astype(np.int32)
                    sch.status[pid] = PipeStatus.SUSPENDED
                    release[pid] = tick + max(int(backoff), 1)
                    pipe_client_attempts[pid] += 1
                    client_retry_events += 1
                else:
                    sch.status[pid] = PipeStatus.FAILED
                    completion[pid] = tick
                    failed_count += 1
            if params.fault_events_active:
                backlog = sum(
                    1 for s2 in sch.status.values()
                    if s2 == PipeStatus.WAITING
                )
                if (
                    last_fault_tick != int(INF_TICK)
                    and tick > last_fault_tick
                    and backlog <= max(prefault_backlog, 0)
                    and drain_tick == int(INF_TICK)
                ):
                    drain_tick = tick

        # ---- scheduler (down pools masked to zero free capacity) ------------
        down = pool_down_until > tick
        if outage_on and down.any():
            saved_free = (sch.pool_cpu_free, sch.pool_ram_free)
            sch.pool_cpu_free = np.where(
                down, np.float32(0.0), sch.pool_cpu_free
            ).astype(np.float32)
            sch.pool_ram_free = np.where(
                down, np.float32(0.0), sch.pool_ram_free
            ).astype(np.float32)
            suspends, assignments = algo(sch, failures, new_pipes)
            sch.pool_cpu_free, sch.pool_ram_free = saved_free
            # decision filter: cap-driven schedulers (naive) can still
            # target a dead pool — drop those before they commit
            assignments = [
                a for a in assignments
                if not down[min(max(int(a.pool), 0), NP - 1)]
            ]
        else:
            suspends, assignments = algo(sch, failures, new_pipes)
        acted = bool(suspends or assignments or sch.data.get("rejects"))

        # rejects (permanent failures back to the user)
        for pid in sch.data.pop("rejects", []):
            if sch.status[pid] == PipeStatus.WAITING:
                sch.status[pid] = PipeStatus.FAILED
                completion[pid] = tick
                failed_count += 1

        # suspensions
        for s in suspends:
            pid = s.pipeline.pid
            c = sch.running.pop(pid, None)
            if c is None:
                continue
            sch.pool_cpu_free[c.pool] += c.cpus
            sch.pool_ram_free[c.pool] += c.ram
            free_slots.add(c.slot)
            _mark_warm(c, tick)
            sch.status[pid] = PipeStatus.SUSPENDED
            release[pid] = tick + 1
            preempts[pid] += 1
            preempt_events += 1

        # assignments
        for a in assignments:
            pid = a.pipeline.pid
            if sch.status[pid] != PipeStatus.WAITING or not free_slots:
                continue
            pool = int(a.pool)
            slot = _pick_slot(free_slots, pool, tick, sch, prefer_warm)
            free_slots.discard(slot)
            is_warm = bool(
                sch.slot_warm_pool[slot] == pool
                and tick < sch.slot_warm_until[slot]
            )
            cold_ticks = 0 if is_warm else params.cold_start_ticks
            # data plane: scan whatever input bytes the pool's cache lacks
            total_out = np.float32(pipe_out[pid])
            cached = sch.cache_bytes[pool, pid]
            hit_gb = np.minimum(cached, total_out)
            miss_gb = np.maximum(np.float32(total_out - cached), np.float32(0))
            scan_ticks = int(
                np.ceil(np.float32(params.scan_ticks_per_gb) * miss_gb)
            )
            startup = cold_ticks + scan_ticks
            cpus, ram_gb = np.float32(a.cpus), np.float32(a.ram_gb)
            dur, oom_off = container_schedule_py(a.pipeline, cpus, ram_gb)
            if straggler_on:
                # straggler stretch (f32, mirrors the event engine's stretch;
                # ceil is monotone so stretching the pre-clamped offset
                # equals its stretch-then-min)
                f = np.float32(straggler[pid])

                def _stretch(t: int) -> int:
                    return int(np.minimum(
                        np.ceil(np.float32(t) * f), np.float32(2**30)
                    ).astype(np.int32))

                dur = _stretch(dur)
                if oom_off is not None:
                    oom_off = _stretch(oom_off)
            end = tick + startup + dur
            timed = False
            if params.timeout_ticks > 0:
                # wall-clock deadline; a same-tick OOM wins at retirement
                deadline = tick + params.timeout_ticks
                timed = end > deadline
                end = min(end, deadline)
            c = Container(
                slot,
                pid,
                pool,
                cpus,
                ram_gb,
                tick,
                end,
                (tick + startup + oom_off) if oom_off is not None else None,
                warm=is_warm,
                timed=timed,
            )
            cache_hit_gb = np.float32(cache_hit_gb + hit_gb)
            bytes_moved_gb = np.float32(bytes_moved_gb + miss_gb)
            cache_hits += int(hit_gb > 0)
            cache_lookups += int(total_out > 0)
            cold_starts += int(not is_warm)
            warm_starts += int(is_warm)
            cold_start_tick_total += cold_ticks
            if params.cache_gb_per_pool > 0:
                _cache_insert_py(
                    sch, pool, pid, total_out, tick, params.cache_gb_per_pool
                )
            sch.running[pid] = c
            sch.status[pid] = PipeStatus.RUNNING
            a.pipeline.last_cpus = a.cpus
            a.pipeline.last_ram_gb = a.ram_gb
            a.pipeline.failed_before = False
            first_start[pid] = min(first_start[pid], tick)
            sch.pool_cpu_free[a.pool] -= a.cpus
            sch.pool_ram_free[a.pool] -= a.ram_gb

        # ---- next event -----------------------------------------------------
        nxt = horizon
        if arr_ix < len(arrivals_sorted):
            nxt = min(nxt, arrivals_sorted[arr_ix][0])
        for c in sch.running.values():
            nxt = min(nxt, c.end if c.oom is None else min(c.end, c.oom))
        for r in release.values():
            nxt = min(nxt, r)
        if crash_on or outage_on:
            nxt = min(nxt, nxt_fault)
        if acted:
            nxt = min(nxt, tick + 1)
        nxt = max(nxt, tick + 1)
        nxt = min(nxt, horizon)

        # ---- integrate utilisation over [tick, nxt) -------------------------
        dt_s = (nxt - tick) / TICKS_PER_SECOND
        used_cpu = np.zeros((NP,))
        used_ram = np.zeros((NP,))
        for c in sch.running.values():
            used_cpu[c.pool] += c.cpus
            used_ram[c.pool] += c.ram
        util_cpu_s += used_cpu * dt_s
        util_ram_s += used_ram * dt_s
        base_cpu = params.pool_cpus
        over = np.maximum(used_cpu - base_cpu, 0.0)
        cost += (
            float(np.sum(np.minimum(used_cpu, base_cpu) + params.cloud_premium_factor * over))
            * params.cloud_cost_per_cpu_second
            * dt_s
        )
        B = params.util_log_buckets
        edges = np.linspace(0.0, float(horizon), B + 1)
        lo = np.maximum(edges[:-1], tick)
        hi = np.minimum(edges[1:], nxt)
        overlap_s = np.maximum(hi - lo, 0.0) / TICKS_PER_SECOND
        util_log += overlap_s[:, None, None] * np.stack(
            [used_cpu, used_ram], axis=-1
        )[None, :, :]
        if outage_on:
            # a pool down at tick is down for all of [tick, nxt): the
            # next-fault register includes every recovery tick
            pool_down_s += float(dt_s) * int(np.sum(pool_down_until > tick))

        tick = nxt

    # ---- pack a SimState for uniform downstream consumption ----------------
    def asarray(x, dtype=None) -> torch.Tensor:
        return torch.from_numpy(np.array(x, dtype=dtype))

    st = SimState(*(x[0] for x in init_state(params, 1, "cpu")))
    status_arr = np.full((MP,), int(PipeStatus.EMPTY), np.int32)
    for pid, s in sch.status.items():
        # not-yet-arrived pipelines are indistinguishable from empty slots
        # in the SoA representation — normalise for engine equivalence
        status_arr[pid] = int(PipeStatus.EMPTY if s == PipeStatus.PENDING else s)
    # next-event registers: same invariants the event engine's executor keeps
    # (min end/oom over running containers, min release over suspended,
    # count of consumed arrivals)
    nxt_retire = min(
        (
            c.end if c.oom is None else min(c.end, c.oom)
            for c in sch.running.values()
        ),
        default=int(INF_TICK),
    )
    nxt_release = min(release.values(), default=int(INF_TICK))
    st = st._replace(
        nxt_retire=asarray(min(nxt_retire, int(INF_TICK)), np.int32),
        nxt_release=asarray(min(nxt_release, int(INF_TICK)), np.int32),
        nxt_arrival_cursor=asarray(arr_ix, np.int32),
        tick=asarray(horizon, np.int32),
        pipe_status=asarray(status_arr),
        pipe_completion=asarray(
            np.minimum(completion, INF_TICK).astype(np.int32)
        ),
        pipe_first_start=asarray(
            np.minimum(first_start, INF_TICK).astype(np.int32)
        ),
        pipe_fails=asarray(fails.astype(np.int32)),
        pipe_preempts=asarray(preempts.astype(np.int32)),
        pipe_fail_flag=asarray(
            np.array([pipelines[i].failed_before for i in range(MP)])
        ),
        pool_cpu_free=asarray(np.array(sch.pool_cpu_free, np.float32)),
        pool_ram_free=asarray(np.array(sch.pool_ram_free, np.float32)),
        pool_cache_used=asarray(
            np.array(sch.pool_cache_used, np.float32)
        ),
        cache_bytes=asarray(np.array(sch.cache_bytes, np.float32)),
        cache_last=asarray(sch.cache_last.astype(np.int32)),
        slot_warm_pool=asarray(sch.slot_warm_pool.astype(np.int32)),
        slot_warm_until=asarray(
            np.minimum(sch.slot_warm_until, INF_TICK).astype(np.int32)
        ),
        ctr_warm=asarray(
            np.array(
                [
                    any(
                        c.slot == s and c.warm
                        for c in sch.running.values()
                    )
                    for s in range(MC)
                ]
            )
        ),
        cache_hit_gb=asarray(cache_hit_gb, np.float32),
        bytes_moved_gb=asarray(bytes_moved_gb, np.float32),
        cache_hits=asarray(cache_hits, np.int32),
        cache_lookups=asarray(cache_lookups, np.int32),
        cold_starts=asarray(cold_starts, np.int32),
        warm_starts=asarray(warm_starts, np.int32),
        cold_start_tick_total=asarray(cold_start_tick_total, np.int32),
        done_count=asarray(done_count, np.int32),
        failed_count=asarray(failed_count, np.int32),
        oom_events=asarray(oom_events, np.int32),
        preempt_events=asarray(preempt_events, np.int32),
        sum_latency_s=asarray(sum_lat, np.float32),
        sum_latency_s_prio=asarray(sum_lat_prio.astype(np.float32)),
        done_prio=asarray(done_prio.astype(np.int32)),
        util_cpu_s=asarray(util_cpu_s.astype(np.float32)),
        util_ram_s=asarray(util_ram_s.astype(np.float32)),
        cost_dollars=asarray(cost, np.float32),
        util_log=asarray(util_log.astype(np.float32)),
        # ---- chaos layer registers + counters -----------------------------
        pipe_retries=asarray(pipe_retries.astype(np.int32)),
        ctr_timed=asarray(
            np.array(
                [
                    any(
                        c.slot == s and c.timed
                        for c in sch.running.values()
                    )
                    for s in range(MC)
                ]
            )
        ),
        pool_down_until=asarray(
            np.minimum(pool_down_until, INF_TICK).astype(np.int32)
        ),
        crash_cursor=asarray(crash_cursor, np.int32),
        outage_cursor=asarray(outage_cursor, np.int32),
        nxt_fault=asarray(min(nxt_fault, int(INF_TICK)), np.int32),
        crash_events=asarray(crash_events, np.int32),
        outage_events=asarray(outage_events, np.int32),
        timeout_events=asarray(timeout_events, np.int32),
        retry_events=asarray(retry_events, np.int32),
        fault_kills=asarray(fault_kills, np.int32),
        wasted_ticks=asarray(wasted_ticks, np.int32),
        pool_down_s=asarray(pool_down_s, np.float32),
        # ---- closed-loop registers + counters -----------------------------
        pipe_offered=asarray(pipe_offered),
        pipe_presented=asarray(pipe_presented),
        pipe_client_attempts=asarray(
            pipe_client_attempts.astype(np.int32)
        ),
        offered_total=asarray(offered_total, np.int32),
        offered_unique=asarray(offered_unique, np.int32),
        admitted_total=asarray(admitted_total, np.int32),
        shed_total=asarray(shed_total, np.int32),
        deferred_total=asarray(deferred_total, np.int32),
        client_retry_events=asarray(client_retry_events, np.int32),
        offered_prio=asarray(offered_prio.astype(np.int32)),
        admitted_prio=asarray(admitted_prio.astype(np.int32)),
        admit_tokens=asarray(adm_regs["tokens"], np.float32),
        admit_last_tick=asarray(adm_regs["last_tick"], np.int32),
        codel_above_since=asarray(
            min(adm_regs["above_since"], int(INF_TICK)), np.int32
        ),
        last_fault_tick=asarray(last_fault_tick, np.int32),
        prefault_backlog=asarray(prefault_backlog, np.int32),
        drain_tick=asarray(drain_tick, np.int32),
    )
    st = tree_map(lambda x: x.to(device), st)  # the one write of the state
    return SimResult(state=st, workload=result_wl, params=params, events=events,
                     sched_state=sch)


__all__ = [
    "Scheduler",
    "Container",
    "container_schedule_py",
    "pipelines_from_workload",
    "run_python_engine",
]
