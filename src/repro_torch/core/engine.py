"""The lane-major simulation core, as a Python loop over events.

The reference's engine is one ``lax.while_loop`` over a vmapped lane
step. Here every field is a ``[F, ...]`` tensor and the loop is Python:

* each iteration is one event for every lane still running: the
  ``fleet_tick`` phase-1 read, :func:`executor.apply_fused_phase1`, the
  fault pass (:func:`executor.apply_faults`, crashes and outages), the
  closed-loop pass (:func:`admission.apply_closed_loop`: the client
  gate, the admission policy, client retries and shedding; a Python
  branch on ``params.closed_loop_active``, so with the loop off none of
  it runs), the scheduler (on a view with down pools masked), the
  down-pool filter,
  :func:`executor.apply_decision`, the jump to the lane's next event
  from the ``nxt_retire`` / ``nxt_release`` / ``nxt_fault`` registers
  and the sorted arrivals, and the integrals over the jump;
* finished lanes pass through untouched (the reference's ``keep`` mask),
  their scheduler state too;
* the loop ends when no lane has ``tick < horizon``: one host read per
  event, which also reads the fault pass's gate.

With ``trace_capacity > 0`` each event is :func:`traced_event_step`: the
same step, with the state at entry and after the closed-loop pass kept
and the telemetry recorder (``telemetry.record_step``) appending the
event's records to every active lane's trace. The recorder only reads,
so a traced run's states equal the untraced run's bit for bit; with a
capacity of 0 none of it runs.

``run()`` is a fleet of one; ``sweep.fleet_run`` the F-lane case.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from . import admission, executor
from .params import SimParams, load_params
from .faults import attach_fault_trace
from .policy import N_POLICY_PARAMS
from .scheduler import (
    SchedDecision,
    get_scheduler,
    get_vector_scheduler_init,
    mask_down_pools,
)
from .state import (
    SimState,
    Workload,
    broadcast_lanes,
    init_state,
    tree_map,
    workload_lane,
    workload_to,
)
from .telemetry.decode import decode_lane
from .telemetry.record import init_trace_buffer, record_step, step_block_rows
from .telemetry.schema import DEFAULT_TRACE_CAPACITY
from .types import INF_TICK, ContainerStatus, PipeStatus
from .workload import get_workload
from ..kernels.sim_tick import fleet_tick


@dataclasses.dataclass
class SimResult:
    state: SimState        # lane axis squeezed: per-lane shapes
    workload: Workload     # likewise
    params: SimParams
    events: int = 0        # engine loop iterations
    sched_state: Any = None  # the scheduler's final state (lane axis squeezed)
    trace: Any = None      # telemetry.TraceEvents when run(trace=True)

    def summary(self) -> dict:
        from .metrics import summarize

        return summarize(self.state, self.workload, self.params, trace=self.trace)


def _raise_later(what: str, slice_: str):
    raise NotImplementedError(f"{what} waits for ROADMAP queue 1, {slice_}")


def check_main_path(params: SimParams) -> None:
    """Raise ``NotImplementedError`` for an optional layer the port does
    not have yet, naming the ROADMAP item that brings it, and
    ``KeyError`` for an admission policy nobody registered, before the
    run starts."""
    if params.engine != "event":
        _raise_later(f"engine={params.engine!r}", "item 14 (the paper's surface)")
    if params.admission_active:
        admission.get_admission_policy(params.admission_policy)


def resolve_device(device) -> torch.device:
    """The device a run asks for; a CUDA device without a card raises
    (the port never moves a run to the CPU by itself)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on CUDA by default, and torch.cuda.is_available() "
            "is False here; pass device='cpu' to run the plain PyTorch versions"
        )
    return device


def _sorted_arrivals(arrival: torch.Tensor) -> torch.Tensor:
    """Arrival ticks sorted ascending along the last axis, INF-padded by
    one slot so a cursor past every arrival reads INF_TICK."""
    pad = torch.full(arrival.shape[:-1] + (1,), INF_TICK, dtype=torch.int32,
                     device=arrival.device)
    return torch.cat([torch.sort(arrival, dim=-1).values, pad], dim=-1)


def _next_event_registers(
    state: SimState, arr_sorted: torch.Tensor, tick: torch.Tensor,
    acted: torch.Tensor,
):
    """``(next_tick, cursor)`` per lane from the registers and a binary
    search of the sorted arrivals (``searchsorted(side="right")``)."""
    cursor = torch.searchsorted(
        arr_sorted[:, :-1].contiguous(), tick[:, None].contiguous(), right=True
    )
    next_arrival = torch.gather(arr_sorted, 1, cursor)[:, 0]
    nxt = torch.minimum(torch.minimum(next_arrival, state.nxt_retire),
                        state.nxt_release)
    nxt = torch.minimum(nxt, state.nxt_fault)
    nxt = torch.where(acted, torch.minimum(nxt, tick + 1), nxt)
    return torch.maximum(nxt, tick + 1), cursor[:, 0].to(torch.int32)


def _next_event(state: SimState, wl: Workload, tick: torch.Tensor,
                acted: torch.Tensor) -> torch.Tensor:
    """Earliest tick after ``tick`` at which a lane's state can change,
    recomputed from the tables: the oracle for the registers."""
    pending = state.pipe_status == int(PipeStatus.EMPTY)
    t = tick[:, None]
    next_arrival = torch.where(
        pending & (wl.arrival > t), wl.arrival, INF_TICK).amin(-1)
    running = state.ctr_status == int(ContainerStatus.RUNNING)
    next_retire = torch.where(
        running, torch.minimum(state.ctr_end, state.ctr_oom), INF_TICK
    ).amin(-1)
    suspended = state.pipe_status == int(PipeStatus.SUSPENDED)
    next_release = torch.where(suspended, state.pipe_release, INF_TICK).amin(-1)
    nxt = torch.minimum(torch.minimum(next_arrival, next_retire), next_release)
    if wl.faults is not None:
        # the next crash and outage start past ``tick`` (the sorted trace's
        # first entry beyond it), and the next pool recovery
        ft = wl.faults
        for times in (ft.crash_time, ft.outage_start, state.pool_down_until):
            nxt = torch.minimum(nxt, torch.where(times > t, times, INF_TICK).amin(-1))
    nxt = torch.where(acted, torch.minimum(nxt, tick + 1), nxt)
    return torch.maximum(nxt, tick + 1)


def _acted(dec: SchedDecision) -> torch.Tensor:
    return dec.suspend.any(-1) | dec.reject.any(-1) | (dec.assign_pipe >= 0).any(-1)


def _lane_decide(params, scheduler_fn, state, sched_state, wl, arr_sorted, tick,
                 active, edges, with_aux: bool = False):
    """From the scheduler on, for every lane: decide (on a view with the
    down pools masked, and without assignments onto them), apply, jump
    to the next event and integrate over the jump. Returns ``(state,
    sched_state, dec, aux)``, ``aux`` the recorder's per-slot columns
    from :func:`executor.apply_decision` (``with_aux``) or None."""
    if params.outage_mtbf_ticks > 0:
        sched_state, dec = scheduler_fn(
            sched_state, mask_down_pools(state, tick), wl, params, active)
        dec = _filter_down_pool_assignments(dec, state, tick, params)
    else:
        sched_state, dec = scheduler_fn(sched_state, state, wl, params, active)
    aux = None
    if with_aux:
        state, aux = executor.apply_decision(state, wl, dec, tick, params, with_aux=True)
    else:
        state = executor.apply_decision(state, wl, dec, tick, params)
    nxt, cursor = _next_event_registers(state, arr_sorted, tick, _acted(dec))
    nxt = torch.clamp_max(nxt, params.horizon_ticks)
    state = executor.integrate(state, tick, nxt, params, edges)
    return state._replace(tick=nxt, nxt_arrival_cursor=cursor), sched_state, dec, aux


def _filter_down_pool_assignments(dec: SchedDecision, state: SimState,
                                  tick: torch.Tensor, params: SimParams) -> SchedDecision:
    """Drop the assignments onto a down pool (schedulers that size by
    pool caps would commit onto dead capacity otherwise)."""
    down = tick[:, None] < state.pool_down_until
    pool = dec.assign_pool.clamp(0, params.num_pools - 1).long()
    bad = (dec.assign_pipe >= 0) & torch.gather(down, 1, pool)
    return dec._replace(assign_pipe=torch.where(bad, -1, dec.assign_pipe))


def fault_gate(states: SimState, active: torch.Tensor, params: SimParams):
    """``(any lane active, fault pass due)`` in one host read. The pass
    is due when some active lane's ``nxt_fault`` has come; on the lanes
    where it has not, the pass changes nothing, so running it for the
    whole fleet (or not at all) is exact."""
    if not params.fault_events_active:
        return bool(active.any()), False
    due = active & (states.tick >= states.nxt_fault)
    go, due = torch.stack([active.any(), due.any()]).tolist()
    return go, due


def _phase1(params, state, wl):
    """``fleet_tick``'s masks and :func:`executor.apply_fused_phase1`;
    returns the state and the masks."""
    tick = state.tick
    ph = fleet_tick(
        state.ctr_status, state.ctr_end, state.ctr_oom,
        state.ctr_cpus, state.ctr_ram, state.ctr_pool,
        state.pipe_status, wl.arrival, state.pipe_release,
        tick, num_pools=params.num_pools,
    )
    return executor.apply_fused_phase1(state, wl, tick, params, ph), ph


def event_step(params, scheduler_fn, state, wl, arr_sorted, edges, active,
               faults_due: bool = False, sched_state=None):
    """One event for every lane: phase 1, the fault pass where
    ``faults_due`` (:func:`fault_gate`), the closed-loop pass (with the
    loop on), then :func:`_lane_decide`. Returns the advanced state and
    scheduler state (finished lanes not yet masked) and the decision."""
    tick = state.tick
    state, _ = _phase1(params, state, wl)
    if faults_due:
        state = executor.apply_faults(state, wl, tick, params)
    if params.closed_loop_active:
        state = admission.apply_closed_loop(state, wl, tick, params)
    state, sched_state, dec, _ = _lane_decide(
        params, scheduler_fn, state, sched_state, wl, arr_sorted, tick, active, edges)
    return state, sched_state, dec


def traced_event_step(params, scheduler_fn, state, wl, arr_sorted, edges, active,
                      faults_due, sched_state, tbuf, capacity: int):
    """:func:`event_step` plus the telemetry recorder: the same state and
    scheduler updates, with the event's records appended to ``tbuf``
    (``active`` gates every write). The recorder sees the state at entry
    (``pre``), after phase 1, the fault pass and the closed-loop pass
    (``st1``, the queue the scheduler saw) and after the step; where the
    fault pass is not due, its outputs are
    :func:`executor.zero_fault_aux`, what the pass gives there. Returns
    ``(state, sched_state, tbuf)``."""
    pre, tick = state, state.tick
    state, ph = _phase1(params, state, wl)
    fault_aux = None
    if params.fault_events_active:
        if faults_due:
            state, fault_aux = executor.apply_faults(state, wl, tick, params, with_aux=True)
        else:
            fault_aux = executor.zero_fault_aux(state)
    if params.closed_loop_active:
        state = admission.apply_closed_loop(state, wl, tick, params)
    st1 = state
    state, sched_state, dec, aux = _lane_decide(
        params, scheduler_fn, state, sched_state, wl, arr_sorted, tick, active, edges,
        with_aux=True)
    tbuf = record_step(tbuf, capacity, active, pre, st1, state, wl, params, tick, ph, dec,
                       aux, fault_aux)
    return state, sched_state, tbuf


def _keep(active: torch.Tensor, new, old):
    """``new`` on the active lanes and ``old`` on the rest, leaf by leaf
    of a state (or a scheduler state's tree)."""
    def sel(n, o):
        return torch.where(active.reshape((-1,) + (1,) * (n.dim() - 1)), n, o)

    return tree_map(sel, new, old)


def initial_sched_state(scheduler_key: str, params: SimParams, F: int, device):
    """The scheduler's initial state, ``get_vector_scheduler_init(key)
    (params)``, on ``device`` and broadcast to the ``F`` lanes."""
    init = get_vector_scheduler_init(scheduler_key)(params)
    return broadcast_lanes(tree_map(lambda x: torch.as_tensor(x, device=device), init), F)


def run_lane_major_engine(
    params: SimParams, wls: Workload, scheduler_key: str, trace_capacity: int = 0,
):
    """Advance the whole batch ``wls`` ``[F, ...]`` to the horizon.
    Returns the final fleet state, the final scheduler state, the number
    of loop iterations and, with ``trace_capacity > 0``, the fleet's
    ``telemetry.TraceBuffer`` (records ``[F, trace_capacity, 11]``;
    None untraced). Trace buffers skip the finished-lane mask: the
    recorder gates its writes on ``active`` itself."""
    scheduler_fn = get_scheduler(scheduler_key)
    device = wls.arrival.device
    F = wls.arrival.shape[0]
    horizon = params.horizon_ticks
    arr_sorted = _sorted_arrivals(wls.arrival)
    edges = executor.bucket_edges(params, device)
    states = init_state(params, F, device)
    scheds = initial_sched_state(scheduler_key, params, F, device)
    tbuf = None
    if trace_capacity:
        scratch = step_block_rows(params.max_pipelines, params.max_containers,
                                  params.max_assignments_per_tick, params)
        tbuf = init_trace_buffer(F, trace_capacity, scratch, device)
    events = 0
    while True:
        active = states.tick < horizon
        go, faults_due = fault_gate(states, active, params)
        if not go:
            break
        if tbuf is None:
            new, new_scheds, _ = event_step(params, scheduler_fn, states, wls, arr_sorted,
                                            edges, active, faults_due, scheds)
        else:
            new, new_scheds, tbuf = traced_event_step(
                params, scheduler_fn, states, wls, arr_sorted, edges, active, faults_due,
                scheds, tbuf, trace_capacity)
        states = _keep(active, new, states)
        scheds = _keep(active, new_scheds, scheds)
        events += 1
    if tbuf is not None:
        tbuf = tbuf._replace(records=tbuf.records[:, :trace_capacity])
    return states, scheds, events, tbuf


def _check_workload(wl: Workload, params: SimParams) -> None:
    if wl.arrival.dim() != 2:
        raise ValueError(
            f"workload arrival must be [F, MP] (lane-major), got {tuple(wl.arrival.shape)}"
        )
    got = (wl.arrival.shape[-1], wl.op_valid.shape[-1])
    want = (params.max_pipelines, params.max_ops_per_pipeline)
    if got != want:
        raise ValueError(
            f"workload is shaped {got} (max_pipelines, max_ops_per_pipeline) "
            f"but params say {want}"
        )
    if wl.policy is not None and tuple(wl.policy.shape) != (
            wl.arrival.shape[0], N_POLICY_PARAMS):
        raise ValueError(
            f"workload policy vectors are shaped {tuple(wl.policy.shape)}; expected "
            f"[F, {N_POLICY_PARAMS}] = {(wl.arrival.shape[0], N_POLICY_PARAMS)}"
        )
    if wl.faults is not None:
        F, MP = wl.arrival.shape
        MF = wl.faults.crash_time.shape[-1]
        shapes = [tuple(x.shape) for x in wl.faults]
        if shapes != [(F, MF)] * 4 + [(F, MP)]:
            raise ValueError(
                f"fault trace fields are shaped {shapes}; expected [F, MF] x 4 "
                f"and [F, MP] = {(F, MP)}"
            )


def run(
    paramfile: str | dict | SimParams,
    workload: Workload | None = None,
    engine: str | None = None,
    *,
    device: Any = "cuda",
    trace: bool = False,
    trace_capacity: int = DEFAULT_TRACE_CAPACITY,
) -> SimResult:
    """Run one simulation on ``device`` (CUDA unless the caller asks for
    the CPU). ``workload`` is a fleet of one (``[1, ...]``, e.g. from
    ``bridge.workload_from_arrays``) or None for the seed generator.
    The result's state and workload have the lane axis squeezed.

    ``trace=True`` records an event trace of up to ``trace_capacity``
    records and decodes it into ``result.trace``
    (:class:`telemetry.TraceEvents`); the simulated state is the same
    bit for bit either way. On overflow the earliest records win and
    ``result.trace.events_dropped`` counts the rest."""
    params = load_params(paramfile)
    if engine is not None and engine != params.engine:
        params = params.replace(engine=engine)
    check_main_path(params)
    capacity = int(trace_capacity) if trace else 0
    if trace and capacity <= 0:
        raise ValueError(f"trace_capacity must be positive, got {trace_capacity}")
    device = resolve_device(device)
    wl = workload if workload is not None else get_workload(params, device=device)
    if params.fault_trace_active and wl.faults is None:
        # a bare workload (a trace or a caller's) under the chaos layer:
        # the fault trace comes from params.seed
        wl = attach_fault_trace(wl, params)
    _check_workload(wl, params)
    wl = workload_to(wl, device)
    if wl.arrival.shape[0] != 1:
        raise ValueError("run() takes a fleet of one; use fleet_run for more lanes")
    state, sched_state, events, tbuf = run_lane_major_engine(
        params, wl, params.scheduling_algo, capacity)
    return SimResult(
        state=SimState(*(x[0] for x in state)),
        workload=workload_lane(wl, 0),
        params=params,
        events=events,
        sched_state=tree_map(lambda x: x[0], sched_state),
        trace=None if tbuf is None else decode_lane(tbuf, 0),
    )


__all__ = [
    "SimResult",
    "check_main_path",
    "event_step",
    "fault_gate",
    "initial_sched_state",
    "resolve_device",
    "run",
    "run_lane_major_engine",
    "traced_event_step",
    "_next_event",
    "_next_event_registers",
    "_sorted_arrivals",
]
