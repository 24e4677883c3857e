"""The lane-major simulation core, as a Python loop over events.

The reference's engine is one ``lax.while_loop`` over a vmapped lane
step. Here every field is a ``[F, ...]`` tensor and the loop is Python:

* each iteration is one event for every lane still running: the
  ``fleet_tick`` phase-1 read, :func:`executor.apply_fused_phase1`, the
  scheduler, :func:`executor.apply_decision`, the jump to the lane's
  next event from the ``nxt_retire`` / ``nxt_release`` registers and
  the sorted arrivals, and the utilisation integral over the jump;
* finished lanes pass through untouched (the reference's ``keep`` mask);
* the loop ends when no lane has ``tick < horizon``: one host read per
  event.

``run()`` is a fleet of one; ``sweep.fleet_run`` the F-lane case.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from . import executor
from .params import SimParams, load_params
from .scheduler import SchedDecision, get_scheduler
from .state import SimState, Workload, init_state
from .types import INF_TICK, ContainerStatus, PipeStatus
from .workload import get_workload
from ..kernels.sim_tick import fleet_tick


@dataclasses.dataclass
class SimResult:
    state: SimState        # lane axis squeezed: per-lane shapes
    workload: Workload     # likewise
    params: SimParams
    events: int = 0        # engine loop iterations

    def summary(self) -> dict:
        from .metrics import summarize

        return summarize(self.state, self.workload, self.params)


def _raise_later(what: str, slice_: str):
    raise NotImplementedError(f"{what} waits for ROADMAP queue 1, {slice_}")


# the knobs of the layers later slices bring, by their ROADMAP item; any
# of them away from its default raises, even where the reference would
# leave it inert (a retry budget with no fault source)
_LATER_KNOBS = {
    "item 9 (the data plane)": (
        "cache_gb_per_pool", "scan_ticks_per_gb", "cold_start_ticks",
    ),
    "item 10 (chaos layer)": (
        "crash_mtbf_ticks", "outage_mtbf_ticks", "outage_duration_ticks",
        "straggler_prob", "straggler_factor", "timeout_ticks", "max_retries",
        "base_backoff_ticks", "max_fault_events",
    ),
    "item 11 (closed loop)": (
        "client_max_inflight", "client_think_ticks", "client_max_retries",
        "client_backoff_ticks", "admit_queue_limit", "admit_rate_per_s",
        "admit_burst", "codel_target_ticks", "codel_interval_ticks",
    ),
}
_DEFAULTS = SimParams()


def check_main_path(params: SimParams) -> None:
    """Raise ``NotImplementedError`` for any optional layer this slice
    does not port, naming the ROADMAP item that brings it."""
    if params.engine != "event":
        _raise_later(f"engine={params.engine!r}", "item 14 (the paper's surface)")
    if params.trace_path:
        _raise_later("trace_path (trace ingestion)", "item 3")
    if params.admission_active:
        _raise_later(f"admission_policy={params.admission_policy!r}", "item 11 (closed loop)")
    for item, knobs in _LATER_KNOBS.items():
        changed = [k for k in knobs if getattr(params, k) != getattr(_DEFAULTS, k)]
        if changed:
            _raise_later(", ".join(changed), item)


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
    nxt = torch.where(acted, torch.minimum(nxt, tick + 1), nxt)
    return torch.maximum(nxt, tick + 1)


def _acted(dec: SchedDecision) -> torch.Tensor:
    return dec.suspend.any(-1) | dec.reject.any(-1) | (dec.assign_pipe >= 0).any(-1)


def _lane_decide(params, scheduler_fn, state, wl, arr_sorted, tick, active,
                 edges):
    """From the scheduler on, for every lane: decide, apply, jump to the
    next event and integrate over the jump. Returns ``(state, dec)``."""
    dec = scheduler_fn(state, wl, params, active)
    state = executor.apply_decision(state, wl, dec, tick, params)
    nxt, cursor = _next_event_registers(state, arr_sorted, tick, _acted(dec))
    nxt = torch.clamp_max(nxt, params.horizon_ticks)
    state = executor.integrate(state, tick, nxt, params, edges)
    return state._replace(tick=nxt, nxt_arrival_cursor=cursor), dec


def event_step(params, scheduler_fn, state, wl, arr_sorted, edges, active):
    """One event for every lane: phase 1, then :func:`_lane_decide`.
    Returns the advanced state (finished lanes not yet masked) and the
    decision."""
    tick = state.tick
    ph = fleet_tick(
        state.ctr_status, state.ctr_end, state.ctr_oom,
        state.ctr_cpus, state.ctr_ram, state.ctr_pool,
        state.pipe_status, wl.arrival, state.pipe_release,
        tick, num_pools=params.num_pools,
    )
    state = executor.apply_fused_phase1(state, wl, tick, params, ph)
    return _lane_decide(params, scheduler_fn, state, wl, arr_sorted, tick,
                        active, edges)


def _keep(active: torch.Tensor, new: SimState, old: SimState) -> SimState:
    def sel(n, o):
        return torch.where(active.reshape((-1,) + (1,) * (n.dim() - 1)), n, o)

    return SimState(*(sel(n, o) for n, o in zip(new, old)))


def run_lane_major_engine(
    params: SimParams, wls: Workload, scheduler_key: str
) -> tuple[SimState, int]:
    """Advance the whole batch ``wls`` ``[F, ...]`` to the horizon.
    Returns the final fleet state and the number of loop iterations."""
    scheduler_fn = get_scheduler(scheduler_key)
    device = wls.arrival.device
    F = wls.arrival.shape[0]
    horizon = params.horizon_ticks
    arr_sorted = _sorted_arrivals(wls.arrival)
    edges = executor.bucket_edges(params, device)
    states = init_state(params, F, device)
    events = 0
    while True:
        active = states.tick < horizon
        if not bool(active.any()):
            return states, events
        new, _ = event_step(params, scheduler_fn, states, wls, arr_sorted,
                            edges, active)
        states = _keep(active, new, states)
        events += 1


def _check_workload(wl: Workload, params: SimParams) -> None:
    if wl.faults is not None or wl.policy is not None:
        raise NotImplementedError(
            "workloads with fault traces or policy vectors wait for ROADMAP "
            "queue 1, items 9 and 10"
        )
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


def run(
    paramfile: str | dict | SimParams,
    workload: Workload | None = None,
    engine: str | None = None,
    *,
    device: Any = "cuda",
    trace: bool = False,
) -> SimResult:
    """Run one simulation on ``device`` (CUDA unless the caller asks for
    the CPU). ``workload`` is a fleet of one (``[1, ...]``, e.g. from
    ``bridge.workload_from_arrays``) or None for the seed generator.
    The result's state and workload have the lane axis squeezed."""
    params = load_params(paramfile)
    if engine is not None and engine != params.engine:
        params = params.replace(engine=engine)
    if trace:
        _raise_later("trace=True (telemetry)", "item 12")
    check_main_path(params)
    device = resolve_device(device)
    wl = workload if workload is not None else get_workload(params, device=device)
    _check_workload(wl, params)
    wl = Workload(*(x.to(device).contiguous() for x in wl[:10]))
    if wl.arrival.shape[0] != 1:
        raise ValueError("run() takes a fleet of one; use fleet_run for more lanes")
    state, events = run_lane_major_engine(params, wl, params.scheduling_algo)
    return SimResult(
        state=SimState(*(x[0] for x in state)),
        workload=Workload(*(x[0] for x in wl[:10])),
        params=params,
        events=events,
    )


__all__ = [
    "SimResult",
    "check_main_path",
    "event_step",
    "resolve_device",
    "run",
    "run_lane_major_engine",
    "_next_event",
    "_next_event_registers",
    "_sorted_arrivals",
]
