"""Simulation fleets: many lanes in one lane-major run.

``fleet_run`` advances ``len(seeds)`` generated lanes, or a caller-built
``[F, ...]`` workload batch (seed-generated, or one recorded trace per
lane from ``workload_batch_from_traces``), in one engine loop; lane
``i`` of the result equals ``run()`` on lane ``i``'s workload.

``shard=`` resolves as the reference's does (``None`` one device,
``"auto"`` every local device, ``n`` the first n) against
``torch.cuda.device_count()``, a CPU run counting as one device. On one
card the fleet runs whole; spreading it over several (with the lanes
binned by event density, ``bin_lanes_by_density``, and padded to a
multiple of the devices, ``pad_lanes``) is ROADMAP queue 1, item 16.
``fleet_summary`` aggregates a fleet's final states. With
``trace=True`` every lane records its events (``core/telemetry``) and
``fleet_run`` returns ``(states, traces)``. A fleet always runs the
lane-major event engine, whatever ``params.engine`` says, as in the
reference (the Python engine is ``run(engine="python")``'s alone).
"""
from __future__ import annotations

from typing import Any, Sequence

import numpy as np
import torch

from . import metrics
from .engine import _check_workload, check_main_path, resolve_device, run_lane_major_engine
from .faults import attach_fault_traces
from .params import SimParams
from .policy import N_POLICY_PARAMS, PolicyParams
from .state import SimState, Workload, tree_map, workload_to
from .telemetry.decode import decode_fleet
from .telemetry.schema import DEFAULT_TRACE_CAPACITY
from .types import INF_TICK, TICKS_PER_SECOND
from .workload import generate_workload, workload_batch_from_traces  # noqa: F401  (batch ingestion pairs with fleet_run)


def make_workload_batch(
    params: SimParams, seeds: Sequence[int], *, device="cpu"
) -> Workload:
    """One seed-generated workload per lane (lane ``i`` is
    ``generate_workload(params, seeds[i])``, its fault trace included)."""
    lanes = [generate_workload(params, s) for s in seeds]
    return workload_to(tree_map(lambda *parts: torch.cat(parts), *lanes), device)


def _policy_matrix(policies) -> torch.Tensor:
    """``policies`` (a ``PolicyParams``, a sequence of them, or an array)
    as an f32 tensor on the CPU."""
    if isinstance(policies, PolicyParams):
        policies = policies.to_vector()
    elif isinstance(policies, (list, tuple)) and policies and isinstance(
        policies[0], PolicyParams
    ):
        policies = np.stack([p.to_vector() for p in policies])
    if isinstance(policies, torch.Tensor):
        return policies.detach().to("cpu", torch.float32)
    return torch.from_numpy(np.asarray(policies, np.float32))


def attach_policies(wls: Workload, policies) -> Workload:
    """Attach ``PolicyParams`` vectors to a workload batch for the
    dynamic ``"policy"`` scheduler: ``[F, P]`` (one per lane), a single
    ``[P]`` vector broadcast to every lane, a ``PolicyParams`` or a
    sequence of them. The vectors ride the workload, so ``pad_lanes``
    and ``bin_lanes_by_density`` carry them like any other lane field."""
    pol = _policy_matrix(policies)
    F = wls.arrival.shape[0]
    if pol.dim() == 1:
        pol = pol.expand(F, pol.shape[0])
    if tuple(pol.shape) != (F, N_POLICY_PARAMS):
        raise ValueError(
            f"policies must be [{F}, {N_POLICY_PARAMS}] (one PolicyParams "
            f"vector per lane) or a single [{N_POLICY_PARAMS}] vector, "
            f"got {tuple(pol.shape)}"
        )
    return wls._replace(policy=pol.contiguous().to(wls.arrival.device))


def policy_grid_workloads(wls: Workload, policies) -> tuple[Workload, int, int]:
    """Tile an ``[S, ...]`` scenario batch across a ``[C, P]`` policy grid
    (or a sequence of ``PolicyParams``). Returns ``(grid_wls, C, S)``:
    lane ``c*S + s`` of ``grid_wls`` runs scenario ``s`` under candidate
    ``c``, so one ``fleet_run(scheduler_key="policy")`` evaluates the
    whole grid."""
    pol = _policy_matrix(policies)
    if pol.dim() != 2 or pol.shape[1] != N_POLICY_PARAMS:
        raise ValueError(
            f"policies must be a [C, {N_POLICY_PARAMS}] grid, got {tuple(pol.shape)}"
        )
    if wls.policy is not None:
        raise ValueError(
            "scenario batch already carries policy vectors; build the "
            "grid from a policy-free batch"
        )
    C, S = int(pol.shape[0]), int(wls.arrival.shape[0])
    tiled = tree_map(lambda x: x.repeat((C,) + (1,) * (x.dim() - 1)), wls)
    grid = pol.repeat_interleave(S, dim=0).to(wls.arrival.device)
    return tiled._replace(policy=grid), C, S


def pad_lanes(wls: Workload, n_lanes: int) -> Workload:
    """Pad the fleet axis of ``wls`` up to ``n_lanes`` with copies of lane
    0 whose arrivals (and crashes and outage starts) are all INF_TICK:
    a padding lane retires in one event."""
    F = wls.arrival.shape[0]
    pad = n_lanes - F
    if pad <= 0:
        return wls
    padded = tree_map(
        lambda x: torch.cat([x, x[:1].expand((pad,) + tuple(x.shape[1:]))]), wls)
    # every field is a new tensor (cat): set the padding's events in place
    padded.arrival[F:] = INF_TICK
    if padded.faults is not None:
        padded.faults.crash_time[F:] = INF_TICK
        padded.faults.outage_start[F:] = INF_TICK
    return padded


def predicted_lane_events(wls: Workload, params: SimParams) -> np.ndarray:
    """Per-lane predicted event count, the binning key: the arrivals
    inside the horizon (each admits and retires once)."""
    counts = (wls.arrival < params.horizon_ticks).sum(-1, dtype=torch.int32)
    return counts.cpu().numpy()


def bin_lanes_by_density(wls: Workload, params: SimParams) -> tuple[Workload, np.ndarray]:
    """Sort the fleet axis by predicted event count, heaviest first (a
    stable sort: equal lanes keep their order); returns ``(sorted_wls,
    inverse_permutation)``."""
    score = predicted_lane_events(wls, params)
    order = np.argsort(-score, kind="stable")
    inv = np.argsort(order)
    index = torch.from_numpy(order).to(wls.arrival.device)
    return tree_map(lambda x: x[index], wls), inv


def _unbin_states(states: SimState, inv) -> SimState:
    """Undo the binning permutation, dropping padding lanes (``inv``
    addresses only the real lanes, which binning sorted ahead of the
    padding): one index per field."""
    index = torch.as_tensor(inv, device=states.tick.device)
    return SimState(*(x[index] for x in states))


def _resolve_shards(shard, fleet_size: int, device: torch.device | None = None) -> int:
    """The devices ``shard`` asks for, capped by the fleet's lanes; the
    local devices are the CUDA cards (a CPU run counts as one)."""
    if shard is None:
        return 1
    on_cuda = device is not None and torch.device(device).type == "cuda"
    n_dev = torch.cuda.device_count() if on_cuda else 1
    n = n_dev if shard == "auto" else int(shard)
    if n > n_dev:
        raise ValueError(
            f"shard={shard!r} asks for {n} devices but only {n_dev} are local"
        )
    return max(1, min(n, fleet_size))


def fleet_run(
    params: SimParams,
    seeds: Sequence[int] | None = None,
    scheduler_key: str | None = None,
    *,
    workloads: Workload | None = None,
    device: Any = "cuda",
    shard: str | int | None = None,
    bin_lanes: bool = True,
    trace: bool = False,
    trace_capacity: int | None = None,
):
    """Run a fleet on ``device`` (CUDA unless the caller asks for the
    CPU); exactly one of ``seeds`` / ``workloads`` is given. Returns the
    batched final state (leading axis = lane), or ``(states, traces)``
    with ``trace=True``: ``traces`` one ``telemetry.TraceEvents`` a lane,
    of up to ``trace_capacity`` records (``DEFAULT_TRACE_CAPACITY`` when
    None). ``shard`` resolves as in the reference; a fleet spread over
    more than one device (where ``bin_lanes`` would bin its lanes first)
    waits for ROADMAP queue 1, item 16."""
    if (seeds is None) == (workloads is None):
        raise ValueError(
            "fleet_run needs exactly one of seeds= (generated lanes) or "
            "workloads= (a caller-built batch)"
        )
    check_main_path(params)
    capacity = 0
    if trace:
        capacity = int(DEFAULT_TRACE_CAPACITY if trace_capacity is None else trace_capacity)
        if capacity <= 0:
            raise ValueError(f"trace_capacity must be positive, got {trace_capacity}")
    device = resolve_device(device)
    if workloads is None:
        workloads = make_workload_batch(params, seeds)
    n_shards = _resolve_shards(shard, workloads.arrival.shape[0], device)
    if n_shards > 1:
        raise NotImplementedError(
            f"shard={shard!r} spreads the fleet over {n_shards} devices: that waits "
            "for ROADMAP queue 1, item 16 (distribution); one device runs it whole"
        )
    if params.fault_trace_active and workloads.faults is None:
        # a caller's batch carries no traces: each lane's comes from
        # params.seed and its lane index
        workloads = attach_fault_traces(workloads, params)
    _check_workload(workloads, params)
    wls = workload_to(workloads, device)
    states, _, _, tbuf = run_lane_major_engine(
        params, wls, scheduler_key or params.scheduling_algo, capacity
    )
    if capacity:
        return states, _decode_traces(tbuf)
    return states


def _decode_traces(tbuf):
    """Every lane's ``TraceEvents``; only the populated prefix of the
    tables (up to the fleet's largest count, rounded up to a power of
    two) leaves the device."""
    counts = _np(tbuf.count)
    cap = int(tbuf.records.shape[1])
    hi = int(counts.max(initial=0))
    keep = min(cap, 1 << max(hi - 1, 0).bit_length()) if hi else 0
    if keep < cap:
        tbuf = tbuf._replace(records=tbuf.records[:, :keep])
    return decode_fleet(tbuf, capacity=cap)


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy()


def fleet_summary(states: SimState, params: SimParams, traces=None) -> dict:
    """Fleet statistics (mean / std over the lanes) of ``repro.core.
    fleet_summary``; with ``traces`` (``fleet_run(..., trace=True)``'s)
    also the recorder's fleet-total overflow, ``events_dropped_total``."""
    done = _np(states.done_count)
    lat = _np(states.sum_latency_s) / np.maximum(done, 1)
    util = _np(states.util_cpu_s).sum(-1) / (params.total_cpus * params.duration)

    def mean(name):
        return float(_np(getattr(states, name)).mean())

    out = {
        "fleet_size": int(done.shape[0]),
        "throughput_per_s_mean": float(done.mean() / params.duration),
        "throughput_per_s_std": float(done.std() / params.duration),
        "mean_latency_s_mean": float(lat.mean()),
        "mean_latency_s_std": float(lat.std()),
        "cpu_utilization_mean": float(util.mean()),
        "oom_events_mean": mean("oom_events"),
        "preempt_events_mean": mean("preempt_events"),
        "cost_dollars_mean": mean("cost_dollars"),
        "cache_hit_gb_mean": mean("cache_hit_gb"),
        "bytes_moved_gb_mean": mean("bytes_moved_gb"),
        "cache_hit_rate_mean": _fleet_hit_rate(states),
        "cold_starts_mean": mean("cold_starts"),
        "warm_starts_mean": mean("warm_starts"),
        "crash_events_mean": mean("crash_events"),
        "outage_events_mean": mean("outage_events"),
        "fault_kills_mean": mean("fault_kills"),
        "timeouts_mean": mean("timeout_events"),
        "retries_mean": mean("retry_events"),
        "failed_mean": mean("failed_count"),
        "wasted_work_s_mean": float(_np(states.wasted_ticks).mean() / TICKS_PER_SECOND),
        "pool_down_s_mean": mean("pool_down_s"),
    }
    offered = _np(states.offered_total).astype(np.float64)
    admitted = _np(states.admitted_total).astype(np.float64)
    out.update({
        "offered_mean": float(offered.mean()),
        "admitted_mean": float(admitted.mean()),
        "shed_mean": mean("shed_total"),
        "deferred_mean": mean("deferred_total"),
        "client_retries_mean": mean("client_retry_events"),
        "admitted_fraction_mean": float((admitted[offered > 0] / offered[offered > 0]).mean())
        if np.any(offered > 0) else float("nan"),
        "fairness_jain_done": metrics._jain(done),
    })
    if traces is not None:
        out["events_dropped_total"] = int(sum(t.events_dropped for t in traces))
    return out


def _fleet_hit_rate(states: SimState) -> float:
    hit = _np(states.cache_hit_gb).astype(np.float64)
    moved = _np(states.bytes_moved_gb).astype(np.float64)
    total = hit + moved
    rates = np.where(total > 0, hit / np.maximum(total, 1e-12), 0.0)
    return float(rates.mean())


__all__ = [
    "attach_policies",
    "bin_lanes_by_density",
    "fleet_run",
    "fleet_summary",
    "make_workload_batch",
    "pad_lanes",
    "policy_grid_workloads",
    "predicted_lane_events",
    "workload_batch_from_traces",
]
