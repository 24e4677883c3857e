"""Execution statistics of a finished simulation (paper Fig. 2): the keys
of ``repro.core.metrics.summarize``, the data plane's, the chaos layer's
and the overload layer's among them (zero counters and NaN ratios where
a layer is off)."""
from __future__ import annotations

import numpy as np
import torch

from .params import SimParams
from .state import SimState, Workload
from .types import INF_TICK, TICKS_PER_SECOND, PipeStatus, Priority


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy()


def _jain(x) -> float:
    """Jain's fairness index (Σx)²/(n·Σx²); NaN for an empty or all-zero
    vector."""
    x = np.asarray(x, np.float64)
    x = x[np.isfinite(x)]
    if x.size == 0:
        return float("nan")
    s2 = float(np.sum(x * x))
    if s2 <= 0:
        return float("nan")
    return float(np.sum(x)) ** 2 / (x.size * s2)


def _slo_attainment(params, prio, arrival, completion, done) -> dict:
    """Per priority, the fraction of submitted pipelines that completed
    within ``params.slo_latency_s``; NaN for a class without a target
    (0) or without submissions."""
    out = {}
    lat_s = (completion - arrival) / TICKS_PER_SECOND
    for p in Priority:
        target = params.slo_latency_s[int(p)] if int(p) < len(params.slo_latency_s) else 0.0
        sel = (arrival < INF_TICK) & (prio == int(p))
        n = int(np.sum(sel))
        if target <= 0 or n == 0:
            out[p.name.lower()] = float("nan")
        else:
            out[p.name.lower()] = float(np.sum(sel & done & (lat_s <= target))) / n
    return out


def _closed_loop_stats(state: SimState, params: SimParams, dur_s: float) -> dict:
    """The overload statistics: zero counters and NaN ratios with the
    closed loop off. ``retry_amplification`` is offers per distinct
    pipeline offered; ``time_to_drain_s`` runs from the last fault to the
    backlog's return to its pre-fault level; ``metastable`` means it had
    not returned within ``metastable_window_ticks`` (0: by the end)."""
    offered = int(state.offered_total)
    unique = int(state.offered_unique)
    admitted = int(state.admitted_total)
    last_fault = int(state.last_fault_tick)
    drain = int(state.drain_tick)
    had_fault = last_fault < INF_TICK
    drained = drain < INF_TICK
    window = params.metastable_window_ticks
    if not had_fault:
        metastable = False
    elif window > 0:
        metastable = (not drained) or (drain - last_fault > window)
    else:
        metastable = not drained
    return {
        "offered": offered,
        "admitted": admitted,
        "shed": int(state.shed_total),
        "deferred": int(state.deferred_total),
        "client_retries": int(state.client_retry_events),
        "offered_load_per_s": offered / dur_s,
        "admitted_fraction": admitted / offered if offered else float("nan"),
        "retry_amplification": offered / unique if unique else float("nan"),
        "time_to_drain_s": (drain - last_fault) / TICKS_PER_SECOND
        if had_fault and drained else float("nan"),
        "metastable": bool(metastable),
    }


def summarize(state: SimState, wl: Workload, params: SimParams, trace=None) -> dict:
    """Statistics of one lane (per-lane shapes, no fleet axis); with the
    lane's ``trace`` (``telemetry.TraceEvents``) also ``trace_enabled``
    and the recorder's ``events_dropped``."""
    status = _np(state.pipe_status)
    arrival = _np(wl.arrival).astype(np.int64)
    completion = _np(state.pipe_completion).astype(np.int64)
    prio = _np(wl.prio)
    offered_prio = _np(state.offered_prio)
    admitted_prio = _np(state.admitted_prio)

    submitted = arrival < INF_TICK
    done = status == int(PipeStatus.DONE)
    failed = status == int(PipeStatus.FAILED)
    lat_s = (completion - arrival)[done] / TICKS_PER_SECOND

    def stat(fn, x):
        return float(fn(x)) if x.size else float("nan")

    per_prio = {}
    for p in Priority:
        sel = done & (prio == int(p))
        sel_lat = (completion - arrival)[sel] / TICKS_PER_SECOND
        per_prio[p.name.lower()] = {
            "done": int(np.sum(sel)),
            "submitted": int(np.sum(submitted & (prio == int(p)))),
            "mean_latency_s": stat(np.mean, sel_lat),
            "p99_latency_s": stat(lambda v: np.percentile(v, 99), sel_lat),
            "admitted_fraction": float(admitted_prio[int(p)]) / float(offered_prio[int(p)])
            if offered_prio[int(p)] > 0 else float("nan"),
        }

    dur_s = params.duration
    cap_cpu_s = float(np.sum(_np(state.pool_cpu_cap))) * dur_s
    cap_ram_s = float(np.sum(_np(state.pool_ram_cap))) * dur_s
    util_cpu = float(np.sum(_np(state.util_cpu_s)))
    util_ram = float(np.sum(_np(state.util_ram_s)))
    hit_gb, moved_gb = float(state.cache_hit_gb), float(state.bytes_moved_gb)
    outages = int(state.outage_events)
    out = {
        "submitted": int(np.sum(submitted)),
        "done": int(np.sum(done)),
        "failed": int(np.sum(failed)),
        "in_flight": int(np.sum(
            submitted & ~done & ~failed & (status != int(PipeStatus.EMPTY))
        )),
        "throughput_per_s": float(np.sum(done)) / dur_s,
        "mean_latency_s": stat(np.mean, lat_s),
        "p50_latency_s": stat(lambda v: np.percentile(v, 50), lat_s),
        "p99_latency_s": stat(lambda v: np.percentile(v, 99), lat_s),
        "oom_events": int(state.oom_events),
        "preempt_events": int(state.preempt_events),
        "cpu_utilization": util_cpu / cap_cpu_s if cap_cpu_s else 0.0,
        "ram_utilization": util_ram / cap_ram_s if cap_ram_s else 0.0,
        "cost_dollars": float(state.cost_dollars),
        "per_priority": per_prio,
        # data plane
        "cache_hit_gb": hit_gb,
        "bytes_moved_gb": moved_gb,
        "cache_hit_rate": hit_gb / (hit_gb + moved_gb) if hit_gb + moved_gb > 0 else 0.0,
        "cache_hits": int(state.cache_hits),
        "cache_lookups": int(state.cache_lookups),
        "cache_resident_gb": float(np.sum(_np(state.pool_cache_used))),
        "cold_starts": int(state.cold_starts),
        "warm_starts": int(state.warm_starts),
        "cold_start_ticks": int(state.cold_start_tick_total),
        "cold_start_s": float(state.cold_start_tick_total) / TICKS_PER_SECOND,
        # chaos layer
        "faults_injected": int(state.crash_events) + outages,
        "crash_events": int(state.crash_events),
        "outage_events": outages,
        "fault_kills": int(state.fault_kills),
        "timeouts": int(state.timeout_events),
        "retries": int(state.retry_events),
        "wasted_work_s": float(state.wasted_ticks) / TICKS_PER_SECOND,
        "pool_down_s": float(state.pool_down_s),
        "mttr_s": float(state.pool_down_s) / outages if outages > 0 else float("nan"),
        "goodput_per_s": float(np.sum(done)) / dur_s,
        "slo_attainment": _slo_attainment(params, prio, arrival, completion, done),
    }
    out.update(_closed_loop_stats(state, params, dur_s))
    out["fairness_jain_latency"] = _jain(lat_s)
    offered = offered_prio > 0
    out["fairness_jain_admission"] = _jain(
        admitted_prio[offered] / np.maximum(offered_prio[offered], 1)
    )
    if trace is not None:
        out["trace_enabled"] = True
        out["events_dropped"] = int(trace.events_dropped)
    return out


def fleet_lane_stats(states: SimState, params: SimParams, arrival=None) -> dict[str, np.ndarray]:
    """Per-lane fleet statistics as ``[F]`` numpy arrays (the policy
    search's objectives), as ``repro.core.metrics.fleet_lane_stats``.
    ``arrival`` is the batch's ``[F, MP]`` arrival table; without it the
    latency columns are NaN. Empty lanes report NaN latency. The
    ``censored_*`` columns count every arrived pipeline, an unfinished
    one at ``horizon - arrival``."""
    status = _np(states.pipe_status)
    completion = _np(states.pipe_completion).astype(np.float64)
    done_mask = status == int(PipeStatus.DONE)
    done = done_mask.sum(axis=1)
    dur_s = params.duration

    F = status.shape[0]
    mean_lat = np.full((F,), np.nan)
    p99_lat = np.full((F,), np.nan)
    cens_mean = np.full((F,), np.nan)
    cens_p99 = np.full((F,), np.nan)
    if arrival is not None:
        arrival = (_np(arrival) if isinstance(arrival, torch.Tensor) else np.asarray(arrival))
        arrival = arrival.astype(np.float64)
        arrived = arrival < float(INF_TICK)
        horizon = float(params.horizon_ticks)
        lat_s = (completion - arrival) / TICKS_PER_SECOND
        cens_s = (np.where(done_mask, completion, horizon) - arrival) / TICKS_PER_SECOND
        for i in range(F):
            lane = lat_s[i][done_mask[i]]
            if lane.size:
                mean_lat[i] = lane.mean()
                p99_lat[i] = np.percentile(lane, 99)
            clane = cens_s[i][arrived[i]]
            if clane.size:
                cens_mean[i] = clane.mean()
                cens_p99[i] = np.percentile(clane, 99)

    cap_cpu_s = np.sum(_np(states.pool_cpu_cap), axis=-1) * dur_s
    util_cpu = np.sum(_np(states.util_cpu_s), axis=-1)
    return {
        "done": done.astype(np.int64),
        "failed": (status == int(PipeStatus.FAILED)).sum(axis=1),
        "throughput_per_s": done / dur_s,
        "mean_latency_s": mean_lat,
        "p99_latency_s": p99_lat,
        "censored_mean_latency_s": cens_mean,
        "censored_p99_latency_s": cens_p99,
        "cpu_utilization": np.where(cap_cpu_s > 0, util_cpu / np.maximum(cap_cpu_s, 1e-12), 0.0),
        "cost_dollars": _np(states.cost_dollars).astype(np.float64),
        "oom_events": _np(states.oom_events).astype(np.int64),
        "preempt_events": _np(states.preempt_events).astype(np.int64),
    }


def completion_table(state: SimState, wl: Workload) -> np.ndarray:
    """``[MP, 4]`` of one lane (per-lane shapes, as ``SimResult`` holds
    them): (arrival, completion, status, priority)."""
    return np.stack(
        [_np(wl.arrival), _np(state.pipe_completion), _np(state.pipe_status), _np(wl.prio)],
        axis=1,
    )


__all__ = ["summarize", "completion_table", "fleet_lane_stats"]
