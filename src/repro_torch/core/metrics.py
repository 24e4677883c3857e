"""Execution statistics of a finished simulation (paper Fig. 2): the
main-path keys of ``repro.core.metrics.summarize``. The statistics of the
later slices' layers (chaos, closed loop, telemetry) come with them."""
from __future__ import annotations

import numpy as np

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


def summarize(state: SimState, wl: Workload, params: SimParams) -> dict:
    """Statistics of one lane (per-lane shapes, no fleet axis)."""
    status = _np(state.pipe_status)
    arrival = _np(wl.arrival).astype(np.int64)
    completion = _np(state.pipe_completion).astype(np.int64)
    prio = _np(wl.prio)

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
        }

    dur_s = params.duration
    cap_cpu_s = float(np.sum(_np(state.pool_cpu_cap))) * dur_s
    cap_ram_s = float(np.sum(_np(state.pool_ram_cap))) * dur_s
    util_cpu = float(np.sum(_np(state.util_cpu_s)))
    util_ram = float(np.sum(_np(state.util_ram_s)))
    return {
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
        "bytes_moved_gb": float(state.bytes_moved_gb),
        "cache_lookups": int(state.cache_lookups),
        "cold_starts": int(state.cold_starts),
        "warm_starts": int(state.warm_starts),
        "goodput_per_s": float(np.sum(done)) / dur_s,
        "fairness_jain_latency": _jain(lat_s),
    }


__all__ = ["summarize"]
