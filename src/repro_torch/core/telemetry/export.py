"""Trace exporters: Perfetto/Chrome ``trace_event`` JSON and windowed
timeline metrics.

``to_perfetto_json`` emits the Chrome trace-event format (the JSON
flavour Perfetto and ``chrome://tracing`` both load): one *process* per
fleet lane, one *track* (thread) per pool carrying the pipeline
execution spans, instant markers for the point events, and counter
tracks for queue depth, CPU/RAM in use, and cache residency. Every
emitted event carries its schema kind in ``cat``, so per-kind counts
round-trip through the JSON (tests/test_torch_telemetry.py reconciles
them against ``summarize()``).

>>> from repro_torch import SimParams, run
>>> from repro_torch.core.telemetry import summarize_timeline, to_perfetto_json
>>> import json
>>> p = SimParams(duration=0.02, max_pipelines=8, max_containers=8,
...               max_ops_per_pipeline=4, waiting_ticks_mean=300.0,
...               op_base_seconds_mean=0.002)
>>> res = run(p, trace=True, device="cpu")
>>> doc = json.loads(to_perfetto_json(res.trace, res.params))
>>> sorted(doc) == ['displayTimeUnit', 'traceEvents']
True
>>> tl = summarize_timeline(res.trace, res.params, n_windows=4)
>>> len(tl['windows']), sorted(tl['overall'])[:2]
(4, ['backlog_max', 'backlog_p50'])
"""
from __future__ import annotations

import json

import numpy as np

from ..params import SimParams
from ..types import TICK_SECONDS
from .decode import TraceEvents
from .schema import COL_A, COL_PIPE, COL_POOL, COL_TICK, EventKind

_US_PER_TICK = TICK_SECONDS * 1e6

# point events rendered as instant markers on their pool track
_INSTANT_KINDS = (
    EventKind.ARRIVAL,
    EventKind.SCHED_DECISION,
    EventKind.COLD_START,
    EventKind.CACHE_HIT,
    EventKind.CACHE_MISS,
    EventKind.PREEMPT,
    EventKind.OOM,
    EventKind.REJECT,
    EventKind.FAULT,
    EventKind.POOL_DOWN,
    EventKind.POOL_UP,
    EventKind.TIMEOUT,
    EventKind.RETRY,
)


def to_perfetto_json(
    trace: TraceEvents,
    params: SimParams | None = None,
    *,
    lane: int = 0,
    max_counter_samples: int = 2048,
) -> str:
    """Chrome/Perfetto ``trace_event`` JSON for one lane's trace.

    Load the returned string (saved as a ``.json`` file) in
    https://ui.perfetto.dev or ``chrome://tracing``. ``lane`` sets the
    process id so per-lane exports of a fleet can be concatenated.
    Counter tracks are downsampled to ``max_counter_samples`` points;
    span and instant events are never dropped.
    """
    events: list[dict] = [
        {
            "name": "process_name",
            "ph": "M",
            "pid": lane,
            "args": {"name": f"eudoxia lane {lane}"},
        }
    ]
    pools = sorted({int(p) for p in trace.pool if p >= 0}) or [0]
    for pool in pools:
        events.append({
            "name": "thread_name",
            "ph": "M",
            "pid": lane,
            "tid": pool,
            "args": {"name": f"pool {pool}"},
        })

    # ---- pipeline spans on their pool track --------------------------------
    for s in trace.spans():
        events.append({
            "name": f"pipe {s.pipe}",
            "cat": "span",
            "ph": "X",
            "ts": s.start_tick * _US_PER_TICK,
            "dur": max(s.end_tick - s.start_tick, 1) * _US_PER_TICK,
            "pid": lane,
            "tid": max(s.pool, 0),
            "args": {
                "pipe": s.pipe,
                "priority": s.priority,
                "cpus": s.cpus,
                "ram_gb": s.ram_gb,
                "end": s.end_kind,
            },
        })
    # one countable event per COMPLETE record (spans can outlive a
    # truncated trace; the JSON still reconciles per-kind counts)
    for row in trace.of_kind(EventKind.COMPLETE):
        events.append({
            "name": f"pipe {int(row[COL_PIPE])} done",
            "cat": "complete",
            "ph": "i",
            "s": "t",
            "ts": int(row[COL_TICK]) * _US_PER_TICK,
            "pid": lane,
            "tid": max(int(row[COL_POOL]), 0),
        })

    # ---- instant markers ---------------------------------------------------
    for kind in _INSTANT_KINDS:
        for row in trace.of_kind(kind):
            events.append({
                "name": f"{kind.name.lower()} pipe {int(row[COL_PIPE])}",
                "cat": kind.name.lower(),
                "ph": "i",
                "s": "t",
                "ts": int(row[COL_TICK]) * _US_PER_TICK,
                "pid": lane,
                "tid": max(int(row[COL_POOL]), 0),
                "args": {"a": int(row[COL_A])},
            })

    # ---- counter tracks ----------------------------------------------------
    ticks, qdepth, free_cpu, free_ram, cache_gb = trace.series()
    stride = max(1, int(np.ceil(len(ticks) / max_counter_samples)))
    sel = np.arange(0, len(ticks), stride)
    cpu_cap = ram_cap = None
    if params is not None:
        factor = params.cloud_scale_max_factor if params.cloud_scaling else 1.0
        cpu_cap = params.total_cpus * factor
        ram_cap = params.total_ram_gb * factor
    for i in sel:
        ts = int(ticks[i]) * _US_PER_TICK
        counters = {"queue_depth": int(qdepth[i])}
        if cpu_cap is not None:
            counters["cpus_in_use"] = round(cpu_cap - float(free_cpu[i]), 4)
            counters["ram_gb_in_use"] = round(
                ram_cap - float(free_ram[i]), 4
            )
        else:
            counters["free_cpu"] = round(float(free_cpu[i]), 4)
            counters["free_ram_gb"] = round(float(free_ram[i]), 4)
        counters["cache_gb"] = round(float(cache_gb[i]), 4)
        for name, value in counters.items():
            events.append({
                "name": name,
                "cat": "counter",
                "ph": "C",
                "ts": ts,
                "pid": lane,
                "args": {"value": value},
            })

    return json.dumps(
        {"traceEvents": events, "displayTimeUnit": "ms"}, indent=None
    )


def summarize_timeline(
    trace: TraceEvents,
    params: SimParams,
    *,
    n_windows: int = 8,
) -> dict:
    """Windowed latency and backlog percentiles from one lane's trace.

    The horizon splits into ``n_windows`` equal windows; each reports
    completion count, p50/p99 end-to-end latency of the pipelines that
    *completed* in the window (arrival taken from their ARRIVAL
    records), and p50/p99/max queue depth over the records sampled in
    the window. ``overall`` aggregates the same statistics across the
    whole run.
    """
    horizon = max(params.horizon_ticks, 1)
    edges = np.linspace(0, horizon, n_windows + 1)

    arrivals = trace.of_kind(EventKind.ARRIVAL)
    arrival_tick = {
        int(r[COL_PIPE]): int(r[COL_TICK]) for r in arrivals[::-1]
    }  # first arrival wins (end-to-end latency incl. OOM retries)
    completes = trace.of_kind(EventKind.COMPLETE)
    comp_ticks = completes[:, COL_TICK].astype(np.int64)
    lat_s = np.array([
        (int(r[COL_TICK]) - arrival_tick.get(int(r[COL_PIPE]), 0))
        * TICK_SECONDS
        for r in completes
    ])
    qd_ticks = trace.tick.astype(np.int64)
    qd = trace.queue_depth

    def _pct(x, q):
        return float(np.percentile(x, q)) if len(x) else float("nan")

    windows = []
    for lo, hi in zip(edges[:-1], edges[1:]):
        in_w = (comp_ticks >= lo) & (comp_ticks < hi)
        qd_w = qd[(qd_ticks >= lo) & (qd_ticks < hi)]
        windows.append({
            "t0_s": lo * TICK_SECONDS,
            "t1_s": hi * TICK_SECONDS,
            "completed": int(np.sum(in_w)),
            "p50_latency_s": _pct(lat_s[in_w], 50),
            "p99_latency_s": _pct(lat_s[in_w], 99),
            "backlog_p50": _pct(qd_w, 50),
            "backlog_p99": _pct(qd_w, 99),
            "backlog_max": int(qd_w.max()) if len(qd_w) else 0,
        })
    return {
        "n_windows": n_windows,
        "window_s": horizon * TICK_SECONDS / n_windows,
        "windows": windows,
        "overall": {
            "completed": int(len(lat_s)),
            "p50_latency_s": _pct(lat_s, 50),
            "p99_latency_s": _pct(lat_s, 99),
            "backlog_p50": _pct(qd, 50),
            "backlog_p99": _pct(qd, 99),
            "backlog_max": int(qd.max()) if len(qd) else 0,
            "events_dropped": trace.events_dropped,
        },
    }


__all__ = ["to_perfetto_json", "summarize_timeline"]
