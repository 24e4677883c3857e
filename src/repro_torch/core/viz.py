"""Execution-statistics visualisation (paper Fig. 2: "visualizers or
other downstream applications can access execution statistics").

Text/CSV renderings of the per-pool utilisation timeline (the bucketed
`util_log` integral) and the pipeline latency distribution — what a
platform engineer actually looks at after a policy simulation.

A copy of ``repro.core.viz``: the same text from equal states. Each
function reads the fields it draws from the result's state (on any
device) to the host once, with ``.cpu()``.
"""
from __future__ import annotations

import numpy as np

from .engine import SimResult
from .types import PipeStatus, Priority, TICKS_PER_SECOND


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy()

BLOCKS = " ▁▂▃▄▅▆▇█"


def utilization_timeline(res: SimResult, *, width: int = 64) -> str:
    """Unicode sparkline of CPU (and RAM) utilisation per pool."""
    log = _host(res.state.util_log)          # [B, NP, 2] resource-sec
    B, NP, _ = log.shape
    caps_c = _host(res.state.pool_cpu_cap)
    caps_r = _host(res.state.pool_ram_cap)
    bucket_s = res.params.duration / B
    lines = []
    # resample to `width` buckets; never upsample: with width > B the
    # linspace edges repeat and a bucket lands in several columns,
    # over-weighting it in the printed mean (regression in
    # tests/test_viz.py)
    width = min(width, B)
    ix = np.linspace(0, B, width + 1).astype(int)
    for pool in range(NP):
        for ri, (name, cap) in enumerate(
            (("cpu", caps_c[pool]), ("ram", caps_r[pool]))
        ):
            frac = []
            for i in range(width):
                seg = log[ix[i]: max(ix[i + 1], ix[i] + 1), pool, ri]
                denom = cap * bucket_s * max(len(seg), 1)
                frac.append(min(seg.sum() / denom, 1.0) if denom else 0.0)
            bars = "".join(BLOCKS[int(f * (len(BLOCKS) - 1))] for f in frac)
            lines.append(f"pool{pool} {name} |{bars}| "
                         f"mean {np.mean(frac) * 100:5.1f}%")
    return "\n".join(lines)


_GANTT_END = {
    "complete": "C", "preempt": "P", "oom": "O", "open": ">",
    "fault": "X", "timeout": "T",
}


def pipeline_gantt(res: SimResult, *, width: int = 64) -> str:
    """Trace-driven text Gantt: one row per pipeline, its container
    executions drawn on a shared time axis.

    Needs a telemetry trace (``run(..., trace=True)``); each span is a
    run of ``=`` from its START to its end event, terminated by ``C``
    (complete), ``P`` (preempt), ``O`` (oom), ``X`` (killed by an
    injected fault), ``T`` (wall-clock timeout) or ``>`` (still running
    at the end of the trace). Priorities are taken from the spans' end
    records.
    """
    trace = getattr(res, "trace", None)
    if trace is None:
        return "(no trace: run with trace=True to record spans)"
    spans = trace.spans()
    if not spans:
        return "(trace holds no container executions)"
    horizon = max(int(res.params.horizon_ticks), 1)

    def col(tick: int) -> int:
        return min(int(tick * width / horizon), width - 1)

    by_pipe: dict[int, list] = {}
    for s in spans:
        by_pipe.setdefault(s.pipe, []).append(s)
    prio_names = {int(p): p.name for p in Priority}
    lines = [
        f"{'pipeline':>8s} {'prio':11s} |{'time -> ' + ' ' * (width - 8)}| spans"
    ]
    for pipe in sorted(by_pipe):
        row = [" "] * width
        prio = -1
        for s in by_pipe[pipe]:
            lo, hi = col(s.start_tick), col(max(s.end_tick, s.start_tick))
            for c in range(lo, hi):
                row[c] = "="
            row[hi] = _GANTT_END.get(s.end_kind, "?")
            if s.priority >= 0:
                prio = s.priority
        lines.append(
            f"{pipe:8d} {prio_names.get(prio, '?'):11s} |{''.join(row)}| "
            f"{len(by_pipe[pipe])}"
        )
    if trace.events_dropped:
        lines.append(f"(trace overflow: {trace.events_dropped} events dropped)")
    return "\n".join(lines)


def latency_histogram(res: SimResult, *, bins: int = 10) -> str:
    comp = _host(res.state.pipe_completion)
    arr = _host(res.workload.arrival)
    done = _host(res.state.pipe_status) == int(PipeStatus.DONE)
    if not done.any():
        return "(no completed pipelines)"
    lat = (comp[done] - arr[done]) / TICKS_PER_SECOND
    hist, edges = np.histogram(lat, bins=bins)
    peak = hist.max() or 1
    lines = []
    for h, lo, hi in zip(hist, edges[:-1], edges[1:]):
        bar = "#" * int(40 * h / peak)
        lines.append(f"{lo:8.3f}-{hi:8.3f}s |{bar} {h}")
    return "\n".join(lines)


def per_priority_table(res: SimResult) -> str:
    s = res.summary()
    rows = [f"{'priority':12s} {'submitted':>9s} {'done':>6s} {'mean lat':>10s}"]
    for p in Priority:
        v = s["per_priority"][p.name.lower()]
        rows.append(
            f"{p.name:12s} {v['submitted']:9d} {v['done']:6d} "
            f"{v['mean_latency_s']:10.4f}"
        )
    return "\n".join(rows)


def timeline_csv(res: SimResult) -> str:
    """CSV: bucket_start_s, pool, cpu_util, ram_util."""
    log = _host(res.state.util_log)
    B, NP, _ = log.shape
    caps_c = _host(res.state.pool_cpu_cap)
    caps_r = _host(res.state.pool_ram_cap)
    bucket_s = res.params.duration / B
    out = ["t_s,pool,cpu_util,ram_util"]
    for b in range(B):
        for pool in range(NP):
            cu = log[b, pool, 0] / max(caps_c[pool] * bucket_s, 1e-12)
            ru = log[b, pool, 1] / max(caps_r[pool] * bucket_s, 1e-12)
            out.append(f"{b * bucket_s:.4f},{pool},{cu:.4f},{ru:.4f}")
    return "\n".join(out)


__all__ = [
    "utilization_timeline",
    "pipeline_gantt",
    "latency_histogram",
    "per_priority_table",
    "timeline_csv",
]
