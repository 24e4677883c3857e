"""The scenario families: named workload generators beyond the paper.

The paper's generator (§3.2.1) is a single open-loop process —
exponential inter-arrivals at one fixed rate, one priority mix, one
runtime distribution. Real lakehouse days are not like that: load
breathes with the clock, CI pushes arrive in bursts, a handful of
elephant pipelines dominate the runtime mass, and the query/pipeline
mix shifts with who is online. Each family below models ONE of those
departures as a pure, deterministic function

    family(params, *, seed=0, **knobs) -> list[trace records]

producing the JSON trace schema of docs/trace-format.md — so a scenario
is just a synthetic *recorded day*: it flows through the same ingestion
path as a real production trace (``workload_from_trace_records`` /
``workload_batch_from_traces``) and runs on every compiled path
(``run``, ``fleet_run``, ``shard="auto"``, lane binning).

Determinism: everything is drawn from one ``numpy.random.default_rng
(seed)`` stream; the same ``(params, seed, knobs)`` triple always
produces the identical record list. Arrival counts are truncated at
``params.max_pipelines`` when it is positive (the arrival-table
capacity, mirroring the seed generator's fixed table); set it to 0 and
ingest with ``workload_batch_from_traces`` to derive capacity from the
scenario instead.
"""
from __future__ import annotations

from typing import Any, Callable

import numpy as np

from ..params import SimParams
from ..types import TICKS_PER_SECOND

_PRIORITY_NAMES = ("BATCH", "QUERY", "INTERACTIVE")


def _base_rate_per_s(params: SimParams) -> float:
    """The paper generator's mean arrival rate, in pipelines/second."""
    return TICKS_PER_SECOND / params.waiting_ticks_mean


def _max_arrivals(params: SimParams) -> int:
    return params.max_pipelines if params.max_pipelines > 0 else 1 << 20


def _prio_scale(params: SimParams, prio: int) -> float:
    return (1.0, params.query_scale, params.interactive_scale)[prio]


def _draw_priority(rng: np.random.Generator, probs) -> int:
    p = np.asarray(probs, np.float64)
    return int(rng.choice(3, p=p / p.sum()))


def _draw_ops(
    rng: np.random.Generator,
    params: SimParams,
    prio: int,
    *,
    n_ops: int | None = None,
    base_s_mean: float | None = None,
    base_factor: float = 1.0,
    out_factor: float = 1.0,
) -> list[dict[str, Any]]:
    """Draw one pipeline's operator list, mirroring the seed generator's
    distributions (lognormal sizes, chain/join DAG shape, categorical
    CPU-scaling alpha, priority-dependent scale-down)."""
    if n_ops is None:
        lam = max(params.mean_ops_per_pipeline - 1.0, 0.0)
        n_ops = 1 + int(rng.poisson(lam))
    if params.max_ops_per_pipeline > 0:
        n_ops = min(n_ops, params.max_ops_per_pipeline)
    scale = _prio_scale(params, prio)
    base_mean = (
        params.op_base_seconds_mean if base_s_mean is None else base_s_mean
    )
    aprobs = np.asarray(params.alpha_probs, np.float64)
    aprobs = aprobs / aprobs.sum()
    level = 0
    ops = []
    for j in range(n_ops):
        if j > 0 and rng.random() < params.chain_prob:
            level += 1
        base_s = (
            float(np.exp(rng.normal() * params.op_base_seconds_sigma))
            * base_mean * scale * base_factor
        )
        ops.append(
            {
                "ram_gb": max(
                    float(np.exp(rng.normal() * params.op_ram_gb_sigma))
                    * params.op_ram_gb_mean * scale,
                    0.05,
                ),
                "base_s": max(base_s, 1.0 / TICKS_PER_SECOND),
                "alpha": float(
                    np.asarray(params.alpha_choices)[rng.choice(
                        len(aprobs), p=aprobs
                    )]
                ),
                "level": level,
                "out_gb": (
                    float(np.exp(rng.normal() * params.op_out_gb_sigma))
                    * params.op_out_gb_mean * scale * out_factor
                ),
            }
        )
    return ops


def _records(
    rng: np.random.Generator,
    params: SimParams,
    arrivals_s: list[float],
    probs=None,
    **op_kw,
) -> list[dict[str, Any]]:
    probs = params.priority_probs if probs is None else probs
    records = []
    for t in arrivals_s:
        prio = _draw_priority(rng, probs)
        records.append(
            {
                "arrival_s": float(t),
                "priority": _PRIORITY_NAMES[prio],
                "ops": _draw_ops(rng, params, prio, **op_kw),
            }
        )
    return records


def _thinned_arrivals(
    rng: np.random.Generator,
    rate_fn: Callable[[float], float],
    lam_max: float,
    horizon_s: float,
    max_n: int,
) -> list[float]:
    """Non-homogeneous Poisson arrivals by thinning: candidates at the
    envelope rate ``lam_max``, kept with probability rate(t)/lam_max."""
    out: list[float] = []
    t = 0.0
    while len(out) < max_n:
        t += rng.exponential(1.0 / lam_max)
        if t >= horizon_s:
            break
        if rng.random() * lam_max <= rate_fn(t):
            out.append(t)
    return out


# ---------------------------------------------------------------------------
# The families.
# ---------------------------------------------------------------------------
def diurnal(
    params: SimParams,
    *,
    seed: int = 0,
    amplitude: float = 0.75,
    period_s: float | None = None,
    phase: float = -np.pi / 2,
) -> list[dict[str, Any]]:
    """Sinusoidal arrival rate — the compressed day/night cycle.

    rate(t) = base * (1 + amplitude * sin(2*pi*t/period + phase)), a
    non-homogeneous Poisson process sampled by thinning. The default
    phase starts the trace in the trough (night) so the ramp into the
    peak stresses admission policies mid-trace. ``period_s`` defaults
    to the whole horizon: one full cycle per trace.

    >>> from repro_torch import SimParams
    >>> recs = diurnal(SimParams(duration=0.5), seed=0)
    >>> recs == diurnal(SimParams(duration=0.5), seed=0)  # deterministic
    True
    >>> sorted(recs[0])
    ['arrival_s', 'ops', 'priority']
    """
    rng = np.random.default_rng(seed)
    base = _base_rate_per_s(params)
    period = params.duration if period_s is None else period_s
    amp = float(np.clip(amplitude, 0.0, 1.0))

    def rate(t: float) -> float:
        return base * (1.0 + amp * np.sin(2.0 * np.pi * t / period + phase))

    arrivals = _thinned_arrivals(
        rng, rate, base * (1.0 + amp), params.duration, _max_arrivals(params)
    )
    return _records(rng, params, arrivals)


def bursty(
    params: SimParams,
    *,
    seed: int = 0,
    burst_factor: float = 6.0,
    duty_cycle: float = 0.2,
    mean_cycle_s: float | None = None,
) -> list[dict[str, Any]]:
    """Markov-modulated Poisson on/off bursts — CI pushes, backfills.

    A two-state MMPP: ON periods arrive at ``burst_factor`` times the
    base rate, OFF periods at the complementary rate that keeps the
    long-run average at the base rate (clipped at 0 when
    ``burst_factor >= 1/duty_cycle``). Sojourns are exponential with
    means ``duty_cycle * mean_cycle_s`` (ON) and the rest (OFF);
    ``mean_cycle_s`` defaults to a quarter of the horizon. The result
    is the clumpy arrival tape that makes event-density lane binning
    and preemption policies earn their keep.

    >>> from repro_torch import SimParams
    >>> recs = bursty(SimParams(duration=0.5), seed=1)
    >>> recs == bursty(SimParams(duration=0.5), seed=1)
    True
    >>> all(r["arrival_s"] < 0.5 for r in recs)
    True
    """
    rng = np.random.default_rng(seed)
    base = _base_rate_per_s(params)
    duty = float(np.clip(duty_cycle, 1e-3, 1.0 - 1e-3))
    cycle = (
        params.duration / 4.0 if mean_cycle_s is None else float(mean_cycle_s)
    )
    on_rate = base * burst_factor
    off_rate = max(base * (1.0 - duty * burst_factor) / (1.0 - duty), 0.0)
    on_mean, off_mean = duty * cycle, (1.0 - duty) * cycle

    arrivals: list[float] = []
    t, on = 0.0, False  # start quiet, like the end of a night
    max_n = _max_arrivals(params)
    while t < params.duration and len(arrivals) < max_n:
        sojourn = rng.exponential(on_mean if on else off_mean)
        t_end = min(t + sojourn, params.duration)
        rate = on_rate if on else off_rate
        if rate > 0.0:
            u = t
            while len(arrivals) < max_n:
                u += rng.exponential(1.0 / rate)
                if u >= t_end:
                    break
                arrivals.append(u)
        t, on = t_end, not on
    return _records(rng, params, arrivals)


def heavy_tail(
    params: SimParams,
    *,
    seed: int = 0,
    tail_index: float = 1.3,
    body_scale: float = 0.3,
    out_runtime_exp: float = 0.5,
) -> list[dict[str, Any]]:
    """Pareto runtime mix — a few elephant pipelines own the runtime mass.

    Arrivals are plain Poisson at the base rate, but every pipeline
    draws a Pareto(``tail_index``) runtime factor: most pipelines run
    at ``body_scale`` of the configured mean, while the power-law tail
    produces rare 10-1000x elephants (the smaller the index, the
    heavier the tail). Each pipeline's intermediate dataset sizes scale
    with the factor**``out_runtime_exp`` — long pipelines emit large
    intermediates, so the data plane and SJF-style policies see the
    skew too.

    >>> from repro_torch import SimParams
    >>> recs = heavy_tail(SimParams(duration=0.5), seed=2)
    >>> recs == heavy_tail(SimParams(duration=0.5), seed=2)
    True
    >>> len(recs) > 0
    True
    """
    rng = np.random.default_rng(seed)
    base = _base_rate_per_s(params)
    arrivals = _thinned_arrivals(
        rng, lambda t: base, base, params.duration, _max_arrivals(params)
    )
    records = []
    for t in arrivals:
        prio = _draw_priority(rng, params.priority_probs)
        factor = body_scale * (1.0 + rng.pareto(tail_index))
        records.append(
            {
                "arrival_s": float(t),
                "priority": _PRIORITY_NAMES[prio],
                "ops": _draw_ops(
                    rng, params, prio,
                    base_factor=factor,
                    out_factor=factor ** out_runtime_exp,
                ),
            }
        )
    return records


def priority_skew(
    params: SimParams,
    *,
    seed: int = 0,
    interactive_frac: float = 0.55,
    query_frac: float = 0.30,
    batch_ops_factor: float = 2.0,
) -> list[dict[str, Any]]:
    """Query-vs-pipeline mix inversion — the analyst-hours workload.

    The paper's default mix is 60 % BATCH; here the default is 55 %
    INTERACTIVE + 30 % QUERY with only the remainder BATCH — but each
    BATCH pipeline is ``batch_ops_factor`` times longer (more ops) than
    the configured mean, so a small number of heavy background
    pipelines run under a storm of short interactive queries. This is
    the regime where preemption and priority-pool isolation separate
    the policies (paper §4.1.2).

    >>> from repro_torch import SimParams
    >>> recs = priority_skew(SimParams(duration=0.5), seed=3)
    >>> recs == priority_skew(SimParams(duration=0.5), seed=3)
    True
    >>> {r["priority"] for r in recs} <= {"BATCH", "QUERY", "INTERACTIVE"}
    True
    """
    rng = np.random.default_rng(seed)
    if interactive_frac + query_frac >= 1.0:
        raise ValueError("interactive_frac + query_frac must be < 1")
    probs = (
        1.0 - interactive_frac - query_frac, query_frac, interactive_frac
    )
    base = _base_rate_per_s(params)
    arrivals = _thinned_arrivals(
        rng, lambda t: base, base, params.duration, _max_arrivals(params)
    )
    records = []
    lam = max(params.mean_ops_per_pipeline - 1.0, 0.0)
    for t in arrivals:
        prio = _draw_priority(rng, probs)
        n_ops = None
        if prio == 0:  # the rare, heavy background pipelines
            n_ops = 1 + int(rng.poisson(lam * batch_ops_factor))
        records.append(
            {
                "arrival_s": float(t),
                "priority": _PRIORITY_NAMES[prio],
                "ops": _draw_ops(rng, params, prio, n_ops=n_ops),
            }
        )
    return records


def spot_churn(
    params: SimParams,
    *,
    seed: int = 0,
    batch_frac: float = 0.8,
    runtime_factor: float = 3.0,
) -> list[dict[str, Any]]:
    """Spot-instance fleet day — restartable batch work under churn.

    The arrival tape itself is calm: steady Poisson arrivals at the base
    rate, ``batch_frac`` of them BATCH, each running
    ``runtime_factor`` times the configured mean so every pipeline is
    long enough that a mid-flight kill actually costs something. The
    churn comes from the chaos layer (docs/faults.md): this family is
    meant to run with the fault knobs on — pair it with
    :func:`spot_churn_params`, which turns on crash/outage injection and
    a retry budget tuned so the workload survives on retries rather
    than failing back to the user. Scheduler-resilience comparisons
    (benchmarks/scheduler_comparison.py ``--resilience``) measure
    goodput and wasted work per policy on exactly this pairing.

    >>> from repro_torch import SimParams
    >>> recs = spot_churn(SimParams(duration=0.5), seed=4)
    >>> recs == spot_churn(SimParams(duration=0.5), seed=4)
    True
    >>> sum(r["priority"] == "BATCH" for r in recs) > len(recs) // 2
    True
    """
    rng = np.random.default_rng(seed)
    frac = float(np.clip(batch_frac, 0.0, 1.0))
    probs = (frac, (1.0 - frac) * 0.5, (1.0 - frac) * 0.5)
    base = _base_rate_per_s(params)
    arrivals = _thinned_arrivals(
        rng, lambda t: base, base, params.duration, _max_arrivals(params)
    )
    return _records(rng, params, arrivals, probs=probs,
                    base_factor=runtime_factor)


def spot_churn_params(
    params: SimParams,
    *,
    crash_mtbf_s: float = 0.05,
    outage_mtbf_s: float = 0.2,
    outage_duration_s: float = 0.02,
    max_retries: int = 3,
    base_backoff_s: float = 0.001,
) -> SimParams:
    """The chaos-knob half of the ``spot_churn`` scenario.

    Returns ``params`` with crash/outage injection on at the given MTBFs
    (seconds of simulated time, converted to ticks) and an exponential
    retry budget sized so transient kills are absorbed by re-queues.
    ``max_retries=0`` leaves every faulted pipeline FAILED — the CI
    chaos smoke asserts both sides of that contract.
    """
    return params.replace(
        crash_mtbf_ticks=crash_mtbf_s * TICKS_PER_SECOND,
        outage_mtbf_ticks=outage_mtbf_s * TICKS_PER_SECOND,
        outage_duration_ticks=outage_duration_s * TICKS_PER_SECOND,
        max_retries=max_retries,
        base_backoff_ticks=max(int(base_backoff_s * TICKS_PER_SECOND), 1),
    )


def retry_storm(
    params: SimParams,
    *,
    seed: int = 0,
    surge_factor: float = 4.0,
    surge_start_frac: float = 0.25,
    surge_duration_frac: float = 0.35,
    interactive_frac: float = 0.5,
) -> list[dict[str, Any]]:
    """Overload surge — the arrival tape half of a retry storm.

    Steady Poisson arrivals at the base rate, except for a surge window
    (``surge_start_frac`` to ``surge_start_frac + surge_duration_frac``
    of the horizon) where the rate jumps to ``surge_factor`` times the
    base — an incident tape: a launch, a backfill, a thundering herd
    after an outage. Half the traffic is INTERACTIVE by default, so
    admission policies have a latency-sensitive class to protect. The
    storm itself comes from the closed loop (docs/closed-loop.md): pair
    this family with :func:`retry_storm_params`, which turns on
    client-side retries (the amplification mechanism) plus a pool
    outage mid-surge, and choose an admission policy to see whether the
    backlog drains or goes metastable. The CI overload smoke
    (benchmarks/run.py ``--overload-smoke``) asserts both outcomes.

    >>> from repro_torch import SimParams
    >>> recs = retry_storm(SimParams(duration=0.5), seed=5)
    >>> recs == retry_storm(SimParams(duration=0.5), seed=5)
    True
    >>> all(0.0 <= r["arrival_s"] < 0.5 for r in recs)
    True
    """
    rng = np.random.default_rng(seed)
    frac = float(np.clip(interactive_frac, 0.0, 1.0))
    probs = ((1.0 - frac) * 0.6, (1.0 - frac) * 0.4, frac)
    base = _base_rate_per_s(params)
    surge = max(float(surge_factor), 1.0)
    t0 = params.duration * float(np.clip(surge_start_frac, 0.0, 1.0))
    t1 = min(
        t0 + params.duration * max(float(surge_duration_frac), 0.0),
        params.duration,
    )

    def rate(t: float) -> float:
        return base * surge if t0 <= t < t1 else base

    arrivals = _thinned_arrivals(
        rng, rate, base * surge, params.duration, _max_arrivals(params)
    )
    return _records(rng, params, arrivals, probs=probs)


def retry_storm_params(
    params: SimParams,
    *,
    outage_mtbf_s: float = 0.3,
    outage_duration_s: float = 0.05,
    max_retries: int = 2,
    base_backoff_s: float = 0.001,
    client_max_retries: int = 4,
    client_backoff_s: float = 0.002,
    client_max_inflight: int = 0,
    client_think_s: float = 0.002,
    admission_policy: str = "admit_all",
    admit_queue_limit: int = 0,
    metastable_window_s: float = 0.0,
) -> SimParams:
    """The closed-loop-knob half of the ``retry_storm`` scenario.

    Returns ``params`` with client-side retries on (rejected offers come
    back after a capped exponential backoff — the amplification
    mechanism), a pool-outage schedule that strikes mid-surge, a modest
    server-side retry budget for the fault kills, and the chosen
    admission policy. The default ``admit_all`` is the control arm: the
    storm hits the scheduler unfiltered. Swap in ``queue_threshold``
    (with ``admit_queue_limit``) or any registered policy
    (docs/closed-loop.md) for the treatment arm. Window 0 means
    metastability is judged "by the end of the run".
    """
    return params.replace(
        outage_mtbf_ticks=outage_mtbf_s * TICKS_PER_SECOND,
        outage_duration_ticks=outage_duration_s * TICKS_PER_SECOND,
        max_retries=max_retries,
        base_backoff_ticks=max(int(base_backoff_s * TICKS_PER_SECOND), 1),
        client_max_retries=client_max_retries,
        client_backoff_ticks=max(
            int(client_backoff_s * TICKS_PER_SECOND), 1
        ),
        client_max_inflight=client_max_inflight,
        client_think_ticks=max(int(client_think_s * TICKS_PER_SECOND), 1)
        if client_max_inflight > 0
        else 0,
        admission_policy=admission_policy,
        admit_queue_limit=admit_queue_limit,
        metastable_window_ticks=int(metastable_window_s * TICKS_PER_SECOND),
    )


__all__ = [
    "diurnal", "bursty", "heavy_tail", "priority_skew",
    "spot_churn", "spot_churn_params",
    "retry_storm", "retry_storm_params",
]
