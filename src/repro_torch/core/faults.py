"""The chaos layer's fault traces: drawn up front from a seed, like the
arrival table, so a run replays the same crashes, outages and
stragglers on any device.

Three fault classes, each on only when its knobs are (see
``repro.core.faults`` for the contract):

* transient crashes (``crash_mtbf_ticks``): sorted ticks of a Poisson
  process; at each, the longest-running container is killed;
* pool outages (``outage_mtbf_ticks`` / ``outage_duration_ticks``):
  sorted start ticks, a duration each, and the pool struck;
* stragglers (``straggler_prob`` / ``straggler_factor``): a slowdown
  factor per pipeline.

The reference draws with ``jax.random`` threefry (fold-in keys 8-12 of
the workload's key); the port draws from ``torch.Generator``s on the
CPU, one per fault class, seeded from the seed and the class through a
``numpy.random.SeedSequence``. The two agree in distribution only, so
parity runs hand the port the reference's traces
(``bridge.workload_from_arrays``). The workload's own generator is never
touched: its draws are the same whether faults are on or off.

Traces are lane-major like the workload: ``[F, MF]`` and ``[F, MP]``.
"""
from __future__ import annotations

from typing import Any, Sequence

import numpy as np
import torch

from .params import SimParams
from .state import FaultTrace, Workload
from .types import INF_TICK

# the stream of each fault class, after the reference's fold-in keys
_K_CRASH, _K_OUTAGE_START, _K_OUTAGE_DUR, _K_OUTAGE_POOL, _K_STRAGGLER = (
    8, 9, 10, 11, 12,
)
# entropy tags: a run's trace (from its seed) and a batch lane's trace
_TAG_RUN, _TAG_LANE = 0xFA017, 0xFA018


def empty_fault_trace(params: SimParams) -> FaultTrace:
    """An inert trace, a fleet of one: padding only."""
    MF, MP = params.max_fault_events, params.max_pipelines
    i32 = torch.int32
    return FaultTrace(
        crash_time=torch.full((1, MF), INF_TICK, dtype=i32),
        outage_start=torch.full((1, MF), INF_TICK, dtype=i32),
        outage_end=torch.full((1, MF), INF_TICK, dtype=i32),
        outage_pool=torch.zeros((1, MF), dtype=i32),
        straggler=torch.ones((1, MP), dtype=torch.float32),
    )


def _generator(entropy: tuple, stream: int) -> torch.Generator:
    seed = np.random.SeedSequence((*entropy, stream)).generate_state(1, np.uint64)[0]
    return torch.Generator().manual_seed(int(seed))


def _event_times(g: torch.Generator, mtbf: float, horizon: int, MF: int) -> torch.Tensor:
    """Sorted ticks of a Poisson process of mean gap ``mtbf``, INF_TICK
    at or past the horizon."""
    gaps = torch.empty(MF, dtype=torch.float64).exponential_(generator=g)
    t = torch.cumsum(gaps * mtbf, 0)
    return torch.where(t < horizon, t.floor(), float(INF_TICK)).to(torch.int64).to(torch.int32)


def _lane_trace(params: SimParams, entropy: tuple) -> FaultTrace:
    """One lane's trace (per-lane shapes) from ``entropy``."""
    MF, MP = params.max_fault_events, params.max_pipelines
    horizon = params.horizon_ticks
    crash_time, outage_start, outage_end, outage_pool, straggler = (
        x[0] for x in empty_fault_trace(params))
    if params.crash_mtbf_ticks > 0:
        crash_time = _event_times(
            _generator(entropy, _K_CRASH), params.crash_mtbf_ticks, horizon, MF)
    if params.outage_mtbf_ticks > 0:
        outage_start = _event_times(
            _generator(entropy, _K_OUTAGE_START), params.outage_mtbf_ticks, horizon, MF)
        dur = torch.empty(MF, dtype=torch.float64).exponential_(
            generator=_generator(entropy, _K_OUTAGE_DUR)) * params.outage_duration_ticks
        dur = dur.clamp_max(2.0**30).to(torch.int64).clamp_min(1)
        outage_end = torch.where(
            outage_start < INF_TICK,
            (outage_start.to(torch.int64) + dur).clamp_max(INF_TICK),
            INF_TICK,
        ).to(torch.int32)
        outage_pool = torch.randint(
            0, params.num_pools, (MF,), generator=_generator(entropy, _K_OUTAGE_POOL)
        ).to(torch.int32)
    if params.straggler_prob > 0:
        slow = torch.rand(MP, generator=_generator(entropy, _K_STRAGGLER)) < params.straggler_prob
        straggler = torch.where(
            slow, torch.tensor(params.straggler_factor, dtype=torch.float32),
            torch.tensor(1.0, dtype=torch.float32))
    return FaultTrace(crash_time, outage_start, outage_end, outage_pool, straggler)


def _stack(lanes: Sequence[FaultTrace], device) -> FaultTrace:
    return FaultTrace(*(torch.stack(parts).to(device) for parts in zip(*lanes)))


def generate_fault_trace(
    params: SimParams, seed: int | None = None, *, device="cpu"
) -> FaultTrace:
    """The trace of one run as a fleet of one (``[1, ...]``), drawn from
    ``seed`` (default ``params.seed``). Only the classes whose knobs are
    on draw anything; the rest stay padding."""
    seed = int(params.seed if seed is None else seed)
    return _stack([_lane_trace(params, (_TAG_RUN, seed))], device)


def attach_fault_trace(wl: Workload, params: SimParams, seed: int | None = None) -> Workload:
    """``wl`` (a fleet of one) with the trace of ``seed`` attached."""
    return wl._replace(faults=generate_fault_trace(params, seed, device=wl.arrival.device))


def attach_fault_traces(wls: Workload, params: SimParams) -> Workload:
    """``wls`` (``[F, ...]``) with a trace per lane: lane ``i`` draws from
    ``(params.seed, i)``, so the batch is reproducible from the seed and
    every lane's faults differ."""
    F = wls.arrival.shape[0]
    lanes = [_lane_trace(params, (_TAG_LANE, int(params.seed), i)) for i in range(F)]
    return wls._replace(faults=_stack(lanes, wls.arrival.device))


# ---------------------------------------------------------------------------
# Records: one lane's trace as a dict of plain lists, and back, exactly.
# ---------------------------------------------------------------------------
def fault_trace_to_records(ft: FaultTrace) -> dict[str, list]:
    """One lane's trace (a fleet of one, or per-lane shapes) as a dict of
    lists; ``fault_trace_from_records`` gives it back exactly."""
    def lane(x):
        if x.dim() == 2:
            if x.shape[0] != 1:
                raise ValueError(f"records hold one lane; the trace has {x.shape[0]}")
            x = x[0]
        return x.cpu()

    return {
        "crash_time": [int(t) for t in lane(ft.crash_time)],
        "outage_start": [int(t) for t in lane(ft.outage_start)],
        "outage_end": [int(t) for t in lane(ft.outage_end)],
        "outage_pool": [int(p) for p in lane(ft.outage_pool)],
        "straggler": [float(f) for f in lane(ft.straggler)],
    }


def fault_trace_from_records(
    records: dict[str, Sequence[Any]], params: SimParams
) -> FaultTrace:
    """A trace (a fleet of one) from its records, short lists padded to
    ``params``' capacities and missing keys left as padding."""
    MF, MP = params.max_fault_events, params.max_pipelines

    def pad_i32(name: str, fill: int, n: int) -> torch.Tensor:
        vals = [int(v) for v in records.get(name, ())]
        if len(vals) > n:
            raise ValueError(f"fault trace {name!r} has {len(vals)} entries > capacity {n}")
        return torch.tensor([vals + [fill] * (n - len(vals))], dtype=torch.int32)

    strag = [float(v) for v in records.get("straggler", ())]
    if len(strag) > MP:
        raise ValueError(f"fault trace straggler has {len(strag)} entries > {MP} pipelines")
    return FaultTrace(
        crash_time=pad_i32("crash_time", INF_TICK, MF),
        outage_start=pad_i32("outage_start", INF_TICK, MF),
        outage_end=pad_i32("outage_end", INF_TICK, MF),
        outage_pool=pad_i32("outage_pool", 0, MF),
        straggler=torch.tensor([strag + [1.0] * (MP - len(strag))], dtype=torch.float32),
    )


__all__ = [
    "empty_fault_trace",
    "generate_fault_trace",
    "attach_fault_trace",
    "attach_fault_traces",
    "fault_trace_to_records",
    "fault_trace_from_records",
]
