"""Simulation fleets: many lanes in one lane-major run.

``fleet_run`` advances ``len(seeds)`` generated lanes, or a caller-built
``[F, ...]`` workload batch, in one engine loop; lane ``i`` of the
result equals ``run()`` on lane ``i``'s workload. Device sharding and
lane binning are later work (ROADMAP queue 1, item 8).
"""
from __future__ import annotations

from typing import Any, Sequence

import torch

from .engine import _check_workload, check_main_path, resolve_device, run_lane_major_engine
from .params import SimParams
from .state import SimState, Workload
from .workload import generate_workload


def make_workload_batch(
    params: SimParams, seeds: Sequence[int], *, device="cpu"
) -> Workload:
    """One seed-generated workload per lane (lane ``i`` is
    ``generate_workload(params, seeds[i])``)."""
    lanes = [generate_workload(params, s) for s in seeds]
    return Workload(*(torch.cat(parts).to(device) for parts in zip(*(wl[:10] for wl in lanes))))


def fleet_run(
    params: SimParams,
    seeds: Sequence[int] | None = None,
    scheduler_key: str | None = None,
    *,
    workloads: Workload | None = None,
    device: Any = "cuda",
    shard=None,
    trace: bool = False,
) -> SimState:
    """Run a fleet on ``device`` (CUDA unless the caller asks for the
    CPU); exactly one of ``seeds`` / ``workloads`` is given. Returns the
    batched final state (leading axis = lane)."""
    if (seeds is None) == (workloads is None):
        raise ValueError(
            "fleet_run needs exactly one of seeds= (generated lanes) or "
            "workloads= (a caller-built batch)"
        )
    if shard is not None:
        raise NotImplementedError(
            "shard= (lanes spread over devices) waits for ROADMAP queue 1, item 8"
        )
    if trace:
        raise NotImplementedError("trace=True (telemetry) waits for ROADMAP queue 1, item 12")
    check_main_path(params)
    device = resolve_device(device)
    if workloads is None:
        workloads = make_workload_batch(params, seeds)
    _check_workload(workloads, params)
    wls = Workload(*(x.to(device).contiguous() for x in workloads[:10]))
    states, _ = run_lane_major_engine(
        params, wls, scheduler_key or params.scheduling_algo
    )
    return states


__all__ = ["fleet_run", "make_workload_batch"]
