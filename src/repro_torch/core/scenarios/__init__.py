"""Scenario library: parameterised workload families as trace records.

The port's copy of ``repro.core.scenarios``: the families draw from one
``numpy.random.default_rng(seed)`` stream, so the same ``(params, seed,
knobs)`` gives the reference's records bit for bit; ``scenario_fleet``
ingests them with the port's ``workload_batch_from_traces`` and returns
a batch on the CPU (``fleet_run`` moves it to its device).

Every family is a pure function producing the trace-record schema
(docs/trace-format.md), so scenarios and recorded production days are
the same thing to the simulator — both flow through
``workload_from_trace_records`` (one lane) or
``workload_batch_from_traces`` (a fleet) and run on every compiled
path. See docs/scenarios.md for each family's story and knobs.

Three layers:

* family functions (``diurnal``/``bursty``/``heavy_tail``/
  ``priority_skew``/``spot_churn``/``retry_storm``) — one trace each;
* ``scenario_lane_batch`` — n_lanes independent draws of one family
  (per-lane seeds), the fleet Monte-Carlo shape;
* ``scenario_fleet`` — the same, ingested: returns ``(workloads,
  params)`` ready for ``fleet_run(params, workloads=workloads)``.

>>> from repro_torch import SimParams
>>> from repro_torch.core.scenarios import get_scenario, list_scenarios
>>> list_scenarios()
['bursty', 'diurnal', 'heavy_tail', 'priority_skew', 'retry_storm', 'spot_churn']
>>> fn = get_scenario("diurnal")
>>> recs = fn(SimParams(duration=0.5), seed=0)
>>> len(recs) > 0
True
"""
from __future__ import annotations

from typing import Any, Callable, Sequence

from ..params import SimParams
from ..state import Workload
from ..workload import workload_batch_from_traces
from .families import (
    bursty,
    diurnal,
    heavy_tail,
    priority_skew,
    retry_storm,
    retry_storm_params,
    spot_churn,
    spot_churn_params,
)

ScenarioFn = Callable[..., "list[dict[str, Any]]"]

SCENARIOS: dict[str, ScenarioFn] = {
    "diurnal": diurnal,
    "bursty": bursty,
    "heavy_tail": heavy_tail,
    "priority_skew": priority_skew,
    "retry_storm": retry_storm,
    "spot_churn": spot_churn,
}


def list_scenarios() -> list[str]:
    return sorted(SCENARIOS)


def get_scenario(name: str) -> ScenarioFn:
    key = name.replace("-", "_").lower()
    if key not in SCENARIOS:
        raise KeyError(
            f"unknown scenario {name!r}; available: {list_scenarios()}"
        )
    return SCENARIOS[key]


def scenario_lane_batch(
    name: str | ScenarioFn,
    params: SimParams,
    n_lanes: int,
    *,
    seed: int = 0,
    **knobs: Any,
) -> list[list[dict[str, Any]]]:
    """n_lanes independent draws of one family: lane i uses seed+i.

    The result is a plain list of record lists — compose lanes from
    different families freely before ingesting (the trace-replay
    example mixes all four into one fleet).

    >>> from repro_torch import SimParams
    >>> lanes = scenario_lane_batch("bursty", SimParams(duration=0.5), 3)
    >>> len(lanes)
    3
    >>> lanes[0] != lanes[1]  # per-lane seeds -> independent draws
    True
    """
    fn = get_scenario(name) if isinstance(name, str) else name
    return [fn(params, seed=seed + lane, **knobs) for lane in range(n_lanes)]


def scenario_fleet(
    name: str | ScenarioFn | Sequence[str],
    params: SimParams,
    n_lanes: int,
    *,
    seed: int = 0,
    **knobs: Any,
) -> tuple[Workload, SimParams]:
    """One family (or a round-robin mix of families) as an ingested
    fleet batch: returns ``(workloads, params)`` for ``fleet_run(params,
    workloads=workloads)``. With a list of names, lane i draws family
    ``i % len(names)`` — a mixed fleet in one call. Capacity knobs at 0
    are derived from the batch (see ``workload_batch_from_traces``).

    >>> from repro_torch import SimParams
    >>> p = SimParams(duration=0.5, max_pipelines=0,
    ...               max_ops_per_pipeline=0)
    >>> wls, p2 = scenario_fleet(["diurnal", "bursty"], p, 4)
    >>> int(wls.arrival.shape[0]), p2.max_pipelines > 0
    (4, True)
    """
    if isinstance(name, (list, tuple)):
        if not name:
            raise ValueError(
                "scenario_fleet needs at least one family name; "
                f"available: {list_scenarios()}"
            )
        lanes = [
            get_scenario(name[lane % len(name)])(
                params, seed=seed + lane, **knobs
            )
            for lane in range(n_lanes)
        ]
    else:
        lanes = scenario_lane_batch(
            name, params, n_lanes, seed=seed, **knobs
        )
    return workload_batch_from_traces(lanes, params)


__all__ = [
    "SCENARIOS",
    "list_scenarios",
    "get_scenario",
    "scenario_lane_batch",
    "scenario_fleet",
    "diurnal",
    "bursty",
    "heavy_tail",
    "priority_skew",
    "retry_storm",
    "retry_storm_params",
    "spot_churn",
    "spot_churn_params",
]
