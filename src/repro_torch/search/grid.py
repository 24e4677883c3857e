"""Policy-grid evaluation: candidates × scenarios in one fleet.

``evaluate_policies`` is the search's oracle call. It tiles a scenario
batch across a candidate grid (``sweep.policy_grid_workloads``), runs
ONE ``fleet_run`` under the dynamic ``"policy"`` scheduler family on
``device`` (CUDA unless the caller asks for the CPU), and reduces
per-lane statistics (``metrics.fleet_lane_stats``) to one objective
vector per candidate.

The caller passes a ``make_scenarios`` *factory* that rebuilds the
batch (bitwise, from fixed seeds) on every call, as the reference's
donation contract asks; arrival tables are copied to the host before
the engine sees them.
"""
from __future__ import annotations

from typing import Any, Callable, Sequence

import numpy as np

from ..core.metrics import fleet_lane_stats
from ..core.params import SimParams
from ..core.state import Workload, tree_map, workload_to
from ..core.sweep import fleet_run, policy_grid_workloads

# objective columns, all minimised — the Pareto front and the CEM
# scalarisation both rank over this layout. Two deliberate choices:
# latency is the CENSORED estimator (every arrived pipeline counts,
# unfinished ones at their `horizon - arrival` lower bound — see
# ``metrics.fleet_lane_stats``), so a policy can't shine by stranding
# the queue and reporting the latency of the two pipelines it deigned
# to finish; and utilisation is minimised too, because the scenario
# batch fixes the work — CPU-seconds above the workload's intrinsic
# demand are waste (retry re-work, preemption restarts, premium cloud
# overflow), and in a pay-per-use FaaS setting the operator wants the
# same pipelines finished sooner on a smaller resource footprint.
OBJECTIVES = (
    "censored_mean_latency_s",
    "censored_p99_latency_s",
    "cpu_utilization",
    "cost_dollars",
)


def _nanmean_cols(x: np.ndarray) -> np.ndarray:
    """Row-wise nanmean without the all-NaN RuntimeWarning; all-NaN
    rows stay NaN (sanitised to +inf at ranking time)."""
    finite = np.isfinite(x)
    cnt = finite.sum(axis=1)
    tot = np.where(finite, x, 0.0).sum(axis=1)
    return np.where(cnt > 0, tot / np.maximum(cnt, 1), np.nan)


def evaluate_policies(
    make_scenarios: Callable[[], tuple[Workload, SimParams]],
    policies,
    *,
    lane_limit: int | None = None,
    shard: str | int | None = None,
    device: Any = "cuda",
) -> dict:
    """Evaluate a ``[C, P]`` policy grid over a scenario batch on
    ``device``.

    ``make_scenarios`` returns ``(workloads, params)`` (e.g. a
    ``scenario_fleet`` closure) and is called once per evaluation.
    ``lane_limit`` keeps only the first L scenario lanes
    (successive-halving rungs evaluate cheap low-fidelity prefixes of
    the same batch).

    Returns ``{"objectives": [C, 4], "per_candidate": {stat: [C]},
    "C": C, "S": S}`` with objective columns :data:`OBJECTIVES`;
    candidates whose every lane finished nothing get NaN latency
    objectives (never an exception).
    """
    wls, params = make_scenarios()
    if wls.policy is not None:
        raise ValueError(
            "make_scenarios must return a policy-free batch; "
            "evaluate_policies attaches the candidate grid itself"
        )
    if lane_limit is not None:
        if lane_limit <= 0:
            raise ValueError(f"lane_limit must be positive, got {lane_limit}")
        wls = tree_map(lambda x: x[:lane_limit], wls)
    grid, C, S = policy_grid_workloads(wls, policies)
    # the host copy of the arrivals, taken before the run
    arrival = grid.arrival.cpu().numpy()
    states = fleet_run(
        params, workloads=grid, scheduler_key="policy", shard=shard, device=device
    )
    lanes = fleet_lane_stats(states, params, arrival=arrival)

    per_candidate = {
        name: _nanmean_cols(
            np.asarray(col, np.float64).reshape(C, S)
        )
        for name, col in lanes.items()
    }
    objectives = np.stack(
        [per_candidate[name] for name in OBJECTIVES], axis=1
    )
    return {
        "objectives": objectives,
        "per_candidate": per_candidate,
        "C": C,
        "S": S,
    }


def scenario_factory(
    names: Sequence[str] | str,
    params: SimParams,
    n_lanes: int,
    *,
    seed: int = 0,
    device: Any = "cuda",
    **knobs,
) -> Callable[[], tuple[Workload, SimParams]]:
    """A ``make_scenarios`` closure over the scenario library.

    Each call rebuilds the same batch bitwise (fixed ``seed``) and moves
    it to ``device``; with a list of names the lanes round-robin the
    families (``scenario_fleet``).
    """
    from ..core.engine import resolve_device
    from ..core.scenarios import scenario_fleet

    names = [names] if isinstance(names, str) else list(names)
    device = resolve_device(device)

    def make() -> tuple[Workload, SimParams]:
        wls, p = scenario_fleet(names, params, n_lanes, seed=seed, **knobs)
        return workload_to(wls, device), p

    return make


__all__ = ["OBJECTIVES", "evaluate_policies", "scenario_factory"]
