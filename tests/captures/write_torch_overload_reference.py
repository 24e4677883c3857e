"""Write ``torch_overload_reference.json`` and
``torch_overload_reference_half.json``: the JAX package's overload table,
for the port to be held to (``tests/test_torch_overload.py`` on the CPU,
``chip_smoke.py`` phase 6c (b) on the card).

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/captures/write_torch_overload_reference.py

The configuration is ``benchmarks/scheduler_comparison.py``'s
``overload_comparison``: 8 ``retry_storm`` lanes (seed 11, surge 6, a
0.06 s tape in a 0.08 s run), two early outages a lane, clients that
retry 3 times, under the four admission policies; the ``_half`` file
runs the same at half the horizon (a 0.03 s tape in a 0.04 s run), which
is what the card's phase 6c (b) runs. Each file holds each lane's fault
trace as the reference draws it (``fault_trace_to_records``; the same
for every arm) and each arm's row from the reference's ``fleet_run`` on
those traces.
"""
from __future__ import annotations

import json
import pathlib

import numpy as np

from repro.core import SimParams, fleet_run, fleet_summary, workload_batch_from_traces
from repro.core.faults import attach_fault_traces, fault_trace_to_records
from repro.core.scenarios import retry_storm_params, scenario_lane_batch
from repro.core.state import INF_TICK, FaultTrace

HERE = pathlib.Path(__file__).parent
# file: (run s, tape s)
CAPTURES = {"torch_overload_reference.json": (0.08, 0.06),
            "torch_overload_reference_half.json": (0.04, 0.03)}
N_LANES = 8
# benchmarks/scheduler_comparison.py's OVERLOAD_POLICIES
OVERLOAD_POLICIES = (
    ("admit_all", {}),
    ("queue_threshold", {"admit_queue_limit": 3}),
    ("token_bucket", {"admit_rate_per_s": 400.0, "admit_burst": 4.0}),
    ("codel", {"codel_target_ticks": 400, "codel_interval_ticks": 200}),
)


def base_params() -> SimParams:
    return SimParams(
        duration=0.08, max_pipelines=0, max_ops_per_pipeline=0, max_containers=16,
        waiting_ticks_mean=150.0, op_base_seconds_mean=0.008, op_base_seconds_sigma=1.0,
        num_pools=2, total_cpus=4, total_ram_gb=8, scheduling_algo="priority_pool", seed=11,
    )


def armed_params(params: SimParams, policy: str, knobs: dict) -> SimParams:
    return retry_storm_params(
        params, admission_policy=policy, outage_mtbf_s=0.02, outage_duration_s=0.006,
        client_max_retries=3,
    ).replace(max_fault_events=2, **knobs)


def row(states, params) -> dict:
    """An arm's row: totals over the lanes, goodput (mean completions a
    lane per simulated second), drained and metastable lanes."""
    s = fleet_summary(states, params)
    drained = int(np.sum(np.asarray(states.drain_tick) < INF_TICK))
    return {
        "offered": int(np.sum(np.asarray(states.offered_total))),
        "admitted": int(np.sum(np.asarray(states.admitted_total))),
        "shed": int(np.sum(np.asarray(states.shed_total))),
        "deferred": int(np.sum(np.asarray(states.deferred_total))),
        "client_retries": int(np.sum(np.asarray(states.client_retry_events))),
        "goodput_per_s": float(s["throughput_per_s_mean"]),
        "drained_lanes": drained,
        "metastable_lanes": int(states.drain_tick.shape[0]) - drained,
    }


def write(name: str, duration: float, tape: float) -> None:
    base = base_params().replace(duration=duration)
    lanes = scenario_lane_batch("retry_storm", base.replace(duration=tape), N_LANES,
                                seed=11, surge_factor=6.0)
    traces, rows = None, {}
    for policy, knobs in OVERLOAD_POLICIES:
        wls, params = workload_batch_from_traces(lanes, base)
        armed = armed_params(params, policy, knobs)
        wls = attach_fault_traces(wls, armed)
        lane_traces = [
            fault_trace_to_records(FaultTrace(*(np.asarray(x)[i] for x in wls.faults)))
            for i in range(N_LANES)
        ]
        if traces is None:
            traces = lane_traces
        elif lane_traces != traces:
            raise AssertionError(f"{policy}: the fault traces differ from the first arm's")
        rows[policy] = row(fleet_run(armed, workloads=wls), armed)
    (HERE / name).write_text(json.dumps({
        "config": f"chip_smoke.py phase 6c (b): retry_storm, 8 lanes, seed 11, surge 6, "
                  f"{tape:g} s tape in {duration:g} s, two outages a lane, client_max_retries 3",
        "fault_traces": traces,
        "rows": rows,
    }, indent=1, sort_keys=True) + "\n")
    print(name, json.dumps(rows, indent=1, sort_keys=True))


def main() -> None:
    for name, (duration, tape) in CAPTURES.items():
        write(name, duration, tape)


if __name__ == "__main__":
    main()
