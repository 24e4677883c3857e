"""Trace ingestion of the port against the JAX package's, on the CPU.

Records, trace files (JSON and TOML, in the seconds spelling and the
exact tick spelling of docs/trace-format.md) and batches go through
``repro.core`` and ``repro_torch`` alike: every workload field equal bit
for bit, the same exceptions, and ``run(SimParams(trace_path=...))`` and
``fleet_run(workloads=...)`` held to the reference under the comparison
contract (ROADMAP, ground rules): int and bool fields and the other f32
fields exact, the f32 sums taken in another order to rtol 1e-5.
"""
import json

import numpy as np
import pytest

from repro.core import SimParams as JParams
from repro.core import generate_workload as j_generate
from repro.core import run as j_run
from repro.core.sweep import fleet_run as j_fleet_run
from repro.core.workload import load_trace as j_load_trace
from repro.core.workload import workload_batch_from_traces as j_batch_from_traces
from repro.core.workload import workload_from_trace_records as j_from_records
from repro.core.workload import workload_to_trace_records as j_to_records
from repro_torch import (
    SimParams,
    fleet_run,
    load_trace,
    run,
    workload_batch_from_traces,
    workload_from_trace_records,
    workload_to_trace_records,
)
from repro_torch.bridge import state_to_arrays, workload_from_arrays

TOLERANT = {
    "sum_latency_s", "sum_latency_s_prio", "util_cpu_s", "util_ram_s",
    "cost_dollars", "util_log", "pool_down_s",
}
FIELDS = ("arrival", "prio", "n_ops", "op_valid", "op_level", "op_ram", "op_base",
          "op_alpha", "op_out", "pipe_out")


def _kw(**extra):
    return dict(duration=0.05, op_base_seconds_mean=0.005, op_base_seconds_sigma=1.0,
                max_pipelines=32, max_containers=32, waiting_ticks_mean=200.0, **extra)


def _ref_records(seed, **extra):
    """The records of a reference-built workload (its beyond-horizon
    slots reserved at INF), and the workload's arrays."""
    wl = j_generate(JParams(**_kw(**extra), seed=seed))
    arrays = {f: np.asarray(getattr(wl, f)) for f in FIELDS}
    return j_to_records(wl), arrays


def _assert_workloads_equal(port, ref, lane=None):
    """Every field of a port workload (lane axis first) equal to a
    reference workload's, bit for bit (dtype, shape and bits)."""
    for name in FIELDS:
        got = getattr(port, name).numpy()
        got = got[0 if lane is None else lane]
        want = np.asarray(getattr(ref, name) if not isinstance(ref, dict) else ref[name])
        if lane is not None and want.ndim == got.ndim + 1:
            want = want[lane]
        assert got.dtype == want.dtype and got.shape == want.shape, name
        assert got.tobytes() == want.tobytes(), name


def _assert_contract(port: dict, ref, ctx, lane=None):
    for name in ref._fields:
        want = np.asarray(getattr(ref, name))
        if lane is not None:
            want = want[lane]
        got = port[name] if lane is None else port[name][lane]
        assert got.dtype == want.dtype and got.shape == want.shape, (ctx, name)
        if name in TOLERANT:
            np.testing.assert_allclose(got, want, rtol=1e-5, err_msg=f"{ctx}: {name}")
        else:
            np.testing.assert_array_equal(got, want, err_msg=f"{ctx}: {name}")


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_records_equal_the_reference_and_ingest_back_bitwise(seed):
    recs, arrays = _ref_records(seed)
    port_wl = workload_from_arrays(arrays)
    mine = workload_to_trace_records(port_wl)
    assert mine == recs
    # some slots are reserved (never arrive, keep their ops)
    assert any(r["arrival_tick"] == 2**31 - 1 and r["ops"] for r in mine)
    params = SimParams(**_kw())
    _assert_workloads_equal(workload_from_trace_records(mine, params), arrays)
    _assert_workloads_equal(workload_from_trace_records(mine, params),
                            j_from_records(recs, JParams(**_kw())))
    # a per-lane workload gives the same records as its fleet of one
    lane = type(port_wl)(*(x[0] for x in port_wl[:10]))
    assert workload_to_trace_records(lane) == recs


def _spelled_records():
    """Records in both spellings of docs/trace-format.md: seconds fields
    (rounded to the tick grid, priority by name or number, optional
    fields left to their defaults, sizes off the MiB grid) and the exact
    tick fields (fractional base_ticks, a reserved slot, an arrival past
    the int32 range)."""
    return [
        {"arrival_s": 0.0, "priority": "QUERY",
         "ops": [{"ram_gb": 4.2, "base_s": 0.55, "alpha": 1.0, "level": 0, "out_gb": 0.5},
                 {"ram_gb": 1.3, "base_s": 0.012345}]},
        {"arrival_s": 0.0123456, "priority": 2,
         "ops": [{"ram_gb": 0.7, "base_s": 0.004, "out_gb": 0.0001}]},
        {"arrival_s": 0.02, "priority": "batch",
         "ops": [{"ram_gb": 2.0, "base_s": 0.1, "alpha": 0.5, "level": 0},
                 {"ram_gb": 2.5, "base_s": 0.1, "alpha": 0.5, "level": 0},
                 {"ram_gb": 1.0, "base_s": 0.2, "alpha": 0.0, "level": 1, "out_gb": 3.14159}]},
        {"arrival_s": 1e9, "ops": [{"ram_gb": 1.0, "base_s": 0.01}]},
        {"arrival_s": 0.5, "arrival_tick": 1234, "priority": "INTERACTIVE",
         "ops": [{"ram_gb": 3.3, "base_s": 0.1, "base_ticks": 1234.5678, "alpha": 0.5,
                  "level": 0, "out_gb": 0.25}]},
        {"arrival_tick": 2**31 - 1, "priority": 0,
         "ops": [{"ram_gb": 0.9, "base_ticks": 77.25, "alpha": 1.0, "level": 0}]},
    ]


def _toml(records):
    """The records as ``[[pipeline]]`` tables with nested
    ``[[pipeline.ops]]`` tables."""
    def value(v):
        return json.dumps(v) if isinstance(v, str) else repr(v)

    lines = []
    for rec in records:
        lines.append("[[pipeline]]")
        lines += [f"{k} = {value(v)}" for k, v in rec.items() if k != "ops"]
        for op in rec["ops"]:
            lines.append("[[pipeline.ops]]")
            lines += [f"{k} = {value(v)}" for k, v in op.items()]
        lines.append("")
    return "\n".join(lines)


@pytest.mark.parametrize("form", ["json-list", "json-pipelines", "toml"])
def test_trace_files_load_as_in_the_reference(tmp_path, form):
    records = _spelled_records()
    if form == "toml":
        path = tmp_path / "day.toml"
        path.write_text(_toml(records))
    else:
        path = tmp_path / "day.json"
        path.write_text(json.dumps(records if form == "json-list" else {"pipelines": records}))
    kw = dict(max_pipelines=8, max_ops_per_pipeline=4)
    mine = load_trace(path, SimParams(**kw))
    _assert_workloads_equal(mine, j_load_trace(path, JParams(**kw)))
    assert int(mine.arrival[0, 3]) == 2**31 - 1 and int(mine.arrival[0, 4]) == 1234
    assert float(mine.op_base[0, 4, 0]) == np.float32(1234.5678)


@pytest.mark.parametrize("form", ["json", "toml"])
def test_trace_files_without_records_raise_as_the_reference(tmp_path, form):
    path = tmp_path / f"day.{form}"
    path.write_text('{"days": []}' if form == "json" else 'title = "no pipelines"\n')
    for load, params in ((load_trace, SimParams()), (j_load_trace, JParams())):
        with pytest.raises(ValueError, match="pipeline"):
            load(path, params)


def _lanes():
    """Three traces of other lengths: two reference-built days and the
    spelled records."""
    return [_ref_records(3)[0][:20], _ref_records(4)[0], _spelled_records()]


def test_batch_with_derived_capacities_equals_the_reference():
    lanes = _lanes()
    base = dict(duration=0.05, max_pipelines=0, max_ops_per_pipeline=0)
    mine, mine_params = workload_batch_from_traces(lanes, SimParams(**base))
    ref, ref_params = j_batch_from_traces(lanes, JParams(**base))
    derived = (ref_params.max_pipelines, ref_params.max_ops_per_pipeline)
    assert (mine_params.max_pipelines, mine_params.max_ops_per_pipeline) == derived
    assert mine_params == SimParams(**base).replace(
        max_pipelines=derived[0], max_ops_per_pipeline=derived[1])
    for lane in range(len(lanes)):
        _assert_workloads_equal(mine, ref, lane=lane)
        # lane i of the batch is the single-lane ingestion of trace i
        single = workload_from_trace_records(lanes[lane], mine_params)
        _assert_workloads_equal(mine, {f: getattr(single, f).numpy()[0] for f in FIELDS},
                                lane=lane)


# (batch or single-lane ingestion, capacities, the lane's records, error)
BAD = {
    "pipelines": (True, dict(max_pipelines=3), _spelled_records(), ValueError),
    "ops": (True, dict(max_ops_per_pipeline=2), _spelled_records(), ValueError),
    "missing-ops": (True, {}, _spelled_records()[:1] + [{"arrival_s": 0.1, "opps": []}],
                    KeyError),
    "single-over-capacity": (False, dict(max_pipelines=3), _spelled_records(), ValueError),
}


@pytest.mark.parametrize("case", list(BAD))
def test_bad_batches_raise_as_the_reference(case):
    batch, kw, recs, error = BAD[case]
    for ingest, params in (
        (workload_batch_from_traces if batch else workload_from_trace_records, SimParams(**kw)),
        (j_batch_from_traces if batch else j_from_records, JParams(**kw)),
    ):
        with pytest.raises(error):
            ingest([recs] if batch else recs, params)


@pytest.mark.parametrize("algo", ["naive", "priority", "priority_pool"])
def test_run_from_a_trace_path_matches_the_reference(tmp_path, algo):
    recs, _ = _ref_records(5, op_ram_gb_mean=4.0)
    path = tmp_path / f"{algo}.json"
    path.write_text(json.dumps(recs))
    kw = _kw(scheduling_algo=algo, num_pools=2, trace_path=str(path))
    mine = run(SimParams(**kw), device="cpu")
    ref = j_run(JParams(**kw))
    _assert_contract(state_to_arrays(mine.state), ref.state, f"trace {algo}")
    assert int(mine.state.done_count) > 0


def test_fleet_of_traces_matches_the_reference_lane_by_lane():
    lanes = [_ref_records(s)[0] for s in (6, 7, 8)]
    kw = _kw(scheduling_algo="priority")
    mine_wls, params = workload_batch_from_traces(lanes, SimParams(**kw))
    states = state_to_arrays(fleet_run(params, workloads=mine_wls, device="cpu"))
    ref_wls, ref_params = j_batch_from_traces(lanes, JParams(**kw))
    ref = j_fleet_run(ref_params, workloads=ref_wls)
    for lane in range(len(lanes)):
        _assert_contract(states, ref, f"fleet lane {lane}", lane=lane)
    assert (states["done_count"] > 0).all()
