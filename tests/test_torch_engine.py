"""The port's simulator main path against the JAX package's, on the CPU.

``repro_torch.run(..., device="cpu")`` and ``fleet_run`` are held to
``repro.core.run`` / ``repro.core.sweep.fleet_run`` on reference-built
workloads (carried across with ``repro_torch.bridge``), under the
comparison contract: every int and bool field and every other f32 field
exact; the f32 sums taken in another order than the reference's
(``sum_latency_s``, ``sum_latency_s_prio``, ``util_cpu_s``,
``util_ram_s``, ``cost_dollars``, ``util_log``) to rtol 1e-5, as the
reference allows itself across its own engines and batch widths.

JAX compiles once per distinct ``SimParams``, so the cases share engine
parameters per (scheduler, pools) and vary the arrival rate and RAM
scale through the workload alone (neither knob reaches the engine).
"""
import numpy as np
import pytest
import torch

from repro.core import SimParams as JParams
from repro.core import generate_workload as j_generate
from repro.core import run as j_run
from repro.core import summarize as j_summarize
from repro.core.sweep import fleet_run as j_fleet_run
from repro.core.sweep import make_workload_batch as j_batch
from repro_torch import SimParams, fleet_run, run
from repro_torch.bridge import state_to_arrays, workload_from_arrays
from repro_torch.core import engine
from repro_torch.core.executor import bucket_edges
from repro_torch.core.scheduler import get_scheduler
from repro_torch.core.state import init_state
from test_torch_serving import _assert_summary_equal
from test_torch_models import release_jax_executables  # noqa: F401 (autouse)

TOLERANT = {
    "sum_latency_s", "sum_latency_s_prio", "util_cpu_s", "util_ram_s",
    "cost_dollars", "util_log",
}


def _kw(algo, pools, **extra):
    return dict(
        duration=0.05, scheduling_algo=algo, num_pools=pools,
        op_base_seconds_mean=0.005, op_base_seconds_sigma=1.0,
        max_pipelines=32, max_containers=32, **extra,
    )


def _ref_workload(algo, pools, seed, waiting, ram):
    """A reference-built workload, as the reference's workload tuple and
    as the numpy arrays the bridge takes."""
    wl = j_generate(JParams(**_kw(algo, pools), seed=seed,
                            waiting_ticks_mean=waiting, op_ram_gb_mean=ram))
    arrays = {f: np.asarray(getattr(wl, f)) for f in wl._fields if getattr(wl, f) is not None}
    return wl, arrays


def _assert_contract(port: dict, ref, ctx, lane=None):
    for name in ref._fields:
        want = np.asarray(getattr(ref, name))
        got = port[name] if lane is None else port[name][lane]
        assert got.dtype == want.dtype and got.shape == want.shape, (ctx, name)
        if name in TOLERANT:
            np.testing.assert_allclose(got, want, rtol=1e-5, err_msg=f"{ctx}: {name}")
        else:
            np.testing.assert_array_equal(got, want, err_msg=f"{ctx}: {name}")


CASES = [
    # (scheduler, pools, seed, waiting_ticks_mean, op_ram_gb_mean)
    ("naive", 1, 1, 200.0, 2.0),
    ("naive", 2, 2, 800.0, 6.0),
    ("naive", 3, 3, 200.0, 0.5),
    ("priority", 1, 4, 200.0, 6.0),
    ("priority", 1, 5, 800.0, 2.0),
    ("priority", 2, 6, 200.0, 2.0),
    ("priority", 3, 7, 3000.0, 6.0),
    ("priority", 3, 8, 200.0, 0.5),
    ("priority_pool", 1, 9, 200.0, 2.0),
    ("priority_pool", 2, 10, 200.0, 6.0),
    ("priority_pool", 3, 11, 800.0, 0.5),
    ("priority_pool", 3, 12, 200.0, 2.0),
]


@pytest.mark.parametrize("algo,pools,seed,waiting,ram", CASES)
def test_run_matches_reference(algo, pools, seed, waiting, ram):
    wl, arrays = _ref_workload(algo, pools, seed, waiting, ram)
    ref = j_run(JParams(**_kw(algo, pools)), workload=wl)
    port = run(SimParams(**_kw(algo, pools)), workload_from_arrays(arrays), device="cpu")
    _assert_contract(state_to_arrays(port.state), ref.state, f"{algo}/p{pools}/s{seed}")
    assert int(port.state.done_count) > 0 or waiting > 1000
    if algo == "priority" and ram == 6.0 and waiting == 200.0:
        # the busy case exercises preemption and OOM retries
        assert int(port.state.preempt_events) > 0 and int(port.state.oom_events) > 0
    mine, theirs = port.summary(), j_summarize(ref.state, ref.workload, ref.params)
    for key in ("submitted", "done", "failed", "in_flight", "oom_events",
                "preempt_events", "cold_starts", "warm_starts", "cache_lookups"):
        assert mine[key] == theirs[key], key
    for key in ("mean_latency_s", "p99_latency_s", "cpu_utilization", "cost_dollars"):
        np.testing.assert_allclose(mine[key], theirs[key], rtol=1e-5, err_msg=key)


@pytest.mark.parametrize("algo,pools", [("priority", 2), ("naive", 1)])
def test_next_event_registers_match_full_recompute(algo, pools):
    """At every event, the register-based jump equals the oracle that
    recomputes the next event from the tables."""
    params = SimParams(**_kw(algo, pools), waiting_ticks_mean=200.0)
    _, arrays = _ref_workload(algo, pools, 21, 200.0, 2.0)
    wl = workload_from_arrays(arrays)
    scheduler_fn = get_scheduler(algo)
    arr_sorted = engine._sorted_arrivals(wl.arrival)
    edges = bucket_edges(params, "cpu")
    state = init_state(params, 1, "cpu")
    n_events = 0
    while int(state.tick[0]) < params.horizon_ticks:
        tick = state.tick
        active = tick < params.horizon_ticks
        new, _, dec = engine.event_step(params, scheduler_fn, state, wl, arr_sorted, edges, active)
        oracle = engine._next_event(new, wl, tick, engine._acted(dec))
        assert int(new.tick[0]) == min(int(oracle[0]), params.horizon_ticks), n_events
        state, n_events = new, n_events + 1
    assert n_events > 20


def test_fleet_lanes_match_run_and_reference_fleet():
    algo, pools = "priority_pool", 2
    params = SimParams(**_kw(algo, pools), waiting_ticks_mean=300.0)
    jparams = JParams(**_kw(algo, pools), waiting_ticks_mean=300.0)
    seeds = [3, 4, 5]
    batch = j_batch(jparams, seeds)
    arrays = {f: np.asarray(getattr(batch, f)) for f in batch._fields
              if getattr(batch, f) is not None}
    states = state_to_arrays(fleet_run(params, workloads=workload_from_arrays(arrays), device="cpu"))
    ref = j_fleet_run(jparams, workloads=j_batch(jparams, seeds))
    for i in range(len(seeds)):
        lane = {f: a[i] for f, a in arrays.items()}
        single = state_to_arrays(run(params, workload_from_arrays(lane), device="cpu").state)
        for name, got in single.items():
            np.testing.assert_array_equal(states[name][i], got, err_msg=f"lane {i}: {name}")
        ref_lane = type(ref)(*(np.asarray(x)[i] for x in ref))
        _assert_contract(states, ref_lane, f"fleet lane {i}", lane=i)


def test_fleet_run_from_seeds_is_reproducible():
    params = SimParams(**_kw("priority", 1), waiting_ticks_mean=300.0)
    a = fleet_run(params, seeds=[0, 1], device="cpu")
    b = fleet_run(params, seeds=[0, 1], device="cpu")
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert a.done_count.shape == (2,) and int(a.done_count.sum()) > 0
    with pytest.raises(ValueError, match="exactly one"):
        fleet_run(params, device="cpu")


def test_summary_has_the_reference_keys_and_slo_attainment():
    """Every key of ``repro.core.summarize`` (nested ``per_priority`` and
    ``slo_attainment`` included) at the reference's values, on the
    reference's seed-0 workload with a nonzero SLO target."""
    kw = dict(slo_latency_s=(0.5, 0.5, 0.5))
    wl = j_generate(JParams(**kw))
    ref = j_run(JParams(**kw), workload=wl)
    arrays = {f: np.asarray(getattr(wl, f)) for f in wl._fields if getattr(wl, f) is not None}
    port = run(SimParams(**kw), workload_from_arrays(arrays), device="cpu")
    mine, theirs = port.summary(), j_summarize(ref.state, ref.workload, ref.params)
    _assert_summary_equal(mine, theirs, "summary")
    np.testing.assert_allclose(
        [mine["slo_attainment"][p] for p in ("batch", "query", "interactive")],
        [1 / 6, 1 / 6, 0.5])
