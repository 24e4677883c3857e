"""The port's chaos layer against the JAX package's, on the CPU.

* (a) ``repro_torch.run(device="cpu")`` equals ``repro.core.run`` on the
  reference's workload and fault trace (carried across by
  ``bridge.workload_from_arrays``) under the comparison contract: every
  int and bool field and ``pool_*_free`` exact; the f32 sums taken in
  another order, ``pool_down_s`` among them, to rtol 1e-5. The knob sets
  are those of ``tests/test_faults.py`` (whose horizon of 4,000 ticks
  is shorter than their timeouts), plus two whose timeouts fire.
* (b) a 4-lane ``fleet_run`` equals the reference's on
  ``attach_fault_traces`` batches, lane by lane, and each lane equals
  the port's own ``run``.
* (c) the plain ``retire_land`` with the timeout branch on equals the
  reference's ``retire_land_ref`` (the f32 sums to rtol 1e-5) and the
  Pallas kernel in interpret mode on every int and bool output (the
  Pallas kernel's f32 sums disagree with its own ref: ROADMAP queue 3).
* (d) fault records round-trip exactly against the reference's.
* (e) the port's own generator (``torch.Generator``, other numbers than
  threefry): seeded, per lane, and of the stated distributions.
* (f) the ``nxt_fault`` register against the oracle at every event.
* (g) a faults-off run never enters the chaos layer.
* the retry policy's backoff is an exact power of two.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import SimParams as JParams
from repro.core import fleet_run as j_fleet_run
from repro.core import generate_workload as j_generate
from repro.core import run as j_run
from repro.core.faults import (
    attach_fault_traces as j_attach_traces,
    fault_trace_from_records as j_from_records,
    fault_trace_to_records as j_to_records,
    generate_fault_trace as j_generate_trace,
)
from repro.core.sweep import make_workload_batch as j_batch
from repro.kernels.state_update.kernel import retire_land_kernel
from repro.kernels.state_update.ref import retire_land_ref as j_retire_ref
from repro_torch import SimParams, fleet_run, run
from repro_torch.bridge import state_to_arrays, workload_from_arrays
from repro_torch.core import engine, executor, faults, sweep, workload
from repro_torch.core.executor import bucket_edges
from repro_torch.core.scheduler import get_scheduler
from repro_torch.core.state import FaultTrace, init_state
from repro_torch.core.types import INF_TICK
from repro_torch.kernels.state_update import retire_land
from test_torch_kernels import LAT_OUTPUTS, _retire_tables, _same, _t
from test_torch_models import release_jax_executables  # noqa: F401 (autouse)

TOLERANT = {
    "sum_latency_s", "sum_latency_s_prio", "util_cpu_s", "util_ram_s",
    "cost_dollars", "util_log", "pool_down_s",
}
CHAOS = dict(
    crash_mtbf_ticks=500.0, outage_mtbf_ticks=1_500.0, outage_duration_ticks=300.0,
    straggler_prob=0.15, timeout_ticks=30_000, max_retries=3, base_backoff_ticks=40,
)
KNOBS = {
    "crash": dict(crash_mtbf_ticks=500.0, max_retries=3, base_backoff_ticks=40),
    "outage": dict(outage_mtbf_ticks=1_200.0, outage_duration_ticks=300.0,
                   max_retries=3, base_backoff_ticks=40),
    "timeout": dict(timeout_ticks=25_000, max_retries=2, base_backoff_ticks=30),
    "straggler": dict(straggler_prob=0.3),
    "all": CHAOS,
    # timeouts inside the horizon, and a retry budget that runs out
    "timeout-fires": dict(timeout_ticks=300, max_retries=2, base_backoff_ticks=30),
    "all-fires": {**CHAOS, "timeout_ticks": 400, "max_retries": 1},
}


def _kw(algo, **knobs):
    return dict(
        duration=0.04, scheduling_algo=algo, num_pools=1 if algo == "naive" else 2,
        waiting_ticks_mean=400.0, op_base_seconds_mean=0.005, op_base_seconds_sigma=1.0,
        max_pipelines=32, max_containers=32, **knobs,
    )


def _arrays(wl, lane=None):
    """The reference's workload as numpy arrays, its fault trace with it."""
    pick = (lambda x: np.asarray(x)) if lane is None else (lambda x: np.asarray(x)[lane])
    out = {f: pick(getattr(wl, f)) for f in wl._fields[:10]}
    if wl.faults is not None:
        out["faults"] = {f: pick(getattr(wl.faults, f)) for f in wl.faults._fields}
    return out


def _assert_contract(port: dict, ref, ctx, lane=None):
    for name in ref._fields:
        want = np.asarray(getattr(ref, name))
        got = port[name] if lane is None else port[name][lane]
        assert got.dtype == want.dtype and got.shape == want.shape, (ctx, name)
        if name in TOLERANT:
            np.testing.assert_allclose(got, want, rtol=1e-5, err_msg=f"{ctx}: {name}")
        else:
            np.testing.assert_array_equal(got, want, err_msg=f"{ctx}: {name}")


# ---------------------------------------------------------------------------
# (a) run
# ---------------------------------------------------------------------------
RUN_CASES = [(k, algo) for k in ("crash", "outage", "timeout", "straggler", "all")
             for algo in ("priority", "naive")]
RUN_CASES += [("all", "priority_pool"), ("timeout-fires", "priority"),
              ("all-fires", "priority_pool")]


@pytest.mark.parametrize("knobs,algo", RUN_CASES)
def test_run_under_faults_matches_reference(knobs, algo):
    kw = _kw(algo, **KNOBS[knobs])
    wl = j_generate(JParams(**kw, seed=5))
    arrays = _arrays(wl)
    ref = j_run(JParams(**kw, seed=5), workload=wl)
    port = run(SimParams(**kw, seed=5), workload_from_arrays(arrays), device="cpu")
    _assert_contract(state_to_arrays(port.state), ref.state, f"{knobs}/{algo}")
    s = port.state
    if knobs.endswith("fires"):
        assert int(s.timeout_events) > 0 and int(s.retry_events) > 0
    if knobs == "all-fires":
        assert int(s.crash_events) > 0 and int(s.outage_events) > 0
        assert int(s.fault_kills) > 0 and int(s.failed_count) > 0


# ---------------------------------------------------------------------------
# (b) fleet_run
# ---------------------------------------------------------------------------
def test_fleet_under_faults_matches_reference_lane_by_lane():
    kw = _kw("priority_pool", **KNOBS["all-fires"])
    jparams, params = JParams(**kw), SimParams(**kw)
    seeds = [3, 4, 5, 6]
    wls = j_attach_traces(j_batch(jparams, seeds)._replace(faults=None), jparams)
    arrays = _arrays(wls)                      # before the reference consumes wls
    ref = j_fleet_run(jparams, workloads=wls)
    states = state_to_arrays(fleet_run(params, workloads=workload_from_arrays(arrays),
                                       device="cpu"))
    for i in range(len(seeds)):
        ref_lane = type(ref)(*(np.asarray(x)[i] for x in ref))
        _assert_contract(states, ref_lane, f"fleet lane {i}", lane=i)
        lane = {f: (a[i] if f != "faults" else {k: v[i] for k, v in a.items()})
                for f, a in arrays.items()}
        single = state_to_arrays(run(params, workload_from_arrays(lane), device="cpu").state)
        for name, got in single.items():
            np.testing.assert_array_equal(states[name][i], got, err_msg=f"lane {i}: {name}")
    assert int(states["crash_events"].sum()) > 0 and int(states["timeout_events"].sum()) > 0


def test_fleet_run_attaches_a_trace_per_lane():
    """A bare batch under the chaos layer gets a trace per lane from
    params.seed; seeds keep each lane's own trace."""
    params = SimParams(**_kw("priority", **KNOBS["crash"]))
    batch = sweep.make_workload_batch(params, [0, 1])
    for i, s in enumerate((0, 1)):
        own = faults.generate_fault_trace(params, s)
        assert torch.equal(batch.faults.crash_time[i], own.crash_time[0])
    bare = batch._replace(faults=None)
    attached = faults.attach_fault_traces(bare, params)
    a = fleet_run(params, workloads=bare, device="cpu")
    b = fleet_run(params, workloads=attached, device="cpu")
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(attached.faults.crash_time[0], attached.faults.crash_time[1])


# ---------------------------------------------------------------------------
# (c) retire_land with the timeout branch on
# ---------------------------------------------------------------------------
def _timed_tables(seed, F, MC, MP):
    rng = np.random.default_rng(seed)
    args = list(_retire_tables(rng, F, MC, MP))
    args[5] = rng.random((F, MC)) < 0.3                  # ctr_timed
    return tuple(args)


@pytest.mark.parametrize("F", [1, 3, 8])
def test_retire_land_timeout_plain_matches_jax_ref(F):
    args = _timed_tables(F, F, 64, 32)
    port = retire_land(*map(_t, args), timeout_on=True)
    ref = j_retire_ref(*map(jnp.asarray, args), timeout_on=True)
    _same(port, ref, "retire_land timeout vs ref", rtol_at=LAT_OUTPUTS)
    timed_hit, done_hit, wasted = port[2], port[1], port[4]
    assert bool(timed_hit.any()) and int(wasted.sum()) > 0
    # a pipeline with a timed and a done container at once
    assert bool((timed_hit & done_hit).any())


def test_retire_land_timeout_plain_matches_pallas_interpret():
    args = _timed_tables(11, 6, 16, 32)
    port = retire_land(*map(_t, args), timeout_on=True)
    kern = retire_land_kernel(*map(jnp.asarray, args), timeout_on=True, block_fleet=4,
                              interpret=True)
    ints = [i for i in range(10) if i not in LAT_OUTPUTS]
    _same([port[i] for i in ints],
          [np.asarray(kern[i]).astype(bool) if port[i].dtype == torch.bool else kern[i]
           for i in ints], "retire_land timeout vs pallas")


# ---------------------------------------------------------------------------
# (d) records
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("knobs", ["crash", "outage", "straggler", "all"])
def test_fault_records_round_trip_against_the_reference(knobs):
    jp = JParams(**_kw("priority", **KNOBS[knobs]))
    p = SimParams(**_kw("priority", **KNOBS[knobs]))
    jft = j_generate_trace(jp)
    records = j_to_records(jft)
    mine = workload_from_arrays(_arrays(j_generate(jp))).faults
    assert faults.fault_trace_to_records(mine) == records
    back = faults.fault_trace_from_records(records, p)
    for name in FaultTrace._fields:
        np.testing.assert_array_equal(getattr(back, name)[0].numpy(), np.asarray(getattr(jft, name)))
    # short lists pad the same way
    short = {"crash_time": records["crash_time"][:3], "straggler": records["straggler"][:5]}
    padded, jpadded = faults.fault_trace_from_records(short, p), j_from_records(short, jp)
    for name in FaultTrace._fields:
        np.testing.assert_array_equal(getattr(padded, name)[0].numpy(),
                                      np.asarray(getattr(jpadded, name)))


@pytest.mark.parametrize("field,n", [("crash_time", 65), ("outage_pool", 70), ("straggler", 33)])
def test_fault_records_over_capacity_raise_the_same_error(field, n):
    records = {field: [1] * n}
    with pytest.raises(ValueError) as mine:
        faults.fault_trace_from_records(records, SimParams(max_pipelines=32))
    with pytest.raises(ValueError) as theirs:
        j_from_records(records, JParams(max_pipelines=32))
    assert str(mine.value) == str(theirs.value)


# ---------------------------------------------------------------------------
# (e) the port's generator
# ---------------------------------------------------------------------------
def test_generator_is_seeded_and_of_the_stated_distributions():
    p = SimParams(duration=60.0, max_pipelines=4096, max_fault_events=4096, num_pools=3,
                  crash_mtbf_ticks=1_000.0, outage_mtbf_ticks=1_200.0,
                  outage_duration_ticks=300.0, straggler_prob=0.2, straggler_factor=3.0)
    ft = faults.generate_fault_trace(p)
    again = faults.generate_fault_trace(p)
    assert all(torch.equal(a, b) for a, b in zip(ft, again))
    other = faults.generate_fault_trace(p, seed=1)
    assert not torch.equal(ft.crash_time, other.crash_time)
    dtypes = (torch.int32,) * 4 + (torch.float32,)
    shapes = [(1, 4096)] * 4 + [(1, 4096)]
    assert [x.dtype for x in ft] == list(dtypes) and [tuple(x.shape) for x in ft] == shapes
    # 4,096 gaps: the mean within 5 % of the mtbf (3 standard errors)
    for times, mtbf in ((ft.crash_time[0], 1_000.0), (ft.outage_start[0], 1_200.0)):
        assert bool((times[1:] >= times[:-1]).all())
        live = times[times < INF_TICK].double()
        assert len(live) == 4096
        assert abs(live.diff().mean().item() / mtbf - 1) < 0.05
    dur = (ft.outage_end - ft.outage_start)[0].double()
    assert dur.min().item() >= 1 and abs(dur.mean().item() / 300.0 - 1) < 0.05
    pools = ft.outage_pool[0]
    assert set(pools.tolist()) == {0, 1, 2}
    s = ft.straggler[0]
    assert set(s.tolist()) == {1.0, 3.0} and abs((s > 1).double().mean().item() - 0.2) < 0.03
    # past the horizon: INF_TICK, sorted, never a tick at or beyond it
    short = faults.generate_fault_trace(p.replace(duration=0.5))
    t = short.crash_time[0]
    assert bool((t[t < INF_TICK] < 50_000).all()) and int((t == INF_TICK).sum()) > 0
    assert bool((t[1:] >= t[:-1]).all())
    # classes off: padding
    off = faults.generate_fault_trace(SimParams(max_pipelines=8, straggler_prob=0.5))
    assert bool((off.crash_time == INF_TICK).all()) and bool((off.outage_pool == 0).all())


def test_generator_leaves_the_workload_draws_alone():
    base = dict(max_pipelines=32, max_ops_per_pipeline=4, duration=0.05)
    plain = workload.generate_workload(SimParams(**base))
    chaos = workload.generate_workload(SimParams(**base, **KNOBS["all"]))
    assert all(torch.equal(a, b) for a, b in zip(plain[:10], chaos[:10]))
    assert plain.faults is None and chaos.faults is not None
    lanes = faults.attach_fault_traces(sweep.make_workload_batch(
        SimParams(**base), [0, 1, 2]), SimParams(**base, **KNOBS["all"])).faults
    assert len({tuple(x.tolist()) for x in lanes.crash_time}) == 3


# ---------------------------------------------------------------------------
# (f) the register against the oracle
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("algo", ["priority_pool", "naive"])
def test_next_event_registers_match_full_recompute_under_faults(algo):
    kw = _kw(algo, **KNOBS["all-fires"])
    params = SimParams(**kw)
    wl = workload_from_arrays(_arrays(j_generate(JParams(**kw, seed=21))))
    scheduler_fn = get_scheduler(algo)
    arr_sorted = engine._sorted_arrivals(wl.arrival)
    edges = bucket_edges(params, "cpu")
    state = init_state(params, 1, "cpu")
    n_events = n_fault_passes = 0
    while int(state.tick[0]) < params.horizon_ticks:
        tick = state.tick
        active = tick < params.horizon_ticks
        _, due = engine.fault_gate(state, active, params)
        new, _, dec = engine.event_step(params, scheduler_fn, state, wl, arr_sorted, edges,
                                        active, due)
        oracle = engine._next_event(new, wl, tick, engine._acted(dec))
        assert int(new.tick[0]) == min(int(oracle[0]), params.horizon_ticks), n_events
        state, n_events, n_fault_passes = new, n_events + 1, n_fault_passes + due
    assert n_events > 20 and 0 < n_fault_passes < n_events
    assert int(state.crash_events[0]) > 0 and int(state.outage_events[0]) > 0


# ---------------------------------------------------------------------------
# (g) faults off
# ---------------------------------------------------------------------------
def test_faults_off_never_enters_the_chaos_layer(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("the chaos layer ran in a faults-off run")

    for mod, name in ((executor, "apply_faults"), (executor, "requeue_faulted"),
                      (engine, "attach_fault_trace"), (workload, "attach_fault_trace"),
                      (sweep, "attach_fault_traces")):
        monkeypatch.setattr(mod, name, refuse)
    params = SimParams(**_kw("priority"))
    res = run(params, device="cpu")
    states = fleet_run(params, seeds=[0, 1], device="cpu")
    assert res.workload.faults is None and int(res.state.done_count) > 0
    assert int(res.state.nxt_fault) == INF_TICK and int(states.crash_events.sum()) == 0


# ---------------------------------------------------------------------------
# the retry policy
# ---------------------------------------------------------------------------
def test_backoff_is_an_exact_power_of_two():
    """``base * 2**attempt`` exactly, to the cap; the reference's XLA
    ``exp2`` is off at odd exponents from 13 (ROADMAP queue 3), where no
    retry budget of the repo reaches."""
    params = SimParams(max_pipelines=32, max_retries=40, base_backoff_ticks=40)
    state = init_state(params, 1, "cpu")
    attempt = torch.arange(32, dtype=torch.int32)[None]
    state = state._replace(pipe_retries=attempt)
    tick = torch.tensor([1_000], dtype=torch.int32)
    out = executor.requeue_faulted(state, tick, params, torch.ones((1, 32), dtype=torch.bool))
    want = 1_000 + np.minimum(40 * 2.0 ** np.minimum(np.arange(32), 30), 2**30)
    np.testing.assert_array_equal(out.pipe_release[0].numpy(), want.astype(np.int64))
    assert int(out.retry_events[0]) == 32 and int(out.nxt_release[0]) == 1_040
