"""The port's value types, parameters, state and workload generator
against the JAX package's (``repro.core.{types,params,policy,state,
workload}``), on the CPU."""
import dataclasses
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import params as jparams
from repro.core import policy as jpolicy
from repro.core import state as jstate
from repro.core import types as jtypes
from repro.core.workload import generate_workload as j_generate
from repro_torch.bridge import state_from_arrays, state_to_arrays, workload_from_arrays
from repro_torch.core import params, policy, state, types
from repro_torch.core.workload import generate_workload, get_workload

EXAMPLE_TOML = pathlib.Path(__file__).resolve().parents[1] / "examples" / "project.toml"

PARAM_SETS = [
    {},
    {"num_pools": 3, "cloud_scaling": True, "duration": 0.25},
    {"cache_gb_per_pool": 4.0, "timeout_ticks": 100, "admission_policy": "codel"},
    {"crash_mtbf_ticks": 10.0, "client_think_ticks": 5, "straggler_prob": 0.1},
]
PROPERTIES = [
    "horizon_ticks", "data_plane_active", "faults_active", "fault_events_active",
    "fault_trace_active", "client_loop_active", "admission_active",
    "closed_loop_active", "pool_cpus", "pool_ram_gb",
]


def test_types_match_reference():
    assert types.TICKS_PER_SECOND == jtypes.TICKS_PER_SECOND
    assert types.TICK_SECONDS == jtypes.TICK_SECONDS
    assert types.INF_TICK == int(jstate.INF_TICK)
    for mine, ref in ((types.Priority, jtypes.Priority),
                      (types.PipeStatus, jtypes.PipeStatus),
                      (types.ContainerStatus, jtypes.ContainerStatus)):
        assert {m.name: int(m) for m in mine} == {m.name: int(m) for m in ref}


def test_simparams_fields_and_defaults_match_reference():
    mine = {f.name: f.default for f in dataclasses.fields(params.SimParams)}
    ref = {f.name: f.default for f in dataclasses.fields(jparams.SimParams)}
    assert mine == ref


@pytest.mark.parametrize("overrides", PARAM_SETS)
def test_simparams_properties_match_reference(overrides):
    p, j = params.SimParams(**overrides), jparams.SimParams(**overrides)
    for name in PROPERTIES:
        assert getattr(p, name) == getattr(j, name), name


def test_load_params_matches_reference():
    p, j = params.load_params(EXAMPLE_TOML), jparams.load_params(EXAMPLE_TOML)
    assert dataclasses.asdict(p) == dataclasses.asdict(j)
    d = {"Duration": 2, "NUM_POOLS": 2}
    assert dataclasses.asdict(params.load_params(d)) == dataclasses.asdict(
        jparams.load_params(d))
    with pytest.raises(KeyError, match="unknown Eudoxia parameter"):
        params.load_params({"no_such_knob": 1})


def test_policy_points_match_reference():
    assert policy.N_POLICY_PARAMS == jpolicy.N_POLICY_PARAMS
    assert policy.PolicyParams._fields == jpolicy.PolicyParams._fields
    assert policy.PolicyParams() == jpolicy.PolicyParams()
    assert {k: tuple(v) for k, v in policy.DEFAULT_POINTS.items()} == {
        k: tuple(v) for k, v in jpolicy.DEFAULT_POINTS.items()}


@pytest.mark.parametrize("overrides", PARAM_SETS[:2] + [{"admit_burst": 3.5, "max_pipelines": 16}])
def test_init_state_matches_reference_on_every_field(overrides):
    p, j = params.SimParams(**overrides), jparams.SimParams(**overrides)
    mine = state_to_arrays(state.init_state(p, 2, "cpu"))
    ref = jstate.init_state(j)
    assert state.SimState._fields == jstate.SimState._fields
    for name in jstate.SimState._fields:
        want = np.asarray(getattr(ref, name))
        got = mine[name]
        assert got.dtype == want.dtype, name
        assert got.shape == (2,) + want.shape, name
        np.testing.assert_array_equal(got[1], want, err_msg=name)


def _random_rows(rng, n_rows, MO):
    """A workload of ``n_rows`` pipelines and one assignment per row."""
    p = jparams.SimParams(max_pipelines=n_rows, max_ops_per_pipeline=MO, seed=int(rng.integers(1 << 30)))
    wl = j_generate(p)
    cpus = rng.choice([0.8, 1.6, 3.2, 6.4, 8.0, 16.0], n_rows).astype(np.float32)
    cpus[::7] = rng.random(len(cpus[::7])).astype(np.float32) * 10  # arbitrary grants
    ram = rng.choice([0.5, 1.6, 3.2, 6.4, 12.8], n_rows).astype(np.float32)
    return wl, cpus, ram


@pytest.mark.parametrize("seed", [0, 1])
def test_container_schedule_matches_reference_on_random_rows(seed):
    """``pow(c, alpha)`` for alpha in {0, 0.5, 1} and the ``ceil`` after
    it agree to the tick on every row."""
    rng = np.random.default_rng(seed)
    wl, cpus, ram = _random_rows(rng, 1024, 8)
    assert set(np.unique(np.asarray(wl.op_alpha))) <= {0.0, 0.5, 1.0}
    pipes = np.arange(1024, dtype=np.int32)
    jd, jo = jax.jit(jax.vmap(
        lambda p, c, r: jstate.container_schedule(wl, p, c, r)
    ))(jnp.asarray(pipes), jnp.asarray(cpus), jnp.asarray(ram))
    arrays = {f: np.asarray(getattr(wl, f)) for f in wl._fields if getattr(wl, f) is not None}
    twl = workload_from_arrays(arrays)
    d, o = state.container_schedule(
        twl, torch.from_numpy(pipes)[None], torch.from_numpy(cpus)[None],
        torch.from_numpy(ram)[None],
    )
    assert d.dtype == o.dtype == torch.int32
    np.testing.assert_array_equal(d[0].numpy(), np.asarray(jd))
    np.testing.assert_array_equal(o[0].numpy(), np.asarray(jo))
    assert (o[0].numpy() < types.INF_TICK).any()  # some rows OOM


def test_used_resources_matches_reference():
    rng = np.random.default_rng(4)
    j = jstate.init_state(jparams.SimParams(num_pools=3, max_containers=32))
    j = j._replace(
        ctr_status=jnp.asarray(rng.integers(0, 2, 32), jnp.int32),
        ctr_pool=jnp.asarray(rng.integers(0, 3, 32), jnp.int32),
        ctr_cpus=jnp.asarray(rng.random(32) * 4, jnp.float32),
        ctr_ram=jnp.asarray(rng.random(32) * 8, jnp.float32),
    )
    mine = state_from_arrays({f: np.asarray(getattr(j, f)) for f in j._fields})
    for a, b in zip(state.used_resources(mine), jstate.used_resources(j)):
        np.testing.assert_allclose(a[0].numpy(), np.asarray(b), rtol=1e-6)


def test_bridge_round_trips_a_reference_state():
    j = jstate.init_state(jparams.SimParams(num_pools=2))
    arrays = {f: np.asarray(getattr(j, f)) for f in j._fields}
    back = state_to_arrays(state_from_arrays(arrays))
    for name, want in arrays.items():
        np.testing.assert_array_equal(back[name][0], want, err_msg=name)


def test_generated_workload_matches_reference_in_distribution():
    """Different generators (torch vs threefry), same distributions:
    shapes and dtypes equal, and the main statistics close."""
    kw = dict(max_pipelines=2048, max_ops_per_pipeline=8, duration=1000.0)
    p, j = params.SimParams(**kw), jparams.SimParams(**kw)
    mine, ref = generate_workload(p), j_generate(j)
    for name in ref._fields:
        want = getattr(ref, name)
        if want is None:
            continue
        got = getattr(mine, name)
        assert got.dtype == getattr(torch, str(np.asarray(want).dtype)), name
        assert tuple(got.shape) == (1,) + np.asarray(want).shape, name
    a, b = mine.arrival[0].numpy(), np.asarray(ref.arrival)
    assert abs(np.diff(a).mean() / np.diff(b).mean() - 1) < 0.1
    for name, tol in (("n_ops", 0.05), ("op_ram", 0.1), ("op_base", 0.15), ("pipe_out", 0.1)):
        x, y = getattr(mine, name)[0].numpy(), np.asarray(getattr(ref, name))
        assert abs(x.mean() / y.mean() - 1) < tol, name
    assert abs((mine.prio[0].numpy() == 0).mean() - 0.6) < 0.05
    # the generator is seeded: same seed, same workload; and not the reference's
    again = generate_workload(p)
    assert all(torch.equal(x, y) for x, y in zip(mine[:10], again[:10]))
    assert get_workload(p).arrival.shape == (1, 2048)


def test_get_workload_reads_the_trace_path(tmp_path):
    """``trace_path`` replays the file (as a fleet of one, on the device
    asked for) instead of drawing from the seed."""
    path = tmp_path / "day.json"
    path.write_text('[{"arrival_s": 0.001, "priority": "BATCH", '
                    '"ops": [{"ram_gb": 1.0, "base_s": 0.002}]}]')
    wl = get_workload(params.SimParams(trace_path=str(path), max_pipelines=4,
                                       max_ops_per_pipeline=2), device="cpu")
    assert wl.arrival.tolist() == [[100, 2**31 - 1, 2**31 - 1, 2**31 - 1]]
    assert wl.op_base[0, 0].tolist() == [200.0, 0.0] and wl.prio[0, 0] == 0


def test_generated_workload_carries_a_fault_trace():
    p = params.SimParams(crash_mtbf_ticks=5.0, max_pipelines=16, max_fault_events=8)
    wl = generate_workload(p)
    assert isinstance(wl.faults, state.FaultTrace)
    assert [tuple(x.shape) for x in wl.faults] == [(1, 8)] * 4 + [(1, 16)]
    assert int(wl.faults.crash_time[0, 0]) < 2**31 - 1
    assert generate_workload(params.SimParams(max_pipelines=16)).faults is None
