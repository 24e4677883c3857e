"""The port's schedulers, the policy family and the registry against the
JAX package's, on the CPU.

* The six named schedulers with the data plane on, and ``sjf``,
  ``cache_aware`` and ``locality_pool`` with it off: ``run`` equals
  ``repro.core.run`` on the reference's workload under the comparison
  contract (every int and bool field and every other f32 field exact;
  the f32 sums taken in another order to rtol 1e-5).
* The identity wall inside the port: a named scheduler, its ``*_ref``
  oracle and the dynamic ``"policy"`` family fed its point vector give
  the same final state bit for bit, for ``run`` and a 4-lane fleet.
* A 12-lane ``policy_grid_workloads`` fleet mixing named points and
  random points of the search box equals the reference's lane by lane.
* The registry's surface, the ``ValueError``\\ s, and ``select_sjf``.

JAX compiles once per distinct ``SimParams``: each case here is one
reference run on one parameter set.
"""
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import SimParams as JParams
from repro.core import generate_workload as j_generate
from repro.core import run as j_run
from repro.core import summarize as j_summarize
from repro.core.extra_schedulers import _select_sjf as j_select_sjf_oracle
from repro.core.policy import DEFAULT_POINTS as J_POINTS
from repro.core.policy import policy_bounds as j_policy_bounds
from repro.core.sweep import fleet_run as j_fleet_run
from repro.core.sweep import policy_grid_workloads as j_grid
from repro.kernels.sched_select import select_sjf as j_select_sjf
from repro.kernels.sched_select.ref import select_sjf_ref as j_select_sjf_ref
from repro_torch import SimParams, fleet_run, run
from repro_torch.bridge import state_to_arrays, workload_from_arrays
from repro_torch.core import scheduler as sched
from repro_torch.core.extra_schedulers import _select_sjf
from repro_torch.core.policy import DEFAULT_POINTS, N_POLICY_PARAMS, PolicyParams, policy_bounds
from repro_torch.core.state import tree_map
from repro_torch.core.sweep import attach_policies, policy_grid_workloads
from repro_torch.kernels.sched_select import select_sjf, select_sjf_ref

NAMED = sorted(DEFAULT_POINTS)
TOLERANT = {
    "sum_latency_s", "sum_latency_s_prio", "util_cpu_s", "util_ram_s",
    "cost_dollars", "util_log", "pool_down_s",
}
# tests/test_policy_family.py's data plane
DATA_PLANE = dict(cache_gb_per_pool=4.0, scan_ticks_per_gb=50.0, cold_start_ticks=40,
                  container_warm_ticks=2_000)


def _kw(algo="priority", dp=True):
    return dict(
        duration=0.05, scheduling_algo=algo, num_pools=2, waiting_ticks_mean=400.0,
        op_base_seconds_mean=0.004, op_base_seconds_sigma=1.0, op_ram_gb_mean=2.0,
        max_pipelines=32, max_containers=32, **(DATA_PLANE if dp else {}),
    )


def _arrays(wl) -> dict:
    """The reference's workload as numpy arrays (policy vectors kept)."""
    return {f: np.asarray(getattr(wl, f)) for f in wl._fields if getattr(wl, f) is not None}


def _assert_contract(port: dict, ref, ctx, lane=None):
    for name in ref._fields:
        want = np.asarray(getattr(ref, name))
        want = want if lane is None else want[lane]
        got = port[name] if lane is None else port[name][lane]
        assert got.dtype == want.dtype and got.shape == want.shape, (ctx, name)
        if name in TOLERANT:
            np.testing.assert_allclose(got, want, rtol=1e-5, err_msg=f"{ctx}: {name}")
        else:
            np.testing.assert_array_equal(got, want, err_msg=f"{ctx}: {name}")


def _assert_same(a: dict, b: dict, ctx):
    for name in a:
        np.testing.assert_array_equal(a[name], b[name], err_msg=f"{ctx}: {name}")


# ---------------------------------------------------------------------------
# The named schedulers against the reference
# ---------------------------------------------------------------------------
# summarize's data-plane keys, read from the state
DATA_PLANE_KEYS = ("cache_hit_gb", "bytes_moved_gb", "cache_hit_rate", "cache_hits",
                   "cache_lookups", "cache_resident_gb", "cold_starts", "warm_starts",
                   "cold_start_ticks", "cold_start_s")
REF_CASES = [(algo, True) for algo in NAMED] + [
    (algo, False) for algo in ("cache_aware", "locality_pool", "sjf")]


@pytest.mark.parametrize("algo,dp", REF_CASES, ids=lambda v: str(v))
def test_named_scheduler_matches_reference(algo, dp):
    jp = JParams(**_kw(algo, dp))
    wl = j_generate(jp)
    ref = j_run(jp, workload=wl)
    port = run(SimParams(**_kw(algo, dp)), workload_from_arrays(_arrays(wl)), device="cpu")
    _assert_contract(state_to_arrays(port.state), ref.state, f"{algo}/dp={dp}")
    s, want = port.summary(), j_summarize(ref.state, ref.workload, ref.params)
    for key in DATA_PLANE_KEYS:
        assert s[key] == want[key], key
    assert s["done"] > 0
    if dp:
        assert s["cold_starts"] > 0 and s["cold_start_ticks"] > 0
        assert s["cache_lookups"] > 0 and s["cache_resident_gb"] > 0


# ---------------------------------------------------------------------------
# The identity wall: named == *_ref == the point vector, bit for bit
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def port_batch():
    """Four seed-generated lanes from the port's own generator."""
    from repro_torch.core.sweep import make_workload_batch

    return make_workload_batch(SimParams(**_kw()), [0, 1, 2, 3])


@pytest.mark.parametrize("algo", NAMED)
def test_named_equals_ref_and_vector(algo, port_batch):
    params = SimParams(**_kw(algo))
    lane0 = tree_map(lambda x: x[:1], port_batch)
    named = run(params, lane0, device="cpu")
    oracle = run(params.replace(scheduling_algo=f"{algo}_ref"), lane0, device="cpu")
    vector = run(params.replace(scheduling_algo="policy"),
                 attach_policies(lane0, DEFAULT_POINTS[algo]), device="cpu")
    want = state_to_arrays(named.state)
    _assert_same(state_to_arrays(oracle.state), want, f"run/{algo}_ref")
    _assert_same(state_to_arrays(vector.state), want, f"run/policy@{algo}")
    assert named.events == oracle.events == vector.events

    fleet = state_to_arrays(fleet_run(params, workloads=port_batch, device="cpu"))
    for key, wls in ((f"{algo}_ref", port_batch),
                     ("policy", attach_policies(port_batch, DEFAULT_POINTS[algo]))):
        got = fleet_run(params, workloads=wls, scheduler_key=key, device="cpu")
        _assert_same(state_to_arrays(got), fleet, f"fleet/{key}")
    for name, x in want.items():
        np.testing.assert_array_equal(fleet[name][0], x, err_msg=f"fleet lane 0 vs run: {name}")


# ---------------------------------------------------------------------------
# A mixed policy grid against the reference
# ---------------------------------------------------------------------------
def _grid_points() -> np.ndarray:
    """Three named points and three random points of the search box."""
    rng = np.random.default_rng(19)
    lo, hi = policy_bounds()
    rand = [lo + (hi - lo) * rng.random(N_POLICY_PARAMS, dtype=np.float32) for _ in range(3)]
    named = [DEFAULT_POINTS[k].to_vector() for k in ("sjf", "priority_pool", "naive")]
    return np.stack(named + rand).astype(np.float32)


def _j_scenarios(jp, seeds):
    """The reference's ``make_workload_batch`` lane by lane (lane ``i``
    is ``generate_workload(params, PRNGKey(seeds[i]))``), without the
    compile of its vmapped generator."""
    lanes = [j_generate(jp, jax.random.PRNGKey(s)) for s in seeds]
    return jax.tree.map(lambda *xs: jnp.stack(xs), *lanes)


def test_policy_grid_matches_reference():
    points = _grid_points()
    lo, hi = policy_bounds()
    j_lo, j_hi = j_policy_bounds()
    np.testing.assert_array_equal(lo, j_lo)
    np.testing.assert_array_equal(hi, j_hi)
    # a shorter horizon: one random point preempts in exclusive mode and
    # wakes the engine at every tick
    kw = {**_kw(), "duration": 0.02}
    jp = JParams(**kw)
    scenarios = _j_scenarios(jp, [0, 1])
    grid, C, S = j_grid(scenarios, points)
    assert (C, S) == (6, 2)
    arrays = _arrays(grid)
    ref = j_fleet_run(jp, workloads=grid, scheduler_key="policy")
    port = fleet_run(SimParams(**kw), workloads=workload_from_arrays(arrays),
                     scheduler_key="policy", device="cpu")
    got = state_to_arrays(port)
    for lane in range(C * S):
        _assert_contract(got, ref, f"grid lane {lane}", lane=lane)
    # the port builds the same grid from the same scenario batch
    mine, c, s = policy_grid_workloads(workload_from_arrays(_arrays(scenarios)), points)
    assert (c, s) == (C, S)
    for f in ("arrival", "op_out", "policy"):
        np.testing.assert_array_equal(getattr(mine, f).numpy(), arrays[f], err_msg=f)
    assert int(got["cache_hits"].sum()) > 0
    # the first random point turns on exclusive mode and preemption: the
    # reference then suspends a victim at nearly every event without
    # assigning in its place (ROADMAP queue 3), and the port mirrors it
    excl_preempt = points[3]
    assert excl_preempt[PolicyParams._fields.index("exclusive")] > 0.5
    assert excl_preempt[PolicyParams._fields.index("preempt")] > 0.5
    assert (got["preempt_events"][6:8] > 100).all()


# ---------------------------------------------------------------------------
# The registry's surface
# ---------------------------------------------------------------------------
def test_policy_points_registry():
    pts = sched.policy_points()
    assert set(NAMED) <= set(pts)
    for name in NAMED:
        assert sched.has_policy_point(name)
        vec = sched.get_policy_point(name).to_vector()
        np.testing.assert_array_equal(vec, J_POINTS[name].to_vector(), err_msg=name)
        np.testing.assert_array_equal(PolicyParams.from_vector(vec).to_vector(), vec)
    assert not sched.has_policy_point("policy")
    with pytest.raises(KeyError, match="policy point"):
        sched.get_policy_point("policy")
    for key in NAMED + [f"{n}_ref" for n in NAMED] + ["policy"]:
        assert sched.has_vector_scheduler(key), key
    with pytest.raises(KeyError, match="unknown scheduler"):
        sched.get_vector_scheduler("no_such_scheduler")


def test_user_registered_stateful_scheduler():
    """A lane-major scheduler with a state of its own: the engine starts
    it from its init, threads it per lane and returns it in the result."""
    key = "counting_priority_test"
    inner = sched.get_vector_scheduler("priority")

    @sched.register_vector_scheduler_init(key)
    def _init(params):
        return {"calls": torch.zeros((), dtype=torch.int32)}

    @sched.register_vector_scheduler(key)
    def _counting(sched_state, sim, wl, params, active):
        _, dec = inner(None, sim, wl, params, active)
        return {"calls": sched_state["calls"] + 1}, dec

    try:
        params = SimParams(**_kw("priority"))
        base = run(params, device="cpu")
        res = run(params.replace(scheduling_algo=key),
                  tree_map(lambda x: x[None], base.workload), device="cpu")
        assert base.sched_state is None
        assert res.sched_state["calls"].shape == ()
        assert int(res.sched_state["calls"]) == res.events > 0
        _assert_same(state_to_arrays(res.state), state_to_arrays(base.state), "stateful")
    finally:
        for table in (sched._VECTOR_FAMILIES, sched._VECTOR_INITS):
            table.pop(key, None)
        sched._invalidate(key)


def test_deprecated_fleet_registry_warns():
    key = "deprecated_shim_test"
    fn = sched.get_vector_scheduler("priority")
    try:
        with pytest.warns(DeprecationWarning, match="deprecated"):
            sched.register_fleet_vector_scheduler(key)(fn)
        with pytest.warns(DeprecationWarning, match="deprecated"):
            assert sched.get_fleet_vector_scheduler(key) is fn
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            assert sched.get_vector_scheduler(key, early_exit=True) is fn
    finally:
        sched._VECTOR_FAMILIES.pop(key, None)
        sched._SHIM_EARLY_EXIT.pop(key, None)
        sched._invalidate(key)


# ---------------------------------------------------------------------------
# The reference's ValueErrors
# ---------------------------------------------------------------------------
def test_policy_errors(port_batch):
    params = SimParams(**_kw("policy", dp=False))
    with pytest.raises(ValueError, match="policy"):
        fleet_run(params, workloads=port_batch, device="cpu")
    with pytest.raises(ValueError):
        attach_policies(port_batch, np.zeros((3, N_POLICY_PARAMS), np.float32))
    with pytest.raises(ValueError):
        attach_policies(port_batch, np.zeros((4, N_POLICY_PARAMS + 1), np.float32))
    with pytest.raises(ValueError, match="grid"):
        policy_grid_workloads(port_batch, np.zeros((N_POLICY_PARAMS,), np.float32))
    with_pol = attach_policies(port_batch, DEFAULT_POINTS["sjf"])
    assert tuple(with_pol.policy.shape) == (4, N_POLICY_PARAMS)
    with pytest.raises(ValueError, match="already carries"):
        policy_grid_workloads(with_pol, [DEFAULT_POINTS["sjf"]])
    bad = with_pol._replace(policy=with_pol.policy[:, :3])
    with pytest.raises(ValueError, match="policy vectors are shaped"):
        fleet_run(params, workloads=bad, device="cpu")


# ---------------------------------------------------------------------------
# select_sjf at the SJF key set
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("seed", range(4))
def test_select_sjf_matches_reference(seed):
    rng = np.random.default_rng(seed)
    F, N = 16, 67
    mask = rng.random((F, N)) < (0.02 if seed == 0 else 0.5)
    mask[0] = False                                    # an empty lane
    n_ops = rng.integers(1, 4, (F, N)).astype(np.int32)  # the lead key ties often
    prio = rng.integers(0, 3, (F, N)).astype(np.int32)
    entered = rng.integers(0, 5, (F, N)).astype(np.int32)
    args = [torch.from_numpy(x) for x in (mask, n_ops, prio, entered)]
    want = np.asarray(j_select_sjf_ref(*map(jnp.asarray, (mask, n_ops, prio, entered))))
    oracle = np.stack([np.asarray(j_select_sjf_oracle(*map(jnp.asarray, x)))
                       for x in zip(mask, n_ops, prio, entered)])
    np.testing.assert_array_equal(want, oracle)
    np.testing.assert_array_equal(
        want, np.asarray(j_select_sjf(*map(jnp.asarray, (mask, n_ops, prio, entered)))))
    for got in (select_sjf(*args), select_sjf_ref(*args), _select_sjf(*args)):
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
    assert want[0] == -1
