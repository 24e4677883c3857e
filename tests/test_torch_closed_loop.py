"""The port's overload layer (closed-loop clients, admission control,
drain and metastability) against the JAX package's, on the CPU.

* (a) ``repro_torch.run(device="cpu")`` equals ``repro.core.run`` on the
  reference's workload (and, under the chaos layer, its fault trace)
  under the comparison contract, for the five knob sets of
  ``tests/test_closed_loop.py`` under ``priority`` and ``naive``: the
  closed-loop fields, ``pipe_status``, ``pipe_completion``,
  ``done_count`` and ``failed_count`` exactly, like every int and bool
  field; ``summary()`` equal to the reference's on every key.
* (b) a 4-lane ``fleet_run`` equals the reference's lane by lane, and
  ``fleet_summary`` equals the reference's.
* (c) each compiled policy equals the reference's on random lane-major
  states, registers included; the numpy mirrors equal the reference's.
* (d) the registry: keys normalised on ``-`` and case, unknown keys a
  ``KeyError`` naming the registered ones.
* (e) off is free: a default run leaves every closed-loop field at its
  initial value and never enters the layer.
* (f) a lane of a closed-loop fleet equals that lane run alone; the
  client backoff is an exact power of two and the retry budget sheds.

Workloads drawn by ``repro.core.generate_workload`` differ between
machines (XLA's float codegen), so on those only equality with the
reference is asserted; ``tests/test_torch_overload.py`` holds the
overload smoke and the assertions that each class fires, on
``retry_storm`` tapes.
"""
import functools
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import SimParams as JParams
from repro.core import fleet_run as j_fleet_run
from repro.core import fleet_summary as j_fleet_summary
from repro.core import generate_workload as j_generate
from repro.core import run as j_run
from repro.core import admission as j_admission
from repro.core.faults import attach_fault_traces as j_attach_traces
from repro.core.state import CLOSED_LOOP_FIELDS as J_CLOSED_LOOP_FIELDS
from repro.core.state import SimState as JSimState
from repro.core.state import init_state as j_init_state
from repro.core.sweep import make_workload_batch as j_batch
from repro_torch import SimParams, fleet_run, fleet_summary, run
from repro_torch.bridge import state_to_arrays, workload_from_arrays
from repro_torch.core import admission
from repro_torch.core.faults import attach_fault_traces
from repro_torch.core.state import CLOSED_LOOP_FIELDS, SimState, init_state, tree_map
from repro_torch.core.sweep import make_workload_batch
from repro_torch.core.types import INF_TICK
from test_torch_models import release_jax_executables  # noqa: F401 (autouse)

TOLERANT = {
    "sum_latency_s", "sum_latency_s_prio", "util_cpu_s", "util_ram_s",
    "cost_dollars", "util_log", "pool_down_s",
}
CLOSED_LOOP = dict(
    client_max_inflight=6, client_think_ticks=30, client_max_retries=3,
    client_backoff_ticks=40, admission_policy="queue_threshold", admit_queue_limit=4,
    metastable_window_ticks=400,
)
# the knob sets of tests/test_closed_loop.py:115-132
KNOBS = {
    "client_gate": dict(client_max_inflight=4, client_think_ticks=50),
    "queue_threshold": dict(admission_policy="queue_threshold", admit_queue_limit=3,
                            client_max_retries=3, client_backoff_ticks=40),
    "token_bucket": dict(admission_policy="token_bucket", admit_rate_per_s=2_000.0,
                         admit_burst=4.0),
    "codel": dict(admission_policy="codel", codel_target_ticks=300,
                  codel_interval_ticks=150, client_max_retries=2, client_backoff_ticks=30),
    "all_plus_chaos": dict(outage_mtbf_ticks=1_200.0, outage_duration_ticks=300.0,
                           max_retries=3, base_backoff_ticks=40, **CLOSED_LOOP),
}
SUMMARY_KEYS = (
    "offered", "admitted", "shed", "deferred", "client_retries", "offered_load_per_s",
    "admitted_fraction", "retry_amplification", "time_to_drain_s", "metastable",
    "fairness_jain_admission",
)
FLEET_OVERLOAD_KEYS = ("offered", "admitted", "shed", "deferred", "client_retries",
                       "admitted_fraction", "fairness_jain_done")


def _kw(algo="priority", **knobs):
    return dict(
        duration=0.04, scheduling_algo=algo, num_pools=1 if algo == "naive" else 2,
        waiting_ticks_mean=400.0, op_base_seconds_mean=0.005, op_base_seconds_sigma=1.0,
        max_pipelines=32, max_containers=32, **knobs,
    )


def _arrays(wl):
    """The reference's workload as numpy arrays, its fault trace with it."""
    out = {f: np.asarray(getattr(wl, f)) for f in wl._fields[:10]}
    if wl.faults is not None:
        out["faults"] = {f: np.asarray(getattr(wl.faults, f)) for f in wl.faults._fields}
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


def _same_value(a, b, ctx, exact=True):
    """Summary values: the same type and value, NaN for NaN; a float
    read off a tolerant field (``exact=False``) to rtol 1e-5."""
    if isinstance(a, dict):
        assert a.keys() == b.keys(), ctx
        for k in a:
            _same_value(a[k], b[k], f"{ctx}.{k}", exact or k == "admitted_fraction")
    elif isinstance(a, float) and np.isnan(a):
        assert isinstance(b, float) and np.isnan(b), ctx
    elif isinstance(a, float) and not exact:
        assert isinstance(b, float) and np.isclose(a, b, rtol=1e-5, atol=0), (ctx, a, b)
    else:
        assert type(a) is type(b) and a == b, (ctx, a, b)


@functools.lru_cache(maxsize=None)
def _run_pair(knobs: str, algo: str):
    """(port result, reference result) of one knob set, one JAX compile."""
    kw = _kw(algo, **KNOBS[knobs])
    wl = j_generate(JParams(**kw, seed=5))
    arrays = _arrays(wl)
    ref = j_run(JParams(**kw, seed=5), workload=wl)
    port = run(SimParams(**kw, seed=5), workload_from_arrays(arrays), device="cpu")
    return port, ref


# ---------------------------------------------------------------------------
# (a) run
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("algo", ["priority", "naive"])
@pytest.mark.parametrize("knobs", list(KNOBS))
def test_run_closed_loop_matches_reference(knobs, algo):
    port, ref = _run_pair(knobs, algo)
    _assert_contract(state_to_arrays(port.state), ref.state, f"{knobs}/{algo}")
    assert port.events > 0 and int(ref.state.offered_total) == int(port.state.offered_total)


@pytest.mark.parametrize("knobs", list(KNOBS))
def test_summary_matches_reference(knobs):
    port, ref = _run_pair(knobs, "priority")
    got, want = port.summary(), ref.summary()
    assert set(want) <= set(got)
    for key in want:
        _same_value(got[key], want[key], f"{knobs}: {key}", key in SUMMARY_KEYS)


# ---------------------------------------------------------------------------
# (b) fleet_run
# ---------------------------------------------------------------------------
def test_fleet_closed_loop_matches_reference_lane_by_lane():
    kw = _kw("priority_pool", **KNOBS["all_plus_chaos"])
    jparams, params = JParams(**kw), SimParams(**kw)
    wls = j_attach_traces(j_batch(jparams, [3, 4, 5, 6])._replace(faults=None), jparams)
    arrays = _arrays(wls)
    ref = j_fleet_run(jparams, workloads=wls)
    port = fleet_run(params, workloads=workload_from_arrays(arrays), device="cpu")
    states = state_to_arrays(port)
    for i in range(4):
        _assert_contract(states, type(ref)(*(np.asarray(x)[i] for x in ref)),
                         f"fleet lane {i}", lane=i)
    got, want = fleet_summary(port, params), j_fleet_summary(ref, jparams)
    assert got.keys() == want.keys()
    for key in want:
        overload = key.split("_mean")[0] in FLEET_OVERLOAD_KEYS
        _same_value(got[key], want[key], key, overload)


# ---------------------------------------------------------------------------
# (c) the policies, lane by lane, on random states
# ---------------------------------------------------------------------------
POLICY_KNOBS = {
    "admit_all": {},
    "queue_threshold": dict(admit_queue_limit=5),
    "token_bucket": dict(admit_rate_per_s=3_000.0, admit_burst=6.0),
    "codel": dict(codel_target_ticks=200, codel_interval_ticks=100),
}


def _random_state(rng, params, F):
    MP = params.max_pipelines
    state = init_state(params, F, "cpu")
    tick = rng.integers(0, 5_000, F).astype(np.int32)
    last = (tick - rng.integers(0, 3_000, F)).clip(0).astype(np.int32)
    since = np.where(rng.random(F) < 0.5, INF_TICK, tick - rng.integers(0, 400, F)).astype(np.int32)
    t = torch.from_numpy
    return state._replace(
        tick=t(tick),
        pipe_status=t(rng.integers(0, 7, (F, MP)).astype(np.int32)),
        pipe_offered=t(rng.random((F, MP)) < 0.4),
        pipe_entered=t((tick[:, None] - rng.integers(0, 800, (F, MP))).astype(np.int32)),
        admit_tokens=t((rng.random(F) * params.admit_burst).astype(np.float32)),
        admit_last_tick=t(last),
        codel_above_since=t(since),
    )


def _jstate(state, i):
    return JSimState(**{k: jnp.asarray(v[i]) for k, v in state_to_arrays(state).items()})


@pytest.mark.parametrize("seed", range(2))
@pytest.mark.parametrize("key", list(POLICY_KNOBS))
def test_compiled_policy_matches_reference(key, seed):
    kw = dict(max_pipelines=48, admission_policy=key, **POLICY_KNOBS[key])
    params, jparams = SimParams(**kw), JParams(**kw)
    rng = np.random.default_rng(seed)
    F = 8
    state = _random_state(rng, params, F)
    offered = torch.from_numpy(rng.random((F, 48)) < 0.5)
    wl = None
    new, reject, defer, dt = admission.get_admission_policy(key)(
        state, wl, params, state.tick, offered)
    assert reject.dtype == defer.dtype == torch.bool and reject.shape == (F, 48)
    for i in range(F):
        js = _jstate(state, i)
        jnew, jrej, jdef, jdt = j_admission.get_admission_policy(key)(
            js, wl, jparams, js.tick, jnp.asarray(offered[i].numpy()))
        assert dt == jdt
        np.testing.assert_array_equal(reject[i].numpy(), np.asarray(jrej), err_msg=f"{i}")
        np.testing.assert_array_equal(defer[i].numpy(), np.asarray(jdef), err_msg=f"{i}")
        for name in ("admit_tokens", "admit_last_tick", "codel_above_since"):
            np.testing.assert_array_equal(getattr(new, name)[i].numpy(),
                                          np.asarray(getattr(jnew, name)), err_msg=name)
    if key != "admit_all":
        assert bool((reject | defer).any()) and bool((offered & ~reject & ~defer).any())


@pytest.mark.parametrize("key", list(POLICY_KNOBS))
def test_python_mirror_matches_reference(key):
    kw = dict(admission_policy=key, **POLICY_KNOBS[key])
    params, jparams = SimParams(**kw), JParams(**kw)
    rng = np.random.default_rng(7)
    regs = {"tokens": np.float32(2.5), "last_tick": 0, "above_since": int(INF_TICK)}
    jregs = dict(regs)
    tick = 0
    for _ in range(40):
        tick += int(rng.integers(1, 300))
        offered = sorted(rng.choice(64, int(rng.integers(0, 9)), replace=False).tolist())
        waiting = int(rng.integers(0, 9))
        oldest = int(INF_TICK) if rng.random() < 0.2 else tick - int(rng.integers(0, 600))
        got = admission.get_admission_policy_py(key)(
            params, tick, offered, admission.AdmissionView(waiting, oldest, regs))
        want = j_admission.get_admission_policy_py(key)(
            jparams, tick, offered, j_admission.AdmissionView(waiting, oldest, jregs))
        assert got == want and regs == jregs, tick
        assert all(type(regs[k]) is type(jregs[k]) for k in regs)


# ---------------------------------------------------------------------------
# (d) the registry
# ---------------------------------------------------------------------------
def test_registry_matches_reference():
    assert admission.list_admission_policies() == j_admission.list_admission_policies()
    for key in ("queue-threshold", "Token_Bucket", "CODEL", "admit_all"):
        assert admission.has_admission_policy(key)
        assert admission.get_admission_policy(key) is admission.get_admission_policy(
            key.lower().replace("-", "_"))
        assert admission.get_admission_policy_py(key) is not None
    assert not admission.has_admission_policy("no_such_policy")
    with pytest.raises(KeyError, match="registered: .*codel.*token_bucket"):
        admission.get_admission_policy("no_such_policy")
    with pytest.raises(KeyError, match="no python mirror"):
        admission.get_admission_policy_py("no_such_policy")
    with pytest.raises(KeyError, match="queue_threshold"):
        run(SimParams(**_kw(admission_policy="no_such_policy")), device="cpu")


def test_registered_policy_runs():
    """A policy registered by a user runs through ``run``: this one
    defers every offer on odd ticks."""
    @admission.register_admission_policy("odd_tick_defer")
    def odd_tick_defer(state, wl, params, tick, offered):
        defer = offered & (tick % 2 == 1)[:, None]
        return state, torch.zeros_like(offered), defer, 3

    try:
        s = run(SimParams(**_kw(admission_policy="Odd-Tick-Defer")), device="cpu").summary()
    finally:
        admission._POLICIES.pop("odd_tick_defer")
    assert s["offered"] > 0 and s["deferred"] > 0 and s["shed"] == 0


# ---------------------------------------------------------------------------
# (e) off is free
# ---------------------------------------------------------------------------
def test_closed_loop_fields_and_initial_values_equal_the_reference():
    kw = dict(max_pipelines=16, admit_burst=3.5)
    assert CLOSED_LOOP_FIELDS == J_CLOSED_LOOP_FIELDS
    port = state_to_arrays(init_state(SimParams(**kw), 1, "cpu"))
    ref = j_init_state(JParams(**kw))
    for name in CLOSED_LOOP_FIELDS:
        want = np.asarray(getattr(ref, name))
        assert port[name][0].dtype == want.dtype, name
        np.testing.assert_array_equal(port[name][0], want, err_msg=name)


def test_closed_loop_off_state_is_pristine(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("the overload layer ran with the closed loop off")

    monkeypatch.setattr(admission, "apply_closed_loop", refuse)
    params = SimParams(**_kw(outage_mtbf_ticks=1_200.0, outage_duration_ticks=300.0))
    res = run(params, device="cpu")
    initial = init_state(params, 1, "cpu")
    for name in CLOSED_LOOP_FIELDS:
        assert torch.equal(getattr(res.state, name), getattr(initial, name)[0]), name
    assert int(res.state.outage_events) > 0 and int(res.state.done_count) > 0
    s = res.summary()
    assert s["offered"] == s["shed"] == s["client_retries"] == 0
    assert np.isnan(s["retry_amplification"]) and np.isnan(s["time_to_drain_s"])
    assert s["metastable"] is False


# ---------------------------------------------------------------------------


def test_lanes_count_on_their_own():
    """Each lane's counters are its own: a lane of a closed-loop fleet
    equals that lane run alone, and the per-priority counts sum to the
    lane's totals."""
    params = SimParams(**_kw("priority", **KNOBS["all_plus_chaos"]))
    wls = attach_fault_traces(make_workload_batch(params, [0, 1, 2]), params)
    states = fleet_run(params, workloads=wls, device="cpu")
    assert torch.equal(states.offered_prio.sum(-1), states.offered_total)
    assert torch.equal(states.admitted_prio.sum(-1), states.admitted_total)
    for i in range(3):
        lane = run(params, tree_map(lambda x: x[i:i + 1], wls), device="cpu").state
        for name in SimState._fields:
            assert torch.equal(getattr(lane, name), getattr(states, name)[i]), (i, name)


# ---------------------------------------------------------------------------
# the client retry contract
# ---------------------------------------------------------------------------
def test_client_backoff_is_exact_and_sheds_at_the_budget():
    """Rejected offers re-land at ``tick + max(min(base * 2**attempt,
    2**30), 1)`` exactly (the reference's XLA ``exp2`` is off at odd
    exponents from 13, ROADMAP queue 3), and an exhausted budget sheds
    as FAILED at the reject tick."""
    params = SimParams(max_pipelines=32, client_max_retries=20, client_backoff_ticks=37,
                       admission_policy="queue_threshold", admit_queue_limit=0)
    state = init_state(params, 1, "cpu")
    attempt = torch.arange(32, dtype=torch.int32)[None]
    state = state._replace(pipe_status=torch.full((1, 32), 2, dtype=torch.int32),
                           pipe_client_attempts=attempt)
    tick = torch.tensor([1_000], dtype=torch.int32)
    wl = SimpleNamespace(prio=torch.zeros((1, 32), dtype=torch.int32))
    out = admission.apply_closed_loop(state, wl, tick, params)
    retried = np.arange(32) < 20
    want = 1_000 + np.minimum(37 * 2.0 ** np.minimum(np.arange(32), 30), 2**30)
    np.testing.assert_array_equal(out.pipe_release[0].numpy()[retried], want[retried])
    assert (out.pipe_status[0].numpy() == np.where(retried, 4, 6)).all()
    assert (out.pipe_completion[0].numpy()[~retried] == 1_000).all()
    assert int(out.shed_total[0]) == 32 and int(out.client_retry_events[0]) == 20
    assert int(out.failed_count[0]) == 12 and int(out.nxt_release[0]) == 1_037
