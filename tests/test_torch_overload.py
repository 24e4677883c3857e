"""The overload layer on ``retry_storm`` tapes, on the CPU.

* (a) ``benchmarks/run.py``'s overload smoke (4 lanes, ``admit_all``
  and ``queue_threshold`` with limit 3) equals the JAX package's lane by
  lane under the comparison contract, on the reference's fault traces:
  the drained and metastable lanes are the reference's.
* (b) every class of the layer fires, on a storm of half the length:
  offers, admissions, sheds, client retries, defers by the token bucket
  and by the client gate, outages on every lane, and drains;
  ``admit_all`` sheds nothing at amplification 1.0.
* (c) the event skip stays exact: the ``nxt_release`` register against
  the oracle at every event while deferred and retried offers are in
  flight.
* (d) the reference's overload table of ``chip_smoke.py`` phase 6c (b)
  (``tests/captures/torch_overload_reference.json``): its fault traces
  round-trip through the port's records, and its ``queue_threshold`` row
  is the CPU port's on them.

The tapes come from numpy (``retry_storm``) and the fault traces of
(b) and (c) from the port's generator on the CPU, so the counts that
(b) asserts are the same on every machine.
"""
import functools
import json
import pathlib

import numpy as np
import pytest
import torch

from repro.core import SimParams as JParams
from repro.core import fleet_run as j_fleet_run
from repro.core import workload_batch_from_traces as j_batch_from_traces
from repro.core.faults import attach_fault_traces as j_attach_traces
from repro.core.scenarios import retry_storm_params as j_retry_storm_params
from repro_torch import SimParams, fleet_run, fleet_summary
from repro_torch.bridge import state_to_arrays, workload_from_arrays
from repro_torch.core import engine, executor
from repro_torch.core.faults import (
    attach_fault_traces,
    fault_trace_from_records,
    fault_trace_to_records,
)
from repro_torch.core.scenarios import retry_storm_params, scenario_lane_batch
from repro_torch.core.scheduler import get_scheduler
from repro_torch.core.state import init_state, tree_map
from repro_torch.core.types import INF_TICK
from repro_torch.core.workload import workload_batch_from_traces
from test_torch_closed_loop import _arrays, _assert_contract
from test_torch_models import release_jax_executables  # noqa: F401 (autouse)

# the policies' knobs of benchmarks/scheduler_comparison.py's OVERLOAD_POLICIES
ARMS = {
    "admit_all": dict(admission_policy="admit_all"),
    "queue_threshold": dict(admission_policy="queue_threshold", admit_queue_limit=3),
    "token_bucket": dict(admission_policy="token_bucket", admit_rate_per_s=400.0,
                         admit_burst=4.0),
    "codel": dict(admission_policy="codel", codel_target_ticks=400, codel_interval_ticks=200),
    "client_gate": dict(client_max_inflight=4),
}


def _base(duration):
    return SimParams(
        duration=duration, max_pipelines=0, max_ops_per_pipeline=0, max_containers=16,
        waiting_ticks_mean=150.0, op_base_seconds_mean=0.008, op_base_seconds_sigma=1.0,
        num_pools=2, total_cpus=4, total_ram_gb=8, scheduling_algo="priority_pool",
    )


# benchmarks/run.py's overload smoke: a 0.06 s tape in a 0.08 s run
# (a quiet tail), outages every 0.02 s lasting 0.006 s; and the same at
# half the length
SMOKE = dict(duration=0.08, tape_s=0.06, outage_mtbf_s=0.02, outage_duration_s=0.006)
SHORT = dict(duration=0.04, tape_s=0.03, outage_mtbf_s=0.01, outage_duration_s=0.003)


def _storm(n_lanes, seed, duration, tape_s, outage_mtbf_s, outage_duration_s, **arm):
    """retry_storm tapes (surge factor 6) under at most two outages, with
    clients that retry three times. Returns (records, base params,
    batch, params)."""
    base = _base(duration)
    lanes = scenario_lane_batch("retry_storm", base.replace(duration=tape_s), n_lanes,
                                seed=seed, surge_factor=6.0)
    wls, params = workload_batch_from_traces(lanes, base)
    policy_knobs = {k: arm.pop(k) for k in list(arm)
                    if k.startswith(("admit_rate", "admit_burst", "codel"))}
    params = retry_storm_params(
        params, outage_mtbf_s=outage_mtbf_s, outage_duration_s=outage_duration_s,
        client_max_retries=3, **arm,
    ).replace(max_fault_events=2, **policy_knobs)
    return lanes, base, wls, params


# ---------------------------------------------------------------------------
# (a) the overload smoke against the reference, on its fault traces
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arm", ["admit_all", "queue_threshold"])
def test_overload_smoke_matches_reference_lane_by_lane(arm):
    knobs = ARMS[arm]
    lanes, base, wls, params = _storm(4, 3, **SMOKE, **knobs)
    jbase = JParams(**{f: getattr(base, f) for f in JParams.__dataclass_fields__})
    jwls, jp = j_batch_from_traces(lanes, jbase)
    jp = j_retry_storm_params(jp, outage_mtbf_s=0.02, outage_duration_s=0.006,
                              client_max_retries=3, **knobs).replace(max_fault_events=2)
    assert jp == JParams(**{f: getattr(params, f) for f in JParams.__dataclass_fields__})
    jwls = j_attach_traces(jwls, jp)
    arrays = _arrays(jwls)
    for name in wls._fields[:10]:
        np.testing.assert_array_equal(getattr(wls, name).numpy(), arrays[name], err_msg=name)
    ref = j_fleet_run(jp, workloads=jwls)
    states = state_to_arrays(fleet_run(params, workloads=workload_from_arrays(arrays),
                                       device="cpu"))
    for i in range(4):
        _assert_contract(states, type(ref)(*(np.asarray(x)[i] for x in ref)),
                         f"{arm} lane {i}", lane=i)


# ---------------------------------------------------------------------------
# (b) every class fires
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def _storm_fleet(arm):
    _, _, wls, params = _storm(2, 11, **SHORT, **ARMS[arm])
    return fleet_run(params, workloads=wls, device="cpu"), params


def _total(states, name):
    return int(getattr(states, name).sum())


@pytest.mark.parametrize("arm", list(ARMS))
def test_retry_storm_classes_fire(arm):
    states, params = _storm_fleet(arm)
    assert bool((states.last_fault_tick < INF_TICK).all())        # an outage on every lane
    assert _total(states, "offered_total") > 0 and _total(states, "admitted_total") > 0
    assert torch.equal(states.offered_prio.sum(-1), states.offered_total)
    assert torch.equal(states.admitted_prio.sum(-1), states.admitted_total)
    shed, retries = _total(states, "shed_total"), _total(states, "client_retry_events")
    deferred = _total(states, "deferred_total")
    offered, unique = _total(states, "offered_total"), _total(states, "offered_unique")
    s = fleet_summary(states, params)
    # every re-presentation of an offer (deferred by the policy, retried
    # by the client) counts again; one the client gate holds back was
    # never offered
    assert (offered == unique) == (arm in ("admit_all", "client_gate"))
    if arm in ("admit_all", "token_bucket", "client_gate"):
        assert shed == retries == 0                   # nothing rejected
    else:
        # rejects retried by the clients (a retry storm) and, past the
        # budget, shed as FAILED
        assert shed > 0 and retries > 0
        assert 0 < s["admitted_fraction_mean"] < 1 and s["shed_mean"] > 0
    assert (deferred > 0) == (arm in ("token_bucket", "client_gate"))


def test_some_lane_drains_and_some_goes_metastable():
    drained = np.concatenate([(_storm_fleet(arm)[0].drain_tick < INF_TICK).numpy()
                              for arm in ARMS])
    assert drained.any() and not drained.all()


# ---------------------------------------------------------------------------
# (c) the register against the oracle
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arm", ["queue_threshold", "token_bucket", "client_gate"])
def test_next_event_registers_match_full_recompute_under_the_closed_loop(arm):
    _, _, wls, params = _storm(1, 5, **SHORT, **ARMS[arm])
    wl = attach_fault_traces(wls, params)
    scheduler_fn = get_scheduler(params.scheduling_algo)
    arr_sorted = engine._sorted_arrivals(wl.arrival)
    edges = executor.bucket_edges(params, "cpu")
    state = init_state(params, 1, "cpu")
    n_events = 0
    while int(state.tick[0]) < params.horizon_ticks:
        tick = state.tick
        active = tick < params.horizon_ticks
        _, due = engine.fault_gate(state, active, params)
        new, _, dec = engine.event_step(params, scheduler_fn, state, wl, arr_sorted, edges,
                                        active, due)
        oracle = engine._next_event(new, wl, tick, engine._acted(dec))
        assert int(new.tick[0]) == min(int(oracle[0]), params.horizon_ticks), n_events
        state, n_events = new, n_events + 1
    assert n_events > 20
    assert int(state.deferred_total[0]) + int(state.client_retry_events[0]) > 0


# ---------------------------------------------------------------------------
# (d) the reference's overload table (chip_smoke.py phase 6c (b))
# ---------------------------------------------------------------------------
REFERENCE = pathlib.Path(__file__).parent / "captures" / "torch_overload_reference.json"


def test_overload_reference_fixture_round_trips():
    """The fixture of ``tests/captures/write_torch_overload_reference.py``:
    its eight fault traces rebuild through the port's
    ``fault_trace_from_records`` and write back to the same records, and
    replayed on the CPU port under ``queue_threshold`` the eight lanes
    give the reference's row."""
    fx = json.loads(REFERENCE.read_text())
    assert set(fx["rows"]) == {"admit_all", "queue_threshold", "token_bucket", "codel"}
    _, _, wls, params = _storm(8, 11, **SMOKE, **ARMS["queue_threshold"])
    traces = [fault_trace_from_records(r, params) for r in fx["fault_traces"]]
    assert [fault_trace_to_records(t) for t in traces] == fx["fault_traces"]
    wls = wls._replace(faults=tree_map(lambda *lane: torch.cat(lane), *traces))
    states = fleet_run(params, workloads=wls, device="cpu")
    drained = int((states.drain_tick < INF_TICK).sum())
    row = {
        "offered": _total(states, "offered_total"),
        "admitted": _total(states, "admitted_total"),
        "shed": _total(states, "shed_total"),
        "deferred": _total(states, "deferred_total"),
        "client_retries": _total(states, "client_retry_events"),
        "goodput_per_s": fleet_summary(states, params)["throughput_per_s_mean"],
        "drained_lanes": drained,
        "metastable_lanes": 8 - drained,
    }
    assert row == fx["rows"]["queue_threshold"]
