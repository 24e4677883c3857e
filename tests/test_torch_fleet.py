"""The port's fleet tools against the JAX package's, on the CPU.

Lane padding, the binning key and permutation, the fleet statistics
(``fleet_summary``, ``fleet_lane_stats``, ``completion_table``),
``broadcast_lanes``, ``shard=`` resolution, and a fleet at the
engine-throughput configuration (64 lanes,
``benchmarks/engine_throughput.py:_fleet_params``) held to the
reference under the comparison contract. Inputs are reference-built
(``repro_torch.bridge`` carries them across).
"""
import numpy as np
import pytest
import torch

from repro.core import SimParams as JParams
from repro.core.metrics import completion_table as j_completion_table
from repro.core.metrics import fleet_lane_stats as j_fleet_lane_stats
from repro.core.state import broadcast_lanes as j_broadcast_lanes
from repro.core.state import init_state as j_init_state
from repro.core.sweep import _unbin_states as j_unbin_states
from repro.core.sweep import bin_lanes_by_density as j_bin_lanes
from repro.core.sweep import fleet_run as j_fleet_run
from repro.core.sweep import fleet_summary as j_fleet_summary
from repro.core.sweep import make_workload_batch as j_batch
from repro.core.sweep import pad_lanes as j_pad_lanes
from repro.core.sweep import predicted_lane_events as j_predicted
from repro_torch import (
    SimParams,
    broadcast_lanes,
    completion_table,
    fleet_lane_stats,
    fleet_run,
    fleet_summary,
    pad_lanes,
)
from repro_torch.bridge import state_from_arrays, state_to_arrays, workload_from_arrays
from repro_torch.core import sweep
from repro_torch.core.state import SimState, workload_lane
from test_torch_models import release_jax_executables  # noqa: F401 (autouse)

TOLERANT = {
    "sum_latency_s", "sum_latency_s_prio", "util_cpu_s", "util_ram_s",
    "cost_dollars", "util_log", "pool_down_s",
}
CHAOS = dict(crash_mtbf_ticks=800.0, outage_mtbf_ticks=2_000.0, outage_duration_ticks=300.0,
             straggler_prob=0.2)


def _kw(**extra):
    base = dict(duration=0.05, op_base_seconds_mean=0.005, op_base_seconds_sigma=1.0,
                max_pipelines=32, max_containers=32, waiting_ticks_mean=250.0)
    return {**base, **extra}


def _arrays(wls):
    """A reference batch as the numpy arrays the bridge takes (its fault
    trace, where it has one, by field)."""
    out = {f: np.asarray(getattr(wls, f)) for f in wls._fields[:10]}
    if wls.faults is not None:
        out["faults"] = {f: np.asarray(getattr(wls.faults, f)) for f in wls.faults._fields}
    return out


def _assert_same_workload(port, ref):
    fields = list(zip(port[:10], ref[:10]))
    if ref.faults is not None:
        fields += list(zip(port.faults, ref.faults))
    for got, want in fields:
        got, want = got.numpy(), np.asarray(want)
        assert got.dtype == want.dtype and got.shape == want.shape
        assert got.tobytes() == want.tobytes()


@pytest.mark.parametrize("chaos", [False, True], ids=["faults-off", "faults-on"])
def test_pad_lanes_matches_the_reference(chaos):
    kw = _kw(**(CHAOS if chaos else {}))
    ref = j_batch(JParams(**kw), [0, 1, 2])
    port = workload_from_arrays(_arrays(ref))
    _assert_same_workload(pad_lanes(port, 5), j_pad_lanes(ref, 5))
    assert pad_lanes(port, 3) is port


def test_binning_matches_the_reference_and_unbins():
    jp = JParams(**_kw(waiting_ticks_mean=400.0))
    ref = j_batch(jp, list(range(6)))
    port = workload_from_arrays(_arrays(ref))
    params = SimParams(**_kw(waiting_ticks_mean=400.0))
    np.testing.assert_array_equal(sweep.predicted_lane_events(port, params), j_predicted(ref, jp))
    assert sweep.predicted_lane_events(port, params).dtype == j_predicted(ref, jp).dtype
    binned, inv = sweep.bin_lanes_by_density(port, params)
    ref_binned, ref_inv = j_bin_lanes(ref, jp)
    np.testing.assert_array_equal(inv, ref_inv)
    _assert_same_workload(binned, ref_binned)
    # a fleet run on the binned lanes, unbinned, is the fleet run as given
    states = fleet_run(params, workloads=binned, device="cpu")
    unbinned = state_to_arrays(sweep._unbin_states(states, inv))
    whole = state_to_arrays(fleet_run(params, workloads=port, device="cpu"))
    for name, got in unbinned.items():
        np.testing.assert_array_equal(got, whole[name], err_msg=name)
    # and the same permutation as the reference's, on the same states
    ref_state = type(j_init_state(jp))
    binned_arrays = state_to_arrays(states)
    ref_unbinned = j_unbin_states(ref_state(**{f: binned_arrays[f] for f in ref_state._fields}),
                                  np.asarray(ref_inv))
    for name in SimState._fields:
        np.testing.assert_array_equal(unbinned[name], np.asarray(getattr(ref_unbinned, name)))


def _ref_fleet(chaos, seeds=(0, 1, 2, 3)):
    kw = _kw(scheduling_algo="priority_pool", num_pools=2, **(CHAOS if chaos else {}))
    jp = JParams(**kw)
    arrival = np.asarray(j_batch(jp, list(seeds)).arrival)
    states = j_fleet_run(jp, workloads=j_batch(jp, list(seeds)))
    return jp, SimParams(**kw), states, arrival


def _assert_same_stats(mine, theirs):
    assert mine.keys() == theirs.keys()
    for key, want in theirs.items():
        got = mine[key]
        if isinstance(want, np.ndarray):
            assert got.dtype == want.dtype, key
        np.testing.assert_array_equal(got, want, err_msg=key)


@pytest.mark.parametrize("chaos", [False, True], ids=["faults-off", "faults-on"])
def test_fleet_statistics_on_the_same_states_equal_the_reference(chaos):
    jp, params, ref_states, arrival = _ref_fleet(chaos)
    port_states = state_from_arrays({f: np.asarray(getattr(ref_states, f))
                                     for f in ref_states._fields})
    _assert_same_stats(fleet_summary(port_states, params), j_fleet_summary(ref_states, jp))
    _assert_same_stats(fleet_lane_stats(port_states, params, torch.tensor(arrival)),
                       j_fleet_lane_stats(ref_states, jp, arrival))
    _assert_same_stats(fleet_lane_stats(port_states, params),
                       j_fleet_lane_stats(ref_states, jp))
    wl = j_batch(jp, [0])
    lane_wl = workload_lane(workload_from_arrays(_arrays(wl)), 0)
    lane_state = SimState(*(x[0] for x in port_states))
    ref_lane = type(ref_states)(*(np.asarray(x)[0] for x in ref_states))
    ref_wl = wl._replace(arrival=np.asarray(wl.arrival)[0], prio=np.asarray(wl.prio)[0])
    np.testing.assert_array_equal(completion_table(lane_state, lane_wl),
                                  j_completion_table(ref_lane, ref_wl))
    if chaos:
        assert fleet_summary(port_states, params)["crash_events_mean"] > 0


def test_fleet_summary_of_the_ports_own_run_follows_the_contract():
    jp, params, ref_states, _ = _ref_fleet(False)
    wls = workload_from_arrays(_arrays(j_batch(jp, [0, 1, 2, 3])))
    mine = fleet_summary(fleet_run(params, workloads=wls, device="cpu"), params)
    theirs = j_fleet_summary(ref_states, jp)
    assert mine.keys() == theirs.keys()
    for key, want in theirs.items():
        # sums taken in another order (latency, utilisation, cost) to rtol 1e-5
        np.testing.assert_allclose(mine[key], want, rtol=1e-5, err_msg=key)
    # with the fleet's traces, the reference's overflow key joins the rest
    states, traces = fleet_run(params, workloads=wls, device="cpu", trace=True)
    traced = fleet_summary(states, params, traces=traces)
    assert traced.pop("events_dropped_total") == 0
    assert traced.keys() == mine.keys()
    for key, value in mine.items():
        np.testing.assert_array_equal(traced[key], value, err_msg=key)


def test_broadcast_lanes_matches_the_reference():
    jp = JParams(**_kw(num_pools=2))
    ref = j_broadcast_lanes(j_init_state(jp), 3)
    one = {f: np.asarray(getattr(j_init_state(jp), f))[None] for f in SimState._fields}
    port = broadcast_lanes(SimState(*(x[0] for x in state_from_arrays(one))), 3)
    for name in SimState._fields:
        got, want = getattr(port, name).numpy(), np.asarray(getattr(ref, name))
        assert got.dtype == want.dtype and got.shape == want.shape, name
        np.testing.assert_array_equal(got, want, err_msg=name)
    tree = broadcast_lanes({"a": (torch.zeros(2), None), "b": [1.5]}, 4)
    assert tree["a"][1] is None and tuple(tree["a"][0].shape) == (4, 2)
    assert tree["b"][0].tolist() == [1.5] * 4


def test_shard_resolves_as_the_reference_on_one_device():
    params = SimParams(**_kw())
    whole = state_to_arrays(fleet_run(params, seeds=[0, 1, 2], device="cpu"))
    for shard in ("auto", 1):
        got = state_to_arrays(fleet_run(params, seeds=[0, 1, 2], device="cpu", shard=shard))
        for name, a in got.items():
            np.testing.assert_array_equal(a, whole[name], err_msg=f"shard={shard}: {name}")
    with pytest.raises(ValueError, match="only 1 are local"):
        fleet_run(params, seeds=[0, 1, 2], device="cpu", shard=2)


def test_shards_count_the_cards(monkeypatch):
    """``_resolve_shards`` against the CUDA device count (a CPU run is one
    device); a fleet spread over four cards hands ``cuda:0`` .. ``cuda:3``
    to ``_fleet_sharded`` (run here as CPU blocks) and equals the whole
    fleet."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    cuda = torch.device("cuda")
    assert sweep._resolve_shards("auto", 64, cuda) == 4
    assert sweep._resolve_shards(2, 64, cuda) == 2
    assert sweep._resolve_shards("auto", 3, cuda) == 3
    assert sweep._resolve_shards(None, 64, cuda) == 1
    assert sweep._resolve_shards("auto", 64, torch.device("cpu")) == 1
    with pytest.raises(ValueError, match="only 4 are local"):
        sweep._resolve_shards(8, 64, cuda)
    params = SimParams(**_kw())
    whole = state_to_arrays(fleet_run(params, seeds=[0, 1, 2, 3, 4], device="cpu"))
    monkeypatch.setattr(sweep, "resolve_device", lambda device: cuda)
    asked = []
    real = sweep._fleet_sharded

    def on_cpu(params, wls, key, devices, capacity=0):
        asked.extend(devices)
        return real(params, wls, key, [torch.device("cpu")] * len(devices), capacity)

    monkeypatch.setattr(sweep, "_fleet_sharded", on_cpu)
    got = state_to_arrays(fleet_run(params, seeds=[0, 1, 2, 3, 4], shard="auto"))
    assert asked == [torch.device("cuda", i) for i in range(4)]
    for name, want in whole.items():
        np.testing.assert_array_equal(got[name], want, err_msg=name)


def test_engine_throughput_fleet_matches_the_reference():
    """64 lanes at ``benchmarks/engine_throughput.py:_fleet_params`` (1 s,
    MP 128, MC 64, ``priority``), the shape of chip_smoke.py's phase 5."""
    kw = dict(duration=1.0, waiting_ticks_mean=5_000, op_base_seconds_mean=0.03,
              op_base_seconds_sigma=1.2, op_ram_gb_mean=2.0, max_pipelines=128,
              max_containers=64, scheduling_algo="priority")
    jp = JParams(**kw)
    seeds = list(range(64))
    arrays = _arrays(j_batch(jp, seeds))
    states = state_to_arrays(fleet_run(SimParams(**kw), workloads=workload_from_arrays(arrays),
                                       device="cpu"))
    ref = j_fleet_run(jp, workloads=j_batch(jp, seeds))
    for name in ref._fields:
        got, want = states[name], np.asarray(getattr(ref, name))
        assert got.dtype == want.dtype and got.shape == want.shape, name
        if name in TOLERANT:
            np.testing.assert_allclose(got, want, rtol=1e-5, err_msg=name)
        else:
            np.testing.assert_array_equal(got, want, err_msg=name)
    assert (states["done_count"] > 0).all()
