"""The port's scenario library against the JAX package's, on the CPU.

The families draw from ``numpy.random.default_rng(seed)``, so the same
``(params, seed, knobs)`` gives the same records in both packages, to
the bit; ``scenario_fleet`` ingests them into the same batch (the port's
on the CPU) with the same derived capacities; the knob halves
(``retry_storm_params``, ``spot_churn_params``) set the same params; the
lookups fail with the same errors. The port's doctests run here too.
"""
import dataclasses
import doctest

import numpy as np
import pytest

from repro.core import SimParams as JParams
from repro.core import scenarios as j_scenarios
from repro_torch import SimParams
from repro_torch.core import admission, scenarios
from repro_torch.core.scenarios import families
from test_torch_models import release_jax_executables  # noqa: F401 (autouse)

BASE = dict(duration=0.2, waiting_ticks_mean=400.0, max_pipelines=64)
# each family at its defaults and with its knobs moved
KNOBS = {
    "diurnal": [{}, dict(amplitude=0.3, period_s=0.05, phase=0.4)],
    "bursty": [{}, dict(burst_factor=3.0, duty_cycle=0.5, mean_cycle_s=0.02)],
    "heavy_tail": [{}, dict(tail_index=2.5, body_scale=0.8, out_runtime_exp=1.0)],
    "priority_skew": [{}, dict(interactive_frac=0.2, query_frac=0.7, batch_ops_factor=4.0)],
    "spot_churn": [{}, dict(batch_frac=0.3, runtime_factor=1.5)],
    "retry_storm": [{}, dict(surge_factor=6.0, surge_start_frac=0.5, surge_duration_frac=0.2,
                             interactive_frac=0.9)],
}


def _params(**kw):
    return SimParams(**{**BASE, **kw}), JParams(**{**BASE, **kw})


def test_the_same_families():
    assert scenarios.list_scenarios() == j_scenarios.list_scenarios()
    assert sorted(scenarios.SCENARIOS) == sorted(j_scenarios.SCENARIOS)
    assert families.__all__ == j_scenarios.families.__all__


@pytest.mark.parametrize("knob_set", [0, 1], ids=["defaults", "knobs"])
@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("name", sorted(KNOBS))
def test_family_records_equal_the_reference(name, seed, knob_set):
    knobs = KNOBS[name][knob_set]
    p, jp = _params()
    got = scenarios.get_scenario(name)(p, seed=seed, **knobs)
    want = j_scenarios.get_scenario(name)(jp, seed=seed, **knobs)
    assert len(got) > 0
    assert got == want          # floats compared exactly, key order aside
    assert [list(r) for r in got] == [list(r) for r in want]


@pytest.mark.parametrize("name", ["diurnal", "retry_storm"])
def test_uncapped_families_equal_the_reference(name):
    """``max_pipelines=0`` draws the whole horizon (no truncation)."""
    p, jp = _params(max_pipelines=0, duration=0.05)
    assert scenarios.get_scenario(name)(p, seed=3) == j_scenarios.get_scenario(name)(jp, seed=3)


def test_lane_batch_equals_the_reference():
    p, jp = _params()
    got = scenarios.scenario_lane_batch("bursty", p, 3, seed=4, burst_factor=5.0)
    want = j_scenarios.scenario_lane_batch("bursty", jp, 3, seed=4, burst_factor=5.0)
    assert got == want and got[0] != got[1]
    fn = scenarios.get_scenario("heavy_tail")
    assert scenarios.scenario_lane_batch(fn, p, 2) == j_scenarios.scenario_lane_batch(
        j_scenarios.get_scenario("heavy_tail"), jp, 2)


def _same_params(got: SimParams, want: JParams):
    for f in dataclasses.fields(want):
        assert getattr(got, f.name) == getattr(want, f.name), f.name


@pytest.mark.parametrize("name", [
    "retry_storm", ["diurnal", "bursty", "spot_churn"], ("heavy_tail", "priority_skew"),
], ids=["one-family", "mixed-list", "mixed-tuple"])
@pytest.mark.parametrize("capacity", ["derived", "fixed"])
def test_scenario_fleet_batch_equals_the_reference(name, capacity):
    kw = dict(max_pipelines=0, max_ops_per_pipeline=0) if capacity == "derived" else dict(
        max_pipelines=64, max_ops_per_pipeline=8)
    p, jp = _params(**kw)
    wls, p2 = scenarios.scenario_fleet(name, p, 5, seed=2)
    jwls, jp2 = j_scenarios.scenario_fleet(name, jp, 5, seed=2)
    _same_params(p2, jp2)
    assert p2.max_pipelines > 0
    for field in jwls._fields[:10]:
        got, want = getattr(wls, field), np.asarray(getattr(jwls, field))
        assert got.device.type == "cpu"
        assert got.numpy().dtype == want.dtype and got.shape == want.shape, field
        np.testing.assert_array_equal(got.numpy(), want, err_msg=field)
    assert wls.faults is None and jwls.faults is None


@pytest.mark.parametrize("kw", [{}, dict(outage_mtbf_s=0.02, outage_duration_s=0.006,
                                         client_max_retries=3, client_max_inflight=4,
                                         admission_policy="queue_threshold",
                                         admit_queue_limit=3, metastable_window_s=0.01)])
def test_retry_storm_params_equal_the_reference(kw):
    p, jp = _params()
    _same_params(scenarios.retry_storm_params(p, **kw), j_scenarios.retry_storm_params(jp, **kw))
    armed = scenarios.retry_storm_params(p, **kw)
    assert armed.closed_loop_active and armed.fault_events_active


@pytest.mark.parametrize("kw", [{}, dict(crash_mtbf_s=0.01, outage_mtbf_s=0.05,
                                         outage_duration_s=0.002, max_retries=0,
                                         base_backoff_s=0.0)])
def test_spot_churn_params_equal_the_reference(kw):
    p, jp = _params()
    _same_params(scenarios.spot_churn_params(p, **kw), j_scenarios.spot_churn_params(jp, **kw))


def test_lookup_errors_equal_the_reference():
    p, jp = _params()
    with pytest.raises(KeyError) as mine:
        scenarios.get_scenario("no_such_family")
    with pytest.raises(KeyError) as theirs:
        j_scenarios.get_scenario("no_such_family")
    assert str(mine.value) == str(theirs.value) and "retry_storm" in str(mine.value)
    assert scenarios.get_scenario("Retry-Storm") is families.retry_storm
    with pytest.raises(ValueError) as mine:
        scenarios.scenario_fleet([], p, 2)
    with pytest.raises(ValueError) as theirs:
        j_scenarios.scenario_fleet([], jp, 2)
    assert str(mine.value) == str(theirs.value)
    with pytest.raises(ValueError, match="must be < 1"):
        families.priority_skew(p, interactive_frac=0.6, query_frac=0.4)


@pytest.mark.parametrize("module", [scenarios, families, admission],
                         ids=lambda m: m.__name__)
def test_port_doctests(module):
    result = doctest.testmod(module, verbose=False)
    assert result.attempted > 0 and result.failed == 0, result
