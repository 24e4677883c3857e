"""The port's policy search (``repro_torch.search``) against the JAX
package's (``repro.search``), on the CPU.

* (a) the host-side math: ``pareto_front``, ``dominates``,
  ``weakly_dominates``, ``sanitize``, ``scalarize``, ``elite_select``
  and ``halving_lane_counts`` equal the reference's on the same inputs;
  ``PolicySpace``'s normalise / denormalise round trips equal the
  reference's.
* (b) ``evaluate_policies`` on a ``scenario_factory`` batch equals the
  reference's objectives under the comparison contract (rtol 1e-5).
* (c) ``cem_search`` with the reference's draws injected (a
  ``PolicySpace`` whose samplers return, call by call, what the
  reference's ``PolicySpace`` draws under ``fold_in(PRNGKey(seed),
  generation)``) gives the reference's candidate history and Pareto
  front, the objectives under the contract.
* (d) the port's own draws: the same seed gives the same search bit for
  bit (``SearchResult.to_json``), another seed another one; the
  history's invariants hold.

Search arenas stay at 0.02 s: random policy points can preempt at every
tick (ROADMAP queue 3, exclusive mode), which makes each tick an event.
The seeds are the reference test's (``tests/test_search.py``: 5 and 6).
"""
import functools

import jax
import numpy as np
import pytest

from repro.core import SimParams as JParams
from repro.search import PolicySpace as JPolicySpace
from repro.search import cem_search as j_cem_search
from repro.search import driver as j_driver
from repro.search import evaluate_policies as j_evaluate
from repro.search import pareto as j_pareto
from repro.search import scenario_factory as j_factory
from repro_torch import DEFAULT_POINTS, SimParams
from repro_torch.core.policy import PolicyParams
from repro_torch.search import (
    OBJECTIVES,
    PolicySpace,
    cem_search,
    dominates,
    elite_select,
    evaluate_policies,
    halving_lane_counts,
    pareto_front,
    sanitize,
    scalarize,
    scenario_factory,
    weakly_dominates,
)
from repro_torch.search.driver import DOMINANCE_COLUMNS, generation_generator
from test_torch_models import release_jax_executables  # noqa: F401 (autouse)

ARENA = dict(
    duration=0.02, seed=0, scheduling_algo="policy", num_pools=2,
    waiting_ticks_mean=300.0, op_base_seconds_mean=0.004, max_pipelines=16,
    max_containers=32, total_cpus=4, total_ram_gb=8, cache_gb_per_pool=4.0,
    scan_ticks_per_gb=50.0, cold_start_ticks=40, container_warm_ticks=2_000,
    cloud_scaling=True,
)
# two baselines, 4 lanes, rungs of 2 and 4 lanes: every evaluation is a
# fleet of 8 or 12 lanes, two JAX compiles in all
BASELINES = ("priority_pool", "sjf")
SEARCH = dict(seed=5, generations=2, population=6, rungs=(0.5, 1.0))


# ---------------------------------------------------------------------------
# (a) the host-side math
# ---------------------------------------------------------------------------
def _objective_rows(seed, n, cols=4, ties=False):
    rng = np.random.default_rng(seed)
    objs = (rng.integers(0, 4, size=(n, cols)).astype(float) if ties
            else rng.normal(size=(n, cols)))
    objs[rng.random(size=(n, cols)) < 0.1] = np.nan
    return objs


@pytest.mark.parametrize("seed", range(6))
def test_pareto_and_dominance_equal_the_reference(seed):
    for n, ties in ((1, False), (7, True), (13, False), (20, True)):
        objs = _objective_rows(seed, n, cols=3, ties=ties)
        np.testing.assert_array_equal(pareto_front(objs), j_pareto.pareto_front(objs))
        np.testing.assert_array_equal(sanitize(objs), j_pareto.sanitize(objs))
        for i in range(n):
            for j in range(n):
                assert dominates(objs[i], objs[j]) == j_pareto.dominates(objs[i], objs[j])
                assert weakly_dominates(objs[i], objs[j]) == \
                    j_pareto.weakly_dominates(objs[i], objs[j])
    assert pareto_front(np.empty((0, 3))).tolist() == []


@pytest.mark.parametrize("seed", range(6))
def test_scalarize_elite_and_halving_equal_the_reference(seed):
    rng = np.random.default_rng(seed)
    for n in (1, 5, 17):
        objs = _objective_rows(seed, n)
        w = rng.uniform(0.1, 2.0, size=4)
        np.testing.assert_array_equal(scalarize(objs, w), j_driver.scalarize(objs, w))
        np.testing.assert_array_equal(scalarize(objs), j_driver.scalarize(objs))
        scores = rng.integers(0, 5, size=n).astype(float)   # heavy ties
        for k in range(1, n + 1):
            np.testing.assert_array_equal(elite_select(scores, k),
                                          j_driver.elite_select(scores, k))
    for n_lanes in (1, 3, 8, 37, 64):
        rungs = sorted(rng.uniform(0.05, 1.0, size=rng.integers(1, 4)))
        assert halving_lane_counts(n_lanes, rungs) == j_driver.halving_lane_counts(n_lanes, rungs)
    for bad in ((0.0, 1.0), (1.5,)):
        with pytest.raises(ValueError):
            halving_lane_counts(8, bad)
    with pytest.raises(ValueError):
        elite_select(np.zeros(3), 4)
    with pytest.raises(ValueError):
        scalarize(np.zeros((2, 4)), weights=(1.0, 2.0))


def test_policy_space_round_trips_equal_the_reference():
    sp, ref = PolicySpace(), JPolicySpace()
    np.testing.assert_array_equal(sp.lo, ref.lo)
    np.testing.assert_array_equal(sp.hi, ref.hi)
    assert tuple(sp.names) == tuple(ref.names)
    rng = np.random.default_rng(0)
    vecs = np.stack([pt.to_vector() for pt in DEFAULT_POINTS.values()])
    units = rng.random((16, len(sp.names))).astype(np.float32)
    for x in (vecs, sp.denormalize(units)):
        np.testing.assert_array_equal(sp.normalize(x), ref.normalize(x))
        np.testing.assert_array_equal(sp.denormalize(sp.normalize(x)),
                                      ref.denormalize(ref.normalize(x)))
    np.testing.assert_array_equal(sp.denormalize(units), ref.denormalize(units))
    # pinned axes normalise to 0, as the reference's do
    pinned = PolicySpace(lo=sp.lo, hi=np.where(np.arange(len(sp.lo)) < 3, sp.lo, sp.hi))
    np.testing.assert_array_equal(
        pinned.normalize(vecs), JPolicySpace(lo=pinned.lo, hi=pinned.hi).normalize(vecs))
    with pytest.raises(ValueError):
        PolicySpace(lo=sp.hi, hi=sp.lo)
    with pytest.raises(ValueError):
        PolicySpace(lo=sp.lo[:3], hi=sp.hi[:3])


def test_samplers_draw_from_the_generator_alone():
    sp = PolicySpace()
    a = sp.sample_uniform(generation_generator(3, 0), 5)
    assert a.shape == (5, len(sp.names)) and a.dtype == np.float32
    assert ((a >= 0) & (a < 1)).all()
    np.testing.assert_array_equal(a, sp.sample_uniform(generation_generator(3, 0), 5))
    assert not np.array_equal(a, sp.sample_uniform(generation_generator(3, 1), 5))
    mean = np.full(len(sp.names), 0.5, np.float32)
    g = sp.sample_gaussian(generation_generator(3, 1), mean, mean * 0.4, 6)
    assert g.shape == (6, len(sp.names)) and ((g >= 0) & (g <= 1)).all()


# ---------------------------------------------------------------------------
# (b) evaluate_policies
# ---------------------------------------------------------------------------
def test_evaluate_policies_equals_the_reference():
    points = [DEFAULT_POINTS[k] for k in sorted(DEFAULT_POINTS)]
    pols = np.stack([p.to_vector() for p in points])
    got = evaluate_policies(scenario_factory("bursty", SimParams(**ARENA), 2, seed=11,
                                             device="cpu"), pols, device="cpu")
    want = j_evaluate(j_factory("bursty", JParams(**ARENA), 2, seed=11), pols)
    assert (got["C"], got["S"]) == (want["C"], want["S"]) == (len(points), 2)
    assert got["objectives"].shape == (len(points), len(OBJECTIVES))
    np.testing.assert_allclose(got["objectives"], want["objectives"], rtol=1e-5, atol=0)
    for name, col in want["per_candidate"].items():
        np.testing.assert_allclose(got["per_candidate"][name], col, rtol=1e-5, atol=0,
                                   err_msg=name)
    # a lane prefix, and the guards
    got = evaluate_policies(scenario_factory("bursty", SimParams(**ARENA), 2, seed=11,
                                             device="cpu"), pols[:1], lane_limit=1,
                            device="cpu")
    assert (got["C"], got["S"]) == (1, 1)
    with pytest.raises(ValueError, match="positive"):
        evaluate_policies(scenario_factory("bursty", SimParams(**ARENA), 2, device="cpu"),
                          pols, lane_limit=0, device="cpu")


# ---------------------------------------------------------------------------
# (c) cem_search on the reference's draws
# ---------------------------------------------------------------------------
class ReferenceDraws(PolicySpace):
    """A ``PolicySpace`` whose samplers return the reference's draws for
    generation ``g`` (the ``g``-th call): ``repro.search.PolicySpace``'s
    under ``fold_in(PRNGKey(seed), g)``, with the mean and std the port's
    driver passes."""

    def __init__(self, seed):
        super().__init__()
        self.key = jax.random.PRNGKey(seed)
        self.ref = JPolicySpace()
        self.calls = 0

    def _key(self):
        key = jax.random.fold_in(self.key, self.calls)
        self.calls += 1
        return key

    def sample_uniform(self, generator, n):
        return self.ref.sample_uniform(self._key(), n)

    def sample_gaussian(self, generator, mean, std, n):
        return self.ref.sample_gaussian(self._key(), mean, std, n)


def _baselines(pkg_points):
    return {k: pkg_points[k] for k in BASELINES}


@functools.lru_cache(maxsize=None)
def _searches():
    from repro.core.policy import DEFAULT_POINTS as J_POINTS

    ref = j_cem_search(j_factory(["bursty"], JParams(**ARENA), 4, seed=7),
                       baselines=_baselines(J_POINTS), **SEARCH)
    port = cem_search(scenario_factory(["bursty"], SimParams(**ARENA), 4, seed=7, device="cpu"),
                      baselines=_baselines(DEFAULT_POINTS), space=ReferenceDraws(SEARCH["seed"]),
                      device="cpu", **SEARCH)
    return port, ref


def _close(a, b, ctx):
    np.testing.assert_allclose(np.asarray(a, np.float64), np.asarray(b, np.float64),
                               rtol=1e-5, atol=0, err_msg=ctx)


def test_cem_search_on_the_reference_draws_equals_the_reference():
    port, ref = _searches()
    assert len(port.history) == len(ref.history) == SEARCH["generations"]
    for g, (h, r) in enumerate(zip(port.history, ref.history)):
        for key in ("policies", "origin", "survivors", "elites", "mean", "std"):
            assert h[key] == r[key], (g, key)
        _close(h["best_score"], r["best_score"], f"generation {g}: best score")
        assert [(x["lanes"], x["candidates"]) for x in h["rungs"]] == \
            [(x["lanes"], x["candidates"]) for x in r["rungs"]], g
        for x, y in zip(h["rungs"], r["rungs"]):
            _close(x["scores"], y["scores"], f"generation {g}: scores")
            _close(x["objectives"], y["objectives"], f"generation {g}: objectives")
    np.testing.assert_array_equal(port.pareto_policies, ref.pareto_policies)
    _close(port.pareto_objectives, ref.pareto_objectives, "front objectives")
    _close(port.baseline_objectives, ref.baseline_objectives, "baseline objectives")
    assert port.baseline_names == ref.baseline_names
    assert port.evaluations == ref.evaluations
    assert port.meta == ref.meta
    assert (port.champion is None) == (ref.champion is None)
    if ref.champion is not None:
        assert port.champion["origin"] == ref.champion["origin"]
        assert port.champion["policy"] == ref.champion["policy"]
        _close(port.champion["objectives"], ref.champion["objectives"], "champion")


# ---------------------------------------------------------------------------
# (d) the port's own draws: determinism and invariants
# ---------------------------------------------------------------------------
def _own_search(seed):
    return cem_search(scenario_factory(["bursty"], SimParams(**ARENA), 4, seed=7, device="cpu"),
                      baselines=_baselines(DEFAULT_POINTS), device="cpu",
                      **{**SEARCH, "seed": seed})


@functools.lru_cache(maxsize=None)
def _own(seed):
    return _own_search(seed)


def test_same_seed_same_search_bit_for_bit():
    assert _own(5).to_json() == _own_search(5).to_json()


def test_another_seed_another_search():
    assert _own(5).to_json() != _own(6).to_json()


def test_search_history_invariants():
    res = _own(5)
    B = len(res.baseline_names)
    assert res.baseline_names == sorted(BASELINES)
    for g in res.history:
        assert len(g["policies"]) == SEARCH["population"]
        assert set(g["elites"]) <= set(g["survivors"]) <= set(range(SEARCH["population"]))
        assert [r["lanes"] for r in g["rungs"]] == res.meta["lane_counts"] == [2, 4]
        assert g["origin"][:B] == [f"baseline:{n}" for n in res.baseline_names]
    bests = [g["best_score"] for g in res.history]
    assert all(b <= a for a, b in zip(bests, bests[1:]))   # elitist carryover
    objs = res.pareto_objectives
    assert objs.shape[0] >= 1
    assert not any(dominates(objs[j], objs[i])
                   for i in range(len(objs)) for j in range(len(objs)) if i != j)
    for brow in res.baseline_objectives:
        assert any(weakly_dominates(f, brow) for f in objs)
    if res.champion is not None:
        tri = np.asarray(res.champion["objectives"])[list(DOMINANCE_COLUMNS)]
        for brow in res.baseline_objectives[:, list(DOMINANCE_COLUMNS)]:
            assert weakly_dominates(tri, brow)


def test_search_refuses_what_the_reference_refuses():
    make = scenario_factory(["bursty"], SimParams(**ARENA), 2, device="cpu")
    with pytest.raises(ValueError, match="too small"):
        cem_search(make, population=3, device="cpu")
    wls, _ = make()
    assert wls.policy is None

    def with_policy():
        w, p = make()
        return w._replace(policy=w.arrival.new_zeros(0)), p

    with pytest.raises(ValueError, match="policy-free"):
        evaluate_policies(with_policy, [PolicyParams().to_vector()], device="cpu")
