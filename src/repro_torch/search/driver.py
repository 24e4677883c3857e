"""Gradient-free policy search: CEM with successive-halving rungs.

The driver is deliberately boring where it matters for reproducibility:

* all randomness flows from the seed: generation ``g`` draws from a
  ``torch.Generator`` seeded from ``(seed, g)`` alone through a
  ``numpy.random.SeedSequence`` — no ``time()``/global-RNG state;
* elite selection is pure numpy: ``np.lexsort`` over (score, index) —
  the index tie-break makes equal scores deterministic;
* every evaluation rebuilds its scenario batch from fixed seeds, so
  rung L of generation g sees bitwise the same lanes on every run.

Same seed ⇒ identical candidate history and Pareto front
(tests/test_torch_search.py runs the whole driver twice and compares
the JSON artifacts byte-for-byte).

The pure helpers (:func:`scalarize`, :func:`elite_select`,
:func:`halving_lane_counts`) are module-level precisely so the
property-test wall can check the CEM/halving invariants against
independent numpy oracles.
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Any, Callable, Sequence

import numpy as np
import torch

from ..core.policy import PolicyParams
from ..core.state import Workload

from .grid import OBJECTIVES, evaluate_policies
from .pareto import pareto_front, sanitize, weakly_dominates
from .space import PolicySpace

# scalarisation weights over OBJECTIVES (all minimised, utilisation
# included — see grid.OBJECTIVES for why): mean latency leads, p99 is
# a tail regulariser, utilisation and cost are the footprint terms.
# Latency is O(1e-2) s while utilisation is O(1e-1), so the footprint
# weights stay small to keep the latency term in charge of ranking.
DEFAULT_WEIGHTS = (1.0, 0.1, 0.01, 100.0)

# the acceptance-triple column indices: (mean latency, utilisation,
# cost_dollars) — what "weakly dominates every named baseline" means
DOMINANCE_COLUMNS = (0, 2, 3)


def scalarize(objectives, weights=DEFAULT_WEIGHTS) -> np.ndarray:
    """Weighted-sum scores (lower is better); any NaN/inf objective
    pushes the candidate's score to +inf (it can still appear in the
    history, it just never wins)."""
    objs = sanitize(objectives)
    w = np.asarray(weights, np.float64)
    if w.shape != (objs.shape[1],):
        raise ValueError(
            f"weights must match the {objs.shape[1]} objective columns"
        )
    scores = objs @ w
    return np.where(np.isfinite(scores), scores, np.inf)


def elite_select(scores, n_elite: int) -> np.ndarray:
    """Indices of the ``n_elite`` lowest scores, ties broken by index
    (``np.lexsort`` keys: score primary, position secondary)."""
    scores = np.asarray(scores, np.float64)
    if not 0 < n_elite <= scores.shape[0]:
        raise ValueError(
            f"n_elite must be in [1, {scores.shape[0]}], got {n_elite}"
        )
    order = np.lexsort((np.arange(scores.shape[0]), scores))
    return order[:n_elite]


def halving_lane_counts(n_lanes: int, rungs: Sequence[float]) -> list[int]:
    """Strictly-increasing rung lane counts from fractions; the last
    rung always evaluates the full batch.

    >>> halving_lane_counts(8, (0.25, 0.5, 1.0))
    [2, 4, 8]
    >>> halving_lane_counts(3, (0.5, 1.0))
    [2, 3]
    """
    counts: list[int] = []
    for f in rungs:
        if not 0.0 < f <= 1.0:
            raise ValueError(f"rung fractions must be in (0, 1], got {f}")
        c = max(1, int(round(f * n_lanes)))
        if not counts or c > counts[-1]:
            counts.append(c)
    if counts[-1] != n_lanes:
        counts.append(n_lanes)
    return counts


@dataclass
class SearchResult:
    """The recorded candidate-history artifact of one search run."""

    seed: int
    objectives: tuple[str, ...]
    history: list[dict]
    baseline_names: list[str]
    baseline_objectives: np.ndarray  # [B, 4]
    pareto_policies: np.ndarray      # [K, P] f32
    pareto_objectives: np.ndarray    # [K, 4]
    champion: dict | None = None
    evaluations: int = 0
    meta: dict = field(default_factory=dict)

    def to_json(self) -> str:
        """Canonical JSON (sorted keys) — byte-identical across runs of
        the same seed; the determinism tests diff this string."""
        payload = {
            "seed": self.seed,
            "objectives": list(self.objectives),
            "history": self.history,
            "baselines": {
                name: [float(v) for v in row]
                for name, row in zip(
                    self.baseline_names, self.baseline_objectives
                )
            },
            "pareto_policies": self.pareto_policies.tolist(),
            "pareto_objectives": self.pareto_objectives.tolist(),
            "champion": self.champion,
            "evaluations": self.evaluations,
            "meta": self.meta,
        }
        return json.dumps(payload, sort_keys=True)


def generation_generator(seed: int, generation: int) -> torch.Generator:
    """The CPU generator of one generation's draws, seeded from
    ``(seed, generation)`` alone (the reference folds ``generation`` into
    ``PRNGKey(seed)``)."""
    state = np.random.SeedSequence((seed, generation)).generate_state(1, np.uint64)[0]
    return torch.Generator().manual_seed(int(state))


def _as_float_rows(a) -> list[list[float]]:
    return [[float(v) for v in row] for row in np.asarray(a)]


def cem_search(
    make_scenarios: Callable[[], tuple[Workload, "object"]],
    *,
    seed: int = 0,
    generations: int = 4,
    population: int = 16,
    elite_frac: float = 0.25,
    rungs: Sequence[float] = (0.5, 1.0),
    weights: Sequence[float] = DEFAULT_WEIGHTS,
    baselines: dict[str, PolicyParams] | None = None,
    space: PolicySpace | None = None,
    init_std: float = 0.25,
    std_floor: float = 0.02,
    shard: str | int | None = None,
    device: Any = "cuda",
) -> SearchResult:
    """Cross-entropy search over the policy space (see module docs).

    Each generation's candidate block is ``baselines + previous elites
    + Gaussian samples`` (uniform at generation 0), evaluated through
    successive-halving rungs: everyone runs the cheapest lane prefix,
    the top half advances, until the survivors run the full scenario
    batch. Elites refit the Gaussian; the elitist carryover means the
    per-generation best full-fidelity score is monotone non-increasing
    (a tested invariant). ``baselines`` defaults to every registered
    named-scheduler point (``scheduler.policy_points()``), evaluated
    once at full fidelity as the comparison row the Pareto front is
    judged against. Every evaluation runs on ``device`` (CUDA unless
    the caller asks for the CPU).
    """
    from ..core.scheduler import policy_points

    if baselines is None:
        baselines = policy_points()
    base_names = sorted(baselines)
    space = space or PolicySpace()
    B = len(base_names)
    n_elite = max(1, int(round(elite_frac * population)))
    if population < B + n_elite + 1:
        raise ValueError(
            f"population={population} too small for {B} baselines + "
            f"{n_elite} elites + 1 sample"
        )

    wls_probe, _ = make_scenarios()
    S = int(wls_probe.arrival.shape[0])
    del wls_probe
    lane_counts = halving_lane_counts(S, rungs)

    base_vecs = space.normalize(
        np.stack([baselines[n].to_vector() for n in base_names])
    ) if B else np.zeros((0, len(space.names)), np.float32)

    mean = np.full((len(space.names),), 0.5, np.float32)
    std = np.full((len(space.names),), np.float32(init_std), np.float32)

    history: list[dict] = []
    pool_pol: list[np.ndarray] = []   # full-fidelity evaluations
    pool_obj: list[np.ndarray] = []
    pool_tag: list[str] = []
    evaluations = 0
    elites_u = np.zeros((0, len(space.names)), np.float32)
    best_score = np.inf

    # baselines once, at full fidelity — the judgement row
    if B:
        res = evaluate_policies(
            make_scenarios, space.denormalize(base_vecs), shard=shard,
            device=device,
        )
        evaluations += res["C"] * res["S"]
        baseline_objs = res["objectives"]
        for name, u, obj in zip(base_names, base_vecs, baseline_objs):
            pool_pol.append(space.denormalize(u))
            pool_obj.append(obj)
            pool_tag.append(f"baseline:{name}")
    else:
        baseline_objs = np.zeros((0, len(OBJECTIVES)))

    for gen in range(generations):
        kgen = generation_generator(seed, gen)
        E = elites_u.shape[0]
        n_sample = population - B - E
        if gen == 0:
            samples = space.sample_uniform(kgen, n_sample)
        else:
            samples = space.sample_gaussian(kgen, mean, std, n_sample)
        unit = np.concatenate([base_vecs, elites_u, samples], axis=0)
        origin = (
            [f"baseline:{n}" for n in base_names]
            + ["elite"] * E
            + ["sample"] * n_sample
        )
        pols = space.denormalize(unit)

        alive = np.arange(population)
        rung_log: list[dict] = []
        scores = None
        objs = None
        for L in lane_counts:
            res = evaluate_policies(
                make_scenarios,
                pols[alive],
                lane_limit=None if L == S else L,
                shard=shard,
                device=device,
            )
            evaluations += res["C"] * res["S"]
            objs = res["objectives"]
            scores = scalarize(objs, weights)
            rung_log.append(
                {
                    "lanes": L,
                    "candidates": [int(i) for i in alive],
                    "scores": [float(s) for s in scores],
                    "objectives": _as_float_rows(objs),
                }
            )
            if L != lane_counts[-1]:
                keep_n = max(n_elite, -(-len(alive) // 2))
                # carried-over elites are exempt from low-fidelity cuts:
                # they always reach the full batch, which is what makes
                # the per-generation best score monotone (their full-
                # fidelity scores are deterministic re-evaluations)
                prot = np.flatnonzero((alive >= B) & (alive < B + E))
                rest = np.flatnonzero((alive < B) | (alive >= B + E))
                n_rest = keep_n - prot.size
                chosen = (
                    rest[elite_select(scores[rest], n_rest)]
                    if n_rest > 0 and rest.size
                    else np.zeros((0,), np.int64)
                )
                alive = alive[np.sort(np.concatenate([prot, chosen]))]

        # full-fidelity survivors feed the front and the elite refit
        for i, idx in enumerate(alive):
            pool_pol.append(pols[idx])
            pool_obj.append(objs[i])
            pool_tag.append(f"gen{gen}:{origin[idx]}")
        elite_local = elite_select(scores, min(n_elite, len(alive)))
        elite_idx = alive[elite_local]
        elites_u = unit[elite_idx]
        gen_best = float(np.min(scores))
        best_score = min(best_score, gen_best)
        mean = elites_u.mean(axis=0).astype(np.float32)
        std = np.maximum(
            elites_u.std(axis=0), np.float32(std_floor)
        ).astype(np.float32)

        history.append(
            {
                "generation": gen,
                "policies": _as_float_rows(pols),
                "origin": origin,
                "rungs": rung_log,
                "survivors": [int(i) for i in alive],
                "elites": [int(i) for i in elite_idx],
                "best_score": gen_best,
                "mean": [float(v) for v in mean],
                "std": [float(v) for v in std],
            }
        )

    pool_obj_arr = np.stack(pool_obj) if pool_obj else np.zeros((0, 4))
    pool_pol_arr = (
        np.stack(pool_pol)
        if pool_pol
        else np.zeros((0, len(space.names)), np.float32)
    )
    front = pareto_front(pool_obj_arr)
    champion = None
    tri = pool_obj_arr[:, list(DOMINANCE_COLUMNS)]
    base_tri = baseline_objs[:, list(DOMINANCE_COLUMNS)] if B else None
    eligible = [
        i for i in front
        if base_tri is not None
        and all(weakly_dominates(tri[i], b) for b in base_tri)
    ]
    if eligible:
        # of the eligible front members, crown the best-scoring one —
        # pool order lists baselines first, so "first eligible" would
        # shadow a searched strict improvement with the baseline point
        # it improves on (elite_select tie-breaks equal scores by pool
        # position, keeping the pick deterministic)
        pool_scores = scalarize(pool_obj_arr, weights)
        i = int(
            np.asarray(eligible)[elite_select(pool_scores[eligible], 1)][0]
        )
        champion = {
            "policy": [float(v) for v in pool_pol_arr[i]],
            "objectives": [float(v) for v in pool_obj_arr[i]],
            "origin": pool_tag[i],
        }

    return SearchResult(
        seed=seed,
        objectives=OBJECTIVES,
        history=history,
        baseline_names=base_names,
        baseline_objectives=baseline_objs,
        pareto_policies=pool_pol_arr[front],
        pareto_objectives=pool_obj_arr[front],
        champion=champion,
        evaluations=evaluations,
        meta={
            "generations": generations,
            "population": population,
            "elite_frac": elite_frac,
            "rungs": list(rungs),
            "weights": [float(w) for w in weights],
            "lane_counts": lane_counts,
            "scenario_lanes": S,
        },
    )


__all__ = [
    "DEFAULT_WEIGHTS",
    "DOMINANCE_COLUMNS",
    "SearchResult",
    "cem_search",
    "elite_select",
    "generation_generator",
    "halving_lane_counts",
    "scalarize",
]
