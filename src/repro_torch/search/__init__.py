"""Fleet-scale scheduling-policy search on top of the lane-major engine.

The simulator is the oracle of a search over policy space:

* :mod:`repro_torch.search.space` — the normalised policy box
  (:class:`~repro_torch.core.policy.PolicyParams` bounds) with
  explicit-generator sampling;
* :mod:`repro_torch.search.pareto` — NaN-guarded dominance and Pareto
  fronts;
* :mod:`repro_torch.search.grid` — one ``fleet_run`` per evaluation: the
  fleet axis spans policy candidates × scenario lanes, on the card
  unless the caller asks for the CPU;
* :mod:`repro_torch.search.driver` — a gradient-free CEM driver with
  successive-halving rungs, pure-numpy elite selection, and a recorded
  candidate-history artifact.

Reproducibility: all randomness flows from the seed (one CPU
``torch.Generator`` a generation, seeded from ``(seed, generation)``);
scenario batches are rebuilt bitwise-identically from fixed seeds per
rung; elite selection is ``np.lexsort`` with an index tie-break. Same
seed ⇒ identical candidate history and Pareto front.
"""
from .driver import (
    SearchResult,
    cem_search,
    elite_select,
    halving_lane_counts,
    scalarize,
)
from .grid import OBJECTIVES, evaluate_policies, scenario_factory
from .pareto import dominates, pareto_front, sanitize, weakly_dominates
from .space import PolicySpace

__all__ = [
    "OBJECTIVES",
    "PolicySpace",
    "SearchResult",
    "cem_search",
    "dominates",
    "elite_select",
    "evaluate_policies",
    "halving_lane_counts",
    "pareto_front",
    "sanitize",
    "scalarize",
    "scenario_factory",
    "weakly_dominates",
]
