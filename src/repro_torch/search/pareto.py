"""NaN-guarded Pareto dominance over minimised objective vectors.

Objectives follow the minimise convention throughout (including
utilisation, see :data:`repro_torch.search.grid.OBJECTIVES`). A NaN
objective — an empty lane, an all-shed scenario, a policy that finished
nothing — maps to +inf (PR-9 NaN-guard pattern): it can never dominate,
and anything finite dominates it, so degenerate candidates sink to the
back of every front instead of poisoning comparisons.

>>> import numpy as np
>>> dominates([1.0, 2.0], [2.0, 2.0])
True
>>> dominates([1.0, 2.0], [1.0, 2.0])  # ties: equal points don't dominate
False
>>> weakly_dominates([1.0, 2.0], [1.0, 2.0])
True
>>> dominates([1.0, float("nan")], [2.0, 3.0])  # NaN -> +inf, can't win
False
>>> dominates([1.0, 3.0], [1.0, float("nan")])  # ...and finite beats it
True
>>> pareto_front([[1.0, 4.0], [2.0, 3.0], [3.0, 3.0], [2.0, 5.0]]).tolist()
[0, 1]
>>> pareto_front([[7.0, 7.0]]).tolist()  # single candidate IS the front
[0]
>>> pareto_front(np.empty((0, 2))).tolist()
[]
"""
from __future__ import annotations

import numpy as np


def sanitize(objs) -> np.ndarray:
    """Objective matrix as float64 with every NaN replaced by +inf."""
    objs = np.asarray(objs, np.float64)
    return np.where(np.isnan(objs), np.inf, objs)


def dominates(a, b) -> bool:
    """True iff ``a`` is no worse than ``b`` everywhere and strictly
    better somewhere (both minimised; NaN = +inf)."""
    a, b = sanitize(a), sanitize(b)
    return bool(np.all(a <= b) and np.any(a < b))


def weakly_dominates(a, b) -> bool:
    """True iff ``a`` is no worse than ``b`` on every objective."""
    a, b = sanitize(a), sanitize(b)
    return bool(np.all(a <= b))


def pareto_front(objs) -> np.ndarray:
    """Indices (ascending) of the non-dominated rows of ``objs``.

    A row is kept unless some other row strictly dominates it;
    duplicate rows therefore all stay on the front (neither strictly
    dominates the other), keeping the selection deterministic under
    candidate reordering.
    """
    objs = sanitize(objs)
    n = objs.shape[0]
    keep = np.ones((n,), bool)
    for i in range(n):
        strict = np.all(objs <= objs[i], axis=1) & np.any(
            objs < objs[i], axis=1
        )
        keep[i] = not bool(np.any(strict))
    return np.flatnonzero(keep)


__all__ = ["sanitize", "dominates", "weakly_dominates", "pareto_front"]
