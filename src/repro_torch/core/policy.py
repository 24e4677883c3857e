"""Scheduler policies as points of one flat f32 knob vector.

The port's copy of ``repro.core.policy``: every named scheduler of the
parameterised family (``scheduler.policy_family``) is the family
evaluated at its :data:`DEFAULT_POINTS` entry. Field order is the
vector layout.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np


class PolicyParams(NamedTuple):
    """One scheduling policy; booleans are floats thresholded at 0.5."""

    # ---- allocation sizing (paper §4.1.2) ---------------------------------
    chunk_frac: float = 0.10    # fresh-arrival grant, fraction of total
    cap_frac: float = 0.50      # allocation cap (and OOM-reject threshold)
    retry_mult: float = 2.0     # OOM-retry multiplier on the last grant
    # ---- queue ordering: f32 lead key size*n_ops + age*entered - prio*prio
    size_weight: float = 0.0
    prio_weight: float = 0.0
    age_weight: float = 0.0
    # ---- preemption -------------------------------------------------------
    preempt: float = 1.0
    preempt_min_prio: float = 0.0
    victim_prio_gap: float = 0.0
    # ---- pool selection (data plane) --------------------------------------
    multi_pool: float = 0.0
    cache_pin: float = 0.0
    locality_bonus: float = 0.0
    # ---- naive-mode switches ----------------------------------------------
    exclusive: float = 0.0
    grab_all: float = 0.0
    ram_gate: float = 1.0

    def to_vector(self) -> np.ndarray:
        return np.asarray(self, dtype=np.float32)

    @classmethod
    def from_vector(cls, vec) -> "PolicyParams":
        vec = np.asarray(vec, dtype=np.float32).reshape(-1)
        if vec.shape[0] != N_POLICY_PARAMS:
            raise ValueError(
                f"policy vector must have {N_POLICY_PARAMS} entries "
                f"({', '.join(cls._fields)}), got {vec.shape[0]}"
            )
        return cls(*(float(v) for v in vec))


N_POLICY_PARAMS = len(PolicyParams._fields)


DEFAULT_POINTS: dict[str, PolicyParams] = {
    "naive": PolicyParams(
        preempt=0.0, exclusive=1.0, grab_all=1.0, ram_gate=0.0,
    ),
    "priority": PolicyParams(),
    "priority_pool": PolicyParams(multi_pool=1.0),
    "cache_aware": PolicyParams(multi_pool=1.0, cache_pin=1.0),
    "locality_pool": PolicyParams(multi_pool=1.0, locality_bonus=1e-3),
    "sjf": PolicyParams(
        chunk_frac=0.25, size_weight=1.0, preempt=0.0,
    ),
}


__all__ = ["PolicyParams", "N_POLICY_PARAMS", "DEFAULT_POINTS"]
