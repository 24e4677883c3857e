"""The normalised policy search space over
:class:`~repro_torch.core.policy.PolicyParams`.

Searches live in the unit cube ``[0, 1]^P`` and map through the
per-knob ``POLICY_BOUNDS`` box; every named scheduler's default point
normalises into the cube, so populations can be seeded from (and
compared against) the built-ins. All sampling takes an explicit
``torch.Generator`` and draws f32 on the CPU: no hidden RNG state
anywhere in the search stack. The reference draws with ``jax.random``
threefry, so the two agree in distribution, not in value.

>>> import numpy as np, torch
>>> from repro_torch.core.policy import DEFAULT_POINTS
>>> sp = PolicySpace()
>>> u = sp.normalize(DEFAULT_POINTS["sjf"].to_vector())
>>> bool((u >= 0).all() and (u <= 1).all())
True
>>> np.allclose(sp.denormalize(u), DEFAULT_POINTS["sjf"].to_vector())
True
>>> sp.sample_uniform(torch.Generator().manual_seed(0), 4).shape
(4, 15)
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.policy import N_POLICY_PARAMS, PolicyParams, policy_bounds


class PolicySpace:
    """Box-bounded policy space with unit-cube sampling helpers.

    ``lo``/``hi`` default to :func:`repro_torch.core.policy.policy_bounds`;
    pass narrower vectors to restrict a search (e.g. pin the naive-mode
    switches to 0 by setting ``lo = hi`` on those axes).
    """

    def __init__(self, lo=None, hi=None):
        d_lo, d_hi = policy_bounds()
        self.lo = np.asarray(d_lo if lo is None else lo, np.float32)
        self.hi = np.asarray(d_hi if hi is None else hi, np.float32)
        if self.lo.shape != (N_POLICY_PARAMS,) or self.hi.shape != (
            N_POLICY_PARAMS,
        ):
            raise ValueError(
                f"bounds must be [{N_POLICY_PARAMS}] vectors, got "
                f"{self.lo.shape} / {self.hi.shape}"
            )
        if np.any(self.hi < self.lo):
            raise ValueError("hi < lo on some axis")
        self.names = PolicyParams._fields

    # -- unit-cube <-> knob space -----------------------------------------
    def denormalize(self, u) -> np.ndarray:
        """Map ``[..., P]`` unit-cube points to policy vectors (f32)."""
        u = np.asarray(u, np.float32)
        return (self.lo + u * (self.hi - self.lo)).astype(np.float32)

    def normalize(self, x) -> np.ndarray:
        """Map policy vectors into the unit cube (degenerate axes with
        ``hi == lo`` map to 0)."""
        x = np.asarray(x, np.float32)
        span = self.hi - self.lo
        return np.where(
            span > 0, (x - self.lo) / np.maximum(span, 1e-12), 0.0
        ).astype(np.float32)

    # -- explicit-generator sampling (normalised space) --------------------
    def sample_uniform(self, generator: torch.Generator, n: int) -> np.ndarray:
        """``[n, P]`` uniform unit-cube sample from an explicit generator."""
        u = torch.rand((n, N_POLICY_PARAMS), generator=generator, dtype=torch.float32)
        return u.numpy()

    def sample_gaussian(self, generator: torch.Generator, mean, std, n: int) -> np.ndarray:
        """``[n, P]`` Gaussian sample around ``mean``/``std`` (unit-cube
        coordinates), clipped back into the cube — the CEM proposal."""
        mean = torch.as_tensor(np.asarray(mean, np.float32))
        std = torch.as_tensor(np.asarray(std, np.float32))
        z = torch.randn((n, N_POLICY_PARAMS), generator=generator, dtype=torch.float32)
        return torch.clamp(mean + z * std, 0.0, 1.0).numpy()


__all__ = ["PolicySpace"]
