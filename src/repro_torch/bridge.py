"""Carry workloads and states between the JAX package and the port.

Both packages use the same field names; the JAX package's ``Workload``
and ``SimState`` become numpy arrays (``np.asarray`` of every field) on
its side, and these functions turn such arrays into the port's lane-major
tensors and back. A per-lane array set (no fleet axis) gains a lane
axis of one. Used by the parity tests; nothing on the simulation path
calls it.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from .core.state import SimState, Workload

_DTYPES = {
    np.dtype(np.int32): torch.int32,
    np.dtype(np.float32): torch.float32,
    np.dtype(np.bool_): torch.bool,
}


def _tensor(name: str, x, device) -> torch.Tensor:
    a = np.ascontiguousarray(np.asarray(x))
    if a.dtype not in _DTYPES:
        raise TypeError(f"field {name} has dtype {a.dtype}; expected int32, float32 or bool")
    return torch.from_numpy(a.copy()).to(device)


def workload_from_arrays(arrays: Mapping[str, np.ndarray], device="cpu") -> Workload:
    """A port ``Workload`` from the reference's workload fields, with
    (``arrival`` is ``[F, MP]``) or without (``[MP]``) a lane axis."""
    for extra in ("faults", "policy"):
        if arrays.get(extra) is not None:
            raise NotImplementedError(
                f"workload field {extra!r} waits for ROADMAP queue 1, items 9 and 10"
            )
    lane = np.asarray(arrays["arrival"]).ndim == 1
    fields = {}
    for name in Workload._fields[:10]:
        t = _tensor(name, arrays[name], device)
        fields[name] = t[None] if lane else t
    return Workload(**fields)


def state_from_arrays(arrays: Mapping[str, np.ndarray], device="cpu") -> SimState:
    """A port ``SimState`` from the reference's state fields, with
    (``tick`` is ``[F]``) or without (``tick`` is a scalar) a lane axis."""
    lane = np.asarray(arrays["tick"]).ndim == 0
    fields = {}
    for name in SimState._fields:
        t = _tensor(name, arrays[name], device)
        fields[name] = t[None] if lane else t
    return SimState(**fields)


def state_to_arrays(state: SimState) -> dict[str, np.ndarray]:
    """Every field of a port state as a numpy array (lane axis kept)."""
    return {name: getattr(state, name).detach().cpu().numpy() for name in SimState._fields}


__all__ = ["workload_from_arrays", "state_from_arrays", "state_to_arrays"]
