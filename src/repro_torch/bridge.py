"""Carry workloads, states and LM parameters between the JAX package and
the port.

Both packages use the same field names; the JAX package's ``Workload``
and ``SimState`` become numpy arrays (``np.asarray`` of every field) on
its side, and these functions turn such arrays into the port's lane-major
tensors and back. A per-lane array set (no fleet axis) gains a lane
axis of one. ``lm_params_from_arrays`` and ``encdec_params_from_arrays``
turn the JAX ``lm_init`` and ``encdec_init`` parameter trees into the
port's per-layer modules. Used by the parity
tests; nothing on the simulation or serving path calls it.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from .core.state import FaultTrace, SimState, Workload

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
    (``arrival`` is ``[F, MP]``) or without (``[MP]``) a lane axis.
    ``faults``, where given, is the reference's fault trace: a mapping of
    its five fields by name, with the same lane axis as the workload;
    ``policy``, where given, the per-lane ``PolicyParams`` vectors."""
    lane = np.asarray(arrays["arrival"]).ndim == 1

    def tensors(names, source):
        out = {}
        for name in names:
            t = _tensor(name, source[name], device)
            out[name] = t[None] if lane else t
        return out

    fields = tensors(Workload._fields[:10], arrays)
    if arrays.get("faults") is not None:
        fields["faults"] = FaultTrace(**tensors(FaultTrace._fields, arrays["faults"]))
    if arrays.get("policy") is not None:
        fields.update(tensors(("policy",), arrays))
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


def _param_tensor(a) -> torch.Tensor:
    """A numpy array as a CPU tensor of the same dtype; bfloat16 arrays
    (the ``ml_dtypes`` type that JAX hands to numpy) keep their bits."""
    a = np.ascontiguousarray(np.asarray(a))
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _tensors(node, index=None):
    """A numpy tree (nested mappings) as CPU tensors; ``index`` takes
    slice ``index`` of every leaf's leading axis."""
    if isinstance(node, Mapping):
        return {name: _tensors(child, index) for name, child in node.items()}
    return _param_tensor(node if index is None else np.asarray(node)[index])


def lm_params_from_arrays(cfg, tree):
    """The port's ``LM`` parameters (on the CPU) from the JAX package's
    ``lm_init`` parameter tree given as numpy arrays. The JAX tree stacks
    each pattern position over the periods (``stack.periods[i]``,
    leading axis ``n_periods``): its slice ``p`` becomes layer
    ``p * period + i``; the ``tail`` layers follow."""
    from .models.blocks import Block
    from .models.lm import LM

    layers = [None] * cfg.n_layers
    for i, stacked in enumerate(tree["stack"]["periods"]):
        for p in range(cfg.n_periods):
            layers[p * cfg.period + i] = Block(cfg.pattern[i], _tensors(stacked, p))
    base = cfg.n_periods * cfg.period
    for t, layer in enumerate(tree["stack"]["tail"]):
        layers[base + t] = Block(cfg.pattern[t % cfg.period], _tensors(layer))
    head, frontend = tree.get("head"), tree.get("frontend_proj")
    return LM(_param_tensor(tree["embed"]), _param_tensor(tree["final_norm"]),
              None if head is None else _param_tensor(head), layers,
              None if frontend is None else _param_tensor(frontend))


def encdec_params_from_arrays(cfg, tree):
    """The port's ``EncDec`` parameters (on the CPU) from the JAX
    package's ``encdec_init`` parameter tree given as numpy arrays. The
    JAX tree stacks the encoder and decoder layers on a leading axis
    (``enc``, ``dec``): slice ``i`` becomes layer ``i``."""
    from .models.encdec import EncDec, EncDecLayer

    enc = [EncDecLayer(_tensors(tree["enc"], i)) for i in range(cfg.n_enc_layers)]
    dec = [EncDecLayer(_tensors(tree["dec"], i)) for i in range(cfg.n_layers)]
    return EncDec(*(_param_tensor(tree[name]) for name in
                    ("frontend_proj", "embed", "enc_norm", "final_norm", "head")), enc, dec)


__all__ = [
    "encdec_params_from_arrays",
    "lm_params_from_arrays",
    "state_from_arrays",
    "state_to_arrays",
    "workload_from_arrays",
]
