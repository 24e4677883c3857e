"""Carry workloads, states and LM parameters between the JAX package and
the port.

Both packages use the same field names; the JAX package's ``Workload``
and ``SimState`` become numpy arrays (``np.asarray`` of every field) on
its side, and these functions turn such arrays into the port's lane-major
tensors and back. A per-lane array set (no fleet axis) gains a lane
axis of one. ``lm_params_from_arrays`` and ``encdec_params_from_arrays``
turn the JAX ``lm_init`` and ``encdec_init`` parameter trees into the
port's per-layer modules, and ``params_into_arrays`` writes a port
model's parameters back into such a tree; ``named_from_tree`` reads any
tree of the parameters' structure (gradients, moments) by the port's
parameter names, and ``opt_state_from_arrays`` carries a JAX
``OptState`` into the port's. Used by the parity tests; nothing on the simulation, serving or
training path calls it.
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


def _jax_node(cfg, tree, name: str):
    """The node of a JAX parameter-structured tree that holds the port's
    parameter ``name``, and the index of its layer along the stacked
    axis (None for an unstacked node)."""
    parts = name.split(".")
    if parts[0] == "layers":
        layer, rest = int(parts[1]), parts[2:]
        base = cfg.n_periods * cfg.period
        if layer < base:
            node, index = tree["stack"]["periods"][layer % cfg.period], layer // cfg.period
        else:
            node, index = tree["stack"]["tail"][layer - base], None
    elif parts[0] in ("enc", "dec"):
        node, index, rest = tree[parts[0]], int(parts[1]), parts[2:]
    else:
        node, index, rest = tree, None, parts
    for key in rest:
        node = node[key]
    return node, index


def named_from_tree(cfg, model, tree) -> dict:
    """``{name: tensor}`` over the port ``model``'s parameter names, from a
    JAX tree of the parameters' structure given as numpy arrays (the
    gradients of ``jax.grad``, AdamW's moments); a leaf that is a mapping
    (Adafactor's ``{"vr", "vc"}``) becomes a mapping of tensors."""
    def take(node, index):
        if isinstance(node, Mapping):
            return {k: take(v, index) for k, v in node.items()}
        return _param_tensor(node if index is None else np.asarray(node)[index])

    return {name: take(*_jax_node(cfg, tree, name)) for name, _ in model.named_parameters()}


def params_into_arrays(cfg, model, tree):
    """Write ``model``'s parameters into ``tree``, a JAX parameter tree of
    numpy arrays (zeros of the ``lm_init`` / ``encdec_init`` shapes and
    dtypes, stacked as the JAX package stacks its layers), in place;
    returns it. bf16 values pass through f32 exactly."""
    for name, p in model.named_parameters():
        leaf, index = _jax_node(cfg, tree, name)
        leaf[... if index is None else index] = (
            p.detach().to(torch.float32).numpy().astype(leaf.dtype))
    return tree


def opt_state_from_arrays(cfg, model, opt):
    """The port's ``OptState`` (on the CPU) from the JAX package's
    ``OptState`` of ``model``'s parameters with numpy leaves: AdamW's
    ``{"m", "v"}`` by parameter name, or Adafactor's ``{"vr", "vc"}`` /
    ``{"v"}`` by leaf of ``runtime.steps.stacked_leaves`` (the JAX
    tree's own leaves, stacked layers and all), bf16 kept bit for bit."""
    from .optim.optimizers import OptState
    from .runtime.steps import stacked_leaves

    inner = opt.inner
    if isinstance(inner, Mapping) and set(inner) == {"m", "v"}:
        inner = {k: named_from_tree(cfg, model, inner[k]) for k in ("m", "v")}
    else:
        def node(key):
            n = inner
            for part in key.split("."):
                n = n[int(part)] if isinstance(n, (list, tuple)) else n[part]
            return {k: _param_tensor(v) for k, v in n.items()}

        names = [n for n, _ in model.named_parameters()]
        inner = {key: node(key) for key in stacked_leaves(cfg, names)}
    return OptState(step=torch.tensor(int(np.asarray(opt.step)), dtype=torch.int32), inner=inner)


__all__ = [
    "encdec_params_from_arrays",
    "lm_params_from_arrays",
    "named_from_tree",
    "opt_state_from_arrays",
    "params_into_arrays",
    "state_from_arrays",
    "state_to_arrays",
    "workload_from_arrays",
]
