"""Abstract (no-allocation) views of an architecture for a mesh, a part
of the port of ``repro.launch.lowering``.

``arch_rules`` applies an architecture's ``rule_overrides`` to the
default sharding rules; ``model_axes_and_shapes`` gives every
parameter's logical axes and its ``meta`` tensor (nothing allocated);
``shardings_of`` places a tree of axes strings on a mesh. The
optimizer of an ``ArchSpec`` is ``runtime.steps.opt_config``. Lowering
a whole step for a dry run of a 256- or 512-rank mesh (``lower_*``)
waits for ROADMAP queue 1, item 16 (d).
"""
from __future__ import annotations

from typing import Any, Mapping

from ..models.axes import model_axes
from ..models.common import ModelConfig
from ..parallel.sharding import ShardingRules, placements_for


def arch_rules(arch) -> ShardingRules:
    return ShardingRules().override(param=arch.rule_overrides.get("param"),
                                    act=arch.rule_overrides.get("act"))


def model_axes_and_shapes(cfg: ModelConfig):
    """(``{name: axes}``, ``{name: meta tensor}``) of ``cfg``'s
    parameters, drawn on the ``meta`` device."""
    from ..runtime.steps import model_init

    shapes = dict(model_init(cfg, device="meta").named_parameters())
    return model_axes(cfg), shapes


def shardings_of(axes_tree, shape_tree, mesh, rules: Mapping) -> Any:
    """The placements of every leaf of ``shape_tree`` (tensors, ``meta``
    tensors or shape tuples) from the matching axes string of
    ``axes_tree`` (mappings, named tuples, lists and tuples of them)."""
    if isinstance(axes_tree, str):
        shape = getattr(shape_tree, "shape", shape_tree)
        return placements_for(tuple(shape), axes_tree, mesh, rules)
    if isinstance(axes_tree, Mapping):
        return {k: shardings_of(v, shape_tree[k], mesh, rules) for k, v in axes_tree.items()}
    if isinstance(axes_tree, tuple) and hasattr(axes_tree, "_fields"):
        return type(axes_tree)(*(shardings_of(a, s, mesh, rules)
                                 for a, s in zip(axes_tree, shape_tree)))
    return type(axes_tree)(shardings_of(a, s, mesh, rules) for a, s in zip(axes_tree, shape_tree))


def _lowering_waits(*_args, **_kwargs):
    raise NotImplementedError("lowering a step for a dry run of a large mesh waits for "
                              "ROADMAP queue 1, item 16 (d)")


lower_train = lower_prefill = lower_decode = lower_cell = _lowering_waits


__all__ = [
    "arch_rules",
    "lower_cell",
    "lower_decode",
    "lower_prefill",
    "lower_train",
    "model_axes_and_shapes",
    "shardings_of",
]
