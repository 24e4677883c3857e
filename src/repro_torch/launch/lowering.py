"""Abstract (no-allocation) lowerings of train / prefill / decode steps
for any (arch x shape x mesh) cell, a port of ``repro.launch.lowering``.

``arch_rules`` applies an architecture's ``rule_overrides`` to the
default sharding rules; ``model_axes_and_shapes`` gives every
parameter's logical axes and its ``meta`` tensor (nothing allocated);
``shardings_of`` places a tree of axes strings on a mesh. The
optimizer of an ``ArchSpec`` is ``runtime.steps.opt_config``.

``lower_train``, ``lower_prefill``, ``lower_decode`` and ``lower_cell``
run one step on ``meta`` tensors, as DTensors over ``mesh`` (a mesh of
``launch.mesh.fake_process_group``; None: one device, no DTensor),
under ``roofline.counting`` and return a ``Lowered``: the counterpart
of the reference's lowered and compiled program, read by
``launch/dryrun.py``. The state and the batch are placed as
``runtime.train_loop.shard_state`` and ``data.pipeline`` place real
ones; the hand-written kernels run as their ``meta`` stand-ins and
report their work. Nothing is allocated and no kernel is launched.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Mapping

import torch

from ..models.axes import model_axes
from ..models.common import ModelConfig
from ..parallel.sharding import ShardingRules, distribute, placements_for


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


META = torch.device("meta")


@dataclasses.dataclass
class Lowered:
    """One step's count (``roofline.counting.Count``), for rank 0: FLOPs,
    HBM bytes, collectives by kind (count, result bytes, wire bytes,
    bytes over links inside a node and between nodes), the peak of live
    bytes, the hand-written kernels' calls and work, the ops run, and
    the seconds the step took to trace."""
    kind: str
    chips: int
    flops: float
    bytes: float
    collectives: dict
    link_bytes: dict
    peak_bytes: int
    kernels: dict
    ops: int
    t_trace_s: float

    @property
    def collective_bytes(self) -> float:
        return sum(v["wire_bytes"] for v in self.collectives.values())


def _spec(shape):
    from .shapes import SHAPES

    return SHAPES[shape] if isinstance(shape, str) else shape


def _chips(mesh) -> int:
    return 1 if mesh is None else int(mesh.size())


def _place(tree, axes, mesh, rules: Mapping):
    """``tree``'s ``meta`` tensors (the whole value) as DTensors placed by
    their axes on ``mesh`` (no mesh: as they are)."""
    if mesh is None:
        return tree
    place = shardings_of(axes, tree, mesh, rules)
    return {k: distribute(v, mesh, place[k]) for k, v in tree.items()}


def _lowered(kind: str, mesh, count) -> Lowered:
    return Lowered(kind=kind, chips=_chips(mesh), flops=count.flops, bytes=count.bytes,
                   collectives=count.collectives, link_bytes=count.link_bytes(),
                   peak_bytes=count.peak_bytes, kernels=count.kernels, ops=count.ops,
                   t_trace_s=count.seconds)


def lower_train(arch, shape, mesh=None) -> Lowered:
    """One ``make_train_step`` step of ``arch.model`` (its optimizer,
    state dtype and microbatches) on one global batch of ``shape`` (a
    name of ``launch.shapes.SHAPES`` or a ``ShapeSpec``)."""
    from ..roofline.counting import counting
    from ..runtime.steps import make_train_step, opt_config
    from ..runtime.train_loop import shard_state
    from .shapes import batch_axes, batch_specs

    cfg, rules, spec = arch.model, arch_rules(arch), _spec(shape)
    init_fn, step_fn = make_train_step(cfg, opt_config(arch), microbatches=arch.train_microbatches,
                                       device=META, mesh=mesh, rules=rules)
    state = init_fn(0)
    if mesh is not None:
        state = shard_state(arch, cfg, state, mesh)
    batch = _place(batch_specs(cfg, spec), batch_axes(cfg, spec), mesh, rules.act)
    with counting(state, batch) as count:
        step_fn(state, batch)
    return _lowered("train", mesh, count)


def _serving_params(arch, mesh):
    from ..parallel.sharding import shard_params
    from ..runtime.steps import model_init

    cfg = arch.model
    params = model_init(cfg, device=META)
    if mesh is not None:
        shard_params(params, model_axes(cfg), mesh, arch_rules(arch))
    return params


@contextlib.contextmanager
def _serving_ctx(arch, mesh, params=None):
    """Serving on a mesh: the sharding context of the architecture's
    activation rules and, with ``params``, each parameter sharded over a
    data axis gathered whole for the compute (FSDP, as a training step
    gathers it)."""
    from ..parallel.ctx import sharding_ctx
    from ..parallel.sharding import gathered_params

    if mesh is None:
        yield
        return
    with sharding_ctx(mesh, arch_rules(arch).act), (
            contextlib.nullcontext() if params is None else gathered_params(params)):
        yield


def lower_prefill(arch, shape, mesh=None) -> Lowered:
    """One prefill of ``shape``'s global batch into caches of its length."""
    from ..roofline.counting import counting
    from ..runtime.steps import make_serve_steps
    from .shapes import batch_axes, batch_specs

    cfg, rules, spec = arch.model, arch_rules(arch), _spec(shape)
    prefill_fn, _ = make_serve_steps(cfg)
    params = _serving_params(arch, mesh)
    batch = _place(batch_specs(cfg, spec), batch_axes(cfg, spec), mesh, rules.act)
    with torch.no_grad(), counting(params, batch) as count, _serving_ctx(arch, mesh, params):
        prefill_fn(params, batch, spec.seq)
    return _lowered("prefill", mesh, count)


def _decode_caches(cfg, spec, mesh):
    """Caches of ``spec``'s batch and length; under a mesh's context the
    KV caches are DTensors placed as the kernels take them (batch over
    the batch axes, heads over ``"model"``): ``init_kv_cache`` places an
    LM's, and the encoder-decoder's (which a prefill would return) are
    placed here. The recurrent states stay whole on every rank, as the
    serving path keeps them."""
    from ..models.attention import KVCache, _head_split
    from ..models.encdec import EncDecCaches
    from ..parallel.ctx import kernel_placements
    from .shapes import cache_shapes

    caches = cache_shapes(cfg, spec.batch, spec.seq)
    if mesh is None or cfg.family != "audio":
        return caches
    split, kv_dim = _head_split(cfg.n_heads, cfg.n_kv_heads)

    def place(t):
        return distribute(t, mesh, kernel_placements(4, 0, kv_dim, spec.batch, split))

    return EncDecCaches(self_kv=[KVCache(k=place(c.k), v=place(c.v)) for c in caches.self_kv],
                        cross_kv=[(place(k), place(v)) for k, v in caches.cross_kv])


def lower_decode(arch, shape, mesh=None) -> Lowered:
    """One decode step of ``shape``'s global batch against caches of its
    length, drawn as the serving path draws them (under the sharding
    context on a mesh)."""
    from ..roofline.counting import counting
    from ..runtime.steps import make_serve_steps

    cfg, spec = arch.model, _spec(shape)
    _, decode_fn = make_serve_steps(cfg)
    params = _serving_params(arch, mesh)
    with torch.no_grad():
        with _serving_ctx(arch, mesh):
            caches = _decode_caches(cfg, spec, mesh)
        token = _place({"t": torch.empty((spec.batch,), dtype=torch.int32, device=META)},
                       {"t": "batch"}, mesh, arch_rules(arch).act)["t"]
        with counting(params, caches, token) as count, _serving_ctx(arch, mesh, params):
            decode_fn(params, caches, token, spec.seq - 1)
    return _lowered("decode", mesh, count)


def lower_cell(arch, shape, mesh=None) -> Lowered:
    kind = _spec(shape).kind
    if kind == "train":
        return lower_train(arch, shape, mesh)
    if kind == "prefill":
        return lower_prefill(arch, shape, mesh)
    return lower_decode(arch, shape, mesh)


__all__ = [
    "Lowered",
    "arch_rules",
    "lower_cell",
    "lower_decode",
    "lower_prefill",
    "lower_train",
    "model_axes_and_shapes",
    "shardings_of",
]
