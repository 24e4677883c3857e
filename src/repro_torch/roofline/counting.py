"""Counting what a step executes: the port's counterpart of the JAX
package's ``roofline/hlo_stats.py``.

The reference reads a compiled program's HLO and multiplies loop bodies
by their trip counts. The port runs the step once (eagerly, on ``meta``
tensors for a dry run or on the card) inside ``counting()`` and counts
each op as it executes, so a loop needs no trip count. For rank 0's
local tensors it gives:

- **FLOPs**: ``torch.utils.flop_counter``'s formulas for the aten ops
  that have one (the matrix products), plus the operations of every
  hand-written kernel call (``report``, from ``roofline.kernels``).
- **HBM bytes**: the tensor inputs plus outputs of every aten op that
  moves data: not a view (an op whose outputs all alias an input without
  writing it) and not an allocation (``empty*``). Eager PyTorch fuses
  nothing, so each op reads and writes HBM; a hand-written kernel counts
  its own bytes. Collectives are counted apart, not here.
- **Peak live bytes**: the largest sum of live storages (each storage
  once, however many views share it), from the storages of ``roots`` at
  the start and every op's outputs, each dropped when its storage dies.
- **Collectives**: every ``_c10d_functional`` op (and DTensor's
  ``shard_dim_alltoall``): its kind, the bytes of its result, its
  group's size (from its ``group_name``), the wire bytes of the ring
  model (``analysis.wire_bytes``) and whether the group stays inside a
  node of ``H100.gpus_per_node`` consecutive ranks.

A DTensor op is not counted: the mode lets DTensor run it (returns
``NotImplemented``) and counts the local ops and collectives it turns
into, at the local shard's shape. Neither are the ops DTensor runs under
its own fake-tensor mode to propagate shapes, nor any op none of whose
tensors lies on the counted device (the roots' device: ``meta`` in a dry
run, ``cuda`` on the card): DTensor's bookkeeping on CPU tensors, which
it caches, so that its count would change between a first and a second
run of the same step. An op whose inputs all lie elsewhere is not
counted either (a copy from the host is not a step's HBM traffic, and
``torch.tensor(x, device="meta")`` runs no op at all), so that the same
step counts the same on the card and on ``meta``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
import time
import weakref
from typing import Any, Iterator

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from .analysis import COLLECTIVE_OPS, wire_bytes
from .hw import H100

# the kinds of the collectives, by op name (``_c10d_functional``,
# ``_dtensor``); ops of those namespaces that move nothing
_KINDS = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_gather_into_tensor_out": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_reduce": "all-reduce",
    "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_reduce_coalesced_": "all-reduce",
    "all_to_all_single": "all-to-all",
    "shard_dim_alltoall": "all-to-all",
}
_NO_TRAFFIC = {"wait_tensor", "_wrap_tensor_autograd"}
# ops that are not counted at all: the no-op that ``torch.tensor`` runs on
# its fresh tensor where its data comes from the host (on the card, not on
# ``meta``, where ``torch.tensor`` dispatches nothing)
_SKIPPED = {"lift_fresh"}
_COLLECTIVE_NAMESPACES = {"_c10d_functional", "_dtensor"}
_ALLOCATIONS = {"empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided"}


@dataclasses.dataclass
class Count:
    """What ``counting()`` saw; every number for rank 0's local tensors."""
    flops: float = 0.0
    bytes: float = 0.0
    peak_bytes: int = 0
    ops: int = 0
    collectives: dict = dataclasses.field(default_factory=lambda: {
        k: {"count": 0, "result_bytes": 0.0, "wire_bytes": 0.0, "intra_bytes": 0.0,
            "inter_bytes": 0.0} for k in COLLECTIVE_OPS})
    kernels: dict = dataclasses.field(default_factory=dict)
    seconds: float = 0.0

    @property
    def collective_bytes(self) -> float:
        return sum(v["wire_bytes"] for v in self.collectives.values())

    def link_bytes(self) -> dict[str, float]:
        """Wire bytes over each kind of link: ``intra`` (a group inside
        one node) and ``inter`` (a group that crosses nodes)."""
        return {link: sum(v[f"{link}_bytes"] for v in self.collectives.values())
                for link in ("intra", "inter")}

    def kernel_calls(self) -> dict[str, int]:
        return {k: v["calls"] for k, v in self.kernels.items()}

    def add_kernel(self, kernel: str, work) -> None:
        entry = self.kernels.setdefault(kernel, {"calls": 0, "flops": 0.0, "bytes": 0.0,
                                                 "exps": 0.0})
        entry["calls"] += 1
        entry["flops"] += work.flops
        entry["bytes"] += work.bytes
        entry["exps"] += work.exps
        self.flops += work.flops
        self.bytes += work.bytes


_ACTIVE: list = []          # the counters open now (any thread reports to them)
_LOCK = threading.RLock()   # a storage can die (and its callback run) inside an update


def report(kernel: str, work_fn, *args, **kwargs) -> None:
    """A hand-written kernel's call (a launch on the card or a ``meta``
    stand-in): adds ``work_fn(*args, **kwargs)`` (a ``roofline.kernels``
    function) to every open counter. Does nothing, and computes nothing,
    when none is open."""
    if not _ACTIVE:
        return
    work = work_fn(*args, **kwargs)
    with _LOCK:
        for c in _ACTIVE:
            c.add_kernel(kernel, work)


def tensors_of(tree) -> list[torch.Tensor]:
    """The tensors of ``tree`` (modules' parameters and buffers, named
    tuples, mappings, sequences), DTensors as their local tensors."""
    out = []
    if isinstance(tree, torch.nn.Module):
        tree = list(tree.parameters()) + list(tree.buffers())
    leaves, _ = tree_flatten(tree)
    for x in leaves:
        if isinstance(x, torch.nn.Module):
            out += tensors_of(x)
        elif isinstance(x, torch.Tensor):
            out.append(getattr(x, "_local_tensor", x))
    return out


def _flat(x, out: list) -> list:
    """The tensors of an op's arguments or results (tensors, lists and
    tuples of them, mappings), appended to ``out``."""
    if isinstance(x, torch.Tensor):
        out.append(x)
    elif isinstance(x, (list, tuple)):
        for y in x:
            _flat(y, out)
    elif isinstance(x, dict):
        for y in x.values():
            _flat(y, out)
    return out


class _Counter(TorchDispatchMode):
    def __init__(self, count: Count, device: str):
        from torch.distributed.tensor import DTensor

        super().__init__()
        self.count, self.device = count, device
        self.dtensor = DTensor
        self.live: dict[int, tuple[Any, int]] = {}
        self.live_bytes = 0
        self.groups: dict = {}
        self.infos: dict = {}

    # ---- live storages ----------------------------------------------------
    def track(self, t: torch.Tensor) -> None:
        if type(t) is not torch.Tensor and not isinstance(t, torch.nn.Parameter):
            return
        st = t.untyped_storage()
        key = id(st)
        if key in self.live:
            return
        n = st.nbytes()
        self.live[key] = (weakref.ref(st, lambda _, k=key: self.free(k)), n)
        self.live_bytes += n
        if self.live_bytes > self.count.peak_bytes:
            self.count.peak_bytes = self.live_bytes

    def free(self, key: int) -> None:
        with _LOCK:
            entry = self.live.pop(key, None)
            if entry is not None:
                self.live_bytes -= entry[1]

    # ---- ops ----------------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if isinstance(func, torch._ops.HigherOrderOperator):
            return func(*args, **kwargs)
        if self.dtensor in types:
            return NotImplemented           # counted as the local ops it becomes
        out = func(*args, **kwargs)
        if torch._C._get_dispatch_mode(torch._C._TorchDispatchModeKey.FAKE) is not None:
            return out                      # DTensor's shape propagation
        with _LOCK:
            self.account(func, args, kwargs, out)
        return out

    def info(self, func):
        """(not counted, collective kind, moves nothing, flop formula) of
        ``func``."""
        from torch.utils.flop_counter import flop_registry

        name = func._overloadpacket.__name__
        if func.namespace in _COLLECTIVE_NAMESPACES:
            if name in _NO_TRAFFIC:
                return False, None, True, None
            if name not in _KINDS:
                raise ValueError(f"counting: no kind for the collective {func}")
            return False, _KINDS[name], True, None
        returns = func._schema.returns
        view = bool(returns) and all(r.alias_info is not None and not r.alias_info.is_write
                                     for r in returns)
        return (name in _SKIPPED, None, view or name in _ALLOCATIONS,
                flop_registry.get(func._overloadpacket))

    def account(self, func, args, kwargs, out) -> None:
        info = self.infos.get(func)
        if info is None:
            info = self.infos[func] = self.info(func)
        skipped, kind, still, formula = info
        if skipped:
            return
        ins = _flat((args, kwargs), [])
        if ins and not any(t.device.type == self.device for t in ins):
            return                          # bookkeeping elsewhere, or a copy from the host
        outs = _flat(out, [])
        if not ins and not any(t.device.type == self.device for t in outs):
            return
        c = self.count
        c.ops += 1
        if kind is not None:
            self.collective(kind, args, outs)
        if formula is not None:
            c.flops += formula(*args, **kwargs, out_val=out)
        if not still:
            c.bytes += sum(t.numel() * t.element_size() for t in ins + outs)
        for t in outs:
            self.track(t)

    def collective(self, kind: str, args, outs) -> None:
        import torch.distributed as dist
        from torch.distributed.distributed_c10d import _resolve_process_group

        group = args[-1]
        key = group if isinstance(group, str) else id(group)
        if key not in self.groups:
            pg = _resolve_process_group(group) if isinstance(group, str) else group
            ranks = dist.get_process_group_ranks(pg)
            nodes = {r // H100.gpus_per_node for r in ranks}
            self.groups[key] = (len(ranks), "intra" if len(nodes) == 1 else "inter")
        n, link = self.groups[key]
        result = sum(t.numel() * t.element_size() for t in outs)
        wire = wire_bytes(kind, result, n)
        entry = self.count.collectives[kind]
        entry["count"] += 1
        entry["result_bytes"] += result
        entry["wire_bytes"] += wire
        entry[f"{link}_bytes"] += wire


@contextlib.contextmanager
def counting(*roots) -> Iterator[Count]:
    """Count what runs inside. ``roots``: what is live at the start (a
    train state, a batch, caches: tensors, modules, DTensors, or trees of
    them), whose storages start the peak and whose device is the one
    counted (``meta`` without any). A collective's group lies inside a
    node when its ranks do, in nodes of ``H100.gpus_per_node``."""
    count = Count()
    live = tensors_of(roots)
    mode = _Counter(count, live[0].device.type if live else "meta")
    for t in live:
        mode.track(t)
    _ACTIVE.append(count)
    t0 = time.perf_counter()
    try:
        with mode:
            yield count
    finally:
        count.seconds = time.perf_counter() - t0
        _ACTIVE.remove(count)
        mode.live.clear()


__all__ = ["Count", "counting", "report", "tensors_of"]
