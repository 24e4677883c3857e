"""Sharded, atomic, async checkpointing with keep-last-k and elastic
restore, a port of ``repro.checkpoint.ckpt``.

The behaviour is the JAX package's: a step is written to
``step_<n>.tmp/`` and renamed to ``step_<n>/`` only when complete (a
crashed writer never leaves a half checkpoint under the final name),
with a JSON manifest of every leaf; ``CheckpointManager.async_save``
copies the state to host memory at once and compresses and writes it on
a thread while training goes on; ``wait`` joins it (and re-raises its
error); the newest ``keep`` steps are kept.

The format is the port's own, built on the standard library, numpy and
torch alone: ``manifest.json`` (step, extra, and for each leaf its path,
dtype, shape, offset and byte count) and ``leaves.bin.zlib``, the leaves'
raw bytes one after the other, compressed with ``zlib`` (the JAX
package's codec where ``zstandard`` is absent). numpy has no bfloat16,
so a bf16 leaf is stored as its raw 16-bit words with ``"bfloat16"`` in
the manifest, and restored bit for bit.

A state is a tree of mappings, lists, tuples, named tuples and modules
(``nn.Module``: its named parameters) whose leaves are tensors, numpy
arrays or Python numbers. ``restore_checkpoint`` writes the stored
values into the template's own tensors (in place, on their device) and
returns the template's structure with them.

A sharded state (DTensor leaves, ``runtime.train_loop`` over a mesh) is
written as the reference's design has it: each rank writes the shards it
holds (one copy of each: a replica is written by the rank at coordinate
0 of its replicated mesh dims) to ``shard_<rank>.bin.zlib`` with their
index ranges in ``shard_<rank>.json``; rank 0 writes the manifest and
the plain leaves. Over more than one rank the step directory is renamed
once every rank has written (a barrier, on the caller's thread: in
``wait`` for an async save). A restore assembles each leaf's region
from whatever pieces hold it, so a state written on any mesh (or by one
process, in either layout) restores onto any other: the elastic
re-mesh.
"""
from __future__ import annotations

import dataclasses
import json
import pathlib
import shutil
import threading
import zlib
from typing import Any, Mapping, Optional

import numpy as np
import torch
from torch import nn

from ..parallel.ctx import is_dtensor

PAYLOAD = "leaves.bin.zlib"


def _world() -> tuple[int, int]:
    """(rank, world size) of the default process group ((0, 1) without
    one)."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _barrier() -> None:
    import torch.distributed as dist

    if _world()[1] > 1:
        dist.barrier()


def _region(t) -> tuple[tuple[int, ...], tuple[int, ...]]:
    """(start, shape) of the part of a leaf's global value that this rank
    holds: all of it for a plain tensor."""
    if not is_dtensor(t):
        return (0,) * t.ndim, tuple(t.shape)
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

    shape, start = compute_local_shape_and_global_offset(t.shape, t.device_mesh, t.placements)
    return tuple(start), tuple(shape)


def _writes(t) -> bool:
    """Whether this rank writes its shard of DTensor ``t``: one copy of
    every replica, from coordinate 0 of each unsharded mesh dim."""
    from torch.distributed.tensor import Shard

    coord = t.device_mesh.get_coordinate()
    return coord is not None and all(
        isinstance(pl, Shard) or c == 0 for pl, c in zip(t.placements, coord))


def _leaves(tree, prefix: str = ""):
    """(path, leaf) pairs of a state tree, in a fixed order."""
    if isinstance(tree, nn.Module):
        for name, p in tree.named_parameters():
            yield f"{prefix}.{name}" if prefix else name, p
    elif isinstance(tree, Mapping):
        for key in tree:
            yield from _leaves(tree[key], f"{prefix}[{key!r}]")
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for key in tree._fields:
            yield from _leaves(getattr(tree, key), f"{prefix}.{key}")
    elif isinstance(tree, (list, tuple)):
        for i, child in enumerate(tree):
            yield from _leaves(child, f"{prefix}[{i}]")
    else:
        yield prefix, tree


def _to_host(leaf) -> tuple[np.ndarray, str]:
    """A leaf (a DTensor: its local shard) as a host array and its dtype's
    name; bf16 keeps its bits."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        t = (t.to_local() if is_dtensor(t) else t).cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().copy(), "bfloat16"
        return t.numpy().copy(), str(t.dtype).split(".")[-1]
    arr = np.asarray(leaf)
    return arr.copy(), str(arr.dtype)


def _snapshot(state) -> dict:
    """This rank's part of ``state`` on the host: ``plain`` (path, array,
    dtype) for the plain leaves (rank 0 alone writes them) and
    ``shards`` (path, array, dtype, global shape, start) for the DTensor
    shards this rank writes."""
    rank, _ = _world()
    plain, shards = [], []
    for path, leaf in _leaves(state):
        if is_dtensor(leaf):
            if _writes(leaf):
                start, _ = _region(leaf)
                shards.append((path, *_to_host(leaf), list(leaf.shape), list(start)))
        elif rank == 0:
            plain.append((path, *_to_host(leaf)))
    return {"plain": plain, "shards": shards}


def _pack(entries, index: list) -> bytes:
    """The entries' raw bytes one after the other; each entry's offset,
    byte count, dtype and local shape appended to ``index``."""
    chunks, offset = [], 0
    for path, arr, dtype, *where in entries:
        raw = np.ascontiguousarray(arr).tobytes()
        entry = {"path": path, "dtype": dtype, "shape": list(arr.shape), "offset": offset,
                 "nbytes": len(raw)}
        if where:
            entry.update(global_shape=where[0], start=where[1])
        index.append(entry)
        chunks.append(raw)
        offset += len(raw)
    return zlib.compress(b"".join(chunks), level=3)


def _tmp_dir(directory: pathlib.Path, step: int) -> pathlib.Path:
    return directory / f"step_{step:08d}.tmp"


def _prepare(directory: pathlib.Path, step: int) -> pathlib.Path:
    """The step's empty temporary directory (a stale one from a crashed
    writer removed by rank 0), once every rank can write into it."""
    tmp = _tmp_dir(directory, step)
    if _world()[0] == 0:
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
    _barrier()
    return tmp


def _write(snap: dict, tmp: pathlib.Path, step: int, extra: Optional[dict]) -> None:
    """Write this rank's files into the step's temporary directory; rank
    0 also writes the plain leaves and the manifest."""
    rank, world = _world()
    if snap["shards"]:
        index: list = []
        (tmp / f"shard_{rank}.bin.zlib").write_bytes(_pack(snap["shards"], index))
        (tmp / f"shard_{rank}.json").write_text(json.dumps(index))
    if rank == 0:
        manifest = {"step": step, "format": "repro_torch", "codec": "zlib", "leaves": [],
                    "extra": extra or {}, "ranks": world}
        (tmp / PAYLOAD).write_bytes(_pack(snap["plain"], manifest["leaves"]))
        (tmp / "manifest.json").write_text(json.dumps(manifest))


def _commit(directory: pathlib.Path, step: int) -> pathlib.Path:
    """Rename the step's temporary directory to its final name (rank 0,
    once every rank has written)."""
    final = directory / f"step_{step:08d}"
    _barrier()
    if _world()[0] == 0:
        if final.exists():
            shutil.rmtree(final)
        _tmp_dir(directory, step).rename(final)
    _barrier()
    return final


def save_checkpoint(state: Any, directory: str | pathlib.Path, step: int,
                    extra: Optional[dict] = None) -> pathlib.Path:
    """Write ``state`` for ``step``, atomically (every rank of a sharded
    state calls it); returns the step's directory."""
    directory = pathlib.Path(directory)
    _write(_snapshot(state), _prepare(directory, step), step, extra)
    return _commit(directory, step)


def latest_step(directory: str | pathlib.Path) -> Optional[int]:
    directory = pathlib.Path(directory)
    if not directory.exists():
        return None
    steps = [int(p.name.split("_")[1]) for p in directory.iterdir()
             if p.is_dir() and p.name.startswith("step_") and not p.name.endswith(".tmp")]
    return max(steps) if steps else None


def _from_host(raw: bytes, entry: dict) -> np.ndarray:
    dtype = np.int16 if entry["dtype"] == "bfloat16" else np.dtype(entry["dtype"])
    return np.frombuffer(raw, dtype=dtype).reshape(entry["shape"])


class _Stored:
    """Every leaf of one stored step, whole or in pieces: ``region(path,
    start, shape)`` assembles any box of a leaf's global value."""

    def __init__(self, d: pathlib.Path, manifest: dict):
        self.pieces: dict = {}
        self._add(zlib.decompress((d / PAYLOAD).read_bytes()), manifest["leaves"])
        for index in sorted(d.glob("shard_*.json")):
            payload = (d / index.name.replace(".json", ".bin.zlib")).read_bytes()
            self._add(zlib.decompress(payload), json.loads(index.read_text()))

    def _add(self, payload: bytes, entries) -> None:
        for e in entries:
            arr = _from_host(payload[e["offset"]:e["offset"] + e["nbytes"]], e)
            start = tuple(e.get("start", (0,) * arr.ndim))
            shape = tuple(e.get("global_shape", arr.shape))
            self.pieces.setdefault(e["path"], []).append((start, arr, e["dtype"], shape))

    def dtype_and_shape(self, path: str):
        if path not in self.pieces:
            raise KeyError(f"checkpoint missing leaf {path}")
        _, _, dtype, shape = self.pieces[path][0]
        return dtype, shape

    def region(self, path: str, start, shape) -> np.ndarray:
        dtype, _ = self.dtype_and_shape(path)
        pieces = self.pieces[path]
        out = np.empty(shape, dtype=pieces[0][1].dtype)
        covered = np.zeros(shape, dtype=bool)
        for p_start, arr, _, _ in pieces:
            lo = [max(a, b) for a, b in zip(start, p_start)]
            hi = [min(a + n, b + m) for a, n, b, m in zip(start, shape, p_start, arr.shape)]
            if any(h <= lo_ for lo_, h in zip(lo, hi)) and len(shape):
                continue
            dst = tuple(slice(a - s, b - s) for a, b, s in zip(lo, hi, start))
            src = tuple(slice(a - s, b - s) for a, b, s in zip(lo, hi, p_start))
            out[dst] = arr[src]
            covered[dst] = True
        if not covered.all():
            raise ValueError(f"leaf {path}: the stored shards do not cover {tuple(start)} + "
                             f"{tuple(shape)}")
        return out


def _rebuild(tree, arrays: "_Stored", prefix: str = ""):
    """The template's structure with every leaf taken from ``arrays`` (by
    path); tensors are written in place."""
    if isinstance(tree, nn.Module):
        for name, p in tree.named_parameters():
            _fill(p, arrays, f"{prefix}.{name}" if prefix else name)
        return tree
    if isinstance(tree, Mapping):
        return {key: _rebuild(tree[key], arrays, f"{prefix}[{key!r}]") for key in tree}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_rebuild(getattr(tree, key), arrays, f"{prefix}.{key}")
                            for key in tree._fields))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(child, arrays, f"{prefix}[{i}]") for i, child in enumerate(tree))
    if isinstance(tree, torch.Tensor):
        return _fill(tree, arrays, prefix)
    _, shape = arrays.dtype_and_shape(prefix)
    arr = arrays.region(prefix, (0,) * len(shape), shape)
    return arr.copy() if isinstance(tree, np.ndarray) else type(tree)(arr.item())


@torch.no_grad()
def _fill(t: torch.Tensor, arrays: "_Stored", path: str) -> torch.Tensor:
    """Write the stored value of ``path`` into ``t`` (a DTensor: the
    region of its local shard)."""
    dtype, shape = arrays.dtype_and_shape(path)
    if t.dtype == torch.bfloat16 and dtype != "bfloat16":
        raise TypeError(f"leaf {path}: stored {dtype}, the template is bfloat16")
    if tuple(shape) != tuple(t.shape):
        raise ValueError(f"leaf {path}: stored {dtype}{tuple(shape)}, the template holds "
                         f"{t.dtype}{tuple(t.shape)}")
    if is_dtensor(t) and t.device_mesh.get_coordinate() is None:
        return t            # a rank outside the leaf's mesh holds none of it
    start, local = _region(t)
    src = torch.from_numpy(arrays.region(path, start, local))
    if t.dtype == torch.bfloat16:
        src = src.view(torch.bfloat16)
    if src.dtype != t.dtype:
        raise ValueError(f"leaf {path}: stored {dtype}, the template holds {t.dtype}")
    dst = t.to_local() if is_dtensor(t) else t
    dst.copy_(src.to(dst.device))
    return t


def restore_checkpoint(directory: str | pathlib.Path, template: Any, step: Optional[int] = None):
    """Restore ``step`` (the newest when None) into ``template``; returns
    (state, manifest)."""
    directory = pathlib.Path(directory)
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {directory}")
    d = directory / f"step_{step:08d}"
    manifest = json.loads((d / "manifest.json").read_text())
    return _rebuild(template, _Stored(d, manifest)), manifest


@dataclasses.dataclass
class CheckpointManager:
    directory: str | pathlib.Path
    keep: int = 3

    def __post_init__(self):
        self.directory = pathlib.Path(self.directory)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self._pending: Optional[int] = None

    # ---- sync ----------------------------------------------------------
    def save(self, state, step: int, extra: Optional[dict] = None):
        self.wait()
        p = save_checkpoint(state, self.directory, step, extra)
        self._gc()
        return p

    # ---- async ---------------------------------------------------------
    def async_save(self, state, step: int, extra: Optional[dict] = None):
        """Snapshot to host memory now; compress and write on a thread.
        One process renames the step to its final name on that thread, as
        soon as it is written. Over more than one rank the rename waits
        for the next ``wait`` (every rank calls it: ``async_save``,
        ``restore`` and the end of a run do), once every rank has
        written: a barrier is not taken on a writer thread."""
        self.wait()
        snapshot = _snapshot(state)
        tmp = _prepare(self.directory, step)
        alone = _world()[1] == 1

        def work():
            try:
                _write(snapshot, tmp, step, extra)
                if alone:
                    _commit(self.directory, step)
                    self._gc()
            except BaseException as e:  # noqa: BLE001
                self._error = e

        self._pending = None if alone else step
        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error, self._pending = self._error, None, None
            raise err
        if self._pending is not None:
            step, self._pending = self._pending, None
            _commit(self.directory, step)
            self._gc()

    def restore(self, template, step=None):
        self.wait()
        return restore_checkpoint(self.directory, template, step)

    def latest_step(self):
        return latest_step(self.directory)

    def _gc(self):
        if _world()[0] != 0:
            return
        steps = sorted(p for p in pathlib.Path(self.directory).glob("step_*")
                       if p.is_dir() and not p.name.endswith(".tmp"))
        for p in steps[: -self.keep] if self.keep else []:
            shutil.rmtree(p, ignore_errors=True)


__all__ = ["CheckpointManager", "latest_step", "restore_checkpoint", "save_checkpoint"]
