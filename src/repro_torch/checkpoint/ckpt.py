"""Atomic, async checkpointing with keep-last-k, a port of
``repro.checkpoint.ckpt`` for one process.

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

PAYLOAD = "leaves.bin.zlib"


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
    """A leaf as a host array and its dtype's name; bf16 keeps its bits."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().copy(), "bfloat16"
        return t.numpy().copy(), str(t.dtype).split(".")[-1]
    arr = np.asarray(leaf)
    return arr.copy(), str(arr.dtype)


def _snapshot(state) -> list[tuple[str, np.ndarray, str]]:
    return [(path, *_to_host(leaf)) for path, leaf in _leaves(state)]


def _write(flat, directory: pathlib.Path, step: int, extra: Optional[dict]) -> pathlib.Path:
    final = directory / f"step_{step:08d}"
    tmp = directory / f"step_{step:08d}.tmp"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    manifest = {"step": step, "format": "repro_torch", "codec": "zlib", "leaves": [],
                "extra": extra or {}}
    chunks, offset = [], 0
    for path, arr, dtype in flat:
        raw = np.ascontiguousarray(arr).tobytes()
        manifest["leaves"].append({"path": path, "dtype": dtype, "shape": list(arr.shape),
                                   "offset": offset, "nbytes": len(raw)})
        chunks.append(raw)
        offset += len(raw)
    (tmp / PAYLOAD).write_bytes(zlib.compress(b"".join(chunks), level=3))
    (tmp / "manifest.json").write_text(json.dumps(manifest))
    if final.exists():
        shutil.rmtree(final)
    tmp.rename(final)
    return final


def save_checkpoint(state: Any, directory: str | pathlib.Path, step: int,
                    extra: Optional[dict] = None) -> pathlib.Path:
    """Write ``state`` for ``step``, atomically; returns the step's
    directory."""
    return _write(_snapshot(state), pathlib.Path(directory), step, extra)


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


def _rebuild(tree, arrays: dict, prefix: str = ""):
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
    arr, _ = _lookup(arrays, prefix)
    return arr.copy() if isinstance(tree, np.ndarray) else type(tree)(arr.item())


def _lookup(arrays: dict, path: str):
    if path not in arrays:
        raise KeyError(f"checkpoint missing leaf {path}")
    return arrays[path]


@torch.no_grad()
def _fill(t: torch.Tensor, arrays: dict, path: str) -> torch.Tensor:
    arr, dtype = _lookup(arrays, path)
    if t.dtype == torch.bfloat16:
        if dtype != "bfloat16":
            raise TypeError(f"leaf {path}: stored {dtype}, the template is bfloat16")
        src = torch.from_numpy(arr.copy()).view(torch.bfloat16)
    else:
        src = torch.from_numpy(arr.copy())
    if src.dtype != t.dtype or tuple(src.shape) != tuple(t.shape):
        raise ValueError(f"leaf {path}: stored {dtype}{tuple(src.shape)}, the template holds "
                         f"{t.dtype}{tuple(t.shape)}")
    t.copy_(src.to(t.device))
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
    payload = zlib.decompress((d / PAYLOAD).read_bytes())
    arrays = {e["path"]: (_from_host(payload[e["offset"]:e["offset"] + e["nbytes"]], e),
                          e["dtype"]) for e in manifest["leaves"]}
    return _rebuild(template, arrays), manifest


@dataclasses.dataclass
class CheckpointManager:
    directory: str | pathlib.Path
    keep: int = 3

    def __post_init__(self):
        self.directory = pathlib.Path(self.directory)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    # ---- sync ----------------------------------------------------------
    def save(self, state, step: int, extra: Optional[dict] = None):
        p = save_checkpoint(state, self.directory, step, extra)
        self._gc()
        return p

    # ---- async ---------------------------------------------------------
    def async_save(self, state, step: int, extra: Optional[dict] = None):
        """Snapshot to host memory now; compress and write on a thread."""
        self.wait()
        snapshot = _snapshot(state)

        def work():
            try:
                _write(snapshot, self.directory, step, extra)
                self._gc()
            except BaseException as e:  # noqa: BLE001
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def restore(self, template, step=None):
        self.wait()
        return restore_checkpoint(self.directory, template, step)

    def latest_step(self):
        return latest_step(self.directory)

    def _gc(self):
        steps = sorted(p for p in pathlib.Path(self.directory).glob("step_*")
                       if p.is_dir() and not p.name.endswith(".tmp"))
        for p in steps[: -self.keep] if self.keep else []:
            shutil.rmtree(p, ignore_errors=True)


__all__ = ["CheckpointManager", "latest_step", "restore_checkpoint", "save_checkpoint"]
