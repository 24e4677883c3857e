"""Device meshes, a port of ``repro.launch.mesh`` onto ``torch.distributed``.

Single pod: 256 ranks as (data=16, model=16).
Multi-pod:  2 pods x 256 ranks as (pod=2, data=16, model=16): the pod
axis is pure data parallel.

Both build ``DeviceMesh``es over the ranks of the default process group,
which the caller has started (``torchrun`` gives each process its rank;
``init_process_group`` needs its address, world size and rank): on the
CUDA cards when the group runs ``nccl``, on the CPU under ``gloo``.

A dry run (``launch/lowering.py``, ``launch/dryrun.py``) starts a
``fake_process_group`` of the cell's world size instead: rank 0 of 256
or 512, in one process, with no peers (``torch.testing._internal.
distributed.fake_pg``: its collectives move nothing). Its meshes are
``"cuda"`` meshes, so DTensor picks the collectives it would pick over
NCCL (an all-to-all where ``gloo`` would gather), but the fake backend
sets no device and the dry run's tensors live on ``meta``: the card is
not touched.
"""
from __future__ import annotations

import contextlib


def _device_type() -> str:
    import torch.distributed as dist

    if not dist.is_initialized():
        raise RuntimeError("a device mesh needs a started process group "
                           "(torch.distributed.init_process_group)")
    return "cpu" if dist.get_backend() == "gloo" else "cuda"


def _mesh(shape: tuple[int, ...], names: tuple[str, ...]):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    device = _device_type()
    size = 1
    for n in shape:
        size *= n
    if size != dist.get_world_size():
        raise ValueError(f"a {dict(zip(names, shape))} mesh needs {size} ranks; the process "
                         f"group has {dist.get_world_size()}")
    return init_device_mesh(device, shape, mesh_dim_names=names)


def make_production_mesh(*, multi_pod: bool = False):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(shape, axes)


def make_host_mesh(data: int = 1, model: int = 1, pod: int = 0):
    """A small (data, model) mesh, or (pod, data, model) with ``pod``,
    over every rank of the process group (tests, smoke runs)."""
    if pod:
        return _mesh((pod, data, model), ("pod", "data", "model"))
    return _mesh((data, model), ("data", "model"))


@contextlib.contextmanager
def fake_process_group(world_size: int):
    """The default process group, inside: rank 0 of ``world_size`` on the
    ``"fake"`` backend (one process, no peers, collectives that move
    nothing), destroyed on the way out. Raises if a group is already
    started."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("a dry run starts its own fake process group; one is already "
                           "started (torch.distributed.destroy_process_group)")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


__all__ = ["fake_process_group", "make_host_mesh", "make_production_mesh"]
