"""Device meshes, a port of ``repro.launch.mesh`` onto ``torch.distributed``.

Single pod: 256 ranks as (data=16, model=16).
Multi-pod:  2 pods x 256 ranks as (pod=2, data=16, model=16): the pod
axis is pure data parallel.

Both build ``DeviceMesh``es over the ranks of the default process group,
which the caller has started (``torchrun`` gives each process its rank;
``init_process_group`` needs its address, world size and rank): on the
CUDA cards when the group runs ``nccl``, on the CPU under ``gloo``.
"""
from __future__ import annotations


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


__all__ = ["make_host_mesh", "make_production_mesh"]
