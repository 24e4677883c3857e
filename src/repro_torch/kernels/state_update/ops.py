"""``retire_land`` and ``assign_gather``: the event's table landings, on
the kernels of ``csrc/state_update.cu`` for CUDA tensors (each launch
counted in the function's ``launches``) and on the plain versions of
``ref.py`` for CPU tensors."""
from __future__ import annotations

import ctypes

import torch

from .. import cuda_lib
from ..dispatch import use_kernel
from .ref import assign_gather_ref, retire_land_ref

_P, _I = ctypes.c_void_p, ctypes.c_int
_RETIRE_ARGTYPES = [_P] * 9 + [_I] * 4 + [_P] * 10 + [_P, _I]
_ASSIGN_ARGTYPES = [_P] * 11 + [_I] * 4 + [_P] * 4 + [_P, _I]
_ASSIGN_ROWS = ("valid", "slot", "pipe", "pool", "cpus", "ram", "end", "oom",
                "prio", "warm", "timed")
_ASSIGN_DTYPES = (torch.bool, torch.int32, torch.int32, torch.int32,
                  torch.float32, torch.float32, torch.int32, torch.int32,
                  torch.int32, torch.bool, torch.bool)


def retire_land(
    ctr_pipe, ctr_end, ctr_start, oomed, done, timed, arrival, prio, tick,
    *, timeout_on: bool = False,
):
    """Land the event's container retirements on the pipeline axis; see
    ``ref.retire_land_ref``. ``timed`` may be None (timeout off). A
    launch with the timeout branch on also counts in
    ``timeout_launches``."""
    if not use_kernel(ctr_pipe):
        return retire_land_ref(
            ctr_pipe, ctr_end, ctr_start, oomed, done, timed, arrival, prio,
            tick, timeout_on=timeout_on,
        )
    F, MC = ctr_pipe.shape
    MP = arrival.shape[1]
    dev = ctr_pipe.device
    i32, f32, b = torch.int32, torch.float32, torch.bool
    for arg, x, dt in (
        ("ctr_pipe", ctr_pipe, i32), ("ctr_end", ctr_end, i32),
        ("oomed", oomed, b), ("done", done, b),
    ):
        cuda_lib.require("retire_land", arg, x, dt, (F, MC), dev)
    cuda_lib.require("retire_land", "arrival", arrival, i32, (F, MP), dev)
    cuda_lib.require("retire_land", "prio", prio, i32, (F, MP), dev)
    if timeout_on:
        cuda_lib.require("retire_land", "ctr_start", ctr_start, i32, (F, MC), dev)
        cuda_lib.require("retire_land", "timed", timed, b, (F, MC), dev)
        cuda_lib.require("retire_land", "tick", tick, i32, (F,), dev)
        branch = (ctr_start.data_ptr(), timed.data_ptr(), tick.data_ptr())
    else:
        branch = (None, None, None)

    outs = (
        torch.empty((F, MP), dtype=b, device=dev),     # oom_hit
        torch.empty((F, MP), dtype=b, device=dev),     # done_hit
        torch.empty((F, MP), dtype=b, device=dev),     # timed_hit
        torch.empty((F, MP), dtype=i32, device=dev),   # end_of
        torch.empty((F,), dtype=i32, device=dev),      # timed_wasted
        torch.empty((F,), dtype=f32, device=dev),      # lat_sum
        torch.empty((F, 3), dtype=f32, device=dev),    # lat_prio
        torch.empty((F, 3), dtype=i32, device=dev),    # done_prio
        torch.empty((F,), dtype=i32, device=dev),      # n_done
        torch.empty((F,), dtype=i32, device=dev),      # n_oom
    )
    fn = cuda_lib.function("repro_retire_land", _RETIRE_ARGTYPES)
    code = fn(
        *(x.data_ptr() for x in (ctr_pipe, ctr_end, oomed, done, arrival,
                                 prio)),
        *branch, F, MC, MP, int(timeout_on), *(y.data_ptr() for y in outs),
        *cuda_lib.stream_args(dev),
    )
    cuda_lib.check_launch("retire_land", code)
    retire_land.launches += 1
    if timeout_on:
        retire_land.timeout_launches += 1
    return outs


retire_land.launches = 0
retire_land.timeout_launches = 0


def _check_assign_rows(rows, F: int, K: int, dev: torch.device) -> None:
    """One pass over the 11 ``[F, K]`` rows; ``cuda_lib.require`` names
    the first that is not a contiguous tensor of its dtype on ``dev``."""
    shape = (F, K)
    for name, x, dt in zip(_ASSIGN_ROWS, rows, _ASSIGN_DTYPES):
        if not (type(x) is torch.Tensor and x.dtype is dt and x.shape == shape
                and x.device == dev and x.is_contiguous()):
            cuda_lib.require("assign_gather", name, x, dt, shape, dev)


def _assign_outputs(F: int, MC: int, MP: int, dev: torch.device):
    """The 13 outputs as views of the four regions the kernel writes:
    ``[7, F, MC]`` (pipe, pool, cpus, ram, end, oom, prio; the floats as
    their bits), ``[2, F, MP]`` (cpus, ram), ``[3, F, MC]`` bools (hit,
    warm, timed) and ``[F, MP]`` bools (hit); four allocations and
    three ``unbind``s in place of 13 allocations. Returns ``(regions,
    outputs)``."""
    c = torch.empty((7, F, MC), dtype=torch.int32, device=dev)
    p = torch.empty((2, F, MP), dtype=torch.float32, device=dev)
    fc = torch.empty((3, F, MC), dtype=torch.bool, device=dev)
    hp = torch.empty((F, MP), dtype=torch.bool, device=dev)
    l_pipe, l_pool, l_cpus, l_ram, l_end, l_oom, l_prio = c.unbind(0)
    hit_c, l_warm, l_timed = fc.unbind(0)
    l_pcpus, l_pram = p.unbind(0)
    outs = (hit_c, l_pipe, l_pool, l_cpus.view(torch.float32),
            l_ram.view(torch.float32), l_end, l_oom, l_prio, l_warm, l_timed,
            hp, l_pcpus, l_pram)
    return (c, p, fc, hp), outs


def _launch_assign(rows, regions, F, K, MC, MP, dev) -> None:
    fn = cuda_lib.function("repro_assign_gather", _ASSIGN_ARGTYPES)
    code = fn(
        *(x.data_ptr() for x in rows), F, K, MC, MP,
        *(y.data_ptr() for y in regions), *cuda_lib.stream_args(dev),
    )
    cuda_lib.check_launch("assign_gather", code)


def assign_gather(
    valid, slot, pipe, pool, cpus, ram, end, oom, prio, warm, timed,
    *, max_containers: int, max_pipelines: int,
):
    """Land ``[F, K]`` assignment rows on the container and pipeline
    axes; see ``ref.assign_gather_ref``. On CUDA the 13 outputs are
    views of four allocations (``_assign_outputs``)."""
    if not use_kernel(valid):
        return assign_gather_ref(
            valid, slot, pipe, pool, cpus, ram, end, oom, prio, warm, timed,
            max_containers=max_containers, max_pipelines=max_pipelines,
        )
    F, K = valid.shape
    MC, MP = int(max_containers), int(max_pipelines)
    dev = valid.device
    rows = (valid, slot, pipe, pool, cpus, ram, end, oom, prio, warm, timed)
    _check_assign_rows(rows, F, K, dev)
    regions, outs = _assign_outputs(F, MC, MP, dev)
    _launch_assign(rows, regions, F, K, MC, MP, dev)
    assign_gather.launches += 1
    return outs


assign_gather.launches = 0

__all__ = ["retire_land", "assign_gather"]
