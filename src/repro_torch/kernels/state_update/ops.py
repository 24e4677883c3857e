"""``retire_land`` and ``assign_gather``: the event's table landings, on
the kernels of ``csrc/state_update.cu`` for CUDA tensors (each launch
counted in the function's ``launches``) and on the plain versions of
``ref.py`` for CPU tensors."""
from __future__ import annotations

import ctypes

import torch

from .. import cuda_lib
from ..dispatch import use_kernel
from .ref import _TIMEOUT_SLICE, assign_gather_ref, retire_land_ref

_P, _I = ctypes.c_void_p, ctypes.c_int
_RETIRE_ARGTYPES = [_P] * 6 + [_I] * 3 + [_P] * 10 + [_P, _I]
_ASSIGN_ARGTYPES = [_P] * 11 + [_I] * 4 + [_P] * 13 + [_P, _I]


def retire_land(
    ctr_pipe, ctr_end, ctr_start, oomed, done, timed, arrival, prio, tick,
    *, timeout_on: bool = False,
):
    """Land the event's container retirements on the pipeline axis; see
    ``ref.retire_land_ref``. ``timed`` may be None (timeout off)."""
    if timeout_on:
        raise NotImplementedError(_TIMEOUT_SLICE)
    if not use_kernel(ctr_pipe):
        return retire_land_ref(
            ctr_pipe, ctr_end, ctr_start, oomed, done, timed, arrival, prio,
            tick,
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
        F, MC, MP, *(y.data_ptr() for y in outs),
        *cuda_lib.stream_args(dev),
    )
    cuda_lib.check_launch("retire_land", code)
    retire_land.launches += 1
    return outs


retire_land.launches = 0


def assign_gather(
    valid, slot, pipe, pool, cpus, ram, end, oom, prio, warm, timed,
    *, max_containers: int, max_pipelines: int,
):
    """Land ``[F, K]`` assignment rows on the container and pipeline
    axes; see ``ref.assign_gather_ref``."""
    if not use_kernel(valid):
        return assign_gather_ref(
            valid, slot, pipe, pool, cpus, ram, end, oom, prio, warm, timed,
            max_containers=max_containers, max_pipelines=max_pipelines,
        )
    F, K = valid.shape
    MC, MP = int(max_containers), int(max_pipelines)
    dev = valid.device
    i32, f32, b = torch.int32, torch.float32, torch.bool
    rows = (valid, slot, pipe, pool, cpus, ram, end, oom, prio, warm, timed)
    names = ("valid", "slot", "pipe", "pool", "cpus", "ram", "end", "oom",
             "prio", "warm", "timed")
    dtypes = (b, i32, i32, i32, f32, f32, i32, i32, i32, b, b)
    for arg, x, dt in zip(names, rows, dtypes):
        cuda_lib.require("assign_gather", arg, x, dt, (F, K), dev)

    def c_out(dt):
        return torch.empty((F, MC), dtype=dt, device=dev)

    def p_out(dt):
        return torch.empty((F, MP), dtype=dt, device=dev)

    outs = (
        c_out(b), c_out(i32), c_out(i32), c_out(f32), c_out(f32),
        c_out(i32), c_out(i32), c_out(i32), c_out(b), c_out(b),
        p_out(b), p_out(f32), p_out(f32),
    )
    fn = cuda_lib.function("repro_assign_gather", _ASSIGN_ARGTYPES)
    code = fn(
        *(x.data_ptr() for x in rows), F, K, MC, MP,
        *(y.data_ptr() for y in outs), *cuda_lib.stream_args(dev),
    )
    cuda_lib.check_launch("assign_gather", code)
    assign_gather.launches += 1
    return outs


assign_gather.launches = 0

__all__ = ["retire_land", "assign_gather"]
