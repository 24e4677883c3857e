"""``fleet_tick``: the fused phase-1 read, on the kernel or its plain
version by the device of the data (``kernels/dispatch.py``).

On CUDA tensors it launches ``repro_fleet_tick`` of ``csrc/sim_tick.cu``
on the current stream and counts the launch in ``fleet_tick.launches``;
on CPU tensors it runs ``ref.fleet_tick_ref``.
"""
from __future__ import annotations

import ctypes

import torch

from .. import cuda_lib
from ..dispatch import use_kernel
from .ref import fleet_tick_ref

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [_P] * 10 + [_I] * 4 + [_P] * 9 + [_P, _I]


def fleet_tick(
    ctr_status, ctr_end, ctr_oom, cpus, ram, pool,
    pipe_status, arrival, release, tick, *, num_pools: int,
):
    """Completions, releases, arrival admission, per-pool freed
    resources and next-event registers of one event over a fleet.

    Returns ``(oomed, done, new_ctr_status, freed_cpu, freed_ram, fresh,
    rel, nxt_retire, nxt_release)``; see ``ref.fleet_tick_ref``.
    """
    if not use_kernel(ctr_status):
        return fleet_tick_ref(
            ctr_status, ctr_end, ctr_oom, cpus, ram, pool,
            pipe_status, arrival, release, tick, num_pools=num_pools,
        )
    F, MC = ctr_status.shape
    MP = pipe_status.shape[1]
    NP = int(num_pools)
    dev = ctr_status.device
    i32, f32 = torch.int32, torch.float32
    for arg, x, dt in (
        ("ctr_status", ctr_status, i32), ("ctr_end", ctr_end, i32),
        ("ctr_oom", ctr_oom, i32), ("cpus", cpus, f32), ("ram", ram, f32),
        ("pool", pool, i32),
    ):
        cuda_lib.require("fleet_tick", arg, x, dt, (F, MC), dev)
    for arg, x in (
        ("pipe_status", pipe_status), ("arrival", arrival),
        ("release", release),
    ):
        cuda_lib.require("fleet_tick", arg, x, i32, (F, MP), dev)
    cuda_lib.require("fleet_tick", "tick", tick, i32, (F,), dev)

    outs = (
        torch.empty((F, MC), dtype=torch.bool, device=dev),  # oomed
        torch.empty((F, MC), dtype=torch.bool, device=dev),  # done
        torch.empty((F, MC), dtype=i32, device=dev),         # new status
        torch.empty((F, NP), dtype=f32, device=dev),         # freed cpu
        torch.empty((F, NP), dtype=f32, device=dev),         # freed ram
        torch.empty((F, MP), dtype=torch.bool, device=dev),  # fresh
        torch.empty((F, MP), dtype=torch.bool, device=dev),  # rel
        torch.empty((F,), dtype=i32, device=dev),            # nxt_retire
        torch.empty((F,), dtype=i32, device=dev),            # nxt_release
    )
    ins = (ctr_status, ctr_end, ctr_oom, cpus, ram, pool,
           pipe_status, arrival, release, tick)
    fn = cuda_lib.function("repro_fleet_tick", _ARGTYPES)
    code = fn(
        *(x.data_ptr() for x in ins), F, MC, MP, NP,
        *(y.data_ptr() for y in outs), *cuda_lib.stream_args(dev),
    )
    cuda_lib.check_launch("fleet_tick", code)
    fleet_tick.launches += 1
    return outs


fleet_tick.launches = 0

__all__ = ["fleet_tick"]
