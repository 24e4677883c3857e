"""``masked_lex_argmin`` and the two selections built on it, on the
kernel of ``csrc/sched_select.cu`` for CUDA tensors (each launch counted
in ``masked_lex_argmin.launches``) and on ``ref.py`` for CPU tensors."""
from __future__ import annotations

import ctypes

import torch

from .. import cuda_lib
from ..dispatch import use_kernel
from .ref import masked_lex_argmin_ref

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [_P, _I, _I, _I, _P, _P, _P, _I, _P, _P, _I]


def masked_lex_argmin(mask, keys):
    """Index of the lexicographically smallest ``(*keys[i], i)`` among
    ``mask`` ``[F, N]`` per lane, -1 where the mask is empty. ``keys``
    is a sequence of 1 to 3 ``[F, N]`` tensors, each f32 or int32."""
    keys = tuple(keys)
    if not use_kernel(mask):
        return masked_lex_argmin_ref(mask, keys)
    if not 1 <= len(keys) <= 3:
        raise ValueError(f"masked_lex_argmin takes 1 to 3 keys, got {len(keys)}")
    F, N = mask.shape
    dev = mask.device
    cuda_lib.require("masked_lex_argmin", "mask", mask, torch.bool, (F, N), dev)
    f32_keys = 0
    for j, k in enumerate(keys):
        dt = torch.float32 if k.dtype == torch.float32 else torch.int32
        cuda_lib.require("masked_lex_argmin", f"keys[{j}]", k, dt, (F, N), dev)
        if dt == torch.float32:
            f32_keys |= 1 << j
    ptrs = [k.data_ptr() for k in keys]
    ptrs += [ptrs[-1]] * (3 - len(ptrs))  # unused slots
    out = torch.empty((F,), dtype=torch.int32, device=dev)
    fn = cuda_lib.function("repro_masked_lex_argmin", _ARGTYPES)
    code = fn(
        mask.data_ptr(), F, N, len(keys), *ptrs, f32_keys, out.data_ptr(),
        *cuda_lib.stream_args(dev),
    )
    cuda_lib.check_launch("masked_lex_argmin", code)
    masked_lex_argmin.launches += 1
    return out


masked_lex_argmin.launches = 0


def select_next_pipe(mask, prio, entered):
    """Queue head: priority desc, entry asc, pid asc."""
    return masked_lex_argmin(mask, (-prio, entered))


def select_victim(live, ctr_prio, ctr_start, below_prio):
    """Preemption victim strictly below ``below_prio``: priority asc,
    start desc (least progress lost), slot asc."""
    m = live & (ctr_prio < below_prio)
    return masked_lex_argmin(m, (ctr_prio, -ctr_start))


__all__ = ["masked_lex_argmin", "select_next_pipe", "select_victim"]
