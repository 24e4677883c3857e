"""``rwkv6_scan``: pad to a multiple of the chunk, then the kernels of
``csrc/rwkv6_scan.cu`` for CUDA tensors (the intra-chunk pass and the
carry, one call counted once in ``rwkv6_scan.launches``) or
``ref.rwkv6_chunked_ref`` for CPU tensors."""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from .. import cuda_lib
from ..dispatch import use_kernel
from .ref import rwkv6_chunked_ref

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [_P] * 9 + [_I] * 6 + [_P, _I]
MAX_HEAD_DIM = 64
MAX_CHUNK = 64


def rwkv6_scan(r, k, v, w, u, state0=None, *, chunk: int = 16):
    """r/k/v/w [B,S,H,N] (w: decays in (0, 1)), u [H,N], state0
    [B,H,N,N] f32 or None (zeros). Returns (out [B,S,H,N] in r's dtype,
    state [B,H,N,N] f32)."""
    B, S, H, N = r.shape
    if state0 is None:
        state0 = torch.zeros((B, H, N, N), dtype=torch.float32, device=r.device)
    # pad ragged sequences; w = 1, k = 0 is the identity state update
    C = min(chunk, S)
    pad = (C - S % C) % C
    if pad:
        def zpad(t, value=0.0):
            return F.pad(t, (0, 0, 0, 0, 0, pad), value=value)

        r, k, v, w = zpad(r), zpad(k), zpad(v), zpad(w, 1.0)
    if use_kernel(r):
        out, state = _launch(r, k, v, w, u, state0, C)
    else:
        out, state = rwkv6_chunked_ref(r, k, v, w, u, state0, chunk=C)
    return (out[:, :S], state) if pad else (out, state)


def _launch(r, k, v, w, u, state0, C: int):
    B, S, H, N = r.shape
    dev = r.device
    if r.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"rwkv6_scan: r has dtype {r.dtype}; the kernel takes bf16 or f32")
    if N > MAX_HEAD_DIM or N % 8 or C > MAX_CHUNK:
        raise ValueError(
            f"rwkv6_scan: the kernel takes head_dim % 8 == 0 (rows of 16-byte "
            f"copies), head_dim <= {MAX_HEAD_DIM} and chunk <= {MAX_CHUNK}, got {N} and {C}"
        )
    r, k, v = r.contiguous(), k.contiguous(), v.contiguous()
    for name, x in (("r", r), ("k", k), ("v", v)):
        cuda_lib.require("rwkv6_scan", name, x, r.dtype, (B, S, H, N), dev)
    # the chunk math is f32 (as in the reference): w and u enter as f32
    w = w.to(torch.float32).contiguous()
    u = u.to(torch.float32).contiguous()
    state0 = state0.contiguous()
    cuda_lib.require("rwkv6_scan", "w", w, torch.float32, (B, S, H, N), dev)
    cuda_lib.require("rwkv6_scan", "u", u, torch.float32, (H, N), dev)
    cuda_lib.require("rwkv6_scan", "state0", state0, torch.float32, (B, H, N, N), dev)
    out = torch.empty_like(r)
    state = torch.empty((B, H, N, N), dtype=torch.float32, device=dev)
    # scratch: the intra-chunk output A V + d V in f32, B S H N floats
    intra = torch.empty((B, S, H, N), dtype=torch.float32, device=dev)
    fn = cuda_lib.function("repro_rwkv6_scan", _ARGTYPES)
    code = fn(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(), u.data_ptr(),
        state0.data_ptr(), out.data_ptr(), state.data_ptr(), intra.data_ptr(),
        B, S, H, N, C, int(r.dtype == torch.bfloat16), *cuda_lib.stream_args(dev),
    )
    cuda_lib.check_launch("rwkv6_scan", code)
    rwkv6_scan.launches += 1
    return out, state


rwkv6_scan.launches = 0

__all__ = ["rwkv6_scan"]
