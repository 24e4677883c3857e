"""``rwkv6_scan``: pad to a multiple of the chunk, then the kernels of
``csrc/rwkv6_scan.cu`` for CUDA tensors (the intra-chunk pass and the
carry, one call counted once in ``rwkv6_scan.launches``) or
``ref.rwkv6_chunked_ref`` for CPU tensors.

With grad enabled and an input that requires grad, the call is
differentiable (``_RWKV6Scan``, one Function on both devices): on CUDA
the forward carry also writes every chunk's input state, and the
backward is ``rwkv6_scan_bwd``: the kernels of ``csrc/rwkv6_scan_bwd.cu``
for CUDA tensors (each call counted once in ``rwkv6_scan_bwd.launches``),
``ref.rwkv6_scan_bwd_ref`` for CPU tensors. The padding, the casts of w
and u to f32 and the ``[:, :S]`` slice stay outside the Function, where
autograd differentiates them.

``meta`` tensors (a dry run) take the kernels' paths up to the launch
and return their empty outputs there; every call, a launch or a
stand-in, reports its work (``roofline.kernels``) to
``roofline.counting``."""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from ...roofline import kernels as work
from ...roofline.counting import report
from .. import cuda_lib
from ..dispatch import abstract, use_kernel
from .ref import rwkv6_chunked_ref, rwkv6_scan_bwd_ref

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [_P] * 10 + [_I] * 6 + [_P, _I]
_BWD_ARGTYPES = [_P] * 16 + [_I] * 6 + [_P, _I]
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
    if torch.is_grad_enabled() and any(t.requires_grad for t in (r, k, v, w, u, state0)):
        out, state = _RWKV6Scan.apply(r, k, v, w.to(torch.float32), u.to(torch.float32),
                                      state0, C)
    elif abstract(r) or use_kernel(r):
        out, state, _ = _launch(r, k, v, w, u, state0, C)
    else:
        out, state = rwkv6_chunked_ref(r, k, v, w, u, state0, chunk=C)
    return (out[:, :S], state) if pad else (out, state)


def _check(kernel: str, r, C: int) -> None:
    N = r.shape[3]
    if r.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"{kernel}: r has dtype {r.dtype}; the kernel takes bf16 or f32")
    if N > MAX_HEAD_DIM or N % 8 or C > MAX_CHUNK:
        raise ValueError(
            f"{kernel}: the kernel takes head_dim % 8 == 0 (rows of 16-byte "
            f"copies), head_dim <= {MAX_HEAD_DIM} and chunk <= {MAX_CHUNK}, got {N} and {C}"
        )


def _launch(r, k, v, w, u, state0, C: int, *, with_states: bool = False):
    """The forward kernels; returns (out, state, the input state of every
    chunk [B,H,S/C,N,N] f32, or None)."""
    B, S, H, N = r.shape
    dev = r.device
    _check("rwkv6_scan", r, C)
    r, k, v = r.contiguous(), k.contiguous(), v.contiguous()
    # the chunk math is f32 (as in the reference): w and u enter as f32
    w = w.to(torch.float32).contiguous()
    u = u.to(torch.float32).contiguous()
    state0 = state0.contiguous()
    out = torch.empty_like(r)
    state = torch.empty((B, H, N, N), dtype=torch.float32, device=dev)
    # scratch: the intra-chunk output A V + d V in f32, B S H N floats
    intra = torch.empty((B, S, H, N), dtype=torch.float32, device=dev)
    states = (torch.empty((B, H, S // C, N, N), dtype=torch.float32, device=dev)
              if with_states else None)
    report("rwkv6_scan", work.rwkv6_scan, B, S, H, N, C, r.dtype, with_states=with_states)
    if r.is_meta:
        return out, state, states
    for name, x in (("r", r), ("k", k), ("v", v)):
        cuda_lib.require("rwkv6_scan", name, x, r.dtype, (B, S, H, N), dev)
    cuda_lib.require("rwkv6_scan", "w", w, torch.float32, (B, S, H, N), dev)
    cuda_lib.require("rwkv6_scan", "u", u, torch.float32, (H, N), dev)
    cuda_lib.require("rwkv6_scan", "state0", state0, torch.float32, (B, H, N, N), dev)
    fn = cuda_lib.function("repro_rwkv6_scan", _ARGTYPES)
    code = fn(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(), u.data_ptr(),
        state0.data_ptr(), out.data_ptr(), state.data_ptr(), intra.data_ptr(),
        None if states is None else states.data_ptr(),
        B, S, H, N, C, int(r.dtype == torch.bfloat16), *cuda_lib.stream_args(dev),
    )
    cuda_lib.check_launch("rwkv6_scan", code)
    rwkv6_scan.launches += 1
    return out, state, states


class _RWKV6Scan(torch.autograd.Function):
    """The chunked scan over S divisible by C, differentiable: saves the
    inputs (and on CUDA the forward's chunk states) and runs
    ``rwkv6_scan_bwd``. Under activation checkpointing its forward runs
    twice, each time on its own saved tensors."""

    @staticmethod
    def forward(ctx, r, k, v, w, u, state0, C: int):
        if abstract(r) or use_kernel(r):
            out, state, states = _launch(r, k, v, w, u, state0, C, with_states=True)
        else:
            (out, state), states = rwkv6_chunked_ref(r, k, v, w, u, state0, chunk=C), None
        ctx.save_for_backward(r, k, v, w, u, state0, states)
        ctx.C = C
        return out, state

    @staticmethod
    def backward(ctx, dout, dstate):
        r, k, v, w, u, state0, states = ctx.saved_tensors
        grads = rwkv6_scan_bwd(r, k, v, w, u, state0, dout, dstate, chunk=ctx.C, states=states)
        return (*(g if need else None for g, need in zip(grads, ctx.needs_input_grad)), None)


def rwkv6_scan_bwd(r, k, v, w, u, state0, dout, dstate, *, chunk: int, states=None):
    """The gradients (dr, dk, dv, dw, du, dstate0) of the chunked scan over
    S divisible by ``C = min(chunk, S)``, each in its input's dtype
    (dstate0 f32), from the cotangents ``dout`` (None: zeros) and
    ``dstate`` (None: zeros). On CUDA ``states`` is the forward's input
    state of every chunk (``_launch(..., with_states=True)``)."""
    if not (abstract(r) or use_kernel(r)):
        return rwkv6_scan_bwd_ref(r, k, v, w, u, state0, dout, dstate, chunk=chunk)
    B, S, H, N = r.shape
    C = min(chunk, S)
    dev = r.device
    _check("rwkv6_scan_bwd", r, C)
    if S % C:
        raise ValueError(f"rwkv6_scan_bwd: seq {S} must be divisible by chunk {C}")
    if states is None:
        raise ValueError("rwkv6_scan_bwd: the kernels take the forward's chunk states "
                         "(_launch(..., with_states=True))")
    dout = torch.zeros_like(r) if dout is None else dout.contiguous()
    r, k, v = r.contiguous(), k.contiguous(), v.contiguous()
    w32 = w.to(torch.float32).contiguous()
    u32 = u.to(torch.float32).contiguous()
    states = states.contiguous()
    if dstate is not None:
        dstate = dstate.contiguous()
    dr, dk, dv = torch.empty_like(r), torch.empty_like(k), torch.empty_like(v)
    dw = torch.empty_like(w32)
    du = torch.zeros_like(u32)    # a batch of 0 rows folds nothing
    ds0 = torch.empty((B, H, N, N), dtype=torch.float32, device=dev)
    # scratch: dS_out of every chunk, du's partials by (b, h, chunk)
    dsout = torch.empty_like(states)
    du_part = torch.empty((B, H, S // C, N), dtype=torch.float32, device=dev)
    report("rwkv6_scan_bwd", work.rwkv6_scan_bwd, B, S, H, N, C, r.dtype,
           with_dstate=dstate is not None)
    if not r.is_meta:
        _launch_bwd(r, k, v, w32, u32, states, dout, dstate, dr, dk, dv, dw, du, ds0, dsout,
                    du_part, C)
    return dr, dk, dv, dw.to(w.dtype), du.to(u.dtype), ds0


def _launch_bwd(r, k, v, w32, u32, states, dout, dstate, dr, dk, dv, dw, du, ds0, dsout,
                du_part, C: int) -> None:
    B, S, H, N = r.shape
    dev = r.device
    for name, x in (("r", r), ("k", k), ("v", v), ("dout", dout)):
        cuda_lib.require("rwkv6_scan_bwd", name, x, r.dtype, (B, S, H, N), dev)
    cuda_lib.require("rwkv6_scan_bwd", "w", w32, torch.float32, (B, S, H, N), dev)
    cuda_lib.require("rwkv6_scan_bwd", "u", u32, torch.float32, (H, N), dev)
    cuda_lib.require("rwkv6_scan_bwd", "states", states, torch.float32, (B, H, S // C, N, N), dev)
    if dstate is not None:
        cuda_lib.require("rwkv6_scan_bwd", "dstate", dstate, torch.float32, (B, H, N, N), dev)
    fn = cuda_lib.function("repro_rwkv6_scan_bwd", _BWD_ARGTYPES)
    code = fn(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), w32.data_ptr(), u32.data_ptr(),
        states.data_ptr(), dout.data_ptr(), None if dstate is None else dstate.data_ptr(),
        dr.data_ptr(), dk.data_ptr(), dv.data_ptr(), dw.data_ptr(), du.data_ptr(),
        ds0.data_ptr(), dsout.data_ptr(), du_part.data_ptr(),
        B, S, H, N, C, int(r.dtype == torch.bfloat16), *cuda_lib.stream_args(dev),
    )
    cuda_lib.check_launch("rwkv6_scan_bwd", code)
    rwkv6_scan_bwd.launches += 1


rwkv6_scan.launches = 0
rwkv6_scan_bwd.launches = 0

__all__ = ["rwkv6_scan", "rwkv6_scan_bwd"]
