"""``flash_attention``: the kernel of ``csrc/flash_attention.cu`` for CUDA
tensors (each launch counted in ``flash_attention.launches``), for every
call: the full-sequence case and the ``q_offset``/``kv_len`` case of a
prefill against a cache alike. bf16 goes to the tensor-core kernel
(``wgmma``), f32 to the CUDA-core one. ``ref.flash_attention_ref`` for
CPU tensors.

With grad enabled and an input that requires grad, the call is
differentiable (``_FlashAttention``), with any ``q_offset >= 0`` and
``kv_len``, as the JAX package differentiates its plain path: the
forward keeps the log-sum-exp of each row (the kernel's ``lse`` output
on CUDA, ``flash_attention_fwd_lse_ref`` on the CPU) and the backward is
``flash_attention_bwd``: the kernels of ``csrc/flash_attention_bwd.cu``
for CUDA tensors (bf16 on the tensor cores, f32 on the CUDA cores; each
call counted once in ``flash_attention_bwd.launches``),
``flash_attention_bwd_ref`` for CPU tensors. Without grad nothing of
this runs and no ``lse`` is stored.

``meta`` tensors (a dry run) take the kernels' paths up to the launch
and return their empty outputs there; every call, a launch or a
stand-in, reports its work (``roofline.kernels``) to
``roofline.counting``."""
from __future__ import annotations

import ctypes

import torch

from ...roofline import kernels as work
from ...roofline.counting import report
from .. import cuda_lib
from ..dispatch import abstract, use_kernel
from .ref import (
    first_dead_row,
    flash_attention_bwd_ref,
    flash_attention_fwd_lse_ref,
    flash_attention_ref,
    padded_key_count,
)

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [_P] * 6 + [_I] * 12 + [ctypes.c_float, _I, _P, _I]
_BWD_ARGTYPES = [_P] * 10 + [_I] * 11 + [ctypes.c_float] * 2 + [_I, _P, _I]
MAX_HEAD_DIM = 256


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    q_offset: int = 0, kv_len: int | None = None):
    """q [B,Sq,H,D], k/v [B,Skv,KV,D] -> [B,Sq,H,D] (see ``ref.py`` for
    the masks)."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return _FlashAttention.apply(q, k, v, bool(causal), int(window), int(q_offset),
                                     None if kv_len is None else int(kv_len))
    if not (abstract(q) or use_kernel(q)):
        return flash_attention_ref(q, k, v, causal=causal, window=window,
                                   q_offset=q_offset, kv_len=kv_len)
    return _launch(q, k, v, causal, window, q_offset, kv_len, with_lse=False)[0]


def _launch(q, k, v, causal, window, q_offset, kv_len, *, with_lse: bool):
    """The forward kernel (on ``meta``, its stand-in); returns (out, lse
    [B,Sq,H] f32 or None)."""
    B, Sq, H, D = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    dev = q.device
    kv_len = Skv if kv_len is None else int(kv_len)
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"flash_attention: q has dtype {q.dtype}; the kernel takes bf16 or f32")
    # bf16 copies 16-byte rows of 8 values, f32 reads float4s
    multiple = 8 if q.dtype == torch.bfloat16 else 4
    if D % multiple or D > MAX_HEAD_DIM or H % KV:
        raise ValueError(
            f"flash_attention: the kernel takes head_dim % {multiple} == 0 ({q.dtype}), "
            f"head_dim <= {MAX_HEAD_DIM} and H % KV == 0, got D={D}, H={H}, KV={KV}"
        )
    if not 0 <= kv_len <= Skv:
        raise ValueError(f"flash_attention: kv_len {kv_len} outside [0, {Skv}]")
    if q_offset < 0:
        raise ValueError(f"flash_attention: q_offset {q_offset} < 0 (positions start at 0)")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    out = torch.empty_like(q)
    lse = torch.empty((B, Sq, H), dtype=torch.float32, device=dev) if with_lse else None
    # rows that see no key get the mean of V over the reference's padded
    # key slots, from a [B, KV, D] f32 scratch the kernel fills first
    dead_row = first_dead_row(Sq, int(window), int(q_offset), kv_len)
    vmean = (torch.empty((B, KV, D), dtype=torch.float32, device=dev)
             if dead_row < Sq and Skv else None)
    report("flash_attention", work.flash_attention, B, Sq, Skv, H, KV, D, q.dtype, causal=causal,
           window=window, q_offset=q_offset, kv_len=kv_len, with_lse=with_lse)
    if q.is_meta:
        return out, lse
    cuda_lib.require("flash_attention", "q", q, q.dtype, (B, Sq, H, D), dev)
    cuda_lib.require("flash_attention", "k", k, q.dtype, (B, Skv, KV, D), dev)
    cuda_lib.require("flash_attention", "v", v, q.dtype, (B, Skv, KV, D), dev)
    fn = cuda_lib.function("repro_flash_attention", _ARGTYPES)
    code = fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        None if lse is None else lse.data_ptr(), None if vmean is None else vmean.data_ptr(),
        B, Sq, Skv, H, KV, D, int(causal), int(window), int(q_offset), kv_len,
        dead_row if vmean is not None else Sq, padded_key_count(Skv) if Skv else 0,
        1.0 / (D ** 0.5), int(q.dtype == torch.bfloat16), *cuda_lib.stream_args(dev),
    )
    cuda_lib.check_launch("flash_attention", code)
    flash_attention.launches += 1
    return out, lse


class _FlashAttention(torch.autograd.Function):
    """Attention, differentiable: saves (q, k, v, out, lse) and recomputes
    the score tiles in the backward."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: int, q_offset: int, kv_len: int | None):
        if abstract(q) or use_kernel(q):
            out, lse = _launch(q, k, v, causal, window, q_offset, kv_len, with_lse=True)
        else:
            out, lse = flash_attention_fwd_lse_ref(q, k, v, causal=causal, window=window,
                                                   q_offset=q_offset, kv_len=kv_len)
            lse = lse.reshape(q.shape[:3])
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.masks = dict(causal=causal, window=window, q_offset=q_offset, kv_len=kv_len)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, dout, **ctx.masks)
        return dq, dk, dv, None, None, None, None


def flash_attention_bwd(q, k, v, out, lse, dout, *, causal: bool = True, window: int = 0,
                        q_offset: int = 0, kv_len: int | None = None):
    """The gradients (dq, dk, dv) of attention (query i at position
    ``q_offset + i`` against the first ``kv_len`` keys, all when None), in
    the dtypes of q, k and v, from the forward's ``out`` and ``lse``
    [B,Sq,H] f32 and the output's gradient ``dout``."""
    if q_offset < 0:
        raise ValueError(f"flash_attention_bwd: q_offset {q_offset} < 0 (positions start at 0)")
    if not (abstract(q) or use_kernel(q)):
        return flash_attention_bwd_ref(q, k, v, out, lse, dout, causal=causal, window=window,
                                       q_offset=q_offset, kv_len=kv_len)
    B, Sq, H, D = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    dev = q.device
    kv_len = Skv if kv_len is None else int(kv_len)
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"flash_attention_bwd: q has dtype {q.dtype}; the kernels take bf16 or f32")
    # bf16 tiles are copied in 16-byte rows of 8 values, as the forward's
    multiple = 8 if q.dtype == torch.bfloat16 else 1
    if D % multiple or D > MAX_HEAD_DIM or H % KV:
        raise ValueError(f"flash_attention_bwd: the kernels take head_dim % {multiple} == 0 "
                         f"({q.dtype}), head_dim <= {MAX_HEAD_DIM} and H % KV == 0, got D={D}, "
                         f"H={H}, KV={KV}")
    if not 0 <= kv_len <= Skv:
        raise ValueError(f"flash_attention_bwd: kv_len {kv_len} outside [0, {Skv}]")
    q, k, v, out, dout = (x.contiguous() for x in (q, k, v, out, dout))
    lse = lse.contiguous()
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if min(Sq, Skv) == 0:   # no pair to differentiate: nothing to launch
        return dq.zero_(), dk.zero_(), dv.zero_()
    delta = torch.empty((B, Sq, H), dtype=torch.float32, device=dev)   # rowsum(dO * O)
    report("flash_attention_bwd", work.flash_attention_bwd, B, Sq, Skv, H, KV, D, q.dtype,
           causal=causal, window=window, q_offset=q_offset, kv_len=kv_len)
    if q.is_meta:
        return dq, dk, dv
    for name, x, shape in (("q", q, (B, Sq, H, D)), ("k", k, (B, Skv, KV, D)),
                           ("v", v, (B, Skv, KV, D)), ("out", out, (B, Sq, H, D)),
                           ("dout", dout, (B, Sq, H, D))):
        cuda_lib.require("flash_attention_bwd", name, x, q.dtype, shape, dev)
    cuda_lib.require("flash_attention_bwd", "lse", lse, torch.float32, (B, Sq, H), dev)
    fn = cuda_lib.function("repro_flash_attention_bwd", _BWD_ARGTYPES)
    code = fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), dout.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        B, Sq, Skv, H, KV, D, int(causal), int(window), int(q_offset), kv_len,
        first_dead_row(Sq, int(window), int(q_offset), kv_len), 1.0 / (D ** 0.5),
        1.0 / padded_key_count(Skv), int(q.dtype == torch.bfloat16), *cuda_lib.stream_args(dev),
    )
    cuda_lib.check_launch("flash_attention_bwd", code)
    flash_attention_bwd.launches += 1
    return dq, dk, dv


flash_attention.launches = 0
flash_attention_bwd.launches = 0

__all__ = ["flash_attention", "flash_attention_bwd"]
