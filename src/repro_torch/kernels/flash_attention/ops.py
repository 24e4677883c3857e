"""``flash_attention``: the kernel of ``csrc/flash_attention.cu`` for CUDA
tensors (each launch counted in ``flash_attention.launches``), for every
call: the full-sequence case and the ``q_offset``/``kv_len`` case of a
prefill against a cache alike. bf16 goes to the tensor-core kernel
(``wgmma``), f32 to the CUDA-core one. ``ref.flash_attention_ref`` for
CPU tensors.

With grad enabled and an input that requires grad, the call is
differentiable (``_FlashAttention``), under the conditions of the JAX
package's custom VJP (``q_offset == 0``, ``kv_len`` None): the forward
keeps the log-sum-exp of each row (the kernel's ``lse`` output on CUDA,
``flash_attention_fwd_lse_ref`` on the CPU) and the backward is
``flash_attention_bwd``: the kernels of ``csrc/flash_attention_bwd.cu``
for CUDA tensors (each call counted once in
``flash_attention_bwd.launches``), ``flash_attention_bwd_ref`` for CPU
tensors. Without grad nothing of this runs and no ``lse`` is stored."""
from __future__ import annotations

import ctypes

import torch

from .. import cuda_lib
from ..dispatch import use_kernel
from .ref import flash_attention_bwd_ref, flash_attention_fwd_lse_ref, flash_attention_ref

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [_P] * 5 + [_I] * 10 + [ctypes.c_float, _I, _P, _I]
_BWD_ARGTYPES = [_P] * 10 + [_I] * 8 + [ctypes.c_float, _I, _P, _I]
MAX_HEAD_DIM = 256


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    q_offset: int = 0, kv_len: int | None = None):
    """q [B,Sq,H,D], k/v [B,Skv,KV,D] -> [B,Sq,H,D] (see ``ref.py`` for
    the masks)."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        if q_offset != 0 or kv_len is not None:
            raise NotImplementedError(
                "flash_attention: no gradient through the q_offset / kv_len path (a prefill "
                "against a cache); training attends from position 0 over its own keys")
        return _FlashAttention.apply(q, k, v, bool(causal), int(window))
    if not use_kernel(q):
        return flash_attention_ref(q, k, v, causal=causal, window=window,
                                   q_offset=q_offset, kv_len=kv_len)
    return _launch(q, k, v, causal, window, q_offset, kv_len, with_lse=False)[0]


def _launch(q, k, v, causal, window, q_offset, kv_len, *, with_lse: bool):
    """The forward kernel; returns (out, lse [B,Sq,H] f32 or None)."""
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
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    cuda_lib.require("flash_attention", "q", q, q.dtype, (B, Sq, H, D), dev)
    cuda_lib.require("flash_attention", "k", k, q.dtype, (B, Skv, KV, D), dev)
    cuda_lib.require("flash_attention", "v", v, q.dtype, (B, Skv, KV, D), dev)
    out = torch.empty_like(q)
    lse = torch.empty((B, Sq, H), dtype=torch.float32, device=dev) if with_lse else None
    fn = cuda_lib.function("repro_flash_attention", _ARGTYPES)
    code = fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        None if lse is None else lse.data_ptr(),
        B, Sq, Skv, H, KV, D, int(causal), int(window), int(q_offset), kv_len,
        1.0 / (D ** 0.5), int(q.dtype == torch.bfloat16), *cuda_lib.stream_args(dev),
    )
    cuda_lib.check_launch("flash_attention", code)
    flash_attention.launches += 1
    return out, lse


class _FlashAttention(torch.autograd.Function):
    """Attention from position 0 over all keys, differentiable: saves
    (q, k, v, out, lse) and recomputes the score tiles in the backward."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: int):
        if use_kernel(q):
            out, lse = _launch(q, k, v, causal, window, 0, None, with_lse=True)
        else:
            out, lse = flash_attention_fwd_lse_ref(q, k, v, causal=causal, window=window)
            lse = lse.reshape(q.shape[:3])
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.window = causal, window
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, dout, causal=ctx.causal,
                                         window=ctx.window)
        return dq, dk, dv, None, None


def flash_attention_bwd(q, k, v, out, lse, dout, *, causal: bool = True, window: int = 0):
    """The gradients (dq, dk, dv) of attention from position 0 over all
    keys, in the dtypes of q, k and v, from the forward's ``out`` and
    ``lse`` [B,Sq,H] f32 and the output's gradient ``dout``."""
    if not use_kernel(q):
        return flash_attention_bwd_ref(q, k, v, out, lse, dout, causal=causal, window=window)
    B, Sq, H, D = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    dev = q.device
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"flash_attention_bwd: q has dtype {q.dtype}; the kernels take bf16 or f32")
    if D > MAX_HEAD_DIM or H % KV:
        raise ValueError(f"flash_attention_bwd: the kernels take head_dim <= {MAX_HEAD_DIM} and "
                         f"H % KV == 0, got D={D}, H={H}, KV={KV}")
    q, k, v, out, dout = (x.contiguous() for x in (q, k, v, out, dout))
    for name, x, shape in (("q", q, (B, Sq, H, D)), ("k", k, (B, Skv, KV, D)),
                           ("v", v, (B, Skv, KV, D)), ("out", out, (B, Sq, H, D)),
                           ("dout", dout, (B, Sq, H, D))):
        cuda_lib.require("flash_attention_bwd", name, x, q.dtype, shape, dev)
    lse = lse.contiguous()
    cuda_lib.require("flash_attention_bwd", "lse", lse, torch.float32, (B, Sq, H), dev)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if min(Sq, Skv) == 0:   # no pair to differentiate: nothing to launch
        return dq.zero_(), dk.zero_(), dv.zero_()
    delta = torch.empty((B, Sq, H), dtype=torch.float32, device=dev)   # rowsum(dO * O)
    fn = cuda_lib.function("repro_flash_attention_bwd", _BWD_ARGTYPES)
    code = fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), dout.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        B, Sq, Skv, H, KV, D, int(causal), int(window), 1.0 / (D ** 0.5),
        int(q.dtype == torch.bfloat16), *cuda_lib.stream_args(dev),
    )
    cuda_lib.check_launch("flash_attention_bwd", code)
    flash_attention_bwd.launches += 1
    return dq, dk, dv


flash_attention.launches = 0
flash_attention_bwd.launches = 0

__all__ = ["flash_attention", "flash_attention_bwd"]
