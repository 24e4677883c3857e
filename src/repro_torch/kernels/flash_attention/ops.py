"""``flash_attention``: the kernel of ``csrc/flash_attention.cu`` for CUDA
tensors (each launch counted in ``flash_attention.launches``), for every
call: the full-sequence case and the ``q_offset``/``kv_len`` case of a
prefill against a cache alike. bf16 goes to the tensor-core kernel
(``wgmma``), f32 to the CUDA-core one. ``ref.flash_attention_ref`` for
CPU tensors."""
from __future__ import annotations

import ctypes

import torch

from .. import cuda_lib
from ..dispatch import use_kernel
from .ref import flash_attention_ref

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [_P] * 4 + [_I] * 10 + [ctypes.c_float, _I, _P, _I]
MAX_HEAD_DIM = 256


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    q_offset: int = 0, kv_len: int | None = None):
    """q [B,Sq,H,D], k/v [B,Skv,KV,D] -> [B,Sq,H,D] (see ``ref.py`` for
    the masks)."""
    if not use_kernel(q):
        return flash_attention_ref(q, k, v, causal=causal, window=window,
                                   q_offset=q_offset, kv_len=kv_len)
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
    fn = cuda_lib.function("repro_flash_attention", _ARGTYPES)
    code = fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        B, Sq, Skv, H, KV, D, int(causal), int(window), int(q_offset), kv_len,
        1.0 / (D ** 0.5), int(q.dtype == torch.bfloat16), *cuda_lib.stream_args(dev),
    )
    cuda_lib.check_launch("flash_attention", code)
    flash_attention.launches += 1
    return out


flash_attention.launches = 0

__all__ = ["flash_attention"]
