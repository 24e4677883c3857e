"""``ssm_scan``: the kernel of ``csrc/ssm_scan.cu`` for CUDA tensors, at
their own sequence length (each launch counted in
``ssm_scan.launches``), or ``ref.ssm_scan_ref`` for CPU tensors, whose
chunked form needs the sequence padded to a multiple of the chunk."""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from .. import cuda_lib
from ..dispatch import use_kernel
from .ref import ssm_scan_ref

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [_P] * 9 + [_I] * 5 + [_P, _I]
# state sizes the kernel is built for: 4 states per thread, N / 4
# threads per channel
STATE_SIZES = (4, 8, 16, 32)


def ssm_scan(x, dt, A, B, C, D, h0=None, *, chunk: int = 256):
    """x [B,S,dim] (bf16 or f32), dt [B,S,dim] f32, A [dim,N] f32, B/C
    [B,S,N] in x's dtype, D [dim] f32, h0 [B,dim,N] f32 or None (zeros).
    Returns (y [B,S,dim] in x's dtype, h [B,dim,N] f32). ``chunk`` is
    the plain version's; the kernel takes any S."""
    S = x.shape[1]
    if use_kernel(x):
        return _launch(x, dt, A, B, C, D, h0)
    # pad ragged sequences to a chunk multiple; dt = 0, x = 0 is the
    # identity update (a = exp(0) = 1, b = 0), so the carried state is
    # untouched
    Cn = min(chunk, S)
    pad = (Cn - S % Cn) % Cn if Cn else 0
    if pad:
        def zpad(t):
            return F.pad(t, (0, 0, 0, pad))

        x, dt, B, C = zpad(x), zpad(dt), zpad(B), zpad(C)
    y, h = ssm_scan_ref(x, dt, A, B, C, D, h0, chunk=Cn)
    return (y[:, :S], h) if pad else (y, h)


def _launch(x, dt, A, B, C, D, h0):
    Bsz, S, dim = x.shape
    N = A.shape[1]
    dev = x.device
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"ssm_scan: x has dtype {x.dtype}; the kernel takes bf16 or f32")
    if N not in STATE_SIZES:
        raise ValueError(f"ssm_scan: the kernel takes d_state in {STATE_SIZES}, got {N}")
    for name, t, dtype, shape in (
        ("x", x, x.dtype, (Bsz, S, dim)),
        ("dt", dt, torch.float32, (Bsz, S, dim)),
        ("A", A, torch.float32, (dim, N)),
        ("B", B, x.dtype, (Bsz, S, N)),
        ("C", C, x.dtype, (Bsz, S, N)),
        ("D", D, torch.float32, (dim,)),
        ("h0", h0, torch.float32, (Bsz, dim, N)),
    ):
        if t is not None or name != "h0":    # no h0: the kernel starts from zeros
            cuda_lib.require("ssm_scan", name, t, dtype, shape, dev)
    y = torch.empty_like(x)
    h = torch.empty((Bsz, dim, N), dtype=torch.float32, device=dev)
    fn = cuda_lib.function("repro_ssm_scan", _ARGTYPES)
    code = fn(
        x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(), C.data_ptr(),
        D.data_ptr(), None if h0 is None else h0.data_ptr(), y.data_ptr(), h.data_ptr(),
        Bsz, S, dim, N, int(x.dtype == torch.bfloat16), *cuda_lib.stream_args(dev),
    )
    cuda_lib.check_launch("ssm_scan", code)
    ssm_scan.launches += 1
    return y, h


ssm_scan.launches = 0

__all__ = ["STATE_SIZES", "ssm_scan"]
