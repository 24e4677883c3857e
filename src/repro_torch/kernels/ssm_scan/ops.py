"""``ssm_scan``: the kernel of ``csrc/ssm_scan.cu`` for CUDA tensors, at
their own sequence length (each launch counted in
``ssm_scan.launches``), or ``ref.ssm_scan_ref`` for CPU tensors, whose
chunked form needs the sequence padded to a multiple of the chunk.

With grad enabled and an input that requires grad, the call is
differentiable (``_SSMScan``, one Function on both devices), and the
backward is ``ssm_scan_bwd``: the kernels of ``csrc/ssm_scan_bwd.cu``
for CUDA tensors (each call counted once in ``ssm_scan_bwd.launches``),
``ref.ssm_scan_bwd_ref`` for CPU tensors. The CPU's padding and the
``[:, :S]`` slice stay outside the Function.

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
from .ref import ssm_scan_bwd_ref, ssm_scan_ref

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [_P] * 9 + [_I] * 5 + [_P, _I]
_BWD_ARGTYPES = [_P] * 23 + [_I] * 5 + [_P, _I]
# state sizes the kernel is built for: 4 states per thread, N / 4
# threads per channel
STATE_SIZES = (4, 8, 16, 32)
CHANNELS = 64                        # channels of a backward block
CHUNK = 128                          # tokens of a backward time chunk
SEGMENT = {4: 16, 8: 16, 16: 8, 32: 8}   # tokens between the backward's checkpoints


def ssm_scan(x, dt, A, B, C, D, h0=None, *, chunk: int = 256):
    """x [B,S,dim] (bf16 or f32), dt [B,S,dim] f32, A [dim,N] f32, B/C
    [B,S,N] in x's dtype, D [dim] f32, h0 [B,dim,N] f32 or None (zeros).
    Returns (y [B,S,dim] in x's dtype, h [B,dim,N] f32). ``chunk`` is
    the plain version's; the kernel takes any S."""
    grad = torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in (x, dt, A, B, C, D, h0))
    S = x.shape[1]
    if abstract(x) or use_kernel(x):
        if grad:
            return _SSMScan.apply(x, dt, A, B, C, D, h0, chunk)
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
    if grad:
        y, h = _SSMScan.apply(x, dt, A, B, C, D, h0, Cn)
    else:
        y, h = ssm_scan_ref(x, dt, A, B, C, D, h0, chunk=Cn)
    return (y[:, :S], h) if pad else (y, h)


def _check(kernel: str, x, A) -> None:
    N = A.shape[1]
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"{kernel}: x has dtype {x.dtype}; the kernel takes bf16 or f32")
    if N not in STATE_SIZES:
        raise ValueError(f"{kernel}: the kernel takes d_state in {STATE_SIZES}, got {N}")


def _require(kernel: str, x, dt, A, B, C, D, h0) -> None:
    Bsz, S, dim = x.shape
    N = A.shape[1]
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
            cuda_lib.require(kernel, name, t, dtype, shape, x.device)


def _launch(x, dt, A, B, C, D, h0):
    Bsz, S, dim = x.shape
    N = A.shape[1]
    dev = x.device
    _check("ssm_scan", x, A)
    y = torch.empty_like(x)
    h = torch.empty((Bsz, dim, N), dtype=torch.float32, device=dev)
    report("ssm_scan", work.ssm_scan, Bsz, S, dim, N, x.dtype, with_h0=h0 is not None)
    if x.is_meta:
        return y, h
    _require("ssm_scan", x, dt, A, B, C, D, h0)
    fn = cuda_lib.function("repro_ssm_scan", _ARGTYPES)
    code = fn(
        x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(), C.data_ptr(),
        D.data_ptr(), None if h0 is None else h0.data_ptr(), y.data_ptr(), h.data_ptr(),
        Bsz, S, dim, N, int(x.dtype == torch.bfloat16), *cuda_lib.stream_args(dev),
    )
    cuda_lib.check_launch("ssm_scan", code)
    ssm_scan.launches += 1
    return y, h


class _SSMScan(torch.autograd.Function):
    """The scan, differentiable: saves the inputs and runs
    ``ssm_scan_bwd``, which recomputes the states. Under activation
    checkpointing its forward runs twice, each time on its own saved
    tensors."""

    @staticmethod
    def forward(ctx, x, dt, A, B, C, D, h0, chunk: int):
        if abstract(x) or use_kernel(x):
            y, h = _launch(x, dt, A, B, C, D, h0)
        else:
            y, h = ssm_scan_ref(x, dt, A, B, C, D, h0, chunk=chunk)
        ctx.save_for_backward(x, dt, A, B, C, D, h0)
        return y, h

    @staticmethod
    def backward(ctx, dy, dh):
        grads = ssm_scan_bwd(*ctx.saved_tensors, dy, dh)
        return (*(g if need else None for g, need in zip(grads, ctx.needs_input_grad)), None)


def bwd_scratch_shapes(Bsz: int, S: int, dim: int, N: int) -> dict[str, tuple[int, ...]]:
    """The f32 partials and scratch of ``csrc/ssm_scan_bwd.cu`` for a call
    over ``S`` tokens (any S, the last chunk and segment ragged): per
    (row, time chunk) dA and dD, per block of ``CHANNELS`` channels dB and
    dC, the local state at every segment's start and the sum of dt up to
    it, and each chunk's three terms (local end state, decay product,
    local start cotangent)."""
    n_chunks, n_seg, n_blk = -(-S // CHUNK), -(-S // SEGMENT[N]), -(-dim // CHANNELS)
    terms = (Bsz, n_chunks, dim, N)
    return {"dA_part": terms, "dD_part": (Bsz, n_chunks, dim),
            "dB_part": (Bsz, n_blk, S, N), "dC_part": (Bsz, n_blk, S, N),
            "ckpt": (Bsz, n_seg, dim, N), "cumdt": (Bsz, n_seg, dim),
            "hloc": terms, "prod": terms, "gloc": terms}


def ssm_scan_bwd(x, dt, A, B, C, D, h0, dy, dh):
    """The gradients (dx, ddt, dA, dB, dC, dD, dh0) of the scan over any S,
    each in its input's dtype (dh0 f32), from the cotangents ``dy`` and
    ``dh`` (either None: zeros; h0 None: zeros)."""
    if not (abstract(x) or use_kernel(x)):
        return ssm_scan_bwd_ref(x, dt, A, B, C, D, h0, dy, dh)
    Bsz, S, dim = x.shape
    N = A.shape[1]
    dev = x.device
    _check("ssm_scan_bwd", x, A)
    dy = torch.zeros_like(x) if dy is None else dy.contiguous()
    if dh is not None:
        dh = dh.contiguous()
    f32 = dict(dtype=torch.float32, device=dev)
    dx, ddt = torch.empty_like(x), torch.empty_like(dt)
    dB, dC = torch.empty_like(B), torch.empty_like(C)
    dh0 = torch.empty((Bsz, dim, N), **f32)
    # per-(row, chunk) partials of dA and dD, folded below; scratch
    scratch = {k: torch.empty(shape, **f32)
               for k, shape in bwd_scratch_shapes(Bsz, S, dim, N).items()}
    report("ssm_scan_bwd", work.ssm_scan_bwd, Bsz, S, dim, N, x.dtype, with_h0=h0 is not None,
           with_dh=dh is not None)
    if not x.is_meta:
        _launch_bwd(x, dt, A, B, C, D, h0, dy, dh, dx, ddt, dB, dC, dh0, scratch)
    return (dx, ddt, scratch["dA_part"].sum((0, 1)), dB, dC, scratch["dD_part"].sum((0, 1)),
            dh0)


def _launch_bwd(x, dt, A, B, C, D, h0, dy, dh, dx, ddt, dB, dC, dh0, scratch) -> None:
    Bsz, S, dim = x.shape
    N = A.shape[1]
    dev = x.device
    _require("ssm_scan_bwd", x, dt, A, B, C, D, h0)
    cuda_lib.require("ssm_scan_bwd", "dy", dy, x.dtype, (Bsz, S, dim), dev)
    if dh is not None:
        cuda_lib.require("ssm_scan_bwd", "dh", dh, torch.float32, (Bsz, dim, N), dev)
    fn = cuda_lib.function("repro_ssm_scan_bwd", _BWD_ARGTYPES)
    code = fn(
        x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(), C.data_ptr(), D.data_ptr(),
        None if h0 is None else h0.data_ptr(), dy.data_ptr(),
        None if dh is None else dh.data_ptr(), dx.data_ptr(), ddt.data_ptr(),
        scratch["dA_part"].data_ptr(), dB.data_ptr(), dC.data_ptr(),
        scratch["dD_part"].data_ptr(), dh0.data_ptr(),
        *(scratch[k].data_ptr() for k in ("dB_part", "dC_part", "ckpt", "cumdt", "hloc", "prod",
                                          "gloc")),
        Bsz, S, dim, N, int(x.dtype == torch.bfloat16), *cuda_lib.stream_args(dev),
    )
    cuda_lib.check_launch("ssm_scan_bwd", code)
    ssm_scan_bwd.launches += 1


ssm_scan.launches = 0
ssm_scan_bwd.launches = 0

__all__ = ["STATE_SIZES", "bwd_scratch_shapes", "ssm_scan", "ssm_scan_bwd"]
