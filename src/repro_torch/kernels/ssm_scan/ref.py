"""Plain PyTorch versions of the Mamba-1 selective scan.

Discretised SSM, per channel d and state dim n:

    h_t = exp(A[d,n] * dt_t[d]) * h_{t-1} + dt_t[d] * B_t[n] * x_t[d]
    y_t[d] = sum_n C_t[n] * h_t[d,n] + D[d] * x_t[d]

Two functions, as in ``repro.kernels.ssm_scan``:

* ``ssm_scan_ref``: the recurrence token by token inside each chunk,
  with the state carried from chunk to chunk; all math in f32. PyTorch
  has no associative scan, so this is the sequential form of the JAX
  package's oracle (``ref.ssm_scan_ref``) and of its chunked scan
  (``ops._ssm_chunked``); it is the plain version that the wrapper runs
  for CPU tensors and that the CUDA kernel (``csrc/ssm_scan.cu``) is
  held to.
* ``ssm_decode_step``: one token for serving (plain torch on every
  device: the JAX package has no kernel for it either).

Shapes: x, dt [B,S,dim]; A [dim,N]; B, C [B,S,N]; D [dim];
state [B,dim,N] f32.
"""
from __future__ import annotations

import torch


def _step(h, x_t, dt_t, A, B_t, C_t, D):
    """One token in f32: x_t/dt_t [B,dim], B_t/C_t [B,N], h [B,dim,N]."""
    a = torch.exp(A[None] * dt_t[..., None])                 # [B,dim,N]
    b = (dt_t * x_t)[..., None] * B_t[:, None, :]            # [B,dim,N]
    h = a * h + b
    y = torch.einsum("bdn,bn->bd", h, C_t) + D[None] * x_t
    return h, y


def ssm_scan_ref(x, dt, A, B, C, D, h0=None, *, chunk: int = 256):
    """The scan over ``S`` divisible by ``min(chunk, S)``. Returns
    (y [B,S,dim] in x's dtype, h [B,dim,N] f32)."""
    Bsz, S, dim = x.shape
    N = A.shape[1]
    f32 = torch.float32
    Cn = min(chunk, S) if S else 1
    if S % Cn:
        raise ValueError(f"seq {S} must be divisible by chunk {Cn}")
    xf, dtf, Bf, Cf = (t.to(f32) for t in (x, dt, B, C))
    Af, Df = A.to(f32), D.to(f32)
    h = (torch.zeros((Bsz, dim, N), dtype=f32, device=x.device)
         if h0 is None else h0.to(f32))
    ys = []
    for t in range(S):   # chunk after chunk, the state carried across
        h, y = _step(h, xf[:, t], dtf[:, t], Af, Bf[:, t], Cf[:, t], Df)
        ys.append(y)
    y = torch.stack(ys, dim=1) if ys else xf.new_zeros((Bsz, 0, dim))
    return y.to(x.dtype), h


def ssm_decode_step(x, dt, A, B, C, D, h):
    """One-token update. x/dt [B,dim]; B/C [B,N]; h [B,dim,N] f32.
    Returns (y [B,dim] in x's dtype, new h)."""
    f32 = torch.float32
    xf, dtf, Bf, Cf = (t.to(f32) for t in (x, dt, B, C))
    h, y = _step(h, xf, dtf, A.to(f32), Bf, Cf, D.to(f32))
    return y.to(x.dtype), h


__all__ = ["ssm_scan_ref", "ssm_decode_step"]
