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
* ``ssm_scan_bwd_ref``: the VJP of the scan, as the reverse pass that
  the backward kernels (``csrc/ssm_scan_bwd.cu``) compute, token by
  token; the backward the wrapper runs for CPU tensors.
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


def ssm_scan_bwd_ref(x, dt, A, B, C, D, h0, dy, dh):
    """The gradients of ``ssm_scan_ref``'s (y, h) with respect to (x, dt,
    A, B, C, D, h0), given their cotangents ``dy`` [B,S,dim] and ``dh``
    [B,dim,N] (either may be None: zeros; h0 None: zeros). Any S.
    Returns (dx, ddt, dA, dB, dC, dD, dh0), each in its input's dtype
    (dh0 f32).

    The states h_0 .. h_{S-1} first (the forward), then the tokens in
    reverse with g_t, the cotangent of h_t:

        g_t    = dy_t C_t + a_{t+1} g_{t+1}      (g_{S-1} = dy C + dh)
        dx_t   = sum_n g_t dt_t B_t + D dy_t,    dB_t = sum_d g_t dt_t x_t
        ddt_t  = sum_n g_t (h_{t-1} a_t A + x_t B_t)
        dC_t   = sum_d dy_t h_t,                 dA  += g_t h_{t-1} a_t dt_t
        dD    += dy_t x_t,                       dh0  = a_0 g_0

    with a_t = exp(A dt_t): every h_{t-1} is kept from the forward, never
    recovered by dividing by a_t (which underflows)."""
    Bsz, S, dim = x.shape
    N = A.shape[1]
    f32 = torch.float32
    xf, dtf, Bf, Cf = (t.to(f32) for t in (x, dt, B, C))
    Af, Df = A.to(f32), D.to(f32)
    dyf = torch.zeros_like(xf) if dy is None else dy.to(f32)
    h = (torch.zeros((Bsz, dim, N), dtype=f32, device=x.device)
         if h0 is None else h0.to(f32))
    hs = [h]                                                 # h_{-1}, h_0, .., h_{S-1}
    for t in range(S):
        hs.append(_step(hs[-1], xf[:, t], dtf[:, t], Af, Bf[:, t], Cf[:, t], Df)[0])
    g_next = (torch.zeros((Bsz, dim, N), dtype=f32, device=x.device) if dh is None
              else dh.to(f32))                               # a_{t+1} g_{t+1}, then dh
    dx, ddt, dB, dC = (torch.zeros_like(t) for t in (xf, dtf, Bf, Cf))
    dA = torch.zeros_like(Af)
    dD = torch.zeros_like(Df)
    for t in reversed(range(S)):
        a = torch.exp(Af[None] * dtf[:, t, :, None])         # [B,dim,N]
        g = dyf[:, t, :, None] * Cf[:, t, None, :] + g_next
        dC[:, t] = torch.einsum("bd,bdn->bn", dyf[:, t], hs[t + 1])
        dB[:, t] = torch.einsum("bdn,bd->bn", g, dtf[:, t] * xf[:, t])
        da = g * hs[t] * a                                   # d(A dt_t)
        ddt[:, t] = (da * Af[None]).sum(-1) + xf[:, t] * (g * Bf[:, t, None, :]).sum(-1)
        dx[:, t] = dtf[:, t] * (g * Bf[:, t, None, :]).sum(-1) + Df[None] * dyf[:, t]
        dA = dA + (da * dtf[:, t, :, None]).sum(0)
        dD = dD + (dyf[:, t] * xf[:, t]).sum(0)
        g_next = a * g
    return (dx.to(x.dtype), ddt.to(dt.dtype), dA.to(A.dtype), dB.to(B.dtype), dC.to(C.dtype),
            dD.to(D.dtype), g_next)


def ssm_decode_step(x, dt, A, B, C, D, h):
    """One-token update. x/dt [B,dim]; B/C [B,N]; h [B,dim,N] f32.
    Returns (y [B,dim] in x's dtype, new h)."""
    f32 = torch.float32
    xf, dtf, Bf, Cf = (t.to(f32) for t in (x, dt, B, C))
    h, y = _step(h, xf, dtf, A.to(f32), Bf, Cf, D.to(f32))
    return y.to(x.dtype), h


__all__ = ["ssm_decode_step", "ssm_scan_bwd_ref", "ssm_scan_ref"]
