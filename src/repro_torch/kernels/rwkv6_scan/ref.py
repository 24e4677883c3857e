"""Plain PyTorch versions of the RWKV-6 (Finch) WKV recurrence.

Per head (head_dim = N), with receptance r_t, key k_t, value v_t in R^N,
data-dependent decay w_t in (0,1)^N and bonus u in R^N:

    S_t   = diag(w_t) . S_{t-1} + k_t^T v_t          (S in R^{N x N})
    out_t = r_t . (S_{t-1} + diag(u) . k_t^T v_t)

Three functions, as in ``repro.kernels.rwkv6_scan``:

* ``rwkv6_ref``: the sequential oracle, one step per token in f32;
* ``rwkv6_chunked_ref``: the chunked form that the TPU kernel and the
  CUDA kernel (``csrc/rwkv6_scan.cu``) compute, chunk by chunk with the
  ``[N, N]`` state carried between chunks, with the same clamp
  (``LOG_W_MIN``) and the same order of operations; the plain version
  the wrapper runs for CPU tensors;
* ``rwkv6_decode_step``: one token for serving (plain torch on every
  device: the JAX package has no kernel for it either).

Shapes: r/k/v/w [B, S, H, N]; u [H, N]; state [B, H, N, N] f32
(rows = key dim, cols = value dim).
"""
from __future__ import annotations

import torch

LOG_W_MIN = -5.0


def rwkv6_ref(r, k, v, w, u, state0=None):
    """Sequential recurrence; returns (out [B,S,H,N] in r's dtype,
    state [B,H,N,N] f32)."""
    B, S, H, N = r.shape
    f32 = torch.float32
    rf, kf, vf, wf = (x.to(f32) for x in (r, k, v, w))
    uf = u.to(f32)
    state = (torch.zeros((B, H, N, N), dtype=f32, device=r.device)
             if state0 is None else state0.to(f32))
    outs = []
    for t in range(S):
        kv = kf[:, t, :, :, None] * vf[:, t, :, None, :]          # [B,H,N,N]
        outs.append(torch.einsum("bhn,bhnm->bhm", rf[:, t], state + uf[None, :, :, None] * kv))
        state = wf[:, t, :, :, None] * state + kv
    out = torch.stack(outs, dim=1) if outs else rf.new_zeros((B, 0, H, N))
    return out.to(r.dtype), state


def rwkv6_chunked_ref(r, k, v, w, u, state0, *, chunk: int):
    """The chunked scan over ``S`` divisible by ``C = min(chunk, S)``:

        E_j   = prod_{t<j} w_t                    (exclusive cumprod)
        out_j = (r_j . E_j) S_in
              + [(r.E) (k/E')^T  o  mask_strict + diag(r.(u.k))] V
        S_out = diag(E_C) S_in + (k/E' . E_C)^T V

    with E'_i = E_{i+1}, every log-decay clamped at ``LOG_W_MIN`` and
    everything f32 inside the chunk. Returns (out, state) as
    ``rwkv6_ref``."""
    B, S, H, N = r.shape
    C = min(chunk, S)
    if S % C:
        raise ValueError(f"seq {S} must be divisible by chunk {C}")
    n_chunks = S // C
    f32 = torch.float32
    dev = r.device

    def to_chunks(x):  # [B,S,H,N] -> [n, B, H, C, N]
        return x.to(f32).reshape(B, n_chunks, C, H, N).permute(1, 0, 3, 2, 4)

    rc, kc, vc, wc = map(to_chunks, (r, k, v, w))
    uf = u.to(f32)
    tri_excl = torch.tril(torch.ones((C, C), dtype=f32, device=dev), diagonal=-1)
    mask_strict = tri_excl.bool()
    state = state0.to(f32)
    outs = []
    for c in range(n_chunks):
        r_, k_, v_, w_ = rc[c], kc[c], vc[c], wc[c]                  # [B,H,C,N]
        logw = torch.clamp_min(torch.log(torch.clamp_min(w_, 1e-30)), LOG_W_MIN)
        Lx = torch.einsum("ij,bhjn->bhin", tri_excl, logw)           # exclusive cumsum
        Li = Lx + logw                                               # inclusive
        E = torch.exp(Lx)                                            # prod_{t<j} w_t
        Etot = torch.exp(Li[..., -1:, :])                            # [B,H,1,N]
        q_ = r_ * E
        k_div = k_ * torch.exp(-Li)                                  # k / E'
        A = torch.einsum("bhin,bhjn->bhij", q_, k_div)
        A = torch.where(mask_strict, A, 0.0)
        d = torch.einsum("bhin,hn->bhi", r_ * k_, uf)                # bonus-u diagonal
        outs.append(
            torch.einsum("bhin,bhnm->bhim", q_, state)
            + torch.einsum("bhij,bhjn->bhin", A, v_)
            + d[..., None] * v_
        )
        k_carry = k_div * Etot                                       # k . E_C/E'
        state = Etot[..., 0, :, None] * state + torch.einsum("bhin,bhim->bhnm", k_carry, v_)
    out = torch.stack(outs, 0).permute(1, 0, 3, 2, 4).reshape(B, S, H, N)
    return out.to(r.dtype), state


def rwkv6_decode_step(r, k, v, w, u, state):
    """Single-token recurrence for serving. r/k/v/w: [B, H, N]; state
    [B, H, N, N] f32. Returns (out [B,H,N] in r's dtype, new state)."""
    f32 = torch.float32
    rf, kf, vf, wf = (x.to(f32) for x in (r, k, v, w))
    uf = u.to(f32)
    kv = kf[..., :, None] * vf[..., None, :]
    out = torch.einsum("bhn,bhnm->bhm", rf, state + uf[None, :, :, None] * kv)
    state_new = wf[..., :, None] * state + kv
    return out.to(r.dtype), state_new


__all__ = ["LOG_W_MIN", "rwkv6_ref", "rwkv6_chunked_ref", "rwkv6_decode_step"]
