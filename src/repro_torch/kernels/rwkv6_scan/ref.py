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
* ``rwkv6_scan_bwd_ref``: the VJP of the chunked form, as the reverse
  pass that the backward kernels (``csrc/rwkv6_scan_bwd.cu``) compute,
  chunk by chunk; the backward the wrapper runs for CPU tensors;
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


def _to_chunks(x, n_chunks: int, C: int):
    """[B, S, H, N] -> [n, B, H, C, N] in f32."""
    B, S, H, N = x.shape
    return x.to(torch.float32).reshape(B, n_chunks, C, H, N).permute(1, 0, 3, 2, 4)


def _chunk_terms(r_, k_, w_, tri_excl):
    """One chunk's decay terms, [B, H, C, N] each but ``Etot`` [B, H, 1, N]:
    the inclusive cumsum Li of the clamped log decay, E = exp(Lx) (Lx
    the exclusive cumsum), E_C, r E and k / E'."""
    logw = torch.clamp_min(torch.log(torch.clamp_min(w_, 1e-30)), LOG_W_MIN)
    Lx = torch.einsum("ij,bhjn->bhin", tri_excl, logw)           # exclusive cumsum
    Li = Lx + logw                                               # inclusive
    E = torch.exp(Lx)                                            # prod_{t<j} w_t
    Etot = torch.exp(Li[..., -1:, :])                            # [B,H,1,N]
    return Li, E, Etot, r_ * E, k_ * torch.exp(-Li)              # q_ = r E, k / E'


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
    rc, kc, vc, wc = (_to_chunks(x, n_chunks, C) for x in (r, k, v, w))
    uf = u.to(f32)
    tri_excl = torch.tril(torch.ones((C, C), dtype=f32, device=r.device), diagonal=-1)
    mask_strict = tri_excl.bool()
    state = state0.to(f32)
    outs = []
    for c in range(n_chunks):
        r_, k_, v_, w_ = rc[c], kc[c], vc[c], wc[c]                  # [B,H,C,N]
        _, _, Etot, q_, k_div = _chunk_terms(r_, k_, w_, tri_excl)
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


def rwkv6_scan_bwd_ref(r, k, v, w, u, state0, dout, dstate, *, chunk: int):
    """The gradients of ``rwkv6_chunked_ref``'s (out, state) with respect
    to (r, k, v, w, u, state0), given their cotangents ``dout`` [B,S,H,N]
    and ``dstate`` [B,H,N,N] (either may be None: zeros). Returns (dr,
    dk, dv, dw, du, dstate0), each in its input's dtype (dstate0 f32).

    The forward's input state of every chunk first (the forward carry),
    then the chunks in reverse, given S_in, dS_out (the state's
    cotangent after the chunk) and dO:

        dA     = (dO V^T) o mask_strict,           dd = rowsum(dO . V)
        d(rE)  = dO S_in^T + dA (k/E')
        d(k/E')= dA^T (r E) + (V dS_out^T) . E_C
        dV     = A^T dO + diag(d) dO + (k/E' . E_C) dS_out
        dr     = d(rE) . E + dd (k . u),   dk = d(k/E') / E' + dd (r . u)
        du    += sum_i dd_i (r . k)_i
        dS_in  = diag(E_C) dS_out + (r E)^T dO

    and the log decay's: dLx = d(rE) . (rE), dLi = -d(k/E') . (k/E'),
    plus dE_C . E_C on the last row, where dE_C = colsum(d(k/E'.E_C) .
    k/E') + rowsum(dS_out . S_in); dlogw_t = sum_{i>t} (dLx_i + dLi_i)
    + dLi_t. The clamps pass the gradient as ``clamp_min`` does:
    dw = dlogw / w where log max(w, 1e-30) >= LOG_W_MIN, else 0."""
    B, S, H, N = r.shape
    C = min(chunk, S)
    if S % C:
        raise ValueError(f"seq {S} must be divisible by chunk {C}")
    n_chunks = S // C
    f32 = torch.float32
    dev = r.device
    rc, kc, vc, wc = (_to_chunks(x, n_chunks, C) for x in (r, k, v, w))
    doc = (torch.zeros_like(rc) if dout is None else _to_chunks(dout, n_chunks, C))
    uf = u.to(f32)
    tri_excl = torch.tril(torch.ones((C, C), dtype=f32, device=dev), diagonal=-1)
    mask_strict = tri_excl.bool()
    # the forward carry: the input state of every chunk
    states = [state0.to(f32)]
    for c in range(n_chunks - 1):
        _, _, Etot, _, k_div = _chunk_terms(rc[c], kc[c], wc[c], tri_excl)
        states.append(Etot[..., 0, :, None] * states[-1]
                      + torch.einsum("bhin,bhim->bhnm", k_div * Etot, vc[c]))
    dS = (torch.zeros((B, H, N, N), dtype=f32, device=dev) if dstate is None
          else dstate.to(f32))
    du = torch.zeros((H, N), dtype=f32, device=dev)
    grads = [[None] * n_chunks for _ in range(4)]       # dr, dk, dv, dw by chunk
    for c in reversed(range(n_chunks)):
        r_, k_, v_, w_, do = rc[c], kc[c], vc[c], wc[c], doc[c]
        S_in, dS_out = states[c], dS
        Li, E, Etot, q_, k_div = _chunk_terms(r_, k_, w_, tri_excl)
        k_carry = k_div * Etot
        A = torch.where(mask_strict, torch.einsum("bhin,bhjn->bhij", q_, k_div), 0.0)
        d = torch.einsum("bhin,hn->bhi", r_ * k_, uf)
        dA = torch.where(mask_strict, torch.einsum("bhim,bhjm->bhij", do, v_), 0.0)
        dd = (do * v_).sum(-1)                                       # [B,H,C]
        dq = (torch.einsum("bhim,bhnm->bhin", do, S_in)
              + torch.einsum("bhij,bhjn->bhin", dA, k_div))
        dkc = torch.einsum("bhjm,bhnm->bhjn", v_, dS_out)            # d(k/E' . E_C)
        dkd = torch.einsum("bhij,bhin->bhjn", dA, q_) + dkc * Etot
        dv = (torch.einsum("bhij,bhim->bhjm", A, do) + d[..., None] * do
              + torch.einsum("bhjn,bhnm->bhjm", k_carry, dS_out))
        dEtot = (dkc * k_div).sum(-2) + (dS_out * S_in).sum(-1)      # [B,H,N]
        ddu = dd[..., None] * uf[None, :, None, :]
        grads[0][c] = dq * E + ddu * k_
        grads[1][c] = dkd * torch.exp(-Li) + ddu * r_
        grads[2][c] = dv
        du = du + torch.einsum("bhi,bhin->hn", dd, r_ * k_)
        dLi = -dkd * k_div
        dLi[..., -1, :] += dEtot * Etot[..., 0, :]
        step = dq * q_ + dLi                                         # dLx + dLi
        # sum_{i>t} step_i: the reverse inclusive cumsum, shifted by one row
        after = torch.flip(torch.cumsum(torch.flip(step, [-2]), -2), [-2])
        after = torch.cat([after[..., 1:, :], torch.zeros_like(after[..., :1, :])], -2)
        raw = torch.log(torch.clamp_min(w_, 1e-30))
        grads[3][c] = torch.where(raw >= LOG_W_MIN, (after + dLi) / w_, 0.0)
        dS = Etot[..., 0, :, None] * dS_out + torch.einsum("bhin,bhim->bhnm", q_, do)

    def from_chunks(parts, like):   # [n, B, H, C, N] -> [B, S, H, N] in like's dtype
        x = torch.stack(parts, 0).permute(1, 0, 3, 2, 4).reshape(B, S, H, N)
        return x.to(like.dtype)

    return (from_chunks(grads[0], r), from_chunks(grads[1], k), from_chunks(grads[2], v),
            from_chunks(grads[3], w), du.to(u.dtype), dS)


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


__all__ = ["LOG_W_MIN", "rwkv6_ref", "rwkv6_chunked_ref", "rwkv6_decode_step",
           "rwkv6_scan_bwd_ref"]
