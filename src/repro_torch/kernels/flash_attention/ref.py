"""Plain PyTorch versions of flash attention (GQA + causal + sliding
window + query offset + key length).

Shapes: q [B, Sq, H, D]; k, v [B, Skv, KV, D]; H = KV * G (GQA), query
head h reads key/value head h // G. Query i sits at position
``q_offset + i``; key j is visible to it iff ``j < kv_len`` (all of
``Skv`` when ``kv_len`` is None), ``j <= q_offset + i`` (causal) and
``j > q_offset + i - window`` (``window > 0``, gemma3-style local
layers).

* ``flash_attention_ref``: the online-softmax scan over key blocks of
  ``repro.kernels.flash_attention.ref`` (``NEG_INF = -1e30`` for masked
  scores, ``acc / max(l, 1e-30)``), the plain version the wrapper runs
  for CPU tensors. The query is cast to f32 and then scaled by
  ``1/sqrt(D)``, as the TPU kernel does (``kernel.py:68``) and as the
  CUDA kernel (``csrc/flash_attention.cu``) does. The JAX package's
  ``q_offset``/``kv_len`` path scales in the input dtype first; in f32
  the two agree exactly, in bf16 they differ by the rounding of
  ``q * scale`` in bf16 (within the bf16 tolerance, 2e-2).
* ``flash_attention_fwd_lse_ref``: the training forward, a copy of the
  JAX package's ``_forward_with_lse`` (``ref.py:157``): the same scan
  over key blocks of ``min(1024, Skv)``, K/V padded with zeros to a
  whole block and the pad masked, returning the output and the
  log-sum-exp of each row, ``lse [B, Sq, KV, G]`` f32.
* ``flash_attention_bwd_ref``: the backward, a copy of
  ``_flash_backward`` (``ref.py:201``): ``D = rowsum(dO * O)``, then one
  pass over the same key blocks that recomputes the scores from
  ``(q, k, lse)``, accumulates ``dQ`` and returns each block's ``dK`` and
  ``dV``. It is the plain version of ``csrc/flash_attention_bwd.cu``.
* ``mha_reference``: naive softmax attention, for small-shape tests.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def _visible(q_pos, k_pos, causal: bool, window: int, kv_len: int):
    ok = (k_pos < kv_len)[None, :].expand(q_pos.shape[0], k_pos.shape[0])
    if causal:
        ok = ok & (k_pos[None, :] <= q_pos[:, None])
    if window > 0:
        ok = ok & (k_pos[None, :] > q_pos[:, None] - window)
    return ok


def flash_attention_ref(
    q, k, v, *, causal: bool = True, window: int = 0, q_offset: int = 0,
    kv_len: int | None = None, block_k: int = 1024,
):
    """q [B,Sq,H,D], k/v [B,Skv,KV,D] -> [B,Sq,H,D] in q's dtype."""
    B, Sq, H, D = q.shape
    _, Skv, KV, Dk = k.shape
    if Dk != D or H % KV:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} vs k {tuple(k.shape)}")
    G = H // KV
    kv_len = Skv if kv_len is None else int(kv_len)
    block_k = min(block_k, Skv)
    f32 = torch.float32
    dev = q.device
    scale = 1.0 / (D ** 0.5)
    qf = (q.to(f32) * scale).reshape(B, Sq, KV, G, D)
    q_pos = int(q_offset) + torch.arange(Sq, device=dev)

    m = torch.full((B, Sq, KV, G), NEG_INF, dtype=f32, device=dev)
    l = torch.zeros((B, Sq, KV, G), dtype=f32, device=dev)
    acc = torch.zeros((B, Sq, KV, G, D), dtype=f32, device=dev)
    for start in range(0, Skv, block_k):
        kblk = k[:, start:start + block_k].to(f32)
        vblk = v[:, start:start + block_k].to(f32)
        k_pos = start + torch.arange(kblk.shape[1], device=dev)
        s = torch.einsum("bqkgd,bckd->bqkgc", qf, kblk)
        ok = _visible(q_pos, k_pos, causal, window, kv_len)
        s = torch.where(ok[None, :, None, None, :], s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bqkgc,bckd->bqkgd", p, vblk)
        m = m_new
    out = acc / torch.clamp_min(l[..., None], 1e-30)
    return out.reshape(B, Sq, H, D).to(q.dtype)


def _padded_blocks(k, v, block_k: int):
    """K/V padded with zeros to whole blocks of ``min(block_k, Skv)``,
    and the block length."""
    Skv = k.shape[1]
    block_k = min(block_k, Skv)
    pad = -Skv % block_k
    if pad:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
    return k, v, block_k


def flash_attention_fwd_lse_ref(q, k, v, *, causal: bool = True, window: int = 0,
                                block_k: int = 1024):
    """The training forward: (out [B,Sq,H,D] in q's dtype, lse [B,Sq,KV,G]
    f32), queries from position 0 against all ``Skv`` keys."""
    B, Sq, H, D = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    G = H // KV
    kp, vp, block_k = _padded_blocks(k, v, block_k)
    f32 = torch.float32
    dev = q.device
    scale = 1.0 / (D ** 0.5)
    qf = (q.to(f32) * scale).reshape(B, Sq, KV, G, D)
    q_pos = torch.arange(Sq, device=dev)
    m = torch.full((B, Sq, KV, G), NEG_INF, dtype=f32, device=dev)
    l = torch.zeros((B, Sq, KV, G), dtype=f32, device=dev)
    acc = torch.zeros((B, Sq, KV, G, D), dtype=f32, device=dev)
    for start in range(0, kp.shape[1], block_k):
        kblk = kp[:, start:start + block_k].to(f32)
        vblk = vp[:, start:start + block_k].to(f32)
        k_pos = start + torch.arange(block_k, device=dev)
        s = torch.einsum("bqkgd,bckd->bqkgc", qf, kblk)
        ok = _visible(q_pos, k_pos, causal, window, Skv)
        s = torch.where(ok[None, :, None, None, :], s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bqkgc,bckd->bqkgd", p, vblk)
        m = m_new
    lse = m + torch.log(torch.clamp_min(l, 1e-30))
    out = (acc / torch.clamp_min(l[..., None], 1e-30)).reshape(B, Sq, H, D)
    return out.to(q.dtype), lse


def flash_attention_bwd_ref(q, k, v, out, lse, dout, *, causal: bool = True, window: int = 0,
                            block_k: int = 1024):
    """The backward of ``flash_attention_fwd_lse_ref``: (dq, dk, dv) in the
    dtypes of q, k and v, from the forward's ``out`` and ``lse``
    ([B,Sq,KV,G] or [B,Sq,H] f32) and the output's gradient ``dout``."""
    B, Sq, H, D = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    G = H // KV
    kp, vp, block_k = _padded_blocks(k, v, block_k)
    f32 = torch.float32
    dev = q.device
    scale = 1.0 / (D ** 0.5)
    lse = lse.reshape(B, Sq, KV, G)
    qf = q.to(f32).reshape(B, Sq, KV, G, D)
    do = dout.to(f32).reshape(B, Sq, KV, G, D)
    of = out.to(f32).reshape(B, Sq, KV, G, D)
    D_term = torch.sum(do * of, dim=-1)                          # [B,Sq,KV,G]
    q_pos = torch.arange(Sq, device=dev)
    dq = torch.zeros((B, Sq, KV, G, D), dtype=f32, device=dev)
    dks, dvs = [], []
    for start in range(0, kp.shape[1], block_k):
        kblk = kp[:, start:start + block_k].to(f32)
        vblk = vp[:, start:start + block_k].to(f32)
        k_pos = start + torch.arange(block_k, device=dev)
        s = torch.einsum("bqkgd,bckd->bqkgc", qf * scale, kblk)
        ok = _visible(q_pos, k_pos, causal, window, Skv)
        s = torch.where(ok[None, :, None, None, :], s, NEG_INF)
        p = torch.exp(s - lse[..., None])                         # [B,Sq,KV,G,C]
        dvs.append(torch.einsum("bqkgc,bqkgd->bckd", p, do))
        dp = torch.einsum("bqkgd,bckd->bqkgc", do, vblk)
        ds = p * (dp - D_term[..., None]) * scale
        dq = dq + torch.einsum("bqkgc,bckd->bqkgd", ds, kblk)
        dks.append(torch.einsum("bqkgc,bqkgd->bckd", ds, qf))
    dk = torch.cat(dks, dim=1)[:, :Skv]
    dv = torch.cat(dvs, dim=1)[:, :Skv]
    return dq.reshape(B, Sq, H, D).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def mha_reference(q, k, v, *, causal=True, window=0, q_offset=0, kv_len=None):
    """Naive O(S^2)-memory reference (small-shape tests only)."""
    B, Sq, H, D = q.shape
    _, Skv, KV, _ = k.shape
    G = H // KV
    kx = torch.repeat_interleave(k, G, dim=2).to(torch.float32)
    vx = torch.repeat_interleave(v, G, dim=2).to(torch.float32)
    s = torch.einsum("bqhd,bkhd->bhqk", q.to(torch.float32), kx) / (D ** 0.5)
    q_pos = int(q_offset) + torch.arange(Sq, device=q.device)
    k_pos = torch.arange(Skv, device=q.device)
    ok = _visible(q_pos, k_pos, causal, window, Skv if kv_len is None else int(kv_len))
    s = torch.where(ok[None, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, vx).to(q.dtype)


__all__ = ["NEG_INF", "flash_attention_bwd_ref", "flash_attention_fwd_lse_ref",
           "flash_attention_ref", "mha_reference"]
