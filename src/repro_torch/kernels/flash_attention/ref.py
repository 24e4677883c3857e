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


__all__ = ["NEG_INF", "flash_attention_ref", "mha_reference"]
