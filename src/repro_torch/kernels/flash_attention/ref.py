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
  scores, ``acc / max(l, 1e-30)``, K/V padded to whole blocks and the
  pad masked), the plain version the wrapper runs for CPU tensors. The
  query is cast to f32 and then scaled by
  ``1/sqrt(D)``, as the TPU kernel does (``kernel.py:68``) and as the
  CUDA kernel (``csrc/flash_attention.cu``) does. The JAX package's
  ``q_offset``/``kv_len`` path scales in the input dtype first; in f32
  the two agree exactly, in bf16 they differ by the rounding of
  ``q * scale`` in bf16 (within the bf16 tolerance, 2e-2).
* ``flash_attention_fwd_lse_ref``: the training forward, a copy of the
  JAX package's ``_forward_with_lse`` (``ref.py:157``): the same scan
  over key blocks of ``min(1024, Skv)``, K/V padded with zeros to a
  whole block and the pad masked, returning the output and the
  log-sum-exp of each row, ``lse [B, Sq, KV, G]`` f32. With a
  ``q_offset`` or a ``kv_len`` it is the JAX package's
  ``_flash_attention_scan`` (the same blocks and masks).
* ``flash_attention_bwd_ref``: the backward, a copy of
  ``_flash_backward`` (``ref.py:201``): ``D = rowsum(dO * O)``, then one
  pass over the same key blocks that recomputes the scores from
  ``(q, k, lse)``, accumulates ``dQ`` and returns each block's ``dK`` and
  ``dV``. It is the plain version of ``csrc/flash_attention_bwd.cu``.
  A row that sees no key (``first_dead_row``) is the forward's uniform
  average over its ``padded_key_count`` slots (every score ``NEG_INF``):
  it adds ``dO / L`` to every key's ``dV`` and nothing to ``dQ`` or
  ``dK``, as ``jax.vjp`` of the scan gives.
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
    """q [B,Sq,H,D], k/v [B,Skv,KV,D] -> [B,Sq,H,D] in q's dtype: the scan
    of ``flash_attention_fwd_lse_ref`` over whole key blocks (the pad
    masked), as the JAX package's scan walks them, so a row that sees no
    key is the mean of V over the ``padded_key_count`` slots."""
    B, Sq, H, D = q.shape
    _, Skv, KV, Dk = k.shape
    if Dk != D or H % KV:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} vs k {tuple(k.shape)}")
    return flash_attention_fwd_lse_ref(q, k, v, causal=causal, window=window, q_offset=q_offset,
                                       kv_len=kv_len, block_k=block_k)[0]


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


def padded_key_count(Skv: int, block_k: int = 1024) -> int:
    """L: the key slots the plain forward walks, ``Skv`` padded to whole
    blocks of ``min(block_k, Skv)`` (``Skv >= 1``)."""
    block_k = min(block_k, Skv)
    return -(-Skv // block_k) * block_k


def first_dead_row(Sq: int, window: int, q_offset: int, kv_len: int) -> int:
    """The first query row that sees no key (``Sq``: every row sees one),
    for ``q_offset >= 0``: the rows that see none are all of them when
    ``kv_len == 0``, else those whose position reaches ``kv_len + window
    - 1`` under a window (the causal mask never empties a row)."""
    if kv_len == 0:
        return 0
    if window > 0:
        return min(Sq, max(0, kv_len + window - 1 - q_offset))
    return Sq


def flash_attention_fwd_lse_ref(q, k, v, *, causal: bool = True, window: int = 0,
                                q_offset: int = 0, kv_len: int | None = None,
                                block_k: int = 1024):
    """The training forward: (out [B,Sq,H,D] in q's dtype, lse [B,Sq,KV,G]
    f32), query i at position ``q_offset + i`` against the first
    ``kv_len`` (all ``Skv`` when None) keys."""
    B, Sq, H, D = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    G = H // KV
    kv_len = Skv if kv_len is None else int(kv_len)
    kp, vp, block_k = _padded_blocks(k, v, block_k)
    f32 = torch.float32
    dev = q.device
    scale = 1.0 / (D ** 0.5)
    qf = (q.to(f32) * scale).reshape(B, Sq, KV, G, D)
    q_pos = int(q_offset) + torch.arange(Sq, device=dev)
    m = torch.full((B, Sq, KV, G), NEG_INF, dtype=f32, device=dev)
    l = torch.zeros((B, Sq, KV, G), dtype=f32, device=dev)
    acc = torch.zeros((B, Sq, KV, G, D), dtype=f32, device=dev)
    for start in range(0, kp.shape[1], block_k):
        kblk = kp[:, start:start + block_k].to(f32)
        vblk = vp[:, start:start + block_k].to(f32)
        k_pos = start + torch.arange(block_k, device=dev)
        s = torch.einsum("bqkgd,bckd->bqkgc", qf, kblk)
        ok = _visible(q_pos, k_pos, causal, window, kv_len)
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
                            q_offset: int = 0, kv_len: int | None = None, block_k: int = 1024):
    """The backward of ``flash_attention_fwd_lse_ref``: (dq, dk, dv) in the
    dtypes of q, k and v, from the forward's ``out`` and ``lse``
    ([B,Sq,KV,G] or [B,Sq,H] f32) and the output's gradient ``dout``."""
    B, Sq, H, D = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    G = H // KV
    kv_len = Skv if kv_len is None else int(kv_len)
    kp, vp, block_k = _padded_blocks(k, v, block_k)
    f32 = torch.float32
    dev = q.device
    scale = 1.0 / (D ** 0.5)
    lse = lse.reshape(B, Sq, KV, G)
    qf = q.to(f32).reshape(B, Sq, KV, G, D)
    do = dout.to(f32).reshape(B, Sq, KV, G, D)
    of = out.to(f32).reshape(B, Sq, KV, G, D)
    D_term = torch.sum(do * of, dim=-1)                          # [B,Sq,KV,G]
    q_pos = int(q_offset) + torch.arange(Sq, device=dev)
    # rows that see no key: weight 1 / L on every slot in the forward
    dead = ~_visible(q_pos, torch.arange(Skv, device=dev), causal, window, kv_len).any(dim=1)
    uniform = dead.to(f32)[None, :, None, None, None] / kp.shape[1] if bool(dead.any()) else None
    dq = torch.zeros((B, Sq, KV, G, D), dtype=f32, device=dev)
    dks, dvs = [], []
    for start in range(0, kp.shape[1], block_k):
        kblk = kp[:, start:start + block_k].to(f32)
        vblk = vp[:, start:start + block_k].to(f32)
        k_pos = start + torch.arange(block_k, device=dev)
        s = torch.einsum("bqkgd,bckd->bqkgc", qf * scale, kblk)
        ok = _visible(q_pos, k_pos, causal, window, kv_len)[None, :, None, None, :]
        p = torch.where(ok, torch.exp(s - lse[..., None]), 0.0)   # [B,Sq,KV,G,C]
        p_v = p if uniform is None else p + uniform
        dvs.append(torch.einsum("bqkgc,bqkgd->bckd", p_v, do))
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


__all__ = ["NEG_INF", "first_dead_row", "flash_attention_bwd_ref", "flash_attention_fwd_lse_ref",
           "flash_attention_ref", "mha_reference", "padded_key_count"]
