"""GQA attention block: projections + RoPE + flash attention + KV cache.

A port of ``repro.models.attention``: MQA (granite kv=1), MHA (phi3
kv=32), GQA (everything else), sliding-window local layers with a
ring-buffer cache (gemma3 5:1 local:global), non-causal encoder
attention and cross-attention (whisper), and one-token decode against a
cache. Every multi-token call goes to ``kernels.flash_attention`` (the
CUDA kernel for CUDA tensors): the cache-free call over the K/V in
flight (the encoder's, non-causal), the full-sequence prefill of a
ring-cache layer, the prefill of a plain-cache layer against its cache
with ``q_offset``/``kv_len``, and every cross-attention call, one-token
decode included. One-token decode against a self-attention cache is
``decode_attention``, a plain masked einsum, as in the JAX package.

Caches are updated in place (the JAX package returns new arrays): a
cache belongs to its caller, and writing into it saves a copy of every
layer's cache per step.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..kernels.flash_attention import NEG_INF, flash_attention
from .common import ModelConfig, dense_init, rotary


def attn_init(cfg: ModelConfig, gen: torch.Generator) -> dict:
    d, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    dt = cfg.param_dtype
    return {
        "wq": dense_init(gen, (d, H, hd), d, dt),
        "wk": dense_init(gen, (d, KV, hd), d, dt),
        "wv": dense_init(gen, (d, KV, hd), d, dt),
        "wo": dense_init(gen, (H, hd, d), H * hd, dt),
    }


def cross_attn_init(cfg: ModelConfig, gen: torch.Generator) -> dict:
    return attn_init(cfg, gen)


class KVCache(NamedTuple):
    k: torch.Tensor  # [B, S_max, KV, hd]
    v: torch.Tensor


def init_kv_cache(cfg: ModelConfig, batch: int, max_len: int, device) -> KVCache:
    shape = (batch, max_len, cfg.n_kv_heads, cfg.hd)
    return KVCache(
        k=torch.zeros(shape, dtype=cfg.compute_dtype, device=device),
        v=torch.zeros(shape, dtype=cfg.compute_dtype, device=device),
    )


def attn_apply(
    cfg: ModelConfig,
    p,
    x: torch.Tensor,                   # [B, S, d]
    *,
    positions: torch.Tensor,           # [S] int
    window: int = 0,
    causal: bool = True,
    use_rope: bool = True,
    cache: KVCache | None = None,
    cache_index: int = 0,              # tokens already in the cache
    kv_override: tuple | None = None,  # (k, v) for cross-attention
):
    """Returns (y [B,S,d], cache). With ``cache`` and no ``kv_override``
    the fresh K/V are written into the cache in place (causal, as in the
    JAX package); otherwise the call attends over the K/V in flight (or
    ``kv_override``'s) and returns no cache."""
    q = torch.einsum("bsd,dhn->bshn", x, p["wq"])
    if kv_override is None:
        k = torch.einsum("bsd,dkn->bskn", x, p["wk"])
        v = torch.einsum("bsd,dkn->bskn", x, p["wv"])
        if use_rope:
            k = rotary(k, positions, cfg.rope_theta)
    else:
        k, v = kv_override
    if use_rope:
        q = rotary(q, positions, cfg.rope_theta)

    if cache is None or kv_override is not None:
        y = flash_attention(q, k, v, causal=causal, window=window)
        return torch.einsum("bshn,hnd->bsd", y, p["wo"]), None

    S = x.shape[1]
    idx = int(cache_index)
    if window > 0 and cache.k.shape[1] == window:
        return _ring_cache_attend(p, q, k, v, cache, idx, S, window)
    # plain cache: write the fresh K/V at cache_index
    cache.k[:, idx:idx + S] = k.to(cache.k.dtype)
    cache.v[:, idx:idx + S] = v.to(cache.v.dtype)
    kv_len = idx + S
    if S == 1:
        y = decode_attention(q, cache.k, cache.v, kv_len=kv_len, window=window, q_pos=idx)
    else:
        y = flash_attention(q, cache.k, cache.v, causal=causal, window=window,
                            q_offset=idx, kv_len=kv_len)
    return torch.einsum("bshn,hnd->bsd", y, p["wo"]), cache


def _ring_cache_attend(p, q, k, v, cache, idx, S, window):
    """Sliding-window layer with a ring-buffer cache of `window` slots.
    Slot j holds position p_j = idx' - ((idx' - j) mod W) for the newest
    idx'; masking by p_j >= 0 covers the not-yet-full phase, and every
    resident position is inside the window by construction."""
    W = window
    if S == 1:
        slot = idx % W
        cache.k[:, slot:slot + 1] = k.to(cache.k.dtype)
        cache.v[:, slot:slot + 1] = v.to(cache.v.dtype)
        j = torch.arange(W, device=q.device)
        slot_pos = idx - torch.remainder(idx - j, W)          # in (idx-W, idx]
        y = decode_attention(q, cache.k, cache.v, kv_len=idx + 1, window=W, q_pos=idx,
                             slot_pos=slot_pos)
        return torch.einsum("bshn,hnd->bsd", y, p["wo"]), cache
    # prefill (from position 0, as in the JAX package): attend over the
    # in-flight K/V, then retire only the last `window` positions
    y = flash_attention(q, k, v, causal=True, window=W)
    start = max(S - W, 0)
    slots = torch.arange(start, S, device=q.device) % W
    cache.k[:, slots] = k[:, start:].to(cache.k.dtype)
    cache.v[:, slots] = v[:, start:].to(cache.v.dtype)
    return torch.einsum("bshn,hnd->bsd", y, p["wo"]), cache


def decode_attention(q, k, v, *, kv_len, window=0, q_pos=0, slot_pos=None):
    """Single-query attention over a KV cache: q [B,1,H,D]; k/v
    [B,S,KV,D]. Softmax over the full S with masking by kv_len (and the
    sliding window); `slot_pos` gives the position of each cache slot
    (ring buffers). Plain max-subtracted softmax in f32."""
    B, _, H, D = q.shape
    _, Skv, KV, _ = k.shape
    G = H // KV
    qf = q.reshape(B, KV, G, D).to(torch.float32)
    s = torch.einsum("bkgd,bskd->bkgs", qf, k.to(torch.float32)) / (D ** 0.5)
    if slot_pos is None:
        pos = torch.arange(Skv, device=q.device)
        ok = pos < kv_len
        if window > 0:
            ok = ok & (pos > q_pos - window)
    else:
        ok = (slot_pos >= 0) & (slot_pos <= q_pos)
    s = torch.where(ok[None, None, None, :], s, NEG_INF)
    m = torch.amax(s, dim=-1, keepdim=True)
    pr = torch.exp(s - m)
    denom = torch.sum(pr, dim=-1, keepdim=True)
    out = torch.einsum("bkgs,bskd->bkgd", pr / torch.clamp_min(denom, 1e-30), v.to(torch.float32))
    return out.reshape(B, 1, H, D).to(q.dtype)


def encode_kv(cfg: ModelConfig, p, enc_out: torch.Tensor):
    """Cross-attention K/V of the encoder output (whisper): [B, S_enc,
    KV, hd] each, no rotary."""
    k = torch.einsum("bsd,dkn->bskn", enc_out, p["wk"])
    v = torch.einsum("bsd,dkn->bskn", enc_out, p["wv"])
    return k, v


__all__ = [
    "KVCache",
    "attn_apply",
    "attn_init",
    "cross_attn_init",
    "decode_attention",
    "encode_kv",
    "init_kv_cache",
]
