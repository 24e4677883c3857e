"""Whisper-style encoder-decoder (audio family), a port of
``repro.models.encdec`` for serving.

The conv frontend is a stub, as in the JAX package: a batch's
``frontend_embeds`` [B, S_enc, VIT_DIM] are the frame embeddings (as if
the two conv-downsampling layers already ran); the transformer backbone
is real. Positions are fixed sinusoidal, computed on the fly; the
encoder's attention is bidirectional, the decoder's causal
self-attention with a cache plus cross-attention over the encoder
output. The encoder, the decoder's prefill and every cross-attention
call (one query a step in decode) go through ``kernels.flash_attention``;
one-token decode against the self-attention cache is the plain
``decode_attention``.

The JAX package stacks the layers on a leading axis and scans over them;
the port keeps one module per layer (``EncDec.enc``, ``EncDec.dec``) and
its caches as one entry per decoder layer. Training: ``encdec_loss`` is
the decoder's next-token cross entropy over ``decode_train``'s causal,
cache-free pass against the encoder output, every encoder and decoder
layer recomputed in the backward unless ``cfg.remat == "none"``, as in
the JAX package. ``encode`` is the serving entry (no grad); the loss
runs ``_encode``.

Shape mapping for the input shapes: seq_len = encoder frame count
(long-form audio), decoder length = max(64, seq_len // 8).
"""
from __future__ import annotations

import math
from typing import Mapping, NamedTuple

import torch
from torch import nn

from ..core.engine import resolve_device
from ..parallel.ctx import constrain, whole
from .attention import attn_apply, attn_init, cross_attn_init, encode_kv, init_kv_cache
from .blocks import _group, _param
from .common import ModelConfig, generator, normal, remat, rms_norm
from .lm import VIT_DIM
from .mlp import mlp_apply, mlp_init

def dec_len(cfg: ModelConfig, s_enc: int) -> int:
    return max(64, s_enc // 8)


def sinusoidal(S: int, d: int, offset: int = 0, device=None) -> torch.Tensor:
    """[S, d] f32: sin then cos of positions ``offset .. offset + S - 1``
    over ``d // 2`` frequencies."""
    pos = (torch.arange(S, device=device) + offset)[:, None].to(torch.float32)
    half = d // 2
    freq = torch.exp(-math.log(10_000.0) * torch.arange(half, dtype=torch.float32, device=device)
                     / max(half - 1, 1))
    ang = pos * freq[None, :]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------
class EncDecLayer(nn.Module):
    """One layer under the JAX package's names: the norms (``n1``,
    ``n2``, and the decoder's ``nc``) as tensors, the attention and MLP
    groups (``attn``; ``self`` and ``cross``; ``mlp``) as parameter
    groups."""

    def __init__(self, params: Mapping):
        super().__init__()
        for name, t in params.items():
            setattr(self, name, _group(t) if isinstance(t, Mapping) else _param(t))


class EncDec(nn.Module):
    """The parameters of the encoder-decoder: ``frontend_proj`` [VIT_DIM,
    d], ``embed`` [V, d], ``enc_norm`` and ``final_norm`` [d], ``head``
    [d, V], and the ``enc`` and ``dec`` layers."""

    def __init__(self, frontend_proj, embed, enc_norm, final_norm, head,
                 enc: list[EncDecLayer], dec: list[EncDecLayer]):
        super().__init__()
        self.frontend_proj = _param(frontend_proj)
        self.embed = _param(embed)
        self.enc_norm = _param(enc_norm)
        self.final_norm = _param(final_norm)
        self.head = _param(head)
        self.enc = nn.ModuleList(enc)
        self.dec = nn.ModuleList(dec)

    @property
    def device(self) -> torch.device:
        return self.embed.device


def _enc_block_init(cfg: ModelConfig, gen: torch.Generator) -> EncDecLayer:
    zero = lambda: torch.zeros((cfg.d_model,), dtype=torch.float32, device=gen.device)  # noqa: E731
    return EncDecLayer({"n1": zero(), "attn": attn_init(cfg, gen), "n2": zero(),
                        "mlp": mlp_init(cfg, gen)})


def _dec_block_init(cfg: ModelConfig, gen: torch.Generator) -> EncDecLayer:
    zero = lambda: torch.zeros((cfg.d_model,), dtype=torch.float32, device=gen.device)  # noqa: E731
    return EncDecLayer({"n1": zero(), "self": attn_init(cfg, gen), "nc": zero(),
                        "cross": cross_attn_init(cfg, gen), "n2": zero(),
                        "mlp": mlp_init(cfg, gen)})


def encdec_init(cfg: ModelConfig, seed: int = 0, *, device="cuda") -> EncDec:
    """Parameters drawn from ``seed`` on ``device`` (CUDA unless the
    caller asks for the CPU), with the scales of the JAX init."""
    if cfg.n_enc_layers <= 0:
        raise ValueError(f"{cfg.name}: an encoder-decoder needs n_enc_layers > 0")
    cfg.validate()
    device = resolve_device(device)
    gen = generator(device, seed)
    d, dt = cfg.d_model, cfg.param_dtype
    frontend_proj = normal(gen, (VIT_DIM, d), 0.02, dt)
    embed = normal(gen, (cfg.vocab, d), 0.02, dt)
    head = normal(gen, (d, cfg.vocab), 0.02, dt)
    norm = lambda: torch.zeros((d,), dtype=torch.float32, device=device)  # noqa: E731
    enc = [_enc_block_init(cfg, gen) for _ in range(cfg.n_enc_layers)]
    dec = [_dec_block_init(cfg, gen) for _ in range(cfg.n_layers)]
    return EncDec(frontend_proj, embed, norm(), norm(), head, enc, dec)


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------
def _enc_layer(cfg: ModelConfig, layer: EncDecLayer, x, positions):
    h = rms_norm(x, layer.n1, cfg.norm_eps)
    y, _ = attn_apply(cfg, layer.attn, h, positions=positions, causal=False, use_rope=False)
    x = x + y
    h2 = rms_norm(x, layer.n2, cfg.norm_eps)
    return x + mlp_apply(layer.mlp, h2)


def _encode(cfg: ModelConfig, params: EncDec, frames: torch.Tensor) -> torch.Tensor:
    B, S, _ = frames.shape
    x = torch.einsum("bsv,vd->bsd", frames.to(cfg.compute_dtype), params.frontend_proj)
    x = x + sinusoidal(S, cfg.d_model, device=x.device)[None].to(x.dtype)
    positions = torch.arange(S, device=x.device)
    for layer in params.enc:
        x = remat(cfg, _enc_layer, cfg, layer, x, positions)
    return rms_norm(x, params.enc_norm, cfg.norm_eps)


@torch.no_grad()
def encode(cfg: ModelConfig, params: EncDec, frames: torch.Tensor) -> torch.Tensor:
    """frames [B, S_enc, VIT_DIM] -> encoder output [B, S_enc, d]."""
    return _encode(cfg, params, frames)


def _dec_layer(cfg: ModelConfig, layer: EncDecLayer, x, positions, cross_kv, *, cache,
               cache_index: int):
    """One decoder layer against its self-attention ``cache`` (written in
    place) and its cross-attention K/V. Returns (x, cache)."""
    h = rms_norm(x, layer.n1, cfg.norm_eps)
    y, cache = attn_apply(cfg, layer.self, h, positions=positions, use_rope=False, cache=cache,
                          cache_index=cache_index)
    x = x + y
    hc = rms_norm(x, layer.nc, cfg.norm_eps)
    yc, _ = attn_apply(cfg, layer.cross, hc, positions=positions, causal=False, use_rope=False,
                       kv_override=cross_kv)
    x = x + yc
    h2 = rms_norm(x, layer.n2, cfg.norm_eps)
    return x + mlp_apply(layer.mlp, h2), cache


def _dec_train_layer(cfg: ModelConfig, layer: EncDecLayer, x, positions, enc_out):
    """One decoder layer of training: causal self-attention over the whole
    sequence (no cache) and cross-attention over ``enc_out``'s K/V."""
    return _dec_layer(cfg, layer, x, positions, encode_kv(cfg, layer.cross, enc_out),
                      cache=None, cache_index=0)[0]


def decode_train(cfg: ModelConfig, params: EncDec, tokens, enc_out):
    """The decoder over all of ``tokens`` [B, S] against ``enc_out``;
    returns the final-normed hidden states [B, S, d]."""
    B, S = tokens.shape
    x = constrain(params.embed[tokens.long()].to(cfg.compute_dtype), "batch seq embed")
    x = x + sinusoidal(S, cfg.d_model, device=x.device)[None].to(x.dtype)
    positions = torch.arange(S, device=x.device)
    for layer in params.dec:
        x = remat(cfg, _dec_train_layer, cfg, layer, x, positions, enc_out)
    return rms_norm(x, params.final_norm, cfg.norm_eps)


def encdec_loss(cfg: ModelConfig, params: EncDec, batch, vocab_chunk: int = 0):
    """Next-token cross entropy of the decoder (labels = tokens shifted
    left, the last position masked) given ``batch["frontend_embeds"]``;
    ``vocab_chunk`` is accepted and unused, as in the JAX package."""
    tokens = batch["tokens"]
    enc_out = _encode(cfg, params, batch["frontend_embeds"])
    h = decode_train(cfg, params, tokens, enc_out)
    logits = whole(torch.einsum("bsd,dv->bsv", h, params.head).to(torch.float32), -1)
    labels = torch.cat([tokens[:, 1:], tokens[:, :1]], dim=1)
    B, S = tokens.shape
    mask = torch.cat([torch.ones((B, S - 1), dtype=torch.float32, device=h.device),
                      torch.zeros((B, 1), dtype=torch.float32, device=h.device)], dim=1)
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    return torch.sum((lse - gold) * mask) / torch.clamp_min(torch.sum(mask), 1.0)


class EncDecCaches(NamedTuple):
    self_kv: list       # one KVCache per decoder layer
    cross_kv: list      # one (k, v) per decoder layer


def _logits(cfg: ModelConfig, params: EncDec, h: torch.Tensor) -> torch.Tensor:
    h = rms_norm(h, params.final_norm, cfg.norm_eps)
    return torch.einsum("bsd,dv->bsv", h, params.head)[:, 0].to(torch.float32)


@torch.no_grad()
def encdec_prefill(cfg: ModelConfig, params: EncDec, batch: dict, max_dec: int):
    """Encode the audio and prefill the decoder with its start tokens.
    Returns (last logits [B, V] f32, caches)."""
    enc_out = encode(cfg, params, batch["frontend_embeds"])
    tokens = batch["tokens"]
    B, S = tokens.shape
    x = constrain(params.embed[tokens.long()].to(cfg.compute_dtype), "batch seq embed")
    x = x + sinusoidal(S, cfg.d_model, device=x.device)[None].to(x.dtype)
    positions = torch.arange(S, device=x.device)
    self_kv, cross_kv = [], []
    for layer in params.dec:
        kv = encode_kv(cfg, layer.cross, enc_out)
        x, cache = _dec_layer(cfg, layer, x, positions, kv,
                              cache=init_kv_cache(cfg, B, max_dec, x.device), cache_index=0)
        self_kv.append(cache)
        cross_kv.append(kv)
    return _logits(cfg, params, x[:, -1:]), EncDecCaches(self_kv, cross_kv)


@torch.no_grad()
def encdec_decode_step(cfg: ModelConfig, params: EncDec, caches: EncDecCaches,
                       token: torch.Tensor, pos: int):
    """One decode step. token [B] int; pos = #tokens already cached.
    Returns (logits [B, V] f32, caches)."""
    x = constrain(params.embed[token[:, None].long()].to(cfg.compute_dtype), "batch seq embed")
    x = x + sinusoidal(1, cfg.d_model, offset=int(pos), device=x.device)[None].to(x.dtype)
    positions = torch.full((1,), int(pos), dtype=torch.int64, device=x.device)
    self_kv = []
    for layer, cache, kv in zip(params.dec, caches.self_kv, caches.cross_kv):
        x, cache = _dec_layer(cfg, layer, x, positions, kv, cache=cache, cache_index=int(pos))
        self_kv.append(cache)
    return _logits(cfg, params, x), EncDecCaches(self_kv, caches.cross_kv)


__all__ = [
    "EncDec",
    "EncDecCaches",
    "EncDecLayer",
    "dec_len",
    "decode_train",
    "encdec_decode_step",
    "encdec_init",
    "encdec_loss",
    "encdec_prefill",
    "encode",
    "sinusoidal",
]
