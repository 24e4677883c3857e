"""Causal LM (+ VLM variant): init, train loss, prefill, decode.

A port of ``repro.models.lm``. The JAX package scans over stacked
repeats of the layer pattern; the port keeps one ``Block`` module per
layer, layer ``i`` having spec ``cfg.pattern[i % period]``, and caches
as one entry per layer. The vlm and audio families carry the stubbed
frontend's projector ``frontend_proj`` [VIT_DIM, d]: a batch's
``frontend_embeds`` [B, n_img, VIT_DIM] take the first ``n_img``
positions.

``lm_loss`` is the next-token cross entropy of the JAX package: each
layer recomputed in the backward (``torch.utils.checkpoint``) unless
``cfg.remat == "none"``, as the JAX package rematerialises each period,
and the logits taken ``vocab_chunk`` positions at a time, each chunk
recomputed in the backward, so that no [B, S, V] f32 logits are kept.

The entry points run where the parameters live: ``lm_init`` puts them on
CUDA unless the caller asks for the CPU.
"""
from __future__ import annotations

from typing import Sequence

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..core.engine import resolve_device
from ..parallel.ctx import checkpoint_kwargs, constrain, whole
from .blocks import Block, _param, block_apply, block_init, init_block_cache
from .common import ModelConfig, generator, normal, remat, rms_norm


VIT_DIM = 1024  # stubbed vision/audio frontend embedding width


class LM(nn.Module):
    """The parameters of a causal LM: ``embed`` [V, d], ``final_norm``
    [d], ``head`` [d, V] (None with tied embeddings), ``layers`` and
    ``frontend_proj`` [VIT_DIM, d] (None outside the vlm and audio
    families)."""

    def __init__(self, embed: torch.Tensor, final_norm: torch.Tensor,
                 head: torch.Tensor | None, layers: Sequence[Block],
                 frontend_proj: torch.Tensor | None = None):
        super().__init__()
        self.embed = _param(embed)
        self.final_norm = _param(final_norm)
        self.head = None if head is None else _param(head)
        self.frontend_proj = None if frontend_proj is None else _param(frontend_proj)
        self.layers = nn.ModuleList(layers)

    @property
    def device(self) -> torch.device:
        return self.embed.device


def lm_init(cfg: ModelConfig, seed: int = 0, *, device="cuda") -> LM:
    """Parameters drawn from ``seed`` on ``device`` (CUDA unless the
    caller asks for the CPU), with the scales of the JAX init."""
    cfg.validate()
    device = resolve_device(device)
    gen = generator(device, seed)
    embed = normal(gen, (cfg.vocab, cfg.d_model), 0.02, cfg.param_dtype)
    final_norm = torch.zeros((cfg.d_model,), dtype=torch.float32, device=device)
    head = None if cfg.tie_embeddings else normal(gen, (cfg.d_model, cfg.vocab), 0.02, cfg.param_dtype)
    frontend_proj = None
    if cfg.family in ("vlm", "audio"):
        frontend_proj = normal(gen, (VIT_DIM, cfg.d_model), 0.02, cfg.param_dtype)
    layers = [block_init(cfg, cfg.layer_spec(i), gen) for i in range(cfg.n_layers)]
    return LM(embed, final_norm, head, layers, frontend_proj)


def init_caches(cfg: ModelConfig, batch: int, max_len: int, device) -> list:
    """One cache per layer: a ``KVCache`` (ring of ``window`` slots for
    sliding-window layers) or an ``RWKVState``."""
    return [init_block_cache(cfg, cfg.layer_spec(i), batch, max_len, device)
            for i in range(cfg.n_layers)]


def _embed(cfg: ModelConfig, params: LM, batch: dict) -> torch.Tensor:
    x = params.embed[batch["tokens"].long()].to(cfg.compute_dtype)
    if cfg.family in ("vlm", "audio") and "frontend_embeds" in batch:
        fe = torch.einsum("bsv,vd->bsd", batch["frontend_embeds"].to(cfg.compute_dtype),
                          params.frontend_proj)
        n_img = fe.shape[1]
        x = torch.cat([fe, x[:, n_img:]], dim=1)
    return constrain(x, "batch seq embed")


def _stack_apply(cfg: ModelConfig, params: LM, x, *, positions, mode: str, caches=None,
                 cache_index=0):
    """Run every layer. Returns (x, new caches (None in training), the
    MoE load-balance terms summed over all layers, in layer order as the
    JAX package's period scan and tail add them). In training each layer
    is recomputed in the backward (``common.remat``)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device) if mode == "train" else 0.0
    new_caches = []
    for i, block in enumerate(params.layers):
        if mode == "train":
            x, a = remat(cfg, _train_layer, cfg, block, x, positions)
        else:
            x, nc, a = block_apply(cfg, block, x, positions=positions, mode=mode,
                                   cache=caches[i], cache_index=cache_index)
            new_caches.append(nc)
        x = constrain(x, "batch seq embed")
        aux = aux + a
    return x, None if mode == "train" else new_caches, aux


def _train_layer(cfg, block, x, positions):
    x, _, aux = block_apply(cfg, block, x, positions=positions, mode="train")
    return x, aux


def _logits(cfg: ModelConfig, params: LM, h: torch.Tensor) -> torch.Tensor:
    h = rms_norm(h, params.final_norm, cfg.norm_eps)
    w = params.embed.T if cfg.tie_embeddings else params.head
    return torch.einsum("bsd,dv->bsv", h, w)


def _chunk_ce(h, w, labels, mask):
    """Sum of (lse - gold) * mask and of mask over one chunk of positions;
    the bf16 product is cast to f32 afterwards, as in the JAX package."""
    logits = whole(torch.einsum("bsd,dv->bsv", h, w).to(torch.float32), -1)
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    return torch.sum((lse - gold) * mask), torch.sum(mask)


def lm_loss(cfg: ModelConfig, params: LM, batch: dict, *, vocab_chunk: int = 0) -> torch.Tensor:
    """Next-token cross entropy (labels = tokens shifted left, the last
    position masked, ``batch["loss_mask"]`` applied where given), plus
    ``0.01 * aux / (n_moe * n_periods)`` for a model with MoE layers."""
    tokens = batch["tokens"]
    B, S = tokens.shape
    x = _embed(cfg, params, batch)
    positions = torch.arange(S, device=x.device)
    h, _, aux = _stack_apply(cfg, params, x, positions=positions, mode="train")
    h = rms_norm(h, params.final_norm, cfg.norm_eps)
    w = params.embed.T if cfg.tie_embeddings else params.head
    labels = torch.cat([tokens[:, 1:], tokens[:, :1]], dim=1)
    mask = torch.cat([torch.ones((B, S - 1), dtype=torch.float32, device=x.device),
                      torch.zeros((B, 1), dtype=torch.float32, device=x.device)], dim=1)
    if "loss_mask" in batch:
        mask = mask * batch["loss_mask"].to(torch.float32)
    if vocab_chunk and S > vocab_chunk:
        if S % vocab_chunk:
            raise ValueError(f"lm_loss: seq {S} is not a multiple of vocab_chunk {vocab_chunk}")
        tot = cnt = 0.0
        for start in range(0, S, vocab_chunk):
            part = slice(start, start + vocab_chunk)
            s, c = checkpoint(_chunk_ce, h[:, part], w, labels[:, part], mask[:, part],
                              use_reentrant=False, **checkpoint_kwargs())
            tot, cnt = tot + s, cnt + c
    else:
        tot, cnt = _chunk_ce(h, w, labels, mask)
    loss = tot / torch.clamp_min(cnt, 1.0)
    n_moe = sum(s.mlp in ("moe", "moe_dense") for s in cfg.pattern)
    if n_moe:
        loss = loss + 0.01 * aux / max(float(n_moe * max(cfg.n_periods, 1)), 1.0)
    return loss


@torch.no_grad()
def lm_prefill(cfg: ModelConfig, params: LM, batch: dict, max_len: int | None = None):
    """Full-sequence prefill. Returns (last-token logits [B, V], caches)."""
    tokens = batch["tokens"]
    B, S = tokens.shape
    max_len = max_len or S
    x = _embed(cfg, params, batch)
    positions = torch.arange(S, device=x.device)
    caches = init_caches(cfg, B, max_len, x.device)
    h, caches, _ = _stack_apply(cfg, params, x, positions=positions, mode="prefill",
                                caches=caches, cache_index=0)
    logits = _logits(cfg, params, h[:, -1:, :])
    return logits[:, 0, :], caches


@torch.no_grad()
def lm_decode_step(cfg: ModelConfig, params: LM, caches, token: torch.Tensor, pos: int):
    """One decode step. token [B] int; pos = #tokens already cached.
    Returns (logits [B, V], caches)."""
    x = _embed(cfg, params, {"tokens": token[:, None]})
    positions = torch.full((1,), int(pos), dtype=torch.int64, device=x.device)
    h, caches, _ = _stack_apply(cfg, params, x, positions=positions, mode="decode",
                                caches=caches, cache_index=int(pos))
    logits = _logits(cfg, params, h)
    return logits[:, 0, :], caches


__all__ = [
    "LM",
    "VIT_DIM",
    "init_caches",
    "lm_decode_step",
    "lm_init",
    "lm_loss",
    "lm_prefill",
]
