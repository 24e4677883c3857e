"""Causal LM: init, prefill, decode.

A port of ``repro.models.lm`` for serving. The JAX package scans over
stacked repeats of the layer pattern; the port keeps one ``Block``
module per layer, layer ``i`` having spec ``cfg.pattern[i % period]``,
and caches as one entry per layer. ``lm_loss`` (training) and the
vlm/audio frontends wait for later slices and raise.

The entry points run where the parameters live: ``lm_init`` puts them on
CUDA unless the caller asks for the CPU.
"""
from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from ..core.engine import resolve_device
from .blocks import Block, block_apply, block_init, init_block_cache
from .common import ModelConfig, normal, rms_norm


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family in ("vlm", "audio"):
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family} frontend waits for ROADMAP queue 1, item 15"
        )


class LM(nn.Module):
    """The parameters of a causal LM: ``embed`` [V, d], ``final_norm``
    [d], ``head`` [d, V] (None with tied embeddings) and ``layers``."""

    def __init__(self, embed: torch.Tensor, final_norm: torch.Tensor,
                 head: torch.Tensor | None, layers: Sequence[Block]):
        super().__init__()
        self.embed = nn.Parameter(embed, requires_grad=False)
        self.final_norm = nn.Parameter(final_norm, requires_grad=False)
        self.head = None if head is None else nn.Parameter(head, requires_grad=False)
        self.layers = nn.ModuleList(layers)

    @property
    def device(self) -> torch.device:
        return self.embed.device


def lm_init(cfg: ModelConfig, seed: int = 0, *, device="cuda") -> LM:
    """Parameters drawn from ``seed`` on ``device`` (CUDA unless the
    caller asks for the CPU), with the scales of the JAX init."""
    cfg.validate()
    _check_family(cfg)
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    embed = normal(gen, (cfg.vocab, cfg.d_model), 0.02, cfg.param_dtype)
    final_norm = torch.zeros((cfg.d_model,), dtype=torch.float32, device=device)
    head = None if cfg.tie_embeddings else normal(gen, (cfg.d_model, cfg.vocab), 0.02, cfg.param_dtype)
    layers = [block_init(cfg, cfg.layer_spec(i), gen) for i in range(cfg.n_layers)]
    return LM(embed, final_norm, head, layers)


def init_caches(cfg: ModelConfig, batch: int, max_len: int, device) -> list:
    """One cache per layer: a ``KVCache`` (ring of ``window`` slots for
    sliding-window layers) or an ``RWKVState``."""
    return [init_block_cache(cfg, cfg.layer_spec(i), batch, max_len, device)
            for i in range(cfg.n_layers)]


def _embed(cfg: ModelConfig, params: LM, batch: dict) -> torch.Tensor:
    if "frontend_embeds" in batch:
        _check_family(cfg)
    return params.embed[batch["tokens"].long()].to(cfg.compute_dtype)


def _stack_apply(cfg: ModelConfig, params: LM, x, *, positions, mode: str, caches, cache_index):
    new_caches = []
    for block, cache in zip(params.layers, caches):
        x, nc = block_apply(cfg, block, x, positions=positions, mode=mode, cache=cache,
                            cache_index=cache_index)
        new_caches.append(nc)
    return x, new_caches


def _logits(cfg: ModelConfig, params: LM, h: torch.Tensor) -> torch.Tensor:
    h = rms_norm(h, params.final_norm, cfg.norm_eps)
    w = params.embed.T if cfg.tie_embeddings else params.head
    return torch.einsum("bsd,dv->bsv", h, w)


def lm_loss(cfg: ModelConfig, params: LM, batch: dict, **_):
    raise NotImplementedError("lm_loss (training) waits for ROADMAP queue 1, item 15")


@torch.no_grad()
def lm_prefill(cfg: ModelConfig, params: LM, batch: dict, max_len: int | None = None):
    """Full-sequence prefill. Returns (last-token logits [B, V], caches)."""
    tokens = batch["tokens"]
    B, S = tokens.shape
    max_len = max_len or S
    x = _embed(cfg, params, batch)
    positions = torch.arange(S, device=x.device)
    caches = init_caches(cfg, B, max_len, x.device)
    h, caches = _stack_apply(cfg, params, x, positions=positions, mode="prefill",
                             caches=caches, cache_index=0)
    logits = _logits(cfg, params, h[:, -1:, :])
    return logits[:, 0, :], caches


@torch.no_grad()
def lm_decode_step(cfg: ModelConfig, params: LM, caches, token: torch.Tensor, pos: int):
    """One decode step. token [B] int; pos = #tokens already cached.
    Returns (logits [B, V], caches)."""
    x = _embed(cfg, params, {"tokens": token[:, None]})
    positions = torch.full((1,), int(pos), dtype=torch.int64, device=x.device)
    h, caches = _stack_apply(cfg, params, x, positions=positions, mode="decode",
                             caches=caches, cache_index=int(pos))
    logits = _logits(cfg, params, h)
    return logits[:, 0, :], caches


__all__ = [
    "LM",
    "init_caches",
    "lm_decode_step",
    "lm_init",
    "lm_loss",
    "lm_prefill",
]
