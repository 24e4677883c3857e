"""Serve step factories, generic over the architecture zoo: the serving
half of ``repro.runtime.steps``.

``model_init`` draws an architecture's parameters (``encdec_init`` for
the audio family, ``lm_init`` for the others) on CUDA unless the caller
asks for the CPU; ``make_serve_steps`` returns its prefill and decode
functions. Training (``loss_fn``, ``make_train_step``) waits for
ROADMAP queue 1, item 15 (c), and raises.
"""
from __future__ import annotations

from ..models import encdec as ed
from ..models import lm
from ..models.common import ModelConfig


def model_init(cfg: ModelConfig, seed: int = 0, *, device="cuda"):
    if cfg.family == "audio":
        return ed.encdec_init(cfg, seed, device=device)
    return lm.lm_init(cfg, seed, device=device)


def loss_fn(cfg: ModelConfig, params, batch, vocab_chunk: int = 512):
    raise NotImplementedError("loss_fn (training) waits for ROADMAP queue 1, item 15 (c)")


def make_train_step(cfg: ModelConfig, opt_cfg=None, microbatches: int = 1):
    raise NotImplementedError("make_train_step (training and the optimisers) waits for "
                              "ROADMAP queue 1, item 15 (c)")


def make_serve_steps(cfg: ModelConfig):
    """Returns (prefill_fn(params, batch, max_len), decode_fn(params,
    caches, token, pos)) for the architecture."""
    if cfg.family == "audio":
        def prefill(params, batch, max_len):
            return ed.encdec_prefill(cfg, params, batch, max_dec=max_len)

        def decode(params, caches, token, pos):
            return ed.encdec_decode_step(cfg, params, caches, token, pos)
    else:
        def prefill(params, batch, max_len):
            return lm.lm_prefill(cfg, params, batch, max_len=max_len)

        def decode(params, caches, token, pos):
            return lm.lm_decode_step(cfg, params, caches, token, pos)

    return prefill, decode


def init_serve_caches(cfg: ModelConfig, batch: int, max_len: int, device):
    if cfg.family == "audio":
        raise NotImplementedError(
            "whisper caches come from encdec_prefill (they embed cross-KV)"
        )
    return lm.init_caches(cfg, batch, max_len, device)


__all__ = [
    "model_init",
    "loss_fn",
    "make_train_step",
    "make_serve_steps",
    "init_serve_caches",
]
