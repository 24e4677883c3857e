"""Layer assembly: (norm + mixer + norm + mlp) per LayerSpec.

A port of ``repro.models.blocks``. A ``Block`` is one layer of the
stack, an ``nn.Module`` holding its spec and its parameters under the
JAX package's names: ``n1``, ``n2`` and one group per part (``rwkv``, or
``attn`` and ``mlp``). Mixer kinds: ``attn`` and ``rwkv`` (which
handles its own channel mix and norms); MLP kind: ``dense``. The
``mamba`` mixer and the ``moe`` / ``moe_dense`` MLPs raise
``NotImplementedError``: they wait for ROADMAP queue 1, item 15.
"""
from __future__ import annotations

from typing import Mapping

import torch
from torch import nn

from .attention import attn_apply, attn_init, init_kv_cache
from .common import LayerSpec, ModelConfig, rms_norm
from .mlp import mlp_apply, mlp_init
from .rwkv import init_rwkv_state, rwkv_apply, rwkv_decode, rwkv_init

LATER = "ROADMAP queue 1, item 15"


def check_spec(spec: LayerSpec) -> None:
    """Raise for a layer kind this slice does not port."""
    if spec.kind == "mamba" or spec.mlp in ("moe", "moe_dense"):
        raise NotImplementedError(
            f"{spec.kind} mixer with {spec.mlp} MLP: mamba and MoE layers wait for {LATER}"
        )
    if spec.kind not in ("attn", "rwkv"):
        raise ValueError(f"unknown mixer kind {spec.kind!r}")
    if spec.mlp != "dense":
        raise ValueError(f"unknown MLP kind {spec.mlp!r}")


def _frozen(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


class Block(nn.Module):
    """One layer: ``spec`` and the tensors of ``params`` (a mapping with
    the JAX package's names: ``n1``, ``n2``, and a mapping of tensors
    per part)."""

    def __init__(self, spec: LayerSpec, params: Mapping):
        super().__init__()
        check_spec(spec)
        self.spec = spec
        self.n1 = _frozen(params["n1"])
        self.n2 = _frozen(params["n2"])
        parts = ("rwkv",) if spec.kind == "rwkv" else ("attn", "mlp")
        for part in parts:
            setattr(self, part, nn.ParameterDict(
                {name: _frozen(t) for name, t in params[part].items()}
            ))


def block_init(cfg: ModelConfig, spec: LayerSpec, gen: torch.Generator) -> Block:
    check_spec(spec)
    zeros = lambda: torch.zeros((cfg.d_model,), dtype=torch.float32, device=gen.device)
    params = {"n1": zeros(), "n2": zeros()}
    if spec.kind == "rwkv":
        params["rwkv"] = rwkv_init(cfg, gen)
    else:
        params["attn"] = attn_init(cfg, gen)
        params["mlp"] = mlp_init(cfg, gen)
    return Block(spec, params)


def init_block_cache(cfg: ModelConfig, spec: LayerSpec, batch: int, max_len: int, device):
    check_spec(spec)
    if spec.kind == "attn":
        # sliding-window layers keep a ring buffer of `window` slots
        eff = min(max_len, spec.window) if spec.window > 0 else max_len
        return init_kv_cache(cfg, batch, eff, device)
    return init_rwkv_state(cfg, batch, device)


def block_apply(
    cfg: ModelConfig,
    block: Block,
    x: torch.Tensor,
    *,
    positions: torch.Tensor,
    mode: str,                 # "prefill" | "decode"
    cache,
    cache_index: int = 0,
):
    """Returns (x, new_cache)."""
    spec = block.spec
    if spec.kind == "rwkv":
        if mode == "decode":
            return rwkv_decode(cfg, block.rwkv, x, block.n1, block.n2, cache)
        return rwkv_apply(cfg, block.rwkv, x, block.n1, block.n2, cache)

    h = rms_norm(x, block.n1, cfg.norm_eps)
    y, new_cache = attn_apply(cfg, block.attn, h, positions=positions, window=spec.window,
                              cache=cache, cache_index=cache_index)
    x = x + y
    h2 = rms_norm(x, block.n2, cfg.norm_eps)
    return x + mlp_apply(block.mlp, h2), new_cache


__all__ = ["Block", "block_apply", "block_init", "check_spec", "init_block_cache"]
