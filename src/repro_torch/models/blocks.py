"""Layer assembly: (norm + mixer + norm + mlp/moe) per LayerSpec.

A port of ``repro.models.blocks``. A ``Block`` is one layer of the
stack, an ``nn.Module`` holding its spec and its parameters under the
JAX package's names: ``n1``, ``n2`` and one group per part: ``rwkv``;
or the mixer (``attn`` or ``mamba``) and the MLP (``mlp``, ``moe``, or
both for ``moe_dense``), with the MoE's ``shared`` expert as a group
nested in ``moe``. Mixer kinds: ``attn``, ``mamba`` and ``rwkv`` (which
handles its own channel mix and norms); MLP kinds: ``dense``, ``moe``
and ``moe_dense`` (arctic's parallel dense residual beside the MoE).
The MoE's auxiliary load-balance loss belongs to training and is not
returned.
"""
from __future__ import annotations

from typing import Mapping

import torch
from torch import nn

from .attention import attn_apply, attn_init, init_kv_cache
from .common import LayerSpec, ModelConfig, rms_norm
from .mlp import mlp_apply, mlp_init, moe_apply, moe_init
from .rwkv import init_rwkv_state, rwkv_apply, rwkv_decode, rwkv_init
from .ssm import init_mamba_state, mamba_apply, mamba_decode, mamba_init

MLP_PARTS = {"dense": ("mlp",), "moe": ("moe",), "moe_dense": ("moe", "mlp")}


def check_spec(spec: LayerSpec) -> None:
    """Raise ``ValueError`` for an unknown mixer or MLP kind."""
    if spec.kind not in ("attn", "mamba", "rwkv"):
        raise ValueError(f"unknown mixer kind {spec.kind!r}")
    if spec.mlp not in MLP_PARTS:
        raise ValueError(f"unknown MLP kind {spec.mlp!r}")


def parts(spec: LayerSpec) -> tuple[str, ...]:
    """The parameter groups of a layer besides its norms."""
    if spec.kind == "rwkv":
        return ("rwkv",)
    return (spec.kind, *MLP_PARTS[spec.mlp])


def _frozen(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


def _group(tensors: Mapping) -> nn.ParameterDict:
    """A parameter group; a nested mapping (the MoE's ``shared``) becomes
    a nested group."""
    return nn.ParameterDict({
        name: _group(t) if isinstance(t, Mapping) else _frozen(t)
        for name, t in tensors.items()
    })


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
        for part in parts(spec):
            setattr(self, part, _group(params[part]))


def block_init(cfg: ModelConfig, spec: LayerSpec, gen: torch.Generator) -> Block:
    check_spec(spec)
    zeros = lambda: torch.zeros((cfg.d_model,), dtype=torch.float32, device=gen.device)
    params = {"n1": zeros(), "n2": zeros()}
    init = {"rwkv": rwkv_init, "attn": attn_init, "mamba": mamba_init,
            "mlp": mlp_init, "moe": moe_init}
    for part in parts(spec):
        params[part] = init[part](cfg, gen)
    return Block(spec, params)


def init_block_cache(cfg: ModelConfig, spec: LayerSpec, batch: int, max_len: int, device):
    check_spec(spec)
    if spec.kind == "attn":
        # sliding-window layers keep a ring buffer of `window` slots
        eff = min(max_len, spec.window) if spec.window > 0 else max_len
        return init_kv_cache(cfg, batch, eff, device)
    if spec.kind == "mamba":
        return init_mamba_state(cfg, batch, device)
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
    if spec.kind == "attn":
        y, new_cache = attn_apply(cfg, block.attn, h, positions=positions, window=spec.window,
                                  cache=cache, cache_index=cache_index)
    elif mode == "decode":
        y, new_cache = mamba_decode(cfg, block.mamba, h, cache)
    else:  # every prefill starts from the zero state, as in the JAX package
        y, new_cache = mamba_apply(cfg, block.mamba, h, None)
    x = x + y
    h2 = rms_norm(x, block.n2, cfg.norm_eps)
    if spec.mlp == "dense":
        return x + mlp_apply(block.mlp, h2), new_cache
    y2 = moe_apply(cfg, block.moe, h2)
    if spec.mlp == "moe":
        return x + y2, new_cache
    return x + y2 + mlp_apply(block.mlp, h2), new_cache  # moe_dense: parallel residual


__all__ = ["Block", "block_apply", "block_init", "check_spec", "init_block_cache"]
