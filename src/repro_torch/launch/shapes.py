"""Assigned input shapes and abstract input specs per (arch x shape), a
port of ``repro.launch.shapes``.

Shapes (LM transformer: seq_len x global_batch):
    train_4k     seq=4096    batch=256   -> train_step
    prefill_32k  seq=32768   batch=32    -> prefill
    decode_32k   seq=32768   batch=128   -> serve_step (1 token, KV=seq)
    long_500k    seq=524288  batch=1     -> serve_step (sub-quadratic only)

``batch_specs`` and ``cache_shapes`` return ``meta`` tensors (shapes and
dtypes, no allocation). The axes helpers give the logical axes of a
batch, of the caches (one entry a layer, as the port keeps them: the
reference's stacked ``layers`` axis dropped) and of the optimizer state,
so that a mesh run can place every tensor.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Mapping

import torch

from ..models import lm
from ..models.attention import KVCache
from ..models.common import ModelConfig
from ..models.encdec import EncDecCaches, dec_len
from ..models.rwkv import RWKVState
from ..models.ssm import MambaState
from ..optim.optimizers import OptState, _factored

META = torch.device("meta")


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str          # "train" | "prefill" | "decode"
    seq: int
    batch: int


SHAPES: dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524_288, 1),
}


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def batch_specs(cfg: ModelConfig, shape: ShapeSpec) -> dict[str, torch.Tensor]:
    """Abstract model inputs for train/prefill of one global batch."""
    B, L = shape.batch, shape.seq
    if cfg.family == "audio":
        return {"frontend_embeds": _meta((B, L, lm.VIT_DIM), torch.bfloat16),
                "tokens": _meta((B, dec_len(cfg, L)), torch.int32)}
    out = {"tokens": _meta((B, L), torch.int32)}
    if cfg.family == "vlm":
        out["frontend_embeds"] = _meta((B, cfg.n_img_tokens, lm.VIT_DIM), torch.bfloat16)
    return out


def batch_axes(cfg: ModelConfig, shape: ShapeSpec) -> dict[str, str]:
    if cfg.family == "audio":
        return {"frontend_embeds": "batch seq state", "tokens": "batch seq"}
    out = {"tokens": "batch seq"}
    if cfg.family == "vlm":
        out["frontend_embeds"] = "batch seq state"
    return out


KV_AXES = "batch kv_seq kv_heads head_dim"


def _block_cache_axes(kind: str):
    if kind == "attn":
        return KVCache(k=KV_AXES, v=KV_AXES)
    if kind == "mamba":
        return MambaState(h="batch ff state", conv="batch conv ff")
    if kind == "rwkv":
        return RWKVState(wkv="batch heads head_dim state", shift_t="batch seq embed",
                         shift_c="batch seq embed")
    raise ValueError(kind)


def cache_axes(cfg: ModelConfig):
    """The caches' logical axes, one entry a layer."""
    if cfg.family == "audio":
        return EncDecCaches(self_kv=[KVCache(k=KV_AXES, v=KV_AXES)] * cfg.n_layers,
                            cross_kv=[(KV_AXES, KV_AXES)] * cfg.n_layers)
    return [_block_cache_axes(cfg.layer_spec(i).kind) for i in range(cfg.n_layers)]


def cache_shapes(cfg: ModelConfig, batch: int, max_len: int):
    """Abstract caches (``meta`` tensors, no allocation)."""
    if cfg.family == "audio":
        KV, hd = cfg.n_kv_heads, cfg.hd
        kv = lambda s: _meta((batch, s, KV, hd), cfg.compute_dtype)  # noqa: E731
        d_dec = dec_len(cfg, max_len)
        return EncDecCaches(self_kv=[KVCache(k=kv(d_dec), v=kv(d_dec)) for _ in range(cfg.n_layers)],
                            cross_kv=[(kv(max_len), kv(max_len)) for _ in range(cfg.n_layers)])
    return lm.init_caches(cfg, batch, max_len, META)


def opt_axes(opt_name: str, param_axes: Mapping[str, str], param_shapes: Mapping[str, Any],
             groups=None):
    """The optimizer state's logical axes, structured as the port's
    ``OptState``: AdamW's moments take their parameters' axes;
    Adafactor's leaves (``groups``: ``runtime.steps.stacked_leaves``, or
    each parameter its own) put ``layers`` before a stacked leaf's axes,
    and a factored leaf's ``vr`` / ``vc`` drop its last / second-to-last."""
    if opt_name == "adamw":
        return OptState(step="", inner={"m": dict(param_axes), "v": dict(param_axes)})
    groups = groups if groups is not None else {n: ([n], False) for n in param_axes}
    inner = {}
    for leaf, (names, stacked) in groups.items():
        shape = tuple(param_shapes[names[0]].shape)
        ax = param_axes[names[0]].split()
        if stacked:
            shape, ax = (len(names),) + shape, ["layers"] + ax
        if _factored(shape):
            inner[leaf] = {"vr": " ".join(ax[:-1]), "vc": " ".join(ax[:-2] + ax[-1:])}
        else:
            inner[leaf] = {"v": " ".join(ax)}
    return OptState(step="", inner=inner)


__all__ = [
    "SHAPES",
    "ShapeSpec",
    "batch_axes",
    "batch_specs",
    "cache_axes",
    "cache_shapes",
    "opt_axes",
]
