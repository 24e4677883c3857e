"""Model configuration and the shared building blocks of the LM substrate.

A copy of ``repro.models.common`` for PyTorch: the same ``LayerSpec``
pattern (a short tuple of per-layer specs that repeats over the depth),
the same ``ModelConfig`` fields, except ``attn_impl`` (the kernel is
chosen by the device of the data alone, ``kernels/dispatch.py``); dtypes
are ``torch`` dtypes. ``remat`` other than ``"none"`` recomputes each
layer in the backward (``"full"`` and ``"dots"`` alike: the port keeps
no saved products).

Initialisation draws from an explicit ``torch.Generator`` with the
scales of the JAX init (``dense_init`` 1/sqrt(fan_in), embeddings 0.02);
the draws match the JAX package's in distribution only.
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..parallel.ctx import checkpoint_kwargs


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    """One position inside the repeating layer pattern."""

    kind: str = "attn"          # "attn" | "mamba" | "rwkv"
    mlp: str = "dense"          # "dense" | "moe" | "moe_dense" (parallel both)
    window: int = 0             # 0 = global attention; >0 = sliding window


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int = 0
    top_k: int = 1
    expert_ff: int = 0
    shared_expert_ff: int = 0   # 0 = no shared expert
    capacity_factor: float = 1.25
    router_jitter: float = 0.0


@dataclasses.dataclass(frozen=True)
class MambaConfig:
    d_state: int = 16
    conv_k: int = 4
    expand: int = 2
    dt_rank: int = 0            # 0 -> ceil(d_model / 16)
    chunk: int = 256            # scan chunk length (memory/compute knob)


@dataclasses.dataclass(frozen=True)
class RWKVConfig:
    head_dim: int = 64
    chunk: int = 32             # chunked-scan length (numerics knob)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str = "model"
    family: str = "lm"          # lm | moe | ssm | hybrid | vlm | audio
    n_layers: int = 2
    d_model: int = 256
    n_heads: int = 4
    n_kv_heads: int = 4
    head_dim: int = 0           # 0 -> d_model // n_heads
    d_ff: int = 1024
    vocab: int = 1024
    pattern: tuple[LayerSpec, ...] = (LayerSpec(),)
    moe: MoEConfig = MoEConfig()
    mamba: MambaConfig = MambaConfig()
    rwkv: RWKVConfig = RWKVConfig()
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-6
    mlp_type: str = "swiglu"    # "swiglu" | "gelu" (non-gated, 2 matmuls)
    tie_embeddings: bool = False
    # enc-dec (whisper): n_layers is the decoder depth
    n_enc_layers: int = 0
    # vlm: number of leading positions fed by the (stubbed) vision frontend
    n_img_tokens: int = 0
    # numerics / memory
    param_dtype: torch.dtype = torch.bfloat16
    compute_dtype: torch.dtype = torch.bfloat16
    remat: str = "full"         # "none" | "full" | "dots"
    # sequence-parallel attention (shard seq over 'model' axis for
    # norms/mlp): the reference's knob, which no model code of either
    # package reads yet
    seq_shard_decode: bool = False

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def period(self) -> int:
        return len(self.pattern)

    @property
    def n_periods(self) -> int:
        return self.n_layers // self.period

    @property
    def n_tail(self) -> int:
        return self.n_layers - self.n_periods * self.period

    def layer_spec(self, i: int) -> LayerSpec:
        return self.pattern[i % self.period]

    def validate(self) -> "ModelConfig":
        if self.n_heads % max(self.n_kv_heads, 1):
            raise ValueError(f"{self.name}: n_heads {self.n_heads} is not a multiple "
                             f"of n_kv_heads {self.n_kv_heads}")
        for spec in self.pattern:
            if spec.mlp in ("moe", "moe_dense") and self.moe.n_experts <= 0:
                raise ValueError(f"{self.name}: an MoE layer needs moe.n_experts > 0")
        return self


def remat(cfg: ModelConfig, fn, *args):
    """``fn(*args)``, recomputed in the backward (``torch.utils.checkpoint``:
    only the inputs are kept) unless ``cfg.remat`` is "none" or grad is
    off; under a sharding context the recomputation runs in it too."""
    if cfg.remat != "none" and torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False, **checkpoint_kwargs())
    return fn(*args)


def param_count(module: torch.nn.Module) -> int:
    return sum(p.numel() for p in module.parameters())


class _MetaGenerator:
    """The ``generator`` of the ``meta`` device: draws carry shapes and
    dtypes and no values."""

    device = torch.device("meta")


def generator(device, seed: int = 0):
    """A ``torch.Generator`` on ``device`` seeded with ``seed`` (on
    ``meta``, a stand-in without state)."""
    if torch.device(device).type == "meta":
        return _MetaGenerator()
    return torch.Generator(device=device).manual_seed(int(seed))


def _source(gen):
    return None if isinstance(gen, _MetaGenerator) else gen


def dense_init(gen: torch.Generator, shape, in_axis_size: int, dtype) -> torch.Tensor:
    """Normal draws scaled by 1/sqrt(fan_in), on the generator's device."""
    scale = 1.0 / math.sqrt(max(in_axis_size, 1))
    return normal(gen, shape, scale, dtype)


def normal(gen: torch.Generator, shape, scale: float, dtype) -> torch.Tensor:
    x = torch.randn(tuple(shape), generator=_source(gen), device=gen.device, dtype=torch.float32)
    return (x.mul_(scale)).to(dtype)


def uniform(gen: torch.Generator, shape, dtype) -> torch.Tensor:
    x = torch.rand(tuple(shape), generator=_source(gen), device=gen.device, dtype=torch.float32)
    return x.to(dtype)


# ---------------------------------------------------------------------------
# Primitive layers (plain functions on tensors)
# ---------------------------------------------------------------------------
def rms_norm(x, scale, eps):
    dt = x.dtype
    x = x.to(torch.float32)
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    out = x * torch.rsqrt(var + eps)
    return (out * (1.0 + scale.to(torch.float32))).to(dt)


def rotary(x, positions, theta):
    """x: [..., S, H, D]; positions: [..., S] (int)."""
    d = x.shape[-1]
    half = d // 2
    freq = torch.exp(
        -math.log(theta) * torch.arange(0, half, dtype=torch.float32, device=x.device) / half
    )
    ang = positions[..., None].to(torch.float32) * freq   # [..., S, half]
    sin = torch.sin(ang)[..., None, :]
    cos = torch.cos(ang)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def swiglu(x, w_gate, w_up, w_down):
    g = torch.einsum("...d,df->...f", x, w_gate)
    u = torch.einsum("...d,df->...f", x, w_up)
    h = F.silu(g.to(torch.float32)).to(x.dtype) * u
    return torch.einsum("...f,fd->...d", h, w_down)


__all__ = [
    "LayerSpec",
    "MoEConfig",
    "MambaConfig",
    "RWKVConfig",
    "ModelConfig",
    "dense_init",
    "generator",
    "normal",
    "param_count",
    "remat",
    "rms_norm",
    "rotary",
    "swiglu",
    "uniform",
]
