"""Dense feed-forward block (SwiGLU, or non-gated GELU), a port of the
dense half of ``repro.models.mlp``. The Mixture-of-Experts layers wait
for ROADMAP queue 1, item 15."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .common import ModelConfig, dense_init


def mlp_init(cfg: ModelConfig, gen: torch.Generator, d_ff: int | None = None) -> dict:
    d = cfg.d_model
    f = d_ff or cfg.d_ff
    dt = cfg.param_dtype
    p = {}
    if cfg.mlp_type == "swiglu":
        p["w_gate"] = dense_init(gen, (d, f), d, dt)
    p["w_up"] = dense_init(gen, (d, f), d, dt)
    p["w_down"] = dense_init(gen, (f, d), f, dt)
    return p


def mlp_apply(p, x: torch.Tensor) -> torch.Tensor:
    u = torch.einsum("bsd,df->bsf", x, p["w_up"])
    if "w_gate" in p:
        g = torch.einsum("bsd,df->bsf", x, p["w_gate"])
        h = F.silu(g.to(torch.float32)).to(x.dtype) * u
    else:  # jax.nn.gelu's default is the tanh approximation
        h = F.gelu(u.to(torch.float32), approximate="tanh").to(x.dtype)
    return torch.einsum("bsf,fd->bsd", h, p["w_down"])


__all__ = ["mlp_init", "mlp_apply"]
