"""Mamba-1 block (jamba's sequence mixer).

A port of ``repro.models.ssm``: in_proj -> (x, z gate); short causal
depthwise conv on x; data-dependent (dt, B, C) projections; the
selective scan (``kernels.ssm_scan``: the CUDA kernel for CUDA
tensors); gated out_proj. Decode keeps two small states per layer: the
SSM state [B, d_inner, N] f32 and the conv tail [B, conv_k-1, d_inner]
in the compute dtype, and steps one token in plain torch
(``ssm_decode_step``).

Parameters are a mapping of tensors with the JAX package's names and
layouts (``in_proj`` [d, 2 d_inner], ``conv_w`` [K, d_inner], ...).
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from ..kernels.ssm_scan import ssm_decode_step, ssm_scan
from ..parallel.ctx import constrain, kernel_map, model_size
from .common import ModelConfig, dense_init, uniform


class MambaState(NamedTuple):
    h: torch.Tensor        # [B, d_inner, N] f32
    conv: torch.Tensor     # [B, conv_k - 1, d_inner]


def _dims(cfg: ModelConfig):
    d_inner = cfg.mamba.expand * cfg.d_model
    dt_rank = cfg.mamba.dt_rank or max(1, math.ceil(cfg.d_model / 16))
    return d_inner, dt_rank, cfg.mamba.d_state, cfg.mamba.conv_k


def _uniform(gen: torch.Generator, shape, low: float, high: float) -> torch.Tensor:
    return uniform(gen, shape, torch.float32) * (high - low) + low


def mamba_init(cfg: ModelConfig, gen: torch.Generator) -> dict:
    d = cfg.d_model
    di, dtr, N, K = _dims(cfg)
    dt = cfg.param_dtype
    f32 = torch.float32
    A = -torch.exp(_uniform(gen, (di, N), 0.0, math.log(16.0)))
    # dt_bias is the inverse softplus of dt drawn in [1e-3, 0.1]
    dt0 = _uniform(gen, (di,), 1e-3, 0.1)
    return {
        "in_proj": dense_init(gen, (d, 2 * di), d, dt),
        "conv_w": dense_init(gen, (K, di), K, dt),
        "conv_b": torch.zeros((di,), dtype=dt, device=gen.device),
        "x_proj": dense_init(gen, (di, dtr + 2 * N), di, dt),
        "dt_proj": dense_init(gen, (dtr, di), dtr, dt),
        "dt_bias": torch.log(torch.exp(dt0) - 1.0),
        "A_log": torch.log(-A),
        "D": torch.ones((di,), dtype=f32, device=gen.device),
        "out_proj": dense_init(gen, (di, d), di, dt),
    }


def init_mamba_state(cfg: ModelConfig, batch: int, device) -> MambaState:
    di, _, N, K = _dims(cfg)
    return MambaState(
        h=torch.zeros((batch, di, N), dtype=torch.float32, device=device),
        conv=torch.zeros((batch, K - 1, di), dtype=cfg.compute_dtype, device=device),
    )


def _causal_conv(x, w, b, tail=None):
    """x [B,S,di], w [K,di] depthwise; optional tail [B,K-1,di] prefix.
    A sum of K shifted products, as the JAX package writes it."""
    K = w.shape[0]
    if tail is None:
        pad = torch.zeros((x.shape[0], K - 1, x.shape[2]), dtype=x.dtype, device=x.device)
    else:
        pad = tail.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)                   # [B, S+K-1, di]
    S = x.shape[1]
    out = xp[:, 0:S, :] * w[0][None, None, :]
    for i in range(1, K):
        out = out + xp[:, i:i + S, :] * w[i][None, None, :]
    return out + b[None, None, :], xp[:, -(K - 1):, :]


def _ssm_inputs(cfg: ModelConfig, p, xi: torch.Tensor):
    """The data-dependent (dt f32, B, C) of the scan, and A = -exp(A_log)."""
    _, dtr, N, _ = _dims(cfg)
    proj = torch.einsum("bse,ez->bsz", xi, p["x_proj"])
    dt_in, B_in, C_in = torch.split(proj, [dtr, N, N], dim=-1)
    dt = F.softplus(
        torch.einsum("bsz,ze->bse", dt_in, p["dt_proj"]).to(torch.float32)
        + p["dt_bias"][None, None, :]
    )
    A = -torch.exp(p["A_log"])
    return dt, A, B_in.contiguous(), C_in.contiguous()


def mamba_apply(
    cfg: ModelConfig,
    p,
    x: torch.Tensor,                      # [B, S, d]
    state: Optional[MambaState] = None,
):
    """Full-sequence mixer from ``state`` (None: the zero state, as every
    prefill of the JAX package starts). Returns (out [B,S,d], the state
    after x)."""
    xz = constrain(torch.einsum("bsd,de->bse", x, p["in_proj"]), "batch seq ff")
    xi, z = torch.chunk(xz, 2, dim=-1)               # [B,S,di] each
    xi, conv_tail = _causal_conv(xi, p["conv_w"], p["conv_b"],
                                 None if state is None else state.conv)
    xi = F.silu(xi.to(torch.float32)).to(x.dtype)
    dt, A, B_in, C_in = _ssm_inputs(cfg, p, xi)
    h0 = None if state is None else state.h
    # the kernel on each rank's batch rows (and channels over "model")
    y, h = kernel_map(
        lambda xi, dt, A, B_in, C_in, D, h0: ssm_scan(xi, dt, A, B_in, C_in, D, h0,
                                                      chunk=cfg.mamba.chunk),
        (xi, dt, A, B_in, C_in, p["D"], h0),
        [(0, 2), (0, 2), (None, 0), (0, None), (0, None), (None, 0), None if h0 is None else (0, 1)],
        [(3, 0, 2), (3, 0, 1)], split=xi.shape[2] % model_size() == 0)
    y = y * F.silu(z.to(torch.float32)).to(y.dtype)
    out = constrain(torch.einsum("bse,ed->bsd", y, p["out_proj"]), "batch seq embed")
    return out, MambaState(h=h, conv=conv_tail)


def mamba_decode(cfg: ModelConfig, p, x: torch.Tensor, state: MambaState):
    """One-token step. x [B, 1, d] -> (y [B,1,d], new state)."""
    xz = torch.einsum("bsd,de->bse", x, p["in_proj"])
    xi, z = torch.chunk(xz, 2, dim=-1)               # [B,1,di]
    window = torch.cat([state.conv.to(xi.dtype), xi], dim=1)
    conv_out = (
        torch.einsum("bke,ke->be", window, p["conv_w"]) + p["conv_b"][None, :]
    )[:, None, :]
    xi = F.silu(conv_out.to(torch.float32)).to(x.dtype)
    dt, A, B_in, C_in = _ssm_inputs(cfg, p, xi)
    y, h = ssm_decode_step(xi[:, 0], dt[:, 0], A, B_in[:, 0], C_in[:, 0], p["D"], state.h)
    y = y[:, None, :] * F.silu(z.to(torch.float32)).to(y.dtype)
    out = constrain(torch.einsum("bse,ed->bsd", y, p["out_proj"]), "batch seq embed")
    return out, MambaState(h=h, conv=window[:, 1:, :])


__all__ = [
    "MambaState",
    "init_mamba_state",
    "mamba_apply",
    "mamba_decode",
    "mamba_init",
]
