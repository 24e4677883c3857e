"""RWKV-6 "Finch" block: data-dependent-decay time mix + channel mix.

A port of ``repro.models.rwkv``: token-shift interpolation with
per-channel learned mix vectors, LoRA-projected decay
w = exp(-exp(..)), the WKV6 recurrence (``kernels.rwkv6_scan``: the CUDA
kernel for CUDA tensors), bonus u, per-head RMS group norm, gated output
and the squared-ReLU channel mix. Decode carries the [B,H,N,N] WKV state
and the one-token shift states per mixer, and runs the recurrence one
token at a time in plain torch (``rwkv6_decode_step``).

Parameters are a mapping of tensors with the JAX package's names and
layouts (``wr`` [d, H, N], ``wo`` [H, N, d], ...).
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from ..kernels.rwkv6_scan import rwkv6_decode_step, rwkv6_scan
from ..parallel.ctx import constrain, kernel_map, model_size
from .common import ModelConfig, dense_init, normal, rms_norm, uniform


class RWKVState(NamedTuple):
    wkv: torch.Tensor      # [B, H, N, N] f32
    shift_t: torch.Tensor  # [B, 1, d] last token (time mix)
    shift_c: torch.Tensor  # [B, 1, d] last token (channel mix)


def _dims(cfg: ModelConfig):
    N = cfg.rwkv.head_dim
    H = cfg.d_model // N
    return H, N


def rwkv_init(cfg: ModelConfig, gen: torch.Generator) -> dict:
    d = cfg.d_model
    H, N = _dims(cfg)
    dt = cfg.param_dtype
    f32 = torch.float32
    lora = max(32, d // 64)
    return {
        "mix": uniform(gen, (5, d), dt),   # interpolation weights for (r,k,v,w,g)
        "wr": dense_init(gen, (d, H, N), d, dt),
        "wk": dense_init(gen, (d, H, N), d, dt),
        "wv": dense_init(gen, (d, H, N), d, dt),
        "wg": dense_init(gen, (d, H, N), d, dt),
        # decay LoRA: w = exp(-exp(base + tanh(x W1) W2))
        "w_base": torch.linspace(-6.0, -0.3, d, dtype=f32, device=gen.device).reshape(1, d),
        "w_lora1": dense_init(gen, (d, lora), d, dt),
        "w_lora2": normal(gen, (lora, d), 0.01, f32),
        "u": normal(gen, (H, N), 0.3, f32),
        "ln_scale": torch.zeros((H, N), dtype=f32, device=gen.device),
        "wo": dense_init(gen, (H, N, d), d, dt),
        # channel mix
        "cmix": uniform(gen, (2, d), dt),
        "ck": dense_init(gen, (d, cfg.d_ff), d, dt),
        "cv": dense_init(gen, (cfg.d_ff, d), cfg.d_ff, dt),
        "cr": dense_init(gen, (d, d), d, dt),
    }


def init_rwkv_state(cfg: ModelConfig, batch: int, device) -> RWKVState:
    H, N = _dims(cfg)
    return RWKVState(
        wkv=torch.zeros((batch, H, N, N), dtype=torch.float32, device=device),
        shift_t=torch.zeros((batch, 1, cfg.d_model), dtype=cfg.compute_dtype, device=device),
        shift_c=torch.zeros((batch, 1, cfg.d_model), dtype=cfg.compute_dtype, device=device),
    )


def _token_shift(x, prev):
    """Shift right by one; position 0 sees `prev` (zeros at seq start)."""
    return torch.cat([prev.to(x.dtype), x[:, :-1, :]], dim=1)


def _group_rms(x, scale, eps):
    # x [B,S,H,N]: per-head normalisation
    xf = x.to(torch.float32)
    var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * (1.0 + scale)[None, None]).to(x.dtype)


def _time_mix_inputs(cfg, p, x, shifted):
    H, N = _dims(cfg)
    mix = p["mix"].to(x.dtype)  # [5, d]
    xr, xk, xv, xw, xg = (
        x * mix[i][None, None, :] + shifted * (1 - mix[i][None, None, :])
        for i in range(5)
    )
    B, S, d = x.shape
    hax = "batch seq heads head_dim"
    r = constrain(torch.einsum("bsd,dhn->bshn", xr, p["wr"]), hax)
    k = constrain(torch.einsum("bsd,dhn->bshn", xk, p["wk"]), hax)
    v = constrain(torch.einsum("bsd,dhn->bshn", xv, p["wv"]), hax)
    g = constrain(torch.einsum("bsd,dhn->bshn", xg, p["wg"]), hax)
    # data-dependent decay (log-space LoRA), f32
    wl = torch.tanh(torch.einsum("bsd,dl->bsl", xw, p["w_lora1"]).to(torch.float32))
    logw_in = p["w_base"][0][None, None, :] + torch.einsum("bsl,ld->bsd", wl, p["w_lora2"])
    w = torch.exp(-torch.exp(logw_in)).reshape(B, S, H, N)
    return r, k, v, g, w


def _channel_mix(p, xc, shifted_c, dtype):
    cmix = p["cmix"].to(dtype)
    xk_c = xc * cmix[0][None, None] + shifted_c * (1 - cmix[0][None, None])
    xr_c = xc * cmix[1][None, None] + shifted_c * (1 - cmix[1][None, None])
    kk = torch.einsum("bsd,df->bsf", xk_c, p["ck"])
    kk = torch.square(F.relu(kk.to(torch.float32))).to(dtype)
    gate = torch.sigmoid(torch.einsum("bsd,de->bse", xr_c, p["cr"]).to(torch.float32)).to(dtype)
    return gate * constrain(torch.einsum("bsf,fd->bsd", kk, p["cv"]), "batch seq embed")


def _time_mix_out(cfg, p, out, g):
    out = _group_rms(out, p["ln_scale"], cfg.norm_eps)
    out = out * F.silu(g.to(torch.float32)).to(out.dtype)
    return constrain(torch.einsum("bshn,hnd->bsd", out, p["wo"]), "batch seq embed")


def rwkv_apply(
    cfg: ModelConfig,
    p,
    x: torch.Tensor,
    n1,
    n2,
    state: RWKVState,
):
    """Full RWKV block on the raw residual stream, continuing from
    ``state``: x1 = x + time_mix(rms(x, n1)); out = x1 +
    channel_mix(rms(x1, n2)). Returns (out, the state after x)."""
    xn = rms_norm(x, n1, cfg.norm_eps)
    shifted = _token_shift(xn, state.shift_t)
    r, k, v, g, w = _time_mix_inputs(cfg, p, xn, shifted)
    # the kernel on each rank's batch rows (and heads over "model")
    out, wkv = kernel_map(
        lambda r, k, v, w, u, s0: rwkv6_scan(r, k, v, w, u, s0, chunk=cfg.rwkv.chunk),
        (r, k, v, w, p["u"], state.wkv), [(0, 2)] * 4 + [(None, 0), (0, 1)],
        [(4, 0, 2), (4, 0, 1)], split=r.shape[2] % model_size() == 0)
    x1 = x + _time_mix_out(cfg, p, out, g)
    xc = rms_norm(x1, n2, cfg.norm_eps)
    shifted_c = _token_shift(xc, state.shift_c)
    y = x1 + _channel_mix(p, xc, shifted_c, x.dtype)
    return y, RWKVState(wkv=wkv, shift_t=xn[:, -1:, :], shift_c=xc[:, -1:, :])


def rwkv_decode(cfg: ModelConfig, p, x: torch.Tensor, n1, n2, state: RWKVState):
    """One token (S=1) using the sequential recurrence."""
    xn = rms_norm(x, n1, cfg.norm_eps)
    shifted = state.shift_t.to(x.dtype)
    r, k, v, g, w = _time_mix_inputs(cfg, p, xn, shifted)
    out, wkv = rwkv6_decode_step(r[:, 0], k[:, 0], v[:, 0], w[:, 0], p["u"], state.wkv)
    x1 = x + _time_mix_out(cfg, p, out[:, None], g)
    xc = rms_norm(x1, n2, cfg.norm_eps)
    shifted_c = state.shift_c.to(x.dtype)
    y = x1 + _channel_mix(p, xc, shifted_c, x.dtype)
    return y, RWKVState(wkv=wkv, shift_t=xn, shift_c=xc)


__all__ = [
    "RWKVState",
    "rwkv_init",
    "rwkv_apply",
    "rwkv_decode",
    "init_rwkv_state",
]
