"""Optimizers: AdamW and Adafactor (factored second moment), a port of
``repro.optim.optimizers``.

The update rules, the warmup-cosine schedule and the global-norm clip
are the JAX package's, operation for operation and with its casts: the
moments are stored in ``OptConfig.state_dtype`` (f32, or bf16 for the
giants) and every update runs in f32. Parameters and states are plain
tensors keyed by parameter name (``named_parameters()`` of the model);
the update writes the new values into the parameters and the moments in
place, one parameter at a time, so that no second copy of the model or
of its moments is ever held (the state passed in is the state returned,
its ``step`` a new tensor). No ``torch.optim`` class is used.

* ``OptState(step, inner)``: ``step`` an int32 scalar tensor; ``inner``
  ``{"m": {name: t}, "v": {name: t}}`` for AdamW, ``{leaf: {"vr", "vc"}}``
  (factored, for a leaf whose last two dims exceed 1) or ``{leaf:
  {"v"}}`` for Adafactor.
* ``make_optimizer(cfg)`` returns ``(init(cfg, params, groups=None),
  update(cfg, grads, state, params, groups=None) -> (state,
  grad_norm))``; ``params`` is a mapping of names to parameters,
  ``grads`` of names to gradients.

Adafactor is not elementwise: it factors the second moment over a
leaf's last two dims and clips each leaf's update by its RMS. The JAX
package's leaves stack a pattern position's layers on a leading axis,
so a norm scale [d] is a [P, d] leaf there, factored over (P, d), and
the RMS runs over the P layers together. ``groups`` (``{leaf: (names,
stacked)}``, ``runtime.steps.stacked_leaves``) gives the port the same
leaves: the members of a stacked leaf are stacked for the update and
written back layer by layer. Without ``groups`` each parameter is a leaf
of its own. AdamW is elementwise and takes ``groups`` for the same
signature only.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Mapping, NamedTuple

import torch

F32 = torch.float32


class OptState(NamedTuple):
    step: torch.Tensor          # int32 scalar
    inner: Any                  # per-optimizer state, keyed by parameter name


@dataclasses.dataclass(frozen=True)
class OptConfig:
    name: str = "adamw"         # "adamw" | "adafactor"
    peak_lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    weight_decay: float = 0.01
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    clip_norm: float = 1.0
    state_dtype: torch.dtype = torch.float32


def _f32(x: float, device) -> torch.Tensor:
    """A Python float as an f32 scalar (JAX's weakly typed constants)."""
    return torch.tensor(x, dtype=F32, device=device)


def warmup_cosine(cfg: OptConfig) -> Callable:
    """lr(step): linear warmup to ``peak_lr`` over ``warmup_steps`` (the
    first update at step 0 already above 0), then a cosine to a tenth of
    it at ``total_steps``; f32 throughout."""
    def lr(step: torch.Tensor) -> torch.Tensor:
        step = step.to(F32) + 1.0
        warm = torch.clamp_max(step / max(cfg.warmup_steps, 1), 1.0)
        t = torch.clamp((step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1),
                        0.0, 1.0)
        cos = 0.5 * (1.0 + torch.cos(_f32(math.pi, step.device) * t))
        return cfg.peak_lr * warm * (0.1 + 0.9 * cos)

    return lr


def global_norm(grads: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's sum of squares in f32."""
    leaves = [torch.sum(torch.square(g.to(F32))) for g in grads.values()]
    return torch.sqrt(torch.sum(torch.stack(leaves)))


def _clip_scale(grads, clip_norm: float):
    """(scale, norm): every gradient is multiplied by ``scale`` (cast to
    its dtype) before the update, as the JAX package's ``_clip``."""
    g = global_norm(grads)
    return torch.clamp_max(clip_norm / torch.clamp_min(g, 1e-9), 1.0), g


def _names(params, grads):
    if set(params) != set(grads):
        raise KeyError(f"gradients {sorted(set(grads) ^ set(params))} do not match the parameters")
    return list(params)


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------
def adamw_init(cfg: OptConfig, params: Mapping[str, torch.Tensor], groups=None) -> OptState:
    def zeros(p):
        return torch.zeros(p.shape, dtype=cfg.state_dtype, device=p.device)

    device = next(iter(params.values())).device
    return OptState(step=torch.zeros((), dtype=torch.int32, device=device),
                    inner={"m": {n: zeros(p) for n, p in params.items()},
                           "v": {n: zeros(p) for n, p in params.items()}})


@torch.no_grad()
def adamw_update(cfg: OptConfig, grads, state: OptState, params, groups=None):
    """Update ``params`` in place; returns (new state, global grad norm)."""
    lr = warmup_cosine(cfg)(state.step)
    scale, gnorm = _clip_scale(grads, cfg.clip_norm)
    step = state.step + 1
    t = step.to(F32)
    bc1 = 1.0 - torch.pow(_f32(cfg.b1, t.device), t)
    bc2 = 1.0 - torch.pow(_f32(cfg.b2, t.device), t)
    for n in _names(params, grads):
        p, m, v = params[n], state.inner["m"][n], state.inner["v"][n]
        gf = (grads[n] * scale.to(grads[n].dtype)).to(F32)
        m1 = cfg.b1 * m.to(F32) + (1 - cfg.b1) * gf
        v1 = cfg.b2 * v.to(F32) + (1 - cfg.b2) * torch.square(gf)
        delta = (m1 / bc1) / (torch.sqrt(v1 / bc2) + cfg.eps) + cfg.weight_decay * p.to(F32)
        p.copy_((p.to(F32) - lr * delta).to(p.dtype))
        m.copy_(m1.to(cfg.state_dtype))
        v.copy_(v1.to(cfg.state_dtype))
    return OptState(step=step, inner=state.inner), gnorm


# ---------------------------------------------------------------------------
# Adafactor (factored second moment; no first moment)
# ---------------------------------------------------------------------------
def _factored(shape) -> bool:
    return len(shape) >= 2 and shape[-1] > 1 and shape[-2] > 1


def _leaves(params, groups):
    """``{leaf: (names, stacked)}``: the given groups, or each parameter a
    leaf of its own."""
    return groups if groups is not None else {n: ([n], False) for n in params}


def adafactor_init(cfg: OptConfig, params: Mapping[str, torch.Tensor], groups=None) -> OptState:
    def init_v(shape, device):
        def zeros(shape):
            return torch.zeros(shape, dtype=cfg.state_dtype, device=device)

        if _factored(shape):
            return {"vr": zeros(shape[:-1]), "vc": zeros(shape[:-2] + shape[-1:])}
        return {"v": zeros(shape)}

    inner = {}
    for leaf, (names, stacked) in _leaves(params, groups).items():
        p = params[names[0]]
        inner[leaf] = init_v(((len(names),) if stacked else ()) + tuple(p.shape), p.device)
    device = next(iter(params.values())).device
    return OptState(step=torch.zeros((), dtype=torch.int32, device=device), inner=inner)


@torch.no_grad()
def adafactor_update(cfg: OptConfig, grads, state: OptState, params, groups=None):
    """Update ``params`` in place; returns (new state, global grad norm)."""
    _names(params, grads)
    lr = warmup_cosine(cfg)(state.step)
    scale, gnorm = _clip_scale(grads, cfg.clip_norm)
    step = state.step + 1
    t = step.to(F32)
    beta2 = 1.0 - torch.pow(t, -0.8)
    for leaf, (names, stacked) in _leaves(params, groups).items():
        v = state.inner[leaf]
        if stacked:
            g = torch.stack([grads[n] for n in names])
            p = torch.stack([params[n] for n in names])
        else:
            g, p = grads[names[0]], params[names[0]]
        gf = (g * scale.to(g.dtype)).to(F32)
        g2 = torch.square(gf) + 1e-30
        if "vr" in v:
            vr = beta2 * v["vr"].to(F32) + (1 - beta2) * torch.mean(g2, dim=-1)
            vc = beta2 * v["vc"].to(F32) + (1 - beta2) * torch.mean(g2, dim=-2)
            denom = (vr[..., None] * vc[..., None, :]
                     / torch.clamp_min(torch.mean(vr, dim=-1, keepdim=True)[..., None], 1e-30))
            precond = gf * torch.rsqrt(torch.clamp_min(denom, 1e-30))
            v["vr"].copy_(vr.to(cfg.state_dtype))
            v["vc"].copy_(vc.to(cfg.state_dtype))
        else:
            vf = beta2 * v["v"].to(F32) + (1 - beta2) * g2
            precond = gf * torch.rsqrt(torch.clamp_min(vf, 1e-30))
            v["v"].copy_(vf.to(cfg.state_dtype))
        # relative-scale update clipping (Adafactor's d = 1.0)
        rms = torch.sqrt(torch.mean(torch.square(precond)) + 1e-30)
        precond = precond / torch.clamp_min(rms, 1.0)
        p_new = (p.to(F32) - lr * (precond + cfg.weight_decay * p.to(F32))).to(p.dtype)
        for i, n in enumerate(names):
            params[n].copy_(p_new[i] if stacked else p_new)
    return OptState(step=step, inner=state.inner), gnorm


# ---------------------------------------------------------------------------
def make_optimizer(cfg: OptConfig):
    if cfg.name == "adamw":
        return adamw_init, adamw_update
    if cfg.name == "adafactor":
        return adafactor_init, adafactor_update
    raise ValueError(cfg.name)


__all__ = [
    "OptConfig",
    "OptState",
    "adafactor_init",
    "adafactor_update",
    "adamw_init",
    "adamw_update",
    "global_norm",
    "make_optimizer",
    "warmup_cosine",
]
