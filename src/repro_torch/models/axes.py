"""Logical axes of the port's parameters.

The JAX init returns an axes side table beside its parameters (one
space-separated logical name per dim). The port's ``lm_init`` /
``encdec_init`` return modules; ``model_axes(cfg)`` gives the same
table by the port's parameter names. A parameter of a layer that the
JAX package stacks over periods (``runtime.steps.stacked_leaves``) has
that leaf's axes without the leading ``layers``: the port keeps one
tensor a layer.
"""
from __future__ import annotations

from .common import ModelConfig

_ATTN = {"wq": "embed heads head_dim", "wk": "embed kv_heads head_dim",
         "wv": "embed kv_heads head_dim", "wo": "heads head_dim embed"}
_MLP = {"w_gate": "embed ff", "w_up": "embed ff", "w_down": "ff embed"}
_GROUPS = {
    "attn": _ATTN, "self": _ATTN, "cross": _ATTN,
    "mlp": _MLP, "shared": _MLP,
    "moe": {"router": "embed expert", "we_gate": "expert embed_moe ff",
            "we_up": "expert embed_moe ff", "we_down": "expert ff embed_moe"},
    "mamba": {"in_proj": "embed ff", "conv_w": "conv ff", "conv_b": "ff", "x_proj": "ff state",
              "dt_proj": "state ff", "dt_bias": "ff", "A_log": "ff state", "D": "ff",
              "out_proj": "ff embed"},
    "rwkv": {"mix": "state embed", "wr": "embed heads head_dim", "wk": "embed heads head_dim",
             "wv": "embed heads head_dim", "wg": "embed heads head_dim", "w_base": "state embed",
             "w_lora1": "embed state", "w_lora2": "state embed", "u": "heads head_dim",
             "ln_scale": "heads head_dim", "wo": "heads head_dim embed", "cmix": "state embed",
             "ck": "embed ff", "cv": "ff embed", "cr": "embed embed"},
}
_TOP = {"embed": "vocab embed", "head": "embed vocab", "frontend_proj": "state embed",
        "final_norm": "embed", "enc_norm": "embed", "n1": "embed", "n2": "embed", "nc": "embed"}


def param_axes(name: str) -> str:
    """The logical axes of the port's parameter ``name``."""
    parts = name.split(".")
    leaf = parts[-1]
    group = parts[-2] if len(parts) > 1 else None
    table = _GROUPS.get(group)
    if table is not None and leaf in table:
        return table[leaf]
    if leaf in _TOP:
        return _TOP[leaf]
    raise KeyError(f"no logical axes for parameter {name!r}")


def model_axes(cfg: ModelConfig) -> dict[str, str]:
    """``{parameter name: axes}`` of ``cfg``'s model, in the order of
    ``named_parameters()`` (drawn on the ``meta`` device: nothing is
    allocated)."""
    from ..runtime.steps import model_init

    return {name: param_axes(name)
            for name, _ in model_init(cfg, device="meta").named_parameters()}


__all__ = ["model_axes", "param_axes"]
