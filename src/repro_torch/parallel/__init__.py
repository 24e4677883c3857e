"""The port's parallel substrate (``repro.parallel``) on
``torch.distributed``: logical-axis sharding rules and DTensor
placements (``sharding``), the model code's sharding context and kernel
boundary (``ctx``), the int8 error-feedback gradient all-reduce
(``collectives``) and GPipe over a mesh axis (``pipeline``). The
reference's ``parallel/compat.py`` is a JAX-version shim with no
counterpart here."""
from .collectives import compressed_psum_mean, dequantize_int8, ef_compress_grad, quantize_int8
from .ctx import batch_axes_in_mesh, constrain, get_ctx, kernel_map, sharding_ctx
from .pipeline import bubble_fraction, gpipe
from .sharding import (
    DEFAULT_ACT_RULES,
    DEFAULT_PARAM_RULES,
    ShardingRules,
    logical_constraint,
    param_shardings,
    placements,
    shard_params,
    spec_for,
)

__all__ = [
    "DEFAULT_ACT_RULES",
    "DEFAULT_PARAM_RULES",
    "ShardingRules",
    "batch_axes_in_mesh",
    "bubble_fraction",
    "compressed_psum_mean",
    "constrain",
    "dequantize_int8",
    "ef_compress_grad",
    "get_ctx",
    "gpipe",
    "kernel_map",
    "logical_constraint",
    "param_shardings",
    "placements",
    "quantize_int8",
    "shard_params",
    "sharding_ctx",
    "spec_for",
]
