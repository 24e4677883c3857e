"""granite-34b [dense]: 88L d_model=6144 48H (GQA kv=1 — MQA) d_ff=24576
vocab=49152 — llama-arch, code. [arXiv:2405.04324; hf]

Non-gated GELU MLP (two matrices); every query head reads the one
key/value head.
"""
from ..models.common import LayerSpec, ModelConfig
from .registry import ArchSpec, register

register(
    ArchSpec(
        model=ModelConfig(
            name="granite_34b",
            family="lm",
            n_layers=88,
            d_model=6144,
            n_heads=48,
            n_kv_heads=1,
            head_dim=128,
            d_ff=24576,
            vocab=49152,
            mlp_type="gelu",
            pattern=(LayerSpec("attn", "dense"),),
        ),
        smoke=ModelConfig(
            name="granite_34b_smoke",
            family="lm",
            n_layers=4,
            d_model=64,
            n_heads=4,
            n_kv_heads=1,
            head_dim=16,
            d_ff=128,
            vocab=512,
            mlp_type="gelu",
            pattern=(LayerSpec("attn", "dense"),),
        ),
        optimizer="adamw",
        skip={"long_500k": "full attention (quadratic)"},
        notes="MQA: 48 query heads on one KV head.",
    )
)
