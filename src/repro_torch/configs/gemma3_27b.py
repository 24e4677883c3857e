"""gemma3-27b [dense]: 62L d_model=5376 32H (GQA kv=16) d_ff=21504
vocab=262144 — 5:1 local:global, 128k. [hf:google/gemma-3-1b-pt; unverified]

62 layers = 10 full (5 local + 1 global) periods + 2 tail local layers.
"""
from ..models.common import LayerSpec, ModelConfig
from .registry import ArchSpec, register

LOCAL = LayerSpec("attn", "dense", window=1024)
GLOBAL = LayerSpec("attn", "dense", window=0)

register(
    ArchSpec(
        model=ModelConfig(
            name="gemma3_27b",
            family="lm",
            n_layers=62,
            d_model=5376,
            n_heads=32,
            n_kv_heads=16,
            head_dim=128,
            d_ff=21504,
            vocab=262144,
            pattern=(LOCAL, LOCAL, LOCAL, LOCAL, LOCAL, GLOBAL),
            rope_theta=1_000_000.0,
        ),
        smoke=ModelConfig(
            name="gemma3_27b_smoke",
            family="lm",
            n_layers=8,  # 2 periods of 3 + 2 tail
            d_model=96,
            n_heads=4,
            n_kv_heads=2,
            head_dim=24,
            d_ff=192,
            vocab=512,
            pattern=(
                LayerSpec("attn", "dense", window=8),
                LayerSpec("attn", "dense", window=8),
                LayerSpec("attn", "dense", window=0),
            ),
        ),
        optimizer="adamw",
        skip={"long_500k": "global layers are full attention (quadratic)"},
        notes="5:1 local:global via period-6 pattern; a 2-layer local tail.",
    )
)
