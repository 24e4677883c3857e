"""gemma3-12b [dense]: 48L d_model=3840 16H (GQA kv=8) d_ff=15360
vocab=262144 — 5:1 local:global interleave, 128k context.
[hf:google/gemma-3-1b-pt; unverified]

head_dim=256 (gemma3-12b's actual head width). Local layers use a
1024-token sliding window; every 6th layer is global.
"""
from ..models.common import LayerSpec, ModelConfig
from .registry import ArchSpec, register

LOCAL = LayerSpec("attn", "dense", window=1024)
GLOBAL = LayerSpec("attn", "dense", window=0)
PATTERN = (LOCAL, LOCAL, LOCAL, LOCAL, LOCAL, GLOBAL)

register(
    ArchSpec(
        model=ModelConfig(
            name="gemma3_12b",
            family="lm",
            n_layers=48,
            d_model=3840,
            n_heads=16,
            n_kv_heads=8,
            head_dim=256,
            d_ff=15360,
            vocab=262144,
            pattern=PATTERN,
            rope_theta=1_000_000.0,
        ),
        smoke=ModelConfig(
            name="gemma3_12b_smoke",
            family="lm",
            n_layers=6,
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
        notes="5:1 local:global via period-6 pattern.",
    )
)
