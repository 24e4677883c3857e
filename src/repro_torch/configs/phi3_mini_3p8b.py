"""phi3-mini-3.8b [dense]: 32L d_model=3072 32H (kv=32 — full MHA)
d_ff=8192 vocab=32064 — RoPE SwiGLU. [arXiv:2404.14219; unverified]

vocab padded 32064 -> 32256 (divisible by 256). head_dim 96, which the
bf16 attention kernel pads to 128 in shared memory.
"""
from ..models.common import LayerSpec, ModelConfig
from .registry import ArchSpec, pad_vocab, register

register(
    ArchSpec(
        model=ModelConfig(
            name="phi3_mini_3p8b",
            family="lm",
            n_layers=32,
            d_model=3072,
            n_heads=32,
            n_kv_heads=32,
            head_dim=96,
            d_ff=8192,
            vocab=pad_vocab(32064),
            pattern=(LayerSpec("attn", "dense"),),
        ),
        smoke=ModelConfig(
            name="phi3_mini_smoke",
            family="lm",
            n_layers=4,
            d_model=64,
            n_heads=4,
            n_kv_heads=4,
            d_ff=128,
            vocab=512,
            pattern=(LayerSpec("attn", "dense"),),
        ),
        optimizer="adamw",
        skip={"long_500k": "full attention (quadratic)"},
    )
)
