"""internvl2-2b [vlm]: 24L d_model=2048 16H (GQA kv=8) d_ff=8192
vocab=92553 — InternViT + InternLM2. [arXiv:2404.16821; hf]

The InternViT frontend is a stub, as in the JAX package: 256
precomputed patch embeddings [B, 256, 1024] which a learned projector
(``LM.frontend_proj``) maps into the first 256 positions of the LM.
vocab padded 92553 -> 92672.
"""
from ..models.common import LayerSpec, ModelConfig
from .registry import ArchSpec, pad_vocab, register

register(
    ArchSpec(
        model=ModelConfig(
            name="internvl2_2b",
            family="vlm",
            n_layers=24,
            d_model=2048,
            n_heads=16,
            n_kv_heads=8,
            head_dim=128,
            d_ff=8192,
            vocab=pad_vocab(92553),
            n_img_tokens=256,
            pattern=(LayerSpec("attn", "dense"),),
        ),
        smoke=ModelConfig(
            name="internvl2_2b_smoke",
            family="vlm",
            n_layers=4,
            d_model=64,
            n_heads=4,
            n_kv_heads=2,
            d_ff=128,
            vocab=512,
            n_img_tokens=8,
            pattern=(LayerSpec("attn", "dense"),),
        ),
        optimizer="adamw",
        skip={"long_500k": "full attention (quadratic)"},
        notes="LM backbone only; vision tower stubbed.",
    )
)
