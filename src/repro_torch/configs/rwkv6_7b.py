"""rwkv6-7b [ssm]: 32L d_model=4096 (attention-free) d_ff=14336
vocab=65536 — Finch, data-dependent decay. [arXiv:2404.05892; hf]

64 heads x head_dim 64; O(1) recurrent state per layer (decode state is
[B, 64, 64, 64] f32 per layer regardless of context).
"""
from ..models.common import LayerSpec, ModelConfig, RWKVConfig
from .registry import ArchSpec, register

register(
    ArchSpec(
        model=ModelConfig(
            name="rwkv6_7b",
            family="ssm",
            n_layers=32,
            d_model=4096,
            d_ff=14336,
            vocab=65536,
            rwkv=RWKVConfig(head_dim=64, chunk=32),
            pattern=(LayerSpec("rwkv", "dense"),),
        ),
        smoke=ModelConfig(
            name="rwkv6_7b_smoke",
            family="ssm",
            n_layers=4,
            d_model=64,
            d_ff=128,
            vocab=512,
            rwkv=RWKVConfig(head_dim=16, chunk=8),
            pattern=(LayerSpec("rwkv", "dense"),),
        ),
        optimizer="adamw",
        notes="attention-free; Eudoxia's scheduling layer treats its "
        "decode ops exactly like attention archs (technique is "
        "architecture-agnostic).",
    )
)
