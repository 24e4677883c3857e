"""jamba-1.5-large-398b [hybrid]: 72L d_model=8192 64H (GQA kv=8)
d_ff=24576 vocab=65536, MoE 16e top-2 — Mamba+attn 1:7 interleave.
[arXiv:2403.19887; hf]

Period-8 pattern: one attention layer per 8 (position 4), the rest
Mamba; MoE replaces the dense MLP on every other layer.
"""
from ..models.common import LayerSpec, MambaConfig, MoEConfig, ModelConfig
from .registry import ArchSpec, register

M_D = LayerSpec("mamba", "dense")
M_E = LayerSpec("mamba", "moe")
A_D = LayerSpec("attn", "dense")

register(
    ArchSpec(
        model=ModelConfig(
            name="jamba_1p5_large_398b",
            family="hybrid",
            n_layers=72,
            d_model=8192,
            n_heads=64,
            n_kv_heads=8,
            head_dim=128,
            d_ff=24576,
            vocab=65536,
            moe=MoEConfig(
                n_experts=16, top_k=2, expert_ff=24576, capacity_factor=1.25
            ),
            mamba=MambaConfig(d_state=16, conv_k=4, expand=2, chunk=256),
            pattern=(M_D, M_E, M_D, M_E, A_D, M_E, M_D, M_E),
        ),
        smoke=ModelConfig(
            name="jamba_smoke",
            family="hybrid",
            n_layers=8,
            d_model=64,
            n_heads=4,
            n_kv_heads=2,
            d_ff=128,
            vocab=512,
            moe=MoEConfig(n_experts=4, top_k=2, expert_ff=96),
            mamba=MambaConfig(d_state=8, conv_k=4, expand=2, chunk=8),
            pattern=(
                LayerSpec("mamba", "dense"),
                LayerSpec("mamba", "moe"),
                LayerSpec("attn", "dense"),
                LayerSpec("mamba", "moe"),
            ),
        ),
        notes="long_500k runs: mamba state is O(1); attention KV at 500k "
        "shards over the model axis (SP/context parallelism).",
    )
)
