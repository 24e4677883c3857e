"""llama4-maverick-400b-a17b [moe]: 48L d_model=5120 40H (GQA kv=8)
d_ff=8192 vocab=202048, MoE 128e top-1 — early fusion.
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]

Maverick interleaves dense and MoE layers 1:1; MoE layers carry 128
routed experts (top-1) plus a shared expert. iRoPE's chunked-local
global layers are modelled as plain global attention. The 40 heads are
padded to 48, as in the JAX config.
"""
from ..models.common import LayerSpec, MoEConfig, ModelConfig
from .registry import ArchSpec, register

register(
    ArchSpec(
        model=ModelConfig(
            name="llama4_maverick_400b_a17b",
            family="moe",
            n_layers=48,
            d_model=5120,
            n_heads=48,
            n_kv_heads=8,
            head_dim=128,
            d_ff=16384,  # dense-layer FF (ff=8192 in the line is expert FF)
            vocab=202048,
            moe=MoEConfig(
                n_experts=128,
                top_k=1,
                expert_ff=8192,
                shared_expert_ff=8192,
                capacity_factor=1.25,
            ),
            pattern=(LayerSpec("attn", "dense"), LayerSpec("attn", "moe")),
        ),
        smoke=ModelConfig(
            name="llama4_maverick_smoke",
            family="moe",
            n_layers=4,
            d_model=64,
            n_heads=4,
            n_kv_heads=2,
            d_ff=128,
            vocab=512,
            moe=MoEConfig(
                n_experts=4, top_k=1, expert_ff=96, shared_expert_ff=96
            ),
            pattern=(LayerSpec("attn", "dense"), LayerSpec("attn", "moe")),
        ),
        optimizer="adafactor",
        opt_state_dtype="bfloat16",
        train_microbatches=8,
        skip={"long_500k": "global attention layers (quadratic)"},
        notes="Q heads padded 40->48.",
    )
)
