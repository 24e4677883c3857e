"""arctic-480b [moe]: 35L d_model=7168 56H (GQA kv=8) d_ff=4864
vocab=32000, MoE 128e top-2 + dense residual.
[hf:Snowflake/snowflake-arctic-base; hf]

Arctic's dense-MoE hybrid: every layer runs a (small) dense MLP **in
parallel** with the 128-expert top-2 MoE ("moe_dense" spec). The 56
heads are padded to 64, as in the JAX config. vocab 32000 is already a
multiple of 256, so ``pad_vocab(32000)`` leaves it at 32000.
"""
from ..models.common import LayerSpec, MoEConfig, ModelConfig
from .registry import ArchSpec, pad_vocab, register

register(
    ArchSpec(
        model=ModelConfig(
            name="arctic_480b",
            family="moe",
            n_layers=35,
            d_model=7168,
            n_heads=64,
            n_kv_heads=8,
            head_dim=128,
            d_ff=4864,
            vocab=pad_vocab(32000),
            moe=MoEConfig(
                n_experts=128, top_k=2, expert_ff=4864, capacity_factor=1.25
            ),
            pattern=(LayerSpec("attn", "moe_dense"),),
        ),
        smoke=ModelConfig(
            name="arctic_480b_smoke",
            family="moe",
            n_layers=2,
            d_model=64,
            n_heads=4,
            n_kv_heads=2,
            d_ff=96,
            vocab=512,
            moe=MoEConfig(n_experts=8, top_k=2, expert_ff=96),
            pattern=(LayerSpec("attn", "moe_dense"),),
        ),
        optimizer="adafactor",
        opt_state_dtype="bfloat16",
        train_microbatches=8,
        skip={"long_500k": "full attention (quadratic)"},
        notes="dense residual MLP parallel to 128e top-2 MoE every layer.",
    )
)
