"""whisper-small [audio]: 12L d_model=768 12H (kv=12) d_ff=3072
vocab=51865 — enc-dec, conv frontend (stub). [arXiv:2212.04356; unverified]

12L = 12 encoder + 12 decoder layers (whisper-small's actual split).
The conv frontend is a stub, as in the JAX package: precomputed frame
embeddings [B, seq_len, 1024]; decoder length = max(64, seq_len // 8)
(``models.encdec.dec_len``). vocab padded 51865 -> 51968.
"""
from ..models.common import LayerSpec, ModelConfig
from .registry import ArchSpec, pad_vocab, register

register(
    ArchSpec(
        model=ModelConfig(
            name="whisper_small",
            family="audio",
            n_layers=12,
            n_enc_layers=12,
            d_model=768,
            n_heads=12,
            n_kv_heads=12,
            head_dim=64,
            d_ff=3072,
            vocab=pad_vocab(51865),
            mlp_type="gelu",
            pattern=(LayerSpec("attn", "dense"),),
        ),
        smoke=ModelConfig(
            name="whisper_small_smoke",
            family="audio",
            n_layers=2,
            n_enc_layers=2,
            d_model=64,
            n_heads=4,
            n_kv_heads=4,
            d_ff=128,
            vocab=512,
            mlp_type="gelu",
            pattern=(LayerSpec("attn", "dense"),),
        ),
        optimizer="adamw",
        skip={"long_500k": "500k-frame encoder self-attention is quadratic"},
        notes="encoder-decoder: bidirectional encoder, causal decoder with "
        "cross-attention over the encoder output.",
    )
)
