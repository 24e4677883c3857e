"""The LM substrate of the port, on the serving path: dense attention
(MQA, MHA, GQA, sliding window), RWKV-6 and hybrid Mamba / attention
decoder stacks with dense or Mixture-of-Experts MLPs, the vlm family's
stubbed frontend, the whisper-style encoder-decoder (``encdec``), and
their caches."""
from .common import LayerSpec, MambaConfig, ModelConfig, MoEConfig, RWKVConfig
from .encdec import (
    EncDec,
    EncDecCaches,
    dec_len,
    encdec_decode_step,
    encdec_init,
    encdec_loss,
    encdec_prefill,
    encode,
    sinusoidal,
)
from .lm import LM, VIT_DIM, init_caches, lm_decode_step, lm_init, lm_loss, lm_prefill

__all__ = [
    "EncDec",
    "EncDecCaches",
    "LM",
    "LayerSpec",
    "MambaConfig",
    "MoEConfig",
    "ModelConfig",
    "RWKVConfig",
    "VIT_DIM",
    "dec_len",
    "encdec_decode_step",
    "encdec_init",
    "encdec_loss",
    "encdec_prefill",
    "encode",
    "init_caches",
    "lm_decode_step",
    "lm_init",
    "lm_loss",
    "lm_prefill",
    "sinusoidal",
]
