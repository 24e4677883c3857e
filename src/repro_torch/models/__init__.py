"""The LM substrate of the port, on the serving path: dense attention
(GQA, sliding window), RWKV-6 and hybrid Mamba / attention decoder
stacks with dense or Mixture-of-Experts MLPs, and their caches."""
from .common import LayerSpec, MambaConfig, ModelConfig, MoEConfig, RWKVConfig
from .lm import LM, init_caches, lm_decode_step, lm_init, lm_loss, lm_prefill

__all__ = [
    "LM",
    "LayerSpec",
    "MambaConfig",
    "MoEConfig",
    "ModelConfig",
    "RWKVConfig",
    "init_caches",
    "lm_decode_step",
    "lm_init",
    "lm_loss",
    "lm_prefill",
]
