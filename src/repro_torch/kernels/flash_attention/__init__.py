from .ops import flash_attention
from .ref import NEG_INF, flash_attention_ref, mha_reference

__all__ = ["NEG_INF", "flash_attention", "flash_attention_ref", "mha_reference"]
