from .ops import flash_attention, flash_attention_bwd
from .ref import (NEG_INF, flash_attention_bwd_ref, flash_attention_fwd_lse_ref,
                  flash_attention_ref, mha_reference)

__all__ = ["NEG_INF", "flash_attention", "flash_attention_bwd", "flash_attention_bwd_ref",
           "flash_attention_fwd_lse_ref", "flash_attention_ref", "mha_reference"]
