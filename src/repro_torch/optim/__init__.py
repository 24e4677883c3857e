"""The port's optimizers (``repro.optim``): AdamW and Adafactor over
named parameters."""
from .optimizers import (
    OptConfig,
    OptState,
    adafactor_init,
    adamw_init,
    global_norm,
    make_optimizer,
    warmup_cosine,
)

__all__ = [
    "OptConfig",
    "OptState",
    "adafactor_init",
    "adamw_init",
    "global_norm",
    "make_optimizer",
    "warmup_cosine",
]
