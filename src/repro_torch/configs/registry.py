"""Architecture registry of the port: full configs + reduced smoke configs.

Every architecture of the JAX package registers an :class:`ArchSpec`
from its own module (``configs/<id>.py``), its ``model`` and ``smoke``
configs copied field for field from ``repro.configs.<id>`` (without
``attn_impl``), and the training fields (``optimizer``,
``opt_state_dtype``, ``train_microbatches``, ``shapes``, ``skip``,
``rule_overrides``) copied from the same ``ArchSpec``. ``rule_overrides``
amends the default sharding rules (``launch.lowering.arch_rules``).
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Mapping

from ..models.common import ModelConfig

ALL_SHAPES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")


@dataclasses.dataclass(frozen=True)
class ArchSpec:
    model: ModelConfig
    smoke: ModelConfig
    optimizer: str = "adamw"            # "adamw" | "adafactor"
    opt_state_dtype: str = "float32"    # "float32" | "bfloat16" (giants)
    train_microbatches: int = 4         # gradient-accumulation splits
    shapes: tuple[str, ...] = ALL_SHAPES
    skip: Mapping[str, str] = dataclasses.field(default_factory=dict)
    # sharding-rule overrides, e.g. {"param": {"head_dim": ("model",)}}
    rule_overrides: Mapping[str, Mapping] = dataclasses.field(default_factory=dict)
    notes: str = ""

    @property
    def name(self) -> str:
        return self.model.name

    def runnable_shapes(self) -> tuple[str, ...]:
        return tuple(s for s in self.shapes if s not in self.skip)


_REGISTRY: dict[str, ArchSpec] = {}

ARCH_MODULES = [
    "gemma3_12b",
    "granite_34b",
    "phi3_mini_3p8b",
    "gemma3_27b",
    "internvl2_2b",
    "llama4_maverick_400b_a17b",
    "arctic_480b",
    "whisper_small",
    "jamba_1p5_large_398b",
    "rwkv6_7b",
]


def register(spec: ArchSpec) -> ArchSpec:
    _REGISTRY[spec.name] = spec
    return spec


def _load_all():
    for mod in ARCH_MODULES:
        importlib.import_module(f"{__package__}.{mod}")


def get_arch(name: str) -> ArchSpec:
    if not _REGISTRY:
        _load_all()
    key = name.replace("-", "_").replace(".", "p")
    for cand in (name, key):
        if cand in _REGISTRY:
            return _REGISTRY[cand]
    raise KeyError(f"unknown arch {name!r}; ported: {sorted(_REGISTRY)}")


def list_archs() -> list[str]:
    if not _REGISTRY:
        _load_all()
    return sorted(_REGISTRY)


def pad_vocab(v: int, multiple: int = 256) -> int:
    """Pad vocab to a multiple so it TP-shards cleanly (noted per config)."""
    return ((v + multiple - 1) // multiple) * multiple


__all__ = ["ALL_SHAPES", "ArchSpec", "register", "get_arch", "list_archs", "pad_vocab"]
