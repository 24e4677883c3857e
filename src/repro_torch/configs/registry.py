"""Architecture registry of the port: full configs + reduced smoke configs.

Every architecture of the JAX package registers an :class:`ArchSpec`
from its own module (``configs/<id>.py``), its ``model`` and ``smoke``
configs copied field for field from ``repro.configs.<id>`` (without
``attn_impl``). ``ArchSpec`` holds what serving reads; the training
fields of the JAX package's (``optimizer``, ``opt_state_dtype``,
``train_microbatches``, ``shapes``, ``skip``) wait for ROADMAP queue 1,
item 15 (c), and its sharding overrides for item 16.
"""
from __future__ import annotations

import dataclasses
import importlib

from ..models.common import ModelConfig


@dataclasses.dataclass(frozen=True)
class ArchSpec:
    model: ModelConfig
    smoke: ModelConfig
    notes: str = ""

    @property
    def name(self) -> str:
        return self.model.name


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


__all__ = ["ArchSpec", "register", "get_arch", "list_archs", "pad_vocab"]
