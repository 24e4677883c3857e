"""Architecture registry of the port: full configs + reduced smoke configs.

Each ported architecture registers an :class:`ArchSpec` from its own
module (``configs/<id>.py``), its ``model`` and ``smoke`` configs copied
field for field from ``repro.configs.<id>`` (without ``attn_impl``).
``get_arch`` of an architecture the JAX package has and the port does
not yet raises ``NotImplementedError`` naming the ROADMAP item.
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

ARCH_MODULES = ["gemma3_12b", "jamba_1p5_large_398b", "rwkv6_7b"]
# the JAX package's other architectures, each waiting for its layers
LATER_ARCHS = (
    "arctic_480b", "gemma3_27b", "granite_34b", "internvl2_2b",
    "llama4_maverick_400b_a17b", "phi3_mini_3p8b", "whisper_small",
)


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
        if cand in LATER_ARCHS:
            raise NotImplementedError(
                f"arch {cand!r} is not ported yet: its config and layers wait for "
                "ROADMAP queue 1, item 15"
            )
    raise KeyError(f"unknown arch {name!r}; ported: {sorted(_REGISTRY)}")


def list_archs() -> list[str]:
    if not _REGISTRY:
        _load_all()
    return sorted(_REGISTRY)


__all__ = ["ArchSpec", "register", "get_arch", "list_archs"]
