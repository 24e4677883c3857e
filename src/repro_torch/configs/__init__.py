from .registry import ALL_SHAPES, ArchSpec, get_arch, list_archs, pad_vocab

__all__ = ["ALL_SHAPES", "ArchSpec", "get_arch", "list_archs", "pad_vocab"]
