from .registry import ArchSpec, get_arch, list_archs, pad_vocab

__all__ = ["ArchSpec", "get_arch", "list_archs", "pad_vocab"]
