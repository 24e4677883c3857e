from .registry import ArchSpec, get_arch, list_archs

__all__ = ["ArchSpec", "get_arch", "list_archs"]
