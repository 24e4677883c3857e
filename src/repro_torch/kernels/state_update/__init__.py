from .ops import assign_gather, retire_land
from .ref import assign_gather_ref, retire_land_ref

__all__ = [
    "assign_gather",
    "retire_land",
    "assign_gather_ref",
    "retire_land_ref",
]
