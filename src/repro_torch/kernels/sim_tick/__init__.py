from .ops import fleet_tick
from .ref import fleet_tick_ref

__all__ = ["fleet_tick", "fleet_tick_ref"]
