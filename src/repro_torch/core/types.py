"""Core enumerations and the time base of the simulator.

A copy of the value types of ``repro.core.types`` (the port imports
nothing of the JAX package): the tick length, the priority levels and
the pipeline / container status codes that every ``SimState`` column
stores as int32. ``INF_TICK`` marks "never" in tick-valued columns.
"""
from __future__ import annotations

import enum

# one loop iteration == 1 tick ~= 10 microseconds (paper §3.2)
TICK_SECONDS: float = 10e-6
TICKS_PER_SECOND: int = int(round(1.0 / TICK_SECONDS))  # 100_000

# "never" in int32 tick columns
INF_TICK: int = 2**31 - 1


class Priority(enum.IntEnum):
    """Ascending priority order (paper §3.2.1 / §4.1.2)."""

    BATCH = 0
    QUERY = 1
    INTERACTIVE = 2


class PipeStatus(enum.IntEnum):
    EMPTY = 0      # slot unused / pipeline has not arrived yet
    PENDING = 1
    WAITING = 2    # in the scheduler's waiting queue
    RUNNING = 3    # assigned to a live container
    SUSPENDED = 4  # preempted; sits 1 tick in the suspending queue
    DONE = 5
    FAILED = 6     # permanently failed back to the user


class ContainerStatus(enum.IntEnum):
    EMPTY = 0
    RUNNING = 1


N_PRIO = len(Priority)

__all__ = [
    "TICK_SECONDS",
    "TICKS_PER_SECOND",
    "INF_TICK",
    "N_PRIO",
    "Priority",
    "PipeStatus",
    "ContainerStatus",
]
