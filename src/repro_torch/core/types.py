"""Core enumerations and the time base of the simulator.

A copy of the value types of ``repro.core.types`` (the port imports
nothing of the JAX package): the tick length, the priority levels and
the pipeline / container status codes that every ``SimState`` column
stores as int32. ``INF_TICK`` marks "never" in tick-valued columns.
``Operator`` and ``Pipeline`` are the trace records that
``workload.workload_from_pipelines`` packs (the Python scheduler's retry
bookkeeping on ``Pipeline`` comes with ``engine="python"``, ROADMAP
queue 1, item 14).
"""
from __future__ import annotations

import dataclasses
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


# ---------------------------------------------------------------------------
# Python-facing records of a trace (paper §3.2.1), as in the reference.
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class Operator:
    """One function node of a pipeline DAG."""

    ram_gb: float          # max RAM required to avoid OOM
    base_ticks: float      # runtime at exactly 1 CPU (f32 ticks, may be fractional)
    alpha: float           # CPU-scaling exponent: t(c) = base / c**alpha
    level: int             # topological depth inside the pipeline DAG
    out_gb: float = 0.0    # intermediate output dataset size (data plane)


@dataclasses.dataclass
class Pipeline:
    """User-submitted DAG of operators (paper §3.2.1)."""

    pid: int
    priority: Priority
    arrival_tick: int
    ops: list[Operator]


__all__ = [
    "TICK_SECONDS",
    "TICKS_PER_SECOND",
    "INF_TICK",
    "N_PRIO",
    "Priority",
    "PipeStatus",
    "ContainerStatus",
    "Operator",
    "Pipeline",
]
