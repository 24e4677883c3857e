"""Core enumerations and the time base of the simulator.

A copy of the value types of ``repro.core.types`` (the port imports
nothing of the JAX package): the tick length, the priority levels and
the pipeline / container status codes that every ``SimState`` column
stores as int32. ``INF_TICK`` marks "never" in tick-valued columns.
``Operator`` and ``Pipeline`` are the trace records that
``workload.workload_from_pipelines`` packs, and with ``Failure``,
``Assignment`` and ``Suspension`` the plain Python objects that user
schedulers of the paper's Listing 4 read and return in the Python engine
(``engine_python.py``).
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Optional

import numpy as np

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
# Python-facing records (paper §3.2.1 and Listing 4), as in the reference.
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class Operator:
    """One function node of a pipeline DAG."""

    ram_gb: float          # max RAM required to avoid OOM
    base_ticks: float      # runtime at exactly 1 CPU (f32 ticks, may be fractional)
    alpha: float           # CPU-scaling exponent: t(c) = base / c**alpha
    level: int             # topological depth inside the pipeline DAG
    out_gb: float = 0.0    # intermediate output dataset size (data plane)

    def runtime_ticks(self, cpus: float) -> int:
        eff = max(float(cpus), 1e-6)
        return max(1, int(np.ceil(self.base_ticks / (eff ** self.alpha))))


@dataclasses.dataclass
class Pipeline:
    """User-submitted DAG of operators (paper §3.2.1)."""

    pid: int
    priority: Priority
    arrival_tick: int
    ops: list[Operator]
    # -- retry bookkeeping (priority scheduler, paper §4.1.2) --
    failed_before: bool = False
    last_cpus: float = 0.0
    last_ram_gb: float = 0.0

    @property
    def num_ops(self) -> int:
        return len(self.ops)

    @property
    def total_ram_gb(self) -> float:
        return float(sum(o.ram_gb for o in self.ops))

    @property
    def total_out_gb(self) -> float:
        """Total intermediate dataset bytes the pipeline materialises."""
        return float(sum(o.out_gb for o in self.ops))

    def level_ram(self) -> list[float]:
        if not self.ops:
            return [0.0]
        depth = max(o.level for o in self.ops) + 1
        out = [0.0] * depth
        for o in self.ops:
            out[o.level] += o.ram_gb
        return out


@dataclasses.dataclass
class Failure:
    """An executor-reported failure (OOM) from the previous tick."""

    pipeline: Pipeline
    tick: int
    cpus: float
    ram_gb: float
    reason: str = "oom"


@dataclasses.dataclass
class Assignment:
    """Scheduler -> Executor: create this container (paper §4.1.3 (2))."""

    pipeline: Pipeline
    pool: int
    cpus: float
    ram_gb: float
    # Optional subset of operator indices to run (None == whole pipeline).
    op_indices: Optional[list[int]] = None


@dataclasses.dataclass
class Suspension:
    """Scheduler -> Executor: preempt the container running this pipeline."""

    pipeline: Pipeline
    reason: str = "preempted"


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
    "Failure",
    "Assignment",
    "Suspension",
]
