"""The simulator core of the PyTorch / CUDA port (lane-major tensors)."""
from .engine import SimResult, run
from .metrics import summarize
from .params import SimParams, load_params
from .policy import DEFAULT_POINTS, N_POLICY_PARAMS, PolicyParams
from .state import SimState, Workload, container_schedule, init_state, used_resources
from .sweep import fleet_run, make_workload_batch
from .types import (
    INF_TICK,
    TICKS_PER_SECOND,
    ContainerStatus,
    PipeStatus,
    Priority,
)
from .workload import generate_workload, get_workload

__all__ = [
    "DEFAULT_POINTS",
    "INF_TICK",
    "N_POLICY_PARAMS",
    "TICKS_PER_SECOND",
    "ContainerStatus",
    "PipeStatus",
    "PolicyParams",
    "Priority",
    "SimParams",
    "SimResult",
    "SimState",
    "Workload",
    "container_schedule",
    "fleet_run",
    "generate_workload",
    "get_workload",
    "init_state",
    "load_params",
    "make_workload_batch",
    "run",
    "summarize",
    "used_resources",
]
