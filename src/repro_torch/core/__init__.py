"""The simulator core of the PyTorch / CUDA port (lane-major tensors)."""
from .engine import SimResult, run
from .faults import (
    attach_fault_trace,
    attach_fault_traces,
    empty_fault_trace,
    fault_trace_from_records,
    fault_trace_to_records,
    generate_fault_trace,
)
from .metrics import summarize
from .params import SimParams, load_params
from .policy import DEFAULT_POINTS, N_POLICY_PARAMS, PolicyParams
from .state import (
    FaultTrace,
    SimState,
    Workload,
    container_schedule,
    init_state,
    used_resources,
)
from .sweep import fleet_run, make_workload_batch
from .types import (
    INF_TICK,
    TICKS_PER_SECOND,
    ContainerStatus,
    Operator,
    Pipeline,
    PipeStatus,
    Priority,
)
from .workload import generate_workload, get_workload, workload_from_pipelines

__all__ = [
    "DEFAULT_POINTS",
    "INF_TICK",
    "N_POLICY_PARAMS",
    "Operator",
    "Pipeline",
    "TICKS_PER_SECOND",
    "ContainerStatus",
    "FaultTrace",
    "PipeStatus",
    "PolicyParams",
    "Priority",
    "SimParams",
    "SimResult",
    "SimState",
    "Workload",
    "attach_fault_trace",
    "attach_fault_traces",
    "container_schedule",
    "empty_fault_trace",
    "fault_trace_from_records",
    "fault_trace_to_records",
    "fleet_run",
    "generate_fault_trace",
    "generate_workload",
    "get_workload",
    "init_state",
    "load_params",
    "make_workload_batch",
    "run",
    "summarize",
    "used_resources",
    "workload_from_pipelines",
]
