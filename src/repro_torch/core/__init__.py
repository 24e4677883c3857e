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
from .metrics import completion_table, fleet_lane_stats, summarize
from .params import SimParams, load_params
from .policy import DEFAULT_POINTS, N_POLICY_PARAMS, PolicyParams
from .state import (
    FaultTrace,
    SimState,
    Workload,
    broadcast_lanes,
    container_schedule,
    init_state,
    used_resources,
)
from .sweep import fleet_run, fleet_summary, make_workload_batch, pad_lanes
from .types import (
    INF_TICK,
    TICKS_PER_SECOND,
    ContainerStatus,
    Operator,
    Pipeline,
    PipeStatus,
    Priority,
)
from .workload import (
    generate_workload,
    get_workload,
    load_trace,
    workload_batch_from_traces,
    workload_from_pipelines,
    workload_from_trace_records,
    workload_to_trace_records,
)

__all__ = [
    "ContainerStatus",
    "DEFAULT_POINTS",
    "FaultTrace",
    "INF_TICK",
    "N_POLICY_PARAMS",
    "Operator",
    "PipeStatus",
    "Pipeline",
    "PolicyParams",
    "Priority",
    "SimParams",
    "SimResult",
    "SimState",
    "TICKS_PER_SECOND",
    "Workload",
    "attach_fault_trace",
    "attach_fault_traces",
    "broadcast_lanes",
    "completion_table",
    "container_schedule",
    "empty_fault_trace",
    "fault_trace_from_records",
    "fault_trace_to_records",
    "fleet_lane_stats",
    "fleet_run",
    "fleet_summary",
    "generate_fault_trace",
    "generate_workload",
    "get_workload",
    "init_state",
    "load_params",
    "load_trace",
    "make_workload_batch",
    "pad_lanes",
    "run",
    "summarize",
    "used_resources",
    "workload_batch_from_traces",
    "workload_from_pipelines",
    "workload_from_trace_records",
    "workload_to_trace_records",
]
