"""The simulator core of the PyTorch / CUDA port (lane-major tensors).

Public API mirrors the paper (§4.1): ``run_simulator(paramfile)``, the
``Scheduler`` class, the ``Failure`` / ``Assignment`` / ``Suspension`` /
``Pipeline`` records and the registration decorators of
``repro_torch.core.algorithm``, as ``repro.core`` exports them; every
entry point runs on CUDA unless the caller passes ``device="cpu"``.
"""
from .admission import (
    AdmissionView,
    has_admission_policy,
    list_admission_policies,
    register_admission_policy,
    register_admission_policy_py,
)
from .algorithm import register_scheduler, register_scheduler_init
from .engine import SimResult, run
from .engine_python import Scheduler
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
from .policy import DEFAULT_POINTS, N_POLICY_PARAMS, POLICY_BOUNDS, PolicyParams, policy_bounds
from .scheduler import (
    SchedDecision,
    get_fleet_vector_scheduler,
    get_policy_point,
    get_vector_scheduler,
    get_vector_scheduler_init,
    has_policy_point,
    has_vector_scheduler,
    mask_down_pools,
    policy_points,
    register_fleet_vector_scheduler,
    register_vector_scheduler,
    register_vector_scheduler_family,
    register_vector_scheduler_init,
)
from .state import (
    CLOSED_LOOP_FIELDS,
    FaultTrace,
    SimState,
    Workload,
    broadcast_lanes,
    cache_insert,
    container_schedule,
    init_state,
    used_resources,
)
from . import telemetry
from .telemetry import (
    EventKind,
    Span,
    TraceEvents,
    summarize_timeline,
    to_perfetto_json,
)
from .sweep import (
    attach_policies,
    fleet_run,
    fleet_summary,
    make_workload_batch,
    pad_lanes,
    policy_grid_workloads,
)
from .types import (
    INF_TICK,
    TICKS_PER_SECOND,
    Assignment,
    ContainerStatus,
    Failure,
    Operator,
    Pipeline,
    PipeStatus,
    Priority,
    Suspension,
)
# registers 'sjf' and 'sjf_ref', and the Python twins of 'sjf',
# 'cache_aware' and 'locality_pool'
from . import extra_schedulers  # noqa: E402,F401
from . import scenarios  # noqa: E402
from .scenarios import (  # noqa: E402
    SCENARIOS,
    get_scenario,
    list_scenarios,
    retry_storm_params,
    scenario_fleet,
    scenario_lane_batch,
    spot_churn_params,
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


def run_simulator(paramfile, **kw) -> SimResult:
    """Paper Listing 3 entry point: ``run(paramfile, **kw)``, on CUDA
    unless ``device="cpu"`` is passed."""
    return run(paramfile, **kw)


__all__ = [
    "AdmissionView",
    "Assignment",
    "Failure",
    "register_scheduler",
    "register_scheduler_init",
    "run_simulator",
    "Scheduler",
    "Suspension",
    "telemetry",
    "attach_fault_trace",
    "attach_fault_traces",
    "attach_policies",
    "broadcast_lanes",
    "cache_insert",
    "CLOSED_LOOP_FIELDS",
    "completion_table",
    "container_schedule",
    "ContainerStatus",
    "DEFAULT_POINTS",
    "empty_fault_trace",
    "EventKind",
    "fault_trace_from_records",
    "fault_trace_to_records",
    "FaultTrace",
    "fleet_lane_stats",
    "fleet_run",
    "fleet_summary",
    "generate_fault_trace",
    "generate_workload",
    "get_fleet_vector_scheduler",
    "get_policy_point",
    "get_scenario",
    "get_vector_scheduler",
    "get_vector_scheduler_init",
    "get_workload",
    "has_admission_policy",
    "has_policy_point",
    "has_vector_scheduler",
    "INF_TICK",
    "init_state",
    "list_admission_policies",
    "list_scenarios",
    "load_params",
    "load_trace",
    "make_workload_batch",
    "mask_down_pools",
    "N_POLICY_PARAMS",
    "Operator",
    "pad_lanes",
    "Pipeline",
    "PipeStatus",
    "POLICY_BOUNDS",
    "policy_bounds",
    "policy_grid_workloads",
    "policy_points",
    "PolicyParams",
    "Priority",
    "register_admission_policy",
    "register_admission_policy_py",
    "register_fleet_vector_scheduler",
    "register_vector_scheduler",
    "register_vector_scheduler_family",
    "register_vector_scheduler_init",
    "retry_storm_params",
    "run",
    "scenario_fleet",
    "scenario_lane_batch",
    "SCENARIOS",
    "scenarios",
    "SchedDecision",
    "SimParams",
    "SimResult",
    "SimState",
    "Span",
    "spot_churn_params",
    "summarize",
    "summarize_timeline",
    "TICKS_PER_SECOND",
    "to_perfetto_json",
    "TraceEvents",
    "used_resources",
    "Workload",
    "workload_batch_from_traces",
    "workload_from_pipelines",
    "workload_from_trace_records",
    "workload_to_trace_records",
]
