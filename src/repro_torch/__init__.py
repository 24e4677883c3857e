"""repro_torch: the Eudoxia FaaS scheduling simulator on PyTorch and CUDA.

A port of the JAX package ``repro`` for one NVIDIA H100, with the same
layout. It runs the simulator — ``run()`` and ``fleet_run()`` under every
registered scheduler (the six named ones, their ``*_ref`` oracles, a
per-lane policy grid under ``"policy"``, and schedulers users register),
with the chaos layer (crashes, outages, stragglers, timeouts, retries),
the data plane (cold starts, scan cost, zero-copy caches) and the
overload layer (closed-loop clients, the four admission policies, drain
and metastability) on or off, from seeds, from recorded traces
(``load_trace``, ``workload_batch_from_traces``) or from the scenario
library (``core.scenarios``: ``scenario_fleet``), with event tracing
(``run(trace=True)``, ``core.telemetry``) on or off, and a policy search
over fleets (``repro_torch.search``: ``cem_search``) — through four
hand-written CUDA kernels, and serving (``launch/serve.py``: the
simulator picks the policy, ``serving/`` batches requests through
``models/`` for every architecture of ``configs/``: the decoder-only
LMs, MoE, hybrid and RWKV stacks, ``internvl2_2b``'s stubbed vision
frontend, and ``whisper_small``'s encoder-decoder through
``runtime.make_serve_steps``) through three more (``kernels/``,
sources in ``csrc/``). The paper's surface is here
too: ``run_simulator`` (Listing 3), user schedulers of Listing 4 on the
reference Python engine (``run(engine="python")``,
``core/engine_python.py``), ``core/viz.py``, the CLI
``python -m repro_torch.launch.sim`` and the ``eudoxia_torch`` facade.
Entry points run on CUDA unless the caller passes ``device="cpu"``,
which runs the kernels' plain PyTorch versions instead.
"""
from .core import (
    DEFAULT_POINTS,
    AdmissionView,
    PolicyParams,
    SimParams,
    SimResult,
    Scheduler,
    SimState,
    Workload,
    attach_policies,
    broadcast_lanes,
    completion_table,
    fleet_lane_stats,
    fleet_run,
    fleet_summary,
    generate_workload,
    has_admission_policy,
    list_admission_policies,
    list_scenarios,
    load_params,
    load_trace,
    make_workload_batch,
    pad_lanes,
    policy_grid_workloads,
    register_admission_policy,
    register_admission_policy_py,
    register_scheduler,
    register_scheduler_init,
    register_vector_scheduler,
    register_vector_scheduler_family,
    register_vector_scheduler_init,
    retry_storm_params,
    run,
    run_simulator,
    scenario_fleet,
    scenario_lane_batch,
    summarize,
    workload_batch_from_traces,
    workload_from_trace_records,
    workload_to_trace_records,
)

__all__ = [
    "AdmissionView",
    "DEFAULT_POINTS",
    "PolicyParams",
    "SimParams",
    "SimResult",
    "Scheduler",
    "SimState",
    "Workload",
    "attach_policies",
    "broadcast_lanes",
    "completion_table",
    "fleet_lane_stats",
    "fleet_run",
    "fleet_summary",
    "generate_workload",
    "has_admission_policy",
    "list_admission_policies",
    "list_scenarios",
    "load_params",
    "load_trace",
    "make_workload_batch",
    "pad_lanes",
    "policy_grid_workloads",
    "register_admission_policy",
    "register_admission_policy_py",
    "register_scheduler",
    "register_scheduler_init",
    "register_vector_scheduler",
    "register_vector_scheduler_family",
    "register_vector_scheduler_init",
    "retry_storm_params",
    "run",
    "run_simulator",
    "scenario_fleet",
    "scenario_lane_batch",
    "summarize",
    "workload_batch_from_traces",
    "workload_from_trace_records",
    "workload_to_trace_records",
]
