"""repro_torch: the Eudoxia FaaS scheduling simulator on PyTorch and CUDA.

A port of the JAX package ``repro`` for one NVIDIA H100, with the same
layout. This slice runs the simulator's main path — ``run()`` and
``fleet_run()`` with every optional layer at its zero default, under the
``naive``, ``priority`` and ``priority_pool`` schedulers — through four
hand-written CUDA kernels (``kernels/``, sources in ``csrc/``). Entry
points run on CUDA unless the caller passes ``device="cpu"``, which runs
the kernels' plain PyTorch versions instead.
"""
from .core import (
    PolicyParams,
    SimParams,
    SimResult,
    SimState,
    Workload,
    fleet_run,
    generate_workload,
    load_params,
    make_workload_batch,
    run,
    summarize,
)

__all__ = [
    "PolicyParams",
    "SimParams",
    "SimResult",
    "SimState",
    "Workload",
    "fleet_run",
    "generate_workload",
    "load_params",
    "make_workload_batch",
    "run",
    "summarize",
]
