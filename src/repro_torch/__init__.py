"""repro_torch: the Eudoxia FaaS scheduling simulator on PyTorch and CUDA.

A port of the JAX package ``repro`` for one NVIDIA H100, with the same
layout. It runs the simulator — ``run()`` and ``fleet_run()`` under the
``naive``, ``priority`` and ``priority_pool`` schedulers, with the chaos
layer (crashes, outages, stragglers, timeouts, retries) on or off and
the other optional layers at their zero defaults — through four
hand-written CUDA kernels, and serving (``launch/serve.py``: the
simulator picks the policy, ``serving/`` batches requests through
``models/`` for ``rwkv6_7b``, ``gemma3_12b`` and jamba) through three
more (``kernels/``, sources in ``csrc/``). Entry points run on CUDA unless
the caller passes ``device="cpu"``, which runs the kernels' plain
PyTorch versions instead.
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
