"""Workloads (paper §3.2.1): drawn with a ``torch.Generator``, or packed
from a trace of ``Pipeline`` records (``workload_from_pipelines``).

The whole arrival table is drawn up front from one seed, from the same
distributions as ``repro.core.workload.generate_workload``:

* inter-arrival ticks ~ Exponential(mean = waiting_ticks_mean)
* ops per pipeline    ~ 1 + Poisson(mean_ops_per_pipeline - 1), clipped
* DAG shape           ~ each op opens a new level w.p. chain_prob
* op RAM, op runtime  ~ LogNormal centred at their means
* op output dataset   ~ LogNormal, log-correlated with the runtime draw,
                        on a MiB grid (multiples of 2**-10 GB)
* CPU-scaling alpha   ~ Categorical(alpha_choices, alpha_probs)
* priority            ~ Categorical(priority_probs), with interactive and
                        query pipelines scaled shorter and smaller.

The reference draws with ``jax.random`` (threefry); a ``torch.Generator``
gives other numbers from the same seed, so the two packages' generators
agree in distribution only, never draw for draw. Comparisons between
the packages therefore feed both the same reference-built workload
(``repro_torch.bridge.workload_from_arrays``). The draws happen on the
CPU, so a seed gives the same workload whatever the device it is then
moved to.
"""
from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch

from .faults import attach_fault_trace
from .params import SimParams
from .state import Workload, workload_to
from .types import INF_TICK, TICKS_PER_SECOND, Pipeline

GB_QUANTUM = 1.0 / 1024.0


def generate_workload(
    params: SimParams, seed: int | None = None, *, device="cpu"
) -> Workload:
    """One seed-generated workload as a fleet of one (``[1, ...]``);
    ``seed`` defaults to ``params.seed``. With crashes, outages or
    stragglers on it carries the seed's fault trace (``core/faults.py``,
    drawn from generators of its own)."""
    seed = int(params.seed if seed is None else seed)
    g = torch.Generator().manual_seed(seed)
    MP, MO = params.max_pipelines, params.max_ops_per_pipeline
    f32, i32 = torch.float32, torch.int32

    # --- arrivals ----------------------------------------------------------
    gaps = torch.empty(MP, dtype=torch.float64).exponential_(generator=g)
    arrival = torch.cumsum(gaps * params.waiting_ticks_mean, 0)
    arrival = torch.where(
        arrival < params.horizon_ticks, arrival.floor(), float(INF_TICK)
    ).to(torch.int64).clamp_max(INF_TICK).to(i32)

    # --- priorities --------------------------------------------------------
    pprobs = torch.tensor(params.priority_probs, dtype=torch.float64)
    prio = torch.multinomial(pprobs, MP, replacement=True, generator=g).to(i32)

    # --- DAG shapes ---------------------------------------------------------
    lam = max(params.mean_ops_per_pipeline - 1.0, 0.0)
    n_ops = 1 + torch.poisson(torch.full((MP,), lam), generator=g).to(i32)
    n_ops = n_ops.clamp(1, MO)
    op_valid = torch.arange(MO, dtype=i32)[None, :] < n_ops[:, None]
    chains = torch.bernoulli(
        torch.full((MP, MO), float(params.chain_prob)), generator=g
    ).bool()
    chains[:, 0] = True
    op_level = torch.cumsum(chains, 1, dtype=i32) - 1
    op_level = torch.where(op_valid, op_level, 0)

    scale = torch.tensor(
        [1.0, params.query_scale, params.interactive_scale], dtype=f32
    )[prio.long()][:, None]

    # --- op RAM / runtime / output size / scaling --------------------------
    ram = (
        torch.exp(torch.randn((MP, MO), generator=g) * params.op_ram_gb_sigma)
        * params.op_ram_gb_mean * scale
    ).clamp_min(0.05)
    z_base = torch.randn((MP, MO), generator=g)
    base = (
        torch.exp(z_base * params.op_base_seconds_sigma)
        * params.op_base_seconds_mean * scale * TICKS_PER_SECOND
    ).clamp_min(1.0)
    rho = min(max(params.out_runtime_corr, -1.0), 1.0)
    z_out = torch.randn((MP, MO), generator=g)
    z_mix = rho * z_base + math.sqrt(max(1.0 - rho * rho, 0.0)) * z_out
    out = (
        torch.exp(z_mix * params.op_out_gb_sigma)
        * params.op_out_gb_mean * scale
    )
    out = torch.clamp_min(torch.round(out * 1024.0) / 1024.0, GB_QUANTUM)
    aprobs = torch.tensor(params.alpha_probs, dtype=torch.float64)
    alpha_ix = torch.multinomial(aprobs, MP * MO, replacement=True, generator=g)
    alpha = torch.tensor(params.alpha_choices, dtype=f32)[alpha_ix].reshape(MP, MO)

    op_out = torch.where(op_valid, out, 0.0).to(f32)
    wl = Workload(
        arrival=arrival,
        prio=prio,
        n_ops=n_ops,
        op_valid=op_valid,
        op_level=op_level.to(i32),
        op_ram=torch.where(op_valid, ram, 0.0).to(f32),
        op_base=torch.where(op_valid, base, 0.0).to(f32),
        op_alpha=torch.where(op_valid, alpha, 0.0).to(f32),
        op_out=op_out,
        pipe_out=op_out.sum(1, dtype=f32),
    )
    wl = Workload(*(x[None] for x in wl[:10]))
    if params.fault_trace_active:
        wl = attach_fault_trace(wl, params, seed)
    return workload_to(wl, device)


def _op_out_gb_quantized(out_gb: float) -> float:
    """An operator's output size on the MiB grid; 0 stays 0 so that
    data-plane-free traces remain inert."""
    if out_gb > 0:
        return max(round(out_gb * 1024.0) / 1024.0, GB_QUANTUM)
    return 0.0


def workload_from_pipelines(pipelines: Sequence[Pipeline], params: SimParams) -> Workload:
    """Pack a trace of ``Pipeline`` records into a workload, as a fleet
    of one (``[1, ...]``) on the CPU; ``run`` moves it to its device."""
    MP, MO = params.max_pipelines, params.max_ops_per_pipeline
    if len(pipelines) > MP:
        raise ValueError(f"trace has {len(pipelines)} pipelines > capacity {MP}")
    arrival = np.full((MP,), INF_TICK, np.int32)
    prio = np.zeros((MP,), np.int32)
    n_ops = np.zeros((MP,), np.int32)
    op_valid = np.zeros((MP, MO), bool)
    op_level = np.zeros((MP, MO), np.int32)
    op_ram = np.zeros((MP, MO), np.float32)
    op_base = np.zeros((MP, MO), np.float32)
    op_alpha = np.zeros((MP, MO), np.float32)
    op_out = np.zeros((MP, MO), np.float32)
    for i, p in enumerate(pipelines):
        if len(p.ops) > MO:
            raise ValueError(f"pipeline {p.pid} has {len(p.ops)} ops > {MO}")
        arrival[i] = p.arrival_tick
        prio[i] = int(p.priority)
        n_ops[i] = len(p.ops)
        for j, o in enumerate(p.ops):
            op_valid[i, j] = True
            op_level[i, j] = o.level
            op_ram[i, j] = o.ram_gb
            op_base[i, j] = o.base_ticks
            op_alpha[i, j] = o.alpha
            op_out[i, j] = _op_out_gb_quantized(o.out_gb)
    fields = (arrival, prio, n_ops, op_valid, op_level, op_ram, op_base, op_alpha,
              op_out, op_out.sum(axis=1, dtype=np.float32))
    return Workload(*(torch.from_numpy(a)[None] for a in fields))


def get_workload(params: SimParams, *, device="cpu") -> Workload:
    """The workload ``params`` describes: a trace file (a later slice)
    or the seed generator."""
    if params.trace_path:
        raise NotImplementedError(
            "trace ingestion (trace_path) waits for ROADMAP queue 1, item 3"
        )
    return generate_workload(params, device=device)


__all__ = ["generate_workload", "get_workload", "workload_from_pipelines", "GB_QUANTUM"]
