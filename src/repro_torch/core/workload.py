"""Workload generation (paper §3.2.1), drawn with a ``torch.Generator``.

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

import torch

from .params import SimParams
from .state import Workload
from .types import INF_TICK, TICKS_PER_SECOND

GB_QUANTUM = 1.0 / 1024.0


def generate_workload(
    params: SimParams, seed: int | None = None, *, device="cpu"
) -> Workload:
    """One seed-generated workload as a fleet of one (``[1, ...]``);
    ``seed`` defaults to ``params.seed``."""
    if params.fault_trace_active:
        raise NotImplementedError(
            "fault traces wait for the chaos-layer slice (ROADMAP queue 1, "
            "item 10)"
        )
    g = torch.Generator().manual_seed(int(params.seed if seed is None else seed))
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
    return Workload(*(x[None].to(device) for x in wl[:10]))


def get_workload(params: SimParams, *, device="cpu") -> Workload:
    """The workload ``params`` describes: a trace file (a later slice)
    or the seed generator."""
    if params.trace_path:
        raise NotImplementedError(
            "trace ingestion (trace_path) waits for ROADMAP queue 1, item 3"
        )
    return generate_workload(params, device=device)


__all__ = ["generate_workload", "get_workload", "GB_QUANTUM"]
