"""Workloads (paper §3.2.1): drawn with a ``torch.Generator``, or packed
from a trace of ``Pipeline`` records (``workload_from_pipelines``) or of
pipeline records as JSON / TOML (``load_trace``,
``workload_from_trace_records``; one trace per fleet lane with
``workload_batch_from_traces``); ``workload_to_trace_records`` is the
exact inverse. The schema is docs/trace-format.md.

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

Trace ingestion fills numpy arrays as the reference does (the same
record helpers, the same float32 / int32 stores, ``pipe_out`` summed in
numpy) and makes tensors only at the end, so every field equals the
reference's bit for bit.
"""
from __future__ import annotations

import json
import math
import pathlib
import tomllib
from typing import Any, Sequence

import numpy as np
import torch

from .faults import attach_fault_trace
from .params import SimParams
from .state import Workload, tree_map, workload_lane, workload_to
from .types import INF_TICK, TICKS_PER_SECOND, Operator, Pipeline, Priority

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
    wl = tree_map(lambda x: x[None], wl)
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


# --- record fields, shared by the single-lane (Pipeline objects) and the
# --- batched (array-filling) ingestion, so both store the same bits
def _rec_arrival_tick(rec: dict[str, Any]) -> int:
    """``arrival_tick`` (exact) wins over ``arrival_s``; either is clamped
    to INF_TICK, which marks a reserved slot that never arrives."""
    if "arrival_tick" in rec:
        return min(int(rec["arrival_tick"]), int(INF_TICK))
    return min(int(round(float(rec["arrival_s"]) * TICKS_PER_SECOND)), int(INF_TICK))


def _rec_priority(rec: dict[str, Any]) -> Priority:
    pri = rec.get("priority", "QUERY")
    if isinstance(pri, str):
        pri = Priority[pri.upper()]
    return Priority(int(pri))


def _op_base_ticks(o: dict[str, Any]) -> float:
    """``base_ticks`` (exact f32 ticks) wins over ``base_s``, which is
    rounded to the tick grid."""
    if "base_ticks" in o:
        return float(o["base_ticks"])
    return float(int(round(float(o["base_s"]) * TICKS_PER_SECOND)))


def load_trace(path: str | pathlib.Path, params: SimParams) -> Workload:
    """A trace file as a fleet of one on the CPU: JSON (a list of
    records, or ``{"pipeline(s)": [...]}``) or TOML (``.toml``,
    ``[[pipeline]]`` tables with nested ``[[pipeline.ops]]``)."""
    p = pathlib.Path(path)
    text = p.read_text()
    if p.suffix.lower() == ".toml":
        raw = tomllib.loads(text)
        records = raw.get("pipeline", raw.get("pipelines"))
        if records is None:
            raise ValueError(f"TOML trace {p} has no [[pipeline]] tables")
    else:
        raw = json.loads(text)
        if isinstance(raw, dict):
            records = raw.get("pipeline", raw.get("pipelines"))
            if records is None:
                raise ValueError(
                    f"JSON trace {p} is an object without a 'pipeline(s)' "
                    "key (expected a list of records or {'pipeline': [...]})"
                )
        else:
            records = raw
    return workload_from_trace_records(records, params)


def workload_from_trace_records(
    records: Sequence[dict[str, Any]], params: SimParams
) -> Workload:
    """One trace (a sequence of pipeline records) as a fleet of one on the
    CPU, shaped by ``params``' capacities."""
    pipelines = [
        Pipeline(
            pid=i,
            priority=_rec_priority(rec),
            arrival_tick=_rec_arrival_tick(rec),
            ops=[
                Operator(
                    ram_gb=float(o["ram_gb"]),
                    base_ticks=_op_base_ticks(o),
                    alpha=float(o.get("alpha", 0.5)),
                    level=int(o.get("level", j)),
                    out_gb=float(o.get("out_gb", 0.0)),
                )
                for j, o in enumerate(rec["ops"])
            ],
        )
        for i, rec in enumerate(records)
    ]
    return workload_from_pipelines(pipelines, params)


def workload_to_trace_records(wl: Workload) -> list[dict[str, Any]]:
    """The exact inverse of trace ingestion, for one lane (per-lane
    shapes, or a fleet of one): the seconds fields beside the exact
    ``arrival_tick`` / ``base_ticks`` that ingestion prefers, reserved
    slots (never arriving, but with ops) at ``arrival_tick = 2**31 - 1``,
    empty trailing slots trimmed."""
    if wl.arrival.dim() == 2:
        if wl.arrival.shape[0] != 1:
            raise ValueError(
                f"workload_to_trace_records takes one lane, got {wl.arrival.shape[0]}"
            )
        wl = workload_lane(wl, 0)
    arrival, prio, n_ops, op_level, op_ram, op_base, op_alpha, op_out = (
        x.detach().cpu().numpy() for x in (
            wl.arrival, wl.prio, wl.n_ops, wl.op_level, wl.op_ram, wl.op_base,
            wl.op_alpha, wl.op_out))
    live = (arrival < INF_TICK) | (n_ops > 0) | (prio != 0)
    last = int(np.max(np.nonzero(live)[0])) if live.any() else -1
    records: list[dict[str, Any]] = []
    for i in range(last + 1):
        ops = []
        for j in range(int(n_ops[i])):
            base = float(op_base[i, j])
            ops.append({
                "ram_gb": float(op_ram[i, j]),
                "base_s": base / TICKS_PER_SECOND,
                "base_ticks": base,
                "alpha": float(op_alpha[i, j]),
                "level": int(op_level[i, j]),
                "out_gb": float(op_out[i, j]),
            })
        tick = int(arrival[i])
        records.append({
            "arrival_s": tick / TICKS_PER_SECOND,
            "arrival_tick": tick,
            "priority": Priority(int(prio[i])).name,
            "ops": ops,
        })
    return records


def workload_batch_from_traces(
    records_per_lane: Sequence[Sequence[dict[str, Any]]], params: SimParams
) -> tuple[Workload, SimParams]:
    """One trace per fleet lane, filled in one pass over the records:
    ``(workloads, params)`` for ``fleet_run(params,
    workloads=workloads)``. Lane ``i`` equals
    ``workload_from_trace_records(records_per_lane[i], params)``.
    ``max_pipelines`` / ``max_ops_per_pipeline`` of 0 take the batch's
    maxima (the returned params carry them); positive ones are checked
    against them."""
    lanes = [list(recs) for recs in records_per_lane]
    L = len(lanes)
    if L == 0:
        raise ValueError("records_per_lane is empty: a batch needs >= 1 lane")
    need_mp = max(1, max(len(recs) for recs in lanes))
    need_mo = max(1, max((len(r["ops"]) for recs in lanes for r in recs), default=1))
    MP = params.max_pipelines if params.max_pipelines > 0 else need_mp
    MO = params.max_ops_per_pipeline if params.max_ops_per_pipeline > 0 else need_mo
    if need_mp > MP:
        raise ValueError(
            f"a lane has {need_mp} pipelines > capacity {MP} "
            "(set max_pipelines=0 to derive it from the traces)"
        )
    if need_mo > MO:
        raise ValueError(
            f"a pipeline has {need_mo} ops > capacity {MO} "
            "(set max_ops_per_pipeline=0 to derive it from the traces)"
        )
    if (MP, MO) != (params.max_pipelines, params.max_ops_per_pipeline):
        params = params.replace(max_pipelines=MP, max_ops_per_pipeline=MO)

    arrival = np.full((L, MP), INF_TICK, np.int32)
    prio = np.zeros((L, MP), np.int32)
    n_ops = np.zeros((L, MP), np.int32)
    op_level = np.zeros((L, MP, MO), np.int32)
    op_ram = np.zeros((L, MP, MO), np.float32)
    op_base = np.zeros((L, MP, MO), np.float32)
    op_alpha = np.zeros((L, MP, MO), np.float32)
    op_out = np.zeros((L, MP, MO), np.float32)
    for lane, recs in enumerate(lanes):
        for i, rec in enumerate(recs):
            arrival[lane, i] = _rec_arrival_tick(rec)
            prio[lane, i] = int(_rec_priority(rec))
            ops = rec["ops"]   # required: a misspelt key fails here
            n_ops[lane, i] = len(ops)
            for j, o in enumerate(ops):
                op_level[lane, i, j] = int(o.get("level", j))
                op_ram[lane, i, j] = float(o["ram_gb"])
                op_base[lane, i, j] = _op_base_ticks(o)
                op_alpha[lane, i, j] = float(o.get("alpha", 0.5))
                op_out[lane, i, j] = _op_out_gb_quantized(float(o.get("out_gb", 0.0)))
    op_valid = np.arange(MO, dtype=np.int32)[None, None, :] < n_ops[:, :, None]
    fields = (arrival, prio, n_ops, op_valid, op_level, op_ram, op_base, op_alpha,
              op_out, op_out.sum(axis=-1, dtype=np.float32))
    return Workload(*(torch.from_numpy(a) for a in fields)), params


def get_workload(params: SimParams, *, device="cpu") -> Workload:
    """The workload ``params`` describes: the trace at ``trace_path``, or
    the seed generator."""
    if params.trace_path:
        return workload_to(load_trace(params.trace_path, params), device)
    return generate_workload(params, device=device)


__all__ = [
    "GB_QUANTUM",
    "generate_workload",
    "get_workload",
    "load_trace",
    "workload_batch_from_traces",
    "workload_from_pipelines",
    "workload_from_trace_records",
    "workload_to_trace_records",
]
