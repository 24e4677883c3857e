"""Simulation parameters and TOML loading (paper §4.1.1).

The port's own copy of ``repro.core.params.SimParams``: the same
fields, defaults and derived properties, so one parameter file drives
both packages. Python 3.12 parses TOML with the standard ``tomllib``.
"""
from __future__ import annotations

import dataclasses
import pathlib
import tomllib
from typing import Any

from .types import TICKS_PER_SECOND


@dataclasses.dataclass(frozen=True)
class SimParams:
    # ---- paper-named core knobs (§4.1.1) ----------------------------------
    duration: float = 1.0              # simulated SECONDS
    waiting_ticks_mean: float = 5_000  # mean ticks between pipeline arrivals
    num_pools: int = 1
    scheduling_algo: str = "priority"

    # ---- resources (executor, §3.2.2) --------------------------------------
    total_cpus: float = 16.0           # summed over all pools
    total_ram_gb: float = 32.0         # summed over all pools
    cloud_scaling: bool = False
    cloud_scale_max_factor: float = 2.0
    cloud_cost_per_cpu_second: float = 0.000011
    cloud_premium_factor: float = 1.5

    # ---- workload generator (§3.2.1) ---------------------------------------
    seed: int = 0
    max_pipelines: int = 256
    max_ops_per_pipeline: int = 8
    mean_ops_per_pipeline: float = 3.0
    chain_prob: float = 0.65
    op_ram_gb_mean: float = 2.0
    op_ram_gb_sigma: float = 0.6
    op_base_seconds_mean: float = 0.5
    op_base_seconds_sigma: float = 0.8
    alpha_choices: tuple[float, ...] = (0.0, 0.5, 1.0)
    alpha_probs: tuple[float, ...] = (0.25, 0.35, 0.40)
    priority_probs: tuple[float, ...] = (0.6, 0.25, 0.15)
    interactive_scale: float = 0.15
    query_scale: float = 0.5

    # ---- data plane (intermediate datasets, caches, warm starts) -----------
    op_out_gb_mean: float = 1.0
    op_out_gb_sigma: float = 0.6
    out_runtime_corr: float = 0.5
    cache_gb_per_pool: float = 0.0
    scan_ticks_per_gb: float = 0.0
    cold_start_ticks: int = 0
    container_warm_ticks: int = 20_000

    # ---- fault injection + retry policy (all zero-default = off) -----------
    crash_mtbf_ticks: float = 0.0
    outage_mtbf_ticks: float = 0.0
    outage_duration_ticks: float = 0.0
    straggler_prob: float = 0.0
    straggler_factor: float = 4.0
    timeout_ticks: int = 0
    max_retries: int = 0
    base_backoff_ticks: int = 0
    max_fault_events: int = 64
    slo_latency_s: tuple[float, ...] = (0.0, 0.0, 0.0)

    # ---- closed-loop clients + admission control (all zero-default = off) --
    client_max_inflight: int = 0
    client_think_ticks: int = 0
    client_max_retries: int = 0
    client_backoff_ticks: int = 0
    admission_policy: str = "admit_all"
    admit_queue_limit: int = 0
    admit_rate_per_s: float = 0.0
    admit_burst: float = 0.0
    codel_target_ticks: int = 0
    codel_interval_ticks: int = 0
    metastable_window_ticks: int = 0

    # ---- engine -------------------------------------------------------------
    engine: str = "event"
    max_containers: int = 64
    max_assignments_per_tick: int = 16
    util_log_buckets: int = 512
    trace_path: str = ""

    # -------------------------------------------------------------------------
    @property
    def horizon_ticks(self) -> int:
        return int(round(self.duration * TICKS_PER_SECOND))

    @property
    def data_plane_active(self) -> bool:
        return (
            self.cache_gb_per_pool > 0
            or self.scan_ticks_per_gb > 0
            or self.cold_start_ticks > 0
        )

    @property
    def faults_active(self) -> bool:
        return (
            self.fault_events_active
            or self.straggler_prob > 0
            or self.timeout_ticks > 0
        )

    @property
    def fault_events_active(self) -> bool:
        return self.crash_mtbf_ticks > 0 or self.outage_mtbf_ticks > 0

    @property
    def fault_trace_active(self) -> bool:
        return (
            self.crash_mtbf_ticks > 0
            or self.outage_mtbf_ticks > 0
            or self.straggler_prob > 0
        )

    @property
    def client_loop_active(self) -> bool:
        return (
            self.client_max_inflight > 0
            or self.client_think_ticks > 0
            or self.client_max_retries > 0
            or self.client_backoff_ticks > 0
        )

    @property
    def admission_active(self) -> bool:
        return (
            self.admission_policy.replace("-", "_").lower() != "admit_all"
        )

    @property
    def closed_loop_active(self) -> bool:
        return self.client_loop_active or self.admission_active

    @property
    def pool_cpus(self) -> float:
        return self.total_cpus / self.num_pools

    @property
    def pool_ram_gb(self) -> float:
        return self.total_ram_gb / self.num_pools

    def replace(self, **kw: Any) -> "SimParams":
        return dataclasses.replace(self, **kw)

    # -------------------------------------------------------------------------
    @staticmethod
    def from_toml(path: str | pathlib.Path) -> "SimParams":
        raw = tomllib.loads(pathlib.Path(path).read_text())
        return SimParams.from_dict(raw)

    @staticmethod
    def from_dict(raw: dict[str, Any]) -> "SimParams":
        fields = {f.name: f for f in dataclasses.fields(SimParams)}
        kw: dict[str, Any] = {}
        for key, value in raw.items():
            k = key.lower()
            if k not in fields:
                raise KeyError(
                    f"unknown Eudoxia parameter {key!r}; "
                    f"known: {sorted(fields)}"
                )
            ftype = fields[k].type
            if isinstance(value, list):
                value = tuple(value)
            if ftype in ("float", float) and isinstance(value, int):
                value = float(value)
            kw[k] = value
        return SimParams(**kw)


def load_params(paramfile: str | pathlib.Path | dict | SimParams) -> SimParams:
    if isinstance(paramfile, SimParams):
        return paramfile
    if isinstance(paramfile, dict):
        return SimParams.from_dict(paramfile)
    return SimParams.from_toml(paramfile)


__all__ = ["SimParams", "load_params"]
