"""Eudoxia <-> serving bridge: the simulator as the serving runtime's
scheduling component, a port of ``repro.serving.bridge``.

An inference request is a two-operator pipeline in Eudoxia's terms:

* prefill: compute-bound; runtime scales ~linearly with allocated
  compute (alpha ~ 1), RAM ~ KV cache for the prompt;
* decode: memory-bound sequential generation; does not scale with
  extra compute (alpha ~ 0), runtime ~ new_tokens x per-token latency.

``requests_to_pipelines`` turns a request trace into pipelines
(INTERACTIVE for chat, BATCH for offline jobs); ``evaluate_policies``
replays the trace under each candidate scheduler in the port's
simulator (``repro_torch.core.run``, on CUDA unless the caller asks for
the CPU) and returns the summaries; ``pick_policy`` chooses one.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Sequence

from ..core import (
    TICKS_PER_SECOND,
    Operator,
    Pipeline,
    Priority,
    SimParams,
    run,
    workload_from_pipelines,
)


@dataclasses.dataclass(frozen=True)
class ServeRequest:
    arrival_s: float
    prompt_tokens: int
    new_tokens: int
    interactive: bool = True


def _kv_gb(cfg_like, tokens: int) -> float:
    """KV-cache GB for `tokens` (per request)."""
    L = getattr(cfg_like, "n_layers", 32)
    kv = getattr(cfg_like, "n_kv_heads", 8)
    hd = getattr(cfg_like, "hd", 128)
    return 2 * L * kv * hd * tokens * 2 / 1e9


def requests_to_pipelines(
    requests: Sequence[ServeRequest],
    cfg_like,
    *,
    prefill_tok_per_s_per_cpu: float = 4000.0,
    decode_tok_per_s: float = 50.0,
) -> list[Pipeline]:
    """Map a request trace onto pipelines (one per request): prefill
    scales with compute (alpha = 1), decode does not (alpha = 0)."""
    out = []
    for i, r in enumerate(requests):
        prefill_s = r.prompt_tokens / prefill_tok_per_s_per_cpu
        decode_s = r.new_tokens / decode_tok_per_s
        ram = max(_kv_gb(cfg_like, r.prompt_tokens + r.new_tokens), 0.05)
        ops = [
            Operator(ram_gb=ram, base_ticks=max(int(prefill_s * TICKS_PER_SECOND), 1),
                     alpha=1.0, level=0),
            Operator(ram_gb=ram, base_ticks=max(int(decode_s * TICKS_PER_SECOND), 1),
                     alpha=0.0, level=1),
        ]
        out.append(Pipeline(
            pid=i,
            priority=Priority.INTERACTIVE if r.interactive else Priority.BATCH,
            arrival_tick=int(r.arrival_s * TICKS_PER_SECOND),
            ops=ops,
        ))
    return out


def evaluate_policies(
    requests: Sequence[ServeRequest],
    cfg_like,
    *,
    duration_s: float = 10.0,
    total_cpus: float = 64.0,
    total_ram_gb: float = 128.0,
    policies: Sequence[str] = ("naive", "priority", "priority_pool"),
    num_pools: int = 2,
    device: Any = "cuda",
) -> dict[str, dict]:
    """Replay the trace under each scheduling policy on ``device``;
    returns each policy's summary."""
    results = {}
    for policy in policies:
        params = SimParams(
            duration=duration_s,
            scheduling_algo=policy,
            num_pools=num_pools if policy == "priority_pool" else 1,
            total_cpus=total_cpus,
            total_ram_gb=total_ram_gb,
            max_pipelines=max(64, len(requests)),
            max_containers=128,
        )
        wl = workload_from_pipelines(requests_to_pipelines(requests, cfg_like), params)
        results[policy] = run(params, workload=wl, device=device).summary()
    return results


def pick_policy(results: dict[str, dict]) -> str:
    """Choose the policy: lowest interactive latency, ties by throughput."""
    def key(name):
        s = results[name]
        lat = s["per_priority"]["interactive"]["mean_latency_s"]
        lat = float("inf") if lat != lat else lat  # NaN -> inf
        return (lat, -s["throughput_per_s"])

    return min(results, key=key)


__all__ = [
    "ServeRequest",
    "evaluate_policies",
    "pick_policy",
    "requests_to_pipelines",
]
