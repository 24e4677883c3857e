"""Failure injection, straggler detection, and the checkpoint-cadence
advice: a copy of ``repro.runtime.failures`` (numpy only), for the port's
train loop.

At 1000+ nodes, mean-time-between-failures is hours, not days; the
runtime must (a) detect dead/slow hosts, (b) restart from the newest
checkpoint, and (c) choose a checkpoint cadence that balances write cost
against expected lost work. (c) is answered by
``advise_checkpoint_cadence`` with a small purpose-built replay of the
failure/restart process — deterministic, but NOT a run of the Eudoxia
engine (see its docstring).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass
class FailureInjector:
    """Deterministic failure schedule for chaos testing the train loop."""

    seed: int = 0
    mtbf_steps: float = 200.0   # mean steps between injected failures
    max_failures: int = 3

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        gaps = rng.exponential(self.mtbf_steps, size=self.max_failures)
        self.schedule = np.cumsum(np.maximum(gaps, 2.0)).astype(int).tolist()
        self._injected = 0

    def should_fail(self, step: int) -> bool:
        if self._injected >= self.max_failures:
            return False
        if self.schedule[self._injected] <= step:
            self._injected += 1
            return True
        return False


@dataclasses.dataclass
class StragglerMonitor:
    """EWMA step-time monitor; flags steps slower than k x the average.

    On real pods this drives hot-spare swap / mesh shrink; here the train
    loop counts the steps it flags.
    """

    alpha: float = 0.1
    threshold: float = 2.0
    warmup: int = 3

    def __post_init__(self):
        self.ewma: Optional[float] = None
        self.n = 0
        self.flagged: list[tuple[int, float]] = []

    def observe(self, step: int, dt: float) -> bool:
        self.n += 1
        if self.ewma is None:
            self.ewma = dt
            return False
        is_straggler = (
            self.n > self.warmup and dt > self.threshold * self.ewma
        )
        # stragglers don't poison the average
        if not is_straggler:
            self.ewma = (1 - self.alpha) * self.ewma + self.alpha * dt
        if is_straggler:
            self.flagged.append((step, dt))
        return is_straggler


def advise_checkpoint_cadence(
    *,
    step_time_s: float,
    ckpt_write_s: float,
    restart_s: float,
    mtbf_steps: float,
    horizon_steps: int = 2000,
    candidates: tuple[int, ...] = (10, 25, 50, 100, 250, 500),
    seed: int = 0,
) -> dict:
    """Pick the checkpoint interval that minimises wall-clock time to
    ``horizon_steps`` useful steps under failures.

    This is a purpose-built deterministic replay, not a Eudoxia engine
    run: the engine simulates many *independent* pipelines under a
    scheduler, while cadence choice needs one *sequential* job with
    checkpoint/restart state the engine deliberately does not model.
    What IS shared with the engine is the failure process — exponential
    inter-failure gaps, exactly how the chaos layer
    (``core/faults.py``, docs/faults.md) draws crash times.

    The job replays as ``horizon_steps`` sequential steps; failures
    arrive at exponential times; each failure rolls back to the last
    checkpoint (losing the steps since) and pays ``restart_s``; each
    checkpoint pays ``ckpt_write_s``. One deterministic replay per
    candidate interval.
    """
    rng = np.random.default_rng(seed)
    fail_times = np.cumsum(
        rng.exponential(mtbf_steps * step_time_s, size=64)
    )
    results = {}
    for interval in candidates:
        t = 0.0
        done = 0
        last_ckpt = 0
        fi = 0
        while done < horizon_steps:
            t += step_time_s
            done += 1
            if done - last_ckpt >= interval:
                t += ckpt_write_s
                last_ckpt = done
            if fi < len(fail_times) and t >= fail_times[fi]:
                fi += 1
                lost = done - last_ckpt
                done = last_ckpt
                t += restart_s
        results[interval] = t
    best = min(results, key=results.get)
    return {
        "best_interval": int(best),
        "total_time_s": {int(k): float(v) for k, v in results.items()},
    }


__all__ = [
    "FailureInjector",
    "StragglerMonitor",
    "advise_checkpoint_cadence",
]
