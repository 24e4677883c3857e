"""Host-side decode of on-device trace buffers.

``TraceEvents`` wraps one lane's record table as numpy columns and
derives the structures downstream consumers want: per-kind counts,
per-pipeline execution spans (start -> complete/preempt/oom pairing),
queue-depth / resource-gauge time series, and CSV export. The decode
is exact: int columns are raw, float gauges are bit-for-bit the f32
values the engine observed (stored as IEEE-754 bits, viewed back).

>>> from repro_torch import SimParams, run
>>> p = SimParams(duration=0.02, max_pipelines=8, max_containers=8,
...               max_ops_per_pipeline=4, waiting_ticks_mean=300.0,
...               op_base_seconds_mean=0.002)
>>> res = run(p, trace=True, device="cpu")
>>> res.trace.counts_by_kind()["complete"] == res.summary()["done"]
True
>>> res.trace.events_dropped
0
>>> spans = res.trace.spans()
>>> bool(all(s.end_tick >= s.start_tick for s in spans))
True
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .schema import (
    COL_A,
    COL_B,
    COL_CACHE_GB,
    COL_FREE_CPU,
    COL_FREE_RAM,
    COL_KIND,
    COL_OP,
    COL_PIPE,
    COL_POOL,
    COL_QDEPTH,
    COL_TICK,
    KIND_NAMES,
    EventKind,
)

CSV_HEADER = (
    "tick,kind,pipe,op,pool,queue_depth,free_cpu,free_ram_gb,"
    "cache_gb,a,b"
)

# kinds whose a/b payloads are f32 bits (schema.py payload table)
_FLOAT_A = {EventKind.START, EventKind.CACHE_HIT, EventKind.CACHE_MISS}
_FLOAT_B = {EventKind.START}


@dataclasses.dataclass(frozen=True)
class Span:
    """One container execution of a pipeline (START .. end event)."""

    pipe: int
    pool: int
    priority: int
    start_tick: int
    end_tick: int
    end_kind: str  # "complete" | "preempt" | "oom" | "fault" | "timeout" | "open"
    cpus: float
    ram_gb: float


def _f32(col: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(col.astype(np.int32)).view(np.float32)


@dataclasses.dataclass(frozen=True)
class TraceEvents:
    """Decoded per-lane event trace (time-ordered valid records only)."""

    records: np.ndarray  # [n, RECORD_WIDTH] int32
    events_dropped: int
    capacity: int

    @staticmethod
    def from_arrays(records, count, dropped, capacity=None) -> "TraceEvents":
        records = np.asarray(records, dtype=np.int32)
        n = int(count)
        return TraceEvents(
            records=records[:n].copy(),
            events_dropped=int(dropped),
            # callers that ship only the populated prefix to the host
            # pass the true ring capacity explicitly
            capacity=int(records.shape[0] if capacity is None else capacity),
        )

    # ---- columns ----------------------------------------------------------
    @property
    def n(self) -> int:
        return int(self.records.shape[0])

    @property
    def tick(self) -> np.ndarray:
        return self.records[:, COL_TICK]

    @property
    def kind(self) -> np.ndarray:
        return self.records[:, COL_KIND]

    @property
    def pipe(self) -> np.ndarray:
        return self.records[:, COL_PIPE]

    @property
    def pool(self) -> np.ndarray:
        return self.records[:, COL_POOL]

    @property
    def queue_depth(self) -> np.ndarray:
        return self.records[:, COL_QDEPTH]

    @property
    def free_cpu(self) -> np.ndarray:
        return _f32(self.records[:, COL_FREE_CPU])

    @property
    def free_ram_gb(self) -> np.ndarray:
        return _f32(self.records[:, COL_FREE_RAM])

    @property
    def cache_gb(self) -> np.ndarray:
        return _f32(self.records[:, COL_CACHE_GB])

    # ---- derived views ----------------------------------------------------
    def counts_by_kind(self) -> dict:
        """``{"arrival": n, "start": n, ...}`` over all valid records."""
        counts = np.bincount(self.kind, minlength=len(KIND_NAMES))
        return {name: int(counts[i]) for i, name in enumerate(KIND_NAMES)}

    def of_kind(self, kind: EventKind) -> np.ndarray:
        """The record rows of one event kind."""
        return self.records[self.kind == int(kind)]

    def spans(self) -> list:
        """Per-pipeline execution spans, START paired with the next
        COMPLETE / PREEMPT / OOM of the same pipeline (records are
        time-ordered as stored). An unterminated span is closed at the
        last recorded tick with ``end_kind="open"``."""
        open_by_pipe: dict[int, tuple] = {}
        out: list[Span] = []
        enders = {
            int(EventKind.COMPLETE): "complete",
            int(EventKind.PREEMPT): "preempt",
            int(EventKind.OOM): "oom",
            int(EventKind.FAULT): "fault",
            int(EventKind.TIMEOUT): "timeout",
        }
        for row in self.records:
            kind = int(row[COL_KIND])
            pipe = int(row[COL_PIPE])
            if kind == int(EventKind.START):
                cpus = float(_f32(row[COL_A : COL_A + 1])[0])
                ram = float(_f32(row[COL_B : COL_B + 1])[0])
                open_by_pipe[pipe] = (
                    int(row[COL_TICK]), int(row[COL_POOL]), cpus, ram
                )
            elif kind in enders and pipe in open_by_pipe:
                start, pool, cpus, ram = open_by_pipe.pop(pipe)
                out.append(Span(
                    pipe=pipe, pool=pool, priority=int(row[COL_B]),
                    start_tick=start, end_tick=int(row[COL_TICK]),
                    end_kind=enders[kind], cpus=cpus, ram_gb=ram,
                ))
        last = int(self.tick.max()) if self.n else 0
        for pipe, (start, pool, cpus, ram) in sorted(open_by_pipe.items()):
            out.append(Span(
                pipe=pipe, pool=pool, priority=-1, start_tick=start,
                end_tick=last, end_kind="open", cpus=cpus, ram_gb=ram,
            ))
        return out

    def series(self):
        """``(tick, queue_depth, free_cpu, free_ram_gb, cache_gb)``
        sampled at every record — the counter-track inputs."""
        return (
            self.tick, self.queue_depth, self.free_cpu,
            self.free_ram_gb, self.cache_gb,
        )

    def to_csv(self) -> str:
        """CSV export (floats decoded, kinds named)."""
        lines = [CSV_HEADER]
        for row in self.records:
            kind = int(row[COL_KIND])
            a: float | int = int(row[COL_A])
            b: float | int = int(row[COL_B])
            if kind in {int(k) for k in _FLOAT_A}:
                a = float(_f32(row[COL_A : COL_A + 1])[0])
            if kind in {int(k) for k in _FLOAT_B}:
                b = float(_f32(row[COL_B : COL_B + 1])[0])
            lines.append(
                f"{int(row[COL_TICK])},{KIND_NAMES[kind]},"
                f"{int(row[COL_PIPE])},{int(row[COL_OP])},"
                f"{int(row[COL_POOL])},{int(row[COL_QDEPTH])},"
                f"{float(_f32(row[COL_FREE_CPU: COL_FREE_CPU + 1])[0]):g},"
                f"{float(_f32(row[COL_FREE_RAM: COL_FREE_RAM + 1])[0]):g},"
                f"{float(_f32(row[COL_CACHE_GB: COL_CACHE_GB + 1])[0]):g},"
                f"{a},{b}"
            )
        return "\n".join(lines)


def _host(x) -> np.ndarray:
    """A host numpy copy of a tensor (from any device) or an array."""
    if hasattr(x, "detach"):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def decode_lane(tbuf, lane: int, capacity: int | None = None) -> TraceEvents:
    """Decode one lane of a fleet :class:`TraceBuffer`."""
    return TraceEvents.from_arrays(
        _host(tbuf.records[lane]),
        _host(tbuf.count[lane]),
        _host(tbuf.dropped[lane]),
        capacity=capacity,
    )


def decode_fleet(tbuf, capacity: int | None = None) -> list:
    """Decode every lane of a fleet trace into ``[TraceEvents, ...]``."""
    records = _host(tbuf.records)
    counts = _host(tbuf.count)
    dropped = _host(tbuf.dropped)
    return [
        TraceEvents.from_arrays(
            records[i], counts[i], dropped[i], capacity=capacity
        )
        for i in range(records.shape[0])
    ]


__all__ = ["TraceEvents", "Span", "decode_lane", "decode_fleet"]
