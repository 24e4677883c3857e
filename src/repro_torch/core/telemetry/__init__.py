"""In-engine telemetry: the event recorder and host-side export.

The recorder (:mod:`.record`) rides the lane-major engine's loop and
appends one int32 row per simulation event (:mod:`.schema`) to every
lane's table. The host side (:mod:`.decode`, :mod:`.export`) turns the
tables into :class:`TraceEvents`, Perfetto/Chrome trace JSON, CSV, and
windowed timeline metrics. Enable with ``run(p, trace=True)`` or
``fleet_run(..., trace=True)``; off, none of it runs, and on, the
simulated states are bit-equal to the untraced run's.
"""
from .decode import Span, TraceEvents, decode_fleet, decode_lane
from .export import summarize_timeline, to_perfetto_json
from .record import TraceBuffer, init_trace_buffer, record_step
from .schema import DEFAULT_TRACE_CAPACITY, KIND_NAMES, RECORD_WIDTH, EventKind

__all__ = [
    "EventKind",
    "KIND_NAMES",
    "RECORD_WIDTH",
    "DEFAULT_TRACE_CAPACITY",
    "TraceBuffer",
    "init_trace_buffer",
    "record_step",
    "TraceEvents",
    "Span",
    "decode_lane",
    "decode_fleet",
    "to_perfetto_json",
    "summarize_timeline",
]
