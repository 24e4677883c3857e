"""Trace record schema shared by the on-device recorder and the host
decoder.

One trace record is one int32 row of ``RECORD_WIDTH`` columns. Float
payloads (resource gauges, allocation sizes, cached GB) are stored as
their raw IEEE-754 bits (``bitcast``, not a cast) so the decode is
exact; the decoder views them back as float32.

Columns
-------

====  ===========  ====================================================
 idx  name         meaning
====  ===========  ====================================================
  0   tick         event tick (simulation time, 1 tick = 10 us)
  1   kind         :class:`EventKind`
  2   pipe         pipeline id (-1 when not applicable)
  3   op           kind-specific small int (see payload table)
  4   pool         pool id (-1 when not applicable)
  5   queue_depth  WAITING pipelines after the engine step
  6   free_cpu     f32 bits — total free CPUs after the step
  7   free_ram     f32 bits — total free RAM GB after the step
  8   cache_gb     f32 bits — total cache-resident GB after the step
  9   a            kind-specific payload (see payload table)
 10   b            kind-specific payload (see payload table)
====  ===========  ====================================================

Payloads per kind (``op`` / ``a`` / ``b``)
------------------------------------------

================  =====================  ======================  =================
 kind              op                     a                       b
================  =====================  ======================  =================
 ARRIVAL           -1                     priority                arrival tick
 SCHED_DECISION    runner-up priority     runner-up pipeline      chosen priority
 START             -1                     f32 bits: cpus          f32 bits: ram GB
 COLD_START        -1                     cold-start ticks        0
 CACHE_HIT         -1                     f32 bits: hit GB        0
 CACHE_MISS        -1                     f32 bits: miss GB       0
 PREEMPT           -1                     container slot          priority
 OOM               -1                     container slot          priority
 COMPLETE          -1                     container slot          priority
 REJECT            -1                     priority                0
 FAULT             cause (0=crash,        container slot          priority
                   1=outage)
 POOL_DOWN         -1                     down-until tick         0
 POOL_UP           -1                     0                       0
 TIMEOUT           -1                     container slot          priority
 RETRY             -1                     attempt number          release tick
 ADMIT_REJECT      -1                     priority                0
 CLIENT_RETRY      -1                     attempt number          release tick
 SHED              -1                     priority                0
================  =====================  ======================  =================

Within one engine step, records appear in the fixed order arrivals ->
ooms -> completes -> preempts -> rejects -> scheduler decision ->
starts -> cold-starts -> cache hits -> cache misses, and steps append
chronologically, so a lane's record array is time-ordered as stored.
The chaos-layer kinds (FAULT, TIMEOUT, POOL_DOWN, POOL_UP, RETRY,
emitted only when the matching fault knobs are on — see docs/faults.md)
extend that order at the end of each step: faults -> timeouts ->
pool-downs -> pool-ups -> retries. The closed-loop kinds (ADMIT_REJECT,
CLIENT_RETRY, SHED, emitted only when the closed-loop knobs are on —
see docs/closed-loop.md) follow last: admit-rejects -> client-retries
-> sheds. ADMIT_REJECT fires for every admission rejection; each is
also either a CLIENT_RETRY (budget left, re-offered with backoff) or a
SHED (budget exhausted, pipeline FAILED).
"""
from __future__ import annotations

import enum


class EventKind(enum.IntEnum):
    """Per-event record kinds (see the payload table above)."""

    ARRIVAL = 0         # pipeline admitted to the waiting queue
    SCHED_DECISION = 1  # scheduler picked a head-of-queue (chosen vs runner-up)
    START = 2           # container created for a pipeline
    COLD_START = 3      # that container started on a cold slot
    CACHE_HIT = 4       # assignment found input bytes in the pool cache
    CACHE_MISS = 5      # assignment scanned input bytes from storage
    PREEMPT = 6         # container suspended by the scheduler
    OOM = 7             # container killed by the RAM model
    COMPLETE = 8        # pipeline finished
    REJECT = 9          # pipeline failed back to the user
    FAULT = 10          # container killed by the chaos layer (crash/outage)
    POOL_DOWN = 11      # pool struck by an outage (capacity masked)
    POOL_UP = 12        # pool recovered from its outage
    TIMEOUT = 13        # container killed at its wall-clock deadline
    RETRY = 14          # faulted/timed-out pipeline re-queued with backoff
    ADMIT_REJECT = 15   # offer rejected by the admission policy
    CLIENT_RETRY = 16   # rejected offer re-queued by the client (backoff)
    SHED = 17           # rejected offer permanently shed (client budget out)


KIND_NAMES = tuple(k.name.lower() for k in EventKind)

# column indices of one int32 record row
COL_TICK = 0
COL_KIND = 1
COL_PIPE = 2
COL_OP = 3
COL_POOL = 4
COL_QDEPTH = 5
COL_FREE_CPU = 6   # f32 bits
COL_FREE_RAM = 7   # f32 bits
COL_CACHE_GB = 8   # f32 bits
COL_A = 9
COL_B = 10
RECORD_WIDTH = 11

# f32-bits columns, viewed back as float32 on decode
FLOAT_COLS = (COL_FREE_CPU, COL_FREE_RAM, COL_CACHE_GB)

DEFAULT_TRACE_CAPACITY = 4096

# The recorder emits at most this many records per engine step; larger
# bursts are counted in ``events_dropped``. The cap is what keeps the
# recorder cheap: per step it compacts and writes a fixed
# ``[TRACE_STEP_EVENTS, RECORD_WIDTH]`` block instead of the full
# candidate table (every pipeline x every container x every assignment
# slot, ~hundreds of rows), and the compaction search cost scales with
# the block size. Event-driven steps carry ~1-5 records in practice;
# the worst observed across the test matrix and the scenario library
# (bursty arrivals at 10x base rate) is 9, so 16 still has headroom —
# and a clipped burst is counted in ``events_dropped``, never silent.
TRACE_STEP_EVENTS = 16

__all__ = [
    "EventKind",
    "KIND_NAMES",
    "RECORD_WIDTH",
    "FLOAT_COLS",
    "DEFAULT_TRACE_CAPACITY",
    "TRACE_STEP_EVENTS",
    "COL_TICK",
    "COL_KIND",
    "COL_PIPE",
    "COL_OP",
    "COL_POOL",
    "COL_QDEPTH",
    "COL_FREE_CPU",
    "COL_FREE_RAM",
    "COL_CACHE_GB",
    "COL_A",
    "COL_B",
]
