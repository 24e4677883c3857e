"""The port's telemetry (``core/telemetry``: the recorder, the traced
event step, decode and export) against the JAX package's, on the CPU.

* (a) ``run(trace=True)``: records, count and ``dropped`` equal the
  reference's on the reference's workload (and fault trace) under
  ``naive``, ``priority``, ``priority_pool``, ``cache_aware`` with the
  data plane, the chaos layer and the closed loop; the traced state
  equals the untraced one bit for bit.
* (b) ``fleet_run(trace=True)``: every lane's records equal the
  reference's, with the data plane, the chaos layer and the closed loop
  on, and on ``retry_storm`` tapes under a queue threshold (admission
  rejects, client retries, sheds); ``fleet_summary(traces=)`` reports
  the fleet's overflow.
* (c) overflow truncates and never corrupts: a small capacity keeps the
  prefix of the full trace and counts the rest in ``dropped``, in
  ``summary()`` too.
* (d) the recorder's pieces: ``_find_slots`` (``torch.searchsorted``,
  clamped) equals the reference's unrolled binary search; the fault
  pass's telemetry outputs on a step where it is not due are what the
  pass gives there, a pool recovering at the step's tick included.
* (e) the host side: Perfetto JSON, the timeline and the decoded spans
  reconcile with ``summarize``; every CLIENT_RETRY record's release tick
  obeys the client backoff (a twin of
  ``tests/test_closed_loop.py::test_client_backoff_schedule_exact``).
"""
import functools
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import SimParams as JParams
from repro.core import fleet_run as j_fleet_run
from repro.core import generate_workload as j_generate
from repro.core import run as j_run
from repro.core.faults import attach_fault_traces as j_attach_traces
from repro.core.sweep import make_workload_batch as j_batch
from repro.core.telemetry import record as j_record
from repro_torch import SimParams, fleet_run, fleet_summary, make_workload_batch, run
from repro_torch.bridge import workload_from_arrays
from repro_torch.core import EventKind, engine, executor, summarize_timeline, to_perfetto_json
from repro_torch.core.state import init_state
from repro_torch.core.telemetry import record
from repro_torch.core.telemetry.schema import COL_A, COL_B, COL_PIPE, COL_TICK
from repro_torch.core.types import INF_TICK
from test_torch_closed_loop import _arrays

DATA_PLANE = dict(cache_gb_per_pool=4.0, scan_ticks_per_gb=50.0, cold_start_ticks=40,
                  container_warm_ticks=2_000)
# tools/record_telemetry_capture.py's CHAOS, its timeout cut to 400 ticks
# so that timeouts fire in 0.03 s
CHAOS = dict(crash_mtbf_ticks=400.0, outage_mtbf_ticks=1_200.0, outage_duration_ticks=250.0,
             straggler_prob=0.1, timeout_ticks=400, max_retries=3, base_backoff_ticks=50)
# tools/record_telemetry_capture.py's CLOSED_LOOP, the threshold at 2 so
# that it sheds
CLOSED_LOOP = dict(client_max_inflight=6, client_think_ticks=30, client_max_retries=3,
                   client_backoff_ticks=40, admission_policy="queue_threshold",
                   admit_queue_limit=2, metastable_window_ticks=400)
# a small box under dense arrivals of large pipelines: preemptions, OOMs
# and rejections
OVERLOADED = dict(waiting_ticks_mean=100.0, op_ram_gb_mean=8.0, total_cpus=4, total_ram_gb=8)
CASES = {
    "naive-overloaded": dict(scheduling_algo="naive", **OVERLOADED),
    "priority-overloaded": dict(scheduling_algo="priority", **OVERLOADED),
    "priority_pool": dict(scheduling_algo="priority_pool"),
    "cache_aware-dataplane": dict(scheduling_algo="cache_aware", **DATA_PLANE),
    "chaos": dict(scheduling_algo="priority_pool", **DATA_PLANE, **CHAOS),
    "closed_loop": dict(scheduling_algo="priority_pool", **CHAOS, **CLOSED_LOOP),
}
CAPACITY = 2048


def _kw(case, **extra):
    """tests/test_telemetry.py's ``_params``: 0.03 s, MP = MC = 32."""
    kw = dict(duration=0.03, num_pools=2, waiting_ticks_mean=300.0, op_base_seconds_mean=0.005,
              op_base_seconds_sigma=1.0, max_pipelines=32, max_containers=32, seed=7)
    kw.update(CASES[case])
    if kw["scheduling_algo"] == "naive":
        kw["num_pools"] = 1
    return {**kw, **extra}


@functools.lru_cache(maxsize=None)
def _run_pair(case):
    """(port traced, port untraced, reference traced) of one case, on the
    reference's workload."""
    kw = _kw(case)
    wl = j_generate(JParams(**kw))
    port_wl = workload_from_arrays(_arrays(wl))
    ref = j_run(JParams(**kw), workload=wl, trace=True, trace_capacity=CAPACITY)
    traced = run(SimParams(**kw), port_wl, device="cpu", trace=True, trace_capacity=CAPACITY)
    plain = run(SimParams(**kw), port_wl, device="cpu")
    return traced, plain, ref


def _same_trace(got, want, ctx):
    assert (got.n, got.events_dropped, got.capacity) == \
        (want.n, want.events_dropped, want.capacity), ctx
    np.testing.assert_array_equal(got.records, want.records, err_msg=ctx)


# ---------------------------------------------------------------------------
# (a) run
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("case", list(CASES))
def test_run_trace_equals_reference(case):
    traced, plain, ref = _run_pair(case)
    _same_trace(traced.trace, ref.trace, case)
    assert traced.trace.n > 0 and traced.trace.events_dropped == 0
    for name in traced.state._fields:
        assert torch.equal(getattr(traced.state, name), getattr(plain.state, name)), name
    assert plain.trace is None and "trace_enabled" not in plain.summary()


def test_every_record_kind_is_exercised():
    traces = [_run_pair(case)[0].trace for case in CASES] + list(_storm_pair()[1])
    counts = {}
    for trace in traces:
        for kind, n in trace.counts_by_kind().items():
            counts[kind] = counts.get(kind, 0) + n
    quiet = [k for k, n in counts.items() if n == 0]
    assert not quiet, counts


def test_decision_provenance_is_recorded():
    trace = _run_pair("priority_pool")[0].trace
    decisions = trace.of_kind(EventKind.SCHED_DECISION)
    assert len(decisions) > 0
    chosen, runner = decisions[:, COL_PIPE], decisions[:, COL_A]
    assert (chosen >= 0).all()
    assert (runner[runner >= 0] != chosen[runner >= 0]).all()


# ---------------------------------------------------------------------------
# (b) fleet_run
# ---------------------------------------------------------------------------
def test_fleet_trace_equals_reference_lane_by_lane():
    kw = _kw("chaos", **CLOSED_LOOP)
    jparams, params = JParams(**kw), SimParams(**kw)
    wls = j_attach_traces(j_batch(jparams, [3, 4, 5])._replace(faults=None), jparams)
    arrays = _arrays(wls)
    _, ref = j_fleet_run(jparams, workloads=wls, trace=True, trace_capacity=CAPACITY)
    port_wls = workload_from_arrays(arrays)
    states, traces = fleet_run(params, workloads=port_wls, device="cpu", trace=True,
                               trace_capacity=CAPACITY)
    assert len(traces) == len(ref) == 3
    for i, (got, want) in enumerate(zip(traces, ref)):
        _same_trace(got, want, f"lane {i}")
    plain = fleet_run(params, workloads=port_wls, device="cpu")
    for name in states._fields:
        assert torch.equal(getattr(states, name), getattr(plain, name)), name
    assert fleet_summary(states, params, traces=traces)["events_dropped_total"] == 0
    assert "events_dropped_total" not in fleet_summary(states, params)


@functools.lru_cache(maxsize=None)
def _storm_pair():
    """(port states, port traces, reference traces, params) of two
    ``retry_storm`` lanes (numpy tapes, the same in both packages) under
    a queue threshold of 2, clients retrying 4 times at 37 ticks."""
    from repro.core import workload_batch_from_traces as j_batch_from_traces
    from repro_torch.core.scenarios import scenario_lane_batch
    from repro_torch.core.workload import workload_batch_from_traces

    base = dict(duration=0.04, max_pipelines=0, max_ops_per_pipeline=0, max_containers=16,
                waiting_ticks_mean=150.0, op_base_seconds_mean=0.008, op_base_seconds_sigma=1.0,
                num_pools=2, total_cpus=4, total_ram_gb=8, scheduling_algo="priority_pool")
    knobs = dict(admission_policy="queue_threshold", admit_queue_limit=2, client_max_retries=4,
                 client_backoff_ticks=37)
    lanes = scenario_lane_batch("retry_storm", SimParams(**{**base, "duration": 0.03}), 2,
                                seed=11, surge_factor=6.0)
    wls, params = workload_batch_from_traces(lanes, SimParams(**base))
    jwls, jparams = j_batch_from_traces(lanes, JParams(**base))
    params, jparams = params.replace(**knobs), jparams.replace(**knobs)
    _, ref = j_fleet_run(jparams, workloads=jwls, trace=True, trace_capacity=CAPACITY)
    states, traces = fleet_run(params, workloads=wls, device="cpu", trace=True,
                               trace_capacity=CAPACITY)
    return states, traces, ref, params


def test_retry_storm_trace_equals_reference():
    states, traces, ref, _ = _storm_pair()
    for i, (got, want) in enumerate(zip(traces, ref)):
        _same_trace(got, want, f"retry_storm lane {i}")
    counts = {k: sum(t.counts_by_kind()[k] for t in traces)
              for k in ("admit_reject", "client_retry", "shed")}
    assert all(n > 0 for n in counts.values()), counts
    assert counts["admit_reject"] == counts["client_retry"] + counts["shed"]
    # shed_total counts every admission rejection
    assert counts["admit_reject"] == int(states.shed_total.sum())
    assert counts["client_retry"] == int(states.client_retry_events.sum())


# ---------------------------------------------------------------------------
# (c) overflow
# ---------------------------------------------------------------------------
def test_overflow_truncates_never_corrupts():
    full = _run_pair("cache_aware-dataplane")[0]
    assert full.trace.n > 16
    kw = _kw("cache_aware-dataplane")
    port_wl = workload_from_arrays(_arrays(j_generate(JParams(**kw))))
    small = run(SimParams(**kw), port_wl, device="cpu", trace=True, trace_capacity=16)
    assert (small.trace.n, small.trace.capacity) == (16, 16)
    assert small.trace.events_dropped == full.trace.n - 16
    np.testing.assert_array_equal(small.trace.records, full.trace.records[:16])
    s = small.summary()
    assert s["trace_enabled"] is True and s["events_dropped"] == full.trace.n - 16
    for name in small.state._fields:
        assert torch.equal(getattr(small.state, name), getattr(full.state, name)), name


def test_records_are_time_ordered():
    for case in CASES:
        assert (np.diff(_run_pair(case)[0].trace.tick) >= 0).all(), case


# ---------------------------------------------------------------------------
# (d) the recorder's pieces
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n,G", [(1, 1), (5, 16), (16, 16), (37, 16), (64, 16), (200, 16),
                                 (257, 9)])
def test_find_slots_equals_the_reference_search(n, G):
    """``torch.searchsorted`` clamped to ``n - 1`` gives block slot j the
    j-th selected candidate. The reference's unrolled search runs
    ``(n - 1).bit_length()`` halvings, one short when ``n`` is a power of
    two (ROADMAP queue 3); everywhere else the two agree."""
    rng = np.random.default_rng(n * 100 + G)
    masks = rng.random((12, n)) < rng.uniform(0.0, 0.6, (12, 1))
    masks[0] = False
    masks[1] = True
    pos = np.cumsum(masks, axis=1, dtype=np.int32)
    got = record._find_slots(torch.from_numpy(pos), G).numpy()
    for lane, p in enumerate(pos):
        k = min(int(p[-1]), G)
        np.testing.assert_array_equal(got[lane, :k], np.flatnonzero(masks[lane])[:k])
        assert (got[lane, k:] == n - 1).all()
    want = np.stack([np.minimum(np.asarray(j_record._find_slots(jnp.asarray(p), G)), n - 1)
                     for p in pos])
    if n & (n - 1) or n == 1:
        np.testing.assert_array_equal(got, want)
    else:
        # all n candidates selected: the reference gives slot 1 candidate 0
        assert want[1, 1] == 0 and got[1, 1] == 1


def test_fault_aux_of_a_step_where_the_pass_is_not_due():
    """The engine skips the fault pass where no lane is due; the
    recorder then reads ``zero_fault_aux``. On every lane where the pass
    is not due it reports exactly that — and a pool that recovers at the
    step's tick makes the pass due (``nxt_fault``), with ``up_now`` set."""
    params = SimParams(**_kw("chaos"))
    wls = make_workload_batch(params, [0, 1, 2])
    never = torch.full_like(wls.faults.crash_time, INF_TICK)
    wls = wls._replace(faults=wls.faults._replace(crash_time=never, outage_start=never))
    tick = torch.tensor([5, 9, 9], dtype=torch.int32)
    # lane 1: pool 0 recovers at the step's tick (due); lanes 0 and 2 not due
    state = init_state(params, 3, "cpu")._replace(
        tick=tick, pool_down_until=torch.tensor([[0, 0], [9, 0], [30, 0]], dtype=torch.int32),
        nxt_fault=torch.tensor([INF_TICK, 9, 30], dtype=torch.int32))
    go, due = engine.fault_gate(state, torch.ones(3, dtype=torch.bool), params)
    assert go and due
    _, aux = executor.apply_faults(state, wls, tick, params, with_aux=True)
    zero = executor.zero_fault_aux(state)
    for lane in (0, 2):
        for got, want in zip(aux, zero):
            assert torch.equal(got[lane], want[lane])
    assert aux[6][1].tolist() == [True, False]          # up_now
    assert not aux[5].any() and not aux[0].any()        # down_new, kill


# ---------------------------------------------------------------------------
# (e) the host side
# ---------------------------------------------------------------------------
def test_perfetto_timeline_and_spans_reconcile_with_summarize():
    res = _run_pair("cache_aware-dataplane")[0]
    s = res.summary()
    doc = json.loads(to_perfetto_json(res.trace, res.params))
    assert set(doc) == {"traceEvents", "displayTimeUnit"}
    by_cat = {}
    for ev in doc["traceEvents"]:
        if ev.get("ph") in ("X", "i"):
            by_cat[ev.get("cat")] = by_cat.get(ev.get("cat"), 0) + 1
    counts = res.trace.counts_by_kind()
    for kind, key in (("complete", "done"), ("preempt", "preempt_events"),
                      ("cold_start", "cold_starts"), ("cache_hit", "cache_hits"),
                      ("oom", "oom_events"), ("reject", "failed")):
        assert by_cat.get(kind, 0) == counts[kind] == s[key], kind
    tl = summarize_timeline(res.trace, res.params, n_windows=4)
    assert len(tl["windows"]) == 4
    assert sum(w["completed"] for w in tl["windows"]) == tl["overall"]["completed"] == s["done"]
    spans = res.trace.spans()
    assert len(spans) == counts["start"]
    assert all(0 <= sp.start_tick <= sp.end_tick <= res.params.horizon_ticks for sp in spans)
    lines = res.trace.to_csv().splitlines()
    assert lines[0].startswith("tick,kind,") and len(lines) == res.trace.n + 1


def test_client_backoff_schedule_exact():
    """Every CLIENT_RETRY record's release tick obeys tick + max(min(
    client_backoff_ticks * 2**(attempt-1), 2**30), 1); per-pipe attempts
    strictly increase. On ``retry_storm`` tapes: the reference's own
    test draws a workload that retries on some machines and not on
    others (XLA's float codegen)."""
    _, traces, _, params = _storm_pair()
    base = params.client_backoff_ticks
    n = 0
    for trace in traces:
        assert trace.events_dropped == 0
        by_pipe = {}
        for row in trace.of_kind(EventKind.CLIENT_RETRY):
            tick, attempt, release = int(row[COL_TICK]), int(row[COL_A]), int(row[COL_B])
            assert attempt >= 1
            assert release == tick + max(min(base * 2 ** (attempt - 1), 2**30), 1)
            by_pipe.setdefault(int(row[COL_PIPE]), []).append(attempt)
            n += 1
        for attempts in by_pipe.values():
            assert all(b > a for a, b in zip(attempts, attempts[1:]))
    assert n > 0, "config too quiet: no client retries recorded"
