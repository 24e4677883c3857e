"""The port's reference Python engine on the CPU: against the JAX
package's Python engine, and against the port's own event engine.

* (a) ``repro_torch.run(engine="python", device="cpu")`` equals
  ``repro.core.run(engine="python")`` on the reference's workload (its
  fault trace and policy vector with it) on every ``SimState`` field
  under the comparison contract (every int, bool and f32 field exactly
  but the f32 sums ``TOLERANT``, rtol 1e-5): the seven Python-registered
  schedulers (``policy`` at the three points of
  ``tests/test_search.py``), the data plane
  (``tests/test_engine_equivalence.py``'s ``DATA_PLANE``), two chaos sets
  of ``tests/test_faults.py`` and two closed-loop sets of
  ``tests/test_closed_loop.py``. The two engines are one numpy program,
  so every field agrees to the bit.
* (b) the port's Python engine equals the port's event engine on the
  reference's compared fields (``COMPARE_FIELDS`` and, with the closed
  loop on, the closed-loop fields) at fixed seeds of the port's own
  generator, with the reference's tolerances on ``util_cpu_s`` and
  ``pool_down_s`` (rtol 1e-3, atol 1e-4).
* (c) ``container_schedule_py``, ``_cache_insert_py`` and
  ``_backoff_release_py`` equal the reference's on numpy-seeded inputs;
  the backoff also equals the event engine's ``executor.backoff_ticks``
  (an exact power of two: base 40 at attempt 15 is 1,310,720 ticks).

Workloads stay at ``tests/test_torch_engine.py``'s size (0.05 s, MP = MC
= 32). The reference compiles its generator once per distinct
``SimParams``, so the cases of (a) share one generator configuration
where the knobs do not shape the workload.
"""
import copy
import functools

import numpy as np
import pytest
import torch

from repro.core import SimParams as JParams
from repro.core import engine_python as j_engine_python
from repro.core import generate_workload as j_generate
from repro.core import run as j_run
from repro.core.policy import DEFAULT_POINTS as J_POINTS
from repro.core.policy import PolicyParams as JPolicy
from repro.core.types import Operator as JOperator
from repro.core.types import Pipeline as JPipeline
from repro.core.types import Priority as JPriority
from repro_torch import SimParams, generate_workload, run
from repro_torch.bridge import workload_from_arrays
from repro_torch.core import engine_python, executor
from repro_torch.core.state import CLOSED_LOOP_FIELDS
from repro_torch.core.types import Operator, Pipeline, Priority
from test_torch_models import release_jax_executables  # noqa: F401 (autouse)

TOLERANT = {
    "sum_latency_s", "sum_latency_s_prio", "util_cpu_s", "util_ram_s",
    "cost_dollars", "util_log", "pool_down_s",
}
# tests/test_engine_equivalence.py
COMPARE_FIELDS = [
    "pipe_status", "pipe_completion", "pipe_fails", "pipe_preempts", "done_count",
    "failed_count", "oom_events", "preempt_events", "cache_hits", "cache_lookups",
    "cold_starts", "warm_starts", "cold_start_tick_total", "cache_hit_gb", "bytes_moved_gb",
    "cache_bytes", "cache_last", "pool_cache_used", "pipe_retries", "ctr_timed",
    "pool_down_until", "crash_cursor", "outage_cursor", "nxt_fault", "crash_events",
    "outage_events", "timeout_events", "retry_events", "fault_kills", "wasted_ticks",
]
DATA_PLANE = dict(cache_gb_per_pool=4.0, scan_ticks_per_gb=50.0, cold_start_ticks=40,
                  container_warm_ticks=2_000)
# tests/test_faults.py: its CHAOS set, and timeouts that fire inside the
# horizon with a retry budget that runs out
CHAOS = dict(crash_mtbf_ticks=500.0, outage_mtbf_ticks=1_500.0, outage_duration_ticks=300.0,
             straggler_prob=0.15, timeout_ticks=30_000, max_retries=3, base_backoff_ticks=40)
CHAOS_SETS = {
    "all": CHAOS,
    "timeout-fires": dict(timeout_ticks=300, max_retries=2, base_backoff_ticks=30),
}
# tests/test_closed_loop.py: the queue threshold with client retries, and
# every knob over outages
CLOSED_LOOP = dict(client_max_inflight=6, client_think_ticks=30, client_max_retries=3,
                   client_backoff_ticks=40, admission_policy="queue_threshold",
                   admit_queue_limit=4, metastable_window_ticks=400)
CLOSED_LOOP_SETS = {
    "queue_threshold": dict(admission_policy="queue_threshold", admit_queue_limit=3,
                            client_max_retries=3, client_backoff_ticks=40),
    "all_plus_chaos": dict(outage_mtbf_ticks=1_200.0, outage_duration_ticks=300.0,
                           max_retries=3, base_backoff_ticks=40, **CLOSED_LOOP),
}
# tests/test_search.py's three points
POLICY_POINTS = {
    "priority_pool": J_POINTS["priority_pool"],
    "sjf": J_POINTS["sjf"],
    "searched": JPolicy(chunk_frac=0.2, size_weight=0.5, prio_weight=1.0, preempt=1.0,
                        multi_pool=1.0, cache_pin=1.0),
}


def _kw(algo="priority", pools=2, **extra):
    return dict(
        duration=0.05, scheduling_algo=algo, num_pools=pools, waiting_ticks_mean=400.0,
        op_base_seconds_mean=0.005, op_base_seconds_sigma=1.0, max_pipelines=32,
        max_containers=32, **extra,
    )


@functools.lru_cache(maxsize=None)
def _ref_workload(seed: int, shaping: tuple = ()):
    """The reference's workload at seed ``seed`` under ``_kw`` plus the
    knobs in ``shaping`` (those that draw a fault trace): a shared
    generator configuration, so the reference compiles it once."""
    return j_generate(JParams(**_kw(**dict(shaping)), seed=seed))


def _arrays(wl, policy=None):
    out = {f: np.asarray(getattr(wl, f)) for f in wl._fields[:10]}
    if wl.faults is not None:
        out["faults"] = {f: np.asarray(getattr(wl.faults, f)) for f in wl.faults._fields}
    if policy is not None:
        out["policy"] = np.asarray(policy, np.float32)
    return out


def _assert_contract(port_state, ref_state, ctx):
    for name in ref_state._fields:
        want = np.asarray(getattr(ref_state, name))
        got = getattr(port_state, name).numpy()
        assert got.dtype == want.dtype and got.shape == want.shape, (ctx, name)
        if name in TOLERANT:
            np.testing.assert_allclose(got, want, rtol=1e-5, err_msg=f"{ctx}: {name}")
        else:
            np.testing.assert_array_equal(got, want, err_msg=f"{ctx}: {name}")


def _both_python(seed, kw, shaping=(), policy=None):
    """The reference's and the port's Python engine on one workload."""
    wl = _ref_workload(seed, shaping)
    if policy is not None:
        wl = wl._replace(policy=policy.to_vector())
    ref = j_run(JParams(**kw, seed=seed), workload=wl, engine="python")
    port = run(SimParams(**kw, seed=seed), workload_from_arrays(_arrays(wl, wl.policy)),
               engine="python", device="cpu")
    return port, ref


# ---------------------------------------------------------------------------
# (a) the port's Python engine against the reference's
# ---------------------------------------------------------------------------
SCHEDULER_CASES = [
    # (scheduler, pools, seed, knobs): the two data-plane schedulers with
    # their cache on
    ("naive", 1, 1, {}), ("priority", 2, 2, {}), ("priority_pool", 3, 3, {}), ("sjf", 2, 4, {}),
    ("cache_aware", 2, 5, DATA_PLANE), ("locality_pool", 2, 6, DATA_PLANE),
]


@pytest.mark.parametrize("algo,pools,seed,knobs", SCHEDULER_CASES,
                         ids=[c[0] for c in SCHEDULER_CASES])
def test_python_engine_matches_reference_per_scheduler(algo, pools, seed, knobs):
    port, ref = _both_python(seed, _kw(algo, pools, **knobs))
    assert int(ref.state.done_count) > 0, "config too quiet"
    _assert_contract(port.state, ref.state, algo)
    assert port.summary()["done"] == int(ref.state.done_count)


@pytest.mark.parametrize("point", list(POLICY_POINTS), ids=list(POLICY_POINTS))
def test_python_engine_matches_reference_under_policy(point):
    kw = _kw("policy", **DATA_PLANE)
    port, ref = _both_python(7, kw, policy=POLICY_POINTS[point])
    assert int(ref.state.done_count) > 0
    _assert_contract(port.state, ref.state, f"policy/{point}")


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("algo", ["priority_pool", "cache_aware"])
def test_python_engine_matches_reference_data_plane(algo, seed):
    port, ref = _both_python(seed, _kw(algo, **DATA_PLANE))
    assert int(ref.state.cache_lookups) > 0
    _assert_contract(port.state, ref.state, f"data plane/{algo}/s{seed}")


@pytest.mark.parametrize("name", list(CHAOS_SETS), ids=list(CHAOS_SETS))
def test_python_engine_matches_reference_under_faults(name):
    knobs = CHAOS_SETS[name]
    shaping = tuple(sorted(knobs.items())) if JParams(**_kw(**knobs)).fault_trace_active else ()
    port, ref = _both_python(5, _kw("priority", **knobs), shaping)
    assert int(ref.state.retry_events) > 0, "no retry fired"
    _assert_contract(port.state, ref.state, f"chaos/{name}")


@pytest.mark.parametrize("name", list(CLOSED_LOOP_SETS), ids=list(CLOSED_LOOP_SETS))
def test_python_engine_matches_reference_closed_loop(name):
    knobs = CLOSED_LOOP_SETS[name]
    params = JParams(**_kw(**knobs))
    shaping = tuple(sorted((k, v) for k, v in knobs.items() if k in (
        "outage_mtbf_ticks", "outage_duration_ticks"))) if params.fault_trace_active else ()
    port, ref = _both_python(5, _kw("priority", **knobs), shaping)
    assert int(ref.state.offered_total) > 0, "config too quiet"
    _assert_contract(port.state, ref.state, f"closed loop/{name}")


def test_python_engine_result_shape_and_device():
    """The result is what ``run`` gives on the event path: per-lane
    shapes, on the requested device, the workload squeezed, the loop's
    events counted and the ``Scheduler`` as the scheduler state."""
    wl = _ref_workload(2)
    port = run(SimParams(**_kw(), seed=2), workload_from_arrays(_arrays(wl)), engine="python",
               device="cpu")
    event = run(SimParams(**_kw(), seed=2), workload_from_arrays(_arrays(wl)), device="cpu")
    for name in port.state._fields:
        a, b = getattr(port.state, name), getattr(event.state, name)
        assert a.device.type == "cpu" and a.dtype == b.dtype and a.shape == b.shape, name
    assert port.workload.arrival.shape == (32,)
    assert port.events > 0 and isinstance(port.sched_state, engine_python.Scheduler)
    assert port.params.engine == "python"


# ---------------------------------------------------------------------------
# (b) the port's Python engine against the port's event engine
# ---------------------------------------------------------------------------
EVENT_CASES = [
    # (scheduler, pools, seed, knobs)
    ("naive", 1, 11, {}),
    ("priority", 2, 12, {}),
    ("priority_pool", 3, 13, {}),
    ("sjf", 2, 14, {}),
    ("cache_aware", 2, 15, DATA_PLANE),
    ("locality_pool", 2, 16, DATA_PLANE),
    ("priority", 2, 17, CHAOS),
    ("priority_pool", 2, 18, CLOSED_LOOP),
]


@pytest.mark.parametrize("algo,pools,seed,knobs", EVENT_CASES,
                         ids=[f"{c[0]}-s{c[2]}" for c in EVENT_CASES])
def test_python_engine_matches_event_engine(algo, pools, seed, knobs):
    params = SimParams(**_kw(algo, pools, **knobs), seed=seed)
    wl = generate_workload(params, device="cpu")
    event = run(params, wl, device="cpu")
    python = run(params, wl, engine="python", device="cpu")
    assert int(event.state.done_count) > 0, "config too quiet"
    fields = COMPARE_FIELDS + (list(CLOSED_LOOP_FIELDS) if params.closed_loop_active else [])
    for name in fields:
        np.testing.assert_array_equal(getattr(python.state, name).numpy(),
                                      getattr(event.state, name).numpy(), err_msg=name)
    for name in ("util_cpu_s", "pool_down_s"):
        np.testing.assert_allclose(getattr(python.state, name).numpy(),
                                   getattr(event.state, name).numpy(), rtol=1e-3, atol=1e-4,
                                   err_msg=name)


# ---------------------------------------------------------------------------
# (c) the numpy transitions against the reference's
# ---------------------------------------------------------------------------
def _random_pipeline(rng, pid, records):
    """One pipeline of 1-6 ops on 1-3 levels with the generator's alphas,
    f32 runtimes and RAM, as the port's or the reference's records."""
    op, pipe, prio = records
    n = int(rng.integers(1, 7))
    levels = np.sort(rng.integers(0, 3, n))
    ops = [op(ram_gb=float(np.float32(rng.uniform(0.1, 6.0))),
              base_ticks=float(np.float32(rng.lognormal(5.0, 1.5))),
              alpha=float(rng.choice([0.0, 0.5, 1.0])), level=int(levels[i]),
              out_gb=float(np.float32(rng.integers(0, 4096) / 1024)))
           for i in range(n)]
    return pipe(pid=pid, priority=prio(int(rng.integers(0, 3))), arrival_tick=0, ops=ops)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_container_schedule_py_matches_reference(seed):
    rng_a, rng_b = np.random.default_rng(seed), np.random.default_rng(seed)
    for i in range(200):
        mine = _random_pipeline(rng_a, i, (Operator, Pipeline, Priority))
        ref = _random_pipeline(rng_b, i, (JOperator, JPipeline, JPriority))
        cpus, ram = np.float32(rng_a.uniform(0.1, 32.0)), np.float32(rng_a.uniform(0.1, 16.0))
        rng_b.uniform(), rng_b.uniform()
        assert engine_python.container_schedule_py(mine, cpus, ram) == \
            j_engine_python.container_schedule_py(ref, cpus, ram)


class _Caches:
    """The three cache tables ``_cache_insert_py`` reads and writes."""

    def __init__(self, NP, MP):
        self.cache_bytes = np.zeros((NP, MP), np.float32)
        self.cache_last = np.zeros((NP, MP), np.int64)
        self.pool_cache_used = np.zeros((NP,), np.float32)


def test_cache_insert_py_matches_reference():
    """Inserts of MiB-grid datasets into small caches, evictions included,
    give the same tables step for step."""
    rng = np.random.default_rng(3)
    NP, MP, cap = 2, 32, 4.0
    mine = _Caches(NP, MP)
    ref = copy.deepcopy(mine)
    evictions = 0
    for tick in range(1, 400):
        pool, pid = int(rng.integers(0, NP)), int(rng.integers(0, MP))
        size = np.float32(rng.integers(0, 5 * 1024) / 1024)
        before = int((mine.cache_bytes > 0).sum())
        engine_python._cache_insert_py(mine, pool, pid, size, tick, cap)
        j_engine_python._cache_insert_py(ref, pool, pid, size, tick, cap)
        evictions += int((mine.cache_bytes > 0).sum()) < before
        for name in ("cache_bytes", "cache_last", "pool_cache_used"):
            np.testing.assert_array_equal(getattr(mine, name), getattr(ref, name), err_msg=name)
    assert evictions > 0


@pytest.mark.parametrize("base", [1, 25, 30, 37, 40, 500, 1_000_003])
def test_backoff_release_py_matches_reference_and_event_engine(base):
    params = SimParams(base_backoff_ticks=base)
    jparams = JParams(base_backoff_ticks=base)
    attempts = torch.arange(0, 36, dtype=torch.int32)
    event = executor.backoff_ticks(base, attempts).clamp_min(1).tolist()
    for attempt in range(36):
        got = engine_python._backoff_release_py(attempt, 1_000, params)
        assert got == j_engine_python._backoff_release_py(attempt, 1_000, jparams)
        assert got == 1_000 + event[attempt], (base, attempt)
    if base == 40:
        assert engine_python._backoff_release_py(15, 0, params) == 1_310_720
