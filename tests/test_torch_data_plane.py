"""The port's data plane (cold starts, scan cost, the zero-copy cache)
against the JAX package's, on the CPU.

* The hand-computed scenarios of ``tests/test_data_plane.py`` (cold and
  warm starts, scan cost, cache hits, LRU eviction, a dataset larger
  than the cache) give the same numbers on the port's
  ``workload_from_pipelines``.
* ``state.cache_insert`` equals the reference's on random rows.
* The premise of the cache's f32 sums: every generated or ingested
  dataset size lies on the MiB grid, so the sums are exact in any order.
* An outage flushes the struck pool's cache, as the reference's
  ``apply_faults`` does, and a run with the chaos layer and the data
  plane on equals the reference's under the comparison contract.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import SimParams as JParams
from repro.core import generate_workload as j_generate
from repro.core import run as j_run
from repro.core.executor import apply_faults as j_apply_faults
from repro.core.faults import FaultTrace as JFaultTrace
from repro.core.state import SimState as JSimState
from repro.core.state import cache_insert as j_cache_insert
from repro_torch import SimParams, run
from repro_torch.bridge import state_to_arrays, workload_from_arrays
from repro_torch.core import executor
from repro_torch.core.state import FaultTrace, cache_insert, init_state
from repro_torch.core.types import INF_TICK, Operator, Pipeline, Priority
from repro_torch.core.workload import (
    generate_workload,
    workload_from_pipelines,
    workload_from_trace_records,
)

TOLERANT = {
    "sum_latency_s", "sum_latency_s_prio", "util_cpu_s", "util_ram_s",
    "cost_dollars", "util_log", "pool_down_s",
}


def one_op_pipe(pid, arrive_tick, *, ram=1.0, base=100, out_gb=0.0, prio=Priority.BATCH):
    return Pipeline(pid=pid, priority=prio, arrival_tick=arrive_tick,
                    ops=[Operator(ram_gb=ram, base_ticks=base, alpha=0.0, level=0,
                                  out_gb=out_gb)])


def P(**kw) -> SimParams:
    base = dict(duration=0.05, scheduling_algo="naive", total_cpus=16.0, total_ram_gb=32.0,
                max_pipelines=8, max_containers=8)
    base.update(kw)
    return SimParams(**base)


def _run(params, pipes):
    return run(params, workload_from_pipelines(pipes, params), device="cpu")


# ---------------------------------------------------------------------------
# The hand-computed scenarios (numbers from tests/test_data_plane.py)
# ---------------------------------------------------------------------------
def test_cold_then_warm():
    # p0 at t=0 on a cold slot: 50 boot + 100 run, done at 150; p1 at
    # t=200 finds slot 0 warm until 150 + 10000: no boot, done at 300
    res = _run(P(cold_start_ticks=50, container_warm_ticks=10_000),
               [one_op_pipe(0, 0), one_op_pipe(1, 200)])
    st = res.state
    assert st.pipe_completion[:2].tolist() == [150, 300]
    assert (int(st.cold_starts), int(st.warm_starts), int(st.cold_start_tick_total)) == (1, 1, 50)


def test_warmth_expires():
    # a 30-tick warm window: p1 at t=200 > 150 + 30 boots again
    res = _run(P(cold_start_ticks=50, container_warm_ticks=30),
               [one_op_pipe(0, 0), one_op_pipe(1, 200)])
    st = res.state
    assert st.pipe_completion[:2].tolist() == [150, 350]
    assert (int(st.cold_starts), int(st.warm_starts), int(st.cold_start_tick_total)) == (2, 0, 100)


def test_zero_cold_start_charges_nothing():
    res = _run(P(), [one_op_pipe(0, 0), one_op_pipe(1, 200)])
    assert res.state.pipe_completion[:2].tolist() == [100, 300]
    assert int(res.state.cold_start_tick_total) == 0


def test_oom_retry_hits_cache():
    # chunk 3.2 GB < 5 GB: run 1 (t=0) scans 2 GB at 100 ticks/GB and
    # OOMs at 201; run 2 (t=201) finds the 2 GB resident, done at 301
    res = _run(P(scheduling_algo="priority", cache_gb_per_pool=10.0, scan_ticks_per_gb=100.0),
               [one_op_pipe(0, 0, ram=5.0, out_gb=2.0)])
    st = res.state
    assert int(st.oom_events) == 1 and int(st.pipe_completion[0]) == 301
    assert float(st.bytes_moved_gb) == 2.0 and float(st.cache_hit_gb) == 2.0
    assert (int(st.cache_hits), int(st.cache_lookups)) == (1, 2)
    assert res.summary()["cache_hit_rate"] == pytest.approx(0.5)


def test_cache_capacity_zero_never_hits():
    # no cache: both runs scan the whole 2 GB, done at 201 + 200 + 100
    res = _run(P(scheduling_algo="priority", cache_gb_per_pool=0.0, scan_ticks_per_gb=100.0),
               [one_op_pipe(0, 0, ram=5.0, out_gb=2.0)])
    st = res.state
    assert float(st.bytes_moved_gb) == 4.0 and float(st.cache_hit_gb) == 0.0
    assert int(st.cache_hits) == 0 and int(st.pipe_completion[0]) == 501


@pytest.mark.parametrize("sizes,want_bytes,want_used", [
    # cap 5: C needs 4 + 2 - 5 = 1 GB freed, so A (the oldest) goes
    ((2.0, 2.0, 2.0), [0.0, 2.0, 2.0], 4.0),
    # D needs 4 + 4.5 - 5 = 3.5: A (2 < 3.5), then B; only D remains
    ((2.0, 2.0, 4.5), [0.0, 0.0, 4.5], 4.5),
    # 7 GB > the 5 GB cache: never inserted, the resident set intact
    ((2.0, 7.0), [2.0, 0.0], 2.0),
], ids=["oldest-first", "cascade", "oversized"])
def test_lru_eviction(sizes, want_bytes, want_used):
    res = _run(P(cache_gb_per_pool=5.0),
               [one_op_pipe(i, 200 * i, out_gb=gb) for i, gb in enumerate(sizes)])
    st = res.state
    assert st.cache_bytes[0, :len(sizes)].tolist() == want_bytes
    assert float(st.pool_cache_used[0]) == want_used
    if sizes == (2.0, 2.0, 2.0):
        assert st.cache_last[0, 1:3].tolist() == [200, 400]


def test_cache_aware_retry_lands_on_cached_pool():
    res = _run(P(scheduling_algo="cache_aware", num_pools=2, cache_gb_per_pool=10.0,
                 scan_ticks_per_gb=100.0), [one_op_pipe(0, 0, ram=5.0, out_gb=2.0)])
    st = res.state
    assert int(st.oom_events) == 1 and float(st.cache_hit_gb) == 2.0
    assert int(st.cache_hits) == 1 and int((st.cache_bytes > 0).sum()) == 1


# ---------------------------------------------------------------------------
# cache_insert against the reference's
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("seed", range(3))
def test_cache_insert_matches_reference(seed):
    rng = np.random.default_rng(seed)
    F, MP, cap = 64, 24, 6.0
    mib = lambda a: (np.round(a * 1024.0) / 1024.0).astype(np.float32)  # noqa: E731
    row_b = np.where(rng.random((F, MP)) < 0.3, mib(rng.uniform(0.05, 2.5, (F, MP))), 0.0)
    row_b = row_b.astype(np.float32)
    row_l = rng.integers(0, 50, (F, MP)).astype(np.int32)   # ties in the last touch
    used = row_b.sum(-1, dtype=np.float32)
    pipe = rng.integers(0, MP, F).astype(np.int32)
    size = mib(rng.uniform(0.0, 8.0, F))                     # some larger than the cache
    tick = rng.integers(50, 100, F).astype(np.int32)
    want = jax.vmap(lambda *a: j_cache_insert(*a, cap))(
        *map(jnp.asarray, (row_b, row_l, used, pipe, size, tick)))
    got = cache_insert(*map(torch.from_numpy, (row_b, row_l, used, pipe, size, tick)), cap)
    for g, w, name in zip(got, want, ("row_bytes", "row_last", "used")):
        assert g.numpy().dtype == np.asarray(w).dtype, name
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    assert bool((got[0] != torch.from_numpy(row_b)).any())      # some rows evicted


# ---------------------------------------------------------------------------
# The MiB-grid premise of the cache's f32 sums
# ---------------------------------------------------------------------------
def _on_mib_grid(x: torch.Tensor) -> bool:
    scaled = x.double() * 1024.0
    return bool((scaled == torch.round(scaled)).all())


def test_dataset_sizes_lie_on_the_mib_grid():
    params = SimParams(duration=0.05, max_pipelines=64, op_out_gb_mean=2.0, op_out_gb_sigma=1.5)
    gen = generate_workload(params, 3, device="cpu")
    rng = np.random.default_rng(0)
    records = [{"arrival_s": 0.001 * i,
                "ops": [{"ram_gb": 1.0, "base_s": 0.002, "out_gb": float(g)}
                        for g in rng.lognormal(0.0, 1.5, 3)]} for i in range(20)]
    traced = workload_from_trace_records(records, params)
    ref = j_generate(JParams(duration=0.05, max_pipelines=64, op_out_gb_mean=2.0,
                             op_out_gb_sigma=1.5))
    for name, wl in (("generator", gen), ("trace", traced),
                     ("reference", workload_from_arrays({f: np.asarray(getattr(ref, f))
                                                         for f in ref._fields[:10]}))):
        assert bool((wl.op_out > 0).any()), name
        assert _on_mib_grid(wl.op_out) and _on_mib_grid(wl.pipe_out), name


# ---------------------------------------------------------------------------
# The outage flush under the chaos layer
# ---------------------------------------------------------------------------
def test_outage_flushes_the_struck_pools_cache():
    params = SimParams(duration=0.05, num_pools=2, max_pipelines=8, max_containers=8,
                       outage_mtbf_ticks=1_000.0, outage_duration_ticks=300.0,
                       cache_gb_per_pool=8.0, max_fault_events=4)
    state = init_state(params, 1, "cpu")
    cb = torch.zeros_like(state.cache_bytes)
    cb[0, 0, :3] = torch.tensor([1.0, 0.5, 2.0])
    cb[0, 1, 3:5] = torch.tensor([3.0, 0.25])
    state = state._replace(
        cache_bytes=cb, cache_last=(cb > 0).to(torch.int32) * 7,
        pool_cache_used=cb.sum(-1), tick=torch.full((1,), 100, dtype=torch.int32),
        nxt_fault=torch.full((1,), 100, dtype=torch.int32))
    MF, MP = 4, params.max_pipelines
    inf = torch.full((1, MF), INF_TICK, dtype=torch.int32)
    faults = FaultTrace(
        crash_time=inf.clone(),
        outage_start=torch.tensor([[100, 900, INF_TICK, INF_TICK]], dtype=torch.int32),
        outage_end=torch.tensor([[400, 1200, INF_TICK, INF_TICK]], dtype=torch.int32),
        outage_pool=torch.tensor([[1, 0, 0, 0]], dtype=torch.int32),
        straggler=torch.ones((1, MP)))
    wl = generate_workload(params, 0, device="cpu")._replace(faults=faults)
    got = executor.apply_faults(state, wl, state.tick, params)
    assert got.cache_bytes[0, 1].abs().sum() == 0 and got.cache_last[0, 1].abs().sum() == 0
    assert float(got.pool_cache_used[0, 1]) == 0.0
    assert torch.equal(got.cache_bytes[0, 0], cb[0, 0]) and float(got.pool_cache_used[0, 0]) == 3.5

    from repro.core.params import SimParams as JP

    jparams = JP(duration=0.05, num_pools=2, max_pipelines=8, max_containers=8,
                 outage_mtbf_ticks=1_000.0, outage_duration_ticks=300.0,
                 cache_gb_per_pool=8.0, max_fault_events=4)
    jstate = JSimState(**{k: jnp.asarray(v[0]) for k, v in state_to_arrays(state).items()})
    jwl = j_generate(jparams)._replace(faults=JFaultTrace(
        *(jnp.asarray(x[0].numpy()) for x in faults)))
    want, _ = j_apply_faults(jstate, jwl, jnp.int32(100), jparams)
    mine = state_to_arrays(got)
    for name in JSimState._fields:
        np.testing.assert_array_equal(mine[name][0], np.asarray(getattr(want, name)),
                                      err_msg=name)


def test_chaos_and_data_plane_run_matches_reference():
    kw = dict(duration=0.04, scheduling_algo="cache_aware", num_pools=2,
              waiting_ticks_mean=300.0, op_base_seconds_mean=0.004, op_base_seconds_sigma=1.0,
              max_pipelines=32, max_containers=32, cache_gb_per_pool=4.0,
              scan_ticks_per_gb=50.0, cold_start_ticks=40, container_warm_ticks=2_000,
              outage_mtbf_ticks=800.0, outage_duration_ticks=300.0, crash_mtbf_ticks=700.0,
              max_retries=3, base_backoff_ticks=40, seed=5)
    wl = j_generate(JParams(**kw))
    arrays = {f: np.asarray(getattr(wl, f)) for f in wl._fields[:10]}
    arrays["faults"] = {f: np.asarray(getattr(wl.faults, f)) for f in wl.faults._fields}
    ref = j_run(JParams(**kw), workload=wl)
    port = run(SimParams(**kw), workload_from_arrays(arrays), device="cpu")
    got = state_to_arrays(port.state)
    for name in ref.state._fields:
        want = np.asarray(getattr(ref.state, name))
        if name in TOLERANT:
            np.testing.assert_allclose(got[name], want, rtol=1e-5, err_msg=name)
        else:
            np.testing.assert_array_equal(got[name], want, err_msg=name)
    s = port.state
    assert int(s.outage_events) > 0 and int(s.cache_hits) > 0 and int(s.cold_starts) > 0
