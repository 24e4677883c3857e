"""The CUDA kernels of ``repro_torch`` against their plain versions.

The ``cuda``-marked tests need a card with sm_90 and skip without one;
on the GPU machine they run with

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

This file imports no JAX, so it runs where only PyTorch is installed.
The unmarked tests check, on the CPU, the build and argument checks
that stand between a wrapper and its kernel.
"""
import copy
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import (
    DEFAULT_POINTS,
    SimParams,
    fleet_run,
    generate_workload,
    make_workload_batch,
    policy_grid_workloads,
    retry_storm_params,
    run,
    scenario_lane_batch,
    workload_batch_from_traces,
    workload_to_trace_records,
)
from repro_torch.configs import get_arch, list_archs
from repro_torch.core.state import workload_lane
from repro_torch.kernels import (
    KERNELS,
    LM_KERNELS,
    SIM_KERNELS,
    cuda_lib,
    launch_counts,
    reset_launch_counts,
)
from repro_torch.kernels.flash_attention import (
    flash_attention,
    flash_attention_bwd,
    flash_attention_bwd_ref,
    flash_attention_fwd_lse_ref,
)
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.flash_attention.ref import NEG_INF, first_dead_row
from repro_torch.kernels.rwkv6_scan import ops as rwkv6_ops
from repro_torch.kernels.rwkv6_scan import rwkv6_scan, rwkv6_scan_bwd
from repro_torch.kernels.sched_select import (
    masked_lex_argmin,
    masked_lex_argmin_ref,
    select_sjf,
    select_sjf_ref,
)
from repro_torch.kernels.sim_tick import fleet_tick, fleet_tick_ref
from repro_torch.kernels.ssm_scan import ssm_scan, ssm_scan_bwd
from repro_torch.kernels.ssm_scan import ops as ssm_ops
from repro_torch.kernels.state_update import (
    assign_gather,
    assign_gather_ref,
    retire_land,
    retire_land_ref,
)
from repro_torch.kernels.state_update import ops as state_update_ops

INF = 2**31 - 1
F, MC, MP, K = 64, 64, 256, 16


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device with sm_90 (the kernels are built for Hopper)")
    return torch.device("cuda")


def _pair(arrays, dev):
    """The same inputs as CPU tensors and as CUDA tensors."""
    cpu = tuple(None if a is None else torch.from_numpy(np.ascontiguousarray(a)) for a in arrays)
    return cpu, tuple(None if a is None else a.to(dev) for a in cpu)


def _equal(got, want):
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.dtype == b.dtype and a.shape == b.shape, i
        assert torch.equal(a.cpu(), b), f"output {i}"


@pytest.mark.cuda
@pytest.mark.parametrize("NP", [1, 3])
def test_fleet_tick_kernel_matches_plain(cuda, NP):
    rng = np.random.default_rng(NP)
    t = rng.integers(0, 100, F).astype(np.int32)
    arrays = (
        rng.integers(0, 2, (F, MC)).astype(np.int32),
        rng.integers(0, 100, (F, MC)).astype(np.int32),
        np.where(rng.random((F, MC)) < 0.3, rng.integers(0, 100, (F, MC)), INF).astype(np.int32),
        (rng.random((F, MC)) * 4).astype(np.float32),
        (rng.random((F, MC)) * 8).astype(np.float32),
        rng.integers(0, NP, (F, MC)).astype(np.int32),
        np.asarray([0, 2, 4], np.int32)[rng.integers(0, 3, (F, MP))],
        rng.integers(0, 150, (F, MP)).astype(np.int32),
        rng.integers(0, 150, (F, MP)).astype(np.int32),
        t,
    )
    cpu, dev = _pair(arrays, cuda)
    _equal(fleet_tick(*dev, num_pools=NP), fleet_tick_ref(*cpu, num_pools=NP))


@pytest.mark.cuda
@pytest.mark.parametrize("mp", [200, 1024])
@pytest.mark.parametrize("mc", [33, 200, 1000])
def test_fleet_tick_kernel_matches_plain_at_ragged_sizes(cuda, mc, mp):
    """Ragged runs of containers (a partial last run), 8 pools, wide
    exponents in the freed terms, and lane 0 with every container
    retiring."""
    NP = 8
    rng = np.random.default_rng(mc + mp)
    t = rng.integers(0, 100, F).astype(np.int32)
    status = rng.integers(0, 2, (F, mc)).astype(np.int32)
    end = rng.integers(0, 100, (F, mc)).astype(np.int32)
    status[0], end[0] = 1, t[0]
    arrays = (
        status, end,
        np.where(rng.random((F, mc)) < 0.3, rng.integers(0, 100, (F, mc)), INF).astype(np.int32),
        (rng.random((F, mc)) * 10.0 ** rng.integers(-3, 4, (F, mc))).astype(np.float32),
        (rng.random((F, mc)) * 10.0 ** rng.integers(-3, 4, (F, mc))).astype(np.float32),
        rng.integers(0, NP, (F, mc)).astype(np.int32),
        np.asarray([0, 2, 4], np.int32)[rng.integers(0, 3, (F, mp))],
        rng.integers(0, 150, (F, mp)).astype(np.int32),
        rng.integers(0, 150, (F, mp)).astype(np.int32),
        t,
    )
    cpu, dev = _pair(arrays, cuda)
    reset_launch_counts()
    got = fleet_tick(*dev, num_pools=NP)
    torch.cuda.synchronize()
    assert launch_counts()["fleet_tick"] == 1
    want = fleet_tick_ref(*cpu, num_pools=NP)
    assert bool(want[1][0].logical_or(want[0][0]).all())   # lane 0: all retire
    _equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("mp", [32, 200, 256, 1024])
def test_retire_land_kernel_matches_plain(cuda, mp):
    rng = np.random.default_rng(mp)
    t = rng.integers(10_000, 50_000, F).astype(np.int32)
    end = (t[:, None] - rng.integers(0, 4, (F, MC))).astype(np.int32)
    u = rng.random((F, MC))
    arrays = (
        rng.integers(-1, max(mp // 4, 2), (F, MC)).astype(np.int32), end,
        (end - rng.integers(1, 5_000, (F, MC))).astype(np.int32),
        u < 0.25, (u >= 0.25) & (u < 0.7), None,
        (t[:, None] - rng.integers(5_000, 9_000, (F, mp))).astype(np.int32),
        rng.integers(-1, 4, (F, mp)).astype(np.int32), t,    # priorities outside 0..2 too
    )
    cpu, dev = _pair(arrays, cuda)
    reset_launch_counts()
    got = retire_land(*dev)
    torch.cuda.synchronize()
    assert launch_counts()["retire_land"] == 1
    _equal(got, retire_land_ref(*cpu))


@pytest.mark.cuda
@pytest.mark.parametrize("mp", [32, 256, 1024])
def test_retire_land_timeout_kernel_matches_plain(cuda, mp):
    """The timeout branch: about a quarter of the completing containers
    timed, several timed and done containers on one pipeline."""
    rng = np.random.default_rng(mp + 1)
    t = rng.integers(10_000, 50_000, F).astype(np.int32)
    end = (t[:, None] - rng.integers(0, 4, (F, MC))).astype(np.int32)
    u = rng.random((F, MC))
    arrays = (
        rng.integers(-1, max(mp // 8, 2), (F, MC)).astype(np.int32), end,
        (end - rng.integers(1, 5_000, (F, MC))).astype(np.int32),
        u < 0.2, (u >= 0.2) & (u < 0.7), rng.random((F, MC)) < 0.25,
        (t[:, None] - rng.integers(5_000, 9_000, (F, mp))).astype(np.int32),
        rng.integers(0, 3, (F, mp)).astype(np.int32), t,
    )
    cpu, dev = _pair(arrays, cuda)
    reset_launch_counts()
    got = retire_land(*dev, timeout_on=True)
    torch.cuda.synchronize()
    assert launch_counts()["retire_land"] == 1 and retire_land.timeout_launches == 1
    want = retire_land_ref(*cpu, timeout_on=True)
    _equal(got, want)
    assert bool((want[2] & want[1]).any()) and int(want[4].sum()) != 0


@pytest.mark.cuda
def test_chaos_run_on_the_card_matches_the_cpu_port(cuda):
    """Crashes, outages, stragglers, timeouts and retries: a 3-lane
    fleet on CUDA equals the CPU port field by field, and the timeout
    branch of retire_land ran."""
    params = SimParams(duration=0.05, max_pipelines=32, max_containers=32, num_pools=2,
                       scheduling_algo="priority_pool", waiting_ticks_mean=300.0,
                       op_base_seconds_mean=0.005, crash_mtbf_ticks=500.0,
                       outage_mtbf_ticks=1_500.0, outage_duration_ticks=300.0,
                       straggler_prob=0.15, timeout_ticks=400, max_retries=1,
                       base_backoff_ticks=40)
    reset_launch_counts()
    on_card = fleet_run(params, seeds=[0, 1, 2], device=cuda)
    counts = launch_counts()
    on_cpu = fleet_run(params, seeds=[0, 1, 2], device="cpu")
    assert all(counts[name] > 0 for name in SIM_KERNELS), counts
    assert retire_land.timeout_launches == counts["retire_land"]
    tolerant = {"sum_latency_s", "sum_latency_s_prio", "util_cpu_s", "util_ram_s",
                "cost_dollars", "util_log", "pool_down_s"}
    for name in on_cpu._fields:
        a, b = getattr(on_card, name).cpu(), getattr(on_cpu, name)
        if name in tolerant:
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, err_msg=name)
        else:
            assert torch.equal(a, b), name
    for name in ("crash_events", "outage_events", "timeout_events", "fault_kills"):
        assert int(getattr(on_cpu, name).sum()) > 0, name


@pytest.mark.cuda
@pytest.mark.parametrize("mixed", [False, True])
def test_masked_lex_argmin_kernel_matches_plain(cuda, mixed):
    rng = np.random.default_rng(int(mixed))
    N = MP if mixed else MC
    mask = rng.random((F, N)) < 0.35
    mask[:3] = False
    prio = rng.integers(0, 3, (F, N)).astype(np.int32)
    ticks = (rng.integers(0, 6, (F, N)) * 100).astype(np.int32)
    keys = ((rng.integers(0, 3, (F, N)) * 0.5).astype(np.float32), -prio, ticks) if mixed else (prio, -ticks)
    cpu, dev = _pair((mask, *keys), cuda)
    _equal([masked_lex_argmin(dev[0], dev[1:])], [masked_lex_argmin_ref(cpu[0], cpu[1:])])


NAN, INF_F = float("nan"), float("inf")
# rows whose keys take the sweeps off the tuple minimum: NaN, signed
# zeros, infinities, keys at and above their sentinel
SELECT_EDGE_ROWS = {
    "nan-last-key": ([1, 1, 1], [("i4", [0, 0, 0]), ("f4", [2, NAN, 1])]),
    "nan-first-key": ([1, 1, 0], [("f4", [NAN, 1, 0]), ("i4", [2, 3, 1])]),
    "nan-k1": ([0, 1, 1, 1], [("f4", [NAN, 1, NAN, NAN])]),
    "zero-signs": ([1, 1, 1, 1], [("f4", [0.0, -0.0, 0.0, -0.0]), ("i4", [5, 3, 3, 4])]),
    "inf": ([1, 1, 1, 1], [("f4", [INF_F, -INF_F, -INF_F, 1.0]), ("i4", [0, 2, 1, 0])]),
    "inf-full-row": ([1, 1, 1], [("f4", [INF_F, INF_F, INF_F]), ("i4", [1, 0, 2])]),
    "f32-at-sentinel": ([1, 0], [("f4", [2.0**31, 0.0]), ("i4", [0, 0])]),
    "f32-above-sentinel-full-row": ([1, 1, 1], [("f4", [2.0**32, 2.0**32, 3e9]),
                                                ("i4", [1, 0, 2])]),
    "i32-at-sentinel-later-key": ([1, 1, 0, 0], [("i4", [0, 0, 5, 0]), ("i4", [INF, INF, 1, 0]),
                                                 ("i4", [5, 4, 3, 9])]),
    "i32-at-sentinel-first-key": ([1, 1, 1], [("i4", [INF, INF, INF]), ("i4", [2, 1, 0])]),
    "k1": ([0, 1, 1, 1], [("i4", [0, 4, 2, 2])]),
}


def _select_on_card(cuda, mask, keys):
    """The kernel on the card (one launch) and the plain version on the
    CPU, on the same rows; their answers must be equal."""
    cpu, dev = _pair((mask, *keys), cuda)
    reset_launch_counts()
    got = masked_lex_argmin(dev[0], dev[1:])
    torch.cuda.synchronize()
    assert launch_counts()["masked_lex_argmin"] == 1
    _equal([got], [masked_lex_argmin_ref(cpu[0], cpu[1:])])


@pytest.mark.cuda
@pytest.mark.parametrize("width", [None, 256], ids=["own-width", "in-256"])
@pytest.mark.parametrize("name", list(SELECT_EDGE_ROWS))
def test_masked_lex_argmin_kernel_matches_plain_on_edge_keys(cuda, name, width):
    """Each edge row alone, and set at the start of rows of 256 entries
    (16-byte loads) beside unmasked and masked zero keys."""
    mask, keys = SELECT_EDGE_ROWS[name]
    m = np.asarray([mask, mask], bool)
    ks = [np.asarray([v, v[::-1]], np.dtype(dt)) for dt, v in keys]
    if width:
        pad = width - m.shape[1]
        m = np.concatenate([m, np.arange(2 * pad).reshape(2, pad) % 3 == 0], axis=1)
        ks = [np.concatenate([k, np.zeros((2, pad), k.dtype)], axis=1) for k in ks]
    _select_on_card(cuda, m, ks)


F32_SPECIAL = np.array([0.0, -0.0, 1.0, -1.0, np.inf, -np.inf, np.nan, 2.0**31, 2.0**32,
                        2.0**31 - 128, 3e9], np.float32)
I32_SPECIAL = np.array([0, 1, -1, INF, INF - 1, -INF, -(2**31)], np.int32)


@pytest.mark.cuda
@pytest.mark.parametrize("N", [1, 33, 64, 200, 256, 1024])
@pytest.mark.parametrize("kind", ["main-path", "adversarial"])
def test_masked_lex_argmin_kernel_matches_plain_at_widths(cuda, N, kind):
    """The head's keys with real f32 leads (a weighted sum of op counts,
    entry ticks and priorities, as the scheduler forms them), and keys
    drawn a fifth of the time from NaN, signed zeros, infinities and
    the sentinels, at K = 1, 2, 3 in every dtype mix; some lanes empty,
    some full."""
    rng = np.random.default_rng(N)
    mask = rng.random((F, N)) < np.resize([0.0, 0.05, 0.35, 1.0], F)[:, None]
    if kind == "main-path":
        n_ops = rng.integers(1, 9, (F, N))
        entered = rng.integers(0, 40, (F, N)) * 1_000
        prio = rng.integers(0, 3, (F, N))
        lead = (0.37 * n_ops + 1e-3 * entered - 2.5 * prio).astype(np.float32)
        _select_on_card(cuda, mask, (lead, (-prio).astype(np.int32), entered.astype(np.int32)))
        return
    for K in (1, 2, 3):
        for f32_keys in range(2**K):
            keys = []
            for j in range(K):
                odd = rng.random((F, N)) < 0.2
                if (f32_keys >> j) & 1:
                    small = (rng.integers(0, 3, (F, N)) * 0.5).astype(np.float32)
                    keys.append(np.where(odd, rng.choice(F32_SPECIAL, (F, N)), small).astype(np.float32))
                else:
                    small = rng.integers(-1, 3, (F, N)).astype(np.int32)
                    keys.append(np.where(odd, rng.choice(I32_SPECIAL, (F, N)), small).astype(np.int32))
            _select_on_card(cuda, mask, keys)


@pytest.mark.cuda
@pytest.mark.parametrize("N,shift", [(201, "row"), (256, "element")])
def test_masked_lex_argmin_kernel_on_unaligned_rows(cuda, N, shift):
    """Rows whose starts are not 16-byte aligned go through the scalar
    loads: a contiguous ``big[1:]`` with N % 4 != 0, and a view one
    element into its storage with N % 4 == 0."""
    rng = np.random.default_rng(N)
    mask = rng.random((F + 1, N)) < 0.4
    keys = (rng.standard_normal((F + 1, N)).astype(np.float32),
            rng.integers(0, 3, (F + 1, N)).astype(np.int32))
    cpu = [torch.from_numpy(x) for x in (mask, *keys)]
    if shift == "row":
        dev = [x.to(cuda)[1:] for x in cpu]
        cpu = [x[1:] for x in cpu]
    else:
        dev = [x.to(cuda).flatten()[1:1 + F * N].view(F, N) for x in cpu]
        cpu = [x.flatten()[1:1 + F * N].view(F, N) for x in cpu]
    assert all(x.is_contiguous() and x.data_ptr() % 16 for x in dev[1:])
    _equal([masked_lex_argmin(dev[0], dev[1:])], [masked_lex_argmin_ref(cpu[0], cpu[1:])])


@pytest.mark.cuda
def test_masked_lex_argmin_kernel_on_a_wide_fleet(cuda):
    rng = np.random.default_rng(4096)
    Fw, N = 4096, 256
    mask = rng.random((Fw, N)) < 0.3
    mask[::7] = False
    keys = ((rng.integers(0, 5, (Fw, N)) * 0.25).astype(np.float32),
            -rng.integers(0, 3, (Fw, N)).astype(np.int32),
            rng.integers(0, 50, (Fw, N)).astype(np.int32))
    _select_on_card(cuda, mask, keys)


def _assign_arrays(rng, lanes, k, mc, mp, edge):
    """Assignment rows at ``[lanes, k]``: the engine's (unique slots and
    pipes) or, with ``edge``, slots and pipes of -1, ``mc`` and ``mp`` on
    valid and invalid rows, lane 0 without a valid row, and on lane 1
    two valid rows sharing a slot and two sharing a pipe."""
    valid = rng.random((lanes, k)) < 0.6
    slot = np.stack([rng.permutation(max(mc, k))[:k] for _ in range(lanes)])
    pipe = np.stack([rng.permutation(max(mp, k))[:k] for _ in range(lanes)])
    if edge:
        valid[0] = False
        slot = np.where(rng.random((lanes, k)) < 0.15, rng.choice([-1, mc], (lanes, k)), slot)
        pipe = np.where(rng.random((lanes, k)) < 0.15, rng.choice([-1, mp], (lanes, k)), pipe)
        if k >= 4:
            valid[1, :4] = True
            slot[1, :4] = [mc - 1, 0, mc - 1, 1]
            pipe[1, :4] = [2, mp - 1, 3, mp - 1]
    return (
        valid, slot.astype(np.int32), pipe.astype(np.int32),
        rng.integers(0, 3, (lanes, k)).astype(np.int32),
        (rng.standard_normal((lanes, k)) * 8).astype(np.float32),
        (rng.standard_normal((lanes, k)) * 16).astype(np.float32),
        rng.integers(-2**31, 2**31 - 1, (lanes, k)).astype(np.int32),
        np.where(rng.random((lanes, k)) < 0.5, INF, rng.integers(0, 9_000, (lanes, k))).astype(np.int32),
        rng.integers(-1, 4, (lanes, k)).astype(np.int32),
        rng.random((lanes, k)) < 0.5,
        rng.random((lanes, k)) < 0.5,
    )


# (lanes, K, MC, MP, edge rows): the main path's shapes, then the edge
# grid of chip_smoke.py's phase 3 (scalar stores where MC or MP is not a
# multiple of 4, K past a warp, past MC and past the block's 128 threads,
# a wide fleet)
ASSIGN_CASES = [
    (F, K, MC, MP, False),
    (F, 1, 33, 200, True),
    (F, 33, 33, 1024, True),
    (F, 64, 1000, 200, True),
    (F, 64, 1000, 1024, True),
    (F, 33, 64, 256, True),
    (F, 200, 33, 256, True),
    (F, 129, 64, 1024, True),
    (4096, K, MC, MP, True),
]


@pytest.mark.cuda
@pytest.mark.parametrize("lanes,k,mc,mp,edge", ASSIGN_CASES,
                         ids=lambda v: str(v))
def test_assign_gather_kernel_matches_plain(cuda, lanes, k, mc, mp, edge):
    rng = np.random.default_rng(k * mc + mp)
    cpu, dev = _pair(_assign_arrays(rng, lanes, k, mc, mp, edge), cuda)
    kw = dict(max_containers=mc, max_pipelines=mp)
    reset_launch_counts()
    got = assign_gather(*dev, **kw)
    assert launch_counts()["assign_gather"] == 1
    _equal(got, assign_gather_ref(*cpu, **kw))


@pytest.mark.cuda
def test_fleet_replayed_from_trace_records_on_the_card(cuda):
    """Eight seed-built lanes, as trace records and back, on the card:
    equal to the seed-built fleet on every field."""
    params = SimParams(duration=0.05, max_pipelines=32, max_containers=32,
                       waiting_ticks_mean=300.0, op_base_seconds_mean=0.005)
    wls = make_workload_batch(params, list(range(8)))
    days = [workload_to_trace_records(workload_lane(wls, i)) for i in range(8)]
    batch, batch_params = workload_batch_from_traces(days, params)
    assert batch_params == params
    reset_launch_counts()
    replayed = fleet_run(params, workloads=batch, device=cuda)
    assert all(n > 0 for name, n in launch_counts().items() if name in SIM_KERNELS)
    seeded = fleet_run(params, workloads=wls, device=cuda)
    for name in seeded._fields:
        assert torch.equal(getattr(replayed, name), getattr(seeded, name)), name


@pytest.mark.cuda
def test_main_path_goes_through_every_kernel(cuda):
    params = SimParams(duration=0.05, max_pipelines=32, max_containers=32,
                       waiting_ticks_mean=300.0, op_base_seconds_mean=0.005)
    reset_launch_counts()
    on_card = fleet_run(params, seeds=[0, 1, 2], device=cuda)
    counts = launch_counts()
    on_cpu = fleet_run(params, seeds=[0, 1, 2], device="cpu")
    assert all(counts[name] > 0 for name in SIM_KERNELS), counts
    for name in ("pipe_status", "pipe_completion", "pool_cpu_free", "done_count"):
        assert torch.equal(getattr(on_card, name).cpu(), getattr(on_cpu, name)), name


@pytest.mark.cuda
@pytest.mark.parametrize("seed", range(3))
def test_masked_lex_argmin_kernel_at_the_sjf_key_set(cuda, seed):
    """``select_sjf``'s three int32 keys (op counts 1..8, so the lead key
    ties often) through the kernel, exactly as the plain version."""
    rng = np.random.default_rng(300 + seed)
    mask = rng.random((F, MP)) < 0.4
    mask[:2] = False
    n_ops = rng.integers(1, 9, (F, MP)).astype(np.int32)
    prio = rng.integers(0, 3, (F, MP)).astype(np.int32)
    entered = rng.integers(0, 50, (F, MP)).astype(np.int32) * 1_000
    cpu, dev = _pair((mask, n_ops, prio, entered), cuda)
    reset_launch_counts()
    got = select_sjf(*dev)
    assert launch_counts()["masked_lex_argmin"] == 1
    _equal((got,), (select_sjf_ref(*cpu),))


@pytest.mark.cuda
@pytest.mark.parametrize("seed", range(3))
def test_masked_lex_argmin_kernel_with_per_lane_leads(cuda, seed):
    """The ``"policy"`` family's f32 lead key, with weights drawn per
    lane in the search box: a different lead in every lane."""
    rng = np.random.default_rng(400 + seed)
    mask = rng.random((F, MP)) < 0.4
    n_ops = rng.integers(1, 9, (F, MP)).astype(np.int32)
    prio = rng.integers(0, 3, (F, MP)).astype(np.int32)
    entered = rng.integers(0, 100_000, (F, MP)).astype(np.int32)
    w = rng.random((3, F, 1)).astype(np.float32) * np.float32([[[2.0]], [[1e-3]], [[2.0]]])
    cpu, dev = _pair((mask, n_ops, prio, entered, *w), cuda)

    def keys(mask, n_ops, prio, entered, sw, aw, pw):
        f32 = torch.float32
        lead = sw * n_ops.to(f32) + aw * entered.to(f32) - pw * prio.to(f32)
        return mask, (lead, -prio, entered)

    m_dev, k_dev = keys(*dev)
    m_cpu, k_cpu = keys(*cpu)
    assert torch.equal(k_dev[0].cpu(), k_cpu[0])
    got = masked_lex_argmin(m_dev, k_dev)
    _equal((got,), (masked_lex_argmin_ref(m_cpu, k_cpu),))


def _data_plane_params(**kw):
    return SimParams(duration=0.05, num_pools=2, max_pipelines=32, max_containers=32,
                     waiting_ticks_mean=300.0, op_base_seconds_mean=0.005, op_out_gb_mean=2.0,
                     cache_gb_per_pool=4.0, scan_ticks_per_gb=50.0, cold_start_ticks=40,
                     container_warm_ticks=2_000, **kw)


def _assert_contract(on_card, on_cpu):
    tolerant = {"sum_latency_s", "sum_latency_s_prio", "util_cpu_s", "util_ram_s",
                "cost_dollars", "util_log", "pool_down_s"}
    for name in on_cpu._fields:
        a, b = getattr(on_card, name).cpu(), getattr(on_cpu, name)
        assert a.dtype == b.dtype and a.shape == b.shape, name
        if name in tolerant:
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, err_msg=name)
        else:
            assert torch.equal(a, b), name


@pytest.mark.cuda
@pytest.mark.parametrize("algo", ["cache_aware", "sjf"])
def test_data_plane_run_on_the_card(cuda, algo):
    params = _data_plane_params(scheduling_algo=algo)
    wl = generate_workload(params)
    reset_launch_counts()
    on_card = run(params, wl, device=cuda)
    assert all(n > 0 for name, n in launch_counts().items() if name in SIM_KERNELS)
    on_cpu = run(params, wl, device="cpu")
    _assert_contract(on_card.state, on_cpu.state)
    s = on_card.summary()
    assert s["cold_starts"] > 0 and s["cache_lookups"] > 0


@pytest.mark.cuda
def test_policy_grid_on_the_card(cuda):
    """Two seeds under the six named points: 12 lanes of ``"policy"`` on
    the card equal the CPU port's, and each point's lanes equal its
    named scheduler's fleet bit for bit."""
    params = _data_plane_params()
    scen = make_workload_batch(params, [0, 1])
    names = sorted(DEFAULT_POINTS)
    grid, C, S = policy_grid_workloads(scen, [DEFAULT_POINTS[k] for k in names])
    on_card = fleet_run(params, workloads=grid, scheduler_key="policy", device=cuda)
    _assert_contract(on_card, fleet_run(params, workloads=grid, scheduler_key="policy",
                                        device="cpu"))
    for c, key in enumerate(names):
        named = fleet_run(params, workloads=scen, scheduler_key=key, device=cuda)
        for name in named._fields:
            assert torch.equal(getattr(on_card, name)[c * S:(c + 1) * S],
                               getattr(named, name)), (key, name)


@pytest.mark.cuda
def test_closed_loop_run_on_the_card(cuda):
    """Clients, a queue threshold, client retries and outages: ``run`` on
    CUDA equals the CPU port under the contract."""
    params = SimParams(duration=0.04, max_pipelines=32, max_containers=32, num_pools=2,
                       waiting_ticks_mean=400.0, op_base_seconds_mean=0.005,
                       op_base_seconds_sigma=1.0, outage_mtbf_ticks=1_200.0,
                       outage_duration_ticks=300.0, max_retries=3, base_backoff_ticks=40,
                       client_max_inflight=6, client_think_ticks=30, client_max_retries=3,
                       client_backoff_ticks=40, admission_policy="queue_threshold",
                       admit_queue_limit=4, metastable_window_ticks=400)
    wl = generate_workload(params)
    reset_launch_counts()
    on_card = run(params, wl, device=cuda)
    assert all(launch_counts()[name] > 0 for name in SIM_KERNELS)
    _assert_contract(on_card.state, run(params, wl, device="cpu").state)
    assert int(on_card.state.offered_total) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("policy,knobs", [
    ("admit_all", {}),
    ("queue_threshold", dict(admit_queue_limit=3)),
    ("token_bucket", dict(admit_rate_per_s=400.0, admit_burst=4.0)),
    ("codel", dict(codel_target_ticks=400, codel_interval_ticks=200)),
], ids=lambda v: v if isinstance(v, str) else "")
def test_retry_storm_fleet_on_the_card(cuda, policy, knobs):
    """Eight ``retry_storm`` lanes (``benchmarks/run.py``'s overload smoke
    at half its length) under each admission policy: ``fleet_run`` on
    CUDA equals the CPU port lane by lane."""
    base = SimParams(duration=0.04, max_pipelines=0, max_ops_per_pipeline=0,
                     max_containers=16, waiting_ticks_mean=150.0, op_base_seconds_mean=0.008,
                     op_base_seconds_sigma=1.0, num_pools=2, total_cpus=4, total_ram_gb=8,
                     scheduling_algo="priority_pool")
    lanes = scenario_lane_batch("retry_storm", base.replace(duration=0.03), 8, seed=11,
                                surge_factor=6.0)
    wls, params = workload_batch_from_traces(lanes, base)
    params = retry_storm_params(params, admission_policy=policy, outage_mtbf_s=0.01,
                                outage_duration_s=0.003, client_max_retries=3
                                ).replace(max_fault_events=2, **knobs)
    reset_launch_counts()
    on_card = fleet_run(params, workloads=wls, device=cuda)
    assert all(launch_counts()[name] > 0 for name in SIM_KERNELS)
    _assert_contract(on_card, fleet_run(params, workloads=wls, device="cpu"))
    assert int(on_card.offered_total.sum()) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("knobs", [
    {},
    dict(crash_mtbf_ticks=400.0, outage_mtbf_ticks=1_200.0, outage_duration_ticks=250.0,
         straggler_prob=0.1, timeout_ticks=400, max_retries=3, base_backoff_ticks=50,
         client_max_inflight=6, client_think_ticks=30, client_max_retries=3,
         client_backoff_ticks=40, admission_policy="queue_threshold", admit_queue_limit=2),
], ids=["plain", "chaos-closed-loop"])
def test_traced_fleet_on_the_card(cuda, knobs):
    """``fleet_run(trace=True)`` on CUDA: the states equal the untraced
    run's bit for bit, and the records, counts and ``dropped`` equal the
    CPU port's traced run; the decision provenance adds one
    ``masked_lex_argmin`` launch an event."""
    params = _data_plane_params(scheduling_algo="priority_pool", **knobs)
    wls = make_workload_batch(params, [0, 1, 2, 3])
    reset_launch_counts()
    untraced = fleet_run(params, workloads=wls, device=cuda)
    plain = launch_counts()
    reset_launch_counts()
    states, traces = fleet_run(params, workloads=wls, device=cuda, trace=True,
                               trace_capacity=512)
    traced = launch_counts()
    for name in untraced._fields:
        assert torch.equal(getattr(states, name), getattr(untraced, name)), name
    assert traced == {**plain, "masked_lex_argmin": plain["masked_lex_argmin"]
                      + traced["fleet_tick"]}
    _, cpu_traces = fleet_run(params, workloads=wls, device="cpu", trace=True,
                              trace_capacity=512)
    for a, b in zip(traces, cpu_traces):
        assert (a.n, a.events_dropped) == (b.n, b.events_dropped)
        np.testing.assert_array_equal(a.records, b.records)
    assert sum(t.n for t in traces) > 0


@pytest.mark.cuda
def test_evaluate_policies_on_the_card(cuda):
    """``evaluate_policies`` of the six named points over two ``bursty``
    lanes on CUDA equals the CPU port's objectives under the contract."""
    from repro_torch.search import evaluate_policies, scenario_factory

    arena = SimParams(max_pipelines=24, max_containers=32, duration=0.03,
                      waiting_ticks_mean=500.0, op_base_seconds_mean=0.002, num_pools=2,
                      total_cpus=4, total_ram_gb=8, cache_gb_per_pool=4.0,
                      scan_ticks_per_gb=100.0, cold_start_ticks=40, cloud_scaling=True)
    points = [DEFAULT_POINTS[k] for k in sorted(DEFAULT_POINTS)]
    reset_launch_counts()
    got = evaluate_policies(scenario_factory("bursty", arena, 2, seed=7, device=cuda), points,
                            device=cuda)
    assert all(launch_counts()[name] > 0 for name in SIM_KERNELS)
    want = evaluate_policies(scenario_factory("bursty", arena, 2, seed=7, device="cpu"),
                             points, device="cpu")
    assert (got["C"], got["S"]) == (want["C"], want["S"]) == (len(points), 2)
    np.testing.assert_allclose(got["objectives"], want["objectives"], rtol=1e-5, atol=0)


# ---------------------------------------------------------------------------
# The LM kernels: float kernels, held to their plain versions (run on the
# CPU) at the stated tolerance, f32 rtol=atol=2e-4, bf16 2e-2: the sums
# run in another order, and bf16 outputs round an ulp apart.
# ---------------------------------------------------------------------------
TOLS = {torch.float32: dict(rtol=2e-4, atol=2e-4), torch.bfloat16: dict(rtol=2e-2, atol=2e-2)}


def _close(got, want, dtype):
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_allclose(got.float().cpu().numpy(), want.float().numpy(), **TOLS[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("B,S,H,N,chunk", [(2, 64, 3, 16, 16), (1, 45, 2, 64, 32), (1, 20, 4, 16, 8),
                                            (2, 77, 3, 64, 32)])   # ragged, B = 2, two column slices
def test_rwkv6_scan_kernel_matches_plain(cuda, B, S, H, N, chunk, dtype):
    rng = np.random.default_rng(S)
    base = np.linspace(-6.0, -0.3, H * N).reshape(H, N)   # the model's decay range
    w = np.exp(-np.exp(base + 0.1 * rng.standard_normal((B, S, H, N))))
    arrays = [rng.standard_normal((B, S, H, N)), rng.standard_normal((B, S, H, N)) * 0.5,
              rng.standard_normal((B, S, H, N))]
    cpu = [torch.from_numpy(a.astype(np.float32)).to(dtype) for a in arrays]
    cpu += [torch.from_numpy(w.astype(np.float32)),
            torch.from_numpy((rng.standard_normal((H, N)) * 0.3).astype(np.float32)),
            torch.from_numpy((rng.standard_normal((B, H, N, N)) * 0.1).astype(np.float32))]
    dev = [x.to(cuda) for x in cpu]
    reset_launch_counts()
    out, state = rwkv6_scan(*dev, chunk=chunk)
    torch.cuda.synchronize()
    assert launch_counts()["rwkv6_scan"] == 1
    want_out, want_state = rwkv6_scan(*cpu, chunk=chunk)
    _close(out, want_out, dtype)
    _close(state, want_state, torch.float32)


FLASH_CUDA_CASES = [
    # B, Sq, Skv, H, KV, D, causal, window, q_offset, kv_len
    (1, 64, 64, 2, 2, 32, True, 0, 0, None),
    (2, 128, 128, 4, 1, 64, False, 0, 0, None),      # MQA, not causal
    (1, 256, 256, 8, 4, 32, True, 64, 0, None),      # sliding window
    (1, 96, 96, 2, 2, 32, True, 0, 0, None),         # ragged tiles
    (1, 20, 20, 4, 2, 24, True, 8, 0, None),         # gemma3 smoke local layer
    (2, 20, 48, 4, 2, 24, True, 0, 0, 20),           # gemma3 smoke global layer
    (1, 8, 64, 4, 2, 32, True, 8, 20, 28),           # query offset + window
    (1, 130, 256, 16, 8, 256, True, 64, 0, 130),     # gemma3_12b head width
    (1, 256, 256, 16, 2, 128, True, 0, 0, None),     # jamba's head width, G = 8
    (1, 100, 384, 4, 2, 256, True, 96, 150, 250),    # D 256: q_offset, kv_len and window
    (2, 200, 200, 8, 4, 64, True, 0, 0, None),       # Sq not a multiple of the query tile
    (1, 200, 200, 4, 4, 96, True, 0, 0, None),       # phi3's head width 96 (padded to 128)
    (1, 64, 300, 2, 2, 96, False, 0, 0, None),       # D 96 over five key tiles, both ring stages
    (1, 130, 256, 48, 1, 128, True, 0, 0, 130),      # granite's MQA: 48 heads on one KV head
    (2, 300, 1500, 4, 4, 64, False, 0, 0, None),     # whisper's encoder: 1,500 keys, not causal
    (2, 4, 1500, 4, 4, 64, False, 0, 0, None),       # cross-attention at prefill (Sq 4)
    (3, 1, 1500, 12, 12, 64, False, 0, 0, None),     # cross-attention at a decode step (Sq 1)
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("B,Sq,Skv,H,KV,D,causal,window,q_offset,kv_len", FLASH_CUDA_CASES)
def test_flash_attention_kernel_matches_plain(cuda, B, Sq, Skv, H, KV, D, causal, window,
                                              q_offset, kv_len, dtype):
    rng = np.random.default_rng(Sq + D)
    cpu = [torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dtype)
           for shape in ((B, Sq, H, D), (B, Skv, KV, D), (B, Skv, KV, D))]
    kw = dict(causal=causal, window=window, q_offset=q_offset, kv_len=kv_len)
    reset_launch_counts()
    got = flash_attention(*(x.to(cuda) for x in cpu), **kw)
    torch.cuda.synchronize()
    assert launch_counts()["flash_attention"] == 1
    _close(got, flash_attention(*cpu, **kw), dtype)


FLASH_BWD_CUDA_CASES = [
    # B, Sq, Skv, H, KV, D, causal, window[, q_offset, kv_len]
    (2, 96, 96, 4, 2, 32, True, 0),       # causal GQA, ragged tiles
    (1, 130, 130, 4, 2, 24, True, 16),    # sliding window, head dim 24
    (2, 100, 100, 4, 1, 64, False, 0),    # not causal, MQA
    (2, 20, 150, 4, 4, 64, False, 0),     # Sq != Skv: cross-attention
    (1, 70, 70, 4, 4, 96, True, 0),       # phi3's head dim 96
    (1, 72, 72, 4, 2, 256, True, 8),      # gemma3's 256 with a window
    (1, 33, 33, 2, 2, 16, True, 0),       # the smoke configs' head dim 16
    (1, 2048, 2048, 16, 8, 64, True, 0),  # B Sq Skv H D = 2^32: no int product of the sizes
    (1, 1100, 1100, 4, 2, 96, True, 0),   # D 96 over 18 key and 9 query tiles
    (1, 300, 300, 4, 2, 256, True, 100),  # D 256, a window over several tiles of each
    (1, 100, 256, 4, 2, 64, True, 0, 120, 220),   # a query offset and kv_len < Skv
    (2, 70, 160, 4, 2, 32, False, 0, 0, 100),     # kv_len < Skv, not causal
    (1, 90, 300, 4, 4, 128, True, 64, 150, 200),  # a window with an offset
    (1, 80, 200, 4, 2, 64, True, 16, 100, 150),   # rows 65-79 see no key
    (1, 20, 1100, 2, 1, 256, True, 8, 1090, 1095),  # rows 13-19 see none, L = 2,048
]


def _flash_bwd_inputs(case, dtype):
    B, Sq, Skv, H, KV, D, causal, window, *cache = case
    q_offset, kv_len = cache or (0, None)
    rng = np.random.default_rng(Sq * 7 + D)
    q, k, v, dout = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dtype)
                     for shape in ((B, Sq, H, D), (B, Skv, KV, D), (B, Skv, KV, D),
                                   (B, Sq, H, D)))
    kw = dict(causal=causal, window=window, q_offset=q_offset, kv_len=kv_len)
    out, lse = flash_attention_fwd_lse_ref(q, k, v, **kw)
    return q, k, v, out, lse.reshape(B, Sq, H), dout, kw


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("case", FLASH_BWD_CUDA_CASES, ids=str)
def test_flash_attention_bwd_kernels_match_plain(cuda, case, dtype):
    """dq, dk and dv of the three backward kernels against
    ``flash_attention_bwd_ref`` on the same (q, k, v, out, lse, dO); bf16
    also within 2e-2 in norm."""
    *ins, kw = _flash_bwd_inputs(case, dtype)
    reset_launch_counts()
    got = flash_attention_bwd(*(x.to(cuda) for x in ins), **kw)
    torch.cuda.synchronize()
    assert launch_counts()["flash_attention_bwd"] == 1
    for g, w in zip(got, flash_attention_bwd_ref(*ins, **kw)):
        _close(g, w, dtype)
        if dtype == torch.bfloat16:
            diff = (g.float().cpu() - w.float()).norm()
            assert diff <= 2e-2 * w.float().norm(), (diff, w.float().norm())


@pytest.mark.cuda
@pytest.mark.parametrize("case", [FLASH_BWD_CUDA_CASES[i] for i in (0, 5, 8, 13)], ids=str)
def test_flash_attention_bwd_bf16_repeats_bit_equal(cuda, case):
    """No atomics: a second call gives dq, dk and dv equal in every bit."""
    *ins, kw = _flash_bwd_inputs(case, torch.bfloat16)
    ins = [x.to(cuda) for x in ins]
    first = flash_attention_bwd(*ins, **kw)
    again = flash_attention_bwd(*ins, **kw)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, again))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("case", FLASH_BWD_CUDA_CASES[:4] + FLASH_BWD_CUDA_CASES[10:], ids=str)
def test_flash_attention_kernel_lse_and_autograd(cuda, case, dtype):
    """The forward kernel's ``lse`` against the plain forward's (2e-4), and
    a backward through ``flash_attention`` on the card: one forward and
    one backward launch, gradients as the CPU's."""
    q, k, v, out, lse, dout, kw = _flash_bwd_inputs(case, dtype)
    got_out, got_lse = flash_ops._launch(q.to(cuda), k.to(cuda), v.to(cuda), kw["causal"],
                                         kw["window"], kw["q_offset"], kw["kv_len"],
                                         with_lse=True)
    np.testing.assert_allclose(got_lse.cpu().numpy(), lse.numpy(), rtol=2e-4, atol=2e-4)
    _close(got_out, out, dtype)
    leaves = [x.to(cuda).requires_grad_() for x in (q, k, v)]
    reset_launch_counts()
    flash_attention(*leaves, **kw).backward(dout.to(cuda))
    torch.cuda.synchronize()
    counts = launch_counts()
    assert counts["flash_attention"] == 1 and counts["flash_attention_bwd"] == 1, counts
    cpu = [x.clone().requires_grad_() for x in (q, k, v)]
    flash_attention(*cpu, **kw).backward(dout)
    for g, w in zip(leaves, cpu):
        _close(g.grad, w.grad, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("case", FLASH_BWD_CUDA_CASES[13:15], ids=str)
def test_flash_attention_kernel_rows_that_see_no_key(cuda, case, dtype):
    """Rows that see no key (a window that ends before kv_len): the forward
    kernel's ``out`` and ``lse`` on every row against the plain forward's,
    which gives such a row the mean of V over the padded key slots and an
    ``lse`` of NEG_INF; serving (no lse) writes the same ``out``."""
    q, k, v, out, lse, _, kw = _flash_bwd_inputs(case, dtype)
    dead = first_dead_row(q.shape[1], kw["window"], kw["q_offset"], kw["kv_len"])
    assert dead < q.shape[1]
    got_out, got_lse = flash_ops._launch(q.to(cuda), k.to(cuda), v.to(cuda), kw["causal"],
                                         kw["window"], kw["q_offset"], kw["kv_len"],
                                         with_lse=True)
    served = flash_attention(q.to(cuda), k.to(cuda), v.to(cuda), **kw)
    torch.cuda.synchronize()
    np.testing.assert_allclose(got_lse.cpu().numpy(), lse.numpy(), rtol=2e-4, atol=2e-4)
    assert float(got_lse[:, dead:].max()) == float(np.float32(NEG_INF))
    _close(got_out, out, dtype)
    assert torch.equal(served, got_out)
    assert bool(got_out[:, dead:].abs().sum() > 0)   # the mean of V, not zeros


@pytest.mark.cuda
def test_flash_attention_without_grad_stores_no_lse(cuda, monkeypatch):
    """Serving (no grad) launches the forward with a null ``lse``."""
    seen = []
    real = flash_ops._launch
    monkeypatch.setattr(flash_ops, "_launch",
                        lambda *a, **kw: seen.append(kw["with_lse"]) or real(*a, **kw))
    q = torch.zeros((1, 8, 2, 16), device=cuda, requires_grad=True)
    with torch.no_grad():
        flash_attention(q, q, q)
    flash_attention(q.detach(), q.detach(), q.detach())
    assert seen == [False, False]


# the kernels a training step of each model launches on the card, forward
# and backward
TRAIN_KERNELS = {
    "rwkv6_7b": ("rwkv6_scan", "rwkv6_scan_bwd"),
    "jamba_1p5_large_398b": ("ssm_scan", "ssm_scan_bwd", "flash_attention", "flash_attention_bwd"),
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["phi3_mini_3p8b", "llama4_maverick_400b_a17b", "whisper_small",
                                  "rwkv6_7b", "jamba_1p5_large_398b"])
def test_smoke_training_on_the_card_matches_the_cpu(cuda, name):
    """Two ``make_train_step`` steps of 2 microbatches of a smoke config in
    f32 on the card against the CPU port's, from the same parameters:
    losses and gradient norms to 1e-4, the model's forward and backward
    kernels launched (llama4: Adafactor with bf16 state and the MoE's
    load-balance loss; whisper: the encoder-decoder; rwkv6_7b and jamba:
    the scans' backward kernels)."""
    from repro_torch.data import SyntheticLM, make_batch_iterator
    from repro_torch.runtime import make_train_step, opt_config

    cfg = dataclasses.replace(get_arch(name).smoke, param_dtype=torch.float32,
                              compute_dtype=torch.float32)
    ocfg = opt_config(get_arch(name))
    ds = SyntheticLM(vocab=cfg.vocab, seq_len=32, global_batch=4, seed=0, family=cfg.family,
                     n_img_tokens=cfg.n_img_tokens)
    start, runs = None, {}
    for where in ("cpu", cuda):
        init_fn, step_fn = make_train_step(cfg, ocfg, microbatches=2, device=where)
        state = init_fn(0)
        with torch.no_grad():
            if start is None:
                start = [p.detach().clone() for p in state.params.parameters()]
            else:
                for a, b in zip(state.params.parameters(), start):
                    a.copy_(b)
        reset_launch_counts()
        it = make_batch_iterator(ds, device=where)
        metrics = []
        for _ in range(2):
            state, m = step_fn(state, next(it))
            metrics.append((float(m["loss"]), float(m["grad_norm"])))
        runs[str(where)] = metrics
    counts = launch_counts()
    kernels = TRAIN_KERNELS.get(name, ("flash_attention", "flash_attention_bwd"))
    assert all(counts[k] > 0 for k in kernels), counts
    np.testing.assert_allclose(runs[str(cuda)], runs["cpu"], rtol=1e-4, atol=0)


SSM_CUDA_CASES = [
    # B, S, dim, N, chunk
    (1, 32, 8, 4, 8),
    (2, 64, 16, 8, 16),
    (1, 45, 40, 16, 16),       # ragged S, dim not a multiple of 32
    (2, 200, 128, 16, 64),     # several tiles, ragged last one
    (1, 130, 64, 32, 256),     # chunk > S
    (3, 17, 96, 8, 8),         # jamba smoke's d_state
    # ragged S that the wrapper hands over unpadded
    (2, 1, 40, 4, 256),
    (1, 63, 72, 16, 256),
    (2, 65, 200, 32, 256),
    (1, 300, 104, 16, 256),
    (1, 65, 20, 16, 256),      # 40 bytes of bf16 a row: staged without 16-byte copies
    (2, 63, 13, 4, 256),       # odd dim: plain loads in both dtypes
]
def _ssm_arrays(rng, B, S, dim, N, dtype):
    """x, B, C in ``dtype``; dt through softplus, A = -exp(A_log), D and
    the state in f32, as the Mamba mixer hands them over."""
    f32 = lambda a: torch.from_numpy(np.asarray(a, np.float32))
    return (
        f32(rng.standard_normal((B, S, dim))).to(dtype),
        f32(np.log1p(np.exp(rng.standard_normal((B, S, dim)) - 1.0))),
        -torch.exp(f32(rng.uniform(0.0, np.log(16.0), (dim, N)))),
        f32(rng.standard_normal((B, S, N))).to(dtype),
        f32(rng.standard_normal((B, S, N))).to(dtype),
        f32(rng.standard_normal(dim)),
        f32(rng.standard_normal((B, dim, N)) * 0.1),
    )


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("B,S,dim,N,chunk", SSM_CUDA_CASES)
def test_ssm_scan_kernel_matches_plain(cuda, B, S, dim, N, chunk, dtype):
    cpu = _ssm_arrays(np.random.default_rng(S + dim), B, S, dim, N, dtype)
    reset_launch_counts()
    y, h = ssm_scan(*(x.to(cuda) for x in cpu), chunk=chunk)
    torch.cuda.synchronize()
    assert launch_counts()["ssm_scan"] == 1
    # not padded: y at its own length, as the kernel wrote it
    assert y.shape == (B, S, dim) and y.is_contiguous() and h.shape == (B, dim, N)
    want_y, want_h = ssm_scan(*cpu, chunk=chunk)
    _close(y, want_y, dtype)
    _close(h, want_h, torch.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("state", [True, False], ids=["state", "no-state"])
def test_ssm_scan_ragged_call_is_one_kernel(cuda, state):
    """A ragged call runs the scan kernel and nothing else on the card:
    no pad, fill or copy kernel beside it."""
    from torch.profiler import ProfilerActivity, profile

    dev = [x.to(cuda) for x in _ssm_arrays(np.random.default_rng(1), 1, 1838, 256, 16,
                                           torch.bfloat16)]
    if not state:
        dev[6] = None
    ssm_scan(*dev, chunk=256)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        ssm_scan(*dev, chunk=256)
        torch.cuda.synchronize()
    kernels = [e.key for e in prof.key_averages() if e.device_time_total > 0]
    assert len(kernels) == 1 and "ssm_scan_kernel" in kernels[0], kernels


@pytest.mark.cuda
def test_ssm_scan_kernel_without_state_and_empty_batch(cuda):
    cpu = _ssm_arrays(np.random.default_rng(0), 2, 24, 32, 16, torch.float32)
    dev = [x.to(cuda) for x in cpu]
    y, h = ssm_scan(*dev[:6], None, chunk=8)
    y0, h0 = ssm_scan(*dev[:6], torch.zeros_like(dev[6]), chunk=8)
    assert torch.equal(y, y0) and torch.equal(h, h0)
    empty = [x[:0] if x.dim() == 3 and x.shape[0] == 2 else x for x in dev]
    y, h = ssm_scan(*empty, chunk=8)
    assert y.shape == (0, 24, 32) and h.shape == (0, 32, 16)


# ---------------------------------------------------------------------------
# The scans' backward kernels against their plain VJPs (run on the CPU),
# as chip_smoke.py holds them: bf16 gradients to 2e-2 (1 + |plain|)
# elementwise and 2e-2 |plain| in norm, f32 gradients to 2e-4 |plain| in
# norm; rwkv6's du, a sum of products that cancel, in norm only.
# ---------------------------------------------------------------------------
def _hold_grad(got, want, elementwise=True):
    assert got.dtype == want.dtype and got.shape == want.shape
    a, b = got.cpu().double(), want.double()
    assert bool(a.isfinite().all())
    tol = 2e-2 if want.dtype == torch.bfloat16 else 2e-4
    assert (a - b).norm().item() <= tol * b.norm().item() + 1e-12
    if elementwise and want.dtype == torch.bfloat16:
        assert bool(((a - b).abs() <= tol * (1 + b.abs())).all())


def _rwkv_grad_arrays(rng, B, S, H, N, chunk, dtype, clamp=False):
    """r, k, v in ``dtype``; w = exp(-exp(x)), x uniform in [-6, 0.5]
    (-0.5 at chunk 64: the chunked form computes k exp(-Li), finite only
    while a chunk's decays stay above exp(-88)), or with ``clamp`` w =
    exp(-y), y uniform in [4.9, 5.1] (the log decays on both sides of the
    clamp at -5), a few decays below the clamp; u, a state; the cotangents
    dout (``dtype``) and dstate."""
    f32 = lambda a: torch.from_numpy(np.asarray(a, np.float32))  # noqa: E731
    if clamp:
        w = np.exp(-rng.uniform(4.9, 5.1, (B, S, H, N)))
    else:
        w = np.exp(-np.exp(rng.uniform(-6.0, 0.5 if chunk <= 32 else -0.5, (B, S, H, N))))
    w[:, 1:3, 0, :4] = 1e-4
    ins = (f32(rng.standard_normal((B, S, H, N))).to(dtype),
           f32(rng.standard_normal((B, S, H, N)) * 0.5).to(dtype),
           f32(rng.standard_normal((B, S, H, N))).to(dtype), f32(w),
           f32(rng.standard_normal((H, N)) * 0.3), f32(rng.standard_normal((B, H, N, N)) * 0.1))
    return ins, (f32(rng.standard_normal((B, S, H, N))).to(dtype),
                 f32(rng.standard_normal((B, H, N, N))))


RWKV_BWD_CUDA_CASES = [
    # B, S, H, N, chunk
    (2, 64, 2, 16, 8),
    (1, 96, 3, 32, 16),
    (1, 128, 2, 64, 32),     # rwkv6_7b's head dim and chunk, two value slices
    (1, 128, 2, 64, 64),
    (2, 48, 2, 16, 16),
    (1, 24, 2, 32, 32),      # chunk > S: one chunk of 24
    (2, 1024, 2, 64, 32),    # the reverse scan over 32 chunks
    (1, 256, 2, 64, 16, "clamp"),   # log decays at the clamp: 16 x -5 a chunk
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("case", RWKV_BWD_CUDA_CASES, ids=str)
@pytest.mark.parametrize("dstate", [True, False], ids=["dstate", "no-dstate"])
def test_rwkv6_scan_bwd_kernels_match_plain(cuda, case, dtype, dstate):
    """The backward kernels on the forward kernel's chunk states against
    ``rwkv6_scan_bwd_ref``; dw exactly 0 below the clamp; a second call
    bit-equal to the first."""
    B, S, H, N, chunk, *clamp = case
    ins, (dout, dst) = _rwkv_grad_arrays(np.random.default_rng(S + N + chunk), B, S, H, N,
                                         chunk, dtype, clamp=bool(clamp))
    dst = dst if dstate else None
    dev = [x.to(cuda) for x in ins]
    C = min(chunk, S)
    _, _, states = rwkv6_ops._launch(*dev, C, with_states=True)
    reset_launch_counts()
    got = rwkv6_scan_bwd(*dev, dout.to(cuda), None if dst is None else dst.to(cuda),
                         chunk=chunk, states=states)
    torch.cuda.synchronize()
    assert launch_counts()["rwkv6_scan_bwd"] == 1
    want = rwkv6_scan_bwd(*ins, dout, dst, chunk=chunk)
    for i, (g, w) in enumerate(zip(got, want)):
        _hold_grad(g, w, elementwise=i != 4)
    assert float(got[3][:, 1:3, 0, :4].abs().max()) == 0.0 == float(want[3][:, 1:3, 0, :4].abs().max())
    again = rwkv6_scan_bwd(*dev, dout.to(cuda), None if dst is None else dst.to(cuda),
                           chunk=chunk, states=states)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


# inputs that require grad, by position in (r, k, v, w, u, state0)
GRAD_SUBSETS = {"all": (0, 1, 2, 3, 4, 5), "r-w": (0, 3), "u-state0": (4, 5), "v": (2,)}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("subset", list(GRAD_SUBSETS))
@pytest.mark.parametrize("S,N,chunk", [(45, 32, 16), (77, 64, 32), (30, 16, 8)])
def test_rwkv6_scan_grads_on_the_card_match_the_cpu(cuda, S, N, chunk, subset, dtype):
    """Gradients through ``rwkv6_scan`` on the card (a ragged S: the padding
    and the slice around the Function) against the CPU's, for a subset of
    inputs that require grad: one forward and one backward launch."""
    ins, (dout, dst) = _rwkv_grad_arrays(np.random.default_rng(S * N), 2, S, 2, N, chunk, dtype)
    grads = {}
    for dev in (cuda, torch.device("cpu")):
        leaves = [x.to(dev).requires_grad_(i in GRAD_SUBSETS[subset]) for i, x in enumerate(ins)]
        reset_launch_counts()
        out, state = rwkv6_scan(*leaves, chunk=chunk)
        wanted = [x for x in leaves if x.requires_grad]
        grads[dev.type] = torch.autograd.grad((out, state), wanted, (dout.to(dev), dst.to(dev)))
        counts = launch_counts()
        assert counts["rwkv6_scan"] == counts["rwkv6_scan_bwd"] == (dev.type == "cuda"), counts
    for i, g, w in zip(GRAD_SUBSETS[subset], grads["cuda"], grads["cpu"]):
        _hold_grad(g, w, elementwise=i != 4)


SSM_BWD_CUDA_CASES = [
    # B, S, dim, N
    (1, 40, 64, 4),
    (2, 33, 40, 8),          # dim not a multiple of 32, ragged segments
    (1, 70, 96, 16),
    (2, 17, 64, 32),
    (1, 300, 104, 16),       # many segments
    (2, 1, 32, 16),
    (1, 1000, 72, 16),       # eight time chunks, the last ragged
    (2, 129, 64, 16),        # one token past a chunk
    (1, 300, 64, 16, "zero decay"),   # a = exp(A dt) = 0 at token 150, inside a chunk
    (1, 131, 40, 32),        # N 32: 8-token segments, two chunks
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("case", SSM_BWD_CUDA_CASES, ids=str)
@pytest.mark.parametrize("state", [True, False], ids=["state", "no-state"])
def test_ssm_scan_bwd_kernels_match_plain(cuda, case, dtype, state):
    """The backward kernels against ``ssm_scan_bwd_ref`` with and without
    h0 and dh; a second call bit-equal to the first."""
    B, S, dim, N, *zero = case
    rng = np.random.default_rng(S + dim + N)
    cpu = list(_ssm_arrays(rng, B, S, dim, N, dtype))
    if zero:
        cpu[1][:, S // 2] = 200.0   # A dt <= -200
    dy = torch.from_numpy(rng.standard_normal((B, S, dim)).astype(np.float32)).to(dtype)
    dh = torch.from_numpy(rng.standard_normal((B, dim, N)).astype(np.float32))
    if not state:
        cpu[6], dh = None, None
    dev = [None if x is None else x.to(cuda) for x in cpu]
    reset_launch_counts()
    got = ssm_scan_bwd(*dev, dy.to(cuda), None if dh is None else dh.to(cuda))
    torch.cuda.synchronize()
    assert launch_counts()["ssm_scan_bwd"] == 1
    for g, w in zip(got, ssm_scan_bwd(*cpu, dy, dh)):
        _hold_grad(g, w)
    again = ssm_scan_bwd(*dev, dy.to(cuda), None if dh is None else dh.to(cuda))
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("subset", [(0, 1, 2, 3, 4, 5, 6), (0, 3), (2, 5), (1,)], ids=str)
def test_ssm_scan_grads_on_the_card_match_the_cpu(cuda, subset, dtype):
    """Gradients through ``ssm_scan`` on the card (any S, no padding)
    against the CPU's (padded to the chunk), for a subset of inputs that
    require grad: one forward and one backward launch."""
    cpu = _ssm_arrays(np.random.default_rng(7), 2, 45, 40, 16, dtype)
    rng = np.random.default_rng(8)
    dy = torch.from_numpy(rng.standard_normal((2, 45, 40)).astype(np.float32)).to(dtype)
    dh = torch.from_numpy(rng.standard_normal((2, 40, 16)).astype(np.float32))
    grads = {}
    for dev in (cuda, torch.device("cpu")):
        leaves = [x.to(dev).requires_grad_(i in subset) for i, x in enumerate(cpu)]
        reset_launch_counts()
        y, h = ssm_scan(*leaves, chunk=16)
        wanted = [x for x in leaves if x.requires_grad]
        grads[dev.type] = torch.autograd.grad((y, h), wanted, (dy.to(dev), dh.to(dev)))
        counts = launch_counts()
        assert counts["ssm_scan"] == counts["ssm_scan_bwd"] == (dev.type == "cuda"), counts
    for g, w in zip(grads["cuda"], grads["cpu"]):
        _hold_grad(g, w)


@pytest.mark.cuda
def test_no_plain_scan_runs_under_grad_on_the_card(cuda, monkeypatch):
    """With every plain version of the two scans patched to raise, a
    forward and a backward through each on the card still run: no CUDA
    path differentiates a plain version."""
    def refuse(*args, **kwargs):
        raise AssertionError("a plain version ran on the card")

    for mod, names in ((rwkv6_ops, ("rwkv6_chunked_ref", "rwkv6_scan_bwd_ref")),
                       (ssm_ops, ("ssm_scan_ref", "ssm_scan_bwd_ref"))):
        for name in names:
            monkeypatch.setattr(mod, name, refuse)
    ins, _ = _rwkv_grad_arrays(np.random.default_rng(0), 1, 40, 2, 16, 16, torch.bfloat16)
    leaves = [x.to(cuda).requires_grad_() for x in ins]
    out, state = rwkv6_scan(*leaves, chunk=16)
    (out.float().sum() + state.sum()).backward()
    ssm = [x.to(cuda).requires_grad_() for x in _ssm_arrays(np.random.default_rng(0), 1, 40, 64,
                                                               16, torch.bfloat16)]
    y, h = ssm_scan(*ssm, chunk=16)
    (y.float().sum() + h.sum()).backward()
    assert all(x.grad is not None for x in leaves + ssm)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["rwkv6_7b", "jamba_1p5_large_398b"])
def test_scan_models_loss_grads_on_the_card_match_the_cpu(cuda, name):
    """``loss_fn`` of rwkv6_7b's and jamba's smoke configs in f32 and its
    gradients, on the card against the CPU port, from the same parameters
    and a batch of 37 tokens (ragged against the chunk): the loss to
    1e-5, every gradient leaf to 1e-4 |g| in norm (rwkv6's u to 4e-4, as
    tests/test_torch_train.py holds it to the JAX package)."""
    from repro_torch.runtime import loss_fn, model_init

    cfg = dataclasses.replace(get_arch(name).smoke, param_dtype=torch.float32,
                              compute_dtype=torch.float32)
    base = model_init(cfg, 0, device="cpu")
    rng = np.random.default_rng(3)
    batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab, (2, 37)).astype(np.int32)),
             "loss_mask": torch.from_numpy((rng.random((2, 37)) < 0.8).astype(np.float32))}
    got = {}
    for dev in (cuda, torch.device("cpu")):
        params = copy.deepcopy(base).to(dev)
        named = dict(params.named_parameters())
        reset_launch_counts()
        loss = loss_fn(cfg, params, {k: v.to(dev) for k, v in batch.items()})
        grads = torch.autograd.grad(loss, list(named.values()))
        got[dev.type] = float(loss), {n: g.cpu() for n, g in zip(named, grads)}, launch_counts()
    (loss, grads, counts), (want_loss, want, _) = got["cuda"], got["cpu"]
    assert all(counts[k] > 0 for k in TRAIN_KERNELS[name]), counts
    np.testing.assert_allclose(loss, want_loss, rtol=1e-5)
    for n, g in grads.items():
        tol = 4e-4 if n.endswith("rwkv.u") else 1e-4
        assert (g - want[n]).norm() <= tol * want[n].norm() + 1e-7, n


@pytest.mark.cuda
def test_sharded_fleet_blocks_on_the_card_match_the_cpu_port(cuda):
    """``_fleet_sharded`` on five lanes padded to six, three blocks in
    turn on the card: lane for lane equal to the CPU port's unsharded
    fleet, every simulator kernel launched."""
    from repro_torch.core import sweep

    params = SimParams(duration=0.05, max_pipelines=32, max_containers=32, num_pools=2,
                       scheduling_algo="priority_pool", waiting_ticks_mean=300.0,
                       op_base_seconds_mean=0.005)
    wls = make_workload_batch(params, list(range(5)))
    binned, inv = sweep.bin_lanes_by_density(wls, params)
    reset_launch_counts()
    states, _ = sweep._unbin_states(sweep._fleet_sharded(
        params, sweep.pad_lanes(binned, 6), params.scheduling_algo, [cuda] * 3), inv)
    counts = launch_counts()
    want = fleet_run(params, workloads=wls, device="cpu")
    assert all(counts[name] > 0 for name in SIM_KERNELS), counts
    for name in want._fields:
        assert torch.equal(getattr(states, name).cpu(), getattr(want, name)), name


@pytest.mark.cuda
def test_training_step_over_a_one_rank_mesh_matches_no_mesh(cuda, tmp_path):
    """``run_training`` of phi3's smoke config over a (1, 1) mesh of a
    one-rank ``nccl`` group, 1,024 tokens a row (two chunks of the cross
    entropy, each recomputed in the backward on the autograd engine's
    device thread) in two microbatches: losses bit-equal to ``mesh=None``
    on the card, and the attention kernels launched as often."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.runtime import run_training

    arch = get_arch("phi3_mini_3p8b")
    kw = dict(steps=2, device=cuda, global_batch=4, seq_len=1024, microbatches=2)
    reset_launch_counts()
    want = run_training(arch, **kw)
    plain = launch_counts()
    dist.init_process_group("nccl", store=dist.FileStore(str(tmp_path / "store"), 1), rank=0,
                            world_size=1)
    try:
        reset_launch_counts()
        got = run_training(arch, mesh=make_host_mesh(1, 1), **kw)
        meshed = launch_counts()
    finally:
        dist.destroy_process_group()
    assert got.losses == want.losses
    assert meshed["flash_attention"] == plain["flash_attention"] > 0
    assert meshed["flash_attention_bwd"] == plain["flash_attention_bwd"] > 0


# every decoder-only architecture of the registry (all but the audio family)
SERVED_SMOKE = [name for name in list_archs() if get_arch(name).model.family != "audio"]


@pytest.mark.cuda
@pytest.mark.parametrize("name", SERVED_SMOKE)
def test_serving_goes_through_the_lm_kernels(cuda, name):
    from repro_torch.models import lm
    from repro_torch.serving.batching import ContinuousBatcher, Request

    cfg = dataclasses.replace(get_arch(name).smoke, param_dtype=torch.float32,
                              compute_dtype=torch.float32)
    base = lm.lm_init(cfg, 0, device="cpu")
    outs = {}
    for dev in (cuda, torch.device("cpu")):
        b = ContinuousBatcher(cfg, copy.deepcopy(base).to(dev), slots=2, max_len=48)
        for i, n in enumerate((11, 17, 9)):
            toks = np.random.default_rng(i).integers(2, cfg.vocab, n).astype(np.int32)
            b.submit(Request(rid=i, tokens=toks, max_new=4, interactive=i == 2))
        reset_launch_counts()
        outs[dev.type] = [(r.rid, r.out) for r in b.run_to_completion()]
        counts = launch_counts()
        if dev.type == "cuda":
            kernels = {"rwkv6_7b": ("rwkv6_scan",),
                       "jamba_1p5_large_398b": ("ssm_scan", "flash_attention")}.get(
                           name, ("flash_attention",))
            assert all(counts[k] > 0 for k in kernels), counts
    assert outs["cuda"] == outs["cpu"]


def _greedy_on_both(cuda, base, prefill, decode, batch, max_len, start, steps):
    """``prefill`` then ``steps`` greedy ``decode`` steps from position
    ``start``, on the card and on the CPU from copies of ``base``: for
    each device the prefill logits (on the CPU), the tokens and the
    ``flash_attention`` launches."""
    got = {}
    for dev in (cuda, torch.device("cpu")):
        params = copy.deepcopy(base).to(dev)
        reset_launch_counts()
        logits, caches = prefill(params, {k: v.to(dev) for k, v in batch.items()}, max_len)
        first, out = logits.cpu(), []
        for pos in range(start, start + steps):
            nxt = torch.argmax(logits, dim=-1).to(torch.int32)
            out.append(nxt.tolist())
            logits, caches = decode(params, caches, nxt, pos)
        got[dev.type] = (first, out, launch_counts()["flash_attention"])
    return got


@pytest.mark.cuda
def test_vlm_frontend_prefill_on_the_card(cuda):
    """internvl2_2b smoke in f32 with patch embeddings in its first
    positions: the card's prefill logits within 2e-4 of the CPU port's,
    and three greedy decode steps give the same tokens."""
    from repro_torch.models import VIT_DIM, lm

    cfg = dataclasses.replace(get_arch("internvl2_2b").smoke, param_dtype=torch.float32,
                              compute_dtype=torch.float32)
    base = lm.lm_init(cfg, 0, device="cpu")
    rng = np.random.default_rng(5)
    toks = torch.from_numpy(rng.integers(2, cfg.vocab, (2, 20)).astype(np.int32))
    fe = torch.from_numpy(rng.standard_normal((2, cfg.n_img_tokens, VIT_DIM)).astype(np.float32))
    got = _greedy_on_both(
        cuda, base, lambda params, batch, max_len: lm.lm_prefill(cfg, params, batch, max_len=max_len),
        lambda params, caches, nxt, pos: lm.lm_decode_step(cfg, params, caches, nxt, pos),
        {"tokens": toks, "frontend_embeds": fe}, 32, 20, 3)
    assert got["cuda"][2] > 0 and got["cuda"][1] == got["cpu"][1]
    assert (got["cuda"][0] - got["cpu"][0]).abs().max().item() <= 2e-4


@pytest.mark.cuda
def test_whisper_serve_steps_on_the_card(cuda):
    """whisper_small smoke in f32 through ``runtime.make_serve_steps``:
    encoder, decoder prefill and four greedy decode steps on the card
    give the CPU port's tokens, with ``flash_attention`` launched for
    the encoder and for the cross-attention of every step."""
    from repro_torch.models import VIT_DIM, encdec
    from repro_torch.runtime import make_serve_steps, model_init

    cfg = dataclasses.replace(get_arch("whisper_small").smoke, param_dtype=torch.float32,
                              compute_dtype=torch.float32)
    base = model_init(cfg, 0, device="cpu")
    rng = np.random.default_rng(6)
    frames = torch.from_numpy(rng.standard_normal((2, 150, VIT_DIM)).astype(np.float32))
    toks = torch.from_numpy(rng.integers(2, cfg.vocab, (2, 4)).astype(np.int32))
    prefill, decode = make_serve_steps(cfg)
    got = _greedy_on_both(cuda, base, prefill, decode, {"tokens": toks, "frontend_embeds": frames},
                          encdec.dec_len(cfg, 150), 4, 4)
    # encoder layers + decoder prefill (self and cross) + one cross call a step
    n = cfg.n_enc_layers + 2 * cfg.n_layers + 4 * cfg.n_layers
    assert got["cuda"][2] == n and got["cuda"][1] == got["cpu"][1]
    assert (got["cuda"][0] - got["cpu"][0]).abs().max().item() <= 2e-4


# ---------------------------------------------------------------------------
# On the CPU: the build and the checks in front of every launch
# ---------------------------------------------------------------------------
def test_sources_and_library_name():
    names = {p.name for p in cuda_lib.sources()}
    assert names == {"sim_tick.cu", "state_update.cu", "sched_select.cu",
                     "rwkv6_scan.cu", "flash_attention.cu", "flash_attention_bwd.cu",
                     "ssm_scan.cu", "rwkv6_scan_bwd.cu", "ssm_scan_bwd.cu"}
    path = cuda_lib.library_path()
    assert path.parent == cuda_lib.BUILD_DIR and path == cuda_lib.library_path()
    assert "sm_90a" in " ".join(cuda_lib.NVCC_FLAGS)
    assert set(SIM_KERNELS) == {"fleet_tick", "retire_land", "masked_lex_argmin", "assign_gather"}
    assert set(LM_KERNELS) == {"rwkv6_scan", "flash_attention", "ssm_scan",
                               "flash_attention_bwd", "rwkv6_scan_bwd", "ssm_scan_bwd"}
    assert set(KERNELS) == set(SIM_KERNELS) | set(LM_KERNELS)


@pytest.mark.parametrize(
    "x,error",
    [
        (torch.zeros((2, 3), dtype=torch.int64), TypeError),
        (torch.zeros((3, 2), dtype=torch.int32), ValueError),
        (torch.zeros((3, 2), dtype=torch.int32).t(), ValueError),
        (np.zeros((2, 3), np.int32), TypeError),
    ],
    ids=["dtype", "shape", "contiguity", "not-a-tensor"],
)
def test_require_refuses_what_a_kernel_does_not_take(x, error):
    with pytest.raises(error):
        cuda_lib.require("k", "x", x, torch.int32, (2, 3), torch.device("cpu"))
    cuda_lib.require("k", "x", torch.zeros((2, 3), dtype=torch.int32),
                     torch.int32, (2, 3), torch.device("cpu"))


@pytest.mark.parametrize("mc,mp", [(64, 256), (33, 200), (1000, 1024), (33, 1024)])
def test_assign_outputs_are_views_of_the_four_regions(mc, mp):
    """The 13 outputs of ``assign_gather`` on CUDA are views of the four
    regions the kernel writes, shaped and typed as the plain version's,
    in the order the kernel lays its fields out."""
    lanes, k = 5, 3
    regions, outs = state_update_ops._assign_outputs(lanes, mc, mp, torch.device("cpu"))
    arrays = _assign_arrays(np.random.default_rng(0), lanes, k, mc, mp, False)
    want = assign_gather_ref(*(torch.from_numpy(a) for a in arrays),
                             max_containers=mc, max_pipelines=mp)
    assert [(o.dtype, o.shape) for o in outs] == [(w.dtype, w.shape) for w in want]
    assert [(r.dtype, tuple(r.shape)) for r in regions] == [
        (torch.int32, (7, lanes, mc)), (torch.float32, (2, lanes, mp)),
        (torch.bool, (3, lanes, mc)), (torch.bool, (lanes, mp))]
    # (region, index in it) of each output, in the plain version's order
    where = [(2, 0), *((0, j) for j in range(7)), (2, 1), (2, 2), (3, None), (1, 0), (1, 1)]
    for o, (r, j) in zip(outs, where):
        assert o.is_contiguous()
        view = regions[r] if j is None else regions[r][j]
        assert o.data_ptr() == view.data_ptr() and o.nbytes == view.nbytes


@pytest.mark.parametrize("row", range(11))
def test_assign_gather_checks_name_the_row_it_refuses(row):
    """The one-pass check in front of the launch raises as
    ``cuda_lib.require`` does, naming the row."""
    lanes, k = 4, 6
    cpu = torch.device("cpu")
    rows = [torch.from_numpy(a) for a in _assign_arrays(np.random.default_rng(1), lanes, k, 8, 8,
                                                          False)]
    state_update_ops._check_assign_rows(tuple(rows), lanes, k, cpu)
    name = state_update_ops._ASSIGN_ROWS[row]
    bad = {"dtype": (rows[row].to(torch.int64), TypeError),
           "shape": (rows[row][:, :-1].contiguous(), ValueError),
           "contiguity": (rows[row].repeat(1, 2)[:, ::2], ValueError),
           "not-a-tensor": (rows[row].numpy(), TypeError)}
    for what, (x, error) in bad.items():
        changed = tuple(x if i == row else r for i, r in enumerate(rows))
        with pytest.raises(error, match=name):
            state_update_ops._check_assign_rows(changed, lanes, k, cpu)


def _ssm_launch_args(**change):
    """Valid ``ssm_scan`` kernel operands (CPU tensors), one replaced."""
    args = dict(zip(("x", "dt", "A", "B", "C", "D", "h0"),
                    _ssm_arrays(np.random.default_rng(0), 1, 8, 32, 16, torch.bfloat16)))
    args.update(change)
    return args


@pytest.mark.parametrize(
    "change,error",
    [
        ({"x": torch.zeros((1, 8, 32), dtype=torch.float16)}, TypeError),
        ({"dt": torch.zeros((1, 8, 32), dtype=torch.bfloat16)}, TypeError),
        ({"B": torch.zeros((1, 8, 16), dtype=torch.float32)}, TypeError),
        ({"A": torch.zeros((32, 12))}, ValueError),
        ({"C": torch.zeros((1, 16, 8), dtype=torch.bfloat16).transpose(1, 2)}, ValueError),
        ({"D": torch.zeros(31)}, ValueError),
        ({"h0": torch.zeros((1, 16, 32)).transpose(1, 2)}, ValueError),
    ],
    ids=["x-fp16", "dt-bf16", "B-not-x-dtype", "N-not-built", "C-contiguity", "D-shape",
         "h0-contiguity"],
)
def test_ssm_scan_launch_refuses_what_the_kernel_does_not_take(change, error):
    """The checks in front of the launch, before anything is built."""
    with pytest.raises(error):
        ssm_ops._launch(**_ssm_launch_args(**change))


def test_cpu_tensors_never_launch():
    reset_launch_counts()
    mask = torch.ones((2, 4), dtype=torch.bool)
    keys = (torch.zeros((2, 4), dtype=torch.int32), torch.arange(8, dtype=torch.int32).reshape(2, 4))
    assert masked_lex_argmin(mask, keys).tolist() == [0, 0]
    assert launch_counts() == {name: 0 for name in KERNELS}


@pytest.mark.cuda
def test_each_launch_reports_the_work_its_meta_stand_in_reports(cuda):
    """Every LM kernel, forward and backward (through their autograd
    Functions), counted on the card and on ``meta`` at the same shapes:
    the same records (calls, FLOPs, bytes, exps), the same FLOPs and HBM
    bytes of the whole step, and launches only on the card."""
    from repro_torch.roofline.counting import counting

    def step(dev):
        gen = torch.Generator(device="cpu").manual_seed(0)

        def t(*shape, dtype=torch.bfloat16, grad=True, scale=1.0):
            x = (torch.rand(shape, generator=gen) * scale).to(dtype).to(dev)
            return x.requires_grad_(grad)

        q, k, v = t(2, 64, 4, 64), t(2, 64, 2, 64), t(2, 64, 2, 64)
        y = flash_attention(q, k, v)
        r, kk, vv = t(1, 64, 2, 64), t(1, 64, 2, 64), t(1, 64, 2, 64)
        w = t(1, 64, 2, 64, dtype=torch.float32, scale=0.5) + 0.4
        o, _ = rwkv6_scan(r, kk, vv, w, t(2, 64, dtype=torch.float32), chunk=16)
        x, dt = t(1, 48, 32), t(1, 48, 32, dtype=torch.float32, scale=0.1)
        A = -t(32, 16, dtype=torch.float32)
        ys, _ = ssm_scan(x, dt, A, t(1, 48, 16), t(1, 48, 16), t(32, dtype=torch.float32))
        loss = y.float().sum() + o.float().sum() + ys.float().sum()
        torch.autograd.grad(loss, [q, r, x])

    reset_launch_counts()
    with counting(torch.empty(0, device=cuda)) as on_card:
        step(cuda)
    torch.cuda.synchronize()
    launched = {n: c for n, c in launch_counts().items() if c}
    reset_launch_counts()
    with counting(torch.empty(0, device="meta")) as on_meta:
        step("meta")
    assert launch_counts() == {name: 0 for name in KERNELS}
    assert on_card.kernels == on_meta.kernels
    assert on_card.kernel_calls() == launched == {
        "flash_attention": 1, "flash_attention_bwd": 1, "rwkv6_scan": 1, "rwkv6_scan_bwd": 1,
        "ssm_scan": 1, "ssm_scan_bwd": 1}
    assert (on_card.flops, on_card.bytes) == (on_meta.flops, on_meta.bytes)
