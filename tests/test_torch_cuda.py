"""The CUDA kernels of ``repro_torch`` against their plain versions.

The ``cuda``-marked tests need a card with sm_90 and skip without one;
on the GPU machine they run with

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

This file imports no JAX, so it runs where only PyTorch is installed.
The unmarked tests check, on the CPU, the build and argument checks
that stand between a wrapper and its kernel.
"""
import numpy as np
import pytest
import torch

from repro_torch import SimParams, fleet_run
from repro_torch.kernels import KERNELS, cuda_lib, launch_counts, reset_launch_counts
from repro_torch.kernels.sched_select import masked_lex_argmin, masked_lex_argmin_ref
from repro_torch.kernels.sim_tick import fleet_tick, fleet_tick_ref
from repro_torch.kernels.state_update import (
    assign_gather,
    assign_gather_ref,
    retire_land,
    retire_land_ref,
)

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
def test_retire_land_kernel_matches_plain(cuda):
    rng = np.random.default_rng(0)
    t = rng.integers(10_000, 50_000, F).astype(np.int32)
    end = (t[:, None] - rng.integers(0, 4, (F, MC))).astype(np.int32)
    u = rng.random((F, MC))
    arrays = (
        rng.integers(-1, MP // 4, (F, MC)).astype(np.int32), end,
        (end - rng.integers(1, 5_000, (F, MC))).astype(np.int32),
        u < 0.25, (u >= 0.25) & (u < 0.7), None,
        (t[:, None] - rng.integers(5_000, 9_000, (F, MP))).astype(np.int32),
        rng.integers(0, 3, (F, MP)).astype(np.int32), t,
    )
    cpu, dev = _pair(arrays, cuda)
    _equal(retire_land(*dev), retire_land_ref(*cpu))


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


@pytest.mark.cuda
def test_assign_gather_kernel_matches_plain(cuda):
    rng = np.random.default_rng(0)
    arrays = (
        rng.random((F, K)) < 0.6,
        np.stack([rng.permutation(MC)[:K] for _ in range(F)]).astype(np.int32),
        np.stack([rng.permutation(MP)[:K] for _ in range(F)]).astype(np.int32),
        rng.integers(0, 3, (F, K)).astype(np.int32),
        (rng.integers(1, 9, (F, K)) * 0.8).astype(np.float32),
        (rng.integers(1, 9, (F, K)) * 1.6).astype(np.float32),
        rng.integers(100, 9_000, (F, K)).astype(np.int32),
        np.full((F, K), INF, np.int32),
        rng.integers(0, 3, (F, K)).astype(np.int32),
        rng.random((F, K)) < 0.5,
        np.zeros((F, K), bool),
    )
    cpu, dev = _pair(arrays, cuda)
    kw = dict(max_containers=MC, max_pipelines=MP)
    _equal(assign_gather(*dev, **kw), assign_gather_ref(*cpu, **kw))


@pytest.mark.cuda
def test_main_path_goes_through_every_kernel(cuda):
    params = SimParams(duration=0.05, max_pipelines=32, max_containers=32,
                       waiting_ticks_mean=300.0, op_base_seconds_mean=0.005)
    reset_launch_counts()
    on_card = fleet_run(params, seeds=[0, 1, 2], device=cuda)
    counts = launch_counts()
    on_cpu = fleet_run(params, seeds=[0, 1, 2], device="cpu")
    assert all(n > 0 for n in counts.values()), counts
    for name in ("pipe_status", "pipe_completion", "pool_cpu_free", "done_count"):
        assert torch.equal(getattr(on_card, name).cpu(), getattr(on_cpu, name)), name


# ---------------------------------------------------------------------------
# On the CPU: the build and the checks in front of every launch
# ---------------------------------------------------------------------------
def test_sources_and_library_name():
    names = {p.name for p in cuda_lib.sources()}
    assert names == {"sim_tick.cu", "state_update.cu", "sched_select.cu"}
    path = cuda_lib.library_path()
    assert path.parent == cuda_lib.BUILD_DIR and path == cuda_lib.library_path()
    assert "sm_90a" in " ".join(cuda_lib.NVCC_FLAGS)
    assert set(KERNELS) == {"fleet_tick", "retire_land", "masked_lex_argmin", "assign_gather"}


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


def test_cpu_tensors_never_launch():
    reset_launch_counts()
    mask = torch.ones((2, 4), dtype=torch.bool)
    keys = (torch.zeros((2, 4), dtype=torch.int32), torch.arange(8, dtype=torch.int32).reshape(2, 4))
    assert masked_lex_argmin(mask, keys).tolist() == [0, 0]
    assert launch_counts() == {name: 0 for name in KERNELS}
