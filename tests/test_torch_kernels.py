"""The port's kernel subsystems against the JAX package's.

Each plain PyTorch version (what a wrapper runs on CPU tensors) is held
to the JAX ``ref.py`` on the same numpy-seeded inputs, and to the Pallas
kernel in interpret mode where the JAX package's own tests run it so.
Tolerances: every int and bool output exact; the f32 latency sums
rtol 1e-5, the reference's own allowance between its kernel and ref.
The f32 freed-resource sums are exact on allocation sizes where every
summation order gives the same sum (what the engine grants are); on
arbitrary floats they are held to rtol 1e-6, as the reference holds its
own kernel, because XLA's reduction order depends on the fusion around
it while the port folds in one fixed order (``kernels/fold.py``).
The CUDA kernels themselves are compared with the plain versions by
``tests/test_torch_cuda.py``, which needs a card.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import scheduler as jsched
from repro.kernels.sched_select import masked_lex_argmin as j_select
from repro.kernels.sched_select.kernel import masked_lex_argmin_kernel
from repro.kernels.sched_select.ref import masked_lex_argmin_ref as j_select_ref
from repro.kernels.sim_tick.kernel import fleet_tick_kernel
from repro.kernels.sim_tick.ref import fleet_tick_ref as j_tick_ref
from repro.kernels.state_update.kernel import assign_gather_kernel, retire_land_kernel
from repro.kernels.state_update.ref import (
    assign_gather_ref as j_assign_ref,
    retire_land_ref as j_retire_ref,
)
from repro_torch.kernels.fold import ordered_sum
from repro_torch.kernels.sched_select import (
    masked_lex_argmin,
    select_next_pipe,
    select_victim,
)
from repro_torch.kernels.sim_tick import fleet_tick
from repro_torch.kernels.state_update import assign_gather, retire_land

INF = 2**31 - 1
LAT_OUTPUTS = {5, 6}  # retire_land: lat_sum, lat_prio


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _same(port, ref, ctx, rtol_at=()):
    assert len(port) == len(ref), ctx
    for i, (a, b) in enumerate(zip(port, ref)):
        a, b = _np(a), _np(b)
        assert a.shape == b.shape and a.dtype == b.dtype, (ctx, i, a.dtype, b.dtype)
        if i in rtol_at:
            np.testing.assert_allclose(a, b, rtol=1e-5, err_msg=f"{ctx} output {i}")
        else:
            np.testing.assert_array_equal(a, b, err_msg=f"{ctx} output {i}")


# ---------------------------------------------------------------------------
# fleet_tick
# ---------------------------------------------------------------------------
def _tick_tables(rng, F, MC, MP, NP, exact_sizes=True):
    t = rng.integers(0, 100, F).astype(np.int32)
    status = rng.integers(0, 2, (F, MC)).astype(np.int32)
    end = rng.integers(0, 100, (F, MC)).astype(np.int32)
    oom = np.where(rng.random((F, MC)) < 0.3, rng.integers(0, 100, (F, MC)), INF).astype(np.int32)
    if exact_sizes:  # quarter-cpu / half-GB grants: sums exact in any order
        cpus = (rng.integers(1, 33, (F, MC)) * 0.25).astype(np.float32)
        ram = (rng.integers(1, 33, (F, MC)) * 0.5).astype(np.float32)
    else:
        cpus = (rng.random((F, MC)) * 4).astype(np.float32)
        ram = (rng.random((F, MC)) * 8).astype(np.float32)
    pool = rng.integers(0, NP, (F, MC)).astype(np.int32)
    pstat = np.asarray([0, 2, 4], np.int32)[rng.integers(0, 3, (F, MP))]
    arrival = rng.integers(0, 150, (F, MP)).astype(np.int32)
    release = rng.integers(0, 150, (F, MP)).astype(np.int32)
    return (status, end, oom, cpus, ram, pool, pstat, arrival, release, t)


@pytest.mark.parametrize(
    "seed,F,MC,MP,NP",
    [(0, 1, 32, 32, 1), (1, 5, 64, 32, 3), (2, 4, 64, 128, 2), (3, 3, 32, 256, 3)],
)
def test_fleet_tick_plain_matches_jax_ref(seed, F, MC, MP, NP):
    args = _tick_tables(np.random.default_rng(seed), F, MC, MP, NP)
    port = fleet_tick(*map(_t, args), num_pools=NP)
    ref = j_tick_ref(*map(jnp.asarray, args), num_pools=NP)
    _same(port, ref, "fleet_tick vs ref")
    assert float(port[3].sum()) > 0


@pytest.mark.parametrize("MC", [32, 64])
def test_fleet_tick_plain_arbitrary_sizes(MC):
    args = _tick_tables(np.random.default_rng(MC), 4, MC, 32, 3, exact_sizes=False)
    port = fleet_tick(*map(_t, args), num_pools=3)
    ref = j_tick_ref(*map(jnp.asarray, args), num_pools=3)
    for i, (a, b) in enumerate(zip(port, ref)):
        if i in (3, 4):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)
        else:
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_fleet_tick_plain_matches_pallas_interpret():
    args = _tick_tables(np.random.default_rng(7), 6, 32, 32, 2)
    port = fleet_tick(*map(_t, args), num_pools=2)
    kern = fleet_tick_kernel(*map(jnp.asarray, args), num_pools=2, block_fleet=4,
                             interpret=True)
    _same(port, kern, "fleet_tick vs pallas")


# ---------------------------------------------------------------------------
# retire_land (timeout off)
# ---------------------------------------------------------------------------
def _retire_tables(rng, F, MC, MP):
    t = rng.integers(10_000, 50_000, F).astype(np.int32)
    # a few pipelines own many containers: several retire together
    ctr_pipe = rng.integers(-1, max(MP // 4, 2), (F, MC)).astype(np.int32)
    ctr_end = (t[:, None] - rng.integers(0, 4, (F, MC))).astype(np.int32)
    ctr_start = (ctr_end - rng.integers(1, 5_000, (F, MC))).astype(np.int32)
    u = rng.random((F, MC))
    oomed = u < 0.25
    done = (u >= 0.25) & (u < 0.7)
    timed = np.zeros((F, MC), bool)
    arrival = (t[:, None] - rng.integers(5_000, 9_000, (F, MP))).astype(np.int32)
    prio = rng.integers(0, 3, (F, MP)).astype(np.int32)
    return (ctr_pipe, ctr_end, ctr_start, oomed, done, timed, arrival, prio, t)


@pytest.mark.parametrize("seed,F,MC,MP", [(0, 1, 32, 32), (1, 6, 64, 64), (2, 3, 32, 128)])
def test_retire_land_plain_matches_jax_ref(seed, F, MC, MP):
    args = _retire_tables(np.random.default_rng(seed), F, MC, MP)
    port = retire_land(*map(_t, args))
    ref = j_retire_ref(*map(jnp.asarray, args), timeout_on=False)
    _same(port, ref, "retire_land vs ref", rtol_at=LAT_OUTPUTS)
    assert int(port[8].sum()) > 0 and int(port[9].sum()) > 0


def test_retire_land_plain_matches_pallas_interpret():
    args = _retire_tables(np.random.default_rng(11), 6, 16, 32)
    port = retire_land(*map(_t, args))
    kern = retire_land_kernel(*map(jnp.asarray, args), timeout_on=False,
                              block_fleet=4, interpret=True)
    _same(port, kern, "retire_land vs pallas", rtol_at=LAT_OUTPUTS)


def test_retire_land_timeout_waits_for_its_slice():
    args = _retire_tables(np.random.default_rng(0), 1, 8, 8)
    with pytest.raises(NotImplementedError, match="chaos"):
        retire_land(*map(_t, args), timeout_on=True)


# ---------------------------------------------------------------------------
# masked_lex_argmin
# ---------------------------------------------------------------------------
def _select_inputs(rng, F, N, mixed):
    mask = rng.random((F, N)) < 0.35
    mask[0] = False                                     # an empty lane
    if F > 2:
        mask[1] = False
        mask[1, N // 2] = True                          # a single candidate
    prio = rng.integers(0, 3, (F, N)).astype(np.int32)
    ticks = (rng.integers(0, 6, (F, N)) * 100).astype(np.int32)  # many ties
    if mixed:
        lead = (rng.integers(0, 3, (F, N)) * 0.5).astype(np.float32)
        lead[: F // 2] = 0.0                            # the main path's +0.0
        keys = (lead, -prio, ticks)
    else:
        keys = (prio, -ticks)
    return mask, keys


@pytest.mark.parametrize(
    "seed,F,N,mixed", [(0, 7, 32, False), (1, 7, 64, True), (2, 4, 256, True), (3, 5, 37, False)]
)
def test_masked_lex_argmin_plain_matches_jax_ref(seed, F, N, mixed):
    mask, keys = _select_inputs(np.random.default_rng(seed), F, N, mixed)
    port = masked_lex_argmin(_t(mask), tuple(map(_t, keys)))
    ref = j_select_ref(jnp.asarray(mask), tuple(map(jnp.asarray, keys)))
    np.testing.assert_array_equal(port.numpy(), np.asarray(ref))
    assert port.dtype == torch.int32 and int(port[0]) == -1


def test_masked_lex_argmin_plain_matches_pallas_interpret():
    mask, keys = _select_inputs(np.random.default_rng(5), 6, 32, mixed=False)
    port = masked_lex_argmin(_t(mask), tuple(map(_t, keys)))
    kern = masked_lex_argmin_kernel(jnp.asarray(mask), jnp.stack(keys, axis=1),
                                    block_fleet=4, interpret=True)
    np.testing.assert_array_equal(port.numpy(), np.asarray(kern))


def test_mixed_keys_are_never_stacked():
    """Entry ticks above 2**24 that differ in int32 collide once stacked
    with an f32 key (the JAX wrapper's ``jnp.stack``): the port keeps
    each key's dtype and picks the reference's index."""
    entered = np.array([[2**24 + 1, 2**24]], np.int32)
    assert np.float32(entered[0, 0]) == np.float32(entered[0, 1])
    mask = np.ones((1, 2), bool)
    keys = (np.zeros((1, 2), np.float32), np.zeros((1, 2), np.int32), entered)
    port = masked_lex_argmin(_t(mask), tuple(map(_t, keys)))
    ref = j_select_ref(jnp.asarray(mask), tuple(map(jnp.asarray, keys)))
    stacked = j_select(jnp.asarray(mask), tuple(map(jnp.asarray, keys)),
                       impl="kernel", interpret=True)
    assert int(port[0]) == int(ref[0]) == 1
    assert int(stacked[0]) == 0  # the JAX-side fault this test pins


def test_select_helpers_match_scheduler_oracles():
    rng = np.random.default_rng(3)
    F, MP, MC = 6, 32, 32
    mask = rng.random((F, MP)) < 0.4
    prio = rng.integers(0, 3, (F, MP)).astype(np.int32)
    entered = rng.integers(0, 50, (F, MP)).astype(np.int32)
    live = rng.random((F, MC)) < 0.6
    ctr_prio = rng.integers(0, 3, (F, MC)).astype(np.int32)
    ctr_start = rng.integers(0, 50, (F, MC)).astype(np.int32)
    below = rng.integers(0, 4, F).astype(np.int32)
    head = select_next_pipe(_t(mask), _t(prio), _t(entered))
    victim = select_victim(_t(live), _t(ctr_prio), _t(ctr_start), _t(below)[:, None])
    for f in range(F):
        assert int(head[f]) == int(jsched.select_next_pipe(
            jnp.asarray(mask[f]), jnp.asarray(prio[f]), jnp.asarray(entered[f])))
        assert int(victim[f]) == int(jsched.select_victim(
            jnp.asarray(live[f]), jnp.asarray(ctr_prio[f]),
            jnp.asarray(ctr_start[f]), jnp.asarray(below[f])))


# ---------------------------------------------------------------------------
# assign_gather
# ---------------------------------------------------------------------------
def _assign_rows(rng, F, K, MC, MP):
    valid = rng.random((F, K)) < 0.6
    slot = np.stack([rng.permutation(MC)[:K] for _ in range(F)]).astype(np.int32)
    pipe = np.stack([rng.permutation(MP)[:K] for _ in range(F)]).astype(np.int32)
    return (
        valid, slot, pipe,
        rng.integers(0, 3, (F, K)).astype(np.int32),
        (rng.integers(1, 9, (F, K)) * 0.8).astype(np.float32),
        (rng.integers(1, 9, (F, K)) * 1.6).astype(np.float32),
        rng.integers(100, 9_000, (F, K)).astype(np.int32),
        np.where(rng.random((F, K)) < 0.3, rng.integers(50, 100, (F, K)), INF).astype(np.int32),
        rng.integers(0, 3, (F, K)).astype(np.int32),
        rng.random((F, K)) < 0.5,
        np.zeros((F, K), bool),
    )


@pytest.mark.parametrize("seed,F,K,MC,MP", [(0, 1, 16, 32, 32), (1, 5, 16, 64, 256), (2, 6, 8, 16, 32)])
def test_assign_gather_plain_matches_jax_ref(seed, F, K, MC, MP):
    rows = _assign_rows(np.random.default_rng(seed), F, K, MC, MP)
    kw = dict(max_containers=MC, max_pipelines=MP)
    port = assign_gather(*map(_t, rows), **kw)
    _same(port, j_assign_ref(*map(jnp.asarray, rows), **kw), "assign_gather vs ref")
    if (F, K, MC, MP) == (6, 8, 16, 32):
        kern = assign_gather_kernel(*map(jnp.asarray, rows), block_fleet=4,
                                    interpret=True, **kw)
        _same(port, kern, "assign_gather vs pallas")


# ---------------------------------------------------------------------------
# The fold order shared by the kernels and the plain versions
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("N", [8, 32, 64, 256])
def test_ordered_sum_matches_xla_reduction(N):
    rng = np.random.default_rng(N)
    x = rng.random((40, N)).astype(np.float32)
    mask = rng.random((40, 2, N)) < 0.7
    port = ordered_sum(_t(x), _t(mask)).numpy()
    xla = np.asarray(jnp.sum(jnp.where(jnp.asarray(mask), jnp.asarray(x)[:, None, :], 0.0), axis=2))
    np.testing.assert_array_equal(port, xla)
