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
from hypothesis import given, settings, strategies as st

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
from repro_torch.core.state import seconds
from repro_torch.kernels.fold import ordered_sum
from repro_torch.kernels.sched_select import (
    masked_lex_argmin,
    masked_lex_argmin_ref,
    select_next_pipe,
    select_victim,
)
from repro_torch.kernels.sim_tick import fleet_tick, fleet_tick_ref
from repro_torch.kernels.state_update import assign_gather, retire_land
from test_torch_models import release_jax_executables  # noqa: F401 (autouse)

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
# retire_land (timeout off; the timeout branch: tests/test_torch_faults.py)
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


NAN, INF_F = float("nan"), float("inf")
F32_BIG = 2.0**31          # BIG as f32, the sentinel of an f32 key
# (mask row, keys as (dtype, values)) and the index JAX's reference picks
SELECT_EDGE_CASES = {
    "nan-last-key": ([1, 1, 1], [("i4", [0, 0, 0]), ("f4", [2, NAN, 1])], 1),
    "nan-first-key": ([1, 1, 0], [("f4", [NAN, 1, 0]), ("i4", [2, 3, 1])], 0),
    "nan-unmasked": ([1, 0, 1], [("f4", [2, NAN, 1]), ("i4", [0, 0, 0])], 2),
    "nan-k1": ([0, 1, 1, 1], [("f4", [NAN, 1, NAN, NAN])], 2),
    "zero-signs-tie": ([1, 1, 1, 1], [("f4", [0.0, -0.0, 0.0, -0.0]), ("i4", [5, 3, 3, 4])], 1),
    "zero-signs-k1": ([1, 1], [("f4", [-0.0, 0.0])], 0),
    "zero-signs-last": ([1, 1, 1], [("i4", [1, 0, 0]), ("f4", [0.0, 0.0, -0.0])], 1),
    "inf": ([1, 1, 1, 1], [("f4", [INF_F, -INF_F, -INF_F, 1.0]), ("i4", [0, 2, 1, 0])], 2),
    "inf-beside-unmasked": ([1, 1, 0], [("f4", [INF_F, INF_F, 0.0]), ("i4", [1, 0, 0])], -1),
    "inf-full-row": ([1, 1, 1], [("f4", [INF_F, INF_F, INF_F]), ("i4", [1, 0, 2])], 1),
    "f32-at-sentinel": ([1, 0], [("f4", [F32_BIG, 0.0]), ("i4", [0, 0])], -1),
    "f32-above-sentinel-full-row": (
        [1, 1, 1], [("f4", [2.0**32, 2.0**32, 3e9]), ("i4", [1, 0, 2])], 2),
    "f32-above-sentinel-later-key": (
        [1, 1, 0, 1], [("i4", [0, 0, 0, 1]), ("f4", [2.0**32, 2.0**33, 0.0, 0.0]),
                       ("i4", [4, 3, 2, 1])], 3),
    "f32-just-below-sentinel": ([1, 1, 0], [("f4", [2.0**31 - 128, 2.0**31 - 128, 0.0])], 0),
    "i32-at-sentinel-later-key-widens": (
        [1, 1, 0, 0], [("i4", [0, 0, 5, 0]), ("i4", [INF, INF, 1, 0]), ("i4", [5, 4, 3, 9])], 2),
    "i32-at-sentinel-last-key": ([1, 1, 0], [("i4", [0, 0, 0]), ("i4", [INF, INF, 7])], 0),
    "i32-at-sentinel-first-key": ([1, 1, 1], [("i4", [INF, INF, INF]), ("i4", [2, 1, 0])], -1),
    "i32-extremes": ([1, 1, 1], [("i4", [-(2**31), -(2**31), INF - 1]), ("i4", [3, 2, 1])], 1),
    "k1-f32": ([1, 1, 1, 0], [("f4", [3.0, 1.0, 1.0, 0.0])], 1),
    "k1-i32": ([0, 1, 1, 1], [("i4", [0, 4, 2, 2])], 2),
    "k1-empty": ([0, 0, 0], [("i4", [0, 1, 2])], -1),
}


def _edge_case(mask, keys):
    m = np.asarray([mask], bool)
    return m, tuple(np.asarray([v], np.dtype(dt)) for dt, v in keys)


@pytest.mark.parametrize("name", list(SELECT_EDGE_CASES))
def test_masked_lex_argmin_plain_matches_jax_ref_on_edge_keys(name):
    """NaN (the first NaN of the last key wins, as ``jnp.argmin``
    picks it), signed zeros, infinities and keys at and above their
    sentinel (an empty first key, a widening later key)."""
    mask, keys, want = SELECT_EDGE_CASES[name]
    m, keys = _edge_case(mask, keys)
    port = masked_lex_argmin(_t(m), tuple(map(_t, keys)))
    ref = j_select_ref(jnp.asarray(m), tuple(map(jnp.asarray, keys)))
    assert int(np.asarray(ref)[0]) == want
    np.testing.assert_array_equal(port.numpy(), np.asarray(ref))


F32_SPECIAL = np.array([0.0, -0.0, 1.0, -1.0, 0.5, np.inf, -np.inf, np.nan, 2.0**31,
                        2.0**32, 2.0**31 - 128, -(2.0**31), 3e9], np.float32)
I32_SPECIAL = np.array([0, 1, -1, 2, INF, INF - 1, -INF, -(2**31), 7], np.int32)


def _order_key(bits):
    """``order_key`` of ``csrc/sched_select.cu`` on f32 bit patterns:
    int32 values in the float order, -0 equal to +0."""
    b = np.where(bits == np.int32(-(2**31)), 0, bits).astype(np.int64)
    return np.where(b < 0, b ^ 0x7FFFFFFF, b)


def _register_pass_model(mask, keys, vec):
    """The algorithm of ``csrc/sched_select.cu`` in numpy: each of a
    warp's 32 threads takes the lexicographic minimum of (order keys,
    index) over its masked entries in ascending index (thread
    ``(i // 4) % 32`` of entry ``i`` on the 16-byte path, ``i % 32`` on
    the scalar one); the warp reduces the tuples one component at a
    time; the tuple's index is the answer unless the mask is empty (-1),
    a masked f32 key is NaN, or a component of the winner reaches its
    key's sentinel, where the kernel runs the sweeps (``ref.py``)."""
    m = mask.numpy()
    F, N = m.shape
    comps = np.zeros((3, F, N), np.int64)
    nan = np.zeros((F, N), bool)
    bigs = [INF] * 3
    for j, k in enumerate(keys):
        k = k.numpy()
        if k.dtype == np.float32:
            comps[j], bigs[j] = _order_key(k.view(np.int32)), 0x4F000000
            nan |= np.isnan(k)
        else:
            comps[j] = k
    entry = np.arange(N)
    thread = (entry // 4) % 32 if vec else entry % 32
    sweeps = masked_lex_argmin_ref(mask, keys).numpy()
    out = np.empty(F, np.int32)
    for f in range(F):
        if not m[f].any():
            out[f] = -1
            continue
        best = []
        for th in range(32):
            t = (INF,) * 4
            for i in entry[(thread == th) & m[f]]:
                a = tuple(int(c) for c in comps[:, f, i])
                if a < t[:3]:
                    t = (*a, int(i))
            best.append(t)
        tie, w = np.ones(32, bool), []
        for c in range(4):
            vals = np.array([b[c] for b in best])
            w.append(np.where(tie, vals, INF).min())
            tie &= vals == w[-1]
        fast = not (nan[f] & m[f]).any() and all(w[j] < bigs[j] for j in range(3))
        out[f] = w[3] if fast else sweeps[f]
    return out


@settings(max_examples=60, deadline=None)
@given(
    seed=st.integers(0, 100_000),
    N=st.sampled_from([1, 2, 3, 5, 7, 11, 31, 33, 64, 200, 256, 257, 520]),
    K=st.integers(1, 3),
    f32_keys=st.integers(0, 7),
    special=st.sampled_from([0.0, 0.2, 0.6]),
)
def test_register_pass_with_guard_matches_sweeps(seed, N, K, f32_keys, special):
    """The kernel's one pass over registers, its guard and its slow path
    equal the sweeps of ``masked_lex_argmin_ref`` (and JAX's) on keys
    drawn from NaN, signed zeros, infinities, values at and above the
    sentinels and small ties, with empty, sparse and full masks."""
    rng = np.random.default_rng(seed)
    F = 4
    mask = rng.random((F, N)) < np.array([0.0, 0.1, 0.5, 1.0])[:, None]
    keys = []
    for j in range(K):
        odd = rng.random((F, N)) < special
        if (f32_keys >> j) & 1:
            small = (rng.integers(0, 3, (F, N)) * 0.5).astype(np.float32)
            keys.append(np.where(odd, rng.choice(F32_SPECIAL, (F, N)), small).astype(np.float32))
        else:
            small = rng.integers(-1, 3, (F, N)).astype(np.int32)
            keys.append(np.where(odd, rng.choice(I32_SPECIAL, (F, N)), small).astype(np.int32))
    tm, tk = _t(mask), tuple(map(_t, keys))
    want = masked_lex_argmin_ref(tm, tk).numpy()
    np.testing.assert_array_equal(
        want, np.asarray(j_select_ref(jnp.asarray(mask), tuple(map(jnp.asarray, keys)))))
    for vec in (True, False):
        np.testing.assert_array_equal(_register_pass_model(tm, tk, vec), want, err_msg=f"vec={vec}")


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


@pytest.mark.parametrize("K", [33, 64])
def test_assign_gather_plain_matches_jax_ref_on_edge_rows(K):
    """Off the engine's contract: K past a warp and past MC, slots and
    pipes of -1, MC and MP (and beyond) on valid and invalid rows, a lane
    without a valid row, two valid rows sharing a slot and two sharing a
    pipe (the first row lands, as the reference's argmax picks it)."""
    F, MC, MP = 6, 33, 200
    rng = np.random.default_rng(K)
    rows = list(_assign_rows(rng, F, K, max(MC, K), max(MP, K)))
    valid, slot, pipe = rows[:3]
    valid[0] = False
    slot[rng.random((F, K)) < 0.15] = -1
    slot[rng.random((F, K)) < 0.15] = MC
    pipe[rng.random((F, K)) < 0.15] = -1
    pipe[rng.random((F, K)) < 0.15] = MP
    valid[1, :4] = True
    slot[1, :4] = [MC - 1, 0, MC - 1, 1]
    pipe[1, :4] = [2, MP - 1, 3, MP - 1]
    rows[4][1, :4] = [0.8, 1.6, 2.4, 3.2]
    kw = dict(max_containers=MC, max_pipelines=MP)
    port = assign_gather(*map(_t, rows), **kw)
    _same(port, j_assign_ref(*map(jnp.asarray, rows), **kw), "assign_gather vs ref")
    hit_c, l_cpus, hit_p, l_pcpus = port[0], port[3], port[10], port[11]
    assert not hit_c[0].any() and not hit_p[0].any()
    assert l_cpus[1, MC - 1] == np.float32(0.8) and l_pcpus[1, MP - 1] == np.float32(1.6)


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


def _parallel_runs_fold(values, sel):
    """The fold schedule of ``csrc/state_update.cu`` (retire_land_kernel)
    in numpy f32: per (sum, run) a left fold of the run's terms that
    enter the sum (sum 0 takes every ``sel >= 0``, sum 1 + q takes
    ``sel == q``; any other term is skipped, not added as 0), then per
    sum its run totals added in order. ``values``, ``sel`` ``[F, MP]``;
    returns ``[F, 4]``."""
    F, MP = values.shape
    runs = -(-MP // 32)
    out = np.zeros((F, 4), np.float32)
    for f in range(F):
        for s in range(4):
            totals = []
            for r in range(runs):
                run = np.float32(0.0)
                for p in range(32 * r, min(MP, 32 * r + 32)):
                    if sel[f, p] < 0 or (s > 0 and sel[f, p] != s - 1):
                        continue
                    run = np.float32(run + values[f, p])
                totals.append(run)
            acc = np.float32(0.0)
            for run in totals:
                acc = np.float32(acc + run)
            out[f, s] = acc
    return out


def _bits(x):
    return np.ascontiguousarray(x, np.float32).view(np.int32)


@pytest.mark.parametrize("MP", [32, 200, 256, 1024])
def test_retire_fold_in_parallel_runs_matches_ordered_sum_and_ref(MP):
    rng = np.random.default_rng(MP)
    F = 3
    # signed terms with zeros and -0.0, and runs of which no term enters
    values = (rng.standard_normal((F, MP)) * 10.0 ** rng.integers(-3, 4, (F, MP))).astype(np.float32)
    values[rng.random((F, MP)) < 0.1] = 0.0
    values[rng.random((F, MP)) < 0.1] = -0.0
    sel = rng.integers(-1, 4, (F, MP))
    sel[:, 32:64] = -1
    sel[1, :] = np.where(sel[1] == 0, 1, sel[1])
    masks = np.stack([sel >= 0] + [sel == q for q in range(3)], axis=1)
    model = _parallel_runs_fold(values, sel)
    np.testing.assert_array_equal(_bits(model), _bits(ordered_sum(_t(values), _t(masks)).numpy()))

    # on retire_land's own terms: the plain version's latency sums
    args = _retire_tables(rng, F, 64, MP)
    port = retire_land(*map(_t, args))
    end_of, done_hit, arrival, prio = port[3], port[1], _t(args[6]), _t(args[7])
    terms = seconds(end_of - arrival).numpy()
    known = (prio >= 0) & (prio < 3)
    sel = np.where(done_hit.numpy(), np.where(known.numpy(), prio.numpy(), 3), -1)
    model = _parallel_runs_fold(terms, sel)
    np.testing.assert_array_equal(_bits(model[:, 0]), _bits(port[5].numpy()))
    np.testing.assert_array_equal(_bits(model[:, 1:]), _bits(port[6].numpy()))
    assert int(done_hit.sum()) > 0


def _ballot_fold(values, retired, pool, num_pools):
    """The freed-sum fold of ``csrc/sim_tick.cu`` in numpy f32: per run
    of 32 containers (one warp) and pool q, the ballot of the run's
    retiring containers of pool q, its set bits walked in ascending
    order, each term added to the run's sum; then per pool the runs'
    sums added in run order."""
    F, MC = values.shape
    runs = -(-MC // 32)
    out = np.zeros((F, num_pools), np.float32)
    for f in range(F):
        for q in range(num_pools):
            acc = np.float32(0.0)
            for r in range(runs):
                bits = 0
                for lane in range(min(32, MC - 32 * r)):
                    c = 32 * r + lane
                    if retired[f, c] and pool[f, c] == q:
                        bits |= 1 << lane
                run = np.float32(0.0)
                while bits:
                    src = (bits & -bits).bit_length() - 1
                    bits &= bits - 1
                    run = np.float32(run + values[f, 32 * r + src])
                acc = np.float32(acc + run)
            out[f, q] = acc
    return out


@pytest.mark.parametrize("NP", [1, 3, 8])
@pytest.mark.parametrize("MC", [1, 31, 32, 33, 64, 200, 1000])
def test_fleet_tick_ballot_fold_matches_ordered_sum_and_ref(MC, NP):
    rng = np.random.default_rng(MC * 10 + NP)
    F, MP = 3, 32
    args = list(_tick_tables(rng, F, MC, MP, NP, exact_sizes=False))
    # wide exponents: the order of the sums shows in their last bits
    args[3] = (rng.random((F, MC)) * 10.0 ** rng.integers(-3, 4, (F, MC))).astype(np.float32)
    args[4] = (rng.random((F, MC)) * 10.0 ** rng.integers(-3, 4, (F, MC))).astype(np.float32)
    # lane 0: every container retires
    args[0][0], args[1][0] = 1, args[9][0]
    status, end, oom, cpus, ram, pool, *_, t = args
    running = status == 1
    retired = running & ((oom <= t[:, None]) | (end <= t[:, None]))
    assert retired[0].all()
    port = fleet_tick_ref(*map(_t, args), num_pools=NP)
    onehot = (pool[:, None, :] == np.arange(NP)[None, :, None]) & retired[:, None, :]
    for values, got in ((cpus, port[3]), (ram, port[4])):
        model = _ballot_fold(values, retired, pool, NP)
        np.testing.assert_array_equal(_bits(model), _bits(ordered_sum(_t(values), _t(onehot)).numpy()))
        np.testing.assert_array_equal(_bits(model), _bits(got.numpy()))
