"""The scans' gradients in the port against the JAX package, on the CPU.

The JAX package differentiates its chunked jnp forms by autodiff:
``rwkv6_scan(..., impl="ref")`` (``_rwkv6_chunked``) and
``ssm_scan(..., impl="ref")`` (``_ssm_chunked``). Here ``jax.vjp`` of
those, on the same numpy-seeded inputs and cotangents, holds

* the port's differentiable wrappers (``rwkv6_scan`` / ``ssm_scan`` with
  inputs that require grad: the padding and the slice under autograd, the
  ``autograd.Function`` running the plain forward and ``*_bwd_ref``, as
  the card runs the kernels), and
* ``rwkv6_scan_bwd_ref`` / ``ssm_scan_bwd_ref`` called directly (the
  plain statement of the backward kernels' math), which are also held to
  ``torch.autograd.grad`` through the plain forward.

Tolerances: f32 gradients to ``|diff| <= 1e-4 |g| + 1e-7`` (Frobenius
norms), rwkv6's bonus u to ``U_TOL`` (a sum of products that cancel, as
``tests/test_torch_train.py`` holds it), bf16 to 5e-2 in norm. The cases
cover a ragged S, a nonzero input state, a zero and a nonzero cotangent
of the final state, rwkv6 at chunk 16 and 32 with decays where the
chunked form is finite and decays below the clamp (dw exactly 0 in both
packages), and a subset of inputs that require grad. The last test pins
the chunk-32 overflow that both packages share (ROADMAP queue 3).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.kernels.rwkv6_scan.ops import rwkv6_scan as j_rwkv6_scan
from repro.kernels.ssm_scan.ops import ssm_scan as j_ssm_scan
from repro_torch.kernels.rwkv6_scan import rwkv6_chunked_ref, rwkv6_scan, rwkv6_scan_bwd_ref
from repro_torch.kernels.ssm_scan import ssm_scan, ssm_scan_bwd_ref, ssm_scan_ref

from test_torch_models import release_jax_executables  # noqa: F401 (autouse)

U_TOL = 4e-4
DT = {"f32": (torch.float32, jnp.float32), "bf16": (torch.bfloat16, jnp.bfloat16)}
RWKV_NAMES = ("r", "k", "v", "w", "u", "state0")
SSM_NAMES = ("x", "dt", "A", "B", "C", "D", "h0")


def _hold(got, want, dtype, name):
    """|got - want| <= tol |want| + 1e-7 in Frobenius norm."""
    got = np.asarray(got.detach().float() if isinstance(got, torch.Tensor) else got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, name
    tol = 5e-2 if dtype == "bf16" else (U_TOL if name == "u" else 1e-4)
    diff = np.linalg.norm(got - want)
    assert diff <= tol * np.linalg.norm(want) + 1e-7, (name, diff, np.linalg.norm(want))


# ---------------------------------------------------------------------------
# rwkv6_scan
# ---------------------------------------------------------------------------
def _rwkv_case(seed, B, S, H, N):
    """r, k, v, w = exp(-exp(x)) with x uniform in [-6, 0.5] (finite in the
    chunked form up to chunk 32), a few decays below the clamp (1e-4 <
    exp(-5)), u, a state; the cotangents dout and dstate."""
    rng = np.random.default_rng(seed)
    w = np.exp(-np.exp(rng.uniform(-6.0, 0.5, (B, S, H, N))))
    w[:, 1:3, 0, :3] = 1e-4
    ins = [rng.standard_normal((B, S, H, N)), rng.standard_normal((B, S, H, N)) * 0.5,
           rng.standard_normal((B, S, H, N)), w, rng.standard_normal((H, N)) * 0.3,
           rng.standard_normal((B, H, N, N)) * 0.1]
    cot = [rng.standard_normal((B, S, H, N)), rng.standard_normal((B, H, N, N))]
    return [np.asarray(a, np.float32) for a in ins], [np.asarray(a, np.float32) for a in cot]


def _jax_rwkv_vjp(ins, cot, dtype, chunk):
    jdt = DT[dtype][1]
    args = [jnp.asarray(a).astype(jdt) if i < 3 else jnp.asarray(a) for i, a in enumerate(ins)]
    _, vjp = jax.vjp(lambda *a: j_rwkv6_scan(*a, chunk=chunk, impl="ref"), *args)
    return vjp((jnp.asarray(cot[0]).astype(jdt), jnp.asarray(cot[1])))


def _torch_ins(ins, dtype):
    tdt = DT[dtype][0]
    return [torch.from_numpy(a).to(tdt) if i < 3 else torch.from_numpy(a)
            for i, a in enumerate(ins)]


RWKV_CASES = [
    # B, S, H, N, chunk, dtype, dstate
    (2, 21, 3, 8, 8, "f32", True),        # ragged S
    (1, 48, 2, 16, 16, "f32", True),
    (2, 40, 2, 16, 16, "f32", False),     # ragged, no cotangent of the final state
    (1, 64, 2, 16, 32, "f32", True),      # chunk 32, rwkv6_7b's
    (1, 37, 2, 8, 32, "f32", False),      # chunk 32, ragged
    (2, 32, 2, 16, 16, "bf16", True),
    (1, 45, 2, 16, 32, "bf16", True),
]


@pytest.mark.parametrize("case", RWKV_CASES, ids=str)
def test_rwkv6_grads_match_jax_vjp(case):
    B, S, H, N, chunk, dtype, dstate = case
    ins, cot = _rwkv_case(S * N + chunk, B, S, H, N)
    if not dstate:
        cot[1] = np.zeros_like(cot[1])
    want = _jax_rwkv_vjp(ins, cot, dtype, chunk)
    # the wrapper under autograd: the padding, the slice and the Function
    leaves = [x.requires_grad_() for x in _torch_ins(ins, dtype)]
    out, state = rwkv6_scan(*leaves, chunk=chunk)
    tdt = DT[dtype][0]
    dout = torch.from_numpy(cot[0]).to(tdt)
    # no cotangent of the final state: the state is left out of the graph
    outs, cots = ((out, state), (dout, torch.from_numpy(cot[1]))) if dstate else ((out,), (dout,))
    got = torch.autograd.grad(outs, leaves, cots)
    # the plain backward on the padded inputs (w = 1, k = 0 past S)
    C = min(chunk, S)
    pad = (C - S % C) % C
    t = _torch_ins(ins, dtype)
    p = lambda x, val=0.0: F.pad(x, (0, 0, 0, 0, 0, pad), value=val)  # noqa: E731
    ref = rwkv6_scan_bwd_ref(p(t[0]), p(t[1]), p(t[2]), p(t[3], 1.0), t[4], t[5], p(dout),
                             torch.from_numpy(cot[1]) if dstate else None, chunk=chunk)
    ref = [g[:, :S] if i < 4 else g for i, g in enumerate(ref)]
    for name, a, b, w in zip(RWKV_NAMES, got, ref, want):
        assert a.dtype == b.dtype == leaves[RWKV_NAMES.index(name)].dtype, name
        _hold(a, w, dtype, name)
        _hold(b, w, dtype, name)
    # decays below the clamp: no gradient in either package
    assert float(got[3][:, 1:3, 0, :3].abs().max()) == 0.0
    assert float(np.abs(np.asarray(want[3])[:, 1:3, 0, :3]).max()) == 0.0


@pytest.mark.parametrize("chunk", [8, 16])
def test_rwkv6_bwd_ref_matches_autograd(chunk):
    """``rwkv6_scan_bwd_ref`` against ``torch.autograd.grad`` through the
    plain forward, f32, S a multiple of the chunk."""
    ins, cot = _rwkv_case(chunk, 2, 32, 2, 8)
    leaves = [torch.from_numpy(a).requires_grad_() for a in ins]
    out, state = rwkv6_chunked_ref(*leaves, chunk=chunk)
    dout, dstate = (torch.from_numpy(a) for a in cot)
    want = torch.autograd.grad((out, state), leaves, (dout, dstate))
    got = rwkv6_scan_bwd_ref(*(x.detach() for x in leaves), dout, dstate, chunk=chunk)
    for name, a, b in zip(RWKV_NAMES, got, want):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert (a - b).norm() <= 1e-5 * b.norm() + 1e-7, name


def test_rwkv6_grads_of_a_subset_match_jax_vjp():
    """Only r, w and the state require grad: the others get none, and the
    three match JAX's."""
    ins, cot = _rwkv_case(3, 1, 24, 2, 8)
    want = _jax_rwkv_vjp(ins, cot, "f32", 8)
    t = _torch_ins(ins, "f32")
    for i in (0, 3, 5):
        t[i].requires_grad_()
    out, state = rwkv6_scan(*t, chunk=8)
    (out * torch.from_numpy(cot[0])).sum().add((state * torch.from_numpy(cot[1])).sum()).backward()
    assert t[1].grad is None and t[2].grad is None and t[4].grad is None
    for i in (0, 3, 5):
        _hold(t[i].grad, want[i], "f32", RWKV_NAMES[i])


def test_rwkv6_chunk_32_overflows_in_both_packages():
    """The chunked form computes k exp(-Li); with a constant decay of
    exp(-4) a chunk of 32 reaches Li = -128 and exp(128) overflows f32,
    while a chunk of 16 stays finite. Both packages give the same pattern
    (ROADMAP queue 3: rwkv6_7b's config sets chunk 32)."""
    rng = np.random.default_rng(0)
    B, S, H, N = 1, 64, 2, 16
    r, k, v = (rng.standard_normal((B, S, H, N)).astype(np.float32) for _ in range(3))
    w = np.full((B, S, H, N), np.exp(-4.0), np.float32)
    u = rng.standard_normal((H, N)).astype(np.float32)
    s0 = np.zeros((B, H, N, N), np.float32)
    for chunk, finite in ((16, True), (32, False)):
        jo, js = j_rwkv6_scan(r, k, v, w, u, s0, chunk=chunk, impl="ref")
        to, ts = rwkv6_scan(*(torch.from_numpy(a) for a in (r, k, v, w, u, s0)), chunk=chunk)
        for x in (jo, js):
            assert bool(np.isfinite(np.asarray(x)).all()) == finite, chunk
        for x in (to, ts):
            assert bool(torch.isfinite(x).all()) == finite, chunk


# ---------------------------------------------------------------------------
# ssm_scan
# ---------------------------------------------------------------------------
def _ssm_case(seed, B, S, dim, N):
    """x, B, C; dt through softplus, A = -exp(A_log), D, a state, as the
    Mamba mixer hands them over; the cotangents dy and dh."""
    rng = np.random.default_rng(seed)
    ins = [rng.standard_normal((B, S, dim)), np.log1p(np.exp(rng.standard_normal((B, S, dim)) - 1.0)),
           -np.exp(rng.uniform(0.0, np.log(16.0), (dim, N))), rng.standard_normal((B, S, N)),
           rng.standard_normal((B, S, N)), rng.standard_normal(dim),
           rng.standard_normal((B, dim, N)) * 0.1]
    cot = [rng.standard_normal((B, S, dim)), rng.standard_normal((B, dim, N))]
    return [np.asarray(a, np.float32) for a in ins], [np.asarray(a, np.float32) for a in cot]


def _model_dtype(i):   # x, B and C in the model's dtype; dt, A, D and h0 f32
    return i in (0, 3, 4)


SSM_CASES = [
    # B, S, dim, N, chunk, dtype, dh
    (2, 13, 6, 4, 4, "f32", True),       # ragged S
    (1, 24, 16, 8, 8, "f32", True),
    (2, 19, 8, 16, 8, "f32", False),     # ragged, no cotangent of the final state
    (1, 16, 8, 8, 16, "bf16", True),
]


@pytest.mark.parametrize("case", SSM_CASES, ids=str)
def test_ssm_grads_match_jax_vjp(case):
    Bsz, S, dim, N, chunk, dtype, dh = case
    ins, cot = _ssm_case(S + dim, Bsz, S, dim, N)
    if not dh:
        cot[1] = np.zeros_like(cot[1])
    tdt, jdt = DT[dtype]
    args = [jnp.asarray(a).astype(jdt) if _model_dtype(i) else jnp.asarray(a)
            for i, a in enumerate(ins)]
    _, vjp = jax.vjp(lambda *a: j_ssm_scan(*a, chunk=chunk, impl="ref"), *args)
    want = vjp((jnp.asarray(cot[0]).astype(jdt), jnp.asarray(cot[1])))
    t = [torch.from_numpy(a).to(tdt) if _model_dtype(i) else torch.from_numpy(a)
         for i, a in enumerate(ins)]
    leaves = [x.clone().requires_grad_() for x in t]
    y, h = ssm_scan(*leaves, chunk=chunk)
    dy = torch.from_numpy(cot[0]).to(tdt)
    outs, cots = ((y, h), (dy, torch.from_numpy(cot[1]))) if dh else ((y,), (dy,))
    got = torch.autograd.grad(outs, leaves, cots)
    ref = ssm_scan_bwd_ref(*t, dy, torch.from_numpy(cot[1]) if dh else None)
    for name, a, b, w, leaf in zip(SSM_NAMES, got, ref, want, leaves):
        assert a.dtype == b.dtype == leaf.dtype, name
        _hold(a, w, dtype, name)
        _hold(b, w, dtype, name)


def test_ssm_bwd_ref_matches_autograd():
    """``ssm_scan_bwd_ref`` against ``torch.autograd.grad`` through the
    plain forward, f32, with and without h0 and dh."""
    ins, cot = _ssm_case(5, 2, 16, 8, 8)
    dy, dh = (torch.from_numpy(a) for a in cot)
    for with_state in (True, False):
        leaves = [torch.from_numpy(a).requires_grad_() for a in ins]
        h0 = leaves[6] if with_state else None
        y, h = ssm_scan_ref(*leaves[:6], h0, chunk=8)
        outs, cots = ((y, h), (dy, dh)) if with_state else ((y,), (dy,))
        wanted = leaves if with_state else leaves[:6]
        want = torch.autograd.grad(outs, wanted, cots)
        got = ssm_scan_bwd_ref(*(x.detach() for x in leaves[:6]),
                               None if h0 is None else h0.detach(), dy, dh if with_state else None)
        for name, a, b in zip(SSM_NAMES, got, want):
            assert a.dtype == b.dtype and a.shape == b.shape, name
            assert (a - b).norm() <= 1e-5 * b.norm() + 1e-7, name


def test_ssm_grads_of_a_subset_match_jax_vjp():
    """Only x, A and D require grad, and no h0: the others get none, and
    the three match JAX's."""
    ins, cot = _ssm_case(9, 1, 10, 8, 4)
    ins[6] = np.zeros_like(ins[6])
    _, vjp = jax.vjp(lambda *a: j_ssm_scan(*a, chunk=4, impl="ref"), *(jnp.asarray(a) for a in ins))
    want = vjp((jnp.asarray(cot[0]), jnp.asarray(cot[1])))
    t = [torch.from_numpy(a) for a in ins[:6]]
    for i in (0, 2, 5):
        t[i].requires_grad_()
    y, h = ssm_scan(*t, None, chunk=4)
    (y * torch.from_numpy(cot[0])).sum().add((h * torch.from_numpy(cot[1])).sum()).backward()
    assert all(t[i].grad is None for i in (1, 3, 4))
    for i in (0, 2, 5):
        _hold(t[i].grad, want[i], "f32", SSM_NAMES[i])


# ---------------------------------------------------------------------------
# The backward kernels' decompositions, in plain torch, against the plain
# backwards (f32, 1e-5 in norm): rwkv6 as a parallel term pass, an
# elementwise reverse scan of the state's cotangent and chunks that are
# then independent (csrc/rwkv6_scan_bwd.cu); ssm as a parallel walk of
# each time chunk from a zero state, a serial pass over the chunks' three
# terms and a parallel reverse walk of each chunk from its checkpoints
# (csrc/ssm_scan_bwd.cu)
# ---------------------------------------------------------------------------
def _close_norm(got, want, name):
    assert got.shape == want.shape, name
    assert (got - want).norm() <= 1e-5 * want.norm() + 1e-7, (name, float((got - want).norm()))


@pytest.mark.parametrize("B,S,H,N,chunk,dstate", [(2, 48, 2, 8, 8, True), (1, 64, 2, 16, 16, False),
                                                  (1, 40, 3, 8, 4, True)])
def test_rwkv6_bwd_as_terms_a_reverse_scan_and_independent_chunks(B, S, H, N, chunk, dstate):
    from repro_torch.kernels.rwkv6_scan.ref import _chunk_terms, _to_chunks

    ins, cot = _rwkv_case(S + N, B, S, H, N)
    r, k, v, w, u, s0 = (torch.from_numpy(a) for a in ins)
    dout = torch.from_numpy(cot[0])
    dst = torch.from_numpy(cot[1]) if dstate else None
    want = rwkv6_scan_bwd_ref(r, k, v, w, u, s0, dout, dst, chunk=chunk)
    n = S // chunk
    tri = torch.tril(torch.ones((chunk, chunk)), diagonal=-1)
    rc, wc, doc = (_to_chunks(x, n, chunk) for x in (r, w, dout))
    # the term pass: U_c = (r E)_c^T dO_c and E_C of every chunk
    terms = [_chunk_terms(rc[c], rc[c], wc[c], tri) for c in range(n)]
    U = [torch.einsum("bhin,bhim->bhnm", terms[c][3], doc[c]) for c in range(n)]
    etot = [terms[c][2][..., 0, :, None] for c in range(n)]
    # the reverse scan, elementwise: dS_out of every chunk, then dstate0
    ds = torch.zeros((B, H, N, N)) if dst is None else dst.clone()
    dsout = [None] * n
    for c in reversed(range(n)):
        dsout[c] = ds
        ds = etot[c] * ds + U[c]
    _close_norm(ds, want[5], "dstate0")
    # every chunk alone, from its input state and its dS_out
    state, parts = s0, []
    for c in range(n):
        cut = slice(c * chunk, (c + 1) * chunk)
        args = (r[:, cut], k[:, cut], v[:, cut], w[:, cut], u, state)
        parts.append(rwkv6_scan_bwd_ref(*args, dout[:, cut], dsout[c], chunk=chunk))
        _close_norm(parts[-1][5], dsout[c - 1] if c else ds, f"dS_in of chunk {c}")
        state = rwkv6_chunked_ref(*args, chunk=chunk)[1]
    for i, name in enumerate(("dr", "dk", "dv", "dw")):
        _close_norm(torch.cat([p[i] for p in parts], 1), want[i], name)
    _close_norm(sum(p[4] for p in parts), want[4], "du")


def _ssm_three_passes(x, dt, A, Bm, Cm, D, h0, dy, dh, chunk, seg):
    """The backward as csrc/ssm_scan_bwd.cu orders it, in f32: (1) each
    chunk from a zero state (its local end state, decay product and local
    start cotangent; the local state and the sum of dt at every segment's
    start), (2) the chunks in order and in reverse, (3) each chunk's
    segments in reverse from ckpt + exp(A cumdt) h_in."""
    Bsz, S, dim = x.shape
    N = A.shape[1]
    zeros = torch.zeros((Bsz, dim, N))
    a = torch.exp(A[None, None] * dt[..., None])                   # [B,S,dim,N]
    u = (dt * x)[..., None] * Bm[:, :, None, :]
    gy = dy[..., None] * Cm[:, :, None, :]
    starts = list(range(0, S, chunk))
    terms, ckpt, cumdt = [], {}, {}
    for t0 in starts:                                                # (1)
        h, pr, gl = zeros.clone(), torch.ones((Bsz, dim, N)), zeros.clone()
        cd = torch.zeros((Bsz, dim))
        for t in range(t0, min(S, t0 + chunk)):
            if t % seg == 0:
                ckpt[t], cumdt[t] = h, cd
            h = a[:, t] * h + u[:, t]
            pr = pr * a[:, t]
            gl = gl + pr * gy[:, t]
            cd = cd + dt[:, t]
        terms.append((h, pr, gl))
    hin, gout = [], [None] * len(starts)                             # (2)
    hs = zeros if h0 is None else h0
    for hl, pr, _ in terms:
        hin.append(hs)
        hs = pr * hs + hl
    gs = zeros if dh is None else dh
    for c in reversed(range(len(starts))):
        gout[c] = gs
        gs = terms[c][1] * gs + terms[c][2]
    dh0 = gs
    dx, ddt, dB, dC = (torch.zeros_like(t) for t in (x, dt, Bm, Cm))
    dA, dD = torch.zeros_like(A), torch.zeros_like(D)
    for c, t0 in enumerate(starts):                                  # (3)
        carry = gout[c]
        for s0 in reversed(range(t0, min(S, t0 + chunk), seg)):
            h = ckpt[s0] + torch.exp(A[None] * cumdt[s0][..., None]) * hin[c]
            hp = []
            for t in range(s0, min(S, s0 + seg)):
                hp.append(h)
                h = a[:, t] * h + u[:, t]
            hp.append(h)
            for j in reversed(range(len(hp) - 1)):
                t = s0 + j
                g = gy[:, t] + carry
                dC[:, t] = torch.einsum("bd,bdn->bn", dy[:, t], hp[j + 1])
                dB[:, t] = torch.einsum("bdn,bd->bn", g, dt[:, t] * x[:, t])
                da = g * hp[j] * a[:, t]
                ddt[:, t] = (da * A[None]).sum(-1) + x[:, t] * (g * Bm[:, t, None, :]).sum(-1)
                dx[:, t] = dt[:, t] * (g * Bm[:, t, None, :]).sum(-1) + D[None] * dy[:, t]
                dA = dA + (da * dt[:, t, :, None]).sum(0)
                dD = dD + (dy[:, t] * x[:, t]).sum(0)
                carry = a[:, t] * g
    return dx, ddt, dA, dB, dC, dD, dh0


@pytest.mark.parametrize("B,S,dim,N,chunk,seg,state,zero_decay", [
    (2, 29, 6, 4, 8, 4, True, False),     # ragged: the last chunk and segment short
    (1, 32, 5, 8, 16, 4, False, False),   # no h0, no dh
    (2, 37, 4, 4, 12, 4, True, True),     # a = exp(A dt) = 0 inside a chunk
])
def test_ssm_bwd_as_three_passes_over_time_chunks(B, S, dim, N, chunk, seg, state, zero_decay):
    ins, cot = _ssm_case(S * dim + N, B, S, dim, N)
    t = [torch.from_numpy(a) for a in ins]
    dy, dh = (torch.from_numpy(a) for a in cot)
    if zero_decay:   # A dt below -104 at token 17, mid-chunk: a underflows to 0
        t[1][:, 17] = 200.0
        assert float(torch.exp(t[2].max() * 200.0)) == 0.0
    if not state:
        t[6], dh = None, None
    want = ssm_scan_bwd_ref(*t, dy, dh)
    got = _ssm_three_passes(*t, dy, dh, chunk, seg)
    for name, a, b in zip(SSM_NAMES, got, want):
        _close_norm(a, b, name)


@pytest.mark.parametrize("S", [1, 16, 127, 128, 129, 1000, 1838, 2048, 4097])
@pytest.mark.parametrize("N", [4, 16, 32])
def test_ssm_bwd_scratch_shapes_for_ragged_sequences(S, N):
    """The backward's scratch plan: one time chunk per 128 tokens and one
    checkpoint per segment, the last of each ragged; chunks hold whole
    segments; dB / dC partials per block of 64 channels; the three chunk
    terms and dA's partials one [dim, N] slice per (row, chunk)."""
    from repro_torch.kernels.ssm_scan import ops as ssm_ops

    B, dim = 2, 100
    plan = ssm_ops.bwd_scratch_shapes(B, S, dim, N)
    seg = ssm_ops.SEGMENT[N]
    n_chunks = -(-S // ssm_ops.CHUNK)
    assert ssm_ops.CHUNK % seg == 0
    assert (n_chunks - 1) * ssm_ops.CHUNK < S <= n_chunks * ssm_ops.CHUNK
    assert plan["ckpt"] == (B, -(-S // seg), dim, N) and plan["cumdt"] == (B, -(-S // seg), dim)
    for name in ("hloc", "prod", "gloc", "dA_part"):
        assert plan[name] == (B, n_chunks, dim, N), name
    assert plan["dD_part"] == (B, n_chunks, dim)
    assert plan["dB_part"] == plan["dC_part"] == (B, 2, S, N)
