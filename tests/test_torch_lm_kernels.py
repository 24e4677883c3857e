"""The port's LM kernels (plain versions, on the CPU) against the JAX
package's: ``rwkv6_scan`` against the Pallas kernel in interpret mode,
the chunked jnp form and the sequential oracle; ``rwkv6_decode_step``;
``flash_attention`` against the Pallas kernel in interpret mode and,
with ``q_offset``/``kv_len``, against ``flash_attention_ref``;
``ssm_scan`` against the Pallas kernel in interpret mode, the chunked
associative scan and the sequential oracle; ``ssm_decode_step``.

Inputs are drawn with numpy from a seed and handed to both packages
(bf16 inputs are the same f32 draws rounded to bf16 by each).
Tolerances as ``tests/test_kernels.py``: f32 ``rtol=atol=2e-4``, bf16
``2e-2``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.kernels.flash_attention.kernel import flash_attention_kernel
from repro.kernels.flash_attention.ref import flash_attention_ref as j_flash_ref
from repro.kernels.rwkv6_scan.kernel import rwkv6_scan_kernel
from repro.kernels.rwkv6_scan.ops import _rwkv6_chunked
from repro.kernels.rwkv6_scan.ops import rwkv6_decode_step as j_decode_step
from repro.kernels.rwkv6_scan.ops import rwkv6_scan as j_rwkv6_scan
from repro.kernels.rwkv6_scan.ref import rwkv6_ref as j_rwkv6_ref
from repro.kernels.ssm_scan.kernel import ssm_scan_kernel
from repro.kernels.ssm_scan.ops import _ssm_chunked
from repro.kernels.ssm_scan.ops import ssm_decode_step as j_ssm_decode_step
from repro.kernels.ssm_scan.ops import ssm_scan as j_ssm_scan
from repro.kernels.ssm_scan.ref import ssm_scan_ref as j_ssm_scan_ref
from repro_torch.kernels import launch_counts, reset_launch_counts
from repro_torch.kernels.flash_attention import flash_attention, flash_attention_ref, mha_reference
from repro_torch.kernels.rwkv6_scan import rwkv6_decode_step, rwkv6_ref, rwkv6_scan
from repro_torch.kernels.ssm_scan import ops as ssm_ops
from repro_torch.kernels.ssm_scan import ssm_decode_step, ssm_scan, ssm_scan_ref
from test_torch_models import release_jax_executables  # noqa: F401 (autouse)

TOL = dict(rtol=2e-2, atol=2e-2)       # bf16 inputs
TOL32 = dict(rtol=2e-4, atol=2e-4)     # f32 inputs
DTYPES = {"f32": (torch.float32, jnp.float32, TOL32), "bf16": (torch.bfloat16, jnp.bfloat16, TOL)}


def _both(a, dtype):
    tdt, jdt, _ = DTYPES[dtype]
    a = np.asarray(a, np.float32)
    return torch.from_numpy(a.copy()).to(tdt), jnp.asarray(a).astype(jdt)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _rwkv_arrays(seed, B, S, H, N):
    rng = np.random.default_rng(seed)
    return dict(
        r=rng.standard_normal((B, S, H, N)),
        k=rng.standard_normal((B, S, H, N)) * 0.5,
        v=rng.standard_normal((B, S, H, N)),
        w=np.exp(-np.exp(rng.uniform(-3.0, 1.0, (B, S, H, N)))),
        u=rng.standard_normal((H, N)) * 0.3,
        s0=rng.standard_normal((B, H, N, N)) * 0.1,
    )


RWKV_SHAPES = [(1, 32, 2, 8, 8), (2, 64, 3, 16, 16), (1, 48, 1, 32, 16), (2, 45, 2, 16, 16)]


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("B,S,H,N,chunk", RWKV_SHAPES, ids=lambda v: str(v))
def test_rwkv6_scan_matches_pallas_chunked_and_oracle(B, S, H, N, chunk, dtype):
    a = _rwkv_arrays(B * S + N, B, S, H, N)
    tol = DTYPES[dtype][2]
    t, j = {}, {}
    for name in ("r", "k", "v", "w", "u"):
        t[name], j[name] = _both(a[name], dtype)
    t_s0 = torch.from_numpy(a["s0"].astype(np.float32))
    j_s0 = jnp.asarray(a["s0"].astype(np.float32))
    args_t = (t["r"], t["k"], t["v"], t["w"], t["u"], t_s0)
    args_j = (j["r"], j["k"], j["v"], j["w"], j["u"], j_s0)

    out, state = rwkv6_scan(*args_t, chunk=chunk)
    assert out.dtype == t["r"].dtype and out.shape == (B, S, H, N)
    assert state.dtype == torch.float32 and state.shape == (B, H, N, N)
    o_ref, s_ref = j_rwkv6_ref(*args_j)
    if S % chunk == 0:
        o_k, s_k = rwkv6_scan_kernel(*args_j, chunk=chunk, interpret=True)
        o_c, s_c = _rwkv6_chunked(*args_j, chunk=chunk)
    else:  # the padding of the public wrapper, on the Pallas kernel
        o_k, s_k = j_rwkv6_scan(*args_j, chunk=chunk, impl="kernel", interpret=True)
        o_c, s_c = j_rwkv6_scan(*args_j, chunk=chunk, impl="ref")
    for o_j, s_j in ((o_k, s_k), (o_c, s_c)):
        np.testing.assert_allclose(_np(out), _np(o_j), **tol)
        np.testing.assert_allclose(state.numpy(), _np(s_j), **TOL32)
    np.testing.assert_allclose(_np(out), _np(o_ref), **tol)
    np.testing.assert_allclose(state.numpy(), _np(s_ref), **TOL32)
    o_seq, s_seq = rwkv6_ref(*args_t)
    np.testing.assert_allclose(_np(o_seq), _np(o_ref), **tol)
    np.testing.assert_allclose(s_seq.numpy(), _np(s_ref), **TOL32)


def test_rwkv6_scan_without_state_starts_from_zeros():
    a = _rwkv_arrays(3, 1, 16, 2, 8)
    t = {n: torch.from_numpy(a[n].astype(np.float32)) for n in a}
    out, state = rwkv6_scan(t["r"], t["k"], t["v"], t["w"], t["u"], None, chunk=8)
    o2, s2 = rwkv6_scan(t["r"], t["k"], t["v"], t["w"], t["u"], torch.zeros(1, 2, 8, 8), chunk=8)
    assert torch.equal(out, o2) and torch.equal(state, s2)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_rwkv6_decode_step_matches_jax(dtype):
    a = _rwkv_arrays(5, 2, 1, 3, 16)
    tol = DTYPES[dtype][2]
    t, j = {}, {}
    for name in ("r", "k", "v", "w", "u"):
        x = a[name][:, 0] if a[name].ndim == 4 else a[name]
        t[name], j[name] = _both(x, dtype)
    s0 = a["s0"].astype(np.float32)
    out, state = rwkv6_decode_step(t["r"], t["k"], t["v"], t["w"], t["u"], torch.from_numpy(s0))
    o_j, s_j = j_decode_step(j["r"], j["k"], j["v"], j["w"], j["u"], jnp.asarray(s0))
    assert out.dtype == t["r"].dtype
    np.testing.assert_allclose(_np(out), _np(o_j), **tol)
    np.testing.assert_allclose(state.numpy(), _np(s_j), **TOL32)


def _qkv(seed, B, Sq, Skv, H, KV, D, dtype):
    rng = np.random.default_rng(seed)
    q = _both(rng.standard_normal((B, Sq, H, D)), dtype)
    k = _both(rng.standard_normal((B, Skv, KV, D)), dtype)
    v = _both(rng.standard_normal((B, Skv, KV, D)), dtype)
    return (q[0], k[0], v[0]), (q[1], k[1], v[1])


FLASH_CASES = [
    (1, 64, 2, 2, 32, True, 0, 16, 16),
    (2, 128, 4, 2, 64, True, 0, 32, 64),
    (2, 128, 4, 1, 64, False, 0, 64, 32),     # MQA
    (1, 256, 8, 4, 32, True, 64, 64, 64),     # sliding window
    (1, 96, 2, 2, 32, True, 0, 32, 32),       # ragged: S % block != 0
]


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("B,S,H,KV,D,causal,window,bq,bk", FLASH_CASES, ids=lambda v: str(v))
def test_flash_attention_matches_pallas_kernel(B, S, H, KV, D, causal, window, bq, bk, dtype):
    (qt, kt, vt), (qj, kj, vj) = _qkv(S + D, B, S, S, H, KV, D, dtype)
    out = flash_attention(qt, kt, vt, causal=causal, window=window)
    want = flash_attention_kernel(qj, kj, vj, causal=causal, window=window,
                                  block_q=bq, block_k=bk, interpret=True)
    assert out.dtype == qt.dtype and out.shape == qt.shape
    np.testing.assert_allclose(_np(out), _np(want), **DTYPES[dtype][2])


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize(
    "Sq,Skv,q_offset,kv_len,window",
    [(24, 48, 0, 24, 0), (8, 64, 20, 28, 0), (8, 64, 20, 28, 8), (1, 40, 30, 31, 0), (33, 96, 0, 33, 16)],
    ids=lambda v: str(v),
)
def test_flash_attention_offset_and_kv_len_match_jax_ref(Sq, Skv, q_offset, kv_len, window, dtype):
    (qt, kt, vt), (qj, kj, vj) = _qkv(Sq * Skv, 2, Sq, Skv, 4, 2, 32, dtype)
    out = flash_attention(qt, kt, vt, causal=True, window=window, q_offset=q_offset, kv_len=kv_len)
    want = j_flash_ref(qj, kj, vj, causal=True, window=window,
                       q_offset=jnp.asarray(q_offset), kv_len=jnp.asarray(kv_len), block_k=16)
    np.testing.assert_allclose(_np(out), _np(want), **DTYPES[dtype][2])
    naive = mha_reference(qt.float(), kt.float(), vt.float(), causal=True, window=window,
                          q_offset=q_offset, kv_len=kv_len)
    ref = flash_attention_ref(qt.float(), kt.float(), vt.float(), causal=True, window=window,
                              q_offset=q_offset, kv_len=kv_len, block_k=16)
    np.testing.assert_allclose(ref.numpy(), naive.numpy(), **TOL32)


# ---------------------------------------------------------------------------
# ssm_scan (Mamba-1): x, B, C in the model's dtype, dt, A, D and the state
# in f32, as ``mamba_apply`` hands them over
# ---------------------------------------------------------------------------
def _ssm_arrays(seed, B, S, dim, N):
    rng = np.random.default_rng(seed)
    return dict(
        x=rng.standard_normal((B, S, dim)),
        dt=np.log1p(np.exp(rng.standard_normal((B, S, dim)) - 1.0)),   # softplus
        A=-np.exp(rng.standard_normal((dim, N))),
        B=rng.standard_normal((B, S, N)),
        C=rng.standard_normal((B, S, N)),
        D=rng.standard_normal((dim,)),
        h0=rng.standard_normal((B, dim, N)) * 0.1,
    )


def _ssm_both(a, dtype):
    """(torch args, jax args): x, B, C in ``dtype``, the rest f32."""
    t, j = [], []
    for name in ("x", "dt", "A", "B", "C", "D", "h0"):
        tt, jj = _both(a[name], dtype if name in ("x", "B", "C") else "f32")
        t.append(tt)
        j.append(jj)
    return t, j


# the shapes of tests/test_kernels.py::test_ssm_chunked_and_kernel, and a
# ragged sequence (45 = 2 chunks of 16 and 13 tokens) at jamba smoke's N
SSM_SHAPES = [(1, 32, 8, 4, 8, 8), (2, 64, 16, 8, 16, 8), (1, 128, 8, 4, 32, 4),
              (2, 45, 16, 8, 16, 8)]


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("B,S,dim,N,chunk,bd", SSM_SHAPES, ids=lambda v: str(v))
def test_ssm_scan_matches_pallas_chunked_and_oracle(B, S, dim, N, chunk, bd, dtype):
    tol = DTYPES[dtype][2]
    args_t, args_j = _ssm_both(_ssm_arrays(B * S + dim, B, S, dim, N), dtype)
    y, h = ssm_scan(*args_t, chunk=chunk)
    assert y.dtype == args_t[0].dtype and y.shape == (B, S, dim)
    assert h.dtype == torch.float32 and h.shape == (B, dim, N)
    y_ref, h_ref = j_ssm_scan_ref(*args_j)
    if S % chunk == 0:
        y_k, h_k = ssm_scan_kernel(*args_j, chunk=chunk, block_dim=bd, interpret=True)
        y_c, h_c = _ssm_chunked(*args_j, chunk=chunk)
    else:  # the padding of the public wrapper, on the Pallas kernel
        y_k, h_k = j_ssm_scan(*args_j, chunk=chunk, impl="kernel", interpret=True)
        y_c, h_c = j_ssm_scan(*args_j, chunk=chunk, impl="ref")
    for y_j, h_j in ((y_ref, h_ref), (y_k, h_k), (y_c, h_c)):
        np.testing.assert_allclose(_np(y), _np(y_j), **tol)
        np.testing.assert_allclose(h.numpy(), _np(h_j), **TOL32)


def test_ssm_scan_without_state_starts_from_zeros():
    a = _ssm_arrays(3, 1, 16, 8, 4)
    t, _ = _ssm_both(a, "f32")
    y, h = ssm_scan(*t[:6], None, chunk=8)
    y2, h2 = ssm_scan(*t[:6], torch.zeros(1, 8, 4), chunk=8)
    assert torch.equal(y, y2) and torch.equal(h, h2)


def test_ssm_scan_ref_refuses_a_ragged_sequence():
    t, _ = _ssm_both(_ssm_arrays(4, 1, 12, 8, 4), "f32")
    with pytest.raises(ValueError, match="divisible"):
        ssm_scan_ref(*t, chunk=8)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_ssm_decode_step_matches_jax_and_the_scan(dtype):
    a = _ssm_arrays(5, 2, 17, 8, 4)
    tol = DTYPES[dtype][2]
    t, j = _ssm_both(a, dtype)
    last = lambda xs: [x[:, -1] if i in (0, 1, 3, 4) else x for i, x in enumerate(xs)]
    _, h_prefix = ssm_scan(t[0][:, :-1], t[1][:, :-1], t[2], t[3][:, :-1], t[4][:, :-1],
                           t[5], t[6], chunk=16)
    tx, tdt, tA, tB, tC, tD, _ = last(t)
    y_d, h_d = ssm_decode_step(tx, tdt, tA, tB, tC, tD, h_prefix)
    jx, jdt, jA, jB, jC, jD, _ = last(j)
    y_j, h_j = j_ssm_decode_step(jx, jdt, jA, jB, jC, jD, jnp.asarray(h_prefix.numpy()))
    assert y_d.dtype == t[0].dtype
    np.testing.assert_allclose(_np(y_d), _np(y_j), **tol)
    np.testing.assert_allclose(h_d.numpy(), _np(h_j), **TOL32)
    # the step after the prefix is the scan's last token
    y_full, h_full = ssm_scan(*t, chunk=17)
    np.testing.assert_allclose(_np(y_d), _np(y_full[:, -1]), **tol)
    np.testing.assert_allclose(h_d.numpy(), h_full.numpy(), **TOL32)


def test_cpu_tensors_run_the_plain_versions():
    reset_launch_counts()
    (qt, kt, vt), _ = _qkv(0, 1, 16, 16, 2, 1, 8, "f32")
    flash_attention(qt, kt, vt)
    a = _rwkv_arrays(0, 1, 8, 1, 4)
    t = {n: torch.from_numpy(a[n].astype(np.float32)) for n in a}
    rwkv6_scan(t["r"], t["k"], t["v"], t["w"], t["u"], t["s0"], chunk=4)
    ssm_scan(*_ssm_both(_ssm_arrays(0, 1, 8, 8, 4), "f32")[0], chunk=4)
    counts = launch_counts()
    assert counts["flash_attention"] == counts["rwkv6_scan"] == counts["ssm_scan"] == 0


# ---------------------------------------------------------------------------
# The algebra of the CUDA kernels, in plain PyTorch on the CPU: the
# two-pass split of rwkv6_scan (csrc/rwkv6_scan.cu), the bf16
# tensor-core rounding of flash_attention (csrc/flash_attention.cu), and
# the unpadded steps of ssm_scan (csrc/ssm_scan.cu)
# ---------------------------------------------------------------------------
def _rwkv6_two_pass(r, k, v, w, u, s0, chunk, slice_cols=32):
    """Pass 1 per chunk, from that chunk alone: the intra-chunk output
    y = A V + d V. Pass 2 per slice of value columns, chunk after chunk:
    the decay again, out = (r E) S_in + y, S = diag(E_C) S + (k/E'.E_C)^T V."""
    B, S, H, N = r.shape
    C = chunk
    f32 = torch.float32
    rc, kc, vc, wc = (x.to(f32).reshape(B, S // C, C, H, N).permute(1, 0, 3, 2, 4)
                      for x in (r, k, v, w))                          # [n, B, H, C, N]
    lower = torch.tril(torch.ones(C, C, dtype=torch.bool), diagonal=-1)

    def decay(w_):
        logw = torch.clamp_min(torch.log(torch.clamp_min(w_, 1e-30)), -5.0)
        li = torch.cumsum(logw, dim=-2)
        return li - logw, li, torch.exp(li[..., -1:, :])               # Lx, Li, E_C

    ys = []
    for c in range(S // C):                                           # pass 1
        lx, li, _ = decay(wc[c])
        q_, kd = rc[c] * torch.exp(lx), kc[c] * torch.exp(-li)
        A = torch.where(lower, q_ @ kd.transpose(-1, -2), 0.0)
        d = ((rc[c] * kc[c]) * u.to(f32)[None, :, None, :]).sum(-1)
        ys.append(A @ vc[c] + d[..., None] * vc[c])
    out = torch.empty((S // C, B, H, C, N), dtype=f32)
    state = torch.empty((B, H, N, N), dtype=f32)
    for m0 in range(0, N, slice_cols):                                # pass 2
        cols = slice(m0, min(m0 + slice_cols, N))
        st = s0.to(f32)[..., cols]
        for c in range(S // C):
            lx, li, etot = decay(wc[c])
            out[c][..., cols] = rc[c] * torch.exp(lx) @ st + ys[c][..., cols]
            k_carry = (kc[c] * torch.exp(-li)) * etot
            st = etot[..., 0, :, None] * st + k_carry.transpose(-1, -2) @ vc[c][..., cols]
        state[..., cols] = st
    return out.permute(1, 0, 3, 2, 4).reshape(B, S, H, N).to(r.dtype), state


@pytest.mark.parametrize("B,S,H,N,chunk", [(2, 64, 2, 16, 16), (1, 96, 1, 64, 32), (1, 32, 2, 40, 8)],
                         ids=lambda v: str(v))
def test_rwkv6_two_pass_split_matches_pallas(B, S, H, N, chunk):
    a = _rwkv_arrays(S + N, B, S, H, N)
    t, j = {}, {}
    for name in ("r", "k", "v", "w", "u", "s0"):
        t[name], j[name] = _both(a[name], "f32")
    out, state = _rwkv6_two_pass(t["r"], t["k"], t["v"], t["w"], t["u"], t["s0"], chunk)
    o_k, s_k = rwkv6_scan_kernel(j["r"], j["k"], j["v"], j["w"], j["u"], j["s0"],
                                 chunk=chunk, interpret=True)
    np.testing.assert_allclose(out.numpy(), _np(o_k), **TOL32)
    np.testing.assert_allclose(state.numpy(), _np(s_k), **TOL32)


def _flash_bf16_tensor_core(q, k, v, *, causal, window, q_offset, kv_len, block_k=64):
    """bf16 operands, f32 sums, the scores scaled by 1/sqrt(D) after the
    product, P rounded to bf16 before P V; the online softmax over
    64-key tiles in log2 units, as the kernel runs it."""
    B, Sq, H, D = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    G = H // KV
    f32, bf = torch.float32, torch.bfloat16
    qf = q.to(bf).to(f32).reshape(B, Sq, KV, G, D)
    kf, vf = k.to(bf).to(f32), v.to(bf).to(f32)
    scale_log2 = (1.0 / D ** 0.5) * 1.4426950408889634
    q_pos = q_offset + torch.arange(Sq)
    m = torch.full((B, Sq, KV, G), -1e30)
    l = torch.zeros((B, Sq, KV, G))
    acc = torch.zeros((B, Sq, KV, G, D))
    for start in range(0, Skv, block_k):
        k_pos = start + torch.arange(min(block_k, Skv - start))
        s = torch.einsum("bqkgd,bckd->bqkgc", qf, kf[:, start:start + block_k]) * scale_log2
        ok = (k_pos < kv_len)[None, :] & (k_pos[None, :] <= q_pos[:, None] if causal else True)
        if window > 0:
            ok = ok & (k_pos[None, :] > q_pos[:, None] - window)
        s = torch.where(ok[None, :, None, None, :], s, -1e30)
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp2(s - m_new[..., None])
        corr = torch.exp2(m - m_new)
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bqkgc,bckd->bqkgd", p.to(bf).to(f32), vf[:, start:start + block_k])
        m = m_new
    return (acc / torch.clamp_min(l[..., None], 1e-30)).reshape(B, Sq, H, D)


@pytest.mark.parametrize(
    "B,Sq,Skv,H,KV,D,window,q_offset,kv_len",
    [(1, 192, 192, 4, 2, 256, 0, 0, 192), (1, 160, 160, 16, 2, 128, 48, 0, 160),
     (2, 40, 200, 4, 1, 64, 32, 100, 140), (1, 70, 70, 4, 2, 24, 0, 0, 70)],
    ids=lambda v: str(v),
)
def test_flash_attention_bf16_tensor_core_rounding_matches_jax_ref(B, Sq, Skv, H, KV, D, window,
                                                                   q_offset, kv_len):
    rng = np.random.default_rng(Sq + D)
    q, k, v = (rng.standard_normal(shape).astype(np.float32)
               for shape in ((B, Sq, H, D), (B, Skv, KV, D), (B, Skv, KV, D)))
    # both sides see the same bf16-rounded operands; JAX computes in f32
    q, k, v = (torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v))
    got = _flash_bf16_tensor_core(q, k, v, causal=True, window=window, q_offset=q_offset,
                                  kv_len=kv_len)
    want = _np(j_flash_ref(*(jnp.asarray(x.float().numpy()) for x in (q, k, v)), causal=True,
                           window=window, q_offset=jnp.asarray(q_offset),
                           kv_len=jnp.asarray(kv_len), block_k=64))
    assert np.all(np.abs(got.numpy() - want) <= 2e-2 * (1 + np.abs(want)))


def _ssm_steps(x, dt, A, B, C, D, h0):
    """The recurrence token by token over exactly the given tokens, one
    ``ssm_decode_step`` a token."""
    h, ys = h0, []
    for t in range(x.shape[1]):
        y, h = ssm_decode_step(x[:, t], dt[:, t], A, B[:, t], C[:, t], D, h)
        ys.append(y)
    return torch.stack(ys, dim=1), h


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("S,dim", [(1, 8), (45, 16), (1838, 8)])
def test_ssm_zero_rows_are_exact_identity_steps(S, dim, dtype):
    """The kernel steps a ragged tail on zero rows (x, dt, B, C = 0) and
    drops their y: the plain scan over the zero-padded sequence, cut to
    S, equals the recurrence over the S tokens alone, bit for bit."""
    t, _ = _ssm_both(_ssm_arrays(S + dim, 1, S, dim, 4), dtype)
    pad = -S % 64
    padded = [F.pad(a, (0, 0, 0, pad)) if i in (0, 1, 3, 4) else a for i, a in enumerate(t)]
    y_pad, h_pad = ssm_scan_ref(*padded, chunk=64)
    y, h = _ssm_steps(*t)
    assert torch.equal(y_pad[:, :S], y) and torch.equal(h_pad, h)


def test_ssm_scan_hands_the_kernel_its_own_sequence(monkeypatch):
    """On the CUDA path the wrapper copies nothing: the kernel gets the
    unpadded, contiguous operands, and its contiguous y is returned as
    it is."""
    calls = []

    def launch(x, dt, A, B, C, D, h0):
        calls.append([None if a is None else (tuple(a.shape), a.is_contiguous())
                      for a in (x, dt, B, C, h0)])
        y, h = ssm_scan_ref(x, dt, A, B, C, D, h0, chunk=max(x.shape[1], 1))
        return y.contiguous(), h

    monkeypatch.setattr(ssm_ops, "use_kernel", lambda x: True)
    monkeypatch.setattr(ssm_ops, "_launch", launch)
    for S in (1, 45, 300):
        t, _ = _ssm_both(_ssm_arrays(S, 2, S, 16, 8), "bf16")
        y, h = ssm_scan(*t, chunk=256)
        assert calls[-1] == [((2, S, 16), True), ((2, S, 16), True), ((2, S, 8), True),
                             ((2, S, 8), True), ((2, 16, 8), True)]
        assert y.shape == (2, S, 16) and y.is_contiguous() and h.shape == (2, 16, 8)
        y_ref, h_ref = ssm_scan_ref(*[F.pad(a, (0, 0, 0, -S % 256)) if i in (0, 1, 3, 4)
                                     else a for i, a in enumerate(t)], chunk=256)
        assert torch.equal(y, y_ref[:, :S]) and torch.equal(h, h_ref)
    ssm_scan(*t[:6], None, chunk=256)
    assert calls[-1][-1] is None       # no state: nothing allocated, the kernel starts from zeros
    assert len(calls) == 4
