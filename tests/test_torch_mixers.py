"""The port's Mamba mixer and Mixture-of-Experts MLP against the JAX
package's, on the CPU, on the same weights (drawn by the JAX init and
carried across as numpy arrays) and the same inputs (numpy seed).

* ``mamba_apply`` from the zero state and from a given state (SSM state
  and conv tail), with the state it returns, then three
  ``mamba_decode`` steps.
* ``moe_apply`` on the per-row dispatch (prefill) and on the global
  dispatch (decode), with and without a ``shared`` expert, and with
  pairs dropped by capacity on both dispatches. The chosen experts are
  compared first, then the outputs. The global dispatch's capacity at
  jamba's width and 4 slots is one pair per expert, so colliding slots
  drop pairs (ROADMAP queue 3); both packages drop the same ones.

Tolerances as ``tests/test_kernels.py``: f32 ``rtol=atol=2e-4``, bf16
``2e-2``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_arch as j_get_arch
from repro.models import common as j_common
from repro.models import mlp as j_mlp
from repro.models import ssm as j_ssm
from repro.models.attention import unzip
from repro_torch.bridge import _param_tensor
from repro_torch.configs import get_arch
from repro_torch.models import common, mlp, ssm

TOL32 = dict(rtol=2e-4, atol=2e-4)
TOL16 = dict(rtol=2e-2, atol=2e-2)
DTYPES = {"f32": (jnp.float32, torch.float32, TOL32), "bf16": (jnp.bfloat16, torch.bfloat16, TOL16)}


def _configs(dtype, **kw):
    """The same small config in both packages."""
    jdt, tdt, _ = DTYPES[dtype]
    jmoe, tmoe = kw.pop("moe", None), None
    if jmoe is not None:
        tmoe = common.MoEConfig(**jmoe)
        jmoe = j_common.MoEConfig(**jmoe)
    base = dict(name="mixers", d_model=32, n_heads=2, n_kv_heads=2, d_ff=48, vocab=64, **kw)
    jcfg = j_common.ModelConfig(param_dtype=jdt, compute_dtype=jdt,
                                mamba=j_common.MambaConfig(d_state=8, conv_k=4, expand=2, chunk=8),
                                **({"moe": jmoe} if jmoe else {}), **base)
    tcfg = common.ModelConfig(param_dtype=tdt, compute_dtype=tdt,
                              mamba=common.MambaConfig(d_state=8, conv_k=4, expand=2, chunk=8),
                              **({"moe": tmoe} if tmoe else {}), **base)
    return jcfg, tcfg


def _carry(tree):
    """A JAX parameter tree (Param leaves) as (jax tree, port tensors)."""
    params, _ = unzip(tree)

    def tensors(node):
        if isinstance(node, dict):
            return {k: tensors(v) for k, v in node.items()}
        return _param_tensor(np.asarray(node))

    return params, tensors(params)


def _both(a, jdt, tdt):
    a = np.asarray(a, np.float32)
    return jnp.asarray(a).astype(jdt), torch.from_numpy(a.copy()).to(tdt)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


# ---------------------------------------------------------------------------
# Mamba
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("with_state", [False, True], ids=["zero_state", "given_state"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_mamba_apply_and_decode_match_jax(dtype, with_state):
    jdt, tdt, tol = DTYPES[dtype]
    jcfg, tcfg = _configs(dtype)
    jp, tp = _carry(j_ssm.mamba_init(jcfg, jax.random.PRNGKey(1)))
    rng = np.random.default_rng(7)
    B, S = 2, 13                         # ragged: 13 tokens, chunk 8
    jx, tx = _both(rng.standard_normal((B, S, 32)), jdt, tdt)
    di = 2 * 32
    jstate = tstate = None
    if with_state:
        jh, th = _both(rng.standard_normal((B, di, 8)) * 0.1, jnp.float32, torch.float32)
        jc, tc = _both(rng.standard_normal((B, 3, di)), jdt, tdt)
        jstate, tstate = j_ssm.MambaState(h=jh, conv=jc), ssm.MambaState(h=th, conv=tc)
    jy, js = j_ssm.mamba_apply(jcfg, jp, jx, jstate, return_state=True)
    ty, ts = ssm.mamba_apply(tcfg, tp, tx, tstate)
    assert ty.dtype == tdt and ty.shape == (B, S, 32)
    np.testing.assert_allclose(_np(ty), _np(jy), **tol)
    np.testing.assert_allclose(_np(ts.h), _np(js.h), **TOL32 if dtype == "f32" else tol)
    np.testing.assert_allclose(_np(ts.conv), _np(js.conv), **tol)
    assert ts.conv.dtype == tdt and ts.h.dtype == torch.float32
    for step in range(3):
        jx1, tx1 = _both(rng.standard_normal((B, 1, 32)), jdt, tdt)
        jy, js = j_ssm.mamba_decode(jcfg, jp, jx1, js)
        ty, ts = ssm.mamba_decode(tcfg, tp, tx1, ts)
        np.testing.assert_allclose(_np(ty), _np(jy), err_msg=f"decode {step}", **tol)
        np.testing.assert_allclose(_np(ts.h), _np(js.h), err_msg=f"decode {step}",
                                   **TOL32 if dtype == "f32" else tol)
        np.testing.assert_allclose(_np(ts.conv), _np(js.conv), **tol)


def test_mamba_init_draws_the_jax_shapes_and_dtypes():
    jcfg, tcfg = _configs("bf16")
    jp, _ = _carry(j_ssm.mamba_init(jcfg, jax.random.PRNGKey(0)))
    tp = ssm.mamba_init(tcfg, torch.Generator().manual_seed(0))
    assert set(tp) == set(jp)
    for name, t in tp.items():
        assert tuple(t.shape) == tuple(jp[name].shape), name
        assert str(t.dtype).split(".")[-1] == jnp.dtype(jp[name].dtype).name, name
    # dt = softplus(dt_bias) in [1e-3, 0.1]; A = -exp(A_log) in [-16, -1]
    dt = torch.nn.functional.softplus(tp["dt_bias"])
    assert float(dt.min()) >= 1e-3 - 1e-6 and float(dt.max()) <= 0.1 + 1e-6
    A = -torch.exp(tp["A_log"])
    assert float(A.min()) >= -16.0 - 1e-4 and float(A.max()) <= -1.0 + 1e-6
    state = ssm.init_mamba_state(tcfg, 3, "cpu")
    assert state.h.shape == (3, 64, 8) and state.conv.shape == (3, 3, 64)
    assert state.conv.dtype == torch.bfloat16


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------
MOE = dict(n_experts=4, top_k=2, expert_ff=24)


def _moe_pair(dtype, shared=0, skew=False, **moe):
    jcfg, tcfg = _configs(dtype, moe={**MOE, "shared_expert_ff": shared, **moe})
    jp, tp = _carry(j_mlp.moe_init(jcfg, jax.random.PRNGKey(3)))
    if skew:
        # every token routes to experts 0 and 1: capacity drops pairs
        router = np.asarray(jp["router"]).copy()
        router[:, 0], router[:, 1] = 0.5, 0.45
        jp["router"] = jnp.asarray(router)
        tp["router"] = torch.from_numpy(router.copy())
    return jcfg, tcfg, jp, tp


def _tokens(B, S, dtype, skew, seed=11):
    jdt, tdt, _ = DTYPES[dtype]
    x = np.random.default_rng(seed).standard_normal((B, S, 32)) + (1.0 if skew else 0.0)
    return _both(x, jdt, tdt)


def _jax_choice(jcfg, jp, jx):
    logits = jnp.einsum("...d,de->...e", jx.astype(jnp.float32), jp["router"])
    gk, ek = jax.lax.top_k(jax.nn.softmax(logits, -1), jcfg.moe.top_k)
    return np.asarray(ek), np.asarray(gk / jnp.maximum(gk.sum(-1, keepdims=True), 1e-9))


def _check_moe(jcfg, tcfg, jp, tp, jx, tx, tol):
    want_e, want_g = _jax_choice(jcfg, jp, jx)
    got_g, got_e = mlp.route(tcfg, tp, tx)
    assert np.array_equal(got_e.numpy(), want_e), "the two packages chose other experts"
    np.testing.assert_allclose(got_g.numpy(), want_g, **TOL32)
    want, _ = j_mlp.moe_apply(jcfg, jp, jx)
    got = mlp.moe_apply(tcfg, tp, tx)
    assert got.dtype == tx.dtype and got.shape == tx.shape
    np.testing.assert_allclose(_np(got), _np(want), **tol)
    return got_e


def _dense(tcfg, tp, x):
    """Every routed pair through its expert, nothing dropped (f32)."""
    gk, ek = mlp.route(tcfg, tp, x)
    out = torch.zeros_like(x)
    for idx in np.ndindex(*x.shape[:-1]):
        for j in range(tcfg.moe.top_k):
            e = int(ek[idx][j])
            g = x[idx] @ tp["we_gate"][e]
            u = x[idx] @ tp["we_up"][e]
            out[idx] += gk[idx][j] * ((torch.nn.functional.silu(g) * u) @ tp["we_down"][e])
    return out


@pytest.mark.parametrize("shared", [0, 16], ids=["no_shared", "shared"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_moe_per_row_dispatch_matches_jax(dtype, shared):
    jcfg, tcfg, jp, tp = _moe_pair(dtype, shared)
    jx, tx = _tokens(2, 12, dtype, skew=False)          # S*K = 24 >= E: per row
    assert ("shared" in tp) == bool(shared)
    _check_moe(jcfg, tcfg, jp, tp, jx, tx, DTYPES[dtype][2])


@pytest.mark.parametrize("shared", [0, 16], ids=["no_shared", "shared"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_moe_global_dispatch_matches_jax(dtype, shared):
    jcfg, tcfg, jp, tp = _moe_pair(dtype, shared, n_experts=8)
    jx, tx = _tokens(3, 1, dtype, skew=False)           # S*K = 2 < E: global
    _check_moe(jcfg, tcfg, jp, tp, jx, tx, DTYPES[dtype][2])


@pytest.mark.parametrize("B,S", [(1, 20), (4, 1)], ids=["per_row", "global"])
def test_moe_capacity_drops_the_same_pairs(B, S):
    """jamba smoke's MoE (E 4, top 2, capacity factor 1.25) with every
    token routed to experts 0 and 1: per row 20 pairs on each against a
    capacity of min(max(8, int(1.25 * 40 / 4)), 40) = 12; globally, 4
    slots' pairs against a capacity of max(1, min(int(1.25 * 4 * 2 / 4)
    + 1, 4)) = 3. The later tokens' pairs are dropped in both packages."""
    smoke = get_arch("jamba_1p5_large_398b").smoke.moe
    jcfg, tcfg, jp, tp = _moe_pair("f32", skew=True, n_experts=smoke.n_experts,
                                   top_k=smoke.top_k, capacity_factor=smoke.capacity_factor)
    jx, tx = _tokens(B, S, "f32", skew=True)
    experts = _check_moe(jcfg, tcfg, jp, tp, jx, tx, TOL32)
    assert set(np.unique(experts.numpy())) == {0, 1}
    got, full = mlp.moe_apply(tcfg, tp, tx), _dense(tcfg, tp, tx)
    kept = torch.isclose(got, full, rtol=1e-4, atol=1e-4).all(dim=-1).reshape(-1)
    C = 12 if S > 1 else 3
    assert kept[:C].all() and not kept[C:].any(), kept     # first C tokens keep both pairs
    assert torch.count_nonzero(got.reshape(-1, 32)[C:].abs().sum(-1)) == 0


def test_global_capacity_at_jamba_width_is_one_pair_per_expert():
    """At jamba's published MoE (E 16, top 2) and 4 decode slots,
    C = max(1, min(int(1.25 * 4 * 2 / 16) + 1, 4)) = 1: two slots that
    pick one expert lose a pair. Both packages drop the same pair."""
    full = get_arch("jamba_1p5_large_398b").model.moe
    jcfg, tcfg, jp, tp = _moe_pair("f32", n_experts=full.n_experts, top_k=full.top_k,
                                   capacity_factor=full.capacity_factor)
    dropped = 0
    for seed in range(6):
        jx, tx = _tokens(4, 1, "f32", skew=False, seed=seed)
        experts = _check_moe(jcfg, tcfg, jp, tp, jx, tx, TOL32)
        dropped += experts.numel() - len(np.unique(experts.numpy()))
    assert dropped > 0       # a collision happened and was dropped alike


def test_moe_init_shapes_and_the_nested_shared_group():
    _, tcfg = _configs("bf16", moe={**MOE, "shared_expert_ff": 16})
    p = mlp.moe_init(tcfg, torch.Generator().manual_seed(0))
    assert p["router"].dtype == torch.float32 and p["router"].shape == (32, 4)
    assert p["we_gate"].shape == (4, 32, 24) and p["we_down"].shape == (4, 24, 32)
    assert p["we_up"].dtype == torch.bfloat16
    assert set(p["shared"]) == {"w_gate", "w_up", "w_down"} and p["shared"]["w_up"].shape == (32, 16)
    # experts are drawn one by one, each at the scale 1/sqrt(fan_in)
    std = p["we_gate"].float().std(dim=(1, 2))
    assert torch.allclose(std, torch.full((4,), 32 ** -0.5), rtol=0.1)
    assert not torch.equal(p["we_gate"][0], p["we_gate"][1])


def test_jamba_configs_copy_the_jax_package():
    for which in ("model", "smoke"):
        j = getattr(j_get_arch("jamba_1p5_large_398b"), which)
        t = getattr(get_arch("jamba_1p5_large_398b"), which)
        for field in dataclasses.fields(t):
            a, b = getattr(t, field.name), getattr(j, field.name)
            if field.name in ("param_dtype", "compute_dtype"):
                assert str(a).split(".")[-1] == jnp.dtype(b).name, field.name
            elif dataclasses.is_dataclass(a):
                assert dataclasses.asdict(a) == dataclasses.asdict(b), field.name
            elif field.name == "pattern":
                assert [dataclasses.astuple(s) for s in a] == [dataclasses.astuple(s) for s in b]
            else:
                assert a == b, field.name
