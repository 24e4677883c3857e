"""The port's LM (``repro_torch.models``) against the JAX package's, on
the CPU, for the three served architectures at their smoke sizes.

The JAX ``lm_init`` parameters are carried across with
``repro_torch.bridge.lm_params_from_arrays``; both packages then run
``lm_prefill`` on the same prompt (numpy seed) and three
``lm_decode_step``s on the same tokens, and the last-token logits and
every layer's cache are compared after each. gemma3 smoke runs at
``max_len=48`` with prompts longer than its window of 8: its local
layers take the ring-cache path, its global layers the ``q_offset`` /
``kv_len`` path. jamba smoke (Mamba and attention mixers, dense and MoE
MLPs) checks the ``MambaState`` of its Mamba layers as well; its
prefill takes the per-row MoE dispatch, its decode the global one.

jamba smoke in bf16 is held to the JAX package run op by op
(``jax.disable_jit()``), where the two agree to the bit on logits and
to f32 rounding on the Mamba state. Under ``jit`` XLA keeps excess
precision inside its fusions (``xla_allow_excess_precision`` is on by
default), so the jitted JAX LM rounds the same bf16 program elsewhere;
the Mamba state, an f32 sum over bf16 inputs, carries those one-ulp
differences past 2 % (in norm) over four layers, with the same experts
chosen on both sides. Tolerances: f32 ``rtol=atol=2e-4``, bf16 ``2e-2`` (as
``tests/test_kernels.py``).
"""
import contextlib
import dataclasses
import gc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_arch as j_get_arch
from repro.models import lm as j_lm
from repro_torch.bridge import lm_params_from_arrays
from repro_torch.configs import get_arch
from repro_torch.models import lm

TOL32 = dict(rtol=2e-4, atol=2e-4)
TOL16 = dict(rtol=2e-2, atol=2e-2)
DTYPES = {"f32": (jnp.float32, torch.float32, TOL32), "bf16": (jnp.bfloat16, torch.bfloat16, TOL16)}
MAX_LEN = 48
# (arch, dtype) pairs whose JAX reference runs op by op (module docstring)
OP_BY_OP = {("jamba_1p5_large_398b", "bf16")}


def configs(name, dtype):
    jdt, tdt, _ = DTYPES[dtype]
    jcfg = dataclasses.replace(j_get_arch(name).smoke, param_dtype=jdt, compute_dtype=jdt)
    tcfg = dataclasses.replace(get_arch(name).smoke, param_dtype=tdt, compute_dtype=tdt)
    return jcfg, tcfg


def to_numpy(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module", autouse=True)
def release_jax_executables():
    """Free the worker's compiled JAX programs when the module starts and
    when it ends. Each holds memory maps of its own, and one pytest worker
    would otherwise reach the kernel's limit on them
    (``vm.max_map_count``, 65,530), where XLA's compiler aborts the
    process: the JAX package's own modules keep theirs (a worker measured
    32,361 maps after ``tests/test_fleet.py``), and a port module that
    compiles many programs adds ~32,000 more before its end
    (``test_torch_closed_loop.py``). A module that imports this fixture
    gets it too."""
    jax.clear_caches()
    gc.collect()
    yield
    jax.clear_caches()
    gc.collect()


@pytest.fixture(scope="module", params=[
    ("rwkv6_7b", "f32"), ("rwkv6_7b", "bf16"), ("gemma3_12b", "f32"), ("gemma3_12b", "bf16"),
    ("jamba_1p5_large_398b", "f32"), ("jamba_1p5_large_398b", "bf16"),
], ids=lambda p: "-".join(p))
def pair(request):
    name, dtype = request.param
    jcfg, tcfg = configs(name, dtype)
    jparams, _ = j_lm.lm_init(jcfg, jax.random.PRNGKey(0))
    tparams = lm_params_from_arrays(tcfg, to_numpy(jparams))
    return name, dtype, jcfg, tcfg, jparams, tparams


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()   # parameters require grad
    return np.asarray(x, np.float32)


def jax_layer_caches(jcfg, caches):
    """The JAX cache tree as one cache per layer (layer p*period + i is
    slice p of pattern position i; then the tail)."""
    out = [None] * jcfg.n_layers
    for i, stacked in enumerate(caches["periods"]):
        for p in range(jcfg.n_periods):
            out[p * jcfg.period + i] = type(stacked)(*(f[p] for f in stacked))
    for t, c in enumerate(caches["tail"]):
        out[jcfg.n_periods * jcfg.period + t] = c
    return out


def assert_caches_close(jcfg, jcaches, tcaches, tol, ctx):
    """Every layer's cache: elementwise at ``tol`` in f32; in bf16 each
    field's relative error in norm, ``|port - jax| <= 2e-2 |jax|``. A
    bf16 cache entry can sit on a cancellation (the residual ``x + tm``
    before the norm that feeds ``shift_c``), where one bf16 ulp of an
    operand the two frameworks round apart is a large share of the
    entry, so bf16 entries are not held one by one."""
    for layer, (jc, tc) in enumerate(zip(jax_layer_caches(jcfg, jcaches), tcaches)):
        assert type(jc)._fields == type(tc)._fields, (ctx, layer)
        for field, a, b in zip(tc._fields, jc, tc):
            assert tuple(a.shape) == tuple(b.shape), (ctx, layer, field)
            got, want = _f32(b), _f32(a)
            msg = f"{ctx} layer {layer} {field}"
            if tol is TOL16:
                err = float(np.linalg.norm(got - want))
                assert err <= TOL16["rtol"] * float(np.linalg.norm(want)) + 1e-6, (msg, err)
            else:
                np.testing.assert_allclose(got, want, err_msg=msg, **tol)


def test_params_carry_across(pair):
    name, dtype, jcfg, tcfg, jparams, tparams = pair
    assert len(tparams.layers) == tcfg.n_layers
    for i, block in enumerate(tparams.layers):
        assert block.spec == tcfg.layer_spec(i)
    n_jax = sum(x.size for x in jax.tree.leaves(jparams))
    assert sum(p.numel() for p in tparams.parameters()) == n_jax
    assert tparams.embed.dtype == DTYPES[dtype][1]


@pytest.mark.parametrize("B,S", [(2, 13)])
def test_prefill_and_decode_match_jax(pair, B, S):
    name, dtype, jcfg, tcfg, jparams, tparams = pair
    tol = DTYPES[dtype][2]
    rng = np.random.default_rng(B * 100 + S)
    toks = rng.integers(2, jcfg.vocab, (B, S)).astype(np.int32)
    reference = jax.disable_jit if (name, dtype) in OP_BY_OP else contextlib.nullcontext
    with reference():
        jl, jc = j_lm.lm_prefill(jcfg, jparams, {"tokens": jnp.asarray(toks)}, max_len=MAX_LEN)
    tl, tc = lm.lm_prefill(tcfg, tparams, {"tokens": torch.from_numpy(toks)}, max_len=MAX_LEN)
    assert tl.shape == (B, jcfg.vocab) and tl.dtype == DTYPES[dtype][1]
    np.testing.assert_allclose(_f32(tl), _f32(jl), **tol)
    assert_caches_close(jcfg, jc, tc, tol, "prefill")
    pos = S
    nxt = np.asarray(jnp.argmax(jl, axis=-1), np.int32)
    for step in range(3):
        with reference():
            jl, jc = j_lm.lm_decode_step(jcfg, jparams, jc, jnp.asarray(nxt), pos)
        tl, tc = lm.lm_decode_step(tcfg, tparams, tc, torch.from_numpy(nxt.copy()), pos)
        np.testing.assert_allclose(_f32(tl), _f32(jl), err_msg=f"decode {step}", **tol)
        assert_caches_close(jcfg, jc, tc, tol, f"decode {step}")
        nxt = np.asarray(jnp.argmax(jl, axis=-1), np.int32)
        pos += 1
