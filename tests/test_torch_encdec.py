"""The port's encoder-decoder (``repro_torch.models.encdec``) and serve
steps (``repro_torch.runtime.steps``) against the JAX package's, on the
CPU, at ``whisper_small``'s smoke size.

The JAX ``encdec_init`` parameters (one init, in f32; the bf16 case
casts them to the dtypes ``encdec_init`` gives in bf16) are carried
across with ``repro_torch.bridge.encdec_params_from_arrays``; both
packages then run ``encode``, ``encode_kv``, ``encdec_prefill`` (last
logits, every decoder layer's self-attention cache and cross K/V) and
three ``encdec_decode_step``s on the same numpy-seeded frames and
tokens (the JAX side jitted, ``cfg`` static). The encoder attends
without a causal mask over a frame count that is not a multiple of any
tile; the decoder's cross-attention goes through ``flash_attention``
at every step, one query against all frames.

Tolerances as ``tests/test_torch_models.py``: f32 ``rtol=atol=2e-4``;
bf16 ``2e-2``, caches in norm per field.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_arch as j_get_arch
from repro.models import attention as j_attention
from repro.models import encdec as j_ed
from repro.runtime import steps as j_steps
from repro_torch.bridge import encdec_params_from_arrays, lm_params_from_arrays
from repro_torch.configs import get_arch
from repro_torch.models import VIT_DIM, attention, encdec
from repro_torch.runtime import steps
from test_torch_models import (  # noqa: F401 (release_jax_executables: autouse)
    DTYPES, TOL16, TOL32, _f32, release_jax_executables, to_numpy,
)

NAME = "whisper_small"
B, S_ENC, S_DEC = 2, 40, 4

J_INIT = jax.jit(lambda cfg, key: j_ed.encdec_init(cfg, key)[0], static_argnums=0)
J_ENCODE = jax.jit(j_ed.encode, static_argnums=0)
J_PREFILL = jax.jit(j_ed.encdec_prefill, static_argnums=(0, 3))
J_DECODE = jax.jit(j_ed.encdec_decode_step, static_argnums=0)


@pytest.fixture(scope="module")
def whisper():
    made = {}

    def get(dtype):
        if dtype not in made:
            jdt, tdt, _ = DTYPES[dtype]
            jcfg = dataclasses.replace(j_get_arch(NAME).smoke, param_dtype=jdt, compute_dtype=jdt)
            tcfg = dataclasses.replace(get_arch(NAME).smoke, param_dtype=tdt, compute_dtype=tdt)
            if "init" not in made:
                made["init"] = J_INIT(dataclasses.replace(jcfg, param_dtype=jnp.float32,
                                                          compute_dtype=jnp.float32),
                                      jax.random.PRNGKey(0))
            shapes = jax.eval_shape(lambda k: j_ed.encdec_init(jcfg, k)[0], jax.random.PRNGKey(0))
            jparams = jax.tree.map(lambda x, s: x.astype(s.dtype), made["init"], shapes)
            made[dtype] = jcfg, tcfg, jparams, encdec_params_from_arrays(tcfg, to_numpy(jparams))
        return made[dtype]

    return get


def _inputs(vocab):
    rng = np.random.default_rng(11)
    frames = rng.standard_normal((B, S_ENC, VIT_DIM)).astype(np.float32)
    toks = rng.integers(2, vocab, (B, S_DEC)).astype(np.int32)
    return frames, toks


def _close(got, want, tol, msg):
    got, want = _f32(got), _f32(want)
    assert got.shape == want.shape, msg
    if tol is TOL16:
        err = float(np.linalg.norm(got - want))
        assert err <= TOL16["rtol"] * float(np.linalg.norm(want)) + 1e-6, (msg, err)
    else:
        np.testing.assert_allclose(got, want, err_msg=msg, **tol)


def _assert_caches_close(jcaches, tcaches, tol, ctx):
    """Each decoder layer's self-attention cache (slice ``i`` of the JAX
    package's stacked ``KVCache``) and cross K/V."""
    n = len(tcaches.self_kv)
    assert len(tcaches.cross_kv) == n == jcaches.self_kv.k.shape[0]
    for i in range(n):
        for field in ("k", "v"):
            _close(getattr(tcaches.self_kv[i], field), getattr(jcaches.self_kv, field)[i], tol,
                   f"{ctx} layer {i} self {field}")
        for j, field in enumerate(("k", "v")):
            _close(tcaches.cross_kv[i][j], jcaches.cross_kv[j][i], tol,
                   f"{ctx} layer {i} cross {field}")


@pytest.mark.parametrize("offset", [0, 7, 1499])
@pytest.mark.parametrize("S,d", [(1, 64), (40, 64), (5, 768), (3, 33)])
def test_sinusoidal_matches_jax(S, d, offset):
    got = encdec.sinusoidal(S, d, offset=offset)
    want = np.asarray(j_ed.sinusoidal(S, d, offset=offset))
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, **TOL32)


def test_dec_len_matches_jax():
    cfg, jcfg = get_arch(NAME).model, j_get_arch(NAME).model
    for s in (1, 8, 64, 511, 512, 513, 1500, 4096, 32768, 500_000):
        assert encdec.dec_len(cfg, s) == j_ed.dec_len(jcfg, s)
    assert encdec.dec_len(cfg, 1500) == 187 and encdec.dec_len(cfg, 32768) == 4096


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_params_carry_across(whisper, dtype):
    jcfg, tcfg, jparams, tparams = whisper(dtype)
    assert len(tparams.enc) == tcfg.n_enc_layers and len(tparams.dec) == tcfg.n_layers
    assert {n for n, _ in tparams.enc[0].named_children()} == {"attn", "mlp"}
    assert {n for n, _ in tparams.dec[0].named_children()} == {"self", "cross", "mlp"}
    assert sum(p.numel() for p in tparams.parameters()) == sum(
        x.size for x in jax.tree.leaves(jparams))
    np.testing.assert_array_equal(_f32(tparams.dec[1].cross["wk"]),
                                  _f32(jparams["dec"]["cross"]["wk"][1]))
    assert tparams.embed.dtype == DTYPES[dtype][1]


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_encode_and_encode_kv_match_jax(whisper, dtype):
    jcfg, tcfg, jparams, tparams = whisper(dtype)
    tol = DTYPES[dtype][2]
    frames, _ = _inputs(jcfg.vocab)
    jout = J_ENCODE(jcfg, jparams, jnp.asarray(frames))
    tout = encdec.encode(tcfg, tparams, torch.from_numpy(frames))
    assert tout.shape == (B, S_ENC, tcfg.d_model) and tout.dtype == DTYPES[dtype][1]
    _close(tout, jout, tol, "encode")
    layer = jax.tree.map(lambda x: x[0], jparams["dec"]["cross"])
    jk, jv = j_attention.encode_kv(jcfg, layer, jout)
    tk, tv = attention.encode_kv(tcfg, tparams.dec[0].cross, tout)
    _close(tk, jk, tol, "encode_kv k")
    _close(tv, jv, tol, "encode_kv v")


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_prefill_and_decode_match_jax(whisper, dtype):
    jcfg, tcfg, jparams, tparams = whisper(dtype)
    tol = DTYPES[dtype][2]
    frames, toks = _inputs(jcfg.vocab)
    max_dec = encdec.dec_len(tcfg, S_ENC)
    jl, jc = J_PREFILL(jcfg, jparams, {"tokens": jnp.asarray(toks),
                                       "frontend_embeds": jnp.asarray(frames)}, max_dec)
    tl, tc = encdec.encdec_prefill(tcfg, tparams, {"tokens": torch.from_numpy(toks),
                                                   "frontend_embeds": torch.from_numpy(frames)},
                                   max_dec=max_dec)
    assert tl.shape == (B, jcfg.vocab) and tl.dtype == torch.float32
    np.testing.assert_allclose(_f32(tl), _f32(jl), **tol)
    assert tc.self_kv[0].k.shape == (B, max_dec, tcfg.n_kv_heads, tcfg.hd)
    _assert_caches_close(jc, tc, tol, "prefill")
    pos = S_DEC
    nxt = np.asarray(jnp.argmax(jl, axis=-1), np.int32)
    for step in range(3):
        jl, jc = J_DECODE(jcfg, jparams, jc, jnp.asarray(nxt), pos)
        tl, tc = encdec.encdec_decode_step(tcfg, tparams, tc, torch.from_numpy(nxt.copy()), pos)
        np.testing.assert_allclose(_f32(tl), _f32(jl), err_msg=f"decode {step}", **tol)
        _assert_caches_close(jc, tc, tol, f"decode {step}")
        nxt = np.asarray(jnp.argmax(jl, axis=-1), np.int32)
        pos += 1


def test_make_serve_steps_serves_both_families(whisper):
    """The audio family's steps are ``encdec_prefill`` /
    ``encdec_decode_step``, the others' ``lm_prefill`` /
    ``lm_decode_step``: greedy tokens equal the JAX package's steps' in
    f32, on whisper and on internvl2_2b."""
    jcfg, tcfg, jparams, tparams = whisper("f32")
    frames, toks = _inputs(jcfg.vocab)
    vlm = get_arch("internvl2_2b").smoke
    jvlm = j_get_arch("internvl2_2b").smoke
    jvlm = dataclasses.replace(jvlm, param_dtype=jnp.float32, compute_dtype=jnp.float32)
    tvlm = dataclasses.replace(vlm, param_dtype=torch.float32, compute_dtype=torch.float32)
    jvp, _ = j_steps.model_init(jvlm, jax.random.PRNGKey(1))
    cases = [
        (jcfg, tcfg, jparams, tparams, {"frontend_embeds": frames, "tokens": toks},
         encdec.dec_len(tcfg, S_ENC)),
        (jvlm, tvlm, jvp, lm_params_from_arrays(tvlm, to_numpy(jvp)), {"tokens": toks}, 24),
    ]
    for jc_, tc_, jp, tp, batch, max_len in cases:
        jpre, jdec = j_steps.make_serve_steps(jc_)
        tpre, tdec = steps.make_serve_steps(tc_)
        jl, jcache = jpre(jp, {k: jnp.asarray(v) for k, v in batch.items()}, max_len)
        tl, tcache = tpre(tp, {k: torch.from_numpy(v) for k, v in batch.items()}, max_len)
        jtoks, ttoks = [], []
        for pos in range(S_DEC, S_DEC + 3):
            jn, tn = jnp.argmax(jl, axis=-1).astype(jnp.int32), torch.argmax(tl, dim=-1)
            jtoks.append(np.asarray(jn).tolist())
            ttoks.append(tn.tolist())
            jl, jcache = jdec(jp, jcache, jn, pos)
            tl, tcache = tdec(tp, tcache, tn.to(torch.int32), pos)
        assert ttoks == jtoks, tc_.name
        np.testing.assert_allclose(_f32(tl), _f32(jl), **TOL32)


def test_model_init_and_serve_caches():
    cfg = dataclasses.replace(get_arch(NAME).smoke, param_dtype=torch.float32,
                              compute_dtype=torch.float32)
    params = steps.model_init(cfg, 0, device="cpu")
    assert isinstance(params, encdec.EncDec) and params.device.type == "cpu"
    with pytest.raises(NotImplementedError, match="cross-KV"):
        steps.init_serve_caches(cfg, 2, 64, "cpu")
    with pytest.raises(NotImplementedError, match="cross-KV"):
        j_steps.init_serve_caches(j_get_arch(NAME).smoke, 2, 64)
    lm_cfg = get_arch("granite_34b").smoke
    caches = steps.init_serve_caches(lm_cfg, 2, 16, "cpu")
    assert len(caches) == lm_cfg.n_layers and caches[0].k.shape == (2, 16, 1, 16)
