"""The rest of the served zoo in the port against the JAX package, on the
CPU: the registry, ``pad_vocab``, and the five text configs and
``internvl2_2b`` at their smoke sizes.

* Every ``ArchSpec`` of the port equals the JAX package's, ``model`` and
  ``smoke``, field for field (dtypes by name; the port has no
  ``attn_impl``), and its training and sharding fields (``optimizer``,
  ``opt_state_dtype``, ``train_microbatches``, ``shapes``, ``skip``,
  ``rule_overrides``) and ``runnable_shapes()`` equal the JAX
  package's.
* ``gemma3_27b`` (local ring caches, global layers and a two-layer
  tail), ``granite_34b`` (MQA, non-gated GELU), ``phi3_mini_3p8b``
  (MHA), ``arctic_480b`` (``moe_dense``: the dense MLP beside the MoE),
  ``llama4_maverick_400b_a17b`` (dense and MoE layers with a shared
  expert) and ``internvl2_2b`` (with and without ``frontend_embeds``):
  the JAX ``lm_init`` parameters (one init per arch, cast to bf16 for
  the bf16 case) carried across by
  ``repro_torch.bridge.lm_params_from_arrays``, then ``lm_prefill`` and
  three ``lm_decode_step``s (jitted on the JAX side) on the same
  numpy-seeded tokens, the logits and every layer's cache compared
  after each.

Tolerances as ``tests/test_torch_models.py``: f32 ``rtol=atol=2e-4``;
bf16 ``2e-2``, caches in norm per field. Every case holds to the jitted
JAX run; none needs ``jax.disable_jit()``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_arch as j_get_arch
from repro.configs.registry import list_archs as j_list_archs
from repro.configs.registry import pad_vocab as j_pad_vocab
from repro.models import lm as j_lm
from repro_torch.bridge import lm_params_from_arrays
from repro_torch.configs import get_arch, list_archs, pad_vocab
from repro_torch.models import VIT_DIM, lm
from test_torch_models import (  # noqa: F401 (release_jax_executables: autouse)
    DTYPES, MAX_LEN, _f32, assert_caches_close, release_jax_executables, to_numpy,
)

TEXT_ARCHS = ["gemma3_27b", "granite_34b", "phi3_mini_3p8b", "arctic_480b",
              "llama4_maverick_400b_a17b", "internvl2_2b"]


@pytest.mark.parametrize("name", sorted(j_list_archs()))
def test_arch_specs_copy_the_jax_package(name):
    assert name in list_archs()
    for which in ("model", "smoke"):
        j = getattr(j_get_arch(name), which)
        t = getattr(get_arch(name), which)
        jfields = {f.name for f in dataclasses.fields(j)}
        tfields = {f.name for f in dataclasses.fields(t)}
        assert jfields - tfields == {"attn_impl"}
        assert tfields <= jfields
        for field in dataclasses.fields(t):
            a, b = getattr(t, field.name), getattr(j, field.name)
            if field.name in ("param_dtype", "compute_dtype"):
                assert str(a).split(".")[-1] == jnp.dtype(b).name, field.name
            elif dataclasses.is_dataclass(a):
                assert dataclasses.asdict(a) == dataclasses.asdict(b), field.name
            elif field.name == "pattern":
                assert [dataclasses.astuple(s) for s in a] == [dataclasses.astuple(s) for s in b]
            else:
                assert a == b, (which, field.name)
    for field in ("optimizer", "opt_state_dtype", "train_microbatches", "shapes", "skip",
                  "rule_overrides"):
        assert getattr(get_arch(name), field) == getattr(j_get_arch(name), field), field
    assert get_arch(name).runnable_shapes() == j_get_arch(name).runnable_shapes()


def test_pad_vocab_matches_jax():
    for v in [1, 255, 256, 257, 32000, 32064, 51865, 92553, 202048, *range(0, 2000, 37)]:
        for multiple in (1, 8, 128, 256):
            assert pad_vocab(v, multiple) == j_pad_vocab(v, multiple), (v, multiple)
    assert pad_vocab(32000) == 32000 and get_arch("arctic_480b").model.vocab == 32000


CASES = [(n, d) for n in TEXT_ARCHS for d in ("f32", "bf16")]
IDS = ["-".join(c) for c in CASES]


# the JAX entry points, compiled once per config (``cfg`` is static)
J_INIT = jax.jit(lambda cfg, key: j_lm.lm_init(cfg, key)[0], static_argnums=0)
J_PREFILL = jax.jit(j_lm.lm_prefill, static_argnums=0, static_argnames=("max_len",))
J_DECODE = jax.jit(j_lm.lm_decode_step, static_argnums=0)


@pytest.fixture(scope="module")
def zoo():
    """One JAX init per arch and module, in f32; the bf16 case casts it
    to the dtypes that ``lm_init`` gives in bf16 (``jax.eval_shape``).
    Both packages run on the same parameters."""
    made, inits = {}, {}

    def get(name, dtype):
        if (name, dtype) not in made:
            jdt, tdt, _ = DTYPES[dtype]
            jcfg = dataclasses.replace(j_get_arch(name).smoke, param_dtype=jdt, compute_dtype=jdt)
            tcfg = dataclasses.replace(get_arch(name).smoke, param_dtype=tdt, compute_dtype=tdt)
            if name not in inits:
                inits[name] = J_INIT(dataclasses.replace(jcfg, param_dtype=jnp.float32,
                                                         compute_dtype=jnp.float32),
                                     jax.random.PRNGKey(0))
            shapes = jax.eval_shape(lambda k: j_lm.lm_init(jcfg, k)[0], jax.random.PRNGKey(0))
            jparams = jax.tree.map(lambda x, s: x.astype(s.dtype), inits[name], shapes)
            made[name, dtype] = jcfg, tcfg, jparams, lm_params_from_arrays(tcfg, to_numpy(jparams))
        return made[name, dtype]

    return get


@pytest.mark.parametrize("name,dtype", CASES, ids=IDS)
def test_params_carry_across(zoo, name, dtype):
    jcfg, tcfg, jparams, tparams = zoo(name, dtype)
    assert len(tparams.layers) == tcfg.n_layers
    for i, block in enumerate(tparams.layers):
        assert block.spec == tcfg.layer_spec(i)
    assert sum(p.numel() for p in tparams.parameters()) == sum(
        x.size for x in jax.tree.leaves(jparams))
    if tcfg.family == "vlm":
        assert tparams.frontend_proj.shape == (VIT_DIM, tcfg.d_model)
        np.testing.assert_array_equal(_f32(tparams.frontend_proj), _f32(jparams["frontend_proj"]))
    else:
        assert tparams.frontend_proj is None


def _prefill_and_decode(zoo, name, dtype, frontend):
    jcfg, tcfg, jparams, tparams = zoo(name, dtype)
    tol = DTYPES[dtype][2]
    B, S = 2, 13
    rng = np.random.default_rng(7)
    toks = rng.integers(2, jcfg.vocab, (B, S)).astype(np.int32)
    jbatch, tbatch = {"tokens": jnp.asarray(toks)}, {"tokens": torch.from_numpy(toks)}
    if frontend:
        fe = rng.standard_normal((B, jcfg.n_img_tokens, VIT_DIM)).astype(np.float32)
        jbatch["frontend_embeds"] = jnp.asarray(fe)
        tbatch["frontend_embeds"] = torch.from_numpy(fe)
    jl, jc = J_PREFILL(jcfg, jparams, jbatch, max_len=MAX_LEN)
    tl, tc = lm.lm_prefill(tcfg, tparams, tbatch, max_len=MAX_LEN)
    assert tl.shape == (B, jcfg.vocab) and tl.dtype == DTYPES[dtype][1]
    np.testing.assert_allclose(_f32(tl), _f32(jl), **tol)
    assert_caches_close(jcfg, jc, tc, tol, "prefill")
    if frontend:
        # the patch embeddings take the first n_img positions: the logits
        # move with them
        plain, _ = lm.lm_prefill(tcfg, tparams, {"tokens": torch.from_numpy(toks)}, max_len=MAX_LEN)
        assert not torch.equal(plain, tl)
    pos = S
    nxt = np.asarray(jnp.argmax(jl, axis=-1), np.int32)
    for step in range(3):
        jl, jc = J_DECODE(jcfg, jparams, jc, jnp.asarray(nxt), pos)
        tl, tc = lm.lm_decode_step(tcfg, tparams, tc, torch.from_numpy(nxt.copy()), pos)
        np.testing.assert_allclose(_f32(tl), _f32(jl), err_msg=f"decode {step}", **tol)
        assert_caches_close(jcfg, jc, tc, tol, f"decode {step}")
        nxt = np.asarray(jnp.argmax(jl, axis=-1), np.int32)
        pos += 1


@pytest.mark.parametrize("name,dtype", CASES, ids=IDS)
def test_prefill_and_decode_match_jax(zoo, name, dtype):
    _prefill_and_decode(zoo, name, dtype, frontend=False)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_frontend_embeds_match_jax(zoo, dtype):
    _prefill_and_decode(zoo, "internvl2_2b", dtype, frontend=True)
