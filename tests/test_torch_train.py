"""Training in the port against the JAX package, on the CPU.

* The attention backward: gradients through ``flash_attention`` (the
  port's ``flash_attention_fwd_lse_ref`` and ``flash_attention_bwd_ref``
  behind its ``autograd.Function``) against ``jax.vjp`` of the JAX
  ``flash_attention_ref`` (its custom VJP), and the forward's ``lse``
  against ``_forward_with_lse``, in f32 to ``rtol=1e-5, atol=1e-6``:
  causal GQA, a window, not causal, Sq 5 against 17 keys, and a ragged
  key count past one block of 1,024. Through the cache path
  (``q_offset``, ``kv_len``) against ``jax.vjp`` of the JAX package's
  scan, rows that see no key included.
* ``loss_fn`` and its gradients for every smoke config, on the same
  parameters (drawn by the port's init and carried to the JAX tree) and
  the same numpy-seeded batch (a ``loss_mask`` for the decoder-only
  families, two ``vocab_chunk`` chunks): in f32 the loss to
  ``rtol=1e-5`` and every gradient leaf to ``|diff| <= 1e-4 |g| + 1e-7``
  (Frobenius norms); rwkv6_7b and jamba train through the plain scans.
  One exception: rwkv6's bonus ``u`` (``U_TOL``), a sum of products
  that cancel, where the JAX package's jitted and op-by-op gradients part
  by 8.4e-5 of |g| and the port lies 1.1e-4 from the op-by-op one and
  1.9e-4 from the jitted one.
  In bf16 the loss to 1e-2 and the global gradient norm to 5e-2, on a
  dense GQA model with windows, an MoE and the encoder-decoder
  (``BF16_ARCHS``): each case compiles a JAX gradient (2-7 s), and the
  two files keep to 90 s in one worker. rwkv6_7b's jitted bf16 gradient
  norm parts from the JAX package's own op-by-op run by 9 % (the port is
  within 0.3 % of the latter), and the op-by-op run takes ~30 s.
* One ``make_train_step`` step with ``microbatches=2`` (AdamW with f32
  state; Adafactor with bf16 state and an MoE): loss and gradient norm
  to 1e-4, parameters to ``atol = 2 lr`` (a gradient near zero may flip
  AdamW's sign).
* ``run_training`` with an injected failure and checkpoints every 2
  steps equal, loss for loss and bit for bit, to an uninterrupted run.
* ``python -m repro_torch.launch.train --device cpu --steps 3`` prints
  the JAX launcher's JSON keys.

The JAX side runs jitted (``cfg`` static): eager JAX retraces its scans
per call.
"""
import copy
import dataclasses
import gc
import io
import json
import sys
from contextlib import redirect_stdout

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_arch as j_get_arch
from repro.configs.registry import list_archs as j_list_archs
from repro.kernels.flash_attention import ref as j_flash
from repro.launch import train as j_train_cli
from repro.launch.lowering import opt_config as j_opt_config
from repro.optim import optimizers as j_opt
from repro.runtime import steps as j_steps
from repro.runtime.train_loop import TrainResult as JTrainResult
from repro_torch.bridge import named_from_tree, opt_state_from_arrays, params_into_arrays
from repro_torch.configs import get_arch
from repro_torch.kernels.flash_attention import flash_attention, flash_attention_fwd_lse_ref
from repro_torch.kernels.flash_attention.ref import _visible, first_dead_row
from repro_torch.launch import train as train_cli
from repro_torch.optim import global_norm
from repro_torch.runtime import (
    FailureInjector,
    TrainState,
    loss_fn,
    make_train_step,
    model_init,
    opt_config,
    run_training,
)
from test_torch_models import DTYPES, release_jax_executables, to_numpy  # noqa: F401 (autouse)

@pytest.fixture
def release_jax_after_test():
    """A test that compiles a whole model's gradient (its config is
    static) frees it at once: no later test reuses it, and a worker that
    runs this module beside other JAX modules stays far from the kernel's
    limit on memory maps (``release_jax_executables`` frees the rest at
    the module's end)."""
    yield
    jax.clear_caches()
    gc.collect()


# ---------------------------------------------------------------------------
# the attention backward
# ---------------------------------------------------------------------------
FLASH_CASES = [
    # B, Sq, Skv, H, KV, D, causal, window
    (2, 24, 24, 4, 2, 16, True, 0),        # causal GQA
    (1, 40, 40, 4, 2, 8, True, 8),         # sliding window
    (2, 20, 20, 2, 2, 8, False, 0),        # not causal
    (2, 5, 17, 4, 1, 8, False, 0),         # Sq 5 against 17 keys (cross-attention)
    (1, 1100, 1100, 2, 1, 8, True, 0),     # ragged keys past one block of 1,024
]


@pytest.mark.parametrize("case", FLASH_CASES, ids=str)
def test_flash_backward_matches_jax_vjp(case):
    B, Sq, Skv, H, KV, D, causal, window = case
    rng = np.random.default_rng(Sq + D)
    q, k, v, dout = (rng.standard_normal(s).astype(np.float32)
                     for s in ((B, Sq, H, D), (B, Skv, KV, D), (B, Skv, KV, D), (B, Sq, H, D)))
    out, vjp = jax.vjp(lambda *a: j_flash.flash_attention_ref(*a, causal=causal, window=window),
                       q, k, v)
    want = (out, *vjp(dout))
    _, want_lse = j_flash._forward_with_lse(q, k, v, causal, window, min(1024, Skv))
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    got = flash_attention(*leaves, causal=causal, window=window)
    got.backward(torch.from_numpy(dout))
    _, got_lse = flash_attention_fwd_lse_ref(*(x.detach() for x in leaves), causal=causal,
                                             window=window)
    for name, a, b in zip(("out", "dq", "dk", "dv", "lse"),
                          (got.detach(), *(x.grad for x in leaves), got_lse), (*want, want_lse)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-6, err_msg=name)


# the cache path (item 18): B, Sq, Skv, H, KV, D, causal, window, q_offset, kv_len
FLASH_CACHE_CASES = [
    (1, 8, 24, 4, 2, 8, True, 0, 16, None),      # causal with an offset
    (2, 6, 20, 2, 1, 8, True, 0, 10, 16),        # kv_len < Skv
    (2, 5, 12, 2, 2, 8, False, 0, 0, 9),         # kv_len < Skv, not causal
    (1, 10, 32, 4, 2, 8, True, 6, 20, 30),       # a window with an offset
    (1, 6, 16, 2, 1, 8, True, 4, 10, 12),        # its last row sees no key (position 15)
    (1, 3, 8, 2, 2, 8, False, 0, 0, 0),          # kv_len 0: no row sees a key
    (1, 3, 1100, 2, 1, 8, True, 2, 1098, 1099),  # a row that sees none, L = 2,048 padded slots
]


@pytest.mark.parametrize("case", FLASH_CACHE_CASES, ids=str)
def test_flash_backward_through_the_cache_path_matches_jax_vjp(case):
    """out, dq, dk and dv through ``flash_attention(q_offset=, kv_len=)``
    against ``jax.vjp`` of the JAX package's scan: rows that see no key are
    its uniform average over the padded key slots, and get its gradients."""
    B, Sq, Skv, H, KV, D, causal, window, q_offset, kv_len = case
    rng = np.random.default_rng(Sq * 31 + Skv)
    q, k, v, dout = (rng.standard_normal(s).astype(np.float32)
                     for s in ((B, Sq, H, D), (B, Skv, KV, D), (B, Skv, KV, D), (B, Sq, H, D)))
    kw = dict(causal=causal, window=window, q_offset=q_offset, kv_len=kv_len)
    out, vjp = jax.vjp(lambda *a: j_flash.flash_attention_ref(*a, **kw), q, k, v)
    want = (out, *vjp(dout))
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    got = flash_attention(*leaves, **kw)
    got.backward(torch.from_numpy(dout))
    for name, a, b in zip(("out", "dq", "dk", "dv"), (got.detach(), *(x.grad for x in leaves)),
                          want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-6, err_msg=name)


@pytest.mark.parametrize("window", [0, 1, 5])
@pytest.mark.parametrize("causal", [True, False])
def test_first_dead_row_is_the_first_row_without_a_visible_key(causal, window):
    """The kernels' host-side count of rows that see no key against the
    plain version's mask, over offsets and key counts."""
    Sq, Skv = 12, 20
    for q_offset in range(0, 24, 3):
        for kv_len in range(0, Skv + 1):
            q_pos = q_offset + torch.arange(Sq)
            seen = _visible(q_pos, torch.arange(Skv), causal, window, kv_len).any(dim=1)
            dead = [i for i in range(Sq) if not seen[i]]
            first = first_dead_row(Sq, window, q_offset, kv_len)
            assert dead == list(range(first, Sq)), (q_offset, kv_len, dead, first)


@pytest.mark.parametrize("case", [c for c in FLASH_CACHE_CASES if c[-1] is not None], ids=str)
def test_flash_forward_without_grad_matches_jax_on_rows_that_see_no_key(case):
    """The plain forward that serving runs (no grad) walks whole key blocks
    as the JAX package's scan does: a row that sees no key is the mean of
    V over the padded key slots (2,048 at 1,100 keys), equal to the JAX
    package's and to the training forward's."""
    B, Sq, Skv, H, KV, D, causal, window, q_offset, kv_len = case
    rng = np.random.default_rng(Sq * 17 + Skv)
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((B, Sq, H, D), (B, Skv, KV, D), (B, Skv, KV, D)))
    kw = dict(causal=causal, window=window, q_offset=q_offset, kv_len=kv_len)
    want = np.asarray(j_flash.flash_attention_ref(q, k, v, **kw))
    with torch.no_grad():
        got = flash_attention(*(torch.from_numpy(x) for x in (q, k, v)), **kw)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    trained, _ = flash_attention_fwd_lse_ref(*(torch.from_numpy(x) for x in (q, k, v)), **kw)
    assert torch.equal(got, trained)


def test_flash_cache_path_without_grad_serves():
    q = torch.zeros((1, 4, 2, 8), requires_grad=True)
    with torch.no_grad():   # serving takes that path without grad
        assert flash_attention(q, q, q, q_offset=2, kv_len=4).shape == q.shape


# ---------------------------------------------------------------------------
# the losses and their gradients, every smoke config
# ---------------------------------------------------------------------------
ARCHS = sorted(j_list_archs())
BF16_ARCHS = ["gemma3_12b", "llama4_maverick_400b_a17b", "whisper_small"]
U_TOL = 4e-4   # rwkv6's bonus u (module docstring)
B, S, CHUNK = 2, 32, 16


def _init(cfg, key):
    return j_steps.model_init(cfg, key)[0]


J_LOSS_AND_GRAD = jax.jit(
    jax.value_and_grad(lambda p, b, cfg: j_steps.loss_fn(cfg, p, b, vocab_chunk=CHUNK)),
    static_argnums=2)


def _jax_tree(jcfg, tcfg, tparams):
    """The port's parameters as the JAX package's parameter tree, so that
    no JAX init is compiled."""
    shapes = jax.eval_shape(lambda k: _init(jcfg, k), jax.random.PRNGKey(0))
    return params_into_arrays(tcfg, tparams,
                              jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes))


def _batch(cfg, rng, batch=B):
    out = {"tokens": rng.integers(0, cfg.vocab, (batch, S)).astype(np.int32)}
    if cfg.family == "audio":
        out["frontend_embeds"] = rng.standard_normal((batch, 48, 1024)).astype(np.float32)
    else:
        out["loss_mask"] = (rng.random((batch, S)) < 0.8).astype(np.float32)
    if cfg.family == "vlm":
        out["frontend_embeds"] = rng.standard_normal(
            (batch, cfg.n_img_tokens, 1024)).astype(np.float32)
    return out


def _tensors(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@pytest.fixture(scope="module")
def models():
    """Per (arch, dtype): (jcfg, tcfg, the JAX parameter tree as numpy,
    the port's parameters), both drawn by the port's ``model_init`` (seed
    0) and carried to the JAX side by ``_jax_tree``."""
    made = {}

    def get(name, dtype):
        if (name, dtype) not in made:
            jdt, tdt, _ = DTYPES[dtype]
            jcfg = dataclasses.replace(j_get_arch(name).smoke, param_dtype=jdt, compute_dtype=jdt)
            tcfg = dataclasses.replace(get_arch(name).smoke, param_dtype=tdt, compute_dtype=tdt)
            tparams = model_init(tcfg, 0, device="cpu")
            made[name, dtype] = jcfg, tcfg, _jax_tree(jcfg, tcfg, tparams), tparams
        return made[name, dtype]

    return get


def _f32(x):
    return np.asarray(x.detach().to(torch.float32) if isinstance(x, torch.Tensor) else x,
                      dtype=np.float32)


@pytest.mark.parametrize("name,dtype", [(n, "f32") for n in ARCHS]
                         + [(n, "bf16") for n in BF16_ARCHS])
def test_loss_and_grads_match_jax(models, name, dtype, release_jax_after_test):
    jcfg, tcfg, jparams, tparams = models(name, dtype)
    batch = _batch(jcfg, np.random.default_rng(len(name)))
    jloss, jgrads = J_LOSS_AND_GRAD(jparams, batch, jcfg)
    named = dict(tparams.named_parameters())
    loss = loss_fn(tcfg, tparams, _tensors(batch), vocab_chunk=CHUNK)
    grads = dict(zip(named, torch.autograd.grad(loss, list(named.values()))))
    want = named_from_tree(tcfg, tparams, to_numpy(jgrads))
    assert set(want) == set(grads)
    for n, g in grads.items():
        assert g.dtype == named[n].dtype and g.shape == named[n].shape, n
    if dtype == "f32":
        np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
        for n, g in grads.items():
            diff = np.linalg.norm(_f32(g) - _f32(want[n]))
            rtol = U_TOL if n.endswith("rwkv.u") else 1e-4
            assert diff <= rtol * np.linalg.norm(_f32(want[n])) + 1e-7, (n, diff)
    else:
        np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-2)
        np.testing.assert_allclose(float(global_norm(grads)), float(global_norm(want)),
                                   rtol=5e-2)


# ---------------------------------------------------------------------------
# one optimizer step with gradient accumulation
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", ["phi3_mini_3p8b", "arctic_480b"])
def test_train_step_with_microbatches_matches_jax(models, name, release_jax_after_test):
    jcfg, tcfg, jparams, tparams = models(name, "f32")
    tparams = copy.deepcopy(tparams)    # the step updates it in place
    arch, jarch = get_arch(name), j_get_arch(name)
    jocfg, tocfg = j_opt_config(jarch), opt_config(arch)
    assert (tocfg.name, str(tocfg.state_dtype).split(".")[-1]) == (
        jocfg.name, jnp.dtype(jocfg.state_dtype).name)
    assert dataclasses.astuple(dataclasses.replace(tocfg, state_dtype=None)) == \
        dataclasses.astuple(dataclasses.replace(jocfg, state_dtype=None))
    batch = _batch(jcfg, np.random.default_rng(3), batch=4)
    j_init_opt, _ = j_opt.make_optimizer(jocfg)
    jstate = j_steps.TrainState(params=jparams, opt=j_init_opt(jocfg, jparams))
    _, j_step = j_steps.make_train_step(jcfg, jocfg, microbatches=2)
    jnew, jm = jax.jit(j_step)(jstate, batch)

    topt = opt_state_from_arrays(tcfg, tparams, to_numpy(jstate.opt))
    _, t_step = make_train_step(tcfg, tocfg, microbatches=2, device="cpu")
    tnew, tm = t_step(TrainState(params=tparams, opt=topt), _tensors(batch))
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-4)
    np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-4)
    assert int(tm["step"]) == int(jm["step"]) == 1
    lr = float(j_opt.warmup_cosine(jocfg)(jnp.zeros((), jnp.int32)))
    want = named_from_tree(tcfg, tparams, to_numpy(jnew.params))
    moved = 0
    for n, p in tnew.params.named_parameters():
        np.testing.assert_allclose(_f32(p), _f32(want[n]), rtol=0, atol=2 * lr, err_msg=n)
        moved += int(not np.array_equal(_f32(p), _f32(named_from_tree(tcfg, tparams, jparams)[n])))
    assert moved > 0


# ---------------------------------------------------------------------------
# the train loop: restart from a checkpoint equals an uninterrupted run
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", ["phi3_mini_3p8b", "llama4_maverick_400b_a17b"])
def test_run_training_resumes_bit_equal(tmp_path, name):
    kw = dict(steps=6, global_batch=2, seq_len=16, device="cpu")
    plain, resumed = {}, []
    whole = run_training(get_arch(name), on_metrics=lambda s, m: plain.setdefault(s, m["loss"]),
                         **kw)
    injector = FailureInjector(seed=1, mtbf_steps=3.0, max_failures=1)
    assert 2 < injector.schedule[0] < 6      # after the first checkpoint (step 1)
    cut = run_training(get_arch(name), ckpt_dir=str(tmp_path), ckpt_every=2, injector=injector,
                       on_metrics=lambda s, m: resumed.append((s, m["loss"])), **kw)
    assert whole.restarts == 0 and cut.restarts == 1 and cut.steps_done == 6
    assert sorted({s for s, _ in resumed}) == list(range(6)) and len(resumed) > 6
    back = next(i for i in range(1, len(resumed)) if resumed[i][0] <= resumed[i - 1][0])
    assert resumed[back][0] > 0     # restored from a checkpoint, not drawn from the seed
    for s, loss in resumed:
        assert loss == plain[s], (s, loss, plain[s])
    for a, b in zip(whole.final_state.params.parameters(), cut.final_state.params.parameters()):
        assert torch.equal(a, b)


def test_train_cli_prints_the_jax_launchers_keys(monkeypatch):
    stub = JTrainResult(steps_done=3, losses=[1.0, 0.5], restarts=0, straggler_events=0,
                        final_state=None)
    monkeypatch.setattr(j_train_cli, "run_training", lambda *a, **kw: stub)
    monkeypatch.setattr(sys, "argv", ["train", "--arch", "phi3_mini_3p8b", "--steps", "3"])
    out = io.StringIO()
    with redirect_stdout(out):
        j_train_cli.main()
    want = json.loads(out.getvalue()[out.getvalue().index("{"):])

    out = io.StringIO()
    with redirect_stdout(out):
        train_cli.main(["--arch", "phi3_mini_3p8b", "--device", "cpu", "--steps", "3",
                        "--global-batch", "2", "--seq-len", "16"])
    text = out.getvalue()
    got = json.loads(text[text.index("{"):])
    assert set(got) == set(want)
    assert got["arch"] == "phi3_mini_3p8b" and got["steps_done"] == 3 and got["restarts"] == 0
    assert np.isfinite(got["first_loss"]) and np.isfinite(got["last_loss"])
    assert "step     0 loss" in text
