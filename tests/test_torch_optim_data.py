"""The training tools of the port against the JAX package, on the CPU:
the optimizers, the synthetic data, the failure tools and the
checkpoints.

* AdamW and Adafactor (``repro_torch.optim``), both state dtypes, over
  three steps of the same gradients through warmup, the cosine and the
  global-norm clip: parameters, moments and the gradient norm against
  the JAX package's eager update, f32 to ``rtol=1e-6``, bf16 to one bf16
  ulp. The two packages sum the squares of a leaf in different orders,
  so the clip scale can part by an ulp; a moment that cancels (``b1 m +
  (1 - b1) g`` near 0) then parts by more than 1e-6 of itself, so the
  f32 moments also take ``atol`` = 1e-6 of their leaf's largest
  magnitude.
* ``SyntheticLM.batch_at`` equal to the JAX package's bit for bit for
  the lm, vlm and audio families at several steps.
* ``FailureInjector``, ``StragglerMonitor`` and
  ``advise_checkpoint_cadence`` equal to the JAX package's.
* Checkpoints: a round trip with bf16 leaves restored bit for bit into
  the template's tensors, a stale ``.tmp`` never seen, keep-last-k, an
  async save whose snapshot is taken at the call, restore of the newest.
"""
import json
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from repro.data.pipeline import SyntheticLM as JSyntheticLM
from repro.optim import optimizers as j_opt
from repro.runtime import failures as j_fail
from repro_torch.checkpoint import CheckpointManager, latest_step, restore_checkpoint, save_checkpoint
from repro_torch.data import SyntheticLM, make_batch_iterator
from repro_torch.optim import OptConfig, OptState, make_optimizer
from repro_torch.runtime import FailureInjector, StragglerMonitor, advise_checkpoint_cadence
from test_torch_models import release_jax_executables  # noqa: F401 (autouse)

# shapes that meet both of Adafactor's branches: factored over the last
# two dims (with and without a leading axis) and not ("b"; "s" has a
# last-but-one dim of 1)
SHAPES = {"b": (6,), "e": (4, 3, 5), "s": (1, 7), "w": (8, 6)}
JDT = {"f32": jnp.float32, "bf16": jnp.bfloat16}
TDT = {"f32": torch.float32, "bf16": torch.bfloat16}


def _bf16_ulp(x: np.ndarray) -> np.ndarray:
    """One bf16 ulp at each |x| (8 significant bits)."""
    mag = np.maximum(np.abs(x.astype(np.float64)), np.finfo(np.float32).tiny)
    return 2.0 ** (np.floor(np.log2(mag)) - 7)


def _assert_close(got: torch.Tensor, want, dtype: str, what: str, leaf_atol: bool = False):
    got = got.to(torch.float32).numpy()
    want = np.asarray(want).astype(np.float32)
    if dtype == "f32":
        atol = 1e-6 * float(np.abs(want).max()) if leaf_atol else 0.0
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=atol, err_msg=what)
    else:
        assert np.all(np.abs(got - want) <= _bf16_ulp(want)), what


def _jax_state_leaves(name, state):
    if name == "adamw":
        return {f"{k}.{n}": v for k in ("m", "v") for n, v in state.inner[k].items()}
    return {f"{n}.{k}": v for n, d in state.inner.items() for k, v in d.items()}


def _port_state_leaves(name, state):
    if name == "adamw":
        return {f"{k}.{n}": v for k in ("m", "v") for n, v in state.inner[k].items()}
    return {f"{n}.{k}": v for n, d in state.inner.items() for k, v in d.items()}


@pytest.mark.parametrize("param_dtype", ["f32", "bf16"])
@pytest.mark.parametrize("state_dtype", ["f32", "bf16"])
@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_optimizers_match_jax(name, state_dtype, param_dtype):
    rng = np.random.default_rng(7)
    params = {n: rng.standard_normal(s).astype(np.float32) for n, s in SHAPES.items()}
    grads = [{n: (rng.standard_normal(s) * 0.6).astype(np.float32) for n, s in SHAPES.items()}
             for _ in range(3)]
    kw = dict(name=name, warmup_steps=2, total_steps=5, peak_lr=1e-2)
    jcfg = j_opt.OptConfig(**kw, state_dtype=JDT[state_dtype])
    tcfg = OptConfig(**kw, state_dtype=TDT[state_dtype])
    j_init, j_update = j_opt.make_optimizer(jcfg)
    t_init, t_update = make_optimizer(tcfg)
    jp = {n: jnp.asarray(p).astype(JDT[param_dtype]) for n, p in params.items()}
    tp = {n: torch.from_numpy(p).to(TDT[param_dtype]) for n, p in params.items()}
    js, ts = j_init(jcfg, jp), t_init(tcfg, tp)
    for i, g in enumerate(grads):
        jg = {n: jnp.asarray(x).astype(JDT[param_dtype]) for n, x in g.items()}
        tg = {n: torch.from_numpy(x).to(TDT[param_dtype]) for n, x in g.items()}
        jp, js, jnorm = j_update(jcfg, jg, js, jp)
        ts, tnorm = t_update(tcfg, tg, ts, tp)
        assert int(ts.step) == int(js.step) == i + 1
        np.testing.assert_allclose(float(tnorm), float(jnorm), rtol=1e-6)
        for n in SHAPES:
            _assert_close(tp[n], jp[n], param_dtype, f"step {i} param {n}")
        want = _jax_state_leaves(name, js)
        got = _port_state_leaves(name, ts)
        assert set(got) == set(want)
        for k in want:
            assert got[k].dtype == TDT[state_dtype] and tuple(got[k].shape) == want[k].shape
            _assert_close(got[k], want[k], state_dtype, f"step {i} state {k}", leaf_atol=True)
    assert float(jnorm) > 1.0   # the clip bound at least once


@pytest.mark.parametrize("step", [0, 3, 17])
@pytest.mark.parametrize("family", ["lm", "vlm", "audio"])
def test_synthetic_batches_equal_jax(family, step):
    kw = dict(vocab=300, seq_len=96, global_batch=3, seed=5, mean_doc_len=40, family=family,
              n_img_tokens=4 if family == "vlm" else 0, vit_dim=16)
    want = JSyntheticLM(**kw).batch_at(step)
    got = SyntheticLM(**kw).batch_at(step)
    assert set(got) == set(want)
    for key in want:
        assert got[key].dtype == want[key].dtype
        np.testing.assert_array_equal(got[key], want[key])
    batches = make_batch_iterator(SyntheticLM(**kw), start_step=step, device="cpu")
    first = next(batches)
    assert first["tokens"].dtype == torch.int32 and first["tokens"].device.type == "cpu"
    np.testing.assert_array_equal(first["tokens"].numpy(), want["tokens"])
    np.testing.assert_array_equal(next(batches)["tokens"].numpy(),
                                  JSyntheticLM(**kw).batch_at(step + 1)["tokens"])


@pytest.mark.parametrize("seed,mtbf,n", [(0, 200.0, 3), (4, 3.0, 5), (9, 1.0, 2)])
def test_failure_injector_equals_jax(seed, mtbf, n):
    got, want = FailureInjector(seed, mtbf, n), j_fail.FailureInjector(seed, mtbf, n)
    assert got.schedule == want.schedule
    assert [got.should_fail(s) for s in range(40)] == [want.should_fail(s) for s in range(40)]


def test_straggler_monitor_equals_jax():
    rng = np.random.default_rng(3)
    times = list(rng.gamma(4.0, 0.01, 60))
    times[10] = times[30] = 1.0
    got, want = StragglerMonitor(), j_fail.StragglerMonitor()
    assert [got.observe(s, t) for s, t in enumerate(times)] == [
        want.observe(s, t) for s, t in enumerate(times)]
    assert got.flagged == want.flagged and got.ewma == want.ewma and len(got.flagged) >= 2


@pytest.mark.parametrize("mtbf", [30.0, 300.0])
def test_checkpoint_cadence_equals_jax(mtbf):
    kw = dict(step_time_s=0.5, ckpt_write_s=2.0, restart_s=20.0, mtbf_steps=mtbf,
              horizon_steps=400, seed=2)
    assert advise_checkpoint_cadence(**kw) == j_fail.advise_checkpoint_cadence(**kw)


class _Tiny(nn.Module):
    def __init__(self, seed):
        super().__init__()
        g = torch.Generator().manual_seed(seed)
        self.w = nn.Parameter(torch.randn((5, 3), generator=g).to(torch.bfloat16))
        self.norm = nn.Parameter(torch.randn((3,), generator=g))


def _state(seed):
    g = torch.Generator().manual_seed(100 + seed)
    return {"model": _Tiny(seed),
            "opt": OptState(step=torch.tensor(seed, dtype=torch.int32),
                            inner={"m": {"w": torch.randn((5, 3), generator=g).to(torch.bfloat16)},
                                   "count": np.arange(4, dtype=np.int64)}),
            "lr": 0.5 * seed}


def _assert_state_equal(got, want):
    for a, b in zip(got["model"].parameters(), want["model"].parameters()):
        assert a.dtype == b.dtype
        bits = torch.int16 if a.dtype == torch.bfloat16 else torch.int32
        assert torch.equal(a.detach().view(bits), b.detach().view(bits))   # NaN too
    assert torch.equal(got["opt"].step, want["opt"].step)
    m_got, m_want = got["opt"].inner["m"]["w"], want["opt"].inner["m"]["w"]
    assert m_got.dtype == torch.bfloat16 and torch.equal(m_got.view(torch.int16),
                                                         m_want.view(torch.int16))
    np.testing.assert_array_equal(got["opt"].inner["count"], want["opt"].inner["count"])
    assert got["lr"] == want["lr"]


def test_checkpoint_round_trip_keeps_bf16_bits(tmp_path):
    state = _state(3)
    state["model"].w.data[0, 0] = torch.tensor(float("nan"), dtype=torch.bfloat16)
    path = save_checkpoint(state, tmp_path, 7, extra={"note": "x"})
    assert path.name == "step_00000007" and latest_step(tmp_path) == 7
    manifest = json.loads((path / "manifest.json").read_text())
    dtypes = {e["path"]: e["dtype"] for e in manifest["leaves"]}
    assert dtypes["['model'].w"] == "bfloat16" and dtypes["['model'].norm"] == "float32"
    template = _state(0)
    restored, manifest = restore_checkpoint(tmp_path, template)
    assert manifest["step"] == 7 and manifest["extra"] == {"note": "x"}
    assert restored["model"] is template["model"]         # written in place
    _assert_state_equal(restored, state)
    with pytest.raises(ValueError, match="template"):
        restore_checkpoint(tmp_path, {"model": _Tiny(0), "opt": OptState(
            step=torch.zeros((2,), dtype=torch.int32), inner=template["opt"].inner), "lr": 0.0})


def test_stale_tmp_is_never_seen_and_gc_keeps_the_newest(tmp_path):
    (tmp_path / "step_00000009.tmp").mkdir(parents=True)
    assert latest_step(tmp_path) is None
    with pytest.raises(FileNotFoundError):
        restore_checkpoint(tmp_path, _state(0))
    mgr = CheckpointManager(tmp_path, keep=2)
    for step in range(5):
        mgr.save(_state(step), step)
    names = sorted(p.name for p in pathlib.Path(tmp_path).iterdir())
    assert names == ["step_00000003", "step_00000004", "step_00000009.tmp"]
    restored, manifest = mgr.restore(_state(0))
    assert manifest["step"] == 4
    _assert_state_equal(restored, _state(4))


def test_async_save_snapshots_at_the_call(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=3)
    state = _state(2)
    want = _state(2)
    mgr.async_save(state, 11)
    with torch.no_grad():   # training goes on while the thread writes
        state["model"].w.add_(1.0)
    mgr.wait()
    assert mgr.latest_step() == 11
    assert not list(pathlib.Path(tmp_path).glob("*.tmp"))
    restored, _ = restore_checkpoint(tmp_path, _state(0), step=11)
    _assert_state_equal(restored, want)
