"""The port's serving path against the JAX package's, on the CPU.

* ``requests_to_pipelines`` + ``workload_from_pipelines``: the packed
  arrays equal the JAX package's exactly.
* ``evaluate_policies``: each policy's summary equals the JAX package's
  under the comparison contract of ``PERF.md`` §2 (counts and latencies
  exact; utilisation and cost, sums taken in another order, to rtol
  1e-5), and ``pick_policy`` picks the same policy.
* ``ContinuousBatcher`` in f32 on the three smoke models (parameters carried
  across from the JAX ``lm_init``) gives the JAX package's tokens, with
  one slot, and with two slots where an interactive request preempts a
  batch one. The two-slot case serves prompts of different lengths, so
  on gemma3 it pins the JAX package's decode position ``max(pos)``
  (``repro/serving/batching.py:137``, ROADMAP queue 3), which the port
  mirrors.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_arch as j_get_arch
from repro.core.workload import workload_from_pipelines as j_workload_from_pipelines
from repro.core import SimParams as JParams
from repro.models import lm as j_lm
from repro.serving import batching as j_batching
from repro.serving import bridge as j_bridge
from repro_torch import SimParams
from repro_torch.bridge import lm_params_from_arrays
from repro_torch.configs import get_arch
from repro_torch.core import workload_from_pipelines
from repro_torch.serving import batching, bridge

TOLERANT_KEYS = {"cpu_utilization", "ram_utilization", "cost_dollars"}


def _trace(n=16, seed=0):
    rng = np.random.default_rng(seed)
    return [
        dict(arrival_s=float(i * 0.15), prompt_tokens=int(rng.integers(32, 256)),
             new_tokens=32, interactive=bool(i % 2))
        for i in range(n)
    ]


def test_pipelines_and_workload_arrays_equal_jax():
    trace = _trace()
    jcfg, tcfg = j_get_arch("gemma3_12b").model, get_arch("gemma3_12b").model
    jp = j_bridge.requests_to_pipelines([j_bridge.ServeRequest(**r) for r in trace], jcfg)
    tp = bridge.requests_to_pipelines([bridge.ServeRequest(**r) for r in trace], tcfg)
    for a, b in zip(jp, tp):
        assert (a.pid, int(a.priority), a.arrival_tick) == (b.pid, int(b.priority), b.arrival_tick)
        assert [dataclasses.astuple(o) for o in a.ops] == [dataclasses.astuple(o) for o in b.ops]
    kw = dict(duration=20.0, max_pipelines=64, max_containers=128)
    jw = j_workload_from_pipelines(jp, JParams(**kw))
    tw = workload_from_pipelines(tp, SimParams(**kw))
    for name in tw._fields[:10]:
        want = np.asarray(getattr(jw, name))
        got = getattr(tw, name)[0].numpy()
        assert got.dtype == want.dtype and np.array_equal(got, want), name


def _assert_summary_equal(got: dict, want: dict, ctx: str):
    assert set(got) == set(want), (ctx, set(got) ^ set(want))
    for key, w in want.items():
        g = got[key]
        if isinstance(w, dict):
            _assert_summary_equal(g, w, f"{ctx}.{key}")
        elif key in TOLERANT_KEYS:
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=0, err_msg=f"{ctx}.{key}")
        else:
            assert g == w or (g != g and w != w), (ctx, key, g, w)


def test_evaluate_policies_and_pick_match_jax():
    trace = _trace()
    jres = j_bridge.evaluate_policies([j_bridge.ServeRequest(**r) for r in trace],
                                      j_get_arch("gemma3_12b").model, duration_s=20.0)
    tres = bridge.evaluate_policies([bridge.ServeRequest(**r) for r in trace],
                                    get_arch("gemma3_12b").model, duration_s=20.0, device="cpu")
    assert set(tres) == set(jres) == {"naive", "priority", "priority_pool"}
    for policy in jres:
        assert tres[policy]["submitted"] == 16
        _assert_summary_equal(tres[policy], jres[policy], policy)
    assert bridge.pick_policy(tres) == j_bridge.pick_policy(jres)


@pytest.fixture(scope="module", params=["rwkv6_7b", "gemma3_12b", "jamba_1p5_large_398b"])
def models(request):
    name = request.param
    jcfg = dataclasses.replace(j_get_arch(name).smoke, param_dtype=jnp.float32,
                               compute_dtype=jnp.float32)
    tcfg = dataclasses.replace(get_arch(name).smoke, param_dtype=torch.float32,
                               compute_dtype=torch.float32)
    jparams, _ = j_lm.lm_init(jcfg, jax.random.PRNGKey(0))
    tparams = lm_params_from_arrays(tcfg, jax.tree.map(np.asarray, jparams))
    return jcfg, tcfg, jparams, tparams


def _serve(module, cfg, params, slots, plan):
    """Serve ``plan``: a list of rounds, each a list of (rid, prompt,
    interactive) submitted before one ``step``; then run to completion.
    Returns (rid, tokens) per finished request, in finishing order."""
    b = module.ContinuousBatcher(cfg, params, slots=slots, max_len=48, policy="priority")
    for round_ in plan:
        for rid, prompt, interactive in round_:
            b.submit(module.Request(rid=rid, tokens=prompt.copy(), max_new=5,
                                    interactive=interactive))
        b.step()
    return [(r.rid, list(r.out)) for r in b.run_to_completion()]


def _prompt(seed, n):
    return np.random.default_rng(seed).integers(2, 512, n).astype(np.int32)


@pytest.mark.parametrize("case", ["one_slot", "two_slots_preempt"])
def test_batcher_tokens_match_jax(models, case):
    jcfg, tcfg, jparams, tparams = models
    if case == "one_slot":
        slots = 1
        plan = [[(0, _prompt(0, 11), True), (1, _prompt(1, 9), True)]]
    else:
        # two batch requests fill both slots; an interactive one arrives
        # and preempts the later batch slot, which is requeued
        slots = 2
        plan = [[(0, _prompt(2, 9), False), (1, _prompt(3, 14), False)],
                [(2, _prompt(4, 12), True)]]
    want = _serve(j_batching, jcfg, jparams, slots, plan)
    got = _serve(batching, tcfg, tparams, slots, plan)
    assert got == want
    if case == "two_slots_preempt":
        # the preempted batch request finishes last, with the tokens it
        # had made before its eviction kept in its prompt, not its output
        assert [rid for rid, _ in got] == [0, 2, 1]
        assert len(got[-1][1]) < 5
