"""The port's distribution layer against the JAX package's, in one
process on the CPU.

* ``parallel.sharding.spec_for`` equals the reference's on the cases of
  ``tests/test_sharding_rules.py``, on random shapes and axes, and on
  every parameter of the ten architectures at their published widths
  (``launch.lowering.model_axes_and_shapes`` on the ``meta`` device)
  over duck-typed (16, 16) and (2, 16, 16) meshes; ``placements`` turns
  a spec into DTensor placements and refuses a tuple out of mesh order.
* ``models.axes.model_axes`` equals the JAX init's axes side table for
  the ten smoke configs (a stacked leaf without its ``layers``).
* ``launch.shapes`` equals the reference's values for 10 archs x 4
  shapes; ``launch.lowering``'s ``lower_*`` wait for item 16 (d).
* The int8 helpers of ``parallel.collectives`` are bit-equal to the
  reference's.
* ``core.sweep._fleet_sharded`` over four CPU blocks of a 6-lane fleet
  (padded to 8) is bit-equal lane for lane to the unsharded fleet under
  every scheduler, with the data plane off and on, traced too; and equal
  under the comparison contract to the reference's ``fleet_run(shard=
  "auto")`` on ``conftest.py``'s four forced host devices.
* Over a one-rank ``gloo`` process group (a ``FileStore`` under
  ``tmp_path``): ``run_training`` on a (1, 1) mesh is bit-equal to
  ``mesh=None``, a prefill on it bit-equal to the plain one, and
  ``compressed_psum_mean`` equals ``ef_compress_grad``.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from repro.configs.registry import get_arch as j_get_arch
from repro.core import SimParams as JParams
from repro.core.sweep import fleet_run as j_fleet_run
from repro.core.sweep import make_workload_batch as j_batch
from repro.launch import lowering as j_lowering
from repro.launch import shapes as j_shapes
from repro.parallel import collectives as j_coll
from repro.parallel import sharding as j_sharding
from repro.runtime.steps import model_init as j_model_init
from repro_torch import SimParams, fleet_run
from repro_torch.bridge import _jax_node, state_to_arrays, workload_from_arrays
from repro_torch.configs import get_arch, list_archs
from repro_torch.core import sweep
from repro_torch.core.policy import DEFAULT_POINTS
from repro_torch.launch import lowering, shapes
from repro_torch.models.axes import model_axes
from repro_torch.parallel import collectives, pipeline
from repro_torch.parallel.sharding import (
    DEFAULT_ACT_RULES,
    DEFAULT_PARAM_RULES,
    ShardingRules,
    placements,
    spec_for,
)
from repro_torch.runtime.steps import stacked_leaves
from test_torch_models import release_jax_executables  # noqa: F401 (autouse)


class FakeMesh:
    """Duck-typed mesh: only axis_names + shape are consulted."""

    def __init__(self, shape: dict):
        self.axis_names = tuple(shape)
        self.shape = shape


MESH_SINGLE = FakeMesh({"data": 16, "model": 16})
MESH_MULTI = FakeMesh({"pod": 2, "data": 16, "model": 16})
MESHES = {"single": MESH_SINGLE, "multi": MESH_MULTI}
ARCHS = sorted(list_archs())


def _ref_spec(shape, axes, mesh, rules):
    return tuple(j_sharding.spec_for(shape, axes, mesh, rules))


# ---------------------------------------------------------------------------
# spec_for and placements
# ---------------------------------------------------------------------------
RULE_CASES = [
    ((256, 4096), "batch seq", "multi", "act"),
    ((1, 4096), "batch seq", "multi", "act"),
    ((6144, 1, 128), "embed kv_heads head_dim", "single", "param"),
    ((5376, 16, 128), "embed kv_heads head_dim", "single", "param"),
    ((128, 7168, 4864), "expert embed_moe ff", "single", "param"),
    ((4, 4, 4), "embed ff", "single", "param"),
    ((5120, 40, 128), "embed heads head_dim", "single", "override"),
]


@pytest.mark.parametrize("shape,axes,mesh,rules", RULE_CASES, ids=lambda v: str(v))
def test_spec_for_equals_the_reference_on_the_rule_cases(shape, axes, mesh, rules):
    if rules == "override":
        port = ShardingRules().override(param={"head_dim": ("model",), "heads": ()}).param
        ref = j_sharding.ShardingRules().override(param={"head_dim": ("model",), "heads": ()}).param
    else:
        port = DEFAULT_ACT_RULES if rules == "act" else DEFAULT_PARAM_RULES
        ref = j_sharding.DEFAULT_ACT_RULES if rules == "act" else j_sharding.DEFAULT_PARAM_RULES
    assert port == ref
    got = spec_for(shape, axes, MESHES[mesh], port)
    assert got == _ref_spec(shape, axes, MESHES[mesh], ref)
    assert P(*got) == j_sharding.spec_for(shape, axes, MESHES[mesh], ref)


def test_spec_for_equals_the_reference_on_random_shapes():
    rng = np.random.default_rng(0)
    dims = [1, 2, 7, 16, 56, 64, 128, 131, 4096, 262144]
    names = ["batch", "seq", "embed", "heads", "kv_heads", "ff", "expert", "vocab", "head_dim",
             "kv_seq", "embed_moe", "layers"]
    for _ in range(400):
        n = int(rng.integers(1, 5))
        shape = tuple(int(d) for d in rng.choice(dims, n))
        axes = " ".join(rng.choice(names, n))
        mesh = MESHES[str(rng.choice(["single", "multi"]))]
        for port, ref in ((DEFAULT_PARAM_RULES, j_sharding.DEFAULT_PARAM_RULES),
                          (DEFAULT_ACT_RULES, j_sharding.DEFAULT_ACT_RULES)):
            assert spec_for(shape, axes, mesh, port) == _ref_spec(shape, axes, mesh, ref), (
                shape, axes)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mesh", ["single", "multi"])
def test_spec_for_every_parameter_at_published_width(arch, mesh):
    """Every parameter of the architecture at its published shape (the
    port's ``meta`` init) gets the reference's spec of the same axes, and
    the port's axes and shapes are the reference's (a stacked leaf's
    slice)."""
    cfg = get_arch(arch).model
    axes, shapes_ = lowering.model_axes_and_shapes(cfg)
    assert set(axes) == set(shapes_) and all(t.device.type == "meta" for t in shapes_.values())
    j_axes, j_shapes_tree = j_lowering.model_axes_and_shapes(j_get_arch(arch).model)
    rules = lowering.arch_rules(get_arch(arch))
    j_rules = j_lowering.arch_rules(j_get_arch(arch))
    assert dict(rules.param) == dict(j_rules.param) and dict(rules.act) == dict(j_rules.act)
    m = MESHES[mesh]
    for name, t in shapes_.items():
        j_ax, index = _jax_node(cfg, j_axes, name)
        j_sh = _jax_node(cfg, j_shapes_tree, name)[0].shape
        if index is not None:
            assert j_ax.startswith("layers ") and tuple(t.shape) == tuple(j_sh[1:]), name
            j_ax = j_ax[len("layers "):]
        else:
            assert tuple(t.shape) == tuple(j_sh), name
        assert axes[name] == j_ax, name
        assert (spec_for(t.shape, axes[name], m, rules.param)
                == _ref_spec(tuple(t.shape), j_ax, m, j_rules.param)), name


def test_placements_follow_the_spec_in_mesh_order():
    from torch.distributed.tensor import Replicate, Shard

    mesh = FakeMesh({"pod": 2, "data": 4, "model": 2})
    assert placements(("model", None, ("pod", "data")), mesh) == [Shard(2), Shard(2), Shard(0)]
    assert placements((), mesh) == [Replicate()] * 3
    # an axis of one rank splits nothing
    assert placements(("data",), FakeMesh({"data": 1, "model": 2})) == [Replicate(), Replicate()]
    with pytest.raises(ValueError, match="mesh's order"):
        placements((("data", "pod"),), mesh)


# ---------------------------------------------------------------------------
# model_axes, launch/shapes.py, launch/lowering.py
# ---------------------------------------------------------------------------
def _jax_axes(cfg_j):
    box = {}

    def f(key):
        params, axes = j_model_init(cfg_j, key)
        box["axes"] = axes
        return params

    jax.eval_shape(f, jax.random.PRNGKey(0))
    return box["axes"]


@pytest.mark.parametrize("arch", ARCHS)
def test_model_axes_equal_the_jax_init(arch):
    cfg = get_arch(arch).smoke
    ref = _jax_axes(j_get_arch(arch).smoke)
    axes = model_axes(cfg)
    assert list(axes) == [n for n, _ in lowering.model_axes_and_shapes(cfg)[1].items()]
    for name, ax in axes.items():
        want, index = _jax_node(cfg, ref, name)
        assert ax == (want if index is None else want[len("layers "):]), name


def _tensor_spec(t):
    return tuple(t.shape), str(t.dtype).split(".")[-1]


def _ref_spec_of(s):
    return tuple(s.shape), str(jnp.dtype(s.dtype))


def dataclass_tuple(s):
    return (s.name, s.kind, s.seq, s.batch)


@pytest.mark.parametrize("shape_name", list(shapes.SHAPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_shapes_equal_the_reference(arch, shape_name):
    spec, j_spec = get_arch(arch).model, j_get_arch(arch).model
    shape = shapes.SHAPES[shape_name]
    assert dataclass_tuple(shape) == dataclass_tuple(j_shapes.SHAPES[shape_name])
    got, want = shapes.batch_specs(spec, shape), j_shapes.batch_specs(j_spec, j_shapes.SHAPES[shape_name])
    assert {k: _tensor_spec(v) for k, v in got.items()} == {k: _ref_spec_of(v) for k, v in want.items()}
    assert all(v.device.type == "meta" for v in got.values())
    assert shapes.batch_axes(spec, shape) == j_shapes.batch_axes(j_spec, j_shapes.SHAPES[shape_name])
    # caches: the port keeps one entry a layer, the reference stacks the
    # periods of the pattern (a leading "layers")
    axes, c_shapes = shapes.cache_axes(spec), shapes.cache_shapes(spec, shape.batch, shape.seq)
    j_axes = j_shapes.cache_axes(j_spec)
    j_c = j_shapes.cache_shapes(j_spec, shape.batch, shape.seq)
    if spec.family == "audio":
        pairs = [(axes.self_kv[i], c_shapes.self_kv[i], j_axes.self_kv, j_c.self_kv, i)
                 for i in range(spec.n_layers)]
        pairs += [(axes.cross_kv[i], c_shapes.cross_kv[i], j_axes.cross_kv, j_c.cross_kv, i)
                  for i in range(spec.n_layers)]
    else:
        base = spec.n_periods * spec.period
        pairs = [(axes[i], c_shapes[i], j_axes["periods"][i % spec.period],
                  j_c["periods"][i % spec.period], i // spec.period) if i < base else
                 (axes[i], c_shapes[i], j_axes["tail"][i - base], j_c["tail"][i - base], None)
                 for i in range(spec.n_layers)]
    for ax, sh, j_ax, j_sh, index in pairs:
        for a, s, ja, js in zip(ax, sh, j_ax, j_sh):
            if index is not None:
                ja, js = ja[len("layers "):], jax.ShapeDtypeStruct(js.shape[1:], js.dtype)
            assert a == ja and _tensor_spec(s) == _ref_spec_of(js)



@pytest.mark.parametrize("arch", ["phi3_mini_3p8b", "jamba_1p5_large_398b", "rwkv6_7b"])
def test_opt_axes_equal_the_reference(arch):
    """AdamW's moments take their parameters' axes; Adafactor's leaves
    are the JAX tree's stacked leaves with their factored axes."""
    cfg, j_cfg = get_arch(arch).smoke, j_get_arch(arch).smoke
    p_axes, p_shapes = lowering.model_axes_and_shapes(cfg)
    j_axes, j_p_shapes = j_lowering.model_axes_and_shapes(j_cfg)
    groups = stacked_leaves(cfg, list(p_axes))
    for opt in ("adamw", "adafactor"):
        got = shapes.opt_axes(opt, p_axes, p_shapes, groups)
        want = j_shapes.opt_axes(opt, j_axes, j_p_shapes)
        assert got.step == want.step == ""
        if opt == "adamw":
            for name in p_axes:
                for k in ("m", "v"):
                    j_ax, index = _jax_node(cfg, want.inner[k], name)
                    assert got.inner[k][name] == (j_ax if index is None else j_ax[len("layers "):])
            continue
        for leaf in groups:
            node = want.inner
            for part in leaf.split("."):
                node = node[int(part)] if isinstance(node, (list, tuple)) else node[part]
            assert got.inner[leaf] == node, leaf


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_lowering_counts_one_step_on_meta(kind):
    """Item 16 (d): ``lower_train``, ``lower_prefill``, ``lower_decode``
    and ``lower_cell`` run a step of a smoke config on ``meta`` (no mesh:
    one device, no process group) and return its count; the attention
    kernels are counted as their stand-ins report them, and nothing is
    launched. Over fake 256- and 512-rank groups:
    ``tests/test_torch_dryrun.py``."""
    import dataclasses

    from repro_torch.kernels import launch_counts, reset_launch_counts

    arch = get_arch("phi3_mini_3p8b")
    arch = dataclasses.replace(arch, model=arch.smoke, train_microbatches=2)
    spec = shapes.ShapeSpec(kind, kind, 32, 4)
    fn = {"train": lowering.lower_train, "prefill": lowering.lower_prefill,
          "decode": lowering.lower_decode}[kind]
    reset_launch_counts()
    low = fn(arch, spec)
    assert launch_counts() == {name: 0 for name in launch_counts()}
    again = lowering.lower_cell(arch, spec)
    assert (low.kind, low.chips, low.collective_bytes) == (kind, 1, 0)
    assert low.flops > 0 and low.bytes > 0 and low.peak_bytes > 0
    assert (again.flops, again.bytes, again.ops) == (low.flops, low.bytes, low.ops)
    layers = arch.model.n_layers
    want = {"train": {"flash_attention": 2 * layers * 2, "flash_attention_bwd": layers * 2},
            "prefill": {"flash_attention": layers}, "decode": {}}[kind]
    assert {k: v["calls"] for k, v in low.kernels.items()} == want


# ---------------------------------------------------------------------------
# collectives: the int8 helpers
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_helpers_equal_the_reference(dtype):
    rng = np.random.default_rng(5)
    x = (rng.standard_normal((64, 33)) * rng.choice([1e-3, 1.0, 40.0], (64, 33))).astype(np.float32)
    x[0, :4] = [0.5, -0.5, 1.5, 2.5]       # ties at the rounding step
    err = (rng.standard_normal((64, 33)) * 1e-3).astype(np.float32)
    tx = torch.from_numpy(x)
    jx = jnp.asarray(x)
    if dtype == "bfloat16":
        tx, jx = tx.to(torch.bfloat16), jx.astype(jnp.bfloat16)
    q, scale = collectives.quantize_int8(tx)
    jq, jscale = j_coll.quantize_int8(jx)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert scale.numpy().tobytes() == np.asarray(jscale).tobytes()
    np.testing.assert_array_equal(collectives.dequantize_int8(q, scale).numpy(),
                                  np.asarray(j_coll.dequantize_int8(jq, jscale)))
    q, scale, new = collectives.ef_compress_grad(tx, torch.from_numpy(err))
    jq, jscale, jnew = j_coll.ef_compress_grad(jx, jnp.asarray(err))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert scale.numpy().tobytes() == np.asarray(jscale).tobytes()
    assert new.numpy().tobytes() == np.asarray(jnew).tobytes()


def test_bubble_fraction_equals_the_reference():
    from repro.parallel.pipeline import bubble_fraction as j_bubble

    for s, m in ((1, 1), (2, 8), (4, 4), (16, 64)):
        assert pipeline.bubble_fraction(s, m) == j_bubble(s, m)


# ---------------------------------------------------------------------------
# the sharded fleet
# ---------------------------------------------------------------------------
DATA_PLANE = dict(cache_gb_per_pool=4.0, scan_ticks_per_gb=50.0, cold_start_ticks=40)
SCHEDULERS = ["naive", "priority", "priority_pool", "sjf", "cache_aware", "locality_pool", "policy"]


def _fleet_kw(algo, dp):
    return dict(duration=0.05, scheduling_algo=algo, num_pools=2, waiting_ticks_mean=250.0,
                op_base_seconds_mean=0.005, max_pipelines=32, max_containers=32,
                **(DATA_PLANE if dp else {}))


def _fleet_wls(params, algo):
    wls = sweep.make_workload_batch(params, list(range(6)))
    if algo == "policy":
        wls = sweep.attach_policies(wls, [DEFAULT_POINTS["priority"]] * 6)
    return wls


def _sharded(params, wls, algo, capacity):
    """bin, pad to 8, four CPU blocks, unbin: fleet_run's spread path."""
    binned, inv = sweep.bin_lanes_by_density(wls, params)
    states, tbuf = sweep._fleet_sharded(params, sweep.pad_lanes(binned, 8), algo,
                                        [torch.device("cpu")] * 4, capacity)
    return sweep._unbin_states((states, tbuf), inv)


@pytest.mark.parametrize("dp", [False, True], ids=["dp-off", "dp-on"])
@pytest.mark.parametrize("algo", SCHEDULERS)
def test_sharded_fleet_equals_the_unsharded_lane_for_lane(algo, dp):
    params = SimParams(**_fleet_kw(algo, dp))
    wls = _fleet_wls(params, algo)
    states, tbuf = _sharded(params, wls, algo, 0)
    assert tbuf is None
    got = state_to_arrays(states)
    whole = state_to_arrays(fleet_run(params, workloads=wls, device="cpu"))
    for name, want in whole.items():
        np.testing.assert_array_equal(got[name], want, err_msg=name)
    assert whole["done_count"].sum() > 0


@pytest.mark.parametrize("algo,dp", [("priority", False), ("cache_aware", True)])
def test_sharded_traced_fleet_equals_the_unsharded(algo, dp):
    params = SimParams(**_fleet_kw(algo, dp))
    wls = _fleet_wls(params, algo)
    states, tbuf = _sharded(params, wls, algo, 512)
    want_states, want_traces = fleet_run(params, workloads=wls, device="cpu", trace=True,
                                         trace_capacity=512)
    got, whole = state_to_arrays(states), state_to_arrays(want_states)
    for name in whole:
        np.testing.assert_array_equal(got[name], whole[name], err_msg=name)
    traces = sweep._decode_traces(tbuf)
    assert len(traces) == 6
    for mine, theirs in zip(traces, want_traces):
        assert mine.counts_by_kind() == theirs.counts_by_kind()
        np.testing.assert_array_equal(mine.records, theirs.records)


TOLERANT = {"sum_latency_s", "sum_latency_s_prio", "util_cpu_s", "util_ram_s", "cost_dollars",
            "util_log", "pool_down_s"}


def test_sharded_fleet_matches_the_reference_sharded_fleet():
    """The reference spreads the same batch over conftest.py's four
    forced host devices (``shard="auto"``); the port over four CPU
    blocks; the comparison contract of tests/test_torch_fleet.py."""
    assert len(jax.local_devices()) == 4
    kw = _fleet_kw("priority_pool", True)
    jp = JParams(**kw)
    arrays = {f: np.asarray(getattr(j_batch(jp, list(range(6))), f))
              for f in j_batch(jp, [0])._fields[:10]}
    ref = j_fleet_run(jp, workloads=j_batch(jp, list(range(6))), shard="auto")
    params = SimParams(**kw)
    states, _ = _sharded(params, workload_from_arrays(arrays), "priority_pool", 0)
    got = state_to_arrays(states)
    for name in ref._fields:
        want = np.asarray(getattr(ref, name))
        assert got[name].dtype == want.dtype and got[name].shape == want.shape, name
        if name in TOLERANT:
            np.testing.assert_allclose(got[name], want, rtol=1e-5, err_msg=name)
        else:
            np.testing.assert_array_equal(got[name], want, err_msg=name)


# ---------------------------------------------------------------------------
# a one-rank process group
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def one_rank(tmp_path_factory):
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_host_mesh

    store = dist.FileStore(str(tmp_path_factory.mktemp("pg") / "store"), 1)
    dist.init_process_group("gloo", store=store, rank=0, world_size=1)
    try:
        yield make_host_mesh(1, 1)
    finally:
        dist.destroy_process_group()


def test_training_on_a_one_rank_mesh_is_bit_equal(one_rank):
    from repro_torch.runtime import run_training

    arch = get_arch("phi3_mini_3p8b")
    kw = dict(steps=3, device="cpu", global_batch=4, seq_len=32, microbatches=2)
    got = run_training(arch, mesh=one_rank, **kw)
    want = run_training(arch, **kw)
    assert got.losses == want.losses
    for (name, p), q in zip(got.final_state.params.named_parameters(),
                            want.final_state.params.parameters()):
        assert torch.equal(p.detach().full_tensor(), q.detach()), name


def test_prefill_on_a_one_rank_mesh_is_bit_equal(one_rank):
    from repro_torch.models import lm
    from repro_torch.parallel import logical_constraint, shard_params, sharding_ctx

    arch = get_arch("arctic_480b")
    cfg, rules = arch.smoke, lowering.arch_rules(arch)
    m = lm.lm_init(cfg, 0, device="cpu")
    tok = torch.randint(2, cfg.vocab, (2, 24), generator=torch.Generator().manual_seed(3))
    want, caches = lm.lm_prefill(cfg, m, {"tokens": tok}, max_len=32)
    want_d, _ = lm.lm_decode_step(cfg, m, caches, tok[:, -1], 24)
    shard_params(m, model_axes(cfg), one_rank, rules)
    with sharding_ctx(one_rank, rules.act):
        got, caches = lm.lm_prefill(cfg, m, {"tokens": logical_constraint(
            tok, "batch seq", one_rank, rules)}, max_len=32)
        got_d, _ = lm.lm_decode_step(cfg, m, caches, logical_constraint(
            tok[:, -1], "batch", one_rank, rules), 24)
    assert torch.equal(got.full_tensor(), want) and torch.equal(got_d.full_tensor(), want_d)


def test_compressed_psum_mean_on_one_rank_is_ef_compress_grad(one_rank):
    gen = torch.Generator().manual_seed(1)
    grads = {"a": torch.randn((8, 5), generator=gen), "b": torch.randn((3,), generator=gen)}
    errs = {k: torch.randn(v.shape, generator=gen) * 1e-3 for k, v in grads.items()}
    means, new_errs = collectives.compressed_psum_mean(grads, errs, one_rank)
    for k in grads:
        q, scale, new = collectives.ef_compress_grad(grads[k], errs[k])
        assert torch.equal(means[k], collectives.dequantize_int8(q, scale))
        assert torch.equal(new_errs[k], new)


def test_recomputation_enters_the_context_on_another_thread(one_rank):
    """The autograd engine runs a CUDA backward on a device thread, which
    inherits the caller's thread-local state (DTensor's implicit
    replication among it) but not the sharding context (a
    ``ContextVar``); each layer recomputed there
    (``torch.utils.checkpoint``) enters the context of its forward. Here
    the backward runs on a thread of its own with that state: the
    gradients equal the plain ones bit for bit, and a DTensor handed to
    a kernel outside a context raises."""
    import threading

    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.models import lm
    from repro_torch.parallel import kernel_map, logical_constraint, shard_params, sharding_ctx

    arch = get_arch("phi3_mini_3p8b")
    cfg, rules = arch.smoke, lowering.arch_rules(arch)
    tok = torch.randint(2, cfg.vocab, (2, 16), generator=torch.Generator().manual_seed(4))
    m = lm.lm_init(cfg, 0, device="cpu")
    # two chunks of the cross entropy, each recomputed in the backward too
    want = torch.autograd.grad(lm.lm_loss(cfg, m, {"tokens": tok}, vocab_chunk=8),
                               list(m.parameters()))
    shard_params(m, model_axes(cfg), one_rank, rules)
    out = {}

    def backward():
        try:
            with implicit_replication():
                out["grads"] = torch.autograd.grad(out["loss"], list(m.parameters()))
        except BaseException as e:  # noqa: BLE001
            out["error"] = e

    with sharding_ctx(one_rank, rules.act):
        out["loss"] = lm.lm_loss(cfg, m, {"tokens": logical_constraint(
            tok, "batch seq", one_rank, rules)}, vocab_chunk=8)
        worker = threading.Thread(target=backward)
        worker.start()
        worker.join(timeout=300)
    assert not worker.is_alive()
    if "error" in out:
        raise out["error"]
    for g, w in zip(out["grads"], want):
        assert torch.equal(g.full_tensor(), w)
    with pytest.raises(RuntimeError, match="outside a sharding context"):
        kernel_map(lambda x: x, (next(m.parameters()),), [(None, None)], (1, None, None))


def test_the_private_torch_names_the_port_reads_are_there(one_rank):
    """The names the port reads that are private to torch pin its version
    (ROADMAP queue 3): DTensor's implicit-replication flag, which
    ``sharding_ctx`` sets and restores and which the autograd engine's
    device threads must see too, and
    ``compute_local_shape_and_global_offset``, which ``ckpt._region``
    calls; for the dry run (``launch/mesh.py``, ``roofline/counting.py``,
    ``launch/lowering.py``) the fake process group's ``FakeStore``, the
    dispatch-mode key of a fake-tensor mode (how the counter tells
    DTensor's shape propagation from the step's ops),
    ``_resolve_process_group`` (a collective's group from its name) and
    ``flop_counter.flop_registry``. Any gone or changed in kind fails
    here, not on the card. The flag is one of
    two kinds: an attribute of the process's one dispatcher (any thread
    sees it), or torch's own thread-local flag behind
    ``torch._C._get_dtensor_allow_implicit_replication``, which is part
    of the thread-local state that the autograd engine hands to its
    device threads."""
    import threading

    from torch.distributed.tensor import DTensor, Shard, distribute_tensor
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

    from repro_torch.checkpoint.ckpt import _region
    from repro_torch.parallel import sharding_ctx

    dispatcher = DTensor._op_dispatcher
    before = dispatcher._allow_implicit_replication
    assert isinstance(before, bool)
    seen = {}
    with sharding_ctx(one_rank, {}):
        assert dispatcher._allow_implicit_replication is True
        thread = threading.Thread(
            target=lambda: seen.update(flag=DTensor._op_dispatcher._allow_implicit_replication))
        thread.start()
        thread.join()
    assert dispatcher._allow_implicit_replication is before
    assert isinstance(seen["flag"], bool)
    assert seen["flag"] or torch._C._get_dtensor_allow_implicit_replication() is before

    assert callable(compute_local_shape_and_global_offset)
    t = distribute_tensor(torch.arange(24.0).reshape(4, 6), one_rank, [Shard(0), Shard(1)])
    shape, start = compute_local_shape_and_global_offset(t.shape, t.device_mesh, t.placements)
    assert (tuple(shape), tuple(start)) == ((4, 6), (0, 0))
    assert _region(t) == ((0, 0), (4, 6))

    # the dry run's names
    import torch.distributed as dist
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.distributed_c10d import _resolve_process_group
    from torch.testing._internal.distributed.fake_pg import FakeStore
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils.flop_counter import flop_registry

    assert issubclass(FakeStore, dist.Store) and dist.Backend.FAKE == "fake"
    group = dist.group.WORLD
    assert _resolve_process_group(group.group_name).size() == group.size() == 1
    assert callable(flop_registry[torch.ops.aten.mm])
    modes = []

    class Probe(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            modes.append(torch._C._get_dispatch_mode(torch._C._TorchDispatchModeKey.FAKE))
            return func(*args, **(kwargs or {}))

    with Probe():
        torch.ones(2) + 1
        with FakeTensorMode():
            torch.ones(2) + 1
    assert modes[0] is None and any(m is not None for m in modes[1:])

