"""The port's roofline (``repro_torch.roofline``) against the JAX package's
(``repro.roofline``): the model-FLOP formula and the active parameters of
every architecture, the parameter count of the ``meta`` init, the ring
model of the collectives (on synthetic HLO lines the reference parses),
``Roofline`` under the reference's own constants; the hand-written
kernels' work at PERF.md's table shapes; the ``meta`` stand-ins of the
LM kernels against their plain versions' outputs; and the counter."""
from __future__ import annotations

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs.registry import get_arch as j_get_arch
from repro.launch import lowering as j_lowering
from repro.roofline import analysis as j_analysis
from repro.roofline import hw as j_hw
from repro_torch.configs import get_arch, list_archs
from repro_torch.kernels import cuda_lib, launch_counts, reset_launch_counts
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.flash_attention import ref as flash_ref
from repro_torch.kernels.rwkv6_scan import ops as rwkv6_ops
from repro_torch.kernels.sim_tick import fleet_tick
from repro_torch.kernels.ssm_scan import ops as ssm_ops
from repro_torch.launch.lowering import model_axes_and_shapes
from repro_torch.roofline import analysis, counting, hw
from repro_torch.roofline import kernels as work
from test_torch_models import release_jax_executables  # noqa: F401 (autouse)

ARCHS = sorted(list_archs())
META = torch.device("meta")
BF16, F32 = torch.bfloat16, torch.float32


# ---------------------------------------------------------------------------
# parameters and model FLOPs
# ---------------------------------------------------------------------------
def _n_params(cfg) -> int:
    _, shapes = model_axes_and_shapes(cfg)
    return sum(p.numel() for p in shapes.values())


@pytest.mark.parametrize("arch", ARCHS)
def test_meta_parameter_count_equals_the_reference_eval_shape(arch):
    _, j_shapes = j_lowering.model_axes_and_shapes(j_get_arch(arch).model)
    assert _n_params(get_arch(arch).model) == sum(x.size for x in jax.tree.leaves(j_shapes))


@pytest.mark.parametrize("arch", ARCHS)
def test_model_flops_and_active_params_equal_the_reference(arch):
    spec, j_spec = get_arch(arch), j_get_arch(arch)
    n = _n_params(spec.model)
    assert analysis.active_params(spec, n) == j_analysis.active_params(j_spec, n)
    for shape in spec.runnable_shapes():
        assert analysis.model_flops_estimate(spec, shape, n) == \
            j_analysis.model_flops_estimate(j_spec, shape, n), shape


# ---------------------------------------------------------------------------
# the ring model
# ---------------------------------------------------------------------------
def _hlo_line(kind: str, n: int, start: bool, iota: bool) -> tuple[str, float]:
    """One collective of a 64 x 128 bf16 result over groups of ``n`` (of
    16 devices), in the synchronous or the ``-start`` form; returns (the
    line, the result's bytes)."""
    groups = (f"replica_groups=[{16 // n},{n}]<=[16]" if iota else
              "replica_groups={{" + ",".join(str(i) for i in range(n)) + "}}")
    result = "bf16[64,128]{1,0}"
    shape = f"(bf16[{64 // n},128]{{1,0}}, {result})" if start else result
    op = kind + ("-start" if start else "")
    return (f"  %c.{kind}.{n} = {shape} {op}(bf16[{64 // n},128]{{1,0}} %p), {groups}",
            64 * 128 * 2.0)


@pytest.mark.parametrize("kind", analysis.COLLECTIVE_OPS)
@pytest.mark.parametrize("n", [2, 4, 16])
@pytest.mark.parametrize("start", [False, True], ids=["sync", "start"])
def test_wire_bytes_equal_the_reference_ring_model(kind, n, start):
    for iota in (False, True):
        line, R = _hlo_line(kind, n, start, iota)
        # a -done line is not counted again
        text = line + ("\n  %d = bf16[64,128]{1,0} " + kind + "-done(%c)" if start else "")
        ref = j_analysis.collective_bytes_by_type(text, chips=16)
        assert ref["_counts"][kind] == 1, line
        assert analysis.wire_bytes(kind, R, n) == ref[kind], line
    with pytest.raises(ValueError, match="unknown collective"):
        analysis.wire_bytes("all-scatter", 1.0, 2)


# ---------------------------------------------------------------------------
# Roofline
# ---------------------------------------------------------------------------
REFERENCE_HW = hw.Hardware(name="the reference's", peak_flops=j_hw.PEAK_FLOPS_BF16,
                           hbm_bytes_per_s=j_hw.HBM_BW, hbm_bytes=j_hw.HBM_BYTES,
                           intra_node_bytes_per_s=j_hw.ICI_BW,
                           inter_node_bytes_per_s=j_hw.ICI_BW, gpus_per_node=8)


@pytest.mark.parametrize("seed", range(6))
def test_roofline_equals_the_reference_under_its_constants(seed):
    rng = np.random.default_rng(seed)
    kw = dict(arch="a", shape="train_4k", mesh="single", chips=int(rng.choice([8, 256, 512])),
              flops_per_device=float(rng.uniform(1e9, 1e16)),
              bytes_per_device=float(rng.uniform(1e6, 1e13)),
              collective_bytes_per_device=float(rng.choice([0.0, rng.uniform(1e3, 1e12)])),
              collectives={"all-gather": 1.0}, model_flops=float(rng.uniform(0, 1e18)),
              memory_per_device={"peak_bytes": 5.0})
    got = analysis.Roofline(**kw, hw=REFERENCE_HW).to_dict()
    want = j_analysis.Roofline(**kw).to_dict()
    assert set(got) == set(want)
    for k, v in want.items():
        if isinstance(v, float):
            np.testing.assert_allclose(got[k], v, rtol=1e-12, err_msg=k)
        else:
            assert got[k] == v, k


def test_roofline_collective_term_runs_each_link_at_its_rate():
    roof = analysis.Roofline("a", "train_4k", "single", 256, 1.0, 1.0, 3e9, {}, 0.0, {},
                             link_bytes={"intra": 1e9, "inter": 2e9})
    assert roof.t_collective == pytest.approx(1e9 / hw.NVLINK_BYTES_PER_S + 2e9 / hw.IB_BYTES_PER_S)
    # no split: every byte over the slower link
    roof = dataclasses.replace(roof, link_bytes=None)
    assert roof.t_collective == pytest.approx(3e9 / hw.IB_BYTES_PER_S)
    assert analysis.model_flop_share(989e12, 2.0) == 0.5


# ---------------------------------------------------------------------------
# the kernels' work (PERF.md §6's Bytes and Bound ms columns)
# ---------------------------------------------------------------------------
def test_kernel_work_reproduces_the_table_bounds():
    cases = [
        # row, work, bound ms, what bounds it, bytes
        ("5", work.flash_attention(1, 2048, 2048, 16, 8, 256, BF16), 0.034759, "operations",
         50_331_648),
        ("5b", work.flash_attention_bwd(1, 4096, 4096, 32, 32, 96, BF16), 0.260628, "operations",
         201_850_880),
        ("6", work.rwkv6_scan(1, 2048, 64, 64, 32, BF16), 0.039815, "operations", 102_776_832),
        ("6b", work.rwkv6_scan_bwd(1, 4096, 64, 64, 32, BF16), 0.111128, "bytes", 372_277_248),
        ("7", work.ssm_scan(1, 2048, 16384, 16, BF16), 0.128384, "exp", 271_777_792),
        ("7b", work.ssm_scan_bwd(1, 2048, 16384, 16, BF16), 0.141910, "bytes", 475_398_144),
    ]
    for row, w, ms, by, moved in cases:
        bounds = w.bounds_ms()
        got_by = max(bounds, key=bounds.get)
        got_ms = bounds[got_by]
        assert (f"{got_ms:.6f}", got_by) == (f"{ms:.6f}", by), row
        assert w.bytes == moved, row
    # 6b's operations: the carry in f32, the intra products in TF32, and
    # all of them at the f32 rate
    b = work.rwkv6_scan_bwd(1, 4096, 64, 64, 32, BF16).bounds_ms()["operations"]
    assert f"{b:.6f}" == "0.050321"
    assert f"{work.rwkv_bwd_ops(4096, 32) / hw.CORE_OPS_PER_S * 1e3:.6f}" == "0.167021"
    # rows 1-4: the bytes at F 64, MC 64, MP 256, K 16 (fleet_tick at NP 3)
    assert work.fleet_tick(64, 64, 256, 3).bytes == 354_560
    assert work.retire_land(64, 64, 256).bytes == 289_280
    assert work.retire_land(64, 64, 256, timeout=True).bytes == 310_016
    assert work.masked_lex_argmin(64, 256, (4, 4, 4)).bytes == 213_248
    assert work.assign_gather(64, 16, 64, 256).bytes == 310_272


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("seed", range(4))
def test_visible_pairs_count_the_reference_mask(causal, seed):
    rng = np.random.default_rng(seed)
    Sq, Skv = int(rng.integers(1, 90)), int(rng.integers(1, 120))
    window, q_offset = int(rng.choice([0, 1, 7, 40])), int(rng.integers(0, 60))
    kv_len = int(rng.integers(0, Skv + 1))
    ok = flash_ref._visible(q_offset + torch.arange(Sq), torch.arange(Skv), causal, window, kv_len)
    assert work.visible_pairs(Sq, Skv, causal, window, q_offset, kv_len) == int(ok.sum())


# ---------------------------------------------------------------------------
# the meta stand-ins
# ---------------------------------------------------------------------------
def _pair(shape, dtype, gen, grad=False):
    cpu = torch.randn(shape, generator=gen).to(dtype)
    meta = torch.empty(shape, dtype=dtype, device=META)
    return cpu.requires_grad_(grad), meta.requires_grad_(grad)


def _same_specs(got, want):
    got = got if isinstance(got, (tuple, list)) else (got,)
    want = want if isinstance(want, (tuple, list)) else (want,)
    assert [(tuple(g.shape), g.dtype, g.device.type) for g in got] == \
        [(tuple(w.shape), w.dtype, "meta") for w in want]


def _plain_outputs(fn):
    with torch.no_grad():
        return fn()


@pytest.mark.parametrize("dtype", [BF16, F32], ids=["bf16", "f32"])
def test_flash_attention_stand_ins_have_the_plain_shapes(dtype, monkeypatch):
    gen = torch.Generator().manual_seed(0)
    (q, qm), (k, km), (v, vm) = (_pair(s, dtype, gen) for s in
                                 ((2, 24, 4, 16), (2, 40, 2, 16), (2, 40, 2, 16)))
    kw = dict(causal=True, window=8, q_offset=16, kv_len=30)
    want = flash_ref.flash_attention_ref(q, k, v, **kw)
    out, lse = flash_ref.flash_attention_fwd_lse_ref(q, k, v, **kw)
    dout = torch.randn(out.shape, generator=gen).to(dtype)
    grads = flash_ref.flash_attention_bwd_ref(q, k, v, out, lse.reshape(q.shape[:3]), dout, **kw)
    _refuse_everything(monkeypatch)
    reset_launch_counts()
    with counting.counting() as c:
        _same_specs(flash_ops.flash_attention(qm, km, vm, **kw), want)
        got_out, got_lse = flash_ops._launch(qm, km, vm, True, 8, 16, 30, with_lse=True)
        _same_specs((got_out, got_lse), (out, lse.reshape(q.shape[:3])))
        _same_specs(flash_ops.flash_attention_bwd(qm, km, vm, got_out, got_lse,
                                                  torch.empty_like(got_out), **kw), grads)
    assert c.kernel_calls() == {"flash_attention": 2, "flash_attention_bwd": 1}
    assert all(n == 0 for n in launch_counts().values())


def _refuse_everything(monkeypatch):
    def refuse(*_a, **_k):
        raise AssertionError("a meta call reached a plain version or cuda_lib")

    for mod in (flash_ops, rwkv6_ops, ssm_ops):
        for name in dir(mod):
            if name.endswith("_ref"):
                monkeypatch.setattr(mod, name, refuse)
    for name in ("function", "require", "stream_args", "check_launch", "build"):
        monkeypatch.setattr(cuda_lib, name, refuse)


@pytest.mark.parametrize("S", [32, 45])
def test_rwkv6_scan_stand_ins_have_the_plain_shapes(S, monkeypatch):
    from repro_torch.kernels.rwkv6_scan import ref

    gen = torch.Generator().manual_seed(1)
    B, H, N, C = 2, 2, 8, 16
    pairs = [_pair((B, S, H, N), BF16, gen) for _ in range(3)]
    w = (torch.rand((B, S, H, N), generator=gen) * 0.5 + 0.4, torch.empty((B, S, H, N),
                                                                          device=META))
    u = _pair((H, N), F32, gen)
    s0 = _pair((B, H, N, N), F32, gen)
    cpu = [p[0] for p in pairs] + [w[0], u[0], s0[0]]
    meta = [p[1] for p in pairs] + [w[1], u[1], s0[1]]
    want = ref.rwkv6_chunked_ref(*[torch.nn.functional.pad(t, (0, 0, 0, 0, 0, -S % C))
                                   if i < 4 else t for i, t in enumerate(cpu)], chunk=C)
    Sp = want[0].shape[1]
    dout = torch.randn(want[0].shape, generator=gen).to(BF16)
    padded = [torch.nn.functional.pad(t, (0, 0, 0, 0, 0, -S % C)) if i < 4 else t
              for i, t in enumerate(cpu)]
    grads = ref.rwkv6_scan_bwd_ref(*padded, dout, torch.zeros_like(s0[0]), chunk=C)
    plain = ref.rwkv6_chunked_ref(*padded, chunk=C)
    _refuse_everything(monkeypatch)
    with counting.counting() as c:
        out, state = rwkv6_ops.rwkv6_scan(*meta, chunk=C)
        _same_specs((out, state), (plain[0][:, :S], plain[1]))
        mp = [torch.empty((B, Sp, H, N), dtype=t.dtype, device=META) if i < 4 else t
              for i, t in enumerate(meta)]
        o, s, states = rwkv6_ops._launch(*mp, C, with_states=True)
        assert tuple(states.shape) == (B, H, Sp // C, N, N) and states.dtype == F32
        _same_specs(rwkv6_ops.rwkv6_scan_bwd(*mp, torch.empty_like(o), torch.empty_like(s),
                                             chunk=C, states=states), grads)
    assert c.kernel_calls() == {"rwkv6_scan": 2, "rwkv6_scan_bwd": 1}


@pytest.mark.parametrize("S", [16, 37])
def test_ssm_scan_stand_ins_have_the_plain_shapes(S, monkeypatch):
    from repro_torch.kernels.ssm_scan import ref

    gen = torch.Generator().manual_seed(2)
    B, dim, N = 2, 12, 8
    x, dt = _pair((B, S, dim), BF16, gen), _pair((B, S, dim), F32, gen)
    A, D = _pair((dim, N), F32, gen), _pair((dim,), F32, gen)
    Bm, Cm = _pair((B, S, N), BF16, gen), _pair((B, S, N), BF16, gen)
    h0 = _pair((B, dim, N), F32, gen)
    cpu = [t[0] for t in (x, dt, A, Bm, Cm, D, h0)]
    meta = [t[1] for t in (x, dt, A, Bm, Cm, D, h0)]
    want = ssm_ops.ssm_scan(*cpu, chunk=8)
    grads = ref.ssm_scan_bwd_ref(*cpu, torch.randn((B, S, dim), generator=gen).to(BF16),
                                 torch.zeros((B, dim, N)))
    _refuse_everything(monkeypatch)
    with counting.counting() as c:
        _same_specs(ssm_ops.ssm_scan(*meta, chunk=8), want)
        _same_specs(ssm_ops.ssm_scan_bwd(*meta, torch.empty((B, S, dim), dtype=BF16, device=META),
                                         torch.empty((B, dim, N), device=META)), grads)
    assert c.kernel_calls() == {"ssm_scan": 1, "ssm_scan_bwd": 1}


def test_a_backward_traced_on_meta_reports_the_backward_kernels(monkeypatch):
    """The autograd Functions run on ``meta``: a forward and backward
    there report the forward and backward kernels, and their gradients
    have the inputs' shapes."""
    _refuse_everything(monkeypatch)
    q = torch.empty((1, 32, 4, 16), dtype=BF16, device=META, requires_grad=True)
    k = torch.empty((1, 32, 2, 16), dtype=BF16, device=META, requires_grad=True)
    x = torch.empty((1, 20, 6), dtype=BF16, device=META, requires_grad=True)
    dt, A = torch.empty((1, 20, 6), device=META), torch.empty((6, 4), device=META)
    Bc = torch.empty((1, 20, 4), dtype=BF16, device=META)
    with counting.counting() as c:
        y = flash_ops.flash_attention(q, k, k)
        ys, _ = ssm_ops.ssm_scan(x, dt, A, Bc, Bc, torch.empty(6, device=META))
        g = torch.autograd.grad((y.float().sum(), ys.float().sum()), (q, k, x))
    assert [tuple(t.shape) for t in g] == [(1, 32, 4, 16), (1, 32, 2, 16), (1, 20, 6)]
    assert c.kernel_calls() == {"flash_attention": 1, "ssm_scan": 1, "flash_attention_bwd": 1,
                                "ssm_scan_bwd": 1}
    # the attention's records: 4 H D and 5 x 2 H D a visible pair
    pairs = 32 * 33 // 2
    assert c.kernels["flash_attention"]["flops"] == 4 * 4 * 16 * pairs
    assert c.kernels["flash_attention_bwd"]["flops"] == 10 * 4 * 16 * pairs


def test_other_devices_still_raise_and_the_simulator_has_no_stand_in():
    from repro_torch.kernels.dispatch import abstract, use_kernel

    m = torch.empty(3, device=META)
    assert abstract(m) and not abstract(torch.empty(3))
    with pytest.raises(ValueError, match="'cuda' or 'cpu'"):
        use_kernel(m)
    t = torch.empty((4, 8), dtype=torch.int32, device=META)
    with pytest.raises(ValueError, match="'cuda' or 'cpu'"):
        fleet_tick(t, t, t, t.float(), t.float(), t, t, t, t, t[:, 0], num_pools=1)


# ---------------------------------------------------------------------------
# the counter
# ---------------------------------------------------------------------------
def test_counter_counts_products_bytes_and_the_peak():
    a = torch.empty((64, 32), device=META)
    b = torch.empty((32, 16), device=META)
    with counting.counting(a, b) as c:
        y = a @ b                    # 2 m k n FLOPs; reads a and b, writes y
        v = y.view(16, 64).t()       # views move nothing
        z = torch.empty((1000,), device=META)    # an allocation moves nothing
        del z
        w = v.float() + 1.0          # a float of an f32 is no copy; the add moves 2 x y
    assert c.flops == 2 * 64 * 32 * 16
    assert c.bytes == 4 * (64 * 32 + 32 * 16 + 64 * 16) + 4 * 2 * 64 * 16
    # the 4,000-byte allocation died before w was made; a, b, y (which v
    # views) and w were live at once
    assert c.peak_bytes == 4 * (64 * 32 + 32 * 16 + 64 * 16) + 4 * 64 * 16
    assert c.ops == 5 and w.shape == (64, 16)     # mm, view, t, empty, add


def test_report_computes_nothing_without_a_counter():
    def boom(*_a):
        raise AssertionError("computed")

    counting.report("flash_attention", boom)
    with pytest.raises(AssertionError, match="computed"), counting.counting():
        counting.report("flash_attention", boom)


def test_a_dtensor_op_is_counted_once_at_its_local_shape():
    """On a fake (2, 4) mesh: a matrix product of a batch-sharded input by
    a model-sharded weight counts its local FLOPs once; redistributing
    the weight to replicated counts one all-gather over the group of 4."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from repro_torch.launch.mesh import fake_process_group, make_host_mesh

    with fake_process_group(8):
        mesh = make_host_mesh(2, 4)
        x = DTensor.from_local(torch.empty((3, 8), device=META), mesh, [Shard(0), Replicate()],
                               run_check=False)
        w = DTensor.from_local(torch.empty((8, 5), device=META), mesh, [Replicate(), Shard(1)],
                               run_check=False)
        with counting.counting(x, w) as c:
            y = x @ w
            whole = w.redistribute(mesh, [Replicate(), Replicate()])
        assert y.to_local().shape == (3, 5) and whole.to_local().shape == (8, 20)
    assert c.flops == 2 * 3 * 8 * 5
    ag = c.collectives["all-gather"]
    assert ag["count"] == 1 and ag["result_bytes"] == 8 * 20 * 4
    assert ag["wire_bytes"] == analysis.wire_bytes("all-gather", 8 * 20 * 4, 4)
    # ranks 0-3 of a node of 8: the group stays inside it
    assert ag["intra_bytes"] == ag["wire_bytes"] and ag["inter_bytes"] == 0


def test_h100_constants():
    assert hw.H100.peak_flops == 989e12 and hw.H100.hbm_bytes_per_s == 3.35e12
    assert hw.OPS_PER_S == {"f32": 67e12, "bf16": 989e12, "tf32": 495e12}
    assert hw.SFU_EXP_PER_S == pytest.approx(4.18176e12)
    assert hw.H100.link_bytes_per_s("intra") == 450e9
    assert hw.H100.link_bytes_per_s("inter") == 50e9
    assert hw.DTYPE_BYTES[torch.bfloat16] == 2 and hw.DTYPE_BYTES[torch.bool] == 1
