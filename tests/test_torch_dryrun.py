"""The port's dry run (``launch/lowering.py``, ``launch/dryrun.py``) on fake
process groups: the smoke configs of the JAX package's
``tests/test_dryrun_small.py`` cells on fake (2, 4) and (2, 2, 2) meshes,
the FSDP gathers against the placements' arithmetic, the per-device
FLOPs against the reference's HLO count of the same cell, lowerings over
256 and 512 ranks, and the CLI's report through
``benchmarks/roofline_report.py``."""
from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import pytest
import torch

from repro_torch.configs import get_arch
from repro_torch.launch import dryrun, lowering
from repro_torch.launch.mesh import fake_process_group, make_host_mesh, make_production_mesh
from repro_torch.launch.shapes import ShapeSpec
from repro_torch.roofline.analysis import model_flops_estimate
from repro_torch.roofline.counting import counting
from test_torch_models import release_jax_executables  # noqa: F401 (autouse)

CELLS = [
    ("gemma3_12b", "train_4k", (2, 4)),
    ("jamba_1p5_large_398b", "decode_32k", (2, 4)),
    ("rwkv6_7b", "train_4k", (2, 4)),
    ("whisper_small", "prefill_32k", (2, 4)),
    ("arctic_480b", "train_4k", (2, 4)),
    ("internvl2_2b", "train_4k", (2, 2, 2)),
    ("llama4_maverick_400b_a17b", "train_4k", (2, 2, 2)),
]
# the hand-written kernels each cell's step must call (as meta stand-ins)
KERNELS = {
    "gemma3_12b": {"flash_attention", "flash_attention_bwd"},
    "jamba_1p5_large_398b": set(),      # decode: one token, no kernel
    "rwkv6_7b": {"rwkv6_scan", "rwkv6_scan_bwd"},
    "whisper_small": {"flash_attention"},
    "arctic_480b": {"flash_attention", "flash_attention_bwd"},
    "internvl2_2b": {"flash_attention", "flash_attention_bwd"},
    "llama4_maverick_400b_a17b": {"flash_attention", "flash_attention_bwd"},
}


def smoke(name: str):
    """The architecture with its smoke config and 2 microbatches, as the
    reference's ``test_dryrun_small.py`` shrinks it."""
    arch = get_arch(name)
    return dataclasses.replace(arch, model=arch.smoke, train_microbatches=2)


def _mesh(shape):
    return make_host_mesh(*shape[-2:], pod=shape[0] if len(shape) == 3 else 0)


@pytest.mark.parametrize("name,shape,mesh", CELLS, ids=[f"{a}-{s}" for a, s, _ in CELLS])
def test_smoke_cells_lower_on_a_fake_mesh(name, shape, mesh):
    arch = smoke(name)
    with fake_process_group(8):
        low = lowering.lower_cell(arch, shape, _mesh(mesh))
    assert low.chips == 8
    assert low.flops > 0 and low.bytes > 0 and low.peak_bytes > 0 and low.ops > 0
    # an FSDP + TP mesh moves data in every step
    assert low.collective_bytes > 0
    assert set(low.kernels) == KERNELS[name]
    n_params = sum(p.numel() for p in lowering.model_axes_and_shapes(arch.model)[1].values())
    useful = model_flops_estimate(arch, shape, n_params) / (low.flops * low.chips)
    assert 0 < useful <= 1


def _fsdp_arithmetic(arch, mesh):
    """(count, result bytes, wire bytes) of the all-gathers that gather
    every parameter sharded over ``"data"`` to its compute placements,
    from the placements ``shardings_of`` gives."""
    from torch.distributed.tensor import Shard

    axes, shapes = lowering.model_axes_and_shapes(arch.model)
    place = lowering.shardings_of(axes, shapes, mesh, lowering.arch_rules(arch).param)
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    count, result, wire = 0, 0.0, 0.0
    for name, t in shapes.items():
        pl = place[name]
        data = [i for i, p in enumerate(pl) if isinstance(p, Shard)
                and mesh.mesh_dim_names[i] == "data"]
        if not data:
            continue
        local = t.numel() * t.element_size()
        for i, p in enumerate(pl):     # the model shard stays
            if isinstance(p, Shard) and mesh.mesh_dim_names[i] == "model":
                local //= sizes["model"]
        n = sizes["data"]
        count, result, wire = count + 1, result + local, wire + local * (n - 1) / n
    return count, result, wire


@pytest.mark.parametrize("name", ["phi3_mini_3p8b", "gemma3_12b"])
def test_fsdp_gathers_equal_the_placements_arithmetic(name):
    """Entering ``gathered_params`` (a train step does once a microbatch)
    all-gathers each parameter sharded over ``"data"`` to its compute
    placements: one all-gather each, the result and wire bytes of the
    placements; a whole step does it once for each of its microbatches,
    and its other all-gathers are the activations'."""
    from repro_torch.parallel.sharding import gathered_params, shard_params
    from repro_torch.runtime.steps import model_init

    arch = smoke(name)
    with fake_process_group(8):
        mesh = make_host_mesh(4, 2)
        params = model_init(arch.model, device="meta")
        shard_params(params, lowering.model_axes_and_shapes(arch.model)[0], mesh,
                     lowering.arch_rules(arch))
        with counting(params) as c, gathered_params(params):
            pass
        want = _fsdp_arithmetic(arch, mesh)
        step = lowering.lower_train(arch, ShapeSpec("t", "train", 64, 16), mesh)
    ag = c.collectives["all-gather"]
    assert (ag["count"], ag["result_bytes"]) == want[:2]
    assert ag["wire_bytes"] == pytest.approx(want[2], rel=1e-12)
    assert sum(v["count"] for k, v in c.collectives.items() if k != "all-gather") == 0
    M = arch.train_microbatches
    assert step.collectives["all-gather"]["count"] >= M * want[0]
    assert step.collectives["all-gather"]["result_bytes"] >= M * want[1]


REFERENCE = textwrap.dedent(
    """
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import dataclasses, json, sys
    import jax
    from repro.configs.registry import get_arch
    from repro.launch.lowering import lower_cell
    from repro.roofline import hlo_stats

    arch = get_arch(sys.argv[1])
    arch = dataclasses.replace(arch, model=arch.smoke, train_microbatches=2)
    # an Auto mesh: jax.make_mesh's default Explicit axes are refused by
    # the reference's with_sharding_constraint under jax 0.9
    mesh = jax.make_mesh((2, 4), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)
    text = lower_cell(arch, sys.argv[2], mesh).compile().as_text()
    flops = hlo_stats.analyze_hlo(text, chips=8).flops
    hlo_stats._ELTWISE_1FLOP = frozenset()     # the products alone
    print(json.dumps({"flops": flops,
                      "dot_flops": hlo_stats.analyze_hlo(text, chips=8).flops}))
    """
)


def _reference(name: str, shape: str) -> dict:
    env = dict(os.environ, PYTHONPATH="src", JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", REFERENCE, name, shape], capture_output=True,
                       text=True, env=env, cwd=os.getcwd(), timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


# (cell, the band of the port's per-device FLOPs over the reference's
# HLO FLOPs, over its products alone). The reference counts one FLOP an
# element of every elementwise op (torch's formulas count the products
# alone) and its attention computes whole blocks, masked positions
# included (the port's kernels count the visible pairs): PERF.md §6
# names both terms.
COMPARED = [
    (("gemma3_12b", "train_4k"), (0.45, 0.8), (0.45, 0.85)),
    (("phi3_mini_3p8b", "decode_32k"), (0.35, 0.65), (0.95, 1.05)),
]


@pytest.mark.parametrize("cell,band,dot_band", COMPARED, ids=[c[0][0] for c in COMPARED])
def test_port_flops_against_the_reference_hlo_count(cell, band, dot_band):
    ref = _reference(*cell)
    with fake_process_group(8):
        low = lowering.lower_cell(smoke(cell[0]), cell[1], make_host_mesh(2, 4))
    assert band[0] <= low.flops / ref["flops"] <= band[1], (low.flops, ref)
    assert dot_band[0] <= low.flops / ref["dot_flops"] <= dot_band[1], (low.flops, ref)


def test_lowering_over_256_and_512_ranks():
    """``lower_train`` and ``lower_decode`` at published width over the
    production meshes; the multi-pod step moves half the single pod's
    tokens a device and adds the pods' gradient sums."""
    arch = get_arch("internvl2_2b")
    out = {}
    for multi in (False, True):
        with fake_process_group(512 if multi else 256):
            mesh = make_production_mesh(multi_pod=multi)
            out[multi] = lowering.lower_cell(arch, "decode_32k", mesh)
    single, multi = out[False], out[True]
    assert (single.chips, multi.chips) == (256, 512)
    assert 0.4 < multi.flops / single.flops < 0.6
    for low in (single, multi):
        assert low.flops > 0 and low.collective_bytes > 0
        # every group of these meshes crosses nodes of 8 ranks
        assert low.link_bytes["intra"] == 0 and low.link_bytes["inter"] == low.collective_bytes
    assert not torch.distributed.is_initialized()


def test_lowering_a_single_device_step_needs_no_group():
    """No mesh: one device, no DTensor, no collective; the record counts
    the attention kernels of every layer's forward, its recomputation and
    its backward."""
    arch = smoke("phi3_mini_3p8b")
    low = lowering.lower_train(arch, ShapeSpec("t", "train", 64, 4))
    assert low.chips == 1 and low.collective_bytes == 0
    L, M = arch.model.n_layers, arch.train_microbatches
    assert low.kernels["flash_attention"]["calls"] == 2 * L * M
    assert low.kernels["flash_attention_bwd"]["calls"] == L * M


def test_a_fake_group_is_refused_inside_another_and_destroyed_after():
    with fake_process_group(4):
        with pytest.raises(RuntimeError, match="already"):
            with fake_process_group(4):
                pass
    assert not torch.distributed.is_initialized()


def test_dryrun_report_renders_through_the_reference_renderer(tmp_path, capsys):
    from benchmarks.roofline_report import render, summarize

    report = tmp_path / "dryrun.json"
    dryrun.main(["--arch", "whisper_small", "--shape", "decode_32k", "--mesh", "both",
                 "--report", str(report)])
    rows = json.loads(report.read_text())
    assert [(r["mesh"], r["status"]) for r in rows] == [("single", "ok"), ("multi", "ok")]
    for r in rows:
        # XLA's analyses have no counterpart: their keys are left out
        assert not {"cost_analysis_flops", "cost_analysis_bytes", "hlo_bytes",
                    "t_compile_s"} & set(r)
        assert r["fits_hbm"] and r["useful_flops_fraction"] <= 1
    for mesh in ("single", "multi"):
        table = render(str(report), mesh)
        assert "| whisper_small | decode_32k | ok |" in table
    assert summarize(str(report)).startswith("2 cells: 2 compiled ok")
    # a skipped cell, and an error exits 1 as the reference's CLI does
    assert dryrun.run_cell("phi3_mini_3p8b", "long_500k", "single")["status"] == "skipped"
    with pytest.raises(SystemExit) as e:
        dryrun.main(["--arch", "no_such_arch", "--shape", "train_4k", "--report",
                     str(tmp_path / "bad.json")])
    assert e.value.code == 1
    assert "1 errors" in capsys.readouterr().out
