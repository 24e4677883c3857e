"""Multi-node dry run: one step of every (arch x shape x mesh) cell on
``meta`` tensors, a port of ``repro.launch.dryrun``.

The reference lowers and compiles each cell under 512 forced XLA host
devices and reads the compiled program. The port starts a fake process
group of the cell's world size (rank 0 of 256 or 512, one process,
``launch.mesh.fake_process_group``), builds the production mesh over it
and runs the step once on ``meta`` DTensors under
``roofline.counting`` (``launch.lowering.lower_cell``): nothing is
allocated, nothing is launched, no card is needed.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma3_12b \\
        --shape train_4k --mesh single
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both \\
        --report reports/dryrun_torch.json

Per cell it prints and records the peak of live bytes a device holds
(whether it fits the card's memory), the FLOPs, HBM bytes and collective
wire bytes a device handles, and the three-term roofline under the
H100's constants (``roofline.hw``). The record has the reference's keys
where the port has the quantity; XLA's ``cost_analysis`` and
``memory_analysis`` (``cost_analysis_*``, ``hlo_bytes``,
``t_compile_s``) have no counterpart and are left out, and
``t_lower_s`` is the seconds the step took to trace.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import traceback

from ..configs import get_arch, list_archs
from ..roofline.analysis import Roofline, model_flops_estimate
from ..roofline.counting import tensors_of
from ..roofline.hw import H100
from .lowering import lower_cell, model_axes_and_shapes
from .mesh import fake_process_group, make_production_mesh
from .shapes import SHAPES, cache_shapes

WORLD = {"single": 256, "multi": 512}


def _param_stats(cfg) -> tuple[int, int]:
    """(parameters, their bytes) of ``cfg``, drawn on ``meta``."""
    _, shapes = model_axes_and_shapes(cfg)
    return (sum(p.numel() for p in shapes.values()),
            sum(p.numel() * p.element_size() for p in shapes.values()))


def _cache_bytes(cfg, shape) -> int:
    return sum(t.numel() * t.element_size()
               for t in tensors_of(cache_shapes(cfg, shape.batch, shape.seq)))


def run_cell(arch_name: str, shape_name: str, mesh_kind: str) -> dict:
    arch = get_arch(arch_name)
    if shape_name in arch.skip:
        return {"arch": arch_name, "shape": shape_name, "mesh": mesh_kind, "status": "skipped",
                "reason": arch.skip[shape_name]}
    with fake_process_group(WORLD[mesh_kind]):
        mesh = make_production_mesh(multi_pod=mesh_kind == "multi")
        low = lower_cell(arch, shape_name, mesh)
    chips = low.chips

    n_params, param_bytes = _param_stats(arch.model)
    mf = model_flops_estimate(arch, shape_name, n_params)
    # minimal per-device HBM traffic: weights + (decode) caches, each
    # touched once: the lower bound of the memory term
    min_bytes = param_bytes / chips
    shape = SHAPES[shape_name]
    if shape.kind == "decode":
        min_bytes += _cache_bytes(arch.model, shape) / chips
    coll = {k: v["wire_bytes"] for k, v in low.collectives.items()}
    coll["_counts"] = {k: v["count"] for k, v in low.collectives.items()}
    coll["_result_bytes"] = {k: v["result_bytes"] for k, v in low.collectives.items()}
    coll["_link_bytes"] = dict(low.link_bytes)

    roof = Roofline(
        arch=arch_name, shape=shape_name, mesh=mesh_kind, chips=chips,
        flops_per_device=low.flops, bytes_per_device=low.bytes,
        collective_bytes_per_device=low.collective_bytes, collectives=coll, model_flops=mf,
        memory_per_device={"peak_bytes": low.peak_bytes}, link_bytes=low.link_bytes)
    rec = roof.to_dict()
    rec.update(
        status="ok",
        n_params=n_params,
        t_lower_s=round(low.t_trace_s, 2),
        peak_bytes_per_device=low.peak_bytes,
        fits_hbm=bool(low.peak_bytes <= H100.hbm_bytes),
        min_bytes_per_device=min_bytes,
        mem_efficiency=min_bytes / max(low.bytes, 1.0),
        kernels=low.kernels,
        ops=low.ops,
        hw=H100.name,
    )
    return rec


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(SHAPES) + [None])
    ap.add_argument("--mesh", default="single", choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--report", default=None)
    ap.add_argument("--append", action="store_true")
    args = ap.parse_args(argv)

    cells: list[tuple[str, str, str]] = []
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    if args.all:
        for a in list_archs():
            for s in get_arch(a).shapes:
                for m in meshes:
                    cells.append((a, s, m))
    else:
        if not (args.arch and args.shape):
            ap.error("give --arch and --shape, or --all")
        for m in meshes:
            cells.append((args.arch, args.shape, m))

    results = []
    report_path = pathlib.Path(args.report) if args.report else None
    if report_path and args.append and report_path.exists():
        results = json.loads(report_path.read_text())
        done = {(r["arch"], r["shape"], r["mesh"]) for r in results}
        cells = [c for c in cells if c not in done]

    for a, s, m in cells:
        print(f"=== {a} x {s} x {m} ===", flush=True)
        try:
            rec = run_cell(a, s, m)
        except Exception as e:  # noqa: BLE001 - record and continue
            rec = {"arch": a, "shape": s, "mesh": m, "status": "error",
                   "error": f"{type(e).__name__}: {e}", "trace": traceback.format_exc()[-2000:]}
        if rec["status"] == "ok":
            print(
                f"  traced in {rec['t_lower_s']}s | "
                f"peak/device {rec['peak_bytes_per_device'] / 2**30:.2f} GiB "
                f"(fits={rec['fits_hbm']}) | "
                f"t_comp {rec['t_compute_s'] * 1e3:.2f} ms "
                f"t_mem {rec['t_memory_s'] * 1e3:.2f} ms "
                f"t_coll {rec['t_collective_s'] * 1e3:.2f} ms "
                f"-> {rec['dominant']}-bound | "
                f"useful {rec['useful_flops_fraction'] * 100:.0f}% "
                f"roofline {rec['roofline_fraction'] * 100:.0f}%",
                flush=True,
            )
        else:
            print(f"  {rec['status']}: {rec.get('reason', rec.get('error'))}", flush=True)
        results.append(rec)
        if report_path:
            report_path.parent.mkdir(parents=True, exist_ok=True)
            report_path.write_text(json.dumps(results, indent=1))

    ok = sum(r["status"] == "ok" for r in results)
    sk = sum(r["status"] == "skipped" for r in results)
    er = sum(r["status"] == "error" for r in results)
    print(f"\n{ok} ok / {sk} skipped / {er} errors")
    if er:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
