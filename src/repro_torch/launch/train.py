"""End-to-end training launcher, a port of ``repro.launch.train``.

    PYTHONPATH=src python -m repro_torch.launch.train --arch gemma3_12b \
        --steps 200 --smoke --ckpt-dir /tmp/ckpt --ckpt-every 50 [--device cpu]

Runs the reduced (smoke) config of any architecture, or the full one
with ``--no-smoke``, for ``--steps`` steps with checkpoints, failure
injection and straggler monitoring, on ``--device`` (CUDA unless the
caller asks for the CPU, where the kernels' plain versions run), and
prints the JAX launcher's closing JSON.

With ``--mesh-data n`` (and ``--mesh-model m``) it trains over an
(n, m) ``("data", "model")`` mesh of n * m ranks, one process a rank,
as ``torchrun`` starts them:

    PYTHONPATH=src torchrun --nproc-per-node 2 -m repro_torch.launch.train \
        --arch phi3_mini_3p8b --device cpu --mesh-data 2 --steps 20

The process group comes from torchrun's environment: ``gloo`` on the
CPU, ``nccl`` on the cards (each rank on card ``LOCAL_RANK``). Rank 0
prints the JSON.
"""
from __future__ import annotations

import argparse
import json
import os

from ..configs.registry import get_arch
from ..runtime.failures import FailureInjector
from ..runtime.train_loop import run_training


def _mesh(data: int, model: int, device: str):
    """The (data, model) mesh over torchrun's ranks (the process group
    started here unless the caller started it); returns (mesh, device of
    this rank)."""
    import torch
    import torch.distributed as dist

    from .mesh import make_host_mesh

    on_cpu = torch.device(device).type == "cpu"
    if not on_cpu:
        local = int(os.environ.get("LOCAL_RANK", 0))
        torch.cuda.set_device(local)
        device = f"cuda:{local}"
    if not dist.is_initialized():
        dist.init_process_group("gloo" if on_cpu else "nccl")
    return make_host_mesh(data=data, model=model), device


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--no-smoke", dest="smoke", action="store_false")
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=0)
    ap.add_argument("--inject-failures", action="store_true")
    ap.add_argument("--mesh-data", type=int, default=0,
                    help="train over a (data, model) mesh of this data size (under torchrun)")
    ap.add_argument("--mesh-model", type=int, default=1)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    mesh, device = None, args.device
    if args.mesh_data:
        mesh, device = _mesh(args.mesh_data, args.mesh_model, args.device)
    injector = (FailureInjector(mtbf_steps=args.steps / 3, max_failures=2)
                if args.inject_failures else None)
    result = run_training(
        get_arch(args.arch),
        steps=args.steps,
        mesh=mesh,
        use_smoke_config=args.smoke,
        global_batch=args.global_batch,
        seq_len=args.seq_len,
        ckpt_dir=args.ckpt_dir,
        ckpt_every=args.ckpt_every,
        injector=injector,
        microbatches=args.microbatches,
        on_metrics=lambda s, m: (
            print(f"step {s:5d} loss {m['loss']:.4f} ({m['dt']*1e3:.0f} ms)")
            if s % 10 == 0 and _rank() == 0 else None
        ),
        device=device,
    )
    if _rank() == 0:
        print(json.dumps({
            "arch": args.arch,
            "steps_done": result.steps_done,
            "first_loss": result.losses[0] if result.losses else None,
            "last_loss": result.losses[-1] if result.losses else None,
            "restarts": result.restarts,
            "straggler_events": result.straggler_events,
        }, indent=1))


def _rank() -> int:
    import torch.distributed as dist

    return dist.get_rank() if dist.is_initialized() else 0


if __name__ == "__main__":
    main()
