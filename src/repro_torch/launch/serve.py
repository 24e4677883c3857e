"""Serving entry point: simulator-evaluated policy + continuous batching, a
port of ``repro.launch.serve``.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6_7b \
        --requests 12 --slots 4 [--device cpu]

1. Builds a synthetic request trace (mixed interactive/batch).
2. Replays it in the simulator under each candidate scheduling policy
   (paper §4) and picks the winner.
3. Serves the trace through the continuous batcher (smoke config) with
   that policy.

Everything runs on ``--device`` (CUDA unless the caller asks for the
CPU, where the kernels' plain versions run).
"""
from __future__ import annotations

import argparse
import json

import numpy as np

from ..configs.registry import get_arch
from ..models import lm
from ..serving.batching import ContinuousBatcher, Request
from ..serving.bridge import ServeRequest, evaluate_policies, pick_policy


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="rwkv6_7b")
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    arch = get_arch(args.arch)
    cfg = arch.smoke
    rng = np.random.default_rng(args.seed)

    # ---- 1. synthetic trace --------------------------------------------
    trace = [
        ServeRequest(
            arrival_s=float(rng.exponential(0.3) * i),
            prompt_tokens=int(rng.integers(8, 24)),
            new_tokens=args.max_new,
            interactive=bool(rng.random() < 0.4),
        )
        for i in range(args.requests)
    ]

    # ---- 2. policy evaluation in the simulator ---------------------------
    sim = evaluate_policies(trace, arch.model, duration_s=30.0, device=args.device)
    policy = pick_policy(sim)
    print("simulator policy comparison:")
    for name, s in sim.items():
        inter = s["per_priority"]["interactive"]
        print(
            f"  {name:14s} thr={s['throughput_per_s']:7.2f}/s "
            f"inter_lat={inter['mean_latency_s']!s:>10} "
            f"pre={s['preempt_events']} oom={s['oom_events']}"
        )
    print(f"-> selected policy: {policy}")

    # ---- 3. real serving under the chosen policy -------------------------
    params = lm.lm_init(cfg, 0, device=args.device)
    batcher = ContinuousBatcher(cfg, params, slots=args.slots, max_len=64, policy=policy)
    for i, r in enumerate(trace):
        toks = rng.integers(2, cfg.vocab, size=r.prompt_tokens).astype(np.int32)
        batcher.submit(Request(rid=i, tokens=toks, max_new=r.new_tokens,
                               interactive=r.interactive))
    done = batcher.run_to_completion()
    print(json.dumps({
        "served": len(done),
        "policy": policy,
        "sample_output_lens": [len(r.out) for r in done[:8]],
    }))


if __name__ == "__main__":
    main()
