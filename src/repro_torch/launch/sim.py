"""Simulator CLI: run Eudoxia from a TOML file (paper §4.1.1) with
visual output, on CUDA unless ``--device cpu`` is given.

    PYTHONPATH=src python -m repro_torch.launch.sim examples/project.toml \
        [--engine event|python] [--csv out.csv] [--json out.json] [--device cpu]

The same output as ``python -m repro.launch.sim`` from equal states.
"""
from __future__ import annotations

import argparse
import json
import pathlib

from repro_torch.core import run
from repro_torch.core.viz import (
    latency_histogram,
    per_priority_table,
    timeline_csv,
    utilization_timeline,
)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("paramfile")
    ap.add_argument("--engine", default=None,
                    choices=[None, "event", "python"])
    ap.add_argument("--csv", default=None,
                    help="write the utilisation timeline as CSV")
    ap.add_argument("--json", default=None, help="write the summary JSON")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the run (default cuda; cpu runs the "
                         "kernels' plain PyTorch versions)")
    args = ap.parse_args(argv)

    res = run(args.paramfile, engine=args.engine, device=args.device)
    s = res.summary()
    print("== summary ==")
    for k in ("submitted", "done", "failed", "throughput_per_s",
              "mean_latency_s", "p99_latency_s", "cpu_utilization",
              "oom_events", "preempt_events", "cost_dollars"):
        print(f"  {k:18s} {s[k]}")
    print("\n== per priority ==")
    print(per_priority_table(res))
    print("\n== utilisation ==")
    print(utilization_timeline(res))
    print("\n== latency distribution ==")
    print(latency_histogram(res))
    if args.csv:
        pathlib.Path(args.csv).write_text(timeline_csv(res))
        print(f"\nwrote {args.csv}")
    if args.json:
        pathlib.Path(args.json).write_text(json.dumps(s, indent=1))
        print(f"wrote {args.json}")


if __name__ == "__main__":
    main()
