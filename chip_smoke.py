#!/usr/bin/env python3
"""Drive the PyTorch / CUDA port of the simulator (``src/repro_torch``)
on one NVIDIA GPU, and check it.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. the card (name and power limit from nvidia-smi), compute capability
   9.0, TF32 off for matmul and cuDNN;
2. build the CUDA kernels from ``src/repro_torch/csrc`` (into
   ``build/repro_torch/``);
3. each kernel against its plain PyTorch version on the card, at the
   main path's shapes: exact agreement, and the time of both;
4. ``run(SimParams())`` (the paper's default cluster, ``priority``) on
   CUDA and on the CPU through the plain versions, compared field by
   field;
5. ``fleet_run`` of 64 seeds at the engine-throughput configuration,
   on CUDA and on the CPU, compared lane by lane;
6. the kernel launches of phases 4 and 5, each of which must be > 0.

The last two lines of standard output are a JSON object with one entry
per kernel and ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import pathlib
import statistics
import subprocess
import sys
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# H100 SXM data sheet: HBM3 rate and the f32 / int32 rate of the CUDA
# cores (the kernels do no tensor-core work)
HBM_BYTES_PER_S = 3.35e12
CORE_OPS_PER_S = 67e12
F, MC, MP, K = 64, 64, 256, 16

# fields that are sums taken in another order than the reference's
# (stated tolerance rtol 1e-5); every other field must be equal exactly
TOLERANT_FIELDS = {
    "sum_latency_s", "sum_latency_s_prio", "util_cpu_s", "util_ram_s",
    "cost_dollars", "util_log",
}
RTOL = 1e-5


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    )
    return out.stdout.strip().splitlines()[0]


def timed_ms(fn, reps: int = 21, inner: int = 20) -> float:
    """Median over ``reps`` of the mean time per call of ``inner``
    back-to-back calls, from CUDA events on the current stream."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    samples = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        stop.record()
        stop.synchronize()
        samples.append(start.elapsed_time(stop) / inner)
    return statistics.median(samples)


def device_ms(fn, kernel: str, calls: int = 20):
    """Mean device time of the CUDA kernel named ``kernel`` over
    ``calls`` calls of ``fn``, from a torch.profiler trace (CUPTI);
    None when the trace holds no such kernel."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    total_us, count = 0.0, 0
    for evt in prof.key_averages():
        if kernel in evt.key:
            total_us += evt.device_time_total
            count += evt.count
    return total_us / count / 1e3 if count else None


def nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def max_abs_err(got, want) -> float:
    """Largest |got - want| over the outputs; raises unless every
    output is equal exactly (the kernels and the plain versions add in
    the same order)."""
    import torch

    err = 0.0
    for i, (a, b) in enumerate(zip(got, want)):
        if a.dtype != b.dtype or a.shape != b.shape:
            raise AssertionError(f"output {i}: {a.dtype}{tuple(a.shape)} vs {b.dtype}{tuple(b.shape)}")
        d = (a.double() - b.double()).abs().max().item() if a.numel() else 0.0
        err = max(err, d)
        if not torch.equal(a, b):
            raise AssertionError(f"output {i} differs from the plain version (max |diff| {d})")
    return err


# ---------------------------------------------------------------------------
# Phase 3 inputs: random tables at the main path's shapes, from a seed.
# ---------------------------------------------------------------------------
def tick_inputs(rng, dev, NP):
    import torch

    t = rng.integers(1_000, 90_000, F)
    status = rng.integers(0, 2, (F, MC))
    end = t[:, None] + rng.integers(-50, 50, (F, MC))
    oom = np.where(rng.random((F, MC)) < 0.3, t[:, None] + rng.integers(-50, 50, (F, MC)), 2**31 - 1)
    cpus = rng.choice([0.8, 1.6, 3.2, 6.4, 8.0], (F, MC))
    ram = rng.choice([1.6, 3.2, 6.4, 12.8, 16.0], (F, MC))
    pool = rng.integers(0, NP, (F, MC))
    pstatus = rng.integers(0, 7, (F, MP))
    arrival = t[:, None] + rng.integers(-100, 100, (F, MP))
    release = np.where(pstatus == 4, t[:, None] + rng.integers(-3, 3, (F, MP)), 2**31 - 1)

    def i32(x):
        return torch.tensor(x, dtype=torch.int32, device=dev)

    def f32(x):
        return torch.tensor(x, dtype=torch.float32, device=dev)

    return (i32(status), i32(end), i32(oom), f32(cpus), f32(ram), i32(pool),
            i32(pstatus), i32(arrival), i32(release), i32(t))


def retire_inputs(rng, dev):
    import torch

    t = rng.integers(10_000, 90_000, F)
    ctr_pipe = rng.integers(-1, MP // 8, (F, MC))   # duplicate pipelines
    ctr_end = t[:, None] - rng.integers(0, 5, (F, MC))
    ctr_start = ctr_end - rng.integers(1, 5_000, (F, MC))
    u = rng.random((F, MC))
    oomed = u < 0.2
    done = (u >= 0.2) & (u < 0.6)
    arrival = t[:, None] - rng.integers(5_000, 9_000, (F, MP))
    prio = rng.integers(0, 3, (F, MP))

    def i32(x):
        return torch.tensor(x, dtype=torch.int32, device=dev)

    def b(x):
        return torch.tensor(x, dtype=torch.bool, device=dev)

    return (i32(ctr_pipe), i32(ctr_end), i32(ctr_start), b(oomed), b(done),
            None, i32(arrival), i32(prio), i32(t))


def select_inputs(rng, dev, mixed: bool):
    import torch

    N = MP if mixed else MC
    mask = rng.random((F, N)) < 0.3
    mask[:4] = False                                  # empty lanes
    prio = rng.integers(0, 3, (F, N))
    ticks = rng.integers(0, 40, (F, N)) * 1_000       # ties
    mask_t = torch.tensor(mask, device=dev)
    if mixed:
        lead = torch.zeros((F, N), dtype=torch.float32, device=dev)
        keys = (lead, torch.tensor(-prio, dtype=torch.int32, device=dev),
                torch.tensor(ticks, dtype=torch.int32, device=dev))
    else:
        keys = (torch.tensor(prio, dtype=torch.int32, device=dev),
                torch.tensor(-ticks, dtype=torch.int32, device=dev))
    return mask_t, keys


def assign_inputs(rng, dev):
    import torch

    valid = rng.random((F, K)) < 0.6
    slot = np.stack([rng.permutation(MC)[:K] for _ in range(F)])
    pipe = np.stack([rng.permutation(MP)[:K] for _ in range(F)])
    t = rng.integers(0, 90_000, (F, 1))

    def i32(x):
        return torch.tensor(x, dtype=torch.int32, device=dev)

    return (
        torch.tensor(valid, device=dev), i32(slot), i32(pipe),
        i32(rng.integers(0, 3, (F, K))),
        torch.tensor(rng.choice([1.6, 3.2, 6.4], (F, K)), dtype=torch.float32, device=dev),
        torch.tensor(rng.choice([3.2, 6.4, 12.8], (F, K)), dtype=torch.float32, device=dev),
        i32(t + rng.integers(1, 9_000, (F, K))), i32(np.full((F, K), 2**31 - 1)),
        i32(rng.integers(0, 3, (F, K))),
        torch.tensor(rng.random((F, K)) < 0.5, device=dev),
        torch.zeros((F, K), dtype=torch.bool, device=dev),
    )


def check_kernels(dev) -> dict:
    """Phase 3: every kernel against its plain version; returns the
    per-kernel measurements for the JSON line."""
    import torch

    from repro_torch.kernels.sched_select import masked_lex_argmin, masked_lex_argmin_ref
    from repro_torch.kernels.sim_tick import fleet_tick, fleet_tick_ref
    from repro_torch.kernels.state_update import (
        assign_gather, assign_gather_ref, retire_land, retire_land_ref,
    )

    rng = np.random.default_rng(0)
    cases = []
    for NP in (1, 3):
        args = tick_inputs(rng, dev, NP)
        cases.append(("fleet_tick", f"NP={NP}",
                      lambda a=args, n=NP: fleet_tick(*a, num_pools=n),
                      lambda a=args, n=NP: fleet_tick_ref(*a, num_pools=n), args))
    args = retire_inputs(rng, dev)
    # timeout off: the landing reads ctr_pipe, ctr_end, the two masks,
    # arrival and prio (not ctr_start, timed or tick)
    cases.append(("retire_land", "", lambda a=args: retire_land(*a),
                  lambda a=args: retire_land_ref(*a),
                  (args[0], args[1], args[3], args[4], args[6], args[7])))
    for mixed in (False, True):
        mask, keys = select_inputs(rng, dev, mixed)
        label = "K=3 f32/i32/i32 N=MP" if mixed else "K=2 i32/i32 N=MC"
        cases.append(("masked_lex_argmin", label,
                      lambda m=mask, k=keys: masked_lex_argmin(m, k),
                      lambda m=mask, k=keys: masked_lex_argmin_ref(m, k),
                      (mask, *keys)))
    args = assign_inputs(rng, dev)
    kw = dict(max_containers=MC, max_pipelines=MP)
    cases.append(("assign_gather", "", lambda a=args: assign_gather(*a, **kw),
                  lambda a=args: assign_gather_ref(*a, **kw), args))

    results = {}
    for name, label, kernel, plain, ins in cases:
        got = kernel()
        torch.cuda.synchronize()
        want = plain()
        err = max_abs_err(got, want)
        ms = timed_ms(kernel)
        plain_ms = timed_ms(plain)
        dev_ms = device_ms(kernel, f"{name}_kernel")
        moved = nbytes(ins) + nbytes(got)
        elements = sum(x.numel() for x in ins)
        bound_bytes_ms = moved / HBM_BYTES_PER_S * 1e3
        # a few compares / selects per input element; no tensor-core work
        bound_ops_ms = 4 * elements / CORE_OPS_PER_S * 1e3
        dev_text = "not measured" if dev_ms is None else f"{dev_ms:.5f}"
        print(f"kernel {name} [{label}] exact max_abs_err={err} ms={ms:.5f} "
              f"(per wrapper call) device_ms={dev_text} (kernel alone, profiler) "
              f"plain_ms={plain_ms:.5f} bytes={moved} bound_ms={bound_bytes_ms:.6f} "
              f"(bytes / 3.35 TB/s; a launch alone takes a few microseconds)")
        prev = results.get(name)
        row = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
               "bound_ms": max(bound_bytes_ms, bound_ops_ms),
               "bound_by": "bytes" if bound_bytes_ms >= bound_ops_ms else "operations",
               "bytes": moved}
        # the heavier of a kernel's cases stands for it in the JSON line
        if prev is None or row["bytes"] > prev["bytes"]:
            results[name] = row
    return results


# ---------------------------------------------------------------------------
# Phases 4 and 5: the main path on CUDA against the CPU port.
# ---------------------------------------------------------------------------
def compare_states(cuda_state, cpu_state, ctx: str) -> None:
    for name in cuda_state._fields:
        a = getattr(cuda_state, name).cpu()
        b = getattr(cpu_state, name)
        if a.dtype != b.dtype or a.shape != b.shape:
            raise AssertionError(f"{ctx}: field {name} {a.dtype}{tuple(a.shape)} vs {b.dtype}{tuple(b.shape)}")
        if name in TOLERANT_FIELDS:
            if not np.allclose(a.numpy(), b.numpy(), rtol=RTOL, atol=0.0):
                raise AssertionError(f"{ctx}: field {name} beyond rtol {RTOL}")
        elif not np.array_equal(a.numpy(), b.numpy()):
            raise AssertionError(f"{ctx}: field {name} differs between CUDA and CPU")
        if a.is_floating_point() and not bool(a.isfinite().all()):
            raise AssertionError(f"{ctx}: field {name} is not finite")


def run_phase(dev) -> dict:
    import torch

    from repro_torch import SimParams, generate_workload, run
    from repro_torch.kernels import launch_counts, reset_launch_counts

    params = SimParams()
    wl = generate_workload(params)
    reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = run(params, wl, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts()
    ref = run(params, wl, device="cpu")
    compare_states(res.state, ref.state, "run(SimParams())")
    summary = res.summary()
    if summary["submitted"] <= 0 or summary["done"] <= 0:
        raise AssertionError(f"run(SimParams()) did no work: {summary}")
    print(f"phase 4: run(SimParams()) on {dev}: wall {wall:.3f} s, "
          f"{res.events} events, equal to the CPU port under the contract")
    print("phase 4 summary:", json.dumps(summary, sort_keys=True))
    print("phase 4 launches:", json.dumps(counts))
    return counts


def fleet_phase(dev) -> dict:
    import torch

    from repro_torch import SimParams, fleet_run, make_workload_batch
    from repro_torch.kernels import launch_counts, reset_launch_counts

    params = SimParams(
        duration=1.0, waiting_ticks_mean=5_000, op_base_seconds_mean=0.03,
        op_base_seconds_sigma=1.2, op_ram_gb_mean=2.0, max_pipelines=128,
        max_containers=64, scheduling_algo="priority",
    )
    seeds = list(range(64))
    wls = make_workload_batch(params, seeds)
    reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    states = fleet_run(params, workloads=wls, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts()
    ref = fleet_run(params, workloads=wls, device="cpu")
    compare_states(states, ref, "fleet_run(64 seeds)")
    done = states.done_count.cpu()
    if int(done.min()) <= 0:
        raise AssertionError("a fleet lane completed nothing")
    sim_s = len(seeds) * params.duration
    print(f"phase 5: fleet_run of {len(seeds)} lanes on {dev}: wall {wall:.3f} s, "
          f"{sim_s / wall:.3f} simulated s per wall s, done per lane "
          f"mean {float(done.float().mean()):.2f}, equal to the CPU port lane by lane")
    print("phase 5 launches:", json.dumps(counts))
    profile_fleet(params, wls, dev)
    return counts


def profile_fleet(params, wls, dev) -> None:
    """Where the fleet run's time goes: one more run under torch.profiler,
    its wall time against the summed device time of every CUDA kernel
    (the device's busy share), and the kernels that take the most."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import fleet_run

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fleet_run(params, workloads=wls, device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = [e for e in prof.key_averages()
            if str(getattr(e, "device_type", "")).endswith("CUDA")]
    if not rows:
        print("phase 5 profile: the trace holds no CUDA kernels; device busy share not measured")
        return
    busy_ms = sum(e.device_time_total for e in rows) / 1e3
    launches = sum(e.count for e in rows)
    print(f"phase 5 profile: wall {wall * 1e3:.1f} ms (under the profiler), device busy "
          f"{busy_ms:.1f} ms ({100 * busy_ms / (wall * 1e3):.1f}% of wall), "
          f"{launches} kernel launches")
    for e in sorted(rows, key=lambda e: -e.device_time_total)[:8]:
        print(f"  {e.device_time_total / 1e3:9.3f} ms  {e.count:6d}x  {e.key[:90]}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "drives the port on a GPU", file=sys.stderr)
        return 1
    from repro_torch.kernels import KERNELS, cuda_lib

    # ---- phase 1 -------------------------------------------------------
    print(gpu_line())
    cap = torch.cuda.get_device_capability(0)
    if cap != (9, 0):
        raise AssertionError(f"compute capability {cap}, the kernels are built for sm_90a")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"phase 1: {torch.cuda.get_device_name(0)} capability {cap}; "
          f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")
    dev = torch.device("cuda", 0)

    # ---- phase 2 -------------------------------------------------------
    t0 = time.perf_counter()
    lib = cuda_lib.build()
    print(f"phase 2: built {lib.relative_to(ROOT)} in {time.perf_counter() - t0:.2f} s")
    for line in lib.with_suffix(".log").read_text().splitlines():
        if "registers" in line or line.startswith("=="):
            print("  ptxas:", line.strip())

    # ---- phase 3 -------------------------------------------------------
    measured = check_kernels(dev)

    # ---- phases 4 and 5 ------------------------------------------------
    run_counts = run_phase(dev)
    fleet_counts = fleet_phase(dev)

    # ---- phase 6 -------------------------------------------------------
    for name in KERNELS:
        for phase, counts in (("run", run_counts), ("fleet_run", fleet_counts)):
            if counts[name] <= 0:
                raise AssertionError(f"{name} was not launched in the {phase} phase")
    print("kernels: " + ", ".join(KERNELS))

    sources = {
        "fleet_tick": ("src/repro_torch/csrc/sim_tick.cu",
                       "src/repro/kernels/sim_tick/kernel.py:80"),
        "retire_land": ("src/repro_torch/csrc/state_update.cu",
                        "src/repro/kernels/state_update/kernel.py:91"),
        "masked_lex_argmin": ("src/repro_torch/csrc/sched_select.cu",
                              "src/repro/kernels/sched_select/kernel.py:52"),
        "assign_gather": ("src/repro_torch/csrc/state_update.cu",
                          "src/repro/kernels/state_update/kernel.py:202"),
    }
    rows = []
    for name in KERNELS:
        m = measured[name]
        rows.append({
            "name": name, "route": "cuda", "source": sources[name][0],
            "replaces": sources[name][1],
            "launches": run_counts[name] + fleet_counts[name],
            "max_abs_err": m["max_abs_err"], "ms": m["ms"],
            "plain_ms": m["plain_ms"], "bound_ms": m["bound_ms"],
            "bound_by": m["bound_by"], "library_ms": None,
        })
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
