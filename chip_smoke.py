#!/usr/bin/env python3
"""Drive the PyTorch / CUDA port (``src/repro_torch``) on one NVIDIA GPU,
and check it: the simulator's main path, serving every architecture of
``configs/`` at its published width under the policy the simulator
picks, and the paper's surface (``eudoxia_torch``, the Python engine,
the CLI).

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. the card (name and power limit from nvidia-smi), compute capability
   9.0, TF32 off for matmul and cuDNN;
2. build the CUDA kernels from ``src/repro_torch/csrc`` (into
   ``build/repro_torch/``); ptxas's registers and spills (``fleet_tick``,
   ``masked_lex_argmin`` and ``assign_gather`` must not spill) and a SASS
   mix;
3. each kernel against its plain PyTorch version on the card: the
   simulator's four at the main path's shapes, exactly, and
   ``retire_land`` also with its timeout branch on (beside the
   timeout-off case in its JSON row), ``masked_lex_argmin`` and
   ``fleet_tick`` also on edge keys (NaN,
   signed zeros, infinities, keys at their sentinels), real f32 leads,
   ragged and unaligned rows, 4,096 lanes, ragged runs of containers and
   8 pools, ``masked_lex_argmin`` at the SJF key set (``select_sjf``)
   and with f32 leads that differ from lane to lane, exactly, and
   ``assign_gather`` on an edge grid (K past a
   warp, past MC and past the block's 128 threads, MC / MP not
   multiples of 4, indices out of range, rows sharing a slot or a pipe,
   4,096 lanes), exactly; the card's launch floor (``torch.Tensor.fill_`` of one
   element) beside them, and ``assign_gather``'s host time a call step
   by step; ``rwkv6_scan``,
   ``flash_attention`` and ``ssm_scan`` at rwkv6_7b's, gemma3_12b's and
   jamba's prefill shapes (``ssm_scan`` at 2048 tokens, a ragged 2000
   and the served prompt's 1838), bf16 outputs to 2e-2 and f32 states
   to 2e-4, ``flash_attention``'s also in norm (|diff| <= 2e-2
   |plain|); ``flash_attention`` also at the rest of the zoo's shapes
   (``ZOO_ATTENTION``: phi3's head dim 96, granite's 48 heads on one KV
   head against its cache, whisper's non-causal encoder at 8 x 1,500
   and 1 x 32,768 frames, the plain version on the first 2,048 queries
   of the latter, and its cross-attention of 4 and 1 queries against
   1,500 frames); the training backward ``flash_attention_bwd``
   (``TRAIN_ATTENTION``: gemma3_12b's 2,048 causal with a window of 1,024
   and without, phi3's 4,096 causal, whisper's encoder and its
   cross-attention of 187 queries against 1,500 frames, bf16 to 2e-2
   elementwise and in norm; the cross-attention in f32 to 2e-4) against
   ``flash_attention_bwd_ref`` on the forward kernel's own out and
   ``lse``, that ``lse`` first held to the plain forward's to 2e-4, the
   library's time PyTorch's SDPA backward with the same mask;
   the time of each call, its device time per call (summed over the
   kernel's launches, with the launches per call), of its plain version
   and, for attention, of PyTorch's ``scaled_dot_product_attention``;
   for the LM kernels the achieved TFLOP/s and the share of the bound;
4. ``run(SimParams())`` (the paper's default cluster, ``priority``) on
   CUDA and on the CPU through the plain versions, compared field by
   field;
5. ``fleet_run`` of 64 seeds at the engine-throughput configuration,
   on CUDA and on the CPU, compared lane by lane;
5b. phase 5's fleet replayed from trace files: each lane's workload
   written as JSON records (``workload_to_trace_records``) and read
   back (``workload_batch_from_traces``), bit-equal to phase 5's batch;
   the replayed ``fleet_run`` on CUDA equal to phase 5's CUDA states on
   every field, ``run(trace_path=lane_0.json)`` equal to lane 0,
   ``shard="auto"`` equal to the unsharded run, ``fleet_summary`` equal
   to the CPU port's under the contract;
5c. the data plane at ``benchmarks/scheduler_comparison.py``'s
   ``cache_sensitivity`` (cut from 2 s to 1 s, two pools, MP 256, MC 64, 2 GB outputs,
   scan 50 ticks/GB, cold start 100 ticks, warm 50,000, seed 11, one
   shared workload) at 8 GB of cache a pool: ``run`` under ``naive``,
   ``priority_pool``, ``cache_aware``, ``locality_pool`` and ``sjf`` on
   CUDA against the CPU port; cache hits under ``cache_aware``, cold and
   warm starts over the five; ``cache_aware`` profiled with the cache on
   and off over the first 0.5 s (launches per event, the device's busy
   share);
5d. the policy grid: ``policy_grid_workloads`` of the six named points
   over seeds 0-7 (48 lanes) at phase 5's configuration with two pools
   and phase 5c's data plane; ``fleet_run(scheduler_key="policy")`` on
   CUDA bit-equal, lane for lane, to the six named 8-lane fleets on
   CUDA, and one seed per point against the CPU port;
5e. telemetry: (a) phase 5's 64-lane fleet with ``trace=True`` on CUDA,
   its states bit-equal to phase 5's untraced CUDA states, lanes 0-7's
   records, counts and ``dropped`` equal to the CPU port's traced run,
   every kernel launched as often as in phase 5 but ``masked_lex_argmin``,
   which adds the decision provenance's one launch an event; (b) 8 lanes
   of phase 6b's chaos fleet and 8 ``retry_storm`` lanes of phase 6c
   (b)'s ``queue_threshold`` arm (phase 6c (a)'s knobs shed nothing),
   traced on CUDA, each equal to its CPU run, with FAULT, RETRY,
   POOL_DOWN and ADMIT_REJECT / CLIENT_RETRY records among them; (c)
   ``summarize_timeline`` and ``to_perfetto_json`` of lane 0 reconciled
   with ``summarize``; events, records a lane, dropped, wall, simulated
   s per wall s, device kernels an event and busy share beside phase
   5's;
6. the simulator kernels' launches in phases 4 and 5, each > 0;
6b. the chaos layer at phase 5's configuration with two pools,
   ``priority_pool`` and crashes, outages, stragglers, timeouts and
   retries on: ``run`` at seed 0 and the 64-lane ``fleet_run`` on CUDA
   against the CPU port, every fault class firing over the fleet,
   ``retire_land`` launched with its timeout branch; wall time,
   simulated s per wall s, launches and the device's busy share beside
   phase 5's;
6c. the overload layer: (a) phase 5's 64-lane fleet with closed-loop
   clients (at most 6 in flight, 200 ticks of think time, 3 retries at
   200 ticks of backoff) and a queue threshold of 4
   (``benchmarks/engine_throughput.py``'s closed-loop row) on CUDA, its
   first 8 lanes against the CPU port; wall, simulated s per wall s,
   device kernels an event and busy share beside phase 5's; offers,
   admissions and defers above 0, sheds and client retries printed (0:
   the client cap keeps the threshold from binding); (b)
   ``benchmarks/scheduler_comparison.py``'s ``overload_comparison``: 8
   ``retry_storm`` lanes (seed 11, surge 6, a 0.06 s tape in 0.08 s, two
   early outages, clients that retry 3 times) under ``admit_all``,
   ``queue_threshold``, ``token_bucket`` and ``codel``, on the JAX
   package's fault traces (``tests/captures/torch_overload_reference.json``),
   each arm on CUDA with its first 2 lanes against the CPU port and its
   row (offered, admitted, shed, deferred, client retries, goodput,
   drained and metastable lanes) equal to the reference's from the same
   file; every lane whose fault trace starts an outage inside the
   horizon saw it, ``admit_all`` shed nothing at amplification 1.0,
   ``queue_threshold`` shed and retried,
   ``token_bucket`` deferred, every simulator kernel launched; the
   drained and metastable lanes printed;
7. serving rwkv6_7b at full width (random weights from a seed):
   ``evaluate_policies`` on CUDA picks the policy, then a 4-slot
   ``ContinuousBatcher`` serves 8 requests of 512-2048 prompt tokens;
   every request served, every logit finite, ``rwkv6_scan`` launched;
8. the same for gemma3_12b (``max_len`` 4096, prompts past the
   1024-token window), ``flash_attention`` launched;
9. the smoke configs in f32 on CUDA and on the CPU port, equal greedy
   tokens, prefill logits within 2e-4: the nine decoder-only ones
   through the batcher, internvl2_2b once more through ``lm_prefill``
   with patch embeddings, whisper_small through
   ``runtime.make_serve_steps``;
10. the same as 7 for jamba_1p5_large_398b at full width, cut to the first
   five layers of its period (one H100 holds five, not 72), with
   ``ssm_scan`` and ``flash_attention`` launched;
11. policy search: ``benchmarks/policy_search.py``'s ``search_smoke``
   (its ``SEARCH_PARAMS`` arena, ``scenario_factory(["bursty"], arena,
   4, seed=7)``, ``cem_search(seed=3, generations=1, population=12,
   rungs=(0.5, 1.0))``) on CUDA and on the CPU port: the same candidate
   history and front, the objectives under the contract, every baseline
   weakly dominated by a front member; wall, evaluations, candidates/s,
   lane evaluations/s, front size and the simulator kernels' launches;
12. the paper's surface: (a) Listing 3,
   ``eudoxia_torch.run_simulator("examples/project.toml")`` on CUDA (2 s,
   two pools, MP 256, MC 64, ``cache_aware``, 8 GB of cache a pool),
   every simulator kernel launched, held to ``run(engine="python")`` of
   the same file; (b) the reference Python engine (host code, no kernel
   launched) against the card's event engine on the reference's compared
   fields (``tests/test_engine_equivalence.py``; its tolerant fields at
   rtol 1e-3): phase 5c's five CUDA runs and a new ``priority`` run on
   its workload, 6b's chaos ``run(seed 0)``, lane 0 of 6c (a)'s
   closed-loop fleet (the closed-loop fields too) and, under
   ``"policy"``, each of 5d's six points against its seed-0 lane; (c)
   Listing 4's smallest-job-first scheduler of
   ``examples/custom_scheduler.py``, registered through
   ``eudoxia_torch.algorithm``, on the Python engine at 5c's
   configuration, its summary beside ``priority``'s on CUDA; (d)
   ``python -m repro_torch.launch.sim`` as a subprocess on CUDA on
   ``project.toml`` cut to 0.5 s: exit 0, its four renderings and CSV
   non-empty, its ``--json`` equal to the in-process run under the
   contract; each Python-engine run's wall and events beside the
   card's wall for the same run;
13. the same as 7 for the five text configs at their published widths:
   gemma3_27b, granite_34b and phi3_mini_3p8b whole, arctic_480b cut to
   two layers and llama4_maverick_400b_a17b to four (one 128-expert
   layer is 26.8 and 32.2 GB), ``flash_attention`` launched for each;
   profiled for arctic and llama4 only (the dense three's windows cost
   most of the phase's wall under the profiler);
14. internvl2_2b at full size: (a) as 7; (b) 4 requests whose first 256
   positions are patch embeddings [4, 256, 1024] from a numpy seed, a
   1,024-position ``lm_prefill`` and 16 greedy steps, every logit
   finite, the prefill logits moving with the embeddings;
15. whisper_small at full size through ``runtime.make_serve_steps``: 8
   clips of 1,500 frames (32 greedy steps) and one of 32,768 (16
   steps); encoder, prefill and step times, peak memory, every logit
   finite, the encoder's and every cross-attention call's
   ``flash_attention`` launched without the causal mask;
16. training: (a) phi3_mini_3p8b whole (32 layers, d 3,072, bf16
   parameters, AdamW with f32 state) through ``make_train_step``, 5
   steps at 4 x 4,096 tokens of ``SyntheticLM(seed=0)`` in 4
   microbatches; (b) whisper_small whole, 3 steps of ``encdec_loss`` on
   8 clips of 1,500 frames and 187 decoder tokens; each with step ms,
   tokens/s, peak GiB, the device's busy share of one more step under
   the profiler, ``flash_attention``'s and ``flash_attention_bwd``'s
   shares of its device time and the model-FLOP share of the bf16 peak;
   finite losses and norms, parameters that changed; (c) every smoke
   config in f32, 2 steps of 2 microbatches on the card against the CPU
   port (losses and gradient norms to 1e-4; Adafactor, bf16 optimizer
   state and the MoE's load-balance loss on the card); rwkv6_7b and jamba
   raise, naming ROADMAP item 15 (d); (d) phi3's smoke config through
   ``run_training`` with a checkpoint every 2 steps and an injected
   failure, under deterministic algorithms: the resumed run's losses
   bit-equal to an uninterrupted run's.

Without a card, or from a directory that holds this script and nothing
else of the repository, it prints why and exits 1 before any phase.

Every phase prints its wall time, and every line with a measurement
names the card and its power limit. The last two lines of standard
output are a JSON object with one entry per kernel and
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import copy
import dataclasses
import gc
import json
import math
import pathlib
import re
import statistics
import subprocess
import sys
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# H100 SXM data sheet: HBM3 rate, the f32 / int32 rate of the CUDA cores
# and the dense bf16 tensor-core rate; the special-function units' exp
# rate, 16 per SM per clock on 132 SMs at the 1.98 GHz boost clock
HBM_BYTES_PER_S = 3.35e12
CORE_OPS_PER_S = 67e12
BF16_TENSOR_OPS_PER_S = 989e12
SFU_EXP_PER_S = 16 * 132 * 1.98e9
F, MC, MP, K = 64, 64, 256, 16

# fields that are sums taken in another order than the reference's
# (stated tolerance rtol 1e-5); every other field must be equal exactly
TOLERANT_FIELDS = {
    "sum_latency_s", "sum_latency_s_prio", "util_cpu_s", "util_ram_s",
    "cost_dollars", "util_log", "pool_down_s",
}
# the chaos layer's knobs (phase 6b): tools/record_telemetry_capture.py's
# CHAOS set, scaled to a 1 s horizon
CHAOS = dict(
    crash_mtbf_ticks=5_000.0, outage_mtbf_ticks=20_000.0, outage_duration_ticks=5_000.0,
    straggler_prob=0.15, straggler_factor=4.0, timeout_ticks=10_000, max_retries=3,
    base_backoff_ticks=500,
)
RTOL = 1e-5
# the data plane of phases 5c and 5d: benchmarks/scheduler_comparison.py's
# cache_sensitivity at 8 GB of cache a pool
DATA_PLANE = dict(
    op_out_gb_mean=2.0, scan_ticks_per_gb=50.0, cold_start_ticks=100,
    container_warm_ticks=50_000, cache_gb_per_pool=8.0,
)
# the LM kernels against their plain versions: bf16 outputs 2e-2 (an
# ulp of bf16 apart after sums in another order), f32 2e-4
LM_TOL = {"bf16": 2e-2, "f32": 2e-4}
# flash_attention's bf16 outputs also in norm, |got - plain| <= 2e-2
# |plain| (the rule of tests/test_torch_models.py): attention over many
# keys averages its values down (an output of about 0.009 at 32,768 keys),
# below the elementwise 2e-2 (1 + |plain|), while a kernel that leaves
# out even one 128-key tile there moves the outputs by more than this
ATTN_NORM_TOL = 2e-2
# the card's name and power limit (nvidia-smi), set by phase 1, named
# beside every measurement
CARD = "card not read"


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
    """Device time per call of ``fn`` of the CUDA kernels whose names
    hold ``kernel`` (summed over every launch of a call: a kernel of two
    passes launches two), their launches per call, and the time per
    call of each such kernel by name, over ``calls`` calls, from a
    torch.profiler trace (CUPTI); (None, 0, {}) when the trace holds no
    such kernel."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    per_kernel = {evt.key: evt.device_time_total / calls / 1e3
                  for evt in prof.key_averages() if kernel in evt.key}
    count = sum(evt.count for evt in prof.key_averages() if kernel in evt.key)
    if not count:
        return None, 0, {}
    return sum(per_kernel.values()), count / calls, per_kernel


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


def close_err(got, want, tols) -> tuple[float, float]:
    """Largest |got - want| and largest |got - want| / (1 + |want|) over
    the outputs; raises where an output leaves
    ``|got - want| <= tol (1 + |want|)`` for its tolerance, or is not
    finite."""
    err = rel = 0.0
    for i, (a, b, tol) in enumerate(zip(got, want, tols)):
        if a.dtype != b.dtype or a.shape != b.shape:
            raise AssertionError(f"output {i}: {a.dtype}{tuple(a.shape)} vs {b.dtype}{tuple(b.shape)}")
        a, b = a.double(), b.double()
        if not bool(a.isfinite().all()):
            raise AssertionError(f"output {i} is not finite")
        diff = (a - b).abs()
        scaled = diff / (1 + b.abs())
        err, rel = max(err, diff.max().item()), max(rel, scaled.max().item())
        if bool((scaled > tol).any()):
            raise AssertionError(f"output {i} beyond tolerance {tol} (max |diff| {diff.max().item()})")
    return err, rel


def norm_err(got, want) -> float:
    """Largest |got - want| / |want| (Frobenius norms) over the
    outputs."""
    return max(((a.double() - b.double()).norm() / b.double().norm()).item()
               for a, b in zip(got, want))


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


def retire_inputs(rng, dev, timeout: bool = False):
    """The landing's rows; with ``timeout``, a quarter of the containers
    flagged timed (so about a quarter of the completing ones time out,
    several timed and done on one pipeline at once), and the branch's
    ``ctr_start``, ``timed`` and ``tick`` in place."""
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

    timed = b(rng.random((F, MC)) < 0.25) if timeout else None
    return (i32(ctr_pipe), i32(ctr_end), i32(ctr_start), b(oomed), b(done),
            timed, i32(arrival), i32(prio), i32(t))


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


def sjf_inputs(rng, dev):
    """``select_sjf``'s inputs at the main path's shapes: op counts 1..8
    (the lead key ties often), priorities, entry ticks with ties."""
    import torch

    mask = rng.random((F, MP)) < 0.3
    mask[:4] = False                                  # empty lanes
    n_ops = rng.integers(1, 9, (F, MP))
    prio = rng.integers(0, 3, (F, MP))
    ticks = rng.integers(0, 40, (F, MP)) * 1_000
    as_i32 = lambda a: torch.tensor(a, dtype=torch.int32, device=dev)  # noqa: E731
    return torch.tensor(mask, device=dev), as_i32(n_ops), as_i32(prio), as_i32(ticks)


def lane_lead_inputs(rng, dev):
    """The ``"policy"`` family's queue-head keys with its f32 lead
    ``size * n_ops + age * entered - prio_w * prio`` from weights drawn
    per lane in the search box (``policy.POLICY_BOUNDS``)."""
    import torch

    mask, n_ops, prio, entered = sjf_inputs(rng, dev)
    entered = entered + torch.tensor(rng.integers(0, 1_000, (F, MP)), dtype=torch.int32,
                                     device=dev)
    scale = np.array([2.0, 1e-3, 2.0], np.float32)[:, None, None]
    w = torch.tensor(rng.random((3, F, 1), dtype=np.float32) * scale, device=dev)
    f32 = torch.float32
    lead = w[0] * n_ops.to(f32) + w[1] * entered.to(f32) - w[2] * prio.to(f32)
    return mask, lead, -prio, entered


F32_SPECIAL = np.array([0.0, -0.0, 1.0, -1.0, np.inf, -np.inf, np.nan, 2.0**31, 2.0**32,
                        2.0**31 - 128, 3e9], np.float32)
I32_SPECIAL = np.array([0, 1, -1, 2**31 - 1, 2**31 - 2, -(2**31 - 1), -(2**31)], np.int32)


def select_edge_inputs(rng, dev, lanes, N, dtypes, special=0.2, offset=False):
    """Rows of ``len(dtypes)`` keys ("f4" / "i4") with real f32 leads
    (a weighted sum of op counts, entry ticks and priorities, as the
    scheduler forms them) or small ties, a ``special`` share of them
    drawn from NaN, signed zeros, infinities and the sentinels; empty,
    sparse and full lanes. ``offset``: each row one row into a
    contiguous table (a ``big[1:]`` view), so rows start unaligned
    when N % 4 != 0."""
    import torch

    rows = lanes + 1 if offset else lanes
    mask = rng.random((rows, N)) < np.resize([0.0, 0.05, 0.35, 1.0], rows)[:, None]
    keys = []
    for dt in dtypes:
        odd = rng.random((rows, N)) < special
        if dt == "f4":
            lead = (0.37 * rng.integers(1, 9, (rows, N)) + 1e-3 * rng.integers(0, 40, (rows, N)) * 1_000
                    - 2.5 * rng.integers(0, 3, (rows, N))).astype(np.float32)
            keys.append(np.where(odd, rng.choice(F32_SPECIAL, (rows, N)), lead).astype(np.float32))
        else:
            small = rng.integers(-1, 3, (rows, N)).astype(np.int32)
            keys.append(np.where(odd, rng.choice(I32_SPECIAL, (rows, N)), small).astype(np.int32))
    out = [torch.tensor(x, device=dev) for x in (mask, *keys)]
    if offset:
        out = [x[1:] for x in out]
    return out[0], tuple(out[1:])


def tick_edge_inputs(rng, dev, mc, mp, NP):
    """``tick_inputs`` at other sizes: wide exponents in the freed terms
    (their order shows in the last bits), lane 0 with every container
    retiring."""
    import torch

    t = rng.integers(1_000, 90_000, F)
    status = rng.integers(0, 2, (F, mc))
    end = t[:, None] + rng.integers(-50, 50, (F, mc))
    status[0], end[0] = 1, t[0]
    oom = np.where(rng.random((F, mc)) < 0.3, t[:, None] + rng.integers(-50, 50, (F, mc)), 2**31 - 1)
    cpus = rng.random((F, mc)) * 10.0 ** rng.integers(-3, 4, (F, mc))
    ram = rng.random((F, mc)) * 10.0 ** rng.integers(-3, 4, (F, mc))
    pstatus = rng.integers(0, 7, (F, mp))
    release = np.where(pstatus == 4, t[:, None] + rng.integers(-3, 3, (F, mp)), 2**31 - 1)

    def i32(x):
        return torch.tensor(x, dtype=torch.int32, device=dev)

    def f32(x):
        return torch.tensor(x, dtype=torch.float32, device=dev)

    return (i32(status), i32(end), i32(oom), f32(cpus), f32(ram), i32(rng.integers(0, NP, (F, mc))),
            i32(pstatus), i32(t[:, None] + rng.integers(-100, 100, (F, mp))), i32(release), i32(t))


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


def assign_edge_inputs(rng, dev, lanes, k, mc, mp):
    """``assign_inputs`` at other sizes and off the engine's contract:
    slots and pipes of -1, ``mc`` and ``mp`` (and beyond, where K > MC)
    on valid and invalid rows, lane 0 without a valid row, and on lane 1
    two valid rows sharing a slot and two sharing a pipe, with other
    fields (the first row of each pair lands)."""
    import torch

    valid = rng.random((lanes, k)) < 0.6
    valid[0] = False
    slot = np.stack([rng.permutation(max(mc, k))[:k] for _ in range(lanes)])
    pipe = np.stack([rng.permutation(max(mp, k))[:k] for _ in range(lanes)])
    odd = rng.random((lanes, k)) < 0.15
    slot = np.where(odd, rng.choice([-1, mc], (lanes, k)), slot)
    odd = rng.random((lanes, k)) < 0.15
    pipe = np.where(odd, rng.choice([-1, mp], (lanes, k)), pipe)
    if k >= 4:
        valid[1, :4] = True
        slot[1, :4] = [mc - 1, 0, mc - 1, 1]
        pipe[1, :4] = [2, mp - 1, 3, mp - 1]

    def i32(x):
        return torch.tensor(x, dtype=torch.int32, device=dev)

    def f32(x):
        return torch.tensor(x, dtype=torch.float32, device=dev)

    return (
        torch.tensor(valid, device=dev), i32(slot), i32(pipe), i32(rng.integers(0, 8, (lanes, k))),
        f32(rng.standard_normal((lanes, k)) * 8), f32(rng.standard_normal((lanes, k)) * 16),
        i32(rng.integers(-2**31, 2**31 - 1, (lanes, k))), i32(rng.integers(-2**31, 2**31 - 1, (lanes, k))),
        i32(rng.integers(-1, 4, (lanes, k))), torch.tensor(rng.random((lanes, k)) < 0.5, device=dev),
        torch.tensor(rng.random((lanes, k)) < 0.5, device=dev),
    )


def rwkv_inputs(rng, dev, S: int, H: int = 64, N: int = 64):
    """rwkv6_7b's prefill operands: r, k, v in bf16 from the projections'
    scale, the decay drawn as the model makes it,
    w = exp(-exp(w_base + lora)) with w_base on linspace(-6, -0.3, d)
    (``models/rwkv.py``), u and a carried state in f32."""
    import torch

    def bf16(x):
        return torch.tensor(x, dtype=torch.float32, device=dev).to(torch.bfloat16)

    d = H * N
    w_base = np.linspace(-6.0, -0.3, d).reshape(1, 1, H, N)
    lora = 0.05 * rng.standard_normal((1, S, H, N))
    w = np.exp(-np.exp(w_base + lora))
    return (bf16(rng.standard_normal((1, S, H, N))), bf16(rng.standard_normal((1, S, H, N)) * 0.5),
            bf16(rng.standard_normal((1, S, H, N))),
            torch.tensor(w, dtype=torch.float32, device=dev),
            torch.tensor(rng.standard_normal((H, N)) * 0.3, dtype=torch.float32, device=dev),
            torch.tensor(rng.standard_normal((1, H, N, N)) * 0.1, dtype=torch.float32, device=dev))


def rwkv_ops(S: int, chunk: int, H: int = 64, N: int = 64) -> float:
    """f32 operations of the chunked scan for one sequence: per chunk and
    head the strict-lower C x C product and its V product, (r E) S and
    the state carry, two operations per multiply-add."""
    C = min(chunk, S)
    n_chunks = math.ceil(S / C)
    return 2.0 * n_chunks * H * (C * (C - 1) * N + 2 * C * N * N)


def ssm_inputs(rng, dev, S: int, dim: int = 16384, N: int = 16):
    """jamba's Mamba prefill operands as ``mamba_apply`` hands them to the
    scan: x, B, C in bf16; dt = softplus(dt_proj + dt_bias) in f32, with
    dt_bias the inverse softplus of U(1e-3, 0.1); A = -exp(A_log), A_log
    in U(0, log 16); D = 1 (its init); a carried state in f32."""
    import torch

    def f32(x):
        return torch.tensor(x, dtype=torch.float32, device=dev)

    dt_bias = np.log(np.expm1(rng.uniform(1e-3, 0.1, dim)))
    pre = 0.5 * rng.standard_normal((1, S, dim)) + dt_bias
    return (f32(rng.standard_normal((1, S, dim))).to(torch.bfloat16),
            f32(np.logaddexp(pre, 0.0)),
            -torch.exp(f32(rng.uniform(0.0, np.log(16.0), (dim, N)))),
            f32(rng.standard_normal((1, S, N))).to(torch.bfloat16),
            f32(rng.standard_normal((1, S, N))).to(torch.bfloat16),
            torch.ones(dim, dtype=torch.float32, device=dev),
            f32(0.1 * rng.standard_normal((1, dim, N))))


def attn_inputs(rng, dev, Sq: int, Skv: int, H: int = 16, KV: int = 8, D: int = 256,
                B: int = 1):
    import torch

    def bf16(shape):
        return torch.tensor(rng.standard_normal(shape), dtype=torch.float32, device=dev).to(torch.bfloat16)

    return bf16((B, Sq, H, D)), bf16((B, Skv, KV, D)), bf16((B, Skv, KV, D))


def attn_mask(Sq, Skv, window, q_offset, kv_len, dev, causal: bool = True):
    """The [Sq, Skv] visibility of the flash kernel's masks (True =
    attend), for the library call."""
    import torch

    q_pos = q_offset + torch.arange(Sq, device=dev)[:, None]
    k_pos = torch.arange(Skv, device=dev)[None, :]
    ok = (k_pos < kv_len) & ((k_pos <= q_pos) if causal else (q_pos >= 0))
    if window > 0:
        ok &= k_pos > q_pos - window
    return ok


# flash_attention at the shapes the rest of the served zoo gives it (its
# own draws, so the other cases draw what they drew): label, B, Sq, Skv,
# causal, kv_len, H, KV, D, query rows held to the plain version (None:
# all)
ZOO_ATTENTION = (
    ("phi3 D=96 causal", 1, 2048, 2048, True, None, 32, 32, 96, None),
    ("granite MQA global Skv=4096 kv_len=2048", 1, 2048, 4096, True, 2048, 48, 1, 128, None),
    ("whisper encoder B=8 S=1500 not causal", 8, 1500, 1500, False, None, 12, 12, 64, None),
    ("whisper encoder S=32768 not causal (plain on the first 2048 queries)", 1, 32768, 32768,
     False, None, 12, 12, 64, 2048),
    ("whisper cross-attention prefill Sq=4 Skv=1500", 8, 4, 1500, False, None, 12, 12, 64, None),
    ("whisper cross-attention decode Sq=1 Skv=1500", 8, 1, 1500, False, None, 12, 12, 64, None),
)


# the attention backward at the shapes training gives it: label, B, Sq,
# Skv, causal, window, H, KV, D, dtype (phase 3; phase 16 trains phi3 at
# 4,096 and whisper at 8 x 1,500 frames with 187 decoder tokens)
TRAIN_ATTENTION = (
    ("gemma3_12b local causal window=1024", 1, 2048, 2048, True, 1024, 16, 8, 256, "bf16"),
    ("gemma3_12b global causal", 1, 2048, 2048, True, 0, 16, 8, 256, "bf16"),
    ("phi3 causal", 1, 4096, 4096, True, 0, 32, 32, 96, "bf16"),
    ("whisper encoder not causal", 8, 1500, 1500, False, 0, 12, 12, 64, "bf16"),
    ("whisper cross-attention not causal", 8, 187, 1500, False, 0, 12, 12, 64, "bf16"),
    ("whisper cross-attention not causal", 8, 187, 1500, False, 0, 12, 12, 64, "f32"),
)


def check_kernels(dev) -> dict:
    """Phase 3: every kernel against its plain version; returns the
    per-kernel measurements for the JSON line."""
    import torch
    import torch.nn.functional as Fn

    from repro_torch.kernels import LM_KERNELS
    from repro_torch.kernels.flash_attention import (
        flash_attention, flash_attention_bwd, flash_attention_bwd_ref, flash_attention_fwd_lse_ref,
        flash_attention_ref,
    )
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.rwkv6_scan import rwkv6_chunked_ref, rwkv6_scan
    from repro_torch.kernels.sched_select import (
        masked_lex_argmin, masked_lex_argmin_ref, select_sjf, select_sjf_ref,
    )
    from repro_torch.kernels.sim_tick import fleet_tick, fleet_tick_ref
    from repro_torch.kernels.ssm_scan import ssm_scan, ssm_scan_ref
    from repro_torch.kernels.state_update import (
        assign_gather, assign_gather_ref, retire_land, retire_land_ref,
    )

    rng = np.random.default_rng(0)
    sel_rng = np.random.default_rng(19)
    # name, label, kernel, plain, bytes in, {bound: (count, rate)} beside
    # bytes, library, tolerances, options: "plain_reps" (fewer repeats of
    # a slow plain version), "represent" (False: the case never stands
    # for its kernel in the JSON line), "attach" (rides in its kernel's
    # row under this key), "rows" (only the first query rows held to the
    # plain version), "norm_tol" (also held in norm)
    cases = []
    for NP in (1, 3):
        args = tick_inputs(rng, dev, NP)
        cases.append(("fleet_tick", f"NP={NP}",
                      lambda a=args, n=NP: fleet_tick(*a, num_pools=n),
                      lambda a=args, n=NP: fleet_tick_ref(*a, num_pools=n), args, None, None, None))
    args = retire_inputs(rng, dev)
    # timeout off: the landing reads ctr_pipe, ctr_end, the two masks,
    # arrival and prio (not ctr_start, timed or tick)
    cases.append(("retire_land", "timeout off", lambda a=args: retire_land(*a),
                  lambda a=args: retire_land_ref(*a),
                  (args[0], args[1], args[3], args[4], args[6], args[7]), None, None, None))
    # timeout on (its own inputs, so the other cases draw what they drew):
    # it reads every input; its row rides in the timeout-off row's JSON
    args = retire_inputs(np.random.default_rng(17), dev, timeout=True)
    cases.append(("retire_land", "timeout on",
                  lambda a=args: retire_land(*a, timeout_on=True),
                  lambda a=args: retire_land_ref(*a, timeout_on=True),
                  args, None, None, None, {"represent": False, "attach": "timeout_on"}))
    for mixed in (False, True):
        mask, keys = select_inputs(rng, dev, mixed)
        label = "K=3 f32/i32/i32 N=MP" if mixed else "K=2 i32/i32 N=MC"
        cases.append(("masked_lex_argmin", label,
                      lambda m=mask, k=keys: masked_lex_argmin(m, k),
                      lambda m=mask, k=keys: masked_lex_argmin_ref(m, k),
                      (mask, *keys), None, None, None))
    # exactly, beside the main path's shapes (none stands for its kernel):
    # keys that take the sweeps off the tuple minimum (NaN, signed zeros,
    # infinities, sentinels), real f32 leads, ragged and unaligned rows,
    # a wide fleet; ragged runs of containers, 8 pools
    extra = {"represent": False}
    for label, lanes, N, dtypes, special, offset in (
        ("K=3 f32/i32/i32 N=MP real leads", F, MP, ("f4", "i4", "i4"), 0.0, False),
        ("K=3 f32/i32/i32 N=MP edge keys", F, MP, ("f4", "i4", "i4"), 0.2, False),
        ("K=3 i32/f32/f32 N=MP edge keys", F, MP, ("i4", "f4", "f4"), 0.2, False),
        ("K=2 i32/i32 N=MC edge keys", F, MC, ("i4", "i4"), 0.2, False),
        ("K=1 f32 N=33 edge keys", F, 33, ("f4",), 0.2, False),
        ("K=3 f32/i32/i32 N=201 edge keys, rows one row in (unaligned)", F, 201, ("f4", "i4", "i4"),
         0.2, True),
        ("K=2 f32/i32 N=1024 edge keys", F, 1024, ("f4", "i4"), 0.2, False),
        ("K=3 f32/i32/i32 N=MP F=4096 real leads", 4096, MP, ("f4", "i4", "i4"), 0.0, False),
    ):
        mask, keys = select_edge_inputs(rng, dev, lanes, N, dtypes, special, offset)
        cases.append(("masked_lex_argmin", label,
                      lambda m=mask, k=keys: masked_lex_argmin(m, k),
                      lambda m=mask, k=keys: masked_lex_argmin_ref(m, k),
                      (mask, *keys), None, None, None, extra))
    # the SJF key set and per-lane f32 leads (their own draws, so the
    # other cases draw what they drew); each rides in the K = 3 row
    for label, attach, (mask, *keys), sjf in (
        ("K=3 i32/i32/i32 N=MP SJF keys (select_sjf)", "sjf", sjf_inputs(sel_rng, dev), True),
        ("K=3 f32/i32/i32 N=MP per-lane leads", "per_lane_leads",
         lane_lead_inputs(sel_rng, dev), False),
    ):
        if sjf:
            kernel = lambda m=mask, k=keys: select_sjf(m, *k)        # noqa: E731
            plain = lambda m=mask, k=keys: select_sjf_ref(m, *k)     # noqa: E731
        else:
            kernel = lambda m=mask, k=keys: masked_lex_argmin(m, k)  # noqa: E731
            plain = lambda m=mask, k=keys: masked_lex_argmin_ref(m, k)  # noqa: E731
        cases.append(("masked_lex_argmin", label, kernel, plain, (mask, *keys), None, None,
                      None, {"represent": False, "attach": attach}))
    for mc, mp in ((33, 200), (200, 1024), (1000, 1024)):
        args = tick_edge_inputs(rng, dev, mc, mp, 8)
        cases.append(("fleet_tick", f"MC={mc} MP={mp} NP=8, lane 0 all retiring",
                      lambda a=args: fleet_tick(*a, num_pools=8),
                      lambda a=args: fleet_tick_ref(*a, num_pools=8), args, None, None, None, extra))
    args = assign_inputs(rng, dev)
    sizes = dict(max_containers=MC, max_pipelines=MP)
    cases.append(("assign_gather", f"K={K} MC={MC} MP={MP}",
                  lambda a=args: assign_gather(*a, **sizes),
                  lambda a=args: assign_gather_ref(*a, **sizes), args, None, None, None))
    # the edge grid: K past a warp, past MC and past the block's 128
    # threads, rows of MC / MP not a multiple of 4 (scalar stores),
    # indices out of range, shared slots and pipes, a lane without a
    # valid row, a wide fleet; all exactly
    for lanes, k, mc, mp in ((F, 1, 33, 200), (F, 33, 33, 1024), (F, 64, 1000, 200),
                             (F, 64, 1000, 1024), (F, 33, 64, 256), (F, 200, 33, 256),
                             (F, 129, 64, 1024), (4096, K, MC, MP)):
        args = assign_edge_inputs(rng, dev, lanes, k, mc, mp)
        edge = dict(max_containers=mc, max_pipelines=mp)
        cases.append(("assign_gather", f"F={lanes} K={k} MC={mc} MP={mp} edge rows",
                      lambda a=args, e=edge: assign_gather(*a, **e),
                      lambda a=args, e=edge: assign_gather_ref(*a, **e), args, None, None,
                      None, extra))

    # rwkv6_7b prefill: H = N = 64, chunk 32; one sequence of 2048 tokens
    # and a ragged one (padded to a multiple of the chunk by the wrapper)
    for S in (2048, 2000):
        a = rwkv_inputs(rng, dev, S)
        pad = (32 - S % 32) % 32

        def plain(a=a, S=S, pad=pad):
            # the wrapper's padding (w = 1, k = 0), then the chunked form
            p = lambda t, val=0.0: Fn.pad(t, (0, 0, 0, 0, 0, pad), value=val)
            o, s = rwkv6_chunked_ref(p(a[0]), p(a[1]), p(a[2]), p(a[3], 1.0), a[4], a[5], chunk=32)
            return o[:, :S], s

        cases.append(("rwkv6_scan", f"B=1 S={S} H=64 N=64 chunk=32 bf16",
                      lambda a=a: rwkv6_scan(*a, chunk=32), plain, a,
                      {"operations": (rwkv_ops(S, 32), CORE_OPS_PER_S)}, None,
                      (LM_TOL["bf16"], LM_TOL["f32"])))

    # gemma3_12b prefill: H = 16, KV = 8, D = 256, 2048 tokens; the local
    # layers' ring-cache call (window 1024), a full causal call, and the
    # global layers' call against a 4096-slot cache (q_offset 0, kv_len)
    # jamba's attention layer (H = 64, KV = 8, D = 128) against its
    # 4096-slot cache; the gemma cases stay the row's representative
    for label, Skv, window, kv_len, (H, KV, D) in (
        ("W=1024", 2048, 1024, None, (16, 8, 256)), ("W=0", 2048, 0, None, (16, 8, 256)),
        ("global Skv=4096 kv_len=2048", 4096, 0, 2048, (16, 8, 256)),
        ("jamba global Skv=4096 kv_len=2048", 4096, 0, 2048, (64, 8, 128)),
    ):
        q, k, v = attn_inputs(rng, dev, 2048, Skv, H, KV, D)
        kw = dict(causal=True, window=window, q_offset=0, kv_len=kv_len)
        n_keys = Skv if kv_len is None else kv_len
        mask = attn_mask(2048, Skv, window, 0, n_keys, dev)
        visible = int(mask.sum().item())
        # the keys that this run's queries see: rows below kv_len
        needed = (q, k[:, :n_keys], v[:, :n_keys])
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))

        def library(qt=qt, kt=kt, vt=vt, mask=mask):
            return Fn.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask, enable_gqa=True)

        cases.append(("flash_attention", f"B=1 Sq=2048 H={H} KV={KV} D={D} {label} bf16",
                      lambda q=q, k=k, v=v, kw=kw: flash_attention(q, k, v, **kw),
                      lambda q=q, k=k, v=v, kw=kw: flash_attention_ref(q, k, v, **kw),
                      needed, {"operations": (4.0 * H * visible * D, BF16_TENSOR_OPS_PER_S)},
                      library, (LM_TOL["bf16"],), {"represent": H == 16, "norm_tol": ATTN_NORM_TOL}))
    # the rest of the zoo: phi3's head width 96, granite's 48 heads on one
    # KV head against its cache, whisper's encoder (not causal, 1,500 and
    # 32,768 frames) and its cross-attention (4 and 1 queries against
    # 1,500 frames); none stands for the kernel in the JSON line
    zoo_rng = np.random.default_rng(23)
    for label, B, Sq, Skv, causal, kv_len, H, KV, D, rows in ZOO_ATTENTION:
        q, k, v = attn_inputs(zoo_rng, dev, Sq, Skv, H, KV, D, B=B)
        kw = dict(causal=causal, window=0, q_offset=0, kv_len=kv_len)
        n_keys = Skv if kv_len is None else kv_len
        # an unmasked call needs no mask: the library runs without one
        mask = None if not causal and n_keys == Skv else attn_mask(Sq, Skv, 0, 0, n_keys, dev, causal)
        visible = B * (Sq * n_keys if mask is None else int(mask.sum().item()))
        needed = (q, k[:, :n_keys], v[:, :n_keys])
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))

        def library(qt=qt, kt=kt, vt=vt, mask=mask):
            return Fn.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask, enable_gqa=True)

        extra = {"represent": False, "norm_tol": ATTN_NORM_TOL}
        if rows is not None:
            # the plain version on the first `rows` queries (not causal,
            # so a query's output does not depend on the others)
            extra.update(rows=rows, plain_reps=dict(reps=3, inner=1))
        elif B * Sq * Skv * H > 2**30:
            extra["plain_reps"] = dict(reps=3, inner=1)
        cases.append(("flash_attention", f"B={B} Sq={Sq} Skv={Skv} H={H} KV={KV} D={D} {label} bf16",
                      lambda q=q, k=k, v=v, kw=kw: flash_attention(q, k, v, **kw),
                      lambda q=q, k=k, v=v, kw=kw, r=rows: flash_attention_ref(q[:, :r], k, v, **kw),
                      needed, {"operations": (4.0 * H * visible * D, BF16_TENSOR_OPS_PER_S)},
                      library, (LM_TOL["bf16"],), extra))

    # the attention backward of training (phase 16's path): each case's
    # forward kernel with its lse (held to the plain forward's out and lse),
    # then flash_attention_bwd against flash_attention_bwd_ref on that out,
    # lse and a random dO; bound: 5 products of 2 H D (visible pairs)
    bwd_rng = np.random.default_rng(24)
    for label, B, Sq, Skv, causal, window, H, KV, D, dtype in TRAIN_ATTENTION:
        q, k, v = attn_inputs(bwd_rng, dev, Sq, Skv, H, KV, D, B=B)
        dout = attn_inputs(bwd_rng, dev, Sq, 1, H, 1, D, B=B)[0]
        if dtype == "f32":
            q, k, v, dout = (x.float() for x in (q, k, v, dout))
        out, lse = flash_ops._launch(q, k, v, causal, window, 0, None, with_lse=True)
        plain_out, plain_lse = flash_attention_fwd_lse_ref(q, k, v, causal=causal, window=window)
        lse_err, lse_rel = close_err((lse,), (plain_lse.reshape(B, Sq, H),), (LM_TOL["f32"],))
        out_err, _ = close_err((out,), (plain_out,), (LM_TOL[dtype],))
        print(f"{CARD}: kernel flash_attention [{label} {dtype}, forward with lse]: lse within "
              f"2e-4 of 1 + |plain| (max |diff| {lse_err:.3g}, / (1 + |plain|) {lse_rel:.3g}), "
              f"out max |diff| {out_err:.3g}")
        del plain_out, plain_lse
        ins = (q, k, v, out, lse, dout)
        kw = dict(causal=causal, window=window)
        mask = None if not causal and window == 0 else attn_mask(Sq, Skv, window, 0, Skv, dev,
                                                                 causal)
        visible = B * (Sq * Skv if mask is None else int(mask.sum().item()))
        qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_() for x in (q, k, v))
        # the library's backward alone: SDPA's forward once, its backward timed
        lib_out = Fn.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=None if causal and window == 0 else mask,
            is_causal=causal and window == 0, enable_gqa=True)
        dout_t = dout.transpose(1, 2)

        def library(o=lib_out, leaves=(qt, kt, vt), g=dout_t):
            return torch.autograd.grad(o, leaves, g, retain_graph=True)

        rate = BF16_TENSOR_OPS_PER_S if dtype == "bf16" else CORE_OPS_PER_S
        cases.append(("flash_attention_bwd", f"B={B} Sq={Sq} Skv={Skv} H={H} KV={KV} D={D} "
                      f"{label} {dtype}",
                      lambda a=ins, kw=kw: flash_attention_bwd(*a, **kw),
                      lambda a=ins, kw=kw: flash_attention_bwd_ref(*a, **kw),
                      ins, {"operations": (5 * 2.0 * H * D * visible, rate)}, library,
                      (LM_TOL[dtype],) * 3,
                      {"represent": dtype == "bf16", "norm_tol": ATTN_NORM_TOL,
                       "plain_reps": dict(reps=3, inner=1)}))

    # jamba's Mamba prefill: B = 1, dim 16384, N 16; 2048 tokens, a ragged
    # 2000 and the served prompt's 1838, each handed to the kernel unpadded.
    # Bounds: one exp per (token, channel, state) on the special-function
    # units, and ~6 f32 operations per (token, channel, state)
    for S in (2048, 2000, 1838):
        a = ssm_inputs(rng, dev, S)
        pad = (256 - S % 256) % 256

        def plain(a=a, S=S, pad=pad):
            # the plain version's chunked form: zeros in x, dt, B, C up to
            # a multiple of the chunk, then the scan (the kernel pads nothing)
            p = lambda t: Fn.pad(t, (0, 0, 0, pad))
            y, h = ssm_scan_ref(p(a[0]), p(a[1]), a[2], p(a[3]), p(a[4]), a[5], a[6], chunk=256)
            return y[:, :S], h

        per_state = S * 16384 * 16
        cases.append(("ssm_scan", f"B=1 S={S} dim=16384 N=16 bf16 (plain: chunk 256)",
                      lambda a=a: ssm_scan(*a, chunk=256), plain, a,
                      {"exp": (per_state, SFU_EXP_PER_S),
                       "operations": (6.0 * per_state, CORE_OPS_PER_S)}, None,
                      (LM_TOL["bf16"], LM_TOL["f32"]), {"plain_reps": dict(reps=3, inner=1)}))

    results, attached = {}, {}
    for name, label, kernel, plain, ins, ops, library, tols, *options in cases:
        options = options[0] if options else {}
        got = kernel()
        torch.cuda.synchronize()
        want = plain()
        if not isinstance(got, tuple):
            got, want = (got,), (want,)
        # a case with "rows" holds only its first query rows to the plain
        # version (which ran on those alone)
        held = tuple(g[:, :options["rows"]] for g in got) if "rows" in options else got
        if tols is None:
            err, kind, reps = max_abs_err(held, want), "exact", {}
        else:
            err, rel = close_err(held, want, tols)
            kind = f"within {tols} of 1 + |plain| (max |diff| / (1 + |plain|) = {rel:.3g})"
            if "norm_tol" in options:
                norm = norm_err(held, want)
                if norm > options["norm_tol"]:
                    raise AssertionError(f"{name} [{label}]: |diff| / |plain| = {norm} in norm, "
                                         f"beyond {options['norm_tol']}")
                kind += (f" and in norm (|diff| / |plain| = {norm:.4g} <= {options['norm_tol']}, "
                         f"max |plain| = {max(w.abs().max().item() for w in want):.4g})")
            reps = dict(reps=11, inner=5)   # milliseconds per call: fewer repeats
        ms = timed_ms(kernel, **reps)
        plain_ms = timed_ms(plain, **options.get("plain_reps", reps))
        library_ms = None if library is None else timed_ms(library, **reps)
        dev_ms, dev_launches, dev_split = device_ms(kernel, f"{name}_kernel")
        moved = nbytes(x for x in ins if x is not None) + nbytes(got)
        if ops is None:
            # a few compares / selects per input element; no tensor-core work
            ops = {"operations": (4 * sum(x.numel() for x in ins if x is not None), CORE_OPS_PER_S)}
        bounds = {"bytes": moved / HBM_BYTES_PER_S * 1e3,
                  **{what: count / rate * 1e3 for what, (count, rate) in ops.items()}}
        bound_by = max(bounds, key=bounds.get)
        bound_ms = bounds[bound_by]
        dev_text = ("not measured" if dev_ms is None else
                    f"{dev_ms:.5f} ({dev_launches:g} device launches per call)")
        if len(dev_split) > 1:
            # a kernel of several passes: each pass's share, by its name
            passes = {re.search(rf"\w*{name}_kernel\w*", key).group(0): v
                      for key, v in dev_split.items()}
            dev_text += " [" + ", ".join(f"{k} {v:.5f}" for k, v in passes.items()) + "]"
        lib_text = "" if library_ms is None else f" library_ms={library_ms:.5f} (sdpa)"
        bound_text = " ".join(f"bound_{what}_ms={v:.6f}" for what, v in bounds.items())
        rate_text = ""
        if name in LM_KERNELS and dev_ms is not None:
            # achieved rate of the kernel's operations over its device time,
            # and its share of the bound
            rate_text = (f" achieved={ops['operations'][0] / dev_ms / 1e9:.2f} TFLOP/s, "
                         f"{100 * bound_ms / dev_ms:.1f}% of the bound")
            if library_ms is not None:
                rate_text += f", {dev_ms / library_ms:.3f}x the library's time"
        print(f"{CARD}: kernel {name} [{label}] {kind} max_abs_err={err} ms={ms:.5f} "
              f"(per wrapper call) device_ms={dev_text} (kernel alone, profiler) "
              f"plain_ms={plain_ms:.5f}{lib_text} bytes={moved} {bound_text} "
              f"bound_ms={bound_ms:.6f} ({bound_by}){rate_text}")
        # the exps of ssm_scan are operations of the special-function units
        row = {"max_abs_err": err, "ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms,
               "bound_ms": bound_ms, "bound_by": "bytes" if bound_by == "bytes" else "operations",
               "library_ms": library_ms, "bytes": moved}
        # the case with the largest bound stands for its kernel in the JSON
        # line; an attached case rides in that row under its own key
        prev = results.get(name)
        if "attach" in options:
            attached.setdefault(name, {})[options["attach"]] = row
        elif options.get("represent", True) and (prev is None or row["bound_ms"] > prev["bound_ms"]):
            results[name] = row
    for name, extra in attached.items():
        results[name].update(extra)
    results["launch_floor"] = launch_floor(dev)
    results["assign_gather"]["host_us"] = assign_host_breakdown(dev)
    return results


def launch_floor(dev) -> float | None:
    """The card's launch floor, a yardstick beside the simulator kernels
    that the port never calls: the device time per call (torch.profiler)
    of ``torch.Tensor.fill_`` on a one-element tensor, and its time per
    call (CUDA events); returns the device time (None: not measured)."""
    import torch

    x = torch.zeros(1, device=dev)

    def fill():
        x.fill_(1.0)

    ms = timed_ms(fill)
    dev_ms, launches, _ = device_ms(fill, "FillFunctor")
    dev_text = "not measured" if dev_ms is None else f"{dev_ms:.5f} ({launches:g} launches per call)"
    print(f"{CARD}: launch floor: torch.Tensor.fill_ of 1 element: device_ms={dev_text} "
          f"(profiler) ms={ms:.5f} (per call); a yardstick, not a kernel of the port")
    return dev_ms


def host_us(fn, calls: int = 200, reps: int = 11) -> float:
    """Median over ``reps`` of the host time per call of ``calls``
    back-to-back calls of ``fn`` (µs, perf_counter; the queue drained
    before and after each rep)."""
    import torch

    for _ in range(10):
        fn()
    samples = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        samples.append((time.perf_counter() - t0) / calls * 1e6)
    return statistics.median(samples)


def assign_host_breakdown(dev) -> dict:
    """Where ``assign_gather``'s wrapper call spends the host's time, at
    the main path's shapes: the whole call, and its steps (the one-pass
    row checks, the four allocations with their 13 views, the stream
    handle, the ctypes call with its pointers). Returns the times in
    µs."""
    from repro_torch.kernels import cuda_lib
    from repro_torch.kernels.state_update import ops

    rows = assign_inputs(np.random.default_rng(3), dev)
    regions, _ = ops._assign_outputs(F, MC, MP, dev)
    out = {
        "call": host_us(lambda: ops.assign_gather(*rows, max_containers=MC, max_pipelines=MP)),
        "checks": host_us(lambda: ops._check_assign_rows(rows, F, K, dev)),
        "allocs": host_us(lambda: ops._assign_outputs(F, MC, MP, dev)),
        "stream": host_us(lambda: cuda_lib.stream_args(dev)),
        "ctypes_call": host_us(lambda: ops._launch_assign(rows, regions, F, K, MC, MP, dev)),
    }
    print(f"{CARD}: assign_gather host breakdown (µs per call, host clock): "
          + " ".join(f"{k}={v:.2f}" for k, v in out.items()))
    return out


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
    print(f"{CARD}: phase 4: run(SimParams()) on {dev}: wall {wall:.3f} s, "
          f"{res.events} events, equal to the CPU port under the contract")
    print("phase 4 summary:", json.dumps(summary, sort_keys=True))
    print("phase 4 launches:", json.dumps(counts))
    return counts


def fleet_params(**kw):
    """Phase 5's configuration: benchmarks/engine_throughput.py's fleet."""
    from repro_torch import SimParams

    base = dict(
        duration=1.0, waiting_ticks_mean=5_000, op_base_seconds_mean=0.03,
        op_base_seconds_sigma=1.2, op_ram_gb_mean=2.0, max_pipelines=128,
        max_containers=64, scheduling_algo="priority",
    )
    return SimParams(**{**base, **kw})


def timed_fleet(params, wls, dev):
    """``fleet_run`` of ``wls`` on ``dev`` with the launch counts set to 0
    just before it and read just after; returns (states, wall s, counts,
    retire_land's launches with the timeout branch on)."""
    import torch

    from repro_torch import fleet_run
    from repro_torch.kernels import launch_counts, reset_launch_counts, retire_land

    reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    states = fleet_run(params, workloads=wls, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return states, wall, launch_counts(), retire_land.timeout_launches


def fleet_phase(dev) -> tuple[dict, dict, dict]:
    """Phase 5; returns the launches, the numbers phase 6b prints beside
    its own, and the fleet (params, workloads, CUDA and CPU states) that
    phase 5b replays."""
    from repro_torch import fleet_run, make_workload_batch

    params = fleet_params()
    seeds = list(range(64))
    wls = make_workload_batch(params, seeds)
    states, wall, counts, _ = timed_fleet(params, wls, dev)
    ref = fleet_run(params, workloads=wls, device="cpu")
    compare_states(states, ref, "fleet_run(64 seeds)")
    done = states.done_count.cpu()
    if int(done.min()) <= 0:
        raise AssertionError("a fleet lane completed nothing")
    sim_s = len(seeds) * params.duration
    print(f"{CARD}: phase 5: fleet_run of {len(seeds)} lanes on {dev}: wall {wall:.3f} s, "
          f"{sim_s / wall:.3f} simulated s per wall s, done per lane "
          f"mean {float(done.float().mean()):.2f}, equal to the CPU port lane by lane")
    print("phase 5 launches:", json.dumps(counts))
    busy = profile_fleet(params, wls, dev, "phase 5")
    return counts, {"wall_s": wall, "sim_s_per_wall_s": sim_s / wall,
                    "launches": sum(counts.values()), "events": counts["fleet_tick"], **busy}, {
        "params": params, "wls": wls, "states": states, "ref": ref}


def assert_same_states(got, want, ctx: str) -> None:
    """Every field of two states on the card equal exactly (dtype, shape
    and values)."""
    import torch

    for name in got._fields:
        a, b = getattr(got, name), getattr(want, name)
        if a.dtype != b.dtype or a.shape != b.shape or not torch.equal(a, b):
            raise AssertionError(f"{ctx}: field {name} differs")


def replay_phase(dev, fleet: dict) -> tuple[dict, dict]:
    """Phase 5b: phase 5's fleet replayed from trace files. Each lane's
    workload becomes records (``workload_to_trace_records``), a JSON file
    in a temporary directory, and back (``workload_batch_from_traces``):
    the batch equals phase 5's bit for bit, the replayed fleet on CUDA
    equals phase 5's CUDA states on every field, ``run`` of lane 0's
    file (``trace_path``) equals lane 0 under the contract,
    ``shard="auto"`` equals the unsharded run, and ``fleet_summary`` of
    the card's states equals that of phase 5's CPU states under the
    contract. Returns the launches of the replayed fleet and of the run."""
    import tempfile

    import torch

    from repro_torch import fleet_run, fleet_summary, run, workload_batch_from_traces
    from repro_torch.core.state import SimState, workload_lane
    from repro_torch.core.workload import workload_to_trace_records
    from repro_torch.kernels import SIM_KERNELS, launch_counts, reset_launch_counts

    params, wls = fleet["params"], fleet["wls"]
    lanes = wls.arrival.shape[0]
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        paths = [pathlib.Path(tmp) / f"lane_{i}.json" for i in range(lanes)]
        for i, path in enumerate(paths):
            path.write_text(json.dumps(workload_to_trace_records(workload_lane(wls, i))))
        days = [json.loads(path.read_text()) for path in paths]
        batch, batch_params = workload_batch_from_traces(days, params)
        ingest_s = time.perf_counter() - t0
        if batch_params != params:
            raise AssertionError("phase 5b: the batch's capacities differ from phase 5's")
        for name in wls._fields[:10]:
            a, b = getattr(batch, name), getattr(wls, name)
            if a.dtype != b.dtype or not torch.equal(a, b):
                raise AssertionError(f"phase 5b: ingested field {name} differs from phase 5's")
        states, wall, counts, _ = timed_fleet(params, batch, dev)
        assert_same_states(states, fleet["states"], "phase 5b: replayed fleet vs phase 5")
        reset_launch_counts()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        res = run(params.replace(trace_path=str(paths[0])), device=dev)
        torch.cuda.synchronize()
        run_wall = time.perf_counter() - t1
        run_counts = launch_counts()
    for name in SIM_KERNELS:
        if counts[name] <= 0 or run_counts[name] <= 0:
            raise AssertionError(f"phase 5b: {name} was not launched")
    compare_states(SimState(*(x[None] for x in res.state)),
                   SimState(*(x[:1].cpu() for x in fleet["states"])), "phase 5b: run(trace_path)")
    sharded = fleet_run(params, workloads=batch, device=dev, shard="auto")
    assert_same_states(sharded, states, 'phase 5b: shard="auto" vs unsharded')
    summary = fleet_summary(states, params)
    want = fleet_summary(fleet["ref"], params)
    for key, value in want.items():
        if not math.isclose(summary[key], value, rel_tol=RTOL) and not (
                math.isnan(value) and math.isnan(summary[key])):
            raise AssertionError(f"phase 5b: fleet_summary[{key}] {summary[key]} vs CPU {value}")
    sim_s = lanes * params.duration
    print(f"{CARD}: phase 5b: {lanes} lanes replayed from JSON trace files on {dev}: written and "
          f"ingested in {ingest_s:.3f} s, bit-equal to phase 5's batch; fleet_run wall "
          f"{wall:.3f} s, {sim_s / wall:.3f} simulated s per wall s, equal to phase 5's CUDA "
          f"states on every field; run(trace_path=lane_0.json) wall {run_wall:.3f} s, "
          f"{res.events} events, equal to lane 0; shard=\"auto\" equal to the unsharded run; "
          f"fleet_summary equal to the CPU port's under the contract")
    print("phase 5b fleet_summary:", json.dumps(summary, sort_keys=True))
    print("phase 5b launches:", json.dumps(counts), "run:", json.dumps(run_counts))
    return counts, run_counts


def timed_run(params, wl, dev, scheduler_key=None):
    """``run`` (or, with ``scheduler_key``, ``fleet_run`` of the batch
    ``wl``) on ``dev`` with the launch counts set to 0 just before it and
    read just after; returns (result, wall s, counts)."""
    import torch

    from repro_torch import fleet_run, run
    from repro_torch.kernels import launch_counts, reset_launch_counts

    reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    if scheduler_key is None:
        out = run(params, wl, device=dev)
    else:
        out = fleet_run(params, workloads=wl, scheduler_key=scheduler_key, device=dev)
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0, launch_counts()


def cache_params(**kw):
    """Phase 5c's configuration: benchmarks/scheduler_comparison.py's
    cache_sensitivity (its shared workload, seed 11) at 8 GB a pool, its
    2 s horizon cut to 1 s to make room for phase 16."""
    from repro_torch import SimParams

    base = dict(
        duration=1.0, waiting_ticks_mean=1500, num_pools=2, op_base_seconds_mean=0.02,
        op_ram_gb_mean=3.0, max_pipelines=256, max_containers=64, seed=11, **DATA_PLANE,
    )
    return SimParams(**{**base, **kw})


def data_plane_phase(dev) -> tuple[list[dict], dict]:
    """Phase 5c: one shared workload under five schedulers with the data
    plane on, each ``run`` on CUDA against the CPU port; ``cache_aware``
    profiled with the cache on and off. Returns each run's launches, and
    the params, the workload and each scheduler's CUDA result and wall
    (phase 12 holds the Python engine to them)."""
    from repro_torch import generate_workload, run
    from repro_torch.kernels import SIM_KERNELS

    base = cache_params()
    wl = generate_workload(base)
    all_counts, rows, held = [], {}, {"params": base, "wl": wl, "runs": {}}
    for algo in ("naive", "priority_pool", "cache_aware", "locality_pool", "sjf"):
        params = base.replace(scheduling_algo=algo)
        res, wall, counts = timed_run(params, wl, dev)
        held["runs"][algo] = (res, wall)
        cpu = run(params, wl, device="cpu")
        compare_states(res.state, cpu.state, f"phase 5c: {algo}")
        s, c = res.summary(), cpu.summary()
        rows[algo] = {k: s[k] for k in ("done", "cache_hits", "cache_lookups", "cold_starts",
                                        "warm_starts", "cache_hit_rate", "mean_latency_s")}
        print(f"{CARD}: phase 5c: {algo}: run on {dev}: wall {wall:.3f} s, {res.events} events, "
              f"{sum(counts.values())} launches ({sum(counts.values()) / res.events:.2f} an "
              f"event), cache_hit_rate {s['cache_hit_rate']!r} (CPU port "
              f"{c['cache_hit_rate']!r}), equal to the CPU port under the contract; "
              + json.dumps(rows[algo]))
        print(f"phase 5c {algo} launches:", json.dumps(counts))
        all_counts.append(counts)
    if rows["cache_aware"]["cache_hits"] <= 0:
        raise AssertionError("phase 5c: no cache hit under cache_aware")
    for key in ("cold_starts", "warm_starts"):
        if sum(r[key] for r in rows.values()) <= 0:
            raise AssertionError(f"phase 5c: no {key} over the five runs")
    for name in SIM_KERNELS:
        if sum(c[name] for c in all_counts) <= 0:
            raise AssertionError(f"phase 5c: {name} was not launched")
    # the profiled pair runs the first quarter of the horizon: the
    # profiler's bookkeeping of a whole 2 s run (~840,000 kernels) takes
    # minutes
    params = base.replace(scheduling_algo="cache_aware", duration=0.5)
    for label, p in (("cache on", params), ("cache off", params.replace(cache_gb_per_pool=0.0))):
        busy = profile_call(lambda p=p: run(p, wl, device=dev), f"phase 5c cache_aware {label}")
        if busy:
            events = busy["result"].events
            print(f"{CARD}: phase 5c: cache_aware, {label}, first 0.5 s: {events} events, "
                  f"{busy['device_launches'] / events:.1f} device kernels an event, device busy "
                  f"{100 * busy['busy_share']:.1f}% of wall")
    return all_counts, held


def policy_grid_phase(dev) -> tuple[dict, dict]:
    """Phase 5d: the six named points over seeds 0-7 as one 48-lane
    ``"policy"`` fleet on CUDA, bit-equal lane for lane to the six named
    8-lane fleets on CUDA, and one seed per point against the CPU port.
    Returns the grid run's launches, and the params, the grid, its CUDA
    states, wall, point names and seeds a point (for phase 12)."""
    from repro_torch import DEFAULT_POINTS, fleet_run, make_workload_batch, policy_grid_workloads
    from repro_torch.core.policy import PolicyParams
    from repro_torch.core.state import SimState, tree_map

    params = fleet_params(num_pools=2, **DATA_PLANE)
    names = sorted(DEFAULT_POINTS)
    scen = make_workload_batch(params, list(range(8)))
    grid, C, S = policy_grid_workloads(scen, [DEFAULT_POINTS[k] for k in names])
    states, wall, counts = timed_run(params, grid, dev, scheduler_key="policy")
    leads = grid.policy[:, PolicyParams._fields.index("size_weight")]
    if len(set(leads.tolist())) < 2:
        raise AssertionError("phase 5d: the lead key's weights are the same in every lane")
    for name in ("masked_lex_argmin", "assign_gather"):
        if counts[name] <= 0:
            raise AssertionError(f"phase 5d: {name} was not launched")
    warm = int(states.warm_starts.sum())
    if warm <= 0:
        raise AssertionError("phase 5d: assign_gather landed no warm row")
    named_walls = {}
    for c, key in enumerate(names):
        named, named_walls[key], _ = timed_run(params, scen, dev, scheduler_key=key)
        assert_same_states(SimState(*(x[c * S:(c + 1) * S] for x in states)), named,
                           f"phase 5d: policy lanes of {key} vs the named fleet")
    sub, _, _ = policy_grid_workloads(tree_map(lambda x: x[:1], scen),
                                      [DEFAULT_POINTS[k] for k in names])
    t0 = time.perf_counter()
    cpu = fleet_run(params, workloads=sub, scheduler_key="policy", device="cpu")
    cpu_wall = time.perf_counter() - t0
    compare_states(SimState(*(x[0::S] for x in states)), cpu, "phase 5d: seed 0 vs the CPU port")
    sim_s = C * S * params.duration
    done = states.done_count.reshape(C, S).float().mean(-1).tolist()
    print(f"{CARD}: phase 5d: fleet_run(\"policy\") of {C} points x {S} seeds = {C * S} lanes "
          f"on {dev}: wall {wall:.3f} s, {sim_s / wall:.3f} simulated s per wall s, "
          f"{sum(counts.values())} launches, warm starts {warm}; bit-equal to the named fleets "
          f"(walls {json.dumps({k: round(v, 3) for k, v in named_walls.items()})}); seed 0 of "
          f"each point equal to the CPU port (wall {cpu_wall:.3f} s); done per lane by point "
          + json.dumps(dict(zip(names, [round(d, 2) for d in done]))))
    print("phase 5d launches:", json.dumps(counts))
    busy = profile_call(
        lambda: fleet_run(params, workloads=grid, scheduler_key="policy", device=dev),
        "phase 5d")
    if busy:
        print(f"{CARD}: phase 5d: device busy {100 * busy['busy_share']:.1f}% of wall under the "
              f"profiler, {busy['device_launches']} kernel launches")
    return counts, {"params": params, "grid": grid, "states": states, "wall": wall,
                    "names": names, "S": S}


def profile_fleet(params, wls, dev, label: str) -> dict:
    """Where the fleet run's time goes (:func:`profile_call`)."""
    from repro_torch import fleet_run

    busy = profile_call(lambda: fleet_run(params, workloads=wls, device=dev), label)
    busy.pop("result", None)
    return busy


def profile_call(fn, label: str) -> dict:
    """Where a simulation's time goes: one more call of ``fn`` under
    torch.profiler, its wall time against the summed device time of every
    CUDA kernel (the device's busy share), and the kernels that take the
    most; returns the busy share and the kernel launches (empty: not
    measured). The trace's raw events are summed as they come, to the
    same sums as ``key_averages()``, which takes the host minutes to build
    for a fleet's hundreds of thousands of kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_name = {}                                   # kernel name -> [ns, launches]
    for e in prof.profiler.kineto_results.events():
        if str(e.device_type()).endswith("CUDA"):
            row = by_name.setdefault(e.name(), [0, 0])
            row[0] += e.duration_ns()
            row[1] += 1
    if not by_name:
        print(f"{label} profile: the trace holds no CUDA kernels; device busy share not measured")
        return {}
    busy_ms = sum(ns for ns, _ in by_name.values()) / 1e6
    launches = sum(n for _, n in by_name.values())
    print(f"{CARD}: {label} profile: wall {wall * 1e3:.1f} ms (under the profiler), device busy "
          f"{busy_ms:.1f} ms ({100 * busy_ms / (wall * 1e3):.1f}% of wall), "
          f"{launches} kernel launches")
    for name, (ns, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]:
        print(f"  {ns / 1e6:9.3f} ms  {n:6d}x  {name[:90]}")
    return {"busy_share": busy_ms / (wall * 1e3), "device_launches": launches, "result": out,
            "busy_ms": busy_ms, "by_name": by_name}


def chaos_phase(dev, faults_off: dict) -> tuple[dict, dict, dict]:
    """Phase 6b: the chaos layer at phase 5's configuration with two pools
    and ``priority_pool``: ``run`` at seed 0 and the 64-lane
    ``fleet_run``, each on CUDA against the CPU port; every fault class
    fires over the fleet and ``retire_land`` runs its timeout branch.
    Returns the launches of the run and of the fleet, and the run's
    params, CUDA result and wall (for phase 12)."""
    import torch

    from repro_torch import fleet_run, generate_workload, make_workload_batch, run
    from repro_torch.kernels import SIM_KERNELS, launch_counts, reset_launch_counts, retire_land

    params = fleet_params(num_pools=2, scheduling_algo="priority_pool", **CHAOS)
    wl = generate_workload(params)
    reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = run(params, wl, device=dev)
    torch.cuda.synchronize()
    run_wall = time.perf_counter() - t0
    run_counts, run_timeout = launch_counts(), retire_land.timeout_launches
    compare_states(res.state, run(params, wl, device="cpu").state, "chaos run(seed 0)")
    summary = res.summary()
    keys = ("done", "failed", "faults_injected", "crash_events", "outage_events",
            "fault_kills", "timeouts", "retries", "wasted_work_s", "pool_down_s", "mttr_s")
    print(f"{CARD}: phase 6b: chaos run(seed 0) on {dev}: wall {run_wall:.3f} s, {res.events} "
          f"events, equal to the CPU port under the contract; "
          + json.dumps({k: summary[k] for k in keys}))
    print("phase 6b run launches:", json.dumps(run_counts), f"retire_land with the timeout "
          f"branch: {run_timeout}")

    seeds = list(range(64))
    wls = make_workload_batch(params, seeds)
    states, wall, counts, timeout_launches = timed_fleet(params, wls, dev)
    compare_states(states, fleet_run(params, workloads=wls, device="cpu"),
                   "chaos fleet_run(64 seeds)")
    fired = {name: int(getattr(states, name).sum()) for name in (
        "crash_events", "outage_events", "timeout_events", "retry_events", "fault_kills",
        "failed_count")}
    fired["stragglers"] = int((wls.faults.straggler > 1).sum())
    quiet = [name for name, n in fired.items() if n <= 0]
    if quiet:
        raise AssertionError(f"phase 6b: fault classes that never fired: {quiet}")
    for name in SIM_KERNELS:
        if counts[name] <= 0 or run_counts[name] <= 0:
            raise AssertionError(f"phase 6b: {name} was not launched")
    if timeout_launches <= 0 or timeout_launches != counts["retire_land"]:
        raise AssertionError(f"phase 6b: retire_land ran its timeout branch {timeout_launches} "
                             f"of {counts['retire_land']} times")
    sim_s = len(seeds) * params.duration
    print(f"{CARD}: phase 6b: chaos fleet_run of {len(seeds)} lanes on {dev}: wall {wall:.3f} s "
          f"({faults_off['wall_s']:.3f} s faults off, phase 5), {sim_s / wall:.3f} simulated s "
          f"per wall s ({faults_off['sim_s_per_wall_s']:.3f}), {sum(counts.values())} wrapper "
          f"launches ({faults_off['launches']}), equal to the CPU port lane by lane; fired over "
          f"the fleet: " + json.dumps(fired))
    print("phase 6b fleet launches:", json.dumps(counts),
          f"retire_land with the timeout branch: {timeout_launches}")
    busy = profile_fleet(params, wls, dev, "phase 6b")
    if busy and faults_off.get("busy_share") is not None:
        print(f"{CARD}: phase 6b: device busy {100 * busy['busy_share']:.1f}% of wall under the "
              f"profiler ({100 * faults_off['busy_share']:.1f}% faults off, phase 5), "
              f"{busy['device_launches']} kernel launches ({faults_off['device_launches']})")
    return run_counts, counts, {"params": params, "res": res, "wall": run_wall}


# the overload layer's knobs of phase 6c (a):
# benchmarks/engine_throughput.py:298-307 (the fused_closed_loop row)
CLOSED_LOOP = dict(
    client_max_inflight=6, client_think_ticks=200, client_max_retries=3,
    client_backoff_ticks=200, admission_policy="queue_threshold", admit_queue_limit=4,
)
# phase 6c (b): benchmarks/scheduler_comparison.py's OVERLOAD_POLICIES
OVERLOAD_POLICIES = (
    ("admit_all", {}),
    ("queue_threshold", {"admit_queue_limit": 3}),
    ("token_bucket", {"admit_rate_per_s": 400.0, "admit_burst": 4.0}),
    ("codel", {"codel_target_ticks": 400, "codel_interval_ticks": 200}),
)
# lanes of phase 6c held to the CPU port (lanes are independent; the card
# runs them all)
CPU_LANES_6C = {"fleet": 8, "arm": 2}
# phase 6c (b)'s fault traces and rows as the JAX package gives them
# (tests/captures/write_torch_overload_reference.py)
OVERLOAD_REFERENCE = ROOT / "tests" / "captures" / "torch_overload_reference.json"
ROW_KEYS = ("offered", "admitted", "shed", "deferred", "client_retries", "goodput_per_s",
            "drained_lanes", "metastable_lanes")


def overload_storm(policy: str, knobs: dict):
    """Phase 6c (b)'s arm ``policy``: the 8 ``retry_storm`` lanes as a
    CPU batch with the reference's fault traces (``fault_trace_from_
    records`` of the fixture's records), and its params."""
    import torch

    from repro_torch import SimParams
    from repro_torch.core.faults import fault_trace_from_records
    from repro_torch.core.scenarios import retry_storm_params, scenario_lane_batch
    from repro_torch.core.state import tree_map
    from repro_torch.core.workload import workload_batch_from_traces

    base = SimParams(
        duration=0.08, max_pipelines=0, max_ops_per_pipeline=0, max_containers=16,
        waiting_ticks_mean=150.0, op_base_seconds_mean=0.008, op_base_seconds_sigma=1.0,
        num_pools=2, total_cpus=4, total_ram_gb=8, scheduling_algo="priority_pool", seed=11,
    )
    lanes = scenario_lane_batch("retry_storm", base.replace(duration=0.06), 8,
                                seed=11, surge_factor=6.0)
    wls, params = workload_batch_from_traces(lanes, base)
    armed = retry_storm_params(
        params, admission_policy=policy, outage_mtbf_s=0.02, outage_duration_s=0.006,
        client_max_retries=3,
    ).replace(max_fault_events=2, **knobs)
    records = json.loads(OVERLOAD_REFERENCE.read_text())["fault_traces"]
    faults = tree_map(lambda *lane: torch.cat(lane),
                      *[fault_trace_from_records(r, armed) for r in records])
    return wls._replace(faults=faults), armed


def overload_phase(dev, loop_off: dict) -> tuple[list[dict], dict]:
    """Phase 6c: the overload layer. (a) phase 5's 64-lane fleet with
    closed-loop clients and a queue threshold, on CUDA against the CPU
    port on its first 8 lanes, profiled as phase 5 is; (b)
    ``overload_comparison``'s table: 8 ``retry_storm`` lanes under each of
    the four admission policies with two early outages (the reference's
    fault traces), each arm's ``fleet_run`` on CUDA against the CPU port
    on its first 2 lanes and its row equal to the reference's. Returns
    the launches of each run, and (a)'s params, lane 0's workload and
    CUDA state and the fleet's wall (for phase 12)."""
    import torch

    from repro_torch import fleet_run, fleet_summary, make_workload_batch
    from repro_torch.core.state import tree_map
    from repro_torch.core.types import INF_TICK
    from repro_torch.kernels import SIM_KERNELS

    def head(tree, n):
        return tree_map(lambda x: x[:n], tree)

    # ---- (a) the closed-loop fleet -------------------------------------------
    params = fleet_params(**CLOSED_LOOP)
    seeds = list(range(64))
    wls = make_workload_batch(params, seeds)
    states, wall, counts, _ = timed_fleet(params, wls, dev)
    n = CPU_LANES_6C["fleet"]
    t0 = time.perf_counter()
    compare_states(head(states, n), fleet_run(params, workloads=head(wls, n), device="cpu"),
                   f"phase 6c (a): closed-loop fleet, first {n} lanes")
    cpu_wall = time.perf_counter() - t0
    totals = {name: int(getattr(states, name).sum()) for name in (
        "offered_total", "admitted_total", "shed_total", "deferred_total",
        "client_retry_events", "done_count")}
    # at most 6 in flight a lane against 64 containers: an admitted
    # pipeline starts at once, so the threshold of 4 admitted-and-waiting
    # never binds and nothing is shed or retried (the reference's fleet
    # of seeds 0-63 sheds nothing either); (b) sheds and retries
    quiet = [name for name, v in totals.items()
             if v <= 0 and name not in ("shed_total", "client_retry_events")]
    if quiet:
        raise AssertionError(f"phase 6c (a): totals that stayed at 0: {quiet}")
    for name in SIM_KERNELS:
        if counts[name] <= 0:
            raise AssertionError(f"phase 6c (a): {name} was not launched")
    events = counts["fleet_tick"]
    sim_s = len(seeds) * params.duration
    print(f"{CARD}: phase 6c (a): closed-loop fleet_run of {len(seeds)} lanes on {dev}: wall "
          f"{wall:.3f} s ({loop_off['wall_s']:.3f} s loop off, phase 5), {sim_s / wall:.3f} "
          f"simulated s per wall s ({loop_off['sim_s_per_wall_s']:.3f}), {events} events "
          f"({loop_off['events']}), {sum(counts.values())} wrapper launches "
          f"({loop_off['launches']}); first {n} lanes equal to the CPU port (CPU wall "
          f"{cpu_wall:.3f} s); totals over the fleet: " + json.dumps(totals))
    print("phase 6c (a) launches:", json.dumps(counts))
    busy = profile_fleet(params, wls, dev, "phase 6c (a)")
    if busy and loop_off.get("busy_share") is not None:
        print(f"{CARD}: phase 6c (a): {busy['device_launches'] / events:.1f} device kernels an "
              f"event ({loop_off['device_launches'] / loop_off['events']:.1f} loop off, phase "
              f"5), device busy {100 * busy['busy_share']:.1f}% of wall under the profiler "
              f"({100 * loop_off['busy_share']:.1f}%)")
    all_counts = [counts]
    lane0 = {"params": params, "wl": head(wls, 1), "state": tree_map(lambda x: x[0], states),
             "wall": wall, "lanes": len(seeds)}

    # ---- (b) the overload table ----------------------------------------------
    n_lanes, n = 8, CPU_LANES_6C["arm"]
    reference = json.loads(OVERLOAD_REFERENCE.read_text())["rows"]
    rows = {}
    for policy, knobs in OVERLOAD_POLICIES:
        wls, armed = overload_storm(policy, knobs)
        states, wall, counts, _ = timed_fleet(armed, wls, dev)
        t0 = time.perf_counter()
        compare_states(head(states, n), fleet_run(armed, workloads=head(wls, n), device="cpu"),
                       f"phase 6c (b): {policy}, first {n} lanes")
        cpu_wall = time.perf_counter() - t0
        for name in SIM_KERNELS:
            if counts[name] <= 0:
                raise AssertionError(f"phase 6c (b): {policy}: {name} was not launched")
        # the lanes whose trace starts an outage inside the horizon
        struck = (wls.faults.outage_start[:, 0] < armed.horizon_ticks).to(dev)
        faulted = states.last_fault_tick < INF_TICK
        if not torch.equal(faulted, struck) or int(struck.sum()) < n_lanes // 2:
            raise AssertionError(f"phase 6c (b): {policy}: lanes that saw an outage "
                                 f"{faulted.tolist()}, lanes whose trace holds one "
                                 f"{struck.tolist()}")
        s = fleet_summary(states, armed)
        offered = int(states.offered_total.sum())
        unique = int(states.offered_unique.sum())
        drained = int((states.drain_tick < INF_TICK).sum())
        rows[policy] = row = {
            "scenario": "retry_storm", "policy": policy, "lanes": n_lanes,
            "offered": offered, "admitted": int(states.admitted_total.sum()),
            "admitted_fraction": round(s["admitted_fraction_mean"], 3),
            "shed": int(states.shed_total.sum()), "deferred": int(states.deferred_total.sum()),
            "client_retries": int(states.client_retry_events.sum()),
            "retry_amplification": round(offered / max(unique, 1), 2),
            "goodput_per_s": round(s["throughput_per_s_mean"], 2),
            "mean_latency_s": round(s["mean_latency_s_mean"], 4),
            "drained_lanes": drained, "metastable_lanes": n_lanes - drained,
            "fairness_jain_done": round(s["fairness_jain_done"], 3), "wall_s": round(wall, 3),
        }
        # the reference's row: every count, and the goodput unrounded
        got = {**{k: row[k] for k in ROW_KEYS}, "goodput_per_s": s["throughput_per_s_mean"]}
        if got != reference[policy]:
            raise AssertionError(f"phase 6c (b): {policy}: row {got} differs from the "
                                 f"reference's {reference[policy]}")
        print(f"{CARD}: phase 6c (b): {policy}: fleet_run of {n_lanes} lanes on {dev}: wall "
              f"{wall:.3f} s, {counts['fleet_tick']} events, {sum(counts.values())} wrapper "
              f"launches; first {n} lanes equal to the CPU port (CPU wall {cpu_wall:.3f} s); "
              f"lanes that saw an outage {int(faulted.sum())} (every lane whose trace holds "
              f"one), drained lanes {drained}, metastable lanes {n_lanes - drained}; row equal "
              f"to the reference's; " + json.dumps(row))
        print(f"phase 6c (b) {policy} launches:", json.dumps(counts))
        all_counts.append(counts)
    control, shedder = rows["admit_all"], rows["queue_threshold"]
    if (control["shed"] != 0 or control["offered"] != control["admitted"]
            or control["retry_amplification"] != 1.0):
        raise AssertionError(f"phase 6c (b): admit_all rejected something: {control}")
    if shedder["shed"] <= 0 or shedder["client_retries"] <= 0:
        raise AssertionError(f"phase 6c (b): queue_threshold shed or retried nothing: {shedder}")
    if rows["token_bucket"]["deferred"] <= 0:
        raise AssertionError(f"phase 6c (b): token_bucket deferred nothing: {rows['token_bucket']}")
    return all_counts, lane0


# lanes of phase 5e held to the CPU port's traced runs
CPU_LANES_5E = 8


def traced_fleet(params, wls, dev, label: str):
    """``fleet_run(trace=True)`` of ``wls`` on ``dev`` with the launch
    counts set to 0 just before it and read just after, and the CPU
    port's traced run of its first ``CPU_LANES_5E`` lanes: their states
    under the contract and their records, counts and ``dropped``
    exactly. Returns (states, traces, wall s, counts, CPU wall s)."""
    import torch

    from repro_torch import fleet_run
    from repro_torch.core.state import tree_map
    from repro_torch.kernels import launch_counts, reset_launch_counts

    n = CPU_LANES_5E
    reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    states, traces = fleet_run(params, workloads=wls, device=dev, trace=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts()
    t1 = time.perf_counter()
    cpu_states, cpu_traces = fleet_run(params, workloads=tree_map(lambda x: x[:n], wls),
                                       device="cpu", trace=True)
    cpu_wall = time.perf_counter() - t1
    compare_states(tree_map(lambda x: x[:n], states), cpu_states,
                   f"phase 5e: {label}, first {n} lanes")
    for i, (a, b) in enumerate(zip(traces[:n], cpu_traces)):
        if (a.n, a.events_dropped, a.capacity) != (b.n, b.events_dropped, b.capacity) or \
                not np.array_equal(a.records, b.records):
            raise AssertionError(f"phase 5e: {label}: lane {i}'s trace differs from the CPU "
                                 f"port's ({a.n} / {b.n} records, {a.events_dropped} / "
                                 f"{b.events_dropped} dropped)")
    return states, traces, wall, counts, cpu_wall


def telemetry_phase(dev, fleet: dict, fleet_counts: dict, untraced: dict) -> list[dict]:
    """Phase 5e: telemetry on the card. (a) phase 5's fleet traced: the
    states bit-equal to phase 5's, lanes 0-7 equal to the CPU port's
    traced run, every kernel launched as in phase 5 plus one
    ``masked_lex_argmin`` an event (the decision provenance), profiled
    as phase 5 is; (b) 8 lanes of the chaos fleet and 8 ``retry_storm``
    lanes under ``queue_threshold``, traced, each equal to its CPU run,
    the chaos layer's and the closed loop's records among them; (c) lane
    0's timeline and Perfetto JSON reconciled with ``summarize``.
    Returns the launches of each traced run."""
    from repro_torch import fleet_run, make_workload_batch
    from repro_torch.core import summarize, summarize_timeline, to_perfetto_json
    from repro_torch.core.state import SimState, workload_lane
    from repro_torch.kernels import SIM_KERNELS

    # ---- (a) phase 5's fleet, traced -----------------------------------------
    params, wls = fleet["params"], fleet["wls"]
    states, traces, wall, counts, cpu_wall = traced_fleet(params, wls, dev, "phase 5's fleet")
    assert_same_states(states, fleet["states"], "phase 5e (a): traced fleet vs phase 5")
    events = counts["fleet_tick"]
    want = {**fleet_counts, "masked_lex_argmin": fleet_counts["masked_lex_argmin"] + events}
    if counts != want:
        raise AssertionError(f"phase 5e (a): launches {counts}; phase 5's plus one "
                             f"masked_lex_argmin an event: {want}")
    n_rec = [t.n for t in traces]
    dropped = sum(t.events_dropped for t in traces)
    lanes = len(traces)
    sim_s = lanes * params.duration
    print(f"{CARD}: phase 5e (a): traced fleet_run of {lanes} lanes on {dev}: wall {wall:.3f} s "
          f"({untraced['wall_s']:.3f} s untraced, phase 5), {sim_s / wall:.3f} simulated s per "
          f"wall s ({untraced['sim_s_per_wall_s']:.3f}), {events} events ({untraced['events']}), "
          f"records a lane mean {statistics.mean(n_rec):.1f} (min {min(n_rec)}, max "
          f"{max(n_rec)}, capacity {traces[0].capacity}), {sum(n_rec)} records, {dropped} "
          f"dropped; states bit-equal to phase 5's, first {CPU_LANES_5E} lanes' records equal "
          f"to the CPU port's (CPU wall {cpu_wall:.3f} s)")
    print("phase 5e (a) launches:", json.dumps(counts))
    busy = profile_call(lambda: fleet_run(params, workloads=wls, device=dev, trace=True),
                        "phase 5e (a)")
    busy.pop("result", None)
    if busy and untraced.get("busy_share") is not None:
        print(f"{CARD}: phase 5e (a): {busy['device_launches'] / events:.1f} device kernels an "
              f"event ({untraced['device_launches'] / untraced['events']:.1f} untraced, phase "
              f"5), device busy {100 * busy['busy_share']:.1f}% of wall under the profiler "
              f"({100 * untraced['busy_share']:.1f}%)")
    all_counts = [counts]

    # ---- (c) lane 0: the timeline and the Perfetto JSON against summarize ----
    trace = traces[0]
    if trace.events_dropped:
        raise AssertionError(f"phase 5e (c): lane 0 dropped {trace.events_dropped} records")
    summary = summarize(SimState(*(x[0] for x in states)), workload_lane(wls, 0), params,
                        trace=trace)
    by_cat = {}
    for ev in json.loads(to_perfetto_json(trace, params))["traceEvents"]:
        if ev.get("ph") in ("X", "i"):
            by_cat[ev.get("cat")] = by_cat.get(ev.get("cat"), 0) + 1
    kinds = trace.counts_by_kind()
    timeline = summarize_timeline(trace, params)
    pairs = {"complete": "done", "preempt": "preempt_events", "cold_start": "cold_starts",
             "cache_hit": "cache_hits", "oom": "oom_events", "reject": "failed"}
    for kind, key in pairs.items():
        if not by_cat.get(kind, 0) == kinds[kind] == summary[key]:
            raise AssertionError(f"phase 5e (c): {kind}: Perfetto {by_cat.get(kind, 0)}, "
                                 f"records {kinds[kind]}, summarize {summary[key]}")
    completed = sum(w["completed"] for w in timeline["windows"])
    if not (completed == timeline["overall"]["completed"] == summary["done"]
            and summary["trace_enabled"] and summary["events_dropped"] == 0):
        raise AssertionError(f"phase 5e (c): timeline {timeline['overall']} against "
                             f"summarize done {summary['done']}")
    print(f"phase 5e (c): lane 0's Perfetto JSON, timeline and records reconcile with "
          f"summarize: " + json.dumps({k: kinds[k] for k in pairs}))

    # ---- (b) the chaos layer and the closed loop, traced ---------------------
    fired = dict.fromkeys(("fault", "retry", "pool_down", "pool_up", "timeout",
                           "admit_reject", "client_retry", "shed"), 0)
    chaos = fleet_params(num_pools=2, scheduling_algo="priority_pool", **CHAOS)
    storm, storm_params = overload_storm("queue_threshold", {"admit_queue_limit": 3})
    runs = [("chaos fleet", chaos, make_workload_batch(chaos, list(range(8)))),
            ("retry_storm lanes under queue_threshold", storm_params, storm)]
    for label, p, w in runs:
        _, tr, wall, counts, cpu_wall = traced_fleet(p, w, dev, label)
        for name in SIM_KERNELS:
            if counts[name] <= 0:
                raise AssertionError(f"phase 5e (b): {label}: {name} was not launched")
        kinds = {k: sum(t.counts_by_kind()[k] for t in tr) for k in fired}
        for k in fired:
            fired[k] += kinds[k]
        print(f"{CARD}: phase 5e (b): {label}: traced fleet_run of {len(tr)} lanes on {dev}: "
              f"wall {wall:.3f} s, {counts['fleet_tick']} events, "
              f"{sum(t.n for t in tr)} records, {sum(t.events_dropped for t in tr)} dropped; "
              f"equal to the CPU port's (CPU wall {cpu_wall:.3f} s); " + json.dumps(kinds))
        print(f"phase 5e (b) {label} launches:", json.dumps(counts))
        all_counts.append(counts)
    quiet = [k for k in ("fault", "retry", "pool_down") if fired[k] <= 0]
    if fired["admit_reject"] + fired["client_retry"] <= 0:
        quiet.append("admit_reject / client_retry")
    if quiet:
        raise AssertionError(f"phase 5e (b): record kinds that never appeared: {quiet}")
    return all_counts


# ---------------------------------------------------------------------------
# Phase 11: policy search on the card.
# ---------------------------------------------------------------------------
# benchmarks/policy_search.py:45-61, the search arena: a saturating 4-CPU
# box with two pools, the data plane and cloud bursting
SEARCH_PARAMS = dict(
    seed=0, scheduling_algo="policy", max_pipelines=24, max_containers=32, duration=0.2,
    waiting_ticks_mean=500.0, op_base_seconds_mean=0.002, num_pools=2, total_cpus=4,
    total_ram_gb=8, cache_gb_per_pool=4.0, scan_ticks_per_gb=100.0, cold_start_ticks=40,
    container_warm_ticks=2_000, cloud_scaling=True,
)
# benchmarks/policy_search.py:search_smoke
SEARCH_SMOKE = dict(seed=3, generations=1, population=12, rungs=(0.5, 1.0))


def search_phase(dev) -> dict:
    """Phase 11: ``search_smoke`` on the card and on the CPU port; the
    same candidate history (indices, origins, policies, rung lane
    counts, survivors and elites) and front members, the objectives and
    scores under the contract, every baseline weakly dominated by a
    front member. Returns the launches of the card's search."""
    import torch

    from repro_torch import SimParams
    from repro_torch.kernels import SIM_KERNELS, launch_counts, reset_launch_counts
    from repro_torch.search import cem_search, weakly_dominates
    from repro_torch.search.grid import scenario_factory

    arena = SimParams(**SEARCH_PARAMS)

    def search(device):
        make = scenario_factory(["bursty"], arena, 4, seed=7, device=device)
        return cem_search(make, device=device, **SEARCH_SMOKE)

    reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = search(dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts()
    t1 = time.perf_counter()
    cpu = search("cpu")
    cpu_wall = time.perf_counter() - t1

    def close(a, b, ctx):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        if a.shape != b.shape or not np.allclose(a, b, rtol=RTOL, atol=0.0, equal_nan=True):
            raise AssertionError(f"phase 11: {ctx} differs from the CPU port's beyond rtol {RTOL}")

    def same(a, b, ctx):
        if a != b:
            raise AssertionError(f"phase 11: {ctx} differs from the CPU port's: {a} vs {b}")

    same(len(res.history), len(cpu.history), "the number of generations")
    for g, (h, c) in enumerate(zip(res.history, cpu.history)):
        for key in ("policies", "origin", "survivors", "elites", "mean", "std"):
            same(h[key], c[key], f"generation {g}'s {key}")
        close(h["best_score"], c["best_score"], f"generation {g}'s best score")
        same(len(h["rungs"]), len(c["rungs"]), f"generation {g}'s rungs")
        for r, (hr, cr) in enumerate(zip(h["rungs"], c["rungs"])):
            same((hr["lanes"], hr["candidates"]), (cr["lanes"], cr["candidates"]),
                 f"generation {g}, rung {r}'s lanes and candidates")
            close(hr["scores"], cr["scores"], f"generation {g}, rung {r}'s scores")
            close(hr["objectives"], cr["objectives"], f"generation {g}, rung {r}'s objectives")
    same(res.pareto_policies.tolist(), cpu.pareto_policies.tolist(), "the front's members")
    close(res.pareto_objectives, cpu.pareto_objectives, "the front's objectives")
    close(res.baseline_objectives, cpu.baseline_objectives, "the baselines' objectives")
    same(res.evaluations, cpu.evaluations, "the evaluations")
    same(res.champion and res.champion["origin"], cpu.champion and cpu.champion["origin"],
         "the champion")
    for name, brow in zip(res.baseline_names, res.baseline_objectives):
        if not any(weakly_dominates(f, brow) for f in res.pareto_objectives):
            raise AssertionError(f"phase 11: no front member weakly dominates baseline {name}")
    for name in SIM_KERNELS:
        if counts[name] <= 0:
            raise AssertionError(f"phase 11: {name} was not launched")
    n_cand = SEARCH_SMOKE["generations"] * SEARCH_SMOKE["population"]
    row = {
        "search": "cem_smoke", "candidates": n_cand, "evaluations": res.evaluations,
        "wall_s": round(wall, 3), "candidates_per_s": round(n_cand / wall, 2),
        "lane_evals_per_s": round(res.evaluations / wall, 1),
        "front_size": int(len(res.pareto_objectives)), "champion": res.champion is not None,
    }
    print(f"{CARD}: phase 11: cem_search on {dev}: wall {wall:.3f} s, {res.evaluations} lane "
          f"evaluations, {n_cand / wall:.3f} candidates/s, {res.evaluations / wall:.3f} lane "
          f"evaluations/s, front of {len(res.pareto_objectives)}; the same history and front "
          f"as the CPU port (CPU wall {cpu_wall:.3f} s), every baseline weakly dominated by a "
          f"front member; " + json.dumps(row))
    print("phase 11 launches:", json.dumps(counts))
    return counts


# ---------------------------------------------------------------------------
# Phase 12: the paper's surface (Listings 3 and 4, the Python engine, the
# CLI).
# ---------------------------------------------------------------------------
# the fields the reference holds its two engines to exactly
# (tests/test_engine_equivalence.py:16-51); its tolerant fields are the
# contract's TOLERANT_FIELDS at rtol 1e-3, atol 1e-4 (:84-91)
ENGINE_FIELDS = (
    "pipe_status", "pipe_completion", "pipe_fails", "pipe_preempts", "done_count",
    "failed_count", "oom_events", "preempt_events", "cache_hits", "cache_lookups",
    "cold_starts", "warm_starts", "cold_start_tick_total", "cache_hit_gb", "bytes_moved_gb",
    "cache_bytes", "cache_last", "pool_cache_used", "pipe_retries", "ctr_timed",
    "pool_down_until", "crash_cursor", "outage_cursor", "nxt_fault", "crash_events",
    "outage_events", "timeout_events", "retry_events", "fault_kills", "wasted_ticks",
)
ENGINE_RTOL, ENGINE_ATOL = 1e-3, 1e-4
PROJECT_TOML = ROOT / "examples" / "project.toml"


def compare_engines(python_state, event_state, ctx: str, closed_loop: bool = False) -> None:
    """The Python engine's state against the event engine's: the
    reference's compared fields (and, with the closed loop on, the
    closed-loop fields) exactly, the tolerant fields at its tolerance."""
    from repro_torch.core.state import CLOSED_LOOP_FIELDS

    exact = ENGINE_FIELDS + (CLOSED_LOOP_FIELDS if closed_loop else ())
    for name in exact + tuple(sorted(TOLERANT_FIELDS)):
        a = getattr(python_state, name).cpu().numpy()
        b = getattr(event_state, name).cpu().numpy()
        if a.dtype != b.dtype or a.shape != b.shape:
            raise AssertionError(f"{ctx}: field {name} {a.dtype}{a.shape} vs {b.dtype}{b.shape}")
        if name in TOLERANT_FIELDS:
            if not np.allclose(a, b, rtol=ENGINE_RTOL, atol=ENGINE_ATOL):
                raise AssertionError(f"{ctx}: field {name} beyond rtol {ENGINE_RTOL}")
        elif not np.array_equal(a, b):
            raise AssertionError(f"{ctx}: field {name} differs between the engines")


def assert_summary_equal(got: dict, want: dict, ctx: str) -> None:
    """Two summaries under the contract: floats to rtol 1e-5 (NaN equal
    to NaN), everything else exactly."""
    if set(got) != set(want):
        raise AssertionError(f"{ctx}: keys differ: {sorted(set(got) ^ set(want))}")
    for key, w in want.items():
        g = got[key]
        if isinstance(w, dict):
            assert_summary_equal(g, w, f"{ctx}.{key}")
        elif isinstance(w, float) and not isinstance(w, bool):
            if not (math.isclose(g, w, rel_tol=RTOL) or (g != g and w != w)):
                raise AssertionError(f"{ctx}.{key}: {g!r} vs {w!r}")
        elif g != w:
            raise AssertionError(f"{ctx}.{key}: {g!r} vs {w!r}")


def register_listing4() -> str:
    """``examples/custom_scheduler.py``'s smallest-job-first scheduler
    (paper Listings 4-6), registered through ``eudoxia_torch.algorithm``;
    returns its key."""
    from eudoxia_torch.algorithm import register_scheduler, register_scheduler_init
    from eudoxia_torch.core import Assignment

    @register_scheduler_init(key="my-scheduler")
    def scheduler_init(sch):
        sch.data["chunk"] = 0.25  # allocate quarter-pool containers

    @register_scheduler(key="my-scheduler")
    def scheduler_algo(sch, f, p):
        suspends, assignments = [], []
        frac = sch.data["chunk"]
        want_cpu = frac * sch.pool_cpu_cap[0]
        want_ram = frac * sch.pool_ram_cap[0]
        free_cpu = list(sch.pool_cpu_free)
        free_ram = list(sch.pool_ram_free)
        # smallest job first (by op count, then priority)
        for pid in sorted(
            sch.waiting_pids(),
            key=lambda pid: (sch.pipeline(pid).num_ops, -int(sch.pipeline(pid).priority)),
        ):
            pipe = sch.pipeline(pid)
            cpu = max(want_cpu, pipe.last_cpus * 2 if pipe.failed_before else want_cpu)
            ram = max(want_ram, pipe.last_ram_gb * 2 if pipe.failed_before else want_ram)
            if free_cpu[0] >= cpu and free_ram[0] >= ram:
                assignments.append(Assignment(pipe, 0, cpu, ram))
                free_cpu[0] -= cpu
                free_ram[0] -= ram
        return suspends, assignments

    return "my-scheduler"


def surface_phase(dev, cache: dict, grid: dict, chaos: dict, loop: dict) -> list[dict]:
    """Phase 12: the paper's surface on the card. (a) Listing 3:
    ``eudoxia_torch.run_simulator(examples/project.toml)`` on CUDA, held
    to ``run(engine="python")`` of the same file; (b) the Python engine
    against the card's event engine at phase 5c's configuration (its five
    CUDA states and one new ``priority`` run), against 6b's chaos run,
    lane 0 of 6c (a)'s closed-loop fleet and, under ``"policy"``, each of
    5d's six points; (c) Listing 4's scheduler on the Python engine
    beside ``priority`` on CUDA; (d) the CLI as a subprocess on CUDA on
    ``project.toml`` cut to 0.5 s, its JSON equal to the in-process run.
    Returns the launches of the CUDA runs."""
    import os
    import tempfile

    import torch

    import eudoxia_torch as eudoxia
    from repro_torch import run
    from repro_torch.core.state import tree_map
    from repro_torch.kernels import SIM_KERNELS, launch_counts, reset_launch_counts

    def python_run(params, wl):
        reset_launch_counts()
        t0 = time.perf_counter()
        res = run(params, wl, engine="python", device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launched = {k: v for k, v in launch_counts().items() if v}
        if launched:
            raise AssertionError(f"phase 12: the Python engine launched kernels: {launched}")
        return res, wall

    def fleet_of_one(wl):
        return tree_map(lambda x: x[None], wl)

    rows = []

    def report(label, py, py_wall, card_wall, card_what):
        rows.append({"run": label, "python_wall_s": round(py_wall, 3), "events": py.events,
                     "card_wall_s": round(card_wall, 3), "card_run": card_what})
        print(f"{CARD}: phase 12: {label}: Python engine {py_wall:.3f} s wall, {py.events} "
              f"events; the card's {card_what} {card_wall:.3f} s; equal on the reference's "
              f"compared fields")

    # ---- (a) Listing 3 --------------------------------------------------------
    reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = eudoxia.run_simulator(str(PROJECT_TOML), device=dev)
    torch.cuda.synchronize()
    card_wall = time.perf_counter() - t0
    listing3_counts = launch_counts()
    quiet = [name for name in SIM_KERNELS if listing3_counts[name] <= 0]
    if quiet:
        raise AssertionError(f"phase 12 (a): run_simulator launched no {quiet}")
    py, py_wall = python_run(str(PROJECT_TOML), None)
    for name in res.workload._fields[:10]:
        if not torch.equal(getattr(res.workload, name), getattr(py.workload, name)):
            raise AssertionError(f"phase 12 (a): the two runs' workloads differ in {name}")
    compare_engines(py.state, res.state, "phase 12 (a): project.toml")
    summary = res.summary()
    if summary["done"] <= 0 or summary["cache_hits"] <= 0:
        raise AssertionError(f"phase 12 (a): project.toml did no work or hit no cache: {summary}")
    report("(a) run_simulator(project.toml)", py, py_wall, card_wall,
           f"run_simulator ({res.events} events)")
    print("phase 12 (a) summary:", json.dumps(summary, sort_keys=True))
    print("phase 12 (a) launches:", json.dumps(listing3_counts))

    # ---- (b) the Python engine against the card's event engine ---------------
    base, wl = cache["params"], cache["wl"]
    for algo, (event, wall) in cache["runs"].items():
        py, py_wall = python_run(base.replace(scheduling_algo=algo), wl)
        compare_engines(py.state, event.state, f"phase 12 (b): {algo}")
        report(f"(b) 5c {algo}", py, py_wall, wall, "run (phase 5c)")
    params = base.replace(scheduling_algo="priority")
    event, wall, priority_counts = timed_run(params, wl, dev)
    py, py_wall = python_run(params, wl)
    compare_engines(py.state, event.state, "phase 12 (b): priority")
    report("(b) 5c priority", py, py_wall, wall, "run (new)")
    priority = event

    res = chaos["res"]
    py, py_wall = python_run(chaos["params"], fleet_of_one(res.workload))
    compare_engines(py.state, res.state, "phase 12 (b): chaos run(seed 0)")
    if int(py.state.retry_events) <= 0 or int(py.state.fault_kills) <= 0:
        raise AssertionError("phase 12 (b): the chaos run retried or killed nothing")
    report("(b) 6b chaos run(seed 0)", py, py_wall, chaos["wall"], "run (phase 6b)")

    py, py_wall = python_run(loop["params"], loop["wl"])
    compare_engines(py.state, loop["state"], "phase 12 (b): 6c (a) lane 0", closed_loop=True)
    if int(py.state.offered_total) <= 0:
        raise AssertionError("phase 12 (b): the closed-loop lane offered nothing")
    report("(b) 6c (a) lane 0", py, py_wall, loop["wall"],
           f"fleet_run of {loop['lanes']} lanes (phase 6c (a))")

    params = grid["params"].replace(scheduling_algo="policy")
    for c, name in enumerate(grid["names"]):
        lane = c * grid["S"]
        py, py_wall = python_run(params, tree_map(lambda x: x[lane:lane + 1], grid["grid"]))
        compare_engines(py.state, tree_map(lambda x: x[lane], grid["states"]),
                        f"phase 12 (b): policy point {name}")
        report(f"(b) 5d policy {name}", py, py_wall, grid["wall"],
               f"fleet_run of {grid['grid'].arrival.shape[0]} lanes (phase 5d)")

    # ---- (c) Listing 4 ---------------------------------------------------------
    key = register_listing4()
    mine, mine_wall = python_run(base.replace(scheduling_algo=key), wl)
    a, b = mine.summary(), priority.summary()
    if a["done"] <= 0:
        raise AssertionError(f"phase 12 (c): {key} completed nothing")
    print(f"{CARD}: phase 12 (c): Listing 4's {key} on the Python engine at phase 5c's "
          f"configuration: {mine_wall:.3f} s wall, {mine.events} events, state on "
          f"{mine.state.done_count.device}")
    print(f"  {'metric':22s} {key:>14s} {'priority':>14s}")
    for k in ("done", "throughput_per_s", "mean_latency_s", "p99_latency_s",
              "cpu_utilization", "oom_events", "cache_hit_rate"):
        print(f"  {k:22s} {a[k]!s:>14.14s} {b[k]!s:>14.14s}")

    # ---- (d) the CLI -----------------------------------------------------------
    with tempfile.TemporaryDirectory() as tmp:
        tmp = pathlib.Path(tmp)
        toml = tmp / "project.toml"
        text, n = re.subn(r"(?m)^duration = .*$", "duration = 0.5", PROJECT_TOML.read_text())
        if n != 1:
            raise AssertionError("phase 12 (d): project.toml holds no duration line")
        toml.write_text(text)
        out_json, out_csv = tmp / "summary.json", tmp / "timeline.csv"
        env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.sim", str(toml), "--json", str(out_json),
             "--csv", str(out_csv)],
            cwd=ROOT, env=env, capture_output=True, text=True, timeout=600,
        )
        cli_wall = time.perf_counter() - t0
        if proc.returncode != 0:
            raise AssertionError(f"phase 12 (d): the CLI exited {proc.returncode}: "
                                 f"{proc.stderr[-2000:]}")
        sections = re.split(r"(?m)^== (.+) ==$", proc.stdout)
        texts = dict(zip(sections[1::2], (t.strip() for t in sections[2::2])))
        names = ("summary", "per priority", "utilisation", "latency distribution")
        empty = [n for n in names if not texts.get(n)]
        if empty or not out_csv.read_text().strip():
            raise AssertionError(f"phase 12 (d): empty renderings {empty} or CSV")
        inproc, _, cli_counts = timed_run(str(toml), None, dev)
        assert_summary_equal(json.loads(out_json.read_text()), inproc.summary(),
                             "phase 12 (d): --json")
        print(f"{CARD}: phase 12 (d): python -m repro_torch.launch.sim on {dev} (project.toml "
              f"at 0.5 s): exit 0 in {cli_wall:.3f} s with start-up, four renderings and "
              f"{len(out_csv.read_text().splitlines())} CSV lines; --json equal to the "
              f"in-process run under the contract")
    print("phase 12 runs:", json.dumps(rows))
    print("phase 12 launches:", json.dumps({"(b) priority": priority_counts,
                                            "(d) in-process": cli_counts}))
    return [listing3_counts, priority_counts, cli_counts]


# ---------------------------------------------------------------------------
# Phases 7-9: serving through the LM substrate.
# ---------------------------------------------------------------------------
class ServeMeter:
    """Times every prefill and decode step of a batcher (each ends in a
    device synchronisation) and checks that every logit is finite."""

    def __init__(self):
        self.prefill_s, self.prefill_tokens, self.decode_s = [], 0, []

    def __enter__(self):
        import torch

        from repro_torch.models import lm

        self.lm, self.saved = lm, (lm.lm_prefill, lm.lm_decode_step)
        prefill, decode = self.saved

        def check(logits, what):
            if not bool(torch.isfinite(logits.float()).all()):
                raise AssertionError(f"{what} produced a logit that is not finite")

        def timed_prefill(cfg, params, batch, max_len=None):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, caches = prefill(cfg, params, batch, max_len=max_len)
            torch.cuda.synchronize()
            self.prefill_s.append(time.perf_counter() - t0)
            self.prefill_tokens += int(batch["tokens"].numel())
            check(logits, "prefill")
            return logits, caches

        def timed_decode(cfg, params, caches, token, pos):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, caches = decode(cfg, params, caches, token, pos)
            torch.cuda.synchronize()
            self.decode_s.append(time.perf_counter() - t0)
            check(logits, "decode")
            return logits, caches

        lm.lm_prefill, lm.lm_decode_step = timed_prefill, timed_decode
        return self

    def __exit__(self, *exc):
        self.lm.lm_prefill, self.lm.lm_decode_step = self.saved
        return False


def serve_phase(phase: int, arch_name: str, lm_kernels: tuple, dev, *, seed: int = 0,
                n_layers: int | None = None, profile: bool = True) -> dict:
    """Serve 8 requests (512-2048 prompt tokens, 16 new, 40 % interactive)
    on ``arch_name`` at its published width (and depth, unless
    ``n_layers`` cuts it), under the policy that ``evaluate_policies`` on
    CUDA picks; returns the launches; the profile (unless ``profile`` is
    False) breaks out ``lm_kernels``."""
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.kernels import SIM_KERNELS, launch_counts, reset_launch_counts
    from repro_torch.models import lm
    from repro_torch.models.common import param_count
    from repro_torch.serving import (
        ContinuousBatcher, Request, ServeRequest, evaluate_policies, pick_policy,
    )

    arch = get_arch(arch_name)
    cfg = arch.model if n_layers is None else dataclasses.replace(arch.model, n_layers=n_layers)
    rng = np.random.default_rng(seed)
    trace = [
        ServeRequest(arrival_s=float(rng.exponential(0.3) * i),
                     prompt_tokens=int(rng.integers(512, 2049)), new_tokens=16,
                     interactive=bool(rng.random() < 0.4))
        for i in range(8)
    ]
    t_init = time.perf_counter()
    params = lm.lm_init(cfg, seed, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t_init
    n_params = param_count(params)
    if n_layers is not None:
        print(f"phase {phase}: {arch_name} cut from {arch.model.n_layers} to {cfg.n_layers} "
              f"layers {[f'{sp.kind}+{sp.mlp}' for sp in (cfg.layer_spec(i) for i in range(cfg.n_layers))]}"
              f", every width as published: {n_params} parameters, "
              f"{n_params * 2 / 2**30:.2f} GiB in {cfg.param_dtype} (one MoE layer is "
              f"{3 * cfg.moe.n_experts * cfg.d_model * cfg.moe.expert_ff * 2 / 1e9:.1f} GB, "
              f"one period of {cfg.period} layers holds "
              f"{sum(sp.mlp != 'dense' for sp in cfg.pattern)}; the card has 80 GB)")
    prompts = [rng.integers(2, cfg.vocab, r.prompt_tokens).astype(np.int32) for r in trace]

    reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sim = evaluate_policies(trace, cfg, duration_s=30.0, device=dev)
    policy = pick_policy(sim)
    torch.cuda.synchronize()
    sim_s = time.perf_counter() - t0
    batcher = ContinuousBatcher(cfg, params, slots=4, max_len=4096, policy=policy)
    for i, (r, toks) in enumerate(zip(trace, prompts)):
        batcher.submit(Request(rid=i, tokens=toks, max_new=r.new_tokens, interactive=r.interactive))
    torch.cuda.reset_peak_memory_stats()
    t1 = time.perf_counter()
    with ServeMeter() as meter:
        done = batcher.run_to_completion()
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t1
    counts = launch_counts()

    if sorted(r.rid for r in done) != list(range(len(trace))):
        raise AssertionError(f"phase {phase}: served {sorted(r.rid for r in done)} of {len(trace)}")
    for name in (*SIM_KERNELS, *lm_kernels):
        if counts[name] <= 0:
            raise AssertionError(f"phase {phase}: {name} was not launched")
    for name, s in sim.items():
        inter = s["per_priority"]["interactive"]
        print(f"phase {phase} simulator: {name:14s} thr={s['throughput_per_s']:.3f}/s "
              f"inter_lat={inter['mean_latency_s']} pre={s['preempt_events']} oom={s['oom_events']}")
    prefill_s = sum(meter.prefill_s)
    print(f"{CARD}: phase {phase}: {arch_name} at full width ({n_params} parameters, "
          f"{cfg.param_dtype}, drawn on the card in {init_s:.2f} s): policy {policy} "
          f"(simulator {sim_s:.2f} s), served {len(done)} requests in {serve_s:.2f} s; "
          f"{len(meter.prefill_s)} prefills of {meter.prefill_tokens} tokens in "
          f"{prefill_s:.3f} s = {meter.prefill_tokens / prefill_s:.1f} prefill tokens/s; "
          f"{len(meter.decode_s)} decode steps of 4 slots, "
          f"{1e3 * statistics.mean(meter.decode_s):.3f} ms per step (median "
          f"{1e3 * statistics.median(meter.decode_s):.3f}); peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB of the card's "
          f"{torch.cuda.get_device_properties(0).total_memory / 2**30:.2f}; every logit finite")
    print(f"phase {phase} prompts: {[int(r.prompt_tokens) for r in trace]}, interactive "
          f"{[r.interactive for r in trace]}, outputs {[(r.rid, len(r.out)) for r in done]}")
    print(f"phase {phase} launches:", json.dumps(counts))
    if profile:
        t_prof = time.perf_counter()
        profile_serving(phase, cfg, params, batcher, max(prompts, key=len), lm_kernels, dev)
        print(f"phase {phase} profile windows: {time.perf_counter() - t_prof:.2f} s")
    else:
        print(f"phase {phase} profile windows: cut for {arch_name}")
    del params, batcher, done
    gc.collect()
    torch.cuda.empty_cache()
    return counts


def profile_serving(phase, cfg, params, batcher, prompt, lm_kernels, dev) -> None:
    """Where a prefill's and a decode step's time goes: one prefill of
    the longest prompt, then 4 decode steps of the 4 slots, each under
    torch.profiler; wall time against the summed device time of every
    CUDA kernel (the device's busy share), the LM kernel's share of the
    device time, and the kernels that take the most."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models import lm

    toks = torch.as_tensor(prompt, device=dev)[None]
    last = torch.zeros(batcher.slots, dtype=torch.int32, device=dev)
    pos = int(batcher.pos.max())
    windows = (
        ("prefill", lambda: lm.lm_prefill(cfg, params, {"tokens": toks}, max_len=batcher.max_len)),
        ("decode x4", lambda: [lm.lm_decode_step(cfg, params, batcher.caches, last, pos + i)
                               for i in range(4)]),
    )
    for label, fn in windows:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        rows = [e for e in prof.key_averages()
                if str(getattr(e, "device_type", "")).endswith("CUDA")]
        if not rows:
            print(f"phase {phase} profile {label}: no CUDA kernels in the trace; not measured")
            continue
        busy_ms = sum(e.device_time_total for e in rows) / 1e3
        mine = {k: sum(e.device_time_total for e in rows if f"{k}_kernel" in e.key) / 1e3
                for k in lm_kernels}
        mine_text = ", ".join(f"{k} {ms:.1f} ms ({100 * ms / busy_ms:.1f}% of busy)"
                              for k, ms in mine.items())
        print(f"{CARD}: phase {phase} profile {label} ({len(prompt) if label == 'prefill' else 4 * batcher.slots}"
              f" tokens): wall {wall_ms:.1f} ms (under the profiler), device busy {busy_ms:.1f} ms "
              f"({100 * busy_ms / wall_ms:.1f}% of wall), {mine_text}, "
              f"{sum(e.count for e in rows)} kernel launches")
        for e in sorted(rows, key=lambda e: -e.device_time_total)[:6]:
            print(f"  {e.device_time_total / 1e3:9.3f} ms  {e.count:6d}x  {e.key[:90]}")


def parity_archs() -> list[str]:
    """Every decoder-only architecture of the registry (all but the
    audio family), in the registry's order."""
    from repro_torch.configs import get_arch, list_archs

    return [name for name in list_archs() if get_arch(name).model.family != "audio"]


def f32_smoke(name: str):
    import torch

    from repro_torch.configs import get_arch

    return dataclasses.replace(get_arch(name).smoke, param_dtype=torch.float32,
                               compute_dtype=torch.float32)


def parity_phase(dev) -> None:
    """Phase 9: the smoke configs in f32 on CUDA against the CPU port:
    equal greedy tokens, prefill logits within 2e-4. Every decoder-only
    one through the batcher (jamba smoke puts the Mamba prefill
    (``ssm_scan``) and decode, and the per-row and global MoE, on the
    card; arctic the dense MLP beside the MoE, llama4 the shared expert,
    granite MQA and GELU); internvl2_2b once more through ``lm_prefill``
    with patch embeddings in its first positions and 4 greedy steps;
    whisper_small through ``runtime.make_serve_steps`` (encoder, decoder
    prefill, 6 greedy steps)."""
    import torch

    from repro_torch.models import VIT_DIM, encdec, lm
    from repro_torch.runtime import make_serve_steps, model_init
    from repro_torch.serving import ContinuousBatcher, Request

    def check(name, logits, outs, what):
        err = (logits["cuda"].cpu() - logits["cpu"]).abs().max().item()
        if err > 2e-4:
            raise AssertionError(f"phase 9: {name} {what} prefill logits differ by {err}")
        if outs["cuda"] != outs["cpu"]:
            raise AssertionError(f"phase 9: {name} {what} tokens differ: {outs['cuda']} vs "
                                 f"{outs['cpu']}")
        return err

    def greedy_parity(name, what, base, prefill, decode, batch, max_len, start, steps):
        """``prefill`` then ``steps`` greedy ``decode`` steps from
        position ``start``, on the card and on the CPU from copies of
        ``base``; checked by ``check``."""
        outs, logits = {}, {}
        for d in (dev, torch.device("cpu")):
            params = copy.deepcopy(base).to(d)
            lg, caches = prefill(params, {k: v.to(d) for k, v in batch.items()}, max_len)
            logits[d.type], out = lg, []
            for pos in range(start, start + steps):
                nxt = torch.argmax(lg, dim=-1).to(torch.int32)
                out.append(nxt.tolist())
                lg, caches = decode(params, caches, nxt, pos)
            outs[d.type] = out
        return check(name, logits, outs, what)

    for name in parity_archs():
        cfg = f32_smoke(name)
        base = lm.lm_init(cfg, 0, device="cpu")
        rng = np.random.default_rng(1)
        prompts = [rng.integers(2, cfg.vocab, n).astype(np.int32) for n in (11, 23, 17, 30)]
        toks = torch.from_numpy(prompts[1])[None]
        outs, logits = {}, {}
        for d in (dev, torch.device("cpu")):
            params = copy.deepcopy(base).to(d)
            logits[d.type], _ = lm.lm_prefill(cfg, params, {"tokens": toks.to(d)}, max_len=48)
            b = ContinuousBatcher(cfg, params, slots=2, max_len=48)
            for i, p in enumerate(prompts):
                b.submit(Request(rid=i, tokens=p, max_new=6, interactive=i == 3))
            outs[d.type] = [(r.rid, r.out) for r in b.run_to_completion()]
        err = check(name, logits, outs, "batcher")
        print(f"{CARD}: phase 9: {cfg.name} f32, CUDA == CPU: {len(outs['cpu'])} requests, "
              f"{sum(len(o) for _, o in outs['cpu'])} greedy tokens equal, prefill logits "
              f"max |diff| {err:.3g} (<= 2e-4)")

    # internvl2_2b's frontend: 8 patch embeddings then tokens, 4 greedy steps
    cfg = f32_smoke("internvl2_2b")
    base = lm.lm_init(cfg, 0, device="cpu")
    rng = np.random.default_rng(2)
    toks = torch.from_numpy(rng.integers(2, cfg.vocab, (2, 24)).astype(np.int32))
    fe = torch.from_numpy(rng.standard_normal((2, cfg.n_img_tokens, VIT_DIM)).astype(np.float32))
    err = greedy_parity(
        "internvl2_2b", "frontend", base,
        lambda params, batch, max_len: lm.lm_prefill(cfg, params, batch, max_len=max_len),
        lambda params, caches, nxt, pos: lm.lm_decode_step(cfg, params, caches, nxt, pos),
        {"tokens": toks, "frontend_embeds": fe}, 32, 24, 4)
    print(f"{CARD}: phase 9: {cfg.name} f32 with {cfg.n_img_tokens} patch embeddings, CUDA == CPU: "
          f"2 x 4 greedy tokens equal, prefill logits max |diff| {err:.3g} (<= 2e-4)")

    # whisper_small: encoder over 150 frames, 4 start tokens, 6 greedy steps
    cfg = f32_smoke("whisper_small")
    base = model_init(cfg, 0, device="cpu")
    prefill, decode = make_serve_steps(cfg)
    rng = np.random.default_rng(3)
    frames = torch.from_numpy(rng.standard_normal((2, 150, VIT_DIM)).astype(np.float32))
    toks = torch.from_numpy(rng.integers(2, cfg.vocab, (2, 4)).astype(np.int32))
    err = greedy_parity("whisper_small", "make_serve_steps", base, prefill, decode,
                        {"tokens": toks, "frontend_embeds": frames}, encdec.dec_len(cfg, 150), 4, 6)
    print(f"{CARD}: phase 9: {cfg.name} f32 through make_serve_steps, CUDA == CPU: 2 x 6 greedy "
          f"tokens equal, prefill logits max |diff| {err:.3g} (<= 2e-4)")


# ---------------------------------------------------------------------------
# Phases 13-15: the rest of the served zoo at published width.
# ---------------------------------------------------------------------------
# arch, layers served (None: every one), profiled. arctic: 128 experts of
# 3 x 7168 x 4864 are 26.8 GB a layer, so two layers (55.4 GB of weights)
# and not three (82.7); llama4: two (attn+dense, attn+moe) periods, 70.7
# GB. The dense three are not profiled: tracing their 4,000-30,000
# kernels a window on the host took most of the phase's wall
ZOO_SERVED = (
    ("gemma3_27b", None, False), ("granite_34b", None, False), ("phi3_mini_3p8b", None, False),
    ("arctic_480b", 2, True), ("llama4_maverick_400b_a17b", 4, True),
)


# phase 14 (b): requests, positions (the first 256 patch embeddings), steps
VLM_FRONTEND = (4, 1024, 16)
# phase 15: label, clips, frames a clip, greedy steps
WHISPER_CLIPS = (("(a)", 8, 1500, 32), ("(b)", 1, 32768, 16))


def zoo_phase(dev) -> list[dict]:
    """Phase 13: the five text configs at their published widths through
    ``serve_phase``; returns each one's launches."""
    return [serve_phase(13, name, ("flash_attention",), dev, n_layers=n_layers, profile=profile)
            for name, n_layers, profile in ZOO_SERVED]


class FlashCalls:
    """Records (causal, B, Sq, Skv) of every ``flash_attention`` call the
    models make (the kernel's wrapper counts its launches itself)."""

    def __enter__(self):
        from repro_torch.models import attention

        self.module, self.saved, self.calls = attention, attention.flash_attention, []

        def recorded(q, k, v, **kw):
            self.calls.append((bool(kw.get("causal", True)), q.shape[0], q.shape[1], k.shape[1]))
            return self.saved(q, k, v, **kw)

        attention.flash_attention = recorded
        return self

    def __exit__(self, *exc):
        self.module.flash_attention = self.saved


def finite(logits, what: str) -> None:
    import torch

    if not bool(torch.isfinite(logits.float()).all()):
        raise AssertionError(f"{what} produced a logit that is not finite")


def vlm_phase(dev) -> list[dict]:
    """Phase 14: internvl2_2b at full size: (a) the batcher serve of
    ``serve_phase``; (b) its frontend path: 4 requests whose first 256
    positions are patch embeddings [4, 256, 1024] from a numpy seed, one
    1,024-position ``lm_prefill`` of the 4, then 16 greedy decode steps;
    every logit finite, and the prefill logits move when the embeddings
    do. Returns the launches of (a) and (b)."""
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import VIT_DIM, lm

    served = serve_phase(14, "internvl2_2b", ("flash_attention",), dev)
    cfg = get_arch("internvl2_2b").model
    params = lm.lm_init(cfg, 0, device=dev)
    rng = np.random.default_rng(14)
    B, S, steps = VLM_FRONTEND
    toks = torch.as_tensor(rng.integers(2, cfg.vocab, (B, S)).astype(np.int32), device=dev)
    fe = torch.as_tensor(rng.standard_normal((B, cfg.n_img_tokens, VIT_DIM)).astype(np.float32),
                         device=dev)
    reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, caches = lm.lm_prefill(cfg, params, {"tokens": toks, "frontend_embeds": fe},
                                   max_len=S + steps)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    finite(logits, "phase 14 (b) prefill")
    first = logits.float()
    step_s = []
    for pos in range(S, S + steps):
        nxt = torch.argmax(logits, dim=-1).to(torch.int32)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, caches = lm.lm_decode_step(cfg, params, caches, nxt, pos)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        finite(logits, "phase 14 (b) decode")
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    # the same prompts with other patch embeddings: the logits move
    other, _ = lm.lm_prefill(cfg, params, {"tokens": toks, "frontend_embeds": -fe}, max_len=S + steps)
    moved = (other.float() - first).abs().max().item()
    if not moved > 0:
        raise AssertionError("phase 14 (b): the prefill logits do not move with the embeddings")
    if counts["flash_attention"] <= 0:
        raise AssertionError("phase 14 (b): flash_attention was not launched")
    print(f"{CARD}: phase 14 (b): internvl2_2b frontend path, {B} requests of {cfg.n_img_tokens} "
          f"patch embeddings + {S - cfg.n_img_tokens} tokens: prefill {1e3 * prefill_s:.3f} ms "
          f"({B * S / prefill_s:.1f} tokens/s), {steps} decode steps "
          f"{1e3 * statistics.mean(step_s):.3f} ms per step (median "
          f"{1e3 * statistics.median(step_s):.3f}), peak memory {peak:.2f} GiB; every logit finite; "
          f"other embeddings move the prefill logits by up to {moved:.4g}; launches "
          f"{json.dumps(counts)}")
    del params, caches
    gc.collect()
    torch.cuda.empty_cache()
    return [served, counts]


def whisper_phase(dev) -> list[dict]:
    """Phase 15: whisper_small at full size through
    ``runtime.make_serve_steps``: (a) 8 clips of 1,500 frames (the 30 s
    window after the stride-2 convolution), 4 start tokens, 32 greedy
    steps, ``max_dec = dec_len(1500)``; (b) one long-form clip of 32,768
    frames, 16 steps. Encoder ms, prefill ms (encoder included), ms per
    decode step and peak memory; every logit finite, ``flash_attention``
    launched, not causal for the encoder and every cross-attention call.
    Returns the launches of (a) and (b)."""
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import VIT_DIM, encdec
    from repro_torch.models.common import param_count
    from repro_torch.runtime import make_serve_steps, model_init

    cfg = get_arch("whisper_small").model
    t0 = time.perf_counter()
    params = model_init(cfg, 0, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    prefill, decode = make_serve_steps(cfg)
    rng = np.random.default_rng(15)
    out = []
    for label, B, S_enc, steps in WHISPER_CLIPS:
        frames = torch.as_tensor(rng.standard_normal((B, S_enc, VIT_DIM)).astype(np.float32),
                                 device=dev)
        toks = torch.as_tensor(rng.integers(2, cfg.vocab, (B, 4)).astype(np.int32), device=dev)
        max_dec = encdec.dec_len(cfg, S_enc)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        enc = encdec.encode(cfg, params, frames)
        torch.cuda.synchronize()
        enc_s = time.perf_counter() - t0
        del enc
        reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        step_s = []
        with FlashCalls() as flash:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, caches = prefill(params, {"tokens": toks, "frontend_embeds": frames}, max_dec)
            torch.cuda.synchronize()
            prefill_s = time.perf_counter() - t0
            finite(logits, f"phase 15 {label} prefill")
            for pos in range(4, 4 + steps):
                nxt = torch.argmax(logits, dim=-1).to(torch.int32)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                logits, caches = decode(params, caches, nxt, pos)
                torch.cuda.synchronize()
                step_s.append(time.perf_counter() - t0)
                finite(logits, f"phase 15 {label} decode")
        counts = launch_counts()
        peak = torch.cuda.max_memory_allocated() / 2**30
        non_causal = [c for c in flash.calls if not c[0]]
        # every encoder layer and every decoder layer's cross-attention,
        # at prefill and at each step, is a call without the causal mask
        want = cfg.n_enc_layers + cfg.n_layers * (1 + steps)
        if len(non_causal) != want or counts["flash_attention"] != len(flash.calls):
            raise AssertionError(f"phase 15 {label}: {len(non_causal)} non-causal flash_attention "
                                 f"calls (want {want}), {counts['flash_attention']} launches of "
                                 f"{len(flash.calls)} calls")
        shapes = sorted({c[1:] for c in non_causal})
        print(f"{CARD}: phase 15 {label}: whisper_small at full size ({param_count(params)} "
              f"parameters, {cfg.param_dtype}, drawn on the card in {init_s:.2f} s), {B} clip(s) of "
              f"{S_enc} frames, max_dec {max_dec}: encoder {1e3 * enc_s:.3f} ms, prefill "
              f"{1e3 * prefill_s:.3f} ms (encoder included), {steps} decode steps "
              f"{1e3 * statistics.mean(step_s):.3f} ms per step (median "
              f"{1e3 * statistics.median(step_s):.3f}), peak memory {peak:.2f} GiB; every logit "
              f"finite; flash_attention {counts['flash_attention']} launches, {len(non_causal)} "
              f"not causal at (B, Sq, Skv) {shapes}")
        print(f"phase 15 {label} launches:", json.dumps(counts))
        out.append(counts)
        del caches, logits, frames
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return out


# phase 16 (a), (b): the whole models' training steps
TRAIN_PHI3 = dict(seq_len=4096, global_batch=4, steps=5)
TRAIN_WHISPER = dict(clips=8, frames=1500, steps=3)
# phase 16 (c): the smoke configs, f32, on the card against the CPU port
TRAIN_SMOKE = dict(seq_len=32, global_batch=4, microbatches=2, steps=2)
SCANS_WAIT = ("rwkv6_7b", "jamba_1p5_large_398b")   # item 15 (d)


def _kernel_ms(by_name: dict, kernel: str) -> float:
    return sum(ns for name, (ns, _) in by_name.items() if kernel in name) / 1e6


def timed_train(step_fn, state, batches, label: str):
    """Run ``step_fn`` over ``batches``; the step walls (host clock, each
    ending in a synchronize), losses and gradient norms; raises on a
    loss or norm that is not finite."""
    import torch

    walls, losses, norms = [], [], []
    for batch in batches:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step_fn(state, batch)
        loss, norm = float(m["loss"]), float(m["grad_norm"])
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        losses.append(loss)
        norms.append(norm)
        if not (math.isfinite(loss) and math.isfinite(norm)):
            raise AssertionError(f"{label}: step {len(walls)}: loss {loss}, grad norm {norm}")
    return state, walls, losses, norms


def whole_model_training(dev, label, cfg, arch, batches, tokens: int, model_flops: float,
                         attention_flops: float, profile_batch) -> dict:
    """Phase 16 (a) / (b): ``make_train_step`` of ``arch``'s optimizer and
    microbatches on ``cfg``, the batches in turn, then one more step under
    the profiler. Returns the launches of the timed steps."""
    import torch

    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.runtime import make_train_step, opt_config

    ocfg = opt_config(arch)
    init_fn, step_fn = make_train_step(cfg, ocfg, microbatches=arch.train_microbatches,
                                       device=dev)
    torch.cuda.reset_peak_memory_stats()
    state = init_fn(0)
    n_params = sum(p.numel() for p in state.params.parameters())
    watched = [p for p in state.params.parameters() if p.dim() >= 2][:3] + [
        state.params.final_norm]
    before = [p.detach().flatten()[:4096].clone() for p in watched]
    reset_launch_counts()
    state, walls, losses, norms = timed_train(step_fn, state, batches, label)
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    moved = [not torch.equal(b, p.detach().flatten()[:4096]) for b, p in zip(before, watched)]
    if not all(moved):
        raise AssertionError(f"{label}: parameters that did not change: {moved}")
    for name in ("flash_attention", "flash_attention_bwd"):
        if counts[name] <= 0:
            raise AssertionError(f"{label}: {name} was not launched")
    if peak >= 79:
        raise AssertionError(f"{label}: peak {peak:.2f} GiB")
    step_s = statistics.median(walls[1:])
    busy = profile_call(lambda: step_fn(state, profile_batch), f"{label} one step")
    shares = ""
    if busy:
        shares = ", ".join(
            f"{k} {_kernel_ms(busy['by_name'], f'{k}_kernel'):.1f} ms "
            f"({100 * _kernel_ms(busy['by_name'], f'{k}_kernel') / busy['busy_ms']:.1f}% of the "
            f"step's device time)" for k in ("flash_attention", "flash_attention_bwd"))
        shares = f"; device busy {100 * busy['busy_share']:.1f}% of the profiled step's wall; " \
                 + shares
    mfu = (model_flops + attention_flops) / (step_s * BF16_TENSOR_OPS_PER_S)
    print(f"{CARD}: {label}: {n_params} parameters ({cfg.param_dtype}), {ocfg.name} with "
          f"{ocfg.state_dtype} state, {arch.train_microbatches} microbatches; step walls (s) "
          f"{[round(w, 3) for w in walls]}, step {step_s * 1e3:.1f} ms (median of steps "
          f"2-{len(walls)}), {tokens / step_s:.0f} tokens/s, peak {peak:.2f} GiB; losses "
          f"{[round(x, 4) for x in losses]}, grad norms {[round(x, 4) for x in norms]}; "
          f"model-FLOP share of the bf16 peak {100 * mfu:.1f}% ((6 N T = "
          f"{model_flops:.4g} + attention {attention_flops:.4g}) FLOP a step){shares}")
    print(f"{label} launches:", json.dumps(counts))
    del state, init_fn, step_fn
    torch.cuda.empty_cache()
    return counts


def train_phase(dev) -> list[dict]:
    """Phase 16: training on the card. (a) phi3_mini_3p8b whole (32
    layers, d 3,072, bf16, AdamW with f32 state, 4 microbatches): 5 steps
    of ``make_train_step`` at 4 x 4,096 tokens of ``SyntheticLM(seed=0)``;
    (b) whisper_small whole: 3 steps of ``encdec_loss`` on 8 clips of
    1,500 frames and 187 decoder tokens; each with step ms, tokens/s, peak
    GiB, the device's busy share of one more step under the profiler,
    ``flash_attention``'s and ``flash_attention_bwd``'s shares of its
    device time and the model-FLOP share of the bf16 peak; finite losses,
    parameters that changed. (c) every smoke config in f32, 2 steps with 2
    microbatches on the card against the CPU port's (losses and norms to
    1e-4); rwkv6_7b and jamba raise, naming item 15 (d). (d) phi3's smoke
    config through ``run_training`` with checkpoints every 2 steps and an
    injected failure, under deterministic algorithms: the resumed run's
    losses bit-equal to an uninterrupted run's. Returns the launches."""
    import tempfile
    import warnings

    import torch

    from repro_torch.configs import get_arch, list_archs
    from repro_torch.data import SyntheticLM, make_batch_iterator
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import VIT_DIM, encdec
    from repro_torch.runtime import FailureInjector, make_train_step, opt_config, run_training

    all_counts = []
    # ---- (a) phi3_mini_3p8b whole --------------------------------------------
    arch = get_arch("phi3_mini_3p8b")
    cfg = arch.model
    S, Bg, n = TRAIN_PHI3["seq_len"], TRAIN_PHI3["global_batch"], TRAIN_PHI3["steps"]
    it = make_batch_iterator(SyntheticLM(vocab=cfg.vocab, seq_len=S, global_batch=Bg, seed=0),
                             device=dev)
    batches = [next(it) for _ in range(n + 1)]
    # 6 N T with N every parameter (embedding and head included) and the
    # attention's own products, forward and backward (3 x 4 H D a visible pair)
    N = cfg.vocab * cfg.d_model * 2 + cfg.d_model + cfg.n_layers * (
        2 * cfg.d_model + cfg.d_model * cfg.hd * (2 * cfg.n_heads + 2 * cfg.n_kv_heads)
        + 3 * cfg.d_model * cfg.d_ff)
    T = Bg * S
    attn = 3 * 4.0 * cfg.n_heads * cfg.hd * (S * (S + 1) // 2) * Bg * cfg.n_layers
    all_counts.append(whole_model_training(
        dev, "phase 16 (a) phi3_mini_3p8b training", cfg, arch, batches[:n], T, 6.0 * N * T,
        attn, batches[n]))

    # ---- (b) whisper_small whole ---------------------------------------------
    arch = get_arch("whisper_small")
    cfg = arch.model
    clips, frames, n = TRAIN_WHISPER["clips"], TRAIN_WHISPER["frames"], TRAIN_WHISPER["steps"]
    S_dec = encdec.dec_len(cfg, frames)
    rng = np.random.default_rng(16)
    it = make_batch_iterator(SyntheticLM(vocab=cfg.vocab, seq_len=S_dec, global_batch=clips,
                                         seed=0), device=dev)
    batches = [{**next(it), "frontend_embeds": torch.as_tensor(
        rng.standard_normal((clips, frames, VIT_DIM), dtype=np.float32), device=dev)}
        for _ in range(n + 1)]
    d, f, hd, H = cfg.d_model, cfg.d_ff, cfg.hd, cfg.n_heads
    attn_params = d * hd * 4 * H
    mlp_params = (3 if cfg.mlp_type == "swiglu" else 2) * d * f
    n_enc = VIT_DIM * d + cfg.n_enc_layers * (attn_params + mlp_params + 2 * d) + d
    n_dec = 2 * cfg.vocab * d + cfg.n_layers * (2 * attn_params + mlp_params + 3 * d) + d
    model_flops = 6.0 * (n_enc * clips * frames + n_dec * clips * S_dec)
    attn = 3 * 4.0 * H * hd * clips * (cfg.n_enc_layers * frames * frames + cfg.n_layers * (
        S_dec * (S_dec + 1) // 2 + S_dec * frames))
    all_counts.append(whole_model_training(
        dev, "phase 16 (b) whisper_small training", cfg, arch, batches[:n],
        clips * (frames + S_dec), model_flops, attn, batches[n]))

    # ---- (c) every smoke config, f32, on the card against the CPU port --------
    reset_launch_counts()
    held = []
    for name in list_archs():
        arch, cfg = get_arch(name), f32_smoke(name)
        ocfg = opt_config(arch)
        ds = SyntheticLM(vocab=cfg.vocab, seq_len=TRAIN_SMOKE["seq_len"],
                         global_batch=TRAIN_SMOKE["global_batch"], seed=0, family=cfg.family,
                         n_img_tokens=cfg.n_img_tokens)
        if name in SCANS_WAIT:
            init_fn, step_fn = make_train_step(cfg, ocfg, microbatches=TRAIN_SMOKE["microbatches"],
                                               device=dev)
            try:
                step_fn(init_fn(0), next(make_batch_iterator(ds, device=dev)))
            except NotImplementedError as e:
                if "item 15 (d)" not in str(e):
                    raise
                print(f"phase 16 (c): {name} on {dev}: raises NotImplementedError ({e})")
                continue
            raise AssertionError(f"phase 16 (c): {name} trained on {dev} through a scan that "
                                 "has no backward kernel")
        runs, start = {}, None
        for where in ("cpu", dev):
            init_fn, step_fn = make_train_step(cfg, ocfg, microbatches=TRAIN_SMOKE["microbatches"],
                                               device=where)
            state = init_fn(0)
            with torch.no_grad():
                if start is None:
                    start = [p.detach().clone() for p in state.params.parameters()]
                else:   # the CPU port's parameters, on the card
                    for a, b in zip(state.params.parameters(), start):
                        a.copy_(b)
            it = make_batch_iterator(ds, device=where)
            losses, norms = [], []
            for _ in range(TRAIN_SMOKE["steps"]):
                state, m = step_fn(state, next(it))
                losses.append(float(m["loss"]))
                norms.append(float(m["grad_norm"]))
            runs[where] = (losses, norms)
        (cl, cn), (gl, gn) = runs["cpu"], runs[dev]
        for a, b, what in ((gl, cl, "losses"), (gn, cn, "grad norms")):
            if not np.allclose(a, b, rtol=1e-4, atol=0):
                raise AssertionError(f"phase 16 (c): {name}: {what} on {dev} {a} against the CPU "
                                     f"port's {b}")
        held.append(name)
        print(f"phase 16 (c): {name} ({ocfg.name}, {ocfg.state_dtype} state): losses {gl} and "
              f"grad norms {gn} on {dev}, within 1e-4 of the CPU port's {cl}, {cn}")
    counts = launch_counts()
    print(f"{CARD}: phase 16 (c): {len(held)} smoke configs trained on {dev} as on the CPU port "
          f"({', '.join(held)}); {', '.join(SCANS_WAIT)} wait for item 15 (d)")
    print("phase 16 (c) launches:", json.dumps(counts))
    for k in ("flash_attention", "flash_attention_bwd"):
        if counts[k] <= 0:
            raise AssertionError(f"phase 16 (c): {k} was not launched")
    all_counts.append(counts)

    # ---- (d) checkpoint and resume on the card --------------------------------
    arch = get_arch("phi3_mini_3p8b")
    was = torch.are_deterministic_algorithms_enabled()
    reset_launch_counts()
    with warnings.catch_warnings(record=True) as caught, tempfile.TemporaryDirectory() as tmp:
        warnings.simplefilter("always")
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            kw = dict(steps=6, global_batch=2, seq_len=64, device=dev)
            whole, resumed = {}, []
            run_training(arch, on_metrics=lambda s, m: whole.setdefault(s, m["loss"]), **kw)
            injector = FailureInjector(seed=1, mtbf_steps=3.0, max_failures=1)
            cut = run_training(arch, ckpt_dir=tmp, ckpt_every=2, injector=injector,
                               on_metrics=lambda s, m: resumed.append((s, m["loss"])), **kw)
        finally:
            torch.use_deterministic_algorithms(was)
    nondeterministic = sorted({str(w.message).split(" does not have a deterministic")[0]
                               for w in caught if "deterministic" in str(w.message)})
    if cut.restarts != 1:
        raise AssertionError(f"phase 16 (d): {cut.restarts} restarts")
    exact = all(loss == whole[s] for s, loss in resumed)
    if not exact:
        worst = max(abs(loss - whole[s]) / abs(whole[s]) for s, loss in resumed)
        if not nondeterministic or worst > 1e-6:
            raise AssertionError(f"phase 16 (d): resumed losses {resumed} against {whole} "
                                 f"(ops without a deterministic version: {nondeterministic})")
    counts = launch_counts()
    back = next(i for i in range(1, len(resumed)) if resumed[i][0] <= resumed[i - 1][0])
    print(f"{CARD}: phase 16 (d): phi3 smoke, failure at step {injector.schedule[0]}, resumed "
          f"at step {resumed[back][0]} from the newest checkpoint: {len(resumed)} steps run for "
          f"6; resumed losses "
          f"{'bit-equal' if exact else 'within 1e-6'} to the uninterrupted run's "
          f"{[whole[s] for s in sorted(whole)]}; ops without a deterministic CUDA version: "
          f"{nondeterministic or 'none'}")
    print("phase 16 (d) launches:", json.dumps(counts))
    all_counts.append(counts)
    return all_counts


def card_phase():
    """Phase 1: the card, its capability, TF32 off; returns the device."""
    import torch

    global CARD
    CARD = gpu_line()
    print(CARD)
    cap = torch.cuda.get_device_capability(0)
    if cap != (9, 0):
        raise AssertionError(f"compute capability {cap}, the kernels are built for sm_90a")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"phase 1: {torch.cuda.get_device_name(0)} capability {cap}; torch "
          f"{torch.__version__} CUDA {torch.version.cuda}; "
          f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")
    return torch.device("cuda", 0)


SASS_OPS = ("HGMMA", "HMMA", "FFMA", "FMUL", "FADD", "MUFU.EX2", "MUFU.LG2", "SHFL", "LDS",
            "LDGSTS", "BAR.SYNC", "STL", "LDL", "REDUX", "VOTE", "LDG", "ATOMS", "STG")
# kernels whose registers must not spill (phase 2 fails otherwise)
NO_SPILL = ("masked_lex_argmin_kernel", "fleet_tick_kernel", "assign_gather_kernel")


def build_phase() -> None:
    """Phase 2: build the kernels; print what ptxas says of each, and the
    instruction mix of the LM kernels', the two simulator kernels' that
    must not spill and both ``retire_land`` instantiations' SASS
    (cuobjdump, where the toolkit has it). Fails if a bf16 attention kernel holds no tensor-core
    instruction."""
    import shutil

    from repro_torch.kernels import cuda_lib

    lib = cuda_lib.build()
    print(f"phase 2: built {lib.relative_to(ROOT)}")
    entry, spilled = "", []
    for line in lib.with_suffix(".log").read_text().splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1] if "'" in line else line.strip()
            print("  ptxas:", entry[:100])
        elif "registers" in line or "spill" in line or line.startswith("=="):
            print("  ptxas:", line.strip())
            stores = re.search(r"(\d+) bytes spill stores", line)
            if stores and int(stores.group(1)) and any(k in entry for k in NO_SPILL):
                spilled.append(entry)
    if spilled:
        raise AssertionError(f"ptxas spills registers in {spilled}")
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not pathlib.Path(tool).exists():
        print("phase 2: SASS instruction mix not measured (no cuobjdump)")
        return
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True, text=True).stdout
    mix, fn = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split("Function :")[1].strip()
            if not any(k in fn for k in ("flash_attention_kernel", "flash_attention_bwd_kernel",
                                         "rwkv6_scan_kernel",
                                         "ssm_scan_kernel", "retire_land_kernel", *NO_SPILL)):
                fn = None
        elif fn:
            parts = line.split("*/")
            # "/*addr*/ [@P] OPCODE operands ; /* encoding */"
            words = parts[1].split() if len(parts) > 2 else []
            words = words[1:] if words and words[0].startswith("@") else words
            op = words[0] if words else ""
            if op:
                # every instruction, beside the classes below
                mix.setdefault(fn, dict.fromkeys(("ALL", *SASS_OPS), 0))["ALL"] += 1
            for want in SASS_OPS:
                if op == want or op.startswith(want + "."):
                    mix[fn][want] += 1
    for fn, counts in mix.items():
        print(f"  sass: {fn[:110]} " + " ".join(f"{k}={v}" for k, v in counts.items() if v))
        if "ssm_scan_kernel" in fn and counts["MUFU.EX2"]:
            # a thread's token step is 4 states, one MUFU.EX2 each; the static
            # counts of the unrolled group loop, its prologue included
            steps = counts["MUFU.EX2"] / 4
            print("    per token step and thread: " + " ".join(
                f"{k}={counts[k] / steps:.2f}" for k in ("MUFU.EX2", "FFMA", "FMUL", "FADD",
                                                         "SHFL", "LDS")))
    for fn, counts in mix.items():
        if "flash_attention_kernel_bf16" in fn and counts["HGMMA"] + counts["HMMA"] == 0:
            raise AssertionError(f"{fn}: no tensor-core instruction in its SASS")


def sim_launch_phase(run_counts, fleet_counts) -> None:
    """Phase 6: every simulator kernel launched in phases 4 and 5."""
    from repro_torch.kernels import SIM_KERNELS

    for name in SIM_KERNELS:
        for label, counts in (("run", run_counts), ("fleet_run", fleet_counts)):
            if counts[name] <= 0:
                raise AssertionError(f"{name} was not launched in the {label} phase")
    print("phase 6: launched in run and fleet_run: " + ", ".join(SIM_KERNELS))


def main() -> int:
    import torch

    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"chip_smoke: no src/repro_torch beside {pathlib.Path(__file__).name}; this "
              "script drives the port from a checkout of the repository", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "drives the port on a GPU", file=sys.stderr)
        return 1
    from repro_torch.kernels import KERNELS, SIM_KERNELS

    walls = {}
    t_all = time.perf_counter()

    def phase(n, fn, *args, **kw):
        t = time.perf_counter()
        out = fn(*args, **kw)
        walls[n] = time.perf_counter() - t
        print(f"{CARD}: phase {n} wall: {walls[n]:.2f} s")
        return out

    dev = phase(1, card_phase)
    phase(2, build_phase)
    measured = phase(3, check_kernels, dev)
    run_counts = phase(4, run_phase, dev)
    fleet_counts, faults_off, fleet = phase(5, fleet_phase, dev)
    replay_counts = phase("5b", replay_phase, dev, fleet)
    cache_counts, cache_runs = phase("5c", data_plane_phase, dev)
    grid_counts, grid = phase("5d", policy_grid_phase, dev)
    telemetry_counts = phase("5e", telemetry_phase, dev, fleet, fleet_counts, faults_off)
    del fleet
    phase(6, sim_launch_phase, run_counts, fleet_counts)
    *chaos_counts, chaos_run = phase("6b", chaos_phase, dev, faults_off)
    overload_counts, loop_lane = phase("6c", overload_phase, dev, faults_off)
    rwkv_counts = phase(7, serve_phase, 7, "rwkv6_7b", ("rwkv6_scan",), dev)
    gemma_counts = phase(8, serve_phase, 8, "gemma3_12b", ("flash_attention",), dev)
    phase(9, parity_phase, dev)
    # jamba: the first five layers of its period (M+dense, M+MoE, M+dense,
    # M+MoE, attn+dense); 72 layers at these widths are ~800 GB of weights
    jamba_counts = phase(10, serve_phase, 10, "jamba_1p5_large_398b",
                         ("ssm_scan", "flash_attention"), dev, n_layers=5)
    search_counts = phase(11, search_phase, dev)
    surface_counts = phase(12, surface_phase, dev, cache_runs, grid, chaos_run, loop_lane)
    del cache_runs, grid, chaos_run, loop_lane
    zoo_counts = phase(13, zoo_phase, dev)
    vlm_counts = phase(14, vlm_phase, dev)
    whisper_counts = phase(15, whisper_phase, dev)
    train_counts = phase(16, train_phase, dev)
    print(f"{CARD}: phase walls (s): " + json.dumps({str(k): round(v, 3) for k, v in walls.items()})
          + f", total {time.perf_counter() - t_all:.2f}")

    sources = {
        "fleet_tick": ("src/repro_torch/csrc/sim_tick.cu",
                       "src/repro/kernels/sim_tick/kernel.py:80"),
        "retire_land": ("src/repro_torch/csrc/state_update.cu",
                        "src/repro/kernels/state_update/kernel.py:91"),
        "masked_lex_argmin": ("src/repro_torch/csrc/sched_select.cu",
                              "src/repro/kernels/sched_select/kernel.py:52"),
        "assign_gather": ("src/repro_torch/csrc/state_update.cu",
                          "src/repro/kernels/state_update/kernel.py:202"),
        "rwkv6_scan": ("src/repro_torch/csrc/rwkv6_scan.cu",
                       "src/repro/kernels/rwkv6_scan/kernel.py:87"),
        "flash_attention": ("src/repro_torch/csrc/flash_attention.cu",
                            "src/repro/kernels/flash_attention/kernel.py:113"),
        # the backward is a jnp custom VJP in the JAX package, not a Pallas call
        "flash_attention_bwd": ("src/repro_torch/csrc/flash_attention_bwd.cu",
                                "src/repro/kernels/flash_attention/ref.py:201"),
        "ssm_scan": ("src/repro_torch/csrc/ssm_scan.cu",
                     "src/repro/kernels/ssm_scan/kernel.py:60"),
    }
    main_runs = (run_counts, fleet_counts, *replay_counts, *cache_counts, grid_counts,
                 *telemetry_counts, *chaos_counts, *overload_counts, rwkv_counts, gemma_counts,
                 jamba_counts, search_counts, *surface_counts, *zoo_counts, *vlm_counts,
                 *whisper_counts, *train_counts)
    rows = []
    for name in KERNELS:
        m = measured[name]
        rows.append({
            "name": name, "route": "cuda", "source": sources[name][0],
            "replaces": sources[name][1],
            "launches": sum(c[name] for c in main_runs),
            "max_abs_err": m["max_abs_err"], "ms": m["ms"], "device_ms": m["device_ms"],
            "plain_ms": m["plain_ms"], "bound_ms": m["bound_ms"],
            "bound_by": m["bound_by"], "library_ms": m["library_ms"],
            # the launch floor beside the simulator kernels (bound by launches)
            **({"floor_ms": measured["launch_floor"]} if name in SIM_KERNELS else {}),
            # retire_land's timeout branch beside its timeout-off case,
            # masked_lex_argmin's SJF keys and per-lane leads beside its
            # K = 3 case, assign_gather's host time a call step by step
            **{k: m[k] for k in ("timeout_on", "sjf", "per_lane_leads", "host_us") if k in m},
        })
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
