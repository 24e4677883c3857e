"""The port stands alone, runs where it is told, and refuses what it has
not ported yet.

* No module of ``src/repro_torch`` or ``src/eudoxia_torch`` and not
  ``chip_smoke.py`` imports JAX or the JAX package (``repro``,
  ``eudoxia``): an AST scan of every import.
* The entry points run on CUDA unless the caller asks for the CPU, and
  without a card the default raises instead of running on the CPU.
* Every optional layer of a later slice raises ``NotImplementedError``
  naming its ROADMAP item, never a silent fallback (training over a
  device mesh, item 16; a gradient through the scans' kernels on the
  card, item 15 (d); a gradient through attention's cache path); the layer kinds that
  a slice has ported run (the chaos layer's, the data plane's and the
  overload layer's knobs, every registered scheduler, every
  architecture of the registry and the stubbed frontends, among them).
"""
import ast
import pathlib

import pytest
import torch

from repro_torch import SimParams, fleet_run, run
from repro_torch.core import engine

REPO = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = (sorted((REPO / "src" / "repro_torch").rglob("*.py"))
              + sorted((REPO / "src" / "eudoxia_torch").rglob("*.py")) + [REPO / "chip_smoke.py"])


def _imported_roots(path: pathlib.Path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_and_no_reference_package_imports(path):
    roots = set(_imported_roots(path))
    assert not roots & {"jax", "jaxlib", "repro", "eudoxia", "flax", "optax", "msgpack",
                        "zstandard", "ml_dtypes"}, (path, roots)


def test_port_has_files_to_scan():
    names = {p.name for p in PORT_FILES}
    assert {"engine.py", "scheduler.py", "executor.py", "chip_smoke.py",
            "lm.py", "attention.py", "rwkv.py", "batching.py", "serve.py"} <= names
    assert {"ssm.py", "mlp.py"} <= names
    assert {"admission.py", "families.py"} <= names
    assert {"algorithm.py", "engine_python.py", "viz.py", "sim.py", "core.py"} <= names
    assert {"encdec.py", "steps.py"} <= names
    assert {"optimizers.py", "pipeline.py", "ckpt.py", "train_loop.py", "failures.py",
            "train.py"} <= names
    assert (REPO / "src" / "eudoxia_torch" / "__init__.py") in PORT_FILES
    assert {p.name for p in (REPO / "src" / "repro_torch" / "csrc").glob("*.cu")} == {
        "sim_tick.cu", "state_update.cu", "sched_select.cu", "rwkv6_scan.cu", "flash_attention.cu",
        "flash_attention_bwd.cu", "ssm_scan.cu",
    }


def _small(**kw):
    return SimParams(duration=0.01, max_pipelines=8, max_containers=8,
                     max_ops_per_pipeline=4, **kw)


def test_default_device_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run(_small())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        fleet_run(_small(), seeds=[0])


def test_cpu_run_stays_on_the_cpu():
    res = run(_small(waiting_ticks_mean=100.0), device="cpu")
    assert all(x.device.type == "cpu" for x in res.state)
    assert res.state.tick.shape == () and int(res.state.tick) == 1000


# knobs that raised until the ROADMAP item named beside each ported them
LATER_KNOBS = [
    ("engine", "python", "item 14"),
]


@pytest.mark.parametrize("knob,value,item", LATER_KNOBS, ids=lambda v: str(v))
def test_optional_layers_raise(knob, value, item):
    """Once refused, these knobs run: the Python engine (item 14) runs on
    the CPU when asked to, and its state stays there."""
    res = run(_small(waiting_ticks_mean=100.0, **{knob: value}), device="cpu")
    assert res.params.engine == value and res.events > 0
    assert all(x.device.type == "cpu" for x in res.state)
    assert res.state.tick.shape == () and int(res.state.tick) == 1000
    assert res.summary()["submitted"] > 0


# the data plane's knobs run (ROADMAP queue 1, item 9), each moving the
# summary keys that report it
DATA_PLANE_KNOBS = [
    ("cache_gb_per_pool", 4.0, ("cache_resident_gb",)),
    ("scan_ticks_per_gb", 10.0, ("mean_latency_s",)),
    ("cold_start_ticks", 40, ("cold_start_ticks", "cold_start_s")),
]


@pytest.mark.parametrize("knob,value,live", DATA_PLANE_KNOBS,
                         ids=[k for k, _, _ in DATA_PLANE_KNOBS])
def test_data_plane_knobs_run(knob, value, live):
    busy = dict(waiting_ticks_mean=50.0, op_base_seconds_mean=0.002, op_out_gb_mean=2.0)
    summary = run(_small(**busy, **{knob: value}), device="cpu").summary()
    quiet = run(_small(**busy), device="cpu").summary()
    for key in live:
        assert summary[key] != quiet[key], key


@pytest.mark.parametrize("algo", ["sjf", "cache_aware", "locality_pool", "naive_ref",
                                  "priority_ref", "priority_pool_ref", "cache_aware_ref",
                                  "locality_pool_ref", "sjf_ref"])
def test_every_registered_scheduler_runs(algo):
    res = run(_small(scheduling_algo=algo, waiting_ticks_mean=100.0), device="cpu")
    assert int(res.state.tick) == 1000 and res.summary()["submitted"] > 0


def test_policy_key_needs_policy_vectors():
    with pytest.raises(ValueError, match="policy"):
        run(_small(scheduling_algo="policy"), device="cpu")


# the chaos layer's knobs run (ROADMAP queue 1, item 10), each moving the
# summary keys that report it
CHAOS_KNOBS = [
    ("timeout_ticks", 100, ("timeouts", "failed", "wasted_work_s")),
    ("crash_mtbf_ticks", 200.0, ("faults_injected", "crash_events", "fault_kills")),
    ("outage_mtbf_ticks", 200.0, ("faults_injected", "outage_events", "pool_down_s")),
    ("straggler_prob", 0.5, ("done", "mean_latency_s")),
    ("max_retries", 3, ()),
]


@pytest.mark.parametrize("knob,value,live", CHAOS_KNOBS, ids=[k for k, _, _ in CHAOS_KNOBS])
def test_chaos_knobs_run(knob, value, live):
    busy = dict(waiting_ticks_mean=50.0, op_base_seconds_mean=0.002)
    params = _small(**busy, **{knob: value})
    summary = run(params, device="cpu").summary()
    quiet = run(_small(**busy), device="cpu").summary()
    for key in live:
        assert summary[key] != quiet[key], key
    if not live:
        # a retry budget with no fault source changes nothing
        assert repr(summary) == repr(quiet)


# the overload layer's knobs run (ROADMAP queue 1, item 11): each policy
# and the client gate, each moving the summary keys that report it
CLOSED_LOOP_KNOBS = [
    ("admit_all", dict(client_max_retries=2, client_backoff_ticks=40),
     ("offered", "admitted", "admitted_fraction")),
    ("queue_threshold", dict(admission_policy="queue_threshold", admit_queue_limit=1,
                             client_max_retries=1, client_backoff_ticks=40),
     ("offered", "shed", "client_retries", "failed")),
    ("token_bucket", dict(admission_policy="token_bucket", admit_rate_per_s=1_000.0,
                          admit_burst=1.0), ("offered", "deferred", "mean_latency_s")),
    ("codel", dict(admission_policy="codel", codel_target_ticks=5, codel_interval_ticks=5),
     ("offered", "shed", "failed")),
    ("client_gate", dict(client_max_inflight=1, client_think_ticks=50),
     ("offered", "deferred", "mean_latency_s")),
]


@pytest.mark.parametrize("name,knobs,live", CLOSED_LOOP_KNOBS,
                         ids=[k for k, _, _ in CLOSED_LOOP_KNOBS])
def test_closed_loop_knobs_run(name, knobs, live):
    # sixteen arrivals in ~320 ticks on four CPUs: a queue forms
    busy = dict(waiting_ticks_mean=20.0, op_base_seconds_mean=0.002, total_cpus=4,
                total_ram_gb=16)
    summary = run(_small(**busy, **knobs).replace(max_pipelines=16), device="cpu").summary()
    quiet = run(_small(**busy).replace(max_pipelines=16), device="cpu").summary()
    for key in live:
        assert summary[key] != quiet[key], key
    assert summary["offered"] > 0 and quiet["offered"] == 0


@pytest.mark.parametrize("kwargs,item", [
    ({"engine": "python", "trace": True}, "item 14"),
    ({"shard": 2, "trace": True}, "item 16"),
])
def test_fleet_options_of_later_slices_raise(kwargs, item, monkeypatch):
    """A fleet runs the event engine whatever ``params.engine`` says, as
    the reference's does (item 14 ported the Python engine to ``run``
    alone): its states and traces equal the event engine's. A fleet over
    several cards (item 16) raises, traced or not; a fleet over two cards
    is asked of a machine that reports two, and refused before any work
    on them."""
    kwargs = dict(kwargs)
    params = _small(engine=kwargs.pop("engine", "event"), waiting_ticks_mean=50.0,
                    op_base_seconds_mean=0.002)
    if item == "item 14":
        states, traces = fleet_run(params, seeds=[0, 1], device="cpu", **kwargs)
        want, want_traces = fleet_run(params.replace(engine="event"), seeds=[0, 1],
                                      device="cpu", **kwargs)
        for name in states._fields:
            assert torch.equal(getattr(states, name), getattr(want, name)), name
        assert [t.counts_by_kind() for t in traces] == [t.counts_by_kind() for t in want_traces]
        assert int(states.done_count.sum()) > 0
        return
    device = "cpu"
    if "shard" in kwargs:
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
        device = "cuda"
    with pytest.raises(NotImplementedError, match=item):
        fleet_run(params, seeds=[0, 1], device=device, **kwargs)


def test_run_trace_raises():
    """Telemetry runs on the event engine: the Python engine raises
    ``ValueError`` with a trace asked of it, as the reference's does, and
    a capacity of 0 is refused."""
    with pytest.raises(ValueError, match="compiled event engine"):
        run(_small(engine="python"), device="cpu", trace=True)
    with pytest.raises(ValueError, match="positive"):
        run(_small(), device="cpu", trace=True, trace_capacity=0)
    with pytest.raises(ValueError, match="positive"):
        fleet_run(_small(), seeds=[0], device="cpu", trace=True, trace_capacity=0)
    assert run(_small(), device="cpu", trace=True).trace is not None


def test_unknown_scheduler_is_a_key_error():
    with pytest.raises(KeyError, match="ported"):
        engine.run_lane_major_engine(_small(), None, "no_such_scheduler")


# ---------------------------------------------------------------------------
# The LM substrate: what the port has not ported raises, naming the item;
# the mamba mixer and the MoE MLPs run
# ---------------------------------------------------------------------------
def _tiny_lm_config(**kw):
    from repro_torch.models import ModelConfig

    return ModelConfig(n_layers=2, d_model=32, n_heads=2, n_kv_heads=2, d_ff=64, vocab=64,
                       param_dtype=torch.float32, compute_dtype=torch.float32, **kw)


@pytest.mark.parametrize("spec", [("mamba", "dense"), ("attn", "moe"), ("attn", "moe_dense"),
                                  ("mamba", "moe")], ids=lambda s: "-".join(s))
def test_mamba_and_moe_layers_raise(spec):
    """Once refused, these layer kinds are ported: each initialises on
    the CPU and runs one prefill and one decode step to finite logits
    (only an unknown kind raises, ``ValueError``)."""
    from repro_torch.models import LayerSpec, MoEConfig, lm
    from repro_torch.models.blocks import check_spec

    cfg = _tiny_lm_config(pattern=(LayerSpec(*spec),), moe=MoEConfig(n_experts=4, top_k=2))
    params = lm.lm_init(cfg, device="cpu")
    parts = {name for name, _ in params.layers[0].named_children()}
    assert parts == {spec[0]} | {"dense": {"mlp"}, "moe": {"moe"}, "moe_dense": {"moe", "mlp"}}[spec[1]]
    logits, caches = lm.lm_prefill(cfg, params, {"tokens": torch.arange(2, 12)[None]}, max_len=16)
    assert logits.shape == (1, 64) and bool(torch.isfinite(logits).all())
    logits, _ = lm.lm_decode_step(cfg, params, caches, torch.tensor([5]), 10)
    assert logits.shape == (1, 64) and bool(torch.isfinite(logits).all())
    with pytest.raises(ValueError, match="unknown"):
        check_spec(LayerSpec(spec[0], "no_such_mlp"))


def test_training_over_a_mesh_waits_for_item_16():
    """``run_training(mesh=...)`` (the elastic re-mesh) raises, naming
    ROADMAP item 16, before anything is drawn."""
    from repro_torch.configs import get_arch
    from repro_torch.runtime import run_training

    with pytest.raises(NotImplementedError, match="item 16"):
        run_training(get_arch("phi3_mini_3p8b"), steps=1, mesh=object(), device="cpu")


@pytest.mark.parametrize("call", ["q_offset", "kv_len"])
def test_attention_grad_through_the_cache_path_raises(call):
    """A gradient through ``flash_attention``'s ``q_offset`` / ``kv_len``
    path (a prefill against a cache) raises; no training path reaches it."""
    from repro_torch.kernels.flash_attention import flash_attention

    q = torch.zeros((1, 4, 2, 8), requires_grad=True)
    kw = {"q_offset": dict(q_offset=2), "kv_len": dict(kv_len=3)}[call]
    with pytest.raises(NotImplementedError, match="q_offset / kv_len"):
        flash_attention(q, q, q, **kw)


@pytest.mark.parametrize("kernel", ["rwkv6_scan", "ssm_scan"])
def test_scan_kernels_refuse_grad_naming_item_15d(kernel):
    """The guard in front of the two scans' CUDA launches: under grad, an
    input that requires grad raises naming ROADMAP item 15 (d); without
    grad, or with no input that requires grad, it lets the launch go."""
    from repro_torch.kernels.dispatch import refuse_grad

    x = torch.zeros(3, requires_grad=True)
    with pytest.raises(NotImplementedError, match=rf"{kernel}: .*item 15 \(d\)"):
        refuse_grad(kernel, None, x)
    with torch.no_grad():
        refuse_grad(kernel, None, x)
    refuse_grad(kernel, x.detach(), None)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["rwkv6_7b", "jamba_1p5_large_398b"])
def test_training_the_scans_on_the_card_waits_for_item_15d(name):
    """rwkv6_7b's and jamba's smoke configs raise on CUDA under grad."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device with sm_90 (the kernels are built for Hopper)")
    from repro_torch.configs import get_arch
    from repro_torch.runtime import loss_fn, model_init

    cfg = get_arch(name).smoke
    params = model_init(cfg, 0, device="cuda")
    batch = {"tokens": torch.zeros((1, 16), dtype=torch.int32, device="cuda")}
    with pytest.raises(NotImplementedError, match=r"item 15 \(d\)"):
        loss_fn(cfg, params, batch)


@pytest.mark.parametrize("family", ["vlm", "audio"])
def test_frontends_raise(family):
    """The name is historical: the frontends were once refused and run
    now (item 15 (b)). ``lm_init`` of either family draws
    ``frontend_proj`` [1024, d] on the CPU, and a prefill whose first
    positions are frontend embeddings gives finite logits that move with
    the embeddings."""
    from repro_torch.models import VIT_DIM, lm

    cfg = _tiny_lm_config(family=family)
    params = lm.lm_init(cfg, device="cpu")
    assert params.frontend_proj.shape == (VIT_DIM, 32)
    assert lm.lm_init(_tiny_lm_config(), device="cpu").frontend_proj is None
    toks = torch.arange(2, 12)[None]
    gen = torch.Generator().manual_seed(0)
    logits = {}
    for scale in (1.0, 2.0):
        fe = scale * torch.randn((1, 4, VIT_DIM), generator=gen.manual_seed(0))
        logits[scale], _ = lm.lm_prefill(cfg, params, {"tokens": toks, "frontend_embeds": fe},
                                         max_len=16)
        assert logits[scale].shape == (1, 64) and bool(torch.isfinite(logits[scale]).all())
    assert not torch.equal(logits[1.0], logits[2.0])


@pytest.mark.parametrize("name", [
    "arctic_480b", "gemma3_27b", "granite_34b", "internvl2_2b",
    "llama4_maverick_400b_a17b", "phi3_mini_3p8b", "whisper_small",
])
def test_archs_not_yet_ported_raise(name):
    """The name is historical: these architectures were once refused and
    are ported now (item 15 (a), (b)). Each loads its smoke config on the
    CPU and runs one prefill through ``runtime.make_serve_steps`` to
    finite logits."""
    from repro_torch.configs import get_arch
    from repro_torch.runtime import make_serve_steps, model_init

    cfg = get_arch(name).smoke
    params = model_init(cfg, 0, device="cpu")
    batch = {"tokens": torch.arange(2, 12)[None]}
    if cfg.family in ("vlm", "audio"):
        n = cfg.n_img_tokens or 24
        batch["frontend_embeds"] = torch.randn((1, n, 1024), generator=torch.Generator().manual_seed(0))
    prefill, _ = make_serve_steps(cfg)
    logits, _ = prefill(params, batch, 64)
    assert logits.shape == (1, cfg.vocab) and bool(torch.isfinite(logits.float()).all())


def test_ported_archs_and_unknown_names():
    from repro_torch.configs import get_arch, list_archs

    assert list_archs() == [
        "arctic_480b", "gemma3_12b", "gemma3_27b", "granite_34b", "internvl2_2b",
        "jamba_1p5_large_398b", "llama4_maverick_400b_a17b", "phi3_mini_3p8b", "rwkv6_7b",
        "whisper_small",
    ]
    assert get_arch("jamba-1.5-large-398b").model.n_layers == 72
    assert get_arch("rwkv6-7b").model.n_layers == 32
    assert get_arch("phi3-mini-3.8b") is get_arch("phi3_mini_3p8b")
    with pytest.raises(KeyError, match="ported"):
        get_arch("no_such_arch")


def test_lm_init_needs_a_card_by_default(monkeypatch):
    from repro_torch.models import lm

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        lm.lm_init(_tiny_lm_config())
