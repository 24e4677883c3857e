"""The paper's surface on the port, on the CPU: the Listing-4 registry,
the public names, ``core/viz.py`` and the CLI against the JAX package's.

* A Listing-4 user scheduler (``examples/custom_scheduler.py``'s SJF)
  registered under one key through ``eudoxia_torch.algorithm`` and
  through ``eudoxia.algorithm``: each engine runs its own registry's
  function, and the two states are equal under the comparison contract.
* ``repro.core.__all__`` is a subset of ``repro_torch.core.__all__``,
  and ``eudoxia_torch`` (with its ``core`` and ``algorithm``) exposes
  every name ``eudoxia`` does; an unknown engine and a traced Python
  run raise the reference's ``ValueError``.
* The five renderings of ``viz`` give the reference's text on equal
  states: the Python engine's, and for the Gantt the traced event run.
* ``python -m repro_torch.launch.sim --device cpu`` on a small TOML
  (replaying a trace file, so both packages simulate one workload)
  imports no JAX, and its ``--json`` summary equals the reference CLI's
  under the contract.
"""
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

import eudoxia
import eudoxia_torch
import repro.core
import repro_torch.core
from repro.core import SimParams as JParams
from repro.core import generate_workload as j_generate
from repro.core import run as j_run
from repro.core import viz as j_viz
from repro.launch import sim as j_sim
from repro_torch.bridge import workload_from_arrays
from repro_torch.core import viz
from repro_torch.core.algorithm import PY_SCHEDULERS
from test_torch_engine_python import _arrays, _assert_contract
from test_torch_serving import _assert_summary_equal
from test_torch_models import release_jax_executables  # noqa: F401 (autouse)

REPO = pathlib.Path(__file__).resolve().parents[1]
KEY = "surface-sjf"


def _kw(**extra):
    # tests/test_viz.py's configuration
    kw = dict(
        duration=0.03, scheduling_algo="priority_pool", num_pools=2, waiting_ticks_mean=300.0,
        op_base_seconds_mean=0.005, op_base_seconds_sigma=1.0, max_pipelines=32,
        max_containers=32, cache_gb_per_pool=4.0, scan_ticks_per_gb=50.0, cold_start_ticks=40,
        container_warm_ticks=2_000,
    )
    kw.update(extra)
    return kw


def _listing4(package, calls: list):
    """``examples/custom_scheduler.py``'s scheduler, registered under
    ``KEY`` through ``package.algorithm``; ``calls`` counts its calls."""
    register_scheduler = package.algorithm.register_scheduler
    register_scheduler_init = package.algorithm.register_scheduler_init
    Assignment = package.core.Assignment

    @register_scheduler_init(key=KEY)
    def scheduler_init(sch):
        sch.data["chunk"] = 0.25  # allocate quarter-pool containers

    @register_scheduler(key=KEY)
    def scheduler_algo(sch, f, p):
        calls.append(sch.params.scheduling_algo)
        suspends, assignments = [], []
        frac = sch.data["chunk"]
        want_cpu = frac * sch.pool_cpu_cap[0]
        want_ram = frac * sch.pool_ram_cap[0]
        free_cpu = list(sch.pool_cpu_free)
        free_ram = list(sch.pool_ram_free)
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

    return scheduler_algo


def test_listing4_scheduler_runs_in_each_registry():
    port_calls, ref_calls = [], []
    port_fn = _listing4(eudoxia_torch, port_calls)
    ref_fn = _listing4(eudoxia, ref_calls)
    assert PY_SCHEDULERS[KEY.replace("-", "_")] is port_fn
    assert repro.core.algorithm.PY_SCHEDULERS[KEY.replace("-", "_")] is ref_fn
    kw = _kw(scheduling_algo=KEY, duration=0.05, num_pools=1)
    wl = j_generate(JParams(**_kw(), seed=3))
    ref = eudoxia.run_simulator(JParams(**kw, seed=3), workload=wl, engine="python")
    n_ref = len(ref_calls)
    port = eudoxia_torch.run_simulator(eudoxia_torch.SimParams(**kw, seed=3),
                                       workload=workload_from_arrays(_arrays(wl)),
                                       engine="python", device="cpu")
    assert n_ref > 0 and len(ref_calls) == n_ref, "the port ran the reference's function"
    assert len(port_calls) == n_ref == port.events
    assert int(ref.state.done_count) > 0
    _assert_contract(port.state, ref.state, "listing 4")


def test_public_names_cover_the_reference():
    assert set(repro.core.__all__) <= set(repro_torch.core.__all__)
    for ref, port in ((eudoxia, eudoxia_torch), (eudoxia.core, eudoxia_torch.core),
                      (eudoxia.algorithm, eudoxia_torch.algorithm)):
        names = {n for n in dir(ref) if not n.startswith("_")}
        missing = {n for n in names if not hasattr(port, n)}
        assert not missing, (ref.__name__, missing)
    for name in ("Scheduler", "Assignment", "Failure", "Suspension", "register_scheduler",
                 "register_scheduler_init", "run_simulator", "telemetry"):
        assert name in repro_torch.core.__all__, name


@pytest.mark.parametrize("engine,trace", [("tick", False), ("python", True)],
                         ids=["unknown-engine", "python-traced"])
def test_engine_errors_equal_the_reference(engine, trace):
    """An unknown engine, and a trace asked of the Python engine, raise
    the reference's ``ValueError`` with its message (the reference
    raises before it reads the workload, so it is handed a stand-in)."""
    kw = _kw(duration=0.01)
    with pytest.raises(ValueError) as ref:
        j_run(JParams(**kw), workload=object(), engine=engine, trace=trace)
    with pytest.raises(ValueError) as port:
        repro_torch.core.run(repro_torch.core.SimParams(**kw), engine=engine, trace=trace,
                             device="cpu")
    assert str(port.value) == str(ref.value)


@pytest.fixture(scope="module")
def python_runs():
    """The reference's and the port's Python-engine runs of one
    workload."""
    kw = _kw(duration=0.05)
    wl = j_generate(JParams(**kw, seed=4))
    ref = j_run(JParams(**kw, seed=4), workload=wl, engine="python")
    port = repro_torch.core.run(repro_torch.core.SimParams(**kw, seed=4),
                                workload_from_arrays(_arrays(wl)), engine="python",
                                device="cpu")
    assert int(ref.state.done_count) > 0
    return port, ref


@pytest.mark.parametrize("name,kw", [
    ("utilization_timeline", {}), ("utilization_timeline", {"width": 16}),
    ("latency_histogram", {}), ("per_priority_table", {}), ("timeline_csv", {}),
    ("pipeline_gantt", {}),
], ids=["utilization_timeline", "utilization_timeline-16", "latency_histogram",
        "per_priority_table", "timeline_csv", "pipeline_gantt-untraced"])
def test_viz_text_equals_reference_on_python_engine_states(python_runs, name, kw):
    port, ref = python_runs
    got = getattr(viz, name)(port, **kw)
    assert got and got == getattr(j_viz, name)(ref, **kw)


def test_pipeline_gantt_equals_reference_on_traced_event_run():
    kw = _kw()
    wl = j_generate(JParams(**kw, seed=0))
    ref = j_run(JParams(**kw, seed=0), workload=wl, trace=True)
    port = repro_torch.core.run(repro_torch.core.SimParams(**kw, seed=0),
                                workload_from_arrays(_arrays(wl)), device="cpu", trace=True)
    assert port.trace.spans(), "no spans to draw"
    for width in (64, 24):
        got = viz.pipeline_gantt(port, width=width)
        assert got == j_viz.pipeline_gantt(ref, width=width)
        assert "C" in got


def _tiny_toml(tmp_path, engine):
    """A TOML file that replays 20 recorded pipelines (both packages
    ingest a trace file bit for bit) at tests/test_viz.py's size."""
    rng = np.random.default_rng(5)
    day = [{"arrival_s": round(0.0012 * i, 6), "priority": int(rng.integers(0, 3)),
            "ops": [{"ram_gb": 1.0 + i % 3, "base_s": 0.002 + 0.0005 * (i % 4),
                     "out_gb": 0.5}]} for i in range(20)]
    (tmp_path / "day.json").write_text(json.dumps(day))
    path = tmp_path / "tiny.toml"
    path.write_text(
        f'duration = 0.04\nnum_pools = 2\nscheduling_algo = "priority_pool"\n'
        f'max_pipelines = 32\nmax_containers = 32\nengine = "{engine}"\n'
        f'cache_gb_per_pool = 4.0\nscan_ticks_per_gb = 50.0\n'
        f'trace_path = "{(tmp_path / "day.json").as_posix()}"\n'
    )
    return path


@pytest.mark.parametrize("engine", ["event", "python"])
def test_cli_runs_on_the_cpu_without_jax_and_matches_reference(tmp_path, engine, monkeypatch):
    toml = _tiny_toml(tmp_path, engine)
    out_json, out_csv = tmp_path / "port.json", tmp_path / "port.csv"
    code = ("import runpy, sys; sys.argv = sys.argv[1:]; "
            "runpy.run_module('repro_torch.launch.sim', run_name='__main__'); "
            "assert not {'jax', 'repro', 'eudoxia'} & set(sys.modules), 'imported JAX'")
    env = {**os.environ, "PYTHONPATH": str(REPO / "src")}
    proc = subprocess.run(
        [sys.executable, "-c", code, "sim", str(toml), "--device", "cpu",
         "--json", str(out_json), "--csv", str(out_csv)],
        capture_output=True, text=True, env=env, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    for section in ("== summary ==", "== per priority ==", "== utilisation ==",
                    "== latency distribution =="):
        assert section in proc.stdout
    assert out_csv.read_text().startswith("t_s,pool,cpu_util,ram_util\n")
    ref_json = tmp_path / "ref.json"
    monkeypatch.setattr(sys, "argv", ["sim", str(toml), "--json", str(ref_json)])
    j_sim.main()
    got, want = json.loads(out_json.read_text()), json.loads(ref_json.read_text())
    assert got["submitted"] == 20 and got["done"] > 0
    _assert_summary_equal(got, want, f"cli/{engine}")
