"""The port stands alone, runs where it is told, and refuses what it has
not ported yet.

* No module of ``src/repro_torch`` and not ``chip_smoke.py`` imports JAX
  or the JAX package (``repro``): an AST scan of every import.
* The entry points run on CUDA unless the caller asks for the CPU, and
  without a card the default raises instead of running on the CPU.
* Every optional layer of a later slice raises ``NotImplementedError``
  naming its ROADMAP item, never a silent fallback.
"""
import ast
import pathlib

import pytest
import torch

from repro_torch import SimParams, fleet_run, run
from repro_torch.core import engine

REPO = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((REPO / "src" / "repro_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]


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
    assert not roots & {"jax", "jaxlib", "repro", "flax", "optax"}, (path, roots)


def test_port_has_files_to_scan():
    names = {p.name for p in PORT_FILES}
    assert {"engine.py", "scheduler.py", "executor.py", "chip_smoke.py"} <= names
    assert len(list((REPO / "src" / "repro_torch" / "csrc").glob("*.cu"))) == 3


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


LATER_KNOBS = [
    ("cache_gb_per_pool", 4.0, "item 9"),
    ("scan_ticks_per_gb", 10.0, "item 9"),
    ("cold_start_ticks", 40, "item 9"),
    ("timeout_ticks", 100, "item 10"),
    ("crash_mtbf_ticks", 500.0, "item 10"),
    ("outage_mtbf_ticks", 500.0, "item 10"),
    ("straggler_prob", 0.1, "item 10"),
    ("max_retries", 3, "item 10"),
    ("client_max_inflight", 4, "item 11"),
    ("admission_policy", "codel", "item 11"),
    ("admit_burst", 2.0, "item 11"),
    ("engine", "python", "item 14"),
    ("trace_path", "day.json", "item 3"),
    ("scheduling_algo", "sjf", "item 9"),
    ("scheduling_algo", "policy", "item 9"),
]


@pytest.mark.parametrize("knob,value,item", LATER_KNOBS, ids=lambda v: str(v))
def test_optional_layers_raise(knob, value, item):
    params = _small(**{knob: value})
    with pytest.raises(NotImplementedError, match=item):
        run(params, device="cpu")


@pytest.mark.parametrize("kwargs,item", [({"trace": True}, "item 12"), ({"shard": "auto"}, "item 8")])
def test_fleet_options_of_later_slices_raise(kwargs, item):
    with pytest.raises(NotImplementedError, match=item):
        fleet_run(_small(), seeds=[0], device="cpu", **kwargs)


def test_run_trace_raises():
    with pytest.raises(NotImplementedError, match="item 12"):
        run(_small(), device="cpu", trace=True)


def test_unknown_scheduler_is_a_key_error():
    with pytest.raises(KeyError, match="ported"):
        engine.run_lane_major_engine(_small(), None, "no_such_scheduler")
