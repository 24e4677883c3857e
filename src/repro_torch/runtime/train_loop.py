"""Fault-tolerant training loop: checkpoint / restart, failure injection,
straggler monitoring and training over a device mesh, a port of
``repro.runtime.train_loop``.

``run_training`` is the loop that ``launch/train.py`` drives: seeded
``SyntheticLM`` batches, ``make_train_step`` of the architecture's
optimizer, an async checkpoint every ``ckpt_every`` steps, and on an
injected failure a restart from the newest checkpoint (the state drawn
anew from the seed, then restored into; from step 0 when there is no
checkpoint). With a ``mesh`` (a ``DeviceMesh`` with ``"data"`` /
``"model"`` axes, ``launch.mesh``) every rank draws the same state from
the seed and keeps its shards of it (``_state_shardings``: the
parameters' logical axes, the optimizer state's from ``launch.shapes.
opt_axes``, placed by the architecture's rules), each rank takes its
rows of every global batch, and a restart restores the newest
checkpoint onto the mesh, whatever mesh wrote it (the elastic re-mesh).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Mapping, Optional

from ..checkpoint import CheckpointManager
from ..core.engine import resolve_device
from ..data.pipeline import SyntheticLM, make_batch_iterator
from ..launch.lowering import arch_rules, shardings_of
from ..launch.shapes import opt_axes
from ..models.axes import model_axes
from ..parallel.sharding import distribute, shard_params
from .failures import FailureInjector, StragglerMonitor
from .steps import TrainState, make_train_step, opt_config, stacked_leaves


@dataclasses.dataclass
class TrainResult:
    steps_done: int
    losses: list
    restarts: int
    straggler_events: int
    final_state: TrainState


def _state_shardings(arch, cfg, state: TrainState):
    """(the parameters' axes, the optimizer state's axes tree, the
    architecture's rules) of ``state``."""
    rules = arch_rules(arch)
    p_axes = model_axes(cfg)
    named = dict(state.params.named_parameters())
    o_axes = opt_axes(arch.optimizer, p_axes, named, stacked_leaves(cfg, named))
    return p_axes, o_axes, rules


def shard_state(arch, cfg, state: TrainState, mesh) -> TrainState:
    """``state`` (the whole value on every rank) as DTensors placed by
    the architecture's rules; scalars (the step) stay plain."""
    p_axes, o_axes, rules = _state_shardings(arch, cfg, state)
    shard_params(state.params, p_axes, mesh, rules)
    place = shardings_of(o_axes, state.opt, mesh, rules.param)

    def put(t, pl):
        if isinstance(t, Mapping):
            return {k: put(t[k], pl[k]) for k in t}
        return t if t.ndim == 0 else distribute(t, mesh, pl)

    opt = state.opt._replace(inner=put(state.opt.inner, place.inner))
    return TrainState(params=state.params, opt=opt)


def run_training(
    arch,
    *,
    steps: int,
    mesh=None,
    use_smoke_config: bool = True,
    global_batch: int = 8,
    seq_len: int = 64,
    ckpt_dir: Optional[str] = None,
    ckpt_every: int = 0,
    start_seed: int = 0,
    injector: Optional[FailureInjector] = None,
    microbatches: int = 1,
    log_every: int = 10,
    on_metrics: Optional[Callable] = None,
    device="cuda",
) -> TrainResult:
    """Train ``arch`` (its smoke config unless ``use_smoke_config`` is
    False) for ``steps`` steps on ``device`` (CUDA unless the caller asks
    for the CPU). ``on_metrics(step, {"loss", "dt", "grad_norm"})`` sees
    every step run, a step run again after a restart included; ``losses``
    lists them in the order they ran. Over a ``mesh`` the state is sharded and
    ``device`` is this rank's card (or the CPU under ``gloo``)."""
    device = resolve_device(device)
    cfg = arch.smoke if use_smoke_config else arch.model
    ocfg = dataclasses.replace(opt_config(arch), total_steps=max(steps, 10))
    init_fn, step_fn = make_train_step(cfg, ocfg, microbatches=microbatches, device=device,
                                       mesh=mesh, rules=arch_rules(arch))
    ds = SyntheticLM(vocab=cfg.vocab, seq_len=seq_len, global_batch=global_batch,
                     seed=start_seed, family=cfg.family, n_img_tokens=cfg.n_img_tokens)

    mgr = CheckpointManager(ckpt_dir) if ckpt_dir else None
    monitor = StragglerMonitor()
    losses: list[float] = []
    restarts = 0

    def restart() -> tuple[TrainState, int]:
        """A fresh state from the seed, restored from the newest
        checkpoint where there is one; and the step to run next. An async
        save still in flight is waited for first, so the step restarted
        from does not depend on the writer thread's timing."""
        state = init_fn(start_seed)
        if mesh is not None:
            state = shard_state(arch, cfg, state, mesh)
        if mgr is not None:
            mgr.wait()
        if mgr is None or mgr.latest_step() is None:
            return state, 0
        state, manifest = mgr.restore(state)
        return state, manifest["step"] + 1

    state, step = restart()
    it = make_batch_iterator(ds, start_step=step, device=device, mesh=mesh)
    while step < steps:
        batch = next(it)
        if injector is not None and injector.should_fail(step):
            # a simulated hard failure: the in-memory state is lost
            restarts += 1
            del state
            state, step = restart()
            it = make_batch_iterator(ds, start_step=step, device=device, mesh=mesh)
            continue

        t0 = time.time()
        state, metrics = step_fn(state, batch)
        loss = float(metrics["loss"])
        dt = time.time() - t0
        monitor.observe(step, dt)
        losses.append(loss)
        if on_metrics:
            on_metrics(step, {"loss": loss, "dt": dt, "grad_norm": float(metrics["grad_norm"])})
        if mgr and ckpt_every and (step + 1) % ckpt_every == 0:
            mgr.async_save(state, step)
        step += 1

    if mgr:
        mgr.wait()
    return TrainResult(steps_done=step, losses=losses, restarts=restarts,
                       straggler_events=len(monitor.flagged), final_state=state)


__all__ = ["TrainResult", "run_training"]
