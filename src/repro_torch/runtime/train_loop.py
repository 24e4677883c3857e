"""Fault-tolerant training loop: checkpoint / restart, failure injection
and straggler monitoring, a port of ``repro.runtime.train_loop`` on one
device (``mesh=None``).

``run_training`` is the loop that ``launch/train.py`` drives: seeded
``SyntheticLM`` batches, ``make_train_step`` of the architecture's
optimizer, an async checkpoint every ``ckpt_every`` steps, and on an
injected failure a restart from the newest checkpoint (the state drawn
anew from the seed, then restored into; from step 0 when there is no
checkpoint). A device mesh (the JAX package's elastic re-mesh) waits
for ROADMAP queue 1, item 16, and raises.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

from ..checkpoint import CheckpointManager
from ..core.engine import resolve_device
from ..data.pipeline import SyntheticLM, make_batch_iterator
from .failures import FailureInjector, StragglerMonitor
from .steps import TrainState, make_train_step, opt_config


@dataclasses.dataclass
class TrainResult:
    steps_done: int
    losses: list
    restarts: int
    straggler_events: int
    final_state: TrainState


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
    for the CPU). ``on_metrics(step, {"loss", "dt"})`` sees every step
    run, a step run again after a restart included; ``losses`` lists them
    in the order they ran."""
    if mesh is not None:
        raise NotImplementedError("run_training over a device mesh (the elastic re-mesh) waits "
                                  "for ROADMAP queue 1, item 16")
    device = resolve_device(device)
    cfg = arch.smoke if use_smoke_config else arch.model
    ocfg = dataclasses.replace(opt_config(arch), total_steps=max(steps, 10))
    init_fn, step_fn = make_train_step(cfg, ocfg, microbatches=microbatches, device=device)
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
        if mgr is not None:
            mgr.wait()
        if mgr is None or mgr.latest_step() is None:
            return state, 0
        state, manifest = mgr.restore(state)
        return state, manifest["step"] + 1

    state, step = restart()
    it = make_batch_iterator(ds, start_step=step, device=device)
    while step < steps:
        batch = next(it)
        if injector is not None and injector.should_fail(step):
            # a simulated hard failure: the in-memory state is lost
            restarts += 1
            del state
            state, step = restart()
            it = make_batch_iterator(ds, start_step=step, device=device)
            continue

        t0 = time.time()
        state, metrics = step_fn(state, batch)
        loss = float(metrics["loss"])
        dt = time.time() - t0
        monitor.observe(step, dt)
        losses.append(loss)
        if on_metrics:
            on_metrics(step, {"loss": loss, "dt": dt})
        if mgr and ckpt_every and (step + 1) % ckpt_every == 0:
            mgr.async_save(state, step)
        step += 1

    if mgr:
        mgr.wait()
    return TrainResult(steps_done=step, losses=losses, restarts=restarts,
                       straggler_events=len(monitor.flagged), final_state=state)


__all__ = ["TrainResult", "run_training"]
