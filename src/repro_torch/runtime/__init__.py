"""The port's runtime (``repro.runtime``): the step factories, the
fault-tolerant train loop and its failure tools."""
from .failures import FailureInjector, StragglerMonitor, advise_checkpoint_cadence
from .steps import (
    TrainState,
    init_serve_caches,
    loss_fn,
    make_serve_steps,
    make_train_step,
    model_init,
    opt_config,
    stacked_leaves,
)
from .train_loop import TrainResult, run_training

__all__ = [
    "FailureInjector",
    "StragglerMonitor",
    "TrainResult",
    "TrainState",
    "advise_checkpoint_cadence",
    "init_serve_caches",
    "loss_fn",
    "make_serve_steps",
    "make_train_step",
    "model_init",
    "opt_config",
    "run_training",
    "stacked_leaves",
]
