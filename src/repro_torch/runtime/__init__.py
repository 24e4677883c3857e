"""Step factories of the port, generic over the architecture zoo: the
serving half of ``repro.runtime`` (``steps``)."""
from .steps import init_serve_caches, loss_fn, make_serve_steps, make_train_step, model_init

__all__ = ["init_serve_caches", "loss_fn", "make_serve_steps", "make_train_step", "model_init"]
