"""Custom-scheduler registry (paper §4.1.3, Listing 4).

Users extend Eudoxia with *two decorators*:

    @register_scheduler_init(key="my-scheduler")
    def scheduler_init(sch: Scheduler): ...

    @register_scheduler(key="my-scheduler")
    def scheduler_algo(sch: Scheduler, f: List[Failure], p: List[Pipeline]):
        ...
        return suspends, assignments

and reference the same key from ``scheduling_algo`` in the TOML file.
These run in the Python engine (``engine='python'``) with the exact
signature above. Lane-major *vector* schedulers (for the event engine
and the fleets) register through
``repro_torch.core.scheduler.register_vector_scheduler`` instead; a key
may be registered in both worlds and the engine picks the matching one.
The registry is the port's own: a key registered with the JAX package's
``repro.core.algorithm`` is not seen here, nor the other way round.
"""
from __future__ import annotations

from typing import Callable, Dict

PY_SCHEDULERS: Dict[str, Callable] = {}
PY_SCHEDULER_INITS: Dict[str, Callable] = {}


def _norm(key: str) -> str:
    return key.replace("-", "_").lower()


def register_scheduler(key: str):
    def deco(fn: Callable) -> Callable:
        PY_SCHEDULERS[_norm(key)] = fn
        return fn

    return deco


def register_scheduler_init(key: str):
    def deco(fn: Callable) -> Callable:
        PY_SCHEDULER_INITS[_norm(key)] = fn
        return fn

    return deco


def get_python_scheduler(key: str) -> Callable:
    k = _norm(key)
    if k not in PY_SCHEDULERS:
        raise KeyError(
            f"no python scheduler registered for {key!r}; "
            f"known: {sorted(PY_SCHEDULERS)}"
        )
    return PY_SCHEDULERS[k]


def get_python_scheduler_init(key: str) -> Callable:
    return PY_SCHEDULER_INITS.get(_norm(key), lambda sch: None)


def has_python_scheduler(key: str) -> bool:
    return _norm(key) in PY_SCHEDULERS


__all__ = [
    "register_scheduler",
    "register_scheduler_init",
    "get_python_scheduler",
    "get_python_scheduler_init",
    "has_python_scheduler",
    "PY_SCHEDULERS",
    "PY_SCHEDULER_INITS",
]
