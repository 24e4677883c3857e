"""Hand-written CUDA kernels of the simulator's main path, each beside
its plain PyTorch version (``<subsystem>/ref.py``) and a wrapper
(``<subsystem>/ops.py``) that picks one by the device of the data."""
from .sched_select import masked_lex_argmin
from .sim_tick import fleet_tick
from .state_update import assign_gather, retire_land

# every kernel wrapper, by the name its launch counter reports
KERNELS = {
    "fleet_tick": fleet_tick,
    "retire_land": retire_land,
    "masked_lex_argmin": masked_lex_argmin,
    "assign_gather": assign_gather,
}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


def launch_counts() -> dict[str, int]:
    return {name: fn.launches for name, fn in KERNELS.items()}


__all__ = [
    "KERNELS",
    "assign_gather",
    "fleet_tick",
    "launch_counts",
    "masked_lex_argmin",
    "reset_launch_counts",
    "retire_land",
]
