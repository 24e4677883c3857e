"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version (``<subsystem>/ref.py``) and a wrapper (``<subsystem>/ops.py``)
that picks one by the device of the data: the simulator's four, the
LM substrate's three and the backwards of training (attention and the
two scans)."""
from .flash_attention import flash_attention, flash_attention_bwd
from .rwkv6_scan import rwkv6_scan, rwkv6_scan_bwd
from .sched_select import masked_lex_argmin
from .sim_tick import fleet_tick
from .ssm_scan import ssm_scan, ssm_scan_bwd
from .state_update import assign_gather, retire_land

# the simulator's kernels (run / fleet_run), by the name each launch
# counter reports
SIM_KERNELS = {
    "fleet_tick": fleet_tick,
    "retire_land": retire_land,
    "masked_lex_argmin": masked_lex_argmin,
    "assign_gather": assign_gather,
}
# the LM substrate's kernels (serving prefill; the backwards in training)
LM_KERNELS = {
    "rwkv6_scan": rwkv6_scan,
    "flash_attention": flash_attention,
    "ssm_scan": ssm_scan,
    "flash_attention_bwd": flash_attention_bwd,
    "rwkv6_scan_bwd": rwkv6_scan_bwd,
    "ssm_scan_bwd": ssm_scan_bwd,
}
KERNELS = {**SIM_KERNELS, **LM_KERNELS}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0
    retire_land.timeout_launches = 0


def launch_counts() -> dict[str, int]:
    return {name: fn.launches for name, fn in KERNELS.items()}


__all__ = [
    "KERNELS",
    "LM_KERNELS",
    "SIM_KERNELS",
    "assign_gather",
    "flash_attention",
    "flash_attention_bwd",
    "fleet_tick",
    "launch_counts",
    "masked_lex_argmin",
    "reset_launch_counts",
    "retire_land",
    "rwkv6_scan",
    "rwkv6_scan_bwd",
    "ssm_scan",
    "ssm_scan_bwd",
]
