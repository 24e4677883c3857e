"""The one dispatch rule of the port's kernel subsystems.

A tensor on a CUDA device goes to the hand-written kernel; a tensor on
the CPU goes to the plain PyTorch version in the subsystem's ``ref.py``.
The device of the data decides, nothing else: no backend guess, no
environment switch, and no fallback from a failed kernel to the plain
version.

A ``meta`` tensor (a dry run, ``launch/lowering.py``) means abstract
evaluation, for the LM kernels alone (``abstract(x) or use_kernel(x)``): it
takes the kernel's path up to the launch (the same checks, the same
output allocations, the same work reported to ``roofline.counting``) and
returns the empty ``meta`` outputs there. It never runs a plain version
and never reaches ``cuda_lib``. The simulator's kernels have no such
stand-in and raise on it, as on any other device.
"""
from __future__ import annotations

import torch


def use_kernel(x: torch.Tensor) -> bool:
    """True for a CUDA tensor (launch the kernel), False for a CPU
    tensor (run the plain version); any other device raises, ``meta``
    too (only the LM kernels' wrappers take it, through ``abstract``)."""
    kind = x.device.type
    if kind == "cuda":
        return True
    if kind == "cpu":
        return False
    raise ValueError(
        f"repro_torch kernels run on 'cuda' or 'cpu' tensors, got {x.device}"
    )


def abstract(x: torch.Tensor) -> bool:
    """True for a ``meta`` tensor: the LM kernels' stand-in (the kernel's
    path without its launch) runs, and no plain version."""
    return x.device.type == "meta"


__all__ = ["abstract", "use_kernel"]
