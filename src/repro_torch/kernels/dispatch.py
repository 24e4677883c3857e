"""The one dispatch rule of the port's kernel subsystems.

A tensor on a CUDA device goes to the hand-written kernel; a tensor on
the CPU goes to the plain PyTorch version in the subsystem's ``ref.py``.
The device of the data decides, nothing else: no backend guess, no
environment switch, and no fallback from a failed kernel to the plain
version.
"""
from __future__ import annotations

import torch


def use_kernel(x: torch.Tensor) -> bool:
    """True for a CUDA tensor (launch the kernel), False for a CPU
    tensor (run the plain version); any other device raises."""
    kind = x.device.type
    if kind == "cuda":
        return True
    if kind == "cpu":
        return False
    raise ValueError(
        f"repro_torch kernels run on 'cuda' or 'cpu' tensors, got {x.device}"
    )


__all__ = ["use_kernel"]
