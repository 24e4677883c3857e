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


def refuse_grad(kernel: str, *inputs) -> None:
    """Raise ``NotImplementedError`` when grad is enabled and an input
    requires grad: ``kernel`` has no backward kernel on the card yet
    (ROADMAP queue 1, item 15 (d)), and nothing falls back to the plain
    version."""
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in inputs):
        raise NotImplementedError(
            f"{kernel}: no backward kernel on the card yet; training through it on CUDA "
            "waits for ROADMAP queue 1, item 15 (d) (the CPU trains through the plain version)")


__all__ = ["refuse_grad", "use_kernel"]
