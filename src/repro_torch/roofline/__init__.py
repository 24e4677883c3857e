"""The port's roofline (``repro.roofline``): the H100's constants
(``hw``), the hand-written kernels' work by shape (``kernels``), a
counter of what a step executes (``counting.counting``, in place of the
reference's HLO parser ``hlo_stats.py``) and the three-term roofline on
its counts (``analysis``)."""
from .analysis import (
    COLLECTIVE_OPS, Roofline, active_params, model_flop_share, model_flops_estimate, wire_bytes,
)
from . import counting, kernels
from .counting import Count, report
from .hw import H100, Hardware

__all__ = [
    "COLLECTIVE_OPS",
    "Count",
    "H100",
    "Hardware",
    "Roofline",
    "active_params",
    "counting",
    "kernels",
    "model_flop_share",
    "model_flops_estimate",
    "report",
    "wire_bytes",
]
