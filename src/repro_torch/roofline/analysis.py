"""Three-term roofline from a counted step (``roofline.counting``), a port
of ``repro.roofline.analysis``:

    compute    = FLOPs            / peak FLOP/s
    memory     = HBM bytes        / HBM bandwidth
    collective = wire bytes       / link bandwidth (each group's slowest link)

every count per device. The reference parses a compiled program's HLO
for its collectives; the port counts the collective ops a step runs and
gives each its wire bytes by the same ring model (``wire_bytes``). The
hardware is an argument, the H100 of ``roofline.hw`` by default; with 8
cards a node and row-major ranks, every group of the (16, 16) and
(2, 16, 16) production meshes crosses nodes, so their collective term
runs at the InfiniBand rate.
"""
from __future__ import annotations

import dataclasses
from typing import Any

from .hw import H100, Hardware

COLLECTIVE_OPS = (
    "all-gather",
    "all-reduce",
    "reduce-scatter",
    "all-to-all",
    "collective-permute",
)


def wire_bytes(kind: str, result_bytes: float, n: int) -> float:
    """Per-device wire bytes of one collective (ring-algorithm model), for
    result bytes R and group size n:
      all-gather          R (n-1)/n      (operand is R/n, gathered)
      all-reduce          2 R (n-1)/n    (reduce-scatter + all-gather)
      reduce-scatter      R (n-1)        (operand R*n scattered)
      all-to-all          R (n-1)/n
      collective-permute  R
    """
    R, n = float(result_bytes), max(int(n), 1)
    if kind == "all-gather":
        return R * (n - 1) / n
    if kind == "all-reduce":
        return 2.0 * R * (n - 1) / n
    if kind == "reduce-scatter":
        return R * (n - 1)
    if kind == "all-to-all":
        return R * (n - 1) / n
    if kind == "collective-permute":
        return R
    raise ValueError(f"unknown collective kind {kind!r}")


@dataclasses.dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    chips: int
    flops_per_device: float
    bytes_per_device: float
    collective_bytes_per_device: float
    collectives: dict[str, Any]
    model_flops: float            # 6*N*D (or 6*N_active*D for MoE)
    memory_per_device: dict[str, float]
    hw: Hardware = H100
    # the wire bytes over each link ({"intra": ..., "inter": ...}); None:
    # all of them over the slower link between nodes
    link_bytes: dict[str, float] | None = None

    @property
    def t_compute(self) -> float:
        return self.flops_per_device / self.hw.peak_flops

    @property
    def t_memory(self) -> float:
        return self.bytes_per_device / self.hw.hbm_bytes_per_s

    @property
    def t_collective(self) -> float:
        links = self.link_bytes or {"inter": self.collective_bytes_per_device}
        return sum(b / self.hw.link_bytes_per_s(link) for link, b in links.items())

    @property
    def dominant(self) -> str:
        terms = {
            "compute": self.t_compute,
            "memory": self.t_memory,
            "collective": self.t_collective,
        }
        return max(terms, key=terms.get)

    @property
    def bound_time(self) -> float:
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def useful_flops_fraction(self) -> float:
        """MODEL_FLOPS / global FLOPs (remat and redundant work)."""
        total = self.flops_per_device * self.chips
        return self.model_flops / total if total else 0.0

    @property
    def roofline_fraction(self) -> float:
        """Fraction of the dominant-resource roofline this step achieves
        on *useful* work: (model_flops / chips / peak) / bound_time."""
        ideal = self.model_flops / self.chips / self.hw.peak_flops
        return ideal / self.bound_time if self.bound_time else 0.0

    def to_dict(self) -> dict:
        return {
            "arch": self.arch,
            "shape": self.shape,
            "mesh": self.mesh,
            "chips": self.chips,
            "flops_per_device": self.flops_per_device,
            "bytes_per_device": self.bytes_per_device,
            "collective_bytes_per_device": self.collective_bytes_per_device,
            "collectives": self.collectives,
            "model_flops": self.model_flops,
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "dominant": self.dominant,
            "useful_flops_fraction": self.useful_flops_fraction,
            "roofline_fraction": self.roofline_fraction,
            "memory_per_device": self.memory_per_device,
        }


def model_flop_share(flops: float, seconds: float, hw: Hardware = H100) -> float:
    """The share of ``hw``'s dense bf16 peak that ``flops`` of model work
    in ``seconds`` of wall reach."""
    return flops / (seconds * hw.peak_flops)


def _shape_spec(shape):
    from ..launch.shapes import SHAPES

    return SHAPES[shape] if isinstance(shape, str) else shape


def model_flops_estimate(arch_spec, shape, n_params: int) -> float:
    """6*N*D with N = active params (MoE: routed fraction + shared);
    ``shape`` a name of ``launch.shapes.SHAPES`` or a ``ShapeSpec``."""
    from ..models.encdec import dec_len

    cfg = arch_spec.model
    sp = _shape_spec(shape)
    if sp.kind == "train":
        if cfg.family == "audio":
            tokens = sp.batch * (sp.seq + dec_len(cfg, sp.seq))
        else:
            tokens = sp.batch * sp.seq
        factor = 6.0
    elif sp.kind == "prefill":
        tokens = sp.batch * sp.seq
        factor = 2.0
    else:  # decode: one token per sequence
        tokens = sp.batch * 1
        factor = 2.0
    n_active = active_params(arch_spec, n_params)
    return factor * n_active * tokens


def active_params(arch_spec, n_params: int) -> float:
    """Active-per-token parameter count (MoE discounts unused experts)."""
    cfg = arch_spec.model
    m = cfg.moe
    if not m.n_experts:
        return float(n_params)
    # fraction of layers that are MoE; each token uses top_k experts
    n_moe_layers = sum(
        1
        for i in range(cfg.n_layers)
        if cfg.layer_spec(i).mlp in ("moe", "moe_dense")
    )
    per_expert = 3 * cfg.d_model * (m.expert_ff or cfg.d_ff)
    if cfg.mlp_type == "gelu":
        per_expert = 2 * cfg.d_model * (m.expert_ff or cfg.d_ff)
    total_expert = n_moe_layers * m.n_experts * per_expert
    active_expert = n_moe_layers * m.top_k * per_expert
    return float(n_params) - total_expert + active_expert


__all__ = [
    "COLLECTIVE_OPS",
    "Roofline",
    "active_params",
    "model_flop_share",
    "model_flops_estimate",
    "wire_bytes",
]
