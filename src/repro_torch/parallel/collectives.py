"""Distributed-optimization collectives: error-feedback compressed
gradient all-reduce, a port of ``repro.parallel.collectives``.

``compressed_psum_mean``: int8-quantised data-parallel gradient
reduction with a per-tensor scale and an error-feedback buffer (the
quantisation residual is added back into the next step's gradient,
which keeps SGD/Adam convergence: Seide et al. / EF-SGD). The
collectives are explicit: an ``all_reduce(MAX)`` of the scale and an
int32 ``all_reduce(SUM)`` of the int8 payloads on the group of one mesh
axis. The int32 payload moves 4 bytes an element, as f32 does: what the
scheme gains here is a sum that is exact whatever the order of the
ranks, with the rounding carried by the error feedback, not fewer bytes
on the wire (that wants an int8 payload collective, which the port has
not).

``quantize_int8``, ``dequantize_int8`` and ``ef_compress_grad`` equal
the reference bit for bit (``torch.round`` and ``jnp.round`` both round
half to even; divisions are by f32 tensors, never by a Python scalar,
which CUDA turns into a multiplication by the reciprocal).
"""
from __future__ import annotations

from typing import Mapping

import torch

F32 = torch.float32


def _f32(x: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(x, dtype=F32, device=like.device)


def _scale_of(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp_min(torch.amax(torch.abs(x)), 1e-12) / _f32(127.0, x)


def _quantize(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)


def quantize_int8(x: torch.Tensor):
    """Symmetric per-tensor int8 quantisation. Returns (q, scale)."""
    xf = x.to(F32)
    scale = _scale_of(xf)
    return _quantize(xf, scale), scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(F32) * scale


def ef_compress_grad(g: torch.Tensor, err: torch.Tensor):
    """Error-feedback compression of one gradient tensor: quantises
    ``g + err`` and keeps the residual. Returns (q int8, scale f32,
    new_err f32)."""
    corrected = g.to(F32) + err
    q, scale = quantize_int8(corrected)
    return q, scale, corrected - dequantize_int8(q, scale)


def compressed_psum_mean(grads: Mapping[str, torch.Tensor], errs: Mapping[str, torch.Tensor],
                         mesh, axis: str = "data"):
    """Mean-reduce ``grads`` (each rank's locally accumulated gradients,
    plain tensors by name) over the mesh axis ``axis`` with int8 + error
    feedback. Returns (mean grads f32, new errs), both by name."""
    import torch.distributed as dist

    group = mesh.get_group(axis)
    n = dist.get_world_size(group)
    means, new_errs = {}, {}
    for name, g in grads.items():
        corrected = g.to(F32) + errs[name]
        # a shared scale across ranks (a tiny MAX) so the int8 payloads
        # sum exactly; then one int32 SUM carries the wire
        scale = _scale_of(corrected)
        dist.all_reduce(scale, op=dist.ReduceOp.MAX, group=group)
        q = _quantize(corrected, scale)
        new_errs[name] = corrected - q.to(F32) * scale
        qsum = q.to(torch.int32)
        dist.all_reduce(qsum, op=dist.ReduceOp.SUM, group=group)
        means[name] = qsum.to(F32) * scale / _f32(float(n), corrected)
    return means, new_errs


__all__ = [
    "compressed_psum_mean",
    "dequantize_int8",
    "ef_compress_grad",
    "quantize_int8",
]
