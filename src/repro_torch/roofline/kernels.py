"""The hand-written kernels' work as functions of their shapes: the
operations and the unit that runs them, the bytes a call must move (each
input read once, each output written once; scratch not counted) and the
exps on the special-function units.

One function a kernel, read by three callers: ``chip_smoke.py``'s phase 3
(each case's bound), the ``meta`` stand-ins of the LM kernels (a dry
run's count) and the kernels' launches on the card (the same count of
the same call), so that a kernel's share of its bound reads the same
work whatever runs it.
"""
from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch

from .hw import DTYPE_BYTES, HBM_BYTES_PER_S, OPS_PER_S, SFU_EXP_PER_S


@dataclasses.dataclass(frozen=True)
class Work:
    """``ops``: (operations, unit) pairs whose times add, the unit a key
    of ``hw.OPS_PER_S``; ``bytes`` moved; ``exps`` on the SFUs."""
    ops: tuple[tuple[float, str], ...]
    bytes: float
    exps: float = 0.0

    @property
    def flops(self) -> float:
        return float(sum(n for n, _ in self.ops))

    def bounds_ms(self) -> dict[str, float]:
        """ms of each bound: the bytes at the HBM rate, the operations at
        their units' rates (added) and, where there are any, the exps."""
        out = {"bytes": self.bytes / HBM_BYTES_PER_S * 1e3,
               "operations": sum(n / OPS_PER_S[unit] for n, unit in self.ops) * 1e3}
        if self.exps:
            out["exp"] = self.exps / SFU_EXP_PER_S * 1e3
        return out


def _nbytes(dtype: torch.dtype, *shape: int) -> int:
    return DTYPE_BYTES[dtype] * math.prod(shape)


def _unit(dtype: torch.dtype) -> str:
    """The unit of an attention product: bf16 on the tensor cores, f32
    on the CUDA cores."""
    return "bf16" if dtype == torch.bfloat16 else "f32"


@functools.lru_cache(maxsize=4096)
def visible_pairs(Sq: int, Skv: int, causal: bool = True, window: int = 0, q_offset: int = 0,
                  kv_len: int | None = None) -> int:
    """The (query, key) pairs the attention's masks keep, for one batch
    row and head: query i at position ``q_offset + i`` sees key j <
    ``kv_len`` with ``j <= position`` (causal) and ``j > position -
    window`` (``window > 0``), as ``ref._visible``."""
    kv = Skv if kv_len is None else int(kv_len)
    pos = q_offset + np.arange(Sq, dtype=np.int64)
    hi = np.minimum(kv - 1, pos) if causal else np.full(Sq, kv - 1, dtype=np.int64)
    lo = np.maximum(0, pos - window + 1) if window > 0 else np.zeros(Sq, dtype=np.int64)
    return int(np.maximum(0, hi - lo + 1).sum())


def flash_attention(B: int, Sq: int, Skv: int, H: int, KV: int, D: int, dtype: torch.dtype, *,
                    causal: bool = True, window: int = 0, q_offset: int = 0,
                    kv_len: int | None = None, with_lse: bool = False) -> Work:
    """The forward: QK^T and PV over the visible pairs (4 H D operations a
    pair); reads q and the first ``kv_len`` rows of k and v, writes out
    (and the f32 ``lse`` when training asks for it)."""
    kv = Skv if kv_len is None else int(kv_len)
    pairs = B * visible_pairs(Sq, Skv, causal, window, q_offset, kv_len)
    moved = 2 * _nbytes(dtype, B, Sq, H, D) + 2 * _nbytes(dtype, B, kv, KV, D)
    if with_lse:
        moved += _nbytes(torch.float32, B, Sq, H)
    return Work(ops=((4.0 * H * D * pairs, _unit(dtype)),), bytes=moved)


def flash_attention_bwd(B: int, Sq: int, Skv: int, H: int, KV: int, D: int, dtype: torch.dtype, *,
                        causal: bool = True, window: int = 0, q_offset: int = 0,
                        kv_len: int | None = None) -> Work:
    """The backward: five products of 2 H D a visible pair (S and P
    recomputed, dV, dP, dQ, dK); reads q, k, v, out, dout and the f32
    lse, writes dq, dk, dv."""
    pairs = B * visible_pairs(Sq, Skv, causal, window, q_offset, kv_len)
    q = _nbytes(dtype, B, Sq, H, D)
    kv = _nbytes(dtype, B, Skv, KV, D)
    moved = 3 * q + 2 * kv + _nbytes(torch.float32, B, Sq, H) + q + 2 * kv
    return Work(ops=((5 * 2.0 * H * D * pairs, _unit(dtype)),), bytes=moved)


def rwkv_ops(S: int, chunk: int, H: int = 64, N: int = 64) -> float:
    """f32 operations of the chunked scan for one sequence: per chunk and
    head the strict-lower C x C product and its V product, (r E) S and
    the state carry, two operations per multiply-add."""
    C = min(chunk, S)
    n_chunks = math.ceil(S / C)
    return 2.0 * n_chunks * H * (C * (C - 1) * N + 2 * C * N * N)


def rwkv_bwd_ops(S: int, chunk: int, H: int = 64, N: int = 64) -> float:
    """f32 operations of the chunked scan's backward for one sequence:
    per chunk and head the N x N products d(rE)'s dO S_in^T, V dS_out^T
    and dV's (k/E'.E_C) dS_out, and the carry's (r E)^T dO, then A, dA
    and the products with them on the strict lower triangle (five of
    C (C - 1) / 2 N), two operations per multiply-add."""
    C = min(chunk, S)
    n_chunks = math.ceil(S / C)
    return 2.0 * n_chunks * H * (4 * C * N * N + 2.5 * C * (C - 1) * N)


def rwkv_bwd_bound(S: int, chunk: int, H: int = 64, N: int = 64,
                   bf16: bool = True) -> tuple[tuple[float, str], ...]:
    """The operations of ``rwkv6_scan_bwd`` as its kernels run them for
    one sequence: the carry's (r E)^T dO on the CUDA cores in f32, and
    with bf16 inputs the intra kernel's products on the tensor cores in
    TF32 (f32 inputs: all on the CUDA cores)."""
    C = min(chunk, S)
    carry = 2.0 * math.ceil(S / C) * H * C * N * N
    rest = rwkv_bwd_ops(S, chunk, H, N) - carry
    return ((carry, "f32"), (rest, "tf32" if bf16 else "f32"))


def rwkv6_scan(B: int, S: int, H: int, N: int, chunk: int, dtype: torch.dtype, *,
               with_states: bool = False) -> Work:
    """The forward over ``S`` tokens: reads r, k, v (``dtype``), w (f32),
    u, the input state; writes out and the state (and, for training,
    every chunk's input state)."""
    C = min(chunk, S)
    act = _nbytes(dtype, B, S, H, N)
    moved = (3 * act + _nbytes(torch.float32, B, S, H, N) + _nbytes(torch.float32, H, N)
             + 2 * _nbytes(torch.float32, B, H, N, N) + act)
    if with_states:
        moved += _nbytes(torch.float32, B, H, math.ceil(S / C), N, N)
    return Work(ops=((B * rwkv_ops(S, chunk, H, N), "f32"),), bytes=moved)


def rwkv6_scan_bwd(B: int, S: int, H: int, N: int, chunk: int, dtype: torch.dtype, *,
                   with_dstate: bool = True) -> Work:
    """The backward: reads r, k, v, dout (``dtype``), w (f32), u, the
    input state and the state's cotangent; writes dr, dk, dv, dw, du and
    the input state's gradient."""
    act = _nbytes(dtype, B, S, H, N)
    w = _nbytes(torch.float32, B, S, H, N)
    u = _nbytes(torch.float32, H, N)
    state = _nbytes(torch.float32, B, H, N, N)
    moved = 4 * act + w + u + state * (2 if with_dstate else 1) + 3 * act + w + u + state
    ops = rwkv_bwd_bound(S, chunk, H, N, bf16=dtype == torch.bfloat16)
    return Work(ops=tuple((B * n, unit) for n, unit in ops), bytes=moved)


def _ssm_inputs(B: int, S: int, dim: int, N: int, dtype: torch.dtype, with_h0: bool) -> int:
    """x and B, C in ``dtype``; dt (f32, as x), A, D and the input state."""
    return (_nbytes(dtype, B, S, dim) + _nbytes(torch.float32, B, S, dim)
            + _nbytes(torch.float32, dim, N) + 2 * _nbytes(dtype, B, S, N)
            + _nbytes(torch.float32, dim) + (_nbytes(torch.float32, B, dim, N) if with_h0 else 0))


def ssm_scan(B: int, S: int, dim: int, N: int, dtype: torch.dtype, *,
             with_h0: bool = True) -> Work:
    """The selective scan: one exp a (token, channel, state) and ~6 f32
    operations; reads x, dt, A, B, C, D and the input state, writes y
    and the state."""
    per_state = B * S * dim * N
    moved = (_ssm_inputs(B, S, dim, N, dtype, with_h0) + _nbytes(dtype, B, S, dim)
             + _nbytes(torch.float32, B, dim, N))
    return Work(ops=((6.0 * per_state, "f32"),), bytes=moved, exps=per_state)


def ssm_scan_bwd(B: int, S: int, dim: int, N: int, dtype: torch.dtype, *,
                 with_h0: bool = True, with_dh: bool = True) -> Work:
    """The backward: one exp and ~10 f32 operations a (token, channel,
    state) (the forward's recomputation, g, dA, ddt, dx, dB, dC and the
    carry); reads the forward's inputs, dy and dh, writes dx, ddt, dA,
    dB, dC, dD and dh0."""
    per_state = B * S * dim * N
    f32 = torch.float32
    moved = (_ssm_inputs(B, S, dim, N, dtype, with_h0) + _nbytes(dtype, B, S, dim)
             + (_nbytes(f32, B, dim, N) if with_dh else 0)
             + _nbytes(dtype, B, S, dim) + _nbytes(f32, B, S, dim) + _nbytes(f32, dim, N)
             + 2 * _nbytes(dtype, B, S, N) + _nbytes(f32, dim) + _nbytes(f32, B, dim, N))
    return Work(ops=((10.0 * per_state, "f32"),), bytes=moved, exps=per_state)


# the simulator's kernels: bytes of one call at a fleet's shapes (F
# lanes, MC containers, MP pipelines), with a few compares and selects
# an input element on the CUDA cores
def _sim(moved: int, inputs: int) -> Work:
    return Work(ops=((4.0 * inputs, "f32"),), bytes=moved)


def fleet_tick(F: int, MC: int, MP: int, NP: int) -> Work:
    """Reads six [F, MC] and three [F, MP] 4-byte tables and the ticks;
    writes two [F, MC] masks, the new statuses, two [F, NP] f32 sums, two
    [F, MP] masks and two [F] registers."""
    inputs = 6 * F * MC + 3 * F * MP + F
    return _sim(4 * inputs + 2 * F * MC + 4 * F * MC + 8 * F * NP + 2 * F * MP + 8 * F, inputs)


def retire_land(F: int, MC: int, MP: int, *, timeout: bool = False) -> Work:
    """Reads the containers' pipelines and ends (and with the timeout
    branch their starts), two [F, MC] masks (three), arrivals and
    priorities (and the ticks); writes three [F, MP] masks, the ends, and
    the per-lane and per-priority sums."""
    inputs = (3 if timeout else 2) * F * MC + (3 if timeout else 2) * F * MC + 2 * F * MP + (
        F if timeout else 0)
    moved = (4 * (3 if timeout else 2) * F * MC + (3 if timeout else 2) * F * MC + 8 * F * MP
             + (4 * F if timeout else 0))
    out = 3 * F * MP + 4 * F * MP + 4 * F + 4 * F + 12 * F + 12 * F + 8 * F
    return _sim(moved + out, inputs)


def masked_lex_argmin(F: int, N: int, key_bytes=(4, 4, 4)) -> Work:
    """Reads the [F, N] mask and K keys of ``key_bytes`` each; writes one
    [F] index."""
    return _sim(F * N * (1 + sum(key_bytes)) + 4 * F, F * N * (1 + len(key_bytes)))


def assign_gather(F: int, K: int, MC: int, MP: int) -> Work:
    """Reads K assignment rows a lane (three masks, eight 4-byte fields);
    writes seven [F, MC] int32 fields, two [F, MP] f32 ones, three
    [F, MC] masks and one [F, MP] mask."""
    return _sim(3 * F * K + 32 * F * K + 28 * F * MC + 8 * F * MP + 3 * F * MC + F * MP, 11 * F * K)


__all__ = [
    "Work",
    "assign_gather",
    "flash_attention",
    "flash_attention_bwd",
    "fleet_tick",
    "masked_lex_argmin",
    "retire_land",
    "rwkv6_scan",
    "rwkv6_scan_bwd",
    "rwkv_bwd_bound",
    "rwkv_bwd_ops",
    "rwkv_ops",
    "ssm_scan",
    "ssm_scan_bwd",
    "visible_pairs",
]
