"""Plain PyTorch version of the masked lexicographic selection.

Carries the semantics of
``repro.kernels.sched_select.ref.masked_lex_argmin_ref``: per lane, the
index of the lexicographically smallest ``(keys[0][i], ..., keys[-1][i],
i)`` among the masked entries of the last axis, or -1 where the mask is
empty. One narrowing sweep per key: unmasked entries read the sentinel
``BIG = 2**31 - 1`` converted to the key's dtype (2**31 for an f32 key),
the minimum narrows the mask, emptiness is the first key's minimum
equalling that sentinel, and the first index achieving the last key's
minimum wins (the first NaN, where one remains, as ``jnp.argmin`` picks
it).

Keys keep their own dtypes (f32 or int32); they are never stacked into
one tensor, which would round int32 keys above 2**24 in f32.
"""
from __future__ import annotations

import torch

BIG = 2**31 - 1


def sentinel(key: torch.Tensor):
    """``BIG`` converted to ``key``'s dtype, as a Python number."""
    return float(torch.tensor(BIG, dtype=key.dtype)) if key.is_floating_point() else BIG


def masked_lex_argmin_ref(mask, keys):
    keys = tuple(keys)
    m = mask
    empty = None
    for k in keys[:-1]:
        big = sentinel(k)
        km = torch.where(m, k, big)
        b = km.amin(-1, keepdim=True)
        if empty is None:
            empty = b[..., 0] == big
        m = km == b
    big = sentinel(keys[-1])
    km = torch.where(m, keys[-1], big)
    if empty is None:
        empty = km.amin(-1) == big
    # the first index of the minimum, or of the first NaN where one
    # remains (torch.argmin picks it, as jnp.argmin does)
    idx = km.argmin(-1)
    return torch.where(empty, -1, idx).to(torch.int32)


def select_next_pipe_ref(mask, prio, entered):
    """Queue head: priority desc, entry asc, pid asc."""
    return masked_lex_argmin_ref(mask, (-prio, entered))


def select_victim_ref(live, ctr_prio, ctr_start, below_prio):
    """Preemption victim below ``below_prio`` ([F, 1] or broadcastable):
    priority asc, start desc, slot asc."""
    m = live & (ctr_prio < below_prio)
    return masked_lex_argmin_ref(m, (ctr_prio, -ctr_start))


def select_sjf_ref(mask, n_ops, prio, entered):
    """Smallest job first: op count asc, priority desc, entry asc, pid asc."""
    return masked_lex_argmin_ref(mask, (n_ops, -prio, entered))


__all__ = [
    "BIG",
    "masked_lex_argmin_ref",
    "select_next_pipe_ref",
    "select_sjf_ref",
    "select_victim_ref",
    "sentinel",
]
