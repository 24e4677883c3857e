"""Closed-loop clients and admission control (the overload layer), lane-major.

The open-loop simulator offers every arrival to the scheduler. This
layer puts a client model and an admission stage ahead of it: the
clients decide which pending arrivals are *offered* at an event, and the
admission policy may REJECT an offer (the client retries it after a
backoff, or it is shed) or DEFER it. With every client and admission
knob at its zero default ``params.closed_loop_active`` is False and the
engine runs nothing of this module.

Admission policies are registered by key, as scheduler families are:

>>> sorted(list_admission_policies())
['admit_all', 'codel', 'queue_threshold', 'token_bucket']
>>> has_admission_policy("queue-threshold")
True

A compiled policy has the signature::

    policy(state, wl, params, tick, offered) -> (state, reject, defer,
                                                 defer_ticks)

over a fleet: ``offered``, ``reject`` and ``defer`` are ``[F, MP]`` bool
masks (``reject`` and ``defer`` subsets of ``offered``), ``tick`` and
the policy registers (token bucket level, CoDel clock) in the returned
state are ``[F]``, and ``defer_ticks`` is a Python int: deferred offers
re-land ``max(defer_ticks, 1)`` ticks later through the suspension
release registers, so the event skip stays exact. Ranks are taken in
pipe-index order (a ``cumsum`` along the last axis), because the numpy
mirrors walk the pids in ascending order.

Every built-in policy has a numpy mirror (``*_py``, registered under the
same key) for a per-tick Python engine, op for op identical to the
compiled policy, f32 rounding included. The mirrors see an
:class:`AdmissionView` in place of the state:

>>> view = AdmissionView(admitted_waiting=3, oldest_admitted_entered=0,
...                      regs={"tokens": np.float32(2.0), "last_tick": 0,
...                            "above_since": int(INF_TICK)})
>>> p = SimParams(admission_policy="queue_threshold", admit_queue_limit=4)
>>> reject, defer, _ = queue_threshold_py(p, 10, [5, 6, 7], view)
>>> (reject, defer)   # one free slot below the limit -> admit pid 5 only
([6, 7], [])
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from .executor import WAITING, _col, backoff_ticks
from .params import SimParams
from .state import SimState, Workload
from .types import INF_TICK, TICKS_PER_SECOND, PipeStatus

_I32, _F32 = torch.int32, torch.float32

# (state, wl, params, tick, offered) -> (state, reject, defer, defer_ticks)
AdmissionPolicy = Callable[
    [SimState, Workload, SimParams, torch.Tensor, torch.Tensor],
    tuple[SimState, torch.Tensor, torch.Tensor, int],
]
# (params, tick, offered_pids, view) -> (reject_pids, defer_pids, defer_ticks)
AdmissionPolicyPy = Callable[
    [SimParams, int, list, "AdmissionView"], tuple[list, list, int]
]

_POLICIES: dict[str, AdmissionPolicy] = {}
_POLICIES_PY: dict[str, AdmissionPolicyPy] = {}


def _norm(key: str) -> str:
    return key.replace("-", "_").lower()


def register_admission_policy(key: str):
    """Register a compiled (lane-major) admission policy."""

    def deco(fn: AdmissionPolicy) -> AdmissionPolicy:
        _POLICIES[_norm(key)] = fn
        return fn

    return deco


def register_admission_policy_py(key: str):
    """Register the numpy mirror of a policy."""

    def deco(fn: AdmissionPolicyPy) -> AdmissionPolicyPy:
        _POLICIES_PY[_norm(key)] = fn
        return fn

    return deco


def get_admission_policy(key: str) -> AdmissionPolicy:
    k = _norm(key)
    if k not in _POLICIES:
        raise KeyError(
            f"unknown admission policy {key!r}; registered: "
            f"{sorted(_POLICIES)}"
        )
    return _POLICIES[k]


def get_admission_policy_py(key: str) -> AdmissionPolicyPy:
    k = _norm(key)
    if k not in _POLICIES_PY:
        raise KeyError(
            f"admission policy {key!r} has no python mirror; registered: "
            f"{sorted(_POLICIES_PY)}"
        )
    return _POLICIES_PY[k]


def has_admission_policy(key: str) -> bool:
    return _norm(key) in _POLICIES


def list_admission_policies() -> list[str]:
    return sorted(_POLICIES)


class AdmissionView:
    """Queue statistics and mutable policy registers for the numpy mirrors.

    ``admitted_waiting`` counts pipelines admitted and still WAITING (the
    backlog the scheduler sees); ``oldest_admitted_entered`` is the
    smallest ``entered`` tick among them (``INF_TICK`` when none);
    ``regs`` holds the policy registers {"tokens": np.float32,
    "last_tick": int, "above_since": int} that policies mutate in place.
    """

    __slots__ = ("admitted_waiting", "oldest_admitted_entered", "regs")

    def __init__(self, admitted_waiting, oldest_admitted_entered, regs):
        self.admitted_waiting = admitted_waiting
        self.oldest_admitted_entered = oldest_admitted_entered
        self.regs = regs


# ---------------------------------------------------------------------------
# Built-in policies. Each compiled policy is followed by its numpy mirror;
# keep them in step when editing.
# ---------------------------------------------------------------------------
@register_admission_policy("admit_all")
def admit_all(state, wl, params, tick, offered):
    """Default open-door policy: nothing rejected, nothing deferred."""
    z = torch.zeros_like(offered)
    return state, z, z, 1


@register_admission_policy_py("admit_all")
def admit_all_py(params, tick, offered, view):
    return [], [], 1


@register_admission_policy("queue_threshold")
def queue_threshold(state, wl, params, tick, offered):
    """REJECT offers beyond a cap on admitted-and-waiting pipelines.

    Load shedding: the backlog the scheduler may accumulate is bounded
    by ``params.admit_queue_limit``; everything else bounces to the
    client, which may retry it after a backoff (the retry storm, when
    the limit is hit during an outage).
    """
    waiting = state.pipe_status == WAITING
    q = (waiting & state.pipe_offered).sum(-1, dtype=_I32)
    slots = torch.clamp_min(params.admit_queue_limit - q, 0)
    rank = offered.cumsum(-1, dtype=_I32)
    reject = offered & (rank > _col(slots))
    return state, reject, torch.zeros_like(offered), 1


@register_admission_policy_py("queue_threshold")
def queue_threshold_py(params, tick, offered, view):
    slots = max(params.admit_queue_limit - view.admitted_waiting, 0)
    return list(offered[slots:]), [], 1


def _token_bucket_consts(params: SimParams) -> tuple[np.float32, int]:
    """(per-tick refill rate as f32, defer interval in ticks), taken on
    the host."""
    rate = np.float32(params.admit_rate_per_s / TICKS_PER_SECOND)
    if params.admit_rate_per_s > 0:
        defer_ticks = max(
            int(np.ceil(TICKS_PER_SECOND / params.admit_rate_per_s)), 1
        )
    else:  # zero rate: only the initial burst ever admits
        defer_ticks = int(TICKS_PER_SECOND)
    return rate, defer_ticks


@register_admission_policy("token_bucket")
def token_bucket(state, wl, params, tick, offered):
    """DEFER offers beyond a token-bucket rate limit.

    Tokens accrue at ``admit_rate_per_s`` up to ``admit_burst``; each
    admission consumes one. Offers without a token are deferred one
    refill interval (the bucket never rejects: pair it with a client
    concurrency cap or a queue threshold for shedding).
    """
    rate, defer_ticks = _token_bucket_consts(params)
    elapsed = (tick - state.admit_last_tick).to(_F32)
    # the max is value-neutral (elapsed, rate >= 0); the reference keeps
    # it so that XLA does not contract the product and the sum into one
    # FMA, and it stays here so that the two read alike (each torch op
    # rounds on its own)
    refill = torch.clamp_min(elapsed * float(rate), 0.0)
    tokens = torch.clamp_max(state.admit_tokens + refill, float(np.float32(params.admit_burst)))
    n_admit = torch.floor(tokens).to(_I32)
    rank = offered.cumsum(-1, dtype=_I32)
    admit = offered & (rank <= _col(n_admit))
    defer = offered & ~admit
    tokens = tokens - admit.sum(-1, dtype=_I32).to(_F32)
    state = state._replace(admit_tokens=tokens, admit_last_tick=tick)
    return state, torch.zeros_like(offered), defer, defer_ticks


@register_admission_policy_py("token_bucket")
def token_bucket_py(params, tick, offered, view):
    regs = view.regs
    rate, defer_ticks = _token_bucket_consts(params)
    elapsed = np.float32(tick - regs["last_tick"])
    tokens = np.minimum(
        np.float32(regs["tokens"] + np.float32(elapsed * rate)),
        np.float32(params.admit_burst),
    )
    n_admit = int(np.floor(tokens).astype(np.int32))
    admit = offered[:n_admit] if n_admit > 0 else []
    defer = list(offered[len(admit):])
    regs["tokens"] = np.float32(tokens - np.float32(len(admit)))
    regs["last_tick"] = tick
    return [], defer, defer_ticks


@register_admission_policy("codel")
def codel(state, wl, params, tick, offered):
    """REJECT all offers while queue delay stays above target (CoDel).

    Delay = sojourn of the oldest admitted-and-waiting pipeline. Once it
    exceeds ``codel_target_ticks`` continuously for
    ``codel_interval_ticks``, every offer is rejected until the delay
    recovers: it bounds queue *delay* rather than queue *depth*.
    """
    waiting_adm = (state.pipe_status == WAITING) & state.pipe_offered
    oldest = torch.where(waiting_adm, state.pipe_entered, INF_TICK).amin(-1)
    delay = torch.where(oldest == INF_TICK, 0, tick - oldest)
    above = delay > params.codel_target_ticks
    above_since = torch.where(
        above, torch.minimum(state.codel_above_since, tick), INF_TICK)
    overload = above & ((tick - above_since) >= params.codel_interval_ticks)
    reject = offered & _col(overload)
    state = state._replace(codel_above_since=above_since)
    return state, reject, torch.zeros_like(offered), 1


@register_admission_policy_py("codel")
def codel_py(params, tick, offered, view):
    regs = view.regs
    oldest = view.oldest_admitted_entered
    delay = 0 if oldest == int(INF_TICK) else tick - oldest
    above = delay > params.codel_target_ticks
    if above:
        regs["above_since"] = min(regs["above_since"], tick)
    else:
        regs["above_since"] = int(INF_TICK)
    overload = above and (tick - regs["above_since"]
                          >= params.codel_interval_ticks)
    return (list(offered) if overload else []), [], 1


# ---------------------------------------------------------------------------
# The closed-loop pass. The engine runs it in every event after phase 1
# and the fault pass, before the scheduler's view (engine.event_step)
# when ``params.closed_loop_active``.
# ---------------------------------------------------------------------------
def apply_closed_loop(
    state: SimState, wl: Workload, tick: torch.Tensor, params: SimParams
) -> SimState:
    """Offer pending arrivals through the client gate and the admission
    policy, for every lane.

    Fresh presentations are WAITING pipelines that never started and are
    not admitted (``~pipe_offered``): new arrivals, and deferred or
    client-retried ones re-landed by the release machinery. Each
    presentation counts toward ``offered_total`` again, which makes the
    retry amplification observable. Deferred and client-retried offers
    park as SUSPENDED with a release tick folded into ``nxt_release``,
    so the event-skip registers stay exact with no new event source.
    Every count is per lane, an int32 sum along the last axis.
    """
    t = _col(tick)
    status = state.pipe_status
    waiting = status == WAITING
    fresh = waiting & (state.pipe_first_start == INF_TICK) & ~state.pipe_offered

    # ---- client concurrency gate (closed-loop think time) ----------------
    if params.client_max_inflight > 0:
        active = (waiting | (status == int(PipeStatus.RUNNING))
                  | (status == int(PipeStatus.SUSPENDED)))
        inflight = (state.pipe_offered & active).sum(-1, dtype=_I32)
        slots = torch.clamp_min(params.client_max_inflight - inflight, 0)
        offer = fresh & (fresh.cumsum(-1, dtype=_I32) <= _col(slots))
        gate_defer = fresh & ~offer
    else:
        offer = fresh
        gate_defer = torch.zeros_like(fresh)

    prio_rows = wl.prio[:, None, :] == torch.arange(
        3, dtype=_I32, device=tick.device)[:, None]                 # [F, 3, MP]
    off_prio = (prio_rows & offer[:, None, :]).sum(-1, dtype=_I32)

    # ---- admission policy (reads the pre-admission queue) ----------------
    if params.admission_active:
        policy = get_admission_policy(params.admission_policy)
        state, reject, defer, defer_ticks = policy(state, wl, params, tick, offer)
    else:
        reject = defer = torch.zeros_like(offer)
        defer_ticks = 1
    admit = offer & ~reject & ~defer
    adm_prio = (prio_rows & admit[:, None, :]).sum(-1, dtype=_I32)

    # ---- rejects: client retry with capped exponential backoff, or shed --
    attempts = state.pipe_client_attempts
    can_retry = reject & (attempts < params.client_max_retries)
    shed = reject & ~can_retry
    retry_release = t + torch.clamp_min(backoff_ticks(params.client_backoff_ticks, attempts), 1)
    gate_release = t + max(int(params.client_think_ticks), 1)
    pol_release = t + max(int(defer_ticks), 1)
    to_suspend = gate_defer | defer | can_retry
    release = torch.where(
        gate_defer, gate_release, torch.where(defer, pol_release, retry_release))

    def count(mask):
        return mask.sum(-1, dtype=_I32)

    state = state._replace(
        pipe_status=torch.where(
            to_suspend, int(PipeStatus.SUSPENDED),
            torch.where(shed, int(PipeStatus.FAILED), status)),
        pipe_release=torch.where(to_suspend, release, state.pipe_release),
        pipe_completion=torch.where(shed, t, state.pipe_completion),
        pipe_offered=state.pipe_offered | admit,
        pipe_presented=state.pipe_presented | offer,
        pipe_client_attempts=attempts + can_retry.to(_I32),
        offered_total=state.offered_total + count(offer),
        offered_unique=state.offered_unique + count(offer & ~state.pipe_presented),
        admitted_total=state.admitted_total + count(admit),
        shed_total=state.shed_total + count(reject),
        deferred_total=state.deferred_total + count(gate_defer | defer),
        client_retry_events=state.client_retry_events + count(can_retry),
        offered_prio=state.offered_prio + off_prio,
        admitted_prio=state.admitted_prio + adm_prio,
        failed_count=state.failed_count + count(shed),
        nxt_release=torch.minimum(
            state.nxt_release, torch.where(to_suspend, release, INF_TICK).amin(-1)),
    )

    # ---- drain detection (overload recovery, needs the chaos layer) ------
    if params.fault_events_active:
        backlog = count(state.pipe_status == WAITING)
        drained = (
            (state.last_fault_tick != INF_TICK)
            & (tick > state.last_fault_tick)
            & (backlog <= torch.clamp_min(state.prefault_backlog, 0))
            & (state.drain_tick == INF_TICK)
        )
        state = state._replace(
            drain_tick=torch.where(drained, tick, state.drain_tick))
    return state


__all__ = [
    "AdmissionPolicy",
    "AdmissionPolicyPy",
    "AdmissionView",
    "apply_closed_loop",
    "admit_all",
    "admit_all_py",
    "codel",
    "codel_py",
    "get_admission_policy",
    "get_admission_policy_py",
    "has_admission_policy",
    "list_admission_policies",
    "queue_threshold",
    "queue_threshold_py",
    "register_admission_policy",
    "register_admission_policy_py",
    "token_bucket",
    "token_bucket_py",
]
