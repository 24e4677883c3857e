"""Plain PyTorch versions of the two table landings of one event.

* :func:`retire_land_ref` carries the semantics of
  ``repro.kernels.state_update.ref.retire_land_ref`` with the timeout
  branch off: for each pipeline, whether one of its containers OOMed or
  completed, its completion tick (the max end tick of its completing
  containers, 0 where none), and the latency sums (total and per
  priority, f32) and counts (int32). Several containers of one pipeline
  may retire together; the hit masks are "any" and ``end_of`` a max,
  so they land like scatters would.
* :func:`assign_gather_ref` carries ``assign_gather_ref``: up to K
  assignment rows land on the container axis (hit mask plus 9 fields)
  and the pipeline axis (hit mask plus cpus and RAM). Valid rows have
  unique slots and pipes, so each output has at most one source row.

The latency sums fold in the fixed order of ``kernels/fold.py``, the
order of the CUDA kernel (``csrc/state_update.cu``). The JAX reference
reduces them with ``jnp.sum`` in XLA's order, which is the same for
rows of a multiple of 32 entries; the comparison contract still holds
them only to rtol 1e-5, as the reference holds its own kernel.
"""
from __future__ import annotations

import torch

from ...core.state import seconds
from ...core.types import N_PRIO
from ..fold import ordered_sum

_TIMEOUT_SLICE = (
    "the timeout branch of retire_land waits for the chaos-layer slice "
    "(ROADMAP queue 1, item 10)"
)


def first_true(mask: torch.Tensor, dim: int) -> torch.Tensor:
    """Index of the first True along ``dim`` (int64), 0 where there is
    none: ``jnp.argmax`` of a bool array."""
    n = mask.shape[dim]
    shape = [1] * mask.dim()
    shape[dim] = n
    iota = torch.arange(n, device=mask.device).reshape(shape)
    idx = torch.where(mask, iota, n).amin(dim)
    return torch.where(idx == n, 0, idx)


def retire_land_ref(
    ctr_pipe, ctr_end, ctr_start, oomed, done, timed, arrival, prio, tick,
    *, timeout_on: bool = False,
):
    """Returns ``(oom_hit, done_hit, timed_hit, end_of, timed_wasted,
    lat_sum, lat_prio, done_prio, n_done, n_oom)`` over ``[F, MC]``
    container rows and ``[F, MP]`` pipeline rows; ``timed_hit`` and
    ``timed_wasted`` are zeros (timeout off). ``ctr_start``, ``timed``
    and ``tick`` are read only by the timeout branch."""
    if timeout_on:
        raise NotImplementedError(_TIMEOUT_SLICE)
    F, MP = arrival.shape
    dev = arrival.device
    retired = oomed | done
    pid = torch.where(retired, ctr_pipe, MP)
    oh = pid[:, :, None] == torch.arange(MP, dtype=torch.int32, device=dev)
    oom_hit = (oh & oomed[:, :, None]).any(1)
    land = oh & done[:, :, None]
    done_hit = land.any(1)
    end_of = torch.where(land, ctr_end[:, :, None], 0).amax(1).clamp_min(0)

    lat_s = seconds(end_of - arrival)
    prio_oh = prio[:, None, :] == torch.arange(
        N_PRIO, dtype=torch.int32, device=dev
    )[None, :, None]
    done_prio_oh = prio_oh & done_hit[:, None, :]
    lat_sum = ordered_sum(lat_s, done_hit[:, None, :])[:, 0]
    lat_prio = ordered_sum(lat_s, done_prio_oh)
    i32 = torch.int32
    return (
        oom_hit,
        done_hit,
        torch.zeros_like(done_hit),
        end_of,
        torch.zeros((F,), dtype=i32, device=dev),
        lat_sum,
        lat_prio,
        done_prio_oh.sum(-1, dtype=i32),
        done_hit.sum(-1, dtype=i32),
        oom_hit.sum(-1, dtype=i32),
    )


def assign_gather_ref(
    valid, slot, pipe, pool, cpus, ram, end, oom, prio, warm, timed,
    *, max_containers: int, max_pipelines: int,
):
    """Land ``[F, K]`` assignment rows on ``[F, MC]`` and ``[F, MP]``.

    Returns ``(hit_c, l_pipe, l_pool, l_cpus, l_ram, l_end, l_oom,
    l_prio, l_warm, l_timed, hit_p, l_pcpus, l_pram)``, zeros (False)
    where no valid row lands."""
    MC, MP = max_containers, max_pipelines
    dev = valid.device
    sv = torch.where(valid, slot, MC)
    oh_c = sv[:, :, None] == torch.arange(MC, dtype=torch.int32, device=dev)
    hit_c = oh_c.any(1)
    rr_c = first_true(oh_c, 1)

    def land_c(x):
        return torch.where(hit_c, torch.gather(x, 1, rr_c), 0)

    pv = torch.where(valid, pipe, MP)
    oh_p = pv[:, :, None] == torch.arange(MP, dtype=torch.int32, device=dev)
    hit_p = oh_p.any(1)
    rr_p = first_true(oh_p, 1)
    return (
        hit_c,
        land_c(pipe),
        land_c(pool),
        land_c(cpus),
        land_c(ram),
        land_c(end),
        land_c(oom),
        land_c(prio),
        hit_c & torch.gather(warm, 1, rr_c),
        hit_c & torch.gather(timed, 1, rr_c),
        hit_p,
        torch.where(hit_p, torch.gather(cpus, 1, rr_p), 0.0),
        torch.where(hit_p, torch.gather(ram, 1, rr_p), 0.0),
    )


__all__ = ["retire_land_ref", "assign_gather_ref", "first_true"]
