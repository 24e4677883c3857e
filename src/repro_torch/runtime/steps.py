"""Train / serve step factories, generic over the architecture zoo: a port
of ``repro.runtime.steps``.

``model_init`` draws an architecture's parameters (``encdec_init`` for
the audio family, ``lm_init`` for the others) on CUDA unless the caller
asks for the CPU. ``loss_fn`` is ``encdec_loss`` or ``lm_loss``;
``make_train_step`` returns the initial state and one optimizer step
with gradient accumulation over microbatches; ``opt_config`` is the
optimizer an ``ArchSpec`` names (the JAX package's
``launch/lowering.py: opt_config``). ``make_serve_steps`` returns an
architecture's prefill and decode functions.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn
from torch.distributed.tensor import DTensor

from ..models import encdec as ed
from ..models import lm
from ..models.common import ModelConfig
from ..optim.optimizers import OptConfig, OptState, make_optimizer
from ..parallel.ctx import sharding_ctx
from ..parallel.sharding import gathered_params


class TrainState(NamedTuple):
    params: nn.Module           # ``LM`` or ``EncDec``, updated in place by a step
    opt: OptState


def model_init(cfg: ModelConfig, seed: int = 0, *, device="cuda"):
    if cfg.family == "audio":
        return ed.encdec_init(cfg, seed, device=device)
    return lm.lm_init(cfg, seed, device=device)


def loss_fn(cfg: ModelConfig, params, batch, vocab_chunk: int = 512):
    if cfg.family == "audio":
        return ed.encdec_loss(cfg, params, batch)
    return lm.lm_loss(cfg, params, batch, vocab_chunk=vocab_chunk)


def opt_config(arch) -> OptConfig:
    """The optimizer of an ``ArchSpec``: its name and state dtype, the
    other settings ``OptConfig``'s defaults."""
    return OptConfig(name=arch.optimizer,
                     state_dtype=torch.bfloat16 if arch.opt_state_dtype == "bfloat16"
                     else torch.float32)


def stacked_leaves(cfg: ModelConfig, names) -> dict:
    """``{leaf: (names, stacked)}``: the port's parameter names grouped as
    the JAX package's parameter tree holds them. Layer ``L < n_periods *
    period`` of an LM is slice ``L // period`` of the leaf
    ``stack.periods.<L % period>.<rest>``; a tail layer ``stack.tail.<t>.
    <rest>`` stands alone; the encoder-decoder's layers ``i`` are slices of
    ``enc.<rest>`` / ``dec.<rest>``; other parameters are leaves of their
    own. ``names`` in layer order keeps each leaf's members in stacking
    order."""
    groups: dict = {}
    base = cfg.n_periods * cfg.period
    for name in names:
        parts = name.split(".")
        if parts[0] == "layers":
            layer, rest = int(parts[1]), ".".join(parts[2:])
            if layer < base:
                key, stacked = f"stack.periods.{layer % cfg.period}.{rest}", True
            else:
                key, stacked = f"stack.tail.{layer - base}.{rest}", False
        elif parts[0] in ("enc", "dec"):
            key, stacked = f"{parts[0]}.{'.'.join(parts[2:])}", True
        else:
            key, stacked = name, False
        groups.setdefault(key, ([], stacked))[0].append(name)
    return groups


def make_train_step(cfg: ModelConfig, opt_cfg: OptConfig, microbatches: int = 1, *,
                    device="cuda", mesh=None, rules=None):
    """Returns (init_fn(seed) -> TrainState, step_fn(state, batch) ->
    (state, metrics)). The JAX package's ``init_fn`` also returns the
    parameters' sharding axes; the port's are ``models.axes.model_axes``.

    ``step_fn`` takes the gradient of ``loss_fn`` and applies the
    optimizer to the parameters in place; ``metrics`` holds ``loss``,
    ``grad_norm`` (before clipping) and ``step`` as scalar tensors. With
    ``microbatches = M > 1`` the batch is split along axis 0 into M
    parts; each part's gradients (in the parameters' dtype, from
    ``torch.autograd.grad``) are added into f32 accumulators in order,
    as the JAX package's scan adds them into its f32 ``g0``, and the
    sums and the losses' sum are divided by M.

    With a ``mesh`` (and the ``ShardingRules`` of the architecture) the
    state holds DTensors (``runtime.train_loop``) and the batch is
    sharded over the batch axes: the step runs under the sharding
    context of ``rules.act``, each parameter sharded over a data axis
    gathered whole for the compute (``parallel.sharding.
    gathered_params``: FSDP), its gradient reduced back onto its shards
    and the optimizer applied to each rank's shards. The metrics are
    plain tensors, the same on every rank.
    """
    opt_init, opt_update = make_optimizer(opt_cfg)

    def init_fn(seed: int = 0) -> TrainState:
        params = model_init(cfg, seed, device=device)
        named = dict(params.named_parameters())
        return TrainState(params=params, opt=opt_init(opt_cfg, named, stacked_leaves(cfg, named)))

    def step_fn(state: TrainState, batch: dict):
        if mesh is None:
            return _step(state, batch)
        with sharding_ctx(mesh, rules.act):
            state, metrics = _step(state, batch)
        return state, {k: v.full_tensor() if isinstance(v, DTensor) else v
                       for k, v in metrics.items()}

    def _step(state: TrainState, batch: dict):
        named = dict(state.params.named_parameters())
        leaves = list(named.values())

        def grads_of(b):
            # the backward's recomputation reads the gathered parameters too
            with gathered_params(state.params):
                loss = loss_fn(cfg, state.params, b)
                g = torch.autograd.grad(loss, leaves, allow_unused=True)
            # a parameter the batch does not reach (a frontend without
            # embeddings) has a zero gradient, as in the JAX package
            return loss.detach(), [torch.zeros_like(p) if gi is None else gi
                                   for p, gi in zip(leaves, g)]

        if microbatches > 1:
            parts = {k: torch.chunk(v, microbatches, dim=0) for k, v in batch.items()}
            if any(len(p) != microbatches or p[0].shape[0] * microbatches != batch[k].shape[0]
                   for k, p in parts.items()):
                raise ValueError(f"the batch does not split into {microbatches} equal microbatches")
            loss_sum = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
            g_sum = [torch.zeros_like(p, dtype=torch.float32) for p in leaves]
            for i in range(microbatches):
                loss, g = grads_of({k: p[i] for k, p in parts.items()})
                for acc, gi in zip(g_sum, g):
                    acc.add_(gi.to(torch.float32))
                del g
                loss_sum = loss_sum + loss
            loss = loss_sum / microbatches
            for acc in g_sum:
                acc.div_(microbatches)
            grads = g_sum
        else:
            loss, grads = grads_of(batch)
        opt, gnorm = opt_update(opt_cfg, dict(zip(named, grads)), state.opt, named,
                                stacked_leaves(cfg, named))
        return TrainState(params=state.params, opt=opt), {
            "loss": loss, "grad_norm": gnorm, "step": opt.step}

    return init_fn, step_fn


def make_serve_steps(cfg: ModelConfig):
    """Returns (prefill_fn(params, batch, max_len), decode_fn(params,
    caches, token, pos)) for the architecture."""
    if cfg.family == "audio":
        def prefill(params, batch, max_len):
            return ed.encdec_prefill(cfg, params, batch, max_dec=max_len)

        def decode(params, caches, token, pos):
            return ed.encdec_decode_step(cfg, params, caches, token, pos)
    else:
        def prefill(params, batch, max_len):
            return lm.lm_prefill(cfg, params, batch, max_len=max_len)

        def decode(params, caches, token, pos):
            return lm.lm_decode_step(cfg, params, caches, token, pos)

    return prefill, decode


def init_serve_caches(cfg: ModelConfig, batch: int, max_len: int, device):
    if cfg.family == "audio":
        raise NotImplementedError(
            "whisper caches come from encdec_prefill (they embed cross-KV)"
        )
    return lm.init_caches(cfg, batch, max_len, device)


__all__ = [
    "TrainState",
    "init_serve_caches",
    "loss_fn",
    "make_serve_steps",
    "make_train_step",
    "model_init",
    "opt_config",
    "stacked_leaves",
]
