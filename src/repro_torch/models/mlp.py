"""Feed-forward blocks: dense SwiGLU (or non-gated GELU) and
Mixture-of-Experts, a port of ``repro.models.mlp``.

The MoE routes each token to its top-k experts and dispatches with a
sort and a gather under a static per-expert capacity, as the JAX package
does; pairs past an expert's capacity are dropped (they add nothing).
Two dispatches, picked by the number of routed pairs as in the JAX
package:

* per row (``S * K >= E``, prefill): capacity per sequence
  ``C = min(max(8, int(cf * S * K / E)), S * K)``;
* global (``S * K < E``, decode): over all ``B * S`` tokens, capacity
  ``C = max(1, min(int(cf * T * K / E) + 1, T))``. At jamba's width and
  4 decode slots that is one pair per expert, so when two slots pick
  the same expert one pair is dropped and a token's output depends on
  the other slots' routing (ROADMAP queue 3); the port keeps the same
  capacity so that tokens agree with the JAX package.

The expert products are batched matrix products (``torch.einsum``),
the sort ``torch.sort(stable=True)`` and the combine ``index_add_``
(at most ``K`` contributions reach a token, so the sum is exact in any
order). ``route`` also returns the auxiliary load-balance loss, which
``lm_loss`` adds in training.

Under a sharding context (``parallel.ctx``) with the batch over the
mesh's batch axes, the per-row dispatch runs as the JAX package's
``_batch_local_gather`` / ``_batch_local_combine`` do, in one
``local_map``: each rank routes, sorts, gathers and combines its own
rows (no token crosses a data shard), its slice of the experts when they
divide over ``"model"``, and hands back its partial combine as a
``Partial`` placement over ``"model"``, summed by the next
redistribution. At most K <= 2 pairs reach a token and every other
shard adds zeros, so the sharded result equals the plain one bit for
bit. The load-balance means come back as ``Partial`` sums of each
rank's means weighted by its share of the rows (exact on one rank). The
global dispatch (decode) runs on gathered tokens and weights.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..parallel.ctx import (
    batch_axes_in_mesh, constrain, get_ctx, is_dtensor, kernel_placements, model_size,
)
from .common import ModelConfig, dense_init


# ---------------------------------------------------------------------------
# dense SwiGLU
# ---------------------------------------------------------------------------
def mlp_init(cfg: ModelConfig, gen: torch.Generator, d_ff: int | None = None) -> dict:
    d = cfg.d_model
    f = d_ff or cfg.d_ff
    dt = cfg.param_dtype
    p = {}
    if cfg.mlp_type == "swiglu":
        p["w_gate"] = dense_init(gen, (d, f), d, dt)
    p["w_up"] = dense_init(gen, (d, f), d, dt)
    p["w_down"] = dense_init(gen, (f, d), f, dt)
    return p


def mlp_apply(p, x: torch.Tensor) -> torch.Tensor:
    u = torch.einsum("bsd,df->bsf", x, p["w_up"])
    if "w_gate" in p:
        g = torch.einsum("bsd,df->bsf", x, p["w_gate"])
        h = F.silu(g.to(torch.float32)).to(x.dtype) * u
    else:  # jax.nn.gelu's default is the tanh approximation
        h = F.gelu(u.to(torch.float32), approximate="tanh").to(x.dtype)
    h = constrain(h, "batch seq ff")
    return constrain(torch.einsum("bsf,fd->bsd", h, p["w_down"]), "batch seq embed")


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------
def _experts_init(gen: torch.Generator, E: int, shape, fan_in: int, dtype) -> torch.Tensor:
    """[E, *shape] drawn expert by expert: one f32 draw of a whole expert
    tensor at jamba's width would be 12.9 GB."""
    out = torch.empty((E, *shape), dtype=dtype, device=gen.device)
    if out.device.type == "meta":      # shapes alone: nothing to draw
        return out
    for e in range(E):
        out[e] = dense_init(gen, shape, fan_in, dtype)
    return out


def moe_init(cfg: ModelConfig, gen: torch.Generator) -> dict:
    d = cfg.d_model
    m = cfg.moe
    f = m.expert_ff or cfg.d_ff
    dt = cfg.param_dtype
    p = {
        "router": dense_init(gen, (d, m.n_experts), d, torch.float32),
        "we_gate": _experts_init(gen, m.n_experts, (d, f), d, dt),
        "we_up": _experts_init(gen, m.n_experts, (d, f), d, dt),
        "we_down": _experts_init(gen, m.n_experts, (f, d), f, dt),
    }
    if m.shared_expert_ff:
        p["shared"] = mlp_init(cfg, gen, d_ff=m.shared_expert_ff)
    return p


def route(cfg: ModelConfig, p, x: torch.Tensor):
    """Router of ``x`` [..., d]: the top-k experts [..., K] (best first),
    their gates renormalised over the k, from f32 logits, and the
    load-balance term over every token of ``x`` (an f32 scalar)."""
    gate_k, expert_k, f, pm = _route_parts(cfg, p, x)
    return gate_k, expert_k, cfg.moe.n_experts * torch.sum(f * pm)


def _route_parts(cfg: ModelConfig, p, x: torch.Tensor):
    """``route``'s experts and gates, and the two means of its
    load-balance term: the share of tokens whose first choice is each
    expert, and each expert's mean gate."""
    E = cfg.moe.n_experts
    logits = torch.einsum("...d,de->...e", x.to(torch.float32), p["router"])
    gates = torch.softmax(logits, dim=-1)
    gate_k, expert_k = torch.topk(gates, cfg.moe.top_k, dim=-1)
    gate_k = gate_k / torch.clamp_min(torch.sum(gate_k, dim=-1, keepdim=True), 1e-9)
    tokens = tuple(range(gates.dim() - 1))
    f = torch.mean(F.one_hot(expert_k[..., 0], E).to(torch.float32), dim=tokens)
    return gate_k, expert_k, f, torch.mean(gates, dim=tokens)


def _dispatch(flat_e, flat_t, flat_g, E: int, C: int, empty: int):
    """Sort the routed pairs of one row by expert (stably), keep the first
    ``C`` of each expert, and return the token table [E*C] (``empty``
    where a slot holds no pair) and the gate table [E*C] f32."""
    se, order = torch.sort(flat_e, stable=True)
    stok, sg = flat_t[order], flat_g[order]
    pos = torch.arange(se.shape[-1], device=se.device) - torch.searchsorted(se, se, side="left")
    keep = pos < C
    slot = torch.where(keep, se * C + pos, E * C)     # dropped pairs go to slot E*C
    tok = torch.full((E * C + 1,), empty, dtype=torch.int64, device=se.device)
    gate = torch.zeros((E * C + 1,), dtype=torch.float32, device=se.device)
    tok.scatter_(0, slot, stok)
    gate.scatter_(0, slot, torch.where(keep, sg, 0.0))
    return tok[:E * C], gate[:E * C]


def _experts(p, xe: torch.Tensor, gate_table: torch.Tensor, dtype) -> torch.Tensor:
    """SwiGLU of every expert on its slots: xe [..., E, C, d] -> [..., E,
    C, d], each slot scaled by its gate."""
    g = torch.einsum("...ecd,edf->...ecf", xe, p["we_gate"])
    u = torch.einsum("...ecd,edf->...ecf", xe, p["we_up"])
    h = F.silu(g.to(torch.float32)).to(dtype) * u
    ye = torch.einsum("...ecf,efd->...ecd", h, p["we_down"])
    return ye * gate_table[..., None].to(ye.dtype)


def moe_apply(cfg: ModelConfig, p, x: torch.Tensor):
    """x [B, S, d] -> (out [B, S, d], aux): per-row dispatch with capacity
    per sequence (the global dispatch when ``S * K < E``)."""
    B, S, d = x.shape
    m = cfg.moe
    E, K = m.n_experts, m.top_k
    SK = S * K
    if get_ctx() is not None and is_dtensor(x):
        out, aux = (_moe_global_sharded if SK < E else _moe_rows_sharded)(cfg, p, x)
    elif SK < E:
        return _moe_apply_global(cfg, p, x)
    else:
        out, f, pm = _moe_rows(cfg, p, x, 0, E)
        out, aux = out[:, :S], E * torch.sum(f * pm)
    if "shared" in p:
        out = out + mlp_apply(p["shared"], x)
    return out, aux


def _moe_rows(cfg: ModelConfig, p, x: torch.Tensor, e0: int, n_exp: int, share: float = 1.0):
    """The per-row dispatch of ``x`` [B, S, d] through experts ``e0`` ..
    ``e0 + n_exp - 1`` (``p``'s expert weights are those experts'):
    (their combine [B, S+1, d], row S the empty slots'; the two means of
    the load-balance term, each times ``share``)."""
    B, S, d = x.shape
    m = cfg.moe
    E, K = m.n_experts, m.top_k
    SK = S * K
    gate_k, expert_k, f, pm = _route_parts(cfg, p, x)   # [B, S, K]
    C = max(8, int(m.capacity_factor * SK / E))
    C = min(C, SK)
    tok_ix = torch.arange(S, device=x.device).repeat_interleave(K)      # [SK]
    tables = [_dispatch(expert_k[b].reshape(SK), tok_ix, gate_k[b].reshape(SK), E, C, S)
              for b in range(B)]
    cols = slice(e0 * C, (e0 + n_exp) * C)
    tok_table = torch.stack([t[cols] for t, _ in tables])               # [B, n_exp*C]
    gate_table = torch.stack([g[cols] for _, g in tables])

    x_pad = torch.cat([x, torch.zeros((B, 1, d), dtype=x.dtype, device=x.device)], dim=1)
    xe = torch.gather(x_pad, 1, tok_table[..., None].expand(B, n_exp * C, d))
    ye = _experts(p, xe.reshape(B, n_exp, C, d), gate_table.reshape(B, n_exp, C), x.dtype)
    # combine: per-row scatter-add back to the tokens (row S collects
    # the empty slots and is cut away)
    rows = torch.arange(B, device=x.device)[:, None] * (S + 1)
    out = torch.zeros((B * (S + 1), d), dtype=ye.dtype, device=x.device)
    out.index_add_(0, (rows + tok_table).reshape(-1), ye.reshape(B * n_exp * C, d))
    if share != 1.0:
        f, pm = f * share, pm * share
    return out.reshape(B, S + 1, d), f, pm


_EXPERT_WEIGHTS = ("we_gate", "we_up", "we_down")


def _moe_rows_sharded(cfg: ModelConfig, p, x):
    """``_moe_rows`` on each rank's batch rows and, where the experts
    divide over ``"model"``, its slice of them (the JAX package's
    ``_batch_local_gather`` / ``_batch_local_combine``)."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh, _ = get_ctx()
    B, S, _ = x.shape
    E = cfg.moe.n_experts
    names = list(mesh.mesh_dim_names)
    ep = "model" in names and E % model_size() == 0
    batch_axes = batch_axes_in_mesh(B) or ()
    x_pl = kernel_placements(3, 0, None, B, False)
    whole = [Replicate()] * mesh.ndim
    w_pl = [Shard(0) if ep and n == "model" else Replicate() for n in names]
    out_pl = [Partial() if ep and n == "model" else pl for n, pl in zip(names, x_pl)]
    mean_pl = [Partial() if n in batch_axes else Replicate() for n in names]

    def local(x_l, router, *experts):
        n_exp = experts[0].shape[0]
        e0 = mesh.get_local_rank("model") * n_exp if ep else 0
        return _moe_rows(cfg, {"router": router, **dict(zip(_EXPERT_WEIGHTS, experts))},
                         x_l, e0, n_exp, share=x_l.shape[0] / B)

    mapped = local_map(local, out_placements=(out_pl, mean_pl, mean_pl),
                       in_placements=(x_pl, whole, w_pl, w_pl, w_pl), device_mesh=mesh,
                       redistribute_inputs=True)
    out, f, pm = mapped(x, p["router"], *(p[n] for n in _EXPERT_WEIGHTS))
    out = out.redistribute(mesh, x_pl)[:, :S]       # the partial combines summed
    return out, E * torch.sum(f * pm)


def _moe_global_sharded(cfg: ModelConfig, p, x):
    """The global dispatch on the whole (gathered) tokens and weights,
    replicated on every rank."""
    from torch.distributed.tensor import Replicate
    from torch.distributed.tensor.experimental import local_map

    mesh, _ = get_ctx()
    whole = [Replicate()] * mesh.ndim
    plain = {k: p[k] for k in ("router", *_EXPERT_WEIGHTS)}
    mapped = local_map(lambda x_l, *w: _moe_apply_global(cfg, dict(zip(plain, w)), x_l),
                       out_placements=(whole, whole), in_placements=(whole,) * 5,
                       device_mesh=mesh, redistribute_inputs=True)
    return mapped(x, *plain.values())


def _moe_apply_global(cfg: ModelConfig, p, x: torch.Tensor) -> torch.Tensor:
    """Dispatch over all ``B * S`` tokens at once: the decode path
    (``S * K < E``), where per-row capacity would be pure padding."""
    B, S, d = x.shape
    m = cfg.moe
    E, K = m.n_experts, m.top_k
    T = B * S
    xt = x.reshape(T, d)
    gate_k, expert_k, aux = route(cfg, p, xt)         # [T, K]
    C = max(1, min(int(m.capacity_factor * T * K / E) + 1, T))
    flat_t = torch.arange(T, device=x.device).repeat_interleave(K)
    tok_table, gate_table = _dispatch(expert_k.reshape(-1), flat_t, gate_k.reshape(-1), E, C, T)

    xt_pad = torch.cat([xt, torch.zeros((1, d), dtype=x.dtype, device=x.device)], dim=0)
    xe = xt_pad[tok_table].reshape(E, C, d)
    ye = _experts(p, xe, gate_table.reshape(E, C), x.dtype)            # [E, C, d]
    out = torch.zeros((T + 1, d), dtype=ye.dtype, device=x.device)
    out.index_add_(0, tok_table, ye.reshape(E * C, d))
    out = out[:T].reshape(B, S, d)
    if "shared" in p:
        out = out + mlp_apply(p["shared"], x)
    return out, aux


__all__ = ["mlp_apply", "mlp_init", "moe_apply", "moe_init", "route"]
