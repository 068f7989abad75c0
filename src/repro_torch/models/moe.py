"""Mixture-of-Experts layer (the port's ``repro.models.moe``): top-k
routing with group-local capacity dispatch, the expert GEMMs through the
grouped entry points of `core.gemm_backend`.

Routing runs per token *group* (the batch rows, as in the JAX package): the
router projection goes through ``gemm_backend.matmul``, each token picks
its ``top_k`` experts, and each (group, expert) pair keeps at most
``capacity`` assignments, ranked in token order; the rest are dropped.  The
kept rows are scattered into a (G, E, C, d) dispatch buffer, the SwiGLU
experts run as one grouped GLU launch and one grouped w_out launch, and the
outputs are gathered back and summed per token, weighted by the gates.

Three places differ in form from the JAX code and not in value:

* ``lax.top_k`` puts the lower expert first among equal probabilities;
  ``torch.topk`` promises no order, so `_top_k` takes the first k of a
  stable descending sort.
* The dispatch writes unique slots with ``scatter`` (the dropped rows,
  all zero, share the overflow row, which is cut off), not an add.
* The combine is a sum over each token's k rows in a fixed order, in the
  input type, where JAX scatter-adds them: on CUDA an ``index_add_`` is
  atomic and its order changes from run to run.

The expert-parallel path (``_moe_shard_map``, with ``_route_local``) waits
for the distributed port, ROADMAP queue 1 item 16.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.core.gemm_backend import grouped_glu_matmul, grouped_matmul, matmul as _bmm
from repro_torch.models.layers import normal_, param

__all__ = ["MoE", "Routing", "route", "moe_forward"]


class MoE(nn.Module):
    """The layer's parameters, in the JAX package's layout: the router (d,
    E) and the expert stacks ``w_in``, ``w_gate`` (E, d, d_ff) and ``w_out``
    (E, d_ff, d)."""

    def __init__(self, d_model: int, d_ff: int, n_experts: int, *, dtype, device):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.router = param((d_model, n_experts), **kw)
        self.w_in = param((n_experts, d_model, d_ff), **kw)
        self.w_gate = param((n_experts, d_model, d_ff), **kw)
        self.w_out = param((n_experts, d_ff, d_model), **kw)

    def init(self, generator: torch.Generator) -> None:
        """normal x 0.02 for every weight (the JAX package's ``moe_init``)."""
        for p in (self.router, self.w_in, self.w_gate, self.w_out):
            normal_(p, generator)


@dataclasses.dataclass
class Routing:
    """One routing decision over (G, Tg) tokens, k assignments each, in the
    JAX package's flattened (G, Tg * k) layout."""

    logits: torch.Tensor  # (G, Tg, E) f32
    probs: torch.Tensor  # (G, Tg, E) f32
    flat_e: torch.Tensor  # (G, Tg*k) int64 expert of each assignment
    flat_g: torch.Tensor  # (G, Tg*k) f32 normalised gate
    keep: torch.Tensor  # (G, Tg*k) bool: within the expert's capacity
    slot: torch.Tensor  # (G, Tg*k) int64 row of the dispatch buffer (E*C: dropped)
    capacity: int


def _top_k(probs: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``lax.top_k``: the k largest values along the last axis, the lower
    index first among equal values."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _positions_in_expert_grouped(flat_e: torch.Tensor, n_experts: int) -> torch.Tensor:
    """Rank of each assignment within its (group, expert), in token order:
    a stable sort by expert, each expert's run numbered from its start."""
    g, n = flat_e.shape
    order = torch.argsort(flat_e, dim=1, stable=True)
    sorted_e = torch.gather(flat_e, 1, order)
    counts = F.one_hot(sorted_e, n_experts).sum(dim=1)  # (G, E)
    starts = torch.cumsum(counts, dim=-1) - counts  # exclusive prefix
    pos_sorted = torch.arange(n, device=flat_e.device)[None, :] - torch.gather(starts, 1, sorted_e)
    return torch.zeros((g, n), dtype=torch.int64, device=flat_e.device).scatter(1, order, pos_sorted)


def route(router: torch.Tensor, xg: torch.Tensor, *, top_k: int, capacity_factor: float) -> Routing:
    """The routing of ``xg`` (G, Tg, d): the router projection through the
    GEMM backend, its f32 softmax, top-k with normalised gates, and each
    assignment's capacity rank and dispatch slot."""
    groups, tg, _ = xg.shape
    e = router.shape[-1]
    logits = _bmm(xg, router).float()
    probs = torch.softmax(logits, dim=-1)
    gate_vals, gate_idx = _top_k(probs, top_k)
    gate_vals = gate_vals / gate_vals.sum(dim=-1, keepdim=True)
    capacity = max(int(math.ceil(tg * top_k * capacity_factor / e)), top_k)
    flat_e = gate_idx.reshape(groups, tg * top_k)
    pos = _positions_in_expert_grouped(flat_e, e)
    keep = pos < capacity
    slot = torch.where(keep, flat_e * capacity + pos, torch.full_like(pos, e * capacity))
    return Routing(logits, probs, flat_e, gate_vals.reshape(groups, tg * top_k), keep, slot, capacity)


def moe_forward(
    moe: MoE,
    x: torch.Tensor,  # (B, S, d)
    *,
    top_k: int,
    capacity_factor: float = 1.25,
    router_z_weight: float = 1e-3,
    aux_weight: float = 1e-2,
    token_groups: Optional[int] = None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(output (B, S, d), aux) of the layer; aux holds the Switch-style
    load-balance loss and the router z-loss (the JAX package's local
    ``moe_forward``)."""
    b, s, d = x.shape
    e = moe.router.shape[-1]
    n_tok = b * s
    groups = token_groups or b
    tg = n_tok // groups
    xg = x.reshape(groups, tg, d)
    r = route(moe.router, xg, top_k=top_k, capacity_factor=capacity_factor)
    cap = r.capacity

    # dispatch: each kept assignment's token row into its own slot; the
    # dropped ones (zeroed) share the overflow row, which is cut off
    rows = xg[:, :, None, :].expand(groups, tg, top_k, d).reshape(groups, tg * top_k, d)
    src = rows * r.keep[..., None].to(x.dtype)
    idx = r.slot[..., None].expand(groups, tg * top_k, d)
    buf = torch.zeros((groups, e * cap + 1, d), dtype=x.dtype, device=x.device).scatter(1, idx, src)
    buf = buf[:, :-1].reshape(groups, e, cap, d)

    # the expert GEMMs: one grouped GLU launch and one grouped w_out launch
    h = grouped_glu_matmul(buf, moe.w_gate, moe.w_in)
    out_buf = grouped_matmul(h, moe.w_out).reshape(groups, e * cap, d)
    out_buf = torch.cat([out_buf, out_buf.new_zeros((groups, 1, d))], dim=1)

    # combine: gather each assignment's row, weight it by its gate, and sum
    # a token's k rows in order
    rows_out = torch.gather(out_buf, 1, idx)
    rows_out = (rows_out * (r.flat_g * r.keep).to(out_buf.dtype)[..., None]).to(x.dtype)
    rows_out = rows_out.reshape(groups, tg, top_k, d)
    out = rows_out[:, :, 0]
    for j in range(1, top_k):
        out = out + rows_out[:, :, j]

    # aux losses (Switch-style load balance + router z), global means
    me = r.probs.reshape(n_tok, e).mean(dim=0)
    routed = (F.one_hot(r.flat_e, e).float() * r.keep.float()[..., None]).sum(dim=(0, 1))
    ce = routed / routed.sum().clamp_min(1.0)
    aux_loss = aux_weight * e * (me * ce).sum()
    z_loss = router_z_weight * torch.logsumexp(r.logits, dim=-1).square().mean()
    return out.reshape(b, s, d), {"moe_aux_loss": aux_loss, "moe_z_loss": z_loss}
