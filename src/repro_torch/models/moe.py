"""Mixture-of-Experts FFN with capacity-based token dispatch (PyTorch).

The port of ``repro.models.moe``: tokens are routed top-k,
assigned a position inside their expert by a cumulative-sum rank over the
token-major ``(T * K)`` assignments, dropped beyond the capacity ``C``
(to the drop slot ``E * C``), gathered into an ``(E, C, d)`` buffer, run
through the experts' SwiGLU FFNs as batched products, and scattered back
weighted by their gates (on a mesh: below).

What decides parity with the reference, mirrored here:

- the router's dtype differs by path: ``moe_forward`` (the decode step's,
  flat tokens) multiplies in float32 with the float32 router;
  ``moe_forward_batched`` (forward and prefill, per batch row) casts the
  router to the activation dtype first. In bfloat16 the two can route the
  same token differently;
- ``jax.lax.top_k`` puts the lower expert index first on ties, and so does
  ``_top_k`` (the first K of a stable descending sort);
- the gate is cast to the activation dtype before the combine.

The decode step's ``moe_forward`` is capturable in a CUDA graph: static
shapes (``C`` follows from the pool's ``max_slots``), no host sync, no
data-dependent indexing. Its ``active`` mask keeps a free slot's token
from taking capacity, where the reference routes every slot (a departure:
ROADMAP.md, Departures).

On a device mesh (``runtime_flags.get_mesh()``, set by
``launch.steps.sharded_step``) a rank holds the router's columns of its
share of the experts (where the model axis divides E; else the whole
router, which then reads x before the copy: ``_router_logits``) and every expert's
share of ``d_ff`` (``w_gate``/``w_up`` on their f columns, ``w_down`` on
its f rows), as the reference's rules place them, and the shared experts
column- then row-parallel. The router's logits are gathered whole before
the top-k (``layers.gather_model_axis``), so every rank routes every token
alike; each rank runs the dispatch -> FFN -> combine block over all E
experts at its share of f (the gates enter it through
``layers.copy_to_model_axis``: they weight partial outputs, so their
gradient is a sum over the ranks), adds its shared experts' partial output, and
one ``all_reduce`` sums the combined output: combine-then-reduce, as the
reference's ``psum`` inside its ``shard_map`` does. In a sharded train
step the load-balance loss takes its two means over the global batch
(``layers.mean_over_batch_axes``); a sharded decode step's data ranks
dispatch their tokens as one global batch (``moe_forward``).
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import runtime_flags
from repro_torch.models.layers import _dense_init

Params = Dict[str, Any]


def init_moe(cfg: ModelConfig, gen: torch.Generator, dtype, device) -> Params:
    """The router (float32 in every model dtype, as in the reference), the
    routed experts stacked over ``E`` and, where the config has them, the
    shared experts as one SwiGLU FFN of ``n_shared_experts * d_ff``."""
    d, m = cfg.d_model, cfg.moe
    p = {
        "router": _dense_init(gen, (d, m.n_experts), torch.float32, device),
        "w_gate": _dense_init(gen, (m.n_experts, d, m.d_ff), dtype, device),
        "w_up": _dense_init(gen, (m.n_experts, d, m.d_ff), dtype, device),
        "w_down": _dense_init(gen, (m.n_experts, m.d_ff, d), dtype, device),
    }
    if m.n_shared_experts:
        f_sh = m.n_shared_experts * m.d_ff
        p["shared"] = {"w_gate": _dense_init(gen, (d, f_sh), dtype, device),
                       "w_up": _dense_init(gen, (d, f_sh), dtype, device),
                       "w_down": _dense_init(gen, (f_sh, d), dtype, device)}
    return p


def expert_capacity(cfg: ModelConfig, n_tokens: int) -> int:
    m = cfg.moe
    c = math.ceil(n_tokens * m.experts_per_token / m.n_experts * m.capacity_factor)
    return max(8, -(-c // 8) * 8)  # round up to a multiple of 8


def _top_k(probs: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k`` over the last axis: the largest ``k`` values, a tie
    broken towards the lower index."""
    values, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return values[..., :k], idx[..., :k]


def _router_logits(cfg: ModelConfig, x: torch.Tensor, xc: torch.Tensor,
                   router: torch.Tensor) -> torch.Tensor:
    """``x @ router`` over all E experts. Where a rank holds only its
    experts' columns, from ``xc`` (``x`` through ``layers.copy_to_model_axis``:
    a rank's x-gradient is then its columns' part, summed over the ranks)
    and gathered over the model axis. Where every rank holds the whole
    router (the model axis does not divide E, or there is no mesh), from
    ``x`` itself: each rank's x-gradient is then the whole one already, and
    the copy's sum would count it once a rank."""
    if router.shape[-1] == cfg.moe.n_experts:
        return x @ router
    return L.gather_model_axis(xc @ router)


def _route(cfg: ModelConfig, logits: torch.Tensor):
    """Router logits (..., E) float32 -> probs, normalized top-k gates and
    their expert indices (..., K)."""
    probs = torch.softmax(logits, dim=-1)
    gate, idx = _top_k(probs, cfg.moe.experts_per_token)
    return probs, gate / gate.sum(-1, keepdim=True), idx


def _lower_ranks_counts(counts: torch.Tensor) -> torch.Tensor:
    """The sum of ``counts`` (E,) over the batch ranks below this one
    (``runtime_flags.get_batch_axes()``, row-major over its axes, the order
    in which ``launch.steps.batch_rows`` hands out the rows): one
    ``all_gather`` a batch axis, innermost first."""
    axes = runtime_flags.get_batch_axes()
    every, index = counts, 0
    for group in reversed(axes.groups):
        parts = [torch.empty_like(every) for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, every.contiguous(), group=group)
        every = torch.stack(parts)
    for group in axes.groups:
        index = index * dist.get_world_size(group) + dist.get_rank(group)
    return every.reshape(-1, counts.shape[-1])[:index].sum(0)


def _dispatch(flat_e: torch.Tensor, E: int, C: int,
              counted: Optional[torch.Tensor] = None, over_batch: bool = False):
    """Each assignment's destination in the ``(E * C + 1)`` buffer and
    whether it is kept. flat_e (..., N) in token-major order; its rank
    inside its expert is a cumulative sum along N (the reference's
    ``cumsum(one_hot) * one_hot``); rank ``C`` or beyond goes to the drop
    slot ``E * C``. ``counted`` (..., N) bool or None: assignments that take
    no capacity (and are not kept) where False. ``over_batch`` (flat_e (N,),
    under batch axes): the ranks count one token-major sequence, this rank's
    tokens after those of the batch ranks below it, so each of its ranks
    starts at the counts they gave its expert."""
    # one-hot (..., E, N): the running count runs along the inner axis,
    # where a scan is one pass per expert (along the outer one it took a
    # quarter of an MoE prefill's device time on the H100)
    oh = (flat_e[..., None, :] == torch.arange(E, device=flat_e.device)[:, None]) \
        .to(torch.int32)
    if counted is not None:
        oh = oh * counted[..., None, :].to(torch.int32)
    pos_in_e = (torch.cumsum(oh, dim=-1) * oh).sum(-2) - 1
    if over_batch:
        pos_in_e = pos_in_e + _lower_ranks_counts(oh.sum(-1))[flat_e]
    keep = pos_in_e < C
    if counted is not None:
        keep = keep & counted
    dest = torch.where(keep, flat_e * C + pos_in_e, torch.full_like(flat_e, E * C))
    return dest, keep


def _experts(p: Params, xe: torch.Tensor) -> torch.Tensor:
    """The routed experts' SwiGLU over their capacity rows: xe (E, R, d) ->
    (E, R, d), the reference's ``ecd,edf->ecf`` products as batched ones."""
    h = F.silu(torch.bmm(xe, p["w_gate"])) * torch.bmm(xe, p["w_up"])
    return torch.bmm(h, p["w_down"])


def _shared(p: Params, x: torch.Tensor) -> torch.Tensor:
    sh = p["shared"]
    return (F.silu(x @ sh["w_gate"]) * (x @ sh["w_up"])) @ sh["w_down"]


def _aux(cfg: ModelConfig, probs: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Switch-style load-balance loss: E * sum(fraction of assignments x
    mean router probability) per expert, times its weight."""
    E = cfg.moe.n_experts
    oh = (idx[..., None] == torch.arange(E, device=idx.device)).float()
    frac_tokens = L.mean_over_batch_axes(oh.reshape(-1, E).mean(0))
    frac_prob = L.mean_over_batch_axes(probs.reshape(-1, E).mean(0))
    return E * torch.sum(frac_tokens * frac_prob) * cfg.moe.router_aux_loss


def moe_forward(cfg: ModelConfig, p: Params, x: torch.Tensor,
                active: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (T, d) -> (y (T, d), aux_load_balance_loss): the decode step's
    dispatch over flat tokens, router logits in float32. ``active`` (T,)
    bool or None: a False row takes no expert capacity and gets only the
    shared experts' output. Under batch axes (a sharded decode step's data
    ranks, each with T tokens) the capacity is the global batch's and each
    rank's tokens take their places after the lower ranks' (``_dispatch``'s
    ``over_batch``), as the reference's one dispatch over the whole batch."""
    T, d = x.shape
    E, K = cfg.moe.n_experts, cfg.moe.experts_per_token
    batch_axes = runtime_flags.get_batch_axes()
    C = expert_capacity(cfg, T * (1 if batch_axes is None else batch_axes.size))
    xc = L.copy_to_model_axis(x)
    probs, gate, idx = _route(cfg, _router_logits(cfg, x.float(), xc.float(), p["router"]))
    x = xc
    flat_e = idx.reshape(-1)                                  # (T*K,)
    counted = None if active is None else \
        active[:, None].expand(T, K).reshape(-1)
    dest, keep = _dispatch(flat_e, E, C, counted, batch_axes is not None)
    tok_id = torch.arange(T, device=x.device)[:, None].expand(T, K).reshape(-1)
    buf_tok = torch.zeros((E * C + 1,), dtype=torch.long, device=x.device) \
        .scatter_(0, dest, tok_id)
    buf_fill = torch.zeros((E * C + 1,), dtype=torch.bool, device=x.device) \
        .scatter_(0, dest, keep)
    xe = (x[buf_tok[:-1]] * buf_fill[:-1, None].to(x.dtype)).reshape(E, C, d)
    out_flat = torch.cat([_experts(p, xe).reshape(E * C, d),
                          x.new_zeros((1, d))], dim=0)
    gate_w = L.copy_to_model_axis((gate.reshape(-1) * keep).to(x.dtype))
    y = (out_flat[dest] * gate_w[:, None]).reshape(T, K, d).sum(1)
    if "shared" in p:
        y = y + _shared(p, x)
    return L.reduce_model_axis(y), _aux(cfg, probs, idx)


def moe_forward_batched(cfg: ModelConfig, p: Params, x: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, d) -> (y (B, S, d), aux): dispatch within each batch row,
    capacity from S, router cast to the activation dtype (the reference's
    ``moe_forward_batched``; forward and prefill)."""
    B, S, d = x.shape
    E, K = cfg.moe.n_experts, cfg.moe.experts_per_token
    C = expert_capacity(cfg, S)
    xc = L.copy_to_model_axis(x)
    probs, gate, idx = _route(cfg, _router_logits(cfg, x, xc, p["router"].to(x.dtype)).float())
    x = xc
    flat_e = idx.reshape(B, S * K)
    dest, keep = _dispatch(flat_e, E, C)
    tok_id = torch.arange(S, device=x.device)[:, None].expand(S, K).reshape(1, -1) \
        .expand(B, S * K)
    buf_tok = torch.zeros((B, E * C + 1), dtype=torch.long, device=x.device) \
        .scatter_(1, dest, tok_id)
    buf_fill = torch.zeros((B, E * C + 1), dtype=torch.bool, device=x.device) \
        .scatter_(1, dest, keep)
    xe = torch.gather(x, 1, buf_tok[:, :-1, None].expand(B, E * C, d))
    xe = xe * buf_fill[:, :-1, None].to(x.dtype)
    # (B, E, C, d) -> the experts' (E, B*C, d) and back
    xe = xe.reshape(B, E, C, d).transpose(0, 1).reshape(E, B * C, d)
    out_e = _experts(p, xe).reshape(E, B, C, d).transpose(0, 1).reshape(B, E * C, d)
    out_flat = torch.cat([out_e, x.new_zeros((B, 1, d))], dim=1)
    y_assign = torch.gather(out_flat, 1, dest[:, :, None].expand(B, S * K, d))
    gate_w = L.copy_to_model_axis((gate.reshape(B, S * K) * keep).to(x.dtype))
    y = (y_assign * gate_w[:, :, None]).reshape(B, S, K, d).sum(2)
    if "shared" in p:
        y = y + _shared(p, x)
    return L.reduce_model_axis(y), _aux(cfg, probs, idx)
