"""Shared building blocks of the ported model families (PyTorch).

The port of the dense subset of ``repro.models.layers`` (the Mamba2 block
is in ``ssm.py``): parameters are
nested dicts of tensors created by ``init_*`` functions and consumed by the
matching forward functions, with the reference's layouts at every public
function.

Conventions:
- activations compute in the parameter dtype; softmax / norms in float32.
- full-sequence attention goes through ``ops.flash_prefill`` and one-token
  decode attention through ``ops.paged_attention`` over a page pool
  ``(num_pages, page, Hkv, D)`` per layer. On CUDA tensors both are the
  hand-written kernels; on CPU tensors their plain PyTorch versions.
- a sliding window (``cfg.sliding_window``) and a bidirectional prefix
  (``prefix_len``, the VLM's vision tokens) are masks of both kernels. A
  windowed model's pool is a ring, as the reference's cache is (``slot = pos
  % S``), at page granularity: a row's ``P`` pages hold position ``q`` at
  ring page ``(q // page) mod P``, offset ``q mod page``, so that the pool
  holds a row's last ``P * page`` positions and a decode step's state stays
  O(window) at any position. A decode step reads them through a rotated
  view of ``P + 1`` block-table entries (``decode_plan``, ``ring_view``),
  oldest page first, in which they lie in order, and attends over the last
  ``min(window, P * page)`` of them: the kernel's ``[starts, lengths)`` in
  the view's positions. A prefill of a longer prompt keeps its last
  positions on the ring (``held_positions``), as the reference's
  ``fit_cache`` keeps its last ``S``.
- under a mesh (``runtime_flags.get_mesh()``, set by
  ``launch.steps.sharded_step``) a rank holds its shards of the heads, the
  KV heads, ``d_ff`` and the vocabulary; the row-parallel products (the
  attention's ``wo``, the FFN's ``w_down``: ``row_parallel``, whose
  half-precision partials stay in float32 until the sum) and the
  vocabulary-sharded ``embed`` and ``unembed`` sum over the model axis with
  one ``all_reduce`` each (``reduce_model_axis``), and a replicated activation
  enters each column-parallel product (``wq``/``wk``/``wv``,
  ``w_gate``/``w_up``, the sharded head) through ``copy_to_model_axis``.
  The two are Megatron's conjugate pair of autograd functions: the
  reduction's backward is the identity, the copy's an ``all_reduce`` of
  the rank's partial gradient, so that every rank's gradient of the
  residual stream is the whole one. With no mesh nothing is reduced and
  nothing is added to the graph.
- cross-attention (``kv_x``, the audio family's decoder over its encoder
  states) goes through ``ops.flash_prefill`` without a causal mask, and in
  the decode step through ``ops.paged_attention`` over a fixed pool of the
  encoder's K/V (``cross_attention_decode``); under a mesh each rank's pool
  holds its KV heads' rows, which its share of ``wk``/``wv`` projected from
  the whole encoder output, and ``wo`` sums over the model axis.
- where the model axis splits the heads (a ``RankConfig`` with ``q_cols``:
  ``launch.steps.splits_heads``), a rank holds the reference's column
  blocks of ``wq``/``wk``/``wv``, cut mid-head where the axis does not
  divide the heads, and the matching rows of ``wo``. It gathers q, k and v
  whole (``gather_columns``: one ``all_gather`` of the three, float32 for
  half precision, rounded once; backward, one ``all_reduce`` of their
  gradients, of which it keeps its own columns; a cross-attention gathers
  q from the decoder's rows and k and v from the encoder's, in two). A
  prefill or a train step runs ``ops.flash_prefill`` over the query heads
  its ``wo`` rows overlap (``split_head_block``), with the window where
  there is one, and keeps its own columns of their output. Its KV pool
  holds every KV head at its round-robin pages of each row
  (``launch.shardings.seq_place``; a windowed pool's ring too, its ``L``
  local pages a ring of their own): a decode step writes the new token's
  K/V on the rank that owns the position only, runs ``ops.paged_attention``
  over every head and the rank's positions (within the window: the rank's
  ``starts``, in its own rotated view) into a float32 partial with its
  log-sum-exp (``-inf`` on a rank that holds no position of the window),
  and the ranks merge the
  partials (``merge_model_axis``: one ``all_gather`` of each rank's
  partial and log-sum-exp, weighed by ``exp(lse - max lse)`` on every
  rank), rounded once. An audio model's cross pool of ``enc_seq`` encoder
  positions takes the same round-robin pages (where the reference cuts
  ``head_dim``: ROADMAP.md, Departures), and its decode step's
  cross-attention is merged alike.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.distributed as dist
import torch.utils.checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.launch import shardings as sh
from repro_torch.models import runtime_flags

Params = Dict[str, Any]

# ---------------------------------------------------------------- utilities


def _dense_init(gen: torch.Generator, shape, dtype, device,
                scale: Optional[float] = None) -> torch.Tensor:
    """Normal(0, scale) drawn in float32 on ``device`` and cast to ``dtype``;
    scaled in place, so a draw holds one float32 copy at a time."""
    fan_in = shape[0]
    scale = scale if scale is not None else 1.0 / math.sqrt(fan_in)
    w = torch.randn(shape, generator=gen, device=device, dtype=torch.float32)
    return w.mul_(scale).to(dtype)


def stack_into(stacked: Params, layer: Params, index: int, n_layers: int) -> None:
    """Write one layer's parameters into slot ``index`` of the tensors
    stacked over ``n_layers`` (created at the first layer, in each
    parameter's own dtype)."""
    for name, value in layer.items():
        if isinstance(value, dict):
            stack_into(stacked.setdefault(name, {}), value, index, n_layers)
            continue
        if name not in stacked:
            stacked[name] = torch.empty((n_layers,) + tuple(value.shape),
                                        dtype=value.dtype, device=value.device)
        stacked[name][index] = value


def layer_params(stacked: Params, index: int) -> Params:
    """Views of layer ``index`` of the stacked parameters."""
    return {name: layer_params(v, index) if isinstance(v, dict) else v[index]
            for name, v in stacked.items()}


def maybe_remat(fn, remat: bool, *args):
    """``fn(*args)``; with ``remat``, through ``torch.utils.checkpoint``
    (non-reentrant), which keeps none of ``fn``'s activations and runs it
    again in the backward pass: the counterpart of the reference's
    ``jax.checkpoint`` of a layer."""
    if not remat:
        return fn(*args)
    return torch.utils.checkpoint.checkpoint(fn, *args, use_reentrant=False)


def rms_norm(x: torch.Tensor, w: Optional[torch.Tensor], eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    y = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    if w is not None:
        y = y * w.float()
    return y.to(x.dtype)


def layer_norm(x: torch.Tensor, w: Optional[torch.Tensor], b: Optional[torch.Tensor],
               eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean(torch.square(xf - mu), dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    if w is not None:
        y = y * w.float()
    if b is not None:
        y = y + b.float()
    return y.to(x.dtype)


def init_norm(cfg: ModelConfig, dtype, device) -> Params:
    if cfg.norm == "rmsnorm":
        return {"w": torch.ones((cfg.d_model,), dtype=dtype, device=device)}
    if cfg.norm == "layernorm":
        return {"w": torch.ones((cfg.d_model,), dtype=dtype, device=device),
                "b": torch.zeros((cfg.d_model,), dtype=dtype, device=device)}
    return {}  # nonparametric (OLMo-style)


def apply_norm(cfg: ModelConfig, p: Params, x: torch.Tensor) -> torch.Tensor:
    if cfg.norm == "rmsnorm":
        return rms_norm(x, p["w"])
    if cfg.norm == "layernorm":
        return layer_norm(x, p["w"], p["b"])
    return layer_norm(x, None, None)  # nonparametric LN


def all_reduce_sum(x: torch.Tensor, groups, scale: float = 1.0) -> torch.Tensor:
    """The sum of ``x`` over ``groups`` one after the other, times
    ``scale``, in float32 (float64 for float64 ``x``) and cast back, as an
    unsharded product accumulates; out of place: ``x`` is never written."""
    total = x.to(torch.promote_types(x.dtype, torch.float32), copy=True)
    for group in groups:
        dist.all_reduce(total, group=group)
    if scale != 1.0:
        total = total * scale
    return total.to(x.dtype)


class _ReduceForward(torch.autograd.Function):
    """``all_reduce_sum`` forward, the identity backward: each rank's partial
    sum feeds a result every rank holds whole, so the gradient of each
    partial is the result's gradient."""

    @staticmethod
    def forward(ctx, x, groups, scale):
        return all_reduce_sum(x, groups, scale)

    @staticmethod
    def backward(ctx, grad):
        return grad, None, None


class _ReduceBackward(torch.autograd.Function):
    """The identity forward, ``all_reduce_sum`` backward: a replicated input
    that each rank feeds into its shard of a product gets the sum of the
    ranks' partial gradients."""

    @staticmethod
    def forward(ctx, x, groups):
        ctx.groups = groups
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce_sum(grad, ctx.groups), None


def reduce_model_axis(x: torch.Tensor) -> torch.Tensor:
    """The sum of ``x`` over the ambient model axis (one ``all_reduce``),
    reduced in float32 and cast back, as an unsharded product accumulates;
    its backward passes the gradient through. ``x`` itself with no mesh."""
    axis = runtime_flags.get_mesh()
    if axis is None:
        return x
    return _ReduceForward.apply(x, (axis.group,), 1.0)


def row_parallel(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` for a weight whose rows the model axis cuts (``wo``,
    ``w_down``, ``w_out``), summed over the axis (``reduce_model_axis``). A
    half-precision rank keeps its partial product in float32 through the
    ``all_reduce`` and rounds the sum to ``x``'s dtype once, as an unsharded
    product rounds its one float32 sum once. ``x @ w`` itself with no mesh."""
    if runtime_flags.get_mesh() is None:
        return x @ w
    if x.dtype in (torch.float32, torch.float64):
        return reduce_model_axis(x @ w)
    return reduce_model_axis(_matmul_float32(x, w)).to(x.dtype)


def _matmul_float32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` (w 2-D) of half-precision operands with its float32 sums
    unrounded: one cuBLAS product with a float32 output on the card, which
    has no gradient; the operands cast up where a gradient is wanted and off
    the card."""
    if x.is_cuda and not (torch.is_grad_enabled() and (x.requires_grad or w.requires_grad)):
        out = torch.mm(x.reshape(-1, x.shape[-1]), w, out_dtype=torch.float32)
        return out.reshape(*x.shape[:-1], w.shape[-1])
    return x.float() @ w.float()


def copy_to_model_axis(x: torch.Tensor) -> torch.Tensor:
    """``x`` (replicated over the ambient model axis) as the input of a
    column-parallel product: the identity forward, and a sum of the ranks'
    gradients over the axis backward. ``x`` itself with no mesh."""
    axis = runtime_flags.get_mesh()
    if axis is None:
        return x
    return _ReduceBackward.apply(x, (axis.group,))


def sum_model_axis(x: torch.Tensor) -> torch.Tensor:
    """The sum of ``x`` over the ambient model axis, for a statistic that
    each rank sums from its shard and then applies to its shard (the Mamba2
    block's gated norm over its ``d_inner``): an ``all_reduce`` forward and
    backward, since each rank's loss reaches the statistic through its own
    shard only, so that its gradient too is a sum of the ranks' partials
    (``copy_to_model_axis`` of ``reduce_model_axis``). ``x`` itself with no
    mesh."""
    return copy_to_model_axis(reduce_model_axis(x))


def mean_over_batch_axes(x: torch.Tensor) -> torch.Tensor:
    """The mean of ``x`` over the batch axes of a sharded train step
    (``runtime_flags.get_batch_axes()``): each rank's statistic of its rows
    made the global batch's. Its backward passes the gradient through, so
    that averaging the ranks' gradients gives the global statistic's.
    ``x`` itself outside a sharded train step."""
    axes = runtime_flags.get_batch_axes()
    if axes is None:
        return x
    return _ReduceForward.apply(x, axes.groups, 1.0 / axes.size)


# ---------------------------------------------------------------- split heads


def split_heads(cfg: ModelConfig) -> bool:
    """Whether ``cfg`` is a rank's config whose model axis splits the heads
    (``launch.steps.local_config``; the module docstring)."""
    return bool(getattr(cfg, "q_cols", 0))


def seq_rank(cfg: ModelConfig) -> Tuple[int, int]:
    """``(r, m)``: this rank's coordinate on the ambient model axis and the
    number of ranks a split-heads config's KV pool is sharded over."""
    axis = runtime_flags.get_mesh()
    if axis is None or axis.size != cfg.kv_shards:
        raise RuntimeError(f"{cfg.name}: a rank's config of split heads runs only "
                           f"inside a sharded step on a model axis of {cfg.kv_shards}")
    return axis.rank, axis.size


class _GatherColumns(torch.autograd.Function):
    """Forward, each rank's products packed side by side (``part``, blocks of
    ``widths`` columns) gathered over the model ``axis`` in one
    ``all_gather`` and returned whole, one tensor a block. Backward, the
    whole tensors' gradients summed over the axis (one ``all_reduce`` in
    float32), of which the rank keeps its own column blocks: each rank's
    attention backward gives only the part of a head's gradient that flows
    through its own rows of ``wo``, so a head (or a KV head) that several
    ranks read gets the sum of their parts. The sum is the reduce-scatter
    it could be (ROADMAP.md, Queue B item 7), as the ZeRO-1 step's
    ``all_reduce`` and slice are."""

    @staticmethod
    def forward(ctx, part, widths, axis):
        ctx.widths, ctx.axis = widths, axis
        parts = [torch.empty_like(part) for _ in range(axis.size)]
        dist.all_gather(parts, part.contiguous(), group=axis.group)
        return tuple(torch.cat(cols, -1) for cols in
                     zip(*(p.split(widths, -1) for p in parts)))

    @staticmethod
    def backward(ctx, *grads):
        axis = ctx.axis
        whole = all_reduce_sum(torch.cat(grads, -1), (axis.group,))
        own, start = [], 0
        for width in ctx.widths:
            own.append(whole[..., start + axis.rank * width:start + (axis.rank + 1) * width])
            start += width * axis.size
        return torch.cat(own, -1), None, None


def gather_columns(x: torch.Tensor, *ws: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """``x @ W`` whole for each ``W`` of which each rank of the ambient model
    axis holds its block ``w`` of columns in rank order: the rank's
    products, packed side by side and gathered over the axis in one
    ``all_gather``. A half-precision product is gathered in float32 and
    rounded once, as the unsharded product rounds its float32 sum once.
    Its gradient is ``_GatherColumns``': the gathered products' gradients
    summed over the axis, each rank's own columns of it, so that ``x``'s
    ``copy_to_model_axis`` then sums the ranks' partial gradients of ``x``."""
    axis = runtime_flags.get_mesh()
    wide = x.dtype in (torch.float32, torch.float64)
    part = torch.cat([x @ w if wide else _matmul_float32(x, w) for w in ws], -1)
    return tuple(t.to(x.dtype) for t in
                 _GatherColumns.apply(part, tuple(w.shape[-1] for w in ws), axis))


def split_head_block(cfg: ModelConfig, r: int) -> Tuple[int, int, int]:
    """``(h0, h1, offset)``: the query heads ``[h0, h1)`` whose columns rank
    ``r``'s block of ``wo`` rows (``q_cols`` of them) overlaps, and where that
    block starts in their flattened output."""
    D = cfg.resolved_head_dim
    c0 = r * cfg.q_cols
    h0 = c0 // D
    return h0, -(-(c0 + cfg.q_cols) // D), c0 - h0 * D


def kv_heads_of(cfg: ModelConfig, h0: int, h1: int):
    """The KV heads that query heads ``[h0, h1)`` read, as the kernels' GQA
    takes them: ``slice(kv0, kv1)`` where the block's heads keep a grouping
    of their own (each run of ``(h1 - h0) / (kv1 - kv0)`` consecutive heads on
    one KV head), else each head's KV head, one a head (group 1)."""
    group = cfg.n_heads // cfg.n_kv_heads
    kv = [h // group for h in range(h0, h1)]
    kv0, kv1 = kv[0], kv[-1] + 1
    n, nkv = h1 - h0, kv1 - kv0
    if n % nkv == 0 and all(k - kv0 == j // (n // nkv) for j, k in enumerate(kv)):
        return slice(kv0, kv1)
    return kv


def held_positions(cfg: ModelConfig, pages: int, length: int, page: int, device=None,
                   ring: bool = False):
    """``(positions, slots)``: which of a row's positions ``[0, length)``
    this rank's pool of ``pages`` pages a row holds, and where each lies in
    the row's pages (``transformer.cache_rows``' order): every position at
    its own slot, or on a rank of split heads those of its round-robin
    pages, in order from its first slot (``shardings.seq_positions``,
    ``seq_local_length`` of them). With ``ring`` (a sliding window's pool,
    the module docstring) the ring keeps the last positions it has room for
    (``m * pages`` pages of them on ``m`` ranks), each at its ring slot
    (``shardings.seq_place``); before the ring is full the same places as
    without. Either may be a slice."""
    r, m = seq_rank(cfg) if split_heads(cfg) else (0, 1)
    if ring and length > m * pages * page:
        # the rank's positions of the last m * pages pages, in order: its
        # ring unrolled, from local position lo (its page u // page is the
        # row's page (u // page) m + r)
        lo = sh.seq_local_length(length - m * pages * page, r, m, page)
        u = torch.arange(lo, sh.seq_local_length(length, r, m, page), device=device)
        return ((u // page) * m + r) * page + u % page, (u // page) % pages * page + u % page
    if m == 1:
        return slice(None), slice(0, length)
    where = sh.seq_positions(r, m, pages, page, device)
    n = sh.seq_local_length(length, r, m, page)
    return where[:n], slice(0, n)


def merge_partials(o: torch.Tensor, lse: torch.Tensor) -> torch.Tensor:
    """The attention over every rank's positions from the ranks' partials
    stacked on the first axis: each ``o`` normalized over its rank's own
    positions, ``lse`` its log-sum-exp (``o``'s shape without its last
    axis; ``-inf`` where the rank holds none): ``sum_r w_r o_r / sum_r w_r``
    with ``w_r = exp(lse_r - max_r lse_r)``, summed in rank order. A row
    that no rank holds a position of gives zeros."""
    top = lse.amax(0)
    w = torch.exp(lse - torch.where(torch.isfinite(top), top, torch.zeros_like(top)))
    return (o * w[..., None]).sum(0) / w.sum(0).clamp_min(1e-30)[..., None]


def merge_model_axis(o: torch.Tensor, lse: torch.Tensor) -> torch.Tensor:
    """``merge_partials`` over the ranks of the ambient model axis: each
    rank's partial ``o`` (float32) and its log-sum-exp ``lse``, packed and
    gathered in one ``all_gather``, merged alike on every rank. Float32,
    unrounded. Serving only: the train step never decodes, so no gradient
    flows through the gather."""
    axis = runtime_flags.get_mesh()
    part = torch.cat([o.reshape(-1), lse.reshape(-1)])
    parts = [torch.empty_like(part) for _ in range(axis.size)]
    dist.all_gather(parts, part, group=axis.group)
    every = torch.stack(parts)
    return merge_partials(every[:, :o.numel()].view(-1, *o.shape),
                          every[:, o.numel():].view(-1, *lse.shape))


# ---------------------------------------------------------------- RoPE


def rope_angles(positions: torch.Tensor, head_dim: int,
                theta: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """positions (...,) -> cos/sin of shape (..., head_dim//2), float32."""
    half = head_dim // 2
    freqs = torch.exp(-torch.arange(0, half, dtype=torch.float32,
                                    device=positions.device) *
                      (math.log(theta) / half))
    ang = positions.float()[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x (..., n_heads, head_dim); cos/sin broadcastable to (..., 1, head_dim//2).
    The two halves of head_dim are rotated against each other (not
    interleaved pairs)."""
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    cos = cos[..., None, :]
    sin = sin[..., None, :]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos],
                     dim=-1).to(x.dtype)


# ---------------------------------------------------------------- attention


def init_attention(cfg: ModelConfig, gen: torch.Generator, dtype, device,
                   d_model: Optional[int] = None) -> Params:
    d = d_model or cfg.d_model
    hd = cfg.resolved_head_dim
    # a rank of split heads: its column blocks (the module docstring)
    cq = cfg.q_cols if split_heads(cfg) else cfg.n_heads * hd
    ckv = cfg.kv_cols if split_heads(cfg) else cfg.n_kv_heads * hd
    return {
        "wq": _dense_init(gen, (d, cq), dtype, device),
        "wk": _dense_init(gen, (d, ckv), dtype, device),
        "wv": _dense_init(gen, (d, ckv), dtype, device),
        "wo": _dense_init(gen, (cq, d), dtype, device),
    }


def attention_forward(cfg: ModelConfig, p: Params, x: torch.Tensor, *,
                      positions: Optional[torch.Tensor] = None,
                      causal: bool = True,
                      kv_x: Optional[torch.Tensor] = None,
                      use_rope: bool = True,
                      prefix_len: int = 0,
                      return_kv: bool = False,
                      past_kv: Optional[Tuple[torch.Tensor, torch.Tensor]] = None):
    """Full-sequence (self or cross) attention through ``ops.flash_prefill``.

    x (B,S,d). kv_x: source of K and V for cross-attention (B,T,d); None =
    self. Cross-attention takes no RoPE, as in the reference, and is full
    (``causal=False``) over the T rows. positions: absolute positions (B,S)
    for RoPE; default ``past_len + arange(S)``.
    return_kv: also return the (roped) K and V of the new tokens, e.g. for
    cache building.
    past_kv: (pk, pv) of shape (B, P, Hkv, D) — already-roped K/V of a
    prefix (chunked prefill / prefix caching); queries sit at absolute
    positions P.. and attend to the past causally.
    prefix_len: number of leading tokens (the vision tokens) that every query
    attends to bidirectionally; with ``cfg.sliding_window`` the causal part
    is cut to the window, as in the reference.
    """
    B, S, _ = x.shape
    hd = cfg.resolved_head_dim
    H, Hkv = cfg.n_heads, cfg.n_kv_heads
    x = copy_to_model_axis(x)
    src = x if kv_x is None else copy_to_model_axis(kv_x)
    past_len = past_kv[0].shape[1] if past_kv is not None else 0
    split = split_heads(cfg)
    if split and kv_x is None:    # a self-attention's q, k and v in one gather
        q, k, v = gather_columns(x, p["wq"], p["wk"], p["wv"])
    elif split:    # a cross-attention's q over x's rows, k and v over the source's
        q, = gather_columns(x, p["wq"])
        k, v = gather_columns(src, p["wk"], p["wv"])
    else:
        q, k, v = x @ p["wq"], src @ p["wk"], src @ p["wv"]
    q = q.reshape(B, S, H, hd)
    k = k.reshape(B, src.shape[1], Hkv, hd)
    v = v.reshape(B, src.shape[1], Hkv, hd)
    if use_rope and kv_x is None:
        if positions is None:
            positions = (past_len + torch.arange(S, device=x.device))[None, :] \
                .expand(B, S)
        cos, sin = rope_angles(positions, hd, cfg.rope_theta)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
    new_k, new_v = k, v
    if past_kv is not None:
        k = torch.cat([past_kv[0].to(k.dtype), k], dim=1)
        v = torch.cat([past_kv[1].to(v.dtype), v], dim=1)
    offset = 0
    if split:   # the heads this rank's rows of wo overlap, and their KV heads
        h0, h1, offset = split_head_block(cfg, seq_rank(cfg)[0])
        kv = kv_heads_of(cfg, h0, h1)
        q, k, v = q[:, :, h0:h1], k[:, :, kv], v[:, :, kv]
    # (B,S,H,D) -> the kernel's (B,H,S,D) as strided views, no copy; as in
    # the reference, a cross-attention is never masked
    o = ops.flash_prefill(q.transpose(1, 2), k.transpose(1, 2),
                          v.transpose(1, 2), causal=causal and kv_x is None,
                          q_offset=past_len,
                          window=cfg.sliding_window, prefix_len=prefix_len)
    o = o.transpose(1, 2).reshape(B, S, -1)
    if split:
        o = o[..., offset:offset + cfg.q_cols]
    out = row_parallel(o, p["wo"])
    if return_kv:
        return out, new_k, new_v   # new tokens only (past excluded)
    return out


def init_kv_cache(cfg: ModelConfig, batch: int, cache_len: int, n_layers: int,
                  dtype, device) -> Dict[str, torch.Tensor]:
    """Zeroed page pools for ``batch`` sequences of up to ``cache_len`` tokens,
    or, for a model with a sliding window, a ring of the last ``cache_len``
    positions of each (the module docstring), rounded up to whole pages.

    ``k``/``v`` are (n_layers, num_pages, page, Hkv, D) with
    ``num_pages = batch * ceil(cache_len / page)``. Row ``i`` of
    ``block_tables`` (batch, pages_per_seq) int32 owns the fixed page range
    ``[i * pages_per_seq, (i + 1) * pages_per_seq)``. A rank of split heads
    holds every KV head at its share of each row's pages
    (``shardings.seq_pages``: round-robin pages).
    """
    hd = cfg.resolved_head_dim
    page_size = ops.DEFAULT_PAGE_SIZE
    pages_per_seq = -(-cache_len // page_size)
    if split_heads(cfg):
        pages_per_seq = sh.seq_pages(pages_per_seq, cfg.kv_shards)
    shape = (n_layers, batch * pages_per_seq, page_size, cfg.n_kv_heads, hd)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
        "block_tables": torch.arange(batch * pages_per_seq, dtype=torch.int32,
                                     device=device).reshape(batch, pages_per_seq),
    }


def decode_plan(cfg: ModelConfig, block_tables: torch.Tensor, pos: torch.Tensor,
                active: Optional[torch.Tensor], page: int) -> Dict[str, Any]:
    """What every layer of one decode step shares: where the new token's K/V
    go in the pools, the block table, lengths and, with a sliding window,
    first positions (``starts``) to attend over, and the RoPE angles.
    Computed once per step on the device, so the layers do not repeat these
    small launches and a captured graph recomputes them from ``pos`` at
    every replay.

    block_tables (B, pages_per_seq) int32; pos (B,) absolute position of the
    new token; active (B,) bool or None (all rows hold a sequence). An
    inactive row gets length 0 and position 0, so its indices stay in range
    whatever its stale ``pos`` is.

    With a sliding window the pool is a ring of ``pages_per_seq`` pages (the
    module docstring): the new token goes to ring page ``(pos // page) mod
    pages_per_seq``, a row attends over its last ``min(window, pages_per_seq
    * page)`` positions (the reference's ``slot_pos > pos - window`` over a
    ring of that many slots), and ``table`` is the rotated view of the ring
    in which they lie in order (``ring_view``): ``pages_per_seq + 1``
    entries whatever ``pos`` is, so a captured graph replays across the
    wrap; before it the view is the block table with one entry more, never
    read, and ``starts`` and ``lengths`` are ``max(0, pos + 1 - window)``
    and ``pos + 1``. Without a window ``table`` is the block table and
    ``starts`` None.

    A rank of split heads holds its round-robin pages of each row
    (``shardings.seq_place``): the page and offset are the new token's place
    in them, ``keep`` lets only the rank that owns the position write it,
    and the lengths and starts are counts of the rank's positions up to the
    new token and below the window (``shardings.seq_local_length``), in its
    own rotated view where its pages are a ring.
    """
    pos = pos.long()
    if active is not None:
        pos = pos * active
    cos, sin = rope_angles(pos[:, None], cfg.resolved_head_dim, cfg.rope_theta)
    lengths = pos + 1
    ring = block_tables.shape[1] if cfg.sliding_window > 0 else 0
    r, m = seq_rank(cfg) if split_heads(cfg) else (0, 1)
    # a ring holds its last m * ring pages' positions, m = 1 off a mesh
    starts = (lengths - min(cfg.sliding_window, m * ring * page)).clamp_min(0) \
        if ring else None
    owner, local, offsets = sh.seq_place(pos, m, page, ring)
    keep = active
    if m > 1:
        lengths = sh.seq_local_length(lengths, r, m, page)
        starts = None if starts is None else sh.seq_local_length(starts, r, m, page)
        keep = owner == r if keep is None else keep & (owner == r)
    if active is not None:
        lengths = lengths * active
    table = block_tables
    if ring:
        table, starts, lengths = ring_view(block_tables, starts, lengths, page)
    return {
        "page_ids": torch.gather(block_tables.long(), 1, local[:, None])[:, 0],
        "offsets": offsets,
        "table": table,
        "lengths": lengths.to(torch.int32),
        "starts": None if starts is None else starts.to(torch.int32),
        "cos": cos, "sin": sin,
        "keep": None if keep is None else keep[:, None, None],
    }


def ring_view(block_tables: torch.Tensor, starts: torch.Tensor, lengths: torch.Tensor,
              page: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """A ring's rotated view: ``(table, starts, lengths)`` for the kernel,
    from a row's ``L = block_tables.shape[1]`` ring pages and the positions
    ``[starts, lengths)`` to attend over, counted along the ring unrolled
    (the row's own positions, or a rank's own). The view's ``L + 1`` entries
    are the ring pages of unrolled pages ``base .. base + L``, ``base = max(0,
    newest - L)``: the oldest page the ring may still hold positions of
    comes first and shares its physical page with the newest, which comes
    last; ``starts`` and ``lengths`` move down by ``base`` pages. Since a
    ring holds its last ``L * page`` positions, ``starts >= lengths - L *
    page`` keeps every position read out of the newest page's slots that it
    has already overwritten. ``base`` is 0 until the ring wraps: the view is
    then the table with its first page once more at the end, past
    ``lengths``."""
    L = block_tables.shape[1]
    base = ((lengths - 1).clamp_min(0) // page - L).clamp_min(0)
    pages = (base[:, None] + torch.arange(L + 1, device=block_tables.device)) % L
    table = torch.gather(block_tables, 1, pages)
    return table.to(torch.int32), starts - base * page, lengths - base * page


def attention_decode(cfg: ModelConfig, p: Params, x: torch.Tensor,
                     k_pool: torch.Tensor, v_pool: torch.Tensor,
                     block_tables: torch.Tensor, pos: torch.Tensor,
                     active: Optional[torch.Tensor] = None,
                     *, use_rope: bool = True,
                     plan: Optional[Dict[str, Any]] = None) -> torch.Tensor:
    """One-token decode against a paged KV pool, through ``ops.paged_attention``.

    x (B,1,d); k_pool/v_pool (num_pages, page, Hkv, D) of one layer;
    block_tables (B, pages_per_seq) int32; pos (B,) absolute position of the
    new token; active (B,) bool, rows that hold a sequence (default: all);
    plan: ``decode_plan`` of the same arguments, when the caller shares one
    between layers.

    The new token's K/V are written into the pools IN PLACE, at page
    ``block_tables[b, pos // page]`` (its ring page with a window), offset
    ``pos % page``, before scoring, so the token attends to itself and
    ``lengths = pos + 1``. (The reference returns updated copies of its
    dense cache; updating the pool in place avoids copying the whole pool
    every layer of every step.) Inactive rows leave the pools as they are
    and attend over length 0, which gives zeros. With ``cfg.sliding_window``
    a row attends over its last ``window`` positions only, those its ring
    holds (``plan["table"]``, ``plan["starts"]``). Returns out (B,1,d).
    """
    B = x.shape[0]
    hd = cfg.resolved_head_dim
    H, Hkv = cfg.n_heads, cfg.n_kv_heads
    page = k_pool.shape[1]
    if plan is None:
        plan = decode_plan(cfg, block_tables, pos, active, page)
    split = split_heads(cfg)
    if split:
        q, k, v = gather_columns(x, p["wq"], p["wk"], p["wv"])
    else:
        q, k, v = x @ p["wq"], x @ p["wk"], x @ p["wv"]
    q = q.reshape(B, 1, H, hd)
    k = k.reshape(B, 1, Hkv, hd)
    v = v.reshape(B, 1, Hkv, hd)
    if use_rope:
        q = apply_rope(q, plan["cos"], plan["sin"])
        k = apply_rope(k, plan["cos"], plan["sin"])
    where = (plan["page_ids"], plan["offsets"])
    k_new, v_new = k[:, 0].to(k_pool.dtype), v[:, 0].to(v_pool.dtype)
    if plan["keep"] is not None:
        # an inactive row rewrites what its target already holds: a masked
        # write without data-dependent shapes, hence without a host sync
        k_new = torch.where(plan["keep"], k_new, k_pool[where])
        v_new = torch.where(plan["keep"], v_new, v_pool[where])
    k_pool[where] = k_new
    v_pool[where] = v_new
    q = q.reshape(B, Hkv, H // Hkv, hd)
    if split:
        return _merged_decode(cfg, p, q, k_pool, v_pool, plan["table"], plan["lengths"],
                              x.dtype, plan["starts"])
    o = ops.paged_attention(q, k_pool, v_pool, plan["table"], plan["lengths"],
                            page_size=page, starts=plan["starts"])
    return row_parallel(o.reshape(B, 1, H * hd), p["wo"])


def cross_attention_decode(cfg: ModelConfig, p: Params, x: torch.Tensor,
                           k_pool: torch.Tensor, v_pool: torch.Tensor,
                           block_tables: torch.Tensor,
                           lengths: torch.Tensor) -> torch.Tensor:
    """One-token cross-attention over each sequence's fixed encoder K/V,
    through ``ops.paged_attention``.

    x (B,1,d); k_pool/v_pool (num_pages, page, Hkv, D) of one layer, holding
    each sequence's ``enc_seq`` encoder rows (written at prefill, never
    changed by a decode step); block_tables (B, pages_per_seq) int32;
    lengths (B,) int32: ``enc_seq`` for a row that holds a sequence, 0 for a
    free one (which gives zeros). Returns out (B,1,d).

    On a rank of split heads the pools hold the rank's round-robin pages of
    each row's encoder rows and ``lengths`` counts those
    (``shardings.seq_local_length``; 0 where the rank holds none of the row,
    whose partial then has a log-sum-exp of -inf): q is gathered whole, and
    every head's partial over the rank's positions is merged over the ranks
    (``merge_model_axis``), as ``attention_decode``'s.

    The reference (``repro.models.layers.cross_attention_decode``) casts the
    softmax weights to the cache dtype before the P V product, where the
    kernel keeps them in float32: the same in float32, and inside the
    bfloat16 tolerance in bfloat16.
    """
    B = x.shape[0]
    hd = cfg.resolved_head_dim
    H, Hkv = cfg.n_heads, cfg.n_kv_heads
    if split_heads(cfg):
        q = gather_columns(x, p["wq"])[0].reshape(B, Hkv, H // Hkv, hd)
        return _merged_decode(cfg, p, q, k_pool, v_pool, block_tables, lengths, x.dtype)
    q = (x @ p["wq"]).reshape(B, Hkv, H // Hkv, hd)
    o = ops.paged_attention(q, k_pool, v_pool, block_tables, lengths,
                            page_size=k_pool.shape[1])
    return row_parallel(o.reshape(B, 1, H * hd), p["wo"])


def _merged_decode(cfg: ModelConfig, p: Params, q: torch.Tensor, k_pool: torch.Tensor,
                   v_pool: torch.Tensor, block_tables: torch.Tensor,
                   lengths: torch.Tensor, dtype,
                   starts: Optional[torch.Tensor] = None) -> torch.Tensor:
    """A decode attention on a rank of split heads: every head of ``q`` (B,
    Hkv, group, D) over the rank's positions ``[starts, lengths)`` of its
    pages (``block_tables``: a ring's rotated view) into a float32 partial
    with its log-sum-exp (``-inf`` where it holds none), merged over the
    ranks (``merge_model_axis``), rounded to ``dtype`` once, and the rank's
    ``q_cols`` columns of it through its rows of ``wo``."""
    B = q.shape[0]
    o, lse = ops.paged_attention(q, k_pool, v_pool, block_tables, lengths,
                                 page_size=k_pool.shape[1], starts=starts,
                                 return_lse=True)
    o = merge_model_axis(o, lse).to(dtype).reshape(B, 1, -1)
    r = seq_rank(cfg)[0]
    return row_parallel(o[..., r * cfg.q_cols:(r + 1) * cfg.q_cols], p["wo"])


# ---------------------------------------------------------------- FFN


def init_ffn(cfg: ModelConfig, gen: torch.Generator, dtype, device,
             d_ff: Optional[int] = None, d_model: Optional[int] = None) -> Params:
    d = d_model or cfg.d_model
    f = d_ff or cfg.d_ff
    if cfg.ffn == "swiglu":
        return {"w_gate": _dense_init(gen, (d, f), dtype, device),
                "w_up": _dense_init(gen, (d, f), dtype, device),
                "w_down": _dense_init(gen, (f, d), dtype, device)}
    return {"w_up": _dense_init(gen, (d, f), dtype, device),
            "w_down": _dense_init(gen, (f, d), dtype, device)}


def ffn_forward(cfg: ModelConfig, p: Params, x: torch.Tensor) -> torch.Tensor:
    x = copy_to_model_axis(x)
    if cfg.ffn == "swiglu":
        h = torch.nn.functional.silu(x @ p["w_gate"]) * (x @ p["w_up"])
    else:
        # the reference's jax.nn.gelu defaults to the tanh approximation
        h = torch.nn.functional.gelu(x @ p["w_up"], approximate="tanh")
    return row_parallel(h, p["w_down"])


# ---------------------------------------------------------------- embeddings


def init_embeddings(cfg: ModelConfig, gen: torch.Generator, dtype, device) -> Params:
    p = {"tok": _dense_init(gen, (cfg.vocab_size, cfg.d_model), dtype, device,
                            scale=0.02)}
    if not cfg.tie_embeddings:
        p["head"] = _dense_init(gen, (cfg.d_model, cfg.vocab_size), dtype, device)
    return p


def embed(p: Params, tokens: torch.Tensor) -> torch.Tensor:
    """Token embeddings; under a mesh whose model axis shards the
    vocabulary, each rank looks up the ids in its rows (zeros for the rest)
    and the ranks' rows are summed."""
    axis = runtime_flags.get_mesh()
    if axis is None or not axis.shard_vocab:
        return p["tok"][tokens]
    rows = p["tok"].shape[0]
    local = tokens - axis.rank * rows
    inside = ((local >= 0) & (local < rows))[..., None]
    x = torch.where(inside, p["tok"][local.clamp(0, rows - 1)], 0)
    return reduce_model_axis(x)


def unembed(p: Params, x: torch.Tensor) -> torch.Tensor:
    """Logits over the vocabulary; under a mesh whose model axis shards it,
    each rank writes its columns into a zero-filled full-vocabulary buffer
    and the buffers are summed."""
    axis = runtime_flags.get_mesh()
    if axis is None or not axis.shard_vocab:
        return x @ p["head"] if "head" in p else x @ p["tok"].T
    x = copy_to_model_axis(x)
    return gather_model_axis(x @ p["head"] if "head" in p else x @ p["tok"].T)


def gather_model_axis(part: torch.Tensor) -> torch.Tensor:
    """The whole last axis of a tensor whose columns the ambient model axis
    shards in rank order: each rank writes its columns into a zero-filled
    buffer and the buffers are summed (exact: one term a column). Its
    backward hands each rank its columns' gradient."""
    axis = runtime_flags.get_mesh()
    cols = part.shape[-1]
    full = part.new_zeros(part.shape[:-1] + (cols * axis.size,))
    full[..., axis.rank * cols:(axis.rank + 1) * cols] = part
    return reduce_model_axis(full)
