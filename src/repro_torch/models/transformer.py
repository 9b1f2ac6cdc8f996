"""Decoder-only transformer stack, dense, MoE and VLM arms (PyTorch).

The MoE arm replaces each layer's FFN by ``models/moe.py``: forward and
prefill dispatch per batch row (``moe_forward_batched``; chunked prefill
over the chunk only, with its capacity from the chunk's length), the decode
step over the flat slots (``moe_forward``), where a free slot takes no
expert capacity. ``forward`` returns the layers' summed auxiliary
(load-balance) loss. The VLM arm is the dense stack with
``n_vision_tokens`` vision embeddings (the stub frontend's patch
embeddings) prepended to the token embeddings, which every query attends
to bidirectionally (``prefix_len``).

Parameters are stacked over layers (leading axis = n_layers), as in
``repro.models.transformer``, so the reference's parameters load one to
one (``repro_torch.params.from_reference``). Where the reference scans over
the stacked layers, this is a Python loop over views of the stacked tensors.

Two cache formats:

- the *dense* cache ``prefill`` returns: ``{"k", "v": (L, B, T, Hkv, D),
  "pos": (B,)}``, exactly the prompt's (roped) K/V — what chunked prefill
  continues from (``past_cache``) and what a serving engine copies into a
  slot;
- the *paged* cache ``decode_step`` works on (``init_cache``): page pools
  ``"k", "v": (L, num_pages, page, Hkv, D)``, ``"block_tables"
  (B, pages_per_seq)`` int32 in which row ``i`` owns the fixed page range
  ``[i * pages_per_seq, (i + 1) * pages_per_seq)``, and ``"pos": (B,)``.
  ``prefill(cache_len=n)`` returns this format, ready for ``decode_step``.
  With a sliding window its pages are a ring (``models/layers.py``), which
  a prefill of a longer prompt fills with the prompt's last positions.
  A mesh rank of split heads (``layers.split_heads``) holds its round-robin
  pages of each row (``launch.shardings.seq_place``), every KV head whole:
  its valid positions are a prefix of its pages until a ring wraps, so
  ``write_slot`` and ``read_slot`` copy a row's pages in order between two
  such pools.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models.layers import layer_params, stack_into
from repro_torch.models.moe import init_moe, moe_forward, moe_forward_batched

Params = Dict[str, Any]
Cache = Dict[str, torch.Tensor]


def _require_transformer(cfg: ModelConfig) -> None:
    if cfg.arch_type not in ("dense", "vlm", "moe") or \
            cfg.is_moe != (cfg.arch_type == "moe"):
        raise NotImplementedError(
            f"arch_type {cfg.arch_type!r} is not an arm of the transformer: "
            "its dense, moe and vlm arms are ported (ROADMAP.md, Queue A)")


def init_layer(cfg: ModelConfig, gen: torch.Generator, dtype, device) -> Params:
    p = {
        "attn": L.init_attention(cfg, gen, dtype, device),
        "norm1": L.init_norm(cfg, dtype, device),
        "norm2": L.init_norm(cfg, dtype, device),
    }
    if cfg.is_moe:
        p["moe"] = init_moe(cfg, gen, dtype, device)
    else:
        p["ffn"] = L.init_ffn(cfg, gen, dtype, device)
    return p


def init_params(cfg: ModelConfig, gen: torch.Generator, dtype=None,
                device="cuda", cut=None) -> Params:
    """Random parameters from ``gen`` (a generator on ``device``). Each layer
    is drawn in float32 and written into the stacked tensors in ``dtype``
    straight away, so a full-width model never holds more than one layer in
    float32 (an MoE router stays float32, as in the reference). ``cut(key,
    tree)``, where given, maps each subtree as soon as it is drawn (``key``
    is ``"emb"``, ``"layers"`` for one layer, or ``"final_norm"``):
    ``params.init_shard`` keeps a mesh rank's shards with it."""
    _require_transformer(cfg)
    dtype = dtype or getattr(torch, cfg.dtype)
    cut = cut or (lambda _key, tree: tree)
    emb = cut("emb", L.init_embeddings(cfg, gen, dtype, device))
    stacked: Params = {}
    for i in range(cfg.n_layers):
        stack_into(stacked, cut("layers", init_layer(cfg, gen, dtype, device)), i,
                   cfg.n_layers)
    return {"emb": emb, "layers": stacked,
            "final_norm": cut("final_norm", L.init_norm(cfg, dtype, device))}


def _ffn(cfg: ModelConfig, lp: Params, h: torch.Tensor
         ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """A layer's FFN over (B, S, d): the dense one, or the MoE dispatched
    per batch row with its auxiliary loss (None for a dense layer)."""
    if cfg.is_moe:
        return moe_forward_batched(cfg, lp["moe"], h)
    return L.ffn_forward(cfg, lp["ffn"], h), None


def _layer_forward(cfg: ModelConfig, lp: Params, x: torch.Tensor,
                   positions: torch.Tensor, prefix_len: int
                   ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    h = L.apply_norm(cfg, lp["norm1"], x)
    x = x + L.attention_forward(cfg, lp["attn"], h, positions=positions,
                                prefix_len=prefix_len)
    y, aux = _ffn(cfg, lp, L.apply_norm(cfg, lp["norm2"], x))
    return x + y, aux


def _embed(params: Params, tokens: torch.Tensor,
           vision_embeds: Optional[torch.Tensor]) -> Tuple[torch.Tensor, int]:
    """Token embeddings with the vision embeddings (B, n_vis, d) in front,
    and n_vis."""
    x = L.embed(params["emb"], tokens)
    if vision_embeds is None:
        return x, 0
    return torch.cat([vision_embeds.to(x.dtype), x], dim=1), vision_embeds.shape[1]


def forward(cfg: ModelConfig, params: Params, tokens: torch.Tensor, *,
            vision_embeds: Optional[torch.Tensor] = None, remat: bool = False
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward. Returns (logits (B,S,V), aux_loss): the MoE
    layers' summed load-balance loss, zero for a dense model. ``remat``
    recomputes each layer in the backward pass (``layers.maybe_remat``).

    For VLM configs, ``vision_embeds`` (B, n_vis, d) is prepended to the
    token embeddings at positions ``0 .. n_vis - 1``; logits are returned for
    the text positions only."""
    _require_transformer(cfg)
    x, prefix_len = _embed(params, tokens, vision_embeds)
    B, S, _ = x.shape
    positions = torch.arange(S, device=x.device)[None, :].expand(B, S)
    aux = torch.zeros((), device=x.device)
    for i in range(cfg.n_layers):
        x, a = L.maybe_remat(_layer_forward, remat, cfg,
                             layer_params(params["layers"], i), x, positions,
                             prefix_len)
        if a is not None:
            aux = aux + a
    x = L.apply_norm(cfg, params["final_norm"], x)
    return L.unembed(params["emb"], x[:, prefix_len:]), aux


def init_cache(cfg: ModelConfig, batch: int, cache_len: int, dtype,
               device="cuda") -> Cache:
    """Zeroed paged cache for ``batch`` sequences of up to ``cache_len``."""
    _require_transformer(cfg)
    c = L.init_kv_cache(cfg, batch, cache_len, cfg.n_layers, dtype, device)
    c["pos"] = torch.zeros((batch,), dtype=torch.int32, device=device)
    return c


def cache_rows(cache: Cache, key: str, row: int,
               table: str = "block_tables") -> torch.Tensor:
    """The K or V storage of sequence ``row`` of a paged cache from
    ``init_cache``, as a view (L, capacity, Hkv, D) in token order. Relies on
    row ``i`` owning the contiguous page range ``init_cache`` gave it in the
    block table ``cache[table]``."""
    pool = cache[key]
    pages_per_seq = cache[table].shape[1]
    n_layers, _, page, n_kv, hd = pool.shape
    rows = pool[:, row * pages_per_seq:(row + 1) * pages_per_seq]
    return rows.view(n_layers, pages_per_seq * page, n_kv, hd)


def write_slot(cache: Cache, slot: int, sub: Cache) -> None:
    """Write a batch-of-1 dense cache (k/v (L,1,S,Hkv,D)) into row ``slot``
    of a paged cache. ``pos`` is left to the caller."""
    S = sub["k"].shape[2]
    for key in ("k", "v"):
        cache_rows(cache, key, slot)[:, :S] = sub[key][:, 0]


def read_slot(cache: Cache, slot: int, length: int) -> Cache:
    """The first ``length`` tokens of row ``slot`` as a batch-of-1 dense cache
    on the host, copied: with the pool itself on the CPU, ``.cpu()`` would
    hand back a view of the slot, which the next request admitted there
    overwrites."""
    out = {key: cache_rows(cache, key, slot)[:, None, :length].to("cpu", copy=True)
           for key in ("k", "v")}
    out["pos"] = torch.tensor([length], dtype=torch.int32)
    return out


def prefill(cfg: ModelConfig, params: Params, tokens: torch.Tensor, *,
            cache_len: Optional[int] = None,
            vision_embeds: Optional[torch.Tensor] = None,
            past_cache: Optional[Cache] = None,
            dtype=None) -> Tuple[torch.Tensor, Cache]:
    """Run the prompt, return last-position logits and the KV cache.

    ``vision_embeds`` (B, n_vis, d), VLM: prepended to the prompt, which then
    fills ``n_vis + S`` positions (``pos = n_vis + S``).
    ``past_cache``: a dense cache to continue from — the chunked-prefill /
    prefix-caching path: only the new tokens are computed; the returned cache
    covers past + new. As in the reference it takes neither a vision prefix
    (that must be in the first chunk) nor a sliding window. K/V are cast to
    ``dtype`` on the way out. An MoE layer dispatches over the new tokens
    only, with the capacity of their count, as the reference's does.

    Without ``cache_len`` the cache is dense (see the module docstring) and
    holds every position, also with a sliding window (the reference's keeps
    a ring of the last ``window``); with ``cache_len``, a paged cache of that
    capacity, ready for ``decode_step``: with a sliding window a ring that
    keeps the prompt's last positions where the prompt is longer, as the
    reference's ``fit_cache`` keeps its last ``cache_len``
    (``fill_pool``); without one a ``cache_len`` shorter than the prompt
    raises ``ValueError``.
    """
    _require_transformer(cfg)
    dtype = dtype or getattr(torch, cfg.dtype)
    past_len = 0
    if past_cache is not None:
        if vision_embeds is not None:
            raise ValueError("prefill: the vision prefix must be in the first "
                             "chunk (no past_cache with vision_embeds)")
        if cfg.sliding_window > 0:
            raise ValueError("prefill: chunked prefill assumes a non-windowed "
                             "cache")
        past_len = int(past_cache["k"].shape[2])
    x, _ = _embed(params, tokens, vision_embeds)
    n_vis = 0 if vision_embeds is None else vision_embeds.shape[1]
    B, S, _ = x.shape            # S counts the vision prefix
    full_len = past_len + S
    check_cache_len(cfg, cache_len, full_len)

    positions = (past_len + torch.arange(S, device=x.device))[None, :].expand(B, S)
    hd = cfg.resolved_head_dim
    ks = torch.empty((cfg.n_layers, B, full_len, cfg.n_kv_heads, hd),
                     dtype=dtype, device=x.device)
    vs = torch.empty_like(ks)
    for i in range(cfg.n_layers):
        lp = layer_params(params["layers"], i)
        past = None
        if past_cache is not None:
            past = (past_cache["k"][i], past_cache["v"][i])
            ks[i, :, :past_len] = past[0]
            vs[i, :, :past_len] = past[1]
        h = L.apply_norm(cfg, lp["norm1"], x)
        o, k, v = L.attention_forward(cfg, lp["attn"], h, positions=positions,
                                      prefix_len=n_vis, return_kv=True,
                                      past_kv=past)
        ks[i, :, past_len:] = k
        vs[i, :, past_len:] = v
        x = x + o
        x = x + _ffn(cfg, lp, L.apply_norm(cfg, lp["norm2"], x))[0]

    x = L.apply_norm(cfg, params["final_norm"], x)
    logits = L.unembed(params["emb"], x[:, -1:])[:, 0]
    pos = torch.full((B,), full_len, dtype=torch.int32, device=x.device)
    if cache_len is None:
        return logits, {"k": ks, "v": vs, "pos": pos}
    cache = init_cache(cfg, B, cache_len, dtype, x.device)
    fill_pool(cfg, cache, {"k": ks, "v": vs})
    cache["pos"] = pos
    return logits, cache


def check_cache_len(cfg: ModelConfig, cache_len: Optional[int], length: int) -> None:
    """Refuse a pool of ``cache_len`` that cannot take a prompt of
    ``length`` positions: one shorter than the prompt, unless the model
    has a sliding window, whose pool is a ring that keeps the last."""
    if cache_len is not None and cache_len < length and cfg.sliding_window == 0:
        raise ValueError(f"cache_len {cache_len} is shorter than the prompt "
                         f"({length} tokens)")


def fill_pool(cfg: ModelConfig, cache: Cache, dense: Cache) -> None:
    """Write dense K/V (``dense[key]`` (L, B, S, Hkv, D), positions 0 ..
    S - 1 of each row) into the pools ``cache[key]`` of a paged cache, each
    row the positions this rank's pool holds at their places
    (``layers.held_positions``): every position, or on a rank of split
    heads those of its round-robin pages; the self pools' ring (a sliding
    window's) its last positions. A ``cross_`` key goes to the cross pool of
    ``cross_block_tables``, which is no ring."""
    for key, t in dense.items():
        table = "cross_block_tables" if key.startswith("cross") else "block_tables"
        positions, slots = L.held_positions(
            cfg, cache[table].shape[1], t.shape[2], cache[key].shape[2], t.device,
            ring=cfg.sliding_window > 0 and table == "block_tables")
        for b in range(t.shape[1]):
            cache_rows(cache, key, b, table=table)[:, slots] = t[:, b, positions]


def decode_step(cfg: ModelConfig, params: Params, tokens: torch.Tensor,
                cache: Cache, active: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Cache]:
    """One decode step on a paged cache. tokens (B,1) -> logits (B,V) and the
    cache with ``pos`` advanced. The pools are updated IN PLACE (the returned
    cache shares them with the one passed in): copying them every step would
    move the whole KV store.

    ``active`` (B,) bool marks the rows that hold a sequence (default: all).
    An inactive row writes no K/V, attends over nothing and keeps its
    ``pos``; rows are independent, so the active rows' logits do not depend
    on it. An MoE layer dispatches the B rows as flat tokens
    (``moe_forward``, router in float32); an inactive row takes no expert
    capacity.
    """
    _require_transformer(cfg)
    x = L.embed(params["emb"], tokens)
    pos = cache["pos"]
    bt = cache["block_tables"]
    plan = L.decode_plan(cfg, bt, pos, active, cache["k"].shape[2])
    for i in range(cfg.n_layers):
        lp = layer_params(params["layers"], i)
        h = L.apply_norm(cfg, lp["norm1"], x)
        x = x + L.attention_decode(cfg, lp["attn"], h, cache["k"][i],
                                   cache["v"][i], bt, pos, active, plan=plan)
        h = L.apply_norm(cfg, lp["norm2"], x)
        if cfg.is_moe:
            x = x + moe_forward(cfg, lp["moe"], h[:, 0], active)[0][:, None]
        else:
            x = x + L.ffn_forward(cfg, lp["ffn"], h)
    x = L.apply_norm(cfg, params["final_norm"], x)
    logits = L.unembed(params["emb"], x)[:, 0]
    step = 1 if active is None else active.to(pos.dtype)
    return logits, dict(cache, pos=pos + step)
