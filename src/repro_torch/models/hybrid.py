"""Zamba2-style hybrid (PyTorch): a Mamba2 backbone and one shared attention
block applied after every ``cfg.attn_every`` backbone layers, each call
with its own KV cache and the same weights. [arXiv:2411.15242]

The port of ``repro.models.hybrid``. Parameters are the reference's, so
they load one to one: ``"layers"`` the Mamba2 layers of ``models/ssm.py``
stacked over ``n_layers``, ``"shared"`` one block (``attn``, ``ffn``,
``norm1``, ``norm2``) and ``"final_norm"`` ``{"w"}``, applied as
``rms_norm`` whatever ``cfg.norm`` says, as the reference applies it.

The decode cache joins the two families' caches: the per-layer
``"ssm" (L, B, H, P, N)`` float32 and ``"conv" (L, B, conv_width - 1, ch)``
states of ``mamba_model.py``, and the dense family's page pools per call of
the shared block, ``"k", "v": (G, num_pages, page, Hkv, D)`` with
``G = n_layers / attn_every``, with ``"block_tables"`` and ``"pos"``. As in
the dense family a sliding window's pools are rings of pages, as the
reference's caches are rings of slots (``models/layers.py``), and
``prefill`` without ``cache_len`` returns a dense cache ``"k", "v":
(G, B, S, Hkv, D)`` that ``write_slot`` copies into a pool row. Free rows
update their SSM state as the reference's do and write no K/V.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import mamba_model, transformer
from repro_torch.models.ssm import init_mamba_layer, mamba_decode, mamba_forward

Params = Dict[str, Any]
Cache = Dict[str, torch.Tensor]


def _n_groups(cfg: ModelConfig) -> int:
    if cfg.attn_every < 1 or cfg.n_layers % cfg.attn_every:
        raise ValueError(f"{cfg.name}: n_layers {cfg.n_layers} is not a multiple "
                         f"of attn_every {cfg.attn_every}")
    return cfg.n_layers // cfg.attn_every


def init_params(cfg: ModelConfig, gen: torch.Generator, dtype=None,
                device="cuda", cut=None) -> Params:
    """Random parameters from ``gen`` (a generator on ``device``), each
    Mamba2 layer written into the stacked tensors in ``dtype`` as it is
    drawn (``A_log``, ``D`` and ``dt_bias`` stay float32). ``cut(key,
    tree)``: as ``transformer.init_params``'s (``key`` also ``"shared"``)."""
    _n_groups(cfg)
    dtype = dtype or getattr(torch, cfg.dtype)
    cut = cut or (lambda _key, tree: tree)
    emb = cut("emb", L.init_embeddings(cfg, gen, dtype, device))
    stacked: Params = {}
    for i in range(cfg.n_layers):
        L.stack_into(stacked, cut("layers", init_mamba_layer(cfg, gen, dtype, device)), i,
                     cfg.n_layers)
    shared = cut("shared", {"attn": L.init_attention(cfg, gen, dtype, device),
                            "ffn": L.init_ffn(cfg, gen, dtype, device),
                            "norm1": L.init_norm(cfg, dtype, device),
                            "norm2": L.init_norm(cfg, dtype, device)})
    return {"emb": emb, "layers": stacked, "shared": shared,
            "final_norm": cut("final_norm", {"w": torch.ones((cfg.d_model,), dtype=dtype,
                                                             device=device)})}


def _shared_ffn(cfg: ModelConfig, sp: Params, x: torch.Tensor) -> torch.Tensor:
    return x + L.ffn_forward(cfg, sp["ffn"], L.apply_norm(cfg, sp["norm2"], x))


def _shared_block(cfg: ModelConfig, sp: Params, x: torch.Tensor,
                  positions: torch.Tensor) -> torch.Tensor:
    h = L.apply_norm(cfg, sp["norm1"], x)
    return _shared_ffn(cfg, sp, x + L.attention_forward(cfg, sp["attn"], h,
                                                         positions=positions))


def forward(cfg: ModelConfig, params: Params, tokens: torch.Tensor, *,
            remat: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward: (logits (B,S,V), aux_loss = 0). ``remat``
    recomputes each Mamba2 layer and each call of the shared block in the
    backward pass (``layers.maybe_remat``)."""
    G, A = _n_groups(cfg), cfg.attn_every
    x = L.embed(params["emb"], tokens)
    B, S, _ = x.shape
    positions = torch.arange(S, device=x.device)[None, :].expand(B, S)
    sp = params["shared"]
    for g in range(G):
        for i in range(g * A, (g + 1) * A):
            x = L.maybe_remat(mamba_model._layer, remat, cfg,
                              L.layer_params(params["layers"], i), x)
        x = L.maybe_remat(_shared_block, remat, cfg, sp, x, positions)
    x = L.rms_norm(x, params["final_norm"]["w"])
    return L.unembed(params["emb"], x), torch.zeros((), device=x.device)


def init_cache(cfg: ModelConfig, batch: int, cache_len: int, dtype,
               device="cuda") -> Cache:
    """Zeroed decode state for ``batch`` sequences of up to ``cache_len``
    positions: the Mamba2 states and a page pool per shared-block call."""
    c = mamba_model.init_cache(cfg, batch, cache_len, dtype, device)
    c.update(L.init_kv_cache(cfg, batch, cache_len, _n_groups(cfg), dtype, device))
    return c


def prefill(cfg: ModelConfig, params: Params, tokens: torch.Tensor, *,
            cache_len: Optional[int] = None, past_cache: Optional[Cache] = None,
            dtype=None) -> Tuple[torch.Tensor, Cache]:
    """Run the prompt; return last-position logits and the decode cache:
    dense K/V without ``cache_len`` (every position, also with a window),
    page pools of that capacity with it (a window's rings keep a longer
    prompt's last positions). Continuing from a ``past_cache``
    (chunked prefill) is not ported: the reference engine does not chunk
    this family."""
    if past_cache is not None:
        raise NotImplementedError(
            "chunked prefill (past_cache) of the hybrid family is not ported to "
            "repro_torch (the reference engine does not chunk this family "
            "either)")
    dtype = dtype or getattr(torch, cfg.dtype)
    G, A = _n_groups(cfg), cfg.attn_every
    B, S = tokens.shape
    transformer.check_cache_len(cfg, cache_len, S)
    x = L.embed(params["emb"], tokens)
    positions = torch.arange(S, device=x.device)[None, :].expand(B, S)
    hd = cfg.resolved_head_dim
    ks = torch.empty((G, B, S, cfg.n_kv_heads, hd), dtype=dtype, device=x.device)
    vs = torch.empty_like(ks)
    hs, convs = [], []
    sp = params["shared"]
    for g in range(G):
        for i in range(g * A, (g + 1) * A):
            x, h, conv = mamba_forward(cfg, L.layer_params(params["layers"], i), x)
            hs.append(h)
            convs.append(conv.to(dtype))
        hn = L.apply_norm(cfg, sp["norm1"], x)
        o, ks[g], vs[g] = L.attention_forward(cfg, sp["attn"], hn,
                                              positions=positions, return_kv=True)
        x = _shared_ffn(cfg, sp, x + o)
    x = L.rms_norm(x, params["final_norm"]["w"])
    logits = L.unembed(params["emb"], x[:, -1:])[:, 0]
    pos = torch.full((B,), S, dtype=torch.int32, device=x.device)
    states = {"ssm": torch.stack(hs), "conv": torch.stack(convs)}
    if cache_len is None:
        return logits, {**states, "k": ks, "v": vs, "pos": pos}
    cache = init_cache(cfg, B, cache_len, dtype, x.device)
    for b in range(B):
        mamba_model.write_slot(cache, b, {key: t[:, b:b + 1] for key, t in states.items()})
    transformer.fill_pool(cfg, cache, {"k": ks, "v": vs})
    cache["pos"] = pos
    return logits, cache


def decode_step(cfg: ModelConfig, params: Params, tokens: torch.Tensor,
                cache: Cache, active: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Cache]:
    """One decode step. tokens (B,1) -> logits (B,V) and the cache with
    ``pos`` advanced; the SSM states, conv states and page pools are updated
    IN PLACE. ``active`` (B,) bool or None (all): an inactive row keeps its
    ``pos`` and writes no K/V, and its SSM and conv states advance as the
    reference engine's free slots do."""
    G, A = _n_groups(cfg), cfg.attn_every
    x = L.embed(params["emb"], tokens)
    pos, bt = cache["pos"], cache["block_tables"]
    plan = L.decode_plan(cfg, bt, pos, active, cache["k"].shape[2])
    sp = params["shared"]
    for g in range(G):
        for i in range(g * A, (g + 1) * A):
            x, _, conv = mamba_decode(cfg, L.layer_params(params["layers"], i), x,
                                      cache["ssm"][i], cache["conv"][i])
            cache["conv"][i] = conv
        h = L.apply_norm(cfg, sp["norm1"], x)
        x = _shared_ffn(cfg, sp, x + L.attention_decode(
            cfg, sp["attn"], h, cache["k"][g], cache["v"][g], bt, pos, active,
            plan=plan))
    x = L.rms_norm(x, params["final_norm"]["w"])
    logits = L.unembed(params["emb"], x)[:, 0]
    step = 1 if active is None else active.to(pos.dtype)
    return logits, dict(cache, pos=pos + step)


def write_slot(cache: Cache, slot: int, sub: Cache) -> None:
    """Write a batch-of-1 cache (from ``prefill`` or ``read_slot``) into row
    ``slot``: the SSM and conv states as ``mamba_model.write_slot`` writes
    them, the K/V of each call into the slot's pages. ``pos`` is left to the
    caller."""
    mamba_model.write_slot(cache, slot, sub)
    transformer.write_slot(cache, slot, sub)


def read_slot(cache: Cache, slot: int, length: int) -> Cache:
    """Row ``slot``, holding ``length`` positions, as a batch-of-1 cache
    copied to the host."""
    return {**mamba_model.read_slot(cache, slot, length),
            **transformer.read_slot(cache, slot, length)}
