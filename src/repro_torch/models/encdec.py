"""Whisper-style encoder-decoder transformer backbone (PyTorch).
[arXiv:2212.04356]

The port of ``repro.models.encdec``. As there, the mel-spectrogram and conv
frontend is a stub: the model takes precomputed frame embeddings
``(B, enc_seq, d_model)``. The bidirectional encoder runs its attention
through ``ops.flash_prefill`` with ``causal=False`` (S = T = ``enc_seq``);
each decoder layer has a causal self-attention (RoPE, as the reference's),
a cross-attention over the encoder states and a GELU FFN. Parameters keep
the reference's names and stacking (``emb``, ``enc_pos``, ``enc_layers``,
``dec_layers``, ``enc_norm``, ``final_norm``), so they load one to one.

Two cache formats, as in ``transformer``:

- the *dense* cache ``prefill`` returns: ``{"k", "v": (L, B, S, Hkv, D),
  "cross_k", "cross_v": (L, B, enc_seq, Hkv, D), "pos": (B,)}``;
- the *paged* cache ``decode_step`` works on (``init_cache``): the self
  pool ``k``, ``v``, ``block_tables`` of ``transformer``'s format, and a
  cross pool ``cross_k``, ``cross_v``, ``cross_block_tables`` of
  ``enc_seq`` positions a row, which the decode step reads through
  ``ops.paged_attention`` (``layers.cross_attention_decode``) and never
  writes. ``prefill(cache_len=n)`` returns this format.

Against the reference, as in the port's other families: a free row of
``decode_step`` (``active`` False) neither advances ``pos`` nor writes K/V,
and attends over nothing. ``prefill`` refuses a ``past_cache`` (the
reference's swallows it; its engine never chunks this family).

With a sliding window (``launch.steps.resolve_config`` gives whisper-base
one at ``long_500k``) the self pool is a ring of pages, as the dense
family's (``models/layers.py``); the cross pool is never one.

On a rank of split heads (``launch.steps.splits_heads``: whisper-base's 8
heads on a model axis of 16) both pools hold the rank's round-robin pages
of each row (``launch.shardings.seq_place``), the cross pool those of the
row's ``enc_seq`` encoder positions, where the reference cuts the cross
K/V's ``head_dim`` (ROADMAP.md, Departures): ``prefill`` writes the
positions the rank holds, and ``decode_step`` attends over the rank's
count of them (``shardings.seq_local_length``) and merges the partials
over the ranks (``layers.cross_attention_decode``).
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.launch import shardings as sh
from repro_torch.models import layers as L
from repro_torch.models import transformer
from repro_torch.models.layers import layer_params, stack_into

Params = Dict[str, Any]
Cache = Dict[str, torch.Tensor]


def _init_enc_layer(cfg: ModelConfig, gen: torch.Generator, dtype, device) -> Params:
    return {"attn": L.init_attention(cfg, gen, dtype, device),
            "ffn": L.init_ffn(cfg, gen, dtype, device),
            "norm1": L.init_norm(cfg, dtype, device),
            "norm2": L.init_norm(cfg, dtype, device)}


def _init_dec_layer(cfg: ModelConfig, gen: torch.Generator, dtype, device) -> Params:
    return {"self_attn": L.init_attention(cfg, gen, dtype, device),
            "cross_attn": L.init_attention(cfg, gen, dtype, device),
            "ffn": L.init_ffn(cfg, gen, dtype, device),
            "norm1": L.init_norm(cfg, dtype, device),
            "norm2": L.init_norm(cfg, dtype, device),
            "norm3": L.init_norm(cfg, dtype, device)}


def init_params(cfg: ModelConfig, gen: torch.Generator, dtype=None,
                device="cuda", cut=None) -> Params:
    """Random parameters from ``gen`` (a generator on ``device``), each layer
    written into the stacked tensors in ``dtype`` as it is drawn. ``cut(key,
    tree)``: as ``transformer.init_params``'s, ``key`` each top-level name
    (``"enc_layers"`` / ``"dec_layers"`` for one layer) but ``enc_pos``,
    which every rule keeps whole."""
    dtype = dtype or getattr(torch, cfg.dtype)
    cut = cut or (lambda _key, tree: tree)
    emb = cut("emb", L.init_embeddings(cfg, gen, dtype, device))
    enc_pos = (torch.randn((cfg.enc_seq, cfg.d_model), generator=gen, device=device)
               * 0.02).to(dtype)
    enc: Params = {}
    for i in range(cfg.n_enc_layers):
        stack_into(enc, cut("enc_layers", _init_enc_layer(cfg, gen, dtype, device)), i,
                   cfg.n_enc_layers)
    dec: Params = {}
    for i in range(cfg.n_layers):
        stack_into(dec, cut("dec_layers", _init_dec_layer(cfg, gen, dtype, device)), i,
                   cfg.n_layers)
    return {"emb": emb, "enc_pos": enc_pos, "enc_layers": enc,
            "dec_layers": dec, "enc_norm": cut("enc_norm", L.init_norm(cfg, dtype, device)),
            "final_norm": cut("final_norm", L.init_norm(cfg, dtype, device))}


def _enc_layer(cfg: ModelConfig, lp: Params, x: torch.Tensor) -> torch.Tensor:
    h = L.apply_norm(cfg, lp["norm1"], x)
    x = x + L.attention_forward(cfg, lp["attn"], h, causal=False, use_rope=False)
    return x + L.ffn_forward(cfg, lp["ffn"], L.apply_norm(cfg, lp["norm2"], x))


def encode(cfg: ModelConfig, params: Params, frames: torch.Tensor) -> torch.Tensor:
    """frames (B, T, d) stub embeddings -> encoder states (B, T, d)."""
    x = frames + params["enc_pos"][None, :frames.shape[1]].to(frames.dtype)
    for i in range(cfg.n_enc_layers):
        x = _enc_layer(cfg, layer_params(params["enc_layers"], i), x)
    return L.apply_norm(cfg, params["enc_norm"], x)


def _dec_layer_full(cfg: ModelConfig, lp: Params, x: torch.Tensor, enc: torch.Tensor,
                    positions: torch.Tensor) -> torch.Tensor:
    h = L.apply_norm(cfg, lp["norm1"], x)
    x = x + L.attention_forward(cfg, lp["self_attn"], h, positions=positions)
    h = L.apply_norm(cfg, lp["norm2"], x)
    x = x + L.attention_forward(cfg, lp["cross_attn"], h, kv_x=enc, causal=False,
                                use_rope=False)
    return x + L.ffn_forward(cfg, lp["ffn"], L.apply_norm(cfg, lp["norm3"], x))


def forward(cfg: ModelConfig, params: Params, tokens: torch.Tensor, *,
            frames: torch.Tensor, remat: bool = False
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward: (logits (B,S,V), aux_loss = 0). ``remat``
    recomputes each decoder layer in the backward pass, as the reference
    checkpoints its decoder scan's body."""
    enc = encode(cfg, params, frames)
    x = L.embed(params["emb"], tokens)
    B, S, _ = x.shape
    positions = torch.arange(S, device=x.device)[None, :].expand(B, S)
    for i in range(cfg.n_layers):
        x = L.maybe_remat(_dec_layer_full, remat, cfg,
                          layer_params(params["dec_layers"], i), x, enc, positions)
    x = L.apply_norm(cfg, params["final_norm"], x)
    return L.unembed(params["emb"], x), torch.zeros((), device=x.device)


def init_cache(cfg: ModelConfig, batch: int, cache_len: int, dtype,
               device="cuda") -> Cache:
    """Zeroed paged cache for ``batch`` sequences of up to ``cache_len``
    decoder positions, with a cross pool of ``enc_seq`` positions a row."""
    c = L.init_kv_cache(cfg, batch, cache_len, cfg.n_layers, dtype, device)
    cross = L.init_kv_cache(cfg, batch, cfg.enc_seq, cfg.n_layers, dtype, device)
    c.update({"cross_k": cross["k"], "cross_v": cross["v"],
              "cross_block_tables": cross["block_tables"],
              "pos": torch.zeros((batch,), dtype=torch.int32, device=device)})
    return c


def write_slot(cache: Cache, slot: int, sub: Cache) -> None:
    """Write a batch-of-1 cache (``k``/``v`` (L,1,S,Hkv,D) and ``cross_k`` /
    ``cross_v`` (L,1,T,Hkv,D), from ``prefill`` or ``read_slot``) into row
    ``slot`` of a paged cache. ``pos`` is left to the caller."""
    transformer.write_slot(cache, slot, sub)
    for key in ("cross_k", "cross_v"):
        T = sub[key].shape[2]
        transformer.cache_rows(cache, key, slot, table="cross_block_tables")[:, :T] = \
            sub[key][:, 0]


def read_slot(cache: Cache, slot: int, length: int) -> Cache:
    """Row ``slot``, holding ``length`` decoder positions, as a batch-of-1
    cache copied to the host. The cross rows are copied whole: the row's
    every cross page (``enc_seq`` rounded up to a page, 1504 positions and
    18.5 MB in bfloat16 at whisper-base's full width; the positions past
    ``enc_seq`` hold zeros)."""
    out = transformer.read_slot(cache, slot, length)
    for key in ("cross_k", "cross_v"):
        rows = transformer.cache_rows(cache, key, slot, table="cross_block_tables")
        out[key] = rows[:, None].to("cpu", copy=True)
    return out


def prefill(cfg: ModelConfig, params: Params, tokens: torch.Tensor, *,
            frames: torch.Tensor, cache_len: Optional[int] = None,
            past_cache: Optional[Cache] = None, dtype=None
            ) -> Tuple[torch.Tensor, Cache]:
    """Encode ``frames``, run the prompt; return last-position logits and
    the cache: dense without ``cache_len`` (see the module docstring), paged
    of that decoder capacity with it (with a sliding window the self pool is
    a ring, which keeps a longer prompt's last positions, as the dense
    family's). Each layer's cross K/V are the
    projections of the encoder states its cross-attention computed, kept
    once. A ``past_cache`` (chunked prefill) raises ``ValueError``."""
    if past_cache is not None:
        raise ValueError("prefill: the audio family takes no past_cache (its "
                         "engine never chunks a prompt)")
    dtype = dtype or getattr(torch, cfg.dtype)
    enc = encode(cfg, params, frames)
    x = L.embed(params["emb"], tokens)
    B, S, _ = x.shape
    transformer.check_cache_len(cfg, cache_len, S)
    positions = torch.arange(S, device=x.device)[None, :].expand(B, S)
    hd, Hkv, T = cfg.resolved_head_dim, cfg.n_kv_heads, enc.shape[1]
    ks = torch.empty((cfg.n_layers, B, S, Hkv, hd), dtype=dtype, device=x.device)
    vs = torch.empty_like(ks)
    cks = torch.empty((cfg.n_layers, B, T, Hkv, hd), dtype=dtype, device=x.device)
    cvs = torch.empty_like(cks)
    for i in range(cfg.n_layers):
        lp = layer_params(params["dec_layers"], i)
        h = L.apply_norm(cfg, lp["norm1"], x)
        o, ks[i], vs[i] = L.attention_forward(cfg, lp["self_attn"], h,
                                              positions=positions, return_kv=True)
        x = x + o
        h = L.apply_norm(cfg, lp["norm2"], x)
        o, cks[i], cvs[i] = L.attention_forward(cfg, lp["cross_attn"], h, kv_x=enc,
                                                causal=False, use_rope=False,
                                                return_kv=True)
        x = x + o
        x = x + L.ffn_forward(cfg, lp["ffn"], L.apply_norm(cfg, lp["norm3"], x))
    x = L.apply_norm(cfg, params["final_norm"], x)
    logits = L.unembed(params["emb"], x[:, -1:])[:, 0]
    pos = torch.full((B,), S, dtype=torch.int32, device=x.device)
    dense = {"k": ks, "v": vs, "cross_k": cks, "cross_v": cvs}
    if cache_len is None:
        return logits, {**dense, "pos": pos}
    cache = init_cache(cfg, B, cache_len, dtype, x.device)
    transformer.fill_pool(cfg, cache, dense)
    cache["pos"] = pos
    return logits, cache


def cross_lengths(cfg: ModelConfig, pos: torch.Tensor, active: Optional[torch.Tensor],
                  page: int) -> torch.Tensor:
    """Each row's length in the cross pool (pages of ``page``), like
    ``pos``: ``enc_seq`` for an active row (``active`` (B,) bool, default
    all), 0 for a free one; on a rank of split heads, the rank's count of
    the row's ``enc_seq`` positions on its round-robin pages
    (``shardings.seq_local_length``), 0 where it holds none."""
    enc = cfg.enc_seq
    if L.split_heads(cfg):
        r, m = L.seq_rank(cfg)
        enc = sh.seq_local_length(enc, r, m, page)
    lengths = torch.full_like(pos, enc)
    return lengths if active is None else lengths * active


def decode_step(cfg: ModelConfig, params: Params, tokens: torch.Tensor,
                cache: Cache, active: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Cache]:
    """One decode step on a paged cache. tokens (B,1) -> logits (B,V) and the
    cache with ``pos`` advanced; the self pools are updated IN PLACE, the
    cross pools only read. Every layer shares one ``decode_plan`` and one
    cross length per row (``cross_lengths``), computed on the device, so a
    captured graph needs nothing from the host."""
    x = L.embed(params["emb"], tokens)
    pos, bt = cache["pos"], cache["block_tables"]
    plan = L.decode_plan(cfg, bt, pos, active, cache["k"].shape[2])
    cross_len = cross_lengths(cfg, pos, active, cache["cross_k"].shape[2])
    for i in range(cfg.n_layers):
        lp = layer_params(params["dec_layers"], i)
        h = L.apply_norm(cfg, lp["norm1"], x)
        x = x + L.attention_decode(cfg, lp["self_attn"], h, cache["k"][i],
                                   cache["v"][i], bt, pos, active, plan=plan)
        h = L.apply_norm(cfg, lp["norm2"], x)
        x = x + L.cross_attention_decode(cfg, lp["cross_attn"], h, cache["cross_k"][i],
                                         cache["cross_v"][i],
                                         cache["cross_block_tables"], cross_len)
        x = x + L.ffn_forward(cfg, lp["ffn"], L.apply_norm(cfg, lp["norm3"], x))
    x = L.apply_norm(cfg, params["final_norm"], x)
    logits = L.unembed(params["emb"], x)[:, 0]
    step = 1 if active is None else active.to(pos.dtype)
    return logits, dict(cache, pos=pos + step)
