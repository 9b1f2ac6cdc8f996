"""Pure-SSM (Mamba2) decoder model (PyTorch): attention-free, O(1) decode
state. The port of ``repro.models.mamba_model``, parameters stacked over
layers as the reference's, so they load one to one.

The decode cache (``init_cache``, ``prefill``) is the reference's:
``"ssm" (L, B, H, P, N)`` fp32, ``"conv" (L, B, conv_width - 1, ch)`` in the
model dtype and ``"pos" (B,)`` int32. A slot of a serving pool is row
``[:, slot]`` of ``ssm`` and ``conv`` plus ``pos[slot]``.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models.ssm import init_mamba_layer, mamba_decode, mamba_forward

Params = Dict[str, Any]
Cache = Dict[str, torch.Tensor]


def init_params(cfg: ModelConfig, gen: torch.Generator, dtype=None,
                device="cuda", cut=None) -> Params:
    """Random parameters from ``gen`` (a generator on ``device``). Each layer
    is drawn in float32 and written into the stacked tensors in ``dtype``
    straight away (``A_log``, ``D`` and ``dt_bias`` stay float32, as in the
    reference). ``cut(key, tree)``: as ``transformer.init_params``'s."""
    dtype = dtype or getattr(torch, cfg.dtype)
    cut = cut or (lambda _key, tree: tree)
    emb = cut("emb", L.init_embeddings(cfg, gen, dtype, device))
    stacked: Params = {}
    for i in range(cfg.n_layers):
        L.stack_into(stacked, cut("layers", init_mamba_layer(cfg, gen, dtype, device)), i,
                     cfg.n_layers)
    return {"emb": emb, "layers": stacked,
            "final_norm": cut("final_norm", {"w": torch.ones((cfg.d_model,), dtype=dtype,
                                                             device=device)})}


def _layer(cfg: ModelConfig, lp: Params, x: torch.Tensor) -> torch.Tensor:
    return mamba_forward(cfg, lp, x)[0]


def forward(cfg: ModelConfig, params: Params, tokens: torch.Tensor, *,
            remat: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward: (logits (B,S,V), aux_loss = 0). ``remat``
    recomputes each layer in the backward pass (``layers.maybe_remat``)."""
    x = L.embed(params["emb"], tokens)
    for i in range(cfg.n_layers):
        x = L.maybe_remat(_layer, remat, cfg, L.layer_params(params["layers"], i), x)
    x = L.rms_norm(x, params["final_norm"]["w"])
    return L.unembed(params["emb"], x), torch.zeros((), device=x.device)


def init_cache(cfg: ModelConfig, batch: int, cache_len: int, dtype,
               device="cuda") -> Cache:
    """Zeroed decode state for ``batch`` sequences; O(1) in ``cache_len``."""
    del cache_len
    H, P, N = cfg.n_ssm_heads, cfg.ssm.head_dim, cfg.ssm.state_dim
    ch = cfg.d_inner + 2 * N
    return {
        "ssm": torch.zeros((cfg.n_layers, batch, H, P, N), dtype=torch.float32,
                           device=device),
        "conv": torch.zeros((cfg.n_layers, batch, cfg.ssm.conv_width - 1, ch),
                            dtype=dtype, device=device),
        "pos": torch.zeros((batch,), dtype=torch.int32, device=device),
    }


def prefill(cfg: ModelConfig, params: Params, tokens: torch.Tensor, *,
            cache_len: Optional[int] = None, past_cache: Optional[Cache] = None,
            dtype=None) -> Tuple[torch.Tensor, Cache]:
    """Run the prompt; return last-position logits and the decode cache.

    ``cache_len`` is accepted for the unified API and unused: the state does
    not grow with the context. A prompt shorter than ``conv_width - 1``
    gives a ``conv`` of that many rows, as the reference's does. Continuing
    from a ``past_cache`` (chunked prefill) is not ported.
    """
    del cache_len
    if past_cache is not None:
        raise NotImplementedError(
            "chunked prefill (past_cache) of the ssm family is not ported to "
            "repro_torch (the reference engine does not chunk this family "
            "either)")
    dtype = dtype or getattr(torch, cfg.dtype)
    B, S = tokens.shape
    x = L.embed(params["emb"], tokens)
    hs, convs = [], []
    for i in range(cfg.n_layers):
        x, h, conv = mamba_forward(cfg, L.layer_params(params["layers"], i), x)
        hs.append(h)
        convs.append(conv.to(dtype))
    x = L.rms_norm(x, params["final_norm"]["w"])
    logits = L.unembed(params["emb"], x[:, -1:])[:, 0]
    cache = {"ssm": torch.stack(hs), "conv": torch.stack(convs),
             "pos": torch.full((B,), S, dtype=torch.int32, device=x.device)}
    return logits, cache


def decode_step(cfg: ModelConfig, params: Params, tokens: torch.Tensor,
                cache: Cache, active: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Cache]:
    """One decode step. tokens (B,1) -> logits (B,V) and the cache with
    ``pos`` advanced. ``ssm`` and ``conv`` are updated IN PLACE (the returned
    cache shares them with the one passed in): a copy per step would move the
    whole state pool.

    ``active`` (B,) bool marks the rows that hold a sequence (default: all).
    An inactive row keeps its ``pos``; its ``ssm`` and ``conv`` rows are
    updated like the others, as the reference engine updates its free slots.
    Rows are independent, so the active rows' logits do not depend on it, and
    a slot's state is overwritten on admission, except the conv rows past a
    short prompt's, which keep what the slot held, as in the reference.
    """
    x = L.embed(params["emb"], tokens)
    for i in range(cfg.n_layers):
        x, _, conv = mamba_decode(cfg, L.layer_params(params["layers"], i), x,
                                  cache["ssm"][i], cache["conv"][i])
        cache["conv"][i] = conv
    x = L.rms_norm(x, params["final_norm"]["w"])
    logits = L.unembed(params["emb"], x)[:, 0]
    pos = cache["pos"]
    step = 1 if active is None else active.to(pos.dtype)
    return logits, dict(cache, pos=pos + step)


def write_slot(cache: Cache, slot: int, sub: Cache) -> None:
    """Write a batch-of-1 cache into row ``slot`` (``pos`` is left to the
    caller). A ``conv`` of fewer rows than the pool's (a prompt shorter than
    ``conv_width - 1``) goes to the slot's FIRST rows and leaves the rest as
    they were, as the reference engine writes it."""
    cache["ssm"][:, slot] = sub["ssm"][:, 0]
    rows = sub["conv"].shape[2]
    cache["conv"][:, slot, :rows] = sub["conv"][:, 0]


def read_slot(cache: Cache, slot: int, length: int) -> Cache:
    """Row ``slot`` as a batch-of-1 cache on the host, copied (a ``.cpu()``
    of a CPU pool would be a view that the next admission overwrites)."""
    out = {key: cache[key][:, slot:slot + 1].to("cpu", copy=True)
           for key in ("ssm", "conv")}
    out["pos"] = torch.tensor([length], dtype=torch.int32)
    return out
