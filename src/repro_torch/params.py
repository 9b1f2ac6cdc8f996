"""Carries parameters and caches of the reference package over to the port.

The reference's pytrees arrive as nested dicts of ``numpy`` arrays (the
caller converts them: this package imports neither the reference nor its
framework). The port stacks parameters over layers exactly as the reference
does, so parameters map one to one (a VLM's tree is the dense one, an MoE
layer's ``moe`` subtree keeps its float32 router, an audio model's tree is
the reference's encoder-decoder one); a dense cache changes format, from
the reference's ``(L, B, S, Hkv, D)`` slots (a ring of them with a sliding
window) to the port's page pools, which hold every position in order, an
ssm cache keeps its own, a hybrid cache does both, and an audio cache also
carries its encoder K/V over into a cross pool.

On a device mesh a rank holds its shards: ``shard_params`` takes a rank's
slices of a global parameter tree (from ``from_reference`` or
``Model.init``) by the specs of ``launch/shardings.py``; ``init_shard``
draws the same parameters as ``Model.init`` from the same generator but
keeps only the rank's slices, one layer at a time, so that a rank on a card
never holds the whole tree. A rank's cache is the one its sharded prefill
writes (``launch/steps.py``). A rank's AdamW state holds its blocks of the
moments by ``shardings.opt_shardings`` (``init_opt_shard``), and
``gather_params`` / ``gather_opt_state`` take the ranks' shards back to the
global trees (the tests' and the smoke run's comparisons; no step needs
them).
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs.base import ModelConfig
from repro_torch.launch import shardings as sh
from repro_torch.launch.mesh import mesh_axis_sizes
from repro_torch.models import layers, transformer
from repro_torch.models.api import Model, resolve_device
from repro_torch.models.transformer import cache_rows
from repro_torch.training.optimizer import AdamWState, adamw_init


def _tensor(a, device, dtype) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":      # no numpy-native bfloat16 for torch
        a = a.astype(np.float32)
    t = torch.from_numpy(np.array(a))     # a copy: jax hands out read-only views
    if t.is_floating_point():
        t = t.to(dtype)
    return t.to(device)


# the SSM's decay, skip and step-bias parameters and the MoE router stay
# float32 in every model dtype, as in the reference
_FLOAT32_KEYS = ("A_log", "D", "dt_bias", "router")


def _convert(tree, device, dtype):
    if isinstance(tree, dict):
        return {k: _convert(v, device, torch.float32 if k in _FLOAT32_KEYS else dtype)
                for k, v in tree.items()}
    return _tensor(tree, device, dtype)


def from_reference(params_numpy: Dict[str, Any], cfg: ModelConfig,
                   device="cuda", dtype=torch.float32) -> Dict[str, Any]:
    """The reference's parameter pytree (as numpy arrays) -> the port's
    parameters on ``device`` in ``dtype``."""
    device = resolve_device(device)
    if cfg.arch_type not in ("dense", "vlm", "moe", "ssm", "hybrid", "audio"):
        raise KeyError(f"unknown arch_type {cfg.arch_type!r}")
    params = _convert(params_numpy, device, dtype)
    checks = []
    if cfg.arch_type in ("dense", "vlm", "moe"):
        checks.append(("wq", params["layers"]["attn"]["wq"],
                       (cfg.n_layers, cfg.d_model, cfg.n_heads * cfg.resolved_head_dim)))
    if cfg.arch_type == "moe":
        m = cfg.moe
        checks.append(("moe.w_gate", params["layers"]["moe"]["w_gate"],
                       (cfg.n_layers, m.n_experts, cfg.d_model, m.d_ff)))
    if cfg.arch_type in ("ssm", "hybrid"):
        checks.append(("w_in", params["layers"]["w_in"],
                       (cfg.n_layers, cfg.d_model,
                        2 * cfg.d_inner + 2 * cfg.ssm.state_dim + cfg.n_ssm_heads)))
    if cfg.arch_type == "audio":
        checks.append(("dec_layers.self_attn.wq", params["dec_layers"]["self_attn"]["wq"],
                       (cfg.n_layers, cfg.d_model, cfg.n_heads * cfg.resolved_head_dim)))
        checks.append(("enc_pos", params["enc_pos"], (cfg.enc_seq, cfg.d_model)))
    if cfg.arch_type == "hybrid":
        checks.append(("shared.attn.wq", params["shared"]["attn"]["wq"],
                       (cfg.d_model, cfg.n_heads * cfg.resolved_head_dim)))
    for name, w, want in checks:
        if tuple(w.shape) != want:
            raise ValueError(f"parameters do not fit {cfg.name}: {name} has shape "
                             f"{tuple(w.shape)}, expected {want}")
    return params


def cache_from_reference(cache_numpy: Dict[str, Any], cfg: ModelConfig,
                         device="cuda", dtype=torch.float32) -> Dict[str, torch.Tensor]:
    """The reference's decode cache -> the port's. A dense cache (``k``/``v``
    (L, B, S, Hkv, D), ``slot_pos`` (B, S), ``pos`` (B,)) becomes a paged
    cache for ``decode_step`` of capacity S or, for a sliding window's ring,
    of the latest position held plus S (room for a ring's worth of decode
    steps). Each slot's K/V goes to the position its
    ``slot_pos`` names (-1: empty); a ring's slots are so unrolled into
    position order, and the positions the ring no longer holds stay zero,
    below the window that decode attends over. An ssm cache (``ssm``
    float32, ``conv`` in ``dtype``, ``pos``) is carried over unchanged. A
    hybrid cache is both: its ``ssm`` and ``conv`` unchanged, the K/V of
    each of its G shared-block calls (``k``/``v`` (G, B, S, Hkv, D)) into
    page pools as a dense cache's. An audio cache is a dense one plus its
    encoder K/V (``cross_k``/``cross_v`` (L, B, enc_seq, Hkv, D)), which go
    into the cross pool of ``enc_seq`` positions a row."""
    device = resolve_device(device)
    cache = {"pos": _tensor(cache_numpy["pos"], device, dtype).to(torch.int32)}
    if cfg.arch_type in ("ssm", "hybrid"):
        cache["ssm"] = _tensor(cache_numpy["ssm"], device, torch.float32)
        cache["conv"] = _tensor(cache_numpy["conv"], device, dtype)
    if cfg.arch_type == "ssm":
        return cache
    k = _tensor(cache_numpy["k"], device, dtype)
    v = _tensor(cache_numpy["v"], device, dtype)
    n_pools, B, S, _, _ = k.shape
    slot_pos = np.asarray(cache_numpy["slot_pos"])
    cache_len = S if cfg.sliding_window == 0 else int(slot_pos.max()) + 1 + S
    cache.update(layers.init_kv_cache(cfg, B, cache_len, n_pools, dtype, device))
    for b in range(B):
        held = np.nonzero(slot_pos[b] >= 0)[0]
        where = torch.from_numpy(slot_pos[b][held].astype(np.int64)).to(device)
        slots = torch.from_numpy(held).to(device)
        cache_rows(cache, "k", b)[:, where] = k[:, b, slots]
        cache_rows(cache, "v", b)[:, where] = v[:, b, slots]
    if cfg.arch_type == "audio":
        cross = layers.init_kv_cache(cfg, B, cfg.enc_seq, n_pools, dtype, device)
        cache.update({"cross_k": cross["k"], "cross_v": cross["v"],
                      "cross_block_tables": cross["block_tables"]})
        for key in ("cross_k", "cross_v"):
            t = _tensor(cache_numpy[key], device, dtype)
            for b in range(B):
                cache_rows(cache, key, b, table="cross_block_tables")[:, :t.shape[2]] = \
                    t[:, b]
    return cache


# ------------------------------------------------------------ on a mesh


def _slice(t: torch.Tensor, spec, sizes, coords) -> torch.Tensor:
    """The shard of ``t`` at ``coords``, in storage of its own."""
    return t[sh.shard_slices(spec, tuple(t.shape), sizes, coords)].clone()


def shard_params(params: Dict[str, Any], mesh, coords: Dict[str, int]) -> Dict[str, Any]:
    """The shards of a global parameter tree that the device at ``coords``
    (an index on each axis of ``mesh``) holds, by ``shardings.param_spec``."""
    sizes = mesh_axis_sizes(mesh)
    msize = sizes["model"]
    return sh.map_with_path(
        lambda path, t: _slice(t, sh.param_spec(path, tuple(t.shape), msize), sizes,
                               coords), params)


def init_shard(cfg: ModelConfig, gen: torch.Generator, mesh, coords: Dict[str, int],
               dtype=None, device="cuda") -> Dict[str, Any]:
    """``shard_params(Model(cfg).init(gen, dtype, device), mesh, coords)``
    without the whole tree: ``transformer.init_params``'s draws, each
    subtree cut to its shards as soon as it is drawn (a layer by the spec of
    its stacked ``(L, ...)`` tensor). The transformer family's arms."""
    sizes = mesh_axis_sizes(mesh)

    def cut(key, tree):
        lead = (cfg.n_layers,) if key == "layers" else ()

        def leaf(path, t):
            spec = sh.param_spec((key,) + path, lead + tuple(t.shape), sizes["model"])
            return _slice(t, spec[len(lead):], sizes, coords)
        return sh.map_with_path(leaf, tree)

    return transformer.init_params(cfg, gen, dtype, resolve_device(device), cut=cut)


def global_specs(cfg: ModelConfig, mesh, *, zero: bool = False):
    """``(params, param_specs, opt_specs)``: ``cfg``'s global parameter tree
    on the meta device, each leaf's spec (``shardings.param_shardings``) and
    the AdamW state's (``shardings.opt_shardings``; ``zero``: ZeRO-1, each
    moment also cut over ``data``)."""
    params = Model(cfg).init(torch.Generator(), device="meta")
    p_sh = sh.param_shardings(mesh, params)
    return params, p_sh, sh.opt_shardings(mesh, adamw_init(params), p_sh, zero=zero)


def _zip_tree(fn, specs, tree):
    if isinstance(tree, dict):
        return {k: _zip_tree(fn, specs[k], v) for k, v in tree.items()}
    return fn(specs, tree)


def init_opt_shard(cfg: ModelConfig, mesh, *, zero: bool = False,
                   device="cuda") -> AdamWState:
    """A rank's blocks of ``adamw_init`` of ``cfg``'s parameters by
    ``shardings.opt_shardings`` (``zero``: ZeRO-1), without the global
    tree: zero float32 moments of the shape of a rank's blocks (every rank's
    blocks have one shape)."""
    device = resolve_device(device)
    params, _, o_sh = global_specs(cfg, mesh, zero=zero)
    sizes = mesh_axis_sizes(mesh)

    def zeros(spec, t):
        return torch.zeros(sh.local_shape(spec, tuple(t.shape), sizes), dtype=torch.float32,
                           device=device)
    return AdamWState(torch.zeros((), dtype=torch.int32, device=device),
                      _zip_tree(zeros, o_sh.mu, params), _zip_tree(zeros, o_sh.nu, params))


def gather_leaf(t: torch.Tensor, spec, mesh) -> torch.Tensor:
    """The global tensor whose shard under ``spec`` each rank of the live
    ``mesh`` holds as ``t``: an ``all_gather`` over each sharded axis, on
    every rank."""
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        for axis in reversed((entry,) if isinstance(entry, str) else tuple(entry)):
            group = mesh.get_group(axis)
            parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
            dist.all_gather(parts, t.contiguous(), group=group)
            t = torch.cat(parts, dim=dim)
    return t


def gather_params(params: Dict[str, Any], cfg: ModelConfig, mesh) -> Dict[str, Any]:
    """The global parameter tree from each rank's shards (``shard_params``'s
    inverse), on every rank of the live ``mesh``."""
    _, p_sh, _ = global_specs(cfg, mesh)
    return _zip_tree(lambda spec, t: gather_leaf(t, spec, mesh), p_sh, params)


def gather_opt_state(state: AdamWState, cfg: ModelConfig, mesh, *,
                     zero: bool = False) -> AdamWState:
    """The global AdamW state from each rank's blocks (``init_opt_shard``'s
    layout), on every rank of the live ``mesh``."""
    _, _, o_sh = global_specs(cfg, mesh, zero=zero)

    def gather(spec, t):
        return gather_leaf(t, spec, mesh)
    return AdamWState(state.step.clone(), _zip_tree(gather, o_sh.mu, state.mu),
                      _zip_tree(gather, o_sh.nu, state.nu))
