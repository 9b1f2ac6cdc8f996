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
``Model.init``) by the specs of ``launch/shardings.py``, and a Mamba2
leaf's by its rank layout (``ssm_layout``: whole heads, B and C whole);
``init_shard`` draws the same parameters as ``Model.init`` from the same
generator but keeps only the rank's slices, one layer at a time, so that a
rank on a card never holds the whole tree. ``rank_leaves`` says how a rank
holds each leaf, for every consumer of the layout (the train step's norm
and ZeRO-1 blocks, the dry run's bytes). A rank's cache is the one its
sharded prefill writes (``launch/steps.py``). A rank's AdamW state holds
its blocks of the moments, the shape of its pieces cut over ``data`` by
ZeRO-1 (``init_opt_shard``), and ``gather_params`` / ``gather_opt_state``
take the ranks' shards back to the global trees (the tests' and the smoke
run's comparisons; no step needs them).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.launch import shardings as sh
from repro_torch.launch.mesh import mesh_axis_sizes
from repro_torch.models import encdec, hybrid, layers, mamba_model, transformer
from repro_torch.models.api import Model, resolve_device
from repro_torch.models.transformer import cache_rows
from repro_torch.training import tree
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
    cache for ``decode_step`` of capacity S: for a sliding window a ring of
    ``ceil(S / page)`` pages a row (``models/layers.py``), as the reference's
    is a ring of S slots. Each slot's K/V goes to the place of the position
    its ``slot_pos`` names (-1: empty): that position itself, or its ring
    page and offset. A ring of S slots shorter than the window where the
    page does not divide S raises ``ValueError``: the port's ring of whole
    pages attends over up to ``page - 1`` positions more than the
    reference's S, which the reference's cache does not hold (ROADMAP.md,
    Departures). An ssm cache (``ssm``
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
    slot_pos = np.asarray(cache_numpy["slot_pos"]).astype(np.int64)
    page = ops.DEFAULT_PAGE_SIZE
    if 0 < S < cfg.sliding_window and S % page:
        raise ValueError(f"a ring of {S} slots, shorter than the window of "
                         f"{cfg.sliding_window}, is not a whole number of pages of "
                         f"{page}: the port's ring would attend over positions the "
                         "reference's does not hold")
    cache.update(layers.init_kv_cache(cfg, B, S, n_pools, dtype, device))
    ring = cache["block_tables"].shape[1] if cfg.sliding_window > 0 else 0
    for b in range(B):
        held = np.nonzero(slot_pos[b] >= 0)[0]
        q = slot_pos[b][held]
        if ring:   # the position's ring page and offset
            q = (q // page) % ring * page + q % page
        where = torch.from_numpy(q).to(device)
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

# A rank's Mamba2 leaves. The fused ``w_in`` holds the columns [z | x | B |
# C | dt] and the conv its channels [x | B | C]; the reference's rules cut
# both into contiguous blocks (``shardings.param_spec``, ``cache_spec``),
# which are not one rank's heads. A rank of the port's tensor-parallel step
# holds whole heads instead: its z, x and dt columns, its heads' ``A_log``,
# ``D``, ``dt_bias``, its ``d_inner / m`` slice of ``norm_w`` and rows of
# ``w_out``, and B and C whole (the model has one group), in ``w_in``,
# ``conv_w``, ``conv_b`` and the ``conv`` cache alike (ROADMAP.md,
# Departures). A leaf's layout is the dimension it is cut on (counted from
# the end, so a layer drawn alone is cut as its stacked tensor) and that
# dimension's segments in order, each (width, sharded): rank r holds the
# r-th block of width / m of a sharded segment and the whole of a
# replicated one.
Segments = Tuple[Tuple[int, bool], ...]


def ssm_layout(key: str, d_inner: int, state_dim: int, heads: int
               ) -> Optional[Tuple[int, Segments]]:
    """The rank layout of the Mamba2 leaf or cache entry ``key`` of a model
    of SSM width ``d_inner``, state ``state_dim`` and ``heads`` SSM heads
    (see above); None for a leaf the reference's rules place."""
    di, N, H = d_inner, state_dim, heads
    xbc = ((di, True), (2 * N, False))
    return {"w_in": (-1, ((di, True), (di, True), (2 * N, False), (H, True))),
            "conv_w": (-1, xbc), "conv_b": (-1, xbc), "conv": (-1, xbc),
            "A_log": (-1, ((H, True),)), "D": (-1, ((H, True),)),
            "dt_bias": (-1, ((H, True),)), "norm_w": (-1, ((di, True),)),
            "w_out": (-2, ((di, True),)), "ssm": (-3, ((H, True),))}.get(key)


def _cfg_layout(cfg: ModelConfig, path: Tuple[str, ...]) -> Optional[Tuple[int, Segments]]:
    """The rank layout of the parameter at ``path`` of ``cfg``'s global tree
    (a Mamba2 leaf of ``layers``), or None."""
    if cfg.arch_type not in ("ssm", "hybrid") or not path or path[0] != "layers":
        return None
    return ssm_layout(path[-1], cfg.d_inner, cfg.ssm.state_dim, cfg.n_ssm_heads)


def _tree_layouts(params: Dict[str, Any]):
    """``_cfg_layout`` read off a global parameter tree's own shapes: its
    Mamba2 widths from ``norm_w`` (d_inner), ``A_log`` (heads) and
    ``w_in``'s columns (2 d_inner + 2 N + heads)."""
    lay = params.get("layers", {})
    if "w_in" not in lay:
        return lambda path: None
    di, H = lay["norm_w"].shape[-1], lay["A_log"].shape[-1]
    N = (lay["w_in"].shape[-1] - 2 * di - H) // 2
    return lambda path: ssm_layout(path[-1], di, N, H) if path[0] == "layers" else None


def _rank_width(segments: Segments, m: int) -> int:
    return sum(w // m if cut else w for w, cut in segments)


def layout_cut(t: torch.Tensor, layout: Tuple[int, Segments], m: int, r: int) -> torch.Tensor:
    """Rank ``r``'s piece of ``t`` under ``layout`` on a model axis of ``m``,
    in storage of its own."""
    dim, segments = layout
    pieces, start = [], 0
    for width, cut in segments:
        n = width // m if cut else width
        pieces.append(t.narrow(dim, start + r * n if cut else start, n))
        start += width
    return torch.cat(pieces, dim)


def layout_join(parts, layout: Tuple[int, Segments]) -> torch.Tensor:
    """The global tensor from every rank's piece under ``layout``, in rank
    order (``layout_cut``'s inverse)."""
    dim, segments = layout
    m = len(parts)
    out, start = [], 0
    for width, cut in segments:
        n = width // m if cut else width
        out += [p.narrow(dim, start, n) for p in (parts if cut else parts[:1])]
        start += n
    return torch.cat(out, dim)


def layout_split(t: torch.Tensor, layout: Tuple[int, Segments], m: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """A rank's piece ``t`` as (its sharded elements, its replicated ones),
    each flattened: a sum over the ranks counts the first once a rank and
    the second once."""
    dim, segments = layout
    cut_parts, whole_parts, start = [], [], 0
    for width, cut in segments:
        n = width // m if cut else width
        (cut_parts if cut else whole_parts).append(t.narrow(dim, start, n).reshape(-1))
        start += n
    empty = t.new_zeros((0,))
    return (torch.cat(cut_parts) if cut_parts else empty,
            torch.cat(whole_parts) if whole_parts else empty)


def _slice(t: torch.Tensor, spec, sizes, coords) -> torch.Tensor:
    """The shard of ``t`` at ``coords``, in storage of its own."""
    return t[sh.shard_slices(spec, tuple(t.shape), sizes, coords)].clone()


def shard_params(params: Dict[str, Any], mesh, coords: Dict[str, int]) -> Dict[str, Any]:
    """The shards of a global parameter tree that the device at ``coords``
    (an index on each axis of ``mesh``) holds: a Mamba2 leaf's by its rank
    layout (``ssm_layout``), every other leaf's by
    ``shardings.param_spec``."""
    sizes = mesh_axis_sizes(mesh)
    msize = sizes["model"]
    layout_of = _tree_layouts(params)

    def leaf(path, t):
        layout = layout_of(path)
        if layout is not None:
            return layout_cut(t, layout, msize, coords.get("model", 0))
        return _slice(t, sh.param_spec(path, tuple(t.shape), msize), sizes, coords)
    return sh.map_with_path(leaf, params)


_INIT = {"dense": transformer, "vlm": transformer, "moe": transformer,
         "ssm": mamba_model, "hybrid": hybrid, "audio": encdec}


def init_shard(cfg: ModelConfig, gen: torch.Generator, mesh, coords: Dict[str, int],
               dtype=None, device="cuda") -> Dict[str, Any]:
    """``shard_params(Model(cfg).init(gen, dtype, device), mesh, coords)``
    without the whole tree: the family's ``init_params`` draws, each
    subtree cut to its shards as soon as it is drawn (a layer by the spec or
    the rank layout of its stacked ``(L, ...)`` tensor)."""
    sizes = mesh_axis_sizes(mesh)
    leads = {"layers": cfg.n_layers, "dec_layers": cfg.n_layers,
             "enc_layers": cfg.n_enc_layers}

    def cut(key, tree):
        lead = (leads[key],) if key in leads else ()

        def leaf(path, t):
            layout = _cfg_layout(cfg, (key,) + path)
            if layout is not None:
                return layout_cut(t, layout, sizes["model"], coords.get("model", 0))
            spec = sh.param_spec((key,) + path, lead + tuple(t.shape), sizes["model"])
            return _slice(t, spec[len(lead):], sizes, coords)
        return sh.map_with_path(leaf, tree)

    return _INIT[cfg.arch_type].init_params(cfg, gen, dtype, resolve_device(device), cut=cut)


def global_specs(cfg: ModelConfig, mesh, *, zero: bool = False):
    """``(params, param_specs, opt_specs)``: ``cfg``'s global parameter tree
    on the meta device, each leaf's spec (``shardings.param_shardings``) and
    the AdamW state's (``shardings.opt_shardings``; ``zero``: ZeRO-1, each
    moment also cut over ``data``)."""
    params = Model(cfg).init(torch.Generator(), device="meta")
    p_sh = sh.param_shardings(mesh, params)
    return params, p_sh, sh.opt_shardings(mesh, adamw_init(params), p_sh, zero=zero)


@dataclass(frozen=True)
class RankLeaf:
    """How each rank of a mesh holds one leaf of the global parameter tree:
    ``spec``, the reference's (``shardings.param_spec``), or ``layout``, the
    rank layout of a Mamba2 leaf, which then decides; ``shape``, the rank's
    piece; ``zero_dim``, the dimension of that piece on which ZeRO-1 cuts
    its moments over ``data`` (None: every data rank keeps them whole);
    ``dtype``, the leaf's. Every rank's piece has one shape."""
    spec: sh.Spec
    layout: Optional[Tuple[int, Segments]]
    shape: Tuple[int, ...]
    zero_dim: Optional[int]
    dtype: torch.dtype

    @property
    def on_model(self) -> bool:
        """Whether the ranks of the model axis hold other pieces."""
        return self.layout is not None or "model" in self.spec


def rank_leaves(cfg: ModelConfig, mesh, *, zero: bool = False):
    """``(leaves, treedef)``: a ``RankLeaf`` for each leaf of ``cfg``'s
    global parameter tree in ``tree.flatten`` order, and the tree's
    structure. ZeRO-1 (``zero``) cuts a leaf the reference's rules place as
    ``shardings.opt_shardings`` does; a Mamba2 leaf on its piece's largest
    dimension, other than the layout's, that ``data`` divides."""
    params, p_sh, o_sh = global_specs(cfg, mesh, zero=zero)
    sizes = mesh_axis_sizes(mesh)
    m, dsize = sizes["model"], sizes["data"]
    paths = []
    sh.map_with_path(lambda path, _t: paths.append(path), params)
    flat, treedef = tree.flatten(params)
    out = []
    # tree.flatten walks every dict's keys sorted: the paths' sorted order
    for path, t, spec, mspec in zip(sorted(paths), flat, tree.leaves(p_sh),
                                    tree.leaves(o_sh.mu)):
        layout = _cfg_layout(cfg, path)
        if layout is None:
            shape = sh.local_shape(spec, tuple(t.shape), sizes)
            zd = next((i for i, e in enumerate(mspec) if e == "data"), None)
        else:
            dim = layout[0] % t.dim()
            shape = tuple(_rank_width(layout[1], m) if i == dim else n
                          for i, n in enumerate(t.shape))
            cands = [(n, i) for i, n in enumerate(shape) if i != dim and n % dsize == 0]
            zd = max(cands)[1] if zero and cands else None
        out.append(RankLeaf(spec, layout, shape, zd, t.dtype))
    return out, treedef


def rank_cache_shape(cfg: ModelConfig, key: str, spec_shape: Tuple[int, ...],
                     msize: int) -> Tuple[int, ...]:
    """The shape of a rank's ``key`` leaf of a cache whose shape under
    ``shardings.cache_spec`` is ``spec_shape``: the ``conv`` cache's
    channels by the rank layout, [x_r | B | C], every other leaf as the spec
    places it."""
    layout = ssm_layout(key, cfg.d_inner, cfg.ssm.state_dim, cfg.n_ssm_heads) \
        if cfg.arch_type in ("ssm", "hybrid") else None
    if layout is None:
        return spec_shape
    dim = layout[0] % len(spec_shape)
    return tuple(_rank_width(layout[1], msize) if i == dim else n
                 for i, n in enumerate(spec_shape))


def init_opt_shard(cfg: ModelConfig, mesh, *, zero: bool = False,
                   device="cuda") -> AdamWState:
    """A rank's blocks of ``adamw_init`` of ``cfg``'s parameters, without the
    global tree: zero float32 moments of the shape of the rank's piece of
    each leaf (``rank_leaves``), with ``zero`` (ZeRO-1) its data rank's block
    of it."""
    device = resolve_device(device)
    leaves, treedef = rank_leaves(cfg, mesh, zero=zero)
    dsize = mesh_axis_sizes(mesh)["data"]

    def zeros(rl: RankLeaf):
        shape = tuple(n // dsize if i == rl.zero_dim else n for i, n in enumerate(rl.shape))
        return torch.zeros(shape, dtype=torch.float32, device=device)
    return AdamWState(torch.zeros((), dtype=torch.int32, device=device),
                      tree.unflatten(treedef, [zeros(rl) for rl in leaves]),
                      tree.unflatten(treedef, [zeros(rl) for rl in leaves]))


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


def gather_rank_leaf(t: torch.Tensor, rl: RankLeaf, mesh, *,
                     zero_block: bool = False) -> torch.Tensor:
    """The global leaf from each rank's piece ``t`` of it (``zero_block``:
    each data rank's ZeRO-1 block of the piece), on every rank of the live
    ``mesh``."""
    if zero_block and rl.zero_dim is not None:
        t = gather_leaf(t, tuple("data" if i == rl.zero_dim else None
                                 for i in range(t.dim())), mesh)
    if rl.layout is None:
        return gather_leaf(t, rl.spec, mesh)
    group = mesh.get_group("model")
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t.contiguous(), group=group)
    return layout_join(parts, rl.layout)


def gather_params(params: Dict[str, Any], cfg: ModelConfig, mesh) -> Dict[str, Any]:
    """The global parameter tree from each rank's shards (``shard_params``'s
    inverse), on every rank of the live ``mesh``."""
    leaves, treedef = rank_leaves(cfg, mesh)
    return tree.unflatten(treedef, [gather_rank_leaf(t, rl, mesh)
                                    for t, rl in zip(tree.leaves(params), leaves)])


def gather_opt_state(state: AdamWState, cfg: ModelConfig, mesh, *,
                     zero: bool = False) -> AdamWState:
    """The global AdamW state from each rank's blocks (``init_opt_shard``'s
    layout), on every rank of the live ``mesh``."""
    leaves, treedef = rank_leaves(cfg, mesh, zero=zero)

    def gather(moments):
        return tree.unflatten(treedef, [
            gather_rank_leaf(t, rl, mesh, zero_block=True)
            for t, rl in zip(tree.leaves(moments), leaves)])
    return AdamWState(state.step.clone(), gather(state.mu), gather(state.nu))
