"""Sharding rules: map every parameter, cache, batch and optimizer leaf to
a partition spec.

The port's copy of ``repro.launch.shardings``, the same policy with the same
divisibility fallbacks:

- tensor parallelism on the ``model`` axis: attention QKV/out projections,
  FFN in/out, MoE experts (f-sharded where ``d_ff`` divides the axis, else
  expert parallel), the vocabulary-sharded embedding and head, SSM inner
  channels;
- data parallelism on ``data`` (and ``pod`` where the mesh has one): the
  batch axis of inputs and caches;
- every rule checks divisibility and falls back to replication, so every
  (arch x shape x mesh) has a placement.

A spec is the tuple of the reference's ``PartitionSpec`` entries: ``None``
(replicated), an axis name, or a tuple of axis names (the batch over
``("pod", "data")``); ``()`` is fully replicated. A mesh is anything
``launch.mesh.mesh_axis_sizes`` reads: a ``MeshShape`` or a live
``DeviceMesh``.

The port's KV cache is a page pool ``(L, pages, page, Hkv, D)`` where the
reference keeps ``(L, B, S, Hkv, D)``, so ``cache_spec`` maps by meaning:
the KV heads go on ``model``; the batch axis becomes the pool's pages, which
a data rank's slots own (row ``i`` owns pages ``[i * pps, (i + 1) * pps)``);
the block tables go with their rows. The reference's sequence-sharded
fallback (KV heads that do not divide the axis) keeps its spec, and so its
bytes, on the positions within a page (where the page, too, divides the
axis); by meaning the sharded step holds it as round-robin pages: a row's
page ``p`` lives on model rank ``p mod m`` at the rank's local page ``p div
m``, every KV head whole (``seq_pages``, ``seq_place``,
``seq_local_length``, ``seq_positions``: the one map that the cache, the
prefill's and the decode's writes and the lengths read). A rank's valid
positions are then a prefix of its local pages, a page stays 16 positions
(the kernel's), and the map does not depend on the pool's length, so a row
copies between pools page for page. A row of ``pages`` pages takes
``ceil(pages / m)`` pages on every rank: where ``m`` does not divide
``pages`` that rounds it up (ROADMAP.md, Departures).

A sliding window's pool is a ring (``models/layers.py``): position ``q`` of
a row lives at ring page ``(q // page) mod P`` of its ``P`` pages, the
reference's ``slot = pos % S`` at page granularity. On ``m`` ranks the ring
is the ``m * L`` pages that the rank's ``L = ceil(P / m)`` local pages a
row make up, each rank's pages round-robin by ring page as above: page
``p = q // page`` lives on rank ``p mod m`` at local page ``(p div m) mod
L`` (``seq_place(..., ring=L)``), so a rank's pages form a ring of their
own, of its ``L`` local pages, and ``seq_local_length`` still counts its
positions in order, the ring unrolled.

The rules here stay the reference's. The sharded step holds the Mamba2
leaves (``w_in``, the conv's ``conv_w`` / ``conv_b``, ``norm_w``) and the
``conv`` cache by the port's rank layout instead (``params.ssm_layout``:
whole heads a rank, B and C whole), where these rules cut contiguous
blocks that are not one rank's heads (ROADMAP.md, Departures).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple, Union

import torch

from repro_torch.launch.mesh import mesh_axis_sizes
from repro_torch.training.optimizer import AdamWState

Entry = Union[None, str, Tuple[str, ...]]
Spec = Tuple[Entry, ...]


def batch_axes(mesh) -> Tuple[str, ...]:
    return ("pod", "data") if "pod" in mesh_axis_sizes(mesh) else ("data",)


def _batch_spec_axis(mesh, b: int) -> Entry:
    """Largest prefix of the batch axes that divides b (else None)."""
    sizes = mesh_axis_sizes(mesh)
    axes = batch_axes(mesh)
    total = 1
    for a in axes:
        total *= sizes[a]
    if b % total == 0:
        return axes if len(axes) > 1 else axes[0]
    if b % sizes["data"] == 0:
        return "data"
    return None


def _div(shape, dim: int, size: int) -> bool:
    return 0 <= dim < len(shape) and shape[dim] % size == 0


def param_spec(names: Tuple[str, ...], shape: Tuple[int, ...], msize: int) -> Spec:
    """Spec of one parameter leaf (model-axis tensor parallelism only)."""
    def spec_at(dim: int) -> Spec:
        dim = dim % len(shape)
        if not _div(shape, dim, msize):
            return ()
        out: list = [None] * len(shape)
        out[dim] = "model"
        return tuple(out)

    name = names[-1] if names else ""
    if "moe" in names and len(shape) == 4:            # (L, E, d, f) experts
        # f-sharded tensor parallelism; expert parallel where f does not divide
        dim = -1 if name in ("w_gate", "w_up") else -2
        if _div(shape, dim % len(shape), msize):
            return spec_at(dim)
        return spec_at(1)
    if name in ("wq", "wk", "wv", "w_gate", "w_up", "w_in"):
        return spec_at(-1)
    if name in ("wo", "w_down", "w_out"):
        return spec_at(-2)
    if name == "router":
        return spec_at(-1)
    if name == "tok":
        return spec_at(0)                             # vocab-sharded embedding
    if name == "head":
        return spec_at(-1)                            # vocab-sharded logits
    if name == "conv_w":
        return spec_at(-1)
    if name in ("A_log", "D", "dt_bias"):
        return spec_at(-1)
    return ()                                         # norms, biases, pos-emb


def cache_spec(key: str, shape: Tuple[int, ...], mesh, batch: int,
               positions: Optional[int] = None) -> Spec:
    """Spec of one leaf of the port's cache (see the module docstring).
    ``positions``: the positions a row of a pool holds, which the
    reference's sequence-sharded fallback asks to divide the model axis
    (default: the row's pages times the page; a cross pool holds the
    encoder's ``enc_seq``, fewer where it is not a whole number of pages)."""
    msize = mesh_axis_sizes(mesh)["model"]
    baxis = _batch_spec_axis(mesh, batch)
    if key == "pos":
        return (baxis,)
    if key in ("block_tables", "cross_block_tables"):
        return (baxis, None)
    out: list = [None] * len(shape)
    out[1] = baxis                                    # (L/G, B or pages, ...)
    if key in ("k", "v", "cross_k", "cross_v"):
        if _div(shape, 3, msize):
            out[3] = "model"                          # kv heads
        elif _div(shape, 2, msize) and \
                (positions or shape[1] // batch * shape[2]) % msize == 0:
            out[2] = "model"                          # sequence (round-robin pages)
        elif _div(shape, 4, msize):
            out[4] = "model"                          # head_dim fallback
    elif key == "ssm":
        if _div(shape, 2, msize):
            out[2] = "model"                          # SSM heads
        elif _div(shape, 3, msize):
            out[3] = "model"
    elif key == "conv":
        if _div(shape, 3, msize):
            out[3] = "model"                          # conv channels
    return tuple(out)


# ------------------------------------------------- the sequence-sharded KV pool
# (the module docstring): page p of a row on model rank p mod m, local page
# p div m. Each function takes ints or integer tensors alike.


def seq_pages(pages: int, m: int) -> int:
    """The pages a row of ``pages`` holds on each of ``m`` model ranks."""
    return -(-pages // m)


def seq_place(pos, m: int, page: int, ring: int = 0):
    """``(owner, local_page, offset)`` of position ``pos`` of a row: the
    model rank that holds it, its page in that rank's pages of the row, and
    its place within the page. ``ring``: a rank's local pages a row where
    they form a ring (a sliding window's pool), which the local page then
    wraps around; 0 for a pool that holds every position."""
    p = pos // page
    local = p // m
    return p % m, local % ring if ring else local, pos % page


def seq_local_length(length, r: int, m: int, page: int):
    """How many of a row's first ``length`` positions model rank ``r`` of
    ``m`` holds: a prefix of its local pages, so this is also the length to
    attend over in them."""
    full = length // page
    whole = (full - r + m - 1) // m            # full pages p < full with p % m == r
    return page * whole + (full % m == r) * (length % page)


def seq_positions(r: int, m: int, local_pages: int, page: int, device=None):
    """The positions of model rank ``r``'s ``local_pages`` pages of a row,
    in local order (a tensor of ``local_pages * page``)."""
    j = torch.arange(local_pages * page, device=device)
    return ((j // page) * m + r) * page + j % page


# ------------------------------------------------------------------ trees


def map_with_path(fn: Callable, node: Any, path: Tuple[str, ...] = ()) -> Any:
    """``fn(path, leaf)`` over a tree of dicts and NamedTuples; a path holds
    the dict keys and field names down to the leaf."""
    if isinstance(node, dict):
        return {k: map_with_path(fn, v, path + (str(k),)) for k, v in node.items()}
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return type(node)(*(map_with_path(fn, v, path + (f,))
                            for f, v in zip(node._fields, node)))
    return fn(path, node)


def param_shardings(mesh, params) -> Any:
    msize = mesh_axis_sizes(mesh)["model"]
    return map_with_path(lambda path, t: param_spec(path, tuple(t.shape), msize),
                         params)


def cache_shardings(mesh, cache, batch: int,
                    positions: Optional[Dict[str, int]] = None) -> Any:
    """Specs of a cache's leaves; ``positions``: ``cache_spec``'s, by key."""
    positions = positions or {}
    return map_with_path(lambda path, t: cache_spec(path[-1], tuple(t.shape), mesh,
                                                    batch, positions.get(path[-1])),
                         cache)


def batch_shardings(mesh, batch) -> Any:
    def leaf(_path, t):
        return (_batch_spec_axis(mesh, t.shape[0]),) + (None,) * (t.dim() - 1)
    return map_with_path(leaf, batch)


def opt_shardings(mesh, opt_state: AdamWState, param_sh, *,
                  zero: bool = False) -> AdamWState:
    """AdamW's state: the moments follow the parameters, the step is
    replicated. ``zero=True`` (ZeRO-1) also shards each moment over the data
    axis, on its largest dimension that is unsharded and divisible."""
    if not zero:
        return AdamWState((), param_sh, param_sh)
    dsize = mesh_axis_sizes(mesh)["data"]

    def zero_leaf(spec: Spec, shape) -> Spec:
        spec = list(spec) + [None] * (len(shape) - len(spec))
        cands = [(shape[i], i) for i in range(len(shape))
                 if spec[i] is None and shape[i] % dsize == 0]
        if cands:
            _, dim = max(cands)
            spec[dim] = "data"
        return tuple(spec)

    mom_sh = _zip_map(zero_leaf, param_sh, opt_state.mu)
    return AdamWState((), mom_sh, mom_sh)


def _zip_map(fn: Callable, specs: Any, tensors: Any) -> Any:
    if isinstance(tensors, dict):
        return {k: _zip_map(fn, specs[k], v) for k, v in tensors.items()}
    return fn(specs, tuple(tensors.shape))


def logits_sharding(mesh, batch: int, vocab: int) -> Spec:
    msize = mesh_axis_sizes(mesh)["model"]
    return (_batch_spec_axis(mesh, batch), "model" if vocab % msize == 0 else None)


# ------------------------------------------------------------------ shards


def _entry_axes(entry: Entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def local_shape(spec: Spec, shape: Tuple[int, ...], sizes: Dict[str, int]
                ) -> Tuple[int, ...]:
    """The shape of one device's shard of a leaf of ``shape`` under
    ``spec`` on a mesh of axis ``sizes``."""
    out = list(shape)
    for dim, entry in enumerate(spec):
        n = 1
        for axis in _entry_axes(entry):
            n *= sizes[axis]
        if out[dim] % n:
            raise ValueError(f"spec {spec} does not divide shape {tuple(shape)}")
        out[dim] //= n
    return tuple(out)


def shard_index(entry: Entry, sizes: Dict[str, int], coords: Dict[str, int]
                ) -> Tuple[int, int]:
    """(index, count): which of the ``count`` equal blocks of a dimension
    sharded on ``entry`` the device at ``coords`` holds (row-major over a
    tuple of axes, as a ``PartitionSpec`` lays them out)."""
    index, count = 0, 1
    for axis in _entry_axes(entry):
        index = index * sizes[axis] + coords.get(axis, 0)
        count *= sizes[axis]
    return index, count


def shard_slices(spec: Spec, shape: Tuple[int, ...], sizes: Dict[str, int],
                 coords: Dict[str, int]) -> Tuple[slice, ...]:
    """The slice of each dimension that the device at ``coords`` holds."""
    local = local_shape(spec, shape, sizes)
    out = []
    for dim, n in enumerate(local):
        entry = spec[dim] if dim < len(spec) else None
        index, _ = shard_index(entry, sizes, coords)
        out.append(slice(index * n, (index + 1) * n))
    return tuple(out)
