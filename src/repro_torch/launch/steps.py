"""The port's steps: the train, prefill and serve step functions, the input
specs of each step on the meta device, and the prefill and serve steps
sharded over a device mesh.

The counterpart of ``repro.launch.steps``. ``input_specs`` gives every input
of a step kind as tensors on ``torch.device("meta")``: shapes and dtypes
with no storage, as ``jax.eval_shape`` gives them to the reference, so the
dry run (``launch/dryrun.py``) can trace the full production configs
without allocating a byte. The step functions are eager closures over
``Model``; each runs on the device of the tensors it is given (the kernels
on a CUDA device, their plain versions on the CPU and on the meta device,
where nothing is computed). The train step takes its gradient with autograd
(through the ``flash_prefill`` and ``ssd_scan`` backward kernels on a CUDA
device) and applies AdamW.

``sharded_step`` is the counterpart of the reference's ``jit_step``: the
train, prefill and serve steps over a live mesh (``launch/mesh.py``), each
rank running ``Model(local_config(cfg, sizes))`` on its shards
(``launch/shardings.py``, ``params.shard_params``) with the layers'
collectives on the model axis (``models/runtime_flags.py``), and each data
rank taking its rows of the batch. The train step averages the gradients
over the batch axes, clips by the norm of the global tree and, with ZeRO-1,
updates each data rank's block of every moment and all-gathers the
parameters. It runs every family: a Mamba2 layer's rank holds whole heads
(``params.ssm_layout``), B and C whole on every rank. Where the model axis
splits the attention heads (``splits_heads``: the reference's production
axis of 16 over 8 KV heads), the dense, VLM and audio families' train,
prefill and decode steps run the reference's placement: the projections cut
mid-head, the KV pool (and an audio model's cross pool of encoder
positions) sharded over the sequence in round-robin pages
(``shardings.seq_place``; a sliding window's ring by ring page), the
decode's attention merged over the ranks by log-sum-exp
(``models/layers.py``).

A sliding window's pool is a ring of ``cache_len_for`` positions, as the
reference's cache is, so a windowed prefill step keeps the prompt's last
positions (zamba2-2.7b's window of 4096 at ``prefill_32k``) and the decode
state at ``long_500k`` is O(window). One departure: the port's pool of a
model without a window keeps every position, so internvl2-2b's prefill of
256 vision positions in front of 32768 tokens gets a pool of the prompt's
length, where the reference keeps the last ``cache_len_for`` positions
(``prefill_cache_len``; ROADMAP.md, Departures).
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.configs.base import InputShape, ModelConfig, RankConfig
from repro_torch.launch import shardings as sh
from repro_torch.launch.mesh import mesh_axis_sizes, mesh_coords
from repro_torch.models import Model, runtime_flags
from repro_torch.models.layers import all_reduce_sum
from repro_torch.params import gather_leaf, init_opt_shard, layout_split, rank_leaves
from repro_torch.training import tree
from repro_torch.training.optimizer import AdamWState, adamw_init, adamw_update

LONG_CONTEXT_WINDOW = 4096

META = torch.device("meta")


def resolve_config(cfg: ModelConfig, shape: InputShape) -> ModelConfig:
    """Shape-dependent config adjustments: at 500k-token decode every
    attention-bearing arch runs the sliding-window variant so decode state is
    O(window)."""
    if shape.name == "long_500k" and cfg.has_attention and \
            cfg.sliding_window == 0:
        cfg = cfg.with_(sliding_window=LONG_CONTEXT_WINDOW)
    return cfg


def cache_len_for(cfg: ModelConfig, shape: InputShape) -> int:
    if cfg.sliding_window > 0:
        return min(shape.seq_len, cfg.sliding_window)
    return shape.seq_len


def prefill_cache_len(cfg: ModelConfig, shape: InputShape) -> int:
    """The pool a prefill of ``shape`` writes: ``cache_len_for``, a ring
    with a sliding window; without one, the prompt's positions where they
    are more (a VLM's vision prefix counted; see the module docstring)."""
    if cfg.sliding_window > 0:
        return cache_len_for(cfg, shape)
    n_vis = cfg.n_vision_tokens if cfg.arch_type == "vlm" else 0
    return max(cache_len_for(cfg, shape), shape.seq_len + n_vis)


# ------------------------------------------------------------ input specs


def _token_spec(batch: int, seq: int) -> torch.Tensor:
    return torch.empty((batch, seq), dtype=torch.int32, device=META)


def batch_specs(cfg: ModelConfig, batch: int, seq: int) -> Dict[str, torch.Tensor]:
    dt = getattr(torch, cfg.dtype)
    out = {"tokens": _token_spec(batch, seq)}
    if cfg.arch_type == "audio":
        out["frames"] = torch.empty((batch, cfg.enc_seq, cfg.d_model), dtype=dt,
                                    device=META)
    if cfg.arch_type == "vlm":
        out["vision"] = torch.empty((batch, cfg.n_vision_tokens, cfg.d_model),
                                    dtype=dt, device=META)
    return out


def params_specs(cfg: ModelConfig) -> Any:
    # a generator cannot live on the meta device; a CPU one draws nothing
    # for meta tensors
    return Model(cfg).init(torch.Generator(), device=META)


def cache_specs(cfg: ModelConfig, batch: int, cache_len: int) -> Any:
    return Model(cfg).init_cache(batch, cache_len, device=META)


def input_specs(cfg: ModelConfig, shape: InputShape) -> Dict[str, Any]:
    """Every input of the step this shape runs, as meta tensors."""
    cfg = resolve_config(cfg, shape)
    p = params_specs(cfg)
    if shape.kind == "train":
        return {"params": p, "opt_state": adamw_init(p),
                "batch": batch_specs(cfg, shape.global_batch, shape.seq_len)}
    if shape.kind == "prefill":
        return {"params": p,
                "batch": batch_specs(cfg, shape.global_batch, shape.seq_len)}
    # decode: one token against a cache of seq_len
    return {"params": p,
            "tokens": _token_spec(shape.global_batch, 1),
            "cache": cache_specs(cfg, shape.global_batch, cache_len_for(cfg, shape))}


# ------------------------------------------------------------ step fns


def loss_and_grads(model: Model, params, batch: Dict[str, torch.Tensor], *,
                   remat: bool = False) -> Tuple[torch.Tensor, list]:
    """``Model.loss`` and its gradient by autograd, one tensor per leaf in
    ``tree.flatten`` order (zeros for a leaf the loss does not reach)."""
    flat, treedef = tree.flatten(params)
    flat = [p.detach().requires_grad_(True) for p in flat]
    with torch.enable_grad():
        loss = model.loss(tree.unflatten(treedef, flat), batch, remat=remat)
        grads = torch.autograd.grad(loss, flat, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(flat, grads)]
    return loss.detach(), grads


def make_train_step(cfg: ModelConfig, *, remat: bool = True, lr: float = 3e-4,
                    microbatch: int = 0):
    """Build ``train_step(params, opt_state, batch) -> (params, opt_state,
    {"loss", "grad_norm"})``. ``remat`` recomputes each layer in the
    backward pass (``torch.utils.checkpoint``). ``microbatch=M > 1`` splits
    the batch into M sequential microbatches and accumulates their gradients
    in float32, then divides by M, as the reference does; the loss is the
    microbatches' mean."""
    model = Model(cfg)

    def train_step(params, opt_state: AdamWState, batch: Dict[str, torch.Tensor]
                   ) -> Tuple[Any, AdamWState, Dict[str, torch.Tensor]]:
        treedef = tree.flatten(params)[1]
        if microbatch and microbatch > 1:
            m = microbatch
            parts = {key: t.reshape(m, t.shape[0] // m, *t.shape[1:])
                     for key, t in batch.items()}
            acc, losses = None, []
            for i in range(m):
                loss, grads = loss_and_grads(model, params,
                                             {key: t[i] for key, t in parts.items()},
                                             remat=remat)
                grads = [g.float() for g in grads]
                acc = grads if acc is None else [a + g for a, g in zip(acc, grads)]
                losses.append(loss)
            grads = [a / m for a in acc]
            loss = torch.stack(losses).mean()
        else:
            loss, grads = loss_and_grads(model, params, batch, remat=remat)
        new_params, new_opt, info = adamw_update(tree.unflatten(treedef, grads),
                                                 opt_state, params, lr=lr)
        return new_params, new_opt, {"loss": loss, **info}

    return train_step


def make_prefill_step(cfg: ModelConfig, shape: Optional[InputShape] = None):
    """``prefill_step(params, batch) -> (last_logits, cache)``; with a shape,
    the cache is a page pool of ``prefill_cache_len`` positions, without one
    the model's dense cache of the prompt."""
    model = Model(cfg)
    clen = prefill_cache_len(cfg, shape) if shape else None

    def prefill_step(params, batch):
        return model.prefill(params, batch, cache_len=clen)
    return prefill_step


def make_serve_step(cfg: ModelConfig):
    """``serve_step(params, tokens, cache) -> (logits, cache)``: one decode
    step; the pools are written in place."""
    model = Model(cfg)

    def serve_step(params, tokens, cache):
        return model.decode_step(params, tokens, cache)
    return serve_step


# ------------------------------------------------------------ on a mesh

# the families whose layers carry the collectives (models/layers.py,
# models/moe.py, models/ssm.py)
MESH_ARCHS = ("dense", "vlm", "moe", "ssm", "hybrid", "audio")


def splits_heads(cfg: ModelConfig, m: int) -> bool:
    """Whether a model axis of ``m`` splits ``cfg``'s attention heads: it
    does not divide the KV heads (or the query heads), so that the
    reference's placement cuts ``wq``/``wk``/``wv`` mid-head and shards the
    KV cache over the sequence."""
    return bool(cfg.n_heads) and bool(cfg.n_kv_heads % m or cfg.n_heads % m)


def check_mesh_runs(cfg: ModelConfig, sizes: Dict[str, int]) -> None:
    """Raise ``NotImplementedError`` unless ``sharded_step`` can run ``cfg``
    on a mesh of axis ``sizes``: a model whose heads, KV heads, ``d_ff`` and
    SSM heads the model axis divides, so that every rank holds whole heads,
    and, for MoE, its experts' ``d_ff`` (f-sharded experts: the reference's
    expert-parallel fallback is not ported); or a dense, VLM or audio model,
    with or without a sliding window, where the axis divides ``d_ff`` and the
    projections' widths ``n_heads * head_dim`` and ``n_kv_heads * head_dim``
    but not the KV heads: the split-heads placement (``splits_heads``:
    ``wq``/``wk``/``wv`` cut on their columns mid-head as the reference cuts
    them, the KV pools, an audio model's cross pool among them, sharded over
    the sequence in round-robin pages, a window's ring by ring page). The
    train, prefill and decode steps run alike. The placement functions of
    ``launch/shardings.py`` answer every case."""
    m = sizes["model"]
    if cfg.arch_type not in MESH_ARCHS:
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.arch_type} family on a mesh is not ported "
            "(ROADMAP.md, Queue A item 8b-ii)")
    if splits_heads(cfg, m):
        _check_split_heads(cfg, m)
        return
    bad = {k: getattr(cfg, k) for k in ("n_heads", "n_kv_heads", "d_ff", "n_ssm_heads")
           if getattr(cfg, k) % m}
    if bad:
        raise NotImplementedError(
            f"{cfg.name}: a model axis of {m} does not divide {bad}; the "
            "sequence-sharded KV cache and split heads are not ported "
            "(ROADMAP.md, Queue A item 8b-ii, 4)")
    if cfg.is_moe and cfg.moe.d_ff % m:
        raise NotImplementedError(
            f"{cfg.name}: a model axis of {m} does not divide the experts' d_ff "
            f"{cfg.moe.d_ff}; the expert-parallel fallback is not ported "
            "(ROADMAP.md, Queue A item 8b-ii)")


def _check_split_heads(cfg: ModelConfig, m: int) -> None:
    """``check_mesh_runs`` where a model axis of ``m`` splits the heads."""
    where = (f"{cfg.name}: a model axis of {m} splits its {cfg.n_heads} heads over "
             f"{cfg.n_kv_heads} KV heads")
    if cfg.arch_type not in ("dense", "vlm", "audio"):
        raise NotImplementedError(
            f"{where}; only the dense, VLM and audio families run on split heads "
            "(ROADMAP.md, Queue A item 8b-ii)")
    if cfg.n_kv_heads % m == 0:
        raise NotImplementedError(
            f"{where}; it divides the KV heads but not the heads, a placement "
            "that is not ported (ROADMAP.md, Queue A item 8b-ii, 4a)")
    D = cfg.resolved_head_dim
    bad = {k: v for k, v in (("n_heads * head_dim", cfg.n_heads * D),
                             ("n_kv_heads * head_dim", cfg.n_kv_heads * D),
                             ("d_ff", cfg.d_ff)) if v % m}
    if bad:
        raise NotImplementedError(
            f"{where} and does not divide {bad}, where the reference replicates "
            "the projection; not ported (ROADMAP.md, Queue A item 8b-ii, 4a)")


def local_config(cfg: ModelConfig, sizes: Dict[str, int]) -> ModelConfig:
    """The config of one rank's model on a mesh of axis ``sizes``: its
    shares of the heads, the KV heads, ``d_ff`` and the experts' ``d_ff``
    (the shared experts' width with it), of the vocabulary where the model
    axis divides it (``shardings.param_spec``'s rule), and of the SSM width
    and heads (a ``RankConfig``: ``params.ssm_layout``). Where the axis
    splits the heads (``splits_heads``), a ``RankConfig`` that keeps the
    heads whole and carries the rank's column counts of the projections and
    the KV pool's sequence shards."""
    check_mesh_runs(cfg, sizes)
    m = sizes["model"]
    vocab = cfg.vocab_size // m if cfg.vocab_size % m == 0 else cfg.vocab_size
    if splits_heads(cfg, m):
        D = cfg.resolved_head_dim
        local = cfg.with_(head_dim=D, d_ff=cfg.d_ff // m, vocab_size=vocab)
        return RankConfig(**{f.name: getattr(local, f.name)
                             for f in dataclasses.fields(local)},
                          q_cols=cfg.n_heads * D // m, kv_cols=cfg.n_kv_heads * D // m,
                          kv_shards=m)
    moe = dataclasses.replace(cfg.moe, d_ff=cfg.moe.d_ff // m) if cfg.is_moe else cfg.moe
    local = cfg.with_(n_heads=cfg.n_heads // m, n_kv_heads=cfg.n_kv_heads // m,
                      head_dim=cfg.resolved_head_dim, d_ff=cfg.d_ff // m,
                      vocab_size=vocab, moe=moe)
    if not cfg.n_ssm_heads:
        return local
    return RankConfig(**{f.name: getattr(local, f.name) for f in dataclasses.fields(local)},
                      inner=cfg.d_inner // m)


def batch_rows(mesh, batch: int) -> slice:
    """The rows of a global batch of ``batch`` that this rank of a live mesh
    takes: its block on the batch axes (``shardings.batch_shardings``), or
    every row where they do not divide it."""
    index, count = sh.shard_index(sh._batch_spec_axis(mesh, batch),
                                  mesh_axis_sizes(mesh), mesh_coords(mesh))
    n = batch // count
    return slice(index * n, (index + 1) * n)


@contextlib.contextmanager
def on_model_axis(axis: Optional[runtime_flags.ModelAxis],
                  batch_axes: Optional[runtime_flags.BatchAxes] = None):
    """``axis`` as the ambient model axis (and ``batch_axes`` as the batch
    axes) for the body, the previous ones after it."""
    before = runtime_flags.get_mesh(), runtime_flags.get_batch_axes()
    runtime_flags.set_mesh(axis)
    runtime_flags.set_batch_axes(batch_axes)
    try:
        yield
    finally:
        runtime_flags.set_mesh(before[0])
        runtime_flags.set_batch_axes(before[1])


def _mesh_loss_and_grads(model: Model, params, batch: Dict[str, torch.Tensor],
                         batch_axes: Optional[runtime_flags.BatchAxes], remat: bool
                         ) -> Tuple[torch.Tensor, list]:
    """The global batch's loss and this rank's gradient of it, one tensor
    per leaf in ``tree.flatten`` order, from this rank's rows: the summed
    cross-entropy and the positions counted are summed over the batch axes
    apart (a mean of the ranks' means is another number where a
    ``loss_mask`` counts them unevenly), and each rank differentiates its
    share scaled by the ranks' count, so that the average of the ranks'
    gradients is the global loss's."""
    flat, treedef = tree.flatten(params)
    flat = [p.detach().requires_grad_(True) for p in flat]
    with torch.enable_grad():
        total, count, aux = model.loss_terms(tree.unflatten(treedef, flat), batch,
                                             remat=remat)
        sums = torch.stack([total.detach(), count])
        n = 1
        if batch_axes is not None:
            n = batch_axes.size
            for group in batch_axes.groups:
                dist.all_reduce(sums, group=group)
        denominator = sums[1].clamp_min(1.0)
        grads = torch.autograd.grad(n * total / denominator + aux, flat, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(flat, grads)]
    return sums[0] / denominator + aux.detach(), grads


def _sharded_train_step(cfg: ModelConfig, lcfg: ModelConfig, shape: InputShape, mesh, *,
                        remat: bool, zero_opt: bool, microbatch: int):
    """``make_train_step``'s body on this rank of ``mesh`` (see
    ``sharded_step``)."""
    model = Model(lcfg)
    sizes, coords = mesh_axis_sizes(mesh), mesh_coords(mesh)
    axis = runtime_flags.ModelAxis.of(mesh, cfg.vocab_size)
    batch_axes = runtime_flags.BatchAxes.of(mesh)
    leaves, _ = rank_leaves(cfg, mesh, zero=zero_opt)
    # the dimension on which ZeRO-1 cuts each moment over ``data`` (None:
    # every data rank keeps and updates the whole leaf)
    zero_dims = [rl.zero_dim for rl in leaves]
    groups = {a: mesh.get_group(a) for a in ("model", "data") if sizes[a] > 1}
    m = microbatch if microbatch and microbatch > 1 else 1
    rows = shape.global_batch // m
    mine = batch_rows(mesh, rows)

    def sum_squares(flat_g):
        # each element counted once: a model-sharded leaf's sum over
        # ``model``, a ZeRO block's over ``data``, a replicated one's as it
        # is; a Mamba2 leaf's replicated B/C part (params.ssm_layout) as a
        # replicated leaf's, the rest of it as a model-sharded one's
        parts = [torch.zeros((), dtype=torch.float32, device=flat_g[0].device)
                 for _ in range(4)]
        for g, rl in zip(flat_g, leaves):
            zk = 2 * int(rl.zero_dim is not None)
            if rl.layout is None:
                pieces = ((int(rl.on_model), g),)
            else:
                pieces = tuple(zip((1, 0), layout_split(g, rl.layout, sizes["model"])))
            for k, piece in pieces:
                parts[k + zk] = parts[k + zk] + torch.sum(torch.square(piece.float()))
        parts = torch.stack(parts)
        for a, mask in (("model", (0., 1., 0., 1.)), ("data", (0., 0., 1., 1.))):
            if a in groups:
                w = torch.tensor(mask, device=parts.device)
                part = parts * w
                dist.all_reduce(part, group=groups[a])
                parts = parts * (1 - w) + part
        return parts.sum()

    def train_step(params, opt_state: AdamWState, batch: Dict[str, torch.Tensor]
                   ) -> Tuple[Any, AdamWState, Dict[str, torch.Tensor]]:
        flat_p, treedef = tree.flatten(params)
        acc, losses = None, []
        with on_model_axis(axis, batch_axes):
            for i in range(m):
                part = {k: t[i * rows:(i + 1) * rows][mine] for k, t in batch.items()}
                loss, grads = _mesh_loss_and_grads(model, params, part, batch_axes, remat)
                if m > 1:
                    grads = [g.float() for g in grads]
                acc = grads if acc is None else [a + g for a, g in zip(acc, grads)]
                losses.append(loss)
        grads = [a / m for a in acc] if m > 1 else acc
        loss = torch.stack(losses).mean() if m > 1 else losses[0]
        if batch_axes is not None:   # the average over the batch axes, a leaf at a time
            for i, g in enumerate(grads):
                grads[i] = all_reduce_sum(g, batch_axes.groups, 1.0 / batch_axes.size)
        if zero_opt:   # this data rank's block of each cut leaf
            grads, flat_p = ([_block(t, zd, coords, sizes) for t, zd in zip(ts, zero_dims)]
                             for ts in (grads, flat_p))
        new_p, new_opt, info = adamw_update(tree.unflatten(treedef, grads), opt_state,
                                            tree.unflatten(treedef, flat_p),
                                            sum_squares=sum_squares)
        if zero_opt:   # every data rank's blocks, all-gathered over ``data``
            new_p = tree.unflatten(treedef, [
                t if zd is None else gather_leaf(
                    t, tuple("data" if i == zd else None for i in range(t.dim())), mesh)
                for t, zd in zip(tree.leaves(new_p), zero_dims)])
        return new_p, new_opt, {"loss": loss, **info}

    return train_step


def _block(t: torch.Tensor, dim: Optional[int], coords: Dict[str, int],
           sizes: Dict[str, int]) -> torch.Tensor:
    """This data rank's block of ``t`` on ``dim`` (``t`` where None)."""
    if dim is None:
        return t
    n = t.shape[dim] // sizes["data"]
    return t.narrow(dim, coords["data"] * n, n)


def sharded_step(cfg: ModelConfig, shape: InputShape, mesh, *, remat: bool = True,
                 zero_opt: bool = False, microbatch: int = 0):
    """The train, prefill or serve step of ``shape`` on this rank of the live
    ``mesh``, and its inputs' specs: the counterpart of the reference's
    ``jit_step`` (``repro.launch.steps.jit_step``), with its knobs ``remat``,
    ``zero_opt`` and ``microbatch`` for a train step.

    Returns ``(fn, args)``: for a train step, ``fn(params, opt_state,
    batch) -> (params, opt_state, {"loss", "grad_norm"})`` and ``args =
    (params, opt_state, batch)``; for a prefill, ``fn(params, batch) ->
    (logits, cache)`` and ``args = (params, batch)``; for a decode,
    ``fn(params, tokens, cache) -> (logits, cache)`` and ``args = (params,
    tokens, cache)``, as meta tensors. ``params`` and ``cache`` are this
    rank's shards (``params.shard_params`` / ``init_shard``; the cache the
    prefill step returned), ``opt_state`` its blocks of the AdamW state
    (``params.init_opt_shard``, ``zero_opt`` alike);
    ``batch`` and ``tokens`` are the global batch, of which ``fn`` takes this
    rank's rows (``batch_rows``; with ``microbatch=M``, its rows of each of
    the M consecutive microbatches). The logits are those rows' over the
    whole vocabulary; a train step's metrics are the global batch's, the
    same on every rank. ``zero_opt`` is ZeRO-1: each data rank updates its
    block of each leaf that ``shardings.opt_shardings(zero=True)`` cuts and
    the parameters are all-gathered over ``data`` after the update. The
    decode step runs eagerly: a gloo collective cannot be captured in a
    CUDA graph. A model that ``check_mesh_runs`` refuses raises
    ``NotImplementedError``.

    Where the model axis splits the heads (``splits_heads``; a dense, VLM or
    audio model), a rank holds the reference's column blocks of
    ``wq``/``wk``/``wv`` and row block of ``wo`` (an audio model's in every
    encoder and decoder attention), gathers q, k and v whole (a
    cross-attention's q from the decoder's rows, k and v from the
    encoder's), and runs a prefill's or a train step's attention over the
    heads its ``wo`` rows overlap; the train step's backward sums the
    gathered q, k and v's gradients over the model axis and keeps the rank's
    columns (``layers.gather_columns``), and its norm, ZeRO-1 and
    microbatches take those column and row blocks as every other
    model-sharded leaf. Its KV
    pool (an audio model's cross pool too) holds every KV head at its
    round-robin pages of each row (``shardings.seq_place``; a sliding
    window's ring by ring page, each rank's pages a ring of their own), and
    a decode step merges the ranks' partial attention, each over its
    positions within the window, by their log-sum-exp
    (``models/layers.py``)."""
    cfg = resolve_config(cfg, shape)
    sizes = mesh_axis_sizes(mesh)
    lcfg = local_config(cfg, sizes)
    axis = runtime_flags.ModelAxis.of(mesh, cfg.vocab_size)
    if shape.kind == "train":
        fn = _sharded_train_step(cfg, lcfg, shape, mesh, remat=remat, zero_opt=zero_opt,
                                 microbatch=microbatch)
        return fn, (params_specs(lcfg), init_opt_shard(cfg, mesh, zero=zero_opt, device=META),
                    batch_specs(cfg, shape.global_batch, shape.seq_len))
    rows = batch_rows(mesh, shape.global_batch)
    local = dataclasses.replace(shape, global_batch=rows.stop - rows.start)
    specs = input_specs(lcfg, local)
    if shape.kind == "prefill":
        prefill = make_prefill_step(lcfg, local)

        def prefill_step(params, batch):
            with on_model_axis(axis):
                return prefill(params, {k: t[rows] for k, t in batch.items()})
        global_batch = batch_specs(cfg, shape.global_batch, shape.seq_len)
        return prefill_step, (specs["params"], global_batch)

    serve = make_serve_step(lcfg)
    # the axes that cut the batch: an MoE layer dispatches the global batch
    # over them (models/moe.py)
    batch_axes = runtime_flags.BatchAxes.of(
        mesh, sh._entry_axes(sh._batch_spec_axis(mesh, shape.global_batch)))

    def serve_step(params, tokens, cache):
        with on_model_axis(axis, batch_axes):
            return serve(params, tokens[rows], cache)
    return serve_step, (specs["params"], _token_spec(shape.global_batch, 1),
                        specs["cache"])
