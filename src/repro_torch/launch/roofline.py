"""Roofline terms of one step on one H100.

The counterpart of ``repro.launch.roofline``:

  compute term    = FLOPs / peak FLOP/s at the step's dtype
  memory term     = bytes / HBM bandwidth
  collective term = collective bytes / link bandwidth      (0 on one card)

The constants are the card's data-sheet numbers that ``sim/perf_model.py``
holds (dense bf16 tensor-core peak, HBM3 bandwidth, NVLink per direction),
plus ``FP32_FLOPS``, the H100 SXM's float32 rate outside the tensor cores
(NVIDIA's H100 data sheet). The port trains in float32 with TF32 off, so a
float32 step is held to ``FP32_FLOPS``; every other step to ``PEAK_FLOPS``.
``RooflineTerms`` takes the peak of its ``dtype``.

FLOPs come from ``torch.utils.flop_counter.FlopCounterMode`` around the
port's own step (``make_prefill_step``, ``make_serve_step``,
``make_train_step``) run on the meta inputs of ``steps.input_specs``: the
products of the plain versions (the kernels' wrappers take their plain
version on the meta device), full S x T attention scores included, as the
reference's HLO counts its own plain attention. A meta tensor computes
nothing, so this hides no device and no kernel.

Bytes have no compiler count; ``step_bytes`` counts each input byte read
once and each output byte written once, activations left out:

  serve (one decode token a sequence):
      parameters + tokens + block tables and positions
      + K/V of ``context`` positions a sequence (cross K/V: the encoder's
        positions) + the SSM and conv states, read and written
      + one K/V row a sequence written + logits
  prefill: parameters + the prompt (tokens, frames, vision)
      + the cache written (the whole returned pool or state) + logits
  train:  parameters x passes (forward and backward, a third with remat,
        each microbatch again) + the batch + gradients written
      + AdamW's moments and step read and written + parameters written

On a mesh (``plan(..., mesh=)``) the terms are one device's, as the
reference's compiled module reports them per chip: the bytes are the same
formulas over the device's shards of each tree (``launch/shardings.py``),
the logits a rank returns over the whole vocabulary (as ``sharded_step``
returns them); the FLOPs the step's split over the model axis and over the
batch shards (a data rank whose batch does not divide computes every row);
and ``coll_bytes`` the collectives of the port's plan (``mesh_coll_bytes``:
the tensor-parallel all_reduces on the model axis, and for a train step
the gradient's average over the batch axes and ZeRO-1's all-gather) at a
ring's ``2 (n - 1) / n`` of each buffer a device (``(n - 1) / n`` for an
all-gather), each over its axis's rate (``coll_rates``): NVLink's
``LINK_BW`` (450 GB/s a direction, half of the 900 GB/s that NVIDIA's H100
SXM data sheet gives a card) where the axis's ring lies within one node of
``NODE_CARDS`` cards, else ``INTER_NODE_BW``. ``coll_bytes`` is None where
``sharded_step`` does not run the pair (a family or a width it refuses):
the port has no plan there to count. One card moves no collective bytes.

Not ported: ``extract_terms`` (XLA's HLO cost analysis) and
``collective_bytes`` / ``_shape_bytes`` (collectives parsed from HLO text),
which have no torch counterpart (ROADMAP.md Queue A item 8b-i).
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple

import torch
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs.base import InputShape, ModelConfig
from repro_torch.kernels.ops import DEFAULT_PAGE_SIZE
from repro_torch.launch import shardings as sh
from repro_torch.launch import steps
from repro_torch.launch.mesh import mesh_axis_sizes
from repro_torch.params import rank_cache_shape, rank_leaves
from repro_torch.sim.perf_model import HBM_BW, LINK_BW, PEAK_FLOPS
from repro_torch.training import tree

FP32_FLOPS = 67e12          # float32 FLOP/s without the tensor cores (H100 SXM)
CARD_BYTES = 85.02e9        # the card's memory as torch reports it (H100 80GB HBM3)
# an NVLink domain: the eight cards of one HGX H100 node; past it, a ring
# crosses nodes at a card's InfiniBand rate (NVIDIA's DGX H100 data sheet:
# one 400 Gb/s ConnectX-7 port a card, 50 GB/s a direction)
NODE_CARDS = 8
INTER_NODE_BW = 50e9


def peak_flops(dtype: str) -> float:
    return FP32_FLOPS if dtype == "float32" else PEAK_FLOPS


@dataclass
class RooflineTerms:
    flops: float                 # FLOPs of the step (FlopCounterMode)
    hbm_bytes: float             # bytes the step must move (step_bytes)
    coll_bytes: Optional[float]  # collective bytes (0 on one card; None: no plan)
    coll_breakdown: Dict[str, int] = field(default_factory=dict)
    model_flops: float = 0.0     # 6*N*D (or 6*N_active*D) useful FLOPs
    dtype: str = "bfloat16"      # the step's dtype: picks the peak
    link_bw: float = LINK_BW     # the rate its model-axis collectives run at
    coll_rates: Dict[str, float] = field(default_factory=dict)   # by breakdown key

    @property
    def peak_flops(self) -> float:
        return peak_flops(self.dtype)

    @property
    def compute_s(self) -> float:
        return self.flops / self.peak_flops

    @property
    def memory_s(self) -> float:
        return self.hbm_bytes / HBM_BW

    @property
    def collective_s(self) -> Optional[float]:
        """Each collective's bytes over its axis's rate (``link_bw`` where
        ``coll_rates`` names none)."""
        if self.coll_bytes is None:
            return None
        if not self.coll_breakdown:
            return self.coll_bytes / self.link_bw
        return sum(b / self.coll_rates.get(k, self.link_bw)
                   for k, b in self.coll_breakdown.items())

    def _known(self) -> Dict[str, float]:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return {k: v for k, v in terms.items() if v is not None}

    @property
    def bottleneck(self) -> str:
        terms = self._known()
        return max(terms, key=terms.get)

    @property
    def step_time_s(self) -> float:
        """The largest known term (a lower bound where ``coll_bytes`` is None)."""
        return max(self._known().values())

    @property
    def useful_flops_ratio(self) -> float:
        if self.flops <= 0:
            return 0.0
        return self.model_flops / self.flops

    def as_dict(self) -> Dict:
        return {
            "flops": self.flops, "hbm_bytes": self.hbm_bytes,
            "coll_bytes": self.coll_bytes,
            "compute_s": self.compute_s, "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "bottleneck": self.bottleneck,
            "useful_flops_ratio": self.useful_flops_ratio,
            "coll_breakdown": self.coll_breakdown,
            "dtype": self.dtype,
        }


def model_flops_for(cfg, shape) -> float:
    """MODEL_FLOPS = 6*N*D (dense) / 6*N_active*D (MoE); forward-only
    kinds use 2*N*D (prefill) or 2*N_active per token (decode)."""
    n = cfg.active_param_count()
    tokens = shape.global_batch * shape.seq_len
    if shape.kind == "train":
        return 6.0 * n * tokens
    if shape.kind == "prefill":
        return 2.0 * n * tokens
    return 2.0 * n * shape.global_batch      # decode: one token per sequence


# ------------------------------------------------------------ bytes


def nbytes(t: Any) -> int:
    """Bytes of every tensor in a tree of dicts, NamedTuples, tuples and
    lists (meta tensors included)."""
    if isinstance(t, (tuple, list)) and not hasattr(t, "_fields"):
        return sum(nbytes(x) for x in t)
    return sum(x.numel() * x.element_size() for x in tree.leaves(t)
               if isinstance(x, torch.Tensor))


def _position_bytes(pool: torch.Tensor) -> float:
    """Bytes of one position of one sequence in a (L, pages, page, Hkv, D)
    pool whose pages are split evenly over the sequences."""
    return pool.element_size() * pool.shape[0] * pool.shape[3] * pool.shape[4]


def decode_bytes(cfg: ModelConfig, params, tokens: torch.Tensor, cache: Dict,
                 logits: torch.Tensor, context: float) -> float:
    """Bytes of one decode step over ``context`` positions a sequence (see the
    module docstring)."""
    batch = tokens.shape[0]
    total = nbytes(params) + nbytes(tokens) + nbytes(logits)
    for key, t in cache.items():
        if key in ("k", "v"):
            total += _position_bytes(t) * batch * (context + 1)
        elif key in ("cross_k", "cross_v"):
            total += _position_bytes(t) * batch * cfg.enc_seq
        elif key in ("ssm", "conv", "pos"):
            total += 2 * nbytes(t)
        else:                                    # block tables
            total += nbytes(t)
    return float(total)


def train_bytes(params, opt_state, batch: Dict, *, remat: bool,
                microbatch: int = 0) -> float:
    p = nbytes(params)
    passes = (3 if remat else 2) * max(microbatch, 1)
    grads = sum(x.numel() * (4 if microbatch > 1 else x.element_size())
                for x in tree.leaves(params))
    return float(p * passes + nbytes(batch) + grads + 2 * nbytes(opt_state) + p)


# ------------------------------------------------------------ one step


def count_flops(fn, *args) -> Tuple[float, Any]:
    """(FLOPs, outputs) of ``fn(*args)`` under ``FlopCounterMode``."""
    with FlopCounterMode(display=False) as counter:
        out = fn(*args)
    return float(counter.get_total_flops()), out


# ------------------------------------------------------------ a mesh

_REDUCE_BYTES = 4            # the port reduces its partial sums in float32


def _ring(n: int) -> float:
    return 2.0 * (n - 1) / n


def _batch_shards(mesh, batch: int) -> int:
    """How many blocks the batch axes cut a global batch of ``batch`` into."""
    return sh.shard_index(sh._batch_spec_axis(mesh, batch), mesh_axis_sizes(mesh), {})[1]


def link_bw(model_axis: int) -> float:
    """The rate a ring over a model axis of ``model_axis`` cards runs at: NVLink
    where the axis (the mesh's innermost, so consecutive cards) tiles one
    node, else a card's inter-node rate."""
    return LINK_BW if NODE_CARDS % model_axis == 0 else INTER_NODE_BW


def data_link_bw(mesh) -> float:
    """The rate a ring over the batch axes runs at: NVLink where the whole
    mesh fits one node (the model axis innermost, so a batch axis strides
    over it), else a card's inter-node rate."""
    world = 1
    for n in mesh_axis_sizes(mesh).values():
        world *= n
    return LINK_BW if world <= NODE_CARDS else INTER_NODE_BW


def mesh_coll_bytes(cfg: ModelConfig, shape: InputShape, mesh, *, remat: bool = True,
                    zero_opt: bool = False) -> Optional[Dict[str, float]]:
    """One device's collective bytes in one step of ``shape`` on ``mesh``,
    by the plan ``sharded_step`` runs (``models/layers.py``,
    ``models/moe.py``, ``launch/steps.py``), each buffer in float32:

    - forward, on ``model``: an all_reduce of the attention's and the FFN's
      (an MoE layer's combined experts') row-parallel outputs in every
      layer, of an MoE router's logits where the axis shards its columns, of
      the embeddings and of the full-vocabulary logits where the vocabulary
      is sharded (a prefill's of its last position, a train step's of every
      text position);
    - a train step's backward, on ``model``: the layers' forward again under
      ``remat`` (recomputed inside the backward), and an all_reduce of the
      gradient at every ``copy_to_model_axis`` (the attention's and the
      FFN's inputs, an MoE layer's gates, the sharded head's input);
    - a train step, on the batch axes: the average of the rank's gradient
      (every leaf of its shards); with ``zero_opt``, the all-gather of each
      data rank's block of the leaves ZeRO-1 cuts;
    - where the model axis splits the heads (``steps.splits_heads``: a
      dense, VLM or audio model), on ``model``: the all-gather of q, k and
      v in every layer (``layers.gather_columns``; the audio family's
      encoder layers over the frames, and a decoder layer's self q, k, v
      over the tokens, its cross q over the tokens and cross k, v over the
      frames: a decode step runs no encoder and gathers no cross k, v),
      the decoder's again under a train step's ``remat`` (not the
      encoder's); a train step's backward all_reduces the gathered
      gradients, the same elements as the forward's gathers; and a decode
      step's merge of the ranks' partial attention
      (``layers.merge_model_axis``), one a layer (the audio family's two:
      self and cross): an all-gather of every rank's partial output and
      log-sum-exp, ``H (D + 1)`` elements a sequence from each rank.

    An all_reduce moves ``2 (n - 1) / n`` of its buffer, an all-gather
    ``(n - 1) / n`` of what it gathers; what a step reduces by the handful
    (the loss's two sums, the norm's four, an MoE layer's 2 E load-balance
    means) is not counted. None where ``sharded_step`` does not run the
    pair; zero on one card."""
    sizes = mesh_axis_sizes(mesh)
    m = sizes["model"]
    try:
        steps.check_mesh_runs(cfg, sizes)
    except NotImplementedError:
        return None
    rows = shape.global_batch // _batch_shards(mesh, shape.global_batch)
    seq = 1 if shape.kind == "decode" else shape.seq_len
    n_vis = cfg.n_vision_tokens if cfg.arch_type == "vlm" and shape.kind != "decode" else 0
    tokens = rows * (seq + n_vis)
    vocab = cfg.vocab_size % m == 0
    logit_rows = rows * seq if shape.kind == "train" else rows
    edges = rows * seq * cfg.d_model + logit_rows * cfg.vocab_size if vocab else 0
    forward, backward = _layers_coll(cfg, shape, tokens, rows, m)
    model = forward + edges
    out = {}
    if steps.splits_heads(cfg, m):
        encoder, decoder, merges = _split_gathers(cfg, shape, tokens, rows, m)
        gathered = encoder + decoder + merges
        if shape.kind == "train":   # remat's gathers again; the gradients' sum
            gathered += decoder if remat else 0
            backward += encoder + decoder
        out["all-gather model"] = gathered * _REDUCE_BYTES * (m - 1) / m
    if shape.kind == "train":
        if remat:   # the layers' forward again inside the backward (not the encoder's)
            model += forward - (_encoder_coll(cfg, rows) if cfg.arch_type == "audio" else 0)
        # the copies' backward, and the sharded head's input
        model += backward + (rows * seq * cfg.d_model if vocab else 0)
        n_batch = 1
        for a in ("pod", "data"):
            n_batch *= sizes.get(a, 1)
        if n_batch > 1:
            leaves, _ = rank_leaves(cfg, mesh, zero=zero_opt)
            grads = sum(math.prod(rl.shape) for rl in leaves)
            out["all-reduce data"] = sum(grads * _REDUCE_BYTES * _ring(sizes[a])
                                         for a in ("pod", "data") if sizes.get(a, 1) > 1)
            if zero_opt:
                cut = sum(math.prod(rl.shape) * rl.dtype.itemsize
                          for rl in leaves if rl.zero_dim is not None)
                out["all-gather data"] = cut * (sizes["data"] - 1) / sizes["data"]
    return {"all-reduce model": model * _REDUCE_BYTES * _ring(m), **out}


def _split_gathers(cfg: ModelConfig, shape: InputShape, tokens: int, rows: int, m: int
                   ) -> Tuple[float, float, float]:
    """(encoder, decoder, merges): the elements a rank of split heads
    all-gathers on the model axis in one forward over ``tokens`` (of
    ``rows`` sequences): q, k and v in the audio encoder's layers over its
    frames; in each decoder (or transformer) layer q, k and v over the
    tokens and, for the audio family, the cross q over the tokens and the
    cross k, v over the frames (none in a decode step, which runs no
    encoder); and a decode step's merges of every rank's partial output and
    log-sum-exp, one a layer (the audio family's two)."""
    D, L, H, Hkv = cfg.resolved_head_dim, cfg.n_layers, cfg.n_heads, cfg.n_kv_heads
    decoder = L * tokens * (H + 2 * Hkv) * D
    encoder, merges = 0, 0
    audio = cfg.arch_type == "audio"
    if audio and shape.kind != "decode":
        frames = rows * cfg.enc_seq
        encoder = cfg.n_enc_layers * frames * (H + 2 * Hkv) * D
        decoder += L * frames * 2 * Hkv * D
    if audio:
        decoder += L * tokens * H * D
    if shape.kind == "decode":
        merges = (2 if audio else 1) * L * m * rows * H * (D + 1)
    return encoder, decoder, merges


def _split_pool_extra_bytes(cfg: ModelConfig, mesh, cache: Dict) -> int:
    """What a rank of split heads holds of a decode step's KV pools (an
    audio model's cross pools too) beyond their shards under the
    reference's specs (``cache``, one device's shards): each row rounded up
    to whole pages a rank (``shardings.seq_pages``), where the reference
    shards a pool over its positions, or, for a cross pool whose
    ``enc_seq`` positions the model axis does not divide, cuts its
    ``head_dim``; zero where the model axis divides the row's pages and the
    spec cuts the positions."""
    m = mesh_axis_sizes(mesh)["model"]
    extra = 0
    for table, keys in (("block_tables", ("k", "v")),
                        ("cross_block_tables", ("cross_k", "cross_v"))):
        if table not in cache:
            continue
        rows, pages = cache[table].shape
        held = sh.seq_pages(pages, m) * rows * DEFAULT_PAGE_SIZE * cfg.n_kv_heads * \
            cfg.resolved_head_dim
        extra += sum((cache[key].shape[0] * held - cache[key].numel()) *
                     cache[key].element_size() for key in keys)
    return int(extra)


def _encoder_coll(cfg: ModelConfig, rows: int) -> float:
    """The audio encoder's forward all_reduces (``wo``, ``w_down``) over
    ``rows`` sequences of ``enc_seq`` frames: elements, one device."""
    return cfg.n_enc_layers * 2 * rows * cfg.enc_seq * cfg.d_model


def _layers_coll(cfg: ModelConfig, shape: InputShape, tokens: int, rows: int, m: int
                 ) -> Tuple[float, float]:
    """(forward, backward): the elements the layers all_reduce over the model
    axis in a forward over ``tokens`` (of ``rows`` sequences), and in a
    train step's backward at the copies (``copy_to_model_axis``,
    ``sum_model_axis``), by family:

    - a transformer layer: ``wo`` and ``w_down`` (an MoE layer's combine),
      an MoE router's logits where the axis cuts its columns; backward the
      attention's and the FFN's inputs and an MoE layer's gates;
    - a Mamba2 layer: ``w_out`` and the gated norm's statistic (one a
      token); backward the z/x/dt product's input, B and C after the conv
      (2 N a token) and the statistic;
    - the hybrid's shared block, once a call: a dense layer's;
    - the audio family: each encoder layer's two over the frames (a decode
      step runs no encoder) and each decoder layer's three (the self- and
      cross-attention's ``wo``, ``w_down``); backward each one's inputs,
      the cross-attention's K/V input (the encoder's output) among them."""
    d, L = cfg.d_model, cfg.n_layers
    if cfg.arch_type in ("ssm", "hybrid"):
        N = cfg.ssm.state_dim
        forward = L * tokens * (d + 1)
        backward = L * tokens * (d + 2 * N + 1)
        if cfg.arch_type == "hybrid":
            calls = L // cfg.attn_every
            forward += calls * 2 * tokens * d
            backward += calls * 2 * tokens * d
        return forward, backward
    if cfg.arch_type == "audio":
        enc = 0 if shape.kind == "decode" else _encoder_coll(cfg, rows)
        frames = rows * cfg.enc_seq
        return enc + L * 3 * tokens * d, enc + L * (3 * tokens + frames) * d
    E = cfg.moe.n_experts if cfg.is_moe else 0
    layer = 2 * tokens * d + (tokens * E if E and E % m == 0 else 0)
    gates = tokens * cfg.moe.experts_per_token if E else 0
    return L * layer, L * (2 * tokens * d + gates)


def local_meta(t: Any, specs: Any, sizes: Dict[str, int]) -> Any:
    """A tree of meta tensors of one device's shard shapes."""
    if isinstance(t, dict):
        return {k: local_meta(v, specs[k], sizes) for k, v in t.items()}
    if isinstance(t, tuple) and hasattr(t, "_fields"):
        return type(t)(*(local_meta(v, s, sizes) for v, s in zip(t, specs)))
    return torch.empty(sh.local_shape(specs, tuple(t.shape), sizes), dtype=t.dtype,
                       device=steps.META)


def _local_specs(cfg: ModelConfig, shape: InputShape, mesh, specs: Dict, out,
                 zero_opt: bool) -> Tuple[Dict, Any]:
    """One device's shards of the step's inputs and outputs, as meta trees."""
    sizes = mesh_axis_sizes(mesh)
    B = shape.global_batch
    p_sh = sh.param_shardings(mesh, specs["params"])
    ins = {"params": local_meta(specs["params"], p_sh, sizes)}
    if shape.kind == "train":
        o_sh = sh.opt_shardings(mesh, specs["opt_state"], p_sh, zero=zero_opt)
        ins["opt_state"] = local_meta(specs["opt_state"], o_sh, sizes)
        ins["batch"] = local_meta(specs["batch"], sh.batch_shardings(mesh, specs["batch"]),
                                  sizes)
        outs = (ins["params"], ins["opt_state"])
    else:
        # a rank's rows over the whole vocabulary, as sharded_step returns them
        logits = local_meta(out[0], (sh._batch_spec_axis(mesh, B), None), sizes)
        if shape.kind == "prefill":
            ins["batch"] = local_meta(specs["batch"],
                                      sh.batch_shardings(mesh, specs["batch"]), sizes)
            cache = out[1]
        else:
            ins["tokens"] = local_meta(specs["tokens"],
                                       sh.batch_shardings(mesh, specs["tokens"]), sizes)
            cache = specs["cache"]
        cross = {"cross_k": cfg.enc_seq, "cross_v": cfg.enc_seq}
        cache = local_meta(cache, sh.cache_shardings(mesh, cache, B, cross), sizes)
        if shape.kind == "decode":
            ins["cache"] = cache
        outs = (logits, cache)
    return ins, outs


def _layout_extra_bytes(cfg: ModelConfig, shape: InputShape, mesh, ins: Dict,
                        zero_opt: bool) -> int:
    """The bytes that the rank layout of the Mamba2 leaves
    (``params.ssm_layout``) adds to one device's inputs ``ins``, which hold
    each leaf under the reference's specs (``arg_bytes``): B and C whole on
    every rank, 2 N (m - 1) / m columns of ``w_in`` a layer more than its
    spec's contiguous block, their channels of ``conv_w`` and ``conv_b``
    (which the spec replicates, as it does ``norm_w``: those then count
    less), in AdamW's moments as well, and in a decode step's ``conv``
    cache. Zero for a family with no Mamba2 layer. Where the model axis
    splits the heads, a decode step's KV pools rounded up to whole pages a
    rank (``_split_pool_extra_bytes``)."""
    sizes = mesh_axis_sizes(mesh)
    if shape.kind == "decode" and steps.splits_heads(cfg, sizes["model"]):
        try:
            steps.check_mesh_runs(cfg, sizes)
        except NotImplementedError:   # no rank layout to count
            return 0
        return _split_pool_extra_bytes(cfg, mesh, ins["cache"])
    if cfg.arch_type not in ("ssm", "hybrid"):
        return 0
    leaves, _ = rank_leaves(cfg, mesh, zero=zero_opt)
    extra = sum((math.prod(rl.shape) - t.numel()) * t.element_size()
                for rl, t in zip(leaves, tree.leaves(ins["params"])))
    if shape.kind == "train":
        for rl, t in zip(leaves, tree.leaves(ins["opt_state"].mu)):
            n = math.prod(rl.shape) // (sizes["data"] if rl.zero_dim is not None else 1)
            extra += 2 * (n - t.numel()) * t.element_size()
    if shape.kind == "decode":
        conv = ins["cache"]["conv"]
        mine = rank_cache_shape(cfg, "conv", tuple(conv.shape), sizes["model"])
        extra += (math.prod(mine) - conv.numel()) * conv.element_size()
    return int(extra)


def plan(cfg: ModelConfig, shape: InputShape, *, remat: bool = True,
         microbatch: int = 0, context: Optional[float] = None, mesh=None,
         zero_opt: bool = False) -> Tuple[RooflineTerms, Dict[str, int]]:
    """The roofline terms of ``shape``'s step on the meta device, and its
    memory: ``arg_bytes`` (parameters, plus the cache for decode, plus
    AdamW's state and the batch for train; the prefill's prompt too),
    ``out_bytes`` (what the step returns) and, on a mesh,
    ``layout_extra_bytes`` (``_layout_extra_bytes``). Activations are not
    counted.
    ``context``: the positions a decode step reads a sequence (default: the
    cache's length). With ``mesh`` (a ``MeshShape``; ``zero_opt``: ZeRO-1
    moments) every term and byte count is one device's (module
    docstring)."""
    cfg = steps.resolve_config(cfg, shape)
    specs = steps.input_specs(cfg, shape)
    mflops = model_flops_for(cfg, shape)
    if shape.kind == "train":
        fn = steps.make_train_step(cfg, remat=remat, microbatch=microbatch)
        flops, out = count_flops(fn, specs["params"], specs["opt_state"],
                                 specs["batch"])
    elif shape.kind == "prefill":
        fn = steps.make_prefill_step(cfg, shape)
        flops, out = count_flops(fn, specs["params"], specs["batch"])
    else:
        fn = steps.make_serve_step(cfg)
        flops, out = count_flops(fn, specs["params"], specs["tokens"], specs["cache"])
    coll, bw, rates = {}, LINK_BW, {}
    ins, outs, layout_extra = specs, out, 0
    if mesh is not None:
        split = mesh_axis_sizes(mesh)["model"] * _batch_shards(mesh, shape.global_batch)
        flops, mflops = flops / split, mflops / split
        coll = mesh_coll_bytes(cfg, shape, mesh, remat=remat, zero_opt=zero_opt)
        bw = link_bw(mesh_axis_sizes(mesh)["model"])
        rates = {"all-reduce data": data_link_bw(mesh), "all-gather data": data_link_bw(mesh)}
        ins, outs = _local_specs(cfg, shape, mesh, specs, out, zero_opt)
        layout_extra = _layout_extra_bytes(cfg, shape, mesh, ins, zero_opt)
    if shape.kind == "train":
        hbm = train_bytes(ins["params"], ins["opt_state"], ins["batch"],
                          remat=remat, microbatch=microbatch)
    elif shape.kind == "prefill":
        hbm = float(nbytes(ins["params"]) + nbytes(ins["batch"]) + nbytes(outs))
    else:
        ctx = steps.cache_len_for(cfg, shape) if context is None else context
        hbm = decode_bytes(cfg, ins["params"], ins["tokens"], ins["cache"], outs[0], ctx)
    mem = {"arg_bytes": nbytes(ins), "layout_extra_bytes": layout_extra,
           # a decode step writes its pools in place: only the logits are new
           "out_bytes": nbytes(outs[0]) if shape.kind == "decode" else nbytes(outs)}
    terms = RooflineTerms(flops=flops, hbm_bytes=hbm,
                          coll_bytes=None if coll is None else float(sum(coll.values())),
                          coll_breakdown=coll or {}, model_flops=mflops, dtype=cfg.dtype,
                          link_bw=bw, coll_rates=rates)
    return terms, mem
