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

Not ported: ``extract_terms`` (XLA's HLO cost analysis) and
``collective_bytes`` / ``_shape_bytes`` (collectives parsed from HLO text),
which have no torch counterpart (ROADMAP.md Queue A item 8b-i); one card
moves no collective bytes.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple

import torch
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs.base import InputShape, ModelConfig
from repro_torch.launch import steps
from repro_torch.sim.perf_model import HBM_BW, LINK_BW, PEAK_FLOPS
from repro_torch.training import tree

FP32_FLOPS = 67e12          # float32 FLOP/s without the tensor cores (H100 SXM)
CARD_BYTES = 85.02e9        # the card's memory as torch reports it (H100 80GB HBM3)


def peak_flops(dtype: str) -> float:
    return FP32_FLOPS if dtype == "float32" else PEAK_FLOPS


@dataclass
class RooflineTerms:
    flops: float                 # FLOPs of the step (FlopCounterMode)
    hbm_bytes: float             # bytes the step must move (step_bytes)
    coll_bytes: float            # collective bytes (0 on one card)
    coll_breakdown: Dict[str, int] = field(default_factory=dict)
    model_flops: float = 0.0     # 6*N*D (or 6*N_active*D) useful FLOPs
    dtype: str = "bfloat16"      # the step's dtype: picks the peak

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
    def collective_s(self) -> float:
        return self.coll_bytes / LINK_BW

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def step_time_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

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


def plan(cfg: ModelConfig, shape: InputShape, *, remat: bool = True,
         microbatch: int = 0, context: Optional[float] = None
         ) -> Tuple[RooflineTerms, Dict[str, int]]:
    """The roofline terms of ``shape``'s step on the meta device, and its
    memory: ``arg_bytes`` (parameters, plus the cache for decode, plus
    AdamW's state and the batch for train; the prefill's prompt too) and
    ``out_bytes`` (what the step returns). Activations are not counted.
    ``context``: the positions a decode step reads a sequence (default: the
    cache's length)."""
    cfg = steps.resolve_config(cfg, shape)
    specs = steps.input_specs(cfg, shape)
    mflops = model_flops_for(cfg, shape)
    if shape.kind == "train":
        fn = steps.make_train_step(cfg, remat=remat, microbatch=microbatch)
        flops, out = count_flops(fn, specs["params"], specs["opt_state"],
                                 specs["batch"])
        hbm = train_bytes(specs["params"], specs["opt_state"], specs["batch"],
                          remat=remat, microbatch=microbatch)
    elif shape.kind == "prefill":
        fn = steps.make_prefill_step(cfg, shape)
        flops, out = count_flops(fn, specs["params"], specs["batch"])
        hbm = float(nbytes(specs["params"]) + nbytes(specs["batch"]) + nbytes(out))
    else:
        fn = steps.make_serve_step(cfg)
        flops, out = count_flops(fn, specs["params"], specs["tokens"], specs["cache"])
        ctx = steps.cache_len_for(cfg, shape) if context is None else context
        hbm = decode_bytes(cfg, specs["params"], specs["tokens"], specs["cache"],
                           out[0], ctx)
    mem = {"arg_bytes": nbytes(specs),
           # a decode step writes its pools in place: only the logits are new
           "out_bytes": nbytes(out[0]) if shape.kind == "decode" else nbytes(out)}
    terms = RooflineTerms(flops=flops, hbm_bytes=hbm, coll_bytes=0.0,
                          model_flops=mflops, dtype=cfg.dtype)
    return terms, mem
