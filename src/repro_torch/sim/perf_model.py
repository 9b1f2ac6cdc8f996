"""Analytic per-instance performance model (roofline-calibrated).

The port's copy of the reference's ``sim/perf_model.py``: the same formulas,
with the hardware constants of the card the port serves on. The paper
measures ITL/throughput-vs-batch-size on A100s (Fig. 3); the model
re-derives the same trade-off from first principles:

  decode step time(b) = max(compute, memory) + collective + overhead
    memory   = (weight_bytes + kv_bytes(b)) / (chips * HBM_bw)
    compute  = 2 * N_active * b / (chips * peak_flops)
    collective = 2 * d_model * bytes * (tp-1)/tp * n_layers / link_bw  (TP allreduce)

  preemption: when the resident KV demand exceeds the pool, evicted
  requests must re-prefill; each re-prefill steals decode time, inflating
  ITL and bending throughput DOWN past an inflection point — the exact
  phenomenon Chiron's TBP metric detects (paper Fig. 3).

A "chip" here is one card. ``PEAK_FLOPS``, ``HBM_BW``, ``HBM_BYTES`` and
``LINK_BW`` are data-sheet numbers of the NVIDIA H100 SXM5 80 GB (dense bf16
tensor-core peak, HBM3 bandwidth, HBM capacity, NVLink bandwidth per
direction). ``MBU`` and ``STEP_OVERHEAD`` are fitted to the card: the
graphed decode step at 8 slots (contexts of 72-328 tokens) of llama-8b,
phi3-mini-3.8b, olmo-1b, internvl2-2b and yi-34b in bf16, served by
``python3 chip_smoke.py`` (its ``perf_model`` line) on an NVIDIA H100 80GB
HBM3 at a 700.00 W power limit (torch 2.11.0+cu128). ``MBU`` is the
least-squares fit, in relative error, of weight plus KV bytes over
device-busy time (the five models' own shares of 3.35 TB/s run from 0.27,
olmo-1b, to 0.67, yi-34b: one share fits llama-8b to 1.4 % and the others
to 24-41 %); ``STEP_OVERHEAD`` is the median of wall minus device-busy time
of the five steps (the replay's gaps and the engine's bookkeeping).
``MFU_DECODE`` is the reference's assumption, kept. ``INSTANCE_CHIPS`` is
re-derived for 80 GB cards (see there).

All constants are module-level and overridable for calibration tests; they
are folded into each ``PerfModel`` when it is built.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict

from repro_torch.configs import get_config
from repro_torch.configs.base import ModelConfig

# NVIDIA H100 SXM5 80 GB, data sheet
PEAK_FLOPS = 989e12          # bf16 dense FLOP/s per card
HBM_BW = 3.35e12             # bytes/s per card (HBM3)
HBM_BYTES = 80e9             # per card
LINK_BW = 450e9              # bytes/s per direction (NVLink 4)
BYTES_PER_PARAM = 2          # bf16 weights
STEP_OVERHEAD = 7.425e-4     # host and replay time per graphed decode step (fitted)
MFU_DECODE = 0.6             # achievable fraction of peak in decode GEMMs
MBU = 0.4761                 # achieved HBM bandwidth fraction in decode (fitted)

# default tensor-parallel instance sizes (cards per serving instance): the
# fewest cards, a power of two, whose 80 GB hold the bf16 weights with at
# least a fifth of the memory left for the KV cache (llama-70b's 141 GB
# would leave 12 % of two cards, yi-34b's 69 GB 14 % of one). A planning
# rule for KV headroom, not what a model needs: yi-34b serves on one card
# with a pool of 8 x 1024 tokens (2.01 GB beside its weights).
INSTANCE_CHIPS: Dict[str, int] = {
    "llama-8b": 1, "llama-70b": 4,
    "olmo-1b": 1, "granite-8b": 1, "zamba2-2.7b": 1, "phi3-mini-3.8b": 1,
    "yi-34b": 2, "mamba2-1.3b": 1, "qwen2-moe-a2.7b": 1,
    "deepseek-moe-16b": 1, "whisper-base": 1, "internvl2-2b": 1,
}


@dataclass
class PerfModel:
    """Latency/throughput/memory responses for one (model, instance) pair:
    what Algorithm 2 plans a batch instance's throughput from. (The
    reference's prefix-caching, speculative-decoding and accelerator-scale
    knobs serve only its simulator and fleet; they come with Queue A
    item 9.)"""
    model_name: str
    chips: int = 0
    cfg: ModelConfig = None

    def __post_init__(self):
        self.cfg = self.cfg or get_config(self.model_name)
        self.chips = self.chips or INSTANCE_CHIPS.get(self.model_name, 4)
        self.n_params = self.cfg.param_count()
        self.n_active = self.cfg.active_param_count()
        self.weight_bytes = self.n_params * BYTES_PER_PARAM
        # fold every shape-derived constant once
        self._kv_per_tok = self._kv_bytes_per_token()
        free = self.chips * HBM_BYTES - self.weight_bytes
        self._kv_cap = float("inf") if self._kv_per_tok <= 0 else \
            max(free, 0) * 0.9 / self._kv_per_tok   # 10% activation headroom
        mem_bw = self.chips * HBM_BW * MBU
        self._flops_per_s = self.chips * PEAK_FLOPS * MFU_DECODE
        self._mem_t_base = self.weight_bytes / mem_bw
        self._mem_t_per_kvtok = self._kv_per_tok / mem_bw
        self._comp_t_per_seq = 2 * self.n_active / self._flops_per_s
        self._coll_t = 0.0
        if self.chips > 1:
            coll_bytes = 2 * self.cfg.d_model * BYTES_PER_PARAM * \
                self.cfg.n_layers * (self.chips - 1) / self.chips
            self._coll_t = coll_bytes / LINK_BW

    # ------------------------------------------------------------ memory
    def _kv_bytes_per_token(self) -> float:
        cfg = self.cfg
        hd = cfg.resolved_head_dim
        if cfg.arch_type == "ssm":
            return 0.0  # O(1) state, amortized to ~0 per token
        n_attn_layers = cfg.n_layers
        if cfg.arch_type == "hybrid":
            n_attn_layers = cfg.n_layers // max(cfg.attn_every, 1)
        return 2 * n_attn_layers * cfg.n_kv_heads * hd * BYTES_PER_PARAM

    def kv_capacity_tokens(self) -> float:
        return self._kv_cap

    # ------------------------------------------------------------ latency
    def itl(self, batch_size: int, mean_ctx: float = 1024.0) -> float:
        """Inter-token latency at a given running batch size."""
        b = max(batch_size, 1)
        mem_t = self._mem_t_base + b * mean_ctx * self._mem_t_per_kvtok
        comp_t = b * self._comp_t_per_seq
        t = max(mem_t, comp_t) + self._coll_t + STEP_OVERHEAD
        # preemption inflation past the KV-capacity inflection point
        t *= self.preemption_factor(b, mean_ctx)
        return t

    def preemption_factor(self, batch_size: int, mean_ctx: float) -> float:
        """ITL multiplier from eviction/re-prefill past KV capacity."""
        cap = self.kv_capacity_tokens()
        if not math.isfinite(cap):
            return 1.0
        demand = batch_size * mean_ctx
        if demand <= cap:
            return 1.0
        over = demand / cap - 1.0
        # each over-capacity fraction triggers re-prefills worth ~ctx tokens
        return 1.0 + 4.0 * over + 8.0 * over * over

    def throughput(self, batch_size: int, mean_ctx: float = 1024.0) -> float:
        """Aggregate decode tokens/s at a given batch size."""
        return batch_size / self.itl(batch_size, mean_ctx)

    # ------------------------------------------------------------ scaling
    def optimal_batch(self, itl_slo: float, mean_ctx: float = 1024.0,
                      max_batch: int = 4096) -> int:
        """Largest batch meeting the ITL SLO without throughput regression —
        the fixed point Algorithm 1 converges to."""
        best, best_b = 0.0, 1
        for b in range(1, max_batch + 1):
            t = self.itl(b, mean_ctx)
            thr = b / t
            if t > itl_slo:
                break
            if thr <= best:
                break
            best, best_b = thr, b
        return best_b
