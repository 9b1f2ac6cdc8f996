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

``_LOAD_BW`` is measured on the card too: the host-to-card rate of a
checkpoint load (``chip_smoke.py``'s ``sim`` phase). The clamp of
``model_load_time`` to 15-60 s is the paper's model-load range, no card's
measurement.

All constants are module-level and overridable for calibration tests. Each
``PerfModel`` folds them in when it is built, the step overhead and the load
rate included, and the simulator's instances read them from their model
only: one patch of this module's constants, made before a ``PerfModel`` is
built, covers every reader.
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

# model-load times: the paper's range is 15 s - 1 min (the clamp in
# ``model_load_time``), scaled with checkpoint size over the rate a
# checkpoint reaches the card. Measured by ``chip_smoke.py``'s ``sim`` phase
# on an NVIDIA H100 80GB HBM3 at a 700.00 W power limit: llama-8b's bf16
# parameter tree (16.06 GB) from pageable host memory, the median of three
# loads (4.74-5.36 GB/s).
_LOAD_BW = 5.090649192359789e9   # bytes/s host->HBM per card


@dataclass
class PerfModel:
    """Latency/throughput/memory responses for one (model, instance) pair.

    Accelerator variants: the ``*_scale`` fields derate or boost this
    module's H100 baseline constants (compute, HBM bandwidth, HBM capacity)
    for another part, and every latency, capacity and throughput response
    shifts with them.
    """
    model_name: str
    chips: int = 0
    cfg: ModelConfig = None
    # optimization knobs that shift the optimum the local autoscaler finds
    # (paper Fig. 11): prefix caching preloads KV; spec decode adds draft work
    prefix_caching: bool = False
    speculative_decoding: bool = False
    prefix_hit_tokens: int = 512
    spec_draft_overhead: float = 0.15
    spec_accept_speedup: float = 2.0
    # accelerator scaling relative to the H100 baseline constants above
    flops_scale: float = 1.0
    hbm_bw_scale: float = 1.0
    hbm_bytes_scale: float = 1.0

    def __post_init__(self):
        self.cfg = self.cfg or get_config(self.model_name)
        self.chips = self.chips or INSTANCE_CHIPS.get(self.model_name, 4)
        self.n_params = self.cfg.param_count()
        self.n_active = self.cfg.active_param_count()
        self.weight_bytes = self.n_params * BYTES_PER_PARAM
        # The hot-path responses (itl / can_admit) run millions of times per
        # simulation; fold every shape-derived constant once, and the
        # module's step overhead and load rate with them.
        self.step_overhead = STEP_OVERHEAD
        self._load_bw = _LOAD_BW
        self._kv_per_tok = self._kv_bytes_per_token()
        free = self.chips * HBM_BYTES * self.hbm_bytes_scale \
            - self.weight_bytes
        self._kv_cap = float("inf") if self._kv_per_tok <= 0 else \
            max(free, 0) * 0.9 / self._kv_per_tok   # 10% activation headroom
        mem_bw = self.chips * HBM_BW * self.hbm_bw_scale * MBU
        self._flops_per_s = self.chips * PEAK_FLOPS * self.flops_scale \
            * MFU_DECODE
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

    def kv_bytes_per_token(self) -> float:
        return self._kv_per_tok

    def kv_capacity_tokens(self) -> float:
        return self._kv_cap

    # ------------------------------------------------------------ latency
    def prefill_time(self, prompt_len: int) -> float:
        eff_len = prompt_len
        if self.prefix_caching:
            eff_len = max(prompt_len - self.prefix_hit_tokens, 16)
        flops = 2 * self.n_active * eff_len
        return flops / self._flops_per_s + self.step_overhead

    def itl(self, batch_size: int, mean_ctx: float = 1024.0) -> float:
        """Inter-token latency at a given running batch size."""
        b = max(batch_size, 1)
        mem_t = self._mem_t_base + b * mean_ctx * self._mem_t_per_kvtok
        comp_t = b * self._comp_t_per_seq
        t = max(mem_t, comp_t) + self._coll_t + self.step_overhead
        if self.speculative_decoding:
            t = t * (1 + self.spec_draft_overhead * math.sqrt(b)) \
                / self.spec_accept_speedup
        # preemption inflation past the KV-capacity inflection point
        t *= self.preemption_factor(b, mean_ctx)
        return t

    def preemption_factor(self, batch_size: int, mean_ctx: float) -> float:
        """ITL multiplier from eviction/re-prefill past KV capacity."""
        cap = self.kv_capacity_tokens()
        if not math.isfinite(cap):
            return 1.0
        eff_ctx = mean_ctx
        if self.prefix_caching:
            eff_ctx = mean_ctx + self.prefix_hit_tokens  # preloaded prefix KV
        demand = batch_size * eff_ctx
        if demand <= cap:
            return 1.0
        over = demand / cap - 1.0
        # each over-capacity fraction triggers re-prefills worth ~ctx tokens
        return 1.0 + 4.0 * over + 8.0 * over * over

    def throughput(self, batch_size: int, mean_ctx: float = 1024.0) -> float:
        """Aggregate decode tokens/s at a given batch size."""
        return batch_size / self.itl(batch_size, mean_ctx)

    def max_stable_batch(self, mean_ctx: float = 1024.0) -> int:
        return int(self.kv_capacity_tokens() / max(mean_ctx, 1))

    # ------------------------------------------------------------ scaling
    def model_load_time(self) -> float:
        return max(15.0, min(self.weight_bytes / (self.chips * self._load_bw),
                             60.0))

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
