"""Local autoscaler — Algorithm 1 (batch-size autoscaling).

Online control of an instance's max batch size from local backpressure; no
offline profiling. If backpressure >= 1 the batch size is halved; otherwise
it grows by an EWMA-weighted proportional step:

    bs <- alpha * (1/bp) * bs + (1 - alpha) * bs

As bp -> 1 the growth slows, converging to the largest batch size that
meets the ITL SLO without a throughput regression (paper Fig. 11/12).
A growth-factor cap (default 2x/update) bounds the proportional term when
backpressure is near zero — an implementation guard, the fixed point is
unchanged.

Reproduction note (recorded in EXPERIMENTS.md §Repro-claims): Algorithm 1
as literally printed is unstable — at any throughput steady state
TBP = thr_prev/thr_curr = 1, which takes the "else" branch and halves the
batch size; the halving lowers throughput, so TBP stays > 1 and the batch
size collapses to 1. The paper's own description ("if TBP > 1, no
throughput gain is observed from INCREASING the batch size") implies TBP
judges growth steps, so we (a) evaluate TBP only when the previous action
increased the batch size, and (b) treat bp == 1 as the fixed point (no
change). With this reading the controller converges to the Fig. 3
inflection exactly as Fig. 11/12 report.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

from repro_torch.core.backpressure import LocalMetrics, local_backpressure


@dataclass
class LocalAutoscaler:
    itl_slo: float                      # overridden per-update by resident min
    alpha: float = 0.5                  # EWMA smoothing factor (paper value)
    min_batch: int = 1
    max_batch: int = 4096
    init_batch: int = 8
    max_growth: float = 2.0             # cap on per-update growth factor

    # AIMD-style stabilization: remember the batch size that violated and
    # regrow toward (not past) it; relax the ceiling slowly so the
    # controller stays adaptive to workload drift. Without this the 2x
    # regrow jumps back over sharp inflections (KV preemption cliffs) and
    # the controller limit-cycles instead of converging (Fig. 11/12 show
    # flat converged lines).
    ceiling_shrink: float = 0.95
    ceiling_relax: float = 1.02
    # graduated decrease: halving is right for gross violations (the paper's
    # case: ITL 2x over SLO), but a 5-15% throughput dip just past the
    # inflection only needs a proportional step back (floored at
    # mild_decrease) — halving there reopens the gap the controller just
    # closed and produces sawtooth batch sizes.
    mild_violation: float = 1.25
    mild_decrease: float = 0.9
    # EWMA on the throughput input to TBP (ROADMAP robustness item): the
    # raw metric is sampled at control-tick grain, where one sequence
    # finishing just before vs. just after the tick flips TBP across 1 and
    # different engines/sampling grains converge to different batch-size
    # ceilings. Smoothing the *input* keeps Algorithm 1 itself unchanged
    # (alpha_thr=1 reproduces the raw-sample behaviour exactly) while
    # making its fixed point grain-invariant.
    thr_ewma_alpha: float = 0.5

    max_batch_size: int = field(init=False)
    _prev_throughput: Optional[float] = field(default=None, init=False)
    _thr_ewma: Optional[float] = field(default=None, init=False)
    _prev_batch: int = field(default=0, init=False)
    _ceiling: Optional[float] = field(default=None, init=False)
    history: List[int] = field(default_factory=list, init=False)

    def __post_init__(self):
        self.max_batch_size = self.init_batch
        self._prev_batch = self.init_batch

    def update(self, m: LocalMetrics) -> int:
        """One Algorithm-1 iteration; returns the new max batch size."""
        slo = m.itl_slo if m.itl_slo > 0 else self.itl_slo
        # TBP judges the last growth step (see reproduction note above):
        # an absolute throughput regression after growing means the batch
        # size crossed the Fig. 3 inflection. LBP alone paces the EWMA
        # growth — using the TBP ratio as a growth divisor would throttle
        # proportionally to the step size, not to SLO proximity.
        grew = self.max_batch_size > self._prev_batch
        prev_thr = self._prev_throughput if grew else None
        a = self.thr_ewma_alpha
        thr = m.throughput if self._thr_ewma is None else \
            a * m.throughput + (1.0 - a) * self._thr_ewma
        self._thr_ewma = thr
        bp = local_backpressure(m.observed_itl, slo, prev_thr, thr)
        lbp = m.observed_itl / slo
        bs = float(self.max_batch_size)
        self._prev_batch = self.max_batch_size
        if bp > 1.0:
            self._ceiling = bs
            if bp < self.mild_violation:
                # proportional step back, floored at mild_decrease: a
                # barely-over-1 (smoothed) TBP excursion costs ~nothing,
                # so sampling noise cannot ratchet the ceiling down —
                # the EWMA bounds the excursion, this bounds its damage
                bs = bs * max(1.0 / bp, self.mild_decrease)
            else:
                bs = bs / 2.0
        else:
            if lbp <= 0.0:
                factor = self.max_growth
            else:
                factor = self.alpha * (1.0 / lbp) + (1.0 - self.alpha)
                factor = min(factor, self.max_growth)
            target = factor * bs
            if self._ceiling is not None:
                target = min(target, self.ceiling_shrink * self._ceiling)
                self._ceiling *= self.ceiling_relax
            if target > bs:
                target = max(target, bs + 1)   # don't stall on rounding
            bs = max(target, bs)   # a growth decision never shrinks
        self.max_batch_size = int(max(self.min_batch,
                                      min(self.max_batch, round(bs))))
        self._prev_throughput = thr
        self.history.append(self.max_batch_size)
        return self.max_batch_size

    def converged(self, window: int = 6, tol: float = 0.1) -> bool:
        """Batch size stable within +-tol over the last ``window`` updates."""
        if len(self.history) < window:
            return False
        tail = self.history[-window:]
        lo, hi = min(tail), max(tail)
        return hi - lo <= max(1, tol * hi)
