"""Baseline autoscalers the paper compares against (§6 Experiment Setup).

- ``LlumnixAutoscaler``: Llumnix-style — keeps average token (memory/slot)
  utilization across instances inside a configurable [low, high] band by
  adding/removing one serving instance at a time; SLO-unaware; no request
  queuing (instances are added immediately on backlog). The "tuned"
  variant is the same policy with a per-workload parameter sweep (the
  reference's benchmarks/fig9/fig10 sweep the band).
- ``StaticAutoscaler``: fixed instance count (ablation support).
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass
class LlumnixAutoscaler:
    """Utilization-band autoscaler. update() returns +1 / 0 / -1 instances."""
    low: float = 0.3
    high: float = 0.8
    min_instances: int = 1
    scale_up_step: int = 1          # Llumnix adds capacity gradually (§6.2)

    def update(self, avg_utilization: float, n_instances: int,
               n_queued: int = 0) -> int:
        # queued work immediately counts as pressure (no SLO-aware queuing)
        if n_queued > 0 or avg_utilization > self.high:
            return self.scale_up_step
        if avg_utilization < self.low and n_instances > self.min_instances:
            return -1
        return 0


@dataclass
class StaticAutoscaler:
    n_instances: int = 1

    def update(self, avg_utilization: float, n_instances: int,
               n_queued: int = 0) -> int:
        return self.n_instances - n_instances


@dataclass
class UtilizationGlobalScaler:
    """Chiron's global autoscaler replaced by a pure utilization policy —
    the "Local" ablation arm in Fig. 18 (local autoscaler kept, global
    replaced)."""
    low: float = 0.3
    high: float = 0.8
    min_instances: int = 1

    def update(self, avg_utilization: float, n_instances: int,
               n_queued: int = 0) -> int:
        if avg_utilization > self.high or n_queued > 0:
            return 1
        if avg_utilization < self.low and n_instances > self.min_instances:
            return -1
        return 0
