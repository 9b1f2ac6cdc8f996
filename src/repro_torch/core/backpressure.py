"""Hierarchical backpressure metrics — the heart of Chiron (§4.1, §5.1).

Local (per serving instance):
  LBP = observed_ITL / ITL_SLO              (>1 -> ITL SLO being violated)
  TBP = throughput_prev / throughput_curr   (>1 -> batch growth stopped paying)
  local backpressure = max(LBP, TBP)

Global (cluster):
  IBP = instances_running_interactive / (interactive + mixed instances)
  BBP = #(request groups whose estimated waiting time exceeds TTFT SLO)
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

_EPS = 1e-9


def latency_backpressure(observed_itl: float, itl_slo: float) -> float:
    return observed_itl / max(itl_slo, _EPS)


def throughput_backpressure(throughput_prev: Optional[float],
                            throughput_curr: float) -> float:
    """>1 when throughput dropped after the last batch-size increase."""
    if throughput_prev is None or throughput_prev <= 0:
        return 0.0
    return throughput_prev / max(throughput_curr, _EPS)


def local_backpressure(observed_itl: float, itl_slo: float,
                       throughput_prev: Optional[float],
                       throughput_curr: float) -> float:
    return max(latency_backpressure(observed_itl, itl_slo),
               throughput_backpressure(throughput_prev, throughput_curr))


def interactive_backpressure(n_running_interactive: int,
                             n_interactive_instances: int,
                             n_mixed_instances: int) -> float:
    denom = n_interactive_instances + n_mixed_instances
    if denom == 0:
        return 1.0 if n_running_interactive > 0 else 0.0
    return n_running_interactive / denom


@dataclass
class LocalMetrics:
    """What an instance reports to its local autoscaler each interval."""
    observed_itl: float        # seconds/token, mean over the interval
    throughput: float          # tokens/s over the interval
    itl_slo: float             # min ITL SLO among resident requests
    n_active: int = 0
    batch_size: int = 0
