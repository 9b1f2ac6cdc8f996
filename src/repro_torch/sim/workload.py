"""Workload generation: ShareGPT-like token distributions, Poisson or
Gamma arrivals, an interactive/batch class mix.

The port's copy of what ``launch.serve`` and the global layer need of
``repro.sim.workload``: ``WorkloadSpec``, ``generate``, and the
arrival-spike statistics behind Theta (``arrival_spikes``,
``theta_from_history``). The draws are made in the same order from the
same ``numpy`` generator (batch-queue token lengths, live token lengths,
gaps, class coin flips), so one spec and seed give the same requests here
and there. The columnar ``Trace`` plane (trace files,
multi-model fleets, retries) belongs to the simulator and is not needed
by a serving instance, so ``_arrival_column`` takes request lists and
arrays only.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np

from repro_torch.serving.request import (BATCH_ITL_SLO, INTERACTIVE_ITL_SLO,
                                         INTERACTIVE_TTFT_SLO, Request,
                                         RequestType, SLO)

# ShareGPT-ish lognormal parameters (Fig. 8: median input ~100 tokens with a
# heavy tail; outputs somewhat longer)
INPUT_MU, INPUT_SIGMA = 4.6, 1.0      # median ~100, mean ~165
OUTPUT_MU, OUTPUT_SIGMA = 5.2, 0.9    # median ~180, mean ~270
MAX_TOKENS = 2048

DEFAULT_MODEL = "llama-8b"


@dataclass
class WorkloadSpec:
    n_requests: int = 3500
    arrival_rate: float = 10.0        # requests/s
    interactive_frac: float = 1.0     # 1.0 = W_A; <1 adds batch requests
    process: str = "poisson"          # poisson | gamma
    cv: float = 1.0                   # Gamma coefficient of variation
    model: str = DEFAULT_MODEL
    batch_ttft_slo: float = 3600.0
    seed: int = 0
    # batch-queue mode (W_B): dump `batch_queue_size` batch requests at t=0
    batch_queue_size: int = 0


def _token_lengths(rng: np.random.Generator, n: int):
    ins = np.clip(rng.lognormal(INPUT_MU, INPUT_SIGMA, n), 4, MAX_TOKENS)
    outs = np.clip(rng.lognormal(OUTPUT_MU, OUTPUT_SIGMA, n), 4, MAX_TOKENS)
    return ins.astype(np.int64), outs.astype(np.int64)


def _interarrival(rng: np.random.Generator, spec: WorkloadSpec, n: int) -> np.ndarray:
    mean = 1.0 / max(spec.arrival_rate, 1e-9)
    if spec.process == "poisson":
        return rng.exponential(mean, n)
    # Gamma with CV: shape k = 1/cv^2, scale = mean*cv^2
    k = 1.0 / (spec.cv ** 2)
    return rng.gamma(k, mean * spec.cv ** 2, n)


def generate(spec: WorkloadSpec) -> List[Request]:
    """Draw the request stream of ``spec``, sorted by arrival time."""
    rng = np.random.default_rng(spec.seed)
    arrival, ins, outs, inter = [], [], [], []

    if spec.batch_queue_size > 0:
        q_in, q_out = _token_lengths(rng, spec.batch_queue_size)
        arrival.append(np.zeros(spec.batch_queue_size))
        ins.append(q_in)
        outs.append(q_out)
        inter.append(np.zeros(spec.batch_queue_size, dtype=bool))

    n = spec.n_requests
    l_in, l_out = _token_lengths(rng, n)
    arrival.append(np.cumsum(_interarrival(rng, spec, n)))
    ins.append(l_in)
    outs.append(l_out)
    inter.append(rng.random(n) < spec.interactive_frac)

    arrival = np.concatenate(arrival)
    order = np.argsort(arrival, kind="stable")
    cols = zip(arrival[order].tolist(), np.concatenate(ins)[order].tolist(),
               np.concatenate(outs)[order].tolist(),
               np.concatenate(inter)[order].tolist())
    reqs = []
    for t, p, o, interactive in cols:
        if interactive:
            rtype = RequestType.INTERACTIVE
            slo = SLO(INTERACTIVE_TTFT_SLO, INTERACTIVE_ITL_SLO)
        else:
            rtype = RequestType.BATCH
            slo = SLO(float(spec.batch_ttft_slo), BATCH_ITL_SLO)
        reqs.append(Request(p, o, rtype, slo, arrival_time=t,
                            model=spec.model))
    return reqs


def _arrival_column(source) -> np.ndarray:
    """Arrival times from an ndarray/sequence of floats, or a sequence of
    Request-likes (anything with ``.arrival_time``)."""
    if isinstance(source, np.ndarray):
        return source.astype(np.float64, copy=False)
    src = list(source)
    if not src:
        return np.empty(0)
    if hasattr(src[0], "arrival_time"):
        return np.fromiter((r.arrival_time for r in src), dtype=np.float64,
                           count=len(src))
    return np.asarray(src, dtype=np.float64)


def arrival_spikes(source, interval: float = 30.0) -> np.ndarray:
    """Paper §2.3: ratio of arrival rate between consecutive intervals of
    length = model load time. Used by the Theta-from-history heuristic.

    Vectorized: one ``np.bincount`` over the arrival column, a shifted
    ratio, and a mask — O(n + bins) with no per-request Python loop.
    """
    times = _arrival_column(source)
    if times.size == 0:
        return np.empty(0)
    counts = np.bincount((times / interval).astype(np.int64))
    prev, nxt = counts[:-1], counts[1:]
    mask = prev > 0
    return nxt[mask] / prev[mask]


def theta_from_history(source, interval: float = 30.0,
                       pct: float = 99.0) -> float:
    """Theta = 1 / tail-spike (paper §5.2 example: spike 3x -> Theta=1/3)."""
    spikes = arrival_spikes(source, interval)
    if spikes.size == 0:
        return 1.0 / 3.0
    tail = float(np.percentile(spikes, pct))
    return 1.0 / max(tail, 1.0)
