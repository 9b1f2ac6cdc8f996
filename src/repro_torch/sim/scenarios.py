"""Scenario library: named workload generators beyond the paper's traces.

Each scenario builds a columnar :class:`~repro_torch.sim.workload.Trace`
exercising a distinct control-plane regime — diurnal capacity tracking,
spike absorption (Theta), multi-tenant SLO mixes, heavy-tail output
lengths, batch-backlog drains, multi-model fleets, trace replay,
instance-failure injection, slow-node degradation, and the multi-cluster
fleet plane (region-aware routing, batch consolidation, spillover,
heterogeneous accelerators) — in the trace-driven multi-SLO evaluation
style of SLOs-Serve (arXiv:2504.08784) and the forecast/diurnal workloads
of SageServe (arXiv:2502.14617). Generation is fully vectorized (NumPy
column fills, no per-request Python loop), so million-request scenarios
build in well under a second.

The port's copy of the reference's ``sim/scenarios.py``: the same 16
builders draw the same columns from the same seed, and their lazy imports
(trace files, fleets, failure plans, overload) go to the port's modules.
Scenarios register into ``SCENARIOS``::

    from repro_torch.sim.scenarios import SCENARIOS, build, build_trace
    reqs, sim_kw = build("diurnal", n_requests=5000, seed=0)      # Requests
    trace, sim_kw = build_trace("trace_replay", n_requests=10**6) # columnar

Every builder takes ``(n_requests, seed, **overrides)`` and returns
``(trace, sim_kwargs)``; ``build`` materializes the trace into ``Request``
objects for legacy callers while ``build_trace`` hands the columnar form
straight to ``simulate_events`` (lazy chunked materialization).
``sim_kwargs`` carries a suggested ``max_time`` and, where relevant,
a ``failures`` :class:`~repro_torch.sim.simulator.FailurePlan` /
``degradations`` :class:`~repro_torch.sim.simulator.DegradationPlan` /
``outages`` :class:`~repro_torch.sim.simulator.OutagePlan` /
``flash_crowds`` :class:`~repro_torch.sim.simulator.FlashCrowdPlan` to pass to
``simulate_events``, a ``models`` tuple for configuring a multi-model
controller (``ChironController(models=...)``), and — for the fleet
scenarios — a zero-arg ``fleet`` factory building the
:class:`~repro_torch.sim.fleet.Fleet` that ``simulate_fleet`` drives (the trace
itself stays single-cluster-compatible: origins are simply ignored by the
single-cluster engines).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.serving.request import BATCH_ITL_SLO, Request
from repro_torch.sim.workload import (MAX_TOKENS, Trace, _token_lengths,
                                make_trace)

SimKwargs = Dict[str, object]
Builder = Callable[..., Tuple[Trace, SimKwargs]]


@dataclass
class Scenario:
    name: str
    description: str
    build: Builder
    default_n: int = 3000


SCENARIOS: Dict[str, Scenario] = {}


def register(name: str, description: str, default_n: int = 3000):
    def deco(fn: Builder) -> Builder:
        SCENARIOS[name] = Scenario(name, description, fn, default_n)
        return fn
    return deco


def build_trace(name: str, n_requests: int = 0, seed: int = 0,
                **overrides) -> Tuple[Trace, SimKwargs]:
    """Columnar form — feed the Trace straight to ``simulate_events``."""
    sc = SCENARIOS[name]
    return sc.build(n_requests or sc.default_n, seed, **overrides)


def build(name: str, n_requests: int = 0, seed: int = 0,
          **overrides) -> Tuple[List[Request], SimKwargs]:
    """Legacy form: materialized ``Request`` objects."""
    trace, kw = build_trace(name, n_requests, seed, **overrides)
    return trace.materialize(), kw


def _nonhomogeneous_arrivals(rng: np.random.Generator, n: int,
                             rate_fn: Callable[[np.ndarray], np.ndarray],
                             rate_max: float, horizon: float) -> np.ndarray:
    """Thinning sampler for a non-homogeneous Poisson process; returns the
    first ``n`` accepted arrival times (wraps the horizon if needed).
    Candidates are drawn and thinned in vectorized batches."""
    chunks: List[np.ndarray] = []
    got = 0
    t = 0.0
    while got < n:
        # draw candidate gaps in bulk at the envelope rate
        gaps = rng.exponential(1.0 / rate_max, size=max(n, 1024))
        ts = t + np.cumsum(gaps)
        keep = ts[rng.random(ts.size) < rate_fn(ts % horizon) / rate_max]
        chunks.append(keep)
        got += keep.size
        t = float(ts[-1])
    return np.concatenate(chunks)[:n]


# --------------------------------------------------------------- scenarios
@register("diurnal",
          "sinusoidal day/night arrival rate; capacity must track the wave",
          default_n=4000)
def diurnal(n_requests: int, seed: int = 0, *, period: float = 1800.0,
            base_rate: float = 6.0, amplitude: float = 0.85,
            interactive_frac: float = 0.85,
            batch_ttft_slo: float = 900.0) -> Tuple[Trace, SimKwargs]:
    rng = np.random.default_rng(seed)
    rate_max = base_rate * (1 + amplitude)

    def rate(ts: np.ndarray) -> np.ndarray:
        return base_rate * (1 + amplitude * np.sin(2 * np.pi * ts / period))

    times = _nonhomogeneous_arrivals(rng, n_requests, rate, rate_max, period)
    ins, outs = _token_lengths(rng, n_requests)
    cls = rng.random(n_requests) < interactive_frac
    trace = make_trace(times, ins, outs, cls, batch_ttft_slo=batch_ttft_slo)
    return trace, {"max_time": trace.duration + 600.0}


@register("burst_spikes",
          "quiet Poisson base + short high-rate spikes separated by idle "
          "gaps; stresses Theta over-provisioning and idle-skip",
          default_n=4000)
def burst_spikes(n_requests: int, seed: int = 0, *, n_bursts: int = 8,
                 burst_rate: float = 120.0, base_rate: float = 0.5,
                 gap: float = 300.0,
                 interactive_frac: float = 1.0) -> Tuple[Trace, SimKwargs]:
    rng = np.random.default_rng(seed)
    n_bursts = max(min(n_bursts, n_requests), 1)   # tiny-n guard
    per_burst = max(n_requests // n_bursts, 1)
    # each burst is a Poisson run; bursts are separated by ``gap`` of
    # silence — cumulative sum over per-burst gap offsets, all vectorized
    gaps = rng.exponential(1.0 / burst_rate, (n_bursts, per_burst))
    within = np.cumsum(gaps, axis=1)
    starts = 30.0 + np.concatenate(
        ([0.0], np.cumsum(within[:-1, -1] + gap)))
    times = (starts[:, None] + within).ravel()
    t_end = float(times[-1])
    # sparse background traffic between bursts
    n_bg = n_requests - per_burst * n_bursts
    if n_bg > 0:
        times = np.concatenate([times, rng.uniform(0.0, t_end + gap, n_bg)])
    n = times.size
    ins, outs = _token_lengths(rng, n)
    cls = rng.random(n) < interactive_frac
    trace = make_trace(times, ins, outs, cls)
    return trace, {"max_time": trace.duration + gap + 300.0}


@register("multi_tenant_slo",
          "four tenants with distinct (TTFT, ITL) SLO classes sharing the "
          "cluster: premium/standard interactive + urgent/overnight batch",
          default_n=4000)
def multi_tenant_slo(n_requests: int, seed: int = 0, *,
                     arrival_rate: float = 12.0) -> Tuple[Trace, SimKwargs]:
    rng = np.random.default_rng(seed)
    # (weight, interactive?, ttft_slo, itl_slo)
    tenants = np.array([
        (0.35, 1, 5.0, 0.1),       # premium chat
        (0.35, 1, 15.0, 0.3),      # standard chat
        (0.15, 0, 600.0, BATCH_ITL_SLO),    # urgent batch
        (0.15, 0, 3600.0, BATCH_ITL_SLO),   # overnight batch
    ])
    times = np.cumsum(rng.exponential(1.0 / arrival_rate, n_requests))
    ins, outs = _token_lengths(rng, n_requests)
    choice = rng.choice(len(tenants), size=n_requests,
                        p=tenants[:, 0] / tenants[:, 0].sum())
    trace = make_trace(times, ins, outs,
                       tenants[choice, 1].astype(bool),
                       ttft_slo=tenants[choice, 2],
                       itl_slo=tenants[choice, 3])
    return trace, {"max_time": trace.duration + 900.0}


@register("heavy_tail",
          "Pareto-tailed output lengths (a few requests generate for "
          "minutes); stresses completion estimates and KV growth",
          default_n=2500)
def heavy_tail(n_requests: int, seed: int = 0, *, arrival_rate: float = 8.0,
               pareto_shape: float = 1.2,
               interactive_frac: float = 0.8) -> Tuple[Trace, SimKwargs]:
    rng = np.random.default_rng(seed)
    times = np.cumsum(rng.exponential(1.0 / arrival_rate, n_requests))
    ins, _ = _token_lengths(rng, n_requests)
    outs = np.clip((rng.pareto(pareto_shape, n_requests) + 1) * 48,
                   4, 4 * MAX_TOKENS).astype(np.int64)
    cls = rng.random(n_requests) < interactive_frac
    trace = make_trace(times, ins, outs, cls, batch_ttft_slo=1800.0)
    return trace, {"max_time": trace.duration + 1800.0}


@register("backlog_drain",
          "large batch queue dumped at t=0 under a live interactive "
          "stream (Fig. 19 regime): deadline-driven bulk scaling",
          default_n=4000)
def backlog_drain(n_requests: int, seed: int = 0, *,
                  backlog_frac: float = 0.8, arrival_rate: float = 10.0,
                  batch_ttft_slo: float = 1200.0) -> Tuple[Trace, SimKwargs]:
    rng = np.random.default_rng(seed)
    n_backlog = int(n_requests * backlog_frac)
    n_live = n_requests - n_backlog
    ins_b, outs_b = _token_lengths(rng, n_backlog)
    backlog = make_trace(np.zeros(n_backlog), ins_b, outs_b,
                         np.zeros(n_backlog, dtype=bool),
                         batch_ttft_slo=batch_ttft_slo, sort=False)
    times = np.cumsum(rng.exponential(1.0 / arrival_rate, n_live))
    ins_l, outs_l = _token_lengths(rng, n_live)
    live = make_trace(times, ins_l, outs_l, np.ones(n_live, dtype=bool),
                      sort=False)
    trace = Trace.concat([backlog, live]).sorted_by_arrival()
    return trace, {"max_time": batch_ttft_slo + 1200.0}


@register("multi_model_fleet",
          "two-model fleet (8B chat + 70B premium) sharing one chip "
          "budget: per-model IBP/Algorithm-2 loops and model-keyed routing",
          default_n=4000)
def multi_model_fleet(n_requests: int, seed: int = 0, *,
                      models: Sequence[str] = ("llama-8b", "llama-70b"),
                      model_weights: Sequence[float] = (0.7, 0.3),
                      arrival_rate: float = 10.0,
                      interactive_frac: float = 0.85,
                      batch_ttft_slo: float = 900.0) -> Tuple[Trace, SimKwargs]:
    rng = np.random.default_rng(seed)
    w = np.asarray(model_weights, dtype=np.float64)
    times = np.cumsum(rng.exponential(1.0 / arrival_rate, n_requests))
    ins, outs = _token_lengths(rng, n_requests)
    cls = rng.random(n_requests) < interactive_frac
    midx = rng.choice(len(models), size=n_requests,
                      p=w / w.sum()).astype(np.int32)
    trace = make_trace(times, ins, outs, cls,
                       batch_ttft_slo=batch_ttft_slo,
                       model_idx=midx, models=tuple(models))
    return trace, {"max_time": trace.duration + 900.0,
                   "models": tuple(models)}


@register("trace_replay",
          "replay a CSV/JSONL trace (Azure LLM inference style) — or a "
          "synthetic stand-in with its conversation/code mix when no "
          "path is given; the 1M-request scale scenario",
          default_n=20000)
def trace_replay(n_requests: int, seed: int = 0, *,
                 path: Optional[str] = None,
                 stream: bool = False,
                 chunk_requests: int = 65536,
                 max_time: Optional[float] = None,
                 arrival_rate: float = 60.0,
                 code_frac: float = 0.35,
                 interactive_frac: float = 1.0,
                 slack: float = 600.0) -> Tuple[Trace, SimKwargs]:
    if path is not None:
        from repro_torch.sim.trace_io import load_trace, stream_trace
        if stream:
            # windowed replay: the file (gzip ok) is parsed in chunks as
            # the simulation consumes it — the multi-day-trace mode. The
            # horizon is unknowable without reading the whole file, so
            # pass ``max_time`` yourself to cap a run (default: run to
            # completion).
            src = stream_trace(path, chunk_requests=chunk_requests,
                               max_requests=n_requests)
            return src, {"max_time": float("inf") if max_time is None
                         else max_time}
        trace = load_trace(path, max_requests=n_requests)
        # deliberately no "models" kwarg: a production trace may carry
        # hundreds of transient deployments, and pre-configuring them all
        # would pin a permanent per-model instance floor — the controller's
        # on-demand discovery path provisions only models with live work
        # (pass models=... to the controller yourself for a small fleet)
        return trace, {"max_time": trace.duration + slack}
    # Azure-LLM-inference-style stand-in: a conversation class (short
    # prompts, chatty outputs) and a code class (long prompts, short
    # completions) under a mildly diurnal rate — the public trace's shape
    rng = np.random.default_rng(seed)
    period = max(n_requests / arrival_rate, 600.0)

    def rate(ts: np.ndarray) -> np.ndarray:
        return arrival_rate * (1 + 0.3 * np.sin(2 * np.pi * ts / period))

    times = _nonhomogeneous_arrivals(rng, n_requests, rate,
                                     1.3 * arrival_rate, period)
    is_code = rng.random(n_requests) < code_frac
    conv_in, conv_out = _token_lengths(rng, n_requests)
    code_in = np.clip(rng.lognormal(6.3, 0.8, n_requests), 32,
                      4 * MAX_TOKENS).astype(np.int64)   # median ~545
    code_out = np.clip(rng.lognormal(4.0, 0.7, n_requests), 4,
                       MAX_TOKENS).astype(np.int64)      # median ~55
    ins = np.where(is_code, code_in, conv_in)
    outs = np.where(is_code, code_out, conv_out)
    cls = rng.random(n_requests) < interactive_frac
    trace = make_trace(times, ins, outs, cls)
    return trace, {"max_time": trace.duration + slack}


@register("slow_nodes",
          "steady interactive stream with injected slow-node degradation "
          "(ITL inflation, not removal): detection via the health EWMA, "
          "routing must steer around the victims until they recover",
          default_n=3000)
def slow_nodes(n_requests: int, seed: int = 0, *,
               arrival_rate: float = 12.0,
               interactive_frac: float = 0.9,
               n_degradations: int = 3,
               factor: float = 4.0,
               duration: float = 240.0,
               batch_ttft_slo: float = 900.0) -> Tuple[Trace, SimKwargs]:
    from repro_torch.sim.simulator import DegradationPlan
    rng = np.random.default_rng(seed)
    times = np.cumsum(rng.exponential(1.0 / arrival_rate, n_requests))
    ins, outs = _token_lengths(rng, n_requests)
    cls = rng.random(n_requests) < interactive_frac
    trace = make_trace(times, ins, outs, cls, batch_ttft_slo=batch_ttft_slo)
    span = trace.duration
    deg_times = np.sort(span * (0.15 + 0.6 * rng.random(n_degradations)))
    return trace, {"max_time": span + 900.0,
                   "degradations": DegradationPlan(
                       deg_times.tolist(), factor=factor,
                       duration=duration, seed=seed)}


# ---------------------------------------------------------- fleet scenarios
def _origin_column(rng: np.random.Generator, n: int,
                   origins: Sequence[str],
                   weights: Sequence[float]) -> np.ndarray:
    w = np.asarray(weights, dtype=np.float64)
    return rng.choice(len(origins), size=n, p=w / w.sum()).astype(np.int32)


@register("multi_region",
          "three regional clusters (cheap economy chips in us) under the "
          "fleet plane: the placer consolidates batch onto the cheapest "
          "cluster while each region's interactive traffic serves locally",
          default_n=3000)
def multi_region(n_requests: int, seed: int = 0, *,
                 arrival_rate: float = 12.0,
                 interactive_frac: float = 0.7,
                 batch_ttft_slo: float = 900.0,
                 chips_per_cluster: int = 160) -> Tuple[Trace, SimKwargs]:
    regions = ("us", "eu", "ap")
    rng = np.random.default_rng(seed)
    times = np.cumsum(rng.exponential(1.0 / arrival_rate, n_requests))
    ins, outs = _token_lengths(rng, n_requests)
    cls = rng.random(n_requests) < interactive_frac
    oidx = _origin_column(rng, n_requests, regions, (0.4, 0.35, 0.25))
    trace = make_trace(times, ins, outs, cls, batch_ttft_slo=batch_ttft_slo,
                       origin_idx=oidx, origins=regions)

    def fleet():
        from repro_torch.sim.fleet import ClusterSpec, Fleet, FleetTopology
        specs = [
            ClusterSpec("us-central", "us", max_chips=chips_per_cluster,
                        accelerator="v4e"),     # cheapest $/token
            ClusterSpec("eu-west", "eu", max_chips=chips_per_cluster),
            ClusterSpec("ap-south", "ap", max_chips=chips_per_cluster),
        ]
        topo = FleetTopology(regions, latency={
            ("us", "eu"): 0.06, ("us", "ap"): 0.11, ("eu", "ap"): 0.09})
        return Fleet(specs, topo, models=("llama-8b",))

    return trace, {"max_time": trace.duration + 900.0, "fleet": fleet}


@register("regional_spillover",
          "a small regional cluster hit by an origin-local spike that "
          "exceeds its chip budget: the router must spill interactive "
          "work to the neighbouring region and hand it back afterwards",
          default_n=3000)
def regional_spillover(n_requests: int, seed: int = 0, *,
                       base_rate: float = 4.0, spike_rate: float = 240.0,
                       spike_frac: float = 0.5,
                       small_chips: int = 4,
                       big_chips: int = 240) -> Tuple[Trace, SimKwargs]:
    regions = ("us", "eu")
    rng = np.random.default_rng(seed)
    n_spike = int(n_requests * spike_frac)
    n_base = n_requests - n_spike
    base_t = np.cumsum(rng.exponential(1.0 / base_rate, n_base))
    ins_b, outs_b = _token_lengths(rng, n_base)
    base = make_trace(base_t, ins_b, outs_b, np.ones(n_base, dtype=bool),
                      origin_idx=_origin_column(rng, n_base, regions,
                                                (0.7, 0.3)),
                      origins=regions, sort=False)
    # the spike lands mid-trace, entirely us-origin, far above what the
    # small us cluster can absorb
    t0 = 0.4 * float(base_t[-1])
    spike_t = t0 + np.cumsum(rng.exponential(1.0 / spike_rate, n_spike))
    ins_s, outs_s = _token_lengths(rng, n_spike)
    spike = make_trace(spike_t, ins_s, outs_s, np.ones(n_spike, dtype=bool),
                       origin_idx=np.zeros(n_spike, dtype=np.int32),
                       origins=regions, sort=False)
    trace = Trace.concat([base, spike]).sorted_by_arrival()

    def fleet():
        from repro_torch.sim.fleet import ClusterSpec, Fleet, FleetTopology
        specs = [ClusterSpec("us-edge", "us", max_chips=small_chips),
                 ClusterSpec("eu-hub", "eu", max_chips=big_chips)]
        topo = FleetTopology(regions, latency={("us", "eu"): 0.07})
        return Fleet(specs, topo, models=("llama-8b",))

    return trace, {"max_time": trace.duration + 900.0, "fleet": fleet}


@register("heterogeneous_accelerators",
          "one region, three chip generations (premium/baseline/economy): "
          "cost-per-token routing should pack batch onto the economy part "
          "and keep interactive latency on the fast parts",
          default_n=3000)
def heterogeneous_accelerators(n_requests: int, seed: int = 0, *,
                               arrival_rate: float = 12.0,
                               interactive_frac: float = 0.55,
                               batch_ttft_slo: float = 900.0) \
        -> Tuple[Trace, SimKwargs]:
    regions = ("us",)
    rng = np.random.default_rng(seed)
    times = np.cumsum(rng.exponential(1.0 / arrival_rate, n_requests))
    ins, outs = _token_lengths(rng, n_requests)
    cls = rng.random(n_requests) < interactive_frac
    trace = make_trace(times, ins, outs, cls, batch_ttft_slo=batch_ttft_slo,
                       origin_idx=np.zeros(n_requests, dtype=np.int32),
                       origins=regions)

    def fleet():
        from repro_torch.sim.fleet import ClusterSpec, Fleet, FleetTopology
        specs = [
            ClusterSpec("us-premium", "us", max_chips=64,
                        accelerator="v5p"),
            ClusterSpec("us-baseline", "us", max_chips=128,
                        accelerator="v5e"),
            ClusterSpec("us-economy", "us", max_chips=192,
                        accelerator="v4e"),
        ]
        return Fleet(specs, FleetTopology(regions), models=("llama-8b",))

    return trace, {"max_time": trace.duration + 900.0, "fleet": fleet}


def _tenant_column(rng: np.random.Generator, n: int,
                   tenants: Sequence[str],
                   weights: Sequence[float]) -> np.ndarray:
    w = np.asarray(weights, dtype=np.float64)
    return rng.choice(len(tenants), size=n, p=w / w.sum()).astype(np.int32)


@register("zone_outage",
          "two-region fleet where every instance in one zone crashes at "
          "once mid-trace and its chip budget returns in staged tranches: "
          "the hierarchy must re-provision into the surviving zone and "
          "then back as capacity is restored",
          default_n=3000)
def zone_outage(n_requests: int, seed: int = 0, *,
                arrival_rate: float = 12.0,
                interactive_frac: float = 0.9,
                chips_per_cluster: int = 96,
                victim: Optional[str] = "us-east",
                outage_at_frac: float = 0.3,
                outage_duration: Optional[float] = None,
                recovery_stages: int = 2,
                stage_interval: float = 30.0,
                batch_ttft_slo: float = 900.0) -> Tuple[Trace, SimKwargs]:
    from repro_torch.sim.simulator import OutagePlan
    regions = ("us", "eu")
    tenants = ("acme", "globex")
    rng = np.random.default_rng(seed)
    times = np.cumsum(rng.exponential(1.0 / arrival_rate, n_requests))
    ins, outs = _token_lengths(rng, n_requests)
    cls = rng.random(n_requests) < interactive_frac
    oidx = _origin_column(rng, n_requests, regions, (0.55, 0.45))
    tidx = _tenant_column(rng, n_requests, tenants, (0.6, 0.4))
    trace = make_trace(times, ins, outs, cls, batch_ttft_slo=batch_ttft_slo,
                       origin_idx=oidx, origins=regions,
                       tenant_idx=tidx, tenants=tenants)
    span = trace.duration
    # the outage scales with the trace so short smoke runs still leave
    # post-restoration traffic to measure recovery against
    if outage_duration is None:
        outage_duration = 0.2 * span
    plan = OutagePlan(start=outage_at_frac * span,
                      duration=outage_duration, cluster=victim,
                      recovery_stages=recovery_stages,
                      stage_interval=stage_interval, seed=seed)

    def fleet():
        from repro_torch.sim.fleet import ClusterSpec, Fleet, FleetTopology
        specs = [ClusterSpec("us-east", "us", max_chips=chips_per_cluster),
                 ClusterSpec("eu-west", "eu", max_chips=chips_per_cluster)]
        topo = FleetTopology(regions, latency={("us", "eu"): 0.07})
        return Fleet(specs, topo, models=("llama-8b",))

    return trace, {"max_time": span + 900.0, "fleet": fleet,
                   "outages": plan}


@register("flash_crowd",
          "steady single-model stream plus a seeded ramp of a second "
          "model that goes zero-to-dominant in minutes: on-the-fly model "
          "discovery, placement warm-up, and recovery once the crowd "
          "passes",
          default_n=3000)
def flash_crowd(n_requests: int, seed: int = 0, *,
                arrival_rate: float = 10.0,
                interactive_frac: float = 0.9,
                crowd_model: str = "llama-70b",
                peak_rate: float = 8.0,
                ramp: Optional[float] = None,
                crowd_duration: Optional[float] = None,
                crowd_at_frac: float = 0.3,
                batch_ttft_slo: float = 900.0) -> Tuple[Trace, SimKwargs]:
    from repro_torch.sim.simulator import FlashCrowdPlan
    tenants = ("acme", "globex")
    rng = np.random.default_rng(seed)
    times = np.cumsum(rng.exponential(1.0 / arrival_rate, n_requests))
    ins, outs = _token_lengths(rng, n_requests)
    cls = rng.random(n_requests) < interactive_frac
    tidx = _tenant_column(rng, n_requests, tenants, (0.6, 0.4))
    base = make_trace(times, ins, outs, cls, batch_ttft_slo=batch_ttft_slo,
                      models=("llama-8b",),
                      tenant_idx=tidx, tenants=tenants, sort=False)
    span = base.duration
    # crowd window scales with the trace (same reasoning as zone_outage)
    if crowd_duration is None:
        crowd_duration = 0.3 * span
    if ramp is None:
        ramp = 0.25 * crowd_duration
    plan = FlashCrowdPlan(start=crowd_at_frac * span, ramp=ramp,
                          duration=crowd_duration, model=crowd_model,
                          peak_rate=peak_rate, seed=seed)
    # the crowd itself: seeded ramp arrivals of the second model, all
    # interactive, attributed to the crowd-heavy tenant
    crowd_t = plan.arrival_times()
    n_crowd = crowd_t.size
    ins_c, outs_c = _token_lengths(rng, n_crowd)
    crowd = make_trace(crowd_t, ins_c, outs_c,
                       np.ones(n_crowd, dtype=bool),
                       models=(crowd_model,),
                       tenant_idx=np.ones(n_crowd, dtype=np.int32),
                       tenants=tenants, sort=False)
    trace = Trace.concat([base, crowd]).sorted_by_arrival()
    return trace, {"max_time": trace.duration + 900.0,
                   "models": ("llama-8b", crowd_model),
                   "flash_crowds": plan}


def _heavy_tokens(rng: np.random.Generator, n: int,
                  prompt_med: float, output_med: float):
    """Near-constant heavy requests (tight lognormal): the overload
    scenarios need sustained saturation, not a lucky light-token lull."""
    ins = np.clip(rng.lognormal(np.log(prompt_med), 0.25, n),
                  64, 4 * MAX_TOKENS).astype(np.int64)
    outs = np.clip(rng.lognormal(np.log(output_med), 0.25, n),
                   16, MAX_TOKENS).astype(np.int64)
    return ins, outs


@register("retry_storm",
          "sustained interactive overload far past a capped cluster: "
          "SLO-aware admission rejects infeasible arrivals, rejected "
          "clients re-submit with jittered exponential backoff, and the "
          "deadline sweep sheds what still cannot make its window",
          default_n=1200)
def retry_storm(n_requests: int, seed: int = 0, *,
                arrival_rate: float = 80.0,
                ttft_slo: float = 3.0,
                prompt_med: float = 1500.0,
                output_med: float = 400.0,
                max_chips: int = 4,
                slack: float = 1.0,
                max_retries: int = 3,
                base_backoff: float = 2.0,
                retry_budget: float = 45.0,
                overload_enabled: bool = True) -> Tuple[Trace, SimKwargs]:
    from repro_torch.sim.overload import OverloadConfig
    rng = np.random.default_rng(seed)
    times = np.cumsum(rng.exponential(1.0 / arrival_rate, n_requests))
    ins, outs = _heavy_tokens(rng, n_requests, prompt_med, output_med)
    trace = make_trace(times, ins, outs,
                       np.ones(n_requests, dtype=bool), ttft_slo=ttft_slo)
    kw: SimKwargs = {"max_time": trace.duration + 600.0,
                     "max_chips": max_chips}
    if overload_enabled:
        kw["overload"] = OverloadConfig.full(
            slack=slack, max_retries=max_retries,
            base_backoff=base_backoff, budget=retry_budget)
    return trace, kw


@register("graceful_brownout",
          "mixed interactive+batch stream with a mid-trace overload "
          "wave: sustained-overload hysteresis engages brownout (batch "
          "deferred and preempted, hopeless interactive backlog shed), "
          "then exits cleanly once the wave passes",
          default_n=2000)
def graceful_brownout(n_requests: int, seed: int = 0, *,
                      base_rate: float = 10.0,
                      storm_rate: float = 70.0,
                      storm_frac: float = 0.4,
                      interactive_frac: float = 0.75,
                      ttft_slo: float = 4.0,
                      batch_ttft_slo: float = 1800.0,
                      prompt_med: float = 1200.0,
                      output_med: float = 350.0,
                      max_chips: int = 6,
                      slack: float = 1.0,
                      max_retries: int = 1,
                      base_backoff: float = 3.0,
                      retry_budget: float = 30.0,
                      overload_enabled: bool = True) -> Tuple[Trace, SimKwargs]:
    from repro_torch.sim.overload import OverloadConfig
    rng = np.random.default_rng(seed)
    n_storm = int(n_requests * storm_frac)
    n_base = n_requests - n_storm
    base_t = np.cumsum(rng.exponential(1.0 / base_rate, n_base))
    ins_b, outs_b = _heavy_tokens(rng, n_base, prompt_med, output_med)
    cls = rng.random(n_base) < interactive_frac
    base = make_trace(base_t, ins_b, outs_b, cls, ttft_slo=np.where(
        cls, ttft_slo, batch_ttft_slo), sort=False)
    # the wave lands mid-trace, all interactive, far past capacity —
    # long enough that the brownout hysteresis confirms it is sustained
    t0 = 0.35 * float(base_t[-1])
    storm_t = t0 + np.cumsum(rng.exponential(1.0 / storm_rate, n_storm))
    ins_s, outs_s = _heavy_tokens(rng, n_storm, prompt_med, output_med)
    storm = make_trace(storm_t, ins_s, outs_s,
                       np.ones(n_storm, dtype=bool), ttft_slo=ttft_slo,
                       sort=False)
    trace = Trace.concat([base, storm]).sorted_by_arrival()
    kw: SimKwargs = {"max_time": trace.duration + 900.0,
                     "max_chips": max_chips}
    if overload_enabled:
        kw["overload"] = OverloadConfig.full(
            slack=slack, max_retries=max_retries,
            base_backoff=base_backoff, budget=retry_budget)
    return trace, kw


@register("instance_failures",
          "steady interactive stream with injected instance crashes: the "
          "hierarchy must re-provision and re-queue displaced work",
          default_n=3000)
def instance_failures(n_requests: int, seed: int = 0, *,
                      arrival_rate: float = 12.0,
                      interactive_frac: float = 0.9,
                      n_failures: int = 4,
                      batch_ttft_slo: float = 900.0) -> Tuple[Trace, SimKwargs]:
    from repro_torch.sim.simulator import FailurePlan
    rng = np.random.default_rng(seed)
    times = np.cumsum(rng.exponential(1.0 / arrival_rate, n_requests))
    ins, outs = _token_lengths(rng, n_requests)
    cls = rng.random(n_requests) < interactive_frac
    trace = make_trace(times, ins, outs, cls, batch_ttft_slo=batch_ttft_slo)
    # crashes spread over the middle of the trace (jittered, seeded): the
    # fleet is warm when they land and has traffic left to recover for
    span = trace.duration
    crash_times = np.sort(span * (0.2 + 0.6 * rng.random(n_failures)))
    return trace, {"max_time": span + 900.0,
                   "failures": FailurePlan(crash_times.tolist(), seed=seed)}
