"""Cluster simulation: event-driven core + fixed-tick reference loop.

The event-driven core (``simulate_events``) drives the cluster off a
time-ordered event heap — request arrivals, instance-ready transitions,
per-instance completion estimates, control ticks, injected instance
failures, and timeline samples — so idle spans cost zero work and
million-request traces run in seconds. The identical ``repro_torch.core``
autoscaler code used by the real engine runs in the control loop — only
the data plane is simulated, as a fluid model whose
composition changes happen exactly at event times.

Both engines accept either a materialized ``List[Request]`` or a columnar
:class:`~repro_torch.sim.workload.Trace`. The event core walks a Trace through a
chunked cursor that materializes ``Request`` objects lazily in arrival
order, so a 1M-request replay never builds a million objects up front.

The hot path is columnar end to end: the cursor installs a
:class:`~repro_torch.sim.ledger.RequestLedger` (outcomes recorded by integer
row id alongside the ``Request`` view; metrics reduce over arrays), and
the control-tick catch-up runs through the cluster's vectorized
:class:`~repro_torch.sim.cluster.InstancePlane` — one array pass over every
instance's fluid state instead of O(instances) Python calls, with
identical arithmetic to the per-object path so scaling decisions are
bit-for-bit equivalent.

Failure injection: pass ``failures=FailurePlan(times, seed=...)`` and the
event core crashes a uniformly-drawn active instance at each time — the
instance is removed (chips freed, ``cluster.failures`` counted separately
from autoscaling actions), its in-flight requests lose their KV and
re-queue, and the control hierarchy heals the fleet on its next tick.
``degradations=DegradationPlan(...)`` is the partial-failure sibling: the
victim stays up but its ITL inflates by a factor for a while; the control
plane detects it through the health EWMA and routes around it.

Multi-cluster fleets: ``simulate_fleet`` drives a ``repro_torch.sim.fleet``
Fleet — several clusters, each with its own queue and Chiron hierarchy —
off one shared event heap, adding cross-region network-delay events for
routed arrivals and placement warm-up events for model migrations.

``simulate_fixed_tick`` is the original discrete-time loop (default tick
0.25 s), kept as the equivalence reference and quantization baseline.
``simulate`` keeps the historical signature and dispatches to either
engine (event-driven by default).
"""
from __future__ import annotations

import functools
import gc
import heapq
import itertools
import math
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Union

import numpy as np

from repro_torch.obs.recorder import (R_INJECTED as _R_INJECTED,
                                      R_OUTAGE as _R_OUTAGE)
from repro_torch.serving.global_queue import (GlobalQueue, ReferenceGlobalQueue,
                                              make_queue)
from repro_torch.serving.request import Request
from repro_torch.sim.cluster import InstanceState, InstanceType, SimCluster
from repro_torch.sim.controllers import BaseController
from repro_torch.sim.ledger import RequestLedger
from repro_torch.sim.metrics import RunResult, Shock, Timeline
from repro_torch.sim.overload import (BrownoutState, OverloadConfig, WaitGauge,
                                      is_overloaded)
from repro_torch.sim.perf_model import PerfModel
from repro_torch.sim.workload import Trace, TraceStream

# heap-event kinds; the tuple position makes READY sort before COMPLETION
# and COMPLETION before FAILURE at equal timestamps (an instance activates
# before its estimates fire; finishes land before the crash takes them).
# _NET (cross-region arrival) and _WARM (placement warm-up) are fleet-only.
# _OUTAGE/_RESTORE drive correlated zone failures with staged capacity
# return; _BURST marks a flash-crowd onset in the decision ledger.
# _RETRY is a client re-arrival of a rejected/shed request after its
# deterministic jittered backoff (payload: the Request itself).
(_READY, _COMPLETION, _FAIL, _DEGRADE, _RECOVER, _NET, _WARM,
 _OUTAGE, _RESTORE, _BURST, _RETRY) = range(11)

_INF = float("inf")

RequestSource = Union[Sequence[Request], Trace, TraceStream]


def _gc_paused(fn):
    """Run ``fn`` with the cyclic garbage collector paused (restored on
    exit). The event core's churn — event tuples, SimSeqs, per-request
    dicts — is entirely reference-counted; the only cycles are the
    handful of long-lived instance/cluster backrefs. Leaving the
    generational collector armed makes it sweep a multi-million-object
    heap thousands of times per 1M-request run for nothing (~8% of
    wall). No-op when the caller already disabled collection."""
    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        was_enabled = gc.isenabled()
        if was_enabled:
            gc.disable()
        try:
            return fn(*args, **kwargs)
        finally:
            if was_enabled:
                gc.enable()
    return wrapper


@dataclass
class FailurePlan:
    """Crash schedule for failure injection: at each time in ``times``,
    ``victims`` uniformly-drawn *active* instances crash (a correlated
    multi-victim burst when > 1). Victim draws come from
    ``default_rng(seed)`` over the id-sorted active list; exactly one
    draw is consumed per scheduled victim whether or not an eligible
    instance exists at event time (ineligible slots are counted in
    ``RunResult.skipped_injections`` instead of silently shifting every
    later draw), so a plan is fully deterministic for a given run."""
    times: Sequence[float]
    seed: int = 0
    victims: int = 1

    def sorted_times(self) -> List[float]:
        return sorted(float(t) for t in self.times)


@dataclass
class DegradationPlan:
    """Slow-node schedule: at each time in ``times`` one uniformly-drawn
    *healthy* active instance has its ITL inflated by ``factor`` for
    ``duration`` seconds (then it recovers). Unlike a crash the instance
    keeps its work — the failure mode is silent throughput loss, which the
    control plane must *detect* (health EWMA) rather than observe as a
    membership change. Victim draws are seeded like :class:`FailurePlan`."""
    times: Sequence[float]
    factor: float = 4.0
    duration: float = 300.0
    seed: int = 0

    def sorted_times(self) -> List[float]:
        return sorted(float(t) for t in self.times)


@dataclass
class OutagePlan:
    """Correlated zone outage: at ``start`` every live instance (or the
    seeded ``fraction`` of them) in the target cluster crashes *at once*
    and that share of the zone's chip budget is withheld; capacity
    returns in ``recovery_stages`` equal steps every ``stage_interval``
    seconds starting at ``start + duration``. Displaced requests lose
    their KV and requeue; the control hierarchy must re-provision into
    the staged budget as it comes back.

    ``cluster`` names the victim zone for :func:`simulate_fleet`
    (``Fleet.by_name``); the single-cluster engine ignores it (the only
    cluster *is* the zone). Partial outages (``fraction`` < 1) draw the
    victim subset with ``default_rng(seed)`` over the id-sorted live
    list — fully deterministic per run."""
    start: float
    duration: float = 300.0
    cluster: Optional[str] = None
    fraction: float = 1.0
    recovery_stages: int = 1
    stage_interval: float = 60.0
    seed: int = 0

    def end_time(self) -> float:
        """Time the last withheld capacity stage is restored."""
        stages = max(1, int(self.recovery_stages))
        return self.start + self.duration \
            + (stages - 1) * self.stage_interval


@dataclass
class FlashCrowdPlan:
    """Flash-crowd demand shock: ``model`` goes from zero to a dominant
    arrival share within minutes, exercising on-the-fly model discovery,
    placement warm-up, and (in fleet mode) the Router's spillover.

    The shock *arrivals* are a seeded trace merged into the run's input
    at build time (:func:`arrival_times` generates the ramp; the
    ``flash_crowd`` scenario wraps it) — arrivals must flow through the
    normal cursor/ledger plumbing to stay columnar. The plan passed to
    the engines marks the shock window on ``RunResult.shocks`` for the
    recovery metrics and fires a ``_BURST`` heap event at onset so the
    decision ledger carries the term that fired."""
    start: float
    ramp: float = 120.0         # seconds from zero to peak rate
    duration: float = 600.0     # total elevated-arrival window
    model: str = "llama-70b"
    peak_rate: float = 20.0     # arrivals/s at the top of the ramp
    seed: int = 0

    def end_time(self) -> float:
        return self.start + self.duration

    def arrival_times(self) -> np.ndarray:
        """Seeded arrival offsets for the shock (absolute times): the
        expected count for a linear zero-to-peak ramp followed by a
        plateau, placed by inverse-CDF sampling of that rate profile —
        deterministic for a given seed."""
        rng = np.random.default_rng(self.seed)
        span = max(float(self.duration), 1e-9)
        ramp = min(max(float(self.ramp), 1e-9), span)
        area = 0.5 * ramp + (span - ramp)    # rate units of peak_rate
        n = max(1, int(round(self.peak_rate * area)))
        u = np.sort(rng.random(n)) * area
        cut = 0.5 * ramp
        times = np.where(u < cut,
                         np.sqrt(np.maximum(2.0 * u * ramp, 0.0)),
                         ramp + (u - cut))
        return self.start + times


def _as_plans(value, klass) -> List:
    """Normalize an engine chaos-plan kwarg: None, a single plan, or a
    sequence of plans -> list."""
    if value is None:
        return []
    if isinstance(value, klass):
        return [value]
    return list(value)


class _RequestCursor:
    """Arrival-ordered request source over a list, a columnar Trace, or a
    chunked :class:`TraceStream` — and the owner of the run's
    :class:`RequestLedger`.

    Trace mode materializes ``Request`` objects in chunks as the arrival
    loop consumes them — peeking the next arrival time reads the float
    column directly, so unarrived requests cost no Python objects. Stream
    mode pulls the next file chunk only when the previous one is consumed,
    so a multi-day replay never holds the whole file columnar. In every
    mode the ledger rows line up with arrival order and each materialized
    ``Request`` carries its row id.
    """

    def __init__(self, source: RequestSource, chunk: int = 16384):
        self._chunk = chunk
        self._trace = None
        self._stream = None
        if isinstance(source, Trace):
            self._trace = source.sorted_by_arrival()
            self._times = self._trace.arrival
            # plain-float shadow of the arrival column: the per-event
            # peek (`times[j] <= limit`, and the returned next-arrival)
            # costs a C-double compare instead of a NumPy scalar
            # box/unbox round-trip on every single arrival
            self._times_l = self._times.tolist()
            self.n = self._trace.n
            self.all: List[Request] = []
            self.ledger = RequestLedger.from_trace(self._trace)
        elif isinstance(source, TraceStream):
            self._stream = source
            self.n = 0                   # grows as chunks are pulled
            self.all = []
            self.ledger = RequestLedger(0)
        else:
            self.all = sorted(source, key=lambda r: r.arrival_time)
            self.n = len(self.all)
            self.ledger = RequestLedger.from_requests(self.all)
        self._i = 0

    def _pull_chunk(self) -> bool:
        """Stream mode: materialize the next chunk; False at EOF."""
        try:
            tr = next(self._stream)
        except StopIteration:
            self._stream = None
            return False
        base = self.ledger.extend_from_trace(tr)
        self.all.extend(tr.materialize(row0=base))
        self.n += tr.n
        return True

    @property
    def exhausted(self) -> bool:
        if self._i >= self.n and self._stream is not None:
            self._pull_chunk()
        return self._i >= self.n

    def peek_time(self) -> float:
        if self.exhausted:
            return _INF
        if self._trace is not None:
            return self._times_l[self._i]
        return self.all[self._i].arrival_time

    def pop(self) -> Request:
        if self._trace is not None and self._i >= len(self.all):
            lo = len(self.all)
            self.all.extend(self._trace.materialize(lo, lo + self._chunk,
                                                    row0=lo))
        req = self.all[self._i]
        self._i += 1
        return req

    def pop_next(self):
        """Fused ``(pop(), peek_time())`` — one call on the arrival hot
        path instead of two."""
        i = self._i
        all_ = self.all
        if self._trace is not None:
            if i >= len(all_):
                self.all.extend(self._trace.materialize(
                    i, i + self._chunk, row0=i))
                all_ = self.all
            req = all_[i]
            i += 1
            self._i = i
            return req, (self._times_l[i] if i < self.n else _INF)
        req = all_[i]
        self._i = i + 1
        return req, self.peek_time()

    def pop_until(self, limit: float):
        """``(cohort, next_time)``: every request with
        ``arrival_time <= limit`` — the exact set the per-arrival loop
        would pop — as one cohort, plus the arrival time of the first
        request *past* the cohort (``inf`` at EOF), fused so the hot loop
        pays one call. Trace mode checks the next arrival scalar first
        (cohorts of one dominate sparse traces) and only falls back to a
        ``searchsorted`` over the arrival column for true bursts, then
        materializes the whole cohort in one slice (the NumPy-batched
        arrival path); list/stream modes fall back to the scalar walk."""
        i = self._i
        if self._trace is not None:
            times = self._times_l
            n = self.n
            j = i + 1
            if j < n and times[j] <= limit:
                j = int(self._times.searchsorted(limit, side="right"))
            all_ = self.all
            if j > len(all_):
                lo = len(all_)
                all_.extend(self._trace.materialize(
                    lo, max(j, lo + self._chunk), row0=lo))
            self._i = j
            return all_[i:j], (times[j] if j < n else _INF)
        out = []
        while not self.exhausted and self.all[self._i].arrival_time <= limit:
            out.append(self.all[self._i])
            self._i += 1
        return out, self.peek_time()

    def all_requests(self) -> List[Request]:
        """Every request (materializing any unserved tail) for RunResult."""
        if self._trace is not None and len(self.all) < self.n:
            lo = len(self.all)
            self.all.extend(self._trace.materialize(lo, self.n, row0=lo))
        while self._stream is not None:
            self._pull_chunk()
        return self.all


def _warm_start(controller, cluster: SimCluster, t: float, n: int) -> None:
    """Pre-provision ``n`` instances, instantly active (shared by engines);
    multi-model controllers get them round-robin across their fleet."""
    models = getattr(controller, "model_list", None)
    for k in range(n):
        model = models[k % len(models)] if models else \
            getattr(controller, "model", "llama-8b")
        inst = controller._provision(cluster, InstanceType.MIXED, t, model) \
            if hasattr(controller, "_provision") else \
            cluster.provision(model, InstanceType.MIXED, t,
                              static_batch=getattr(controller, "static_batch",
                                                   64))
        if inst is not None:
            inst.ready_time = t
            inst.activate_if_ready(t)


@_gc_paused
def simulate_events(requests: RequestSource, controller: BaseController,
                    cluster: SimCluster, *, control_interval: float = 1.0,
                    max_time: float = 7200.0, warm_start: int = 0,
                    timeline_every: float = 1.0,
                    completion_grain: float = 0.25,
                    quantize: float = 0.0,
                    failures: Optional[FailurePlan] = None,
                    degradations: Optional[DegradationPlan] = None,
                    outages=None,
                    flash_crowds=None,
                    detector=None,
                    reference: bool = False,
                    shadow_verify=None,
                    telemetry=None,
                    overload: Optional[OverloadConfig] = None,
                    phase_timers=None) -> RunResult:
    """Event-driven simulation. ``quantize > 0`` snaps every event time up
    to that grid, making the run a *sparse fixed-tick*: it touches only
    non-empty ticks yet batches arrivals/completions exactly like a
    ``simulate_fixed_tick`` run at ``dt=quantize`` — the mode the
    engine-equivalence comparison uses.

    ``reference=True`` runs the pre-columnar-refactor control flow — no
    arrival fast path, no saturation memo, per-object (never vectorized)
    control-tick catch-up — as the equivalence baseline the columnar hot
    path is tested against. Results must be identical either way.

    ``shadow_verify`` enables the runtime mirror auditor: pass a
    :class:`repro_torch.analysis.shadow.ShadowVerifier` (or any truthy value,
    or set ``CHIRON_SHADOW_VERIFY=1``) to rebuild the ledger/plane
    columns from the objects at control ticks and completion sweeps and
    assert exact agreement. Raises ``ShadowVerifyError`` on desync.

    ``telemetry`` arms the flight recorder (``repro_torch.obs``): pass a
    :class:`repro_torch.obs.FlightRecorder` (or any truthy value, or set
    ``CHIRON_TELEMETRY=1``) to record control-plane signal/tick columns,
    the decision ledger, and sampled request-lifecycle spans. The
    recorder rides on the result as ``RunResult.telemetry``; decisions
    are bit-identical either way.

    ``overload`` arms the overload control plane
    (:class:`repro_torch.sim.overload.OverloadConfig`): SLO-aware admission,
    deadline shedding, deterministic client retries, and brownout mode.
    ``None`` (or an all-``None`` config) is bit-identical to the
    pre-overload engine; requires the columnar path (``reference=False``).

    ``phase_timers`` (the repo's ``scripts/profile_sim.py --phases``) is an injected
    accumulator with ``clock()``/``lap(name, t0)`` — the loop brackets
    its six numbered phases with it; ``None`` (the default) costs one
    predicted branch per phase."""
    from repro_torch.analysis.shadow import resolve as _shadow_resolve
    from repro_torch.obs.recorder import resolve as _obs_resolve
    shadow = _shadow_resolve(shadow_verify)
    rec = _obs_resolve(telemetry)
    ov = overload if overload is not None and overload.active else None
    if ov is not None and reference:
        raise ValueError("overload control requires the columnar engine "
                         "(reference=True is the pre-overload baseline)")
    queue = make_queue(reference)
    cursor = _RequestCursor(requests)
    t = 0.0
    cluster.event_mode = True
    cluster.now = 0.0
    cluster.completion_grain = completion_grain
    cluster.quantize = quantize
    cluster.ledger = cursor.ledger
    if detector is not None:
        cluster.detector = detector
    if rec is not None:
        # attach before the warm start so bootstrap provisions land in
        # the decision ledger too (replay() then matches scale_ups)
        rec.register_cluster(cluster, "cluster")
        cluster.obs = rec
        controller.obs = rec

    _warm_start(controller, cluster, t, warm_start)
    # instances provisioned before this call (still LOADING) also need
    # READY events — fold them into the new-loading drain
    cluster.new_loading = [i for i in cluster.instances
                           if i.state == InstanceState.LOADING]

    heap: list = []                  # (time, kind, seq, instance, epoch)
    ev_seq = itertools.count()
    timeline = Timeline()
    next_control = 0.0
    control_parked = False
    next_timeline = 0.0
    last_sample_t = 0.0
    n_events = 0
    batch_seq = 0                    # event-batch stamp (ETA-cache key)
    eps = 1e-12
    # One-slot completion staging: the single-dirty sweep (one admit or
    # one completion per event, the steady-state shape) parks its fresh
    # estimate here instead of heap-pushing it. When the *same* instance
    # sweeps again before the estimate fires, the epoch bump that
    # schedules the replacement has already made the staged tuple stale —
    # it is overwritten in place, saving both the push and the later
    # stale pop. A staged event otherwise behaves exactly like the heap
    # head: it joins the t_next min, disarms the arrival fast path at its
    # timestamp, and is heap-pushed (firing in exact tuple order) the
    # moment it comes due or a different instance sweeps.
    pend = None
    use_pend = quantize == 0         # sparse fixed-tick keeps plain pushes

    # hot-path locals (attribute lookups hoisted out of the loop)
    observe_arrival = getattr(controller, "observe_arrival", None)
    observe_completion = controller.observe_completion
    route_interactive = getattr(controller, "route_interactive", None)
    route_arrival = getattr(controller, "route_arrival", None) \
        if quantize == 0 and not reference else None
    route_burst = getattr(controller, "route_arrival_burst", None) \
        if route_arrival is not None else None
    use_memo = not reference
    if reference:
        cluster.vec_min = 1 << 30        # scalar catch-up only

    # ---- overload control plane (all off when ov is None) ----
    ov_adm = ov.admission if ov is not None else None
    ov_shed = ov.shedding if ov is not None else None
    ov_retry = ov.retry if ov is not None else None
    ov_brown = ov.brownout if ov is not None else None
    gauge = None
    brownout = None
    pending_retry = 0                # scheduled _RETRY events outstanding
    led = cursor.ledger
    if ov is not None:
        gauge = WaitGauge(controller, cluster)
        if not gauge.supported:
            # admission/brownout need the controller's QLM estimators;
            # shedding and retries still work without them
            ov_adm = None
            ov_brown = None
        if ov_brown is not None:
            brownout = BrownoutState()
    if ov_adm is not None:
        # the admission gate must see every arrival before placement —
        # disable the zero-queuing arrival fast path (routing still
        # drains the queue on the same event)
        route_arrival = None
        route_burst = None

    queue_push = queue.push
    heappush = heapq.heappush
    heappop = heapq.heappop
    heapify = heapq.heapify
    pop_until = cursor.pop_until
    ACTIVE = InstanceState.ACTIVE
    cdirty = cluster.dirty               # stable set object, never rebound
    timers = phase_timers
    timing = timers is not None
    # steady-state arrival micro-loop eligibility (see loop tail): only
    # the plain event mode qualifies — shadow audits, phase timing, and
    # sparse fixed-tick all need the full per-phase scan
    # (the flight recorder does not disqualify: its hooks live on the
    # state mutations — admit/evict/provision — which the micro-loop
    # reaches through the same routing calls as the full scan)
    inner_on = (route_burst is not None and route_interactive is not None
                and shadow is None and not timing and quantize == 0
                and ov is None)

    fail_rng = None
    if failures is not None:
        fail_rng = np.random.default_rng(failures.seed)
        for tf in failures.sorted_times():
            heappush(heap, (tf, _FAIL, next(ev_seq), None, 0))
    deg_rng = None
    if degradations is not None:
        deg_rng = np.random.default_rng(degradations.seed)
        for td in degradations.sorted_times():
            heappush(heap, (td, _DEGRADE, next(ev_seq), None, 0))
    skipped_injections = 0
    shocks: List[Shock] = []
    for plan in _as_plans(outages, OutagePlan):
        heappush(heap, (float(plan.start), _OUTAGE, next(ev_seq), plan, 0))
        shocks.append(Shock("outage", float(plan.start), plan.end_time(),
                            plan.cluster or ""))
    for plan in _as_plans(flash_crowds, FlashCrowdPlan):
        heappush(heap, (float(plan.start), _BURST, next(ev_seq), plan, 0))
        shocks.append(Shock("flash_crowd", float(plan.start),
                            plan.end_time(), plan.model))

    def _sample(now: float) -> None:
        nonlocal last_sample_t, next_timeline
        rate = cluster.take_tokens() / max(now - last_sample_t, 1e-9)
        n_i, n_m, n_b = cluster.counts_by_type()
        timeline.append_sample(
            now, n_i, n_m, n_b, cluster.used_chips(),
            queue.n_interactive, queue.n_batch, rate,
            q_interactive_by_model={m: queue.n_interactive_for(m)
                                    for m in queue.interactive_models()},
            q_batch_by_model={m: queue.n_batch_for(m)
                              for m in queue.batch_models()})
        last_sample_t = now
        next_timeline = now + timeline_every

    def _maybe_retry(req: Request, now: float) -> None:
        """Schedule the client's next attempt for a rejected/shed request
        (jittered exponential backoff, abandoned past the retry budget).
        The object/ledger row stays terminal until the attempt lands."""
        nonlocal pending_retry
        if ov_retry is None:
            return
        attempt = req.retries + 1
        if attempt > ov_retry.max_retries:
            return
        key = req.row if req.row >= 0 else req.req_id
        when = now + ov_retry.backoff(key, attempt)
        if when > req.arrival_time + ov_retry.budget:
            return
        led.bump_retry(req)
        pending_retry += 1
        heappush(heap, (when, _RETRY, next(ev_seq), req, 0))

    def _admit(req: Request, now: float) -> bool:
        """Admission gate (arrivals and retry re-arrivals): queue the
        request, or refuse it as REJECTED when its estimated wait at max
        budget already blows the TTFT SLO — no autoscaling decision could
        save it (QLM-style infeasibility)."""
        if req.is_interactive:
            budget_w = ov_adm.slack * req.slo.ttft
            wait = gauge.wait(queue, req.model)
            if wait > budget_w:
                led.mark_rejected(req)
                if rec is not None:
                    rec.record_reject(cluster, now, req.model, wait,
                                      budget_w)
                _maybe_retry(req, now)
                return False
        queue_push(req)
        return True

    def _overload_tick(now: float) -> None:
        """Control-tick overload pass: brownout hysteresis first (an
        entering tick sheds proactively below), then the vectorized
        deadline sweep over the interactive lanes. Batch lanes are never
        touched — batch work defers, it does not drop."""
        if brownout is not None:
            flip = brownout.update(
                is_overloaded(cluster, queue, gauge, ov_brown), ov_brown)
            if flip is not None:
                controller.brownout_active = flip
                if rec is not None:
                    rec.record_brownout(cluster, now, flip,
                                        queue.n_interactive,
                                        ov_brown.queue_min)
                if flip:
                    controller.brownout_preempt_batch(cluster, queue, now)
        if ov_shed is not None and queue._icount:
            wbm = None
            if brownout is not None and brownout.engaged \
                    and gauge is not None and gauge.supported:
                # brownout sheds proactively: entries that cannot reach
                # service before their deadline at the estimated
                # per-request drain rate are dropped now, not at expiry
                wbm = {m: gauge.per_request_wait(m)
                       for m in queue.interactive_models()}
            expired, shed = queue.sweep_interactive(
                now, grace=ov_shed.grace, wait_by_model=wbm)
            for req in expired:
                led.mark_expired(req)
            for req in shed:
                led.mark_shed(req)
                _maybe_retry(req, now)
            if rec is not None:
                for reqs, hook in ((expired, rec.record_expire),
                                   (shed, rec.record_shed)):
                    counts: Dict[str, int] = {}
                    for req in reqs:
                        counts[req.model] = counts.get(req.model, 0) + 1
                    for m in sorted(counts):
                        hook(cluster, now, m, counts[m])

    t_arr = cursor.peek_time()

    predrain = quantize == 0

    while True:
        # ---- termination: all requests arrived, none queued or running,
        # and no client retry is still in backoff
        if t_arr == _INF and cluster.total_running == 0 \
                and len(queue) == 0 and pending_retry == 0:
            break

        # ---- stale completion estimates (superseded by a newer epoch, or
        # on a retired instance) that land strictly before every other
        # event source would each burn a full loop iteration doing
        # provably nothing: no state change, no routing work (queue
        # empty), no control tick, no timeline sample. Drain them in one
        # tight pass, replicating the per-event chip-second accumulation
        # exactly (it is NOT float-associative across segments), so
        # results stay bit-identical to the one-iteration-per-pop flow.
        if predrain and heap and not (queue._icount or queue._bcount):
            pt = pend[0] if pend is not None else _INF
            while heap:
                ev = heap[0]
                th = ev[0]
                if th >= t_arr - eps or th >= next_control - eps \
                        or th >= next_timeline - eps or th >= pt - eps \
                        or th > max_time or ev[1] != _COMPLETION:
                    break
                inst = ev[3]
                if ev[4] == inst._epoch \
                        and inst.state == InstanceState.ACTIVE:
                    break                    # live estimate — a real event
                heappop(heap)
                n_events += 1
                if th > cluster.now:         # inline advance_time
                    cluster.chip_seconds += \
                        cluster._used_chips * (th - cluster.now)
                    cluster.now = th

        # ---- next event time across all sources
        t_next = t_arr
        if heap and heap[0][0] < t_next:
            t_next = heap[0][0]
        if pend is not None and pend[0] < t_next:
            t_next = pend[0]
        if next_control < t_next:
            t_next = next_control
        if not control_parked and next_timeline < t_next:
            t_next = next_timeline
        if quantize > 0:                 # sparse fixed-tick alignment
            t_next = math.ceil(t_next / quantize - 1e-9) * quantize
        if t_next > max_time or t_next == _INF:
            cluster.advance_time(max_time)   # idle chip-time to the horizon
            t = max_time
            break
        t = t_next
        if t > cluster.now:                  # inline advance_time
            cluster.chip_seconds += cluster._used_chips * (t - cluster.now)
            cluster.now = t
        batch_seq += 1
        cluster.batch_seq = batch_seq
        changed = False

        if timing:
            _t0 = timers.clock()

        # 1. arrivals due at t, popped as one cohort (Trace mode finds
        #    the extent with one searchsorted and materializes one
        #    slice). When nothing else shares the timestamp (no heap
        #    event, no control tick — so steps 2-4 would change nothing
        #    before routing) interactive arrivals into empty lanes take
        #    the zero-queuing fast path: the whole burst routes through
        #    one ``route_arrival_burst`` call, placed directly and
        #    skipping the queue round-trip the full pass would undo.
        if t_arr <= t + eps:
            fast = route_arrival is not None \
                and not (heap and heap[0][0] <= t + eps) \
                and not (pend is not None and pend[0] <= t + eps) \
                and next_control > t + eps
            cohort, t_arr = cursor.pop_until(t + eps)
            n_events += len(cohort)
            changed = True
            if fast and route_burst is not None:
                route_burst(cluster, queue, cohort, t, observe_arrival)
            elif ov_adm is not None:
                for req in cohort:
                    if observe_arrival is not None:
                        observe_arrival(req, t)
                    _admit(req, t)
            else:
                for req in cohort:
                    if observe_arrival is not None:
                        observe_arrival(req, t)
                    if not (fast and queue._icount == 0
                            and route_arrival(cluster, queue, req, t)):
                        queue_push(req)

        if timing:
            _t0 = timers.lap("arrivals", _t0)

        # 2. instance events due at t (ready transitions, completion
        #    estimates, injected crashes; stale estimates are skipped via
        #    the epoch stamp). Instances that gained capacity are
        #    backfilled directly below.
        freed = ()                       # lazily a list once events fire
        if pend is not None and pend[0] <= t + eps:
            # repro-lint: ok(DET204, staged 5-tuple built inline)
            heappush(heap, pend)         # due: fire in exact tuple order
            pend = None
        if heap and heap[0][0] <= t + eps:
            freed = []
        while heap and heap[0][0] <= t + eps:
            _, kind, _, inst, epoch = heappop(heap)
            n_events += 1
            if kind == _READY:
                if inst.state == InstanceState.LOADING:
                    # the event was scheduled at ready_time exactly; t may
                    # sit an epsilon below it (accumulated control-clock
                    # float error) and the event must not be lost
                    inst.activate_if_ready(max(t, inst.ready_time))
                    inst.mark_dirty()
                    freed.append(inst)
                    changed = True
            elif kind == _FAIL:
                # crash ``victims`` uniformly-drawn active instances
                # (id-ordered registry + seeded rng -> deterministic
                # victims per run). Exactly one draw per victim slot,
                # eligible or not: an empty fleet skips the slot and
                # counts it instead of shifting every later draw.
                for _ in range(max(1, failures.victims)):
                    draw = int(fail_rng.integers(1 << 30))
                    active = cluster.active_sorted()
                    if not active:
                        skipped_injections += 1
                        continue
                    victim = active[draw % len(active)]
                    if victim in freed:
                        freed.remove(victim)
                    displaced = cluster.fail_instance(victim)
                    # fluid state settled at the crash instant: finishes
                    # that beat the crash still count, the rest requeue
                    for r in victim.drain_finished():
                        observe_completion(r)
                    for r in displaced:
                        queue.requeue(r)
                    cluster.dirty.discard(victim)
                    changed = True
            elif kind == _DEGRADE:
                # slow a uniformly-drawn healthy active instance (one
                # draw per event whether or not a candidate exists — see
                # _FAIL); recovery is scheduled as its own event
                draw = int(deg_rng.integers(1 << 30))
                cands = [i for i in cluster.active_sorted()
                         if i.slow_factor == 1.0]
                if cands:
                    victim = cands[draw % len(cands)]
                    cluster.degrade_instance(victim, degradations.factor, t)
                    heappush(heap, (t + degradations.duration,
                                    _RECOVER, next(ev_seq), victim, 0))
                    changed = True
                else:
                    skipped_injections += 1
            elif kind == _RECOVER:
                if inst.state != InstanceState.RETIRED \
                        and inst.slow_factor != 1.0:
                    cluster.recover_instance(inst, t)
                    changed = True
            elif kind == _OUTAGE:
                # correlated zone outage: every live instance (or the
                # seeded fraction) crashes at once and the zone's chip
                # budget is withheld; staged _RESTORE events return it
                plan = inst                     # payload: the OutagePlan
                victims = sorted(cluster.instances, key=lambda i: i.id)
                if plan.fraction < 1.0 and victims:
                    k = min(len(victims), max(1, math.ceil(
                        plan.fraction * len(victims))))
                    sel = np.random.default_rng(plan.seed).permutation(
                        len(victims))[:k]
                    sel.sort()
                    victims = [victims[int(i)] for i in sel]
                if not victims:
                    skipped_injections += 1
                withhold = int(round(min(plan.fraction, 1.0)
                                     * cluster.max_chips))
                if rec is not None:
                    rec.record_outage(cluster, t, len(victims), withhold)
                    rec.inj_reason = _R_OUTAGE
                for victim in victims:
                    if victim in freed:
                        freed.remove(victim)
                    displaced = cluster.fail_instance(victim)
                    for r in victim.drain_finished():
                        observe_completion(r)
                    for r in displaced:
                        queue.requeue(r)
                    cluster.dirty.discard(victim)
                if rec is not None:
                    rec.inj_reason = _R_INJECTED
                stages = max(1, int(plan.recovery_stages))
                base_amt, rem = divmod(withhold, stages)
                for k2 in range(stages):
                    amt = base_amt + (1 if k2 < rem else 0)
                    heappush(heap, (plan.start + plan.duration
                                    + k2 * plan.stage_interval,
                                    _RESTORE, next(ev_seq), amt, 0))
                cluster.max_chips -= withhold
                cluster.route_version += 1
                changed = True
            elif kind == _RESTORE:
                # one staged tranche of withheld outage capacity returns
                cluster.max_chips += inst       # payload: chip count
                cluster.route_version += 1
                if rec is not None:
                    rec.record_restore(cluster, t, inst)
                changed = True
            elif kind == _BURST:
                # flash-crowd onset: the shock arrivals ride the trace;
                # this marks the term that fired in the decision ledger
                if rec is not None:
                    rec.record_flash_crowd(cluster, t, inst.model)
                changed = True
            elif kind == _RETRY:
                # client retry re-arrival (payload: the Request): the
                # attempt re-enters the lifecycle with a fresh per-attempt
                # deadline, counts as observed demand (retry storms
                # inflate the forecast — that is the point), and faces
                # the admission gate again
                req = inst
                pending_retry -= 1
                if observe_arrival is not None:
                    observe_arrival(req, t)
                req.deadline_at = t + req.slo.ttft
                led.mark_queued(req)
                if ov_adm is not None:
                    _admit(req, t)
                else:
                    queue_push(req)
                changed = True
            elif epoch == inst._epoch and inst.state == InstanceState.ACTIVE:
                inst.advance(t)
                freed.append(inst)
                changed = True

        if timing:
            _t0 = timers.lap("heap_drain", _t0)

        # a parked control loop resumes as soon as anything happens
        if control_parked and changed:
            next_control = t
            control_parked = False

        # 3. control tick: align every instance's fluid state with ``t``
        #    (vectorized instance-plane pass above the scalar cut-over),
        #    then run the identical production control path
        ran_control = t >= next_control - eps
        if ran_control:
            n_events += 1
            cluster.catch_up(t, batch_seq)
            if shadow is not None:
                shadow.verify_cluster(cluster)
                shadow.verify_queue(queue)
                shadow.maybe_verify_ledger(cursor.ledger, cursor.all, t)
            if ov is not None:
                _overload_tick(t)
            pre = (len(cluster.instances), cluster.scale_ups,
                   cluster.scale_downs)
            controller.control(cluster, queue, t)
            # schedule ready events for instances the controller provisioned
            for inst in cluster.drain_new_loading():
                heappush(heap, (inst.ready_time, _READY,
                                next(ev_seq), inst, 0))
            post = (len(cluster.instances), cluster.scale_ups,
                    cluster.scale_downs)
            if rec is not None:
                rec.record_cluster_tick(t, cluster, queue)
            quiescent = (pre == post and len(queue) == 0
                         and cluster.total_running == 0
                         and cluster.n_loading == 0)
            if quiescent:
                # deterministic controller + unchanged inputs -> nothing can
                # change before the next arrival; park the control loop
                next_control = t_arr
                control_parked = True
            else:
                next_control = t + control_interval

        if timing:
            _t0 = timers.lap("control", _t0)

        # 4. routing: the full preferential pass runs at control ticks; in
        #    between, interactive dispatch stays zero-queuing on every event
        #    and only just-freed instances are backfilled from the batch
        #    queue — the hot path never rescans the whole cluster
        if ran_control or route_interactive is None:
            controller.route(cluster, queue, t)
        else:
            if queue._icount:
                route_interactive(cluster, queue, t, use_memo)
            if freed and queue._bcount:
                if len(freed) > 1:
                    # preserve pool preference: batch instances first
                    freed.sort(key=lambda i:
                               i.itype != InstanceType.BATCH)
                controller.backfill(freed, queue, t)

        if timing:
            _t0 = timers.lap("routing", _t0)

        # 5. sweep instances touched this batch: surface completions to
        #    the controller, then one vectorized ETA recompute over the
        #    plane columns (``sweep_etas``: cached catch-up ETAs reused,
        #    the rest batch-recomputed) feeds a single bulk heap refill.
        #    Epochs still advance per instance, so stale estimates cancel
        #    exactly as the per-instance re-push did.
        if cdirty:
            if len(cdirty) == 1:
                # single-dirty fast path (the common shape: one admit or
                # one completion per event) — same operations as the
                # general branch below, minus the list plumbing
                inst = cdirty.pop()
                pf = inst._pending_finished
                if pf:
                    inst._pending_finished = []
                    for r in pf:
                        observe_completion(r)
                if inst.state == InstanceState.ACTIVE:
                    if inst._eta_stamp != batch_seq:
                        inst._eta_val = inst.next_event_in()
                        inst._eta_stamp = batch_seq
                    eta = inst._eta_val
                    if eta != _INF:
                        inst._epoch += 1
                        ev = (t + eta, _COMPLETION,
                              next(ev_seq), inst, inst._epoch)
                        if use_pend:
                            if pend is not None and pend[3] is not inst:
                                # repro-lint: ok(DET204, staged 5-tuple)
                                heappush(heap, pend)
                            # a same-instance staged tuple was superseded
                            # by the epoch bump above — dropped here
                            # instead of lingering as a stale heap pop
                            pend = ev
                        else:
                            # repro-lint: ok(DET204, ev built inline above)
                            heappush(heap, ev)
            else:
                dirty = cluster.drain_dirty()
                if pend is not None:
                    # repro-lint: ok(DET204, staged 5-tuple)
                    heappush(heap, pend)
                    pend = None
                for inst in dirty:
                    pf = inst._pending_finished
                    if pf:
                        inst._pending_finished = []
                        for r in pf:
                            observe_completion(r)
                refill = cluster.sweep_etas(dirty, batch_seq)
                if refill:
                    # bulk refill: extend+heapify beats k sifts once the
                    # batch is a decent fraction of the heap; pop order
                    # is identical either way (event seqs total-order)
                    if 8 * len(refill) < len(heap):
                        for inst, eta in refill:
                            inst._epoch += 1
                            heappush(heap, (t + eta, _COMPLETION,
                                            next(ev_seq), inst,
                                            inst._epoch))
                    else:
                        for inst, eta in refill:
                            inst._epoch += 1
                            heap.append((t + eta, _COMPLETION,
                                         next(ev_seq), inst, inst._epoch))
                        heapify(heap)
            if shadow is not None:
                shadow.verify_cluster(cluster)

        if timing:
            _t0 = timers.lap("sweep", _t0)

        # 6. timeline sample (suppressed while parked — state is frozen)
        if t >= next_timeline - eps:
            _sample(t)

        if timing:
            timers.lap("sampling", _t0)

        # ---- steady-state arrival micro-loop: while the next cohort
        # lands strictly before every other event source (no heap event
        # or staged completion due, no control tick, no timeline sample),
        # phases 2/3/6 above are provably no-ops and phase 4 reduces to
        # the zero-queuing retry — so the full scan degenerates to
        # arrival → route → sweep. Run exactly those, with the phase
        # bodies replicated verbatim (same float and tie-break order, so
        # results are bit-identical); the win is the per-event fixed
        # overhead of the outer loop, paid once per burst instead of
        # once per arrival.
        if inner_on:
            while (next_control > t_arr + eps
                   and next_timeline > t_arr + eps
                   and t_arr <= max_time
                   and not (heap and heap[0][0] <= t_arr + eps)
                   and not (pend is not None and pend[0] <= t_arr + eps)):
                t = t_arr
                if t > cluster.now:          # inline advance_time
                    cluster.chip_seconds += \
                        cluster._used_chips * (t - cluster.now)
                    cluster.now = t
                batch_seq += 1
                cluster.batch_seq = batch_seq
                cohort, t_arr = pop_until(t + eps)
                n_events += len(cohort)
                route_burst(cluster, queue, cohort, t, observe_arrival)
                if queue._icount:            # zero-queuing retry (phase 4)
                    route_interactive(cluster, queue, t, use_memo)
                if not cdirty:
                    continue
                if len(cdirty) == 1:
                    inst = cdirty.pop()
                    pf = inst._pending_finished
                    if pf:
                        inst._pending_finished = []
                        for r in pf:
                            observe_completion(r)
                    if inst.state == ACTIVE:
                        if inst._eta_stamp != batch_seq:
                            inst._eta_val = inst.next_event_in()
                            inst._eta_stamp = batch_seq
                        eta = inst._eta_val
                        if eta != _INF:
                            inst._epoch += 1
                            ev = (t + eta, _COMPLETION,
                                  next(ev_seq), inst, inst._epoch)
                            if pend is not None and pend[3] is not inst:
                                # repro-lint: ok(DET204, staged 5-tuple)
                                heappush(heap, pend)
                            pend = ev
                else:
                    dirty = cluster.drain_dirty()
                    if pend is not None:
                        # repro-lint: ok(DET204, staged 5-tuple)
                        heappush(heap, pend)
                        pend = None
                    for inst in dirty:
                        pf = inst._pending_finished
                        if pf:
                            inst._pending_finished = []
                            for r in pf:
                                observe_completion(r)
                    refill = cluster.sweep_etas(dirty, batch_seq)
                    if refill:
                        if 8 * len(refill) < len(heap):
                            for inst, eta in refill:
                                inst._epoch += 1
                                heappush(heap, (t + eta, _COMPLETION,
                                                next(ev_seq), inst,
                                                inst._epoch))
                        else:
                            for inst, eta in refill:
                                inst._epoch += 1
                                heap.append((t + eta, _COMPLETION,
                                             next(ev_seq), inst,
                                             inst._epoch))
                            heapify(heap)

    if timeline and t > timeline[-1].t:
        _sample(t)
    if shadow is not None:
        shadow.verify_cluster(cluster)
        shadow.verify_queue(queue)
        shadow.verify_ledger(cursor.ledger, cursor.all)
    if rec is not None:
        cluster.obs = None
        controller.obs = None
    return RunResult(requests=cursor.all_requests(), timeline=timeline,
                     chip_seconds=cluster.chip_seconds,
                     peak_chips=cluster.peak_chips,
                     scale_ups=cluster.scale_ups,
                     scale_downs=cluster.scale_downs,
                     duration=t, failures=cluster.failures,
                     n_events=n_events,
                     degradations=cluster.degradations,
                     skipped_injections=skipped_injections,
                     shocks=shocks,
                     ledger=cursor.ledger, telemetry=rec)


def simulate_fixed_tick(requests: RequestSource, controller: BaseController,
                        cluster: SimCluster, *, dt: float = 0.25,
                        control_interval: float = 1.0,
                        max_time: float = 7200.0, warm_start: int = 0,
                        timeline_every: float = 1.0) -> RunResult:
    """The original discrete-time loop (reference/quantization baseline).
    A Trace input is materialized up front — the reference loop walks
    every tick anyway, so laziness buys nothing here."""
    queue = GlobalQueue()
    if isinstance(requests, Trace):
        requests = requests.sorted_by_arrival().materialize()
    pending = sorted(requests, key=lambda r: r.arrival_time)
    pi = 0
    t = 0.0
    next_control = 0.0
    next_timeline = 0.0
    timeline = Timeline()

    _warm_start(controller, cluster, t, warm_start)

    while t < max_time:
        # 1. arrivals
        while pi < len(pending) and pending[pi].arrival_time <= t:
            queue.push(pending[pi])
            if hasattr(controller, "observe_arrival"):
                controller.observe_arrival(pending[pi], t)
            pi += 1

        # 2. instance state transitions
        for inst in cluster.instances:
            inst.activate_if_ready(t)

        # 3. control (scaling) then routing
        if t >= next_control:
            controller.control(cluster, queue, t)
            next_control = t + control_interval
        controller.route(cluster, queue, t)

        # 4. data-plane step
        tok_this_tick = 0
        for inst in cluster.active_instances():
            finished, toks = inst.step(dt, t)
            tok_this_tick += toks
            for r in finished:
                controller.observe_completion(r)

        cluster.tick_accounting(dt)

        # 5. timeline sample
        if t >= next_timeline:
            n_i, n_m, n_b = cluster.counts_by_type()
            timeline.append_sample(
                t, n_i, n_m, n_b, cluster.used_chips(),
                queue.n_interactive, queue.n_batch,
                tok_this_tick / dt)
            next_timeline = t + timeline_every

        t += dt

        # 6. termination: all requests arrived and none outstanding
        if pi >= len(pending) and len(queue) == 0 and \
                all(not i.running for i in cluster.instances):
            break

    return RunResult(requests=pending, timeline=timeline,
                     chip_seconds=cluster.chip_seconds,
                     peak_chips=cluster.peak_chips,
                     scale_ups=cluster.scale_ups,
                     scale_downs=cluster.scale_downs,
                     duration=t, failures=cluster.failures)


def simulate(requests: RequestSource, controller: BaseController,
             cluster: SimCluster, *, dt: float = 0.25,
             control_interval: float = 1.0, max_time: float = 7200.0,
             warm_start: int = 0, timeline_every: float = 1.0,
             engine: str = "event",
             failures: Optional[FailurePlan] = None,
             degradations: Optional[DegradationPlan] = None,
             outages=None,
             flash_crowds=None,
             telemetry=None,
             overload: Optional[OverloadConfig] = None) -> RunResult:
    """Compatibility wrapper: dispatch to the event-driven core (default)
    or the fixed-tick reference (``engine="fixed"``, where ``dt`` applies;
    failure/degradation/outage injection, flight-recorder telemetry, and
    the overload control plane need the event core).
    """
    if engine == "event":
        return simulate_events(requests, controller, cluster,
                               control_interval=control_interval,
                               max_time=max_time, warm_start=warm_start,
                               timeline_every=timeline_every,
                               failures=failures, degradations=degradations,
                               outages=outages, flash_crowds=flash_crowds,
                               telemetry=telemetry, overload=overload)
    if engine == "fixed":
        if failures is not None or degradations is not None \
                or outages is not None or flash_crowds is not None:
            raise ValueError("failure injection requires engine='event'")
        if telemetry:
            raise ValueError("telemetry requires engine='event'")
        if overload is not None and overload.active:
            raise ValueError("overload control requires engine='event'")
        return simulate_fixed_tick(requests, controller, cluster, dt=dt,
                                   control_interval=control_interval,
                                   max_time=max_time, warm_start=warm_start,
                                   timeline_every=timeline_every)
    raise ValueError(f"unknown engine {engine!r} (want 'event' or 'fixed')")


@_gc_paused
def simulate_fleet(requests: RequestSource, fleet, *,
                   control_interval: float = 1.0, max_time: float = 7200.0,
                   warm_start: int = 0, timeline_every: float = 5.0,
                   completion_grain: float = 0.25,
                   failures: Optional[FailurePlan] = None,
                   degradations: Optional[DegradationPlan] = None,
                   outages=None,
                   flash_crowds=None,
                   detector=None,
                   reference: bool = False,
                   shadow_verify=None,
                   telemetry=None,
                   overload: Optional[OverloadConfig] = None,
                   phase_timers=None) -> RunResult:
    """Multi-cluster event loop: one shared heap drives every cluster in a
    :class:`repro_torch.sim.fleet.Fleet`, each with its own queue and Chiron
    hierarchy (the paper's two tiers), under the fleet's Router/GlobalPlacer
    (the third tier).

    Beyond the single-cluster event kinds, the heap carries cross-region
    network-delay events (a routed arrival reaches a remote cluster's
    queue only after the origin->region latency — TTFT accounting then
    includes the hop for free) and placement warm-up events (a migrated
    model serves only after its weights transferred and loaded).
    ``warm_start`` pre-provisions that many instances *per cluster* over
    the models initially resident there. Failure/degradation victims are
    drawn uniformly over the whole fleet's active instances.

    Reported ``peak_chips`` is the sum of per-cluster peaks (budgets are
    disjoint, so coincident peaks are what capacity planning needs).

    ``shadow_verify`` mirrors :func:`simulate_events`: a truthy value (or
    ``CHIRON_SHADOW_VERIFY=1``) audits every cluster's plane and the
    shared ledger at control ticks and completion sweeps.

    ``telemetry`` mirrors :func:`simulate_events` too: one shared
    :class:`repro_torch.obs.FlightRecorder` spans the fleet — clusters are
    registered under their fleet names, and tier-3 placement actions
    (migrations, hand-backs, drains) land in the decision ledger
    alongside every cluster's own Chiron actions.

    ``overload`` arms the per-cluster overload plane (admission at each
    destination queue, deadline sweeps, client retries re-routed through
    the Router, per-cluster brownout) — and, when the fleet's Router
    carries a :class:`repro_torch.sim.overload.BreakerConfig`, feeds each
    cluster's admission outcomes into its circuit breaker so routing
    deflects around clusters whose rejection-rate EWMA tripped."""
    from repro_torch.analysis.shadow import resolve as _shadow_resolve
    from repro_torch.obs.recorder import resolve as _obs_resolve
    shadow = _shadow_resolve(shadow_verify)
    rec = _obs_resolve(telemetry)
    ov = overload if overload is not None and overload.active else None
    if ov is not None and reference:
        raise ValueError("overload control requires the columnar engine "
                         "(reference=True is the pre-overload baseline)")
    cursor = _RequestCursor(requests)
    clusters = list(fleet.clusters)
    by_sim = {id(fc.cluster): fc for fc in clusters}
    t = 0.0
    use_memo = not reference

    # ---- overload control plane (all off when ov is None) ----
    ov_adm = ov.admission if ov is not None else None
    ov_shed = ov.shedding if ov is not None else None
    ov_retry = ov.retry if ov is not None else None
    ov_brown = ov.brownout if ov is not None else None
    pending_retry = 0
    led = cursor.ledger
    gauges: Dict[int, WaitGauge] = {}
    brownouts: Dict[int, BrownoutState] = {}
    if ov is not None:
        for fc in clusters:
            g = WaitGauge(fc.controller, fc.cluster)
            if g.supported:
                gauges[id(fc)] = g
        if not gauges:
            ov_adm = None
            ov_brown = None
        if ov_brown is not None:
            for fc in clusters:
                if id(fc) in gauges:
                    brownouts[id(fc)] = BrownoutState()
    if rec is not None:
        fleet.obs = rec
    for fc in clusters:
        fc.cluster.event_mode = True
        fc.cluster.now = 0.0
        fc.cluster.completion_grain = completion_grain
        fc.cluster.ledger = cursor.ledger
        if detector is not None:
            fc.cluster.detector = detector
        if reference:
            fc.cluster.vec_min = 1 << 30
            fc.queue = ReferenceGlobalQueue()   # object-queue baseline
        if rec is not None:
            rec.register_cluster(fc.cluster, fc.name)
            fc.cluster.obs = rec
            fc.controller.obs = rec
        _warm_start(fc.controller, fc.cluster, t, warm_start)
        fc.cluster.new_loading = [i for i in fc.cluster.instances
                                  if i.state == InstanceState.LOADING]

    heap: list = []                  # (time, kind, seq, payload, epoch)
    ev_seq = itertools.count()
    timeline = Timeline()
    next_control = 0.0
    next_place = fleet.placer.interval
    control_parked = False
    next_timeline = 0.0
    last_sample_t = 0.0
    n_events = 0
    batch_seq = 0
    pending_net = 0                  # in-flight cross-region arrivals
    eps = 1e-12
    heappush = heapq.heappush
    heappop = heapq.heappop
    heapify = heapq.heapify
    timers = phase_timers
    timing = timers is not None

    fail_rng = None
    if failures is not None:
        fail_rng = np.random.default_rng(failures.seed)
        for tf in failures.sorted_times():
            heappush(heap, (tf, _FAIL, next(ev_seq), None, 0))
    deg_rng = None
    if degradations is not None:
        deg_rng = np.random.default_rng(degradations.seed)
        for td in degradations.sorted_times():
            heappush(heap, (td, _DEGRADE, next(ev_seq), None, 0))
    skipped_injections = 0
    shocks: List[Shock] = []
    for plan in _as_plans(outages, OutagePlan):
        if plan.cluster is not None and plan.cluster not in fleet.by_name:
            raise ValueError(f"OutagePlan: unknown cluster {plan.cluster!r}")
        heappush(heap, (float(plan.start), _OUTAGE, next(ev_seq), plan, 0))
        shocks.append(Shock("outage", float(plan.start), plan.end_time(),
                            plan.cluster or clusters[0].name))
    for plan in _as_plans(flash_crowds, FlashCrowdPlan):
        heappush(heap, (float(plan.start), _BURST, next(ev_seq), plan, 0))
        shocks.append(Shock("flash_crowd", float(plan.start),
                            plan.end_time(), plan.model))

    def emit_warm(delay: float, payload) -> None:
        heappush(heap, (t + max(delay, 0.0), _WARM,
                        next(ev_seq), payload, 0))

    def _maybe_retry(req: Request, now: float) -> None:
        """Schedule the client's next attempt (fleet flavour: the retry
        re-routes through the Router, so an open breaker deflects it)."""
        nonlocal pending_retry
        if ov_retry is None:
            return
        attempt = req.retries + 1
        if attempt > ov_retry.max_retries:
            return
        key = req.row if req.row >= 0 else req.req_id
        when = now + ov_retry.backoff(key, attempt)
        if when > req.arrival_time + ov_retry.budget:
            return
        led.bump_retry(req)
        pending_retry += 1
        heappush(heap, (when, _RETRY, next(ev_seq), req, 0))

    def _enqueue(fc, req: Request, now: float) -> None:
        if ov_adm is not None and req.is_interactive:
            g = gauges.get(id(fc))
            if g is not None:
                budget_w = ov_adm.slack * req.slo.ttft
                wait = g.wait(fc.queue, req.model)
                rejected = wait > budget_w
                trans = fleet.router.note_admission(fc, rejected, now)
                if trans is not None and rec is not None:
                    rec.record_breaker(now, fc.name, trans[0], trans[1],
                                      fleet.router.breaker.open_threshold)
                if rejected:
                    led.mark_rejected(req)
                    if rec is not None:
                        rec.record_reject(fc.cluster, now, req.model,
                                          wait, budget_w)
                    _maybe_retry(req, now)
                    return
        fc.queue.push(req)
        fc.controller.observe_arrival(req, now)

    def _dispatch(req: Request, now: float) -> None:
        nonlocal pending_net
        fc, delay = fleet.route(req, now)
        if delay > eps:
            heappush(heap, (now + delay, _NET, next(ev_seq),
                            (req, fc), 0))
            pending_net += 1
        else:
            _enqueue(fc, req, now)

    def _overload_tick_fc(fc, now: float) -> None:
        """Per-cluster control-tick overload pass (brownout hysteresis,
        then the vectorized interactive deadline sweep)."""
        g = gauges.get(id(fc))
        bstate = brownouts.get(id(fc))
        if bstate is not None and g is not None:
            flip = bstate.update(
                is_overloaded(fc.cluster, fc.queue, g, ov_brown), ov_brown)
            if flip is not None:
                fc.controller.brownout_active = flip
                if rec is not None:
                    rec.record_brownout(fc.cluster, now, flip,
                                        fc.queue.n_interactive,
                                        ov_brown.queue_min)
                if flip:
                    fc.controller.brownout_preempt_batch(fc.cluster,
                                                         fc.queue, now)
        if ov_shed is not None and fc.queue._icount:
            wbm = None
            if bstate is not None and bstate.engaged and g is not None:
                wbm = {m: g.per_request_wait(m)
                       for m in fc.queue.interactive_models()}
            expired, shed = fc.queue.sweep_interactive(
                now, grace=ov_shed.grace, wait_by_model=wbm)
            for req in expired:
                led.mark_expired(req)
            for req in shed:
                led.mark_shed(req)
                _maybe_retry(req, now)
            if rec is not None:
                for reqs, hook in ((expired, rec.record_expire),
                                   (shed, rec.record_shed)):
                    counts: Dict[str, int] = {}
                    for req in reqs:
                        counts[req.model] = counts.get(req.model, 0) + 1
                    for m in sorted(counts):
                        hook(fc.cluster, now, m, counts[m])

    def _all_active():
        # merged per-cluster active registries, id-ordered (deterministic
        # victim draws without scanning every instance per event)
        out = []
        for fc in clusters:
            out.extend(fc.cluster._active.values())
        out.sort(key=lambda i: i.id)
        return out

    def _sample(now: float) -> None:
        nonlocal last_sample_t, next_timeline
        toks = n_i = n_m = n_b = chips = q_i = q_b = 0
        qi_m: Dict[str, int] = {}
        qb_m: Dict[str, int] = {}
        for fc in clusters:
            toks += fc.cluster.take_tokens()
            i, m, b = fc.cluster.counts_by_type()
            n_i += i
            n_m += m
            n_b += b
            chips += fc.cluster.used_chips()
            q = fc.queue
            q_i += q.n_interactive
            q_b += q.n_batch
            for mdl in q.interactive_models():
                qi_m[mdl] = qi_m.get(mdl, 0) + q.n_interactive_for(mdl)
            for mdl in q.batch_models():
                qb_m[mdl] = qb_m.get(mdl, 0) + q.n_batch_for(mdl)
        rate = toks / max(now - last_sample_t, 1e-9)
        timeline.append_sample(now, n_i, n_m, n_b, chips, q_i, q_b, rate,
                               q_interactive_by_model=qi_m,
                               q_batch_by_model=qb_m)
        last_sample_t = now
        next_timeline = now + timeline_every

    t_arr = cursor.peek_time()

    while True:
        # ---- termination: everything arrived, landed, and finished,
        # and no client retry is still in backoff
        if t_arr == _INF and pending_net == 0 and pending_retry == 0 and \
                all(len(fc.queue) == 0 and fc.cluster.total_running == 0
                    for fc in clusters):
            break

        # ---- stale completion estimates landing strictly before every
        # other event source: drain without a loop iteration (see the
        # single-cluster loop for the full argument; chip-time advances
        # per event so accumulation stays bit-identical)
        if heap and not any(fc.queue._icount or fc.queue._bcount
                            for fc in clusters):
            while heap:
                ev = heap[0]
                th = ev[0]
                if th >= t_arr - eps or th >= next_control - eps \
                        or th >= next_place - eps \
                        or th >= next_timeline - eps or th > max_time \
                        or ev[1] != _COMPLETION:
                    break
                inst = ev[3]
                if ev[4] == inst._epoch \
                        and inst.state == InstanceState.ACTIVE:
                    break                    # live estimate — a real event
                heappop(heap)
                n_events += 1
                for fc in clusters:
                    fc.cluster.advance_time(th)

        # ---- next event time across all sources
        t_next = t_arr
        if heap and heap[0][0] < t_next:
            t_next = heap[0][0]
        if next_control < t_next:
            t_next = next_control
        if not control_parked:
            if next_place < t_next:
                t_next = next_place
            if next_timeline < t_next:
                t_next = next_timeline
        if t_next > max_time or t_next == _INF:
            for fc in clusters:
                fc.cluster.advance_time(max_time)
            t = max_time
            break
        t = t_next
        batch_seq += 1
        for fc in clusters:
            fc.cluster.advance_time(t)
            fc.cluster.batch_seq = batch_seq
        changed = False
        freed: Dict[int, List] = {}      # id(fc) -> instances w/ capacity

        if timing:
            _t0 = timers.clock()

        # 1. arrivals due at t, popped as one cohort (one searchsorted +
        #    one materialize slice): forecast observation, then route —
        #    local arrivals enqueue now, cross-region after the hop
        if t_arr <= t + eps:
            cohort, t_arr = cursor.pop_until(t + eps)
            n_events += len(cohort)
            changed = True
            for req in cohort:
                fleet.observe_arrival(req, t)
                _dispatch(req, t)

        if timing:
            _t0 = timers.lap("arrivals", _t0)

        # 2. heap events due at t
        while heap and heap[0][0] <= t + eps:
            _, kind, _, payload, epoch = heappop(heap)
            n_events += 1
            if kind == _NET:
                req, fc = payload
                pending_net -= 1
                _enqueue(fc, req, t)
                changed = True
            elif kind == _WARM:
                fleet.on_warm(payload, t)
                changed = True
            elif kind == _READY:
                inst = payload
                if inst.state == InstanceState.LOADING:
                    # scheduled at ready_time exactly; t may sit an epsilon
                    # below it (see simulate_events) — never lose the event
                    inst.activate_if_ready(max(t, inst.ready_time))
                    inst.mark_dirty()
                    freed.setdefault(id(by_sim[id(inst._cluster)]),
                                     []).append(inst)
                    changed = True
            elif kind == _FAIL:
                # one draw per victim slot, eligible or not (see the
                # single-cluster loop) — seeded victim sequences never
                # shift when the fleet happens to be empty
                for _ in range(max(1, failures.victims)):
                    draw = int(fail_rng.integers(1 << 30))
                    active = _all_active()
                    if not active:
                        skipped_injections += 1
                        continue
                    victim = active[draw % len(active)]
                    fc = by_sim[id(victim._cluster)]
                    flist = freed.get(id(fc))
                    if flist and victim in flist:
                        flist.remove(victim)
                    displaced = fc.cluster.fail_instance(victim)
                    for r in victim.drain_finished():
                        fc.controller.observe_completion(r)
                        fleet.observe_completion(r, fc, t)
                    for r in displaced:
                        fc.queue.requeue(r)
                    fc.cluster.dirty.discard(victim)
                    changed = True
            elif kind == _DEGRADE:
                draw = int(deg_rng.integers(1 << 30))
                cands = [i for i in _all_active() if i.slow_factor == 1.0]
                if cands:
                    victim = cands[draw % len(cands)]
                    victim._cluster.degrade_instance(
                        victim, degradations.factor, t)
                    heappush(heap, (t + degradations.duration,
                                    _RECOVER, next(ev_seq), victim, 0))
                    changed = True
                else:
                    skipped_injections += 1
            elif kind == _RECOVER:
                inst = payload
                if inst.state != InstanceState.RETIRED \
                        and inst.slow_factor != 1.0:
                    inst._cluster.recover_instance(inst, t)
                    changed = True
            elif kind == _OUTAGE:
                # correlated zone outage against one named fleet cluster
                plan = payload
                fc = fleet.by_name[plan.cluster] \
                    if plan.cluster is not None else clusters[0]
                victims = sorted(fc.cluster.instances, key=lambda i: i.id)
                if plan.fraction < 1.0 and victims:
                    k = min(len(victims), max(1, math.ceil(
                        plan.fraction * len(victims))))
                    sel = np.random.default_rng(plan.seed).permutation(
                        len(victims))[:k]
                    sel.sort()
                    victims = [victims[int(i)] for i in sel]
                if not victims:
                    skipped_injections += 1
                withhold = int(round(min(plan.fraction, 1.0)
                                     * fc.cluster.max_chips))
                if rec is not None:
                    rec.record_outage(fc.cluster, t, len(victims),
                                      withhold)
                    rec.inj_reason = _R_OUTAGE
                flist = freed.get(id(fc))
                for victim in victims:
                    if flist and victim in flist:
                        flist.remove(victim)
                    displaced = fc.cluster.fail_instance(victim)
                    for r in victim.drain_finished():
                        fc.controller.observe_completion(r)
                        fleet.observe_completion(r, fc, t)
                    for r in displaced:
                        fc.queue.requeue(r)
                    fc.cluster.dirty.discard(victim)
                if rec is not None:
                    rec.inj_reason = _R_INJECTED
                stages = max(1, int(plan.recovery_stages))
                base_amt, rem = divmod(withhold, stages)
                for k2 in range(stages):
                    amt = base_amt + (1 if k2 < rem else 0)
                    heappush(heap, (plan.start + plan.duration
                                    + k2 * plan.stage_interval,
                                    _RESTORE, next(ev_seq), (fc, amt), 0))
                fc.cluster.max_chips -= withhold
                fc.cluster.route_version += 1
                changed = True
            elif kind == _RESTORE:
                fc, amt = payload
                fc.cluster.max_chips += amt
                fc.cluster.route_version += 1
                if rec is not None:
                    rec.record_restore(fc.cluster, t, amt)
                changed = True
            elif kind == _BURST:
                if rec is not None:
                    rec.record_flash_crowd(clusters[0].cluster, t,
                                           payload.model)
                changed = True
            elif kind == _RETRY:
                # client retry re-arrival: fresh per-attempt deadline,
                # observed as demand, re-routed through the Router (an
                # open breaker deflects it to a healthy cluster at the
                # price of the network hop)
                req = payload
                pending_retry -= 1
                fleet.observe_arrival(req, t)
                req.deadline_at = t + req.slo.ttft
                led.mark_queued(req)
                _dispatch(req, t)
                changed = True
            else:                        # completion estimate
                inst = payload
                if epoch == inst._epoch \
                        and inst.state == InstanceState.ACTIVE:
                    inst.advance(t)
                    freed.setdefault(id(by_sim[id(inst._cluster)]),
                                     []).append(inst)
                    changed = True

        if timing:
            _t0 = timers.lap("heap_drain", _t0)

        # a parked control loop resumes as soon as anything happens
        if control_parked and changed:
            next_control = t
            control_parked = False

        # 3. control tick: every cluster runs its own Chiron hierarchy on
        #    its own queue against its own chip budget
        ran_control = t >= next_control - eps
        if ran_control:
            n_events += 1
            pre = post = 0
            for fc in clusters:
                fc.cluster.catch_up(t, batch_seq)
                if shadow is not None:
                    shadow.verify_cluster(fc.cluster)
                    shadow.verify_queue(fc.queue)
                if ov is not None:
                    _overload_tick_fc(fc, t)
                pre += len(fc.cluster.instances) + fc.cluster.scale_ups \
                    + fc.cluster.scale_downs
                fc.controller.control(fc.cluster, fc.queue, t)
                for inst in fc.cluster.drain_new_loading():
                    heappush(heap, (inst.ready_time, _READY,
                                    next(ev_seq), inst, 0))
                post += len(fc.cluster.instances) + fc.cluster.scale_ups \
                    + fc.cluster.scale_downs
                if rec is not None:
                    rec.record_cluster_tick(t, fc.cluster, fc.queue)
            quiescent = (pre == post and pending_net == 0
                         and all(len(fc.queue) == 0
                                 and fc.cluster.total_running == 0
                                 and fc.cluster.n_loading == 0
                                 for fc in clusters))
            if quiescent:
                # nothing can change before the next arrival (warm-up
                # events still fire off the heap); park the control and
                # placer clocks
                next_control = t_arr
                control_parked = True
            else:
                next_control = t + control_interval

        if timing:
            _t0 = timers.lap("control", _t0)

        # 4. placement review (tier 3): forecast-driven residency changes,
        #    batch-target selection, saturation hand-back
        if not control_parked and t >= next_place - eps:
            n_events += 1
            for req, fc, delay in fleet.review(t, emit_warm):
                if delay > eps:
                    heappush(heap, (t + delay, _NET, next(ev_seq),
                                    (req, fc), 0))
                    pending_net += 1
                else:
                    _enqueue(fc, req, t)
                changed = True
            next_place = t + fleet.placer.interval

        # 5. routing per cluster (full pass at control ticks, incremental
        #    zero-queuing + freed-instance backfill in between)
        for fc in clusters:
            if ran_control:
                fc.controller.route(fc.cluster, fc.queue, t)
            else:
                fc.controller.route_interactive(fc.cluster, fc.queue, t,
                                                use_memo)
                flist = freed.get(id(fc))
                if flist and fc.queue.n_batch:
                    if len(flist) > 1:
                        flist.sort(key=lambda i:
                                   i.itype != InstanceType.BATCH)
                    fc.controller.backfill(flist, fc.queue, t)

        if timing:
            _t0 = timers.lap("routing", _t0)

        # 6. sweep dirty instances: completions surface to the owning
        #    cluster's controller and the fleet rollup, then each
        #    cluster's vectorized ``sweep_etas`` pass bulk-refills the
        #    shared heap (epochs still advance per instance)
        for fc in clusters:
            if not fc.cluster.dirty:
                continue
            dirty = fc.cluster.drain_dirty()
            for inst in dirty:
                pf = inst._pending_finished
                if pf:
                    inst._pending_finished = []
                    for r in pf:
                        fc.controller.observe_completion(r)
                        fleet.observe_completion(r, fc, t)
            refill = fc.cluster.sweep_etas(dirty, batch_seq)
            if refill:
                if 8 * len(refill) < len(heap):
                    for inst, eta in refill:
                        inst._epoch += 1
                        heappush(heap, (t + eta, _COMPLETION,
                                        next(ev_seq), inst,
                                        inst._epoch))
                else:
                    for inst, eta in refill:
                        inst._epoch += 1
                        heap.append((t + eta, _COMPLETION,
                                     next(ev_seq), inst, inst._epoch))
                    heapify(heap)
            if shadow is not None:
                shadow.verify_cluster(fc.cluster)
        if shadow is not None and ran_control:
            shadow.maybe_verify_ledger(cursor.ledger, cursor.all, t)

        if timing:
            _t0 = timers.lap("sweep", _t0)

        # 7. timeline sample (suppressed while parked — state is frozen)
        if not control_parked and t >= next_timeline - eps:
            _sample(t)

        if timing:
            timers.lap("sampling", _t0)

    if timeline and t > timeline[-1].t:
        _sample(t)
    if shadow is not None:
        for fc in clusters:
            shadow.verify_cluster(fc.cluster)
            shadow.verify_queue(fc.queue)
        shadow.verify_ledger(cursor.ledger, cursor.all)
    if rec is not None:
        fleet.obs = None
        for fc in clusters:
            fc.cluster.obs = None
            fc.controller.obs = None
    stats = fleet.finalize()
    return RunResult(
        requests=cursor.all_requests(), timeline=timeline,
        chip_seconds=sum(fc.cluster.chip_seconds for fc in clusters),
        peak_chips=sum(fc.cluster.peak_chips for fc in clusters),
        scale_ups=sum(fc.cluster.scale_ups for fc in clusters),
        scale_downs=sum(fc.cluster.scale_downs for fc in clusters),
        duration=t,
        failures=sum(fc.cluster.failures for fc in clusters),
        degradations=sum(fc.cluster.degradations for fc in clusters),
        skipped_injections=skipped_injections, shocks=shocks,
        n_events=n_events, clusters=stats,
        migrations=fleet.migrations, handbacks=fleet.handbacks,
        egress_bytes=fleet.egress_bytes,
        egress_cost_usd=fleet.egress_cost_usd,
        ledger=cursor.ledger, telemetry=rec)


def default_perf_factory(**perf_kw) -> Callable[[str], PerfModel]:
    cache = {}

    def factory(model: str) -> PerfModel:
        if model not in cache:
            cache[model] = PerfModel(model, **perf_kw)
        return cache[model]
    return factory
