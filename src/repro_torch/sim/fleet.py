"""Multi-cluster placement & routing plane: the third tier above Chiron.

The paper's hierarchy stops at one cluster with one shared chip budget.
This module scales it out the way a cloud provider runs it (SageServe,
arXiv:2502.14617): a *fleet* of regional clusters — each wrapping its own
:class:`~repro_torch.sim.cluster.SimCluster`, its own
:class:`~repro_torch.serving.global_queue.GlobalQueue`, and its own full Chiron
hierarchy (per-model IBP + Algorithm-2 loops on a per-cluster chip
budget) — coordinated by two fleet-level components:

- :class:`Router` — assigns every arriving request to a cluster by SLO
  headroom: interactive requests go to the lowest-latency cluster (from
  the request's origin region) that still has capacity, spilling over to
  farther clusters on saturation; batch requests go to the cheapest
  backpressure-positive cluster ($ per generated token, so heterogeneous
  accelerators rank correctly), falling back to the least-backlogged one.
- :class:`GlobalPlacer` — decides *which models are resident in which
  clusters* from windowed EWMA arrival-rate forecasts per (model, origin
  region), re-estimates per-model Theta with the existing
  ``theta_from_history`` machinery and pushes it down to every cluster
  controller, consolidates each model's batch work onto the cheapest
  capable cluster, migrates residency with explicit warm-up delay events
  (weights transfer over WAN + load), drains placements whose demand
  evaporated, and hands queued batch work back for re-routing when a
  cluster saturates.

Accelerator heterogeneity rides on :class:`~repro_torch.sim.perf_model.PerfModel`
variants (``ACCELERATORS``): each cluster's perf factory applies its chip
generation's FLOPs/HBM scales, so ITL, KV capacity, and cost-per-token
all shift coherently.

The event loop that drives a Fleet is
:func:`repro_torch.sim.simulator.simulate_fleet`; scenario builders in
``repro_torch.sim.scenarios`` (``multi_region``, ``regional_spillover``,
``heterogeneous_accelerators``) construct ready-made fleets.

The port's copy of the reference's ``sim/fleet.py``, whole: the same
router, placer and fleet, the same ``ACCELERATORS`` rows (see there for
what each row means on the port's H100 baseline).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.serving.global_queue import GlobalQueue
from repro_torch.serving.request import BATCH_ITL_SLO, Request
from repro_torch.sim.cluster import InstanceType, SimCluster
from repro_torch.sim.controllers import ChironController
from repro_torch.sim.metrics import ClusterStats
from repro_torch.sim.overload import BreakerConfig, CircuitBreaker
from repro_torch.sim.simulator import default_perf_factory
from repro_torch.sim.workload import DEFAULT_MODEL, theta_from_history

# accelerator catalogue, the reference's rows as they are: perf scales are
# applied to the baseline constants in perf_model; $/chip-hour tracks the
# list-price ordering (premium part fastest and dearest, previous-gen part
# slow but cheap — the natural batch home). In the port that baseline is
# the H100's (perf_model's data-sheet and fitted constants), so:
# - "v5e" (no scales) is this card's own constants under the reference's key;
# - "v5p" and "v4e" are TPU-generation ratios applied to an H100: they
#   describe no real part;
# - every cost_per_chip_hour is a TPU list price, no card's price.
# The rows stay so that a fleet run compares with the reference's seed for
# seed; a card's chip-hours are the port's measure, not these dollars.
ACCELERATORS: Dict[str, Dict] = {
    "v5e": dict(cost_per_chip_hour=1.20, perf_kw={}),
    "v5p": dict(cost_per_chip_hour=2.60,
                perf_kw=dict(flops_scale=2.33, hbm_bw_scale=3.35,
                             hbm_bytes_scale=5.94)),
    "v4e": dict(cost_per_chip_hour=0.55,
                perf_kw=dict(flops_scale=0.60, hbm_bw_scale=0.75,
                             hbm_bytes_scale=1.0)),
}

TOKEN_BYTES = 4          # request/response payload bytes per token (egress)


@dataclass(frozen=True)
class Region:
    """A geographic serving region — the latency and egress domain
    requests originate from and clusters live in."""
    name: str


@dataclass
class ClusterSpec:
    """Static description of one fleet cluster."""
    name: str
    region: str
    max_chips: int = 200
    accelerator: str = "v5e"
    cost_per_chip_hour: Optional[float] = None   # None -> accelerator default
    load_time: Optional[float] = None            # instance bring-up override


class FleetTopology:
    """Inter-region network model: one-way latency (seconds) and egress
    pricing. Pairs absent from ``latency`` fall back to ``inter_latency``
    (``intra_latency`` within a region); entries are symmetric."""

    def __init__(self, regions: Sequence, *,
                 latency: Optional[Dict[Tuple[str, str], float]] = None,
                 intra_latency: float = 0.002, inter_latency: float = 0.08,
                 egress_cost_per_gb: float = 0.08):
        self.regions = [r.name if isinstance(r, Region) else str(r)
                        for r in regions]
        self.intra_latency = intra_latency
        self.inter_latency = inter_latency
        self.egress_cost_per_gb = egress_cost_per_gb
        self._lat: Dict[Tuple[str, str], float] = {}
        for (a, b), v in (latency or {}).items():
            self._lat[(a, b)] = float(v)
            self._lat[(b, a)] = float(v)

    def latency(self, a: str, b: str) -> float:
        if a == b:
            return self.intra_latency
        return self._lat.get((a, b), self.inter_latency)


class FleetCluster:
    """One cluster in the fleet: SimCluster + queue + Chiron controller +
    residency set + rollup stats, under one per-cluster chip budget."""

    def __init__(self, spec: ClusterSpec, *, models: Sequence[str],
                 controller_kw: Optional[Dict] = None,
                 perf_kw: Optional[Dict] = None):
        acc = ACCELERATORS[spec.accelerator]
        kw = dict(acc["perf_kw"])
        kw.update(perf_kw or {})
        self.spec = spec
        self.perf_factory = default_perf_factory(**kw)
        self.cluster = SimCluster(self.perf_factory,
                                  max_chips=spec.max_chips,
                                  load_time=spec.load_time)
        ckw = dict(controller_kw or {})
        ckw.setdefault("models", list(models))
        self.controller = ChironController(**ckw)
        self.queue = GlobalQueue()
        # model -> "warming" (weights in flight) | "active" (serving)
        self.resident: Dict[str, str] = {}
        self.cost_per_chip_hour = spec.cost_per_chip_hour \
            if spec.cost_per_chip_hour is not None \
            else acc["cost_per_chip_hour"]
        self.stats = ClusterStats(name=spec.name, region=spec.region,
                                  accelerator=spec.accelerator,
                                  cost_per_chip_hour=self.cost_per_chip_hour)
        self._batch_cache: Dict[str, Tuple[float, int]] = {}
        self._itl_cache: Dict[str, float] = {}

    @property
    def name(self) -> str:
        return self.spec.name

    @property
    def region(self) -> str:
        return self.spec.region

    def free_chips(self) -> int:
        return self.cluster.max_chips - self.cluster.used_chips()

    # --------------------------------------------------- headroom queries
    def _batch_point(self, model: str) -> Tuple[float, int]:
        """($ per Mtoken, SLO-optimal batch size) for batch work here —
        the accelerator-aware ranking key the router and placer share."""
        c = self._batch_cache.get(model)
        if c is None:
            perf = self.perf_factory(model)
            b = perf.optimal_batch(BATCH_ITL_SLO, mean_ctx=512.0)
            thr = perf.throughput(b, mean_ctx=512.0)
            cost = self.cost_per_chip_hour * perf.chips \
                / max(thr * 3600.0, 1e-9) * 1e6
            c = self._batch_cache[model] = (cost, b)
        return c

    def batch_cost_per_mtoken(self, model: str) -> float:
        return self._batch_point(model)[0]

    def interactive_itl(self, model: str) -> float:
        """Reference decode latency (small batch) — ranks accelerator
        generations for interactive placement at equal network latency."""
        itl = self._itl_cache.get(model)
        if itl is None:
            itl = self._itl_cache[model] = \
                self.perf_factory(model).itl(8, mean_ctx=512.0)
        return itl

    def interactive_headroom(self, model: str) -> float:
        """Spare interactive capacity: free slots on healthy
        interactive/mixed instances plus room to grow in the chip budget
        (discounted — a new instance takes a model load to arrive)."""
        slots = 0
        for itype in (InstanceType.INTERACTIVE, InstanceType.MIXED):
            for i in self.cluster.by_model(model, itype):
                if i.active and not i.suspected_slow:
                    slots += max(i.max_batch_size - i.n_running, 0)
        growth = self.free_chips() // self.perf_factory(model).chips
        return slots + 8 * growth

    def batch_headroom(self, model: str) -> float:
        """Backpressure sign for batch routing: spare healthy batch/mixed
        slots plus budget growth at the SLO-optimal batch size, minus the
        work already queued here. Positive = this cluster can absorb."""
        slots = 0
        for itype in (InstanceType.BATCH, InstanceType.MIXED):
            for i in self.cluster.by_model(model, itype):
                if i.active and not i.suspected_slow:
                    slots += max(i.max_batch_size - i.n_running, 0)
        _, b = self._batch_point(model)
        growth = (self.free_chips() // self.perf_factory(model).chips) * b
        return slots + growth - self.queue.n_batch_for(model)

    def has_model_work(self, model: str) -> bool:
        return bool(self.queue.n_interactive_for(model)
                    or self.queue.n_batch_for(model)
                    or any(i.n_running
                           for i in self.cluster.instances_of(model)))


@dataclass
class Router:
    """Tier-3 request routing by SLO headroom (bound to a Fleet).

    Candidate orders are static for a fixed residency set — latency,
    reference ITL, and $/Mtoken are all static per (model, origin) — so
    they are cached and invalidated by the fleet's ``residency_epoch``
    instead of re-sorted on every arrival (the per-arrival hot path of
    ``simulate_fleet``).

    ``breaker`` arms per-cluster circuit breakers on the admission
    rejection-rate EWMA (fed by ``simulate_fleet`` when the overload
    plane is on): routing skips clusters whose breaker is open,
    deflecting to the next candidate at the price of the network hop;
    after the cooldown a half-open breaker admits trial traffic and
    closes on consecutive accepts. Transitions are stamped into the obs
    decision ledger (state code in the row's ``itype`` slot)."""

    breaker: Optional[BreakerConfig] = None

    def bind(self, fleet: "Fleet") -> None:
        self._fleet = fleet
        self._iorder: Dict[Tuple[str, str], Tuple[int, list]] = {}
        self._border: Dict[str, Tuple[int, list]] = {}
        self._breakers: Dict[str, CircuitBreaker] = {}
        if self.breaker is not None:
            self._breakers = {fc.name: CircuitBreaker(self.breaker)
                              for fc in fleet.clusters}

    # ------------------------------------------------- circuit breakers
    def breaker_for(self, fc: FleetCluster) -> Optional[CircuitBreaker]:
        return self._breakers.get(fc.name)

    def note_admission(self, fc: FleetCluster, rejected: bool,
                       now: float) -> Optional[Tuple[int, float]]:
        """Feed one admission outcome at ``fc`` into its breaker;
        returns ``(new_state_code, ewma)`` on a transition, else None."""
        brk = self._breakers.get(fc.name)
        if brk is None:
            return None
        new_state = brk.record(rejected, now)
        if new_state is None:
            return None
        return new_state, brk.ewma

    def _allowed(self, fc: FleetCluster, now: float) -> bool:
        """May traffic route to ``fc``? Stamps the open -> half-open
        cooldown transition when it happens here."""
        brk = self._breakers.get(fc.name)
        if brk is None:
            return True
        before = brk.state
        ok = brk.allows(now)
        if brk.state != before and self._fleet.obs is not None:
            self._fleet.obs.record_breaker(now, fc.name, brk.state,
                                           brk.ewma,
                                           brk.cfg.open_threshold)
        return ok

    def _actives_interactive(self, model: str, origin: str) -> list:
        fleet = self._fleet
        ep = fleet.residency_epoch
        c = self._iorder.get((model, origin))
        if c is None or c[0] != ep:
            topo = fleet.topology
            order = sorted((fc for fc in fleet.clusters
                            if fc.resident.get(model) == "active"),
                           key=lambda fc: (topo.latency(origin, fc.region),
                                           fc.interactive_itl(model),
                                           fc.name))
            self._iorder[(model, origin)] = c = (ep, order)
        return c[1]

    def _actives_batch(self, model: str) -> list:
        fleet = self._fleet
        ep = fleet.residency_epoch
        c = self._border.get(model)
        if c is None or c[0] != ep:
            order = sorted((fc for fc in fleet.clusters
                            if fc.resident.get(model) == "active"),
                           key=lambda fc: (fc.batch_cost_per_mtoken(model),
                                           fc.name))
            self._border[model] = c = (ep, order)
        return c[1]

    def route(self, req: Request, now: float) -> Tuple[FleetCluster, float]:
        """Pick the serving cluster; returns ``(cluster, network_delay)``.
        The delay is the origin->region latency — the fleet loop enqueues
        the request there only after it, so remote TTFT pays the hop."""
        fleet = self._fleet
        topo = fleet.topology
        origin = req.origin if req.origin else topo.regions[0]
        fc = self.pick(req, now)
        if fc.region != origin:
            fc.stats.remote_served += 1
            # prompt payload crosses origin -> serving region now; the
            # response is charged at completion (tokens actually made)
            fleet.add_egress(None, req.prompt_len * TOKEN_BYTES)
        return fc, topo.latency(origin, fc.region)

    def pick(self, req: Request, now: float) -> FleetCluster:
        """Destination selection only — no latency or egress accounting
        (``Fleet.drain`` re-dispatches through this and accounts the hop
        from the cluster the work actually leaves)."""
        fleet = self._fleet
        origin = req.origin if req.origin else fleet.topology.regions[0]
        model = req.model
        if req.is_interactive:
            fc = self._pick_interactive(model, origin, now)
        else:
            fc = self._pick_batch(model, now)
        if fc is None:
            # cold start: nothing resident anywhere — nearest cluster with
            # budget becomes the model's discovered (floor-less) home
            fc = fleet.closest_cluster(origin, model) or fleet.clusters[0]
            if fc.resident.setdefault(model, "active") == "active":
                fleet.residency_epoch += 1
        return fc

    def _pick_interactive(self, model: str, origin: str,
                          now: float) -> Optional[FleetCluster]:
        """Lowest latency with capacity; spill farther on saturation
        (and around open breakers — the hop is the deflection price);
        wait at the nearest routable cluster when the fleet is full."""
        order = self._actives_interactive(model, origin)
        if self._breakers:
            routable = [fc for fc in order if self._allowed(fc, now)]
            if routable:                 # every breaker open: route anyway
                order = routable
        for fc in order:
            if fc.interactive_headroom(model) > 0:
                return fc
        return order[0] if order else None

    def _pick_batch(self, model: str,
                    now: float) -> Optional[FleetCluster]:
        """Cheapest backpressure-positive cluster (placer's consolidation
        target first); least-backlogged when every cluster is saturated.
        Open breakers deflect batch work like interactive."""
        order = self._actives_batch(model)
        if not order:
            return None
        if self._breakers:
            routable = [fc for fc in order if self._allowed(fc, now)]
            if routable:
                order = routable
        tname = self._fleet.placer.batch_target.get(model)
        if tname is not None:
            tfc = self._fleet.by_name.get(tname)
            if tfc is not None and tfc in order:
                order = [tfc] + [fc for fc in order if fc is not tfc]
        for fc in order:
            if fc.batch_headroom(model) > 0:
                return fc
        return max(order, key=lambda fc: (fc.batch_headroom(model),
                                          fc.name))


@dataclass
class GlobalPlacer:
    """Forecast-driven model placement across the fleet (tier 3 control).

    Every ``interval`` seconds the placer reviews EWMA arrival-rate
    forecasts per (model, origin region): regions with real interactive
    demand get a resident copy in their closest capable cluster; each
    model's batch work is consolidated onto the cheapest cluster with
    capacity (migrating residency there when the saving clears
    ``migration_cost_margin``); placements idle for ``drain_strikes``
    consecutive reviews drain away; and saturated batch queues hand work
    back for re-routing. Residency additions are *not* instantaneous —
    weights transfer over ``wan_bw`` and load, surfaced as warm-up delay
    events on the simulator heap.
    """
    interval: float = 30.0
    ewma_alpha: float = 0.4
    place_rate_min: float = 0.5      # req/s regional demand worth a copy
    drain_strikes: int = 3
    wan_bw: float = 1.25e9           # bytes/s cross-region weight transfer
    handback_queue_min: int = 64
    migration_cost_margin: float = 0.8
    theta_refresh: float = 120.0
    theta_history: int = 4096

    def __post_init__(self):
        self._fleet: Optional["Fleet"] = None
        self._win_i: Dict[Tuple[str, str], int] = {}
        self._win_b: Dict[str, int] = {}
        self._rate_i: Dict[Tuple[str, str], float] = {}
        self._rate_b: Dict[str, float] = {}
        self._models: set = set()
        self._arrivals: Dict[str, List[float]] = {}
        self._next_theta: Dict[str, float] = {}
        self._strikes: Dict[Tuple[str, str], int] = {}
        self._last_review = 0.0
        self.batch_target: Dict[str, str] = {}

    def bind(self, fleet: "Fleet") -> None:
        self._fleet = fleet

    # ------------------------------------------------------------ intake
    def observe_arrival(self, req: Request, now: float) -> None:
        model = req.model
        self._models.add(model)
        if req.is_interactive:
            origin = req.origin if req.origin else \
                self._fleet.topology.regions[0]
            key = (model, origin)
            self._win_i[key] = self._win_i.get(key, 0) + 1
            self._arrivals.setdefault(model, []).append(now)
        else:
            self._win_b[model] = self._win_b.get(model, 0) + 1

    # ------------------------------------------------------------ review
    def review(self, now: float, emit_warm) \
            -> List[Tuple[Request, FleetCluster, float]]:
        """One placement pass; returns handed-back requests to re-dispatch
        as ``(request, destination, network_delay)``."""
        fleet = self._fleet
        dt = max(now - self._last_review, 1e-9)
        self._last_review = now
        # sorted: set-union iteration order is address-dependent, and the
        # update order decides the rate dicts' insertion order downstream
        for key in sorted(set(self._rate_i) | set(self._win_i)):
            obs = self._win_i.get(key, 0) / dt
            r = self._rate_i.get(key, 0.0)
            self._rate_i[key] = r + self.ewma_alpha * (obs - r)
        for m in sorted(set(self._rate_b) | set(self._win_b)):
            obs = self._win_b.get(m, 0) / dt
            r = self._rate_b.get(m, 0.0)
            self._rate_b[m] = r + self.ewma_alpha * (obs - r)
        self._win_i.clear()
        self._win_b.clear()

        redispatch: List[Tuple[Request, FleetCluster, float]] = []
        for model in sorted(self._models):
            self._refresh_theta(model, now)
            self._place_interactive(model, now, emit_warm)
            self._place_batch(model, now, emit_warm)
            self._drain_idle(model, now, redispatch)
            self._hand_back(model, now, redispatch)
        return redispatch

    def _refresh_theta(self, model: str, now: float) -> None:
        """The paper's Theta-from-history heuristic, fleet-wide: one
        arrival stream per model feeds every resident controller."""
        nxt = self._next_theta.get(model, 0.0)
        if now < nxt:
            return
        self._next_theta[model] = now + self.theta_refresh
        arrivals = self._arrivals.get(model, [])
        if len(arrivals) > self.theta_history:
            del arrivals[:-self.theta_history]
        if len(arrivals) < 20:
            return
        theta = theta_from_history(np.asarray(arrivals), 30.0)
        for fc in self._fleet.clusters:
            scaler = fc.controller.interactive_scalers.get(model)
            if scaler is not None:
                scaler.theta = theta

    def _place_interactive(self, model: str, now: float, emit_warm) -> None:
        for region in self._fleet.topology.regions:
            if self._rate_i.get((model, region), 0.0) < self.place_rate_min:
                continue
            fc = self._fleet.closest_cluster(region, model)
            if fc is not None:
                self.ensure_resident(model, fc, now, emit_warm)

    def _place_batch(self, model: str, now: float, emit_warm) -> None:
        fleet = self._fleet
        has_batch = self._rate_b.get(model, 0.0) > 0.0 or \
            any(fc.queue.n_batch_for(model) for fc in fleet.clusters)
        if not has_batch:
            return
        ranked = sorted(fleet.clusters, key=lambda fc:
                        (fc.batch_cost_per_mtoken(model), fc.name))
        resident = [fc for fc in ranked
                    if fc.resident.get(model) == "active"]
        if not resident:
            if ranked:
                self.ensure_resident(model, ranked[0], now, emit_warm)
            return
        best, cur = ranked[0], resident[0]
        if best is not cur and best.resident.get(model) is None \
                and best.batch_cost_per_mtoken(model) < \
                self.migration_cost_margin * cur.batch_cost_per_mtoken(model) \
                and best.free_chips() >= best.perf_factory(model).chips:
            # meaningfully cheaper home with room: start the migration —
            # the target flips once it finishes warming
            self.ensure_resident(model, best, now, emit_warm)
        target = next((fc for fc in resident
                       if fc.batch_headroom(model) > 0), resident[0])
        self.batch_target[model] = target.name

    def _drain_idle(self, model: str, now: float, redispatch) -> None:
        """Placements neither needed (demand, batch target) nor busy for
        ``drain_strikes`` consecutive reviews drain away — never the last
        active copy."""
        fleet = self._fleet
        needed = set()
        t = self.batch_target.get(model)
        if t is not None:
            needed.add(t)
        for region in fleet.topology.regions:
            if self._rate_i.get((model, region), 0.0) >= \
                    0.5 * self.place_rate_min:
                fc = fleet.closest_cluster(region, model)
                if fc is not None:
                    needed.add(fc.name)
        actives = [fc for fc in fleet.clusters
                   if fc.resident.get(model) == "active"]
        for fc in list(actives):
            key = (model, fc.name)
            if fc.name in needed or fc.has_model_work(model):
                self._strikes.pop(key, None)
                continue
            strikes = self._strikes.get(key, 0) + 1
            self._strikes[key] = strikes
            if strikes >= self.drain_strikes and len(actives) > 1:
                self._strikes.pop(key, None)
                redispatch.extend(fleet.drain(model, fc, now))
                actives.remove(fc)

    def _hand_back(self, model: str, now: float, redispatch) -> None:
        """Saturation hand-back: a budget-full cluster with a deep batch
        queue surrenders half of it to the cheapest cluster that can
        absorb the work."""
        fleet = self._fleet
        for fc in fleet.clusters:
            qn = fc.queue.n_batch_for(model)
            if qn < self.handback_queue_min:
                continue
            if fc.free_chips() >= fc.perf_factory(model).chips:
                continue                 # can still grow locally
            alts = [a for a in fleet.clusters
                    if a is not fc and a.resident.get(model) == "active"
                    and a.batch_headroom(model) > qn // 2]
            if not alts:
                continue
            alt = min(alts, key=lambda a:
                      (a.batch_cost_per_mtoken(model), a.name))
            delay = fleet.topology.latency(fc.region, alt.region)
            moved = 0
            for _ in range(qn // 2):
                r = fc.queue.pop_batch_fcfs(model)
                if r is None:
                    break
                # the work leaves this cluster: any host-saved KV stays
                # behind (the receiver must re-prefill), cross-region
                # hand-offs move the prompt payload again, and the
                # receiver tallies a cross-region assignment — same
                # accounting as a Router cross-region route
                r.saved_kv = None
                if alt.region != fc.region:
                    fleet.add_egress(fc, r.prompt_len * TOKEN_BYTES)
                if r.origin and alt.region != r.origin:
                    alt.stats.remote_served += 1
                redispatch.append((r, alt, delay))
                moved += 1
            fc.stats.handbacks += moved
            fleet.handbacks += moved
            if moved and fleet.obs is not None:
                fleet.obs.record_handback(now, fc.name, alt.name, model,
                                          moved)

    # --------------------------------------------------------- migrations
    def ensure_resident(self, model: str, fc: FleetCluster, now: float,
                        emit_warm) -> None:
        """Make ``model`` resident in ``fc`` (no-op if it already is or is
        warming). Weights come from the nearest active copy — cross-region
        transfers pay WAN time and egress — and the placement only serves
        after the warm-up event fires."""
        if fc.resident.get(model) in ("warming", "active"):
            return
        fleet = self._fleet
        perf = fc.perf_factory(model)
        delay = perf.model_load_time()
        sources = [s for s in fleet.clusters if s is not fc
                   and s.resident.get(model) == "active"]
        if sources:
            src = min(sources, key=lambda s:
                      (fleet.topology.latency(fc.region, s.region), s.name))
            if src.region != fc.region:
                delay += perf.weight_bytes / self.wan_bw
                fleet.add_egress(src, perf.weight_bytes)
        fc.resident[model] = "warming"
        fc.stats.migrations_in += 1
        fleet.migrations += 1
        if fleet.obs is not None:
            fleet.obs.record_migration(now, fc.name, model, delay)
        emit_warm(delay, (model, fc))


class Fleet:
    """The multi-cluster serving plane ``simulate_fleet`` drives.

    ``placement`` maps model -> cluster names initially resident (default:
    every model everywhere). Clusters with no initial placement idle until
    the placer or a cold-start route gives them one.
    """

    def __init__(self, specs: Sequence[ClusterSpec],
                 topology: Optional[FleetTopology] = None, *,
                 models: Sequence[str] = (DEFAULT_MODEL,),
                 placement: Optional[Dict[str, Sequence[str]]] = None,
                 controller_kw: Optional[Dict] = None,
                 perf_kw: Optional[Dict] = None,
                 placer: Optional[GlobalPlacer] = None,
                 router: Optional[Router] = None):
        specs = list(specs)
        if not specs:
            raise ValueError("a Fleet needs at least one ClusterSpec")
        names = [s.name for s in specs]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate cluster names: {names}")
        if topology is None:
            topology = FleetTopology(sorted({s.region for s in specs}))
        self.topology = topology
        self.models = list(models)
        if placement is None:
            placement = {m: names for m in self.models}
        self.clusters: List[FleetCluster] = []
        self.by_name: Dict[str, FleetCluster] = {}
        for s in specs:
            placed = sorted(m for m, cs in placement.items()
                            if s.name in cs)
            fc = FleetCluster(s, models=placed or [self.models[0]],
                              controller_kw=controller_kw, perf_kw=perf_kw)
            if not placed:
                # the controller needs a primary model; un-pin it so this
                # cluster holds no floor until the placer assigns work
                fc.controller.set_model_placed(self.models[0], False)
            for m in placed:
                fc.resident[m] = "active"
            self.clusters.append(fc)
            self.by_name[s.name] = fc
        self.placer = placer or GlobalPlacer()
        self.placer.bind(self)
        self.router = router or Router()
        self.router.bind(self)
        self.migrations = 0
        self.handbacks = 0
        self.egress_bytes = 0.0
        self.egress_cost_usd = 0.0
        # flight recorder (repro_torch.obs) attached by simulate_fleet when
        # telemetry is armed; tier-3 actions land in its decision ledger
        self.obs = None
        # bumped whenever some model's set of active residencies changes;
        # the Router's cached candidate orders key on it
        self.residency_epoch = 0

    # ------------------------------------------------------------ helpers
    def add_egress(self, src: Optional[FleetCluster], nbytes: float) -> None:
        if src is not None:
            src.stats.egress_bytes += nbytes
        self.egress_bytes += nbytes
        self.egress_cost_usd += nbytes / 1e9 \
            * self.topology.egress_cost_per_gb

    def closest_cluster(self, region: str,
                        model: str) -> Optional[FleetCluster]:
        """Lowest-latency cluster from ``region`` that either already
        serves ``model`` or has budget to start."""
        order = sorted(self.clusters, key=lambda fc:
                       (self.topology.latency(region, fc.region), fc.name))
        for fc in order:
            if fc.resident.get(model) == "active" or \
                    fc.free_chips() >= fc.perf_factory(model).chips:
                return fc
        return order[0] if order else None

    # ------------------------------------------- simulate_fleet protocol
    def observe_arrival(self, req: Request, now: float) -> None:
        self.placer.observe_arrival(req, now)

    def route(self, req: Request, now: float) -> Tuple[FleetCluster, float]:
        return self.router.route(req, now)

    def review(self, now: float, emit_warm):
        return self.placer.review(now, emit_warm)

    def on_warm(self, payload, now: float) -> None:
        model, fc = payload
        if fc.resident.get(model) == "warming":
            fc.resident[model] = "active"
            fc.controller.set_model_placed(model, True)
            self.residency_epoch += 1

    def drain(self, model: str, fc: FleetCluster, now: float) \
            -> List[Tuple[Request, FleetCluster, float]]:
        """Remove a residency; queued work is handed back for re-routing
        (running work finishes where it is, then the floor-less local
        fleet scales itself away). The hop is accounted from *this*
        cluster — the work physically leaves here, not the origin — and
        any host-saved KV stays behind (another cluster's hosts never
        held it), so moved requests re-prefill at the destination."""
        fc.resident.pop(model, None)
        fc.controller.set_model_placed(model, False)
        fc.stats.migrations_out += 1
        self.residency_epoch += 1
        out = []
        for r in fc.queue.drain_model(model):
            r.saved_kv = None
            dest = self.router.pick(r, now)
            if dest.region != fc.region:
                self.add_egress(fc, r.prompt_len * TOKEN_BYTES)
            if r.origin and dest.region != r.origin:
                dest.stats.remote_served += 1
            out.append((r, dest,
                        self.topology.latency(fc.region, dest.region)))
        if self.obs is not None:
            self.obs.record_drain(now, fc.name, model, len(out))
        return out

    def observe_completion(self, req: Request, fc: FleetCluster,
                           now: float) -> None:
        st = fc.stats
        met = req.slo_met()
        if req.is_interactive:
            st.served_interactive += 1
            st.slo_met_interactive += met
        else:
            st.served_batch += 1
            st.slo_met_batch += met
        if req.origin and fc.region != req.origin:
            # response tokens travel back to the origin region
            self.add_egress(fc, req.tokens_generated * TOKEN_BYTES)

    def finalize(self) -> List[ClusterStats]:
        """Copy terminal SimCluster counters into the per-cluster stats
        (called by ``simulate_fleet`` when the run ends)."""
        for fc in self.clusters:
            st = fc.stats
            st.chip_seconds = fc.cluster.chip_seconds
            st.peak_chips = fc.cluster.peak_chips
            st.scale_ups = fc.cluster.scale_ups
            st.scale_downs = fc.cluster.scale_downs
            st.failures = fc.cluster.failures
            st.degradations = fc.cluster.degradations
        return [fc.stats for fc in self.clusters]
