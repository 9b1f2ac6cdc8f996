"""Cluster controllers: Chiron (hierarchical) and the Llumnix baseline.

A controller's ``control(cluster, queue, now)`` runs every control interval
and turns backpressure into provision/retire actions; ``route`` places
queued requests onto instances per the paper's preferential routing.

Multi-model fleets: ``ChironController(models=[...])`` runs one full
hierarchy per model — a per-model IBP/Theta interactive scaler and a
per-model Algorithm-2 batch scaler whose request groups are maintained off
that model's queue lane — while every provision draws from the single
shared chip budget (``max_chips``). Routing is model-keyed end to end: a
request is only ever offered to instances of its own model (the instance's
``can_admit`` enforces the invariant as a backstop). Models seen in the
arrival stream but not configured are registered on the fly.

The port's copy of the reference's ``sim/controllers.py`` with the paths a
duck-typed cluster takes (``serving.real_cluster.RealCluster``): the method
names and the order of decisions are the reference's. What only the
reference's simulator reaches is left out — the fused ``_scan_admit`` and
the memoized ``_find_slot`` over ``SimCluster.pool_pair``, the event core's
``route_arrival`` / ``route_arrival_burst``, the ``route_version`` memo,
the overload plane's brownout arm (``brownout_active``,
``brownout_preempt_batch``), the fleet placer's ``set_model_placed`` and the
ablation arms its benchmarks set (``local_enabled``, ``global_enabled``,
``ChironController.static_batch`` and ``group_k``) —
and so is the flight recorder (``obs``), which the port does not have.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.core.baselines import LlumnixAutoscaler
from repro_torch.core.global_autoscaler import (BatchAutoscaler,
                                                InteractiveAutoscaler)
from repro_torch.core.local_autoscaler import LocalAutoscaler
from repro_torch.core.waiting_time import WaitingTimeEstimator
from repro_torch.serving.global_queue import GlobalQueue
from repro_torch.serving.request import Request, RequestType
from repro_torch.sim.cluster import SLOW_SUSPECT_RATIO, InstanceType


def _best_fit(insts: List) -> Optional[object]:
    """Most-loaded instance that can still admit (packing). Packing — not
    least-loaded spreading — keeps interactive requests concentrated so
    IBP counts genuinely-busy instances and mixed spare capacity stays
    spare (otherwise every mixed instance 'runs interactive' and the
    interactive scaler over-provisions 3x its own additions).

    Instances whose health EWMA marks them suspected-slow are routed
    around whenever a healthy candidate exists — degradation detection
    must not strand requests, so a fully-degraded pool still serves."""
    cands = [i for i in insts if i.active]
    if not cands:
        return None
    healthy = [i for i in cands if not i.suspected_slow]
    return max(healthy or cands, key=lambda i: i.slot_utilization())


class BaseController:
    """Shared routing: interactive -> interactive then mixed (preempting
    batch); batch -> batch instances then spare mixed capacity; every
    lookup stays inside the request's own model pools.

    ``route`` is the full preferential pass, run every step of the serving
    loop.
    """

    serves_batch_on_mixed = True

    def route(self, cluster, queue: GlobalQueue, now: float) -> None:
        self.route_interactive(cluster, queue, now)
        if not queue.n_batch:
            return
        for model in queue.batch_models():
            pools = [cluster.by_model(model, InstanceType.BATCH)]
            if self.serves_batch_on_mixed:
                pools.append(cluster.by_model(model, InstanceType.MIXED))
            for pool in pools:
                self.backfill(pool, queue, now)

    def route_interactive(self, cluster, queue: GlobalQueue,
                          now: float) -> None:
        if not queue.n_interactive:     # hot path: most events route nothing
            return
        # ---- interactive: zero-queuing, one pass per model lane
        for model in queue.interactive_models():
            self._route_interactive_model(cluster, queue, model, now)

    def _route_interactive_model(self, cluster, queue: GlobalQueue,
                                 model: str, now: float) -> None:
        # duck-typed cluster: the generic can_admit path (the reference's
        # saturation memo serves only its simulator)
        req = queue.peek_interactive(model)
        while req is not None:
            inst = self._find_slot_generic(cluster, queue, model, req, now)
            if inst is None:
                break
            inst.admit(queue.pop_interactive(model), now)
            req = queue.peek_interactive(model)

    def _find_slot_generic(self, cluster, queue: GlobalQueue, model: str,
                           req: Request, now: float):
        """Find (or make, by evicting batch work) a slot for one
        interactive request: interactive pool, then mixed pool, then batch
        preemption on a same-model mixed instance — the original
        ``can_admit``/``_best_fit`` pass. The eviction branch mutates
        (victim requeued); the caller admits into the returned instance
        immediately."""
        for pool in (cluster.by_model(model, InstanceType.INTERACTIVE),
                     cluster.by_model(model, InstanceType.MIXED)):
            inst = _best_fit([i for i in pool if i.can_admit(req)])
            if inst is not None:
                return inst
        for inst in cluster.by_model(model, InstanceType.MIXED):
            if not inst.active or inst.n_running_batch() == 0:
                continue
            victim = inst.evict_one_batch(now)
            if victim is not None:
                queue.requeue(victim)
                return inst
        return None

    def backfill(self, insts, queue: GlobalQueue, now: float) -> None:
        """Fill spare capacity on ``insts`` from their models' batch lanes.
        The queue pops in service order (resume lane, then earliest
        deadline / FCFS) — no per-pass sort."""
        for inst in insts:
            if inst.itype == InstanceType.INTERACTIVE:
                continue             # interactive pool never serves batch
            if inst.health_ewma > SLOW_SUSPECT_RATIO:
                continue             # route around degraded nodes; the
                                     # batch scaler re-adds the capacity
            model = inst.model
            # duck-typed instance (real engine): generic can_admit
            while inst.active and inst.n_running < inst.max_batch_size \
                    and queue.n_batch_for(model):
                req = queue.peek_batch(model)
                if not inst.can_admit(req):
                    break
                inst.admit(queue.pop_batch_fcfs(model), now)

    def control(self, cluster, queue: GlobalQueue, now: float) -> None:
        raise NotImplementedError


@dataclass
class ChironController(BaseController):
    """The paper's hierarchical autoscaler (local + global), replicated
    per model when ``models`` lists a fleet."""
    model: str = "llama-8b"
    models: Optional[Sequence[str]] = None  # multi-model fleet; None = [model]
    theta: float = 1.0 / 3.0
    delta: float = 0.1
    itl_slo_interactive: float = 0.2
    itl_slo_batch: float = 2.0
    estimator: WaitingTimeEstimator = field(default_factory=WaitingTimeEstimator)
    min_instances: int = 1
    init_batch: int = 8
    max_batch: int = 4096
    # paper §5.2: Theta is chosen from historical arrival spikes (tail
    # spike 3x -> Theta = 1/3). auto_theta re-estimates it online from the
    # observed arrival process every `theta_refresh` seconds — per model:
    # each model runs its own refresh clock, and `theta_refresh_per_model`
    # overrides the cadence for models whose arrival processes drift on a
    # different timescale than the fleet default.
    auto_theta: bool = False
    theta_refresh: float = 120.0
    theta_refresh_per_model: Optional[Dict[str, float]] = None
    # arrival history kept per model for Theta re-estimation: a rolling
    # window (recent spikes are what Theta hedges against) that also
    # bounds memory on long replays
    theta_history: int = 4096

    def __post_init__(self):
        self.model_list: List[str] = list(self.models) if self.models \
            else [self.model]
        if self.model not in self.model_list:
            # model= was left at its default (or named a model outside the
            # fleet): the fleet's first entry becomes the primary
            self.model = self.model_list[0]
        self._configured = set(self.model_list)
        self.interactive_scalers: Dict[str, InteractiveAutoscaler] = {}
        self._batch_scalers: Dict[str, Optional[BatchAutoscaler]] = {}
        self._arrivals: Dict[str, List[float]] = {}
        # per-model waiting-time estimators: models with divergent output
        # distributions must not pollute each other's QLM fit. The primary
        # model keeps the `estimator` field itself.
        self.estimators: Dict[str, WaitingTimeEstimator] = {
            self.model: self.estimator}
        self._out_models: Dict[str, object] = {}
        self._next_theta_update: Dict[str, float] = {}
        for m in self.model_list:
            self._register_model(m)

    # ------------------------------------------------------------ helpers
    def _register_model(self, model: str) -> None:
        # discovered (unconfigured) models get no instance floor: once
        # their traffic drains, their fleet may drop to zero instances
        floor = self.min_instances if model in self._configured else 0
        self.interactive_scalers[model] = InteractiveAutoscaler(
            self.theta, self.delta, floor)
        self._batch_scalers[model] = None
        self._arrivals[model] = []
        self._next_theta_update[model] = self._theta_cadence(model)

    def _theta_cadence(self, model: str) -> float:
        if self.theta_refresh_per_model \
                and model in self.theta_refresh_per_model:
            return self.theta_refresh_per_model[model]
        return self.theta_refresh

    def _estimator_for(self, model: str) -> WaitingTimeEstimator:
        est = self.estimators.get(model)
        if est is None:
            est = self.estimators[model] = WaitingTimeEstimator(
                quantile_z=self.estimator.quantile_z)
        return est

    def _mk_local(self, slo: float) -> LocalAutoscaler:
        return LocalAutoscaler(itl_slo=slo, init_batch=self.init_batch,
                               max_batch=self.max_batch)

    def _provision(self, cluster, itype: InstanceType, now: float,
                   model: Optional[str] = None):
        slo = self.itl_slo_batch if itype == InstanceType.BATCH \
            else self.itl_slo_interactive
        return cluster.provision(
            model or self.model, itype, now,
            local_autoscaler=self._mk_local(slo))

    def batch_instance_throughput(self, cluster,
                                  model: Optional[str] = None) -> float:
        perf = cluster.perf_factory(model or self.model)
        b = perf.optimal_batch(self.itl_slo_batch, mean_ctx=512.0)
        return perf.throughput(b, mean_ctx=512.0)

    # ------------------------------------------------------------ control
    def observe_arrival(self, req: Request, now: float) -> None:
        m = req.model
        if m not in self.interactive_scalers:   # a model seen first here
            self.model_list.append(m)
            self._register_model(m)
        if self.auto_theta \
                and req.request_type == RequestType.INTERACTIVE:
            self._arrivals[m].append(now)

    def _refresh_theta(self, now: float) -> None:
        """Per-model Theta re-estimation: every model runs its own refresh
        clock (its own cadence), so a model whose arrival process shifts
        quickly is not held hostage by the fleet-wide schedule."""
        if not self.auto_theta:
            return
        from repro_torch.sim.workload import arrival_spikes
        for model, arrivals in self._arrivals.items():
            if now < self._next_theta_update[model]:
                continue
            self._next_theta_update[model] = now + self._theta_cadence(model)
            if len(arrivals) > self.theta_history:   # rolling window
                del arrivals[:-self.theta_history]
            if len(arrivals) < 20:
                continue
            spikes = arrival_spikes(np.asarray(arrivals), 30.0)
            if spikes.size:
                tail = float(np.percentile(spikes, 99.0))
                self.interactive_scalers[model].theta = 1.0 / max(tail, 1.0)

    def control(self, cluster, queue: GlobalQueue, now: float) -> None:
        # 0. bootstrap + optional Theta re-estimation from arrival history.
        # Configured models always keep a foothold; models discovered from
        # the arrival stream are provisioned on demand only — a replayed
        # trace with many transient deployments must not pin a chip per
        # deployment forever.
        self._refresh_theta(now)
        for m in self.model_list:
            if cluster.instances_of(m):
                continue
            if m in self._configured or queue.n_interactive_for(m) \
                    or queue.n_batch_for(m):
                self._provision(cluster, InstanceType.MIXED, now, m)

        # 1. local autoscaling + health tracking on every instance (the
        # health EWMA is the slow-node detection signal routing reads)
        for inst in cluster.active_instances():
            inst.update_health()
            inst.update_local_autoscaler()

        # 2./3. one global loop per model, all sharing the chip budget.
        # Drained models (no instances, no queued work — only possible for
        # discovered ones after the bootstrap above) are skipped.
        for m in self.model_list:
            if not cluster.instances_of(m) \
                    and not queue.n_interactive_for(m) \
                    and not queue.n_batch_for(m):
                continue
            self._control_model(cluster, queue, m, now)

    def _control_model(self, cluster, queue: GlobalQueue, model: str,
                       now: float) -> None:
        # 2. interactive/mixed scaling on this model's IBP
        inter = cluster.by_model(model, InstanceType.INTERACTIVE)
        mixed = cluster.by_model(model, InstanceType.MIXED)
        n_running = sum(1 for i in inter + mixed if i.runs_interactive())
        iscaler = self.interactive_scalers[model]
        dec = iscaler.update(n_running, len(inter), len(mixed))
        if dec.delta_instances > 0:
            # Algorithm 1: IBP above the band
            for _ in range(dec.delta_instances):
                if self._provision(cluster, InstanceType.MIXED, now,
                                   model) is None:
                    break               # shared chip budget exhausted
        elif dec.delta_instances < 0:
            # Algorithm 1: IBP below the band
            floor = self.min_instances if model in self._configured else 0
            idle_mixed = [i for i in mixed
                          if i.active and not i.runs_interactive()]
            idle_mixed.sort(key=lambda i: i.n_running)
            for inst in idle_mixed[:-dec.delta_instances]:
                if len(cluster.by_model(model, InstanceType.MIXED)) + \
                        len(cluster.by_model(model,
                                             InstanceType.INTERACTIVE)) \
                        <= floor:
                    break
                for r in cluster.retire(inst):
                    queue.requeue(r)

        # 3. batch scaling on this model's BBP (Algorithm 2)
        scaler = self._batch_scalers[model]
        if scaler is None:
            scaler = self._batch_scalers[model] = BatchAutoscaler(
                self._estimator_for(model),
                self.batch_instance_throughput(cluster, model),
                model=model)
        spare = sum(i.spare_throughput()
                    for i in cluster.by_model(model, InstanceType.MIXED)
                    if i.active)
        n_batch_inst = len(cluster.by_model(model, InstanceType.BATCH))
        n_active_batch = 0
        for itype in InstanceType:
            for i in cluster.by_model(model, itype):
                n_active_batch += i.n_running_batch()
        # pass the queue itself: request groups are maintained
        # incrementally off its per-model add/remove stream
        dec2 = scaler.update(
            queue, now,
            n_batch_instances=n_batch_inst,
            spare_mixed_throughput=spare,
            n_active_batch_requests=n_active_batch)
        if dec2.retire_all:
            # Algorithm 2: no batch work left
            for inst in list(cluster.by_model(model, InstanceType.BATCH)):
                for r in cluster.retire(inst):
                    queue.requeue(r)
        elif dec2.remove_instances > 0:
            # Algorithm 2 minimality: surrender excess batch instances
            # while BBP stays 0 — idle/least-loaded (and still-loading)
            # instances first, displaced requests re-enter the queue
            victims = sorted(cluster.by_model(model, InstanceType.BATCH),
                             key=lambda i: (i.active, i.n_running))
            for inst in victims[:dec2.remove_instances]:
                for r in cluster.retire(inst):
                    queue.requeue(r)
        else:
            # Algorithm 2: BBP > 0, add until it clears
            for _ in range(dec2.add_instances):
                if self._provision(cluster, InstanceType.BATCH, now,
                                   model) is None:
                    break               # shared chip budget exhausted

    def observe_completion(self, req: Request) -> None:
        # per-model output-length fit: each model's QLM estimator only
        # sees its own completions (``OutputLengthModel.observe`` inlined:
        # same moment-sum arithmetic)
        om = self._out_models.get(req.model)
        if om is None:
            om = self._out_models[req.model] = \
                self._estimator_for(req.model).output_model
        o = req.output_len
        om._n += 1
        om._sum += o
        om._sumsq += o * o
        om._stale = True


@dataclass
class LlumnixController(BaseController):
    """Utilization-band autoscaler; SLO-unaware, no queue deferral.
    Single-model baseline (the paper's comparison arm)."""
    model: str = "llama-8b"
    low: float = 0.3
    high: float = 0.8
    static_batch: int = 64
    min_instances: int = 1

    def __post_init__(self):
        self.scaler = LlumnixAutoscaler(self.low, self.high,
                                        self.min_instances)

    # every Llumnix instance serves whatever arrives -> model as MIXED
    def control(self, cluster, queue: GlobalQueue, now: float) -> None:
        if not cluster.instances:
            cluster.provision(self.model, InstanceType.MIXED, now,
                              static_batch=self.static_batch)
        insts = cluster.active_instances()
        util = (sum(i.kv_utilization() for i in insts) / len(insts)) \
            if insts else 1.0
        delta = self.scaler.update(util, len(cluster.instances), len(queue))
        if delta > 0:
            for _ in range(delta):
                cluster.provision(self.model, InstanceType.MIXED, now,
                                  static_batch=self.static_batch)
        elif delta < 0:
            idle = [i for i in insts if i.n_running == 0]
            for inst in idle[:(-delta)]:
                if len(cluster.instances) <= self.min_instances:
                    break
                cluster.retire(inst)

    def observe_completion(self, req: Request) -> None:
        pass
