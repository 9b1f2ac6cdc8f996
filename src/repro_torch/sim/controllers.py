"""Cluster controllers: Chiron (hierarchical) and the baselines.

A controller's ``control(cluster, queue, now)`` runs every control interval
and turns backpressure into provision/retire actions; ``route`` places
queued requests onto instances per the paper's preferential routing.

Multi-model fleets: ``ChironController(models=[...])`` runs one full
hierarchy per model — a per-model IBP/Theta interactive scaler and a
per-model Algorithm-2 batch scaler whose request groups are maintained off
that model's queue lane — while every provision draws from the single
shared chip budget (``SimCluster.max_chips``). Routing is model-keyed end
to end: a request is only ever offered to instances of its own model
(``SimInstance.can_admit`` enforces the invariant as a backstop). Models
seen in the arrival stream but not configured are registered on the fly.

The port's copy of the reference's ``sim/controllers.py``, whole. The same
controllers drive both clusters: the simulated one (``SimCluster``: the
fused ``_scan_admit``, the memoized ``_find_slot``, the event core's
``route_arrival`` / ``route_arrival_burst`` and its ``route_version``
memo) and the real one (``serving.real_cluster.RealCluster``, duck-typed:
the generic ``can_admit`` / ``_best_fit`` pass). The overload plane's
brownout arm, the fleet placer's ``set_model_placed``, the ablation arms
(``local_enabled``, ``global_enabled``, ``static_batch``, ``group_k``) and
the flight recorder's hooks (``obs``) are the reference's too.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.baselines import LlumnixAutoscaler
from repro_torch.core.global_autoscaler import BatchAutoscaler, InteractiveAutoscaler
from repro_torch.core.local_autoscaler import LocalAutoscaler
from repro_torch.core.waiting_time import WaitingTimeEstimator
from repro_torch.obs.recorder import (R_BBP_ADD as _R_BBP_ADD,
                                      R_BBP_IDLE as _R_BBP_IDLE,
                                      R_BBP_TRIM as _R_BBP_TRIM,
                                      R_IBP_HIGH as _R_IBP_HIGH,
                                      R_IBP_LOW as _R_IBP_LOW)
from repro_torch.serving.global_queue import GlobalQueue
from repro_torch.serving.request import Request, RequestType
from repro_torch.sim.cluster import (SLOW_SUSPECT_RATIO, InstanceType, SimCluster,
                                     SimInstance)

_SCAN_INF = float("inf")


def _best_fit(insts: List[SimInstance]) -> Optional[SimInstance]:
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


def _scan_admit(pool: List[SimInstance],
                req: Request) -> Tuple[Optional[SimInstance], float]:
    """One fused pass over a same-model pool: admission check (active,
    batch slot free, KV wall) and best-fit packing (max slot utilization,
    first max wins, suspected-slow instances only as a last resort) —
    semantically identical to ``_best_fit([i for i in pool if
    i.can_admit(req)])`` but without building candidate lists or paying a
    method call per instance. This is the per-arrival routing hot path.

    Returns ``(winner, rej_slack)`` where ``rej_slack`` is the largest
    ``wall - kv`` over instances this scan rejected *by the KV wall*
    (``-1.0`` when none were). The wall test is the only request-dependent
    admission check — a later request with ``prompt_len > rej_slack`` is
    provably rejected by every instance this scan rejected, which is what
    lets the positive-scan memo in ``route_arrival_burst`` skip the
    rescan without changing any decision."""
    best = None
    best_u = -1.0
    slow_best = None
    slow_u = -1.0
    rej = -1.0
    pl = req.prompt_len
    inf = _SCAN_INF
    for inst in pool:
        if not inst.active:
            continue
        n = len(inst.running)
        loc = inst.local
        mb = loc.max_batch_size if loc is not None \
            else (inst.static_batch or 64)
        if n >= mb:
            continue
        wall = inst._c_wall
        if wall != inf:
            if inst.event_mode:
                kv = inst._kv_prefill + inst._kv_dec_base \
                    + inst._n_dec * inst.vclock
            else:
                kv = inst._kv_tokens
            if kv + pl > wall:
                s = wall - kv
                if s > rej:
                    rej = s
                continue
        u = n / mb if mb >= 1 else float(n)
        if inst.health_ewma > SLOW_SUSPECT_RATIO:
            if u > slow_u:
                slow_u, slow_best = u, inst
        elif u > best_u:
            best_u, best = u, inst
    return (best if best is not None else slow_best), rej


class BaseController:
    """Shared routing: interactive -> interactive then mixed (preempting
    batch); batch -> batch instances then spare mixed capacity; every
    lookup stays inside the request's own model pools.

    ``route`` is the full preferential pass (every fixed tick / control
    tick); the event core additionally calls ``route_interactive`` on every
    event (zero-queuing) and ``backfill`` for just-freed instances, so the
    hot path never rescans the whole cluster per completion.
    """

    serves_batch_on_mixed = True
    # flight recorder (repro_torch.obs) attached by the engines when telemetry
    # is armed; None costs one predicted branch per control tick
    obs = None
    # brownout mode (repro_torch.sim.overload): while True, batch work is
    # deferred — no batch routing or backfill — so every slot serves the
    # interactive backlog. Set by the engines' overload plane; the False
    # default keeps overload-free runs bit-identical.
    brownout_active = False

    def route(self, cluster: SimCluster, queue: GlobalQueue, now: float) -> None:
        self.route_interactive(cluster, queue, now, use_memo=False)
        if not queue.n_batch or self.brownout_active:
            return
        for model in queue.batch_models():
            pools = [cluster.by_model(model, InstanceType.BATCH)]
            if self.serves_batch_on_mixed:
                pools.append(cluster.by_model(model, InstanceType.MIXED))
            for pool in pools:
                self.backfill(pool, queue, now)

    def route_interactive(self, cluster: SimCluster, queue: GlobalQueue,
                          now: float, use_memo: bool = True) -> None:
        if not queue.n_interactive:     # hot path: most events route nothing
            return
        # ---- interactive: zero-queuing, one pass per model lane
        for model in queue.interactive_models():
            self._route_interactive_model(cluster, queue, model, now,
                                          use_memo)

    def _route_interactive_model(self, cluster: SimCluster,
                                 queue: GlobalQueue, model: str,
                                 now: float, use_memo: bool = True) -> None:
        if not isinstance(cluster, SimCluster):
            # duck-typed cluster (RealCluster): the generic can_admit
            # path — no memo, no coefficient-cached scan
            req = queue.peek_interactive(model)
            while req is not None:
                inst = self._find_slot_generic(cluster, queue, model,
                                               req, now)
                if inst is None:
                    break
                inst.admit(queue.pop_interactive(model), now)
                req = queue.peek_interactive(model)
            return
        # saturation memo: when this lane's head couldn't be placed, the
        # outcome can only change once capacity moves — an instance frees a
        # slot / activates / is provisioned (all bump ``route_version``) or
        # the head itself changes (a front requeue). Until then the failed
        # scan would just repeat, so skip it. A memo is
        # ``(version, batch, head)`` and matches when the head is the same
        # request and either the version or the event batch is unchanged
        # (the batch arm covers verdicts whose own eviction pass mutated
        # state — valid for the rest of that batch, stale after it). Full
        # control-tick passes (``use_memo=False``) always rescan: local
        # autoscalers may have raised batch ceilings without touching the
        # version.
        try:
            blocked = self._route_blocked
        except AttributeError:
            blocked = self._route_blocked = {}
        req = queue.peek_interactive(model)
        if use_memo:
            memo = blocked.get(model)
            if memo is not None and memo[2] is req \
                    and (memo[0] == cluster.route_version
                         or memo[1] == cluster.batch_seq):
                return
        while req is not None:
            # version *before* the attempt: a failed eviction pass can
            # itself free capacity (its settle-advance pops finishes and
            # bumps the version), and the memo must not mask that
            v0 = cluster.route_version
            inst = self._find_slot(cluster, queue, model, req, now)
            if inst is None:
                # lane saturated; record (pre-attempt version, head) so
                # the next no-capacity-change event skips the scan
                blocked[model] = (v0, -1, req)
                break
            inst.admit(queue.pop_interactive(model), now)
            req = queue.peek_interactive(model)

    def _find_slot(self, cluster: SimCluster, queue: GlobalQueue,
                   model: str, req: Request,
                   now: float) -> Optional[SimInstance]:
        """Find (or make, by evicting batch work) a slot for one
        interactive request: interactive pool, then mixed pool, then
        batch preemption on a same-model mixed instance. The eviction
        branch mutates (victim requeued); the caller admits into the
        returned instance immediately."""
        inter, mixed = cluster.pool_pair(model)
        if inter:
            inst, _ = _scan_admit(inter, req)
            if inst is not None:
                return inst
        if mixed:
            inst, _ = _scan_admit(mixed, req)
            if inst is not None:
                return inst
            # preempt a batch request on a same-model mixed instance (the
            # O(1) batch-count guard keeps a saturated all-interactive
            # cluster from rescanning every batch)
            for inst in mixed:
                if not inst.active or len(inst.running) \
                        - inst._n_interactive == 0:
                    continue
                victim = inst.evict_one_batch(now)
                if victim is not None:
                    queue.requeue(victim)
                    return inst
        return None

    def _find_slot_generic(self, cluster, queue: GlobalQueue, model: str,
                           req: Request, now: float):
        """`_find_slot` for duck-typed clusters/instances (the real
        engine): the original `can_admit`/`_best_fit` pass."""
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

    def route_arrival(self, cluster: SimCluster, queue: GlobalQueue,
                      req: Request, now: float) -> bool:
        """Zero-queuing fast path for a single just-arrived interactive
        request whose lane is empty (the event core calls this before
        enqueueing, when no other event shares the timestamp): place it
        directly — skipping the queue round-trip the full pass would
        immediately undo — or return False for a normal enqueue, leaving
        the saturation memo set exactly as a failed lane pass would."""
        if req.request_type != RequestType.INTERACTIVE:
            return False
        v0 = cluster.route_version
        inst = self._find_slot(cluster, queue, req.model, req, now)
        if inst is None:
            try:
                blocked = self._route_blocked
            except AttributeError:
                blocked = self._route_blocked = {}
            if cluster.route_version == v0:
                # clean verdict: valid until capacity moves
                blocked[req.model] = (v0, -1, req)
            else:
                # the attempt itself mutated state (eviction settle) so
                # the verdict only holds for the rest of this event batch
                # — exactly the once-per-batch attempt the full pass makes
                blocked[req.model] = (-1, cluster.batch_seq, req)
            return False
        inst.admit(req, now)
        return True

    def route_arrival_burst(self, cluster: SimCluster, queue: GlobalQueue,
                            reqs: List[Request], now: float,
                            observe=None) -> None:
        """Cohort fast path: route a whole same-timestamp arrival burst
        in one call — decision-identical to the per-request
        ``observe_arrival`` + ``route_arrival``-or-push loop, with the
        per-request overhead hoisted (one ``pool_pair`` lookup per
        model run instead of per request, the memo dict resolved once).
        Interactive requests place zero-queuing while their lanes stay
        empty; everything else (and every request after the first
        placement failure backs the lane up) enqueues normally.

        The *positive-scan memo* removes the pool scan from the
        steady-state path entirely. After an admit we remember
        ``(route_version, winner, rej_slack)`` per model. On the next
        same-model arrival, if the version is unchanged (every
        routing-relevant mutation bumps it — admits, frees, provisioning,
        activation, eviction, health flips, local ceiling moves) then the
        only instance whose scan inputs moved is the winner itself, whose
        utilization strictly *rose* — so it is still the first strict
        maximum and a fresh scan would pick it again, provided (a) it
        still passes the admission checks (revalidated here against the
        exact scan predicate) and (b) the new prompt cannot un-reject an
        instance the original scan rejected. Capacity/active rejections
        are request-independent; only the KV-wall test depends on
        ``prompt_len``, and ``prompt_len > rej_slack`` keeps every
        wall-rejected instance rejected. Any check failing falls back to
        the full scan, so decisions are bit-identical either way.

        One subtlety: an admit is only a *pure insert* when its embedded
        settle-advance popped no finishes — a settle pop drops the
        winner's utilization, so it may no longer be the maximum even
        though only its own state moved. The memo is therefore stored
        only when ``len(running)`` grew by exactly one (the admit's net
        effect was the insert); otherwise the next arrival rescans."""
        try:
            blocked = self._route_blocked
        except AttributeError:
            blocked = self._route_blocked = {}
        try:
            pick = self._route_pick
        except AttributeError:
            pick = self._route_pick = {}
        pool_pair = cluster.pool_pair
        push = queue.push
        scan = _scan_admit
        it = RequestType.INTERACTIVE
        inf = _SCAN_INF
        last_model = None
        inter = mixed = None
        for req in reqs:
            if observe is not None:
                observe(req, now)
            if req.request_type != it or queue._icount:
                push(req)
                continue
            model = req.model
            v0 = cluster.route_version
            pk = pick.get(model)
            if pk is not None and pk[0] == v0 and req.prompt_len > pk[2]:
                cand = pk[1]
                if cand.active:
                    loc = cand.local
                    if len(cand.running) < (
                            loc.max_batch_size if loc is not None
                            else (cand.static_batch or 64)):
                        wall = cand._c_wall
                        if wall != inf:
                            if cand.event_mode:
                                kv = cand._kv_prefill + cand._kv_dec_base \
                                    + cand._n_dec * cand.vclock
                            else:
                                kv = cand._kv_tokens
                            ok = kv + req.prompt_len <= wall
                        else:
                            ok = True
                        if ok:
                            n0 = len(cand.running)
                            cand.admit(req, now)
                            if len(cand.running) == n0 + 1:
                                pick[model] = (cluster.route_version,
                                               cand, pk[2])
                            continue
            # pools resolved only on memo miss — a hit never touches them
            if model != last_model:
                inter, mixed = pool_pair(model)
                last_model = model
            rej = -1.0
            inst = None
            if inter:
                inst, rej = scan(inter, req)
            if inst is None and mixed:
                inst, r2 = scan(mixed, req)
                if r2 > rej:
                    rej = r2
                if inst is None:
                    # preempt batch work on a same-model mixed instance
                    # (same order and guards as _find_slot)
                    for cand in mixed:
                        if not cand.active or len(cand.running) \
                                - cand._n_interactive == 0:
                            continue
                        victim = cand.evict_one_batch(now)
                        if victim is not None:
                            queue.requeue(victim)
                            inst = cand
                            break
            if inst is None:
                # saturated: leave the memo exactly as route_arrival would
                if cluster.route_version == v0:
                    blocked[model] = (v0, -1, req)
                else:
                    blocked[model] = (-1, cluster.batch_seq, req)
                push(req)
            else:
                n0 = len(inst.running)
                inst.admit(req, now)
                if len(inst.running) == n0 + 1:
                    pick[model] = (cluster.route_version, inst, rej)

    def backfill(self, insts, queue: GlobalQueue, now: float) -> None:
        """Fill spare capacity on ``insts`` from their models' batch lanes.
        The queue pops in service order (resume lane, then earliest
        deadline / FCFS) at O(log n) per admission — no per-pass sort."""
        if self.brownout_active:
            return                   # brownout: batch strictly deferred
        for inst in insts:
            if inst.itype == InstanceType.INTERACTIVE:
                continue             # interactive pool never serves batch
            if inst.health_ewma > SLOW_SUSPECT_RATIO:
                continue             # route around degraded nodes; the
                                     # batch scaler re-adds the capacity
            model = inst.model
            if not isinstance(inst, SimInstance):
                # duck-typed instance (real engine): generic can_admit
                while inst.active and inst.n_running < inst.max_batch_size \
                        and queue.n_batch_for(model):
                    req = queue.peek_batch(model)
                    if not inst.can_admit(req):
                        break
                    inst.admit(queue.pop_batch_fcfs(model), now)
                continue
            wall = inst._c_wall
            # cheap slot-full rejection before touching the queue
            while inst.active and queue.n_batch_for(model):
                n = len(inst.running)
                loc = inst.local
                mb = loc.max_batch_size if loc is not None \
                    else (inst.static_batch or 64)
                if n >= mb:
                    break
                if wall != float("inf"):
                    req = queue.peek_batch(model)
                    kv = inst._kv_prefill + inst._kv_dec_base \
                        + inst._n_dec * inst.vclock if inst.event_mode \
                        else inst._kv_tokens
                    if kv + req.prompt_len > wall:
                        break
                inst.admit(queue.pop_batch_fcfs(model), now)

    def brownout_preempt_batch(self, cluster: SimCluster,
                               queue: GlobalQueue, now: float) -> int:
        """Brownout's aggressive arm: evict every batch request running
        on a mixed instance back to the queue (host-saved KV lands in
        the resume lanes, so nothing is lost) so the whole mixed pool
        serves the interactive backlog. Returns the eviction count."""
        n = 0
        for inst in (cluster._active.values()
                     if isinstance(cluster, SimCluster)
                     else cluster.active_instances()):
            if inst.itype != InstanceType.MIXED:
                continue
            while inst.n_running_batch() > 0:
                victim = inst.evict_one_batch(now)
                if victim is None:
                    break
                queue.requeue(victim)
                n += 1
        return n

    def control(self, cluster: SimCluster, queue: GlobalQueue,
                now: float) -> None:
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
    local_enabled: bool = True          # False -> "Global" ablation arm
    global_enabled: bool = True         # False -> "Local" ablation arm
    static_batch: int = 64              # used when local_enabled=False
    estimator: WaitingTimeEstimator = field(default_factory=WaitingTimeEstimator)
    min_instances: int = 1
    init_batch: int = 8
    max_batch: int = 4096
    group_k: int = 0                    # -1 disables request groups (Fig. 6)
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
    # bounds memory on million-request replays
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
        # model keeps the `estimator` field itself (legacy single-model
        # behaviour is bit-identical).
        self.estimators: Dict[str, WaitingTimeEstimator] = {
            self.model: self.estimator}
        self._out_models: Dict[str, object] = {}
        self._next_theta_update: Dict[str, float] = {}
        for m in self.model_list:
            self._register_model(m)

    # ------------------------------------------------------------ helpers
    @property
    def interactive_scaler(self) -> InteractiveAutoscaler:
        """Legacy single-model accessor (the primary model)."""
        return self.interactive_scalers[self.model]

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

    def _ensure_model(self, model: str) -> None:
        if model not in self.interactive_scalers:
            self.model_list.append(model)
            self._register_model(model)

    def set_model_placed(self, model: str, placed: bool) -> None:
        """Placement pin from a fleet-level placer: a placed model keeps
        the configured instance floor (a warm foothold); unplacing drops
        the floor to zero so the model's local fleet drains away."""
        self._ensure_model(model)
        if placed:
            self._configured.add(model)
        else:
            self._configured.discard(model)
        self.interactive_scalers[model].min_instances = \
            self.min_instances if placed else 0

    def _mk_local(self, slo: float) -> Optional[LocalAutoscaler]:
        if not self.local_enabled:
            return None
        return LocalAutoscaler(itl_slo=slo, init_batch=self.init_batch,
                               max_batch=self.max_batch)

    def _provision(self, cluster: SimCluster, itype: InstanceType,
                   now: float, model: Optional[str] = None) -> Optional[SimInstance]:
        slo = self.itl_slo_batch if itype == InstanceType.BATCH \
            else self.itl_slo_interactive
        return cluster.provision(
            model or self.model, itype, now,
            local_autoscaler=self._mk_local(slo),
            static_batch=None if self.local_enabled else self.static_batch)

    def batch_instance_throughput(self, cluster: SimCluster,
                                  model: Optional[str] = None) -> float:
        perf = cluster.perf_factory(model or self.model)
        b = perf.optimal_batch(self.itl_slo_batch, mean_ctx=512.0)
        return perf.throughput(b, mean_ctx=512.0)

    # ------------------------------------------------------------ control
    def observe_arrival(self, req: Request, now: float) -> None:
        m = req.model
        if m not in self.interactive_scalers:   # inline _ensure_model
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

    def control(self, cluster: SimCluster, queue: GlobalQueue,
                now: float) -> None:
        # 0. bootstrap + optional Theta re-estimation from arrival history.
        # Configured models always keep a foothold; models discovered from
        # the arrival stream are provisioned on demand only — a replayed
        # trace with many transient deployments must not pin a chip per
        # deployment forever.
        self._refresh_theta(now)
        sim = isinstance(cluster, SimCluster)
        for m in self.model_list:
            if cluster.n_instances_of(m) if sim else cluster.instances_of(m):
                continue
            if m in self._configured or queue.n_interactive_for(m) \
                    or queue.n_batch_for(m):
                self._provision(cluster, InstanceType.MIXED, now, m)

        # 1. local autoscaling + health tracking on every instance (the
        # health EWMA is the slow-node detection signal routing reads;
        # updates are per-instance independent, so the active registry's
        # order is as good as the instance list's and costs no scan)
        local_enabled = self.local_enabled
        for inst in (cluster._active.values() if sim
                     else cluster.active_instances()):
            inst.update_health()
            if local_enabled:
                inst.update_local_autoscaler()

        # 2./3. one global loop per model, all sharing the chip budget.
        # Drained models (no instances, no queued work — only possible for
        # discovered ones after the bootstrap above) cost two O(1) checks,
        # so per-tick work tracks the active fleet, not every model ever
        # seen in a long replay.
        if self.global_enabled:
            for m in self.model_list:
                if not (cluster.n_instances_of(m) if sim
                        else cluster.instances_of(m)) \
                        and not queue.n_interactive_for(m) \
                        and not queue.n_batch_for(m):
                    continue
                self._control_model(cluster, queue, m, now)

    def _control_model(self, cluster: SimCluster, queue: GlobalQueue,
                       model: str, now: float) -> None:
        # 2. interactive/mixed scaling on this model's IBP
        inter = cluster.by_model(model, InstanceType.INTERACTIVE)
        mixed = cluster.by_model(model, InstanceType.MIXED)
        n_running = sum(1 for i in inter + mixed if i.runs_interactive())
        iscaler = self.interactive_scalers[model]
        dec = iscaler.update(n_running, len(inter), len(mixed))
        obs = self.obs
        if dec.delta_instances > 0:
            if obs is not None:     # Algorithm 1: IBP above the band
                obs.set_context(_R_IBP_HIGH, dec.ibp,
                                iscaler.theta + iscaler.delta)
            for _ in range(dec.delta_instances):
                if self._provision(cluster, InstanceType.MIXED, now,
                                   model) is None:
                    break               # shared chip budget exhausted
        elif dec.delta_instances < 0:
            if obs is not None:     # Algorithm 1: IBP below the band
                obs.set_context(_R_IBP_LOW, dec.ibp,
                                iscaler.theta - iscaler.delta)
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
                group_k=self.group_k, model=model)
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
            if obs is not None:     # Algorithm 2: no batch work left
                obs.set_context(_R_BBP_IDLE, float(dec2.bbp_before), 0.0)
            for inst in list(cluster.by_model(model, InstanceType.BATCH)):
                for r in cluster.retire(inst):
                    queue.requeue(r)
        elif dec2.remove_instances > 0:
            # Algorithm 2 minimality: surrender excess batch instances
            # while BBP stays 0 — idle/least-loaded (and still-loading)
            # instances first, displaced requests re-enter the queue
            if obs is not None:
                obs.set_context(_R_BBP_TRIM, float(dec2.bbp_before), 0.0)
            victims = sorted(cluster.by_model(model, InstanceType.BATCH),
                             key=lambda i: (i.active, i.n_running))
            for inst in victims[:dec2.remove_instances]:
                for r in cluster.retire(inst):
                    queue.requeue(r)
        else:
            if obs is not None and dec2.add_instances:
                # Algorithm 2: BBP > 0, add until it clears
                obs.set_context(_R_BBP_ADD, float(dec2.bbp_before), 0.0)
            for _ in range(dec2.add_instances):
                if self._provision(cluster, InstanceType.BATCH, now,
                                   model) is None:
                    break               # shared chip budget exhausted
        if obs is not None:
            obs.record_signals(
                now, cluster, model,
                dec.ibp, iscaler.theta,
                dec2.bbp_before, scaler.last_wait,
                queue.n_interactive_for(model),
                queue.n_batch_for(model),
                len(inter), len(mixed),
                len(cluster.by_model(model, InstanceType.BATCH)))

    def observe_completion(self, req: Request) -> None:
        # per-model output-length fit: each model's QLM estimator only
        # sees its own completions (output models cached flat — this runs
        # once per finished request, so ``OutputLengthModel.observe`` is
        # inlined: same moment-sum arithmetic, one call fewer)
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
    def control(self, cluster: SimCluster, queue: GlobalQueue,
                now: float) -> None:
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
