"""Global autoscaler — interactive (IBP / Theta) + batch (Algorithm 2).

Interactive autoscaling (§5.2): keep the over-provisioning ratio
IBP = running_interactive / (interactive + mixed) inside [Theta-delta,
Theta+delta]; Theta comes from historical arrival spikes (tail spike 3x ->
Theta = 1/3).

Batch instance autoscaling (§5.3, Algorithm 2): group queued batch requests
by TTFT deadline, estimate each group's waiting time via QLM, add the
MINIMUM number of batch instances that makes BBP (groups past deadline)
zero; retire all batch instances when no batch work remains.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import List, Optional, Sequence

from repro_torch.core.request_groups import (GroupStat, IncrementalGrouper,
                                             RequestGroup, make_request_groups)
from repro_torch.core.waiting_time import WaitingTimeEstimator
from repro_torch.serving.request import Request


@dataclass
class InteractiveScalingDecision:
    delta_instances: int            # +n add (interactive+mixed), -n remove
    ibp: float


@dataclass
class InteractiveAutoscaler:
    theta: float = 1.0 / 3.0        # target over-provisioning level
    delta: float = 0.1              # hysteresis band (footnote 2)
    min_instances: int = 1

    def update(self, n_running_interactive: int, n_interactive: int,
               n_mixed: int) -> InteractiveScalingDecision:
        total = n_interactive + n_mixed
        ibp = (n_running_interactive / total) if total else 1.0
        if ibp > self.theta + self.delta:
            # instances needed so that running/total == theta
            needed = math.ceil(n_running_interactive / max(self.theta, 1e-9))
            return InteractiveScalingDecision(max(needed - total, 1), ibp)
        if ibp < self.theta - self.delta and total > self.min_instances:
            target = math.ceil(max(n_running_interactive, 1) /
                               max(self.theta, 1e-9))
            remove = min(total - max(target, self.min_instances),
                         total - self.min_instances)
            return InteractiveScalingDecision(-max(remove, 0), ibp)
        return InteractiveScalingDecision(0, ibp)


@dataclass
class BatchScalingDecision:
    add_instances: int
    retire_all: bool
    bbp_before: int
    groups: List[RequestGroup] = field(default_factory=list)
    remove_instances: int = 0           # excess instances while BBP stays 0


@dataclass
class BatchAutoscaler:
    estimator: WaitingTimeEstimator
    instance_token_throughput: float    # Theta per batch instance (tokens/s)
    max_add_per_cycle: int = 64
    group_k: int = 0                    # 0 = auto; -1 = groups disabled
                                        # (one group per request — the
                                        # hysteresis ablation of Fig. 6)
    # multi-model fleets run one BatchAutoscaler per model; when set, only
    # that model's queue lane is grouped/observed (None = whole queue)
    model: Optional[str] = None
    # Scale-down damping: an instance is only surrendered if BBP stays 0
    # with the remaining capacity derated by this factor, so a boundary
    # estimate cannot oscillate add/remove every control tick; at most one
    # instance goes per cycle, bounding the in-flight work a removal can
    # displace back into the queue.
    scale_down_derate: float = 0.8
    max_remove_per_cycle: int = 1
    # QLM waiting-time estimate for the full backlog at the last
    # ``compute_bbp`` call (NaN before any call / with no groups) — the
    # flight recorder exports it as the per-tick ``wait_est`` signal
    last_wait: float = float("nan")
    _grouper: Optional[IncrementalGrouper] = field(default=None, repr=False)
    _grouper_src: Optional[object] = field(default=None, repr=False)

    def compute_bbp(self, groups: Sequence[RequestGroup], now: float,
                    total_throughput: float) -> int:
        """BBP (Eq. 2): groups whose estimated wait blows the TTFT deadline.

        Requests ahead of group g = all requests in groups with earlier
        deadlines plus g itself (FCFS across group order).
        """
        bbp = 0
        ahead = 0
        w = float("nan")
        for g in groups:
            ahead += g.n
            w = self.estimator.waiting_time(ahead, total_throughput, 1)
            if now + w > g.deadline:
                bbp += 1
        self.last_wait = w
        return bbp

    def _iter_batch(self, queue):
        """Model-filtered batch iteration, tolerating single-model queues
        whose ``iter_batch`` takes no model argument."""
        try:
            return queue.iter_batch(self.model)
        except TypeError:
            return queue.iter_batch()

    def _groups_for(self, queued_batch) -> List[RequestGroup]:
        """Request groups for either a queue snapshot (one-shot k-means) or
        a ``GlobalQueue`` (incrementally maintained via its listener API,
        filtered to ``self.model`` when set)."""
        if callable(getattr(queued_batch, "attach_batch_listener", None)):
            if self.group_k < 0:
                # grouping-disabled ablation: one group per request
                return [GroupStat(r.deadline, 1) for r in
                        sorted(self._iter_batch(queued_batch),
                               key=lambda r: r.deadline)]
            if self._grouper is None or self._grouper_src is not queued_batch:
                self._grouper = IncrementalGrouper(k=self.group_k)
                self._grouper_src = queued_batch
                try:
                    queued_batch.attach_batch_listener(self._grouper,
                                                       model=self.model)
                except TypeError:   # legacy listener API: no model filter
                    queued_batch.attach_batch_listener(self._grouper)
            return self._grouper.group_stats()
        if hasattr(queued_batch, "iter_batch"):
            # queue-like without the listener API: re-cluster a snapshot
            # every tick (the pre-incremental behaviour)
            queued_batch = list(self._iter_batch(queued_batch))
        k = -1 if self.group_k < 0 else self.group_k
        return make_request_groups(queued_batch, k=k)

    def update(self, queued_batch, now: float, *,
               n_batch_instances: int, spare_mixed_throughput: float = 0.0,
               n_active_batch_requests: int = 0) -> BatchScalingDecision:
        """Algorithm 2 over ``queued_batch`` — a Sequence[Request] snapshot
        or a ``GlobalQueue`` (preferred in the control loop: groups are then
        maintained incrementally instead of re-clustered every tick)."""
        groups = self._groups_for(queued_batch)
        if not groups:
            self.last_wait = float("nan")
            retire = (n_active_batch_requests == 0 and n_batch_instances > 0)
            return BatchScalingDecision(0, retire, 0, [])

        def throughput_with(extra: int) -> float:
            return (n_batch_instances + extra) * self.instance_token_throughput \
                + spare_mixed_throughput

        bbp0 = self.compute_bbp(groups, now, max(throughput_with(0), 1e-9))
        dispatch = 0
        bbp = bbp0
        # Algorithm 2: keep adding instances until backpressure is 0
        while bbp > 0 and dispatch < self.max_add_per_cycle:
            dispatch += 1
            bbp = self.compute_bbp(groups, now, throughput_with(dispatch))

        # Minimality (Algorithm 2's claim): with BBP already 0 and no adds,
        # surrender instances that remain unnecessary even after derating
        # the surviving capacity — otherwise excess batch instances linger
        # at BBP = 0 while groups trickle in.
        remove = 0
        if dispatch == 0 and bbp0 == 0 and n_batch_instances > 0:
            limit = min(n_batch_instances, self.max_remove_per_cycle)
            while remove < limit and self.compute_bbp(
                    groups, now,
                    max(self.scale_down_derate * throughput_with(-(remove + 1)),
                        1e-9)) == 0:
                remove += 1
        return BatchScalingDecision(dispatch, False, bbp0, groups,
                                    remove_instances=remove)
