"""Request groups (SHEPHERD-style, via 1-D k-means on TTFT deadlines).

Queued batch requests with similar TTFT-SLO deadlines are clustered and
scheduled as a unit (FCFS within a group), which minimizes autoscaling
hysteresis (paper §2.3, Fig. 6: 20x fewer scaling actions, 2.5x throughput).

Two grouping paths:

- ``make_request_groups``: one-shot clustering of a queue snapshot
  (benchmarks, tests, the real-cluster control loop).
- ``IncrementalGrouper``: maintained online over the queue's add/remove
  stream so the control loop never re-clusters the whole queue each tick;
  greedy nearest-centroid assignment with a periodic k-means rebuild to
  bound drift.
"""
from __future__ import annotations

import heapq
import itertools
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

from repro_torch.serving.request import Request


@dataclass
class RequestGroup:
    requests: List[Request] = field(default_factory=list)
    centroid_deadline: float = 0.0

    @property
    def deadline(self) -> float:
        """Earliest TTFT-SLO deadline in the group (conservative)."""
        return min(r.deadline for r in self.requests)

    @property
    def n(self) -> int:
        return len(self.requests)

    def total_expected_tokens(self, mean_output: float) -> float:
        return self.n * mean_output

    def sorted_fcfs(self) -> List[Request]:
        return sorted(self.requests, key=lambda r: r.arrival_time)


@dataclass
class GroupStat:
    """Lightweight (deadline, size) view of a group — all the batch
    autoscaler's BBP computation needs (Eq. 2 reads nothing else)."""
    deadline: float
    n: int


def kmeans_1d(values: Sequence[float], k: int, iters: int = 25) -> List[int]:
    """MacQueen-style 1-D k-means; returns a cluster id per value."""
    n = len(values)
    if n == 0:
        return []
    k = max(1, min(k, n))
    vs = sorted(values)
    # init centroids at quantiles
    cents = [vs[int(i * (n - 1) / max(k - 1, 1))] for i in range(k)]
    assign = [0] * n
    for _ in range(iters):
        changed = False
        for i, v in enumerate(values):
            j = min(range(k), key=lambda c: abs(v - cents[c]))
            if assign[i] != j:
                assign[i] = j
                changed = True
        for j in range(k):
            members = [values[i] for i in range(n) if assign[i] == j]
            if members:
                cents[j] = sum(members) / len(members)
        if not changed:
            break
    return assign


def auto_k(deadlines: Sequence[float], deadline_tolerance: float,
           max_groups: int = 8) -> int:
    """One group per ``deadline_tolerance`` seconds of spread (min 1)."""
    spread = max(deadlines) - min(deadlines)
    return int(min(max_groups, max(1, round(spread / deadline_tolerance))))


def cluster_deadlines(deadlines: Sequence[float], k: int) -> List[int]:
    """Cluster deadline values into ≤k groups; subsamples large inputs."""
    if len(deadlines) > 3000:
        # cluster a stride sample, then one nearest-centroid pass for all
        stride = len(deadlines) // 1000
        sample = deadlines[::stride]
        sample_assign = kmeans_1d(sample, k)
        kk = max(sample_assign) + 1
        cents = [0.0] * kk
        counts = [0] * kk
        for v, a in zip(sample, sample_assign):
            cents[a] += v
            counts[a] += 1
        cents = [c / max(n, 1) for c, n in zip(cents, counts)]
        return [min(range(kk), key=lambda j: abs(v - cents[j]))
                for v in deadlines]
    return kmeans_1d(deadlines, k)


def make_request_groups(requests: Sequence[Request], k: int = 0,
                        deadline_tolerance: float = 300.0) -> List[RequestGroup]:
    """Cluster queued requests by TTFT deadline.

    k=0  -> choose k from the deadline spread (``auto_k``).
    k>0  -> at most min(k, n) clusters; requests with identical or nearby
            deadlines still collapse into one group, so a short queue never
            degenerates into one-group-per-request (which would inflate BBP
            and scaling actions).
    k=-1 -> the explicit grouping-disabled ablation (Fig. 6): one group per
            request. Only this sentinel selects the degenerate path.
    """
    reqs = list(requests)
    if not reqs:
        return []
    if k < 0:
        # explicit ablation: one group per request
        out = [RequestGroup([r], r.deadline) for r in reqs]
        out.sort(key=lambda g: g.deadline)
        return out
    deadlines = [r.deadline for r in reqs]
    if k == 0:
        k = auto_k(deadlines, deadline_tolerance)
    k = min(k, len(reqs))
    assign = cluster_deadlines(deadlines, k)
    groups: Dict[int, RequestGroup] = {}
    for r, a in zip(reqs, assign):
        groups.setdefault(a, RequestGroup())
        groups[a].requests.append(r)
    out = []
    for g in groups.values():
        g.centroid_deadline = sum(r.deadline for r in g.requests) / g.n
        out.append(g)
    out.sort(key=lambda g: g.deadline)
    return out


class _IncGroup:
    """One maintained cluster: size/centroid aggregates plus a lazy-deleted
    min-heap over member deadlines for the conservative group deadline."""

    __slots__ = ("gid", "n", "sum_deadline", "_heap")

    def __init__(self, gid: int):
        self.gid = gid
        self.n = 0
        self.sum_deadline = 0.0
        self._heap: List[tuple] = []        # (deadline, req_id)

    @property
    def centroid(self) -> float:
        return self.sum_deadline / self.n if self.n else 0.0

    def add(self, req_id: int, deadline: float) -> None:
        self.n += 1
        self.sum_deadline += deadline
        heapq.heappush(self._heap, (deadline, req_id))

    def remove(self, deadline: float) -> None:
        self.n -= 1
        self.sum_deadline -= deadline

    def min_deadline(self, member_of: Dict[int, int]) -> float:
        while self._heap and member_of.get(self._heap[0][1]) != self.gid:
            heapq.heappop(self._heap)       # stale (departed) member
        return self._heap[0][0] if self._heap else self.centroid


class IncrementalGrouper:
    """Deadline clusters maintained over a queue's add/remove stream.

    Implements the ``GlobalQueue`` batch-listener protocol (``on_add`` /
    ``on_remove``). New requests are greedily assigned to the nearest
    centroid (a new group opens when none lies within
    ``deadline_tolerance`` and fewer than ``max_groups`` exist); a full
    k-means rebuild runs only after the membership has churned by
    ``rebuild_factor`` of its size, bounding drift at O(changes) amortized
    cost instead of a from-scratch re-cluster every control tick.
    """

    def __init__(self, k: int = 0, deadline_tolerance: float = 300.0,
                 max_groups: int = 8, rebuild_factor: float = 1.0,
                 min_rebuild_changes: int = 256):
        self.k = k
        self.deadline_tolerance = deadline_tolerance
        # a positive k bounds the greedy path too, not just rebuilds —
        # otherwise a k-configured run tracks up to max_groups clusters
        # until the first rebuild, diverging from the one-shot semantics
        self.max_groups = k if k > 0 else max_groups
        self.rebuild_factor = rebuild_factor
        self.min_rebuild_changes = min_rebuild_changes
        self._gid = itertools.count()
        self._groups: Dict[int, _IncGroup] = {}
        self._member_of: Dict[int, int] = {}    # req_id -> gid
        self._deadline: Dict[int, float] = {}   # req_id -> deadline
        self._changes = 0
        self.rebuilds = 0

    # ------------------------------------------------------- listener API
    def on_add(self, req: Request) -> None:
        d = req.deadline
        gid = self._nearest(d)
        if gid is None:
            gid = next(self._gid)
            self._groups[gid] = _IncGroup(gid)
        self._groups[gid].add(req.req_id, d)
        self._member_of[req.req_id] = gid
        self._deadline[req.req_id] = d
        self._bump()

    def on_remove(self, req: Request) -> None:
        gid = self._member_of.pop(req.req_id, None)
        if gid is None:
            return
        d = self._deadline.pop(req.req_id)
        g = self._groups[gid]
        g.remove(d)
        if g.n <= 0:
            del self._groups[gid]
        self._bump()

    # ------------------------------------------------------------ queries
    @property
    def n_members(self) -> int:
        return len(self._member_of)

    def group_stats(self) -> List[GroupStat]:
        """Current groups as (deadline, n), earliest deadline first."""
        self._maybe_rebuild()
        stats = [GroupStat(g.min_deadline(self._member_of), g.n)
                 for g in self._groups.values() if g.n > 0]
        stats.sort(key=lambda s: s.deadline)
        return stats

    # ------------------------------------------------------------ internal
    def _nearest(self, deadline: float) -> Optional[int]:
        best, best_dist = None, float("inf")
        for gid, g in self._groups.items():
            dist = abs(deadline - g.centroid)
            if dist < best_dist:
                best, best_dist = gid, dist
        if best is None:
            return None
        if best_dist > self.deadline_tolerance and \
                len(self._groups) < self.max_groups:
            return None                      # open a new group
        return best

    def _bump(self) -> None:
        self._changes += 1

    def _maybe_rebuild(self) -> None:
        threshold = max(self.min_rebuild_changes,
                        int(self.rebuild_factor * len(self._member_of)))
        if self._changes < threshold or not self._member_of:
            return
        self._changes = 0
        self.rebuilds += 1
        ids = list(self._member_of)
        deadlines = [self._deadline[i] for i in ids]
        k = self.k if self.k > 0 else auto_k(deadlines,
                                             self.deadline_tolerance,
                                             self.max_groups)
        k = min(k, len(ids))
        assign = cluster_deadlines(deadlines, k)
        self._groups.clear()
        remap: Dict[int, int] = {}
        for rid, d, a in zip(ids, deadlines, assign):
            gid = remap.get(a)
            if gid is None:
                gid = next(self._gid)
                remap[a] = gid
                self._groups[gid] = _IncGroup(gid)
            self._groups[gid].add(rid, d)
            self._member_of[rid] = gid
