"""Global queue (paper §3, Lifecycle of a Request) — multi-model aware,
columnar.

All requests enqueue here; interactive requests follow a zero-queuing
discipline (dispatched immediately, footnote 3) while batch requests may
wait and are scheduled as request groups by the global autoscaler.

Every lane is keyed by the request's ``model``: a fleet serving N models
holds N interactive FIFO lanes and N batch lane sets behind one facade,
and routing asks for work *for a specific model* so a request can never
be handed to an instance that doesn't serve it. All single-model entry
points (``pop_interactive()``, ``peek_batch()``, ...) keep their
historical semantics by taking the globally-next request across lanes.

Struct-of-arrays layout (:class:`GlobalQueue`, the default): every lane
is a :class:`_Lane` — preallocated, amortized-doubling NumPy key columns
(``seq``, ``arrival``, ``deadline``, ``row``) plus the ``req_objs``
payload list, with O(1) head/tail cursors. The per-lane **min cursor is
the head**: batch arrivals enter in nondecreasing arrival order and a
lane holds one TTFT-SLO class, so ``(deadline, arrival, seq)`` is
nondecreasing along the lane and the earliest entry is always
``columns[head]`` — no heap sift per push/pop. The rare out-of-order
entry (a requeue of an old arrival, fleet hand-back) falls into a
per-model overflow heap merged at peek time. Snapshots and drains are
vectorized (``np.lexsort`` over the concatenated key columns) instead of
sorting Python tuples. ``Request`` objects ride along as the payload —
they are only *touched* again at the admit edge (the scheduler-batch
idiom of keeping scheduling state columnar and crossing into object land
at the boundary).

:class:`ReferenceGlobalQueue` keeps the pre-columnar object flavour —
per-model deques and ``(deadline, arrival, seq, Request)`` binary heaps —
as the decision-equivalence baseline (the engines' ``reference=True``
mode); both flavours produce bit-identical pop orders.

The mirror registry ``QUEUE_MIRRORS`` maps each mirrored ``Request``
attribute to its lane column; the static auditor
(``repro_torch.analysis``, rule MIR103) checks that every payload write also
writes the key columns, and the runtime shadow verifier rebuilds the
columns from the payload objects and asserts exact agreement.

Preempted batch requests that still hold host-saved KV are parked in a
per-model resume lane served before fresh work, so a restart never
re-queues behind requests that have not prefill'd yet.

Listeners (``attach_batch_listener``) observe every batch add/remove —
optionally filtered to one model — and let each model's global
autoscaler maintain request groups incrementally instead of
re-clustering the whole queue each control tick. Attach replays the
current contents in *service order* (resume lanes, then earliest
deadline first) so the replay stream is a property of the queue's
contents, not of either flavour's internal layout.

The port's copy of the reference's ``serving/global_queue.py``, whole: the
same lanes, keys and pop order, so the port's simulator and its real
cluster (``serving/real_cluster.py``) decide as the reference's do.
"""
from __future__ import annotations

import heapq
import itertools
from collections import deque
from typing import Deque, Dict, Iterator, List, Optional, Tuple

import numpy as np

from repro_torch.serving.request import Request, RequestType

# Mirror registry: ``Request`` attribute -> lane key column holding the
# same value for every queued entry (``lane.<col>[i]`` mirrors
# ``lane.req_objs[i].<attr>``). The static auditor (rule MIR103) checks
# every payload write pairs with the key-column writes, and the runtime
# shadow verifier rebuilds the columns from the objects and asserts
# exact agreement — extend both when adding a key column.
QUEUE_MIRRORS: Dict[str, str] = {
    "arrival_time": "arrival",
    "deadline": "deadline",
    "row": "row",
}
# Every key column a payload write must refresh: the mirrored ones plus
# the queue-internal FIFO stamp (no Request twin — it exists to make the
# cross-lane pop order total).
QUEUE_KEY_COLUMNS: Tuple[str, ...] = ("seq", "arrival", "deadline", "row")

_LANE_CAP0 = 32


class _Lane:
    """One columnar lane: a FIFO over preallocated, amortized-doubling
    key columns plus the ``req_objs`` payload list.

    ``head``/``tail`` cursors bound the live window; ``head`` is the
    O(1) min cursor (see module docstring). ``push_front`` supports the
    interactive front-requeue discipline by writing at ``head - 1``
    (regrowing with front headroom when the window touches 0), so front
    entries pop most-recent-first exactly like ``deque.appendleft``.
    """

    __slots__ = ("model", "cap", "head", "tail",
                 "seq", "arrival", "deadline", "row", "req_objs")

    def __init__(self, model: str, cap: int = _LANE_CAP0):
        self.model = model
        self.cap = cap
        self.head = 0
        self.tail = 0
        self.seq = np.empty(cap, dtype=np.int64)
        self.arrival = np.empty(cap, dtype=np.float64)
        self.deadline = np.empty(cap, dtype=np.float64)
        self.row = np.empty(cap, dtype=np.int64)
        self.req_objs: List[Optional[Request]] = [None] * cap

    def __len__(self) -> int:
        return self.tail - self.head

    def _regrow(self, front_gap: int) -> None:
        """Reallocate the columns, landing the live window at offset
        ``front_gap`` (amortized doubling; also compacts a drained
        head)."""
        head, tail = self.head, self.tail
        live = tail - head
        cap = self.cap
        while cap < live + front_gap + 1:
            cap *= 2
        for name in ("seq", "arrival", "deadline", "row"):
            old = getattr(self, name)
            new = np.empty(cap, dtype=old.dtype)
            new[front_gap:front_gap + live] = old[head:tail]
            setattr(self, name, new)
        self.req_objs = [None] * front_gap + self.req_objs[head:tail] \
            + [None] * (cap - front_gap - live)
        self.cap = cap
        self.head = front_gap
        self.tail = front_gap + live

    def push(self, s: int, req: Request) -> None:
        t = self.tail
        if t == self.cap:
            self._regrow(0)
            t = self.tail
        self.seq[t] = s
        self.arrival[t] = req.arrival_time
        self.deadline[t] = req.deadline
        self.row[t] = req.row
        self.req_objs[t] = req
        self.tail = t + 1

    def push_front(self, s: int, req: Request) -> None:
        h = self.head
        if h == 0:
            self._regrow(max(4, self.cap // 4))
            h = self.head
        h -= 1
        self.seq[h] = s
        self.arrival[h] = req.arrival_time
        self.deadline[h] = req.deadline
        self.row[h] = req.row
        self.req_objs[h] = req
        self.head = h

    def popleft(self) -> Request:
        h = self.head
        req = self.req_objs[h]
        # mirror-sync: ok(clearing the freed payload cell; the key cells
        # behind the head cursor are dead)
        self.req_objs[h] = None
        h += 1
        if h == self.tail:
            self.head = self.tail = 0
        else:
            self.head = h
        return req

    def peek(self) -> Request:
        return self.req_objs[self.head]

    # ------------------------------------------------- vectorized views
    def key_slices(self):
        """Live (seq, arrival, deadline, payload) column views — the
        vectorized drain/snapshot surface."""
        h, t = self.head, self.tail
        return (self.seq[h:t], self.arrival[h:t], self.deadline[h:t],
                self.req_objs[h:t])


class GlobalQueue:
    """Columnar struct-of-arrays queue plane (see module docstring)."""

    columnar = True              # shadow verifier / introspection marker

    def __init__(self):
        # model -> interactive FIFO lane; the seq column is a global FIFO
        # stamp so cross-lane pops preserve arrival order, and
        # front-requeues take negative stamps (they must precede
        # everything already queued)
        self._ilanes: Dict[str, _Lane] = {}
        self._iseq = 0
        self._ifront = -1
        self._icount = 0
        # model -> {ttft-slo class -> lane}: one TTFT class per lane
        # keeps (deadline, arrival, seq) nondecreasing along the lane
        # (the O(1) min-cursor invariant); out-of-order entries fall
        # into the per-model overflow heap
        self._blanes: Dict[str, Dict[float, _Lane]] = {}
        self._boflow: Dict[str, List[Tuple[float, float, int, Request]]] = {}
        self._bfresh: Dict[str, int] = {}    # model -> lane+overflow count
        self._bresumes: Dict[str, _Lane] = {}   # preempted, KV on host
        self._bseq = 0
        self._bcount = 0
        self._listeners: List[Tuple[object, Optional[str]]] = []

    # ------------------------------------------------------------ intake
    def push(self, req: Request) -> None:
        if req.request_type == RequestType.INTERACTIVE:
            lane = self._ilanes.get(req.model)
            if lane is None:
                lane = self._ilanes[req.model] = _Lane(req.model)
            s = self._iseq
            self._iseq = s + 1
            lane.push(s, req)
            self._icount += 1
        else:
            self._push_batch(req)

    def _push_batch(self, req: Request) -> None:
        model = req.model
        lanes = self._blanes.get(model)
        if lanes is None:
            lanes = self._blanes[model] = {}
            self._boflow[model] = []
            self._bfresh[model] = 0
        seq = self._bseq
        self._bseq = seq + 1
        slo_class = req.slo.ttft
        lane = lanes.get(slo_class)
        if lane is None:
            lane = lanes[slo_class] = _Lane(model)
        t = lane.tail
        d = req.deadline
        if t == lane.head:
            lane.push(seq, req)
        else:
            dt = lane.deadline[t - 1]
            if d > dt or (d == dt
                          and req.arrival_time >= lane.arrival[t - 1]):
                lane.push(seq, req)      # in-order: the overwhelming case
            else:
                # an old arrival re-entering (failure displacement, fleet
                # hand-back): it must sort before the lane tail, so it
                # takes the per-model overflow heap instead
                heapq.heappush(self._boflow[model],
                               (d, req.arrival_time, seq, req))
        self._bfresh[model] += 1
        self._bcount += 1
        if self._listeners:
            self._notify_add(req)

    def requeue(self, req: Request) -> None:
        """Preempted request returns to the queue.

        Zero-queuing discipline (footnote 3): a preempted interactive
        request goes to the *front* of its model's line — it already
        waited once and must not re-queue behind later arrivals. Batch
        requests with host-saved KV enter the model's resume lane (served
        first, the restart skips re-prefill); otherwise they re-enter at
        their original (deadline, arrival) position.
        """
        if req.request_type == RequestType.INTERACTIVE:
            lane = self._ilanes.get(req.model)
            if lane is None:
                lane = self._ilanes[req.model] = _Lane(req.model)
            s = self._ifront
            self._ifront = s - 1
            lane.push_front(s, req)
            self._icount += 1
        elif req.saved_kv is not None:
            lane = self._bresumes.get(req.model)
            if lane is None:
                lane = self._bresumes[req.model] = _Lane(req.model)
            s = self._bseq
            self._bseq = s + 1
            lane.push(s, req)
            self._bcount += 1
            self._notify_add(req)
        else:
            self.push(req)

    # ------------------------------------------------- interactive serving
    def interactive_models(self) -> List[str]:
        """Models with queued interactive work (lane insertion order)."""
        return [m for m, lane in self._ilanes.items()
                if lane.tail > lane.head]

    def n_interactive_for(self, model: str) -> int:
        lane = self._ilanes.get(model)
        return lane.tail - lane.head if lane is not None else 0

    def peek_interactive(self, model: Optional[str] = None) -> Optional[Request]:
        lane = self._pick_ilane(model)
        return lane.req_objs[lane.head] if lane is not None else None

    def pop_interactive(self, model: Optional[str] = None) -> Optional[Request]:
        lane = self._pick_ilane(model)
        if lane is None:
            return None
        self._icount -= 1
        return lane.popleft()

    def _pick_ilane(self, model: Optional[str]) -> Optional[_Lane]:
        lanes = self._ilanes
        if model is not None:
            lane = lanes.get(model)
            return lane if lane is not None and lane.tail > lane.head \
                else None
        if len(lanes) == 1:              # single-model fast path: no scan
            lane = next(iter(lanes.values()))
            return lane if lane.tail > lane.head else None
        best = None
        best_seq = 0
        for lane in lanes.values():      # few models: O(M) head compare
            if lane.tail > lane.head:
                s = lane.seq[lane.head]
                if best is None or s < best_seq:
                    best, best_seq = lane, s
        return best

    # ------------------------------------------------- overload sweeping
    def sweep_interactive(self, now: float, *, grace: float = 0.0,
                          wait_by_model: Optional[Dict[str, float]] = None
                          ) -> Tuple[List[Request], List[Request]]:
        """Vectorized overload sweep over the interactive lanes; batch
        lanes are never touched (defer, don't drop).

        Returns ``(expired, shed)``: entries whose deadline (+``grace``)
        already passed are removed as EXPIRED candidates; when
        ``wait_by_model`` gives a per-queued-request service delay
        (brownout mode), entries whose estimated service start
        ``now + position * delay`` would still miss the deadline are
        removed as SHED candidates. Interactive lane deadlines are *not*
        monotone (several SLO classes share one per-model FIFO, and
        front-requeues take negative stamps), so this is a masked sweep
        over the deadline column, not a bisect. The caller owns the
        terminal state / ledger / retry bookkeeping for what comes back.
        """
        expired: List[Request] = []
        shed: List[Request] = []
        for lane in self._ilanes.values():
            h, t = lane.head, lane.tail
            if t <= h:
                continue
            dl = lane.deadline[h:t]
            gone = dl + grace < now
            doomed = None
            if wait_by_model is not None:
                w = wait_by_model.get(lane.model, 0.0)
                if w > 0.0:
                    start = now + np.arange(t - h, dtype=np.float64) * w
                    doomed = (start > dl + grace) & ~gone
                    if not doomed.any():
                        doomed = None
            if doomed is None and not gone.any():
                continue
            gidx = np.nonzero(gone)[0]
            expired.extend(lane.req_objs[h + int(i)] for i in gidx)
            if doomed is not None:
                shed.extend(lane.req_objs[h + int(i)]
                            for i in np.nonzero(doomed)[0])
                keep = ~(gone | doomed)
            else:
                keep = ~gone
            self._compact_ilane(lane, keep)
        return expired, shed

    def _compact_ilane(self, lane: _Lane, keep: np.ndarray) -> None:
        """Drop the masked-out entries, preserving order (and the key
        column / payload mirror) for the survivors."""
        h = lane.head
        dropped = int(keep.size) - int(np.count_nonzero(keep))
        kidx = np.nonzero(keep)[0] + h
        k = int(kidx.size)
        lane.seq[h:h + k] = lane.seq[kidx]
        lane.arrival[h:h + k] = lane.arrival[kidx]
        lane.deadline[h:h + k] = lane.deadline[kidx]
        lane.row[h:h + k] = lane.row[kidx]
        lane.req_objs[h:h + k] = [lane.req_objs[int(i)] for i in kidx]
        for i in range(h + k, lane.tail):
            # mirror-sync: ok(freed payload cells; their key cells are dead)
            lane.req_objs[i] = None
        if k == 0:
            lane.head = lane.tail = 0
        else:
            lane.tail = h + k
        self._icount -= dropped

    # ------------------------------------------------------ batch serving
    def batch_models(self) -> List[str]:
        """Models with queued batch work (lane insertion order)."""
        out = [m for m, n in self._bfresh.items() if n]
        out.extend(m for m, lane in self._bresumes.items()
                   if lane.tail > lane.head and m not in out)
        return out

    def n_batch_for(self, model: str) -> int:
        res = self._bresumes.get(model)
        return self._bfresh.get(model, 0) + \
            (res.tail - res.head if res is not None else 0)

    def peek_batch(self, model: Optional[str] = None) -> Optional[Request]:
        lane, kind = self._pick_blane(model)
        if lane is None:
            return None
        return lane[0][3] if kind == "heap" else lane.req_objs[lane.head]

    def pop_batch_fcfs(self, model: Optional[str] = None) -> Optional[Request]:
        """Earliest deadline first, then arrival order (FCFS within a
        group, §5.3); preempted requests with saved KV resume first."""
        lane, kind = self._pick_blane(model)
        if lane is None:
            return None
        if kind == "heap":
            req = heapq.heappop(lane)[3]
            self._bfresh[req.model] -= 1
        else:
            req = lane.popleft()
            if kind == "lane":
                self._bfresh[req.model] -= 1
        self._bcount -= 1
        if self._listeners:
            self._notify_remove(req)
        return req

    def _pick_blane(self, model: Optional[str]):
        """The source the next batch pop serves: a resume lane (kind
        ``"resume"``), an SLO-class lane (``"lane"``), or the overflow
        heap (``"heap"``) — the min head across candidates."""
        if model is not None:
            res = self._bresumes.get(model)
            if res is not None and res.tail > res.head:
                return res, "resume"
            if not self._bfresh.get(model, 0):
                return None, None
            return self._min_fresh(self._blanes[model],
                                   self._boflow[model])
        for res in self._bresumes.values():      # any resume lane first
            if res.tail > res.head:
                return res, "resume"
        best = best_key = None
        best_kind = None
        for m, n in self._bfresh.items():        # min head across models
            if not n:
                continue
            lane, kind = self._min_fresh(self._blanes[m], self._boflow[m])
            key = lane[0] if kind == "heap" else \
                (lane.deadline[lane.head], lane.arrival[lane.head],
                 lane.seq[lane.head])
            # seq (slot 2) is globally unique, so the comparison always
            # resolves before reaching a heap entry's Request element
            if best_key is None or key < best_key:
                best, best_key, best_kind = lane, key, kind
        return (best, best_kind) if best is not None else (None, None)

    @staticmethod
    def _min_fresh(lanes: Dict[float, _Lane], oflow: list):
        """Min head among one model's SLO-class lanes and overflow heap
        (caller guarantees at least one entry exists)."""
        best = best_key = None
        for lane in lanes.values():
            h = lane.head
            if h == lane.tail:
                continue
            key = (lane.deadline[h], lane.arrival[h], lane.seq[h])
            if best_key is None or key < best_key:
                best, best_key = lane, key
        if oflow and (best_key is None or oflow[0] < best_key):
            return oflow, "heap"
        return best, "lane"

    def _batch_sorted(self, model: str) -> List[Request]:
        """One model's fresh batch entries in service order — a
        vectorized ``np.lexsort`` merge of its SLO-class lanes and
        overflow heap (deadline, then arrival, then seq)."""
        lanes = self._blanes.get(model)
        if lanes is None:
            return []
        seqs, arrs, dls, objs = [], [], [], []
        for lane in lanes.values():
            s, a, d, o = lane.key_slices()
            if len(o):
                seqs.append(s)
                arrs.append(a)
                dls.append(d)
                objs.extend(o)
        for d, a, s, req in self._boflow.get(model, ()):
            seqs.append(np.array([s], dtype=np.int64))
            arrs.append(np.array([a]))
            dls.append(np.array([d]))
            objs.append(req)
        if not objs:
            return []
        order = np.lexsort((np.concatenate(seqs), np.concatenate(arrs),
                            np.concatenate(dls)))
        return [objs[i] for i in order.tolist()]

    def drain_model(self, model: str) -> List[Request]:
        """Remove and return every queued request for ``model`` — its
        interactive lane, batch lanes, and resume lane — preserving
        service order within each class (interactive first). The fleet
        plane uses this for migration hand-back: a cluster losing a
        model's placement surrenders that model's queued work for
        re-routing."""
        out: List[Request] = []
        lane = self._ilanes.pop(model, None)
        if lane is not None:
            live = lane.req_objs[lane.head:lane.tail]
            out.extend(live)
            self._icount -= len(live)
        res = self._bresumes.pop(model, None)
        if res is not None:
            for r in res.req_objs[res.head:res.tail]:
                out.append(r)
                self._bcount -= 1
                self._notify_remove(r)
        ordered = self._batch_sorted(model)      # deadline/FCFS order
        self._blanes.pop(model, None)
        self._boflow.pop(model, None)
        self._bfresh.pop(model, None)
        for r in ordered:
            out.append(r)
            self._bcount -= 1
            self._notify_remove(r)
        return out

    def iter_batch(self, model: Optional[str] = None) -> Iterator[Request]:
        """Queued batch requests in unspecified order (O(n))."""
        models = (model,) if model is not None else \
            dict.fromkeys(itertools.chain(self._blanes, self._bresumes))
        for m in models:
            res = self._bresumes.get(m)
            if res is not None:
                yield from res.req_objs[res.head:res.tail]
            for lane in self._blanes.get(m, {}).values():
                yield from lane.req_objs[lane.head:lane.tail]
            for entry in self._boflow.get(m, ()):
                yield entry[3]

    # ------------------------------------------------ legacy flat views
    @property
    def interactive(self) -> List[Request]:
        """Snapshot of queued interactive requests in global FIFO order.

        Vectorized debug/compat view (argsort over the concatenated seq
        columns) — the routing hot path uses ``peek_interactive`` /
        ``pop_interactive`` instead.
        """
        seqs, objs = [], []
        for lane in self._ilanes.values():
            s, _, _, o = lane.key_slices()
            if len(o):
                seqs.append(s)
                objs.extend(o)
        if not objs:
            return []
        order = np.argsort(np.concatenate(seqs), kind="stable")
        return [objs[i] for i in order.tolist()]

    @property
    def batch(self) -> List[Request]:
        """Snapshot of queued batch requests, resume lanes first, then
        earliest deadline first (vectorized lexsort merge)."""
        out: List[Request] = []
        for res in self._bresumes.values():
            out.extend(res.req_objs[res.head:res.tail])
        for m in self._blanes:
            out.extend(self._batch_sorted(m))
        return out

    # ------------------------------------------------------------ listeners
    def attach_batch_listener(self, listener,
                              model: Optional[str] = None) -> None:
        """Register an ``on_add(req)`` / ``on_remove(req)`` observer of
        the batch side — all models, or one model's lanes when ``model``
        is given; current (matching) contents are replayed as adds in
        service order (resume lanes first, then earliest deadline)."""
        self._listeners.append((listener, model))
        for req in self._replay_order(model):
            listener.on_add(req)

    def _replay_order(self, model: Optional[str]) -> List[Request]:
        models = (model,) if model is not None else \
            dict.fromkeys(itertools.chain(self._blanes, self._bresumes))
        out: List[Request] = []
        for m in models:
            res = self._bresumes.get(m)
            if res is not None:
                out.extend(res.req_objs[res.head:res.tail])
            out.extend(self._batch_sorted(m))
        return out

    def _notify_add(self, req: Request) -> None:
        for listener, model in self._listeners:
            if model is None or req.model == model:
                listener.on_add(req)

    def _notify_remove(self, req: Request) -> None:
        for listener, model in self._listeners:
            if model is None or req.model == model:
                listener.on_remove(req)

    # --------------------------------------------------------- audit hooks
    def audit_lanes(self):
        """Yield ``(kind, model, lane)`` for every columnar lane — the
        shadow verifier's rebuild surface (kinds: ``interactive``,
        ``batch``, ``resume``)."""
        for m, lane in self._ilanes.items():
            yield "interactive", m, lane
        for m, lanes in self._blanes.items():
            for lane in lanes.values():
                yield "batch", m, lane
        for m, lane in self._bresumes.items():
            yield "resume", m, lane

    def audit_counts(self) -> Tuple[int, int]:
        """Recount (interactive, batch) entries from the lanes (the
        shadow verifier checks them against ``_icount``/``_bcount``)."""
        n_i = sum(lane.tail - lane.head for lane in self._ilanes.values())
        n_b = sum(lane.tail - lane.head
                  for lanes in self._blanes.values()
                  for lane in lanes.values())
        n_b += sum(len(h) for h in self._boflow.values())
        n_b += sum(lane.tail - lane.head
                   for lane in self._bresumes.values())
        return n_i, n_b

    # ------------------------------------------------------------ sizes
    @property
    def n_interactive(self) -> int:
        return self._icount

    @property
    def n_batch(self) -> int:
        return self._bcount

    def __len__(self) -> int:
        return self._icount + self._bcount


class ReferenceGlobalQueue:
    """Pre-columnar object flavour: per-model deques of ``(seq, Request)``
    and ``(deadline, arrival, seq, Request)`` binary heaps. Kept as the
    decision-equivalence baseline (``reference=True``) — pop order is
    bit-identical to :class:`GlobalQueue`."""

    columnar = False

    def __init__(self):
        self._ilanes: Dict[str, Deque[Tuple[int, Request]]] = {}
        self._iseq = itertools.count()
        self._ifront = itertools.count(-1, -1)
        self._icount = 0
        # model -> (deadline, arrival_time, seq, request) heap — earliest
        # deadline first, FCFS within a deadline (§5.3), seq breaks ties
        self._bheaps: Dict[str, List[Tuple[float, float, int, Request]]] = {}
        self._bresumes: Dict[str, Deque[Request]] = {}   # preempted, KV host
        self._bseq = itertools.count()
        self._bcount = 0
        self._listeners: List[Tuple[object, Optional[str]]] = []

    # ------------------------------------------------------------ intake
    def push(self, req: Request) -> None:
        if req.request_type == RequestType.INTERACTIVE:
            lane = self._ilanes.get(req.model)
            if lane is None:
                lane = self._ilanes[req.model] = deque()
            lane.append((next(self._iseq), req))
            self._icount += 1
        else:
            h = self._bheaps.get(req.model)
            if h is None:
                h = self._bheaps[req.model] = []
            heapq.heappush(h, (req.deadline, req.arrival_time,
                               next(self._bseq), req))
            self._bcount += 1
            if self._listeners:
                self._notify_add(req)

    def requeue(self, req: Request) -> None:
        """See :meth:`GlobalQueue.requeue` (identical discipline)."""
        if req.request_type == RequestType.INTERACTIVE:
            self._ilanes.setdefault(req.model, deque()).appendleft(
                (next(self._ifront), req))
            self._icount += 1
        elif req.saved_kv is not None:
            self._bresumes.setdefault(req.model, deque()).append(req)
            self._bcount += 1
            self._notify_add(req)
        else:
            self.push(req)

    # ------------------------------------------------- interactive serving
    def interactive_models(self) -> List[str]:
        return [m for m, d in self._ilanes.items() if d]

    def n_interactive_for(self, model: str) -> int:
        lane = self._ilanes.get(model)
        return len(lane) if lane else 0

    def peek_interactive(self, model: Optional[str] = None) -> Optional[Request]:
        lane = self._pick_ilane(model)
        return lane[0][1] if lane else None

    def pop_interactive(self, model: Optional[str] = None) -> Optional[Request]:
        lane = self._pick_ilane(model)
        if not lane:
            return None
        self._icount -= 1
        return lane.popleft()[1]

    def _pick_ilane(self, model: Optional[str]) -> Optional[Deque]:
        lanes = self._ilanes
        if model is not None:
            lane = lanes.get(model)
            return lane if lane else None
        if len(lanes) == 1:              # single-model fast path: no scan
            lane = next(iter(lanes.values()))
            return lane if lane else None
        best = None
        for lane in lanes.values():      # few models: O(M) scan
            if lane and (best is None or lane[0][0] < best[0][0]):
                best = lane
        return best

    # ------------------------------------------------------ batch serving
    def batch_models(self) -> List[str]:
        out = [m for m, h in self._bheaps.items() if h]
        out.extend(m for m, d in self._bresumes.items()
                   if d and m not in out)
        return out

    def n_batch_for(self, model: str) -> int:
        return len(self._bheaps.get(model, ())) + \
            len(self._bresumes.get(model, ()))

    def peek_batch(self, model: Optional[str] = None) -> Optional[Request]:
        lane, kind = self._pick_blane(model)
        if lane is None:
            return None
        return lane[0] if kind == "resume" else lane[0][3]

    def pop_batch_fcfs(self, model: Optional[str] = None) -> Optional[Request]:
        lane, kind = self._pick_blane(model)
        if lane is None:
            return None
        req = lane.popleft() if kind == "resume" else heapq.heappop(lane)[3]
        self._bcount -= 1
        if self._listeners:
            self._notify_remove(req)
        return req

    def _pick_blane(self, model: Optional[str]):
        """The lane the next batch pop serves: a resume deque or a heap."""
        if model is not None:
            res = self._bresumes.get(model)
            if res:
                return res, "resume"
            h = self._bheaps.get(model)
            return (h, "heap") if h else (None, None)
        if self._bresumes:
            for res in self._bresumes.values():  # any resume lane first
                if res:
                    return res, "resume"
        best = None
        for h in self._bheaps.values():         # min head across models
            # seq (slot 2) is globally unique, so the head comparison
            # always resolves before reaching the Request element
            if h and (best is None or h[0] < best[0]):
                best = h
        return (best, "heap") if best is not None else (None, None)

    def drain_model(self, model: str) -> List[Request]:
        """See :meth:`GlobalQueue.drain_model` (identical order)."""
        out: List[Request] = []
        lane = self._ilanes.pop(model, None)
        if lane:
            out.extend(r for _, r in lane)
            self._icount -= len(lane)
        res = self._bresumes.pop(model, None)
        if res:
            for r in res:
                out.append(r)
                self._bcount -= 1
                self._notify_remove(r)
        heap = self._bheaps.pop(model, None)
        if heap:
            heap.sort()                      # deadline/FCFS service order
            for entry in heap:
                out.append(entry[3])
                self._bcount -= 1
                self._notify_remove(entry[3])
        return out

    def iter_batch(self, model: Optional[str] = None) -> Iterator[Request]:
        """Queued batch requests in unspecified order (O(n))."""
        models = (model,) if model is not None else \
            dict.fromkeys(itertools.chain(self._bheaps, self._bresumes))
        for m in models:
            yield from self._bresumes.get(m, ())
            for entry in self._bheaps.get(m, ()):
                yield entry[3]

    # ------------------------------------------------ legacy flat views
    @property
    def interactive(self) -> List[Request]:
        entries: List[Tuple[int, Request]] = []
        for lane in self._ilanes.values():
            entries.extend(lane)
        entries.sort(key=lambda e: e[0])
        return [r for _, r in entries]

    @property
    def batch(self) -> List[Request]:
        out: List[Request] = []
        for res in self._bresumes.values():
            out.extend(res)
        entries: List[Tuple[float, float, int, Request]] = []
        for h in self._bheaps.values():
            entries.extend(h)
        entries.sort()
        out.extend(e[3] for e in entries)
        return out

    # ------------------------------------------------------------ listeners
    def attach_batch_listener(self, listener,
                              model: Optional[str] = None) -> None:
        """See :meth:`GlobalQueue.attach_batch_listener` — the replay
        runs in the same canonical service order (resume lanes first,
        then sorted heap entries) so both flavours feed listeners an
        identical stream."""
        self._listeners.append((listener, model))
        models = (model,) if model is not None else \
            dict.fromkeys(itertools.chain(self._bheaps, self._bresumes))
        for m in models:
            for req in self._bresumes.get(m, ()):
                listener.on_add(req)
            for entry in sorted(self._bheaps.get(m, ())):
                listener.on_add(entry[3])

    def _notify_add(self, req: Request) -> None:
        for listener, model in self._listeners:
            if model is None or req.model == model:
                listener.on_add(req)

    def _notify_remove(self, req: Request) -> None:
        for listener, model in self._listeners:
            if model is None or req.model == model:
                listener.on_remove(req)

    # ------------------------------------------------------------ sizes
    @property
    def n_interactive(self) -> int:
        return self._icount

    @property
    def n_batch(self) -> int:
        return self._bcount

    def __len__(self) -> int:
        return self._icount + self._bcount


def make_queue(reference: bool = False):
    """The engines' queue factory: the columnar plane by default, the
    object flavour under ``reference=True``."""
    return ReferenceGlobalQueue() if reference else GlobalQueue()
