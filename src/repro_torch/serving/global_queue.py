"""Global queue (paper §3, Lifecycle of a Request) — multi-model aware,
columnar.

The port's copy of ``_Lane`` and ``GlobalQueue`` from the reference's
``serving/global_queue.py``, unchanged; the reference's object flavour
(``ReferenceGlobalQueue``, ``make_queue``) serves its simulator and is not
copied (ROADMAP.md, Queue A item 9), nor are the hooks of its shadow
verifier (``QUEUE_MIRRORS``, ``audit_lanes``, ``audit_counts``) or the
methods only its simulator and fleet call (``sweep_interactive``,
``_compact_ilane``, ``drain_model``). The
``mirror-sync`` annotations stay: the repo's static auditor reads them.

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
entry (a requeue of an old arrival) falls into a
per-model overflow heap merged at peek time. Snapshots are
vectorized (``np.lexsort`` over the concatenated key columns) instead of
sorting Python tuples. ``Request`` objects ride along as the payload —
they are only *touched* again at the admit edge (the scheduler-batch
idiom of keeping scheduling state columnar and crossing into object land
at the boundary).

Preempted batch requests that still hold host-saved KV are parked in a
per-model resume lane served before fresh work, so a restart never
re-queues behind requests that have not prefill'd yet.

Listeners (``attach_batch_listener``) observe every batch add/remove —
optionally filtered to one model — and let each model's global
autoscaler maintain request groups incrementally instead of
re-clustering the whole queue each control tick. Attach replays the
current contents in *service order* (resume lanes, then earliest
deadline first) so the replay stream is a property of the queue's
contents, not of the lanes' internal layout.
"""
from __future__ import annotations

import heapq
import itertools
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from repro_torch.serving.request import Request, RequestType

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
        vectorized snapshot surface."""
        h, t = self.head, self.tail
        return (self.seq[h:t], self.arrival[h:t], self.deadline[h:t],
                self.req_objs[h:t])


class GlobalQueue:
    """Columnar struct-of-arrays queue plane (see module docstring)."""

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

    # ------------------------------------------------------------ sizes
    @property
    def n_interactive(self) -> int:
        return self._icount

    @property
    def n_batch(self) -> int:
        return self._bcount

    def __len__(self) -> int:
        return self._icount + self._bcount
