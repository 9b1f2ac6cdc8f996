"""Columnar request ledger: struct-of-arrays outcome store for the event core.

The workload plane has been columnar since the ``Trace`` refactor, but the
simulation hot path still recorded every outcome by mutating ``Request``
objects, and every metric was a Python loop over those objects — at
million-request scale the *reduction* pass cost seconds on top of the
simulation itself. The :class:`RequestLedger` closes that gap: one
preallocated column per per-request outcome (first-token time, finish
time, tokens generated, lifecycle state, lifetime-mean ITL) plus views of
the immutable workload columns (arrival, token lengths, class, SLOs,
model/origin vocabulary indices).

The event core writes the ledger by integer **row id** (``Request.row``)
at the exact sites it writes the corresponding ``Request`` attribute, so
the object view and the columnar view never disagree; ``Request`` stays
the admission-boundary currency for queues and controllers. Everything
*aggregate* — SLO attainment, per-model/per-class rollups, completion
rate, token totals, TTFT percentiles — becomes a vectorized reduction
over the ledger (see :class:`repro_torch.sim.metrics.RunResult`), which is what
keeps a 1M-request replay's summary at array speed.

Rows are assigned in arrival order (the sorted trace's row order). Stream
replays grow the ledger chunk by chunk (amortized doubling), so the row
space always covers every request the simulator has seen.

Lifecycle state is encoded as int8 (``STATE_CODES`` maps from
:class:`~repro_torch.serving.request.RequestState`): QUEUED=0, RUNNING=1,
PREEMPTED=2, FINISHED=3, plus the overload-plane terminal states
REJECTED=4, SHED=5, EXPIRED=6. Unwritten float cells are NaN (never
observed).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.serving.request import Request, RequestState, RequestType

# int8 lifecycle codes (stable: the ledger round-trips through files).
# 4..6 are the overload-plane terminal states (append-only).
QUEUED, RUNNING, PREEMPTED, FINISHED = 0, 1, 2, 3
REJECTED, SHED, EXPIRED = 4, 5, 6
STATE_CODES: Dict[RequestState, int] = {
    RequestState.QUEUED: QUEUED,
    RequestState.RUNNING: RUNNING,
    RequestState.PREEMPTED: PREEMPTED,
    RequestState.FINISHED: FINISHED,
    RequestState.REJECTED: REJECTED,
    RequestState.SHED: SHED,
    RequestState.EXPIRED: EXPIRED,
}
# Terminal codes: a row in one of these states is done (accounting
# identity: the terminal counts sum to n over a completed run)
TERMINAL_CODES = (FINISHED, REJECTED, SHED, EXPIRED)

# Mirror registry: ``Request`` attribute -> ledger outcome column written
# at the same mutation site (``led.<col>[req.row] = ...``). The static
# mirror auditor (``repro_torch.analysis``, rule MIR101) walks
# assignments against this mapping, and the runtime shadow verifier rebuilds the
# columns from the objects and asserts exact agreement — extend it when
# adding a mirrored outcome field.
LEDGER_MIRRORS: Dict[str, str] = {
    "state": "state",
    "first_token_time": "first_token_time",
    "finish_time": "finish_time",
    "tokens_generated": "tokens_generated",
    "retries": "retries",
}
# Derived mirror (documented for the shadow verifier, not auto-audited:
# the object side is a list *append*, not an assignment): the event core
# records the lifetime-mean ITL of ``Request.itl_samples`` in
# ``mean_itl`` at finish time.
LEDGER_DERIVED_MIRRORS: Dict[str, str] = {"itl_samples": "mean_itl"}


class RequestLedger:
    """Struct-of-arrays per-request outcome store (see module docstring).

    Workload columns (``arrival``, ``prompt_len``, ``output_len``,
    ``interactive``, ``ttft_slo``, ``itl_slo``, ``model_idx``,
    ``origin_idx``, ``tenant_idx``) are immutable inputs; outcome columns
    (``first_token_time``, ``finish_time``, ``tokens_generated``,
    ``state``, ``mean_itl``) are written by the event core via row id.
    """

    __slots__ = ("n", "arrival", "prompt_len", "output_len", "interactive",
                 "ttft_slo", "itl_slo", "model_idx", "origin_idx",
                 "tenant_idx", "models", "origins", "tenants",
                 "first_token_time", "finish_time",
                 "tokens_generated", "state", "mean_itl", "retries",
                 "_backing", "_cap")

    def __init__(self, n: int, *, models: Tuple[str, ...] = (),
                 origins: Tuple[str, ...] = (),
                 tenants: Tuple[str, ...] = ()):
        self.n = n
        self._backing: Dict[str, np.ndarray] = {}
        self._cap = 0
        self.models = tuple(models)
        self.origins = tuple(origins)
        self.tenants = tuple(tenants)
        self.arrival = np.zeros(n, dtype=np.float64)
        self.prompt_len = np.zeros(n, dtype=np.int64)
        self.output_len = np.zeros(n, dtype=np.int64)
        self.interactive = np.zeros(n, dtype=bool)
        self.ttft_slo = np.zeros(n, dtype=np.float64)
        self.itl_slo = np.zeros(n, dtype=np.float64)
        self.model_idx = np.zeros(n, dtype=np.int32)
        self.origin_idx = np.zeros(n, dtype=np.int32)
        self.tenant_idx = np.zeros(n, dtype=np.int32)
        self.first_token_time = np.full(n, np.nan)
        self.finish_time = np.full(n, np.nan)
        self.tokens_generated = np.zeros(n, dtype=np.int64)
        self.state = np.zeros(n, dtype=np.int8)
        self.mean_itl = np.full(n, np.nan)
        self.retries = np.zeros(n, dtype=np.int32)

    # ------------------------------------------------------- construction
    @classmethod
    def from_trace(cls, trace) -> "RequestLedger":
        """Ledger over an arrival-sorted :class:`~repro_torch.sim.workload.Trace`
        — row i is trace row i. The workload columns are shared views
        (the trace is immutable by convention), outcome columns fresh."""
        led = cls(trace.n, models=trace.models, origins=trace.origins,
                  tenants=getattr(trace, "tenants", ()))
        led.arrival = trace.arrival
        led.prompt_len = trace.prompt_len
        led.output_len = trace.output_len
        led.interactive = trace.interactive
        led.ttft_slo = trace.ttft_slo
        led.itl_slo = trace.itl_slo
        led.model_idx = trace.model_idx
        led.origin_idx = trace.origin_idx
        tidx = getattr(trace, "tenant_idx", None)
        if tidx is not None:
            led.tenant_idx = tidx
        att = getattr(trace, "attempt", None)
        if att is not None:
            # pre-consumed client retry attempts (replayed overload trace)
            led.retries[:] = att
        return led

    @classmethod
    def from_requests(cls, reqs: Sequence[Request],
                      assign_rows: bool = True) -> "RequestLedger":
        """Columnarize a request list (row i = list position i); stamps
        ``req.row`` so the event core can write outcomes by id. Existing
        lifecycle state is carried over (a re-ledgered half-run request
        keeps its history)."""
        models: List[str] = []
        mseen: Dict[str, int] = {}
        origins: List[str] = []
        oseen: Dict[str, int] = {}
        tenants: List[str] = []
        tseen: Dict[str, int] = {}
        led = cls(len(reqs))
        for i, r in enumerate(reqs):
            if assign_rows:
                r.row = i
            mi = mseen.get(r.model)
            if mi is None:
                mi = mseen[r.model] = len(models)
                models.append(r.model)
            led.model_idx[i] = mi
            if r.origin is not None:
                oi = oseen.get(r.origin)
                if oi is None:
                    oi = oseen[r.origin] = len(origins)
                    origins.append(r.origin)
                led.origin_idx[i] = oi
            if r.tenant is not None:
                ti = tseen.get(r.tenant)
                if ti is None:
                    ti = tseen[r.tenant] = len(tenants)
                    tenants.append(r.tenant)
                led.tenant_idx[i] = ti
            led.arrival[i] = r.arrival_time
            led.prompt_len[i] = r.prompt_len
            led.output_len[i] = r.output_len
            led.interactive[i] = r.is_interactive
            led.ttft_slo[i] = r.slo.ttft
            led.itl_slo[i] = r.slo.itl
            led.state[i] = STATE_CODES[r.state]
            led.tokens_generated[i] = r.tokens_generated
            led.retries[i] = r.retries
            if r.first_token_time is not None:
                led.first_token_time[i] = r.first_token_time
            if r.finish_time is not None:
                led.finish_time[i] = r.finish_time
            if r.itl_samples:
                led.mean_itl[i] = sum(r.itl_samples) / len(r.itl_samples)
        led.models = tuple(models)
        led.origins = tuple(origins)
        led.tenants = tuple(tenants)
        return led

    # column -> (dtype, fill value for unwritten outcome cells)
    _COLUMNS = (
        ("arrival", np.float64, 0.0), ("prompt_len", np.int64, 0),
        ("output_len", np.int64, 0), ("interactive", bool, False),
        ("ttft_slo", np.float64, 0.0), ("itl_slo", np.float64, 0.0),
        ("model_idx", np.int32, 0), ("origin_idx", np.int32, 0),
        ("tenant_idx", np.int32, 0),
        ("first_token_time", np.float64, np.nan),
        ("finish_time", np.float64, np.nan),
        ("tokens_generated", np.int64, 0), ("state", np.int8, 0),
        ("mean_itl", np.float64, np.nan), ("retries", np.int32, 0),
    )

    def _reserve(self, extra: int) -> None:
        """Amortized-doubling growth for the stream path: backing arrays
        at least double on overflow and the public columns become
        exact-length views, so N rows over C chunks cost O(N) total
        copying instead of O(C*N)."""
        need = self.n + extra
        cap = self._cap if self._cap > 0 else 0
        if cap == 0:
            # first growth (or a ledger built without backing arrays):
            # current columns become the live prefix of fresh backing
            cap = max(need, 1024)
            for name, dtype, fill in self._COLUMNS:
                back = np.full(cap, fill, dtype=dtype)
                back[:self.n] = getattr(self, name)
                self._backing[name] = back
        elif need > cap:
            while cap < need:
                cap *= 2
            for name, dtype, fill in self._COLUMNS:
                back = np.full(cap, fill, dtype=dtype)
                back[:self.n] = self._backing[name]
                self._backing[name] = back
        else:
            return
        self._cap = cap

    def _expose(self) -> None:
        """Point the public columns at the live prefix of the backing."""
        n = self.n
        for name, _, _ in self._COLUMNS:
            setattr(self, name, self._backing[name][:n])

    def extend_from_trace(self, trace) -> int:
        """Stream mode: append a chunk's workload columns; returns the
        first row id of the appended block. The chunk's model/origin
        vocabularies are merged into the ledger's. Growth is amortized
        doubling (public columns are views of backing arrays)."""
        base = self.n
        mremap = self._merge_vocab("models", trace.models)
        oremap = self._merge_vocab("origins", trace.origins)
        tremap = self._merge_vocab("tenants",
                                   getattr(trace, "tenants", ()))
        self._reserve(trace.n)
        b = self._backing
        hi = base + trace.n
        b["arrival"][base:hi] = trace.arrival
        b["prompt_len"][base:hi] = trace.prompt_len
        b["output_len"][base:hi] = trace.output_len
        b["interactive"][base:hi] = trace.interactive
        b["ttft_slo"][base:hi] = trace.ttft_slo
        b["itl_slo"][base:hi] = trace.itl_slo
        b["model_idx"][base:hi] = mremap[trace.model_idx]
        b["origin_idx"][base:hi] = oremap[trace.origin_idx] \
            if len(oremap) else trace.origin_idx
        tidx = getattr(trace, "tenant_idx", None)
        if tidx is None:
            tidx = np.zeros(trace.n, dtype=np.int32)
        b["tenant_idx"][base:hi] = tremap[tidx] if len(tremap) else tidx
        att = getattr(trace, "attempt", None)
        if att is not None:
            b["retries"][base:hi] = att
        # outcome cells keep their fill values (nan / 0)
        self.n = hi
        self._expose()
        return base

    def _merge_vocab(self, attr: str, vocab: Tuple[str, ...]) -> np.ndarray:
        mine = list(getattr(self, attr))
        remap = np.empty(max(len(vocab), 1), dtype=np.int32)
        for i, name in enumerate(vocab):
            if name not in mine:
                mine.append(name)
            remap[i] = mine.index(name)
        setattr(self, attr, tuple(mine))
        return remap[:len(vocab)]

    # ------------------------------------------------- overload lifecycle
    # Each helper moves the object state and its ledger column together in
    # one function — the MIR104 auditor requires exactly this pairing for
    # every terminal write, so the engines route all overload-plane state
    # transitions through here instead of open-coding them.
    def mark_rejected(self, req: Request) -> None:
        """Terminal REJECTED: refused at admission (infeasible TTFT)."""
        req.state = RequestState.REJECTED
        if req.row >= 0:
            self.state[req.row] = REJECTED

    def mark_shed(self, req: Request) -> None:
        """Terminal SHED: proactively dropped from the queue (brownout)."""
        req.state = RequestState.SHED
        if req.row >= 0:
            self.state[req.row] = SHED

    def mark_expired(self, req: Request) -> None:
        """Terminal EXPIRED: deadline passed while still queued."""
        req.state = RequestState.EXPIRED
        if req.row >= 0:
            self.state[req.row] = EXPIRED

    def mark_queued(self, req: Request) -> None:
        """A retry attempt re-enters the lifecycle (REJECTED/SHED ->
        QUEUED before the re-admission gate runs)."""
        req.state = RequestState.QUEUED
        if req.row >= 0:
            self.state[req.row] = QUEUED

    def bump_retry(self, req: Request) -> int:
        """Consume one client retry attempt (object + column together —
        the ``retries`` mirror is MIR101-audited like any other)."""
        req.retries = req.retries + 1
        if req.row >= 0:
            self.retries[req.row] = req.retries
        return req.retries

    # -------------------------------------------------------- reductions
    def class_mask(self, rtype: Optional[RequestType]) -> Optional[np.ndarray]:
        if rtype is None:
            return None
        if rtype == RequestType.INTERACTIVE:
            return self.interactive
        return ~self.interactive

    def finished_mask(self) -> np.ndarray:
        return self.state == FINISHED

    def state_counts(self) -> np.ndarray:
        """Requests per lifecycle code (one bincount; index with the
        module constants, e.g. ``counts[REJECTED]``)."""
        if not self.n:
            return np.zeros(EXPIRED + 1, dtype=np.int64)
        return np.bincount(self.state, minlength=EXPIRED + 1)

    def goodput_mask(self) -> np.ndarray:
        """Rows that finished *and* met their SLO — the overload plane's
        currency: shed/rejected/expired rows and SLO-blown completions
        both fall out."""
        return self.slo_met_mask()

    def goodput(self, duration: float,
                rtype: Optional[RequestType] = None) -> float:
        """SLO-met completions per second over ``duration``."""
        if not duration:
            return 0.0
        good = self.goodput_mask()
        mask = self.class_mask(rtype)
        if mask is not None:
            good = good & mask
        return float(np.count_nonzero(good)) / duration

    def ttft(self) -> np.ndarray:
        """Per-row TTFT (NaN where no first token was observed)."""
        return self.first_token_time - self.arrival

    def ttft_met_mask(self) -> np.ndarray:
        ftt = self.first_token_time
        with np.errstate(invalid="ignore"):
            return ~np.isnan(ftt) & (ftt - self.arrival <= self.ttft_slo)

    def itl_met_mask(self, tolerance: float = 1.0) -> np.ndarray:
        """Mean observed ITL within the SLO; rows with no samples count as
        met (mirrors :meth:`Request.itl_met`)."""
        mi = self.mean_itl
        with np.errstate(invalid="ignore"):
            return np.isnan(mi) | (mi <= self.itl_slo * tolerance)

    def slo_met_mask(self) -> np.ndarray:
        return self.finished_mask() & self.ttft_met_mask() \
            & self.itl_met_mask()

    def slo_attainment(self, rtype: Optional[RequestType] = None) -> float:
        mask = self.class_mask(rtype)
        met = self.slo_met_mask()
        if mask is None:
            return float(np.count_nonzero(met)) / self.n if self.n else 1.0
        tot = int(np.count_nonzero(mask))
        if not tot:
            return 1.0
        return float(np.count_nonzero(met & mask)) / tot

    def slo_by_model(self) -> Dict[str, float]:
        """Per-model SLO attainment, first-appearance order (one bincount
        pass — no per-request Python)."""
        if not self.n:
            return {}
        nm = max(len(self.models), int(self.model_idx.max()) + 1)
        tot = np.bincount(self.model_idx, minlength=nm)
        met = np.bincount(self.model_idx, weights=self.slo_met_mask(),
                          minlength=nm)
        first = np.full(nm, self.n, dtype=np.int64)
        # first appearance: reversed assignment leaves the earliest index
        first[self.model_idx[::-1]] = np.arange(self.n - 1, -1, -1)
        order = [int(i) for i in np.argsort(first, kind="stable")
                 if tot[i] > 0]
        return {self.models[i] if i < len(self.models) else str(i):
                float(met[i]) / int(tot[i]) for i in order}
