"""Workload generation: columnar traces + ShareGPT-like token distributions.

The paper's traces use 3,500 ShareGPT requests (Fig. 8 token distributions)
with Poisson arrivals for the main experiments and Gamma arrivals (varying
CV) for the burstiness robustness analysis (§6.3, Fig. 17).

The workload plane is columnar: a :class:`Trace` is a struct-of-arrays
(NumPy) view of a request stream — arrival times, token lengths, request
class, per-request SLOs, and a model column for multi-model fleets — and
every generator here fills those arrays with vectorized draws, never a
per-request Python loop. ``Request`` objects are only materialized at the
simulator boundary (``Trace.materialize`` / the event core's chunked
cursor), which is what keeps 1M+ request traces generable in milliseconds.

Trace schema (one row per request):

  arrival      float64  seconds from trace start, non-decreasing
  prompt_len   int64    input tokens
  output_len   int64    output tokens (ground truth)
  interactive  bool     True -> interactive class, False -> batch
  ttft_slo     float64  per-request TTFT SLO (seconds)
  itl_slo      float64  per-request ITL SLO (seconds/token)
  model_idx    int32    index into ``models`` (the model vocabulary)
  origin_idx   int32    index into ``origins`` (originating regions;
                        empty ``origins`` = single-region workload)
  tenant_idx   int32    index into ``tenants`` (paying tenants for
                        per-tenant attainment; empty ``tenants`` =
                        single-tenant workload)
  attempt      int32    optional: client retry attempts already consumed
                        before this submission (``None`` = fresh trace;
                        replayed overload traces carry the column so the
                        retry budget keeps counting across a round-trip)

``repro_torch.sim.trace_io`` round-trips this schema to CSV/JSONL (including
Azure-LLM-inference-style traces) and streams multi-day files in
arrival-ordered chunks (:class:`TraceStream`).

The port's copy of the reference's ``sim/workload.py``: the same columns
and the same draws, in the same order from the same ``numpy`` generator
(batch-queue token lengths, live token lengths, gaps, class coin flips),
so one spec and seed give the same trace, and the same requests, in both
packages. The simulator, the trace files and the real cluster's serving
loop all read it.
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np

from repro_torch.serving.request import (BATCH_ITL_SLO, BATCH_TTFT_SLO,
                                         INTERACTIVE_ITL_SLO, INTERACTIVE_TTFT_SLO,
                                         Request, RequestType, SLO,
                                         request_id_counter)

# ShareGPT-ish lognormal parameters (Fig. 8: median input ~100 tokens with a
# heavy tail; outputs somewhat longer)
INPUT_MU, INPUT_SIGMA = 4.6, 1.0      # median ~100, mean ~165
OUTPUT_MU, OUTPUT_SIGMA = 5.2, 0.9    # median ~180, mean ~270
MAX_TOKENS = 2048

DEFAULT_MODEL = "llama-8b"

# infinite -1 row stamp for unledgered materialization (shared: `repeat`
# is stateless and inexhaustible, so concurrent zips interleave safely)
_NO_ROWS = itertools.repeat(-1)


# =========================================================== columnar trace
@dataclass
class Trace:
    """Struct-of-arrays request stream (see module docstring for schema).

    All columns share one length; ``models`` is the model vocabulary that
    ``model_idx`` indexes. Construction normalizes dtypes; use
    :meth:`sorted_by_arrival` before handing a trace to the simulator.
    """
    arrival: np.ndarray
    prompt_len: np.ndarray
    output_len: np.ndarray
    interactive: np.ndarray
    ttft_slo: np.ndarray
    itl_slo: np.ndarray
    model_idx: np.ndarray
    models: Tuple[str, ...] = (DEFAULT_MODEL,)
    origin_idx: Optional[np.ndarray] = None   # None/empty origins = no column
    origins: Tuple[str, ...] = ()
    tenant_idx: Optional[np.ndarray] = None   # None/empty tenants = no column
    tenants: Tuple[str, ...] = ()
    attempt: Optional[np.ndarray] = None      # None = no retry history

    def __post_init__(self):
        self.arrival = np.asarray(self.arrival, dtype=np.float64)
        n = self.arrival.shape[0]
        self.prompt_len = np.asarray(self.prompt_len, dtype=np.int64)
        self.output_len = np.asarray(self.output_len, dtype=np.int64)
        self.interactive = np.asarray(self.interactive, dtype=bool)
        self.ttft_slo = np.asarray(self.ttft_slo, dtype=np.float64)
        self.itl_slo = np.asarray(self.itl_slo, dtype=np.float64)
        self.model_idx = np.asarray(self.model_idx, dtype=np.int32)
        self.models = tuple(self.models)
        self.origins = tuple(self.origins)
        self.tenants = tuple(self.tenants)
        if self.origin_idx is None:
            self.origin_idx = np.zeros(n, dtype=np.int32)
        self.origin_idx = np.asarray(self.origin_idx, dtype=np.int32)
        if self.tenant_idx is None:
            self.tenant_idx = np.zeros(n, dtype=np.int32)
        self.tenant_idx = np.asarray(self.tenant_idx, dtype=np.int32)
        if self.attempt is not None:
            self.attempt = np.asarray(self.attempt, dtype=np.int32)
            if self.attempt.shape != (n,):
                raise ValueError(f"Trace column 'attempt' has shape "
                                 f"{self.attempt.shape}, want ({n},)")
        for name in ("prompt_len", "output_len", "interactive",
                     "ttft_slo", "itl_slo", "model_idx", "origin_idx",
                     "tenant_idx"):
            if getattr(self, name).shape != (n,):
                raise ValueError(f"Trace column {name!r} has shape "
                                 f"{getattr(self, name).shape}, want ({n},)")
        if n and (self.model_idx.min() < 0
                  or self.model_idx.max() >= len(self.models)):
            raise ValueError("Trace.model_idx out of range of models")
        if n and self.origins and (self.origin_idx.min() < 0 or
                                   self.origin_idx.max() >= len(self.origins)):
            raise ValueError("Trace.origin_idx out of range of origins")
        if n and self.tenants and (self.tenant_idx.min() < 0 or
                                   self.tenant_idx.max() >= len(self.tenants)):
            raise ValueError("Trace.tenant_idx out of range of tenants")

    # ------------------------------------------------------------ basics
    @property
    def n(self) -> int:
        return int(self.arrival.shape[0])

    def __len__(self) -> int:
        return self.n

    @property
    def duration(self) -> float:
        return float(self.arrival[-1]) if self.n else 0.0

    def sorted_by_arrival(self) -> "Trace":
        """Stable-sorted copy (no-op view reuse when already sorted)."""
        if self.n == 0 or bool(np.all(np.diff(self.arrival) >= 0)):
            return self
        order = np.argsort(self.arrival, kind="stable")
        return self.take(order)

    def take(self, idx) -> "Trace":
        return Trace(self.arrival[idx], self.prompt_len[idx],
                     self.output_len[idx], self.interactive[idx],
                     self.ttft_slo[idx], self.itl_slo[idx],
                     self.model_idx[idx], self.models,
                     self.origin_idx[idx], self.origins,
                     self.tenant_idx[idx], self.tenants,
                     None if self.attempt is None else self.attempt[idx])

    def head(self, n: int) -> "Trace":
        return self.take(slice(0, n))

    @staticmethod
    def concat(traces: Sequence["Trace"]) -> "Trace":
        """Concatenate traces, merging model (and origin) vocabularies."""
        def merge(vocabs, idx_cols):
            merged: List[str] = []
            remapped = []
            for vocab, idx in zip(vocabs, idx_cols):
                remap = np.empty(len(vocab), dtype=np.int32)
                for i, name in enumerate(vocab):
                    if name not in merged:
                        merged.append(name)
                    remap[i] = merged.index(name)
                remapped.append(remap[idx])
            return tuple(merged), remapped

        models, midx = merge([t.models for t in traces],
                             [t.model_idx for t in traces])
        # an origin-less trace (empty vocabulary) folds in as origin ""
        if any(t.origins for t in traces):
            origins, oidx = merge([t.origins or ("",) for t in traces],
                                  [t.origin_idx for t in traces])
        else:
            origins, oidx = (), [t.origin_idx for t in traces]
        # same folding rule for tenants: tenant-less traces become ""
        if any(t.tenants for t in traces):
            tenants, tidx = merge([t.tenants or ("",) for t in traces],
                                  [t.tenant_idx for t in traces])
        else:
            tenants, tidx = (), [t.tenant_idx for t in traces]
        # attempt folds in as zeros for history-less traces
        if any(t.attempt is not None for t in traces):
            attempt = np.concatenate(
                [t.attempt if t.attempt is not None
                 else np.zeros(t.n, dtype=np.int32) for t in traces])
        else:
            attempt = None
        return Trace(
            np.concatenate([t.arrival for t in traces]),
            np.concatenate([t.prompt_len for t in traces]),
            np.concatenate([t.output_len for t in traces]),
            np.concatenate([t.interactive for t in traces]),
            np.concatenate([t.ttft_slo for t in traces]),
            np.concatenate([t.itl_slo for t in traces]),
            np.concatenate(midx), models,
            np.concatenate(oidx), origins,
            np.concatenate(tidx), tenants, attempt)

    # ----------------------------------------------------- materialization
    def materialize(self, lo: int = 0, hi: Optional[int] = None, *,
                    row0: Optional[int] = None) -> List[Request]:
        """Build ``Request`` objects for rows [lo, hi) — the only place the
        columnar plane crosses into per-object land. Batched callers (the
        event core's cursor) use the slice bounds to stay lazy.

        ``row0`` stamps ``Request.row`` with ledger row ids (``row0 + i``
        for slice position i) so the event core can record outcomes
        columnar; by default rows stay unstamped (-1).

        SLO objects are interned per distinct (ttft, itl) pair — a trace
        carries a handful of SLO classes across millions of rows, and one
        shared immutable-by-convention instance per class keeps the
        per-request build cost down.
        """
        hi = self.n if hi is None else min(hi, self.n)
        arr = self.arrival[lo:hi].tolist()
        ins = self.prompt_len[lo:hi].tolist()
        outs = self.output_len[lo:hi].tolist()
        inter = self.interactive[lo:hi].tolist()
        midx = self.model_idx[lo:hi].tolist()
        models = self.models
        origins = self.origins or None
        oidx = self.origin_idx[lo:hi].tolist()
        tenants = self.tenants or None
        tidx = self.tenant_idx[lo:hi].tolist()
        it, ba = RequestType.INTERACTIVE, RequestType.BATCH
        # SLO interning columnar: one unique pass over the (ttft, itl)
        # pair column — complex128 packs both float64 exactly, so equal
        # pairs collapse to one shared SLO object, same as the old
        # per-row dict intern but without a tuple-key lookup per row
        key = self.ttft_slo[lo:hi] + self.itl_slo[lo:hi] * 1j
        uniq, inv = np.unique(key, return_inverse=True)
        slo_objs = [SLO(u.real, u.imag) for u in uniq.tolist()]
        slo_col = [slo_objs[k] for k in inv.tolist()]
        rows = range(row0, row0 + (hi - lo)) if row0 is not None \
            else _NO_ROWS
        out = []
        # bulk construction bypasses the dataclass __init__ (measured ~3x
        # per-object): a dict literal covering every Request field becomes
        # the instance __dict__ directly. test_trace_plane pins this
        # against constructor-built requests so field drift fails loudly.
        new = Request.__new__
        next_id = request_id_counter().__next__
        append = out.append
        for t, p, o, c, m, g, tn, slo, rw in zip(arr, ins, outs, inter,
                                                 midx, oidx, tidx,
                                                 slo_col, rows):
            r = new(Request)
            # fields at their dataclass defaults (state, outcome slots,
            # preemptions, ...) are deliberately absent: the dataclass
            # stores plain defaults as class attributes, so reads fall
            # through and the first write creates the instance entry.
            # Only ``itl_samples`` has a mutable factory default and must
            # be per-instance from the start.
            r.__dict__ = {
                "prompt_len": p, "output_len": o,
                "request_type": it if c else ba, "slo": slo,
                "arrival_time": t, "req_id": next_id(),
                "model": models[m],
                "itl_samples": [],
                "row": rw,
            }
            if origins:
                r.__dict__["origin"] = origins[g]
            if tenants:
                r.__dict__["tenant"] = tenants[tn]
            append(r)
        if self.attempt is not None:
            # pre-consumed retry attempts (replayed overload trace):
            # only nonzero cells need an instance entry — zero reads
            # fall through to the class default
            for r, a in zip(out, self.attempt[lo:hi].tolist()):
                if a:
                    # mirror-sync: ok(no ledger exists yet - from_trace seeds the column from this array)
                    r.retries = a
        return out

    @classmethod
    def from_requests(cls, reqs: Sequence[Request]) -> "Trace":
        """Columnarize a request list (round-trip / legacy ingestion)."""
        models: List[str] = []
        origins: List[str] = []
        tenants: List[str] = []
        midx = np.empty(len(reqs), dtype=np.int32)
        oidx = np.zeros(len(reqs), dtype=np.int32)
        tidx = np.zeros(len(reqs), dtype=np.int32)
        for i, r in enumerate(reqs):
            if r.model not in models:
                models.append(r.model)
            midx[i] = models.index(r.model)
            if r.origin is not None:
                if r.origin not in origins:
                    origins.append(r.origin)
                oidx[i] = origins.index(r.origin)
            tenant = getattr(r, "tenant", None)
            if tenant is not None:
                if tenant not in tenants:
                    tenants.append(tenant)
                tidx[i] = tenants.index(tenant)
        attempt = np.array([r.retries for r in reqs], dtype=np.int32)
        return cls(
            np.array([r.arrival_time for r in reqs], dtype=np.float64),
            np.array([r.prompt_len for r in reqs], dtype=np.int64),
            np.array([r.output_len for r in reqs], dtype=np.int64),
            np.array([r.is_interactive for r in reqs], dtype=bool),
            np.array([r.slo.ttft for r in reqs], dtype=np.float64),
            np.array([r.slo.itl for r in reqs], dtype=np.float64),
            midx, tuple(models) or (DEFAULT_MODEL,),
            oidx, tuple(origins),
            tidx, tuple(tenants),
            attempt if attempt.any() else None)


def make_trace(arrival: np.ndarray, prompt_len: np.ndarray,
               output_len: np.ndarray, interactive: np.ndarray, *,
               ttft_slo: Union[float, np.ndarray, None] = None,
               itl_slo: Union[float, np.ndarray, None] = None,
               batch_ttft_slo: float = BATCH_TTFT_SLO,
               model_idx: Optional[np.ndarray] = None,
               models: Sequence[str] = (DEFAULT_MODEL,),
               origin_idx: Optional[np.ndarray] = None,
               origins: Sequence[str] = (),
               tenant_idx: Optional[np.ndarray] = None,
               tenants: Sequence[str] = (),
               attempt: Optional[np.ndarray] = None,
               sort: bool = True) -> Trace:
    """Assemble a Trace from columns, filling SLO columns from the class
    mask (interactive -> paper defaults; batch -> ``batch_ttft_slo``)."""
    interactive = np.asarray(interactive, dtype=bool)
    n = interactive.shape[0]
    if ttft_slo is None:
        ttft_slo = np.where(interactive, INTERACTIVE_TTFT_SLO, batch_ttft_slo)
    elif np.ndim(ttft_slo) == 0:        # Python or NumPy scalar: broadcast
        ttft_slo = np.full(n, float(ttft_slo))
    if itl_slo is None:
        itl_slo = np.where(interactive, INTERACTIVE_ITL_SLO, BATCH_ITL_SLO)
    elif np.ndim(itl_slo) == 0:
        itl_slo = np.full(n, float(itl_slo))
    if model_idx is None:
        model_idx = np.zeros(n, dtype=np.int32)
    tr = Trace(arrival, prompt_len, output_len, interactive,
               ttft_slo, itl_slo, model_idx, tuple(models),
               origin_idx, tuple(origins),
               tenant_idx, tuple(tenants), attempt)
    return tr.sorted_by_arrival() if sort else tr


class TraceStream:
    """Arrival-ordered stream of :class:`Trace` chunks.

    The windowed replay path for traces too large to hold columnar in
    memory: ``repro_torch.sim.trace_io.stream_trace`` yields file chunks, the
    event core's request cursor consumes them one at a time, and chunk
    boundaries are validated to be non-decreasing in arrival time (a
    streamed file must already be arrival-sorted — there is no global
    sort without the whole file).
    """

    def __init__(self, chunks):
        self._it = iter(chunks)
        self._last_t = -np.inf

    def __iter__(self):
        return self

    def __next__(self) -> Trace:
        chunk = next(self._it)
        while chunk.n == 0:
            chunk = next(self._it)
        chunk = chunk.sorted_by_arrival()   # sort BEFORE the boundary
        # check, or an unsorted chunk's early rows would sneak past it
        if float(chunk.arrival[0]) < self._last_t:
            raise ValueError(
                "TraceStream chunks are not globally arrival-sorted: chunk "
                f"starts at t={float(chunk.arrival[0]):.3f} after "
                f"t={self._last_t:.3f}")
        self._last_t = float(chunk.arrival[-1])
        return chunk


# ============================================================== generation
@dataclass
class WorkloadSpec:
    n_requests: int = 3500
    arrival_rate: float = 10.0        # requests/s
    interactive_frac: float = 1.0     # 1.0 = W_A; <1 adds batch requests
    process: str = "poisson"          # poisson | gamma
    cv: float = 1.0                   # Gamma coefficient of variation
    model: str = DEFAULT_MODEL
    batch_ttft_slo: float = 3600.0
    seed: int = 0
    # batch-queue mode (W_B): dump `batch_queue_size` batch requests at t=0
    batch_queue_size: int = 0


def _token_lengths(rng: np.random.Generator, n: int):
    ins = np.clip(rng.lognormal(INPUT_MU, INPUT_SIGMA, n), 4, MAX_TOKENS)
    outs = np.clip(rng.lognormal(OUTPUT_MU, OUTPUT_SIGMA, n), 4, MAX_TOKENS)
    return ins.astype(np.int64), outs.astype(np.int64)


def _interarrival(rng: np.random.Generator, spec: WorkloadSpec, n: int) -> np.ndarray:
    mean = 1.0 / max(spec.arrival_rate, 1e-9)
    if spec.process == "poisson":
        return rng.exponential(mean, n)
    # Gamma with CV: shape k = 1/cv^2, scale = mean*cv^2
    k = 1.0 / (spec.cv ** 2)
    return rng.gamma(k, mean * spec.cv ** 2, n)


def generate_trace(spec: WorkloadSpec) -> Trace:
    """Fully vectorized trace generation — no per-request Python work.

    Draw order matches the historical ``generate`` exactly (batch-queue
    token lengths, live token lengths, gaps, class coin flips) so seeds
    reproduce the same workloads they always did.
    """
    rng = np.random.default_rng(spec.seed)
    parts: List[Trace] = []

    if spec.batch_queue_size > 0:
        ins, outs = _token_lengths(rng, spec.batch_queue_size)
        parts.append(make_trace(
            np.zeros(spec.batch_queue_size), ins, outs,
            np.zeros(spec.batch_queue_size, dtype=bool),
            batch_ttft_slo=spec.batch_ttft_slo,
            models=(spec.model,), sort=False))

    n = spec.n_requests
    ins, outs = _token_lengths(rng, n)
    t = np.cumsum(_interarrival(rng, spec, n))
    classes = rng.random(n) < spec.interactive_frac
    parts.append(make_trace(t, ins, outs, classes,
                            batch_ttft_slo=spec.batch_ttft_slo,
                            models=(spec.model,), sort=False))
    out = parts[0] if len(parts) == 1 else Trace.concat(parts)
    return out.sorted_by_arrival()


def generate(spec: WorkloadSpec) -> List[Request]:
    """Historical API: generate and materialize (small/medium traces)."""
    return generate_trace(spec).materialize()


# ======================================================== arrival analysis
def _arrival_column(source) -> np.ndarray:
    """Arrival times from a Trace, an ndarray/sequence of floats, or a
    sequence of Request-likes (anything with ``.arrival_time``)."""
    if isinstance(source, Trace):
        return source.arrival
    if isinstance(source, np.ndarray):
        return source.astype(np.float64, copy=False)
    src = list(source)
    if not src:
        return np.empty(0)
    if hasattr(src[0], "arrival_time"):
        return np.fromiter((r.arrival_time for r in src), dtype=np.float64,
                           count=len(src))
    return np.asarray(src, dtype=np.float64)


def arrival_spikes(source, interval: float = 30.0) -> np.ndarray:
    """Paper §2.3: ratio of arrival rate between consecutive intervals of
    length = model load time. Used by the Theta-from-history heuristic.

    Vectorized: one ``np.bincount`` over the arrival column, a shifted
    ratio, and a mask — O(n + bins) with no per-request Python loop.
    """
    times = _arrival_column(source)
    if times.size == 0:
        return np.empty(0)
    counts = np.bincount((times / interval).astype(np.int64))
    prev, nxt = counts[:-1], counts[1:]
    mask = prev > 0
    return nxt[mask] / prev[mask]


def theta_from_history(source, interval: float = 30.0,
                       pct: float = 99.0) -> float:
    """Theta = 1 / tail-spike (paper §5.2 example: spike 3x -> Theta=1/3)."""
    spikes = arrival_spikes(source, interval)
    if spikes.size == 0:
        return 1.0 / 3.0
    tail = float(np.percentile(spikes, pct))
    return 1.0 / max(tail, 1.0)
