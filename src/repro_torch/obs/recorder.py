"""Flight recorder: struct-of-arrays telemetry plane for the simulators.

Three coordinated layers, all preallocated amortized-doubling columns
(the :class:`~repro_torch.sim.ledger.RequestLedger` growth idiom):

* **Control-plane time series** — one row per control tick per cluster
  (chips, per-type instance counts, loading/active registries, queue
  depths, KV aggregates, chip utilization) plus one row per (tick,
  cluster, model) with the Chiron signals exactly as the controller
  computed them: IBP, Theta, BBP, the QLM waiting-time estimate, and the
  per-model queue depths the decision read.

* **Decision ledger** — every scale-up/down, crash, degradation,
  recovery, batch eviction, model migration, saturation hand-back and
  residency drain, recorded with its inputs: which Algorithm 1/2 term
  fired (``reason``), the backpressure value and the threshold it
  crossed, chips before/after, model, cluster, instance type. The
  sequence is replayable — :meth:`FlightRecorder.replay` reconstructs
  ``RunResult`` scale counts exactly and
  :meth:`FlightRecorder.replay_instance_counts` rebuilds the per-type
  instance timeline the decision-equivalence tests pin.

* **Request-lifecycle spans** — sampled admit/preempt transitions with
  timestamps and instance ids. Sampling is a deterministic integer hash
  of the request row (no RNG, so runs are reproducible and the
  determinism auditor stays quiet); queued/prefill/decode/finish
  boundaries are joined from the request ledger at export time, so the
  hot path pays exactly two optional appends per request.

Gating mirrors ``repro_torch.analysis.shadow``: engines call :func:`resolve`
on their ``telemetry`` argument — a :class:`FlightRecorder` passes
through, ``True`` builds one, ``None`` consults ``CHIRON_TELEMETRY``.
When off every hook site costs one predicted ``obs is not None`` branch
and results are bit-identical to a build without the recorder.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

_NAN = float("nan")
_INF = float("inf")

# ---------------------------------------------------------------- codes
# int8 decision kinds (stable: rows round-trip through JSONL exports;
# new kinds append at the end so existing codes never shift)
(PROVISION, RETIRE, FAIL, DEGRADE, RECOVER, EVICT, MIGRATE, HANDBACK,
 DRAIN, OUTAGE, RESTORE, FLASH, REJECT, SHED, EXPIRE, BREAKER,
 BROWNOUT) = range(17)
KIND_NAMES = ("provision", "retire", "fail", "degrade", "recover",
              "evict", "migrate", "handback", "drain", "outage",
              "restore", "flash", "reject", "shed", "expire", "breaker",
              "brownout")

# int8 decision reasons: which control-law term fired. BOOTSTRAP covers
# warm starts and the controller's keep-a-foothold provisions (step 0);
# IBP_* are Algorithm 1's band exits, BBP_* Algorithm 2's branches;
# PREEMPT is interactive-over-batch eviction; INJECTED marks plan-driven
# failures/degradations; PLACEMENT marks fleet-tier residency moves;
# OUTAGE marks correlated zone-outage crashes and their staged restores;
# FLASH marks a flash-crowd onset. The overload plane's terms:
# INFEASIBLE (admission estimated the TTFT unreachable), DEADLINE (the
# queued request's deadline passed), RETRY_EXHAUSTED (client gave up),
# BREAKER (circuit-breaker transition), OVERLOAD (brownout hysteresis).
(R_BOOTSTRAP, R_IBP_HIGH, R_IBP_LOW, R_BBP_ADD, R_BBP_IDLE, R_BBP_TRIM,
 R_PREEMPT, R_INJECTED, R_PLACEMENT, R_OUTAGE, R_FLASH, R_INFEASIBLE,
 R_DEADLINE, R_RETRY_EXHAUSTED, R_BREAKER, R_OVERLOAD) = range(16)
REASON_NAMES = ("bootstrap", "ibp_high", "ibp_low", "bbp_add",
                "bbp_idle", "bbp_trim", "preempt", "injected",
                "placement", "outage", "flash", "infeasible", "deadline",
                "retry_exhausted", "breaker", "overload")

# int8 span events
SPAN_ADMIT, SPAN_PREEMPT = 0, 1
SPAN_NAMES = ("admit", "preempt")


class _Columns:
    """Amortized-doubling struct-of-arrays row store. Subclasses declare
    ``_COLUMNS`` as ``(name, dtype, fill)`` triples; ``append`` takes the
    values in declaration order.

    Writes are combined: ``append`` stages the row as a plain tuple and
    any read (``col``/``rows``) flushes the staging list into the numpy
    backing with one bulk slice assignment per column. Per-row hot-path
    cost is one tuple build + one list append; backing arrays at least
    double on overflow so N rows cost O(N) total copying."""

    __slots__ = ("_n", "_backing", "_cap", "_stage")
    _COLUMNS: tuple = ()

    def __init__(self):
        self._n = 0
        self._cap = 0
        self._backing: Dict[str, np.ndarray] = {}
        self._stage: list = []

    @property
    def n(self) -> int:
        return self._n + len(self._stage)

    def _reserve(self, extra: int) -> None:
        need = self._n + extra
        cap = self._cap
        if cap == 0:
            cap = max(need, 256)
            for name, dtype, fill in self._COLUMNS:
                self._backing[name] = np.full(cap, fill, dtype=dtype)
        elif need > cap:
            while cap < need:
                cap *= 2
            for name, dtype, fill in self._COLUMNS:
                back = np.full(cap, fill, dtype=dtype)
                back[:self._n] = self._backing[name][:self._n]
                self._backing[name] = back
        else:
            return
        self._cap = cap

    def append(self, *values) -> None:
        self._stage.append(values)

    def _flush(self) -> None:
        st = self._stage
        if not st:
            return
        k = len(st)
        self._reserve(k)
        i = self._n
        b = self._backing
        for j, (name, _, _) in enumerate(self._COLUMNS):
            b[name][i:i + k] = [row[j] for row in st]
        self._n = i + k
        st.clear()

    def col(self, name: str) -> np.ndarray:
        """Exact-length view of one column (flushes staged writes)."""
        self._flush()
        if self._cap == 0:
            for cname, dtype, _ in self._COLUMNS:
                if cname == name:
                    return np.empty(0, dtype=dtype)
            raise KeyError(name)
        return self._backing[name][:self._n]

    def column_names(self) -> List[str]:
        return [name for name, _, _ in self._COLUMNS]

    def rows(self):
        """Row dicts with plain Python scalars (export/CLI path — not for
        the hot loop)."""
        names = self.column_names()
        cols = [self.col(name) for name in names]
        for i in range(self.n):
            yield {name: col[i].item() for name, col in zip(names, cols)}


class SignalColumns(_Columns):
    """One row per (control tick, cluster, model): the Chiron inputs as
    the controller computed them. Instance counts are post-decision (the
    state the tick left behind); queue depths are what the decision
    read."""
    _COLUMNS = (
        ("t", np.float64, 0.0), ("cluster", np.int32, 0),
        ("model", np.int32, 0),
        ("q_interactive", np.int32, 0), ("q_batch", np.int32, 0),
        ("ibp", np.float64, _NAN), ("theta", np.float64, _NAN),
        ("bbp", np.int32, 0), ("wait_est", np.float64, _NAN),
        ("n_interactive", np.int32, 0), ("n_mixed", np.int32, 0),
        ("n_batch", np.int32, 0),
    )


class ClusterTickColumns(_Columns):
    """One row per (control tick, cluster): post-decision cluster-wide
    aggregates."""
    _COLUMNS = (
        ("t", np.float64, 0.0), ("cluster", np.int32, 0),
        ("chips", np.int32, 0),
        ("n_interactive", np.int32, 0), ("n_mixed", np.int32, 0),
        ("n_batch", np.int32, 0), ("n_loading", np.int32, 0),
        ("n_active", np.int32, 0),
        ("q_interactive", np.int32, 0), ("q_batch", np.int32, 0),
        ("kv_tokens", np.float64, 0.0),
        ("kv_utilization", np.float64, 0.0),
        ("utilization", np.float64, 0.0),
    )


class DecisionColumns(_Columns):
    """One row per control-plane action. ``value``/``threshold`` carry
    the fired term's backpressure reading and band edge (NaN when the
    action has no scalar input — e.g. injected failures); ``peer`` is
    the destination cluster of a hand-back (-1 otherwise); ``count`` is
    the multiplicity of aggregate actions (hand-back moves, drained
    requests)."""
    _COLUMNS = (
        ("t", np.float64, 0.0), ("cluster", np.int32, 0),
        ("kind", np.int8, 0), ("reason", np.int8, 0),
        ("model", np.int32, -1), ("itype", np.int8, -1),
        ("value", np.float64, _NAN), ("threshold", np.float64, _NAN),
        ("chips_before", np.int32, 0), ("chips_after", np.int32, 0),
        ("peer", np.int32, -1), ("count", np.int32, 1),
    )


class SpanColumns(_Columns):
    """Sampled request-lifecycle transitions (admit/preempt) by ledger
    row id; queued/first-token/finish anchors join from the request
    ledger at export time."""
    _COLUMNS = (
        ("t", np.float64, 0.0), ("row", np.int64, -1),
        ("event", np.int8, 0), ("instance", np.int32, -1),
    )


class FlightRecorder:
    """The run-scoped telemetry sink the engines attach to clusters,
    controllers and fleets (as their ``obs`` attribute) for the run's
    duration. All methods append O(1) rows; nothing here feeds back into
    simulation state.

    All column stores write-combine (see :class:`_Columns`), so the one
    per-request hot hook — ``record_span`` — costs an inlined sampling
    hash plus a single staged tuple append; the numpy columns
    materialize lazily on first read.

    ``span_sample`` defaults to head-based sampling at 25% — lifecycle
    spans are the only per-request (rather than per-tick) stream, and
    sampling them is what keeps full telemetry inside the <5% overhead
    budget the benchmark pins. Pass ``span_sample=1.0`` to trace every
    request (tests and small runs); the signal/tick/decision layers are
    always complete regardless."""

    __slots__ = ("signals", "cticks", "decisions", "spans", "_sp_stage",
                 "span_sample", "span_seed", "_span_limit", "_span_mix",
                 "cluster_names", "_cluster_codes",
                 "model_names", "_model_codes",
                 "itype_names", "_itype_codes",
                 "_ctx_reason", "_ctx_value", "_ctx_threshold",
                 "inj_reason")

    def __init__(self, *, span_sample: float = 0.25, span_seed: int = 0):
        self.signals = SignalColumns()
        self.cticks = ClusterTickColumns()
        self.decisions = DecisionColumns()
        self.spans = SpanColumns()
        # record_span bypasses the append() call; _flush clears this
        # list in place so the cached reference stays valid
        self._sp_stage = self.spans._stage
        self.span_sample = float(span_sample)
        self.span_seed = int(span_seed)
        # deterministic sampling: keep row iff a 32-bit multiplicative
        # hash of (row, seed) lands under sample_rate * 2^32 — no RNG,
        # so identical runs sample identical rows
        self._span_limit = int(min(max(self.span_sample, 0.0), 1.0)
                               * 2.0 ** 32)
        self._span_mix = (self.span_seed * 0x9E3779B9) & 0xFFFFFFFF
        self.cluster_names: List[str] = []
        self._cluster_codes: Dict[int, int] = {}
        self.model_names: List[str] = []
        self._model_codes: Dict[str, int] = {}
        self.itype_names: List[str] = []
        self._itype_codes: Dict[object, int] = {}
        self._ctx_reason = R_BOOTSTRAP
        self._ctx_value = _NAN
        self._ctx_threshold = _NAN
        # injection-reason context: FAIL rows default to plan-driven
        # crashes; the engines set R_OUTAGE around a correlated zone
        # outage so each victim's row carries the term that fired
        self.inj_reason = R_INJECTED

    # ------------------------------------------------------- vocabularies
    def register_cluster(self, cluster, name: str) -> int:
        """Bind a cluster object to a stable name/index (the engines call
        this at attach time; unknown clusters auto-register as ``c<i>``)."""
        code = self._cluster_codes.get(id(cluster))
        if code is None:
            code = self._cluster_codes[id(cluster)] = \
                len(self.cluster_names)
            self.cluster_names.append(name)
        return code

    def _cluster_code(self, cluster) -> int:
        code = self._cluster_codes.get(id(cluster))
        if code is None:
            code = self.register_cluster(
                cluster, f"c{len(self.cluster_names)}")
        return code

    def cluster_code_by_name(self, name: str) -> int:
        try:
            return self.cluster_names.index(name)
        except ValueError:
            self.cluster_names.append(name)
            return len(self.cluster_names) - 1

    def _model_code(self, model: Optional[str]) -> int:
        if model is None:
            return -1
        code = self._model_codes.get(model)
        if code is None:
            code = self._model_codes[model] = len(self.model_names)
            self.model_names.append(model)
        return code

    def _itype_code(self, itype) -> int:
        if itype is None:
            return -1
        code = self._itype_codes.get(itype)
        if code is None:
            code = self._itype_codes[itype] = len(self.itype_names)
            self.itype_names.append(
                getattr(itype, "name", str(itype)).lower())
        return code

    # ---------------------------------------------------- decision context
    # The controller sets which Algorithm 1/2 term is about to act (and
    # its backpressure/threshold reading) before a provision/retire loop;
    # the cluster-level hooks stamp the pending rows with it. Outside any
    # explicit context, actions are bootstrap/foothold provisions.
    def set_context(self, reason: int, value: float = _NAN,
                    threshold: float = _NAN) -> None:
        self._ctx_reason = reason
        self._ctx_value = value
        self._ctx_threshold = threshold

    def clear_context(self) -> None:
        self._ctx_reason = R_BOOTSTRAP
        self._ctx_value = _NAN
        self._ctx_threshold = _NAN

    # ------------------------------------------------------ decision hooks
    def record_provision(self, cluster, now: float, model: str, itype,
                         chips_before: int, chips_after: int) -> None:
        self.decisions.append(now, self._cluster_code(cluster), PROVISION,
                              self._ctx_reason, self._model_code(model),
                              self._itype_code(itype), self._ctx_value,
                              self._ctx_threshold, chips_before,
                              chips_after, -1, 1)

    def record_retire(self, cluster, now: float, inst,
                      chips_before: int, chips_after: int) -> None:
        self.decisions.append(now, self._cluster_code(cluster), RETIRE,
                              self._ctx_reason,
                              self._model_code(inst.model),
                              self._itype_code(inst.itype),
                              self._ctx_value, self._ctx_threshold,
                              chips_before, chips_after, -1, 1)

    def record_fail(self, cluster, now: float, inst,
                    chips_before: int, chips_after: int) -> None:
        self.decisions.append(now, self._cluster_code(cluster), FAIL,
                              self.inj_reason,
                              self._model_code(inst.model),
                              self._itype_code(inst.itype), _NAN, _NAN,
                              chips_before, chips_after, -1, 1)

    def record_outage(self, cluster, now: float, victims: int,
                      withheld_chips: int) -> None:
        """Correlated zone-outage onset: one row with the victim count
        (``count``) and the chip budget withheld (``value``); each
        victim's crash still lands as its own FAIL row (stamped
        ``R_OUTAGE`` via ``inj_reason``)."""
        chips = cluster.used_chips()
        self.decisions.append(now, self._cluster_code(cluster), OUTAGE,
                              R_OUTAGE, -1, -1, float(withheld_chips),
                              _NAN, chips, chips, -1, victims)

    def record_restore(self, cluster, now: float, chips_back: int) -> None:
        """One staged tranche of withheld outage capacity returning."""
        chips = cluster.used_chips()
        self.decisions.append(now, self._cluster_code(cluster), RESTORE,
                              R_OUTAGE, -1, -1, float(chips_back), _NAN,
                              chips, chips, -1, 1)

    def record_flash_crowd(self, cluster, now: float, model: str) -> None:
        """Flash-crowd onset marker (the shock arrivals ride the trace)."""
        chips = cluster.used_chips()
        self.decisions.append(now, self._cluster_code(cluster), FLASH,
                              R_FLASH, self._model_code(model), -1, _NAN,
                              _NAN, chips, chips, -1, 1)

    def record_degrade(self, cluster, now: float, inst,
                       factor: float) -> None:
        chips = cluster.used_chips()
        self.decisions.append(now, self._cluster_code(cluster), DEGRADE,
                              R_INJECTED, self._model_code(inst.model),
                              self._itype_code(inst.itype), factor, _NAN,
                              chips, chips, -1, 1)

    def record_recover(self, cluster, now: float, inst) -> None:
        chips = cluster.used_chips()
        self.decisions.append(now, self._cluster_code(cluster), RECOVER,
                              R_INJECTED, self._model_code(inst.model),
                              self._itype_code(inst.itype), _NAN, _NAN,
                              chips, chips, -1, 1)

    def record_evict(self, cluster, now: float, req, inst) -> None:
        """Interactive-over-batch preemption: one decision row (the saved
        KV size as ``value``) plus a sampled preempt span."""
        chips = cluster.used_chips()
        saved = req.saved_kv[1] if req.saved_kv is not None else _NAN
        self.decisions.append(now, self._cluster_code(cluster), EVICT,
                              R_PREEMPT, self._model_code(req.model),
                              self._itype_code(inst.itype), saved, _NAN,
                              chips, chips, -1, 1)
        self.record_span(now, req.row, SPAN_PREEMPT, inst.id)

    def record_migration(self, now: float, cluster_name: str, model: str,
                         delay: float) -> None:
        self.decisions.append(now, self.cluster_code_by_name(cluster_name),
                              MIGRATE, R_PLACEMENT,
                              self._model_code(model), -1, delay, _NAN,
                              0, 0, -1, 1)

    def record_handback(self, now: float, src_name: str, dst_name: str,
                        model: str, moved: int) -> None:
        self.decisions.append(now, self.cluster_code_by_name(src_name),
                              HANDBACK, R_PLACEMENT,
                              self._model_code(model), -1, _NAN, _NAN,
                              0, 0, self.cluster_code_by_name(dst_name),
                              moved)

    def record_drain(self, now: float, cluster_name: str, model: str,
                     moved: int) -> None:
        self.decisions.append(now, self.cluster_code_by_name(cluster_name),
                              DRAIN, R_PLACEMENT, self._model_code(model),
                              -1, _NAN, _NAN, 0, 0, -1, moved)

    # ------------------------------------------------------ overload hooks
    def record_reject(self, cluster, now: float, model: str,
                      wait_est: float, budget: float,
                      reason: int = R_INFEASIBLE) -> None:
        """Admission refusal: the estimated wait (``value``) against the
        TTFT budget it blew (``threshold``); ``reason`` carries the term
        that fired (INFEASIBLE at admission, RETRY_EXHAUSTED when the
        client abandoned after its last attempt)."""
        chips = cluster.used_chips()
        self.decisions.append(now, self._cluster_code(cluster), REJECT,
                              reason, self._model_code(model), -1,
                              wait_est, budget, chips, chips, -1, 1)

    def record_shed(self, cluster, now: float, model: str,
                    count: int) -> None:
        """Brownout shed sweep: ``count`` queued interactive requests of
        ``model`` dropped as infeasible."""
        chips = cluster.used_chips()
        self.decisions.append(now, self._cluster_code(cluster), SHED,
                              R_OVERLOAD, self._model_code(model), -1,
                              _NAN, _NAN, chips, chips, -1, count)

    def record_expire(self, cluster, now: float, model: str,
                      count: int) -> None:
        """Deadline sweep: ``count`` queued interactive requests whose
        deadline passed before service."""
        chips = cluster.used_chips()
        self.decisions.append(now, self._cluster_code(cluster), EXPIRE,
                              R_DEADLINE, self._model_code(model), -1,
                              _NAN, _NAN, chips, chips, -1, count)

    def record_breaker(self, now: float, cluster_name: str,
                       state_code: int, ewma: float,
                       threshold: float) -> None:
        """Circuit-breaker transition: the new state lands in ``itype``
        (0 closed / 1 half-open / 2 open — breaker rows carry no
        instance type) with the rejection EWMA and trip threshold."""
        self.decisions.append(now, self.cluster_code_by_name(cluster_name),
                              BREAKER, R_BREAKER, -1, state_code, ewma,
                              threshold, 0, 0, -1, 1)

    def record_brownout(self, cluster, now: float, entered: bool,
                        depth: int, threshold: float) -> None:
        """Brownout enter (``itype`` 1) / exit (``itype`` 0) with the
        interactive backlog that tripped the hysteresis."""
        chips = cluster.used_chips()
        self.decisions.append(now, self._cluster_code(cluster), BROWNOUT,
                              R_OVERLOAD, -1, 1 if entered else 0,
                              float(depth), threshold, chips, chips,
                              -1, 1)

    # ---------------------------------------------------------- tick hooks
    def record_signals(self, now: float, cluster, model: str,
                       ibp: float, theta: float, bbp: int,
                       wait_est: float, q_interactive: int, q_batch: int,
                       n_interactive: int, n_mixed: int,
                       n_batch: int) -> None:
        # staged directly (bypassing append()) — per (tick, cluster,
        # model) hot site; also closes the tick's decision context (the
        # signals row is the last thing a scale pass records)
        self.signals._stage.append(
            (now, self._cluster_code(cluster), self._model_code(model),
             q_interactive, q_batch, ibp, theta, bbp, wait_est,
             n_interactive, n_mixed, n_batch))
        self._ctx_reason = R_BOOTSTRAP
        self._ctx_value = _NAN
        self._ctx_threshold = _NAN

    def record_cluster_tick(self, now: float, cluster, queue) -> None:
        kv = 0.0
        kv_util = 0.0
        act = cluster._active
        n_act = len(act)
        inf = _INF
        # inlined SimInstance.kv_tokens / kv_utilization (per control
        # tick x per active instance — the recorder's second-hottest
        # site); instances inherit the cluster's mode at provision so
        # the branch hoists out of the loop
        if cluster.event_mode:
            for inst in act.values():
                k = inst._kv_prefill + inst._kv_dec_base \
                    + inst._n_dec * inst.vclock
                kv += k
                cap = inst._c_cap
                kv_util += k / cap if cap != inf \
                    else len(inst.running) / (inst.max_batch_size or 1)
        else:
            for inst in act.values():
                k = inst._kv_tokens
                kv += k
                cap = inst._c_cap
                kv_util += k / cap if cap != inf \
                    else len(inst.running) / (inst.max_batch_size or 1)
        n_i, n_m, n_b = cluster.counts_by_type()
        chips = cluster._used_chips
        self.cticks._stage.append(
            (now, self._cluster_code(cluster), chips,
             n_i, n_m, n_b, cluster.n_loading, n_act,
             queue.n_interactive, queue.n_batch, kv,
             kv_util / n_act if n_act else 0.0,
             chips / cluster.max_chips if cluster.max_chips else 0.0))

    # --------------------------------------------------------------- spans
    def sampled(self, row: int) -> bool:
        """Deterministic per-row sampling verdict (Knuth multiplicative
        hash over the 32-bit ring; seed shifts the subset)."""
        if row < 0:
            return False
        h = ((row + 1) * 2654435761 + self._span_mix) & 0xFFFFFFFF
        return h < self._span_limit

    def record_span(self, now: float, row: int, event: int,
                    inst_id: int) -> None:
        # the one per-request hot hook (once per admit/preempt): inlined
        # sampling hash, then one staged tuple append
        if row < 0 or ((row + 1) * 2654435761 + self._span_mix) \
                & 0xFFFFFFFF >= self._span_limit:
            return
        self._sp_stage.append((now, row, event, inst_id))

    def record_admit(self, now: float, row: int, inst_id: int) -> None:
        self.record_span(now, row, SPAN_ADMIT, inst_id)

    # -------------------------------------------------------------- replay
    def replay(self) -> Dict[str, int]:
        """Reconstruct the run's scale-action totals from the decision
        ledger alone. Matches ``RunResult`` exactly: every provision (warm
        start, bootstrap, IBP/BBP) and every retire/fail/degrade goes
        through the recorded cluster hooks."""
        kinds = self.decisions.col("kind")
        counts = np.bincount(kinds, minlength=len(KIND_NAMES))
        weights = self.decisions.col("count")
        return {
            "scale_ups": int(counts[PROVISION]),
            "scale_downs": int(counts[RETIRE]),
            "failures": int(counts[FAIL]),
            "degradations": int(counts[DEGRADE]),
            "evictions": int(counts[EVICT]),
            "migrations": int(counts[MIGRATE]),
            "handbacks": int(weights[kinds == HANDBACK].sum()),
            "drains": int(counts[DRAIN]),
            "outages": int(counts[OUTAGE]),
            "restores": int(counts[RESTORE]),
            "flash_crowds": int(counts[FLASH]),
            "rejections": int(counts[REJECT]),
            "sheds": int(weights[kinds == SHED].sum()),
            "expirations": int(weights[kinds == EXPIRE].sum()),
            "breaker_trips": int(np.count_nonzero(
                (kinds == BREAKER)
                & (self.decisions.col("itype") == 2))),
            "brownouts": int(np.count_nonzero(
                (kinds == BROWNOUT)
                & (self.decisions.col("itype") == 1))),
        }

    def replay_instance_counts(self, times) -> np.ndarray:
        """Rebuild the fleet-wide per-type instance timeline from the
        decision ledger: (len(times), 3) array of (interactive, mixed,
        batch) counts at each query time — provisions count immediately
        (``counts_by_type`` includes LOADING instances), retires and
        crashes subtract at their decision time. Equals the recorded
        ``RunResult.timeline`` columns when evaluated at the sample
        times."""
        times = np.asarray(times, dtype=np.float64)
        out = np.zeros((times.size, 3), dtype=np.int64)
        kinds = self.decisions.col("kind")
        t_dec = self.decisions.col("t")
        itypes = self.decisions.col("itype")
        class_of = {name: i for i, name in
                    enumerate(("interactive", "mixed", "batch"))}
        for code, name in enumerate(self.itype_names):
            cls = class_of.get(name)
            if cls is None:
                continue
            sel = itypes == code
            adds = t_dec[sel & (kinds == PROVISION)]
            subs = t_dec[sel & ((kinds == RETIRE) | (kinds == FAIL))]
            out[:, cls] = (np.searchsorted(adds, times, side="right")
                           - np.searchsorted(subs, times, side="right"))
        return out


def resolve(telemetry) -> Optional[FlightRecorder]:
    """Normalize the engines' ``telemetry`` argument: a recorder passes
    through, ``True`` builds one, ``None`` consults the
    ``CHIRON_TELEMETRY`` environment variable."""
    if isinstance(telemetry, FlightRecorder):
        return telemetry
    if telemetry is None:
        import os
        telemetry = os.environ.get("CHIRON_TELEMETRY", "") \
            not in ("", "0", "false", "no")
    return FlightRecorder() if telemetry else None
