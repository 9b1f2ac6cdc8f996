"""Experiment metrics: SLO attainment, throughput, GPU efficiency,
hysteresis — plus per-cluster/per-region rollups for fleet runs.

When a run carries a :class:`repro_torch.sim.ledger.RequestLedger` (the event
engines always install one), every aggregate — SLO attainment, per-model
rollups, completion rate, token totals, mean ITL, TTFT percentiles — is a
vectorized reduction over the ledger columns instead of a Python loop
over a million ``Request`` objects; the object path is kept as the
reference for ledger-less runs (fixed tick, hand-built results)."""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.serving.request import Request, RequestState, RequestType
from repro_torch.sim.ledger import (EXPIRED, FINISHED, REJECTED, RequestLedger,
                                    SHED)


@dataclass
class TimelinePoint:
    t: float
    n_interactive: int
    n_mixed: int
    n_batch: int
    chips: int
    q_interactive: int
    q_batch: int
    tokens_per_s: float


class Timeline:
    """Columnar run timeline: one struct-of-arrays row per sample
    (amortized-doubling backing, the :class:`RequestLedger` idiom)
    instead of a ``TimelinePoint`` object per sample, plus per-model
    queue-depth columns the flat tuple could not express.

    The object view survives for back-compat: iteration, indexing
    (negative included) and slicing materialize :class:`TimelinePoint`
    views lazily, so ``timeline[-1].t`` and every existing consumer keep
    working; vectorized consumers read :meth:`col` directly."""

    _COLUMNS = (
        ("t", np.float64, 0.0), ("n_interactive", np.int32, 0),
        ("n_mixed", np.int32, 0), ("n_batch", np.int32, 0),
        ("chips", np.int32, 0), ("q_interactive", np.int32, 0),
        ("q_batch", np.int32, 0), ("tokens_per_s", np.float64, 0.0),
    )
    __slots__ = ("n", "_cap", "_backing", "_q_int_models",
                 "_q_batch_models")

    def __init__(self):
        self.n = 0
        self._cap = 0
        self._backing: Dict[str, np.ndarray] = {}
        # model -> per-sample queue-depth column; created zero-filled on
        # a model's first nonzero depth (rows before that are correctly
        # zero — the lane did not exist yet)
        self._q_int_models: Dict[str, np.ndarray] = {}
        self._q_batch_models: Dict[str, np.ndarray] = {}

    def _reserve(self, extra: int) -> None:
        need = self.n + extra
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
                back[:self.n] = self._backing[name][:self.n]
                self._backing[name] = back
            for store in (self._q_int_models, self._q_batch_models):
                for m, col in store.items():
                    back = np.zeros(cap, dtype=np.int32)
                    back[:self.n] = col[:self.n]
                    store[m] = back
        else:
            return
        self._cap = cap

    def append_sample(self, t: float, n_interactive: int, n_mixed: int,
                      n_batch: int, chips: int, q_interactive: int,
                      q_batch: int, tokens_per_s: float, *,
                      q_interactive_by_model=None,
                      q_batch_by_model=None) -> None:
        self._reserve(1)
        i = self.n
        b = self._backing
        b["t"][i] = t
        b["n_interactive"][i] = n_interactive
        b["n_mixed"][i] = n_mixed
        b["n_batch"][i] = n_batch
        b["chips"][i] = chips
        b["q_interactive"][i] = q_interactive
        b["q_batch"][i] = q_batch
        b["tokens_per_s"][i] = tokens_per_s
        if q_interactive_by_model:
            self._set_depths(self._q_int_models, q_interactive_by_model, i)
        if q_batch_by_model:
            self._set_depths(self._q_batch_models, q_batch_by_model, i)
        self.n = i + 1

    def _set_depths(self, store: Dict[str, np.ndarray],
                    depths: Dict[str, int], i: int) -> None:
        for m, v in depths.items():
            col = store.get(m)
            if col is None:
                col = store[m] = np.zeros(self._cap, dtype=np.int32)
            col[i] = v

    # ------------------------------------------------------- column views
    def col(self, name: str) -> np.ndarray:
        """Exact-length view of one aggregate column."""
        if self._cap == 0:
            for cname, dtype, _ in self._COLUMNS:
                if cname == name:
                    return np.empty(0, dtype=dtype)
            raise KeyError(name)
        return self._backing[name][:self.n]

    def queue_models(self) -> List[str]:
        """Models with a per-model queue-depth column, sorted."""
        return sorted(set(self._q_int_models) | set(self._q_batch_models))

    def q_interactive_for(self, model: str) -> np.ndarray:
        col = self._q_int_models.get(model)
        return np.zeros(self.n, dtype=np.int32) if col is None \
            else col[:self.n]

    def q_batch_for(self, model: str) -> np.ndarray:
        col = self._q_batch_models.get(model)
        return np.zeros(self.n, dtype=np.int32) if col is None \
            else col[:self.n]

    # ----------------------------------------------- object view (compat)
    def _point(self, i: int) -> TimelinePoint:
        b = self._backing
        return TimelinePoint(
            float(b["t"][i]), int(b["n_interactive"][i]),
            int(b["n_mixed"][i]), int(b["n_batch"][i]),
            int(b["chips"][i]), int(b["q_interactive"][i]),
            int(b["q_batch"][i]), float(b["tokens_per_s"][i]))

    def __len__(self) -> int:
        return self.n

    def __iter__(self):
        for i in range(self.n):
            yield self._point(i)

    def __getitem__(self, i):
        if isinstance(i, slice):
            return [self._point(j) for j in range(*i.indices(self.n))]
        if i < 0:
            i += self.n
        if not 0 <= i < self.n:
            raise IndexError("timeline index out of range")
        return self._point(i)


@dataclass(frozen=True)
class Shock:
    """One injected chaos window (zone outage / flash crowd) carried on
    ``RunResult.shocks`` — :meth:`RunResult.recovery_metrics` scores the
    run's behaviour per shock."""
    kind: str            # "outage" | "flash_crowd"
    t0: float            # injection onset
    t1: float            # end of injection (capacity restored / ramp over)
    label: str = ""      # victim cluster name or the shock model


@dataclass
class ClusterStats:
    """Per-cluster rollup of a fleet run (attributed at completion time —
    the cluster whose instance finished the request gets the credit)."""
    name: str
    region: str = ""
    accelerator: str = ""
    cost_per_chip_hour: float = 1.0
    chip_seconds: float = 0.0
    peak_chips: int = 0
    scale_ups: int = 0
    scale_downs: int = 0
    failures: int = 0
    degradations: int = 0
    served_interactive: int = 0
    served_batch: int = 0
    slo_met_interactive: int = 0
    slo_met_batch: int = 0
    # cross-region assignment events (routing, drain re-routes, and
    # saturation hand-offs each count — a re-routed request's prompt
    # crosses a region boundary again, so it may tally more than once)
    remote_served: int = 0
    migrations_in: int = 0        # model placements copied into here
    migrations_out: int = 0       # placements drained away
    handbacks: int = 0            # saturated-queue work re-routed elsewhere
    egress_bytes: float = 0.0     # bytes this cluster's region sent out

    def gpu_hours(self) -> float:
        return self.chip_seconds / 3600.0

    def cost_usd(self) -> float:
        return self.gpu_hours() * self.cost_per_chip_hour

    def slo_interactive(self) -> float:
        return self.slo_met_interactive / self.served_interactive \
            if self.served_interactive else 1.0

    def slo_batch(self) -> float:
        return self.slo_met_batch / self.served_batch \
            if self.served_batch else 1.0


@dataclass
class RunResult:
    requests: List[Request]
    timeline: List[TimelinePoint]
    chip_seconds: float
    peak_chips: int
    scale_ups: int
    scale_downs: int
    duration: float
    failures: int = 0               # injected instance crashes
    n_events: int = 0               # event-core loop events (0: fixed tick)
    degradations: int = 0           # injected slow-node events
    skipped_injections: int = 0     # chaos events with no eligible victim
    # injected chaos windows (outages / flash crowds) this run carried;
    # recovery_metrics() scores each one
    shocks: List[Shock] = field(default_factory=list)
    # columnar outcome store (event-core runs); aggregate metrics reduce
    # over it vectorized instead of walking ``requests``
    ledger: Optional[RequestLedger] = None
    # flight recorder (repro_torch.obs.FlightRecorder) when the run was made
    # with telemetry on; None otherwise
    telemetry: Optional[object] = None
    # --- fleet runs (simulate_fleet) ---
    clusters: List[ClusterStats] = field(default_factory=list)
    migrations: int = 0             # placement copies scheduled
    handbacks: int = 0              # saturated work re-routed
    egress_bytes: float = 0.0       # cross-region bytes (weights + tokens)
    egress_cost_usd: float = 0.0

    # ------------------------------------------------------------ SLOs
    def _done(self, rtype=None, model=None) -> List[Request]:
        rs = [r for r in self.requests
              if (rtype is None or r.request_type == rtype)
              and (model is None or r.model == model)]
        return rs

    def models(self) -> List[str]:
        """Distinct request models in first-appearance order."""
        if self.ledger is not None:
            led = self.ledger
            if not led.n:
                return []
            _, first = np.unique(led.model_idx, return_index=True)
            return [led.models[int(led.model_idx[i])]
                    for i in np.sort(first)]
        seen: Dict[str, None] = {}
        for r in self.requests:
            seen.setdefault(r.model)
        return list(seen)

    def slo_by_model(self) -> Dict[str, float]:
        """Per-model SLO attainment (one vectorized pass)."""
        if self.ledger is not None:
            return self.ledger.slo_by_model()
        met: Dict[str, int] = {}
        tot: Dict[str, int] = {}
        for r in self.requests:
            tot[r.model] = tot.get(r.model, 0) + 1
            if r.slo_met():
                met[r.model] = met.get(r.model, 0) + 1
        return {m: met.get(m, 0) / n for m, n in tot.items()}

    def slo_attainment(self, rtype=None) -> float:
        if self.ledger is not None:
            return self.ledger.slo_attainment(rtype)
        rs = self._done(rtype)
        if not rs:
            return 1.0
        return sum(r.slo_met() for r in rs) / len(rs)

    def ttft_attainment(self, rtype=None) -> float:
        if self.ledger is not None:
            led = self.ledger
            mask = led.class_mask(rtype)
            ok = led.finished_mask() & led.ttft_met_mask()
            tot = led.n if mask is None else int(np.count_nonzero(mask))
            if not tot:
                return 1.0
            if mask is not None:
                ok = ok & mask
            return float(np.count_nonzero(ok)) / tot
        rs = self._done(rtype)
        if not rs:
            return 1.0
        return sum(1 for r in rs
                   if r.state == RequestState.FINISHED and r.ttft_met()) / len(rs)

    def completion_rate(self) -> float:
        if self.ledger is not None:
            led = self.ledger
            if not led.n:
                return 1.0
            return float(np.count_nonzero(led.state == FINISHED)) / led.n
        if not self.requests:
            return 1.0
        return sum(r.state == RequestState.FINISHED
                   for r in self.requests) / len(self.requests)

    # -------------------------------------------------- overload currency
    def goodput(self, rtype=None) -> float:
        """SLO-met completions per second — the overload plane's
        currency. Rejected/shed/expired requests and SLO-blown
        completions all fall out of the numerator; admission control
        earns its keep by keeping this up while the raw completion rate
        drops."""
        if not self.duration:
            return 0.0
        if self.ledger is not None:
            return self.ledger.goodput(self.duration, rtype)
        good = sum(1 for r in self._done(rtype)
                   if r.state == RequestState.FINISHED and r.slo_met())
        return good / self.duration

    def outcome_rates(self) -> Dict[str, float]:
        """Fractions of all submitted requests per terminal outcome:
        ``reject_rate`` / ``shed_rate`` / ``expired_rate``. All three are
        0.0 on runs without the overload plane, so the keys are stable
        across configurations (trend tooling diffs them directly)."""
        if self.ledger is not None and self.ledger.n:
            counts = self.ledger.state_counts()
            n = self.ledger.n
            return {"reject_rate": int(counts[REJECTED]) / n,
                    "shed_rate": int(counts[SHED]) / n,
                    "expired_rate": int(counts[EXPIRED]) / n}
        n = len(self.requests)
        if not n:
            return {"reject_rate": 0.0, "shed_rate": 0.0,
                    "expired_rate": 0.0}
        states = [r.state for r in self.requests]
        return {
            "reject_rate": states.count(RequestState.REJECTED) / n,
            "shed_rate": states.count(RequestState.SHED) / n,
            "expired_rate": states.count(RequestState.EXPIRED) / n,
        }

    # ------------------------------------------------------------ thr/eff
    def total_tokens(self) -> int:
        if self.ledger is not None:
            return int(self.ledger.tokens_generated.sum())
        return sum(r.tokens_generated for r in self.requests)

    def request_throughput(self) -> float:
        if not self.duration:
            return 0.0
        if self.ledger is not None:
            return float(np.count_nonzero(
                self.ledger.state == FINISHED)) / self.duration
        done = [r for r in self.requests if r.state == RequestState.FINISHED]
        return len(done) / self.duration

    def per_instance_throughput(self) -> float:
        """Mean tokens/s per active instance over the run."""
        if not self.timeline:
            return 0.0
        samples = [(p.tokens_per_s, p.n_interactive + p.n_mixed + p.n_batch)
                   for p in self.timeline if
                   (p.n_interactive + p.n_mixed + p.n_batch) > 0]
        if not samples:
            return 0.0
        return sum(t / n for t, n in samples) / len(samples)

    def gpu_hours(self) -> float:
        return self.chip_seconds / 3600.0

    @property
    def hysteresis(self) -> float:
        if self.scale_ups == 0:
            return 0.0
        return (self.scale_ups + self.scale_downs) / self.scale_ups

    def mean_itl(self, rtype=None) -> float:
        if self.ledger is not None:
            led = self.ledger
            mi = led.mean_itl
            mask = ~np.isnan(mi)
            cm = led.class_mask(rtype)
            if cm is not None:
                mask = mask & cm
            if not mask.any():
                return 0.0
            return float(np.mean(mi[mask]))
        rs = [r for r in self._done(rtype) if r.itl_samples]
        if not rs:
            return 0.0
        vals = [sum(r.itl_samples) / len(r.itl_samples) for r in rs]
        return sum(vals) / len(vals)

    def p99_ttft(self, rtype=None) -> float:
        if self.ledger is not None:
            led = self.ledger
            ftt = led.first_token_time
            mask = ~np.isnan(ftt)
            cm = led.class_mask(rtype)
            if cm is not None:
                mask = mask & cm
            if not mask.any():
                return 0.0
            ttfts = np.sort(ftt[mask] - led.arrival[mask])
            return float(ttfts[min(int(0.99 * ttfts.size), ttfts.size - 1)])
        ttfts = sorted(r.ttft for r in self._done(rtype) if r.ttft is not None)
        if not ttfts:
            return 0.0
        return ttfts[min(int(0.99 * len(ttfts)), len(ttfts) - 1)]

    def instance_counts_at(self, t: float) -> Tuple[int, int, int]:
        """(interactive, mixed, batch) instance counts at time ``t``
        (stepwise-left over the timeline samples)."""
        tl = self.timeline
        if isinstance(tl, Timeline):
            # columnar fast path, bit-identical to the stepwise-left scan:
            # index of the last sample with sample.t <= t
            i = int(np.searchsorted(tl.col("t"), t, side="right")) - 1
            if i < 0:
                return (0, 0, 0)
            return (int(tl.col("n_interactive")[i]),
                    int(tl.col("n_mixed")[i]),
                    int(tl.col("n_batch")[i]))
        last = (0, 0, 0)
        for p in tl:
            if p.t > t:
                break
            last = (p.n_interactive, p.n_mixed, p.n_batch)
        return last

    def recovery_metrics(self, *, bin_s: float = 30.0,
                         epsilon: float = 0.02,
                         baseline_window: float = 600.0) -> List[Dict]:
        """Per-shock recovery scorecard, vectorized off the ledger and
        timeline columns. For each :class:`Shock` in ``shocks``:

        - ``baseline_attainment``: SLO attainment over arrivals in the
          ``baseline_window`` seconds before onset.
        - ``max_attainment_dip``: baseline minus the worst ``bin_s``
          attainment bin at/after onset (0.0 when attainment held).
        - ``time_to_recover_s``: seconds from onset until binned
          attainment is back within ``epsilon`` of baseline *and stays
          there* (end of the last populated bin below the band); 0.0
          when attainment never left the band, -1.0 when it has not
          recovered by end of run.
        - ``recovered``: explicit boolean companion to the -1.0
          sentinel — ``False`` exactly when the run ended still below
          the recovery band, so scorecard consumers never have to
          compare against the sentinel.
        - ``time_to_detect_s``: seconds from onset until the control
          plane visibly reacts — the first timeline sample where the
          live-instance count rises above its running minimum since
          onset (re-provisioning after an outage) or above the onset
          count (scale-out into a flash crowd); -1.0 if it never does.
        - attainment over arrivals inside the shock window [t0, t1]:
          overall, per SLO class (interactive / batch), and per tenant
          when the trace carries a tenant column.

        Needs the columnar ledger (event-engine runs); returns ``[]``
        for ledger-less or shock-free runs."""
        led = self.ledger
        if led is None or not led.n or not self.shocks:
            return []
        arrival = led.arrival
        met = led.slo_met_mask().astype(np.float64)
        nbins = max(int(max(self.duration, float(arrival[-1])) / bin_s)
                    + 1, 1)
        bins = np.minimum((arrival / bin_s).astype(np.int64), nbins - 1)
        tot = np.bincount(bins, minlength=nbins)
        hit = np.bincount(bins, weights=met, minlength=nbins)
        have = tot > 0
        # NaN-safe division: an overload run can shed every arrival in a
        # bin (hit=0, attainment 0.0, still populated); the guarded form
        # also keeps any upstream NaN weight from poisoning the bin
        with np.errstate(invalid="ignore", divide="ignore"):
            att = np.where(have, hit / np.maximum(tot, 1), 1.0)
        att = np.nan_to_num(att, nan=0.0)
        interactive = led.interactive.astype(bool)
        tl = self.timeline
        if isinstance(tl, Timeline) and len(tl):
            tl_t = tl.col("t")
            tl_n = (tl.col("n_interactive").astype(np.int64)
                    + tl.col("n_mixed") + tl.col("n_batch"))
        else:
            tl_t = np.empty(0)
            tl_n = np.empty(0, dtype=np.int64)

        def _att(mask: np.ndarray) -> float:
            if not mask.any():
                return 1.0
            v = float(met[mask].mean())
            return v if np.isfinite(v) else 0.0

        out: List[Dict] = []
        for shock in self.shocks:
            t0, t1 = shock.t0, shock.t1
            pre = (arrival >= t0 - baseline_window) & (arrival < t0)
            baseline = _att(pre)
            b0 = min(int(t0 / bin_s), nbins)
            post_have = have.copy()
            post_have[:b0] = False
            vals = att[post_have]
            max_dip = float(max(0.0, baseline - vals.min())) \
                if vals.size else 0.0
            low = post_have & (att < baseline - epsilon)
            if not low.any():
                ttr = 0.0
            else:
                last_low = int(np.nonzero(low)[0][-1])
                last_pop = int(np.nonzero(have)[0][-1])
                # still below the band in the final populated bin: the
                # run ended before attainment came back
                ttr = -1.0 if last_low >= last_pop \
                    else float((last_low + 1) * bin_s - t0)
            ttd = -1.0
            if tl_t.size:
                i0 = int(np.searchsorted(tl_t, t0, side="right")) - 1
                n0 = int(tl_n[i0]) if i0 >= 0 else 0
                post = np.nonzero(tl_t > t0)[0]
                if post.size:
                    seg = tl_n[post]
                    runmin = np.minimum.accumulate(np.minimum(seg, n0))
                    react = np.nonzero(seg > runmin)[0]
                    if react.size:
                        ttd = float(tl_t[post[react[0]]] - t0)
            win = (arrival >= t0) & (arrival <= t1)
            by_tenant: Dict[str, float] = {}
            tenants = getattr(led, "tenants", ())
            if tenants and win.any():
                tidx = led.tenant_idx[win]
                w_tot = np.bincount(tidx, minlength=len(tenants))
                w_hit = np.bincount(tidx, weights=met[win],
                                    minlength=len(tenants))
                for ti, name in enumerate(tenants):
                    if w_tot[ti]:
                        by_tenant[name] = float(w_hit[ti] / w_tot[ti])
            out.append({
                "kind": shock.kind, "label": shock.label,
                "t0": float(t0), "t1": float(t1),
                "baseline_attainment": baseline,
                "max_attainment_dip": max_dip,
                "time_to_recover_s": ttr,
                "recovered": ttr >= 0.0,
                "time_to_detect_s": ttd,
                "window_attainment": _att(win),
                "window_interactive": _att(win & interactive),
                "window_batch": _att(win & ~interactive),
                "window_by_tenant": by_tenant,
            })
        return out

    def summary(self) -> Dict[str, float]:
        out = {
            "slo_attainment": self.slo_attainment(),
            "slo_interactive": self.slo_attainment(RequestType.INTERACTIVE),
            "slo_batch": self.slo_attainment(RequestType.BATCH),
            "completion_rate": self.completion_rate(),
            "goodput": self.goodput(),
            "goodput_interactive": self.goodput(RequestType.INTERACTIVE),
            "request_throughput": self.request_throughput(),
            "per_instance_throughput": self.per_instance_throughput(),
            "gpu_hours": self.gpu_hours(),
            "peak_chips": self.peak_chips,
            "hysteresis": self.hysteresis,
            "mean_itl": self.mean_itl(),
        }
        out.update(self.outcome_rates())
        by_model = self.slo_by_model()
        if len(by_model) > 1:           # multi-model fleet: per-model SLOs
            for m, v in by_model.items():
                out[f"slo_model:{m}"] = v
        if self.failures:
            out["failures"] = self.failures
        if self.degradations:
            out["degradations"] = self.degradations
        if self.skipped_injections:
            out["skipped_injections"] = self.skipped_injections
        if self.clusters:               # fleet run: per-cluster/region rollups
            out["migrations"] = self.migrations
            out["handbacks"] = self.handbacks
            out["egress_gb"] = self.egress_bytes / 1e9
            out["egress_cost_usd"] = self.egress_cost_usd
            out["fleet_cost_usd"] = sum(c.cost_usd() for c in self.clusters)
            total_batch = sum(c.served_batch for c in self.clusters)
            regions: Dict[str, float] = {}
            for c in self.clusters:
                out[f"cluster:{c.name}:gpu_hours"] = c.gpu_hours()
                out[f"cluster:{c.name}:peak_chips"] = c.peak_chips
                out[f"cluster:{c.name}:slo_interactive"] = c.slo_interactive()
                out[f"cluster:{c.name}:batch_share"] = \
                    c.served_batch / total_batch if total_batch else 0.0
                regions[c.region] = regions.get(c.region, 0.0) \
                    + c.gpu_hours()
            for r, gh in regions.items():
                out[f"region:{r}:gpu_hours"] = gh
        return out


def decisions_match(a: "RunResult", b: "RunResult", *,
                    interval: float = 1.0,
                    slack_intervals: int = 1) -> Tuple[float, int]:
    """Compare two runs' autoscaling decisions (per-type instance counts
    sampled every control ``interval``), tolerating a shift of
    ``slack_intervals`` — the engines may act the same way one control
    tick apart. Returns (fraction of grid points matching, max per-type
    count deviation at the unmatched points)."""
    horizon = min(a.duration, b.duration)
    n = max(int(horizon / interval), 1)
    matched = 0
    max_dev = 0
    for i in range(n + 1):
        t = i * interval
        ca = a.instance_counts_at(t)
        shifts = range(-slack_intervals, slack_intervals + 1)
        if any(ca == b.instance_counts_at(t + s * interval) for s in shifts):
            matched += 1
        else:
            cb = b.instance_counts_at(t)
            max_dev = max(max_dev, max(abs(x - y) for x, y in zip(ca, cb)))
    return matched / (n + 1), max_dev
