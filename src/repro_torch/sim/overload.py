"""Overload control plane: admission, shedding, retries, brownout, breakers.

Chiron's hierarchy decides *how much* capacity to run; this module is the
survival layer for the regime where the chip budget is exhausted and the
autoscaler can no longer help. Four cooperating mechanisms, all disabled
by default (an engine run without an :class:`OverloadConfig` is
bit-identical to one predating this module):

- **Admission** (QLM-style): an interactive arrival whose estimated TTFT
  at *max budget* is already infeasible is refused at route time
  (terminal state REJECTED) instead of queueing doomed work.
- **Deadline shedding**: a vectorized sweep over the columnar interactive
  lanes drops entries whose deadline has already passed (EXPIRED). Batch
  work is *deferred, never dropped* — its lanes are left intact.
- **Client retries** (:class:`RetryPolicy`): rejected/shed requests
  re-arrive as heap events with jittered exponential backoff, so retry
  storms and their damping are actually simulated. Jitter comes from
  counter-based Knuth-hash draws keyed on (ledger row, attempt) — fully
  deterministic, no RNG state, bit-identical under telemetry/shadow.
- **Brownout** (:class:`BrownoutState`) and **circuit breakers**
  (:class:`CircuitBreaker`): sustained-overload detection with
  enter/exit hysteresis suspends batch backfill and evicts batch from
  mixed instances; fleets additionally stop routing into clusters whose
  rejection-rate EWMA tripped (open -> half-open -> closed), deflecting
  to healthy regions at the price of the network hop.

Every decision is stamped into the ``obs`` decision ledger with the term
that fired, so the recorder's replay can show *why* goodput held.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

# Counter-based deterministic jitter (the PR-9 detector-noise idiom):
# Knuth multiplicative hash + golden-ratio decorrelation per attempt.
_KNUTH = 2654435761
_GOLDEN = 0x9E3779B9


@dataclass(frozen=True)
class RetryPolicy:
    """Deterministic client retry model for rejected/shed requests.

    Attempt ``k`` (1-based) re-arrives after
    ``base_backoff * 2**(k-1) * (1 + jitter * u)`` seconds where
    ``u in [0, 1)`` is a counter-based hash of (row, k). A retry is
    abandoned (the request goes terminal) once attempts are exhausted or
    the re-arrival would land past ``arrival + budget``.
    """
    max_retries: int = 3
    base_backoff: float = 2.0       # seconds before the first retry
    jitter: float = 0.5             # fractional jitter on each backoff
    budget: float = 120.0           # client gives up this long after arrival

    def backoff(self, row: int, attempt: int) -> float:
        """Delay before retry ``attempt`` (1-based) of ledger row ``row``."""
        base = self.base_backoff * (2.0 ** max(attempt - 1, 0))
        h = ((row + 1) * _KNUTH + attempt * _GOLDEN) & 0xFFFFFFFF
        return base * (1.0 + self.jitter * (h / 4294967296.0))


@dataclass(frozen=True)
class AdmissionConfig:
    """SLO-aware admission: reject an interactive arrival when its
    estimated queueing delay exceeds ``slack`` times its TTFT SLO."""
    slack: float = 1.0


@dataclass(frozen=True)
class SheddingConfig:
    """Deadline sweep over the interactive lanes at control ticks.
    ``grace`` extends the deadline before a queued request is expired."""
    grace: float = 0.0


@dataclass(frozen=True)
class BrownoutConfig:
    """Sustained-overload detection with hysteresis. Overloaded means:
    at least ``queue_min`` interactive requests waiting while the free
    chip budget cannot fit one more instance. ``enter_ticks`` consecutive
    overloaded control ticks enter brownout; ``exit_ticks`` healthy ticks
    exit it."""
    enter_ticks: int = 3
    exit_ticks: int = 5
    queue_min: int = 8


@dataclass(frozen=True)
class BreakerConfig:
    """Fleet circuit breaker on a cluster's admission-rejection EWMA."""
    ewma_alpha: float = 0.3         # per-outcome EWMA smoothing
    open_threshold: float = 0.5     # rejection-rate EWMA that opens
    cooldown: float = 30.0          # open -> half-open after this long
    trial_successes: int = 3        # half-open accepts needed to close
    min_samples: int = 10           # outcomes before the EWMA is trusted


@dataclass(frozen=True)
class OverloadConfig:
    """Feature switchboard for the overload plane. ``None`` sub-configs
    are off; an all-``None`` config is inert (the engines treat it the
    same as passing no config at all)."""
    admission: Optional[AdmissionConfig] = None
    shedding: Optional[SheddingConfig] = None
    retry: Optional[RetryPolicy] = None
    brownout: Optional[BrownoutConfig] = None

    @property
    def active(self) -> bool:
        return (self.admission is not None or self.shedding is not None
                or self.retry is not None or self.brownout is not None)

    @classmethod
    def full(cls, *, slack: float = 1.0, max_retries: int = 3,
             base_backoff: float = 2.0, budget: float = 120.0) -> "OverloadConfig":
        """Everything on with scenario-friendly defaults."""
        return cls(admission=AdmissionConfig(slack=slack),
                   shedding=SheddingConfig(),
                   retry=RetryPolicy(max_retries=max_retries,
                                     base_backoff=base_backoff,
                                     budget=budget),
                   brownout=BrownoutConfig())


class WaitGauge:
    """Estimated interactive queueing delay per model *at max budget*.

    Reuses the controller's per-model QLM :class:`WaitingTimeEstimator`
    (output-length moments learned from completions) with a service rate
    of ``n_instances = max_chips // chips_per_instance`` instances at the
    interactive-ITL-optimal batch — i.e. the most optimistic capacity the
    cluster could ever field. If the wait is infeasible *at that* rate,
    no autoscaling decision can save the request.
    """

    __slots__ = ("_controller", "_cluster", "_rates")

    def __init__(self, controller, cluster):
        self._controller = controller
        self._cluster = cluster
        # model -> (tokens/s per instance, instances at max budget, chips)
        self._rates: Dict[str, Tuple[float, int, int]] = {}

    @property
    def supported(self) -> bool:
        return hasattr(self._controller, "_estimator_for")

    def _rate(self, model: str) -> Tuple[float, int, int]:
        r = self._rates.get(model)
        if r is None:
            perf = self._cluster.perf_factory(model)
            b = perf.optimal_batch(self._controller.itl_slo_interactive,
                                   mean_ctx=512.0)
            thr = perf.throughput(b, mean_ctx=512.0)
            chips = max(int(perf.chips), 1)
            n_inst = max(self._cluster.max_chips // chips, 1)
            r = self._rates[model] = (thr, n_inst, chips)
        return r

    def wait(self, queue, model: str) -> float:
        """Estimated delay for a new arrival behind the current lane."""
        thr, n_inst, _ = self._rate(model)
        est = self._controller._estimator_for(model)
        return est.waiting_time(queue.n_interactive_for(model), thr,
                                n_instances=n_inst)

    def per_request_wait(self, model: str) -> float:
        """Estimated service delay contributed by one queued request."""
        thr, n_inst, _ = self._rate(model)
        est = self._controller._estimator_for(model)
        return est.waiting_time(1, thr, n_instances=n_inst)

    def min_chips(self) -> int:
        """Smallest instance footprint among the controller's models —
        the budget headroom below which the cluster cannot grow."""
        models = getattr(self._controller, "model_list", None) \
            or [getattr(self._controller, "model", "llama-8b")]
        return min(self._rate(m)[2] for m in models)


def is_overloaded(cluster, queue, gauge: WaitGauge,
                  cfg: BrownoutConfig) -> bool:
    """The brownout entry signal: interactive backlog with no budget
    headroom left to scale into."""
    if queue.n_interactive < cfg.queue_min:
        return False
    free = cluster.max_chips - cluster.used_chips()
    return free < gauge.min_chips()


class BrownoutState:
    """Hysteresis counter for brownout mode (one per cluster).
    (``engaged``, not ``active`` — the latter is an instance-plane
    mirror attribute and would trip the MIR102 auditor.)"""

    __slots__ = ("engaged", "_hot", "_cool")

    def __init__(self):
        self.engaged = False
        self._hot = 0
        self._cool = 0

    def update(self, overloaded: bool, cfg: BrownoutConfig) -> Optional[bool]:
        """Feed one control tick; returns True on enter, False on exit,
        None when the mode did not change."""
        if overloaded:
            self._hot += 1
            self._cool = 0
        else:
            self._cool += 1
            self._hot = 0
        if not self.engaged and self._hot >= cfg.enter_ticks:
            self.engaged = True
            return True
        if self.engaged and self._cool >= cfg.exit_ticks:
            self.engaged = False
            return False
        return None


# Breaker state codes (stamped into the obs decision ledger's itype slot)
BRK_CLOSED, BRK_HALF_OPEN, BRK_OPEN = 0, 1, 2


class CircuitBreaker:
    """Per-cluster breaker on the admission-rejection EWMA.

    closed --(ewma > open_threshold)--> open --(cooldown)--> half-open
    --(trial accepts)--> closed, or --(any rejection)--> open again.
    """

    __slots__ = ("cfg", "state", "ewma", "samples", "opened_at",
                 "_successes")

    def __init__(self, cfg: BreakerConfig):
        self.cfg = cfg
        self.state = BRK_CLOSED
        self.ewma = 0.0
        self.samples = 0
        self.opened_at = 0.0
        self._successes = 0

    def allows(self, now: float) -> bool:
        """May traffic be routed here? Transitions open -> half-open
        after the cooldown (check :attr:`state` for the stamp)."""
        if self.state == BRK_OPEN:
            if now - self.opened_at >= self.cfg.cooldown:
                self.state = BRK_HALF_OPEN
                self._successes = 0
                return True
            return False
        return True

    def record(self, rejected: bool, now: float) -> Optional[int]:
        """Feed one admission outcome; returns the new state code on a
        transition, None otherwise."""
        a = self.cfg.ewma_alpha
        x = 1.0 if rejected else 0.0
        self.ewma = x if self.samples == 0 else a * x + (1.0 - a) * self.ewma
        self.samples += 1
        if self.state == BRK_HALF_OPEN:
            if rejected:
                self.state = BRK_OPEN
                self.opened_at = now
                return BRK_OPEN
            self._successes += 1
            if self._successes >= self.cfg.trial_successes:
                self.state = BRK_CLOSED
                self.ewma = 0.0     # fresh slate after a confirmed close
                self.samples = 0
                return BRK_CLOSED
        elif self.state == BRK_CLOSED \
                and self.samples >= self.cfg.min_samples \
                and self.ewma > self.cfg.open_threshold:
            self.state = BRK_OPEN
            self.opened_at = now
            return BRK_OPEN
        return None
