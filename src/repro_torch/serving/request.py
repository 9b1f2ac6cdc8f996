"""Request model: SLO classes, lifecycle states, timing bookkeeping."""
from __future__ import annotations

import enum
import itertools
from dataclasses import dataclass, field
from typing import List, Optional

_req_counter = itertools.count()


def request_id_counter():
    """The shared ``req_id`` source — bulk constructors (columnar
    ``Trace.materialize``) draw from the same counter the dataclass
    default does, so ids stay globally unique either way."""
    return _req_counter


class RequestType(enum.Enum):
    INTERACTIVE = "interactive"
    BATCH = "batch"


class RequestState(enum.Enum):
    QUEUED = "queued"
    RUNNING = "running"
    PREEMPTED = "preempted"     # evicted from a mixed instance, KV on host
    FINISHED = "finished"
    # overload-plane terminal states (never served):
    REJECTED = "rejected"       # refused at admission (infeasible TTFT)
    SHED = "shed"               # proactively dropped under brownout
    EXPIRED = "expired"         # deadline passed while still queued


# States a request can never leave (the accounting identity
# finished + rejected + shed + expired == n holds over completed runs)
TERMINAL_STATES = (RequestState.FINISHED, RequestState.REJECTED,
                   RequestState.SHED, RequestState.EXPIRED)


# The paper's production-derived SLO defaults (§6 Workloads)
INTERACTIVE_TTFT_SLO = 10.0     # seconds
INTERACTIVE_ITL_SLO = 0.2       # seconds/token
BATCH_TTFT_SLO = 3600.0         # one hour
BATCH_ITL_SLO = 2.0             # seconds/token


@dataclass
class SLO:
    ttft: float
    itl: float

    @classmethod
    def interactive(cls) -> "SLO":
        return cls(INTERACTIVE_TTFT_SLO, INTERACTIVE_ITL_SLO)

    @classmethod
    def batch(cls) -> "SLO":
        return cls(BATCH_TTFT_SLO, BATCH_ITL_SLO)


@dataclass
class Request:
    prompt_len: int
    output_len: int                 # ground truth; schedulers must not read
    request_type: RequestType
    slo: SLO
    arrival_time: float = 0.0
    req_id: int = field(default_factory=lambda: next(_req_counter))
    model: str = "llama-8b"
    # originating region (multi-cluster fleets): the router measures
    # network latency / egress from here; None = single-region workload
    origin: Optional[str] = None
    # paying tenant (per-tenant attainment rollups); None = single-tenant
    tenant: Optional[str] = None

    # lifecycle
    state: RequestState = RequestState.QUEUED
    tokens_generated: int = 0
    first_token_time: Optional[float] = None
    finish_time: Optional[float] = None
    itl_samples: List[float] = field(default_factory=list)
    preemptions: int = 0
    # client retry attempts consumed so far (overload plane): incremented
    # when a rejected/shed request re-arrives with backoff; mirrored into
    # the ledger ``retries`` column
    retries: int = 0
    # per-attempt deadline re-arm (overload plane): a retry re-arrival at
    # ``tr`` sets this to ``tr + slo.ttft`` so the queue's deadline sweep
    # gives each attempt its own SLO window. ``arrival_time`` stays the
    # *first* submission — SLO attainment and goodput remain end-to-end.
    deadline_at: Optional[float] = None
    # host-offloaded KV (real engine: actual arrays; sim: token count)
    saved_kv: Optional[object] = None
    # optional explicit prompt token ids (enables prefix caching; the
    # engine synthesizes random tokens when absent)
    prompt_tokens: Optional[object] = None
    # columnar ledger row id (repro.sim.ledger.RequestLedger): the event
    # core records this request's outcomes by integer row instead of — in
    # addition to — mutating the object; -1 = not tracked by a ledger
    row: int = -1

    @property
    def deadline(self) -> float:
        """TTFT-SLO-based deadline for first token (re-armed per client
        retry attempt — see ``deadline_at``)."""
        if self.deadline_at is not None:
            return self.deadline_at
        return self.arrival_time + self.slo.ttft

    @property
    def ttft(self) -> Optional[float]:
        if self.first_token_time is None:
            return None
        return self.first_token_time - self.arrival_time

    @property
    def is_interactive(self) -> bool:
        return self.request_type == RequestType.INTERACTIVE

    def ttft_met(self) -> bool:
        return self.ttft is not None and self.ttft <= self.slo.ttft

    def itl_met(self, tolerance: float = 1.0) -> bool:
        """ITL SLO attainment: mean observed ITL within the SLO."""
        if not self.itl_samples:
            return True
        mean_itl = sum(self.itl_samples) / len(self.itl_samples)
        return mean_itl <= self.slo.itl * tolerance

    def slo_met(self) -> bool:
        return self.state == RequestState.FINISHED and self.ttft_met() and self.itl_met()


def make_interactive(prompt_len: int, output_len: int, arrival: float = 0.0,
                     model: str = "llama-8b") -> Request:
    return Request(prompt_len, output_len, RequestType.INTERACTIVE,
                   SLO.interactive(), arrival, model=model)


def make_batch(prompt_len: int, output_len: int, arrival: float = 0.0,
               model: str = "llama-8b", ttft_slo: float = BATCH_TTFT_SLO) -> Request:
    return Request(prompt_len, output_len, RequestType.BATCH,
                   SLO(ttft_slo, BATCH_ITL_SLO), arrival, model=model)
