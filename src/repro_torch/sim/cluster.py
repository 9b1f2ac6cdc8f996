"""Simulated serving cluster: instances driven by the analytic perf model.

The control plane (autoscalers, routing, queues, request groups) is the
production ``repro_torch.core`` / ``repro_torch.serving`` code; only the
data plane — how long a decode step takes — is simulated, using
``PerfModel``. Instance bring-up takes ``model_load_time()`` (the 15–60 s that motivates Chiron's
over-provisioning), and every provision/retire action is counted for the
hysteresis metric.

Two data-plane drivers share the same instance state:

- ``step(dt, now)``: the fixed-tick reference — every running sequence is
  walked each tick.
- ``advance(now)``: the event-core fluid model. Continuous batching gives
  every decoding sequence the same token rate, so decode progress is a
  single per-instance *virtual clock* (tokens emitted per sequence);
  sequence finish order is a heap over virtual finish times and KV/context
  aggregates are closed forms of the clock. Advancing an instance is O(1)
  plus O(log B) per completed/transitioned sequence — independent of
  batch size, which is what keeps million-request traces tractable.

Control-plane queries (``can_admit``, ``mean_ctx``, ``runs_interactive``,
``min_itl_slo``…) are all O(1) via maintained aggregates; the routing hot
path never scans a batch.

The vectorized instance plane (:class:`InstancePlane`) mirrors every
instance's fluid scalars — virtual clock, catch-up time, running/decoding
counts, KV aggregates, slow factor — plus its cached ``PerfModel`` ITL
coefficients into struct-of-arrays NumPy columns, kept in sync
incrementally by the mutation sites. The control-tick catch-up
(``SimCluster.catch_up``) then advances every instance without a pending
intrinsic event in **one array pass** (identical arithmetic to the scalar
``advance``, so decisions are bit-for-bit equivalent) and falls back to
the per-object path only for instances whose prefill/finish heap actually
crosses the tick. Below ``SimCluster.vec_min`` live instances the scalar
loop wins on NumPy fixed costs and is used instead — the plane is the
production-scale path, not a small-fleet tax.

Outcome recording is columnar too: when ``SimCluster.ledger`` is set (the
event engines install a :class:`repro_torch.sim.ledger.RequestLedger`), every
``Request`` attribute write in the hot path (first token, finish, state,
tokens) lands in the ledger at ``Request.row`` as well, so run metrics
reduce over arrays instead of a million objects.

The port's copy of the reference's ``sim/cluster.py``, with two
departures that change no decision. The per-step overhead is read from
each instance's ``PerfModel`` (``step_overhead``, folded in when the model
is built; the plane keeps it as a column beside the collective time), not
bound from ``perf_model`` at import, so one patch of the perf model's
constants covers every reader. And ``SimCluster``'s default budget is the
paper's 50 cards, not the reference's 400 TPU chips.
"""
from __future__ import annotations

import enum
import heapq
import itertools
import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.local_autoscaler import LocalAutoscaler
from repro_torch.core.backpressure import LocalMetrics
from repro_torch.obs.recorder import (SPAN_ADMIT as _SPAN_ADMIT,
                                      SPAN_PREEMPT as _SPAN_PREEMPT)
from repro_torch.serving.request import Request, RequestState, RequestType
from repro_torch.sim import ledger as _ledger
from repro_torch.sim.perf_model import PerfModel

_inst_counter = itertools.count()

_INF = float("inf")
_heappush = heapq.heappush           # hot-path aliases: skip the module
_heappop = heapq.heappop             # attribute load per heap operation


def _by_id(inst) -> int:
    return inst.id

# decode rate used when the quantized tick emulation truncates to zero
# tokens per tick (itl > dt: the tick loop makes no progress either)
_STALLED_ITL = 1e12

# health-EWMA ratio (observed ITL / healthy-model ITL) above which an
# instance is suspected slow and routed around (slow-node degradation)
SLOW_SUSPECT_RATIO = 1.8

_HASH_SCALE = 1.0 / 4294967296.0     # uint32 hash -> [0, 1)


@dataclass(frozen=True)
class DetectorConfig:
    """Noisy slow-node detector knobs (``SimCluster.detector``).

    The detector sees one *observed* ITL-ratio sample per instance per
    control tick — the ground-truth ``slow_factor`` corrupted by
    multiplicative measurement noise and optional sample-level
    false-positive / false-negative flips — and tests the window median
    through the health EWMA. Detection therefore takes a few ticks and
    can mis-fire, like a real control plane; the fluid-exact ratio is
    never read by the detection path.

    All randomness is a counter-based integer hash of (instance id,
    sample index, seed): deterministic, replayable, and independent of
    every seeded RNG stream in the engines, so detector noise can never
    perturb victim draws or arrival sequences.
    """
    window: int = 5        # median window (samples = control ticks)
    alpha: float = 0.5     # health-EWMA gain on the window median
    noise: float = 0.1     # multiplicative measurement noise (+-10%)
    fp_rate: float = 0.0   # P(healthy sample reads as slow)
    fn_rate: float = 0.0   # P(slow sample reads as healthy)
    seed: int = 0          # decorrelates the sample hash stream


_DEFAULT_DETECTOR = DetectorConfig()

# Mirror registries: ``SimInstance`` fluid scalar -> ``InstancePlane``
# column kept in sync at every mutation site (directly, via
# ``_sync_plane()``, or via ``plane.alloc``/``plane.free``). The static
# mirror auditor (``repro_torch.analysis``, rule MIR102) checks
# assignments against these mappings and the runtime shadow verifier
# asserts the columns agree with the objects — extend them when mirroring
# a new scalar into the plane.
PLANE_MIRRORS: Dict[str, str] = {
    "active": "active",
    "vclock": "vclock",
    "last_advance": "last_advance",
    "slow_factor": "slow",
    "_n_dec": "n_dec",
    "_kv_prefill": "kv_prefill",
    "_kv_dec_base": "kv_dec_base",
}
# Container mirror: mutating the ``running`` dict (admission, removal,
# clear) must land in the ``n_running`` column the same way.
PLANE_CONTAINER_MIRRORS: Dict[str, str] = {"running": "n_running"}


class InstanceType(enum.Enum):
    INTERACTIVE = "interactive"
    MIXED = "mixed"
    BATCH = "batch"


class InstanceState(enum.Enum):
    LOADING = "loading"
    ACTIVE = "active"
    RETIRED = "retired"


class SimSeq:
    """One running sequence (slotted: allocated once per admission)."""

    __slots__ = ("request", "ctx_tokens", "prefill_left", "gen_f",
                 "decoding", "prefill_done_t", "v0", "gen_base", "ctx_base")

    def __init__(self, request: Request, ctx_tokens: float,
                 prefill_left: float, gen_f: float = 0.0):
        self.request = request
        self.ctx_tokens = ctx_tokens     # prompt + generated (KV footprint)
        self.prefill_left = prefill_left  # seconds of prefill work left
        self.gen_f = gen_f               # fractional tokens generated
        # --- event-core fluid state ---
        self.decoding = False
        self.prefill_done_t = 0.0        # absolute sim time prefill done
        self.v0 = 0.0                    # instance vclock at decode entry
        self.gen_base = 0.0              # gen_f - vclock while decoding
        self.ctx_base = 0.0              # ctx   - vclock while decoding

    @property
    def done(self) -> bool:
        return self.request.tokens_generated >= self.request.output_len


_new_seq = SimSeq.__new__               # hot-path constructor bypass


class InstancePlane:
    """Struct-of-arrays mirror of per-instance fluid state + cached ITL
    coefficients (see module docstring). Slots are allocated at provision
    and freed at retirement; mutation sites keep the columns in sync via
    ``SimInstance._sync_plane`` so ``catch_up`` can advance the whole
    fleet in one vectorized pass.
    """

    def __init__(self, cap: int = 64):
        self.cap = cap
        self._free: List[int] = list(range(cap - 1, -1, -1))
        self.owner: List[Optional["SimInstance"]] = [None] * cap
        z = np.zeros
        # dynamic fluid state
        self.active = z(cap, dtype=bool)
        self.n_running = z(cap, dtype=np.int64)
        self.n_dec = z(cap, dtype=np.int64)
        self.kv_prefill = z(cap)
        self.kv_dec_base = z(cap)
        self.vclock = z(cap)
        self.last_advance = z(cap)
        self.slow = np.ones(cap)
        # earliest (possibly stale-conservative) intrinsic events
        self.next_prefill = np.full(cap, _INF)
        self.next_vfin = np.full(cap, _INF)
        # cached PerfModel ITL coefficients (static per slot)
        self.mem_base = z(cap)
        self.mem_kv = z(cap)
        self.comp_seq = z(cap)
        self.coll = z(cap)
        self.oh = z(cap)
        self.kv_cap = np.full(cap, _INF)
        self.prefix = z(cap)
        self.spec_on = z(cap, dtype=bool)
        self.spec_over = z(cap)
        self.spec_speed = np.ones(cap)

    def _grow(self) -> None:
        old = self.cap
        self.cap = cap = old * 2
        self._free.extend(range(cap - 1, old - 1, -1))
        self.owner.extend([None] * old)
        for name in ("active", "n_running", "n_dec", "kv_prefill",
                     "kv_dec_base", "vclock", "last_advance", "slow",
                     "next_prefill", "next_vfin", "mem_base", "mem_kv",
                     "comp_seq", "coll", "oh", "kv_cap", "prefix", "spec_on",
                     "spec_over", "spec_speed"):
            a = getattr(self, name)
            pad = np.empty(old, dtype=a.dtype)
            if name in ("next_prefill", "next_vfin", "kv_cap"):
                pad.fill(np.inf)
            elif name in ("slow", "spec_speed"):
                pad.fill(1)
            else:
                pad.fill(0)
            setattr(self, name, np.concatenate([a, pad]))

    def alloc(self, inst: "SimInstance") -> int:
        if not self._free:
            self._grow()
        s = self._free.pop()
        self.owner[s] = inst
        self.active[s] = inst.active
        self.n_running[s] = 0
        self.n_dec[s] = 0
        self.kv_prefill[s] = 0.0
        self.kv_dec_base[s] = 0.0
        self.vclock[s] = 0.0
        self.last_advance[s] = inst.last_advance
        self.slow[s] = inst.slow_factor
        self.next_prefill[s] = _INF
        self.next_vfin[s] = _INF
        self.mem_base[s] = inst._c_mem_base
        self.mem_kv[s] = inst._c_mem_kv
        self.comp_seq[s] = inst._c_comp
        self.coll[s] = inst._c_coll
        self.oh[s] = inst._c_oh
        self.kv_cap[s] = inst._c_cap
        self.prefix[s] = inst._c_prefix
        self.spec_on[s] = inst._c_spec
        self.spec_over[s] = inst._c_spec_over
        self.spec_speed[s] = inst._c_spec_speed
        return s

    def free(self, slot: int) -> None:
        self.owner[slot] = None
        self.active[slot] = False
        self.n_running[slot] = 0
        self.n_dec[slot] = 0
        self.next_prefill[slot] = _INF
        self.next_vfin[slot] = _INF
        self._free.append(slot)

    def catch_up(self, t: float, cluster: "SimCluster",
                 batch_seq: int) -> None:
        """Vectorized fluid catch-up of every running instance to ``t``.

        One array pass computes each instance's frozen-composition ITL
        with the exact operation order of ``PerfModel.itl`` (bit-for-bit
        the scalar result), detects which instances have an intrinsic
        event (prefill completion / decode finish) crossing the interval,
        advances the rest in bulk, and caches their next-completion ETA
        for the sweep. Crossing instances fall back to the scalar
        ``advance`` (heap pops, interpolation).
        """
        nr = self.n_running
        m = self.active & (nr > 0) & (self.last_advance < t)
        slots = np.nonzero(m)[0]
        if slots.size == 0:
            return
        b = nr[slots]
        dt = t - self.last_advance[slots]
        nd = self.n_dec[slots]
        vc = self.vclock[slots]
        kv = self.kv_prefill[slots] + self.kv_dec_base[slots] + nd * vc
        ctx = np.maximum(kv / b, 1.0)
        itl = self._itl(slots, b, ctx)
        ratio = dt / itl
        vnew = np.where(nd > 0, vc + ratio, vc)
        crossing = (self.next_prefill[slots] <= t + 1e-12) \
            | ((nd > 0) & (self.next_vfin[slots] <= vnew + 1e-9))
        fast = ~crossing
        fs = slots[fast]
        owner = self.owner
        if fs.size:
            self.last_advance[fs] = t
            self.vclock[fs] = vnew[fast]
            ndf = nd[fast]
            dec = ndf > 0
            if dec.any():
                cluster.tok_accum += float(np.sum(ndf[dec]
                                                  * ratio[fast][dec]))
            # next-completion ETA under the *new* composition-frozen ITL
            # (exactly what next_event_in would recompute at the sweep)
            kv2 = self.kv_prefill[fs] + self.kv_dec_base[fs] \
                + ndf * self.vclock[fs]
            ctx2 = np.maximum(kv2 / nr[fs], 1.0)
            itl2 = self._itl(fs, nr[fs], ctx2)
            eta = np.minimum(self.next_prefill[fs] - t,
                             (self.next_vfin[fs] - self.vclock[fs]) * itl2)
            np.maximum(eta, cluster.completion_grain, out=eta)
            dirty = cluster.dirty
            vcol = self.vclock
            for s, e in zip(fs.tolist(), eta.tolist()):
                inst = owner[s]
                inst.vclock = vcol[s]
                inst.last_advance = t
                inst._eta_val = e
                inst._eta_stamp = batch_seq
                dirty.add(inst)
        for s in slots[crossing].tolist():
            owner[s].advance(t)

    def _itl(self, slots: np.ndarray, b: np.ndarray,
             ctx: np.ndarray) -> np.ndarray:
        """Vector twin of ``SimInstance._itl_now`` — identical op order."""
        mem = self.mem_base[slots] + b * ctx * self.mem_kv[slots]
        comp = b * self.comp_seq[slots]
        t = np.maximum(mem, comp) + self.coll[slots] + self.oh[slots]
        sp = self.spec_on[slots]
        if sp.any():
            t = np.where(sp, t * (1 + self.spec_over[slots] * np.sqrt(b))
                         / self.spec_speed[slots], t)
        cap = self.kv_cap[slots]
        demand = b * (ctx + self.prefix[slots])
        with np.errstate(invalid="ignore"):
            over = demand / cap - 1.0
            pre = demand > cap
        if pre.any():
            t = np.where(pre, t * (1.0 + 4.0 * over + 8.0 * over * over), t)
        return t * self.slow[slots]


class SimInstance:
    def __init__(self, perf: PerfModel, itype: InstanceType, now: float, *,
                 local_autoscaler: Optional[LocalAutoscaler] = None,
                 static_batch: Optional[int] = None,
                 load_time: Optional[float] = None):
        self.id = next(_inst_counter)
        self.perf = perf
        self.model = perf.model_name
        self.itype = itype
        self.state = InstanceState.LOADING
        self.active = False          # mirrors state (hot-path flag)
        self.ready_time = now + (load_time if load_time is not None
                                 else perf.model_load_time())
        self.local = local_autoscaler
        self.static_batch = static_batch
        self.running: Dict[int, SimSeq] = {}    # req_id -> seq (ins. order)
        self.created_at = now
        # slow-node degradation: ground-truth ITL inflation (set by the
        # injection event) and the *observed* health signal the control
        # plane detects it with — an EWMA over the median of a ring
        # buffer of noisy observed-ITL-ratio samples pushed at control
        # ticks (see DetectorConfig). Routing avoids suspected instances.
        self.slow_factor = 1.0
        self.health_ewma = 1.0
        self._obs_buf: List[float] = []   # noisy ITL-ratio sample window
        self._obs_n = 0                   # samples drawn (hash counter)
        # O(1) aggregates over ``running`` (the routing/control hot path
        # queries these every pass; scanning the batch would be O(B))
        self._kv_tokens = 0.0        # fixed-tick: sum of ctx_tokens
        self._n_interactive = 0
        self._slo_counts: Dict[float, int] = {}
        self._batch_lifo: List[int] = []   # batch admits (lazy-stale rids)
        # --- event-core state (unused on the fixed-tick path) ---
        self.event_mode = False
        self.last_advance = now      # sim time the fluid state is valid at
        self.vclock = 0.0            # fluid tokens emitted per decoding seq
        self._n_dec = 0              # decoding seqs
        self._kv_prefill = 0.0       # sum ctx over prefilling seqs
        self._kv_dec_base = 0.0      # sum ctx_base over decoding seqs
        self._prefill_heap: List[Tuple[float, int]] = []   # (t_done, rid)
        self._decode_heap: List[Tuple[float, int]] = []    # (vfin, rid)
        self._epoch = 0              # invalidates scheduled events
        self._pending_finished: List[Request] = []
        self._cluster = None         # backref set by SimCluster.provision
        self.slot = -1               # InstancePlane slot (set by provision)
        self._plane: Optional[InstancePlane] = None
        self._eta_val = 0.0          # cached post-advance completion ETA
        self._eta_stamp = -1         # event batch it is valid for
        # inlined PerfModel ITL coefficients — ``_itl_now`` is the scalar
        # hot-path twin of ``PerfModel.itl`` (identical arithmetic; the
        # method-call + attribute-chase overhead is what it removes)
        self._c_mem_base = perf._mem_t_base
        self._c_mem_kv = perf._mem_t_per_kvtok
        self._c_comp = perf._comp_t_per_seq
        self._c_coll = perf._coll_t
        self._c_oh = perf.step_overhead
        self._c_cap = perf._kv_cap
        self._c_wall = 1.5 * perf._kv_cap if math.isfinite(perf._kv_cap) \
            else _INF
        self._c_prefix = float(perf.prefix_hit_tokens) \
            if perf.prefix_caching else 0.0
        self._c_spec = perf.speculative_decoding
        self._c_spec_over = perf.spec_draft_overhead
        self._c_spec_speed = perf.spec_accept_speedup
        # prefill_time twin: (2 * n_active) * eff_len / flops + overhead
        # with the same grouping as PerfModel.prefill_time
        self._c_2na = 2 * perf.n_active
        self._c_flops = perf._flops_per_s
        self._c_pc = perf.prefix_caching
        self._c_hit = perf.prefix_hit_tokens
        # packed copy for the hottest callers (advance/admit): one
        # attribute load + tuple unpack instead of nine attribute loads
        self._c_itl = (self._c_mem_base, self._c_mem_kv, self._c_comp,
                       self._c_coll, self._c_spec, self._c_spec_over,
                       self._c_spec_speed, self._c_cap, self._c_prefix)

    # ------------------------------------------------------------ state
    def activate_if_ready(self, now: float) -> None:
        # The lost-READY fix lives at the call sites: max(t, inst.ready_time).
        # repro-lint: ok(DET205, callers clamp now to ready_time)
        if self.state == InstanceState.LOADING and now >= self.ready_time:
            self.state = InstanceState.ACTIVE
            self.active = True
            c = self._cluster
            if c is not None:
                c.n_loading -= 1
                c._active[self.id] = self
                c.route_version += 1
            if self.slot >= 0:
                self._plane.active[self.slot] = True

    @property
    def max_batch_size(self) -> int:
        if self.local is not None:
            return self.local.max_batch_size
        return self.static_batch or 64

    @property
    def n_running(self) -> int:
        return len(self.running)

    def n_running_batch(self) -> int:
        return len(self.running) - self._n_interactive

    def mean_ctx(self) -> float:
        n = len(self.running)
        return self.kv_tokens() / n if n else 0.0

    def kv_tokens(self) -> float:
        if self.event_mode:
            return self._kv_prefill + self._kv_dec_base \
                + self._n_dec * self.vclock
        return self._kv_tokens

    def kv_utilization(self) -> float:
        cap = self._c_cap
        if not math.isfinite(cap):
            return self.n_running / max(self.max_batch_size, 1)
        return self.kv_tokens() / cap

    def slot_utilization(self) -> float:
        return self.n_running / max(self.max_batch_size, 1)

    def _itl_now(self, b: int, ctx: float) -> float:
        """Scalar ITL at batch ``b`` / mean context ``ctx`` — inlined
        ``PerfModel.itl`` (identical operation order, hence identical
        floats) times the degradation ``slow_factor``."""
        mem_t = self._c_mem_base + b * ctx * self._c_mem_kv
        comp_t = b * self._c_comp
        t = (mem_t if mem_t >= comp_t else comp_t) \
            + self._c_coll + self._c_oh
        if self._c_spec:
            t = t * (1 + self._c_spec_over * math.sqrt(b)) \
                / self._c_spec_speed
        cap = self._c_cap
        if cap != _INF:
            demand = b * (ctx + self._c_prefix)
            if demand > cap:
                over = demand / cap - 1.0
                t *= 1.0 + 4.0 * over + 8.0 * over * over
        return t * self.slow_factor

    def current_itl(self) -> float:
        if not self.running:
            return 0.0
        return self._itl_now(len(self.running), max(self.mean_ctx(), 1.0))

    def current_throughput(self) -> float:
        if not self.running:
            return 0.0
        return self.n_running / self.current_itl()

    def spare_throughput(self) -> float:
        """Tokens/s of unused slot capacity (used for BBP multiplexing)."""
        spare = self.max_batch_size - self.n_running
        if spare <= 0:
            return 0.0
        itl = self._itl_now(self.max_batch_size, max(self.mean_ctx(), 512.0))
        return spare / itl

    def update_health(self, alpha: Optional[float] = None) -> None:
        """Push one *noisy* observed-ITL-ratio sample and re-test health
        (the detection signal for slow-node degradation; called once per
        control tick). The sample is the ground-truth ``slow_factor``
        corrupted by deterministic hash noise plus optional FP/FN flips
        (``DetectorConfig``); the detector EWMAs the window **median**,
        so detection lags injection by a few ticks and isolated flipped
        samples are suppressed — the fluid-exact ratio is no longer read
        by the detection path. Idle instances update too (a health
        probe): routing refuses suspected instances, so without this a
        drained victim could never clear its flag after recovery and
        would strand healthy capacity forever.

        A flip of the *suspected* flag bumps the cluster route version:
        routing reads health only through that flag, and the positive
        scan memo (``_scan_admit`` reuse across arrivals) relies on the
        version capturing every routing-visible change."""
        if not self.active:
            return
        c = self._cluster
        det = c.detector if c is not None else _DEFAULT_DETECTOR
        n = self._obs_n = self._obs_n + 1
        # counter-based integer hash (Knuth multiplicative) — one draw
        # per (instance, sample index, seed); no RNG object, so sampling
        # can never perturb the engines' seeded victim/arrival streams
        h = ((self.id + 1) * 2654435761 + n * 40503
             + (det.seed + 1) * 69069) & 0xFFFFFFFF
        obs = self.slow_factor \
            * (1.0 + det.noise * (2.0 * h * _HASH_SCALE - 1.0))
        if det.fp_rate > 0.0 or det.fn_rate > 0.0:
            h2 = (h * 2654435761 + 0x9E3779B9) & 0xFFFFFFFF
            if self.slow_factor == 1.0:
                if h2 * _HASH_SCALE < det.fp_rate:
                    obs = SLOW_SUSPECT_RATIO * 1.25  # spurious slow read
            elif h2 * _HASH_SCALE < det.fn_rate:
                obs = 1.0                            # missed slow read
        buf = self._obs_buf
        if len(buf) < det.window:
            buf.append(obs)
        else:
            buf[n % det.window] = obs
        stat = sorted(buf)[len(buf) // 2]            # window median
        a = det.alpha if alpha is None else alpha
        was = self.health_ewma > SLOW_SUSPECT_RATIO
        self.health_ewma += a * (stat - self.health_ewma)
        if (self.health_ewma > SLOW_SUSPECT_RATIO) != was \
                and c is not None:
            c.route_version += 1

    @property
    def suspected_slow(self) -> bool:
        return self.health_ewma > SLOW_SUSPECT_RATIO

    def runs_interactive(self) -> bool:
        return self._n_interactive > 0

    def min_itl_slo(self) -> float:
        if not self._slo_counts:
            return _INF
        return min(self._slo_counts)

    # ------------------------------------------------------------ intake
    def can_admit(self, req: Request) -> bool:
        if not self.active or len(self.running) >= self.max_batch_size:
            return False
        if req.model != self.model:
            return False            # never serve a wrong-model request
        # hard admission wall well past the soft preemption inflection
        # (wall = 1.5 * kv capacity; inf when KV is unbounded)
        if self.kv_tokens() + req.prompt_len > self._c_wall:
            return False
        return True

    def admit(self, req: Request, now: float) -> None:
        if self.event_mode and self.last_advance < now:
            self.advance(now, False)  # settle old composition first
        restored = req.saved_kv is not None
        ctx = float(req.prompt_len + req.tokens_generated)
        if restored:
            prefill = 0.0
            req.saved_kv = None
        else:
            # inlined PerfModel.prefill_time (identical grouping/floats)
            eff = req.prompt_len
            if self._c_pc:
                eff = eff - self._c_hit
                if eff < 16:
                    eff = 16
            prefill = self._c_2na * eff / self._c_flops + self._c_oh
        req.state = RequestState.RUNNING
        c = self._cluster
        led = c.ledger if c is not None else None
        if led is not None and req.row >= 0:
            led.state[req.row] = _ledger.RUNNING
        if c is not None and c.obs is not None:
            # FlightRecorder.record_span inlined (the one per-request
            # telemetry hook): sampling hash + one staged tuple append
            rec = c.obs
            if req.row >= 0 and ((req.row + 1) * 2654435761
                                 + rec._span_mix) \
                    & 0xFFFFFFFF < rec._span_limit:
                rec._sp_stage.append(
                    (now, req.row, _SPAN_ADMIT, self.id))
        # slotted SimSeq built without the constructor call (hot: once
        # per admission) — field-for-field what __init__ would set
        s = _new_seq(SimSeq)
        s.request = req
        s.ctx_tokens = ctx
        s.prefill_left = prefill
        s.gen_f = float(req.tokens_generated)
        s.decoding = False
        s.prefill_done_t = 0.0
        s.v0 = 0.0
        s.gen_base = 0.0
        s.ctx_base = 0.0
        self.running[req.req_id] = s
        if c is not None:
            c.total_running += 1
        sc = self._slo_counts
        k = req.slo.itl
        sc[k] = sc.get(k, 0) + 1
        if req.request_type == RequestType.INTERACTIVE:
            self._n_interactive += 1
        else:
            self._batch_lifo.append(req.req_id)
        if self.event_mode:
            if prefill > 0:
                s.prefill_done_t = now + prefill
                _heappush(self._prefill_heap, (s.prefill_done_t,
                                               req.req_id))
                self._kv_prefill += ctx
            else:
                self._enter_decode(s, self.vclock)
                if req.first_token_time is None:
                    req.first_token_time = now
                    if led is not None and req.row >= 0:
                        led.first_token_time[req.row] = now
            if c is not None:                # inline mark_dirty
                c.dirty.add(self)
                c.route_version += 1
            # inline _sync_plane's early-out (hot: once per admit)
            if self.slot >= 0 and c is not None and c.plane_live:
                self._sync_plane()
            else:
                self._eta_stamp = -1
            if c is not None:
                # cache the post-admit completion ETA while the
                # composition is hot: the sweep's ``sweep_etas`` sees a
                # fresh stamp and skips its ``next_event_in`` recompute
                # (identical value — active with a non-empty batch, so
                # the guard it adds over ``_compute_eta`` is vacuous).
                # The composition ITL is inlined when it will be used
                # (same expression grouping as ``mean_ctx``/``_itl_now``
                # inside ``_compute_eta`` — identical floats).
                if self._n_dec and c.quantize == 0.0:
                    n2 = len(self.running)
                    ctx2 = (self._kv_prefill + self._kv_dec_base
                            + self._n_dec * self.vclock) / n2
                    if ctx2 < 1.0:
                        ctx2 = 1.0
                    (c_mem_base, c_mem_kv, c_comp, c_coll, c_spec,
                     c_spec_over, c_spec_speed, cap, c_prefix) = \
                        self._c_itl
                    mem_t = c_mem_base + n2 * ctx2 * c_mem_kv
                    comp_t = n2 * c_comp
                    itl = (mem_t if mem_t >= comp_t else comp_t) \
                        + c_coll + self._c_oh
                    if c_spec:
                        itl = itl * (1 + c_spec_over
                                     * math.sqrt(n2)) / c_spec_speed
                    if cap != _INF:
                        demand = n2 * (ctx2 + c_prefix)
                        if demand > cap:
                            over = demand / cap - 1.0
                            itl *= 1.0 + 4.0 * over + 8.0 * over * over
                    itl *= self.slow_factor
                    running = self.running
                    best = _INF
                    ph = self._prefill_heap
                    while ph:
                        t_done, rid = ph[0]
                        s2 = running.get(rid)
                        if s2 is None or s2.decoding \
                                or s2.prefill_done_t != t_done:
                            _heappop(ph)
                            continue
                        best = t_done - self.last_advance
                        break
                    dh = self._decode_heap
                    while dh:
                        vfin, rid = dh[0]
                        s2 = running.get(rid)
                        if s2 is None or not s2.decoding:
                            _heappop(dh)
                            continue
                        d = (s2.request.output_len - s2.gen_base) - vfin
                        if d > 1e-6 or d < -1e-6:
                            _heappop(dh)
                            continue
                        eta = (vfin - self.vclock) * itl
                        if eta < 1e11 and eta < best:
                            best = eta
                        break
                    grain = c.completion_grain
                    self._eta_val = best if best >= grain else grain
                else:
                    self._eta_val = self._compute_eta()
                self._eta_stamp = c.batch_seq
        else:
            self._kv_tokens += ctx

    def evict_one_batch(self, now: float) -> Optional[Request]:
        """Mixed-instance preemption: interactive evicts batch; KV saved to
        host so the restart skips re-prefill (paper §3)."""
        if self.n_running_batch() == 0:
            return None
        if self.event_mode:
            self.advance(now, False)  # settle old composition first
        while self._batch_lifo:      # most-recent batch admit still running
            s = self.running.get(self._batch_lifo.pop())
            if s is None or s.request.request_type != RequestType.BATCH:
                continue             # stale entry (finished/evicted)
            self._materialize(s)
            self._remove_seq(s)
            r = s.request
            r.state = RequestState.PREEMPTED
            r.preemptions += 1
            r.saved_kv = ("sim", s.ctx_tokens)
            c = self._cluster
            if c is not None and c.ledger is not None and r.row >= 0:
                c.ledger.state[r.row] = _ledger.PREEMPTED
            if c is not None and c.obs is not None:
                c.obs.record_evict(c, now, r, self)
            self.mark_dirty()
            self._sync_plane()
            return r
        return None

    # ----------------------------------------------------- seq bookkeeping
    # Internal transition: every caller runs _sync_plane before the batch ends.
    # mirror-sync: ok(callers settle the composition via _sync_plane)
    def _enter_decode(self, s: SimSeq, v_entry: float) -> None:
        s.decoding = True
        s.v0 = v_entry
        s.gen_base = s.gen_f - v_entry
        s.ctx_base = s.ctx_tokens - v_entry
        self._kv_dec_base += s.ctx_base
        self._n_dec += 1
        vfin = float(s.request.output_len) - s.gen_base
        _heappush(self._decode_heap, (vfin, s.request.req_id))

    def _materialize(self, s: SimSeq) -> None:
        """Sync a decoding seq's lazy counters from the virtual clock."""
        if self.event_mode and s.decoding:
            s.gen_f = min(s.gen_base + self.vclock,
                          float(s.request.output_len))
            s.ctx_tokens = s.ctx_base + self.vclock
            r = s.request
            r.tokens_generated = int(s.gen_f)
            c = self._cluster
            if c is not None and c.ledger is not None and r.row >= 0:
                c.ledger.tokens_generated[r.row] = r.tokens_generated

    # Internal transition: every caller runs _sync_plane before the batch ends.
    # mirror-sync: ok(callers settle the composition via _sync_plane)
    def _remove_seq(self, s: SimSeq) -> None:
        r = s.request
        del self.running[r.req_id]
        if self._cluster is not None:
            self._cluster.total_running -= 1
        sc = self._slo_counts
        c = sc.get(r.slo.itl, 0) - 1
        if c > 0:
            sc[r.slo.itl] = c
        else:
            sc.pop(r.slo.itl, None)
        if r.request_type == RequestType.INTERACTIVE:
            self._n_interactive -= 1
        if self.event_mode:
            if s.decoding:
                s.decoding = False
                self._kv_dec_base -= s.ctx_base
                self._n_dec -= 1
            else:
                self._kv_prefill -= s.ctx_tokens
        else:
            self._kv_tokens -= s.ctx_tokens
        if not self.running:       # reset float drift at emptiness
            self._kv_tokens = 0.0
            self._kv_prefill = 0.0
            self._kv_dec_base = 0.0
            self._n_interactive = 0

    # --------------------------------------------------- event-driven core
    def mark_dirty(self) -> None:
        """Flag this instance for completion-event rescheduling (and pending
        finish collection) at the end of the current event batch. Also
        bumps the cluster's route version: anything that marks an instance
        dirty may have freed capacity, so saturated-lane routing memos
        must be revalidated."""
        c = self._cluster
        if c is not None:
            c.dirty.add(self)
            c.route_version += 1

    def _sync_plane(self) -> None:
        """Mirror this instance's fluid scalars into the plane columns
        (and invalidate its cached completion ETA). Below the vectorized
        cut-over (``cluster.plane_live`` unarmed) only the ETA stamp is
        touched — the columns would never be read, and arming resyncs
        every instance from scratch."""
        self._eta_stamp = -1
        s = self.slot
        if s < 0:
            return
        c = self._cluster
        if c is None or not c.plane_live:
            return
        pl = self._plane
        pl.vclock[s] = self.vclock
        pl.last_advance[s] = self.last_advance
        pl.n_running[s] = len(self.running)
        pl.n_dec[s] = self._n_dec
        pl.kv_prefill[s] = self._kv_prefill
        pl.kv_dec_base[s] = self._kv_dec_base
        # mirror *cleaned* heads: a stale head (seq evicted/finished) is
        # conservative for the crossing check but would poison the
        # vectorized ETA with a too-early event the scalar path (which
        # cleans inside next_event_in) would never schedule
        pl.next_prefill[s], pl.next_vfin[s] = self._clean_heads()

    def _clean_heads(self) -> Tuple[float, float]:
        """Pop invalid heap tops (departed/re-entered seqs) and return the
        earliest *valid* (prefill completion time, decode virtual finish)
        — inf where none. Popping invalid entries is unobservable: every
        consumer validity-checks entries anyway."""
        running = self.running
        ph = self._prefill_heap
        np_ = _INF
        while ph:
            t_done, rid = ph[0]
            s = running.get(rid)
            if s is None or s.decoding or s.prefill_done_t != t_done:
                heapq.heappop(ph)
                continue
            np_ = t_done
            break
        dh = self._decode_heap
        nv = _INF
        while dh:
            vfin, rid = dh[0]
            s = running.get(rid)
            if s is None or not s.decoding or abs(
                    (s.request.output_len - s.gen_base) - vfin) > 1e-6:
                heapq.heappop(dh)
                continue
            nv = vfin
            break
        return np_, nv

    def drain_finished(self) -> List[Request]:
        out = self._pending_finished
        self._pending_finished = []
        return out

    def advance(self, now: float, store_eta: bool = True) -> None:
        """Fluid catch-up to ``now`` under the current (fixed) composition —
        the event-core counterpart of :meth:`step`.

        All decoding seqs share one token rate, so the whole pool advances
        by moving ``vclock``; prefill→decode transitions and finishes pop
        off heaps at their exact crossing times (interpolated, so a
        completion estimate firing slightly late is harmless).

        ``store_eta`` caches the post-advance completion ETA in the plane
        (what ``next_event_in`` would recompute at the sweep) — callers
        that immediately change the composition again (an admit settle)
        pass False to skip the wasted work.
        """
        dt = now - self.last_advance
        t0 = self.last_advance
        self.last_advance = now
        running = self.running
        if dt <= 0 or not self.active or not running:
            if self.slot >= 0 and self._cluster is not None \
                    and self._cluster.plane_live:
                self._plane.last_advance[self.slot] = now
            return
        cluster = self._cluster
        if cluster is not None:
            cluster.dirty.add(self)          # inline mark_dirty
            cluster.route_version += 1
        # inline _itl_now at max(mean_ctx, 1.0) — identical float sequence
        n = len(running)
        v_old = self.vclock
        ctx = (self._kv_prefill + self._kv_dec_base
               + self._n_dec * v_old) / n
        if ctx < 1.0:
            ctx = 1.0
        (c_mem_base, c_mem_kv, c_comp, c_coll, c_spec,
         c_spec_over, c_spec_speed, cap, c_prefix) = self._c_itl
        mem_t = c_mem_base + n * ctx * c_mem_kv
        comp_t = n * c_comp
        itl = (mem_t if mem_t >= comp_t else comp_t) \
            + c_coll + self._c_oh
        if c_spec:
            itl = itl * (1 + c_spec_over * math.sqrt(n)) / c_spec_speed
        if cap != _INF:
            demand = n * (ctx + c_prefix)
            if demand > cap:
                over = demand / cap - 1.0
                itl *= 1.0 + 4.0 * over + 8.0 * over * over
        sf = self.slow_factor
        if sf != 1.0:
            itl *= sf
        q = cluster.quantize if cluster is not None else 0.0
        if q > 0:
            # fixed-tick parity: int(q/itl) tokens per tick, no carry
            per_tick = int(q / itl + 1e-9)
            itl = q / per_tick if per_tick > 0 else _STALLED_ITL
        toks = 0.0
        led = cluster.ledger if cluster is not None else None

        # 1. prefill completions due within (t0, now]: seq starts decoding
        #    mid-interval with vclock credit from its entry point
        ph = self._prefill_heap
        dh = self._decode_heap
        entry_debt = 0.0
        lim = now + 1e-12
        while ph and ph[0][0] <= lim:
            t_done, rid = _heappop(ph)
            s = running.get(rid)
            if s is None or s.decoding or s.prefill_done_t != t_done:
                continue                     # stale (departed/re-admitted)
            s.prefill_left = 0.0
            self._kv_prefill -= s.ctx_tokens
            r = s.request
            if r.first_token_time is None:
                r.first_token_time = t_done
                if led is not None and r.row >= 0:
                    led.first_token_time[r.row] = t_done
                s.gen_f += 1.0
                s.ctx_tokens += 1.0
                toks += 1.0
            dpre = t_done - t0               # inline max(dpre, 0.0)
            v_entry = v_old + (dpre if dpre > 0.0 else 0.0) / itl
            entry_debt += v_entry - v_old
            # inline _enter_decode (hottest transition in the event core)
            s.decoding = True
            s.v0 = v_entry
            s.gen_base = gb = s.gen_f - v_entry
            s.ctx_base = cb = s.ctx_tokens - v_entry
            self._kv_dec_base += cb
            self._n_dec += 1
            _heappush(dh, (float(r.output_len) - gb, rid))

        # 2. the decode pool advances as one fluid
        if self._n_dec:
            self.vclock = v_old + dt / itl
            toks += self._n_dec * (dt / itl) - entry_debt

            # 3. finishes: pop virtual finish times the clock crossed
            vclock = self.vclock
            vlim = vclock + 1e-9
            sc = self._slo_counts
            while dh and dh[0][0] <= vlim:
                vfin, rid = _heappop(dh)
                s = running.get(rid)
                if s is None or not s.decoding:
                    continue                 # stale entry
                d = (s.request.output_len - s.gen_base) - vfin
                if d > 1e-6 or d < -1e-6:    # manual abs: hot stale check
                    continue
                over_v = vclock - vfin       # tokens past the true finish
                toks -= over_v
                s.ctx_tokens = s.ctx_base + vfin
                r = s.request
                s.gen_f = float(r.output_len)
                # inline _remove_seq, specialized: event_mode decoding seq
                del running[rid]
                if cluster is not None:
                    cluster.total_running -= 1
                k = r.slo.itl
                cnt = sc.get(k, 0) - 1
                if cnt > 0:
                    sc[k] = cnt
                else:
                    sc.pop(k, None)
                if r.request_type == RequestType.INTERACTIVE:
                    self._n_interactive -= 1
                s.decoding = False
                self._kv_dec_base -= s.ctx_base
                self._n_dec -= 1
                if not running:    # reset float drift at emptiness
                    self._kv_tokens = 0.0
                    self._kv_prefill = 0.0
                    self._kv_dec_base = 0.0
                    self._n_interactive = 0
                r.tokens_generated = r.output_len
                r.state = RequestState.FINISHED
                ft = now - over_v * itl
                first = r.first_token_time
                if first is None:            # sub-itl output edge case
                    first = r.first_token_time = ft
                r.finish_time = ft if ft >= first else first
                # one lifetime-mean ITL sample (the event core records the
                # mean the SLO check reads, not per-tick samples)
                span = r.finish_time - first
                den = float(r.output_len) - 1.0
                mean = span / (den if den > 1.0 else 1.0)
                r.itl_samples.append(mean)
                if led is not None and r.row >= 0:
                    row = r.row
                    led.state[row] = _ledger.FINISHED
                    led.tokens_generated[row] = r.output_len
                    led.first_token_time[row] = r.first_token_time
                    led.finish_time[row] = r.finish_time
                    led.mean_itl[row] = mean
                self._pending_finished.append(r)

        if toks and cluster is not None:
            cluster.tok_accum += toks
        # cache the sweep's completion ETA while everything is hot (heads
        # cleaned first so the plane mirrors valid heads); any later
        # composition change re-invalidates the stamp via _sync_plane
        do_eta = store_eta and running and cluster is not None \
            and q == 0.0
        if do_eta:
            # post-pop composition ITL, computed once and shared with the
            # eta (exactly what next_event_in would recompute); _itl_now
            # and _compute_eta are inlined — identical float sequences
            n2 = len(running)
            ctx2 = (self._kv_prefill + self._kv_dec_base
                    + self._n_dec * self.vclock) / n2
            if ctx2 < 1.0:
                ctx2 = 1.0
            mem_t = c_mem_base + n2 * ctx2 * c_mem_kv
            comp_t = n2 * c_comp
            itl2 = (mem_t if mem_t >= comp_t else comp_t) \
                + c_coll + self._c_oh
            if c_spec:
                itl2 = itl2 * (1 + c_spec_over * math.sqrt(n2)) \
                    / c_spec_speed
            if cap != _INF:
                demand = n2 * (ctx2 + c_prefix)
                if demand > cap:
                    over = demand / cap - 1.0
                    itl2 *= 1.0 + 4.0 * over + 8.0 * over * over
            itl2 *= self.slow_factor
            best = _INF
            while ph:
                t_done, rid = ph[0]
                s = running.get(rid)
                if s is None or s.decoding or s.prefill_done_t != t_done:
                    _heappop(ph)
                    continue
                best = t_done - self.last_advance
                break
            while dh:
                vfin, rid = dh[0]
                s = running.get(rid)
                if s is None or not s.decoding:
                    _heappop(dh)
                    continue
                d = (s.request.output_len - s.gen_base) - vfin
                if d > 1e-6 or d < -1e-6:    # manual abs: hot stale check
                    _heappop(dh)
                    continue
                eta = (vfin - self.vclock) * itl2
                if eta < 1e11 and eta < best:  # stalled seqs: no event
                    best = eta
                break
            grain = cluster.completion_grain
            eta = best if best >= grain else grain
        # inline _sync_plane's early-out: below the vectorized cut-over
        # only the ETA stamp matters, and the call itself is hot
        if self.slot >= 0 and cluster is not None and cluster.plane_live:
            self._sync_plane()
        else:
            self._eta_stamp = -1
        if do_eta:
            self._eta_val = eta
            self._eta_stamp = cluster.batch_seq

    def _compute_eta(self, itl: Optional[float] = None) -> float:
        """Shared body of :meth:`next_event_in`: clean stale heap heads,
        return the grain-floored seconds until the next intrinsic event
        under the *current* composition. ``itl`` short-circuits the
        composition ITL when the caller (``advance``) just computed it —
        only valid with quantize off."""
        best = _INF
        running = self.running
        ph = self._prefill_heap
        while ph:
            t_done, rid = ph[0]
            s = running.get(rid)
            if s is None or s.decoding or s.prefill_done_t != t_done:
                _heappop(ph)
                continue
            best = t_done - self.last_advance
            break
        dh = self._decode_heap
        while dh:
            vfin, rid = dh[0]
            s = running.get(rid)
            if s is None or not s.decoding or abs(
                    (s.request.output_len - s.gen_base) - vfin) > 1e-6:
                _heappop(dh)
                continue
            if itl is None:
                itl = self._itl_now(len(running), max(self.mean_ctx(), 1.0))
                cluster = self._cluster
                q = cluster.quantize if cluster is not None else 0.0
                if q > 0:
                    per_tick = int(q / itl + 1e-9)
                    itl = q / per_tick if per_tick > 0 else _STALLED_ITL
            eta = (vfin - self.vclock) * itl
            if eta < 1e11 and eta < best:  # stalled seqs schedule nothing
                best = eta
            break
        grain = self._cluster.completion_grain if self._cluster else 1e-3
        return best if best >= grain else grain

    def next_event_in(self) -> float:
        """Seconds until this instance's next intrinsic event (a prefill
        completing or the earliest finish) under the current composition;
        inf when idle. Floored at the cluster's completion grain so nearby
        finishes coalesce into one event (and a late-drifting estimate
        re-fires geometrically rather than spinning)."""
        if not self.active or not self.running:
            return _INF
        return self._compute_eta()

    # ------------------------------------------------------------ stepping
    # The event engines never run it and RunResult falls back to objects.
    # mirror-sync: ok(fixed-tick reference path is ledger-less by design)
    def step(self, dt: float, now: float) -> Tuple[List[Request], int]:
        """Advance the instance by dt of simulated wall time (fixed-tick
        reference; walks every running sequence)."""
        if not self.active or not self.running:
            return [], 0
        b = self.n_running
        itl = self._itl_now(b, max(self.mean_ctx(), 1.0))
        finished: List[Request] = []
        tokens_out = 0
        for s in list(self.running.values()):
            budget = dt
            if s.prefill_left > 0:
                used = min(budget, s.prefill_left)
                s.prefill_left -= used
                budget -= used
                if s.prefill_left > 0:
                    continue
                if s.request.first_token_time is None:
                    s.request.first_token_time = now + used
                    s.request.tokens_generated += 1
                    s.ctx_tokens += 1
                    self._kv_tokens += 1
                    tokens_out += 1
            ntok = int(budget / itl)
            ntok = min(ntok, s.request.output_len - s.request.tokens_generated)
            if ntok > 0:
                s.request.tokens_generated += ntok
                s.ctx_tokens += ntok
                self._kv_tokens += ntok
                tokens_out += ntok
                s.request.itl_samples.append(itl)
                if s.request.first_token_time is None:
                    s.request.first_token_time = now + itl
            if s.done:
                s.request.state = RequestState.FINISHED
                s.request.finish_time = now + dt
                self._remove_seq(s)
                finished.append(s.request)
        return finished, tokens_out

    def update_local_autoscaler(self) -> None:
        if self.local is None or not self.running:
            return
        itl = self.current_itl()
        m = LocalMetrics(observed_itl=itl,
                         throughput=self.n_running / itl,
                         itl_slo=self.min_itl_slo(),
                         n_active=self.n_running,
                         batch_size=self.local.max_batch_size)
        before = self.local.max_batch_size
        self.local.update(m)
        if self.local.max_batch_size != before and self._cluster is not None:
            # a ceiling move changes admission capacity — routing memos
            # (saturation and positive-scan) key off route_version
            self._cluster.route_version += 1


class SimCluster:
    def __init__(self, perf_factory, *, max_chips: int = 50,
                 load_time: Optional[float] = None):
        """perf_factory: model_name -> PerfModel (fresh or shared).
        ``max_chips`` is the card budget, the paper's 50 GPUs by default."""
        self.perf_factory = perf_factory
        self.max_chips = max_chips
        self.load_time = load_time
        self.instances: List[SimInstance] = []
        self.scale_ups = 0
        self.scale_downs = 0
        self.failures = 0            # crash-injected removals (not scaling)
        self.degradations = 0        # slow-node injections (instance kept)
        # noisy slow-node detector knobs (engines thread a per-run config
        # through; tests/scenarios may assign directly before the run)
        self.detector = _DEFAULT_DETECTOR
        self.chip_seconds = 0.0
        self.peak_chips = 0
        self._used_chips = 0         # maintained by provision/retire
        self._pools: Dict[InstanceType, List[SimInstance]] = \
            {t: [] for t in InstanceType}
        # (model, itype) -> live pool; the multi-model routing/control path
        # (one Algorithm-2 loop per model) reads these instead of filtering
        self._model_pools: Dict[Tuple[str, InstanceType],
                                List[SimInstance]] = {}
        self._model_count: Dict[str, int] = {}   # model -> live instances
        self._pool_pairs: Dict[str, Tuple[List[SimInstance],
                                          List[SimInstance]]] = {}
        self.total_running = 0       # running seqs cluster-wide (O(1) idle check)
        # O(1) registries: live ACTIVE instances keyed by id (provision
        # order; failure/degradation victim draws sort the small key set
        # instead of scanning every instance), count of LOADING instances
        # (quiescence check), and provisions not yet given a READY event
        self._active: Dict[int, SimInstance] = {}
        self.n_loading = 0
        self.new_loading: List[SimInstance] = []
        # bumped whenever admission capacity may have improved (instance
        # dirtied / activated / provisioned); saturated-lane routing memos
        # key on it — see BaseController.route_interactive
        self.route_version = 0
        # current event-batch stamp (set by the event loops each
        # iteration; keys the routing memo's once-per-batch arm and the
        # plane's completion-ETA cache)
        self.batch_seq = 0
        # --- event-core state (unused on the fixed-tick path) ---
        self.event_mode = False
        self.now = 0.0               # sim time chip accounting is valid at
        self.dirty: set = set()      # instances needing event rescheduling
        self.tok_accum = 0.0         # tokens generated since last drain
        # completion estimates are coalesced to this grain: finishes inside
        # one grain are processed together (their finish times are still
        # interpolated exactly) — the same quantization a dt=0.25 fixed
        # tick imposes, at a fraction of the events
        self.completion_grain = 0.25
        # sparse fixed-tick mode (simulate_events(quantize=dt)): decode
        # rates emulate the tick loop's integer truncation (int(dt/itl)
        # tokens per tick, no carry) so both engines share dynamics
        self.quantize = 0.0
        # columnar outcome store installed by the event engines; None =
        # object-only recording (fixed tick, bare unit-test clusters)
        self.ledger = None
        # flight recorder (repro_torch.obs) attached by the engines when
        # telemetry is armed; every hook is one predicted branch when off
        self.obs = None
        # struct-of-arrays instance plane; ``catch_up`` uses the vectorized
        # pass at >= vec_min live instances (NumPy fixed costs lose below),
        # the scalar per-object loop otherwise. Equivalence tests pin
        # vec_min to 0/huge to force either path.
        self.plane = InstancePlane()
        self.vec_min = 33
        # armed once the fleet is big enough that the vectorized pass may
        # run: column syncs are skipped while unarmed (nothing reads
        # them) and arming does one full resync. Hysteresis on disarm
        # keeps a fleet hovering at the threshold from thrashing.
        self.plane_live = False

    # ------------------------------------------------------------ queries
    def by_type(self, itype: InstanceType) -> List[SimInstance]:
        """Live (maintained) pool list — treat as read-only; copy before
        retiring members while iterating."""
        return self._pools[itype]

    def by_model(self, model: str, itype: InstanceType) -> List[SimInstance]:
        """Live (model, type) pool — same read-only contract as by_type."""
        return self._model_pools.setdefault((model, itype), [])

    def pool_pair(self, model: str) -> Tuple[List[SimInstance],
                                             List[SimInstance]]:
        """(interactive pool, mixed pool) for ``model`` — the per-arrival
        routing pair, cached by model name. Pool list objects are stable
        (mutated in place, never replaced), so the cache never goes
        stale."""
        pair = self._pool_pairs.get(model)
        if pair is None:
            pair = self._pool_pairs[model] = (
                self.by_model(model, InstanceType.INTERACTIVE),
                self.by_model(model, InstanceType.MIXED))
        return pair

    def instances_of(self, model: str) -> List[SimInstance]:
        """All live instances serving ``model`` (every type)."""
        return [i for t in InstanceType
                for i in self._model_pools.get((model, t), ())]

    def n_instances_of(self, model: str) -> int:
        """O(1) live-instance count for ``model`` (maintained counter —
        the per-tick bootstrap/skip checks in the controller use this
        instead of building the ``instances_of`` list)."""
        return self._model_count.get(model, 0)

    def models_present(self) -> List[str]:
        """Distinct models with at least one live instance."""
        seen: Dict[str, None] = {}
        for inst in self.instances:
            seen.setdefault(inst.model)
        return list(seen)

    def active_instances(self) -> List[SimInstance]:
        return [i for i in self.instances if i.active]

    def active_sorted(self) -> List[SimInstance]:
        """Active instances in id order (failure/degradation victim draws;
        O(a log a) over the registry, not O(n) over every instance)."""
        out = list(self._active.values())
        out.sort(key=lambda i: i.id)
        return out

    @property
    def n_active(self) -> int:
        return len(self._active)

    def counts_by_type(self) -> Tuple[int, int, int]:
        """O(1) (interactive, mixed, batch) live-instance counts — the
        timeline-sample fast path."""
        p = self._pools
        return (len(p[InstanceType.INTERACTIVE]),
                len(p[InstanceType.MIXED]),
                len(p[InstanceType.BATCH]))

    def used_chips(self) -> int:
        return self._used_chips

    @property
    def hysteresis(self) -> float:
        """Total scaling actions / scale-ups (paper §2.3 definition)."""
        if self.scale_ups == 0:
            return 0.0
        return (self.scale_ups + self.scale_downs) / self.scale_ups

    # ------------------------------------------------------------ scaling
    def provision(self, model: str, itype: InstanceType, now: float,
                  **inst_kw) -> Optional[SimInstance]:
        perf = self.perf_factory(model)
        if self._used_chips + perf.chips > self.max_chips:
            return None
        chips0 = self._used_chips
        inst = SimInstance(perf, itype, now, load_time=self.load_time,
                           **inst_kw)
        inst.event_mode = self.event_mode
        inst._cluster = self
        inst._plane = self.plane
        inst.slot = self.plane.alloc(inst)
        self.instances.append(inst)
        self._pools[itype].append(inst)
        self._model_pools.setdefault((model, itype), []).append(inst)
        self._model_count[model] = self._model_count.get(model, 0) + 1
        self.scale_ups += 1
        self._used_chips += perf.chips
        self.peak_chips = max(self.peak_chips, self._used_chips)
        self.n_loading += 1
        self.route_version += 1
        if self.event_mode:
            self.new_loading.append(inst)
        if not self.plane_live and len(self.instances) >= self.vec_min:
            self._arm_plane()
        if self.obs is not None:
            self.obs.record_provision(self, now, model, itype,
                                      chips0, self._used_chips)
        return inst

    def _arm_plane(self) -> None:
        """Arm the vectorized plane: resync every live instance's columns
        (they were skipped while unarmed), then keep them in sync."""
        self.plane_live = True
        pl = self.plane
        for inst in self.instances:
            s = inst.slot
            if s < 0:
                continue
            pl.active[s] = inst.active
            pl.slow[s] = inst.slow_factor
            inst._sync_plane()

    def drain_new_loading(self) -> List[SimInstance]:
        """Instances provisioned since the last drain that still need a
        READY event scheduled (O(new) — replaces the per-tick scan over
        every instance)."""
        out = [i for i in self.new_loading
               if i.state == InstanceState.LOADING]
        self.new_loading.clear()
        return out

    def retire(self, inst: SimInstance) -> List[Request]:
        """Remove an instance; returns displaced requests for requeueing."""
        chips0 = self._used_chips
        displaced = self._remove_instance(inst)
        self.scale_downs += 1
        if self.obs is not None:
            self.obs.record_retire(self, self.now, inst,
                                   chips0, self._used_chips)
        return displaced

    def degrade_instance(self, inst: SimInstance, factor: float,
                         now: float) -> None:
        """Slow-node injection: inflate the victim's ITL by ``factor``
        without removing it. Fluid state is settled first so only future
        decode progress runs slow; in-flight work stays put (the partial
        failure mode crashes cannot model)."""
        if self.event_mode:
            inst.advance(now, False)  # settle at the healthy rate first
        inst.slow_factor = factor
        if inst.slot >= 0:
            self.plane.slow[inst.slot] = factor
        inst.mark_dirty()            # completion estimates must re-fire
        self.degradations += 1
        if self.obs is not None:
            self.obs.record_degrade(self, now, inst, factor)

    def recover_instance(self, inst: SimInstance, now: float) -> None:
        if self.event_mode:
            inst.advance(now, False)  # settle at the degraded rate first
        inst.slow_factor = 1.0
        if inst.slot >= 0:
            self.plane.slow[inst.slot] = 1.0
        inst.mark_dirty()
        if self.obs is not None:
            self.obs.record_recover(self, now, inst)

    def fail_instance(self, inst: SimInstance) -> List[Request]:
        """Crash an instance (failure injection): like ``retire`` but the
        removal is counted as a failure, not an autoscaling action, so the
        hysteresis metric stays a controller property. In-flight requests
        lose their on-device KV (``saved_kv=None`` — they must re-prefill
        elsewhere) and are returned for requeueing."""
        chips0 = self._used_chips
        displaced = self._remove_instance(inst)
        self.failures += 1
        if self.obs is not None:
            self.obs.record_fail(self, self.now, inst,
                                 chips0, self._used_chips)
        return displaced

    def _remove_instance(self, inst: SimInstance) -> List[Request]:
        if self.event_mode:
            inst.advance(self.now, False)   # settle fluid state first
            self.dirty.add(inst)     # pending finishes still get drained
        led = self.ledger
        displaced = []
        for s in inst.running.values():
            inst._materialize(s)
            r = s.request
            r.state = RequestState.PREEMPTED
            r.saved_kv = None   # instance gone; must re-prefill elsewhere
            if led is not None and r.row >= 0:
                led.state[r.row] = _ledger.PREEMPTED
            displaced.append(r)
        obs = self.obs
        if obs is not None:
            for r in displaced:     # lifecycle spans: back to queued
                obs.record_span(self.now, r.row, _SPAN_PREEMPT, inst.id)
        self.total_running -= len(inst.running)
        inst.running.clear()
        inst._batch_lifo.clear()
        inst._kv_tokens = 0.0
        inst._kv_prefill = 0.0
        inst._kv_dec_base = 0.0
        inst._n_dec = 0
        inst._n_interactive = 0
        inst._slo_counts.clear()
        inst._prefill_heap.clear()
        inst._decode_heap.clear()
        if inst.state == InstanceState.LOADING:
            self.n_loading -= 1
        inst.state = InstanceState.RETIRED
        inst.active = False
        self._active.pop(inst.id, None)
        if inst.slot >= 0:
            self.plane.free(inst.slot)
            inst.slot = -1
        self.instances.remove(inst)
        self._pools[inst.itype].remove(inst)
        self._model_pools[(inst.model, inst.itype)].remove(inst)
        self._model_count[inst.model] -= 1
        self._used_chips -= inst.perf.chips
        self.route_version += 1
        if self.plane_live and len(self.instances) < self.vec_min // 2:
            self.plane_live = False          # hysteresis disarm
        return displaced

    def tick_accounting(self, dt: float) -> None:
        self.chip_seconds += self.used_chips() * dt

    # --------------------------------------------------- event-driven core
    def advance_time(self, t: float) -> None:
        """Accrue chip-seconds over [now, t] (composition is constant
        between event batches) and move the cluster clock."""
        if t > self.now:
            self.chip_seconds += self._used_chips * (t - self.now)
            self.now = t

    def catch_up(self, t: float, batch_seq: int = -1) -> None:
        """Align every instance's fluid state with ``t`` (control ticks).

        At or above ``vec_min`` live instances this is one vectorized
        plane pass (plus scalar fall-back for instances with a crossing
        intrinsic event); below, the scalar loop — bit-identical results
        either way. Quantize mode always takes the scalar loop (the tick
        emulation's integer truncation isn't worth vectorizing)."""
        insts = self.instances
        if self.quantize > 0 or not self.event_mode \
                or len(insts) < self.vec_min:
            for inst in insts:
                inst.advance(t)
            return
        if not self.plane_live:
            self._arm_plane()        # vec_min lowered after provisioning
        self.plane.catch_up(t, self, batch_seq)

    def cached_eta(self, inst: SimInstance, batch_seq: int) -> float:
        """The completion ETA ``catch_up`` vector-computed for ``inst`` in
        event batch ``batch_seq``, or -1 when unavailable (mutated since /
        never computed) — the sweep then calls ``next_event_in``."""
        if inst._eta_stamp == batch_seq:
            return inst._eta_val
        return -1.0

    def sweep_etas(self, insts: List[SimInstance],
                   batch_seq: int) -> List[Tuple[SimInstance, float]]:
        """Completion ETAs for a sweep's dirty instances in one pass —
        the event loops' bulk-refill source (they stamp epochs and
        extend the heap from the returned pairs instead of re-pushing
        one estimate per instance).

        Instances whose ETA the vectorized catch-up already cached this
        event batch reuse it; the rest are recomputed — one vectorized
        pass over the plane columns when the plane is live (the
        coefficient math is ``InstancePlane._itl`` and the heads are the
        plane's *cleaned* mirrors, so the float sequence matches
        ``next_event_in`` exactly), the scalar path otherwise. Returns
        ``(instance, eta)`` pairs in input order, finite ETAs only."""
        if len(insts) < 8 or not self.plane_live or self.quantize != 0.0:
            # fused single pass — dirty sets are typically 1-2 deep and
            # the two-comprehension shape below costs more than the work
            out = []
            active = InstanceState.ACTIVE
            for inst in insts:
                if inst.state != active:
                    continue
                if inst._eta_stamp != batch_seq:
                    inst._eta_val = inst.next_event_in()
                    inst._eta_stamp = batch_seq
                e = inst._eta_val
                if e != _INF:
                    out.append((inst, e))
            return out
        stale = [i for i in insts
                 if i._eta_stamp != batch_seq
                 and i.state == InstanceState.ACTIVE]
        if stale:
            if len(stale) >= 8:
                pl = self.plane
                slots = np.fromiter((i.slot for i in stale),
                                    dtype=np.int64, count=len(stale))
                nr = pl.n_running[slots]
                run = nr > 0
                etas = np.full(len(stale), _INF)
                if run.any():
                    s = slots[run]
                    b = nr[run]
                    vc = pl.vclock[s]
                    kv = pl.kv_prefill[s] + pl.kv_dec_base[s] \
                        + pl.n_dec[s] * vc
                    ctx = np.maximum(kv / b, 1.0)
                    itl = pl._itl(s, b, ctx)
                    dec = (pl.next_vfin[s] - vc) * itl
                    dec = np.where(dec < 1e11, dec, _INF)  # stalled seqs
                    eta = np.minimum(
                        pl.next_prefill[s] - pl.last_advance[s], dec)
                    np.maximum(eta, self.completion_grain, out=eta)
                    etas[run] = eta
                for inst, e in zip(stale, etas.tolist()):
                    inst._eta_val = e
                    inst._eta_stamp = batch_seq
            else:
                for inst in stale:
                    inst._eta_val = inst.next_event_in()
                    inst._eta_stamp = batch_seq
        return [(i, i._eta_val) for i in insts
                if i.state == InstanceState.ACTIVE
                and i._eta_val != _INF and i._eta_stamp == batch_seq]

    def drain_dirty(self) -> List[SimInstance]:
        # deterministic order: set iteration is address-dependent, and this
        # order fixes event tie-breaks, backfill order, and the sequence
        # completions reach the estimator — same seed must mean same run
        d = self.dirty
        if len(d) == 1:
            return [d.pop()]
        out = sorted(d, key=_by_id)
        d.clear()
        return out

    def take_tokens(self) -> float:
        out = self.tok_accum
        self.tok_accum = 0.0
        return out
