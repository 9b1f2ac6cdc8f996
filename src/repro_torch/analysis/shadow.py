"""Runtime shadow verification of the columnar mirrors.

The static mirror auditor (:mod:`repro_torch.analysis.checks`) proves every
mutation *site* pairs its object write with the column write — but it
cannot prove the paired writes store the same value, fire under the same
conditions, or that no site was exempted wrongly. The shadow verifier
closes that gap at runtime: the event engines
(``simulate_events``/``simulate_fleet`` with ``shadow_verify=True`` or
env ``CHIRON_SHADOW_VERIFY=1``) rebuild the ledger/plane columns from
the object view at control ticks and completion sweeps and assert
**exact** agreement — the mirrors are written at the same sites with the
same arithmetic, so any tolerance would only hide bugs.

Cost model: the plane check is O(instances) and runs at every control
tick and completion sweep; the ledger check is O(materialized requests)
and is throttled to every ``ledger_interval`` sim-seconds (pass ``0.0``
to check at every control tick — the deliberate-desync mutation test
needs that, since a corrupted in-flight cell is re-overwritten with the
correct value when the request finishes). A full ledger verification
always runs once more at the end of the run.
"""
from __future__ import annotations

import math
from typing import List, Optional

from repro_torch.sim.ledger import STATE_CODES


class ShadowVerifyError(AssertionError):
    """A columnar mirror disagreed with the object view it shadows."""


def _fail(what: str, detail: str) -> None:
    raise ShadowVerifyError(f"shadow-verify: {what}: {detail}")


class ShadowVerifier:
    """Rebuild-and-compare harness for the ledger and instance plane.

    ``plane_checks`` / ``ledger_checks`` / ``queue_checks`` count
    completed verifications so tests can assert the hooks actually ran.
    """

    def __init__(self, ledger_interval: float = 30.0):
        self.ledger_interval = ledger_interval
        self._next_ledger = 0.0
        self.plane_checks = 0
        self.ledger_checks = 0
        self.queue_checks = 0

    # ---------------------------------------------------- instance plane
    def verify_cluster(self, cluster) -> None:
        """Columns vs object scalars for every live slot. Only meaningful
        while the plane is armed (``plane_live``) — below the vectorized
        cut-over the columns are deliberately stale and never read."""
        if not cluster.event_mode or not cluster.plane_live:
            return
        pl = cluster.plane
        for inst in cluster.instances:
            s = inst.slot
            if s < 0:
                continue
            where = f"instance {inst.id} slot {s}"
            checks = (
                ("active", bool(pl.active[s]), inst.active),
                ("n_running", int(pl.n_running[s]), len(inst.running)),
                ("n_dec", int(pl.n_dec[s]), inst._n_dec),
                ("kv_prefill", float(pl.kv_prefill[s]), inst._kv_prefill),
                ("kv_dec_base", float(pl.kv_dec_base[s]),
                 inst._kv_dec_base),
                ("vclock", float(pl.vclock[s]), inst.vclock),
                ("last_advance", float(pl.last_advance[s]),
                 inst.last_advance),
                ("slow", float(pl.slow[s]), inst.slow_factor),
            )
            for col, got, want in checks:
                if got != want:
                    _fail(f"plane column `{col}` out of sync",
                          f"{where}: column={got!r} object={want!r}")
            # mirrored heads must match the earliest *valid* heap entries
            # (cleaning pops only invalid entries — unobservable)
            np_, nv = inst._clean_heads()
            if float(pl.next_prefill[s]) != np_ \
                    or float(pl.next_vfin[s]) != nv:
                _fail("plane event heads out of sync",
                      f"{where}: column=({float(pl.next_prefill[s])!r}, "
                      f"{float(pl.next_vfin[s])!r}) "
                      f"cleaned=({np_!r}, {nv!r})")
        self.plane_checks += 1

    # ------------------------------------------------------------ queue
    def verify_queue(self, queue) -> None:
        """Key columns vs payload ``Request`` objects for every live lane
        window of a columnar :class:`~repro_torch.serving.global_queue.
        GlobalQueue` (``QUEUE_MIRRORS``), plus the maintained
        interactive/batch counters against a recount. No-ops on the
        object-queue reference flavour (nothing columnar to shadow)."""
        if not getattr(queue, "columnar", False):
            return
        from repro_torch.serving.global_queue import QUEUE_MIRRORS
        mirrors = sorted(QUEUE_MIRRORS.items())
        for kind, model, lane in queue.audit_lanes():
            for i in range(lane.head, lane.tail):
                req = lane.req_objs[i]
                where = f"{kind} lane {model!r} index {i}"
                if req is None:
                    _fail("queue payload cell empty",
                          f"{where}: live window holds None")
                for attr, col in mirrors:
                    got = float(getattr(lane, col)[i])
                    want = float(getattr(req, attr))
                    if got != want:
                        _fail(f"queue column `{col}` out of sync",
                              f"{where}: column={got!r} "
                              f"request.{attr}={want!r}")
        n_i, n_b = queue.audit_counts()
        if n_i != queue._icount or n_b != queue._bcount:
            _fail("queue counters out of sync",
                  f"recount=({n_i}, {n_b}) "
                  f"counters=({queue._icount}, {queue._bcount})")
        self.queue_checks += 1

    # ----------------------------------------------------------- ledger
    def verify_ledger(self, ledger, requests: List) -> None:
        """Outcome columns vs ``Request`` attributes over every
        materialized request with a ledger row."""
        if ledger is None:
            return
        state = ledger.state
        tokens = ledger.tokens_generated
        retries = ledger.retries
        ftt = ledger.first_token_time
        fin = ledger.finish_time
        mitl = ledger.mean_itl
        for r in requests:
            row = r.row
            if row < 0:
                continue
            where = f"request {r.req_id} row {row}"
            if int(state[row]) != STATE_CODES[r.state]:
                _fail("ledger `state` out of sync",
                      f"{where}: column={int(state[row])} "
                      f"object={r.state!r}")
            if int(tokens[row]) != r.tokens_generated:
                _fail("ledger `tokens_generated` out of sync",
                      f"{where}: column={int(tokens[row])} "
                      f"object={r.tokens_generated}")
            if int(retries[row]) != r.retries:
                _fail("ledger `retries` out of sync",
                      f"{where}: column={int(retries[row])} "
                      f"object={r.retries}")
            self._check_optional(ftt, row, r.first_token_time,
                                 "first_token_time", where)
            self._check_optional(fin, row, r.finish_time,
                                 "finish_time", where)
            cell = float(mitl[row])
            if not r.itl_samples:
                if not math.isnan(cell):
                    _fail("ledger `mean_itl` out of sync",
                          f"{where}: column={cell!r} but no ITL samples")
            elif math.isnan(cell):
                _fail("ledger `mean_itl` out of sync",
                      f"{where}: column=NaN but {len(r.itl_samples)} "
                      "ITL sample(s)")
            elif len(r.itl_samples) == 1 and cell != r.itl_samples[0]:
                # the event core records exactly one lifetime-mean sample
                # at finish; a single-sample mean is bit-exact
                _fail("ledger `mean_itl` out of sync",
                      f"{where}: column={cell!r} "
                      f"object={r.itl_samples[0]!r}")
        self.ledger_checks += 1

    @staticmethod
    def _check_optional(col, row: int, value: Optional[float],
                        name: str, where: str) -> None:
        cell = float(col[row])
        if value is None:
            if not math.isnan(cell):
                _fail(f"ledger `{name}` out of sync",
                      f"{where}: column={cell!r} object=None")
        elif cell != value:
            _fail(f"ledger `{name}` out of sync",
                  f"{where}: column={cell!r} object={value!r}")

    def maybe_verify_ledger(self, ledger, requests: List,
                            t: float) -> None:
        """Throttled ledger check (see class docstring)."""
        if t < self._next_ledger:
            return
        self._next_ledger = t + self.ledger_interval
        self.verify_ledger(ledger, requests)


def resolve(shadow_verify) -> Optional[ShadowVerifier]:
    """Normalize the engines' ``shadow_verify`` argument: a verifier
    passes through, True builds one, None consults the
    ``CHIRON_SHADOW_VERIFY`` environment variable."""
    if isinstance(shadow_verify, ShadowVerifier):
        return shadow_verify
    if shadow_verify is None:
        import os
        shadow_verify = os.environ.get("CHIRON_SHADOW_VERIFY", "") \
            not in ("", "0", "false", "no")
    return ShadowVerifier() if shadow_verify else None
