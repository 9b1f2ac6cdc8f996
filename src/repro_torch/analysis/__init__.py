"""Static invariant auditor + runtime shadow-verify plane (the port's copy
of the reference's ``analysis`` package).

The simulator's columnar hot path keeps two views of every request and
instance — object fields (``Request``, ``SimInstance``) and columnar
mirrors (``RequestLedger``, ``InstancePlane``, the queue's lane columns) —
synchronized *by hand* at each mutation site, and its seed-for-seed
guarantees hang on that discipline plus strict determinism (seeded RNG,
totally-ordered event heaps, epsilon-tolerant event-time comparisons).
This package machine-checks those invariants instead of remembering them:

- **Mirror-sync auditor** (``MIR1xx``): machine-readable mirror
  registries declared next to the data structures
  (:data:`repro_torch.sim.ledger.LEDGER_MIRRORS`,
  :data:`repro_torch.sim.cluster.PLANE_MIRRORS` /
  :data:`~repro_torch.sim.cluster.PLANE_CONTAINER_MIRRORS`,
  :data:`repro_torch.serving.global_queue.QUEUE_MIRRORS`) drive an AST
  walk that flags any assignment to a mirrored attribute not paired — in
  the same function — with the corresponding ledger/plane column write or
  a ``_sync_plane()`` / ``plane.alloc`` / ``plane.free`` call, and any
  columnar-queue payload write not paired with its key-column writes. The
  mirror rules apply inside ``repro_torch/sim`` and
  ``repro_torch/serving``.
- **Determinism & heap-discipline lints** (``DET2xx``): unseeded global
  RNG, wall-clock reads outside ``benchmarks/``/``scripts/``, iteration
  over set expressions (address-dependent order) feeding decisions,
  ``heapq.heappush`` keys that are not total-order tuples, and raw
  comparisons of scheduled event times without an epsilon.
- **Hygiene lints** (``LINT3xx``): unused imports and mutable default
  arguments.
- **Shadow-verify plane** (:mod:`repro_torch.analysis.shadow`): at
  runtime, ``simulate_events(..., shadow_verify=True)`` (env
  ``CHIRON_SHADOW_VERIFY=1``) rebuilds the ledger/plane/queue columns from
  the objects at control ticks and completion sweeps and asserts exact
  agreement — any sync bug the static pass can't see fails loudly.

Rule catalogue
==============

========  ============================================================
rule id   flags
========  ============================================================
MIR101    ``Request`` mirrored-attribute write without the paired
          ``ledger.<col>[row]`` write in the same function
MIR102    ``SimInstance`` mirrored-scalar (or ``running`` container)
          write without a paired plane column write / ``_sync_plane()``
          / ``plane.alloc``/``free`` in the same function
MIR103    columnar-queue payload write (``req_objs[i] = req``) without
          paired writes to every key column (``seq``, ``arrival``,
          ``deadline``, ``row``) in the same function (``None``
          cell-clears exempt)
MIR104    terminal lifecycle write (``req.state = RequestState.<T>``
          for T in FINISHED/REJECTED/SHED/EXPIRED) without a ``state``
          column write naming the *same* terminal code in the same
          function (MIR101 alone cannot tell the codes apart)
DET201    unseeded global RNG: ``random.<fn>()`` or ``np.random.<fn>()``
          not going through ``default_rng``/``Generator``/``SeedSequence``
DET202    wall-clock read (``time.time``/``monotonic``/``perf_counter``,
          ``datetime.now``) outside ``benchmarks/``/``scripts/``
DET203    ``for``/comprehension over a set expression (set literal,
          ``set(...)``, unions/intersections of sets) without ``sorted``
DET204    ``heapq.heappush`` key that is not a tuple of >= 2 elements
          with a total-order tiebreaker (a ``seq``/``id``/``epoch``
          field or ``next(<counter>)``) after the time
DET205    raw ``<``/``<=``/``>``/``>=``/``==`` between a scheduled
          event-time attribute (``ready_time``, ``prefill_done_t``) and
          a current-time variable without an epsilon term
LINT301   unused module-level import
LINT302   mutable default argument (list/dict/set literal or call)
========  ============================================================

Suppressions
============

- ``# mirror-sync: ok(<reason>)`` on the offending line suppresses the
  MIR rules there; on a ``def`` line it exempts the whole function (the
  gated ``plane_live`` fast paths where callers settle + sync).
- ``# mirror-sync: module ok(<reason>)`` anywhere in a file exempts the
  whole module from the MIR rules (the real-engine modules, which have
  no ledger/plane to mirror into).
- ``# repro-lint: ok(RULE_ID, <reason>)`` suppresses any one rule on
  that line (or function, when on the ``def`` line).

Run ``python -m repro_torch.analysis src/repro_torch`` (``--json`` for
findings-as-JSON); exit status 1 when any finding survives, 2 on a usage
error.
"""
from __future__ import annotations

import os
from typing import List, Optional, Sequence

from repro_torch.analysis.findings import Finding, Suppressions
from repro_torch.analysis.checks import analyze_code
from repro_torch.analysis.shadow import ShadowVerifier, ShadowVerifyError, resolve

__all__ = ["Finding", "Suppressions", "analyze_code", "analyze_file",
           "run_analysis", "iter_py_files", "ShadowVerifier",
           "ShadowVerifyError", "resolve"]


def analyze_file(path: str, *, rules: Optional[Sequence[str]] = None,
                 ) -> List[Finding]:
    """Analyze one Python file (all rules unless ``rules`` narrows)."""
    with open(path, encoding="utf-8") as f:
        code = f.read()
    return analyze_code(code, path=path, rules=rules)


def iter_py_files(paths: Sequence[str]) -> List[str]:
    """Expand files/directories into a sorted list of ``.py`` files."""
    out: List[str] = []
    for p in paths:
        if os.path.isdir(p):
            for root, dirs, files in os.walk(p):
                dirs[:] = sorted(d for d in dirs
                                 if d not in ("__pycache__", ".git"))
                for name in sorted(files):
                    if name.endswith(".py"):
                        out.append(os.path.join(root, name))
        elif p.endswith(".py"):
            out.append(p)
    return sorted(dict.fromkeys(out))


def run_analysis(paths: Sequence[str], *,
                 rules: Optional[Sequence[str]] = None) -> List[Finding]:
    """Analyze every ``.py`` file under ``paths``; findings sorted by
    (path, line, rule). The mirror rules only apply inside the
    simulator/serving planes (the structures they audit live there);
    every other rule applies tree-wide."""
    findings: List[Finding] = []
    for path in iter_py_files(paths):
        findings.extend(analyze_file(path, rules=rules))
    findings.sort(key=lambda f: (f.path, f.line, f.rule))
    return findings
