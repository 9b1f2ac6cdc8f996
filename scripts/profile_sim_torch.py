#!/usr/bin/env python
"""Profile the port's simulator on any registered scenario.

The port's copy of ``scripts/profile_sim.py``: cProfile the event core
(or the fleet loop for fleet scenarios) over one scenario build and print
the top-N functions by tottime and cumtime — the first tool to reach for
before touching the hot path. Host code; the card budget defaults to 50,
the port's ``SimCluster`` default.

Usage::

    python scripts/profile_sim_torch.py                    # trace_replay
    python scripts/profile_sim_torch.py diurnal
    python scripts/profile_sim_torch.py trace_replay -n 100000
    python scripts/profile_sim_torch.py burst_spikes --top 40 --sort cumulative
    python scripts/profile_sim_torch.py multi_region --plain    # no profiler,
                                                                # wall + ev/s only
    python scripts/profile_sim_torch.py trace_replay --phases   # per-phase wall

``--plain`` runs without instrumentation (cProfile inflates Python-call
costs ~2x, so confirm wall-clock wins un-instrumented).

``--phases`` threads a :class:`PhaseTimers` accumulator through the
event core's ``phase_timers`` hook: the loop brackets its six numbered
phases (arrivals, heap_drain, control, routing, sweep, sampling) with
cheap ``perf_counter`` laps and this prints the per-phase wall-clock
breakdown — phase attribution without cProfile's ~2x call-cost noise,
so the next perf PR starts from data. Per-lap overhead is two clock
reads; totals run ~5-10% above ``--plain`` wall.

``--json`` (with ``--plain`` or ``--phases``) replaces the human
report with one machine-readable JSON object on stdout — scenario,
wall_s, events, events_per_s, completion_rate, and (under
``--phases``) the per-phase seconds — for harnesses and the
phase-attribution smoke test (tests/test_torch_examples.py).
"""
from __future__ import annotations

import argparse
import cProfile
import io
import json
import os
import pstats
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__))), "src"))

from repro_torch.sim.cluster import SimCluster                     # noqa: E402
from repro_torch.sim.controllers import ChironController           # noqa: E402
from repro_torch.sim.scenarios import SCENARIOS, build_trace       # noqa: E402
from repro_torch.sim.simulator import (default_perf_factory,       # noqa: E402
                                 simulate_events, simulate_fleet)


class PhaseTimers:
    """Accumulating wall-clock buckets for the event loop's six phases.

    Implements the duck-typed protocol ``simulate_events`` /
    ``simulate_fleet`` expect from ``phase_timers``: ``clock()`` returns
    an opaque monotonic reading and ``lap(name, t0)`` folds
    ``clock() - t0`` into the named bucket and returns the new reading
    (so consecutive laps share one clock read). Wall-clock lives here in
    ``scripts/`` — the simulator itself stays deterministic (DET202)."""

    def __init__(self):
        self.buckets = {}
        self.clock = time.perf_counter

    def lap(self, name: str, t0: float) -> float:
        t1 = time.perf_counter()
        self.buckets[name] = self.buckets.get(name, 0.0) + (t1 - t0)
        return t1

    def report(self, wall: float) -> str:
        total = sum(self.buckets.values()) or 1e-12
        lines = ["  phase        seconds   of-loop  of-wall"]
        for name, secs in sorted(self.buckets.items(),
                                 key=lambda kv: -kv[1]):
            lines.append(f"  {name:<12} {secs:7.3f}   {secs / total:6.1%}"
                         f"   {secs / wall:6.1%}")
        lines.append(f"  {'(loop total)':<12} {total:7.3f}            "
                     f"{total / wall:7.1%}")
        return "\n".join(lines)


def run_scenario(name: str, n_requests: int, seed: int, max_chips: int,
                 phase_timers=None):
    trace, kw = build_trace(name, n_requests=n_requests, seed=seed)
    if "fleet" in kw:
        return simulate_fleet(trace, kw["fleet"](),
                              max_time=kw["max_time"], warm_start=1,
                              failures=kw.get("failures"),
                              degradations=kw.get("degradations"),
                              phase_timers=phase_timers)
    cluster = SimCluster(default_perf_factory(), max_chips=max_chips)
    ctrl = ChironController(models=kw["models"]) if "models" in kw \
        else ChironController()
    return simulate_events(trace, ctrl, cluster, max_time=kw["max_time"],
                           warm_start=2, failures=kw.get("failures"),
                           degradations=kw.get("degradations"),
                           phase_timers=phase_timers)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("scenario", nargs="?", default="trace_replay",
                    choices=sorted(SCENARIOS))
    ap.add_argument("-n", "--n-requests", type=int, default=0,
                    help="override the scenario's default request count")
    ap.add_argument("--seed", type=int, default=3)
    ap.add_argument("--max-chips", type=int, default=50)
    ap.add_argument("--top", type=int, default=25,
                    help="rows per pstats table")
    ap.add_argument("--sort", default="tottime",
                    choices=["tottime", "cumulative", "ncalls"])
    ap.add_argument("--plain", action="store_true",
                    help="no profiler: wall time + events/s only")
    ap.add_argument("--phases", action="store_true",
                    help="no profiler: per-phase wall-clock breakdown")
    ap.add_argument("--json", action="store_true",
                    help="with --plain/--phases: emit one JSON object "
                         "instead of the human report")
    args = ap.parse_args()

    if args.plain or args.phases or args.json:
        timers = PhaseTimers() if args.phases else None
        t0 = time.perf_counter()
        res = run_scenario(args.scenario, args.n_requests, args.seed,
                           args.max_chips, phase_timers=timers)
        wall = time.perf_counter() - t0
        if args.json:
            out = {
                "scenario": args.scenario,
                "wall_s": wall,
                "events": res.n_events,
                "events_per_s": res.n_events / wall,
                "completion_rate": res.completion_rate(),
            }
            if timers is not None:
                out["phases"] = dict(sorted(timers.buckets.items()))
            print(json.dumps(out))
            return 0
        print(f"{args.scenario}: {wall:.3f}s wall, {res.n_events} events, "
              f"{res.n_events / wall:,.0f} events/s, "
              f"completion={res.completion_rate():.4f}")
        if timers is not None:
            print(timers.report(wall))
        return 0

    pr = cProfile.Profile()
    t0 = time.perf_counter()
    pr.enable()
    res = run_scenario(args.scenario, args.n_requests, args.seed,
                       args.max_chips)
    pr.disable()
    wall = time.perf_counter() - t0
    print(f"{args.scenario}: {wall:.3f}s wall (profiled), "
          f"{res.n_events} events, {res.n_events / wall:,.0f} events/s")
    out = io.StringIO()
    pstats.Stats(pr, stream=out).sort_stats(args.sort).print_stats(args.top)
    print(out.getvalue())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
