"""Walkthrough of the port: the columnar trace plane + the event-driven
simulator (host code, on the H100's planning constants).

Run:  PYTHONPATH=src python examples/scenario_sweep_torch.py

1. lists the registered scenarios,
2. runs two of them end-to-end on the event-driven engine straight from
   the columnar ``Trace`` (lazy request materialization),
3. runs the multi-model fleet (per-model SLO attainment on one shared
   chip budget) and the failure-injection scenario,
4. round-trips a trace through a CSV file (``trace_replay`` style),
5. shows the engine dispatch (`simulate(..., engine=...)`) and the
   event-vs-fixed-tick speedup on a small backlog drain.

The reference package's full benchmark (100k-request traces,
``BENCH_scenarios.json``) lives in ``benchmarks/scenario_sweep.py``; it has
no twin in the port.
"""
import os
import tempfile
import time

from repro_torch.sim.cluster import SimCluster
from repro_torch.sim.controllers import ChironController
from repro_torch.sim.scenarios import SCENARIOS, build_trace
from repro_torch.sim.simulator import default_perf_factory, simulate
from repro_torch.sim.trace_io import load_trace, save_trace


def _controller(kw):
    return ChironController(models=kw["models"]) if "models" in kw \
        else ChironController()


def main():
    print("registered scenarios:")
    for name, sc in sorted(SCENARIOS.items()):
        print(f"  {name:18s} {sc.description}")

    for name in ("diurnal", "multi_tenant_slo", "multi_model_fleet",
                 "instance_failures"):
        trace, kw = build_trace(name, n_requests=1200, seed=0)
        cluster = SimCluster(default_perf_factory(), max_chips=200)
        t0 = time.perf_counter()
        res = simulate(trace, _controller(kw), cluster,
                       max_time=kw["max_time"], warm_start=2,
                       failures=kw.get("failures"))
        wall = time.perf_counter() - t0
        s = res.summary()
        print(f"\n{name}: {trace.n} requests in {wall:.2f}s wall "
              f"({res.duration:.0f}s simulated)")
        print(f"  slo_attainment={s['slo_attainment']:.3f} "
              f"gpu_hours={s['gpu_hours']:.2f} "
              f"peak_chips={s['peak_chips']} "
              f"hysteresis={s['hysteresis']:.2f}")
        per_model = {k.split(':', 1)[1]: v for k, v in s.items()
                     if k.startswith('slo_model:')}
        if per_model:
            print(f"  per-model SLO: "
                  + " ".join(f"{m}={v:.3f}" for m, v in per_model.items()))
        if res.failures:
            print(f"  injected failures survived: {res.failures}")

    # trace replay: save a scenario to CSV, load it back, run the replay
    trace, kw = build_trace("trace_replay", n_requests=2000, seed=1)
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "trace.csv")
        save_trace(trace, path)
        replay = load_trace(path)
        res = simulate(replay, ChironController(),
                       SimCluster(default_perf_factory(), max_chips=200),
                       max_time=kw["max_time"], warm_start=2)
    print(f"\ntrace_replay via CSV: {replay.n} requests round-tripped, "
          f"slo={res.slo_attainment():.3f}")

    # engine dispatch: same trace, event core vs fixed-tick reference
    walls = {}
    for engine in ("event", "fixed"):
        trace_i, kw = build_trace("backlog_drain", n_requests=3000, seed=1)
        cluster = SimCluster(default_perf_factory(), max_chips=200)
        t0 = time.perf_counter()
        simulate(trace_i, ChironController(), cluster,
                 max_time=kw["max_time"], warm_start=2, engine=engine)
        walls[engine] = time.perf_counter() - t0
    print(f"\nbacklog_drain x3000: event {walls['event']:.2f}s vs "
          f"fixed-tick {walls['fixed']:.2f}s "
          f"({walls['fixed'] / walls['event']:.1f}x)")


if __name__ == "__main__":
    main()
