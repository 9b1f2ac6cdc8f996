#!/usr/bin/env python
"""Fast CI loop of the port: static gates + its host-only test subset.

Three blocking stages, cheapest first:

1. ``python -m repro_torch.analysis src/repro_torch`` — the port's
   invariant auditor (mirror-sync, determinism, hygiene rules). Zero
   findings or the build fails.
2. ``ruff check`` over the port, its tests and its twins — when ruff is
   installed (see requirements-dev.txt); skipped with a notice otherwise.
3. The port's host-only tests: the simulator, the global layer, the
   auditor, the exporters, the fleet tier and the scenarios, each held
   against the reference package's (which they import; neither side
   loads a model or a kernel). Well under a minute.

Usage:  python scripts/ci_fast_torch.py [extra pytest args]
"""
import glob
import os
import shutil
import subprocess
import sys
import time

FAST_TESTS = [
    "tests/test_torch_analysis.py",     # the auditor's fixtures, finding for finding
    "tests/test_torch_fleet.py",        # the fleet tier, seed for seed
    "tests/test_torch_global.py",       # queue, groups, QLM estimate, autoscalers,
                                        # PerfModel
    "tests/test_torch_obs_export.py",   # exporters line for line
    "tests/test_torch_scenarios.py",    # the 16 scenarios, seed for seed
    "tests/test_torch_sim_leaves.py",   # the simulator's leaf modules
    "tests/test_torch_simulator.py",    # simulate / simulate_events / fixed tick
]


def main() -> int:
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ)
    src = os.path.join(root, "src")
    env["PYTHONPATH"] = src + os.pathsep * bool(env.get("PYTHONPATH", "")) \
        + env.get("PYTHONPATH", "")
    # repro-lint: ok(DET202, CI wall clock)
    t0 = time.time()

    rc = subprocess.call([sys.executable, "-m", "repro_torch.analysis",
                          "src/repro_torch"], cwd=root, env=env)
    if rc != 0:
        print("ci_fast_torch: repro_torch.analysis found violations (see above)",
              file=sys.stderr)
        return rc

    ruff = shutil.which("ruff")
    if ruff:
        twins = sorted(glob.glob(os.path.join(root, "examples", "*_torch.py")) +
                       glob.glob(os.path.join(root, "scripts", "*_torch.py")))
        rc = subprocess.call([ruff, "check", "src/repro_torch", "chip_smoke.py",
                              *glob.glob(os.path.join(root, "tests", "test_torch_*.py")),
                              *twins], cwd=root, env=env)
        if rc != 0:
            print("ci_fast_torch: ruff check failed", file=sys.stderr)
            return rc
    else:
        print("ci_fast_torch: ruff not installed — skipping (the auditor's "
              "LINT rules still gate)", file=sys.stderr)

    cmd = [sys.executable, "-m", "pytest", "-q", *FAST_TESTS, *sys.argv[1:]]
    rc = subprocess.call(cmd, cwd=root, env=env)
    # repro-lint: ok(DET202, CI wall clock)
    print(f"ci_fast_torch: {time.time() - t0:.1f}s", file=sys.stderr)
    return rc


if __name__ == "__main__":
    raise SystemExit(main())
