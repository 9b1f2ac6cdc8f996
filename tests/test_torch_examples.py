"""The torch twins of ``examples/*`` and ``scripts/*`` run end to end on the
CPU: each as a subprocess with ``--device cpu`` (the model-running ones) or
at the small sizes the reference's own tests use, under a time limit of its
own; its exit code and its key output line are checked. Without a GPU, a
model-running twin asked for its default device refuses to run."""
import json
import os
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODEL_TWINS = ["examples/quickstart_torch.py", "examples/serve_autoscaled_torch.py",
               "examples/train_tiny_torch.py", "scripts/dev_engine_torch.py",
               "scripts/dev_smoke_torch.py", "scripts/dev_kernels_torch.py"]


def _run(script, *args, timeout=90):
    # two intra-op threads: the suite's workers share the host's cores
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), OMP_NUM_THREADS="2")
    return subprocess.run([sys.executable, os.path.join(ROOT, script), *args],
                          env=env, cwd=ROOT, capture_output=True, text=True,
                          timeout=timeout)


def _ok(out):
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-3000:]
    return out.stdout


@pytest.mark.parametrize("script,args,key", [
    ("examples/quickstart_torch.py", [], "decoded 4 tokens, cache pos now [36, 36]"),
    ("examples/serve_autoscaled_torch.py", [], "8/8 requests served"),
    ("examples/serve_autoscaled_torch.py", ["--arch", "mamba2-1.3b"], "8/8 requests served"),
    ("scripts/dev_engine_torch.py", [], "ENGINE OK"),
    ("scripts/dev_smoke_torch.py", [], "ALL OK"),
    ("scripts/dev_kernels_torch.py", [], "ALL KERNELS OK"),
], ids=["quickstart", "serve_autoscaled", "serve_autoscaled_ssm", "dev_engine",
        "dev_smoke", "dev_kernels"])
def test_model_twin_runs_on_the_cpu(script, args, key):
    assert key in _ok(_run(script, *args, "--device", "cpu"))


def test_train_tiny_twin(tmp_path):
    """The ~100M olmo variant, two steps of 1 x 16, and its checkpoint."""
    path = str(tmp_path / "ckpt")
    out = _ok(_run("examples/train_tiny_torch.py", "--device", "cpu", "--steps", "2",
                   "--batch", "1", "--seq", "16", "--checkpoint", path))
    assert "loss " in out and " over 2 steps" in out
    assert f"checkpoint saved to {path}" in out and os.path.isdir(path)


@pytest.mark.parametrize("script", MODEL_TWINS)
def test_model_twin_refuses_the_cpu_unasked(script):
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU: the twins run on it")
    out = _run(script)
    assert out.returncode != 0 and "CUDA" in out.stderr, out.stderr[-2000:]


@pytest.mark.parametrize("script,key", [
    ("examples/cluster_experiment_torch.py", "Chiron vs Llumnix: GPU-hour savings"),
    ("examples/scenario_sweep_torch.py",
     "trace_replay via CSV: 2000 requests round-tripped"),
    ("scripts/dev_sim_torch.py", "Llumnix: {'slo_attainment'"),
], ids=["cluster_experiment", "scenario_sweep", "dev_sim"])
def test_simulator_twin_runs(script, key):
    assert key in _ok(_run(script))


def test_profile_sim_twin_phases_json_contract():
    """As ``tests/test_profile_sim.py`` holds the reference's: the six
    event-loop phases, positive laps, bounded by the end-to-end wall."""
    rep = json.loads(_ok(_run("scripts/profile_sim_torch.py", "diurnal", "-n", "400",
                              "--phases", "--json")))
    assert rep["scenario"] == "diurnal" and rep["events"] > 0
    assert rep["events_per_s"] == pytest.approx(rep["events"] / rep["wall_s"])
    assert set(rep["phases"]) == {"arrivals", "heap_drain", "control", "routing",
                                  "sweep", "sampling"}
    assert 0.0 < sum(rep["phases"].values()) <= rep["wall_s"] * 1.5


def test_ci_fast_twin_audits_and_collects_its_subset():
    """The auditor over ``src/repro_torch`` passes and the host-only subset
    collects (its tests run in the suite itself)."""
    out = _ok(_run("scripts/ci_fast_torch.py", "--collect-only", "-q",
                   "-p", "no:cacheprovider"))
    counts = {line.split(":")[0]: int(line.split(":")[1]) for line in out.splitlines()
              if line.startswith("tests/test_torch_")}
    assert len(counts) == 7 and sum(counts.values()) >= 150, out[-1000:]
