"""The port's flight-recorder exporters (``repro_torch.obs.export``) and
terminal dashboards (``python -m repro_torch.obs``) held against the
reference's on the CPU.

One seeded telemetry run in each package, under the reference's planning
constants: ``to_jsonl`` writes the same lines (the header's
``generated_unix`` wall-clock stamp aside), ``to_perfetto`` the same
document and ``to_prometheus`` the same text, and the dashboards print the
same text but for the line that names the file."""
import contextlib
import io
import json

import pytest

from test_torch_sim_parity import PORT, REF, fresh_counters, patched, run_scenario  # noqa: F401


def _telemetry_run(P, monkeypatch, name, n):
    fresh_counters(P, monkeypatch)
    trace, kw = P.scenarios.build_trace(name, n_requests=n, seed=7)
    return run_scenario(P, trace, kw, telemetry=P.recorder.FlightRecorder(span_sample=0.5))


# a single-cluster run with two models, a fleet run (clusters by name,
# migrations), and an overload run (rejections, retries, the outcome rates)
RUNS = {"multi_model_fleet": 300, "zone_outage": 300, "retry_storm": 200}


@pytest.fixture(params=list(RUNS))
def runs(request, patched):  # noqa: F811
    name = request.param
    return {P.root: _telemetry_run(P, patched, name, RUNS[name]) for P in (REF, PORT)}


def _jsonl(P, res, path):
    n = P.export.to_jsonl(res, path)
    lines = [json.loads(s) for s in path.read_text().splitlines()]
    assert len(lines) == n and lines[0]["kind"] == "meta"
    assert isinstance(lines[0].pop("generated_unix"), float)
    return lines


def test_jsonl_is_the_reference_line_for_line(runs, tmp_path):
    ref = _jsonl(REF, runs["repro"], tmp_path / "ref.jsonl")
    port = _jsonl(PORT, runs["repro_torch"], tmp_path / "port.jsonl")
    assert len(port) == len(ref)
    for i, (a, b) in enumerate(zip(ref, port)):
        assert a == b, i
    kinds = {row["kind"] for row in port}
    assert {"meta", "timeline", "signal", "cluster", "decision", "request"} <= kinds
    rec = runs["repro_torch"].telemetry
    assert sum(row["kind"] == "decision" for row in port) == rec.decisions.n
    assert sum(row["kind"] == "signal" for row in port) == rec.signals.n


def test_perfetto_and_prometheus_are_the_references(runs, tmp_path):
    ref, port = runs["repro"], runs["repro_torch"]
    doc = PORT.export.to_perfetto(port, tmp_path / "trace.json")
    assert doc == REF.export.to_perfetto(ref)
    assert json.loads((tmp_path / "trace.json").read_text()) == doc
    assert any(e["ph"] == "X" for e in doc["traceEvents"])
    text = PORT.export.to_prometheus(port, tmp_path / "metrics.prom")
    assert text == REF.export.to_prometheus(ref)
    assert (tmp_path / "metrics.prom").read_text() == text
    assert "chiron_chips_in_use" in text
    assert PORT.export.sampled_requests(port, port.telemetry) == \
        REF.export.sampled_requests(ref, ref.telemetry)


def _dashboard(P, path, *args):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert P.obs_cli.main([str(path), *args]) == 0
    first, *rest = out.getvalue().splitlines()
    assert first == f"flight recorder: {path}"
    return rest


def test_the_dashboards_print_the_references(runs, tmp_path):
    for P in (REF, PORT):
        P.export.to_jsonl(runs[P.root], tmp_path / f"{P.root}.jsonl")
    models = runs["repro_torch"].telemetry.model_names
    for args in ([], ["--model", models[0], "--waterfalls", "3", "--width", "40"]):
        port = _dashboard(PORT, tmp_path / "repro_torch.jsonl", *args)
        assert port == _dashboard(REF, tmp_path / "repro.jsonl", *args)
        assert any("decision ledger" in line for line in port)


def test_an_export_needs_a_recorder(patched):  # noqa: F811
    fresh_counters(PORT, patched)
    trace, kw = PORT.scenarios.build_trace("diurnal", n_requests=50, seed=1)
    res = PORT.simulator.simulate_events(
        trace, PORT.controllers.ChironController(),
        PORT.cluster.SimCluster(PORT.simulator.default_perf_factory(), max_chips=200),
        max_time=kw["max_time"], warm_start=2)
    with pytest.raises(ValueError, match="telemetry"):
        PORT.export.to_prometheus(res)
