"""The port's scenario library (``repro_torch.sim.scenarios``) held against
the reference's on the CPU.

Both registries hold the same scenarios with the same descriptions and
default sizes. Every builder, given the same size and seed, draws the same
trace column for column and suggests the same simulator arguments, and the
run through the engine the scenario is made for (``simulate_fleet`` for a
fleet, ``simulate_events`` otherwise) is the reference's, under the
reference's planning constants. ``trace_replay`` reads a file written by
the port's ``trace_io``, whole and streamed."""
import dataclasses

import numpy as np
import pytest

from test_torch_sim_parity import (PORT, REF, assert_same_run, assert_same_trace,  # noqa: F401
                                   fresh_counters, patched, run_scenario)

N = 200


def test_the_registries_are_the_references():
    assert list(PORT.scenarios.SCENARIOS) == list(REF.scenarios.SCENARIOS)
    assert len(PORT.scenarios.SCENARIOS) == 16
    for name, sc in PORT.scenarios.SCENARIOS.items():
        ref = REF.scenarios.SCENARIOS[name]
        assert (sc.name, sc.description, sc.default_n) == \
            (ref.name, ref.description, ref.default_n)


def _plain(value):
    """A simulator argument in a form that compares across the packages."""
    if dataclasses.is_dataclass(value):
        return type(value).__name__, dataclasses.asdict(value)
    if callable(value):                                  # a fleet factory
        fleet = value()
        return [dataclasses.asdict(fc.spec) for fc in fleet.clusters], \
            fleet.topology.regions, fleet.models
    return value


@pytest.mark.parametrize("name", sorted(REF.scenarios.SCENARIOS))
def test_every_scenario_builds_and_runs_as_the_reference(name, patched):  # noqa: F811
    built = {}
    for P in (REF, PORT):
        fresh_counters(P, patched)
        trace, kw = P.scenarios.build_trace(name, n_requests=N, seed=5)
        built[P.root] = trace, kw, run_scenario(P, trace, kw)
    (ta, ka, ra), (tb, kb, rb) = built["repro"], built["repro_torch"]
    assert isinstance(tb, PORT.workload.Trace) and tb.n == ta.n > 0
    assert_same_trace(ta, tb)
    assert ka.keys() == kb.keys()
    assert {k: _plain(v) for k, v in ka.items()} == {k: _plain(v) for k, v in kb.items()}
    assert_same_run(ra, rb)
    assert rb.completion_rate() > 0.5


@pytest.mark.parametrize("name", ["diurnal", "backlog_drain", "flash_crowd", "multi_region"])
def test_the_materialized_requests_are_the_references(name, patched):  # noqa: F811
    reqs = {}
    for P in (REF, PORT):
        fresh_counters(P, patched)
        reqs[P.root], _ = P.scenarios.build(name, n_requests=N, seed=2)
    fields = ("req_id", "arrival_time", "prompt_len", "output_len", "model", "origin",
              "tenant", "row")

    def rows(rs):
        return [(r.request_type.value, r.slo.ttft, r.slo.itl)
                + tuple(getattr(r, f) for f in fields) for r in rs]
    assert rows(reqs["repro_torch"]) == rows(reqs["repro"])
    assert len(reqs["repro_torch"]) >= N        # a flash crowd adds its own


@pytest.mark.parametrize("suffix", [".csv", ".jsonl.gz"])
def test_trace_replay_from_a_written_file(suffix, tmp_path, patched):  # noqa: F811
    """A trace the port's ``trace_io`` writes is replayed by both packages'
    ``trace_replay(path=...)``: the same trace whole, the same chunks
    streamed, and the same runs from either."""
    synth, _ = PORT.scenarios.build_trace("multi_tenant_slo", n_requests=300, seed=3)
    path = str(tmp_path / f"replay{suffix}")
    PORT.trace_io.save_trace(synth, path)
    whole = {P.root: P.scenarios.build_trace("trace_replay", n_requests=250, seed=99,
                                             path=path) for P in (REF, PORT)}
    (ta, ka), (tb, kb) = whole["repro"], whole["repro_torch"]
    assert_same_trace(ta, tb)
    assert ka == kb and tb.n == 250
    np.testing.assert_array_equal(tb.arrival, synth.arrival[:250])
    np.testing.assert_array_equal(tb.ttft_slo, synth.ttft_slo[:250])
    runs = []
    for P, (trace, kw) in ((REF, whole["repro"]), (PORT, whole["repro_torch"])):
        fresh_counters(P, patched)
        runs.append(run_scenario(P, trace, kw))
    assert_same_run(*runs)

    def streamed(P):
        src, kw = P.scenarios.build_trace("trace_replay", n_requests=250, path=path,
                                          stream=True, chunk_requests=64, max_time=1200.0)
        assert isinstance(src, P.workload.TraceStream) and kw == {"max_time": 1200.0}
        return src
    chunks = [list(streamed(P)) for P in (REF, PORT)]
    assert [c.n for c in chunks[1]] == [64, 64, 64, 58]
    for a, b in zip(*chunks):
        assert_same_trace(a, b)
    runs = []
    for P in (REF, PORT):
        fresh_counters(P, patched)
        runs.append(run_scenario(P, streamed(P), {"max_time": 1200.0}))
    assert_same_run(*runs)
