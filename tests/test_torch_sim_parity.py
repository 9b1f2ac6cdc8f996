"""What the parity tests of the simulator's surface share (the auditor,
the exporters, the fleet tier and the scenarios import it): both packages'
modules side by side, the reference's planning constants patched into the
port's ``perf_model`` (the port's own are the H100's), fresh request and
instance counters in both packages before a run (a slow-node detector
hashes instance ids, so both must count alike), and equality of two runs,
two traces and two summaries. Its own tests show the patch and the counters
do what the others rely on."""
import dataclasses
import importlib
import itertools
import math
from types import SimpleNamespace

import numpy as np
import pytest

_MODULES = dict(
    workload="sim.workload", simulator="sim.simulator", cluster="sim.cluster",
    controllers="sim.controllers", perf="sim.perf_model", request="serving.request",
    queue="serving.global_queue", ledger="sim.ledger", fleet="sim.fleet",
    scenarios="sim.scenarios", trace_io="sim.trace_io", overload="sim.overload",
    shadow="analysis.shadow", recorder="obs.recorder", export="obs.export",
    obs_cli="obs.__main__", analysis="analysis", checks="analysis.checks",
    analysis_cli="analysis.__main__")


def _package(root):
    return SimpleNamespace(root=root, **{
        key: importlib.import_module(f"{root}.{name}") for key, name in _MODULES.items()})


REF, PORT = _package("repro"), _package("repro_torch")

# the reference's TPU planning constants, patched into the port's module
REF_CONSTANTS = {"PEAK_FLOPS": REF.perf.PEAK_FLOPS, "HBM_BW": REF.perf.HBM_BW,
                 "HBM_BYTES": REF.perf.HBM_BYTES, "LINK_BW": REF.perf.ICI_BW,
                 "STEP_OVERHEAD": REF.perf.STEP_OVERHEAD,
                 "MFU_DECODE": REF.perf.MFU_DECODE, "MBU": REF.perf.MBU,
                 "INSTANCE_CHIPS": dict(REF.perf.INSTANCE_CHIPS),
                 "_LOAD_BW": REF.perf._LOAD_BW}


@pytest.fixture
def patched(monkeypatch):
    for key, value in REF_CONSTANTS.items():
        monkeypatch.setattr(PORT.perf, key, value)
    return monkeypatch


def fresh_counters(P, monkeypatch):
    monkeypatch.setattr(P.request, "_req_counter", itertools.count())
    monkeypatch.setattr(P.cluster, "_inst_counter", itertools.count())


def run_scenario(P, trace, kw, **extra):
    """One scenario's trace through the engine it is made for, with the
    simulator arguments its builder suggests: ``simulate_fleet`` over its
    fleet, else ``simulate_events`` on its own chip cap (200 otherwise)."""
    opts = {key: kw.get(key) for key in ("failures", "degradations", "outages",
                                         "flash_crowds", "detector", "overload")}
    if "fleet" in kw:
        return P.simulator.simulate_fleet(trace, kw["fleet"](), max_time=kw["max_time"],
                                          warm_start=1, **opts, **extra)
    cluster = P.cluster.SimCluster(P.simulator.default_perf_factory(),
                                   max_chips=kw.get("max_chips", 200))
    ctrl = P.controllers.ChironController(**({"models": kw["models"]} if "models" in kw
                                             else {}))
    return P.simulator.simulate_events(trace, ctrl, cluster, max_time=kw["max_time"],
                                       warm_start=2, **opts, **extra)


def same(x, y):
    if isinstance(x, float) and isinstance(y, float) and math.isnan(x) and math.isnan(y):
        return True
    return x == y


def assert_same_summary(a, b):
    assert a.keys() == b.keys()
    assert {k: (a[k], b[k]) for k in a if not same(a[k], b[k])} == {}


def assert_same_trace(a, b):
    """Two ``Trace``s (one of each package) equal column for column."""
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, np.ndarray) or isinstance(y, np.ndarray):
            assert (x is None) == (y is None), f.name
            if x is not None:
                assert x.dtype == y.dtype, f.name
                np.testing.assert_array_equal(x, y, err_msg=f.name)
        else:
            assert x == y, f.name


def assert_same_run(ra, rb):
    """Two ``RunResult``s equal: summary, requests (by the ledger's columns
    when the run kept one), timeline, counters, fleet rollups and, when a
    flight recorder rode along, its every column."""
    assert_same_summary(ra.summary(), rb.summary())
    fields = ("chip_seconds", "peak_chips", "scale_ups", "scale_downs", "duration",
              "n_events", "failures", "degradations", "skipped_injections",
              "migrations", "handbacks", "egress_bytes", "egress_cost_usd")
    assert [getattr(ra, f) for f in fields] == [getattr(rb, f) for f in fields]
    assert [dataclasses.astuple(s) for s in ra.shocks] == \
        [dataclasses.astuple(s) for s in rb.shocks]
    assert [dataclasses.astuple(c) for c in ra.clusters] == \
        [dataclasses.astuple(c) for c in rb.clusters]
    assert [dataclasses.astuple(p) for p in ra.timeline] == \
        [dataclasses.astuple(p) for p in rb.timeline]
    assert (ra.ledger is None) == (rb.ledger is None)
    if ra.ledger is not None:
        assert ra.ledger.n == rb.ledger.n > 0
        for col in ("state", "first_token_time", "finish_time", "tokens_generated",
                    "mean_itl", "retries"):
            np.testing.assert_array_equal(getattr(ra.ledger, col), getattr(rb.ledger, col),
                                          err_msg=col)
    else:
        assert len(ra.requests) == len(rb.requests) > 0
        for a, b in zip(ra.requests, rb.requests):
            assert (a.state.value, a.first_token_time, a.finish_time, a.tokens_generated) == \
                (b.state.value, b.first_token_time, b.finish_time, b.tokens_generated)
    assert (ra.telemetry is None) == (rb.telemetry is None)
    if ra.telemetry is not None:
        ta, tb = ra.telemetry, rb.telemetry
        assert ta.cluster_names == tb.cluster_names
        assert ta.model_names == tb.model_names and ta.itype_names == tb.itype_names
        for part in ("signals", "cticks", "decisions", "spans"):
            a, b = getattr(ta, part), getattr(tb, part)
            assert a.n == b.n, part
            for name in a.column_names():
                np.testing.assert_array_equal(a.col(name), b.col(name),
                                              err_msg=f"{part}.{name}")
        assert ta.replay() == tb.replay()


def test_the_patch_makes_the_port_plan_as_the_reference(patched):
    for name in ("llama-8b", "llama-70b", "mamba2-1.3b"):
        ours, ref = PORT.perf.PerfModel(name), REF.perf.PerfModel(name)
        assert (ours.chips, ours.model_load_time(), ours.itl(8, 512.0)) == \
            (ref.chips, ref.model_load_time(), ref.itl(8, 512.0))
    patched.undo()
    assert PORT.perf.PerfModel("llama-8b").itl(8, 512.0) != \
        REF.perf.PerfModel("llama-8b").itl(8, 512.0)


def test_fresh_counters_number_both_packages_alike(monkeypatch):
    ids = []
    for P in (REF, PORT):
        fresh_counters(P, monkeypatch)
        reqs = P.workload.generate(P.workload.WorkloadSpec(n_requests=5, seed=1))
        inst = P.cluster.SimInstance(P.perf.PerfModel("llama-8b"),
                                     P.cluster.InstanceType.MIXED, 0.0)
        ids.append(([r.req_id for r in reqs], inst.id))
    assert ids[0] == ids[1] == ([0, 1, 2, 3, 4], 0)
