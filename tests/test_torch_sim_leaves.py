"""The leaves of the port's simulator held against the reference's on the
CPU: the columnar trace plane (``sim/workload.py``), trace files
(``sim/trace_io.py``), the request ledger (``sim/ledger.py``), the overload
plane's gauges (``sim/overload.py``), the flight recorder (``obs``) and the
queue's simulator-only methods (``serving/global_queue.py``). Each case
feeds both packages the same inputs and asserts equal results, exactly."""
import itertools

import numpy as np
import pytest

from repro.obs import recorder as ref_recorder
from repro.serving import global_queue as ref_queue
from repro.serving import request as ref_request
from repro.sim import ledger as ref_ledger
from repro.sim import overload as ref_overload
from repro.sim import trace_io as ref_trace_io
from repro.sim import workload as ref_workload
from repro.sim.cluster import InstanceType as RefInstanceType
from repro_torch.obs import recorder
from repro_torch.serving import global_queue, request
from repro_torch.sim import ledger, overload, trace_io, workload
from repro_torch.sim.cluster import InstanceType

_COLUMNS = ("arrival", "prompt_len", "output_len", "interactive", "ttft_slo",
            "itl_slo", "model_idx")


def _assert_same_trace(a, b):
    assert a.n == b.n
    for name in _COLUMNS:
        x, y = getattr(a, name), getattr(b, name)
        assert x.dtype == y.dtype, name
        np.testing.assert_array_equal(x, y, err_msg=name)
    assert a.models == b.models
    assert a.origins == b.origins and a.tenants == b.tenants
    for name in ("origin_idx", "tenant_idx", "attempt"):
        x, y = getattr(a, name), getattr(b, name)
        assert (x is None) == (y is None), name
        if x is not None:
            np.testing.assert_array_equal(x, y, err_msg=name)


_SPECS = {
    "poisson": dict(n_requests=300, arrival_rate=12.0, interactive_frac=0.7, seed=1),
    "gamma": dict(n_requests=300, arrival_rate=12.0, process="gamma", cv=3.0, seed=2),
    "batch dump": dict(n_requests=120, arrival_rate=8.0, interactive_frac=1.0,
                       batch_queue_size=200, batch_ttft_slo=900.0, seed=7),
}


@pytest.mark.parametrize("name", list(_SPECS))
def test_generate_trace_is_the_same_column_for_column(name):
    a = ref_workload.generate_trace(ref_workload.WorkloadSpec(**_SPECS[name]))
    b = workload.generate_trace(workload.WorkloadSpec(**_SPECS[name]))
    _assert_same_trace(a, b)
    # ``generate`` materializes the same requests
    ra = ref_workload.generate(ref_workload.WorkloadSpec(**_SPECS[name]))
    rb = workload.generate(workload.WorkloadSpec(**_SPECS[name]))
    assert [(r.arrival_time, r.prompt_len, r.output_len, r.request_type.value,
             r.slo.ttft, r.slo.itl, r.model) for r in ra] == \
        [(r.arrival_time, r.prompt_len, r.output_len, r.request_type.value,
          r.slo.ttft, r.slo.itl, r.model) for r in rb]


def _two_models(wmod):
    a = wmod.generate_trace(wmod.WorkloadSpec(n_requests=80, arrival_rate=6.0,
                                              model="llama-8b", seed=3))
    b = wmod.generate_trace(wmod.WorkloadSpec(n_requests=50, arrival_rate=4.0,
                                              interactive_frac=0.5, model="granite-8b",
                                              seed=4))
    return wmod.Trace.concat([a, b]).sorted_by_arrival()


def test_make_trace_concat_and_two_models_are_the_same():
    a, b = _two_models(ref_workload), _two_models(workload)
    _assert_same_trace(a, b)
    assert b.models == ("llama-8b", "granite-8b")
    rng = np.random.default_rng(5)
    t = rng.uniform(0, 60, 90)
    ins, outs = rng.integers(4, 900, 90), rng.integers(4, 300, 90)
    cls = rng.random(90) < 0.6
    kw = dict(ttft_slo=3.0, batch_ttft_slo=600.0, model_idx=rng.integers(0, 2, 90),
              models=("llama-8b", "olmo-1b"), tenant_idx=rng.integers(0, 2, 90),
              tenants=("acme", "globex"), attempt=rng.integers(0, 3, 90))
    _assert_same_trace(ref_workload.make_trace(t, ins, outs, cls, **kw),
                       workload.make_trace(t, ins, outs, cls, **kw))


def test_trace_stream_chunks_and_materialize_are_the_same(monkeypatch):
    chunks = {}
    for name, wmod, req in (("ref", ref_workload, ref_request), ("port", workload, request)):
        tr = _two_models(wmod)
        stream = wmod.TraceStream([tr.take(slice(0, 40)), tr.take(slice(40, 40)),
                                   tr.take(slice(40, 130))])
        chunks[name] = list(stream)
        monkeypatch.setattr(req, "_req_counter", itertools.count())
        chunks[name + " requests"] = tr.materialize(row0=0)
    assert len(chunks["ref"]) == len(chunks["port"]) == 2      # the empty one skipped
    for a, b in zip(chunks["ref"], chunks["port"]):
        _assert_same_trace(a, b)
    assert [(r.req_id, r.row, r.model, r.arrival_time, r.slo.ttft)
            for r in chunks["ref requests"]] == \
        [(r.req_id, r.row, r.model, r.arrival_time, r.slo.ttft)
         for r in chunks["port requests"]]
    bad = workload.TraceStream([_two_models(workload).take(slice(40, 130)),
                                _two_models(workload).head(40)])
    next(bad)
    with pytest.raises(ValueError, match="arrival-sorted"):
        next(bad)


def test_arrival_spikes_take_a_trace():
    a, b = _two_models(ref_workload), _two_models(workload)
    np.testing.assert_array_equal(workload.arrival_spikes(b, 10.0),
                                  ref_workload.arrival_spikes(a, 10.0))
    assert workload.theta_from_history(b, 10.0) == ref_workload.theta_from_history(a, 10.0)


@pytest.mark.parametrize("ext", ["csv", "jsonl", "csv.gz", "jsonl.gz"])
def test_trace_files_round_trip_across_the_packages(tmp_path, ext):
    a, b = _two_models(ref_workload), _two_models(workload)
    ref_path, port_path = str(tmp_path / f"ref.{ext}"), str(tmp_path / f"port.{ext}")
    ref_trace_io.save_trace(a, ref_path)
    trace_io.save_trace(b, port_path)
    # what one package writes, the other reads, and both read the same
    _assert_same_trace(trace_io.load_trace(ref_path), ref_trace_io.load_trace(ref_path))
    _assert_same_trace(ref_trace_io.load_trace(port_path), trace_io.load_trace(port_path))
    # and the files the two write read back alike
    _assert_same_trace(trace_io.load_trace(ref_path), trace_io.load_trace(port_path))
    with open(ref_path, "rb") as f, open(port_path, "rb") as g:
        if not ext.endswith("gz"):
            assert f.read() == g.read()
    streamed = list(trace_io.stream_trace(ref_path, chunk_requests=32))
    want = list(ref_trace_io.stream_trace(port_path, chunk_requests=32))
    assert len(streamed) == len(want) > 1
    for x, y in zip(streamed, want):
        _assert_same_trace(x, y)


def test_ledger_transitions_and_state_codes(monkeypatch):
    assert {k.value: v for k, v in ledger.STATE_CODES.items()} == \
        {k.value: v for k, v in ref_ledger.STATE_CODES.items()}
    assert ledger.LEDGER_MIRRORS == ref_ledger.LEDGER_MIRRORS
    assert (ledger.QUEUED, ledger.FINISHED, ledger.REJECTED, ledger.SHED,
            ledger.EXPIRED) == (ref_ledger.QUEUED, ref_ledger.FINISHED,
                                ref_ledger.REJECTED, ref_ledger.SHED, ref_ledger.EXPIRED)
    out = {}
    for name, wmod, lmod, req in (("ref", ref_workload, ref_ledger, ref_request),
                                  ("port", workload, ledger, request)):
        monkeypatch.setattr(req, "_req_counter", itertools.count())
        tr = _two_models(wmod)
        led = lmod.RequestLedger.from_trace(tr)
        reqs = tr.materialize(row0=0)
        led.mark_rejected(reqs[0])
        led.mark_shed(reqs[1])
        led.mark_expired(reqs[2])
        led.mark_queued(reqs[0])
        assert led.bump_retry(reqs[0]) == 1
        led.mark_rejected(reqs[0])
        for r in reqs[3:40]:
            r.first_token_time = r.arrival_time + 0.5
            r.finish_time = r.arrival_time + 2.0
            r.tokens_generated = r.output_len
            led.first_token_time[r.row] = r.first_token_time
            led.finish_time[r.row] = r.finish_time
            led.tokens_generated[r.row] = r.tokens_generated
            led.state[r.row] = lmod.FINISHED
        more = led.extend_from_trace(_two_models(wmod).head(10))
        out[name] = (led, [r.state.value for r in reqs], more)
    (a, sa, ma), (b, sb, mb) = out["ref"], out["port"]
    assert sa == sb and ma == mb and a.n == b.n
    for col in ("state", "retries", "first_token_time", "finish_time",
                "tokens_generated", "arrival", "model_idx"):
        np.testing.assert_array_equal(getattr(a, col), getattr(b, col), err_msg=col)
    np.testing.assert_array_equal(a.state_counts(), b.state_counts())
    assert a.slo_attainment() == b.slo_attainment()
    assert a.slo_by_model() == b.slo_by_model()
    assert a.goodput(60.0) == b.goodput(60.0)


class _Cluster:
    def __init__(self, perf, max_chips, used):
        self.perf_factory = lambda model: perf
        self.max_chips, self._used = max_chips, used

    def used_chips(self):
        return self._used


def test_overload_gauges_and_breaker_driven_alike():
    from repro.sim.controllers import ChironController as RefChiron
    from repro.sim.perf_model import PerfModel as RefPerfModel
    from repro_torch.sim import perf_model
    from repro_torch.sim.controllers import ChironController
    assert overload.RetryPolicy().backoff(7, 3) == ref_overload.RetryPolicy().backoff(7, 3)
    assert [overload.RetryPolicy(jitter=0.3).backoff(r, k) for r in range(5)
            for k in range(1, 4)] == \
        [ref_overload.RetryPolicy(jitter=0.3).backoff(r, k) for r in range(5)
         for k in range(1, 4)]
    cfg, rcfg = overload.OverloadConfig.full(slack=0.3), ref_overload.OverloadConfig.full(slack=0.3)
    assert cfg.active and rcfg.active and not overload.OverloadConfig().active
    # brownout hysteresis over the same overloaded/healthy stream
    rng = np.random.default_rng(8)
    stream = (rng.random(200) < 0.6).tolist()
    ours, ref = overload.BrownoutState(), ref_overload.BrownoutState()
    assert [ours.update(x, cfg.brownout) for x in stream] == \
        [ref.update(x, rcfg.brownout) for x in stream]
    # the breaker over the same outcomes and clock
    bcfg = dict(ewma_alpha=0.4, open_threshold=0.5, cooldown=5.0, trial_successes=2,
                min_samples=4)
    ours = overload.CircuitBreaker(overload.BreakerConfig(**bcfg))
    ref = ref_overload.CircuitBreaker(ref_overload.BreakerConfig(**bcfg))
    trail_ours, trail_ref = [], []
    for i, rejected in enumerate((rng.random(300) < 0.45).tolist()):
        now = 0.7 * i
        for b, trail in ((ours, trail_ours), (ref, trail_ref)):
            if b.allows(now):
                trail.append((b.record(rejected, now), b.state, b.ewma, b.samples))
            else:
                trail.append(("refused", b.state))
    assert trail_ours == trail_ref
    assert {s for s in trail_ours if s[0] not in (None, "refused")}  # it moved
    # the wait gauge on the same estimator state and the same planning model
    pm = perf_model.PerfModel("llama-8b")
    rpm = RefPerfModel("llama-8b")
    port_ctrl, ref_ctrl = ChironController(), RefChiron()
    for ctrl in (port_ctrl, ref_ctrl):
        om = ctrl._estimator_for("llama-8b").output_model
        for o in (40, 300, 120, 75):
            om.observe(o)
    for queued in (0, 5, 40):
        q, rq = global_queue.GlobalQueue(), ref_queue.GlobalQueue()
        for _ in range(queued):
            q.push(request.make_interactive(100, 50))
            rq.push(ref_request.make_interactive(100, 50))
        # both gauges plan on one model (the two packages' constants differ):
        # what must agree is the gauges' arithmetic on it
        g = overload.WaitGauge(port_ctrl, _Cluster(rpm, 16, 12))
        rg = ref_overload.WaitGauge(ref_ctrl, _Cluster(rpm, 16, 12))
        assert g.supported and rg.supported
        assert g.wait(q, "llama-8b") == rg.wait(rq, "llama-8b")
        assert g.per_request_wait("llama-8b") == rg.per_request_wait("llama-8b")
        assert g.min_chips() == rg.min_chips()
        for used in (12, 16):
            assert overload.is_overloaded(_Cluster(rpm, 16, used), q, g, cfg.brownout) == \
                ref_overload.is_overloaded(_Cluster(rpm, 16, used), rq, rg, rcfg.brownout)
    assert overload.WaitGauge(port_ctrl, _Cluster(pm, 16, 0)).min_chips() == pm.chips


class _Inst:
    def __init__(self, i, itype, model):
        self.id, self.itype, self.model, self.chips = i, itype, model, 1


def _drive_recorder(rmod, itypes):
    """The same calls on a recorder of either package."""
    rec = rmod.FlightRecorder(span_sample=0.5, span_seed=3)
    cluster = _Cluster(None, 8, 2)
    rec.register_cluster(cluster, "main")
    inter, mixed, batch = (_Inst(0, itypes.INTERACTIVE, "llama-8b"),
                           _Inst(1, itypes.MIXED, "llama-8b"),
                           _Inst(2, itypes.BATCH, "granite-8b"))
    rec.set_context(rmod.R_IBP_HIGH, 0.6, 0.43)
    rec.record_provision(cluster, 1.0, "llama-8b", itypes.MIXED, 0, 1)
    rec.clear_context()
    rec.set_context(rmod.R_BBP_ADD, 3.0, 0.0)
    rec.record_provision(cluster, 2.0, "granite-8b", itypes.BATCH, 1, 2)
    rec.record_retire(cluster, 5.0, batch, 2, 1)
    rec.record_fail(cluster, 6.0, inter, 1, 0)
    rec.record_degrade(cluster, 7.0, mixed, 4.0)
    rec.record_recover(cluster, 9.0, mixed)
    for row in range(40):
        rec.record_admit(0.1 * row, row, row % 3)
        if rec.sampled(row):
            rec.record_span(0.1 * row + 0.05, row, rmod.SPAN_PREEMPT, row % 3)
    return rec


def test_flight_recorder_columns_after_the_same_calls():
    assert (recorder.REASON_NAMES, recorder.KIND_NAMES, recorder.SPAN_NAMES) == \
        (ref_recorder.REASON_NAMES, ref_recorder.KIND_NAMES, ref_recorder.SPAN_NAMES)
    ours = _drive_recorder(recorder, InstanceType)
    ref = _drive_recorder(ref_recorder, RefInstanceType)
    for part in ("signals", "cticks", "decisions", "spans"):
        a, b = getattr(ours, part), getattr(ref, part)
        assert a.column_names() == b.column_names() and a.n == b.n, part
        for name in a.column_names():
            np.testing.assert_array_equal(a.col(name), b.col(name), err_msg=f"{part}.{name}")
    assert ours.replay() == ref.replay()
    assert ours.decisions.n == 6 and 0 < ours.spans.n < 80
    assert ours.itype_names == ref.itype_names == ["mixed", "batch", "interactive"]
    assert ours.model_names == ref.model_names == ["llama-8b", "granite-8b"]
    assert recorder.resolve(None) is None and recorder.resolve(False) is None
    assert isinstance(recorder.resolve(True), recorder.FlightRecorder)


def _queue_requests(req):
    """Interactive and batch requests of two models with arrivals, SLOs and
    a host-saved KV on one (a resume-lane entry) from a seed."""
    rng = np.random.default_rng(6)
    out = []
    for i in range(60):
        model = ("llama-8b", "granite-8b")[i % 2]
        t = float(i) * 0.25
        if rng.random() < 0.5:
            r = req.make_interactive(int(rng.integers(8, 400)), 40, arrival=t, model=model)
            r.slo = req.SLO(float(rng.choice([2.0, 4.0, 8.0])), r.slo.itl)
        else:
            r = req.make_batch(int(rng.integers(8, 400)), 40, arrival=t, model=model,
                               ttft_slo=float(rng.choice([60.0, 300.0])))
        out.append(r)
    return out


class _Listener:
    def __init__(self):
        self.log = []

    def on_add(self, req):
        self.log.append(("add", req.req_id))

    def on_remove(self, req):
        self.log.append(("remove", req.req_id))


def _drive_queue(qcls, req, monkeypatch):
    monkeypatch.setattr(req, "_req_counter", itertools.count())
    reqs = _queue_requests(req)
    q = qcls()
    listener = _Listener()
    q.attach_batch_listener(listener, model="granite-8b")
    for r in reqs:
        q.push(r)
    # two batch requests come back, one with host-saved KV
    b = [r for r in reqs if not r.is_interactive][:2]
    q.pop_batch_fcfs(b[0].model)
    popped = q.pop_batch_fcfs(b[1].model)
    popped.saved_kv = object()
    q.requeue(popped)
    log = [("pop", q.pop_interactive("llama-8b").req_id)]
    if hasattr(q, "sweep_interactive"):
        expired, shed = q.sweep_interactive(9.0, wait_by_model={"granite-8b": 0.5})
        log.append(("swept", [r.req_id for r in expired], [r.req_id for r in shed]))
        log.append(("audit", q.audit_counts(),
                    sorted((k, m, lane.tail - lane.head) for k, m, lane in q.audit_lanes())))
    log.append(("drain", [r.req_id for r in q.drain_model("granite-8b")]))
    log.append(("left", q.n_interactive, q.n_batch, len(q),
                [r.req_id for r in q.iter_batch("llama-8b")],
                [r.req_id for r in q.interactive]))
    log.append(("listener", listener.log))
    return log


@pytest.mark.parametrize("flavour", ["GlobalQueue", "ReferenceGlobalQueue"])
def test_queue_sweep_drain_and_audits_match(flavour, monkeypatch):
    ours = _drive_queue(getattr(global_queue, flavour), request, monkeypatch)
    ref = _drive_queue(getattr(ref_queue, flavour), ref_request, monkeypatch)
    assert ours == ref
    assert any(entry[0] == "drain" and entry[1] for entry in ours)
    assert global_queue.QUEUE_MIRRORS == ref_queue.QUEUE_MIRRORS
    assert global_queue.QUEUE_KEY_COLUMNS == ref_queue.QUEUE_KEY_COLUMNS
    assert isinstance(global_queue.make_queue(True), global_queue.ReferenceGlobalQueue)
    assert isinstance(global_queue.make_queue(False), global_queue.GlobalQueue)
