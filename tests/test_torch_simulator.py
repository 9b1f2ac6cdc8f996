"""The port's simulator (``repro_torch.sim.simulator``) held against the
reference's seed for seed on the CPU.

Each case draws its requests from the same spec and seed once per package
(the simulator writes into its ``Request`` objects, so a list is never
shared), resets both packages' request and instance counters, patches the
reference's planning constants into the port's ``perf_model`` (the port's
own are the H100's) and runs both. The ``summary()`` dicts, every request's
``(state, first_token_time, finish_time, tokens_generated)``, the timeline
and the ledger's columns must be equal, exactly: the port runs the same
numpy operations in the same order. One case runs on the port's own
constants and differs, which shows the patch, not luck, makes the others
equal."""
import math

import numpy as np
import pytest

from test_torch_sim_parity import PORT, REF, assert_same_run, fresh_counters, patched  # noqa: F401


def _run(P, monkeypatch, requests, controller, *, max_chips=200, events=False,
         per_package=None, **kw):
    """One run of package ``P`` from fresh request and instance counters (a
    slow-node detector hashes instance ids, so both must count alike);
    ``per_package(P)`` gives the arguments built from ``P``'s own classes."""
    fresh_counters(P, monkeypatch)
    reqs = requests(P)
    cluster = P.cluster.SimCluster(P.simulator.default_perf_factory(), max_chips=max_chips)
    sim = P.simulator.simulate_events if events else P.simulator.simulate
    res = sim(reqs, controller(P), cluster, **kw, **(per_package(P) if per_package else {}))
    return res, reqs if isinstance(reqs, list) else res.requests


def _assert_same_run(ref, port):
    (ra, qa), (rb, qb) = ref, port
    assert_same_run(ra, rb)
    assert len(qa) == len(qb) > 0
    for a, b in zip(qa, qb):
        assert (a.state.value, a.first_token_time, a.finish_time, a.tokens_generated) == \
            (b.state.value, b.first_token_time, b.finish_time, b.tokens_generated)


def _both(monkeypatch, requests, controller, **kw):
    ref = _run(REF, monkeypatch, requests, controller, **kw)
    port = _run(PORT, monkeypatch, requests, controller, **kw)
    _assert_same_run(ref, port)
    return ref, port


def _spec(**kw):
    return lambda P: P.workload.generate(P.workload.WorkloadSpec(**kw))


def _chiron(**kw):
    return lambda P: P.controllers.ChironController(**kw)


def _llumnix(P):
    return P.controllers.LlumnixController()


# the scenarios of the reference's tests/test_simulator.py
_FIG19_MIX = dict(n_requests=150, arrival_rate=8.0, interactive_frac=1.0,
                  batch_queue_size=400, batch_ttft_slo=900.0, seed=7)
_SCENARIOS = {
    "steady": (_spec(n_requests=200, arrival_rate=15.0, seed=3), _chiron(), 900),
    "fig19-chiron": (_spec(**_FIG19_MIX), _chiron(), 1500),
    "fig19-llumnix": (_spec(**_FIG19_MIX), _llumnix, 1500),
    "mixed-0.7": (_spec(n_requests=150, arrival_rate=10.0, interactive_frac=0.7,
                        batch_ttft_slo=600.0, seed=5), _chiron(), 1200),
}
_ENGINES = {"event": dict(), "fixed": dict(engine="fixed"),
            "reference": dict(events=True, reference=True),
            "quantize": dict(events=True, quantize=0.25)}


@pytest.mark.parametrize("engine", list(_ENGINES))
@pytest.mark.parametrize("scenario", list(_SCENARIOS))
def test_scenarios_match_the_reference(scenario, engine, patched):
    requests, controller, max_time = _SCENARIOS[scenario]
    (res, reqs), _ = _both(patched, requests, controller, max_time=max_time,
                           warm_start=2, **_ENGINES[engine])
    assert res.completion_rate() > 0.9 and res.scale_ups > 0


@pytest.mark.parametrize("arm", [dict(local_enabled=False), dict(global_enabled=False),
                                 dict(group_k=-1), dict(auto_theta=True, theta_refresh=20.0)])
def test_ablation_arms_match_the_reference(arm, patched):
    _both(patched, _spec(**_FIG19_MIX), _chiron(**arm), max_time=1500, warm_start=2)


def _steady_trace(n=300, rate=12.0, seed=0, interactive_frac=0.9):
    """A trace of each package from the same seeded columns."""
    def make(P):
        rng = np.random.default_rng(seed)
        times = np.cumsum(rng.exponential(1.0 / rate, n))
        ins = np.clip(rng.lognormal(5.5, 0.8, n), 4, 4096).astype(np.int64)
        outs = np.clip(rng.lognormal(4.5, 0.8, n), 4, 2048).astype(np.int64)
        cls = rng.random(n) < interactive_frac
        return P.workload.make_trace(times, ins, outs, cls, batch_ttft_slo=900.0)
    return make


_CHAOS = {
    "failures": lambda P: dict(failures=P.simulator.FailurePlan(
        [20.0, 35.0, 50.0], seed=4, victims=2)),
    "degradations": lambda P: dict(degradations=P.simulator.DegradationPlan(
        [8.0, 15.0], factor=4.0, duration=40.0, seed=2),
        detector=P.cluster.DetectorConfig(noise=0.2, fp_rate=0.05, seed=1)),
    "outage": lambda P: dict(outages=P.simulator.OutagePlan(
        start=12.0, duration=20.0, fraction=0.5, recovery_stages=2,
        stage_interval=10.0, seed=3)),
}


@pytest.mark.parametrize("plan", list(_CHAOS))
def test_chaos_plans_match_the_reference(plan, patched):
    (res, _), _ = _both(patched, _steady_trace(seed=1), _chiron(), events=True,
                        max_time=900.0, warm_start=2, per_package=_CHAOS[plan])
    assert res.failures + res.degradations > 0 and res.completion_rate() == 1.0


def _flash_crowd(P):
    """A steady llama-8b stream with a seeded crowd of llama-70b arrivals
    merged in, as the reference's ``flash_crowd`` scenario builds it."""
    base = _steady_trace(n=200, rate=10.0, seed=6)(P)
    plan = P.simulator.FlashCrowdPlan(start=6.0, ramp=4.0, duration=12.0,
                                      model="llama-70b", peak_rate=4.0, seed=6)
    t = plan.arrival_times()
    rng = np.random.default_rng(16)
    crowd = P.workload.make_trace(t, rng.integers(16, 600, t.size),
                                  rng.integers(8, 200, t.size),
                                  np.ones(t.size, dtype=bool), models=("llama-70b",),
                                  sort=False)
    return P.workload.Trace.concat([base, crowd]).sorted_by_arrival(), plan


def test_flash_crowd_matches_the_reference(patched):
    (res, reqs), _ = _both(
        patched, lambda P: _flash_crowd(P)[0], _chiron(models=["llama-8b"]), events=True,
        max_time=600.0, warm_start=2,
        per_package=lambda P: dict(flash_crowds=_flash_crowd(P)[1]))
    assert {r.model for r in reqs} == {"llama-8b", "llama-70b"} and res.shocks


def _storm(P):
    """Sustained saturation past what 4 chips serve in a tight TTFT SLO, as
    the reference's overload tests build it."""
    rng = np.random.default_rng(3)
    n = 600
    t = np.sort(rng.uniform(0.0, n / 80.0, n))
    ins = np.clip(rng.lognormal(np.log(1500.0), 0.25, n), 64, 8192).astype(np.int64)
    outs = np.clip(rng.lognormal(np.log(400.0), 0.25, n), 16, 2048).astype(np.int64)
    return P.workload.make_trace(t, ins, outs, np.ones(n, dtype=bool), ttft_slo=3.0)


def test_overload_plane_matches_the_reference(patched):
    (res, _), _ = _both(
        patched, _storm, _chiron(), events=True, max_chips=4, max_time=600.0,
        per_package=lambda P: dict(overload=P.overload.OverloadConfig.full(
            slack=0.3, max_retries=3, base_backoff=2.0, budget=30.0)))
    s = res.summary()
    assert s["reject_rate"] > 0.0 and int(res.ledger.retries.sum()) > 0


def test_shadow_verify_and_telemetry_match_the_reference(patched):
    """Both observers on: the runs stay equal, the verifier checks, and the
    flight recorders hold the same columns."""
    shadows = {}

    def observers(P):
        shadows[P is PORT] = P.shadow.ShadowVerifier(ledger_interval=0.0)
        return dict(shadow_verify=shadows[P is PORT],
                    telemetry=P.recorder.FlightRecorder(span_sample=1.0))

    (ra, _), (rb, _) = _both(patched, _spec(**_FIG19_MIX), _chiron(), events=True,
                             max_time=1500, warm_start=2, per_package=observers)
    ours, ref = shadows[True], shadows[False]
    assert ours.ledger_checks == ref.ledger_checks > 0
    assert ours.plane_checks == ref.plane_checks
    assert ours.queue_checks == ref.queue_checks > 0
    for part in ("signals", "cticks", "decisions", "spans"):
        a, b = getattr(ra.telemetry, part), getattr(rb.telemetry, part)
        assert a.n == b.n > 0, part
        for name in a.column_names():
            np.testing.assert_array_equal(a.col(name), b.col(name), err_msg=f"{part}.{name}")
    assert ra.telemetry.replay() == rb.telemetry.replay()


def test_the_shadow_verifier_catches_a_desync(patched):
    """A ledger row knocked back to QUEUED after an admit is caught by the
    port's verifier, as the reference's is (its tests/test_shadow_verify.py)."""
    admit = PORT.cluster.SimInstance.admit

    def corrupt(self, req, *args, **kwargs):
        out = admit(self, req, *args, **kwargs)
        led = getattr(self._cluster, "ledger", None) if self._cluster else None
        if led is not None and req.row >= 0:
            led.state[req.row] = 0
        return out

    patched.setattr(PORT.cluster.SimInstance, "admit", corrupt)
    with pytest.raises(PORT.shadow.ShadowVerifyError, match="ledger `state`"):
        _run(PORT, patched, _spec(**_FIG19_MIX), _chiron(), events=True, max_time=1500,
             warm_start=2, per_package=lambda P: dict(
                 shadow_verify=P.shadow.ShadowVerifier(ledger_interval=0.0)))


def test_a_two_model_fleet_matches_the_reference(patched):
    def requests(P):
        a = P.workload.generate(P.workload.WorkloadSpec(
            n_requests=120, arrival_rate=8.0, interactive_frac=0.8, model="llama-8b",
            seed=11))
        b = P.workload.generate(P.workload.WorkloadSpec(
            n_requests=80, arrival_rate=5.0, interactive_frac=1.0, batch_queue_size=150,
            batch_ttft_slo=600.0, model="granite-8b", seed=12))
        return sorted(a + b, key=lambda r: r.arrival_time)

    (res, _), _ = _both(patched, requests, _chiron(models=["llama-8b", "granite-8b"]),
                        max_time=1500, warm_start=2)
    assert {k for k in res.summary() if k.startswith("slo_model:")} == \
        {"slo_model:llama-8b", "slo_model:granite-8b"}


def test_the_port_constants_change_the_run(monkeypatch):
    """Unpatched, the port plans on the H100's constants: the run completes
    and differs from the reference's (fewer chip-hours: one card holds a
    llama-8b instance that the reference plans on four chips)."""
    ref = _run(REF, monkeypatch, _spec(**_FIG19_MIX), _chiron(), max_time=1500,
               warm_start=2)
    port = _run(PORT, monkeypatch, _spec(**_FIG19_MIX), _chiron(), max_time=1500,
                warm_start=2)
    assert port[0].completion_rate() == 1.0
    assert port[0].summary() != ref[0].summary()
    assert port[0].chip_seconds < ref[0].chip_seconds


def test_one_patch_of_the_constants_reaches_every_reader(monkeypatch):
    """The step overhead and the load rate are folded into each
    ``PerfModel`` when it is built; a simulated instance and the vector
    plane read them from there, never from the module."""
    monkeypatch.setattr(PORT.perf, "STEP_OVERHEAD", 5e-3)
    monkeypatch.setattr(PORT.perf, "_LOAD_BW", 1e9)
    pm = PORT.perf.PerfModel("llama-8b")
    assert pm.step_overhead == 5e-3 and pm.model_load_time() == 16.05999001600
    monkeypatch.setattr(PORT.perf, "STEP_OVERHEAD", 1.0)    # after the build
    inst = PORT.cluster.SimInstance(pm, PORT.cluster.InstanceType.MIXED, 0.0)
    assert inst._c_oh == 5e-3 and inst.ready_time == pm.model_load_time()
    assert inst._itl_now(1, 1.0) == pm.itl(1, 1.0)
    plane = PORT.cluster.InstancePlane(cap=1)
    s = plane.alloc(inst)
    plane.alloc(PORT.cluster.SimInstance(pm, PORT.cluster.InstanceType.BATCH, 0.0))
    assert plane.oh[s] == 5e-3 and plane.cap == 2


@pytest.mark.parametrize("knobs", [dict(), dict(prefix_caching=True),
                                   dict(speculative_decoding=True),
                                   dict(flops_scale=2.0, hbm_bw_scale=1.5,
                                        hbm_bytes_scale=1.2, chips=2)])
@pytest.mark.parametrize("name", ["llama-8b", "mamba2-1.3b", "qwen2-moe-a2.7b"])
def test_perf_model_knobs_match_the_reference(name, knobs, patched):
    ours, ref = PORT.perf.PerfModel(name, **knobs), REF.perf.PerfModel(name, **knobs)
    assert ours.kv_bytes_per_token() == ref.kv_bytes_per_token()
    assert ours.kv_capacity_tokens() == ref.kv_capacity_tokens()
    assert ours.model_load_time() == ref.model_load_time()
    for prompt in (16, 337, 2048):
        assert ours.prefill_time(prompt) == ref.prefill_time(prompt)
    for ctx in (128.0, 1024.0):
        if math.isfinite(ref.kv_capacity_tokens()):     # an SSM's is infinite
            assert ours.max_stable_batch(ctx) == ref.max_stable_batch(ctx)
        for b in (1, 8, 64, 512):
            assert ours.itl(b, ctx) == ref.itl(b, ctx)
            assert ours.preemption_factor(b, ctx) == ref.preemption_factor(b, ctx)
        assert ours.optimal_batch(0.2, ctx) == ref.optimal_batch(0.2, ctx)


def test_the_port_plans_load_times_on_the_card():
    """No reference constant is the port's own, and the measured load rate
    puts every configuration at the paper's 15 s floor."""
    for key in ("PEAK_FLOPS", "HBM_BW", "HBM_BYTES", "MBU", "STEP_OVERHEAD", "_LOAD_BW"):
        assert getattr(PORT.perf, key) != getattr(REF.perf, key), key
    assert PORT.perf.LINK_BW != REF.perf.ICI_BW
    for name in PORT.perf.INSTANCE_CHIPS:
        assert PORT.perf.PerfModel(name).model_load_time() == 15.0
    assert PORT.cluster.SimCluster(PORT.simulator.default_perf_factory()).max_chips == 50
