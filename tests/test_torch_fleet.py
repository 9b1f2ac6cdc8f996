"""The port's fleet tier (``repro_torch.sim.fleet``) and its event loop
(``simulate_fleet``) held against the reference's seed for seed on the CPU.

Each case builds the same fleet scenario in both packages at a small size,
from fresh request and instance counters and under the reference's
planning constants, and runs ``simulate_fleet`` in each: the summary, the
per-cluster rollups, every request's outcome, the timeline and, with the
flight recorder on, its every column and its cluster names must be equal,
exactly. The router's and the placer's decisions on a hand-built fleet
must be the reference's one for one."""
import dataclasses

import pytest

from test_torch_sim_parity import PORT, REF, assert_same_run, fresh_counters, patched  # noqa: F401

FLEET_SCENARIOS = ("multi_region", "regional_spillover", "heterogeneous_accelerators",
                   "zone_outage")
N = 300


def _observers(P, which):
    if which == "shadow_verify":
        return dict(shadow_verify=P.shadow.ShadowVerifier(ledger_interval=0.0))
    return dict(telemetry=P.recorder.FlightRecorder(span_sample=1.0))


def _fleet_run(P, monkeypatch, name, n=N, seed=3, fleet=None, **extra):
    fresh_counters(P, monkeypatch)
    trace, kw = P.scenarios.build_trace(name, n_requests=n, seed=seed)
    fl = fleet(P) if fleet else kw["fleet"]()
    res = P.simulator.simulate_fleet(trace, fl, max_time=kw["max_time"], warm_start=1,
                                     outages=kw.get("outages"), **extra)
    return res, fl


@pytest.mark.parametrize("observer", ["shadow_verify", "telemetry"])
@pytest.mark.parametrize("name", FLEET_SCENARIOS)
def test_fleet_scenarios_match_the_reference(name, observer, patched):  # noqa: F811
    obs = {P.root: _observers(P, observer) for P in (REF, PORT)}
    (ra, fa), (rb, fb) = (_fleet_run(P, patched, name, **obs[P.root]) for P in (REF, PORT))
    assert_same_run(ra, rb)
    assert rb.completion_rate() == 1.0 and len(rb.clusters) == len(fb.clusters) >= 2
    assert [(fc.name, dict(fc.resident)) for fc in fa.clusters] == \
        [(fc.name, dict(fc.resident)) for fc in fb.clusters]
    if observer == "shadow_verify":
        ours, ref = obs["repro_torch"]["shadow_verify"], obs["repro"]["shadow_verify"]
        assert ours.ledger_checks == ref.ledger_checks > 0
        assert ours.plane_checks == ref.plane_checks
        assert ours.queue_checks == ref.queue_checks > 0
    else:
        assert rb.telemetry.cluster_names == [fc.name for fc in fb.clusters]
    if name == "zone_outage":
        assert rb.shocks and rb.shocks[0].label == "us-east"


def _breaker_fleet(P):
    """``regional_spillover``'s two clusters behind a Router with circuit
    breakers, so the overload plane's admission outcomes feed them."""
    specs = [P.fleet.ClusterSpec("us-edge", "us", max_chips=4),
             P.fleet.ClusterSpec("eu-hub", "eu", max_chips=4)]
    topo = P.fleet.FleetTopology(("us", "eu"), latency={("us", "eu"): 0.07})
    router = P.fleet.Router(breaker=P.overload.BreakerConfig(min_samples=4, cooldown=10.0))
    return P.fleet.Fleet(specs, topo, models=("llama-8b",), router=router)


# the options of simulate_events on the fleet loop: chaos plans with the
# detector, the object-queue baseline, the overload plane with breakers
_OPTIONS = {
    "chaos": lambda P: dict(
        failures=P.simulator.FailurePlan([40.0, 70.0], seed=4, victims=2),
        degradations=P.simulator.DegradationPlan([30.0, 50.0], factor=4.0,
                                                 duration=40.0, seed=2),
        detector=P.cluster.DetectorConfig(noise=0.2, fp_rate=0.05, seed=1),
        flash_crowds=P.simulator.FlashCrowdPlan(start=20.0, ramp=5.0, duration=20.0,
                                                model="llama-8b", peak_rate=4.0, seed=6)),
    "reference-queue": lambda P: dict(reference=True),
    "overload-breakers": lambda P: dict(
        fleet=_breaker_fleet, telemetry=True, n=600,
        overload=P.overload.OverloadConfig.full(slack=0.05, max_retries=2,
                                                base_backoff=2.0, budget=30.0)),
}


@pytest.mark.parametrize("option", list(_OPTIONS))
def test_fleet_options_match_the_reference(option, patched):  # noqa: F811
    name = "regional_spillover" if option == "overload-breakers" else "multi_region"
    (ra, _), (rb, _) = (_fleet_run(P, patched, name, **_OPTIONS[option](P))
                        for P in (REF, PORT))
    assert_same_run(ra, rb)
    if option == "chaos":
        assert rb.failures + rb.degradations > 0
    if option == "overload-breakers":
        actions = rb.telemetry.replay()
        assert actions["rejections"] > 0 and actions["breaker_trips"] > 0


def _decisions(P):
    """A hand-built two-region fleet driven through the router and the
    placer; every decision and counter they leave, by name."""
    F, R = P.fleet, P.request
    topo = F.FleetTopology([F.Region("us"), F.Region("eu")])
    fleet = F.Fleet([F.ClusterSpec("us-a", "us", max_chips=4),
                     F.ClusterSpec("eu-a", "eu", max_chips=40),
                     F.ClusterSpec("us-econ", "us", accelerator="v4e", max_chips=8)],
                    topo, models=("llama-8b",), placement={"llama-8b": ["us-a", "eu-a"]})
    log = []
    us = fleet.by_name["us-a"]
    inst = us.cluster.provision("llama-8b", P.cluster.InstanceType.MIXED, 0.0, static_batch=4)
    inst.ready_time = 0.0
    inst.activate_if_ready(0.0)
    for _ in range(4):
        inst.admit(R.make_interactive(64, 32, 0.0), 0.0)
    def route(now):
        for k, (origin, interactive) in enumerate([("us", True), ("eu", True), ("us", False),
                                                   (None, True), ("eu", False)]):
            req = (R.make_interactive if interactive else R.make_batch)(100 + k, 50, now + k)
            req.origin = origin
            fc, delay = fleet.route(req, now + k)
            log.append(("route", now + k, fc.name, delay))

    route(0.0)
    warms = []
    now = 0.0
    for review in range(fleet.placer.drain_strikes + 2):
        for k in range(60):
            req = (R.make_interactive if k % 3 else R.make_batch)(100, 50, now)
            req.origin = "us" if k % 2 else "eu"
            fleet.observe_arrival(req, now)
        now += fleet.placer.interval
        moved = fleet.review(now, lambda d, p: warms.append((d, p[0], p[1].name)))
        log.append(("review", review, [(r.prompt_len, fc.name, d) for r, fc, d in moved],
                    dict(fleet.placer.batch_target)))
    for delay, model, name in warms:
        fleet.on_warm((model, fleet.by_name[name]), now + delay)
    log.append(("warms", warms))
    route(now + 1000.0)
    log.append(("resident", [(fc.name, dict(fc.resident)) for fc in fleet.clusters]))
    log.append(("costs", [(fc.name, fc.batch_cost_per_mtoken("llama-8b"),
                           fc.interactive_itl("llama-8b"),
                           fc.interactive_headroom("llama-8b"),
                           fc.batch_headroom("llama-8b")) for fc in fleet.clusters]))
    log.append(("fleet", fleet.migrations, fleet.handbacks, fleet.egress_bytes,
                fleet.egress_cost_usd, fleet.residency_epoch))
    log.append(("stats", [dataclasses.astuple(st) for st in fleet.finalize()]))
    return log


def test_router_and_placer_decide_as_the_reference(patched):  # noqa: F811
    fresh_counters(REF, patched)
    ref = _decisions(REF)
    fresh_counters(PORT, patched)
    port = _decisions(PORT)
    assert port == ref
    routes = [entry for entry in port if entry[0] == "route"]
    assert {name for _, _, name, _ in routes} >= {"eu-a", "us-econ"}    # spilled, cheapest
    assert any(entry[0] == "warms" and entry[1] for entry in port)


def test_the_accelerator_rows_are_the_references():
    assert PORT.fleet.ACCELERATORS == REF.fleet.ACCELERATORS
    assert PORT.fleet.ACCELERATORS["v5e"]["perf_kw"] == {}     # the baseline: the card's own
    assert PORT.fleet.TOKEN_BYTES == REF.fleet.TOKEN_BYTES
    assert dataclasses.asdict(PORT.fleet.ClusterSpec("a", "us")) == \
        dataclasses.asdict(REF.fleet.ClusterSpec("a", "us"))
    assert dataclasses.asdict(PORT.fleet.GlobalPlacer()) == \
        dataclasses.asdict(REF.fleet.GlobalPlacer())


def test_the_fleet_runs_on_the_cards_constants(monkeypatch):
    """Unpatched, the baseline row is the H100's constants: the fleet
    completes and its chip-hours differ from the reference's."""
    (ra, _), (rb, _) = (_fleet_run(P, monkeypatch, "zone_outage") for P in (REF, PORT))
    assert rb.completion_rate() == 1.0
    assert rb.chip_seconds < ra.chip_seconds
