"""The port's real-plane cluster on the CPU: the behaviours of
``tests/test_real_cluster.py`` on the llama-8b smoke config, and, against
the reference's cluster on the same weights and clock, the routing path
that evicts batch work, the controller's bookkeeping, and the one
place the port departs from it (a request its engine preempts is not
lost). ``tests/test_torch_cluster_parity.py`` holds whole runs."""
import jax
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as ref_smoke_config
from repro.serving import request as ref_request
from repro.serving import real_cluster as ref_real_cluster
from repro.sim import controllers as ref_controllers
from repro_torch import params as port_params
from repro_torch.configs import get_smoke_config
from repro_torch.serving import request as port_request
from repro_torch.serving.cluster_trace import ClusterRecorder, SharedClock
from repro_torch.serving.real_cluster import RealCluster, RealInstance, serve_forever
from repro_torch.serving.request import RequestState, make_batch, make_interactive
from repro_torch.sim import controllers, perf_model
from repro_torch.sim.cluster import InstanceState, InstanceType

# the test workers share the host's cores: cap each one's intra-op threads
torch.set_num_threads(2)


@pytest.fixture(scope="module")
def cfg():
    return get_smoke_config("llama-8b")


def test_chiron_controller_drives_real_engines(cfg):
    cluster = RealCluster(cfg, max_chips=4, max_slots=3, max_len=64, device="cpu")
    ctrl = controllers.ChironController(model="llama-8b", init_batch=2, max_batch=3)
    reqs = ([make_interactive(8, 6, arrival=0.0) for _ in range(4)] +
            [make_batch(8, 10, arrival=0.0, ttft_slo=30.0)
             for _ in range(4)])
    # deterministic fake clock: one "second" per call
    t = iter(range(100000))
    out = serve_forever(reqs, ctrl, cluster,
                        clock=lambda: float(next(t)) * 0.05,
                        max_steps=800)
    assert out["finished"] == out["total"] == 8, out
    assert cluster.scale_ups >= 1
    for r in reqs:
        assert r.state == RequestState.FINISHED
        assert r.tokens_generated >= r.output_len


def test_migration_preserves_generation(cfg):
    a = RealInstance(cfg, InstanceType.MIXED, 0.0, max_slots=2, max_len=64,
                     device="cpu")
    b = RealInstance(cfg, InstanceType.MIXED, 0.0, max_slots=2, max_len=64,
                     device="cpu")
    a.activate_if_ready(0.0)
    b.activate_if_ready(0.0)
    req = make_batch(8, 16)
    a.admit(req, 0.0)
    for _ in range(5):
        a.step(0.0)
    toks_before = req.tokens_generated
    assert toks_before > 0

    cluster = RealCluster.__new__(RealCluster)  # migrate() only needs ducks
    assert RealCluster.migrate(cluster, req.req_id, a, b)
    assert a.n_running == 0
    while req.state != RequestState.FINISHED:
        st = b.step(0.0)
        if not st.n_active and not b.engine.waiting:
            break
    assert req.state == RequestState.FINISHED
    assert req.tokens_generated >= req.output_len
    assert req.tokens_generated >= toks_before  # no progress lost


def test_rebalance_moves_batch_off_crowded(cfg):
    cluster = RealCluster(cfg, max_chips=2, max_slots=2, max_len=64, device="cpu")
    a = cluster.provision("x", InstanceType.MIXED, 0.0, static_batch=2)
    b = cluster.provision("x", InstanceType.MIXED, 0.0, static_batch=2)
    a.activate_if_ready(0.0)
    b.activate_if_ready(0.0)
    for r in (make_batch(8, 30), make_batch(8, 30)):
        a.admit(r, 0.0)
    a.step(0.0)
    assert a.n_running == 2 and b.n_running == 0
    moved = cluster.rebalance(0.0)
    b.step(0.0)
    assert moved == 1
    assert a.n_running == 1 and b.n_running == 1


def test_instances_share_one_set_of_weights_and_retire_cleanly(cfg):
    cluster = RealCluster(cfg, max_chips=2, max_slots=2, max_len=64, device="cpu")
    a = cluster.provision("llama-8b", InstanceType.MIXED, 0.0)
    b = cluster.provision("llama-8b", InstanceType.BATCH, 0.0)
    assert cluster.provision("llama-8b", InstanceType.BATCH, 0.0) is None
    assert a.engine.params is b.engine.params is cluster._shared_params
    a.activate_if_ready(0.0)
    r = make_batch(8, 20)
    a.admit(r, 0.0)
    a.step(0.0)
    waiting = make_interactive(8, 4, model="llama-8b")
    a.admit(waiting, 0.0)
    displaced = cluster.retire(a)
    assert displaced == [r, waiting] and r.saved_kv is not None
    assert a.state == InstanceState.RETIRED and cluster.instances == [b]
    assert (cluster.scale_ups, cluster.scale_downs, cluster.peak_chips) == (2, 1, 2)
    assert isinstance(cluster.perf_factory("granite-8b"), perf_model.PerfModel)
    assert cluster.perf_factory("granite-8b").model_name == "llama-8b"


def test_recorder_names_requests_by_index_and_changes_nothing(cfg):
    def run(record):
        cluster = RealCluster(cfg, max_chips=3, max_slots=2, max_len=64, device="cpu")
        reqs = [make_interactive(6 + i, 4 + i, arrival=0.1 * i) for i in range(5)] + \
            [make_batch(9, 7, arrival=0.0, ttft_slo=1.0) for _ in range(3)]
        clock = SharedClock(0.05)
        rec = ClusterRecorder(cluster, reqs, clock) if record else None
        if not record:      # the same engine clocks, without the recorder
            provision = cluster.provision

            def provision_on_clock(*a, **kw):
                inst = provision(*a, **kw)
                if inst is not None:
                    inst.engine.clock = clock.read
                return inst
            cluster.provision = provision_on_clock
        out = serve_forever(reqs, controllers.ChironController(init_batch=2, max_batch=2),
                            cluster, clock=clock.advance)
        return rec, out, [(r.tokens_generated, r.first_token_time, r.finish_time)
                          for r in reqs]

    rec, out_a, a = run(True)
    _, out_b, b = run(False)
    assert a == b and out_a == out_b
    assert rec.tokens_of(0) and all(isinstance(t, int) for t in rec.tokens_of(0))
    assert {e[0] for e in rec.log} >= {"provision", "admit", "step"}


def _one_instance_run(rmod, cmod, cluster, serve):
    """One mixed instance of two slots (Llumnix, static batch 2): a batch
    request runs, then two interactive requests arrive at once. One routing
    pass hands both to the instance, which has one free slot: the engine
    admits the first and preempts the batch request for the second."""
    batch = rmod.make_batch(10, 12, arrival=0.0, ttft_slo=60.0)
    inter = [rmod.make_interactive(6 + i, 5, arrival=0.12) for i in range(2)]
    reqs = [batch] + inter
    rng = np.random.default_rng(2)
    for r in reqs:
        r.prompt_tokens = rng.integers(0, 512, size=(r.prompt_len,), dtype=np.int32)
    clock = SharedClock(0.05)
    rec = ClusterRecorder(cluster, reqs, clock)
    out = serve(reqs, cmod.LlumnixController(model="llama-8b", static_batch=2),
                cluster, clock=clock.advance, max_steps=200)
    return rec, out, reqs


def test_a_request_the_engine_preempts_is_not_lost():
    """The reference drops a batch request its own engine preempts (it stays
    PREEMPTED and the loop ends without it); the port requeues it, and up
    to that preemption the two make the same decisions and tokens."""
    rcfg, cfg = ref_smoke_config("llama-8b"), get_smoke_config("llama-8b")
    kw = dict(max_chips=1, max_slots=2, max_len=64)
    ref_cluster = ref_real_cluster.RealCluster(rcfg, **kw)
    params = port_params.from_reference(
        jax.tree.map(np.asarray, ref_cluster._shared_params), cfg, device="cpu")
    ref = _one_instance_run(ref_request, ref_controllers, ref_cluster,
                            ref_real_cluster.serve_forever)
    port = _one_instance_run(port_request, controllers,
                             RealCluster(cfg, device="cpu", params=params, **kw),
                             serve_forever)
    (rrec, rout, rreqs), (prec, pout, preqs) = ref, port
    cut = next(i for i, e in enumerate(prec.log) if e[0] == "step" and e[4])
    assert prec.log[cut][4] == [0]                  # the batch request
    assert prec.log[:cut + 1] == rrec.log[:cut + 1]
    assert rreqs[0].state.value == "preempted"         # the reference's enum
    assert rout["finished"] == 2 and rout["total"] == 3
    assert pout["finished"] == pout["total"] == 3
    assert preqs[0].preemptions == 1 and preqs[0].tokens_generated >= 12
    assert ("admit", 0, 0) in prec.log[cut + 1:]    # back through the queue


def test_an_interactive_arrival_evicts_batch_work_the_same_way():
    """Every slot of the only mixed instance runs batch work when an
    interactive request arrives: routing evicts one batch request (KV to the
    host, back to the queue) and admits the interactive one, in both
    packages alike."""
    rcfg, cfg = ref_smoke_config("llama-8b"), get_smoke_config("llama-8b")
    kw = dict(max_chips=1, max_slots=2, max_len=64)
    ref_cluster = ref_real_cluster.RealCluster(rcfg, **kw)
    params = port_params.from_reference(
        jax.tree.map(np.asarray, ref_cluster._shared_params), cfg, device="cpu")
    logs, outs = [], []
    for rmod, cmod, cluster, serve in (
            (ref_request, ref_controllers, ref_cluster, ref_real_cluster.serve_forever),
            (port_request, controllers, RealCluster(cfg, device="cpu", params=params, **kw),
             serve_forever)):
        reqs = [rmod.make_batch(9 + i, 14, arrival=0.0, ttft_slo=60.0) for i in range(2)]
        reqs.append(rmod.make_interactive(7, 5, arrival=0.17))
        rng = np.random.default_rng(3)
        for r in reqs:
            r.prompt_tokens = rng.integers(0, 512, size=(r.prompt_len,), dtype=np.int32)
        clock = SharedClock(0.05)
        rec = ClusterRecorder(cluster, reqs, clock)
        outs.append(serve(reqs, cmod.LlumnixController(model="llama-8b", static_batch=2),
                          cluster, clock=clock.advance, max_steps=200))
        logs.append(rec.log)
    assert logs[1] == logs[0]
    assert ("evict", 0, 1) in logs[1]
    assert outs[1]["finished"] == outs[0]["finished"] == 3


def test_cluster_entry_points_raise_without_a_gpu(cfg):
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU: the entry points run on it")
    with pytest.raises(RuntimeError, match="CUDA"):
        RealCluster(cfg, max_chips=1, max_slots=2, max_len=32)   # device defaults to cuda
    with pytest.raises(RuntimeError, match="CUDA"):
        RealInstance(cfg, InstanceType.MIXED, 0.0, max_slots=2, max_len=32)


def test_controller_bookkeeping_matches_the_reference():
    """What ``serve_forever`` does not drive but the controller keeps: Theta
    re-estimated from observed arrivals, per-model QLM output fits from
    completions, and discovered models."""
    rng = np.random.default_rng(8)
    arrivals = np.sort(np.concatenate([rng.uniform(0, 300, 200), rng.uniform(60, 75, 150)]))
    states = []
    for rmod, cmod in ((ref_request, ref_controllers), (port_request, controllers)):
        ctrl = cmod.ChironController(model="llama-8b", auto_theta=True,
                                     theta_refresh=100.0,
                                     theta_refresh_per_model={"granite-8b": 50.0})
        for i, t in enumerate(arrivals):
            model = "granite-8b" if i % 3 == 0 else "llama-8b"
            req = rmod.make_interactive(8, 10 + i % 50, arrival=float(t), model=model)
            ctrl.observe_arrival(req, float(t))
            if i % 2:
                ctrl.observe_completion(req)
            ctrl._refresh_theta(float(t))
        states.append((ctrl.model_list,
                       {m: (s.theta, s.min_instances)
                        for m, s in ctrl.interactive_scalers.items()},
                       {m: (e.output_model.mu, e.output_model.sigma, e.output_model.n_observed)
                        for m, e in ctrl.estimators.items()},
                       dict(ctrl._next_theta_update)))
    assert states[1] == states[0]
    assert states[1][1]["llama-8b"][0] != 1 / 3      # Theta moved
