"""The port's whole hierarchy against the reference's on the CPU: the same
trace, fake clock and weights give the same decisions and the same greedy
tokens, step by step, through ``serve_forever`` driven by
``ChironController`` (one model, and a two-model fleet) and by
``LlumnixController``.

The reference's runs here are PATCHED: ``_requeue_engine_preemptions``
gives them the port's one deliberate departure (a batch request that its
own engine preempts goes back to the global queue, where the unpatched
reference drops it and never finishes it). "The reference" in these tests
is that patched reference; ``tests/test_torch_cluster.py::
test_a_request_the_engine_preempts_is_not_lost`` holds the port against the
unpatched one, up to the first such preemption."""
import jax
import numpy as np
import torch

from repro.configs import get_smoke_config as ref_smoke_config
from repro.serving import global_queue as ref_global_queue
from repro.serving import real_cluster as ref_real_cluster
from repro.sim import controllers as ref_controllers
from repro.sim import perf_model as ref_perf
from repro.sim import workload as ref_workload
from repro_torch import params as port_params
from repro_torch.configs import get_smoke_config
from repro_torch.serving.cluster_trace import ClusterRecorder, SharedClock
from repro_torch.serving.real_cluster import RealCluster, serve_forever
from repro_torch.sim import controllers, perf_model, workload

# the test workers share the host's cores: cap each one's intra-op threads
torch.set_num_threads(2)

_REF_CONSTANTS = {"PEAK_FLOPS": ref_perf.PEAK_FLOPS, "HBM_BW": ref_perf.HBM_BW,
                  "HBM_BYTES": ref_perf.HBM_BYTES, "LINK_BW": ref_perf.ICI_BW,
                  "MBU": ref_perf.MBU, "STEP_OVERHEAD": ref_perf.STEP_OVERHEAD,
                  "MFU_DECODE": ref_perf.MFU_DECODE,
                  "INSTANCE_CHIPS": dict(ref_perf.INSTANCE_CHIPS)}


def _trace(wmod, vocab):
    """Interactive arrivals over two seconds and a batch backlog at t=0,
    prompts and outputs cut to the smoke engines' 64-token slots, explicit
    prompt tokens from a seed."""
    spec = wmod.WorkloadSpec(n_requests=24, arrival_rate=12.0, interactive_frac=0.7,
                             batch_queue_size=10, batch_ttft_slo=5.0, seed=7)
    reqs = wmod.generate(spec)
    rng = np.random.default_rng(11)
    for r in reqs:
        r.prompt_len = int(min(r.prompt_len, 20))
        r.output_len = int(min(r.output_len, 3 + r.prompt_len % 13))
        r.prompt_tokens = rng.integers(0, vocab, size=(r.prompt_len,), dtype=np.int32)
    return reqs


def _requeue_engine_preemptions(monkeypatch, recorder):
    """Give the reference's ``serve_forever`` the port's one departure: a
    batch request its engine preempts goes back to the global queue (the
    reference drops it). Its queue is caught as ``serve_forever`` makes it."""
    queues = []

    class Queue(ref_global_queue.GlobalQueue):
        def __init__(self):
            super().__init__()
            queues.append(self)

    monkeypatch.setattr(ref_global_queue, "GlobalQueue", Queue)
    provision = recorder.provision

    def provision_requeueing(*a, **kw):
        inst = provision(*a, **kw)
        if inst is not None:
            step = inst.step

            def step_requeueing(now):
                stats = step(now)
                for victim in stats.preempted:
                    queues[-1].requeue(victim)
                return stats
            inst.step = step_requeueing
        return inst
    recorder.cluster.provision = provision_requeueing


def _two_model_trace(wmod, vocab):
    """Two models' traffic (the instances of both run the smoke weights; the
    model is the routing key): each model's interactive arrivals and a batch
    backlog of the second model only."""
    a = wmod.generate(wmod.WorkloadSpec(n_requests=8, arrival_rate=8.0,
                                        interactive_frac=1.0, seed=1,
                                        model="llama-8b"))
    b = wmod.generate(wmod.WorkloadSpec(n_requests=6, arrival_rate=6.0,
                                        interactive_frac=0.5, batch_queue_size=4,
                                        batch_ttft_slo=2.0, seed=2,
                                        model="granite-8b"))
    reqs = sorted(a + b, key=lambda r: r.arrival_time)
    rng = np.random.default_rng(12)
    for r in reqs:
        r.prompt_len = int(min(r.prompt_len, 16))
        r.output_len = int(min(r.output_len, 3 + r.prompt_len % 9))
        r.prompt_tokens = rng.integers(0, vocab, size=(r.prompt_len,), dtype=np.int32)
    return reqs


def _run_both(make_controller, monkeypatch, max_chips=4, trace=_trace):
    """The same trace through the reference's cluster (patched to requeue
    its engines' preemptions, as the port does) and the port's, on the
    reference's weights and a shared fake clock; returns both recorders,
    both results and both request lists."""
    for key, value in _REF_CONSTANTS.items():
        monkeypatch.setattr(perf_model, key, value)
    rcfg, cfg = ref_smoke_config("llama-8b"), get_smoke_config("llama-8b")
    kw = dict(max_chips=max_chips, max_slots=3, max_len=64)
    ref_cluster = ref_real_cluster.RealCluster(rcfg, **kw)
    params = port_params.from_reference(
        jax.tree.map(np.asarray, ref_cluster._shared_params), cfg, device="cpu")
    port_cluster = RealCluster(cfg, device="cpu", params=params, **kw)
    runs = []
    for pkg, wmod, cluster in (("ref", ref_workload, ref_cluster),
                               ("port", workload, port_cluster)):
        reqs = trace(wmod, cfg.vocab_size)
        clock = SharedClock(0.05)
        rec = ClusterRecorder(cluster, reqs, clock)
        if pkg == "ref":         # the patched reference (module docstring)
            _requeue_engine_preemptions(monkeypatch, rec)
        out = (ref_real_cluster.serve_forever if pkg == "ref" else serve_forever)(
            reqs, make_controller(pkg), cluster, clock=clock.advance, max_steps=1500)
        runs.append((rec, out, reqs))
    return runs


def _assert_same_run(ref, port):
    (rrec, rout, rreqs), (prec, pout, preqs) = ref, port
    rd, pd = rrec.decisions(), prec.decisions()
    assert pd == rd, next((i, a, b) for i, (a, b) in enumerate(zip(pd, rd)) if a != b) \
        if len(pd) == len(rd) else (len(pd), len(rd))
    # every step's tokens, step by step
    steps_r = [e for e in rrec.log if e[0] == "step"]
    steps_p = [e for e in prec.log if e[0] == "step"]
    assert len(steps_p) == len(steps_r)
    for i, (a, b) in enumerate(zip(steps_p, steps_r)):
        assert a == b, f"engine step {i}: {a} != {b}"
    assert prec.log == rrec.log
    assert {k: pout[k] for k in ("steps", "finished", "total", "scale_ups",
                                 "scale_downs")} == \
        {k: rout[k] for k in ("steps", "finished", "total", "scale_ups", "scale_downs")}
    for a, b in zip(preqs, rreqs):
        assert (a.state.value, a.tokens_generated, a.preemptions) == \
            (b.state.value, b.tokens_generated, b.preemptions)
    assert pout["finished"] == pout["total"]


def test_chiron_hierarchy_matches_the_reference(monkeypatch):
    def make(pkg):
        mod = ref_controllers if pkg == "ref" else controllers
        return mod.ChironController(model="llama-8b", init_batch=2, max_batch=3)

    ref, port = _run_both(make, monkeypatch)
    _assert_same_run(ref, port)
    decisions = port[0].decisions()
    provisioned = {e[2] for e in decisions if e[0] == "provision"}
    assert provisioned == {"mixed", "batch"}        # both arms of the global layer
    # a retirement that carries running requests' KV to the queue, and
    # requests the engines preempted themselves
    assert any(e[0] == "retire" and e[2] for e in decisions)
    assert sum(len(e[4]) for e in port[0].log if e[0] == "step") >= 1
    assert port[1]["scale_ups"] >= 4 and port[1]["scale_downs"] >= 2


def test_a_two_model_fleet_matches_the_reference(monkeypatch):
    """One hierarchy per model on one chip budget, each with its own IBP
    scaler, batch scaler and QLM estimator. (Both models are configured:
    ``serve_forever`` never calls ``observe_arrival``, so a model it would
    discover from the arrivals is never served, in either package.)"""
    def make(pkg):
        mod = ref_controllers if pkg == "ref" else controllers
        return mod.ChironController(models=["llama-8b", "granite-8b"],
                                    init_batch=2, max_batch=3)

    ref, port = _run_both(make, monkeypatch, max_chips=5, trace=_two_model_trace)
    _assert_same_run(ref, port)
    rec, out, reqs = port
    placed = {}
    for e in rec.log:
        if e[0] == "admit":
            placed.setdefault(e[1], set()).add(reqs[e[2]].model)
    assert all(len(models) == 1 for models in placed.values())
    assert {m for models in placed.values() for m in models} == {"llama-8b",
                                                                 "granite-8b"}


def test_llumnix_controller_matches_the_reference(monkeypatch):
    def make(pkg):
        mod = ref_controllers if pkg == "ref" else controllers
        return mod.LlumnixController(model="llama-8b", static_batch=3)

    ref, port = _run_both(make, monkeypatch)
    _assert_same_run(ref, port)
    assert port[1]["scale_ups"] >= 2
