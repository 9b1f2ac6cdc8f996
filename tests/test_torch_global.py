"""The port's global layer on the CPU against the reference on the same
seeded inputs: the global queue, request groups, the QLM waiting-time
estimate, the interactive and batch autoscalers (Algorithm 2), the Llumnix
baseline, the arrival-spike statistics behind Theta and the performance
model Algorithm 2 plans from."""
import math

import numpy as np
import pytest
import torch

from repro.core import baselines as ref_baselines
from repro.core import global_autoscaler as ref_global
from repro.core import request_groups as ref_groups
from repro.core import waiting_time as ref_waiting
from repro.serving import global_queue as ref_queue
from repro.serving import request as ref_request
from repro.sim import perf_model as ref_perf
from repro.sim import workload as ref_workload
from repro_torch.core import baselines, global_autoscaler, request_groups, waiting_time
from repro_torch.serving import global_queue
from repro_torch.serving import request as port_request
from repro_torch.sim import perf_model, workload

# the test workers share the host's cores: cap each one's intra-op threads
torch.set_num_threads(2)

MODELS = ("llama-8b", "granite-8b")
TTFT_CLASSES = (5.0, 30.0, 120.0)


def _request(mod, kind, arrival, model, ttft):
    if kind == "interactive":
        return mod.make_interactive(16, 8, arrival=arrival, model=model)
    return mod.make_batch(16, 8, arrival=arrival, model=model, ttft_slo=ttft)


def _queue_script(seed, n_ops=600):
    """A seeded script of queue operations over both lanes and two models."""
    rng = np.random.default_rng(seed)
    ops, t = [], 0.0
    for _ in range(n_ops):
        u = rng.random()
        model = MODELS[int(rng.integers(2))] if rng.random() < 0.8 else None
        if u < 0.45:
            t += float(rng.exponential(0.3))
            kind = "interactive" if rng.random() < 0.5 else "batch"
            ops.append(("push", kind, t, model or MODELS[0],
                        TTFT_CLASSES[int(rng.integers(3))]))
        elif u < 0.6:
            ops.append(("requeue", int(rng.integers(1 << 30)), bool(rng.random() < 0.5)))
        elif u < 0.78:
            ops.append(("pop_interactive", model))
        elif u < 0.96:
            ops.append(("pop_batch", model))
        else:
            ops.append(("peek", model))
    return ops


class _Listener:
    def __init__(self, index):
        self.index, self.events = index, []

    def on_add(self, req):
        self.events.append(("add", self.index[id(req)]))

    def on_remove(self, req):
        self.events.append(("remove", self.index[id(req)]))


def _run_queue(qmod, rmod, ops):
    """Apply ``ops`` to a fresh queue; return what it said after each one."""
    q = qmod.GlobalQueue()
    reqs, index, popped, out = [], {}, [], []
    listener = _Listener(index)
    q.attach_batch_listener(listener, model=MODELS[1])

    def name(r):
        return None if r is None else index[id(r)]

    for op in ops:
        if op[0] == "push":
            r = _request(rmod, *op[1:])
            index[id(r)] = len(reqs)
            reqs.append(r)
            q.push(r)
            got = None
        elif op[0] == "requeue":
            if not popped:
                continue
            r = popped.pop(op[1] % len(popped))
            # a preempted batch request may carry host-saved KV (resume lane)
            r.saved_kv = {"k": 0} if op[2] and not r.is_interactive else None
            q.requeue(r)
            got = name(r)
        elif op[0] == "pop_interactive":
            got = name(q.pop_interactive(op[1]))
        elif op[0] == "pop_batch":
            got = name(q.pop_batch_fcfs(op[1]))
        else:
            got = (name(q.peek_interactive(op[1])), name(q.peek_batch(op[1])))
        if op[0].startswith("pop") and got is not None:
            popped.append(reqs[got])
        out.append((op[0], got, q.n_interactive, q.n_batch, len(q),
                     [(m, q.n_interactive_for(m), q.n_batch_for(m)) for m in MODELS],
                     q.interactive_models(), q.batch_models()))
    out.append(("snapshot", [name(r) for r in q.interactive],
                [name(r) for r in q.batch],
                sorted(name(r) for r in q.iter_batch())))
    return out, listener.events


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_global_queue_pops_in_the_same_order(seed):
    ops = _queue_script(seed)
    want, want_events = _run_queue(ref_queue, ref_request, ops)
    got, got_events = _run_queue(global_queue, port_request, ops)
    assert got == want
    assert got_events == want_events
    assert sum(1 for o in got if o[0].startswith("pop") and o[1] is not None) > 100


def _deadline_requests(mod, seed, n):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        ttft = float(rng.choice([60.0, 600.0, 1800.0, 3600.0]))
        out.append(mod.make_batch(16, 8, arrival=float(rng.uniform(0, 900)),
                                  ttft_slo=ttft))
    return out


@pytest.mark.parametrize("k", [1, 3, 8])
def test_kmeans_1d_gives_the_same_clusters(k):
    rng = np.random.default_rng(k)
    values = list(np.concatenate([rng.normal(c, 5.0, 40) for c in (0, 100, 400)]))
    assert request_groups.kmeans_1d(values, k) == ref_groups.kmeans_1d(values, k)
    big = list(rng.uniform(0, 5000, 3500))          # the subsampled path
    assert request_groups.cluster_deadlines(big, k) == \
        ref_groups.cluster_deadlines(big, k)
    assert request_groups.auto_k(values, 60.0) == ref_groups.auto_k(values, 60.0)


@pytest.mark.parametrize("k", [0, 2, -1])
def test_make_request_groups_gives_the_same_groups(k):
    def groups(gmod, rmod):
        reqs = _deadline_requests(rmod, 3, 120)
        index = {id(r): i for i, r in enumerate(reqs)}
        return [(sorted(index[id(r)] for r in g.requests), g.deadline,
                 g.centroid_deadline) for g in gmod.make_request_groups(reqs, k=k)]

    assert groups(request_groups, port_request) == groups(ref_groups, ref_request)


@pytest.mark.parametrize("k", [0, 3])
def test_incremental_grouper_gives_the_same_groups(k):
    def run(gmod, rmod):
        reqs = _deadline_requests(rmod, 4, 300)
        g = gmod.IncrementalGrouper(k=k, deadline_tolerance=300.0,
                                    min_rebuild_changes=40)
        rng = np.random.default_rng(9)
        live, seen = [], []
        for r in reqs:
            g.on_add(r)
            live.append(r)
            if rng.random() < 0.35:
                g.on_remove(live.pop(int(rng.integers(len(live)))))
            if rng.random() < 0.1:
                seen.append([(s.deadline, s.n) for s in g.group_stats()])
        seen.append([(s.deadline, s.n) for s in g.group_stats()])
        return seen, g.rebuilds, g.n_members

    got, want = run(request_groups, port_request), run(ref_groups, ref_request)
    assert got == want
    assert got[1] >= 2


def test_waiting_time_estimate_is_the_same():
    rng = np.random.default_rng(0)
    outs = rng.integers(4, 2048, 500)
    for z in (0.0, 1.645):
        ours = waiting_time.WaitingTimeEstimator(quantile_z=z)
        ref = ref_waiting.WaitingTimeEstimator(quantile_z=z)
        for i, o in enumerate(outs):
            if i in (0, 1, 7, 100, 499):       # the prior, then the online fit
                for n, thr, inst in ((0, 100.0, 1), (1, 250.0, 2), (37, 1e3, 3),
                                     (2000, 5e4, 1), (5, 0.0, 1)):
                    a = ours.waiting_time(n, thr, inst)
                    b = ref.waiting_time(n, thr, inst)
                    assert abs(a - b) <= 1e-12 * max(abs(b), 1.0)
                assert ours.output_model.mu == ref.output_model.mu
                assert ours.output_model.sigma == ref.output_model.sigma
            ours.output_model.observe(int(o))
            ref.output_model.observe(int(o))


def test_interactive_autoscaler_decides_the_same():
    rng = np.random.default_rng(1)
    for theta, delta, floor in ((1 / 3, 0.1, 1), (0.5, 0.05, 2), (0.25, 0.2, 0)):
        ours = global_autoscaler.InteractiveAutoscaler(theta, delta, floor)
        ref = ref_global.InteractiveAutoscaler(theta, delta, floor)
        for _ in range(300):
            n_i, n_m = int(rng.integers(0, 6)), int(rng.integers(0, 9))
            running = int(rng.integers(0, n_i + n_m + 1))
            a, b = ours.update(running, n_i, n_m), ref.update(running, n_i, n_m)
            assert (a.delta_instances, a.ibp) == (b.delta_instances, b.ibp)


def _batch_queue(qmod, rmod, seed, n):
    q = qmod.GlobalQueue()
    rng = np.random.default_rng(seed)
    t = 0.0
    for _ in range(n):
        t += float(rng.exponential(0.5))
        q.push(rmod.make_batch(16, 8, arrival=t,
                               ttft_slo=float(rng.choice([2.0, 20.0, 200.0]))))
    return q


@pytest.mark.parametrize("group_k", [0, -1, 2])
def test_batch_autoscaler_decides_the_same(group_k):
    """Algorithm 2 on seeded queues: the same adds, retirements, removals,
    backpressure and waiting-time estimate, tick by tick, while the queue
    drains (the request groups maintained off the queue's add/remove
    stream)."""
    def run(gmod, wmod, qmod, rmod):
        est = wmod.WaitingTimeEstimator()
        for o in (100, 300, 250, 80):
            est.output_model.observe(o)
        scaler = gmod.BatchAutoscaler(est, 400.0, group_k=group_k,
                                      model="llama-8b")
        q = _batch_queue(qmod, rmod, 11, 80)
        rng = np.random.default_rng(2)
        out = []
        for tick in range(40):
            now = 2.0 * tick
            d = scaler.update(q, now, n_batch_instances=int(rng.integers(0, 4)),
                              spare_mixed_throughput=float(rng.uniform(0, 300)),
                              n_active_batch_requests=int(rng.integers(0, 3)))
            out.append((d.add_instances, d.retire_all, d.bbp_before,
                        d.remove_instances, len(d.groups),
                        None if math.isnan(scaler.last_wait) else scaler.last_wait))
            for _ in range(int(rng.integers(0, 5))):
                q.pop_batch_fcfs("llama-8b")
        # and on a plain snapshot list
        snap = _deadline_requests(rmod, 6, 50)
        d = scaler.update(snap, 100.0, n_batch_instances=1)
        out.append((d.add_instances, d.retire_all, d.bbp_before, d.remove_instances))
        return out

    got = run(global_autoscaler, waiting_time, global_queue, port_request)
    want = run(ref_global, ref_waiting, ref_queue, ref_request)
    assert got == want
    assert any(o[0] > 0 for o in got) and any(o[1] or o[3] for o in got[:-1])


@pytest.mark.parametrize("group_k", [0, -1])
def test_batch_autoscaler_counts_only_its_model(group_k):
    """One ``BatchAutoscaler`` per model over a queue that holds two models'
    batch work: each plans from its own model's requests alone, as the
    reference's do."""
    def run(gmod, wmod, qmod, rmod):
        q = qmod.GlobalQueue()
        rng = np.random.default_rng(13)
        for i in range(60):
            q.push(rmod.make_batch(16, 8, arrival=0.1 * i, model=MODELS[i % 3 == 0],
                                   ttft_slo=float(rng.choice([2.0, 20.0]))))
        out = []
        for model in MODELS:
            scaler = gmod.BatchAutoscaler(wmod.WaitingTimeEstimator(), 300.0,
                                          group_k=group_k, model=model)
            d = scaler.update(q, 1.0, n_batch_instances=0)
            out.append((model, d.add_instances, d.bbp_before,
                        sum(g.n for g in d.groups), q.n_batch_for(model)))
        return out

    got = run(global_autoscaler, waiting_time, global_queue, port_request)
    assert got == run(ref_global, ref_waiting, ref_queue, ref_request)
    assert [o[3] for o in got] == [o[4] for o in got] == [40, 20]


def test_llumnix_and_the_small_baselines_decide_the_same():
    rng = np.random.default_rng(3)
    pairs = [(baselines.LlumnixAutoscaler(), ref_baselines.LlumnixAutoscaler()),
             (baselines.LlumnixAutoscaler(0.2, 0.7, 2, 2),
              ref_baselines.LlumnixAutoscaler(0.2, 0.7, 2, 2)),
             (baselines.StaticAutoscaler(3), ref_baselines.StaticAutoscaler(3)),
             (baselines.UtilizationGlobalScaler(), ref_baselines.UtilizationGlobalScaler())]
    for ours, ref in pairs:
        deltas = []
        for _ in range(200):
            u, n, q = float(rng.random()), int(rng.integers(0, 6)), int(rng.integers(0, 3) == 0)
            a = ours.update(u, n, q)
            assert a == ref.update(u, n, q)
            deltas.append(a)
        assert len(set(deltas)) >= 2


def test_arrival_spikes_and_theta_are_the_same():
    rng = np.random.default_rng(4)
    arrivals = np.sort(np.concatenate([rng.uniform(0, 600, 400), rng.uniform(300, 330, 200)]))
    reqs_port = [port_request.make_interactive(8, 8, arrival=float(t)) for t in arrivals]
    reqs_ref = [ref_request.make_interactive(8, 8, arrival=float(t)) for t in arrivals]
    for interval in (10.0, 30.0):
        want = ref_workload.arrival_spikes(arrivals, interval)
        np.testing.assert_array_equal(workload.arrival_spikes(arrivals, interval), want)
        np.testing.assert_array_equal(workload.arrival_spikes(reqs_port, interval),
                                      ref_workload.arrival_spikes(reqs_ref, interval))
        np.testing.assert_array_equal(workload.arrival_spikes(list(arrivals), interval), want)
        assert workload.theta_from_history(arrivals, interval) == \
            ref_workload.theta_from_history(arrivals, interval)
    assert workload.arrival_spikes([]).size == 0
    assert workload.theta_from_history([]) == ref_workload.theta_from_history([])


# the reference's TPU constants, patched into the port's module for parity
_REF_CONSTANTS = {"PEAK_FLOPS": ref_perf.PEAK_FLOPS, "HBM_BW": ref_perf.HBM_BW,
                  "HBM_BYTES": ref_perf.HBM_BYTES, "LINK_BW": ref_perf.ICI_BW,
                  "MBU": ref_perf.MBU, "STEP_OVERHEAD": ref_perf.STEP_OVERHEAD,
                  "MFU_DECODE": ref_perf.MFU_DECODE,
                  "INSTANCE_CHIPS": dict(ref_perf.INSTANCE_CHIPS)}


def _close(a, b):
    return a == b or abs(a - b) <= 1e-12 * max(abs(a), abs(b))


@pytest.mark.parametrize("name", ["llama-8b", "granite-8b", "mamba2-1.3b",
                                  "whisper-base"])
def test_perf_model_formulas_match_with_the_reference_constants(name, monkeypatch):
    for key, value in _REF_CONSTANTS.items():
        monkeypatch.setattr(perf_model, key, value)
    # (chip counts whose memory holds the weights: with none left for KV,
    # both packages divide by a zero capacity)
    for kw in ({}, {"chips": 2}, {"chips": 8}):
        ours, ref = perf_model.PerfModel(name, **kw), ref_perf.PerfModel(name, **kw)
        assert ours.chips == ref.chips
        assert _close(ours.kv_capacity_tokens(), ref.kv_capacity_tokens())
        for ctx in (128.0, 512.0, 1024.0, 8192.0):
            for b in (1, 8, 64, 512, 4096):
                assert _close(ours.itl(b, ctx), ref.itl(b, ctx))
                assert _close(ours.throughput(b, ctx), ref.throughput(b, ctx))
            for slo in (0.05, 0.2, 2.0):
                assert ours.optimal_batch(slo, ctx) == ref.optimal_batch(slo, ctx)


def test_perf_model_plans_for_the_h100():
    """With its own constants the model plans llama-8b on one 80 GB card:
    one copy of the bf16 weights and the rest (less a tenth) for KV."""
    m = perf_model.PerfModel("llama-8b")
    assert m.chips == 1 and m._coll_t == 0.0
    kv_per_token = 2 * 32 * 8 * 128 * 2
    assert m._kv_per_tok == kv_per_token
    assert m.weight_bytes == 2 * 8_029_995_008
    want = (80e9 - m.weight_bytes) * 0.9 / kv_per_token
    assert abs(m.kv_capacity_tokens() / want - 1) < 1e-12
    # a decode step of 8 slots at 1024 tokens: streaming 16 GB of weights and
    # 1.07 GB of KV at the fitted share (0.476) of 3.35 TB/s, plus the
    # fitted step overhead (0.74 ms)
    assert perf_model.MBU == pytest.approx(0.4761, abs=1e-4)
    assert perf_model.STEP_OVERHEAD == pytest.approx(7.425e-4, abs=1e-7)
    assert 0.0110 < m.itl(8, 1024.0) < 0.0120
    assert perf_model.PerfModel("granite-8b").chips == 1
    assert perf_model.PerfModel("mamba2-1.3b").chips == 1
    # a planning size with headroom for KV, not what one card can hold
    assert perf_model.PerfModel("yi-34b").chips == 2
    assert perf_model.PerfModel("qwen2-moe-a2.7b").chips == 1
    assert perf_model.PerfModel("whisper-base").chips == 1
