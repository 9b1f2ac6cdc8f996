"""The port's copies of the control plane give what the reference's give:
the same requests from one workload spec and seed, and the same
Algorithm-1 batch-size history on the same metrics."""
import numpy as np
import pytest
import torch

from repro.core.backpressure import LocalMetrics as RefMetrics
from repro.core.local_autoscaler import LocalAutoscaler as RefAutoscaler
from repro.sim import workload as ref_workload
from repro_torch.core.backpressure import LocalMetrics, local_backpressure
from repro_torch.core.local_autoscaler import LocalAutoscaler
from repro_torch.sim import workload

# the test workers share the host's cores: cap each one's intra-op threads
torch.set_num_threads(2)

_FIELDS = ("prompt_len", "output_len", "arrival_time", "model")


@pytest.mark.parametrize("kw", [
    dict(seed=0, n_requests=64, interactive_frac=0.7),
    dict(seed=3, n_requests=200, arrival_rate=50.0, interactive_frac=0.7,
         model="granite-8b"),
    dict(seed=11, n_requests=100, process="gamma", cv=2.0, interactive_frac=0.4),
    dict(seed=5, n_requests=40, batch_queue_size=25, batch_ttft_slo=900.0),
])
def test_generate_same_requests_as_reference(kw):
    got = workload.generate(workload.WorkloadSpec(**kw))
    want = ref_workload.generate(ref_workload.WorkloadSpec(**kw))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for f in _FIELDS:       # draw for draw: exact equality
            assert getattr(g, f) == getattr(w, f), f
        assert g.request_type.value == w.request_type.value
        assert (g.slo.ttft, g.slo.itl) == (w.slo.ttft, w.slo.itl)
        assert g.state.value == w.state.value == "queued"
        assert isinstance(g.prompt_len, int) and isinstance(g.arrival_time, float)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_local_autoscaler_same_history_as_reference(seed):
    rng = np.random.default_rng(seed)
    ours = LocalAutoscaler(itl_slo=0.2, init_batch=2, max_batch=64)
    theirs = RefAutoscaler(itl_slo=0.2, init_batch=2, max_batch=64)
    for _ in range(60):
        itl = float(rng.uniform(0.02, 0.35))
        thr = float(rng.uniform(50.0, 400.0))
        a = ours.update(LocalMetrics(observed_itl=itl, throughput=thr, itl_slo=0.2))
        b = theirs.update(RefMetrics(observed_itl=itl, throughput=thr, itl_slo=0.2))
        assert a == b
    assert ours.history == theirs.history
    assert ours.converged() == theirs.converged()


def test_local_backpressure_is_max_of_latency_and_throughput_terms():
    assert local_backpressure(0.3, 0.2, None, 100.0) == pytest.approx(1.5)
    assert local_backpressure(0.1, 0.2, 200.0, 100.0) == pytest.approx(2.0)
