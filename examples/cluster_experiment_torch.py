"""Cluster-scale experiment: Chiron vs Llumnix on the W_B workload
(the paper's Fig. 19 / Appendix A.2 scenario), in the port's simulator.

  PYTHONPATH=src python examples/cluster_experiment_torch.py

Host code only: the simulator plans on the H100's constants
(``repro_torch.sim.perf_model``) with a budget of 50 cards, the paper's.
"""
from repro_torch.sim.cluster import SimCluster
from repro_torch.sim.controllers import ChironController, LlumnixController
from repro_torch.sim.simulator import default_perf_factory, simulate
from repro_torch.sim.workload import WorkloadSpec, generate

SPEC = dict(n_requests=2000, arrival_rate=30.0, interactive_frac=1.0,
            batch_queue_size=30000, batch_ttft_slo=1800.0,
            model="llama-8b", seed=5)


def run(name, ctrl):
    reqs = generate(WorkloadSpec(**SPEC))
    cluster = SimCluster(default_perf_factory(), max_chips=50)
    res = simulate(reqs, ctrl, cluster, max_time=2400, warm_start=2)
    s = res.summary()
    print(f"\n=== {name} ===")
    print(f"  SLO attainment: {100*s['slo_attainment']:.1f}% "
          f"(interactive {100*s['slo_interactive']:.1f}%, "
          f"batch {100*s['slo_batch']:.1f}%); completed "
          f"{100*s['completion_rate']:.1f}%")
    print(f"  per-instance throughput: {s['per_instance_throughput']:.0f} tok/s")
    print(f"  GPU hours: {s['gpu_hours']:.2f}  peak chips: {s['peak_chips']}")
    print(f"  scaling actions: {res.scale_ups} up / {res.scale_downs} down "
          f"(hysteresis {s['hysteresis']:.2f})")
    print("  chips over time:",
          " ".join(f"{p.chips}" for p in res.timeline[::len(res.timeline)//12 or 1]))
    return res


res_c = run("Chiron", ChironController(model="llama-8b"))
res_l = run("Llumnix", LlumnixController(model="llama-8b"))

save = 100 * (1 - res_c.gpu_hours() / max(res_l.gpu_hours(), 1e-9))
peak = 100 * (1 - res_c.peak_chips / max(res_l.peak_chips, 1))
print(f"\nChiron vs Llumnix: GPU-hour savings {save:.1f}%, "
      f"peak-GPU savings {peak:.1f}% (paper: up to 70%)")
print("Note: on a FINITE batch workload Chiron deliberately provisions the")
print("minimum cluster that meets the deadline (paper Fig. 19); its savings")
print("show up as peak GPUs (the paper's Fig. 2 metric) and as GPU-hours")
print("whenever interactive load shares the over-provisioned capacity.")
