"""Dev check of the port's simulator: perf-model curves on the H100's
constants + a small Chiron-vs-Llumnix simulation (host code).

  PYTHONPATH=src python scripts/dev_sim_torch.py
"""
from repro_torch.sim.perf_model import PerfModel
from repro_torch.sim.workload import WorkloadSpec, generate
from repro_torch.sim.cluster import SimCluster
from repro_torch.sim.controllers import ChironController, LlumnixController
from repro_torch.sim.simulator import default_perf_factory, simulate

# --- Fig 3 shape: ITL and throughput vs batch size
for model in ("llama-8b", "llama-70b"):
    pm = PerfModel(model)
    print(f"\n{model}: chips={pm.chips} params={pm.n_params/1e9:.1f}B "
          f"kv/tok={pm.kv_bytes_per_token()/1024:.0f}KiB "
          f"kv_cap={pm.kv_capacity_tokens()/1e3:.0f}k tok "
          f"load={pm.model_load_time():.0f}s")
    prev_thr = 0
    for b in (1, 8, 32, 64, 128, 256, 512, 1024):
        itl = pm.itl(b, 1024)
        thr = pm.throughput(b, 1024)
        print(f"  b={b:5d} itl={itl*1000:8.1f}ms thr={thr:8.0f} tok/s")
    print(f"  optimal batch @ITL 0.2s: {pm.optimal_batch(0.2, 1024)}, "
          f"@ITL 2s: {pm.optimal_batch(2.0, 1024)}")

# --- small interactive workload sim
spec = WorkloadSpec(n_requests=400, arrival_rate=20.0, model="llama-8b", seed=1)
reqs_c = generate(spec)
reqs_l = generate(spec)

cl = SimCluster(default_perf_factory(), max_chips=50)
ctrl = ChironController(model="llama-8b")
res_c = simulate(reqs_c, ctrl, cl, max_time=600, warm_start=2)
print("\nChiron:", {k: round(v, 3) for k, v in res_c.summary().items()})

cl2 = SimCluster(default_perf_factory(), max_chips=50)
ctrl2 = LlumnixController(model="llama-8b")
res_l = simulate(reqs_l, ctrl2, cl2, max_time=600, warm_start=2)
print("Llumnix:", {k: round(v, 3) for k, v in res_l.summary().items()})
