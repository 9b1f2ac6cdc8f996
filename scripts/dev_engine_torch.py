"""Dev check of the port: the continuous-batching engine + the local
autoscaler loop.

  PYTHONPATH=src python scripts/dev_engine_torch.py [--device cpu]

On the GPU by default (it fails without one), on the CPU with ``--device cpu``.
"""
import argparse

import torch

from repro_torch.configs import get_smoke_config
from repro_torch.core.backpressure import LocalMetrics
from repro_torch.core.local_autoscaler import LocalAutoscaler
from repro_torch.serving.engine import Engine
from repro_torch.serving.request import make_batch, make_interactive

ap = argparse.ArgumentParser()
ap.add_argument("--device", default="cuda",
                help="cuda (default; fails without a GPU) or cpu")
args = ap.parse_args()

# head_dim 64: the attention kernels take 64, 80, 96 and 128, not the
# reduced config's 32
cfg = get_smoke_config("granite-8b").with_(head_dim=64)
eng = Engine(cfg, max_slots=4, max_len=96, dtype=torch.float32, device=args.device)

reqs = [make_interactive(16, 8), make_interactive(24, 12),
        make_batch(16, 20), make_batch(16, 20), make_batch(16, 6)]
for r in reqs:
    eng.submit(r)

scaler = LocalAutoscaler(itl_slo=0.5, init_batch=2, max_batch=4)
steps = 0
while (eng.waiting or eng.n_active) and steps < 200:
    stats = eng.step()
    steps += 1
    if steps % 5 == 0:
        bs = scaler.update(LocalMetrics(stats.itl, stats.throughput or 1.0, 0.5))
        eng.set_max_batch_size(bs)

fin = [r for r in reqs if r.state.value == "finished"]
print(f"steps={steps} finished={len(fin)}/{len(reqs)} "
      f"final_bs={scaler.max_batch_size}")
assert len(fin) == len(reqs), [r.state for r in reqs]
for r in reqs:
    assert r.tokens_generated >= r.output_len
    assert r.first_token_time is not None
print("preemptions:", [r.preemptions for r in reqs])
print("ENGINE OK")
