"""End-to-end example of the port: a real serving engine with Chiron's
local autoscaler.

  PYTHONPATH=src python examples/serve_autoscaled_torch.py [--arch mamba2-1.3b] \
      [--device cpu]

A continuous-batching engine serves a mixed interactive+batch workload on
the reduced model; the local autoscaler closes the loop on measured ITL
and throughput, and an interactive request preempts a batch request on the
(mixed) instance — the full Chiron mixed-instance story on one card (the
default, ``--device cuda``; it fails without a GPU) or on the CPU.
"""
import argparse
import time

import torch

from repro_torch.configs import get_smoke_config
from repro_torch.core.backpressure import LocalMetrics
from repro_torch.core.local_autoscaler import LocalAutoscaler
from repro_torch.serving.engine import Engine
from repro_torch.serving.request import RequestState, make_batch, make_interactive

ap = argparse.ArgumentParser()
ap.add_argument("--arch", default="granite-8b")
ap.add_argument("--device", default="cuda",
                help="cuda (default; fails without a GPU) or cpu")
args = ap.parse_args()

cfg = get_smoke_config(args.arch)
if cfg.has_attention:
    # the attention kernels take head_dim 64, 80, 96 and 128, not the
    # reduced configs' 32
    cfg = cfg.with_(head_dim=64)
eng = Engine(cfg, max_slots=6, max_len=128, dtype=torch.float32, device=args.device)
scaler = LocalAutoscaler(itl_slo=1.0, init_batch=2, max_batch=6)

reqs = ([make_batch(16, 40) for _ in range(4)] +
        [make_interactive(12, 10) for _ in range(4)])
for r in reqs[:4]:
    eng.submit(r)

# repro-lint: ok(DET202, real-engine wall clock)
t0 = time.monotonic()
step = 0
while eng.waiting or eng.n_active or step == 0:
    stats = eng.step()
    step += 1
    if step == 6:   # interactive burst mid-run -> preemption path
        for r in reqs[4:]:
            eng.submit(r)
        print(f"step {step}: interactive burst submitted")
    if stats.preempted:
        print(f"step {step}: PREEMPTED batch request "
              f"{[r.req_id for r in stats.preempted]} (KV saved to host)")
        for r in stats.preempted:
            eng.submit(r)   # back into the queue; resumes from saved KV
    if step % 5 == 0 and stats.n_active:
        bs = scaler.update(LocalMetrics(stats.itl, stats.throughput or 1.0,
                                        itl_slo=1.0))
        eng.set_max_batch_size(bs)
        print(f"step {step:3d}: active={stats.n_active} "
              f"itl={stats.itl*1e3:5.0f}ms thr={stats.throughput:6.1f} tok/s "
              f"max_batch={bs}")
    if step > 400:
        break

# repro-lint: ok(DET202, real-engine wall clock)
wall = time.monotonic() - t0
done = [r for r in reqs if r.state == RequestState.FINISHED]
toks = sum(r.tokens_generated for r in reqs)
print(f"\n{len(done)}/{len(reqs)} requests served, {toks} tokens in "
      f"{wall:.1f}s; preemptions: {sum(r.preemptions for r in reqs)}; "
      f"ITL SLO met: {sum(r.itl_met() for r in done)}/{len(done)}")
assert len(done) == len(reqs)
