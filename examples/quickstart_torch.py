"""Quickstart of the PyTorch/CUDA port: the public API in five minutes.

  PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]

1. pick an assigned architecture config (full or reduced),
2. build the model on the device, run a forward pass,
3. prefill a prompt and decode a few tokens through the paged KV cache,
4. score a batch (training loss),
5. inspect Chiron's autoscaler on synthetic metrics.

Runs on the GPU (``--device cuda``, the default; it fails when there is
none), where the attention goes through the hand-written kernels, or on the
CPU through their plain versions.
"""
import argparse

import torch

from repro_torch.configs import get_config, get_smoke_config, list_archs
from repro_torch.core.backpressure import LocalMetrics
from repro_torch.core.local_autoscaler import LocalAutoscaler
from repro_torch.models import get_model

ap = argparse.ArgumentParser()
ap.add_argument("--device", default="cuda",
                help="cuda (default; fails without a GPU) or cpu")
args = ap.parse_args()

print("assigned architectures:", ", ".join(list_archs()))

# full config (what the dry run traces) vs reduced config (what runs here)
full = get_config("granite-8b")
print(f"\ngranite-8b full: {full.n_layers}L d={full.d_model} "
      f"params={full.param_count()/1e9:.1f}B [{full.source}]")

# head_dim 64: the attention kernels take 64, 80, 96 and 128, not the
# reduced config's 32
cfg = get_smoke_config("granite-8b").with_(head_dim=64)
model = get_model(cfg)
params = model.init(torch.Generator(device=args.device).manual_seed(0),
                    dtype=torch.float32, device=args.device)
print(f"reduced: {cfg.n_layers}L d={cfg.d_model} "
      f"params={cfg.param_count()/1e6:.1f}M on {args.device}")

# forward + loss
batch = model.example_batch(2, 32, torch.Generator(device=args.device).manual_seed(1),
                            dtype=torch.float32, device=args.device)
logits, aux = model.forward(params, batch)
print(f"\nforward: logits {tuple(logits.shape)}, loss "
      f"{float(model.loss(params, batch)):.3f}")

# prefill + decode (the serving path)
last, cache = model.prefill(params, batch, cache_len=48, dtype=torch.float32)
tok = last.argmax(-1)[:, None]
for i in range(4):
    logits_step, cache = model.decode_step(params, tok, cache)
    tok = logits_step.argmax(-1)[:, None]
print(f"decoded 4 tokens, cache pos now {cache['pos'].tolist()}")

# Chiron's local autoscaler (Algorithm 1) reacting to backpressure
scaler = LocalAutoscaler(itl_slo=0.2, init_batch=8)
print("\nAlgorithm 1 (batch-size autoscaling):")
for itl in (0.05, 0.05, 0.1, 0.25, 0.15):
    bs = scaler.update(LocalMetrics(observed_itl=itl, throughput=1000.0,
                                    itl_slo=0.2))
    print(f"  observed ITL {itl*1e3:4.0f}ms -> max batch size {bs}")
