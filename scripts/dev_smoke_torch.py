"""Dev-time quick check of the port: every assigned arch's forward,
prefill and decode step at the smoke size.

  PYTHONPATH=src python scripts/dev_smoke_torch.py [--device cpu] [arch ...]

On the GPU by default (it fails without one), on the CPU with ``--device cpu``.
"""
import argparse

import torch

from repro_torch.configs import ASSIGNED_ARCHS, get_smoke_config
from repro_torch.models import get_model

ap = argparse.ArgumentParser()
ap.add_argument("archs", nargs="*")
ap.add_argument("--device", default="cuda",
                help="cuda (default; fails without a GPU) or cpu")
args = ap.parse_args()

for arch in args.archs or ASSIGNED_ARCHS:
    cfg = get_smoke_config(arch)
    if cfg.has_attention:
        # the attention kernels take head_dim 64, 80, 96 and 128, not the
        # reduced configs' 32
        cfg = cfg.with_(head_dim=64)
    model = get_model(cfg)
    gen = torch.Generator(device=args.device).manual_seed(0)
    params = model.init(gen, dtype=torch.float32, device=args.device)
    B, S = 2, 64
    batch = model.example_batch(B, S, gen, dtype=torch.float32, device=args.device)
    logits, aux = model.forward(params, batch)
    assert logits.shape == (B, S, cfg.vocab_size), (arch, logits.shape)
    assert not bool(torch.isnan(logits).any()), f"{arch}: NaN in forward"
    loss = model.loss(params, batch)
    assert bool(torch.isfinite(loss)), f"{arch}: non-finite loss"
    # a paged cache with room for the prompt, a VLM's vision prefix and one token
    n_vis = cfg.n_vision_tokens if cfg.arch_type == "vlm" else 0
    last, cache = model.prefill(params, batch, cache_len=n_vis + S + 1,
                                dtype=torch.float32)
    assert last.shape == (B, cfg.vocab_size)
    tok = last.argmax(-1)[:, None]
    lg2, cache = model.decode_step(params, tok, cache)
    assert lg2.shape == (B, cfg.vocab_size)
    assert not bool(torch.isnan(lg2).any()), f"{arch}: NaN in decode"
    # consistency: prefill last-token logits == forward last-position logits
    err = float((last - logits[:, -1]).abs().max())
    print(f"{arch:20s} ok  loss={float(loss):.3f}  prefill/fwd err={err:.2e}")
print("ALL OK")
