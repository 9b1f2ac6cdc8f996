"""Training launcher of the port: end-to-end LM training with AdamW and
checkpoints, on the GPU (``--device cuda``, the default; it fails when
there is none) or, with ``--device cpu``, through the kernels' plain
versions.

  PYTHONPATH=src python -m repro_torch.launch.train --arch olmo-1b --steps 200 \\
      --batch 8 --seq 128

Without ``--full-config`` the reduced (smoke) variant of the architecture
trains. Every family trains on the card: the attention's gradient runs
through the ``flash_prefill`` backward kernel (dense, vlm, moe, audio, and
the hybrid's shared block), the SSD scan's through the ``ssd_scan``
backward kernel (ssm, hybrid). On the CPU both run through their plain
versions.
"""
from __future__ import annotations

import argparse
import time
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.configs.base import ModelConfig
from repro_torch.launch.steps import make_train_step
from repro_torch.models import Model
from repro_torch.models.api import resolve_device
from repro_torch.training.checkpoint import save_checkpoint
from repro_torch.training.optimizer import adamw_init


def synthetic_lm_batch(rng: np.random.Generator, model: Model, batch: int, seq: int,
                       device="cuda") -> Dict[str, torch.Tensor]:
    """Structured synthetic data (learnable ramps with 10 % noise), the
    reference's ``synthetic_lm_batch``: the same numpy draws in the same
    order, so a seed gives the reference's tokens bit for bit. Audio and
    VLM batches carry zero float32 frame or vision embeddings."""
    cfg = model.cfg
    v = cfg.vocab_size
    base = rng.integers(0, v, size=(batch, 1), dtype=np.int32)
    ramp = (base + np.arange(seq, dtype=np.int32)[None, :] *
            rng.integers(1, 7, size=(batch, 1))) % v
    noise = rng.integers(0, v, size=(batch, seq), dtype=np.int32)
    mask = rng.random((batch, seq)) < 0.1
    toks = np.where(mask, noise, ramp).astype(np.int32)
    device = resolve_device(device)
    b = {"tokens": torch.from_numpy(toks).long().to(device)}
    if cfg.arch_type == "audio":
        b["frames"] = torch.zeros((batch, cfg.enc_seq, cfg.d_model), device=device)
    if cfg.arch_type == "vlm":
        b["vision"] = torch.zeros((batch, cfg.n_vision_tokens, cfg.d_model),
                                  device=device)
    return b


def train(cfg: ModelConfig, *, steps: int, batch: int, seq: int, lr: float = 1e-3,
          remat: bool = False, device="cuda", log_every: int = 0,
          on_step: Optional[Callable[[int], None]] = None) -> Dict[str, Any]:
    """Train ``cfg`` in float32 for ``steps`` steps on synthetic batches
    (numpy seed 0) from random parameters (a generator on the device seeded
    with 0); returns the model, the final parameters and optimizer state and
    each step's loss, gradient norm and wall time (the step's work waited
    for). ``on_step(i)`` runs after step ``i``."""
    device = resolve_device(device)
    model = Model(cfg)
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    params = model.init(gen, dtype=torch.float32, device=device)
    opt = adamw_init(params)
    step_fn = make_train_step(cfg, remat=remat, lr=lr)
    rng = np.random.default_rng(0)
    losses, norms, times = [], [], []
    for i in range(steps):
        b = synthetic_lm_batch(rng, model, batch, seq, device=device)
        # repro-lint: ok(DET202, real training wall clock)
        t0 = time.monotonic()
        params, opt, m = step_fn(params, opt, b)
        losses.append(float(m["loss"]))       # waits for the step
        norms.append(float(m["grad_norm"]))
        # repro-lint: ok(DET202, real training wall clock)
        times.append(time.monotonic() - t0)
        if on_step is not None:
            on_step(i)
        if log_every and (i % log_every == 0 or i == steps - 1):
            print(f"step {i:4d} loss={losses[-1]:.4f} gnorm={norms[-1]:.3f} "
                  f"({times[-1]:.3f}s/step)")
    return {"params": params, "opt_state": opt, "losses": losses,
            "grad_norms": norms, "step_s": times, "model": model}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="olmo-1b")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--full-config", action="store_true")
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--log-every", type=int, default=20)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; fails without a GPU) or cpu")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch) if args.full_config \
        else get_smoke_config(args.arch)
    print(f"training {cfg.name}: {cfg.param_count()/1e6:.1f}M params "
          f"(reduced={not args.full_config}) on {args.device}")
    res = train(cfg, steps=args.steps, batch=args.batch, seq=args.seq, lr=args.lr,
                remat=False, device=args.device, log_every=args.log_every)
    losses = res["losses"]
    print(f"\nloss {losses[0]:.4f} -> {losses[-1]:.4f} over {args.steps} steps")
    if args.checkpoint:
        save_checkpoint(args.checkpoint, {"params": res["params"]},
                        meta={"arch": cfg.name, "steps": args.steps})
        print(f"checkpoint saved to {args.checkpoint}")


if __name__ == "__main__":
    main()
