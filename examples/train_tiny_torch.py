"""End-to-end training example of the port: a ~100M-parameter model.

  PYTHONPATH=src python examples/train_tiny_torch.py [--steps 200] [--device cpu]

Exercises the full training substrate (model stack, AdamW, checkpointing) with an OLMo-family config scaled to ~100M parameters,
through ``repro_torch.launch.train.train``: on the GPU (``--device cuda``,
the default; it fails without one) the attention's forward and backward
run through the hand-written kernels, on the CPU through their plain
versions. ``--checkpoint DIR`` saves the final parameters.
"""
import argparse

from repro_torch.configs import get_config
from repro_torch.launch.train import train
from repro_torch.training.checkpoint import save_checkpoint


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; fails without a GPU) or cpu")
    args = ap.parse_args()
    # ~100M variant of the olmo family
    cfg = get_config("olmo-1b").with_(n_layers=8, d_model=512, n_heads=8, n_kv_heads=8,
                                      d_ff=2048, vocab_size=32000)
    print(f"training {cfg.name} (~100M variant): {cfg.param_count()/1e6:.1f}M params "
          f"on {args.device}")
    res = train(cfg, steps=args.steps, batch=args.batch, seq=args.seq, lr=1e-3,
                device=args.device,
                log_every=max(1, args.steps // 10))
    losses = res["losses"]
    print(f"\nloss {losses[0]:.4f} -> {losses[-1]:.4f} over {args.steps} steps")
    if args.checkpoint:
        save_checkpoint(args.checkpoint, {"params": res["params"]},
                        meta={"arch": cfg.name, "steps": args.steps})
        print(f"checkpoint saved to {args.checkpoint}")


if __name__ == "__main__":
    main()
