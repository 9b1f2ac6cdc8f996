"""Serving launcher: run a real continuous-batching instance with Chiron's
local autoscaler closed-loop on measured ITL/throughput.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama-8b \
      --full-config --dtype bfloat16 --max-len 1024

Runs on the GPU (``--device cuda``, the default) and fails when there is
none; ``--device cpu`` serves the reduced (smoke) variant through the plain
PyTorch path. Without ``--full-config`` the reduced variant of the
architecture is served. Every ported architecture is served (``--arch``):
the dense ones (llama-8b, granite-8b, olmo-1b, phi3-mini-3.8b, yi-34b,
llama-70b), the MoE ones (qwen2-moe-a2.7b, deepseek-moe-16b), the VLM
internvl2-2b (zero vision embeddings in front of each prompt, as the
reference engine feeds), the ssm mamba2-1.3b, the hybrid zamba2-2.7b and
the encoder-decoder whisper-base (zero frame embeddings for each prompt,
as the reference engine feeds).
"""
from __future__ import annotations

import argparse
import time
from typing import Any, Dict, Optional

import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.configs.base import ModelConfig
from repro_torch.core.backpressure import LocalMetrics
from repro_torch.core.local_autoscaler import LocalAutoscaler
from repro_torch.serving.engine import Engine
from repro_torch.sim.workload import WorkloadSpec, generate


def serve(cfg: ModelConfig, *, requests: int = 24, max_slots: int = 8,
          max_len: int = 160, itl_slo: float = 0.5, autoscale_every: int = 5,
          device="cuda", dtype=torch.float32,
          max_output: Optional[int] = None, verbose: bool = True) -> Dict[str, Any]:
    """Serve one generated workload to completion and return what was
    measured. ``max_output`` caps the output lengths below the launcher's own
    cap of ``max_len // 3`` (a shorter run, same path)."""
    eng = Engine(cfg, max_slots=max_slots, max_len=max_len, dtype=dtype,
                 device=device)
    scaler = LocalAutoscaler(itl_slo=itl_slo, init_batch=2, max_batch=max_slots)

    spec = WorkloadSpec(n_requests=requests, arrival_rate=50.0,
                        interactive_frac=0.7, model=cfg.name)
    reqs = generate(spec)
    out_cap = max_len // 3 if max_output is None else min(max_output, max_len // 3)
    # a VLM's vision prefix takes positions of the slot too
    n_vis = cfg.n_vision_tokens if cfg.arch_type == "vlm" else 0
    for r in reqs:
        r.prompt_len = min(r.prompt_len, max_len // 3, max_len - 1 - n_vis)
        r.output_len = min(r.output_len, out_cap)
        eng.submit(r)

    # repro-lint: ok(DET202, real-engine wall clock)
    t0 = time.monotonic()
    steps = decode_steps = 0
    itls = []
    while eng.waiting or eng.n_active:
        stats = eng.step()
        steps += 1
        if stats.n_active:
            decode_steps += 1
            itls.append(stats.itl)
        if steps % autoscale_every == 0 and stats.n_active:
            bs = scaler.update(LocalMetrics(
                observed_itl=stats.itl, throughput=stats.throughput or 1.0,
                itl_slo=itl_slo))
            eng.set_max_batch_size(bs)
            if verbose:
                print(f"step {steps:4d}: active={stats.n_active} itl="
                      f"{stats.itl*1e3:.0f}ms thr={stats.throughput:.1f} tok/s "
                      f"-> max_batch={bs}")

    # repro-lint: ok(DET202, real-engine wall clock)
    wall = time.monotonic() - t0
    done = [r for r in reqs if r.state.value == "finished"]
    toks = sum(r.tokens_generated for r in reqs)
    return {
        "engine": eng, "requests": reqs, "n_finished": len(done),
        "tokens": toks, "wall_s": wall, "tokens_per_s": toks / wall,
        "steps": steps, "decode_steps": decode_steps, "itl_s": itls,
        # every request is submitted at t0, so this is time to first token
        # from submission (the trace's own arrival times are not replayed)
        "ttft_s": [r.first_token_time - t0 for r in reqs
                   if r.first_token_time is not None],
        "prefills": len(reqs),   # once each: a restored request is not prefilled again
        "batch_size_history": list(scaler.history),
        "final_batch_size": scaler.max_batch_size,
        "itl_slo_met": sum(r.itl_met() for r in done),
    }


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-8b",
                    help="a ported architecture: llama-8b, granite-8b, olmo-1b, "
                         "phi3-mini-3.8b, yi-34b, llama-70b, qwen2-moe-a2.7b, "
                         "deepseek-moe-16b, internvl2-2b, mamba2-1.3b, "
                         "zamba2-2.7b, whisper-base")
    ap.add_argument("--requests", type=int, default=24)
    ap.add_argument("--max-slots", type=int, default=8)
    ap.add_argument("--max-len", type=int, default=160)
    ap.add_argument("--itl-slo", type=float, default=0.5)
    ap.add_argument("--full-config", action="store_true",
                    help="use the full config (GPU-scale)")
    ap.add_argument("--autoscale-every", type=int, default=5)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; fails without a GPU) or cpu")
    ap.add_argument("--dtype", default="float32",
                    choices=["float32", "bfloat16"])
    args = ap.parse_args(argv)

    cfg = get_config(args.arch) if args.full_config \
        else get_smoke_config(args.arch)
    print(f"serving {cfg.name} ({cfg.arch_type}), "
          f"{cfg.param_count()/1e6:.1f}M params on {args.device}")
    res = serve(cfg, requests=args.requests, max_slots=args.max_slots,
                max_len=args.max_len, itl_slo=args.itl_slo,
                autoscale_every=args.autoscale_every, device=args.device,
                dtype=getattr(torch, args.dtype))
    print(f"\nserved {res['n_finished']}/{len(res['requests'])} requests, "
          f"{res['tokens']} tokens in {res['wall_s']:.1f}s "
          f"({res['tokens_per_s']:.1f} tok/s), final batch size "
          f"{res['final_batch_size']}")
    print(f"ITL SLO met: {res['itl_slo_met']}/{res['n_finished']}")


if __name__ == "__main__":
    main()
