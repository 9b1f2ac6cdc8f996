"""One-card dry run: trace every (arch x input-shape) pair's step on the
meta device and report its roofline terms and whether its inputs fit the
card.

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi-34b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--out results.jsonl]

The counterpart of ``repro.launch.dryrun``, which lowers and compiles each
pair on a TPU mesh. Here each pair's step (``launch/steps.py``) runs once
on meta tensors: nothing is allocated on any device, as the reference's
lowering allocates nothing. A record holds the terms of
``launch/roofline.py`` (FLOPs counted, bytes from the formula there) and
``arg_bytes``: the parameters, plus the cache for decode, plus AdamW's
state and the batch for train (the prompt for prefill). ``fits`` compares
``arg_bytes`` with the card's 85.02e9 bytes. Activations are not counted
(``temp_bytes`` is None): nothing here plays the role of XLA's
``temp_size_in_bytes``.

Not ported: ``--unroll`` (``_layer_trips``) exists because XLA's cost
analysis counts a while-loop body once; eager PyTorch runs every layer, so
the count is whole. ``--multi-pod``, ``--mesh-shape`` and ``--zero-opt``
ask for a device mesh and raise ``NotImplementedError``
(``launch/mesh.py``). More than one pair is traced in ``MAX_JOBS``
processes (fewer on a host with fewer cores); the records and the printed
lines keep the pairs' order.
"""
from __future__ import annotations

import argparse
import json
import multiprocessing
import os
import sys
import time
import traceback
from concurrent.futures import ProcessPoolExecutor
from typing import Tuple

from repro_torch.configs import ASSIGNED_ARCHS, INPUT_SHAPES, get_config
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.roofline import CARD_BYTES, plan

# each worker process holds its own torch (~0.5 GB); four take --all from
# ~80 s to ~30 s on an 8-core host
MAX_JOBS = 4


def run_one(arch: str, shape_name: str, *, remat: bool = True,
            microbatch: int = 0) -> Tuple[dict, str]:
    """Trace one (arch x shape) step on the meta device; returns its record
    and the line that reports it."""
    rec = {"arch": arch, "shape": shape_name, "mesh": "1", "multi_pod": False,
           "status": "ok"}
    # repro-lint: ok(DET202, real trace timing)
    t0 = time.time()
    try:
        terms, mem = plan(get_config(arch), INPUT_SHAPES[shape_name], remat=remat,
                          microbatch=microbatch)
        # repro-lint: ok(DET202, real trace timing)
        total = time.time() - t0
        rec.update(total_s=round(total, 2), arg_bytes=mem["arg_bytes"],
                   out_bytes=mem["out_bytes"], temp_bytes=None,
                   fits=mem["arg_bytes"] <= CARD_BYTES, card_bytes=CARD_BYTES,
                   model_flops=terms.model_flops, step_time_s=terms.step_time_s,
                   **terms.as_dict())
        line = (f"[{arch} x {shape_name} @ 1 card] OK trace={rec['total_s']}s "
                f"args={mem['arg_bytes'] / 2**30:.2f}GiB fits={rec['fits']} "
                f"compute={terms.compute_s * 1e3:.2f}ms "
                f"memory={terms.memory_s * 1e3:.2f}ms "
                f"collective={terms.collective_s * 1e3:.2f}ms "
                f"bottleneck={terms.bottleneck} "
                f"useful={terms.useful_flops_ratio:.2f}")
    except Exception as e:  # a failure here is a fault of the port: surface it
        rec["status"] = "fail"
        rec["error"] = f"{type(e).__name__}: {e}"
        line = (f"[{arch} x {shape_name} @ 1 card] FAIL: {rec['error']}\n"
                + traceback.format_exc())
    return rec, line


def _run_pair(args):
    return run_one(*args[:2], remat=args[2], microbatch=args[3])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--no-remat", action="store_true")
    ap.add_argument("--out", default=None, help="append JSONL records here")
    ap.add_argument("--zero-opt", action="store_true")
    ap.add_argument("--microbatch", type=int, default=0)
    ap.add_argument("--mesh-shape", default=None,
                    help="a device mesh: not ported (raises)")
    args = ap.parse_args(argv)
    if not (args.all or (args.arch and args.shape)):
        ap.error("pass --arch & --shape, or --all")
    if args.multi_pod or args.mesh_shape or args.zero_opt:
        make_production_mesh(multi_pod=args.multi_pod)

    archs = [args.arch] if args.arch else ASSIGNED_ARCHS
    shapes = [args.shape] if args.shape else list(INPUT_SHAPES)
    pairs = [(a, s, not args.no_remat, args.microbatch) for a in archs for s in shapes]
    jobs = min(len(pairs), len(os.sched_getaffinity(0)), MAX_JOBS)
    if jobs > 1:
        ctx = multiprocessing.get_context("spawn")
        with ProcessPoolExecutor(jobs, mp_context=ctx) as pool:
            results = list(pool.map(_run_pair, pairs))
    else:
        results = map(_run_pair, pairs)

    failures = 0
    for rec, line in results:
        print(line, flush=True)
        failures += rec["status"] != "ok"
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(rec) + "\n")
    print(f"\n{len(pairs) - failures}/{len(pairs)} pairs traced on the meta device")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
