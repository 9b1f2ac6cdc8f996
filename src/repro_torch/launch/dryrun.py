"""Dry run: trace every (arch x input-shape) pair's step on the meta device
and report its roofline terms and whether its inputs fit a card, on one
card or one device of a mesh.

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi-34b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--out results.jsonl]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh-shape 16x16 [--zero-opt]

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

``--mesh-shape AxB[xC]`` (axes ``data``/``model``, or ``pod``/``data``/
``model``), ``--multi-pod`` (2 x 16 x 16) and ``--zero-opt`` (ZeRO-1
moments; on the 16 x 16 production mesh unless a mesh is named) place each
pair on a mesh of that shape by ``launch/shardings.py``, with no process and
no device (``launch/mesh.py``'s ``MeshShape``): ``arg_bytes`` and
``out_bytes`` are then one device's shards under the reference's specs,
``layout_extra_bytes`` what the rank layout of the Mamba2 leaves adds to
them (``params.ssm_layout``: B and C whole on every rank; on split heads,
a decode step's KV pool rounded up to whole pages a rank), ``fits``
compares their sum with the card, ``mesh`` names the shape, and the roofline terms are one device's
(``roofline.plan``); ``coll_bytes`` and ``collective_s`` are None
("unplanned" on the printed line) for a pair the port's sharded step does
not run. Not ported: ``--unroll`` (``_layer_trips``) exists
because XLA's cost analysis counts a while-loop body once; eager PyTorch
runs every layer, so the count is whole. More than one pair is traced in ``MAX_JOBS``
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
from typing import Optional, Tuple

from repro_torch.configs import ASSIGNED_ARCHS, INPUT_SHAPES, get_config
from repro_torch.launch.mesh import make_production_mesh, mesh_shape
from repro_torch.launch.roofline import CARD_BYTES, plan

# each worker process holds its own torch (~0.5 GB); four take --all from
# ~80 s to ~30 s on an 8-core host
MAX_JOBS = 4


def _ms(seconds: Optional[float]) -> str:
    return "unplanned" if seconds is None else f"{seconds * 1e3:.2f}ms"


def run_one(arch: str, shape_name: str, *, remat: bool = True,
            microbatch: int = 0, mesh: Optional[Tuple[int, ...]] = None,
            zero_opt: bool = False) -> Tuple[dict, str]:
    """Trace one (arch x shape) step on the meta device, on one card or, with
    ``mesh`` (its shape), on one device of that mesh; returns its record and
    the line that reports it."""
    where = "x".join(map(str, mesh)) if mesh else "1"
    rec = {"arch": arch, "shape": shape_name, "mesh": where,
           "multi_pod": bool(mesh) and len(mesh) == 3, "status": "ok"}
    # repro-lint: ok(DET202, real trace timing)
    t0 = time.time()
    try:
        terms, mem = plan(get_config(arch), INPUT_SHAPES[shape_name], remat=remat,
                          microbatch=microbatch,
                          mesh=mesh_shape(mesh) if mesh else None, zero_opt=zero_opt)
        # repro-lint: ok(DET202, real trace timing)
        total = time.time() - t0
        held = mem["arg_bytes"] + mem["layout_extra_bytes"]
        rec.update(total_s=round(total, 2), arg_bytes=mem["arg_bytes"],
                   layout_extra_bytes=mem["layout_extra_bytes"],
                   out_bytes=mem["out_bytes"], temp_bytes=None,
                   fits=held <= CARD_BYTES, card_bytes=CARD_BYTES,
                   model_flops=terms.model_flops, step_time_s=terms.step_time_s,
                   **terms.as_dict())
        line = (f"[{arch} x {shape_name} @ {where}] OK trace={rec['total_s']}s "
                f"args={mem['arg_bytes'] / 2**30:.2f}GiB"
                + (f"+{mem['layout_extra_bytes'] / 2**30:.3f}GiB(rank layout)"
                   if mem["layout_extra_bytes"] else "")
                + f" fits={rec['fits']} "
                f"compute={terms.compute_s * 1e3:.2f}ms "
                f"memory={terms.memory_s * 1e3:.2f}ms "
                f"collective={_ms(terms.collective_s)} "
                f"bottleneck={terms.bottleneck} "
                f"useful={terms.useful_flops_ratio:.2f}")
    except Exception as e:  # a failure here is a fault of the port: surface it
        rec["status"] = "fail"
        rec["error"] = f"{type(e).__name__}: {e}"
        line = (f"[{arch} x {shape_name} @ {where}] FAIL: {rec['error']}\n"
                + traceback.format_exc())
    return rec, line


def _run_pair(args):
    return run_one(*args[:2], remat=args[2], microbatch=args[3], mesh=args[4],
                   zero_opt=args[5])


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
                    help="one device of a mesh of this shape, e.g. 16x16 or 32x8")
    args = ap.parse_args(argv)
    if not (args.all or (args.arch and args.shape)):
        ap.error("pass --arch & --shape, or --all")
    mesh = None
    if args.mesh_shape:
        mesh = tuple(int(x) for x in args.mesh_shape.split("x"))
        if len(mesh) not in (2, 3):
            ap.error("--mesh-shape takes AxB or AxBxC")
    elif args.multi_pod or args.zero_opt:
        mesh = make_production_mesh(multi_pod=args.multi_pod).shape

    archs = [args.arch] if args.arch else ASSIGNED_ARCHS
    shapes = [args.shape] if args.shape else list(INPUT_SHAPES)
    pairs = [(a, s, not args.no_remat, args.microbatch, mesh, args.zero_opt)
             for a in archs for s in shapes]
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
    print(f"\n{len(pairs) - failures}/{len(pairs)} pairs traced on the meta device"
          + (f" for one device of a {'x'.join(map(str, mesh))} mesh" if mesh else ""))
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
