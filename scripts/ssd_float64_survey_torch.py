"""The float32 SSD kernels' error against float64 over many draws, on the GPU.

  PYTHONPATH=src python scripts/ssd_float64_survey_torch.py [--draws 8]

For each shape below, ``--draws`` input sets, each from a generator of its
own (seeded from the shape's index and the draw), go through ``ssd_scan``
and ``ssd_scan_backward`` in float32 (the kernel each wrapper's route names
for the shape) and through the plain versions in float32 and in float64.
Prints the card's name and power limit, then one JSON line a shape and direction: the route, and for each output
(y and the final state; dx, ddt, dA, dB, dC) the ratio, draw by draw, of
the kernel's largest error against float64 (over the largest float64 value)
to the plain float32 version's, and the draws beyond ``FACTOR``, the limit
``chip_smoke.py`` holds the tensor-core kernels to (its ``TF32_FACTOR``).
The inputs are ``chip_smoke.py``'s: x, B and C views into one conv output,
dt = softplus(normal), A = -linspace(1, 16), or A = -16 with dt ~ 1.
"""
import argparse
import json
import subprocess

import torch

from repro_torch.kernels import ssd_scan as ssd
from repro_torch.kernels.ssd_scan import (ssd_scan, ssd_scan_backward, ssd_scan_backward_plain,
                                          ssd_scan_plain)

FACTOR = 4.0
P, CHUNK = 64, 256
SHAPES = [  # (name, b, s, h, n, steep)
    ("mamba2-1.3b training", 8, 128, 64, 128, False),
    ("zamba2-2.7b training", 8, 128, 80, 64, False),
    ("s=256", 1, 256, 64, 128, False),
    ("A=-16, dt~1", 8, 128, 64, 128, True),
    ("s=1", 1, 1, 64, 128, False),
    ("s=2", 1, 2, 64, 128, False),
    ("s=3", 1, 3, 64, 128, False),
    ("s=4", 1, 4, 64, 128, False),
    ("s=8", 1, 8, 64, 128, False),
    ("s=16", 1, 16, 64, 128, False),
    ("s=32", 1, 32, 64, 128, False),
]


def inputs(gen, b, s, h, n, steep):
    conv = torch.randn((b, s, h * P + 2 * n), generator=gen, device="cuda")
    x = conv[..., :h * P].reshape(b, s, h, P)
    B, C = conv[..., h * P:h * P + n], conv[..., h * P + n:]
    raw = torch.randn((b, s, h), generator=gen, device="cuda")
    dt = 1.0 + 0.01 * raw if steep else torch.nn.functional.softplus(raw)
    A = torch.full((h,), -16.0, device="cuda") if steep else \
        -torch.linspace(1.0, 16.0, h, device="cuda")
    dy = torch.randn((b, s, h, P), generator=gen, device="cuda")
    return x, dt, A, B, C, dy


def rel(got, want) -> float:
    return float((got.double() - want).abs().max() / want.abs().max())


def ratios(got, plain, exact, names) -> dict:
    """Each named output's kernel error over the plain float32 version's,
    both against float64 (inf where only the plain version is exact);
    outputs that are zero in float64 are left out."""
    out = {}
    for nm, g, w, e in zip(names, got, plain, exact):
        if e is not None and bool(e.abs().max() > 0):
            err, plain_err = rel(g, e), rel(w, e)
            out[nm] = err / plain_err if plain_err > 0 else (float("inf") if err else 1.0)
    return out


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--draws", type=int, default=8)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("ssd_float64_survey_torch: no CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0], flush=True)
    n_sms = torch.cuda.get_device_properties(0).multi_processor_count
    for i, (name, b, s, h, n, steep) in enumerate(SHAPES):
        fwd, bwd = [], []
        for draw in range(args.draws):
            gen = torch.Generator(device="cuda")
            gen.manual_seed(1000 * i + draw)
            x, dt, A, B, C, dy = inputs(gen, b, s, h, n, steep)
            exact = [t.double() for t in (x, dt, A, B, C)]
            fwd.append(ratios(ssd_scan(x, dt, A, B, C, chunk=CHUNK),
                              ssd_scan_plain(x, dt, A, B, C, CHUNK),
                              ssd_scan_plain(*exact, CHUNK), ("y", "state")))
            got = ssd_scan_backward(x, dt, A, B, C, None, dy, chunk=CHUNK)
            plain = ssd_scan_backward_plain(x, dt, A, B, C, None, dy, None, CHUNK)
            want = ssd_scan_backward_plain(*exact, None, dy.double(), None, CHUNK)
            bwd.append(ratios(got[:5], plain[:5], want[:5], ("dx", "ddt", "dA", "dB", "dC")))
        routes = {"ssd_scan": ssd.forward_route(b, s, h, P, n, CHUNK, False, False, n_sms)[0],
                  "ssd_scan_backward": "tensor cores" if ssd.backward_route(
                      b, s, h, P, n, CHUNK, False, False, n_sms)[0] else "fma"}
        for kernel, rows in (("ssd_scan", fwd), ("ssd_scan_backward", bwd)):
            print(json.dumps({
                "kernel": kernel, "case": name, "shape": dict(b=b, s=s, h=h, p=P, n=n),
                "route": routes[kernel], "draws": args.draws,
                "ratio_max": {nm: max(r[nm] for r in rows) for nm in rows[0]},
                "draws_beyond_factor": {nm: sum(r[nm] > FACTOR for r in rows)
                                        for nm in rows[0]},
                "ratio_by_draw": rows}), flush=True)


if __name__ == "__main__":
    main()
