"""Dev-time kernel check of the port: each hand-written kernel against its
plain PyTorch version on the same inputs.

  PYTHONPATH=src python scripts/dev_kernels_torch.py [--device cpu]

On the GPU (the default; it fails without one) every call launches a CUDA
kernel (each wrapper's launch counter must move) and is held against the
plain version: ``paged_attention``, ``flash_prefill`` and its backward,
``ssd_scan`` (the FMA kernel over four chunks, the 3xTF32 kernel on one)
and its backward, all in float32. On the CPU the wrappers take the plain
versions themselves, so there only the chunked SSD against the sequential
recurrence says anything. The SSD state is 64 wide where the reference's
check takes 32: the kernels take N 16, 64 and 128.
"""
import argparse

import torch

from repro_torch.kernels import ops, ref
from repro_torch.kernels.flash_prefill import (flash_prefill_backward,
                                               flash_prefill_backward_plain)
from repro_torch.kernels.ssd_scan import ssd_scan_backward, ssd_scan_backward_plain

ap = argparse.ArgumentParser()
ap.add_argument("--device", default="cuda",
                help="cuda (default; fails without a GPU) or cpu")
args = ap.parse_args()
if args.device.startswith("cuda") and not torch.cuda.is_available():
    raise RuntimeError("dev_kernels_torch checks the CUDA kernels and no CUDA "
                       "device is available; pass --device cpu for the plain path")
dev = torch.device(args.device)
gen = torch.Generator(device=dev).manual_seed(0)


def randn(*shape):
    return torch.randn(shape, generator=gen, device=dev)


def launched(wrapper, fn):
    """``fn()`` and the launches ``wrapper`` counted during it."""
    wrapper.launches = 0
    out = fn()
    return out, wrapper.launches


def check(name, got, want, tol, launches=None):
    """``got`` within ``tol`` (times the largest value of ``want`` where that
    is above 1), leaf by leaf; on the card, a kernel call must have counted
    a launch (``launches`` is None for two plain versions)."""
    if dev.type == "cuda" and launches == 0:
        raise AssertionError(f"{name}: no kernel launch counted")
    if isinstance(got, torch.Tensor):
        got, want = [got], [want]
    err = 0.0
    for g, w in zip(got, want):
        if w is None:
            continue
        e = float((g - w).abs().max())
        assert e <= tol * max(1.0, float(w.abs().max())), (name, e)
        err = max(err, e)
    counted = "" if launches is None else f" ({launches} launches)"
    print(f"{name} ok {err:.3e}{counted}")


# paged attention
B, n_kv, group, D = 4, 2, 4, 128
page, max_pages, num_pages = 16, 8, 64
q = randn(B, n_kv, group, D)
kp, vp = randn(num_pages, page, n_kv, D), randn(num_pages, page, n_kv, D)
bt = torch.randint(0, num_pages, (B, max_pages), generator=gen, device=dev,
                   dtype=torch.int32)
lengths = torch.tensor([128, 37, 1, 100], dtype=torch.int32, device=dev)
out, n_launch = launched(ops.paged_attention,
                         lambda: ops.paged_attention(q, kp, vp, bt, lengths))
check("paged_attention", out, ref.paged_attention_ref(q, kp, vp, bt, lengths), 1e-4,
      n_launch)

# flash prefill and its backward
B, H, Hkv, S, D = 2, 4, 2, 512, 128
q, k, v = randn(B, H, S, D), randn(B, Hkv, S, D), randn(B, Hkv, S, D)
do = randn(B, H, S, D)
o, n_launch = launched(ops.flash_prefill, lambda: ops.flash_prefill(q, k, v))
check("flash_prefill", o, ref.flash_prefill_ref(q, k, v), 2e-4, n_launch)
grads, n_launch = launched(flash_prefill_backward,
                           lambda: flash_prefill_backward(q, k, v, o, do))
check("flash_prefill_backward", grads, flash_prefill_backward_plain(q, k, v, o, do),
      2e-4, n_launch)

# ssd scan: kernel vs chunked plain version vs sequential recurrence, then
# one chunk from a zero state (the 3xTF32 kernel on the card) and the backward
b, h, p, n = 2, 4, 64, 64
for s, chunk in ((256, 64), (64, 64)):
    x = randn(b, s, h, p)
    dt = torch.nn.functional.softplus(randn(b, s, h))
    A = -torch.exp(randn(h) * 0.5)
    Bm, Cm = randn(b, s, n), randn(b, s, n)
    y_r, h_r = ref.ssd_scan_ref(x, dt, A, Bm, Cm, chunk=chunk)
    check(f"ssd chunked plain vs sequential (s {s})", [y_r, h_r],
          ref.ssd_sequential_ref(x, dt, A, Bm, Cm), 1e-3)
    out, n_launch = launched(ops.ssd_scan,
                             lambda: ops.ssd_scan(x, dt, A, Bm, Cm, chunk=chunk))
    check(f"ssd_scan (s {s}, chunk {chunk})", out, [y_r, h_r], 2e-3, n_launch)
    dy = randn(b, s, h, p)
    grads, n_launch = launched(
        ssd_scan_backward, lambda: ssd_scan_backward(x, dt, A, Bm, Cm, None, dy,
                                                     chunk=chunk))
    check(f"ssd_scan_backward (s {s}, chunk {chunk})", grads,
          ssd_scan_backward_plain(x, dt, A, Bm, Cm, None, dy, None, chunk), 2e-3,
          n_launch)
print("ALL KERNELS OK")
