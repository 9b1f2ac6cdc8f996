#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from ``src/repro_torch/kernels/csrc`` with nvcc,
holds each against its plain PyTorch version on the card, checks that the
port's engine samples the same tokens on the card (kernels) and on the CPU
(plain versions) for the dense and the ssm family, and serves llama-8b and
mamba2-1.3b at full width (random bf16 weights from a seed) through
``repro_torch.launch.serve``'s loop, each path with the kernels' launch
counters set to 0 just before it and read just after. Every phase prints
JSON lines; any failure ends the run with a non-zero exit code. Without a
GPU it fails at once. A kernel's ``ms`` (and the plain version's and the
library call's) is device time: the own times of the kernels one call
launches, read with torch.profiler; ``call_ms`` beside it is CUDA events
around calls back to back, which the host's launch rate bounds from below. The last line of the output is
``{"ok": true, "device": {...}}``; the line with the per-kernel numbers
(``{"kernels": [...]}``) and the card's name and power limit come just
before it.

``--phases kernels,parity`` runs a subset (env and build always run); the
final ``ok`` line is printed only when every phase ran.

``--ab OTHER/src`` instead times the three kernels of another tree's port
(for example the parent commit's, unpacked with ``git archive``) and of this
checkout's at the serving path's shapes, in turns (other, this, this,
other), each turn in its own process with the kernels built from that
tree's sources, and prints one ``ab`` JSON line per (tree, turn, case), so
that two versions are compared on one card within one call.
"""
from __future__ import annotations

import argparse
import gc
import json
import os
import re
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))


def _port_src() -> str:
    """The ``src`` directory whose port this process imports: this
    checkout's, or, in an ``--ab`` turn, the tree given with ``--time-src``."""
    if "--time-src" in sys.argv:
        return os.path.abspath(sys.argv[sys.argv.index("--time-src") + 1])
    return os.path.join(HERE, "src")


sys.path.insert(0, _port_src())

import repro_torch.kernels.paged_attention as paged_module  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.flash_prefill import (flash_prefill,  # noqa: E402
                                               flash_prefill_plain)
from repro_torch.kernels.paged_attention import (paged_attention,  # noqa: E402
                                                 paged_attention_plain)
from repro_torch.kernels.ssd_scan import ssd_scan, ssd_scan_plain  # noqa: E402
from repro_torch.launch.serve import serve  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.serving.engine import Engine  # noqa: E402
from repro_torch.serving.request import make_batch, make_interactive  # noqa: E402

ALL_PHASES = ("kernels", "parity", "serve")

# NVIDIA H100 SXM data sheet, dense rates
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
# tolerances of the reference's kernel tests; the kernels keep the softmax
# weights in float32 where the plain versions round the output once, which
# is far inside the bfloat16 tolerance
TOL = {torch.float32: 2e-4, torch.bfloat16: 5e-2}
# the SSD scan sums over a chunk of up to 256 steps in another order than the
# plain version's einsums (the reference's own ssd tolerance in float32)
SSD_TOL = {torch.float32: 2e-3, torch.bfloat16: 5e-2}
KERNELS = {"paged_attention": paged_attention, "flash_prefill": flash_prefill,
           "ssd_scan": ssd_scan}
# the wrappers whose bf16 launches go to a tensor-core kernel, counted apart
TENSOR_CORE_KERNELS = ("flash_prefill", "ssd_scan")

KERNEL_INFO = {
    "paged_attention": {
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/paged_attention.cu",
        "replaces": "src/repro/kernels/paged_attention.py:107",
    },
    "flash_prefill": {
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_prefill.cu",
        "replaces": "src/repro/kernels/flash_prefill.py:85",
    },
    "ssd_scan": {
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/ssd_scan.cu",
        "replaces": "src/repro/kernels/ssd_scan.py:90",
    },
}


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def fail(message: str) -> None:
    print(f"chip_smoke: FAILED: {message}", file=sys.stderr, flush=True)
    sys.exit(1)


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean time of one call of ``fn()`` in ms by CUDA events around
    ``iters`` calls back to back after a warm-up: the device time where the
    device is the slower side, the host's enqueue time where the host is."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of one call of ``fn()`` in ms: the own times of every
    kernel the calls launched, from torch.profiler, over ``iters`` calls
    after a warm-up. Unlike ``time_ms`` it does not include the gaps in which
    the device waits for the host between calls. Now and then a profiler
    session returns no device events at all; such a session is run again,
    up to three times in all."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(warmup):
        fn()
    for _ in range(3):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        total_us = sum(_device_us(e) for e in prof.key_averages()
                       if e.device_type == DeviceType.CUDA)
        if total_us > 0:
            return total_us / iters / 1e3
    fail("the profiler saw no device time in three sessions: kernel times "
         "cannot be read")


def _device_us(event) -> float:
    return getattr(event, "self_device_time_total",
                   getattr(event, "self_cuda_time_total", 0.0))


def check_close(name: str, got: torch.Tensor, want: torch.Tensor, dtype,
                tols=TOL) -> float:
    """Max abs error; fails unless |got - want| <= tol + tol * |want|."""
    got, want = got.float(), want.float()
    if not torch.isfinite(got).all():
        fail(f"{name}: kernel output is not finite")
    err = (got - want).abs()
    tol = tols[dtype]
    if not bool((err <= tol + tol * want.abs()).all()):
        fail(f"{name}: max abs error {err.max().item():.3e} exceeds "
             f"tolerance {tol:g} (atol and rtol)")
    return err.max().item()


def bound(n_bytes: float, n_flops: float, dtype):
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = n_flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ------------------------------------------------------------------ phases
def phase_env() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    nvcc = subprocess.run([_build.find_nvcc(), "--version"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[-2:]
    emit("env", torch=torch.__version__, cuda_runtime=torch.version.cuda,
         nvcc=" | ".join(nvcc), gpu=torch.cuda.get_device_name(0),
         nvidia_smi=smi, python=sys.version.split()[0])
    return smi


def _demangle(names):
    """C++ names as the toolkit's ``cu++filt`` (or ``c++filt``) prints them;
    the mangled names where neither is installed."""
    tools = [os.path.join(os.path.dirname(_build.find_nvcc()), "cu++filt"),
             shutil.which("c++filt")]
    for tool in tools:
        if tool and os.access(tool, os.X_OK):
            out = subprocess.run([tool], input="\n".join(names), capture_output=True,
                                 text=True, check=True).stdout.splitlines()
            if len(out) == len(names):
                return out
    return list(names)


def ptxas_usage(text: str) -> list:
    """Each entry function of ``nvcc -Xptxas=-v`` output with its registers
    and spill bytes, from the "Compiling entry function", "Function
    properties for" and "Used N registers" lines ptxas prints per function."""
    spills, regs, order = {}, {}, []
    entry = props = None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            entry = m.group(1)
            order.append(entry)
            continue
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            props = m.group(1)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and props is not None:
            spills[props] = (int(m.group(1)), int(m.group(2)))
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and entry is not None:
            regs[entry] = int(m.group(1))

    def short(pretty):   # "ssd_scan_kernel<float, 128, 64>"
        pretty = re.sub(r"<unnamed>::|\(anonymous namespace\)::|\((?:unsigned )?\w+\)(?=-?\d)",
                        "", pretty)
        return pretty.removeprefix("void ").split("(")[0]

    return [{"kernel": short(pretty), "registers": regs.get(name),
             "spill_stores": spills.get(name, (0, 0))[0],
             "spill_loads": spills.get(name, (0, 0))[1]}
            for name, pretty in zip(order, _demangle(order))]


# the bf16 instantiations on the llama-8b and mamba2-1.3b serving paths, which
# must not spill
SERVING_INSTANCES = ("flash_prefill_kernel_wgmma<128>",
                     "paged_attention_kernel<__nv_bfloat16, 128, 4, 8>",
                     "ssd_scan_kernel_wgmma<128>")


def phase_build() -> None:
    t0 = time.monotonic()
    out = _build.build_all(extra_flags=("-Xptxas=-v",))
    usage = {}
    serving = {}
    for name, text in out.items():
        kernels = ptxas_usage(text)
        usage[name] = {
            "max_registers": max((k["registers"] or 0 for k in kernels), default=None),
            "kernels": len(kernels),
            "spilling": [k for k in kernels if k["spill_stores"] or k["spill_loads"]]}
        serving.update({k["kernel"]: k for k in kernels
                        if k["kernel"] in SERVING_INSTANCES})
    emit("build", seconds=round(time.monotonic() - t0, 2),
         flags=" ".join(_build.NVCC_FLAGS), ptxas=usage,
         serving_instances=list(serving.values()))
    for inst in SERVING_INSTANCES:
        k = serving.get(inst)
        if k is None or k["spill_stores"] or k["spill_loads"]:
            fail(f"build: serving instantiation {inst} missing or spilling: {k}")


def _paged_case(gen, dtype, B, n_kv, group, D, lengths, pages_per_seq, copies=1):
    """Random q, ``copies`` pools and one shuffled block table on the card."""
    dev = "cuda"
    num_pages = B * pages_per_seq
    q = torch.randn((B, n_kv, group, D), generator=gen, device=dev).to(dtype)
    pools = [(torch.randn((num_pages, 16, n_kv, D), generator=gen, device=dev).to(dtype),
              torch.randn((num_pages, 16, n_kv, D), generator=gen, device=dev).to(dtype))
             for _ in range(copies)]
    perm = torch.randperm(num_pages, generator=gen, device=dev)
    bt = perm.reshape(B, pages_per_seq).to(torch.int32).contiguous()
    ln = torch.tensor(lengths, dtype=torch.int32, device=dev)
    return q, pools, bt, ln


def _paged_timed(gen, F, dtype, B, n_kv, group, D, pps, case, lengths) -> dict:
    """One timed ``paged_attention`` case against its plain version; returns
    its record for the kernels line (without the launch count)."""
    # pools rotate so that, as between the layers of a model, a launch does
    # not find its K/V in the 50 MB L2 from the launch before
    q, pools, bt, ln = _paged_case(gen, dtype, B, n_kv, group, D, lengths, pps,
                                   copies=4)
    out = paged_attention(q, *pools[0], bt, ln)
    torch.cuda.synchronize()
    want = paged_attention_plain(q, *pools[0], bt, ln)
    err = check_close(f"paged_attention {dtype} {case}", out, want, dtype)
    for b, n in enumerate(lengths):
        if n == 0 and out[b].abs().max().item() != 0.0:
            fail("paged_attention: a sequence of length 0 must give zeros")
    turn = [0]

    def rotate(fn):
        turn[0] = (turn[0] + 1) % len(pools)
        fn(q, *pools[turn[0]], bt, ln)

    ms = device_ms(lambda: rotate(paged_attention))
    call_ms = time_ms(lambda: rotate(paged_attention))
    # after ~50 launches the merge's ticket counters must still start at 0
    again = paged_attention(q, *pools[0], bt, ln)
    torch.cuda.synchronize()
    err = max(err, check_close(f"paged_attention {dtype} {case}, after the timed calls",
                               again, want, dtype))
    plain_ms = device_ms(lambda: rotate(paged_attention_plain), iters=5, warmup=1)
    # one library call on the same work: dense gathered K/V and a mask
    idx = bt.long()
    kd = pools[0][0][idx].reshape(B, pps * 16, n_kv, D).permute(0, 2, 1, 3)
    vd = pools[0][1][idx].reshape(B, pps * 16, n_kv, D).permute(0, 2, 1, 3)
    kd = kd.repeat_interleave(group, dim=1).contiguous()
    vd = vd.repeat_interleave(group, dim=1).contiguous()
    qd = q.reshape(B, n_kv * group, 1, D)
    mask = (torch.arange(pps * 16, device="cuda")[None, :] < ln[:, None])
    mask = mask[:, None, None, :]
    library_ms = device_ms(lambda: F.scaled_dot_product_attention(
        qd, kd, vd, attn_mask=mask))
    es = q.element_size()
    tokens = sum(lengths)
    n_bytes = (2 * tokens * n_kv * D + 2 * q.numel()) * es + \
        4 * (sum(-(-n // 16) for n in lengths) + B)
    b_ms, b_by = bound(n_bytes, 4.0 * tokens * n_kv * group * D, dtype)
    plan = paged_module.split_plan(B, n_kv, group, D, pps)
    emit("kernels", kernel="paged_attention", dtype=str(dtype), case=case,
         shape=dict(B=B, n_kv=n_kv, group=group, D=D, page=16, lengths=lengths,
                    max_pages=pps, block_tables="shuffled"),
         n_splits=plan.n_splits, pages_per_split=paged_module.PAGES_PER_SPLIT,
         tolerance=TOL[dtype], max_abs_err=err, time_ms=ms, call_ms=call_ms,
         bound_ms=b_ms, bound_by=b_by, plain_ms=plain_ms, library_ms=library_ms)
    return {"name": "paged_attention", **KERNEL_INFO["paged_attention"],
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": library_ms}


def _paged_garbage(gen, dtype, B, n_kv, group, D, lengths, pps) -> None:
    """``paged_attention`` with the table entries past each sequence's pages
    set to 2**30 (never dereferenced), against the plain version on a clean
    table; checks that the plan has the splits the lengths leave empty."""
    q, pools, bt, ln = _paged_case(gen, dtype, B, n_kv, group, D, lengths, pps)
    safe = bt.clone()
    for b, n in enumerate(lengths):
        bt[b, -(-n // 16):] = 2 ** 30
    out = paged_attention(q, *pools[0], bt, ln)
    torch.cuda.synchronize()
    err = check_close(f"paged_attention {dtype} B={B} group={group} D={D} garbage",
                      out, paged_attention_plain(q, *pools[0], safe, ln), dtype)
    for b, n in enumerate(lengths):
        if n == 0 and out[b].abs().max().item() != 0.0:
            fail("paged_attention: a sequence of length 0 must give zeros")
    plan = paged_module.split_plan(B, n_kv, group, D, pps)
    empty = sum(max(0, plan.n_splits - -(-n // (16 * paged_module.PAGES_PER_SPLIT)))
                for n in lengths)
    emit("kernels", kernel="paged_attention", dtype=str(dtype),
         shape=dict(B=B, n_kv=n_kv, group=group, D=D, lengths=lengths, max_pages=pps,
                    block_tables="garbage past each sequence's pages"),
         n_splits=plan.n_splits, empty_splits=empty, tolerance=TOL[dtype],
         max_abs_err=err)


def _flash_inputs(gen, dtype, B, S, T, H, Hkv, D):
    """Random q (B,H,S,D) and k, v (B,Hkv,T,D) on the card, as transposed
    views of (B,S,H,D) tensors, as the model passes them."""
    q = torch.randn((B, S, H, D), generator=gen, device="cuda").to(dtype)
    k = torch.randn((B, T, Hkv, D), generator=gen, device="cuda").to(dtype)
    v = torch.randn((B, T, Hkv, D), generator=gen, device="cuda").to(dtype)
    return tuple(t.transpose(1, 2) for t in (q, k, v))


def phase_kernels(gen) -> dict:
    """Each kernel against its plain version; returns the per-kernel record
    of the main path's shapes in bf16 (without the launch counts)."""
    records = {}
    F = torch.nn.functional

    # ---- paged_attention: the serving instance's decode shapes (8 slots,
    # max_len 1024 = 64 pages): long contexts up to the limit, and the
    # contexts of 64-400 tokens the serve phase's decode steps see
    B, n_kv, group, D, pps = 8, 8, 4, 128, 64
    paged_cases = [  # lengths: 0, 1, and not multiples of 16
        ("long context", [1024, 0, 1000, 517, 16, 1, 333, 768]),
        ("serve contexts", [64, 400, 120, 257, 333, 96, 201, 310]),
    ]
    for dtype in (torch.bfloat16, torch.float32):
        for case, lengths in paged_cases:
            rec = _paged_timed(gen, F, dtype, B, n_kv, group, D, pps, case, lengths)
            if dtype == torch.bfloat16 and case == "long context":
                records["paged_attention"] = rec

    # a narrow case: D = 64, group = 8, a table with unused (garbage) entries
    _paged_garbage(gen, torch.float32, 3, 2, 8, 64, [40, 7, 0], 4)
    # several splits, some of them empty (length 0, 17 and 300 of 40 pages)
    _paged_garbage(gen, torch.bfloat16, 4, 2, 8, 64, [300, 0, 17, 600], 40)
    _paged_garbage(gen, torch.float32, 4, 2, 1, 128, [300, 257, 256, 1], 48)

    # ---- flash_prefill: a single 64 x 64 tile first (the swizzle of the TMA
    # boxes and of the wgmma descriptors must agree), then one prompt at a
    # time, (B,S,H,D) tensors as strided views
    for D in (64, 128):
        for causal in (False, True):
            qt, kt, vt = _flash_inputs(gen, torch.bfloat16, 1, 64, 64, 1, 1, D)
            out = flash_prefill(qt, kt, vt, causal=causal)
            torch.cuda.synchronize()
            err = check_close(f"flash_prefill single tile D={D} causal={causal}", out,
                              flash_prefill_plain(qt, kt, vt, causal=causal),
                              torch.bfloat16)
            emit("kernels", kernel="flash_prefill", dtype="torch.bfloat16",
                 case="single 64x64 tile", shape=dict(B=1, H=1, Hkv=1, D=D, S=64, T=64,
                                                      causal=causal),
                 tolerance=TOL[torch.bfloat16], max_abs_err=err)

    H, Hkv, D = 32, 8, 128
    cases = [  # (S, q_offset, causal); 341 is the longest prompt `serve` admits
        (53, 0, True), (341, 0, True), (512, 0, True), (682, 0, True),
        (200, 312, True), (300, 0, False)]
    for dtype in (torch.bfloat16, torch.float32):
        for S, q_offset, causal in cases:
            T = q_offset + S if causal else S
            qt, kt, vt = _flash_inputs(gen, dtype, 1, S, T, H, Hkv, D)
            kw = dict(causal=causal, q_offset=q_offset if causal else 0)
            out = flash_prefill(qt, kt, vt, **kw)
            torch.cuda.synchronize()
            want = flash_prefill_plain(qt, kt, vt, **kw)
            err = check_close(f"flash_prefill {dtype} S={S} off={q_offset} "
                              f"causal={causal}", out, want, dtype)
            ms = device_ms(lambda: flash_prefill(qt, kt, vt, **kw))
            call_ms = time_ms(lambda: flash_prefill(qt, kt, vt, **kw))
            plain_ms = device_ms(lambda: flash_prefill_plain(qt, kt, vt, **kw),
                                 iters=5, warmup=1)
            library_ms = None
            if q_offset == 0:
                ke = kt.repeat_interleave(H // Hkv, dim=1)
                ve = vt.repeat_interleave(H // Hkv, dim=1)
                library_ms = device_ms(lambda: F.scaled_dot_product_attention(
                    qt, ke, ve, is_causal=causal))
            seen = sum(q_offset + i + 1 for i in range(S)) if causal else S * T
            es = qt.element_size()
            b_ms, b_by = bound((2 * qt.numel() + kt.numel() + vt.numel()) * es,
                               4.0 * H * D * seen, dtype)
            emit("kernels", kernel="flash_prefill", dtype=str(dtype),
                 route="wgmma + TMA" if dtype == torch.bfloat16 else "fp32 FMA",
                 shape=dict(B=1, H=H, Hkv=Hkv, D=D, S=S, T=T, q_offset=q_offset,
                            causal=causal),
                 tolerance=TOL[dtype], max_abs_err=err, time_ms=ms, call_ms=call_ms,
                 bound_ms=b_ms, bound_by=b_by, plain_ms=plain_ms, library_ms=library_ms)
            if dtype == torch.bfloat16 and (S, q_offset, causal) == (341, 0, True):
                records["flash_prefill"] = {
                    "name": "flash_prefill", **KERNEL_INFO["flash_prefill"],
                    "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                    "bound_ms": b_ms, "bound_by": b_by, "library_ms": library_ms}

    # narrow head_dim, a ragged prompt and a batch of two
    for dtype in (torch.bfloat16, torch.float32):
        qt, kt, vt = _flash_inputs(gen, dtype, 2, 75, 75, 4, 2, 64)
        out = flash_prefill(qt, kt, vt)
        torch.cuda.synchronize()
        err = check_close(f"flash_prefill {dtype} D=64 B=2", out,
                          flash_prefill_plain(qt, kt, vt), dtype)
        emit("kernels", kernel="flash_prefill", dtype=str(dtype),
             shape=dict(B=2, H=4, Hkv=2, D=64, S=75), tolerance=TOL[dtype],
             max_abs_err=err)

    records["ssd_scan"] = _ssd_scan_cases(gen)
    return records


def _ssd_case(gen, dtype, b, s, h, p, n, *, h0=False, steep=False, copies=1,
              strided=False):
    """``copies`` sets of random SSD inputs on the card. The decay rates are
    the model's, A = -linspace(1, 16); ``steep`` puts every head at A = -16
    with dt near 1, where an unmasked exponent overflows. ``strided`` makes
    x, B and C views into one (b, s, h p + 2 n) tensor, as ``mamba_forward``
    slices them out of the conv output."""
    dev = "cuda"

    def one():
        if strided:
            conv = torch.randn((b, s, h * p + 2 * n), generator=gen, device=dev).to(dtype)
            x = conv[..., :h * p].reshape(b, s, h, p)
            B, C = conv[..., h * p:h * p + n], conv[..., h * p + n:]
        else:
            x = torch.randn((b, s, h, p), generator=gen, device=dev).to(dtype)
            B = torch.randn((b, s, n), generator=gen, device=dev).to(dtype)
            C = torch.randn((b, s, n), generator=gen, device=dev).to(dtype)
        raw = torch.randn((b, s, h), generator=gen, device=dev)
        dt = 1.0 + 0.01 * raw if steep else torch.nn.functional.softplus(raw)
        return x, dt, B, C

    A = torch.full((h,), -16.0, device=dev) if steep else \
        -torch.linspace(1.0, 16.0, h, device=dev)
    state = torch.randn((b, h, p, n), generator=gen, device=dev) if h0 else None
    return [one() for _ in range(copies)], A, state


def _ssd_flops(b, s, h, p, n, chunk) -> float:
    """Operations the scan needs on these inputs, from a zero initial state:
    per chunk of L valid steps, C B^T over its L (L + 1) / 2 causal pairs
    once per sequence (it does not depend on the head), and per head
    (C B^T o L) x over the same pairs, x^T B for the state and, after the
    first chunk, C h^T."""
    flops = 0.0
    for t0 in range(0, s, chunk):
        L = min(chunk, s - t0)
        pairs = L * (L + 1) // 2
        flops += b * 2.0 * pairs * n
        flops += b * h * (2.0 * pairs * p + 2.0 * L * p * n)
        if t0 > 0:
            flops += b * h * 2.0 * L * p * n
    return flops


def _ssd_scan_cases(gen) -> dict:
    """``ssd_scan`` against ``ssd_scan_plain`` (y and the final state) at the
    serving path's shape and around it; returns the record of the main shape
    in bf16. At the serving widths x, B and C are strided views, as the
    model passes them."""
    record = None
    cases = [  # (name, b, s, h, p, n, chunk, h0, steep); s = 341: the longest prompt
        ("main", 1, 341, 64, 64, 128, 256, False, False),
        ("s512", 1, 512, 64, 64, 128, 256, False, False),
        # eight chunks of state carried from chunk to chunk
        ("s2048", 1, 2048, 64, 64, 128, 256, False, False),
        # the carried-state product from the first chunk on
        ("h0", 1, 341, 64, 64, 128, 256, True, False),
        ("s=1", 1, 1, 64, 64, 128, 256, False, False),
        ("s=257", 1, 257, 64, 64, 128, 256, False, False),
        ("smoke widths, h0", 2, 100, 8, 32, 16, 32, True, False),
        ("A=-16, dt~1", 1, 341, 64, 64, 128, 256, False, True),
    ]
    for dtype in (torch.bfloat16, torch.float32):
        for name, b, s, h, p, n, chunk, with_h0, steep in cases:
            timed = name in ("main", "s512", "s2048")
            sets, A, h0 = _ssd_case(gen, dtype, b, s, h, p, n, h0=with_h0,
                                    steep=steep, copies=4 if timed else 1,
                                    strided=h == 64)
            x, dt, B, C = sets[0]
            y, state = ssd_scan(x, dt, A, B, C, h0, chunk=chunk)
            torch.cuda.synchronize()
            want_y, want_state = ssd_scan_plain(x, dt, A, B, C, chunk, h0=h0)
            label = f"ssd_scan {dtype} {name}"
            err = max(check_close(f"{label} y", y, want_y, dtype, SSD_TOL),
                      check_close(f"{label} state", state, want_state, dtype, SSD_TOL))
            if not (torch.isfinite(want_y).all() and torch.isfinite(want_state).all()):
                fail(f"{label}: the plain version is not finite")
            rec = dict(kernel="ssd_scan", dtype=str(dtype), case=name,
                       route="wgmma + TMA" if dtype == torch.bfloat16 else "fp32 FMA",
                       shape=dict(b=b, s=s, h=h, p=p, n=n, chunk=chunk, h0=with_h0,
                                  strided=h == 64),
                       tolerance=SSD_TOL[dtype], max_abs_err=err)
            if timed:
                # input sets rotate, as the paged case's pools do
                turn = [0]

                def run(fn):
                    turn[0] = (turn[0] + 1) % len(sets)
                    fn(*sets[turn[0]])

                def kernel():
                    run(lambda x_, dt_, B_, C_: ssd_scan(x_, dt_, A, B_, C_, chunk=chunk))

                ms = device_ms(kernel)
                call_ms = time_ms(kernel)
                plain_ms = device_ms(lambda: run(lambda x_, dt_, B_, C_: ssd_scan_plain(
                    x_, dt_, A, B_, C_, chunk)), iters=5, warmup=1)
                es = x.element_size()
                n_bytes = (x.numel() + B.numel() + C.numel()) * es + dt.numel() * 4 + \
                    y.numel() * es + state.numel() * 4
                b_ms, b_by = bound(n_bytes, _ssd_flops(b, s, h, p, n, chunk),
                                   dtype)
                # no single PyTorch call computes an SSD scan: no library time
                rec.update(time_ms=ms, call_ms=call_ms, bound_ms=b_ms, bound_by=b_by,
                           plain_ms=plain_ms, library_ms=None)
                if dtype == torch.bfloat16 and name == "main":
                    record = {"name": "ssd_scan", **KERNEL_INFO["ssd_scan"],
                              "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                              "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}
            emit("kernels", **rec)
    return record


def _parity_run(cfg, params, device, prompts):
    """Serve ``prompts`` (interactive and batch, with one preemption) and
    return every slot's next token after every step."""
    eng = Engine(cfg, params=params, max_slots=3, max_len=96,
                 dtype=torch.float32, device=device)
    trace = []
    reqs = []
    for i, toks in enumerate(prompts):
        make = make_batch if i < 3 else make_interactive
        r = make(len(toks), 10 + 3 * i)
        r.prompt_tokens = toks
        reqs.append(r)
    for r in reqs[:3]:
        eng.submit(r)
    step = 0
    while (eng.waiting or eng.n_active) and step < 400:
        if step == 3:
            for r in reqs[3:]:
                eng.submit(r)        # interactive arrivals preempt a batch request
        stats = eng.step()
        for victim in stats.preempted:
            eng.submit(victim)
        trace.append([s.token for s in eng.slots])
        step += 1
    if any(r.state.value != "finished" for r in reqs):
        fail(f"parity: not every request finished on {device}")
    return trace, sum(r.preemptions for r in reqs)


def _parity(cfg, label: str, prompt_lens, kernels) -> None:
    """Serve the same prompts with the same float32 parameters on the card
    and on the CPU: every slot's next token must agree after every step,
    through a preempt-and-restore cycle, and the card's run must have
    launched each of ``kernels``."""
    gen = torch.Generator(device="cpu")
    gen.manual_seed(1)
    params_cpu = Model(cfg).init(gen, dtype=torch.float32, device="cpu")

    def to_cuda(tree):
        return {k: to_cuda(v) if isinstance(v, dict) else v.cuda()
                for k, v in tree.items()}

    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, cfg.vocab_size, size=(n,), dtype=np.int32)
               for n in prompt_lens]
    before = {name: KERNELS[name].launches for name in kernels}
    gpu_trace, gpu_preempt = _parity_run(cfg, to_cuda(params_cpu), "cuda", prompts)
    launched = {name: KERNELS[name].launches - before[name] for name in kernels}
    cpu_trace, cpu_preempt = _parity_run(cfg, params_cpu, "cpu", prompts)
    if min(launched.values()) == 0:
        fail(f"parity ({label}): the engine on the card did not launch "
             f"{', '.join(kernels)}: {launched}")
    if gpu_trace != cpu_trace:
        first = next(i for i, (a, b) in enumerate(zip(gpu_trace, cpu_trace)) if a != b)
        fail(f"parity ({label}): tokens differ at step {first}: card "
             f"{gpu_trace[first]}, cpu {cpu_trace[first]}")
    if gpu_preempt < 1 or gpu_preempt != cpu_preempt:
        fail(f"parity ({label}): the run was meant to go through a "
             "preempt-and-restore cycle")
    emit("parity", config=label, prompt_lens=list(prompt_lens), steps=len(gpu_trace),
         preemptions=gpu_preempt, allow_tf32=False, tokens_agree=True,
         kernel_launches=launched)


def phase_parity() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _parity(get_smoke_config("llama-8b").with_(head_dim=64),
            "llama-8b smoke, head_dim=64, float32", (9, 23, 17, 30, 5),
            ("paged_attention", "flash_prefill"))
    # one prompt over three chunks of 32 (the state carried between chunks),
    # one shorter than the conv window
    _parity(get_smoke_config("mamba2-1.3b"), "mamba2-1.3b smoke, float32",
            (9, 70, 17, 30, 2), ("ssd_scan",))


def _profiled(fn, reps: int) -> dict:
    """Run ``fn`` ``reps`` times under torch.profiler and return, per run,
    the device-busy time (sum of the kernels' own times), the number of
    kernel launches and the busiest kernels. Profiling slows the host, so
    wall times are taken in a separate, unprofiled window."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()

    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    top = sorted(((e.key, _device_us(e) / reps / 1e3) for e in kernels),
                 key=lambda kv: -kv[1])
    own = ("paged_attention_", "flash_prefill_kernel", "ssd_scan_kernel")
    return {"device_ms": sum(ms for _, ms in top),
            "launches": sum(e.count for e in kernels) / reps,
            "own_kernels_ms": {k.split("<")[0].split("::")[-1]: round(ms, 4)
                               for k, ms in top if any(o in k for o in own)},
            "top_ms": [[k[:60], round(ms, 4)] for k, ms in top[:6]]}


def _wall_ms(fn, reps: int) -> float:
    torch.cuda.synchronize()
    t0 = time.monotonic()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.monotonic() - t0) * 1e3 / reps


def _where_the_time_goes(eng, steps: int = 8, prompt: int = 337) -> dict:
    """Host (wall) time beside device-busy time of one decode step at a full
    slot pool and of one prefill: how far the eager host code holds the card
    back. ``prompt`` is a length near the longest the serve phase admits
    (341) that its run has most likely not seen, so the first call shows what
    a new prompt length costs on top of the steady time."""
    for _ in range(eng.max_slots):
        eng.submit(make_interactive(64, 2 * steps + 8))
    eng.set_max_batch_size(eng.max_slots)
    for _ in range(3):
        eng.step()
    out = {"decode_wall_ms_per_step": _wall_ms(eng.step, steps)}
    prof = _profiled(eng.step, steps)
    while eng.waiting or eng.n_active:
        eng.step()

    toks = torch.randint(0, eng.cfg.vocab_size, (1, prompt), device=eng.device)

    @torch.no_grad()
    def prefill():
        eng.model.prefill(eng.params, {"tokens": toks}, dtype=eng.dtype)

    out["prefill_tokens"] = prompt
    out["prefill_first_call_wall_ms"] = _wall_ms(prefill, 1)
    out["prefill_wall_ms"] = _wall_ms(prefill, 3)
    pre = _profiled(prefill, 2)
    if not prof["device_ms"]:      # the profiler saw no device activity here
        return {**out, "decode_device_ms_per_step": None}
    for name, p in (("decode", prof), ("prefill", pre)):
        unit = "_per_step" if name == "decode" else ""
        out[f"{name}_device_ms{unit}"] = p["device_ms"]
        out[f"{name}_launches{unit}"] = p["launches"]
        out[f"{name}_own_kernels_ms{unit}"] = p["own_kernels_ms"]
        out[f"{name}_top_device_ms{unit}"] = p["top_ms"]
    out["decode_device_idle_share"] = \
        1.0 - prof["device_ms"] / out["decode_wall_ms_per_step"]
    out["prefill_device_idle_share"] = 1.0 - pre["device_ms"] / out["prefill_wall_ms"]
    return out


def _serve_path(smi: str, arch: str, per_layer) -> dict:
    """Serve ``arch`` at full width through ``launch.serve``'s loop with
    every kernel's launch counter set to 0 just before and read just after;
    ``per_layer(res)`` gives, for each kernel of this path, how many runs of
    one layer the serve run made (launches = that x the layer count)."""
    gc.collect()
    torch.cuda.empty_cache()
    cfg = get_config(arch)
    n_requests, max_output = 24, 64
    torch.cuda.reset_peak_memory_stats()
    for kernel in KERNELS.values():
        kernel.launches = 0
    for kernel in TENSOR_CORE_KERNELS:
        KERNELS[kernel].tensor_core_launches = 0
    t0 = time.monotonic()
    res = serve(cfg, requests=n_requests, max_slots=8, max_len=1024,
                dtype=torch.bfloat16, device="cuda",
                max_output=max_output, verbose=False)
    launches = {name: kernel.launches for name, kernel in KERNELS.items()}
    tensor_core_launches = {name: KERNELS[name].tensor_core_launches
                            for name in TENSOR_CORE_KERNELS}
    total_s = time.monotonic() - t0
    eng = res["engine"]
    if res["n_finished"] != n_requests:
        fail(f"serve {arch}: {res['n_finished']} of {n_requests} requests finished")
    want = {name: runs * cfg.n_layers for name, runs in per_layer(res).items()}
    got = {name: launches[name] for name in want}
    if got != want or min(got.values()) == 0:
        fail(f"serve {arch}: kernel launches {launches}, the run implies {want}")
    # bf16 prefills must go through the tensor-core kernels, every one of them
    for name, n in tensor_core_launches.items():
        if n != launches[name]:
            fail(f"serve {arch}: {launches[name]} {name} launches, {n} of them on "
                 "the tensor-core kernel")

    def leaves(tree):
        for v in tree.values():
            yield from leaves(v) if isinstance(v, dict) else [v]

    if any(t.device.type != "cuda" for t in [*leaves(eng.params), *leaves(eng.pool)]):
        fail(f"serve {arch}: a parameter or pool tensor lives on the CPU")
    for r in res["requests"]:
        if r.tokens_generated < min(r.output_len, 1) or r.first_token_time is None:
            fail(f"serve {arch}: a finished request generated no token")
    itl = np.asarray(res["itl_s"])
    ttft = np.asarray(res["ttft_s"])
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    share = _where_the_time_goes(eng)
    emit("serve", gpu=smi, model=cfg.name, n_layers=cfg.n_layers, d_model=cfg.d_model,
         vocab=cfg.vocab_size, dtype="bfloat16", params=cfg.param_count(),
         requests=n_requests, max_output=max_output, max_slots=8, max_len=1024,
         finished=res["n_finished"], tokens=res["tokens"],
         serve_loop_s=res["wall_s"], with_weight_init_s=total_s,
         tokens_per_s=res["tokens_per_s"], decode_steps=res["decode_steps"],
         prefills=res["prefills"], itl_mean_ms=float(itl.mean() * 1e3),
         itl_p50_ms=float(np.percentile(itl, 50) * 1e3),
         itl_p99_ms=float(np.percentile(itl, 99) * 1e3),
         ttft_mean_ms=float(ttft.mean() * 1e3),
         preemptions=sum(r.preemptions for r in res["requests"]),
         batch_size_history=res["batch_size_history"],
         peak_device_memory_gb=peak_gb, kernel_launches=launches,
         tensor_core_launches=tensor_core_launches, **share)
    return got


def phase_serve(smi: str) -> dict:
    """Both serving paths; returns each kernel's launches on its own path."""
    launches = _serve_path(smi, "llama-8b", lambda res: {
        "paged_attention": res["decode_steps"], "flash_prefill": res["prefills"]})
    launches.update(_serve_path(smi, "mamba2-1.3b", lambda res: {
        "ssd_scan": res["prefills"]}))
    return launches


# ------------------------------------------------- two trees, in turns
def ab_turn(src: str, turn: int) -> None:
    """One ``--ab`` turn: device and event times of the kernels of the port
    this process imported (``src``), built from that tree's sources, at the
    serving path's shapes in bf16, on the same inputs in every turn. Uses only
    the wrappers' signatures, which every slice of the port keeps."""
    _build.build_all()
    dev, bf16 = "cuda", torch.bfloat16
    gen = torch.Generator(device=dev)

    def emit_ab(kernel, case, fn):
        emit("ab", src=src, turn=turn, kernel=kernel, case=case,
             device_ms=device_ms(fn), call_ms=time_ms(fn),
             gpu=torch.cuda.get_device_name(0))

    for case, lengths in (("long context", [1024, 0, 1000, 517, 16, 1, 333, 768]),
                          ("serve contexts", [64, 400, 120, 257, 333, 96, 201, 310])):
        gen.manual_seed(1)
        q, pools, bt, ln = _paged_case(gen, bf16, 8, 8, 4, 128, lengths, 64, copies=4)
        rot = [0]

        def paged():
            rot[0] = (rot[0] + 1) % len(pools)
            paged_attention(q, *pools[rot[0]], bt, ln)
        emit_ab("paged_attention", case, paged)

    for S, q_offset in ((341, 0), (512, 0), (682, 0), (200, 312)):
        gen.manual_seed(2)
        qt, kt, vt = _flash_inputs(gen, bf16, 1, S, S + q_offset, 32, 8, 128)
        emit_ab("flash_prefill", f"S={S} q_offset={q_offset} causal",
                lambda: flash_prefill(qt, kt, vt, causal=True, q_offset=q_offset))

    # input sets rotate, as in the kernels phase
    for s in (341, 2048):
        gen.manual_seed(3)
        sets, A, _ = _ssd_case(gen, bf16, 1, s, 64, 64, 128, copies=4, strided=True)
        rot = [0]

        def ssd():
            rot[0] = (rot[0] + 1) % len(sets)
            x, dt, Bm, Cm = sets[rot[0]]
            ssd_scan(x, dt, A, Bm, Cm, chunk=256)
        emit_ab("ssd_scan", f"s={s}", ssd)


def ab(other_src: str) -> None:
    """Times ``other_src``'s kernels and this checkout's in turns (other,
    this, this, other), one process per turn."""
    trees = [os.path.abspath(other_src), os.path.join(HERE, "src")]
    for turn, src in enumerate(trees + trees[::-1]):
        subprocess.run([sys.executable, os.path.abspath(__file__), "--time-src", src,
                        "--turn", str(turn)], check=True)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--phases", default=",".join(ALL_PHASES),
                    help="comma-separated subset of: " + ", ".join(ALL_PHASES))
    ap.add_argument("--ab", metavar="OTHER_SRC",
                    help="time another tree's kernels and this one's in turns instead")
    ap.add_argument("--time-src", help=argparse.SUPPRESS)
    ap.add_argument("--turn", type=int, default=0, help=argparse.SUPPRESS)
    args = ap.parse_args()
    phases = [p for p in args.phases.split(",") if p]
    if any(p not in ALL_PHASES for p in phases):
        fail(f"unknown phase in {phases}; known: {ALL_PHASES}")
    if not torch.cuda.is_available():
        fail("no CUDA device: this script runs the port on a GPU")
    if args.ab:
        ab(args.ab)
        print("chip_smoke: kernel times of two trees in turns; no result line")
        return
    if args.time_src:
        ab_turn(args.time_src, args.turn)
        return

    smi = phase_env()
    phase_build()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    records = phase_kernels(gen) if "kernels" in phases else {}
    if "parity" in phases:
        phase_parity()
    launches = phase_serve(smi) if "serve" in phases else {}
    if set(phases) != set(ALL_PHASES):
        print(f"chip_smoke: partial run ({phases}); no result line")
        return
    kernels = [{**records[name], "launches": launches[name]} for name in KERNELS]
    order = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
             "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: rec[k] for k in order} for rec in kernels]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
