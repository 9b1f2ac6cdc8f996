#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from ``src/repro_torch/kernels/csrc`` with nvcc,
holds each against its plain PyTorch version on the card (with the sliding
window, the VLM's bidirectional prefix, head_dim 80 and 96, group 7, the
SSD scan at zamba2's N 64 and a block table from ``PagedKVManager``),
checks that the port's engine samples the same tokens on the card (kernels)
and on the CPU (plain versions) for every ported family (the MoE arm with
and without capacity drops, the zamba2 hybrid) and the model-level VLM and
windowed paths agree, serves llama-8b, phi3-mini-3.8b, olmo-1b,
internvl2-2b, mamba2-1.3b, qwen2-moe-a2.7b, deepseek-moe-16b, zamba2-2.7b,
whisper-base and yi-34b at full width (random bf16 weights from a seed;
yi-34b last, alone on the card) through ``repro_torch.launch.serve``'s
loop, puts the
planner's step beside each graphed one and fits its ``MBU`` and
``STEP_OVERHEAD`` to the dense and VLM models' (the ``perf_model`` line),
and runs Chiron's whole hierarchy,
``serve_forever`` driven by ``ChironController`` over llama-8b instances
sharing the card (the ``cluster`` phase: first the smoke cluster's
decisions and tokens card against CPU and a migration mid-generation, then
a mixed interactive and batch trace at full width), and trains olmo-1b and
mamba2-1.3b at full width in float32 through ``repro_torch.launch.train``'s
loop (the ``train`` phase: first one step card against CPU at the smoke
size and one gradient card against CPU at full widths, zamba2-2.7b's
included), each path with the kernels' launch counters set to 0 just
before it and read just after. The ``sim`` phase then runs Chiron's simulator on the card's
planning constants: it measures the host-to-card rate of a llama-8b
checkpoint load beside ``sim/perf_model.py``'s ``_LOAD_BW``, puts the
planned prefill beside the one the ``serve`` phase measured, and runs the
paper's Fig. 19 scenario under ``ChironController`` (with the shadow
verifier and a flight recorder) and ``LlumnixController`` on 50 cards,
on the shipped constants and on the ``serve`` phase's fitted ones. Then it
audits the port's package with its static auditor (any finding fails),
exports that Chiron run's flight recorder (JSONL, Perfetto JSON,
Prometheus text, into a temporary directory) and reads the JSONL
back through the terminal dashboards, runs the fleet scenarios
``regional_spillover`` and ``zone_outage`` through ``simulate_fleet`` with
the shadow verifier (every cluster on the baseline accelerator row, the
card's own constants; chip-hours, no dollars), and every other registered
scenario at its default size, but the two that put clusters on TPU-scaled
rows. It fails if a request is lost. The simulator is host code: it
launches no kernel. The attention gradient runs through the hand-written
``flash_prefill`` backward kernels (bf16 on ``wgmma`` + TMA, float32 on
FMAs), given the log-sum-exp that the forward's LSE instance saved, and is
held against its plain version in the ``kernels`` phase, directly and
through ``FlashPrefill`` under autograd; the SSD scan's gradient through
the hand-written ``ssd_scan`` backward kernels (one chunk without state,
as in training: 3xTF32 products on the tensor cores; otherwise fp32 FMAs),
held against ``ssd_scan_backward_plain`` there, directly and through
``SSDScan``. The float32 forwards that training launches run on their own
3xTF32 kernels (``flash_prefill_kernel_tf32``; ``ssd_scan_kernel_tf32`` for
one chunk from a zero state), held against their plain versions there in
every case a second time bit for bit (the SSD one also against its plain
version in float64, within ``TF32_FACTOR`` of the float32 plain version's
error), and each has a row of its own in the kernels line, whose bound is
that of 3xTF32 on the tensor cores (the FMA rate's beside it, in
``bound_fp32_fma_ms``, as for the SSD backward's row); the wrappers' rows
count the wrappers' other kernels. The ``kernels`` phase first runs the bf16 SSD forward under
remat on PyTorch's autograd thread and from a new host thread (its tensor
maps need the context those threads lack until the launcher binds it).
Every engine on the card replays its decode step as a CUDA graph captured
when it was built; the ``graph`` phase holds one replay against one eager
``model.decode_step`` from the same pool state at full width, bit for bit,
the ``serve``
phase times both and also serves llama-8b with the prefix cache and chunked
prefill. A replay counts the launches its capture recorded
(``serving/decode_graph.py``), and the profiler confirms one
``paged_attention`` kernel an attention layer in a replayed step. Every
phase prints
JSON lines; any failure ends the run with a non-zero exit code. Without a
GPU it fails at once. A kernel's ``ms`` (and the plain version's and the
library call's) is device time: the own times of the kernels one call
launches, read with torch.profiler; ``call_ms`` beside it is CUDA events
around calls back to back, which the host's launch rate bounds from below. The last line of the output is
``{"ok": true, "device": {...}}``; the line with the per-kernel numbers
(``{"kernels": [...]}``) and the card's name and power limit come just
before it.

``--phases kernels,parity`` runs a subset (env and build always run); the
final ``ok`` line is printed only when every phase ran. ``--phases sim``
runs the simulator alone, ``--phases serve,sim`` with the prefill report
and the fitted constants' run.

``--ab OTHER/src`` instead times the three serving kernels of another tree's port
(for example the parent commit's, unpacked with ``git archive``) and of this
checkout's at the serving path's shapes, the float32 forwards that training
launches (the attention's with the log-sum-exp at olmo-1b's training shape,
the SSD scan's at mamba2-1.3b's and zamba2-2.7b's, and beside them the
float32 SSD scan at s 341, which stays on the FMA kernel), the attention's gradient
at whisper-base's encoder and olmo-1b's training shape, and the SSD scan's at
mamba2-1.3b's and zamba2-2.7b's, in turns (other, this, this,
other), each turn in its own process with the kernels built from that
tree's sources, and prints one ``ab`` JSON line per (tree, turn, case), so
that two versions are compared on one card within one call.
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import inspect
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
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
from repro_torch.kernels import _build, ops  # noqa: E402
from repro_torch.kernels.flash_prefill import (  # noqa: E402
    _forward as _flash_forward, attention_mask, flash_prefill, flash_prefill_backward,
    flash_prefill_backward_plain, flash_prefill_plain)
from repro_torch.kernels.paged_attention import (paged_attention,  # noqa: E402
                                                 paged_attention_plain)
import repro_torch.kernels.ssd_scan as ssd_module  # noqa: E402
from repro_torch.kernels.ssd_scan import ssd_scan, ssd_scan_plain  # noqa: E402
# the SSD scan's backward: a tree older than it has none, and an ``--ab``
# turn imports such a tree (it times no SSD backward)
ssd_scan_backward = getattr(ssd_module, "ssd_scan_backward", None)
ssd_scan_backward_plain = getattr(ssd_module, "ssd_scan_backward_plain", None)
from repro_torch.kernels.ref import ssd_scan_ref  # noqa: E402
from repro_torch.configs.base import InputShape  # noqa: E402
from repro_torch.launch import roofline  # noqa: E402
from repro_torch.launch.serve import serve  # noqa: E402
from repro_torch.launch.steps import loss_and_grads, make_train_step  # noqa: E402
from repro_torch.launch.train import synthetic_lm_batch, train  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.serving import decode_graph  # noqa: E402
from repro_torch.serving.cluster_trace import ClusterRecorder, SharedClock  # noqa: E402
from repro_torch.serving.engine import Engine  # noqa: E402
from repro_torch.serving.kv_manager import PagedKVManager  # noqa: E402
from repro_torch.serving.real_cluster import RealCluster, serve_forever  # noqa: E402
from repro_torch.serving.request import make_batch, make_interactive  # noqa: E402
from repro_torch.analysis import ShadowVerifyError  # noqa: E402
from repro_torch.sim.cluster import InstanceType, SimCluster  # noqa: E402
from repro_torch.sim.controllers import ChironController, LlumnixController  # noqa: E402
from repro_torch.sim.perf_model import PerfModel  # noqa: E402
from repro_torch.sim.simulator import default_perf_factory, simulate_events  # noqa: E402
from repro_torch.sim.workload import WorkloadSpec, generate  # noqa: E402
from repro_torch.training import tree  # noqa: E402
from repro_torch.training.optimizer import adamw_init  # noqa: E402

ALL_PHASES = ("kernels", "parity", "graph", "serve", "cluster", "train", "sim", "launch",
              "examples")

# NVIDIA H100 SXM data sheet, dense rates
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
PEAK_TF32_FLOPS = 495e12
# tolerances of the reference's kernel tests; the kernels keep the softmax
# weights in float32 where the plain versions round the output once, which
# is far inside the bfloat16 tolerance
TOL = {torch.float32: 2e-4, torch.bfloat16: 5e-2}
# the SSD scan sums over a chunk of up to 256 steps in another order than the
# plain version's einsums (the reference's own ssd tolerance in float32)
SSD_TOL = {torch.float32: 2e-3, torch.bfloat16: 5e-2}
# 3xTF32 keeps float32's precision: against float64, a float32 kernel on the
# tensor cores errs at most this many times the plain float32 version's
# (their sums run in other orders; tests/test_torch_ssd_forward_tf32.py's
# FACTOR)
TF32_FACTOR = 4.0
# whisper-base's attention averages over 1500 keys, so its outputs and
# gradients are far below 1 (an output's std is about sqrt(e / 1500) = 0.043)
# and TOL's bfloat16 atol exceeds a typical value: there the error is held to
# this share of the largest |want| as well (one bfloat16 ulp is at most 2**-7
# of a value; a dropped 28-row tail tile or split moves the output by ~0.02)
OF_MAX_TOL = 1e-2
KERNELS = {"paged_attention": paged_attention, "flash_prefill": flash_prefill,
           "ssd_scan": ssd_scan, "flash_prefill_backward": flash_prefill_backward,
           "ssd_scan_backward": ssd_scan_backward}
# the wrappers whose bf16 launches go to a wgmma kernel, counted apart in
# their ``tensor_core_launches``
TENSOR_CORE_KERNELS = ("flash_prefill", "ssd_scan")
# the float32 forwards' own kernels in those wrappers, in the same order
# (3xTF32 on the tensor cores, counted in their ``tf32_launches``), each with
# a row of its own in the kernels line
TF32_KERNELS = ("flash_prefill_tf32", "ssd_scan_tf32")
# the kernels of a llama-8b instance, and so of the cluster phase
ATTENTION_KERNELS = ("paged_attention", "flash_prefill")
# the longest the cluster phase's full-width run may take
CLUSTER_LIMIT_S = 400.0

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
    # the float32 forwards of the two, their own kernels in the same sources
    # and wrappers (3xTF32 on the tensor cores), launched by training
    "flash_prefill_tf32": {
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_prefill.cu",
        "replaces": "src/repro/kernels/flash_prefill.py:85",
    },
    "ssd_scan_tf32": {
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/ssd_scan.cu",
        "replaces": "src/repro/kernels/ssd_scan.py:90",
    },
    # the reference has no Pallas backward: it trains through jax.grad of
    # its plain attention, which this kernel stands in for
    "flash_prefill_backward": {
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_prefill_bwd.cu",
        "replaces": "src/repro/models/layers.py:130",
    },
    # nor for the SSD scan: the reference trains through jax.grad of its jnp
    # oracle ssd_chunked, which ssm.py:183 reaches through ops.ssd_scan
    "ssd_scan_backward": {
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/ssd_scan_bwd.cu",
        "replaces": "src/repro/models/ssm.py:25",
    },
}


def zero_counts() -> None:
    """Every launch counter of every kernel wrapper set to 0."""
    decode_graph.add_counts([-c for c in decode_graph.read_counts()])
    flash_prefill_backward.launches = 0
    flash_prefill.lse_launches = 0
    flash_prefill.tf32_launches = 0
    ssd_scan.tf32_launches = 0
    ssd_scan_backward.launches = 0
    ssd_scan_backward.tensor_core_launches = 0


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def fail(message: str) -> None:
    print(f"chip_smoke: FAILED: {message}", file=sys.stderr, flush=True)
    sys.exit(1)


def _leaves(tree):
    for v in tree.values():
        yield from _leaves(v) if isinstance(v, dict) else [v]


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


# marker kernels in front of every profiler session (``_kernel_rows``): 8
# were once enough to take the events a session loses at its start; after
# the MoE and hybrid paths' sessions, yi-34b's prefill sessions lost one
# event of their own, every time, on the H100
LEAD_IN = 32


def _kernel_rows(fn, reps: int) -> list:
    """The device rows of ``key_averages()`` over ``reps`` calls of ``fn()``
    under torch.profiler. A session counts only if some of its lead-in's
    marker kernels were seen (the events it lost at its start were all
    markers) and its kernel events number exactly ``reps`` times those of
    one call, read from a one-call session just before it, which must count
    too: the profiler drops device events now and then (the first few of a
    session, which the lead-in below absorbs, and at times more), and a
    partial session would pass a fraction of the device time as the whole.
    Such a pair of sessions is run again after a pause, up to six times in
    all; then the run fails."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def session(n):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            # a session's first device events are the ones it loses: a
            # lead-in of marker kernels (``spin_kernel``, left out of the
            # rows) and a pause take that loss before ``fn`` runs
            for _ in range(LEAD_IN):
                torch.cuda._sleep(1000)
            torch.cuda.synchronize()
            time.sleep(0.02)
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
        markers = sum(e.count for e in events if "spin_kernel" in e.key)
        return [e for e in events if "spin_kernel" not in e.key], markers

    seen = []
    for attempt in range(6):
        time.sleep(0.2 * attempt)
        one_rows, one_markers = session(1)
        one = sum(e.count for e in one_rows)
        rows, markers = session(reps)
        n = sum(e.count for e in rows)
        if one > 0 and n == reps * one and one_markers > 0 and markers > 0:
            return rows
        seen.append([one, n, one_markers, markers])
    fail(f"six profiler sessions of {reps} calls were incomplete (kernel events "
         f"of one call, of {reps} calls, lead-in markers seen in each of "
         f"{LEAD_IN}: {seen}): device times cannot be read")


def device_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of one call of ``fn()`` in ms: the own times of every
    kernel the calls launched, from a complete torch.profiler session
    (``_kernel_rows``) over ``iters`` calls after a warm-up. Unlike
    ``time_ms`` it does not include the gaps in which the device waits for
    the host between calls. ``fn`` must launch the same kernels at every
    call."""
    for _ in range(warmup):
        fn()
    return sum(_device_us(e) for e in _kernel_rows(fn, iters)) / iters / 1e3


def _device_us(event) -> float:
    return getattr(event, "self_device_time_total",
                   getattr(event, "self_cuda_time_total", 0.0))


def check_close(name: str, got: torch.Tensor, want: torch.Tensor, dtype,
                tols=TOL, of_max: float | None = None) -> float:
    """Max abs error; fails unless |got - want| <= tol + tol * |want| and,
    with ``of_max``, unless |got - want| <= of_max * max |want| as well."""
    got, want = got.float(), want.float()
    if not torch.isfinite(got).all():
        fail(f"{name}: kernel output is not finite")
    err = (got - want).abs()
    tol = tols[dtype]
    if not bool((err <= tol + tol * want.abs()).all()):
        fail(f"{name}: max abs error {err.max().item():.3e} exceeds "
             f"tolerance {tol:g} (atol and rtol)")
    if of_max is not None and err.max().item() > of_max * want.abs().max().item():
        fail(f"{name}: max abs error {err.max().item():.3e} exceeds {of_max:g} of "
             f"max |want| {want.abs().max().item():.3e}")
    return err.max().item()


def bound(n_bytes: float, n_flops: float, dtype):
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = n_flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def bound_3xtf32(n_bytes: float, n_flops: float):
    """``bound`` for a float32 function whose products run on the tensor
    cores in 3xTF32: three TF32 products a pair, at the TF32 rate."""
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = 3 * n_flops / PEAK_TF32_FLOPS * 1e3
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


# the bf16 instantiations on the serving paths, which must not spill: llama-8b
# (D 128, group 4), phi3-mini (D 96, group 1), olmo-1b, qwen2-moe and
# deepseek-moe (group 1), internvl2-2b (group 2, and its prefills' prefix
# mask), yi-34b (group 7, taken by the group-8 instance at 16 lanes a row),
# mamba2-1.3b (N 128), zamba2-2.7b (D 80 at group 1; every prefill through
# the masked instance, its config having a window; the SSD scan at N 64) and
# whisper-base (D 64 at group 1: its encoder, cross and causal prefills, its
# decoder's self and cross attention)
SERVING_INSTANCES = ("flash_prefill_kernel_wgmma<128, 0, 0>",
                     "flash_prefill_kernel_wgmma<64, 0, 0>",
                     "flash_prefill_kernel_wgmma<96, 0, 0>",
                     "flash_prefill_kernel_wgmma<128, 1, 0>",
                     "flash_prefill_kernel_wgmma<80, 0, 0>",
                     "flash_prefill_kernel_wgmma<80, 1, 0>",
                     "paged_attention_kernel<__nv_bfloat16, 128, 4, 8>",
                     "paged_attention_kernel<__nv_bfloat16, 96, 1, 8>",
                     "paged_attention_kernel<__nv_bfloat16, 80, 1, 8>",
                     "paged_attention_kernel<__nv_bfloat16, 64, 1, 8>",
                     "paged_attention_kernel<__nv_bfloat16, 128, 1, 8>",
                     "paged_attention_kernel<__nv_bfloat16, 128, 2, 8>",
                     "paged_attention_kernel<__nv_bfloat16, 128, 8, 16>",
                     "ssd_scan_kernel_wgmma<128>",
                     "ssd_scan_kernel_wgmma<64>")


# the instantiations on the training paths, float32, which must not spill
# (the forwards' 3xTF32 ones are listed in FORWARD_TF32_INSTANCES): olmo-1b's
# backward kernels (D 128); the SSD backward's tensor-core kernel at
# mamba2-1.3b's widths (N 128: every SSD launch of its training run) and
# zamba2-2.7b's (N 64); the FMA kernels of the SSD forward and backward
# where a call has more than one chunk (the card-against-CPU gradients at 2
# x 320: P 64, N 128 and 64, row blocks of 64) or the smoke widths (P 32, N
# 16, chunks of 32); zamba2's shared attention's backward at D 80
TRAINING_INSTANCES = ("flash_prefill_bwd_dq_fma<128>",
                      "flash_prefill_bwd_dkdv_fma<128>",
                      "ssd_scan_bwd_tc<float, 128>",
                      "ssd_scan_bwd_tc<float, 64>",
                      "ssd_scan_kernel_fma<128, 64>",
                      "ssd_scan_kernel_fma<64, 64>",
                      "ssd_scan_kernel_fma<16, 32>",
                      "ssd_scan_bwd_kernel<float, 64, 128, 64>",
                      "ssd_scan_bwd_kernel<float, 64, 64, 64>",
                      "flash_prefill_bwd_dq_fma<80>",
                      "flash_prefill_bwd_dkdv_fma<80>",
                      "ssd_scan_bwd_kernel<float, 32, 16, 32>")
# the float32 forwards' 3xTF32 instantiations, all on the training paths:
# flash_prefill at every head_dim, with and without the log-sum-exp (olmo-1b
# launches <128, 1>, zamba2-2.7b's shared attention <80, 1>); ssd_scan at N
# 128 (mamba2-1.3b) and 64 (zamba2-2.7b)
FORWARD_TF32_INSTANCES = tuple(
    f"flash_prefill_kernel_tf32<{d}, {lse}>" for d in (64, 80, 96, 128) for lse in (0, 1)) + \
    ("ssd_scan_kernel_tf32<128>", "ssd_scan_kernel_tf32<64>")
# the backward's bf16 tensor-core instantiations: every head_dim, with and
# without the general mask
BACKWARD_WGMMA_INSTANCES = tuple(
    f"flash_prefill_bwd_{k}_wgmma<{d}, {m}>"
    for k in ("dq", "dkdv") for d in (64, 80, 96, 128) for m in (0, 1))
# the SSD backward's tensor-core (3xTF32 mma.sync) instantiations: both input
# types at N 128 and 64
SSD_BACKWARD_TC_INSTANCES = tuple(f"ssd_scan_bwd_tc<{t}, {n}>"
                                  for t in ("float", "__nv_bfloat16") for n in (128, 64))


def phase_build() -> None:
    """Builds every kernel source with ``-Xptxas=-v``; fails if a listed
    serving, training, forward 3xTF32 or backward instantiation (the SSD
    backward's tensor-core ones included) is missing or spills, or if any
    instantiation of the two ``flash_prefill`` sources or of the two SSD
    sources spills."""
    t0 = time.monotonic()
    out = _build.build_all(extra_flags=("-Xptxas=-v",))
    usage = {}
    found = {}
    for name, text in out.items():
        kernels = ptxas_usage(text)
        usage[name] = {
            "max_registers": max((k["registers"] or 0 for k in kernels), default=None),
            "kernels": len(kernels),
            "spilling": [k for k in kernels if k["spill_stores"] or k["spill_loads"]]}
        found.update({k["kernel"]: k for k in kernels})
    listed = {"serving": SERVING_INSTANCES, "training": TRAINING_INSTANCES,
              "forward_tf32": FORWARD_TF32_INSTANCES,
              "backward_wgmma": BACKWARD_WGMMA_INSTANCES,
              "ssd_backward_tc": SSD_BACKWARD_TC_INSTANCES}
    emit("build", seconds=round(time.monotonic() - t0, 2),
         flags=" ".join(_build.NVCC_FLAGS), ptxas=usage,
         **{f"{kind}_instances": [found.get(i) for i in insts]
            for kind, insts in listed.items()})
    for kind, insts in listed.items():
        for inst in insts:
            k = found.get(inst)
            if k is None or k["spill_stores"] or k["spill_loads"]:
                fail(f"build: {kind} instantiation {inst} missing or spilling: {k}")
    for name in ("flash_prefill", "flash_prefill_bwd", "ssd_scan", "ssd_scan_bwd"):
        if usage[name]["spilling"]:
            fail(f"build: {name} instantiations spill: {usage[name]['spilling']}")


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


def _paged_timed(gen, F, dtype, B, n_kv, group, D, pps, case, lengths,
                 starts=None, of_max=None) -> dict:
    """One timed ``paged_attention`` case against its plain version, each
    sequence attending over ``[starts[b], lengths[b])`` (``starts`` None: from
    0); returns its record for the kernels line (without the launch count)."""
    # pools rotate so that, as between the layers of a model, a launch does
    # not find its K/V in the 50 MB L2 from the launch before
    q, pools, bt, ln = _paged_case(gen, dtype, B, n_kv, group, D, lengths, pps,
                                   copies=4)
    st = None if starts is None else torch.tensor(starts, dtype=torch.int32,
                                                  device="cuda")
    lo = starts or [0] * B
    out = paged_attention(q, *pools[0], bt, ln, starts=st)
    torch.cuda.synchronize()
    want = paged_attention_plain(q, *pools[0], bt, ln, st)
    err = check_close(f"paged_attention {dtype} {case}", out, want, dtype, of_max=of_max)
    for b, (n, s0) in enumerate(zip(lengths, lo)):
        if n <= s0 and out[b].abs().max().item() != 0.0:
            fail("paged_attention: a sequence with nothing to attend to must give zeros")
    turn = [0]

    def rotate(fn):
        turn[0] = (turn[0] + 1) % len(pools)
        fn(q, *pools[turn[0]], bt, ln, starts=st)

    ms = device_ms(lambda: rotate(paged_attention))
    call_ms = time_ms(lambda: rotate(paged_attention))
    # after ~50 launches the merge's ticket counters must still start at 0
    again = paged_attention(q, *pools[0], bt, ln, starts=st)
    torch.cuda.synchronize()
    err = max(err, check_close(f"paged_attention {dtype} {case}, after the timed calls",
                               again, want, dtype, of_max=of_max))
    plain_ms = device_ms(lambda: rotate(paged_attention_plain), iters=5, warmup=1)
    # one library call on the same work: dense gathered K/V and a mask
    idx = bt.long()
    kd = pools[0][0][idx].reshape(B, pps * 16, n_kv, D).permute(0, 2, 1, 3)
    vd = pools[0][1][idx].reshape(B, pps * 16, n_kv, D).permute(0, 2, 1, 3)
    kd = kd.repeat_interleave(group, dim=1).contiguous()
    vd = vd.repeat_interleave(group, dim=1).contiguous()
    qd = q.reshape(B, n_kv * group, 1, D)
    pos = torch.arange(pps * 16, device="cuda")[None, :]
    mask = (pos < ln[:, None]) & (pos >= torch.tensor(lo, device="cuda")[:, None])
    mask = mask[:, None, None, :]
    library_ms = device_ms(lambda: F.scaled_dot_product_attention(
        qd, kd, vd, attn_mask=mask))
    es = q.element_size()
    tokens = sum(max(0, n - s0) for n, s0 in zip(lengths, lo))
    pages = sum(max(0, -(-n // 16) - s0 // 16) for n, s0 in zip(lengths, lo))
    n_bytes = (2 * tokens * n_kv * D + 2 * q.numel()) * es + \
        4 * (pages + B * (1 if starts is None else 2))
    b_ms, b_by = bound(n_bytes, 4.0 * tokens * n_kv * group * D, dtype)
    plan = paged_module.split_plan(B, n_kv, group, D, pps)
    emit("kernels", kernel="paged_attention", dtype=str(dtype), case=case,
         shape=dict(B=B, n_kv=n_kv, group=group, D=D, page=16, lengths=lengths,
                    starts=starts, max_pages=pps, block_tables="shuffled"),
         n_splits=plan.n_splits, pages_per_split=paged_module.PAGES_PER_SPLIT,
         tolerance=TOL[dtype], tolerance_of_max=of_max, max_abs_err=err, time_ms=ms, call_ms=call_ms,
         bound_ms=b_ms, bound_by=b_by, plain_ms=plain_ms, library_ms=library_ms)
    return {"name": "paged_attention", **KERNEL_INFO["paged_attention"],
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": library_ms}


def _paged_garbage(gen, dtype, B, n_kv, group, D, lengths, pps, starts=None) -> None:
    """``paged_attention`` with the table entries outside each sequence's
    pages in range (past its length, below its lower bound) set to 2**30
    (never dereferenced), against the plain version on a clean table; the
    ticket count of a sequence whose first used split is not split 0 must
    agree too, or the merge comes early, late or never."""
    q, pools, bt, ln = _paged_case(gen, dtype, B, n_kv, group, D, lengths, pps)
    st = None if starts is None else torch.tensor(starts, dtype=torch.int32,
                                                  device="cuda")
    safe = bt.clone()
    for b, n in enumerate(lengths):
        bt[b, -(-n // 16):] = 2 ** 30
        if starts is not None:
            bt[b, :starts[b] // 16] = 2 ** 30
    want = paged_attention_plain(q, *pools[0], safe, ln, st)
    err = 0.0
    for rep in range(3):      # a wrong ticket count shows from the second launch on
        out = paged_attention(q, *pools[0], bt, ln, starts=st)
        torch.cuda.synchronize()
        err = max(err, check_close(
            f"paged_attention {dtype} B={B} group={group} D={D} garbage, launch {rep}",
            out, want, dtype))
    for b, n in enumerate(lengths):
        if n <= (0 if starts is None else starts[b]) and out[b].abs().max().item() != 0.0:
            fail("paged_attention: a sequence with nothing to attend to must give zeros")
    plan = paged_module.split_plan(B, n_kv, group, D, pps)
    split = 16 * paged_module.PAGES_PER_SPLIT
    used = [max(0, -(-n // split) - (0 if starts is None else min(starts[b], n) // split))
            for b, n in enumerate(lengths)]
    emit("kernels", kernel="paged_attention", dtype=str(dtype),
         shape=dict(B=B, n_kv=n_kv, group=group, D=D, lengths=lengths, starts=starts,
                    max_pages=pps,
                    block_tables="garbage outside each sequence's pages in range"),
         n_splits=plan.n_splits, used_splits=used, tolerance=TOL[dtype],
         max_abs_err=err, launches_checked=3)


def _flash_inputs(gen, dtype, B, S, T, H, Hkv, D):
    """Random q (B,H,S,D) and k, v (B,Hkv,T,D) on the card, as transposed
    views of (B,S,H,D) tensors, as the model passes them."""
    q = torch.randn((B, S, H, D), generator=gen, device="cuda").to(dtype)
    k = torch.randn((B, T, Hkv, D), generator=gen, device="cuda").to(dtype)
    v = torch.randn((B, T, Hkv, D), generator=gen, device="cuda").to(dtype)
    return tuple(t.transpose(1, 2) for t in (q, k, v))


def _flash_timed(gen, F, dtype, H, Hkv, D, S, q_offset=0, causal=True, window=0,
                 prefix_len=0, case=None, T=None, of_max=None) -> dict:
    """One timed ``flash_prefill`` case (B=1) against its plain version;
    returns its record for the kernels line (without the launch count). The
    library yardstick is SDPA: causal where there is no other mask and no
    cached row, with an explicit boolean mask where there is a window or a
    prefix, none with cached rows only (its causal mask takes no offset) and
    none for full attention. Full attention (``causal=False``) takes any
    ``T`` (default ``S``): a cross-attention's."""
    T = q_offset + S if causal else (T or S)
    qt, kt, vt = _flash_inputs(gen, dtype, 1, S, T, H, Hkv, D)
    kw = dict(causal=causal, q_offset=q_offset if causal else 0, window=window,
              prefix_len=prefix_len)
    out = flash_prefill(qt, kt, vt, **kw)
    torch.cuda.synchronize()
    want = flash_prefill_plain(qt, kt, vt, **kw)
    label = case or f"S={S} off={q_offset} causal={causal}"
    err = check_close(f"flash_prefill {dtype} D={D} H={H} {label}", out, want, dtype,
                      of_max=of_max)
    ms = device_ms(lambda: flash_prefill(qt, kt, vt, **kw))
    call_ms = time_ms(lambda: flash_prefill(qt, kt, vt, **kw))
    plain_ms = device_ms(lambda: flash_prefill_plain(qt, kt, vt, **kw), iters=5, warmup=1)
    ke = kt.repeat_interleave(H // Hkv, dim=1)
    ve = vt.repeat_interleave(H // Hkv, dim=1)
    mask = attention_mask(S, T, q_offset=kw["q_offset"], window=window,
                          prefix_len=prefix_len, device="cuda") if causal else None
    library_ms = None
    if window or prefix_len:
        library_ms = device_ms(lambda: F.scaled_dot_product_attention(
            qt, ke, ve, attn_mask=mask))
    elif q_offset == 0:
        library_ms = device_ms(lambda: F.scaled_dot_product_attention(
            qt, ke, ve, is_causal=causal))
    seen = int(mask.sum()) if causal else S * T
    es = qt.element_size()
    b_ms, b_by = bound((2 * qt.numel() + kt.numel() + vt.numel()) * es,
                       4.0 * H * D * seen, dtype)
    emit("kernels", kernel="flash_prefill", dtype=str(dtype), case=case,
         route="wgmma + TMA" if dtype == torch.bfloat16 else "3xTF32 mma.sync",
         shape=dict(B=1, H=H, Hkv=Hkv, D=D, S=S, T=T, q_offset=kw["q_offset"],
                    causal=causal, window=window, prefix_len=prefix_len),
         tolerance=TOL[dtype], tolerance_of_max=of_max, max_abs_err=err, time_ms=ms, call_ms=call_ms,
         bound_ms=b_ms, bound_by=b_by, plain_ms=plain_ms, library_ms=library_ms)
    return {"name": "flash_prefill", **KERNEL_INFO["flash_prefill"],
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": library_ms}


# the log-sum-exp the forward writes for the backward, kernel against
# ``flash_prefill_plain(return_lse=True)``: natural-log values of order
# log(T) + a few, in float32 sums of other orders (bf16 inputs are the same
# bf16 values on both sides)
LSE_TOL = 1e-3


def _flash_bwd_case(gen, F, dtype, case, B, H, Hkv, D, S, T, causal, window=0,
                    prefix_len=0, of_max=None, timed=False) -> dict | None:
    """One ``flash_prefill_backward`` case against
    ``flash_prefill_backward_plain`` on the same q, k, v, forward output and
    output gradient, with the log-sum-exp that the forward's LSE instance
    wrote (itself held against the plain version's), and once without it
    (the wrapper then launches that instance itself), and through
    ``FlashPrefill`` under autograd (whose backward runs on the autograd
    engine's device thread), each bit for bit with the first. ``timed``: also its
    times; returns its record for the kernels line (without the launch
    count). Bound: the bytes of q, k, v, o, dO, dQ, dK, dV and the
    log-sum-exp, and 2.5 times the forward's operations (dV, dP, dQ, dK and
    S again: five products of the forward's two; the kernels do seven, S
    and dP twice, for want of atomics). Yardstick: the backward of
    ``scaled_dot_product_attention`` alone (its forward run once before, K/V
    expanded to the query heads outside the timed graph; a boolean mask for
    a window or a prefix)."""
    kw = dict(causal=causal, window=window, prefix_len=prefix_len)
    qt, kt, vt = _flash_inputs(gen, dtype, B, S, T, H, Hkv, D)
    do = torch.randn((B, S, H, D), generator=gen, device="cuda").to(dtype).transpose(1, 2)
    before = flash_prefill.lse_launches
    o, lse = _flash_forward(qt, kt, vt, q_offset=0, with_lse=True, **kw)
    got = flash_prefill_backward(qt, kt, vt, o, do, lse=lse, **kw)
    again = flash_prefill_backward(qt, kt, vt, o, do, **kw)
    torch.cuda.synchronize()
    if flash_prefill.lse_launches - before != 2:
        fail(f"flash_prefill_backward {case}: {flash_prefill.lse_launches - before} "
             "forward launches wrote the log-sum-exp, not 2")
    o, lse = o.detach(), lse.detach()
    label = f"flash_prefill_backward {dtype} {case}"
    _, lse_want = flash_prefill_plain(qt, kt, vt, return_lse=True, **kw)
    lse_err = (lse - lse_want).abs().max().item()
    if not lse_err <= LSE_TOL:
        fail(f"{label}: the forward's log-sum-exp is off by {lse_err:.3e}")
    want = flash_prefill_backward_plain(qt, kt, vt, o, do, **kw)
    err = max(check_close(f"{label} {name}", g, w, dtype, of_max=of_max)
              for name, g, w in zip(("dq", "dk", "dv"), got, want))
    leaves = [t.detach().clone().requires_grad_(True) for t in (qt, kt, vt)]
    with torch.enable_grad():
        through = torch.autograd.grad(flash_prefill(*leaves, **kw), leaves, do)
    for route, grads in (("the call without lse", again), ("FlashPrefill", through)):
        for name, g, w in zip(("dq", "dk", "dv"), grads, got):
            if not torch.equal(g, w):
                fail(f"{label} {name}: {route} differs from the call given lse")
    # the kernels a call given lse launches, by the profiler's names: the
    # dtype's two, the general-mask instances for a window or a prefix
    iters = 20 if timed else 1
    rows = _kernel_rows(lambda: flash_prefill_backward(qt, kt, vt, o, do, lse=lse, **kw),
                        iters)
    instances = {_instance(e.key): e.count / iters for e in rows}
    if dtype == torch.bfloat16:
        masks = int(causal and (window > 0 or prefix_len > 0))
        want = {f"flash_prefill_bwd_{k}_wgmma<{D}, {masks}>": 1 for k in ("dq", "dkdv")}
    else:
        want = {f"flash_prefill_bwd_{k}_fma<{D}>": 1 for k in ("dq", "dkdv")}
    if instances != want:
        fail(f"{label}: a call launched {instances}, want {want}")
    shape = dict(B=B, H=H, Hkv=Hkv, D=D, S=S, T=T, causal=causal, window=window,
                 prefix_len=prefix_len)
    route = "wgmma + TMA" if dtype == torch.bfloat16 else "fp32 FMA"
    if not timed:
        emit("kernels", kernel="flash_prefill_backward", dtype=str(dtype), case=case,
             route=route, kernel_instances=instances, shape=shape, tolerance=TOL[dtype],
             tolerance_of_max=of_max, max_abs_err=err, lse_max_abs_err=lse_err)
        return None
    ms = sum(_device_us(e) for e in rows) / iters / 1e3
    call_ms = time_ms(lambda: flash_prefill_backward(qt, kt, vt, o, do, lse=lse, **kw))
    plain_ms = device_ms(lambda: flash_prefill_backward_plain(qt, kt, vt, o, do, **kw),
                         iters=5, warmup=1)
    mask = attention_mask(S, T, window=window, prefix_len=prefix_len,
                          device="cuda") if causal else None
    lq = qt.detach().clone().requires_grad_(True)
    lk = kt.repeat_interleave(H // Hkv, dim=1).detach().requires_grad_(True)
    lv = vt.repeat_interleave(H // Hkv, dim=1).detach().requires_grad_(True)
    with torch.enable_grad():
        if window or prefix_len:
            lo = F.scaled_dot_product_attention(lq, lk, lv, attn_mask=mask)
        else:
            lo = F.scaled_dot_product_attention(lq, lk, lv, is_causal=causal)
    library_ms = device_ms(lambda: torch.autograd.grad(lo, (lq, lk, lv), do,
                                                       retain_graph=True))
    seen = int(mask.sum()) if causal else S * T
    es = qt.element_size()
    b_ms, b_by = bound((4 * qt.numel() + 4 * kt.numel()) * es + 4 * B * H * S,
                       2.5 * 4.0 * B * H * D * seen, dtype)
    emit("kernels", kernel="flash_prefill_backward", dtype=str(dtype), case=case,
         route=route, kernel_instances=instances, shape=shape, tolerance=TOL[dtype],
         tolerance_of_max=of_max, max_abs_err=err, lse_max_abs_err=lse_err, time_ms=ms,
         call_ms=call_ms,
         bound_ms=b_ms, bound_by=b_by, plain_ms=plain_ms, library_ms=library_ms)
    return {"name": "flash_prefill_backward", **KERNEL_INFO["flash_prefill_backward"],
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": library_ms}


def _flash_lse_timed(gen, F, dtype, B, H, D, S) -> dict:
    """The forward's LSE instance (the one ``FlashPrefill`` launches) at a
    training shape (causal, no GQA), beside the instance without the
    log-sum-exp, the plain version asked for it, and SDPA's forward. Bound:
    the bytes of q, k, v, o and the log-sum-exp, and the forward's
    operations at the dtype's rate; for float32 also as 3xTF32 on the
    tensor cores (three products a pair at the 495 TFLOP/s TF32 rate).
    Returns the numbers of the line."""
    qt, kt, vt = _flash_inputs(gen, dtype, B, S, S, H, H, D)
    ms = device_ms(lambda: _flash_forward(qt, kt, vt, causal=True, q_offset=0, window=0,
                                          prefix_len=0, with_lse=True))
    without = device_ms(lambda: flash_prefill(qt, kt, vt))
    plain_ms = device_ms(lambda: flash_prefill_plain(qt, kt, vt, return_lse=True),
                         iters=5, warmup=1)
    library_ms = device_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True))
    seen = int(attention_mask(S, S, device="cuda").sum())
    n_bytes = 4 * qt.numel() * qt.element_size() + 4 * B * H * S
    flops = 4.0 * B * H * D * seen
    b_ms, b_by = bound(n_bytes, flops, dtype)
    tf32_ms, tf32_by = bound_3xtf32(n_bytes, flops) if dtype == torch.float32 \
        else (None, None)
    rec = dict(time_ms=ms, time_ms_without_lse=without, bound_ms=b_ms, bound_by=b_by,
               bound_3xtf32_ms=tf32_ms, bound_3xtf32_by=tf32_by, plain_ms=plain_ms,
               library_ms=library_ms)
    emit("kernels", kernel="flash_prefill", dtype=str(dtype),
         case="training shape, with the log-sum-exp (LSE instance)",
         route="wgmma + TMA" if dtype == torch.bfloat16 else "3xTF32 mma.sync",
         shape=dict(B=B, H=H, Hkv=H, D=D, S=S, T=S, causal=True), **rec)
    return rec


# the float32 forward's cases on its 3xTF32 kernel (case, B, H, Hkv, D, S,
# q_offset, causal, window, prefix_len, T): the training shapes of olmo-1b
# and of zamba2-2.7b's shared attention, then every head_dim with GQA, the
# window, the prefix, cached rows, full attention and ragged lengths
FLASH_TF32_CASES = [
    ("olmo-1b training", 8, 16, 16, 128, 128, 0, True, 0, 0, None),
    ("zamba2-2.7b training, D=80, window 4096", 8, 32, 32, 80, 128, 0, True, 4096, 0, None),
    ("D=64, group 2, ragged S=75, batch 2", 2, 4, 2, 64, 75, 0, True, 0, 0, None),
    ("D=80, group 7, ragged S=53", 1, 14, 2, 80, 53, 0, True, 0, 0, None),
    ("D=96, window 100", 1, 32, 32, 96, 341, 0, True, 100, 0, None),
    ("D=96, prefix 130", 1, 32, 32, 96, 300, 0, True, 0, 130, None),
    ("D=128, group 4, cached rows", 1, 32, 8, 128, 200, 312, True, 0, 0, None),
    ("window 100 after cached rows", 1, 32, 8, 128, 200, 312, True, 100, 0, None),
    ("window 70 beside prefix 100", 1, 16, 8, 128, 400, 0, True, 70, 100, None),
    ("full, D=128, S=300", 1, 32, 8, 128, 300, 0, False, 0, 0, None),
    ("full, D=64, S=337, T=1500", 1, 8, 8, 64, 337, 0, False, 0, 0, 1500),
]


def _flash_tf32_cases(gen) -> float:
    """The float32 forward's 3xTF32 kernel against ``flash_prefill_plain``
    in every case of ``FLASH_TF32_CASES``, (B, S, H, D) tensors as strided
    views: the instance without the log-sum-exp and the LSE instance
    (its log-sum-exp within ``LSE_TOL`` of the plain version's), each output
    within ``TOL``, each called twice and bit for bit, each launch counted
    in ``flash_prefill.tf32_launches`` (none in ``tensor_core_launches``,
    the bf16 kernel's) and seen by the profiler as the
    instance ``flash_prefill_kernel_tf32<D, LSE>``. Returns the largest
    error at olmo-1b's training shape."""
    dtype = torch.float32
    main_err = None
    for case, B, H, Hkv, D, S, q_offset, causal, window, prefix_len, T in FLASH_TF32_CASES:
        T = q_offset + S if causal else (T or S)
        qt, kt, vt = _flash_inputs(gen, dtype, B, S, T, H, Hkv, D)
        kw = dict(causal=causal, q_offset=q_offset, window=window, prefix_len=prefix_len)
        label = f"flash_prefill 3xTF32 {case}"
        before = (flash_prefill.launches, flash_prefill.tf32_launches,
                  flash_prefill.tensor_core_launches)
        o = flash_prefill(qt, kt, vt, **kw)
        o_again = flash_prefill(qt, kt, vt, **kw)
        o_lse, lse = _flash_forward(qt, kt, vt, with_lse=True, **kw)
        o_lse_again, lse_again = _flash_forward(qt, kt, vt, with_lse=True, **kw)
        torch.cuda.synchronize()
        counted = (flash_prefill.launches - before[0], flash_prefill.tf32_launches - before[1],
                   flash_prefill.tensor_core_launches - before[2])
        if counted != (4, 4, 0):
            fail(f"{label}: four calls counted (launches, 3xTF32 launches, wgmma "
                 f"launches) {counted}")
        want, lse_want = flash_prefill_plain(qt, kt, vt, return_lse=True, **kw)
        err = max(check_close(f"{label}, LSE 0", o, want, dtype),
                  check_close(f"{label}, LSE 1", o_lse, want, dtype))
        lse_err = (lse - lse_want).abs().max().item()
        if not lse_err <= LSE_TOL:
            fail(f"{label}: the log-sum-exp is off by {lse_err:.3e}")
        for what, a, b in (("o", o, o_again), ("o, LSE 1", o_lse, o_lse_again),
                           ("lse", lse, lse_again)):
            if not torch.equal(a, b):
                fail(f"{label}: {what}: a second call gave other bits")
        instances = {}
        for lse_flag, fn in ((0, lambda: flash_prefill(qt, kt, vt, **kw)),
                             (1, lambda: _flash_forward(qt, kt, vt, with_lse=True, **kw))):
            got = {_instance(e.key): e.count for e in _kernel_rows(fn, 1)}
            if got != {f"flash_prefill_kernel_tf32<{D}, {lse_flag}>": 1}:
                fail(f"{label}: a call launched {got}")
            instances.update(got)
        emit("kernels", kernel="flash_prefill", dtype=str(dtype), case=case,
             route="3xTF32 mma.sync", kernel_instances=instances,
             shape=dict(B=B, H=H, Hkv=Hkv, D=D, S=S, T=T, q_offset=q_offset, causal=causal,
                        window=window, prefix_len=prefix_len),
             tolerance=TOL[dtype], max_abs_err=err, lse_tolerance=LSE_TOL,
             lse_max_abs_err=lse_err, second_call="bit for bit")
        if main_err is None:
            main_err = err
    return main_err


def _paged_from_manager(gen) -> None:
    """A block table built through ``PagedKVManager`` (allocate, append
    across pages, swap out, swap back in onto other pages), padded with
    garbage past each sequence's pages, drives ``paged_attention`` over a
    bf16 pool on the card; held against the plain version. The port's
    counterpart of the reference's ``test_allocator_kernel_end_to_end``."""
    B, n_kv, group, D, num_pages, width = 3, 8, 4, 128, 64, 20
    m = PagedKVManager(num_pages=num_pages, page_size=16)
    m.allocate(0, 100)
    m.allocate(1, 300)                   # 19 pages: over both splits of the table
    m.allocate(2, 40)
    for _ in range(40):                  # 100 -> 140 tokens: pages 7..9
        m.append_token(0)
    before = m.block_table(1)
    m.swap_out(1)
    m.allocate(3, 200)                   # takes pages sequence 1 gave back
    m.swap_in(1)
    m.check_invariants()
    if m.block_table(1) == before:
        fail("kernels: the swapped-in sequence was meant to land on other pages")
    bf16 = torch.bfloat16
    q = torch.randn((B, n_kv, group, D), generator=gen, device="cuda").to(bf16)
    kp = torch.randn((num_pages, 16, n_kv, D), generator=gen, device="cuda").to(bf16)
    vp = torch.randn((num_pages, 16, n_kv, D), generator=gen, device="cuda").to(bf16)
    bt = torch.full((B, width), 2 ** 30, dtype=torch.int32)
    for b in range(B):
        bt[b, :len(m.block_table(b))] = torch.tensor(m.block_table(b), dtype=torch.int32)
    bt = bt.cuda()
    ln = torch.tensor([m.seq_tokens(b) for b in range(B)], dtype=torch.int32,
                      device="cuda")
    out = paged_attention(q, kp, vp, bt, ln)
    torch.cuda.synchronize()
    safe = torch.where(bt == 2 ** 30, 0, bt)
    err = check_close("paged_attention over a PagedKVManager table", out,
                      paged_attention_plain(q, kp, vp, safe, ln), bf16)
    emit("kernels", kernel="paged_attention", dtype=str(bf16),
         case="block table from PagedKVManager",
         shape=dict(B=B, n_kv=n_kv, group=group, D=D, lengths=ln.tolist(),
                    max_pages=width, tables=[m.block_table(b) for b in range(B)]),
         tolerance=TOL[bf16], max_abs_err=err)


def _ssd_remat_bf16(gen) -> None:
    """The bf16 SSD forward encodes its TMA maps with libcuda's
    ``cuTensorMapEncodeTiled``, which needs a context current on the calling
    host thread. Remat's recomputed forward runs on PyTorch's autograd device
    thread: ``ssd_scan`` in bf16 with a gradient at mamba2-1.3b's widths (b 2,
    s 128, 64 heads of P 64, N 128) inside ``torch.utils.checkpoint.checkpoint
    (use_reentrant=False)``, ``backward()`` on the card; its gradients must
    equal the same call's without checkpoint, bit for bit. It runs first in
    the kernels phase, before any other backward has used that thread. Then
    the same forward from a new host thread, which has made no CUDA call
    (after one on this thread, so that the allocator serves the new thread's
    outputs from its cache and the encoder is the thread's first CUDA call),
    bit for bit with this thread's."""
    from concurrent.futures import ThreadPoolExecutor
    from torch.utils.checkpoint import checkpoint

    sets, A, _ = _ssd_case(gen, torch.bfloat16, 2, 128, 64, 64, 128, strided=True)
    x, dt, B, C = sets[0]
    dy = torch.randn((2, 128, 64, 64), generator=gen, device="cuda").to(torch.bfloat16)

    def y_of(*inputs):
        return ssd_scan(*inputs, chunk=256)[0]

    grads = {}
    for route in ("checkpoint", "direct"):
        leaves = [t.detach().clone().requires_grad_(True) for t in (x, dt, A, B, C)]
        with torch.enable_grad():
            y = checkpoint(y_of, *leaves, use_reentrant=False) if route == "checkpoint" \
                else y_of(*leaves)
            torch.autograd.backward(y, dy)
        torch.cuda.synchronize()
        grads[route] = [t.grad for t in leaves]
    for nm, a, b in zip(("dx", "ddt", "dA", "dB", "dC"), *grads.values()):
        if not torch.equal(a, b):
            fail(f"ssd_scan bf16 under checkpoint: {nm} differs from the call without it")
    here = y_of(x, dt, A, B, C)
    with ThreadPoolExecutor(1) as pool:
        there = pool.submit(y_of, x, dt, A, B, C).result()
    torch.cuda.synchronize()
    if not torch.equal(here, there):
        fail("ssd_scan bf16 from a new host thread differs from this thread's")
    emit("kernels", kernel="ssd_scan", dtype="torch.bfloat16",
         case="remat's forward on the autograd thread; a new host thread",
         shape=dict(b=2, s=128, h=64, p=64, n=128, chunk=256, strided=True),
         result="gradients bit for bit with and without checkpoint; y bit for bit "
                "from a new thread")


def phase_kernels(gen) -> dict:
    """Each kernel against its plain version; returns the per-kernel record
    of the main path's shapes in bf16 (without the launch counts)."""
    records = {}
    F = torch.nn.functional
    _ssd_remat_bf16(gen)   # first: no backward has run on the autograd thread yet

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

    # the other paths' decode shapes at the serve contexts: phi3-mini (D = 96,
    # 32 KV heads, group 1), olmo-1b, qwen2-moe and deepseek-moe (16, group 1),
    # internvl2-2b (8, group 2), yi-34b (8, group 7: the group-8 instance with
    # one row masked), zamba2 (D = 80, 32 KV heads, group 1); then a sliding
    # window's lower bound inside the first split, on a split boundary, one
    # past it, in a later split, at the length, and wider than the sequence
    serve_lengths = paged_cases[1][1]
    window_starts = [0, 256, 257, 600, 300, 90, 0, 512]
    window_lengths = [1024, 1000, 517, 700, 300, 333, 16, 768]
    for dtype in (torch.bfloat16, torch.float32):
        for case, kv, g, d, lengths, starts in (
                ("phi3-mini, D=96", 32, 1, 96, serve_lengths, None),
                ("olmo-1b, qwen2-moe, deepseek-moe", 16, 1, 128, serve_lengths, None),
                ("internvl2-2b", 8, 2, 128, serve_lengths, None),
                ("yi-34b, group 7", 8, 7, 128, serve_lengths, None),
                ("window, long context", 8, 4, 128, window_lengths, window_starts),
                ("D=96, window", 32, 1, 96, window_lengths, window_starts),
                ("zamba2-2.7b, D=80", 32, 1, 80, serve_lengths, None),
                ("D=80, window", 32, 1, 80, window_lengths, window_starts)):
            _paged_timed(gen, F, dtype, B, kv, g, d, pps, case, lengths, starts)
        # whisper-base's cross-attention: every slot over its 1500 encoder
        # rows (94 pages of 16, 6 splits), n_kv 8, group 1, D 64
        _paged_timed(gen, F, dtype, B, 8, 1, 64, 94, "whisper-base cross, D=64",
                     [1500] * B, of_max=OF_MAX_TOL)
    # lower bounds with garbage below them, group 7, D = 96 and D = 80 (at
    # 16 lanes a row for group 8: 5 elements a lane, loaded one by one) in
    # both types
    for dtype in (torch.bfloat16, torch.float32):
        _paged_garbage(gen, dtype, 4, 2, 7, 128, [700, 300, 40, 600], 48,
                       starts=[300, 256, 40, 0])
        _paged_garbage(gen, dtype, 4, 3, 2, 96, [700, 513, 90, 257], 48,
                       starts=[600, 255, 10, 256])
        _paged_garbage(gen, dtype, 4, 3, 1, 80, [700, 513, 90, 257], 48,
                       starts=[600, 255, 10, 256])
        _paged_garbage(gen, dtype, 4, 2, 8, 80, [300, 0, 17, 600], 48,
                       starts=[40, 0, 0, 300])
    _paged_from_manager(gen)

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
            rec = _flash_timed(gen, F, dtype, H, Hkv, D, S, q_offset, causal)
            if dtype == torch.bfloat16 and (S, q_offset, causal) == (341, 0, True):
                records["flash_prefill"] = rec

    # the new paths' shapes and masks: phi3-mini (D = 96, 32 heads, no GQA),
    # olmo-1b (16 heads, no GQA), yi-34b (56 heads over 8), internvl2-2b (a
    # 256-token vision prefix in front of the longest prompt), and a sliding
    # window over several tiles, after cached rows and beside a prefix
    new_cases = [  # (case, H, Hkv, D, S, q_offset, window, prefix_len)
        ("phi3-mini, D=96", 32, 32, 96, 341, 0, 0, 0),
        ("olmo-1b", 16, 16, 128, 341, 0, 0, 0),
        ("yi-34b", 56, 8, 128, 341, 0, 0, 0),
        ("internvl2-2b, prefix 256", 16, 8, 128, 597, 0, 0, 256),
        ("window 256", 32, 8, 128, 682, 0, 256, 0),
        ("window 100, cached rows", 32, 8, 128, 200, 312, 100, 0),
        ("window 70 beside prefix 100", 16, 8, 128, 400, 0, 70, 100),
        ("D=96, window 100", 32, 32, 96, 341, 0, 100, 0),
        ("D=96, prefix 130", 32, 32, 96, 300, 0, 0, 130),
        # zamba2's shared attention (D = 80, 32 heads, no GQA): without a
        # window, and with one across tiles; its own window of 4096 cuts
        # nothing at S = 341 but still selects the masked instance
        ("zamba2-2.7b, D=80", 32, 32, 80, 341, 0, 0, 0),
        ("D=80, window 100", 32, 32, 80, 341, 0, 100, 0),
        ("zamba2-2.7b, D=80, window 4096", 32, 32, 80, 341, 0, 4096, 0),
    ]
    for dtype in (torch.bfloat16, torch.float32):
        for case, h, hkv, d, S, q_offset, window, prefix_len in new_cases:
            _flash_timed(gen, F, dtype, h, hkv, d, S, q_offset, True, window, prefix_len,
                         case=case)
    # single tiles at D = 96 and 80: the second TMA box reaches past the
    # tensor's columns and must read zeros there
    for D in (96, 80):
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

    # whisper-base (H 8, D 64, full attention): its encoder over 1500 frames
    # (1500 = 23 x 64 + 28: the last KV tile is TMA zero-fill and the mask)
    # and a 337-token prompt's cross-attention over them
    for dtype in (torch.bfloat16, torch.float32):
        for case, S, T in (("whisper-base encoder, full", 1500, 1500),
                           ("whisper-base cross prefill, full", 337, 1500)):
            _flash_timed(gen, F, dtype, 8, 8, 64, S, causal=False, T=T, case=case,
                         of_max=OF_MAX_TOL)

    # the backward: olmo-1b's training shape (B 8, H 16, D 128, S 128,
    # causal) and whisper-base's encoder (full, S = T = 1500, a ragged last
    # tile of 28 rows) timed; then head_dim 80 and 96, a window and a prefix
    # of 256, GQA groups 4 and 7, a ragged S of 337, full attention with
    # S != T and a batch of two, held against the plain version
    bwd_cases = [  # (case, B, H, Hkv, D, S, T, causal, window, prefix_len, of_max)
        ("olmo-1b training", 8, 16, 16, 128, 128, 128, True, 0, 0, None),
        ("whisper-base encoder, full", 1, 8, 8, 64, 1500, 1500, False, 0, 0, OF_MAX_TOL),
        ("D=80", 1, 32, 32, 80, 341, 341, True, 0, 0, None),
        ("D=96", 1, 32, 32, 96, 341, 341, True, 0, 0, None),
        ("window 256", 1, 32, 8, 128, 682, 682, True, 256, 0, None),
        ("prefix 256", 1, 16, 8, 128, 597, 597, True, 0, 256, None),
        ("group 4", 1, 32, 8, 128, 341, 341, True, 0, 0, None),
        ("group 7", 1, 56, 8, 128, 341, 341, True, 0, 0, None),
        ("ragged S=337", 1, 16, 16, 128, 337, 337, True, 0, 0, None),
        ("full, S=337, T=1500", 1, 8, 8, 64, 337, 1500, False, 0, 0, OF_MAX_TOL),
        ("batch 2, group 2", 2, 4, 2, 64, 75, 75, True, 0, 0, None),
    ]
    lse_timed = {}
    for dtype in (torch.float32, torch.bfloat16):
        for i, (case, *shape, of_max) in enumerate(bwd_cases):
            rec = _flash_bwd_case(gen, F, dtype, case, *shape, of_max=of_max, timed=i < 2)
            if dtype == torch.float32 and i == 0:
                records["flash_prefill_backward"] = rec
        lse_timed[dtype] = _flash_lse_timed(gen, F, dtype, 8, 16, 128, 128)

    # the float32 forward's 3xTF32 kernel: every case bit for bit on a second
    # call; its record is olmo-1b's training shape with the log-sum-exp
    err = _flash_tf32_cases(gen)
    t = lse_timed[torch.float32]
    records["flash_prefill_tf32"] = {
        "name": "flash_prefill_tf32", **KERNEL_INFO["flash_prefill_tf32"], "max_abs_err": err,
        "ms": t["time_ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_3xtf32_ms"],
        "bound_by": t["bound_3xtf32_by"], "bound_fp32_fma_ms": t["bound_ms"],
        "library_ms": t["library_ms"]}

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
    records["ssd_scan_tf32"] = _ssd_tf32_cases(gen)
    records["ssd_scan_backward"] = _ssd_scan_backward_cases(gen)
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


def _ssd_bwd_flops(b, s, h, p, n, chunk, h0: bool, dstate: bool,
                   heads_summed: bool = True) -> float:
    """Operations the scan's gradient needs on these inputs: per chunk of L
    valid steps, over its L (L + 1) / 2 causal pairs, C B^T once per
    sequence, dy x^T and W^T dy (P each) per head, and Z^T C and Z B (N
    each) once per sequence on the sum of Z over the heads (B and C are
    shared by the heads, so dB and dC are products of that sum; with
    ``heads_summed=False``, once per head, the count of the FMA kernel,
    which does them so); where the entering state is not zero (a later
    chunk, or h0) its recomputation, the carried-state term of dC and the
    entering state's gradient (L P N products each, per head); where G is
    not zero (an earlier chunk, or a final-state cotangent) the G terms of
    dx and dB."""
    flops = 0.0
    n_chunks = -(-s // chunk)
    for z in range(n_chunks):
        L = min(chunk, s - z * chunk)
        pairs = L * (L + 1) // 2
        zn = (1 if heads_summed else h) * 2.0 * pairs * 2 * n
        flops += b * 2.0 * pairs * n + b * zn + b * h * 2.0 * pairs * 2 * p
        state_terms = (3 if z > 0 else 2 if h0 else 0) + (2 if z < n_chunks - 1 or dstate
                                                          else 0)
        flops += b * h * 2.0 * L * p * n * state_terms
    return flops


def _ssd_bwd_dA_scale(dt, A, ddt) -> torch.Tensor:
    """The magnitude of what dA sums, per head: dA_h = sum over b, s of dt r,
    where A r is d(dt) less its direct part, so its terms are of order
    |dt d(dt) / A|. They cancel to far less where the decay is steep (A =
    -16, dt ~ 1) or there is one step (dA = 0 exactly), so dA is held to
    the tolerance times this, not times its own largest value."""
    return (dt * ddt.float()).abs().sum(dim=(0, 1)) / A.abs()


def _ssd_scan_backward_cases(gen) -> dict:
    """``ssd_scan_backward`` against ``ssd_scan_backward_plain`` on the card
    (each gradient within ``SSD_TOL`` of its largest magnitude, dA of
    ``_ssd_bwd_dA_scale``), a second call bit for bit with the first (no
    atomics), in float32 and bf16: mamba2-1.3b's and zamba2-2.7b's training
    shapes (x, B and C strided views, as the model slices them; timed), one
    full chunk of 256 (ten tile pairs), s = 1, on the tensor-core kernel;
    s 341, eight chunks of carried state (G and h both non-zero), h0 with a
    final-state cotangent, s = 257, the smoke widths and A = -16 with dt ~ 1
    on the FMA kernel (each call's kernel as ``backward_route`` names it,
    counted in ``tensor_core_launches`` or not). The float32 mamba2 case
    also goes through ``SSDScan`` under autograd (bit for bit with the
    direct call) and is held against ``torch.autograd.grad`` of
    ``ssd_scan_plain``. Returns the float32 mamba2 record (the main path's)
    for the kernels line."""
    record = None
    cases = [  # (name, b, s, h, p, n, chunk, h0, dstate, steep)
        ("mamba2-1.3b training", 8, 128, 64, 64, 128, 256, False, False, False),
        ("zamba2-2.7b training", 8, 128, 80, 64, 64, 256, False, False, False),
        ("s=256", 1, 256, 64, 64, 128, 256, False, False, False),
        ("s341", 1, 341, 64, 64, 128, 256, False, False, False),
        ("s2048", 1, 2048, 64, 64, 128, 256, False, False, False),
        ("h0, dstate", 1, 341, 64, 64, 128, 256, True, True, False),
        ("s=1", 1, 1, 64, 64, 128, 256, False, False, False),
        ("s=257", 1, 257, 64, 64, 128, 256, False, False, False),
        ("smoke widths, h0, dstate", 2, 100, 8, 32, 16, 32, True, True, False),
        ("A=-16, dt~1", 1, 341, 64, 64, 128, 256, False, False, True),
    ]
    names = ("dx", "ddt", "dA", "dB", "dC", "dh0")
    n_sms = torch.cuda.get_device_properties(0).multi_processor_count
    for dtype in (torch.float32, torch.bfloat16):
        for name, b, s, h, p, n, chunk, with_h0, with_dstate, steep in cases:
            sets, A, h0 = _ssd_case(gen, dtype, b, s, h, p, n, h0=with_h0, steep=steep,
                                    strided=p == 64)
            x, dt, B, C = sets[0]
            dy = torch.randn((b, s, h, p), generator=gen, device="cuda").to(dtype)
            dstate = torch.randn((b, h, p, n), generator=gen, device="cuda") \
                if with_dstate else None
            tensor_cores, heads = ssd_module.backward_route(b, s, h, p, n, chunk, with_h0,
                                                            with_dstate, n_sms)
            before = (ssd_scan_backward.launches, ssd_scan_backward.tensor_core_launches)
            got = ssd_scan_backward(x, dt, A, B, C, h0, dy, dstate, chunk=chunk)
            again = ssd_scan_backward(x, dt, A, B, C, h0, dy, dstate, chunk=chunk)
            torch.cuda.synchronize()
            counted = (ssd_scan_backward.launches - before[0],
                       ssd_scan_backward.tensor_core_launches - before[1])
            if counted != (2, 2 * int(tensor_cores)):
                fail(f"ssd_scan_backward {name}: two calls counted (launches, tensor-core "
                     f"launches) {counted}, the route implies (2, {2 * int(tensor_cores)})")
            want = ssd_scan_backward_plain(x, dt, A, B, C, h0, dy, dstate, chunk)
            label = f"ssd_scan_backward {dtype} {name}"
            errs = {}
            for nm, g, w, g2 in zip(names, got, want, again):
                if (g is None) != (w is None) or (g is not None and g.shape != w.shape):
                    fail(f"{label} {nm}: got {None if g is None else tuple(g.shape)}, "
                         f"want {None if w is None else tuple(w.shape)}")
                if w is None:
                    continue
                if not torch.equal(g, g2):
                    fail(f"{label} {nm}: a second call gave other bits")
                if not (torch.isfinite(g.float()).all() and torch.isfinite(w.float()).all()):
                    fail(f"{label} {nm}: not finite")
                err = (g.float() - w.float()).abs()
                scale = _ssd_bwd_dA_scale(dt, A, want[1]) if nm == "dA" \
                    else w.float().abs().max()
                if not bool((err <= SSD_TOL[dtype] * scale).all()):
                    fail(f"{label} {nm}: error {err.max().item():.3e} beyond {SSD_TOL[dtype]:g} "
                         f"of {scale.max().item():.3e}")
                errs[nm] = float((err / scale).max())
            rec = dict(kernel="ssd_scan_backward", dtype=str(dtype), case=name,
                       route="3xTF32 mma.sync" if tensor_cores else "fp32 FMA",
                       heads_per_block=heads,
                       shape=dict(b=b, s=s, h=h, p=p, n=n, chunk=chunk,
                                  h0=with_h0, dstate=with_dstate, strided=p == 64),
                       tolerance=SSD_TOL[dtype], rel_err=errs,
                       max_abs_err=max(float((g.float() - w.float()).abs().max())
                                       for g, w in zip(got, want) if w is not None))
            if dtype == torch.float32 and name == "mamba2-1.3b training":
                # the autograd route: SSDScan's backward is the direct call
                leaves = [t.detach().clone().requires_grad_(True) for t in (x, dt, A, B, C)]
                with torch.enable_grad():
                    y, _ = ssd_scan(*leaves, chunk=chunk)
                    through = torch.autograd.grad(y, leaves, dy)
                    y_plain, _ = ssd_scan_plain(*leaves, chunk)
                    auto = torch.autograd.grad(y_plain, leaves, dy)
                for nm, g, w, a in zip(names, through, got, auto):
                    if not torch.equal(g, w):
                        fail(f"{label} {nm}: SSDScan's gradient differs from the direct call")
                    scale = _ssd_bwd_dA_scale(dt, A, want[1]) if nm == "dA" \
                        else a.abs().max()
                    if not bool(((g - a).abs() <= SSD_TOL[dtype] * scale).all()):
                        fail(f"{label} {nm}: beyond {SSD_TOL[dtype]:g} of autograd of "
                             "ssd_scan_plain")
                rec["autograd_route"] = "SSDScan bit for bit with the direct call, within " \
                    "tolerance of autograd of ssd_scan_plain"
            if "training" in name:
                def kernel():
                    ssd_scan_backward(x, dt, A, B, C, h0, dy, dstate, chunk=chunk)

                rows = _kernel_rows(kernel, 20)
                ms = sum(_device_us(e) for e in rows) / 20 / 1e3
                own = {_instance(e.key): e.count / 20 for e in rows if "ssd_scan_bwd" in e.key}
                elem = "float" if dtype == torch.float32 else "__nv_bfloat16"
                if own != {f"ssd_scan_bwd_tc<{elem}, {n}>": 1}:
                    fail(f"{label}: a call launched {own}")
                kernel_ms = sum(_device_us(e) for e in rows if "ssd_scan_bwd" in e.key) / 20 / 1e3
                call_ms = time_ms(kernel)
                plain_ms = device_ms(lambda: ssd_scan_backward_plain(
                    x, dt, A, B, C, h0, dy, dstate, chunk), iters=5, warmup=1)
                es = x.element_size()
                n_bytes = 2 * (x.numel() + B.numel() + C.numel()) * es + dy.numel() * es + \
                    (2 * dt.numel() + 2 * A.numel()) * 4
                flops = _ssd_bwd_flops(b, s, h, p, n, chunk, with_h0, with_dstate)
                b_ms, b_by = bound(n_bytes, flops, dtype)
                # the same work as 3xTF32 products on the tensor cores (495 TFLOP/s
                # TF32, three products each), and the FMA kernel's per-head count
                tf32_ms, tf32_by = bound_3xtf32(n_bytes, flops)
                per_head_ms, _ = bound(n_bytes, _ssd_bwd_flops(
                    b, s, h, p, n, chunk, with_h0, with_dstate, heads_summed=False), dtype)
                # no single PyTorch call computes this gradient: no library time
                rec.update(time_ms=ms, kernel_ms=kernel_ms, call_ms=call_ms, bound_ms=b_ms,
                           bound_by=b_by, bound_3xtf32_ms=tf32_ms,
                           bound_per_head_products_ms=per_head_ms, flops=flops,
                           plain_ms=plain_ms, library_ms=None, kernel_instances=own)
                if dtype == torch.float32 and name == "mamba2-1.3b training":
                    # its kernel runs 3xTF32 on the tensor cores: that is its bound
                    record = {"name": "ssd_scan_backward", **KERNEL_INFO["ssd_scan_backward"],
                              "max_abs_err": rec["max_abs_err"], "ms": ms,
                              "plain_ms": plain_ms, "bound_ms": tf32_ms, "bound_by": tf32_by,
                              "bound_fp32_fma_ms": b_ms, "library_ms": None}
            emit("kernels", **rec)
    return record


def _ssd_scan_cases(gen) -> dict:
    """``ssd_scan`` against ``ssd_scan_plain`` (y and the final state) at the
    serving paths' shapes (mamba2-1.3b's, the main one, and zamba2's) and
    around them, and at mamba2-1.3b's training shape (8 x 128); returns the
    record of the main shape in bf16. At the
    serving widths (P = 64) x, B and C are strided views, as the model
    passes them."""
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
        # zamba2-2.7b's Mamba2 blocks: 80 heads, N = 64 (the NPAD-64 instance)
        ("zamba2", 1, 341, 80, 64, 64, 256, False, False),
        ("zamba2 h0", 1, 341, 80, 64, 64, 256, True, False),
        # mamba2-1.3b's training step (float32: the 3xTF32 kernel, two
        # launches a layer with remat; ``_ssd_tf32_cases`` holds it further)
        ("mamba2-1.3b training", 8, 128, 64, 64, 128, 256, False, False),
    ]
    n_sms = torch.cuda.get_device_properties(0).multi_processor_count
    for dtype in (torch.bfloat16, torch.float32):
        for name, b, s, h, p, n, chunk, with_h0, steep in cases:
            timed = name in ("main", "s512", "s2048", "zamba2", "mamba2-1.3b training")
            sets, A, h0 = _ssd_case(gen, dtype, b, s, h, p, n, h0=with_h0,
                                    steep=steep, copies=4 if timed else 1,
                                    strided=p == 64)
            x, dt, B, C = sets[0]
            y, state = ssd_scan(x, dt, A, B, C, h0, chunk=chunk)
            torch.cuda.synchronize()
            want_y, want_state = ssd_scan_plain(x, dt, A, B, C, chunk, h0=h0)
            label = f"ssd_scan {dtype} {name}"
            err = max(check_close(f"{label} y", y, want_y, dtype, SSD_TOL),
                      check_close(f"{label} state", state, want_state, dtype, SSD_TOL))
            if not (torch.isfinite(want_y).all() and torch.isfinite(want_state).all()):
                fail(f"{label}: the plain version is not finite")
            route, _ = ssd_module.forward_route(b, s, h, p, n, chunk, with_h0,
                                                dtype == torch.bfloat16, n_sms)
            rec = dict(kernel="ssd_scan", dtype=str(dtype), case=name,
                       route={"wgmma": "wgmma + TMA", "tf32": "3xTF32 mma.sync",
                              "fma": "fp32 FMA"}[route],
                       shape=dict(b=b, s=s, h=h, p=p, n=n, chunk=chunk, h0=with_h0,
                                  strided=p == 64),
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


# the float32 forward's one-chunk cases on its 3xTF32 kernel (case, b, s, h,
# n, steep): mamba2-1.3b's and zamba2-2.7b's training shapes (timed), a full
# chunk of 256, a ragged 200, batches that do not fill a wave, one step, and
# A = -16 with dt ~ 1; x, B and C strided views, as the model passes them
SSD_TF32_CASES = [
    ("mamba2-1.3b training", 8, 128, 64, 128, False),
    ("zamba2-2.7b training", 8, 128, 80, 64, False),
    ("mamba2, s=256", 8, 256, 64, 128, False),
    ("zamba2, s=256", 2, 256, 80, 64, False),
    ("mamba2, ragged s=200", 2, 200, 64, 128, False),
    ("zamba2, ragged s=200", 3, 200, 80, 64, False),
    ("mamba2, batch 1", 1, 128, 64, 128, False),
    ("zamba2, batch 3", 3, 128, 80, 64, False),
    ("s=1", 2, 1, 64, 128, False),
    ("A=-16, dt~1", 8, 128, 64, 128, True),
]


def _rel_max(got, want) -> float:
    """The largest error of ``got`` against ``want``, over ``want``'s
    largest magnitude."""
    return float((got.double() - want.double()).abs().max() / want.double().abs().max())


def _ssd_tf32_cases(gen) -> dict:
    """The float32 SSD forward's 3xTF32 kernel against ``ssd_scan_plain``
    (y and the final state within ``SSD_TOL``, and against its float64 run
    within ``TF32_FACTOR`` of the float32 plain version's error) in every case of
    ``SSD_TF32_CASES``, each call's kernel as ``ssd_scan.forward_route``
    names it (counted in ``ssd_scan.tf32_launches``, seen by the profiler as
    ``ssd_scan_kernel_tf32<N>``), a second call bit for bit. The training
    shapes are timed over four rotated input sets; their bound counts the
    function's operations (``_ssd_flops``) at the fp32 rate and, beside it,
    as 3xTF32 on the tensor cores. Returns mamba2-1.3b's record for the
    kernels line."""
    record = None
    dtype = torch.float32
    n_sms = torch.cuda.get_device_properties(0).multi_processor_count
    for case, b, s, h, n, steep in SSD_TF32_CASES:
        p, chunk = 64, 256
        timed = "training" in case
        sets, A, _ = _ssd_case(gen, dtype, b, s, h, p, n, steep=steep,
                               copies=4 if timed else 1, strided=True)
        x, dt, B, C = sets[0]
        route, heads = ssd_module.forward_route(b, s, h, p, n, chunk, False, False, n_sms)
        if route != "tf32":
            fail(f"ssd_scan 3xTF32 {case}: forward_route names {route}")
        label = f"ssd_scan 3xTF32 {case}"
        before = (ssd_scan.launches, ssd_scan.tf32_launches, ssd_scan.tensor_core_launches)
        y, state = ssd_scan(x, dt, A, B, C, chunk=chunk)
        y2, state2 = ssd_scan(x, dt, A, B, C, chunk=chunk)
        torch.cuda.synchronize()
        counted = (ssd_scan.launches - before[0], ssd_scan.tf32_launches - before[1],
                   ssd_scan.tensor_core_launches - before[2])
        if counted != (2, 2, 0):
            fail(f"{label}: two calls counted (launches, 3xTF32 launches, wgmma launches) "
                 f"{counted}")
        if not (torch.equal(y, y2) and torch.equal(state, state2)):
            fail(f"{label}: a second call gave other bits")
        want_y, want_state = ssd_scan_plain(x, dt, A, B, C, chunk)
        if not (torch.isfinite(want_y).all() and torch.isfinite(want_state).all()):
            fail(f"{label}: the plain version is not finite")
        err = max(check_close(f"{label} y", y, want_y, dtype, SSD_TOL),
                  check_close(f"{label} state", state, want_state, dtype, SSD_TOL))
        # float32's precision: against the plain version in float64, the
        # kernel's error at most TF32_FACTOR times the float32 plain version's
        # (one TF32 rounding a product is 20 to 1000 times it)
        exact = ssd_scan_plain(*(t.double() for t in (x, dt, A, B, C)), chunk)
        f64_err, plain_f64_err = {}, {}
        for what, got, plain, want in (("y", y, want_y, exact[0]),
                                       ("state", state, want_state, exact[1])):
            f64_err[what] = _rel_max(got, want)
            plain_f64_err[what] = _rel_max(plain, want)
            if not f64_err[what] <= TF32_FACTOR * plain_f64_err[what]:
                fail(f"{label} {what}: error {f64_err[what]:.3e} of the largest value "
                     f"against float64, beyond {TF32_FACTOR:g} x the float32 plain "
                     f"version's {plain_f64_err[what]:.3e}")
        del exact
        own = {_instance(e.key): e.count for e in
               _kernel_rows(lambda: ssd_scan(x, dt, A, B, C, chunk=chunk), 1)}
        if own != {f"ssd_scan_kernel_tf32<{n}>": 1}:
            fail(f"{label}: a call launched {own}")
        rec = dict(kernel="ssd_scan", dtype=str(dtype), case=case, route="3xTF32 mma.sync",
                   heads_per_block=heads, kernel_instances=own,
                   shape=dict(b=b, s=s, h=h, p=p, n=n, chunk=chunk, strided=True),
                   tolerance=SSD_TOL[dtype], max_abs_err=err,
                   rel_err={"y": _rel_max(y, want_y), "state": _rel_max(state, want_state)},
                   rel_err_float64=f64_err, plain_rel_err_float64=plain_f64_err,
                   float64_factor=TF32_FACTOR, second_call="bit for bit")
        if timed:
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
            n_bytes = (x.numel() + B.numel() + C.numel() + y.numel()) * 4 + \
                dt.numel() * 4 + state.numel() * 4
            flops = _ssd_flops(b, s, h, p, n, chunk)
            b_ms, b_by = bound(n_bytes, flops, dtype)
            tf32_ms, tf32_by = bound_3xtf32(n_bytes, flops)
            # no single PyTorch call computes an SSD scan: no library time
            rec.update(time_ms=ms, call_ms=call_ms, bound_ms=b_ms, bound_by=b_by,
                       bound_3xtf32_ms=tf32_ms, bound_3xtf32_by=tf32_by, flops=flops,
                       plain_ms=plain_ms, library_ms=None)
            if record is None:
                # the kernel runs 3xTF32 on the tensor cores: that is its bound
                record = {"name": "ssd_scan_tf32", **KERNEL_INFO["ssd_scan_tf32"],
                          "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                          "bound_ms": tf32_ms, "bound_by": tf32_by,
                          "bound_fp32_fma_ms": b_ms, "library_ms": None}
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
    if device == "cuda" and eng.decode_graph._graph is None:
        fail("parity: the engine on the card holds no captured decode graph")
    return trace, sum(r.preemptions for r in reqs)


def _to_cuda(tree):
    return {k: _to_cuda(v) if isinstance(v, dict) else v.cuda() for k, v in tree.items()}


def _parity(cfg, label: str, prompt_lens, kernels) -> None:
    """Serve the same prompts with the same float32 parameters on the card
    and on the CPU: every slot's next token must agree after every step,
    through a preempt-and-restore cycle, and the card's run must have
    launched each of ``kernels``."""
    gen = torch.Generator(device="cpu")
    gen.manual_seed(1)
    params_cpu = Model(cfg).init(gen, dtype=torch.float32, device="cpu")
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, cfg.vocab_size, size=(n,), dtype=np.int32)
               for n in prompt_lens]
    before = decode_graph.read_counts()
    gpu_trace, gpu_preempt = _parity_run(cfg, _to_cuda(params_cpu), "cuda", prompts)
    counts = decode_graph.named_counts(
        decode_graph.count_delta(before, decode_graph.read_counts()))
    launched = {name: counts[f"{name}.launches"] for name in kernels}
    cpu_trace, cpu_preempt = _parity_run(cfg, params_cpu, "cpu", prompts)
    if min(launched.values()) == 0:
        fail(f"parity ({label}): the engine on the card did not launch "
             f"{', '.join(kernels)}: {launched}")
    if cfg.arch_type == "vlm" and \
            counts["flash_prefill.prefix_launches"] != counts["flash_prefill.launches"]:
        fail(f"parity ({label}): every VLM prefill carries the vision prefix: {counts}")
    if cfg.arch_type == "audio":
        # a prefill: the encoder's and the cross-attention's launches full,
        # the decoder's self-attention causal
        prefills, rest = divmod(counts["flash_prefill.launches"], prefill_attention_calls(cfg))
        if rest or prefills < len(prompt_lens) or counts["flash_prefill.full_launches"] != \
                prefills * (cfg.n_enc_layers + cfg.n_layers):
            fail(f"parity ({label}): the encoder and cross prefills must be full, the "
                 f"rest causal: {counts}")
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


def _knobs_run(cfg, params, device, prompts):
    """Serve ``prompts`` with ``prefill_chunk=8, prefix_cache_entries=8``, the
    first alone (so that it is cached before the others arrive); returns
    every slot's next token after every step and the cache's hit counts."""
    eng = Engine(cfg, params=params, max_slots=3, max_len=96, dtype=torch.float32,
                 device=device, prefill_chunk=8, prefix_cache_entries=8)
    reqs = []
    for toks in prompts:
        r = make_interactive(len(toks), 8)
        r.prompt_tokens = toks
        reqs.append(r)
    trace = []
    for wave in (reqs[:1], reqs[1:]):
        for r in wave:
            eng.submit(r)
        while eng.waiting or eng.n_active:
            eng.step()
            trace.append([s.token for s in eng.slots])
    if any(r.state.value != "finished" for r in reqs):
        fail(f"parity (knobs): not every request finished on {device}")
    pc = eng.prefix_cache
    return trace, {"hits": pc.hits, "misses": pc.misses, "hit_tokens": pc.hit_tokens}


def _parity_knobs(arch: str) -> None:
    """A transformer smoke engine (dense or moe) with the reference's
    serving knobs, card against CPU: prompts sharing a 20-token prefix,
    prefilled from the prefix cache in chunks of 8 (``flash_prefill`` with
    ``q_offset > 0``)."""
    cfg = get_smoke_config(arch).with_(head_dim=64)
    gen = torch.Generator(device="cpu")
    gen.manual_seed(3)
    params_cpu = Model(cfg).init(gen, dtype=torch.float32, device="cpu")
    rng = np.random.default_rng(11)
    shared = rng.integers(0, cfg.vocab_size, size=(20,), dtype=np.int32)
    prompts = [np.concatenate([shared, rng.integers(0, cfg.vocab_size, size=(n,),
                                                    dtype=np.int32)])
               for n in (5, 17, 3, 11, 1)]
    before = decode_graph.read_counts()
    gpu_trace, gpu_hits = _knobs_run(cfg, _to_cuda(params_cpu), "cuda", prompts)
    launched = decode_graph.named_counts(
        decode_graph.count_delta(before, decode_graph.read_counts()))
    cpu_trace, cpu_hits = _knobs_run(cfg, params_cpu, "cpu", prompts)
    if gpu_trace != cpu_trace:
        first = next((i for i, (a, b) in enumerate(zip(gpu_trace, cpu_trace)) if a != b),
                     min(len(gpu_trace), len(cpu_trace)))
        fail(f"parity (knobs): tokens differ at step {first}")
    if gpu_hits != cpu_hits or gpu_hits["hits"] < len(prompts) - 1:
        fail(f"parity (knobs): prefix cache card {gpu_hits}, cpu {cpu_hits}")
    if launched["flash_prefill.offset_launches"] == 0 or \
            launched["paged_attention.launches"] == 0:
        fail(f"parity (knobs): no flash_prefill launch with q_offset > 0: {launched}")
    emit("parity", config=f"{arch} smoke, head_dim=64, float32, prefill_chunk=8, "
         "prefix_cache_entries=8", prompt_lens=[len(p) for p in prompts],
         steps=len(gpu_trace), prefix_cache=gpu_hits, tokens_agree=True,
         kernel_launches=launched)


# logits of the model-level checks, card against CPU: float32 on both, the
# sums of two layers in other orders (each kernel is within 2e-4 of its plain
# version)
MODEL_TOL = 2e-3


def _model_steps(model, params, batch, tokens, cap):
    """``Model.prefill`` of ``batch`` into a paged cache of ``cap`` positions,
    then one decode step per column of ``tokens`` (B, n); the logits of
    each, on the CPU."""
    logits, cache = model.prefill(params, batch, cache_len=cap, dtype=torch.float32)
    out = [logits.cpu()]
    for i in range(tokens.shape[1]):
        logits, cache = model.decode_step(params, tokens[:, i:i + 1], cache)
        out.append(logits.cpu())
    return out


def _parity_model(cfg, label, batch, prompt: int, steps: int, counter: str) -> None:
    """``Model.forward`` and ``Model.prefill`` of the first ``prompt`` tokens
    of ``batch`` followed by ``steps`` decode steps, float32, on the card
    and on the CPU with the same parameters: the card's logits within
    ``MODEL_TOL`` of the CPU's and its greedy tokens the same; each step's
    logits within the reference's prefill-vs-decode tolerance (5e-3) of the
    forward's at that position. ``counter`` must have moved on the card."""
    gen = torch.Generator(device="cpu")
    gen.manual_seed(4)
    model = Model(cfg)
    params_cpu = model.init(gen, dtype=torch.float32, device="cpu")
    params_gpu = _to_cuda(params_cpu)
    gpu_batch = {k: v.cuda() for k, v in batch.items()}
    head = {k: v[:, :prompt] if k == "tokens" else v for k, v in batch.items()}
    toks = batch["tokens"][:, prompt:prompt + steps]
    cap = batch["tokens"].shape[1] + cfg.n_vision_tokens + 8
    with torch.no_grad():
        full_cpu, _ = model.forward(params_cpu, batch)
        cpu = _model_steps(model, params_cpu, head, toks, cap)
        before = decode_graph.read_counts()
        full_gpu, _ = model.forward(params_gpu, gpu_batch)
        gpu = _model_steps(model, params_gpu, {k: v.cuda() for k, v in head.items()},
                           toks.cuda(), cap)
        torch.cuda.synchronize()
    counts = decode_graph.named_counts(
        decode_graph.count_delta(before, decode_graph.read_counts()))
    if counts[counter] == 0 or counts["paged_attention.launches"] == 0:
        fail(f"parity ({label}): the card's run did not launch {counter} and "
             f"paged_attention: {counts}")
    tol = {torch.float32: MODEL_TOL}
    err = check_close(f"parity ({label}) forward", full_gpu.cpu(), full_cpu,
                      torch.float32, tol)
    for i, (g, c) in enumerate(zip(gpu, cpu)):
        err = max(err, check_close(f"parity ({label}) step {i}", g, c, torch.float32, tol))
        if g.argmax(-1).tolist() != c.argmax(-1).tolist():
            fail(f"parity ({label}): greedy tokens differ at step {i}")
        check_close(f"parity ({label}) step {i} against the forward", g,
                    full_gpu[:, prompt - 1 + i].cpu(), torch.float32,
                    {torch.float32: 5e-3})
    emit("parity", config=label, prompt=prompt, decode_steps=steps,
         tolerance=MODEL_TOL, max_abs_err=err, greedy_tokens_agree=True,
         kernel_launches={k: v for k, v in counts.items() if v})


def phase_parity() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _parity(get_smoke_config("llama-8b").with_(head_dim=64),
            "llama-8b smoke, head_dim=64, float32", (9, 23, 17, 30, 5),
            ("paged_attention", "flash_prefill"))
    # the new dense and VLM configs at their kernels' widths: head_dim 96,
    # group 7, a nonparametric LayerNorm, the vision prefix (zero embeddings,
    # as the engine feeds)
    for arch, head_dim, what in (("phi3-mini-3.8b", 96, "head_dim=96"),
                                 ("yi-34b", 64, "head_dim=64, group 7"),
                                 ("olmo-1b", 64, "head_dim=64, nonparametric LN"),
                                 ("internvl2-2b", 64, "head_dim=64, 16 vision tokens")):
        _parity(get_smoke_config(arch).with_(head_dim=head_dim),
                f"{arch} smoke, {what}, float32", (9, 23, 17, 30, 5),
                ("paged_attention", "flash_prefill"))
    # random vision embeddings: zero ones leave the prefix rows zero and would
    # hide a wrong prefix mask
    cfg = get_smoke_config("internvl2-2b").with_(head_dim=64)
    gen = torch.Generator().manual_seed(5)
    batch = Model(cfg).example_batch(2, 24, gen, dtype=torch.float32, device="cpu")
    _parity_model(cfg, "internvl2-2b smoke, head_dim=64, random vision embeddings",
                  batch, 21, 3, "flash_prefill.prefix_launches")
    # a window of 8 under a 30-token prompt, decoded 10 steps past it
    cfg = get_smoke_config("llama-8b").with_(head_dim=64, sliding_window=8)
    toks = torch.from_numpy(np.random.default_rng(6).integers(
        0, cfg.vocab_size, (2, 40))).long()
    _parity_model(cfg, "llama-8b smoke, head_dim=64, sliding_window=8",
                  {"tokens": toks}, 30, 10, "flash_prefill.window_launches")
    # one prompt over three chunks of 32 (the state carried between chunks),
    # one shorter than the conv window
    _parity(get_smoke_config("mamba2-1.3b"), "mamba2-1.3b smoke, float32",
            (9, 70, 17, 30, 2), ("ssd_scan",))
    _parity_knobs("llama-8b")
    # the MoE arm: both smoke configs (no drops), and qwen2-moe at capacity
    # factor 1.0, whose prefills of up to 30 tokens drop assignments (the
    # drop order, on the card)
    for arch in ("qwen2-moe-a2.7b", "deepseek-moe-16b"):
        _parity(get_smoke_config(arch).with_(head_dim=64),
                f"{arch} smoke, head_dim=64, float32", (9, 23, 17, 30, 5),
                ("paged_attention", "flash_prefill"))
    cfg = get_smoke_config("qwen2-moe-a2.7b")
    _parity(cfg.with_(head_dim=64, moe=dataclasses.replace(cfg.moe, capacity_factor=1.0)),
            "qwen2-moe-a2.7b smoke, head_dim=64, capacity factor 1.0 (drops), float32",
            (9, 23, 17, 30, 5), ("paged_attention", "flash_prefill"))
    _parity_knobs("qwen2-moe-a2.7b")
    # zamba2 at the widths its kernels take on the card (D 80, SSM N 64 /
    # P 64), then with a window of 8 under a 30-token prompt, decoded 10
    # steps past it
    cfg = get_smoke_config("zamba2-2.7b")
    cfg = cfg.with_(head_dim=80, ssm=dataclasses.replace(cfg.ssm, state_dim=64,
                                                         head_dim=64))
    _parity(cfg, "zamba2-2.7b smoke, head_dim=80, SSM N 64 / P 64, float32",
            (9, 70, 17, 30, 2), ("paged_attention", "flash_prefill", "ssd_scan"))
    toks = torch.from_numpy(np.random.default_rng(8).integers(
        0, cfg.vocab_size, (2, 40))).long()
    _parity_model(cfg.with_(sliding_window=8),
                  "zamba2-2.7b smoke, head_dim=80, SSM N 64 / P 64, sliding_window=8",
                  {"tokens": toks}, 30, 10, "flash_prefill.window_launches")
    # whisper-base at full width (1500 encoder frames, 94 cross pages a
    # slot; zero frames, as the engine feeds)
    _parity(get_config("whisper-base"), "whisper-base full width, float32",
            (9, 23, 17, 30, 5), ("paged_attention", "flash_prefill"))


def attention_layers(cfg) -> int:
    """The decode step's attention calls: each launches ``paged_attention``
    once (a hybrid's calls of its shared block; an audio model's self- and
    cross-attention; none in an ssm model)."""
    if cfg.arch_type == "ssm":
        return 0
    if cfg.arch_type == "audio":
        return 2 * cfg.n_layers
    return cfg.n_layers // cfg.attn_every if cfg.arch_type == "hybrid" else cfg.n_layers


def prefill_attention_calls(cfg) -> int:
    """A prefill's ``flash_prefill`` launches: one an attention call of the
    model (an audio model's encoder layers besides its decoder's self- and
    cross-attention)."""
    if cfg.arch_type == "audio":
        return cfg.n_enc_layers + 2 * cfg.n_layers
    return attention_layers(cfg)


def _graph_check(arch: str) -> None:
    """One eager ``model.decode_step`` against one replay of the engine's
    captured graph, at full width in bf16, from one pool state with a mix of
    active and free slots (one freed mid-run, three never used): the eager
    step runs on a copy of the pool, the replay on the engine's own. Logits,
    ``pos`` and the written state bit for bit, and every other element of
    the K/V pools bit-identical to the state before."""
    gc.collect()
    torch.cuda.empty_cache()
    cfg = get_config(arch)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    eng = Engine(cfg, gen=gen, max_slots=8, max_len=1024, dtype=torch.bfloat16,
                 device="cuda")
    g = eng.decode_graph
    rng = np.random.default_rng(4)
    for n, out in ((30, 20), (200, 3), (7, 20), (341, 20), (2, 20)):
        r = make_interactive(n, out)
        r.prompt_tokens = rng.integers(0, cfg.vocab_size, size=(n,), dtype=np.int32)
        eng.submit(r)
    for _ in range(6):
        eng.step()
    tokens = [s.token if s.active else 0 for s in eng.slots]
    active = [s.active for s in eng.slots]
    if sum(active) != 4 or active[1]:
        fail(f"graph {arch}: meant to check 4 active slots and 4 free, got {active}")
    before = {k: v.clone() for k, v in eng.pool.items()}
    scratch = {k: v.clone() for k, v in eng.pool.items()}
    with torch.no_grad():
        want, cache = eng.model.decode_step(
            eng.params, torch.tensor(tokens, device="cuda")[:, None], scratch,
            torch.tensor(active, device="cuda"))
    counts = decode_graph.read_counts()
    next_tok = g.run(tokens, active)
    replayed = decode_graph.named_counts(
        decode_graph.count_delta(counts, decode_graph.read_counts()))
    torch.cuda.synchronize()
    bf16 = torch.bfloat16
    errs = {"logits": check_close(f"graph {arch} logits", g.logits, want, bf16)}
    if next_tok.tolist() != torch.argmax(g.logits, -1).tolist():
        fail(f"graph {arch}: next tokens are not the argmax of the static logits")
    pos = before["pos"] + torch.tensor(active, device="cuda").int()
    if not (torch.equal(eng.pool["pos"], pos) and torch.equal(cache["pos"], pos)):
        fail(f"graph {arch}: pos {eng.pool['pos'].tolist()}, eager "
             f"{cache['pos'].tolist()}, want {pos.tolist()}")
    if "k" in eng.pool:
        rows = [b for b, a in enumerate(active) if a]
        p = before["pos"][rows].long()
        pages = eng.pool["block_tables"][rows].long().gather(1, (p // 16)[:, None])[:, 0]
        offs = p % 16
        for key in ("k", "v"):
            errs[key] = check_close(f"graph {arch} written {key}",
                                    eng.pool[key][:, pages, offs],
                                    scratch[key][:, pages, offs], bf16)
            for name, t in (("replay", eng.pool[key]), ("eager", scratch[key])):
                rest, old = t.clone(), before[key].clone()
                rest[:, pages, offs] = 0
                old[:, pages, offs] = 0
                if not torch.equal(rest, old):
                    fail(f"graph {arch}: the {name} step changed {key} outside the "
                         "rows it writes")
        if not torch.equal(eng.pool["block_tables"], before["block_tables"]):
            fail(f"graph {arch}: the block tables changed")
    for key in ("cross_k", "cross_v", "cross_block_tables"):
        if key in eng.pool and not (torch.equal(eng.pool[key], before[key]) and
                                    torch.equal(scratch[key], before[key])):
            fail(f"graph {arch}: a decode step changed {key}, which it only reads")
    if "ssm" in eng.pool:
        for key in ("ssm", "conv"):
            errs[key] = check_close(f"graph {arch} {key}", eng.pool[key], scratch[key],
                                    bf16)
    if replayed["paged_attention.launches"] != attention_layers(cfg):
        fail(f"graph {arch}: a replay counted {replayed}")
    if any(e != 0.0 for e in errs.values()):
        fail(f"graph {arch}: the replay and the eager step differ: {errs}")
    emit("graph", model=cfg.name, dtype="bfloat16", max_slots=8, max_len=1024,
         active=active, tolerance=TOL[bf16], max_abs_err=errs, pos_equal=True,
         bit_identical=True,
         # the ssm step advances every row's state, free rows too
         **({"unwritten_kv_bit_identical": True} if "k" in eng.pool else {}),
         replay_counted=replayed, capture_s=g.capture_s,
         graph_pool_bytes=g.graph_pool_bytes, warmup_steps=decode_graph.WARMUP_STEPS,
         gpu=torch.cuda.get_device_name(0))
    eng.close()
    del eng, before, scratch, g


def phase_graph() -> None:
    _graph_check("llama-8b")
    _graph_check("phi3-mini-3.8b")     # head_dim 96
    _graph_check("mamba2-1.3b")
    _graph_check("qwen2-moe-a2.7b")    # the MoE dispatch under the graph
    _graph_check("zamba2-2.7b")        # head_dim 80, 9 shared-block calls
    _graph_check("whisper-base")       # self- and cross-attention, D 64


def _instance(key: str) -> str:
    """A profiler kernel name as its template instance, e.g.
    ``ssd_scan_kernel_wgmma<64>``: without namespace, casts of template
    arguments, return type and parameters."""
    key = re.sub(r"\(anonymous namespace\)::|<unnamed>::|\((?:unsigned )?\w+\)(?=-?\d)",
                 "", key)
    return key.removeprefix("void ").split("(")[0].strip()


def _profiled(fn, reps: int) -> dict:
    """Run ``fn`` ``reps`` times under torch.profiler (a complete session,
    ``_kernel_rows``) and return, per run, the device-busy time (sum of the
    kernels' own times), the number of kernel launches and the busiest
    kernels. Profiling slows the host, so wall times are taken in a
    separate, unprofiled window."""
    kernels = _kernel_rows(fn, reps)
    top = sorted(((e.key, _device_us(e) / reps / 1e3) for e in kernels),
                 key=lambda kv: -kv[1])
    own = ("paged_attention_", "flash_prefill_kernel", "flash_prefill_bwd",
           "ssd_scan_kernel", "ssd_scan_bwd")
    short = lambda k: k.split("<")[0].split("::")[-1]  # noqa: E731
    return {"device_ms": sum(ms for _, ms in top),
            "launches": sum(e.count for e in kernels) / reps,
            "own_kernels_ms": {short(k): round(ms, 4)
                               for k, ms in top if any(o in k for o in own)},
            "own_kernel_launches": {short(e.key): e.count / reps for e in kernels
                                    if any(o in e.key for o in own)},
            # by template instance, e.g. "ssd_scan_kernel_wgmma<64>"
            "own_instance_launches": {_instance(e.key): e.count / reps
                                      for e in kernels if any(o in e.key for o in own)},
            "top_ms": [[k[:60], round(ms, 4)] for k, ms in top[:6]]}


def _wall_ms(fn, reps: int) -> float:
    torch.cuda.synchronize()
    t0 = time.monotonic()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.monotonic() - t0) * 1e3 / reps


# times the graphed and the eager decode step are profiled before their
# device-busy times must agree
PROFILE_ATTEMPTS = 3


def _where_the_time_goes(eng, steps: int = 8, prompt: int = 337) -> dict:
    """Host (wall) time beside device-busy time of one decode step at a full
    slot pool, graphed (``eng.step``, a replay) and eager (the model's
    ``decode_step``, argmax and the copy to the host, as the engine ran it
    before the graph, on a copy of the pool), and of one prefill: how far the
    host holds the card back. ``prompt`` is a length near the longest the
    serve phase admits (341) that its run has most likely not seen, so the
    first call shows what a new prompt length costs on top of the steady
    time. The requests' outputs outlast every profiler session
    ``_kernel_rows`` may run, so each profiled step decodes all slots. A
    replay runs the eager step's kernels on the same data (and five small
    ones), so their device-busy times agree (within 3.4 % on every path
    measured); a session can pass ``_kernel_rows``' count check and still
    misreport every duration (on the H100 once halved, all of a graphed
    step's kernels), so both are profiled again, up to ``PROFILE_ATTEMPTS``
    times, until they agree within 10 %. Fails unless they do, and unless the
    profiler sees one ``paged_attention`` kernel an attention layer in a
    replayed step (a hybrid's: one a call of its shared block)."""
    worst = 3 + steps + PROFILE_ATTEMPTS * 6 * (steps + 1)   # eng.step calls
    for _ in range(eng.max_slots):
        eng.submit(make_interactive(64, worst + 8))
    eng.set_max_batch_size(eng.max_slots)
    for _ in range(3):
        eng.step()
    # the positions the wall-timed steps attend over, for the planner's KV term
    ctx0 = float(np.mean(eng._pos))
    out = {"decode_wall_ms_per_step": _wall_ms(eng.step, steps),
           "decode_mean_context": ctx0 + (steps + 1) / 2}
    scratch = {k: v.clone() for k, v in eng.pool.items()}
    tok = torch.tensor([s.token for s in eng.slots], device=eng.device)[:, None]
    act = torch.ones((eng.max_slots,), dtype=torch.bool, device=eng.device)

    @torch.no_grad()
    def eager():
        logits, _ = eng.model.decode_step(eng.params, tok, scratch, act)
        torch.argmax(logits, -1).cpu()

    eager()
    out["eager_decode_wall_ms_per_step"] = _wall_ms(eager, steps)
    disagreed = []
    for _ in range(PROFILE_ATTEMPTS):
        prof = _profiled(eng.step, steps)
        eager_prof = _profiled(eager, steps)
        if abs(prof["device_ms"] / eager_prof["device_ms"] - 1) <= 0.1:
            break
        disagreed.append([prof["device_ms"], eager_prof["device_ms"]])
    else:
        fail(f"{eng.cfg.name}: the graphed and eager decode steps' device-busy times "
             f"never agreed within 10 % (ms, graphed and eager): {disagreed}")
    out["profiles_disagreeing"] = disagreed
    del scratch
    while eng.waiting or eng.n_active:
        eng.step()
    want = attention_layers(eng.cfg)
    for name, p in (("graphed", prof), ("eager", eager_prof)):
        n = p["own_kernel_launches"].get("paged_attention_kernel", 0)
        if n != want:
            fail(f"{eng.cfg.name}: the profiler saw {n} paged_attention kernels "
                 f"in one {name} decode step, not {want}")
    out["eager_decode_device_ms_per_step"] = eager_prof["device_ms"]
    out["eager_decode_launches_per_step"] = eager_prof["launches"]
    out["eager_decode_own_kernel_launches_per_step"] = eager_prof["own_kernel_launches"]
    out["eager_decode_device_idle_share"] = \
        1.0 - eager_prof["device_ms"] / out["eager_decode_wall_ms_per_step"]
    out["capture_s"] = eng.decode_graph.capture_s
    out["graph_pool_bytes"] = eng.decode_graph.graph_pool_bytes

    # as the engine prefills it: a VLM's prompt behind zero vision embeddings
    batch = eng._prompt_batch(np.random.default_rng(9).integers(
        0, eng.cfg.vocab_size, size=(prompt,), dtype=np.int32))

    @torch.no_grad()
    def prefill():
        eng.model.prefill(eng.params, batch, dtype=eng.dtype)

    out["prefill_tokens"] = prompt
    out["prefill_first_call_wall_ms"] = _wall_ms(prefill, 1)
    out["prefill_wall_ms"] = _wall_ms(prefill, 3)
    pre = _profiled(prefill, 2)
    for name, p in (("decode", prof), ("prefill", pre)):
        unit = "_per_step" if name == "decode" else ""
        out[f"{name}_device_ms{unit}"] = p["device_ms"]
        out[f"{name}_launches{unit}"] = p["launches"]
        out[f"{name}_own_kernels_ms{unit}"] = p["own_kernels_ms"]
        out[f"{name}_own_kernel_launches{unit}"] = p["own_kernel_launches"]
        out[f"{name}_own_instance_launches{unit}"] = p["own_instance_launches"]
        out[f"{name}_top_device_ms{unit}"] = p["top_ms"]
    out["decode_device_idle_share"] = \
        1.0 - prof["device_ms"] / out["decode_wall_ms_per_step"]
    out["prefill_device_idle_share"] = 1.0 - pre["device_ms"] / out["prefill_wall_ms"]
    return out


def _expected_launches(cfg, res) -> dict:
    """Each kernel's launches that a serve run of ``cfg`` implies: one
    ``paged_attention`` an attention layer of every decode step (the
    engine's warm-up steps before its capture included), one
    ``flash_prefill`` an attention layer and one ``ssd_scan`` a Mamba2 layer
    of every prefill."""
    steps = res["decode_steps"] + decode_graph.WARMUP_STEPS
    want = {}
    if attention_layers(cfg):
        want["paged_attention"] = steps * attention_layers(cfg)
        want["flash_prefill"] = res["prefills"] * prefill_attention_calls(cfg)
    if cfg.arch_type in ("ssm", "hybrid"):
        want["ssd_scan"] = res["prefills"] * cfg.n_layers
    return want


def _serve_path(smi: str, arch: str):
    """Serve ``arch`` at full width through ``launch.serve``'s loop with
    every kernel's launch counter set to 0 just before and read just after,
    against what the run implies (``_expected_launches``). Returns the
    launches, the engine and what ``_where_the_time_goes`` measured of it."""
    gc.collect()
    torch.cuda.empty_cache()
    resident_gb = torch.cuda.memory_allocated() / 1e9
    cfg = get_config(arch)
    n_requests, max_output = 24, 64
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
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
    want = _expected_launches(cfg, res)
    got = {name: launches[name] for name in want}
    if got != want or min(got.values()) == 0:
        fail(f"serve {arch}: kernel launches {launches}, the run implies {want}")
    # bf16 prefills must go through the tensor-core kernels, every one of them
    for name, n in tensor_core_launches.items():
        if n != launches[name]:
            fail(f"serve {arch}: {launches[name]} {name} launches, {n} of them on "
                 "the tensor-core kernel")
    if cfg.arch_type == "vlm" and flash_prefill.prefix_launches != launches["flash_prefill"]:
        fail(f"serve {arch}: {flash_prefill.prefix_launches} of "
             f"{launches['flash_prefill']} prefill launches carried the vision prefix")
    if cfg.sliding_window and flash_prefill.window_launches != launches["flash_prefill"]:
        fail(f"serve {arch}: {flash_prefill.window_launches} of "
             f"{launches['flash_prefill']} prefill launches carried the window")
    full_launches = flash_prefill.full_launches
    want_full = res["prefills"] * (cfg.n_enc_layers + cfg.n_layers) \
        if cfg.arch_type == "audio" else 0
    if full_launches != want_full:
        fail(f"serve {arch}: {full_launches} full (non-causal) prefill launches, the "
             f"run implies {want_full}")
    window_launches = flash_prefill.window_launches

    if any(t.device.type != "cuda" for t in [*_leaves(eng.params), *_leaves(eng.pool)]):
        fail(f"serve {arch}: a parameter or pool tensor lives on the CPU")
    for r in res["requests"]:
        if r.tokens_generated < min(r.output_len, 1) or r.first_token_time is None:
            fail(f"serve {arch}: a finished request generated no token")
    itl = np.asarray(res["itl_s"])
    ttft = np.asarray(res["ttft_s"])
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    share = _where_the_time_goes(eng)
    peak_all_gb = torch.cuda.max_memory_allocated() / 1e9
    # the instances a prefill of this path launches: zamba2's through the
    # masked D = 80 one (its config has a window) and the SSD scan at N 64
    want_instances = {
        "zamba2-2.7b": {"flash_prefill_kernel_wgmma<80, 1, 0>": attention_layers(cfg),
                        "ssd_scan_kernel_wgmma<64>": cfg.n_layers},
        "mamba2-1.3b": {"ssd_scan_kernel_wgmma<128>": cfg.n_layers},
        "whisper-base": {"flash_prefill_kernel_wgmma<64, 0, 0>": prefill_attention_calls(cfg)},
    }.get(arch, {})
    for inst, n in want_instances.items():
        seen = share["prefill_own_instance_launches"].get(inst)
        if seen != n:
            fail(f"serve {arch}: the profiled prefill launched {inst} {seen} times, "
                 f"not {n}: {share['prefill_own_instance_launches']}")
    if cfg.arch_type != "ssm":
        share["planner"] = _planner_row(cfg, share)
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
         peak_device_memory_gb=peak_gb, peak_with_timing_gb=peak_all_gb,
         device_total_memory_gb=torch.cuda.get_device_properties(0).total_memory / 1e9,
         resident_before_gb=resident_gb, kernel_launches=launches,
         prefix_launches=flash_prefill.prefix_launches,
         window_launches=window_launches, full_launches=full_launches,
         tensor_core_launches=tensor_core_launches, **share)
    return got, eng, share


def _planner_row(cfg, share: dict) -> dict:
    """What ``PerfModel`` plans for the graphed decode step just measured (8
    slots at its mean context, one card: yi-34b's two-card planning size is
    a headroom rule, not what ran) beside it, and the bytes the step streams:
    the weights and the KV of its contexts. MBU and STEP_OVERHEAD of
    ``sim/perf_model.py`` are fitted to these rows (``_fit_planner``)."""
    pm = PerfModel(cfg.name, chips=1)
    ctx = share["decode_mean_context"]
    kv_bytes = 8 * ctx * pm._kv_per_tok
    return {"weight_bytes": pm.weight_bytes, "kv_bytes": kv_bytes,
            "mean_context": ctx, "slots": 8,
            "planned_ms": pm.itl(8, ctx) * 1e3,
            "measured_device_ms": share["decode_device_ms_per_step"],
            "measured_wall_ms": share["decode_wall_ms_per_step"]}


def _fit_planner(rows: dict) -> dict:
    """``MBU`` and ``STEP_OVERHEAD`` from the graphed decode steps of the
    dense models: MBU by least squares on the relative error of the
    device-busy time, t_i = bytes_i / (MBU x HBM_BW), which weighs every
    model alike (r_i = bytes_i / (HBM_BW t_i); MBU = sum r_i^2 / sum r_i);
    STEP_OVERHEAD the median of wall minus device-busy time."""
    from repro_torch.sim import perf_model
    r = np.asarray([(row["weight_bytes"] + row["kv_bytes"]) / perf_model.HBM_BW /
                    (row["measured_device_ms"] / 1e3) for row in rows.values()])
    gaps = [(row["measured_wall_ms"] - row["measured_device_ms"]) / 1e3
            for row in rows.values()]
    return {"models": list(rows), "per_model_bandwidth_share": dict(zip(rows, r.tolist())),
            "MBU": float((r ** 2).sum() / r.sum()),
            "STEP_OVERHEAD_s": float(np.median(gaps)),
            "module_MBU": perf_model.MBU,
            "module_STEP_OVERHEAD_s": perf_model.STEP_OVERHEAD}


def _serve_prefix(smi: str, params) -> dict:
    """llama-8b at full width with the reference's serving knobs
    (``prefix_cache_entries=8, prefill_chunk=128``) on the serve phase's
    weights: 24 requests, all submitted at once, share a 256-token prefix
    and end in 1-85 tokens of their own (prompts <= 341). Counters set to 0
    just before and read just after. Fails unless every request finished,
    every request after the first reused the prefix, and every
    ``flash_prefill`` launch (those with ``q_offset > 0`` among them) went
    to the tensor-core kernel."""
    cfg = get_config("llama-8b")
    n_requests, max_output, prefix = 24, 64, 256
    rng = np.random.default_rng(12)
    shared = rng.integers(0, cfg.vocab_size, size=(prefix,), dtype=np.int32)
    reqs = []
    for n in rng.integers(1, 86, size=n_requests):
        r = make_interactive(prefix + int(n), max_output)
        r.prompt_tokens = np.concatenate(
            [shared, rng.integers(0, cfg.vocab_size, size=(int(n),), dtype=np.int32)])
        reqs.append(r)
    zero_counts()
    eng = Engine(cfg, params=params, max_slots=8, max_len=1024, dtype=torch.bfloat16,
                 device="cuda", prefix_cache_entries=8, prefill_chunk=128)
    t0 = time.monotonic()
    for r in reqs:
        eng.submit(r)
    decode_steps, itl = 0, []
    while eng.waiting or eng.n_active:
        stats = eng.step()
        if stats.n_active:
            decode_steps += 1
            itl.append(stats.itl)
    wall = time.monotonic() - t0
    counts = decode_graph.named_counts(decode_graph.read_counts())
    pc = eng.prefix_cache
    # the first prompt misses and goes in chunks of 128; every other one
    # reuses at least the prefix, and its remainder (< 128) is one chunk
    first = -(-reqs[0].prompt_len // 128)
    want_fp = (first + n_requests - 1) * cfg.n_layers
    want_offset = (first - 1 + n_requests - 1) * cfg.n_layers
    want_paged = (decode_steps + decode_graph.WARMUP_STEPS) * cfg.n_layers
    if any(r.state.value != "finished" for r in reqs):
        fail("serve prefix: not every request finished")
    if pc.hits != n_requests - 1 or pc.hit_tokens < (n_requests - 1) * prefix:
        fail(f"serve prefix: {pc.hits} hits, {pc.hit_tokens} tokens reused")
    fp = counts["flash_prefill.launches"]
    if fp != want_fp or fp != counts["flash_prefill.tensor_core_launches"] or \
            counts["flash_prefill.offset_launches"] != want_offset:
        fail(f"serve prefix: flash_prefill launches {counts}, the run implies "
             f"{want_fp}, {want_offset} of them with q_offset > 0, all on the "
             "tensor-core kernel")
    if counts["paged_attention.launches"] != want_paged:
        fail(f"serve prefix: paged_attention launches {counts}, the run implies "
             f"{want_paged}")
    itl_a = np.asarray(itl)
    ttft = np.asarray([r.first_token_time - t0 for r in reqs])
    emit("serve", check="prefix cache + chunked prefill", gpu=smi, model=cfg.name,
         dtype="bfloat16", requests=n_requests, shared_prefix=prefix,
         prompt_lens=[r.prompt_len for r in reqs], max_output=max_output,
         prefix_cache_entries=8, prefill_chunk=128, hits=pc.hits, misses=pc.misses,
         hit_tokens=pc.hit_tokens, prefill_chunks=first + n_requests - 1,
         serve_loop_s=wall, decode_steps=decode_steps,
         tokens=sum(r.tokens_generated for r in reqs),
         tokens_per_s=sum(r.tokens_generated for r in reqs) / wall,
         ttft_mean_ms=float(ttft.mean() * 1e3), ttft_p50_ms=float(np.median(ttft) * 1e3),
         ttft_max_ms=float(ttft.max() * 1e3),
         itl_p50_ms=float(np.percentile(itl_a, 50) * 1e3),
         itl_p99_ms=float(np.percentile(itl_a, 99) * 1e3),
         capture_s=eng.decode_graph.capture_s, kernel_launches=counts)
    eng.close()
    return {"paged_attention": counts["paged_attention.launches"],
            "flash_prefill": fp}


# the serving paths at full width, in order: yi-34b last, alone on the card
SERVE_ARCHS = ("llama-8b", "phi3-mini-3.8b", "olmo-1b", "internvl2-2b", "mamba2-1.3b",
               "whisper-base",
               "qwen2-moe-a2.7b", "deepseek-moe-16b", "zamba2-2.7b", "yi-34b")


def phase_serve(smi: str):
    """Every serving path and the dense one with the serving knobs; returns
    each kernel's launches over its paths, and what the ``sim`` phase reads
    of the run: each path's ``_where_the_time_goes`` and the planner's fit. Each engine is closed and dropped
    before the next path builds its own, so that yi-34b's 68.78 GB of
    weights have the card to themselves. The planner's step is put beside
    every graphed one but the ssm's; its ``MBU`` and ``STEP_OVERHEAD`` are
    fitted to the dense and VLM models' only, as ``sim/perf_model.py``
    holds them (the MoE and hybrid rows are its predictions, not its
    data)."""
    launches = {"paged_attention": 0, "flash_prefill": 0, "ssd_scan": 0,
                "flash_prefill_backward": 0, "ssd_scan_backward": 0}
    planner, shares = {}, {}
    for arch in SERVE_ARCHS:
        got, eng, share = _serve_path(smi, arch)
        shares[arch] = share
        for name, n in got.items():
            launches[name] += n
        if arch == "llama-8b":
            for name, n in _serve_prefix(smi, eng.params).items():
                launches[name] += n
        if eng.cfg.arch_type != "ssm":
            planner[arch] = share["planner"]
        eng.close()
        del eng
    fitted = {arch: row for arch, row in planner.items()
              if get_config(arch).arch_type in ("dense", "vlm")}
    fit = _fit_planner(fitted)
    emit("perf_model", gpu=smi, rows=planner, fit=fit)
    return launches, {"shares": shares, "fit": fit}


# ------------------------------------------------------------ the cluster
def _cluster_trace(cfg, spec: WorkloadSpec, max_prompt: int, max_output: int):
    """``spec``'s requests with prompts and outputs capped, and explicit prompt
    tokens from a seed (so that every engine prefills the same tokens)."""
    reqs = generate(spec)
    rng = np.random.default_rng(spec.seed + 100)
    for r in reqs:
        r.prompt_len = int(min(r.prompt_len, max_prompt))
        r.output_len = int(min(r.output_len, max_output))
        r.prompt_tokens = rng.integers(0, cfg.vocab_size, size=(r.prompt_len,),
                                       dtype=np.int32)
    return reqs


def _cluster_replay(cfg, params, device):
    """The fp32 smoke cluster under ``ChironController`` on a shared fake
    clock; returns the recorder's log, the result and the requests."""
    cluster = RealCluster(cfg, max_chips=4, max_slots=3, max_len=64,
                          device=device, params=params)
    spec = WorkloadSpec(n_requests=24, arrival_rate=12.0, interactive_frac=0.7,
                        batch_queue_size=10, batch_ttft_slo=5.0, seed=7,
                        model="llama-8b")
    reqs = _cluster_trace(cfg, spec, 20, 15)
    clock = SharedClock(0.05)
    rec = ClusterRecorder(cluster, reqs, clock)
    out = serve_forever(reqs, ChironController(model="llama-8b", init_batch=2,
                                               max_batch=3),
                        cluster, clock=clock.advance, max_steps=1500)
    return rec.log, out, reqs


def _migration_tokens(cfg, params, steps: int, move: bool) -> list:
    """One request's next input token after every step on the card, beside
    two companions on two mixed instances. After ``steps`` steps it moves
    (``move``: ``RealCluster.migrate``) from the first instance to slot 1 of
    the second, or it stays and only takes input token 0 there, as a
    restored request does (the reference's rule), so that both runs feed it
    the same inputs."""
    cluster = RealCluster(cfg, max_chips=2, max_slots=3, max_len=96,
                          device="cuda", params=params)
    rng = np.random.default_rng(5)
    reqs = [make_batch(n, 30) for n in (21, 13, 34)]
    for r in reqs:
        r.prompt_tokens = rng.integers(0, cfg.vocab_size, size=(r.prompt_len,),
                                       dtype=np.int32)
    rec = ClusterRecorder(cluster, reqs)
    a = cluster.provision("llama-8b", InstanceType.MIXED, 0.0, static_batch=3)
    b = cluster.provision("llama-8b", InstanceType.MIXED, 0.0, static_batch=3)
    for inst in (a, b):
        inst.activate_if_ready(0.0)
    a.admit(reqs[0], 0.0)        # the request that moves
    a.admit(reqs[1], 0.0)        # a companion on the first instance
    b.admit(reqs[2], 0.0)        # one on the second: the mover gets slot 1
    for _ in range(steps):
        a.step(0.0)
        b.step(0.0)
    if move:
        if not cluster.migrate(reqs[0].req_id, a, b):
            fail("cluster: RealCluster.migrate refused a free slot")
        if reqs[0].state.value != "queued" or a.n_running != 1:
            fail("cluster: the migrated request did not leave its instance")
    else:
        next(s for s in a.engine.slots if s.request is reqs[0]).token = 0
    for _ in range(200):
        if all(r.state.value == "finished" for r in reqs):
            break
        a.step(0.0)
        b.step(0.0)
    if any(r.state.value != "finished" for r in reqs):
        fail("cluster: the migration run did not finish")
    return rec.tokens_of(0)


def _cluster_parity() -> None:
    """The llama-8b smoke cluster in float32 (head_dim 64, as the parity
    phase) under ``ChironController`` on a shared fake clock, on the card and
    on the CPU: the same decisions and the same token after every step for
    every request. Then one request migrated mid-generation on the card
    keeps the tokens of a run without the move."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_smoke_config("llama-8b").with_(head_dim=64)
    gen = torch.Generator(device="cpu")
    gen.manual_seed(2)
    params_cpu = Model(cfg).init(gen, dtype=torch.float32, device="cpu")
    params_gpu = _to_cuda(params_cpu)
    before = {name: KERNELS[name].launches for name in ATTENTION_KERNELS}
    gpu_log, gpu_out, gpu_reqs = _cluster_replay(cfg, params_gpu, "cuda")
    launched = {name: KERNELS[name].launches - before[name] for name in ATTENTION_KERNELS}
    cpu_log, cpu_out, _ = _cluster_replay(cfg, params_cpu, "cpu")
    if min(launched.values()) == 0:
        fail(f"cluster parity: the card's run did not launch both kernels: {launched}")
    if gpu_log != cpu_log:
        first = next((i for i, (x, y) in enumerate(zip(gpu_log, cpu_log)) if x != y),
                     min(len(gpu_log), len(cpu_log)))
        fail(f"cluster parity: the runs part at event {first}: card "
             f"{gpu_log[first:first + 1]}, cpu {cpu_log[first:first + 1]}")
    if gpu_out["finished"] != gpu_out["total"] or \
            any(gpu_out[k] != cpu_out[k] for k in ("steps", "scale_ups", "scale_downs")):
        fail(f"cluster parity: card {gpu_out}, cpu {cpu_out}")
    kinds = {}
    for e in gpu_log:
        key = e[0] if e[0] != "provision" else f"provision {e[2]}"
        kinds[key] = kinds.get(key, 0) + 1
    if not {"provision mixed", "provision batch", "retire"} <= set(kinds):
        fail(f"cluster parity: the run was meant to use both arms and retire: {kinds}")

    before_move = KERNELS["paged_attention"].launches
    base = _migration_tokens(cfg, params_gpu, 6, move=False)
    toks = _migration_tokens(cfg, params_gpu, 6, move=True)
    if toks != base or len(toks) < 20:
        fail(f"cluster migration: the migrated request's tokens {toks} differ "
             f"from the run without the move {base}")
    if KERNELS["paged_attention"].launches == before_move:
        fail("cluster migration: the runs launched no paged_attention")
    emit("cluster", check="parity",
         config="llama-8b smoke, head_dim=64, float32, fake clock 0.05 s a loop",
         requests=len(gpu_reqs), loops=gpu_out["steps"], events=len(gpu_log),
         decisions=kinds, scale_ups=gpu_out["scale_ups"],
         scale_downs=gpu_out["scale_downs"], card_equals_cpu=True,
         kernel_launches=launched, migration_steps=len(toks),
         migration_tokens_agree=True)


def _percentiles(values) -> dict:
    v = np.asarray(values, dtype=np.float64) * 1e3
    if v.size == 0:
        return {"p50_ms": None, "p99_ms": None, "mean_ms": None}
    return {"p50_ms": float(np.percentile(v, 50)), "p99_ms": float(np.percentile(v, 99)),
            "mean_ms": float(v.mean())}


def _busy_by_batch(cluster, cfg, sizes, prompt: int, steps: int = 5) -> dict:
    """Device-busy and wall time (ms) of one decode step of an engine alone
    on the card, at each batch size in ``sizes``, on the cluster's shared
    weights with ``prompt``-token prompts: a profiled pass after
    ``serve_forever``, so that the run's window holds no profiler."""
    out = {}
    for b in sizes:
        eng = Engine(cfg, params=cluster._shared_params, max_slots=8, max_len=1024,
                     dtype=torch.bfloat16, device="cuda")
        eng.set_max_batch_size(b)
        for _ in range(b):
            # the outputs outlast every session _kernel_rows may run
            eng.submit(make_interactive(prompt, 10 * steps + 8))
        while eng.waiting or eng.n_active < b:
            eng.step()
        eng.step()
        wall = _wall_ms(eng.step, steps)
        prof = _profiled(eng.step, steps)
        out[b] = {"device_ms": prof["device_ms"], "wall_ms": wall,
                  "launches": prof["launches"]}
        eng.close()
        del eng
        gc.collect()
        torch.cuda.empty_cache()
    return out


def phase_cluster(smi: str) -> dict:
    """Chiron's global layer at full width on the card: ``serve_forever``
    driven by ``ChironController`` over llama-8b instances (bf16, random
    weights from seed 0, one copy shared by every instance, a KV pool of
    8 x 1024 tokens each), on the real clock. Each instance is a logical
    share of the one card (``max_chips=4``, one "chip" an instance); the
    loop steps them in turn. Fails unless every request finished, at least
    two instances served tokens, every attention launch went to the hand
    kernels and no engine sits on the CPU. The timed window holds no profiler
    and no recorder: each instance's step, provision and retirement are
    wrapped only to read the clock and count; device-busy time is taken
    after the run (``_busy_by_batch``). Returns the kernels' launches."""
    _cluster_parity()
    gc.collect()
    torch.cuda.empty_cache()
    cfg = get_config("llama-8b")
    max_prompt, max_output = 341, 64
    t_weights = time.monotonic()
    cluster = RealCluster(cfg, max_chips=4, chips_per_instance=1, max_slots=8,
                          max_len=1024, device="cuda", dtype=torch.bfloat16)
    torch.cuda.synchronize()
    weights_s = time.monotonic() - t_weights
    # interactive arrivals over ~8 s and a batch backlog at t=0 (60 s TTFT)
    spec = WorkloadSpec(n_requests=30, arrival_rate=4.0, interactive_frac=0.8,
                        batch_queue_size=12, batch_ttft_slo=60.0, seed=0,
                        model="llama-8b")
    reqs = _cluster_trace(cfg, spec, max_prompt, max_output)

    # per instance, by provision order, on this script's own clock: its
    # lifetime and, for each step that ran requests, the ITL the engine
    # measured, the batch size, whether it admitted, and its wall time;
    # besides, the provisions and retirements in order
    life, per_inst, names, decisions, insts = {}, {}, {}, [], {}
    provision, retire = cluster.provision, cluster.retire

    def provision_timed(model, itype, now, **kw):
        inst = provision(model, itype, now, **kw)
        if inst is None:
            return None
        n = names[id(inst)] = len(names)
        insts[n] = inst
        decisions.append(("provision", n, itype.value))
        life[n] = [time.monotonic(), None, itype.value]
        stats_n = per_inst[n] = {"steps": 0, "tokens": 0, "itl_s": [], "decode": [],
                                 "local": inst.local,
                                 "capture_s": inst.engine.decode_graph.capture_s,
                                 "graph_pool_bytes":
                                     inst.engine.decode_graph.graph_pool_bytes}
        step = inst.step

        def step_timed(now):
            running = {id(s.request) for s in inst.running}
            t = time.monotonic()
            stats = step(now)
            wall = time.monotonic() - t
            stats_n["steps"] += 1
            if stats.n_active:
                stats_n["tokens"] += stats.new_tokens
                stats_n["itl_s"].append(stats.itl)
                admitted = any(id(s.request) not in running for s in inst.running)
                stats_n["decode"].append((stats.n_active, admitted, wall))
            return stats
        inst.step = step_timed
        return inst

    def retire_timed(inst):
        n = names[id(inst)]
        life[n][1] = time.monotonic()
        displaced = retire(inst)
        decisions.append(("retire", n, len(displaced)))
        return displaced

    cluster.provision, cluster.retire = provision_timed, retire_timed
    # serve_forever's clock. Its loop does not sleep: while nothing runs it
    # spins until the next arrival, so its loop count is no bound on time;
    # the clock ends a run that outlasts CLUSTER_LIMIT_S instead.
    t0 = []

    def clock():
        t = time.monotonic()
        if not t0:
            t0.append(t)
        elif t - t0[0] > CLUSTER_LIMIT_S:
            fail(f"cluster: serve_forever still ran after {CLUSTER_LIMIT_S} s")
        return t

    controller = ChironController(model="llama-8b", init_batch=2, max_batch=8)
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    out = serve_forever(reqs, controller, cluster, max_steps=10 ** 9, clock=clock)
    launches = {name: KERNELS[name].launches for name in ATTENTION_KERNELS}
    tensor_core = KERNELS["flash_prefill"].tensor_core_launches
    t_end = time.monotonic()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    if out["finished"] != len(reqs):
        fail(f"cluster: {out['finished']} of {len(reqs)} requests finished: {out}")
    served = [n for n, s in per_inst.items() if s["tokens"] > 0]
    if len(served) < 2:
        fail(f"cluster: only instances {served} served tokens")
    decode_steps = sum(len(s["decode"]) for s in per_inst.values())
    # each engine ran its warm-up steps before its capture
    warmups = decode_graph.WARMUP_STEPS * len(names)
    want = {"paged_attention": (decode_steps + warmups) * cfg.n_layers,
            "flash_prefill": len(reqs) * cfg.n_layers}
    if launches != want or tensor_core != launches["flash_prefill"]:
        fail(f"cluster: attention launches {launches} ({tensor_core} on the "
             f"tensor-core kernel), the run implies {want}")

    def leaves(tree):
        for v in tree.values():
            yield from leaves(v) if isinstance(v, dict) else [v]

    if any(insts[n].engine.decode_graph._graph is not None
           for n, (_, gone, _) in life.items() if gone is not None):
        fail("cluster: a retired engine kept its decode graph")
    for inst in cluster.instances:
        if any(t.device.type != "cuda" for t in [*leaves(inst.engine.params),
                                                 *leaves(inst.engine.pool)]):
            fail("cluster: an engine's parameters or pool live on the CPU")
    for r in reqs:
        if r.tokens_generated < 1 or r.first_token_time is None:
            fail("cluster: a finished request generated no token")

    by_type = {"provision": {}, "retire": {}}
    for e in decisions:
        if e[0] == "provision":
            by_type["provision"][e[2]] = by_type["provision"].get(e[2], 0) + 1
        elif e[0] == "retire":
            kind = life[e[1]][2]
            by_type["retire"][kind] = by_type["retire"].get(kind, 0) + 1
    migrated = sum(e[2] for e in decisions if e[0] == "retire")
    start = t0[0]
    per_type = {}
    for kind in ("interactive", "batch"):
        rs = [r for r in reqs if r.request_type.value == kind]
        # TTFT from the trace's arrival on serve_forever's clock (the
        # engine's clock is absolute; Request.ttft would mix the two)
        ttft = [r.first_token_time - start - r.arrival_time for r in rs]
        itl = [x for r in rs for x in r.itl_samples]
        met = sum(r.state.value == "finished" and t <= r.slo.ttft and r.itl_met()
                  for r, t in zip(rs, ttft))
        per_type[kind] = {"requests": len(rs), "ttft": _percentiles(ttft),
                          "itl": _percentiles(itl), "slo_met": met,
                          "ttft_slo_s": rs[0].slo.ttft if rs else None,
                          "itl_slo_s": rs[0].slo.itl if rs else None}
    tokens = sum(r.tokens_generated for r in reqs)
    # device-busy time of a decode step at each batch size the instances'
    # decode-only steps ran, from a profiled pass after the timed run
    sizes = sorted({b for s in per_inst.values() for b, admitted, _ in s["decode"]
                    if not admitted})
    busy_prompt = int(round(np.mean([r.prompt_len for r in reqs])))
    busy = _busy_by_batch(cluster, cfg, sizes, busy_prompt)
    instances = {}
    for n, s in per_inst.items():
        born, gone, kind = life[n]
        alone = [(b, wall) for b, admitted, wall in s["decode"] if not admitted]
        instances[n] = {
            "type": kind, "seconds": (gone or t_end) - born, "steps": s["steps"],
            "capture_s": s["capture_s"], "graph_pool_bytes": s["graph_pool_bytes"],
            "decode_steps": len(s["decode"]), "tokens": s["tokens"],
            "itl": _percentiles(s["itl_s"]),
            "decode_only_steps": len(alone),
            "decode_only_step_wall": _percentiles([wall for _, wall in alone]),
            "batch_sizes": {b: sum(1 for x, _ in alone if x == b)
                            for b in sorted({x for x, _ in alone})},
            # Algorithm 1's batch size after each of its updates
            "batch_size_history": list(s["local"].history),
            "device_busy_ms_per_decode_only_step": (float(np.mean(
                [busy[b]["device_ms"] for b, _ in alone])) if alone else None)}
    perf = PerfModel("llama-8b")
    ctx = float(np.mean([r.prompt_len + r.output_len / 2 for r in reqs]))
    res = dict(
        gpu=smi, model=cfg.name, dtype="bfloat16", n_layers=cfg.n_layers,
        d_model=cfg.d_model, max_slots=8, max_len=1024, max_chips=4,
        requests=len(reqs), max_prompt=max_prompt, max_output=max_output,
        finished=out["finished"], loops=out["steps"], serve_s=out["wall_s"],
        weights_s=weights_s, tokens=tokens, tokens_per_s=tokens / out["wall_s"],
        provisions=by_type["provision"], retires=by_type["retire"],
        scale_ups=out["scale_ups"], scale_downs=out["scale_downs"],
        chip_seconds_by_cluster=cluster.chip_seconds,
        instance_seconds=sum(i["seconds"] for i in instances.values()),
        preemptions=sum(r.preemptions for r in reqs), migrations=migrated,
        per_type=per_type, instances_served=len(served), instances=instances,
        peak_device_memory_gb=peak_gb, kernel_launches=launches,
        busy_by_batch_size=busy, busy_pass_prompt=busy_prompt,
        flash_prefill_tensor_core_launches=tensor_core,
        perf_model={"itl_ms_at_8_slots": perf.itl(8, ctx) * 1e3, "mean_ctx": ctx,
                    "batch_instance_tokens_per_s":
                        controller.batch_instance_throughput(cluster)})
    emit("cluster", check="serve", **res)
    return launches


# ------------------------------------------------------------ training
# the train phase's tolerance, card against CPU: float32 on both, the
# layers' sums in other orders
TRAIN_TOL = 1e-4
# the parameters after one step at lr 1e-3, card against CPU: Adam's first
# step moves each element by about lr, so a leaf whose gradient were lost
# (moved by the weight decay alone) is off by ~5x this
TRAIN_PARAM_TOL = 2e-4
# the full-width run's learning rate: ``make_train_step``'s default, the
# reference's (at the launcher's 1e-3 the loss of olmo-1b from random weights
# did not fall over 20 steps on the H100: 11.30 -> 11.52; ``_train_lr_witness``
# runs that rate with the kernels and with plain PyTorch attention)
TRAIN_LR = 3e-4
LAUNCHER_LR = 1e-3
# the first step's loss of the full-width runs (20 steps of 8 x 128 from seed
# 0 at TRAIN_LR) when their float32 forwards ran on the FMA kernels, to the
# four decimals PERF.md keeps (H100 80GB HBM3, 700 W): the 3xTF32 forwards
# keep float32's precision, so the first loss stays within TRAIN_TOL of it,
# plus half a unit of its last digit
FMA_FIRST_LOSS = {"olmo-1b": 11.3005, "mamba2-1.3b": 11.2905}
FIRST_LOSS_TOL = TRAIN_TOL + 5e-5
# the launcher's 20 steps at LAUNCHER_LR, attention through the kernels
# against plain PyTorch attention on the card: the same float32 math in other
# sum orders, so the first steps' losses agree within TRAIN_TOL; later the
# rising loss amplifies those differences (~1e-6 at step 1, ~1e-2 by step 17
# on the H100), so there only the verdict, fallen or not, must agree
WITNESS_STEPS = 6


def _launch_counts(names) -> dict:
    """The launch counters of ``names``, as the train phase reads them."""
    read = {"flash_prefill": lambda: flash_prefill.launches,
            "flash_prefill.lse_launches": lambda: flash_prefill.lse_launches,
            "flash_prefill.tf32_launches": lambda: flash_prefill.tf32_launches,
            "flash_prefill_backward": lambda: flash_prefill_backward.launches,
            "ssd_scan": lambda: ssd_scan.launches,
            "ssd_scan.tf32_launches": lambda: ssd_scan.tf32_launches,
            "ssd_scan_backward": lambda: ssd_scan_backward.launches,
            "ssd_scan_backward.tensor_core_launches":
                lambda: ssd_scan_backward.tensor_core_launches}
    return {n: read[n]() for n in names}


def _train_parity(cfg, label: str, B: int, S: int, want: dict) -> dict:
    """One float32 train step (remat on) of ``cfg`` on the card and on the
    CPU from the same parameters and batch: loss and gradient norm within
    ``TRAIN_TOL``, the parameters after the step within ``TRAIN_PARAM_TOL``;
    the card's step must launch the kernels ``want`` says. olmo-1b (widened
    to head_dim 64, the kernels' widths) launches ``flash_prefill`` twice a
    layer (remat runs each forward again), each writing the log-sum-exp
    (both run through ``FlashPrefill``; the backward takes the second's),
    and its backward once a layer; mamba2-1.3b ``ssd_scan`` twice a layer
    (both through ``SSDScan``) and its backward once a layer (on the FMA
    kernel: the smoke widths, P 32 and N 16, over two chunks)."""
    model = Model(cfg)
    params_cpu = model.init(torch.Generator().manual_seed(6), dtype=torch.float32,
                            device="cpu")
    batch_cpu = synthetic_lm_batch(np.random.default_rng(6), model, B, S, device="cpu")
    step = make_train_step(cfg, remat=True, lr=1e-3)
    p_cpu, _, m_cpu = step(params_cpu, adamw_init(params_cpu), batch_cpu)
    params_gpu = _to_cuda(params_cpu)
    zero_counts()
    p_gpu, _, m_gpu = step(params_gpu, adamw_init(params_gpu),
                           {k: v.cuda() for k, v in batch_cpu.items()})
    torch.cuda.synchronize()
    counts = _launch_counts(want)
    if counts != want:
        fail(f"train parity {label}: launches {counts}, a step implies {want}")
    loss = (float(m_gpu["loss"]), float(m_cpu["loss"]))
    norm = (float(m_gpu["grad_norm"]), float(m_cpu["grad_norm"]))
    if abs(loss[0] - loss[1]) > TRAIN_TOL or \
            abs(norm[0] - norm[1]) > TRAIN_TOL * max(1.0, norm[1]):
        fail(f"train parity {label}: loss (card, cpu) {loss}, grad norm {norm}, beyond "
             f"{TRAIN_TOL:g}")
    param_err = max(float((a.cpu() - b).abs().max())
                    for a, b in zip(tree.leaves(p_gpu), tree.leaves(p_cpu)))
    if param_err > TRAIN_PARAM_TOL:
        fail(f"train parity {label}: parameters after one step differ by {param_err:.3e}, "
             f"beyond {TRAIN_PARAM_TOL:g}")
    out = {"config": label, "batch": B, "seq": S,
           "loss": loss, "grad_norm": norm, "tolerance": TRAIN_TOL,
           "params_max_abs_err_after_step": param_err,
           "params_tolerance": TRAIN_PARAM_TOL, "kernel_launches": counts}
    emit("train", check="one step, card against CPU", **out)
    return out


def _leaf_names(t, prefix: str = "") -> list:
    """Dotted names of a parameter tree's leaves in ``tree.flatten`` order."""
    if isinstance(t, dict):
        return [n for k in sorted(t) for n in _leaf_names(t[k], f"{prefix}{k}.")]
    return [prefix[:-1]]


def _leaf_grad_norms(names, grads) -> dict:
    """Each leaf's gradient norm on the host in float64: one a layer for the
    stacked layer leaves, one for any other leaf."""
    return {n: (g.reshape(g.shape[0], -1) if n.startswith("layers.") else g.reshape(1, -1))
            .double().norm(dim=1).cpu() for n, g in zip(names, grads)}


def _train_width_parity(cfg, label: str, B: int, S: int, want: dict) -> dict:
    """The gradient of one float32 loss of ``cfg`` (no remat, as the
    launcher runs) on the card and on the CPU from the same parameters and
    batch: the loss, the global gradient norm and each leaf's gradient norm
    (a layer's slice for the stacked leaves) agree within ``TRAIN_TOL`` of
    the CPU's (of the leaf's largest, for a leaf), and the card launches the
    kernels ``want`` says: one forward a layer (olmo-1b's writes the
    log-sum-exp that the layer's backward takes) and one backward a layer."""
    model = Model(cfg)
    params_cpu = model.init(torch.Generator().manual_seed(7), dtype=torch.float32,
                            device="cpu")
    batch_cpu = synthetic_lm_batch(np.random.default_rng(7), model, B, S, device="cpu")
    names = _leaf_names(params_cpu)
    loss_cpu, grads_cpu = loss_and_grads(model, params_cpu, batch_cpu)
    norms_cpu = _leaf_grad_norms(names, grads_cpu)
    del grads_cpu
    zero_counts()
    loss_gpu, grads_gpu = loss_and_grads(model, _to_cuda(params_cpu),
                                         {k: v.cuda() for k, v in batch_cpu.items()})
    torch.cuda.synchronize()
    counts = _launch_counts(want)
    if counts != want:
        fail(f"train width parity {label}: launches {counts}, a loss and its gradient "
             f"imply {want}")
    norms_gpu = _leaf_grad_norms(names, grads_gpu)
    del grads_gpu
    loss = (float(loss_gpu), float(loss_cpu))
    norm = tuple(float(torch.cat(list(n.values())).norm()) for n in (norms_gpu, norms_cpu))
    if abs(loss[0] - loss[1]) > TRAIN_TOL or abs(norm[0] - norm[1]) > TRAIN_TOL * norm[1]:
        fail(f"train width parity {label}: loss (card, cpu) {loss}, grad norm {norm}, "
             f"beyond {TRAIN_TOL:g}")
    leaf_err = {}
    for n in names:
        a, b = norms_gpu[n], norms_cpu[n]
        if float(b.max()) == 0.0:
            fail(f"train width parity {label}: {n} gets no gradient on the CPU")
        leaf_err[n] = float((a - b).abs().max()) / float(b.max())
        if leaf_err[n] > TRAIN_TOL:
            fail(f"train width parity {label}: {n}'s gradient norms (card, cpu) "
                 f"{a.tolist()}, {b.tolist()} differ by {leaf_err[n]:.3e} of the largest")
    out = {"config": label, "batch": B, "seq": S, "loss": loss, "grad_norm": norm,
           "tolerance": TRAIN_TOL, "leaf_grad_norm_rel_err_max": max(leaf_err.values()),
           "leaf_grad_norms_cpu": {n: v.tolist() for n, v in norms_cpu.items()},
           "kernel_launches": counts}
    emit("train", check="gradient at full width, card against CPU", **out)
    return out


def _train_full(smi: str) -> dict:
    """olmo-1b at full width in float32 through ``launch.train``'s loop:
    20 steps of batch 8 x 128 tokens with remat at ``TRAIN_LR``, counters
    set to 0 just before and read just after. Fails unless the loss falls,
    every loss and
    gradient norm is finite, the first loss is within ``FIRST_LOSS_TOL`` of
    ``FMA_FIRST_LOSS``, and every step launches the backward kernel once a
    layer and the forward kernel twice a layer, every forward launch the
    3xTF32 kernel's and writing the log-sum-exp. Then two more steps are
    profiled for their device-busy time and timed on the wall clock; the
    profile must show the backward's two FMA kernels once a layer each and
    no other backward kernel (no row-statistics pass), and the forward's
    LSE instance ``flash_prefill_kernel_tf32<128, 1>`` twice a layer."""
    gc.collect()
    torch.cuda.empty_cache()
    cfg = get_config("olmo-1b")
    steps, B, S = 20, 8, 128
    per_step, last, held = [], [0, 0], []

    def on_step(_):
        now = [flash_prefill_backward.launches, flash_prefill.launches]
        per_step.append([now[0] - last[0], now[1] - last[1]])
        last[:] = now
        held.append(torch.cuda.memory_allocated() / 1e9)

    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    t0 = time.monotonic()
    res = train(cfg, steps=steps, batch=B, seq=S, lr=TRAIN_LR, remat=True, device="cuda",
                on_step=on_step)
    total_s = time.monotonic() - t0
    launches = {"flash_prefill_backward": flash_prefill_backward.launches,
                "flash_prefill": flash_prefill.launches,
                "flash_prefill.lse_launches": flash_prefill.lse_launches,
                "tensor_core_launches": flash_prefill.tensor_core_launches,
                "flash_prefill.tf32_launches": flash_prefill.tf32_launches,
                "paged_attention": paged_attention.launches}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    losses, norms = res["losses"], res["grad_norms"]
    if not all(np.isfinite(losses)) or not all(np.isfinite(norms)):
        fail(f"train olmo-1b: a loss or gradient norm is not finite: {losses}, {norms}")
    if not losses[-1] < losses[0]:
        fail(f"train olmo-1b: the loss did not fall: {losses}")
    if any(p != [cfg.n_layers, 2 * cfg.n_layers] for p in per_step) or \
            len(per_step) != steps:
        fail(f"train olmo-1b: launches a step (backward, forward) {per_step}, want "
             f"[{cfg.n_layers}, {2 * cfg.n_layers}] each")
    if launches["flash_prefill.lse_launches"] != launches["flash_prefill"] or \
            launches["flash_prefill.tf32_launches"] != launches["flash_prefill"] or \
            launches["tensor_core_launches"]:
        fail(f"train olmo-1b: of {launches['flash_prefill']} forward launches "
             f"{launches['flash_prefill.lse_launches']} wrote the log-sum-exp, "
             f"{launches['flash_prefill.tf32_launches']} ran the 3xTF32 kernel, "
             f"{launches['tensor_core_launches']} the bf16 wgmma kernel")
    if abs(losses[0] - FMA_FIRST_LOSS[cfg.name]) > FIRST_LOSS_TOL:
        fail(f"train olmo-1b: the first loss {losses[0]!r} is not within {FIRST_LOSS_TOL:g} "
             f"of {FMA_FIRST_LOSS[cfg.name]}")
    # device-busy time of a step, then its wall time, on a fixed batch
    state = [res["params"], res["opt_state"]]
    batch = synthetic_lm_batch(np.random.default_rng(1), res["model"], B, S)
    step_fn = make_train_step(cfg, remat=True, lr=TRAIN_LR)

    def one():
        state[0], state[1], m = step_fn(state[0], state[1], batch)
        float(m["loss"])

    one()
    prof = _profiled(one, 2)
    backward = {k: n for k, n in prof["own_kernel_launches"].items()
                if k.startswith("flash_prefill_bwd")}
    want = {"flash_prefill_bwd_dq_fma": cfg.n_layers, "flash_prefill_bwd_dkdv_fma": cfg.n_layers}
    if backward != want:
        fail(f"train olmo-1b: a profiled step launched the backward kernels {backward}, "
             f"want {want}")
    forward = {k: n for k, n in prof["own_instance_launches"].items()
               if k.startswith("flash_prefill_kernel")}
    if forward != {"flash_prefill_kernel_tf32<128, 1>": 2 * cfg.n_layers}:
        fail(f"train olmo-1b: a profiled step launched the forward kernels {forward}")
    wall_ms = _wall_ms(one, 3)
    step_ms = [t * 1e3 for t in res["step_s"]]
    steady = float(np.median(step_ms[1:]))
    out = {"model": cfg.name, "params": cfg.param_count(), "dtype": "float32",
           "remat": True, "steps": steps, "batch": B, "seq": S, "lr": TRAIN_LR,
           "loss_first": losses[0], "loss_last": losses[-1], "losses": losses,
           "grad_norms": norms, "step_ms": step_ms, "step_ms_median_after_first": steady,
           "tokens_per_s": B * S / (steady / 1e3), "train_loop_s": total_s,
           "peak_device_memory_gb": peak_gb, "held_between_steps_gb_max": max(held),
           "kernel_launches": launches,
           "launches_per_step_backward_forward": per_step[0],
           "profiled_step_wall_ms": wall_ms, "profiled_step_device_ms": prof["device_ms"],
           "device_idle_share": 1.0 - prof["device_ms"] / wall_ms,
           "step_launches": prof["launches"], "own_kernels_ms": prof["own_kernels_ms"],
           "backward_kernel_launches_per_step": backward,
           "forward_kernel_launches_per_step": forward,
           "first_loss_with_fma_forward": FMA_FIRST_LOSS[cfg.name],
           "top_device_ms": prof["top_ms"]}
    emit("train", gpu=smi, **out)
    del state, res
    return {"flash_prefill": launches["flash_prefill"],
            "flash_prefill_tf32": launches["flash_prefill.tf32_launches"],
            "flash_prefill_backward": launches["flash_prefill_backward"]}, prof["device_ms"]


def _train_lr_witness() -> dict:
    """``launch.train``'s defaults at olmo-1b's full width (lr LAUNCHER_LR, no
    remat, 20 steps of 8 x 128 from seed 0), twice: the attention through the
    kernels, then through ``flash_prefill_plain`` (autograd of plain PyTorch
    on the card, no kernel launched). Fails unless the first
    ``WITNESS_STEPS`` losses agree within ``TRAIN_TOL`` and both runs' losses
    fall, or both do not: whether the loss falls at this rate is then the
    optimisation's and not the kernels'."""
    cfg = get_config("olmo-1b")
    losses = {}
    for route in ("kernels", "plain attention"):
        gc.collect()
        torch.cuda.empty_cache()
        before = flash_prefill.launches + flash_prefill_backward.launches
        lse_before, bwd_before = flash_prefill.lse_launches, flash_prefill_backward.launches
        if route == "plain attention":
            ops.flash_prefill = flash_prefill_plain
        try:
            res = train(cfg, steps=20, batch=8, seq=128, lr=LAUNCHER_LR, remat=False,
                        device="cuda")
        finally:
            ops.flash_prefill = flash_prefill
        launched = flash_prefill.launches + flash_prefill_backward.launches - before
        if (route == "plain attention") != (launched == 0):
            fail(f"train witness: the {route} run launched {launched} attention kernels")
        if route == "kernels" and flash_prefill.lse_launches - lse_before != \
                flash_prefill_backward.launches - bwd_before:
            fail("train witness: the forward launches that wrote the log-sum-exp "
                 f"({flash_prefill.lse_launches - lse_before}) are not the backward's "
                 f"calls ({flash_prefill_backward.launches - bwd_before})")
        losses[route] = res["losses"]
        del res
    if not all(np.isfinite(v).all() for v in losses.values()):
        fail(f"train witness: a loss is not finite: {losses}")
    diffs = [abs(a - b) for a, b in zip(*losses.values())]
    early = max(diffs[:WITNESS_STEPS])
    fell = {k: v[-1] < v[0] for k, v in losses.items()}
    if early > TRAIN_TOL or len(set(fell.values())) != 1:
        fail(f"train witness: kernels and plain attention part by {early:.3e} in the "
             f"first {WITNESS_STEPS} steps, or one falls and the other not: {losses}")
    out = {"model": cfg.name, "lr": LAUNCHER_LR, "remat": False, "steps": 20, "batch": 8,
           "seq": 128, "losses": losses, "loss_diff_first_steps_max": early,
           "first_steps": WITNESS_STEPS, "tolerance": TRAIN_TOL,
           "loss_diff_max": max(diffs), "loss_fell": fell}
    emit("train", check="the launcher's lr, kernels against plain attention", **out)
    return out


class _NoPlainSSD:
    """While active, ``ssd_scan_plain`` and ``ssd_scan_backward_plain``
    fail the run if they are called on a CUDA tensor: the card's SSD work,
    forward and gradient, must all be the kernels'."""

    def __enter__(self):
        self.saved = (ssd_module.ssd_scan_plain, ssd_module.ssd_scan_backward_plain)

        def guard(fn):
            def run(x, *args, **kw):
                if x.device.type == "cuda":
                    fail(f"train: {fn.__name__} ran on the card")
                return fn(x, *args, **kw)
            return run

        ssd_module.ssd_scan_plain, ssd_module.ssd_scan_backward_plain = map(guard, self.saved)
        return self

    def __exit__(self, *exc):
        ssd_module.ssd_scan_plain, ssd_module.ssd_scan_backward_plain = self.saved
        return False


def _train_ssm_full(smi: str) -> dict:
    """mamba2-1.3b at full width and depth in float32 through
    ``launch.train``'s loop: 20 steps of 8 x 128 tokens with remat at
    ``TRAIN_LR``, counters set to 0 just before and read just after, no
    plain SSD call on the card (``_NoPlainSSD``). Fails unless every loss
    and gradient norm is finite, the first loss is within ``FIRST_LOSS_TOL``
    of ``FMA_FIRST_LOSS``, and every step launches the ``ssd_scan`` forward
    twice a layer and its backward once a layer, every forward launch the
    3xTF32 kernel's and every backward launch the tensor-core kernel's. Then
    a step is profiled for its device-busy time and timed on the wall clock;
    the profile must show the backward's tensor-core kernel once a layer,
    the 3xTF32 forward twice, and no other SSD kernel. Where the loss does not fall,
    ``_train_ssm_witness`` runs the same steps with plain PyTorch SSD and
    fails unless that run does not fall either: whether the loss falls at
    this rate is then the optimisation's and not the kernels'."""
    gc.collect()
    torch.cuda.empty_cache()
    cfg = get_config("mamba2-1.3b")
    steps, B, S = 20, 8, 128
    per_step, last, held = [], [0, 0], []

    def on_step(_):
        now = [ssd_scan_backward.launches, ssd_scan.launches]
        per_step.append([now[0] - last[0], now[1] - last[1]])
        last[:] = now
        held.append(torch.cuda.memory_allocated() / 1e9)

    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    t0 = time.monotonic()
    with _NoPlainSSD():
        res = train(cfg, steps=steps, batch=B, seq=S, lr=TRAIN_LR, remat=True,
                    device="cuda", on_step=on_step)
    total_s = time.monotonic() - t0
    launches = {"ssd_scan_backward": ssd_scan_backward.launches,
                "ssd_scan_backward.tensor_core_launches":
                    ssd_scan_backward.tensor_core_launches,
                "ssd_scan": ssd_scan.launches,
                "tensor_core_launches": ssd_scan.tensor_core_launches,
                "ssd_scan.tf32_launches": ssd_scan.tf32_launches,
                "flash_prefill": flash_prefill.launches,
                "paged_attention": paged_attention.launches}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    losses, norms = res["losses"], res["grad_norms"]
    if not all(np.isfinite(losses)) or not all(np.isfinite(norms)):
        fail(f"train mamba2-1.3b: a loss or gradient norm is not finite: {losses}, {norms}")
    fell = losses[-1] < losses[0]
    if any(p != [cfg.n_layers, 2 * cfg.n_layers] for p in per_step) or \
            len(per_step) != steps or \
            launches["ssd_scan.tf32_launches"] != launches["ssd_scan"] or \
            launches["tensor_core_launches"] or \
            launches["flash_prefill"] or launches["paged_attention"] or \
            launches["ssd_scan_backward.tensor_core_launches"] != \
            launches["ssd_scan_backward"]:
        fail(f"train mamba2-1.3b: launches a step (backward, forward) {per_step}, want "
             f"[{cfg.n_layers}, {2 * cfg.n_layers}] each, every forward launch on the "
             f"3xTF32 kernel (none on the bf16 wgmma kernel) and every backward launch "
             f"on the tensor cores; in all {launches}")
    if abs(losses[0] - FMA_FIRST_LOSS[cfg.name]) > FIRST_LOSS_TOL:
        fail(f"train mamba2-1.3b: the first loss {losses[0]!r} is not within "
             f"{FIRST_LOSS_TOL:g} of {FMA_FIRST_LOSS[cfg.name]}")
    state = [res["params"], res["opt_state"]]
    batch = synthetic_lm_batch(np.random.default_rng(1), res["model"], B, S)
    step_fn = make_train_step(cfg, remat=True, lr=TRAIN_LR)

    def one():
        state[0], state[1], m = step_fn(state[0], state[1], batch)
        float(m["loss"])

    with _NoPlainSSD():
        one()
        prof = _profiled(one, 2)
        wall_ms = _wall_ms(one, 3)
    ssd = {k: n for k, n in prof["own_instance_launches"].items() if "ssd" in k}
    want = {"ssd_scan_bwd_tc<float, 128>": cfg.n_layers,
            "ssd_scan_kernel_tf32<128>": 2 * cfg.n_layers}
    if ssd != want:
        fail(f"train mamba2-1.3b: a profiled step launched the SSD kernels {ssd}, "
             f"want {want}")
    step_ms = [t * 1e3 for t in res["step_s"]]
    steady = float(np.median(step_ms[1:]))
    out = {"model": cfg.name, "params": cfg.param_count(), "dtype": "float32",
           "remat": True, "steps": steps, "batch": B, "seq": S, "lr": TRAIN_LR,
           "loss_first": losses[0], "loss_last": losses[-1], "losses": losses,
           "grad_norms": norms, "step_ms": step_ms, "step_ms_median_after_first": steady,
           "tokens_per_s": B * S / (steady / 1e3), "train_loop_s": total_s,
           "peak_device_memory_gb": peak_gb, "held_between_steps_gb_max": max(held),
           "kernel_launches": launches,
           "launches_per_step_backward_forward": per_step[0],
           "profiled_step_wall_ms": wall_ms, "profiled_step_device_ms": prof["device_ms"],
           "device_idle_share": 1.0 - prof["device_ms"] / wall_ms,
           "step_launches": prof["launches"], "own_kernels_ms": prof["own_kernels_ms"],
           "ssd_kernel_launches_per_step": ssd, "top_device_ms": prof["top_ms"],
           "first_loss_with_fma_forward": FMA_FIRST_LOSS[cfg.name], "loss_fell": fell}
    emit("train", gpu=smi, **out)
    del state, res
    if not fell:
        _train_ssm_witness(losses)
    return {"ssd_scan": launches["ssd_scan"],
            "ssd_scan_tf32": launches["ssd_scan.tf32_launches"],
            "ssd_scan_backward": launches["ssd_scan_backward"]}, prof["device_ms"]


def _train_ssm_witness(kernel_losses) -> dict:
    """Run only when mamba2-1.3b's loss did not fall at ``TRAIN_LR``: the
    same 20 steps again with the SSD scan through ``ssd_scan_ref`` (plain
    PyTorch on the card under autograd, no kernel launched) in
    ``ops.ssd_scan``, the two runs' losses side by side. Fails unless the
    first step's losses (the same parameters and batch) agree within
    ``TRAIN_TOL`` and the plain run does not fall either. The later steps
    are not compared: AdamW's first update moves every element by about
    ``lr`` whatever its gradient's size, so an element whose gradient is
    near zero (d(dt) sums cancelling terms) moves by the sign of its
    rounding, and the two runs part by ~1e-3 from the second step on."""
    gc.collect()
    torch.cuda.empty_cache()
    before = ssd_scan.launches + ssd_scan_backward.launches
    ops.ssd_scan = ssd_scan_ref
    try:
        res = train(get_config("mamba2-1.3b"), steps=20, batch=8, seq=128, lr=TRAIN_LR,
                    remat=True, device="cuda")
    finally:
        ops.ssd_scan = ssd_scan
    plain = res["losses"]
    del res
    launched = ssd_scan.launches + ssd_scan_backward.launches - before
    first = abs(kernel_losses[0] - plain[0])
    out = {"model": "mamba2-1.3b", "lr": TRAIN_LR, "remat": True, "steps": 20, "batch": 8,
           "seq": 128, "losses": {"kernels": kernel_losses, "plain ssd": plain},
           "first_step_loss_diff": first, "tolerance": TRAIN_TOL,
           "loss_diff_max": max(abs(a - b) for a, b in zip(kernel_losses, plain)),
           "loss_fell": {"kernels": kernel_losses[-1] < kernel_losses[0],
                         "plain ssd": plain[-1] < plain[0]}}
    emit("train", check="mamba2-1.3b, the loss not falling: kernels against plain SSD", **out)
    if launched or not np.isfinite(plain).all() or first > TRAIN_TOL or \
            plain[-1] < plain[0]:
        verdict = "fell" if plain[-1] < plain[0] else "did not fall"
        fail(f"train mamba2-1.3b: the kernels' loss did not fall; with plain SSD on the "
             f"card ({launched} kernel launches) it {verdict}, first losses "
             f"{kernel_losses[0]} and {plain[0]}")
    return out


def phase_train(smi: str) -> dict:
    """One step card against CPU at the smoke size (olmo-1b, mamba2-1.3b),
    one gradient card against CPU at full width (olmo-1b and mamba2-1.3b in
    2 layers, zamba2-2.7b in 6: one call of its shared attention; the SSD
    models at 2 x 320, two chunks, and at 2 x 128, one), then
    olmo-1b at full width, the launcher's rate with kernels and with plain
    attention, and mamba2-1.3b at full width and depth; returns each
    kernel's launches over the two full-width runs."""
    torch.backends.cuda.matmul.allow_tf32 = False
    # every float32 attention forward runs the 3xTF32 kernel; an SSD forward
    # does where the call is one chunk (s <= 256) at P 64 (the full widths),
    # else the FMA kernel
    flash = ("flash_prefill", "flash_prefill.lse_launches", "flash_prefill.tf32_launches",
             "flash_prefill_backward")
    olmo = get_smoke_config("olmo-1b").with_(head_dim=64)
    _train_parity(olmo, "olmo-1b smoke, head_dim=64, float32, remat", 4, 64,
                  dict(zip(flash, (2 * olmo.n_layers, 2 * olmo.n_layers, 2 * olmo.n_layers,
                                   olmo.n_layers))))
    mamba = get_smoke_config("mamba2-1.3b")
    ssd = ("ssd_scan", "ssd_scan.tf32_launches", "ssd_scan_backward",
           "ssd_scan_backward.tensor_core_launches")
    _train_parity(mamba, "mamba2-1.3b smoke, float32, remat", 4, 64,
                  dict(zip(ssd, (2 * mamba.n_layers, 0, mamba.n_layers, 0))))
    _train_width_parity(get_config("olmo-1b").with_(n_layers=2),
                        "olmo-1b full widths, 2 layers, float32, no remat", 4, 128,
                        dict(zip(flash, (2, 2, 2, 2))))
    # one full chunk of 256 and a ragged one of 64: the carried-state terms,
    # so the SSD forward's and backward's FMA kernels
    _train_width_parity(get_config("mamba2-1.3b").with_(n_layers=2),
                        "mamba2-1.3b full widths, 2 layers, float32, no remat", 2, 320,
                        dict(zip(ssd, (2, 0, 2, 0))))
    # six Mamba2 layers and one call of the shared attention block (D 80,
    # window 4096: the 3xTF32 forward's instance and the backward's FMA ones)
    _train_width_parity(get_config("zamba2-2.7b").with_(n_layers=6),
                        "zamba2-2.7b full widths, 6 layers, float32, no remat", 2, 320,
                        {**dict(zip(ssd, (6, 0, 6, 0))), **dict(zip(flash, (1, 1, 1, 1)))})
    # the same gradients in one chunk (2 x 128): the 3xTF32 forward and the
    # backward's tensor-core kernel
    _train_width_parity(get_config("mamba2-1.3b").with_(n_layers=2),
                        "mamba2-1.3b full widths, 2 layers, float32, no remat, one chunk",
                        2, 128, dict(zip(ssd, (2, 2, 2, 2))))
    _train_width_parity(get_config("zamba2-2.7b").with_(n_layers=6),
                        "zamba2-2.7b full widths, 6 layers, float32, no remat, one chunk",
                        2, 128, {**dict(zip(ssd, (6, 6, 6, 6))),
                                 **dict(zip(flash, (1, 1, 1, 1)))})
    launches, olmo_ms = _train_full(smi)
    _train_lr_witness()
    ssm_launches, ssm_ms = _train_ssm_full(smi)
    launches.update(ssm_launches)
    return launches, {"olmo-1b": olmo_ms, "mamba2-1.3b": ssm_ms}



# ------------------------------------------------------------ the simulator
LOAD_REPS = 3
# the paper's Fig. 19 scenario (the reference's benchmarks/fig19_timeline.py):
# an interactive stream, then a batch dump of 30,000 requests due in 30 min
FIG19_SPEC = dict(n_requests=2000, arrival_rate=30.0, interactive_frac=1.0,
                  batch_queue_size=30000, batch_ttft_slo=1800.0, model="llama-8b",
                  seed=5)
FIG19_MAX_TIME = 2400.0
FIG19_CHIPS = 50             # the paper's budget of 50 GPUs, here 50 H100s


def _load_bandwidth(smi: str) -> float:
    """Host-to-card rate of a checkpoint load into a new instance: llama-8b's
    bf16 parameter tree, leaf by leaf from pageable host memory (its pages
    written before), ``torch.cuda.synchronize()``d, bytes over wall. The
    median of ``LOAD_REPS`` loads; each load's copy is freed before the next."""
    from repro_torch.sim import perf_model
    cfg = get_config("llama-8b")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    host = [t.cpu() for t in _leaves(Model(cfg).init(gen, dtype=torch.bfloat16,
                                                     device="cuda"))]
    gc.collect()
    torch.cuda.empty_cache()
    n_bytes = sum(t.numel() * t.element_size() for t in host)
    n_leaves = len(host)
    seconds = []
    for _ in range(LOAD_REPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        on_card = [t.to("cuda") for t in host]
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        del on_card
        torch.cuda.empty_cache()
    del host
    gc.collect()
    rate = n_bytes / float(np.median(seconds))
    load = {}
    for arch in perf_model.INSTANCE_CHIPS:
        shipped = PerfModel(arch)
        saved = perf_model._LOAD_BW
        perf_model._LOAD_BW = rate
        try:
            measured = PerfModel(arch)
        finally:
            perf_model._LOAD_BW = saved
        load[arch] = {"chips": shipped.chips, "weight_bytes": shipped.weight_bytes,
                      "model_load_time_s": shipped.model_load_time(),
                      "with_measured_rate_s": measured.model_load_time()}
    emit("sim", check="load bandwidth", gpu=smi, model=cfg.name, dtype="bfloat16",
         leaves=n_leaves, bytes=n_bytes, seconds=seconds, bytes_per_s=[n_bytes / s for s in seconds],
         measured_bytes_per_s=rate, module_LOAD_BW=perf_model._LOAD_BW,
         model_load_time=load)
    return rate



def _prefill_plan(smi: str, served: dict) -> None:
    """``PerfModel.prefill_time`` of the prompt the serve phase profiled
    (337 tokens) beside that prefill's wall and device time, for every model
    served at full width: a report of how far the plan is from the card, not
    a refit. Planned on one card, as the prefill ran."""
    rows = {}
    for arch, share in served["shares"].items():
        planned = PerfModel(arch, chips=1).prefill_time(share["prefill_tokens"])
        rows[arch] = {"prompt": share["prefill_tokens"], "planned_ms": planned * 1e3,
                      "measured_wall_ms": share["prefill_wall_ms"],
                      "measured_first_call_wall_ms": share["prefill_first_call_wall_ms"],
                      "measured_device_ms": share["prefill_device_ms"],
                      "wall_over_planned": share["prefill_wall_ms"] / (planned * 1e3),
                      "device_over_planned": share["prefill_device_ms"] / (planned * 1e3)}
    emit("sim", check="prefill plan", gpu=smi, rows=rows)


def _terminal_or_fail(what: str, res) -> None:
    """Fails unless every request of the run ended in a terminal state."""
    from repro_torch.sim.ledger import EXPIRED, FINISHED, REJECTED, SHED
    counts = res.ledger.state_counts()
    terminal = int(counts[FINISHED] + counts[REJECTED] + counts[SHED] + counts[EXPIRED])
    if terminal != res.ledger.n:
        fail(f"sim {what}: {terminal} of {res.ledger.n} requests ended")


def _fig19(smi: str, constants: str):
    """Fig. 19 through the port's simulator under ``ChironController`` (with
    the shadow verifier and a flight recorder) and ``LlumnixController``, on
    the perf model's constants as they stand. Fails if a request is lost: a
    Chiron run that does not finish every request, or any run whose
    requests do not all end in a terminal state. Returns the Chiron run,
    its recorder attached."""
    from repro_torch.obs import FlightRecorder
    out, runs = {}, {}
    for name, ctrl in (("chiron", ChironController()), ("llumnix", LlumnixController())):
        reqs = generate(WorkloadSpec(**FIG19_SPEC))
        cluster = SimCluster(default_perf_factory(), max_chips=FIG19_CHIPS)
        rec = FlightRecorder() if name == "chiron" else None
        t0 = time.perf_counter()
        try:
            res = simulate_events(reqs, ctrl, cluster, max_time=FIG19_MAX_TIME,
                                  warm_start=2, shadow_verify=name == "chiron",
                                  telemetry=rec)
        except ShadowVerifyError as e:
            fail(f"sim {constants} {name}: the shadow verifier raised: {e}")
        wall = time.perf_counter() - t0
        _terminal_or_fail(f"{constants} {name}", res)
        if name == "chiron" and res.completion_rate() < 1.0:
            fail(f"sim {constants} chiron: completion rate {res.completion_rate()}")
        rows = None if rec is None else {"signals": rec.signals.n,
                                         "cluster_ticks": rec.cticks.n,
                                         "decisions": rec.decisions.n,
                                         "spans": rec.spans.n}
        out[name], runs[name] = res.summary(), res
        led = res.ledger
        inter = led.interactive.astype(bool)
        # which SLO the interactive requests miss: TTFT or ITL
        misses = {"ttft_met": float(led.ttft_met_mask()[inter].mean()),
                  "itl_met": float(led.itl_met_mask()[inter].mean()),
                  "mean_itl_p50_p90_s": np.nanpercentile(led.mean_itl[inter],
                                                         [50, 90]).tolist()}
        emit("sim", check="fig19", gpu=smi, constants=constants, controller=name,
             requests=res.ledger.n, max_chips=FIG19_CHIPS, summary=out[name],
             interactive=misses,
             events=res.n_events, scale_ups=res.scale_ups, scale_downs=res.scale_downs,
             wall_s=wall, shadow_verify=name == "chiron", recorder_rows=rows)
    c, l = out["chiron"]["gpu_hours"], out["llumnix"]["gpu_hours"]
    emit("sim", check="fig19 saving", gpu=smi, constants=constants, chiron_gpu_hours=c,
         llumnix_gpu_hours=l, gpu_hour_saving=1.0 - c / l)
    return runs["chiron"]


def _audit(smi: str) -> None:
    """The port's static auditor (``repro_torch.analysis``: mirror-sync,
    determinism and hygiene rules) over the port's own package; any finding
    fails the run."""
    from repro_torch.analysis import iter_py_files, run_analysis
    root = os.path.join(_port_src(), "repro_torch")
    t0 = time.perf_counter()
    files = iter_py_files([root])
    findings = run_analysis([root])
    wall = time.perf_counter() - t0
    emit("sim", check="audit", gpu=smi, root="src/repro_torch", files=len(files),
         findings=len(findings), wall_s=wall)
    if not files or findings:
        fail(f"audit: {len(files)} files, findings: "
             + "; ".join(str(f) for f in findings[:20]))


def _export(smi: str, res) -> None:
    """The shipped-constants Fig. 19 Chiron run's flight recorder through
    the three exporters (JSONL, Perfetto JSON, Prometheus text) into a
    temporary directory, then the JSONL through the terminal dashboards.
    Fails if the Perfetto JSON does not parse or the JSONL's rows of a kind
    do not number the recorder's."""
    import tempfile
    with tempfile.TemporaryDirectory(prefix="sim_export_") as out_dir:
        _export_into(smi, res, out_dir)


def _export_into(smi: str, res, out_dir: str) -> None:
    import contextlib
    import io
    from repro_torch.obs import export
    from repro_torch.obs import __main__ as dashboards
    rec = res.telemetry
    paths = {fmt: os.path.join(out_dir, f"fig19_chiron.{fmt}")
             for fmt in ("jsonl", "perfetto.json", "prom")}
    wall = {}
    t0 = time.perf_counter()
    n_lines = export.to_jsonl(res, paths["jsonl"])
    wall["jsonl"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    export.to_perfetto(res, paths["perfetto.json"])
    wall["perfetto"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    export.to_prometheus(res, paths["prom"])
    wall["prometheus"] = time.perf_counter() - t0
    try:
        with open(paths["perfetto.json"]) as fh:
            events = json.load(fh)["traceEvents"]
    except (ValueError, KeyError) as e:
        fail(f"sim export: the Perfetto JSON does not parse: {e}")
    rows = {}
    with open(paths["jsonl"]) as fh:
        for line in fh:
            kind = json.loads(line)["kind"]
            rows[kind] = rows.get(kind, 0) + 1
    want = {"meta": 1, "timeline": len(res.timeline), "signal": rec.signals.n,
            "cluster": rec.cticks.n, "decision": rec.decisions.n,
            "request": len(export.sampled_requests(res, rec))}
    if rows != want or sum(rows.values()) != n_lines or not events:
        fail(f"sim export: JSONL rows {rows} (lines {n_lines}), recorder {want}, "
             f"{len(events)} Perfetto events")
    text = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(text):
        rc = dashboards.main([paths["jsonl"]])
    wall["dashboards"] = time.perf_counter() - t0
    shown = text.getvalue()
    if rc != 0 or "decision ledger" not in shown:
        fail(f"sim export: the dashboards returned {rc}")
    emit("sim", check="export", gpu=smi, run="fig19 chiron, shipped constants", rows=rows,
         perfetto_events=len(events),
         bytes={fmt: os.path.getsize(p) for fmt, p in paths.items()},
         dashboard_lines=len(shown.splitlines()), wall_s=wall)


# the fleet scenarios the card's constants run: every cluster on the
# baseline row ("v5e", no scales: perf_model's H100 constants); the other
# two put clusters on TPU-scaled rows and are held on the CPU only
FLEET_ON_CARD = ("regional_spillover", "zone_outage")
HELD_ON_CPU = ("multi_region", "heterogeneous_accelerators")


def _fleet(smi: str) -> None:
    """``regional_spillover`` and ``zone_outage`` at their default sizes
    through ``simulate_fleet`` on the card's planning constants, with the
    shadow verifier on: per cluster, SLO attainment by type, chip-hours,
    peak chips, spills and re-routes, migrations. Chip-hours only: the
    accelerator rows' prices are TPU list prices. Fails if a request is lost
    or the verifier raises."""
    from repro_torch.analysis import ShadowVerifier
    from repro_torch.sim.scenarios import build_trace
    from repro_torch.sim.simulator import simulate_fleet
    for name in FLEET_ON_CARD:
        trace, kw = build_trace(name, seed=0)
        fleet = kw["fleet"]()
        rows = {fc.spec.accelerator for fc in fleet.clusters}
        if rows != {"v5e"}:
            fail(f"sim fleet {name}: clusters on {sorted(rows)}, not the baseline row")
        verifier = ShadowVerifier()
        t0 = time.perf_counter()
        try:
            res = simulate_fleet(trace, fleet, max_time=kw["max_time"], warm_start=1,
                                 outages=kw.get("outages"), shadow_verify=verifier)
        except ShadowVerifyError as e:
            fail(f"sim fleet {name}: the shadow verifier raised: {e}")
        wall = time.perf_counter() - t0
        _terminal_or_fail(f"fleet {name}", res)
        if res.completion_rate() < 1.0:
            fail(f"sim fleet {name}: completion rate {res.completion_rate()}")
        s = res.summary()
        clusters = {c.name: {
            "region": c.region, "max_chips": fleet.by_name[c.name].spec.max_chips,
            "served_interactive": c.served_interactive, "served_batch": c.served_batch,
            "slo_interactive": c.slo_interactive(),
            "slo_batch": c.slo_met_batch / c.served_batch if c.served_batch else None,
            "chip_hours": c.chip_seconds / 3600.0, "peak_chips": c.peak_chips,
            "remote_served": c.remote_served, "handbacks": c.handbacks,
            "migrations_in": c.migrations_in, "migrations_out": c.migrations_out,
            "scale_ups": c.scale_ups, "scale_downs": c.scale_downs}
            for c in res.clusters}
        emit("sim", check="fleet", gpu=smi, scenario=name,
             baseline_row="v5e key = this card's constants", requests=res.ledger.n,
             completion_rate=res.completion_rate(), slo_interactive=s["slo_interactive"],
             slo_batch=s["slo_batch"], chip_hours=s["gpu_hours"], peak_chips=res.peak_chips,
             migrations=res.migrations, handbacks=res.handbacks,
             recovery=res.recovery_metrics(), clusters=clusters,
             shadow_checks={"ledger": verifier.ledger_checks, "plane": verifier.plane_checks,
                            "queue": verifier.queue_checks},
             events=res.n_events, wall_s=wall)


def _scenarios(smi: str) -> None:
    """Every other registered scenario at its default size through
    ``simulate_events`` on the card's planning constants and the paper's
    budget of 50 cards (the overload scenarios' own caps where they set
    one): completion, SLO attainment by type, chip-hours, host wall. Fails
    if a request is lost."""
    from repro_torch.sim.scenarios import SCENARIOS, build_trace
    rows = {}
    for name in sorted(SCENARIOS):
        if name in FLEET_ON_CARD + HELD_ON_CPU:
            continue
        trace, kw = build_trace(name, seed=0)
        cluster = SimCluster(default_perf_factory(), max_chips=kw.get("max_chips", FIG19_CHIPS))
        ctrl = ChironController(**({"models": kw["models"]} if "models" in kw else {}))
        t0 = time.perf_counter()
        res = simulate_events(trace, ctrl, cluster, max_time=kw["max_time"], warm_start=2,
                              failures=kw.get("failures"), degradations=kw.get("degradations"),
                              outages=kw.get("outages"), flash_crowds=kw.get("flash_crowds"),
                              detector=kw.get("detector"), overload=kw.get("overload"))
        wall = time.perf_counter() - t0
        _terminal_or_fail(f"scenario {name}", res)
        s = res.summary()
        rows[name] = {"requests": res.ledger.n, "max_chips": cluster.max_chips,
                      "completion_rate": s["completion_rate"],
                      "slo_interactive": s["slo_interactive"], "slo_batch": s["slo_batch"],
                      "chip_hours": s["gpu_hours"], "peak_chips": res.peak_chips,
                      "wall_s": wall}
    emit("sim", check="scenarios", gpu=smi, rows=rows,
         held_on_the_cpu_only={name: "rows scaled for TPU parts" for name in HELD_ON_CPU},
         wall_s=sum(r["wall_s"] for r in rows.values()))


def phase_sim(smi: str, served) -> None:
    """The port's simulator on the card's planning constants: the measured
    host-to-card load rate beside ``_LOAD_BW``, the planned prefill beside the
    measured one (when ``serve`` ran in this call), and Fig. 19 under both
    controllers on the shipped constants and, when ``serve`` ran, on that
    run's own fitted ``MBU`` and ``STEP_OVERHEAD``. The simulator is host code
    and launches no kernel."""
    from repro_torch.sim import perf_model
    _load_bandwidth(smi)
    fig19 = _fig19(smi, "shipped")
    _audit(smi)
    _export(smi, fig19)
    _fleet(smi)
    _scenarios(smi)
    if served is None:
        return
    _prefill_plan(smi, served)
    fit = served["fit"]
    saved = perf_model.MBU, perf_model.STEP_OVERHEAD
    perf_model.MBU, perf_model.STEP_OVERHEAD = fit["MBU"], fit["STEP_OVERHEAD_s"]
    try:
        _fig19(smi, "fitted in this run")
    finally:
        perf_model.MBU, perf_model.STEP_OVERHEAD = saved


# ------------------------------------------------------------ the launch layer
# no card runs above its roofline: a planned step longer than the measured
# one by more than this says the plan's count is wrong
ROOFLINE_SHARE_MAX = 1.05
TRAIN_SHAPE = InputShape("train_8x128", 128, 8, "train")


def _port_env() -> dict:
    return dict(os.environ, PYTHONPATH=os.path.join(HERE, "src"))


def _dryrun(smi: str) -> None:
    """``python -m repro_torch.launch.dryrun --all`` (in four processes):
    every arch x input shape on the meta device. One line a pair and the
    run's wall seconds; fails unless every pair traced."""
    with tempfile.TemporaryDirectory() as d:
        out = os.path.join(d, "dryrun.jsonl")
        t0 = time.monotonic()
        run = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun", "--all",
                              "--out", out],
                             env=_port_env(), capture_output=True, text=True, timeout=600)
        wall = time.monotonic() - t0
        records = []
        if os.path.exists(out):
            with open(out) as f:
                records = [json.loads(line) for line in f]
    if run.returncode != 0 or len(records) != 40 or \
            any(r["status"] != "ok" for r in records):
        fail(f"launch: the dry run exited {run.returncode} with {len(records)} records:\n"
             f"{run.stdout[-3000:]}{run.stderr[-3000:]}")
    for rec in records:
        emit("launch_dryrun", gpu=smi, **rec)
    emit("launch_dryrun_summary", gpu=smi, pairs=len(records), wall_s=wall,
         last_line=run.stdout.strip().splitlines()[-1],
         fits=sum(r["fits"] for r in records))


def _plan_line(smi: str, path: str, cfg, shape, measured_ms: float, **kw) -> float:
    """The roofline of ``shape``'s step (``launch/roofline.py``, on the meta
    device) beside the device time measured for it; returns its share."""
    terms, mem = roofline.plan(cfg, shape, **kw)
    measured_s = measured_ms / 1e3
    share = terms.step_time_s / measured_s
    emit("launch_plan", gpu=smi, path=path, kind=shape.kind, dtype=terms.dtype,
         batch=shape.global_batch, seq=shape.seq_len, context=kw.get("context"),
         remat=kw.get("remat"), flops=terms.flops, hbm_bytes=terms.hbm_bytes,
         model_flops=terms.model_flops, peak_flops=terms.peak_flops,
         compute_s=terms.compute_s, memory_s=terms.memory_s,
         bottleneck=terms.bottleneck, step_time_s=terms.step_time_s,
         measured_device_s=measured_s, roofline_share=share,
         mfu=terms.model_flops / (measured_s * terms.peak_flops),
         arg_bytes=mem["arg_bytes"])
    return share


def phase_launch(smi: str, served, trained) -> None:
    """The launch layer: the dry run over every arch x input shape, then
    the planned step (``roofline.plan``) beside each graphed decode step the
    ``serve`` phase measured (8 slots at its mean context, bf16) and the two
    train steps the ``train`` phase profiled (8 x 128, float32, remat),
    with the measured device seconds, ``roofline_share`` = planned /
    measured and ``mfu`` = model FLOPs / (measured x the dtype's peak).
    Fails if a share reads above ``ROOFLINE_SHARE_MAX``."""
    _dryrun(smi)
    shares = {}
    for arch, share in (served or {}).get("shares", {}).items():
        ctx = share["decode_mean_context"]
        shape = InputShape(f"decode_8x{ctx:g}", int(np.ceil(ctx)), 8, "decode")
        shares[f"{arch} decode"] = _plan_line(
            smi, arch, get_config(arch).with_(dtype="bfloat16"), shape,
            share["decode_device_ms_per_step"], context=ctx)
    for arch, ms in (trained or {}).items():
        shares[f"{arch} train"] = _plan_line(
            smi, arch, get_config(arch).with_(dtype="float32"), TRAIN_SHAPE, ms,
            remat=True)
    high = {k: v for k, v in shares.items() if v > ROOFLINE_SHARE_MAX}
    if high:
        fail(f"launch: planned steps longer than the measured ones: {high}")
    emit("launch", gpu=smi, roofline_shares=shares)


# ------------------------------------------------------------ the twins
# each model-running twin of examples/ and scripts/ at its smoke size on the
# card, and the line that says it worked
EXAMPLES = (
    ("examples/quickstart_torch.py", (), "decoded 4 tokens"),
    ("examples/serve_autoscaled_torch.py", (), "8/8 requests served"),
    ("examples/serve_autoscaled_torch.py", ("--arch", "mamba2-1.3b"), "8/8 requests served"),
    ("examples/train_tiny_torch.py", ("--steps", "5"), "over 5 steps"),
    ("scripts/dev_engine_torch.py", (), "ENGINE OK"),
    ("scripts/dev_smoke_torch.py", (), "ALL OK"),
    ("scripts/dev_kernels_torch.py", (), "ALL KERNELS OK"),
)
EXAMPLE_LIMIT_S = 300


def phase_examples(smi: str) -> None:
    """Every model-running twin on the card (its default device), all
    started together (the kernels are already built); fails unless each
    exits 0 within ``EXAMPLE_LIMIT_S`` and prints its key line."""
    running = []
    for script, args, key in EXAMPLES:
        t0 = time.monotonic()
        proc = subprocess.Popen([sys.executable, os.path.join(HERE, script), *args],
                                env=_port_env(), cwd=HERE, stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)
        running.append((script, args, key, proc, t0))
    failed = []
    for script, args, key, proc, t0 in running:
        try:
            out, err = proc.communicate(timeout=EXAMPLE_LIMIT_S)
        except subprocess.TimeoutExpired:
            proc.kill()
            out, err = proc.communicate()
        wall = time.monotonic() - t0
        line = next((ln for ln in out.splitlines() if key in ln), None)
        emit("examples", gpu=smi, script=script, args=list(args), rc=proc.returncode,
             wall_s=wall, key_line=line)
        if proc.returncode != 0 or line is None:
            failed.append(f"{script} {' '.join(args)} (exit {proc.returncode}):\n"
                          f"{out[-1500:]}{err[-3000:]}")
    if failed:
        fail("examples: " + "\n".join(failed))


# ------------------------------------------------- two trees, in turns
def ab_turn(src: str, turn: int) -> None:
    """One ``--ab`` turn: device and event times of the kernels of the port
    this process imported (``src``), built from that tree's sources, at the
    serving path's shapes in bf16, the float32 forwards at the training
    shapes, and the attention's gradient at the
    backward's three shapes, on the same inputs in every turn. Uses only the
    wrappers' signatures, which every slice of the port keeps (a backward
    that takes the forward's log-sum-exp is also timed given it), and, in a
    tree with an SSD backward, that backward at mamba2-1.3b's and
    zamba2-2.7b's training shapes. First, before anything has run on
    PyTorch's autograd thread, the bf16 SSD forward under remat and from a
    new host thread (``_ssd_remat_bf16``): whether each tree's encoder finds
    a context there, reported as a result, not a failure."""
    _build.build_all()
    dev, bf16 = "cuda", torch.bfloat16
    gen = torch.Generator(device=dev)

    def emit_ab(kernel, case, fn):
        emit("ab", src=src, turn=turn, kernel=kernel, case=case,
             device_ms=device_ms(fn), call_ms=time_ms(fn),
             gpu=torch.cuda.get_device_name(0))

    if ssd_scan_backward is not None:
        gen.manual_seed(5)
        try:   # a parent tree without the context bind raises: that is its result
            _ssd_remat_bf16(gen)
            result = "passed"
        except RuntimeError as e:
            result = f"raised: {e}"
        emit("ab", src=src, turn=turn, kernel="ssd_scan",
             case="bf16 under remat, then from a new host thread", result=result)

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

    # the float32 forwards that training launches: flash_prefill with the
    # log-sum-exp at olmo-1b's training shape, ssd_scan at mamba2-1.3b's and
    # zamba2-2.7b's (strided x, B, C; input sets rotating); a tree before
    # their 3xTF32 kernels runs its FMA kernels there
    gen.manual_seed(7)
    qt, kt, vt = _flash_inputs(gen, torch.float32, 8, 128, 128, 16, 16, 128)
    emit_ab("flash_prefill", "olmo-1b training, float32, with the log-sum-exp",
            lambda: _flash_forward(qt, kt, vt, causal=True, q_offset=0, window=0,
                                   prefix_len=0, with_lse=True))
    # and, beside them, float32 shapes that stay on the FMA kernel in both
    # trees (two chunks, at mamba2-1.3b's N 128 and zamba2-2.7b's N 64)
    for case, b, s, h, n in (("mamba2-1.3b training", 8, 128, 64, 128),
                             ("zamba2-2.7b training", 8, 128, 80, 64),
                             ("mamba2-1.3b s=341 (FMA kernel)", 1, 341, 64, 128),
                             ("zamba2-2.7b s=341 (FMA kernel)", 1, 341, 80, 64)):
        gen.manual_seed(8)
        sets, A, _ = _ssd_case(gen, torch.float32, b, s, h, 64, n, copies=4, strided=True)
        rot = [0]

        def ssd_fp32():
            rot[0] = (rot[0] + 1) % len(sets)
            x, dt, Bm, Cm = sets[rot[0]]
            ssd_scan(x, dt, A, Bm, Cm, chunk=256)
        emit_ab("ssd_scan", f"{case}, float32", ssd_fp32)

    # the backward called directly (a tree whose backward takes the
    # log-sum-exp launches the forward for it first), given the saved
    # log-sum-exp where it takes one, and forward plus backward through
    # ``FlashPrefill`` under autograd
    takes_lse = "lse" in inspect.signature(flash_prefill_backward).parameters
    for dtype, case, B, H, D, S, causal in (
            (bf16, "whisper-base encoder, full", 1, 8, 64, 1500, False),
            (bf16, "olmo-1b training", 8, 16, 128, 128, True),
            (torch.float32, "olmo-1b training", 8, 16, 128, 128, True)):
        gen.manual_seed(4)
        qt, kt, vt = _flash_inputs(gen, dtype, B, S, S, H, H, D)
        do = torch.randn((B, S, H, D), generator=gen, device=dev).to(dtype).transpose(1, 2)
        o = flash_prefill(qt, kt, vt, causal=causal)
        label = f"{case}, {str(dtype).removeprefix('torch.')}"
        emit_ab("flash_prefill_backward", label,
                lambda: flash_prefill_backward(qt, kt, vt, o, do, causal=causal))
        if takes_lse:
            _, lse = _flash_forward(qt, kt, vt, causal=causal, q_offset=0, window=0,
                                    prefix_len=0, with_lse=True)
            emit_ab("flash_prefill_backward", f"{label}, given lse",
                    lambda: flash_prefill_backward(qt, kt, vt, o, do, causal=causal, lse=lse))
        leaves = [t.detach().clone().requires_grad_(True) for t in (qt, kt, vt)]

        def fwd_bwd():
            with torch.enable_grad():
                torch.autograd.grad(flash_prefill(*leaves, causal=causal), leaves, do)
        emit_ab("FlashPrefill forward + backward", label, fwd_bwd)

    if ssd_scan_backward is not None:
        for dtype in (torch.float32, bf16):
            for case, h, n in (("mamba2-1.3b training", 64, 128),
                               ("zamba2-2.7b training", 80, 64)):
                gen.manual_seed(6)
                sets, A, _ = _ssd_case(gen, dtype, 8, 128, h, 64, n, strided=True)
                x, dt, Bm, Cm = sets[0]
                dy = torch.randn((8, 128, h, 64), generator=gen, device=dev).to(dtype)
                emit_ab("ssd_scan_backward", f"{case}, {str(dtype).removeprefix('torch.')}",
                        lambda: ssd_scan_backward(x, dt, A, Bm, Cm, None, dy, None, chunk=256))


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
    if "graph" in phases:
        phase_graph()
    launches, served = phase_serve(smi) if "serve" in phases else ({}, None)
    cluster_launches = phase_cluster(smi) if "cluster" in phases else {}
    train_launches, trained = phase_train(smi) if "train" in phases else ({}, None)
    if "sim" in phases:
        phase_sim(smi, served)
    if "launch" in phases:
        phase_launch(smi, served, trained)
    if "examples" in phases:
        phase_examples(smi)
    if set(phases) != set(ALL_PHASES):
        print(f"chip_smoke: partial run ({phases}); no result line")
        return
    # each kernel's launches over the main paths it serves: its serve path's,
    # for the attention kernels the cluster's, and the training run's
    total = {name: launches[name] + cluster_launches.get(name, 0) +
             train_launches.get(name, 0) for name in KERNELS}
    # the float32 forwards' 3xTF32 kernels run on the training path only
    # (serving is bf16): their rows count them, and their wrappers' rows
    # only the wrappers' other kernels, so that no launch is counted twice
    for name, wrapper in zip(TF32_KERNELS, TENSOR_CORE_KERNELS):
        total[name] = train_launches[name]
        total[wrapper] -= train_launches[name]
    idle = [name for name, n in total.items() if n <= 0]
    if idle:
        fail(f"no launch on the main paths of {idle}: {total}")
    emit("launches", serve=launches, cluster=cluster_launches, train=train_launches,
         total=total)
    kernels = [{**records[name], "launches": total[name]}
               for name in (*KERNELS, *TF32_KERNELS)]
    # bound_fp32_fma_ms: the kernels that run float32 on the tensor cores in
    # 3xTF32 also carry the bound at the FMA rate beside their own
    order = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
             "plain_ms", "bound_ms", "bound_by", "library_ms", "bound_fp32_fma_ms")
    print(json.dumps({"kernels": [{k: rec[k] for k in order if k in rec}
                                  for rec in kernels]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
