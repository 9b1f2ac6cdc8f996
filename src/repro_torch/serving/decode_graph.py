"""The engine's decode step over static buffers, replayed as a CUDA graph.

The counterpart of the reference engine's ``jax.jit(model.decode_step)``
(``repro/serving/engine.py``): one ``DecodeGraph`` per engine holds static
device buffers for the input tokens ``(max_slots, 1)``, the ``active`` mask
``(max_slots,)``, the logits and the sampled next tokens, and a step
function that runs ``model.decode_step`` over the engine's slot pool, writes
the returned ``pos`` back into ``pool["pos"]`` in place, and takes the
argmax. On a CUDA device that function is captured once, when the engine is
built, and every decode iteration replays it; there is no eager fall-back,
and a failed capture raises. On the CPU the same function runs eagerly.

Capture. ``WARMUP_STEPS`` eager steps on a side stream go first (cuBLAS
handles, the kernels' libraries, their function attributes) on a clone of
the pool, so that the live pool is left as it was: a decode step of the ssm
and hybrid families advances the state of free rows too. Capture itself
executes nothing. Every ported family's step is capturable: the dense, vlm
and moe transformers (an MoE step dispatches over static capacity buffers,
without a host sync), the ssm and the hybrid model.

Launch counters. The kernel wrappers count a launch on the host, so a
replay would count nothing. The counters' change during capture is
recorded, taken back (nothing was launched), and added on every replay,
so a counter still says how many times its kernel ran. The warm-up's
launches ran and stay counted.
"""
from __future__ import annotations

import gc
import time
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.kernels.flash_prefill import flash_prefill
from repro_torch.kernels.paged_attention import paged_attention
from repro_torch.kernels.ssd_scan import ssd_scan

WARMUP_STEPS = 2

# every launch counter of the kernel wrappers
COUNTERS = ((paged_attention, "launches"), (flash_prefill, "launches"),
            (flash_prefill, "tensor_core_launches"),
            (flash_prefill, "offset_launches"), (flash_prefill, "window_launches"),
            (flash_prefill, "prefix_launches"), (flash_prefill, "full_launches"),
            (ssd_scan, "launches"),
            (ssd_scan, "tensor_core_launches"))


def read_counts() -> Tuple[int, ...]:
    """The counters of ``COUNTERS``, in that order."""
    return tuple(getattr(fn, attr) for fn, attr in COUNTERS)


def count_delta(before: Sequence[int], after: Sequence[int]) -> Tuple[int, ...]:
    return tuple(a - b for a, b in zip(after, before))


def add_counts(delta: Sequence[int], times: int = 1) -> None:
    """Add ``times`` x ``delta`` to the counters of ``COUNTERS``."""
    for (fn, attr), d in zip(COUNTERS, delta):
        setattr(fn, attr, getattr(fn, attr) + times * d)


def named_counts(counts: Sequence[int]) -> Dict[str, int]:
    return {f"{fn.__name__}.{attr}": c for (fn, attr), c in zip(COUNTERS, counts)}


class DecodeGraph:
    """One engine's decode step over static buffers (see the module
    docstring); ``run`` is one decode iteration."""

    def __init__(self, model, params, pool: Dict[str, torch.Tensor],
                 max_slots: int, dtype, device: torch.device):
        self.model = model
        self.params = params
        self.pool = pool
        self.device = device
        cuda = device.type == "cuda"
        self.tokens = torch.zeros((max_slots, 1), dtype=torch.long, device=device)
        self.active = torch.zeros((max_slots,), dtype=torch.bool, device=device)
        self.logits = torch.zeros((max_slots, model.cfg.vocab_size), dtype=dtype,
                                  device=device)
        self.next_token = torch.zeros((max_slots,), dtype=torch.long, device=device)
        # host staging, pinned on a CUDA device so that the copies are DMA
        self._host_tokens = torch.zeros((max_slots, 1), dtype=torch.long,
                                        pin_memory=cuda)
        self._host_active = torch.zeros((max_slots,), dtype=torch.bool,
                                        pin_memory=cuda)
        self._host_next = torch.zeros((max_slots,), dtype=torch.long,
                                      pin_memory=cuda)
        self._graph: Optional[torch.cuda.CUDAGraph] = None
        self._closed = False
        self.replay_counts: Tuple[int, ...] = (0,) * len(COUNTERS)
        self.capture_s: Optional[float] = None     # warm-up and capture, wall
        self.graph_pool_bytes: Optional[int] = None
        if cuda:
            self._capture()

    @torch.no_grad()
    def _step(self, pool: Dict[str, torch.Tensor]) -> None:
        logits, cache = self.model.decode_step(self.params, self.tokens, pool,
                                               self.active)
        pool["pos"].copy_(cache["pos"])
        self.logits.copy_(logits)
        self.next_token.copy_(torch.argmax(logits, -1))

    def _capture(self) -> None:
        # repro-lint: ok(DET202, capture cost on the real clock)
        t0 = time.monotonic()
        current = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(current)
        scratch = {key: t.clone() for key, t in self.pool.items()}
        with torch.cuda.stream(side):
            for _ in range(WARMUP_STEPS):
                self._step(scratch)
        current.wait_stream(side)
        del scratch
        # what torch.cuda.graph does on entry, done first so that the
        # reserved memory before and after differ by the graph's pool only
        torch.cuda.synchronize(self.device)
        gc.collect()
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(self.device)
        graph = torch.cuda.CUDAGraph()
        before = read_counts()
        with torch.cuda.graph(graph):
            self._step(self.pool)
        self.replay_counts = count_delta(before, read_counts())
        add_counts(self.replay_counts, -1)      # recorded, not launched
        torch.cuda.synchronize(self.device)
        self.graph_pool_bytes = torch.cuda.memory_reserved(self.device) - reserved
        self._graph = graph
        # repro-lint: ok(DET202, capture cost on the real clock)
        self.capture_s = time.monotonic() - t0

    def run(self, tokens: Sequence[int], active: Sequence[bool]) -> np.ndarray:
        """One decode iteration: ``tokens`` and ``active`` (one per slot)
        into the static buffers, the step (a replay on a CUDA device), and
        the sampled next tokens back on the host."""
        if self._closed:
            raise RuntimeError("DecodeGraph.run after close()")
        self._host_tokens.numpy()[:, 0] = tokens
        self._host_active.numpy()[:] = active
        self.tokens.copy_(self._host_tokens, non_blocking=True)
        self.active.copy_(self._host_active, non_blocking=True)
        if self._graph is None:       # the CPU: a CUDA instance holds its graph
            self._step(self.pool)
        else:
            self._graph.replay()
            add_counts(self.replay_counts)
        self._host_next.copy_(self.next_token, non_blocking=True)
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()
        return self._host_next.numpy().copy()

    def close(self) -> None:
        """Drop the graph (its memory pool is freed with it); ``run`` raises
        from then on."""
        if self._graph is not None:
            self._graph.reset()
            self._graph = None
        self._closed = True
