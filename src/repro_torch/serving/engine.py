"""Continuous-batching engine with real PyTorch execution.

This is the data plane of a serving instance: slot-based KV pool,
iteration-level scheduling (admit -> decode-one-token -> retire), preemption
of batch requests with host KV offload (Chiron's mixed-instance eviction),
and the ITL / throughput measurements the local autoscaler closes its loop
on. The max batch size is the knob Algorithm 1 turns.

The pool is the model family's decode cache for ``max_slots`` rows, and
the model writes, reads and restores one slot of it (``Model.write_slot`` /
``read_slot``): for the dense, moe and vlm families, page pools per layer
in which slot ``i`` owns a fixed, contiguous page range (prefill attention
through the ``flash_prefill`` kernel, decode attention through
``paged_attention``); for the ssm family, row ``i`` of the per-layer SSM and
conv states (every prefill's scan through the ``ssd_scan`` kernel); for the
hybrid family both, with a page pool per call of its shared attention
block.

The decode step is the counterpart of the reference's ``jax.jit`` of
``model.decode_step``: a ``DecodeGraph`` (``serving/decode_graph.py``)
captured once as a CUDA graph when the engine is built on a CUDA device and
replayed every iteration, run eagerly on the CPU. ``close()`` drops it.

The reference's serving knobs (transformer family only; paper Fig. 11):
``prefix_cache_entries`` reuses the longest cached prompt prefix
(``serving/prefix_cache.py``) and ``prefill_chunk`` prefills the rest in
chunks, both through ``Model.prefill(past_cache=...)``.

Against the reference engine (``repro.serving.engine``), on purpose:
- every decode iteration still runs over all ``max_slots`` rows, but an
  ``active`` mask keeps free slots from advancing ``pos`` and, in the
  families with attention, from writing K/V (a free slot's position would
  otherwise run past the end of its pages; free ssm rows update their state
  as the reference's do), and in the moe family from taking expert
  capacity;
- the sampled tokens are copied to the host before the clock is read, so
  the ITL handed to the autoscaler covers the device's work, not only its
  launch; slot positions and next tokens are mirrored on the host, so the
  bookkeeping costs no further device reads;
- ``submit`` refuses a prompt that does not fit a slot: one of 0 tokens, or
  of ``max_len`` or more positions, the VLM's vision prefix counted (the
  reference queues it and fails later).

A VLM's prompt batch carries zero vision embeddings
``(1, n_vision_tokens, d_model)``, as the reference's ``_prompt_batch``
does: the prompt fills ``n_vision_tokens + n`` positions of its slot. An
audio model's carries zero frame embeddings ``(1, enc_seq, d_model)``, as
the reference's does; its slot holds the encoder's K/V beside the prompt's
(a cross pool of ``enc_seq`` positions a row), and a preempted slot saves
both.
"""
from __future__ import annotations

# mirror-sync: module ok(real engine has no RequestLedger/InstancePlane)
# The columnar mirrors exist only in the simulated data plane.
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Deque, Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import Model
from repro_torch.models.api import resolve_device
from repro_torch.serving.decode_graph import DecodeGraph
from repro_torch.serving.prefix_cache import PrefixCache
from repro_torch.serving.request import Request, RequestState, RequestType


@dataclass
class StepStats:
    now: float
    n_active: int
    new_tokens: int
    finished: List[Request] = field(default_factory=list)
    itl: float = 0.0                 # seconds for this decode iteration
    throughput: float = 0.0          # tokens/s over the sliding window
    preempted: List[Request] = field(default_factory=list)


@dataclass
class _Slot:
    request: Optional[Request] = None
    token: Optional[int] = None      # next input token id (host copy)

    @property
    def active(self) -> bool:
        return self.request is not None


class Engine:
    def __init__(self, cfg: ModelConfig, *, gen: Optional[torch.Generator] = None,
                 params=None, max_slots: int = 8, max_len: int = 256,
                 max_batch_size: Optional[int] = None,
                 clock=time.monotonic, dtype=torch.float32, device="cuda",
                 prefix_cache_entries: int = 0, prefill_chunk: int = 0):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.model = Model(cfg)
        self.dtype = dtype
        self.params = params if params is not None else \
            self.model.init(gen, dtype=dtype, device=self.device)
        self.max_slots = max_slots
        self.max_len = max_len
        self.max_batch_size = max_batch_size or max_slots
        self.clock = clock
        # serving-optimization knobs (transformer family only; paper Fig.11)
        chunkable = cfg.arch_type in ("dense", "moe")
        self.prefill_chunk = prefill_chunk if chunkable else 0
        self.prefix_cache = None
        if prefix_cache_entries > 0 and chunkable:
            self.prefix_cache = PrefixCache(prefix_cache_entries)
        self.pool = self.model.init_cache(max_slots, max_len, dtype=dtype,
                                          device=self.device)
        self.decode_graph = DecodeGraph(self.model, self.params, self.pool,
                                        max_slots, dtype, self.device)
        self._pos = np.zeros((max_slots,), np.int64)   # host mirror of pool["pos"]
        self.slots: List[_Slot] = [_Slot() for _ in range(max_slots)]
        self.waiting: Deque[Request] = deque()
        self._last_step_t: Optional[float] = None
        self._window: Deque = deque(maxlen=32)   # (t, tokens) samples
        self._rng = np.random.default_rng(0)

    # ------------------------------------------------------------ metrics
    @property
    def n_active(self) -> int:
        return sum(s.active for s in self.slots)

    @property
    def n_waiting(self) -> int:
        return len(self.waiting)

    def utilization(self) -> float:
        return self.n_active / max(self.max_batch_size, 1)

    def running_types(self) -> List[RequestType]:
        return [s.request.request_type for s in self.slots if s.active]

    def throughput(self) -> float:
        if len(self._window) < 2:
            return 0.0
        dt = self._window[-1][0] - self._window[0][0]
        toks = sum(t for _, t in list(self._window)[1:])
        return toks / dt if dt > 0 else 0.0

    # ------------------------------------------------------------ intake
    def submit(self, req: Request) -> None:
        n = req.prompt_len if req.prompt_tokens is None else \
            int(np.asarray(req.prompt_tokens).size)
        n_vis = self.cfg.n_vision_tokens if self.cfg.arch_type == "vlm" else 0
        if not (n > 0 and n_vis + n < self.max_len):
            raise ValueError(f"prompt of {n} tokens (after {n_vis} vision "
                             f"tokens) does not fit a slot of max_len "
                             f"{self.max_len}")
        req.state = RequestState.QUEUED
        self.waiting.append(req)

    def set_max_batch_size(self, b: int) -> None:
        self.max_batch_size = max(1, min(int(b), self.max_slots))

    def close(self) -> None:
        """Drop the captured decode graph and its memory pool; the engine
        takes no further step."""
        self.decode_graph.close()

    # --------------------------------------------------------- slot cache
    def _set_pos(self, slot: int, pos: int) -> None:
        self.pool["pos"][slot] = pos
        self._pos[slot] = pos

    def _write_slot(self, slot: int, sub: Dict[str, torch.Tensor]) -> None:
        """Write a batch-of-1 cache (from a prefill, or a saved one) into
        ``slot``; its ``pos`` (1,) becomes the slot's position."""
        self.model.write_slot(self.pool, slot, sub)
        self._set_pos(slot, int(sub["pos"][0]))

    def _read_slot(self, slot: int) -> Dict[str, torch.Tensor]:
        """The slot's cache, copied to the host."""
        return self.model.read_slot(self.pool, slot, int(self._pos[slot]))

    def _restore_slot(self, slot: int, saved: Dict[str, torch.Tensor]) -> None:
        self._write_slot(slot, {key: t.to(self.device) for key, t in saved.items()})

    # ------------------------------------------------------------ admit
    def _free_slot(self) -> Optional[int]:
        for i, s in enumerate(self.slots):
            if not s.active:
                return i
        return None

    def _prompt_tokens(self, req: Request) -> np.ndarray:
        if req.prompt_tokens is not None:
            return np.asarray(req.prompt_tokens, np.int32).reshape(-1)
        return self._rng.integers(0, self.cfg.vocab_size,
                                  size=(req.prompt_len,), dtype=np.int32)

    def _prompt_batch(self, tokens: np.ndarray) -> Dict[str, torch.Tensor]:
        batch = {"tokens": torch.from_numpy(tokens).to(self.device).long()[None]}
        if self.cfg.arch_type == "audio":
            batch["frames"] = torch.zeros((1, self.cfg.enc_seq, self.cfg.d_model),
                                          dtype=self.dtype, device=self.device)
        if self.cfg.arch_type == "vlm":
            batch["vision"] = torch.zeros(
                (1, self.cfg.n_vision_tokens, self.cfg.d_model), dtype=self.dtype,
                device=self.device)
        return batch

    def _prefill(self, req: Request):
        """Prefill a prompt, via the prefix cache and/or in chunks when
        those knobs are enabled; returns (last_logits, dense cache)."""
        toks = self._prompt_tokens(req)
        past = None
        if self.prefix_cache is not None:
            past, consumed = self.prefix_cache.lookup(toks)
            remaining = toks[consumed:]
        else:
            remaining = toks
        chunk = self.prefill_chunk or len(remaining)
        logits = None
        for lo in range(0, len(remaining), chunk):
            logits, past = self.model.prefill(
                self.params, self._prompt_batch(remaining[lo:lo + chunk]),
                dtype=self.dtype, past_cache=past)
        if self.prefix_cache is not None:
            self.prefix_cache.store(toks, past)
        return logits, past

    def _admit(self, req: Request, now: float) -> bool:
        slot = self._free_slot()
        if slot is None:
            return False
        if req.saved_kv is not None:
            self._restore_slot(slot, req.saved_kv)
            req.saved_kv = None
            tok = 0       # as the reference: a restored request resumes on token 0
        else:
            logits, cache = self._prefill(req)
            self._write_slot(slot, cache)
            tok = int(torch.argmax(logits, -1)[0])
            req.tokens_generated += 1
            if req.first_token_time is None:
                req.first_token_time = now
        req.state = RequestState.RUNNING
        self.slots[slot] = _Slot(req, tok)
        return True

    def preempt_one_batch(self, now: float) -> Optional[Request]:
        """Evict the most recently admitted batch request (KV to host)."""
        for i in reversed(range(self.max_slots)):
            s = self.slots[i]
            if s.active and s.request.request_type == RequestType.BATCH:
                req = s.request
                req.saved_kv = self._read_slot(i)
                req.state = RequestState.PREEMPTED
                req.preemptions += 1
                self.slots[i] = _Slot()
                return req
        return None

    # ------------------------------------------------------------ step
    @torch.no_grad()
    def step(self) -> StepStats:
        now = self.clock()
        stats = StepStats(now=now, n_active=0, new_tokens=0)

        # 1. admit (interactive first — zero-queuing), preempting batch
        #    requests on a full instance if an interactive request waits.
        self.waiting = deque(sorted(
            self.waiting, key=lambda r: (not r.is_interactive, r.arrival_time)))
        while self.waiting and self.n_active < self.max_batch_size:
            req = self.waiting[0]
            if not self._admit(req, now):
                break
            self.waiting.popleft()
        if self.waiting and self.waiting[0].is_interactive and \
                self.n_active >= self.max_batch_size:
            victim = self.preempt_one_batch(now)
            if victim is not None:
                stats.preempted.append(victim)
                self._admit(self.waiting.popleft(), now)

        active_idx = [i for i, s in enumerate(self.slots) if s.active]
        stats.n_active = len(active_idx)
        if not active_idx:
            self._last_step_t = now
            return stats

        # 2. one decode iteration over the whole slot pool (a graph replay
        #    on a CUDA device); free slots are masked out
        next_tok = self.decode_graph.run(
            [s.token if s.active else 0 for s in self.slots],
            [s.active for s in self.slots])
        # the copy to the host waited for the step: read the clock after it
        t_end = self.clock()
        self._pos[active_idx] += 1
        itl = (t_end - self._last_step_t) if self._last_step_t else (t_end - now)
        self._last_step_t = t_end
        stats.itl = itl

        # 3. bookkeeping: ITL samples, finishes
        for i in active_idx:
            s = self.slots[i]
            req = s.request
            req.itl_samples.append(itl)
            req.tokens_generated += 1
            stats.new_tokens += 1
            if req.first_token_time is None:
                req.first_token_time = t_end
            if req.tokens_generated >= req.output_len or \
                    self._pos[i] >= self.max_len - 1:
                req.state = RequestState.FINISHED
                req.finish_time = t_end
                stats.finished.append(req)
                self.slots[i] = _Slot()
            else:
                s.token = int(next_tok[i])

        self._window.append((t_end, stats.new_tokens))
        stats.throughput = self.throughput()
        return stats
