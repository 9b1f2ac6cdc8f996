"""Prompt-prefix KV cache (paper Fig. 11's "prefix caching" knob, real).

The port's copy of ``repro.serving.prefix_cache``. Stores finished prompts'
KV caches keyed by their token sequence; a new request reuses the longest
stored prefix and prefills only the suffix (via the model layer's
``past_cache`` chunked-prefill path). LRU-bounded.

A stored cache is the dense cache ``Model.prefill`` returned (``k``, ``v``
(L, 1, S, Hkv, D) and ``pos`` (1,), on the engine's device). Nothing writes
into it later: the engine copies it into a slot of its pool, and a prefill
that continues from it copies it into a new cache.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Any, Optional, Tuple

import torch


class PrefixCache:
    def __init__(self, max_entries: int = 16):
        self.max_entries = max_entries
        self._store: "OrderedDict[Tuple[int, ...], Any]" = OrderedDict()
        self.hits = 0
        self.misses = 0
        self.hit_tokens = 0

    @staticmethod
    def _common_prefix(a: Tuple[int, ...], b: Tuple[int, ...]) -> int:
        n = 0
        for x, y in zip(a, b):
            if x != y:
                break
            n += 1
        return n

    @staticmethod
    def _slice_cache(cache, n: int):
        """Truncate a dense transformer cache to its first n positions
        (views of the stored tensors)."""
        return {
            "k": cache["k"][:, :, :n],
            "v": cache["v"][:, :, :n],
            "pos": torch.full_like(cache["pos"], n),
        }

    def lookup(self, tokens, min_tokens: int = 1) -> Tuple[Optional[Any], int]:
        """Longest common prefix between ``tokens`` and any stored prompt
        (leaving at least one token to prefill); the stored cache is sliced
        to the shared length. Returns (cache, n_reused)."""
        key = tuple(int(t) for t in tokens)
        best_key, best_n = None, 0
        for k in self._store:
            n = min(self._common_prefix(k, key), len(key) - 1)
            if n > best_n:
                best_key, best_n = k, n
        if best_key is None or best_n < min_tokens:
            self.misses += 1
            return None, 0
        self._store.move_to_end(best_key)
        self.hits += 1
        self.hit_tokens += best_n
        cache = self._store[best_key]
        if best_n < len(best_key):
            cache = self._slice_cache(cache, best_n)
        return cache, best_n

    def store(self, tokens, cache) -> None:
        key = tuple(int(t) for t in tokens)
        if not key:
            return
        self._store[key] = cache
        self._store.move_to_end(key)
        while len(self._store) > self.max_entries:
            self._store.popitem(last=False)

    def __len__(self) -> int:
        return len(self._store)
