"""Paged KV-cache block allocator (vLLM-style).

The port's copy of ``repro.serving.kv_manager``. Tracks page ownership for
every sequence, supports append-one-token growth, whole-sequence free, and
host offload/restore (the mechanism Chiron's mixed instances use for fast
batch-request restart after eviction). The allocator is pure bookkeeping:
the page pools live with the engine and the kernels, and a block table it
hands out addresses them as ``paged_attention``'s ``block_tables`` rows.
As in the reference, the engine does not allocate through it: slot ``i``
keeps its fixed page range. Tests drive it with hypothesis to check the
no-leak / no-double-alloc invariants.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set


class OutOfPagesError(RuntimeError):
    pass


@dataclass
class SeqAlloc:
    pages: List[int] = field(default_factory=list)
    n_tokens: int = 0
    on_host: bool = False


class PagedKVManager:
    def __init__(self, num_pages: int, page_size: int):
        assert num_pages > 0 and page_size > 0
        self.num_pages = num_pages
        self.page_size = page_size
        self._free: List[int] = list(range(num_pages - 1, -1, -1))
        self._seqs: Dict[int, SeqAlloc] = {}

    # ------------------------------------------------------------ queries
    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def used_pages(self) -> int:
        return self.num_pages - len(self._free)

    def utilization(self) -> float:
        return self.used_pages / self.num_pages

    def pages_needed(self, n_tokens: int) -> int:
        return -(-n_tokens // self.page_size)

    def has_seq(self, seq_id: int) -> bool:
        return seq_id in self._seqs and not self._seqs[seq_id].on_host

    def block_table(self, seq_id: int) -> List[int]:
        return list(self._seqs[seq_id].pages)

    def seq_tokens(self, seq_id: int) -> int:
        return self._seqs[seq_id].n_tokens

    def can_allocate(self, n_tokens: int) -> bool:
        return self.pages_needed(n_tokens) <= self.free_pages

    # ------------------------------------------------------------ mutation
    def allocate(self, seq_id: int, n_tokens: int) -> List[int]:
        if seq_id in self._seqs:
            raise ValueError(f"seq {seq_id} already allocated")
        need = self.pages_needed(n_tokens)
        if need > len(self._free):
            raise OutOfPagesError(
                f"need {need} pages, have {len(self._free)}")
        pages = [self._free.pop() for _ in range(need)]
        self._seqs[seq_id] = SeqAlloc(pages, n_tokens)
        return list(pages)

    def append_token(self, seq_id: int) -> Optional[int]:
        """Grow a sequence by one token; returns the new page id if one was
        allocated, else None. Raises OutOfPagesError when the pool is full."""
        sa = self._seqs[seq_id]
        if sa.on_host:
            raise ValueError(f"seq {seq_id} is offloaded")
        sa.n_tokens += 1
        if sa.n_tokens > len(sa.pages) * self.page_size:
            if not self._free:
                sa.n_tokens -= 1
                raise OutOfPagesError("pool full on append")
            page = self._free.pop()
            sa.pages.append(page)
            return page
        return None

    def free(self, seq_id: int) -> None:
        sa = self._seqs.pop(seq_id)
        if not sa.on_host:
            self._free.extend(sa.pages)

    # ------------------------------------------------- host offload (swap)
    def swap_out(self, seq_id: int) -> SeqAlloc:
        """Release the device pages; the sequence's logical allocation stays
        recorded so swap_in can restore it (engine copies the page data)."""
        sa = self._seqs[seq_id]
        if sa.on_host:
            raise ValueError("already on host")
        self._free.extend(sa.pages)
        sa.pages = []
        sa.on_host = True
        return sa

    def swap_in(self, seq_id: int) -> List[int]:
        sa = self._seqs[seq_id]
        if not sa.on_host:
            raise ValueError("not on host")
        need = self.pages_needed(sa.n_tokens)
        if need > len(self._free):
            raise OutOfPagesError("cannot swap in")
        sa.pages = [self._free.pop() for _ in range(need)]
        sa.on_host = False
        return list(sa.pages)

    # ------------------------------------------------------------ checking
    def check_invariants(self) -> None:
        owned: Set[int] = set()
        for sid, sa in self._seqs.items():
            for p in sa.pages:
                assert p not in owned, f"page {p} double-owned"
                owned.add(p)
            if not sa.on_host:
                assert len(sa.pages) == self.pages_needed(sa.n_tokens) or \
                    sa.n_tokens == 0
        free = set(self._free)
        assert len(free) == len(self._free), "duplicate free pages"
        assert not (free & owned), "page both free and owned"
        assert len(free) + len(owned) == self.num_pages, "pages leaked"
