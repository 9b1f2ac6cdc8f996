"""The port's copy of the paged KV allocator (``serving/kv_manager.py``):
the cases and the hypothesis state machine of ``tests/test_kv_manager.py``
run against it, the same operations give the reference's block tables page
for page, and a block table it hands out addresses the page pool of
``paged_attention`` (its plain version on the CPU)."""
import numpy as np
import pytest
import torch
from _hypothesis_compat import (RuleBasedStateMachine, given, invariant,
                                precondition, rule, settings, st)

from repro.serving import kv_manager as ref_kv
from repro_torch.kernels.paged_attention import paged_attention_plain
from repro_torch.serving.kv_manager import OutOfPagesError, PagedKVManager, SeqAlloc

# the test workers share the host's cores: cap each one's intra-op threads
torch.set_num_threads(2)


def test_basic_alloc_free():
    m = PagedKVManager(num_pages=10, page_size=16)
    pages = m.allocate(1, 40)          # 3 pages
    assert len(pages) == 3
    assert m.free_pages == 7
    m.free(1)
    assert m.free_pages == 10
    m.check_invariants()


def test_append_grows_page():
    m = PagedKVManager(num_pages=4, page_size=4)
    m.allocate(1, 4)
    assert m.used_pages == 1
    for _ in range(4):
        m.append_token(1)
    assert m.used_pages == 2
    assert m.seq_tokens(1) == 8
    m.check_invariants()


def test_out_of_pages():
    m = PagedKVManager(num_pages=2, page_size=4)
    m.allocate(1, 8)
    with pytest.raises(OutOfPagesError):
        m.allocate(2, 1)
    with pytest.raises(OutOfPagesError):
        m.append_token(1)
    m.check_invariants()


def test_swap_out_in_roundtrip():
    m = PagedKVManager(num_pages=4, page_size=4)
    m.allocate(1, 10)
    assert m.used_pages == 3
    sa = m.swap_out(1)
    assert isinstance(sa, SeqAlloc) and sa.on_host and sa.pages == []
    assert m.free_pages == 4
    assert not m.has_seq(1)
    m.allocate(2, 16)
    with pytest.raises(OutOfPagesError):
        m.swap_in(1)
    m.free(2)
    pages = m.swap_in(1)
    assert len(pages) == 3
    assert m.seq_tokens(1) == 10
    m.check_invariants()


def test_refusals():
    m = PagedKVManager(num_pages=4, page_size=4)
    m.allocate(1, 3)
    with pytest.raises(ValueError, match="already"):
        m.allocate(1, 3)
    m.swap_out(1)
    with pytest.raises(ValueError, match="offloaded"):
        m.append_token(1)
    with pytest.raises(ValueError, match="already on host"):
        m.swap_out(1)
    m.swap_in(1)
    with pytest.raises(ValueError, match="not on host"):
        m.swap_in(1)
    assert m.can_allocate(12) and not m.can_allocate(13)
    assert m.utilization() == 0.25
    m.check_invariants()


@given(ops=st.lists(st.tuples(st.integers(0, 4), st.integers(0, 5), st.integers(1, 30)),
                    max_size=60))
@settings(max_examples=40, deadline=None)
def test_same_block_tables_as_reference(ops):
    """One sequence of operations on both allocators: the same pages in the
    same order, the same refusals and the same counts throughout."""
    ours = PagedKVManager(num_pages=24, page_size=4)
    theirs = ref_kv.PagedKVManager(num_pages=24, page_size=4)

    def run(m, errors, op, sid, n):
        try:
            if op == 0:
                return m.allocate(sid, n)
            if op == 1:
                return m.append_token(sid)
            if op == 2:
                return m.free(sid)
            if op == 3:
                return m.swap_out(sid).n_tokens
            return m.swap_in(sid)
        except (KeyError, ValueError, errors) as e:
            return type(e).__name__

    for op, sid, n in ops:
        assert run(ours, OutOfPagesError, op, sid, n) == \
            run(theirs, ref_kv.OutOfPagesError, op, sid, n)
        assert (ours.free_pages, ours.used_pages) == (theirs.free_pages, theirs.used_pages)
        for s in range(6):
            assert ours.has_seq(s) == theirs.has_seq(s)
            if ours.has_seq(s):
                assert ours.block_table(s) == theirs.block_table(s)
                assert ours.seq_tokens(s) == theirs.seq_tokens(s)
        ours.check_invariants()


def test_block_table_addresses_the_paged_attention_pool():
    """Allocate, append across pages, swap out and back in (to other pages):
    a block table from the manager, padded with garbage past the sequence's
    pages, drives ``paged_attention`` over the pool the data was written to,
    as the reference's ``test_allocator_kernel_end_to_end`` does."""
    page, num_pages, n_kv, group, D = 16, 24, 2, 4, 64
    m = PagedKVManager(num_pages=num_pages, page_size=page)
    rng = np.random.default_rng(0)
    kp = torch.zeros((num_pages, page, n_kv, D))
    vp = torch.zeros_like(kp)
    lengths = {0: 20, 1: 45, 2: 7}
    data = {s: (torch.from_numpy(rng.standard_normal((n + 20, n_kv, D), dtype=np.float32)),
                torch.from_numpy(rng.standard_normal((n + 20, n_kv, D), dtype=np.float32)))
            for s, n in lengths.items()}

    def write(s):
        for t, p in enumerate(m.block_table(s)):
            lo, hi = t * page, min((t + 1) * page, m.seq_tokens(s))
            kp[p, :hi - lo] = data[s][0][lo:hi]
            vp[p, :hi - lo] = data[s][1][lo:hi]

    for s, n in lengths.items():
        m.allocate(s, n)
    for _ in range(13):                 # sequence 1 grows 45 -> 58: a 4th page
        m.append_token(1)
    assert len(m.block_table(1)) == 4
    before = m.block_table(0)
    m.swap_out(0)
    m.allocate(3, 30)                   # takes pages sequence 0 gave back
    m.swap_in(0)
    assert m.block_table(0) != before
    m.check_invariants()
    seqs = [0, 1, 2]
    for s in seqs:
        write(s)
    width = 5
    bt = torch.full((len(seqs), width), 2 ** 30, dtype=torch.int32)
    for i, s in enumerate(seqs):
        bt[i, :len(m.block_table(s))] = torch.tensor(m.block_table(s), dtype=torch.int32)
    ln = torch.tensor([m.seq_tokens(s) for s in seqs], dtype=torch.int32)
    q = torch.from_numpy(rng.standard_normal((len(seqs), n_kv, group, D), dtype=np.float32))
    safe = torch.where(bt == 2 ** 30, 0, bt)
    got = paged_attention_plain(q, kp, vp, safe, ln)
    for i, s in enumerate(seqs):
        n = m.seq_tokens(s)
        k, v = data[s][0][:n], data[s][1][:n]
        sc = torch.einsum("kgd,tkd->kgt", q[i], k) / D ** 0.5
        want = torch.einsum("kgt,tkd->kgd", torch.softmax(sc, -1), v)
        np.testing.assert_allclose(got[i].numpy(), want.numpy(), atol=1e-5, rtol=1e-5)


class KVStateMachine(RuleBasedStateMachine):
    """Random alloc/append/free/swap sequences never violate invariants."""

    def __init__(self):
        super().__init__()
        self.m = PagedKVManager(num_pages=32, page_size=4)
        self.live = set()
        self.on_host = set()
        self.next_id = 0

    @rule(n_tokens=st.integers(1, 40))
    def allocate(self, n_tokens):
        sid = self.next_id
        self.next_id += 1
        try:
            self.m.allocate(sid, n_tokens)
            self.live.add(sid)
        except OutOfPagesError:
            pass

    @precondition(lambda self: self.live - self.on_host)
    @rule(data=st.data())
    def append(self, data):
        sid = data.draw(st.sampled_from(sorted(self.live - self.on_host)))
        try:
            self.m.append_token(sid)
        except OutOfPagesError:
            pass

    @precondition(lambda self: self.live)
    @rule(data=st.data())
    def free(self, data):
        sid = data.draw(st.sampled_from(sorted(self.live)))
        self.m.free(sid)
        self.live.discard(sid)
        self.on_host.discard(sid)

    @precondition(lambda self: self.live - self.on_host)
    @rule(data=st.data())
    def swap_out(self, data):
        sid = data.draw(st.sampled_from(sorted(self.live - self.on_host)))
        self.m.swap_out(sid)
        self.on_host.add(sid)

    @precondition(lambda self: self.on_host)
    @rule(data=st.data())
    def swap_in(self, data):
        sid = data.draw(st.sampled_from(sorted(self.on_host)))
        try:
            self.m.swap_in(sid)
            self.on_host.discard(sid)
        except OutOfPagesError:
            pass

    @invariant()
    def invariants_hold(self):
        self.m.check_invariants()


TestKVStateMachine = KVStateMachine.TestCase
TestKVStateMachine.settings = settings(max_examples=30,
                                       stateful_step_count=40,
                                       deadline=None)
