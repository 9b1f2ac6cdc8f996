"""The port's plain PyTorch versions of the kernels against the reference:
``repro.kernels.ref`` and the Pallas kernels in interpret mode, on the same
numpy inputs. (The CUDA kernels themselves are held against these plain
versions on the card by ``chip_smoke.py``.)"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config
from repro.kernels import ops as ref_ops
from repro.kernels import ref as ref_ref
from repro.models import layers as ref_layers
from repro_torch.kernels import ops, ref
from repro_torch.kernels.flash_prefill import flash_prefill, flash_prefill_plain
from repro_torch.kernels.paged_attention import (
    PAGES_PER_SPLIT, paged_attention, paged_attention_merge_plain,
    paged_attention_partials_plain, paged_attention_plain,
    paged_attention_split_plain, split_plan)

# the test workers share the host's cores: cap each one's intra-op threads
torch.set_num_threads(2)

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _tol(name):
    # the reference's own kernel tolerances (tests/test_kernels.py::_tol):
    # bf16 outputs are rounded once more by each side
    return dict(atol=5e-2, rtol=5e-2) if name == "bfloat16" \
        else dict(atol=2e-4, rtol=2e-4)


def _both(x, name):
    """One numpy array -> (jax array, torch tensor) of dtype ``name``."""
    jd, td = DTYPES[name]
    return jnp.asarray(x).astype(jd), torch.from_numpy(x).to(td)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _paged_inputs(rng, B, n_kv, group, D, page, max_pages, num_pages):
    return (rng.standard_normal((B, n_kv, group, D), dtype=np.float32),
            rng.standard_normal((num_pages, page, n_kv, D), dtype=np.float32),
            rng.standard_normal((num_pages, page, n_kv, D), dtype=np.float32),
            rng.integers(0, num_pages, (B, max_pages)).astype(np.int32))


# ---------------------------------------------------------- paged attention
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,n_kv,group,D,page,max_pages", [
    (2, 2, 4, 128, 16, 4),
    (4, 1, 8, 128, 16, 8),
    (1, 4, 1, 256, 8, 16),
])
def test_paged_attention_sweep(dtype, B, n_kv, group, D, page, max_pages):
    rng = np.random.default_rng(0)
    num_pages = max_pages * B + 1
    q, kp, vp, bt = _paged_inputs(rng, B, n_kv, group, D, page, max_pages,
                                  num_pages)
    ln = rng.integers(1, max_pages * page + 1, (B,)).astype(np.int32)
    (qj, qt), (kj, kt), (vj, vt) = (_both(a, dtype) for a in (q, kp, vp))
    out = ref.paged_attention_ref(qt, kt, vt, torch.from_numpy(bt),
                                  torch.from_numpy(ln))
    assert out.dtype == qt.dtype and out.shape == qt.shape
    want_ref = ref_ref.paged_attention_ref(qj, kj, vj, jnp.asarray(bt),
                                           jnp.asarray(ln))
    want_kernel = ref_ops.paged_attention(qj, kj, vj, jnp.asarray(bt),
                                          jnp.asarray(ln), page_size=page,
                                          backend="interpret")
    np.testing.assert_allclose(_np(out), _np(want_ref), **_tol(dtype))
    np.testing.assert_allclose(_np(out), _np(want_kernel), **_tol(dtype))


@pytest.mark.parametrize("lengths", [[1, 64, 33], [16, 17, 15], [5, 48, 64],
                                     [63, 2, 31]])
def test_paged_attention_ragged_lengths(lengths):
    B, n_kv, group, D, page, max_pages = 3, 2, 2, 128, 16, 4
    rng = np.random.default_rng(1)
    q, kp, vp, bt = _paged_inputs(rng, B, n_kv, group, D, page, max_pages, 32)
    ln = np.asarray(lengths, np.int32)
    out = paged_attention_plain(*(torch.from_numpy(a) for a in (q, kp, vp, bt, ln)))
    args = [jnp.asarray(a) for a in (q, kp, vp, bt, ln)]
    want_kernel = ref_ops.paged_attention(*args, page_size=page,
                                          backend="interpret")
    want_ref = ref_ref.paged_attention_ref(*args)
    # float32 on both sides: only the order of the sums differs
    np.testing.assert_allclose(_np(out), _np(want_kernel), atol=2e-4, rtol=2e-4)
    np.testing.assert_allclose(_np(out), _np(want_ref), atol=2e-4, rtol=2e-4)


def test_paged_attention_length_zero_gives_zeros():
    """An empty sequence gives zeros, as the TPU kernel's acc / max(l, 1e-30)
    does; the other rows are what they are without it."""
    B, n_kv, group, D, page, max_pages = 3, 2, 4, 64, 16, 4
    rng = np.random.default_rng(2)
    q, kp, vp, bt = _paged_inputs(rng, B, n_kv, group, D, page, max_pages, 12)
    ln = np.asarray([20, 0, 64], np.int32)
    out = paged_attention_plain(*(torch.from_numpy(a) for a in (q, kp, vp, bt, ln)))
    assert torch.count_nonzero(out[1]) == 0
    want_kernel = ref_ops.paged_attention(
        *(jnp.asarray(a) for a in (q, kp, vp, bt, ln)), page_size=page,
        backend="interpret")
    assert np.count_nonzero(np.asarray(want_kernel)[1]) == 0
    np.testing.assert_allclose(_np(out), _np(want_kernel), atol=2e-4, rtol=2e-4)


# ------------------------------------------- paged attention, split over pages
@pytest.mark.parametrize("max_pages,n_splits", [
    (1, 1), (16, 1), (17, 2), (32, 2), (48, 3), (64, 4), (65, 5)])
def test_split_plan_shapes(max_pages, n_splits):
    """The planner maps the table's width to the grid and the scratch shapes,
    from shapes alone; every split holds at least one page of the table."""
    plan = split_plan(8, 2, 4, 128, max_pages)
    assert plan.n_splits == n_splits
    assert plan.grid == (8, 2, n_splits)
    assert plan.stats_shape == (8, 2, n_splits, 4)
    assert plan.acc_shape == (8, 2, n_splits, 4, 128)
    assert (n_splits - 1) * PAGES_PER_SPLIT < max_pages <= n_splits * PAGES_PER_SPLIT


def test_split_plan_default_at_the_serving_instance():
    """max_len 1024 = 64 pages of 16: four splits of 256 tokens."""
    assert PAGES_PER_SPLIT == 16
    assert split_plan(8, 8, 4, 128, 64).grid == (8, 8, 4)


def _split_case(n_splits, seed):
    """fp32 inputs on a table of ``n_splits`` splits of the kernel's
    ``PAGES_PER_SPLIT`` pages, with lengths 0, 1, 16, exactly one split, one
    past a split boundary and the whole table, and table entries past each
    sequence's pages set to 2**30 (with a clean copy for the oracles)."""
    pps, page, n_kv, group, D = PAGES_PER_SPLIT, 16, 2, 4, 64
    max_pages = n_splits * pps
    split = pps * page
    lengths = [0, 1, 16, split, min(split + 1, max_pages * page), max_pages * page]
    B = len(lengths)
    rng = np.random.default_rng(seed)
    num_pages = B * max_pages
    q, kp, vp, _ = _paged_inputs(rng, B, n_kv, group, D, page, max_pages, num_pages)
    clean = rng.permutation(num_pages).reshape(B, max_pages).astype(np.int32)
    garbage = clean.copy()
    for b, n in enumerate(lengths):
        garbage[b, -(-n // page):] = 2 ** 30
    return q, kp, vp, clean, garbage, np.asarray(lengths, np.int32)


@pytest.mark.parametrize("n_splits", [1, 2, 4])
def test_paged_attention_split_matches_plain_and_reference(n_splits):
    """The kernel's algorithm (a partial softmax per split of the pages,
    then the merge) against the one-pass plain version and the reference's
    oracle on the same numpy inputs; garbage entries are never looked up."""
    q, kp, vp, clean, garbage, ln = _split_case(n_splits, 8 + n_splits)
    assert split_plan(*q.shape, clean.shape[1]).n_splits == n_splits
    t = torch.from_numpy
    out = paged_attention_split_plain(t(q), t(kp), t(vp), t(garbage), t(ln))
    want = paged_attention_plain(t(q), t(kp), t(vp), t(clean), t(ln))
    np.testing.assert_allclose(_np(out), _np(want), atol=1e-5, rtol=1e-5)
    want_ref = np.asarray(ref_ref.paged_attention_ref(
        *(jnp.asarray(a) for a in (q, kp, vp, clean, ln))))
    full = ln > 0   # the reference's oracle gives a uniform average at length 0
    np.testing.assert_allclose(_np(out)[full], want_ref[full], atol=1e-5, rtol=1e-5)
    assert torch.count_nonzero(out[~torch.from_numpy(full)]) == 0


@pytest.mark.parametrize("n_splits", [2, 4])
def test_paged_attention_partials_of_empty_splits(n_splits):
    """A split that starts at or past its sequence's length is empty:
    m = -1e30, l = 0, acc = 0; a non-empty one has l >= 1."""
    q, kp, vp, _, garbage, ln = _split_case(n_splits, 20 + n_splits)
    t = torch.from_numpy
    m, l, acc = paged_attention_partials_plain(t(q), t(kp), t(vp), t(garbage),
                                               t(ln))
    assert m.shape == l.shape == (len(ln), q.shape[1], n_splits, q.shape[2])
    assert acc.shape == m.shape + (q.shape[3],)
    for b, n in enumerate(ln):
        for s in range(n_splits):
            empty = s * PAGES_PER_SPLIT * 16 >= n
            if empty:
                assert bool((m[b, :, s] == -1e30).all())
                assert bool((l[b, :, s] == 0).all())
                assert torch.count_nonzero(acc[b, :, s]) == 0
            else:
                assert bool((l[b, :, s] >= 1).all())


def test_paged_attention_merge_ignores_the_acc_of_empty_splits():
    """The merge weighs a split by l, so an empty split's accumulator,
    which the kernel never writes, may hold anything (NaN here)."""
    q, kp, vp, _, garbage, ln = _split_case(4, 31)
    t = torch.from_numpy
    m, l, acc = paged_attention_partials_plain(t(q), t(kp), t(vp), t(garbage),
                                               t(ln))
    want = paged_attention_merge_plain(m, l, acc, torch.float32)
    acc = torch.where((l == 0)[..., None], torch.full_like(acc, float("nan")), acc)
    m = torch.where(l == 0, torch.full_like(m, 123.0), m)
    got = paged_attention_merge_plain(m, l, acc, torch.float32)
    assert torch.isfinite(got).all()
    assert torch.equal(got, want)


# ---------------------------------------------------------- flash prefill
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,H,Hkv,S,D,bq,bk", [
    (1, 2, 1, 256, 128, 64, 64),
    (2, 4, 4, 256, 128, 128, 64),
    (1, 8, 2, 512, 256, 128, 128),
])
def test_flash_prefill_sweep(dtype, B, H, Hkv, S, D, bq, bk):
    rng = np.random.default_rng(3)
    q = rng.standard_normal((B, H, S, D), dtype=np.float32)
    k = rng.standard_normal((B, Hkv, S, D), dtype=np.float32)
    v = rng.standard_normal((B, Hkv, S, D), dtype=np.float32)
    (qj, qt), (kj, kt), (vj, vt) = (_both(a, dtype) for a in (q, k, v))
    out = ref.flash_prefill_ref(qt, kt, vt)
    assert out.dtype == qt.dtype and out.shape == qt.shape
    want_ref = ref_ref.flash_prefill_ref(qj, kj, vj)
    want_kernel = ref_ops.flash_prefill(qj, kj, vj, block_q=bq, block_k=bk,
                                        backend="interpret")
    np.testing.assert_allclose(_np(out), _np(want_ref), **_tol(dtype))
    np.testing.assert_allclose(_np(out), _np(want_kernel), **_tol(dtype))


def test_flash_prefill_noncausal():
    rng = np.random.default_rng(4)
    q, k, v = (rng.standard_normal((1, 2, 128, 128), dtype=np.float32)
               for _ in range(3))
    out = flash_prefill_plain(*(torch.from_numpy(a) for a in (q, k, v)),
                              causal=False)
    want_kernel = ref_ops.flash_prefill(*(jnp.asarray(a) for a in (q, k, v)),
                                        causal=False, block_q=64, block_k=64,
                                        backend="interpret")
    want_ref = ref_ref.flash_prefill_ref(*(jnp.asarray(a) for a in (q, k, v)),
                                         causal=False)
    np.testing.assert_allclose(_np(out), _np(want_kernel), atol=2e-4, rtol=2e-4)
    np.testing.assert_allclose(_np(out), _np(want_ref), atol=2e-4, rtol=2e-4)


@pytest.mark.parametrize("S", [1, 53, 75, 130])
def test_flash_prefill_ragged_lengths(S):
    """Any S, not only multiples of a block (the Pallas kernel asserts those,
    so the oracle here is the reference's jnp version)."""
    rng = np.random.default_rng(5)
    q = rng.standard_normal((2, 4, S, 64), dtype=np.float32)
    k = rng.standard_normal((2, 2, S, 64), dtype=np.float32)
    v = rng.standard_normal((2, 2, S, 64), dtype=np.float32)
    out = flash_prefill_plain(*(torch.from_numpy(a) for a in (q, k, v)))
    want = ref_ref.flash_prefill_ref(*(jnp.asarray(a) for a in (q, k, v)))
    np.testing.assert_allclose(_np(out), _np(want), atol=2e-4, rtol=2e-4)


@pytest.mark.parametrize("S,past", [(16, 48), (37, 5), (1, 90)])
def test_flash_prefill_q_offset_matches_attention_forward_past_kv(S, past):
    """``q_offset`` is the reference's ``attention_forward(past_kv=...)``:
    with projections that pass x through (identity wq/wo, column selections
    for wk/wv, no RoPE) its output is the attention of q = x over
    [past, new] keys, which the plain version must reproduce."""
    cfg = get_smoke_config("llama-8b")          # d 128, 4 heads / 2 KV heads
    H, Hkv, hd, d = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim, cfg.d_model
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, S, d), dtype=np.float32)
    pk = rng.standard_normal((2, past, Hkv, hd), dtype=np.float32)
    pv = rng.standard_normal((2, past, Hkv, hd), dtype=np.float32)
    eye = np.eye(d, dtype=np.float32)
    p = {"wq": eye, "wo": eye, "wk": eye[:, :Hkv * hd], "wv": eye[:, Hkv * hd:]}
    want = ref_layers.attention_forward(
        cfg, {n: jnp.asarray(w) for n, w in p.items()}, jnp.asarray(x),
        use_rope=False, past_kv=(jnp.asarray(pk), jnp.asarray(pv)))

    q = torch.from_numpy(x).reshape(2, S, H, hd)
    k = torch.cat([torch.from_numpy(pk),
                   torch.from_numpy(x[..., :Hkv * hd]).reshape(2, S, Hkv, hd)], 1)
    v = torch.cat([torch.from_numpy(pv),
                   torch.from_numpy(x[..., Hkv * hd:]).reshape(2, S, Hkv, hd)], 1)
    out = flash_prefill_plain(q.transpose(1, 2), k.transpose(1, 2),
                              v.transpose(1, 2), causal=True, q_offset=past)
    out = out.transpose(1, 2).reshape(2, S, H * hd)
    np.testing.assert_allclose(_np(out), _np(want), atol=2e-4, rtol=2e-4)


# ---------------------------------------------------------- dispatch
def test_wrappers_use_plain_version_on_cpu_and_count_no_launch():
    rng = np.random.default_rng(7)
    q, kp, vp, bt = _paged_inputs(rng, 2, 2, 2, 64, 16, 2, 4)
    args = [torch.from_numpy(a) for a in (q, kp, vp, bt, np.asarray([3, 30], np.int32))]
    before = (paged_attention.launches, flash_prefill.launches)
    assert torch.equal(ops.paged_attention(*args), paged_attention_plain(*args))
    x = torch.from_numpy(rng.standard_normal((1, 2, 9, 64), dtype=np.float32))
    assert torch.equal(ops.flash_prefill(x, x, x), flash_prefill_plain(x, x, x))
    assert (paged_attention.launches, flash_prefill.launches) == before
    assert ops.paged_attention is paged_attention
    assert ops.flash_prefill is flash_prefill


def test_flash_prefill_counts_no_tensor_core_launch_on_cpu():
    """bf16 on the CPU takes the plain version: neither counter moves."""
    rng = np.random.default_rng(9)
    x = torch.from_numpy(rng.standard_normal((1, 2, 9, 64), dtype=np.float32))
    before = (flash_prefill.launches, flash_prefill.tensor_core_launches)
    out = flash_prefill(x.bfloat16(), x.bfloat16(), x.bfloat16())
    assert out.dtype == torch.bfloat16
    assert (flash_prefill.launches, flash_prefill.tensor_core_launches) == before


# ------------------------- masks and head_dim 96 (sliding window, VLM prefix)
def _identity_attention(H, Hkv, D):
    """Projections that pass x through: q = x, k and v two column blocks of
    x, the output projection the identity (d = H * D)."""
    d = H * D
    eye = np.eye(d, dtype=np.float32)
    return {"wq": eye, "wo": eye, "wk": eye[:, :Hkv * D],
            "wv": eye[:, Hkv * D:2 * Hkv * D]}


def _qkv_from_x(x, past_k, past_v, H, Hkv, D):
    """q (B,H,S,D) and k, v (B,Hkv,T,D) as the identity projections give
    them, with the past rows in front."""
    B, S, _ = x.shape
    q = torch.from_numpy(x).reshape(B, S, H, D)
    k = torch.from_numpy(x[..., :Hkv * D]).reshape(B, S, Hkv, D)
    v = torch.from_numpy(x[..., Hkv * D:2 * Hkv * D]).reshape(B, S, Hkv, D)
    if past_k is not None:
        k = torch.cat([torch.from_numpy(past_k), k], 1)
        v = torch.cat([torch.from_numpy(past_v), v], 1)
    return q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)


@pytest.mark.parametrize("D", [64, 96])
@pytest.mark.parametrize("window,prefix_len,past", [
    (8, 0, 0), (0, 12, 0), (8, 12, 0), (5, 0, 20), (40, 0, 0)])
def test_flash_prefill_masks_match_attention_forward(D, window, prefix_len, past):
    """``window`` and ``prefix_len`` are the reference's masks in
    ``attention_forward`` (causal, &= window, |= prefix; with past rows the
    window counts from each query's absolute position), at head_dim 64 and
    96, on the plain version through identity projections (no RoPE)."""
    H, Hkv, S = 4, 2, 37
    rcfg = get_smoke_config("llama-8b").with_(
        d_model=H * D, n_heads=H, n_kv_heads=Hkv, head_dim=D, sliding_window=window)
    rng = np.random.default_rng(10 + D + window + prefix_len + past)
    x = rng.standard_normal((2, S, H * D), dtype=np.float32)
    pk = rng.standard_normal((2, past, Hkv, D), dtype=np.float32) if past else None
    pv = rng.standard_normal((2, past, Hkv, D), dtype=np.float32) if past else None
    p = {n: jnp.asarray(w) for n, w in _identity_attention(H, Hkv, D).items()}
    want = ref_layers.attention_forward(
        rcfg, p, jnp.asarray(x), use_rope=False, prefix_len=prefix_len,
        past_kv=None if not past else (jnp.asarray(pk), jnp.asarray(pv)))
    q, k, v = _qkv_from_x(x, pk, pv, H, Hkv, D)
    out = flash_prefill_plain(q, k, v, q_offset=past, window=window,
                              prefix_len=prefix_len)
    out = out.transpose(1, 2).reshape(2, S, H * D)
    np.testing.assert_allclose(_np(out), _np(want), atol=2e-4, rtol=2e-4)
    # the wrapper takes the plain version on the CPU, with the same masks
    assert torch.equal(flash_prefill(q, k, v, q_offset=past, window=window,
                                     prefix_len=prefix_len),
                       flash_prefill_plain(q, k, v, q_offset=past, window=window,
                                           prefix_len=prefix_len))


@pytest.mark.parametrize("window,prefix_len,q_offset", [
    (100, 0, 0), (0, 64, 0), (100, 64, 0), (70, 0, 130)])
def test_flash_prefill_masks_match_the_long_sequence_reference(window, prefix_len,
                                                              q_offset):
    """The reference's chunked online-softmax path (``_flash_attention_ref``,
    what ``attention_forward`` runs from S = 2048) with a window, a prefix
    and cached rows in front, at head_dim 96, against the plain version."""
    B, H, Hkv, S, D = 1, 4, 2, 300, 96
    rng = np.random.default_rng(20 + window + prefix_len)
    q = rng.standard_normal((B, S, H, D), dtype=np.float32)
    k = rng.standard_normal((B, q_offset + S, Hkv, D), dtype=np.float32)
    v = rng.standard_normal((B, q_offset + S, Hkv, D), dtype=np.float32)
    want = ref_layers._flash_attention_ref(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True, window=window,
        prefix_len=prefix_len, n_heads=H, n_kv=Hkv, block=64, q_offset=q_offset)
    out = flash_prefill_plain(*(torch.from_numpy(a).transpose(1, 2) for a in (q, k, v)),
                              q_offset=q_offset, window=window, prefix_len=prefix_len)
    np.testing.assert_allclose(_np(out.transpose(1, 2).reshape(B, S, H * D)), _np(want),
                               atol=2e-4, rtol=2e-4)


def test_attention_forward_at_2048_tokens_with_window_and_prefix():
    """S = 2048 sends the reference's ``attention_forward`` down its chunked
    path; the port's, through ``ops.flash_prefill``'s plain version, gives
    the same output with a window and a prefix at head_dim 96."""
    from repro_torch.models import layers as port_layers
    from repro_torch.configs import get_smoke_config as port_smoke_config
    H, Hkv, D, S, window, n_vis = 2, 1, 96, 2048, 300, 256
    kw = dict(d_model=H * D, n_heads=H, n_kv_heads=Hkv, head_dim=D, sliding_window=window)
    rcfg = get_smoke_config("llama-8b").with_(**kw)
    cfg = port_smoke_config("llama-8b").with_(**kw)
    rng = np.random.default_rng(30)
    x = rng.standard_normal((1, S, H * D), dtype=np.float32)
    p = _identity_attention(H, Hkv, D)
    want = ref_layers.attention_forward(rcfg, {n: jnp.asarray(w) for n, w in p.items()},
                                        jnp.asarray(x), prefix_len=n_vis)
    got = port_layers.attention_forward(cfg, {n: torch.from_numpy(w) for n, w in p.items()},
                                        torch.from_numpy(x), prefix_len=n_vis)
    np.testing.assert_allclose(_np(got), _np(want), atol=2e-4, rtol=2e-4)


@pytest.mark.parametrize("D", [64, 96])
def test_attention_decode_window_matches_reference(D):
    """Three decode steps with a window of 8: the port attends over its page
    pool from ``max(0, pos + 1 - window)``, the reference over the slots of
    its dense cache whose ``slot_pos > pos - window``; same output. Rows
    start short of the window, across it and far past it."""
    from repro_torch.models import layers as port_layers
    from repro_torch.configs import get_smoke_config as port_smoke_config
    H, Hkv, window = 4, 2, 8
    kw = dict(d_model=H * D, n_heads=H, n_kv_heads=Hkv, head_dim=D, sliding_window=window)
    rcfg = get_smoke_config("llama-8b").with_(**kw)
    cfg = port_smoke_config("llama-8b").with_(**kw)
    rng = np.random.default_rng(40 + D)
    p = {n: (rng.standard_normal(w.shape) * w.shape[0] ** -0.5).astype(np.float32)
         for n, w in _identity_attention(H, Hkv, D).items()}
    B, cap = 3, 48
    pos0 = np.asarray([3, 9, 30])
    kd = np.zeros((B, cap, Hkv, D), np.float32)
    vd = np.zeros((B, cap, Hkv, D), np.float32)
    for b in range(B):
        kd[b, :pos0[b]] = rng.standard_normal((pos0[b], Hkv, D))
        vd[b, :pos0[b]] = rng.standard_normal((pos0[b], Hkv, D))
    cache = port_layers.init_kv_cache(cfg, B, cap, 1, torch.float32, "cpu")
    k_pool, v_pool, bt = cache["k"][0], cache["v"][0], cache["block_tables"]
    k_pool.view(B, cap, Hkv, D)[:] = torch.from_numpy(kd)
    v_pool.view(B, cap, Hkv, D)[:] = torch.from_numpy(vd)
    rk, rv = jnp.asarray(kd), jnp.asarray(vd)
    slot_pos = np.where(np.arange(cap)[None] < pos0[:, None],
                        np.arange(cap)[None], -1).astype(np.int32)
    for step in range(3):
        pos = pos0 + step
        x = rng.standard_normal((B, 1, H * D), dtype=np.float32)
        slot_pos[np.arange(B), pos] = pos
        want, rk, rv = ref_layers.attention_decode(
            rcfg, {n: jnp.asarray(w) for n, w in p.items()}, jnp.asarray(x), rk, rv,
            jnp.asarray(pos, jnp.int32), jnp.asarray(slot_pos))
        got = port_layers.attention_decode(
            cfg, {n: torch.from_numpy(w) for n, w in p.items()}, torch.from_numpy(x),
            k_pool, v_pool, bt, torch.from_numpy(pos).int())
        np.testing.assert_allclose(_np(got), _np(want), atol=2e-4, rtol=2e-4)


def _window_oracle(q, kp, vp, bt, lengths, starts):
    """Softmax attention over positions [start, length) of each sequence,
    in numpy (float64)."""
    B, n_kv, group, D = q.shape
    page = kp.shape[1]
    out = np.zeros(q.shape, np.float64)
    for b in range(B):
        pos = np.arange(starts[b], lengths[b])
        if pos.size == 0:
            continue
        rows = bt[b, pos // page] * page + pos % page
        k = kp.reshape(-1, n_kv, D)[rows].astype(np.float64)     # (T, n_kv, D)
        v = vp.reshape(-1, n_kv, D)[rows].astype(np.float64)
        s = np.einsum("kgd,tkd->kgt", q[b].astype(np.float64), k) / np.sqrt(D)
        w = np.exp(s - s.max(-1, keepdims=True))
        w /= w.sum(-1, keepdims=True)
        out[b] = np.einsum("kgt,tkd->kgd", w, v)
    return out


@pytest.mark.parametrize("D", [64, 96])
def test_paged_attention_lower_bound_across_split_boundaries(D):
    """``starts`` through the kernel's algorithm (partials per split, then
    the merge) and the one-pass plain version, against a numpy oracle: lower
    bounds inside the first split, on a split boundary, one past it, inside
    a later split, in the last page, at the length (nothing to attend to)
    and with a window wider than the sequence. Table entries outside each
    sequence's pages in range are 2**30 and never looked up; the splits
    wholly below a sequence's bound hold nothing (m = -1e30, l = 0)."""
    pps, page, n_kv, group = PAGES_PER_SPLIT, 16, 2, 3
    n_splits = 3
    max_pages = n_splits * pps
    split = pps * page
    lengths = [700, 700, 700, 700, 530, 300, 90, 40]
    starts = [100, split, split + 1, 2 * split + 37, 520, 300, 0, 0]
    B = len(lengths)
    rng = np.random.default_rng(50 + D)
    q, kp, vp, _ = _paged_inputs(rng, B, n_kv, group, D, page, max_pages, B * max_pages)
    clean = rng.permutation(B * max_pages).reshape(B, max_pages).astype(np.int32)
    garbage = clean.copy()
    for b, (n, lo) in enumerate(zip(lengths, starts)):
        garbage[b, -(-n // page):] = 2 ** 30
        garbage[b, :lo // page] = 2 ** 30
    t = torch.from_numpy
    ln = np.asarray(lengths, np.int32)
    st = np.asarray(starts, np.int32)
    want = _window_oracle(q, kp, vp, clean, ln, st)
    plain = paged_attention_plain(t(q), t(kp), t(vp), t(clean), t(ln), t(st))
    split_out = paged_attention_split_plain(t(q), t(kp), t(vp), t(garbage), t(ln), t(st))
    np.testing.assert_allclose(_np(plain), want, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(_np(split_out), want, atol=1e-5, rtol=1e-5)
    assert torch.count_nonzero(split_out[5]) == 0          # start == length
    m, l, _ = paged_attention_partials_plain(t(q), t(kp), t(vp), t(garbage), t(ln), t(st))
    for b, (n, lo) in enumerate(zip(lengths, starts)):
        for s in range(n_splits):
            below = (s + 1) * split <= lo
            past = s * split >= n
            if below or past or lo >= n:
                assert bool((l[b, :, s] == 0).all()) and bool((m[b, :, s] == -1e30).all())
            else:
                assert bool((l[b, :, s] >= 1).all())
    # no bound is a bound of 0
    np.testing.assert_allclose(
        _np(paged_attention_plain(t(q), t(kp), t(vp), t(clean), t(ln), t(np.zeros(B, np.int32)))),
        _np(paged_attention_plain(t(q), t(kp), t(vp), t(clean), t(ln))), atol=0, rtol=0)
    # and the wrapper takes the plain version on the CPU
    assert torch.equal(paged_attention(t(q), t(kp), t(vp), t(clean), t(ln), starts=t(st)),
                       plain)


@pytest.mark.parametrize("group", [1, 2, 7])
def test_paged_attention_head_dim_96_and_group_7_match_reference(group):
    """head_dim 96 (phi3-mini) and group 7 (yi-34b) on the plain version
    against the reference's oracle."""
    B, n_kv, D, page, max_pages = 3, 2, 96 if group < 7 else 128, 16, 6
    rng = np.random.default_rng(60 + group)
    q, kp, vp, bt = _paged_inputs(rng, B, n_kv, group, D, page, max_pages, 20)
    ln = np.asarray([1, 50, 96], np.int32)
    args = [torch.from_numpy(a) for a in (q, kp, vp, bt, ln)]
    want = ref_ref.paged_attention_ref(*(jnp.asarray(a) for a in (q, kp, vp, bt, ln)))
    np.testing.assert_allclose(_np(paged_attention_plain(*args)), _np(want),
                               atol=2e-4, rtol=2e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_prefill_head_dim_96_matches_reference(dtype):
    rng = np.random.default_rng(70)
    q = rng.standard_normal((1, 4, 75, 96), dtype=np.float32)
    k = rng.standard_normal((1, 2, 75, 96), dtype=np.float32)
    v = rng.standard_normal((1, 2, 75, 96), dtype=np.float32)
    (qj, qt), (kj, kt), (vj, vt) = (_both(a, dtype) for a in (q, k, v))
    np.testing.assert_allclose(_np(flash_prefill_plain(qt, kt, vt)),
                               _np(ref_ref.flash_prefill_ref(qj, kj, vj)), **_tol(dtype))


def test_flash_prefill_refuses_a_prefix_after_cached_rows():
    x = torch.zeros((1, 2, 4, 64))
    kv = torch.zeros((1, 2, 9, 64))
    with pytest.raises(ValueError, match="first chunk"):
        flash_prefill(x, kv, kv, q_offset=5, prefix_len=3)
