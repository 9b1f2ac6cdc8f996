"""The gradient of ``flash_prefill`` in the port: the plain backward
(``flash_prefill_backward_plain``, the explicit formulas) against
``torch.autograd.grad`` of ``flash_prefill_plain`` and against ``jax.vjp`` of
the reference's attention (``repro.models.layers._flash_attention_ref``) on
the same numpy inputs; the forward's log-sum-exp, which the backward takes
instead of recomputing it, against ``jax.nn.logsumexp`` of the reference's
scores; the route a call with a gradient takes (``FlashPrefill``, which
saves that log-sum-exp) and ``ssd_scan``'s (``SSDScan``); and the guard of
the kernel that has no backward. The backward kernels themselves run on the
card only (``chip_smoke.py``)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as ref_layers
from repro_torch.kernels import _grad
from repro_torch.kernels.flash_prefill import (FlashPrefill, flash_prefill,
                                               flash_prefill_backward,
                                               flash_prefill_backward_plain,
                                               flash_prefill_plain)
from repro_torch.kernels.ssd_scan import SSDScan, ssd_scan

# the test workers share the host's cores: cap each one's intra-op threads
torch.set_num_threads(2)

TOL = 1e-5

# (case, B, H, Hkv, S, T, D, causal, window, prefix_len)
CASES = [
    ("causal", 2, 4, 4, 37, 37, 64, True, 0, 0),
    ("full, S != T", 1, 4, 2, 21, 45, 64, False, 0, 0),
    ("window", 2, 4, 2, 50, 50, 64, True, 9, 0),
    ("prefix", 1, 4, 1, 40, 40, 64, True, 0, 7),
    ("window beside prefix", 1, 4, 2, 40, 40, 64, True, 6, 10),
    ("group 1", 1, 3, 3, 33, 33, 64, True, 0, 0),
    ("group 4", 1, 8, 2, 33, 33, 64, True, 0, 0),
    ("group 7", 1, 7, 1, 33, 33, 64, True, 0, 0),
    ("D 80", 1, 4, 2, 29, 29, 80, True, 0, 0),
    ("D 96", 1, 4, 2, 29, 29, 96, True, 0, 0),
    ("D 128", 1, 4, 2, 29, 29, 128, True, 0, 0),
    ("full, D 80, group 4", 1, 8, 2, 17, 70, 80, False, 0, 0),
]


def _inputs(B, H, Hkv, S, T, D, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, S, H, D)).astype(np.float32)
    k = rng.standard_normal((B, T, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((B, T, Hkv, D)).astype(np.float32)
    do = rng.standard_normal((B, S, H, D)).astype(np.float32)
    return q, k, v, do


def _ref_lse(q, k, *, causal, window, prefix_len):
    """``jax.nn.logsumexp`` of the reference's scaled, masked scores (its
    ``_flash_attention_ref`` in one block): q (B,S,H,D), k (B,T,Hkv,D)
    numpy; returns (B,H,S)."""
    B, S, H, D = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    qg = jnp.asarray(q).reshape(B, S, Hkv, H // Hkv, D).transpose(0, 2, 3, 1, 4)
    s = jnp.einsum("bkgsd,btkd->bkgst", qg, jnp.asarray(k)) / np.sqrt(D)
    qpos, kpos = jnp.arange(S), jnp.arange(T)
    mask = jnp.ones((S, T), bool)
    if causal:
        mask = kpos[None, :] <= qpos[:, None]
        if window > 0:
            mask &= kpos[None, :] > qpos[:, None] - window
        if prefix_len > 0:
            mask |= kpos[None, :] < prefix_len
    s = jnp.where(mask[None, None, None], s, -1e30)
    return np.asarray(jax.nn.logsumexp(s, axis=-1)).reshape(B, H, S)


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_forward_log_sum_exp_matches_jax(case):
    """The log-sum-exp ``flash_prefill_plain(return_lse=True)`` returns (the
    quantity the kernels write for the backward) is the reference's."""
    _, B, H, Hkv, S, T, D, causal, window, prefix_len = case
    q, k, v, _ = _inputs(B, H, Hkv, S, T, D, seed=S * D + 1)
    kw = dict(causal=causal, window=window, prefix_len=prefix_len)
    qt, kt, vt = (torch.from_numpy(a).transpose(1, 2) for a in (q, k, v))
    o, lse = flash_prefill_plain(qt, kt, vt, return_lse=True, **kw)
    assert lse.shape == (B, H, S) and lse.dtype == torch.float32
    torch.testing.assert_close(o, flash_prefill_plain(qt, kt, vt, **kw), atol=0, rtol=0)
    np.testing.assert_allclose(lse.numpy(), _ref_lse(q, k, **kw), atol=TOL, rtol=TOL)


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_backward_plain_with_the_saved_lse(case):
    """Given the forward's log-sum-exp, the plain backward forms P as
    exp(s - lse), as the kernels do: the same gradients as its softmax
    route and as ``jax.vjp`` of the reference's attention."""
    _, B, H, Hkv, S, T, D, causal, window, prefix_len = case
    q, k, v, do = _inputs(B, H, Hkv, S, T, D, seed=S * D + 2)
    kw = dict(causal=causal, window=window, prefix_len=prefix_len)
    qt, kt, vt, dot = (torch.from_numpy(a).transpose(1, 2) for a in (q, k, v, do))
    o, lse = flash_prefill_plain(qt, kt, vt, return_lse=True, **kw)
    got = flash_prefill_backward_plain(qt, kt, vt, o, dot, lse=lse, **kw)
    want = flash_prefill_backward_plain(qt, kt, vt, o, dot, **kw)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=TOL, rtol=TOL)

    def ref(q_, k_, v_):
        return ref_layers._flash_attention_ref(q_, k_, v_, n_heads=H, n_kv=Hkv, **kw)
    _, vjp = jax.vjp(ref, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    for g, w in zip(got, vjp(jnp.asarray(do.reshape(B, S, H * D)))):
        np.testing.assert_allclose(g.transpose(1, 2).numpy(), np.asarray(w),
                                   atol=TOL, rtol=TOL)


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_backward_plain_matches_autograd_and_jax_vjp(case):
    _, B, H, Hkv, S, T, D, causal, window, prefix_len = case
    q, k, v, do = _inputs(B, H, Hkv, S, T, D, seed=S * D)
    kw = dict(causal=causal, window=window, prefix_len=prefix_len)
    # the port's (B, H, S, D) layout, as transposed views
    qt, kt, vt, dot = (torch.from_numpy(a).transpose(1, 2) for a in (q, k, v, do))
    with torch.no_grad():
        o = flash_prefill_plain(qt, kt, vt, **kw)
    got = flash_prefill_backward_plain(qt, kt, vt, o, dot, **kw)
    assert all(g.dtype == torch.float32 for g in got)

    leaves = [t.clone().requires_grad_(True) for t in (qt, kt, vt)]
    want = torch.autograd.grad(flash_prefill_plain(*leaves, **kw), leaves, dot)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=TOL, rtol=TOL)

    def ref(q_, k_, v_):
        return ref_layers._flash_attention_ref(q_, k_, v_, causal=causal, window=window,
                                               prefix_len=prefix_len, n_heads=H,
                                               n_kv=Hkv)
    out, vjp = jax.vjp(ref, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    np.testing.assert_allclose(o.transpose(1, 2).reshape(B, S, H * D).numpy(),
                               np.asarray(out), atol=TOL, rtol=TOL)
    jq, jk, jv = vjp(jnp.asarray(do.reshape(B, S, H * D)))
    for g, w in zip(got, (jq, jk, jv)):
        np.testing.assert_allclose(g.transpose(1, 2).numpy(), np.asarray(w),
                                   atol=TOL, rtol=TOL)


def test_backward_keeps_the_input_dtype():
    q, k, v, do = (torch.from_numpy(a).transpose(1, 2).to(torch.bfloat16)
                   for a in _inputs(1, 4, 2, 20, 20, 64, seed=1))
    o = flash_prefill_plain(q, k, v)
    dq, dk, dv = flash_prefill_backward(q, k, v, o, do)
    assert (dq.dtype, dk.dtype, dv.dtype) == (torch.bfloat16,) * 3
    assert dq.shape == q.shape and dk.shape == k.shape and dv.shape == v.shape
    assert flash_prefill_backward.launches == 0     # nothing launched on the CPU


def test_a_call_with_a_gradient_goes_through_the_autograd_function():
    """On inputs that require a gradient ``flash_prefill`` returns
    ``FlashPrefill``'s output, whose backward is ``flash_prefill_backward``
    (here its plain version); under ``no_grad`` or without such inputs, the
    bare forward. A gradient through cached rows is refused."""
    q, k, v, do = (torch.from_numpy(a).transpose(1, 2)
                   for a in _inputs(1, 4, 2, 20, 20, 64, seed=2))
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = flash_prefill(*leaves, window=5)
    assert type(out.grad_fn).__name__ == FlashPrefill.__name__ + "Backward"
    got = torch.autograd.grad(out, leaves, do)
    o = flash_prefill_plain(q, k, v, window=5)
    want = flash_prefill_backward_plain(q, k, v, o, do, window=5)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=0, rtol=0)
    with torch.no_grad():
        assert flash_prefill(*leaves).grad_fn is None
    assert flash_prefill(q, k, v).grad_fn is None
    with pytest.raises(ValueError, match="cached rows"):
        flash_prefill(leaves[0][:, :, 10:], *leaves[1:], q_offset=10)


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_flash_prefill_saves_the_log_sum_exp(case):
    """On the CPU, ``FlashPrefill`` saves q, k, v, the output and the
    forward's log-sum-exp, and the gradient through it is unchanged: the
    plain backward's softmax route, bit for bit, and its route through the
    saved log-sum-exp (the kernels' formula) within ``TOL``."""
    _, B, H, Hkv, S, T, D, causal, window, prefix_len = case
    q, k, v, do = _inputs(B, H, Hkv, S, T, D, seed=S * D + 3)
    kw = dict(causal=causal, window=window, prefix_len=prefix_len)
    qt, kt, vt, dot = (torch.from_numpy(a).transpose(1, 2) for a in (q, k, v, do))
    leaves = [t.clone().requires_grad_(True) for t in (qt, kt, vt)]
    out = flash_prefill(*leaves, **kw)
    saved = out.grad_fn.saved_tensors
    o, lse = flash_prefill_plain(qt, kt, vt, return_lse=True, **kw)
    assert len(saved) == 5
    torch.testing.assert_close(saved[3], o, atol=0, rtol=0)
    torch.testing.assert_close(saved[4], lse, atol=0, rtol=0)
    got = torch.autograd.grad(out, leaves, dot)
    for g, w in zip(got, flash_prefill_backward_plain(qt, kt, vt, o, dot, **kw)):
        torch.testing.assert_close(g, w, atol=0, rtol=0)
    for g, w in zip(got, flash_prefill_backward_plain(qt, kt, vt, o, dot, lse=lse, **kw)):
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=TOL, rtol=TOL)


@pytest.mark.parametrize("kernel, n_inputs", [("paged_attention", 3)])
def test_kernels_without_a_backward_refuse_a_gradient(kernel, n_inputs):
    """The condition under which the CUDA branch of ``paged_attention`` (a
    decode kernel, which no trainer reaches) raises (``_grad.refuse_grad``,
    called there with its float inputs): grad mode on and some input
    requiring a gradient. Under ``no_grad``, or with no such input, it lets
    the launch go."""
    inputs = [torch.zeros(3) for _ in range(n_inputs)]
    _grad.refuse_grad(kernel, *inputs)
    inputs[1] = torch.zeros(3, requires_grad=True)
    with pytest.raises(NotImplementedError, match=f"{kernel}: no backward.*decode kernel"):
        _grad.refuse_grad(kernel, *inputs)
    with torch.no_grad():
        _grad.refuse_grad(kernel, *inputs)
    assert _grad.wants_grad(*inputs) and not _grad.wants_grad(torch.zeros(1), None)


def test_ssd_scan_routes_a_gradient_through_its_backward():
    """``ssd_scan`` has a backward: where ``_grad.wants_grad`` holds for its
    inputs (a missing initial state skipped) it goes through ``SSDScan``,
    as ``flash_prefill`` goes through ``FlashPrefill``; under ``no_grad``
    it takes the forward alone."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((1, 9, 2, 32)).astype(np.float32))
    dt = torch.full((1, 9, 2), 0.5)
    A = torch.tensor([-1.0, -2.0], requires_grad=True)
    B, C = (torch.from_numpy(rng.standard_normal((1, 9, 16)).astype(np.float32))
            for _ in range(2))
    assert _grad.wants_grad(x, dt, A, B, C, None)
    y, _ = ssd_scan(x, dt, A, B, C, None, chunk=32)
    assert type(y.grad_fn).__name__ == SSDScan.__name__ + "Backward"
    dA, = torch.autograd.grad(y.sum(), [A])
    assert dA.shape == A.shape and torch.isfinite(dA).all()
    with torch.no_grad():
        assert ssd_scan(x, dt, A, B, C, None, chunk=32)[0].grad_fn is None
