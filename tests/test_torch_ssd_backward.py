"""The gradient of ``ssd_scan`` in the port: the plain backward
(``ssd_scan_backward_plain``, the explicit formulas) against
``torch.autograd.grad`` of ``ssd_scan_plain`` (exactly, in float64, and in
float32) and against ``jax.vjp`` of the reference's
``repro.models.ssm.ssd_chunked`` on the same numpy inputs, for all six
gradients, with cotangents on y and, in some cases, on the final state; and
the route a call with a gradient takes (``SSDScan``). The backward kernel
itself runs on the card only (``chip_smoke.py``)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.ssm import ssd_chunked
from repro_torch.kernels import ref
from repro_torch.kernels.ssd_scan import (SSDScan, ssd_scan, ssd_scan_backward,
                                          ssd_scan_backward_plain, ssd_scan_plain)

# the test workers share the host's cores: cap each one's intra-op threads
torch.set_num_threads(2)

TOL = 1e-5
# float64 against float64: the formulas themselves, to rounding
EXACT_TOL = 1e-10
# against the reference in float32, whose sums run in other orders: each
# side lies up to 7e-6 of the largest value from the float64 value in dx, dB
# and dC at N 128 over 64-step chunks (measured; the port as autograd does),
# so the two differ by up to 1.2e-5 there
JAX_TOL = 2e-5
# d(dt) against the reference in float32: its A r term is A times a running
# sum, over up to a chunk of steps, of gradients of the a_k that are each a
# difference of nearly equal sums (Q's row sum times dt against dt times its
# column sum), so float32 rounds it at up to 4e-5 of its largest value on
# either side (measured against the float64 value); held to TOL against
# autograd, which sums as the port does
DDT_JAX_TOL = 1e-4
NAMES = ("dx", "ddt", "dA", "dB", "dC", "dh0")

# (case, b, s, h, p, n, chunk, h0, a final-state cotangent, A = -16 with dt ~ 1)
CASES = [
    ("one chunk", 2, 32, 4, 32, 16, 32, False, False, False),
    ("several chunks", 2, 128, 4, 32, 16, 32, False, True, False),
    ("ragged last chunk, h0", 2, 100, 4, 32, 16, 32, True, True, False),
    ("h0 without a final-state cotangent, P 64, N 64", 1, 150, 3, 64, 64, 64, True,
     False, False),
    ("N 128, chunk 64", 1, 200, 3, 64, 128, 64, False, True, False),
    ("A=-16, dt~1", 1, 90, 2, 32, 16, 32, False, False, True),
    ("b 3, N 64", 3, 70, 2, 32, 64, 32, True, True, False),
    ("s=1", 2, 1, 4, 32, 16, 32, True, True, False),
]
IDS = [c[0] for c in CASES]


def _inputs(b, s, h, p, n, with_h0, with_dstate, steep, seed):
    """x, dt, A, B, C, h0, dy, dstate as float32 numpy arrays (h0 and dstate
    may be None); the decay rates are the model's, A = -linspace(1, 16)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, h, p))
    B = rng.standard_normal((b, s, n))
    C = rng.standard_normal((b, s, n))
    raw = rng.standard_normal((b, s, h))
    dt = 1.0 + 0.01 * raw if steep else np.log1p(np.exp(raw))
    A = np.full(h, -16.0) if steep else -np.linspace(1.0, 16.0, h)
    h0 = rng.standard_normal((b, h, p, n)) if with_h0 else None
    dy = rng.standard_normal((b, s, h, p))
    dstate = rng.standard_normal((b, h, p, n)) if with_dstate else None
    return [None if a is None else a.astype(np.float32)
            for a in (x, dt, A, B, C, h0, dy, dstate)]


def _torch(arrays, dtype):
    return [None if a is None else torch.from_numpy(a).to(dtype) for a in arrays]


def _autograd(arrays, chunk, dtype):
    """``torch.autograd.grad`` of ``ssd_scan_plain`` for the same cotangents."""
    x, dt, A, B, C, h0, dy, dstate = _torch(arrays, dtype)
    leaves = [t.clone().requires_grad_(True) for t in (x, dt, A, B, C)]
    if h0 is not None:
        leaves.append(h0.clone().requires_grad_(True))
    y, state = ssd_scan_plain(*leaves[:5], chunk, h0=leaves[5] if h0 is not None else None)
    outs, cots = [y], [dy]
    if dstate is not None:
        outs.append(state)
        cots.append(dstate)
    grads = torch.autograd.grad(outs, leaves, cots)
    return [g.numpy() for g in grads] + [None] * (6 - len(grads))


def _jax_vjp(arrays, chunk):
    """``jax.vjp`` of the reference's ``ssd_chunked`` (a zero cotangent on the
    final state where the case has none)."""
    x, dt, A, B, C, h0, dy, dstate = arrays
    b, _, h, p = x.shape
    n = B.shape[-1]
    prims = [jnp.asarray(a) for a in (x, dt, A, B, C)]
    if h0 is not None:
        prims.append(jnp.asarray(h0))
    _, vjp = jax.vjp(lambda *a: ssd_chunked(*a[:5], chunk, h0=a[5] if h0 is not None
                                            else None), *prims)
    dst = jnp.zeros((b, h, p, n), jnp.float32) if dstate is None else jnp.asarray(dstate)
    grads = vjp((jnp.asarray(dy), dst))
    return [np.asarray(g) for g in grads] + [None] * (6 - len(grads))


def _plain(arrays, chunk, dtype):
    x, dt, A, B, C, h0, dy, dstate = _torch(arrays, dtype)
    return [None if g is None else g.numpy()
            for g in ssd_scan_backward_plain(x, dt, A, B, C, h0, dy, dstate, chunk)]


def _assert_grads_close(got, want, dt, A, tol, ddt_tol=None, dA_tol=None):
    """Each gradient within ``tol`` of its largest magnitude (d(dt) within
    ``ddt_tol`` where given), dA within ``tol`` (``dA_tol`` where given) of
    the magnitude of what it sums: dA_h = sum over b, s of dt r, where A r
    is d(dt) less its direct part, so its terms are of order |dt d(dt) / A|,
    and their sum cancels to far less where the decay is steep (A = -16,
    dt ~ 1: dA ~ 1e-5 from terms of ~1e2)."""
    for name, g, w in zip(NAMES, got, want):
        assert (g is None) == (w is None), name
        if w is None:
            continue
        assert g.shape == w.shape and np.isfinite(g).all(), name
        err = np.abs(g.astype(np.float64) - w)
        if name == "dA":
            scale = np.abs(dt * want[1]).sum(axis=(0, 1)) / np.abs(A)
            assert (err <= (dA_tol or tol) * scale).all(), (name, err / scale)
        else:
            t = ddt_tol if name == "ddt" and ddt_tol else tol
            assert err.max() <= t * np.abs(w).max(), (name, err.max() / np.abs(w).max())


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_backward_formulas_are_exact_in_float64(case):
    """In float64 the plain backward is ``torch.autograd.grad`` of the plain
    forward to rounding: the formulas, not a tolerance, are what agree."""
    _, b, s, h, p, n, chunk, with_h0, with_dstate, steep = case
    arrays = _inputs(b, s, h, p, n, with_h0, with_dstate, steep, seed=s * n + p)
    got = _plain(arrays, chunk, torch.float64)
    want = _autograd(arrays, chunk, torch.float64)
    _assert_grads_close(got, want, arrays[1], arrays[2], EXACT_TOL)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_backward_matches_jax_vjp(case):
    """float32: the reference's gradient (``jax.vjp`` of ``ssd_chunked``)."""
    _, b, s, h, p, n, chunk, with_h0, with_dstate, steep = case
    arrays = _inputs(b, s, h, p, n, with_h0, with_dstate, steep, seed=s * n + p + 1)
    got = _plain(arrays, chunk, torch.float32)
    _assert_grads_close(got, _jax_vjp(arrays, chunk), arrays[1], arrays[2], JAX_TOL,
                        ddt_tol=DDT_JAX_TOL, dA_tol=TOL)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_backward_matches_autograd(case):
    """float32: ``torch.autograd.grad`` of ``ssd_scan_plain``."""
    _, b, s, h, p, n, chunk, with_h0, with_dstate, steep = case
    arrays = _inputs(b, s, h, p, n, with_h0, with_dstate, steep, seed=s * n + p + 2)
    got = _plain(arrays, chunk, torch.float32)
    _assert_grads_close(got, _autograd(arrays, chunk, torch.float32), arrays[1], arrays[2],
                        TOL)


@pytest.mark.parametrize("with_h0", [False, True])
def test_a_call_with_a_gradient_goes_through_ssd_scan_autograd(with_h0):
    """On the CPU, as on the card: a call whose inputs require a gradient
    goes through ``SSDScan`` (the forward's bits, ``ssd_scan_backward``'s
    gradients: the plain backward, bit for bit, given no final-state
    cotangent), and h0 gets a gradient only where it was given; a call
    without one (no input requiring it, or under ``no_grad``) takes the
    forward alone."""
    arrays = _inputs(2, 40, 4, 32, 16, with_h0, False, False, seed=11)
    x, dt, A, B, C, h0, dy, _ = _torch(arrays, torch.float32)
    y_plain, state_plain = ssd_scan_plain(x, dt, A, B, C, 32, h0=h0)
    for args in ((x, dt, A, B, C, h0), (x.requires_grad_(True), dt, A, B, C, h0)):
        with torch.no_grad():
            y, state = ssd_scan(*args, chunk=32)
        assert y.grad_fn is None and torch.equal(y, y_plain)
    x.requires_grad_(False)
    y, state = ssd_scan(x, dt, A, B, C, h0, chunk=32)
    assert y.grad_fn is None and torch.equal(state, state_plain)

    leaves = [t.clone().requires_grad_(True) for t in (x, dt, A, B, C)]
    h0_leaf = None if h0 is None else h0.clone().requires_grad_(True)
    y, state = ssd_scan(*leaves, h0_leaf, chunk=32)
    assert type(y.grad_fn).__name__ == SSDScan.__name__ + "Backward"
    assert torch.equal(y, y_plain) and torch.equal(state, state_plain)
    inputs = leaves + ([] if h0_leaf is None else [h0_leaf])
    got = torch.autograd.grad(y, inputs, dy)
    want = ssd_scan_backward_plain(x, dt, A, B, C, h0, dy, None, 32)
    assert (want[5] is None) == (h0 is None)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert ref.ssd_scan_backward_plain is ssd_scan_backward_plain


def test_the_backward_wrapper_runs_the_plain_version_on_the_cpu():
    """``ssd_scan_backward`` on CPU tensors is the plain backward (its
    ``dstate`` defaulting to none) and launches nothing; strided views of
    one projection, as ``mamba_forward`` passes x, B and C, give the
    gradients of their contiguous copies."""
    rng = np.random.default_rng(3)
    b, s, h, p, n = 2, 45, 2, 32, 16
    conv = torch.from_numpy(rng.standard_normal((b, s, h * p + 2 * n)).astype(np.float32))
    x = conv[..., :h * p].reshape(b, s, h, p)
    B, C = conv[..., h * p:h * p + n], conv[..., h * p + n:]
    dt = torch.from_numpy(np.log1p(np.exp(rng.standard_normal((b, s, h)))).astype(np.float32))
    A = -torch.linspace(1.0, 16.0, h)
    dy = torch.from_numpy(rng.standard_normal((b, s, h, p)).astype(np.float32))
    before = ssd_scan_backward.launches
    got = ssd_scan_backward(x, dt, A, B, C, None, dy, chunk=32)
    want = ssd_scan_backward_plain(x.contiguous(), dt, A, B.contiguous(), C.contiguous(),
                                   None, dy, None, 32)
    assert ssd_scan_backward.launches == before
    for g, w in zip(got, want):
        assert (g is None and w is None) or torch.equal(g, w)
