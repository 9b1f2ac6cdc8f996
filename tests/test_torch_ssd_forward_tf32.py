"""The precision of the SSD forward's one-chunk 3xTF32 kernel, on the CPU.

``csrc/ssd_scan.cu``'s float32 kernel for one chunk from a zero state
(``ssd_scan_kernel_tf32``, every training call of mamba2-1.3b and
zamba2-2.7b) runs its three products on the tensor cores in 3xTF32: each
float32 operand value v becomes hi, v rounded to TF32, and lo = v - hi read
truncated to TF32; a product is a_lo b_hi + a_hi b_lo + a_hi b_hi with
float32 sums (``repro_torch/kernels/tf32.py`` models one such product). The
scan of dt * A, the decays, the weights and the accumulators stay float32.

Here the kernel's formulas run with that operand rounding at mamba2-1.3b's
widths (P 64, N 128, 128 steps, 4 heads, batch 2) and at zamba2-2.7b's N 64
(5 heads), with the model's decay rates and with A = -16, dt ~ 1, inputs
from a numpy seed. y and the final state are held against float64
(``ssd_scan_plain`` in float64): their error must stay within ``FACTOR`` of
the plain float32 version's on the same inputs and within ``SSD_TOL`` of the
largest value. They are held against the JAX reference on the same numpy
inputs too, its Pallas kernel in interpret mode as ``tests/test_kernels.py``
runs it, within that file's SSD tolerance. One TF32 rounding a product, the
negative case, misses float32's precision. The kernel's own scan of dt * A
(each lane's eight steps, then a warp scan of the lanes' sums) is modelled
too, with dA_total taken at the last step as the kernel takes it; taken as
the sum of the lanes' sums instead, it misses the factor on the final
state. ``forward_route``, which sends a launch to this kernel or to
another, is checked shape by shape. The kernel itself runs on the card only
(``chip_smoke.py``)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as ref_ops
from repro_torch.kernels.ssd_scan import forward_route, ssd_scan_plain
from repro_torch.kernels.tf32 import matmul_1xtf32, matmul_3xtf32, matmul_6xtf32

# the test workers share the host's cores: cap each one's intra-op threads
torch.set_num_threads(2)

# chip_smoke.py's tolerance of the SSD kernels in float32, of the largest value
SSD_TOL = 2e-3
# tests/test_kernels.py's tolerance of the Pallas SSD kernel against its
# oracle (atol and rtol)
REF_TOL = 2e-3
# 3xTF32 keeps float32's precision: the error against float64 at most this
# many times the plain float32 version's (their sums run in other orders, so
# neither is always the smaller)
FACTOR = 4.0
CHUNK = 256


def cumsum_scan(dt, A):
    """The running sum of dt * A as ``ssd_scan_plain`` forms it, and its
    last value: (a (b,s,h), a_last (b,1,h))."""
    a = torch.cumsum(dt * A, dim=1)
    return a, a[:, -1:]


def warp_scan(dt, A, total_from_lanes=False):
    """The running sum of dt * A as the kernel forms it in one warp: lane l
    sums steps 8 l .. 8 l + 7 in turn (one fused multiply-add a step; steps
    past s add dt = 0), a Hillis-Steele scan over the lanes' sums gives each
    lane's inclusive sum incl, and a_t = (v_t + incl) - run. Returns (a,
    a_last): a_last is a at the last step, as the kernel takes dA_total, or,
    with ``total_from_lanes``, the last lane's incl (the sum of the lanes'
    sums), which rounds otherwise."""
    b, s, h = dt.shape
    d = torch.zeros((b, 256, h), dtype=torch.float64)
    d[:, :s] = dt.double()
    d = d.reshape(b, 32, 8, h)
    run = torch.zeros((b, 32, h), dtype=torch.float32)
    v = []
    for q in range(8):
        # fma(d, A, run): the float64 product is exact, one rounding to float32
        run = (d[:, :, q] * A.double() + run.double()).float()
        v.append(run)
    v = torch.stack(v, dim=2)                                     # (b, lane, q, h)
    incl, off = run, 1
    while off < 32:
        up = torch.cat([torch.zeros_like(incl[:, :off]), incl[:, :-off]], dim=1)
        incl, off = incl + up, 2 * off
    a = ((v + incl[:, :, None]) - run[:, :, None]).reshape(b, 256, h)
    return a[:, :s], incl[:, 31:] if total_from_lanes else a[:, s - 1:s]


def float64_scan(dt, A):
    """The running sum of dt * A as the kernel now forms it: in float64 (each
    product dt * A exact), dA_total its value at the last step."""
    a = torch.cumsum(dt.double() * A.double(), dim=1)
    return a, a[:, -1:]


def tensor_core_forward(x, dt, A, B, C, mm=matmul_3xtf32, scan=cumsum_scan):
    """The kernel's formulas for one chunk (s <= chunk) from a zero state,
    every product through ``mm`` (3xTF32), the rest in float32: a the
    running sum of dt * A (by ``scan``; a float64 one's exponents a_i - a_j
    are rounded to float32 once, as the kernel takes them), S = C B^T once a sequence, per head
    W = S o exp(a_i - a_j) dt_j for i >= j (the exponent masked before exp)
    and y = W x; fin_j = exp(a_last - a_j) dt_j and the final state h = (fin
    o x)^T B. x (b,s,h,p), dt (b,s,h), A (h,), B and C (b,s,n); returns (y,
    state (b,h,p,n))."""
    s = x.shape[1]
    a, a_last = scan(dt, A)                                       # (b, s, h)
    i = torch.arange(s)
    causal = (i[:, None] >= i[None, :])[None, :, :, None]         # (1, i, j, 1)
    L = torch.exp(torch.where(causal, (a[:, :, None] - a[:, None]).float(), -torch.inf))
    S = mm(C, B.transpose(1, 2))                                  # (b, i, j)
    W = S[..., None] * L * dt[:, None]                            # (b, i, j, h)
    y = mm(W.permute(0, 3, 1, 2), x.permute(0, 2, 1, 3)).permute(0, 2, 1, 3)
    fin = torch.exp((a_last - a).float()) * dt                    # (b, s, h)
    state = mm((x * fin[..., None]).permute(0, 2, 3, 1), B[:, None])
    return y, state


def _inputs(seed, n, h, steep, b=2, s=128, p=64):
    rng = np.random.default_rng(seed)
    raw = rng.standard_normal((b, s, h))
    arrays = dict(x=rng.standard_normal((b, s, h, p)), B=rng.standard_normal((b, s, n)),
                  C=rng.standard_normal((b, s, n)),
                  dt=1.0 + 0.01 * raw if steep else np.log1p(np.exp(raw)),
                  A=np.full(h, -16.0) if steep else -np.linspace(1.0, 16.0, h))
    return {k: v.astype(np.float32) for k, v in arrays.items()}


def _torch(t):
    return [torch.from_numpy(t[k]) for k in ("x", "dt", "A", "B", "C")]


def _rel(got, want):
    return float((got.double() - want).abs().max() / want.abs().max())


WIDTHS = [("mamba2-1.3b, N 128, 4 heads", 128, 4), ("zamba2-2.7b, N 64, 5 heads", 64, 5)]


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("steep", [False, True], ids=["model decay", "A=-16, dt~1"])
@pytest.mark.parametrize("width", WIDTHS, ids=[w[0] for w in WIDTHS])
def test_3xtf32_forward_keeps_float32_precision(width, steep, seed):
    _, n, h = width
    args = _torch(_inputs(seed, n, h, steep))
    y, state = tensor_core_forward(*args)
    want_y, want_state = ssd_scan_plain(*(v.double() for v in args), CHUNK)
    plain_y, plain_state = ssd_scan_plain(*args, CHUNK)
    assert y.shape == want_y.shape and state.shape == want_state.shape
    assert torch.isfinite(y).all() and torch.isfinite(state).all()
    for name, got, plain, want in (("y", y, plain_y, want_y),
                                   ("state", state, plain_state, want_state)):
        e, e_plain = _rel(got, want), _rel(plain, want)
        assert e <= SSD_TOL and e <= FACTOR * e_plain, (name, e, e_plain)


@pytest.mark.parametrize("width", WIDTHS, ids=[w[0] for w in WIDTHS])
def test_3xtf32_forward_matches_the_jax_reference(width):
    _, n, h = width
    t = _inputs(2, n, h, False)
    y, state = tensor_core_forward(*_torch(t))
    want_y, want_state = ref_ops.ssd_scan(*(jnp.asarray(t[k]) for k in ("x", "dt", "A", "B", "C")),
                                          chunk=CHUNK, backend="interpret")
    np.testing.assert_allclose(y.numpy(), np.asarray(want_y), atol=REF_TOL, rtol=REF_TOL)
    np.testing.assert_allclose(state.numpy(), np.asarray(want_state), atol=REF_TOL,
                               rtol=REF_TOL)


def test_one_tf32_rounding_would_not_keep_float32_precision():
    """The case for three products: with every operand rounded once to TF32
    the same formulas miss float32's precision by orders of magnitude."""
    args = _torch(_inputs(0, 128, 4, False))
    want_y, want_state = ssd_scan_plain(*(v.double() for v in args), CHUNK)
    plain_y, plain_state = ssd_scan_plain(*args, CHUNK)
    once_y, once_state = tensor_core_forward(*args, mm=matmul_1xtf32)
    for once, plain, want in ((once_y, plain_y, want_y), (once_state, plain_state, want_state)):
        assert _rel(once, want) > 30 * _rel(plain, want), (_rel(once, want), _rel(plain, want))


# the card's cases (chip_smoke.py's SSD_TF32_CASES) at two sequences each:
# (case, s, h, n, steep); ragged s and A = -16 with dt ~ 1 included
CARD_CASES = [("mamba2-1.3b training", 128, 64, 128, False),
              ("zamba2-2.7b training", 128, 80, 64, False),
              ("mamba2, s=256", 256, 64, 128, False),
              ("zamba2, ragged s=200", 200, 80, 64, False),
              ("s=1", 1, 64, 128, False),
              ("A=-16, dt~1", 128, 64, 128, True)]


def _card_inputs(seed, s, h, n, steep, b=2, p=64):
    t = _inputs(seed, n, h, steep, b=b, s=s, p=p)
    return _torch(t)


@pytest.mark.parametrize("case", CARD_CASES, ids=[c[0] for c in CARD_CASES])
def test_warp_scan_forward_keeps_float32_precision(case):
    """With the kernel's own scan of dt * A (and dA_total its last step), y
    and the final state stay within ``FACTOR`` of plain float32's error."""
    _, s, h, n, steep = case
    args = _card_inputs(3, s, h, n, steep)
    y, state = tensor_core_forward(*args, scan=warp_scan)
    want_y, want_state = ssd_scan_plain(*(v.double() for v in args), CHUNK)
    plain_y, plain_state = ssd_scan_plain(*args, CHUNK)
    for name, got, plain, want in (("y", y, plain_y, want_y),
                                   ("state", state, plain_state, want_state)):
        e, e_plain = _rel(got, want), _rel(plain, want)
        assert e <= SSD_TOL and e <= FACTOR * e_plain, (name, e, e_plain)


@pytest.mark.parametrize("s", [1, 75, 128, 200, 256])
def test_warp_scan_matches_the_running_sum(s):
    """The warp scan is a running sum of dt * A to float32's rounding, and
    its dA_total is its own value at the last step, bit for bit."""
    x, dt, A, B, C = _card_inputs(4, s, 8, 16, False)
    a, a_last = warp_scan(dt, A)
    want = torch.cumsum(dt.double() * A.double(), dim=1)
    assert torch.equal(a_last, a[:, -1:])
    assert float(((a.double() - want).abs() / want.abs().clamp_min(1.0)).max()) < 1e-5


def test_total_from_the_lanes_would_not_keep_float32_precision():
    """The case for taking dA_total at the last step: as the sum of the
    lanes' sums it differs from the last step's dA_cum by a rounding, and
    exp of that difference puts about 1e-4 of relative error on the final
    state where its last term dominates (A = -16, dt ~ 1), far beyond
    ``FACTOR`` of plain float32's."""
    args = _card_inputs(0, 128, 64, 128, True)
    want_y, want_state = ssd_scan_plain(*(v.double() for v in args), CHUNK)
    plain_y, plain_state = ssd_scan_plain(*args, CHUNK)
    _, state = tensor_core_forward(
        *args, scan=lambda dt, A: warp_scan(dt, A, total_from_lanes=True))
    assert _rel(state, want_state) > 30 * FACTOR * _rel(plain_state, want_state)


@pytest.mark.parametrize("b, s, h, p, n, chunk, h0, is_bf16, want", [
    (8, 128, 64, 64, 128, 256, False, False, ("tf32", 4)),   # mamba2-1.3b's training shape
    (8, 128, 80, 64, 64, 256, False, False, ("tf32", 5)),    # zamba2-2.7b's
    (8, 256, 64, 64, 128, 256, False, False, ("tf32", 4)),   # a full chunk
    (2, 200, 64, 64, 128, 256, False, False, ("tf32", 1)),   # ragged, fewer blocks than a wave
    (2, 16, 64, 64, 128, 256, False, False, ("tf32", 1)),    # TC_MIN_STEPS
    (2, 15, 64, 64, 128, 256, False, False, ("fma", 1)),     # fewer steps
    (2, 1, 64, 64, 128, 256, False, False, ("fma", 1)),
    (64, 128, 64, 64, 128, 256, False, False, ("tf32", 5)),  # more blocks than a wave at most
    (2, 320, 64, 64, 128, 256, False, False, ("fma", 1)),    # two chunks: the carried state
    (1, 128, 64, 64, 128, 256, True, False, ("fma", 1)),     # h0
    (4, 64, 24, 32, 16, 32, False, False, ("fma", 1)),       # the smoke widths: P 32, N 16
    (1, 341, 64, 64, 128, 256, False, True, ("wgmma", 1)),   # bf16, serving
    (8, 128, 64, 64, 128, 256, False, True, ("wgmma", 1)),   # bf16 at a training shape
])
def test_forward_route(b, s, h, p, n, chunk, h0, is_bf16, want):
    assert forward_route(b, s, h, p, n, chunk, h0, is_bf16, n_sms=132) == want


@pytest.mark.parametrize("case", CARD_CASES[:4] + CARD_CASES[5:],
                         ids=[c[0] for c in CARD_CASES[:4] + CARD_CASES[5:]])
def test_6xtf32_forward_with_a_float64_scan_keeps_float32_precision(case):
    """The kernel's formulas as it now runs them (6xTF32 products, the running
    sum of dt * A in float64) on four draws a case: y and the final state
    within ``FACTOR`` of plain float32's error (s = 1 goes to the FMA kernel:
    ``forward_route``)."""
    _, s, h, n, steep = case
    for seed in range(4):
        args = _card_inputs(20 + seed, s, h, n, steep)
        y, state = tensor_core_forward(*args, mm=matmul_6xtf32, scan=float64_scan)
        want_y, want_state = ssd_scan_plain(*(v.double() for v in args), CHUNK)
        plain_y, plain_state = ssd_scan_plain(*args, CHUNK)
        for name, got, plain, want in (("y", y, plain_y, want_y),
                                       ("state", state, plain_state, want_state)):
            e, e_plain = _rel(got, want), _rel(plain, want)
            assert e <= SSD_TOL and e <= FACTOR * e_plain, (seed, name, e, e_plain)


def test_a_float64_scan_takes_out_most_of_the_error():
    """Why the kernel sums dt * A in float64: at the training length the
    exponents a_i - a_j are differences of two sums of up to a few hundred,
    whose float32 roundings are most of the plain float32 version's error
    on y. With the sum in float64, y errs less than a quarter of it."""
    for n, h in ((128, 4), (64, 5)):
        args = _torch(_inputs(0, n, h, False))
        y, _ = tensor_core_forward(*args, mm=matmul_6xtf32, scan=float64_scan)
        want_y, _ = ssd_scan_plain(*(v.double() for v in args), CHUNK)
        plain_y, _ = ssd_scan_plain(*args, CHUNK)
        assert _rel(y, want_y) < _rel(plain_y, want_y) / 4, (_rel(y, want_y),
                                                              _rel(plain_y, want_y))
