"""The precision of the SSD backward's tensor-core kernel, on the CPU.

``csrc/ssd_scan_bwd.cu``'s tensor-core kernel runs every product of the
float32 backward in 6xTF32 (``split3``; the last tests here), the bf16
one in 3xTF32. 3xTF32 keeps float32's precision over the long sums of the
training shape (the formulas' tests here), but one product of it errs up
to 2^-21, which a sum of one term (s = 1) shows. In 3xTF32 each float32
operand value v becomes hi, v rounded to
TF32 (to nearest, ties away from zero, at 13 bits below a float32's
mantissa, as ``cvt.rna.tf32.f32`` rounds), and lo = v - hi, which the
tensor cores read truncated to TF32 (they take a TF32 operand's top 19
bits); a product is a_lo b_hi + a_hi b_lo + a_hi b_hi, accumulated in
float32. A product of two TF32 values is exact in float32, so
``torch.matmul`` in float32 on the split operands models what the tensor
cores compute, up to the order of the float32 sums (``kernels/tf32.py``,
the model the forward's tests share).

Here the kernel's formulas for one chunk without state (what it takes: the
training shape) run with that operand rounding at mamba2-1.3b's widths (P
64, N 128, 128 steps, 4 heads, batch 2), inputs from a numpy seed, and each
gradient is held against float64 (``ssd_scan_backward_plain`` in float64):
its error must stay within ``FACTOR`` of the plain float32 version's own
error on the same inputs and within ``SSD_TOL`` of the gradient's largest
value (dA: of the magnitude of what it sums, as in
``tests/test_torch_ssd_backward.py``). The split helper and the route a
backward takes on the card (``backward_route``) are checked too. The kernel
itself runs on the card only (``chip_smoke.py``)."""
import numpy as np
import pytest
import torch

from repro_torch.kernels.ssd_scan import TC_MIN_STEPS, backward_route, ssd_scan_backward_plain
# the rounding model of the 3xTF32 products, shared with the forward's tests
from repro_torch.kernels.tf32 import matmul_3xtf32 as mm3
from repro_torch.kernels.tf32 import matmul_1xtf32, matmul_6xtf32, split, split3

# the test workers share the host's cores: cap each one's intra-op threads
torch.set_num_threads(2)

# chip_smoke.py's tolerance of the backward kernel in float32, of the largest value
SSD_TOL = 2e-3
# 3xTF32 keeps float32's precision: each gradient's error against float64 at
# most this many times the plain float32 version's (their sums run in other
# orders, so neither is always the smaller)
FACTOR = 4.0
NAMES = ("dx", "ddt", "dA", "dB", "dC")


def tensor_core_backward(x, dt, A, B, C, dy, mm=mm3, scan64=False):
    """The kernel's formulas for one chunk (s <= chunk), no h0, no final-state
    cotangent, every product through ``mm`` (3xTF32), the rest in float32
    (with ``scan64`` the running sums in float64, as the kernel now takes
    them: a of dt * A, each exponent a_i - a_j rounded to float32 once, and
    r of da, with d(dt) and dA from it):
    S = C B^T once a sequence, per head M = dy x^T, W = S o L dt_j, Z = M o L dt_j,
    Q = S o L o M and dx = W^T dy; dB = Zsum^T C and dC = Zsum B with Zsum
    the sum of Z over the heads; da from Q's row and column sums, r its
    reverse running sum, d(dt) = Q's column sums + A r, dA = sum dt r."""
    b, s, h, _ = x.shape
    a = torch.cumsum(dt.double() * A.double(), dim=1) if scan64 \
        else torch.cumsum(dt * A, dim=1)                         # (b, s, h)
    i = torch.arange(s)
    causal = (i[:, None] >= i[None, :])[None, :, :, None]        # (1, i, j, 1)
    L = torch.exp(torch.where(causal, (a[:, :, None] - a[:, None]).float(), -torch.inf))
    S = mm(C, B.transpose(1, 2))                                 # (b, i, j)
    xh, dyh = x.permute(0, 2, 1, 3), dy.permute(0, 2, 1, 3)       # (b, h, s, p)
    M = mm(dyh, xh.transpose(2, 3)).permute(0, 2, 3, 1)         # (b, i, j, h)
    dt_j = dt[:, None]                                            # (b, 1, j, h)
    W = S[..., None] * L * dt_j
    Z = M * L * dt_j
    Q = S[..., None] * L * M
    dx = mm(W.permute(0, 3, 2, 1), dyh).permute(0, 2, 1, 3)      # (b, j, h, p)
    Zsum = Z.sum(dim=3)                                           # (b, i, j)
    dB = mm(Zsum.transpose(1, 2), C)
    dC = mm(Zsum, B)
    col = Q.sum(dim=1)                                            # (b, j, h)
    da = (Q * dt_j).sum(dim=2) - dt * col
    if scan64:
        r = torch.flip(torch.cumsum(torch.flip(da.double(), [1]), dim=1), [1])
        return dx, (col + A.double() * r).float(), (dt * r).sum((0, 1)).float(), dB, dC
    r = torch.flip(torch.cumsum(torch.flip(da, [1]), dim=1), [1])
    return dx, col + A * r, (dt * r).sum((0, 1)), dB, dC


def _inputs(seed, steep, b=2, s=128, h=4, p=64, n=128):
    rng = np.random.default_rng(seed)
    raw = rng.standard_normal((b, s, h))
    arrays = dict(x=rng.standard_normal((b, s, h, p)), B=rng.standard_normal((b, s, n)),
                  C=rng.standard_normal((b, s, n)),
                  dt=1.0 + 0.01 * raw if steep else np.log1p(np.exp(raw)),
                  A=np.full(h, -16.0) if steep else -np.linspace(1.0, 16.0, h),
                  dy=rng.standard_normal((b, s, h, p)))
    return {k: torch.from_numpy(v.astype(np.float32)) for k, v in arrays.items()}


def _errors(got, want, dt, A):
    """Each gradient's largest error against ``want`` (float64), over its
    largest magnitude; dA's over the magnitude of what it sums."""
    out = {}
    for name, g, w in zip(NAMES, got, want):
        err = (g.double() - w).abs()
        if name == "dA":
            scale = (dt.double() * want[1]).abs().sum(dim=(0, 1)) / A.double().abs()
            out[name] = float((err / scale).max())
        else:
            out[name] = float(err.max() / w.abs().max())
    return out


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("steep", [False, True], ids=["model decay", "A=-16, dt~1"])
def test_3xtf32_backward_keeps_float32_precision(seed, steep):
    t = _inputs(seed, steep)
    args = (t["x"], t["dt"], t["A"], t["B"], t["C"])
    want = ssd_scan_backward_plain(*(v.double() for v in args), None,
                                   t["dy"].double(), None, 256)
    plain = ssd_scan_backward_plain(*args, None, t["dy"], None, 256)
    got = tensor_core_backward(*args, t["dy"])
    for g, w in zip(got, want):
        assert g.shape == w.shape and torch.isfinite(g).all()
    e_tc, e_plain = _errors(got, want, t["dt"], t["A"]), _errors(plain, want, t["dt"], t["A"])
    for name in NAMES:
        assert e_tc[name] <= SSD_TOL, (name, e_tc[name])
        assert e_tc[name] <= FACTOR * e_plain[name], (name, e_tc[name], e_plain[name])


def test_one_tf32_rounding_would_not_keep_float32_precision():
    """The case for three products: with every operand rounded once to TF32
    the same formulas miss float32's precision by orders of magnitude."""
    t = _inputs(0, False)
    args = (t["x"], t["dt"], t["A"], t["B"], t["C"])
    want = ssd_scan_backward_plain(*(v.double() for v in args), None,
                                   t["dy"].double(), None, 256)
    plain = _errors(ssd_scan_backward_plain(*args, None, t["dy"], None, 256), want,
                    t["dt"], t["A"])
    once = _errors(tensor_core_backward(*args, t["dy"], mm=matmul_1xtf32), want,
                   t["dt"], t["A"])
    assert once["dx"] > 30 * plain["dx"] and once["dB"] > 30 * plain["dB"], (once, plain)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_the_split_recovers_float32(seed):
    rng = np.random.default_rng(seed)
    a = torch.from_numpy((rng.standard_normal(100_000) *
                          np.exp(rng.uniform(-20, 20, 100_000))).astype(np.float32))
    hi, lo = split(a)
    # hi and lo are TF32 values: their 13 low mantissa bits are zero
    for part in (hi, lo):
        assert not (part.numpy().view(np.uint32) & np.uint32(0x1FFF)).any()
    assert ((hi.double() + lo.double() - a.double()).abs() <= 2.0 ** -21 * a.double().abs()).all()
    # a bf16 value is a TF32 value: its lo is 0, so its lo products are left out
    bf = a.to(torch.bfloat16).float()
    hi, lo = split(bf)
    assert torch.equal(hi, bf) and not lo.any()


@pytest.mark.parametrize("b, s, h, p, n, chunk, h0, dstate, want", [
    (8, 128, 64, 64, 128, 256, False, False, (True, 4)),   # mamba2-1.3b's training shape
    (8, 128, 80, 64, 64, 256, False, False, (True, 5)),    # zamba2-2.7b's
    (1, 1, 64, 64, 128, 256, False, False, (False, 1)),    # fewer than TC_MIN_STEPS steps
    (1, 15, 64, 64, 128, 256, False, False, (False, 1)),
    (1, 16, 64, 64, 128, 256, False, False, (True, 1)),
    (64, 256, 64, 64, 128, 256, False, False, (True, 5)),  # more blocks than a wave at most
    (2, 320, 64, 64, 128, 256, False, False, (False, 1)),  # two chunks: the carried state
    (1, 128, 64, 64, 128, 256, True, False, (False, 1)),   # h0
    (1, 128, 64, 64, 128, 256, False, True, (False, 1)),   # a final-state cotangent
    (4, 64, 24, 32, 16, 32, False, False, (False, 1)),     # the smoke widths: P 32, N 16
])
def test_backward_route(b, s, h, p, n, chunk, h0, dstate, want):
    assert backward_route(b, s, h, p, n, chunk, h0, dstate, n_sms=132) == want


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_the_three_way_split_is_exact(seed):
    """6xTF32's split: hi, mid and lo are TF32 values (their 13 low mantissa
    bits zero) that sum to the float32 value exactly; a bf16 value is its own
    hi."""
    rng = np.random.default_rng(seed)
    a = torch.from_numpy((rng.standard_normal(100_000) *
                          np.exp(rng.uniform(-20, 20, 100_000))).astype(np.float32))
    hi, mid, lo = split3(a)
    for part in (hi, mid, lo):
        assert not (part.numpy().view(np.uint32) & np.uint32(0x1FFF)).any()
    assert torch.equal(hi.double() + mid.double() + lo.double(), a.double())
    bf = a.to(torch.bfloat16).float()
    hi, mid, lo = split3(bf)
    assert torch.equal(hi, bf) and not mid.any() and not lo.any()


def _ulps_off(got: torch.Tensor, exact: torch.Tensor) -> torch.Tensor:
    """|got - exact| in units of the last place of float32 ``got``."""
    ulp = torch.nextafter(got.abs(), torch.tensor(float("inf"))) - got.abs()
    return (got.double() - exact).abs() / ulp.double()


def test_one_6xtf32_product_is_float32_rounded_once():
    """A sum of one product, as a k-step of the kernel at s = 1 gives it:
    6xTF32's six terms (each exact in float32, as the tensor cores form them)
    summed exactly and rounded once are within half a float32 unit of the
    exact product, as plain float32 is, but for the three terms it leaves
    out (below 2^-32 of the product: 2^-8 of a unit); 3xTF32, whose lo the
    tensor cores read truncated, misses by up to several units."""
    rng = np.random.default_rng(0)
    a, b = (torch.from_numpy(rng.standard_normal(200_000).astype(np.float32))
            for _ in range(2))
    exact = a.double() * b.double()
    (ah, am, al), (bh, bm, bl) = split3(a), split3(b)
    terms = [al * bh, ah * bl, am * bm, am * bh, ah * bm, ah * bh]
    six = sum(t.double() for t in terms).float()
    (h3, l3), (h4, l4) = split(a), split(b)
    three = (l3.double() * h4.double() + h3.double() * l4.double() +
             h3.double() * h4.double()).float()
    assert float(_ulps_off(six, exact).max()) <= 0.5 + 2.0 ** -8
    assert float(_ulps_off(a * b, exact).max()) <= 0.5 + 1e-6
    assert float(_ulps_off(three, exact).max()) > 2.0


@pytest.mark.parametrize("s", [TC_MIN_STEPS, 32, 128, 256])
@pytest.mark.parametrize("steep", [False, True], ids=["model decay", "A=-16, dt~1"])
def test_6xtf32_with_a_float64_scan_keeps_float32_precision(steep, s):
    """The float32 kernel's formulas as it now runs them (6xTF32 products,
    the running sums in float64) on four draws a shape the kernel takes:
    every gradient within ``FACTOR`` of the plain float32 version's error
    against float64 (fewer than ``TC_MIN_STEPS`` steps go to the FMA
    kernel: ``backward_route``)."""
    for seed in range(4):
        t = _inputs(10 + seed, steep, s=s)
        args = (t["x"], t["dt"], t["A"], t["B"], t["C"])
        want = ssd_scan_backward_plain(*(v.double() for v in args), None,
                                       t["dy"].double(), None, 256)
        plain = _errors(ssd_scan_backward_plain(*args, None, t["dy"], None, 256), want,
                        t["dt"], t["A"])
        got = _errors(tensor_core_backward(*args, t["dy"], mm=matmul_6xtf32, scan64=True),
                      want, t["dt"], t["A"])
        for name in NAMES:
            assert got[name] <= SSD_TOL, (seed, name, got[name])
            assert got[name] <= FACTOR * plain[name], (seed, name, got[name], plain[name])


def test_a_float64_scan_takes_out_most_of_the_error():
    """Why the kernel sums dt * A in float64: at the training length the
    exponents a_i - a_j are differences of two sums of up to a few hundred,
    whose float32 roundings are most of the plain float32 version's error.
    With the sum in float64, dx, dB and dC err less than a quarter of it."""
    t = _inputs(0, False)
    args = (t["x"], t["dt"], t["A"], t["B"], t["C"])
    want = ssd_scan_backward_plain(*(v.double() for v in args), None,
                                   t["dy"].double(), None, 256)
    plain = _errors(ssd_scan_backward_plain(*args, None, t["dy"], None, 256), want,
                    t["dt"], t["A"])
    got = _errors(tensor_core_backward(*args, t["dy"], mm=matmul_6xtf32, scan64=True),
                  want, t["dt"], t["A"])
    for name in ("dx", "dB", "dC"):
        assert got[name] < plain[name] / 4, (name, got[name], plain[name])
