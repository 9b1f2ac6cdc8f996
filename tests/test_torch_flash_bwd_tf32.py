"""The precision of ``flash_prefill``'s float32 backward kernels, on the CPU.

``csrc/flash_prefill_bwd.cu``'s float32 kernels (``flash_prefill_bwd_dq_tf32``
and ``flash_prefill_bwd_dkdv_tf32``) run all seven products on the tensor
cores in 3xTF32: each float32 operand value v becomes hi, v rounded to TF32,
and lo = v - hi read truncated to TF32; a product is a_lo b_hi + a_hi b_lo +
a_hi b_hi with float32 sums (``repro_torch/kernels/tf32.py`` models one such
product). P = exp(S scale - lse) from the forward's log-sum-exp, delta =
rowsum(dO O), dS = P (dP - delta) and the sums of the two halves stay
float32.

Here the kernels' formulas run in their tiling with that operand rounding:
dq walks KV steps of 64 rows, each split into two halves of 32 that two warps
sum apart (S = Q K^T, dP = dO V^T, dQ += dS K) and adds the halves at the
end; dkdv walks the group's heads and query steps of 64 rows, halves of 32
again (S^T = K Q^T, dP^T = V dO^T, dV += P^T dO, dK += dS^T Q). Cases:
olmo-1b's widths (H 16, D 128, S 128, batch 2, causal), head_dim 64, 80 and
96, GQA groups 2-7, a window, a prefix, full attention with S != T and
ragged last tiles, inputs from a numpy seed. dQ, dK and dV are held against
float64 gradients (autograd of attention in float64): their error must stay
within ``FACTOR`` of the plain float32 backward's
(``flash_prefill_backward_plain``) on the same inputs. They are held against
``jax.vjp`` of the reference's attention
(``repro.models.layers._flash_attention_ref``) on the same numpy inputs too,
within ``TOL``. One TF32 rounding a product, the negative case, misses
float32's precision by orders of magnitude. The kernels themselves run on
the card only (``chip_smoke.py``)."""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as ref_layers
from repro_torch.kernels.flash_prefill import (_NEG_INF, attention_mask,
                                               flash_prefill_backward_plain,
                                               flash_prefill_plain)
from repro_torch.kernels.tf32 import matmul_1xtf32, matmul_3xtf32

# the test workers share the host's cores: cap each one's intra-op threads
torch.set_num_threads(2)

# the reference's kernel tests' float32 tolerance (atol and rtol), and
# chip_smoke.py's for the kernels against the plain version
TOL = 2e-4
# 3xTF32 keeps float32's precision: the error against float64 at most this
# many times the plain float32 version's (their sums run in other orders, so
# neither is always the smaller)
FACTOR = 4.0
STEP = 64    # the rows of a streamed step: KV rows in dq, query rows in dkdv
HALF = 32    # the rows of a step that one warp takes

# (case, B, H, Hkv, S, D, causal, window, prefix_len, T)
CASES = [
    ("olmo-1b widths", 2, 16, 16, 128, 128, True, 0, 0, None),
    ("D 64, group 2, window 30", 1, 4, 2, 100, 64, True, 30, 0, None),
    ("D 80, group 3, prefix 20", 1, 6, 2, 90, 80, True, 0, 20, None),
    ("D 96, group 4, ragged S 70", 1, 8, 2, 70, 96, True, 0, 0, None),
    ("D 64, group 5, full, S 77, T 150", 1, 5, 1, 77, 64, False, 0, 0, 150),
    ("D 128, group 6, window 9 beside prefix 10", 1, 6, 1, 53, 128, True, 9, 10, None),
    ("D 80, group 7, ragged S 45", 1, 7, 1, 45, 80, True, 0, 0, None),
]
IDS = [c[0] for c in CASES]


def _mask(S, T, causal, window, prefix_len):
    if not causal:
        return torch.ones((S, T), dtype=torch.bool)
    return attention_mask(S, T, window=window, prefix_len=prefix_len)


def _halves(n):
    """The half-steps of a streamed axis of n rows, in the kernels' order:
    (step, half) -> rows [64 step + 32 half, + 32), cut at n."""
    return [slice(s0 + h0, min(s0 + h0 + HALF, n))
            for s0 in range(0, n, STEP) for h0 in (0, HALF) if s0 + h0 < n]


def tensor_core_backward(q, k, v, o, do, lse, *, causal, window, prefix_len,
                         mm=matmul_3xtf32):
    """The kernels' formulas, every product through ``mm`` (3xTF32), the rest
    in float32. q, o, do (B,H,S,D); k, v (B,Hkv,T,D); lse (B,H,S), the
    forward's. Returns (dq, dk, dv)."""
    B, H, S, D = q.shape
    Hkv, T = k.shape[1], k.shape[2]
    group = H // Hkv
    scale = torch.tensor(1.0 / math.sqrt(D), dtype=torch.float32)   # as the launch passes it
    mask = _mask(S, T, causal, window, prefix_len)
    zero = torch.tensor(0.0)
    delta = (do * o).sum(-1)                         # dq's prologue, written for dkdv
    ke, ve = k.repeat_interleave(group, dim=1), v.repeat_interleave(group, dim=1)

    # dq: each query row over the KV half-steps; two sums, one a half
    dq_half = [torch.zeros_like(q), torch.zeros_like(q)]
    for i, c in enumerate(_halves(T)):
        kc, vc = ke[:, :, c], ve[:, :, c]
        s = mm(q, kc.transpose(-1, -2))              # S = Q K^T
        dp = mm(do, vc.transpose(-1, -2))            # dP = dO V^T
        seen = mask[:, c]
        p = torch.where(seen, torch.exp(s * scale - lse[..., None]), zero)
        ds = torch.where(seen, p * (dp - delta[..., None]), zero)
        dq_half[i % 2] = dq_half[i % 2] + mm(ds, kc)   # dQ += dS K
    dq = (dq_half[0] + dq_half[1]) * scale

    # dkdv: each KV row over the group's heads, then the query half-steps
    qg, dog = q.reshape(B, Hkv, group, S, D), do.reshape(B, Hkv, group, S, D)
    lg, dg = lse.reshape(B, Hkv, group, S), delta.reshape(B, Hkv, group, S)
    dk_half = [torch.zeros_like(k), torch.zeros_like(k)]
    dv_half = [torch.zeros_like(k), torch.zeros_like(k)]
    for g in range(group):
        for i, c in enumerate(_halves(S)):
            qc, dc = qg[:, :, g, c], dog[:, :, g, c]
            st = mm(k, qc.transpose(-1, -2))         # S^T = K Q^T
            dpt = mm(v, dc.transpose(-1, -2))        # dP^T = V dO^T
            seen = mask[c].T
            pt = torch.where(seen, torch.exp(st * scale - lg[:, :, g, None, c]), zero)
            dst = torch.where(seen, pt * (dpt - dg[:, :, g, None, c]), zero)
            dv_half[i % 2] = dv_half[i % 2] + mm(pt, dc)   # dV += P^T dO
            dk_half[i % 2] = dk_half[i % 2] + mm(dst, qc)  # dK += dS^T Q
    return dq, (dk_half[0] + dk_half[1]) * scale, dv_half[0] + dv_half[1]


def _float64_attention(q, k, v, *, causal, window, prefix_len):
    """Softmax attention of float64 q (B,H,S,D), k and v (B,Hkv,T,D)."""
    B, H, S, D = q.shape
    Hkv, T = k.shape[1], k.shape[2]
    s = q @ k.repeat_interleave(H // Hkv, dim=1).transpose(-1, -2) / math.sqrt(D)
    s = torch.where(_mask(S, T, causal, window, prefix_len), s,
                    torch.tensor(_NEG_INF, dtype=torch.float64))
    return torch.softmax(s, dim=-1) @ v.repeat_interleave(H // Hkv, dim=1)


def _float64_grads(q, k, v, do, **kw):
    """The gradients of softmax attention in float64, by autograd."""
    q, k, v = (t.double().requires_grad_(True) for t in (q, k, v))
    return torch.autograd.grad(_float64_attention(q, k, v, **kw), (q, k, v), do.double())


def _case(case, seed):
    """Numpy inputs (B,S,H,D) / (B,T,Hkv,D), their (B,H,S,D) views, the
    forward's output and log-sum-exp, and the mask keywords."""
    _, B, H, Hkv, S, D, causal, window, prefix_len, T = case
    T = T or S
    rng = np.random.default_rng(seed)
    q, do = (rng.standard_normal((B, S, H, D)).astype(np.float32) for _ in range(2))
    k, v = (rng.standard_normal((B, T, Hkv, D)).astype(np.float32) for _ in range(2))
    kw = dict(causal=causal, window=window, prefix_len=prefix_len)
    qt, kt, vt, dot = (torch.from_numpy(a).transpose(1, 2) for a in (q, k, v, do))
    o, lse = flash_prefill_plain(qt, kt, vt, return_lse=True, **kw)
    return (q, k, v, do), (qt, kt, vt, o, dot, lse), kw


def _rel(got, want):
    return float((got.double() - want).abs().max() / want.abs().max())


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_3xtf32_backward_keeps_float32_precision(case):
    _, (qt, kt, vt, o, dot, lse), kw = _case(case, seed=case[4] * case[5] + 1)
    got = tensor_core_backward(qt, kt, vt, o, dot, lse, **kw)
    exact = _float64_grads(qt, kt, vt, dot, **kw)
    plain = flash_prefill_backward_plain(qt, kt, vt, o, dot, **kw)
    for name, g, w, p in zip(("dq", "dk", "dv"), got, exact, plain):
        assert g.shape == w.shape and torch.isfinite(g).all(), name
        e, e_plain = _rel(g, w), _rel(p, w)
        assert e <= TOL and e <= FACTOR * e_plain, (name, e, e_plain)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_3xtf32_backward_matches_the_jax_reference(case):
    (q, k, v, do), (qt, kt, vt, o, dot, lse), kw = _case(case, seed=case[4] * case[5] + 2)
    got = tensor_core_backward(qt, kt, vt, o, dot, lse, **kw)
    B, S, H, D = q.shape
    Hkv = k.shape[2]

    def ref(q_, k_, v_):   # (B,S,H*D)
        return ref_layers._flash_attention_ref(q_, k_, v_, n_heads=H, n_kv=Hkv, **kw)
    _, vjp = jax.vjp(ref, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    for g, w in zip(got, vjp(jnp.asarray(do.reshape(B, S, H * D)))):
        np.testing.assert_allclose(g.transpose(1, 2).numpy(), np.asarray(w),
                                   atol=TOL, rtol=TOL)


def test_one_tf32_rounding_would_not_keep_float32_precision():
    """The case for three products: with every operand rounded once to TF32
    the same formulas miss float32's precision by orders of magnitude (at
    olmo-1b's widths each gradient errs 630 to 1320 times as much as the
    plain float32 backward against float64, about 7e-4 of its largest
    value), and the chip's tolerance."""
    _, (qt, kt, vt, o, dot, lse), kw = _case(CASES[0], seed=3)
    exact = _float64_grads(qt, kt, vt, dot, **kw)
    once = tensor_core_backward(qt, kt, vt, o, dot, lse, mm=matmul_1xtf32, **kw)
    plain = flash_prefill_backward_plain(qt, kt, vt, o, dot, **kw)
    for name, g, w, p in zip(("dq", "dk", "dv"), once, exact, plain):
        e_once, e_plain = _rel(g, w), _rel(p, w)
        assert e_once > 100 * e_plain and e_once > TOL, (name, e_once, e_plain)


def test_plain_backward_runs_in_float64_for_float64_inputs():
    """``flash_prefill_backward_plain`` keeps float64 inputs in float64 (the
    yardstick ``chip_smoke.py`` holds the kernels to on the card): its
    gradients equal autograd's in float64 to float64's precision."""
    _, (qt, kt, vt, o, dot, _), kw = _case(CASES[2], seed=4)
    exact = _float64_grads(qt, kt, vt, dot, **kw)
    q64, k64, v64 = qt.double(), kt.double(), vt.double()
    o64 = _float64_attention(q64, k64, v64, **kw)
    got = flash_prefill_backward_plain(q64, k64, v64, o64, dot.double(), **kw)
    for g, w in zip(got, exact):
        assert g.dtype == torch.float64
        assert _rel(g, w) < 1e-12


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_plain_forward_runs_in_float64_for_float64_inputs(case):
    """``flash_prefill_plain`` keeps float64 inputs in float64 (the yardstick
    ``chip_smoke.py`` holds the float32 forward kernel to on the card): its
    output equals softmax attention in float64 to float64's precision, and
    its log-sum-exp is float64."""
    _, (qt, kt, vt, _, _, _), kw = _case(case, seed=5)
    q64, k64, v64 = qt.double(), kt.double(), vt.double()
    o, lse = flash_prefill_plain(q64, k64, v64, return_lse=True, **kw)
    assert o.dtype == torch.float64 and lse.dtype == torch.float64
    assert _rel(o, _float64_attention(q64, k64, v64, **kw)) < 1e-12
