"""The precision of ``flash_prefill``'s float32 forward kernel, on the CPU.

``csrc/flash_prefill.cu``'s float32 kernel (``flash_prefill_kernel_tf32``)
runs both products on the tensor cores in 3xTF32: each float32 operand value
v becomes hi, v rounded to TF32, and lo = v - hi read truncated to TF32; a
product is a_lo b_hi + a_hi b_lo + a_hi b_hi with float32 sums
(``repro_torch/kernels/tf32.py`` models one such product). The probabilities
P are split too. The online softmax over KV tiles of 64, m, l, the output
accumulator and the log-sum-exp stay float32.

Here the kernel's formulas run with that operand rounding at olmo-1b's
widths (H 16, D 128, S 128, batch 2, causal) and at head_dim 64, 80 and 96
with GQA, a window, a prefix, cached rows in front (``q_offset``) and full
attention, inputs from a numpy seed. The output and the log-sum-exp are held
against float64: their error must stay within ``FACTOR`` of the plain float32
version's (``flash_prefill_plain``) on the same inputs. The output is held
against the JAX reference on the same numpy inputs too: the Pallas kernel in
interpret mode where it takes the case (T = S in whole blocks of 64, no
window, prefix or cached rows, as ``tests/test_kernels.py`` runs it), else
the reference's attention (``repro.models.layers._flash_attention_ref``),
within ``TOL``. One TF32
rounding a product, the negative case, misses float32's precision by orders
of magnitude. The kernel itself runs on the card only (``chip_smoke.py``)."""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as ref_ops
from repro.models import layers as ref_layers
from repro_torch.kernels.flash_prefill import _NEG_INF, attention_mask, flash_prefill_plain
from repro_torch.kernels.tf32 import matmul_1xtf32, matmul_3xtf32

# the test workers share the host's cores: cap each one's intra-op threads
torch.set_num_threads(2)

# the reference's kernel tests' float32 tolerance (atol and rtol), and
# chip_smoke.py's for the kernel against the plain version
TOL = 2e-4
# 3xTF32 keeps float32's precision: the error against float64 at most this
# many times the plain float32 version's (their sums run in other orders, so
# neither is always the smaller)
FACTOR = 4.0
KV_TILE = 64   # the kernel's KV rows a step

# (case, B, H, Hkv, S, D, q_offset, causal, window, prefix_len, T)
CASES = [
    ("olmo-1b widths", 2, 16, 16, 128, 128, 0, True, 0, 0, None),
    ("D 64, group 2, window 30", 1, 4, 2, 100, 64, 0, True, 30, 0, None),
    ("D 80, prefix 20", 1, 4, 4, 90, 80, 0, True, 0, 20, None),
    ("D 96, group 4, q_offset 40", 1, 8, 2, 70, 96, 40, True, 0, 0, None),
    ("D 96, full, T 120", 1, 4, 2, 77, 96, 0, False, 0, 0, 120),
    ("D 64, window 9 beside prefix 10, ragged", 1, 4, 1, 53, 64, 0, True, 9, 10, None),
    ("D 80, window 25 after q_offset 30", 1, 4, 2, 45, 80, 30, True, 25, 0, None),
]
IDS = [c[0] for c in CASES]


def _inputs(B, H, Hkv, S, T, D, seed):
    """q (B,S,H,D), k and v (B,T,Hkv,D) float32 numpy from a seed."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, S, H, D)).astype(np.float32),
            rng.standard_normal((B, T, Hkv, D)).astype(np.float32),
            rng.standard_normal((B, T, Hkv, D)).astype(np.float32))


def _mask(S, T, causal, q_offset, window, prefix_len):
    if not causal:
        return torch.ones((S, T), dtype=torch.bool)
    return attention_mask(S, T, q_offset=q_offset, window=window, prefix_len=prefix_len)


def tensor_core_forward(q, k, v, *, causal, q_offset, window, prefix_len,
                        mm=matmul_3xtf32):
    """The kernel's formulas, every product through ``mm`` (3xTF32), the rest
    in float32: per KV tile of 64, S = Q K^T times the scale, masked to
    -1e30; m_new = max(m, rowmax S), alpha = exp(m - m_new), P = exp(S -
    m_new), l = l alpha + rowsum P, O = O alpha + P V; finally O / l and
    lse = m + log l. q (B,H,S,D), k and v (B,Hkv,T,D); returns (o, lse)."""
    B, H, S, D = q.shape
    Hkv, T = k.shape[1], k.shape[2]
    ke = k.repeat_interleave(H // Hkv, dim=1)
    ve = v.repeat_interleave(H // Hkv, dim=1)
    scale = torch.tensor(1.0 / math.sqrt(D), dtype=torch.float32)   # as the launch passes it
    mask = _mask(S, T, causal, q_offset, window, prefix_len)
    neg = torch.tensor(_NEG_INF, dtype=torch.float32)
    m = torch.full((B, H, S), _NEG_INF, dtype=torch.float32)
    l = torch.zeros((B, H, S))
    acc = torch.zeros((B, H, S, D))
    for t0 in range(0, T, KV_TILE):
        kt, vt = ke[:, :, t0:t0 + KV_TILE], ve[:, :, t0:t0 + KV_TILE]
        s = torch.where(mask[:, t0:t0 + KV_TILE], mm(q, kt.transpose(-1, -2)) * scale, neg)
        m_new = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + mm(p, vt)
        m = m_new
    l = l.clamp_min(1e-30)
    return acc / l[..., None], m + torch.log(l)


def _float64(q, k, v, *, causal, q_offset, window, prefix_len):
    """Softmax attention and its log-sum-exp in float64."""
    B, H, S, D = q.shape
    Hkv, T = k.shape[1], k.shape[2]
    q, k, v = (t.double() for t in (q, k, v))
    s = q @ k.repeat_interleave(H // Hkv, dim=1).transpose(-1, -2) / math.sqrt(D)
    s = torch.where(_mask(S, T, causal, q_offset, window, prefix_len), s,
                    torch.tensor(_NEG_INF, dtype=torch.float64))
    return torch.softmax(s, dim=-1) @ v.repeat_interleave(H // Hkv, dim=1), \
        torch.logsumexp(s, dim=-1)


def _case(case, seed):
    _, B, H, Hkv, S, D, q_offset, causal, window, prefix_len, T = case
    T = q_offset + S if causal else T
    q, k, v = _inputs(B, H, Hkv, S, T, D, seed)
    kw = dict(causal=causal, q_offset=q_offset, window=window, prefix_len=prefix_len)
    qt, kt, vt = (torch.from_numpy(a).transpose(1, 2) for a in (q, k, v))
    return (q, k, v), (qt, kt, vt), kw


def _rel(got, want):
    return float((got.double() - want).abs().max() / want.abs().max())


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_3xtf32_forward_keeps_float32_precision(case):
    _, (qt, kt, vt), kw = _case(case, seed=case[4] * case[5] + 1)
    o, lse = tensor_core_forward(qt, kt, vt, **kw)
    assert o.shape == qt.shape and lse.shape == qt.shape[:3]
    assert torch.isfinite(o).all() and torch.isfinite(lse).all()
    want_o, want_lse = _float64(qt, kt, vt, **kw)
    plain_o, plain_lse = flash_prefill_plain(qt, kt, vt, return_lse=True, **kw)
    e_o, e_plain = _rel(o, want_o), _rel(plain_o, want_o)
    assert e_o <= TOL and e_o <= FACTOR * e_plain, (e_o, e_plain)
    e_lse = float((lse.double() - want_lse).abs().max())
    e_plain_lse = float((plain_lse.double() - want_lse).abs().max())
    assert e_lse <= FACTOR * e_plain_lse, (e_lse, e_plain_lse)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_3xtf32_forward_matches_the_jax_reference(case):
    (q, k, v), (qt, kt, vt), kw = _case(case, seed=case[4] * case[5] + 2)
    o, _ = tensor_core_forward(qt, kt, vt, **kw)
    B, S, H, D = q.shape
    Hkv = k.shape[2]
    # the Pallas kernel takes T == S in whole blocks, and no window or prefix
    pallas = kw["q_offset"] == 0 and kw["window"] == 0 and kw["prefix_len"] == 0 and \
        k.shape[1] == S and S % 64 == 0
    if pallas:   # the TPU kernel's body in the Pallas interpreter, (B,H,S,D)
        want = ref_ops.flash_prefill(*(jnp.asarray(a.transpose(0, 2, 1, 3)) for a in (q, k, v)),
                                     causal=kw["causal"], block_q=64, block_k=64,
                                     backend="interpret")
        want = np.asarray(want)
    else:        # the reference's attention, (B,S,H*D)
        want = ref_layers._flash_attention_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                               n_heads=H, n_kv=Hkv, **kw)
        want = np.asarray(want).reshape(B, S, H, D).transpose(0, 2, 1, 3)
    np.testing.assert_allclose(o.numpy(), want, atol=TOL, rtol=TOL)


def test_one_tf32_rounding_would_not_keep_float32_precision():
    """The case for three products: with every operand rounded once to TF32
    the same formulas miss float32's precision by orders of magnitude, and
    the chip's tolerance."""
    _, (qt, kt, vt), kw = _case(CASES[0], seed=3)
    want_o, _ = _float64(qt, kt, vt, **kw)
    once, _ = tensor_core_forward(qt, kt, vt, mm=matmul_1xtf32, **kw)
    plain = flash_prefill_plain(qt, kt, vt, **kw)
    e_once, e_plain = _rel(once, want_o), _rel(plain, want_o)
    assert e_once > 100 * e_plain and e_once > TOL, (e_once, e_plain)
