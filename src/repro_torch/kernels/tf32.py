"""The rounding of the 3xTF32 products, in plain PyTorch.

The float32 kernels that run on the tensor cores (``csrc/tf32_mma.cuh``: the
SSD forward's one-chunk kernel, the SSD backward's tensor-core kernel,
``flash_prefill``'s float32 forward and its float32 backward's two kernels)
keep float32's precision by splitting each operand value v into hi, v
rounded to TF32 (to nearest, ties away from zero, at 13 bits below a
float32's mantissa, as ``cvt.rna.tf32.f32`` rounds), and lo = v - hi,
which the tensor cores read truncated to TF32 (they take a TF32 operand's
top 19 bits); a product is a_lo b_hi + a_hi b_lo + a_hi b_hi, accumulated
in float32. A product of two TF32 values is exact in float32, so
``torch.matmul`` in float32 on the split operands models what the tensor
cores compute, up to the order of the float32 sums. The SSD backward's
float32 kernel and the SSD forward's one-chunk kernel run 6xTF32 instead
(``split3``, ``matmul_6xtf32``): three TF32 pieces a value that sum to it
exactly, six products. The tests use
these functions to hold the kernels' formulas against float64 on the CPU;
no kernel calls them.
"""
from __future__ import annotations

import torch

_KEEP = 0xFFFFE000   # a float32's bits that a TF32 value keeps


def _bits(a: torch.Tensor) -> torch.Tensor:
    """float32 ``a``'s bit patterns as non-negative int64."""
    return a.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF


def _from_bits(u: torch.Tensor) -> torch.Tensor:
    u = u & 0xFFFFFFFF
    return torch.where(u >= 2 ** 31, u - 2 ** 32, u).to(torch.int32).view(torch.float32)


def tf32(a: torch.Tensor) -> torch.Tensor:
    """float32 ``a`` rounded to TF32 as the kernels round hi (and as
    ``cvt.rna.tf32.f32`` does): to nearest at 13 bits below the mantissa's
    last, ties away from zero (half a unit added to the magnitude's bit
    pattern, then the 13 bits cut)."""
    return _from_bits((_bits(a) + 0x1000) & _KEEP)


def truncate(a: torch.Tensor) -> torch.Tensor:
    """float32 ``a`` as the tensor cores read a TF32 operand: its 13 low
    mantissa bits dropped (toward zero)."""
    return _from_bits(_bits(a) & _KEEP)


def split(a: torch.Tensor):
    """(hi, lo) of float32 ``a`` as the products see them: hi = tf32(a), lo =
    a - hi (exact in float32) truncated to TF32."""
    hi = tf32(a)
    return hi, truncate(a - hi)


def matmul_3xtf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` in 3xTF32 with float32 sums: a_lo b_hi + a_hi b_lo + a_hi
    b_hi (``torch.matmul`` broadcasting)."""
    (ah, al), (bh, bl) = split(a), split(b)
    return al @ bh + ah @ bl + ah @ bh


def matmul_1xtf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` with each operand rounded once to TF32 (plain TF32), which
    does not keep float32's precision: the case for three products."""
    return tf32(a) @ tf32(b)


def split3(a: torch.Tensor):
    """(hi, mid, lo) of float32 ``a`` for 6xTF32: hi = tf32(a), mid =
    tf32(a - hi), lo = a - hi - mid; each exact in TF32 (lo keeps two or
    three bits) and hi + mid + lo == a exactly."""
    hi = tf32(a)
    rest = a - hi
    mid = tf32(rest)
    return hi, mid, rest - mid



def matmul_6xtf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` in 6xTF32 with float32 sums: the six products of the
    ``split3`` pieces of more than 2^-24 of the whole, smallest first (lo hi,
    hi lo, mid mid, mid hi, hi mid, hi hi), as ``mma6_step`` issues them."""
    (ah, am, al), (bh, bm, bl) = split3(a), split3(b)
    return al @ bh + ah @ bl + am @ bm + am @ bh + ah @ bm + ah @ bh
