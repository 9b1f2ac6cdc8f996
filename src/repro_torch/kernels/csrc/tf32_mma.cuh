// 3xTF32 (and 6xTF32) products on the tensor cores and cp.async staging,
// shared by the kernels that keep float32's precision on mma.sync: the SSD
// backward's tensor-core kernel (ssd_scan_bwd.cu; 6xTF32 for float32
// inputs), the SSD forward's one-chunk kernel
// (ssd_scan.cu; 6xTF32), flash_prefill's float32 forward (flash_prefill.cu) and its
// float32 backward's two kernels (flash_prefill_bwd.cu).
//
// 3xTF32. A TF32 rounding keeps about three decimal digits, which is not a
// float32 trainer's arithmetic. Each operand value v is split as it is read
// into hi, v rounded to TF32 (to nearest, in two integer operations), and
// lo = v - hi (exact in fp32, read by the tensor cores truncated to TF32);
// a product is a_lo b_hi + a_hi b_lo + a_hi b_hi with fp32 accumulators,
// float32-accurate (tests/test_torch_ssd_tf32.py,
// tests/test_torch_flash_tf32.py and tests/test_torch_flash_bwd_tf32.py
// model it on the CPU against float64, with kernels/tf32.py). The tensor
// cores add into the accumulator with truncation: a long sum in one
// accumulator loses more than float32 (flash_prefill.cu's and
// flash_prefill_bwd.cu's float32 kernels and the SSD forward's one-chunk
// kernel sum at most four k-steps there before a rounding fp32 add;
// warp_mma_rounded). A value that is exact in
// TF32 (a bf16 input) has lo = 0: its lo products are left out.
//
// Fragments of mma.sync.m16n8k8.tf32, lane l of a warp, g = l / 4, t = l % 4:
// A (16 x 8): a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4);
// B (8 x 8): b0 (t, g), b1 (t + 4, g); the accumulator (16 x 8): c0 (g, 2t),
// c1 (g, 2t + 1), c2 (g + 8, 2t), c3 (g + 8, 2t + 1).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// v rounded to TF32, to nearest with ties away from zero: half a unit of the
// last TF32 place added to the bit pattern, the 13 bits below it cut (what
// cvt.rna.tf32.f32 gives, in two integer operations)
__device__ __forceinline__ uint32_t tf32_hi(float v) {
  return (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
}

// v - hi, exact in fp32; the tensor cores read a TF32 operand's top 19 bits,
// so it enters the product truncated to TF32, which keeps hi + lo within
// 2^-21 of v
__device__ __forceinline__ uint32_t tf32_lo(float v, uint32_t hi) {
  return __float_as_uint(v - __uint_as_float(hi));
}

// d (16 x 8, fp32) += a (16 x 8, tf32) b (8 x 8, tf32), one warp
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One k-step of 3xTF32 products, one warp: d[n_first + nb] += A (16 x 8)
// B_nb (8 x 8) for nb < NB, from the fragments' values av (the A fragment)
// and bv[nb] (the B fragment of n-tile nb), split here. The products are
// issued term by term over the n-tiles, so that back-to-back products go to
// different accumulators (a product's latency is hidden behind the NB - 1
// others). n_first is a constant once the caller's loops are unrolled.
template <int NB, bool A_EXACT, bool B_EXACT, int NT>
__device__ __forceinline__ void mma3_step(float (&d)[NT][4], int n_first, const float (&av)[4],
                                          const float (&bv)[NB][2]) {
  uint32_t ahi[4], alo[4], bhi[NB][2], blo[NB][2];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    ahi[q] = tf32_hi(av[q]);
    alo[q] = A_EXACT ? 0u : tf32_lo(av[q], ahi[q]);
  }
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      bhi[nb][q] = tf32_hi(bv[nb][q]);
      blo[nb][q] = B_EXACT ? 0u : tf32_lo(bv[nb][q], bhi[nb][q]);
    }
  if (!A_EXACT)
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) mma_tf32(d[n_first + nb], alo, bhi[nb][0], bhi[nb][1]);
  if (!B_EXACT)
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) mma_tf32(d[n_first + nb], ahi, blo[nb][0], blo[nb][1]);
#pragma unroll
  for (int nb = 0; nb < NB; ++nb) mma_tf32(d[n_first + nb], ahi, bhi[nb][0], bhi[nb][1]);
}

// d[nt] += A (16 x K) B (K x 8 NT) in 3xTF32, one warp; la(m, k) and
// lb(k, n) read A and B from shared memory as floats. The fragment of d[nt]:
// lane l holds rows l/4 and l/4 + 8, columns 8 nt + 2 (l%4) and + 1. A k-step
// loads all its fragments first, then splits them and issues its products
// (mma3_step).
template <int NT, int K, bool A_EXACT, bool B_EXACT, typename LA, typename LB>
__device__ __forceinline__ void warp_mma(float (&d)[NT][4], LA la, LB lb) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll 2
  for (int k0 = 0; k0 < K; k0 += 8) {
    const float av[4] = {la(g, k0 + t), la(g + 8, k0 + t), la(g, k0 + t + 4),
                         la(g + 8, k0 + t + 4)};
    float bv[NT][2];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      bv[nt][0] = lb(k0 + t, 8 * nt + g);
      bv[nt][1] = lb(k0 + t + 4, 8 * nt + g);
    }
    mma3_step<NT, A_EXACT, B_EXACT>(d, 0, av, bv);
  }
}

// 6xTF32: each operand value v split into three TF32 values that sum to it
// exactly, hi = tf32(v), mid = tf32(v - hi) and lo = v - hi - mid (two or
// three bits, exact in TF32, as hi and mid are); a product keeps the six
// terms of more than 2^-24 of it, issued smallest first (lo hi, hi lo, mid
// mid, mid hi, hi mid, hi hi). 3xTF32's lo, read truncated to TF32, leaves
// a product up to 2^-21 off, eight times a float32 rounding: a sum of many
// products averages that out, a sum of one does not (the SSD backward at
// s = 1 erred up to 31x the plain float32 version's error against float64
// on the card). A value exact in TF32 (a bf16 input) has mid = lo = 0: its
// terms in them are left out.
template <int NB, bool A_EXACT, bool B_EXACT, int NT>
__device__ __forceinline__ void mma6_step(float (&d)[NT][4], const float (&av)[4],
                                          const float (&bv)[NB][2]) {
  uint32_t ah[4], am[4], al[4], bh[NB][2], bm[NB][2], bl[NB][2];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    ah[q] = tf32_hi(av[q]);
    const float r = av[q] - __uint_as_float(ah[q]);
    am[q] = A_EXACT ? 0u : tf32_hi(r);
    al[q] = A_EXACT ? 0u : __float_as_uint(r - __uint_as_float(am[q]));
  }
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      bh[nb][q] = tf32_hi(bv[nb][q]);
      const float r = bv[nb][q] - __uint_as_float(bh[nb][q]);
      bm[nb][q] = B_EXACT ? 0u : tf32_hi(r);
      bl[nb][q] = B_EXACT ? 0u : __float_as_uint(r - __uint_as_float(bm[nb][q]));
    }
  if (!A_EXACT)
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) mma_tf32(d[nb], al, bh[nb][0], bh[nb][1]);
  if (!B_EXACT)
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) mma_tf32(d[nb], ah, bl[nb][0], bl[nb][1]);
  if (!A_EXACT && !B_EXACT)
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) mma_tf32(d[nb], am, bm[nb][0], bm[nb][1]);
  if (!A_EXACT)
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) mma_tf32(d[nb], am, bh[nb][0], bh[nb][1]);
  if (!B_EXACT)
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) mma_tf32(d[nb], ah, bm[nb][0], bm[nb][1]);
#pragma unroll
  for (int nb = 0; nb < NB; ++nb) mma_tf32(d[nb], ah, bh[nb][0], bh[nb][1]);
}

// d[nt] += A (16 x K) B (K x 8 NT) in 6xTF32 (mma6_step), one warp, each
// k-step's products in a fresh accumulator that a rounding fp32 add joins to
// d: a long K is never summed in a truncating accumulator (the tensor cores'
// adds truncate; see warp_mma_rounded). One k-step is in flight: in both SSD
// kernels two spilled at their 168-register cap.
template <int NT, int K, bool A_EXACT, bool B_EXACT, typename LA, typename LB>
__device__ __forceinline__ void warp_mma6(float (&d)[NT][4], LA la, LB lb) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  static_assert(K % 8 == 0, "K must be a multiple of a k-step");
#pragma unroll 1
  for (int k0 = 0; k0 < K; k0 += 8) {
    const float av[4] = {la(g, k0 + t), la(g + 8, k0 + t), la(g, k0 + t + 4),
                         la(g + 8, k0 + t + 4)};
    float bv[NT][2];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      bv[nt][0] = lb(k0 + t, 8 * nt + g);
      bv[nt][1] = lb(k0 + t + 4, 8 * nt + g);
    }
    float part[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int r = 0; r < 4; ++r) part[nt][r] = 0.f;
    mma6_step<NT, A_EXACT, B_EXACT>(part, av, bv);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int r = 0; r < 4; ++r) d[nt][r] += part[nt][r];
  }
}

// d[nt] += A (16 x K) B (K x 8 NT) as warp_mma, but summed four k-steps at a
// time (two, or one, where four do not divide K) in fresh accumulators, each
// partial sum added to d by a rounding fp32 add: over a long K the tensor
// cores' truncating adds into one accumulator lose float32's precision (the
// SSD forward's C B^T over N = 128 erred 5.9x the plain float32 version's
// error against float64 at s = 1 on the card).
template <int NT, int K, bool A_EXACT, bool B_EXACT, typename LA, typename LB>
__device__ __forceinline__ void warp_mma_rounded(float (&d)[NT][4], LA la, LB lb) {
  constexpr int KC = K % 32 == 0 ? 32 : (K % 16 == 0 ? 16 : 8);
  static_assert(K % 8 == 0, "K must be a multiple of a k-step");
#pragma unroll 1
  for (int kc = 0; kc < K; kc += KC) {
    float part[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int r = 0; r < 4; ++r) part[nt][r] = 0.f;
    warp_mma<NT, KC, A_EXACT, B_EXACT>(part, [&](int m, int k) { return la(m, kc + k); },
                                       [&](int k, int n) { return lb(kc + k, n); });
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int r = 0; r < 4; ++r) d[nt][r] += part[nt][r];
  }
}

// The k index of a k-step's position k (0 <= k < 8 inside the step) when a
// product's k axis is read in "pair order": positions t and t + 4 of the
// fragments are the neighbouring indices 2t and 2t + 1. A product may sum
// over k in any order as long as A and B agree. In pair order the
// accumulator fragment of one product (columns 2t, 2t + 1 of each 8-column
// tile) is, register for register, the A fragment of a next one whose k runs
// over those columns (a0 = c0, a1 = c2, a2 = c1, a3 = c3), and a B operand
// read along k with rows of stride LD = 4 (mod 8) floats is free of bank
// conflicts (rows 2t lie 8t banks apart).
__device__ __forceinline__ int pair_k(int k) { return (k & ~7) | ((k & 3) << 1) | ((k >> 2) & 1); }

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, uint32_t bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(bytes)
               : "memory");
}

// the barrier's arrival once every cp.async this thread issued has landed
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(bar) : "memory");
}

// Rows [0, ROWS) of a (rows, W) float matrix whose row r starts at src + r *
// stride (floats, W contiguous) into dst[ROWS][LD] by cp.async from the
// calling warp (THREADS = 32) or from threads 0 .. THREADS - 1 together;
// rows >= n_valid are filled with zeros (nothing is read for them).
template <int ROWS, int W, int LD, int THREADS = 32>
__device__ __forceinline__ void cp_async_rows(float* dst, const float* src, int64_t stride,
                                              int n_valid) {
  constexpr int CPR = W / 4;   // 16-byte pieces a row
  for (int idx = threadIdx.x % THREADS; idx < ROWS * CPR; idx += THREADS) {
    const int r = idx / CPR, c = idx % CPR;
    const bool ok = r < n_valid;
    cp_async16(static_cast<uint32_t>(__cvta_generic_to_shared(dst + r * LD + c * 4)),
               src + (ok ? r * stride : 0) + c * 4, ok ? 16u : 0u);
  }
}

}  // namespace
