// Backward pass of flash_prefill (causal or full GQA attention), for sm_90a.
//
// The TPU package has no Pallas backward: it trains through jax.grad of plain
// jnp attention (src/repro/models/layers.py::attention_forward). This kernel
// stands in for that gradient. Given q (B,H,S,D), k, v (B,Hkv,T,D), the
// forward's output o and the output's gradient dO, it returns
//
//   P  = softmax(Q K^T scale + mask)      (recomputed, never stored)
//   dV = P^T dO,   dP = dO V^T,   dS = P * (dP - rowsum(dO * O))
//   dQ = dS K scale,   dK = dS^T Q scale
//
// with dK and dV summed over the query heads of each KV head's group. The
// masks and loop bounds are the forward's (flash_mask.cuh: visible(),
// kv_range()), so the two cannot drift apart; training has no cached rows,
// so q_offset is 0 here.
//
// Three kernels, each one thread block per 64-row tile, 256 threads of 4 x 4
// elements of a 64 x 64 tile (the forward's fp32 FMA layout), float32 FMAs
// from padded shared memory; bf16 inputs are widened to float32 as they are
// staged, so every product accumulates in float32:
//
// (a) rowstats, grid (ceil(S/64), H, B): each query row's log-sum-exp over
//     the keys it sees (one pass of Q K^T with the online max and sum) and
//     delta = rowsum(dO * O);
// (b) dkdv, grid (ceil(T/64), Hkv, B): one K/V tile held in shared memory,
//     dK and dV accumulated in registers over the group's query heads and
//     the query tiles that see the tile (those whose kv_range reaches it);
// (c) dq, grid (ceil(S/64), H, B): one Q/dO tile held, dQ accumulated in
//     registers over the KV tiles of its kv_range.
//
// Each gradient element is written by one thread of one block and summed in
// one fixed order: no atomics, so the result is deterministic. Recomputing
// the log-sum-exp (a) instead of saving it in the forward, and FMAs instead of
// wgmma, keep this first version simple; both are speed work for later.
//
// Plain C interface: flash_prefill_bwd_launch() launches (a), (b), (c) in
// order on the caller's stream and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_mask.cuh"   // visible() and kv_range(), shared with the forward

namespace {

constexpr int kTile = 64;      // query rows and KV rows per tile
constexpr int kThreads = 256;  // 16 x 16 threads, each 4 rows x 4 columns
constexpr int kPad = 4;        // floats of padding per shared-memory row
constexpr int kPP = kTile + kPad;
constexpr float kNegInf = -1e30f;

struct View {   // element strides of (batch, head, sequence); D is contiguous
  int64_t b, h, s;
};

struct Args {
  View q, k, v, o, dO, dq, dk, dv;
  int H, Hkv, S, T, causal, window, prefix_len;
  float scale;
};

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);   // 4 bf16, 8 bytes
  const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&raw.x);
  const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&raw.y);
  const float2 a = __bfloat1622float2(lo), b = __bfloat1622float2(hi);
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// Rows [row0, row0 + 64) of a (rows, D) matrix with row stride `stride`
// (elements) into dst[64][D + kPad] as float32; rows >= n_rows are zero.
template <int D, typename T>
__device__ __forceinline__ void stage(float* dst, const T* src, int64_t stride, int row0,
                                      int n_rows) {
  constexpr int VPR = D / 4;
  for (int idx = threadIdx.x; idx < kTile * VPR; idx += kThreads) {
    const int r = idx / VPR;
    const int c = (idx % VPR) * 4;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < n_rows) val = load4(src + (row0 + r) * stride + c);
    *reinterpret_cast<float4*>(dst + r * (D + kPad) + c) = val;
  }
}

// s[i][j] = sum_d A[ty + 16 i][d] B[tx + 16 j][d] over two staged tiles.
template <int D>
__device__ __forceinline__ void tile_dot(const float* A, const float* B, float (&s)[4][4]) {
  constexpr int DP = D + kPad;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; d += 4) {
    float4 a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = load4(A + (ty + 16 * i) * DP + d);
#pragma unroll
    for (int j = 0; j < 4; ++j) b[j] = load4(B + (tx + 16 * j) * DP + d);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        s[i][j] += a[i].x * b[j].x + a[i].y * b[j].y + a[i].z * b[j].z + a[i].w * b[j].w;
  }
}

// Columns a thread owns of a D-wide row: NC float4 groups at 64 g + 4 tx and
// REM single columns at 64 NC + REM tx + r (D = 80: one group and one column;
// D = 96: one group and two).
template <int D>
struct Cols {
  static constexpr int NC = D / 64;
  static constexpr int REM = (D % 64) / 16;
  static constexpr int NA = 4 * NC + REM;
};

// acc[i][c] += sum_r P(ty + 16 i, r) M[r][column c], where P(row, r) is
// P[row * rs + r * cs] (rs, cs = kPP, 1: P as stored; 1, kPP: its transpose)
// and M a staged 64 x D tile.
template <int D>
__device__ __forceinline__ void acc_product(float (&acc)[4][Cols<D>::NA], const float* P,
                                            int rs, int cs, const float* M) {
  constexpr int DP = D + kPad, NC = Cols<D>::NC, REM = Cols<D>::REM;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll 4
  for (int r = 0; r < kTile; ++r) {
    float pa[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) pa[i] = P[(ty + 16 * i) * rs + r * cs];
#pragma unroll
    for (int g = 0; g < NC; ++g) {
      const float4 m = load4(M + r * DP + 64 * g + 4 * tx);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        acc[i][4 * g + 0] += pa[i] * m.x;
        acc[i][4 * g + 1] += pa[i] * m.y;
        acc[i][4 * g + 2] += pa[i] * m.z;
        acc[i][4 * g + 3] += pa[i] * m.w;
      }
    }
#pragma unroll
    for (int c = 0; c < REM; ++c) {
      const float m = M[r * DP + 64 * NC + REM * tx + c];
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[i][4 * NC + c] += pa[i] * m;
    }
  }
}

// Rows row0 + ty + 16 i (< n_rows) of acc, times `mul`, into a (rows, D)
// matrix of row stride `stride`.
template <int D, typename T>
__device__ __forceinline__ void write_rows(T* dst, int64_t stride, int row0, int n_rows,
                                           const float (&acc)[4][Cols<D>::NA], float mul) {
  constexpr int NC = Cols<D>::NC, REM = Cols<D>::REM;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = row0 + ty + 16 * i;
    if (row >= n_rows) continue;
    T* out = dst + row * stride;
#pragma unroll
    for (int g = 0; g < NC; ++g)
#pragma unroll
      for (int e = 0; e < 4; ++e) store(out + 64 * g + 4 * tx + e, acc[i][4 * g + e] * mul);
#pragma unroll
    for (int c = 0; c < REM; ++c) store(out + 64 * NC + REM * tx + c, acc[i][4 * NC + c] * mul);
  }
}

// P and dS of one (query tile, KV tile) pair in the thread's 4 x 4 elements:
// p = exp(s scale - lse) where the query row exists and sees the key, else 0;
// ds = p (dp - delta).
__device__ __forceinline__ void probs(float (&s)[4][4], const float (&dp)[4][4],
                                      const float* lse, const float* delta, int q0, int k0,
                                      const Args& a, float (&ds)[4][4]) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = ty + 16 * i;
    const int qpos = q0 + row;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = k0 + tx + 16 * j;
      const bool seen =
          qpos < a.S && visible(col, qpos, a.T, a.causal, a.window, a.prefix_len);
      const float p = seen ? expf(s[i][j] * a.scale - lse[row]) : 0.f;
      s[i][j] = p;
      ds[i][j] = p * (dp[i][j] - delta[row]);
    }
  }
}

// (a) grid (ceil(S/64), H, B): lse and delta of every query row.
template <int D, typename T>
__global__ void __launch_bounds__(kThreads, 1)
flash_prefill_bwd_rowstats(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ o, const T* __restrict__ dO,
                           float* __restrict__ lse, float* __restrict__ delta, Args a) {
  constexpr int DP = D + kPad;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;                  // [64][DP]
  float* Ks = Qs + kTile * DP;       // [64][DP]
  const int q0 = blockIdx.x * kTile, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (a.H / a.Hkv);
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  stage<D>(Qs, q + b * a.q.b + h * a.q.h, a.q.s, q0, a.S);

  // delta: the 16 lanes that share ty split each of their rows' D columns
  float dsum[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    float acc = 0.f;
    if (row < a.S) {
      const T* orow = o + b * a.o.b + h * a.o.h + row * a.o.s;
      const T* drow = dO + b * a.dO.b + h * a.dO.h + row * a.dO.s;
      for (int c = 4 * tx; c < D; c += 64) {
        const float4 x = load4(orow + c), y = load4(drow + c);
        acc += x.x * y.x + x.y * y.y + x.z * y.z + x.w * y.w;
      }
    }
    dsum[i] = acc;
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) dsum[i] += __shfl_xor_sync(0xffffffffu, dsum[i], off);

  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
  }
  int lo, hi;
  kv_range(q0, a.S, a.T, 0, a.causal, a.window, a.prefix_len, lo, hi);
  const T* kb = k + b * a.k.b + hk * a.k.h;
  for (int k0 = lo; k0 < hi; k0 += kTile) {
    __syncthreads();                 // the previous step is done with Ks
    stage<D>(Ks, kb, a.k.s, k0, a.T);
    __syncthreads();
    float s[4][4];
    tile_dot<D>(Qs, Ks, s);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty + 16 * i;
      float rmax = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool seen =
            visible(k0 + tx + 16 * j, qpos, a.T, a.causal, a.window, a.prefix_len);
        s[i][j] = seen ? s[i][j] * a.scale : kNegInf;
        rmax = fmaxf(rmax, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rmax = fmaxf(rmax, __shfl_xor_sync(0xffffffffu, rmax, off));
      const float m_new = fmaxf(m[i], rmax);
      float rsum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        rsum += s[i][j] > 0.5f * kNegInf ? expf(s[i][j] - m_new) : 0.f;
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) rsum += __shfl_xor_sync(0xffffffffu, rsum, off);
      l[i] = l[i] * expf(m[i] - m_new) + rsum;
      m[i] = m_new;
    }
  }
  if (tx == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty + 16 * i;
      if (row >= a.S) continue;
      const int64_t at = (static_cast<int64_t>(b) * a.H + h) * a.S + row;
      lse[at] = m[i] + logf(fmaxf(l[i], 1e-30f));
      delta[at] = dsum[i];
    }
  }
}

// (b) grid (ceil(T/64), Hkv, B): dK and dV of one KV tile.
template <int D, typename T>
__global__ void __launch_bounds__(kThreads, 1)
flash_prefill_bwd_dkdv(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, const T* __restrict__ dO,
                       const float* __restrict__ lse, const float* __restrict__ delta,
                       T* __restrict__ dk, T* __restrict__ dv, Args a) {
  constexpr int DP = D + kPad, NA = Cols<D>::NA;
  extern __shared__ __align__(16) float smem[];
  float* Ks = smem;                  // [64][DP]
  float* Vs = Ks + kTile * DP;
  float* Qs = Vs + kTile * DP;
  float* dOs = Qs + kTile * DP;
  float* Ps = dOs + kTile * DP;      // [64][kPP]: P, then dS
  float* lse_s = Ps + kTile * kPP;   // [64]
  float* delta_s = lse_s + kTile;    // [64]
  const int k0 = blockIdx.x * kTile, hk = blockIdx.y, b = blockIdx.z;
  const int group = a.H / a.Hkv;
  stage<D>(Ks, k + b * a.k.b + hk * a.k.h, a.k.s, k0, a.T);
  stage<D>(Vs, v + b * a.v.b + hk * a.v.h, a.v.s, k0, a.T);

  float dk_acc[4][NA], dv_acc[4][NA];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < NA; ++c) dk_acc[i][c] = dv_acc[i][c] = 0.f;

  const int n_qt = (a.S + kTile - 1) / kTile;
  for (int g = 0; g < group; ++g) {
    const int h = hk * group + g;
    for (int qt = 0; qt < n_qt; ++qt) {
      const int q0 = qt * kTile;
      int lo, hi;
      kv_range(q0, a.S, a.T, 0, a.causal, a.window, a.prefix_len, lo, hi);
      if (k0 >= hi || k0 + kTile <= lo) continue;   // no row of the tile sees it
      __syncthreads();               // the previous tile is done with Qs, dOs, Ps
      stage<D>(Qs, q + b * a.q.b + h * a.q.h, a.q.s, q0, a.S);
      stage<D>(dOs, dO + b * a.dO.b + h * a.dO.h, a.dO.s, q0, a.S);
      if (threadIdx.x < kTile) {
        const int row = q0 + threadIdx.x;
        const int64_t at = (static_cast<int64_t>(b) * a.H + h) * a.S + row;
        lse_s[threadIdx.x] = row < a.S ? lse[at] : 0.f;
        delta_s[threadIdx.x] = row < a.S ? delta[at] : 0.f;
      }
      __syncthreads();
      float s[4][4], dp[4][4], ds[4][4];
      tile_dot<D>(Qs, Ks, s);
      tile_dot<D>(dOs, Vs, dp);
      probs(s, dp, lse_s, delta_s, q0, k0, a, ds);
      const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) Ps[(ty + 16 * i) * kPP + tx + 16 * j] = s[i][j];
      __syncthreads();
      acc_product<D>(dv_acc, Ps, 1, kPP, dOs);       // dV += P^T dO
      __syncthreads();
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) Ps[(ty + 16 * i) * kPP + tx + 16 * j] = ds[i][j];
      __syncthreads();
      acc_product<D>(dk_acc, Ps, 1, kPP, Qs);        // dK += dS^T Q
    }
  }
  write_rows<D>(dk + b * a.dk.b + hk * a.dk.h, a.dk.s, k0, a.T, dk_acc, a.scale);
  write_rows<D>(dv + b * a.dv.b + hk * a.dv.h, a.dv.s, k0, a.T, dv_acc, 1.f);
}

// (c) grid (ceil(S/64), H, B): dQ of one query tile.
template <int D, typename T>
__global__ void __launch_bounds__(kThreads, 1)
flash_prefill_bwd_dq(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dO,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     T* __restrict__ dq, Args a) {
  constexpr int DP = D + kPad, NA = Cols<D>::NA;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;                  // [64][DP]
  float* dOs = Qs + kTile * DP;
  float* Ks = dOs + kTile * DP;
  float* Vs = Ks + kTile * DP;
  float* Ps = Vs + kTile * DP;       // [64][kPP]: dS
  float* lse_s = Ps + kTile * kPP;
  float* delta_s = lse_s + kTile;
  const int q0 = blockIdx.x * kTile, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (a.H / a.Hkv);
  stage<D>(Qs, q + b * a.q.b + h * a.q.h, a.q.s, q0, a.S);
  stage<D>(dOs, dO + b * a.dO.b + h * a.dO.h, a.dO.s, q0, a.S);
  if (threadIdx.x < kTile) {
    const int row = q0 + threadIdx.x;
    const int64_t at = (static_cast<int64_t>(b) * a.H + h) * a.S + row;
    lse_s[threadIdx.x] = row < a.S ? lse[at] : 0.f;
    delta_s[threadIdx.x] = row < a.S ? delta[at] : 0.f;
  }

  float dq_acc[4][NA];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < NA; ++c) dq_acc[i][c] = 0.f;

  int lo, hi;
  kv_range(q0, a.S, a.T, 0, a.causal, a.window, a.prefix_len, lo, hi);
  const T* kb = k + b * a.k.b + hk * a.k.h;
  const T* vb = v + b * a.v.b + hk * a.v.h;
  for (int k0 = lo; k0 < hi; k0 += kTile) {
    __syncthreads();                 // the previous step is done with Ks, Vs, Ps
    stage<D>(Ks, kb, a.k.s, k0, a.T);
    stage<D>(Vs, vb, a.v.s, k0, a.T);
    __syncthreads();
    float s[4][4], dp[4][4], ds[4][4];
    tile_dot<D>(Qs, Ks, s);
    tile_dot<D>(dOs, Vs, dp);
    probs(s, dp, lse_s, delta_s, q0, k0, a, ds);
    const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) Ps[(ty + 16 * i) * kPP + tx + 16 * j] = ds[i][j];
    __syncthreads();
    acc_product<D>(dq_acc, Ps, kPP, 1, Ks);          // dQ += dS K
  }
  write_rows<D>(dq + b * a.dq.b + h * a.dq.h, a.dq.s, q0, a.S, dq_acc, a.scale);
}

template <int D, typename T>
int launch(const void* q, const void* k, const void* v, const void* o, const void* dO,
           void* dq, void* dk, void* dv, float* lse, float* delta, int B, const Args& a,
           cudaStream_t stream) {
  constexpr int DP = D + kPad;
  constexpr int smem_a = static_cast<int>(sizeof(float)) * 2 * kTile * DP;
  constexpr int smem_bc =
      static_cast<int>(sizeof(float)) * (4 * kTile * DP + kTile * kPP + 2 * kTile);
  cudaError_t err = cudaFuncSetAttribute(flash_prefill_bwd_rowstats<D, T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem_a);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(flash_prefill_bwd_dkdv<D, T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bc);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(flash_prefill_bwd_dq<D, T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bc);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_qt = (a.S + kTile - 1) / kTile, n_kt = (a.T + kTile - 1) / kTile;
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* dOt = static_cast<const T*>(dO);
  flash_prefill_bwd_rowstats<D, T><<<dim3(n_qt, a.H, B), kThreads, smem_a, stream>>>(
      qt, kt, static_cast<const T*>(o), dOt, lse, delta, a);
  flash_prefill_bwd_dkdv<D, T><<<dim3(n_kt, a.Hkv, B), kThreads, smem_bc, stream>>>(
      qt, kt, vt, dOt, lse, delta, static_cast<T*>(dk), static_cast<T*>(dv), a);
  flash_prefill_bwd_dq<D, T><<<dim3(n_qt, a.H, B), kThreads, smem_bc, stream>>>(
      qt, kt, vt, dOt, lse, delta, static_cast<T*>(dq), a);
  return static_cast<int>(cudaGetLastError());
}

View view(const long long* s) { return View{s[0], s[1], s[2]}; }

}  // namespace

// strides: 24 element strides, (batch, head, sequence) of q, k, v, o, dO, dq,
// dk, dv in turn. lse and delta: float32 scratch of B * H * S each. window
// (0 = none) and prefix_len (0 = none) act only when causal. is_bf16: 1 for
// bfloat16 tensors, 0 for float32. Returns cudaGetLastError() after the
// launches (0 = launched), or cudaErrorInvalidValue for a head_dim the
// kernels do not take.
extern "C" int flash_prefill_bwd_launch(const void* q, const void* k, const void* v,
                                        const void* o, const void* dO, void* dq, void* dk,
                                        void* dv, float* lse, float* delta, int B, int H,
                                        int Hkv, int S, int T, int D, int causal, int window,
                                        int prefix_len, int is_bf16,
                                        const long long* strides, float scale,
                                        void* stream) {
  Args a;
  a.q = view(strides);
  a.k = view(strides + 3);
  a.v = view(strides + 6);
  a.o = view(strides + 9);
  a.dO = view(strides + 12);
  a.dq = view(strides + 15);
  a.dk = view(strides + 18);
  a.dv = view(strides + 21);
  a.H = H;
  a.Hkv = Hkv;
  a.S = S;
  a.T = T;
  a.causal = causal;
  a.window = window;
  a.prefix_len = prefix_len;
  a.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define REPRO_BWD_ARGS q, k, v, o, dO, dq, dk, dv, lse, delta, B, a, s
  if (is_bf16) {
    if (D == 128) return launch<128, __nv_bfloat16>(REPRO_BWD_ARGS);
    if (D == 96) return launch<96, __nv_bfloat16>(REPRO_BWD_ARGS);
    if (D == 80) return launch<80, __nv_bfloat16>(REPRO_BWD_ARGS);
    if (D == 64) return launch<64, __nv_bfloat16>(REPRO_BWD_ARGS);
  } else {
    if (D == 128) return launch<128, float>(REPRO_BWD_ARGS);
    if (D == 96) return launch<96, float>(REPRO_BWD_ARGS);
    if (D == 80) return launch<80, float>(REPRO_BWD_ARGS);
    if (D == 64) return launch<64, float>(REPRO_BWD_ARGS);
  }
#undef REPRO_BWD_ARGS
  return static_cast<int>(cudaErrorInvalidValue);
}
