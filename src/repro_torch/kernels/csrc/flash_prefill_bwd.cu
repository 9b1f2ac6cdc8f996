// Backward pass of flash_prefill (causal or full GQA attention), for sm_90a.
//
// The TPU package has no Pallas backward: it trains through jax.grad of plain
// jnp attention (src/repro/models/layers.py::attention_forward). These
// kernels stand in for that gradient. Given q (B,H,S,D), k, v (B,Hkv,T,D), the
// forward's output o, its log-sum-exp lse (B,H,S) and the output's gradient
// dO, they return
//
//   P  = exp(Q K^T scale - lse)      (masked; recomputed, never stored)
//   dV = P^T dO,   dP = dO V^T,   dS = P * (dP - delta),   delta = rowsum(dO * O)
//   dQ = dS K scale,   dK = dS^T Q scale
//
// with dK and dV summed over the query heads of each KV head's group. The
// masks and loop bounds are the forward's (flash_mask.cuh: visible(),
// kv_range()), so the two cannot drift apart; training has no cached rows,
// so q_offset is 0 here. The log-sum-exp comes from the forward (its LSE
// flag), so no kernel here repeats the forward's Q K^T pass to find it.
//
// Two launches, in order on the caller's stream:
//
// (1) dq, one block per (query tile of 64 rows, head): its prologue computes
//     delta of its rows from O and dO and writes it out; then it walks the
//     KV tiles of its kv_range, recomputing S = Q K^T and dP = dO V^T and
//     accumulating dQ += dS K;
// (2) dkdv, one block per (KV tile of 64 rows, KV head): it walks the query
//     tiles that see its tile (those whose kv_range reaches it), over the
//     group's heads, computing the transposed tiles S^T = K Q^T and
//     dP^T = V dO^T and accumulating dV += P^T dO and dK += dS^T Q.
//
// That is seven products per (query tile, KV tile) pair where FA2's single
// kernel does five: S and dP are computed in both kernels. It is the price of
// having no atomics: each gradient element is written by one thread of one
// block and summed in one fixed order, so the result is deterministic (FA2
// and FA3 add dQ across KV blocks with atomics).
//
// * bf16: flash_prefill_bwd_dq_wgmma<D, MASKS> and _dkdv_wgmma<D, MASKS>,
//   every product on the tensor cores (wgmma m64n64k16, fp32 accumulators).
//   A block is one warpgroup (128 threads); its thread 0 issues the TMA loads
//   (flash_hopper.cuh: 4-D maps over the strided views, boxes of 64 x 64
//   with the 128-byte swizzle that the descriptors declare; D = 80 and 96
//   are two boxes whose maps declare D columns, so the TMA unit zero-fills
//   the rest, as in the forward). The tile the block holds (dq: Q and dO;
//   dkdv: K and V) is loaded once; the other side streams through a ring of
//   two stages on "full" mbarriers, and a stage is loaded again after the
//   block's barrier at the end of the step that read it, so the next tile's
//   copy runs during the current tile's products. The score products are
//   both K-major (S = Q K^T: A = Q, B = K; S^T = K Q^T: A = K, B = Q, as
//   stored). P and dS are formed on the fp32 accumulators in registers
//   (exp2 with log2 e folded into the scale and the log-sum-exp), converted
//   to bf16 A fragments in registers, and the gradient products read their B
//   operand (K for dQ; dO and Q for dV and dK) MN-major through the
//   transpose bit. Nothing of P or dS goes through shared memory. In the
//   transposed tiles of dkdv the mask's row is the key and its column the
//   query. MASKS as the forward's: the general mask of visible() only for a
//   window or a prefix. Shared memory: six 64-row tiles (the held pair and
//   two stages of the other), 97 KB at D = 128, 49 KB at D = 64, so two
//   blocks share an SM; registers: dK and dV (or dQ) accumulators of
//   64 x D fp32 plus S and dP, one warpgroup at up to 255 a thread.
//
//   What bounds it: at whisper's encoder (B 1, H 8, D 64, S = T = 1500,
//   full) operations, 7 x 2 x S T D x H = 16 GFLOP, 16.3 us at 989 TFLOP/s
//   (the five needed products 11.7 us); at olmo-1b's training shape
//   (B 8, H 16, D 128, S 128, causal) bytes, 33.6 MB, 10.0 us. A block's
//   steps are dependent: each waits for its S and dP before the exponent
//   and for its gradient products before it frees a stage.
//
// * fp32: flash_prefill_bwd_dq_fma<D> and _dkdv_fma<D>, the same two
//   launches as float32 FMAs from padded shared memory (the tensor cores
//   would round to TF32, and the training parity holds every leaf's gradient
//   norm to the CPU's). 256 threads, each 4 x 2 or 2 x 4 elements of a
//   64 x 32 tile. The tile a block holds is 64 rows; the other side is
//   staged 32 rows at a time, so a block takes 108 KB at D = 128 and two
//   share an SM. What bounds it: at olmo-1b's training shape operations,
//   2.5 x 4 x B H D x the seen pairs = 1.35 GFLOP, 20 us at 67 TFLOP/s;
//   each of a block's 64 x 32 steps waits for its staging at a barrier.
//
// Plain C interface: flash_prefill_bwd_launch() launches (1) and (2) in
// order on the caller's stream and returns cudaGetLastError().

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_hopper.cuh"   // TMA, mbarriers, wgmma; shared with the forward
#include "flash_mask.cuh"     // visible() and kv_range(), shared with the forward

namespace {

constexpr int kTile = 64;      // query rows and KV rows per tile
constexpr float kLog2e = 1.4426950408889634f;

struct View {   // element strides of (batch, head, sequence); D is contiguous
  int64_t b, h, s;
};

struct Args {
  View q, k, v, o, dO, dq, dk, dv;
  int H, Hkv, S, T, causal, window, prefix_len;
  float scale;
};

// The query tiles [qa, qb) whose kv_range reaches the KV tile at k0: the
// tiles that see at least one of its keys (both ends of kv_range grow with
// the query tile, so they are contiguous).
__device__ __forceinline__ void q_tiles(int k0, const Args& a, int& qa, int& qb) {
  const int n_qt = (a.S + kTile - 1) / kTile;
  qa = n_qt;
  qb = 0;
  for (int qt = 0; qt < n_qt; ++qt) {
    int lo, hi;
    kv_range(qt * kTile, a.S, a.T, 0, a.causal, a.window, a.prefix_len, lo, hi);
    if (k0 < hi && k0 + kTile > lo) {
      qa = min(qa, qt);
      qb = qt + 1;
    }
  }
}

__device__ __forceinline__ int64_t row_at(const Args& a, int b, int h, int row) {
  return (static_cast<int64_t>(b) * a.H + h) * a.S + row;
}

// =============================================================== fp32, FMA
constexpr int kThreads = 256;  // 16 x 16 threads
constexpr int kPad = 4;        // floats of padding per shared-memory row
constexpr int kHalf = 32;      // rows of the streamed side staged at a time
// Blocks an SM the register allocation is held to: two at D = 128 (128
// registers; 108 KB of shared memory each), where ptxas fits both kernels
// without spilling; one below it, where it spilled at 128.
constexpr int fma_min_blocks(int D) { return D == 128 ? 2 : 1; }

// Rows [row0, row0 + R) of a (rows, D) matrix with row stride `stride`
// (elements) into dst[R][D + kPad]; rows >= n_rows are zero.
template <int D, int R>
__device__ __forceinline__ void stage(float* dst, const float* src, int64_t stride, int row0,
                                      int n_rows) {
  constexpr int VPR = D / 4;
  for (int idx = threadIdx.x; idx < R * VPR; idx += kThreads) {
    const int r = idx / VPR;
    const int c = (idx % VPR) * 4;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < n_rows) val = *reinterpret_cast<const float4*>(src + (row0 + r) * stride + c);
    *reinterpret_cast<float4*>(dst + r * (D + kPad) + c) = val;
  }
}

// s[i][j] = sum_d A[ty + 16 i][d] B[tx + 16 j][d] over two staged tiles.
template <int D, int NI, int NJ>
__device__ __forceinline__ void tile_dot(const float* A, const float* B, float (&s)[NI][NJ]) {
  constexpr int DP = D + kPad;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll
  for (int i = 0; i < NI; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) s[i][j] = 0.f;
#pragma unroll 2
  for (int d = 0; d < D; d += 4) {
    float4 x[NI];
#pragma unroll
    for (int i = 0; i < NI; ++i)
      x[i] = *reinterpret_cast<const float4*>(A + (ty + 16 * i) * DP + d);
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const float4 y = *reinterpret_cast<const float4*>(B + (tx + 16 * j) * DP + d);
#pragma unroll
      for (int i = 0; i < NI; ++i)
        s[i][j] += x[i].x * y.x + x[i].y * y.y + x[i].z * y.z + x[i].w * y.w;
    }
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

// acc[i][c] += sum_{r < NR} P(ty + 16 i, r) M[r][column c], where P(row, r)
// is P[row * rs + r * cs] (cs = 1: P as stored; rs = 1: its transpose) and M
// a staged NR x D tile.
template <int D, int NR>
__device__ __forceinline__ void acc_product(float (&acc)[4][Cols<D>::NA], const float* P,
                                            int rs, int cs, const float* M) {
  constexpr int DP = D + kPad, NC = Cols<D>::NC, REM = Cols<D>::REM;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll 2
  for (int r = 0; r < NR; ++r) {
    float pa[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) pa[i] = P[(ty + 16 * i) * rs + r * cs];
#pragma unroll
    for (int g = 0; g < NC; ++g) {
      const float4 m = *reinterpret_cast<const float4*>(M + r * DP + 64 * g + 4 * tx);
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
template <int D>
__device__ __forceinline__ void write_rows(float* dst, int64_t stride, int row0, int n_rows,
                                           const float (&acc)[4][Cols<D>::NA], float mul) {
  constexpr int NC = Cols<D>::NC, REM = Cols<D>::REM;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = row0 + ty + 16 * i;
    if (row >= n_rows) continue;
    float* out = dst + row * stride;
#pragma unroll
    for (int g = 0; g < NC; ++g)
      *reinterpret_cast<float4*>(out + 64 * g + 4 * tx) =
          make_float4(acc[i][4 * g] * mul, acc[i][4 * g + 1] * mul, acc[i][4 * g + 2] * mul,
                      acc[i][4 * g + 3] * mul);
#pragma unroll
    for (int c = 0; c < REM; ++c) out[64 * NC + REM * tx + c] = acc[i][4 * NC + c] * mul;
  }
}

// P and dS of a thread's NI x NJ elements: element (i, j) is query row
// ty + 16 i of the staged rows (for lse and delta), at position q0 + that,
// and key k0 + tx + 16 j. p = exp(s scale - lse) where the query exists and
// sees the key, else 0; ds = p (dp - delta). s becomes p, dp becomes ds.
template <int NI, int NJ>
__device__ __forceinline__ void probs(float (&s)[NI][NJ], float (&dp)[NI][NJ],
                                      const float* lse, const float* delta, int q0, int k0,
                                      const Args& a) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll
  for (int i = 0; i < NI; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int qr = ty + 16 * i;
      const int key = k0 + tx + 16 * j;
      const int qpos = q0 + qr;
      const bool seen =
          qpos < a.S && visible(key, qpos, a.T, a.causal, a.window, a.prefix_len);
      const float p = seen ? expf(s[i][j] * a.scale - lse[qr]) : 0.f;
      s[i][j] = p;
      dp[i][j] = seen ? p * (dp[i][j] - delta[qr]) : 0.f;
    }
}

// (1) grid (ceil(S/64), H, B): delta of one query tile's rows, then its dQ
// over the KV tiles of its kv_range, 32 KV rows at a time.
template <int D>
__global__ void __launch_bounds__(kThreads, fma_min_blocks(D))
flash_prefill_bwd_dq_fma(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, const float* __restrict__ o,
                         const float* __restrict__ dO, const float* __restrict__ lse,
                         float* __restrict__ delta, float* __restrict__ dq, Args a) {
  constexpr int DP = D + kPad, NA = Cols<D>::NA, PP = kHalf + kPad;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;                  // [64][DP]
  float* dOs = Qs + kTile * DP;      // [64][DP]
  float* Ks = dOs + kTile * DP;      // [32][DP]
  float* Vs = Ks + kHalf * DP;       // [32][DP]
  float* Ps = Vs + kHalf * DP;       // [64][PP]: dS
  float* lse_s = Ps + kTile * PP;    // [64]
  float* delta_s = lse_s + kTile;    // [64]
  // the last tiles see the most keys when causal: they launch first
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kTile, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (a.H / a.Hkv);
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  stage<D, kTile>(Qs, q + b * a.q.b + h * a.q.h, a.q.s, q0, a.S);
  stage<D, kTile>(dOs, dO + b * a.dO.b + h * a.dO.h, a.dO.s, q0, a.S);
  __syncthreads();

  // delta: the 16 lanes that share ty split each of their rows' D columns
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    float acc = 0.f;
    if (q0 + r < a.S) {
      const float* orow = o + b * a.o.b + h * a.o.h + (q0 + r) * a.o.s;
      for (int c = 4 * tx; c < D; c += 64) {
        const float4 x = *reinterpret_cast<const float4*>(orow + c);
        const float4 y = *reinterpret_cast<const float4*>(dOs + r * DP + c);
        acc += x.x * y.x + x.y * y.y + x.z * y.z + x.w * y.w;
      }
    }
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (tx == 0) {
      const bool real = q0 + r < a.S;
      delta_s[r] = acc;
      lse_s[r] = real ? lse[row_at(a, b, h, q0 + r)] : 0.f;
      if (real) delta[row_at(a, b, h, q0 + r)] = acc;
    }
  }

  float dq_acc[4][NA];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < NA; ++c) dq_acc[i][c] = 0.f;

  int lo, hi;
  kv_range(q0, a.S, a.T, 0, a.causal, a.window, a.prefix_len, lo, hi);
  const float* kb = k + b * a.k.b + hk * a.k.h;
  const float* vb = v + b * a.v.b + hk * a.v.h;
  for (int k0 = lo; k0 < hi; k0 += kHalf) {
    __syncthreads();                 // the previous step is done with Ks, Vs, Ps
    stage<D, kHalf>(Ks, kb, a.k.s, k0, a.T);
    stage<D, kHalf>(Vs, vb, a.v.s, k0, a.T);
    __syncthreads();
    float s[4][2], dp[4][2];
    tile_dot<D, 4, 2>(Qs, Ks, s);
    tile_dot<D, 4, 2>(dOs, Vs, dp);
    probs<4, 2>(s, dp, lse_s, delta_s, q0, k0, a);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) Ps[(ty + 16 * i) * PP + tx + 16 * j] = dp[i][j];
    __syncthreads();
    acc_product<D, kHalf>(dq_acc, Ps, PP, 1, Ks);    // dQ += dS K
  }
  write_rows<D>(dq + b * a.dq.b + h * a.dq.h, a.dq.s, q0, a.S, dq_acc, a.scale);
}

// (2) grid (ceil(T/64), Hkv, B): dK and dV of one KV tile, over the group's
// heads and the query tiles that see it, 32 query rows at a time.
template <int D>
__global__ void __launch_bounds__(kThreads, fma_min_blocks(D))
flash_prefill_bwd_dkdv_fma(const float* __restrict__ q, const float* __restrict__ k,
                           const float* __restrict__ v, const float* __restrict__ dO,
                           const float* __restrict__ lse, const float* __restrict__ delta,
                           float* __restrict__ dk, float* __restrict__ dv, Args a) {
  constexpr int DP = D + kPad, NA = Cols<D>::NA, PP = kTile + kPad;
  extern __shared__ __align__(16) float smem[];
  float* Ks = smem;                  // [64][DP]
  float* Vs = Ks + kTile * DP;       // [64][DP]
  float* Qs = Vs + kTile * DP;       // [32][DP]
  float* dOs = Qs + kHalf * DP;      // [32][DP]
  float* Ps = dOs + kHalf * DP;      // [32][PP]: P, then dS
  float* lse_s = Ps + kHalf * PP;    // [32]
  float* delta_s = lse_s + kHalf;    // [32]
  const int k0 = blockIdx.x * kTile, hk = blockIdx.y, b = blockIdx.z;
  const int group = a.H / a.Hkv;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  stage<D, kTile>(Ks, k + b * a.k.b + hk * a.k.h, a.k.s, k0, a.T);
  stage<D, kTile>(Vs, v + b * a.v.b + hk * a.v.h, a.v.s, k0, a.T);

  float dk_acc[4][NA], dv_acc[4][NA];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < NA; ++c) dk_acc[i][c] = dv_acc[i][c] = 0.f;

  int qa, qb;
  q_tiles(k0, a, qa, qb);
  const int q_end = min(qb * kTile, a.S);
  for (int g = 0; g < group; ++g) {
    const int h = hk * group + g;
    for (int q0 = qa * kTile; q0 < q_end; q0 += kHalf) {
      __syncthreads();               // the previous step is done with Qs, dOs, Ps
      stage<D, kHalf>(Qs, q + b * a.q.b + h * a.q.h, a.q.s, q0, a.S);
      stage<D, kHalf>(dOs, dO + b * a.dO.b + h * a.dO.h, a.dO.s, q0, a.S);
      if (threadIdx.x < kHalf) {
        const int row = q0 + threadIdx.x;
        lse_s[threadIdx.x] = row < a.S ? lse[row_at(a, b, h, row)] : 0.f;
        delta_s[threadIdx.x] = row < a.S ? delta[row_at(a, b, h, row)] : 0.f;
      }
      __syncthreads();
      // element (i, j): query row ty + 16 i of the half, key tx + 16 j
      float s[2][4], dp[2][4];
      tile_dot<D, 2, 4>(Qs, Ks, s);
      tile_dot<D, 2, 4>(dOs, Vs, dp);
      probs<2, 4>(s, dp, lse_s, delta_s, q0, k0, a);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) Ps[(ty + 16 * i) * PP + tx + 16 * j] = s[i][j];
      __syncthreads();
      acc_product<D, kHalf>(dv_acc, Ps, 1, PP, dOs);   // dV += P^T dO
      __syncthreads();
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) Ps[(ty + 16 * i) * PP + tx + 16 * j] = dp[i][j];
      __syncthreads();
      acc_product<D, kHalf>(dk_acc, Ps, 1, PP, Qs);    // dK += dS^T Q
    }
  }
  write_rows<D>(dk + b * a.dk.b + hk * a.dk.h, a.dk.s, k0, a.T, dk_acc, a.scale);
  write_rows<D>(dv + b * a.dv.b + hk * a.dv.h, a.dv.s, k0, a.T, dv_acc, 1.f);
}

template <int D>
int launch_fma(const void* q, const void* k, const void* v, const void* o, const void* dO,
               void* dq, void* dk, void* dv, const float* lse, float* delta, int B,
               const Args& a, cudaStream_t stream) {
  constexpr int DP = D + kPad;
  constexpr int smem_dq =
      static_cast<int>(sizeof(float)) * ((2 * kTile + 2 * kHalf) * DP +
                                         kTile * (kHalf + kPad) + 2 * kTile);
  constexpr int smem_dkdv =
      static_cast<int>(sizeof(float)) * ((2 * kTile + 2 * kHalf) * DP +
                                         kHalf * (kTile + kPad) + 2 * kHalf);
  cudaError_t err = cudaFuncSetAttribute(flash_prefill_bwd_dq_fma<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem_dq);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(flash_prefill_bwd_dkdv_fma<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem_dkdv);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_qt = (a.S + kTile - 1) / kTile, n_kt = (a.T + kTile - 1) / kTile;
  const float* qt = static_cast<const float*>(q);
  const float* kt = static_cast<const float*>(k);
  const float* vt = static_cast<const float*>(v);
  const float* dOt = static_cast<const float*>(dO);
  flash_prefill_bwd_dq_fma<D><<<dim3(n_qt, a.H, B), kThreads, smem_dq, stream>>>(
      qt, kt, vt, static_cast<const float*>(o), dOt, lse, delta, static_cast<float*>(dq), a);
  flash_prefill_bwd_dkdv_fma<D><<<dim3(n_kt, a.Hkv, B), kThreads, smem_dkdv, stream>>>(
      qt, kt, vt, dOt, lse, delta, static_cast<float*>(dk), static_cast<float*>(dv), a);
  return static_cast<int>(cudaGetLastError());
}

// ============================================================ bf16, wgmma
constexpr int kWgThreads = 128;   // one warpgroup; its thread 0 issues the loads

// Whether key `key` is seen by the query at `qpos`, in the forward's mask.
template <int MASKS>
__device__ __forceinline__ bool seen_by(int key, int qpos, const Args& a) {
  return MASKS ? visible(key, qpos, a.T, a.causal, a.window, a.prefix_len)
               : key < a.T && (!a.causal || key <= qpos);
}

// The NB boxes of one 64-row tile of a (D, rows, heads, batch) map at
// (row0, head, b) into `dst`, completed on `bar`.
template <int NB>
__device__ __forceinline__ void load_tile(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                          int row0, int head, int b) {
#pragma unroll
  for (int nb = 0; nb < NB; ++nb) tma_load(dst + nb * kBox, map, bar, 64 * nb, row0, head, b);
}

// acc (64 x 64) = A B^T over the D / 16 steps of real columns, A and B two
// 64-row tiles in shared memory (K-major both); the zero-filled columns past
// D are skipped.
template <int D>
__device__ __forceinline__ void score_product(float (&acc)[32], uint32_t a_s, uint32_t b_s) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t off = (kk >> 2) * kBox + (kk & 3) * 32;
    wgmma_ss(acc, sw128_desc(a_s + off), sw128_desc(b_s + off), kk > 0);
  }
}

// acc[nb] += A M over the 64 rows of M, A given as its A fragments, M a
// 64-row tile in shared memory read MN-major (per 64-column box, 4 steps of
// 16 rows, 2048 bytes apart).
template <int NB>
__device__ __forceinline__ void grad_product(float (&acc)[NB][32], const uint32_t (&a)[4][4],
                                             uint32_t m_s) {
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs(acc[nb], a[kk], sw128_desc(m_s + nb * kBox + kk * 2048));
}

// Rows row0 + r0 and row0 + r0 + 8 (those < n_rows) of a 64 x D
// accumulator, times `mul`, into a bf16 (rows, D) matrix of row stride
// `stride`, cq = 2 (lane % 4) the thread's first column of each 8.
template <int D, int NB>
__device__ __forceinline__ void write_frag(__nv_bfloat16* dst, int64_t stride, int row0,
                                           int n_rows, int r0, int cq,
                                           const float (&acc)[NB][32], float mul) {
  const int ra = row0 + r0, rb = ra + 8;
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      if (64 * nb + 8 * i >= D) continue;   // the zero-filled columns past D
      const int col = 64 * nb + 8 * i + cq;
      if (ra < n_rows)
        *reinterpret_cast<uint32_t*>(dst + ra * stride + col) =
            pack_bf16(acc[nb][4 * i] * mul, acc[nb][4 * i + 1] * mul);
      if (rb < n_rows)
        *reinterpret_cast<uint32_t*>(dst + rb * stride + col) =
            pack_bf16(acc[nb][4 * i + 2] * mul, acc[nb][4 * i + 3] * mul);
    }
}

template <int NB>
__device__ __forceinline__ void zero(float (&acc)[NB][32]) {
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int j = 0; j < 32; ++j) acc[nb][j] = 0.f;
}

// (1) grid (ceil(S/64), H, B), 128 threads: delta of one query tile's rows,
// then dQ over the KV tiles of its kv_range. Shared memory: Q, dO, then two
// stages of (K, V), each tile NB boxes.
template <int D, int MASKS>
__global__ void __launch_bounds__(kWgThreads, 2)
flash_prefill_bwd_dq_wgmma(const __grid_constant__ CUtensorMap tm_q,
                           const __grid_constant__ CUtensorMap tm_k,
                           const __grid_constant__ CUtensorMap tm_v,
                           const __grid_constant__ CUtensorMap tm_do,
                           const __nv_bfloat16* __restrict__ o,
                           const __nv_bfloat16* __restrict__ dO,
                           const float* __restrict__ lse, float* __restrict__ delta,
                           __nv_bfloat16* __restrict__ dq, Args a, float scale_log2) {
  static_assert(D % 16 == 0, "head_dim must be a multiple of 16");
  constexpr int NB = (D + 63) / 64;
  constexpr int kT = NB * kBox;           // bytes of one 64-row tile
  __shared__ __align__(8) uint64_t bars[3];   // Q/dO, full[2]
  __shared__ float lse_s[kTile], delta_s[kTile];
  extern __shared__ __align__(16) uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_s = base, do_s = base + kT;
  const uint32_t kv_s = base + 2 * kT;    // stage st: K at + 2 st kT, V at + (2 st + 1) kT
  const uint32_t bar_qdo = smem_u32(&bars[0]);
  const uint32_t bar_full = smem_u32(&bars[1]);   // + 8 * stage

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kTile, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (a.H / a.Hkv);
  int lo, hi;
  kv_range(q0, a.S, a.T, 0, a.causal, a.window, a.prefix_len, lo, hi);
  const int t0 = lo / kTile;
  const int n_it = (hi + kTile - 1) / kTile - t0;

  if (threadIdx.x == 0) {
    for (int i = 0; i < 3; ++i) mbar_init(smem_u32(&bars[i]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    mbar_expect_tx(bar_qdo, 2 * kT);
    load_tile<NB>(q_s, &tm_q, bar_qdo, q0, h, b);
    load_tile<NB>(do_s, &tm_do, bar_qdo, q0, h, b);
    for (int it = 0; it < min(2, n_it); ++it) {
      mbar_expect_tx(bar_full + 8 * it, 2 * kT);
      const int row0 = (t0 + it) * kTile;
      load_tile<NB>(kv_s + 2 * it * kT, &tm_k, bar_full + 8 * it, row0, hk, b);
      load_tile<NB>(kv_s + (2 * it + 1) * kT, &tm_v, bar_full + 8 * it, row0, hk, b);
    }
  }

  // delta of the tile's rows while the loads run: two threads a row, each
  // half of its D columns of O and dO, 8 bf16 at a time
  {
    const int r = threadIdx.x >> 1, half = threadIdx.x & 1;
    const int row = q0 + r;
    float acc = 0.f;
    if (row < a.S) {
      const __nv_bfloat16* orow = o + b * a.o.b + h * a.o.h + row * a.o.s + half * (D / 2);
      const __nv_bfloat16* drow = dO + b * a.dO.b + h * a.dO.h + row * a.dO.s + half * (D / 2);
#pragma unroll
      for (int c = 0; c < D / 2; c += 8) {
        const uint4 x = *reinterpret_cast<const uint4*>(orow + c);
        const uint4 y = *reinterpret_cast<const uint4*>(drow + c);
        const __nv_bfloat162* xp = reinterpret_cast<const __nv_bfloat162*>(&x);
        const __nv_bfloat162* yp = reinterpret_cast<const __nv_bfloat162*>(&y);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 xf = __bfloat1622float2(xp[e]), yf = __bfloat1622float2(yp[e]);
          acc += xf.x * yf.x + xf.y * yf.y;
        }
      }
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    if (half == 0) {
      delta_s[r] = acc;
      if (row < a.S) delta[row_at(a, b, h, row)] = acc;
    } else {
      lse_s[r] = row < a.S ? lse[row_at(a, b, h, row)] * kLog2e : 0.f;
    }
  }
  __syncthreads();   // barriers initialised; lse_s and delta_s written

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r0 = warp * 16 + (lane >> 2), cq = (lane & 3) * 2;
  const int qpos0 = q0 + r0, qpos1 = qpos0 + 8;
  const float lse0 = lse_s[r0], lse1 = lse_s[r0 + 8];
  const float dl0 = delta_s[r0], dl1 = delta_s[r0 + 8];

  float dq_acc[NB][32];
  zero<NB>(dq_acc);
  mbar_wait(bar_qdo, 0);
  for (int it = 0; it < n_it; ++it) {
    const int st = it & 1;
    const uint32_t k_s = kv_s + 2 * st * kT, v_s = k_s + kT;
    mbar_wait(bar_full + 8 * st, (it >> 1) & 1);
    __syncwarp();

    // S = Q K^T and dP = dO V^T, two groups: the exponent runs on S while
    // dP is still being computed
    float s[32], dp[32];
#pragma unroll
    for (int j = 0; j < 32; ++j) s[j] = dp[j] = 0.f;
    fence_regs(s);
    fence_regs(dp);
    wgmma_fence();
    score_product<D>(s, q_s, k_s);
    wgmma_commit();
    score_product<D>(dp, do_s, v_s);
    wgmma_commit();
    wgmma_wait<1>();
    fence_regs(s);
    const int k0 = (t0 + it) * kTile;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int key = k0 + (j >> 2) * 8 + cq + (j & 1);
      const bool second = (j & 2) != 0;
      const bool seen = seen_by<MASKS>(key, second ? qpos1 : qpos0, a);
      s[j] = seen ? exp2f(s[j] * scale_log2 - (second ? lse1 : lse0)) : 0.f;
    }
    wgmma_wait<0>();
    fence_regs(dp);
#pragma unroll
    for (int j = 0; j < 32; ++j) dp[j] = s[j] * (dp[j] - ((j & 2) ? dl1 : dl0));

    // dQ += dS K: dS from registers, K MN-major
    uint32_t da[4][4];
    to_a_frags(dp, da);
    wgmma_fence();
    grad_product<NB>(dq_acc, da, k_s);
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) fence_regs(dq_acc[nb]);

    __syncthreads();   // every product of this step has read stage st
    if (threadIdx.x == 0 && it + 2 < n_it) {
      mbar_expect_tx(bar_full + 8 * st, 2 * kT);
      load_tile<NB>(k_s, &tm_k, bar_full + 8 * st, (t0 + it + 2) * kTile, hk, b);
      load_tile<NB>(v_s, &tm_v, bar_full + 8 * st, (t0 + it + 2) * kTile, hk, b);
    }
  }
  write_frag<D, NB>(dq + b * a.dq.b + h * a.dq.h, a.dq.s, q0, a.S, r0, cq, dq_acc, a.scale);
}

// (2) grid (ceil(T/64), Hkv, B), 128 threads: dK and dV of one KV tile over
// the group's heads (outer) and the query tiles that see it (inner). Shared
// memory: K, V, then two stages of (Q, dO), and per stage the stage's lse
// (times log2 e) and delta.
template <int D, int MASKS>
__global__ void __launch_bounds__(kWgThreads, 2)
flash_prefill_bwd_dkdv_wgmma(const __grid_constant__ CUtensorMap tm_q,
                             const __grid_constant__ CUtensorMap tm_k,
                             const __grid_constant__ CUtensorMap tm_v,
                             const __grid_constant__ CUtensorMap tm_do,
                             const float* __restrict__ lse, const float* __restrict__ delta,
                             __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
                             Args a, float scale_log2) {
  static_assert(D % 16 == 0, "head_dim must be a multiple of 16");
  constexpr int NB = (D + 63) / 64;
  constexpr int kT = NB * kBox;
  __shared__ __align__(8) uint64_t bars[3];   // K/V, full[2]
  __shared__ float rows_s[2][2][kTile];       // [stage][lse, delta][query row]
  extern __shared__ __align__(16) uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t k_s = base, v_s = base + kT;
  const uint32_t qd_s = base + 2 * kT;    // stage st: Q at + 2 st kT, dO at + (2 st + 1) kT
  const uint32_t bar_kv = smem_u32(&bars[0]);
  const uint32_t bar_full = smem_u32(&bars[1]);   // + 8 * stage

  const int k0 = blockIdx.x * kTile, hk = blockIdx.y, b = blockIdx.z;
  const int group = a.H / a.Hkv;
  int qa, qb;
  q_tiles(k0, a, qa, qb);
  const int nq = max(0, qb - qa);
  // step it: head hk group + it / nq, query tile qa + it % nq
  const int n_it = group * nq;

  // the lse and delta of step it's query rows into rows_s[it & 1]
  auto load_rows = [&](int it) {
    const int h = hk * group + it / nq, row = (qa + it % nq) * kTile + (threadIdx.x & 63);
    const bool real = row < a.S;
    if (threadIdx.x < 64)
      rows_s[it & 1][0][threadIdx.x] = real ? lse[row_at(a, b, h, row)] * kLog2e : 0.f;
    else
      rows_s[it & 1][1][threadIdx.x - 64] = real ? delta[row_at(a, b, h, row)] : 0.f;
  };
  auto load_stage = [&](int it) {
    const int st = it & 1, h = hk * group + it / nq, row0 = (qa + it % nq) * kTile;
    mbar_expect_tx(bar_full + 8 * st, 2 * kT);
    load_tile<NB>(qd_s + 2 * st * kT, &tm_q, bar_full + 8 * st, row0, h, b);
    load_tile<NB>(qd_s + (2 * st + 1) * kT, &tm_do, bar_full + 8 * st, row0, h, b);
  };

  if (threadIdx.x == 0) {
    for (int i = 0; i < 3; ++i) mbar_init(smem_u32(&bars[i]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    mbar_expect_tx(bar_kv, 2 * kT);
    load_tile<NB>(k_s, &tm_k, bar_kv, k0, hk, b);
    load_tile<NB>(v_s, &tm_v, bar_kv, k0, hk, b);
    for (int it = 0; it < min(2, n_it); ++it) load_stage(it);
  }
  for (int it = 0; it < min(2, n_it); ++it) load_rows(it);
  __syncthreads();   // barriers initialised; rows_s of the first two steps written

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r0 = warp * 16 + (lane >> 2), cq = (lane & 3) * 2;
  const int key0 = k0 + r0, key1 = key0 + 8;   // this thread's rows of S^T

  float dk_acc[NB][32], dv_acc[NB][32];
  zero<NB>(dk_acc);
  zero<NB>(dv_acc);
  mbar_wait(bar_kv, 0);
  for (int it = 0; it < n_it; ++it) {
    const int st = it & 1;
    const uint32_t q_s = qd_s + 2 * st * kT, do_s = q_s + kT;
    const float* lse_r = rows_s[st][0];
    const float* delta_r = rows_s[st][1];
    const int q0 = (qa + it % nq) * kTile;
    mbar_wait(bar_full + 8 * st, (it >> 1) & 1);
    __syncwarp();

    // S^T = K Q^T and dP^T = V dO^T; element j: key row key0 / key1, query
    // column q0 + c
    float s[32], dp[32];
#pragma unroll
    for (int j = 0; j < 32; ++j) s[j] = dp[j] = 0.f;
    fence_regs(s);
    fence_regs(dp);
    wgmma_fence();
    score_product<D>(s, k_s, q_s);
    wgmma_commit();
    score_product<D>(dp, v_s, do_s);
    wgmma_commit();
    wgmma_wait<1>();
    fence_regs(s);
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int c = (j >> 2) * 8 + cq + (j & 1);
      const int qpos = q0 + c;
      const bool seen = qpos < a.S && seen_by<MASKS>((j & 2) ? key1 : key0, qpos, a);
      s[j] = seen ? exp2f(s[j] * scale_log2 - lse_r[c]) : 0.f;
    }
    wgmma_wait<0>();
    fence_regs(dp);
#pragma unroll
    for (int j = 0; j < 32; ++j) dp[j] = s[j] * (dp[j] - delta_r[(j >> 2) * 8 + cq + (j & 1)]);

    // dV += P^T dO, dK += dS^T Q: A from registers, dO and Q MN-major
    uint32_t pa[4][4], da[4][4];
    to_a_frags(s, pa);
    to_a_frags(dp, da);
    wgmma_fence();
    grad_product<NB>(dv_acc, pa, do_s);
    grad_product<NB>(dk_acc, da, q_s);
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
      fence_regs(dv_acc[nb]);
      fence_regs(dk_acc[nb]);
    }

    __syncthreads();   // every product of this step has read stage st and rows_s[st]
    if (it + 2 < n_it) {
      if (threadIdx.x == 0) load_stage(it + 2);
      load_rows(it + 2);   // read at step it + 2, after the next step's barrier
    }
  }
  write_frag<D, NB>(dk + b * a.dk.b + hk * a.dk.h, a.dk.s, k0, a.T, r0, cq, dk_acc, a.scale);
  write_frag<D, NB>(dv + b * a.dv.b + hk * a.dv.h, a.dv.s, k0, a.T, r0, cq, dv_acc, 1.f);
}

template <int D, int MASKS>
int launch_wgmma_as(const void* q, const void* k, const void* v, const void* o,
                    const void* dO, void* dq, void* dk, void* dv, const float* lse,
                    float* delta, int B, const Args& a, cudaStream_t stream) {
  CUtensorMap tm_q, tm_k, tm_v, tm_do;
  CUresult res = bind_context();
  if (res == CUDA_SUCCESS) res = encode_map(&tm_q, q, D, a.S, a.H, B, a.q.s, a.q.h, a.q.b);
  if (res == CUDA_SUCCESS) res = encode_map(&tm_k, k, D, a.T, a.Hkv, B, a.k.s, a.k.h, a.k.b);
  if (res == CUDA_SUCCESS) res = encode_map(&tm_v, v, D, a.T, a.Hkv, B, a.v.s, a.v.h, a.v.b);
  if (res == CUDA_SUCCESS)
    res = encode_map(&tm_do, dO, D, a.S, a.H, B, a.dO.s, a.dO.h, a.dO.b);
  if (res != CUDA_SUCCESS) return -static_cast<int>(res);
  // six 64-row tiles, and room to align them to 1024 bytes
  constexpr int smem = 6 * ((D + 63) / 64) * kBox + 1024;
  cudaError_t err = cudaFuncSetAttribute(flash_prefill_bwd_dq_wgmma<D, MASKS>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(flash_prefill_bwd_dkdv_wgmma<D, MASKS>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_qt = (a.S + kTile - 1) / kTile, n_kt = (a.T + kTile - 1) / kTile;
  const float scale_log2 = a.scale * kLog2e;
  flash_prefill_bwd_dq_wgmma<D, MASKS><<<dim3(n_qt, a.H, B), kWgThreads, smem, stream>>>(
      tm_q, tm_k, tm_v, tm_do, static_cast<const __nv_bfloat16*>(o),
      static_cast<const __nv_bfloat16*>(dO), lse, delta, static_cast<__nv_bfloat16*>(dq), a,
      scale_log2);
  flash_prefill_bwd_dkdv_wgmma<D, MASKS><<<dim3(n_kt, a.Hkv, B), kWgThreads, smem, stream>>>(
      tm_q, tm_k, tm_v, tm_do, lse, delta, static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), a, scale_log2);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_wgmma(const void* q, const void* k, const void* v, const void* o, const void* dO,
                 void* dq, void* dk, void* dv, const float* lse, float* delta, int B,
                 const Args& a, cudaStream_t stream) {
  const bool masks = a.causal && (a.window > 0 || a.prefix_len > 0);
  return (masks ? launch_wgmma_as<D, 1> : launch_wgmma_as<D, 0>)(q, k, v, o, dO, dq, dk, dv,
                                                                lse, delta, B, a, stream);
}

View view(const long long* s) { return View{s[0], s[1], s[2]}; }

}  // namespace

// strides: 24 element strides, (batch, head, sequence) of q, k, v, o, dO, dq,
// dk, dv in turn. lse: the forward's log-sum-exp, float32 (B, H, S),
// contiguous; delta: float32 scratch of B * H * S. window (0 = none) and
// prefix_len (0 = none) act only when causal. is_bf16: 1 for bfloat16
// tensors (the wgmma kernels), 0 for float32 (the FMA kernels). Returns
// cudaGetLastError() after the launches (0 = launched), minus the CUresult
// if a tensor map cannot be encoded, or cudaErrorInvalidValue for a head_dim
// the kernels do not take.
extern "C" int flash_prefill_bwd_launch(const void* q, const void* k, const void* v,
                                        const void* o, const void* dO, void* dq, void* dk,
                                        void* dv, const float* lse, float* delta, int B,
                                        int H, int Hkv, int S, int T, int D, int causal,
                                        int window, int prefix_len, int is_bf16,
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
    if (D == 128) return launch_wgmma<128>(REPRO_BWD_ARGS);
    if (D == 96) return launch_wgmma<96>(REPRO_BWD_ARGS);
    if (D == 80) return launch_wgmma<80>(REPRO_BWD_ARGS);
    if (D == 64) return launch_wgmma<64>(REPRO_BWD_ARGS);
  } else {
    if (D == 128) return launch_fma<128>(REPRO_BWD_ARGS);
    if (D == 96) return launch_fma<96>(REPRO_BWD_ARGS);
    if (D == 80) return launch_fma<80>(REPRO_BWD_ARGS);
    if (D == 64) return launch_fma<64>(REPRO_BWD_ARGS);
  }
#undef REPRO_BWD_ARGS
  return static_cast<int>(cudaErrorInvalidValue);
}
