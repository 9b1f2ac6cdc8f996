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
// * fp32: flash_prefill_bwd_dq_tf32<D> and _dkdv_tf32<D>, the same two
//   launches with every product on the tensor cores in 3xTF32 (tf32_mma.cuh:
//   each operand split into a TF32 hi and lo, three mma.sync.m16n8k8
//   products, fp32 accumulators), which keeps float32's precision
//   (tests/test_torch_flash_bwd_tf32.py models the kernels' arithmetic on
//   the CPU against float64); P stays exp(S scale - lse) in fp32 with expf,
//   as the fp32 forward's. wgmma is not used: it takes a 32-bit operand
//   K-major only, and the gradient products read K, dO and Q along their
//   rows. A block is eight warps (256 threads), which stage and compute
//   alike: the held pair (dq: Q and dO; dkdv: K and V) once, then the other
//   side's 64-row tiles (dq: K and V; dkdv: Q, dO and the step's lse and
//   delta rows) into a ring of two stages by cp.async into rows of D + 4
//   floats (conflict-free fragment loads), each stage completed on an
//   mbarrier when every thread's copies have landed; step it + 2's copy is
//   issued after the block's barrier at the end of step it, so it runs under
//   step it + 1's products. Warp w holds rows 16 (w % 4) .. + 15 of the held
//   tile and takes rows 32 (w / 4) .. + 31 of every streamed step: the split
//   that keeps dkdv's registers in bounds at D = 128, where a warp's dK and
//   dV accumulators of 16 rows take 128 floats a thread and its S^T and dP^T
//   of 16 x 32 another 32 (a 16 x 64 step would be 64 more). P and dS never
//   leave the registers: dq computes S = Q K^T and dP = dO V^T and then
//   dQ += dS K, dkdv the transposed S^T = K Q^T and dP^T = V dO^T and then
//   dV += P^T dO and dK += dS^T Q, each gradient product reading the score
//   accumulator as its A fragment with the k axis in pair order (pair_k).
//   Warps w and w + 4 hold the same rows over the two halves of every step;
//   at the end warps 4-7 leave their sums in shared memory and warps 0-3 add
//   them to their own, one fixed order, and write the rows out. On the
//   causal diagonal (no prefix) a warp whose 16 x 32 sub-tile lies wholly
//   above it skips the step's products (two warps of eight there). Every
//   product sums at most four k-steps on the tensor cores before a rounding
//   fp32 add (see score_tf32), which keeps the error against float64 within
//   chip_smoke.py's TF32_FACTOR of the plain float32 version's. dq's
//   prologue computes delta while the copies run, each warp 8 rows with
//   every load issued first: a block at olmo-1b's shape runs one or two
//   steps, so its start-up is much of its time.
//   Shared memory: six 64-row tiles, 203,840 bytes with the header at
//   D = 128, so one block an SM, at up to 255 registers a thread (dkdv<128>
//   takes more than 168: a ninth warp, a producer as in the fp32 forward,
//   puts three warps on one of the SM's four register files and caps every
//   thread at 168, where dkdv<128> spilled; two blocks of five warps, as the
//   fp32 forward runs, would leave 113 KB a block, room for a streamed side
//   of 32 rows in a single buffer, and dkdv 204 registers for its 160 floats
//   of accumulators and scores). What bounds it at olmo-1b's training shape
//   (B 8, H 16, D 128, S 128, causal): bytes, q, k, v, o, dO, dQ, dK, dV and
//   the lse, 67.2 MB, 20.05 us at 3.35 TB/s, against the five needed
//   products of 1.353 GFLOP, 8.2 us as 3xTF32 at 495 TFLOP/s (20.19 us at
//   the FP32 FMA rate); the kernels do seven products over 3 of the 4 tile
//   pairs, 8.46 GFLOP of TF32, 17.1 us at the peak. What holds it back
//   there: one block of eight warps an SM, and blocks of one or two steps,
//   so each block's staging (the held pair and the first stage, 135 KB)
//   and its dependent chains of load, split and product are exposed
//   (PERF.md).
//
// Plain C interface: flash_prefill_bwd_launch() launches (1) and (2) in
// order on the caller's stream and returns cudaGetLastError().

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_hopper.cuh"   // TMA, mbarriers, wgmma; shared with the forward
#include "flash_mask.cuh"     // visible() and kv_range(), shared with the forward
#include "tf32_mma.cuh"       // 3xTF32 products on mma.sync, cp.async staging

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

// ====================================================== fp32, 3xTF32 mma.sync
constexpr int kTcWarps = 8;   // warps a block, each staging and computing
constexpr int kTcThreads = kTcWarps * 32;
constexpr int kHalf = 32;     // streamed rows of a step a warp takes
// Shared memory of the fp32 kernels: three mbarriers (64 bytes), the lse and
// delta rows of two query stages (dkdv; dq keeps its tile's delta there),
// then six 64-row tiles of D + 4 floats: the held pair and two stages of the
// streamed pair.
constexpr int kTcHead = 64 + 2 * 2 * kTile * static_cast<int>(sizeof(float));
template <int D>
constexpr int tc_smem() {
  return kTcHead + 6 * kTile * (D + 4) * static_cast<int>(sizeof(float));
}
// the mbarriers, each completed when every thread's cp.async into it has
// landed: the held pair's, and each stage's (+ stage)
constexpr int kFullHeld = 0, kFullStage = 1;

// a 4-byte cp.async (an lse or delta value; zero-filled where bytes is 0)
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, uint32_t bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(bytes)
               : "memory");
}

// Rows [row0, row0 + 64) of a (rows, D) float matrix at src (row stride
// `stride`) into dst[64][D + 4] by cp.async from the whole block; rows past
// n_rows are zero-filled.
template <int D>
__device__ __forceinline__ void stage_tile(float* dst, const float* src, int64_t stride,
                                           int row0, int n_rows) {
  cp_async_rows<kTile, D, D + 4, kTcThreads>(dst, src + row0 * stride, stride, n_rows - row0);
}

// The tensor cores add a product's terms into its fp32 accumulator with
// truncation, not rounding to nearest: summed over D (or over a step's rows)
// in one running accumulator, the error against float64 grew to several
// times the plain float32 version's on the H100, beyond chip_smoke.py's
// TF32_FACTOR (the lo terms, 2^-11 of the accumulator, lose their low bits
// at every step). So every product here sums at most four k-steps (32 of
// its k) on the tensor cores, into fresh registers, and adds that partial
// sum to the running one in fp32 with rounding to nearest.

// d (16 x 32) = A B^T over D, one warp, 3xTF32: A's 16 rows and B's 32
// rows in shared memory, rows LD = D + 4 floats apart (S = Q K^T in dq,
// S^T = K Q^T in dkdv, and the same for dP), in chunks of 32 columns (16 at
// D = 80). Fragment of d[nt]: lane l holds rows l/4 and l/4 + 8, columns
// 8 nt + 2 (l%4) and + 1. With LD = 4 (mod 8) floats the A and B fragment
// loads are free of bank conflicts.
template <int D>
__device__ __forceinline__ void score_tf32(float (&d)[4][4], const float* a, const float* b) {
  constexpr int LD = D + 4, CH = D % 32 == 0 ? 32 : 16;
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int r = 0; r < 4; ++r) d[nt][r] = 0.f;
#pragma unroll 1
  for (int c0 = 0; c0 < D; c0 += CH) {
    float part[4][4];
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int r = 0; r < 4; ++r) part[nt][r] = 0.f;
    warp_mma<4, CH, false, false>(part, [&](int m, int k) { return a[m * LD + c0 + k]; },
                                  [&](int k, int n) { return b[n * LD + c0 + k]; });
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int r = 0; r < 4; ++r) d[nt][r] += part[nt][r];
  }
}

// acc (16 x D) += A M, one warp, 3xTF32: A (16 x 32) is a score-shaped
// accumulator in registers (dS in dq; P^T or dS^T in dkdv), read as the A
// operand with its k axis in pair order (tf32_mma.cuh, pair_k): the
// accumulator fragment of columns 8 kk .. 8 kk + 7 is the A fragment of
// k-step kk as it stands (a0 = c0, a1 = c2, a2 = c1, a3 = c3), and M's rows
// 8 kk + 2t and + 1 (K in dq; dO and Q in dkdv, 32 rows in shared memory)
// are its B fragment, conflict-free at LD = 4 (mod 8). G 8-column tiles of
// acc at a time: their four k-steps into fresh registers, then added.
template <int D>
__device__ __forceinline__ void grad_tf32(float (&acc)[D / 8][4], const float (&p)[4][4],
                                          const float* m) {
  constexpr int LD = D + 4, NO = D / 8;
  constexpr int G = NO % 4 == 0 ? 4 : 2;   // 8-column tiles of a group of products
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int n0 = 0; n0 < NO; n0 += G) {
    float part[G][4];
#pragma unroll
    for (int j = 0; j < G; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) part[j][r] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kHalf / 8; ++kk) {
      const float av[4] = {p[kk][0], p[kk][2], p[kk][1], p[kk][3]};
      const float* mr = m + (8 * kk + 2 * t) * LD + g + 8 * n0;
      float bv[G][2];
#pragma unroll
      for (int j = 0; j < G; ++j) {
        bv[j][0] = mr[8 * j];
        bv[j][1] = mr[LD + 8 * j];
      }
      mma3_step<G, false, false>(part, 0, av, bv);
    }
#pragma unroll
    for (int j = 0; j < G; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[n0 + j][r] += part[j][r];
  }
}

// The partial sums of consumer warps 4-7 (the other half of every step's
// streamed rows) to those of warps 0-3 (the same 16 rows), in fragment order
// through `buf` (64 x D floats: lane-consecutive, conflict-free); stash by
// warps 4-7, then, after a barrier, add_stash by warps 0-3, so each
// gradient element is summed in one fixed order.
template <int NO>
__device__ __forceinline__ void stash(const float (&acc)[NO][4], float* buf) {
  float* mine = buf + ((threadIdx.x >> 5) & 3) * NO * 128 + (threadIdx.x & 31);
#pragma unroll
  for (int nt = 0; nt < NO; ++nt)
#pragma unroll
    for (int r = 0; r < 4; ++r) mine[(4 * nt + r) * 32] = acc[nt][r];
}

template <int NO>
__device__ __forceinline__ void add_stash(float (&acc)[NO][4], const float* buf) {
  const float* mine = buf + ((threadIdx.x >> 5) & 3) * NO * 128 + (threadIdx.x & 31);
#pragma unroll
  for (int nt = 0; nt < NO; ++nt)
#pragma unroll
    for (int r = 0; r < 4; ++r) acc[nt][r] += mine[(4 * nt + r) * 32];
}

// Rows row0 + l/4 and + 8 (those < n_rows) of a warp's 16 x D accumulator,
// times `mul`, into a (rows, D) float matrix of row stride `stride`.
template <int NO>
__device__ __forceinline__ void write_acc(float* dst, int64_t stride, int row0, int n_rows,
                                          const float (&acc)[NO][4], float mul) {
  const int lane = threadIdx.x & 31, ra = row0 + (lane >> 2), rb = ra + 8;
#pragma unroll
  for (int nt = 0; nt < NO; ++nt) {
    const int col = 8 * nt + 2 * (lane & 3);
    if (ra < n_rows)
      *reinterpret_cast<float2*>(dst + ra * stride + col) =
          make_float2(acc[nt][0] * mul, acc[nt][1] * mul);
    if (rb < n_rows)
      *reinterpret_cast<float2*>(dst + rb * stride + col) =
          make_float2(acc[nt][2] * mul, acc[nt][3] * mul);
  }
}

// (1) grid (ceil(S/64), H, B), 256 threads: dQ of one query tile over the
// KV tiles of its kv_range. Warp w holds query rows 16 (w % 4) .. + 15 of
// the tile and takes KV rows 32 (w / 4) .. + 31 of every 64-row step. The
// block stages Q and dO once, then K and V of each step into a ring of two
// stages: step it + 2's copy is issued once every warp is done with step it
// and lands while step it + 1 computes. The longest tiles (the last, when
// causal) launch first.
template <int D>
__global__ void __launch_bounds__(kTcThreads, 1)
flash_prefill_bwd_dq_tf32(const float* __restrict__ q, const float* __restrict__ k,
                          const float* __restrict__ v, const float* __restrict__ o,
                          const float* __restrict__ dO, const float* __restrict__ lse,
                          float* __restrict__ delta, float* __restrict__ dq, Args a) {
  static_assert(D % 16 == 0 && D <= 128, "head_dim must be a multiple of 16, at most 128");
  constexpr int LD = D + 4, NO = D / 8;
  extern __shared__ __align__(16) unsigned char smem_tc[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem_tc);
  float* Qs = reinterpret_cast<float*>(smem_tc + kTcHead);   // [64][LD]
  float* dOs = Qs + kTile * LD;                              // [64][LD]
  float* kv = dOs + kTile * LD;   // stage st: K [64][LD] at + 2 st 64 LD, V after it
  auto bar = [&](int i) { return smem_u32(bars + i); };

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kTile, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (a.H / a.Hkv);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  int lo, hi;
  kv_range(q0, a.S, a.T, 0, a.causal, a.window, a.prefix_len, lo, hi);
  const int t0 = lo / kTile;
  const int n_it = (hi + kTile - 1) / kTile - t0;
  const float* kb = k + b * a.k.b + hk * a.k.h;
  const float* vb = v + b * a.v.b + hk * a.v.h;
  // K and V of step it into its stage; each thread's arrival once its
  // copies (and every earlier one) have landed
  auto load_step = [&](int it) {
    const int st = it & 1, k0 = (t0 + it) * kTile;
    float* ks = kv + 2 * st * kTile * LD;
    stage_tile<D>(ks, kb, a.k.s, k0, a.T);
    stage_tile<D>(ks + kTile * LD, vb, a.v.s, k0, a.T);
    cp_async_arrive(bar(kFullStage + st));
  };

  if (threadIdx.x == 0) {
    for (int i = 0; i < 3; ++i) mbar_init(bar(i), kTcThreads);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  stage_tile<D>(Qs, q + b * a.q.b + h * a.q.h, a.q.s, q0, a.S);
  stage_tile<D>(dOs, dO + b * a.dO.b + h * a.dO.h, a.dO.s, q0, a.S);
  cp_async_arrive(bar(kFullHeld));
  for (int it = 0; it < min(2, n_it); ++it) load_step(it);

  // query rows row0 and row1 of the tile in this thread
  const int g = lane >> 2, t = lane & 3;
  const int r0 = 16 * (warp & 3), c0 = kHalf * (warp >> 2);
  const int row0 = q0 + r0 + g, row1 = row0 + 8;

  // delta of the tile's rows while the copies run: warp w the 8 rows
  // 8 w .. 8 w + 7, a row's D columns over the lanes, 4 each, every load
  // issued before the first sum, each row summed by a butterfly (every lane
  // ends with the same bits); out for dkdv, and into shared memory for the
  // warps that hold the rows
  float* delta_s = reinterpret_cast<float*>(smem_tc + 64);   // [64]
  {
    const float* ob = o + b * a.o.b + h * a.o.h;
    const float* db = dO + b * a.dO.b + h * a.dO.h;
    float4 x[8], y[8];
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int row = q0 + 8 * warp + r;
      x[r] = y[r] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (row < a.S && 4 * lane < D) {
        x[r] = *reinterpret_cast<const float4*>(ob + row * a.o.s + 4 * lane);
        y[r] = *reinterpret_cast<const float4*>(db + row * a.dO.s + 4 * lane);
      }
    }
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int row = q0 + 8 * warp + r;
      float acc = x[r].x * y[r].x + x[r].y * y[r].y + x[r].z * y[r].z + x[r].w * y[r].w;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
      if (lane == 0) {
        delta_s[8 * warp + r] = acc;
        if (row < a.S) delta[row_at(a, b, h, row)] = acc;
      }
    }
  }
  const float* lb = lse + row_at(a, b, h, 0);
  const float lse0 = row0 < a.S ? lb[row0] : 0.f, lse1 = row1 < a.S ? lb[row1] : 0.f;
  __syncthreads();   // delta_s written
  const float dl0 = delta_s[r0 + g], dl1 = delta_s[r0 + g + 8];

  float acc[NO][4];
#pragma unroll
  for (int nt = 0; nt < NO; ++nt)
#pragma unroll
    for (int r = 0; r < 4; ++r) acc[nt][r] = 0.f;

  const float* qs = Qs + r0 * LD;
  const float* dos = dOs + r0 * LD;
  mbar_wait(bar(kFullHeld), 0);
  for (int it = 0; it < n_it; ++it) {
    const int st = it & 1;
    const float* ks = kv + (2 * st * kTile + c0) * LD;   // the warp's 32 rows of K
    const float* vs = ks + kTile * LD;                   // and of V
    const int k0 = (t0 + it) * kTile + c0;               // their first key
    mbar_wait(bar(kFullStage + st), (it >> 1) & 1);
    // causal without a prefix, keys wholly past the warp's last row: P and
    // dS are 0 there, and the warp skips the step's products
    if (!(a.causal && a.prefix_len == 0 && k0 > q0 + r0 + 15)) {
      float s[4][4], dp[4][4];
      score_tf32<D>(s, qs, ks);     // S = Q K^T
      score_tf32<D>(dp, dos, vs);   // dP = dO V^T
      // P = exp(S scale - lse) where the query sees the key, else 0;
      // dS = P (dP - delta), left in dp
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool second = e >= 2;
          const int key = k0 + 8 * nt + 2 * t + (e & 1);
          const int qpos = second ? row1 : row0;
          const bool seen =
              qpos < a.S && visible(key, qpos, a.T, a.causal, a.window, a.prefix_len);
          const float p = seen ? expf(s[nt][e] * a.scale - (second ? lse1 : lse0)) : 0.f;
          dp[nt][e] = seen ? p * (dp[nt][e] - (second ? dl1 : dl0)) : 0.f;
        }
      grad_tf32<D>(acc, dp, ks);    // dQ += dS K
    }
    __syncthreads();   // every warp is done with stage st
    if (it + 2 < n_it) load_step(it + 2);
  }

  // warps 4-7's sums into stage 0 (free: the loop ended on a barrier, after
  // every copy landed), then warps 0-3 add them to theirs and write the rows
  if (warp >= 4) stash<NO>(acc, kv);
  __syncthreads();
  if (warp < 4) {
    add_stash<NO>(acc, kv);
    write_acc<NO>(dq + b * a.dq.b + h * a.dq.h, a.dq.s, q0 + r0, a.S, acc, a.scale);
  }
}

// (2) grid (ceil(T/64), Hkv, B), 256 threads: dK and dV of one KV tile over
// the group's heads (outer) and the query tiles that see it (inner). Warp w
// holds KV rows 16 (w % 4) .. + 15 of the tile and takes query rows
// 32 (w / 4) .. + 31 of every 64-row step. The block stages K and V once,
// then Q, dO and the step's lse and delta rows into a ring of two stages, as
// dq stages K and V.
template <int D>
__global__ void __launch_bounds__(kTcThreads, 1)
flash_prefill_bwd_dkdv_tf32(const float* __restrict__ q, const float* __restrict__ k,
                            const float* __restrict__ v, const float* __restrict__ dO,
                            const float* __restrict__ lse, const float* __restrict__ delta,
                            float* __restrict__ dk, float* __restrict__ dv, Args a) {
  static_assert(D % 16 == 0 && D <= 128, "head_dim must be a multiple of 16, at most 128");
  constexpr int LD = D + 4, NO = D / 8;
  extern __shared__ __align__(16) unsigned char smem_tc[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem_tc);
  float* rows = reinterpret_cast<float*>(smem_tc + 64);     // [stage][lse, delta][64]
  float* Ks = reinterpret_cast<float*>(smem_tc + kTcHead);   // [64][LD]
  float* Vs = Ks + kTile * LD;                               // [64][LD]
  float* qd = Vs + kTile * LD;   // stage st: Q [64][LD] at + 2 st 64 LD, dO after it
  auto bar = [&](int i) { return smem_u32(bars + i); };

  const int k0 = blockIdx.x * kTile, hk = blockIdx.y, b = blockIdx.z;
  const int group = a.H / a.Hkv;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  int qa, qb;
  q_tiles(k0, a, qa, qb);
  const int nq = max(0, qb - qa);
  const int n_it = group * nq;   // step it: head hk group + it / nq, query tile qa + it % nq
  // Q, dO and the lse and delta rows of step it into its stage
  auto load_step = [&](int it) {
    const int st = it & 1, h = hk * group + it / nq, q0 = (qa + it % nq) * kTile;
    float* qs = qd + 2 * st * kTile * LD;
    stage_tile<D>(qs, q + b * a.q.b + h * a.q.h, a.q.s, q0, a.S);
    stage_tile<D>(qs + kTile * LD, dO + b * a.dO.b + h * a.dO.h, a.dO.s, q0, a.S);
    if (threadIdx.x < 2 * kTile) {   // lse by threads 0-63, delta by 64-127
      const int i = threadIdx.x & (kTile - 1);
      const bool ok = q0 + i < a.S;
      const float* src = (threadIdx.x < kTile ? lse : delta) + row_at(a, b, h, q0);
      cp_async4(smem_u32(rows + 2 * st * kTile + threadIdx.x), src + (ok ? i : 0),
                ok ? 4u : 0u);
    }
    cp_async_arrive(bar(kFullStage + st));
  };

  if (threadIdx.x == 0) {
    for (int i = 0; i < 3; ++i) mbar_init(bar(i), kTcThreads);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  stage_tile<D>(Ks, k + b * a.k.b + hk * a.k.h, a.k.s, k0, a.T);
  stage_tile<D>(Vs, v + b * a.v.b + hk * a.v.h, a.v.s, k0, a.T);
  cp_async_arrive(bar(kFullHeld));
  for (int it = 0; it < min(2, n_it); ++it) load_step(it);

  // KV rows key0 and key1 of the tile in this thread
  const int g = lane >> 2, t = lane & 3;
  const int r0 = 16 * (warp & 3), c0 = kHalf * (warp >> 2);
  const int key0 = k0 + r0 + g, key1 = key0 + 8;

  float dk_acc[NO][4], dv_acc[NO][4];
#pragma unroll
  for (int nt = 0; nt < NO; ++nt)
#pragma unroll
    for (int r = 0; r < 4; ++r) dk_acc[nt][r] = dv_acc[nt][r] = 0.f;

  const float* ks = Ks + r0 * LD;
  const float* vs = Vs + r0 * LD;
  mbar_wait(bar(kFullHeld), 0);
  for (int it = 0; it < n_it; ++it) {
    const int st = it & 1;
    const int q0 = (qa + it % nq) * kTile + c0;           // the warp's first query
    const float* qs = qd + (2 * st * kTile + c0) * LD;    // its 32 rows of Q
    const float* dos = qs + kTile * LD;                   // and of dO
    const float* lse_r = rows + 2 * st * kTile + c0;      // their lse
    const float* delta_r = lse_r + kTile;                 // and delta
    mbar_wait(bar(kFullStage + st), (it >> 1) & 1);
    // causal without a prefix, queries wholly before the warp's first key
    if (!(a.causal && a.prefix_len == 0 && q0 + kHalf - 1 < k0 + r0)) {
      float s[4][4], dp[4][4];
      score_tf32<D>(s, ks, qs);     // S^T = K Q^T
      score_tf32<D>(dp, vs, dos);   // dP^T = V dO^T
      // P^T = exp(S^T scale - lse) where the query (column) sees the key
      // (row), else 0, left in s; dS^T = P^T (dP^T - delta), left in dp
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = 8 * nt + 2 * t + (e & 1);
          const int qpos = q0 + c;
          const bool seen = qpos < a.S && visible(e >= 2 ? key1 : key0, qpos, a.T, a.causal,
                                                  a.window, a.prefix_len);
          const float p = seen ? expf(s[nt][e] * a.scale - lse_r[c]) : 0.f;
          s[nt][e] = p;
          dp[nt][e] = seen ? p * (dp[nt][e] - delta_r[c]) : 0.f;
        }
      grad_tf32<D>(dv_acc, s, dos);   // dV += P^T dO
      grad_tf32<D>(dk_acc, dp, qs);   // dK += dS^T Q
    }
    __syncthreads();   // every warp is done with stage st
    if (it + 2 < n_it) load_step(it + 2);
  }

  // warps 4-7's sums into stage 0, then warps 0-3 add them and write the rows
  if (warp >= 4) {
    stash<NO>(dk_acc, qd);
    stash<NO>(dv_acc, qd + kTile * LD);
  }
  __syncthreads();
  if (warp < 4) {
    add_stash<NO>(dk_acc, qd);
    add_stash<NO>(dv_acc, qd + kTile * LD);
    write_acc<NO>(dk + b * a.dk.b + hk * a.dk.h, a.dk.s, k0 + r0, a.T, dk_acc, a.scale);
    write_acc<NO>(dv + b * a.dv.b + hk * a.dv.h, a.dv.s, k0 + r0, a.T, dv_acc, 1.f);
  }
}

template <int D>
int launch_tf32(const void* q, const void* k, const void* v, const void* o, const void* dO,
                void* dq, void* dk, void* dv, const float* lse, float* delta, int B,
                const Args& a, cudaStream_t stream) {
  constexpr int smem = tc_smem<D>();
  cudaError_t err = cudaFuncSetAttribute(flash_prefill_bwd_dq_tf32<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(flash_prefill_bwd_dkdv_tf32<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_qt = (a.S + kTile - 1) / kTile, n_kt = (a.T + kTile - 1) / kTile;
  const float* qt = static_cast<const float*>(q);
  const float* kt = static_cast<const float*>(k);
  const float* vt = static_cast<const float*>(v);
  const float* dOt = static_cast<const float*>(dO);
  flash_prefill_bwd_dq_tf32<D><<<dim3(n_qt, a.H, B), kTcThreads, smem, stream>>>(
      qt, kt, vt, static_cast<const float*>(o), dOt, lse, delta, static_cast<float*>(dq), a);
  flash_prefill_bwd_dkdv_tf32<D><<<dim3(n_kt, a.Hkv, B), kTcThreads, smem, stream>>>(
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
// tensors (the wgmma kernels), 0 for float32 (the 3xTF32 kernels). Returns
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
    if (D == 128) return launch_tf32<128>(REPRO_BWD_ARGS);
    if (D == 96) return launch_tf32<96>(REPRO_BWD_ARGS);
    if (D == 80) return launch_tf32<80>(REPRO_BWD_ARGS);
    if (D == 64) return launch_tf32<64>(REPRO_BWD_ARGS);
  }
#undef REPRO_BWD_ARGS
  return static_cast<int>(cudaErrorInvalidValue);
}
