// Causal (or full) GQA flash attention for prefill, for sm_90a.
//
// Replaces the TPU kernel src/repro/kernels/flash_prefill.py::_kernel (grid
// (batch, q_head, q_block, kv_block) with the kv_block axis sequential and the
// online-softmax state carried in VMEM scratch between grid steps). Here one
// thread block owns one (batch, head, tile of 64 query rows); the sequential
// kv_block axis is a loop inside the block up to the causal limit (KV tiles
// wholly above the diagonal are never visited), and the running max / sum /
// output accumulator stay in registers for the whole loop. Beyond the TPU
// kernel it takes what the serving path feeds it: a KV length
// T = q_offset + S (a prefix that is already cached), any S and T (ragged last
// tiles are masked here instead of asserted away), and strides for the batch,
// head and sequence axes, so (B, S, H, D) tensors need no transposed copy.
// It also takes the two masks the reference's attention adds to the causal one
// (src/repro/models/layers.py::attention_forward and _flash_attention_ref),
// which the TPU kernel leaves to jnp: a sliding window (a query at position p
// sees keys above p - window) and a bidirectional prefix (every query sees the
// first prefix_len keys, the VLM's vision tokens), in the reference's order:
// causal, &= window, |= prefix. The loop bounds follow the masks: with a
// prefix a tile's loop runs to at least prefix_len, and with a window and no
// prefix it starts at the first KV tile its first query row can see. The
// bf16 kernel takes the general mask only where a launch has a window or a
// prefix (template flag MASKS): on the H100 it made the plain causal path,
// which is latency-bound, 25 % slower (S = 341: 0.01228 ms against 0.0095).
//
// What bounds it: at the serving shape (S = T = 341, H = 32, Hkv = 8,
// D = 128, bf16) bytes, 2*(S+T)*D elements per KV head plus Q and O, 2.1 us at
// 3.35 TB/s, against 4*S*T*D/2 causal operations, 1.0 us at 989 TFLOP/s. Both
// are below what 192 tiles of up to six dependent 64 x 64 steps take, so the
// kernel is held by the latency of one tile's loop.
//
// Two kernels, chosen by dtype in the wrapper:
//
// * bf16, flash_prefill_kernel_wgmma<D>: both products on the tensor cores.
//   A block is one consumer warpgroup (warps 0-3, 64 query rows, 16 a warp)
//   and one producer warp (warp 4). The producer's first lane loads the Q
//   tile and then a ring of two K/V stages by TMA, each stage completed on a
//   "full" mbarrier and released by the consumers on an "empty" one, so the
//   next tile's loads run while the current one is computed. The tensor maps
//   are 4-D (D, S, H, B) with the caller's element strides, encoded on the
//   host for each call, so the strided (B, S, H, D) views are read in place;
//   rows past S or T are zero-filled by the TMA unit and masked. A D = 128 row
//   is 256 bytes, wider than the 128-byte swizzle span, so every tile is
//   stored as D/64 boxes of 64 rows x 64 columns, each with the 128-byte
//   swizzle that the wgmma descriptors declare (layout type 1, 1024 bytes
//   between groups of 8 rows). S = Q K^T is wgmma m64n64k16 with both operands
//   K-major in shared memory; the online softmax runs on the fp32 accumulator
//   in registers (exp2 with the scale folded in); P is converted to bf16 in
//   registers, where the accumulator's fragment layout is already wgmma's
//   A-operand layout, and O += P V is wgmma m64n64k16 per 64-column box with A
//   from registers and V read as an MN-major B operand through the
//   instruction's transpose bit (no transposed copy of V). Shared memory:
//   Q 16 KB + 2 x (K 16 KB + V 16 KB) at D = 128, so two blocks share an SM
//   and the 192 tiles of the serving shape are resident at once. The grid is
//   (H, q tiles, B) with the q-tile axis reversed, so the 32 longest tiles
//   launch first and take an SM each before short tiles double up. One query
//   head a block (the 4 heads of a GQA group read the same K/V tiles, the
//   later ones from L2).
//
//   head_dim 96 (phi3-mini) and 80 (zamba2's shared attention) are not
//   multiples of the 64-column box: their tiles are two boxes, as at
//   D = 128, and the tensor maps declare the real inner extent, so the TMA
//   unit fills the columns past D of the second box with zeros. Q K^T runs
//   only the D / 16 steps of real columns (6 or 5 of 8); P V runs both
//   64-column boxes (zeros in the accumulator's columns past D), and the
//   epilogue writes D columns.
//
// * fp32, flash_prefill_kernel_tf32<D, LSE>: both products on the tensor
//   cores in 3xTF32 (tf32_mma.cuh: each operand split into a TF32 hi and
//   lo, three mma.sync.m16n8k8 products, fp32 accumulators), which keeps
//   float32's precision (tests/test_torch_flash_tf32.py models it on the CPU
//   against float64); the fp32 trainer's forward, with LSE = 1. Every
//   product sums at most four k-steps on the tensor cores before a rounding
//   fp32 add (the output over all KV steps too): with whole sums in one
//   accumulator the card's truncating adds put the output's error against
//   float64 at 4.7x the plain float32 version's (D 96, prefix 130). wgmma is not
//   used: it takes a 32-bit operand K-major only, and V is read along its
//   rows. A block is four consumer warps (16 query rows each) and one
//   producer warp; the producer's lanes stage Q once, then K and V of each
//   KV step by cp.async into padded rows (D + 4 floats: conflict-free
//   fragment loads), each completed on a "full" mbarrier and released by the
//   consumers on an "empty" one. K and V have a buffer each, not a ring of
//   two K/V stages (that would be 169 KB at D = 128, one block an SM): K of
//   step i + 1 loads while step i's softmax and P V run, V while step i + 1's
//   Q K^T does. Q, K and V take 101,440 bytes at D = 128, so two blocks share
//   an SM and olmo-1b's training shape (B 8, H 16, S 128: 256 blocks) runs
//   in one wave on 132 SMs. P never leaves the registers: O += P V reads its
//   k axis in pair order (pair_k), where the accumulator fragment of S's
//   columns 8 kk .. 8 kk + 7 is already the A fragment of k-step kk, and V's
//   rows 8 kk + 2t and + 1 are its B fragment. The online softmax, m, l, the
//   output accumulator and the log-sum-exp stay fp32, natural exp and log
//   as in the plain version. Q's fragments are read and split again at
//   every KV step (a training tile sees at most two).
//   What bounds it at olmo-1b's training shape: bytes, Q, K, V and O once
//   and the log-sum-exp (33.6 MB, 10.0 us at 3.35 TB/s), against 0.81 GFLOP
//   of causal tile pairs, 4.9 us as 3xTF32 at 495 TFLOP/s (PERF.md).

// What still holds the bf16 kernel back: within a step the softmax waits for
// Q K^T and the stage's release waits for P V, one consumer warpgroup a
// block; the output is written from registers with 4-byte stores. Two things
// tried on the H100 were slower and are not in: letting step i's P V run
// during step i+1's softmax with K and V on separate barriers (FA3's
// intra-warpgroup overlap), and masking only the tiles on the diagonal.
//
// The log-sum-exp for the backward: given an lse buffer, each kernel also
// writes every real row's m + log(l) (natural log of the scaled scores; the
// bf16 kernel converts its base-2 m). It is a template flag (LSE), as MASKS
// is, so the serving instances (LSE = 0) compile as they did: no store, no
// register for it. Training's forward (FlashPrefill) launches LSE = 1.
//
// Plain C interface: flash_prefill_launch() launches the kernel that its
// is_bf16 argument names and returns cudaGetLastError().

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_hopper.cuh"   // TMA, mbarriers, wgmma; shared with the backward
#include "flash_mask.cuh"     // visible() and kv_range(), shared with the backward
#include "tf32_mma.cuh"       // 3xTF32 products on mma.sync, cp.async staging

namespace {

constexpr int kBQ = 64;        // query rows per block
constexpr int kBK = 64;        // KV rows per loop step
constexpr float kNegInf = -1e30f;

struct Strides {   // in elements; the D axis is contiguous
  int64_t q_b, q_h, q_s;
  int64_t k_b, k_h, k_s;
  int64_t v_b, v_h, v_s;
  int64_t o_b, o_h, o_s;
};

// ====================================================== fp32, 3xTF32 mma.sync
constexpr int kTfWarps = 4;                       // consumer warps, 16 query rows each
constexpr int kTfThreads = (kTfWarps + 1) * 32;   // and one producer warp

// Shared memory of the fp32 kernel: five mbarriers, then the Q, K and V
// tiles, 64 rows of D + 4 floats each (16 bytes of padding a row): 101,440
// bytes at D = 128, so two blocks share an SM.
template <int D>
constexpr int tf32_smem() {
  return 64 + 3 * 64 * (D + 4) * static_cast<int>(sizeof(float));
}

// grid (H, ceil(S / 64), B), 160 threads: consumer warps 0-3 (rows 16 w ..
// 16 w + 15 of the query tile), producer warp 4; the longest tiles first, as
// in the bf16 kernel. Query row i sits at absolute position q_offset + i and,
// when causal, sees KV rows 0 .. q_offset + i, cut by the window and widened
// by the prefix (`visible`). LSE = 1: also each row's log-sum-exp of its
// scaled, masked scores into lse (B, H, S), for the backward. Two blocks an
// SM (`, 2`): at most 204 registers a thread.
template <int D, int LSE>
__global__ void __launch_bounds__(kTfThreads, 2)
flash_prefill_kernel_tf32(const float* __restrict__ q, const float* __restrict__ k,
                          const float* __restrict__ v, float* __restrict__ o,
                          float* __restrict__ lse, int Hkv, int S, int Tkv, int q_offset,
                          int causal, int window, int prefix_len, Strides st, float scale) {
  static_assert(D % 16 == 0, "head_dim must be a multiple of 16");
  constexpr int LD = D + 4;                  // floats a row of the Q, K and V tiles
  constexpr int NO = D / 8;                  // 8-column tiles of the output
  constexpr int G = NO % 4 == 0 ? 4 : 2;     // of them, a group of P V's products
  extern __shared__ __align__(16) unsigned char smem_tf[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem_tf);
  float* Qs = reinterpret_cast<float*>(smem_tf + 64);   // [64][LD]
  float* Ks = Qs + kBQ * LD;                            // [64][LD]
  float* Vs = Ks + kBK * LD;                            // [64][LD]
  // "full" barriers of Q, K and V, completed by the producer's 32 lanes;
  // "empty" barriers of K and V, one arrival a consumer warp
  constexpr int kFullQ = 0, kFullK = 1, kFullV = 2, kEmptyK = 3, kEmptyV = 4;
  auto bar = [&](int i) { return smem_u32(bars + i); };

  const int h = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;
  const int b = blockIdx.z;
  const int hk = h / (gridDim.x / Hkv);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  int kv_lo, kv_end;
  kv_range(q0, S, Tkv, q_offset, causal, window, prefix_len, kv_lo, kv_end);
  const int t0 = kv_lo / kBK;             // the first KV tile; producer and
  const int n_tiles = (kv_end + kBK - 1) / kBK - t0;   // consumers agree on it

  if (threadIdx.x == 0) {
    for (int i = 0; i < 5; ++i) mbar_init(bar(i), i <= kFullV ? 32 : kTfWarps);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == kTfWarps) {   // ---- producer: Q, then K and V of each step
    cp_async_rows<kBQ, D, LD>(Qs, q + b * st.q_b + h * st.q_h + q0 * st.q_s, st.q_s, S - q0);
    cp_async_arrive(bar(kFullQ));
    const float* kb = k + b * st.k_b + hk * st.k_h;
    const float* vb = v + b * st.v_b + hk * st.v_h;
    for (int it = 0; it < n_tiles; ++it) {
      const int k0 = (t0 + it) * kBK;
      // K of step it + 1 loads while step it's softmax and P V run, V while
      // step it + 1's Q K^T does
      if (it > 0) mbar_wait(bar(kEmptyK), (it - 1) & 1);
      cp_async_rows<kBK, D, LD>(Ks, kb + k0 * st.k_s, st.k_s, Tkv - k0);
      cp_async_arrive(bar(kFullK));
      if (it > 0) mbar_wait(bar(kEmptyV), (it - 1) & 1);
      cp_async_rows<kBK, D, LD>(Vs, vb + k0 * st.v_s, st.v_s, Tkv - k0);
      cp_async_arrive(bar(kFullV));
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    return;
  }

  // ---- consumer warps: rows r0 + g and r0 + g + 8 of the tile in this thread
  const int g = lane >> 2, t = lane & 3;
  const int r0 = 16 * warp;
  const int qpos0 = q_offset + q0 + r0 + g;
  const int qpos1 = qpos0 + 8;
  const float* qs = Qs + r0 * LD;

  float acc[NO][4];
#pragma unroll
  for (int nt = 0; nt < NO; ++nt)
#pragma unroll
    for (int r = 0; r < 4; ++r) acc[nt][r] = 0.f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;   // l: this thread's share

  mbar_wait(bar(kFullQ), 0);
  for (int it = 0; it < n_tiles; ++it) {
    const uint32_t ph = it & 1;
    mbar_wait(bar(kFullK), ph);
    // S = Q K^T over D: 16 rows x 64 KV columns a warp, 8 tiles of 8, each
    // half of them summed four k-steps at a time with rounding fp32 adds
    // between (warp_mma_rounded)
    float s[8][4];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float sh[4][4];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int r = 0; r < 4; ++r) sh[nt][r] = 0.f;
      const float* kh = Ks + 32 * half * LD;
      warp_mma_rounded<4, D, false, false>(sh, [&](int m, int kk) { return qs[m * LD + kk]; },
                                           [&](int kk, int n) { return kh[n * LD + kk]; });
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int r = 0; r < 4; ++r) s[4 * half + nt][r] = sh[nt][r];
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(bar(kEmptyK));   // K may be loaded again

    // mask, then the online-softmax update; a row's 64 scores sit in the 4
    // lanes that share g. A row whose window starts past this tile sees
    // nothing in it: its weights here are exp(0) = 1, wiped by alpha = 0 at
    // its first seen key.
    const int k0 = (t0 + it) * kBK;
    float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = k0 + 8 * nt + 2 * t + e;
        s[nt][e] = visible(col, qpos0, Tkv, causal, window, prefix_len) ? s[nt][e] * scale
                                                                         : kNegInf;
        s[nt][2 + e] = visible(col, qpos1, Tkv, causal, window, prefix_len)
                           ? s[nt][2 + e] * scale
                           : kNegInf;
        mx0 = fmaxf(mx0, s[nt][e]);
        mx1 = fmaxf(mx1, s[nt][2 + e]);
      }
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float alpha0 = expf(m0 - mn0), alpha1 = expf(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        s[nt][e] = expf(s[nt][e] - mn0);           // 0 for a masked column
        s[nt][2 + e] = expf(s[nt][2 + e] - mn1);
        ps0 += s[nt][e];
        ps1 += s[nt][2 + e];
      }
    l0 = l0 * alpha0 + ps0;
    l1 = l1 * alpha1 + ps1;
#pragma unroll
    for (int nt = 0; nt < NO; ++nt) {
      acc[nt][0] *= alpha0;
      acc[nt][1] *= alpha0;
      acc[nt][2] *= alpha1;
      acc[nt][3] *= alpha1;
    }

    // O += P V with k in pair order (tf32_mma.cuh, pair_k): the accumulator
    // fragment of P's columns 8 kk .. 8 kk + 7 is the A fragment of k-step
    // kk as it stands, and V's rows 8 kk + 2t, + 1 are its B fragment. Each
    // group of G output tiles sums four k-steps at a time in fresh
    // accumulators, added to acc by rounding fp32 adds: acc itself carries
    // the sum over every KV step, which the tensor cores' truncating adds
    // would lose float32's precision over
    mbar_wait(bar(kFullV), ph);
#pragma unroll
    for (int n0 = 0; n0 < NO; n0 += G) {
#pragma unroll
      for (int k4 = 0; k4 < kBK / 8; k4 += 4) {
        float part[G][4];
#pragma unroll
        for (int j = 0; j < G; ++j)
#pragma unroll
          for (int r = 0; r < 4; ++r) part[j][r] = 0.f;
#pragma unroll
        for (int kk = k4; kk < k4 + 4; ++kk) {
          const float av[4] = {s[kk][0], s[kk][2], s[kk][1], s[kk][3]};
          const float* vr = Vs + (8 * kk + 2 * t) * LD + g;
          float bv[G][2];
#pragma unroll
          for (int j = 0; j < G; ++j) {
            bv[j][0] = vr[8 * (n0 + j)];
            bv[j][1] = vr[LD + 8 * (n0 + j)];
          }
          mma3_step<G, false, false>(part, 0, av, bv);
        }
#pragma unroll
        for (int j = 0; j < G; ++j)
#pragma unroll
          for (int r = 0; r < 4; ++r) acc[n0 + j][r] += part[j][r];
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(bar(kEmptyV));   // V may be loaded again
  }

#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float inv0 = 1.f / fmaxf(l0, 1e-30f), inv1 = 1.f / fmaxf(l1, 1e-30f);
  const int row0 = q0 + r0 + g, row1 = row0 + 8;
  if (LSE && t == 0) {
    float* lb = lse + (static_cast<int64_t>(b) * gridDim.x + h) * S;
    if (row0 < S) lb[row0] = m0 + logf(fmaxf(l0, 1e-30f));
    if (row1 < S) lb[row1] = m1 + logf(fmaxf(l1, 1e-30f));
  }
  float* ob = o + b * st.o_b + h * st.o_h;
#pragma unroll
  for (int nt = 0; nt < NO; ++nt) {
    const int col = 8 * nt + 2 * t;
    if (row0 < S)
      *reinterpret_cast<float2*>(ob + row0 * st.o_s + col) =
          make_float2(acc[nt][0] * inv0, acc[nt][1] * inv0);
    if (row1 < S)
      *reinterpret_cast<float2*>(ob + row1 * st.o_s + col) =
          make_float2(acc[nt][2] * inv1, acc[nt][3] * inv1);
  }
}

template <int D, int LSE>
cudaError_t launch_tf32_as(const void* q, const void* k, const void* v, void* o, float* lse,
                           int B, int H, int Hkv, int S, int Tkv, int q_offset, int causal,
                           int window, int prefix_len, const Strides& st, float scale,
                           cudaStream_t stream) {
  constexpr int smem = tf32_smem<D>();
  cudaError_t err = cudaFuncSetAttribute(flash_prefill_kernel_tf32<D, LSE>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(H, (S + kBQ - 1) / kBQ, B);
  flash_prefill_kernel_tf32<D, LSE><<<grid, kTfThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), lse, Hkv, S, Tkv, q_offset,
      causal, window, prefix_len, st, scale);
  return cudaGetLastError();
}

template <int D>
int launch_tf32(const void* q, const void* k, const void* v, void* o, float* lse, int B,
                int H, int Hkv, int S, int Tkv, int q_offset, int causal, int window,
                int prefix_len, const Strides& st, float scale, cudaStream_t stream) {
  return static_cast<int>((lse ? launch_tf32_as<D, 1> : launch_tf32_as<D, 0>)(
      q, k, v, o, lse, B, H, Hkv, S, Tkv, q_offset, causal, window, prefix_len, st, scale,
      stream));
}

// ============================================================ bf16, wgmma
constexpr int kWgThreads = 160;   // one consumer warpgroup + one producer warp

// grid (H, ceil(S / 64), B), 160 threads: the blocks of the longest tiles
// (the last rows, which see the most KV tiles) come first in launch order and
// so get an SM each before the short ones double up. Query row i sits at
// absolute position q_offset + i and, when causal, sees KV rows
// 0 .. q_offset + i, cut by the window and widened by the prefix (`visible`).
// A row is D columns in ceil(D / 64) boxes of 64. Accumulator fragment of
// thread (warp w, lane l): register j holds row 16 w + l/4 + 8 ((j/2) % 2),
// column 8 (j/4) + 2 (l%4) + j%2. MASKS = 0: causal or full attention only
// (window and prefix_len 0); 1: the general mask of `visible`. LSE = 1: also
// each row's log-sum-exp into lse (B, H, S), as the fp32 kernel's.
template <int D, int MASKS, int LSE>
__global__ void __launch_bounds__(kWgThreads, 2)
flash_prefill_kernel_wgmma(const __grid_constant__ CUtensorMap tm_q,
                           const __grid_constant__ CUtensorMap tm_k,
                           const __grid_constant__ CUtensorMap tm_v,
                           __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                           int Hkv, int S, int Tkv,
                           int q_offset, int causal, int window, int prefix_len,
                           int64_t o_b, int64_t o_h, int64_t o_s, float scale_log2) {
  static_assert(D % 16 == 0, "head_dim must be a multiple of 16");
  constexpr int NB = (D + 63) / 64;       // 64-column boxes per row, the last
                                          // zero-filled past D by the TMA unit
  constexpr int kTile = NB * kBox;        // bytes of one 64-row tile

  __shared__ __align__(8) uint64_t bars[5];   // q, full[2], empty[2]
  extern __shared__ __align__(16) uint8_t smem_raw[];
  // the 128-byte swizzle repeats every 1024 bytes: align the tiles to it
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_s = base;
  const uint32_t k_s = base + kTile;      // + stage * kTile
  const uint32_t v_s = base + 3 * kTile;  // + stage * kTile
  const uint32_t bar_q = smem_u32(&bars[0]);
  const uint32_t bar_full = smem_u32(&bars[1]);    // + 8 * stage
  const uint32_t bar_empty = smem_u32(&bars[3]);   // + 8 * stage

  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;
  const int h = blockIdx.x;
  const int b = blockIdx.z;
  const int hk = h / (gridDim.x / Hkv);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  int kv_lo, kv_end;
  kv_range(q0, S, Tkv, q_offset, causal, window, prefix_len, kv_lo, kv_end);
  const int t0 = kv_lo / kBK;             // the first KV tile; producer and
  const int n_tiles = (kv_end + kBK - 1) / kBK - t0;   // consumers agree on it

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int st = 0; st < 2; ++st) {
      mbar_init(bar_full + 8 * st, 1);
      mbar_init(bar_empty + 8 * st, 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 4) {   // ---- producer: one lane issues every load
    if (lane == 0) {
      mbar_expect_tx(bar_q, kTile);
      for (int nb = 0; nb < NB; ++nb)
        tma_load(q_s + nb * kBox, &tm_q, bar_q, 64 * nb, q0, h, b);
      for (int it = 0; it < n_tiles; ++it) {
        const int st = it & 1;
        if (it >= 2) mbar_wait(bar_empty + 8 * st, ((it >> 1) - 1) & 1);
        mbar_expect_tx(bar_full + 8 * st, 2 * kTile);
        for (int nb = 0; nb < NB; ++nb) {
          tma_load(k_s + st * kTile + nb * kBox, &tm_k, bar_full + 8 * st, 64 * nb,
                   (t0 + it) * kBK, hk, b);
          tma_load(v_s + st * kTile + nb * kBox, &tm_v, bar_full + 8 * st, 64 * nb,
                   (t0 + it) * kBK, hk, b);
        }
      }
    }
    return;
  }

  // ---- consumer warpgroup: rows r0 and r0 + 8 of the tile in this thread
  const int r0 = warp * 16 + (lane >> 2);
  const int cq = (lane & 3) * 2;
  const int qpos0 = q_offset + q0 + r0;
  const int qpos1 = qpos0 + 8;

  float acc[NB][32];
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int j = 0; j < 32; ++j) acc[nb][j] = 0.f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;   // l: this thread's share

  mbar_wait(bar_q, 0);
  for (int it = 0; it < n_tiles; ++it) {
    const int st = it & 1;
    mbar_wait(bar_full + 8 * st, (it >> 1) & 1);
    __syncwarp();                         // wgmma wants the warp converged

    // S = Q K^T over D / 16 steps of 16 columns (32 bytes inside a box); the
    // zero-filled columns past D are skipped
    float s[32];
#pragma unroll
    for (int j = 0; j < 32; ++j) s[j] = 0.f;
    fence_regs(s);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t off = (kk >> 2) * kBox + (kk & 3) * 32;
      wgmma_ss(s, sw128_desc(q_s + off), sw128_desc(k_s + st * kTile + off), kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);

    // mask, then the online-softmax update in base 2; a row's 64 scores sit
    // in the 4 lanes that share l/4. (Skipping the mask on tiles below the
    // diagonal made the kernel slower on the H100, so every tile is masked.)
    // A row whose window starts past this tile sees nothing in it: its
    // weights here are exp2(0) = 1, wiped by alpha = 0 at its first seen key.
    const int k0 = (t0 + it) * kBK;
    float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int col = k0 + (j >> 2) * 8 + cq + (j & 1);
      const bool second = (j & 2) != 0;
      const int qpos = second ? qpos1 : qpos0;
      const bool seen = MASKS ? visible(col, qpos, Tkv, causal, window, prefix_len)
                              : col < Tkv && (!causal || col <= qpos);
      s[j] = seen ? s[j] * scale_log2 : kNegInf;
      if (second) mx1 = fmaxf(mx1, s[j]);
      else mx0 = fmaxf(mx0, s[j]);
    }
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float alpha0 = exp2f(m0 - mn0), alpha1 = exp2f(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const bool second = (j & 2) != 0;
      const float p = exp2f(s[j] - (second ? mn1 : mn0));   // 0 when masked
      s[j] = p;
      if (second) ps1 += p;
      else ps0 += p;
    }
    l0 = l0 * alpha0 + ps0;
    l1 = l1 * alpha1 + ps1;
    // the accumulator fragment of columns 16 kk .. 16 kk + 15 is the A
    // fragment of step kk
    uint32_t pa[4][4];
    to_a_frags(s, pa);
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
#pragma unroll
      for (int j = 0; j < 32; ++j) acc[nb][j] *= (j & 2) ? alpha1 : alpha0;
      fence_regs(acc[nb]);
    }

    // O += P V: per 64-column box of V, 4 steps of 16 KV rows (2048 bytes)
    wgmma_fence();
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs(acc[nb], pa[kk], sw128_desc(v_s + st * kTile + nb * kBox + kk * 2048));
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) fence_regs(acc[nb]);
    mbar_arrive(bar_empty + 8 * st);      // this stage may be loaded again
  }

#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float inv0 = 1.f / fmaxf(l0, 1e-30f), inv1 = 1.f / fmaxf(l1, 1e-30f);
  const int row0 = q0 + r0, row1 = row0 + 8;
  if (LSE && (lane & 3) == 0) {
    // m is in base-2 units of the scaled scores: the backward's
    // exp(s scale - lse) wants natural ones
    constexpr float kLn2 = 0.6931471805599453f;
    float* lb = lse + (static_cast<int64_t>(b) * gridDim.x + h) * S;
    if (row0 < S) lb[row0] = m0 * kLn2 + logf(fmaxf(l0, 1e-30f));
    if (row1 < S) lb[row1] = m1 * kLn2 + logf(fmaxf(l1, 1e-30f));
  }
  __nv_bfloat16* ob = o + b * o_b + h * o_h;
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      if (64 * nb + 8 * i >= D) continue;   // the zero-filled columns past D
      const int col = 64 * nb + 8 * i + cq;
      if (row0 < S)
        *reinterpret_cast<uint32_t*>(ob + row0 * o_s + col) =
            pack_bf16(acc[nb][4 * i] * inv0, acc[nb][4 * i + 1] * inv0);
      if (row1 < S)
        *reinterpret_cast<uint32_t*>(ob + row1 * o_s + col) =
            pack_bf16(acc[nb][4 * i + 2] * inv1, acc[nb][4 * i + 3] * inv1);
    }
}

template <int D, int MASKS, int LSE>
int launch_wgmma_as(const void* q, const void* k, const void* v, void* o, float* lse,
                    int B, int H, int Hkv, int S, int Tkv, int q_offset, int causal,
                    int window, int prefix_len, const Strides& st, float scale,
                    cudaStream_t stream) {
  CUtensorMap tm_q, tm_k, tm_v;
  CUresult res = bind_context();
  if (res == CUDA_SUCCESS) res = encode_map(&tm_q, q, D, S, H, B, st.q_s, st.q_h, st.q_b);
  if (res == CUDA_SUCCESS) res = encode_map(&tm_k, k, D, Tkv, Hkv, B, st.k_s, st.k_h, st.k_b);
  if (res == CUDA_SUCCESS) res = encode_map(&tm_v, v, D, Tkv, Hkv, B, st.v_s, st.v_h, st.v_b);
  if (res != CUDA_SUCCESS) return -static_cast<int>(res);
  // Q + two K/V stages, and room to align the tiles to 1024 bytes
  constexpr int smem = 5 * ((D + 63) / 64) * kBox + 1024;
  const cudaError_t err = cudaFuncSetAttribute(flash_prefill_kernel_wgmma<D, MASKS, LSE>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(H, (S + kBQ - 1) / kBQ, B);
  flash_prefill_kernel_wgmma<D, MASKS, LSE><<<grid, kWgThreads, smem, stream>>>(
      tm_q, tm_k, tm_v, static_cast<__nv_bfloat16*>(o), lse, Hkv, S, Tkv, q_offset, causal,
      window, prefix_len, st.o_b, st.o_h, st.o_s, scale * 1.4426950408889634f);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_wgmma(const void* q, const void* k, const void* v, void* o, float* lse, int B,
                 int H, int Hkv, int S, int Tkv, int q_offset, int causal, int window,
                 int prefix_len, const Strides& st, float scale, cudaStream_t stream) {
  const bool masks = causal && (window > 0 || prefix_len > 0);
  auto fn = masks ? (lse ? launch_wgmma_as<D, 1, 1> : launch_wgmma_as<D, 1, 0>)
                  : (lse ? launch_wgmma_as<D, 0, 1> : launch_wgmma_as<D, 0, 0>);
  return fn(q, k, v, o, lse, B, H, Hkv, S, Tkv, q_offset, causal, window, prefix_len, st,
            scale, stream);
}

Strides unpack(const long long* s) {
  Strides st;
  st.q_b = s[0]; st.q_h = s[1]; st.q_s = s[2];
  st.k_b = s[3]; st.k_h = s[4]; st.k_s = s[5];
  st.v_b = s[6]; st.v_h = s[7]; st.v_s = s[8];
  st.o_b = s[9]; st.o_h = s[10]; st.o_s = s[11];
  return st;
}

}  // namespace

// strides: 12 element strides, (batch, head, sequence) of q, k, v, o in turn.
// lse: nullptr, or float32 (B, H, S), contiguous, for each row's log-sum-exp
// of its scaled, masked scores (natural log), which the backward reads.
// window (0 = none) and prefix_len (0 = none) act only when causal. is_bf16
// chooses the kernel: 1 the bf16 wgmma kernel, 0 the fp32 3xTF32 kernel.
// Returns cudaGetLastError() after the launch (0 = launched), minus the
// CUresult if a tensor map cannot be encoded, or cudaErrorInvalidValue for a
// head_dim the kernels do not take.
extern "C" int flash_prefill_launch(const void* q, const void* k, const void* v, void* o,
                                    float* lse, int B, int H, int Hkv, int S, int Tkv, int D,
                                    int q_offset, int causal, int window, int prefix_len,
                                    int is_bf16, const long long* strides, float scale,
                                    void* stream) {
  const Strides st = unpack(strides);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define REPRO_FLASH_ARGS \
  q, k, v, o, lse, B, H, Hkv, S, Tkv, q_offset, causal, window, prefix_len, st, scale, s
  if (is_bf16 && D == 128) return launch_wgmma<128>(REPRO_FLASH_ARGS);
  if (is_bf16 && D == 96) return launch_wgmma<96>(REPRO_FLASH_ARGS);
  if (is_bf16 && D == 80) return launch_wgmma<80>(REPRO_FLASH_ARGS);
  if (is_bf16 && D == 64) return launch_wgmma<64>(REPRO_FLASH_ARGS);
  if (!is_bf16 && D == 128) return launch_tf32<128>(REPRO_FLASH_ARGS);
  if (!is_bf16 && D == 96) return launch_tf32<96>(REPRO_FLASH_ARGS);
  if (!is_bf16 && D == 80) return launch_tf32<80>(REPRO_FLASH_ARGS);
  if (!is_bf16 && D == 64) return launch_tf32<64>(REPRO_FLASH_ARGS);
#undef REPRO_FLASH_ARGS
  return static_cast<int>(cudaErrorInvalidValue);
}
