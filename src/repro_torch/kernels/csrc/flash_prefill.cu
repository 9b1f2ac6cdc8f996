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
// * fp32, flash_prefill_kernel_fma<D>: both products as fp32 FMAs out of
//   padded shared memory (tensor cores would round fp32 to TF32). Each thread
//   keeps a 4x4 tile of scores and a 4 x D/16 tile of the output in
//   registers (for D = 96: four columns of the first 64 and two of the last
//   32; for D = 80 four and one of the last 16); one tile in flight; 118 KB
//   of shared memory at D = 128.
//
// What still holds the bf16 kernel back: within a step the softmax waits for
// Q K^T and the stage's release waits for P V, one consumer warpgroup a
// block; the output is written from registers with 4-byte stores. Two things
// tried on the H100 were slower and are not in: letting step i's P V run
// during step i+1's softmax with K and V on separate barriers (FA3's
// intra-warpgroup overlap), and masking only the tiles on the diagonal.
//
// Plain C interface: flash_prefill_launch() launches the kernel that its
// is_bf16 argument names and returns cudaGetLastError().

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_mask.cuh"   // visible() and kv_range(), shared with the backward

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

// =============================================================== fp32, FMA
constexpr int kFmaThreads = 256;  // 16 x 16 threads, each 4 rows x 4 columns
constexpr int kPad = 4;           // floats of padding per shared-memory row

// Stage rows [row0, row0 + 64) of a (rows, D) matrix with row stride
// `stride` (elements) into dst[64][D + kPad]; rows >= n_rows are zero.
template <int D>
__device__ __forceinline__ void stage_tile(float* dst, const float* src, int64_t stride,
                                           int row0, int n_rows) {
  constexpr int VPR = D / 4;              // 16-byte loads per row
  constexpr int DP = D + kPad;
  for (int idx = threadIdx.x; idx < 64 * VPR; idx += kFmaThreads) {
    const int r = idx / VPR;
    const int c = (idx % VPR) * 4;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < n_rows) val = *reinterpret_cast<const float4*>(src + (row0 + r) * stride + c);
    *reinterpret_cast<float4*>(dst + r * DP + c) = val;
  }
}

// grid (ceil(S / 64), H, B). Query row i sits at absolute position
// q_offset + i and, when causal, sees KV rows 0 .. q_offset + i.
template <int D>
__global__ void __launch_bounds__(kFmaThreads)
flash_prefill_kernel_fma(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, float* __restrict__ o, int Hkv,
                         int S, int Tkv, int q_offset, int causal, int window,
                         int prefix_len, Strides st, float scale) {
  constexpr int DP = D + kPad;            // padded row of Q/K/V tiles
  constexpr int PP = kBK + kPad;          // padded row of the probability tile
  constexpr int NC = D / 64;              // float4 column groups per thread
  constexpr int REM = (D % 64) / 16;      // columns per thread past those groups
  constexpr int NA = 4 * NC + REM;        // output columns per thread
  static_assert(D % 16 == 0, "head_dim must be a multiple of 16");

  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;                       // [kBQ][DP]
  float* Ks = Qs + kBQ * DP;              // [kBK][DP]
  float* Vs = Ks + kBK * DP;              // [kBK][DP]
  float* Ps = Vs + kBK * DP;              // [kBQ][PP]

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (gridDim.y / Hkv);
  const int tx = threadIdx.x & 15;        // columns tx + 16 j
  const int ty = threadIdx.x >> 4;        // rows ty + 16 i

  const float* qb = q + b * st.q_b + h * st.q_h;
  const float* kb = k + b * st.k_b + hk * st.k_h;
  const float* vb = v + b * st.v_b + hk * st.v_h;

  stage_tile<D>(Qs, qb, st.q_s, q0, S);

  float m[4], l[4], acc[4][NA];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NA; ++c) acc[i][c] = 0.f;
  }

  int kv_lo, kv_end;
  kv_range(q0, S, Tkv, q_offset, causal, window, prefix_len, kv_lo, kv_end);

  for (int k0 = kv_lo; k0 < kv_end; k0 += kBK) {
    stage_tile<D>(Ks, kb, st.k_s, k0, Tkv);
    stage_tile<D>(Vs, vb, st.v_s, k0, Tkv);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 qa[4], ka[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qa[i] = *reinterpret_cast<const float4*>(Qs + (ty + 16 * i) * DP + d);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        ka[j] = *reinterpret_cast<const float4*>(Ks + (tx + 16 * j) * DP + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          s[i][j] += qa[i].x * ka[j].x + qa[i].y * ka[j].y + qa[i].z * ka[j].z +
                     qa[i].w * ka[j].w;
    }

    // a row's 64 scores sit in the 16 lanes that share ty
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q_offset + q0 + ty + 16 * i;
      float rmax = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx + 16 * j;
        const bool seen = visible(col, qpos, Tkv, causal, window, prefix_len);
        s[i][j] = seen ? s[i][j] * scale : kNegInf;
        rmax = fmaxf(rmax, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rmax = fmaxf(rmax, __shfl_xor_sync(0xffffffffu, rmax, off));
      const float m_new = fmaxf(m[i], rmax);
      const float alpha = expf(m[i] - m_new);
      float rsum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);   // 0 for a masked column
        Ps[(ty + 16 * i) * PP + tx + 16 * j] = p;
        rsum += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rsum += __shfl_xor_sync(0xffffffffu, rsum, off);
      // a row whose window starts past this tile sees nothing in it: its
      // weights here are exp(0) = 1, wiped by alpha = 0 at its first seen key
      m[i] = m_new;
      l[i] = l[i] * alpha + rsum;
#pragma unroll
      for (int c = 0; c < NA; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

#pragma unroll 2
    for (int kk = 0; kk < kBK; kk += 4) {
      float pa[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 p4 = *reinterpret_cast<const float4*>(Ps + (ty + 16 * i) * PP + kk);
        pa[i][0] = p4.x;
        pa[i][1] = p4.y;
        pa[i][2] = p4.z;
        pa[i][3] = p4.w;
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
#pragma unroll
        for (int g = 0; g < NC; ++g) {
          const float4 vv =
              *reinterpret_cast<const float4*>(Vs + (kk + u) * DP + 64 * g + 4 * tx);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            acc[i][4 * g + 0] += pa[i][u] * vv.x;
            acc[i][4 * g + 1] += pa[i][u] * vv.y;
            acc[i][4 * g + 2] += pa[i][u] * vv.z;
            acc[i][4 * g + 3] += pa[i][u] * vv.w;
          }
        }
#pragma unroll
        for (int r = 0; r < REM; ++r) {
          const float vv = Vs[(kk + u) * DP + 64 * NC + REM * tx + r];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][4 * NC + r] += pa[i][u] * vv;
        }
      }
    }
    __syncthreads();   // the next step overwrites Ks, Vs and Ps
  }

  float* ob = o + b * st.o_b + h * st.o_h;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= S) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int g = 0; g < NC; ++g)
      *reinterpret_cast<float4*>(ob + row * st.o_s + 64 * g + 4 * tx) =
          make_float4(acc[i][4 * g + 0] * inv, acc[i][4 * g + 1] * inv,
                      acc[i][4 * g + 2] * inv, acc[i][4 * g + 3] * inv);
#pragma unroll
    for (int r = 0; r < REM; ++r)
      ob[row * st.o_s + 64 * NC + REM * tx + r] = acc[i][4 * NC + r] * inv;
  }
}

template <int D>
cudaError_t launch_fma(const void* q, const void* k, const void* v, void* o, int B,
                       int H, int Hkv, int S, int Tkv, int q_offset, int causal,
                       int window, int prefix_len, const Strides& st, float scale,
                       cudaStream_t stream) {
  constexpr size_t smem =
      sizeof(float) * (3 * 64 * (D + kPad) + kBQ * (kBK + kPad));
  cudaError_t err = cudaFuncSetAttribute(flash_prefill_kernel_fma<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((S + kBQ - 1) / kBQ, H, B);
  flash_prefill_kernel_fma<D><<<grid, kFmaThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), Hkv, S, Tkv, q_offset,
      causal, window, prefix_len, st, scale);
  return cudaGetLastError();
}

// ============================================================ bf16, wgmma
constexpr int kWgThreads = 160;   // one consumer warpgroup + one producer warp
constexpr int kBox = 64 * 64 * 2; // bytes of one 64-row x 64-column bf16 box

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile(
      "{\n.reg .b64 state;\n"
      "mbarrier.arrive.shared::cta.b64 state, [%0];\n}\n" ::"r"(bar)
      : "memory");
}

// Returns once the phase of parity `parity` of the barrier has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// One 64 x 64 box of a 4-D (D, rows, heads, batch) tensor map into shared
// memory, completed on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3),
      "r"(bar)
      : "memory");
}

// wgmma shared-memory descriptor of a 128-byte-swizzled operand whose groups
// of 8 rows of 128 bytes lie 1024 bytes apart: K-major (Q, K) or, with the
// transpose bit, MN-major (V). The leading offset is unused for both.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  uint64_t d = static_cast<uint64_t>((addr & 0x3FFFF) >> 4);
  d |= static_cast<uint64_t>(1) << 16;             // leading byte offset (unused)
  d |= static_cast<uint64_t>(1024 >> 4) << 32;     // stride byte offset
  d |= static_cast<uint64_t>(1) << 62;             // layout: 128-byte swizzle
  return d;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keeps the compiler from moving register reads or writes across the
// asynchronous products
__device__ __forceinline__ void fence_regs(float (&r)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

#define REPRO_WG_D32                                                                 \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),            \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),      \
      "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),  \
      "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),  \
      "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),  \
      "+f"(d[30]), "+f"(d[31])
#define REPRO_WG_REGS32                                                              \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "          \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"

// d (64 x 64, fp32) = or += A (64 x 16) B (16 x 64), both K-major in shared memory
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da, uint64_t db,
                                         int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " REPRO_WG_REGS32
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : REPRO_WG_D32
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x 64, fp32) += A (64 x 16, bf16 in registers) B (16 x 64), B MN-major
// in shared memory (transpose bit set)
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " REPRO_WG_REGS32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : REPRO_WG_D32
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
#undef REPRO_WG_D32
#undef REPRO_WG_REGS32

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);   // lo in the low half
  return *reinterpret_cast<const uint32_t*>(&v);
}

// grid (H, ceil(S / 64), B), 160 threads: the blocks of the longest tiles
// (the last rows, which see the most KV tiles) come first in launch order and
// so get an SM each before the short ones double up. Query row i sits at
// absolute position q_offset + i and, when causal, sees KV rows
// 0 .. q_offset + i, cut by the window and widened by the prefix (`visible`).
// A row is D columns in ceil(D / 64) boxes of 64. Accumulator fragment of
// thread (warp w, lane l): register j holds row 16 w + l/4 + 8 ((j/2) % 2),
// column 8 (j/4) + 2 (l%4) + j%2. MASKS = 0: causal or full attention only
// (window and prefix_len 0); 1: the general mask of `visible`.
template <int D, int MASKS>
__global__ void __launch_bounds__(kWgThreads, 2)
flash_prefill_kernel_wgmma(const __grid_constant__ CUtensorMap tm_q,
                           const __grid_constant__ CUtensorMap tm_k,
                           const __grid_constant__ CUtensorMap tm_v,
                           __nv_bfloat16* __restrict__ o, int Hkv, int S, int Tkv,
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
    wgmma_wait_all();
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
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) pa[kk][r] = pack_bf16(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);
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
    wgmma_wait_all();
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

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, found through the runtime (no -lcuda)
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A (D, rows, heads, batch) bf16 map with element strides (row, head, batch),
// boxes of 64 x 64 x 1 x 1, 128-byte swizzle; out-of-bounds rows, and the
// columns past D of a box that reaches beyond it (D = 80, 96), read as 0.
CUresult encode_map(CUtensorMap* map, const void* base, int D, int rows, int heads,
                    int batch, int64_t s_row, int64_t s_head, int64_t s_batch) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return CUDA_ERROR_NOT_FOUND;
  // the coordinate of a dimension of extent 1 is always 0: any legal stride
  if (heads == 1) s_head = s_row;
  if (batch == 1) s_batch = s_row;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(s_row) * 2,
                                 static_cast<cuuint64_t>(s_head) * 2,
                                 static_cast<cuuint64_t>(s_batch) * 2};
  const cuuint32_t box[4] = {64, 64, 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims,
            strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

template <int D, int MASKS>
int launch_wgmma_as(const void* q, const void* k, const void* v, void* o, int B, int H,
                 int Hkv, int S, int Tkv, int q_offset, int causal, int window,
                 int prefix_len, const Strides& st, float scale, cudaStream_t stream) {
  CUtensorMap tm_q, tm_k, tm_v;
  CUresult res = encode_map(&tm_q, q, D, S, H, B, st.q_s, st.q_h, st.q_b);
  if (res == CUDA_SUCCESS) res = encode_map(&tm_k, k, D, Tkv, Hkv, B, st.k_s, st.k_h, st.k_b);
  if (res == CUDA_SUCCESS) res = encode_map(&tm_v, v, D, Tkv, Hkv, B, st.v_s, st.v_h, st.v_b);
  if (res != CUDA_SUCCESS) return -static_cast<int>(res);
  // Q + two K/V stages, and room to align the tiles to 1024 bytes
  constexpr int smem = 5 * ((D + 63) / 64) * kBox + 1024;
  const cudaError_t err = cudaFuncSetAttribute(flash_prefill_kernel_wgmma<D, MASKS>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(H, (S + kBQ - 1) / kBQ, B);
  flash_prefill_kernel_wgmma<D, MASKS><<<grid, kWgThreads, smem, stream>>>(
      tm_q, tm_k, tm_v, static_cast<__nv_bfloat16*>(o), Hkv, S, Tkv, q_offset, causal,
      window, prefix_len, st.o_b, st.o_h, st.o_s, scale * 1.4426950408889634f);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_wgmma(const void* q, const void* k, const void* v, void* o, int B, int H,
                 int Hkv, int S, int Tkv, int q_offset, int causal, int window,
                 int prefix_len, const Strides& st, float scale, cudaStream_t stream) {
  const bool masks = causal && (window > 0 || prefix_len > 0);
  return (masks ? launch_wgmma_as<D, 1> : launch_wgmma_as<D, 0>)(
      q, k, v, o, B, H, Hkv, S, Tkv, q_offset, causal, window, prefix_len, st, scale, stream);
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
// window (0 = none) and prefix_len (0 = none) act only when causal. is_bf16
// chooses the kernel: 1 the bf16 tensor-core kernel, 0 the fp32 FMA kernel.
// Returns cudaGetLastError() after the launch (0 = launched), minus the
// CUresult if a tensor map cannot be encoded, or cudaErrorInvalidValue for a
// head_dim the kernels do not take.
extern "C" int flash_prefill_launch(const void* q, const void* k, const void* v, void* o,
                                    int B, int H, int Hkv, int S, int Tkv, int D,
                                    int q_offset, int causal, int window, int prefix_len,
                                    int is_bf16, const long long* strides, float scale,
                                    void* stream) {
  const Strides st = unpack(strides);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define REPRO_FLASH_ARGS \
  q, k, v, o, B, H, Hkv, S, Tkv, q_offset, causal, window, prefix_len, st, scale, s
  if (is_bf16 && D == 128) return launch_wgmma<128>(REPRO_FLASH_ARGS);
  if (is_bf16 && D == 96) return launch_wgmma<96>(REPRO_FLASH_ARGS);
  if (is_bf16 && D == 80) return launch_wgmma<80>(REPRO_FLASH_ARGS);
  if (is_bf16 && D == 64) return launch_wgmma<64>(REPRO_FLASH_ARGS);
  if (!is_bf16 && D == 128) return static_cast<int>(launch_fma<128>(REPRO_FLASH_ARGS));
  if (!is_bf16 && D == 96) return static_cast<int>(launch_fma<96>(REPRO_FLASH_ARGS));
  if (!is_bf16 && D == 80) return static_cast<int>(launch_fma<80>(REPRO_FLASH_ARGS));
  if (!is_bf16 && D == 64) return static_cast<int>(launch_fma<64>(REPRO_FLASH_ARGS));
#undef REPRO_FLASH_ARGS
  return static_cast<int>(cudaErrorInvalidValue);
}
