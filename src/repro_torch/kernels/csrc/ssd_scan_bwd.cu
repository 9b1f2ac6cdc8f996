// Backward pass of the Mamba2 SSD chunked scan (csrc/ssd_scan.cu), for sm_90a.
//
// The TPU package has no Pallas backward for ssd_scan: it trains through
// jax.grad of the jnp oracle, src/repro/models/ssm.py:25 (ssd_chunked),
// which src/repro/models/ssm.py:183 reaches through kernels.ops.ssd_scan.
// This kernel stands in for that gradient. It computes what
// ssd_scan_backward_plain (kernels/ssd_scan.py) computes, by the same
// explicit formulas. Per chunk, with a_i the running sum of dt * A inside it,
// a_L its last value, L_ij = exp(a_i - a_j) for i >= j, S_ij = C_i . B_j,
// M_ij = dy_i . x_j, h the state entering the chunk and G the gradient of the
// state leaving it:
//
//   dx_j  = sum_{i>=j} S_ij L_ij dt_j dy_i + exp(a_L - a_j) dt_j G B_j
//   dB_j  = sum_{i>=j} M_ij L_ij dt_j C_i + exp(a_L - a_j) dt_j G^T x_j   (per head)
//   dC_i  = sum_{j<=i} M_ij L_ij dt_j B_j + exp(a_i) h^T dy_i            (per head)
//   G    <- exp(a_L) G + sum_i exp(a_i) dy_i C_i^T   (the entering state's gradient)
//   d(dt_j) = sum_{i>=j} S_ij L_ij M_ij + exp(a_L - a_j) x_j^T G B_j + A r_j
//   dA   += sum_j dt_j r_j,   r_j = sum_{k>=j} da_k (inside the chunk)
//
// where da_k, the gradient of a_k, collects sum_{j<=k} Q_kj dt_j - dt_k
// sum_{i>=k} Q_ik (Q = S o L o M), the carried state's exp(a_k) C_k . h^T dy_k,
// -dt_k x_k^T G B_k exp(a_L - a_k), and at the chunk's last step the terms of
// a_L. Every exponent is a difference (a_i - a_j, a_L - a_j) or a_i itself,
// all <= 0; the exponent of a pair i < j is never formed.
//
// Two kernels, chosen by the shape alone (the wrapper's backward_route, this
// launcher's tensor_cores argument; a launch of one is never retried on the
// other):
//
// * ssd_scan_bwd_tc<T, N>, for P 64, N 64 or 128, one chunk (16 <= S <=
//   chunk), no h0 and no final-state cotangent: every training call of
//   mamba2-1.3b and zamba2-2.7b at 16 <= s <= 256 (the intra-chunk terms above are then the whole
//   gradient). All five products run on the tensor cores: 6xTF32 for float32
//   inputs, 3xTF32 for bf16 ones, below.
// * ssd_scan_bwd_kernel<T, P, N, R>, fp32 FMAs, for every other shape (P 32,
//   N 16, more than one chunk, h0, dstate, fewer than 16 steps): the
//   carried-state terms.
//
// ---- The tensor-core kernel.
//
// * Split products. A TF32 rounding keeps about three digits, which is not
//   the float32 trainer's arithmetic. 3xTF32 splits each operand value v as
//   it is read into hi, v rounded to TF32 (to nearest, in two integer
//   operations), and lo = v - hi (exact in fp32, read by the tensor cores
//   truncated to TF32), and a product is a_lo b_hi + a_hi b_lo + a_hi b_hi
//   with fp32 accumulators (tests/test_torch_ssd_tf32.py models it on the
//   CPU against float64). A float32 call splits v in three exact TF32 pieces
//   and keeps six products (6xTF32, below: "Float32's precision"). A bf16
//   input is exact in TF32 (lo = 0): its lo terms are left out, so in a
//   bf16 call C B^T and dy x^T are one product and the others two.
// * The products are mma.sync.m16n8k8.tf32, not wgmma. wgmma takes a 32-bit
//   operand from shared memory K-major only (no transpose bit), and three of
//   the five products read an input transposed (dx += W^T dy reads dy^T, dB
//   += Z^T C reads C^T, dC += Z B reads B^T). With a hi and a lo copy of
//   every staged operand, wgmma would need four copies of B and C each
//   (128 KB at N 128) and left no room for the row blocks of x and dy.
//   mma.sync's fragments are loaded by the threads, in either orientation,
//   from one fp32 (or bf16) copy of each tile, and split in registers.
// * The heads share C B^T and the head sums of dB and dC. C B^T does not
//   depend on the head, and B and C are shared by the heads (one group), so
//   dB_j = sum_i (sum_h Z_ij^h) C_i and dC_i = sum_j (sum_h Z_ij^h) B_j: both
//   are one product of the head sum Zsum a tile pair, not one a head. A block
//   owns hg heads of one sequence (grid (ceil(H / hg), batch)); the wrapper
//   picks the fewest heads that fit the blocks into one wave of SMs, at most
//   kMaxHeads = 5 (mamba2-1.3b's training shape, 8 x 64 heads: 4, 128
//   blocks on 132 SMs; zamba2's 8 x 80: 5). The block computes S^T = B_J C_I^T
//   once a tile pair and keeps it in registers over its heads; per head it
//   computes M^T = x_J dy_I^T, forms W^T, Z^T and Q on the accumulators, and
//   adds W^T dy_I into dx_J (below); Zsum^T sums Z^T over the
//   heads in registers. The dB and dC partials are per block, (ceil(H /
//   hg), b, s, N), summed by the wrapper over their leading axis: 4-5x fewer
//   than one a head.
//   (A thread-block cluster of a sequence's head blocks, sharing S through
//   distributed shared memory, was the other route: a block that loops over
//   its heads needs no cross-block protocol, and the products of the head
//   sums need all of Zsum in one place anyway.)
// * Layout of a block: 8 consumer warps and 1 producer warp (288 threads).
//   Tiles are 64 x 64 tile pairs (I >= J, row blocks of 64); consumer warp w
//   owns rows 16 (w % 4) .. + 15 of a pair and columns 32 (w / 4) .. + 31,
//   so S^T, M^T, Zsum^T are 16 registers each. W^T goes through shared
//   memory between the two warps that
//   share its rows (a 64-thread named barrier); dx_J reads it whole. Zsum^T
//   goes through shared memory once a pair, between two barriers of the
//   consumers (bar 1), read by dB, then (C_I released, so that the next
//   pair's C loads meanwhile) by dC, transposed.
// * Float32's precision. Two faults of 3xTF32 on the tensor cores showed
//   against float64 on the card (PERF.md): the tensor cores add into an
//   accumulator with truncation, so a long sum in one accumulator errs
//   beyond float32 (C B^T over N 128 in one accumulator gave dx 20.4x the
//   plain float32 version's error at s = 1; four k-steps a partial still
//   4.6x), and a 3xTF32 product of one term is up to 2^-21 off (at s = 1
//   dC erred up to 31x, dx 22x, even one k-step a partial). So for float32
//   inputs every product is 6xTF32 (tf32_mma.cuh, mma6_step), each k-step
//   summed into a fresh accumulator and added to the running sum by a
//   rounding fp32 add (tc_mma -> warp_mma6). The running sums are taken in
//   float64: a, whose differences a_i - a_j are the exponents (in float32
//   their roundings were most of either the kernel's or the plain float32
//   version's error against float64, so the two were like noises and their
//   ratio had a long tail), and r, the reverse sum of da, with d(dt) and
//   dA from it (the da of a chunk cancel). The kernel's float32 error
//   against float64 is then a few hundredths of the plain version's at the
//   training shape. What is left is the truncation inside one k-step's sum
//   of eight products, a few roundings; in a chunk of fewer than 16 steps
//   the plain version's error is a few roundings too, and such calls go to
//   the FMA kernel (ssd_scan.TC_MIN_STEPS; PERF.md).
//   The partials take registers that dx_J's accumulators over the heads
//   (16 a head) had held, and the ninth warp caps a thread at 168: so a
//   float32 call adds each tile pair's rounded W^T dy_I straight into dx
//   (the row block's first pair stores, later ones add; the thread's own
//   elements, in pair order; L2 holds them between pairs), and no head's dx
//   lives in registers. A bf16 call keeps dx_J in registers over the pairs
//   and its products in one accumulator each (its inputs are exact in TF32
//   and its dx is rounded to bf16).
// * Staging: the producer warp issues cp.async for each tile in the order
//   the consumers use them (B_J; C_I; x_J and dy_I per head, two slots) and
//   completes them on "full" mbarriers (cp.async.mbarrier.arrive.noinc); the
//   consumers release each buffer on an "empty" mbarrier, so the next
//   head's x and dy load while this head computes. Tiles are row-major with
//   16 bytes of padding a row, which makes every fragment load conflict-
//   free. TMA was not used: its boxes are dense (no padding), and the
//   128-byte swizzle leaves the transposed fragment loads 2-way conflicted.
// * Shared memory at N 128, fp32: B_J and C_I 33.8 KB each, two x/dy slots
//   69.6 KB, W^T (two) and Zsum^T 52.2 KB, the per-head vectors (a in
//   float64, dt, da, d(dt)'s direct part) and Q's partial sums 33.3 KB:
//   222.8 KB, one block
//   an SM (the FMA kernel's 215 KB; R 32 would not buy a second block: the
//   x/dy slots and the per-head state dominate).
// * Deterministic: Q's row and column sums go through per-warp partials
//   reduced in a fixed order after the pair's barrier; dB and dC are stored
//   by the first pair of a row block and added to by the later ones (the
//   same thread, in pair order); no atomics.
// * Bound at mamba2-1.3b's training shape (b 8, s 128, h 64, fp32): the
//   function needs C B^T, dB's and dC's products once a sequence and dy x^T
//   and W^T dy once a head over the 8256 causal pairs: 1.13 GFLOP, 0.0169 ms
//   at the 67 TFLOP/s fp32 rate, 0.0069 ms as 3xTF32 (0.0137 ms as 6xTF32)
//   on the 495 TFLOP/s tensor cores, under the 0.0158 ms the 53 MB of inputs
//   and outputs take.
//   What holds it back (PERF.md, H100): not the products. Rounding hi with
//   integer operations instead of cvt.rna (and lo not at all) took 17 % off;
//   issuing a k-step's products accumulator by accumulator, 3 %; skipping
//   the masked half of the diagonal tile pairs (a seventh of the products)
//   moved it by -1 to +2 % and was left out. Each scheduler holds two
//   consumer warps (one block of 8 an SM, bound by shared memory), so the
//   latency of each fragment load, split and product chain, and of the pair
//   barriers, is exposed.
//
// ---- The FMA kernel (fp32 FMA arithmetic, fp32 accumulators; the input
// type T is float or bf16, converted to fp32 as it is staged):
//
// * One block per (head, batch) owns the whole of P and walks the chunks in
//   reverse, G in shared memory. Owning P lets the block finish d(dt) and its
//   head's share of dA itself (215 KB of shared memory at P 64, N 128, one
//   block an SM).
// * The states entering the chunks are recomputed first, by a forward sweep
//   over the chunks (the state in registers), into fp32 scratch (b, h,
//   chunks - 1, P, N) that the wrapper allocates; the serving forward kernel
//   is not touched.
// * A chunk is cut in row blocks of R = 64 (32 for chunk 32): C, B, x, dy
//   row blocks of up to 256 x 128 fp32 would not fit in 227 KB. Per chunk:
//   (A) for each row block I: dC_I's carried-state term exp(a_i) h^T dy_i is
//       written out, and exp(a_i) dy_i C_i^T is summed into the next G
//       (registers, then the shared buffer that held h);
//   (C) for each column block J (B_J, x_J held): dx_J and dB_J start from the
//       G terms, then for each row block I >= J the tiles S and M (4 x 4 a
//       thread), the weights W = S o L dt_j and Z = M o L dt_j (shared), the
//       row and column sums of Q for da and d(dt), and the products
//       dx_J += W^T dy_I, dB_J += Z^T C_I (registers, over I) and
//       dC_I += Z B_J (added to the block's own fp32 partial in device
//       memory: the same thread reads what it wrote, nothing is shared).
//   Then a reverse scan of da gives r, d(dt) and the block's dA.
// * Zero work is skipped: the terms in h while the state is zero (the first
//   chunk without h0), the terms in G while G is zero (the last chunk without
//   a final-state cotangent), and the entering state's gradient where no one
//   reads it (the first chunk without h0).
// * No atomics, so the same inputs give the same bits. dB and dC are sums
//   over the heads, dA over the batch: each block writes its own fp32
//   partials (dB and dC (h, b, s, N), dA (b, h)) and the wrapper sums them
//   over h and over b. Every in-block sum (rows by warp shuffles, columns
//   through a small shared buffer, the scans and the block sums) runs in a
//   fixed order.
// * Its time at mamba2-1.3b's training shape, when that shape ran on it
//   (PERF.md): 0.4277 ms, 8.8x the 0.04871 ms the per-head products it does
//   would take at the fp32 rate: C B^T recomputed by every head's block, one
//   block of 8 warps an SM with a barrier per tile, and FMAs.
//
// Both kernels read x, B, C, dt and dy through their strides (x, B and C as
// views of mamba_forward's conv output, no copy; the last axis contiguous);
// h0, dstate and every output are contiguous. Ragged S: steps past S of the
// last chunk are masked (dt = 0, no input, no store), which is the plain
// version's padding.
//
// Plain C interface: ssd_scan_bwd_launch() launches the kernel and instance
// for the route, input type, P, N and chunk and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_hopper.cuh"   // mbarriers; bind_context() (cuda_context.cuh)
#include "tf32_mma.cuh"       // the split products (warp_mma, warp_mma6), cp.async staging

namespace {

constexpr int kThreads = 256;   // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kPad = 4;         // floats of padding per shared-memory row
constexpr int kMaxChunk = 256;
constexpr int kColGroups = kThreads / 16;   // thread rows of the S and M tiles

struct Strides {   // in elements; the last axis of each is contiguous
  int64_t x_b, x_s, x_h;
  int64_t dt_b, dt_s, dt_h;
  int64_t b_b, b_s;
  int64_t c_b, c_s;
  int64_t dy_b, dy_s, dy_h;
};

__device__ __forceinline__ float4 zero4() { return make_float4(0.f, 0.f, 0.f, 0.f); }

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

__device__ __forceinline__ void store4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, const float (&v)[4]) {
  uint2 u;
  *reinterpret_cast<__nv_bfloat162*>(&u.x) = __floats2bfloat162_rn(v[0], v[1]);
  *reinterpret_cast<__nv_bfloat162*>(&u.y) = __floats2bfloat162_rn(v[2], v[3]);
  *reinterpret_cast<uint2*>(p) = u;
}

__device__ __forceinline__ float dot4(const float4& a, const float4& b) {
  return a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
}

__device__ __forceinline__ float at(const float4& v, int q) {
  return q == 0 ? v.x : q == 1 ? v.y : q == 2 ? v.z : v.w;
}

// Stage rows [0, R) of a (rows, W) matrix whose row r starts at src + r *
// stride (elements; W contiguous) into dst[R][W + kPad] as fp32; rows >=
// n_rows are zero.
template <int W, int R, typename T>
__device__ __forceinline__ void stage_rows(float* dst, const T* src, int64_t stride,
                                           int n_rows) {
  constexpr int VPR = W / 4;
  constexpr int LD = W + kPad;
  for (int idx = threadIdx.x; idx < R * VPR; idx += kThreads) {
    const int r = idx / VPR;
    const int c = (idx % VPR) * 4;
    float4 v = zero4();
    if (r < n_rows) v = load4(src + r * stride + c);
    *reinterpret_cast<float4*>(dst + r * LD + c) = v;
  }
}

// A contiguous (P, N) fp32 matrix into dst[P][N + kPad], or zeros.
template <int P, int N>
__device__ __forceinline__ void stage_state(float* dst, const float* src) {
  constexpr int VPR = N / 4;
  for (int idx = threadIdx.x; idx < P * VPR; idx += kThreads) {
    const int r = idx / VPR;
    const int c = (idx % VPR) * 4;
    const float4 v = src != nullptr ? load4(src + r * N + c) : zero4();
    *reinterpret_cast<float4*>(dst + r * (N + kPad) + c) = v;
  }
}

// The thread layout of a (ROWS, COLS) product: each thread owns 4 adjacent
// columns (4 tx .. 4 tx + 3) of the rows ty + TY r, r < RPT (rows >= ROWS
// idle). The TX threads of a row are adjacent lanes of one warp.
template <int ROWS, int COLS>
struct Layout {
  static constexpr int TX = COLS / 4;
  static constexpr int TY = kThreads / TX;
  static constexpr int RPT = (ROWS + TY - 1) / TY;
  static_assert(TX <= 32 && 32 % TX == 0, "a row's threads must share a warp");
};

// Sum of v over the TX adjacent lanes that share a row, in a fixed order.
template <int TX>
__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int off = 1; off < TX; off <<= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Sum of v over the block, in a fixed order; every thread gets it.
__device__ __forceinline__ float block_sum(float v, float* red) {
  v = row_sum<32>(v);
  __syncthreads();   // earlier readers of red are done
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float t = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) t += red[w];
  return t;
}

// Inclusive scan of v over the threads in order (thread 0 first).
__device__ __forceinline__ float block_scan(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float u = __shfl_up_sync(0xffffffffu, v, off);
    if (lane >= off) v += u;
  }
  __syncthreads();   // earlier readers of red are done
  if (lane == 31) red[warp] = v;
  __syncthreads();
  for (int w = 0; w < warp; ++w) v += red[w];
  return v;
}

template <int P, int N, int R>
constexpr size_t smem_floats() {
  return 2 * R * (N + kPad)          // C and B row blocks
         + 2 * P * (N + kPad)        // G, and h (then the next G)
         + 2 * R * (P + kPad)        // x and dy row blocks
         + 2 * R * (R + kPad)        // W and Z of one (I, J) tile pair
         + kColGroups * R            // column partials of Q
         + 6 * kMaxChunk             // dt, a, da, direct d(dt), dt g, fin
         + 2 * kWarps;               // block sums and scans
}

// grid (H, batch). h0, dstate, dh0 and scratch are contiguous fp32; h0 and
// dstate may be null (zero), and then so may dh0 (no gradient asked).
// dx (b, S, H, P) in T, ddt (b, S, H), dB and dC partials (H, b, S, N), dA
// partial (b, H): contiguous, fp32 but dx.
template <typename T, int P, int N, int R>
__global__ void __launch_bounds__(kThreads, 1)
ssd_scan_bwd_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                    const float* __restrict__ A, const T* __restrict__ Bm,
                    const T* __restrict__ Cm, const float* __restrict__ h0,
                    const T* __restrict__ dy, const float* __restrict__ dstate,
                    T* __restrict__ dx, float* __restrict__ ddt,
                    float* __restrict__ dA_part, float* __restrict__ dB_part,
                    float* dC_part, float* __restrict__ dh0, float* scratch, int S,
                    int H, int chunk, Strides st) {
  constexpr int NP = N + kPad;
  constexpr int XP = P + kPad;
  constexpr int WP = R + kPad;
  constexpr int SI = R / 16;                 // S and M tile rows (and columns) a thread
  using LS = Layout<P, N>;                   // the state, G
  using LX = Layout<R, P>;                   // dx_J
  using LN = Layout<R, N>;                   // dB_J, dC_I

  extern __shared__ __align__(16) float smem[];
  float* Cs = smem;                          // [R][NP]
  float* Bs = Cs + R * NP;                   // [R][NP]
  float* Gs = Bs + R * NP;                   // [P][NP] gradient of the state leaving
  float* Hs = Gs + P * NP;                   // [P][NP] state entering; then the next G
  float* Xs = Hs + P * NP;                   // [R][XP]
  float* Ds = Xs + R * XP;                   // [R][XP] dy
  float* Ws = Ds + R * XP;                   // [R][WP]
  float* Zs = Ws + R * WP;                   // [R][WP]
  float* colbuf = Zs + R * WP;               // [kColGroups][R]
  float* dts = colbuf + kColGroups * R;      // [kMaxChunk] dt
  float* cum = dts + kMaxChunk;              // [kMaxChunk] a
  float* da = cum + kMaxChunk;               // [kMaxChunk] gradient of a
  float* ddd = da + kMaxChunk;               // [kMaxChunk] direct part of d(dt)
  float* gdt = ddd + kMaxChunk;              // [kMaxChunk] dt_j g_j
  float* fin = gdt + kMaxChunk;              // [kMaxChunk] exp(a_L - a_j) dt_j
  float* red_sum = fin + kMaxChunk;          // [kWarps]
  float* red_scan = red_sum + kWarps;        // [kWarps]

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const float a_h = A[h];
  const int n_chunks = (S + chunk - 1) / chunk;

  const T* xb = x + b * st.x_b + h * st.x_h;
  const float* dtb = dt + b * st.dt_b + h * st.dt_h;
  const T* Bb = Bm + b * st.b_b;
  const T* Cb = Cm + b * st.c_b;
  const T* dyb = dy + b * st.dy_b + h * st.dy_h;
  const int64_t out_row = static_cast<int64_t>(b) * S;   // first (b, s) row
  T* dxb = dx + (out_row * H + h) * P;                   // row stride H P
  // the head's (S, N) slab of the (H, batch, S, N) partials, row stride N
  float* dBb = dB_part + (static_cast<int64_t>(h) * gridDim.y + b) * S * N;
  float* dCb = dC_part + (static_cast<int64_t>(h) * gridDim.y + b) * S * N;
  float* ddtb = ddt + out_row * H + h;                   // row stride H
  const size_t bh = static_cast<size_t>(b) * H + h;
  const size_t PN = static_cast<size_t>(P) * N;
  float* scratch_bh = scratch != nullptr ? scratch + bh * (n_chunks - 1) * PN : nullptr;

  const int sx = tid % LS::TX, sy = tid / LS::TX;   // state layout
  const int xx = tid % LX::TX, xy = tid / LX::TX;   // dx layout
  const int nx = tid % LN::TX, ny = tid / LN::TX;   // dB / dC layout
  const int tx16 = tid & 15, ty16 = tid >> 4;       // S / M tiles

  // dt and a = cumsum(dt * A) of chunk c into dts, cum; fin; da, ddd, gdt
  // zeroed. Steps at or past S get dt = 0: no input and no decay.
  auto scan_chunk = [&](int t0, int valid) {
    const float d = tid < valid ? dtb[static_cast<int64_t>(t0 + tid) * st.dt_s] : 0.f;
    const float v = block_scan(d * a_h, red_scan);
    if (tid < chunk) {
      dts[tid] = d;
      cum[tid] = v;
      da[tid] = 0.f;
      ddd[tid] = 0.f;
      gdt[tid] = 0.f;
    }
    __syncthreads();
    if (tid < chunk) fin[tid] = expf(cum[chunk - 1] - v) * d;   // exponent <= 0
    __syncthreads();
  };

  // ---- forward sweep: the state entering chunks 1 .. n_chunks - 1
  if (n_chunks > 1) {
    float hreg[LS::RPT][4];
#pragma unroll
    for (int r = 0; r < LS::RPT; ++r) {
      const int p = sy + LS::TY * r;
#pragma unroll
      for (int q = 0; q < 4; ++q)
        hreg[r][q] = (h0 != nullptr && p < P) ? h0[bh * PN + p * N + 4 * sx + q] : 0.f;
    }
    for (int c = 0; c + 1 < n_chunks; ++c) {
      const int t0 = c * chunk;
      scan_chunk(t0, chunk);
      const float decay = expf(cum[chunk - 1]);
#pragma unroll
      for (int r = 0; r < LS::RPT; ++r)
#pragma unroll
        for (int q = 0; q < 4; ++q) hreg[r][q] *= decay;
      for (int j0 = 0; j0 < chunk; j0 += R) {
        stage_rows<N, R>(Bs, Bb + static_cast<int64_t>(t0 + j0) * st.b_s, st.b_s, R);
        stage_rows<P, R>(Xs, xb + static_cast<int64_t>(t0 + j0) * st.x_s, st.x_s, R);
        __syncthreads();
#pragma unroll 4
        for (int j = 0; j < R; ++j) {
          const float4 bv = load4(Bs + j * NP + 4 * sx);
          const float f = fin[j0 + j];
#pragma unroll
          for (int r = 0; r < LS::RPT; ++r) {
            const int p = sy + LS::TY * r;
            if (p < P) {
              const float xf = Xs[j * XP + p] * f;
#pragma unroll
              for (int q = 0; q < 4; ++q) hreg[r][q] += xf * at(bv, q);
            }
          }
        }
        __syncthreads();
      }
#pragma unroll
      for (int r = 0; r < LS::RPT; ++r) {
        const int p = sy + LS::TY * r;
        if (p < P) store4(scratch_bh + c * PN + p * N + 4 * sx, hreg[r]);
      }
    }
    __syncthreads();
  }

  // ---- the chunks in reverse, G carried
  stage_state<P, N>(Gs, dstate != nullptr ? dstate + bh * PN : nullptr);
  float dA_acc = 0.f;
  for (int c = n_chunks - 1; c >= 0; --c) {
    const int t0 = c * chunk;
    const int valid = min(chunk, S - t0);
    const int n_blocks = (valid + R - 1) / R;
    const bool has_h = c > 0 || h0 != nullptr;            // else the state is zero
    const bool has_g = c < n_chunks - 1 || dstate != nullptr;   // else G is zero
    const bool need_dh = has_h;   // the entering state's gradient is read
    if (has_h)
      stage_state<P, N>(Hs, c > 0 ? scratch_bh + (c - 1) * PN : h0 + bh * PN);
    scan_chunk(t0, valid);        // its barriers cover the staging of Hs
    const float total = cum[chunk - 1];
    const float e_total = expf(total);

    // (A) per row block I: dC's carried-state term, U into da, the next G
    float gn[LS::RPT][4];
#pragma unroll
    for (int r = 0; r < LS::RPT; ++r) {
      const int p = sy + LS::TY * r;
#pragma unroll
      for (int q = 0; q < 4; ++q)
        gn[r][q] = (need_dh && has_g && p < P) ? e_total * Gs[p * NP + 4 * sx + q] : 0.f;
    }
    for (int I = 0; I < n_blocks; ++I) {
      const int i0 = I * R;
      stage_rows<N, R>(Cs, Cb + static_cast<int64_t>(t0 + i0) * st.c_s, st.c_s, valid - i0);
      stage_rows<P, R>(Ds, dyb + static_cast<int64_t>(t0 + i0) * st.dy_s, st.dy_s,
                       valid - i0);
      __syncthreads();
#pragma unroll
      for (int r = 0; r < LN::RPT; ++r) {
        const int row = ny + LN::TY * r;
        float acc[4] = {0.f, 0.f, 0.f, 0.f};
        if (has_h && row < R) {
#pragma unroll 4
          for (int p = 0; p < P; ++p) {
            const float dv = Ds[row * XP + p];
            const float4 hv = load4(Hs + p * NP + 4 * nx);
#pragma unroll
            for (int q = 0; q < 4; ++q) acc[q] += dv * at(hv, q);
          }
          const float e = expf(cum[i0 + row]);   // a_i <= 0
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[q] *= e;
        }
        if (has_h) {   // U_i = C_i . (exp(a_i) h^T dy_i), into da_i
          const float4 cv = row < R ? load4(Cs + row * NP + 4 * nx) : zero4();
          const float u = row_sum<LN::TX>(acc[0] * cv.x + acc[1] * cv.y + acc[2] * cv.z +
                                          acc[3] * cv.w);
          if (nx == 0 && row < R && i0 + row < valid) da[i0 + row] += u;
        }
        if (row < R && i0 + row < valid)
          store4(dCb + static_cast<int64_t>(t0 + i0 + row) * N + 4 * nx, acc);
      }
      if (need_dh) {   // next G += exp(a_i) dy_i C_i^T
        for (int i = 0; i < min(R, valid - i0); ++i) {
          const float e = expf(cum[i0 + i]);
          const float4 cv = load4(Cs + i * NP + 4 * sx);
#pragma unroll
          for (int r = 0; r < LS::RPT; ++r) {
            const int p = sy + LS::TY * r;
            if (p < P) {
              const float dv = Ds[i * XP + p] * e;
#pragma unroll
              for (int q = 0; q < 4; ++q) gn[r][q] += dv * at(cv, q);
            }
          }
        }
      }
      __syncthreads();   // the next row block restages Cs and Ds
    }
    // exp(a_L) <G, h>: the gradient of a_L through the carried state
    float v0 = 0.f;
    if (has_g && has_h) {
      float part = 0.f;
#pragma unroll
      for (int r = 0; r < LS::RPT; ++r) {
        const int p = sy + LS::TY * r;
        if (p < P) part += dot4(load4(Gs + p * NP + 4 * sx), load4(Hs + p * NP + 4 * sx));
      }
      v0 = e_total * block_sum(part, red_sum);
    }
    if (need_dh) {
      __syncthreads();   // every read of h is done
#pragma unroll
      for (int r = 0; r < LS::RPT; ++r) {
        const int p = sy + LS::TY * r;
        if (p < P) store4(Hs + p * NP + 4 * sx, gn[r]);
      }
    }

    // (C) per column block J
    for (int J = 0; J < n_blocks; ++J) {
      const int j0 = J * R;
      stage_rows<N, R>(Bs, Bb + static_cast<int64_t>(t0 + j0) * st.b_s, st.b_s, valid - j0);
      stage_rows<P, R>(Xs, xb + static_cast<int64_t>(t0 + j0) * st.x_s, st.x_s, valid - j0);
      __syncthreads();
      float dxa[LX::RPT][4], dba[LN::RPT][4];
#pragma unroll
      for (int r = 0; r < LX::RPT; ++r)
#pragma unroll
        for (int q = 0; q < 4; ++q) dxa[r][q] = 0.f;
#pragma unroll
      for (int r = 0; r < LN::RPT; ++r)
#pragma unroll
        for (int q = 0; q < 4; ++q) dba[r][q] = 0.f;
      if (has_g) {
        // dx_j = fin_j G B_j; g_j = exp(a_L - a_j) x_j . G B_j
#pragma unroll
        for (int r = 0; r < LX::RPT; ++r) {
          const int row = xy + LX::TY * r;
          float gb[4] = {0.f, 0.f, 0.f, 0.f};
          if (row < R) {
#pragma unroll 4
            for (int n = 0; n < N; n += 4) {
              const float4 bv = load4(Bs + row * NP + n);
#pragma unroll
              for (int q = 0; q < 4; ++q) gb[q] += dot4(bv, load4(Gs + (4 * xx + q) * NP + n));
            }
          }
          const float4 xv = row < R ? load4(Xs + row * XP + 4 * xx) : zero4();
          const float gd = row_sum<LX::TX>(xv.x * gb[0] + xv.y * gb[1] + xv.z * gb[2] +
                                           xv.w * gb[3]);
          if (row < R) {
            const int j = j0 + row;
            const float f = fin[j];
#pragma unroll
            for (int q = 0; q < 4; ++q) dxa[r][q] = f * gb[q];
            if (xx == 0 && j < valid) {
              const float g = expf(total - cum[j]) * gd;
              ddd[j] += g;
              gdt[j] = dts[j] * g;
              da[j] -= dts[j] * g;
            }
          }
        }
        // dB_j = fin_j G^T x_j
#pragma unroll
        for (int r = 0; r < LN::RPT; ++r) {
          const int row = ny + LN::TY * r;
          if (row < R) {
            float xg[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
            for (int p = 0; p < P; ++p) {
              const float xv = Xs[row * XP + p];
              const float4 gv = load4(Gs + p * NP + 4 * nx);
#pragma unroll
              for (int q = 0; q < 4; ++q) xg[q] += xv * at(gv, q);
            }
            const float f = fin[j0 + row];
#pragma unroll
            for (int q = 0; q < 4; ++q) dba[r][q] = f * xg[q];
          }
        }
      }

      for (int I = J; I < n_blocks; ++I) {
        const int i0 = I * R;
        stage_rows<N, R>(Cs, Cb + static_cast<int64_t>(t0 + i0) * st.c_s, st.c_s,
                         valid - i0);
        stage_rows<P, R>(Ds, dyb + static_cast<int64_t>(t0 + i0) * st.dy_s, st.dy_s,
                         valid - i0);
        __syncthreads();

        // S = C_I B_J^T and M = dy_I x_J^T, rows ty16 + 16 i, columns tx16 + 16 j
        {
          float s[SI][SI], m[SI][SI];
#pragma unroll
          for (int i = 0; i < SI; ++i)
#pragma unroll
            for (int j = 0; j < SI; ++j) s[i][j] = m[i][j] = 0.f;
#pragma unroll 2
          for (int n = 0; n < N; n += 4) {
            float4 ca[SI], ba[SI];
#pragma unroll
            for (int i = 0; i < SI; ++i) ca[i] = load4(Cs + (ty16 + 16 * i) * NP + n);
#pragma unroll
            for (int j = 0; j < SI; ++j) ba[j] = load4(Bs + (tx16 + 16 * j) * NP + n);
#pragma unroll
            for (int i = 0; i < SI; ++i)
#pragma unroll
              for (int j = 0; j < SI; ++j) s[i][j] += dot4(ca[i], ba[j]);
          }
#pragma unroll 2
          for (int p = 0; p < P; p += 4) {
            float4 da4[SI], xa[SI];
#pragma unroll
            for (int i = 0; i < SI; ++i) da4[i] = load4(Ds + (ty16 + 16 * i) * XP + p);
#pragma unroll
            for (int j = 0; j < SI; ++j) xa[j] = load4(Xs + (tx16 + 16 * j) * XP + p);
#pragma unroll
            for (int i = 0; i < SI; ++i)
#pragma unroll
              for (int j = 0; j < SI; ++j) m[i][j] += dot4(da4[i], xa[j]);
          }
          float colpart[SI];
#pragma unroll
          for (int j = 0; j < SI; ++j) colpart[j] = 0.f;
#pragma unroll
          for (int i = 0; i < SI; ++i) {
            const int gi = i0 + ty16 + 16 * i;
            float rowpart = 0.f;
#pragma unroll
            for (int j = 0; j < SI; ++j) {
              const int gj = j0 + tx16 + 16 * j;
              float w = 0.f, z = 0.f, qv = 0.f;
              // the exponent is formed for i >= j only: for i < j it is positive
              if (gi >= gj && gi < valid) {
                const float L = expf(cum[gi] - cum[gj]);
                const float sl = s[i][j] * L;
                w = sl * dts[gj];
                z = m[i][j] * L * dts[gj];
                qv = sl * m[i][j];
              }
              Ws[(ty16 + 16 * i) * WP + tx16 + 16 * j] = w;
              Zs[(ty16 + 16 * i) * WP + tx16 + 16 * j] = z;
              rowpart += qv * dts[gj];
              colpart[j] += qv;
            }
            rowpart = row_sum<16>(rowpart);
            if (tx16 == 0 && gi < valid) da[gi] += rowpart;
          }
#pragma unroll
          for (int j = 0; j < SI; ++j) colbuf[ty16 * R + tx16 + 16 * j] = colpart[j];
        }
        __syncthreads();

        // the columns of Q: the direct part of d(dt_j), -dt_j of it into da_j
        if (tid < R && j0 + tid < valid) {
          float cs = 0.f;
#pragma unroll
          for (int k = 0; k < kColGroups; ++k) cs += colbuf[k * R + tid];
          ddd[j0 + tid] += cs;
          da[j0 + tid] -= dts[j0 + tid] * cs;
        }

        // dx_J += W^T dy_I
#pragma unroll 4
        for (int k = 0; k < R; ++k) {
          const float4 dv = load4(Ds + k * XP + 4 * xx);
#pragma unroll
          for (int r = 0; r < LX::RPT; ++r) {
            const int row = xy + LX::TY * r;
            const float w = row < R ? Ws[k * WP + row] : 0.f;
#pragma unroll
            for (int q = 0; q < 4; ++q) dxa[r][q] += w * at(dv, q);
          }
        }
        // dB_J += Z^T C_I
#pragma unroll 4
        for (int k = 0; k < R; ++k) {
          const float4 cv = load4(Cs + k * NP + 4 * nx);
#pragma unroll
          for (int r = 0; r < LN::RPT; ++r) {
            const int row = ny + LN::TY * r;
            const float z = row < R ? Zs[k * WP + row] : 0.f;
#pragma unroll
            for (int q = 0; q < 4; ++q) dba[r][q] += z * at(cv, q);
          }
        }
        // dC_I += Z B_J, into the block's own partial (written in (A))
#pragma unroll
        for (int r = 0; r < LN::RPT; ++r) {
          const int row = ny + LN::TY * r;
          if (row < R && i0 + row < valid) {
            float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
            for (int k = 0; k < R; ++k) {
              const float z = Zs[row * WP + k];
              const float4 bv = load4(Bs + k * NP + 4 * nx);
#pragma unroll
              for (int q = 0; q < 4; ++q) acc[q] += z * at(bv, q);
            }
            float* dst = dCb + static_cast<int64_t>(t0 + i0 + row) * N + 4 * nx;
            const float4 old = load4(dst);
#pragma unroll
            for (int q = 0; q < 4; ++q) acc[q] += at(old, q);
            store4(dst, acc);
          }
        }
        __syncthreads();   // the next step restages Cs, Ds, Ws, Zs and colbuf
      }

#pragma unroll
      for (int r = 0; r < LX::RPT; ++r) {
        const int row = xy + LX::TY * r;
        if (row < R && j0 + row < valid)
          store4(dxb + static_cast<int64_t>(t0 + j0 + row) * H * P + 4 * xx, dxa[r]);
      }
#pragma unroll
      for (int r = 0; r < LN::RPT; ++r) {
        const int row = ny + LN::TY * r;
        if (row < R && j0 + row < valid)
          store4(dBb + static_cast<int64_t>(t0 + j0 + row) * N + 4 * nx, dba[r]);
      }
      __syncthreads();   // the next column block restages Bs and Xs
    }

    // the terms of a_L, then r = the reverse running sum of da; d(dt), dA
    float last = v0;
    if (has_g) last += block_sum(tid < valid ? gdt[tid] : 0.f, red_sum);
    const int e = valid - 1 - tid;
    const float dv = tid < valid ? da[e] + (tid == 0 ? last : 0.f) : 0.f;
    const float rsum = block_scan(dv, red_scan);
    float part = 0.f;
    if (tid < valid) {
      ddtb[static_cast<int64_t>(t0 + e) * H] = ddd[e] + a_h * rsum;
      part = dts[e] * rsum;
    }
    dA_acc += block_sum(part, red_sum);
    if (need_dh) {   // the next (earlier) chunk's G is in Hs
      float* t = Gs;
      Gs = Hs;
      Hs = t;
    }
    __syncthreads();   // the next chunk rewrites the chunk vectors and Hs
  }

  if (tid == 0) dA_part[bh] = dA_acc;
  if (dh0 != nullptr) {
    constexpr int VPR = N / 4;
    for (int idx = tid; idx < P * VPR; idx += kThreads) {
      const int r = idx / VPR;
      const int c = (idx % VPR) * 4;
      *reinterpret_cast<float4*>(dh0 + bh * PN + r * N + c) =
          *reinterpret_cast<const float4*>(Gs + r * NP + c);
    }
  }
}

template <typename T, int P, int N, int R>
cudaError_t launch(const void* x, const void* dt, const void* A, const void* B, const void* C,
                   const void* h0, const void* dy, const void* dstate, void* dx, void* ddt,
                   void* dA_part, void* dB_part, void* dC_part, void* dh0, void* scratch,
                   int batch, int S, int H, int chunk, const Strides& st,
                   cudaStream_t stream) {
  constexpr size_t smem = sizeof(float) * smem_floats<P, N, R>();
  static_assert(smem <= 232448, "more shared memory than a block can have");
  auto kernel = ssd_scan_bwd_kernel<T, P, N, R>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<dim3(H, batch), kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt), static_cast<const float*>(A),
      static_cast<const T*>(B), static_cast<const T*>(C), static_cast<const float*>(h0),
      static_cast<const T*>(dy), static_cast<const float*>(dstate), static_cast<T*>(dx),
      static_cast<float*>(ddt), static_cast<float*>(dA_part), static_cast<float*>(dB_part),
      static_cast<float*>(dC_part), static_cast<float*>(dh0), static_cast<float*>(scratch), S,
      H, chunk, st);
  return cudaGetLastError();
}

template <typename T, int P, int N>
cudaError_t launch_r(const void* x, const void* dt, const void* A, const void* B,
                     const void* C, const void* h0, const void* dy, const void* dstate,
                     void* dx, void* ddt, void* dA_part, void* dB_part, void* dC_part,
                     void* dh0, void* scratch, int batch, int S, int H, int chunk,
                     const Strides& st, cudaStream_t stream) {
  if (chunk == 32)
    return launch<T, P, N, 32>(x, dt, A, B, C, h0, dy, dstate, dx, ddt, dA_part, dB_part,
                               dC_part, dh0, scratch, batch, S, H, chunk, st, stream);
  return launch<T, P, N, 64>(x, dt, A, B, C, h0, dy, dstate, dx, ddt, dA_part, dB_part,
                             dC_part, dh0, scratch, batch, S, H, chunk, st, stream);
}

template <typename T, int P>
cudaError_t launch_n(int N, const void* x, const void* dt, const void* A, const void* B,
                     const void* C, const void* h0, const void* dy, const void* dstate,
                     void* dx, void* ddt, void* dA_part, void* dB_part, void* dC_part,
                     void* dh0, void* scratch, int batch, int S, int H, int chunk,
                     const Strides& st, cudaStream_t stream) {
#define REPRO_SSD_BWD_ARGS x, dt, A, B, C, h0, dy, dstate, dx, ddt, dA_part, dB_part, \
    dC_part, dh0, scratch, batch, S, H, chunk, st, stream
  if (N == 128) return launch_r<T, P, 128>(REPRO_SSD_BWD_ARGS);
  if (N == 64) return launch_r<T, P, 64>(REPRO_SSD_BWD_ARGS);
  if (N == 16) return launch_r<T, P, 16>(REPRO_SSD_BWD_ARGS);
#undef REPRO_SSD_BWD_ARGS
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t launch_p(int P, int N, const void* x, const void* dt, const void* A,
                     const void* B, const void* C, const void* h0, const void* dy,
                     const void* dstate, void* dx, void* ddt, void* dA_part, void* dB_part,
                     void* dC_part, void* dh0, void* scratch, int batch, int S, int H,
                     int chunk, const Strides& st, cudaStream_t stream) {
  if (P == 64)
    return launch_n<T, 64>(N, x, dt, A, B, C, h0, dy, dstate, dx, ddt, dA_part, dB_part,
                           dC_part, dh0, scratch, batch, S, H, chunk, st, stream);
  if (P == 32)
    return launch_n<T, 32>(N, x, dt, A, B, C, h0, dy, dstate, dx, ddt, dA_part, dB_part,
                           dC_part, dh0, scratch, batch, S, H, chunk, st, stream);
  return cudaErrorInvalidValue;
}

// ==================================================== split products on the tensor cores

constexpr int kTcWarps = 8;                       // consumer warps
constexpr int kTcThreads = (kTcWarps + 1) * 32;   // and one producer warp
constexpr int kRows = 64;                         // rows of a row block
constexpr int kTcP = 64;                          // the P the instances take
constexpr int kMaxHeads = 5;                      // heads a block, at most
constexpr int kWP = kRows + 4;                    // floats a row of W^T and Zsum^T

// elements of padding per shared-memory row of a staged tile: 16 bytes
template <typename T>
constexpr int kPadT = 16 / static_cast<int>(sizeof(T));

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// d += A B on the tensor cores. For float32 inputs, whose gradients keep
// float32's precision: 6xTF32, each k-step's products in a fresh
// accumulator added to d by a rounding fp32 add (warp_mma6). For bf16
// inputs, exact in TF32 and held to bf16's tolerance: 3xTF32 in one
// accumulator (warp_mma).
template <bool FP32, int NT, int K, bool A_EXACT, bool B_EXACT, typename LA, typename LB>
__device__ __forceinline__ void tc_mma(float (&d)[NT][4], LA la, LB lb) {
  if constexpr (FP32)
    warp_mma6<NT, K, A_EXACT, B_EXACT>(d, la, lb);
  else
    warp_mma<NT, K, A_EXACT, B_EXACT>(d, la, lb);
}

// the consumer warps, and the two warps that share rows 16 rg .. of a tile
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kTcWarps * 32) : "memory");
}
__device__ __forceinline__ void pair_sync(int rg) {
  asm volatile("bar.sync %0, 64;\n" ::"r"(2 + rg) : "memory");
}

// Rows [0, kRows) of a (rows, W) matrix whose row r starts at src + r *
// stride (elements, W contiguous) into dst[kRows][LD] by cp.async from the
// calling warp; rows >= n_valid read as 0.
template <int W, int LD, typename T>
__device__ __forceinline__ void load_tile(T* dst, const T* src, int64_t stride, int n_valid) {
  constexpr int E = 16 / static_cast<int>(sizeof(T));   // elements a 16-byte piece
  constexpr int CPR = W / E;                            // pieces a row
  for (int idx = threadIdx.x & 31; idx < kRows * CPR; idx += 32) {
    const int r = idx / CPR, c = idx % CPR;
    const bool ok = r < n_valid;
    cp_async16(smem_u32(dst + r * LD + c * E), src + (ok ? r * stride : 0) + c * E,
               ok ? 16u : 0u);
  }
}

template <typename T, int N>
constexpr size_t tc_smem() {
  return 64 + sizeof(double) * kMaxHeads * kMaxChunk +
         sizeof(float) * (3 * kRows * kWP + 3 * kMaxHeads * kMaxChunk + kMaxHeads * kTcWarps * 48) +
         sizeof(T) * (2 * kRows * (N + kPadT<T>) + 4 * kRows * (kTcP + kPadT<T>));
}

// grid (ceil(H / hg), batch): a block owns heads hg b .. of sequence b (fewer
// in the last group). One chunk (S <= chunk), no h0, no final-state
// cotangent. dx (b, S, H, P) in T, ddt (b, S, H), dA partial (b, H), dB and
// dC partials (ceil(H / hg), b, S, N) fp32, all contiguous.
template <typename T, int N>
__global__ void __launch_bounds__(kTcThreads, 1)
ssd_scan_bwd_tc(const T* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ A, const T* __restrict__ Bm,
                const T* __restrict__ Cm, const T* __restrict__ dy, T* __restrict__ dx,
                float* __restrict__ ddt, float* __restrict__ dA_part, float* dB_part,
                float* dC_part, int S, int H, int hg, Strides st) {
  constexpr int LN = N + kPadT<T>;          // elements a row of the B and C tiles
  constexpr int LX = kTcP + kPadT<T>;       // of the x and dy tiles
  constexpr bool kExact = sizeof(T) == 2;      // bf16 inputs are exact in TF32
  constexpr int NH = N / 2;                    // columns of dB and dC a warp
  extern __shared__ __align__(16) unsigned char smem_tc[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem_tc);   // 8 mbarriers
  float* Wb = reinterpret_cast<float*>(smem_tc + 64);      // [2][kRows][kWP] W^T
  float* Zb = Wb + 2 * kRows * kWP;                        // [kRows][kWP] Zsum^T
  double* av = reinterpret_cast<double*>(Zb + kRows * kWP);   // [kMaxHeads][kMaxChunk] a
  float* dtv = reinterpret_cast<float*>(av + kMaxHeads * kMaxChunk);   // dt
  float* dav = dtv + kMaxHeads * kMaxChunk;                // the gradient of a
  float* ddd = dav + kMaxHeads * kMaxChunk;                // d(dt)'s direct part
  float* rowpart = ddd + kMaxHeads * kMaxChunk;            // [kMaxHeads][8][32]
  float* colpart = rowpart + kMaxHeads * kTcWarps * 32;    // [kMaxHeads][8][16]
  T* Bs = reinterpret_cast<T*>(colpart + kMaxHeads * kTcWarps * 16);   // [kRows][LN]
  T* Cs = Bs + kRows * LN;                                 // [kRows][LN]
  T* Xs = Cs + kRows * LN;                                 // [2][kRows][LX]
  T* Ds = Xs + 2 * kRows * LX;                             // [2][kRows][LX] dy
  // "full" barriers 0-3 (B_J, C_I, the two x and dy slots), completed by the
  // producer's 32 lanes; "empty" barriers 4-7 (the same buffers), one arrival
  // a consumer warp
  constexpr int kFullB = 0, kFullC = 1, kFullX = 2, kEmptyB = 4, kEmptyC = 5, kEmptyX = 6;
  auto bar = [&](int i) { return smem_u32(bars + i); };

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int b = blockIdx.y, hb = blockIdx.x * hg;
  const int nh = min(hg, H - hb);
  const int nb = (S + kRows - 1) / kRows;

  if (tid == 0)
    for (int i = 0; i < 8; ++i) mbar_init(bar(i), i < kEmptyB ? 32 : kTcWarps);
  __syncthreads();

  // ---- the producer warp: the tiles, in the order the consumers use them
  if (warp == kTcWarps) {
    int ub = 0, uc = 0, ux = 0;
    for (int J = 0; J < nb; ++J) {
      const int j0 = J * kRows;
      if (ub > 0) mbar_wait(bar(kEmptyB), (ub - 1) & 1);
      load_tile<N, LN>(Bs, Bm + b * st.b_b + j0 * st.b_s, st.b_s, S - j0);
      cp_async_arrive(bar(kFullB));
      ++ub;
      for (int I = J; I < nb; ++I) {
        const int i0 = I * kRows;
        if (uc > 0) mbar_wait(bar(kEmptyC), (uc - 1) & 1);
        load_tile<N, LN>(Cs, Cm + b * st.c_b + i0 * st.c_s, st.c_s, S - i0);
        cp_async_arrive(bar(kFullC));
        ++uc;
        for (int hh = 0; hh < nh; ++hh, ++ux) {
          const int slot = ux & 1, use = ux >> 1;
          if (use > 0) mbar_wait(bar(kEmptyX + slot), (use - 1) & 1);
          const int h = hb + hh;
          load_tile<kTcP, LX>(Xs + slot * kRows * LX,
                              x + b * st.x_b + j0 * st.x_s + h * st.x_h, st.x_s, S - j0);
          load_tile<kTcP, LX>(Ds + slot * kRows * LX,
                              dy + b * st.dy_b + i0 * st.dy_s + h * st.dy_h, st.dy_s, S - i0);
          cp_async_arrive(bar(kFullX + slot));
        }
      }
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    return;
  }

  // ---- the consumer warps
  const int rg = warp & 3, half = warp >> 2, g = lane >> 2, t = lane & 3;
  for (int i = tid; i < kMaxHeads * kMaxChunk; i += kTcWarps * 32) dav[i] = ddd[i] = 0.f;
  if (warp < nh) {   // a = the running sum of dt * A over the chunk, head hb + warp
    // in float64, as the forward's (ssd_scan.cu): the exponents a_i - a_j
    // are differences of two sums of up to a few thousand
    const int h = hb + warp;
    const double ah = A[h];
    double v[8], run = 0.0;
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int k = 8 * lane + q;   // steps at or past S: dt = 0
      const float d = k < S ? dt[b * st.dt_b + k * st.dt_s + h * st.dt_h] : 0.f;
      dtv[warp * kMaxChunk + k] = d;
      run += static_cast<double>(d) * ah;
      v[q] = run;
    }
    double incl = run;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const double u = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl += u;
    }
#pragma unroll
    for (int q = 0; q < 8; ++q) av[warp * kMaxChunk + 8 * lane + q] = v[q] + incl - run;
  }
  consumers_sync();

  // dx_J of each head, rows 16 rg .., columns 32 half ..: in registers
  // across the row block's tile pairs for bf16 inputs; for float32 inputs
  // each pair's rounded product is added into dx itself (the thread's own
  // elements, in pair order), which frees the registers the rounded sums take
  float dxa[kExact ? kMaxHeads : 1][4][4];
  int ub = 0, uc = 0, ux = 0;
  for (int J = 0; J < nb; ++J) {
    const int j0 = J * kRows;
    mbar_wait(bar(kFullB), ub & 1);
    if constexpr (kExact) {
#pragma unroll
      for (int hh = 0; hh < kMaxHeads; ++hh)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int r = 0; r < 4; ++r) dxa[hh][nt][r] = 0.f;
    }

    for (int I = J; I < nb; ++I) {
      const int i0 = I * kRows;
      mbar_wait(bar(kFullC), uc & 1);
      // S^T = B_J C_I^T (the heads share it): rows j 16 rg .., columns i 32 half ..
      float sT[4][4] = {};
      {
        const T* Ba = Bs + 16 * rg * LN;
        const T* Cb = Cs + 32 * half * LN;
        tc_mma<!kExact, 4, N, kExact, kExact>(
            sT, [&](int m, int k) { return to_f(Ba[m * LN + k]); },
            [&](int k, int n) { return to_f(Cb[n * LN + k]); });
      }
      float zs[4][4] = {};   // Zsum^T = sum over the heads of Z^T, the same tile
#pragma unroll
      for (int hh = 0; hh < kMaxHeads; ++hh) {
        if (hh < nh) {
          const int slot = ux & 1;
          mbar_wait(bar(kFullX + slot), (ux >> 1) & 1);
          const T* xs = Xs + slot * kRows * LX;
          const T* ds = Ds + slot * kRows * LX;
          // M^T = x_J dy_I^T, the same tile
          float mT[4][4] = {};
          tc_mma<!kExact, 4, kTcP, kExact, kExact>(
              mT, [&](int m, int k) { return to_f(xs[(16 * rg + m) * LX + k]); },
              [&](int k, int n) { return to_f(ds[(32 * half + n) * LX + k]); });
          // W^T = S^T o L^T dt_j into W, Z^T = M^T o L^T dt_j into Zsum^T, and
          // Q = S o L o M's row sums and its column sums weighted by dt_j
          const double* a = av + hh * kMaxChunk;
          const float* dtp = dtv + hh * kMaxChunk;
          float* W = Wb + slot * kRows * kWP;
          const int jl = 16 * rg + g;   // the thread's rows jl and jl + 8
          const double aj[2] = {a[j0 + jl], a[j0 + jl + 8]};
          const float dj[2] = {dtp[j0 + jl], dtp[j0 + jl + 8]};
          float colp[2] = {0.f, 0.f}, rowp[4][2] = {};
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) {
            const int il = 32 * half + 8 * nt + 2 * t;   // the thread's columns il, il + 1
#pragma unroll
            for (int jr = 0; jr < 2; ++jr) {
              const int gj = j0 + jl + 8 * jr;
              float w[2];
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const int gi = i0 + il + e;
                float z = 0.f, q = 0.f;
                w[e] = 0.f;
                // the exponent is formed for i >= j only: for i < j it is positive
                if (gi >= gj && gi < S) {
                  const float L = expf(static_cast<float>(a[gi] - aj[jr]));
                  const float sl = sT[nt][2 * jr + e] * L;
                  const float m = mT[nt][2 * jr + e];
                  w[e] = sl * dj[jr];
                  z = m * L * dj[jr];
                  q = sl * m;
                }
                zs[nt][2 * jr + e] += z;
                colp[jr] += q;
                rowp[nt][e] += q * dj[jr];
              }
              *reinterpret_cast<float2*>(W + (jl + 8 * jr) * kWP + il) = make_float2(w[0], w[1]);
            }
          }
#pragma unroll
          for (int jr = 0; jr < 2; ++jr) {   // over the 4 lanes of a row
            colp[jr] += __shfl_xor_sync(0xffffffffu, colp[jr], 1);
            colp[jr] += __shfl_xor_sync(0xffffffffu, colp[jr], 2);
          }
#pragma unroll
          for (int nt = 0; nt < 4; ++nt)     // over the 8 lanes of a column
#pragma unroll
            for (int e = 0; e < 2; ++e)
#pragma unroll
              for (int off = 4; off < 32; off <<= 1)
                rowp[nt][e] += __shfl_xor_sync(0xffffffffu, rowp[nt][e], off);
          float* cp = colpart + (hh * kTcWarps + warp) * 16;
          float* rp = rowpart + (hh * kTcWarps + warp) * 32;
          if (t == 0) {
            cp[g] = colp[0];
            cp[g + 8] = colp[1];
          }
          if (g == 0) {
#pragma unroll
            for (int nt = 0; nt < 4; ++nt) {
              rp[8 * nt + 2 * t] = rowp[nt][0];
              rp[8 * nt + 2 * t + 1] = rowp[nt][1];
            }
          }
          pair_sync(rg);   // both halves of W^T's rows 16 rg .. are written
          // dx_J += W^T dy_I: rows j 16 rg .., columns p 32 half ..; K = i
          const auto w_t = [&](int m, int k) { return W[(16 * rg + m) * kWP + k]; };
          const auto dy_i = [&](int k, int n) { return to_f(ds[k * LX + 32 * half + n]); };
          if constexpr (kExact) {
            warp_mma<4, kRows, false, kExact>(dxa[hh], w_t, dy_i);
          } else {
            float acc[4][4] = {};
            tc_mma<true, 4, kRows, false, kExact>(acc, w_t, dy_i);
#pragma unroll
            for (int nt = 0; nt < 4; ++nt)
#pragma unroll
              for (int jr = 0; jr < 2; ++jr) {
                const int j = j0 + 16 * rg + g + 8 * jr;
                if (j < S) {
                  float2* p = reinterpret_cast<float2*>(
                      dx + (static_cast<int64_t>(b * S + j) * H + hb + hh) * kTcP +
                      32 * half + 8 * nt + 2 * t);
                  float2 v = make_float2(acc[nt][2 * jr], acc[nt][2 * jr + 1]);
                  if (I != J) {   // the row block's first pair stores
                    const float2 o = *p;
                    v.x = o.x + v.x;
                    v.y = o.y + v.y;
                  }
                  *p = v;
                }
              }
          }
          __syncwarp();
          if (lane == 0) mbar_arrive(bar(kEmptyX + slot));   // x and dy slot free
          ++ux;
        }
      }
      consumers_sync();   // every warp is done reading the last pair's Zsum^T (dC)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int jr = 0; jr < 2; ++jr)
          *reinterpret_cast<float2*>(Zb + (16 * rg + g + 8 * jr) * kWP + 32 * half + 8 * nt +
                                     2 * t) = make_float2(zs[nt][2 * jr], zs[nt][2 * jr + 1]);
      consumers_sync();   // Zsum^T and the partial sums of Q are complete

      // da and d(dt)'s direct part, from the partial sums in a fixed order:
      // row xl of the tile (j = j0 + xl) sums its two column halves, column xl
      // (i = i0 + xl) its four row groups
      for (int idx = tid; idx < nh * kRows; idx += kTcWarps * 32) {
        const int hh = idx / kRows, xl = idx % kRows;
        const float* rp = rowpart + hh * kTcWarps * 32;
        const float* cp = colpart + hh * kTcWarps * 16;
        float* da = dav + hh * kMaxChunk;
        const int hx = xl / 32, rx = xl / 16;
        const float rs = rp[(4 * hx + 0) * 32 + xl % 32] + rp[(4 * hx + 1) * 32 + xl % 32] +
                         rp[(4 * hx + 2) * 32 + xl % 32] + rp[(4 * hx + 3) * 32 + xl % 32];
        const float cs = cp[rx * 16 + xl % 16] + cp[(rx + 4) * 16 + xl % 16];
        if (j0 + xl < S) {
          ddd[hh * kMaxChunk + j0 + xl] += cs;
          da[j0 + xl] -= dtv[hh * kMaxChunk + j0 + xl] * cs;
        }
        if (i0 + xl < S) da[i0 + xl] += rs;
      }

      // the partials of the block's heads: dB_J += Zsum^T C_I (rows j), then
      // C_I is released (the next pair's loads while dC runs), dC_I += Zsum
      // B_J (rows i); columns n NH half ..; the first pair of a row block
      // stores, later ones add (the same thread, nothing shared)
      auto to_partial = [&](float* part, int r0, bool first, const float (&acc)[NH / 8][4]) {
#pragma unroll
        for (int nt = 0; nt < NH / 8; ++nt)
#pragma unroll
          for (int jr = 0; jr < 2; ++jr) {
            const int row = r0 + 16 * rg + g + 8 * jr;
            if (row < S) {
              float2* p = reinterpret_cast<float2*>(
                  part + ((static_cast<int64_t>(blockIdx.x) * gridDim.y + b) * S + row) * N +
                  NH * half + 8 * nt + 2 * t);
              float2 v = make_float2(acc[nt][2 * jr], acc[nt][2 * jr + 1]);
              if (!first) {
                const float2 o = *p;
                v.x += o.x;
                v.y += o.y;
              }
              *p = v;
            }
          }
      };
      {
        float acc[NH / 8][4] = {};
        tc_mma<!kExact, NH / 8, kRows, false, kExact>(
            acc, [&](int m, int k) { return Zb[(16 * rg + m) * kWP + k]; },
            [&](int k, int n) { return to_f(Cs[k * LN + NH * half + n]); });
        to_partial(dB_part, j0, I == J, acc);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(bar(kEmptyC));   // C_I and the partial sums free
      ++uc;
      {
        float acc[NH / 8][4] = {};
        tc_mma<!kExact, NH / 8, kRows, false, kExact>(
            acc, [&](int m, int k) { return Zb[k * kWP + 16 * rg + m]; },
            [&](int k, int n) { return to_f(Bs[k * LN + NH * half + n]); });
        to_partial(dC_part, i0, J == 0, acc);
      }
    }
    if constexpr (kExact) {
#pragma unroll
      for (int hh = 0; hh < kMaxHeads; ++hh) {
        if (hh < nh) {
#pragma unroll
          for (int nt = 0; nt < 4; ++nt)
#pragma unroll
            for (int jr = 0; jr < 2; ++jr) {
              const int j = j0 + 16 * rg + g + 8 * jr;
              if (j < S)
                store2(dx + (static_cast<int64_t>(b * S + j) * H + hb + hh) * kTcP +
                           32 * half + 8 * nt + 2 * t,
                       dxa[hh][nt][2 * jr], dxa[hh][nt][2 * jr + 1]);
            }
        }
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(bar(kEmptyB));   // B_J free
    ++ub;
  }

  // r = the reverse running sum of da over the chunk; d(dt) and the dA part.
  // In float64: r sums terms that cancel (the da of a chunk sum to about
  // 0), and dA = sum dt r cancels again, so in float32 its error was a few
  // roundings of terms far larger than itself, as the plain version's is
  consumers_sync();
  if (warp < nh) {
    const int h = hb + warp;
    const float* da = dav + warp * kMaxChunk;
    double v[8], run = 0.0;
#pragma unroll
    for (int q = 7; q >= 0; --q) {
      run += da[8 * lane + q];
      v[q] = run;
    }
    double incl = run;   // over this lane's and the later lanes' steps
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const double u = __shfl_down_sync(0xffffffffu, incl, off);
      if (lane + off < 32) incl += u;
    }
    const double ah = A[h];
    double part = 0.0;
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int k = 8 * lane + q;
      if (k < S) {
        const double r = v[q] + incl - run;
        ddt[static_cast<int64_t>(b * S + k) * H + h] =
            static_cast<float>(ddd[warp * kMaxChunk + k] + ah * r);
        part += dtv[warp * kMaxChunk + k] * r;
      }
    }
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) part += __shfl_xor_sync(0xffffffffu, part, off);
    if (lane == 0) dA_part[b * H + h] = static_cast<float>(part);
  }
}

template <typename T, int N>
cudaError_t launch_tc(const void* x, const void* dt, const void* A, const void* B,
                      const void* C, const void* dy, void* dx, void* ddt, void* dA_part,
                      void* dB_part, void* dC_part, int batch, int S, int H, int hg,
                      const Strides& st, cudaStream_t stream) {
  constexpr size_t smem = tc_smem<T, N>();
  static_assert(smem <= 232448, "more shared memory than a block can have");
  auto kernel = ssd_scan_bwd_tc<T, N>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<dim3((H + hg - 1) / hg, batch), kTcThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt), static_cast<const float*>(A),
      static_cast<const T*>(B), static_cast<const T*>(C), static_cast<const T*>(dy),
      static_cast<T*>(dx), static_cast<float*>(ddt), static_cast<float*>(dA_part),
      static_cast<float*>(dB_part), static_cast<float*>(dC_part), S, H, hg, st);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_tc_n(int N, const void* x, const void* dt, const void* A, const void* B,
                        const void* C, const void* dy, void* dx, void* ddt, void* dA_part,
                        void* dB_part, void* dC_part, int batch, int S, int H, int hg,
                        const Strides& st, cudaStream_t stream) {
  if (N == 128)
    return launch_tc<T, 128>(x, dt, A, B, C, dy, dx, ddt, dA_part, dB_part, dC_part, batch,
                             S, H, hg, st, stream);
  return launch_tc<T, 64>(x, dt, A, B, C, dy, dx, ddt, dA_part, dB_part, dC_part, batch, S,
                          H, hg, st, stream);
}

}  // namespace

// strides: x (b, s, h), dt (b, s, h), B (b, s), C (b, s), dy (b, s, h), in
// elements. scratch: (batch, H, chunks - 1, P, N) fp32, null for one chunk.
// is_bf16 chooses the input type: 1 bf16, 0 float32. tensor_cores chooses
// the kernel: 1 ssd_scan_bwd_tc, whose dB and dC partials are
// (ceil(H / heads_per_block), batch, S, N), for the shapes it takes (P 64, N
// 64 or 128, one chunk, no h0, no dstate; anything else is
// cudaErrorInvalidValue); 0 the FMA kernel, whose partials are (H, batch, S,
// N).
extern "C" int ssd_scan_bwd_launch(const void* x, const void* dt, const void* A,
                                   const void* B, const void* C, const void* h0,
                                   const void* dy, const void* dstate, void* dx, void* ddt,
                                   void* dA_part, void* dB_part, void* dC_part, void* dh0,
                                   void* scratch, int batch, int S, int H, int P, int N,
                                   int chunk, int is_bf16, int tensor_cores,
                                   int heads_per_block, const long long* strides,
                                   void* stream) {
  // the autograd engine's device thread runs every backward: the device's
  // primary context is made current first, as for the launchers that encode
  // tensor maps (this one encodes none: cp.async stages its tiles)
  if (bind_context() != CUDA_SUCCESS) return static_cast<int>(cudaErrorInvalidDevice);
  Strides st;
  st.x_b = strides[0]; st.x_s = strides[1]; st.x_h = strides[2];
  st.dt_b = strides[3]; st.dt_s = strides[4]; st.dt_h = strides[5];
  st.b_b = strides[6]; st.b_s = strides[7];
  st.c_b = strides[8]; st.c_s = strides[9];
  st.dy_b = strides[10]; st.dy_s = strides[11]; st.dy_h = strides[12];
  const bool chunk_ok = chunk == 32 || chunk == 64 || chunk == 128 || chunk == 256;
  if (!chunk_ok || S <= 0 || H <= 0 || batch <= 0 || (h0 != nullptr) != (dh0 != nullptr) ||
      ((S + chunk - 1) / chunk > 1) != (scratch != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tensor_cores) {
    if (P != kTcP || (N != 64 && N != 128) || S > chunk || h0 != nullptr ||
        dstate != nullptr || heads_per_block < 1 || heads_per_block > kMaxHeads)
      return static_cast<int>(cudaErrorInvalidValue);
    const cudaError_t err =
        is_bf16 ? launch_tc_n<__nv_bfloat16>(N, x, dt, A, B, C, dy, dx, ddt, dA_part, dB_part,
                                             dC_part, batch, S, H, heads_per_block, st, s)
                : launch_tc_n<float>(N, x, dt, A, B, C, dy, dx, ddt, dA_part, dB_part,
                                     dC_part, batch, S, H, heads_per_block, st, s);
    return static_cast<int>(err);
  }
  cudaError_t err = is_bf16
      ? launch_p<__nv_bfloat16>(P, N, x, dt, A, B, C, h0, dy, dstate, dx, ddt, dA_part,
                                dB_part, dC_part, dh0, scratch, batch, S, H, chunk, st, s)
      : launch_p<float>(P, N, x, dt, A, B, C, h0, dy, dstate, dx, ddt, dA_part, dB_part,
                        dC_part, dh0, scratch, batch, S, H, chunk, st, s);
  return static_cast<int>(err);
}
