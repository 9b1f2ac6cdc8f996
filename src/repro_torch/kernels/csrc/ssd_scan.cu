// Mamba2 SSD (state-space duality) chunked scan, for sm_90a.
//
// Replaces the TPU kernel src/repro/kernels/ssd_scan.py::_kernel (grid
// (batch, head, chunk) with the chunk axis sequential and the (P, N) state
// carried in VMEM scratch between grid steps). On Hopper blocks run in no
// order, so one thread block owns one (batch, head, tile of the P columns)
// and walks the chunks in order itself, with the state in registers.
//
// Per chunk of `chunk` steps starting at t0, with dA_cum the running sum of
// dt * A inside the chunk (fp32) and dA_total its last value:
//   y_i  = exp(dA_cum_i) (C_i . h_p)                      (carried state)
//        + sum_{j <= i} (C_i . B_j) exp(dA_cum_i - dA_cum_j) dt_j x_j
//   h   <- exp(dA_total) h + sum_j fin_j x_j B_j^T,  fin_j = exp(dA_total - dA_cum_j) dt_j
//
// What bounds it, per launch at the serving shape (1 x 341 steps, 64 heads,
// P = 64, N = 128, chunk 256, bf16): bytes, x, dt, B, C (and h0 when given)
// read once, y and the fp32 state written once: 7.9 MB, 2.37 us at 3.35 TB/s.
// The operations that data needs (C B^T once per chunk, shared by the heads;
// (C B^T o L) x, C h^T and x^T B per head, over the causal part only) come to
// 0.76 GFLOP, 0.8 us on the bf16 tensor cores. The bf16 kernel meets neither:
// it runs ~17 us, held by the latency of each warpgroup's chain of products
// (below), not by bytes or by the tensor cores' rate.
//
// Three kernels, chosen in the wrapper by dtype and, for float32, by the
// shape alone (ssd_scan.forward_route; a launch of one is never retried on
// another):
//
// * bf16, ssd_scan_kernel_wgmma<NPAD>: every product on the tensor cores.
//   Grid (P / 32, H, batch): a block owns 32 columns of P of one head, so
//   at the serving shape 128 blocks fill 128 of the 132 SMs. C B^T does not
//   depend on P, so the two blocks of a head both compute it; one block a
//   head (64 columns, 64 blocks) was timed too and took 18-23 % longer
//   (PERF.md): half the SMs idle cost more than the doubled C B^T.
//   A block is two consumer warpgroups (warps 0-7) and one producer warp
//   (warp 8). A chunk is cut into row blocks of 64 (a chunk of 32 is one row
//   block whose last 32 rows are masked). The producer's first lane loads
//   each row block's C, B and x tiles by TMA into slot J of a ring (one slot
//   per row block of a chunk; 3-D/4-D tensor maps over the strided views,
//   C and B with the 128-byte swizzle, x with the 64-byte one; rows past S
//   come in as zeros), each slot completed on a "full" mbarrier and released
//   on an "empty" one once both warpgroups are done with it, so the next
//   chunk's loads start while the state update of this one runs. The
//   producer's 32 lanes read dt ahead and scan dt * A for the next chunk
//   into a second buffer (dt, dA_cum, fin and dA_total, one mbarrier each).
//   Row block I belongs to warpgroup (I ^ I >> 1) & 1 (0 and 3 to one, 1 and
//   2 to the other: 5 tile pairs each at chunk 256). For row block I:
//     y_I  = C_I h^T (wgmma m64n32k16, A = C_I K-major, B = the state),
//            its rows scaled by exp(dA_cum_i); skipped while h is zero;
//     for J <= I: S = C_I B_J^T (wgmma m64n64k16, both K-major, N / 16
//            steps; the first one runs while the scan may still be going);
//            W = S exp(dA_cum_i - dA_cum_j) dt_j on the accumulator, the
//            exponent masked to i >= j before exp; W goes to registers as
//            the A operand, where the accumulator's fragment already is the
//            A operand's; y_I += W x_J (x_J an MN-major B operand read
//            through the transpose bit, no transposed copy).
//   The state is kept transposed, h^T (N x 32) in fp32 registers, each
//   warpgroup one 64-row half of N (one warpgroup when N <= 64). After every
//   row of the chunk has read the entering state (a named barrier):
//     h^T <- exp(dA_total) h^T + sum_J Bt_J^T x_J,  Bt_j = fin_j B_j,
//   with Bt^T built in registers as the A operand (ldmatrix.trans out of the
//   swizzled B tile, scaled by fin_j) and x_J the same MN-major B operand as
//   above, so nothing is written back to shared memory but the copy of h
//   that the next chunk's C h^T reads. Keeping h transposed is what lets a
//   block own 32 columns of P (n32 products: M = 64 rows of N).
//   Rounding points: the three operands formed inside the kernel, W,
//   Bt = fin o B and the copy of h read by C h^T, each go to the tensor
//   cores as a bf16 head plus the bf16 rounding of what the head leaves out
//   (two products each, 16 bits of mantissa). One bf16 rounding of each was
//   tried first and missed the bf16 tolerance (5e-2 atol and rtol) where y
//   nearly cancels, the more so over eight chunks of carried state. The
//   scan of dt * A, every exponent, every accumulator and the master state
//   are fp32; x, B and C come in as bf16.
//   Padding: N = 16 and 64 are read as one 64-column box (TMA fills the
//   columns past N with zeros, which add nothing to C B^T, C h^T or the
//   state).
//   What still holds it back (PERF.md): within a warpgroup every product
//   waits for the one before (S, then W, then W x), so the tensor cores
//   idle most of the time; the first tiles arrive late, every block reading
//   C and B from L2; the state update runs on both warpgroups at once after
//   the chunk, latency-bound. Overlapping W's math with the next S made
//   ptxas serialize the products and was slower.
//
// * fp32, one chunk (16 <= S <= chunk; fewer steps: the FMA kernel,
//   ssd_scan.TC_MIN_STEPS) from a zero state, P 64, N 64 or 128:
//   ssd_scan_kernel_tf32<N>, every product on the tensor cores in 6xTF32
//   (tf32_mma.cuh, mma6_step: each operand split into three TF32 pieces
//   that sum to it, six mma.sync.m16n8k8 products, each k-step in a fresh
//   accumulator added by a rounding fp32 add, since the tensor cores' adds
//   truncate: over C B^T's 128 columns in one accumulator they erred 5.9x
//   the plain float32 version's error against float64 at s = 1; and one
//   3xTF32 product errs up to 2^-21, which a final state whose last term
//   dominates (A = -16) showed at 3.5x). The running sum of dt * A is
//   taken in float64: an exponent a_i - a_j is the difference of two sums
//   of up to a few thousand, whose float32 roundings are most of the plain
//   float32 version's own error against float64 (tests/test_torch_ssd_forward_tf32.py
//   models the formulas, the scan included, against float64). dA_total is the scan's value
//   at the last step itself, so that fin_{S-1} = dt_{S-1} exactly: in a
//   float32 scan the sum of the lanes' sums differs from it by a rounding,
//   which cost the final state 1e-4 of relative error where its last term
//   dominates (A = -16).
//   Every training call of mamba2-1.3b and zamba2-2.7b at s <= 256 is such
//   a call. The design is the SSD backward's tensor-core kernel's
//   (ssd_scan_bwd.cu): C B^T does not depend on the head, so a block owns hg
//   heads of one sequence, grid (ceil(H / hg), batch), hg the fewest that
//   fit one wave of SMs (mamba2's 8 x 64 heads: 4, 128 blocks; zamba2's 8 x
//   80: 5). 8 consumer warps and a producer warp that stages C_I, B_J and
//   each head's x_J by cp.async into padded rows, on "full" and "empty"
//   mbarriers. Per tile pair (I >= J, row blocks of 64) the block computes
//   S = C_I B_J^T once, 16 rows x 32 columns a warp in registers, and per
//   head forms W = S exp(dA_cum_i - dA_cum_j) dt_j on it (the exponent
//   masked to i >= j before exp), passes W to the other warp of its rows
//   through shared memory (a 64-thread named barrier) and adds W x_J into
//   y_I of each head (registers over J). Then each head's final state
//   h[p][n] = sum_j fin_j x_j[p] B_j[n] over every J, written from the
//   accumulators. The two products over j read their k axis in pair order
//   (tf32_mma.cuh, pair_k), so x_J and B_J, read down their columns, are
//   conflict-free with 16 bytes of padding a row. Shared memory 159.8 KB at
//   N 128: one block an SM. What bounds it at mamba2-1.3b's training shape
//   (b 8, s 128, h 64): bytes, 51 MB (x, dt, B, C and y, the state), 0.0153
//   ms at 3.35 TB/s, against 1.63 GFLOP, 0.0198 ms as 6xTF32 at 495 TFLOP/s.
// * fp32, every other shape (more than one chunk, h0, P 32, N 16, fewer
//   than 16 steps):
//   ssd_scan_kernel_fma<N, R>, the products as fp32 FMAs out of padded
//   shared memory. One block per (batch, head, 32 columns of P), the state
//   in registers and a copy in shared memory; row blocks of R (64, or 32 for
//   chunk 32) visit the column blocks J <= I only, and the state update
//   rides on the last row block.
//
// Ragged S: the steps t >= S of the last chunk are masked in every kernel
// (dt = 0, no input, no store), which is what the reference's padding to a
// chunk multiple computes, so the wrapper copies nothing. No exp(-dA_cum) is
// formed alone: every exponent is <= 0 (for i < j it would be positive and
// overflow, and inf * 0 gives NaN).
//
// Plain C interface: ssd_scan_launch() launches the kernel that its is_bf16
// and tensor_cores arguments name and returns cudaGetLastError().

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "cuda_context.cuh"   // bind_context(), before the bf16 launch's maps are encoded
#include "tf32_mma.cuh"       // 3xTF32 products on mma.sync, cp.async staging

namespace {

constexpr int kMaxChunk = 256;
constexpr int kPT = 32;         // P columns per block, in the bf16 and FMA kernels

struct Strides {   // in elements; p of x and y, n of B and C are contiguous
  int64_t x_b, x_s, x_h;
  int64_t dt_b, dt_s, dt_h;
  int64_t b_b, b_s;
  int64_t c_b, c_s;
  int64_t y_b, y_s, y_h;
};

// =============================================================== fp32, FMA
constexpr int kThreads = 256;   // 8 warps
constexpr int kPad = 4;         // floats of padding per shared-memory row

// Stage rows [0, R) of a (rows, W) matrix whose row r starts at
// src + r * stride (elements; W contiguous) into dst[R][W + kPad];
// rows >= n_rows are zero.
template <int W, int R>
__device__ __forceinline__ void stage_rows(float* dst, const float* src, int64_t stride,
                                           int n_rows) {
  constexpr int VPR = W / 4;              // 16-byte loads per row
  constexpr int LD = W + kPad;
  for (int idx = threadIdx.x; idx < R * VPR; idx += kThreads) {
    const int r = idx / VPR;
    const int c = (idx % VPR) * 4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < n_rows) v = *reinterpret_cast<const float4*>(src + r * stride + c);
    *reinterpret_cast<float4*>(dst + r * LD + c) = v;
  }
}

__device__ __forceinline__ float dot4(const float4& a, const float4& b) {
  return a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
}

template <int N, int R>
constexpr size_t smem_floats() {
  return 2 * R * (N + kPad)        // C and B row blocks
         + kPT * (N + kPad)        // the state
         + R * (kPT + kPad)        // x row block
         + R * (R + kPad)          // weights of one (I, J) tile pair
         + 3 * kMaxChunk           // dt, dA_cum, exp(dA_total - dA_cum) dt
         + kThreads / 32;          // the scan's warp sums
}

// grid (P / 32, H, batch). h0 and state are contiguous (batch, H, P, N), fp32;
// h0 may be null (a zero initial state). One block an SM at least (`, 1`):
// without it ptxas held every instance to 128 registers, and those at N 64
// and 128 with row blocks of 64 (and N 64 with 32) spilled 8-16 bytes.
template <int N, int R>
__global__ void __launch_bounds__(kThreads, 1)
ssd_scan_kernel_fma(const float* __restrict__ x, const float* __restrict__ dt,
                    const float* __restrict__ A, const float* __restrict__ Bm,
                    const float* __restrict__ Cm, const float* __restrict__ h0,
                    float* __restrict__ y, float* __restrict__ state, int S, int H,
                    int P, int chunk, Strides st) {
  constexpr int NP = N + kPad;   // padded row of the C, B and state tiles
  constexpr int XP = kPT + kPad; // padded row of the x tile
  constexpr int WP = R + kPad;   // padded row of the weight tile
  constexpr int SI = R / 16;     // score rows (and columns) per thread
  constexpr int YI = R / 32;     // output rows per thread
  constexpr int HN = N / 8;      // state entries per thread

  extern __shared__ __align__(16) float smem[];
  float* Cs = smem;              // [R][NP]
  float* Bs = Cs + R * NP;       // [R][NP]
  float* Hs = Bs + R * NP;       // [kPT][NP]
  float* Xs = Hs + kPT * NP;     // [R][XP]
  float* Ws = Xs + R * XP;       // [R][WP]
  float* dts = Ws + R * WP;      // [kMaxChunk]
  float* cum = dts + kMaxChunk;  // [kMaxChunk]
  float* fin = cum + kMaxChunk;  // [kMaxChunk] exp(dA_total - dA_cum_j) dt_j
  float* wsum = fin + kMaxChunk; // [kThreads / 32]

  const int p0 = blockIdx.x * kPT;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int tx8 = tid & 7;       // output columns 4 tx8 .. 4 tx8 + 3
  const int ty8 = tid >> 3;      // output rows ty8 + 32 i
  const int tx16 = tid & 15;     // score columns tx16 + 16 j
  const int ty16 = tid >> 4;     // score rows ty16 + 16 i
  const float a = A[h];

  const float* xb = x + b * st.x_b + h * st.x_h + p0;
  const float* dtb = dt + b * st.dt_b + h * st.dt_h;
  const float* Bb = Bm + b * st.b_b;
  const float* Cb = Cm + b * st.c_b;
  float* yb = y + b * st.y_b + h * st.y_h + p0;
  const size_t hoff = (static_cast<size_t>(b * H + h) * P + p0) * N;

  // this thread's part of the state: row p = lane, columns warp + 8 k
  float hreg[HN];
#pragma unroll
  for (int k = 0; k < HN; ++k) {
    hreg[k] = h0 != nullptr ? h0[hoff + lane * N + warp + 8 * k] : 0.f;
    Hs[lane * NP + warp + 8 * k] = hreg[k];
  }

  const int n_chunks = (S + chunk - 1) / chunk;
  for (int c = 0; c < n_chunks; ++c) {
    const int t0 = c * chunk;
    const int valid = min(chunk, S - t0);

    // dA_cum: inclusive scan of dt * A over the chunk, in fp32. Steps at or
    // past S get dt = 0: no input and no decay, as the padded reference.
    const float d = tid < valid ? dtb[static_cast<int64_t>(t0 + tid) * st.dt_s] : 0.f;
    float v = d * a;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float u = __shfl_up_sync(0xffffffffu, v, off);
      if (lane >= off) v += u;
    }
    if (lane == 31) wsum[warp] = v;
    __syncthreads();
    for (int w = 0; w < warp; ++w) v += wsum[w];
    if (tid < chunk) {
      dts[tid] = d;
      cum[tid] = v;
    }
    __syncthreads();
    // dA_total is dA_cum at the chunk's last step, bit for bit, so that its
    // fin is dt exactly: the scan reaches step chunk - 1 by another order of
    // the same sums (the steps past S add zeros), and exp of that rounding
    // put up to 67x the plain float32 version's error against float64 on a
    // final state of three steps (H100, scripts/ssd_float64_survey_torch.py)
    const float total = cum[valid - 1];
    if (tid < chunk) fin[tid] = expf(total - v) * d;   // total - v <= 0
    // fin is read only after the next barrier (the first staging's)

    const bool carried = c > 0 || h0 != nullptr;   // else the state is zero
    const int n_blocks = (valid + R - 1) / R;
    for (int I = 0; I < n_blocks; ++I) {
      const int i0 = I * R;
      stage_rows<N, R>(Cs, Cb + static_cast<int64_t>(t0 + i0) * st.c_s, st.c_s,
                       valid - i0);
      __syncthreads();

      // the carried state's part: exp(dA_cum_i) (C_i . h_p)
      float acc[YI][4];
#pragma unroll
      for (int i = 0; i < YI; ++i)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[i][q] = 0.f;
      if (carried) {
#pragma unroll 4
        for (int n = 0; n < N; n += 4) {
          float4 hv[4];
#pragma unroll
          for (int q = 0; q < 4; ++q)
            hv[q] = *reinterpret_cast<const float4*>(Hs + (4 * tx8 + q) * NP + n);
#pragma unroll
          for (int i = 0; i < YI; ++i) {
            const float4 cv =
                *reinterpret_cast<const float4*>(Cs + (ty8 + 32 * i) * NP + n);
#pragma unroll
            for (int q = 0; q < 4; ++q) acc[i][q] += dot4(cv, hv[q]);
          }
        }
#pragma unroll
        for (int i = 0; i < YI; ++i) {
          const float e = expf(cum[i0 + ty8 + 32 * i]);   // <= 1
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[i][q] *= e;
        }
      }

      // the last row block also carries the state to the chunk's end; every
      // row block has read the entering state from Hs by now or reads it
      // above, and Hs is rewritten only after this loop
      const bool last = I == n_blocks - 1;
      if (last) {
        const float decay = expf(total);
#pragma unroll
        for (int k = 0; k < HN; ++k) hreg[k] *= decay;
      }

      for (int J = 0; J <= I; ++J) {
        const int j0 = J * R;
        const int64_t tj = t0 + j0;
        stage_rows<N, R>(Bs, Bb + tj * st.b_s, st.b_s, valid - j0);
        stage_rows<kPT, R>(Xs, xb + tj * st.x_s, st.x_s, valid - j0);
        __syncthreads();

        // weights W_ij = (C_i . B_j) exp(dA_cum_i - dA_cum_j) dt_j for i >= j
        {
          float s[SI][SI];
#pragma unroll
          for (int i = 0; i < SI; ++i)
#pragma unroll
            for (int j = 0; j < SI; ++j) s[i][j] = 0.f;
#pragma unroll 4
          for (int n = 0; n < N; n += 4) {
            float4 ca[SI], ba[SI];
#pragma unroll
            for (int i = 0; i < SI; ++i)
              ca[i] = *reinterpret_cast<const float4*>(Cs + (ty16 + 16 * i) * NP + n);
#pragma unroll
            for (int j = 0; j < SI; ++j)
              ba[j] = *reinterpret_cast<const float4*>(Bs + (tx16 + 16 * j) * NP + n);
#pragma unroll
            for (int i = 0; i < SI; ++i)
#pragma unroll
              for (int j = 0; j < SI; ++j) s[i][j] += dot4(ca[i], ba[j]);
          }
#pragma unroll
          for (int i = 0; i < SI; ++i) {
            const int gi = i0 + ty16 + 16 * i;
#pragma unroll
            for (int j = 0; j < SI; ++j) {
              const int gj = j0 + tx16 + 16 * j;
              // the exponent is masked, not the result: exp runs for i >= j only
              const float w = gi >= gj ? s[i][j] * expf(cum[gi] - cum[gj]) * dts[gj] : 0.f;
              Ws[(ty16 + 16 * i) * WP + tx16 + 16 * j] = w;
            }
          }
        }
        __syncthreads();

        // y_i += W_ij x_j
#pragma unroll 4
        for (int k = 0; k < R; k += 4) {
          float4 xv[4];
#pragma unroll
          for (int u = 0; u < 4; ++u)
            xv[u] = *reinterpret_cast<const float4*>(Xs + (k + u) * XP + 4 * tx8);
#pragma unroll
          for (int i = 0; i < YI; ++i) {
            const float4 wv = *reinterpret_cast<const float4*>(Ws + (ty8 + 32 * i) * WP + k);
            const float w4[4] = {wv.x, wv.y, wv.z, wv.w};
#pragma unroll
            for (int u = 0; u < 4; ++u) {
              acc[i][0] += w4[u] * xv[u].x;
              acc[i][1] += w4[u] * xv[u].y;
              acc[i][2] += w4[u] * xv[u].z;
              acc[i][3] += w4[u] * xv[u].w;
            }
          }
        }

        // h_p += sum_j x_j[p] exp(dA_total - dA_cum_j) dt_j B_j
        if (last) {
#pragma unroll 4
          for (int j = 0; j < R; ++j) {
            const float xf = Xs[j * XP + lane] * fin[j0 + j];
#pragma unroll
            for (int k = 0; k < HN; ++k) hreg[k] += xf * Bs[j * NP + warp + 8 * k];
          }
        }
        __syncthreads();   // the next step restages Bs, Xs and Ws
      }

#pragma unroll
      for (int i = 0; i < YI; ++i) {
        const int row = i0 + ty8 + 32 * i;
        if (row < valid)
          *reinterpret_cast<float4*>(yb + static_cast<int64_t>(t0 + row) * st.y_s +
                                     4 * tx8) =
              make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
      }
      // the next row block's staging of Cs waits at its barrier for nothing:
      // every read of Cs in this block came before the J loop's last barrier
    }

    // the state leaving this chunk
#pragma unroll
    for (int k = 0; k < HN; ++k) Hs[lane * NP + warp + 8 * k] = hreg[k];
    // read by the next chunk only after its scan's barriers
  }

#pragma unroll
  for (int k = 0; k < HN; ++k) state[hoff + lane * N + warp + 8 * k] = hreg[k];
}

template <int N, int R>
cudaError_t launch_fma(const void* x, const void* dt, const void* A, const void* B,
                       const void* C, const void* h0, void* y, void* state, int batch,
                       int S, int H, int P, int chunk, const Strides& st,
                       cudaStream_t stream) {
  constexpr size_t smem = sizeof(float) * smem_floats<N, R>();
  // more than the 48 KB a block gets without asking at the widest shapes
  cudaError_t err = cudaFuncSetAttribute(ssd_scan_kernel_fma<N, R>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(P / kPT, H, batch);
  ssd_scan_kernel_fma<N, R><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const float*>(B),
      static_cast<const float*>(C), static_cast<const float*>(h0),
      static_cast<float*>(y), static_cast<float*>(state), S, H, P, chunk, st);
  return cudaGetLastError();
}

template <int N>
cudaError_t launch_fma_r(const void* x, const void* dt, const void* A, const void* B,
                         const void* C, const void* h0, void* y, void* state, int batch,
                         int S, int H, int P, int chunk, const Strides& st,
                         cudaStream_t stream) {
  if (chunk == 32)
    return launch_fma<N, 32>(x, dt, A, B, C, h0, y, state, batch, S, H, P, chunk, st,
                             stream);
  return launch_fma<N, 64>(x, dt, A, B, C, h0, y, state, batch, S, H, P, chunk, st,
                           stream);
}

// ============================================================ bf16, wgmma
constexpr int kRows = 64;                  // rows of a row block and of a TMA box
constexpr int kConsumers = 256;            // two consumer warpgroups
constexpr int kWgThreads = kConsumers + 32;   // and one producer warp
constexpr int kBox = 64 * 64 * 2;          // bytes of one 64-row x 64-column bf16 box
constexpr int kScan = 3 * kMaxChunk + 4;   // floats of one scan buffer
constexpr float kMasked = -1e30f;          // exponent of a masked weight: exp gives 0

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

__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3),
      "r"(bar)
      : "memory");
}

// the two consumer warpgroups, without the producer warp
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
}

// Byte offset of byte `off` of a tile whose rows are `row_bytes` (128 or 64)
// wide, as TMA's 128- or 64-byte swizzle stores it (the tile starts on a
// 1024-byte boundary): the 16-byte chunk index is XORed with the row's.
template <int row_bytes>
__device__ __forceinline__ uint32_t swz(uint32_t off) {
  return off ^ ((off >> 3) & (row_bytes == 128 ? 0x70u : 0x30u));
}

// wgmma shared-memory descriptor of a swizzled operand with rows of
// `row_bytes` (128: 128-byte swizzle, 64: 64-byte swizzle), groups of 8 rows
// one after another: K-major (C, B) or, with the transpose bit, MN-major
// (x, the bf16 state). The leading offset is unused for both.
template <int row_bytes>
__device__ __forceinline__ uint64_t desc(uint32_t addr) {
  uint64_t d = static_cast<uint64_t>((addr & 0x3FFFF) >> 4);
  d |= static_cast<uint64_t>(1) << 16;                       // leading (unused)
  d |= static_cast<uint64_t>((8 * row_bytes) >> 4) << 32;    // 8 rows apart
  d |= static_cast<uint64_t>(row_bytes == 128 ? 1 : 2) << 62;
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
template <int R>
__device__ __forceinline__ void fence_regs(float (&r)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

#define REPRO_D16(d)                                                                 \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),            \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),      \
      "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
#define REPRO_D32(d)                                                                 \
  REPRO_D16(d), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),     \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]),  \
      "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
#define REPRO_R16                                                                    \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}"
#define REPRO_R32                                                                    \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "          \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"

// S (64 x 64, fp32) = or += A (64 x 16) B^T, A and B (64 x 16) K-major in
// shared memory
__device__ __forceinline__ void wgmma_kk(float (&d)[32], uint64_t da, uint64_t db,
                                         int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " REPRO_R32
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : REPRO_D32(d)
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x 32, fp32) = or += A (64 x 16, K-major in shared memory) B (16 x 32,
// MN-major in shared memory): C h^T
__device__ __forceinline__ void wgmma_sm(float (&d)[16], uint64_t da, uint64_t db,
                                         int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 " REPRO_R16
      ", %16, %17, p, 1, 1, 0, 1;\n}\n"
      : REPRO_D16(d)
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x 32, fp32) += A (64 x 16, bf16 in registers) B (16 x 32, MN-major in
// shared memory): W x and Bt^T x
__device__ __forceinline__ void wgmma_rm(float (&d)[16], const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 " REPRO_R16
      ", {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : REPRO_D16(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
#undef REPRO_D16
#undef REPRO_D32
#undef REPRO_R16
#undef REPRO_R32

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);   // lo in the low half
  return *reinterpret_cast<const uint32_t*>(&v);
}

// (lo, hi) as a pair of bf16 values `head` and the pair of their rounding
// errors, rounded to bf16 again, `tail`: head + tail holds 16 bits of each
__device__ __forceinline__ void split_bf16x2(float lo, float hi, uint32_t& head,
                                             uint32_t& tail) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  head = *reinterpret_cast<const uint32_t*>(&v);
  tail = pack_bf16(lo - __low2float(v), hi - __high2float(v));
}

// grid (P / 32, H, batch), 288 threads: consumer warpgroups 0 and 1 (warps
// 0-7), producer warp 8. h0 and state are contiguous (batch, H, P, N), fp32;
// h0 may be null (a zero initial state). Accumulator fragment of thread
// (warp w of its warpgroup, lane l): register k holds row
// 16 w + l/4 + 8 ((k/2) % 2), column 8 (k/4) + 2 (l%4) + k%2.
template <int NPAD>
__global__ void __launch_bounds__(kWgThreads, 1)
ssd_scan_kernel_wgmma(const __grid_constant__ CUtensorMap tm_x,
                      const __grid_constant__ CUtensorMap tm_b,
                      const __grid_constant__ CUtensorMap tm_c,
                      const float* __restrict__ dt, const float* __restrict__ A,
                      const float* __restrict__ h0, __nv_bfloat16* __restrict__ y,
                      float* __restrict__ state, int S, int H, int P, int N, int chunk,
                      int64_t dt_b, int64_t dt_s, int64_t dt_h, int64_t y_b,
                      int64_t y_s, int64_t y_h) {
  constexpr int NBN = NPAD / 64;         // 64-column boxes of a C or B row block
  constexpr int kCB = NBN * kBox;        // bytes of a C (or B) row block
  constexpr int XRB = kPT * 2;           // bytes of a row of x and of the bf16 state
  constexpr int kX = kRows * XRB;        // bytes of an x row block
  constexpr int NACC = kPT / 2;          // registers of a 64 x 32 accumulator
  constexpr int KS = NPAD / 16;          // k-steps over N

  __shared__ __align__(8) uint64_t bars[10];   // full[4], empty[4], scan[2]
  extern __shared__ __align__(16) uint8_t smem_raw[];
  const int slots = max(chunk, kRows) / kRows;
  // the 128-byte swizzle repeats every 1024 bytes: align the tiles to it
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t c_s = base;                       // + J * kCB
  const uint32_t b_s = c_s + slots * kCB;          // + J * kCB
  const uint32_t x_s = b_s + slots * kCB;          // + J * kX
  const uint32_t h_s = x_s + slots * kX;           // head, tail: NPAD rows x 32, bf16
  constexpr int kH = NPAD * XRB;                   // bytes of one copy of h^T
  uint8_t* const hs = smem_raw + (h_s - raw);
  float* const scan = reinterpret_cast<float*>(hs + 2 * kH);   // 2 x kScan

  const int p0 = blockIdx.x * kPT;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int n_chunks = (S + chunk - 1) / chunk;
  auto full = [&](int J) { return smem_u32(&bars[J]); };
  auto empty = [&](int J) { return smem_u32(&bars[4 + J]); };
  auto scanned = [&](int c) { return smem_u32(&bars[8 + (c & 1)]); };

  if (threadIdx.x == 0) {
    for (int J = 0; J < 4; ++J) {
      mbar_init(full(J), 1);
      mbar_init(empty(J), kConsumers);
    }
    mbar_init(scanned(0), 32);
    mbar_init(scanned(1), 32);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 8) {   // ---- producer
    const float a = A[h];
    const float* dtb = dt + b * dt_b + h * dt_h;
    const int rpl = max(chunk, kRows) / 32;   // scan rows per lane
    float d[8];   // this lane's dt of the chunk scanned next
    auto load_dt = [&](int cc) {
      const int t0 = cc * chunk;
      const int valid = min(chunk, S - t0);
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const int row = lane * rpl + r;
        d[r] = r < rpl && row < valid ? dtb[static_cast<int64_t>(t0 + row) * dt_s] : 0.f;
      }
    };
    // dt, dA_cum, fin and dA_total of chunk cc (its dt in d) into scan buffer cc & 1
    auto scan_chunk = [&](int cc) {
      float* buf = scan + (cc & 1) * kScan;
      float v[8], run = 0.f;
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        run += d[r] * a;
        v[r] = run;
      }
      float incl = run;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float u = __shfl_up_sync(0xffffffffu, incl, off);
        if (lane >= off) incl += u;
      }
      const float excl = incl - run;
      const float total = __shfl_sync(0xffffffffu, incl, 31);
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        if (r >= rpl) break;
        const int row = lane * rpl + r;
        const float cum = v[r] + excl;
        buf[row] = d[r];
        buf[kMaxChunk + row] = cum;
        buf[2 * kMaxChunk + row] = __expf(total - cum) * d[r];   // total - cum <= 0
      }
      if (lane == 0) buf[3 * kMaxChunk] = total;
      mbar_arrive(scanned(cc));
    };

    load_dt(0);   // in flight while the first loads are issued
    for (int c = 0; c < n_chunks; ++c) {
      const int t0 = c * chunk;
      const int nb = (min(chunk, S - t0) + kRows - 1) / kRows;
      if (lane == 0) {
        for (int J = 0; J < nb; ++J) {
          // every chunk but the last fills every slot, so slot J's last use
          // was chunk c - 1
          if (c > 0) mbar_wait(empty(J), (c - 1) & 1);
          mbar_expect_tx(full(J), 2 * kCB + kX);
          for (int q = 0; q < NBN; ++q) {
            tma_load_3d(c_s + J * kCB + q * kBox, &tm_c, full(J), 64 * q, t0 + kRows * J, b);
            tma_load_3d(b_s + J * kCB + q * kBox, &tm_b, full(J), 64 * q, t0 + kRows * J, b);
          }
          tma_load_4d(x_s + J * kX, &tm_x, full(J), p0, t0 + kRows * J, h, b);
        }
      }
      __syncwarp();
      // the buffer of chunk c + 1 was last read in chunk c - 1, which every
      // consumer has finished: lane 0 saw its slots released above
      if (c == 0) {
        scan_chunk(0);
        if (n_chunks > 1) load_dt(1);
      }
      if (c + 1 < n_chunks) {
        scan_chunk(c + 1);
        if (c + 2 < n_chunks) load_dt(c + 2);   // in flight until the next scan
      }
    }
    return;
  }

  // ---- consumers
  const int wg = warp >> 2;
  const int wq = warp & 3;
  const int r0 = wq * 16 + (lane >> 2);   // rows r0 and r0 + 8 of a fragment
  const int cq = (lane & 3) * 2;
  const bool holds_state = NPAD == 128 || wg == 0;
  const int n0 = 64 * wg;                 // first row of h^T this warpgroup holds
  const size_t hoff = static_cast<size_t>(b * H + h) * P * N;
  __nv_bfloat16* const yb = y + b * y_b + h * y_h + p0;

  // this warpgroup's 64 rows of h^T, fp32: register k is (n, p) =
  // (n0 + r0 + 8 ((k/2) % 2), 8 (k/4) + cq + k%2)
  float hacc[NACC];
  auto h_index = [&](int k) {
    const int n = n0 + r0 + 8 * ((k >> 1) & 1);
    const int p = p0 + 8 * (k >> 2) + cq + (k & 1);
    return hoff + static_cast<size_t>(p) * N + n;
  };
  auto h_row_ok = [&](int k) { return n0 + r0 + 8 * ((k >> 1) & 1) < N; };
  // h^T as two bf16 copies, head and tail, read by C h^T as MN-major (rows
  // n, columns p) B operands
  auto write_hs = [&]() {
#pragma unroll
    for (int k = 0; k < NACC; k += 2) {
      const int n = n0 + r0 + 8 * ((k >> 1) & 1);
      const int p = 8 * (k >> 2) + cq;
      const uint32_t off = swz<64>(n * XRB + 2 * p);
      split_bf16x2(hacc[k], hacc[k + 1], *reinterpret_cast<uint32_t*>(hs + off),
                   *reinterpret_cast<uint32_t*>(hs + kH + off));
    }
    // generic stores, read next by wgmma (the async proxy)
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  };

#pragma unroll
  for (int k = 0; k < NACC; ++k)
    hacc[k] = holds_state && h0 != nullptr && h_row_ok(k) ? h0[h_index(k)] : 0.f;
  if (h0 != nullptr) {
    if (holds_state) write_hs();
    consumers_sync();
  }

  for (int c = 0; c < n_chunks; ++c) {
    const int t0 = c * chunk;
    const int valid = min(chunk, S - t0);
    const int nb = (valid + kRows - 1) / kRows;
    const uint32_t ph = c & 1;
    const bool carried = c > 0 || h0 != nullptr;   // else h is zero
    const float* dts = scan + (c & 1) * kScan;
    const float* cum = dts + kMaxChunk;
    const float* fin = cum + kMaxChunk;

    for (int I = 0; I < nb; ++I) {
      if (((I ^ (I >> 1)) & 1) != wg) continue;
      mbar_wait(full(I), ph);
      const int i0 = kRows * I + r0;      // rows i0 and i0 + 8 of the chunk
      const uint32_t c_tile = c_s + I * kCB;

      float acc[NACC];
#pragma unroll
      for (int k = 0; k < NACC; ++k) acc[k] = 0.f;
      if (carried) {   // y_I = exp(dA_cum_i) (C_I h^T), scaled below
        fence_regs(acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < KS; ++kk) {
          const uint64_t da = desc<128>(c_tile + (kk >> 2) * kBox + (kk & 3) * 32);
          wgmma_sm(acc, da, desc<64>(h_s + kk * 16 * XRB), kk > 0);
          wgmma_sm(acc, da, desc<64>(h_s + kH + kk * 16 * XRB), 1);
        }
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(acc);
      }

      for (int J = 0; J <= I; ++J) {
        if (J < I) mbar_wait(full(J), ph);
        // S = C_I B_J^T over N
        float s[32];
#pragma unroll
        for (int k = 0; k < 32; ++k) s[k] = 0.f;
        fence_regs(s);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < KS; ++kk) {
          const uint32_t off = (kk >> 2) * kBox + (kk & 3) * 32;
          wgmma_kk(s, desc<128>(c_tile + off), desc<128>(b_s + J * kCB + off), kk > 0);
        }
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(s);
        // the producer's scan of dt * A ran while the first products did
        if (J == 0) mbar_wait(scanned(c), (c >> 1) & 1);
        const float ci0 = cum[i0], ci1 = cum[i0 + 8];
        if (J == 0 && carried) {
          const float e0 = __expf(ci0), e1 = __expf(ci1);   // <= 1
#pragma unroll
          for (int k = 0; k < NACC; ++k) acc[k] *= (k & 2) ? e1 : e0;
        }

        // W = S exp(dA_cum_i - dA_cum_j) dt_j, the exponent masked to i >= j
        // on the diagonal tile, split into bf16 head and tail as the A
        // operands of W x_J
        const bool diag = J == I;
        uint32_t wa[4][4], wt[4][4];
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          const int j = kRows * J + 8 * q + cq;   // columns j and j + 1
          const float2 cj = *reinterpret_cast<const float2*>(cum + j);
          const float2 dj = *reinterpret_cast<const float2*>(dts + j);
          const int il = r0 - 8 * q - cq;         // row - column, inside the tile
          const float w0 = s[4 * q + 0] * __expf(!diag || il >= 0 ? ci0 - cj.x : kMasked) * dj.x;
          const float w1 = s[4 * q + 1] * __expf(!diag || il >= 1 ? ci0 - cj.y : kMasked) * dj.y;
          const float w2 = s[4 * q + 2] * __expf(!diag || il >= -8 ? ci1 - cj.x : kMasked) * dj.x;
          const float w3 = s[4 * q + 3] * __expf(!diag || il >= -7 ? ci1 - cj.y : kMasked) * dj.y;
          // columns 16 kk .. 16 kk + 15 are the A fragment of step kk
          split_bf16x2(w0, w1, wa[q >> 1][(q & 1) * 2], wt[q >> 1][(q & 1) * 2]);
          split_bf16x2(w2, w3, wa[q >> 1][(q & 1) * 2 + 1], wt[q >> 1][(q & 1) * 2 + 1]);
        }
        // y_I += W x_J: 4 steps of 16 rows of x_J
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const uint64_t db = desc<64>(x_s + J * kX + kk * 16 * XRB);
          wgmma_rm(acc, wa[kk], db);
          wgmma_rm(acc, wt[kk], db);
        }
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(acc);
      }

#pragma unroll
      for (int k = 0; k < NACC; k += 2) {
        const int row = i0 + 8 * ((k >> 1) & 1);
        if (row < valid)
          *reinterpret_cast<uint32_t*>(yb + static_cast<int64_t>(t0 + row) * y_s +
                                       8 * (k >> 2) + cq) = pack_bf16(acc[k], acc[k + 1]);
      }
    }

    consumers_sync();   // every row of the chunk has read the entering h

    if (holds_state) {
      // h^T <- exp(dA_total) h^T + sum_J Bt_J^T x_J, Bt_j = fin_j B_j: the
      // A operand (rows n, columns j) comes from B_J's box of this
      // warpgroup's n through ldmatrix.trans, scaled by fin_j in registers
      mbar_wait(scanned(c), (c >> 1) & 1);   // a warpgroup may own no row block
      const float decay = __expf(dts[3 * kMaxChunk]);
#pragma unroll
      for (int k = 0; k < NACC; ++k) hacc[k] *= decay;
      fence_regs(hacc);
      // lane l gives the address of row l % 8 of 8 x 8 matrix l / 8: rows
      // j + 8 (l / 16), 16-byte column chunk 2 wq + (l / 8) % 2 of the box
      const int lj = (lane & 7) + 8 * (lane >> 4);
      const int lchunk = 2 * wq + ((lane >> 3) & 1);
      for (int J = 0; J < nb; ++J) {
        mbar_wait(full(J), ph);
        const uint32_t bt = b_s + J * kCB + wg * kBox;
        uint32_t ba[4][4], bb[4][4];   // Bt^T, head and tail
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const int jr = 16 * kk + lj;
          const uint32_t addr = bt + swz<128>(jr * 128 + lchunk * 16);
          uint32_t u[4];
          asm volatile(
              "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
              : "=r"(u[0]), "=r"(u[1]), "=r"(u[2]), "=r"(u[3])
              : "r"(addr));
          // registers 0, 1 hold columns j = 16 kk + cq, + 1; 2, 3 those + 8
          const float2 f0 = *reinterpret_cast<const float2*>(fin + kRows * J + 16 * kk + cq);
          const float2 f8 = *reinterpret_cast<const float2*>(fin + kRows * J + 16 * kk + 8 + cq);
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const float2 f = r < 2 ? f0 : f8;
            split_bf16x2(__uint_as_float(u[r] << 16) * f.x,
                         __uint_as_float(u[r] & 0xffff0000u) * f.y, ba[kk][r], bb[kk][r]);
          }
        }
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const uint64_t db = desc<64>(x_s + J * kX + kk * 16 * XRB);
          wgmma_rm(hacc, ba[kk], db);
          wgmma_rm(hacc, bb[kk], db);
        }
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(hacc);
        mbar_arrive(empty(J));   // slot J may be loaded with the next chunk
      }
      if (c + 1 < n_chunks) write_hs();
    } else {
      for (int J = 0; J < nb; ++J) mbar_arrive(empty(J));
    }
    consumers_sync();   // the next chunk reads the new bf16 copy of h
  }

  if (holds_state) {
#pragma unroll
    for (int k = 0; k < NACC; ++k)
      if (h_row_ok(k)) state[h_index(k)] = hacc[k];
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

// A bf16 map of `rank` dimensions (innermost first) with element strides for
// dimensions 1.., boxes of `box`, out-of-bounds elements read as 0.
CUresult encode_map(CUtensorMap* map, const void* base, int rank, const int64_t* dims,
                    const int64_t* strides, const cuuint32_t* box,
                    CUtensorMapSwizzle swizzle) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return CUDA_ERROR_NOT_FOUND;
  cuuint64_t d[4], s[3];
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  for (int i = 0; i < rank; ++i) d[i] = static_cast<cuuint64_t>(dims[i]);
  // the coordinate of a dimension of extent 1 is always 0: any legal stride
  for (int i = 1; i < rank; ++i)
    s[i - 1] = static_cast<cuuint64_t>(dims[i] == 1 ? strides[0] : strides[i - 1]) * 2;
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, const_cast<void*>(base), d, s,
            box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

template <int NPAD>
constexpr int wgmma_smem(int slots) {
  return 1024 + slots * (2 * (NPAD / 64) * kBox + kRows * kPT * 2) + 2 * NPAD * kPT * 2 +
         2 * kScan * static_cast<int>(sizeof(float));
}

template <int NPAD>
int launch_wgmma(const void* x, const void* dt, const void* A, const void* B,
                 const void* C, const void* h0, void* y, void* state, int batch, int S,
                 int H, int P, int N, int chunk, const Strides& st, cudaStream_t stream) {
  CUtensorMap tm_x, tm_b, tm_c;
  const int64_t x_dims[4] = {P, S, H, batch};
  const int64_t x_strides[3] = {st.x_s, st.x_h, st.x_b};
  const cuuint32_t x_box[4] = {kPT, kRows, 1, 1};
  const int64_t bc_dims[3] = {N, S, batch};
  const int64_t b_strides[2] = {st.b_s, st.b_b};
  const int64_t c_strides[2] = {st.c_s, st.c_b};
  const cuuint32_t bc_box[3] = {64, kRows, 1};
  // a recomputed forward (remat) runs on the autograd engine's device thread
  CUresult res = bind_context();
  if (res == CUDA_SUCCESS)
    res = encode_map(&tm_x, x, 4, x_dims, x_strides, x_box, CU_TENSOR_MAP_SWIZZLE_64B);
  if (res == CUDA_SUCCESS)
    res = encode_map(&tm_b, B, 3, bc_dims, b_strides, bc_box, CU_TENSOR_MAP_SWIZZLE_128B);
  if (res == CUDA_SUCCESS)
    res = encode_map(&tm_c, C, 3, bc_dims, c_strides, bc_box, CU_TENSOR_MAP_SWIZZLE_128B);
  if (res != CUDA_SUCCESS) return -static_cast<int>(res);
  const cudaError_t err = cudaFuncSetAttribute(ssd_scan_kernel_wgmma<NPAD>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               wgmma_smem<NPAD>(4));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(P / kPT, H, batch);
  ssd_scan_kernel_wgmma<NPAD>
      <<<grid, kWgThreads, wgmma_smem<NPAD>(max(chunk, kRows) / kRows), stream>>>(
          tm_x, tm_b, tm_c, static_cast<const float*>(dt), static_cast<const float*>(A),
          static_cast<const float*>(h0), static_cast<__nv_bfloat16*>(y),
          static_cast<float*>(state), S, H, P, N, chunk, st.dt_b, st.dt_s, st.dt_h,
          st.y_b, st.y_s, st.y_h);
  return static_cast<int>(cudaGetLastError());
}

// ====================================================== fp32, 3xTF32 mma.sync
constexpr int kTfWarps = 8;                       // consumer warps
constexpr int kTfThreads = (kTfWarps + 1) * 32;   // and one producer warp
constexpr int kTfP = 64;                          // the P the instances take
constexpr int kTfMaxHeads = 5;                    // heads a block, at most
constexpr int kWP = kRows + 8;                    // floats a row of W

// the two consumer warps that share rows 16 rg .. of a tile
__device__ __forceinline__ void pair_sync(int rg) {
  asm volatile("bar.sync %0, 64;\n" ::"r"(2 + rg) : "memory");
}

// Shared memory of the fp32 one-chunk kernel: eight mbarriers; a (double),
// dt and fin of each head; W (two buffers); the C_I and B_J tiles (rows of N
// + 4 floats); two x_J slots (rows of P + 4 floats). 159,808 bytes at N 128:
// one block an SM.
template <int N>
constexpr size_t tf32_smem() {
  return 64 + sizeof(double) * kTfMaxHeads * kMaxChunk +
         sizeof(float) * (2 * kTfMaxHeads * kMaxChunk + 2 * kRows * kWP +
                          2 * kRows * (N + 4) + 2 * kRows * (kTfP + 4));
}

// grid (ceil(H / hg), batch), 288 threads: a block owns heads hg b .. of
// sequence b (fewer in the last group): consumer warps 0-7, producer warp 8.
// One chunk (S <= kMaxChunk) from a zero state. y (b, S, H, P) through its
// strides; state (b, H, P, N) contiguous.
template <int N>
__global__ void __launch_bounds__(kTfThreads, 1)
ssd_scan_kernel_tf32(const float* __restrict__ x, const float* __restrict__ dt,
                     const float* __restrict__ A, const float* __restrict__ Bm,
                     const float* __restrict__ Cm, float* __restrict__ y,
                     float* __restrict__ state, int S, int H, int hg, Strides st) {
  constexpr int LN = N + 4;       // floats a row of the C and B tiles
  constexpr int LX = kTfP + 4;    // of the x tiles
  constexpr int NH = N / 2;       // state columns a warp
  extern __shared__ __align__(16) unsigned char smem_tf[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem_tf);     // 8 mbarriers
  double* av = reinterpret_cast<double*>(smem_tf + 64);      // [kTfMaxHeads][kMaxChunk] dA_cum
  float* dtv = reinterpret_cast<float*>(av + kTfMaxHeads * kMaxChunk);   // dt
  float* finv = dtv + kTfMaxHeads * kMaxChunk;               // exp(dA_total - dA_cum) dt
  float* Wb = finv + kTfMaxHeads * kMaxChunk;                // [2][kRows][kWP]
  float* Cs = Wb + 2 * kRows * kWP;                          // [kRows][LN]
  float* Bs = Cs + kRows * LN;                               // [kRows][LN]
  float* Xs = Bs + kRows * LN;                               // [2][kRows][LX]
  // "full" barriers 0-3 (C_I, B_J, the two x slots), completed by the
  // producer's 32 lanes; "empty" barriers 4-7 (the same buffers), one arrival
  // a consumer warp
  constexpr int kFullC = 0, kFullB = 1, kFullX = 2, kEmptyC = 4, kEmptyB = 5, kEmptyX = 6;
  auto bar = [&](int i) { return smem_u32(bars + i); };

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int b = blockIdx.y, hb = blockIdx.x * hg;
  const int nh = min(hg, H - hb);
  const int nb = (S + kRows - 1) / kRows;

  if (tid == 0) {
    for (int i = 0; i < 8; ++i) mbar_init(bar(i), i < kEmptyC ? 32 : kTfWarps);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // ---- the producer warp: the tiles, in the order the consumers use them
  if (warp == kTfWarps) {
    int ub = 0, ux = 0;
    auto load_b = [&](int j0) {
      if (ub > 0) mbar_wait(bar(kEmptyB), (ub - 1) & 1);
      cp_async_rows<kRows, N, LN>(Bs, Bm + b * st.b_b + j0 * st.b_s, st.b_s, S - j0);
      cp_async_arrive(bar(kFullB));
      ++ub;
    };
    auto load_x = [&](int hh, int j0) {
      const int slot = ux & 1, use = ux >> 1;
      if (use > 0) mbar_wait(bar(kEmptyX + slot), (use - 1) & 1);
      cp_async_rows<kRows, kTfP, LX>(Xs + slot * kRows * LX,
                                     x + b * st.x_b + j0 * st.x_s + (hb + hh) * st.x_h,
                                     st.x_s, S - j0);
      cp_async_arrive(bar(kFullX + slot));
      ++ux;
    };
    // y: C_I, then per J <= I B_J and each head's x_J
    for (int I = 0; I < nb; ++I) {
      const int i0 = I * kRows;
      if (I > 0) mbar_wait(bar(kEmptyC), (I - 1) & 1);
      cp_async_rows<kRows, N, LN>(Cs, Cm + b * st.c_b + i0 * st.c_s, st.c_s, S - i0);
      cp_async_arrive(bar(kFullC));
      for (int J = 0; J <= I; ++J) {
        load_b(J * kRows);
        for (int hh = 0; hh < nh; ++hh) load_x(hh, J * kRows);
      }
    }
    // the final states: per head, each J's B_J and x_J
    for (int hh = 0; hh < nh; ++hh)
      for (int J = 0; J < nb; ++J) {
        load_b(J * kRows);
        load_x(hh, J * kRows);
      }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    return;
  }

  // ---- the consumer warps
  const int rg = warp & 3, half = warp >> 2, g = lane >> 2, t = lane & 3;
  if (warp < nh) {   // dA_cum, the running sum of dt * A over the chunk, head hb + warp
    // in float64: an exponent is a difference a_i - a_j of two running sums
    // of up to a few thousand, and in float32 their roundings (a unit of
    // 7.6e-6 at 100) cost exp(a_i - a_j) more than every product of the
    // kernel together (the plain float32 version's error against float64 is
    // mostly that); each product dt * A is exact in float64
    const int h = hb + warp;
    const double ah = A[h];
    float d[8];
    double v[8], run = 0.0;
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int kq = 8 * lane + q;   // steps at or past S: dt = 0
      d[q] = kq < S ? dt[b * st.dt_b + kq * st.dt_s + h * st.dt_h] : 0.f;
      run += static_cast<double>(d[q]) * ah;
      v[q] = run;
    }
    double incl = run;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const double u = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl += u;
    }
    // dA_total is dA_cum at the last step, bit for bit: fin_{S-1} = dt_{S-1}
    // exactly, as in the plain version
    const double total = __shfl_sync(0xffffffffu, v[7] + incl - run, (S - 1) >> 3);
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int kq = warp * kMaxChunk + 8 * lane + q;
      const double cum = v[q] + incl - run;
      av[kq] = cum;
      dtv[kq] = d[q];
      finv[kq] = expf(static_cast<float>(total - cum)) * d[q];   // total - cum <= 0
    }
  }
  consumers_sync();

  // y_I = sum_{J <= I} W_IJ x_J, W_ij = (C_i . B_j) exp(dA_cum_i - dA_cum_j) dt_j
  // for i >= j. A warp owns rows 16 rg .. of a tile pair and its columns 32
  // half ..: S = C_I B_J^T (shared by the heads) in registers, W of each head
  // formed from it and exchanged through shared memory with the other warp
  // of the rows, and y_I of each head's rows 16 rg .., columns p 32 half ..
  // in registers over J.
  int ub = 0, ux = 0;
  for (int I = 0; I < nb; ++I) {
    const int i0 = I * kRows;
    mbar_wait(bar(kFullC), I & 1);
    float ya[kTfMaxHeads][4][4];
#pragma unroll
    for (int hh = 0; hh < kTfMaxHeads; ++hh)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int r = 0; r < 4; ++r) ya[hh][nt][r] = 0.f;
    const int il = 16 * rg + g;             // the thread's rows il and il + 8
    for (int J = 0; J <= I; ++J) {
      const int j0 = J * kRows;
      mbar_wait(bar(kFullB), ub & 1);
      float sc[4][4];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int r = 0; r < 4; ++r) sc[nt][r] = 0.f;
      {
        const float* Ca = Cs + 16 * rg * LN;
        const float* Bb = Bs + 32 * half * LN;
        warp_mma6<4, N, false, false>(sc, [&](int m, int k) { return Ca[m * LN + k]; },
                                      [&](int k, int n) { return Bb[n * LN + k]; });
      }
      __syncwarp();
      if (lane == 0) {
        mbar_arrive(bar(kEmptyB));                 // B_J free
        if (J == I) mbar_arrive(bar(kEmptyC));     // C_I free
      }
      ++ub;
#pragma unroll
      for (int hh = 0; hh < kTfMaxHeads; ++hh) {
        if (hh < nh) {
          const int slot = ux & 1;
          const double* a = av + hh * kMaxChunk;
          const float* dtp = dtv + hh * kMaxChunk;
          float* W = Wb + slot * kRows * kWP;
          const double ai[2] = {a[i0 + il], a[i0 + il + 8]};
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) {
            const int jl = 32 * half + 8 * nt + 2 * t;   // the thread's columns jl, jl + 1
#pragma unroll
            for (int ir = 0; ir < 2; ++ir) {
              float w[2];
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const int gj = j0 + jl + e;
                // the exponent is formed for i >= j only: for i < j it is positive
                w[e] = i0 + il + 8 * ir >= gj
                           ? sc[nt][2 * ir + e] * expf(static_cast<float>(ai[ir] - a[gj])) * dtp[gj]
                           : 0.f;
              }
              *reinterpret_cast<float2*>(W + (il + 8 * ir) * kWP + jl) = make_float2(w[0], w[1]);
            }
          }
          pair_sync(rg);   // both halves of W's rows 16 rg .. are written
          mbar_wait(bar(kFullX + slot), (ux >> 1) & 1);
          // y_I += W x_J, k (= j) in pair order: W's columns 2t, 2t + 1 of a
          // k-step are one float2, x_J's rows 2t, 2t + 1 conflict-free
          // (6xTF32, each k-step in a fresh accumulator added by a rounding
          // fp32 add, as warp_mma6)
          const float* xs = Xs + slot * kRows * LX + 32 * half + g;
          const float* Wr = W + il * kWP + 2 * t;
#pragma unroll 1
          for (int k0 = 0; k0 < kRows; k0 += 8) {
            const float2 w0 = *reinterpret_cast<const float2*>(Wr + k0);
            const float2 w8 = *reinterpret_cast<const float2*>(Wr + 8 * kWP + k0);
            const float a4[4] = {w0.x, w8.x, w0.y, w8.y};
            float bv[4][2];
#pragma unroll
            for (int nt = 0; nt < 4; ++nt) {
              bv[nt][0] = xs[(k0 + 2 * t) * LX + 8 * nt];
              bv[nt][1] = xs[(k0 + 2 * t + 1) * LX + 8 * nt];
            }
            float part[4][4];
#pragma unroll
            for (int nt = 0; nt < 4; ++nt)
#pragma unroll
              for (int r = 0; r < 4; ++r) part[nt][r] = 0.f;
            mma6_step<4, false, false>(part, a4, bv);
#pragma unroll
            for (int nt = 0; nt < 4; ++nt)
#pragma unroll
              for (int r = 0; r < 4; ++r) ya[hh][nt][r] += part[nt][r];
          }
          __syncwarp();
          if (lane == 0) mbar_arrive(bar(kEmptyX + slot));   // x slot free
          ++ux;
        }
      }
    }
#pragma unroll
    for (int hh = 0; hh < kTfMaxHeads; ++hh) {
      if (hh < nh) {
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int ir = 0; ir < 2; ++ir) {
            const int i = i0 + il + 8 * ir;
            if (i < S)
              *reinterpret_cast<float2*>(y + b * st.y_b + i * st.y_s + (hb + hh) * st.y_h +
                                         32 * half + 8 * nt + 2 * t) =
                  make_float2(ya[hh][nt][2 * ir], ya[hh][nt][2 * ir + 1]);
          }
      }
    }
  }

  // the final state of each head, h[p][n] = sum_j fin_j x_j[p] B_j[n]: rows
  // p 16 rg .., columns n NH half .., over every J; k (= j) in pair order,
  // so that both operands, read down their columns, are conflict-free
  for (int hh = 0; hh < nh; ++hh) {
    float hs[NH / 8][4];
#pragma unroll
    for (int nt = 0; nt < NH / 8; ++nt)
#pragma unroll
      for (int r = 0; r < 4; ++r) hs[nt][r] = 0.f;
    const float* fin = finv + hh * kMaxChunk;
    for (int J = 0; J < nb; ++J) {
      const int j0 = J * kRows, slot = ux & 1;
      mbar_wait(bar(kFullB), ub & 1);
      mbar_wait(bar(kFullX + slot), (ux >> 1) & 1);
      const float* xs = Xs + slot * kRows * LX + 16 * rg;
      const float* Bb = Bs + NH * half;
      warp_mma6<NH / 8, kRows, false, false>(
          hs,
          [&](int m, int k) {
            const int j = pair_k(k);
            return xs[j * LX + m] * fin[j0 + j];
          },
          [&](int k, int n) { return Bb[pair_k(k) * LN + n]; });
      __syncwarp();
      if (lane == 0) {
        mbar_arrive(bar(kEmptyB));
        mbar_arrive(bar(kEmptyX + slot));
      }
      ++ub;
      ++ux;
    }
    float* sb = state + (static_cast<int64_t>(b) * H + hb + hh) * kTfP * N;
#pragma unroll
    for (int nt = 0; nt < NH / 8; ++nt)
#pragma unroll
      for (int ir = 0; ir < 2; ++ir)
        *reinterpret_cast<float2*>(sb + (16 * rg + g + 8 * ir) * N + NH * half + 8 * nt +
                                   2 * t) = make_float2(hs[nt][2 * ir], hs[nt][2 * ir + 1]);
  }
}

template <int N>
cudaError_t launch_tf32(const void* x, const void* dt, const void* A, const void* B,
                        const void* C, void* y, void* state, int batch, int S, int H, int hg,
                        const Strides& st, cudaStream_t stream) {
  constexpr size_t smem = tf32_smem<N>();
  static_assert(smem <= 232448, "more shared memory than a block can have");
  auto kernel = ssd_scan_kernel_tf32<N>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<dim3((H + hg - 1) / hg, batch), kTfThreads, smem, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(dt), static_cast<const float*>(A),
      static_cast<const float*>(B), static_cast<const float*>(C), static_cast<float*>(y),
      static_cast<float*>(state), S, H, hg, st);
  return cudaGetLastError();
}

}  // namespace

// strides: 13 element strides, in turn x (batch, seq, head), dt (batch, seq,
// head), B (batch, seq), C (batch, seq), y (batch, seq, head). h0 may be null.
// is_bf16 chooses the input type: 1 bf16, on the wgmma kernel; 0 float32,
// where tensor_cores chooses the kernel: 1 ssd_scan_kernel_tf32, a block
// owning heads_per_block heads of a sequence, for the shapes it takes (P 64,
// N 64 or 128, one chunk, no h0; anything else is cudaErrorInvalidValue), 0
// the FMA kernel. Returns cudaGetLastError() after the launch (0 =
// launched), minus the CUresult if a tensor map cannot be encoded, or
// cudaErrorInvalidValue for a shape the kernels do not take.
extern "C" int ssd_scan_launch(const void* x, const void* dt, const void* A,
                               const void* B, const void* C, const void* h0, void* y,
                               void* state, int batch, int S, int H, int P, int N,
                               int chunk, int is_bf16, int tensor_cores,
                               int heads_per_block, const long long* strides,
                               void* stream) {
  Strides st;
  st.x_b = strides[0]; st.x_s = strides[1]; st.x_h = strides[2];
  st.dt_b = strides[3]; st.dt_s = strides[4]; st.dt_h = strides[5];
  st.b_b = strides[6]; st.b_s = strides[7];
  st.c_b = strides[8]; st.c_s = strides[9];
  st.y_b = strides[10]; st.y_s = strides[11]; st.y_h = strides[12];
  const bool chunk_ok = chunk == 32 || chunk == 64 || chunk == 128 || chunk == 256;
  const bool p_ok = P == 32 || P == 64;
  if (!chunk_ok || !p_ok || S <= 0 || H <= 0 || batch <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define REPRO_SSD_ARGS x, dt, A, B, C, h0, y, state, batch, S, H, P
  if (is_bf16) {   // N = 16 and 64 read as one 64-column box
    if (N == 128) return launch_wgmma<128>(REPRO_SSD_ARGS, N, chunk, st, s);
    if (N == 64 || N == 16) return launch_wgmma<64>(REPRO_SSD_ARGS, N, chunk, st, s);
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (tensor_cores) {   // fp32, one chunk from a zero state: the 6xTF32 kernel
    if (P != kTfP || (N != 64 && N != 128) || S > chunk || h0 != nullptr ||
        heads_per_block < 1 || heads_per_block > kTfMaxHeads)
      return static_cast<int>(cudaErrorInvalidValue);
    return static_cast<int>(N == 128 ? launch_tf32<128>(x, dt, A, B, C, y, state, batch, S, H,
                                                        heads_per_block, st, s)
                                     : launch_tf32<64>(x, dt, A, B, C, y, state, batch, S, H,
                                                       heads_per_block, st, s));
  }
  cudaError_t err = cudaErrorInvalidValue;
  if (N == 128) err = launch_fma_r<128>(REPRO_SSD_ARGS, chunk, st, s);
  else if (N == 64) err = launch_fma_r<64>(REPRO_SSD_ARGS, chunk, st, s);
  else if (N == 16) err = launch_fma_r<16>(REPRO_SSD_ARGS, chunk, st, s);
#undef REPRO_SSD_ARGS
  return static_cast<int>(err);
}
