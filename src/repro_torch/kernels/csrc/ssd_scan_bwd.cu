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
// Design (fp32 FMA arithmetic, fp32 accumulators; the input type T is float,
// the trainer's, or bf16, converted to fp32 as it is staged):
//
// * One block per (head, batch) owns the whole of P and walks the chunks in
//   reverse, G in shared memory. Owning P lets the block finish d(dt) and its
//   head's share of dA itself. At mamba2-1.3b's training shape (b 8, h 64)
//   that is 512 blocks for 132 SMs, one block an SM (215 KB of shared
//   memory at P 64, N 128).
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
//   reads it (the first chunk without h0). In training (no h0, no cotangent
//   of the final state) at s <= chunk only the intra-chunk terms run.
// * No atomics, so the same inputs give the same bits. dB and dC are sums
//   over the heads, dA over the batch: each block writes its own fp32
//   partials (dB and dC (b, s, h, N), dA (b, h)) and the wrapper sums them
//   over h and over b. Those two sums are the second pass of a cross-block
//   reduction, not the function's work. Every in-block sum (rows by warp
//   shuffles, columns through a small shared buffer, the scans and the
//   block sums) runs in a fixed order.
// * x, B, C, dt and dy are read through their strides (x, B and C as views
//   of mamba_forward's conv output, no copy); the last axis must be
//   contiguous. h0, dstate and every output are contiguous.
// * Ragged S: steps past S of the last chunk are masked (dt = 0, no input,
//   no store), which is the plain version's padding.
//
// What bounds it, at mamba2-1.3b's training shape (b 8, s 128, h 64, P 64,
// N 128, one chunk of 256, fp32): operations. The data need C B^T over the
// 8256 causal pairs once a sequence and, per head, dy x^T (P), Z^T C and Z B
// (N each) and W^T dy (P) over them: 3.26 GFLOP, 0.049 ms at 67 TFLOP/s
// (the card's fp32 rate off the tensor cores); the bytes (x, dy, dx 16.8 MB
// each, B, C, dt and their gradients) take 0.016 ms. What holds the design
// back: C B^T is recomputed by every head's block (a third of the
// products); one block of 8 warps an SM, at 215 KB of shared memory, so
// each barrier idles the SM; dC_I goes through device memory once per
// (I, J) pair; and the products are FMA, not wgmma (fp32 would round to
// TF32 on the tensor cores; bf16 could use them).
//
// Plain C interface: ssd_scan_bwd_launch() launches the instance for the
// input type, P, N and chunk and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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
// dx (b, S, H, P) in T, ddt (b, S, H), dB and dC partials (b, S, H, N), dA
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
  float* dBb = dB_part + (out_row * H + h) * N;          // row stride H N
  float* dCb = dC_part + (out_row * H + h) * N;
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
          store4(dCb + static_cast<int64_t>(t0 + i0 + row) * H * N + 4 * nx, acc);
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
            float* dst = dCb + static_cast<int64_t>(t0 + i0 + row) * H * N + 4 * nx;
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
          store4(dBb + static_cast<int64_t>(t0 + j0 + row) * H * N + 4 * nx, dba[r]);
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

}  // namespace

// strides: x (b, s, h), dt (b, s, h), B (b, s), C (b, s), dy (b, s, h), in
// elements. scratch: (batch, H, chunks - 1, P, N) fp32, null for one chunk.
// is_bf16 chooses the input type: 1 bf16, 0 float32.
extern "C" int ssd_scan_bwd_launch(const void* x, const void* dt, const void* A,
                                   const void* B, const void* C, const void* h0,
                                   const void* dy, const void* dstate, void* dx, void* ddt,
                                   void* dA_part, void* dB_part, void* dC_part, void* dh0,
                                   void* scratch, int batch, int S, int H, int P, int N,
                                   int chunk, int is_bf16, const long long* strides,
                                   void* stream) {
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
  cudaError_t err = is_bf16
      ? launch_p<__nv_bfloat16>(P, N, x, dt, A, B, C, h0, dy, dstate, dx, ddt, dA_part,
                                dB_part, dC_part, dh0, scratch, batch, S, H, chunk, st, s)
      : launch_p<float>(P, N, x, dt, A, B, C, h0, dy, dstate, dx, ddt, dA_part, dB_part,
                        dC_part, dh0, scratch, batch, S, H, chunk, st, s);
  return static_cast<int>(err);
}
