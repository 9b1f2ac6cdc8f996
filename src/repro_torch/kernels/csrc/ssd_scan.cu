// Mamba2 SSD (state-space duality) chunked scan, for sm_90a.
//
// Replaces the TPU kernel src/repro/kernels/ssd_scan.py::_kernel (grid
// (batch, head, chunk) with the chunk axis sequential and the (P, N) state
// carried in VMEM scratch between grid steps). On Hopper blocks run in no
// order, so one thread block owns one (batch, head, tile of 32 of the P
// columns) and walks the chunks in order itself, with the state in registers
// and a copy in shared memory. The recurrence is independent per column p
// (y[:, p] and h[p, :] depend only on x[:, p]), so splitting P gives more
// blocks: at the serving path's shape (1 sequence, 64 heads, P = 64) that is
// 128 blocks on 132 SMs instead of 64.
//
// Per chunk of `chunk` steps starting at t0, with dA_cum the running sum of
// dt * A inside the chunk (fp32, a block-wide scan) and dA_total its last
// value:
//   y_i  = sum_{j <= i} (C_i . B_j) exp(dA_cum_i - dA_cum_j) dt_j x_j
//        + exp(dA_cum_i) (C_i . h_p)                      (carried state)
//   h_p <- exp(dA_total) h_p + sum_j x_j[p] exp(dA_total - dA_cum_j) dt_j B_j
// The chunk is cut into row blocks of R (64, or 32 for chunk 32); for a row
// block I the kernel visits the column blocks J <= I only, staging B_J and
// x_J as fp32 into padded shared memory. The state update rides on the last
// row block's pass over the column blocks, after every row has read the
// entering state.
//
// Numerics: the decay exponent is masked before exp (only i >= j is ever
// evaluated; for i < j it is positive and would overflow, and inf * 0 gives
// NaN), no exp(-dA_cum) is formed alone (every factor is exp of a value
// <= 0), and products accumulate in fp32.
//
// Ragged S: the steps t >= S of the last chunk are masked here (dt = 0, no
// input, no store), which is what the reference's padding to a chunk
// multiple computes, so the wrapper copies nothing.
//
// What bounds it, per launch: bytes, x, dt, B, C (and h0 when given) read
// once, y and the fp32 state written once: 7.9 MB at the serving shape in
// bf16 (1 x 341 x 64 x 64), 2.4 us at 3.35 TB/s. The operations that data
// needs (C B^T once per chunk, shared by the heads; (C B^T o L) x,
// C h^T and x^T B per head, all over the causal part only) come to 0.76
// GFLOP, 0.8 us on the bf16 tensor cores. This first version is far from
// both: all products are fp32 FMAs out of shared memory, each block
// recomputes C B^T (identical for all heads and P tiles), and loads are not
// overlapped with compute. mma/wgmma on bf16 tiles, and C B^T shared across
// the heads, are the later steps.
//
// Plain C interface: ssd_scan_launch() returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;   // 8 warps
constexpr int kPT = 32;         // P columns per block
constexpr int kMaxChunk = 256;
constexpr int kPad = 4;         // floats of padding per shared-memory row

__device__ __forceinline__ void unpack_bf16x2(uint32_t u, float& lo, float& hi) {
  lo = __uint_as_float(u << 16);          // element 0 sits in the low half
  hi = __uint_as_float(u & 0xffff0000u);
}

// 16 bytes from global memory -> floats in shared memory
__device__ __forceinline__ void stage16(const float* src, float* dst) {
  *reinterpret_cast<float4*>(dst) = *reinterpret_cast<const float4*>(src);
}
__device__ __forceinline__ void stage16(const __nv_bfloat16* src, float* dst) {
  const uint4 v = *reinterpret_cast<const uint4*>(src);
  float4 a, b;
  unpack_bf16x2(v.x, a.x, a.y);
  unpack_bf16x2(v.y, a.z, a.w);
  unpack_bf16x2(v.z, b.x, b.y);
  unpack_bf16x2(v.w, b.z, b.w);
  reinterpret_cast<float4*>(dst)[0] = a;
  reinterpret_cast<float4*>(dst)[1] = b;
}

// Stage rows [0, R) of a (rows, W) matrix whose row r starts at
// src + r * stride (elements; W contiguous) into dst[R][W + kPad] as fp32;
// rows >= n_rows are zero.
template <typename T, int W, int R>
__device__ __forceinline__ void stage_rows(float* dst, const T* src, int64_t stride,
                                           int n_rows) {
  constexpr int VEC = 16 / sizeof(T);     // elements per 16-byte load
  constexpr int VPR = W / VEC;            // loads per row
  constexpr int LD = W + kPad;
  for (int idx = threadIdx.x; idx < R * VPR; idx += kThreads) {
    const int r = idx / VPR;
    const int c = (idx % VPR) * VEC;
    float* d = dst + r * LD + c;
    if (r < n_rows) {
      stage16(src + r * stride + c, d);
    } else {
#pragma unroll
      for (int e = 0; e < VEC; e += 4)
        *reinterpret_cast<float4*>(d + e) = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
}

__device__ __forceinline__ void store4(float* p, float a, float b, float c, float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float a, float b, float c,
                                       float d) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(a, b);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(c, d);
  uint2 v;
  v.x = *reinterpret_cast<const uint32_t*>(&lo);
  v.y = *reinterpret_cast<const uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = v;
}

__device__ __forceinline__ float dot4(const float4& a, const float4& b) {
  return a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
}

struct Strides {   // in elements; p of x and y, n of B and C are contiguous
  int64_t x_b, x_s, x_h;
  int64_t dt_b, dt_s, dt_h;
  int64_t b_b, b_s;
  int64_t c_b, c_s;
  int64_t y_b, y_s, y_h;
};

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
// h0 may be null (a zero initial state).
template <typename T, int N, int R>
__global__ void __launch_bounds__(kThreads)
ssd_scan_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ A, const T* __restrict__ Bm,
                const T* __restrict__ Cm, const float* __restrict__ h0,
                T* __restrict__ y, float* __restrict__ state, int S, int H, int P,
                int chunk, Strides st) {
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

  const T* xb = x + b * st.x_b + h * st.x_h + p0;
  const float* dtb = dt + b * st.dt_b + h * st.dt_h;
  const T* Bb = Bm + b * st.b_b;
  const T* Cb = Cm + b * st.c_b;
  T* yb = y + b * st.y_b + h * st.y_h + p0;
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
    const float total = cum[chunk - 1];
    if (tid < chunk) fin[tid] = expf(total - v) * d;   // total - v <= 0
    // fin is read only after the next barrier (the first staging's)

    const bool carried = c > 0 || h0 != nullptr;   // else the state is zero
    const int n_blocks = (valid + R - 1) / R;
    for (int I = 0; I < n_blocks; ++I) {
      const int i0 = I * R;
      stage_rows<T, N, R>(Cs, Cb + static_cast<int64_t>(t0 + i0) * st.c_s, st.c_s,
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
        stage_rows<T, N, R>(Bs, Bb + tj * st.b_s, st.b_s, valid - j0);
        stage_rows<T, kPT, R>(Xs, xb + tj * st.x_s, st.x_s, valid - j0);
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
          store4(yb + static_cast<int64_t>(t0 + row) * st.y_s + 4 * tx8, acc[i][0],
                 acc[i][1], acc[i][2], acc[i][3]);
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

template <typename T, int N, int R>
cudaError_t launch(const void* x, const void* dt, const void* A, const void* B,
                   const void* C, const void* h0, void* y, void* state, int batch,
                   int S, int H, int P, int chunk, const Strides& st,
                   cudaStream_t stream) {
  constexpr size_t smem = sizeof(float) * smem_floats<N, R>();
  // more than the 48 KB a block gets without asking at the widest shapes
  cudaError_t err = cudaFuncSetAttribute(ssd_scan_kernel<T, N, R>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(P / kPT, H, batch);
  ssd_scan_kernel<T, N, R><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const T*>(B), static_cast<const T*>(C),
      static_cast<const float*>(h0), static_cast<T*>(y), static_cast<float*>(state),
      S, H, P, chunk, st);
  return cudaGetLastError();
}

template <typename T, int N>
cudaError_t launch_r(const void* x, const void* dt, const void* A, const void* B,
                     const void* C, const void* h0, void* y, void* state, int batch,
                     int S, int H, int P, int chunk, const Strides& st,
                     cudaStream_t stream) {
  if (chunk == 32)
    return launch<T, N, 32>(x, dt, A, B, C, h0, y, state, batch, S, H, P, chunk, st,
                            stream);
  return launch<T, N, 64>(x, dt, A, B, C, h0, y, state, batch, S, H, P, chunk, st,
                          stream);
}

}  // namespace

// strides: 13 element strides, in turn x (batch, seq, head), dt (batch, seq,
// head), B (batch, seq), C (batch, seq), y (batch, seq, head). h0 may be null.
// Returns cudaGetLastError() after the launch (0 = launched), or
// cudaErrorInvalidValue for a shape the kernel does not take.
extern "C" int ssd_scan_launch(const void* x, const void* dt, const void* A,
                               const void* B, const void* C, const void* h0, void* y,
                               void* state, int batch, int S, int H, int P, int N,
                               int chunk, int is_bf16, const long long* strides,
                               void* stream) {
  Strides st;
  st.x_b = strides[0]; st.x_s = strides[1]; st.x_h = strides[2];
  st.dt_b = strides[3]; st.dt_s = strides[4]; st.dt_h = strides[5];
  st.b_b = strides[6]; st.b_s = strides[7];
  st.c_b = strides[8]; st.c_s = strides[9];
  st.y_b = strides[10]; st.y_s = strides[11]; st.y_h = strides[12];
  const bool chunk_ok = chunk == 32 || chunk == 64 || chunk == 128 || chunk == 256;
  if (!chunk_ok || P % kPT != 0 || P <= 0 || S <= 0 || H <= 0 || batch <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
#define REPRO_SSD_ARGS x, dt, A, B, C, h0, y, state, batch, S, H, P, chunk, st, s
  if (is_bf16 && N == 128) err = launch_r<__nv_bfloat16, 128>(REPRO_SSD_ARGS);
  else if (is_bf16 && N == 64) err = launch_r<__nv_bfloat16, 64>(REPRO_SSD_ARGS);
  else if (is_bf16 && N == 16) err = launch_r<__nv_bfloat16, 16>(REPRO_SSD_ARGS);
  else if (!is_bf16 && N == 128) err = launch_r<float, 128>(REPRO_SSD_ARGS);
  else if (!is_bf16 && N == 64) err = launch_r<float, 64>(REPRO_SSD_ARGS);
  else if (!is_bf16 && N == 16) err = launch_r<float, 16>(REPRO_SSD_ARGS);
#undef REPRO_SSD_ARGS
  return static_cast<int>(err);
}
