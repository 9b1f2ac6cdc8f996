// Causal (or full) GQA flash attention for prefill, for sm_90a.
//
// Replaces the TPU kernel src/repro/kernels/flash_prefill.py::_kernel (grid
// (batch, q_head, q_block, kv_block) with the kv_block axis sequential and the
// online-softmax state carried in VMEM scratch between grid steps). Here one
// thread block owns one (batch, head, tile of 64 query rows); the sequential
// kv_block axis is a loop inside the block up to the causal limit, and the
// running max / sum / output accumulator stay in registers for the whole loop.
// Beyond the TPU kernel it takes what the serving path feeds it: a KV length
// T = q_offset + S (a prefix that is already cached), any S and T (the ragged
// last tiles are masked here instead of asserted away), and strides for the
// batch, head and sequence axes, so (B, S, H, D) tensors need no transposed
// copy.
//
// What bounds it: operations, 4*S*T*D per head (half of that when causal),
// against 2*(S+T)*D elements moved. This first version does both products
// with fp32 FMAs out of shared memory: every K/V tile is converted to fp32
// once when it is staged, each thread keeps a 4x4 tile of scores and a
// 4 x D/16 tile of the output in registers, rows are padded by 4 floats so
// that the 16-byte shared-memory reads are free of bank conflicts, and KV
// tiles wholly above the diagonal are never visited. fp32 inputs keep full
// precision this way (tensor cores would round them to TF32).
//
// What holds it back: the FMA pipe peaks at 67 TFLOP/s against 989 TFLOP/s of
// bf16 tensor cores, so for bf16 inputs the kernel is an order of magnitude
// above its bound by construction; loads are not overlapped with compute
// (one tile in flight, one block per SM because of the fp32 staging). wgmma
// on bf16 tiles fed by TMA is the later step.
//
// Plain C interface: flash_prefill_launch() returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;        // query rows per block
constexpr int kBK = 64;        // KV rows per loop step
constexpr int kThreads = 256;  // 16 x 16 threads, each 4 rows x 4 columns
constexpr int kPad = 4;        // floats of padding per shared-memory row
constexpr float kNegInf = -1e30f;

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

// Stage rows [row0, row0 + 64) of a (rows, D) matrix with row stride
// `stride` (elements) into dst[64][D + kPad] as fp32; rows >= n_rows are zero.
template <typename T, int D>
__device__ __forceinline__ void stage_tile(float* dst, const T* src, int64_t stride,
                                           int row0, int n_rows) {
  constexpr int VEC = 16 / sizeof(T);     // elements per 16-byte load
  constexpr int VPR = D / VEC;            // loads per row
  constexpr int DP = D + kPad;
  for (int idx = threadIdx.x; idx < 64 * VPR; idx += kThreads) {
    const int r = idx / VPR;
    const int c = (idx % VPR) * VEC;
    float* d = dst + r * DP + c;
    if (row0 + r < n_rows) {
      stage16(src + (row0 + r) * stride + c, d);
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

struct Strides {   // in elements; the D axis is contiguous
  int64_t q_b, q_h, q_s;
  int64_t k_b, k_h, k_s;
  int64_t v_b, v_h, v_s;
  int64_t o_b, o_h, o_s;
};

// grid (ceil(S / 64), H, B). Query row i sits at absolute position
// q_offset + i and, when causal, sees KV rows 0 .. q_offset + i.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_prefill_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o, int Hkv, int S,
                     int Tkv, int q_offset, int causal, Strides st, float scale) {
  constexpr int DP = D + kPad;            // padded row of Q/K/V tiles
  constexpr int PP = kBK + kPad;          // padded row of the probability tile
  constexpr int NC = D / 64;              // float4 column groups per thread

  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;                       // [kBQ][DP]
  float* Ks = Qs + kBQ * DP;              // [kBK][DP]
  float* Vs = Ks + kBK * DP;              // [kBK][DP]
  float* Ps = Vs + kBK * DP;              // [kBQ][PP]

  // tiles low on the diagonal have the most KV steps: start them first
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (gridDim.y / Hkv);
  const int tx = threadIdx.x & 15;        // columns tx + 16 j
  const int ty = threadIdx.x >> 4;        // rows ty + 16 i

  const T* qb = q + b * st.q_b + h * st.q_h;
  const T* kb = k + b * st.k_b + hk * st.k_h;
  const T* vb = v + b * st.v_b + hk * st.v_h;

  stage_tile<T, D>(Qs, qb, st.q_s, q0, S);

  float m[4], l[4], acc[4][4 * NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < 4 * NC; ++c) acc[i][c] = 0.f;
  }

  // KV rows this tile can see: all of them, or up to its last row's position
  int kv_end = Tkv;
  if (causal) {
    const int last_q = (q0 + kBQ < S ? q0 + kBQ : S) - 1;
    kv_end = min(Tkv, q_offset + last_q + 1);
  }

  for (int k0 = 0; k0 < kv_end; k0 += kBK) {
    stage_tile<T, D>(Ks, kb, st.k_s, k0, Tkv);
    stage_tile<T, D>(Vs, vb, st.v_s, k0, Tkv);
    __syncthreads();

    // s = q k^T for rows ty + 16 i, columns tx + 16 j
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

    // mask, then the online-softmax update; a row's 64 scores sit in the 16
    // lanes that share ty, so row max and row sum are 4 shuffles each
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q_offset + q0 + ty + 16 * i;
      float rmax = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx + 16 * j;
        const bool seen = col < Tkv && (!causal || col <= qpos);
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
      m[i] = m_new;
      l[i] = l[i] * alpha + rsum;
#pragma unroll
      for (int c = 0; c < 4 * NC; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

    // acc += p v for rows ty + 16 i, columns 64 g + 4 tx .. + 3
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
      }
    }
    __syncthreads();   // the next step overwrites Ks, Vs and Ps
  }

  T* ob = o + b * st.o_b + h * st.o_h;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= S) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int g = 0; g < NC; ++g)
      store4(ob + row * st.o_s + 64 * g + 4 * tx, acc[i][4 * g + 0] * inv,
             acc[i][4 * g + 1] * inv, acc[i][4 * g + 2] * inv,
             acc[i][4 * g + 3] * inv);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int B, int H,
                   int Hkv, int S, int Tkv, int q_offset, int causal,
                   const Strides& st, float scale, cudaStream_t stream) {
  constexpr size_t smem =
      sizeof(float) * (3 * 64 * (D + kPad) + kBQ * (kBK + kPad));
  // more than the 48 KB a block gets without asking
  cudaError_t err = cudaFuncSetAttribute(flash_prefill_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((S + kBQ - 1) / kBQ, H, B);
  flash_prefill_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), Hkv, S, Tkv, q_offset, causal, st, scale);
  return cudaGetLastError();
}

}  // namespace

// strides: 12 element strides, (batch, head, sequence) of q, k, v, o in turn.
// Returns cudaGetLastError() after the launch (0 = launched), or
// cudaErrorInvalidValue for a shape the kernel does not take.
extern "C" int flash_prefill_launch(const void* q, const void* k, const void* v,
                                    void* o, int B, int H, int Hkv, int S, int Tkv,
                                    int D, int q_offset, int causal, int is_bf16,
                                    const long long* strides, float scale,
                                    void* stream) {
  Strides st;
  st.q_b = strides[0]; st.q_h = strides[1]; st.q_s = strides[2];
  st.k_b = strides[3]; st.k_h = strides[4]; st.k_s = strides[5];
  st.v_b = strides[6]; st.v_h = strides[7]; st.v_s = strides[8];
  st.o_b = strides[9]; st.o_h = strides[10]; st.o_s = strides[11];
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
#define REPRO_FLASH_ARGS q, k, v, o, B, H, Hkv, S, Tkv, q_offset, causal, st, scale, s
  if (is_bf16 && D == 128) err = launch<__nv_bfloat16, 128>(REPRO_FLASH_ARGS);
  else if (is_bf16 && D == 64) err = launch<__nv_bfloat16, 64>(REPRO_FLASH_ARGS);
  else if (!is_bf16 && D == 128) err = launch<float, 128>(REPRO_FLASH_ARGS);
  else if (!is_bf16 && D == 64) err = launch<float, 64>(REPRO_FLASH_ARGS);
#undef REPRO_FLASH_ARGS
  return static_cast<int>(err);
}
