// Decode attention over a block-table-addressed KV pool, for sm_90a.
//
// Replaces the TPU kernel src/repro/kernels/paged_attention.py::_kernel
// (grid (batch, kv_head, page) with the page axis sequential and the
// online-softmax state carried in VMEM scratch between grid steps). Here one
// thread block serves one (sequence, KV head); the sequential page axis is a
// loop inside the block, split over the block's warps, and the running
// max / sum / accumulator live in registers. The warps' partial results are
// merged once through shared memory.
//
// What bounds it: bytes. Every K and V element of the sequence is read once
// and used for `group` (1..8) multiply-adds, far below the card's ratio of
// operations to bytes, so the time is that of streaming length*D*2 elements
// per block. The design therefore keeps loads wide and many in flight:
// 16 lanes cover one token row with 16-byte loads (a warp reads two tokens
// per instruction), a whole chunk of 8 or 16 tokens is loaded before its
// softmax update, and all `group` query rows share each loaded K/V row.
// `group` is below any tensor-core tile, so the products are FMAs.
//
// What holds it back: the grid is (B, n_kv) blocks, 64 at the serving
// instance's 8 sequences x 8 KV heads, fewer than the card's 132 SMs, and a
// long sequence is walked by the 8 warps of one block only. Splitting the
// pages of one sequence over several blocks with a second combining pass
// would fill the card; that is left for later.
//
// Plain C interface: paged_attention_launch() returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kPage = 16;     // tokens per page
constexpr int kWarps = 8;     // warps per block
constexpr float kNegInf = -1e30f;

// ---- N contiguous elements -> float registers, 16 bytes per load where N allows
template <int N>
__device__ __forceinline__ void load_row(const float* p, float (&out)[N]) {
  static_assert(N % 4 == 0, "row slice must be a multiple of 16 bytes");
#pragma unroll
  for (int i = 0; i < N / 4; ++i) {
    const float4 v = *reinterpret_cast<const float4*>(p + 4 * i);
    out[4 * i + 0] = v.x;
    out[4 * i + 1] = v.y;
    out[4 * i + 2] = v.z;
    out[4 * i + 3] = v.w;
  }
}

__device__ __forceinline__ void unpack_bf16x2(uint32_t u, float& lo, float& hi) {
  lo = __uint_as_float(u << 16);          // element 0 sits in the low half
  hi = __uint_as_float(u & 0xffff0000u);
}

template <int N>
__device__ __forceinline__ void load_row(const __nv_bfloat16* p, float (&out)[N]) {
  static_assert(N == 4 || N == 8, "row slice of 8 or 16 bytes");
  if constexpr (N == 8) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    unpack_bf16x2(v.x, out[0], out[1]);
    unpack_bf16x2(v.y, out[2], out[3]);
    unpack_bf16x2(v.z, out[4], out[5]);
    unpack_bf16x2(v.w, out[6], out[7]);
  } else {
    const uint2 v = *reinterpret_cast<const uint2*>(p);
    unpack_bf16x2(v.x, out[0], out[1]);
    unpack_bf16x2(v.y, out[2], out[3]);
  }
}

__device__ __forceinline__ void store_out(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// One block per (sequence b, KV head h). GP = `group` rounded up to 1/2/4/8.
template <typename T, int D, int GP>
__global__ void __launch_bounds__(kWarps * 32)
paged_attention_kernel(const T* __restrict__ q, const T* __restrict__ k_pool,
                       const T* __restrict__ v_pool,
                       const int* __restrict__ block_tables,
                       const int* __restrict__ lengths, T* __restrict__ out,
                       int n_kv, int group, int max_pages, float scale) {
  constexpr int EPL = D / 16;             // elements per lane: 16 lanes = one row
  constexpr int TI = (GP == 8) ? 4 : 8;   // steps per chunk, two tokens per step
  constexpr int CHUNK = 2 * TI;           // tokens per softmax update; divides kPage
  static_assert(kPage % CHUNK == 0, "a chunk must not straddle pages");

  const int b = blockIdx.x;
  const int h = blockIdx.y;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int half = lane >> 4;             // which of the step's two tokens
  const int sub = lane & 15;              // which slice of the row
  const int length = lengths[b];

  float qf[GP][EPL];
#pragma unroll
  for (int g = 0; g < GP; ++g) {
    if (g < group) {
      load_row<EPL>(q + ((static_cast<int64_t>(b) * n_kv + h) * group + g) * D +
                        sub * EPL, qf[g]);
    } else {
#pragma unroll
      for (int e = 0; e < EPL; ++e) qf[g][e] = 0.f;
    }
  }

  float m[GP], l[GP], acc[GP][EPL];
#pragma unroll
  for (int g = 0; g < GP; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < EPL; ++e) acc[g][e] = 0.f;
  }

  const int64_t tok_stride = static_cast<int64_t>(n_kv) * D;
  const int64_t page_stride = kPage * tok_stride;
  const int* bt = block_tables + static_cast<int64_t>(b) * max_pages;
  const int n_chunks = (length + CHUNK - 1) / CHUNK;

  for (int c = warp; c < n_chunks; c += kWarps) {
    const int base = c * CHUNK;           // base < length: the chunk's first token is valid
    const int64_t off = bt[base / kPage] * page_stride +
                        (base % kPage) * tok_stride + h * D + sub * EPL;
    const T* kp = k_pool + off;
    const T* vp = v_pool + off;

    // scores of this half-warp's TI tokens against all query rows
    float s[GP][TI];
#pragma unroll
    for (int i = 0; i < TI; ++i) {
      const int t = 2 * i + half;
      const bool valid = base + t < length;
      // a token past the end reads the chunk's first row instead (always
      // written); its score is masked below, so the value is never used
      float kf[EPL];
      load_row<EPL>(kp + (valid ? t : 0) * tok_stride, kf);
#pragma unroll
      for (int g = 0; g < GP; ++g) {
        float dot = 0.f;
#pragma unroll
        for (int e = 0; e < EPL; ++e) dot += qf[g][e] * kf[e];
#pragma unroll
        for (int o = 8; o > 0; o >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, o);
        s[g][i] = valid ? dot * scale : kNegInf;
      }
    }

    // online softmax over the chunk; both half-warps agree on the new max
#pragma unroll
    for (int g = 0; g < GP; ++g) {
      float mc = s[g][0];
#pragma unroll
      for (int i = 1; i < TI; ++i) mc = fmaxf(mc, s[g][i]);
      mc = fmaxf(mc, __shfl_xor_sync(0xffffffffu, mc, 16));
      const float m_new = fmaxf(m[g], mc);
      const float alpha = expf(m[g] - m_new);
      m[g] = m_new;
      l[g] *= alpha;
#pragma unroll
      for (int e = 0; e < EPL; ++e) acc[g][e] *= alpha;
#pragma unroll
      for (int i = 0; i < TI; ++i) {
        const float p = expf(s[g][i] - m_new);   // 0 for a masked token
        s[g][i] = p;
        l[g] += p;                               // this half-warp's share
      }
    }

    // acc += p * v
#pragma unroll
    for (int i = 0; i < TI; ++i) {
      const int t = 2 * i + half;
      const bool valid = base + t < length;
      float vf[EPL];
      load_row<EPL>(vp + (valid ? t : 0) * tok_stride, vf);   // weight is 0 if masked
#pragma unroll
      for (int g = 0; g < GP; ++g) {
#pragma unroll
        for (int e = 0; e < EPL; ++e) acc[g][e] += s[g][i] * vf[e];
      }
    }
  }

  // the two half-warps share m; add their sums and accumulators
#pragma unroll
  for (int g = 0; g < GP; ++g) {
    l[g] += __shfl_xor_sync(0xffffffffu, l[g], 16);
#pragma unroll
    for (int e = 0; e < EPL; ++e)
      acc[g][e] += __shfl_xor_sync(0xffffffffu, acc[g][e], 16);
  }

  __shared__ float sm_m[kWarps][GP];
  __shared__ float sm_l[kWarps][GP];
  __shared__ float sm_acc[kWarps][GP][D];
  if (half == 0) {
#pragma unroll
    for (int g = 0; g < GP; ++g) {
#pragma unroll
      for (int e = 0; e < EPL; ++e) sm_acc[warp][g][sub * EPL + e] = acc[g][e];
    }
  }
  if (lane == 0) {
#pragma unroll
    for (int g = 0; g < GP; ++g) {
      sm_m[warp][g] = m[g];
      sm_l[warp][g] = l[g];
    }
  }
  __syncthreads();

  // merge the warps' partial softmaxes; length == 0 gives 0 / 1e-30 = 0
  for (int idx = threadIdx.x; idx < group * D; idx += kWarps * 32) {
    const int g = idx / D;
    const int d = idx % D;
    float m_all = sm_m[0][g];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) m_all = fmaxf(m_all, sm_m[w][g]);
    float num = 0.f, den = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float wgt = expf(sm_m[w][g] - m_all);
      num += wgt * sm_acc[w][g][d];
      den += wgt * sm_l[w][g];
    }
    store_out(out + ((static_cast<int64_t>(b) * n_kv + h) * group + g) * D + d,
              num / fmaxf(den, 1e-30f));
  }
}

template <typename T, int D, int GP>
void launch(const void* q, const void* k_pool, const void* v_pool,
            const int* block_tables, const int* lengths, void* out, int B,
            int n_kv, int group, int max_pages, float scale, cudaStream_t stream) {
  paged_attention_kernel<T, D, GP><<<dim3(B, n_kv), kWarps * 32, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pool),
      static_cast<const T*>(v_pool), block_tables, lengths, static_cast<T*>(out),
      n_kv, group, max_pages, scale);
}

template <typename T, int D>
bool launch_group(const void* q, const void* k_pool, const void* v_pool,
                  const int* block_tables, const int* lengths, void* out, int B,
                  int n_kv, int group, int max_pages, float scale,
                  cudaStream_t stream) {
#define REPRO_PAGED_ARGS q, k_pool, v_pool, block_tables, lengths, out, B, n_kv, group, max_pages, scale, stream
  if (group == 1) launch<T, D, 1>(REPRO_PAGED_ARGS);
  else if (group == 2) launch<T, D, 2>(REPRO_PAGED_ARGS);
  else if (group <= 4) launch<T, D, 4>(REPRO_PAGED_ARGS);
  else if (group <= 8) launch<T, D, 8>(REPRO_PAGED_ARGS);
  else return false;
#undef REPRO_PAGED_ARGS
  return true;
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 = launched), or
// cudaErrorInvalidValue for a shape the kernel does not take.
extern "C" int paged_attention_launch(const void* q, const void* k_pool,
                                      const void* v_pool, const void* block_tables,
                                      const void* lengths, void* out, int B,
                                      int n_kv, int group, int D, int max_pages,
                                      int is_bf16, float scale, void* stream) {
  const int* bt = static_cast<const int*>(block_tables);
  const int* ln = static_cast<const int*>(lengths);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  bool ok = false;
#define REPRO_PAGED_ARGS q, k_pool, v_pool, bt, ln, out, B, n_kv, group, max_pages, scale, st
  if (is_bf16 && D == 128) ok = launch_group<__nv_bfloat16, 128>(REPRO_PAGED_ARGS);
  else if (is_bf16 && D == 64) ok = launch_group<__nv_bfloat16, 64>(REPRO_PAGED_ARGS);
  else if (!is_bf16 && D == 128) ok = launch_group<float, 128>(REPRO_PAGED_ARGS);
  else if (!is_bf16 && D == 64) ok = launch_group<float, 64>(REPRO_PAGED_ARGS);
#undef REPRO_PAGED_ARGS
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
