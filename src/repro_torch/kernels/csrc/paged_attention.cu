// Decode attention over a block-table-addressed KV pool, for sm_90a.
//
// Replaces the TPU kernel src/repro/kernels/paged_attention.py::_kernel
// (grid (batch, kv_head, page) with the page axis sequential and the
// online-softmax state carried in VMEM scratch between grid steps). Here the
// page axis is split (flash-decoding): one thread block serves one (sequence,
// KV head, split of kPagesPerSplit = 16 pages = 256 tokens) and walks its
// pages itself; the last split of a sequence to finish merges the splits'
// partial softmaxes, in the same launch. Beyond the TPU kernel it takes a
// per-sequence lower bound `starts[b]` (the reference's sliding window,
// src/repro/models/layers.py::attention_decode: a token at position p attends
// to positions above p - window), so a sequence attends over positions
// [starts[b], lengths[b]).
//
// What bounds it: bytes. Every K and V element of a sequence is read once and
// used for `group` (1..8) multiply-adds, far below the card's ratio of
// operations to bytes, so the least time is that of streaming length*D*2
// elements per (sequence, KV head): 15.1 MB, 4.5 us at 3.35 TB/s, at the
// long-context case of the serving instance (8 sequences up to 1024 tokens,
// 8 KV heads, group 4, D = 128, bf16). Reaching it needs the whole card busy
// and many bytes in flight, which the design does as follows:
//
// * The grid is (B, n_kv, n_splits). n_splits = ceil(max_pages / 16) depends
//   on the block table's shape only, never on the lengths, which live on the
//   device: the launch makes no host sync and its scratch is sized from
//   shapes, so it can be captured in a CUDA graph. At the serving instance
//   (max_pages 64) that is 256 blocks on 132 SMs, where one block per
//   (sequence, KV head) gave 64. A split that starts at or past its
//   sequence's length, or ends before its lower bound, exits at once. A
//   sequence whose pages in range all lie in one split is finished by that
//   split, which writes the output itself.
// * Each of a block's 4 warps takes every 4th page of the split and streams
//   it through its own two-stage ring in shared memory with 16-byte
//   cp.async copies: the next page's K and V are in flight while the current
//   one is scored. Only rows in [start, length) are read (the others are
//   zero-filled), and only pages in that range are looked up, so garbage
//   table entries outside a sequence's pages are never dereferenced. The
//   query rows and the table entries of the split's 16 pages (one per lane)
//   are loaded before the length is known, so a page's copies never wait for
//   its table entry.
// * 8 lanes cover one token row (16 for group 8, whose registers would not
//   fit), so a score costs 3 shuffles; a lane holds D / 8 (or D / 16)
//   elements of the row, loaded 16, 8, 4 or 2 bytes at a time as their
//   alignment allows (D = 96 in bf16: three 8-byte pieces, or three 4-byte
//   pieces at 16 lanes a row; D = 80: five 4-byte pieces, or five single
//   elements at 16 lanes a row); the online-softmax update runs once per
//   8 or 16 tokens, and all `group` query rows share each row read. `group` is
//   below any tensor-core tile, so the products are FMAs.
// * The warps' partial softmaxes are merged through shared memory. A sequence
//   over several splits has each split write its partial (m, l, acc in fp32)
//   and take a ticket from a per-(sequence, KV head) counter; the split that
//   takes the last ticket merges the partials into the output and sets the
//   counter back to 0 for the next launch. No second kernel is launched. The
//   counters are a buffer the caller keeps at zero between launches. With a
//   lower bound the splits that hold pages in range start later: every split
//   derives that range (first split, count) from start and length alike, so
//   the count of tickets and the partials merged are the same in each.
//
// * With `lse` given (a sequence-sharded rank's partial),
//   the output is written in float32, unrounded, with each query row's
//   log-sum-exp m + log(l) in the scaled-score units the softmax keeps, and
//   -inf for a row with no position in range: the partial that a merge over
//   ranks weighs by exp(lse - max lse). The same grid, splits and tickets;
//   only the two stores of the output (the single split's and the merge's)
//   and the empty row's change.
//
// What still holds it back: a split's pages are walked by 4 warps with one
// page in flight each, so a split is latency-bound; the split size is fixed,
// not fitted to the batch; times are in PERF.md.
//
// Plain C interface: paged_attention_launch() returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kPage = 16;     // tokens per page
constexpr int kWarps = 4;     // warps per block
constexpr int kPagesPerSplit = 16;   // pages of one sequence per block
constexpr int kMaxMerge = 2048;      // n_splits * group a merge takes
constexpr float kNegInf = -1e30f;

// ---- N contiguous elements -> float registers, in the widest pieces that a
// lane's slice (N elements at an offset of a multiple of N) stays aligned to:
// 16 bytes, else 8, else 4 (D = 80 at 16 lanes a row: 5 elements a lane)
template <int N>
__device__ __forceinline__ void load_row(const float* p, float (&out)[N]) {
  if constexpr (N % 2 != 0) {
#pragma unroll
    for (int i = 0; i < N; ++i) out[i] = p[i];
  } else if constexpr (N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N / 4; ++i) {
      const float4 v = *reinterpret_cast<const float4*>(p + 4 * i);
      out[4 * i + 0] = v.x;
      out[4 * i + 1] = v.y;
      out[4 * i + 2] = v.z;
      out[4 * i + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < N / 2; ++i) {
      const float2 v = *reinterpret_cast<const float2*>(p + 2 * i);
      out[2 * i + 0] = v.x;
      out[2 * i + 1] = v.y;
    }
  }
}

__device__ __forceinline__ void unpack_bf16x2(uint32_t u, float& lo, float& hi) {
  lo = __uint_as_float(u << 16);          // element 0 sits in the low half
  hi = __uint_as_float(u & 0xffff0000u);
}

// 16, 8, 4 or 2 bytes a piece (D = 96: 12 elements a lane at 8 lanes a row,
// 6 at 16; D = 80: 10 at 8 lanes, in 4-byte pieces, and 5 at 16, one by one)
template <int N>
__device__ __forceinline__ void load_row(const __nv_bfloat16* p, float (&out)[N]) {
  if constexpr (N % 2 != 0) {
#pragma unroll
    for (int i = 0; i < N; ++i) out[i] = __bfloat162float(p[i]);
  } else if constexpr (N % 8 == 0) {
#pragma unroll
    for (int i = 0; i < N / 8; ++i) {
      const uint4 v = *reinterpret_cast<const uint4*>(p + 8 * i);
      unpack_bf16x2(v.x, out[8 * i + 0], out[8 * i + 1]);
      unpack_bf16x2(v.y, out[8 * i + 2], out[8 * i + 3]);
      unpack_bf16x2(v.z, out[8 * i + 4], out[8 * i + 5]);
      unpack_bf16x2(v.w, out[8 * i + 6], out[8 * i + 7]);
    }
  } else if constexpr (N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N / 4; ++i) {
      const uint2 v = *reinterpret_cast<const uint2*>(p + 4 * i);
      unpack_bf16x2(v.x, out[4 * i + 0], out[4 * i + 1]);
      unpack_bf16x2(v.y, out[4 * i + 2], out[4 * i + 3]);
    }
  } else {
#pragma unroll
    for (int i = 0; i < N / 2; ++i)
      unpack_bf16x2(*reinterpret_cast<const uint32_t*>(p + 2 * i), out[2 * i],
                    out[2 * i + 1]);
  }
}

__device__ __forceinline__ void store_out(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// element i of the output: float32 where a log-sum-exp is written beside it
// (`out_f32` non-null), else in the kernel's dtype
template <typename T>
__device__ __forceinline__ void store_row(T* out, float* out_f32, int64_t i, float x) {
  if (out_f32 != nullptr) out_f32[i] = x;
  else store_out(out + i, x);
}

// 16 bytes global -> shared, asynchronously; src_bytes 0 writes zeros and
// reads nothing
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_one() {   // all but the newest group
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// One block per (sequence b, KV head h, split). GP = `group` rounded up to
// 1/2/4/8; LPR lanes cover one token row, so a warp scores 32 / LPR tokens per
// step. Partials are indexed ((b * n_kv + h) * n_splits + split) * group + g,
// tickets b * n_kv + h. `starts` may be null (every sequence from 0). With
// `lse` non-null the output goes to `out_f32` (float32) and each query row's
// log-sum-exp to lse[(b * n_kv + h) * group + g].
template <typename T, int D, int GP, int LPR>
__global__ void __launch_bounds__(kWarps * 32)
paged_attention_kernel(const T* __restrict__ q, const T* __restrict__ k_pool,
                       const T* __restrict__ v_pool,
                       const int* __restrict__ block_tables,
                       const int* __restrict__ lengths,
                       const int* __restrict__ starts, T* __restrict__ out,
                       float* __restrict__ out_f32, float* __restrict__ lse,
                       float* __restrict__ part_m, float* __restrict__ part_l,
                       float* __restrict__ part_acc, int* __restrict__ tickets, int n_kv,
                       int group, int max_pages, float scale) {
  constexpr int EPL = D / LPR;            // elements per lane
  constexpr int TPS = 32 / LPR;           // tokens per step
  constexpr int TI = GP == 8 ? 4 : kPage / TPS;   // steps per softmax update
  constexpr int CHUNK = TPS * TI;         // tokens per softmax update; divides kPage
  constexpr int VEC = 16 / sizeof(T);     // elements per 16-byte copy
  constexpr int PAGE = kPage * D;         // elements of one page of one head
  static_assert(kPage % CHUNK == 0, "a chunk must not straddle pages");

  const int b = blockIdx.x;
  const int h = blockIdx.y;
  const int split = blockIdx.z;
  const int n_splits = gridDim.z;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int tis = lane / LPR;             // which of a step's tokens
  const int sub = lane % LPR;             // which slice of the row
  const int p0 = split * kPagesPerSplit;
  const int64_t row0 = (static_cast<int64_t>(b) * n_kv + h) * group;   // first query row
  const int64_t part0 = ((static_cast<int64_t>(b) * n_kv + h) * n_splits + split) * group;
  const int* bt = block_tables + static_cast<int64_t>(b) * max_pages;

  // loads that do not depend on the length go out before it is known: the
  // query rows and the table entries of the split's pages, lane i holding
  // the i-th (reading an entry is safe, using a garbage one is not)
  float qf[GP][EPL];
#pragma unroll
  for (int g = 0; g < GP; ++g) {
    if (g < group) {
      load_row<EPL>(q + (row0 + g) * D + sub * EPL, qf[g]);
    } else {
#pragma unroll
      for (int e = 0; e < EPL; ++e) qf[g][e] = 0.f;
    }
  }
  static_assert(kPagesPerSplit <= 32, "a split's table entries fit a warp's lanes");
  const int my_entry = lane < kPagesPerSplit && p0 + lane < max_pages ? bt[p0 + lane] : 0;
  const int length = lengths[b];
  // the tokens attended to: [lo, length)
  const int lo = starts == nullptr ? 0 : min(max(starts[b], 0), length);
  const int seq_pages = min((length + kPage - 1) / kPage, max_pages);
  const int lo_page = lo / kPage;
  const int pb = max(p0, lo_page);        // this split's pages: [pb, p1)
  const int p1 = min(p0 + kPagesPerSplit, seq_pages);
  // the splits that hold pages in range, from first_split on; with one, that
  // split writes the output itself and no partial is merged
  const int first_split = lo_page / kPagesPerSplit;
  const int n_used =
      seq_pages > lo_page ? (seq_pages - 1) / kPagesPerSplit - first_split + 1 : 0;

  if (pb >= p1) {   // nothing of the sequence in this split
    if (split == 0 && n_used == 0) {      // nothing to attend to gives zeros
      for (int idx = threadIdx.x; idx < group * D; idx += kWarps * 32)
        store_row(out, out_f32, row0 * D + idx, 0.f);
      if (lse != nullptr && threadIdx.x < group)
        lse[row0 + threadIdx.x] = __int_as_float(0xff800000);   // -inf
    }
    return;
  }

  float m[GP], l[GP], acc[GP][EPL];
#pragma unroll
  for (int g = 0; g < GP; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < EPL; ++e) acc[g][e] = 0.f;
  }

  // this warp's ring: [stage][K, V][kPage][D]
  extern __shared__ __align__(16) uint8_t smem_raw[];
  T* ring = reinterpret_cast<T*>(smem_raw) + warp * 4 * PAGE;
  const int64_t tok_stride = static_cast<int64_t>(n_kv) * D;
  const int n_mine = max(0, (p1 - pb - warp + kWarps - 1) / kWarps);

  auto issue = [&](int i) {               // the warp's i-th page into stage i % 2
    const int page = pb + warp + kWarps * i;
    const int tok0 = page * kPage;
    const int entry = __shfl_sync(0xffffffffu, my_entry, page - p0);
    const int64_t off = static_cast<int64_t>(entry) * kPage * tok_stride + h * D;
    T* ks = ring + (i & 1) * 2 * PAGE;
    T* vs = ks + PAGE;
    for (int c = lane; c < kPage * (D / VEC); c += 32) {
      const int t = c / (D / VEC);
      const int e = (c % (D / VEC)) * VEC;
      const int bytes = tok0 + t >= lo && tok0 + t < length ? 16 : 0;
      cp_async16(ks + t * D + e, k_pool + off + t * tok_stride + e, bytes);
      cp_async16(vs + t * D + e, v_pool + off + t * tok_stride + e, bytes);
    }
  };

  if (n_mine > 0) issue(0);
  cp_async_commit();
  for (int i = 0; i < n_mine; ++i) {
    if (i + 1 < n_mine) issue(i + 1);
    cp_async_commit();                    // a group per step, empty at the end
    cp_async_wait_one();                  // page i has landed
    __syncwarp();
    const T* ks = ring + (i & 1) * 2 * PAGE;
    const T* vs = ks + PAGE;
    const int tok0 = (pb + warp + kWarps * i) * kPage;

    // from the chunk that holds lo: a chunk wholly below it is skipped, so
    // every chunk scored holds a token in range and the running max is real
    for (int c0 = max(0, lo - tok0) / CHUNK * CHUNK; c0 < kPage && tok0 + c0 < length;
         c0 += CHUNK) {
      // scores of this lane group's TI tokens against all query rows
      float s[GP][TI];
#pragma unroll
      for (int j = 0; j < TI; ++j) {
        const int t = c0 + TPS * j + tis;
        const bool valid = tok0 + t >= lo && tok0 + t < length;
        float kf[EPL];
        load_row<EPL>(ks + t * D + sub * EPL, kf);   // zeros outside the range
#pragma unroll
        for (int g = 0; g < GP; ++g) {
          float dot = 0.f;
#pragma unroll
          for (int e = 0; e < EPL; ++e) dot += qf[g][e] * kf[e];
#pragma unroll
          for (int o = LPR / 2; o > 0; o >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, o);
          s[g][j] = valid ? dot * scale : kNegInf;
        }
      }

      // online softmax over the chunk; the lane groups agree on the new max
#pragma unroll
      for (int g = 0; g < GP; ++g) {
        float mc = s[g][0];
#pragma unroll
        for (int j = 1; j < TI; ++j) mc = fmaxf(mc, s[g][j]);
#pragma unroll
        for (int o = LPR; o < 32; o <<= 1) mc = fmaxf(mc, __shfl_xor_sync(0xffffffffu, mc, o));
        const float m_new = fmaxf(m[g], mc);
        const float alpha = expf(m[g] - m_new);
        m[g] = m_new;
        l[g] *= alpha;
#pragma unroll
        for (int e = 0; e < EPL; ++e) acc[g][e] *= alpha;
#pragma unroll
        for (int j = 0; j < TI; ++j) {
          const float p = expf(s[g][j] - m_new);   // 0 for a masked token
          s[g][j] = p;
          l[g] += p;                               // this lane group's share
        }
      }

      // acc += p * v (a masked token's row is zeros and its weight 0)
#pragma unroll
      for (int j = 0; j < TI; ++j) {
        float vf[EPL];
        load_row<EPL>(vs + (c0 + TPS * j + tis) * D + sub * EPL, vf);
#pragma unroll
        for (int g = 0; g < GP; ++g) {
#pragma unroll
          for (int e = 0; e < EPL; ++e) acc[g][e] += s[g][j] * vf[e];
        }
      }
    }
    __syncwarp();                         // the stage may be loaded again
  }
  cp_async_wait_all();

  // the lane groups share m; add their sums and accumulators
#pragma unroll
  for (int o = LPR; o < 32; o <<= 1) {
#pragma unroll
    for (int g = 0; g < GP; ++g) {
      l[g] += __shfl_xor_sync(0xffffffffu, l[g], o);
#pragma unroll
      for (int e = 0; e < EPL; ++e) acc[g][e] += __shfl_xor_sync(0xffffffffu, acc[g][e], o);
    }
  }

  // the rings are done with: reuse them for the warps' partials
  __shared__ float sm_m[kWarps][GP];
  __shared__ float sm_l[kWarps][GP];
  __syncthreads();
  float* sm_acc = reinterpret_cast<float*>(smem_raw);   // [kWarps][GP][D]
  if (tis == 0) {
#pragma unroll
    for (int g = 0; g < GP; ++g) {
#pragma unroll
      for (int e = 0; e < EPL; ++e) sm_acc[(warp * GP + g) * D + sub * EPL + e] = acc[g][e];
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

  // merge the warps (a warp without pages has m = -inf, l = 0, acc = 0)
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
      num += wgt * sm_acc[(w * GP + g) * D + d];
      den += wgt * sm_l[w][g];
    }
    if (n_used == 1) {
      store_row(out, out_f32, (row0 + g) * D + d, num / fmaxf(den, 1e-30f));
      if (lse != nullptr && d == 0) lse[row0 + g] = m_all + logf(den);
    } else {
      part_acc[(part0 + g) * D + d] = num;
      if (d == 0) {
        part_m[part0 + g] = m_all;
        part_l[part0 + g] = den;
      }
    }
  }
  if (n_used == 1) return;

  // the split that takes the sequence's last ticket merges the partials: every
  // thread's stores are made visible to the device before the ticket is taken
  __shared__ bool sm_last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    int* ticket = tickets + static_cast<int64_t>(b) * gridDim.y + h;
    sm_last = atomicAdd(ticket, 1) == n_used - 1;
    if (sm_last) atomicExch(ticket, 0);   // every split has arrived: ready for the next launch
  }
  __syncthreads();
  if (!sm_last) return;
  __threadfence();

  // the used splits' m and l go to the shared memory past the warps' partials,
  // all loads at once; each becomes the split's weight exp(m_s - m_all) /
  // sum_s exp(m_s - m_all) l_s per query row. The partials are read through
  // L2 (.cg), where the other splits' stores landed.
  float* sm_w = sm_acc + kWarps * GP * D;   // [split][g]: m, then the weight
  float* sm_pl = sm_w + kMaxMerge;          // [split][g]: l
  // the first used split's row 0
  const int64_t first = part0 - static_cast<int64_t>(split - first_split) * group;
  for (int i = threadIdx.x; i < n_used * group; i += kWarps * 32) {
    sm_w[i] = __ldcg(part_m + first + i);
    sm_pl[i] = __ldcg(part_l + first + i);
  }
  __syncthreads();
  if (threadIdx.x < group) {
    const int g = threadIdx.x;
    float m_seq = kNegInf;
    for (int sp = 0; sp < n_used; ++sp) m_seq = fmaxf(m_seq, sm_w[sp * group + g]);
    float den = 0.f;
    for (int sp = 0; sp < n_used; ++sp) {
      const float wgt = expf(sm_w[sp * group + g] - m_seq);
      den += wgt * sm_pl[sp * group + g];
      sm_w[sp * group + g] = wgt;
    }
    const float inv = 1.f / fmaxf(den, 1e-30f);
    for (int sp = 0; sp < n_used; ++sp) sm_w[sp * group + g] *= inv;
    if (lse != nullptr) lse[row0 + g] = m_seq + logf(den);
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < group * D; idx += kWarps * 32) {
    const int g = idx / D;
    const int d = idx % D;
    float o = 0.f;
#pragma unroll 4
    for (int sp = 0; sp < n_used; ++sp)
      o += sm_w[sp * group + g] * __ldcg(part_acc + (first + sp * group + g) * D + d);
    store_row(out, out_f32, (row0 + g) * D + d, o);
  }
}

struct Args {
  const void *q, *k_pool, *v_pool;
  const int *block_tables, *lengths, *starts;
  void* out;
  float *lse, *part_m, *part_l, *part_acc;
  int* tickets;
  int B, n_kv, group, max_pages, n_splits;
  float scale;
  cudaStream_t stream;
};

template <typename T, int D, int GP, int LPR>
cudaError_t launch(const Args& a) {
  constexpr int smem = kWarps * 4 * kPage * D * sizeof(T);   // each warp: 2 stages of K, V
  // reused after the pages: the warps' partials, then the merge's weights
  static_assert(kWarps * GP * D * 4 + 2 * kMaxMerge * 4 <= smem, "merge scratch does not fit");
  cudaError_t err = cudaFuncSetAttribute(paged_attention_kernel<T, D, GP, LPR>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  paged_attention_kernel<T, D, GP, LPR>
      <<<dim3(a.B, a.n_kv, a.n_splits), kWarps * 32, smem, a.stream>>>(
          static_cast<const T*>(a.q), static_cast<const T*>(a.k_pool),
          static_cast<const T*>(a.v_pool), a.block_tables, a.lengths, a.starts,
          a.lse == nullptr ? static_cast<T*>(a.out) : nullptr,
          a.lse == nullptr ? nullptr : static_cast<float*>(a.out), a.lse, a.part_m,
          a.part_l, a.part_acc, a.tickets, a.n_kv,
          a.group, a.max_pages, a.scale);
  return cudaGetLastError();
}

// 8 lanes a row where the registers allow it (fewer shuffles per score);
// 16 for group 8, whose query rows and accumulators would not fit
template <typename T, int D, int GP>
cudaError_t launch_lpr(const Args& a) {
  return launch<T, D, GP, GP == 8 ? 16 : 8>(a);
}

template <typename T, int D>
cudaError_t launch_group(const Args& a) {
  if (a.group == 1) return launch_lpr<T, D, 1>(a);
  if (a.group == 2) return launch_lpr<T, D, 2>(a);
  if (a.group <= 4) return launch_lpr<T, D, 4>(a);
  if (a.group <= 8) return launch_lpr<T, D, 8>(a);
  return cudaErrorInvalidValue;
}

}  // namespace

// Launches the kernel on a (B, n_kv, n_splits) grid, n_splits = ceil(max_pages
// / 16); starts (B,) int32 is each sequence's first position (null: 0);
// part_m / part_l (B, n_kv, n_splits, group) and part_acc (..., D) are
// float32 scratch and tickets (B, n_kv) int32 counters that are 0 on entry and
// left 0 (all three unused when n_splits == 1); lse (B, n_kv, group) float32
// or null: given, `out` is float32 and takes the unrounded output, and lse
// each query row's log-sum-exp (-inf for a row with nothing in range). Returns cudaGetLastError()
// after the launch (0 = launched), or cudaErrorInvalidValue for a shape the
// kernel does not take.
extern "C" int paged_attention_launch(const void* q, const void* k_pool,
                                      const void* v_pool, const void* block_tables,
                                      const void* lengths, const void* starts, void* out,
                                      void* lse, void* part_m,
                                      void* part_l, void* part_acc, void* tickets,
                                      int B, int n_kv, int group, int D, int max_pages,
                                      int n_splits, int is_bf16, float scale,
                                      void* stream) {
  const Args a{q, k_pool, v_pool, static_cast<const int*>(block_tables),
               static_cast<const int*>(lengths), static_cast<const int*>(starts), out,
               static_cast<float*>(lse), static_cast<float*>(part_m),
               static_cast<float*>(part_l), static_cast<float*>(part_acc),
               static_cast<int*>(tickets), B, n_kv, group, max_pages, n_splits, scale,
               static_cast<cudaStream_t>(stream)};
  if (max_pages < 1 || n_splits * group > kMaxMerge ||
      n_splits != (max_pages + kPagesPerSplit - 1) / kPagesPerSplit ||
      (n_splits > 1 && tickets == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaErrorInvalidValue;
  if (is_bf16 && D == 128) err = launch_group<__nv_bfloat16, 128>(a);
  else if (is_bf16 && D == 96) err = launch_group<__nv_bfloat16, 96>(a);
  else if (is_bf16 && D == 80) err = launch_group<__nv_bfloat16, 80>(a);
  else if (is_bf16 && D == 64) err = launch_group<__nv_bfloat16, 64>(a);
  else if (!is_bf16 && D == 128) err = launch_group<float, 128>(a);
  else if (!is_bf16 && D == 96) err = launch_group<float, 96>(a);
  else if (!is_bf16 && D == 80) err = launch_group<float, 80>(a);
  else if (!is_bf16 && D == 64) err = launch_group<float, 64>(a);
  return static_cast<int>(err);
}
