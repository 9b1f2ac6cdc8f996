// The masks and loop bounds of flash_prefill, shared by its forward
// (flash_prefill.cu) and backward (flash_prefill_bwd.cu) kernels so that the
// two cannot drift apart. Both walk tiles of 64 query rows and 64 KV rows.
#pragma once

// The reference's mask: key `col` is seen by the query at absolute position
// `qpos` when it exists and, if causal, lies on or below the diagonal and
// inside the window (0 = none), or inside the bidirectional prefix.
static __device__ __forceinline__ bool visible(int col, int qpos, int Tkv, int causal,
                                               int window, int prefix_len) {
  if (col >= Tkv) return false;
  if (!causal) return true;
  return (col <= qpos && (window == 0 || col > qpos - window)) || col < prefix_len;
}

// The KV rows [lo, hi) a tile of query rows [q0, q0 + 64) must visit, lo a
// multiple of 64: up to the diagonal of its last row (or the end of the
// prefix, if later); from the first tile its first row's window reaches when
// there is a window and no prefix (with both, from 0: the per-element mask
// does the rest).
static __device__ __forceinline__ void kv_range(int q0, int S, int Tkv, int q_offset,
                                                int causal, int window, int prefix_len,
                                                int& lo, int& hi) {
  lo = 0;
  hi = Tkv;
  if (!causal) return;
  hi = min(Tkv, max(q_offset + min(q0 + 64, S), prefix_len));
  if (window > 0 && prefix_len == 0) lo = max(0, q_offset + q0 - window + 1) / 64 * 64;
}
