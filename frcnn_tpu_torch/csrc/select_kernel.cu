// K5: exact top-k set of each row, index-ascending, for Hopper (sm_90a).
//
// Replaces the TPU kernel frcnn_tpu/ops/pallas/select_kernel.py
// (_thresh_kernel via topk_threshold).  Contract: for scores (B, S) f32 and
// 1 <= k <= S, the indices of lax.top_k's set of each row (the lowest index
// wins a tie at the cut; NaN counts as larger than +inf; -inf, +inf and
// every finite value are ordered as floats, -0.0 below +0.0), written in
// index-ascending order, with their values.
//
// Scores map to the int32 sortable keys of the TPU kernel (_sortable_keys:
// negative floats have their value bits flipped, NaN becomes 0x7FC00000),
// then to unsigned order by flipping the sign bit.
//
// Design, one 1024-thread block per row:
//   * radix select: four passes over the row, one per key byte from the
//     top, each a 256-bin histogram of the elements that match the digits
//     chosen so far (warp-aggregated shared atomics: __match_any_sync groups
//     the lanes holding one digit, so a clustered row does not serialise on
//     one bin).  After the fourth pass the k-th largest key T is known, and
//     r, how many of the elements equal to T belong to the set;
//   * stable compaction: each thread owns a contiguous chunk of the row;
//     block-wide exclusive scans give each thread its first tie rank and
//     then its first output slot, and the thread writes its selected
//     elements (key > T, or key == T with tie rank < r) in index order.
// Every count and prefix is an integer: the TPU kernel's round-4 chip bug
// was a prefix rounded through bf16 (select_kernel.py:127-136).
// What bounds it on the H100: latency.  A row is 88 KB at S = 21888 and
// stays in L1/L2 across the seven passes; with one block per row only B of
// the 132 SMs work, so the block's serial passes and barriers set the time.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ unsigned sort_key(float f) {
  const int u = __float_as_int(f);
  int key = u < 0 ? (u ^ 0x7fffffff) : u;
  if (isnan(f)) key = 0x7FC00000;
  return static_cast<unsigned>(key) ^ 0x80000000u;
}

// Exclusive prefix sum of one int per thread over the block; *total gets
// the block's sum.  Every thread must call it.
__device__ int block_exclusive_scan(int v, int* warp_sums, int* total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int incl = v;
  for (int off = 1; off < 32; off <<= 1) {
    const int n = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += n;
  }
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int w = lane < kWarps ? warp_sums[lane] : 0;
    for (int off = 1; off < 32; off <<= 1) {
      const int n = __shfl_up_sync(0xffffffffu, w, off);
      if (lane >= off) w += n;
    }
    warp_sums[lane] = w;  // inclusive over warps
  }
  __syncthreads();
  const int before = warp == 0 ? 0 : warp_sums[warp - 1];
  *total = warp_sums[kWarps - 1];
  __syncthreads();  // warp_sums is reused by the next call
  return before + incl - v;
}

__global__ void __launch_bounds__(kThreads)
topk_select_kernel(const float* __restrict__ scores, int s, int k,
                   float* __restrict__ vals, int* __restrict__ idx) {
  __shared__ unsigned hist[256];
  __shared__ unsigned s_prefix, s_mask;
  __shared__ int s_need;
  __shared__ int warp_sums[32];
  const int t = threadIdx.x;
  const int lane = t & 31;
  const float* x = scores + (size_t)blockIdx.x * s;

  if (t == 0) {
    s_prefix = 0u;
    s_mask = 0u;
    s_need = k;
  }
  for (int shift = 24; shift >= 0; shift -= 8) {
    for (int i = t; i < 256; i += kThreads) hist[i] = 0u;
    __syncthreads();
    const unsigned prefix = s_prefix, mask = s_mask;
    for (int base = 0; base < s; base += kThreads) {  // uniform trip count
      const int i = base + t;
      unsigned digit = 256u;
      if (i < s) {
        const unsigned u = sort_key(x[i]);
        if ((u & mask) == prefix) digit = (u >> shift) & 0xffu;
      }
      const unsigned peers = __match_any_sync(0xffffffffu, digit);
      if (digit < 256u && lane == __ffs(peers) - 1) atomicAdd(&hist[digit], __popc(peers));
    }
    __syncthreads();
    if (t == 0) {
      // the k-th largest lies in the highest digit d where the count of
      // matching elements with digit >= d reaches `need`
      const int need = s_need;
      int above = 0;
      int d = 255;
      for (; d > 0; --d) {
        if (above + (int)hist[d] >= need) break;
        above += (int)hist[d];
      }
      s_need = need - above;
      s_prefix = prefix | ((unsigned)d << shift);
      s_mask = mask | (0xffu << shift);
    }
    __syncthreads();
  }
  const unsigned thr = s_prefix;
  const int r = s_need;  // elements equal to thr that belong to the set

  const int chunk = (s + kThreads - 1) / kThreads;
  const int lo = min(s, t * chunk), hi = min(s, lo + chunk);
  int ties = 0;
  for (int i = lo; i < hi; ++i) ties += sort_key(x[i]) == thr;
  int total;
  int tie_rank = block_exclusive_scan(ties, warp_sums, &total);
  int count = 0;
  for (int i = lo, tr = tie_rank; i < hi; ++i) {
    const unsigned u = sort_key(x[i]);
    if (u > thr) {
      ++count;
    } else if (u == thr) {
      count += tr < r;
      ++tr;
    }
  }
  int slot = block_exclusive_scan(count, warp_sums, &total);
  float* v_out = vals + (size_t)blockIdx.x * k;
  int* i_out = idx + (size_t)blockIdx.x * k;
  for (int i = lo, tr = tie_rank; i < hi; ++i) {
    const float f = x[i];
    const unsigned u = sort_key(f);
    bool sel = u > thr;
    if (u == thr) sel = tr++ < r;
    if (sel) {
      v_out[slot] = f;
      i_out[slot] = i;
      ++slot;
    }
  }
}

}  // namespace

// scores (B, S) f32 → vals (B, k) f32, idx (B, k) i32.  1 <= k <= S.
extern "C" int frcnn_topk_threshold(const float* scores, int b, int s, int k,
                                    float* vals, int* idx, cudaStream_t stream) {
  if (b <= 0) return 0;
  if (k < 1 || k > s) return static_cast<int>(cudaErrorInvalidValue);
  topk_select_kernel<<<b, kThreads, 0, stream>>>(scores, s, k, vals, idx);
  return static_cast<int>(cudaGetLastError());
}
