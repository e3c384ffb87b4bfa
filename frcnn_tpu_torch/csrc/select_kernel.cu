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
// What bounds it on the H100: bytes, the row read once (a few microseconds
// for every row the callers send).  Design: a thread-block cluster per row.
//   * Block j of the cluster owns the j-th contiguous segment of the row and
//     reads it from device memory ONCE, with 16-byte loads, into its shared
//     memory; every later pass runs on shared memory.  (A segment longer
//     than the shared memory given to the block keeps its tail in device
//     memory and re-reads that tail in each pass.)
//   * Radix select, four passes, one per key byte from the top: each block
//     builds a 256-bin histogram of its own elements that match the digits
//     chosen so far (warp-aggregated shared atomics: __match_any_sync groups
//     the lanes holding one digit, so a clustered row does not serialise on
//     one bin), one cluster barrier publishes it, and every block sums the
//     cluster's histograms through distributed shared memory and picks the
//     digit with a suffix scan over the 256 bins (eight warp scans).  Each
//     pass has its own histogram, so one cluster barrier a pass is enough.
//     After the fourth pass every block knows the k-th largest key T and r,
//     how many of the elements equal to T belong to the set.
//   * Ordered compaction: each warp owns a contiguous chunk of the block's
//     segment and counts its elements above T and equal to T; the blocks
//     exchange their totals (distributed shared memory again); exclusive
//     scans over blocks, then warps, give each warp its first tie rank and
//     its first output slot; the warp then walks CONSECUTIVE elements (32 a
//     step, ballot + popcount prefixes) and writes the selected ones (key >
//     T, or key == T with tie rank < r).  Segments in block order and chunks
//     in warp order keep the output index-ascending and spend r on the
//     lowest indices, across blocks too.
// Every count, prefix and rank is an integer: the TPU kernel's round-4 chip
// bug was a prefix rounded through bf16 (select_kernel.py:127-136).
// At batch 8 a cluster of 8 puts 64 blocks on the card.  What is left is
// latency: the launch, six cluster barriers and the passes over shared memory.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxCluster = 16;
constexpr int kMaxSmemFloats = 56320;  // 220 KB of dynamic shared memory
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ unsigned sort_key(float f) {
  const int u = __float_as_int(f);
  int key = u < 0 ? (u ^ 0x7fffffff) : u;
  if (isnan(f)) key = 0x7FC00000;
  return static_cast<unsigned>(key) ^ 0x80000000u;
}

__global__ void __launch_bounds__(kThreads)
topk_select_kernel(const float* __restrict__ scores, int s, int k, int seg, int cap,
                   float* __restrict__ vals, int* __restrict__ idx) {
  extern __shared__ __align__(16) float sm[];
  __shared__ int hist[4][256];       // one histogram a pass; read by the cluster
  __shared__ int blk_counts[2];      // elements above / equal to T; read by the cluster
  __shared__ int scan_tot[8];
  __shared__ int warp_gt[kWarps], warp_eq[kWarps];
  __shared__ unsigned s_prefix;
  __shared__ int s_need;

  cg::cluster_group cluster = cg::this_cluster();
  const int nranks = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int row = blockIdx.x / nranks;
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;

  const int lo = min(s, rank * seg);
  const int n = min(s, lo + seg) - lo;   // this block's elements: [lo, lo + n) of the row
  const float* xs = scores + (size_t)row * s + lo;
  const int n_sm = min(n, cap);          // of those, the ones kept in shared memory

  if ((reinterpret_cast<uintptr_t>(xs) & 15u) == 0) {
    const int nv = n_sm >> 2;
    const float4* src = reinterpret_cast<const float4*>(xs);
    float4* dst = reinterpret_cast<float4*>(sm);
    for (int i = t; i < nv; i += kThreads) dst[i] = __ldg(src + i);
    for (int i = (nv << 2) + t; i < n_sm; i += kThreads) sm[i] = xs[i];
  } else {
    for (int i = t; i < n_sm; i += kThreads) sm[i] = xs[i];
  }
  for (int i = t; i < 4 * 256; i += kThreads) (&hist[0][0])[i] = 0;
  __syncthreads();

  auto elem = [&](int i) { return i < n_sm ? sm[i] : xs[i]; };

  // ---- radix select --------------------------------------------------
  unsigned prefix = 0u, mask = 0u;
  int need = k;
  for (int pass = 0; pass < 4; ++pass) {
    const int shift = 24 - 8 * pass;
    int* h = hist[pass];
    for (int base = 0; base < n; base += kThreads) {  // whole warps: uniform trip count
      const int i = base + t;
      unsigned digit = 256u;
      if (i < n) {
        const unsigned u = sort_key(elem(i));
        if ((u & mask) == prefix) digit = (u >> shift) & 0xffu;
      }
      const unsigned peers = __match_any_sync(kFull, digit);
      if (digit < 256u && lane == __ffs(peers) - 1) atomicAdd(&h[digit], __popc(peers));
    }
    cluster.sync();
    // bin t of the row: the sum over the cluster's blocks
    int c = 0;
    if (t < 256) {
      for (int j = 0; j < nranks; ++j) c += cluster.map_shared_rank(h, j)[t];
    }
    // inclusive suffix sums over the 256 bins: how many matching elements
    // have a digit >= t
    int incl = c;
    for (int off = 1; off < 32; off <<= 1) {
      const int v = __shfl_down_sync(kFull, incl, off);
      if (lane + off < 32) incl += v;
    }
    if (t < 256 && lane == 0) scan_tot[warp] = incl;
    __syncthreads();
    if (t < 256) {
      for (int w = warp + 1; w < 8; ++w) incl += scan_tot[w];
      const int excl = incl - c;
      // the k-th largest lies in the one digit where the count reaches `need`
      if (excl < need && need <= incl) {
        s_prefix = prefix | (static_cast<unsigned>(t) << shift);
        s_need = need - excl;
      }
    }
    __syncthreads();
    prefix = s_prefix;
    need = s_need;
    mask |= 0xffu << shift;
    // scan_tot, s_prefix and s_need are written again only after the next
    // pass's cluster barrier
  }
  const unsigned thr = prefix;
  const int r = need;  // elements equal to thr that belong to the set

  // ---- ordered compaction -------------------------------------------
  const int chunk = (((n + kWarps - 1) / kWarps) + 31) & ~31;
  const int w_lo = min(n, warp * chunk), w_hi = min(n, w_lo + chunk);
  int gt = 0, eq = 0;
  for (int i = w_lo + lane; i < w_hi; i += 32) {
    const unsigned u = sort_key(elem(i));
    gt += u > thr;
    eq += u == thr;
  }
  for (int off = 16; off > 0; off >>= 1) {
    gt += __shfl_xor_sync(kFull, gt, off);
    eq += __shfl_xor_sync(kFull, eq, off);
  }
  if (lane == 0) {
    warp_gt[warp] = gt;
    warp_eq[warp] = eq;
  }
  __syncthreads();
  if (t == 0) {
    int g = 0, e = 0;
    for (int w = 0; w < kWarps; ++w) {
      g += warp_gt[w];
      e += warp_eq[w];
    }
    blk_counts[0] = g;
    blk_counts[1] = e;
  }
  cluster.sync();
  // exclusive scans in index order: the blocks before this one, then the
  // warps before this one; `taken` ties of each go to the set while r lasts
  int tie_run = 0, slot_run = 0;
  for (int j = 0; j < rank; ++j) {
    const int* c = cluster.map_shared_rank(blk_counts, j);
    const int g = c[0], e = c[1];
    slot_run += g + min(e, max(0, r - tie_run));
    tie_run += e;
  }
  for (int w = 0; w < warp; ++w) {
    const int g = warp_gt[w], e = warp_eq[w];
    slot_run += g + min(e, max(0, r - tie_run));
    tie_run += e;
  }
  float* v_out = vals + (size_t)row * k;
  int* i_out = idx + (size_t)row * k;
  const unsigned below = (1u << lane) - 1u;
  for (int base = w_lo; base < w_hi; base += 32) {
    const int i = base + lane;
    const bool in = i < w_hi;
    const float f = in ? elem(i) : 0.0f;
    const unsigned u = sort_key(f);
    const bool is_eq = in && u == thr;
    const unsigned eq_mask = __ballot_sync(kFull, is_eq);
    const bool sel = in && (u > thr || (is_eq && tie_run + __popc(eq_mask & below) < r));
    const unsigned sel_mask = __ballot_sync(kFull, sel);
    if (sel) {
      const int slot = slot_run + __popc(sel_mask & below);
      v_out[slot] = f;
      i_out[slot] = lo + i;
    }
    tie_run += __popc(eq_mask);
    slot_run += __popc(sel_mask);
  }
  // no block may exit while another still reads its counts
  cluster.sync();
}

}  // namespace

// scores (B, S) f32 → vals (B, k) f32, idx (B, k) i32.  1 <= k <= S.  A
// cluster of `cluster` blocks takes each row, block j the elements
// [j * seg, (j + 1) * seg); each block keeps the first `smem_floats` of its
// segment in shared memory.
extern "C" int frcnn_topk_threshold(const float* scores, int b, int s, int k,
                                    int cluster, int seg, int smem_floats,
                                    float* vals, int* idx, cudaStream_t stream) {
  if (b <= 0) return 0;
  if (k < 1 || k > s || cluster < 1 || cluster > kMaxCluster || seg < 1 || (seg & 3) != 0 ||
      (long long)seg * cluster < s || smem_floats < 0 || smem_floats > kMaxSmemFloats ||
      (long long)b * cluster > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t bytes = (size_t)smem_floats * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      topk_select_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess && cluster > 8) {
    err = cudaFuncSetAttribute(topk_select_kernel,
                               cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3((unsigned)(b * cluster), 1, 1);
  config.blockDim = dim3(kThreads, 1, 1);
  config.dynamicSmemBytes = bytes;
  config.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  config.attrs = attr;
  config.numAttrs = 1;
  err = cudaLaunchKernelEx(&config, topk_select_kernel, scores, s, k, seg, smem_floats, vals,
                           idx);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
