// K4: anchor-overlap statistics of the RPN anchor-target layer, batched over
// images, for Hopper (sm_90a).
//
// Replaces the TPU kernel frcnn_tpu/ops/pallas/overlap_kernel.py
// (_overlap_kernel via anchor_overlap_stats).  For anchors (K, 4), gt boxes
// (B, G, 4) with a validity mask (B, G) and an inside-image mask (B, K), the
// IoU of each (anchor, gt) pair is masked to -1 where the gt is invalid or
// the anchor lies outside, and the kernel returns per anchor
//   max_overlaps (B, K) f32, argmax (B, K) int32 (lowest gt index on a tie),
//   is_gt_argmax (B, K) u8: the anchor attains some valid gt's maximum over
//   all anchors, and that maximum is > 0,
// without materialising the (B, K, G) IoU matrix.
//
// Design: ONE launch, a thread-block cluster per image, no scratch in device
// memory, no memset, no global atomics; every output is written once.
//   * Block j of the cluster owns the j-th contiguous segment of the anchors
//     (a multiple of 32), a warp one chunk of 32 consecutive anchors at a time.
//   * Each block compacts the image's valid gt boxes into shared memory in
//     index order, with their areas and original indices: invalid slots cost
//     nothing afterwards.
//   * An exact cull per chunk: the bounding box of the chunk's INSIDE anchors
//     (warp reductions of order-preserving keys), then lanes l and l + 32
//     test compacted gts l and l + 32 against it with the IoU's own
//     arithmetic, iw = rn(rn(min(X2, gx2) - max(X1, gx1)) + 1) and the same
//     for ih; a ballot gives the 64-bit mask of the gts that may reach some
//     lane.  rn is monotone and every inside anchor lies in the box, so its
//     iw and ih are at most the box's: a gt whose iw or ih is <= 0 against
//     the box has inter = 0, hence IoU exactly 0 (as in the twin,
//     ops/boxes.py bbox_overlaps), for every lane.  Only the survivors pay an
//     IoU: max over the survivors with IoU > 0, else 0 at the lowest valid
//     index; outside anchors -1 at index 0.
//   * Per compacted gt a block maximum in shared memory (IoU >= 0, so its bits
//     order as unsigned: a warp __reduce_max_sync and one shared atomicMax),
//     over the survivors only, from 0: only a maximum > 0 can make a tie.  One
//     cluster barrier, then every block takes the cluster's maxima through
//     distributed shared memory (max is order-free: deterministic).
//   * The tie pass revisits only the chunks with a survivor and, in them, only
//     the gts whose block maximum equals the cluster maximum; the chunk's
//     survivor mask was kept in shared memory (8 bytes a chunk).  A chunk with
//     no survivor wrote is_gt_argmax = 0 in the first pass already.
// Tie membership compares floats, so every IoU must have the same bits in
// both passes and in the twin: one __device__ function with __f*_rn
// intrinsics (no FMA contraction) in the operation order of
// frcnn_tpu_torch/ops/boxes.py bbox_overlaps.
// What bounds it on the H100: by the count, bytes (the anchors, the inside
// mask and the three outputs once, ~15 MB at 8 x 155520: 0.0045 ms).  In
// fact (scripts/probe_overlap.py) a floor of 0.008 ms (C4, 21888 anchors)
// and 0.017 ms (FPN, 155520) with no valid gt: the launch, the two cluster
// barriers and each warp's chunks one after another, one chunk's loads in
// flight; above it, the survivors' IoUs where they crowd: at C4 the warp
// whose chunk keeps the most gts (a C4 chunk spans ~770 px, so most of an
// image's gts survive its cull), at FPN the blocks of the image with the
// most gts, bound by instruction throughput (the IoU's correctly rounded
// division, the compares, a warp reduction a gt).  Images do not share
// blocks: each has its cluster.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kMaxGt = 64;
constexpr int kMaxCluster = 16;
constexpr unsigned kFull = 0xffffffffu;
// dynamic shared memory: the chunk masks; with the static arrays below it
// stays under the 227 KB a block can have
constexpr int kMaxMaskBytes = 224 * 1024;

__device__ __forceinline__ float box_area(float4 b) {
  return __fmul_rn(__fadd_rn(__fsub_rn(b.z, b.x), 1.0f), __fadd_rn(__fsub_rn(b.w, b.y), 1.0f));
}

// whether boxes a and g intersect in bbox_overlaps' arithmetic (iw > 0 and
// ih > 0); a the box of a chunk's inside anchors in the cull
__device__ __forceinline__ bool reaches(float4 a, float4 g) {
  const float iw = __fadd_rn(__fsub_rn(fminf(a.z, g.z), fmaxf(a.x, g.x)), 1.0f);
  const float ih = __fadd_rn(__fsub_rn(fminf(a.w, g.w), fmaxf(a.y, g.y)), 1.0f);
  return iw > 0.0f && ih > 0.0f;
}

// bbox_overlaps(anchor, gt): inter / (area_a + area_g - inter), 0 when the
// boxes do not intersect.
__device__ __forceinline__ float iou(float4 a, float area_a, float4 g, float area_g) {
  const float iw = __fadd_rn(__fsub_rn(fminf(a.z, g.z), fmaxf(a.x, g.x)), 1.0f);
  const float ih = __fadd_rn(__fsub_rn(fminf(a.w, g.w), fmaxf(a.y, g.y)), 1.0f);
  const float inter = __fmul_rn(fmaxf(iw, 0.0f), fmaxf(ih, 0.0f));
  const float uni = __fsub_rn(__fadd_rn(area_a, area_g), inter);
  return inter > 0.0f ? __fdiv_rn(inter, uni) : 0.0f;
}

// Order-preserving float <-> unsigned map.
__device__ __forceinline__ unsigned ordered_key(float f) {
  const unsigned b = __float_as_uint(f);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

__device__ __forceinline__ float key_to_float(unsigned u) {
  return __uint_as_float((u & 0x80000000u) ? (u & 0x7fffffffu) : ~u);
}

__global__ void __launch_bounds__(kMaxThreads)
overlap_stats_kernel(const float4* __restrict__ anchors, int k, const float4* __restrict__ gt,
                     const uint8_t* __restrict__ gt_valid, int g,
                     const uint8_t* __restrict__ inside, int seg,
                     float* __restrict__ max_ov, int* __restrict__ argmax,
                     uint8_t* __restrict__ is_gt_argmax) {
  extern __shared__ unsigned long long chunk_mask[];  // survivors of each chunk
  __shared__ float4 s_box[kMaxGt];                     // the valid gt, compacted
  __shared__ float s_area[kMaxGt];
  __shared__ int s_orig[kMaxGt];
  __shared__ unsigned s_blk_max[kMaxGt];              // read by the cluster
  __shared__ float s_gmax[kMaxGt];
  __shared__ unsigned long long s_cand;
  __shared__ int s_nv;

  cg::cluster_group cluster = cg::this_cluster();
  const int nranks = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int bi = blockIdx.x / nranks;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
  const int lo = rank * seg, hi = min(lo + seg, k);
  const int nchunks = hi > lo ? (hi - lo + 31) >> 5 : 0;
  const unsigned below = (1u << lane) - 1u;

  if (warp == 0) {  // compaction in index order: lane l holds slots l and l + 32
    const bool v0 = lane < g && gt_valid[(size_t)bi * g + lane];
    const bool v1 = lane + 32 < g && gt_valid[(size_t)bi * g + lane + 32];
    const unsigned m0 = __ballot_sync(kFull, v0), m1 = __ballot_sync(kFull, v1);
    if (v0) {
      const int j = __popc(m0 & below);
      const float4 b = gt[(size_t)bi * g + lane];
      s_box[j] = b;
      s_area[j] = box_area(b);
      s_orig[j] = lane;
    }
    if (v1) {
      const int j = __popc(m0) + __popc(m1 & below);
      const float4 b = gt[(size_t)bi * g + lane + 32];
      s_box[j] = b;
      s_area[j] = box_area(b);
      s_orig[j] = lane + 32;
    }
    if (lane == 0) s_nv = __popc(m0) + __popc(m1);
  }
  if (threadIdx.x < kMaxGt) s_blk_max[threadIdx.x] = 0u;
  __syncthreads();
  const int nv = s_nv;
  const int first = nv > 0 ? s_orig[0] : 0;
  const bool has0 = lane < nv, has1 = lane + 32 < nv;  // the gts this lane culls
  const float4 g0 = s_box[has0 ? lane : 0], g1 = s_box[has1 ? lane + 32 : 0];
  const uint8_t* in_row = inside + (size_t)bi * k;
  const size_t out_row = (size_t)bi * k;

  // pass 1: cull, max / argmax, block maxima; the next chunk's loads in flight
  float4 a_next = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  bool in_next = false;
  if (lo + warp * 32 + lane < hi) {
    a_next = anchors[lo + warp * 32 + lane];
    in_next = in_row[lo + warp * 32 + lane] != 0;
  }
  unsigned wmax0 = 0u, wmax1 = 0u;                   // this warp's maxima, as bits
  for (int c = warp; c < nchunks; c += nwarps) {
    const int ai = lo + c * 32 + lane;
    const float4 a = a_next;
    const bool in = in_next && nv > 0;
    const int an = ai + nwarps * 32;
    a_next = an < hi ? anchors[an] : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    in_next = an < hi && in_row[an] != 0;
    unsigned long long mask = 0ull;
    if (__ballot_sync(kFull, in)) {
      const float4 box = make_float4(
          key_to_float(__reduce_min_sync(kFull, in ? ordered_key(a.x) : kFull)),
          key_to_float(__reduce_min_sync(kFull, in ? ordered_key(a.y) : kFull)),
          key_to_float(__reduce_max_sync(kFull, in ? ordered_key(a.z) : 0u)),
          key_to_float(__reduce_max_sync(kFull, in ? ordered_key(a.w) : 0u)));
      mask = (unsigned long long)__ballot_sync(kFull, has0 && reaches(box, g0)) |
             ((unsigned long long)__ballot_sync(kFull, has1 && reaches(box, g1)) << 32);
    }
    // the survivors two at a time (an odd last one twice: idempotent), in
    // index order; lane l keeps the warp's maxima of gts l and l + 32
    const float area_a = box_area(a);
    float mx = 0.0f;
    int am = -1;                                       // compacted; -1: the first valid
    for (unsigned long long m = mask; m;) {            // uniform over the warp
      const int j0 = __ffsll(static_cast<long long>(m)) - 1;
      m &= m - 1ull;
      const int j1 = m ? __ffsll(static_cast<long long>(m)) - 1 : j0;
      m &= m - 1ull;
      const float v0 = in ? iou(a, area_a, s_box[j0], s_area[j0]) : 0.0f;
      const float v1 = in ? iou(a, area_a, s_box[j1], s_area[j1]) : 0.0f;
      if (v0 > mx) {
        mx = v0;
        am = j0;
      }
      if (v1 > mx) {
        mx = v1;
        am = j1;
      }
      const unsigned w0 = __reduce_max_sync(kFull, __float_as_uint(v0));
      const unsigned w1 = __reduce_max_sync(kFull, __float_as_uint(v1));
      if (j0 == lane) wmax0 = max(wmax0, w0);
      if (j0 == lane + 32) wmax1 = max(wmax1, w0);
      if (j1 == lane) wmax0 = max(wmax0, w1);
      if (j1 == lane + 32) wmax1 = max(wmax1, w1);
    }
    if (ai < hi) {
      max_ov[out_row + ai] = in ? mx : -1.0f;
      argmax[out_row + ai] = in ? (am >= 0 ? s_orig[am] : first) : 0;
      if (mask == 0ull) is_gt_argmax[out_row + ai] = 0;
    }
    if (lane == 0) chunk_mask[c] = mask;
  }
  if (wmax0) atomicMax(&s_blk_max[lane], wmax0);
  if (wmax1) atomicMax(&s_blk_max[lane + 32], wmax1);

  // the cluster's maxima: every block's are final after the barrier
  cluster.sync();
  if (warp == 0) {
    unsigned m0 = 0u, m1 = 0u;
    for (int r = 0; r < nranks; ++r) {
      const unsigned* other = cluster.map_shared_rank(s_blk_max, r);
      if (has0) m0 = max(m0, other[lane]);
      if (has1) m1 = max(m1, other[lane + 32]);
    }
    if (has0) s_gmax[lane] = __uint_as_float(m0);
    if (has1) s_gmax[lane + 32] = __uint_as_float(m1);
    const unsigned c0 = __ballot_sync(kFull, m0 > 0u && s_blk_max[lane] == m0);
    const unsigned c1 = __ballot_sync(kFull, m1 > 0u && s_blk_max[lane + 32] == m1);
    if (lane == 0) s_cand = (unsigned long long)c0 | ((unsigned long long)c1 << 32);
  }
  // done reading the other blocks: they may exit once every block is here
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
  __syncthreads();

  // pass 2: ties, only in chunks with a survivor and only for the candidates
  const unsigned long long cand = s_cand;
  for (int c = warp; c < nchunks; c += nwarps) {
    const unsigned long long mask = chunk_mask[c];
    if (mask == 0ull) continue;                        // written in pass 1
    const int ai = lo + c * 32 + lane;
    bool tie = false;
    const unsigned long long m = mask & cand;
    if (m && ai < hi && in_row[ai]) {
      const float4 a = anchors[ai];
      const float area_a = box_area(a);
      for (unsigned long long t = m; t; t &= t - 1ull) {
        const int j = __ffsll(static_cast<long long>(t)) - 1;
        tie |= iou(a, area_a, s_box[j], s_area[j]) == s_gmax[j];
      }
    }
    if (ai < hi) is_gt_argmax[out_row + ai] = tie;
  }
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

}  // namespace

// anchors (K, 4) f32, gt (B, G, 4) f32, gt_valid (B, G) u8, inside (B, K)
// u8 → max_ov (B, K) f32, argmax (B, K) i32, is_gt_argmax (B, K) u8.
// 1 <= G <= 64.  A cluster of `cluster` blocks of `threads` threads takes
// each image, block j the anchors [j * seg, (j + 1) * seg); `smem_bytes`
// must be the chunk masks' size, 8 bytes for each 32 anchors of a segment.
extern "C" int frcnn_anchor_overlap_stats(const float* anchors, int k, const float* gt,
                                          const uint8_t* gt_valid, int b, int g,
                                          const uint8_t* inside, int cluster, int threads,
                                          int seg, int smem_bytes, float* max_ov, int* argmax,
                                          uint8_t* is_gt_argmax, cudaStream_t stream) {
  if (b <= 0 || k <= 0) return 0;
  if (g < 1 || g > kMaxGt || cluster < 1 || cluster > kMaxCluster || threads < 32 ||
      threads > kMaxThreads || (threads & 31) != 0 || seg < 32 || (seg & 31) != 0 ||
      (long long)seg * cluster < k || smem_bytes != seg / 32 * 8 ||
      smem_bytes > kMaxMaskBytes || (long long)b * cluster > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaFuncSetAttribute(
      overlap_stats_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err == cudaSuccess && cluster > 8) {
    err = cudaFuncSetAttribute(overlap_stats_kernel,
                               cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3((unsigned)(b * cluster), 1, 1);
  config.blockDim = dim3((unsigned)threads, 1, 1);
  config.dynamicSmemBytes = (size_t)smem_bytes;
  config.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  config.attrs = attr;
  config.numAttrs = 1;
  err = cudaLaunchKernelEx(&config, overlap_stats_kernel,
                           reinterpret_cast<const float4*>(anchors), k,
                           reinterpret_cast<const float4*>(gt), gt_valid, g, inside, seg, max_ov,
                           argmax, is_gt_argmax);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
