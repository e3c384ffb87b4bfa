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
// Design: two passes over a (K / 256, B) grid, one thread per anchor, the
// image's gt boxes and areas in shared memory.
//   * pass 1 computes each anchor's max/argmax and the per-gt maximum: per
//     gt a warp max (__reduce_max_sync) of order-preserving unsigned keys,
//     then one shared and one global atomicMax per warp and per block;
//   * pass 2 recomputes every IoU and compares it with the per-gt maxima.
// Tie membership compares floats, so both passes must produce the same
// bits: the IoU is one __device__ function with __f*_rn intrinsics (no FMA
// contraction) in the operation order of frcnn_tpu_torch/ops/boxes.py
// bbox_overlaps, as K1 does, which is also what makes the outputs bit-equal
// to the plain twin.
// What bounds it on the H100: K * G IoUs per image twice (11 million at
// 21888 x 64 x 8, a few microseconds of arithmetic); the launches and the
// per-gt reductions dominate.  Nothing of size K * G touches memory.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxGt = 64;

__device__ __forceinline__ float box_area(const float* b) {
  return __fmul_rn(__fadd_rn(__fsub_rn(b[2], b[0]), 1.0f),
                   __fadd_rn(__fsub_rn(b[3], b[1]), 1.0f));
}

// bbox_overlaps(anchor, gt): inter / (area_a + area_g - inter), 0 when the
// boxes do not intersect.
__device__ __forceinline__ float iou(const float* a, float area_a,
                                     const float* g, float area_g) {
  const float iw = __fadd_rn(__fsub_rn(fminf(a[2], g[2]), fmaxf(a[0], g[0])), 1.0f);
  const float ih = __fadd_rn(__fsub_rn(fminf(a[3], g[3]), fmaxf(a[1], g[1])), 1.0f);
  const float inter = __fmul_rn(fmaxf(iw, 0.0f), fmaxf(ih, 0.0f));
  const float uni = __fsub_rn(__fadd_rn(area_a, area_g), inter);
  return inter > 0.0f ? __fdiv_rn(inter, uni) : 0.0f;
}

// Order-preserving float -> unsigned map (0 sorts below every float).
__device__ __forceinline__ unsigned ordered_key(float f) {
  const unsigned b = __float_as_uint(f);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

__device__ __forceinline__ float key_to_float(unsigned u) {
  return __uint_as_float((u & 0x80000000u) ? (u & 0x7fffffffu) : ~u);
}

struct GtTile {
  float box[kMaxGt][4];
  float area[kMaxGt];
  int valid[kMaxGt];
};

__device__ __forceinline__ void load_gt(GtTile* s, const float* gt,
                                        const uint8_t* gt_valid, int bi, int g) {
  const int t = threadIdx.x;
  if (t < g) {
    const float* src = gt + ((size_t)bi * g + t) * 4;
    for (int j = 0; j < 4; ++j) s->box[t][j] = src[j];
    s->area[t] = box_area(src);
    s->valid[t] = gt_valid[(size_t)bi * g + t] != 0;
  }
}

__global__ void overlap_max_kernel(const float* __restrict__ anchors, int k,
                                   const float* __restrict__ gt,
                                   const uint8_t* __restrict__ gt_valid, int g,
                                   const uint8_t* __restrict__ inside,
                                   unsigned* __restrict__ gt_max_keys,
                                   float* __restrict__ max_ov,
                                   int* __restrict__ argmax) {
  __shared__ GtTile s;
  __shared__ unsigned block_max[kMaxGt];
  const int bi = blockIdx.y;
  const int t = threadIdx.x;
  load_gt(&s, gt, gt_valid, bi, g);
  if (t < g) block_max[t] = 0u;
  __syncthreads();

  const int ai = blockIdx.x * kThreads + t;
  const bool active = ai < k;
  float a[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  bool in = false;
  if (active) {
    for (int j = 0; j < 4; ++j) a[j] = anchors[(size_t)ai * 4 + j];
    in = inside[(size_t)bi * k + ai] != 0;
  }
  const float area_a = box_area(a);
  float mx = 0.0f;
  int am = 0;
  for (int gi = 0; gi < g; ++gi) {  // uniform over the block: warps reduce
    const float ov = (in && s.valid[gi]) ? iou(a, area_a, s.box[gi], s.area[gi]) : -1.0f;
    if (gi == 0 || ov > mx) {
      mx = ov;
      am = gi;
    }
    const unsigned wmax = __reduce_max_sync(0xffffffffu, active ? ordered_key(ov) : 0u);
    if ((t & 31) == 0) atomicMax(&block_max[gi], wmax);
  }
  if (active) {
    max_ov[(size_t)bi * k + ai] = mx;
    argmax[(size_t)bi * k + ai] = am;
  }
  __syncthreads();
  if (t < g) atomicMax(&gt_max_keys[(size_t)bi * g + t], block_max[t]);
}

__global__ void overlap_ties_kernel(const float* __restrict__ anchors, int k,
                                    const float* __restrict__ gt,
                                    const uint8_t* __restrict__ gt_valid, int g,
                                    const uint8_t* __restrict__ inside,
                                    const unsigned* __restrict__ gt_max_keys,
                                    uint8_t* __restrict__ is_gt_argmax) {
  __shared__ GtTile s;
  __shared__ float gt_max[kMaxGt];
  const int bi = blockIdx.y;
  const int t = threadIdx.x;
  load_gt(&s, gt, gt_valid, bi, g);
  if (t < g) gt_max[t] = key_to_float(gt_max_keys[(size_t)bi * g + t]);
  __syncthreads();

  const int ai = blockIdx.x * kThreads + t;
  if (ai >= k) return;
  uint8_t tie = 0;
  if (inside[(size_t)bi * k + ai]) {
    float a[4];
    for (int j = 0; j < 4; ++j) a[j] = anchors[(size_t)ai * 4 + j];
    const float area_a = box_area(a);
    for (int gi = 0; gi < g; ++gi) {
      if (s.valid[gi] && gt_max[gi] > 0.0f &&
          iou(a, area_a, s.box[gi], s.area[gi]) == gt_max[gi]) {
        tie = 1;
        break;
      }
    }
  }
  is_gt_argmax[(size_t)bi * k + ai] = tie;
}

}  // namespace

// anchors (K, 4) f32, gt (B, G, 4) f32, gt_valid (B, G) u8, inside (B, K)
// u8; gt_max_keys (B, G) u32 scratch; outputs max_ov (B, K) f32, argmax
// (B, K) i32, is_gt_argmax (B, K) u8.  1 <= G <= 64.
extern "C" int frcnn_anchor_overlap_stats(const float* anchors, int k,
                                          const float* gt,
                                          const uint8_t* gt_valid, int b, int g,
                                          const uint8_t* inside,
                                          unsigned* gt_max_keys, float* max_ov,
                                          int* argmax, uint8_t* is_gt_argmax,
                                          cudaStream_t stream) {
  if (b <= 0 || k <= 0) return 0;
  if (g < 1 || g > kMaxGt || b > 65535) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaMemsetAsync(gt_max_keys, 0, (size_t)b * g * sizeof(unsigned), stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((k + kThreads - 1) / kThreads, b);
  overlap_max_kernel<<<grid, kThreads, 0, stream>>>(anchors, k, gt, gt_valid, g, inside,
                                                    gt_max_keys, max_ov, argmax);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  overlap_ties_kernel<<<grid, kThreads, 0, stream>>>(anchors, k, gt, gt_valid, g, inside,
                                                     gt_max_keys, is_gt_argmax);
  return static_cast<int>(cudaGetLastError());
}
