// K1: batched exact greedy NMS for Hopper (sm_90a).
//
// Replaces the TPU kernel frcnn_tpu/ops/pallas/nms_kernel.py
// (_nms_kernel_b via nms_mask_pallas_batched).  Same contract: B independent
// problems, boxes sorted by descending score, a valid mask (invalid boxes are
// never kept and never suppress), an optional cap: the first max_keep kept
// boxes of a problem are exact, keep bits after the cap are zero.
//
// Design (the lineage's 64-box bitmask NMS, batched over problems):
//   * nms_mask_kernel: one 64-thread block per (problem, 64-row block,
//     64-column block at or right of the diagonal).  The column boxes and
//     their areas sit in shared memory; each thread writes one 64-bit word:
//     bit j set when IoU(row, col j) > thresh and col j > row.
//   * nms_reduce_kernel: one warp per problem walks the rows in score order,
//     holding the suppressed bitmap in shared memory.  A kept row ORs its
//     mask words into the bitmap (lanes split the words); the walk stops
//     once max_keep boxes are kept.
// What bounds it on the H100: the mask pass is B*N*N/2 IoUs (144 million at
// 8 x 6000) and writes B*N*N/8 bytes (36 MB), well under a millisecond; the
// walk is serial per problem and latency-bound (one dependent mask-row load
// per kept box), so the cap and the one-warp-per-problem layout keep it short.
//
// IoU is the division form of bbox_overlaps (frcnn_tpu/ops/boxes.py):
// inter / (area_a + area_b - inter) > thresh, zero when inter == 0, in the
// same operation order.  The _rn intrinsics stop nvcc from contracting a
// multiply and an add into an FMA, so the keep masks are bit-equal to the
// plain version's.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBoxes = 64;

__device__ __forceinline__ float box_area(float x1, float y1, float x2, float y2) {
  return __fmul_rn(__fadd_rn(__fsub_rn(x2, x1), 1.0f),
                   __fadd_rn(__fsub_rn(y2, y1), 1.0f));
}

__device__ __forceinline__ bool iou_above(const float* a, float area_a,
                                          const float* b, float area_b,
                                          float thresh) {
  float iw = __fadd_rn(__fsub_rn(fminf(a[2], b[2]), fmaxf(a[0], b[0])), 1.0f);
  float ih = __fadd_rn(__fsub_rn(fminf(a[3], b[3]), fmaxf(a[1], b[1])), 1.0f);
  float inter = __fmul_rn(fmaxf(iw, 0.0f), fmaxf(ih, 0.0f));
  float uni = __fsub_rn(__fadd_rn(area_a, area_b), inter);
  float iou = inter > 0.0f ? __fdiv_rn(inter, uni) : 0.0f;
  return iou > thresh;
}

__global__ void nms_mask_kernel(const float* __restrict__ boxes, int n,
                                int col_blocks, float thresh,
                                unsigned long long* __restrict__ mask) {
  const int row_block = blockIdx.y;
  const int col_block = blockIdx.x;
  if (col_block < row_block) return;  // the walk never reads left of the diagonal
  const int b = blockIdx.z;
  const int row_size = min(n - row_block * kBoxes, kBoxes);
  const int col_size = min(n - col_block * kBoxes, kBoxes);
  const float* bx = boxes + (size_t)b * n * 4;

  __shared__ float col_boxes[kBoxes * 4];
  __shared__ float col_area[kBoxes];
  const int t = threadIdx.x;
  if (t < col_size) {
    const float* c = bx + (size_t)(col_block * kBoxes + t) * 4;
    col_boxes[t * 4 + 0] = c[0];
    col_boxes[t * 4 + 1] = c[1];
    col_boxes[t * 4 + 2] = c[2];
    col_boxes[t * 4 + 3] = c[3];
    col_area[t] = box_area(c[0], c[1], c[2], c[3]);
  }
  __syncthreads();
  if (t >= row_size) return;

  const int i = row_block * kBoxes + t;
  const float a[4] = {bx[i * 4 + 0], bx[i * 4 + 1], bx[i * 4 + 2], bx[i * 4 + 3]};
  const float area_a = box_area(a[0], a[1], a[2], a[3]);
  unsigned long long bits = 0;
  for (int j = (row_block == col_block) ? t + 1 : 0; j < col_size; ++j) {
    if (iou_above(a, area_a, col_boxes + j * 4, col_area[j], thresh)) {
      bits |= 1ULL << j;
    }
  }
  mask[((size_t)b * n + i) * col_blocks + col_block] = bits;
}

__global__ void nms_reduce_kernel(const unsigned long long* __restrict__ mask,
                                  const uint8_t* __restrict__ valid, int n,
                                  int col_blocks, int max_keep,
                                  uint8_t* __restrict__ keep) {
  extern __shared__ unsigned long long removed[];
  const int b = blockIdx.x;
  const int lane = threadIdx.x;
  for (int w = lane; w < col_blocks; w += 32) removed[w] = 0ULL;
  __syncwarp();

  const unsigned long long* m = mask + (size_t)b * n * col_blocks;
  const uint8_t* v = valid + (size_t)b * n;
  uint8_t* k = keep + (size_t)b * n;
  int kept = 0;
  int i = 0;
  for (; i < n && kept < max_keep; ++i) {
    const int w = i >> 6;
    // uniform across the warp: row i's own mask never sets bit i
    const bool alive = v[i] && !((removed[w] >> (i & 63)) & 1ULL);
    __syncwarp();
    if (lane == 0) k[i] = alive;
    if (alive) {
      ++kept;
      const unsigned long long* row = m + (size_t)i * col_blocks;
      for (int x = w + lane; x < col_blocks; x += 32) removed[x] |= row[x];
      __syncwarp();
    }
  }
  for (int j = i + lane; j < n; j += 32) k[j] = 0;
}

}  // namespace

extern "C" const char* frcnn_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// boxes (B, N, 4) f32, valid (B, N) u8, mask scratch (B, N, ceil(N/64)) u64,
// keep (B, N) u8.  All device pointers; launches on `stream`.
extern "C" int frcnn_nms_batched(const float* boxes, const uint8_t* valid,
                                 int b, int n, float thresh, int max_keep,
                                 unsigned long long* mask, uint8_t* keep,
                                 cudaStream_t stream) {
  if (b <= 0 || n <= 0) return 0;
  const int col_blocks = (n + kBoxes - 1) / kBoxes;
  const size_t smem = (size_t)col_blocks * sizeof(unsigned long long);
  if (b > 65535 || col_blocks > 65535 || smem > 48 * 1024) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  dim3 grid(col_blocks, col_blocks, b);
  nms_mask_kernel<<<grid, kBoxes, 0, stream>>>(boxes, n, col_blocks, thresh, mask);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  nms_reduce_kernel<<<b, 32, smem, stream>>>(mask, valid, n, col_blocks,
                                             max_keep, keep);
  return static_cast<int>(cudaGetLastError());
}
