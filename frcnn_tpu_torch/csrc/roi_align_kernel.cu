// K2: batched RoIAlign forward for Hopper (sm_90a).
//
// Replaces the TPU kernel frcnn_tpu/ops/pallas/roi_align_kernel.py
// (_fwd_kernel via roi_align_pallas).  Semantics of
// frcnn_tpu/ops/roi_align.py::roi_align: torchvision aligned=False, a fixed
// sampling ratio sr, roi_w = max(x2 - x1, 1) with no +1, sample k of an axis
// at lo + ((k + 0.5) / sr) * bin, a sample outside [-1, size] is empty (zero),
// the coordinate is clamped to [0, size - 1], high = min(low + 1, size - 1),
// and a bin is the mean of its sr * sr bilinear samples.
//
// Design: the gather form.  The TPU kernel phrased bilinear sampling as
// interpolation matmuls to feed its matrix unit; on Hopper each output value
// is 4 * sr^2 loads and as many FMAs, so the kernel gathers.  One block per
// (image, roi, bin); the sample geometry is computed once per block into
// shared memory and the threads run over channels, so with channels-last
// features every corner load of a warp is one contiguous run of C values.
// Accumulation is f32; the result is stored in the feature dtype.
// What bounds it on the H100: memory traffic - the output (B*R*p*p*C values,
// 241 MB in bf16 at 8 x 300 rois x 49 bins x 1024) is written once, and the
// corner reads of one image's 7.8 MB feature map come mostly from L2.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxSr = 8;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// Per-axis sample geometry: low/high index and their weights (both zero for
// an empty sample).
__device__ __forceinline__ void sample_axis(float lo, float bin, int k, int sr,
                                            int size, int* i_lo, int* i_hi,
                                            float* w_lo, float* w_hi) {
  const float s = __fdiv_rn(__fadd_rn((float)k, 0.5f), (float)sr);
  const float coord = __fadd_rn(lo, __fmul_rn(s, bin));
  if (coord < -1.0f || coord > (float)size) {
    *i_lo = 0; *i_hi = 0; *w_lo = 0.0f; *w_hi = 0.0f;
    return;
  }
  const float c = fminf(fmaxf(coord, 0.0f), (float)(size - 1));
  const float low = floorf(c);
  const float frac = __fsub_rn(c, low);
  *i_lo = (int)low;
  *i_hi = min(*i_lo + 1, size - 1);
  *w_lo = __fsub_rn(1.0f, frac);
  *w_hi = frac;
}

template <typename T>
__global__ void roi_align_fwd_kernel(const T* __restrict__ feat,
                                     const float* __restrict__ rois, int h,
                                     int w, int c, int r, int p, int sr,
                                     float scale, T* __restrict__ out) {
  const int bin = blockIdx.x;
  const int ri = blockIdx.y;
  const int bi = blockIdx.z;
  const int py = bin / p;
  const int px = bin - py * p;

  __shared__ int y_lo[kMaxSr], y_hi[kMaxSr], x_lo[kMaxSr], x_hi[kMaxSr];
  __shared__ float wy_lo[kMaxSr], wy_hi[kMaxSr], wx_lo[kMaxSr], wx_hi[kMaxSr];
  const int t = threadIdx.x;
  if (t < 2 * sr) {
    const float* roi = rois + ((size_t)bi * r + ri) * 4;
    const bool is_y = t >= sr;
    const int s = is_y ? t - sr : t;
    const float lo = __fmul_rn(roi[is_y ? 1 : 0], scale);
    const float hi = __fmul_rn(roi[is_y ? 3 : 2], scale);
    const float bin_sz = __fdiv_rn(fmaxf(__fsub_rn(hi, lo), 1.0f), (float)p);
    const int k = (is_y ? py : px) * sr + s;
    if (is_y) {
      sample_axis(lo, bin_sz, k, sr, h, &y_lo[s], &y_hi[s], &wy_lo[s], &wy_hi[s]);
    } else {
      sample_axis(lo, bin_sz, k, sr, w, &x_lo[s], &x_hi[s], &wx_lo[s], &wx_hi[s]);
    }
  }
  __syncthreads();

  const T* f = feat + (size_t)bi * h * w * c;
  T* o = out + (((size_t)bi * r + ri) * p * p + bin) * c;
  const float inv_count = 1.0f / (float)(sr * sr);
  for (int ch = t; ch < c; ch += blockDim.x) {
    float acc = 0.0f;
    for (int iy = 0; iy < sr; ++iy) {
      const T* row_lo = f + (size_t)y_lo[iy] * w * c + ch;
      const T* row_hi = f + (size_t)y_hi[iy] * w * c + ch;
      for (int ix = 0; ix < sr; ++ix) {
        const size_t xl = (size_t)x_lo[ix] * c, xh = (size_t)x_hi[ix] * c;
        const float top = wx_lo[ix] * to_float(row_lo[xl]) + wx_hi[ix] * to_float(row_lo[xh]);
        const float bot = wx_lo[ix] * to_float(row_hi[xl]) + wx_hi[ix] * to_float(row_hi[xh]);
        acc += wy_lo[iy] * top + wy_hi[iy] * bot;
      }
    }
    store(o + ch, acc * inv_count);
  }
}

}  // namespace

// feat (B, H, W, C) f32 or bf16, rois (B, R, 4) f32 image coordinates,
// out (B, R, p, p, C) in the feature dtype.
extern "C" int frcnn_roi_align_fwd(const void* feat, int is_bf16,
                                   const float* rois, int b, int h, int w,
                                   int c, int r, int p, int sr, float scale,
                                   void* out, cudaStream_t stream) {
  if (b <= 0 || r <= 0 || c <= 0) return 0;
  if (sr < 1 || sr > kMaxSr || p < 1 || h < 1 || w < 1 || r > 65535 || b > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int threads = min(256, (c + 31) / 32 * 32);
  dim3 grid(p * p, r, b);
  if (is_bf16) {
    roi_align_fwd_kernel<__nv_bfloat16><<<grid, threads, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(feat), rois, h, w, c, r, p, sr, scale,
        static_cast<__nv_bfloat16*>(out));
  } else {
    roi_align_fwd_kernel<float><<<grid, threads, 0, stream>>>(
        static_cast<const float*>(feat), rois, h, w, c, r, p, sr, scale,
        static_cast<float*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}
