// K2: batched RoIAlign forward, K2b: its backward, K6: the multilevel (FPN)
// RoIAlign forward, and K6b: the multilevel backward, for Hopper (sm_90a).
//
// Replaces the TPU kernels frcnn_tpu/ops/pallas/roi_align_kernel.py
// (_fwd_kernel via roi_align_pallas, _bwd_kernel via _bwd_rule,
// _fwd_kernel_lv / _fwd_kernel_lv_yf via roi_align_level_fwd together with
// _fwd_kernel_ml via roi_align_levels_fwd_merged, and _bwd_kernel_lv /
// _bwd_kernel_lv_yf via roi_align_level_bwd).  Semantics of
// frcnn_tpu/ops/roi_align.py::roi_align: torchvision aligned=False, a fixed
// sampling ratio sr, roi_w = max(x2 - x1, 1) with no +1, sample k of an axis
// at lo + ((k + 0.5) / sr) * bin, a sample outside [-1, size] is empty (zero),
// the coordinate is clamped to [0, size - 1], high = min(low + 1, size - 1),
// and a bin is the mean of its sr * sr bilinear samples.
//
// Design: the gather form.  The TPU kernels phrased bilinear sampling as
// interpolation matmuls to feed its matrix unit; on Hopper each output value
// is 4 * sr^2 loads and as many FMAs, so the kernels gather.  One block per
// (image, roi, bin); the sample geometry is computed once per block into
// shared memory (bin_geometry) and the threads run over channels, two
// adjacent channels a thread where C is even (bf16x2 / float2 loads), so with
// channels-last features every corner load of a warp is one contiguous run.
// The interpolation (bilerp) is written with explicit round-to-nearest
// intrinsics, so K2 and K6 share its bits: on one level they agree exactly.
// Accumulation is f32; the result is rounded once to the feature dtype.
// What bounds K2 on the H100: memory traffic - the output (B*R*p*p*C values,
// 241 MB in bf16 at 8 x 300 rois x 49 bins x 1024) is written once, and the
// corner reads of one image's 7.8 MB feature map come mostly from L2.
//
// K6, the FPN forward: the same block layout over all pyramid levels in ONE
// launch.  Each block reads its roi's level and takes that level's base
// pointer, (H, W) and scale from a small struct passed by value, so the
// levels are never concatenated into one table and rois stay in their own
// order (the TPU path sorted rois by level and carried the inverse
// permutation; K6 needs neither).  A roi whose level is outside [0, L) gets
// zeros.  What bounds it: the output write (60 MB in bf16 at 8 x 300 rois x
// 49 bins x 256) and the corner reads, which mostly hit L2.
//
// K2b, the backward (dF only; rois get no gradient, as in the TPU kernel):
// the same block layout, each thread scattering its channel's share of a
// bin's gradient to the 4 * sr^2 sample corners with f32 atomicAdd into a
// zeroed f32 buffer; a second pass rounds it once to the feature dtype, as
// the TPU kernel's f32 scratch accumulator does.  The order of the atomic
// adds varies from run to run, so the result is not bit-deterministic.
// What bounds it on the H100: the atomics - 16 reductions per channel per
// bin (822 million at 8 x 128 rois x 49 bins x 1024), served by L2; where C
// is even a thread takes two adjacent channels and adds them with one
// float2 atomic (two scalar atomics a thread took 1.79 ms against 0.91 at
// that shape, and 1.08 against 0.74 for K6b, on an H100 at 700 W).
//
// K6b, the FPN backward (dF of every level; rois and levels get none): K2b's
// scatter over all pyramid levels in ONE launch.  Each block reads its roi's
// level and scatters into that level's slice of one f32 accumulator (the
// levels laid end to end, cleared by one memset); a roi whose level is
// outside [0, L) contributes nothing, as K6 pools zeros there.  One pass then
// rounds the whole accumulator to the feature dtype.  The TPU kernel sorted
// rois by level, launched once per level and ran dense interpolation matmuls
// into a VMEM accumulator; none of that is needed here.  It shares
// bin_geometry and scatter_channels with K2b, so on one level the two add
// the same values (their order differs: not bit-deterministic either).
// What bounds it on the H100: memory traffic, and not the scatter's - the
// accumulator of P2-P5 at 8 x 608x1024 x 256 is 424 MB of f32 that is
// cleared, read back and rounded to 212 MB of bf16, against 26 MB of
// gradient read; the least the card must move is the 212 MB written once.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

namespace {

constexpr int kMaxSr = 8;
constexpr int kMaxLevels = 8;

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// V adjacent channels from a V-aligned address (V = 1 or 2).
template <int V>
__device__ __forceinline__ void load_v(const float* p, float* v) {
  if constexpr (V == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    v[0] = t.x; v[1] = t.y;
  } else {
    v[0] = *p;
  }
}
template <int V>
__device__ __forceinline__ void load_v(const __nv_bfloat16* p, float* v) {
  if constexpr (V == 2) {
    const float2 t = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
    v[0] = t.x; v[1] = t.y;
  } else {
    v[0] = __bfloat162float(*p);
  }
}
template <int V>
__device__ __forceinline__ void store_v(float* p, const float* v) {
  if constexpr (V == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  } else {
    *p = v[0];
  }
}
template <int V>
__device__ __forceinline__ void store_v(__nv_bfloat16* p, const float* v) {
  if constexpr (V == 2) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v[0], v[1]);
  } else {
    *p = __float2bfloat16_rn(v[0]);
  }
}

// The sr x sr sample geometry of one bin, per axis: low/high index and their
// weights (both zero for an empty sample).
struct BinGeometry {
  int y_lo[kMaxSr], y_hi[kMaxSr], x_lo[kMaxSr], x_hi[kMaxSr];
  float wy_lo[kMaxSr], wy_hi[kMaxSr], wx_lo[kMaxSr], wx_hi[kMaxSr];
};

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

// Thread t < 2 * sr of a block fills sample t of bin (py, px) of the roi
// (x1, y1, x2, y2 in image coordinates) on an h x w map: x samples for
// t < sr, y samples for the rest.
__device__ __forceinline__ void bin_geometry(const float* roi, float scale, int p,
                                             int sr, int py, int px, int h, int w,
                                             int t, BinGeometry* g) {
  const bool is_y = t >= sr;
  const int s = is_y ? t - sr : t;
  const float lo = __fmul_rn(roi[is_y ? 1 : 0], scale);
  const float hi = __fmul_rn(roi[is_y ? 3 : 2], scale);
  const float bin_sz = __fdiv_rn(fmaxf(__fsub_rn(hi, lo), 1.0f), (float)p);
  const int k = (is_y ? py : px) * sr + s;
  if (is_y) {
    sample_axis(lo, bin_sz, k, sr, h, &g->y_lo[s], &g->y_hi[s], &g->wy_lo[s], &g->wy_hi[s]);
  } else {
    sample_axis(lo, bin_sz, k, sr, w, &g->x_lo[s], &g->x_hi[s], &g->wx_lo[s], &g->wx_hi[s]);
  }
}

__device__ __forceinline__ float bilerp(float v00, float v01, float v10, float v11,
                                        float wy_lo, float wy_hi, float wx_lo,
                                        float wx_hi) {
  const float top = __fmaf_rn(wx_hi, v01, __fmul_rn(wx_lo, v00));
  const float bot = __fmaf_rn(wx_hi, v11, __fmul_rn(wx_lo, v10));
  return __fmaf_rn(wy_hi, bot, __fmul_rn(wy_lo, top));
}

// The bin's value for channels [ch, ch + V) of the channels-last (h, w, c)
// map f: the mean of its sr * sr bilinear samples, in f32.
template <int V, typename T>
__device__ __forceinline__ void pool_bin(const T* f, int w, int c, int ch, int sr,
                                         const BinGeometry& g, float* acc) {
  for (int j = 0; j < V; ++j) acc[j] = 0.0f;
  for (int iy = 0; iy < sr; ++iy) {
    const T* row_lo = f + (size_t)g.y_lo[iy] * w * c + ch;
    const T* row_hi = f + (size_t)g.y_hi[iy] * w * c + ch;
    for (int ix = 0; ix < sr; ++ix) {
      const size_t xl = (size_t)g.x_lo[ix] * c, xh = (size_t)g.x_hi[ix] * c;
      float v00[V], v01[V], v10[V], v11[V];
      load_v<V>(row_lo + xl, v00);
      load_v<V>(row_lo + xh, v01);
      load_v<V>(row_hi + xl, v10);
      load_v<V>(row_hi + xh, v11);
      for (int j = 0; j < V; ++j) {
        acc[j] = __fadd_rn(acc[j], bilerp(v00[j], v01[j], v10[j], v11[j], g.wy_lo[iy],
                                          g.wy_hi[iy], g.wx_lo[ix], g.wx_hi[ix]));
      }
    }
  }
  const float inv_count = __fdiv_rn(1.0f, (float)(sr * sr));
  for (int j = 0; j < V; ++j) acc[j] = __fmul_rn(acc[j], inv_count);
}

template <int V, typename T>
__device__ __forceinline__ void pool_channels(const T* f, int w, int c, int sr,
                                              const BinGeometry& g, T* o) {
  for (int ch = (int)threadIdx.x * V; ch < c; ch += (int)blockDim.x * V) {
    float acc[V];
    pool_bin<V>(f, w, c, ch, sr, g, acc);
    store_v<V>(o + ch, acc);
  }
}

template <typename T, int V>
__global__ void roi_align_fwd_kernel(const T* __restrict__ feat,
                                     const float* __restrict__ rois, int h,
                                     int w, int c, int r, int p, int sr,
                                     float scale, T* __restrict__ out) {
  const int bin = blockIdx.x;
  const int ri = blockIdx.y;
  const int bi = blockIdx.z;
  const size_t roi = (size_t)bi * r + ri;
  __shared__ BinGeometry g;
  if ((int)threadIdx.x < 2 * sr) {
    bin_geometry(rois + roi * 4, scale, p, sr, bin / p, bin % p, h, w, threadIdx.x, &g);
  }
  __syncthreads();
  pool_channels<V>(feat + (size_t)bi * h * w * c, w, c, sr, g,
                   out + (roi * p * p + bin) * c);
}

// The pyramid levels of K6: per level a (B, H, W, C) map, its size and its
// spatial scale (1 / stride).
struct Levels {
  const void* feat[kMaxLevels];
  int h[kMaxLevels];
  int w[kMaxLevels];
  float scale[kMaxLevels];
  int n;
};

template <typename T, int V>
__global__ void roi_align_ml_fwd_kernel(Levels lv, const float* __restrict__ rois,
                                        const int* __restrict__ levels, int c, int r,
                                        int p, int sr, T* __restrict__ out) {
  const int bin = blockIdx.x;
  const int ri = blockIdx.y;
  const int bi = blockIdx.z;
  const size_t roi = (size_t)bi * r + ri;
  T* o = out + (roi * p * p + bin) * c;
  const int l = levels[roi];
  if (l < 0 || l >= lv.n) {  // the whole block leaves: no barrier is skipped
    for (int ch = (int)threadIdx.x; ch < c; ch += (int)blockDim.x) store(o + ch, 0.0f);
    return;
  }
  const int h = lv.h[l], w = lv.w[l];
  __shared__ BinGeometry g;
  if ((int)threadIdx.x < 2 * sr) {
    bin_geometry(rois + roi * 4, lv.scale[l], p, sr, bin / p, bin % p, h, w, threadIdx.x, &g);
  }
  __syncthreads();
  pool_channels<V>(static_cast<const T*>(lv.feat[l]) + (size_t)bi * h * w * c, w, c, sr, g,
                   o);
}

// Adds v[j] * wgt to V adjacent f32 values at a V-aligned address: one float2
// atomic for V = 2 (sm_90), one scalar atomic for V = 1.
template <int V>
__device__ __forceinline__ void atomic_add_v(float* p, const float* v, float wgt) {
  if constexpr (V == 2) {
    atomicAdd(reinterpret_cast<float2*>(p), make_float2(v[0] * wgt, v[1] * wgt));
  } else {
    atomicAdd(p, v[0] * wgt);
  }
}

// One bin's gradient gd (c channels) scattered to its 4 * sr^2 sample corners
// of the channels-last f32 (h, w, c) accumulator df: the adjoint of
// pool_channels.  Empty samples (both weights zero) and zero gradients add
// nothing.
template <int V, typename T>
__device__ __forceinline__ void scatter_channels(const T* gd, float* df, int w, int c,
                                                 int sr, const BinGeometry& g) {
  const float inv_count = 1.0f / (float)(sr * sr);
  for (int ch = (int)threadIdx.x * V; ch < c; ch += (int)blockDim.x * V) {
    float gv[V];
    load_v<V>(gd + ch, gv);
    bool any = false;
    for (int j = 0; j < V; ++j) {
      gv[j] *= inv_count;
      any = any || gv[j] != 0.0f;
    }
    if (!any) continue;
    for (int iy = 0; iy < sr; ++iy) {
      if (g.wy_lo[iy] == 0.0f && g.wy_hi[iy] == 0.0f) continue;  // empty sample
      float* row_lo = df + (size_t)g.y_lo[iy] * w * c + ch;
      float* row_hi = df + (size_t)g.y_hi[iy] * w * c + ch;
      float gy_lo[V], gy_hi[V];
      for (int j = 0; j < V; ++j) {
        gy_lo[j] = gv[j] * g.wy_lo[iy];
        gy_hi[j] = gv[j] * g.wy_hi[iy];
      }
      for (int ix = 0; ix < sr; ++ix) {
        if (g.wx_lo[ix] == 0.0f && g.wx_hi[ix] == 0.0f) continue;
        const size_t xl = (size_t)g.x_lo[ix] * c, xh = (size_t)g.x_hi[ix] * c;
        atomic_add_v<V>(row_lo + xl, gy_lo, g.wx_lo[ix]);
        atomic_add_v<V>(row_lo + xh, gy_lo, g.wx_hi[ix]);
        atomic_add_v<V>(row_hi + xl, gy_hi, g.wx_lo[ix]);
        atomic_add_v<V>(row_hi + xh, gy_hi, g.wx_hi[ix]);
      }
    }
  }
}

template <typename T, int V>
__global__ void roi_align_bwd_kernel(const T* __restrict__ dout,
                                     const float* __restrict__ rois, int h,
                                     int w, int c, int r, int p, int sr,
                                     float scale, float* __restrict__ dfeat) {
  const int bin = blockIdx.x;
  const int ri = blockIdx.y;
  const int bi = blockIdx.z;
  const size_t roi = (size_t)bi * r + ri;
  __shared__ BinGeometry g;
  if ((int)threadIdx.x < 2 * sr) {
    bin_geometry(rois + roi * 4, scale, p, sr, bin / p, bin % p, h, w, threadIdx.x, &g);
  }
  __syncthreads();
  scatter_channels<V>(dout + (roi * p * p + bin) * c, dfeat + (size_t)bi * h * w * c, w, c,
                      sr, g);
}

// The pyramid levels of K6b: per level the f32 accumulator of its
// (B, H, W, C) gradient, its size and its spatial scale.
struct LevelGrads {
  float* acc[kMaxLevels];
  int h[kMaxLevels];
  int w[kMaxLevels];
  float scale[kMaxLevels];
  int n;
};

template <typename T, int V>
__global__ void roi_align_ml_bwd_kernel(LevelGrads lv, const T* __restrict__ dout,
                                        const float* __restrict__ rois,
                                        const int* __restrict__ levels, int c, int r,
                                        int p, int sr) {
  const int bin = blockIdx.x;
  const int ri = blockIdx.y;
  const int bi = blockIdx.z;
  const size_t roi = (size_t)bi * r + ri;
  const int l = levels[roi];
  if (l < 0 || l >= lv.n) return;  // the whole block leaves: no barrier is skipped
  const int h = lv.h[l], w = lv.w[l];
  __shared__ BinGeometry g;
  if ((int)threadIdx.x < 2 * sr) {
    bin_geometry(rois + roi * 4, lv.scale[l], p, sr, bin / p, bin % p, h, w, threadIdx.x, &g);
  }
  __syncthreads();
  scatter_channels<V>(dout + (roi * p * p + bin) * c, lv.acc[l] + (size_t)bi * h * w * c, w, c,
                      sr, g);
}

__global__ void f32_to_bf16_kernel(const float* __restrict__ src, size_t n,
                                   __nv_bfloat16* __restrict__ dst) {
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    dst[i] = __float2bfloat16_rn(src[i]);
  }
}

// Calls launch(T*, std::integral_constant<int, V>, threads) for the feature
// (or gradient) dtype T and V, the channels a thread (2 where C is even:
// bf16x2 / float2 loads, float2 atomics); threads: one per V channels, whole
// warps, at most 256.
template <typename Launch>
void dispatch_fwd(int is_bf16, int c, Launch&& launch) {
  const auto go = [&](auto* tag, auto v) {
    launch(tag, v, min(256, ((c + v.value - 1) / v.value + 31) / 32 * 32));
  };
  if (is_bf16) {
    if (c % 2 == 0) go((__nv_bfloat16*)nullptr, std::integral_constant<int, 2>());
    else go((__nv_bfloat16*)nullptr, std::integral_constant<int, 1>());
  } else {
    if (c % 2 == 0) go((float*)nullptr, std::integral_constant<int, 2>());
    else go((float*)nullptr, std::integral_constant<int, 1>());
  }
}

// Rounds the n f32 values of src to bf16 into dst, on stream.
cudaError_t round_to_bf16(const float* src, size_t n, void* dst, cudaStream_t stream) {
  size_t blocks = (n + 255) / 256;
  if (blocks > ((size_t)1 << 20)) blocks = (size_t)1 << 20;
  f32_to_bf16_kernel<<<(unsigned)blocks, 256, 0, stream>>>(
      src, n, static_cast<__nv_bfloat16*>(dst));
  return cudaGetLastError();
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
  const dim3 grid(p * p, r, b);
  dispatch_fwd(is_bf16, c, [&](auto* tag, auto v, int threads) {
    using T = std::remove_pointer_t<decltype(tag)>;
    roi_align_fwd_kernel<T, decltype(v)::value><<<grid, threads, 0, stream>>>(
        static_cast<const T*>(feat), rois, h, w, c, r, p, sr, scale, static_cast<T*>(out));
  });
  return static_cast<int>(cudaGetLastError());
}

// feats: n_levels pointers to (B, H_l, W_l, C) maps, all f32 or all bf16;
// dims: (H_l, W_l) pairs; scales: 1 / stride_l (the three are host arrays);
// rois (B, R, 4) f32 image coordinates; levels (B, R) int32 in [0, n_levels);
// out (B, R, p, p, C) in the feature dtype, in roi order.
extern "C" int frcnn_roi_align_ml_fwd(const void* const* feats, const int* dims,
                                      const float* scales, int n_levels, int is_bf16,
                                      const float* rois, const int* levels, int b,
                                      int c, int r, int p, int sr, void* out,
                                      cudaStream_t stream) {
  if (b <= 0 || r <= 0 || c <= 0) return 0;
  if (n_levels < 1 || n_levels > kMaxLevels || sr < 1 || sr > kMaxSr || p < 1 ||
      r > 65535 || b > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Levels lv;
  lv.n = n_levels;
  for (int l = 0; l < n_levels; ++l) {
    lv.feat[l] = feats[l];
    lv.h[l] = dims[2 * l];
    lv.w[l] = dims[2 * l + 1];
    lv.scale[l] = scales[l];
    if (lv.h[l] < 1 || lv.w[l] < 1) return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(p * p, r, b);
  dispatch_fwd(is_bf16, c, [&](auto* tag, auto v, int threads) {
    using T = std::remove_pointer_t<decltype(tag)>;
    roi_align_ml_fwd_kernel<T, decltype(v)::value><<<grid, threads, 0, stream>>>(
        lv, rois, levels, c, r, p, sr, static_cast<T*>(out));
  });
  return static_cast<int>(cudaGetLastError());
}

// dout (B, R, p, p, C) f32 or bf16, rois (B, R, 4) f32; dfeat32 (B, H, W, C)
// f32 scratch; dfeat (B, H, W, C) in the dout dtype (for f32 it may be
// dfeat32 itself).
extern "C" int frcnn_roi_align_bwd(const void* dout, int is_bf16,
                                   const float* rois, int b, int h, int w,
                                   int c, int r, int p, int sr, float scale,
                                   float* dfeat32, void* dfeat,
                                   cudaStream_t stream) {
  if (b <= 0 || h <= 0 || w <= 0 || c <= 0) return 0;
  if (sr < 1 || sr > kMaxSr || p < 1 || r > 65535 || b > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t n = (size_t)b * h * w * c;
  cudaError_t err = cudaMemsetAsync(dfeat32, 0, n * sizeof(float), stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (r > 0) {
    const dim3 grid(p * p, r, b);
    dispatch_fwd(is_bf16, c, [&](auto* tag, auto v, int threads) {
      using T = std::remove_pointer_t<decltype(tag)>;
      roi_align_bwd_kernel<T, decltype(v)::value><<<grid, threads, 0, stream>>>(
          static_cast<const T*>(dout), rois, h, w, c, r, p, sr, scale, dfeat32);
    });
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (is_bf16) {
    err = round_to_bf16(dfeat32, n, dfeat, stream);
  } else if (dfeat != dfeat32) {
    err = cudaMemcpyAsync(dfeat, dfeat32, n * sizeof(float),
                          cudaMemcpyDeviceToDevice, stream);
  }
  return static_cast<int>(err);
}

// dout (B, R, p, p, C) f32 or bf16; rois (B, R, 4) f32; levels (B, R) int32;
// dims: (H_l, W_l) pairs and scales: 1 / stride_l (host arrays).  acc32: one
// f32 buffer that holds the levels' (B, H_l, W_l, C) gradients end to end, in
// level order; it is cleared here and is the result for f32.  For bf16,
// dfeats is a bf16 buffer of the same layout that takes the rounded result
// (for f32 it is not read).
extern "C" int frcnn_roi_align_ml_bwd(const void* dout, int is_bf16, const float* rois,
                                      const int* levels, const int* dims,
                                      const float* scales, int n_levels, int b, int c,
                                      int r, int p, int sr, float* acc32, void* dfeats,
                                      cudaStream_t stream) {
  if (b <= 0 || c <= 0) return 0;
  if (n_levels < 1 || n_levels > kMaxLevels || sr < 1 || sr > kMaxSr || p < 1 ||
      r > 65535 || b > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  LevelGrads lv;
  lv.n = n_levels;
  size_t total = 0;
  for (int l = 0; l < n_levels; ++l) {
    lv.h[l] = dims[2 * l];
    lv.w[l] = dims[2 * l + 1];
    lv.scale[l] = scales[l];
    if (lv.h[l] < 1 || lv.w[l] < 1) return static_cast<int>(cudaErrorInvalidValue);
    lv.acc[l] = acc32 + total;
    total += (size_t)b * lv.h[l] * lv.w[l] * c;
  }
  cudaError_t err = cudaMemsetAsync(acc32, 0, total * sizeof(float), stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (r > 0) {
    const dim3 grid(p * p, r, b);
    dispatch_fwd(is_bf16, c, [&](auto* tag, auto v, int threads) {
      using T = std::remove_pointer_t<decltype(tag)>;
      roi_align_ml_bwd_kernel<T, decltype(v)::value><<<grid, threads, 0, stream>>>(
          lv, static_cast<const T*>(dout), rois, levels, c, r, p, sr);
    });
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (is_bf16) err = round_to_bf16(acc32, total, dfeats, stream);
  return static_cast<int>(err);
}
