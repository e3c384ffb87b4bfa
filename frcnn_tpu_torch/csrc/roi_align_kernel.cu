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
// is 4 * sr^2 corner reads and as many FMAs, so the kernels gather.
//
// K2, the forward: one block per (image, roi, chunk of channels), the corner
// pixels staged ONCE in shared memory.  The bins of one roi share pixels: at
// sr = 2 a roi spans 14 samples an axis, and on a stride-16 map a roi under
// 224 px has fewer distinct pixels than samples.  The block computes the
// p * sr sample geometries of each axis once (roi_geometry), builds the lists
// of distinct rows and columns they touch (at most 2 * p * sr each; the
// samples are monotonic, so comparing with the last two entries finds a
// repeat), copies [rows][cols][channels] into shared memory with 16-byte
// cp.async (channels-last: a pixel's chunk is contiguous), and pools all
// p * p bins from there through the remapped indices, a thread taking 16
// bytes of channels (8 bf16 or 4 f32) of a bin and writing them with one
// 16-byte store.  The staging buffer has a fixed size; a roi with many
// distinct pixels takes its channel chunk in several passes (a roi wider than
// 2 * p * sr columns has no reuse and the most passes), so any roi is served.
// A channel count whose rows are not 16-byte multiples takes the same path an
// element at a time.  The interpolation (bilerp) and the order of a bin's sum
// are written with explicit round-to-nearest intrinsics and do not depend on
// where the corner values come from, so K2 and K6 share their bits: on one
// level they agree exactly.  Accumulation is f32; the result is rounded once
// to the feature dtype.
// What bounds K2 on the H100: by the count, memory traffic - the output
// (B*R*p*p*C values, 241 MB in bf16 at 8 x 300 rois x 49 bins x 1024) written
// once, the pixels under a roi read once.  In fact the SMs' arithmetic rate:
// every output value still costs 16 shared-memory corner reads, their bf16
// unpacking and 28 multiply-adds in the order that keeps its bits, about 4e9
// thread operations at that shape; the staging only takes the L2-to-SM
// traffic (16 reads of device memory or L2 an output before) out of the way.
// roi_plan (ops/cuda/roi_align_kernel.py) gives the channel chunk, the threads
// and the staging bytes.
//
// K6, the FPN forward: the same staged pooling over all pyramid levels in ONE
// launch.  Each block reads its roi's level and takes that level's base
// pointer, (H, W) and scale from a small struct passed by value, so the
// levels are never concatenated into one table and rois stay in their own
// order (the TPU path sorted rois by level and carried the inverse
// permutation; K6 needs neither).  A roi whose level is outside [0, L) gets
// zeros.  What bounds it: as K2 (60 MB written in bf16 at 8 x 300 rois x 49
// bins x 256).
//
// K2b, the backward (dF only; rois get no gradient, as in the TPU kernel):
// one block per (image, roi, bin); the bin's sample geometry is computed once
// per block into shared memory (bin_geometry, the arithmetic roi_geometry
// repeats) and the threads run over channels, each scattering its share of a
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
constexpr int kMaxForwardThreads = 512;
constexpr int kMaxSamples = 32;   // p * sr, the samples of a roi along one axis (forward)

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// V adjacent channels from a V-aligned address: V = 1, 2, or 16 bytes' worth
// (4 f32, 8 bf16).
template <int V>
__device__ __forceinline__ void load_v(const float* p, float* v) {
  if constexpr (V == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
  } else if constexpr (V == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    v[0] = t.x; v[1] = t.y;
  } else {
    v[0] = *p;
  }
}
template <int V>
__device__ __forceinline__ void load_v(const __nv_bfloat16* p, float* v) {
  if constexpr (V == 8) {
    const uint4 t = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&t);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 f = __bfloat1622float2(h[j]);
      v[2 * j] = f.x; v[2 * j + 1] = f.y;
    }
  } else if constexpr (V == 2) {
    const float2 t = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
    v[0] = t.x; v[1] = t.y;
  } else {
    v[0] = __bfloat162float(*p);
  }
}
template <int V>
__device__ __forceinline__ void store_v(float* p, const float* v) {
  if constexpr (V == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else if constexpr (V == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  } else {
    *p = v[0];
  }
}
template <int V>
__device__ __forceinline__ void store_v(__nv_bfloat16* p, const float* v) {
  if constexpr (V == 8) {
    uint4 t;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&t);
#pragma unroll
    for (int j = 0; j < 4; ++j) h[j] = __floats2bfloat162_rn(v[2 * j], v[2 * j + 1]);
    *reinterpret_cast<uint4*>(p) = t;
  } else if constexpr (V == 2) {
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

// The sample geometry of a whole roi, per axis, for the forward kernels: for
// each of the p * sr samples the (low, high) index pair and their weights
// (both zero for an empty sample).  After roi_stage_list the indices are
// positions in rows[] / cols[], the distinct map rows and columns the roi
// touches.
struct RoiGeometry {
  int2 y_idx[kMaxSamples], x_idx[kMaxSamples];
  float2 y_w[kMaxSamples], x_w[kMaxSamples];
  int rows[2 * kMaxSamples], cols[2 * kMaxSamples];
  int n_rows, n_cols;
};

// Sample k of one axis of the roi (bin_geometry's arithmetic): y for is_y.
__device__ __forceinline__ void roi_sample(const float* roi, float scale, int p, int sr,
                                           int size, bool is_y, int k, int2* idx, float2* wgt) {
  const float lo = __fmul_rn(roi[is_y ? 1 : 0], scale);
  const float hi = __fmul_rn(roi[is_y ? 3 : 2], scale);
  const float bin_sz = __fdiv_rn(fmaxf(__fsub_rn(hi, lo), 1.0f), (float)p);
  sample_axis(lo, bin_sz, k, sr, size, &idx->x, &idx->y, &wgt->x, &wgt->y);
}

// One warp turns the ns <= 32 samples of an axis (lane k holds sample k) into
// the ascending list of distinct indices they touch, rewrites each sample's
// (low, high) as positions in it and returns the list's length.  The
// non-empty samples are consecutive and their coordinates ascend, so the
// entries come out in the order low_0, high_0, low_1, ...: one is new when it
// exceeds everything before it (the previous sample's high, then its own
// low), and a repeat is the last entry or the one before.  Ballots count the
// new entries before each sample.  An empty sample points at position 0.
__device__ __forceinline__ int roi_stage_list(int ns, int2* idx, const float2* wgt, int* list) {
  const int k = threadIdx.x & 31;
  const bool live = k < ns && !(wgt[k].x == 0.0f && wgt[k].y == 0.0f);
  const int lo = live ? idx[k].x : 0, hi = live ? idx[k].y : 0;
  const unsigned live_m = __ballot_sync(0xffffffffu, live);
  const int prev_hi = __shfl_up_sync(0xffffffffu, hi, 1);
  const bool prev_live = k > 0 && ((live_m >> (k - 1)) & 1u);
  const bool new_lo = live && (!prev_live || lo > prev_hi);
  const int last = prev_live && prev_hi > lo ? prev_hi : lo;   // the last entry once lo is in
  const bool new_hi = live && hi > last;
  const unsigned lo_m = __ballot_sync(0xffffffffu, new_lo);
  const unsigned hi_m = __ballot_sync(0xffffffffu, new_hi);
  const unsigned below = (1u << k) - 1u;
  const int n0 = __popc(lo_m & below) + __popc(hi_m & below);  // entries before this sample
  const int n1 = n0 + (new_lo ? 1 : 0);
  if (live) {
    if (new_lo) list[n0] = lo;
    if (new_hi) list[n1] = hi;
    idx[k] = make_int2(new_lo ? n0 : (lo == prev_hi ? n0 - 1 : n0 - 2),
                       new_hi ? n1 : (hi == last ? n1 - 1 : n1 - 2));
  } else if (k < ns) {
    idx[k] = make_int2(0, 0);
  }
  return __popc(lo_m) + __popc(hi_m);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" :: "r"(d), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

// A bilinear sample's first step, for one row and one x sample: the
// interpolation along x of channels [0, V) at `row`, a channels-last row of c-channel pixels.
template <int V, typename T>
__device__ __forceinline__ void lerp_x(const T* row, int c, int2 xi, float2 xw, float* out) {
  float lo[V], hi[V];
  load_v<V>(row + xi.x * c, lo);
  load_v<V>(row + xi.y * c, hi);
#pragma unroll
  for (int j = 0; j < V; ++j) out[j] = __fmaf_rn(xw.y, hi[j], __fmul_rn(xw.x, lo[j]));
}

// The value of bin (py, px) for channels [ch, ch + V) of the staged pixels f,
// a channels-last (rows, w, c) array addressed by g's positions: the mean of
// its sr * sr bilinear samples, in f32, each interpolated along x (lerp_x),
// then along y, and summed in the order (iy, ix).  The general form, for any
// sr.
template <int V, typename T>
__device__ __forceinline__ void pool_bin(const T* f, int w, int c, int ch, int sr, int py,
                                         int px, const RoiGeometry& g, float* acc) {
  for (int j = 0; j < V; ++j) acc[j] = 0.0f;
  for (int iy = 0; iy < sr; ++iy) {
    const int2 yi = g.y_idx[py * sr + iy];
    const float2 yw = g.y_w[py * sr + iy];
    for (int ix = 0; ix < sr; ++ix) {
      const int2 xi = g.x_idx[px * sr + ix];
      const float2 xw = g.x_w[px * sr + ix];
      float top[V], bot[V];
      lerp_x<V>(f + yi.x * w * c + ch, c, xi, xw, top);
      lerp_x<V>(f + yi.y * w * c + ch, c, xi, xw, bot);
      for (int j = 0; j < V; ++j) {
        acc[j] = __fadd_rn(acc[j], __fmaf_rn(yw.y, bot[j], __fmul_rn(yw.x, top[j])));
      }
    }
  }
  const float inv_count = __fdiv_rn(1.0f, (float)(sr * sr));
  for (int j = 0; j < V; ++j) acc[j] = __fmul_rn(acc[j], inv_count);
}

template <int V>
__device__ __forceinline__ void copy_v(float* dst, const float* src) {
#pragma unroll
  for (int j = 0; j < V; ++j) dst[j] = src[j];
}

// pool_bin at sr = 2, the same operations on the same values in the same
// order, so the same bits, with less work: the interpolation along x depends
// on the row and the x sample only, and the four rows of a bin's two y
// samples (low and high of each) are mostly two or three distinct ones (a
// bin is narrower than a pixel wherever the roi is under 7 pixels of the
// map), so each distinct row is read and interpolated once.  Where a warp
// holds one bin the branches are uniform.
template <int V, typename T>
__device__ __forceinline__ void pool_bin_sr2(const T* f, int w, int c, int ch, int py, int px,
                                             const RoiGeometry& g, float* acc) {
  const int2 y0 = g.y_idx[2 * py], y1 = g.y_idx[2 * py + 1];
  const float2 wy0 = g.y_w[2 * py], wy1 = g.y_w[2 * py + 1];
  const int2 x0 = g.x_idx[2 * px], x1 = g.x_idx[2 * px + 1];
  const float2 wx0 = g.x_w[2 * px], wx1 = g.x_w[2 * px + 1];
  const int pitch = w * c;
  const T* base = f + ch;
  float a0[V], a1[V], b0[V], b1[V];        // rows y0.x and y0.y at the two x samples
  lerp_x<V>(base + y0.x * pitch, c, x0, wx0, a0);
  lerp_x<V>(base + y0.x * pitch, c, x1, wx1, a1);
  if (y0.y == y0.x) {
    copy_v<V>(b0, a0); copy_v<V>(b1, a1);
  } else {
    lerp_x<V>(base + y0.y * pitch, c, x0, wx0, b0);
    lerp_x<V>(base + y0.y * pitch, c, x1, wx1, b1);
  }
  float c0[V], c1[V], d0[V], d1[V];        // rows y1.x and y1.y
  if (y1.x == y0.x) {
    copy_v<V>(c0, a0); copy_v<V>(c1, a1);
  } else if (y1.x == y0.y) {
    copy_v<V>(c0, b0); copy_v<V>(c1, b1);
  } else {
    lerp_x<V>(base + y1.x * pitch, c, x0, wx0, c0);
    lerp_x<V>(base + y1.x * pitch, c, x1, wx1, c1);
  }
  if (y1.y == y1.x) {
    copy_v<V>(d0, c0); copy_v<V>(d1, c1);
  } else if (y1.y == y0.y) {
    copy_v<V>(d0, b0); copy_v<V>(d1, b1);
  } else {
    lerp_x<V>(base + y1.y * pitch, c, x0, wx0, d0);
    lerp_x<V>(base + y1.y * pitch, c, x1, wx1, d1);
  }
#pragma unroll
  for (int j = 0; j < V; ++j) {
    float sum = __fadd_rn(0.0f, __fmaf_rn(wy0.y, b0[j], __fmul_rn(wy0.x, a0[j])));
    sum = __fadd_rn(sum, __fmaf_rn(wy0.y, b1[j], __fmul_rn(wy0.x, a1[j])));
    sum = __fadd_rn(sum, __fmaf_rn(wy1.y, d0[j], __fmul_rn(wy1.x, c0[j])));
    sum = __fadd_rn(sum, __fmaf_rn(wy1.y, d1[j], __fmul_rn(wy1.x, c1[j])));
    acc[j] = __fmul_rn(sum, __fdiv_rn(1.0f, 4.0f));
  }
}

// Channels [ch, ch + V) of bin (py, px) of the staged pass into the roi's
// output o.
template <int V, typename T>
__device__ __forceinline__ void pool_store(const T* stage, int n_cols, int cur, int ch, int sr,
                                           int py, int px, const RoiGeometry& g, T* o) {
  float acc[V];
  if (sr == 2) pool_bin_sr2<V>(stage, n_cols, cur, ch, py, px, g, acc);
  else pool_bin<V>(stage, n_cols, cur, ch, sr, py, px, g, acc);
  store_v<V>(o, acc);
}

// Channels [c0, c1) of every bin of one roi, pooled from the channels-last
// (h, w, c) map f into o, the roi's (p, p, c) output: the whole block works,
// with `stage` (stage_elems values of shared memory) holding the roi's
// distinct pixels, V channels a thread (16 bytes, or one channel).  c0, c1
// and c are multiples of V.
template <int V, typename T>
__device__ __forceinline__ void pool_roi_staged(const T* __restrict__ f, const float* roi,
                                                float scale, int h, int w, int c, int c0,
                                                int c1, int p, int sr, T* o, RoiGeometry* g,
                                                T* stage, int stage_elems) {
  const int t = threadIdx.x;
  const int nthreads = blockDim.x;
  const int ns = p * sr;
  for (int s = t; s < 2 * ns; s += nthreads) {
    if (s < ns) roi_sample(roi, scale, p, sr, w, false, s, &g->x_idx[s], &g->x_w[s]);
    else roi_sample(roi, scale, p, sr, h, true, s - ns, &g->y_idx[s - ns], &g->y_w[s - ns]);
  }
  __syncthreads();
  if (t < 32) {
    const int n_rows = roi_stage_list(ns, g->y_idx, g->y_w, g->rows);
    const int n_cols = roi_stage_list(ns, g->x_idx, g->x_w, g->cols);
    if (t == 0) {
      g->n_rows = n_rows;
      g->n_cols = n_cols;
    }
  }
  __syncthreads();
  const int n_rows = g->n_rows, n_cols = g->n_cols;
  const int n_pix = n_rows * n_cols;
  if (n_pix == 0) {   // every sample of an axis is empty: the roi pools zeros
    float zero[V];
    for (int j = 0; j < V; ++j) zero[j] = 0.0f;
    const int groups = (c1 - c0) / V;
    for (int item = t; item < p * p * groups; item += nthreads) {
      store_v<V>(o + (size_t)(item / groups) * c + c0 + (item % groups) * V, zero);
    }
    return;
  }
  // channels a pass: what the buffer holds of every staged pixel
  const int sub = min(c1 - c0, stage_elems / n_pix / V * V);
  for (int cs = c0; cs < c1; cs += sub) {
    const int cur = min(sub, c1 - cs);
    const int groups = cur / V;
    for (int v = t; v < n_pix * groups; v += nthreads) {
      const int pix = v / groups, q = v - pix * groups;
      const int ry = pix / n_cols, rx = pix - ry * n_cols;
      const T* src = f + ((size_t)g->rows[ry] * w + g->cols[rx]) * c + cs + q * V;
      if constexpr (V * sizeof(T) == 16) {
        cp_async16(stage + v * V, src);
      } else {
        for (int j = 0; j < V; ++j) stage[v * V + j] = src[j];
      }
    }
    if constexpr (V * sizeof(T) == 16) cp_async_wait_all();
    __syncthreads();
    if (nthreads % groups == 0) {
      // a thread keeps its channels and strides over the bins: no division a bin
      const int q = t % groups, lanes = nthreads / groups;
      int bin = t / groups;
      int py = bin / p, px = bin - py * p;
      const int dy = lanes / p, dx = lanes - dy * p;
      for (; bin < p * p; bin += lanes) {
        pool_store<V>(stage, n_cols, cur, q * V, sr, py, px, *g,
                      o + (size_t)bin * c + cs + q * V);
        px += dx;
        py += dy;
        if (px >= p) {
          px -= p;
          ++py;
        }
      }
    } else {   // a pass cut to a width that the threads do not divide into
      for (int item = t; item < p * p * groups; item += nthreads) {
        const int bin = item / groups, q = item - bin * groups;
        pool_store<V>(stage, n_cols, cur, q * V, sr, bin / p, bin % p, *g,
                      o + (size_t)bin * c + cs + q * V);
      }
    }
    __syncthreads();   // the buffer is staged again
  }
}

template <typename T, int V>
__global__ void __launch_bounds__(kMaxForwardThreads) roi_align_fwd_kernel(const T* __restrict__ feat,
                                     const float* __restrict__ rois, int h,
                                     int w, int c, int r, int p, int sr,
                                     float scale, int chunk, int stage_elems,
                                     T* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char stage_raw[];
  __shared__ RoiGeometry g;
  const int c0 = blockIdx.x * chunk;
  const int ri = blockIdx.y;
  const int bi = blockIdx.z;
  const size_t roi = (size_t)bi * r + ri;
  pool_roi_staged<V>(feat + (size_t)bi * h * w * c, rois + roi * 4, scale, h, w, c, c0,
                     min(c, c0 + chunk), p, sr, out + roi * p * p * c, &g,
                     reinterpret_cast<T*>(stage_raw), stage_elems);
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
__global__ void __launch_bounds__(kMaxForwardThreads) roi_align_ml_fwd_kernel(Levels lv, const float* __restrict__ rois,
                                        const int* __restrict__ levels, int c, int r,
                                        int p, int sr, int chunk, int stage_elems,
                                        T* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char stage_raw[];
  __shared__ RoiGeometry g;
  const int c0 = blockIdx.x * chunk, c1 = min(c, c0 + chunk);
  const int ri = blockIdx.y;
  const int bi = blockIdx.z;
  const size_t roi = (size_t)bi * r + ri;
  T* o = out + roi * p * p * c;
  const int l = levels[roi];
  if (l < 0 || l >= lv.n) {  // the whole block leaves: no barrier is skipped
    for (int i = (int)threadIdx.x; i < p * p * (c1 - c0); i += (int)blockDim.x) {
      store(o + (size_t)(i / (c1 - c0)) * c + c0 + i % (c1 - c0), 0.0f);
    }
    return;
  }
  const int h = lv.h[l], w = lv.w[l];
  pool_roi_staged<V>(static_cast<const T*>(lv.feat[l]) + (size_t)bi * h * w * c,
                     rois + roi * 4, lv.scale[l], h, w, c, c0, c1, p, sr, o, &g,
                     reinterpret_cast<T*>(stage_raw), stage_elems);
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
// pool_bin.  Empty samples (both weights zero) and zero gradients add
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

// Calls launch(T*, std::integral_constant<int, V>, threads) for the gradient
// dtype T and V, the channels a thread (2 where C is even: bf16x2 / float2
// loads, float2 atomics); threads: one per V channels, whole warps, at most
// 256.
template <typename Launch>
void dispatch_bwd(int is_bf16, int c, Launch&& launch) {
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

// The forward kernels' V: 16 bytes of channels a thread (8 bf16, 4 f32), in
// the staging copies, the pooling and the stores, where a pixel's C channels
// are a multiple of 16 bytes; else one channel.
int forward_vec(int is_bf16, int c) {
  const int per16 = is_bf16 ? 8 : 4;
  return c % per16 == 0 ? per16 : 1;
}

// Calls launch(T*, std::integral_constant<int, V>) for the feature dtype T
// and the forward kernels' V.
template <typename Launch>
void dispatch_fwd(int is_bf16, int c, Launch&& launch) {
  const bool vec = forward_vec(is_bf16, c) > 1;
  if (is_bf16) {
    if (vec) launch((__nv_bfloat16*)nullptr, std::integral_constant<int, 8>());
    else launch((__nv_bfloat16*)nullptr, std::integral_constant<int, 1>());
  } else {
    if (vec) launch((float*)nullptr, std::integral_constant<int, 4>());
    else launch((float*)nullptr, std::integral_constant<int, 1>());
  }
}

// The forward launch geometry the caller chose (roi_plan): the channel chunk
// a block takes, its threads and its staging bytes.  The buffer must hold V
// channels of the (2 * p * sr)^2 pixels a roi can touch at most.
bool forward_plan_ok(int is_bf16, int c, int p, int sr, int chunk, int threads,
                     int smem_bytes) {
  const int v = forward_vec(is_bf16, c);
  const long long max_pix = 4LL * p * sr * p * sr;
  return p * sr <= kMaxSamples && chunk >= v && chunk % v == 0 && threads >= 32 &&
         threads <= kMaxForwardThreads && threads % 32 == 0 && smem_bytes % 16 == 0 &&
         smem_bytes >= max_pix * v * (is_bf16 ? 2 : 4) &&
         smem_bytes + (long long)sizeof(RoiGeometry) <= 232448 &&
         (c + chunk - 1) / chunk <= 65535;
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int smem_bytes) {
  if (smem_bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
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

// feat (B, H, W, C) f32 or bf16 (16-byte aligned), rois (B, R, 4) f32 image
// coordinates, out (B, R, p, p, C) in the feature dtype.  A block takes
// `chunk` channels of one roi with `threads` threads and `smem_bytes` of
// staging buffer.
extern "C" int frcnn_roi_align_fwd(const void* feat, int is_bf16,
                                   const float* rois, int b, int h, int w,
                                   int c, int r, int p, int sr, float scale,
                                   int chunk, int threads, int smem_bytes,
                                   void* out, cudaStream_t stream) {
  if (b <= 0 || r <= 0 || c <= 0) return 0;
  if (sr < 1 || sr > kMaxSr || p < 1 || h < 1 || w < 1 || r > 65535 || b > 65535 ||
      !forward_plan_ok(is_bf16, c, p, sr, chunk, threads, smem_bytes)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid((c + chunk - 1) / chunk, r, b);
  cudaError_t err = cudaSuccess;
  dispatch_fwd(is_bf16, c, [&](auto* tag, auto v) {
    using T = std::remove_pointer_t<decltype(tag)>;
    auto kernel = roi_align_fwd_kernel<T, decltype(v)::value>;
    err = allow_smem(kernel, smem_bytes);
    if (err != cudaSuccess) return;
    kernel<<<grid, threads, smem_bytes, stream>>>(
        static_cast<const T*>(feat), rois, h, w, c, r, p, sr, scale, chunk,
        smem_bytes / (int)sizeof(T), static_cast<T*>(out));
  });
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// feats: n_levels pointers to (B, H_l, W_l, C) maps, all f32 or all bf16;
// dims: (H_l, W_l) pairs; scales: 1 / stride_l (the three are host arrays);
// rois (B, R, 4) f32 image coordinates; levels (B, R) int32 in [0, n_levels);
// out (B, R, p, p, C) in the feature dtype, in roi order.  chunk, threads and
// smem_bytes as for frcnn_roi_align_fwd.
extern "C" int frcnn_roi_align_ml_fwd(const void* const* feats, const int* dims,
                                      const float* scales, int n_levels, int is_bf16,
                                      const float* rois, const int* levels, int b,
                                      int c, int r, int p, int sr, int chunk, int threads,
                                      int smem_bytes, void* out, cudaStream_t stream) {
  if (b <= 0 || r <= 0 || c <= 0) return 0;
  if (n_levels < 1 || n_levels > kMaxLevels || sr < 1 || sr > kMaxSr || p < 1 ||
      r > 65535 || b > 65535 ||
      !forward_plan_ok(is_bf16, c, p, sr, chunk, threads, smem_bytes)) {
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
  const dim3 grid((c + chunk - 1) / chunk, r, b);
  cudaError_t err = cudaSuccess;
  dispatch_fwd(is_bf16, c, [&](auto* tag, auto v) {
    using T = std::remove_pointer_t<decltype(tag)>;
    auto kernel = roi_align_ml_fwd_kernel<T, decltype(v)::value>;
    err = allow_smem(kernel, smem_bytes);
    if (err != cudaSuccess) return;
    kernel<<<grid, threads, smem_bytes, stream>>>(
        lv, rois, levels, c, r, p, sr, chunk, smem_bytes / (int)sizeof(T),
        static_cast<T*>(out));
  });
  if (err != cudaSuccess) return static_cast<int>(err);
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
    dispatch_bwd(is_bf16, c, [&](auto* tag, auto v, int threads) {
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
    dispatch_bwd(is_bf16, c, [&](auto* tag, auto v, int threads) {
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
