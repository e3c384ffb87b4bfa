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
// K2b, the backward (dF only; rois get no gradient, as in the TPU kernel),
// and K6b, the FPN backward (dF of every level; rois and levels get none):
// ONE kernel, the gather form of the adjoint.  The TPU kernel kept its output
// block resident in VMEM and ran the roi tiles as the inner, sequential grid
// axis; here a loop inside the block takes the place of that axis.  A block
// owns a tile of dF (tile_h x tile_w pixels of one level of one image, a
// chunk of channels) and walks the image's rois in index order, keeping
// those on its level that may reach the tile (a division-free test; a
// ballot compacts the list).  Its threads hold the tile's f32 sums in
// registers, each thread V channels (16 bytes of dOut where C allows, else
// one) of up to kBackwardPairs pixels.  A round computes the samples of the
// next kept rois (roi_sample, the forward's arithmetic, so the weights keep
// their bits), per tile row and bin row the sum of the weights of the bin
// row's samples whose low or high index is that row (Ay), the same per
// column (Ax), a bit mask of the bins that reach each row and column, and
// stages with cp.async the rectangle of dOut bins that reach the tile for as
// many rois as the stage holds; then each thread adds Ay * (sum over the bin
// columns of Ax * dOut) over the bins that reach its pixel: contract x, then
// y, as the TPU kernel's two matmuls do.  No two threads share a sum, so
// there is no atomic; the order of the adds (roi, bin row, bin column) is
// fixed, so dF is bit-deterministic, and no tile, chunk or round changes it,
// so K6b with every roi on one level equals K2b there bit for bit.  After
// the last roi each thread scales its sums by 1 / sr^2 and rounds them once
// to the dF dtype with 16-byte stores; a tile that no roi reaches writes
// zeros.  Nothing is allocated but dF: no f32 scratch, no memset, no rounding
// pass.  K6b runs the tiles of every level in one launch, the coarsest
// level's first (each level's size, scale, tiles and output pointer in a
// struct passed by value; the levels' dF lie end to end in one buffer); a
// roi whose level is outside [0, L) adds nothing.
// What bounds it on the H100: by the count, memory traffic - dF written once
// (50 MB in bf16 for K2b at 8 x 38x64x1024, 212 MB for K6b over P2-P5 of
// 608x1024 x 256) and dOut read once (103 MB and 26 MB).  In fact the
// latency of a round (four barriers, the samples' divisions, a cp.async
// round trip) times the rounds of the busiest tiles: a tile that many small
// rois reach takes one round for every few of them.  roi_bwd_plan
// (ops/cuda/roi_align_kernel.py) gives the tile, the chunk, the threads, the
// kept rois whose geometry a block holds and the bins a round stages.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

namespace {

constexpr int kMaxSr = 8;
constexpr int kMaxLevels = 8;
constexpr int kMaxForwardThreads = 512;
constexpr int kMaxBackwardThreads = 256;
constexpr int kBackwardPairs = 4;    // (pixel, V channels) sums a backward thread holds
// Blocks of kMaxBackwardThreads the backward kernel is compiled to fit on an
// SM (at most 64 registers a thread): with the compiler's own choice (104
// for bf16) two fit, and the rounds' latency is hidden half as well.
constexpr int kBackwardBlocksPerSM = 4;
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

// One sample of one axis: its low/high index and their weights (both zero
// for an empty sample).
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

// Sample k of one axis of the roi (sample_axis after the roi's scaled edges
// and bin size): y for is_y.
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

// The dF tiles of K2b / K6b: per level (one for K2b) its (B, H, W, C)
// gradient, its size and spatial scale, its tiles across and in all (per
// image), and the first block of its tiles: the blocks run the coarsest
// level's tiles of every image first, then the next finer level's, so the
// tiles that most rois reach start early.
struct GradLevels {
  void* grad[kMaxLevels];
  int h[kMaxLevels];
  int w[kMaxLevels];
  float scale[kMaxLevels];
  int tiles_w[kMaxLevels];
  int tiles[kMaxLevels];
  int first[kMaxLevels];
  int n;
};

// Byte offsets of the backward block's shared memory, each region 16-byte
// aligned: the staged dOut bins (stage_bins x chunk values of the gradient
// dtype, from offset 0); for a batch of kept rois their samples (index pair,
// weight pair), the weight of
// each bin row on each tile row and of each bin column on each tile column,
// the bins with a non-zero weight there (a bit mask), and the rectangle of
// bins each roi stages (first bin row and column, width, first slot); then
// the kept roi list (indices, then coordinates), one count a warp, and the
// rois and slots a round stages.
// roi_bwd_smem_bytes (ops/cuda/roi_align_kernel.py) repeats it.
struct BwdLayout {
  long long samples_idx, samples_w, weights, masks, rects, kept, kept_roi, counts, total;
};

__host__ __device__ inline long long align16(long long n) { return (n + 15) / 16 * 16; }

__host__ __device__ inline BwdLayout bwd_layout(int elem_bytes, int tile_h, int tile_w, int chunk,
                                                int p, int sr, int batch, int stage_bins,
                                                int threads) {
  const long long ns = (long long)p * sr, edge = tile_h + tile_w;
  BwdLayout l;
  l.samples_idx = align16((long long)stage_bins * chunk * elem_bytes);   // the stage from 0
  l.samples_w = l.samples_idx + align16(batch * 2 * ns * 8);
  l.weights = l.samples_w + align16(batch * 2 * ns * 8);
  l.masks = l.weights + align16(batch * edge * p * 4);
  l.rects = l.masks + align16(batch * edge * 4);
  l.kept = l.rects + align16((long long)batch * 16);
  l.kept_roi = l.kept + align16((long long)threads * 4);
  l.counts = l.kept_roi + (long long)threads * 16;
  l.total = l.counts + align16(34 * 4);
  return l;
}

// Whether the samples of one axis of the roi may touch an index in
// [lo_b, hi_b], without a division: every sample coordinate lies within
// (lo, lo + max(hi - lo, 1)), a live one within [-1, size], and its two
// indices within one of its floor.  A margin of one index each way covers
// the rounding; a roi is kept too often, never too rarely.
__device__ __forceinline__ bool roi_axis_may_touch(const float* roi, float scale, int size,
                                                   bool is_y, int lo_b, int hi_b) {
  const float lo = __fmul_rn(roi[is_y ? 1 : 0], scale);
  const float hi = __fmul_rn(roi[is_y ? 3 : 2], scale);
  const float end = __fadd_rn(lo, fmaxf(__fsub_rn(hi, lo), 1.0f));
  if (!(end >= -2.0f && lo <= (float)size + 1.0f)) return false;
  const float a = fminf(fmaxf(lo, -1.0f), (float)size);
  const float e = fminf(fmaxf(end, -1.0f), (float)size);
  return (int)floorf(a) - 1 <= hi_b && (int)floorf(e) + 2 >= lo_b;
}

// K2b and K6b: one block owns a tile_h x tile_w tile of one level's dF for
// one image and `chunk` channels (blockIdx: x the level, image and tile, as
// GradLevels orders them, y the chunk).  It walks the image's rois in index
// order and keeps those on its level that may touch the tile (a ballot
// compacts the list and their coordinates).  Then, a round at a time, it
// computes for the next kept rois (up to `batch` computed and not yet
// staged) the samples
// (roi_sample), per tile row and bin row Ay = the sum of the weights of the
// bin row's samples whose low or high index is that row (in sample order,
// low before high), the same Ax per tile column and bin column, and a mask of
// the bins with a non-zero weight on each row and column; it stages with
// 16-byte cp.async the rectangle of dOut bins that reach the tile, for as
// many of those rois as `stage_bins` holds (at least one: a roi has p * p
// bins); and each thread adds, for each of its (pixel, V channels) pairs and
// every staged roi, Ay * (the sum over bin columns of Ax * dOut) over the
// bins that reach the pixel into that pair's f32 sums, in its registers.
// The order (roi, bin row, bin column) is fixed and no tile, chunk or round
// changes it.  The sums are scaled by 1 / sr^2 and rounded once into dF; a
// tile that no roi touches writes zeros.
template <typename T, int V>
__global__ void __launch_bounds__(kMaxBackwardThreads, kBackwardBlocksPerSM)
roi_align_bwd_tile_kernel(GradLevels lv, const T* __restrict__ dout,
                          const float* __restrict__ rois, const int* __restrict__ levels, int c,
                          int r, int p, int sr, int tile_h, int tile_w, int chunk, int batch,
                          int stage_bins) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int t = threadIdx.x, nthreads = blockDim.x;
  const BwdLayout lay = bwd_layout(sizeof(T), tile_h, tile_w, chunk, p, sr, batch, stage_bins,
                                   nthreads);
  T* stage = reinterpret_cast<T*>(smem);
  int2* s_idx = reinterpret_cast<int2*>(smem + lay.samples_idx);
  float2* s_w = reinterpret_cast<float2*>(smem + lay.samples_w);
  float* wts = reinterpret_cast<float*>(smem + lay.weights);
  unsigned* masks = reinterpret_cast<unsigned*>(smem + lay.masks);
  int4* rects = reinterpret_cast<int4*>(smem + lay.rects);
  int* kept = reinterpret_cast<int*>(smem + lay.kept);
  float4* kept_roi = reinterpret_cast<float4*>(smem + lay.kept_roi);
  int* counts = reinterpret_cast<int*>(smem + lay.counts);   // 32 warp counts, the round's rois

  int l = lv.n - 1;
  while (l > 0 && (int)blockIdx.x >= lv.first[l - 1]) --l;
  const int h = lv.h[l], w = lv.w[l];
  const int bi = ((int)blockIdx.x - lv.first[l]) / lv.tiles[l];
  const int tile = (int)blockIdx.x - lv.first[l] - bi * lv.tiles[l];
  const int y0 = tile / lv.tiles_w[l] * tile_h, x0 = tile % lv.tiles_w[l] * tile_w;
  const int th = min(tile_h, h - y0), tw = min(tile_w, w - x0);
  const int c0 = blockIdx.y * chunk, groups = min(chunk, c - c0) / V;
  const float scale = lv.scale[l];
  const int ns = p * sr, edge = tile_h + tile_w, pairs = tile_h * tile_w * groups;
  const float* img_rois = rois + (size_t)bi * r * 4;
  const T* img_dout = dout + (size_t)bi * r * p * p * c + c0;

  // the f32 sums of this thread's (pixel, V channels) pairs t + k * nthreads
  float a[kBackwardPairs][V];
#pragma unroll
  for (int k = 0; k < kBackwardPairs; ++k) {
#pragma unroll
    for (int j = 0; j < V; ++j) a[k][j] = 0.0f;
  }
  for (int base = 0; base < r; base += nthreads) {
    const int ri = base + t;
    bool keep = false;
    float4 roi = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (ri < r && (levels == nullptr || levels[(size_t)bi * r + ri] == l)) {
      roi = *reinterpret_cast<const float4*>(img_rois + (size_t)ri * 4);
      const float e[4] = {roi.x, roi.y, roi.z, roi.w};
      keep = roi_axis_may_touch(e, scale, h, true, y0, y0 + th - 1) &&
             roi_axis_may_touch(e, scale, w, false, x0, x0 + tw - 1);
    }
    const unsigned m = __ballot_sync(0xffffffffu, keep);
    if ((t & 31) == 0) counts[t >> 5] = __popc(m);
    __syncthreads();
    int before = 0, nk = 0;
    for (int i = 0; i < nthreads / 32; ++i) {
      before += i < (t >> 5) ? counts[i] : 0;
      nk += counts[i];
    }
    if (keep) {
      const int at = before + __popc(m & ((1u << (t & 31)) - 1u));
      kept[at] = ri;
      kept_roi[at] = roi;
    }
    __syncthreads();
    // kept roi k keeps its geometry in slot k % batch from the round that
    // computes it until the round that stages it: each is computed once
    for (int k0 = 0, k_done = 0; k0 < nk;) {
      const int k_end = min(k0 + batch, nk), nb = k_end - k0, fresh = k_end - k_done;
      for (int e = t; e < fresh * 2 * ns; e += nthreads) {   // the samples, x then y
        const int kk = k_done + e / (2 * ns), s = e % (2 * ns), at = kk % batch * 2 * ns + s;
        const bool is_y = s >= ns;
        roi_sample(reinterpret_cast<const float*>(&kept_roi[kk]), scale, p, sr, is_y ? h : w,
                   is_y, is_y ? s - ns : s, &s_idx[at], &s_w[at]);
      }
      __syncthreads();
      for (int e = t; e < fresh * edge; e += nthreads) {  // rows, then columns, of each roi
        const int slot = (k_done + e / edge) % batch, i = e % edge;
        const bool is_y = i < tile_h;
        const int at = is_y ? y0 + i : x0 + i - tile_h;
        const int s0 = slot * 2 * ns + (is_y ? ns : 0), row = slot * edge + i;
        unsigned mask = 0;
        for (int pb = 0; pb < p; ++pb) {
          float wsum = 0.0f;
          for (int s = s0 + pb * sr; s < s0 + (pb + 1) * sr; ++s) {
            if (s_idx[s].x == at) wsum = __fadd_rn(wsum, s_w[s].x);
            if (s_idx[s].y == at) wsum = __fadd_rn(wsum, s_w[s].y);
          }
          wts[row * p + pb] = wsum;
          if (wsum != 0.0f) mask |= 1u << pb;
        }
        masks[row] = mask;
      }
      k_done = k_end;
      __syncthreads();
      if (t < 32) {                                  // each roi's rectangle of bins
        unsigned ym = 0, xm = 0;
        if (t < nb) {
          const unsigned* mk = masks + (k0 + t) % batch * edge;
          for (int i = 0; i < tile_h; ++i) ym |= mk[i];
          for (int i = tile_h; i < edge; ++i) xm |= mk[i];
        }
        const bool any = ym != 0 && xm != 0;
        const int py0 = any ? __ffs(ym) - 1 : 0, px0 = any ? __ffs(xm) - 1 : 0;
        const int pw = any ? 32 - __clz(xm) - px0 : 0;
        const int area = any ? (32 - __clz(ym) - py0) * pw : 0;
        int incl = area;                             // the slots up to and with this roi
        for (int d = 1; d < 32; d <<= 1) {
          const int o = __shfl_up_sync(0xffffffffu, incl, d);
          if (t >= d) incl += o;
        }
        // incl grows with t, so the rois that fit are a prefix; the first
        // always fits (stage_bins >= p * p)
        const int n_staged = __popc(__ballot_sync(0xffffffffu, t < nb && incl <= stage_bins));
        const int slots = __shfl_sync(0xffffffffu, incl, n_staged - 1);
        if (t < nb) rects[t] = make_int4(py0, px0, pw, incl - area);
        if (t == 0) {
          counts[32] = n_staged;
          counts[33] = slots;
        }
      }
      __syncthreads();
      const int n_staged = counts[32], slots = counts[33];
      for (int e = t; e < slots * groups; e += nthreads) {   // stage the bins
        const int slot = e / groups, q = e - slot * groups;
        int kk = 0;
        while (kk + 1 < n_staged && rects[kk + 1].w <= slot) ++kk;
        const int4 rc = rects[kk];
        const int i = slot - rc.w, py = rc.x + i / rc.z, px = rc.y + i % rc.z;
        const T* src = img_dout + ((size_t)kept[k0 + kk] * p * p + py * p + px) * c + q * V;
        T* dst = stage + (size_t)slot * chunk + q * V;
        if constexpr (V * sizeof(T) == 16) {
          cp_async16(dst, src);
        } else {
          for (int j = 0; j < V; ++j) dst[j] = src[j];
        }
      }
      if constexpr (V * sizeof(T) == 16) cp_async_wait_all();
      __syncthreads();
#pragma unroll
      for (int k = 0; k < kBackwardPairs; ++k) {
        const int i = t + k * nthreads, pix = i / groups, q = i - pix * groups;
        const int y = pix / tile_w, x = pix - y * tile_w;
        if (i >= pairs || y >= th || x >= tw) continue;
        for (int kk = 0; kk < n_staged; ++kk) {
          const int row = (k0 + kk) % batch * edge;
          const unsigned my = masks[row + y], mx = masks[row + tile_h + x];
          if (my == 0 || mx == 0) continue;
          const int4 rc = rects[kk];                 // (py0, px0, width, first slot)
          const T* d = stage + q * V;
          const float* wy = wts + (row + y) * p;
          const float* wx = wts + (row + tile_h + x) * p;
          for (unsigned ym = my; ym; ym &= ym - 1) {
            const int py = __ffs(ym) - 1;
            float rowsum[V];
#pragma unroll
            for (int j = 0; j < V; ++j) rowsum[j] = 0.0f;
            for (unsigned xm = mx; xm; xm &= xm - 1) {
              const int px = __ffs(xm) - 1;
              float dv[V];
              load_v<V>(d + (rc.w + (py - rc.x) * rc.z + px - rc.y) * chunk, dv);
#pragma unroll
              for (int j = 0; j < V; ++j) {
                rowsum[j] = __fadd_rn(rowsum[j], __fmul_rn(wx[px], dv[j]));
              }
            }
#pragma unroll
            for (int j = 0; j < V; ++j) a[k][j] = __fadd_rn(a[k][j], __fmul_rn(wy[py], rowsum[j]));
          }
        }
      }
      __syncthreads();                               // geometry and stage are refilled
      k0 += n_staged;
    }
  }
  const float inv_count = __fdiv_rn(1.0f, (float)(sr * sr));
  T* out = static_cast<T*>(lv.grad[l]) + (size_t)bi * h * w * c + c0;
#pragma unroll
  for (int k = 0; k < kBackwardPairs; ++k) {
    const int i = t + k * nthreads, pix = i / groups, q = i - pix * groups;
    const int y = pix / tile_w, x = pix - y * tile_w;
    if (i >= pairs || y >= th || x >= tw) continue;
#pragma unroll
    for (int j = 0; j < V; ++j) a[k][j] = __fmul_rn(a[k][j], inv_count);
    store_v<V>(out + ((size_t)(y0 + y) * w + x0 + x) * c + q * V, a[k]);
  }
}

// The RoIAlign kernels' V: 16 bytes of channels a thread (8 bf16, 4 f32), in
// the staging copies, the pooling or adds and the stores, where a pixel's C
// channels are a multiple of 16 bytes; else one channel.
int forward_vec(int is_bf16, int c) {
  const int per16 = is_bf16 ? 8 : 4;
  return c % per16 == 0 ? per16 : 1;
}

// Calls launch(T*, std::integral_constant<int, V>) for the feature or
// gradient dtype T and the kernels' V.
template <typename Launch>
void dispatch_vec(int is_bf16, int c, Launch&& launch) {
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

// The backward launch geometry the caller chose (roi_bwd_plan): the tile, the
// channel chunk, the threads, the kept rois a round's geometry holds (one
// warp's worth at most), the dOut bins a round stages (a whole roi's at
// least), and the shared memory, which must be bwd_layout's.
bool backward_plan_ok(int is_bf16, int c, int p, int sr, int tile_h, int tile_w, int chunk,
                      int threads, int batch, int stage_bins, int smem_bytes) {
  const int v = forward_vec(is_bf16, c);
  return p * sr <= kMaxSamples && tile_h >= 1 && tile_w >= 1 && tile_h + tile_w <= 256 &&
         chunk >= v && chunk % v == 0 && threads >= 32 && threads <= kMaxBackwardThreads &&
         threads % 32 == 0 && tile_h * tile_w * (chunk / v) <= kBackwardPairs * threads &&
         batch >= 1 && batch <= 32 && stage_bins >= p * p &&
         (c + chunk - 1) / chunk <= 65535 && smem_bytes <= 232448 &&
         smem_bytes == bwd_layout(is_bf16 ? 2 : 4, tile_h, tile_w, chunk, p, sr, batch,
                                  stage_bins, threads).total;
}

// One launch of roi_align_bwd_tile_kernel over every tile of the levels in
// lv (grad, h, w and scale filled in); levels is null for one level.
int launch_backward(GradLevels& lv, const void* dout, int is_bf16, const float* rois,
                    const int* levels, int b, int c, int r, int p, int sr, int tile_h,
                    int tile_w, int chunk, int threads, int batch, int stage_bins,
                    int smem_bytes, cudaStream_t stream) {
  if (b <= 0 || c <= 0) return 0;
  if (sr < 1 || sr > kMaxSr || p < 1 || r < 0 || b > 65535 ||
      !backward_plan_ok(is_bf16, c, p, sr, tile_h, tile_w, chunk, threads, batch, stage_bins,
                        smem_bytes)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  long long blocks = 0;
  for (int l = lv.n - 1; l >= 0; --l) {
    if (lv.h[l] < 1 || lv.w[l] < 1) return static_cast<int>(cudaErrorInvalidValue);
    lv.tiles_w[l] = (lv.w[l] + tile_w - 1) / tile_w;
    const long long tiles = (long long)(lv.h[l] + tile_h - 1) / tile_h * lv.tiles_w[l];
    if (blocks + tiles * b > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
    lv.tiles[l] = (int)tiles;
    lv.first[l] = (int)blocks;
    blocks += tiles * b;
  }
  const dim3 grid((unsigned)blocks, (c + chunk - 1) / chunk, 1);
  cudaError_t err = cudaSuccess;
  dispatch_vec(is_bf16, c, [&](auto* tag, auto v) {
    using T = std::remove_pointer_t<decltype(tag)>;
    auto kernel = roi_align_bwd_tile_kernel<T, decltype(v)::value>;
    err = allow_smem(kernel, smem_bytes);
    if (err != cudaSuccess) return;
    kernel<<<grid, threads, smem_bytes, stream>>>(lv, static_cast<const T*>(dout), rois, levels,
                                                  c, r, p, sr, tile_h, tile_w, chunk, batch,
                                                  stage_bins);
  });
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
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
  dispatch_vec(is_bf16, c, [&](auto* tag, auto v) {
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
  dispatch_vec(is_bf16, c, [&](auto* tag, auto v) {
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

// dout (B, R, p, p, C) f32 or bf16 (16-byte aligned), rois (B, R, 4) f32
// image coordinates; dfeat (B, H, W, C) in the dout dtype, every value
// written.  tile_h, tile_w, chunk, threads, batch, stage_bins and
// smem_bytes: the plan (roi_bwd_plan).
extern "C" int frcnn_roi_align_bwd(const void* dout, int is_bf16, const float* rois, int b,
                                   int h, int w, int c, int r, int p, int sr, float scale,
                                   int tile_h, int tile_w, int chunk, int threads, int batch,
                                   int stage_bins, int smem_bytes, void* dfeat,
                                   cudaStream_t stream) {
  GradLevels lv;
  lv.n = 1;
  lv.grad[0] = dfeat;
  lv.h[0] = h;
  lv.w[0] = w;
  lv.scale[0] = scale;
  if (h <= 0 || w <= 0) return 0;
  return launch_backward(lv, dout, is_bf16, rois, nullptr, b, c, r, p, sr, tile_h, tile_w,
                         chunk, threads, batch, stage_bins, smem_bytes, stream);
}

// dout (B, R, p, p, C) f32 or bf16; rois (B, R, 4) f32; levels (B, R) int32
// (a level outside [0, n_levels) adds nothing); dims: (H_l, W_l) pairs and
// scales: 1 / stride_l (host arrays).  dfeats: one buffer in the dout dtype
// that takes the levels' (B, H_l, W_l, C) gradients end to end, in level
// order, every value written.  The plan as for frcnn_roi_align_bwd.
extern "C" int frcnn_roi_align_ml_bwd(const void* dout, int is_bf16, const float* rois,
                                      const int* levels, const int* dims,
                                      const float* scales, int n_levels, int b, int c,
                                      int r, int p, int sr, int tile_h, int tile_w, int chunk,
                                      int threads, int batch, int stage_bins, int smem_bytes,
                                      void* dfeats, cudaStream_t stream) {
  if (n_levels < 1 || n_levels > kMaxLevels) return static_cast<int>(cudaErrorInvalidValue);
  GradLevels lv;
  lv.n = n_levels;
  size_t offset = 0;
  const size_t elem = is_bf16 ? 2 : 4;
  for (int l = 0; l < n_levels; ++l) {
    lv.h[l] = dims[2 * l];
    lv.w[l] = dims[2 * l + 1];
    lv.scale[l] = scales[l];
    lv.grad[l] = static_cast<unsigned char*>(dfeats) + offset * elem;
    offset += (size_t)b * lv.h[l] * lv.w[l] * c;
  }
  return launch_backward(lv, dout, is_bf16, rois, levels, b, c, r, p, sr, tile_h, tile_w,
                         chunk, threads, batch, stage_bins, smem_bytes, stream);
}
