// K3: fused stride-1 ResNet bottleneck for Hopper (sm_90a), bf16.
//
// Replaces the TPU kernel frcnn_tpu/ops/pallas/fused_block.py (_kernel via
// fused_bottleneck).  One block computes, with frozen BN folded into the
// weights and biases:
//   y1  = bf16(relu(x @ w1 + b1))                 over the tile plus a 1-pixel halo
//   y2  = bf16(relu(conv3x3(y1) @ w2 + b2))       from shared memory
//   out = bf16(relu(y2 @ w3 + b3 + residual))     residual = x, or x @ wds + bds
// The intermediates are rounded to bf16 exactly where the TPU kernel rounds
// them (after bias + relu, fused_block.py:91 and :119); the biases are added
// in f32 and accumulation is f32.  Halo cells outside the image are zeros,
// as the TPU kernel's zero padding.
//
// Design: one 256-thread block per (image, 8-row x 16-column output tile).
// conv1 runs over the (8+2) x (16+2) halo region (180 pixels, padded to 192
// rows) into shared memory; conv2 reads the nine shifted taps straight from
// that buffer (a tap of one output row is 16 consecutive halo pixels, so it
// is one 16-row matrix tile); conv3, the projection and the residual run in
// the epilogue.  Only x is read from and only the block output is written to
// device memory.  Products use the tensor cores through warp-level wmma
// (16x16x16 bf16 tiles, f32 accumulators); weights are read from global
// memory and served by L1/L2.
// What bounds it on the H100: at layer1/layer2 width the three convolutions
// are ~70 GFLOP per block call at batch 8, and the unfused chain moves about
// three activation tensors through device memory per conv; fusing keeps the
// two intermediates in shared memory.  This first version does not pipeline
// its loads (no TMA, no wgmma), so it is bound by load latency.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kRows = 8;                          // output rows per tile (one per warp)
constexpr int kCols = 16;                         // output columns per tile (one wmma M tile)
constexpr int kHaloW = kCols + 2;
constexpr int kHaloPix = (kRows + 2) * kHaloW;    // 180
constexpr int kHaloM = 192;                       // kHaloPix padded to 16
constexpr int kOutPix = kRows * kCols;            // 128
constexpr int kChunk = 64;                        // input channels staged per step
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kGroup = 8;                         // output n-tiles per conv3 pass

typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> FragA;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> FragB;
typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> FragC;

template <int MID>
struct Layout {
  static constexpr int xs = 0;                                      // kHaloM x kChunk
  static constexpr int y1 = xs + kHaloM * kChunk * 2;               // kHaloM x MID
  static constexpr int y2 = y1 + kHaloM * MID * 2;                  // kOutPix x MID
  static constexpr int stage = y2 + kOutPix * MID * 2;              // kWarps x 256 f32
  static constexpr int bytes = stage + kWarps * 256 * 4;
};

// Copy `rows` pixel rows of x (channels [k0, k0 + kc)) into xs; a pixel
// outside the image, or a padding row, becomes zeros.  `pixel_of` maps a row
// to the image (row, col) it reads.
template <typename PixelOf>
__device__ __forceinline__ void stage_x(bf16* xs, const bf16* xb, int rows,
                                        int h, int w, int cin, int k0, int kc,
                                        PixelOf pixel_of) {
  const int vecs = kc / 8;
  for (int idx = threadIdx.x; idx < rows * vecs; idx += kThreads) {
    const int row = idx / vecs;
    const int v = idx - row * vecs;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    int gr, gc;
    if (pixel_of(row, &gr, &gc) && gr >= 0 && gr < h && gc >= 0 && gc < w) {
      val = *reinterpret_cast<const uint4*>(xb + ((size_t)gr * w + gc) * cin + k0 + v * 8);
    }
    *reinterpret_cast<uint4*>(xs + row * kChunk + v * 8) = val;
  }
}

template <int MID, bool HAS_DS>
__global__ void __launch_bounds__(kThreads)
fused_bottleneck_kernel(const bf16* __restrict__ x, int h, int w, int cin,
                        const bf16* __restrict__ w1, const bf16* __restrict__ b1,
                        const bf16* __restrict__ w2, const bf16* __restrict__ b2,
                        const bf16* __restrict__ w3, const bf16* __restrict__ b3,
                        const bf16* __restrict__ wds, const bf16* __restrict__ bds,
                        int cout, bf16* __restrict__ out) {
  extern __shared__ __align__(128) unsigned char smem[];
  typedef Layout<MID> L;
  bf16* xs = reinterpret_cast<bf16*>(smem + L::xs);
  bf16* y1s = reinterpret_cast<bf16*>(smem + L::y1);
  bf16* y2s = reinterpret_cast<bf16*>(smem + L::y2);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  float* stage = reinterpret_cast<float*>(smem + L::stage) + warp * 256;

  const int c0 = blockIdx.x * kCols;
  const int r0 = blockIdx.y * kRows;
  const bf16* xb = x + (size_t)blockIdx.z * h * w * cin;
  bf16* ob = out + (size_t)blockIdx.z * h * w * cout;

  // ---- conv1 over the halo region -------------------------------------
  // warps split the MID/16 n-tiles; each keeps its n-tile's B fragment and
  // walks a stride of the 12 halo m-tiles
  constexpr int kN1 = MID / 16;
  constexpr int kWarpsPerN = kWarps / kN1;
  constexpr int kFr1 = (kHaloM / 16) / kWarpsPerN;
  const int n1 = warp % kN1;
  const int m1 = warp / kN1;
  auto halo_pixel = [&](int row, int* gr, int* gc) {
    if (row >= kHaloPix) return false;
    *gr = r0 - 1 + row / kHaloW;
    *gc = c0 - 1 + row % kHaloW;
    return true;
  };
  {
    FragC acc[kFr1];
#pragma unroll
    for (int j = 0; j < kFr1; ++j) wmma::fill_fragment(acc[j], 0.0f);
    for (int k0 = 0; k0 < cin; k0 += kChunk) {
      const int kc = min(kChunk, cin - k0);
      __syncthreads();
      stage_x(xs, xb, kHaloM, h, w, cin, k0, kc, halo_pixel);
      __syncthreads();
      for (int kk = 0; kk < kc; kk += 16) {
        FragB bfr;
        wmma::load_matrix_sync(bfr, w1 + (size_t)(k0 + kk) * MID + n1 * 16, MID);
#pragma unroll
        for (int j = 0; j < kFr1; ++j) {
          FragA afr;
          wmma::load_matrix_sync(afr, xs + (m1 + j * kWarpsPerN) * 16 * kChunk + kk, kChunk);
          wmma::mma_sync(acc[j], afr, bfr, acc[j]);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < kFr1; ++j) {
      const int m = m1 + j * kWarpsPerN;
      wmma::store_matrix_sync(stage, acc[j], 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        const int row = m * 16 + e / 16;
        const int ch = n1 * 16 + e % 16;
        int gr, gc;
        float v = 0.0f;
        if (halo_pixel(row, &gr, &gc) && gr >= 0 && gr < h && gc >= 0 && gc < w) {
          v = fmaxf(stage[e] + __bfloat162float(b1[ch]), 0.0f);
        }
        y1s[row * MID + ch] = __float2bfloat16_rn(v);
      }
      __syncwarp();
    }
  }
  __syncthreads();

  // ---- conv2: warp `warp` computes output row `warp` -------------------
  constexpr int kN2 = MID / 16;
  {
    FragC acc[kN2];
#pragma unroll
    for (int n = 0; n < kN2; ++n) wmma::fill_fragment(acc[n], 0.0f);
    for (int tap = 0; tap < 9; ++tap) {
      const int dr = tap / 3, dc = tap % 3;
      const bf16* a_base = y1s + ((warp + dr) * kHaloW + dc) * MID;
      for (int kk = 0; kk < MID; kk += 16) {
        FragA afr;
        wmma::load_matrix_sync(afr, a_base + kk, MID);
#pragma unroll
        for (int n = 0; n < kN2; ++n) {
          FragB bfr;
          wmma::load_matrix_sync(bfr, w2 + (size_t)(tap * MID + kk) * MID + n * 16, MID);
          wmma::mma_sync(acc[n], afr, bfr, acc[n]);
        }
      }
    }
#pragma unroll
    for (int n = 0; n < kN2; ++n) {
      wmma::store_matrix_sync(stage, acc[n], 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        const int ch = n * 16 + e % 16;
        const float v = fmaxf(stage[e] + __bfloat162float(b2[ch]), 0.0f);
        y2s[(warp * kCols + e / 16) * MID + ch] = __float2bfloat16_rn(v);
      }
      __syncwarp();
    }
  }
  __syncthreads();

  // ---- conv3 + residual + relu, kGroup output n-tiles per pass ---------
  const int gr = r0 + warp;
  auto out_pixel = [&](int row, int* pr, int* pc) {
    *pr = r0 + row / kCols;
    *pc = c0 + row % kCols;
    return true;
  };
  for (int n0 = 0; n0 < cout; n0 += kGroup * 16) {
    FragC acc[kGroup];
#pragma unroll
    for (int n = 0; n < kGroup; ++n) wmma::fill_fragment(acc[n], 0.0f);
    if constexpr (HAS_DS) {
      for (int k0 = 0; k0 < cin; k0 += kChunk) {
        const int kc = min(kChunk, cin - k0);
        __syncthreads();
        stage_x(xs, xb, kOutPix, h, w, cin, k0, kc, out_pixel);
        __syncthreads();
        for (int kk = 0; kk < kc; kk += 16) {
          FragA afr;
          wmma::load_matrix_sync(afr, xs + warp * 16 * kChunk + kk, kChunk);
#pragma unroll
          for (int n = 0; n < kGroup; ++n) {
            FragB bfr;
            wmma::load_matrix_sync(bfr, wds + (size_t)(k0 + kk) * cout + n0 + n * 16, cout);
            wmma::mma_sync(acc[n], afr, bfr, acc[n]);
          }
        }
      }
    }
    for (int kk = 0; kk < MID; kk += 16) {
      FragA afr;
      wmma::load_matrix_sync(afr, y2s + warp * 16 * MID + kk, MID);
#pragma unroll
      for (int n = 0; n < kGroup; ++n) {
        FragB bfr;
        wmma::load_matrix_sync(bfr, w3 + (size_t)kk * cout + n0 + n * 16, cout);
        wmma::mma_sync(acc[n], afr, bfr, acc[n]);
      }
    }
#pragma unroll
    for (int n = 0; n < kGroup; ++n) {
      wmma::store_matrix_sync(stage, acc[n], 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        const int gc = c0 + e / 16;
        const int ch = n0 + n * 16 + e % 16;
        if (gr < h && gc < w) {
          const size_t pix = (size_t)gr * w + gc;
          float v = stage[e] + __bfloat162float(b3[ch]);
          if constexpr (HAS_DS) {
            v += __bfloat162float(bds[ch]);
          } else {
            v += __bfloat162float(xb[pix * cin + ch]);
          }
          ob[pix * cout + ch] = __float2bfloat16_rn(fmaxf(v, 0.0f));
        }
      }
      __syncwarp();
    }
  }
}

template <int MID, bool HAS_DS>
cudaError_t launch(const bf16* x, int b, int h, int w, int cin, int cout,
                   const bf16* w1, const bf16* b1, const bf16* w2,
                   const bf16* b2, const bf16* w3, const bf16* b3,
                   const bf16* wds, const bf16* bds, bf16* out,
                   cudaStream_t stream) {
  auto kernel = fused_bottleneck_kernel<MID, HAS_DS>;
  const int bytes = Layout<MID>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  dim3 grid((w + kCols - 1) / kCols, (h + kRows - 1) / kRows, b);
  kernel<<<grid, kThreads, bytes, stream>>>(x, h, w, cin, w1, b1, w2, b2, w3,
                                            b3, wds, bds, cout, out);
  return cudaGetLastError();
}

}  // namespace

// x (B, H, W, Cin) bf16; w1 (Cin, mid); w2 (9*mid, mid), rows ordered
// (dr, dc, in); w3 (mid, Cout); optional wds (Cin, Cout); biases (mid,) or
// (Cout,); all bf16 with frozen BN folded in.  out (B, H, W, Cout) bf16.
extern "C" int frcnn_fused_bottleneck(const void* x, int b, int h, int w,
                                      int cin, int mid, int cout,
                                      const void* w1, const void* b1,
                                      const void* w2, const void* b2,
                                      const void* w3, const void* b3,
                                      const void* wds, const void* bds,
                                      void* out, cudaStream_t stream) {
  if (b <= 0 || h <= 0 || w <= 0) return 0;
  const bool has_ds = wds != nullptr;
  if (cin % 16 != 0 || cout % (kGroup * 16) != 0 || (!has_ds && cin != cout) ||
      b > 65535 || (h + kRows - 1) / kRows > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bf16* args[8] = {static_cast<const bf16*>(w1), static_cast<const bf16*>(b1),
                         static_cast<const bf16*>(w2), static_cast<const bf16*>(b2),
                         static_cast<const bf16*>(w3), static_cast<const bf16*>(b3),
                         static_cast<const bf16*>(wds), static_cast<const bf16*>(bds)};
  const bf16* xx = static_cast<const bf16*>(x);
  bf16* o = static_cast<bf16*>(out);
  cudaError_t err;
  if (mid == 64) {
    err = has_ds ? launch<64, true>(xx, b, h, w, cin, cout, args[0], args[1], args[2], args[3],
                                    args[4], args[5], args[6], args[7], o, stream)
                 : launch<64, false>(xx, b, h, w, cin, cout, args[0], args[1], args[2], args[3],
                                     args[4], args[5], args[6], args[7], o, stream);
  } else if (mid == 128) {
    err = has_ds ? launch<128, true>(xx, b, h, w, cin, cout, args[0], args[1], args[2], args[3],
                                     args[4], args[5], args[6], args[7], o, stream)
                 : launch<128, false>(xx, b, h, w, cin, cout, args[0], args[1], args[2], args[3],
                                      args[4], args[5], args[6], args[7], o, stream);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
