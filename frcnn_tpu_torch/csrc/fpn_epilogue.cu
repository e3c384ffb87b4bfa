// The FPN epilogue: what follows each biased convolution of the FPN neck and
// of its RPN conv, as one pass over the convolution's bf16 channels-last
// output, for Hopper (sm_90a).
//
// Replaces no TPU kernel: XLA fuses the bias, the top-down add and the relu
// into the JAX package's convolutions.  On the card PyTorch ran them as
// separate passes: cuDNN's convolution leaves its bias to a broadcast add_
// (PyTorch's unvectorised elementwise kernel), the top-down path wrote a
// nearest 2x upsampled copy of the coarser level and added it in another
// pass, and the RPN conv's relu was one more.  Here, for x (B, H, W, C) bf16
// (the convolution run without its bias), one of three modes:
//   bias         out = x + bias                     (lateral P5, output P2-P5)
//   bias + relu  out = relu(x + bias)               (the RPN conv on P2-P6)
//   merge        out = (x + bias) + top[y/2, x/2]   (laterals P2-P4)
// where top (B, TH, TW, C) is the coarser level, read in place at the
// nearest 2x source pixel (cropped where a level is odd: 2 TH >= H, 2 TW >=
// W); no upsampled tensor is written.
//
// Rounding is the module path's: the bias (f32 buffer) rounded to bf16, as
// the convolution casts it; x + bias in f32, rounded to bf16; in merge mode
// that plus the top pixel in f32, rounded to bf16 again; the relu on the
// rounded value, as torch.relu (max with 0, NaN kept).  So the result is
// bit-equal to the passes it replaces, and a bias copied into the
// parameter in place reaches the next launch or graph replay.
//
// What bounds it on the H100: bytes (x and out once, and in merge mode the
// coarser level once: 2.29 GB for the 13 launches of a ResNet-50 FPN
// serving batch of 8 at 800x1344, 0.68 ms at 3.35 TB/s).  Design: 16-byte
// loads and stores (8 bf16 channels); one 512-thread block an SM, a
// grid-stride loop whose step is a whole number of pixels, so that a
// thread's 8 channels (and its 8 biases, held in registers) stay the same
// in every step; eight vectors in flight a thread before any is stored
// (four and their top pixels in merge mode).  The top pixel's address
// comes from the output pixel's (n, y, x) by two integer divisions; each
// coarse pixel is read by four output pixels close in time, so after its
// first read it comes from L2.  The grid is chosen from the shape by a
// fixed rule (ops/cuda/epilogue_grid.py, epilogue_plan); the launcher refuses a
// plan whose step is not a whole number of pixels.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;

enum Mode { kBias = 0, kBiasRelu = 1, kMerge = 2 };

// relu as torch.relu (clamp_min): max with 0, NaN kept
__device__ __forceinline__ float relu(float v) { return v != v ? v : fmaxf(v, 0.0f); }

template <int MODE>
__device__ __forceinline__ uint4 apply(uint4 xv, uint4 tv, const float (&b)[8]) {
  const __nv_bfloat162* xp = reinterpret_cast<const __nv_bfloat162*>(&xv);
  const __nv_bfloat162* tp = reinterpret_cast<const __nv_bfloat162*>(&tv);
  uint4 ov;
  __nv_bfloat162* op = reinterpret_cast<__nv_bfloat162*>(&ov);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 x = __bfloat1622float2(xp[j]);
    __nv_bfloat162 y =
        __floats2bfloat162_rn(__fadd_rn(x.x, b[2 * j]), __fadd_rn(x.y, b[2 * j + 1]));
    if (MODE == kMerge) {
      const float2 s = __bfloat1622float2(y);
      const float2 t = __bfloat1622float2(tp[j]);
      y = __floats2bfloat162_rn(__fadd_rn(s.x, t.x), __fadd_rn(s.y, t.y));
    } else if (MODE == kBiasRelu) {
      const float2 s = __bfloat1622float2(y);
      y = __floats2bfloat162_rn(relu(s.x), relu(s.y));
    }
    op[j] = y;
  }
  return ov;
}

struct Shape {
  int h, w;      // x's rows and columns
  int th, tw;    // top's (merge mode)
  int cv;        // vectors of 8 channels a pixel
};

// x, out: nvec vectors of 8 bf16 (channels last); top: the coarser level
// (merge mode); gridDim.x * blockDim.x a multiple of shape.cv.
template <int MODE>
__global__ void __launch_bounds__(kThreads, 1)
fpn_epilogue_kernel(const uint4* __restrict__ x, long long nvec, const float* __restrict__ bias,
                    const uint4* __restrict__ top, Shape shape, uint4* __restrict__ out) {
  // vectors a thread loads before it stores: 128 bytes in flight, x's alone
  // or x's and the top pixels' half each
  constexpr int kUnroll = MODE == kMerge ? 4 : 8;
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  long long v = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (v >= nvec) return;
  const int cg = static_cast<int>(v % shape.cv);           // the thread's channel group
  const int pixel_step = static_cast<int>(step / shape.cv);
  int pixel = static_cast<int>(v / shape.cv);
  uint4 xv[kUnroll], tv[kUnroll] = {};
  auto top_vector = [&](int p) {
    const int col = p % shape.w;
    const int row_all = p / shape.w;
    const int row = row_all % shape.h;
    const int n = row_all / shape.h;
    const long long tp =
        (static_cast<long long>(n) * shape.th + (row >> 1)) * shape.tw + (col >> 1);
    return top[tp * shape.cv + cg];
  };
  auto load = [&](long long v0, int p0) {
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long i = v0 + u * step;
      if (i < nvec) {
        xv[u] = x[i];
        if (MODE == kMerge) tv[u] = top_vector(p0 + u * pixel_step);
      }
    }
  };
  // the first vectors are in flight while the thread reads its biases
  load(v, pixel);
  float b[8];
  {
    const float4 lo = *reinterpret_cast<const float4*>(bias + 8 * cg);
    const float4 hi = *reinterpret_cast<const float4*>(bias + 8 * cg + 4);
    const float f[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
#pragma unroll
    for (int k = 0; k < 8; ++k) b[k] = __bfloat162float(__float2bfloat16_rn(f[k]));
  }
  for (;;) {
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long i = v + u * step;
      if (i < nvec) out[i] = apply<MODE>(xv[u], tv[u], b);
    }
    v += kUnroll * step;
    if (v >= nvec) break;
    pixel += kUnroll * pixel_step;
    load(v, pixel);
  }
}

template <int MODE>
cudaError_t launch(const uint4* x, long long nvec, const float* bias, const uint4* top,
                   Shape shape, int blocks, uint4* out, cudaStream_t stream) {
  fpn_epilogue_kernel<MODE><<<blocks, kThreads, 0, stream>>>(x, nvec, bias, top, shape, out);
  return cudaGetLastError();
}

}  // namespace

// x, out (b, h, w, c) bf16, channels last; bias (c,) f32; top (b, th, tw,
// c) bf16 or null: with top, merge mode (2 th >= h, 2 tw >= w), no relu;
// without, bias mode, with the relu if relu is 1.  c a multiple of 8, b *
// h * w below 2^31; threads must be this file's; blocks * threads a
// multiple of c / 8.  Every pointer 16-byte aligned, bias 32-byte aligned.
extern "C" int frcnn_fpn_epilogue(const void* x, int b, int h, int w, int c, const float* bias,
                                  const void* top, int th, int tw, int relu, int threads,
                                  int blocks, void* out, cudaStream_t stream) {
  const long long pixels = static_cast<long long>(b) * h * w;
  if (b < 0 || h < 0 || w < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (pixels == 0) return 0;
  if (c <= 0 || c % 8 != 0 || pixels >= (1LL << 31) || bias == nullptr ||
      threads != kThreads || blocks <= 0 ||
      (static_cast<long long>(blocks) * threads) % (c / 8) != 0 || (relu != 0 && relu != 1) ||
      (top != nullptr && (relu != 0 || th <= 0 || tw <= 0 || 2LL * th < h || 2LL * tw < w))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Shape shape{h, w, th, tw, c / 8};
  const uint4* xv = static_cast<const uint4*>(x);
  const uint4* tv = static_cast<const uint4*>(top);
  uint4* ov = static_cast<uint4*>(out);
  const long long nvec = pixels * (c / 8);
  cudaError_t err;
  if (top != nullptr) {
    err = launch<kMerge>(xv, nvec, bias, tv, shape, blocks, ov, stream);
  } else if (relu) {
    err = launch<kBiasRelu>(xv, nvec, bias, tv, shape, blocks, ov, stream);
  } else {
    err = launch<kBias>(xv, nvec, bias, tv, shape, blocks, ov, stream);
  }
  return static_cast<int>(err);
}
