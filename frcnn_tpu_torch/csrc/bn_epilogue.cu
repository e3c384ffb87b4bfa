// The BN epilogue: frozen BN's affine, the residual add and the ReLU of an
// unfused ResNet bottleneck (and of the stem) as one pass over a
// convolution's bf16 channels-last output, for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package leaves these elementwise ops to
// XLA's fusion of the convolution's output.  On the card PyTorch
// runs them as separate passes (x * mul, + add, relu; + residual, relu; and
// the fold of (mul, add) from the statistics, ~8 small launches a norm).
// Here, for x (N, C) bf16 (N = B * H * W pixels, channels last):
//   out = act(x * mul + add [+ res | + ds * mul_ds + add_ds])
// with act ReLU or nothing, res an identity residual, ds the projection
// shortcut's own convolution output with its own frozen BN.
//
// BN is folded inside the kernel, as FrozenBatchNorm.folded does it: from
// the f32 buffers (weight, bias, running_mean, running_var) and eps,
//   inv = sqrt(var + eps); mul = w / inv; add = b - mean * w / inv
// in f32 with correctly rounded operations, then each rounded to bf16 (the
// JAX module's .astype(dtype)).  The rest is f32, in the order written
// above, with no FMA contraction (__f*_rn), rounded once at the store.  So
// weights copied into the buffers in place reach the next launch, and a
// captured graph holds no folded tensor.
//
// What bounds it on the H100: bytes (x, the residual or shortcut, and out,
// each once: ~6.5 GB a ResNet-101 C4 serving batch of 8 at 608x1024, ~1.95
// ms at 3.35 TB/s).  Design: 16-byte loads and stores (8 bf16); one
// 512-thread block an SM (blocks x threads a multiple of C / 8, so that a
// thread's channels stay the same in every step of its grid-stride loop:
// it folds its 8 channels (16 with a shortcut) once, into registers, as
// packed bf16 pairs, while its first loads are in flight); eight vectors
// (four and their residuals) loaded before any is stored, 128 bytes in
// flight a thread.  Most launches are small (5M values in layer3), where a
// launch's fixed latency, not the bytes, sets the time: fewer, longer
// threads measured faster there than two or more blocks an SM, and within
// a few percent on the largest shapes (grids of 132 to 1056 blocks on an
// H100 SXM).  The grid is chosen from the shape by a fixed rule
// (ops/cuda/epilogue_grid.py, epilogue_plan); the launcher refuses a plan
// whose step is not a whole number of pixels.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;

enum Mode { kNone = 0, kResidual = 1, kProjection = 2 };

struct FrozenBn {
  const float* weight;
  const float* bias;
  const float* mean;
  const float* var;
  float eps;
};

// (mul, add) of channels c .. c + 7, rounded to bf16, as 4 pairs each.
struct Folded {
  __nv_bfloat162 mul[4];
  __nv_bfloat162 add[4];
};

// 8 floats from p (32-byte aligned: c is a multiple of 8)
__device__ __forceinline__ void load8(const float* p, float (&out)[8]) {
  const float4 lo = *reinterpret_cast<const float4*>(p);
  const float4 hi = *reinterpret_cast<const float4*>(p + 4);
  out[0] = lo.x, out[1] = lo.y, out[2] = lo.z, out[3] = lo.w;
  out[4] = hi.x, out[5] = hi.y, out[6] = hi.z, out[7] = hi.w;
}

__device__ __forceinline__ Folded fold(const FrozenBn& bn, int c) {
  float w[8], b[8], mean[8], var[8];
  load8(bn.weight + c, w);
  load8(bn.bias + c, b);
  load8(bn.mean + c, mean);
  load8(bn.var + c, var);
  Folded f;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    float m[2], a[2];
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int i = 2 * j + k;
      const float inv = __fsqrt_rn(__fadd_rn(var[i], bn.eps));
      m[k] = __fdiv_rn(w[i], inv);
      a[k] = __fsub_rn(b[i], __fdiv_rn(__fmul_rn(mean[i], w[i]), inv));
    }
    f.mul[j] = __floats2bfloat162_rn(m[0], m[1]);
    f.add[j] = __floats2bfloat162_rn(a[0], a[1]);
  }
  return f;
}

__device__ __forceinline__ float2 affine(float2 x, __nv_bfloat162 mul, __nv_bfloat162 add) {
  const float2 m = __bfloat1622float2(mul);
  const float2 a = __bfloat1622float2(add);
  return make_float2(__fadd_rn(__fmul_rn(x.x, m.x), a.x), __fadd_rn(__fmul_rn(x.y, m.y), a.y));
}

// relu as torch.relu: NaN stays NaN
__device__ __forceinline__ float relu(float v) { return v < 0.0f ? 0.0f : v; }

template <int MODE, bool RELU>
__device__ __forceinline__ uint4 apply(uint4 xv, uint4 rv, const Folded& f, const Folded& fd) {
  const __nv_bfloat162* xp = reinterpret_cast<const __nv_bfloat162*>(&xv);
  const __nv_bfloat162* rp = reinterpret_cast<const __nv_bfloat162*>(&rv);
  uint4 ov;
  __nv_bfloat162* op = reinterpret_cast<__nv_bfloat162*>(&ov);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    float2 y = affine(__bfloat1622float2(xp[j]), f.mul[j], f.add[j]);
    if (MODE == kResidual) {
      const float2 r = __bfloat1622float2(rp[j]);
      y = make_float2(__fadd_rn(y.x, r.x), __fadd_rn(y.y, r.y));
    } else if (MODE == kProjection) {
      const float2 r = affine(__bfloat1622float2(rp[j]), fd.mul[j], fd.add[j]);
      y = make_float2(__fadd_rn(y.x, r.x), __fadd_rn(y.y, r.y));
    }
    if (RELU) y = make_float2(relu(y.x), relu(y.y));
    op[j] = __floats2bfloat162_rn(y.x, y.y);
  }
  return ov;
}

// x, res, out: nvec vectors of 8 bf16 (channels last, c a multiple of 8);
// gridDim.x * blockDim.x a multiple of c / 8.
template <int MODE, bool RELU>
__global__ void __launch_bounds__(kThreads, 1)
bn_epilogue_kernel(const uint4* __restrict__ x, long long nvec, int c, FrozenBn bn,
                   const uint4* __restrict__ res, FrozenBn bn_ds, uint4* __restrict__ out) {
  // vectors a thread loads before it stores: 128 bytes in flight, x's
  // alone or x's and the residual's (or shortcut's) half each
  constexpr int kUnroll = MODE == kNone ? 8 : 4;
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  long long v = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (v >= nvec) return;
  uint4 xv[kUnroll], rv[kUnroll] = {};
  auto load = [&](long long v0) {
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long i = v0 + u * step;
      if (i < nvec) {
        xv[u] = x[i];
        if (MODE != kNone) rv[u] = res[i];
      }
    }
  };
  // the first vectors are in flight while the thread folds its channels
  load(v);
  const int c0 = static_cast<int>((v * 8) % c);
  const Folded f = fold(bn, c0);
  const Folded fd = MODE == kProjection ? fold(bn_ds, c0) : f;
  for (;;) {
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long i = v + u * step;
      if (i < nvec) out[i] = apply<MODE, RELU>(xv[u], rv[u], f, fd);
    }
    v += kUnroll * step;
    if (v >= nvec) break;
    load(v);
  }
}

template <int MODE, bool RELU>
cudaError_t launch(const uint4* x, long long nvec, int c, FrozenBn bn, const uint4* res,
                   FrozenBn bn_ds, int blocks, uint4* out, cudaStream_t stream) {
  bn_epilogue_kernel<MODE, RELU><<<blocks, kThreads, 0, stream>>>(x, nvec, c, bn, res, bn_ds,
                                                                  out);
  return cudaGetLastError();
}

template <int MODE>
cudaError_t launch_mode(bool relu, const uint4* x, long long nvec, int c, FrozenBn bn,
                        const uint4* res, FrozenBn bn_ds, int blocks, uint4* out,
                        cudaStream_t stream) {
  return relu ? launch<MODE, true>(x, nvec, c, bn, res, bn_ds, blocks, out, stream)
              : launch<MODE, false>(x, nvec, c, bn, res, bn_ds, blocks, out, stream);
}

}  // namespace

// x, out (n,) bf16, channels last with c channels; weight, bias, mean, var
// (c,) f32 and eps: x's frozen BN.  mode 0: no middle term (res unused);
// 1: res (n,) bf16 is added; 2: res (n,) bf16 is the shortcut's output,
// through its own frozen BN (ds_*, ds_eps).  relu 0 or 1.  threads must be
// this file's; blocks * threads a multiple of c / 8.  Every pointer 16-byte
// aligned.
extern "C" int frcnn_bn_epilogue(const void* x, long long n, int c, const float* weight,
                                 const float* bias, const float* mean, const float* var, float eps,
                                 const void* res, int mode, const float* ds_weight,
                                 const float* ds_bias, const float* ds_mean, const float* ds_var,
                                 float ds_eps, int relu, int threads, int blocks, void* out,
                                 cudaStream_t stream) {
  if (n <= 0) return 0;
  if (c <= 0 || c % 8 != 0 || n % c != 0 || threads != kThreads || blocks <= 0 ||
      (static_cast<long long>(blocks) * threads) % (c / 8) != 0 || mode < kNone ||
      mode > kProjection || (mode != kNone && res == nullptr) ||
      (mode == kProjection && (!ds_weight || !ds_bias || !ds_mean || !ds_var))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const FrozenBn bn{weight, bias, mean, var, eps};
  const FrozenBn bn_ds{ds_weight, ds_bias, ds_mean, ds_var, ds_eps};
  const uint4* xv = static_cast<const uint4*>(x);
  const uint4* rv = static_cast<const uint4*>(res);
  uint4* ov = static_cast<uint4*>(out);
  const long long nvec = n / 8;
  cudaError_t err;
  if (mode == kNone) {
    err = launch_mode<kNone>(relu != 0, xv, nvec, c, bn, rv, bn_ds, blocks, ov, stream);
  } else if (mode == kResidual) {
    err = launch_mode<kResidual>(relu != 0, xv, nvec, c, bn, rv, bn_ds, blocks, ov, stream);
  } else {
    err = launch_mode<kProjection>(relu != 0, xv, nvec, c, bn, rv, bn_ds, blocks, ov, stream);
  }
  return static_cast<int>(err);
}
