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
// What bounds it on the H100: by the count, bytes (x read once, out written
// once; the products alone would take about as long).  In fact the traffic
// from L2 into shared memory: every block stages all of w1, w2 and w3 (544
// KB at mid 128) beside its 320-pixel halo of x.  Switching the products off
// changes nothing, switching the copies off halves the time, and the ring's
// depth does not matter (scripts/ablate_fused_block.py; PERF.md holds the
// times).  So the tile is as large as one block can hold:
// the weights are staged once for 240 output pixels.
//
// Design: one 512-thread block (four warpgroups) per (image, 8-row x
// 30-column output tile), one block an SM.
//   * Products by wgmma (m64nNk16, bf16 in, f32 accumulators in registers),
//     A and B both from shared memory through descriptors, no swizzle.
//   * Pixels are FLATTENED at a pitch of 32: halo pixel (r, c) of the 10 x 32
//     halo region is row r * 32 + c, output pixel (r, c) is row r * 32 + c of
//     an 8 x 32 region (columns 30 and 31 are computed and dropped).  The
//     3x3 tap (dr, dc) of output row m is then halo row m + dr * 32 + dc: for
//     every tap the A operand of a 64-row wgmma is 64 CONSECUTIVE halo rows,
//     one descriptor at a shifted start.  Activations lie in shared memory
//     as [channel / 8][pixel][8 channels]: a pixel's 8 channels are 16 bytes,
//     consecutive pixels are 16 bytes apart, so every 8-row core matrix is
//     128 contiguous bytes at ANY starting pixel (K-major, stride between
//     8-row groups 128 bytes, leading offset one channel group).
//   * Weights are (K, N) row-major in device memory and go to shared memory
//     as [k / 8][n / 8][k % 8][8 columns]: the MN-major operand of wgmma
//     (transpose flag), so no repacking launch is needed.
//   * Everything is staged by cp.async through a three-stage ring, two steps
//     ahead of the products: conv1 streams 32 input channels of the halo tile
//     and of w1 a step; conv2 streams w2 by half taps (64 x mid); conv3
//     streams w3 (and, with a projection, 32-channel chunks of x and wds) by
//     panels of 64 output columns.  The copy order makes every group of 8
//     lanes write 128 contiguous bytes of shared memory and every warp read
//     whole 64-byte runs of device memory.
//   * y1 and y2 never leave shared memory (y2 takes y1's place).  Epilogues
//     run from the accumulator registers: bias from shared memory, relu,
//     rounding; the block output goes through a swizzled shared tile and
//     leaves as 16-byte stores, 128 contiguous bytes a pixel.  The identity
//     residual is asked for before a panel's products and added after them
//     (4-byte loads of the tile the block has just streamed: served by L2).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kTileW = 30;                        // output columns per tile
constexpr int kTileH = 8;                         // output rows per tile
constexpr int kPitch = 32;                        // flattened row pitch: kTileW + 2
constexpr int kM1 = (kTileH + 2) * kPitch;        // 320 halo rows: five 64-row tiles
constexpr int kM2 = kTileH * kPitch;              // 256 output rows: one tile a warpgroup
constexpr int kY1Rows = kM2 + 2 * kPitch + 2;     // 322: the last tap of the last row
constexpr int kThreads = 512;
constexpr int kWarpgroups = kThreads / 128;       // each takes one 64-row tile of conv2 and conv3
constexpr int kKC = 32;                           // input channels per conv1 / projection step
constexpr int kK2 = 64;                           // rows of w2 per conv2 step
constexpr int kPanel = 64;                        // output columns per conv3 step
constexpr int kStages = 3;
constexpr int kOutStage = kWarpgroups * 64 * kPanel * 2;   // the warpgroups' output tiles
static_assert(kM2 == 64 * kWarpgroups && kM1 % 64 == 0, "one 64-row output tile a warpgroup");

constexpr int cmax(int a, int b) { return a > b ? a : b; }

template <int MID>
struct Layout {
  static constexpr int y1_bytes = MID / 8 * kY1Rows * 16;
  static constexpr int y2_bytes = MID / 8 * kM2 * 16;          // at offset 0, over y1
  static constexpr int out_stage = y2_bytes;
  static constexpr int ring = (cmax(y1_bytes, y2_bytes + kOutStage) + 127) / 128 * 128;
  static constexpr int a1_bytes = kKC / 8 * kM1 * 16;          // conv1: x chunk, then w1 chunk
  static constexpr int stage1 = a1_bytes + kKC * MID * 2;
  static constexpr int stage2 = kK2 * MID * 2;
  static constexpr int a3_bytes = kKC / 8 * kM2 * 16;          // projection: x chunk, then wds chunk
  static constexpr int stage3 = cmax(MID * kPanel * 2, a3_bytes + kKC * kPanel * 2);
  static constexpr int bias = ring + kStages * cmax(stage1, cmax(stage2, stage3));
  static constexpr int bytes(int cout) { return bias + (2 * MID + cout) * 4; }
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from device to shared memory; src_bytes = 0 writes zeros
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(src_bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}
// writes made by this thread (cp.async, st.shared) become visible to wgmma
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(threads) : "memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// Shared-memory matrix descriptor, no swizzle: start address, leading byte
// offset (between the two 8-wide halves of K for A; between 8-row groups of
// K for an MN-major B) and stride byte offset (between 8-row groups of M
// for A; between 8-column groups of N for B), all in 16-byte units.
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, int lbo, int sbo) {
  return (uint64_t)((addr & 0x3FFFFu) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32);
}

// m64nNk16, bf16 x bf16 -> f32: A and B from shared-memory descriptors, B
// MN-major (the last immediate), d = a b + (scale_d ? d : 0).
__device__ __forceinline__ void wgmma_n32(float (&d)[16], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_n64(float (&d)[32], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, "
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_n128(float (&d)[64], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, "
      " %24, %25, %26, %27, %28, %29, %30, %31, "
      " %32, %33, %34, %35, %36, %37, %38, %39, "
      " %40, %41, %42, %43, %44, %45, %46, %47, "
      " %48, %49, %50, %51, %52, %53, %54, %55, "
      " %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <int N> struct Wgmma;
template <> struct Wgmma<32> {
  static __device__ __forceinline__ void run(float (&d)[16], uint64_t a, uint64_t b, int s) {
    wgmma_n32(d, a, b, s);
  }
};
template <> struct Wgmma<64> {
  static __device__ __forceinline__ void run(float (&d)[32], uint64_t a, uint64_t b, int s) {
    wgmma_n64(d, a, b, s);
  }
};
template <> struct Wgmma<128> {
  static __device__ __forceinline__ void run(float (&d)[64], uint64_t a, uint64_t b, int s) {
    wgmma_n128(d, a, b, s);
  }
};

// Rows [k0, k0 + kt) x columns [n0, n0 + NT) of a (K, ldw) row-major weight
// matrix into shared memory as [k / 8][n / 8][k % 8][8]; rows at or beyond
// k_end become zeros.  Lanes 0-7 of a group write one 128-byte core matrix.
template <int NT>
__device__ __forceinline__ void stage_weights(uint32_t dst, const bf16* __restrict__ wmat,
                                              int ldw, int k0, int n0, int kt, int k_end) {
  constexpr int kGroups = NT / 8;
#pragma unroll 1
  for (int c = threadIdx.x; c < kt * kGroups; c += kThreads) {
    const int kk = c & 7;
    const int g = (c >> 3) % kGroups;
    const int kb = (c >> 3) / kGroups;
    const int k = k0 + kb * 8 + kk;
    const bool ok = k < k_end;
    const bf16* src = ok ? wmat + (size_t)k * ldw + n0 + g * 8 : wmat;
    cp_async16(dst + kb * (NT * 16) + g * 128 + kk * 16, src, ok ? 16 : 0);
  }
}

// `rows` flattened pixels x kKC channels [k0, k0 + kKC) of x into shared
// memory as [channel / 8][pixel][8]; row m is image pixel (row0 + m / 32,
// col0 + m % 32); pixels outside the image and channels at or beyond cin
// become zeros.
__device__ __forceinline__ void stage_pixels(uint32_t dst, const bf16* __restrict__ xb, int rows,
                                             int row0, int col0, int h, int w, int cin, int k0) {
#pragma unroll 1
  for (int c = threadIdx.x; c < (kKC / 8) * rows; c += kThreads) {
    const int kc = (c >> 3) & 3;
    const int pix = (c >> 5) * 8 + (c & 7);
    const int gr = row0 + (pix >> 5), gc = col0 + (pix & 31);
    const int ch = k0 + kc * 8;
    const bool ok = gr >= 0 && gr < h && gc >= 0 && gc < w && ch < cin;
    const bf16* src = ok ? xb + ((size_t)gr * w + gc) * cin + ch : xb;
    cp_async16(dst + kc * (rows * 16) + pix * 16, src, ok ? 16 : 0);
  }
}

// The ring: `load(step, buffer)` starts the copies of a step, `mma(step,
// buffer)` multiplies what a step brought and waits for its products.  The
// copies run kStages - 1 steps ahead.  One block barrier a step: it makes
// the step's data visible to every warp and, since every warp has waited
// for its own products of the step before, frees the buffer refilled next.
template <typename Load>
__device__ __forceinline__ void ring_prologue(int nsteps, Load load) {
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nsteps) load(s, s);
    cp_async_commit();
  }
}
template <typename Load, typename Mma>
__device__ __forceinline__ void ring_loop(int nsteps, Load load, Mma mma) {
  int buf = 0, next = kStages - 1;
  for (int s = 0; s < nsteps; ++s) {
    cp_async_wait<kStages - 2>();
    fence_proxy_async();
    __syncthreads();
    if (s + kStages - 1 < nsteps) load(s + kStages - 1, next);
    cp_async_commit();
    mma(s, buf);
    buf = buf + 1 == kStages ? 0 : buf + 1;
    next = next + 1 == kStages ? 0 : next + 1;
  }
}

__device__ __forceinline__ uint32_t pack_relu(float a, float b) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(fmaxf(a, 0.0f), fmaxf(b, 0.0f));
  return *reinterpret_cast<const uint32_t*>(&v);
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
  const uint32_t sbase = smem_u32(smem);
  const uint32_t ring = sbase + L::ring;
  const int t = threadIdx.x;
  const int wg = t >> 7;             // warpgroup
  const int tw = t & 127;            // thread of the warpgroup
  const int lane = t & 31;
  const int frow = ((tw >> 5) << 4) + (lane >> 2);   // accumulator row of the 64-row tile (and + 8)
  const int fcol = (lane & 3) << 1;                  // accumulator column of each 8-column group

  const int c0 = blockIdx.x * kTileW;
  const int r0 = blockIdx.y * kTileH;
  const bf16* xb = x + (size_t)blockIdx.z * h * w * cin;
  bf16* ob = out + (size_t)blockIdx.z * h * w * cout;

  float* bias1 = reinterpret_cast<float*>(smem + L::bias);
  float* bias2 = bias1 + MID;
  float* bias3 = bias2 + MID;
  for (int i = t; i < MID; i += kThreads) {
    bias1[i] = __bfloat162float(b1[i]);
    bias2[i] = __bfloat162float(b2[i]);
  }
  for (int i = t; i < cout; i += kThreads) {
    float v = __bfloat162float(b3[i]);
    if constexpr (HAS_DS) v += __bfloat162float(bds[i]);
    bias3[i] = v;
  }
  // (visible to every thread after the first barrier of the ring)

  // ---- conv1 over the halo region, in units of a 64-row tile x half of the
  // mid columns; unit u (tile u / 2, half u % 2) goes to warpgroup u mod
  // kWarpgroups ------------------------------------------------------------
  constexpr int kNH = MID / 2;
  constexpr int kUnits = kM1 / 64 * 2;
  constexpr int kUnitsPerWG = (kUnits + kWarpgroups - 1) / kWarpgroups;
  float acc1[kUnitsPerWG][kNH / 2];
  {
    const int nsteps = (cin + kKC - 1) / kKC;
    auto load = [&](int s, int buf) {
      const uint32_t dst = ring + buf * L::stage1;
      stage_pixels(dst, xb, kM1, r0 - 1, c0 - 1, h, w, cin, s * kKC);
      stage_weights<MID>(dst + L::a1_bytes, w1, MID, s * kKC, 0, kKC, cin);
    };
    auto mma = [&](int s, int buf) {
      const uint32_t a = ring + buf * L::stage1;
      const uint32_t b = a + L::a1_bytes;
#pragma unroll
      for (int i = 0; i < kUnitsPerWG; ++i) fence_regs(acc1[i]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kKC / 16; ++kk) {
#pragma unroll
        for (int i = 0; i < kUnitsPerWG; ++i) {
          const int u = wg + i * kWarpgroups;
          if (u < kUnits) {
            const uint64_t da =
                make_desc(a + 2 * kk * (kM1 * 16) + (u >> 1) * 64 * 16, kM1 * 16, 128);
            const uint64_t db =
                make_desc(b + 2 * kk * (MID * 16) + (u & 1) * (kNH / 8) * 128, MID * 16, 128);
            Wgmma<kNH>::run(acc1[i], da, db, (s | kk) != 0);
          }
        }
      }
      wgmma_commit();
      wgmma_wait();
#pragma unroll
      for (int i = 0; i < kUnitsPerWG; ++i) fence_regs(acc1[i]);
    };
    ring_prologue(nsteps, load);
    ring_loop(nsteps, load, mma);
  }
  __syncthreads();   // the ring is free

  // ---- conv2: warpgroup `wg` computes output rows [64 wg, 64 wg + 64) ----
  constexpr int kStepsPerTap = MID / kK2;
  constexpr int kSteps2 = 9 * kStepsPerTap;
  float acc2[MID / 2];
  {
    auto load = [&](int s, int buf) {
      stage_weights<MID>(ring + buf * L::stage2, w2, MID, s * kK2, 0, kK2, 9 * MID);
    };
    ring_prologue(kSteps2, load);
    // conv1's epilogue: bias, relu, zero outside the image, round, into y1
#pragma unroll
    for (int i = 0; i < kUnitsPerWG; ++i) {
      const int u = wg + i * kWarpgroups;
      if (u >= kUnits) continue;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int pix = (u >> 1) * 64 + frow + hh * 8;
        const int gr = r0 - 1 + (pix >> 5), gc = c0 - 1 + (pix & 31);
        const bool inside = gr >= 0 && gr < h && gc >= 0 && gc < w;
#pragma unroll
        for (int j = 0; j < kNH / 8; ++j) {
          const int ch = (u & 1) * kNH + j * 8 + fcol;
          uint32_t v = 0u;
          if (inside) {
            v = pack_relu(acc1[i][j * 4 + hh * 2] + bias1[ch],
                          acc1[i][j * 4 + hh * 2 + 1] + bias1[ch + 1]);
          }
          *reinterpret_cast<uint32_t*>(smem + (ch >> 3) * (kY1Rows * 16) + pix * 16 + fcol * 2) = v;
        }
      }
    }
    auto mma = [&](int s, int buf) {
      const int tap = s / kStepsPerTap, part = s % kStepsPerTap;
      const int shift = (tap / 3) * kPitch + tap % 3;
      const uint32_t a = sbase + (part * (kK2 / 8)) * (kY1Rows * 16) + (wg * 64 + shift) * 16;
      const uint32_t b = ring + buf * L::stage2;
      fence_regs(acc2);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kK2 / 16; ++kk) {
        const uint64_t da = make_desc(a + 2 * kk * (kY1Rows * 16), kY1Rows * 16, 128);
        const uint64_t db = make_desc(b + 2 * kk * (MID * 16), MID * 16, 128);
        Wgmma<MID>::run(acc2, da, db, (s | kk) != 0);
      }
      wgmma_commit();
      wgmma_wait();
      fence_regs(acc2);
    };
    ring_loop(kSteps2, load, mma);
  }
  __syncthreads();   // y1 and the ring are free

  // ---- conv3 (+ projection) + residual + relu, a 64-column panel a time --
  {
    const int steps_per_panel = HAS_DS ? 1 + (cin + kKC - 1) / kKC : 1;
    const int nsteps = (cout / kPanel) * steps_per_panel;
    auto load = [&](int s, int buf) {
      const int p = s / steps_per_panel, j = s % steps_per_panel;
      const uint32_t dst = ring + buf * L::stage3;
      if (j == 0) {
        stage_weights<kPanel>(dst, w3, cout, 0, p * kPanel, MID, MID);
      } else {
        stage_pixels(dst, xb, kM2, r0, c0, h, w, cin, (j - 1) * kKC);
        stage_weights<kPanel>(dst + L::a3_bytes, wds, cout, (j - 1) * kKC, p * kPanel, kKC, cin);
      }
    };
    ring_prologue(nsteps, load);
    // conv2's epilogue: bias, relu, round, into y2 (over y1)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int m = wg * 64 + frow + hh * 8;
#pragma unroll
      for (int j = 0; j < MID / 8; ++j) {
        const int ch = j * 8 + fcol;
        *reinterpret_cast<uint32_t*>(smem + j * (kM2 * 16) + m * 16 + fcol * 2) =
            pack_relu(acc2[j * 4 + hh * 2] + bias2[ch], acc2[j * 4 + hh * 2 + 1] + bias2[ch + 1]);
      }
    }
    float acc3[kPanel / 2];
    unsigned char* stage_out = smem + L::out_stage + wg * (64 * kPanel * 2);
    auto mma = [&](int s, int buf) {
      const int p = s / steps_per_panel, j = s % steps_per_panel;
      const uint32_t src = ring + buf * L::stage3;
      // the identity residual of this thread's accumulator cells, asked for
      // before the products so that L2's latency hides behind them
      [[maybe_unused]] __nv_bfloat162 res[2][kPanel / 8];
      if constexpr (!HAS_DS) {
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int m = wg * 64 + frow + hh * 8;
          const int gr = r0 + (m >> 5), gc = c0 + (m & 31);
          const bool valid = (m & 31) < kTileW && gr < h && gc < w;
          const bf16* xrow = xb + ((size_t)gr * w + gc) * cin + p * kPanel + fcol;
#pragma unroll
          for (int g = 0; g < kPanel / 8; ++g) {
            res[hh][g] = valid ? *reinterpret_cast<const __nv_bfloat162*>(xrow + g * 8)
                               : __floats2bfloat162_rn(0.0f, 0.0f);
          }
        }
      }
      fence_regs(acc3);
      wgmma_fence();
      if (j == 0) {
        const uint32_t a = sbase + wg * 64 * 16;
#pragma unroll
        for (int kk = 0; kk < MID / 16; ++kk) {
          const uint64_t da = make_desc(a + 2 * kk * (kM2 * 16), kM2 * 16, 128);
          const uint64_t db = make_desc(src + 2 * kk * (kPanel * 16), kPanel * 16, 128);
          Wgmma<kPanel>::run(acc3, da, db, kk != 0);
        }
      } else {
        const uint32_t a = src + wg * 64 * 16;
        const uint32_t b = src + L::a3_bytes;
#pragma unroll
        for (int kk = 0; kk < kKC / 16; ++kk) {
          const uint64_t da = make_desc(a + 2 * kk * (kM2 * 16), kM2 * 16, 128);
          const uint64_t db = make_desc(b + 2 * kk * (kPanel * 16), kPanel * 16, 128);
          Wgmma<kPanel>::run(acc3, da, db, 1);
        }
      }
      wgmma_commit();
      wgmma_wait();
      fence_regs(acc3);
      if (j != steps_per_panel - 1) return;
      // the panel's epilogue: bias, residual, relu, round, into the
      // warpgroup's swizzled tile, then 16-byte stores
      named_barrier(1 + wg, 128);   // the tile's last readers are done
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int row = frow + hh * 8;
#pragma unroll
        for (int g = 0; g < kPanel / 8; ++g) {
          const int ch = p * kPanel + g * 8 + fcol;
          float v0 = acc3[g * 4 + hh * 2] + bias3[ch];
          float v1 = acc3[g * 4 + hh * 2 + 1] + bias3[ch + 1];
          if constexpr (!HAS_DS) {
            v0 += __low2float(res[hh][g]);
            v1 += __high2float(res[hh][g]);
          }
          *reinterpret_cast<uint32_t*>(stage_out + row * 128 + ((g ^ (row & 7)) << 4) + fcol * 2) =
              pack_relu(v0, v1);
        }
      }
      named_barrier(1 + wg, 128);
#pragma unroll
      for (int i = 0; i < (64 * kPanel / 8) / 128; ++i) {
        const int c = tw + i * 128;
        const int row = c >> 3, q = c & 7;
        const int m = wg * 64 + row;
        const int gr = r0 + (m >> 5), gc = c0 + (m & 31);
        if ((m & 31) < kTileW && gr < h && gc < w) {
          const uint4 v = *reinterpret_cast<const uint4*>(stage_out + row * 128 + ((q ^ (row & 7)) << 4));
          *reinterpret_cast<uint4*>(ob + ((size_t)gr * w + gc) * cout + p * kPanel + q * 8) = v;
        }
      }
    };
    ring_loop(nsteps, load, mma);
  }
}

template <int MID, bool HAS_DS>
cudaError_t launch(const bf16* x, int b, int h, int w, int cin, int cout, int smem_bytes,
                   const bf16* w1, const bf16* b1, const bf16* w2,
                   const bf16* b2, const bf16* w3, const bf16* b3,
                   const bf16* wds, const bf16* bds, bf16* out,
                   cudaStream_t stream) {
  auto kernel = fused_bottleneck_kernel<MID, HAS_DS>;
  const int bytes = Layout<MID>::bytes(cout);
  if (bytes != smem_bytes) return cudaErrorInvalidValue;   // the caller's plan is not this layout
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  dim3 grid((w + kTileW - 1) / kTileW, (h + kTileH - 1) / kTileH, b);
  kernel<<<grid, kThreads, bytes, stream>>>(x, h, w, cin, w1, b1, w2, b2, w3,
                                            b3, wds, bds, cout, out);
  return cudaGetLastError();
}

}  // namespace

// x (B, H, W, Cin) bf16; w1 (Cin, mid); w2 (9*mid, mid), rows ordered
// (dr, dc, in); w3 (mid, Cout); optional wds (Cin, Cout); biases (mid,) or
// (Cout,); all bf16 with frozen BN folded in.  out (B, H, W, Cout) bf16.
// smem_bytes: the dynamic shared memory of the caller's plan, which must be
// this file's layout.
extern "C" int frcnn_fused_bottleneck(const void* x, int b, int h, int w,
                                      int cin, int mid, int cout, int smem_bytes,
                                      const void* w1, const void* b1,
                                      const void* w2, const void* b2,
                                      const void* w3, const void* b3,
                                      const void* wds, const void* bds,
                                      void* out, cudaStream_t stream) {
  if (b <= 0 || h <= 0 || w <= 0) return 0;
  const bool has_ds = wds != nullptr;
  if (cin % 16 != 0 || cout % kPanel != 0 || (!has_ds && cin != cout) ||
      b > 65535 || (h + kTileH - 1) / kTileH > 65535) {
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
    err = has_ds ? launch<64, true>(xx, b, h, w, cin, cout, smem_bytes, args[0], args[1], args[2],
                                    args[3], args[4], args[5], args[6], args[7], o, stream)
                 : launch<64, false>(xx, b, h, w, cin, cout, smem_bytes, args[0], args[1], args[2],
                                     args[3], args[4], args[5], args[6], args[7], o, stream);
  } else if (mid == 128) {
    err = has_ds ? launch<128, true>(xx, b, h, w, cin, cout, smem_bytes, args[0], args[1], args[2],
                                     args[3], args[4], args[5], args[6], args[7], o, stream)
                 : launch<128, false>(xx, b, h, w, cin, cout, smem_bytes, args[0], args[1], args[2],
                                      args[3], args[4], args[5], args[6], args[7], o, stream);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
