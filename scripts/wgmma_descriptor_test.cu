// Card test of the wgmma shared-memory descriptor conventions that
// frcnn_tpu_torch/csrc/fused_block.cu relies on (sm_90a):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \
//        -o wgmma_descriptor_test scripts/wgmma_descriptor_test.cu && ./wgmma_descriptor_test
// D (64 x 64) = A (64 x 32) B (32 x 64), bf16 in, f32 out, against a host
// product.  No swizzle.  A is K-major, stored [k / 8][row][8], with the
// tile starting at row offsets 0, 3, 6 and 9 of an 80-row buffer (a start
// that is no multiple of the 8-row core matrix): leading byte offset = one
// k group (80 * 16), stride byte offset = 128.  B is MN-major (transpose
// flag), stored [k / 8][n / 8][k % 8][8]: leading byte offset = one k group
// (64 * 16), stride byte offset = 128.  Exits non-zero unless every product
// is exact (the inputs are small multiples of 1/8 and 1/4).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>

typedef __nv_bfloat16 bf16;

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

__device__ __forceinline__ uint64_t make_desc(const void* p, int lbo, int sbo) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  return (uint64_t)((a & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32);
}

constexpr int M = 64, N = 64, K = 32, ROWS = 80;

__global__ void test_kernel(const bf16* A, const bf16* B, float* D, int a_off) {
  __shared__ __align__(128) bf16 sa[K / 8 * ROWS * 8];
  __shared__ __align__(128) bf16 sb[K * N];
  const int t = threadIdx.x;
  for (int i = t; i < K / 8 * ROWS * 8; i += 128) sa[i] = __float2bfloat16(0.f);
  __syncthreads();
  for (int i = t; i < M * K; i += 128) {
    const int r = i / K, k = i % K;
    sa[(k / 8) * ROWS * 8 + (r + a_off) * 8 + k % 8] = A[i];
  }
  for (int i = t; i < K * N; i += 128) {
    const int k = i / N, n = i % N;
    sb[(k / 8) * (N * 8) + (n / 8) * 64 + (k % 8) * 8 + n % 8] = B[i];
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  float d[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) d[i] = 0.f;
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk) {
    const uint64_t da = make_desc(sa + (2 * kk) * ROWS * 8 + a_off * 8, ROWS * 16, 128);
    const uint64_t db = make_desc(sb + (2 * kk) * N * 8, N * 16, 128);
    wgmma_n64(d, da, db, kk > 0);
  }
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  // the accumulator fragment: warp w owns rows 16 w .. 16 w + 15
  const int w = t / 32, l = t % 32;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int col = j * 8 + (l % 4) * 2;
    const int row = w * 16 + l / 4;
    D[row * N + col] = d[j * 4 + 0];
    D[row * N + col + 1] = d[j * 4 + 1];
    D[(row + 8) * N + col] = d[j * 4 + 2];
    D[(row + 8) * N + col + 1] = d[j * 4 + 3];
  }
}

int main() {
  bf16* hA = (bf16*)malloc(M * K * 2);
  bf16* hB = (bf16*)malloc(K * N * 2);
  float* fa = (float*)malloc(M * K * 4);
  float* fb = (float*)malloc(K * N * 4);
  float* hD = (float*)malloc(M * N * 4);
  srand(1);
  for (int i = 0; i < M * K; ++i) {
    hA[i] = __float2bfloat16((rand() % 17 - 8) / 8.f);
    fa[i] = __bfloat162float(hA[i]);
  }
  for (int i = 0; i < K * N; ++i) {
    hB[i] = __float2bfloat16((rand() % 13 - 6) / 4.f);
    fb[i] = __bfloat162float(hB[i]);
  }
  bf16 *dA, *dB;
  float* dD;
  cudaMalloc(&dA, M * K * 2);
  cudaMalloc(&dB, K * N * 2);
  cudaMalloc(&dD, M * N * 4);
  cudaMemcpy(dA, hA, M * K * 2, cudaMemcpyHostToDevice);
  cudaMemcpy(dB, hB, K * N * 2, cudaMemcpyHostToDevice);
  int bad = 0;
  for (int off = 0; off < 12; off += 3) {
    cudaMemset(dD, 0, M * N * 4);
    test_kernel<<<1, 128>>>(dA, dB, dD, off);
    const cudaError_t e = cudaDeviceSynchronize();
    cudaMemcpy(hD, dD, M * N * 4, cudaMemcpyDeviceToHost);
    double worst = 0;
    for (int r = 0; r < M; ++r) {
      for (int c = 0; c < N; ++c) {
        double ref = 0;
        for (int k = 0; k < K; ++k) ref += fa[r * K + k] * fb[k * N + c];
        worst = fmax(worst, fabs(ref - hD[r * N + c]));
      }
    }
    printf("A at row offset %d: %s, max abs diff %g\n", off, cudaGetErrorString(e), worst);
    bad += e != cudaSuccess || worst != 0;
  }
  return bad != 0;
}
