// K1: batched exact greedy NMS for Hopper (sm_90a).
//
// Replaces the TPU kernel frcnn_tpu/ops/pallas/nms_kernel.py
// (_nms_kernel_b via nms_mask_pallas_batched).  Same contract: B independent
// problems, boxes sorted by descending score, a valid mask (invalid boxes are
// never kept and never suppress), an optional cap: the first max_keep kept
// boxes of a problem are exact, keep bits after the cap are zero.
//
// Design: ONE launch, a thread-block cluster a problem, the walk in chunks
// of 64 candidates, "pull" form: no pair is compared that the capped walk
// does not need, and no IoU bit ever reaches device memory.
//   * The kept list (box and area of every box kept so far, at most
//     min(max_keep, N)) lives in shared memory, dealt round-robin over the
//     cluster's blocks: kept box g sits in block g % R, slot g / R.
//   * A step takes the next 64 candidates (loaded a step ahead).  Every block
//     tests them against ITS part of the kept list (a warp holds 32
//     candidates in registers and reads one kept box at a time as a
//     shared-memory broadcast; the warps split the list), and ballots give
//     the block one 64-bit "suppressed" word.
//   * One cluster barrier a step, split in two: each block writes its word
//     into every block's shared memory (distributed shared memory, two
//     buffers taken in turn) and arrives; while the barrier completes it
//     builds the chunk's own 64 x 64 triangle (word j holds bit i when i < j
//     and IoU(i, j) > thresh; the threads of a column OR their rows' bits by
//     warp shuffles, no atomics); then it waits and ORs the R words.
//   * The chunk's greedy order is resolved by one warp with bit operations
//     on registers: K <- alive & ~(exists i in K: triangle[j] bit i), repeated
//     until K stops changing.  Position j depends only on positions below it,
//     so the fixed point is unique and is the greedy answer; it is reached in
//     as many rounds as the longest suppression chain, a handful.  Every
//     block resolves the same words and so agrees without a second barrier.
//     The cap cuts K after the (max_keep - kept)-th set bit.
//   * The chunk's kept boxes are appended to the list; the walk ends at the
//     cap or at N, and the rest of the keep mask is zeroed.  A chunk with no
//     valid box costs no barrier.
// What bounds it on the H100: operations, and only those the data asks for:
// a candidate at position j meets the boxes kept before it, so the work is
// sum over walked chunks of 64 x kept-so-far, at most N x cap (about 45
// machine operations a pair: on one block a long list makes the step
// throughput-bound, hence the cluster).  What is left besides is latency: four block barriers
// and one cluster barrier a step, 3.2-3.4 us a step on a cluster of 8 blocks
// of 1024 threads (NVIDIA H100 80GB HBM3 at 700 W), so a walk that never
// reaches its cap costs 188 such steps at N = 12000.  nms_plan (ops/cuda/nms_kernel.py) picks cluster size, threads
// and list slots from (B, N, cap).
//
// IoU is the division form of bbox_overlaps (frcnn_tpu/ops/boxes.py):
// inter / (area_a + area_b - inter) > thresh, zero when inter == 0, in the
// same operation order.  The _rn intrinsics stop nvcc from contracting a
// multiply and an add into an FMA, so the keep masks are bit-equal to the
// plain version's.  The quotient is only taken when inter lies within 1e-6
// (relative) of thresh * union: outside that band the comparison is decided
// without it, to the same result (see iou_above).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kChunk = 64;
constexpr int kMaxCluster = 16;
constexpr int kMaxThreads = 1024;
constexpr int kSlotBytes = 20;            // a kept box (float4) and its area
constexpr int kMaxListBytes = 200 * 1024; // of the 232,448 bytes a block may take
constexpr unsigned kFull = 0xffffffffu;
typedef unsigned long long u64;

__device__ __forceinline__ float box_area(const float4& b) {
  return __fmul_rn(__fadd_rn(__fsub_rn(b.z, b.x), 1.0f),
                   __fadd_rn(__fsub_rn(b.w, b.y), 1.0f));
}

// rn(inter / uni) > thresh, exactly.  With q = inter / uni as a real number:
// q > next_float_above(thresh) gives rn(q) > thresh and q < thresh gives
// rn(q) <= thresh, because rounding is monotonic.  p = rn(thresh * uni) is
// within 2^-24 of thresh * uni and next_float_above(thresh) <= thresh *
// (1 + 2^-22), so inter > p * 1.000001 implies the first and inter < p *
// 0.999999 the second; only in between is the division made.
__device__ __forceinline__ bool iou_above(const float4& a, float area_a,
                                          const float4& b, float area_b,
                                          float thresh) {
  const float iw = __fadd_rn(__fsub_rn(fminf(a.z, b.z), fmaxf(a.x, b.x)), 1.0f);
  const float ih = __fadd_rn(__fsub_rn(fminf(a.w, b.w), fmaxf(a.y, b.y)), 1.0f);
  const float inter = __fmul_rn(fmaxf(iw, 0.0f), fmaxf(ih, 0.0f));
  const float uni = __fsub_rn(__fadd_rn(area_a, area_b), inter);
  const float p = __fmul_rn(thresh, uni);
  const bool overlap = inter > 0.0f;
  const bool sure = thresh >= 1e-6f && p > 1e-30f;   // normal numbers, uni > 0
  const bool above = inter > __fmul_rn(p, 1.000001f);
  const bool below = inter < __fmul_rn(p, 0.999999f);
  if (overlap && !(sure && (above || below))) {       // rare: the band around the threshold
    return __fdiv_rn(inter, uni) > thresh;
  }
  // straight-line code, so that the callers' loops overlap their iterations
  return overlap ? above : 0.0f > thresh;
}

__global__ void __launch_bounds__(kMaxThreads)
nms_chunk_kernel(const float* __restrict__ boxes, const uint8_t* __restrict__ valid,
                 int n, float thresh, int max_keep, int slots,
                 uint8_t* __restrict__ keep) {
  extern __shared__ __align__(16) unsigned char list_raw[];
  float4* kbox = reinterpret_cast<float4*>(list_raw);      // [slots]
  float* karea = reinterpret_cast<float*>(kbox + slots);   // [slots]
  __shared__ float4 cbox[kChunk];        // the step's candidates
  __shared__ float carea[kChunk];
  __shared__ u64 tri[kChunk];            // bit i of tri[j]: i < j and IoU(i, j) > thresh
  __shared__ unsigned valid_half[2];     // valid bits of candidates 0-31, 32-63
  __shared__ unsigned sup_half[2];       // candidates suppressed by this block's kept boxes
  __shared__ u64 exch[2][kMaxCluster];   // the blocks' words of a step; written by the cluster
  __shared__ u64 s_keep;

  cg::cluster_group cluster = cg::this_cluster();
  const int nranks = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int prob = blockIdx.x / nranks;
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int half = warp & 1;                      // which 32 candidates this warp holds
  const int slice = warp >> 1;                    // its share of the kept list
  const int slices = static_cast<int>(blockDim.x) >> 6;
  const int parts = slices;                       // threads that share a triangle column (a power of two)
  const int parts_shift = __ffs(parts) - 1;
  const int rank_shift = __ffs(nranks) - 1;       // nranks is a power of two

  const float4* bx = reinterpret_cast<const float4*>(boxes) + (size_t)prob * n;
  const uint8_t* vd = valid + (size_t)prob * n;
  uint8_t* kp = keep + (size_t)prob * n;

  // every block of the cluster runs before any writes into its shared memory
  if (nranks > 1) cluster.sync();

  int kept = 0;      // boxes kept so far, the same number in every block
  int n_local = 0;   // of those, the ones in this block's list
  int step = 0;      // steps that went through the exchange
  // thread t < 64 holds candidate t of the coming step, loaded a step ahead
  // (the valid byte is kept as loaded: testing it here would wait for it)
  float4 next_box = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  uint8_t next_valid = 0;
  if (t < kChunk && t < n) {
    next_box = bx[t];
    next_valid = vd[t];
  }
  int j0 = 0;
  for (; j0 < n && kept < max_keep; j0 += kChunk) {
    if (t < kChunk) {
      cbox[t] = next_box;
      carea[t] = box_area(next_box);
      const unsigned m = __ballot_sync(kFull, next_valid != 0);
      if (lane == 0) {
        valid_half[warp] = m;
        sup_half[warp] = 0u;
      }
      const int j = j0 + kChunk + t;
      next_valid = 0;
      next_box = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (j < n) {
        next_valid = vd[j];
        next_box = bx[j];
      }
    }
    __syncthreads();
    const u64 vword = (u64)valid_half[0] | ((u64)valid_half[1] << 32);
    if (vword == 0ULL) {   // nothing to keep: no exchange (every block sees the same bits)
      if (rank == 0 && t < kChunk && j0 + t < n) kp[j0 + t] = 0;
      __syncthreads();     // valid_half is rewritten by the next step
      continue;
    }

    // pull: this warp's 32 candidates against this warp's share of the list
    if (valid_half[half] != 0u) {
      const float4 c = cbox[half * 32 + lane];
      const float ca = carea[half * 32 + lane];
      int sup = 0;
#pragma unroll 4
      for (int k = slice; k < n_local; k += slices) {
        sup |= iou_above(kbox[k], karea[k], c, ca, thresh);
      }
      const unsigned m = __ballot_sync(kFull, sup != 0);
      if (lane == 0 && m != 0u) atomicOr(&sup_half[half], m);
    }
    __syncthreads();
    // the block's word goes to every block of the cluster; the barrier's
    // latency is spent on the triangle, which needs nothing from the others
    const int par = step & 1;
    ++step;
    if (nranks > 1) {
      if (t < nranks) {
        const u64 mine = (u64)sup_half[0] | ((u64)sup_half[1] << 32);
        *cluster.map_shared_rank(&exch[par][rank], t) = mine;
      }
      cluster.barrier_arrive();
    }
    // the chunk's own triangle: the `parts` adjacent lanes of column j take
    // rows part, part + parts, ... below j and OR their bits by shuffles
    {
      const int part = t & (parts - 1);
      const int j = t >> parts_shift;
      const float4 c = cbox[j];
      const float ca = carea[j];
      u64 bits = 0ULL;
#pragma unroll 4
      for (int i = part; i < j; i += parts) {
        bits |= (u64)iou_above(cbox[i], carea[i], c, ca, thresh) << i;
      }
      for (int o = parts >> 1; o > 0; o >>= 1) bits |= __shfl_xor_sync(kFull, bits, o);
      if (part == 0) tri[j] = bits;
    }
    __syncthreads();
    if (nranks > 1) cluster.barrier_wait();

    if (warp == 0) {
      u64 sup = (u64)sup_half[0] | ((u64)sup_half[1] << 32);
      for (int r = 0; r < nranks && nranks > 1; ++r) sup |= exch[par][r];
      const u64 alive = vword & ~sup;
      const u64 c0 = tri[lane], c1 = tri[lane + 32];
      const bool a0 = (alive >> lane) & 1ULL, a1 = (alive >> (lane + 32)) & 1ULL;
      u64 k = alive;
      for (;;) {
        const unsigned lo = __ballot_sync(kFull, a0 && (c0 & k) == 0ULL);
        const unsigned hi = __ballot_sync(kFull, a1 && (c1 & k) == 0ULL);
        const u64 next = (u64)lo | ((u64)hi << 32);
        if (next == k) break;
        k = next;
      }
      const int room = max_keep - kept;
      if (__popcll(k) > room) {   // the cap falls inside this chunk
        const u64 below0 = (1ULL << lane) - 1ULL, below1 = (1ULL << (lane + 32)) - 1ULL;
        const unsigned lo = __ballot_sync(kFull, ((k >> lane) & 1ULL) &&
                                                     __popcll(k & below0) < room);
        const unsigned hi = __ballot_sync(kFull, ((k >> (lane + 32)) & 1ULL) &&
                                                     __popcll(k & below1) < room);
        k = (u64)lo | ((u64)hi << 32);
      }
      if (lane == 0) s_keep = k;
    }
    __syncthreads();

    const u64 k = s_keep;
    if (t < kChunk) {
      const bool mine = (k >> t) & 1ULL;
      if (rank == 0 && j0 + t < n) kp[j0 + t] = mine;
      if (mine) {
        const int g = kept + __popcll(k & ((1ULL << t) - 1ULL));
        if ((g & (nranks - 1)) == rank) {
          kbox[g >> rank_shift] = cbox[t];
          karea[g >> rank_shift] = carea[t];
        }
      }
    }
    kept += __popcll(k);
    n_local = (kept + nranks - 1 - rank) >> rank_shift;
    // cbox[t] is rewritten by thread t itself; the list is read after the
    // next step's first barrier
  }
  // past the cap, or past N: nothing more is kept
  for (int j = j0 + rank * (int)blockDim.x + t; j < n; j += nranks * (int)blockDim.x) kp[j] = 0;
}

}  // namespace

extern "C" const char* frcnn_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// boxes (B, N, 4) f32 (16-byte aligned), valid (B, N) u8, keep (B, N) u8: all
// device pointers; launches on `stream`.  A cluster of `cluster` blocks of
// `threads` threads takes each problem; each block's kept list has `slots`
// entries, so cluster * slots must hold min(max_keep, N) boxes.
extern "C" int frcnn_nms_batched(const float* boxes, const uint8_t* valid,
                                 int b, int n, float thresh, int max_keep,
                                 int cluster, int threads, int slots,
                                 uint8_t* keep, cudaStream_t stream) {
  if (b <= 0 || n <= 0) return 0;
  const long long need = max_keep < n ? (max_keep > 0 ? max_keep : 0) : n;
  const size_t bytes = (size_t)(slots > 0 ? slots : 0) * kSlotBytes;
  if (cluster < 1 || cluster > kMaxCluster || (cluster & (cluster - 1)) != 0 ||
      threads < kChunk || threads > kMaxThreads || (threads & (threads - 1)) != 0 || slots < 1 ||
      (long long)slots * cluster < need || bytes > (size_t)kMaxListBytes ||
      (long long)b * cluster > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSuccess;
  if (bytes > 48 * 1024) {
    err = cudaFuncSetAttribute(nms_chunk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)bytes);
  }
  if (err == cudaSuccess && cluster > 8) {
    err = cudaFuncSetAttribute(nms_chunk_kernel,
                               cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3((unsigned)(b * cluster), 1, 1);
  config.blockDim = dim3((unsigned)threads, 1, 1);
  config.dynamicSmemBytes = bytes;
  config.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  config.attrs = attr;
  config.numAttrs = 1;
  err = cudaLaunchKernelEx(&config, nms_chunk_kernel, boxes, valid, n, thresh, max_keep, slots,
                           keep);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
