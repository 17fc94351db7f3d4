// Hand-written Hopper (sm_90a) stratified proportional sampling over
// blocked priorities -- prioritized replay's sample.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/sum_tree/sum_tree.py::sample_pallas (body _sample_kernel)
// behind ops.tree_sample_blocked (every prioritized sample of
// replay/device.py::tree_sample, which reads the block sums in place from the
// sum tree's level [n_blocks, 2 n_blocks) and the leaves from tree[size:])
// and ops.sample_proportional.
//
// Semantics (identical to _sample_kernel), for leaves (n_blocks, bs), block
// sums (n_blocks,) and each position u:
//   cum   = inclusive cumsum of the block sums,  total = cum[n_blocks - 1]
//   blk   = min(#{cum <= u}, n_blocks - 1)
//   off   = u - (blk > 0 ? cum[blk - 1] : 0)
//   inner = min(#{cumsum(leaves[blk]) <= off}, bs - 1)
//   idx   = blk * bs + inner,  prob = leaves[blk, inner] / max(total, 1e-12)
// i.e. the smallest i with cumsum(p)[i] > u, clamped at both levels.  total
// is the sum of the block sums, not the tree's root.
//
// What bounds it on an H100, and what the design does about it:
//   * Bytes: each sample reads one row of bs leaves, and the block sums are
//     read once: at 2^17 leaves x 256 samples (bs 512, 256 blocks) about
//     528 KB, 0.16 us at 3.35 TB/s; at the rainbow example's shape (8192
//     leaves, 16 blocks, batch 64) 0.04 us.  The floor that matters is the
//     launch latency, a few microseconds, so the design is one launch per
//     sample call that allocates nothing, not a fast memory pipeline.
//   * The TPU kernel holds the whole table in VMEM and resolves a tile of
//     samples with dense cumsum/compare passes.  Here each block of 256
//     threads scans the block sums once into shared memory (an inclusive
//     scan: one sequential run per thread, then a scan of the runs across
//     warps), makes the scan monotone with a max-scan (exact: f32 max does
//     not round), and each warp then resolves its samples:
//       - a binary search over the monotone cum finds blk with the Pallas
//         kernel's <= and clamp;
//       - the warp scans the leaf row in rounds of 32 consecutive leaves
//         (coalesced loads, all issued before the scan), counts the prefix
//         sums <= off and clamps;
//       - lane 0 writes idx and prob.
//   * Rounding: the prefix sums are taken in another order than XLA's
//     cumsum, so a u within a few ulps of a boundary may pick the
//     neighbouring leaf; on integer priorities (every partial sum exact) the
//     result is exact.  chip_smoke.py holds both rules.
//
// Limits: bs <= 512 (16 leaves a lane), n_blocks <= 8192 (32 KB of shared
// memory).  The wrapper checks them, and the C function returns
// cudaErrorInvalidValue for anything else.
//
// C interface: sum_tree_sample returns the cudaError_t (0 on success) taken
// with cudaGetLastError() right after the launch; the Python wrapper raises
// on anything else.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSamplesPerWarp = 4;
constexpr int kSamplesPerBlock = kWarps * kSamplesPerWarp;
constexpr int kMaxRounds = 16;  // rounds of 32 leaves: bs <= 512
constexpr int kMaxBlocks = 8192;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float warp_inclusive_add(float v, int lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const float o = __shfl_up_sync(kFull, v, d);
    if (lane >= d) v += o;
  }
  return v;
}

__device__ __forceinline__ float warp_inclusive_max(float v, int lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const float o = __shfl_up_sync(kFull, v, d);
    if (lane >= d) v = fmaxf(v, o);
  }
  return v;
}

// Exclusive scan of one value per thread over the whole block (sum, or max
// with identity -inf).  wtot holds kWarps floats; every thread must call.
template <bool kMax>
__device__ float block_exclusive(float v, float* wtot) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const float ident = kMax ? -INFINITY : 0.0f;
  const float inc = kMax ? warp_inclusive_max(v, lane) : warp_inclusive_add(v, lane);
  float excl = __shfl_up_sync(kFull, inc, 1);
  if (lane == 0) excl = ident;
  if (lane == 31) wtot[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    const float w = lane < kWarps ? wtot[lane] : ident;
    const float wi = kMax ? warp_inclusive_max(w, lane) : warp_inclusive_add(w, lane);
    if (lane < kWarps) wtot[lane] = wi;
  }
  __syncthreads();
  const float before = warp > 0 ? wtot[warp - 1] : ident;
  __syncthreads();  // wtot is reused by the next call
  if (warp == 0) return excl;
  if (lane == 0) return before;
  return kMax ? fmaxf(before, excl) : before + excl;
}

__global__ void __launch_bounds__(kThreads)
sum_tree_sample_kernel(const float* __restrict__ leaves, const float* __restrict__ bsums,
                       const float* __restrict__ u, int* __restrict__ idx_out,
                       float* __restrict__ prob_out, int n_blocks, int bs, int batch) {
  extern __shared__ float cum[];  // n_blocks floats
  __shared__ float wtot[kWarps];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  // --- 1. inclusive scan of the block sums into shared memory -------------
  for (int i = tid; i < n_blocks; i += kThreads) cum[i] = bsums[i];
  __syncthreads();
  const int per = (n_blocks + kThreads - 1) / kThreads;
  const int lo = min(tid * per, n_blocks), hi = min(lo + per, n_blocks);
  float run = 0.0f;
  for (int i = lo; i < hi; ++i) {
    run += cum[i];
    cum[i] = run;
  }
  const float offset = block_exclusive<false>(run, wtot);
  // add the runs before this thread's, keeping a running max: the scan is
  // then monotone within the thread's run ...
  float mx = -INFINITY;
  for (int i = lo; i < hi; ++i) {
    mx = fmaxf(mx, offset + cum[i]);
    cum[i] = mx;
  }
  // ... and across runs, with the max of every earlier run (exact)
  const float before = block_exclusive<true>(mx, wtot);
  for (int i = lo; i < hi; ++i) cum[i] = fmaxf(cum[i], before);
  __syncthreads();
  const float total = cum[n_blocks - 1];

  // --- 2. each warp resolves its samples ----------------------------------
  const int rounds = (bs + 31) / 32;
  for (int k = 0; k < kSamplesPerWarp; ++k) {
    const int s = blockIdx.x * kSamplesPerBlock + k * kWarps + warp;
    if (s >= batch) break;  // uniform across the warp
    const float us = u[s];
    // blk = #{cum <= us} by binary search over the monotone cum
    int a = 0, b = n_blocks;
    while (a < b) {
      const int mid = (a + b) >> 1;
      if (cum[mid] <= us) a = mid + 1;
      else b = mid;
    }
    const int blk = min(a, n_blocks - 1);
    const float off = us - (blk > 0 ? cum[blk - 1] : 0.0f);

    const float* row = leaves + static_cast<int64_t>(blk) * bs;
    float x[kMaxRounds];
#pragma unroll
    for (int r = 0; r < kMaxRounds; ++r) {
      const int j = r * 32 + lane;
      x[r] = (r < rounds && j < bs) ? __ldg(row + j) : 0.0f;
    }
    float carry = 0.0f;
    int cnt = 0;
#pragma unroll
    for (int r = 0; r < kMaxRounds; ++r) {
      if (r < rounds) {  // uniform across the warp
        const float c = carry + warp_inclusive_add(x[r], lane);
        if (r * 32 + lane < bs && c <= off) ++cnt;
        carry = __shfl_sync(kFull, c, 31);
      }
    }
    cnt = __reduce_add_sync(kFull, cnt);
    if (lane == 0) {
      const int inner = min(cnt, bs - 1);
      idx_out[s] = blk * bs + inner;
      prob_out[s] = row[inner] / fmaxf(total, 1e-12f);
    }
  }
}

}  // namespace

extern "C" {

// leaves (n_blocks, bs) f32, bsums (n_blocks,) f32, u (batch,) f32, all
// contiguous on one device; idx (batch,) int32 and prob (batch,) f32 are
// written.  Launched on `stream`; no allocation, no synchronisation.
int sum_tree_sample(const void* leaves, const void* bsums, const void* u, void* idx,
                    void* prob, int n_blocks, int bs, int batch, void* stream) {
  if (n_blocks < 1 || n_blocks > kMaxBlocks || bs < 1 || bs > 32 * kMaxRounds || batch < 0)
    return cudaErrorInvalidValue;
  if (batch == 0) return cudaSuccess;
  const int grid = (batch + kSamplesPerBlock - 1) / kSamplesPerBlock;
  const size_t smem = static_cast<size_t>(n_blocks) * sizeof(float);
  sum_tree_sample_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(leaves), static_cast<const float*>(bsums),
      static_cast<const float*>(u), static_cast<int*>(idx), static_cast<float*>(prob),
      n_blocks, bs, batch);
  return cudaGetLastError();
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
