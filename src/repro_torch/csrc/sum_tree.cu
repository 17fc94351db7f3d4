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
// is the sum of the block sums, not the tree's root.  Priorities are >= 0.
//
// What bounds it on an H100, and what the design does about it:
//   * Not bytes: each sample reads one row of bs leaves and the block sums
//     are read once -- at the rainbow example's shape (8192 leaves, 16
//     blocks, batch 64) 31 552 B, 9.4 ns at 3.35 TB/s; at 2^17 leaves x 256
//     samples 0.48 MB, 0.14 us.  The time is latency: the launch, and in
//     each block a chain of dependent steps -- load the block sums, scan
//     them, search them, load the row the search picks (a second round trip
//     to memory that cannot start sooner), scan it, count.  The TPU kernel
//     holds the whole table in VMEM and resolves a tile of samples with dense
//     cumsum / compare passes; here the work is to shorten that chain and to
//     spread the samples over the SMs.
//   * One sample a warp, four warps (128 threads) a block: batch 64 is 16
//     blocks, 256 is 64.  Each warp loads its u first, so that round trip
//     overlaps the block sums'.
//   * The block sums: each thread scans a contiguous run of
//     ceil(n_blocks / 128) of them straight from memory into shared memory
//     (one pad word every 32, so runs of a power-of-two length do not
//     collide in the banks); a warp scan of the run totals and one exchange
//     of the four warp totals give each run its offset, and a max-scan the
//     same way makes the scan monotone across runs (exact: f32 max does not
//     round; within a run offset + prefix is monotone already).  Three
//     barriers in all.  A binary search over the monotone scan finds blk
//     with the TPU kernel's <= and clamp.
//   * One warp scan a row: lane l owns ceil(bs / 32) consecutive leaves --
//     4 ceil(bs / 128), loaded as 16-byte vectors, where the row is 16-byte
//     aligned and bs % 4 == 0; scalars otherwise, decided per row in the
//     kernel -- and takes their prefix sums in registers; one warp scan of
//     the 32 lane totals gives each lane its carry; each lane counts its
//     prefix sums <= off and __reduce_add_sync sums the counts.  A scan of
//     the row 32 leaves at a time would take up to 16 dependent rounds of
//     shuffles; this takes one.
//   * Rounding: the prefix sums are taken in another order than XLA's
//     cumsum (carry + the lane's own prefix), so a u within a few ulps of a
//     boundary may pick the neighbouring leaf; on integer priorities (every
//     partial sum exact) the result is exact.  kernels/sum_tree/ref.py's
//     agreement holds both rules.
//
// Limits: bs <= 512 (16 leaves a lane), n_blocks <= 8192 (33 KB of shared
// memory with the padding).  The wrapper checks them, and the C function
// returns cudaErrorInvalidValue for anything else.
//
// C interface: sum_tree_sample returns the cudaError_t (0 on success) taken
// with cudaGetLastError() right after the launch; the Python wrapper raises
// on anything else.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;  // one sample a warp
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxLeavesPerLane = 16;
constexpr int kMaxBlockSize = 32 * kMaxLeavesPerLane;
constexpr int kMaxBlocks = 8192;
constexpr unsigned kFull = 0xffffffffu;

// shared-memory slot of the scan's entry i: one pad word every 32
__host__ __device__ __forceinline__ int slot(int i) { return i + (i >> 5); }

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

// Exclusive scan of one value per thread over the block (sum, or max with
// identity -inf).  wtot holds kWarps floats and must not be shared with
// another call: one barrier.  Every thread must call.
template <bool kMax>
__device__ __forceinline__ float block_exclusive(float v, float* wtot, int lane, int warp) {
  const float ident = kMax ? -INFINITY : 0.0f;
  const float inc = kMax ? warp_inclusive_max(v, lane) : warp_inclusive_add(v, lane);
  float excl = __shfl_up_sync(kFull, inc, 1);
  if (lane == 0) excl = ident;
  if (lane == 31) wtot[warp] = inc;
  __syncthreads();
  float before = ident;
  for (int w = 0; w < warp; ++w) before = kMax ? fmaxf(before, wtot[w]) : before + wtot[w];
  return kMax ? fmaxf(before, excl) : before + excl;
}

__global__ void __launch_bounds__(kThreads)
sum_tree_sample_kernel(const float* __restrict__ leaves, const float* __restrict__ bsums,
                       const float* __restrict__ u, int* __restrict__ idx_out,
                       float* __restrict__ prob_out, int n_blocks, int bs, int batch) {
  extern __shared__ float cum[];  // slot(n_blocks) floats
  __shared__ float wsum[kWarps], wmax[kWarps];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int s = blockIdx.x * kWarps + warp;  // this warp's sample
  const float us = s < batch ? __ldg(u + s) : 0.0f;

  // --- 1. inclusive scan of the block sums into shared memory -------------
  const int per = (n_blocks + kThreads - 1) / kThreads;
  const int lo = min(tid * per, n_blocks), hi = min(lo + per, n_blocks);
  float run = 0.0f;
#pragma unroll 16  // 16 loads in flight: one round trip at 2048 blocks
  for (int i = lo; i < hi; ++i) {
    run += __ldg(bsums + i);
    cum[slot(i)] = run;
  }
  const float offset = block_exclusive<false>(run, wsum, lane, warp);
  // the largest entry of this run is its last, offset + run
  const float before = block_exclusive<true>(hi > lo ? offset + run : -INFINITY, wmax, lane, warp);
  for (int i = lo; i < hi; ++i) cum[slot(i)] = fmaxf(offset + cum[slot(i)], before);
  __syncthreads();
  if (s >= batch) return;  // uniform across the warp, after the last barrier
  const float total = cum[slot(n_blocks - 1)];

  // --- 2. blk = #{cum <= u} by binary search over the monotone cum --------
  int a = 0, b = n_blocks;
  while (a < b) {
    const int mid = (a + b) >> 1;
    if (cum[slot(mid)] <= us) a = mid + 1;
    else b = mid;
  }
  const int blk = min(a, n_blocks - 1);
  const float off = us - (blk > 0 ? cum[slot(blk - 1)] : 0.0f);

  // --- 3. one warp scan of the row: lane-owned runs of leaves -------------
  const float* row = leaves + static_cast<int64_t>(blk) * bs;
  const bool vec = (bs & 3) == 0 && (reinterpret_cast<uintptr_t>(row) & 15) == 0;
  const int per_lane = vec ? 4 * ((bs + 127) >> 7) : (bs + 31) >> 5;
  const int first = lane * per_lane;
  const int n_own = max(0, min(per_lane, bs - first));  // a multiple of 4 if vec
  float x[kMaxLeavesPerLane];
  if (vec) {
    const float4* row4 = reinterpret_cast<const float4*>(row + first);
#pragma unroll
    for (int j = 0; j < kMaxLeavesPerLane / 4; ++j) {
      const float4 v = 4 * j < n_own ? __ldg(row4 + j) : make_float4(0.f, 0.f, 0.f, 0.f);
      x[4 * j] = v.x;
      x[4 * j + 1] = v.y;
      x[4 * j + 2] = v.z;
      x[4 * j + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < kMaxLeavesPerLane; ++i) x[i] = i < n_own ? __ldg(row + first + i) : 0.0f;
  }
#pragma unroll
  for (int i = 1; i < kMaxLeavesPerLane; ++i) x[i] += x[i - 1];  // the lane's own prefix sums
  const float inc = warp_inclusive_add(x[kMaxLeavesPerLane - 1], lane);
  float carry = __shfl_up_sync(kFull, inc, 1);
  if (lane == 0) carry = 0.0f;
  int cnt = 0;
#pragma unroll
  for (int i = 0; i < kMaxLeavesPerLane; ++i) cnt += (i < n_own && carry + x[i] <= off) ? 1 : 0;
  cnt = __reduce_add_sync(kFull, cnt);
  if (lane == 0) {
    const int inner = min(cnt, bs - 1);
    idx_out[s] = blk * bs + inner;
    prob_out[s] = __ldg(row + inner) / fmaxf(total, 1e-12f);
  }
}

}  // namespace

extern "C" {

// leaves (n_blocks, bs) f32, bsums (n_blocks,) f32, u (batch,) f32, all
// contiguous on one device; idx (batch,) int32 and prob (batch,) f32 are
// written.  Launched on `stream`; no allocation, no synchronisation.
int sum_tree_sample(const void* leaves, const void* bsums, const void* u, void* idx,
                    void* prob, int n_blocks, int bs, int batch, void* stream) {
  if (n_blocks < 1 || n_blocks > kMaxBlocks || bs < 1 || bs > kMaxBlockSize || batch < 0)
    return cudaErrorInvalidValue;
  if (batch == 0) return cudaSuccess;
  const int grid = (batch + kWarps - 1) / kWarps;
  const size_t smem = static_cast<size_t>(slot(n_blocks)) * sizeof(float);
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
