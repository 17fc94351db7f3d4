// Hand-written Hopper (sm_90a) Mamba-2 SSD chunked scan, forward.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/ssd_scan/ssd_scan.py::ssd_scan_pallas (body _ssd_kernel)
// behind ops.ssd_scan, the train forward of every mamba2 layer
// (models/layers.py::ssd_block_train).
//
// Semantics (identical to _ssd_kernel and models/layers.py::ssd_chunked), per
// batch row b, head h (group g = h / (H / G)) and chunk of Q rows:
//   dA_t   = dt_t * A_h;   cum = inclusive cumsum of dA over the chunk
//   L[q,k] = exp(cum_q - cum_k) for k <= q, else 0 (masked BEFORE the exp:
//            the masked differences are positive and would overflow)
//   M[q,k] = (C_q . B_k) * L[q,k] * dt_k
//   y_q    = sum_k M[q,k] x_k  +  (C_q . S_prev) * exp(cum_q)
//   S_new  = S_prev * exp(cum_last) + sum_k B_k (x_k * exp(cum_last - cum_k) * dt_k)
// S starts at 0; y is written in bf16, the final S in f32.  Rows past T act
// as dt = 0 rows (the JAX wrapper's padding): they add nothing to y or S and
// are never written.
//
// What bounds it on an H100, and what the design does about it:
//   * The work is four products per (batch, head, chunk) with a state carried
//     from chunk to chunk.  The TPU kernel carries S in VMEM scratch across a
//     sequential grid axis; Hopper blocks run in no order, so one block owns
//     one (batch, head) pair and loops over the chunks itself, with S (64 x
//     128 f32, 32 KB) resident in shared memory the whole time.  At the
//     mamba2-1.3b training shape (B 8, H 64) that is 512 blocks.
//   * C . B^T is shared by all heads of a group (all 64 heads at G = 1).  A
//     first small kernel (ssd_cb_kernel) computes it once per (batch, chunk,
//     group) into an f32 scratch of (B, nC, G, Q, Q) -- 4 MB at the training
//     shape, which stays in the 50 MB L2 -- and only for the tiles on or
//     below the diagonal.  The scan kernel reads it from there.
//   * The chunk's decay matrix L (256 x 256 f32 = 256 KB) does not fit in
//     shared memory, so M is built one 64 x 64 tile at a time from the chunk's
//     cumsum (256 floats), and the y_diag product visits only the tiles on or
//     below the diagonal.
//   * Precision: every product runs in f32 on the CUDA cores (each thread
//     keeps a 4 x 4 or 4 x 8 register tile; operands are staged in shared
//     memory as f32), so the kernel rounds where ssd_chunked rounds and
//     differs from it only in the order of f32 sums; y is rounded to bf16
//     once, at the end, as in ssd_chunked.  The work is thus bound by f32
//     FMA (67 TFLOP/s), not by bytes (about 87 MB at the training shape).
//     Tensor cores (mma.sync / wgmma on bf16 C, B, x with TF32 or split
//     operands for the f32 ones) are the next step for speed.
//
// Built instance: head dim P 64, state N 128, chunk Q 256 -- mamba2-1.3b.
// Any G dividing H works; T is any length (the last chunk is masked).
//
// C interface: ssd_scan_fwd returns a cudaError_t (0 on success) taken with
// cudaGetLastError() right after each launch; the Python wrapper raises on
// anything else.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kP = 64;           // head dim
constexpr int kN = 128;          // state dim
constexpr int kQ = 256;          // chunk length
constexpr int kThreads = 256;    // one thread per chunk row in the cumsum
constexpr int kTile = 64;        // q / k tile of the chunk
constexpr int kSlice = 32;       // n (or k) slice staged per step
constexpr int kSPad = kN + 1;    // row stride of S in shared memory (floats)
constexpr int kTiles = kQ / kTile;

static_assert(kThreads == kQ, "the cumsum gives each thread one chunk row");
static_assert(kThreads == 16 * 16 && kTile == 4 * 16 && kP == 4 * 16 && kN == 8 * 16,
              "register tiles: 16 x 16 threads, 4 rows and 4 or 8 columns each");

// Shared memory of the scan kernel, in floats.
constexpr int kWorkDiag = kTile * (kTile + 1) + kTile * kP;   // M tile + x tile
constexpr int kWorkOff = kTile * (kSlice + 1);                // C slice
constexpr int kWorkState = kSlice * kN + kSlice * kP;         // B*w slice + x slice
constexpr int kWork = kWorkDiag > kWorkState ? (kWorkDiag > kWorkOff ? kWorkDiag : kWorkOff)
                                             : (kWorkState > kWorkOff ? kWorkState : kWorkOff);
constexpr int kSmemFloats = kP * kSPad + 3 * kQ + 32 + kWork;

__device__ __forceinline__ float bf2f(bf16 v) { return __bfloat162float(v); }

// cb[(((b * nC + c) * G + g) * Q + q) * Q + k] = sum_n C[b, cQ+q, g, n] B[b, cQ+k, g, n]
// for every (q, k) in a 64 x 64 tile on or below the chunk's diagonal; rows
// past T read as 0.  Grid (kTiles * kTiles, nC * G, B).
__global__ void __launch_bounds__(kThreads)
ssd_cb_kernel(const bf16* __restrict__ Bm, const bf16* __restrict__ Cm,
              float* __restrict__ cb, int T, int G, int nC) {
  const int qt = blockIdx.x / kTiles, kt = blockIdx.x % kTiles;
  if (kt > qt) return;  // above the diagonal: never read
  const int c = blockIdx.y / G, g = blockIdx.y % G, b = blockIdx.z;
  __shared__ float c_s[kTile][kSlice + 1];
  __shared__ float b_s[kTile][kSlice + 1];
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int tq0 = c * kQ + qt * kTile, tk0 = c * kQ + kt * kTile;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int n0 = 0; n0 < kN; n0 += kSlice) {
    for (int e = tid; e < kTile * kSlice; e += kThreads) {
      const int r = e / kSlice, n = e % kSlice;
      const int tq = tq0 + r, tk = tk0 + r;
      c_s[r][n] = tq < T ? bf2f(Cm[(((long)b * T + tq) * G + g) * kN + n0 + n]) : 0.f;
      b_s[r][n] = tk < T ? bf2f(Bm[(((long)b * T + tk) * G + g) * kN + n0 + n]) : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int n = 0; n < kSlice; ++n) {
      float av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = c_s[ty + 16 * i][n];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = b_s[tx + 16 * j][n];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
  float* out = cb + ((long)(b * nC + c) * G + g) * kQ * kQ;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      out[(qt * kTile + ty + 16 * i) * kQ + kt * kTile + tx + 16 * j] = acc[i][j];
}

// One block per (head h, batch row b); loops over the chunks in order.
// Thread (ty, tx) = (tid / 16, tid % 16) owns rows ty + 16 i and columns
// tx + 16 j of every register tile.
__global__ void __launch_bounds__(kThreads)
ssd_scan_kernel(const bf16* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ A, const bf16* __restrict__ Bm,
                const bf16* __restrict__ Cm, const float* __restrict__ cb,
                bf16* __restrict__ y, float* __restrict__ state,
                int T, int H, int G, int nC) {
  extern __shared__ float smem[];
  float* s_s = smem;               // [kP][kSPad]  the carried state S
  float* cum_s = s_s + kP * kSPad; // [kQ]  cumsum of dt * A over the chunk
  float* dt_s = cum_s + kQ;        // [kQ]  dt (0 past T)
  float* w_s = dt_s + kQ;          // [kQ]  exp(cum_last - cum_k) * dt_k
  float* red_s = w_s + kQ;         // [32]  warp totals of the cumsum
  float* work = red_s + 32;        // per-phase staging (kWork floats)

  const int h = blockIdx.x, b = blockIdx.y;
  const int g = h / (H / G);
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int lane = tid % 32, warp = tid / 32;
  const float a_h = A[h];

  for (int e = tid; e < kP * kSPad; e += kThreads) s_s[e] = 0.f;

  for (int c = 0; c < nC; ++c) {
    const int t0 = c * kQ;
    const int tc = min(kQ, T - t0);  // rows of this chunk inside T
    const float* cbc = cb + ((long)(b * nC + c) * G + g) * kQ * kQ;

    // 1. dt and the inclusive cumsum of dt * A (thread tid holds row tid)
    const float d = tid < tc ? dt[((long)b * T + t0 + tid) * H + h] : 0.f;
    float v = d * a_h;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float o = __shfl_up_sync(0xffffffffu, v, off);
      if (lane >= off) v += o;
    }
    if (lane == 31) red_s[warp] = v;
    __syncthreads();  // red_s ready; also orders the zeroing of s_s
    for (int w = 0; w < warp; ++w) v += red_s[w];
    cum_s[tid] = v;
    dt_s[tid] = d;
    __syncthreads();
    const float cum_last = cum_s[kQ - 1];
    w_s[tid] = expf(cum_last - cum_s[tid]) * dt_s[tid];
    // (w_s is read after the syncs of phase 2, or of phase 3's first slice)

    // 2. y, one 64-row tile of the chunk at a time
    const int n_qt = (tc + kTile - 1) / kTile;
    for (int qt = 0; qt < n_qt; ++qt) {
      const int q0 = qt * kTile;

      // 2a. y_off = (C_q . S_prev) * exp(cum_q), over slices of n
      float yo[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) yo[i][j] = 0.f;
      float* c_s = work;  // [kTile][kSlice + 1]
      for (int n0 = 0; n0 < kN; n0 += kSlice) {
        for (int e = tid; e < kTile * kSlice; e += kThreads) {
          const int r = e / kSlice, n = e % kSlice, t = t0 + q0 + r;
          c_s[r * (kSlice + 1) + n] =
              t < T ? bf2f(Cm[(((long)b * T + t) * G + g) * kN + n0 + n]) : 0.f;
        }
        __syncthreads();
#pragma unroll 8
        for (int n = 0; n < kSlice; ++n) {
          float av[4], sv[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) av[i] = c_s[(ty + 16 * i) * (kSlice + 1) + n];
#pragma unroll
          for (int j = 0; j < 4; ++j) sv[j] = s_s[(tx + 16 * j) * kSPad + n0 + n];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) yo[i][j] = fmaf(av[i], sv[j], yo[i][j]);
        }
        __syncthreads();
      }

      // 2b. y_diag = sum_k M[q,k] x_k over the k tiles on or below the diagonal
      float yd[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) yd[i][j] = 0.f;
      float* m_s = work;                        // [kTile][kTile + 1]
      float* x_s = work + kTile * (kTile + 1);  // [kTile][kP]
      for (int kt = 0; kt <= qt; ++kt) {
        const int k0 = kt * kTile;
        for (int e = tid; e < kTile * kTile; e += kThreads) {
          const int r = e / kTile, col = e % kTile;
          const int q = q0 + r, k = k0 + col;
          float m = 0.f;
          if (k <= q) m = cbc[q * kQ + k] * expf(cum_s[q] - cum_s[k]) * dt_s[k];
          m_s[r * (kTile + 1) + col] = m;
        }
        for (int e = tid; e < kTile * kP; e += kThreads) {
          const int r = e / kP, p = e % kP, t = t0 + k0 + r;
          x_s[r * kP + p] = t < T ? bf2f(x[(((long)b * T + t) * H + h) * kP + p]) : 0.f;
        }
        __syncthreads();
#pragma unroll 8
        for (int k = 0; k < kTile; ++k) {
          float mv[4], xv[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) mv[i] = m_s[(ty + 16 * i) * (kTile + 1) + k];
#pragma unroll
          for (int j = 0; j < 4; ++j) xv[j] = x_s[k * kP + tx + 16 * j];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) yd[i][j] = fmaf(mv[i], xv[j], yd[i][j]);
        }
        __syncthreads();
      }

#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int q = q0 + ty + 16 * i;
        if (q >= tc) continue;
        const float decay = expf(cum_s[q]);
        bf16* yr = y + (((long)b * T + t0 + q) * H + h) * kP;
#pragma unroll
        for (int j = 0; j < 4; ++j) yr[tx + 16 * j] = __float2bfloat16_rn(yd[i][j] + yo[i][j] * decay);
      }
    }

    // 3. S = S * exp(cum_last) + sum_k (B_k * w_k) x_k, over slices of k
    float sa[4][8];  // rows p = ty + 16 i, columns n = tx + 16 j
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) sa[i][j] = 0.f;
    float* bw_s = work;                  // [kSlice][kN]
    float* xk_s = work + kSlice * kN;    // [kSlice][kP]
    for (int k0 = 0; k0 < tc; k0 += kSlice) {
      __syncthreads();  // w_s written; the previous slice (or phase 2) done with work
      for (int e = tid; e < kSlice * kN; e += kThreads) {
        const int r = e / kN, n = e % kN, k = k0 + r;
        bw_s[e] = k < tc ? bf2f(Bm[(((long)b * T + t0 + k) * G + g) * kN + n]) * w_s[k] : 0.f;
      }
      for (int e = tid; e < kSlice * kP; e += kThreads) {
        const int r = e / kP, p = e % kP, k = k0 + r;
        xk_s[e] = k < tc ? bf2f(x[(((long)b * T + t0 + k) * H + h) * kP + p]) : 0.f;
      }
      __syncthreads();
#pragma unroll 4
      for (int r = 0; r < kSlice; ++r) {
        float xv[4], bv[8];
#pragma unroll
        for (int i = 0; i < 4; ++i) xv[i] = xk_s[r * kP + ty + 16 * i];
#pragma unroll
        for (int j = 0; j < 8; ++j) bv[j] = bw_s[r * kN + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) sa[i][j] = fmaf(bv[j], xv[i], sa[i][j]);
      }
    }
    __syncthreads();  // every thread is done reading S_prev (phase 2a)
    const float e_last = expf(cum_last);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        float* s = s_s + (ty + 16 * i) * kSPad + tx + 16 * j;
        *s = *s * e_last + sa[i][j];
      }
    __syncthreads();  // S_new visible to the next chunk; cum_s / w_s free
  }

  float* so = state + ((long)b * H + h) * kP * kN;
  for (int e = tid; e < kP * kN; e += kThreads) so[e] = s_s[(e / kN) * kSPad + e % kN];
}

}  // namespace

extern "C" {

// x (B,T,H,P) bf16, dt (B,T,H) f32, A (H,) f32, Bm/Cm (B,T,G,N) bf16, all
// contiguous; y (B,T,H,P) bf16 and state (B,H,P,N) f32 are written;
// cb_scratch holds B * ceil(T/Q) * G * Q * Q floats.  Only P 64, N 128 and
// chunk 256 are built.
int ssd_scan_fwd(const void* x, const void* dt, const void* A, const void* Bm, const void* Cm,
                 void* y, void* state, void* cb_scratch, int B, int T, int H, int P, int G,
                 int N, int chunk, void* stream) {
  if (P != kP || N != kN || chunk != kQ || G < 1 || H % G || B < 1 || T < 1)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nC = (T + kQ - 1) / kQ;
  ssd_cb_kernel<<<dim3(kTiles * kTiles, nC * G, B), kThreads, 0, st>>>(
      static_cast<const bf16*>(Bm), static_cast<const bf16*>(Cm),
      static_cast<float*>(cb_scratch), T, G, nC);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int smem = kSmemFloats * static_cast<int>(sizeof(float));
  err = cudaFuncSetAttribute(ssd_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  ssd_scan_kernel<<<dim3(H, B), kThreads, smem, st>>>(
      static_cast<const bf16*>(x), static_cast<const float*>(dt), static_cast<const float*>(A),
      static_cast<const bf16*>(Bm), static_cast<const bf16*>(Cm),
      static_cast<const float*>(cb_scratch), static_cast<bf16*>(y), static_cast<float*>(state),
      T, H, G, nC);
  return cudaGetLastError();
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
