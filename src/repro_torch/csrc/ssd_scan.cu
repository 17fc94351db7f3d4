// Hand-written Hopper (sm_90a) Mamba-2 SSD chunked scan, forward, on the
// tensor cores.
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
//   * At the mamba2-1.3b training shape (B 8, T 512, H 64, P 64, G 1, N 128)
//     the scan must move about 87 MB (x and y 33.5 MB each, the final state
//     16.8 MB, dt, B and C) and do 13 GFLOP: it is bound by bytes, 0.0260 ms
//     at 3.35 TB/s against 0.0132 ms of bf16 tensor-core work.  What holds
//     this kernel far above that is the chain of dependent steps inside a
//     block (C.B^T, then M, then M x, for every 16 x 16 block below the
//     diagonal) and the shared-memory traffic of its operands, so the
//     design keeps every SM busy with one long-lived block and feeds each
//     warp two independent chains a step.
//   * Every product runs on the tensor cores: mma.sync.m16n8k16, bf16 in,
//     f32 accumulate, operands through ldmatrix.  C, B and x are bf16 in the
//     inputs and enter exactly.  The three f32 operands -- M, S_prev and
//     B * w (w = exp(cum_last - cum_k) * dt_k) -- each enter as two bf16
//     halves, hi = bf16(v) and lo = bf16(v - hi), multiplied into the same
//     f32 accumulator: v - hi - lo is at most 2^-17 |v| (2^-134 absolute
//     where lo is subnormal), inside the error model that held the
//     CUDA-core version (chip_smoke.py: ssd_tolerance).  C.B^T comes out of
//     its product in the A-fragment layout of M x, and M is built from it
//     in registers.  (wgmma for C.B^T and C.S_prev, whose operands both sit
//     in shared memory, was measured slower: a 64 x 16 product waited on
//     every step holds the warpgroup.)
//   * One block of 512 threads per (batch, head) walks its chunks in order,
//     as the TPU kernel's sequential grid axis does; 512 blocks at the
//     training shape, one an SM.  Warp w owns the chunk's rows 16w..16w+15
//     (y over all of P) and a 16-row by P N / 256-column block of S^T (at
//     N 128: rows 16 (w % 8).., columns 32 (w / 8)..; at N 64: rows 16
//     (w % 4).., columns 16 (w / 4)..): the state's slices over P live in
//     the registers of the warps as mma accumulators for the whole scan; a
//     bf16 hi / lo copy in shared memory feeds C . S_prev.  Nothing but y
//     and the final state go to device memory, both staged through
//     shared memory into whole rows.
//   * C . B^T is recomputed inside the block, 16 x 32 at a time, and never
//     stored: a scratch written once per (batch, group) would be pulled
//     through L2 by every head's block (139 MB at the training shape for
//     4 MB of data), and that traffic costs more than the products.
//   * Loads overlap the products: a three-stage cp.async ring of 32-row
//     steps carries B, x and the next chunk's C rows (the whole chunk of C
//     is double-buffered in shared memory for C . B^T and C . S_prev); rows
//     past T arrive as zeros.  dt of the next chunk is read a chunk ahead.
//
// Built instances (P, N, Q) of the tensor-core kernel: (64, 128, 256) for
// mamba2-1.3b and (64, 64, 256) for zamba2-7b.  The warps split S^T into
// N / 16 row tiles and 16 / (N / 16) column groups of P, so at N 64 a warp
// holds 16 columns of P (two n8 accumulators) where at N 128 it holds 32.
// The smoke configs' (16, 16, 8) -- a chunk of 8 rows, under one 16-row
// mma tile -- runs a second template, ssd_scan_small_kernel, on the CUDA
// cores: one thread a state element (p, n), the chunk's C.B^T, decays and
// dt in shared memory, every product in f32 (it moves a few KB a block; its
// time is launch overhead).  Any G dividing H works; T is any length (the
// last chunk is masked).
//
// C interface: ssd_scan_fwd returns a cudaError_t (0 on success) taken with
// cudaGetLastError() right after the launch; the Python wrapper raises on
// anything else.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

// The tensor-core kernel's layout at head dim P, state N and chunk Q.
template <int P, int N, int Q>
struct Tc {
  static constexpr int kP = P;            // head dim
  static constexpr int kN = N;            // state dim
  static constexpr int kQ = Q;            // chunk length
  static constexpr int kWarps = kQ / 16;  // one warp per 16 rows of the chunk
  static constexpr int kThreads = kWarps * 32;
  static constexpr int kStep = 32;        // rows of a ring step: two 16-row k-steps
  static constexpr int kStepsPerChunk = kQ / kStep;
  static constexpr int kStages = 3;       // ring of steps
  static constexpr int kRowN = kN + 8;    // C / B row stride in shared memory (bf16)
  static constexpr int kRowP = kP + 8;    // x / S^T row stride (bf16): 144 bytes
  // S^T (N x P) over the warps: N / 16 row tiles, kPG column groups of kPW
  static constexpr int kNT = kN / 16;
  static constexpr int kPG = kWarps / kNT;
  static constexpr int kPW = kP / kPG;    // columns of P a warp holds
  static constexpr int kJ8 = kPW / 8;     // its n8 accumulators
  static constexpr int kCopyB = kStep * (kN / 8);    // threads copying a step's B
  static constexpr int kCRows = kThreads / (kN / 8);  // C rows a load_c call copies

  // the padding puts the eight 16-byte rows of every ldmatrix on distinct banks
  static_assert((kRowN * 2 / 4) % 32 == 4 && (kRowP * 2 / 4) % 32 == 4, "bank-free ldmatrix rows");
  static_assert(kP == 64 && kQ == 256, "y rows of 8 x 16 bytes; 16 warps over the chunk");
  static_assert(kWarps % kNT == 0 && kPW % 16 == 0, "warps tile S^T in 16 x 16 blocks");
  static_assert(kCopyB <= kThreads && kStep * (kP / 8) <= kThreads, "one copy of B, x a thread");
  static_assert(kThreads % (kN / 8) == 0 && 64 % kCRows == 0, "whole C rows a load_c call");
  static_assert(kP * (kN + 4) * 4 <= 2 * kN * kRowP * 2, "the final state fits S_prev's copy");
  static_assert(kP * 2 <= kRowN * 2 && kP * 2 == 8 * 16, "a y row is 8 x 16 bytes in a C row");

  // Shared memory, in bytes: C of two chunks; the ring (B and x of a 32-row
  // step); S_prev^T hi and lo; cumsum, dt and w of the chunk.
  static constexpr int kCBytes = kQ * kRowN * 2;                          // one chunk of C
  static constexpr int kStageBytes = kStep * kRowN * 2 + kStep * kRowP * 2;
  static constexpr int kSBytes = kN * kRowP * 2;                          // S^T hi or lo
  static constexpr int kSmem =
      2 * kCBytes + kStages * kStageBytes + 2 * kSBytes + (3 * kQ + 16) * 4;
};

constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; `valid` false zero-fills them and reads nothing.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four 8 x 8 bf16 matrices; lanes 8i..8i+7 give the row addresses of matrix i.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// d (16 x 8, f32) += a (16 x 16, bf16, row) * b (16 x 8, bf16, col)
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += (hi + lo) * b: an f32 A operand as two bf16 products.
__device__ __forceinline__ void mma2(float (&d)[4], const uint32_t (&hi)[4],
                                     const uint32_t (&lo)[4], uint32_t b0, uint32_t b1) {
  mma(d, hi, b0, b1);
  mma(d, lo, b0, b1);
}

__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// (v0, v1) -> hi = bf16(v), lo = bf16(v - hi), each a register of two bf16
// (v0 in the lower half: the lower column of an mma fragment).  v - hi is
// exact in f32, so v - hi - lo is lo's rounding alone.
__device__ __forceinline__ void split2(float v0, float v1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
  const float2 hf = __bfloat1622float2(h);
  hi = as_u32(h);
  lo = as_u32(__floats2bfloat162_rn(v0 - hf.x, v1 - hf.y));
}

// 2^v, flushing results below 2^-126 to 0 (decays that small times C.B^T
// and dt are far below the error model's absolute term)
__device__ __forceinline__ float ex2(float v) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(r) : "f"(v));
  return r;
}

// A register of two bf16 times (s0, s1), split into hi / lo.
__device__ __forceinline__ void scale_split(uint32_t r, float s0, float s1, uint32_t& hi,
                                            uint32_t& lo) {
  const float2 v = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&r));
  split2(v.x * s0, v.y * s1, hi, lo);
}

// ---------------------------------------------------------------------------
// Grid (H, B), 512 threads: block (h, b) owns x[b, :, h, :], y[b, :, h, :]
// and S[b, h, :, :].  Thread (warp w, gr = lane / 4, t4 = lane % 4) holds,
// as mma accumulators (kNT = N / 16 row tiles of S^T, kPW of its columns a
// warp: 8 and 32 at N 128, 4 and 16 at N 64):
//   acc[j]:  y rows 16w + gr (+8), columns 8j + 2 t4 (+1) of the chunk;
//   sacc[j]: S^T rows n = 16 (w % kNT) + gr (+8), columns p = kPW (w / kNT)
//            + 8j + 2 t4 (+1), for the whole scan.
// Per chunk: the cumsum; acc = y_off = (C . S_prev) exp(cum_q); then per
// 32-row step J from the ring, for its two 16-row halves (k-steps 2J and
// 2J + 1): S^T += (B w)^T x, and for the halves on or above my rows (k-step
// <= w) C.B^T of my 16 rows x the half, M from it, y += M x.
// ---------------------------------------------------------------------------
template <int P, int N, int Q>
__global__ void __launch_bounds__(Tc<P, N, Q>::kThreads, 1)
ssd_scan_kernel(const bf16* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ A, const bf16* __restrict__ Bm,
                const bf16* __restrict__ Cm, bf16* __restrict__ y,
                float* __restrict__ state, int T, int H, int G, int nC) {
  using L = Tc<P, N, Q>;
  constexpr int kP = L::kP, kN = L::kN, kQ = L::kQ, kThreads = L::kThreads;
  constexpr int kStep = L::kStep, kStepsPerChunk = L::kStepsPerChunk, kStages = L::kStages;
  constexpr int kRowN = L::kRowN, kRowP = L::kRowP, kCBytes = L::kCBytes;
  constexpr int kStageBytes = L::kStageBytes, kNT = L::kNT, kPW = L::kPW, kJ8 = L::kJ8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* c_buf = reinterpret_cast<bf16*>(smem);                        // [2][kQ][kRowN]
  unsigned char* ring = smem + 2 * kCBytes;                            // [kStages] B, x
  bf16* s_hi = reinterpret_cast<bf16*>(ring + kStages * kStageBytes);  // [kN][kRowP]
  bf16* s_lo = s_hi + kN * kRowP;
  float* c2_s = reinterpret_cast<float*>(s_lo + kN * kRowP);  // [kQ]  cumsum of dt * A, x log2 e
  float* dt_s = c2_s + kQ;                                    // [kQ]  dt (0 past T)
  float* w_s = dt_s + kQ;                                     // [kQ]  exp(cum_last - cum_k) dt_k
  float* red_s = w_s + kQ;                                    // [kQ / 32 + 1]

  const int h = blockIdx.x, b = blockIdx.y;
  const int g = h / (H / G);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gr = lane >> 2, t4 = lane & 3;
  const int sn = 16 * (warp % kNT), sp = kPW * (warp / kNT);  // this warp's S^T block
  const float a_h = A[h];
  const int n_steps = kStepsPerChunk * (nC - 1) + (T - (nC - 1) * kQ + kStep - 1) / kStep;

  // Copies: step s (rows 32 s .. 32 s + 31 of the sequence, since a chunk
  // is 8 steps) puts 32 rows of B (threads 0 .. 4N - 1, 16 bytes each) and
  // of x (threads 0-255) into its ring stage; the first four steps of a
  // chunk also put 64 rows each of the next chunk's C into the other C
  // buffer.
  // Each thread keeps its own source rows and columns; rows past T arrive
  // as zeros.
  const long row_bc = (long)G * kN;  // elements from one B / C row to the next
  const int cb_r = tid / (kN / 8), cb_col = (tid % (kN / 8)) * 8;  // B and C
  const int cx_r = tid / (kP / 8), cx_col = (tid % (kP / 8)) * 8;  // x
  const bf16* src_b = Bm + ((long)b * T * G + g) * kN + cb_col;
  const bf16* src_c = Cm + ((long)b * T * G + g) * kN + cb_col;
  const bf16* src_x = x + ((long)b * T * H + h) * kP + cx_col;
  const uint32_t dst_b = smem_u32(ring) + (cb_r * kRowN + cb_col) * 2;
  const uint32_t dst_x = smem_u32(ring) + kStep * kRowN * 2 + (cx_r * kRowP + cx_col) * 2;
  const uint32_t dst_c = smem_u32(c_buf) + (cb_r * kRowN + cb_col) * 2;
  auto load_step = [&](int s) {  // one commit group, empty past the last step
    if (s < n_steps) {
      const uint32_t st = (s % kStages) * kStageBytes;
      const int row = kStep * s + cb_r;
      if (tid < L::kCopyB)
        cp_async16(dst_b + st, src_b + (row < T ? row : 0) * row_bc, row < T);
      if (tid < kStep * (kP / 8)) {
        const int rx = kStep * s + cx_r;
        cp_async16(dst_x + st, src_x + (rx < T ? rx : 0) * (long)H * kP, rx < T);
      }
    }
    cp_async_commit();
  };
  auto load_c = [&](int c, int r0) {  // C rows r0 + cb_r of chunk c (no commit)
    const int r = r0 + cb_r, row = c * kQ + r;
    cp_async16(dst_c + (c & 1) * kCBytes + r0 * kRowN * 2, src_c + (row < T ? row : 0) * row_bc,
               row < T);
  };

  float sacc[kJ8][4];
#pragma unroll
  for (int j = 0; j < kJ8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) sacc[j][e] = 0.f;

  for (int r0 = 0; r0 < kQ; r0 += L::kCRows) load_c(0, r0);
  cp_async_commit();
  for (int s = 0; s < kStages - 1; ++s) load_step(s);
  int s = 0;  // step index over the whole scan
  float dt_next = tid < kQ && tid < T ? dt[((long)b * T + tid) * H + h] : 0.f;

  for (int c = 0; c < nC; ++c) {
    const int t0 = c * kQ;
    const int tc = min(kQ, T - t0);  // rows of this chunk inside T
    bf16* c_t = c_buf + (c & 1) * kQ * kRowN;

    // 1. dt and the inclusive cumsum of dt * A (thread tid < 256 holds row
    //    tid); the next chunk's dt is read now, used a chunk later.  C of
    //    this chunk is in (its copies went out with the previous chunk's
    //    first eight steps, or before the first step).
    const float d = dt_next;
    if (tid < kQ && c + 1 < nC) {
      const int tn = t0 + kQ + tid;
      dt_next = tn < T ? dt[((long)b * T + tn) * H + h] : 0.f;
    }
    float v = d * a_h;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float o = __shfl_up_sync(0xffffffffu, v, off);
      if (lane >= off) v += o;
    }
    if (tid < kQ && lane == 31) red_s[warp] = v;
    if (c > 0) cp_async_wait<kStages - 1>();  // (its copies went out with steps 0-3 before)
    __syncthreads();  // red_s and C ready; the previous chunk is done with c2_s / dt_s / w_s
    if (tid < kQ) {
      for (int w = 0; w < warp; ++w) v += red_s[w];
      if (tid == kQ - 1) red_s[kQ / 32] = v;  // cum_last
      c2_s[tid] = v * kLog2e;
      dt_s[tid] = d;
    }
    __syncthreads();
    const float cum_last = red_s[kQ / 32];
    if (tid < kQ) w_s[tid] = expf(cum_last - v) * d;  // read after the first step's barrier
    const float cq2[2] = {c2_s[16 * warp + gr], c2_s[16 * warp + gr + 8]};  // log2 cum, my rows
    const float cr2 = c2_s[16 * warp];  // of my row tile's first row
    const float e_last = expf(cum_last);
#pragma unroll
    for (int j = 0; j < kJ8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sacc[j][e] *= e_last;

    // 2. acc = y_off = (C_q . S_prev) * exp(cum_q); 0 in chunk 0 (S_prev = 0)
    float acc[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
    const uint32_t c_row = smem_u32(c_t + (16 * warp + (lane & 15)) * kRowN + (lane >> 4) * 8);
    if (c > 0 && 16 * warp < tc) {
#pragma unroll 2
      for (int ks = 0; ks < kN / 16; ++ks) {
        uint32_t a[4];
        ldsm_x4(a, c_row + ks * 32);
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const int so = (ks * 16 + (lane & 15)) * kRowP + jj * 16 + (lane >> 4) * 8;
          uint32_t bh[4], bl[4];
          ldsm_x4_t(bh, smem_u32(s_hi + so));
          ldsm_x4_t(bl, smem_u32(s_lo + so));
          mma(acc[2 * jj], a, bh[0], bh[1]);
          mma(acc[2 * jj], a, bl[0], bl[1]);
          mma(acc[2 * jj + 1], a, bh[2], bh[3]);
          mma(acc[2 * jj + 1], a, bl[2], bl[3]);
        }
      }
      const float e0 = ex2(cq2[0]), e1 = ex2(cq2[1]);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        acc[j][0] *= e0;
        acc[j][1] *= e0;
        acc[j][2] *= e1;
        acc[j][3] *= e1;
      }
    }
    // exp(cum_q - cum_r) of my rows against my tile's first row r: with
    // exp(cum_r - cum_k) per column, M's decay below the diagonal step at
    // half the exps (both factors <= 1)
    const float rf[2] = {ex2(cq2[0] - cr2), ex2(cq2[1] - cr2)};

    const int ns = (tc + kStep - 1) / kStep;
    for (int J = 0; J < ns; ++J, ++s) {
      // 3. step s in shared memory for every thread, and every thread done
      //    with step s - 1, whose stage the copies of step s + 2 now fill;
      //    the next chunk's C goes out with the first four steps
      cp_async_wait<kStages - 2>();
      __syncthreads();
      if (c + 1 < nC && J < 4) {
#pragma unroll
        for (int r = 0; r < 64; r += L::kCRows) load_c(c + 1, 64 * J + r);
      }
      load_step(s + kStages - 1);
      const bf16* b_t = reinterpret_cast<const bf16*>(ring + (s % kStages) * kStageBytes);
      const bf16* x_t = b_t + kStep * kRowN;

      // 4. S^T += (B w)^T x over the step's 32 rows
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2) {
        const int k0 = kStep * J + 16 * h2 + 2 * t4;
        uint32_t a[4], hi[4], lo[4], xb[kPW / 16][4];
        ldsm_x4_t(a, smem_u32(b_t + (16 * h2 + (lane & 7) + (lane >> 4) * 8) * kRowN + sn +
                              ((lane >> 3) & 1) * 8));
#pragma unroll
        for (int jj = 0; jj < kPW / 16; ++jj)
          ldsm_x4_t(xb[jj], smem_u32(x_t + (16 * h2 + (lane & 15)) * kRowP + sp + jj * 16 +
                                     (lane >> 4) * 8));
        const float w0 = w_s[k0], w1 = w_s[k0 + 1], w8 = w_s[k0 + 8], w9 = w_s[k0 + 9];
        scale_split(a[0], w0, w1, hi[0], lo[0]);
        scale_split(a[1], w0, w1, hi[1], lo[1]);
        scale_split(a[2], w8, w9, hi[2], lo[2]);
        scale_split(a[3], w8, w9, hi[3], lo[3]);
#pragma unroll
        for (int jj = 0; jj < kPW / 16; ++jj) {
          mma2(sacc[2 * jj], hi, lo, xb[jj][0], xb[jj][1]);
          mma2(sacc[2 * jj + 1], hi, lo, xb[jj][2], xb[jj][3]);
        }
      }
      if (2 * J > warp) continue;  // my rows are above the step

      // 5. C.B^T for my 16 rows x the step's two 16-column halves at once
      //    (one C fragment for both); its accumulators are M's A
      //    fragments: cbv[h2][r >> 1][2 (r & 1) + e] is row gr + 8 (r & 1),
      //    column k0 + 8 (r >> 1) + e of half h2
      float cbv[2][2][4];
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2)
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) cbv[h2][j][e] = 0.f;
      const uint32_t b_row = smem_u32(b_t + ((lane & 7) + ((lane >> 4) << 3)) * kRowN +
                                      ((lane >> 3) & 1) * 8);
#pragma unroll
      for (int ks = 0; ks < kN / 16; ++ks) {
        uint32_t a[4], bb[4], bb2[4];
        ldsm_x4(a, c_row + ks * 32);
        ldsm_x4(bb, b_row + ks * 32);
        ldsm_x4(bb2, b_row + 16 * kRowN * 2 + ks * 32);
        mma(cbv[0][0], a, bb[0], bb[1]);
        mma(cbv[0][1], a, bb[2], bb[3]);
        mma(cbv[1][0], a, bb2[0], bb2[1]);
        mma(cbv[1][1], a, bb2[2], bb2[3]);
      }
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2) {
        const int J2 = 2 * J + h2;  // the 16-column half's k-step
        if (J2 > warp) continue;    // (the second half of my diagonal step)
        const int k0 = 16 * J2 + 2 * t4;
        const float ck[4] = {c2_s[k0], c2_s[k0 + 1], c2_s[k0 + 8], c2_s[k0 + 9]};
        const float dk[4] = {dt_s[k0], dt_s[k0 + 1], dt_s[k0 + 8], dt_s[k0 + 9]};
        float m[4][2];
        if (J2 < warp) {
          float u[4];
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) u[kk] = ex2(cr2 - ck[kk]) * dk[kk];
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int e = 0; e < 2; ++e)
              m[r][e] = cbv[h2][r >> 1][2 * (r & 1) + e] * rf[r & 1] * u[2 * (r >> 1) + e];
        } else {  // the diagonal k-step: L masked before the exp
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int kk = 2 * (r >> 1) + e;
              const bool keep = 2 * t4 + 8 * (r >> 1) + e <= gr + 8 * (r & 1);
              const float l = keep ? ex2(cq2[r & 1] - ck[kk]) : 0.f;
              m[r][e] = cbv[h2][r >> 1][2 * (r & 1) + e] * l * dk[kk];
            }
        }
        uint32_t hi[4], lo[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) split2(m[r][0], m[r][1], hi[r], lo[r]);
        // 6. y += M x over all of P
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          uint32_t xb[4];
          ldsm_x4_t(xb, smem_u32(x_t + (16 * h2 + (lane & 15)) * kRowP + jj * 16 + (lane >> 4) * 8));
          mma2(acc[2 * jj], hi, lo, xb[0], xb[1]);
          mma2(acc[2 * jj + 1], hi, lo, xb[2], xb[3]);
        }
      }
    }

    // 7. y of the chunk's rows inside T, through my own C rows in shared
    //    memory (no other warp reads them, and the next chunk's copies go to
    //    the other buffer): whole 128-byte rows of y, 16 bytes a lane
    bf16* y_s = c_t + 16 * warp * kRowN;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        *reinterpret_cast<uint32_t*>(y_s + (gr + 8 * hh) * kRowN + 8 * j + 2 * t4) =
            as_u32(__floats2bfloat162_rn(acc[j][2 * hh], acc[j][2 * hh + 1]));
    __syncwarp();
#pragma unroll
    for (int it = 0; it < 4; ++it) {
      const int r = 4 * it + lane / 8, q = 16 * warp + r;
      if (q < tc)
        *reinterpret_cast<uint4*>(y + (((long)b * T + t0 + q) * H + h) * kP + (lane % 8) * 8) =
            *reinterpret_cast<const uint4*>(y_s + r * kRowN + (lane % 8) * 8);
    }
    // 8. S_new as the next chunk's S_prev (hi / lo); read after its barriers
    if (c + 1 < nC) {
#pragma unroll
      for (int j = 0; j < kJ8; ++j)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int o = (sn + gr + 8 * hh) * kRowP + sp + 8 * j + 2 * t4;
          uint32_t hi, lo;
          split2(sacc[j][2 * hh], sacc[j][2 * hh + 1], hi, lo);
          *reinterpret_cast<uint32_t*>(s_hi + o) = hi;
          *reinterpret_cast<uint32_t*>(s_lo + o) = lo;
        }
    }
  }
  cp_async_wait<0>();  // (only empty groups are left)

  // the final state, f32, through shared memory (S_prev's copy is free
  // now): state[b, h, p, n] in whole rows of 4N bytes, 16 bytes a lane
  __syncthreads();  // every warp is done with S_prev
  float* st_s = reinterpret_cast<float*>(s_hi);  // [kP][kN + 4]
#pragma unroll
  for (int j = 0; j < kJ8; ++j)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int n = sn + gr + 8 * hh, p = sp + 8 * j + 2 * t4;
      st_s[p * (kN + 4) + n] = sacc[j][2 * hh];
      st_s[(p + 1) * (kN + 4) + n] = sacc[j][2 * hh + 1];
    }
  __syncthreads();
  float* so = state + ((long)b * H + h) * kP * kN;
  for (int e = tid; e < kP * kN / 4; e += kThreads) {
    const int p = e / (kN / 4), n = (e % (kN / 4)) * 4;
    *reinterpret_cast<float4*>(so + p * kN + n) =
        *reinterpret_cast<const float4*>(st_s + p * (kN + 4) + n);
  }
}

// ---------------------------------------------------------------------------
// The CUDA-core kernel for chunks under one mma tile (the smoke configs'
// P 16, N 16, chunk 8).  Grid (H, B), P * N threads: thread (p, n) owns
// S[p, n] in shared memory.  Per chunk: x, B, C and dt of its Q rows into
// shared memory (zeros past T); the cumsum of dt * A (one thread, Q adds);
// M[q, k] = (C_q . B_k) exp(cum_q - cum_k) dt_k for k <= q (the exp only
// below the diagonal); y_q = sum_k M[q, k] x_k + (C_q . S_prev) exp(cum_q);
// then S = S exp(cum_last) + sum_k B_k x_k exp(cum_last - cum_k) dt_k.  All
// in f32, as the plain version; y is rounded to bf16 once.
// ---------------------------------------------------------------------------
template <int P, int N, int Q>
__global__ void __launch_bounds__(P * N)
ssd_scan_small_kernel(const bf16* __restrict__ x, const float* __restrict__ dt,
                      const float* __restrict__ A, const bf16* __restrict__ Bm,
                      const bf16* __restrict__ Cm, bf16* __restrict__ y,
                      float* __restrict__ state, int T, int H, int G, int nC) {
  constexpr int kThreads = P * N;
  static_assert(kThreads <= 1024 && Q * Q <= 4 * kThreads, "a thread a state element");
  __shared__ float xs[Q][P], bs[Q][N], cs[Q][N], dts[Q], cum[Q], m[Q][Q];
  __shared__ float st[P][N + 1];
  const int h = blockIdx.x, b = blockIdx.y;
  const int g = h / (H / G);
  const int tid = threadIdx.x, p = tid / N, n = tid % N;
  const float a_h = A[h];
  st[p][n] = 0.f;
  for (int c = 0; c < nC; ++c) {
    const int t0 = c * Q;
    for (int i = tid; i < Q * P; i += kThreads) {
      const int q = i / P, t = t0 + q;
      xs[q][i % P] = t < T ? __bfloat162float(x[((long)(b * T + t) * H + h) * P + i % P]) : 0.f;
    }
    for (int i = tid; i < Q * N; i += kThreads) {
      const int q = i / N, t = t0 + q;
      const long o = ((long)(b * T + t) * G + g) * N + i % N;
      bs[q][i % N] = t < T ? __bfloat162float(Bm[o]) : 0.f;
      cs[q][i % N] = t < T ? __bfloat162float(Cm[o]) : 0.f;
    }
    if (tid < Q) dts[tid] = t0 + tid < T ? dt[(long)(b * T + t0 + tid) * H + h] : 0.f;
    __syncthreads();
    if (tid == 0) {
      float v = 0.f;
      for (int q = 0; q < Q; ++q) cum[q] = v += dts[q] * a_h;
    }
    __syncthreads();
    for (int i = tid; i < Q * Q; i += kThreads) {
      const int q = i / Q, k = i % Q;
      float v = 0.f;
      if (k <= q) {
        for (int j = 0; j < N; ++j) v = fmaf(cs[q][j], bs[k][j], v);
        v *= expf(cum[q] - cum[k]) * dts[k];
      }
      m[q][k] = v;
    }
    __syncthreads();
    for (int i = tid; i < Q * P; i += kThreads) {
      const int q = i / P, pp = i % P, t = t0 + q;
      float off = 0.f;
      for (int j = 0; j < N; ++j) off = fmaf(cs[q][j], st[pp][j], off);
      float v = off * expf(cum[q]);
      for (int k = 0; k <= q; ++k) v = fmaf(m[q][k], xs[k][pp], v);
      if (t < T) y[((long)(b * T + t) * H + h) * P + pp] = __float2bfloat16_rn(v);
    }
    __syncthreads();  // every y read S_prev
    const float cl = cum[Q - 1];
    float v = st[p][n] * expf(cl);
    for (int k = 0; k < Q; ++k) v = fmaf(bs[k][n] * xs[k][p], expf(cl - cum[k]) * dts[k], v);
    st[p][n] = v;
    __syncthreads();  // the chunk's rows are read before the next chunk's land
  }
  state[((long)b * H + h) * P * N + tid] = st[p][n];
}

// The launch of the (P, N, Q) instance: its kernel, threads and dynamic
// shared memory (the attribute set once).
template <int P, int N, int Q>
struct Instance {
  static const void* kernel() { return reinterpret_cast<const void*>(ssd_scan_kernel<P, N, Q>); }
  static constexpr int kThreads = Tc<P, N, Q>::kThreads;
  static constexpr int kSmem = Tc<P, N, Q>::kSmem;
  static cudaError_t launch(dim3 grid, cudaStream_t st, const bf16* x, const float* dt,
                            const float* A, const bf16* Bm, const bf16* Cm, bf16* y,
                            float* state, int T, int H, int G) {
    ssd_scan_kernel<P, N, Q><<<grid, kThreads, kSmem, st>>>(x, dt, A, Bm, Cm, y, state, T, H, G,
                                                            (T + Q - 1) / Q);
    return cudaGetLastError();
  }
};

template <>
struct Instance<16, 16, 8> {
  static const void* kernel() {
    return reinterpret_cast<const void*>(ssd_scan_small_kernel<16, 16, 8>);
  }
  static constexpr int kThreads = 16 * 16;
  static constexpr int kSmem = 0;
  static cudaError_t launch(dim3 grid, cudaStream_t st, const bf16* x, const float* dt,
                            const float* A, const bf16* Bm, const bf16* Cm, bf16* y,
                            float* state, int T, int H, int G) {
    ssd_scan_small_kernel<16, 16, 8><<<grid, kThreads, 0, st>>>(x, dt, A, Bm, Cm, y, state, T,
                                                                 H, G, (T + 7) / 8);
    return cudaGetLastError();
  }
};

template <int P, int N, int Q>
cudaError_t set_smem() {
  using I = Instance<P, N, Q>;
  static bool done = false;
  if (done || I::kSmem == 0) return cudaSuccess;
  const cudaError_t err =
      cudaFuncSetAttribute(I::kernel(), cudaFuncAttributeMaxDynamicSharedMemorySize, I::kSmem);
  done = err == cudaSuccess;
  return err;
}

template <int P, int N, int Q>
cudaError_t launch(const void* x, const void* dt, const void* A, const void* Bm, const void* Cm,
                   void* y, void* state, int B, int T, int H, int G, cudaStream_t stream) {
  cudaError_t err = set_smem<P, N, Q>();
  if (err != cudaSuccess) return err;
  return Instance<P, N, Q>::launch(
      dim3(H, B), stream, static_cast<const bf16*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const bf16*>(Bm), static_cast<const bf16*>(Cm),
      static_cast<bf16*>(y), static_cast<float*>(state), T, H, G);
}

template <int P, int N, int Q>
cudaError_t occupancy(int* blocks_per_sm) {
  using I = Instance<P, N, Q>;
  cudaError_t err = set_smem<P, N, Q>();
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, I::kernel(), I::kThreads,
                                                       I::kSmem);
}

}  // namespace

// The instances (head dim P, state N, chunk Q); the Python wrapper's
// INSTANCES names the same ones.
#define REPRO_SSD_INSTANCES(X) X(64, 128, 256) X(64, 64, 256) X(16, 16, 8)

extern "C" {

// x (B,T,H,P) bf16, dt (B,T,H) f32, A (H,) f32, Bm/Cm (B,T,G,N) bf16, all
// contiguous; y (B,T,H,P) bf16 and state (B,H,P,N) f32 are written.  Only
// the (P, N, chunk) of REPRO_SSD_INSTANCES are built.
int ssd_scan_fwd(const void* x, const void* dt, const void* A, const void* Bm, const void* Cm,
                 void* y, void* state, int B, int T, int H, int P, int G, int N, int chunk,
                 void* stream) {
  if (G < 1 || H % G || B < 1 || T < 1) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define REPRO_SSD_CASE(PP, NN, QQ) \
  if (P == PP && N == NN && chunk == QQ) \
    return launch<PP, NN, QQ>(x, dt, A, Bm, Cm, y, state, B, T, H, G, st);
  REPRO_SSD_INSTANCES(REPRO_SSD_CASE)
#undef REPRO_SSD_CASE
  return cudaErrorInvalidValue;
}

// How many scan blocks of the (P, N, chunk) instance one SM holds at once
// (the occupancy query; a diagnostic, not used by the launch) and the
// grid's size in blocks.
int ssd_scan_occupancy(int P, int N, int chunk, int H, int B, int* blocks_per_sm,
                       int* grid_blocks) {
  *grid_blocks = H * B;
#define REPRO_SSD_OCC(PP, NN, QQ) \
  if (P == PP && N == NN && chunk == QQ) return occupancy<PP, NN, QQ>(blocks_per_sm);
  REPRO_SSD_INSTANCES(REPRO_SSD_OCC)
#undef REPRO_SSD_OCC
  return cudaErrorInvalidValue;
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
