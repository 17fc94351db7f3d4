// Hand-written Hopper (sm_90a) flash attention forward: GQA, causal with a
// query offset, sliding window, tanh softcap, per-sequence kv_len.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/flash_attention/flash_attention.py::flash_attention_pallas
//   (body _attn_kernel), behind both of its wrappers:
//   flash_attn_fwd    <- ops.flash_attention         (prefill / train forward)
//   flash_attn_decode <- ops.flash_attention_decode  (one token vs a KV cache)
//
// Semantics (identical to _attn_kernel and attention_reference):
//   s = (q . k) / sqrt(dh);  s = tanh(s / cap) * cap          (if softcap)
//   valid(q, k) = k < S  and  k < kv_len[b]                   (if kv_len)
//                 and k <= q_offset + q                       (if causal)
//                 and k >  q_offset + q - window              (if window)
//   masked scores are -1e30; online softmax with f32 running max, sum and
//   accumulator; out = acc / max(l, 1e-30) in bf16.  Query head h reads KV
//   head h / (H / Hkv); KV heads are never repeated.
//
// What bounds it on an H100, and what the design does about it:
//   * Prefill (T = 1024, dh = 256) does 4*dh flops per valid (q, k) pair on
//     ~50 MB of q/k/v/out: it is bound by tensor-core operations, so both
//     products run on the tensor cores (mma.sync m16n8k16 bf16 -> f32) with
//     the operands fed from shared memory by ldmatrix.  The TPU kernel's
//     sequential KV grid axis and its VMEM scratch become a loop over KV
//     tiles inside one block, with the running max / sum / accumulator held
//     in registers.  Tiles wholly outside the causal / window / kv_len range
//     are never visited.  One 64-query tile, one 64-key K tile and one V tile
//     at dh = 256 need 99 KB of shared memory, above the 48 KB default, so
//     the launch opts in with cudaFuncAttributeMaxDynamicSharedMemorySize.
//     Rows are padded by 16 bytes so ldmatrix reads are free of bank
//     conflicts.  Ragged T and S are masked here; no padding in the wrapper.
//     (Not yet done: wgmma, TMA and a pipelined K/V ring — later work.)
//   * Decode (T = 1) reads every valid K/V byte once and does ~1 flop per
//     byte: it is bound by memory bytes.  One block serves one (batch, KV
//     head) pair and all G query heads that share it, so each K/V row is read
//     from device memory exactly once; each warp keeps four rows' loads in
//     flight.  Only B * Hkv blocks run, so a split over the cache length
//     (flash-decoding) is the next step for this entry point.
//
// C interface: every entry point returns a cudaError_t (0 on success) taken
// with cudaGetLastError() right after the launch; the Python wrapper raises
// on anything else.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr float kMask = -1e30f;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// d += a (16x16 bf16, row) * b (16x8 bf16, col), f32 accumulate.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two floats -> one register of two bf16; `lo` takes the lower column.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float apply_softcap(float s, float softcap) {
  return softcap > 0.f ? tanhf(s / softcap) * softcap : s;
}

// ---------------------------------------------------------------------------
// Prefill: grid (ceil(T/64), H, B), 4 warps; warp w owns query rows
// 16w..16w+15 of the block's 64-row tile.
// ---------------------------------------------------------------------------
constexpr int kBQ = 64;
constexpr int kBK = 64;
constexpr int kFwdThreads = 128;

template <int DH>
struct FwdSmem {
  static constexpr int LD = DH + 8;  // padded row, in elements
  static constexpr int BYTES = (kBQ + 2 * kBK) * LD * 2;
};

// rows x DH tile from global (row stride `stride` elements) into shared
// memory (row stride LD); rows >= n_rows are zero-filled so masked keys
// never carry NaN/Inf garbage into P.V.
template <int DH>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, long stride,
                                          int n_rows, int rows) {
  constexpr int LD = FwdSmem<DH>::LD;
  constexpr int CHUNKS = DH / 8;  // 16-byte chunks per row
  for (int c = threadIdx.x; c < rows * CHUNKS; c += kFwdThreads) {
    const int r = c / CHUNKS, col = (c % CHUNKS) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < n_rows) val = *reinterpret_cast<const uint4*>(src + r * stride + col);
    *reinterpret_cast<uint4*>(dst + r * LD + col) = val;
  }
}

template <int DH>
__global__ void __launch_bounds__(kFwdThreads)
flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, const int* __restrict__ kv_len,
                 bf16* __restrict__ out, int T, int S, int H, int Hkv, int causal,
                 int window, float softcap, float scale, int q_offset) {
  constexpr int LD = FwdSmem<DH>::LD;
  constexpr int NS = kBK / 8;  // 8-key column tiles of the score block
  constexpr int NO = DH / 8;   // 8-wide column tiles of the output
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sK = sQ + kBQ * LD;
  bf16* sV = sK + kBK * LD;

  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * kBQ;
  const int hk = h / (H / Hkv);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int q_rows = min(kBQ, T - q0);
  const long q_stride = (long)H * DH, kv_stride = (long)Hkv * DH;

  const bf16* qb = q + ((long)b * T + q0) * q_stride + (long)h * DH;
  const bf16* kb = k + (long)b * S * kv_stride + (long)hk * DH;
  const bf16* vb = v + (long)b * S * kv_stride + (long)hk * DH;

  load_tile<DH>(sQ, qb, q_stride, q_rows, kBQ);

  // valid keys are < k_limit; the causal bound of the block's last row and
  // the window bound of its first row cut the range of tiles visited
  int k_limit = S;
  if (kv_len != nullptr) k_limit = min(k_limit, kv_len[b]);
  int k_end = k_limit;
  if (causal) k_end = min(k_end, q_offset + q0 + q_rows);
  int k_begin = 0;
  if (window > 0) k_begin = max(0, q_offset + q0 - window + 1);
  k_begin = (k_begin / kBK) * kBK;

  const int row = warp * 16 + g;  // this thread's rows: row, row + 8
  const int qpos[2] = {q_offset + q0 + row, q_offset + q0 + row + 8};

  float o[NO][4];
#pragma unroll
  for (int i = 0; i < NO; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
  float m[2] = {kMask, kMask};
  float l[2] = {0.f, 0.f};

  for (int k0 = k_begin; k0 < k_end; k0 += kBK) {
    __syncthreads();  // every warp is done with the previous K/V tile
    const int k_rows = min(kBK, S - k0);
    load_tile<DH>(sK, kb + k0 * kv_stride, kv_stride, k_rows, kBK);
    load_tile<DH>(sV, vb + k0 * kv_stride, kv_stride, k_rows, kBK);
    __syncthreads();

    // S = Q K^T for this warp's 16 rows x 64 keys
    float s[NS][4];
#pragma unroll
    for (int i = 0; i < NS; ++i) s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DH / 32; ++kk) {  // 32 head dims per step
      uint32_t a0[4], a1[4];
      const bf16* qa = sQ + (warp * 16 + (lane & 15)) * LD + kk * 32 + (lane >> 4) * 8;
      ldmatrix_x4(a0, smem_addr(qa));
      ldmatrix_x4(a1, smem_addr(qa + 16));
#pragma unroll
      for (int nt = 0; nt < NS; ++nt) {
        uint32_t bk[4];
        ldmatrix_x4(bk, smem_addr(sK + (nt * 8 + (lane & 7)) * LD + kk * 32 + (lane >> 3) * 8));
        mma_bf16(s[nt], a0, bk[0], bk[1]);
        mma_bf16(s[nt], a1, bk[2], bk[3]);
      }
    }

    // scale, softcap, mask; row max across the 4 threads sharing a row
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int nt = 0; nt < NS; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + nt * 8 + t4 * 2 + (e & 1);
        const int qp = qpos[e >> 1];
        bool ok = key < k_limit;
        if (causal) ok = ok && key <= qp;
        if (window > 0) ok = ok && key > qp - window;
        const float x = ok ? apply_softcap(s[nt][e] * scale, softcap) : kMask;
        s[nt][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
    }
    const float alpha[2] = {expf(m[0] - mx[0]), expf(m[1] - mx[1])};
    m[0] = mx[0];
    m[1] = mx[1];
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int nt = 0; nt < NS; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = expf(s[nt][e] - mx[e >> 1]);
        s[nt][e] = p;
        rs[e >> 1] += p;
      }
    }
    l[0] = l[0] * alpha[0] + rs[0];  // per-thread partial; summed at the end
    l[1] = l[1] * alpha[1] + rs[1];
#pragma unroll
    for (int i = 0; i < NO; ++i) {
      o[i][0] *= alpha[0];
      o[i][1] *= alpha[0];
      o[i][2] *= alpha[1];
      o[i][3] *= alpha[1];
    }

    // O += P V; the score accumulators are already laid out as the A operand
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      uint32_t a[4];
      a[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      a[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      a[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      a[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int nd = 0; nd < NO / 2; ++nd) {
        uint32_t bv[4];
        ldmatrix_x4_trans(bv, smem_addr(sV + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD +
                                        nd * 16 + (lane >> 4) * 8));
        mma_bf16(o[2 * nd], a, bv[0], bv[1]);
        mma_bf16(o[2 * nd + 1], a, bv[2], bv[3]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }
  const float den[2] = {fmaxf(l[0], 1e-30f), fmaxf(l[1], 1e-30f)};
  bf16* ob = out + ((long)b * T + q0) * q_stride + (long)h * DH;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = row + half * 8;
    if (r >= q_rows) continue;
    bf16* orow = ob + r * q_stride;
#pragma unroll
    for (int nt = 0; nt < NO; ++nt) {
      *reinterpret_cast<uint32_t*>(orow + nt * 8 + t4 * 2) =
          pack_bf16(o[nt][2 * half] / den[half], o[nt][2 * half + 1] / den[half]);
    }
  }
}

template <int DH>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, const int* kv_len,
                       void* out, int B, int T, int S, int H, int Hkv, int causal,
                       int window, float softcap, int q_offset, cudaStream_t stream) {
  constexpr int smem = FwdSmem<DH>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((T + kBQ - 1) / kBQ, H, B);
  flash_fwd_kernel<DH><<<grid, kFwdThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      kv_len, static_cast<bf16*>(out), T, S, H, Hkv, causal, window, softcap,
      1.0f / sqrtf(static_cast<float>(DH)), q_offset);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Decode: grid (Hkv, B), 8 warps; warp w walks keys w*4, w*4 + 32, ... with
// its own online softmax, then the warps' partial results are merged.
// ---------------------------------------------------------------------------
constexpr int kDecWarps = 8;
constexpr int kDecUnroll = 4;

// One lane's 8 head dims of a K/V/q row (16 bytes) as floats.
__device__ __forceinline__ void load_row(const bf16* p, float (&f)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 x = __bfloat1622float2(h[i]);
    f[2 * i] = x.x;
    f[2 * i + 1] = x.y;
  }
}

template <int DH, int G>
__global__ void __launch_bounds__(kDecWarps * 32)
flash_decode_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const int* __restrict__ kv_len,
                    bf16* __restrict__ out, int S, int H, int Hkv, float softcap,
                    float scale) {
  constexpr int EPL = DH / 32;  // head dims per lane
  static_assert(EPL == 8, "load_row reads 8 head dims per lane");
  __shared__ float sm_m[kDecWarps][G];
  __shared__ float sm_l[kDecWarps][G];
  __shared__ float sm_acc[kDecWarps][DH];

  const int hk = blockIdx.x, b = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n = min(S, kv_len[b]);
  const long kv_stride = (long)Hkv * DH;
  const bf16* kb = k + (long)b * S * kv_stride + (long)hk * DH + lane * EPL;
  const bf16* vb = v + (long)b * S * kv_stride + (long)hk * DH + lane * EPL;
  const bf16* qb = q + ((long)b * H + (long)hk * G) * DH + lane * EPL;

  float qf[G][EPL];
#pragma unroll
  for (int gi = 0; gi < G; ++gi) load_row(qb + gi * DH, qf[gi]);
  float m[G], l[G], acc[G][EPL];
#pragma unroll
  for (int gi = 0; gi < G; ++gi) {
    m[gi] = kMask;
    l[gi] = 0.f;
#pragma unroll
    for (int e = 0; e < EPL; ++e) acc[gi][e] = 0.f;
  }

  for (int s0 = warp * kDecUnroll; s0 < n; s0 += kDecWarps * kDecUnroll) {
    float kf[kDecUnroll][EPL], vf[kDecUnroll][EPL];
#pragma unroll
    for (int u = 0; u < kDecUnroll; ++u) {
      if (s0 + u < n) {
        load_row(kb + (s0 + u) * kv_stride, kf[u]);
        load_row(vb + (s0 + u) * kv_stride, vf[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < kDecUnroll; ++u) {
      if (s0 + u >= n) break;  // uniform across the warp
#pragma unroll
      for (int gi = 0; gi < G; ++gi) {
        float dot = 0.f;
#pragma unroll
        for (int e = 0; e < EPL; ++e) dot = fmaf(qf[gi][e], kf[u][e], dot);
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, off);
        const float sc = apply_softcap(dot * scale, softcap);
        const float m_new = fmaxf(m[gi], sc);
        const float alpha = expf(m[gi] - m_new);
        const float p = expf(sc - m_new);
        l[gi] = l[gi] * alpha + p;
#pragma unroll
        for (int e = 0; e < EPL; ++e) acc[gi][e] = fmaf(p, vf[u][e], acc[gi][e] * alpha);
        m[gi] = m_new;
      }
    }
  }

  // merge the warps' (m, l, acc) per query head
  bf16* ob = out + ((long)b * H + (long)hk * G) * DH;
#pragma unroll
  for (int gi = 0; gi < G; ++gi) {
    if (lane == 0) {
      sm_m[warp][gi] = m[gi];
      sm_l[warp][gi] = l[gi];
    }
#pragma unroll
    for (int e = 0; e < EPL; ++e) sm_acc[warp][lane * EPL + e] = acc[gi][e];
    __syncthreads();
    if (threadIdx.x < DH) {
      float mm = kMask;
#pragma unroll
      for (int w = 0; w < kDecWarps; ++w) mm = fmaxf(mm, sm_m[w][gi]);
      float den = 0.f, num = 0.f;
#pragma unroll
      for (int w = 0; w < kDecWarps; ++w) {
        const float f = expf(sm_m[w][gi] - mm);
        den += sm_l[w][gi] * f;
        num += sm_acc[w][threadIdx.x] * f;
      }
      ob[gi * DH + threadIdx.x] = __float2bfloat16_rn(num / fmaxf(den, 1e-30f));
    }
    __syncthreads();
  }
}

template <int DH, int G>
cudaError_t launch_decode(const void* q, const void* k, const void* v, const int* kv_len,
                            void* out, int B, int S, int H, int Hkv, float softcap,
                            cudaStream_t stream) {
  const dim3 grid(Hkv, B);
  flash_decode_kernel<DH, G><<<grid, kDecWarps * 32, 0, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      kv_len, static_cast<bf16*>(out), S, H, Hkv, softcap,
      1.0f / sqrtf(static_cast<float>(DH)));
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// One instance each: dh 256 (prefill, any H / Hkv) and dh 256 with two
// query heads per KV head (decode) -- the shapes of the ported config,
// gemma2-2b.  A later config adds its own instance.
//
// q (B,T,H,dh), k/v (B,S,Hkv,dh), out (B,T,H,dh): bf16, contiguous.
// kv_len: (B,) int32 or NULL.  window <= 0: none.  softcap <= 0: none.
int flash_attn_fwd(const void* q, const void* k, const void* v, const void* kv_len, void* out,
                   int B, int T, int S, int H, int Hkv, int dh, int causal, int window,
                   float softcap, int q_offset, void* stream) {
  const int* kvl = static_cast<const int*>(kv_len);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dh != 256) return cudaErrorInvalidValue;
  return launch_fwd<256>(q, k, v, kvl, out, B, T, S, H, Hkv, causal, window, softcap, q_offset, st);
}

// q (B,1,H,dh), k/v (B,S,Hkv,dh), out (B,1,H,dh): bf16, contiguous.
// kv_len: (B,) int32, required.  softcap <= 0: none.
int flash_attn_decode(const void* q, const void* k, const void* v, const void* kv_len, void* out,
                      int B, int S, int H, int Hkv, int dh, float softcap, void* stream) {
  const int* kvl = static_cast<const int*>(kv_len);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dh != 256 || H != 2 * Hkv) return cudaErrorInvalidValue;
  return launch_decode<256, 2>(q, k, v, kvl, out, B, S, H, Hkv, softcap, st);
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
