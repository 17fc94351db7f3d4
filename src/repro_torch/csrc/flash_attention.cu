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
//   head h / (H / Hkv); KV heads are never repeated.  (A query row with no
//   valid key at all gets 0 here; the reference averages v over every key.)
//
// Instances: prefill at head dims 16, 64, 96, 112, 128 and 256 (any
// H / Hkv); decode
// at the (head dim, query heads a KV head) pairs of the ported configs,
// listed at the C interface below.  The Pallas kernel takes any shape
// through its BlockSpecs; here each shape is a template instance, and the
// Python wrapper names the ones that exist.
//
// What bounds each entry point on an H100, and what the design does about it:
//   * Prefill (T = 1024) does 4*dh flops per valid (q, k) pair: it is bound
//     by tensor-core operations.  Both products run on wgmma, fed by TMA: a
//     block of 384 threads takes 128 query rows of one (batch, head); one
//     producer warp loads the Q tile once and K / V tiles of 64 keys into a
//     two-stage mbarrier ring, while two consumer warpgroups (64 rows each,
//     232 registers after setmaxnreg for the 64 x dh f32 output) run
//     S = Q K^T (both operands in shared memory, K-major) and O += P V (P
//     from registers in the A-operand layout, V MN-major through the
//     transpose bit, one m64n{dh} wgmma a 16-key step).  Shared memory holds
//     every tile as column blocks of CB head dims, CB the widest swizzle
//     atom that divides dh (64 dims in the 128-byte swizzle at dh 64, 128
//     and 256, 32 in the 64-byte swizzle at dh 96, 16 in the 32-byte
//     swizzle at dh 16 and at dh 112, whose 224-byte rows take seven): TMA
//     writes that swizzle and the wgmma descriptors read it, so
//     the layout, the boxes and the descriptors are functions of dh alone.
//     The 4-D tensor maps (dh, heads, seq, batch) zero-fill rows past T or
//     S, so ragged tiles need no padding and never reach the next sequence.
//     Tiles wholly outside the causal / window / kv_len range are never
//     loaded, a warpgroup skips a tile none of its rows sees, and the masks
//     are evaluated only on tiles that cross an edge (at a window below 64
//     keys, every tile the rows see).  The query tiles with the most keys
//     are launched first.
//   * Decode (T = 1) reads every valid K/V byte once and does ~G flops per
//     byte (G query heads a KV head): below G ~ 16 it is bound by memory
//     bytes, so the work is to put every SM to work with enough bytes in
//     flight.  The cache is cut into n_split <= 8 contiguous ranges (a
//     host-side plan from B, Hkv and S alone, so no device-to-host sync):
//     grid (n_split, Hkv, B).  Each block serves all G query heads of its
//     KV head, so each K/V byte is still read once, and streams its rows
//     through a cp.async ring.  The splits of one (batch, KV head) form a
//     thread-block cluster and merge their (m, l, acc) through distributed
//     shared memory inside the same launch: one kernel a call on a
//     host-bound path.
//       - G <= 4 (flash_decode_kernel): the arithmetic stays on the CUDA
//         cores.  A key's row is split over LPK lanes of EPL <= 8 head dims
//         each (one 16-byte load at EPL 8), so a warp reads 32 / LPK keys at
//         once (at dh 112, 14 lanes of 8 dims in a group of 16); a block
//         fits in <= 85 registers and 66 KB of shared memory where
//         G * EPL <= 16, so three share an SM.
//       - G >= 8 (flash_decode_mma_kernel): G query rows per key make the
//         product worth the tensor cores.  The G query heads of a KV head
//         are the M of mma.sync m16n8k16 products (ceil(G / 16) row
//         tiles, the rows past G of the last one zero: at G 8 / 12 one tile
//         half / three quarters filled, at G 24 two), a warp takes one row
//         tile and 16 keys of each 64-key stage, scores and P V on the
//         tensor cores, P kept in registers between them.  (At G 8 the
//         CUDA-core kernel would hold 2 x 64 floats of q and acc a lane.)
//
// C interface: every entry point returns a cudaError_t (0 on success) taken
// with cudaGetLastError() right after the launch; the Python wrapper raises
// on anything else.

#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;
namespace cg = cooperative_groups;

constexpr float kMask = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;  // exp(x) = exp2(x log2 e)

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Two floats -> one register of two bf16; `lo` takes the lower column.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// ---------------------------------------------------------------------------
// Prefill: grid (ceil(T/128), H, B), 384 threads, one block an SM.
// Warpgroups 0 and 1 (consumers) own query rows 0-63 and 64-127 of the
// block's 128-row tile; warpgroup 2 (producer) gives up its registers and
// one of its threads issues the TMA loads: the Q tile once, then K and V
// tiles of 64 keys into a ring of kFwdStages stages, each stage released by
// the consumers through an mbarrier.  Shared memory holds every tile as
// column blocks of FwdSmem<DH>::CB head dims (CBB bytes a row) in TMA's
// CBB-byte swizzle, the layout wgmma reads.
// ---------------------------------------------------------------------------
constexpr int kBQ = 128;            // query rows a block
constexpr int kBK = 64;             // keys a K/V tile
constexpr int kFwdStages = 2;
constexpr int kFwdThreads = 384;
constexpr int kFwdConsumerWarps = 8;

template <int DH>
struct FwdSmem {
  // the widest swizzle atom (128, 64 or 32 bytes) that divides a row
  static constexpr int CB = DH % 64 == 0 ? 64 : DH % 32 == 0 ? 32 : 16;
  static constexpr int CBB = CB * 2;  // bytes a row of a column block
  static constexpr int NCB = DH / CB;
  // wgmma descriptor layout type: 1 = 128-byte, 2 = 64-byte, 3 = 32-byte swizzle
  static constexpr uint64_t SWIZZLE = CBB == 128 ? 1 : CBB == 64 ? 2 : 3;
  static constexpr int Q_BYTES = kBQ * DH * 2;
  static constexpr int KV_BYTES = kBK * DH * 2;  // one K or one V tile
  static constexpr int BARRIERS = 1 + 3 * kFwdStages;
  // + 1024: the dynamic base is aligned up to the largest swizzle's 1024 bytes
  static constexpr int BYTES = Q_BYTES + 2 * kFwdStages * KV_BYTES + 8 * BARRIERS + 1024;
  static_assert(DH % 16 == 0 && DH <= 256, "one m64n{dh} wgmma and 16-dim k-steps");
};

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Spin until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// One box of a 4-D tensor map (head dim, head, position, batch) into shared
// memory; rows past the tensor's end arrive as zeros.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// wgmma shared-memory descriptor of a swizzled layout: start address,
// leading and stride byte offsets in 16-byte units, layout type SWIZZLE.
template <uint64_t SWIZZLE>
__device__ __forceinline__ uint64_t sw_desc(uint32_t saddr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((saddr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) | (static_cast<uint64_t>(sbo >> 4) << 32) |
         (SWIZZLE << 62);
}

// The value itself, opaque to the compiler: a per-tile descriptor base that
// it cannot hoist out of the tile loop as sixteen live 64-bit constants.
__device__ __forceinline__ uint64_t opaque(uint64_t x) {
  asm volatile("mov.b64 %0, %0;\n" : "+l"(x));
  return x;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit_wait() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keeps the compiler from moving reads of an accumulator across the wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x 64, f32) (+)= A (64 x 16, smem) * B (16 x 64, smem), both K-major
// and swizzled (the layout type is in the descriptors); scale_d = 0
// overwrites d.
__device__ __forceinline__ void wgmma_m64n64k16_ss(float (&d)[32], uint64_t desc_a,
                                                   uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// d (64 x N, f32) += A (64 x 16, registers) * B (16 x N, smem), B MN-major
// (the transpose bit set) and swizzled; N = dh, one instance a head dim.
template <int N>
struct WgmmaPV;

template <>
struct WgmmaPV<16> {
  static __device__ __forceinline__ void run(float (&d)[8], const uint32_t (&a)[4], uint64_t desc_b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7"
        "}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
  }
};

template <>
struct WgmmaPV<64> {
  static __device__ __forceinline__ void run(float (&d)[32], const uint32_t (&a)[4], uint64_t desc_b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
        "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
  }
};

template <>
struct WgmmaPV<96> {
  static __device__ __forceinline__ void run(float (&d)[48], const uint32_t (&a)[4], uint64_t desc_b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47"
        "}, {%48, %49, %50, %51}, %52, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
  }
};

template <>
struct WgmmaPV<112> {
  static __device__ __forceinline__ void run(float (&d)[56], const uint32_t (&a)[4], uint64_t desc_b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %61, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n112k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55"
        "}, {%56, %57, %58, %59}, %60, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
  }
};

template <>
struct WgmmaPV<128> {
  static __device__ __forceinline__ void run(float (&d)[64], const uint32_t (&a)[4], uint64_t desc_b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
        "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
  }
};

template <>
struct WgmmaPV<256> {
  static __device__ __forceinline__ void run(float (&d)[128], const uint32_t (&a)[4], uint64_t desc_b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
        "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
        "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
        "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
        "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
        "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
        "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]),
        "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
        "+f"(d[126]), "+f"(d[127])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
  }
};

// A consumer warpgroup's work on one K/V tile of kBK keys for its 64 query
// rows: S = Q K^T (descriptors dq, dk), then softcap, the masks (edge tiles
// only) and the online softmax in registers, then O += P V (descriptor dv,
// once v_bar's phase `ph` has completed).  S[4j + e]: row (e < 2 ? row :
// row + 8), key k0 + 8j + 2 t4 + (e & 1).  `scale` is 1/sqrt(dh), divided
// by the softcap when there is one.
template <int DH>
__device__ __forceinline__ void attn_step(float (&o)[DH / 2], float (&m)[2], float (&l)[2],
                                          uint64_t dq, uint64_t dk, uint64_t dv, uint32_t v_bar,
                                          int ph, int k0, bool edge, const int (&qpos)[2], int t4,
                                          int k_limit, int causal, int window, float softcap,
                                          float scale) {
  static_assert(kBK == 64, "S is one m64n64 wgmma accumulator");
  using L = FwdSmem<DH>;
  constexpr int KPC = L::CB / 16;  // 16-dim k-steps a column block
  float sc[kBK / 2];
#pragma unroll
  for (int j = 0; j < kBK / 2; ++j) sc[j] = 0.f;  // overwritten: scale_d = 0 at kk = 0
  fence_regs(sc);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk) {  // 16 head dims (32 bytes) a step
    const uint32_t a = ((kk / KPC) * kBQ * L::CBB + (kk % KPC) * 32) >> 4;
    const uint32_t b = ((kk / KPC) * kBK * L::CBB + (kk % KPC) * 32) >> 4;
    wgmma_m64n64k16_ss(sc, dq + a, dk + b, kk > 0);
  }
  wgmma_commit_wait();
  fence_regs(sc);

  // row max over the 4 threads that share a row
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int j = 0; j < kBK / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x = softcap > 0.f ? tanhf(sc[4 * j + e] * scale) * softcap : sc[4 * j + e] * scale;
      if (edge) {
        const int key = k0 + 8 * j + 2 * t4 + (e & 1);
        const int qp = qpos[e >> 1];
        bool ok = key < k_limit;
        if (causal) ok = ok && key <= qp;
        if (window > 0) ok = ok && key > qp - window;
        x = ok ? x : kMask;
      }
      sc[4 * j + e] = x;
      mx[e >> 1] = fmaxf(mx[e >> 1], x);
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
  }
  const float alpha[2] = {exp2f((m[0] - mx[0]) * kLog2e), exp2f((m[1] - mx[1]) * kLog2e)};
  // a row whose keys so far are all masked keeps p = 0 (fmaf(-1e30, log2e,
  // 1e30 log2e) need not cancel to 0: exp2 of its rounding error is inf or 0)
  const float mxl[2] = {mx[0] == kMask ? 0.f : mx[0] * kLog2e,
                        mx[1] == kMask ? 0.f : mx[1] * kLog2e};
  m[0] = mx[0];
  m[1] = mx[1];
  float rs[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < kBK / 2; ++j) {
    const float p = exp2f(fmaf(sc[j], kLog2e, -mxl[(j >> 1) & 1]));
    sc[j] = p;
    rs[(j >> 1) & 1] += p;
  }
  l[0] = l[0] * alpha[0] + rs[0];  // per-thread partial; summed at the end
  l[1] = l[1] * alpha[1] + rs[1];
#pragma unroll
  for (int j = 0; j < DH / 2; ++j) o[j] *= alpha[(j >> 1) & 1];

  // P as the A operand: the score accumulator is already in the register
  // layout of A, one 16-key step per four registers
  uint32_t pa[kBK / 16][4];
#pragma unroll
  for (int kk = 0; kk < kBK / 16; ++kk) {
#pragma unroll
    for (int r = 0; r < 4; ++r) pa[kk][r] = pack_bf16(sc[8 * kk + 2 * r], sc[8 * kk + 2 * r + 1]);
  }

  // O += P V: V is MN-major (head dims contiguous); its column blocks are
  // kBK * CBB bytes apart (LBO, in the descriptor), 8-key groups 8 * CBB
  // (SBO); a 16-key step moves 16 rows of CBB bytes
  mbar_wait(v_bar, ph);
  fence_regs(o);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kBK / 16; ++kk) WgmmaPV<DH>::run(o, pa[kk], dv + ((kk * 16 * L::CBB) >> 4));
  wgmma_commit_wait();
  fence_regs(o);
}

template <int DH>
__global__ void __launch_bounds__(kFwdThreads, 1)
flash_fwd_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                 const __grid_constant__ CUtensorMap tm_v, const int* __restrict__ kv_len,
                 bf16* __restrict__ out, int T, int S, int H, int Hkv, int causal, int window,
                 float softcap, float scale, int q_offset) {
  using L = FwdSmem<DH>;
  constexpr int NCB = L::NCB, CB = L::CB, CBB = L::CBB;
  extern __shared__ unsigned char fsmem[];
  const uint32_t raw = smem_addr(fsmem);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t sQ = base;
  const uint32_t sK = base + L::Q_BYTES;                      // + stage * KV_BYTES
  const uint32_t sV = sK + kFwdStages * L::KV_BYTES;          // + stage * KV_BYTES
  const uint32_t bars = sV + kFwdStages * L::KV_BYTES;
  const uint32_t q_full = bars;
  auto k_full = [&](int s) { return bars + 8 * (1 + s); };
  auto v_full = [&](int s) { return bars + 8 * (1 + kFwdStages + s); };
  auto empty = [&](int s) { return bars + 8 * (1 + 2 * kFwdStages + s); };

  // the tiles with the most keys (the last ones, when causal) start first
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const int q_rows = min(kBQ, T - q0);

  // valid keys are < k_limit; the causal bound of the block's last row and
  // the window bound of its first row cut the range of tiles visited
  int k_limit = S;
  if (kv_len != nullptr) k_limit = min(k_limit, kv_len[b]);
  int k_end = k_limit;
  if (causal) k_end = min(k_end, q_offset + q0 + q_rows);
  int k_begin = 0;
  if (window > 0) k_begin = max(0, q_offset + q0 - window + 1);
  k_begin = (k_begin / kBK) * kBK;
  const int n_tiles = k_end > k_begin ? (k_end - k_begin + kBK - 1) / kBK : 0;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kFwdStages; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(v_full(s), 1);
      mbar_init(empty(s), kFwdConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // producer: from here on the roles never meet at a block barrier
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 256) {
      mbar_expect_tx(q_full, L::Q_BYTES);
      for (int c = 0; c < NCB; ++c)
        tma_load(sQ + c * kBQ * CBB, &tm_q, q_full, c * CB, h, q0, b);
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % kFwdStages, k0 = k_begin + i * kBK;
        if (i >= kFwdStages) mbar_wait(empty(s), (i / kFwdStages - 1) & 1);
        mbar_expect_tx(k_full(s), L::KV_BYTES);
        for (int c = 0; c < NCB; ++c)
          tma_load(sK + s * L::KV_BYTES + c * kBK * CBB, &tm_k, k_full(s), c * CB, hk, k0, b);
        mbar_expect_tx(v_full(s), L::KV_BYTES);
        for (int c = 0; c < NCB; ++c)
          tma_load(sV + s * L::KV_BYTES + c * kBK * CBB, &tm_v, v_full(s), c * CB, hk, k0, b);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int lane = threadIdx.x & 31, wwarp = (threadIdx.x >> 5) & 3;
    const int t4 = lane & 3;
    const int row = wg * 64 + wwarp * 16 + (lane >> 2);  // this thread's rows: row, row + 8
    const int qpos[2] = {q_offset + q0 + row, q_offset + q0 + row + 8};
    const int wq_min = q_offset + q0 + wg * 64, wq_max = wq_min + 63;

    float o[DH / 2];
#pragma unroll
    for (int i = 0; i < DH / 2; ++i) o[i] = 0.f;
    float m[2] = {kMask, kMask};
    float l[2] = {0.f, 0.f};

    // the scale folded into the softcap's argument: x = tanh(s * scale / cap) * cap
    const float step_scale = softcap > 0.f ? scale / softcap : scale;
    mbar_wait(q_full, 0);
    for (int i = 0; i < n_tiles; ++i) {
      const int s = i % kFwdStages, ph = (i / kFwdStages) & 1;
      const int k0 = k_begin + i * kBK;
      // a tile that no row of this warpgroup sees is skipped; only tiles
      // that cross the kv_len, causal or window edge are masked
      const bool skip = wg * 64 >= q_rows || (causal && k0 > wq_max) ||
                        (window > 0 && k0 + kBK - 1 <= wq_min - window);
      const bool edge = k0 + kBK > k_limit || (causal && k0 + kBK - 1 > wq_min) ||
                        (window > 0 && k0 <= wq_max - window);
      // even a warpgroup that skips the tile waits for it: its arrival on
      // empty(s) must not fall into the phase of the stage's previous tile
      mbar_wait(k_full(s), ph);
      if (!skip) {
        // the descriptors are the tile's bases plus constants (16-byte
        // units): K-major Q and K (8-row groups 8 * CBB apart), MN-major V
        // (column blocks kBK * CBB apart, 8-key groups 8 * CBB)
        attn_step<DH>(o, m, l,
                      opaque(sw_desc<L::SWIZZLE>(sQ + wg * 64 * CBB, 16, 8 * CBB)),
                      opaque(sw_desc<L::SWIZZLE>(sK + s * L::KV_BYTES, 16, 8 * CBB)),
                      opaque(sw_desc<L::SWIZZLE>(sV + s * L::KV_BYTES, kBK * CBB, 8 * CBB)),
                      v_full(s), ph, k0, edge, qpos, t4, k_limit, causal, window, softcap,
                      step_scale);
      }
      if (lane == 0) mbar_arrive(empty(s));  // this warp is done with stage s
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    }
    const float den[2] = {fmaxf(l[0], 1e-30f), fmaxf(l[1], 1e-30f)};
    const long q_stride = (long)H * DH;
    bf16* ob = out + ((long)b * T + q0) * q_stride + (long)h * DH;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = row + half * 8;
      if (r >= q_rows) continue;
      bf16* orow = ob + r * q_stride;
#pragma unroll
      for (int j = 0; j < DH / 8; ++j) {
        *reinterpret_cast<uint32_t*>(orow + 8 * j + 2 * t4) =
            pack_bf16(o[4 * j + 2 * half] / den[half], o[4 * j + 2 * half + 1] / den[half]);
      }
    }
  }
}

// cuTensorMapEncodeTiled, reached through the runtime so that nothing links
// libcuda.
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                              &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess) return nullptr;
    fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// (batch, seq, heads, dh) bf16 as a 4-D map (dh, heads, seq, batch); boxes
// of CB head dims x 1 head x `rows` positions in the swizzle of CB * 2
// bytes.  Rows past `seq` read as zeros, so a tile never reaches into the
// next sequence.
template <int DH>
cudaError_t make_map(CUtensorMap* map, const void* ptr, int batch, int seq, int heads, int rows) {
  using L = FwdSmem<DH>;
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return cudaErrorSymbolNotFound;
  const cuuint64_t dims[4] = {(cuuint64_t)DH, (cuuint64_t)heads, (cuuint64_t)seq,
                              (cuuint64_t)batch};
  const cuuint64_t strides[3] = {(cuuint64_t)DH * 2, (cuuint64_t)heads * DH * 2,
                                 (cuuint64_t)seq * heads * DH * 2};
  const cuuint32_t box[4] = {(cuuint32_t)L::CB, 1, (cuuint32_t)rows, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUtensorMapSwizzle swizzle = L::CBB == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
                                     : L::CBB == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                                    : CU_TENSOR_MAP_SWIZZLE_32B;
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
                        strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int DH>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, const int* kv_len,
                       void* out, int B, int T, int S, int H, int Hkv, int causal,
                       int window, float softcap, int q_offset, cudaStream_t stream) {
  constexpr int smem = FwdSmem<DH>::BYTES;
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_kernel<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    attr_set = true;
  }
  CUtensorMap tm_q, tm_k, tm_v;
  cudaError_t err = make_map<DH>(&tm_q, q, B, T, H, kBQ);
  if (err == cudaSuccess) err = make_map<DH>(&tm_k, k, B, S, Hkv, kBK);
  if (err == cudaSuccess) err = make_map<DH>(&tm_v, v, B, S, Hkv, kBK);
  if (err != cudaSuccess) return err;
  const dim3 grid((T + kBQ - 1) / kBQ, H, B);
  flash_fwd_kernel<DH><<<grid, kFwdThreads, smem, stream>>>(
      tm_q, tm_k, tm_v, kv_len, static_cast<bf16*>(out), T, S, H, Hkv, causal, window, softcap,
      1.0f / sqrtf(static_cast<float>(DH)), q_offset);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Decode: grid (n_split, Hkv, B), one thread-block cluster of n_split blocks
// along x per (batch, KV head).  Block `split` streams the cache slots
// [split * chunk, min((split + 1) * chunk, kv_len[b])) through a ring of
// K and V rows (cp.async, 16 bytes a thread), serving all G query heads of
// its KV head; the block merges its warps into one (m, l, acc) partial,
// then the cluster's blocks share the outputs, each merging every block's
// partial through distributed shared memory (cluster_merge).
// ---------------------------------------------------------------------------
constexpr int kDecMaxSplit = 8;  // the portable cluster size

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The splits' merge: the blocks of the cluster share the G * DH outputs,
// each reading every block's partial (part_m, part_l, part_acc, written
// before the call); an empty split has m = -1e30 and l = acc = 0, so its
// weight exp(m - M) is 0 (or, when every split is empty, the output is
// 0 / 1e-30 = 0).
template <int G, int DH, int THREADS>
__device__ __forceinline__ void cluster_merge(cg::cluster_group& cluster, float (&part_m)[G],
                                              float (&part_l)[G], float (&part_acc)[G][DH],
                                              bf16* __restrict__ ob) {
  cluster.sync();
  const int n_split = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  for (int i = rank * THREADS + threadIdx.x; i < G * DH; i += n_split * THREADS) {
    const int gi = i / DH, d = i % DH;
    float mr[kDecMaxSplit];
    float mm = kMask;
#pragma unroll
    for (int r = 0; r < kDecMaxSplit; ++r) {
      mr[r] = r < n_split ? *cluster.map_shared_rank(&part_m[gi], r) : kMask;
      mm = fmaxf(mm, mr[r]);
    }
    float den = 0.f, num = 0.f;
#pragma unroll
    for (int r = 0; r < kDecMaxSplit; ++r) {
      if (r < n_split) {
        const float f = exp2f((mr[r] - mm) * kLog2e);
        den += *cluster.map_shared_rank(&part_l[gi], r) * f;
        num += *cluster.map_shared_rank(&part_acc[gi][d], r) * f;
      }
    }
    ob[gi * DH + d] = __float2bfloat16_rn(num / fmaxf(den, 1e-30f));
  }
  cluster.sync();  // no block leaves while another still reads its partial
}

// -- G <= 4: the CUDA cores ------------------------------------------------
// Warp w reads, in each ring stage, 2 keys for each of its KPW sub-warps of
// LPK lanes: sub-warp j takes rows 2 (w KPW + j) and 2 (w KPW + j) + 1, a
// lane EPL head dims of each, and keeps its own online softmax; the
// sub-warps merge by shuffles, the warps through shared memory.
constexpr int kDecWarps = 8;
constexpr int kDecThreads = kDecWarps * 32;
constexpr int kDecStages = 4;

// Lanes a key: the fewest (a power of two) that leave each lane at most 8
// head dims in whole bf16 pairs, one 16-byte load at 8.  Where no power of
// two does (dh 112: 16 lanes of 7), a key takes dh / 8 lanes of 8 dims and
// its group is padded to the next power of two, whose last lanes hold
// zeros (dh 112: 14 lanes of 16), so the shuffles still reduce over a
// power of two.
constexpr bool whole_pairs(int dh, int l) { return dh % l == 0 && dh / l <= 8 && (dh / l) % 2 == 0; }

constexpr int lanes_per_key(int dh) {
  int l = 1;
  while (l < 32 && !whole_pairs(dh, l)) l *= 2;
  if (whole_pairs(dh, l)) return l;
  l = 1;
  while (l < dh / 8) l *= 2;
  return l;
}

constexpr int dims_per_lane(int dh) {
  return whole_pairs(dh, lanes_per_key(dh)) ? dh / lanes_per_key(dh) : 8;
}

template <int DH, int G>
struct DecSmem {
  static constexpr int LPK = lanes_per_key(DH);
  static constexpr int EPL = dims_per_lane(DH);   // head dims a lane
  static constexpr int ACTIVE = DH / EPL;         // lanes of a key's group that hold dims
  static constexpr int KPW = 32 / LPK;             // sub-warps a warp
  static constexpr int TILE = kDecWarps * 2 * KPW;  // keys a ring stage
  // ring: [stage][K, V][TILE][DH] bf16
  static constexpr int STAGE_ELEMS = 2 * TILE * DH;
  static constexpr int BYTES = kDecStages * STAGE_ELEMS * 2;
  // three blocks an SM (<= 85 registers) where a lane's q and acc fit, two
  // otherwise
  static constexpr int MIN_BLOCKS = G * EPL <= 16 ? 3 : 2;
  static_assert(LPK <= 32 && ACTIVE <= LPK && EPL % 2 == 0 && DH % 8 == 0,
                "lanes of whole bf16 pairs");
  static_assert(BYTES >= (kDecWarps * G * (DH + 2)) * 4, "warp partials reuse the ring");
};

// One lane's EPL head dims of a K/V/q row as floats: one 16-byte load at
// EPL 8, 4-byte loads otherwise.
template <int EPL>
__device__ __forceinline__ void load_row(const bf16* p, float (&f)[EPL]) {
  if constexpr (EPL == 8) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 x = __bfloat1622float2(h[i]);
      f[2 * i] = x.x;
      f[2 * i + 1] = x.y;
    }
  } else {
#pragma unroll
    for (int i = 0; i < EPL / 2; ++i) {
      const float2 x = __bfloat1622float2(reinterpret_cast<const __nv_bfloat162*>(p)[i]);
      f[2 * i] = x.x;
      f[2 * i + 1] = x.y;
    }
  }
}

template <int DH, int G>
__global__ void __launch_bounds__(kDecThreads, DecSmem<DH, G>::MIN_BLOCKS)
flash_decode_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const int* __restrict__ kv_len,
                    bf16* __restrict__ out, int S, int H, int Hkv, int chunk, float softcap,
                    float scale) {
  using L = DecSmem<DH, G>;
  constexpr int EPL = L::EPL, LPK = L::LPK, KPW = L::KPW, TILE = L::TILE;
  constexpr int CHUNKS = DH / 8;  // 16-byte pieces of a row
  extern __shared__ __align__(16) unsigned char dsmem[];
  bf16* ring = reinterpret_cast<bf16*>(dsmem);
  // this block's merged partial, read by every block of the cluster
  __shared__ float part_m[G], part_l[G];
  __shared__ __align__(16) float part_acc[G][DH];

  cg::cluster_group cluster = cg::this_cluster();
  const int split = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int sub = lane / LPK, li = lane % LPK;
  const bool on = li < L::ACTIVE;  // this lane holds head dims (the others zeros)
  const int n = min(S, kv_len[b]);
  const int s_begin = split * chunk;
  const int s_end = min(n, s_begin + chunk);  // empty split: s_end <= s_begin
  const int n_tiles = s_end > s_begin ? (s_end - s_begin + TILE - 1) / TILE : 0;
  const long kv_stride = (long)Hkv * DH;
  const bf16* kb = k + (long)b * S * kv_stride + (long)hk * DH;
  const bf16* vb = v + (long)b * S * kv_stride + (long)hk * DH;

  // K and V rows of tile t into ring stage t % kDecStages; rows past s_end
  // are not loaded (and never read)
  auto issue = [&](int t) {
    if (t < n_tiles) {
      bf16* stage = ring + (t % kDecStages) * L::STAGE_ELEMS;
      for (int c = threadIdx.x; c < 2 * TILE * CHUNKS; c += kDecThreads) {
        const int which = c / (TILE * CHUNKS);
        const int r = (c / CHUNKS) % TILE, col = (c % CHUNKS) * 8;
        const int key = s_begin + t * TILE + r;
        if (key < s_end) {
          const bf16* src = (which ? vb : kb) + key * kv_stride + col;
          cp_async16(stage + (which * TILE + r) * DH + col, src);
        }
      }
    }
    cp_async_commit();  // one group per tile, empty or not
  };

#pragma unroll
  for (int t = 0; t < kDecStages - 1; ++t) issue(t);

  const bf16* qb = q + ((long)b * H + (long)hk * G) * DH + li * EPL;
  float qf[G][EPL];
#pragma unroll
  for (int gi = 0; gi < G; ++gi) {
    if (on) {
      load_row<EPL>(qb + gi * DH, qf[gi]);
    } else {
#pragma unroll
      for (int e = 0; e < EPL; ++e) qf[gi][e] = 0.f;
    }
  }
  float m[G], l[G], acc[G][EPL];
#pragma unroll
  for (int gi = 0; gi < G; ++gi) {
    m[gi] = kMask;
    l[gi] = 0.f;
#pragma unroll
    for (int e = 0; e < EPL; ++e) acc[gi][e] = 0.f;
  }

  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait<kDecStages - 2>();  // tile t has landed (this thread's part)
    __syncthreads();                  // ... every thread's; stage t-1 is free
    issue(t + kDecStages - 1);
    const int warp_key = s_begin + t * TILE + 2 * warp * KPW;
    if (warp_key >= s_end) continue;  // uniform across the warp
    // this sub-warp's two rows of the tile, updated together: one rescale
    // of (l, acc) for both keys, the dot products reduced side by side; a
    // row past s_end (never loaded) reads as zeros and weighs nothing
    const bf16* stage = ring + (t % kDecStages) * L::STAGE_ELEMS;
    const int r0 = 2 * (warp * KPW + sub), key0 = s_begin + t * TILE + r0;
    const bool has0 = key0 < s_end, has1 = key0 + 1 < s_end;
    // scores first (K rows), then the V rows: the two are never live at once
    float p[G][2], alpha[G];
    {
      float kf[2][EPL];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        if (on && (i == 0 ? has0 : has1)) {
          load_row<EPL>(stage + (r0 + i) * DH + li * EPL, kf[i]);
        } else {  // the slot was not loaded: keep its garbage out of the dot
#pragma unroll
          for (int e = 0; e < EPL; ++e) kf[i][e] = 0.f;
        }
      }
      float dot[G][2];
#pragma unroll
      for (int gi = 0; gi < G; ++gi) {
        dot[gi][0] = dot[gi][1] = 0.f;
#pragma unroll
        for (int e = 0; e < EPL; ++e) {
          dot[gi][0] = fmaf(qf[gi][e], kf[0][e], dot[gi][0]);
          dot[gi][1] = fmaf(qf[gi][e], kf[1][e], dot[gi][1]);
        }
      }
#pragma unroll
      for (int off = LPK / 2; off > 0; off >>= 1) {
#pragma unroll
        for (int gi = 0; gi < G; ++gi) {
          dot[gi][0] += __shfl_xor_sync(0xffffffffu, dot[gi][0], off);
          dot[gi][1] += __shfl_xor_sync(0xffffffffu, dot[gi][1], off);
        }
      }
#pragma unroll
      for (int gi = 0; gi < G; ++gi) {
        if (!has0) {  // a sub-warp past the end changes nothing
          alpha[gi] = 1.f;
          p[gi][0] = p[gi][1] = 0.f;
          continue;
        }
        const float s0 = softcap > 0.f ? tanhf(dot[gi][0] * scale) * softcap : dot[gi][0] * scale;
        const float s1 = !has1 ? kMask : softcap > 0.f ? tanhf(dot[gi][1] * scale) * softcap
                                                       : dot[gi][1] * scale;
        const float m_new = fmaxf(m[gi], fmaxf(s0, s1));
        const float ml = m_new * kLog2e;
        alpha[gi] = exp2f(fmaf(m[gi], kLog2e, -ml));
        p[gi][0] = exp2f(fmaf(s0, kLog2e, -ml));
        p[gi][1] = has1 ? exp2f(fmaf(s1, kLog2e, -ml)) : 0.f;
        l[gi] = l[gi] * alpha[gi] + p[gi][0] + p[gi][1];
        m[gi] = m_new;
      }
    }
    float vf[2][EPL];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if (on && (i == 0 ? has0 : has1)) {
        load_row<EPL>(stage + (TILE + r0 + i) * DH + li * EPL, vf[i]);
      } else {  // p is 0, but 0 * garbage could be NaN
#pragma unroll
        for (int e = 0; e < EPL; ++e) vf[i][e] = 0.f;
      }
    }
#pragma unroll
    for (int gi = 0; gi < G; ++gi) {
#pragma unroll
      for (int e = 0; e < EPL; ++e)
        acc[gi][e] = fmaf(p[gi][1], vf[1][e], fmaf(p[gi][0], vf[0][e], acc[gi][e] * alpha[gi]));
    }
  }
  // merge the warp's sub-warps: lanes li, li + LPK, ... hold the same head
  // dims of different keys
#pragma unroll
  for (int off = LPK; off < 32; off <<= 1) {
#pragma unroll
    for (int gi = 0; gi < G; ++gi) {
      const float mo = __shfl_xor_sync(0xffffffffu, m[gi], off);
      const float lo = __shfl_xor_sync(0xffffffffu, l[gi], off);
      const float mn = fmaxf(m[gi], mo);
      const float fa = exp2f((m[gi] - mn) * kLog2e), fb = exp2f((mo - mn) * kLog2e);
      l[gi] = l[gi] * fa + lo * fb;
#pragma unroll
      for (int e = 0; e < EPL; ++e) {
        const float ao = __shfl_xor_sync(0xffffffffu, acc[gi][e], off);
        acc[gi][e] = acc[gi][e] * fa + ao * fb;
      }
      m[gi] = mn;
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free: reuse it for the warps' partials

  // merge the warps' (m, l, acc) into the block's partial
  float* w_m = reinterpret_cast<float*>(dsmem);  // [kDecWarps][G]
  float* w_l = w_m + kDecWarps * G;               // [kDecWarps][G]
  float* w_acc = w_l + kDecWarps * G;             // [kDecWarps][G][DH]
  if (sub == 0) {
#pragma unroll
    for (int gi = 0; gi < G; ++gi) {
      if (lane == 0) {
        w_m[warp * G + gi] = m[gi];
        w_l[warp * G + gi] = l[gi];
      }
      if (on) {
#pragma unroll
        for (int e = 0; e < EPL; ++e) w_acc[(warp * G + gi) * DH + li * EPL + e] = acc[gi][e];
      }
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < G * DH; i += kDecThreads) {
    const int gi = i / DH, d = i % DH;
    float mm = kMask;
#pragma unroll
    for (int w = 0; w < kDecWarps; ++w) mm = fmaxf(mm, w_m[w * G + gi]);
    float den = 0.f, num = 0.f;
#pragma unroll
    for (int w = 0; w < kDecWarps; ++w) {
      const float f = exp2f((w_m[w * G + gi] - mm) * kLog2e);
      den += w_l[w * G + gi] * f;
      num += w_acc[(w * G + gi) * DH + d] * f;
    }
    part_acc[gi][d] = num;
    if (d == 0) {
      part_m[gi] = mm;
      part_l[gi] = den;
    }
  }
  cluster_merge<G, DH, kDecThreads>(cluster, part_m, part_l, part_acc,
                                    out + ((long)b * H + (long)hk * G) * DH);
}

// -- G >= 8: the tensor cores ----------------------------------------------
// mma.sync m16n8k16 (bf16 in, f32 accumulate).  Fragments, with g = lane / 4
// and t = lane % 4: A (16 x 16) {row g, cols 2t, 2t+1}, {row g+8, 2t..},
// {row g, 2t+8..}, {row g+8, 2t+8..}; B (16 x 8) {rows 2t, 2t+1 of col g},
// {rows 2t+8, 2t+9 of col g}; C (16 x 8) {row g, cols 2t, 2t+1}, {row g+8,
// cols 2t, 2t+1}.  Warp w takes row tile w % MT (16 of the G query heads)
// and keys [16 (w / MT), 16 (w / MT) + 16) of each 64-key stage: S = Q K^T
// as two n8 products per k-step (K rows give B directly), P from the two
// S accumulators as the A operand of P V (the FlashAttention-2 register
// reuse; P as a hi + lo pair, two products), V's B fragments through
// ldmatrix.trans.  Rows past the end are zero-filled in shared memory, and
// rows are padded by 16 bytes so that neither read meets a bank conflict.
constexpr int kMmaKeys = 64;       // keys a ring stage
constexpr int kMmaKeyGroups = kMmaKeys / 16;
constexpr int kMmaStages = 3;

template <int DH, int G>
struct DecMmaSmem {
  static constexpr int MT = (G + 15) / 16;  // row tiles of query heads (G 8 / 12: one, part filled; 24: two)
  static constexpr int WARPS = MT * kMmaKeyGroups;
  static constexpr int THREADS = WARPS * 32;
  static constexpr int PITCH = DH + 8;  // elements a row in shared memory
  static constexpr int STAGE_ELEMS = 2 * kMmaKeys * PITCH;
  static constexpr int RING_BYTES = kMmaStages * STAGE_ELEMS * 2;
  static constexpr int PART_BYTES = WARPS * 16 * (DH + 2) * 4;
  static constexpr int BYTES = RING_BYTES > PART_BYTES ? RING_BYTES : PART_BYTES;
  static_assert(G >= 8 && G % 4 == 0 && DH % 16 == 0 && THREADS <= 1024,
                "16-row tiles (the rows past G of the last tile zero), 16-dim steps");
};

__device__ __forceinline__ void mma_bf16_16816(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                               uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// (a, b) as hi + lo bf16 pairs: hi = bf16(x), lo = bf16(x - hi); `a` takes
// the lower half of each register.
__device__ __forceinline__ void split_bf16(float a, float b, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 f = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(a - f.x, b - f.y);
}

// Four 8 x 8 bf16 matrices, transposed: lane l gives the address of row
// l % 8 of matrix l / 8 and receives {M[2t][g], M[2t+1][g]} of each.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

template <int DH, int G>
__global__ void __launch_bounds__(DecMmaSmem<DH, G>::THREADS, 1)
flash_decode_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, const int* __restrict__ kv_len,
                        bf16* __restrict__ out, int S, int H, int Hkv, int chunk,
                        float softcap, float scale) {
  using L = DecMmaSmem<DH, G>;
  constexpr int MT = L::MT, WARPS = L::WARPS, THREADS = L::THREADS, PITCH = L::PITCH;
  constexpr int KSTEPS = DH / 16, NT = DH / 8, CHUNKS = DH / 8;
  extern __shared__ __align__(16) unsigned char dsmem[];
  bf16* ring = reinterpret_cast<bf16*>(dsmem);
  __shared__ float part_m[G], part_l[G];
  __shared__ __align__(16) float part_acc[G][DH];

  cg::cluster_group cluster = cg::this_cluster();
  const int split = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int mt = warp % MT, kg = warp / MT;
  const int n = min(S, kv_len[b]);
  const int s_begin = split * chunk;
  const int s_end = min(n, s_begin + chunk);
  const int n_tiles = s_end > s_begin ? (s_end - s_begin + kMmaKeys - 1) / kMmaKeys : 0;
  const long kv_stride = (long)Hkv * DH;
  const bf16* kb = k + (long)b * S * kv_stride + (long)hk * DH;
  const bf16* vb = v + (long)b * S * kv_stride + (long)hk * DH;

  auto issue = [&](int t) {
    if (t < n_tiles) {
      bf16* stage = ring + (t % kMmaStages) * L::STAGE_ELEMS;
      for (int c = threadIdx.x; c < 2 * kMmaKeys * CHUNKS; c += THREADS) {
        const int which = c / (kMmaKeys * CHUNKS);
        const int r = (c / CHUNKS) % kMmaKeys, col = (c % CHUNKS) * 8;
        const int key = s_begin + t * kMmaKeys + r;
        bf16* dst = stage + (which * kMmaKeys + r) * PITCH + col;
        if (key < s_end) {
          cp_async16(dst, (which ? vb : kb) + key * kv_stride + col);
        } else {  // zeros past the end: P is 0 there, but 0 * garbage may be NaN
          *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
        }
      }
    }
    cp_async_commit();
  };

#pragma unroll
  for (int t = 0; t < kMmaStages - 1; ++t) issue(t);

  // this warp's 16 query rows as A fragments, one per 16-dim k-step; rows
  // past G (the upper half of G 8's one tile) are zeros, their outputs
  // never written
  const bool has_r0 = mt * 16 + g < G, has_r1 = mt * 16 + g + 8 < G;
  const bf16* q0 = q + ((long)b * H + (long)hk * G + mt * 16 + g) * DH + 2 * t4;
  const bf16* q1 = q0 + 8 * DH;
  uint32_t qa[KSTEPS][4];
#pragma unroll
  for (int kk = 0; kk < KSTEPS; ++kk) {
    qa[kk][0] = has_r0 ? *reinterpret_cast<const uint32_t*>(q0 + 16 * kk) : 0u;
    qa[kk][1] = has_r1 ? *reinterpret_cast<const uint32_t*>(q1 + 16 * kk) : 0u;
    qa[kk][2] = has_r0 ? *reinterpret_cast<const uint32_t*>(q0 + 16 * kk + 8) : 0u;
    qa[kk][3] = has_r1 ? *reinterpret_cast<const uint32_t*>(q1 + 16 * kk + 8) : 0u;
  }
  float o[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  float m[2] = {kMask, kMask}, l[2] = {0.f, 0.f};

  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait<kMmaStages - 2>();
    __syncthreads();
    issue(t + kMmaStages - 1);
    const int key_first = s_begin + t * kMmaKeys + 16 * kg;
    if (key_first >= s_end) continue;  // uniform across the warp
    const bf16* sk = ring + (t % kMmaStages) * L::STAGE_ELEMS + 16 * kg * PITCH;
    const bf16* sv = sk + kMmaKeys * PITCH;
    // S = Q K^T over this warp's 16 keys: two n8 tiles
    float sc[2][4];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      sc[h][0] = sc[h][1] = sc[h][2] = sc[h][3] = 0.f;
      const bf16* krow = sk + (8 * h + g) * PITCH + 2 * t4;
#pragma unroll
      for (int kk = 0; kk < KSTEPS; ++kk)
        mma_bf16_16816(sc[h], qa[kk], *reinterpret_cast<const uint32_t*>(krow + 16 * kk),
                       *reinterpret_cast<const uint32_t*>(krow + 16 * kk + 8));
    }
    // softcap, the kv edge (every row sees the same keys, and the first is
    // valid), the online softmax over the quad that shares a row
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float s = sc[h][e];
        float x = softcap > 0.f ? tanhf(s * scale) * softcap : s * scale;
        x = key_first + 8 * h + 2 * t4 + (e & 1) < s_end ? x : kMask;
        sc[h][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    }
    const float alpha[2] = {exp2f((m[0] - mx[0]) * kLog2e), exp2f((m[1] - mx[1]) * kLog2e)};
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(fmaf(sc[h][e], kLog2e, -mx[e >> 1] * kLog2e));
        sc[h][e] = p;
        rs[e >> 1] += p;
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] = l[r] * alpha[r] + rs[r];  // per-thread partial; summed at the end
      m[r] = mx[r];
    }
    // P (16 rows x 16 keys) as the A operand, as a hi + lo pair of bf16
    // (P = hi + lo to 2^-16): the product then keeps P's f32 precision to
    // the decode tolerance, as the CUDA-core instances do
    uint32_t pa[4], pl[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) split_bf16(sc[r >> 1][2 * (r & 1)], sc[r >> 1][2 * (r & 1) + 1],
                                           pa[r], pl[r]);
    // O += P V, two n8 tiles of head dims a ldmatrix: matrices (keys 0-7,
    // dims j), (keys 8-15, dims j), (keys 0-7, dims j + 8), (keys 8-15, j + 8)
    const int mi = lane >> 3;
    const uint32_t vaddr = smem_addr(sv + ((mi & 1) * 8 + (lane & 7)) * PITCH + (mi >> 1) * 8);
#pragma unroll
    for (int j = 0; j < NT; j += 2) {
      uint32_t vb4[4];
      ldmatrix_x4_trans(vb4, vaddr + j * 8 * 2);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        o[j][e] *= alpha[e >> 1];
        o[j + 1][e] *= alpha[e >> 1];
      }
      mma_bf16_16816(o[j], pa, vb4[0], vb4[1]);
      mma_bf16_16816(o[j], pl, vb4[0], vb4[1]);
      mma_bf16_16816(o[j + 1], pa, vb4[2], vb4[3]);
      mma_bf16_16816(o[j + 1], pl, vb4[2], vb4[3]);
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free: reuse it for the warps' partials

  float* w_m = reinterpret_cast<float*>(dsmem);  // [WARPS][16]
  float* w_l = w_m + WARPS * 16;                  // [WARPS][16]
  float* w_acc = w_l + WARPS * 16;                // [WARPS][16][DH]
  if (t4 == 0) {
    w_m[warp * 16 + g] = m[0];
    w_m[warp * 16 + g + 8] = m[1];
    w_l[warp * 16 + g] = l[0];
    w_l[warp * 16 + g + 8] = l[1];
  }
#pragma unroll
  for (int j = 0; j < NT; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      w_acc[(warp * 16 + g + (e >> 1) * 8) * DH + 8 * j + 2 * t4 + (e & 1)] = o[j][e];
  }
  __syncthreads();
  // merge the key groups of each row tile into the block's partial
  for (int i = threadIdx.x; i < G * DH; i += THREADS) {
    const int gi = i / DH, d = i % DH;
    const int tile = gi / 16, r = gi % 16;
    float mm = kMask;
#pragma unroll
    for (int kq = 0; kq < kMmaKeyGroups; ++kq) mm = fmaxf(mm, w_m[(kq * MT + tile) * 16 + r]);
    float den = 0.f, num = 0.f;
#pragma unroll
    for (int kq = 0; kq < kMmaKeyGroups; ++kq) {
      const int w = kq * MT + tile;
      const float f = exp2f((w_m[w * 16 + r] - mm) * kLog2e);
      den += w_l[w * 16 + r] * f;
      num += w_acc[(w * 16 + r) * DH + d] * f;
    }
    part_acc[gi][d] = num;
    if (d == 0) {
      part_m[gi] = mm;
      part_l[gi] = den;
    }
  }
  cluster_merge<G, DH, THREADS>(cluster, part_m, part_l, part_acc,
                                out + ((long)b * H + (long)hk * G) * DH);
}

// The decode instance's kernel: the tensor-core one at G >= 8.
template <int DH, int G, bool MMA = (G >= 8)>
struct DecodeInstance;

template <int DH, int G>
struct DecodeInstance<DH, G, true> {
  static constexpr bool MMA = true;
  static constexpr int THREADS = DecMmaSmem<DH, G>::THREADS;
  static constexpr int SMEM = DecMmaSmem<DH, G>::BYTES;
  static const void* kernel() {
    return reinterpret_cast<const void*>(flash_decode_mma_kernel<DH, G>);
  }
};

template <int DH, int G>
struct DecodeInstance<DH, G, false> {
  static constexpr bool MMA = false;
  static constexpr int THREADS = kDecThreads;
  static constexpr int SMEM = DecSmem<DH, G>::BYTES;
  static const void* kernel() { return reinterpret_cast<const void*>(flash_decode_kernel<DH, G>); }
};

// The decode kernel's launch: grid (n_split, Hkv, B), clusters of n_split
// along x, the ring as dynamic shared memory (attributes set once).
template <int DH, int G>
cudaError_t decode_config(cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr, int B, int Hkv,
                          int n_split, cudaStream_t stream) {
  using I = DecodeInstance<DH, G>;
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t err =
        cudaFuncSetAttribute(I::kernel(), cudaFuncAttributeMaxDynamicSharedMemorySize, I::SMEM);
    // all of the SM's 228 KB as shared memory: room for more blocks
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(I::kernel(), cudaFuncAttributePreferredSharedMemoryCarveout,
                                 cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return err;
    attr_set = true;
  }
  if (n_split < 1 || n_split > kDecMaxSplit) return cudaErrorInvalidValue;
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(n_split, Hkv, B);
  cfg->blockDim = dim3(I::THREADS);
  cfg->dynamicSmemBytes = I::SMEM;
  cfg->stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = n_split;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return cudaSuccess;
}

template <int DH, int G>
cudaError_t launch_decode(const void* q, const void* k, const void* v, const int* kv_len,
                          void* out, int B, int S, int H, int Hkv, int n_split, int chunk,
                          float softcap, cudaStream_t stream) {
  if (chunk < 1) return cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = decode_config<DH, G>(&cfg, &attr, B, Hkv, n_split, stream);
  if (err != cudaSuccess) return err;
  const bf16* qp = static_cast<const bf16*>(q);
  const bf16* kp = static_cast<const bf16*>(k);
  const bf16* vp = static_cast<const bf16*>(v);
  bf16* op = static_cast<bf16*>(out);
  // the scale folded into the softcap's argument: tanh(s * scale / cap) * cap
  const float scale = softcap > 0.f ? 1.0f / (sqrtf(static_cast<float>(DH)) * softcap)
                                    : 1.0f / sqrtf(static_cast<float>(DH));
  if constexpr (DecodeInstance<DH, G>::MMA) {
    err = cudaLaunchKernelEx(&cfg, flash_decode_mma_kernel<DH, G>, qp, kp, vp, kv_len, op, S, H,
                             Hkv, chunk, softcap, scale);
  } else {
    err = cudaLaunchKernelEx(&cfg, flash_decode_kernel<DH, G>, qp, kp, vp, kv_len, op, S, H, Hkv,
                             chunk, softcap, scale);
  }
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <int DH, int G>
cudaError_t max_clusters(int n_split, int* clusters) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = decode_config<DH, G>(&cfg, &attr, 1, 1, n_split, nullptr);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveClusters(clusters, DecodeInstance<DH, G>::kernel(), &cfg);
}

}  // namespace

// The instances: prefill at every head dim of the ported configs, decode at
// every (head dim, query heads a KV head) pair.  The Python wrapper's
// HEAD_DIMS and DECODE_INSTANCES name the same ones.
#define REPRO_FWD_INSTANCES(X) X(16) X(64) X(96) X(112) X(128) X(256)
#define REPRO_DECODE_INSTANCES(X)                                                    \
  X(16, 1) X(16, 2) X(16, 4) X(64, 1) X(96, 1) X(112, 1) X(128, 1) X(128, 4) X(128, 8) \
  X(128, 12) X(128, 16) X(128, 24) X(128, 48) X(256, 2)

extern "C" {

// q (B,T,H,dh), k/v (B,S,Hkv,dh), out (B,T,H,dh): bf16, contiguous.
// kv_len: (B,) int32 or NULL.  window <= 0: none.  softcap <= 0: none.
int flash_attn_fwd(const void* q, const void* k, const void* v, const void* kv_len, void* out,
                   int B, int T, int S, int H, int Hkv, int dh, int causal, int window,
                   float softcap, int q_offset, void* stream) {
  const int* kvl = static_cast<const int*>(kv_len);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define REPRO_FWD_CASE(D)                                                                   \
  if (dh == D)                                                                              \
    return launch_fwd<D>(q, k, v, kvl, out, B, T, S, H, Hkv, causal, window, softcap, q_offset, \
                         st);
  REPRO_FWD_INSTANCES(REPRO_FWD_CASE)
#undef REPRO_FWD_CASE
  return cudaErrorInvalidValue;
}

// q (B,1,H,dh), k/v (B,S,Hkv,dh), out (B,1,H,dh): bf16, contiguous.
// kv_len: (B,) int32, required.  softcap <= 0: none.  The cache slots are cut
// into n_split (1..8) ranges of `chunk` slots (decode_split_plan in the launcher).
int flash_attn_decode(const void* q, const void* k, const void* v, const void* kv_len, void* out,
                      int B, int S, int H, int Hkv, int dh, int n_split, int chunk, float softcap,
                      void* stream) {
  const int* kvl = static_cast<const int*>(kv_len);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (Hkv < 1 || H % Hkv) return cudaErrorInvalidValue;
  const int G = H / Hkv;
#define REPRO_DECODE_CASE(D, GG)                                                             \
  if (dh == D && G == GG)                                                                    \
    return launch_decode<D, GG>(q, k, v, kvl, out, B, S, H, Hkv, n_split, chunk, softcap, st);
  REPRO_DECODE_INSTANCES(REPRO_DECODE_CASE)
#undef REPRO_DECODE_CASE
  return cudaErrorInvalidValue;
}

// How many of flash_attn_decode's clusters of n_split blocks the card holds
// at once for the (dh, G) instance (cudaOccupancyMaxActiveClusters): a
// diagnostic for the split plan.
int flash_attn_decode_max_clusters(int n_split, int dh, int G, int* clusters) {
#define REPRO_CLUSTERS_CASE(D, GG) \
  if (dh == D && G == GG) return max_clusters<D, GG>(n_split, clusters);
  REPRO_DECODE_INSTANCES(REPRO_CLUSTERS_CASE)
#undef REPRO_CLUSTERS_CASE
  return cudaErrorInvalidValue;
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
