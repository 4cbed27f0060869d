// Sliding-window (banded, causal or not) GQA flash attention for Hopper
// (sm_90a), bf16 route: the forward kernel, the D pre-pass and the two
// kernels of its gradient, on the tensor cores.
//
// Replaces the TPU kernel repro/kernels/swa_attention.py::swa_flash (Pallas
// _flash_kernel) for bf16 inputs; the fp32 route stays in swa_flash.cu.
// The contract is that file's: q (B,Sq,KV,G,hd), k/v (B,Sk,KV,hd),
// contiguous; query head h = kv*G + g; query qpos sees key kpos when
// (!causal || kpos <= qpos) and |qpos - kpos| < window; a masked score is
// the sentinel NEG_INF = -1e30 (a row wholly masked in an early tile takes
// p = 1 there and is wiped by corr = 0 later); o = acc / max(l, 1e-30);
// lse = m + log l (fp32, (B,KV,G,Sq)) goes from the forward to the
// backward.
//
// Bound on an H100 SXM at starcoder2-3b's shape (B=1, S=16384, KV=2, G=12,
// hd=128, window 4096, causal): operations. 58.7M visible (q, k) pairs a
// head x 24 heads at 4 hd FLOP a pair forward and 10 hd backward, at the
// bf16 tensor-core peak: 0.729 ms and 1.823 ms; the bytes are 1-2 % of
// that. So every product runs on the tensor cores (wgmma, bf16 operands,
// fp32 accumulators), and the tiles come in by TMA:
//
// * Each kernel's block has three warpgroups. Warpgroup 0 is the producer:
//   one thread (one warp in dK/dV) issues TMA loads of the tiles into a
//   ring of STAGES slots in shared memory, tracked by full/empty
//   mbarriers, and gives its registers away (setmaxnreg). Warpgroups 1
//   and 2 are consumers: each owns 64 rows of the block's tile (in dK/dV
//   at hd 256 both own the same 64 rows and split hd, so that dK and dV
//   fit in registers).
// * TMA boxes are 64 columns (128 bytes) wide with the 128-byte swizzle;
//   a tile of hd columns is hd / 64 such boxes, one after the other. A
//   head width that is a multiple of 16 but not of 64 (80, 96, 112) runs
//   the kernels of the next multiple of 64 (HD = padded(hd) = 128): the
//   tensor maps keep the real hd as the row's extent and stride, so the
//   last box reads past hd and TMA fills those columns with zeros; every
//   product over HD columns is then the product over hd, and the stores
//   write only the first hd columns of each row (1.6x the tensor-core
//   work at hd 80, 1.14x at 112). The scale is the wrapper's hd^-0.5. A
//   wgmma operand whose contraction runs along hd (Q, K, V, dO as the
//   rows of S = Q K^T and its kin) is K-major; one whose contraction runs
//   along the tile's rows (V in P V, K in dS K, dO in P^T dO, Q in dS^T Q)
//   is MN-major, through the descriptor's transpose bit.
// * The accumulator of S (fp32, registers) has the layout of the A
//   operand of the next wgmma: P (or dS) is rounded to bf16 in registers
//   and multiplies V (or K, dO, Q) from shared memory without leaving the
//   registers. This rounds P and dS to bf16 before those products, as the
//   JAX training path (models/flash.py) casts P to V's type.
// * The band: a block walks only the tiles of its band (kv_band/q_band);
//   the mask is applied only in tiles that cross the band's edges or S.
// * No atomics: dK and dV sum over the G query heads and the band's query
//   tiles in one block, in a fixed order; dQ is a kernel of its own;
//   D = rowsum(dO o O) comes from a pre-pass into a (B,KV,G,Sq) buffer.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <stdio.h>

// Tile geometry; swa_attention.py's BF16_* constants must equal it (the
// CPU tests parse these lines).
#define STAGES 2            // ring slots of every kernel
#define FWD_ROWS 128        // query rows per forward block (2 x 64)
#define DQ_ROWS 128         // query rows per dQ block (2 x 64)
#define DKDV_COLS 64        // query rows per dK/dV ring tile
template <int HD> struct Geo;  // fwd_cols: keys per forward ring tile;
// dq_cols: keys per dQ ring tile; dkdv_rows: KV rows per dK/dV block
template <> struct Geo<64> { static constexpr int fwd_cols = 128, dq_cols = 64, dkdv_rows = 128; };
template <> struct Geo<128> { static constexpr int fwd_cols = 128, dq_cols = 64, dkdv_rows = 128; };
template <> struct Geo<256> { static constexpr int fwd_cols = 64, dq_cols = 32, dkdv_rows = 64; };
// padded widths: the hd-128 kernels' tiles, on zero-filled columns
template <> struct Geo<80> { static constexpr int fwd_cols = 128, dq_cols = 64, dkdv_rows = 128; };
template <> struct Geo<96> { static constexpr int fwd_cols = 128, dq_cols = 64, dkdv_rows = 128; };
template <> struct Geo<112> { static constexpr int fwd_cols = 128, dq_cols = 64, dkdv_rows = 128; };

// the width the products run at: hd rounded up to whole 64-column boxes
__host__ __device__ constexpr int padded(int hd) { return (hd + 63) / 64 * 64; }

#define NEG_INF (-1e30f)
#define LOG2E 1.4426950408889634f
#define LN2 0.6931471805599453f
#define THREADS 384         // producer warpgroup + 2 consumer warpgroups
#define BOX_BYTES 128       // one TMA box row: 64 bf16

typedef __nv_bfloat16 bf16;

// ---------------------------------------------------------------- PTX
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)), "r"(count) : "memory");
}

// arrive and add `bytes` to the transactions the phase waits for
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar)) : "memory");
}

// wait until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(a), "r"(parity) : "memory");
  }
}

// one box {64 cols, 1 head, rows, 1 batch} of a (B, S, heads, hd) array
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int col, int head,
                                         int row, int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"((uint64_t)map), "r"(smem_u32(bar)), "r"(col), "r"(head), "r"(row),
      "r"(b) : "memory");
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// keep the compiler from moving accumulator reads across wgmma issue/wait
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// shared-memory matrix descriptor, 128-byte swizzle. K-major operands: sbo
// = 1024 (8 rows of 128 bytes), lbo unused. MN-major operands: lbo = the
// stride between 64-column boxes, sbo = 1024 (8 rows of the contraction).
__device__ __forceinline__ uint64_t desc(const void* p, uint32_t lbo,
                                         uint32_t sbo) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The m64nNk16 accumulator of thread (warp w, lane) holds, for i < N / 8,
// d[4i + {0,1}] = (row 16w + lane/4, cols 8i + 2(lane%4) + {0,1}) and
// d[4i + {2,3}] = (that row + 8, the same cols). Columns 16j .. 16j + 15
// (d[8j .. 8j + 7]) are the register A operand of k-step j, in order.
template <int N>
__device__ __forceinline__ void to_frag(const float (&d)[N / 2],
                                        uint32_t (&a)[N / 16][4]) {
#pragma unroll
  for (int j = 0; j < N / 16; ++j)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      a[j][r] = pack_bf16(d[8 * j + 2 * r], d[8 * j + 2 * r + 1]);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

__device__ __forceinline__ bool visible(int qpos, int kpos, int window,
                                        int causal) {
  return (!causal || kpos <= qpos) && (qpos - kpos < window) &&
         (kpos - qpos < window);
}

// every (q, k) of rows [q0, q1] x keys [k0, k1] is visible and in range
__device__ __forceinline__ bool interior(int q0, int q1, int k0, int k1,
                                         int Sq, int Sk, int window,
                                         int causal) {
  return q1 < Sq && k1 < Sk && (!causal || k1 <= q0) && q1 - k0 < window &&
         (causal || k1 - q0 < window);
}

// the key tiles (of C) that meet query rows [q_lo, q_hi]
__device__ __forceinline__ void kv_band(int q_lo, int q_hi, int Sk, int C,
                                        int window, int causal, int* first,
                                        int* count) {
  long long lo = (long long)q_lo - window + 1;
  if (lo < 0) lo = 0;
  const long long hi = causal ? (long long)q_hi
                              : (long long)q_hi + window - 1;
  const long long nk = (Sk + C - 1) / C;
  const long long last = hi / C < nk - 1 ? hi / C : nk - 1;
  *first = (int)(lo / C);
  *count = (int)(last - lo / C + 1);
}

// the query tiles (of C) that meet key rows [k_lo, k_hi]
__device__ __forceinline__ void q_band(int k_lo, int k_hi, int Sq, int C,
                                       int window, int causal, int* first,
                                       int* count) {
  long long lo = causal ? (long long)k_lo : (long long)k_lo - window + 1;
  if (lo < 0) lo = 0;
  const long long hi = (long long)k_hi + window - 1;
  const long long nq = (Sq + C - 1) / C;
  const long long last = hi / C < nq - 1 ? hi / C : nq - 1;
  *first = (int)(lo / C);
  *count = (int)(last - lo / C + 1);
}

__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  return (uint8_t*)(((uintptr_t)p + 1023) & ~(uintptr_t)1023);
}

#define PRODUCER_REGS() \
  asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory")
#define CONSUMER_REGS() \
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory")

// ------------------------------------------------------------- wgmma
template <int N> struct Wgmma;

template <> struct Wgmma<32> {
  // d[16] (+)= A[64x16] (smem, K-major) * B[16x32] (smem, K-major)
  static __device__ __forceinline__ void ss(float (&d)[16], uint64_t da,
                                            uint64_t db, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15}, "
        "%16, %17, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "l"(da), "l"(db), "r"(acc));
  }
  // d[16] (+)= A[64x16] (registers, bf16 pairs) * B[16x32] (smem, MN-major)
  static __device__ __forceinline__ void rs(float (&d)[16],
                                            const uint32_t (&a)[4],
                                            uint64_t db, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15}, "
        "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
  }
};

template <> struct Wgmma<64> {
  // d[32] (+)= A[64x16] (smem, K-major) * B[16x64] (smem, K-major)
  static __device__ __forceinline__ void ss(float (&d)[32], uint64_t da,
                                            uint64_t db, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31}, "
        "%32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(da), "l"(db), "r"(acc));
  }
  // d[32] (+)= A[64x16] (registers, bf16 pairs) * B[16x64] (smem, MN-major)
  static __device__ __forceinline__ void rs(float (&d)[32],
                                            const uint32_t (&a)[4],
                                            uint64_t db, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
  }
};

template <> struct Wgmma<128> {
  // d[64] (+)= A[64x16] (smem, K-major) * B[16x128] (smem, K-major)
  static __device__ __forceinline__ void ss(float (&d)[64], uint64_t da,
                                            uint64_t db, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63}, "
        "%64, %65, p, 1, 1, 0, 0;\n}\n"
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
        : "l"(da), "l"(db), "r"(acc));
  }
  // d[64] (+)= A[64x16] (registers, bf16 pairs) * B[16x128] (smem, MN-major)
  static __device__ __forceinline__ void rs(float (&d)[64],
                                            const uint32_t (&a)[4],
                                            uint64_t db, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63}, "
        "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
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
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
  }
};


// --------------------------------------------------------------- forward
// grid: B * KV * G * ceil(Sq / FWD_ROWS) blocks of THREADS threads. Ring
// slot i % STAGES holds key tile first + i (C rows) of K and of V.
template <int HS>
__global__ void __launch_bounds__(THREADS, 1)
fwd_kernel(const __grid_constant__ CUtensorMap tq,
           const __grid_constant__ CUtensorMap tk,
           const __grid_constant__ CUtensorMap tv, bf16* __restrict__ o,
           float* __restrict__ lse, int Sq, int Sk, int KV, int G,
           int window, int causal, float scale) {
  constexpr int HD = padded(HS), C = Geo<HS>::fwd_cols, NB = HD / 64;
  constexpr int ON = HD < 128 ? HD : 128, NO = HD / ON;  // O in N-chunks
  constexpr uint32_t QBYTES = FWD_ROWS * HD * 2, TBYTES = C * HD * 2;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sQ = align1024(smem_raw);              // NB boxes [FWD_ROWS][64]
  uint8_t* sK = sQ + QBYTES;                      // [STAGES] x NB [C][64]
  uint8_t* sV = sK + STAGES * TBYTES;
  uint64_t* bar = (uint64_t*)(sV + STAGES * TBYTES);
  uint64_t* q_full = bar;
  uint64_t* k_full = bar + 1;
  uint64_t* v_full = k_full + STAGES;
  uint64_t* empty = v_full + STAGES;

  const int nq = (Sq + FWD_ROWS - 1) / FWD_ROWS;
  int bid = blockIdx.x;
  const int qt = bid % nq; bid /= nq;
  const int g = bid % G; bid /= G;
  const int kv = bid % KV;
  const int b = bid / KV;
  const int h = kv * G + g;
  const int q_lo = qt * FWD_ROWS;
  int first, ntiles;
  kv_band(q_lo, min(q_lo + FWD_ROWS, Sq) - 1, Sk, C, window, causal, &first,
          &ntiles);

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&k_full[s], 1);
      mbar_init(&v_full[s], 1);
      mbar_init(&empty[s], 8);                    // one arrive a consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {                                  // producer
    PRODUCER_REGS();
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_full, QBYTES);
      for (int c = 0; c < NB; ++c)
        tma_load(sQ + c * FWD_ROWS * BOX_BYTES, &tq, q_full, 64 * c, h, q_lo,
                 b);
      for (int i = 0; i < ntiles; ++i) {
        const int s = i % STAGES, k_lo = (first + i) * C;
        if (i >= STAGES) mbar_wait(&empty[s], ((i / STAGES) & 1) ^ 1);
        mbar_expect_tx(&k_full[s], TBYTES);
        for (int c = 0; c < NB; ++c)
          tma_load(sK + s * TBYTES + c * C * BOX_BYTES, &tk, &k_full[s],
                   64 * c, kv, k_lo, b);
        mbar_expect_tx(&v_full[s], TBYTES);
        for (int c = 0; c < NB; ++c)
          tma_load(sV + s * TBYTES + c * C * BOX_BYTES, &tv, &v_full[s],
                   64 * c, kv, k_lo, b);
      }
    }
    return;
  }

  CONSUMER_REGS();
  const int w = wg - 1, tid = threadIdx.x % 128;
  const int lane = tid % 32, t4 = lane % 4;
  const int row = w * 64 + (tid / 32) * 16 + lane / 4;   // and row + 8
  const int qa = q_lo + row, qb = qa + 8;
  const int q0 = q_lo + w * 64, q1 = q0 + 63;
  float oacc[NO][ON / 2];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < ON / 2; ++e) oacc[n][e] = 0.f;
  // running max (log2 units) and sum of rows qa, qb; the sums are this
  // thread's columns only until the quad adds them up at the end
  float ma = NEG_INF, mb = NEG_INF, la = 0.f, lb = 0.f;
  const float sl2 = scale * LOG2E;
  mbar_wait(q_full, 0);

  for (int i = 0; i < ntiles; ++i) {
    const int s = i % STAGES, par = (i / STAGES) & 1, k_lo = (first + i) * C;
    float sacc[C / 2];
    mbar_wait(&k_full[s], par);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      Wgmma<C>::ss(sacc,
                   desc(sQ + (kk / 4) * FWD_ROWS * BOX_BYTES +
                        w * 64 * BOX_BYTES + (kk % 4) * 32, 0, 1024),
                   desc(sK + s * TBYTES + (kk / 4) * C * BOX_BYTES +
                        (kk % 4) * 32, 0, 1024), kk > 0);
    wg_commit();
    wg_wait0();
    fence_regs(sacc);

    // scores in log2 units: x = s * scale * log2(e); masked x = NEG_INF
    // (the sentinel's p = exp2(0) = 1 in a wholly masked row is wiped by
    // corr = exp2(NEG_INF - m) = 0 once a tile holds one of its keys)
    const bool full = interior(q0, q1, k_lo, k_lo + C - 1, Sq, Sk, window,
                               causal);
    float mxa = ma, mxb = mb;
#pragma unroll
    for (int e = 0; e < C / 2; ++e) {
      float x = sacc[e] * sl2;
      if (!full) {
        const int kpos = k_lo + 8 * (e / 4) + 2 * t4 + (e & 1);
        const int qpos = (e & 2) ? qb : qa;
        if (!(kpos < Sk && visible(qpos, kpos, window, causal))) x = NEG_INF;
      }
      sacc[e] = x;
      if (e & 2) mxb = fmaxf(mxb, x); else mxa = fmaxf(mxa, x);
    }
    mxa = quad_max(mxa);
    mxb = quad_max(mxb);
    const float ca = exp2f(ma - mxa), cb = exp2f(mb - mxb);
    float sa = 0.f, sb = 0.f;
#pragma unroll
    for (int e = 0; e < C / 2; ++e) {
      const float p = exp2f(sacc[e] - ((e & 2) ? mxb : mxa));
      sacc[e] = p;
      if (e & 2) sb += p; else sa += p;
    }
    la = la * ca + sa;
    lb = lb * cb + sb;
    ma = mxa;
    mb = mxb;
#pragma unroll
    for (int n = 0; n < NO; ++n)
#pragma unroll
      for (int e = 0; e < ON / 2; ++e) oacc[n][e] *= (e & 2) ? cb : ca;
    uint32_t pf[C / 16][4];
    to_frag<C>(sacc, pf);

    mbar_wait(&v_full[s], par);
#pragma unroll
    for (int n = 0; n < NO; ++n) fence_regs(oacc[n]);
    wg_fence();
#pragma unroll
    for (int n = 0; n < NO; ++n)
#pragma unroll
      for (int j = 0; j < C / 16; ++j)
        Wgmma<ON>::rs(oacc[n], pf[j],
                      desc(sV + s * TBYTES + (n * ON / 64) * C * BOX_BYTES +
                           j * 16 * BOX_BYTES, C * BOX_BYTES, 1024), 1);
    wg_commit();
    wg_wait0();
#pragma unroll
    for (int n = 0; n < NO; ++n) fence_regs(oacc[n]);
    if (lane == 0) mbar_arrive(&empty[s]);
  }

  la = quad_sum(la);
  lb = quad_sum(lb);
  const long long H = (long long)KV * G;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int qpos = half ? qb : qa;
    if (qpos >= Sq) continue;
    const float l = half ? lb : la, m = half ? mb : ma;
    const float inv = 1.f / fmaxf(l, 1e-30f);
    bf16* dst = o + (((long long)b * Sq + qpos) * H + h) * HS + 2 * t4;
#pragma unroll
    for (int n = 0; n < NO; ++n)
#pragma unroll
      for (int i = 0; i < ON / 8; ++i) {
        if (n * ON + 8 * i >= HS) continue;       // padded columns
        *reinterpret_cast<uint32_t*>(dst + n * ON + 8 * i) =
            pack_bf16(oacc[n][4 * i + 2 * half] * inv,
                      oacc[n][4 * i + 2 * half + 1] * inv);
      }
    if (t4 == 0)
      lse[((long long)b * H + h) * Sq + qpos] = (m + log2f(l)) * LN2;
  }
}

// ------------------------------------------------------------ backward
// D = rowsum(dO o O) in fp32, once a row: D[(b H + h) Sq + i] for row
// (b, i, h) of the (B, Sq, H, hd) arrays; padded(hd) / 16 threads a row,
// those past hd adding nothing.
template <int HS>
__global__ void __launch_bounds__(256)
dot_kernel(const bf16* __restrict__ dout, const bf16* __restrict__ o,
           float* __restrict__ D, long long rows, int Sq, int H) {
  constexpr int TPR = padded(HS) / 16;
  const long long gt = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long r = gt / TPR;
  const int part = (int)(gt % TPR);
  float acc = 0.f;
  if (r < rows && 16 * part < HS) {
    const uint4* x = reinterpret_cast<const uint4*>(dout + r * HS + 16 * part);
    const uint4* y = reinterpret_cast<const uint4*>(o + r * HS + 16 * part);
#pragma unroll
    for (int v = 0; v < 2; ++v) {
      const uint4 a = x[v], c = y[v];
      const uint32_t av[4] = {a.x, a.y, a.z, a.w}, cv[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 fa = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(&av[j]));
        const float2 fc = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(&cv[j]));
        acc = fmaf(fa.x, fc.x, acc);
        acc = fmaf(fa.y, fc.y, acc);
      }
    }
  }
#pragma unroll
  for (int off = 1; off < TPR; off <<= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (r < rows && part == 0) {
    const long long bi = r / H;
    D[(bi / Sq * H + r % H) * Sq + bi % Sq] = acc;
  }
}

// dQ. grid: B * KV * G * ceil(Sq / DQ_ROWS) blocks of THREADS threads; ring
// slot i % STAGES holds key tile first + i (C rows) of K and of V.
// dQ = scale sum_tiles dS K, dS = P o (dO V^T - D), P = exp(s - lse).
template <int HS>
__global__ void __launch_bounds__(THREADS, 1)
dq_kernel(const __grid_constant__ CUtensorMap tq,
          const __grid_constant__ CUtensorMap tdo,
          const __grid_constant__ CUtensorMap tk,
          const __grid_constant__ CUtensorMap tv,
          const float* __restrict__ lse, const float* __restrict__ Dbuf,
          bf16* __restrict__ dq, int Sq, int Sk, int KV, int G, int window,
          int causal, float scale) {
  constexpr int HD = padded(HS), C = Geo<HS>::dq_cols, NB = HD / 64;
  constexpr int ON = HD < 128 ? HD : 128, NO = HD / ON;
  constexpr uint32_t QBYTES = DQ_ROWS * HD * 2, TBYTES = C * HD * 2;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sQ = align1024(smem_raw);              // NB boxes [DQ_ROWS][64]
  uint8_t* sdO = sQ + QBYTES;
  uint8_t* sK = sdO + QBYTES;                     // [STAGES] x NB [C][64]
  uint8_t* sV = sK + STAGES * TBYTES;
  uint64_t* bar = (uint64_t*)(sV + STAGES * TBYTES);
  uint64_t* q_full = bar;                         // Q and dO
  uint64_t* k_full = bar + 1;
  uint64_t* v_full = k_full + STAGES;
  uint64_t* empty = v_full + STAGES;

  const int nq = (Sq + DQ_ROWS - 1) / DQ_ROWS;
  int bid = blockIdx.x;
  const int qt = bid % nq; bid /= nq;
  const int g = bid % G; bid /= G;
  const int kv = bid % KV;
  const int b = bid / KV;
  const int h = kv * G + g;
  const int q_lo = qt * DQ_ROWS;
  int first, ntiles;
  kv_band(q_lo, min(q_lo + DQ_ROWS, Sq) - 1, Sk, C, window, causal, &first,
          &ntiles);

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&k_full[s], 1);
      mbar_init(&v_full[s], 1);
      mbar_init(&empty[s], 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {                                  // producer
    PRODUCER_REGS();
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_full, 2 * QBYTES);
      for (int c = 0; c < NB; ++c) {
        tma_load(sQ + c * DQ_ROWS * BOX_BYTES, &tq, q_full, 64 * c, h, q_lo,
                 b);
        tma_load(sdO + c * DQ_ROWS * BOX_BYTES, &tdo, q_full, 64 * c, h,
                 q_lo, b);
      }
      for (int i = 0; i < ntiles; ++i) {
        const int s = i % STAGES, k_lo = (first + i) * C;
        if (i >= STAGES) mbar_wait(&empty[s], ((i / STAGES) & 1) ^ 1);
        mbar_expect_tx(&k_full[s], TBYTES);
        for (int c = 0; c < NB; ++c)
          tma_load(sK + s * TBYTES + c * C * BOX_BYTES, &tk, &k_full[s],
                   64 * c, kv, k_lo, b);
        mbar_expect_tx(&v_full[s], TBYTES);
        for (int c = 0; c < NB; ++c)
          tma_load(sV + s * TBYTES + c * C * BOX_BYTES, &tv, &v_full[s],
                   64 * c, kv, k_lo, b);
      }
    }
    return;
  }

  CONSUMER_REGS();
  const int w = wg - 1, tid = threadIdx.x % 128;
  const int lane = tid % 32, t4 = lane % 4;
  const int row = w * 64 + (tid / 32) * 16 + lane / 4;
  const int qa = q_lo + row, qb = qa + 8;
  const int q0 = q_lo + w * 64, q1 = q0 + 63;
  const long long H = (long long)KV * G, lrow = ((long long)b * H + h) * Sq;
  // lse in log2 units; rows past Sq are zero tiles, masked below
  const float La = qa < Sq ? lse[lrow + qa] * LOG2E : 0.f;
  const float Lb = qb < Sq ? lse[lrow + qb] * LOG2E : 0.f;
  const float Da = qa < Sq ? Dbuf[lrow + qa] : 0.f;
  const float Db = qb < Sq ? Dbuf[lrow + qb] : 0.f;
  const float sl2 = scale * LOG2E;
  float acc[NO][ON / 2];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < ON / 2; ++e) acc[n][e] = 0.f;
  mbar_wait(q_full, 0);

  for (int i = 0; i < ntiles; ++i) {
    const int s = i % STAGES, par = (i / STAGES) & 1, k_lo = (first + i) * C;
    float sacc[C / 2], dp[C / 2];
    mbar_wait(&k_full[s], par);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)          // S = Q K^T
      Wgmma<C>::ss(sacc,
                   desc(sQ + (kk / 4) * DQ_ROWS * BOX_BYTES +
                        w * 64 * BOX_BYTES + (kk % 4) * 32, 0, 1024),
                   desc(sK + s * TBYTES + (kk / 4) * C * BOX_BYTES +
                        (kk % 4) * 32, 0, 1024), kk > 0);
    wg_commit();
    mbar_wait(&v_full[s], par);
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)          // dP = dO V^T
      Wgmma<C>::ss(dp,
                   desc(sdO + (kk / 4) * DQ_ROWS * BOX_BYTES +
                        w * 64 * BOX_BYTES + (kk % 4) * 32, 0, 1024),
                   desc(sV + s * TBYTES + (kk / 4) * C * BOX_BYTES +
                        (kk % 4) * 32, 0, 1024), kk > 0);
    wg_commit();
    wg_wait0();
    fence_regs(sacc);
    fence_regs(dp);

    const bool full = interior(q0, q1, k_lo, k_lo + C - 1, Sq, Sk, window,
                               causal);
#pragma unroll
    for (int e = 0; e < C / 2; ++e) {
      float x = sacc[e] * sl2;
      if (!full) {
        const int kpos = k_lo + 8 * (e / 4) + 2 * t4 + (e & 1);
        const int qpos = (e & 2) ? qb : qa;
        if (!(kpos < Sk && qpos < Sq && visible(qpos, kpos, window, causal)))
          x = NEG_INF;
      }
      const float p = exp2f(x - ((e & 2) ? Lb : La));
      sacc[e] = p * (dp[e] - ((e & 2) ? Db : Da));  // dS
    }
    uint32_t df[C / 16][4];
    to_frag<C>(sacc, df);
#pragma unroll
    for (int n = 0; n < NO; ++n) fence_regs(acc[n]);
    wg_fence();
#pragma unroll
    for (int n = 0; n < NO; ++n)
#pragma unroll
      for (int j = 0; j < C / 16; ++j)            // dQ += dS K
        Wgmma<ON>::rs(acc[n], df[j],
                      desc(sK + s * TBYTES + (n * ON / 64) * C * BOX_BYTES +
                           j * 16 * BOX_BYTES, C * BOX_BYTES, 1024), 1);
    wg_commit();
    wg_wait0();
#pragma unroll
    for (int n = 0; n < NO; ++n) fence_regs(acc[n]);
    if (lane == 0) mbar_arrive(&empty[s]);
  }

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int qpos = half ? qb : qa;
    if (qpos >= Sq) continue;
    bf16* dst = dq + (((long long)b * Sq + qpos) * H + h) * HS + 2 * t4;
#pragma unroll
    for (int n = 0; n < NO; ++n)
#pragma unroll
      for (int i = 0; i < ON / 8; ++i) {
        if (n * ON + 8 * i >= HS) continue;
        *reinterpret_cast<uint32_t*>(dst + n * ON + 8 * i) =
            pack_bf16(acc[n][4 * i + 2 * half] * scale,
                      acc[n][4 * i + 2 * half + 1] * scale);
      }
  }
}

// dK and dV. grid: B * KV * ceil(Sk / R) blocks of THREADS threads; K and V
// rows [k_lo, k_lo + R) stay in shared memory; ring slot it % STAGES holds
// query tile (g, first + it % ntiles) of Q and dO (DKDV_COLS rows) with its
// lse (log2 units) and D. Rows of the block's scores are key positions,
// columns query positions: S^T = K Q^T, dP^T = V dO^T, P^T, dS^T; dV +=
// P^T dO, dK += dS^T Q; dK = scale dK.
template <int HS>
__global__ void __launch_bounds__(THREADS, 1)
dkdv_kernel(const __grid_constant__ CUtensorMap tq,
            const __grid_constant__ CUtensorMap tdo,
            const __grid_constant__ CUtensorMap tk,
            const __grid_constant__ CUtensorMap tv,
            const float* __restrict__ lse, const float* __restrict__ Dbuf,
            bf16* __restrict__ dk, bf16* __restrict__ dv, int Sq, int Sk,
            int KV, int G, int window, int causal, float scale) {
  constexpr int HD = padded(HS), R = Geo<HS>::dkdv_rows, CQ = DKDV_COLS;
  constexpr int NB = HD / 64;
  // at hd 256 the two consumers own the same 64 rows, 128 columns each
  constexpr bool SPLIT = HD == 256;
  constexpr int NCOL = SPLIT ? HD / 2 : HD;
  constexpr uint32_t KBYTES = R * HD * 2, TBYTES = CQ * HD * 2;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sK = align1024(smem_raw);              // NB boxes [R][64]
  uint8_t* sV = sK + KBYTES;
  uint8_t* sQ = sV + KBYTES;                      // [STAGES] x NB [CQ][64]
  uint8_t* sdO = sQ + STAGES * TBYTES;
  float* sL = (float*)(sdO + STAGES * TBYTES);    // [STAGES][CQ]
  float* sD = sL + STAGES * CQ;                   // [STAGES][CQ]
  uint64_t* bar = (uint64_t*)(sD + STAGES * CQ);
  uint64_t* kv_full = bar;
  uint64_t* full = bar + 1;
  uint64_t* empty = full + STAGES;

  const int nk = (Sk + R - 1) / R;
  int bid = blockIdx.x;
  const int kt = bid % nk; bid /= nk;
  const int kv = bid % KV;
  const int b = bid / KV;
  const int k_lo = kt * R;
  int first, ntiles;
  q_band(k_lo, min(k_lo + R, Sk) - 1, Sq, CQ, window, causal, &first,
         &ntiles);
  const int total = ntiles > 0 ? G * ntiles : 0;
  const long long H = (long long)KV * G;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 32);                    // the producer warp
      mbar_init(&empty[s], 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {                                  // producer: warp 0
    PRODUCER_REGS();
    const int lane = threadIdx.x;
    if (lane < 32) {
      if (lane == 0) {
        mbar_expect_tx(kv_full, 2 * KBYTES);
        for (int c = 0; c < NB; ++c) {
          tma_load(sK + c * R * BOX_BYTES, &tk, kv_full, 64 * c, kv, k_lo, b);
          tma_load(sV + c * R * BOX_BYTES, &tv, kv_full, 64 * c, kv, k_lo, b);
        }
      }
      for (int it = 0; it < total; ++it) {
        const int s = it % STAGES, g = it / ntiles;
        const int q_lo = (first + it % ntiles) * CQ;
        if (it >= STAGES) mbar_wait(&empty[s], ((it / STAGES) & 1) ^ 1);
        const long long lrow = ((long long)b * H + kv * G + g) * Sq;
        for (int c = lane; c < CQ; c += 32) {
          const int qpos = q_lo + c;
          sL[s * CQ + c] = qpos < Sq ? lse[lrow + qpos] * LOG2E : 0.f;
          sD[s * CQ + c] = qpos < Sq ? Dbuf[lrow + qpos] : 0.f;
        }
        if (lane == 0) {
          mbar_expect_tx(&full[s], 2 * TBYTES);
          for (int c = 0; c < NB; ++c) {
            tma_load(sQ + s * TBYTES + c * CQ * BOX_BYTES, &tq, &full[s],
                     64 * c, kv * G + g, q_lo, b);
            tma_load(sdO + s * TBYTES + c * CQ * BOX_BYTES, &tdo, &full[s],
                     64 * c, kv * G + g, q_lo, b);
          }
        } else {
          mbar_arrive(&full[s]);
        }
      }
    }
    return;
  }

  CONSUMER_REGS();
  const int w = wg - 1, tid = threadIdx.x % 128;
  const int lane = tid % 32, t4 = lane % 4;
  const int row_off = SPLIT ? 0 : w * 64, col0 = SPLIT ? w * NCOL : 0;
  const int ka = k_lo + row_off + (tid / 32) * 16 + lane / 4, kb = ka + 8;
  const int k0 = k_lo + row_off, k1 = k0 + 63;
  const float sl2 = scale * LOG2E;
  float dK[NCOL / 2], dV[NCOL / 2];
#pragma unroll
  for (int e = 0; e < NCOL / 2; ++e) dK[e] = dV[e] = 0.f;
  mbar_wait(kv_full, 0);

  for (int it = 0; it < total; ++it) {
    const int s = it % STAGES, par = (it / STAGES) & 1;
    const int q_lo = (first + it % ntiles) * CQ;
    float sacc[CQ / 2], dp[CQ / 2];
    mbar_wait(&full[s], par);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)          // S^T = K Q^T
      Wgmma<CQ>::ss(sacc,
                    desc(sK + (kk / 4) * R * BOX_BYTES +
                         row_off * BOX_BYTES + (kk % 4) * 32, 0, 1024),
                    desc(sQ + s * TBYTES + (kk / 4) * CQ * BOX_BYTES +
                         (kk % 4) * 32, 0, 1024), kk > 0);
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)          // dP^T = V dO^T
      Wgmma<CQ>::ss(dp,
                    desc(sV + (kk / 4) * R * BOX_BYTES +
                         row_off * BOX_BYTES + (kk % 4) * 32, 0, 1024),
                    desc(sdO + s * TBYTES + (kk / 4) * CQ * BOX_BYTES +
                         (kk % 4) * 32, 0, 1024), kk > 0);
    wg_commit();
    wg_wait0();
    fence_regs(sacc);
    fence_regs(dp);

    const bool full_tile = interior(q_lo, q_lo + CQ - 1, k0, k1, Sq, Sk,
                                    window, causal);
    const float* L = sL + s * CQ;
    const float* Dv = sD + s * CQ;
#pragma unroll
    for (int e = 0; e < CQ / 2; ++e) {
      const int col = 8 * (e / 4) + 2 * t4 + (e & 1);
      float x = sacc[e] * sl2;
      if (!full_tile) {
        const int qpos = q_lo + col, kpos = (e & 2) ? kb : ka;
        if (!(qpos < Sq && kpos < Sk && visible(qpos, kpos, window, causal)))
          x = NEG_INF;
      }
      const float p = exp2f(x - L[col]);
      sacc[e] = p;                                // P^T
      dp[e] = p * (dp[e] - Dv[col]);              // dS^T
    }
    uint32_t pf[CQ / 16][4], df[CQ / 16][4];
    to_frag<CQ>(sacc, pf);
    to_frag<CQ>(dp, df);
    fence_regs(dV);
    fence_regs(dK);
    wg_fence();
#pragma unroll
    for (int j = 0; j < CQ / 16; ++j)             // dV += P^T dO
      Wgmma<NCOL>::rs(dV, pf[j],
                      desc(sdO + s * TBYTES + (col0 / 64) * CQ * BOX_BYTES +
                           j * 16 * BOX_BYTES, CQ * BOX_BYTES, 1024), 1);
#pragma unroll
    for (int j = 0; j < CQ / 16; ++j)             // dK += dS^T Q
      Wgmma<NCOL>::rs(dK, df[j],
                      desc(sQ + s * TBYTES + (col0 / 64) * CQ * BOX_BYTES +
                           j * 16 * BOX_BYTES, CQ * BOX_BYTES, 1024), 1);
    wg_commit();
    wg_wait0();
    fence_regs(dV);
    fence_regs(dK);
    if (lane == 0) mbar_arrive(&empty[s]);
  }

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int kpos = half ? kb : ka;
    if (kpos >= Sk) continue;
    const long long off = (((long long)b * Sk + kpos) * KV + kv) * HS + col0 +
                          2 * t4;
#pragma unroll
    for (int i = 0; i < NCOL / 8; ++i) {
      if (col0 + 8 * i >= HS) continue;           // padded columns
      *reinterpret_cast<uint32_t*>(dk + off + 8 * i) =
          pack_bf16(dK[4 * i + 2 * half] * scale,
                    dK[4 * i + 2 * half + 1] * scale);
      *reinterpret_cast<uint32_t*>(dv + off + 8 * i) =
          pack_bf16(dV[4 * i + 2 * half], dV[4 * i + 2 * half + 1]);
    }
  }
}

// ------------------------------------------------------------------ launch
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

#define ENCODE_ERROR 100000   // + CUresult of a failed tensor-map encode
#define MIN_SMEM (116 * 1024) // more than half the SM's: one block an SM,
                              // so the consumers' setmaxnreg.inc is met

// cuTensorMapEncodeTiled, looked up through the CUDA runtime, so that the
// library need not link libcuda
static EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                            cudaEnableDefault, &q);
#endif
    if (e != cudaSuccess || q != cudaDriverEntryPointSuccess) return nullptr;
    fn = (EncodeTiled)p;
  }
  return fn;
}

// a (B, S, heads, hd) bf16 array read in boxes of {64 columns, 1 head, rows
// rows, 1 batch}, 128-byte swizzle; rows past S, and columns past hd (the
// last box of a padded width), read as zeros
static int make_map(CUtensorMap* m, const void* base, int B, int S,
                    int heads, int hd, int rows) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return (int)cudaErrorSymbolNotFound;
  const cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)heads,
                              (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)hd * 2,
                                 (cuuint64_t)heads * hd * 2,
                                 (cuuint64_t)S * heads * hd * 2};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)rows, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = fn(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                        const_cast<void*>(base), dims, strides, box, elem,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : ENCODE_ERROR + (int)r;
}

template <typename K>
static int set_smem(K kernel, size_t* smem) {
  if (*smem < MIN_SMEM) *smem = MIN_SMEM;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)*smem);
}

#define TRY(x)                 \
  do {                         \
    const int rc_ = (x);       \
    if (rc_ != 0) return rc_;  \
  } while (0)

template <int HS>
static int launch_fwd(const void* q, const void* k, const void* v, void* o,
                      float* lse, int B, int Sq, int Sk, int KV, int G,
                      int window, int causal, float scale,
                      cudaStream_t stream) {
  constexpr int HD = padded(HS), C = Geo<HS>::fwd_cols;
  CUtensorMap tq, tk, tv;
  TRY(make_map(&tq, q, B, Sq, KV * G, HS, FWD_ROWS));
  TRY(make_map(&tk, k, B, Sk, KV, HS, C));
  TRY(make_map(&tv, v, B, Sk, KV, HS, C));
  size_t smem = 1024 + FWD_ROWS * HD * 2 + 2 * STAGES * C * HD * 2 + 256;
  TRY(set_smem(fwd_kernel<HS>, &smem));
  const long long blocks =
      (long long)B * KV * G * ((Sq + FWD_ROWS - 1) / FWD_ROWS);
  fwd_kernel<HS><<<(unsigned)blocks, THREADS, smem, stream>>>(
      tq, tk, tv, (bf16*)o, lse, Sq, Sk, KV, G, window, causal, scale);
  return (int)cudaGetLastError();
}

template <int HS>
static int launch_bwd(const void* dout, const void* q, const void* k,
                      const void* v, const void* o, const float* lse,
                      float* D, void* dq, void* dk, void* dv, int B, int Sq,
                      int Sk, int KV, int G, int window, int causal,
                      float scale, cudaStream_t stream) {
  constexpr int HD = padded(HS);
  const long long rows = (long long)B * Sq * KV * G;
  const long long threads = rows * (HD / 16);
  dot_kernel<HS><<<(unsigned)((threads + 255) / 256), 256, 0, stream>>>(
      (const bf16*)dout, (const bf16*)o, D, rows, Sq, KV * G);
  TRY((int)cudaGetLastError());

  constexpr int C = Geo<HS>::dq_cols, R = Geo<HS>::dkdv_rows;
  CUtensorMap tq, tdo, tk, tv;
  TRY(make_map(&tq, q, B, Sq, KV * G, HS, DQ_ROWS));
  TRY(make_map(&tdo, dout, B, Sq, KV * G, HS, DQ_ROWS));
  TRY(make_map(&tk, k, B, Sk, KV, HS, C));
  TRY(make_map(&tv, v, B, Sk, KV, HS, C));
  size_t smem = 1024 + 2 * DQ_ROWS * HD * 2 + 2 * STAGES * C * HD * 2 + 256;
  TRY(set_smem(dq_kernel<HS>, &smem));
  const long long nq = (Sq + DQ_ROWS - 1) / DQ_ROWS;
  dq_kernel<HS><<<(unsigned)((long long)B * KV * G * nq), THREADS, smem,
                  stream>>>(tq, tdo, tk, tv, lse, D, (bf16*)dq, Sq, Sk, KV,
                            G, window, causal, scale);
  TRY((int)cudaGetLastError());

  TRY(make_map(&tq, q, B, Sq, KV * G, HS, DKDV_COLS));
  TRY(make_map(&tdo, dout, B, Sq, KV * G, HS, DKDV_COLS));
  TRY(make_map(&tk, k, B, Sk, KV, HS, R));
  TRY(make_map(&tv, v, B, Sk, KV, HS, R));
  smem = 1024 + 2 * R * HD * 2 + 2 * STAGES * DKDV_COLS * HD * 2 +
         2 * STAGES * DKDV_COLS * 4 + 256;
  TRY(set_smem(dkdv_kernel<HS>, &smem));
  const long long nk = (Sk + R - 1) / R;
  dkdv_kernel<HS><<<(unsigned)((long long)B * KV * nk), THREADS, smem,
                    stream>>>(tq, tdo, tk, tv, lse, D, (bf16*)dk, (bf16*)dv,
                              Sq, Sk, KV, G, window, causal, scale);
  return (int)cudaGetLastError();
}

// The entry points have the fp32 library's names and arguments (the
// backward adds D); dtype must be 1 (bfloat16). hd: 64, 128 or 256, or
// 80, 96 or 112 on the hd-128 kernels (padded).
extern "C" int reft_swa_fwd(const void* q, const void* k, const void* v,
                                 void* o, void* lse, int B, int Sq, int Sk,
                                 int KV, int G, int hd, int window,
                                 int causal, float scale, int dtype,
                                 int device, void* stream) {
  TRY((int)cudaSetDevice(device));
  if (window < 1 || Sq < 1 || Sk < 1 || dtype != 1)
    return (int)cudaErrorInvalidValue;
#define FWD_ARGS                                                         \
  q, k, v, o, (float*)lse, B, Sq, Sk, KV, G, window, causal, scale,      \
      (cudaStream_t)stream
  if (hd == 64) return launch_fwd<64>(FWD_ARGS);
  if (hd == 128) return launch_fwd<128>(FWD_ARGS);
  if (hd == 256) return launch_fwd<256>(FWD_ARGS);
  if (hd == 80) return launch_fwd<80>(FWD_ARGS);
  if (hd == 96) return launch_fwd<96>(FWD_ARGS);
  if (hd == 112) return launch_fwd<112>(FWD_ARGS);
#undef FWD_ARGS
  return (int)cudaErrorInvalidValue;
}

// D: a (B, KV, G, Sq) fp32 scratch buffer for the pre-pass
extern "C" int reft_swa_bwd(const void* dout, const void* q,
                                 const void* k, const void* v, const void* o,
                                 const void* lse, void* D, void* dq,
                                 void* dk, void* dv, int B, int Sq, int Sk,
                                 int KV, int G, int hd, int window,
                                 int causal, float scale, int dtype,
                                 int device, void* stream) {
  TRY((int)cudaSetDevice(device));
  if (window < 1 || Sq < 1 || Sk < 1 || dtype != 1)
    return (int)cudaErrorInvalidValue;
#define BWD_ARGS                                                         \
  dout, q, k, v, o, (const float*)lse, (float*)D, dq, dk, dv, B, Sq, Sk, \
      KV, G, window, causal, scale, (cudaStream_t)stream
  if (hd == 64) return launch_bwd<64>(BWD_ARGS);
  if (hd == 128) return launch_bwd<128>(BWD_ARGS);
  if (hd == 256) return launch_bwd<256>(BWD_ARGS);
  if (hd == 80) return launch_bwd<80>(BWD_ARGS);
  if (hd == 96) return launch_bwd<96>(BWD_ARGS);
  if (hd == 112) return launch_bwd<112>(BWD_ARGS);
#undef BWD_ARGS
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* reft_swa_error_string(int code) {
  static thread_local char buf[96];
  if (code >= ENCODE_ERROR) {
    snprintf(buf, sizeof buf, "cuTensorMapEncodeTiled failed (CUresult %d)",
             code - ENCODE_ERROR);
    return buf;
  }
  return cudaGetErrorString((cudaError_t)code);
}
