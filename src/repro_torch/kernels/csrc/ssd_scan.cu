// Mamba2 SSD scan for Hopper (sm_90a): the chunked (state-space-duality)
// forward and backward, every product on the tensor cores.
//
// Replaces the TPU kernel repro/kernels/ssd_scan.py::ssd_scan (Pallas
// _ssd_kernel, same contract as repro/models/ssm.py::ssd_chunked). The TPU
// walks the chunks as a sequential grid axis with the (P, N) state resident
// in VMEM and does three matmuls per chunk. Here the chunks run in parallel
// (arXiv:2405.21060, section 6): per chunk c of Q steps and head h, with
// cum_t the within-chunk cumsum of a, L[t,s] = e^{cum_t - cum_s} (s <= t)
// and S = C B^T (shared by the heads),
//   1. chunk states  st_c = (w o u)^T B, w_s = e^{cum_{Q-1} - cum_s}
//   2. state passing hs[c] = h; h = e^{cum_{Q-1}} h + st_c (nc steps, the
//                    only serial part; in place over the states)
//   3. chunk scan    y = (S o L) u + e^{cum} C hs[c]^T
// The backward has no TPU counterpart (the JAX package lets XLA derive it
// from ssd_chunked). It follows the same passes in reverse:
//   1. X_c = (e^{cum} o dy)^T C                 (kernel 1, other weights)
//   2. gs[c] = g; g = e^{cum_{Q-1}} g + X_c, c from the last chunk down:
//      gs[c] is the cotangent of the state after chunk c, g ends as dh0
//   3. per (b, c) tile: S, and dS = sum_h (dy_h u_h^T) o L_h summed over
//      the heads inside the block, with the row and column sums of
//      W_h = (dy_h u_h^T) o S o L_h that da needs
//   4. per (b, c, h): du = (S o L)^T dy + e^{cum_{Q-1} - cum} B gs^T, and
//      dcum (W's row minus column sums, the y_inter term, the state
//      terms), da its reverse cumsum within the chunk
//   5. dC = dS B + sum_h e^{cum} dy_h hs_h, dB = dS^T C + sum_h w u_h gs_h:
//      the head sums are one product each with K = H * P
// No atomics and no cross-head partials: every sum over heads or tiles runs
// in one block in a fixed order, so the result is deterministic.
//
// Precision. The contract is fp32 (atol 5e-4, rtol 1e-3). Every product is
// mma.sync m16n8k16 bf16 with fp32 accumulators, each fp32 operand split
// into bf16 hi + lo and multiplied as hi*hi + hi*lo + lo*hi ("bf16x3",
// about 2^-17 relative a term; plain bf16 would be 2^-9). The split is a
// register pass (fetch, put) that writes each 64 x 64 operand tile into
// shared memory as it lies in global memory; ldmatrix, or ldmatrix.trans
// for the operands that are MN-major there, loads the fragments. That
// pass is why this uses mma.sync and not wgmma: TMA cannot split, tf32
// wgmma takes only K-major operands, and the tensor cores are not what
// bounds these kernels (below). The intra-chunk decay masks the upper
// triangle BEFORE the exponential (`decay`): exp would overflow there at
// seq 2048 and make da NaN.
//
// Bound on an H100 SXM at the main path's shapes (B=2, S=2048, H=24, P=64,
// N=128, Q=256), counted from the products these passes do (causal ones
// over a chunk's lower triangle), three bf16 terms each at 989.4 TFLOP/s:
// forward 3 x 4.97 GFLOP -> 0.0151 ms against 69.1 MB of inputs and
// outputs at 3.35 TB/s -> 0.0206 ms (bytes); backward 3 x 11.69 GFLOP ->
// 0.0354 ms against 98.8 MB -> 0.0295 ms (operations). chip_smoke.py
// computes both from the shapes (ssd_flops, ssd_bytes). What holds the
// kernels at 10-15x that bound is the staging: each block fetches two
// fp32 tiles (mostly L2 hits: head-shared tiles such as S and C are read
// once per head), then stores, syncs and multiplies, with no pipeline. On
// an H100 (tools/ssd_scan_profile.py), planting the loads out made the
// kernels 1.9-2.5x faster, planting the products out 1.2x.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define TILE 64        // rows of an output tile and depth of a k-chunk; must equal TILE in ssd_scan.py
#define THREADS 128    // 4 warps of 16 output rows each; must equal THREADS in ssd_scan.py
#define MAX_Q 4096     // longest chunk (the backward keeps dcum for a chunk in shared memory); must equal MAX_Q in ssd_scan.py
#define LDS (TILE + 8) // bf16 row stride of a staged tile: fragment loads hit 32 banks

// A 64 x 64 operand tile split into bf16 hi and lo, [outer][inner]: the
// inner index is the one contiguous in global memory, k for some operands
// and m or n for others (mma_tile's TA, TB).
struct Operand {
  __nv_bfloat16 hi[TILE * LDS];
  __nv_bfloat16 lo[TILE * LDS];
};

// e^{ct - cs} where keep (s <= t inside the chunk), else 0: the mask comes
// BEFORE the exponential, so no inf is ever formed.
__device__ __forceinline__ float decay(float ct, float cs, bool keep) {
  return keep ? expf(ct - cs) : 0.f;
}

// 4 consecutive floats at p, the first n of them valid (the rest 0): one
// 16-byte access when all 4 are valid and p is aligned.
__device__ __forceinline__ float4 ld4(const float* p, int n) {
  if (n >= 4 && (reinterpret_cast<uintptr_t>(p) & 15) == 0)
    return *reinterpret_cast<const float4*>(p);
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
  if (n > 0) v.x = p[0];
  if (n > 1) v.y = p[1];
  if (n > 2) v.z = p[2];
  if (n > 3) v.w = p[3];
  return v;
}

__device__ __forceinline__ void st4(float* p, float4 v, int n) {
  if (n >= 4 && (reinterpret_cast<uintptr_t>(p) & 15) == 0) {
    *reinterpret_cast<float4*>(p) = v;
    return;
  }
  if (n > 0) p[0] = v.x;
  if (n > 1) p[1] = v.y;
  if (n > 2) p[2] = v.z;
  if (n > 3) p[3] = v.w;
}

__device__ __forceinline__ float4 scale4(float4 v, float s) {
  return make_float4(v.x * s, v.y * s, v.z * s, v.w * s);
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float4 zero4() {
  return make_float4(0.f, 0.f, 0.f, 0.f);
}

// A thread's share of a 64 x 64 tile: r[it] is the float4 of (o, i..i+3),
// q = it * THREADS + threadIdx.x, o = q / 16 (outer), i = 4 (q % 16)
// (inner): 16-byte runs along the inner index, so global loads coalesce.
// fetch issues all eight loads before any result is used.
template <class F>
__device__ __forceinline__ void fetch(float4 (&r)[8], F f) {
#pragma unroll
  for (int it = 0; it < TILE * TILE / (4 * THREADS); ++it) {
    const int q = it * THREADS + threadIdx.x;
    r[it] = f(q / (TILE / 4), (q % (TILE / 4)) * 4);
  }
}

// Store a fetched tile into op, split: hi = bf16(x), lo = bf16(x - hi).
__device__ __forceinline__ void put(Operand& op, const float4 (&r)[8]) {
#pragma unroll
  for (int it = 0; it < TILE * TILE / (4 * THREADS); ++it) {
    const int q = it * THREADS + threadIdx.x;
    const int o = q / (TILE / 4), i = (q % (TILE / 4)) * 4;
    const float4 x = r[it];
    const __nv_bfloat162 h01 = __floats2bfloat162_rn(x.x, x.y);
    const __nv_bfloat162 h23 = __floats2bfloat162_rn(x.z, x.w);
    const float2 f01 = __bfloat1622float2(h01), f23 = __bfloat1622float2(h23);
    const __nv_bfloat162 l01 = __floats2bfloat162_rn(x.x - f01.x, x.y - f01.y);
    const __nv_bfloat162 l23 = __floats2bfloat162_rn(x.z - f23.x, x.w - f23.y);
    *reinterpret_cast<uint2*>(op.hi + o * LDS + i) = make_uint2(bits(h01), bits(h23));
    *reinterpret_cast<uint2*>(op.lo + o * LDS + i) = make_uint2(bits(l01), bits(l23));
  }
}

template <bool TRANS>
__device__ __forceinline__ void ldsm(uint32_t r[4], const __nv_bfloat16* p) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(p);
  if (TRANS)
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 "
                 "{%0,%1,%2,%3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
  else
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 "
                 "{%0,%1,%2,%3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}

// Not volatile: the products have no side effects, so the compiler may
// interleave independent ones.
__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4],
                                         const uint32_t* b) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// acc[j] += a b_j for the 8 n-blocks j in three bf16 products each,
// lo*hi + hi*lo + hi*hi, term by term across the 8 accumulators so that
// consecutive products are independent (each term of one accumulator
// waits on the last).
__device__ __forceinline__ void mma3(float acc[8][4], const uint32_t ahi[4],
                                     const uint32_t alo[4],
                                     const uint32_t (&bhi)[16],
                                     const uint32_t (&blo)[16]) {
#pragma unroll
  for (int j = 0; j < 8; ++j) mma_bf16(acc[j], alo, bhi + 2 * j);
#pragma unroll
  for (int j = 0; j < 8; ++j) mma_bf16(acc[j], ahi, blo + 2 * j);
#pragma unroll
  for (int j = 0; j < 8; ++j) mma_bf16(acc[j], ahi, bhi + 2 * j);
}

// acc += A B^T over the 64-deep tile: warp w owns output rows 16w..16w+15,
// all 64 columns. A is staged [m][k], or [k][m] when TA; B [n][k], or
// [k][n] when TB; ldmatrix (.trans for the second kind) loads the
// fragments. acc[j][e] is row 16w + g + 8 (e >> 1), column
// 8j + 2q + (e & 1), with g = lane / 4 and q = lane % 4.
template <bool TA, bool TB>
__device__ __forceinline__ void mma_tile(const Operand& A, const Operand& B,
                                         float acc[8][4]) {
  const int w = threadIdx.x >> 5, l = threadIdx.x & 31;
  // this lane's row of the 8 x 8 matrices of one k-step
  const int a_off = TA ? ((l & 7) + 8 * (l >> 4)) * LDS + 16 * w + 8 * ((l >> 3) & 1)
                       : (16 * w + (l & 15)) * LDS + 8 * (l >> 4);
  const int b_off = TB ? ((l & 7) + 8 * ((l >> 3) & 1)) * LDS + 8 * (l >> 4)
                       : ((l & 7) + 8 * (l >> 4)) * LDS + 8 * ((l >> 3) & 1);
#pragma unroll
  for (int k0 = 0; k0 < TILE; k0 += 16) {
    uint32_t ahi[4], alo[4], bhi[16], blo[16];
    const int ak = a_off + (TA ? k0 * LDS : k0);
    ldsm<TA>(ahi, A.hi + ak);
    ldsm<TA>(alo, A.lo + ak);
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {        // n-blocks 2jj and 2jj + 1
      const int bk = b_off + (TB ? k0 * LDS + 16 * jj : 16 * jj * LDS + k0);
      ldsm<TB>(bhi + 4 * jj, B.hi + bk);
      ldsm<TB>(blo + 4 * jj, B.lo + bk);
    }
    mma3(acc, ahi, alo, bhi, blo);
  }
}

__device__ __forceinline__ void zero(float acc[8][4]) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
}

// acc += sum over k-chunks kc in [k0, k1) of A_kc B_kc^T, with fa(kc, o, i)
// and fb(kc, o, i) giving the float4s of the two staged tiles (see
// mma_tile for their layouts). Both tiles' loads are issued before either
// is stored. Whatever shared memory fa and fb read must be written and
// synced before the call. (Prefetching the next chunk's tiles during the
// products was slower on an H100, tools/ssd_scan_profile.py: 64 more
// registers a thread, and spills.)
template <bool TA, bool TB, class FA, class FB>
__device__ __forceinline__ void gemm(Operand& sA, Operand& sB, int k0, int k1,
                                     FA fa, FB fb, float acc[8][4]) {
  for (int kc = k0; kc < k1; ++kc) {
    float4 ra[8], rb[8];
    fetch(ra, [&](int o, int i) { return fa(kc, o, i); });
    fetch(rb, [&](int o, int i) { return fb(kc, o, i); });
    __syncthreads();                        // the last products are done
    put(sA, ra);
    put(sB, rb);
    __syncthreads();
    mma_tile<TA, TB>(sA, sB, acc);
  }
}

// Row and column of acc[j][e] in the warp's tile (see mma_tile).
__device__ __forceinline__ int acc_row(int e) {
  return 16 * (threadIdx.x >> 5) + ((threadIdx.x & 31) >> 2) + 8 * (e >> 1);
}
__device__ __forceinline__ int acc_col(int j, int e) {
  return 8 * j + 2 * (threadIdx.x & 3) + (e & 1);
}

// In-place inclusive prefix sum of s[0..n) (suffix sum when `reverse`), in
// a fixed order: each thread walks a contiguous run, then the run totals
// are scanned across the block. Callers sync before it; it syncs at the end.
__device__ void block_scan(float* s, int n, bool reverse) {
  __shared__ float warp_total[THREADS / 32];
  const int per = (n + THREADS - 1) / THREADS;
  const int lo = min(n, (int)threadIdx.x * per), hi = min(n, lo + per);
  float run = 0.f;
  for (int i = lo; i < hi; ++i) {
    const int at = reverse ? n - 1 - i : i;
    run += s[at];
    s[at] = run;
  }
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  float x = run;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_total[w] = x;
  __syncthreads();
  float off = x - run;
  for (int i = 0; i < w; ++i) off += warp_total[i];
  for (int i = lo; i < hi; ++i) s[reverse ? n - 1 - i : i] += off;
  __syncthreads();
}

// Index helpers. u, y, dy, du: (B, S, H, P); a, cum, da: (B, S, H);
// Bm, Cm, dB, dC: (B, S, N); hs, gs: (B, H, nc, P, N); S, dS: (B, nc, Q, Q);
// dw: (B, nc, H, nt, Q).
struct Dims {
  int S, H, P, N, Q, nc, nt;
  __device__ size_t up(size_t row, int h, int p) const {
    return (row * H + h) * P + p;
  }
  __device__ size_t ah(size_t row, int h) const { return row * H + h; }
  __device__ size_t st(int b, int h, int c, int p, int n) const {
    return ((((size_t)b * H + h) * nc + c) * P + p) * N + n;
  }
  __device__ size_t qq(int bc, int t, int s) const {
    return ((size_t)bc * Q + t) * Q + s;
  }
};

// (ti, sj) with sj <= ti from the index of a lower-triangle tile.
__device__ __forceinline__ void tri_tile(int idx, int& ti, int& sj) {
  ti = 0;
  while ((ti + 1) * (ti + 2) / 2 <= idx) ++ti;
  sj = idx - ti * (ti + 1) / 2;
}

// acc = S[ti tile][sj tile] = C B^T over N, for chunk rows starting at row0.
__device__ __forceinline__ void cb_tile(Operand& sA, Operand& sB,
                                        const float* __restrict__ Bm,
                                        const float* __restrict__ Cm,
                                        size_t row0, int ti, int sj,
                                        const Dims& d, float acc[8][4]) {
  const int t0 = ti * TILE, s0 = sj * TILE;
  zero(acc);
  gemm<false, false>(
      sA, sB, 0, (d.N + TILE - 1) / TILE,
      [&](int kc, int o, int i) {             // [t][n]
        const int n = kc * TILE + i;
        return ld4(Cm + (row0 + t0 + o) * d.N + n, t0 + o < d.Q ? d.N - n : 0);
      },
      [&](int kc, int o, int i) {             // [s][n]
        const int n = kc * TILE + i;
        return ld4(Bm + (row0 + s0 + o) * d.N + n, s0 + o < d.Q ? d.N - n : 0);
      },
      acc);
}

// scum[0 .. nt * TILE) <- cum of chunk row0.., head h, zero past Q.
__device__ __forceinline__ void load_cum(float* scum,
                                         const float* __restrict__ cum,
                                         size_t row0, int h, const Dims& d) {
  for (int t = threadIdx.x; t < d.nt * TILE; t += THREADS)
    scum[t] = t < d.Q ? cum[d.ah(row0 + t, h)] : 0.f;
}

// ------------------------------------------------- 1. chunk states, and cum
// grid B * nc * H * ceil(P / TILE) * ceil(N / TILE), the n-tiles of one
// (b, c, h, p-tile) adjacent (they share its V tiles in L2).
// out[b,h,c][p][n] = sum_t w_t V[t,h,p] M[t,n] with w_t = e^{cum_{Q-1} -
// cum_t} (forward: V = u, M = Bm) or e^{cum_t} (backward: V = dy, M = Cm).
// The (0, 0) tile of each (b, c, h) writes cum.
__global__ void __launch_bounds__(THREADS, 3)
chunk_state_kernel(const float* __restrict__ V, const float* __restrict__ a,
                   const float* __restrict__ M, float* __restrict__ cum,
                   float* __restrict__ out, Dims d, int backward) {
  extern __shared__ __align__(16) unsigned char smem[];
  Operand& sA = *reinterpret_cast<Operand*>(smem);
  Operand& sB = *reinterpret_cast<Operand*>(smem + sizeof(Operand));
  float* sw = reinterpret_cast<float*>(smem + 2 * sizeof(Operand));  // [Q]
  const int ntn = (d.N + TILE - 1) / TILE, npt = (d.P + TILE - 1) / TILE;
  const int nti = blockIdx.x % ntn, pti = blockIdx.x / ntn % npt;
  const int bch = blockIdx.x / ntn / npt;
  const int h = bch % d.H, bc = bch / d.H;
  const int c = bc % d.nc, b = bc / d.nc;
  const int p0 = pti * TILE, n0 = nti * TILE;
  const size_t row0 = (size_t)b * d.S + (size_t)c * d.Q;
  for (int t = threadIdx.x; t < d.Q; t += THREADS) sw[t] = a[d.ah(row0 + t, h)];
  __syncthreads();
  block_scan(sw, d.Q, false);
  const float last = sw[d.Q - 1];
  const bool writer = pti == 0 && nti == 0;
  __syncthreads();
  for (int t = threadIdx.x; t < d.Q; t += THREADS) {
    if (writer) cum[d.ah(row0 + t, h)] = sw[t];
    sw[t] = backward ? expf(sw[t]) : expf(last - sw[t]);
  }
  __syncthreads();
  float acc[8][4];
  zero(acc);
  gemm<true, true>(
      sA, sB, 0, d.nt,
      [&](int kc, int o, int i) {             // [t][p], scaled by w_t
        const int t = kc * TILE + o;
        return t < d.Q ? scale4(ld4(V + d.up(row0 + t, h, p0 + i),
                                    d.P - p0 - i), sw[t])
                       : zero4();
      },
      [&](int kc, int o, int i) {             // [t][n]
        const int t = kc * TILE + o;
        return ld4(M + (row0 + t) * d.N + n0 + i, t < d.Q ? d.N - n0 - i : 0);
      },
      acc);
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int p = p0 + acc_row(e), n = n0 + acc_col(j, e);
      if (p < d.P && n < d.N) out[d.st(b, h, c, p, n)] = acc[j][e];
    }
}

// ------------------------------------------------------- 2. state passing
// grid B * H * ceil(P * N / (4 * THREADS)), four state elements a thread,
// in place over buf (B, H, nc, P, N): forward, chunk 0 first, buf[c] <- the
// state before chunk c; backward, the last chunk first, buf[c] <- the
// cotangent of the state after chunk c. `last` <- h_final or dh0. The next
// chunk's value is loaded before this one's is stored.
__global__ void __launch_bounds__(THREADS)
state_pass_kernel(float* __restrict__ buf, const float* __restrict__ cum,
                  const float* __restrict__ init, float* __restrict__ last,
                  Dims d, int backward) {
  const int PN = d.P * d.N, nblk = (PN + 4 * THREADS - 1) / (4 * THREADS);
  const int bh = blockIdx.x / nblk, b = bh / d.H, h = bh % d.H;
  const int e = ((blockIdx.x % nblk) * THREADS + threadIdx.x) * 4;
  const int n = PN - e;
  if (n <= 0) return;
  const float4 zero4 = make_float4(0.f, 0.f, 0.f, 0.f);
  float4 x = init != nullptr ? ld4(init + (size_t)bh * PN + e, n) : zero4;
  float* base = buf + (size_t)bh * d.nc * PN + e;
  int c = backward ? d.nc - 1 : 0;
  float4 add = ld4(base + (size_t)c * PN, n);
  for (int i = 0; i < d.nc; ++i) {
    const int cn = backward ? c - 1 : c + 1;
    const float4 next = i + 1 < d.nc ? ld4(base + (size_t)cn * PN, n) : zero4;
    const float A = cum[d.ah((size_t)b * d.S + (size_t)c * d.Q + d.Q - 1, h)];
    st4(base + (size_t)c * PN, x, n);
    const float ea = expf(A);
    x = make_float4(x.x * ea + add.x, x.y * ea + add.y, x.z * ea + add.z,
                    x.w * ea + add.w);
    add = next;
    c = cn;
  }
  st4(last + (size_t)bh * PN + e, x, n);
}

// ------------------------------------------------------------- 3a. S = C B^T
// grid B * nc * nt (nt + 1) / 2: the lower-triangle tiles of S, the tiles
// of one chunk adjacent.
__global__ void __launch_bounds__(THREADS, 3)
cb_kernel(const float* __restrict__ Bm, const float* __restrict__ Cm,
          float* __restrict__ Sm, Dims d) {
  extern __shared__ __align__(16) unsigned char smem[];
  Operand& sA = *reinterpret_cast<Operand*>(smem);
  Operand& sB = *reinterpret_cast<Operand*>(smem + sizeof(Operand));
  const int ntri = d.nt * (d.nt + 1) / 2;
  const int bc = blockIdx.x / ntri, b = bc / d.nc, c = bc % d.nc;
  int ti, sj;
  tri_tile(blockIdx.x % ntri, ti, sj);
  const size_t row0 = (size_t)b * d.S + (size_t)c * d.Q;
  float acc[8][4];
  cb_tile(sA, sB, Bm, Cm, row0, ti, sj, d, acc);
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int t = ti * TILE + acc_row(e), s = sj * TILE + acc_col(j, e);
      if (t < d.Q && s < d.Q) Sm[d.qq(bc, t, s)] = acc[j][e];
    }
}

// -------------------------------------------------------- 3b. chunk scan
// grid B * nc * H * ceil(P / TILE) * nt, the t-tiles of one (b, c, h,
// p-tile) adjacent: y rows ti*TILE.. of chunk c, head h, columns p0.. =
// sum_{s <= t} S[t,s] L[t,s] u_s + e^{cum_t} C_t hs[c]^T. Key tiles above
// the diagonal are skipped.
__global__ void __launch_bounds__(THREADS, 3)
scan_fwd_kernel(const float* __restrict__ u, const float* __restrict__ Cm,
                const float* __restrict__ cum, const float* __restrict__ Sm,
                const float* __restrict__ hs, float* __restrict__ y, Dims d) {
  extern __shared__ __align__(16) unsigned char smem[];
  Operand& sA = *reinterpret_cast<Operand*>(smem);
  Operand& sB = *reinterpret_cast<Operand*>(smem + sizeof(Operand));
  float* scum = reinterpret_cast<float*>(smem + 2 * sizeof(Operand));
  const int npt = (d.P + TILE - 1) / TILE;
  const int ti = blockIdx.x % d.nt, pti = blockIdx.x / d.nt % npt;
  const int bch = blockIdx.x / d.nt / npt;
  const int h = bch % d.H, bc = bch / d.H;
  const int c = bc % d.nc, b = bc / d.nc;
  const int t0 = ti * TILE, p0 = pti * TILE;
  const size_t row0 = (size_t)b * d.S + (size_t)c * d.Q;
  load_cum(scum, cum, row0, h, d);
  __syncthreads();
  float acc[8][4];
  zero(acc);
  gemm<false, true>(
      sA, sB, 0, ti + 1,
      [&](int kc, int o, int i) {             // [t][s]: S o L
        const int t = t0 + o, s = kc * TILE + i;
        float4 v = zero4();
        if (t < d.Q) {
          v = ld4(Sm + d.qq(bc, t, s), d.Q - s);
          v.x *= decay(scum[t], scum[s], s <= t);
          v.y *= decay(scum[t], scum[s + 1], s + 1 <= t);
          v.z *= decay(scum[t], scum[s + 2], s + 2 <= t);
          v.w *= decay(scum[t], scum[s + 3], s + 3 <= t);
        }
        return v;
      },
      [&](int kc, int o, int i) {             // [s][p]
        const int s = kc * TILE + o;
        return ld4(u + d.up(row0 + s, h, p0 + i), s < d.Q ? d.P - p0 - i : 0);
      },
      acc);
  gemm<false, false>(
      sA, sB, 0, (d.N + TILE - 1) / TILE,
      [&](int kc, int o, int i) {             // [t][n], scaled by e^{cum_t}
        const int t = t0 + o, n = kc * TILE + i;
        return t < d.Q ? scale4(ld4(Cm + (row0 + t) * d.N + n, d.N - n),
                                expf(scum[t]))
                       : zero4();
      },
      [&](int kc, int o, int i) {             // [p][n]
        const int n = kc * TILE + i;
        return ld4(hs + d.st(b, h, c, p0 + o, n), p0 + o < d.P ? d.N - n : 0);
      },
      acc);
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int t = t0 + acc_row(e), p = p0 + acc_col(j, e);
      if (t < d.Q && p < d.P) y[d.up(row0 + t, h, p)] = acc[j][e];
    }
}

// ------------------------------------------------ backward 3. S, dS and dw
// grid B * nc * nt (nt + 1) / 2: tile (ti, sj), sj <= ti. Writes the S
// tile, the dS tile (the heads summed here, in order), and for each head
// the tile's row sums of W (at slot sj, rows of tile ti) and minus its
// column sums (at slot ti, columns of tile sj); a diagonal tile writes
// rows minus columns at slot ti. So every (b, c, h, slot, position) of dw
// is written once, and dcum_t = sum over the nt slots at t.
__global__ void __launch_bounds__(THREADS)
ds_kernel(const float* __restrict__ dy, const float* __restrict__ u,
          const float* __restrict__ Bm, const float* __restrict__ Cm,
          const float* __restrict__ cum, float* __restrict__ Sm,
          float* __restrict__ dSm, float* __restrict__ dw, Dims d) {
  extern __shared__ __align__(16) unsigned char smem[];
  Operand& sA = *reinterpret_cast<Operand*>(smem);
  Operand& sB = *reinterpret_cast<Operand*>(smem + sizeof(Operand));
  float* sS = reinterpret_cast<float*>(smem + 2 * sizeof(Operand));
  float* rsum = sS + TILE * (TILE + 4);       // [TILE]
  float* cpart = rsum + TILE;                 // [4][TILE]
  float* srow = cpart + 4 * TILE;             // [H][TILE]: cum of the rows
  float* scol = srow + d.H * TILE;            // [H][TILE]: of the columns
  const int ntri = d.nt * (d.nt + 1) / 2;
  const int bc = blockIdx.x / ntri, b = bc / d.nc, c = bc % d.nc;
  int ti, sj;
  tri_tile(blockIdx.x % ntri, ti, sj);
  const int t0 = ti * TILE, s0 = sj * TILE;
  const size_t row0 = (size_t)b * d.S + (size_t)c * d.Q;
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float ds[8][4], g[8][4];
  cb_tile(sA, sB, Bm, Cm, row0, ti, sj, d, g);
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = acc_row(e), k = acc_col(j, e);
      sS[r * (TILE + 4) + k] = g[j][e];      // read back by this thread only
      if (t0 + r < d.Q && s0 + k < d.Q) Sm[d.qq(bc, t0 + r, s0 + k)] = g[j][e];
    }
  for (int q = threadIdx.x; q < d.H * TILE; q += THREADS) {
    const int hh = q / TILE, i = q % TILE;
    srow[q] = t0 + i < d.Q ? cum[d.ah(row0 + t0 + i, hh)] : 0.f;
    scol[q] = s0 + i < d.Q ? cum[d.ah(row0 + s0 + i, hh)] : 0.f;
  }
  zero(ds);
  zero(g);
  const int npt = (d.P + TILE - 1) / TILE, nk = d.H * npt;
  auto fa = [&](int kc, int o, int i) {       // [t][p] of head kc / npt
    const int p = (kc % npt) * TILE + i;
    return ld4(dy + d.up(row0 + t0 + o, kc / npt, p),
               t0 + o < d.Q ? d.P - p : 0);
  };
  auto fb = [&](int kc, int o, int i) {       // [s][p]
    const int p = (kc % npt) * TILE + i;
    return ld4(u + d.up(row0 + s0 + o, kc / npt, p),
               s0 + o < d.Q ? d.P - p : 0);
  };
  for (int kc = 0; kc < nk; ++kc) {
    gemm<false, false>(sA, sB, kc, kc + 1, fa, fb, g);  // dG = dy_h u_h^T
    if (kc % npt != npt - 1) continue;
    // head h is complete: dS += dG o L_h, and W_h's row and column sums
    const int h = kc / npt;
    const float* cr = srow + h * TILE;
    const float* cc = scol + h * TILE;
    float rs[2] = {0.f, 0.f}, cs[8][2];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      cs[j][0] = cs[j][1] = 0.f;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = acc_row(e), k = acc_col(j, e);
        const int t = t0 + r, s = s0 + k;
        const float L = decay(cr[r], cc[k], t < d.Q && s <= t);
        ds[j][e] += g[j][e] * L;
        const float wv = g[j][e] * sS[r * (TILE + 4) + k] * L;
        rs[e >> 1] += wv;
        cs[j][e & 1] += wv;
        g[j][e] = 0.f;
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      rs[i] += __shfl_xor_sync(0xffffffffu, rs[i], 1);
      rs[i] += __shfl_xor_sync(0xffffffffu, rs[i], 2);
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        cs[j][i] += __shfl_xor_sync(0xffffffffu, cs[j][i], 4);
        cs[j][i] += __shfl_xor_sync(0xffffffffu, cs[j][i], 8);
        cs[j][i] += __shfl_xor_sync(0xffffffffu, cs[j][i], 16);
      }
    if ((lane & 3) == 0) {
      rsum[acc_row(0)] = rs[0];
      rsum[acc_row(2)] = rs[1];
    }
    if ((lane >> 2) == 0) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        cpart[w * TILE + acc_col(j, 0)] = cs[j][0];
        cpart[w * TILE + acc_col(j, 1)] = cs[j][1];
      }
    }
    __syncthreads();
    if (threadIdx.x < TILE) {
      const int i = threadIdx.x;
      const float col = cpart[i] + cpart[TILE + i] + cpart[2 * TILE + i] +
                        cpart[3 * TILE + i];
      float* base = dw + ((size_t)bc * d.H + h) * d.nt * d.Q;
      if (ti == sj) {
        if (t0 + i < d.Q) base[(size_t)ti * d.Q + t0 + i] = rsum[i] - col;
      } else {
        if (t0 + i < d.Q) base[(size_t)sj * d.Q + t0 + i] = rsum[i];
        if (s0 + i < d.Q) base[(size_t)ti * d.Q + s0 + i] = -col;
      }
    }
  }
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int t = t0 + acc_row(e), s = s0 + acc_col(j, e);
      if (t < d.Q && s < d.Q) dSm[d.qq(bc, t, s)] = ds[j][e];
    }
}

// ------------------------------------------------- backward 4. du and da
// grid B * nc * H, one block per chunk and head, walking its row tiles:
//   du_t = sum_{s >= t} S[s,t] L[s,t] dy_s + e^{cum_{Q-1} - cum_t} B_t gs^T
//   dcum_t = sum_slots dw + e^{cum_t} C_t . (dy_t hs) - u_t . du_state_t,
//   dcum_{Q-1} += e^{cum_{Q-1}} <gs, hs> + sum_t u_t . du_state_t,
//   da = the reverse cumsum of dcum over the chunk.
__global__ void __launch_bounds__(THREADS, 3)
duda_kernel(const float* __restrict__ dy, const float* __restrict__ u,
            const float* __restrict__ Bm, const float* __restrict__ Cm,
            const float* __restrict__ cum, const float* __restrict__ Sm,
            const float* __restrict__ hs, const float* __restrict__ gs,
            const float* __restrict__ dw, float* __restrict__ du,
            float* __restrict__ da, Dims d) {
  extern __shared__ __align__(16) unsigned char smem[];
  Operand& sA = *reinterpret_cast<Operand*>(smem);
  Operand& sB = *reinterpret_cast<Operand*>(smem + sizeof(Operand));
  float* red = reinterpret_cast<float*>(smem + 2 * sizeof(Operand));
  float* scum = red + THREADS;                // [nt * TILE]
  float* dcum = scum + d.nt * TILE;           // [Q]
  float* zs = dcum + d.Q;                     // [Q]
  const int h = blockIdx.x % d.H, bc = blockIdx.x / d.H;
  const int c = bc % d.nc, b = bc / d.nc;
  const size_t row0 = (size_t)b * d.S + (size_t)c * d.Q;
  const float A = cum[d.ah(row0 + d.Q - 1, h)];
  const int lane = threadIdx.x & 31;
  const int npt = (d.P + TILE - 1) / TILE, ntn = (d.N + TILE - 1) / TILE;

  // <gs, hs> over the (P, N) state, in a fixed order
  float part = 0.f;
  for (int i = threadIdx.x; i < d.P * d.N; i += THREADS)
    part += gs[d.st(b, h, c, 0, 0) + i] * hs[d.st(b, h, c, 0, 0) + i];
  red[threadIdx.x] = part;
  load_cum(scum, cum, row0, h, d);
  __syncthreads();

  float acc[8][4];
  for (int ri = 0; ri < d.nt; ++ri) {
    const int t0 = ri * TILE;
    float z[2] = {0.f, 0.f}, x[2] = {0.f, 0.f};
    for (int pti = 0; pti < npt; ++pti) {
      const int p0 = pti * TILE;
      zero(acc);
      // the state term first: du_state = (e^{A - cum} o B) gs^T
      gemm<false, false>(
          sA, sB, 0, ntn,
          [&](int kc, int o, int i) {         // [t][n], scaled
            const int t = t0 + o, n = kc * TILE + i;
            return t < d.Q ? scale4(ld4(Bm + (row0 + t) * d.N + n, d.N - n),
                                    expf(A - scum[t]))
                           : zero4();
          },
          [&](int kc, int o, int i) {         // [p][n]
            const int n = kc * TILE + i;
            return ld4(gs + d.st(b, h, c, p0 + o, n),
                       p0 + o < d.P ? d.N - n : 0);
          },
          acc);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int t = t0 + acc_row(e), p = p0 + acc_col(j, e);
          if (t < d.Q && p < d.P)
            z[e >> 1] += u[d.up(row0 + t, h, p)] * acc[j][e];
        }
      // then the intra term: (S o L)^T dy over the steps s >= t
      gemm<true, true>(
          sA, sB, ri, d.nt,
          [&](int kc, int o, int i) {         // [s][t]: (S o L)^T
            const int s = kc * TILE + o, t = t0 + i;
            float4 v = zero4();
            if (s < d.Q) {
              v = ld4(Sm + d.qq(bc, s, t), d.Q - t);
              v.x *= decay(scum[s], scum[t], t <= s);
              v.y *= decay(scum[s], scum[t + 1], t + 1 <= s);
              v.z *= decay(scum[s], scum[t + 2], t + 2 <= s);
              v.w *= decay(scum[s], scum[t + 3], t + 3 <= s);
            }
            return v;
          },
          [&](int kc, int o, int i) {         // [s][p]
            const int s = kc * TILE + o;
            return ld4(dy + d.up(row0 + s, h, p0 + i),
                       s < d.Q ? d.P - p0 - i : 0);
          },
          acc);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int t = t0 + acc_row(e), p = p0 + acc_col(j, e);
          if (t < d.Q && p < d.P) du[d.up(row0 + t, h, p)] = acc[j][e];
        }
    }
    // the y_inter term: e^{cum_t} C_t . (dy_t hs), with dy hs over P
    for (int nti = 0; nti < ntn; ++nti) {
      const int n0 = nti * TILE;
      zero(acc);
      gemm<false, true>(
          sA, sB, 0, npt,
          [&](int kc, int o, int i) {         // [t][p]
            const int p = kc * TILE + i;
            return ld4(dy + d.up(row0 + t0 + o, h, p),
                       t0 + o < d.Q ? d.P - p : 0);
          },
          [&](int kc, int o, int i) {         // [p][n]
            const int p = kc * TILE + o;
            return ld4(hs + d.st(b, h, c, p, n0 + i),
                       p < d.P ? d.N - n0 - i : 0);
          },
          acc);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int t = t0 + acc_row(e), n = n0 + acc_col(j, e);
          if (t < d.Q && n < d.N)
            x[e >> 1] += Cm[(row0 + t) * d.N + n] * acc[j][e];
        }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      z[i] += __shfl_xor_sync(0xffffffffu, z[i], 1);
      z[i] += __shfl_xor_sync(0xffffffffu, z[i], 2);
      x[i] += __shfl_xor_sync(0xffffffffu, x[i], 1);
      x[i] += __shfl_xor_sync(0xffffffffu, x[i], 2);
    }
    if ((lane & 3) == 0) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int t = t0 + acc_row(2 * i);
        if (t < d.Q) {
          float s = 0.f;
          for (int slot = 0; slot < d.nt; ++slot)
            s += dw[(((size_t)bc * d.H + h) * d.nt + slot) * d.Q + t];
          dcum[t] = s + expf(scum[t]) * x[i] - z[i];
          zs[t] = z[i];
        }
      }
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float tot = 0.f;
    for (int i = 0; i < THREADS; ++i) tot += red[i];
    float zt = 0.f;
    for (int t = 0; t < d.Q; ++t) zt += zs[t];
    dcum[d.Q - 1] += expf(A) * tot + zt;
  }
  __syncthreads();
  block_scan(dcum, d.Q, true);
  for (int t = threadIdx.x; t < d.Q; t += THREADS)
    da[d.ah(row0 + t, h)] = dcum[t];
}

// ------------------------------------------------- backward 5. dB and dC
// grid B * nc * nt * 2 ceil(N / TILE), z = 2 * n-tile + which fastest;
// which 0: dC rows ti*TILE.. = dS B + sum_h (e^{cum} o dy_h) hs_h; which 1:
// dB rows = dS^T C + sum_h (e^{cum_{Q-1} - cum} o u_h) gs_h. Each sum in
// one accumulator, in a fixed order: the dS term, then the heads in order.
__global__ void __launch_bounds__(THREADS, 3)
dbdc_kernel(const float* __restrict__ dy, const float* __restrict__ u,
            const float* __restrict__ Bm, const float* __restrict__ Cm,
            const float* __restrict__ cum, const float* __restrict__ dSm,
            const float* __restrict__ hs, const float* __restrict__ gs,
            float* __restrict__ dB, float* __restrict__ dC, Dims d) {
  extern __shared__ __align__(16) unsigned char smem[];
  Operand& sA = *reinterpret_cast<Operand*>(smem);
  Operand& sB = *reinterpret_cast<Operand*>(smem + sizeof(Operand));
  float* srow = reinterpret_cast<float*>(smem + 2 * sizeof(Operand));
  const int nz = 2 * ((d.N + TILE - 1) / TILE);
  const int z = blockIdx.x % nz, ti = blockIdx.x / nz % d.nt;
  const int bc = blockIdx.x / nz / d.nt, b = bc / d.nc, c = bc % d.nc;
  const int t0 = ti * TILE, n0 = (z >> 1) * TILE;
  const bool is_db = z & 1;
  const size_t row0 = (size_t)b * d.S + (size_t)c * d.Q;
  // [H][TILE]: each head's row scale, e^{cum} (dC) or e^{cum_{Q-1} - cum}
  for (int q = threadIdx.x; q < d.H * TILE; q += THREADS) {
    const int hh = q / TILE, t = t0 + q % TILE;
    const float ct = t < d.Q ? cum[d.ah(row0 + t, hh)] : 0.f;
    srow[q] = is_db ? expf(cum[d.ah(row0 + d.Q - 1, hh)] - ct) : expf(ct);
  }
  __syncthreads();
  float acc[8][4];
  zero(acc);
  // the intra term: dS B (over s <= t) or dS^T C (over s >= t); dB's A
  // operand dS^T is staged [s][t], dC's dS [t][s]
  const float* other = is_db ? Cm : Bm;
  auto fa = [&](int kc, int o, int i) {
    const int ao = is_db ? kc * TILE : t0, ai = is_db ? t0 : kc * TILE;
    return ld4(dSm + d.qq(bc, ao + o, ai + i), ao + o < d.Q ? d.Q - ai - i : 0);
  };
  auto fb = [&](int kc, int o, int i) {       // [s][n]
    const int s = kc * TILE + o;
    return ld4(other + (row0 + s) * d.N + n0 + i, s < d.Q ? d.N - n0 - i : 0);
  };
  if (is_db)
    gemm<true, true>(sA, sB, ti, d.nt, fa, fb, acc);
  else
    gemm<false, true>(sA, sB, 0, ti + 1, fa, fb, acc);
  // the state terms, one head after another: K = H * P
  const float* V = is_db ? u : dy;
  const float* G = is_db ? gs : hs;
  const int npt = (d.P + TILE - 1) / TILE;
  const int heads = d.H * npt;                // K = H * P, heads in order
  gemm<false, true>(
      sA, sB, 0, heads,
      [&](int kc, int o, int i) {             // [t][p], scaled by row
        const int hh = kc / npt, p = (kc % npt) * TILE + i;
        return scale4(ld4(V + d.up(row0 + t0 + o, hh, p),
                          t0 + o < d.Q ? d.P - p : 0),
                      srow[hh * TILE + o]);
      },
      [&](int kc, int o, int i) {             // [p][n]
        const int hh = kc / npt, p = (kc % npt) * TILE + o;
        return ld4(G + d.st(b, hh, c, p, n0 + i), p < d.P ? d.N - n0 - i : 0);
      },
      acc);
  float* out = is_db ? dB : dC;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int t = t0 + acc_row(e), n = n0 + acc_col(j, e);
      if (t < d.Q && n < d.N) out[(row0 + t) * d.N + n] = acc[j][e];
    }
}

// ------------------------------------------------------------------ launch
static const size_t OPS = 2 * sizeof(Operand);

template <class K>
static cudaError_t prepare(K kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

static cudaError_t dims(int B, int S, int H, int P, int N, int Q, Dims& d) {
  if (B < 1 || H < 1 || P < 1 || N < 1 || Q < 1 || Q > MAX_Q || S % Q)
    return cudaErrorInvalidValue;
  d.S = S; d.H = H; d.P = P; d.N = N; d.Q = Q;
  d.nc = S / Q;
  d.nt = (Q + TILE - 1) / TILE;
  return cudaSuccess;
}

// cum (B, S, H) and S (B, nc, Q, Q) are the caller's scratch.
extern "C" int reft_ssd_fwd(const void* u, const void* a, const void* Bm,
                            const void* Cm, const void* h0, void* y,
                            void* h_final, void* hs, void* cum, void* Sm,
                            int B, int S, int H, int P, int N, int Q,
                            int device, void* stream_) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  Dims d;
  if ((e = dims(B, S, H, P, N, Q, d)) != cudaSuccess) return (int)e;
  cudaStream_t st = (cudaStream_t)stream_;
  const int pt = (P + TILE - 1) / TILE, ntn = (N + TILE - 1) / TILE;
  const size_t sm1 = OPS + sizeof(float) * Q;
  const size_t sm3 = OPS + sizeof(float) * d.nt * TILE;
  if ((e = prepare(chunk_state_kernel, sm1)) != cudaSuccess ||
      (e = prepare(cb_kernel, OPS)) != cudaSuccess ||
      (e = prepare(scan_fwd_kernel, sm3)) != cudaSuccess)
    return (int)e;
  chunk_state_kernel<<<B * d.nc * H * pt * ntn, THREADS, sm1, st>>>(
      (const float*)u, (const float*)a, (const float*)Bm, (float*)cum,
      (float*)hs, d, 0);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  state_pass_kernel<<<B * H * ((P * N + 4 * THREADS - 1) / (4 * THREADS)),
                      THREADS, 0, st>>>((float*)hs, (const float*)cum,
                               (const float*)h0, (float*)h_final, d, 0);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  cb_kernel<<<B * d.nc * (d.nt * (d.nt + 1) / 2), THREADS, OPS, st>>>(
      (const float*)Bm, (const float*)Cm, (float*)Sm, d);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  scan_fwd_kernel<<<B * d.nc * H * pt * d.nt, THREADS, sm3, st>>>(
      (const float*)u, (const float*)Cm, (const float*)cum, (const float*)Sm,
      (const float*)hs, (float*)y, d);
  return (int)cudaGetLastError();
}

// cum (B, S, H), S and dS (B, nc, Q, Q), dw (B, nc, H, nt, Q) are the
// caller's scratch; gs (B, H, nc, P, N) too.
extern "C" int reft_ssd_bwd(const void* dy, const void* dh_final,
                            const void* u, const void* a, const void* Bm,
                            const void* Cm, const void* hs, void* du,
                            void* da, void* dB, void* dC, void* dh0,
                            void* cum, void* gs, void* Sm, void* dSm,
                            void* dw, int B, int S, int H, int P, int N,
                            int Q, int device, void* stream_) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  Dims d;
  if ((e = dims(B, S, H, P, N, Q, d)) != cudaSuccess) return (int)e;
  cudaStream_t st = (cudaStream_t)stream_;
  const int pt = (P + TILE - 1) / TILE, ntn = (N + TILE - 1) / TILE;
  const size_t sm1 = OPS + sizeof(float) * Q;
  const size_t sm3 =
      OPS + sizeof(float) * (TILE * (TILE + 4) + 5 * TILE + 2 * H * TILE);
  const size_t sm4 = OPS + sizeof(float) * (THREADS + d.nt * TILE + 2 * Q);
  const size_t sm5 = OPS + sizeof(float) * H * TILE;
  if ((e = prepare(chunk_state_kernel, sm1)) != cudaSuccess ||
      (e = prepare(ds_kernel, sm3)) != cudaSuccess ||
      (e = prepare(duda_kernel, sm4)) != cudaSuccess ||
      (e = prepare(dbdc_kernel, sm5)) != cudaSuccess)
    return (int)e;
  chunk_state_kernel<<<B * d.nc * H * pt * ntn, THREADS, sm1, st>>>(
      (const float*)dy, (const float*)a, (const float*)Cm, (float*)cum,
      (float*)gs, d, 1);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  state_pass_kernel<<<B * H * ((P * N + 4 * THREADS - 1) / (4 * THREADS)),
                      THREADS, 0, st>>>((float*)gs, (const float*)cum,
                               (const float*)dh_final, (float*)dh0, d, 1);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  ds_kernel<<<B * d.nc * (d.nt * (d.nt + 1) / 2), THREADS, sm3, st>>>(
      (const float*)dy, (const float*)u, (const float*)Bm, (const float*)Cm,
      (const float*)cum, (float*)Sm, (float*)dSm, (float*)dw, d);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  duda_kernel<<<B * d.nc * H, THREADS, sm4, st>>>(
      (const float*)dy, (const float*)u, (const float*)Bm, (const float*)Cm,
      (const float*)cum, (const float*)Sm, (const float*)hs,
      (const float*)gs, (const float*)dw, (float*)du, (float*)da, d);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  dbdc_kernel<<<B * d.nc * d.nt * 2 * ntn, THREADS, sm5, st>>>(
      (const float*)dy, (const float*)u, (const float*)Bm, (const float*)Cm,
      (const float*)cum, (const float*)dSm, (const float*)hs,
      (const float*)gs, (float*)dB, (float*)dC, d);
  return (int)cudaGetLastError();
}

extern "C" const char* reft_ssd_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
