// Sliding-window (banded, causal or not) GQA flash attention for Hopper
// (sm_90a), fp32 route: the forward kernel and the two kernels of its
// gradient for float32 inputs. bfloat16 inputs, the type of the training
// path, run the tensor-core kernels of swa_flash_bf16.cu instead.
//
// Replaces the TPU kernel repro/kernels/swa_attention.py::swa_flash (Pallas
// _flash_kernel). The TPU kernel walks the KV blocks as a sequential grid
// axis, keeping the output tile and the running max / normaliser resident
// in VMEM from one grid step to the next, and skips the blocks outside the
// band with pl.when. Hopper's blocks run in parallel and in no order, so a
// block here owns one tile of query rows and walks its band of KV tiles in
// a loop, with the running state in registers.
//
// Contract (the reference's): q (B,Sq,KV,G,hd), k/v (B,Sk,KV,hd), all
// float32, contiguous; query head h = kv*G + g; output (B,Sq,KV,G,hd);
// positions count from 0 in both q and k. Query qpos sees key kpos when
// (!causal || kpos <= qpos) and |qpos - kpos| < window.
//
// Numerics follow the reference (_flash_kernel, models/flash.py): scores
// are fp32 sums of products, scaled by hd^-0.5; a masked score is the
// sentinel NEG_INF = -1e30, not -inf, so a row that is wholly masked in an
// early tile takes p = exp(0) = 1 there and is wiped exactly by
// corr = exp(-1e30 - m) = 0 once a tile holds one of its keys; the output
// is acc / max(l, 1e-30). The forward also writes lse = m + log(l) (fp32,
// (B,KV,G,Sq)), which the backward reads.
//
// Backward (no TPU counterpart: the JAX package lets XLA differentiate
// models/flash.py). With P = exp(s - lse) (0 where masked),
// D = rowsum(dO o O), dS = P o (dO V^T - D):
//   fp32_dq_kernel:   one block per (b, kv, g, query tile);
//                     dQ = scale dS K over the band's KV tiles.
//   fp32_dkdv_kernel: one block per (b, kv, KV tile); loops over the G
//                     query heads of the group, then the band's query
//                     tiles; dV += P^T dO, dK += scale dS^T Q.
// Both compute D from O and dO themselves. dK and dV sum over g and the
// query tiles in one block, in a fixed order: no atomics, so the gradient
// is deterministic.
//
// Arithmetic is fp32 FMA on the CUDA cores: fp32 on the tensor cores would
// be TF32, which misses the fp32 tolerances these kernels are held to.
// Every block has 16 x TY threads; thread (ty, tx) owns rows
// 4 ty .. 4 ty + 3 of the tile and columns tx + 16 c (c < 4) of a 64-wide
// score tile, and the accumulator columns 4 tx + 64 e .. + 3 (e < hd / 64).
// The operand whose rows a thread owns sits transposed in shared memory
// ([hd][rows], read as float4 across its 4 rows, broadcast within a warp);
// the other sits row-major with rows padded to hd + 4 floats (read as
// float4 along d, conflict-free for 8 consecutive tx). P and dS go through
// shared memory, column-major with rows padded to rows + 4.
//
// Head widths: each kernel is compiled for HS, the rows' real width, and
// runs at HD = padded(HS), the next multiple of 64: 64, 128 and 256 run
// as they are; 80, 96 and 112 run the hd-128 tiles, the columns past HS
// zero in shared memory (the loads fill them), so every product over HD
// is the product over HS, and the stores write only HS columns a row.
#include <cuda_runtime.h>
#include <stdint.h>

#define COLS 64            // must equal FP32_COLS in swa_attention.py
#define FWD_TY 16          // forward rows: 4 * FWD_TY = FP32_ROWS in swa_attention.py
#define NEG_INF (-1e30f)

// the width the products run at: hd rounded up to a multiple of 64
__host__ __device__ constexpr int padded(int hd) { return (hd + 63) / 64 * 64; }

// --------------------------------------------------------------- helpers
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

__device__ __forceinline__ float4 zero4() {
  return make_float4(0.f, 0.f, 0.f, 0.f);
}

__device__ __forceinline__ void unpack(float4 v, float* out) {
  out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
}

// max / sum over the 16 lanes of one half-warp (the tx of one ty)
__device__ __forceinline__ float row_max16(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float row_sum16(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ bool visible(int qpos, int kpos, int window,
                                        int causal) {
  return (!causal || kpos <= qpos) && (qpos - kpos < window) &&
         (kpos - qpos < window);
}

// n rows of HS values starting at row `pos0` of a (S, row_stride) array,
// into dst[n][LD] (row-major, padded); rows at or past S, and columns at
// or past HS (to HD), are zeros.
template <int HD, int NT, int HS = HD>
__device__ __forceinline__ void load_rows(float* dst, const float* src,
                                          long long row_stride, int pos0,
                                          int n, int S) {
  constexpr int LD = HD + 4, C4 = HD / 4;
  for (int idx = threadIdx.x; idx < n * C4; idx += NT) {
    const int row = idx / C4, d = (idx % C4) * 4;
    const int pos = pos0 + row;
    const float4 x = pos < S && (HS == HD || d < HS)
                         ? load4(src + (long long)pos * row_stride + d)
                         : zero4();
    store4(dst + row * LD + d, x);
  }
}

// n rows as above, transposed into dst[HD][n]
template <int HD, int NT, int HS = HD>
__device__ __forceinline__ void load_rows_t(float* dst, const float* src,
                                            long long row_stride, int pos0,
                                            int n, int S) {
  for (int idx = threadIdx.x; idx < n * (HD / 4); idx += NT) {
    const int row = idx % n, d = (idx / n) * 4;
    const int pos = pos0 + row;
    float x[4];
    unpack(pos < S && (HS == HD || d < HS)
               ? load4(src + (long long)pos * row_stride + d)
               : zero4(),
           x);
#pragma unroll
    for (int w = 0; w < 4; ++w) dst[(d + w) * n + row] = x[w];
  }
}

// acc[r][c] += sum_d rowT[d][4 ty + r] * colN[tx + 16 c][d]
template <int HD, int R>
__device__ __forceinline__ void tile_dot(float (&acc)[4][4],
                                         const float* rowT,
                                         const float* colN, int ty, int tx) {
  constexpr int LD = HD + 4;
#pragma unroll 2
  for (int d = 0; d < HD; d += 4) {
    float cv[4][4], rv[4][4];
#pragma unroll
    for (int c = 0; c < 4; ++c)
      unpack(load4(colN + (tx + 16 * c) * LD + d), cv[c]);
#pragma unroll
    for (int w = 0; w < 4; ++w)
      unpack(load4(rowT + (d + w) * R + 4 * ty), rv[w]);
#pragma unroll
    for (int w = 0; w < 4; ++w)
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(rv[w][r], cv[c][w], acc[r][c]);
  }
}

// out[r][4 e + w] += sum_j pT[j][4 ty + r] * colN[j][4 tx + 64 e + w]
template <int HD, int R>
__device__ __forceinline__ void tile_acc(float (&out)[4][HD / 16],
                                         const float* pT, const float* colN,
                                         int ty, int tx) {
  constexpr int LD = HD + 4, LP = R + 4, NE = HD / 64;
#pragma unroll 4
  for (int j = 0; j < COLS; ++j) {
    float p[4];
    unpack(load4(pT + j * LP + 4 * ty), p);
#pragma unroll
    for (int e = 0; e < NE; ++e) {
      float x[4];
      unpack(load4(colN + j * LD + 4 * tx + 64 * e), x);
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int w = 0; w < 4; ++w)
          out[r][4 * e + w] = fmaf(p[r], x[w], out[r][4 * e + w]);
    }
  }
}

// pT[tx + 16 c][4 ty + r] = x[r][c]
template <int R>
__device__ __forceinline__ void store_tile_t(float* pT, const float (&x)[4][4],
                                             int ty, int tx) {
#pragma unroll
  for (int c = 0; c < 4; ++c)
    store4(pT + (tx + 16 * c) * (R + 4) + 4 * ty,
           make_float4(x[0][c], x[1][c], x[2][c], x[3][c]));
}

// Dsm[i] = sum_d dO[pos0 + i][d] * O[pos0 + i][d] for i < n (0 past S),
// d < HS; NT / n threads per row, summed in a fixed order.
template <int HS, int NT>
__device__ __forceinline__ void row_dots(float* Dsm, const float* dO, const float* O,
                                         long long row_stride, int pos0,
                                         int n, int S) {
  const int tpr = NT / n;                       // 2 or 4: lanes of one row
  const int i = threadIdx.x / tpr, part = threadIdx.x % tpr;
  const int pos = pos0 + i;
  float acc = 0.f;
  if (pos < S) {
    const float* a = dO + (long long)pos * row_stride;
    const float* b = O + (long long)pos * row_stride;
    for (int d = 4 * part; d < HS; d += 4 * tpr) {
      const float4 x = load4(a + d), y = load4(b + d);
      acc = fmaf(x.x, y.x, acc);
      acc = fmaf(x.y, y.y, acc);
      acc = fmaf(x.z, y.z, acc);
      acc = fmaf(x.w, y.w, acc);
    }
  }
  for (int o = 1; o < tpr; o <<= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, o);
  if (part == 0) Dsm[i] = acc;
}

// the KV tiles that meet query rows [q_lo, q_hi]
__device__ __forceinline__ void kv_band(int q_lo, int q_hi, int Sk,
                                        int window, int causal, int* first,
                                        int* last) {
  long long lo = (long long)q_lo - window + 1;
  if (lo < 0) lo = 0;
  const long long hi = causal ? (long long)q_hi
                              : (long long)q_hi + window - 1;
  const long long nk = (Sk + COLS - 1) / COLS;
  *first = (int)(lo / COLS);
  *last = (int)(hi / COLS < nk - 1 ? hi / COLS : nk - 1);
}

// ------------------------------------------------------------------ forward
// grid: B * KV * G * ceil(Sq / R) blocks of 16 TY threads.
template <int HS, int TY>
__global__ void __launch_bounds__(16 * TY)
fp32_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, float* __restrict__ o,
               float* __restrict__ lse, int Sq, int Sk, int KV, int G,
               int window, int causal, float scale) {
  constexpr int HD = padded(HS), NT = 16 * TY, R = 4 * TY, NE = HD / 64;
  constexpr int LD = HD + 4;
  extern __shared__ float smem[];
  float* qT = smem;                    // [HD][R]
  float* kv = qT + HD * R;             // [COLS][LD]: K, then V
  float* pT = kv + COLS * LD;          // [COLS][R + 4]

  const int nq = (Sq + R - 1) / R;
  int bid = blockIdx.x;
  const int qt = bid % nq; bid /= nq;
  const int g = bid % G; bid /= G;
  const int h = bid % KV;
  const int b = bid / KV;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const int q_lo = qt * R;
  const int q_hi = min(q_lo + R, Sq) - 1;
  const long long qstride = (long long)KV * G * HS;
  const long long kstride = (long long)KV * HS;
  const long long qoff = ((long long)b * Sq * KV + h) * G * HS + (long long)g * HS;
  const long long koff = ((long long)b * Sk * KV + h) * HS;

  load_rows_t<HD, NT, HS>(qT, q + qoff, qstride, q_lo, R, Sq);

  float m[4], l[4], acc[4][HD / 16];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    m[r] = NEG_INF;
    l[r] = 0.f;
#pragma unroll
    for (int x = 0; x < HD / 16; ++x) acc[r][x] = 0.f;
  }

  int first, last;
  kv_band(q_lo, q_hi, Sk, window, causal, &first, &last);
  for (int kt = first; kt <= last; ++kt) {
    const int k_lo = kt * COLS;
    __syncthreads();                       // kv and pT free
    load_rows<HD, NT, HS>(kv, k + koff, kstride, k_lo, COLS, Sk);
    __syncthreads();
    float s[4][4] = {};
    tile_dot<HD, R>(s, qT, kv, ty, tx);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int qpos = q_lo + 4 * ty + r;
      float mx = NEG_INF;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int kpos = k_lo + tx + 16 * c;
        const bool ok = kpos < Sk && visible(qpos, kpos, window, causal);
        s[r][c] = ok ? s[r][c] * scale : NEG_INF;
        mx = fmaxf(mx, s[r][c]);
      }
      const float m_new = fmaxf(m[r], row_max16(mx));
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        s[r][c] = expf(s[r][c] - m_new);
        sum += s[r][c];
      }
      const float corr = expf(m[r] - m_new);
      l[r] = l[r] * corr + row_sum16(sum);
      m[r] = m_new;
#pragma unroll
      for (int x = 0; x < HD / 16; ++x) acc[r][x] *= corr;
    }
    store_tile_t<R>(pT, s, ty, tx);
    __syncthreads();                       // K read, P written
    load_rows<HD, NT, HS>(kv, v + koff, kstride, k_lo, COLS, Sk);
    __syncthreads();
    tile_acc<HD, R>(acc, pT, kv, ty, tx);
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int qpos = q_lo + 4 * ty + r;
    if (qpos >= Sq) continue;
    const float den = fmaxf(l[r], 1e-30f);
    float* dst = o + qoff + (long long)qpos * qstride + 4 * tx;
#pragma unroll
    for (int e = 0; e < NE; ++e) {
      if (HS != HD && 64 * e + 4 * tx >= HS) continue;  // padded columns
      store4(dst + 64 * e,
             make_float4(acc[r][4 * e] / den, acc[r][4 * e + 1] / den,
                         acc[r][4 * e + 2] / den, acc[r][4 * e + 3] / den));
    }
    if (tx == 0)
      lse[(((long long)b * KV + h) * G + g) * Sq + qpos] = m[r] + logf(l[r]);
  }
}

// --------------------------------------------------------------- backward
// dQ. grid: B * KV * G * ceil(Sq / R) blocks of 16 TY threads.
template <int HS, int TY>
__global__ void __launch_bounds__(16 * TY)
fp32_dq_kernel(const float* __restrict__ dout, const float* __restrict__ q,
                  const float* __restrict__ k, const float* __restrict__ v,
                  const float* __restrict__ o, const float* __restrict__ lse,
                  float* __restrict__ dq, int Sq, int Sk, int KV, int G,
                  int window, int causal, float scale) {
  constexpr int HD = padded(HS), NT = 16 * TY, R = 4 * TY, NE = HD / 64;
  constexpr int LD = HD + 4;
  extern __shared__ float smem[];
  float* qT = smem;                    // [HD][R]
  float* doT = qT + HD * R;            // [HD][R]
  float* kv = doT + HD * R;            // [COLS][LD]: V, then K
  float* pT = kv + COLS * LD;          // [COLS][R + 4]: dS
  float* Dsm = pT + COLS * (R + 4);    // [R]

  const int nq = (Sq + R - 1) / R;
  int bid = blockIdx.x;
  const int qt = bid % nq; bid /= nq;
  const int g = bid % G; bid /= G;
  const int h = bid % KV;
  const int b = bid / KV;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const int q_lo = qt * R;
  const int q_hi = min(q_lo + R, Sq) - 1;
  const long long qstride = (long long)KV * G * HS;
  const long long kstride = (long long)KV * HS;
  const long long qoff = ((long long)b * Sq * KV + h) * G * HS + (long long)g * HS;
  const long long koff = ((long long)b * Sk * KV + h) * HS;
  const float* lrow = lse + (((long long)b * KV + h) * G + g) * Sq;

  load_rows_t<HD, NT, HS>(qT, q + qoff, qstride, q_lo, R, Sq);
  load_rows_t<HD, NT, HS>(doT, dout + qoff, qstride, q_lo, R, Sq);
  row_dots<HS, NT>(Dsm, dout + qoff, o + qoff, qstride, q_lo, R, Sq);
  __syncthreads();
  float Lr[4], Dr[4], acc[4][HD / 16];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int qpos = q_lo + 4 * ty + r;
    Lr[r] = qpos < Sq ? lrow[qpos] : 0.f;
    Dr[r] = Dsm[4 * ty + r];
#pragma unroll
    for (int x = 0; x < HD / 16; ++x) acc[r][x] = 0.f;
  }

  int first, last;
  kv_band(q_lo, q_hi, Sk, window, causal, &first, &last);
  for (int kt = first; kt <= last; ++kt) {
    const int k_lo = kt * COLS;
    __syncthreads();                       // kv and pT free
    load_rows<HD, NT, HS>(kv, v + koff, kstride, k_lo, COLS, Sk);
    __syncthreads();
    float dp[4][4] = {};
    tile_dot<HD, R>(dp, doT, kv, ty, tx);  // dP = dO V^T
    __syncthreads();                       // V read
    load_rows<HD, NT, HS>(kv, k + koff, kstride, k_lo, COLS, Sk);
    __syncthreads();
    float s[4][4] = {};
    tile_dot<HD, R>(s, qT, kv, ty, tx);    // S = Q K^T
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int qpos = q_lo + 4 * ty + r;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int kpos = k_lo + tx + 16 * c;
        const bool ok = kpos < Sk && visible(qpos, kpos, window, causal);
        const float p = expf((ok ? s[r][c] * scale : NEG_INF) - Lr[r]);
        s[r][c] = p * (dp[r][c] - Dr[r]);  // dS
      }
    }
    store_tile_t<R>(pT, s, ty, tx);
    __syncthreads();
    tile_acc<HD, R>(acc, pT, kv, ty, tx);  // dQ += dS K
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int qpos = q_lo + 4 * ty + r;
    if (qpos >= Sq) continue;
    float* dst = dq + qoff + (long long)qpos * qstride + 4 * tx;
#pragma unroll
    for (int e = 0; e < NE; ++e) {
      if (HS != HD && 64 * e + 4 * tx >= HS) continue;
      store4(dst + 64 * e,
             make_float4(acc[r][4 * e] * scale, acc[r][4 * e + 1] * scale,
                         acc[r][4 * e + 2] * scale,
                         acc[r][4 * e + 3] * scale));
    }
  }
}

// dK and dV. grid: B * KV * ceil(Sk / R) blocks of 16 TY threads; the
// block's rows are KV positions, its score columns query positions.
template <int HS, int TY>
__global__ void __launch_bounds__(16 * TY)
fp32_dkdv_kernel(const float* __restrict__ dout, const float* __restrict__ q,
                    const float* __restrict__ k, const float* __restrict__ v,
                    const float* __restrict__ o, const float* __restrict__ lse,
                    float* __restrict__ dk, float* __restrict__ dv, int Sq, int Sk,
                    int KV, int G, int window, int causal, float scale) {
  constexpr int HD = padded(HS), NT = 16 * TY, R = 4 * TY, NE = HD / 64;
  constexpr int LD = HD + 4;
  extern __shared__ float smem[];
  float* kT = smem;                    // [HD][R]
  float* vT = kT + HD * R;             // [HD][R]
  float* qn = vT + HD * R;             // [COLS][LD]
  float* don = qn + COLS * LD;         // [COLS][LD]
  float* pT = don + COLS * LD;         // [COLS][R + 4]: P
  float* dsT = pT + COLS * (R + 4);    // [COLS][R + 4]: dS
  float* Lsm = dsT + COLS * (R + 4);   // [COLS]
  float* Dsm = Lsm + COLS;             // [COLS]

  const int nk = (Sk + R - 1) / R;
  int bid = blockIdx.x;
  const int kt = bid % nk; bid /= nk;
  const int h = bid % KV;
  const int b = bid / KV;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const int k_lo = kt * R;
  const int k_hi = min(k_lo + R, Sk) - 1;
  const long long qstride = (long long)KV * G * HS;
  const long long kstride = (long long)KV * HS;
  const long long koff = ((long long)b * Sk * KV + h) * HS;

  load_rows_t<HD, NT, HS>(kT, k + koff, kstride, k_lo, R, Sk);
  load_rows_t<HD, NT, HS>(vT, v + koff, kstride, k_lo, R, Sk);
  float dK[4][HD / 16], dV[4][HD / 16];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int x = 0; x < HD / 16; ++x) dK[r][x] = dV[r][x] = 0.f;

  // the query tiles (of COLS rows) that meet KV rows [k_lo, k_hi]
  const long long nqt = (Sq + COLS - 1) / COLS;
  long long lo = causal ? (long long)k_lo : (long long)k_lo - window + 1;
  if (lo < 0) lo = 0;
  const long long hi = (long long)k_hi + window - 1;
  const int first = (int)(lo / COLS);
  const int last = (int)(hi / COLS < nqt - 1 ? hi / COLS : nqt - 1);

  for (int g = 0; g < G; ++g) {
    const long long qoff =
        ((long long)b * Sq * KV + h) * G * HS + (long long)g * HS;
    const float* lrow = lse + (((long long)b * KV + h) * G + g) * Sq;
    for (int it = first; it <= last; ++it) {
      const int q_lo = it * COLS;
      __syncthreads();                     // qn, don, pT, dsT free
      load_rows<HD, NT, HS>(qn, q + qoff, qstride, q_lo, COLS, Sq);
      load_rows<HD, NT, HS>(don, dout + qoff, qstride, q_lo, COLS, Sq);
      row_dots<HS, NT>(Dsm, dout + qoff, o + qoff, qstride, q_lo, COLS,
                          Sq);
      for (int i = threadIdx.x; i < COLS; i += NT)
        Lsm[i] = q_lo + i < Sq ? lrow[q_lo + i] : 0.f;
      __syncthreads();
      float s[4][4] = {}, dp[4][4] = {};
      tile_dot<HD, R>(s, kT, qn, ty, tx);   // S^T = K Q^T
      tile_dot<HD, R>(dp, vT, don, ty, tx); // dP^T = V dO^T
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int qpos = q_lo + tx + 16 * c;
        const float Lc = Lsm[tx + 16 * c], Dc = Dsm[tx + 16 * c];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int kpos = k_lo + 4 * ty + r;
          const bool ok = qpos < Sq && kpos < Sk &&
                          visible(qpos, kpos, window, causal);
          const float p = expf((ok ? s[r][c] * scale : NEG_INF) - Lc);
          s[r][c] = p;
          dp[r][c] = p * (dp[r][c] - Dc);  // dS
        }
      }
      store_tile_t<R>(pT, s, ty, tx);
      store_tile_t<R>(dsT, dp, ty, tx);
      __syncthreads();
      tile_acc<HD, R>(dV, pT, don, ty, tx);  // dV += P^T dO
      tile_acc<HD, R>(dK, dsT, qn, ty, tx);  // dK += dS^T Q
    }
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int kpos = k_lo + 4 * ty + r;
    if (kpos >= Sk) continue;
    float* dstk = dk + koff + (long long)kpos * kstride + 4 * tx;
    float* dstv = dv + koff + (long long)kpos * kstride + 4 * tx;
#pragma unroll
    for (int e = 0; e < NE; ++e) {
      if (HS != HD && 64 * e + 4 * tx >= HS) continue;
      store4(dstk + 64 * e,
             make_float4(dK[r][4 * e] * scale, dK[r][4 * e + 1] * scale,
                         dK[r][4 * e + 2] * scale, dK[r][4 * e + 3] * scale));
      store4(dstv + 64 * e, make_float4(dV[r][4 * e], dV[r][4 * e + 1],
                                        dV[r][4 * e + 2], dV[r][4 * e + 3]));
    }
  }
}

// ------------------------------------------------------------------ launch
// backward tile rows: 4 * BWD_TY(HD) (FP32_BWD_ROWS in swa_attention.py)
template <int HD>
struct BwdTY { static constexpr int value = HD == 256 ? 8 : 16; };

template <typename K>
static cudaError_t allow_smem(K kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

template <int HS>
static cudaError_t launch_fwd(const void* q, const void* k, const void* v,
                              void* o, float* lse, int B, int Sq, int Sk,
                              int KV, int G, int window, int causal,
                              float scale, cudaStream_t stream) {
  constexpr int HD = padded(HS), TY = FWD_TY, R = 4 * TY;
  const size_t smem =
      sizeof(float) * (HD * R + COLS * (HD + 4) + COLS * (R + 4));
  cudaError_t e = allow_smem(fp32_fwd_kernel<HS, TY>, smem);
  if (e != cudaSuccess) return e;
  const long long blocks = (long long)B * KV * G * ((Sq + R - 1) / R);
  fp32_fwd_kernel<HS, TY><<<(unsigned)blocks, 16 * TY, smem, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)o, lse, Sq,
      Sk, KV, G, window, causal, scale);
  return cudaGetLastError();
}

template <int HS>
static cudaError_t launch_bwd(const void* dout, const void* q, const void* k,
                              const void* v, const void* o, const float* lse,
                              void* dq, void* dk, void* dv, int B, int Sq,
                              int Sk, int KV, int G, int window, int causal,
                              float scale, cudaStream_t stream) {
  constexpr int HD = padded(HS), TY = BwdTY<HD>::value, R = 4 * TY;
  const size_t smem_dq = sizeof(float) *
      (2 * HD * R + COLS * (HD + 4) + COLS * (R + 4) + R);
  const size_t smem_dkdv = sizeof(float) *
      (2 * HD * R + 2 * COLS * (HD + 4) + 2 * COLS * (R + 4) + 2 * COLS);
  cudaError_t e = allow_smem(fp32_dq_kernel<HS, TY>, smem_dq);
  if (e != cudaSuccess) return e;
  e = allow_smem(fp32_dkdv_kernel<HS, TY>, smem_dkdv);
  if (e != cudaSuccess) return e;
  const long long nq = (Sq + R - 1) / R, nk = (Sk + R - 1) / R;
  fp32_dq_kernel<HS, TY>
      <<<(unsigned)((long long)B * KV * G * nq), 16 * TY, smem_dq, stream>>>(
          (const float*)dout, (const float*)q, (const float*)k,
          (const float*)v, (const float*)o, lse, (float*)dq, Sq, Sk, KV, G,
          window, causal, scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  fp32_dkdv_kernel<HS, TY>
      <<<(unsigned)((long long)B * KV * nk), 16 * TY, smem_dkdv, stream>>>(
          (const float*)dout, (const float*)q, (const float*)k,
          (const float*)v, (const float*)o, lse, (float*)dk, (float*)dv, Sq,
          Sk, KV, G, window, causal, scale);
  return cudaGetLastError();
}

// dtype must be 0 (float32): bfloat16 inputs go to swa_flash_bf16.cu.
// hd: 64, 128 or 256, or 80, 96 or 112 on the hd-128 tiles (padded).
extern "C" int reft_swa_fwd(const void* q, const void* k, const void* v,
                            void* o, void* lse, int B, int Sq, int Sk,
                            int KV, int G, int hd, int window, int causal,
                            float scale, int dtype, int device,
                            void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (window < 1 || Sq < 1 || Sk < 1 || dtype != 0)
    return (int)cudaErrorInvalidValue;
#define FWD_ARGS                                                         \
  q, k, v, o, (float*)lse, B, Sq, Sk, KV, G, window, causal, scale,      \
      (cudaStream_t)stream
  if (hd == 64) e = launch_fwd<64>(FWD_ARGS);
  else if (hd == 128) e = launch_fwd<128>(FWD_ARGS);
  else if (hd == 256) e = launch_fwd<256>(FWD_ARGS);
  else if (hd == 80) e = launch_fwd<80>(FWD_ARGS);
  else if (hd == 96) e = launch_fwd<96>(FWD_ARGS);
  else if (hd == 112) e = launch_fwd<112>(FWD_ARGS);
  else return (int)cudaErrorInvalidValue;
#undef FWD_ARGS
  return (int)e;
}

extern "C" int reft_swa_bwd(const void* dout, const void* q, const void* k,
                            const void* v, const void* o, const void* lse,
                            void* dq, void* dk, void* dv, int B, int Sq,
                            int Sk, int KV, int G, int hd, int window,
                            int causal, float scale, int dtype, int device,
                            void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (window < 1 || Sq < 1 || Sk < 1 || dtype != 0)
    return (int)cudaErrorInvalidValue;
#define BWD_ARGS                                                         \
  dout, q, k, v, o, (const float*)lse, dq, dk, dv, B, Sq, Sk, KV, G,     \
      window, causal, scale, (cudaStream_t)stream
  if (hd == 64) e = launch_bwd<64>(BWD_ARGS);
  else if (hd == 128) e = launch_bwd<128>(BWD_ARGS);
  else if (hd == 256) e = launch_bwd<256>(BWD_ARGS);
  else if (hd == 80) e = launch_bwd<80>(BWD_ARGS);
  else if (hd == 96) e = launch_bwd<96>(BWD_ARGS);
  else if (hd == 112) e = launch_bwd<112>(BWD_ARGS);
  else return (int)cudaErrorInvalidValue;
#undef BWD_ARGS
  return (int)e;
}

extern "C" const char* reft_swa_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
