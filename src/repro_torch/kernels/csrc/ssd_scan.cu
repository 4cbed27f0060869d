// Mamba2 SSD scan for Hopper (sm_90a): forward and backward kernels.
//
// Replaces the TPU kernel repro/kernels/ssd_scan.py::ssd_scan (Pallas
// _ssd_kernel, same contract as repro/models/ssm.py::ssd_chunked). The
// TPU walks the chunks as a sequential grid axis with the (N, P) state
// resident in VMEM and does three matmuls per chunk. Hopper's blocks run
// in parallel and in no order, so nothing is carried from block to block:
// the recurrence
//     h_t = e^{a_t} h_{t-1} + u_t (x) b_t,   y_t[p] = sum_n h_t[p,n] c_t[n]
// is independent for each row p of the (P, N) state, and one block owns a
// tile of rows of one (batch, head) and walks the whole sequence in a loop.
// Warp w of a block holds row p0 + w; lane l holds columns n = l + 32 j,
// j < NJ, in registers. A chunked formulation with tensor-core products is
// later work.
//
// The backward kernel has no TPU counterpart: it computes what XLA derives
// from ssd_chunked, by the reverse recurrence over t from g = dh_final:
//     g += dy_t (x) c_t;  du_t = g b_t;  dB_t += sum_p g u_t;
//     dC_t += sum_p h_t dy_t;  da_t = e^{a_t} sum g o h_{t-1};  g *= e^{a_t}
// and dh0 = g at the end. It needs h_{t-1} in reverse order: the forward
// saves the state before each chunk of Q steps (hs, (B,H,nc,P,N)); per
// chunk, walking the chunks in reverse, the backward
//   1. runs the chunk forward from hs, storing the state before every
//      BWD_SUB-step sub-segment into its own slice of `scratch`;
//   2. walks the sub-segments in reverse: recomputes the BWD_SUB states of
//      one into registers, then walks them backward.
// No step runs the recurrence backward by dividing by e^{a_t} (unstable
// for strongly negative a). Bm and Cm are shared across heads, so dB and
// dC sum over h and p, and da over p and n: the block sums over its warps
// in shared memory in a fixed order every BWD_RED steps and writes one
// partial per (b, h, p-tile); the wrapper sums the partials with one torch
// reduction. No atomics: the result is deterministic.
//
// Bound on an H100 SXM, at the main path's shapes (B=2, S=2048, H=24,
// P=64, N=128): operations. Forward 4 B S H P N = 3.2 GFLOP at 67 TFLOP/s
// fp32 = 0.048 ms against 58 MB of inputs and outputs at 3.35 TB/s =
// 0.017 ms. Backward 11 B S H P N = 8.9 GFLOP = 0.132 ms against 89 MB =
// 0.027 ms. Both kernels are latency-bound on the serial walk over S.
//
// The `Q` (chunk) argument sets where the forward saves states and how far
// the backward recomputes; the values of y and h_final do not depend on it.
#include <cuda_runtime.h>

#define FWD_ROWS 8    // must equal FWD_ROWS in ssd_scan.py
#define FWD_T 32      // must equal FWD_T in ssd_scan.py
#define BWD_ROWS 16   // must equal BWD_ROWS in ssd_scan.py
#define BWD_SUB 8     // must equal BWD_SUB in ssd_scan.py
#define BWD_RED 4     // must equal BWD_RED in ssd_scan.py

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// ------------------------------------------------------------------ forward
// grid: B * H * ceil(P / FWD_ROWS) blocks of FWD_ROWS warps.
template <int NJ>
__global__ void __launch_bounds__(FWD_ROWS * 32)
ssd_fwd_kernel(const float* __restrict__ u, const float* __restrict__ a,
               const float* __restrict__ Bm, const float* __restrict__ Cm,
               const float* __restrict__ h0, float* __restrict__ y,
               float* __restrict__ h_final, float* __restrict__ hs, int S,
               int H, int P, int N, int Q) {
  extern __shared__ float smem[];
  float* sB = smem;                      // [FWD_T][N]
  float* sC = sB + FWD_T * N;            // [FWD_T][N]
  float* sU = sC + FWD_T * N;            // [FWD_T][FWD_ROWS]
  float* sY = sU + FWD_T * FWD_ROWS;     // [FWD_T][FWD_ROWS]
  float* sE = sY + FWD_T * FWD_ROWS;     // [FWD_T]: e^{a_t}

  const int n_pt = (P + FWD_ROWS - 1) / FWD_ROWS;
  const int bh = blockIdx.x / n_pt, pt = blockIdx.x % n_pt;
  const int b = bh / H, h = bh % H;
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int p = pt * FWD_ROWS + w;
  const bool row = p < P;
  const int nc = S / Q;

  float st[NJ];
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const int n = lane + 32 * j;
    st[j] = (h0 != nullptr && row && n < N)
                ? h0[((size_t)bh * P + p) * N + n] : 0.f;
  }

  for (int t0 = 0; t0 < S; t0 += FWD_T) {
    const int T = min(FWD_T, S - t0);
    __syncthreads();                       // last segment is done with smem
    for (int i = threadIdx.x; i < T * N; i += blockDim.x) {
      const size_t off = ((size_t)b * S + t0) * N + i;
      sB[i] = Bm[off];
      sC[i] = Cm[off];
    }
    for (int i = threadIdx.x; i < T * FWD_ROWS; i += blockDim.x) {
      const int tt = i / FWD_ROWS, pp = pt * FWD_ROWS + i % FWD_ROWS;
      sU[i] = pp < P ? u[(((size_t)b * S + t0 + tt) * H + h) * P + pp] : 0.f;
    }
    for (int i = threadIdx.x; i < T; i += blockDim.x)
      sE[i] = expf(a[((size_t)b * S + t0 + i) * H + h]);
    __syncthreads();

    for (int i = 0; i < T; ++i) {
      const int t = t0 + i;
      if (row && t % Q == 0) {
        float* dst = hs + (((size_t)bh * nc + t / Q) * P + p) * N;
#pragma unroll
        for (int j = 0; j < NJ; ++j)
          if (lane + 32 * j < N) dst[lane + 32 * j] = st[j];
      }
      const float e = sE[i], uu = sU[i * FWD_ROWS + w];
      float acc = 0.f;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int n = lane + 32 * j;
        if (n < N) {
          st[j] = fmaf(e, st[j], uu * sB[i * N + n]);
          acc = fmaf(st[j], sC[i * N + n], acc);
        }
      }
      acc = warp_sum(acc);
      if (lane == 0) sY[i * FWD_ROWS + w] = acc;
    }
    __syncthreads();
    for (int i = threadIdx.x; i < T * FWD_ROWS; i += blockDim.x) {
      const int tt = i / FWD_ROWS, pp = pt * FWD_ROWS + i % FWD_ROWS;
      if (pp < P) y[(((size_t)b * S + t0 + tt) * H + h) * P + pp] = sY[i];
    }
  }
  if (row) {
#pragma unroll
    for (int j = 0; j < NJ; ++j)
      if (lane + 32 * j < N)
        h_final[((size_t)bh * P + p) * N + lane + 32 * j] = st[j];
  }
}

// ----------------------------------------------------------------- backward
// Stage steps [t0, t0 + T) of B, C, u, dy and e^{a} for this block.
__device__ __forceinline__ void bwd_stage(
    float* sB, float* sC, float* sU, float* sDY, float* sE,
    const float* __restrict__ Bm, const float* __restrict__ Cm,
    const float* __restrict__ u, const float* __restrict__ dy,
    const float* __restrict__ a, int b, int h, int pt, int t0, int T, int S,
    int H, int P, int N) {
  __syncthreads();                         // everyone is done with the last
  for (int i = threadIdx.x; i < T * N; i += blockDim.x) {
    const size_t off = ((size_t)b * S + t0) * N + i;
    sB[i] = Bm[off];
    sC[i] = Cm[off];
  }
  for (int i = threadIdx.x; i < T * BWD_ROWS; i += blockDim.x) {
    const int tt = i / BWD_ROWS, pp = pt * BWD_ROWS + i % BWD_ROWS;
    const size_t off = (((size_t)b * S + t0 + tt) * H + h) * P + pp;
    sU[i] = pp < P ? u[off] : 0.f;
    sDY[i] = pp < P ? dy[off] : 0.f;
  }
  for (int i = threadIdx.x; i < T; i += blockDim.x)
    sE[i] = expf(a[((size_t)b * S + t0 + i) * H + h]);
  __syncthreads();
}

// grid: B * H * ceil(P / BWD_ROWS) blocks of BWD_ROWS warps.
// da_part (B, n_pt, S, H); dB_part, dC_part (B, H, n_pt, S, N);
// scratch (B * H * n_pt, ceil(Q / BWD_SUB), BWD_ROWS, N).
template <int NJ>
__global__ void __launch_bounds__(BWD_ROWS * 32)
ssd_bwd_kernel(const float* __restrict__ dy, const float* __restrict__ dh_final,
               const float* __restrict__ u, const float* __restrict__ a,
               const float* __restrict__ Bm, const float* __restrict__ Cm,
               const float* __restrict__ hs, float* __restrict__ du,
               float* __restrict__ da_part, float* __restrict__ dB_part,
               float* __restrict__ dC_part, float* __restrict__ dh0,
               float* __restrict__ scratch, int S, int H, int P, int N,
               int Q) {
  extern __shared__ float smem[];
  float* sB = smem;                          // [BWD_SUB][N]
  float* sC = sB + BWD_SUB * N;              // [BWD_SUB][N]
  float* sU = sC + BWD_SUB * N;              // [BWD_SUB][BWD_ROWS]
  float* sDY = sU + BWD_SUB * BWD_ROWS;      // [BWD_SUB][BWD_ROWS]
  float* rA = sDY + BWD_SUB * BWD_ROWS;      // [BWD_RED][BWD_ROWS]
  float* rB = rA + BWD_RED * BWD_ROWS;       // [BWD_RED][BWD_ROWS][N]
  float* rC = rB + BWD_RED * BWD_ROWS * N;   // [BWD_RED][BWD_ROWS][N]
  float* sE = rC + BWD_RED * BWD_ROWS * N;   // [BWD_SUB]

  const int n_pt = (P + BWD_ROWS - 1) / BWD_ROWS;
  const int bh = blockIdx.x / n_pt, pt = blockIdx.x % n_pt;
  const int b = bh / H, h = bh % H;
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int p = pt * BWD_ROWS + w;
  const bool row = p < P;
  const int nc = S / Q;
  const int n_sub = (Q + BWD_SUB - 1) / BWD_SUB;
  // this warp's row of the block's scratch: sub-segment k at k*ROWS*N
  float* my_sub = scratch + (size_t)blockIdx.x * n_sub * BWD_ROWS * N
                  + (size_t)w * N;

  float g[NJ];
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const int n = lane + 32 * j;
    g[j] = (dh_final != nullptr && row && n < N)
               ? dh_final[((size_t)bh * P + p) * N + n] : 0.f;
  }

  for (int c = nc - 1; c >= 0; --c) {
    const int c0 = c * Q;
    // 1. the state before each sub-segment of chunk c, into scratch
    float st[NJ];
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int n = lane + 32 * j;
      st[j] = (row && n < N) ? hs[(((size_t)bh * nc + c) * P + p) * N + n]
                             : 0.f;
    }
    for (int k = 0; k < n_sub; ++k) {
#pragma unroll
      for (int j = 0; j < NJ; ++j)
        if (lane + 32 * j < N)
          my_sub[(size_t)k * BWD_ROWS * N + lane + 32 * j] = st[j];
      if (k == n_sub - 1) break;
      const int t0 = c0 + k * BWD_SUB;
      bwd_stage(sB, sC, sU, sDY, sE, Bm, Cm, u, dy, a, b, h, pt, t0,
                BWD_SUB, S, H, P, N);
      for (int i = 0; i < BWD_SUB; ++i) {
        const float e = sE[i], uu = sU[i * BWD_ROWS + w];
#pragma unroll
        for (int j = 0; j < NJ; ++j)
          if (lane + 32 * j < N)
            st[j] = fmaf(e, st[j], uu * sB[i * N + lane + 32 * j]);
      }
    }

    // 2. sub-segments in reverse: recompute into registers, walk back
    for (int k = n_sub - 1; k >= 0; --k) {
      const int t0 = c0 + k * BWD_SUB;
      const int T = min(BWD_SUB, c0 + Q - t0);
      bwd_stage(sB, sC, sU, sDY, sE, Bm, Cm, u, dy, a, b, h, pt, t0, T, S,
                H, P, N);
      float h_in[NJ];                       // h_{t0-1}
      float hist[BWD_SUB][NJ];              // hist[i] = h_{t0+i}
#pragma unroll
      for (int j = 0; j < NJ; ++j)
        h_in[j] = (lane + 32 * j < N)
                      ? my_sub[(size_t)k * BWD_ROWS * N + lane + 32 * j] : 0.f;
#pragma unroll
      for (int i = 0; i < BWD_SUB; ++i) {
        const float e = i < T ? sE[i] : 0.f;
        const float uu = i < T ? sU[i * BWD_ROWS + w] : 0.f;
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const int n = lane + 32 * j;
          const float prev = i == 0 ? h_in[j] : hist[i > 0 ? i - 1 : 0][j];
          hist[i][j] = (i < T && n < N) ? fmaf(e, prev, uu * sB[i * N + n])
                                        : 0.f;
        }
      }
#pragma unroll
      for (int grp = BWD_SUB / BWD_RED - 1; grp >= 0; --grp) {
#pragma unroll
        for (int r = BWD_RED - 1; r >= 0; --r) {
          const int i = grp * BWD_RED + r;
          if (i < T) {                       // uniform over the block
            const float e = sE[i], uu = sU[i * BWD_ROWS + w];
            const float dyv = sDY[i * BWD_ROWS + w];
            float dus = 0.f, das = 0.f;
#pragma unroll
            for (int j = 0; j < NJ; ++j) {
              const int n = lane + 32 * j;
              if (n < N) {
                const float prev = i == 0 ? h_in[j] : hist[i > 0 ? i - 1 : 0][j];
                g[j] = fmaf(dyv, sC[i * N + n], g[j]);
                dus = fmaf(g[j], sB[i * N + n], dus);
                das = fmaf(g[j], prev, das);
                rB[(r * BWD_ROWS + w) * N + n] = g[j] * uu;
                rC[(r * BWD_ROWS + w) * N + n] = hist[i][j] * dyv;
                g[j] *= e;
              }
            }
            dus = warp_sum(dus);
            das = warp_sum(das);
            if (lane == 0) {
              if (row) du[(((size_t)b * S + t0 + i) * H + h) * P + p] = dus;
              rA[r * BWD_ROWS + w] = das * e;
            }
          }
        }
        __syncthreads();
        // sum this group's BWD_RED steps over the block's rows, in order
        const int tg = t0 + grp * BWD_RED;
        for (int q = threadIdx.x; q < BWD_RED * N; q += blockDim.x) {
          const int r = q / N, n = q % N;
          if (grp * BWD_RED + r < T) {
            float sb = 0.f, sc = 0.f;
            for (int ww = 0; ww < BWD_ROWS; ++ww) {
              sb += rB[(r * BWD_ROWS + ww) * N + n];
              sc += rC[(r * BWD_ROWS + ww) * N + n];
            }
            const size_t o = ((size_t)blockIdx.x * S + tg + r) * N + n;
            dB_part[o] = sb;
            dC_part[o] = sc;
          }
        }
        if (threadIdx.x < BWD_RED && grp * BWD_RED + (int)threadIdx.x < T) {
          float s = 0.f;
          for (int ww = 0; ww < BWD_ROWS; ++ww)
            s += rA[threadIdx.x * BWD_ROWS + ww];
          da_part[(((size_t)b * n_pt + pt) * S + tg + threadIdx.x) * H + h] = s;
        }
        __syncthreads();
      }
    }
  }
  if (row) {
#pragma unroll
    for (int j = 0; j < NJ; ++j)
      if (lane + 32 * j < N)
        dh0[((size_t)bh * P + p) * N + lane + 32 * j] = g[j];
  }
}

// ------------------------------------------------------------------ launch
template <int NJ>
static cudaError_t launch_fwd(const float* u, const float* a, const float* Bm,
                              const float* Cm, const float* h0, float* y,
                              float* h_final, float* hs, int B, int S, int H,
                              int P, int N, int Q, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * (2 * FWD_T * N + 2 * FWD_T * FWD_ROWS + FWD_T);
  cudaError_t e = cudaFuncSetAttribute(
      ssd_fwd_kernel<NJ>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return e;
  const int blocks = B * H * ((P + FWD_ROWS - 1) / FWD_ROWS);
  ssd_fwd_kernel<NJ><<<blocks, FWD_ROWS * 32, smem, stream>>>(
      u, a, Bm, Cm, h0, y, h_final, hs, S, H, P, N, Q);
  return cudaGetLastError();
}

template <int NJ>
static cudaError_t launch_bwd(const float* dy, const float* dh_final,
                              const float* u, const float* a, const float* Bm,
                              const float* Cm, const float* hs, float* du,
                              float* da_part, float* dB_part, float* dC_part,
                              float* dh0, float* scratch, int B, int S, int H,
                              int P, int N, int Q, cudaStream_t stream) {
  const size_t smem = sizeof(float) *
      (2 * BWD_SUB * N + 2 * BWD_SUB * BWD_ROWS + BWD_RED * BWD_ROWS +
       2 * BWD_RED * BWD_ROWS * N + BWD_SUB);
  cudaError_t e = cudaFuncSetAttribute(
      ssd_bwd_kernel<NJ>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return e;
  const int blocks = B * H * ((P + BWD_ROWS - 1) / BWD_ROWS);
  ssd_bwd_kernel<NJ><<<blocks, BWD_ROWS * 32, smem, stream>>>(
      dy, dh_final, u, a, Bm, Cm, hs, du, da_part, dB_part, dC_part, dh0,
      scratch, S, H, P, N, Q);
  return cudaGetLastError();
}

extern "C" int reft_ssd_fwd(const void* u, const void* a, const void* Bm,
                            const void* Cm, const void* h0, void* y,
                            void* h_final, void* hs, int B, int S, int H,
                            int P, int N, int Q, int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (N < 1 || N > 256 || Q < 1 || S % Q) return (int)cudaErrorInvalidValue;
  const int nj = (N + 31) / 32;
#define FWD_ARGS                                                          \
  (const float*)u, (const float*)a, (const float*)Bm, (const float*)Cm,   \
      (const float*)h0, (float*)y, (float*)h_final, (float*)hs, B, S, H,  \
      P, N, Q, (cudaStream_t)stream
  if (nj == 1) e = launch_fwd<1>(FWD_ARGS);
  else if (nj == 2) e = launch_fwd<2>(FWD_ARGS);
  else if (nj <= 4) e = launch_fwd<4>(FWD_ARGS);
  else e = launch_fwd<8>(FWD_ARGS);
#undef FWD_ARGS
  return (int)e;
}

extern "C" int reft_ssd_bwd(const void* dy, const void* dh_final,
                            const void* u, const void* a, const void* Bm,
                            const void* Cm, const void* hs, void* du,
                            void* da_part, void* dB_part, void* dC_part,
                            void* dh0, void* scratch, int B, int S, int H,
                            int P, int N, int Q, int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (N < 1 || N > 256 || Q < 1 || S % Q) return (int)cudaErrorInvalidValue;
  const int nj = (N + 31) / 32;
#define BWD_ARGS                                                          \
  (const float*)dy, (const float*)dh_final, (const float*)u,              \
      (const float*)a, (const float*)Bm, (const float*)Cm,                \
      (const float*)hs, (float*)du, (float*)da_part, (float*)dB_part,     \
      (float*)dC_part, (float*)dh0, (float*)scratch, B, S, H, P, N, Q,    \
      (cudaStream_t)stream
  if (nj == 1) e = launch_bwd<1>(BWD_ARGS);
  else if (nj == 2) e = launch_bwd<2>(BWD_ARGS);
  else if (nj <= 4) e = launch_bwd<4>(BWD_ARGS);
  else e = launch_bwd<8>(BWD_ARGS);
#undef BWD_ARGS
  return (int)e;
}

extern "C" const char* reft_ssd_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
