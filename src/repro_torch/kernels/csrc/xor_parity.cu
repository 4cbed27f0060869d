// RAIM5 XOR parity for Hopper (sm_90a): XOR over axis 0 of a (k, n) uint32
// array, out[t] = blocks[0, t] ^ ... ^ blocks[k-1, t].
//
// Replaces the TPU kernel repro/kernels/xor_parity.py::xor_reduce (Pallas
// _xor_kernel). The TPU version tiled the lanes into (k, 64Ki) VMEM blocks,
// one sequential grid cell each; here every thread walks the row with a
// grid stride and nothing carries between blocks.
//
// Bound on an H100 SXM: bytes, (k+1) * 4 * n (k rows read once, one row
// written once) at 3.35 TB/s. There is no reuse, so the design only keeps
// enough 16-byte loads in flight: a grid of 8 blocks of 256 threads per SM
// (2048 resident threads); the row loop is unrolled by 4, so up to four
// read-only row loads are in flight before their XORs, then one 16-byte
// store.
//
// Two bodies in one kernel:
//  * vector body: n_vec 16-byte vectors (uint4) per row, used when every
//    row starts 16-byte aligned (n % 4 == 0 and an aligned base). Row r's
//    vector v is at (r * n_vec + v) in uint4 units.
//  * scalar tail: the words [4 * n_vec, n) one uint32 at a time. With
//    n % 4 == 0 it is empty; with n % 4 != 0 the rows after the first are
//    only 4-byte aligned, the wrapper passes n_vec = 0 and the tail is
//    the whole row.
#include <cstdint>
#include <cuda_runtime.h>

#define XOR_THREADS 256     // must equal XOR_THREADS in xor_parity.py

__global__ void __launch_bounds__(XOR_THREADS)
xor_reduce_kernel(const uint32_t* __restrict__ blocks, int k, long long n,
                  long long n_vec, uint32_t* __restrict__ out) {
  const long long stride = (long long)gridDim.x * XOR_THREADS;
  const long long first = (long long)blockIdx.x * XOR_THREADS + threadIdx.x;

  const uint4* src = reinterpret_cast<const uint4*>(blocks);
  uint4* dst = reinterpret_cast<uint4*>(out);
  for (long long v = first; v < n_vec; v += stride) {
    uint4 a = __ldg(src + v);
#pragma unroll 4
    for (int r = 1; r < k; ++r) {
      const uint4 b = __ldg(src + (long long)r * n_vec + v);
      a.x ^= b.x; a.y ^= b.y; a.z ^= b.z; a.w ^= b.w;
    }
    dst[v] = a;
  }

  for (long long t = 4 * n_vec + first; t < n; t += stride) {
    uint32_t a = __ldg(blocks + t);
#pragma unroll 4
    for (int r = 1; r < k; ++r) a ^= __ldg(blocks + (long long)r * n + t);
    out[t] = a;
  }
}

extern "C" int reft_xor_reduce(const void* blocks, int k, long long n,
                               long long n_vec, void* out, int grid,
                               int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  xor_reduce_kernel<<<grid, XOR_THREADS, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)blocks, k, n, n_vec, (uint32_t*)out);
  return (int)cudaGetLastError();
}

extern "C" const char* reft_xor_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
