// Fused snapshot-bucket encode for Hopper (sm_90a): XOR-fold of k stacked
// uint32 rows, then one zlib-compatible CRC32 per tile of the folded row.
//
// Replaces the TPU kernel repro/kernels/stage.py::encode_bucket (Pallas
// _encode_kernel / _encode_tiled_kernel, CRC in _crc_words/_crc_words_dyn).
// The TPU ran each tile as one sequential grid cell; here one block owns a
// tile and splits its CRC over ENC_THREADS segments.
//
// Bound on an H100 SXM: bytes, (k+1) * 4 * n_lanes (k rows read, one row
// written) at 3.35 TB/s; the CRC adds 4 table lookups per word, all from
// shared memory.
//
// Design, per block (= per tile of tile_lanes lanes):
//  1. all threads XOR-fold the tile with coalesced 16-byte loads and
//     stores into `out`;
//  2. the slice-by-4 tables are built in shared memory (divergent indices
//     would serialise in __constant__ memory), with the host's GF(2)
//     zero-operators beside them;
//  3. thread j computes the raw CRC (register starts at 0, no final xor)
//     of segment j: seg_words words ending (ENC_THREADS-1-j)*seg_words
//     words before the tile's last whole word.  Leading segments that
//     would start before the data are shorter or empty, which is the same
//     as padding them with zero bytes on the left: a raw CRC does not
//     change under leading zeros.  zlib's initial 0xFFFFFFFF is folded in
//     by xoring it into data word 0;
//  4. a log2(ENC_THREADS)-level tree combines neighbours:
//     raw(A||B) = Z(|B|) raw(A) ^ raw(B), where Z(len) advances a CRC
//     register past len zero bytes (level l uses len = 4*seg_words*2^l);
//  5. thread 0 runs the 1-3 tail bytes and applies the final xor.
#include <cstdint>
#include <cuda_runtime.h>

#define ENC_THREADS 512   // must equal ENC_THREADS in stage.py
#define ENC_LEVELS 9      // log2(ENC_THREADS)
#define CRC_POLY 0xEDB88320u

// slice-by-4: advance a CRC register by one 32-bit word already xored in
__device__ __forceinline__ uint32_t crc_word(const uint32_t (*tab)[256],
                                             uint32_t x) {
  return tab[3][x & 0xFFu] ^ tab[2][(x >> 8) & 0xFFu] ^
         tab[1][(x >> 16) & 0xFFu] ^ tab[0][x >> 24];
}

__device__ __forceinline__ uint32_t gf2_times(const uint32_t* op, uint32_t v) {
  uint32_t s = 0;
#pragma unroll
  for (int i = 0; i < 32; ++i) s ^= op[i] & (0u - ((v >> i) & 1u));
  return s;
}

__global__ void __launch_bounds__(ENC_THREADS)
encode_bucket_kernel(const uint32_t* __restrict__ blocks, int k,
                     long long n_lanes, uint32_t* out, uint32_t* crc,
                     long long nbytes, int tile_lanes, int want_crc,
                     const uint32_t* __restrict__ zero_ops, int seg_words) {
  __shared__ uint32_t tab[4][256];
  __shared__ uint32_t ops[ENC_LEVELS][32];
  __shared__ uint32_t part[ENC_THREADS];

  const int t = blockIdx.x;
  const int tid = threadIdx.x;
  const long long lane0 = (long long)t * tile_lanes;
  long long lanes = n_lanes - lane0;
  if (lanes > tile_lanes) lanes = tile_lanes;

  // 1. XOR fold (n_lanes and tile_lanes are multiples of 4 lanes)
  const long long row4 = n_lanes / 4;
  const uint4* src = reinterpret_cast<const uint4*>(blocks + lane0);
  uint4* dst = reinterpret_cast<uint4*>(out + lane0);
  for (long long i = tid; i < lanes / 4; i += ENC_THREADS) {
    uint4 a = src[i];
    for (int r = 1; r < k; ++r) {
      const uint4 b = src[r * row4 + i];
      a.x ^= b.x; a.y ^= b.y; a.z ^= b.z; a.w ^= b.w;
    }
    dst[i] = a;
  }
  if (!want_crc) {
    if (tid == 0) crc[t] = 0u;
    return;
  }

  // 2. slice-by-4 tables and zero-operators in shared memory
  for (int i = tid; i < 256; i += ENC_THREADS) {
    uint32_t c = (uint32_t)i;
    for (int b = 0; b < 8; ++b) c = (c & 1u) ? (c >> 1) ^ CRC_POLY : (c >> 1);
    tab[0][i] = c;
  }
  for (int i = tid; i < ENC_LEVELS * 32; i += ENC_THREADS)
    ops[i / 32][i % 32] = zero_ops[i];
  __syncthreads();  // also publishes step 1's `out` to the whole block
  for (int s = 1; s < 4; ++s) {
    for (int i = tid; i < 256; i += ENC_THREADS) {
      const uint32_t p = tab[s - 1][i];
      tab[s][i] = (p >> 8) ^ tab[0][p & 0xFFu];
    }
    __syncthreads();
  }

  // 3. raw CRC of this thread's segment
  long long nb = nbytes - lane0 * 4;
  if (nb < 0) nb = 0;
  if (nb > 4LL * tile_lanes) nb = 4LL * tile_lanes;
  const long long words = nb / 4;
  const int rem = (int)(nb % 4);
  const uint32_t* data = out + lane0;
  const long long hi = words - (long long)(ENC_THREADS - 1 - tid) * seg_words;
  long long lo = hi - seg_words;
  if (lo < 0) lo = 0;
  uint32_t c = 0u;
  for (long long w = lo; w < hi; ++w)
    c = crc_word(tab, c ^ data[w] ^ (w == 0 ? 0xFFFFFFFFu : 0u));
  part[tid] = c;
  __syncthreads();

  // 4. tree combine of equal-length neighbours
  for (int lvl = 0; lvl < ENC_LEVELS; ++lvl) {
    const int stride = 1 << lvl;
    if ((tid & ((stride << 1) - 1)) == 0)
      part[tid] = gf2_times(ops[lvl], part[tid]) ^ part[tid + stride];
    __syncthreads();
  }

  // 5. tail bytes and final xor
  if (tid == 0) {
    uint32_t r = words > 0 ? part[0] : 0xFFFFFFFFu;
    if (rem) {
      const uint32_t wv = data[words];
      for (int j = 0; j < rem; ++j) {
        const uint32_t b = (wv >> (8 * j)) & 0xFFu;
        r = (r >> 8) ^ tab[0][(r ^ b) & 0xFFu];
      }
    }
    crc[t] = r ^ 0xFFFFFFFFu;
  }
}

extern "C" int reft_encode_bucket(const void* blocks, int k, long long n_lanes,
                                  void* out, void* crc, long long nbytes,
                                  int tile_lanes, int n_tiles, int want_crc,
                                  const void* zero_ops, int seg_words,
                                  int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  encode_bucket_kernel<<<n_tiles, ENC_THREADS, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)blocks, k, n_lanes, (uint32_t*)out, (uint32_t*)crc,
      nbytes, tile_lanes, want_crc, (const uint32_t*)zero_ops, seg_words);
  return (int)cudaGetLastError();
}

extern "C" const char* reft_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
