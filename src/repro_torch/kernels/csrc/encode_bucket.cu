// Fused snapshot-bucket encode for Hopper (sm_90a): XOR-fold of k rows of
// uint32 lanes, then one zlib-compatible CRC32 per tile of the folded row.
//
// Replaces the TPU kernel repro/kernels/stage.py::encode_bucket (Pallas
// _encode_kernel / _encode_tiled_kernel, CRC in _crc_words/_crc_words_dyn).
// The TPU ran each tile as one sequential grid cell.
//
// Bound on an H100 SXM: bytes, (k+1) * 4 * n_lanes (k rows read, one row
// written) at 3.35 TB/s; the CRC adds 4 table lookups a word, all from
// shared memory.
//
// Two entries share one kernel body:
//  * encode_kernel<false>: the k rows are one contiguous (k, n_lanes)
//    array (`encode_bucket`);
//  * encode_kernel<true>: each row is a list of byte slices of the leaves
//    (`encode_ranges`), passed by value in the kernel's parameters, and
//    the kernel gathers them itself: 16-byte windows realigned from any
//    source byte alignment with funnel shifts (a window inside one slice
//    starts its two loads with the thread's other windows'), a window
//    that straddles slices merged under byte masks, zeros past the row's
//    last slice.
//
// Design (one launch a bucket):
//  * a tile of tile_lanes lanes is one thread-block cluster of ENC_CLUSTER
//    blocks; block c folds lanes [c*bw, (c+1)*bw) of its tile, bw =
//    ENC_THREADS * sw, sw = seg_words a power of two (16 for the 128 KiB
//    tiles: a 4 MiB bucket runs as 256 blocks);
//  * the fold: 16-byte loads, the k rows XORed in registers, `out` stored
//    from registers and the folded words kept in shared memory, word w at
//    w + w / sw (one pad word a segment: the CRC's per-thread segments
//    then fall on distinct banks). `out` is never read back;
//  * thread j CRCs segment j of its block's live words (raw CRC: register
//    from 0, no final xor; slice-by-4 tables built on the host), the
//    segments right-aligned to the block's last live word, so a short or
//    empty leading segment equals zero bytes on the left, which a raw CRC
//    ignores. zlib's initial 0xFFFFFFFF enters as the starting register
//    of the segment that begins at the tile's word 0;
//  * combine, raw(A||B) = Z(|B|) raw(A) ^ raw(B), with the GF(2)
//    operators Z(4*sw*2^l) built on the host as nibble tables (Z v is 8
//    lookups, each in 16 distinct banks) and copied into shared memory
//    while the fold runs: a shuffle tree over a warp's 32 segments (5
//    levels), the same over the block's ENC_WARPS warps (3 levels);
//  * the block that holds the tile's tail word adds the 1-3 tail bytes;
//    every block stores its raw CRC into block 0's shared memory
//    (distributed shared memory, after a cluster barrier), and block 0
//    combines them: each block before the last live one moved past the
//    full blocks after it (Z(4*bw*2^m) by the bits of their count), their
//    sum past the last live block's bytes by one operator from the
//    wrapper (it depends on nbytes), then the final xor.
//    A cluster barrier instead of an atomic ticket keeps the combine
//    free of global scratch and of a zeroing launch.
#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

#define ENC_THREADS 256    // threads a block (stage.py ENC_THREADS)
#define ENC_WARPS (ENC_THREADS / 32)
#define ENC_CLUSTER 8      // blocks a tile (stage.py ENC_CLUSTER)
#define MAX_SLICES 128     // stage.py MAX_SLICES
#define MAX_ROWS 16        // stage.py MAX_ROWS

// the wrapper's table (uint32 words, stage.py::table_words): the 4 x 256
// slice-by-4 table, then ZLEVELS operators Z(4*sw*2^l) as nibble tables
// (128 words each): levels 0-4 combine a warp's segments, 5-7 a block's
// warps, 8-10 (Z(4*bw*2^m)) a tile's blocks
#define ZLEVELS 11
#define OPS_WORDS (ZLEVELS * 128)

struct Slice {
  const uint8_t* src;  // the leaf byte that lands at row byte `lo`
  long long lo;        // row bytes [lo, next slice's lo or row_end)
};

// passed by value (stage.py::_Args mirrors it field for field)
struct EncodeArgs {
  const uint32_t* blocks;         // encode_kernel<false>: (k, n_lanes)
  uint32_t* out;                  // (n_lanes,)
  uint32_t* crc;                  // (n_tiles,)
  const uint32_t* tables;         // slice-by-4 table + zero operators
  long long n_lanes;
  long long nbytes;
  long long row_end[MAX_ROWS];    // bytes the row's slices cover
  Slice slices[MAX_SLICES];
  int k;
  int tile_lanes;
  int lsw;                        // log2(sw)
  int want_crc;
  int t_last;                     // the last tile with live bytes
  int n_slices;
  int row_first[MAX_ROWS + 1];    // row r: slices [row_first[r], [r+1])
  uint32_t op_full[32];           // Z(last live block's bytes), full tile
  uint32_t op_last[32];           // the same for tile t_last
};

__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// slice-by-4: advance a CRC register by one 32-bit word already xored in
__device__ __forceinline__ uint32_t crc_word(const uint32_t (*tab)[256],
                                             uint32_t x) {
  return tab[3][x & 0xFFu] ^ tab[2][(x >> 8) & 0xFFu] ^
         tab[1][(x >> 16) & 0xFFu] ^ tab[0][x >> 24];
}

__device__ __forceinline__ uint32_t warp_xor(uint32_t v) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v ^= __shfl_xor_sync(0xFFFFFFFFu, v, o);
  return v;
}

// Z v for an operator Z given as 8 x 16 nibble tables (table k, entry x:
// Z applied to x << 4k): 8 lookups, each in 16 distinct banks
__device__ __forceinline__ uint32_t zapply(const uint32_t* z, uint32_t v) {
  uint32_t s = 0;
#pragma unroll
  for (int k = 0; k < 8; ++k) s ^= z[16 * k + ((v >> (4 * k)) & 15u)];
  return s;
}

// bits of the bytes [lo, hi) of a word (lo, hi clamped to [0, 4])
__device__ __forceinline__ uint32_t byte_mask(int lo, int hi) {
  lo = min(max(lo, 0), 4);
  hi = min(max(hi, 0), 4);
  const uint32_t below_hi = hi >= 4 ? 0xFFFFFFFFu : (1u << (8 * hi)) - 1u;
  const uint32_t below_lo = lo >= 4 ? 0xFFFFFFFFu : (1u << (8 * lo)) - 1u;
  return below_hi & ~below_lo;
}

// the window of 16 source bytes starting at q, from its two 16-byte
// vectors a (at q & ~15) and b (16 bytes on)
__device__ __forceinline__ void realign(uint4 a, uint4 b, int sh,
                                        uint32_t out[4]) {
  const uint32_t w[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
  const int qw = sh >> 2, rb = 8 * (sh & 3);
  uint32_t u[5];
#pragma unroll
  for (int i = 0; i < 5; ++i)
    u[i] = qw == 0 ? w[i] : qw == 1 ? w[i + 1]
         : qw == 2 ? w[i + 2] : w[i + 3];
#pragma unroll
  for (int m = 0; m < 4; ++m) out[m] = __funnelshift_r(u[m], u[m + 1], rb);
}

// the last of the row's slices sl[s0, s1) that starts at or before p
__device__ __forceinline__ int find_slice(const Slice* sl, int s0, int s1,
                                          long long p) {
  int l = s0, h = s1;
  while (h - l > 1) {
    const int m = (l + h) >> 1;
    if (sl[m].lo <= p) l = m; else h = m;
  }
  return l;
}

// row bytes [p, p+16) from the row's slices sl[l, s1) (l from
// find_slice), zero past row_end: any window, slice by slice
__device__ uint4 gather16(const Slice* sl, int l, int s1, long long row_end,
                          long long p) {
  uint32_t res[4] = {0u, 0u, 0u, 0u};
  for (int s = l; s < s1; ++s) {
    const long long d = sl[s].lo;
    if (d >= p + 16) break;
    const long long e = s + 1 < s1 ? sl[s + 1].lo : row_end;
    const int blo = (int)(max(p, d) - p);       // window bytes [blo, bhi)
    const int bhi = (int)(min(p + 16, e) - p);  // come from this slice
    if (bhi <= blo) continue;
    // the source address of window byte 0, and its 16-byte vectors: load
    // only those that hold one of the slice's bytes
    const unsigned long long q =
        (unsigned long long)sl[s].src + (unsigned long long)(p - d);
    const int sh = (int)(q & 15u);
    const uint4* v = reinterpret_cast<const uint4*>(q - sh);
    uint4 a = make_uint4(0u, 0u, 0u, 0u), b = a;
    if (sh + blo < 16) a = __ldg(v);
    if (sh + bhi > 16) b = __ldg(v + 1);
    uint32_t win[4];
    realign(a, b, sh, win);
#pragma unroll
    for (int m = 0; m < 4; ++m)
      res[m] |= win[m] & byte_mask(blo - 4 * m, bhi - 4 * m);
  }
  return make_uint4(res[0], res[1], res[2], res[3]);
}

template <bool GATHER>
__global__ void __cluster_dims__(ENC_CLUSTER, 1, 1)
__launch_bounds__(ENC_THREADS)
encode_kernel(const __grid_constant__ EncodeArgs a) {
  // 16-byte vectors of a row a thread has in flight at once (the gather
  // holds two a window)
  constexpr int MAX_VEC = GATHER ? 2 : 4;
  extern __shared__ uint32_t sdata[];  // folded words, word w at w + w/sw
  __shared__ uint32_t tab[4][256];
  __shared__ uint32_t ops[OPS_WORDS];           // the combines' operators
  __shared__ uint32_t op_piece[128];            // Z(last piece), this tile
  __shared__ uint32_t warp_raw[ENC_WARPS];
  __shared__ uint32_t block_raw[ENC_CLUSTER];  // block 0: each block's CRC
  __shared__ Slice sl[GATHER ? MAX_SLICES : 1];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int c = blockIdx.x % ENC_CLUSTER;      // rank in the cluster
  const int t = blockIdx.x / ENC_CLUSTER;      // tile
  const int lsw = a.lsw;
  const int bw = ENC_THREADS << lsw;
  const long long lane0 = (long long)t * a.tile_lanes;
  const long long lanes = min((long long)a.tile_lanes, a.n_lanes - lane0);
  const int nl = (int)max(0LL, min((long long)bw, lanes - (long long)c * bw));
  const long long w0 = lane0 + (long long)c * bw;   // block's first lane

  // the tables arrive while the fold runs (first read after its barrier)
  if (a.want_crc) {
    cluster_arrive_relaxed();     // waited for before the remote store
    for (int i = tid; i < 4 * 256; i += ENC_THREADS)
      (&tab[0][0])[i] = __ldg(a.tables + i);
    for (int i = tid; i < OPS_WORDS; i += ENC_THREADS)
      ops[i] = __ldg(a.tables + 4 * 256 + i);
    if (tid < 128) {              // Z(last piece) as nibble tables
      const uint32_t* col = t == a.t_last ? a.op_last : a.op_full;
      uint32_t z = 0u;
      for (int i = 0; i < 4; ++i)
        if ((tid >> i) & 1) z ^= col[4 * (tid >> 4) + i];
      op_piece[tid] = z;
    }
  }
  if constexpr (GATHER) {
    for (int i = tid; i < a.n_slices; i += ENC_THREADS) sl[i] = a.slices[i];
    __syncthreads();
  }

  // 1. fold: a batch of each row's 16-byte loads in flight, XOR in
  //    registers, `out` stored from registers
  const int nvec = nl / 4;
  const uint4* rows4 = reinterpret_cast<const uint4*>(a.blocks);
  uint4* out4 = reinterpret_cast<uint4*>(a.out + w0);
  for (int v0 = 0; v0 < nvec; v0 += ENC_THREADS * MAX_VEC) {
    uint4 acc[MAX_VEC];
#pragma unroll
    for (int j = 0; j < MAX_VEC; ++j) acc[j] = make_uint4(0u, 0u, 0u, 0u);
    for (int r = 0; r < a.k; ++r) {
      if constexpr (GATHER) {
        // windows inside one slice (all but a few) load both vectors
        // first; the others go slice by slice
        const int s0 = a.row_first[r], s1 = a.row_first[r + 1];
        const long long end = a.row_end[r];
        int sj[MAX_VEC], shj[MAX_VEC];
        bool inside[MAX_VEC];
        uint4 va[MAX_VEC], vb[MAX_VEC];
#pragma unroll
        for (int j = 0; j < MAX_VEC; ++j) {
          const int v = v0 + j * ENC_THREADS + tid;
          const long long p = 4 * (w0 + 4LL * v);
          const int s = find_slice(sl, s0, s1, p);
          sj[j] = s;
          inside[j] = false;
          shj[j] = 0;
          va[j] = vb[j] = make_uint4(0u, 0u, 0u, 0u);
          if (v < nvec && s < s1) {
            const long long d = sl[s].lo;
            const long long e = s + 1 < s1 ? sl[s + 1].lo : end;
            inside[j] = d <= p && p + 16 <= e;
            if (inside[j]) {
              const unsigned long long q = (unsigned long long)sl[s].src +
                                           (unsigned long long)(p - d);
              const int sh = (int)(q & 15u);
              const uint4* vq = reinterpret_cast<const uint4*>(q - sh);
              shj[j] = sh;
              va[j] = __ldg(vq);
              if (sh) vb[j] = __ldg(vq + 1);
            }
          }
        }
#pragma unroll
        for (int j = 0; j < MAX_VEC; ++j) {
          const int v = v0 + j * ENC_THREADS + tid;
          if (v < nvec) {
            uint32_t x[4];
            if (inside[j]) {
              realign(va[j], vb[j], shj[j], x);
            } else {
              const uint4 g = gather16(sl, sj[j], s1, end,
                                       4 * (w0 + 4LL * v));
              x[0] = g.x; x[1] = g.y; x[2] = g.z; x[3] = g.w;
            }
            acc[j].x ^= x[0]; acc[j].y ^= x[1];
            acc[j].z ^= x[2]; acc[j].w ^= x[3];
          }
        }
      } else {
#pragma unroll
        for (int j = 0; j < MAX_VEC; ++j) {
          const int v = v0 + j * ENC_THREADS + tid;
          if (v < nvec) {
            const uint4 x = __ldg(rows4 + r * (a.n_lanes / 4) + w0 / 4 + v);
            acc[j].x ^= x.x; acc[j].y ^= x.y;
            acc[j].z ^= x.z; acc[j].w ^= x.w;
          }
        }
      }
    }
#pragma unroll
    for (int j = 0; j < MAX_VEC; ++j) {
      const int v = v0 + j * ENC_THREADS + tid;
      if (v < nvec) {
        out4[v] = acc[j];
        if (a.want_crc) {
          const int w = 4 * v;
          sdata[w + (w >> lsw)] = acc[j].x;
          sdata[w + 1 + ((w + 1) >> lsw)] = acc[j].y;
          sdata[w + 2 + ((w + 2) >> lsw)] = acc[j].z;
          sdata[w + 3 + ((w + 3) >> lsw)] = acc[j].w;
        }
      }
    }
  }
  if (!a.want_crc) {
    if (c == 0 && tid == 0) a.crc[t] = 0u;
    return;
  }
  __syncthreads();

  // 2. raw CRC of this thread's segment of the block's live words
  const long long nb =
      max(0LL, min(4LL * lanes, a.nbytes - 4LL * lane0));  // tile's bytes
  const long long nw = nb / 4;
  const int rem = (int)(nb % 4);
  const int live = (int)max(0LL, min((long long)bw, nw - (long long)c * bw));
  const int sw = 1 << lsw;
  const int hi = live - (ENC_THREADS - 1 - tid) * sw;
  const int lo = max(0, hi - sw);
  uint32_t r = (c == 0 && lo == 0 && hi > 0) ? 0xFFFFFFFFu : 0u;
#pragma unroll 4
  for (int w = lo; w < hi; ++w) r = crc_word(tab, r ^ sdata[w + (w >> lsw)]);

  // 3. the warp's segments, then the block's warps: a tree, level l
  //    folding in the next 2^l segments, raw(A||B) = Z(|B|) raw(A) ^ raw(B)
#pragma unroll
  for (int l = 0; l < 5; ++l) {
    const uint32_t next = __shfl_down_sync(0xFFFFFFFFu, r, 1 << l);
    r = zapply(ops + 128 * l, r) ^ next;
  }
  if (lane == 0) warp_raw[warp] = r;
  __syncthreads();
  uint32_t piece = 0u;
  if (warp == 0) {
    piece = lane < ENC_WARPS ? warp_raw[lane] : 0u;
#pragma unroll
    for (int l = 0; l < 3; ++l) {
      const uint32_t next = __shfl_down_sync(0xFFFFFFFFu, piece, 1 << l);
      piece = zapply(ops + 128 * (5 + l), piece) ^ next;
    }
    const long long tw = nw - (long long)c * bw;   // the tail word, local
    if (lane == 0 && tw >= 0 && tw < bw) {
      // this block holds the tile's tail: its 1-3 bytes; with no whole
      // word before them they start from zlib's initial register
      if (nw == 0) piece = 0xFFFFFFFFu;
      const uint32_t word = rem ? sdata[tw + (tw >> lsw)] : 0u;
      for (int j = 0; j < rem; ++j) {
        const uint32_t b = (word >> (8 * j)) & 0xFFu;
        piece = (piece >> 8) ^ tab[0][(piece ^ b) & 0xFFu];
      }
    }
  }

  // 4. every block's piece into block 0, which combines them
  cluster_wait();                 // every block of the cluster is running
  if (tid == 0)
    cg::this_cluster().map_shared_rank(&block_raw[0], 0)[c] = piece;
  cluster_arrive();
  cluster_wait();
  if (c != 0 || warp != 0) return;
  uint32_t result = 0u;                            // an empty tile: 0
  if (nb > 0) {
    // the last block with live bytes, and the blocks before it: block
    // c < e moved past the e-1-c full blocks after it, then all of them
    // past block e's piece
    const int e = (int)((nw > 0 && rem == 0) ? (nw - 1) / bw : nw / bw);
    uint32_t x = lane < e ? block_raw[lane] : 0u;
    const int m = e - 1 - lane;
#pragma unroll
    for (int l = 0; l < 3; ++l) {
      const uint32_t y = zapply(ops + 128 * (8 + l), x);
      if (lane < e && ((m >> l) & 1)) x = y;
    }
    x = warp_xor(x);
    result = zapply(op_piece, x) ^ block_raw[e] ^ 0xFFFFFFFFu;
  }
  if (lane == 0) a.crc[t] = result;
}

extern "C" int reft_encode_args_size() { return (int)sizeof(EncodeArgs); }

extern "C" int reft_encode_bucket(const EncodeArgs* args, int gather,
                                  int n_tiles, int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const int bw = ENC_THREADS << args->lsw;
  const size_t smem =
      args->want_crc ? (size_t)(bw + ENC_THREADS) * sizeof(uint32_t) : 0;
  const dim3 grid(n_tiles * ENC_CLUSTER);
  cudaStream_t s = (cudaStream_t)stream;
  if (gather)
    encode_kernel<true><<<grid, ENC_THREADS, smem, s>>>(*args);
  else
    encode_kernel<false><<<grid, ENC_THREADS, smem, s>>>(*args);
  return (int)cudaGetLastError();
}

extern "C" const char* reft_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
