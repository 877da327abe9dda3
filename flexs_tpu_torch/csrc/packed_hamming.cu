// Masked packed-Hamming distance matrix, designed for Hopper (sm_90a).
//
// Replaces no Pallas kernel: the JAX package has none for this op, and XLA
// fuses flexs_tpu/ops/packed_hamming.py::packed_hamming_matrix (with the
// fill mask of flexs_tpu/runtime/jit_runner.py::_dists_to_cache) into its
// callers.  The port ran it as a chain of int64 torch ops, each writing the
// whole [C, m, N] tensor to device memory; this kernel writes the result
// once.  It computes what flexs_tpu_torch/ops/packed_hamming.py::
// masked_hamming_matrix_plain computes, integer for integer:
//
//   out[c, i, j] = sum_w popcount(fold(q[c, i, w] ^ r[c, j, w]) & lsb)
//                  if j < fills[c], else `fill`,
//
// for j < N, where fold ORs each symbol's `bits` bits onto its lowest one.
// Words are int64 holding values below 2**32, read as uint32.  Queries and
// rows are read through the strides they are given (a slice of the rows is
// never copied); the output is contiguous.
//
// What bounds it on this card.  At the main path's shape (one word a row,
// 2 bits a symbol, C = 40 cells x m = 100 queries x N up to ~22,000 rows)
// an element costs one popcount and about eight other integer operations,
// and it writes 4 bytes.  The H100 retires 16 popcounts a clock on each of
// its 132 SMs, about 4.2 T a second, but writes 3.35 TB/s, 0.84 T int32
// elements a second: the output's bytes bound the kernel five times over.
// With K = 7 words a row (RNA, L = 100) the popcounts and the writes are
// about even.
//
// What the design does about it.  Nothing leaves the chip but the result,
// written once, in int32, with 16-byte stores:
//  * a block owns 512 consecutive rows of one cell and up to kQueryTile
//    of its queries (fewer where that would leave SMs idle: one cell with
//    a few thousand rows).  The queries' words sit in shared memory; each
//    thread loops over them and writes one 16-byte store a query, so a
//    warp's store covers 512 contiguous bytes of an output row;
//  * an output row starts 16-byte aligned only where its element offset
//    (c * m + i) * N is a multiple of 4.  So each thread writes the
//    aligned group of 4 elements it owns in that row, shifted left by the
//    row's offset modulo 4 (uniform across the block), and a group cut by
//    either end of the row is written element by element;
//  * with one word a row, a thread keeps the 7 row words its shifted groups
//    can touch in registers, loaded once for all its queries; other K
//    (a general path, not the main one) read the row words through L1 for
//    each query;
//  * the fill mask is a compare against the cell's fill, read once a block
//    from device memory: no host sync and no second pass.
#include <algorithm>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;      // threads of a block, along the rows
constexpr int kGroup = 4;          // elements a thread writes a query: one 16-byte store
constexpr int kQueryTile = 32;     // most queries a block holds
constexpr int kMaxTileWords = 12288;  // 48 KB of query words in shared memory
constexpr int kMinBlocks = 4 * 132;   // four blocks for each of the H100's SMs
constexpr int kReach = 2 * kGroup - 1;  // rows a thread's shifted groups can touch

struct Args {
  const int64_t* q;  // queries [cells, m, k]
  int64_t q_cs, q_rs, q_ws;
  const int64_t* r;  // rows [cells, >= n, k]
  int64_t r_cs, r_rs, r_ws;
  const int64_t* fills;  // [cells], or null: no mask
  int64_t f_cs;
  int32_t* out;  // [cells, m, n], contiguous
  int m, n, k, bits, fill, q_tile;
  uint32_t lsb;
};

__device__ __forceinline__ int word_distance(uint32_t x, int bits, uint32_t lsb) {
  uint32_t f = x;
  for (int b = 1; b < bits; ++b) f |= x >> b;
  return __popc(f & lsb);
}

__device__ __forceinline__ int component(const int4& v, int e) {
  return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}

// Write v to elements js .. js + 3 of the n-wide output row at `base`.
__device__ __forceinline__ void store_group(int32_t* out, int64_t base, int js, int n,
                                            const int4& v) {
  if (js >= 0 && js + kGroup <= n) {
    *reinterpret_cast<int4*>(out + base + js) = v;
    return;
  }
#pragma unroll
  for (int e = 0; e < kGroup; ++e) {
    const int j = js + e;
    if (j >= 0 && j < n) out[base + j] = component(v, e);
  }
}

__global__ void __launch_bounds__(kThreads) packed_hamming_kernel(const Args a) {
  extern __shared__ uint32_t sq[];  // [tile queries, k]
  const int cell = blockIdx.z;
  const int i0 = blockIdx.y * a.q_tile;
  const int tile = min(a.q_tile, a.m - i0);
  const int t = blockIdx.x * kThreads + threadIdx.x;  // this thread's group
  const int64_t* q = a.q + cell * a.q_cs;
  const int64_t* r = a.r + cell * a.r_cs;
  const int64_t fc = a.fills ? a.fills[cell * a.f_cs] : INT64_MAX;

  for (int idx = threadIdx.x; idx < tile * a.k; idx += kThreads) {
    const int ii = idx / a.k, w = idx - ii * a.k;
    sq[idx] = (uint32_t)q[(i0 + ii) * a.q_rs + w * a.q_ws];
  }
  __syncthreads();

  // Rows j0 + e, e < kReach, are those the groups js = kGroup * t - s,
  // s < kGroup, can touch.
  const int j0 = kGroup * t - (kGroup - 1);
  if (j0 >= a.n) return;
  if (a.k == 1) {
    uint32_t rw[kReach];
#pragma unroll
    for (int e = 0; e < kReach; ++e) {
      const int j = j0 + e;
      rw[e] = (j >= 0 && j < a.n) ? (uint32_t)r[j * a.r_rs] : 0u;
    }
    for (int ii = 0; ii < tile; ++ii) {
      const int64_t base = ((int64_t)cell * a.m + i0 + ii) * a.n;
      const int s = (int)(base & (kGroup - 1));
      const uint32_t qw = sq[ii];
      int d[kGroup];
#pragma unroll
      for (int e = 0; e < kGroup; ++e) {
        // Row j0 + (kGroup - 1 - s) + e, from registers: s is uniform, so
        // the switch does not diverge.
        uint32_t x;
        switch (s) {
          case 0: x = rw[3 + e]; break;
          case 1: x = rw[2 + e]; break;
          case 2: x = rw[1 + e]; break;
          default: x = rw[e]; break;
        }
        const int j = kGroup * t - s + e;
        d[e] = j < fc ? word_distance(qw ^ x, a.bits, a.lsb) : a.fill;
      }
      store_group(a.out, base, kGroup * t - s, a.n, make_int4(d[0], d[1], d[2], d[3]));
    }
    return;
  }
  for (int ii = 0; ii < tile; ++ii) {
    const int64_t base = ((int64_t)cell * a.m + i0 + ii) * a.n;
    const int s = (int)(base & (kGroup - 1));
    const int js = kGroup * t - s;
    const uint32_t* qi = sq + ii * a.k;
    int d[kGroup];
#pragma unroll
    for (int e = 0; e < kGroup; ++e) {
      const int j = js + e;
      int v = a.fill;
      if (j >= 0 && j < a.n && j < fc) {
        const int64_t* rj = r + j * a.r_rs;
        v = 0;
        for (int w = 0; w < a.k; ++w) {
          v += word_distance(qi[w] ^ (uint32_t)rj[w * a.r_ws], a.bits, a.lsb);
        }
      }
      d[e] = v;
    }
    store_group(a.out, base, js, a.n, make_int4(d[0], d[1], d[2], d[3]));
  }
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 when the launch was taken).
// `fills` may be null (no mask; `fill` unused).  Strides are in elements.
extern "C" int packed_hamming_launch(
    const int64_t* q, int64_t q_cs, int64_t q_rs, int64_t q_ws,
    const int64_t* r, int64_t r_cs, int64_t r_rs, int64_t r_ws,
    const int64_t* fills, int64_t f_cs, int32_t* out,
    int cells, int m, int n, int k, int bits, uint32_t lsb, int fill, void* stream) {
  if (cells < 1 || m < 1 || n < 1 || k < 1 || k > kMaxTileWords || bits < 1 || bits > 5 ||
      (reinterpret_cast<uintptr_t>(out) & 15) != 0) {
    return (int)cudaErrorInvalidValue;
  }
  // Group t writes from row kGroup * t - s, s < kGroup: the last that can
  // reach row n - 1 is t = (n + kGroup - 2) / kGroup.
  const long long groups = ((long long)n + kGroup - 2) / kGroup + 1;
  const long long blocks_x = (groups + kThreads - 1) / kThreads;
  // Tiles of at most kQueryTile queries (fewer where the words would pass
  // 48 KB), as even as the count allows; more, down to one query a tile,
  // where the grid would hold fewer than kMinBlocks blocks.
  const int most = std::min(kQueryTile, kMaxTileWords / k);
  const long long fill_card = (kMinBlocks + blocks_x * cells - 1) / (blocks_x * cells);
  const int want = (int)std::min<long long>(
      m, std::max<long long>((m + most - 1) / most, fill_card));
  const int q_tile = (m + want - 1) / want;
  const int tiles = (m + q_tile - 1) / q_tile;
  if (tiles > 65535 || cells > 65535 || blocks_x > 0x7fffffffLL) {
    return (int)cudaErrorInvalidValue;
  }
  const Args a = {q, q_cs, q_rs, q_ws, r, r_cs, r_rs, r_ws, fills, f_cs, out,
                  m, n, k, bits, fill, q_tile, lsb};
  const dim3 grid((unsigned)blocks_x, (unsigned)tiles, (unsigned)cells);
  const size_t smem = (size_t)q_tile * k * sizeof(uint32_t);
  packed_hamming_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
