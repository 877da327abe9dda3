// The first CUDA duplex DP (sm_90a): the row-cost build `first`.
//
// Counterpart of scripts/profile_duplex_rowcost.py::run_variant's baseline,
// the kernel the JAX script profiled.  No main path loads it; the main
// path's kernel is csrc/duplex_dp.cu, a redesign of this one, whose
// knockouts csrc/duplex_rowcost.cu builds.  This file keeps the first
// kernel token for token (tests/test_torch_rowcost.py pins its digest) as
// the yardstick that PERF.md's earlier readings name.
//
// It replaced flexs_tpu/ops/pallas_duplex.py::
// _pallas_duplex_batch (kernel body _duplex_kernel -> _duplex_group_body).
// It computes, for B sequences x T
// reversed targets in one launch, the same recursion as the plain version
// flexs_tpu_torch/ops/rna_duplex.py::_duplex_dp_slabs, bit for bit.
//
// Mapping.  One block per (sequence b, target t); thread j owns target
// column j (blockDim = L2 rounded up to 32).  DP rows i run in a loop with
// one __syncthreads() per row.  The three window channels (c, c + mA,
// c + AU) of the last d = maxloop + 2 rows live in shared memory as rings;
// each ring row carries d columns of sentinel padding on the left, so the
// column shift "read column j - k, sentinel where j - k < 0" is a plain
// read.  With d ring slots, row i writes the slot of row i - d, which no
// thread reads during row i, so one barrier per row suffices.  Per-cell
// energies are gathered from the gram-pair tables t_past f32[7, 64, 64]
// and t_fut f32[2, 16, 16] through the read-only cache, at
// (sequence gram of row i, target gram of column j); the duplex-end
// patches come precomputed from the wrapper.
//
// Exactness.  Every value is an f32 add or min of table entries, in the
// plain version's association: interior candidates are
// win_ca[r][j - dj] + interior_cost[r + 1][dj], min-reduced, then + mB;
// bulge candidates are min-reduced, then + AU.  There is no multiply, so
// nothing can contract into an FMA; build without --use_fast_math.  min is
// exact in any order.  The sentinel is the finite 1e6 of the energy
// tables, never inf.
//
// What bounds it.  Each cell does ~153 candidate add+min pairs (4 direct,
// 119 interior, 15 + 15 bulge), each reading one shared-memory word: the
// work is shared-memory and issue bound, not device-memory bound (inputs
// are a few hundred KB).  But the rows are serial, each row ends in a
// barrier, and at the main path's B = 100, T = 1 only 100 blocks of 4
// warps are resident on 132 SMs, so the kernel is latency bound far above
// its operation bound.  This first version accepts that: it keeps each
// block's working set in shared memory and registers (no device-memory
// traffic inside the row loop beyond the cached table gathers) and leaves
// packing several sequences per block, and breaking the serial min chains,
// to later work.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kInf = 1e6f;  // the energy model's finite sentinel

// Channel order of t_past (rna_duplex._PAST) and t_fut (rna_duplex._FUT).
enum { P_OPEN = 0, P_STACK, P_B1S, P_B1T, P_I11, P_MB, P_AU };
enum { F_MA = 0, F_CLOSE };

__host__ __device__ inline int ring_stride(int d, int l2) { return d + l2; }

__host__ __device__ inline size_t smem_floats(int d, int l2) {
  return 3 * (size_t)d * ring_stride(d, l2)  // three window rings
         + (size_t)d * d                    // interior_cost
         + (d - 1) + d                      // bulge_seq, bulge_tgt
         + 32;                              // per-warp minima
}

__global__ void duplex_dp_kernel(
    const int32_t* __restrict__ s3g,         // [B, L1] sequence trigram index
    const int32_t* __restrict__ s2g,         // [B, L1] sequence forward bigram
    const int32_t* __restrict__ t3g,         // [T, L2] target trigram index
    const int32_t* __restrict__ t2g,         // [T, L2] target forward bigram
    const float* __restrict__ open_col0,     // [B, T, L1] OPEN, column 0
    const float* __restrict__ close_coll,    // [B, T, L1] CLOSE, column L2-1
    const float* __restrict__ open_row0,     // [B, T, L2] OPEN, row 0
    const float* __restrict__ close_rowl,    // [B, T, L2] CLOSE, row L1-1
    const float* __restrict__ t_past,        // [7, 64, 64]
    const float* __restrict__ t_fut,         // [2, 16, 16]
    const float* __restrict__ interior_cost, // [d, d]
    const float* __restrict__ bulge_seq,     // [d - 1]
    const float* __restrict__ bulge_tgt,     // [d]
    float* __restrict__ out,                 // [B, T]
    int n_targets, int l1, int l2, int maxloop) {
  extern __shared__ float smem[];
  const int d = maxloop + 2;
  const int stride = ring_stride(d, l2);
  float* win_c = smem;
  float* win_ca = win_c + d * stride;
  float* win_cw = win_ca + d * stride;
  float* icost = win_cw + d * stride;
  float* bseq = icost + d * d;
  float* btgt = bseq + (d - 1);
  float* warp_min = btgt + d;

  const int bt = blockIdx.x;  // b * T + t
  const int b = bt / n_targets;
  const int t = bt % n_targets;
  const int j = threadIdx.x;
  const bool active = j < l2;

  for (int k = threadIdx.x; k < 3 * d * stride; k += blockDim.x) smem[k] = kInf;
  for (int k = threadIdx.x; k < d * d; k += blockDim.x) icost[k] = interior_cost[k];
  for (int k = threadIdx.x; k < d - 1; k += blockDim.x) bseq[k] = bulge_seq[k];
  for (int k = threadIdx.x; k < d; k += blockDim.x) btgt[k] = bulge_tgt[k];
  __syncthreads();

  const int t3 = active ? t3g[t * l2 + j] : 0;
  const int t2 = active ? t2g[t * l2 + j] : 0;
  const int32_t* s3_row = s3g + (size_t)b * l1;
  const int32_t* s2_row = s2g + (size_t)b * l1;
  const float* col0 = open_col0 + (size_t)bt * l1;
  const float* coll = close_coll + (size_t)bt * l1;
  const float* row0 = open_row0 + (size_t)bt * l2;
  const float* rowl = close_rowl + (size_t)bt * l2;
  // Column j of ring slot s: ring + s * stride + d + j (d sentinel columns
  // on the left absorb shifts up to d - 1).
  const int col = d + j;

  float best = kInf;
  for (int i = 0; i < l1; ++i) {
    if (active) {
      const float* tp = t_past + __ldg(s3_row + i) * 64 + t3;
      const float* tf = t_fut + __ldg(s2_row + i) * 16 + t2;
      // Duplex-end patches: column first, then row (the column patches
      // carry the corner values).
      float open_e;
      if (j == 0) open_e = __ldg(col0 + i);
      else if (i == 0) open_e = __ldg(row0 + j);
      else open_e = __ldg(tp + P_OPEN * 4096);
      float close_e;
      if (j == l2 - 1) close_e = __ldg(coll + i);
      else if (i == l1 - 1) close_e = __ldg(rowl + j);
      else close_e = __ldg(tf + F_CLOSE * 256);
      const float au_e = __ldg(tp + P_AU * 4096);

      // Ring slot of DP row i - 1 - r.  Rows before 0 map to slots that no
      // row has written yet, which still hold the sentinel.
      int slot0 = (i - 1) % d;
      if (slot0 < 0) slot0 += d;
      const int slot1 = slot0 == 0 ? d - 1 : slot0 - 1;
      const float* c0 = win_c + slot0 * stride + col;
      const float* c1 = win_c + slot1 * stride + col;

      float acc = fminf(open_e, c0[-1] + __ldg(tp + P_STACK * 4096));
      acc = fminf(acc, c1[-1] + __ldg(tp + P_B1S * 4096));
      acc = fminf(acc, c0[-2] + __ldg(tp + P_B1T * 4096));
      acc = fminf(acc, c1[-2] + __ldg(tp + P_I11 * 4096));

      // Generic interior loops: window row r (DP row i-1-r) shifted by dj,
      // over r + dj - 1 <= maxloop, excluding the 1x1 case (r=1, dj=2).
      float loop_min = INFINITY;
      int slot = slot1;
          for (int r = 1; r <= maxloop; ++r) {
        const float* w = win_ca + slot * stride + col;
        const float* cost = icost + (r + 1) * d;
        const int dj_max = maxloop + 1 - r;
              for (int dj = (r == 1 ? 3 : 2); dj <= dj_max; ++dj) {
          loop_min = fminf(loop_min, w[-dj] + cost[dj]);
        }
        slot = slot == 0 ? d - 1 : slot - 1;
      }
      acc = fminf(acc, loop_min + __ldg(tp + P_MB * 4096));

      // Bulges of >= 2 unpaired bases on the sequence (rows) or the
      // target (columns) side.
      float bulge_min = INFINITY;
      slot = slot1 == 0 ? d - 1 : slot1 - 1;  // r = 2
          for (int r = 2; r <= maxloop; ++r) {
        bulge_min = fminf(bulge_min, win_cw[slot * stride + col - 1] + bseq[r]);
        slot = slot == 0 ? d - 1 : slot - 1;
      }
      const float* w0 = win_cw + slot0 * stride + col;
          for (int dj = 3; dj <= maxloop + 1; ++dj) {
        bulge_min = fminf(bulge_min, w0[-dj] + btgt[dj]);
      }
      acc = fminf(acc, bulge_min + au_e);

      // Unpairable cells admit no path at all.
      if (open_e >= kInf / 2) acc = kInf;
      best = fminf(best, acc + close_e);

      const int dst = (i % d) * stride + col;
      win_c[dst] = acc;
      win_ca[dst] = acc + __ldg(tf + F_MA * 256);
      win_cw[dst] = acc + au_e;
    }
    __syncthreads();
  }

  for (int off = 16; off > 0; off >>= 1) {
    best = fminf(best, __shfl_down_sync(0xffffffffu, best, off));
  }
  if ((threadIdx.x & 31) == 0) warp_min[threadIdx.x >> 5] = best;
  __syncthreads();
  if (threadIdx.x == 0) {
    float m = warp_min[0];
    for (int w = 1; w < (int)(blockDim.x >> 5); ++w) m = fminf(m, warp_min[w]);
    // No pairable positions at all => energy 0 (no duplex forms).
    out[bt] = m >= kInf / 2 ? 0.0f : m;
  }
}

}  // namespace

// Launches the DP on `stream` and returns cudaGetLastError() (0 = launched).
// Shapes and dtypes are checked by the Python wrapper; requires
// 1 <= l2 <= 1024 and maxloop >= 3.
extern "C" int duplex_first_launch(
    const int32_t* s3g, const int32_t* s2g, const int32_t* t3g,
    const int32_t* t2g, const float* open_col0, const float* close_coll,
    const float* open_row0, const float* close_rowl, const float* t_past,
    const float* t_fut, const float* interior_cost, const float* bulge_seq,
    const float* bulge_tgt, float* out, int n_seqs, int n_targets, int l1,
    int l2, int maxloop, void* stream) {
  const int d = maxloop + 2;
  const int threads = ((l2 + 31) / 32) * 32;
  const size_t smem = smem_floats(d, l2) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        duplex_dp_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  duplex_dp_kernel<<<n_seqs * n_targets, threads, smem, (cudaStream_t)stream>>>(
      s3g, s2g, t3g, t2g, open_col0, close_coll, open_row0, close_rowl, t_past,
      t_fut, interior_cost, bulge_seq, bulge_tgt, out, n_targets, l1, l2, maxloop);
  return (int)cudaGetLastError();
}
