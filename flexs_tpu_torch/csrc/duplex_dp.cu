// RNA duplex min-free-energy DP, designed for Hopper (sm_90a).
//
// Replaces flexs_tpu/ops/pallas_duplex.py::_pallas_duplex_batch (kernel body
// _duplex_kernel -> _duplex_group_body).  For B sequences x T reversed
// targets in one launch it computes the recursion of the plain version
// flexs_tpu_torch/ops/rna_duplex.py::_duplex_dp_slabs, bit for bit.  It is
// the redesign of the first CUDA kernel, which csrc/duplex_first.cu keeps
// unchanged as the yardstick.
//
// Mapping.  One block per (sequence b, target t), one thread per target
// column j (blockDim = L2 rounded up to the warp).  DP rows i run in a
// loop with one __syncthreads() per row: column j reads up to maxloop + 1
// columns to its left, across warps.  The three window channels (c, c + mA, c + AU) of the last d = maxloop + 2
// rows live in shared memory as rings; each ring carries `pad` sentinel
// columns left of column 0, so "column j - k, or the sentinel where
// j - k < 0" is a plain read.  Row i overwrites row i - d, which no thread
// reads during row i.
//
// What bounds it on this card.  A cell has 4 direct candidates, 119
// interior and 30 bulge candidates, each a window read, an add and a min.
// The first kernel read each candidate's size cost from shared memory too,
// although every thread of the block reads the same cost: about 302
// shared loads per cell, half of them constants, against 128 bytes per
// clock per SM.  With one thread per column each cell is also one serial
// chain of ~150 dependent mins, and at the main path's B = 100, T = 1 the
// card holds 100 blocks of 4 warps on 132 SMs, one warp per scheduler,
// with nothing to hide that chain.  What the design does about it:
//  * records in the kernel: each block stages its sequence's tokens in
//    shared memory and forms the gram indices and duplex-end patches itself
//    from a per-landscape plan (target grams, gram-pair tables t_past
//    f32[7,64,64] / t_fut f32[2,16,16], and patch tables indexed by a base
//    and its neighbour or by (end base, column)).  Row i + 1's gram indices
//    and nine table energies are loaded while row i runs, so no dependent
//    load pair opens a row;
//  * a compile-time window: template parameter M = maxloop (16, the
//    calibrated value), so the window-row and shift loops unroll.  Its
//    c + mA and c + AU rings are column-major with every row stored twice
//    (see smem_bytes), so all reads of a row's ~150 candidates are shared
//    loads at immediate offsets from one base, with no per-window-row slot
//    arithmetic.  Other maxloop values (>= 3), and targets too long for
//    a 512-thread block, run the M = 0 instantiation with runtime loops
//    over the first kernel's row-major rings;
//  * costs out of shared memory: with M = 16 the size costs (1,436 bytes)
//    are a by-value kernel parameter, so each add reads its cost from the
//    constant bank;
//  * independent min chains: each thread keeps four partial interior
//    minima.  Splitting a cell's chains over 2 or 4 lanes of a warp,
//    combined with __shfl_xor_sync, was built and measured on an H100
//    (PERF.md): it was slower than one lane at B = 100 and 4096 on a
//    100-column target and at B = 100 on a 32-column one, since it adds
//    instructions per cell and the row's fixed latency does not shrink.
//    So the kernel runs one lane per column.
//
// What bounds it after the redesign (PERF.md, from the SASS row loop and
// the clock): at B = 4096 instruction issue, with shared-memory loads
// close behind (about 630 instructions and 157 shared loads per warp and
// row); at B <= 132 a fixed ~0.7 us per row, whatever the target width.
// Fewer of both per cell needs several columns per thread (register
// blocking), left for later.  The row-cost knockouts of this kernel
// (csrc/duplex_rowcost.cu, through the hooks below) attribute that row.
//
// Exactness.  Every value is an f32 add or min of table entries, in the
// plain version's association: interior candidates are
// win_ca[r][j - dj] + interior_cost[r + 1][dj], min-reduced, then + mB;
// bulge candidates are min-reduced, then + AU.  No table holds NaN or -0.0,
// so min is exact in any order and grouping.  There is no multiply, so
// nothing can contract into an FMA; build without --use_fast_math.  The
// sentinel is the finite 1e6 of the energy tables, never inf.  A row with
// a token outside 0..3 scores NaN.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr float kInf = 1e6f;  // the energy model's finite sentinel
constexpr int kNone = 4;      // "no neighbouring base" index of the end tables
constexpr int kStaticMaxloop = 16;
constexpr int kMaxThreads = 1024;
constexpr int kMaxStaticThreads = 512;  // blocks of the compile-time window
constexpr unsigned kFull = 0xffffffffu;

// Channel order of t_past (rna_duplex._PAST) and t_fut (rna_duplex._FUT).
enum { P_OPEN = 0, P_STACK, P_B1S, P_B1T, P_I11, P_MB, P_AU };
enum { F_MA = 0, F_CLOSE };

// Row-cost hooks.  csrc/duplex_rowcost.cu defines some of them before it
// includes this file, to build one knockout of duplex_dp_kernel<16> for
// flexs_tpu_torch/profile_duplex_rowcost.py.  Each expands by default to
// the kernel's own tokens (the empty ones to nothing), so this file's own
// build, the main path's, preprocesses to the same tokens as without them
// (tests/test_torch_rowcost.py pins its digest).  What each is for:
#ifndef DUPLEX_L1  // the number of DP rows (a compile-time 100 in `unrolled`)
#define DUPLEX_L1 a.l1
#endif
#ifndef DUPLEX_ROW_LOOP  // the row loop's pragma (unrolled by 2 in `unrolled`)
#define DUPLEX_ROW_LOOP _Pragma("unroll 1")
#endif
#ifndef DUPLEX_NEXT_ROW  // row i's records (row 0's for every row in `const-rec`)
#define DUPLEX_NEXT_ROW(i) load_row(i)
#endif
#ifndef DUPLEX_ROW_SETUP  // before the row loop: `carry-windows`' registers, `clocked`'s stamps
#define DUPLEX_ROW_SETUP
#endif
#ifndef DUPLEX_STAMP  // `clocked`: clock64() at point k of row i (0 start, 1 interior, 2 bulges, 3 barrier)
#define DUPLEX_STAMP(i, k)
#endif
// The window reads, from the rings at pointer p (from warp shuffles in
// `carry-windows`): c of row i-1-r at column j-k; c + mA of row i-1-r at
// j-dj; c + AU of row i-3-s at j-1 and of row i-1 at j-3-s.
#ifndef DUPLEX_WIN_C
#define DUPLEX_WIN_C(p, r, k) p[-k]
#endif
#ifndef DUPLEX_WIN_CA
#define DUPLEX_WIN_CA(p, r, dj) p[-(dj * pitch + r)]
#endif
#ifndef DUPLEX_WIN_BS
#define DUPLEX_WIN_BS(p, s) p[-s]
#endif
#ifndef DUPLEX_WIN_BT
#define DUPLEX_WIN_BT(p, s) p[-(3 + s) * pitch]
#endif
#ifndef DUPLEX_ADDMIN  // one candidate: min(x, v + e) (one DPX instruction in `dpx`)
#define DUPLEX_ADDMIN(x, v, e) fminf(x, v + e)
#endif
// The partial interior minima: their declaration, the chain of candidate
// m, and their combination (1 or 8 chains in `chains-1`, `chains-8`).
#ifndef DUPLEX_CHAIN_DECL
#define DUPLEX_CHAIN_DECL(lm) float lm[4] = {INFINITY, INFINITY, INFINITY, INFINITY}
#endif
#ifndef DUPLEX_CHAIN
#define DUPLEX_CHAIN(m) m & 3
#endif
#ifndef DUPLEX_CHAIN_MIN
#define DUPLEX_CHAIN_MIN(lm) fminf(fminf(lm[0], lm[1]), fminf(lm[2], lm[3]))
#endif
#ifndef DUPLEX_PUSH  // after row i: `carry-windows` shifts its registers
#define DUPLEX_PUSH(acc, row)
#endif
#ifndef DUPLEX_RING_STORES  // whether a thread stores row i in the rings (never in `carry-windows`)
#define DUPLEX_RING_STORES(active) active
#endif
#ifndef DUPLEX_ROW_BARRIER  // the per-row barrier (none in `no-barrier`, `carry-windows`)
#define DUPLEX_ROW_BARRIER() __syncthreads()
#endif
#ifndef DUPLEX_RESULT  // a block's energy before the store (`dpx` maps a non-finite one to 0)
#define DUPLEX_RESULT(m) m
#endif

// The size costs of a window of M, in the order the plan's host copy holds
// them: interior_cost [d, d], bulge_seq [d - 1], bulge_tgt [d], d = M + 2.
template <int M>
struct Costs {
  float icost[(M + 2) * (M + 2)];
  float bseq[M + 1];
  float btgt[M + 2];
};
static_assert(sizeof(Costs<kStaticMaxloop>) == 1436, "cost struct layout");

struct Args {
  const void* tokens;       // [B, L1] int32 or int64, values 0..3
  const int32_t* t3g;       // [T, L2] target trigram index
  const int32_t* t2g;       // [T, L2] target forward bigram
  const float* open_col0;   // [T, 4, 5] OPEN of column 0 by (s_i, s_i-1 or NONE)
  const float* close_coll;  // [T, 4, 5] CLOSE of column L2-1 by (s_i, s_i+1 or NONE)
  const float* open_row0;   // [T, 4, L2] OPEN of row 0 by (s_0, j)
  const float* close_rowl;  // [T, 4, L2] CLOSE of row L1-1 by (s_L1-1, j)
  const float* t_past;      // [7, 64, 64]
  const float* t_fut;       // [2, 16, 16]
  const float* icost;       // [d, d]   read by the runtime-window build only
  const float* bseq;        // [d - 1]
  const float* btgt;        // [d]
  float* out;               // [B, T]
  int tok64, n_targets, l1, l2, maxloop;
  int pad;   // sentinel columns left of column 0 (the widest shift a thread reads)
  int ncol;  // pad + l2 ring columns
};

// Interior shifts of window row r: dj in [dj_lo(r), maxloop + 1 - r], (1, 2) excluded.
__host__ __device__ constexpr int dj_lo(int r) { return r == 1 ? 3 : 2; }

struct RowE {
  float open, stack, b1s, b1t, i11, mb, au, ma, close;
};

// Shared memory of one block.  The compile-time window keeps c + mA and
// c + AU column-major: column k of a ring at k * (2d + 1), its rows at
// positions 0 .. 2d - 1, each DP row stored twice (at w and w + d, w = row
// mod d), so the d rows before the current one lie at consecutive
// positions and every read of a row is an immediate offset from one base.
// The odd pitch 2d + 1 keeps a warp's 32 columns on 32 banks.  c itself
// (read at rows i-1 and i-2 only) is a ring of 4 rows.  The runtime window
// keeps the first kernel's layout: d rows of `ncol` columns per channel,
// and the costs.
__host__ __device__ inline size_t smem_bytes(int d, int ncol, int l1, bool runtime_window) {
  const size_t rings = runtime_window ? 3 * (size_t)d * ncol + (size_t)d * d + 2 * d - 1
                                      : 2 * (size_t)ncol * (2 * d + 1) + 4 * (size_t)ncol;
  return (rings + 32) * sizeof(float) + (size_t)l1;  // + per-warp minima, staged tokens
}

template <int M>
__global__ void __launch_bounds__(M > 0 ? kMaxStaticThreads : kMaxThreads)
duplex_dp_kernel(const __grid_constant__ Args a, const __grid_constant__ Costs<M> costs) {
  constexpr bool kStatic = M > 0;
  const int maxloop = kStatic ? M : a.maxloop;
  const int d = maxloop + 2;
  const int pitch = 2 * d + 1;  // column pitch of the compile-time window's rings
  const int l1 = DUPLEX_L1, l2 = a.l2, ncol = a.ncol;
  extern __shared__ float smem[];
  // Compile-time window: ca, cw column-major [ncol][pitch], c [4][ncol].
  // Runtime window: c, ca, cw [d][ncol] each, then the size costs.
  float* win_ca = smem;
  float* win_cw = win_ca + (kStatic ? ncol * pitch : d * ncol);
  float* win_c = win_cw + (kStatic ? ncol * pitch : d * ncol);
  float* s_icost = win_c + (kStatic ? 4 * ncol : d * ncol);
  float* s_bseq = s_icost + d * d;
  float* s_btgt = s_bseq + (d - 1);
  float* warp_min = kStatic ? s_icost : s_btgt + d;
  unsigned char* seq = reinterpret_cast<unsigned char*>(warp_min + 32);
  const int n_ring = kStatic ? 2 * ncol * pitch + 4 * ncol : 3 * d * ncol;

  const int bt = blockIdx.x;  // b * T + t
  const int b = bt / a.n_targets;
  const int t = bt % a.n_targets;
  const int tid = threadIdx.x;
  const bool active = tid < l2;
  // Threads past the last column compute column L2 - 1 again and write
  // nothing (the final warp reduction needs the whole warp).
  const int jc = active ? tid : l2 - 1;

  // Stage the sequence and fill the rings with the sentinel.
  bool bad = false;
  for (int k = tid; k < l1; k += blockDim.x) {
    const size_t at = (size_t)b * l1 + k;
    const long long v = a.tok64 ? static_cast<const int64_t*>(a.tokens)[at]
                                : static_cast<const int32_t*>(a.tokens)[at];
    bad |= v < 0 || v > 3;
    seq[k] = (unsigned char)(v & 3);
  }
  for (int k = tid; k < n_ring; k += blockDim.x) smem[k] = kInf;
  if constexpr (!kStatic) {
    for (int k = tid; k < d * d; k += blockDim.x) s_icost[k] = a.icost[k];
    for (int k = tid; k < d - 1; k += blockDim.x) s_bseq[k] = a.bseq[k];
    for (int k = tid; k < d; k += blockDim.x) s_btgt[k] = a.btgt[k];
  }
  const int any_bad = __syncthreads_or(bad);

  const int t3 = __ldg(a.t3g + t * l2 + jc);
  const int t2 = __ldg(a.t2g + t * l2 + jc);
  const float row0_e = __ldg(a.open_row0 + ((size_t)t * 4 + seq[0]) * l2 + jc);
  const float rowl_e = __ldg(a.close_rowl + ((size_t)t * 4 + seq[l1 - 1]) * l2 + jc);
  const float* col0_t = a.open_col0 + t * 20;
  const float* coll_t = a.close_coll + t * 20;
  const float* tpj = a.t_past + t3;
  const float* tfj = a.t_fut + t2;

  // Row i's table energies: gram indices from the staged tokens (clipped
  // neighbours), duplex-end patches column first, then row.
  auto load_row = [&](int i) {
    const int si = seq[i];
    const int sm1 = seq[i > 0 ? i - 1 : 0];
    const int sm2 = seq[i > 1 ? i - 2 : 0];
    const int sp1 = seq[i < l1 - 1 ? i + 1 : l1 - 1];
    const float* tp = tpj + (sm2 * 16 + sm1 * 4 + si) * 64;
    const float* tf = tfj + (si * 4 + sp1) * 16;
    RowE e;
    if (jc == 0) e.open = __ldg(col0_t + si * 5 + (i > 0 ? sm1 : kNone));
    else if (i == 0) e.open = row0_e;
    else e.open = __ldg(tp + P_OPEN * 4096);
    if (jc == l2 - 1) e.close = __ldg(coll_t + si * 5 + (i < l1 - 1 ? sp1 : kNone));
    else if (i == l1 - 1) e.close = rowl_e;
    else e.close = __ldg(tf + F_CLOSE * 256);
    e.stack = __ldg(tp + P_STACK * 4096);
    e.b1s = __ldg(tp + P_B1S * 4096);
    e.b1t = __ldg(tp + P_B1T * 4096);
    e.i11 = __ldg(tp + P_I11 * 4096);
    e.mb = __ldg(tp + P_MB * 4096);
    e.au = __ldg(tp + P_AU * 4096);
    e.ma = __ldg(tf + F_MA * 256);
    return e;
  };

  const int col = a.pad + jc;  // this column's index in the rings
  float best = kInf;
  int slot0 = d - 1;  // ring row of DP row i - 1 (rows before 0 hold the sentinel)
  RowE cur = load_row(0);
  DUPLEX_ROW_SETUP
  DUPLEX_ROW_LOOP
  for (int i = 0; i < l1; ++i) {
    DUPLEX_STAMP(i, 0)
    RowE nxt = cur;
    if (i + 1 < l1) nxt = DUPLEX_NEXT_ROW(i + 1);
    const int slot1 = slot0 == 0 ? d - 1 : slot0 - 1;
    const float* c0 = win_c + (kStatic ? ((i - 1) & 3) : slot0) * ncol + col;
    const float* c1 = win_c + (kStatic ? ((i - 2) & 3) : slot1) * ncol + col;
    float acc = DUPLEX_ADDMIN(cur.open, DUPLEX_WIN_C(c0, 0, 1), cur.stack);
    acc = DUPLEX_ADDMIN(acc, DUPLEX_WIN_C(c1, 1, 1), cur.b1s);
    acc = DUPLEX_ADDMIN(acc, DUPLEX_WIN_C(c0, 0, 2), cur.b1t);
    acc = DUPLEX_ADDMIN(acc, DUPLEX_WIN_C(c1, 1, 2), cur.i11);

    float loop_min, bulge_min;
    if constexpr (kStatic) {
      // Row i-1-r of column k sits at k * pitch + slot0 + d - r.
      const int top = slot0 + d;
      // Interior loops: window row r shifted by dj, in four partial minima.
      const float* wq = win_ca + col * pitch + top;
      DUPLEX_CHAIN_DECL(lm);
      int m = 0;
#pragma unroll
      for (int r = 1; r <= M; ++r) {
#pragma unroll
        for (int dj = dj_lo(r); dj <= M + 1 - r; ++dj, ++m) {
          const float cost = costs.icost[(r + 1) * (M + 2) + dj];
          lm[DUPLEX_CHAIN(m)] =
              DUPLEX_ADDMIN(lm[DUPLEX_CHAIN(m)], DUPLEX_WIN_CA(wq, r, dj), cost);
        }
      }
      loop_min = DUPLEX_CHAIN_MIN(lm);
      DUPLEX_STAMP(i, 1)

      // Bulges of >= 2 unpaired bases: on the sequence side window row
      // r = 2 + s at shift 1, on the target side row i-1 at shift dj = 3 + s.
      const float* ws = win_cw + (col - 1) * pitch + top - 2;
      const float* wt = win_cw + col * pitch + top;
      float bs = INFINITY, bg = INFINITY;
#pragma unroll
      for (int s = 0; s < M - 1; ++s) {
        bs = DUPLEX_ADDMIN(bs, DUPLEX_WIN_BS(ws, s), costs.bseq[2 + s]);
        bg = DUPLEX_ADDMIN(bg, DUPLEX_WIN_BT(wt, s), costs.btgt[3 + s]);
      }
      bulge_min = fminf(bs, bg);
      DUPLEX_STAMP(i, 2)
    } else {
      loop_min = INFINITY;
      int slot = slot1;
      for (int r = 1; r <= maxloop; ++r) {
        const float* w = win_ca + slot * ncol + col;
        const float* cost = s_icost + (r + 1) * d;
        for (int dj = dj_lo(r); dj <= maxloop + 1 - r; ++dj) {
          loop_min = fminf(loop_min, w[-dj] + cost[dj]);
        }
        slot = slot == 0 ? d - 1 : slot - 1;
      }
      bulge_min = INFINITY;
      slot = slot1 == 0 ? d - 1 : slot1 - 1;  // r = 2
      for (int r = 2; r <= maxloop; ++r) {
        bulge_min = fminf(bulge_min, win_cw[slot * ncol + col - 1] + s_bseq[r]);
        slot = slot == 0 ? d - 1 : slot - 1;
      }
      const float* w0 = win_cw + slot0 * ncol + col;
      for (int dj = 3; dj <= maxloop + 1; ++dj) {
        bulge_min = fminf(bulge_min, w0[-dj] + s_btgt[dj]);
      }
    }

    acc = DUPLEX_ADDMIN(acc, loop_min, cur.mb);
    acc = DUPLEX_ADDMIN(acc, bulge_min, cur.au);

    // Unpairable cells admit no path at all.
    if (cur.open >= kInf / 2) acc = kInf;
    if (active) best = fminf(best, acc + cur.close);

    const int wslot = slot0 + 1 == d ? 0 : slot0 + 1;  // the ring row of row i - d
    DUPLEX_PUSH(acc, cur)
    if (DUPLEX_RING_STORES(active)) {
      const float ca = acc + cur.ma, cw = acc + cur.au;
      if constexpr (kStatic) {
        win_c[(i & 3) * ncol + col] = acc;
        float* pa = win_ca + col * pitch + wslot;
        float* pw = win_cw + col * pitch + wslot;
        pa[0] = ca;
        pa[d] = ca;
        pw[0] = cw;
        pw[d] = cw;
      } else {
        const int dst = wslot * ncol + col;
        win_c[dst] = acc;
        win_ca[dst] = ca;
        win_cw[dst] = cw;
      }
    }
    slot0 = wslot;
    cur = nxt;
    DUPLEX_ROW_BARRIER();
    DUPLEX_STAMP(i, 3)
  }

  for (int off = 16; off > 0; off >>= 1) {
    best = fminf(best, __shfl_down_sync(kFull, best, off));
  }
  if ((tid & 31) == 0) warp_min[tid >> 5] = best;
  __syncthreads();
  if (tid == 0) {
    float m = warp_min[0];
    for (int w = 1; w < (int)(blockDim.x >> 5); ++w) m = fminf(m, warp_min[w]);
    // No pairable positions at all => energy 0 (no duplex forms).
    a.out[bt] = any_bad ? NAN : (m >= kInf / 2 ? 0.0f : DUPLEX_RESULT(m));
  }
}

int threads_for(int l2) { return ((l2 + 31) / 32) * 32; }

// The compile-time window runs blocks of at most 512 threads (so it may
// hold up to 128 registers a thread); wider targets take the runtime one.
bool static_window(int l2, int maxloop) {
  return maxloop == kStaticMaxloop && threads_for(l2) <= kMaxStaticThreads;
}

template <int M>
int launch_one(Args a, const float* host_costs, int blocks, cudaStream_t stream) {
  Costs<M> costs;
  if constexpr (M > 0) {
    memcpy(&costs, host_costs, sizeof(costs));
  } else {
    memset(&costs, 0, sizeof(costs));
  }
  const int d = a.maxloop + 2;
  const int threads = threads_for(a.l2);
  a.pad = d;  // the widest shift a thread reads is maxloop + 1
  a.ncol = a.pad + a.l2;
  const size_t smem = smem_bytes(d, a.ncol, a.l1, M == 0);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        duplex_dp_kernel<M>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  duplex_dp_kernel<M><<<blocks, threads, smem, stream>>>(a, costs);
  return (int)cudaGetLastError();
}

}  // namespace

// Launches the DP on `stream` and returns cudaGetLastError() (0 = launched).
// `host_costs` points to the plan's host copy of the size costs
// (interior_cost, bulge_seq, bulge_tgt; d*d + 2d - 1 floats), read here for
// the compile-time window.  Refuses, before launching anything and with
// cudaErrorInvalidValue: maxloop < 3, L1 < 1, L2 outside 1..1024 or a
// negative batch.  Dtypes, devices and
// the plan's shapes are the Python wrapper's to check.
extern "C" int duplex_dp_launch(
    const void* tokens, const int32_t* t3g, const int32_t* t2g,
    const float* open_col0, const float* close_coll, const float* open_row0,
    const float* close_rowl, const float* t_past, const float* t_fut,
    const float* interior_cost, const float* bulge_seq, const float* bulge_tgt,
    const float* host_costs, float* out, int tok64, int n_seqs, int n_targets,
    int l1, int l2, int maxloop, void* stream) {
  if (maxloop < 3 || l1 < 1 || l2 < 1 || l2 > kMaxThreads || n_seqs < 0 || n_targets < 1) {
    return (int)cudaErrorInvalidValue;
  }
  const long long blocks = (long long)n_seqs * n_targets;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  if (blocks == 0) return (int)cudaSuccess;
  const Args a = {tokens, t3g, t2g, open_col0, close_coll, open_row0, close_rowl,
                  t_past, t_fut, interior_cost, bulge_seq, bulge_tgt, out,
                  tok64, n_targets, l1, l2, maxloop, 0, 0};
  const cudaStream_t s = (cudaStream_t)stream;
  if (!static_window(l2, maxloop)) return launch_one<0>(a, host_costs, (int)blocks, s);
  return launch_one<kStaticMaxloop>(a, host_costs, (int)blocks, s);
}
