// Row-cost knockout builds of duplex_dp_kernel<16> (sm_90a).
//
// Counterpart of scripts/profile_duplex_rowcost.py::run_variant +
// make_kernel: flexs_tpu_torch/profile_duplex_rowcost.py times these builds
// to find what a DP row of the main path's kernel costs.  No main path loads
// any of them.  The redesigned kernel runs its L1 rows in series, each row
// ending in a barrier, so its time is L1 times a per-row cost; each build
// here takes one suspected part of that cost away, or changes it.
//
// How.  This file defines some of the hooks of csrc/duplex_dp.cu (each
// listed there; by default each expands to the kernel's own tokens) and
// then includes that file, so every build is the main kernel with one
// change.  The build `baseline` is not made here: it is the main path's
// library itself.  DUPLEX_KNOCKOUT selects one build:
//   1 const-rec      no per-row record loads: every row uses row 0's
//                    gram-index and table energies (wrong, timing only);
//   2 unrolled       L1 a compile-time constant (-DDUPLEX_STATIC_L1) and
//                    the row loop unrolled by 2, so loop control and the
//                    ring-slot updates are spread over two rows (exact);
//   3 carry-windows  each column's last rows of the three channels in
//                    registers, column j - k read from lane - k with
//                    __shfl_up_sync: no rings, no per-row barrier; wrong
//                    across warp boundaries by design (timing only);
//   4 no-barrier     only the per-row __syncthreads() removed, the rings
//                    kept: warps race (timing only);
//   5 chains-1       one interior min chain instead of four (exact: min is
//                    exact in any grouping);
//   6 chains-8       eight interior min chains (exact);
//   7 dpx            each candidate's add and min as one Hopper DPX
//                    instruction, __viaddmin_s32, on the f32 bit patterns
//                    read as int32: what integer energies would buy (wrong,
//                    timing only; a non-finite energy is stored as 0);
//   8 clocked        the main kernel plus clock64() at four points of every
//                    row (row start, after the direct and interior
//                    candidates, after the bulges, after the barrier), stored
//                    by lane 0 of each warp of the first and the last block
//                    into int64[2, warps, L1, 4], and (clock64, globaltimer)
//                    of block 0's warp 0 before the first row and after the
//                    last into int64[2, 2]; pointed at by
//                    duplex_rowcost_set_stamps (exact energies).
// Every build takes only the compile-time window (maxloop 16, L2 <= 512)
// and `unrolled` only its L1: duplex_rowcost_launch refuses anything else.

#include <cuda_runtime.h>
#include <stdint.h>

#ifndef DUPLEX_KNOCKOUT
#error "define DUPLEX_KNOCKOUT (1-8); the baseline is csrc/duplex_dp.cu itself"
#endif
#if DUPLEX_KNOCKOUT < 1 || DUPLEX_KNOCKOUT > 8
#error "DUPLEX_KNOCKOUT must be 1-8"
#endif
#if DUPLEX_KNOCKOUT == 2 && !defined(DUPLEX_STATIC_L1)
#error "the unrolled build needs -DDUPLEX_STATIC_L1"
#endif

#if DUPLEX_KNOCKOUT == 1  // const-rec
#define DUPLEX_NEXT_ROW(i) cur
#endif

#if DUPLEX_KNOCKOUT == 2  // unrolled
#define DUPLEX_L1 DUPLEX_STATIC_L1
#define DUPLEX_ROW_LOOP _Pragma("unroll 2")
#endif

#if DUPLEX_KNOCKOUT == 3  // carry-windows
// rc[r]: c of row i-1-r (r < 2); rca[r], rcw[r]: c + mA, c + AU of row
// i-1-r (r <= M).  left(v, k) is lane - k's v, or the sentinel below lane k.
#define DUPLEX_ROW_SETUP                                                  \
  float rc[2] = {kInf, kInf}, rca[M + 1], rcw[M + 1];                     \
  _Pragma("unroll") for (int r = 0; r <= M; ++r) rca[r] = rcw[r] = kInf;  \
  const int lane = tid & 31;                                              \
  auto left = [lane](float v, int k) {                                    \
    const float u = __shfl_up_sync(kFull, v, k);                          \
    return lane >= k ? u : kInf;                                          \
  };
#define DUPLEX_WIN_C(p, r, k) left(rc[r], k)
#define DUPLEX_WIN_CA(p, r, dj) left(rca[r], dj)
#define DUPLEX_WIN_BS(p, s) left(rcw[2 + s], 1)
#define DUPLEX_WIN_BT(p, s) left(rcw[0], 3 + s)
#define DUPLEX_PUSH(acc, row)                \
  _Pragma("unroll") for (int r = M; r > 0; --r) { \
    rca[r] = rca[r - 1];                     \
    rcw[r] = rcw[r - 1];                     \
  }                                          \
  rc[1] = rc[0];                             \
  rc[0] = acc;                               \
  rca[0] = acc + row.ma;                     \
  rcw[0] = acc + row.au;
#define DUPLEX_RING_STORES(active) false
#define DUPLEX_ROW_BARRIER() (void)0
#endif

#if DUPLEX_KNOCKOUT == 4  // no-barrier
#define DUPLEX_ROW_BARRIER() (void)0
#endif

#if DUPLEX_KNOCKOUT == 5  // chains-1
#define DUPLEX_CHAIN_DECL(lm) float lm[1] = {INFINITY}
#define DUPLEX_CHAIN(m) 0
#define DUPLEX_CHAIN_MIN(lm) lm[0]
#endif

#if DUPLEX_KNOCKOUT == 6  // chains-8
#define DUPLEX_CHAIN_DECL(lm) \
  float lm[8] = {INFINITY, INFINITY, INFINITY, INFINITY, INFINITY, INFINITY, INFINITY, INFINITY}
#define DUPLEX_CHAIN(m) m & 7
#define DUPLEX_CHAIN_MIN(lm)                                  \
  fminf(fminf(fminf(lm[0], lm[1]), fminf(lm[2], lm[3])),      \
        fminf(fminf(lm[4], lm[5]), fminf(lm[6], lm[7])))
#endif

#if DUPLEX_KNOCKOUT == 7  // dpx
#define DUPLEX_ADDMIN(x, v, e) \
  __int_as_float(__viaddmin_s32(__float_as_int(v), __float_as_int(e), __float_as_int(x)))
#define DUPLEX_RESULT(m) (isfinite(m) ? m : 0.0f)
#endif

#if DUPLEX_KNOCKOUT == 8  // clocked
static __device__ long long* g_stamps;  // int64[2, warps, L1, 4], or null: no stamps
static __device__ long long* g_timer;   // int64[2, 2], or null

__device__ __forceinline__ long long globaltimer_ns() {
  long long ns;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(ns));
  return ns;
}

// Where lane 0 of this warp stores its rows' stamps, or null for every
// other thread.  Block 0's warp 0 also starts the timer.
__device__ __forceinline__ long long* stamp_rows(int l1) {
  long long* const s = g_stamps;
  const int last = gridDim.x > 1 && blockIdx.x == gridDim.x - 1;
  if (s == nullptr || (threadIdx.x & 31) != 0 || (blockIdx.x != 0 && !last)) return nullptr;
  long long* const at = s + ((size_t)last * (blockDim.x >> 5) + (threadIdx.x >> 5)) * l1 * 4;
  long long* const timer = g_timer;
  if (at == s && timer != nullptr) {
    timer[0] = clock64();
    timer[1] = globaltimer_ns();
  }
  return at;
}

// After the barrier of row i: store the row's four stamps (and, after
// the last row of block 0's warp 0, stop the timer).
__device__ __forceinline__ void store_stamps(long long* at, int i, const long long* clk, int l1) {
#pragma unroll
  for (int k = 0; k < 4; ++k) at[i * 4 + k] = clk[k];
  long long* const timer = g_timer;
  if (i == l1 - 1 && at == g_stamps && timer != nullptr) {
    timer[2] = clk[3];
    timer[3] = globaltimer_ns();
  }
}
// Every thread reads the clock at the four points, into registers, with
// no branch inside the row (a branch would end the blocks ptxas schedules
// loads across); only after the barrier does lane 0 store them.
#define DUPLEX_ROW_SETUP \
  long long* const stamp_at = stamp_rows(l1); \
  long long row_clock[4];
#define DUPLEX_STAMP(i, k)  \
  row_clock[k] = clock64(); \
  if (k == 3 && stamp_at != nullptr) store_stamps(stamp_at, i, row_clock, l1);
#endif

#include "duplex_dp.cu"

// Launches this build on `stream` with duplex_dp_launch's arguments and
// returns cudaGetLastError() (0 = launched).  Refuses, with
// cudaErrorInvalidValue and before launching anything, a shape outside
// the compile-time window (maxloop 16, L2 <= 512) or, for `unrolled`, an
// L1 other than its own.
extern "C" int duplex_rowcost_launch(
    const void* tokens, const int32_t* t3g, const int32_t* t2g,
    const float* open_col0, const float* close_coll, const float* open_row0,
    const float* close_rowl, const float* t_past, const float* t_fut,
    const float* interior_cost, const float* bulge_seq, const float* bulge_tgt,
    const float* host_costs, float* out, int tok64, int n_seqs, int n_targets,
    int l1, int l2, int maxloop, void* stream) {
  if (l2 < 1 || !static_window(l2, maxloop)) return (int)cudaErrorInvalidValue;
#ifdef DUPLEX_STATIC_L1
  if (l1 != DUPLEX_STATIC_L1) return (int)cudaErrorInvalidValue;
#endif
  return duplex_dp_launch(tokens, t3g, t2g, open_col0, close_coll, open_row0, close_rowl,
                          t_past, t_fut, interior_cost, bulge_seq, bulge_tgt, host_costs,
                          out, tok64, n_seqs, n_targets, l1, l2, maxloop, stream);
}

// This library's DUPLEX_KNOCKOUT, so a caller can check what it loaded.
extern "C" int duplex_rowcost_knockout() { return DUPLEX_KNOCKOUT; }

#if DUPLEX_KNOCKOUT == 8
// Points the clocked kernel's stamps at `stamps` and `timer` (device
// int64[2, warps, L1, 4] and int64[2, 2]; null turns stamping off) before
// the next launch.  Synchronous.  Returns the CUDA error (0 = set).
extern "C" int duplex_rowcost_set_stamps(long long* stamps, long long* timer) {
  cudaError_t err = cudaMemcpyToSymbol(g_stamps, &stamps, sizeof(stamps));
  if (err == cudaSuccess) err = cudaMemcpyToSymbol(g_timer, &timer, sizeof(timer));
  return (int)err;
}
#endif
