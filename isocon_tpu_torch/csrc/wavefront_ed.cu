// K5: banded unit-cost edit distance as an anti-diagonal wavefront over a
// sequence pool, NW (global) and HW (infix), returning (ed, end_j).
//
// Replaces the Pallas TPU kernel isocon_tpu/ops/wavefront_pallas.py::_kernel,
// reached through banded_ed_pallas and wavefront.py::banded_ed_pool, and, for
// bands wider than that kernel's fixed 128 lanes, the lax.scan banded_ed of
// isocon_tpu/ops/wavefront.py.  Same recurrence, boundary rules, ceilings
// and answer extraction (see isocon_tpu_torch/ops/wavefront.py, whose
// banded_ed_plain is the plain version this kernel is held to on every
// entry, certified or not).
//
// What bounds it on the H100: integer operations.  The function needs 4
// 32-bit operations per DP cell over (n + m - 1) * Wp/2 cells with the
// card's DPX min-plus instructions (min of three, add-min; see the cell
// below), plus the pad test of the one code entering each diagonal, while
// it reads n + m code bytes and writes 8 bytes, so the bound is
// ops / (132 SMs x 64 int32 lanes x clock), far above bytes / 3.35 TB/s.  Each pair is a chain of n + m - 1 dependent
// diagonals, so the card is kept full by running many pairs at once.
//
// Geometry shared by both kernels.  Only lanes with o = d (mod 2) are DP
// cells; the other lanes of the JAX versions stay at the ceiling for ever
// and are not stored.  A diagonal's H = Wp/2 cells are compacted into
// slots, one layout for even and one for odd diagonals:
//   even d: slot k holds o = 2k - H + 2,   odd d: slot k holds o = 2k - H + 1
// (o_lo = -(H - 1) is the odd layout's slot 0).  A cell's diagonal d-2 sits
// in its own slot, and its neighbours on diagonal d-1 are
//   even d: slots k (o-1) and k+1 (o+1),   odd d: slots k-1 (o-1) and k (o+1)
// where a slot outside 0 .. H-1 reads the ceiling.
//
// The register kernel (Wp = 128, 256, 512, 1024; the bands the engine
// climbs through on real data).  One warp per pair, four warps a block, a
// persistent grid whose warps take the next pair from an atomic counter
// when they finish one, so a short pair does not hold a long one back.
// Lane l holds C = H/32 consecutive slots l*C .. l*C + C-1 of the even and
// of the odd diagonal in registers; the one neighbour in the next (even d)
// or previous (odd d) lane comes with one shuffle per diagonal.  No barrier
// and no shared memory.
//   Codes shift in; they are not fetched per cell.  From even d to odd d+1
//   slot k's q code is slot k-1's and its t code stays; from odd d+1 to
//   even d+2 its q code stays and its t code is slot k+1's.  So each
//   diagonal moves one code stream one slot (one shuffle), and one code
//   enters at the band's edge: t[c] at slot H-1 on even d and q[c] at slot
//   0 on odd d + 1, with c = d/2 + H/2 - 1 for both.  Lane r of the warp
//   holds codes c = 32w + r of a window w of each sequence, and the next
//   window is loaded one window (64 diagonals) ahead; the entering code is
//   one shuffle from it.  Past a length a code enters as its pad (QPAD /
//   TPAD) when its window is loaded, so no cell tests a length.
//   No per-cell boundary test either.  With every value capped at the
//   ceiling and the cells outside the grid at the ceiling, the recurrence
//   itself gives column 0 (d), NW's row 0 (d) and the ceiling outside the
//   grid; only HW's row 0 (0) is set by hand, on the diagonals d <= H where
//   row 0 lies in the band.  Row n is read only on the diagonals
//   2n + o_lo .. 2n + H where it lies in the band, one shuffle each, and an
//   HW pair stops after the last of them: no later cell can change its
//   answer.  A cell is min(min(up, down) + 1, diag + (qc != tc)) capped at
//   the ceiling, two of the min-plus steps fused in Hopper's DPX
//   instruction (__viaddmin_s32: min(a + b, c)).
//
// The wide kernel (any other Wp): one block per pair, the Wp/2 cells of a
// diagonal strided over the block's threads (up to 1024), the two
// diagonals in shared memory up to Wp = 32768 (4 * Wp bytes; the block
// opts into up to 128 KB) and in a device-memory scratch row of the block
// beyond that, where the grid is capped and each block loops over its
// pairs; one barrier a diagonal, codes straight from the pool rows, every
// boundary rule tested in every cell.  No workload climbs past Wp 256;
// the checks and the saturated-value test (Wp 16,384) do.
//
// Both stop a pair at its own n + m (HW: earlier, as above).  None of the
// TPU kernel's doubled and reversed code planes, sliding windows, 128-pair
// blocks or [B, 128] scalar planes is carried over.
#include "isocon_cuda.h"

namespace {

constexpr int kQPad = 5;
constexpr int kTPad = 6;
constexpr int kSharedMaxWp = 32768;
constexpr int kWarp = 32;
constexpr int kWarpsPerBlock = 4;
constexpr unsigned kFull = 0xffffffffu;

// ---------------------------------------------------------------------------
// register kernel: one warp per pair
// ---------------------------------------------------------------------------
template <int C>
struct Lanes {
  int ev[C];          // even diagonal, slots lane*C + s
  int od[C];          // odd diagonal
  int qc[C];          // q code of each slot on the last diagonal
  int tc[C];          // t code of each slot
  int qwin, qnext;    // q codes 32w + lane of the current window, and next
  int twin, tnext;
  int res, endj;      // HW answer so far (the same in every lane)
};

struct Pair {
  const uint8_t* q;
  const uint8_t* t;
  int n, m;
  int rs, re;         // HW: the diagonals on which row n lies in the band
};

__device__ __forceinline__ int q_code(const Pair& p, int i) {
  return i < p.n ? static_cast<int>(p.q[i]) : kQPad;
}

__device__ __forceinline__ int t_code(const Pair& p, int j) {
  return j < p.m ? static_cast<int>(p.t[j]) : kTPad;
}

// min(min(up, down) + 1, diag + (qc != tc), ceil_val) for diag <= ceil_val:
// with a = min(up, down, diag) it is min(a + 1, diag) where the codes
// match and min(a + 1, ceil_val) where they do not.  Two DPX instructions:
// min of three and add-min (min(a + b, c)).
__device__ __forceinline__ int cell(int up, int down, int diag, int qc,
                                    int tc, int ceil_val) {
  return __viaddmin_s32(__vimin3_s32(up, down, diag), 1,
                        qc == tc ? diag : ceil_val);
}

// Slot k's value (a runtime slot, the same in every lane), in every lane.
template <int C>
__device__ __forceinline__ int slot_value(const int (&X)[C], int k) {
  int mine = X[0];
#pragma unroll
  for (int s = 1; s < C; ++s) mine = pick((k & (C - 1)) == s, X[s], mine);
  return __shfl_sync(kFull, mine, k / C);
}

// The cell (n, d - n) of the diagonal just computed, into the strict
// running minimum; X is that diagonal's slots.
template <int C>
__device__ __forceinline__ void read_row_n(Lanes<C>& S, const int (&X)[C],
                                           const Pair& p, int d, int H) {
  if (d < p.rs || d > p.re) return;
  const int v = slot_value<C>(X, (d - 2 * p.n + H - 1) >> 1);
  if (v < S.res) {
    S.res = v;
    S.endj = d - p.n;
  }
}

// Diagonal d, given the code that enters on it (t[c] on even d, q[c] on
// odd d).  ROW0: set HW's row 0 (o = d; it lies in the band for d <= H).
template <int C, bool EVEN, bool ROW0>
__device__ __forceinline__ void advance(Lanes<C>& S, int fresh, int d,
                                        int lane, int ceil_val) {
  constexpr int H = kWarp * C;
  if (EVEN) {
    // t codes move down one slot; the fresh one enters at slot H-1
    const int in = __shfl_down_sync(kFull, S.tc[0], 1);
#pragma unroll
    for (int s = 0; s + 1 < C; ++s) S.tc[s] = S.tc[s + 1];
    S.tc[C - 1] = lane == kWarp - 1 ? fresh : in;
    // slot k needs odd slots k and k+1; k+1 = H is outside the band
    int up_last = __shfl_down_sync(kFull, S.od[0], 1);
    up_last = lane == kWarp - 1 ? ceil_val : up_last;
#pragma unroll
    for (int s = 0; s < C; ++s) {
      const int up = s + 1 < C ? S.od[s + 1] : up_last;
      int v = cell(up, S.od[s], S.ev[s], S.qc[s], S.tc[s], ceil_val);
      if (ROW0 && 2 * (lane * C + s) - H + 2 == d) v = 0;
      S.ev[s] = v;
    }
  } else {
    // q codes move up one slot; the fresh one enters at slot 0
    const int in = __shfl_up_sync(kFull, S.qc[C - 1], 1);
#pragma unroll
    for (int s = C - 1; s > 0; --s) S.qc[s] = S.qc[s - 1];
    S.qc[0] = lane == 0 ? fresh : in;
    // slot k needs even slots k-1 and k; k-1 = -1 is outside the band
    int down_first = __shfl_up_sync(kFull, S.ev[C - 1], 1);
    down_first = lane == 0 ? ceil_val : down_first;
#pragma unroll
    for (int s = 0; s < C; ++s) {
      const int down = s > 0 ? S.ev[s - 1] : down_first;
      int v = cell(S.ev[s], down, S.od[s], S.qc[s], S.tc[s], ceil_val);
      if (ROW0 && 2 * (lane * C + s) - H + 1 == d) v = 0;
      S.od[s] = v;
    }
  }
}

// The code windows after code c, the last of its window in both streams:
// move on, and load the window after the next one.
template <int C>
__device__ __forceinline__ void next_window(Lanes<C>& S, const Pair& p,
                                            int c, int lane) {
  const int w = ((c >> 5) + 2) * kWarp + lane;
  S.qwin = S.qnext;
  S.twin = S.tnext;
  S.qnext = q_code(p, w);
  S.tnext = t_code(p, w);
}

// Diagonal d, anywhere.  ROWN: test whether row n lies in the band and read
// it.
template <int C, bool EVEN, bool ROW0, bool ROWN>
__device__ __forceinline__ void step(Lanes<C>& S, const Pair& p, int d,
                                     int lane, int ceil_val) {
  constexpr int H = kWarp * C;
  const int c = (d >> 1) + H / 2 - 1;       // index of the entering code
  const int fresh = __shfl_sync(kFull, EVEN ? S.twin : S.qwin,
                                c & (kWarp - 1));
  advance<C, EVEN, ROW0>(S, fresh, d, lane, ceil_val);
  if (ROWN) {
    if (EVEN)
      read_row_n<C>(S, S.ev, p, d, H);
    else
      read_row_n<C>(S, S.od, p, d, H);
  }
  if (!EVEN && (c & (kWarp - 1)) == kWarp - 1) next_window<C>(S, p, c, lane);
}

// The 64 diagonals d .. d + 63 from an even d whose entering code c starts
// a window: the code windows need no index arithmetic and no test.
template <int C>
__device__ __forceinline__ void window(Lanes<C>& S, const Pair& p, int d,
                                       int lane, int ceil_val) {
  constexpr int U = C <= 2 ? 8 : (C <= 4 ? 4 : 2);  // (even, odd) unrolled
#pragma unroll 1
  for (int j0 = 0; j0 < kWarp; j0 += U) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      advance<C, true, false>(S, __shfl_sync(kFull, S.twin, j0 + u), 0, lane,
                              ceil_val);
      advance<C, false, false>(S, __shfl_sync(kFull, S.qwin, j0 + u), 0,
                               lane, ceil_val);
    }
  }
  next_window<C>(S, p, (d >> 1) + kWarp * C / 2 - 1 + kWarp - 1, lane);
}

// Diagonals d .. last, in (even, odd) steps; without row 0 or row n, in
// whole windows where it can.
template <int C, bool ROW0, bool ROWN>
__device__ __forceinline__ void run(Lanes<C>& S, const Pair& p, int& d,
                                    int last, int lane, int ceil_val) {
  constexpr int H = kWarp * C;
  if (d > last) return;
  if (d & 1) {
    step<C, false, ROW0, ROWN>(S, p, d, lane, ceil_val);
    ++d;
  }
  if (!ROW0 && !ROWN) {
#pragma unroll 1
    for (; d < last && (((d >> 1) + H / 2 - 1) & (kWarp - 1)) != 0; d += 2) {
      step<C, true, false, false>(S, p, d, lane, ceil_val);
      step<C, false, false, false>(S, p, d + 1, lane, ceil_val);
    }
#pragma unroll 1
    for (; d + 2 * kWarp - 1 <= last; d += 2 * kWarp)
      window<C>(S, p, d, lane, ceil_val);
  }
#pragma unroll 1
  for (; d < last; d += 2) {
    step<C, true, ROW0, ROWN>(S, p, d, lane, ceil_val);
    step<C, false, ROW0, ROWN>(S, p, d + 1, lane, ceil_val);
  }
  if (d == last) {
    step<C, true, ROW0, ROWN>(S, p, d, lane, ceil_val);
    ++d;
  }
}

template <int C, bool HW>
__global__ void __launch_bounds__(kWarpsPerBlock * kWarp)
wavefront_warp_kernel(const uint8_t* __restrict__ pool,
                      const int* __restrict__ qrow,
                      const int* __restrict__ trow,
                      const int* __restrict__ nlen,
                      const int* __restrict__ mlen, int* __restrict__ out_ed,
                      int* __restrict__ out_ej, int* next_pair, int B, int Lp,
                      int ceil_val, int unset) {
  constexpr int H = kWarp * C;
  constexpr int Wp = 2 * H;
  constexpr int o_lo = 1 - H;
  const int lane = threadIdx.x & (kWarp - 1);
  const int first_taken = gridDim.x * kWarpsPerBlock;
  int b = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);

  while (b < B) {
    Pair p;
    p.n = nlen[b];
    p.m = mlen[b];
    p.q = pool + static_cast<size_t>(qrow[b]) * Lp;
    p.t = pool + static_cast<size_t>(trow[b]) * Lp;
    const int dfin = p.n + p.m;
    Lanes<C> S;
    // diagonal 0: (0, 0) = 0; diagonal 1: (0, 1) = 1 (0 in HW), (1, 0) = 1;
    // the codes of diagonal 1's slots: (i, j) = (H/2 - k, k - H/2 + 1)
#pragma unroll
    for (int s = 0; s < C; ++s) {
      const int k = lane * C + s;
      S.ev[s] = k == H / 2 - 1 ? 0 : ceil_val;
      S.od[s] = k == H / 2 ? (HW ? 0 : 1) : (k == H / 2 - 1 ? 1 : ceil_val);
      S.qc[s] = k < H / 2 ? q_code(p, H / 2 - 1 - k) : kQPad;
      S.tc[s] = k >= H / 2 ? t_code(p, k - H / 2) : kTPad;
    }
    // the first code to enter is c = H/2 (diagonal 2)
    const int w0 = (H / 2) >> 5;
    S.qwin = q_code(p, w0 * kWarp + lane);
    S.twin = t_code(p, w0 * kWarp + lane);
    S.qnext = q_code(p, (w0 + 1) * kWarp + lane);
    S.tnext = t_code(p, (w0 + 1) * kWarp + lane);
    // row n's cells before diagonal 2: (0, *) = 0 and (1, 0) = 1
    S.res = p.n == 0 ? 0 : (p.n == 1 ? 1 : unset);
    S.endj = 0;

    int d = 2;
    if (HW) {
      p.rs = max(max(2, p.n), 2 * p.n + o_lo);
      p.re = min(dfin, 2 * p.n + H);
      const int last = p.rs <= p.re ? p.re : 1;     // nothing to read
      run<C, true, true>(S, p, d, min(H, last), lane, ceil_val);
      run<C, false, false>(S, p, d, min(p.rs - 1, last), lane, ceil_val);
      run<C, false, true>(S, p, d, last, lane, ceil_val);
      if (lane == 0) {
        out_ed[b] = S.res;
        out_ej[b] = S.endj;
      }
    } else {
      run<C, false, false>(S, p, d, dfin, lane, ceil_val);
      // the value on diagonal n + m in lane clip(m - n - o_lo, 0, Wp - 1);
      // a clipped lane of the other parity is no cell: the ceiling
      const int l = min(max(p.m - p.n - o_lo, 0), Wp - 1);
      const int v_even = slot_value<C>(S.ev, l >> 1);
      const int v_odd = slot_value<C>(S.od, l >> 1);
      const int v = (dfin & 1) ? v_odd : v_even;
      if (lane == 0) {
        const bool is_cell = (((o_lo + l) ^ dfin) & 1) == 0;
        out_ed[b] = dfin <= 1 ? max(p.n, p.m) : (is_cell ? v : ceil_val);
        out_ej[b] = p.m;
      }
    }
    int nb = 0;
    if (lane == 0) nb = atomicAdd(next_pair, 1) + first_taken;
    b = __shfl_sync(kFull, nb, 0);
  }
}

template <int C, bool HW>
int launch_warp(const uint8_t* pool, const int* qrow, const int* trow,
                const int* n, const int* m, int* ed, int* ej, int* counter,
                int B, int Lp, int ceil_val, int unset, cudaStream_t stream) {
  auto kernel = wavefront_warp_kernel<C, HW>;
  const int threads = kWarpsPerBlock * kWarp;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc == cudaSuccess)
    rc = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (rc == cudaSuccess)
    rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                       threads, 0);
  if (rc == cudaSuccess)
    rc = cudaMemsetAsync(counter, 0, sizeof(int), stream);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  const int needed = (B + kWarpsPerBlock - 1) / kWarpsPerBlock;
  const int resident = sms * (per_sm > 0 ? per_sm : 1);
  const int grid = needed < resident ? needed : resident;
  kernel<<<grid, threads, 0, stream>>>(pool, qrow, trow, n, m, ed, ej,
                                       counter, B, Lp, ceil_val, unset);
  return isocon_launch_status();
}

// ---------------------------------------------------------------------------
// wide kernel: one block per pair, diagonals in shared or device memory
// ---------------------------------------------------------------------------
template <bool HW>
__global__ void wavefront_wide_kernel(const uint8_t* __restrict__ pool,
                                      const int* __restrict__ qrow,
                                      const int* __restrict__ trow,
                                      const int* __restrict__ nlen,
                                      const int* __restrict__ mlen,
                                      int* __restrict__ out_ed,
                                      int* __restrict__ out_ej, int* scratch,
                                      int B, int Lp, int Wp, int ceil_val,
                                      int unset) {
  extern __shared__ int smem[];
  __shared__ int s_res, s_endj;
  const int H = Wp >> 1;
  int* even = scratch ? scratch + static_cast<size_t>(blockIdx.x) * Wp : smem;
  int* odd = even + H;
  const int tid = threadIdx.x;
  const int o_lo = -(H - 1);

  for (int b = blockIdx.x; b < B; b += gridDim.x) {
    const int n = nlen[b];
    const int m = mlen[b];
    const int dfin = n + m;
    const uint8_t* q = pool + static_cast<size_t>(qrow[b]) * Lp;
    const uint8_t* t = pool + static_cast<size_t>(trow[b]) * Lp;

    // diagonal 0: (0, 0) = 0; diagonal 1: (0, 1) = 1 (0 in HW), (1, 0) = 1
    for (int k = tid; k < H; k += blockDim.x) {
      even[k] = k == H / 2 - 1 ? 0 : ceil_val;
      odd[k] = k == H / 2 ? (HW ? 0 : 1) : (k == H / 2 - 1 ? 1 : ceil_val);
    }
    if (tid == 0) {
      // row n's cells before diagonal 2: (0, *) = 0 and (1, 0) = 1
      s_res = n == 0 ? 0 : (n == 1 ? 1 : unset);
      s_endj = 0;
    }
    __syncthreads();

    for (int d = 2; d <= dfin; ++d) {
      const bool ev = (d & 1) == 0;
      int* cur = ev ? even : odd;            // diagonal d-2, becomes d
      const int* prev = ev ? odd : even;     // diagonal d-1
      for (int k = tid; k < H; k += blockDim.x) {
        const int o = 2 * k - H + (ev ? 2 : 1);
        int v;
        if (o > d || o < -d) {
          v = ceil_val;                      // outside the grid
        } else if (o == -d) {
          v = min(d, ceil_val);              // column 0
        } else if (o == d) {
          v = HW ? 0 : min(d, ceil_val);     // row 0
        } else {
          // A[o-1] and A[o+1]; a lane outside the band is the ceiling
          const int down = ev ? prev[k] : (k > 0 ? prev[k - 1] : ceil_val);
          const int up = ev ? (k + 1 < H ? prev[k + 1] : ceil_val) : prev[k];
          const int i = (d - o) >> 1;
          const int j = (d + o) >> 1;
          const int qc = i <= n ? q[i - 1] : kQPad;
          const int tc = j <= m ? t[j - 1] : kTPad;
          v = min(min(up, down) + 1, cur[k] + (qc != tc ? 1 : 0));
          v = min(v, ceil_val);
        }
        cur[k] = v;
        // row n: the one cell (n, d - n) of this diagonal, in order of j
        if (HW && d - o == 2 * n && d >= n && v < s_res) {
          s_res = v;
          s_endj = d - n;
        }
      }
      __syncthreads();
    }

    if (tid == 0) {
      if (HW) {
        out_ed[b] = s_res;
        out_ej[b] = s_endj;
      } else {
        int ed;
        if (dfin <= 1) {
          ed = max(n, m);
        } else {
          const int lane = min(max(m - n - o_lo, 0), Wp - 1);
          // a clipped lane of the other parity is no cell: the ceiling
          const bool cell = (((o_lo + lane) ^ dfin) & 1) == 0;
          const int* fin = (dfin & 1) ? odd : even;
          ed = cell ? fin[lane >> 1] : ceil_val;
        }
        out_ed[b] = ed;
        out_ej[b] = m;
      }
    }
    __syncthreads();     // the arrays are set anew for the block's next pair
  }
}

template <bool HW>
int launch_wide(const uint8_t* pool, const int* qrow, const int* trow,
                const int* n, const int* m, int* ed, int* ej, int* scratch,
                int B, int Lp, int Wp, int ceil_val, int unset,
                int scratch_rows, cudaStream_t stream) {
  const int H = Wp / 2;
  const int threads = H < 64 ? 64 : (H > 1024 ? 1024 : H);
  size_t shared = 0;
  int grid = B;
  if (scratch) {
    grid = B < scratch_rows ? B : scratch_rows;
  } else {
    shared = sizeof(int) * static_cast<size_t>(Wp);
    if (shared > 48 * 1024) {
      cudaError_t rc = cudaFuncSetAttribute(
          wavefront_wide_kernel<HW>,
          cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(shared));
      if (rc != cudaSuccess) return static_cast<int>(rc);
    }
  }
  wavefront_wide_kernel<HW><<<grid, threads, shared, stream>>>(
      pool, qrow, trow, n, m, ed, ej, scratch, B, Lp, Wp, ceil_val, unset);
  return isocon_launch_status();
}

// The one place that picks the kernel for a band.
template <bool HW>
int launch(const uint8_t* pool, const int* qrow, const int* trow,
           const int* n, const int* m, int* ed, int* ej, int* counter,
           int* scratch, int B, int Lp, int Wp, int ceil_val, int unset,
           int scratch_rows, cudaStream_t stream) {
  switch (Wp) {
    case 128:
      return launch_warp<2, HW>(pool, qrow, trow, n, m, ed, ej, counter, B,
                                Lp, ceil_val, unset, stream);
    case 256:
      return launch_warp<4, HW>(pool, qrow, trow, n, m, ed, ej, counter, B,
                                Lp, ceil_val, unset, stream);
    case 512:
      return launch_warp<8, HW>(pool, qrow, trow, n, m, ed, ej, counter, B,
                                Lp, ceil_val, unset, stream);
    case 1024:
      return launch_warp<16, HW>(pool, qrow, trow, n, m, ed, ej, counter, B,
                                 Lp, ceil_val, unset, stream);
    default:
      return launch_wide<HW>(pool, qrow, trow, n, m, ed, ej, scratch, B, Lp,
                             Wp, ceil_val, unset, scratch_rows, stream);
  }
}

}  // namespace

// K5: (ed, end_j) of query row qrow[b] against target row trow[b] in a band
// of Wp lanes.  hw: 0 = NW, 1 = HW.  ceil_val: the ceiling DP values
// saturate at; unset: the HW answer before any cell of row n is seen.
// counter: one int32 of device memory, the register kernel's pair counter
// (zeroed here; every call passes it).  Wp = 128, 256, 512, 1024 run the
// register kernel, other widths the wide kernel: scratch null (the
// diagonals live in shared memory, Wp <= 32768), or int32
// [scratch_rows, Wp] in device memory.  Returns cudaErrorInvalidValue for
// a geometry the kernels do not take.
ISOCON_API int isocon_wavefront_ed(const void* pool, const void* qrow,
                                   const void* trow, const void* n,
                                   const void* m, void* ed, void* ej,
                                   void* counter, void* scratch, int B,
                                   int Lp, int Wp, int hw, int ceil_val,
                                   int unset, int scratch_rows,
                                   void* stream) {
  if (B <= 0) return 0;
  if (Wp < 8 || Wp % 4 || Lp <= 0 || ceil_val < 1 || !counter)
    return cudaErrorInvalidValue;
  if (scratch ? scratch_rows < 1 : Wp > kSharedMaxWp)
    return cudaErrorInvalidValue;
  auto* P = static_cast<const uint8_t*>(pool);
  auto* qr = static_cast<const int*>(qrow);
  auto* tr = static_cast<const int*>(trow);
  auto* nn = static_cast<const int*>(n);
  auto* mm = static_cast<const int*>(m);
  auto* e = static_cast<int*>(ed);
  auto* j = static_cast<int*>(ej);
  auto* c = static_cast<int*>(counter);
  auto* sc = static_cast<int*>(scratch);
  auto s = static_cast<cudaStream_t>(stream);
  return hw ? launch<true>(P, qr, tr, nn, mm, e, j, c, sc, B, Lp, Wp,
                           ceil_val, unset, scratch_rows, s)
            : launch<false>(P, qr, tr, nn, mm, e, j, c, sc, B, Lp, Wp,
                            ceil_val, unset, scratch_rows, s);
}
