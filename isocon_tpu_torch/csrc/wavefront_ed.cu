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
// What bounds it on the H100: integer operations.  The function needs about
// 8 32-bit operations per DP cell over (n + m - 1) * Wp/2 cells (the
// recurrence 6, q's pad code 2), while it reads n + m code bytes and writes
// 8 bytes, so the bound is ops / (132 SMs x 64 int32 lanes x clock), far
// above bytes / 3.35 TB/s.  This kernel spends more than that: it tests the
// grid's boundary and both lengths in every cell, which only the first Wp/2
// diagonals and the cells past row n need.  What it actually waits for is
// the chain of n + m - 1 dependent diagonals, one barrier each.
//
// Design: one block per pair, the Wp/2 cells of a diagonal strided over the
// block's threads (64 threads at Wp = 128, up to 1024).  Only lanes with
// o = d (mod 2) are DP cells; the other lanes of the JAX versions stay at
// the ceiling for ever and are not stored.  Cells are held compacted in
// two arrays of Wp/2 ints, one for even and one for odd diagonals:
//   even d: slot k holds o = 2k - H + 2,   odd d: slot k holds o = 2k - H + 1
// (H = Wp/2, so o_lo = -(H - 1) is the odd array's slot 0).  A cell's
// diagonal d-2 sits in its own slot, so diagonal d overwrites diagonal d-2
// in place and the other array is diagonal d-1: two arrays, one barrier per
// diagonal.  They live in shared memory up to Wp = 32768 (4 * Wp bytes; the
// block opts into up to 128 KB) and in a device-memory scratch row of the
// block beyond that, where the grid is capped and each block loops over
// its pairs.  Codes come straight from the pool rows by
// (i, j) = ((d - o) / 2, (d + o) / 2); positions at or past a length read
// as QPAD / TPAD.  A pair stops at its own n + m.  None of the TPU
// kernel's doubled and reversed code planes, sliding windows, 128-pair
// blocks or [B, 128] scalar planes is carried over.
#include "isocon_cuda.h"

namespace {

constexpr int kQPad = 5;
constexpr int kTPad = 6;
constexpr int kSharedMaxWp = 32768;

template <bool HW>
__global__ void wavefront_kernel(const uint8_t* __restrict__ pool,
                                 const int* __restrict__ qrow,
                                 const int* __restrict__ trow,
                                 const int* __restrict__ nlen,
                                 const int* __restrict__ mlen,
                                 int* __restrict__ out_ed,
                                 int* __restrict__ out_ej, int* scratch, int B,
                                 int Lp, int Wp, int ceil_val, int unset) {
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
int launch(const uint8_t* pool, const int* qrow, const int* trow,
           const int* n, const int* m, int* ed, int* ej, int* scratch, int B,
           int Lp, int Wp, int ceil_val, int unset, int scratch_rows,
           cudaStream_t stream) {
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
          wavefront_kernel<HW>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(shared));
      if (rc != cudaSuccess) return static_cast<int>(rc);
    }
  }
  wavefront_kernel<HW><<<grid, threads, shared, stream>>>(
      pool, qrow, trow, n, m, ed, ej, scratch, B, Lp, Wp, ceil_val, unset);
  return isocon_launch_status();
}

}  // namespace

// K5: (ed, end_j) of query row qrow[b] against target row trow[b] in a band
// of Wp lanes.  hw: 0 = NW, 1 = HW.  ceil_val: the ceiling DP values
// saturate at; unset: the HW answer before any cell of row n is seen.
// scratch: null (the diagonals live in shared memory, Wp <= 32768), or
// int32 [scratch_rows, Wp] in device memory.  Returns cudaErrorInvalidValue
// for a geometry the kernel does not take.
ISOCON_API int isocon_wavefront_ed(const void* pool, const void* qrow,
                                   const void* trow, const void* n,
                                   const void* m, void* ed, void* ej,
                                   void* scratch, int B, int Lp, int Wp,
                                   int hw, int ceil_val, int unset,
                                   int scratch_rows, void* stream) {
  if (B <= 0) return 0;
  if (Wp < 8 || Wp % 4 || Lp <= 0 || ceil_val < 1) return cudaErrorInvalidValue;
  if (scratch ? scratch_rows < 1 : Wp > kSharedMaxWp)
    return cudaErrorInvalidValue;
  auto* P = static_cast<const uint8_t*>(pool);
  auto* qr = static_cast<const int*>(qrow);
  auto* tr = static_cast<const int*>(trow);
  auto* nn = static_cast<const int*>(n);
  auto* mm = static_cast<const int*>(m);
  auto* e = static_cast<int*>(ed);
  auto* j = static_cast<int*>(ej);
  auto* sc = static_cast<int*>(scratch);
  auto s = static_cast<cudaStream_t>(stream);
  return hw ? launch<true>(P, qr, tr, nn, mm, e, j, sc, B, Lp, Wp, ceil_val,
                           unset, scratch_rows, s)
            : launch<false>(P, qr, tr, nn, mm, e, j, sc, B, Lp, Wp, ceil_val,
                            unset, scratch_rows, s);
}
