// K1 and K2: banded bit-parallel Myers/Hyyro edit distance over a sequence
// pool, NW (global, K1) and HW (infix, K2).
//
// K1 replaces the Pallas TPU kernel isocon_tpu/ops/myers_pallas.py::_kernel
// with HW=False, reached through _myers_ed / myers_ed_pool; K2 replaces the
// same _kernel with HW=True, reached through myers_hw_pool.  Same
// recurrence, window rule and answer extraction (see
// isocon_tpu_torch/ops/myers.py, whose myers_ed_plain and myers_hw_plain
// are the plain versions these kernels are held to on every entry).
//
// What bounds it on the H100: integer operations.  A pair costs about
// 20 32-bit logic/add ops per window word per text column (m * WIN * 20),
// while it reads only m text bytes and 5*WIN Peq words per 32 columns, so
// the bound is ops / (132 SMs x 64 int32 lanes x clock), far above the
// bytes / 3.35 TB/s bound.
//
// Design: one thread per pair, the WIN-word window (pv/mv) in registers
// (WIN is a template parameter so the arrays unroll), no cross-thread
// communication and no __syncthreads: each thread stops at its own m (the
// TPU kernel swept a block's longest target; columns past m do not change
// base + walk).  Once per 32-column phase a thread copies the 5 x WIN Peq
// words of its window into its own column of shared memory ([5*WIN][BLOCK],
// conflict-free), so the per-column loads hit shared memory instead of the
// L1/L2.  The TPU's (SUB, 128) pair packing is not carried over.
//
// Full-width window (win == 0): the escalation past WIN 33.  W0 stays 0
// and the recurrence is unbanded (exact); words below row n's word never
// reach rows <= n, so each thread sweeps words 0 .. (n-1)/32 only.  Its
// state lives in local memory (runtime length).
//
// K2 (the HW template argument) shares the word step and differs around
// it: the pair is taken as given (n may exceed m); the window top feeds
// hin = 0 while it sits at row 0 (free target start) and +1 once it has
// moved; the sweep runs to column max(n, m), the target reading as a code
// without a plane past m, because column n carries the anchor D[n][n];
// walk sums row n's horizontal deltas over every column where row n's word
// is in the window, wn latches it at j = n, and (wmin, wj) take its strict
// minimum over jlow <= j <= m with jlow = max(n - margin, 1), so ties keep
// the smallest end.  The answer is v = base + wmin - wn against the
// delete-whole-query end D[n][0] = n, which wins ties (ej = 0).  At the
// full width every column of row n is in the window, so jlow = 1 there.
// It is bound like K1, by int32 operations: the walk adds about 15 per
// column to the 20 per window word, and a thread still stops at its own
// last column, max(n, m).
#include "isocon_cuda.h"

namespace {

constexpr int kMaxFullWords = 512;  // full window up to L = 16384

__device__ __forceinline__ int plane_of(int code) {
  return code < 4 ? code : (code == 5 ? 4 : -1);
}

constexpr int kWalkBig = 1 << 29;

// K2's answer from the anchor and the row-n walk.
__device__ __forceinline__ void hw_result(int base, int wn, int wmin, int wj,
                                          int n, int* out, int* out_ej,
                                          int b) {
  const int v = base + wmin - wn;
  out[b] = min(v, n);
  out_ej[b] = n <= v ? 0 : wj;
}

template <int WIN, int BLOCK, bool HW>
__global__ void __launch_bounds__(BLOCK)
myers_band_kernel(const uint8_t* __restrict__ pool,
                  const uint32_t* __restrict__ peq,
                  const int* __restrict__ qrow, const int* __restrict__ trow,
                  const int* __restrict__ nlen, const int* __restrict__ mlen,
                  int* __restrict__ out, int* __restrict__ out_ej, int B,
                  int Lp, int L) {
  __shared__ uint32_t speq[5 * WIN * BLOCK];
  const int tid = threadIdx.x;
  const int b = blockIdx.x * BLOCK + tid;
  if (b >= B) return;
  const int n = nlen[b];
  const int m = mlen[b];
  const int NWp = Lp / 32;
  const int nwords = L / 32;
  const uint8_t* text = pool + static_cast<size_t>(trow[b]) * Lp;
  const uint32_t* pq = peq + static_cast<size_t>(qrow[b]) * 5 * NWp;
  constexpr int HALF = WIN / 2;

  uint32_t pv[WIN], mv[WIN];
#pragma unroll
  for (int k = 0; k < WIN; ++k) {
    pv[k] = 0xFFFFFFFFu;
    mv[k] = 0u;
  }
  int sdiag = 0, base = 0, walk = 0;
  int wn = 0, wmin = kWalkBig, wj = 0;     // HW only
  const int nword = (n - 1) >> 5;          // floor((n-1)/32)
  const int nbitpos = (n - 1) & 31;
  const int last = HW ? max(n, m) : m;     // last column swept
  const int nphases = (last + 31) >> 5;
  const int jlow = max(n - 32 * HALF, 1);

  for (int p = 0; p < nphases; ++p) {
    const int W0 = min(max(p - HALF, 0), nwords - WIN);
    const int dslot = p - W0;
    if (p >= HALF + 1 && p <= nwords - WIN + HALF) {
#pragma unroll
      for (int k = 0; k < WIN - 1; ++k) {
        pv[k] = pv[k + 1];
        mv[k] = mv[k + 1];
      }
      pv[WIN - 1] = 0xFFFFFFFFu;
      mv[WIN - 1] = 0u;
    }
#pragma unroll
    for (int c = 0; c < 5; ++c) {
#pragma unroll
      for (int k = 0; k < WIN; ++k) {
        const int w = W0 + k;
        speq[(c * WIN + k) * BLOCK + tid] = w < NWp ? pq[c * NWp + w] : 0u;
      }
    }
    const int rsel = nword - W0;
    const int ncol = min(32, last - 32 * p);
    // window top: +1, or 0 in HW mode while it sits at row 0
    const uint32_t hin = (HW && W0 == 0) ? 0u : 1u;
    for (int s = 0; s < ncol; ++s) {
      const int j = 32 * p + s + 1;
      const int ci = (!HW || j <= m) ? plane_of(text[32 * p + s]) : -1;
      uint32_t pv_d = 0u, mv_d = 0u;
#pragma unroll
      for (int k = 0; k < WIN; ++k) {
        if (k == dslot) {
          pv_d = pv[k];
          mv_d = mv[k];
        }
      }
      sdiag += static_cast<int>((pv_d >> s) & 1u) -
               static_cast<int>((mv_d >> s) & 1u);
      uint32_t hp = hin, hm = 0u;
      uint32_t ph_d = 0u, mh_d = 0u, hsel_p = 0u, hsel_m = 0u;
#pragma unroll
      for (int k = 0; k < WIN; ++k) {
        uint32_t eq = ci >= 0 ? speq[(ci * WIN + k) * BLOCK + tid] : 0u;
        const uint32_t xv = eq | mv[k];
        eq |= hm;
        const uint32_t xh = (((eq & pv[k]) + pv[k]) ^ pv[k]) | eq;
        uint32_t ph = mv[k] | ~(xh | pv[k]);
        uint32_t mh = pv[k] & xh;
        if (k == dslot) {
          ph_d = ph;
          mh_d = mh;
        }
        if (k == rsel) {
          hsel_p = ph;
          hsel_m = mh;
        }
        const uint32_t hout_p = ph >> 31;
        const uint32_t hout_m = mh >> 31;
        ph = (ph << 1) | hp;
        mh = (mh << 1) | hm;
        pv[k] = mh | ~(xv | ph);
        mv[k] = ph & xv;
        hp = hout_p;
        hm = hout_m;
      }
      sdiag += static_cast<int>((ph_d >> s) & 1u) -
               static_cast<int>((mh_d >> s) & 1u);
      if (j == n) base = sdiag;
      const int hdelta = static_cast<int>((hsel_p >> nbitpos) & 1u) -
                         static_cast<int>((hsel_m >> nbitpos) & 1u);
      if (HW) {
        walk += hdelta;
        if (j == n) wn = walk;
        if (j >= jlow && j <= m && walk < wmin) {
          wmin = walk;
          wj = j;
        }
      } else if (j > n && j <= m) {
        walk += hdelta;
      }
    }
  }
  if (HW)
    hw_result(base, wn, wmin, wj, n, out, out_ej, b);
  else
    out[b] = base + walk;
}

template <bool HW>
__global__ void __launch_bounds__(128)
myers_full_kernel(const uint8_t* __restrict__ pool,
                  const uint32_t* __restrict__ peq,
                  const int* __restrict__ qrow, const int* __restrict__ trow,
                  const int* __restrict__ nlen, const int* __restrict__ mlen,
                  int* __restrict__ out, int* __restrict__ out_ej, int B,
                  int Lp) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const int n = nlen[b];
  const int m = mlen[b];
  const int NWp = Lp / 32;
  const uint8_t* text = pool + static_cast<size_t>(trow[b]) * Lp;
  const uint32_t* pq = peq + static_cast<size_t>(qrow[b]) * 5 * NWp;
  uint32_t pv[kMaxFullWords], mv[kMaxFullWords];
  const int nword = (n - 1) >> 5;
  const int nbitpos = (n - 1) & 31;
  const int kmax = max(nword + 1, 1);
  for (int k = 0; k < kmax; ++k) {
    pv[k] = 0xFFFFFFFFu;
    mv[k] = 0u;
  }
  int sdiag = 0, base = 0, walk = 0;
  int wn = 0, wmin = kWalkBig, wj = 0;     // HW only
  const int last = HW ? max(n, m) : m;
  for (int col = 0; col < last; ++col) {
    const int p = col >> 5;
    const int s = col & 31;
    const int j = col + 1;
    const int ci = (!HW || j <= m) ? plane_of(text[col]) : -1;
    const bool diag_live = p < kmax;
    if (diag_live)
      sdiag += static_cast<int>((pv[p] >> s) & 1u) -
               static_cast<int>((mv[p] >> s) & 1u);
    uint32_t hp = HW ? 0u : 1u, hm = 0u;   // the window top stays at row 0
    uint32_t ph_d = 0u, mh_d = 0u, hsel_p = 0u, hsel_m = 0u;
    for (int k = 0; k < kmax; ++k) {
      uint32_t eq = ci >= 0 ? pq[ci * NWp + k] : 0u;
      const uint32_t pvk = pv[k], mvk = mv[k];
      const uint32_t xv = eq | mvk;
      eq |= hm;
      const uint32_t xh = (((eq & pvk) + pvk) ^ pvk) | eq;
      uint32_t ph = mvk | ~(xh | pvk);
      uint32_t mh = pvk & xh;
      if (k == p) {
        ph_d = ph;
        mh_d = mh;
      }
      if (k == nword) {
        hsel_p = ph;
        hsel_m = mh;
      }
      const uint32_t hout_p = ph >> 31;
      const uint32_t hout_m = mh >> 31;
      ph = (ph << 1) | hp;
      mh = (mh << 1) | hm;
      pv[k] = mh | ~(xv | ph);
      mv[k] = ph & xv;
      hp = hout_p;
      hm = hout_m;
    }
    if (diag_live)
      sdiag += static_cast<int>((ph_d >> s) & 1u) -
               static_cast<int>((mh_d >> s) & 1u);
    if (j == n) base = sdiag;
    const int hdelta = static_cast<int>((hsel_p >> nbitpos) & 1u) -
                       static_cast<int>((hsel_m >> nbitpos) & 1u);
    if (HW) {
      walk += hdelta;
      if (j == n) wn = walk;
      if (j <= m && walk < wmin) {         // jlow = 1: every column counts
        wmin = walk;
        wj = j;
      }
    } else if (j > n && j <= m) {
      walk += hdelta;
    }
  }
  if (HW)
    hw_result(base, wn, wmin, wj, n, out, out_ej, b);
  else
    out[b] = base + walk;
}

template <int WIN, int BLOCK, bool HW>
void launch_band(const uint8_t* pool, const uint32_t* peq, const int* qrow,
                 const int* trow, const int* n, const int* m, int* out,
                 int* out_ej, int B, int Lp, int L, cudaStream_t stream) {
  const int grid = (B + BLOCK - 1) / BLOCK;
  myers_band_kernel<WIN, BLOCK, HW><<<grid, BLOCK, 0, stream>>>(
      pool, peq, qrow, trow, n, m, out, out_ej, B, Lp, L);
}

// win in {7, 9, 17, 33}: banded kernel; win == 0: full-width window.
// Returns cudaErrorInvalidValue for a geometry the kernels do not take.
template <bool HW>
int launch_myers(const void* pool, const void* peq, const void* qrow,
                 const void* trow, const void* n, const void* m, void* out,
                 void* out_ej, int B, int Lp, int L, int win, void* stream) {
  auto* P = static_cast<const uint8_t*>(pool);
  auto* Q = static_cast<const uint32_t*>(peq);
  auto* qr = static_cast<const int*>(qrow);
  auto* tr = static_cast<const int*>(trow);
  auto* nn = static_cast<const int*>(n);
  auto* mm = static_cast<const int*>(m);
  auto* o = static_cast<int*>(out);
  auto* oj = static_cast<int*>(out_ej);
  auto s = static_cast<cudaStream_t>(stream);
  if (B <= 0) return 0;
  if (Lp % 32 || L % 32 || L < Lp) return cudaErrorInvalidValue;
  switch (win) {
    case 0:
      if (Lp / 32 > kMaxFullWords) return cudaErrorInvalidValue;
      myers_full_kernel<HW><<<(B + 127) / 128, 128, 0, s>>>(
          P, Q, qr, tr, nn, mm, o, oj, B, Lp);
      break;
    case 7:
      launch_band<7, 128, HW>(P, Q, qr, tr, nn, mm, o, oj, B, Lp, L, s);
      break;
    case 9:
      launch_band<9, 128, HW>(P, Q, qr, tr, nn, mm, o, oj, B, Lp, L, s);
      break;
    case 17:
      launch_band<17, 128, HW>(P, Q, qr, tr, nn, mm, o, oj, B, Lp, L, s);
      break;
    case 33:
      launch_band<33, 64, HW>(P, Q, qr, tr, nn, mm, o, oj, B, Lp, L, s);
      break;
    default: return cudaErrorInvalidValue;
  }
  return isocon_launch_status();
}

}  // namespace

// K1: NW edit distance of (qrow, trow) pairs with n <= m.
ISOCON_API int isocon_myers_ed(const void* pool, const void* peq,
                               const void* qrow, const void* trow,
                               const void* n, const void* m, void* out,
                               int B, int Lp, int L, int win, void* stream) {
  return launch_myers<false>(pool, peq, qrow, trow, n, m, out, nullptr, B, Lp,
                             L, win, stream);
}

// K2: HW (infix) distance and end column of query qrow inside target trow.
ISOCON_API int isocon_myers_hw(const void* pool, const void* peq,
                               const void* qrow, const void* trow,
                               const void* n, const void* m, void* out,
                               void* out_ej, int B, int Lp, int L, int win,
                               void* stream) {
  return launch_myers<true>(pool, peq, qrow, trow, n, m, out, out_ej, B, Lp,
                            L, win, stream);
}
