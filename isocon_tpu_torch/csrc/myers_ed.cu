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
// What bounds it on the H100: the ALU pipe.  A pair reads m text bytes and
// 5 * WIN Peq words per 32 columns, but does WIN word steps per text
// column.  With the card's fused forms (three-input LOP3, the funnel shift
// SHF.L.W) a word step is a Peq load (shared memory), 8 bit-logic
// instructions that only the ALU pipe runs (Eq | carry, & Pv, Xh, Ph, Mh,
// Pv in two, Mv) and 4 that the FMA pipe could take in IMAD forms (+ Pv,
// the carry-in of the previous word's Mh, the two shifted words, one
// funnel shift each on the previous word's unshifted value).  A column
// adds its Peq slot; K2 adds its row-n walk.  The bound (chip_smoke.py) is
// the ALU's 8 a word over 132 SMs x 64 lanes x the clock, far above the
// bytes / 3.35 TB/s.  This kernel leaves the carries on the ALU pipe (11 a
// word there).
//
// Design: one thread per pair, the WIN-word window (pv/mv) in registers
// (WIN is a template parameter so the arrays unroll), no __syncthreads:
// each thread stops at its own last column (the TPU kernel swept a
// block's longest target).  What the design does about the bound:
// - The word step is written in the fused forms above; the carries into
//   word k are __funnelshift_l(prev, cur, 1) of word k-1's Ph / Mh (word 0
//   takes hin, or 0 for Mh).
// - K1 does nothing a column but the word steps and the column's Peq slot,
//   and runs one body in every phase: a body chosen per lane (the pairs of
//   a warp reach row n in different phases) would make the warp run each
//   lane's body in turn.  Each Myers cell keeps
//   h_out - h_in = v_out - v_in, so the deltas the recurrence produces are
//   those of one banded table D' whose row above the window has value T:
//   T grows by hin a column and, when the window moves down a word, by the
//   dropped word's vertical sum.  Then D'[n][j] = T + V, V the vertical
//   sum from the window top to row n (popcounts), and the diagonal-plus-
//   walk answer of the TPU kernel, base + walk, is D'[n][min(m, J*)]
//   (J*: the last column with row n's word in the window; the walk adds
//   nothing later, so the sweep stops there).  No diagonal slot and no
//   row-n word is picked in the word loop.
// - Every column does the same loads: codes 0-3 and N (5) index their Peq
//   slot, code 4 (X) and every code above 5 fall on slot 4, which holds
//   zeros.  A thread keeps its
//   window's 5 x WIN Peq words in its own part of shared memory
//   ([6][WIN][BLOCK] words) and moves them with the window, loading only
//   the new bottom word of each plane from the table: each such load is a
//   sector of its own for every lane of the warp (loading all 5 x WIN at
//   every move read 12% slower on an H100).  Once a 32-column phase it
//   copies its 32 text codes (two 16-byte loads) into [BLOCK][9] words (a
//   row of 36 bytes, so the warp's byte loads and word stores hit 32
//   banks).
// The TPU's (SUB, 128) pair packing is not carried over.
//
// Full-width window (win == 0): the escalation past WIN 33.  W0 stays 0
// and the recurrence is unbanded (exact); words below row n's word never
// reach rows <= n, so each thread sweeps words 0 .. (n-1)/32 only.  Its
// state lives in local memory (runtime length).  It keeps the word step as
// first written and tracks the diagonal and row n's walk a column.
//
// K2 (the HW template argument) shares the word step and the phase loop
// and differs around it: the pair is taken as given (n may exceed m); the
// window top feeds hin = 0 while it sits at row 0 (free target start) and
// +1 once it has moved; walk sums row n's horizontal deltas over the
// columns where row n's word is in the window, and (wmin, wj) take its
// strict minimum over jlow <= j <= m with jlow = max(n - margin, 1), so
// ties keep the smallest end.  The TPU kernel's answer base + wmin - wn is
// anchor + wmin with anchor = D'[n][j0 - 1] = T + V, read where row n's
// word enters the window (j0 = 32 pe + 1: pe = 0 if nword < WIN, else
// nword - HALF), against the delete-whole-query end D[n][0] = n, which wins
// ties (ej = 0).  At the full width every column of row n is in the
// window, so jlow = 1 there.
// Where K2 stops, and why each stop is exact (the TPU kernel and the plain
// version sweep to max(n, m); column n carried their anchor):
// - after column max(m, j0 - 1).  Past it the anchor is read and no column
//   j <= m is left, so wmin and wj cannot change.  max(m, j0 - 1) is m
//   whenever jlow <= m, since j0 - 1 = 32 pe <= n - 1 - margin < jlow.  If
//   m < jlow no column can set wmin at all: the answer is (n, 0), whatever
//   the anchor, and the lane sweeps nothing (last = 0 below).  So the
//   lane sweeps to m or not at all, and every column it sweeps lies before
//   m: its text needs no mark past m;
// - after phase nword + HALF if the window moves below row n: row n's word
//   has left the window, walk is constant and was already held against
//   wmin (K1's stop too).
// Which body a phase runs: row n's bits are picked with per-phase word
// masks (rm), two masked ORs a window word, and the walk's compare and
// minimum a column; that body is only needed in the phases where row n's
// word is in the window (rsel < WIN), WIN of them at most and fewer when
// the lane stops at m.  While row n is below the window its masks are 0,
// the walk adds 0 and the columns lie before jlow.  A body chosen per lane
// would make the warp run each lane's body in turn, so the warp votes: if
// a lane of the warp needs the walk, all run the walk body (those whose
// masks are 0 add nothing); otherwise all run K1's body, unrolled twice.
// The main path's warps (the static graph: runs of pairs that share a
// query, targets within 40 bases of it) walk in the same few phases and
// run K1's body in the others.
#include "isocon_cuda.h"

namespace {

constexpr int kMaxFullWords = 512;  // full window up to L = 16384

__device__ __forceinline__ int plane_of(int code) {
  return code < 4 ? code : (code == 5 ? 4 : -1);
}

constexpr int kWalkBig = 1 << 29;

// Slots of the band kernel's Peq stage: slot = code for codes 0-3 and N (5);
// slot 4 stays zero and takes X (4) and every code above 5.
constexpr int kSlots = 6;
constexpr int kZeroSlot = 4;
// Words of a thread's row of staged text codes: 8 and one of padding.
constexpr int kTextWords = 9;

// K2's answer from the anchor (D'[n][j] - walk(j)) and the row-n walk.
__device__ __forceinline__ void hw_result(int anchor, int wmin, int wj, int n,
                                          int* out, int* out_ej, int b) {
  const int v = anchor + wmin;
  out[b] = min(v, n);
  out_ej[b] = n <= v ? 0 : wj;
}

// D'[n][j] - T: the vertical sum from the window top to row n (bit nbit of
// word rsel, 0 <= rsel < WIN).
template <int WIN>
__device__ __forceinline__ int rows_to_n(const uint32_t (&pv)[WIN],
                                         const uint32_t (&mv)[WIN], int rsel,
                                         int nbit) {
  const uint32_t last = (2u << nbit) - 1u;
  int v = 0;
#pragma unroll
  for (int k = 0; k < WIN; ++k) {
    const uint32_t keep = k < rsel ? 0xFFFFFFFFu : (k == rsel ? last : 0u);
    v += __popc(pv[k] & keep) - __popc(mv[k] & keep);
  }
  return v;
}

// One text column over the window: the word steps, and with WALK row n's
// horizontal deltas or-ed out of every word under its mask rm[k] (bit nbit
// in row n's word, 0 elsewhere) into (hp, hm).  eq: the column's Peq slot,
// word k at eq[k * BLOCK].
template <int WIN, int BLOCK, bool WALK>
__device__ __forceinline__ void column_step(uint32_t (&pv)[WIN],
                                            uint32_t (&mv)[WIN],
                                            const uint32_t* __restrict__ eq,
                                            uint32_t hin31,
                                            const uint32_t (&rm)[WIN],
                                            uint32_t& hp, uint32_t& hm) {
  uint32_t prev_ph = hin31, prev_mh = 0u;
#pragma unroll
  for (int k = 0; k < WIN; ++k) {
    const uint32_t e0 = eq[k * BLOCK];
    const uint32_t pvk = pv[k], mvk = mv[k];
    const uint32_t xv = e0 | mvk;
    const uint32_t e = k == 0 ? e0 : e0 | (prev_mh >> 31);
    const uint32_t xh = (((e & pvk) + pvk) ^ pvk) | e;
    const uint32_t ph = mvk | ~(xh | pvk);
    const uint32_t mh = pvk & xh;
    if (WALK) {
      hp |= ph & rm[k];
      hm |= mh & rm[k];
    }
    const uint32_t phs = __funnelshift_l(prev_ph, ph, 1);
    const uint32_t mhs = __funnelshift_l(prev_mh, mh, 1);
    pv[k] = mhs | ~(xv | phs);
    mv[k] = phs & xv;
    prev_ph = ph;
    prev_mh = mh;
  }
}

// The Peq words of window word w (5 planes, 0 at or past NWp).
__device__ __forceinline__ uint32_t peq_word(const uint32_t* __restrict__ pq,
                                             int NWp, int c, int w) {
  return w < NWp ? pq[c * NWp + w] : 0u;
}

// Stage the window's Peq words (words W0 .. W0 + WIN - 1 of the 5 planes)
// into the thread's slots.
template <int WIN, int BLOCK>
__device__ __forceinline__ void stage_peq(uint32_t* sq,
                                          const uint32_t* __restrict__ pq,
                                          int NWp, int W0) {
#pragma unroll
  for (int c = 0; c < 5; ++c) {
#pragma unroll
    for (int k = 0; k < WIN; ++k)
      sq[((c < 4 ? c : 5) * WIN + k) * BLOCK] =
          peq_word(pq, NWp, c, W0 + k);
  }
}

// Move the staged window down a word: each slot's words move up one place
// in shared memory and word w (the new bottom word) comes in from the table,
// one global load a plane.
template <int WIN, int BLOCK>
__device__ __forceinline__ void shift_peq(uint32_t* sq,
                                          const uint32_t* __restrict__ pq,
                                          int NWp, int w) {
  uint32_t fresh[5];
#pragma unroll
  for (int c = 0; c < 5; ++c) fresh[c] = peq_word(pq, NWp, c, w);
#pragma unroll
  for (int c = 0; c < 5; ++c) {
    uint32_t* slot = sq + (c < 4 ? c : 5) * WIN * BLOCK;
#pragma unroll
    for (int k = 0; k < WIN - 1; ++k) slot[k * BLOCK] = slot[(k + 1) * BLOCK];
    slot[(WIN - 1) * BLOCK] = fresh[c];
  }
}

// Copy text codes 32 p .. 32 p + 31 into the thread's row.
__device__ __forceinline__ void stage_text(uint32_t* row,
                                           const uint8_t* __restrict__ text,
                                           int p) {
  const uint4* src = reinterpret_cast<const uint4*>(text + 32 * p);
  const uint4 a = src[0], b = src[1];
  const uint32_t w[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
  for (int i = 0; i < 8; ++i) row[i] = w[i];
}

template <int WIN, int BLOCK, bool HW>
__global__ void __launch_bounds__(BLOCK)
myers_band_kernel(const uint8_t* __restrict__ pool,
                  const uint32_t* __restrict__ peq,
                  const int* __restrict__ qrow, const int* __restrict__ trow,
                  const int* __restrict__ nlen, const int* __restrict__ mlen,
                  int* __restrict__ out, int* __restrict__ out_ej, int B,
                  int Lp, int L) {
  __shared__ uint32_t speq[kSlots * WIN * BLOCK];
  __shared__ uint32_t stext[kTextWords * BLOCK];
  constexpr int HALF = WIN / 2;
  const int tid = threadIdx.x;
  const int b = blockIdx.x * BLOCK + tid;
  if (b >= B) return;
  const int n = nlen[b];
  const int m = mlen[b];
  const int nword = (n - 1) >> 5;          // floor((n-1)/32)
  const int nbit = (n - 1) & 31;
  const int jlow = max(n - 32 * HALF, 1);  // HW only
  const int NWp = Lp / 32;
  const int nwords = L / 32;
  const uint8_t* text = pool + static_cast<size_t>(trow[b]) * Lp;
  const uint32_t* pq = peq + static_cast<size_t>(qrow[b]) * 5 * NWp;
  uint32_t* sq = speq + tid;
  uint32_t* row = stext + tid * kTextWords;
  const uint8_t* codes = reinterpret_cast<const uint8_t*>(row);
#pragma unroll
  for (int k = 0; k < WIN; ++k) sq[(kZeroSlot * WIN + k) * BLOCK] = 0u;

  uint32_t pv[WIN], mv[WIN];
#pragma unroll
  for (int k = 0; k < WIN; ++k) {
    pv[k] = 0xFFFFFFFFu;
    mv[k] = 0u;
  }
  int top = 0;                 // T: D' on the row above the window
  int anchor = 0, walk = 0, wmin = kWalkBig, wj = 0;   // HW only
  bool entered = false;                                // HW only
  // last column swept (HW: m, or none once m < jlow fixes the answer)
  const int last = HW ? (m < jlow ? 0 : m) : m;
  // past phase nword + HALF, row n's word has left the window (if the
  // window ever moves below it) and nothing changes
  const int pend =
      nword < 0 ? 0
                : min((last + 31) >> 5,
                      nwords - WIN > nword ? nword + HALF + 1 : nwords);
  stage_peq<WIN, BLOCK>(sq, pq, NWp, 0);
  int W0 = 0;
  for (int p = 0; p < pend; ++p) {
    W0 = min(max(p - HALF, 0), nwords - WIN);
    if (p >= HALF + 1 && p <= nwords - WIN + HALF) {   // W0 moved a word
      top += __popc(pv[0]) - __popc(mv[0]);
#pragma unroll
      for (int k = 0; k < WIN - 1; ++k) {
        pv[k] = pv[k + 1];
        mv[k] = mv[k + 1];
      }
      pv[WIN - 1] = 0xFFFFFFFFu;
      mv[WIN - 1] = 0u;
      shift_peq<WIN, BLOCK>(sq, pq, NWp, W0 + WIN - 1);
    }
    stage_text(row, text, p);
    const int ncol = min(32, last - 32 * p);
    // window top: +1, or 0 in HW mode while it sits at row 0 (bit 31 here:
    // word 0's funnel shift carries it in)
    const bool zero_top = HW && W0 == 0;
    const uint32_t hin31 = zero_top ? 0u : 0x80000000u;
    // HW: row n's slot; rsel >= 0 before pend
    const int rsel = nword - W0;
    bool walking = false;
    if (HW) {
      if (rsel < WIN && !entered) {
        anchor = top + rows_to_n<WIN>(pv, mv, rsel, nbit);
        entered = true;
      }
      // The vote is over __activemask(): the lanes of the warp that reach
      // it together.  A lane past its pend has left the phase loop (it
      // waits where the loop ends), so every voter is still in its sweep,
      // and no lane that has left is named in the mask.  The voting lane
      // is always among them: a lane with row n's word in the window runs
      // the walk body whichever other lanes vote with it.
      walking = __any_sync(__activemask(), rsel < WIN);
    }
    if (walking) {
      uint32_t rm[WIN];
#pragma unroll
      for (int k = 0; k < WIN; ++k) rm[k] = k == rsel ? 1u << nbit : 0u;
#pragma unroll 1
      for (int s = 0; s < ncol; ++s) {
        const uint32_t code = codes[s];
        uint32_t hp = 0u, hm = 0u;
        column_step<WIN, BLOCK, true>(
            pv, mv, sq + (code > 5u ? kZeroSlot : code) * (WIN * BLOCK),
            hin31, rm, hp, hm);
        walk += static_cast<int>(hp != 0u) - static_cast<int>(hm != 0u);
        const int j = 32 * p + s + 1;
        if (j >= jlow && walk < wmin) {   // j <= m: the sweep ends at m
          wmin = walk;
          wj = j;
        }
      }
    } else {
      uint32_t rm[WIN], hp, hm;   // not read without the walk
#pragma unroll 2
      for (int s = 0; s < ncol; ++s) {
        const uint32_t code = codes[s];
        column_step<WIN, BLOCK, false>(
            pv, mv, sq + (code > 5u ? kZeroSlot : code) * (WIN * BLOCK),
            hin31, rm, hp, hm);
      }
    }
    if (!zero_top) top += ncol;
  }
  if (HW)
    hw_result(anchor, wmin, wj, n, out, out_ej, b);
  else
    out[b] = pend == 0 ? 0 : top + rows_to_n<WIN>(pv, mv, nword - W0, nbit);
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
    hw_result(base - wn, wmin, wj, n, out, out_ej, b);
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
// Returns cudaErrorInvalidValue for a geometry the kernels do not take or
// a pool that is not 16-byte aligned.
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
  // the band kernel stages a row's text with 16-byte loads
  if (reinterpret_cast<uintptr_t>(pool) % 16) return cudaErrorInvalidValue;
  switch (win) {
    case 0:
      if (Lp / 32 > kMaxFullWords) return cudaErrorInvalidValue;
      myers_full_kernel<HW><<<(B + 127) / 128, 128, 0, s>>>(
          P, Q, qr, tr, nn, mm, o, oj, B, Lp);
      break;
    // blocks shrink with the window so that the stage stays under 48 KB
    case 7:
      launch_band<7, 128, HW>(P, Q, qr, tr, nn, mm, o, oj, B, Lp, L, s);
      break;
    case 9:
      launch_band<9, 128, HW>(P, Q, qr, tr, nn, mm, o, oj, B, Lp, L, s);
      break;
    case 17:
      launch_band<17, 64, HW>(P, Q, qr, tr, nn, mm, o, oj, B, Lp, L, s);
      break;
    case 33:
      launch_band<33, 32, HW>(P, Q, qr, tr, nn, mm, o, oj, B, Lp, L, s);
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
