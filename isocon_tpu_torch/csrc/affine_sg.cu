// K3 + K4: banded affine-gap semi-global alignment (forward DP) and its
// traceback walk, over a sequence pool.
//
// K3 replaces the Pallas TPU kernel isocon_tpu/ops/affine_pallas_c.py::
// _fwd_kernel (sg_align_with_ops_pallas_c); K4 replaces _walk_kernel of the
// same file.  Recurrence, band layout, tie rules, endpoint rule and walk
// state machine are those of isocon_tpu_torch/ops/affine.py
// (sg_forward_plain / sg_walk_plain), the plain versions these kernels are
// held to on every entry anything reads.
//
// What bounds them on the H100.  K3: integer operations.  The function
// needs 20 int32 operations per band cell with sm_90's fused forms (see
// cell() below; chip_smoke.py's AFFINE_OPS_PER_CELL lists them) over
// (n + m - 1) * W cells, W = Wp/2, while it writes one direction byte a cell
// and reads n + m code bytes: the operations outweigh the bytes about four
// times.  Each pair is a chain of n + m - 1 dependent anti-diagonals, so the
// card is kept busy by running many pairs at once.  K4: latency of one
// dependent load per walk step, up to n + m steps per pair (a chain).
//
// Geometry (parity-compacted band, W lanes, every lane a real cell): on
// anti-diagonal d = i + j lane u holds offset o = j - i = 2u + AE on even d
// and 2u + AO on odd d, AE = -(W - 2), AO = AE - 1.  A cell's diagonal
// parent (d-2) is its own lane; on even d its E parent (o-1) is lane u and
// its F parent (o+1) lane u+1, on odd d lane u-1 and lane u; a lane outside
// 0 .. W-1 reads NEG.
//
// The register kernel (Wp = 256, 512, 1024: the bands the engine starts
// at) has two forms, chosen by the launch size.  Launches of more than
// 2 * SMs pairs: one warp per pair, four warps a block, a persistent grid
// whose warps take the next pair from an atomic counter, so a short pair
// does not hold a long one back.  Lane l holds C = W/32 consecutive lanes
// l*C .. l*C + C-1 of the band (its "slots") in registers: H of the last
// even and of the last odd diagonal (H(d-1), H(d-2)), E(d-1) and F(d-1).
// The one neighbour a diagonal needs from the next lane (H and F, even d)
// or the previous one (H and E, odd d) comes with two shuffles.  No shared
// memory and no barrier.  A warp issues some 200 ALU instructions a
// diagonal at Wp 512, so a small launch would leave most of the SMs' four
// schedulers idle: launches of at most 2 * SMs pairs run one pair on the
// four warps of a block instead, each holding C/4 slots a lane; the edge
// cells of each warp go to the next through shared memory, with one
// __syncthreads a diagonal.
//   Codes shift in; they are not fetched per cell.  From even d to odd d+1
//   slot k's q code is slot k-1's and its t code stays; from odd d+1 to even
//   d+2 its q code stays and its t code is slot k+1's.  One code enters at
//   the band's edge each diagonal: t[c] at slot W-1 on even d and q[c] at
//   slot 0 on odd d + 1, c = d/2 + W/2 - 1.  Lane r of the warp holds codes
//   c = 32w + r of a window w of each sequence, the next window loaded one
//   window (64 diagonals) ahead; past a length a code enters as its pad
//   (QPAD / TPAD) when its window is loaded, so no cell tests a length.
//   No per-cell boundary test either: only diagonals d <= W hold cells with
//   |o| >= d (the grid's row 0 and column 0, and cells outside it), so the
//   rules for them run on those diagonals alone.  The endpoint's cells
//   (column m and row n) are read only on the diagonals where they can lie
//   in the band, each by the one lane that holds it, with a compare-select
//   over its slots; the 64-bit keys (score, i, j) are reduced across the
//   warp at the end.  Each lane writes the C direction bytes of a diagonal
//   with one store, so a warp writes a row of dirs[b, d-2, :] at once.
//
// The block kernel (Wp = 2048, 4096, 8192, where C slots would not fit in
// registers; the engine reaches them only by doubling a band that
// overflowed, which no workload has done): one block per pair, one thread per band lane (strided
// when the band has more lanes than the block has threads).  A lane keeps
// its H(d-1), H(d-2), E(d-1), F(d-1) in registers; the neighbour values go
// through shared memory, double-buffered, with one __syncthreads per
// anti-diagonal.  The two sequences are staged in shared memory once.  The
// endpoint is reduced per block with a 64-bit atomicMax on the key.
//
// Both write direction bytes to a global [B, S, W] scratch, the layout K4
// reads.  Parity compaction here is plain index arithmetic, not the TPU's
// two-pairs-per-plane packing, which is not carried over.  K4: one warp
// per pair walks the scratch backward over tiles staged in shared memory
// and writes contiguous opcodes, then the aligned rows they spell (see the
// walk kernel).
#include "isocon_cuda.h"

namespace {

constexpr int NEG = -16000;
constexpr int QPAD = 5;
constexpr int TPAD = 6;
constexpr int H_DIAG = 0, H_FROME = 1, H_FROMF = 2, H_START = 3;
constexpr int OP_NONE = 0, OP_DIAG = 1, OP_GAPQ = 2, OP_GAPT = 3;
constexpr int kMaxThreads = 256;
constexpr int kWarp = 32;
constexpr int kWarpsPerBlock = 4;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ unsigned long long end_key(int v, int i, int j) {
  return (static_cast<unsigned long long>(v + (1 << 20)) << 40) |
         (static_cast<unsigned long long>(i) << 20) |
         static_cast<unsigned long long>(j);
}

// ---------------------------------------------------------------------------
// register kernel: K warps per pair (K = 1 or 4)
// ---------------------------------------------------------------------------
// Between the K warps of a pair, the cells at the edges of each warp's lanes
// go through shared memory, published after each diagonal: after an even
// one lane 31's last slot (H, E, and its q code, which the next warp's first
// slot takes on the odd diagonal), after an odd one lane 0's first slot (H,
// F, and its t code, for the previous warp's last slot).  One barrier a
// diagonal; an even diagonal reads only down[], an odd one only up[], so
// each is rewritten only after every warp has passed the barrier that
// follows its reads.
struct Edge {
  int h, x, code;
};

template <int K>
struct Links {
  Edge up[K];
  Edge down[K];
  unsigned long long best[K];
};

template <int C, int K>
struct Band {
  int ev[C];          // H of the last even diagonal, slots r*C + s
  int od[C];          // H of the last odd diagonal
  int e[C];           // E of the last diagonal
  int f[C];           // F of the last diagonal
  int qc[C];          // q code of each slot on the last diagonal
  int tc[C];          // t code of each slot
  int qwin, qnext;    // q codes 32w + lane of the current window, and next
  int twin, tnext;
  unsigned long long best;   // the best endpoint key this lane has seen
  int lane, wi, r;    // lane, warp of the pair, r = 32 wi + lane
  Links<K>* lk;       // shared by the pair's warps (K > 1)
};

struct Pair {
  const uint8_t* q;
  const uint8_t* t;
  int n, m;
  int ma, mi, go, nge;       // nge: the extension penalty, negated
  uint8_t* dir;              // dirs row of diagonal 2, at this lane's slots
};

__device__ __forceinline__ int q_code(const Pair& p, int i) {
  return i < p.n ? static_cast<int>(p.q[i]) : QPAD;
}

__device__ __forceinline__ int t_code(const Pair& p, int j) {
  return j < p.m ? static_cast<int>(p.t[j]) : TPAD;
}

struct Cell {
  int h, e, f;
  unsigned dir;       // hdir | e_opened << 2 | f_opened << 3
};

// One cell from its parents, in the plain version's order: H is the
// maximum of the unfloored diagonal, E and F, hdir is read from that H
// (diagonal first, then E, then F), and the floors come after (finish).
// With sm_90's fused forms E = max(e_left - ext, h_left - open) is one
// add-max (__viaddmax_s32) and H one max of three (__vimax3_s32); E opened
// (open >= extend) is E == open, as E is the larger of the two.
__device__ __forceinline__ Cell cell(int hpp, int h_left, int e_left,
                                     int h_up, int f_up, int qc, int tc,
                                     const Pair& p) {
  const int diag = hpp + (qc == tc ? p.ma : p.mi);
  const int e_open = h_left - p.go;
  const int e = __viaddmax_s32(e_left, p.nge, e_open);
  const int f_open = h_up - p.go;
  const int f = __viaddmax_s32(f_up, p.nge, f_open);
  const int h = __vimax3_s32(diag, e, f);
  Cell c;
  c.h = h;
  c.e = e;
  c.f = f;
  c.dir = (h == diag ? H_DIAG : (h == e ? H_FROME : H_FROMF)) |
          (e == e_open ? 4u : 0u) | (f == f_open ? 8u : 0u);
  return c;
}

// The boundary rules, on diagonals d <= W only (BOUND): a cell on row 0 or
// column 0 (|o| = d) starts a path (H 0, H_START), a cell outside the grid
// (|o| > d) holds NEG; then the floors.
template <bool BOUND>
__device__ __forceinline__ void finish(Cell& c, int o, int d) {
  if (BOUND) {
    const bool on_b = o == d || o == -d;
    const bool out_g = o > d || o < -d;
    if (on_b) {
      c.h = 0;
      c.dir |= H_START;
    }
    if (out_g) c.h = NEG;
    if (on_b || out_g) {
      c.e = NEG;
      c.f = NEG;
    }
  }
  c.h = max(c.h, NEG);
  c.e = max(c.e, NEG);
  c.f = max(c.f, NEG);
}

// The C direction bytes of this lane's slots, one store.
template <int C>
__device__ __forceinline__ void store_dirs(uint8_t* row,
                                           const unsigned (&w)[(C + 3) / 4]) {
  static_assert(C == 1 || C == 2 || C == 4 || C == 8 || C == 16,
                "C slots: 1, 2, 4, 8 or 16");
  if constexpr (C == 1) {
    *row = static_cast<uint8_t>(w[0]);
  } else if constexpr (C == 2) {
    *reinterpret_cast<uint16_t*>(row) = static_cast<uint16_t>(w[0]);
  } else if constexpr (C == 4) {
    *reinterpret_cast<unsigned*>(row) = w[0];
  } else if constexpr (C == 8) {
    *reinterpret_cast<uint2*>(row) = make_uint2(w[0], w[1]);
  } else {
    *reinterpret_cast<uint4*>(row) = make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// Diagonal d, given the code that enters on it (t[c] on even d, q[c] on
// odd d); row: its dirs row at this lane's slots.
template <int C, int K, bool EVEN, bool BOUND>
__device__ __forceinline__ void advance(Band<C, K>& S, const Pair& p,
                                        int fresh, int d, uint8_t* row) {
  constexpr int W = kWarp * C * K;
  unsigned w[(C + 3) / 4] = {};
  if (EVEN) {
    // t codes move down one slot; the fresh one enters at slot W-1.  Slot
    // k's E parent is odd slot k, its F parent odd slot k+1 (k+1 = W is
    // outside the band)
    int in = __shfl_down_sync(kFull, S.tc[0], 1);
    int h_next = __shfl_down_sync(kFull, S.od[0], 1);
    int f_next = __shfl_down_sync(kFull, S.f[0], 1);
    if (S.lane == kWarp - 1) {
      if (K == 1 || S.wi == K - 1) {
        in = fresh;
        h_next = NEG;
        f_next = NEG;
      } else {
        const Edge x = S.lk->down[S.wi + 1];
        in = x.code;
        h_next = x.h;
        f_next = x.x;
      }
    }
#pragma unroll
    for (int s = 0; s + 1 < C; ++s) S.tc[s] = S.tc[s + 1];
    S.tc[C - 1] = in;
#pragma unroll
    for (int s = 0; s < C; ++s) {
      Cell c = cell(S.ev[s], S.od[s], S.e[s], s + 1 < C ? S.od[s + 1] : h_next,
                    s + 1 < C ? S.f[s + 1] : f_next, S.qc[s], S.tc[s], p);
      finish<BOUND>(c, 2 * (S.r * C + s) - W + 2, d);
      S.ev[s] = c.h;
      S.e[s] = c.e;
      S.f[s] = c.f;
      w[s / 4] |= c.dir << (8 * (s % 4));
    }
  } else {
    // q codes move up one slot; the fresh one enters at slot 0.  Slot k's
    // E parent is even slot k-1 (k-1 = -1 is outside the band), its F
    // parent even slot k
    int in = __shfl_up_sync(kFull, S.qc[C - 1], 1);
    int h_prev = __shfl_up_sync(kFull, S.ev[C - 1], 1);
    int e_prev = __shfl_up_sync(kFull, S.e[C - 1], 1);
    if (S.lane == 0) {
      if (K == 1 || S.wi == 0) {
        in = fresh;
        h_prev = NEG;
        e_prev = NEG;
      } else {
        const Edge x = S.lk->up[S.wi - 1];
        in = x.code;
        h_prev = x.h;
        e_prev = x.x;
      }
    }
#pragma unroll
    for (int s = C - 1; s > 0; --s) S.qc[s] = S.qc[s - 1];
    S.qc[0] = in;
#pragma unroll
    for (int s = C - 1; s >= 0; --s) {
      Cell c = cell(S.od[s], s > 0 ? S.ev[s - 1] : h_prev,
                    s > 0 ? S.e[s - 1] : e_prev, S.ev[s], S.f[s], S.qc[s],
                    S.tc[s], p);
      finish<BOUND>(c, 2 * (S.r * C + s) - W + 1, d);
      S.od[s] = c.h;
      S.e[s] = c.e;
      S.f[s] = c.f;
      w[s / 4] |= c.dir << (8 * (s % 4));
    }
  }
  store_dirs<C>(row, w);
  if constexpr (K > 1) {
    if (EVEN && S.lane == kWarp - 1)
      S.lk->up[S.wi] = Edge{S.ev[C - 1], S.e[C - 1], S.qc[C - 1]};
    if (!EVEN && S.lane == 0)
      S.lk->down[S.wi] = Edge{S.od[0], S.f[0], S.tc[0]};
    __syncthreads();
  }
}

// Slot k's value of X (k the same in every lane), in this lane.
template <int C>
__device__ __forceinline__ int slot_of(const int (&X)[C], int k) {
  int v = X[0];
#pragma unroll
  for (int s = 1; s < C; ++s) v = pick((k & (C - 1)) == s, X[s], v);
  return v;
}

// The endpoint candidates of diagonal d, whose H is X: the column-m cell
// (d - m, m) and the row-n cell (n, d - n), each where it lies in the band,
// into the running maximum of the lane that holds it.
template <int C, int K>
__device__ __forceinline__ void endpoints(Band<C, K>& S, const int (&X)[C],
                                          const Pair& p, int d) {
  constexpr int W = kWarp * C * K;
  const int ap = (d & 1) ? 1 - W : 2 - W;
  if (d >= p.m) {
    const int u = (2 * p.m - d - ap) >> 1;
    if (u >= 0 && u < W && u / C == S.r) {
      const unsigned long long k = end_key(slot_of<C>(X, u), d - p.m, p.m);
      if (k > S.best) S.best = k;
    }
  }
  if (d >= p.n) {
    const int u = (d - 2 * p.n - ap) >> 1;
    if (u >= 0 && u < W && u / C == S.r) {
      const unsigned long long k = end_key(slot_of<C>(X, u), p.n, d - p.n);
      if (k > S.best) S.best = k;
    }
  }
}

// The code windows after code c, the last of its window in both streams:
// move on, and load the window after the next one.
template <int C, int K>
__device__ __forceinline__ void next_window(Band<C, K>& S, const Pair& p,
                                            int c) {
  const int w = ((c >> 5) + 2) * kWarp + S.lane;
  S.qwin = S.qnext;
  S.twin = S.tnext;
  S.qnext = q_code(p, w);
  S.tnext = t_code(p, w);
}

// Diagonal d, anywhere.  BOUND: the boundary rules (d <= W); ENDP: the
// endpoint's cells.
template <int C, int K, bool EVEN, bool BOUND, bool ENDP>
__device__ __forceinline__ void step(Band<C, K>& S, const Pair& p, int d) {
  constexpr int W = kWarp * C * K;
  const int c = (d >> 1) + W / 2 - 1;       // index of the entering code
  const int fresh = __shfl_sync(kFull, EVEN ? S.twin : S.qwin,
                                c & (kWarp - 1));
  advance<C, K, EVEN, BOUND>(S, p, fresh, d,
                             p.dir + static_cast<size_t>(d - 2) * W);
  if (ENDP) {
    if constexpr (EVEN)
      endpoints<C, K>(S, S.ev, p, d);
    else
      endpoints<C, K>(S, S.od, p, d);
  }
  if (!EVEN && (c & (kWarp - 1)) == kWarp - 1) next_window<C, K>(S, p, c);
}

// The 64 diagonals d .. d + 63 from an even d whose entering code c starts
// a window: the code windows need no index arithmetic and no test.
template <int C, int K>
__device__ __forceinline__ void window(Band<C, K>& S, const Pair& p, int d) {
  constexpr int W = kWarp * C * K;
  constexpr int U = C <= 4 ? 4 : (C <= 8 ? 2 : 1);  // (even, odd) unrolled
  uint8_t* row = p.dir + static_cast<size_t>(d - 2) * W;
#pragma unroll 1
  for (int j0 = 0; j0 < kWarp; j0 += U, row += 2 * U * W) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      advance<C, K, true, false>(S, p, __shfl_sync(kFull, S.twin, j0 + u), 0,
                                 row + 2 * u * W);
      advance<C, K, false, false>(S, p, __shfl_sync(kFull, S.qwin, j0 + u),
                                  0, row + (2 * u + 1) * W);
    }
  }
  next_window<C, K>(S, p, (d >> 1) + W / 2 - 1 + kWarp - 1);
}

// Diagonals d .. last, in (even, odd) steps; without the boundary rules or
// the endpoint, in whole windows where it can.
template <int C, int K, bool BOUND, bool ENDP>
__device__ __forceinline__ void run(Band<C, K>& S, const Pair& p, int& d,
                                    int last) {
  constexpr int W = kWarp * C * K;
  if (d > last) return;
  if (d & 1) {
    step<C, K, false, BOUND, ENDP>(S, p, d);
    ++d;
  }
  if (!BOUND && !ENDP) {
#pragma unroll 1
    for (; d < last && (((d >> 1) + W / 2 - 1) & (kWarp - 1)) != 0; d += 2) {
      step<C, K, true, false, false>(S, p, d);
      step<C, K, false, false, false>(S, p, d + 1);
    }
#pragma unroll 1
    for (; d + 2 * kWarp - 1 <= last; d += 2 * kWarp) window<C, K>(S, p, d);
  }
#pragma unroll 1
  for (; d < last; d += 2) {
    step<C, K, true, BOUND, ENDP>(S, p, d);
    step<C, K, false, BOUND, ENDP>(S, p, d + 1);
  }
  if (d == last) {
    step<C, K, true, BOUND, ENDP>(S, p, d);
    ++d;
  }
}

// K = 1: one warp a pair, four a block, a persistent grid whose warps take
// pairs from next_pair.  K = 4: one block of four warps a pair, a pair per
// block in turn (launched for small batches only, where single warps would
// leave schedulers idle).
template <int C, int K>
__global__ void __launch_bounds__(K == 1 ? kWarpsPerBlock * kWarp : K * kWarp)
affine_warp_kernel(const uint8_t* __restrict__ pool,
                   const int* __restrict__ qrow, const int* __restrict__ trow,
                   const int* __restrict__ nlen, const int* __restrict__ mlen,
                   const int* __restrict__ mat, const int* __restrict__ mis,
                   const int* __restrict__ gop, const int* __restrict__ gex,
                   int* __restrict__ best_out, int* __restrict__ ei_out,
                   int* __restrict__ ej_out, uint8_t* __restrict__ dirs,
                   int* next_pair, int B, int Lp, int S) {
  constexpr int W = kWarp * C * K;
  __shared__ Links<K> links;
  Band<C, K> st;
  st.lane = threadIdx.x & (kWarp - 1);
  st.wi = K == 1 ? 0 : threadIdx.x >> 5;
  st.r = st.wi * kWarp + st.lane;
  st.lk = &links;
  const int first_taken = gridDim.x * kWarpsPerBlock;
  int b = K == 1 ? blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5)
                 : blockIdx.x;

  while (b < B) {
    Pair p;
    p.n = nlen[b];
    p.m = mlen[b];
    p.q = pool + static_cast<size_t>(qrow[b]) * Lp;
    p.t = pool + static_cast<size_t>(trow[b]) * Lp;
    p.ma = mat[b];
    p.mi = mis[b];
    p.go = gop[b];
    p.nge = -gex[b];
    p.dir = dirs + static_cast<size_t>(b) * S * W + st.r * C;
    // diagonal 0: (0, 0) = 0 at slot W/2 - 1; diagonal 1: (1, 0) and (0, 1)
    // = 0 at slots W/2 - 1 and W/2; E and F NEG.  The codes of diagonal 1's
    // slots: (i, j) = (W/2 - k, k - W/2 + 1)
#pragma unroll
    for (int s = 0; s < C; ++s) {
      const int k = st.r * C + s;
      st.ev[s] = k == W / 2 - 1 ? 0 : NEG;
      st.od[s] = (k == W / 2 || k == W / 2 - 1) ? 0 : NEG;
      st.e[s] = NEG;
      st.f[s] = NEG;
      st.qc[s] = k < W / 2 ? q_code(p, W / 2 - 1 - k) : QPAD;
      st.tc[s] = k >= W / 2 ? t_code(p, k - W / 2) : TPAD;
    }
    // the first code to enter is c = W/2 (diagonal 2)
    const int w0 = (W / 2) >> 5;
    st.qwin = q_code(p, w0 * kWarp + st.lane);
    st.twin = t_code(p, w0 * kWarp + st.lane);
    st.qnext = q_code(p, (w0 + 1) * kWarp + st.lane);
    st.tnext = t_code(p, (w0 + 1) * kWarp + st.lane);
    st.best = end_key(0, p.n, 0);
    if constexpr (K > 1) {        // diagonal 1, for diagonal 2's reads
      if (st.lane == 0)
        links.down[st.wi] = Edge{st.od[0], st.f[0], st.tc[0]};
      __syncthreads();
    }

    const int dend = p.n + p.m;
    // the first diagonal on which column m or row n can lie in the band
    const int e0 = min(max(p.m, 2 * p.m - W - 1), max(p.n, 2 * p.n - W - 1));
    int d = 2;
    run<C, K, true, true>(st, p, d, min(W, dend));
    run<C, K, false, false>(st, p, d, min(e0 - 1, dend));
    run<C, K, false, true>(st, p, d, dend);
#pragma unroll
    for (int off = kWarp / 2; off > 0; off >>= 1) {
      const unsigned long long k = __shfl_xor_sync(kFull, st.best, off);
      if (k > st.best) st.best = k;
    }
    if constexpr (K > 1) {
      if (st.lane == 0) links.best[st.wi] = st.best;
      __syncthreads();
#pragma unroll
      for (int w = 0; w < K; ++w)
        if (links.best[w] > st.best) st.best = links.best[w];
    }
    if (st.r == 0) {
      best_out[b] = static_cast<int>(st.best >> 40) - (1 << 20);
      ei_out[b] = static_cast<int>((st.best >> 20) & 0xFFFFF);
      ej_out[b] = static_cast<int>(st.best & 0xFFFFF);
    }
    if constexpr (K == 1) {
      int nb = 0;
      if (st.lane == 0) nb = atomicAdd(next_pair, 1) + first_taken;
      b = __shfl_sync(kFull, nb, 0);
    } else {
      b += gridDim.x;
    }
  }
}

// ---------------------------------------------------------------------------
// block kernel: one block per pair (Wp >= 2048)
// ---------------------------------------------------------------------------
template <int LPT>
__global__ void __launch_bounds__(kMaxThreads)
affine_fwd_kernel(const uint8_t* __restrict__ pool,
                  const int* __restrict__ qrow, const int* __restrict__ trow,
                  const int* __restrict__ nlen, const int* __restrict__ mlen,
                  const int* __restrict__ mat, const int* __restrict__ mis,
                  const int* __restrict__ gop, const int* __restrict__ gex,
                  int* __restrict__ best_out, int* __restrict__ ei_out,
                  int* __restrict__ ej_out, uint8_t* __restrict__ dirs,
                  int Lp, int Wp, int S) {
  extern __shared__ unsigned char smem[];
  const int W = Wp / 2;
  const int AE = -(Wp / 2 - 2);
  const int AO = AE - 1;
  int* sH = reinterpret_cast<int*>(smem);          // [2][W]
  int* sX = sH + 2 * W;                            // [2][W]: E (even d) / F (odd d)
  unsigned long long* sbest =
      reinterpret_cast<unsigned long long*>(sX + 2 * W);
  uint8_t* sq = reinterpret_cast<uint8_t*>(sbest + 1);
  uint8_t* st = sq + Lp;

  const int b = blockIdx.x;
  const int T = blockDim.x;
  const int tid = threadIdx.x;
  const int n = nlen[b];
  const int m = mlen[b];
  const int ma = mat[b], mi = mis[b], go = gop[b], ge = gex[b];
  const uint8_t* qg = pool + static_cast<size_t>(qrow[b]) * Lp;
  const uint8_t* tg = pool + static_cast<size_t>(trow[b]) * Lp;
  for (int x = tid; x < n; x += T) sq[x] = qg[x];
  for (int x = tid; x < m; x += T) st[x] = tg[x];

  const int u1 = Wp / 4;
  int Hp[LPT], Hpp[LPT], Ep[LPT], Fp[LPT];
#pragma unroll
  for (int l = 0; l < LPT; ++l) {
    const int u = tid + l * T;
    Hp[l] = (u == u1 || u == u1 - 1) ? 0 : NEG;   // d = 1
    Hpp[l] = (u == u1 - 1) ? 0 : NEG;             // d = 0
    Ep[l] = NEG;
    Fp[l] = NEG;
    sH[W + u] = Hp[l];
    sX[W + u] = NEG;                              // F at d = 1
  }
  unsigned long long mybest = end_key(0, n, 0);
  if (tid == 0) *sbest = mybest;
  __syncthreads();

  uint8_t* drow = dirs + static_cast<size_t>(b) * S * W;
  const int dend = n + m;
  for (int d = 2; d <= dend; ++d) {
    const bool even = (d & 1) == 0;
    const int ap = even ? AE : AO;
    const int rb = ((d - 1) & 1) * W;
    const int wb = (d & 1) * W;
    const int u_col = (2 * m - d - ap) >> 1;
    const int u_row = (d - 2 * n - ap) >> 1;
#pragma unroll
    for (int l = 0; l < LPT; ++l) {
      const int u = tid + l * T;
      const int o = 2 * u + ap;
      const int i = (d - o) >> 1;
      const int j = (d + o) >> 1;
      const int qc = (i >= 1 && i <= n) ? sq[i - 1] : QPAD;
      const int tc = (j >= 1 && j <= m) ? st[j - 1] : TPAD;
      const int sub = qc == tc ? ma : mi;
      int h_left, e_left, h_up, f_up;
      if (even) {
        h_left = Hp[l];
        e_left = Ep[l];
        h_up = u + 1 < W ? sH[rb + u + 1] : NEG;
        f_up = u + 1 < W ? sX[rb + u + 1] : NEG;
      } else {
        h_left = u > 0 ? sH[rb + u - 1] : NEG;
        e_left = u > 0 ? sX[rb + u - 1] : NEG;
        h_up = Hp[l];
        f_up = Fp[l];
      }
      const int e_open = h_left - go, e_ext = e_left - ge;
      int E = max(e_open, e_ext);
      const int e_opened = e_open >= e_ext;
      const int f_open = h_up - go, f_ext = f_up - ge;
      int F = max(f_open, f_ext);
      const int f_opened = f_open >= f_ext;
      const int diag = Hpp[l] + sub;
      int H = max(max(diag, E), F);
      int hdir = H == diag ? H_DIAG : (H == E ? H_FROME : H_FROMF);
      const bool on_b = (o == d) || (o == -d);
      const bool out_g = (o > d) || (o < -d);
      if (on_b) {
        H = 0;
        hdir = H_START;
      }
      if (out_g) H = NEG;
      if (out_g || on_b) {
        E = NEG;
        F = NEG;
      }
      H = max(H, NEG);
      E = max(E, NEG);
      F = max(F, NEG);
      drow[static_cast<size_t>(d - 2) * W + u] =
          static_cast<uint8_t>(hdir | (e_opened << 2) | (f_opened << 3));
      if (u == u_col && d >= m) {
        const unsigned long long k = end_key(H, d - m, m);
        if (k > mybest) mybest = k;
      }
      if (u == u_row && d >= n) {
        const unsigned long long k = end_key(H, n, d - n);
        if (k > mybest) mybest = k;
      }
      Hpp[l] = Hp[l];
      Hp[l] = H;
      Ep[l] = E;
      Fp[l] = F;
      sH[wb + u] = H;
      sX[wb + u] = even ? E : F;
    }
    __syncthreads();
  }
  atomicMax(sbest, mybest);
  __syncthreads();
  if (tid == 0) {
    const unsigned long long k = *sbest;
    best_out[b] = static_cast<int>(k >> 40) - (1 << 20);
    ei_out[b] = static_cast<int>((k >> 20) & 0xFFFFF);
    ej_out[b] = static_cast<int>(k & 0xFFFFF);
  }
}

// The card's SM count, read once: the process drives one card.
int sm_count() {
  static const int sms = [] {
    int dev = 0, v = 0;
    if (cudaGetDevice(&dev) == cudaSuccess)
      cudaDeviceGetAttribute(&v, cudaDevAttrMultiProcessorCount, dev);
    return v;
  }();
  return sms;
}

// ---------------------------------------------------------------------------
// walk kernel (K4): one warp per pair over staged tiles of direction bytes
// ---------------------------------------------------------------------------
// The walk is one chain of dependent byte reads: the byte at (d, o) picks
// the next (d, o).  It reads lane u = clamp((o - ap) >> 1) of row
// dd = d - 2, and a step moves d down by 1 or 2 and u by at most one lane
// over any two diagonals (even d -> odd d - 1: u or u + 1; odd -> even: u or
// u - 1; a diagonal step keeps u; the clamp cannot add drift).  So a tile
// of TD rows (dd0 - TD, dd0] by the lanes u0 - TD/2 .. u0 + TD/2, anchored
// at the step that left the last tile, holds every byte the walk reads
// until it leaves those rows: a pair loads at most ceil(S / TD) + 1 tiles
// (tests/test_torch_walk_tiles.py emulates this addressing on the CPU).
// The tile's lane window starts on a 16-byte boundary (TD + 16 lanes) and
// lies inside [0, W); the whole warp copies it with 16-byte cp.async, one
// round trip to device memory for TD rows, and the chain then waits on
// shared memory instead.  All 32 lanes run the state machine in lockstep on
// the same values and read the same shared byte (a broadcast), so no lane
// diverges.  A step is straight-line code with one branch, the loop's: the
// state machine as selects (sg_walk_plain's form).  Written as branches,
// with a tile test and a ring test a step, it took some 350 cycles a step;
// as it is, some 140 (clock64 per warp on an H100, PERF.md).  Opcodes
// collect in a 128-byte ring in shared memory that the warp writes out
// every 128 steps and at the end, 32 consecutive bytes a store
// instruction.  A persistent grid of four warps a block takes pairs from
// an atomic counter, so a launch of a few pairs still spreads over the SMs
// and a short walk does not hold a long one back.  The warp then turns the
// walk into the pair's two aligned rows (aligned_rows, below) before it
// takes the next pair.
constexpr int kRing = 128;

// The letter of a base code in the aligned rows (encode.decode_seq's:
// A C G T N, X for any other code).
__device__ __forceinline__ int base_letter(int code) {
  return code < 4 ? (0x54474341u >> (8 * code)) & 0xFF
                  : (code == 5 ? 'N' : 'X');
}

// K4's epilogue (plain version: affine.py's sg_rows_plain): the walk's
// two aligned rows, the bytes ops_to_alignment_counts builds on the host,
//   a1 = "-" * fj + q[:fi] + mid1 + q[ei:] + "-" * (m - ej)
//   a2 = t[:fj] + "-" * fi + mid2 + "-" * (n - ei) + t[ej:]
// with the mid the walk's K steps in forward order, and its matches and
// mismatches.  The warp covers 32 consecutive positions of the rows at a
// time, a lane each, and stores them with one instruction a row.  In the
// mid a lane reads its opcode back from the walk's row (just written: read
// from L2, past L1), and the query and target positions it consumes come
// from a prefix count over the lanes below it (ballot and popc) plus those
// the chunks before consumed.  q, t: the pair's pool rows; the counts
// return on every lane.
__device__ __forceinline__ void aligned_rows(
    const uint8_t* orow, int K, const uint8_t* __restrict__ q,
    const uint8_t* __restrict__ t, int n, int m, int ei, int ej, int fi,
    int fj, uint8_t* __restrict__ r1, uint8_t* __restrict__ r2, int lane,
    int& nmat, int& nmis) {
  const int p2 = fi + fj, p3 = p2 + K, p4 = p3 + (n - ei);
  const int A = p4 + (m - ej);
  const unsigned below = (1u << lane) - 1;
  int qn = fi, tn = fj;          // the mid's next query / target position
  int mat = 0, mis = 0;
  for (int base = 0; base < A; base += kWarp) {
    const int pos = base + lane;
    const bool mid = pos >= p2 && pos < p3;
    // forward step pos - p2 of the mid is the walk's step p3 - 1 - pos
    const int op = mid ? __ldcg(orow + (p3 - 1 - pos)) : OP_NONE;
    const bool uq = op == OP_DIAG || op == OP_GAPT;
    const bool ut = op == OP_DIAG || op == OP_GAPQ;
    const unsigned bq = __ballot_sync(kFull, uq);
    const unsigned bt = __ballot_sync(kFull, ut);
    const int qi = qn + __popc(bq & below);
    const int ti = tn + __popc(bt & below);
    qn += __popc(bq);
    tn += __popc(bt);
    if (pos < A) {
      int c1 = '-', c2 = '-';
      if (pos < fj) {
        c2 = base_letter(t[pos]);
      } else if (pos < p2) {
        c1 = base_letter(q[pos - fj]);
      } else if (mid) {
        if (uq) c1 = base_letter(q[qi]);
        if (ut) c2 = base_letter(t[ti]);
        if (op == OP_DIAG) {
          mat += c1 == c2;
          mis += c1 != c2;
        }
      } else if (pos < p4) {
        c1 = base_letter(q[ei + pos - p3]);
      } else {
        c2 = base_letter(t[ej + pos - p4]);
      }
      r1[pos] = static_cast<uint8_t>(c1);
      r2[pos] = static_cast<uint8_t>(c2);
    }
  }
  nmat = __reduce_add_sync(kFull, mat);
  nmis = __reduce_add_sync(kFull, mis);
}

// The pairs' sequences and the rows' outputs of the epilogue.
struct RowArgs {
  const uint8_t* pool;
  const int *qrow, *trow, *n, *m;
  uint8_t *a1, *a2;
  int *alen, *nmat, *nmis;
  int Lp;
};

template <int TD>
__global__ void __launch_bounds__(kWarpsPerBlock * kWarp)
affine_walk_kernel(const uint8_t* __restrict__ dirs,
                   const int* __restrict__ ei, const int* __restrict__ ej,
                   uint8_t* __restrict__ ops, int* __restrict__ fi_out,
                   int* __restrict__ fj_out, int* __restrict__ ov_out,
                   int* next_pair, int B, int S, int Wp, int nops,
                   const RowArgs rows) {
  constexpr int WL = TD + 16;             // lanes of a tile row
  constexpr int CH = WL / 16;             // 16-byte chunks of a tile row
  constexpr int COPIES = TD * CH / kWarp; // chunks a lane copies
  static_assert(TD * CH % kWarp == 0, "a tile is whole chunks a lane");
  // indexed directly (not through a generic pointer), so that a step's
  // shared-memory address is plain arithmetic
  __shared__ __align__(16) uint8_t tiles[kWarpsPerBlock][TD * WL];
  __shared__ uint8_t rings[kWarpsPerBlock][kRing];
  const int wi = threadIdx.x >> 5;
  const int lane = threadIdx.x & (kWarp - 1);
  const int W = Wp / 2;
  const int AE = -(Wp / 2 - 2);
  const int AO = AE - 1;
  const int o_lo = AO;
  const int first_taken = gridDim.x * kWarpsPerBlock;
  int b = blockIdx.x * kWarpsPerBlock + wi;

  while (b < B) {
    const uint8_t* drow = dirs + static_cast<size_t>(b) * S * W;
    uint8_t* orow = ops + static_cast<size_t>(b) * nops;
    int i = ei[b], j = ej[b], st = 0, ov = 0;
    // the tile holds rows top - TD + 1 .. top, lanes ulo .. ulo + WL - 1
    int top = -1, ulo = 0;
    int k = 0;
    bool active = i > 0 && j > 0;
    while (active && k < nops) {
      // the step's read: row dd, lane u.  (o - ap) >> 1 with ap = AO on
      // odd d and AE on even d is (o - AE + 1) >> 1: o and d have the same
      // parity and AE is even.
      int o = j - i;
      int u = min(max((o - AE + 1) >> 1, 0), W - 1);
      int dd = min(max(i + j - 2, 0), S - 1);
      if (static_cast<unsigned>(top - dd) >= static_cast<unsigned>(TD) ||
          static_cast<unsigned>(u - ulo) >= static_cast<unsigned>(WL)) {
        top = dd;
        ulo = min(max(u - TD / 2, 0) & ~15, W - WL);
        const uint8_t* src = drow + ulo;
        __syncwarp();                // every lane is done with the old tile
        // straight into shared memory (cp.async, 16 bytes a copy, no
        // registers), all copies of the tile in flight at once
#pragma unroll
        for (int s = 0; s < COPIES; ++s) {
          const int c = s * kWarp + lane;
          const int row = top - TD + 1 + c / CH;
          if (row >= 0) {            // rows below 0 are never read
            const unsigned dst = static_cast<unsigned>(
                __cvta_generic_to_shared(&tiles[wi][c * 16]));
            asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::
                             "r"(dst),
                         "l"(src + static_cast<size_t>(row) * W + c % CH * 16)
                         : "memory");
          }
        }
        asm volatile("cp.async.wait_all;\n" ::: "memory");
        __syncwarp();
      }
      // steps until the walk leaves the tile, ends or fills the ring: one
      // branch a step.  The state machine is sg_walk_plain's, as selects.
      const int ring_end = min((k | (kRing - 1)) + 1, nops);
      do {
        if (o <= o_lo || o >= o_lo + Wp - 1) ov = 1;
        const int bits = tiles[wi][(dd - top + TD - 1) * WL + (u - ulo)];
        const int hd = bits & 3;
        const bool e_opened = (bits & 4) != 0;
        const bool f_opened = (bits & 8) != 0;
        const bool in_h = st == 0;
        const bool hit_start = in_h && hd == H_START;
        const bool act_diag = in_h && hd == H_DIAG;
        const bool act_e = (in_h && hd == H_FROME) || st == 1;
        const bool act_f = (in_h && hd == H_FROMF) || st == 2;
        const int op = act_diag ? OP_DIAG
                       : act_e  ? OP_GAPQ
                       : act_f  ? OP_GAPT
                                : OP_NONE;
        rings[wi][k & (kRing - 1)] = static_cast<uint8_t>(op);
        i -= (act_diag || act_f) ? 1 : 0;
        j -= (act_diag || act_e) ? 1 : 0;
        st = hit_start ? 3
             : act_diag ? 0
             : act_e    ? (e_opened ? 0 : 1)
             : act_f    ? (f_opened ? 0 : 2)
                        : st;
        ++k;
        active = i > 0 && j > 0 && st != 3;
        o = j - i;
        u = min(max((o - AE + 1) >> 1, 0), W - 1);
        dd = min(max(i + j - 2, 0), S - 1);
      } while (active && k < ring_end &&
               static_cast<unsigned>(top - dd) < static_cast<unsigned>(TD) &&
               static_cast<unsigned>(u - ulo) < static_cast<unsigned>(WL));
      if ((k & (kRing - 1)) == 0) {  // the ring is full: write it out
        __syncwarp();
#pragma unroll
        for (int s = 0; s < kRing; s += kWarp)
          orow[k - kRing + s + lane] = rings[wi][s + lane];
        __syncwarp();
      }
    }
    __syncwarp();
    const int base = k & ~(kRing - 1);
    for (int s = lane; s < k - base; s += kWarp)
      orow[base + s] = rings[wi][s];
    // the rows need the whole opcode row: every lane's stores are seen by
    // the warp after the barrier
    __syncwarp();
    int alen = 0, nmat = 0, nmis = 0;
    if (!ov) {
      const int n = rows.n[b], m = rows.m[b];
      const int e_i = ei[b], e_j = ej[b];
      const size_t w = static_cast<size_t>(nops - 1);
      // a walk that ended on a boundary cell took a last step of OP_NONE
      aligned_rows(orow, k - (st == 3),
                   rows.pool + static_cast<size_t>(rows.qrow[b]) * rows.Lp,
                   rows.pool + static_cast<size_t>(rows.trow[b]) * rows.Lp,
                   n, m, e_i, e_j, i, j, rows.a1 + b * w, rows.a2 + b * w,
                   lane, nmat, nmis);
      alen = i + j + (k - (st == 3)) + (n - e_i) + (m - e_j);
    }
    if (lane == 0) {
      fi_out[b] = i;
      fj_out[b] = j;
      ov_out[b] = ov;
      rows.alen[b] = alen;
      rows.nmat[b] = nmat;
      rows.nmis[b] = nmis;
    }
    int nb = 0;
    if (lane == 0) nb = atomicAdd(next_pair, 1) + first_taken;
    b = __shfl_sync(kFull, nb, 0);   // also: the ring is free again
  }
}

template <int TD>
int launch_walk(const uint8_t* dirs, const int* ei, const int* ej,
                uint8_t* ops, int* fi, int* fj, int* ov, int* counter, int B,
                int S, int Wp, int nops, const RowArgs& rows,
                cudaStream_t stream) {
  auto kernel = affine_walk_kernel<TD>;
  constexpr int threads = kWarpsPerBlock * kWarp;
  static const int per_sm = [=] {
    int v = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&v, kernel, threads, 0);
    return v;
  }();
  const int sms = sm_count();
  if (sms <= 0 || per_sm <= 0) return cudaErrorInvalidConfiguration;
  const cudaError_t rc = cudaMemsetAsync(counter, 0, sizeof(int), stream);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  const int needed = (B + kWarpsPerBlock - 1) / kWarpsPerBlock;
  const int resident = sms * per_sm;
  const int grid = needed < resident ? needed : resident;
  kernel<<<grid, threads, 0, stream>>>(dirs, ei, ej, ops, fi, fj, ov,
                                       counter, B, S, Wp, nops, rows);
  return isocon_launch_status();
}

// The forward kernels' arguments, typed once.
struct FwdArgs {
  const uint8_t* pool;
  const int *qrow, *trow, *n, *m, *mat, *mis, *gop, *gex;
  int *best, *ei, *ej;
  uint8_t* dirs;
};

template <int LPT>
int launch_fwd(const FwdArgs& a, int B, int Lp, int Wp, int S,
               cudaStream_t stream) {
  const int W = Wp / 2;
  const int T = W / LPT;
  const size_t smem = 16 * static_cast<size_t>(W) + 8 + 2 * Lp;
  auto* kern = affine_fwd_kernel<LPT>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kern<<<B, T, smem, stream>>>(a.pool, a.qrow, a.trow, a.n, a.m, a.mat,
                               a.mis, a.gop, a.gex, a.best, a.ei, a.ej,
                               a.dirs, Lp, Wp, S);
  return isocon_launch_status();
}

template <int C, int K>
int launch_warp(const FwdArgs& a, int* counter, int B, int Lp, int S,
                cudaStream_t stream) {
  auto kernel = affine_warp_kernel<C, K>;
  constexpr int threads = K == 1 ? kWarpsPerBlock * kWarp : K * kWarp;
  // resident blocks an SM, fixed for the instantiation
  static const int per_sm = [=] {
    int v = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&v, kernel, threads, 0);
    return v;
  }();
  const int sms = sm_count();
  if (sms <= 0 || per_sm <= 0) return cudaErrorInvalidConfiguration;
  if (K == 1) {
    const cudaError_t rc = cudaMemsetAsync(counter, 0, sizeof(int), stream);
    if (rc != cudaSuccess) return static_cast<int>(rc);
  }
  const int needed = K == 1 ? (B + kWarpsPerBlock - 1) / kWarpsPerBlock : B;
  const int resident = sms * per_sm;
  const int grid = needed < resident ? needed : resident;
  kernel<<<grid, threads, 0, stream>>>(a.pool, a.qrow, a.trow, a.n, a.m,
                                       a.mat, a.mis, a.gop, a.gex, a.best,
                                       a.ei, a.ej, a.dirs, counter, B, Lp,
                                       S);
  return isocon_launch_status();
}

// The register kernel for a band of 32 * C4 * 4 cells, with `warps` warps a
// pair (4 or 1); warps 0 picks 4 for launches of at most 2 * SMs pairs and
// 1 above.  Timed at B 66-917 (PERF.md): four warps a pair win up to
// 2 * SMs at Wp 256, 512 and 1024 (at 1024 up to 3 * SMs), one warp at
// Wp 512 from 2.5 * SMs and at Wp 256 from 4 * SMs; two warps a pair won
// nowhere by more than the spread of the readings.
template <int C4>
int launch_register(const FwdArgs& a, int* counter, int B, int Lp, int S,
                    int warps, cudaStream_t stream) {
  if (warps == 0) warps = B <= 2 * sm_count() ? 4 : 1;
  switch (warps) {
    case 4: return launch_warp<C4, 4>(a, counter, B, Lp, S, stream);
    case 1: return launch_warp<4 * C4, 1>(a, counter, B, Lp, S, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Forward DP.  Wp = 256, 512, 1024 run the register kernel, Wp = 2048,
// 4096, 8192 the block kernel; any other band returns
// cudaErrorInvalidValue.  S >= max(n + m) - 1 is the diagonal count of the
// dirs scratch [B, S, Wp/2]; Lp % 8 == 0.  counter: one int32 of device
// memory, the register kernel's pair counter (zeroed here; every call
// passes it).  warps: the register kernel's warps a pair, 1 or 4, or 0 to
// let the launch size choose (as the engine does); the block kernel takes
// 0 only.
ISOCON_API int isocon_affine_fwd(const void* pool, const void* qrow,
                                 const void* trow, const void* n,
                                 const void* m, const void* mat,
                                 const void* mis, const void* gop,
                                 const void* gex, void* best, void* ei,
                                 void* ej, void* dirs, void* counter, int B,
                                 int Lp, int Wp, int S, int warps,
                                 void* stream) {
  const FwdArgs a = {
      static_cast<const uint8_t*>(pool), static_cast<const int*>(qrow),
      static_cast<const int*>(trow), static_cast<const int*>(n),
      static_cast<const int*>(m), static_cast<const int*>(mat),
      static_cast<const int*>(mis), static_cast<const int*>(gop),
      static_cast<const int*>(gex), static_cast<int*>(best),
      static_cast<int*>(ei), static_cast<int*>(ej),
      static_cast<uint8_t*>(dirs)};
  auto s = static_cast<cudaStream_t>(stream);
  auto* c = static_cast<int*>(counter);
  if (B <= 0) return 0;
  if (Lp % 8 || S < 1 || !counter) return cudaErrorInvalidValue;
  if (Wp >= 2048 && warps != 0) return cudaErrorInvalidValue;
  switch (Wp) {
    case 256: return launch_register<1>(a, c, B, Lp, S, warps, s);
    case 512: return launch_register<2>(a, c, B, Lp, S, warps, s);
    case 1024: return launch_register<4>(a, c, B, Lp, S, warps, s);
    case 2048: return launch_fwd<4>(a, B, Lp, Wp, S, s);
    case 4096: return launch_fwd<8>(a, B, Lp, Wp, S, s);
    case 8192: return launch_fwd<16>(a, B, Lp, Wp, S, s);
    default: return cudaErrorInvalidValue;
  }
}

// Traceback walk over the dirs scratch [B, S, Wp/2] that isocon_affine_fwd
// wrote, for the bands it accepts (Wp = 256 .. 8192); ops [B, nops] must
// arrive zeroed (OP_NONE): the walk writes only the steps it takes.
// tile_rows: the rows of a staged tile, 64 (the only size compiled; the
// wrapper's WALK_TILE_ROWS).  counter: one int32 of device memory, the
// pair counter of the persistent grid (zeroed here).  dirs must be 16-byte
// aligned.  The epilogue writes each pair's aligned rows into a1, a2
// [B, nops - 1] (uint8; the bytes past a row's length are left as they
// are) and its length, matches and mismatches into alen, nmat, nmis [B]
// (int32; zeros for a pair whose walk overflowed, whose rows are left as
// they are), reading the query and target from the pool [R, Lp] at rows
// qrow, trow with lengths n, m (int32 [B]); nops must exceed max(n + m).
// Anything else returns cudaErrorInvalidValue.
ISOCON_API int isocon_affine_walk(const void* dirs, const void* ei,
                                  const void* ej, void* ops, void* fi,
                                  void* fj, void* ov, void* counter,
                                  const void* pool, const void* qrow,
                                  const void* trow, const void* n,
                                  const void* m, void* a1, void* a2,
                                  void* alen, void* nmat, void* nmis, int B,
                                  int S, int Wp, int nops, int tile_rows,
                                  int Lp, void* stream) {
  if (B <= 0) return 0;
  if (S < 1 || !counter || reinterpret_cast<uintptr_t>(dirs) % 16)
    return cudaErrorInvalidValue;
  const RowArgs rows = {
      static_cast<const uint8_t*>(pool), static_cast<const int*>(qrow),
      static_cast<const int*>(trow),     static_cast<const int*>(n),
      static_cast<const int*>(m),        static_cast<uint8_t*>(a1),
      static_cast<uint8_t*>(a2),         static_cast<int*>(alen),
      static_cast<int*>(nmat),           static_cast<int*>(nmis),
      Lp};
  if (!pool || !qrow || !trow || !n || !m || !a1 || !a2 || !alen || !nmat ||
      !nmis || Lp < 1 || nops < 1)
    return cudaErrorInvalidValue;
  switch (Wp) {
    case 256: case 512: case 1024: case 2048: case 4096: case 8192: break;
    default: return cudaErrorInvalidValue;
  }
  if (tile_rows != 64) return cudaErrorInvalidValue;
  return launch_walk<64>(
      static_cast<const uint8_t*>(dirs), static_cast<const int*>(ei),
      static_cast<const int*>(ej), static_cast<uint8_t*>(ops),
      static_cast<int*>(fi), static_cast<int*>(fj), static_cast<int*>(ov),
      static_cast<int*>(counter), B, S, Wp, nops, rows,
      static_cast<cudaStream_t>(stream));
}
