// K6: the sketch scores of the approximate NN graph (--nontargeted) and
// each row's top-k of them.
//
// Replaces isocon_tpu/graph/sketch.py::_topn_scores (a jax.jit of jnp.dot
// and lax.top_k, not a pl.pallas_call).  With p the square-rooted k-mer
// profiles (float32 [N, D]) and len the read lengths:
//
//   score(i, j) = acc(i, j) - float(|len[i] - len[j]|)   (- 1e9f if i == j)
//   acc(i, j)   = fmaf(p[i][D-1], p[j][D-1], ... fmaf(p[i][0], p[j][0], 0.0f))
//
// Each entry's sum is ONE in-order chain of IEEE fused multiply-adds over
// d = 0 .. D-1 from 0.0f (__fmaf_rn, never split, never reordered), the
// order XLA:CPU's dot takes at 3,000 rows and the one the plain version
// (ops/sketch.py::sketch_scores_plain, exact fmaf emulated in float64) is
// held to bit for bit.  The scores decide which top-k neighbours each read
// gets, so their rounding is part of the result.  That is why no tensor
// core runs here: an MMA (mma.sync, wgmma, TF32 or not) accumulates in its
// own order and precision, not as sequential IEEE FMA, and a library GEMM
// splits and blocks the sum.  The two subtractions are the JAX function's,
// each rounded in float32 (__fsub_rn).
//
// Three entries share one tile kernel:
//   isocon_sketch_topn   the first pass of the function: for every row, the
//                        k best (score, column) of each of nseg column
//                        segments, [N, nseg, k], each list in descending
//                        order with the lower column first among equal
//                        scores (lax.top_k's order);
//   isocon_sketch_merge  the second pass: each row's nseg lists merged into
//                        its k best, [N, k];
//   isocon_sketch_scores the same tile code storing the scores ([rows, N])
//                        instead of selecting from them; for checking the
//                        chain on every entry, not on the main path.
// The key (score descending, column ascending) is a strict total order on
// a row's candidates, so the lists are unique whatever order the blocks
// run in: no atomics, nothing nondeterministic.  Scores compare as floats
// (+0.0 == -0.0, as torch.sort holds them).
//
// What bounds it on the H100: float32 FMA.  N^2 * D FMA over 132 SMs x 128
// FP32 lanes x the clock: 1.53 ms at N = 10,000, D = 512, 1,980 MHz; the
// first pass moves p (20 MB) and its [N, nseg, k] lists (16 MB at nseg 10),
// 0.01 ms at 3.35 TB/s.  The [N, N] scores never reach device memory.  So
// the design keeps the FMA pipe fed and the selection off it:
// - a block computes 128 x 128 scores, a thread 8 x 8 of them in registers
//   (rows 4ty .. 4ty + 3 and 64 + 4ty .. 64 + 4ty + 3, columns likewise
//   with tx, 256 threads): a step of d is four 16-byte shared loads for 64
//   FMA (the rows' loads are broadcasts: a warp spans two values of ty);
// - the d-slices are staged 32 values of d at a time with cp.async from
//   p^T (float32 [D, ld], made by the wrapper, zero-padded to a multiple of
//   128 columns), so a slice of 128 rows or columns is 32 contiguous rows of
//   512 bytes, d-major, and the copy needs no registers; two stages, the
//   next slice in flight while the chain runs on this one;
// - a block walks its segment's column tiles for one strip of 128 rows and
//   keeps each row's 32 best (score, column) so far in shared memory,
//   sorted.  At a tile's end its scores go to shared memory (the stages'
//   64 KB) and a warp takes a row at a time, 32 columns a step: one compare
//   a column against the row's k-th pair and one vote discard most of them;
//   up to 32 passing columns are ranked against the list and each other
//   (each broadcast once) and written to their new slots, more are sorted
//   (bitonic sorts across the warp, the tile's four groups of 32 at once)
//   and merged into the list (the elementwise maximum of two sorted lists,
//   one reversed, then a bitonic merge);
// - two blocks fit on an SM (98 KB of shared memory, at most 128 registers
//   a thread), so one block's selection overlaps the other's chain.
//
// K7 (isocon_kmer_profile, at the end of this file) builds p itself from
// the reads' bytes.  Its kernel's name holds no "sketch_": the benchmark's
// sketch_roofline reads the kernels so named, and counts K6's work alone.
#include <climits>

#include "isocon_cuda.h"

namespace {

constexpr int kTile = 128;                 // rows and columns of a tile
constexpr int kDepth = 32;                 // values of d a stage
constexpr int kThreads = 256;              // 16 x 16, 8 x 8 outputs each
constexpr int kSlots = 32;                 // a row's list, one slot a lane
constexpr int kStageFloats = 2 * kDepth * kTile;          // A and B slices
constexpr size_t kStageBytes = 2 * kStageFloats * sizeof(float);  // 64 KB
constexpr size_t kListBytes =
    (kTile * kSlots + kThreads) * (sizeof(float) + sizeof(int));
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMergeWarps = 8;

// -inf, the score of a pad (INT_MAX its column)
__device__ __forceinline__ float neg_inf() {
  return __int_as_float(0xff800000);
}

__device__ __forceinline__ bool beats(float v, int i, float w, int j) {
  return v > w || (v == w && i < j);
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

// Stage slice g (tile t0 + g / nsl, d from (g % nsl) * kDepth) of the A
// rows and the B columns into stage buffer `buf`: 32 rows of d x 128
// floats each, 16 bytes a copy, four copies of each a thread.
__device__ __forceinline__ void stage_slice(
    float* buf, const float* __restrict__ at, const float* __restrict__ bt,
    int lda, int ldb, int i0, int t0, int nsl, int g, int tid) {
  const int j0 = (t0 + g / nsl) * kTile;
  const int d0 = (g % nsl) * kDepth;
  float* sa = buf;
  float* sb = buf + kDepth * kTile;
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    const int q = tid + m * kThreads;
    const int dd = q / 32;
    const int c = (q % 32) * 4;
    cp_async16(sa + dd * kTile + c,
               at + static_cast<size_t>(d0 + dd) * lda + i0 + c);
    cp_async16(sb + dd * kTile + c,
               bt + static_cast<size_t>(d0 + dd) * ldb + j0 + c);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// compare-exchange with the lane `stride` away: keep the better of the two
// pairs if take_better, else the worse (equal pairs are the same pad)
__device__ __forceinline__ void exchange(float& v, int& i, int stride,
                                         bool take_better) {
  const float pv = __shfl_xor_sync(kFull, v, stride);
  const int pi = __shfl_xor_sync(kFull, i, stride);
  if (beats(pv, pi, v, i) == take_better) {
    v = pv;
    i = pi;
  }
}

// The better 32 of two sorted lists (a, best first) and (b, best first),
// into a: the elementwise better of a and b reversed is a bitonic sequence
// holding them; a bitonic merge sorts it.
__device__ __forceinline__ void merge_into(float& av, int& ai, float bv,
                                           int bi, int lane) {
  const float rv = __shfl_sync(kFull, bv, 31 - lane);
  const int ri = __shfl_sync(kFull, bi, 31 - lane);
  if (beats(rv, ri, av, ai)) {
    av = rv;
    ai = ri;
  }
#pragma unroll
  for (int stride = 16; stride > 0; stride >>= 1)
    exchange(av, ai, stride, (lane & stride) == 0);
}

// One row's 128 candidates of a tile (sc: the scores of columns j0 ..
// j0 + 127) against its list (lane l holds slot l, sorted, best first).
// Each column is compared once with the list's k-th pair.  Up to 32
// passing columns are packed into lanes and merged by rank; more are
// sorted as four groups of 32 at once (bitonic, the others pads), the
// groups merged two and two, and the result merged into the list.
// scr_v / scr_i: the warp's 32 pairs of scratch.
__device__ __forceinline__ void select_row(const float* sc, float* list_v,
                                           int* list_i, float* scr_v,
                                           int* scr_i, int j0, int N, int k,
                                           int lane) {
  float lv = list_v[lane];
  int li = list_i[lane];
  const float tv = __shfl_sync(kFull, lv, k - 1);
  const int ti = __shfl_sync(kFull, li, k - 1);
  float gv[4];
  int gj[4];
  unsigned m[4];
  int passing = 0;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    gj[c] = j0 + c * 32 + lane;
    gv[c] = sc[c * 32 + lane];
    const bool ok = gj[c] < N && beats(gv[c], gj[c], tv, ti);
    m[c] = __ballot_sync(kFull, ok);
    passing += __popc(m[c]);
    if (!ok) {
      gv[c] = neg_inf();
      gj[c] = INT_MAX;
    }
  }
  if (passing == 0) return;
  if (passing <= kSlots) {
    // rank merge: the passing columns packed into lanes 0 .. passing - 1
    // (through the warp's scratch), each one broadcast in turn; a pair's
    // new slot is its slot (list) or its rank in the list (column) plus
    // the passing columns better than it; slots past 31 drop out
    int base = 0;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      if ((m[c] >> lane) & 1) {
        const int slot = base + __popc(m[c] & ((1u << lane) - 1));
        scr_v[slot] = gv[c];
        scr_i[slot] = gj[c];
      }
      base += __popc(m[c]);
    }
    __syncwarp();
    const float cv = lane < passing ? scr_v[lane] : neg_inf();
    const int cj = lane < passing ? scr_i[lane] : INT_MAX;
    int lpos = lane;
    int cpos = 0;
    for (int b = 0; b < passing; ++b) {
      const float bv = __shfl_sync(kFull, cv, b);
      const int bj = __shfl_sync(kFull, cj, b);
      lpos += beats(bv, bj, lv, li);
      cpos += beats(bv, bj, cv, cj);
      const int above = __popc(__ballot_sync(kFull, beats(lv, li, bv, bj)));
      if (lane == b) cpos += above;
    }
    if (lpos < kSlots) {
      list_v[lpos] = lv;
      list_i[lpos] = li;
    }
    if (lane < passing && cpos < kSlots) {
      list_v[cpos] = cv;
      list_i[cpos] = cj;
    }
    __syncwarp();
    return;
  }
#pragma unroll
  for (int size = 2; size <= 32; size <<= 1)
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        exchange(gv[c], gj[c], stride,
                 ((lane & stride) == 0) == ((lane & size) == 0));
  merge_into(gv[0], gj[0], gv[1], gj[1], lane);
  merge_into(gv[2], gj[2], gv[3], gj[3], lane);
  merge_into(gv[0], gj[0], gv[2], gj[2], lane);
  merge_into(lv, li, gv[0], gj[0], lane);
  list_v[lane] = lv;
  list_i[lane] = li;
}

// Block (blockIdx.x = segment, blockIdx.y = strip): local rows
// i0 .. i0 + 127 of `at` (global rows row0 + local) against the column
// tiles t0 .. t1 - 1 of its segment, tiles cut as ntiles * s / nseg.
// kTopn: select each row's k best into top_v / top_i [rows, nseg, k];
// else store the scores into out [rows, N] (nseg = ntiles, a tile a block).
template <bool kTopn>
__global__ void __launch_bounds__(kThreads, 2)
sketch_tile_kernel(const float* __restrict__ at, const float* __restrict__ bt,
                   const int* __restrict__ len, float* __restrict__ out,
                   float* __restrict__ top_v, int* __restrict__ top_i, int N,
                   int D, int lda, int ldb, int row0, int rows, int k,
                   int nseg) {
  extern __shared__ __align__(16) float smem[];
  float* list_v = smem + 2 * kStageFloats;        // [kTile][kSlots]
  int* list_i = reinterpret_cast<int*>(list_v + kTile * kSlots);
  float* scr_v = reinterpret_cast<float*>(list_i + kTile * kSlots);
  int* scr_i = reinterpret_cast<int*>(scr_v + kThreads);   // 32 a warp
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int i0 = blockIdx.y * kTile;
  const int ntiles = (N + kTile - 1) / kTile;
  const int seg = blockIdx.x;
  const int t0 = seg * ntiles / nseg;
  const int t1 = (seg + 1) * ntiles / nseg;
  const int nsl = D / kDepth;
  const int G = (t1 - t0) * nsl;

  if (kTopn) {
    for (int q = tid; q < kTile * kSlots; q += kThreads) {
      list_v[q] = neg_inf();
      list_i[q] = INT_MAX;
    }
  }
  float acc[8][8];
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[r][c] = 0.0f;

  stage_slice(smem, at, bt, lda, ldb, i0, t0, nsl, 0, tid);
  for (int g = 0; g < G; ++g) {
    float* buf = smem + (g & 1) * kStageFloats;
    const bool tile_end = g % nsl == nsl - 1;
    // the next slice of the same tile goes in flight now; a tile's first
    // slice waits for the last tile's selection, which uses both stages
    if (!tile_end) {
      stage_slice(smem + ((g + 1) & 1) * kStageFloats, at, bt, lda, ldb, i0,
                  t0, nsl, g + 1, tid);
      asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    }
    __syncthreads();
    const float* sa = buf;
    const float* sb = buf + kDepth * kTile;
#pragma unroll 8
    for (int kk = 0; kk < kDepth; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(sa + kk * kTile +
                                                         ty * 4);
      const float4 a1 = *reinterpret_cast<const float4*>(sa + kk * kTile +
                                                         64 + ty * 4);
      const float4 b0 = *reinterpret_cast<const float4*>(sb + kk * kTile +
                                                         tx * 4);
      const float4 b1 = *reinterpret_cast<const float4*>(sb + kk * kTile +
                                                         64 + tx * 4);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int c = 0; c < 8; ++c)
          acc[r][c] = __fmaf_rn(a[r], b[c], acc[r][c]);
    }
    __syncthreads();
    if (!tile_end) continue;

    // the tile's chains are complete: the two subtractions, in place
    const int j0 = (t0 + g / nsl) * kTile;
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int ri = i0 + (r < 4 ? ty * 4 + r : 64 + ty * 4 + r - 4);
      const int gi = row0 + ri;
      const int li = ri < rows ? len[gi] : 0;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const int gj = j0 + (c < 4 ? tx * 4 + c : 64 + tx * 4 + c - 4);
        const int dl = li - (gj < N ? len[gj] : 0);
        float v = __fsub_rn(acc[r][c], __int2float_rn(dl < 0 ? -dl : dl));
        if (gi == gj) v = __fsub_rn(v, 1e9f);
        acc[r][c] = v;
      }
    }
    if (kTopn) {
      // the tile's scores into both stages (sc[row][column]), then a warp
      // takes rows warp * 16 .. warp * 16 + 15 one at a time
      float* sc = smem;
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        float* dst = sc + (r < 4 ? ty * 4 + r : 64 + ty * 4 + r - 4) * kTile;
        *reinterpret_cast<float4*>(dst + tx * 4) =
            make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
        *reinterpret_cast<float4*>(dst + 64 + tx * 4) =
            make_float4(acc[r][4], acc[r][5], acc[r][6], acc[r][7]);
      }
      __syncthreads();
#pragma unroll 1
      for (int q = 0; q < kTile / 8; ++q) {
        const int r = warp * (kTile / 8) + q;
        if (i0 + r >= rows) break;
        select_row(sc + r * kTile, list_v + r * kSlots, list_i + r * kSlots,
                   scr_v + warp * 32, scr_i + warp * 32, j0, N, k, lane);
      }
      __syncthreads();
    } else {
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const int ri = i0 + (r < 4 ? ty * 4 + r : 64 + ty * 4 + r - 4);
        if (ri >= rows) continue;
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          const int gj = j0 + (c < 4 ? tx * 4 + c : 64 + tx * 4 + c - 4);
          if (gj < N) out[static_cast<size_t>(ri) * N + gj] = acc[r][c];
        }
      }
    }
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int c = 0; c < 8; ++c) acc[r][c] = 0.0f;
    if (g + 1 < G)
      stage_slice(smem + ((g + 1) & 1) * kStageFloats, at, bt, lda, ldb, i0,
                  t0, nsl, g + 1, tid);
  }

  if (kTopn) {
    for (int q = tid; q < kTile * k; q += kThreads) {
      const int r = q / k;
      const int s = q % k;
      if (i0 + r >= rows) break;
      const size_t o =
          (static_cast<size_t>(row0 + i0 + r) * nseg + seg) * k + s;
      top_v[o] = list_v[r * kSlots + s];
      top_i[o] = list_i[r * kSlots + s];
    }
  }
}

// Warp per row: lane s holds the head of list s (s < nseg) and the warp
// takes the best head k times (a butterfly of compares), the winning lane
// moving on in its list.
__global__ void __launch_bounds__(kMergeWarps * 32)
sketch_merge_kernel(const float* __restrict__ part_v,
                    const int* __restrict__ part_i, float* __restrict__ vals,
                    long long* __restrict__ idx, int N, int nseg, int k) {
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * kMergeWarps + threadIdx.x / 32;
  if (row >= N) return;
  const size_t base = (static_cast<size_t>(row) * nseg + lane) * k;
  int h = 0;
  float hv = lane < nseg ? part_v[base] : neg_inf();
  int hi = lane < nseg ? part_i[base] : INT_MAX;
  for (int r = 0; r < k; ++r) {
    float bv = hv;
    int bi = hi;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_xor_sync(kFull, bv, off);
      const int oi = __shfl_xor_sync(kFull, bi, off);
      if (beats(ov, oi, bv, bi)) {
        bv = ov;
        bi = oi;
      }
    }
    if (lane == 0) {
      vals[static_cast<size_t>(row) * k + r] = bv;
      idx[static_cast<size_t>(row) * k + r] = bi;
    }
    if (lane < nseg && hi == bi && hv == bv && bi != INT_MAX) {
      ++h;
      hv = h < k ? part_v[base + h] : neg_inf();
      hi = h < k ? part_i[base + h] : INT_MAX;
    }
  }
}

template <bool kTopn>
int launch_tile(const float* at, const float* bt, const int* len, float* out,
                float* top_v, int* top_i, int N, int D, int lda, int ldb,
                int row0, int rows, int k, int nseg, dim3 grid,
                cudaStream_t stream) {
  const size_t smem = kStageBytes + (kTopn ? kListBytes : 0);
  auto* kern = sketch_tile_kernel<kTopn>;
  const cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  kern<<<grid, kThreads, smem, stream>>>(at, bt, len, out, top_v, top_i, N, D,
                                         lda, ldb, row0, rows, k, nseg);
  return isocon_launch_status();
}

bool misaligned(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 != 0;
}

// ---------------------------------------------------------------------------
// K7: the square roots of the hashed 8-mer counts, the p that K6 reads.
//
// Replaces no TPU kernel: the JAX package counts on the host
// (isocon_tpu/graph/sketch.py:32 kmer_profile, numpy, a read at a time),
// as the port did before this kernel.  For read r, the bytes
// seq[off[r] .. off[r + 1]):
//
//   code(c)   = A/a 0, C/c 1, G/g 2, T/t 3, N/n 5, any other byte 4
//               (ops/encode.py)
//   key(q)    = the 8 codes from position q folded as key * 5 + code
//   bucket(q) = ((key(q) * 0x9E3779B97F4A7C15 mod 2^64) >> 40) % 512
//   out[r][b] = __fsqrt_rn(float(the number of starts q with bucket b))
//
// a row of zeros for a read under 8 bases.  The counts are integer atomics
// in shared memory: an integer sum does not depend on the order of its
// terms, so every run gives the same row, bit for bit np.sqrt of the
// float32 counts (ops/sketch.py::kmer_profiles_plain, the plain version).
//
// What bounds it on the H100: bytes.  Each base is read once and each row
// written once: sum(len) + N x 2,048 bytes and the offsets, ~32 MB for
// 10,000 reads of 1,166 bases, ~10 us at 3.35 TB/s.  So the design moves
// nothing else: a block a read, its 512 bins in shared memory; the read's
// codes staged kProfileChunk starts at a time (coalesced byte loads, any
// read length: the stages walk the read), each thread keying the starts
// tid, tid + 256, ... of the stage from 8 staged codes; then one coalesced
// store of the row.
constexpr int kKmer = 8;
constexpr int kProfileDim = 512;
constexpr int kProfileThreads = 256;
constexpr int kProfileChunk = 8 * kProfileThreads;   // k-mer starts a stage
constexpr unsigned long long kKmerHash = 0x9E3779B97F4A7C15ull;

__device__ __forceinline__ unsigned letter_code(unsigned c) {
  switch (c | 0x20u) {       // the lowercase letter; no other byte maps there
    case 'a': return 0;
    case 'c': return 1;
    case 'g': return 2;
    case 't': return 3;
    case 'n': return 5;
    default: return 4;
  }
}

__global__ void __launch_bounds__(kProfileThreads)
kmer_profile_kernel(const unsigned char* __restrict__ seq,
                    const long long* __restrict__ off,
                    float* __restrict__ out) {
  __shared__ int bins[kProfileDim];
  __shared__ unsigned char codes[kProfileChunk + kKmer - 1];
  const int tid = threadIdx.x;
  const long long start = off[blockIdx.x];
  const long long starts = off[blockIdx.x + 1] - start - (kKmer - 1);
  for (int b = tid; b < kProfileDim; b += kProfileThreads) bins[b] = 0;
  for (long long q0 = 0; q0 < starts; q0 += kProfileChunk) {
    const int n = static_cast<int>(
        starts - q0 < kProfileChunk ? starts - q0 : kProfileChunk);
    __syncthreads();           // bins zeroed; the last stage's codes read
    for (int i = tid; i < n + kKmer - 1; i += kProfileThreads)
      codes[i] = static_cast<unsigned char>(letter_code(seq[start + q0 + i]));
    __syncthreads();
    for (int i = tid; i < n; i += kProfileThreads) {
      long long key = 0;
#pragma unroll
      for (int t = 0; t < kKmer; ++t) key = key * 5 + codes[i + t];
      const unsigned long long h =
          static_cast<unsigned long long>(key) * kKmerHash;
      atomicAdd(&bins[(h >> 40) % kProfileDim], 1);
    }
  }
  __syncthreads();
  float* row = out + static_cast<size_t>(blockIdx.x) * kProfileDim;
  for (int b = tid; b < kProfileDim; b += kProfileThreads)
    row[b] = __fsqrt_rn(__int2float_rn(bins[b]));
}

}  // namespace

// at: float32 [D, lda], the transposed profiles of rows row0 .. row0 +
// rows - 1 (column r = row row0 + r), bt: float32 [D, ldb] of all N rows,
// both zero-padded, lda and ldb multiples of 128 (16-byte aligned); len:
// int32 [N]; out: float32 [rows, N].  Returns the launch's cudaError_t.
ISOCON_API int isocon_sketch_scores(const void* at, const void* bt,
                                    const void* len, void* out, int N, int D,
                                    int lda, int ldb, int row0, int rows,
                                    void* stream) {
  if (rows <= 0 || N <= 0) return 0;
  if (D <= 0 || D % kDepth || row0 < 0 || row0 + rows > N || lda % kTile ||
      ldb % kTile || lda < rows || ldb < N || misaligned(at) ||
      misaligned(bt))
    return cudaErrorInvalidValue;
  const int ntiles = (N + kTile - 1) / kTile;
  return launch_tile<false>(
      static_cast<const float*>(at), static_cast<const float*>(bt),
      static_cast<const int*>(len), static_cast<float*>(out), nullptr,
      nullptr, N, D, lda, ldb, row0, rows, 1, ntiles,
      dim3(ntiles, (rows + kTile - 1) / kTile),
      static_cast<cudaStream_t>(stream));
}

// pt: float32 [D, ld], the transposed profiles of all N rows, zero-padded,
// ld a multiple of 128; len: int32 [N]; vals: float32 [N, nseg, k], idx:
// int32 [N, nseg, k], each row's k best of each segment, padded with
// (-inf, INT_MAX) where a segment has fewer than k columns.  1 <= k <= 32,
// 1 <= nseg <= ceil(N / 128).  Returns the launch's cudaError_t.
ISOCON_API int isocon_sketch_topn(const void* pt, const void* len, void* vals,
                                  void* idx, int N, int D, int ld, int k,
                                  int nseg, void* stream) {
  if (N <= 0) return 0;
  const int ntiles = (N + kTile - 1) / kTile;
  if (D <= 0 || D % kDepth || ld % kTile || ld < N || k < 1 || k > kSlots ||
      nseg < 1 || nseg > ntiles || misaligned(pt))
    return cudaErrorInvalidValue;
  const float* p = static_cast<const float*>(pt);
  return launch_tile<true>(p, p, static_cast<const int*>(len), nullptr,
                           static_cast<float*>(vals), static_cast<int*>(idx),
                           N, D, ld, ld, 0, N, k, nseg, dim3(nseg, ntiles),
                           static_cast<cudaStream_t>(stream));
}

// part_v / part_i: the first pass's [N, nseg, k] lists (each sorted, the
// columns of a row distinct); vals: float32 [N, k], idx: int64 [N, k].
// 1 <= nseg <= 32, 1 <= k <= 32.  Returns the launch's cudaError_t.
ISOCON_API int isocon_sketch_merge(const void* part_v, const void* part_i,
                                   void* vals, void* idx, int N, int nseg,
                                   int k, void* stream) {
  if (N <= 0) return 0;
  if (nseg < 1 || nseg > 32 || k < 1 || k > kSlots)
    return cudaErrorInvalidValue;
  sketch_merge_kernel<<<(N + kMergeWarps - 1) / kMergeWarps,
                        kMergeWarps * 32, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(part_v), static_cast<const int*>(part_i),
      static_cast<float*>(vals), static_cast<long long*>(idx), N, nseg, k);
  return isocon_launch_status();
}

// seq: uint8, the reads' ASCII bytes back to back; off: int64 [N + 1], read
// r's bytes seq[off[r] .. off[r + 1]) (non-decreasing, within seq); out:
// float32 [N, 512], each read's square-rooted hashed 8-mer counts.  Returns
// the launch's cudaError_t.
ISOCON_API int isocon_kmer_profile(const void* seq, const void* off,
                                   void* out, int N, void* stream) {
  if (N <= 0) return 0;
  kmer_profile_kernel<<<N, kProfileThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned char*>(seq),
      static_cast<const long long*>(off), static_cast<float*>(out));
  return isocon_launch_status();
}
