// MAM vote and correction of a round's dense partitions (the port's
// counterpart of the per-member loop of IsoCon's correct_to_consensus,
// correction_module.py:260-446), two kernels in one stream:
//
//   consensus_vote     a thread a column of a partition: the degree-weighted
//                      counts of A, C, G, T and '-' over the partition's rows
//                      (any other byte counts as '-'), the majority (the first
//                      maximum in ACGT- order), whether it is unambiguous,
//                      and the column's part of the partition's error counts
//                      c_ins, c_del, c_subs (a warp sum, then one 64-bit
//                      atomicAdd a warp: integers, so any order gives them).
//   consensus_correct  a block a member row of degree 1: its mismatches (the
//                      unambiguous columns whose code is not the majority's),
//                      each one's freq = count / max(c_type, 1) in float64,
//                      the ceil(n / 2)-th smallest freq by a radix select on
//                      the float64 bits (non-negative doubles order as their
//                      bits), the row with every mismatch of freq <= that
//                      cutoff set to the majority, its '-' bytes removed.
//
// The host sorts the mismatches stably and extends the cut through ties;
// that takes exactly the mismatches whose freq is <= the cutoff, so no
// order of positions is needed.  Layout (``ops/consensus.py``): the MAMs
// row-major one after another in ``mat``; ``part`` [P, 5] int64 a partition
// (byte offset, rows K, columns W, first row, first column); ``deg`` a
// row; ``rows`` [2, R] int64, the rows to correct and their partitions.

#include "isocon_cuda.h"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxGridY = 65535;
constexpr unsigned char kDash = '-';

__device__ __forceinline__ int base_code(unsigned char b) {
  return b == 'A' ? 0 : b == 'C' ? 1 : b == 'G' ? 2 : b == 'T' ? 3 : 4;
}

__device__ __forceinline__ long long warp_sum(long long v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

__global__ void __launch_bounds__(kThreads)
consensus_vote_kernel(const uint8_t* __restrict__ mat,
                      const long long* __restrict__ part,
                      const long long* __restrict__ deg,
                      long long* __restrict__ counts,
                      uint8_t* __restrict__ maj, uint8_t* __restrict__ unamb,
                      unsigned long long* __restrict__ errs, int P) {
  for (int p = blockIdx.y; p < P; p += gridDim.y) {
    const long long base = part[5 * p], K = part[5 * p + 1];
    const long long W = part[5 * p + 2], row0 = part[5 * p + 3];
    const long long col0 = part[5 * p + 4];
    long long ins = 0, del = 0, subs = 0;
    const long long stride = static_cast<long long>(gridDim.x) * kThreads;
    // j0 is the same for the whole block, so every lane reaches the sums
    for (long long j0 = static_cast<long long>(blockIdx.x) * kThreads; j0 < W;
         j0 += stride) {
      const long long j = j0 + threadIdx.x;
      if (j >= W) continue;
      long long c0 = 0, c1 = 0, c2 = 0, c3 = 0, c4 = 0;
      const uint8_t* col = mat + base + j;
      for (long long k = 0; k < K; ++k) {
        const long long d = deg[row0 + k];
        const int code = base_code(col[k * W]);
        c0 += code == 0 ? d : 0;
        c1 += code == 1 ? d : 0;
        c2 += code == 2 ? d : 0;
        c3 += code == 3 ? d : 0;
        c4 += code == 4 ? d : 0;
      }
      long long mx = c0;
      int m = 0;
      if (c1 > mx) { mx = c1; m = 1; }
      if (c2 > mx) { mx = c2; m = 2; }
      if (c3 > mx) { mx = c3; m = 3; }
      if (c4 > mx) { mx = c4; m = 4; }
      const int n_max = (c0 == mx) + (c1 == mx) + (c2 == mx) + (c3 == mx) +
                        (c4 == mx);
      const long long cj = col0 + j;
      long long* cc = counts + 5 * cj;
      cc[0] = c0; cc[1] = c1; cc[2] = c2; cc[3] = c3; cc[4] = c4;
      maj[cj] = static_cast<uint8_t>(m);
      unamb[cj] = n_max == 1;
      if (n_max == 1) {
        const long long other = c0 + c1 + c2 + c3 + c4 - mx;
        if (m == 4) {
          ins += other;
        } else {
          del += c4;
          subs += other - c4;
        }
      }
    }
    ins = warp_sum(ins);
    del = warp_sum(del);
    subs = warp_sum(subs);
    if ((threadIdx.x & 31) == 0 && (ins | del | subs)) {
      atomicAdd(errs + 3 * p, static_cast<unsigned long long>(ins));
      atomicAdd(errs + 3 * p + 1, static_cast<unsigned long long>(del));
      atomicAdd(errs + 3 * p + 2, static_cast<unsigned long long>(subs));
    }
  }
}

// The row's column j: whether it is a mismatch, and then its freq's bits.
struct RowView {
  const uint8_t* row;
  const long long* counts;   // the partition's first column's counts
  const uint8_t* maj;
  const uint8_t* unamb;
  double norm_ins, norm_del, norm_subs;

  __device__ __forceinline__ bool key(long long j, unsigned long long* k)
      const {
    const int code = base_code(row[j]);
    const int m = maj[j];
    if (!unamb[j] || code == m) return false;
    const double norm = m == 4 ? norm_ins : code == 4 ? norm_del : norm_subs;
    const double freq = static_cast<double>(counts[5 * j + code]) / norm;
    *k = static_cast<unsigned long long>(__double_as_longlong(freq));
    return true;
  }
};

__device__ __forceinline__ long long block_sum(long long v, long long* red) {
  v = warp_sum(v);
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) red[warp] = v;
  __syncthreads();
  long long t = 0;
  for (int w = 0; w < kWarps; ++w) t += red[w];
  __syncthreads();
  return t;
}

__global__ void __launch_bounds__(kThreads)
consensus_correct_kernel(const uint8_t* __restrict__ mat,
                         const long long* __restrict__ part,
                         const long long* __restrict__ rows, int R,
                         const long long* __restrict__ counts,
                         const uint8_t* __restrict__ maj,
                         const uint8_t* __restrict__ unamb,
                         const unsigned long long* __restrict__ errs,
                         uint8_t* __restrict__ out, long long out_w,
                         int* __restrict__ lens, int* __restrict__ nmis) {
  __shared__ unsigned int hist[256];
  __shared__ long long red[kWarps];
  __shared__ int tile_sums[2][kWarps];
  __shared__ unsigned long long s_prefix, s_mask;
  __shared__ long long s_rank;

  const int i = blockIdx.x;
  const long long r = rows[i], p = rows[R + i];
  const long long base = part[5 * p], W = part[5 * p + 2];
  const long long row0 = part[5 * p + 3], col0 = part[5 * p + 4];
  const unsigned long long* e = errs + 3 * p;
  RowView v;
  v.row = mat + base + (r - row0) * W;
  v.counts = counts + 5 * col0;
  v.maj = maj + col0;
  v.unamb = unamb + col0;
  v.norm_ins = static_cast<double>(e[0] > 1 ? e[0] : 1);
  v.norm_del = static_cast<double>(e[1] > 1 ? e[1] : 1);
  v.norm_subs = static_cast<double>(e[2] > 1 ? e[2] : 1);

  long long n = 0;
  unsigned long long k;
  for (long long j = threadIdx.x; j < W; j += kThreads) n += v.key(j, &k);
  n = block_sum(n, red);

  // the cutoff: the ceil(n / 2)-th smallest key, 8 bits a pass from the top
  unsigned long long cutoff = 0;
  bool any = n > 0;
  if (any) {
    if (threadIdx.x == 0) {
      s_prefix = 0;
      s_mask = 0;
      s_rank = (n + 1) / 2;
    }
    for (int shift = 56; shift >= 0; shift -= 8) {
      hist[threadIdx.x] = 0;
      __syncthreads();
      // read before the histogram's barrier; written only after it
      const unsigned long long prefix = s_prefix, mask = s_mask;
      const long long rank = s_rank;
      for (long long j = threadIdx.x; j < W; j += kThreads) {
        if (v.key(j, &k) && (k & mask) == prefix)
          atomicAdd(&hist[(k >> shift) & 255], 1u);
      }
      __syncthreads();
      if (threadIdx.x < 32) {
        const int lane = threadIdx.x;
        unsigned int own = 0;
        for (int b = 0; b < 8; ++b) own += hist[8 * lane + b];
        unsigned int incl = own;
        for (int o = 1; o < 32; o <<= 1) {
          const unsigned int t = __shfl_up_sync(0xffffffffu, incl, o);
          if (lane >= o) incl += t;
        }
        const long long excl = static_cast<long long>(incl) - own;
        if (excl < rank && rank <= static_cast<long long>(incl)) {
          long long run = excl;
          for (int b = 0; b < 8; ++b) {
            const unsigned int h = hist[8 * lane + b];
            if (run + h >= rank) {
              s_rank = rank - run;
              s_prefix = prefix |
                  (static_cast<unsigned long long>(8 * lane + b) << shift);
              s_mask = mask | (0xffull << shift);
              break;
            }
            run += h;
          }
        }
      }
      __syncthreads();
    }
    cutoff = s_prefix;
  }

  // the corrected row, '-' bytes removed: a ballot prefix a warp, the
  // warps' totals in shared memory (two buffers, one barrier a tile)
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  uint8_t* dst = out + static_cast<long long>(i) * out_w;
  long long written = 0;
  int buf = 0;
  for (long long j0 = 0; j0 < W; j0 += kThreads, buf ^= 1) {
    const long long j = j0 + threadIdx.x;
    uint8_t b = kDash;
    if (j < W) {
      b = v.row[j];
      if (any && v.key(j, &k) && k <= cutoff) {
        const int m = v.maj[j];
        b = m == 0 ? 'A' : m == 1 ? 'C' : m == 2 ? 'G' : m == 3 ? 'T' : kDash;
      }
    }
    const bool keep = b != kDash;
    const unsigned int ballot = __ballot_sync(0xffffffffu, keep);
    if (lane == 0) tile_sums[buf][warp] = __popc(ballot);
    __syncthreads();
    int before = 0, total = 0;
    for (int w = 0; w < kWarps; ++w) {
      const int t = tile_sums[buf][w];
      before += w < warp ? t : 0;
      total += t;
    }
    if (keep)
      dst[written + before + __popc(ballot & ((1u << lane) - 1))] = b;
    written += total;
  }
  if (threadIdx.x == 0) {
    lens[i] = static_cast<int>(written);
    nmis[i] = static_cast<int>(n);
  }
}

}  // namespace

ISOCON_API int isocon_consensus_vote(const uint8_t* mat, const long long* part,
                                     const long long* deg, long long* counts,
                                     uint8_t* maj, uint8_t* unamb,
                                     unsigned long long* errs, int P,
                                     int max_w, cudaStream_t stream) {
  cudaMemsetAsync(errs, 0, sizeof(unsigned long long) * 3 * P, stream);
  if (P <= 0 || max_w <= 0) return isocon_launch_status();
  const dim3 grid((max_w + kThreads - 1) / kThreads,
                  P < kMaxGridY ? P : kMaxGridY);
  consensus_vote_kernel<<<grid, kThreads, 0, stream>>>(
      mat, part, deg, counts, maj, unamb, errs, P);
  return isocon_launch_status();
}

ISOCON_API int isocon_consensus_correct(
    const uint8_t* mat, const long long* part, const long long* rows,
    const long long* counts, const uint8_t* maj, const uint8_t* unamb,
    const unsigned long long* errs, uint8_t* out, int* lens, int* nmis, int R,
    int out_w, cudaStream_t stream) {
  if (R <= 0) return isocon_launch_status();
  consensus_correct_kernel<<<R, kThreads, 0, stream>>>(
      mat, part, rows, R, counts, maj, unamb, errs, out, out_w, lens, nmis);
  return isocon_launch_status();
}
