// Host Myers bit-vector edit distance (block formulation, Hyyro 2003).
//
// The engine's CPU route for NW edit distances (ops/engine.py,
// PairEngine._ed_native): the unit-cost global distance of every pair,
// exact, with a per-pair cutoff, threaded over the host cores.  The same
// recurrence as isocon_tpu/native/myers_ed.cc: full-width 64-bit blocks
// (no band), and a sound early stop once the cutoff is exceeded:
//   D[n][m] >= D[n][j] - (m - j)  =>  stop once that bound exceeds k.
//
// isocon_tpu_torch/native/__init__.py builds it with g++ at first use and
// loads it with ctypes.  C ABI:
//   int64_t myers_ed(const uint8_t* q, int64_t n, const uint8_t* t,
//                    int64_t m, int64_t k);
//     the edit distance, or -1 if it exceeds k (k < 0: no cutoff).
//   void myers_ed_batch_k(const uint8_t* qs, const int64_t* qlens,
//                         const uint8_t* ts, const int64_t* tlens,
//                         int64_t stride, int64_t n_pairs,
//                         const int64_t* ks, int64_t nthreads,
//                         int64_t* out);
//     out[i] = myers_ed(qs + i*stride, qlens[i], ts + i*stride, tlens[i],
//     ks[i]); pairs are taken from an atomic index by up to nthreads
//     threads.
//
// Sequences are byte codes of any alphabet (the engine passes the
// ops/encode.py codes).

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <thread>
#include <vector>

namespace {

using u64 = uint64_t;

struct Block {
  u64 P;  // vertical +1 deltas
  u64 M;  // vertical -1 deltas
};

// One text column through one block.  Adds the horizontal delta at bit
// `score_bit` to *score and returns the delta leaving the block's last
// row (bit 63), which enters the next block.
inline int advance_block(Block& b, u64 eq, int hin, int score_bit,
                         int* score) {
  const u64 Pv = b.P, Mv = b.M;
  const u64 Xv = eq | Mv;
  if (hin < 0) eq |= 1ULL;
  const u64 Xh = (((eq & Pv) + Pv) ^ Pv) | eq;

  u64 Ph = Mv | ~(Xh | Pv);
  u64 Mh = Pv & Xh;

  if (Ph & (1ULL << score_bit)) {
    ++*score;
  } else if (Mh & (1ULL << score_bit)) {
    --*score;
  }

  int hout = 0;
  if (Ph & (1ULL << 63)) {
    hout = 1;
  } else if (Mh & (1ULL << 63)) {
    hout = -1;
  }

  Ph <<= 1;
  Mh <<= 1;
  if (hin < 0) {
    Mh |= 1ULL;
  } else if (hin > 0) {
    Ph |= 1ULL;
  }

  b.P = Mh | ~(Xv | Ph);
  b.M = Ph & Xv;
  return hout;
}

}  // namespace

extern "C" {

int64_t myers_ed(const uint8_t* q, int64_t n, const uint8_t* t, int64_t m,
                 int64_t k) {
  if (n == 0) return (k < 0 || m <= k) ? m : -1;
  if (m == 0) return (k < 0 || n <= k) ? n : -1;
  if (k >= 0 && (n > m ? n - m : m - n) > k) return -1;

  constexpr int W = 64;
  const int64_t nblocks = (n + W - 1) / W;
  // peq[c * nblocks + b]: the rows of block b that hold code c
  std::vector<u64> peq(256 * nblocks, 0);
  for (int64_t i = 0; i < n; ++i) {
    peq[static_cast<int64_t>(q[i]) * nblocks + i / W] |= 1ULL << (i % W);
  }

  std::vector<Block> blocks(nblocks, Block{~0ULL, 0ULL});
  // scores[b]: D at block b's last row, min((b + 1) * W, n)
  std::vector<int> scores(nblocks);
  for (int64_t b = 0; b < nblocks; ++b) {
    scores[b] = static_cast<int>(std::min<int64_t>((b + 1) * W, n));
  }
  const int last_bit = static_cast<int>((n - 1) % W);

  for (int64_t j = 0; j < m; ++j) {
    const u64* eq = &peq[static_cast<int64_t>(t[j]) * nblocks];
    int hin = 1;  // the top row: D[0][j] = j
    for (int64_t b = 0; b < nblocks; ++b) {
      const int sb = (b == nblocks - 1) ? last_bit : 63;
      hin = advance_block(blocks[b], eq[b], hin, sb, &scores[b]);
    }
    if (k >= 0 && scores[nblocks - 1] - (m - 1 - j) > k) return -1;
  }
  const int64_t d = scores[nblocks - 1];
  return (k >= 0 && d > k) ? -1 : d;
}

void myers_ed_batch_k(const uint8_t* qs, const int64_t* qlens,
                      const uint8_t* ts, const int64_t* tlens, int64_t stride,
                      int64_t n_pairs, const int64_t* ks, int64_t nthreads,
                      int64_t* out) {
  if (n_pairs <= 0) return;
  nthreads = std::max<int64_t>(1, std::min<int64_t>(nthreads, n_pairs));
  std::atomic<int64_t> next(0);
  auto worker = [&]() {
    for (;;) {
      const int64_t i = next.fetch_add(1);
      if (i >= n_pairs) break;
      out[i] = myers_ed(qs + i * stride, qlens[i], ts + i * stride,
                        tlens[i], ks[i]);
    }
  };
  if (nthreads == 1) {
    worker();
    return;
  }
  std::vector<std::thread> threads;
  threads.reserve(nthreads);
  for (int64_t w = 0; w < nthreads; ++w) threads.emplace_back(worker);
  for (auto& th : threads) th.join();
}

}  // extern "C"
