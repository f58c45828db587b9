// Banded infix (edlib-HW-mode) unit-cost alignment with traceback.
//
// Host implementation of isocon_tpu/ops/oracle.py:edit_distance_hw_banded
// (the JAX package's numpy oracle) -- the per-survivor traceback of the
// ends-ignored candidate graph (end_invariant_functions.py:593-621 in the
// reference).  The batched HW
// Myers kernel (K2, csrc/myers_ed.cu) computes the distances with a
// cutoff; only the pairs under the cutoff need the target span + op
// string for the end adjustments, and that walk is latency-bound host
// work, so it lives here in threaded C++ (isocon_tpu_torch/native/
// __init__.py builds it with g++ at first use and loads it with ctypes).
//
// Semantics pinned to the numpy oracle (and covered by its tests):
//   * band offsets o = j - i in [-band, max(0, m-n) + band]
//   * certification: ed <= band and max(0, m-n) + 2*ed <= o_hi, else -1
//     (caller falls back to a wider band / full DP)
//   * endpoint: smallest end j among last-row minima
//   * traceback preference: diagonal > D (consume t) > I (consume q)
//
// Exposed C ABI (ctypes):
//   int64_t hw_banded_traceback(const uint8_t* q, int64_t n,
//                               const uint8_t* t, int64_t m, int64_t band,
//                               int64_t* start_j, int64_t* end_j_incl,
//                               char* ops, int64_t ops_cap);
//     returns ed >= 0 on success (ops NUL-terminated), -1 when the band
//     cannot certify, -2 when ops_cap is too small.

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <thread>
#include <vector>

namespace {
constexpr int32_t BIGV = 1000000;
}

extern "C" {

int64_t hw_banded_traceback(const uint8_t* q, int64_t n, const uint8_t* t,
                            int64_t m, int64_t band, int64_t* start_j,
                            int64_t* end_j_incl, char* ops,
                            int64_t ops_cap) {
  const int64_t delta = m - n;
  const int64_t o_lo = -band;
  const int64_t o_hi = std::max<int64_t>(0, delta) + band;
  const int64_t W = o_hi - o_lo + 1;

  // D[i][c] = D[i][j] with j = i + o_lo + c
  std::vector<int32_t> D(static_cast<size_t>(n + 1) * W, BIGV);
  for (int64_t c = 0; c < W; ++c) {
    const int64_t j = o_lo + c;
    if (j >= 0 && j <= m) D[c] = 0;  // free target start
  }
  for (int64_t i = 1; i <= n; ++i) {
    const int32_t* prev = &D[(i - 1) * W];
    int32_t* row = &D[i * W];
    const uint8_t qc = q[i - 1];
    for (int64_t c = 0; c < W; ++c) {
      const int64_t j = i + o_lo + c;
      if (j < 0 || j > m) {
        row[c] = BIGV;
        continue;
      }
      // deletion-from-q parent (i-1, j): offset +1 => slot c+1
      int32_t best = (c + 1 < W) ? prev[c + 1] + 1 : BIGV;
      // diagonal parent (i-1, j-1): same slot
      const int64_t jp = j - 1;
      if (jp >= 0 && jp < m) {
        const int32_t diag = prev[c] + (qc == t[jp] ? 0 : 1);
        best = std::min(best, diag);
      }
      // horizontal chain (consume t): parent (i, j-1) = slot c-1
      if (c > 0 && row[c - 1] + 1 < best) best = row[c - 1] + 1;
      row[c] = std::min(best, BIGV);
    }
  }

  const int32_t* last = &D[n * W];
  int32_t ed = BIGV;
  int64_t cbest = -1;
  for (int64_t c = 0; c < W; ++c) {  // smallest end j among minima
    const int64_t j = n + o_lo + c;
    if (j < 0 || j > m) continue;
    if (last[c] < ed) {
      ed = last[c];
      cbest = c;
    }
  }
  if (!(ed <= band && std::max<int64_t>(0, delta) + 2 * ed <= o_hi)) {
    return -1;  // band cannot certify; caller escalates
  }
  *end_j_incl = n + o_lo + cbest - 1;

  // traceback; preference diag > D(consume t) > I(consume q)
  int64_t i = n, c = cbest;
  int64_t len = 0;
  while (i > 0) {
    if (len + 1 >= ops_cap) return -2;
    const int64_t j = i + o_lo + c;
    const int64_t jp = j - 1;
    const int32_t cur = D[i * W + c];
    if (jp >= 0 && jp < m &&
        cur == D[(i - 1) * W + c] + (q[i - 1] == t[jp] ? 0 : 1)) {
      ops[len++] = (q[i - 1] == t[jp]) ? '=' : 'X';
      --i;  // diagonal: same slot
    } else if (c > 0 && cur == D[i * W + c - 1] + 1) {
      ops[len++] = 'D';
      --c;
    } else {
      // must be the deletion-from-q parent
      ops[len++] = 'I';
      --i;
      ++c;
    }
  }
  *start_j = i + o_lo + c;
  std::reverse(ops, ops + len);
  ops[len] = '\0';
  return ed;
}

// Batched, threaded variant with internal band escalation: each pair runs
// hw_banded_traceback at doubling bands until certified (band >= 2n always
// certifies, since ed <= n in HW mode).  Replaces the serial per-survivor
// Python confirm loop of the ends-ignored candidate graph
// (end_invariant_functions.py:757-788's traceback pass).
//   qs/ts: [B, stride] padded uint8; meta_out: [B, 3] int64
//   (ed, start_j, end_j_incl); ops_out: [B, ops_stride] NUL-terminated.
//   band0s: per-pair initial band (<= 0 -> 128).  When the caller knows
//   the pair's distance d (the batched prefilter does), band = 2d
//   certifies immediately and the DP shrinks ~5x vs the 128 default --
//   every optimal path of cost d keeps offsets in [-d, delta+d] and all
//   last-row minima sit inside the band, so the smallest-end tie rule
//   sees the same set.
//   caps: optional per-pair edit-distance cutoffs (NULL or <= 0 entry =
//   none): escalation gives up (meta ed = -1) once an uncertified band
//   already proves ed > cap -- the same early-giveup rule as the
//   engine's serial loop (band/2 >= cap), so hopeless pairs stop at a
//   narrow band instead of escalating to the full DP.
void hw_traceback_batch(const uint8_t* qs, const int64_t* qlens,
                        const uint8_t* ts, const int64_t* tlens,
                        int64_t stride, int64_t n_pairs,
                        const int64_t* band0s, const int64_t* caps,
                        int64_t nthreads, char* ops_out, int64_t ops_stride,
                        int64_t* meta_out) {
  if (nthreads < 1) nthreads = 1;
  nthreads = std::min<int64_t>(nthreads, n_pairs);
  std::atomic<int64_t> next(0);
  auto worker = [&]() {
    for (;;) {
      const int64_t p = next.fetch_add(1);
      if (p >= n_pairs) break;
      const uint8_t* q = qs + p * stride;
      const uint8_t* t = ts + p * stride;
      const int64_t n = qlens[p];
      const int64_t m = tlens[p];
      char* ops = ops_out + p * ops_stride;
      int64_t* meta = meta_out + p * 3;
      if (n == 0 || m == 0) {
        meta[0] = 0;  // empty query aligns to an empty span
        meta[1] = 0;
        meta[2] = -1;
        ops[0] = '\0';
        if (n > 0) {  // empty target: delete the whole query
          meta[0] = n;
          for (int64_t k = 0; k < n && k + 1 < ops_stride; ++k) ops[k] = 'I';
          ops[std::min(n, ops_stride - 1)] = '\0';
        }
        continue;
      }
      int64_t band = band0s[p] > 0 ? band0s[p] : 128;
      const int64_t cap = caps ? caps[p] : 0;
      const int64_t maxlen = n > m ? n : m;
      for (;;) {
        const int64_t ed = hw_banded_traceback(q, n, t, m, band, &meta[1],
                                               &meta[2], ops, ops_stride);
        if (ed >= 0) {
          meta[0] = ed;
          break;
        }
        if (ed == -2 || band >= 2 * n) {
          meta[0] = -2;  // ops buffer too small (caller falls back)
          break;
        }
        if (cap > 0 && (band / 2 >= cap || band > 4 * maxlen)) {
          meta[0] = -1;  // uncertified at a band already proving ed > cap
          break;
        }
        band *= 2;
      }
    }
  };
  if (nthreads == 1) {
    worker();
    return;
  }
  std::vector<std::thread> threads;
  threads.reserve(nthreads);
  for (int64_t t = 0; t < nthreads; ++t) threads.emplace_back(worker);
  for (auto& t : threads) t.join();
}

}  // extern "C"
