// K6: sketch scores of the approximate NN graph (--nontargeted).
//
// Replaces isocon_tpu/graph/sketch.py::_topn_scores's score matrix (a
// jax.jit of jnp.dot + lax.top_k, not a pl.pallas_call; the top-n is a
// stable sort in isocon_tpu_torch/ops/sketch.py).  For rows row0 ..
// row0 + rows - 1 of the square-rooted k-mer profiles p (float32 [N, D])
// against all N:
//
//   out[i - row0][j] = acc(i, j) - float(|len[i] - len[j]|)   (- 1e9f if i == j)
//   acc(i, j)        = fmaf(p[i][D-1], p[j][D-1], ... fmaf(p[i][0], p[j][0], 0.0f))
//
// Each entry's sum is ONE in-order chain of IEEE fused multiply-adds over
// d = 0 .. D-1 from 0.0f (__fmaf_rn, never split, never reordered), the
// order XLA:CPU's dot takes at 3,000 rows and the one the plain version
// (ops/sketch.py::sketch_scores_plain, exact fmaf emulated in float64) is
// held to bit for bit.  The scores decide which top-n neighbours each read
// gets, so their rounding is part of the result.  That is why no tensor
// core runs here: an MMA (mma.sync, wgmma, TF32 or not) accumulates in its
// own order and precision, not as sequential IEEE FMA, and a library GEMM
// splits and blocks the sum.  The two subtractions are the JAX function's,
// each rounded in float32 (__fsub_rn), in the same kernel.
//
// What bounds it on the H100: float32 FMA.  N^2 * D FMA over 132 SMs x 128
// FP32 lanes x the clock: 1.53 ms at N = 10,000, D = 512, 1,980 MHz; the
// bytes (p read once, 20 MB; the [N, N] output written once, 400 MB) take
// 0.13 ms at 3.35 TB/s.  So the design keeps the FMA pipe fed: a block
// computes a 64 x 64 tile of outputs, a thread 4 x 4 of them in registers
// (rows 4ty .. 4ty + 3, columns tx, tx + 16, tx + 32, tx + 48), and both
// 64-row slices of p are staged in shared memory 32 values of d at a time,
// in order, d-major, so a step of d is one 16-byte load of the thread's
// four row values (a broadcast: a warp spans two values of ty), four
// conflict-free loads of its column values and 16 FMA.  Rows and columns
// past the ends load zeros and store nothing; D must be a multiple of 32.
#include "isocon_cuda.h"

namespace {

constexpr int kTile = 64;          // outputs a block, each way
constexpr int kDepth = 32;         // values of d staged at a time
constexpr int kStride = kTile + 4; // floats a staged row (16-byte aligned)
constexpr int kThreads = 256;      // 16 x 16, 4 x 4 outputs each

__global__ void __launch_bounds__(kThreads)
sketch_scores_kernel(const float* __restrict__ p, const int* __restrict__ len,
                     float* __restrict__ out, int N, int D, int row0,
                     int rows) {
  __shared__ __align__(16) float as[kDepth][kStride];
  __shared__ __align__(16) float bs[kDepth][kStride];
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int i0 = blockIdx.y * kTile;   // first row of the tile, from row0
  const int j0 = blockIdx.x * kTile;   // first column of the tile

  float acc[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.0f;

  for (int d0 = 0; d0 < D; d0 += kDepth) {
    // stage p[i0 .. i0 + 63][d0 .. d0 + 31] and p[j0 ..][d0 ..], d-major:
    // 64 rows x 8 float4 each, two float4 a thread for each slice
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int q = tid + h * kThreads;
      const int row = q / 8;
      const int k = (q % 8) * 4;
      const int gi = i0 + row;
      const int gj = j0 + row;
      float4 va = make_float4(0.f, 0.f, 0.f, 0.f);
      float4 vb = va;
      if (gi < rows)
        va = *reinterpret_cast<const float4*>(
            p + static_cast<size_t>(row0 + gi) * D + d0 + k);
      if (gj < N)
        vb = *reinterpret_cast<const float4*>(
            p + static_cast<size_t>(gj) * D + d0 + k);
      as[k][row] = va.x;
      as[k + 1][row] = va.y;
      as[k + 2][row] = va.z;
      as[k + 3][row] = va.w;
      bs[k][row] = vb.x;
      bs[k + 1][row] = vb.y;
      bs[k + 2][row] = vb.z;
      bs[k + 3][row] = vb.w;
    }
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < kDepth; ++k) {
      const float4 a4 = *reinterpret_cast<const float4*>(&as[k][ty * 4]);
      const float a[4] = {a4.x, a4.y, a4.z, a4.w};
      float b[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) b[c] = bs[k][tx + 16 * c];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c)
          acc[r][c] = __fmaf_rn(a[r], b[c], acc[r][c]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int ri = i0 + ty * 4 + r;
    if (ri >= rows) continue;
    const int gi = row0 + ri;
    const int li = len[gi];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int gj = j0 + tx + 16 * c;
      if (gj >= N) continue;
      const int dl = li - len[gj];
      float v = __fsub_rn(acc[r][c], __int2float_rn(dl < 0 ? -dl : dl));
      if (gi == gj) v = __fsub_rn(v, 1e9f);
      out[static_cast<size_t>(ri) * N + gj] = v;
    }
  }
}

}  // namespace

// p: float32 [N, D] row-major (16-byte aligned), len: int32 [N], out:
// float32 [rows, N].  Returns the launch's cudaError_t.
ISOCON_API int isocon_sketch_scores(const void* p, const void* len, void* out,
                                    int N, int D, int row0, int rows,
                                    void* stream) {
  if (rows <= 0 || N <= 0) return 0;
  if (D <= 0 || D % kDepth || row0 < 0 || row0 + rows > N ||
      reinterpret_cast<uintptr_t>(p) % 16)
    return cudaErrorInvalidValue;
  dim3 grid((N + kTile - 1) / kTile, (rows + kTile - 1) / kTile);
  sketch_scores_kernel<<<grid, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(p), static_cast<const int*>(len),
      static_cast<float*>(out), N, D, row0, rows);
  return isocon_launch_status();
}
