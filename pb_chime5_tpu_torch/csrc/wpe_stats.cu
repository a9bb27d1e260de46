// WPE correlation statistics for Hopper (sm_90a), CUDA C++.
//
// Replaces the Pallas TPU kernel pb_chime5_tpu/ops/pallas/wpe_stats.py
// (_kernel, launched from _stats_call).  Per frequency f, over all frames t,
// with the weight w_t = 1 / lambda_t:
//
//   R[a, b] = sum_t w_t Yt[a, t] conj(Yt[b, t])     (dim x dim)
//   P[a, d] = sum_t w_t Yt[a, t] conj(Y[d, t])      (dim x D)
//
// The TPU kernel computes both in one pass as the real block product
// (w * [Ytr; Yti]) . [Ytr | Yti | Yr | Yi] over planes that a wrapper
// builds first (a time-major copy of the stacked signal, T padded to 512).
// Here the kernel reads the complex stacked signal Yt (F, dim, T) and Y
// (F, D, T) as they are: no planes, no copy, no padding.  Like the TPU
// kernel it never writes the weighted copy w * Yt to device memory: the
// weight is applied as a chunk is loaded into shared memory.
//
// R is Hermitian, so only its lower block triangle is computed: a block
// on the diagonal writes its entries a >= b, and every entry a > b is also
// written, conjugated, to R[b, a].  The upper triangle is therefore
// exactly the mirror of the lower one; the caller's hermitize then only
// zeroes the rounding left in the imaginary part of the diagonal.
//
// What bounds it on this card: at the headline (F = 513, dim = 240, D = 24,
// T = 2504) the lower half of R plus P is 356 GFLOP, 5.3 ms at the
// 67 TFLOP/s fp32 rate of the CUDA cores, against 2.47 GB of Yt read once
// (0.74 ms at 3.35 TB/s): compute-bound.  IEEE fp32 FMA only, no TF32 and
// no tensor cores (reduced-precision statistics NaN the WPE on scenes with
// near-silent stretches).
//
// Design (simple and right first; wgmma-free register tiling, double-
// buffered loads and exploiting that Yt's rows are shifted copies of Y
// are later work):
//   * one block of 256 threads per (frequency, 48 x 48 output tile) of
//     [R | P]; the tiles of one frequency are adjacent in the grid so
//     they share its rows of Yt in L2; blocks above R's diagonal exit;
//   * the block loops over T in chunks of 32 frames: 48 weighted rows of
//     Yt and 48 rows of [Yt; Y] are staged in shared memory (t-major,
//     padded against bank conflicts);
//   * each thread accumulates a 3 x 3 register tile of complex sums in t
//     order and writes it once at the end.
// No atomics and no cross-block reduction: bit-identical run to run.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 48;
constexpr int kThreads = 256;            // 16 x 16 threads, 3 x 3 outputs
constexpr int kSub = kTile / 16;         // outputs per thread per axis
constexpr int kChunk = 32;               // frames per shared-memory chunk
constexpr int kStride = kTile + 1;       // padded row of a t-major chunk
static_assert(kSub * 16 == kTile, "16 x 16 threads cover the tile");

__global__ void __launch_bounds__(kThreads)
wpe_stats_kernel(const float2* __restrict__ yt,   // (F, dim, T)
                 const float2* __restrict__ y,    // (F, D, T)
                 const float* __restrict__ w,     // (F, T)
                 float2* __restrict__ R,          // (F, dim, dim)
                 float2* __restrict__ P,          // (F, dim, D)
                 int dim, int D, int T, int row_tiles, int col_tiles) {
  __shared__ float2 sA[kChunk * kStride];   // weighted Yt rows, t-major
  __shared__ float2 sB[kChunk * kStride];   // [Yt; Y] rows, t-major

  const int tiles = row_tiles * col_tiles;
  const int f = blockIdx.x / tiles;
  const int tile = blockIdx.x - f * tiles;
  const int ti = tile / col_tiles;
  const int tj = tile - ti * col_tiles;
  const bool in_R = tj < row_tiles;      // else a column tile of P
  if (in_R && tj > ti) return;           // mirrored from block (tj, ti)

  const int a0 = ti * kTile;
  const int b0 = (in_R ? tj : tj - row_tiles) * kTile;
  const int b_rows = in_R ? dim : D;
  const float2* A = yt + (size_t)f * dim * T;
  const float2* B = in_R ? A : y + (size_t)f * D * T;
  const float* wf = w + (size_t)f * T;

  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  float2 acc[kSub][kSub];
#pragma unroll
  for (int i = 0; i < kSub; ++i)
#pragma unroll
    for (int j = 0; j < kSub; ++j) acc[i][j] = make_float2(0.f, 0.f);

  for (int t0 = 0; t0 < T; t0 += kChunk) {
    __syncthreads();  // the previous chunk's readers are done
    // one warp per row and 32 consecutive frames: coalesced reads; rows
    // and frames past the end are zero (they add exactly nothing)
    for (int idx = threadIdx.x; idx < kTile * kChunk; idx += kThreads) {
      const int r = idx / kChunk;
      const int t = idx - r * kChunk;
      const int tt = t0 + t;
      float2 va = make_float2(0.f, 0.f), vb = make_float2(0.f, 0.f);
      if (tt < T) {
        if (a0 + r < dim) {
          const float wt = wf[tt];
          va = A[(size_t)(a0 + r) * T + tt];
          va.x *= wt;
          va.y *= wt;
        }
        if (b0 + r < b_rows) vb = B[(size_t)(b0 + r) * T + tt];
      }
      sA[t * kStride + r] = va;
      sB[t * kStride + r] = vb;
    }
    __syncthreads();

#pragma unroll 4
    for (int t = 0; t < kChunk; ++t) {
      float2 av[kSub], bv[kSub];
#pragma unroll
      for (int i = 0; i < kSub; ++i) av[i] = sA[t * kStride + ty + 16 * i];
#pragma unroll
      for (int j = 0; j < kSub; ++j) bv[j] = sB[t * kStride + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < kSub; ++i)
#pragma unroll
        for (int j = 0; j < kSub; ++j) {
          // acc += a * conj(b)
          acc[i][j].x = fmaf(av[i].x, bv[j].x,
                             fmaf(av[i].y, bv[j].y, acc[i][j].x));
          acc[i][j].y = fmaf(av[i].y, bv[j].x,
                             fmaf(-av[i].x, bv[j].y, acc[i][j].y));
        }
    }
  }

#pragma unroll
  for (int i = 0; i < kSub; ++i) {
    const int a = a0 + ty + 16 * i;
    if (a >= dim) continue;
#pragma unroll
    for (int j = 0; j < kSub; ++j) {
      const int b = b0 + tx + 16 * j;
      if (in_R) {
        if (b > a) continue;  // b >= dim implies b > a
        R[((size_t)f * dim + a) * dim + b] = acc[i][j];
        if (b < a)
          R[((size_t)f * dim + b) * dim + a] =
              make_float2(acc[i][j].x, -acc[i][j].y);
      } else if (b < D) {
        P[((size_t)f * dim + a) * D + b] = acc[i][j];
      }
    }
  }
}

}  // namespace

extern "C" {

// Launch on `stream`; returns the cudaError_t of the launch (0 = success).
int pb_wpe_statistics(const void* yt, const void* y, const void* w, void* R,
                      void* P, int F, int dim, int D, int T, void* stream) {
  if (F < 1 || dim < 1 || D < 1 || T < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int row_tiles = (dim + kTile - 1) / kTile;
  const int col_tiles = row_tiles + (D + kTile - 1) / kTile;
  const long long blocks = (long long)F * row_tiles * col_tiles;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  wpe_stats_kernel<<<(unsigned)blocks, kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(yt), static_cast<const float2*>(y),
      static_cast<const float*>(w), static_cast<float2*>(R),
      static_cast<float2*>(P), dim, D, T, row_tiles, col_tiles);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
