// Batched real SPD solve A X = B by unpivoted blocked Cholesky, for
// Hopper (sm_90a), CUDA C++: the WPE filter solve R G = P in its real
// block form.
//
// Replaces the Pallas TPU kernel K5, pb_chime5_tpu/ops/pallas/
// chol_solve.py (_kernel, called by chol_solve_real_spd).  Per batch
// element (one frequency), A (S, S) float32 SPD with S % 32 == 0 and
// B (S, E):
//
//   for each 32-wide panel j (c0 = 32 j):
//     factor the diagonal block in 32 steps: pivot p -> r = sqrt(max(p,
//     FLT_MIN)), the column below it divided by r, the rank-1 update of
//     the columns to its right, and row p of inv(L11) = (e_p - L[p, :p]
//     inv(L11)[:p, :]) / r;
//     L21 = A21 inv(L11)^T;   A22 -= L21 L21^T;
//   forward substitution  y_j = inv(L11_j) y_j,   y_below -= L21_j y_j;
//   back substitution     x_j = inv(L11_j)^T y_j, y_above -= L_j^T x_j,
//
// the TPU kernel's algorithm and floor.  Its operations and their order
// are kept: every product is a sum over the 32-wide panel in ascending
// order, no atomics, so the result is the same run to run.  The TPU
// kernel updates the whole trailing square (A22 stays exactly symmetric);
// this kernel updates its lower 32 x 32 tiles and reads A12 as A21^T,
// the same numbers.
//
// What bounds it on this card: at the WPE headline (513 frequencies,
// the 240 x 240 complex R as a 480 -> 512 real block, E = 24) the
// function needs the complex Hermitian Cholesky and two substitutions,
// 15.1 GFLOP (0.23 ms at 67 TFLOP/s fp32) against 166 MB of R's lower
// triangle, P and G (0.05 ms at 3.35 TB/s): operations.  The TPU kernel's
// design keeps three S x S matrices in VMEM (3 MB at S = 512); a Hopper
// block has at most 227 KB of shared memory, so here:
//
//   * one block of 256 threads per frequency (513 blocks, ~4 waves);
//   * the matrix is factored in a global-memory working copy W (the
//     first panel reads the input A, everything after reads W; the input
//     is never written).  W ends holding L21 below each diagonal block
//     and inv(L11) in it, for the back substitution;
//   * the diagonal block is factored by one warp, a row per lane in
//     registers, pivots and columns passed by shuffles; inv(L11) is built
//     column per lane in the same 32 steps;
//   * the panel L21 (S x 32, 64 KB) is kept transposed in shared memory,
//     so the trailing update A22 -= L21 L21^T reads two float4 per k
//     and accumulates a 4 x 4 register tile per thread, one 32 x 32
//     lower tile per 64 threads;
//   * the S x E right-hand sides stay in shared memory for both
//     substitutions; the forward substitution runs right after each
//     panel is factored (it needs only that panel).
//
// The trailing updates move ~2.6 GB through device memory at the
// headline (each lower tile read and written once per panel), ~0.8 ms
// at the HBM rate, and the 512 pivot steps per frequency are serial.
// IEEE float32 only (no fast math): division and square root round
// correctly, so the FLT_MIN floor gives exactly 1 / FLT_MIN on a zero
// pivot, as the TPU kernel does.

#include <cuda_runtime.h>
#include <float.h>
#include <math.h>

namespace {

constexpr int kB = 32;             // panel width (the TPU kernel's _BLOCK)
constexpr int kThreads = 256;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float floor_pivot(float p) {
  // jnp.maximum(p, tiny): NaN propagates (fmaxf alone would drop it)
  return isnan(p) ? p : fmaxf(p, FLT_MIN);
}

__global__ void __launch_bounds__(kThreads)
chol_solve_kernel(const float* __restrict__ a_all,   // (F, S, S)
                  const float* __restrict__ b_all,   // (F, S, E)
                  float* __restrict__ w_all,         // (F, S, S) scratch
                  float* __restrict__ x_all,         // (F, S, E)
                  int S, int E) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* pt = smem;                  // [kB][S]  panel L21^T / L block rows
  float* inv = pt + kB * S;          // [kB][kB] inv(L11), row-major
  float* y = inv + kB * kB;          // [S][E]   right-hand sides
  float* yj = y + S * E;             // [kB][E]  current solved block

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const size_t f = blockIdx.x;
  const float* A = a_all + f * S * S;
  float* W = w_all + f * S * S;
  const float* B = b_all + f * S * E;
  float* X = x_all + f * S * E;
  const int NB = S / kB;

  for (int i = tid; i < S * E; i += kThreads) y[i] = B[i];

  for (int j = 0; j < NB; ++j) {
    const int c0 = j * kB;
    const int m = S - c0 - kB;               // rows below the panel
    const float* src = j == 0 ? A : W;

    // ---- diagonal block: L11 and inv(L11), one warp ----
    if (warp == 0) {
      float prow[kB];                        // row `lane` of the block
      const float4* rp = reinterpret_cast<const float4*>(
          src + (size_t)(c0 + lane) * S + c0);
#pragma unroll
      for (int q = 0; q < kB / 4; ++q) {
        const float4 v = rp[q];
        prow[4 * q] = v.x; prow[4 * q + 1] = v.y;
        prow[4 * q + 2] = v.z; prow[4 * q + 3] = v.w;
      }
      float invc[kB];                        // column `lane` of inv(L11)
#pragma unroll
      for (int q = 0; q < kB; ++q) invc[q] = 0.f;
#pragma unroll
      for (int p = 0; p < kB; ++p) {
        const float rpiv = sqrtf(floor_pivot(__shfl_sync(kFull, prow[p], p)));
        // rows above the pivot hold eliminated values: masked out
        const float lcol = lane >= p ? prow[p] / rpiv : 0.f;
#pragma unroll
        for (int c = p + 1; c < kB; ++c)
          prow[c] -= lcol * __shfl_sync(kFull, lcol, c);
        prow[p] = lcol;
        // row p of inv(L11): (e_p - L[p, :p] inv[:p, :]) / rpiv
        float acc = 0.f;
#pragma unroll
        for (int q = 0; q < p; ++q)
          acc += __shfl_sync(kFull, prow[q], p) * invc[q];
        invc[p] = ((lane == p ? 1.f : 0.f) - acc) / rpiv;
      }
      __syncwarp();                          // every lane has read its row
#pragma unroll
      for (int q = 0; q < kB; ++q) {
        inv[q * kB + lane] = invc[q];
        W[(size_t)(c0 + q) * S + c0 + lane] = invc[q];
      }
    }
    __syncthreads();

    // ---- L21 = A21 inv(L11)^T: a row per thread ----
    for (int r = tid; r < m; r += kThreads) {
      float arow[kB];
      const float4* rp = reinterpret_cast<const float4*>(
          src + (size_t)(c0 + kB + r) * S + c0);
#pragma unroll
      for (int q = 0; q < kB / 4; ++q) {
        const float4 v = rp[q];
        arow[4 * q] = v.x; arow[4 * q + 1] = v.y;
        arow[4 * q + 2] = v.z; arow[4 * q + 3] = v.w;
      }
      float4* wp = reinterpret_cast<float4*>(W + (size_t)(c0 + kB + r) * S
                                             + c0);
#pragma unroll
      for (int c4 = 0; c4 < kB / 4; ++c4) {
        float out[4];
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) {
          const float* ic = inv + (4 * c4 + cc) * kB;
          float acc = 0.f;
#pragma unroll
          for (int k = 0; k < kB; ++k) acc += arow[k] * ic[k];
          out[cc] = acc;
          pt[(4 * c4 + cc) * S + r] = acc;
        }
        wp[c4] = make_float4(out[0], out[1], out[2], out[3]);
      }
    }

    // ---- forward substitution of this panel ----
    for (int i = tid; i < kB * E; i += kThreads) {
      const int row = i / E, e = i - (i / E) * E;
      float acc = 0.f;
      for (int k = 0; k < kB; ++k)
        acc += inv[row * kB + k] * y[(c0 + k) * E + e];
      yj[i] = acc;
    }
    __syncthreads();                        // yj and pt complete
    for (int i = tid; i < kB * E; i += kThreads) y[c0 * E + i] = yj[i];
    for (int i = tid; i < m * E; i += kThreads) {
      const int r = i / E, e = i - (i / E) * E;
      float acc = 0.f;
      for (int k = 0; k < kB; ++k) acc += pt[k * S + r] * yj[k * E + e];
      y[(c0 + kB + r) * E + e] -= acc;
    }

    // ---- trailing update A22 -= L21 L21^T, lower 32 x 32 tiles ----
    if (m > 0) {
      const int g = tid >> 6;                // 4 groups of 64 threads
      const int ty = (tid & 63) >> 3, tx = tid & 7;
      const int nt = m / kB;
      int t = 0;
      for (int R = 0; R < nt; ++R) {
        for (int C = 0; C <= R; ++C, ++t) {
          if ((t & 3) != g) continue;
          float acc[4][4] = {};
          for (int k = 0; k < kB; ++k) {
            const float4 a4 = *reinterpret_cast<const float4*>(
                pt + k * S + R * kB + 4 * ty);
            const float4 b4 = *reinterpret_cast<const float4*>(
                pt + k * S + C * kB + 4 * tx);
            const float av[4] = {a4.x, a4.y, a4.z, a4.w};
            const float bv[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
            for (int ii = 0; ii < 4; ++ii)
#pragma unroll
              for (int jj = 0; jj < 4; ++jj) acc[ii][jj] += av[ii] * bv[jj];
          }
#pragma unroll
          for (int ii = 0; ii < 4; ++ii) {
            const size_t off = (size_t)(c0 + kB + R * kB + 4 * ty + ii) * S
                               + c0 + kB + C * kB + 4 * tx;
            const float4 w = *reinterpret_cast<const float4*>(src + off);
            *reinterpret_cast<float4*>(W + off) = make_float4(
                w.x - acc[ii][0], w.y - acc[ii][1], w.z - acc[ii][2],
                w.w - acc[ii][3]);
          }
        }
      }
    }
    __syncthreads();                        // W and y complete
  }

  // ---- back substitution: L^T x = y ----
  for (int j = NB - 1; j >= 0; --j) {
    const int c0 = j * kB;
    for (int i = tid; i < kB * kB; i += kThreads)
      inv[i] = W[(size_t)(c0 + i / kB) * S + c0 + (i & (kB - 1))];
    if (j > 0) {                            // L[c0:c0+32, :c0] -> pt[k][r]
      for (int i = tid; i < kB * c0; i += kThreads) {
        const int k = i / c0, r = i - (i / c0) * c0;
        pt[k * S + r] = W[(size_t)(c0 + k) * S + r];
      }
    }
    __syncthreads();
    for (int i = tid; i < kB * E; i += kThreads) {
      const int row = i / E, e = i - (i / E) * E;
      float acc = 0.f;
      for (int k = 0; k < kB; ++k)
        acc += inv[k * kB + row] * y[(c0 + k) * E + e];
      yj[i] = acc;
      X[c0 * E + i] = acc;
    }
    __syncthreads();
    for (int i = tid; i < c0 * E; i += kThreads) {
      const int r = i / E, e = i - (i / E) * E;
      float acc = 0.f;
      for (int k = 0; k < kB; ++k) acc += pt[k * S + r] * yj[k * E + e];
      y[r * E + e] -= acc;
    }
    __syncthreads();
  }
}

size_t smem_bytes(int S, int E) {
  return sizeof(float) * ((size_t)kB * S + kB * kB + (size_t)S * E + kB * E);
}

}  // namespace

extern "C" {

// Launch on `stream`: a (F, S, S), b (F, S, E) float32 contiguous, work
// (F, S, S) float32 scratch, x (F, S, E) float32 output.  S % 32 == 0 and
// the shared memory of S and E must fit one block.  Returns the
// cudaError_t of the launch (0 = success).
int pb_chol_solve(const void* a, const void* b, void* work, void* x, int F,
                  int S, int E, void* stream) {
  const size_t smem = smem_bytes(S, E);
  if (F < 1 || S < kB || S % kB != 0 || E < 1 || smem > 232448)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      chol_solve_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  chol_solve_kernel<<<F, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<float*>(work), static_cast<float*>(x), S, E);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
