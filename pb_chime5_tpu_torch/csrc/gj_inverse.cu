// Batched Gauss-Jordan inverse and log-determinant of small Hermitian
// positive-definite matrices for Hopper (sm_90a), CUDA C++.
//
// Replaces two Pallas TPU kernels that compute the same math in two TPU
// layouts (a flat (batch, D*D) plane and a (D, D, batch) block):
//
//   K3 pb_chime5_tpu/ops/pallas/gj_inverse2d.py (_gj2d_kernel), the EM
//      inverse of bss_inverse='pallas_gj': the pivot p = max(Re a_ii,
//      FLT_MIN) enters both the log-determinant and the reciprocal;
//   K4 pb_chime5_tpu/ops/pallas/hermitian_inverse.py (_gj_kernel): the
//      log-determinant takes log(max(Re a_ii, 1e-38)), the reciprocal
//      takes the UNFLOORED Re a_ii.  1e-38 is a float32 subnormal, which
//      XLA flushes to zero (on the CPU and the TPU alike), so that floor
//      runs as "below FLT_MIN -> 0": a non-positive pivot gives log 0 =
//      -inf.  This kernel reproduces the floor as it runs.
//
// One kernel serves both entries; the floor mode is a template parameter.
// On HPD input the two modes agree; they differ only on a non-positive
// pivot.  Unpivoted elimination is safe for HPD input for the reason
// Cholesky is: the trailing submatrices stay HPD, so every pivot is real
// and positive (the EM adds its trace-scaled jitter first).
//
// Math: Gauss-Jordan on [A | I], stored in place in the classic form.  At
// step i the columns of the A half left of i and the identity half right
// of i are exact unit vectors and are not stored, so one D x D array holds
// the live part of [A | P]:
//
//   q_c = m_ic / p  (c != i),   q_i = 1 / p         (normalized pivot row)
//   f_r = m_ri      (r != i),   f_i = 0             (elimination factors)
//   m_rc <- (c == i ? 0 : m_rc) - f_r q_c  (r != i),   m_ic <- q_c
//   logdet += log(p)   (one thread, in pivot order)
//
// which is the TPU kernels' update of [A | P] entry for entry (their
// identity-half entries that are exactly 0 or 1 are the constants here).
//
// What bounds it on this card: at the EM batch (2565 matrices of 24 x 24)
// a Hermitian inverse needs ~4 D^3 flops per matrix (Cholesky-based;
// this kernel's Gauss-Jordan issues ~8 D^3), 0.14 GFLOP (2.1 us at
// 67 TFLOP/s fp32), and reading the input's lower triangle and writing
// the inverse is 18.0 MB (5.4 us at 3.35 TB/s): memory-bound, at launch
// scale.  The plain PyTorch version
// rewrites the whole batch in device memory at every pivot step (~15
// launches a step, 24 steps); this kernel reads the batch once, keeps each
// matrix in shared memory across all D steps and writes the inverse once.
//
// Design (simple and right first): one block of 64 threads per matrix;
// the matrix (<= 8 KB) sits in shared memory; each pivot step is a
// snapshot of the pivot row and column, __syncthreads(), the rank-1
// update with each thread owning fixed elements, __syncthreads().  No
// atomics: the result is bit-identical run to run.  IEEE float32 only
// (no fast math).  Supported sizes: 1 <= D <= 32.

#include <cuda_runtime.h>
#include <float.h>
#include <math.h>

namespace {

constexpr int kMaxD = 32;
constexpr int kThreads = 64;
constexpr int kPerThread = kMaxD * kMaxD / kThreads;   // owned elements
static_assert(2 * kMaxD <= kThreads, "one thread per pivot row/column entry");

// FLOOR_RECIPROCAL: true = K3 (floored pivot for log and reciprocal),
//                   false = K4 (floored log, unfloored reciprocal)
template <bool FLOOR_RECIPROCAL>
__global__ void __launch_bounds__(kThreads)
gj_inverse_kernel(const float2* __restrict__ in,   // (N, D, D)
                  float2* __restrict__ out,        // (N, D, D)
                  float* __restrict__ logdet,      // (N,)
                  int D) {
  __shared__ float2 sM[kMaxD * kMaxD];
  __shared__ float2 sRow[kMaxD];
  __shared__ float2 sCol[kMaxD];

  const int tid = threadIdx.x;
  const int DD = D * D;
  const size_t base = (size_t)blockIdx.x * DD;

  // this thread's elements e = tid + k * kThreads: row and column, -1 past
  // the end
  int rr[kPerThread], cc[kPerThread];
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    const int e = tid + k * kThreads;
    rr[k] = e < DD ? e / D : -1;
    cc[k] = e < DD ? e - (e / D) * D : 0;
  }
#pragma unroll
  for (int k = 0; k < kPerThread; ++k)
    if (rr[k] >= 0) sM[tid + k * kThreads] = in[base + tid + k * kThreads];

  float ld = 0.f;
  for (int i = 0; i < D; ++i) {
    __syncthreads();  // the load or the previous step's update is complete
    const float a = sM[i * D + i].x;  // real for Hermitian input
    float pv, lg;
    if (FLOOR_RECIPROCAL) {
      pv = fmaxf(a, FLT_MIN);
      lg = pv;
    } else {
      pv = a;
      lg = a < FLT_MIN ? 0.f : a;  // max(a, 1e-38) with 1e-38 flushed
    }
    const float inv = 1.0f / pv;
    if (tid == 0) ld += logf(lg);
    if (tid < D) {
      const float2 m = tid == i ? make_float2(1.f, 0.f) : sM[i * D + tid];
      sRow[tid] = make_float2(m.x * inv, m.y * inv);
    } else if (tid < 2 * D) {
      const int r = tid - D;
      sCol[r] = r == i ? make_float2(0.f, 0.f) : sM[r * D + i];
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kPerThread; ++k) {
      const int r = rr[k], c = cc[k];
      if (r < 0) continue;
      const int e = tid + k * kThreads;
      const float2 q = sRow[c];
      if (r == i) {
        sM[e] = q;
      } else {
        const float2 f = sCol[r];
        const float2 m = c == i ? make_float2(0.f, 0.f) : sM[e];
        sM[e] = make_float2(m.x - (f.x * q.x - f.y * q.y),
                            m.y - (f.x * q.y + f.y * q.x));
      }
    }
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < kPerThread; ++k)
    if (rr[k] >= 0) out[base + tid + k * kThreads] = sM[tid + k * kThreads];
  if (tid == 0) logdet[blockIdx.x] = ld;
}

}  // namespace

extern "C" {

// Launch on `stream`; floor_reciprocal != 0 selects K3's floors, 0 K4's.
// Returns the cudaError_t of the launch (0 = success).
int pb_gj_inverse(const void* in, void* out, void* logdet, int N, int D,
                  int floor_reciprocal, void* stream) {
  if (N < 1 || D < 1 || D > kMaxD)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float2* a = static_cast<const float2*>(in);
  float2* x = static_cast<float2*>(out);
  float* ld = static_cast<float*>(logdet);
  if (floor_reciprocal)
    gj_inverse_kernel<true><<<N, kThreads, 0, st>>>(a, x, ld, D);
  else
    gj_inverse_kernel<false><<<N, kThreads, 0, st>>>(a, x, ld, D);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
