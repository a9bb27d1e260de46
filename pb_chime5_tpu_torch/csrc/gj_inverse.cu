// Batched Gauss-Jordan inverse and log-determinant of small Hermitian
// positive-definite matrices, and the whole cacGMM EM finalize around it,
// for Hopper (sm_90a), CUDA C++.
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
// and gains the floor of the EM's default inverse, the plain unpivoted
// Gauss-Jordan with a relative pivot floor (ops/linalg.py::
// gauss_jordan_inverse_and_logdet, the JAX package's XLA inverse), so
// that the default path runs on it too.  Three floor modes, one template:
//
//   kFltMin (K3) and kFlushedLog (K4): the classic in-place form.  At
//     step i the columns of the A half left of i and the identity half
//     right of i are exact unit vectors and are not stored:
//       q_c = m_ic / p  (c != i),   q_i = 1 / p      (normalized pivot row)
//       f_r = m_ri      (r != i)                     (elimination factors)
//       m_rc <- (c == i ? 0 : m_rc) - f_r q_c  (r != i),   m_ic <- q_c
//   kRelative: the plain version's formula, operation for operation: the
//     complex pivot, safe = |pivot| > pivfloor ? pivot : pivfloor with
//     pivfloor = max(max_i Re a_ii * eps, FLT_MIN) over the input's
//     diagonal; inv = 1 / safe (complex); the rank-1 update of the whole
//     matrix, m_rc <- m_rc - m_rp (m_pc inv); then row p gains m_pc inv
//     (inv at c = p) and column p gains -m_rp inv (r != p): the rounding
//     residuals of row and column p stay, as in the plain version;
//     logdet += log(max(Re pivot, pivfloor)).
//
// Complex arithmetic rounds as PyTorch's CUDA kernels round c10::complex
// (probed bit for bit on an H100, scripts_dev/diag_k3_card.py): the
// product a*c - b*d, a*d + b*c with the first product of each part fused,
// fma(a, c, -(b*d)) and fma(a, d, b*c); the quotient in numpy's scaled
// form with its denominator fused.  The fusions are written out with
// intrinsics, so no contraction choice of the compiler can move them.  A
// Python scalar divisor is applied as the product with its float
// reciprocal, as PyTorch's CUDA division by a CPU scalar does.
//
// The finalize entry runs, per (frequency, class), the EM finalize of
// ops/kernels/gj_inverse.py::em_finalize_reference in its order:
//   total = sum_k den_k (k = 0..K-1);  log_weight = log(max(den / max(total,
//   FLT_MIN) or 0, FLT_MIN));  S' = S * ((1 / max(den, 2D / FLT_MAX)) * D);
//   B = (S' + S'^H) * 0.5;  tr = sum_i Re B_ii * (1 / D);  B = tr <= FLT_MIN
//   ? I : B / tr;  B_ii += max(diagonal_floor * sum_i Re B_ii * (1 / D),
//   FLT_MIN);  then the inverse and logdet of B.  The two traces are summed
//   in the order of PyTorch's CUDA sum (torch_order_sum).
//
// What bounds it on this card: at the EM batch (513 x 5 matrices of
// 24 x 24) the finalize reads S (11.8 MB) and writes the precision
// (11.8 MB): 7.1 us at 3.35 TB/s; its ~8 D^3 flops a matrix (0.28 GFLOP)
// take 4.2 us at 67 TFLOP/s.  The inverse alone is a serial chain of D
// pivot steps per matrix, so latency, not bytes, is what a design for it
// has to beat.
//
// Design: one warp per matrix, the matrix in registers.  Lane c owns
// column c (D <= 32 lanes, 64 floats of matrix a lane); the pivot loop
// and the row loop are unrolled over 32 with a break at D, so every
// register index is static.  The pivot and column p reach every lane from
// lane p by __shfl_sync; the whole step needs no block barrier.  Lanes
// >= D compute on zeros and never write.  I/O is coalesced: lane c
// reads and writes column c of each row.  The finalize runs one CTA per
// frequency, one warp per class; each warp sums the frequency's den over k = 0..K-1 itself and stages its S
// through shared memory (rows padded to an odd stride, so the transposed
// read of the hermitization has no bank conflicts).  No atomics and one
// fixed order of every sum: the result is bit-identical run to run and
// independent of F and of the other matrices of the launch.  IEEE float32
// (no fast math).  Supported sizes: 1 <= D <= 32; the finalize 1 <= K <= 8.

#include <cuda_runtime.h>
#include <float.h>
#include <math.h>

#include <atomic>

namespace {

constexpr int kMaxD = 32;
constexpr int kMaxK = 8;            // classes (warps) of one frequency
constexpr int kInverseWarps = 4;    // matrices a CTA of the inverse entries
constexpr int kMaxWarps = 16;       // the launch bound: <= 128 registers
constexpr unsigned kFull = 0xffffffffu;

// floor modes, the C entries' `mode` (0 and 1 keep the meaning of the
// entry's earlier floor_reciprocal flag)
constexpr int kFlushedLog = 0;   // K4
constexpr int kFltMin = 1;       // K3
constexpr int kRelative = 2;     // ops/linalg.py's Gauss-Jordan

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  // c10::complex operator*=: (a + bi)(c + di) = (ac - bd) + (ad + bc) i
  return make_float2(__fmaf_rn(a.x, b.x, -__fmul_rn(a.y, b.y)),
                     __fmaf_rn(a.x, b.y, __fmul_rn(a.y, b.x)));
}

__device__ __forceinline__ float2 cdiv(float2 n, float2 v) {
  // c10::complex operator/= (numpy's scaled division)
  const float a = n.x, b = n.y, c = v.x, d = v.y;
  const float abs_c = fabsf(c), abs_d = fabsf(d);
  if (abs_c >= abs_d) {
    if (abs_c == 0.f && abs_d == 0.f) return make_float2(a / abs_c, b / abs_d);
    const float rat = d / c;
    const float scl = 1.0f / __fmaf_rn(d, rat, c);
    return make_float2(__fmul_rn(__fmaf_rn(b, rat, a), scl),
                       __fmul_rn(__fmaf_rn(-a, rat, b), scl));
  }
  const float rat = c / d;
  const float scl = 1.0f / __fmaf_rn(c, rat, d);
  return make_float2(__fmul_rn(__fmaf_rn(a, rat, b), scl),
                     __fmul_rn(__fmaf_rn(b, rat, -a), scl));
}

__device__ __forceinline__ float2 csub(float2 a, float2 b) {
  return make_float2(a.x - b.x, a.y - b.y);
}

__device__ __forceinline__ float2 cadd(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}

// torch.maximum / clamp_min: a NaN operand propagates
__device__ __forceinline__ float nanmax(float a, float b) {
  return a != a ? a : (b != b ? b : fmaxf(a, b));
}

// Row r of lane src's column (the pivot column), on every lane.  Staged
// instead through a per-warp shared-memory slice, written by the pivot's
// lane and read after a __syncwarp, the kernel ran 7-24 % slower
// (scripts_dev/diag_k3_card.py, which builds that form as a variant).
__device__ __forceinline__ float2 shfl2(float2 v, int src) {
  return make_float2(__shfl_sync(kFull, v.x, src),
                     __shfl_sync(kFull, v.y, src));
}

// The sum of the lanes' `v` (0 for lanes >= D), on every lane, in the
// order in which PyTorch's CUDA sum reduces a strided row of D <= 32 values
// (the plain version's torch.diagonal(B).sum(-1)): lane t holds v_t, then
// a tree over the warp, shfl_down offsets 16, 8, 4, 2, 1 (bit-equal to
// torch's sum on every (513, 5) batch of D = 1 .. 32 probed on an H100,
// scripts_dev/diag_k3_card.py).  A trace rounded otherwise rescales B by
// another rounding of 1 / tr, entry by entry, and the inverse of a
// covariance that only the jitter makes invertible turns that ulp into
// ~1e-1 of the precision.
__device__ __forceinline__ float torch_order_sum(float v) {
#pragma unroll
  for (int offset = 16; offset > 0; offset >>= 1)
    v += __shfl_down_sync(kFull, v, offset);
  return __shfl_sync(kFull, v, 0);
}

// m[p] for a p known only at run time: a select over the static indices
__device__ __forceinline__ float2 pick(const float2 (&m)[kMaxD], int p,
                                       int D) {
  float2 v = make_float2(0.f, 0.f);
#pragma unroll
  for (int r = 0; r < kMaxD; ++r) {
    if (r >= D) break;
    if (r == p) v = m[r];
  }
  return v;
}

// In place: m (lane c = column c) -> its inverse; returns the logdet.  The
// pivot loops are unrolled over 32, so that pick() folds to a static index
// (rolled, with pick() a select, the classic modes ran 13-36 % slower and
// the relative mode no faster: scripts_dev/diag_k3_card.py).
template <int MODE>
__device__ __forceinline__ float invert(float2 (&m)[kMaxD], int lane,
                                        int D) {
  float ld = 0.f;
  if (MODE == kRelative) {
    float mx = lane < D ? pick(m, lane, D).x : -INFINITY;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      mx = nanmax(mx, __shfl_xor_sync(kFull, mx, o));
    const float pivfloor = nanmax(mx * FLT_EPSILON, FLT_MIN);
#pragma unroll
    for (int p = 0; p < kMaxD; ++p) {
      if (p >= D) break;
      const float2 mp = pick(m, p, D);
      const float2 piv = shfl2(mp, p);
      const float2 safe = hypotf(piv.x, piv.y) > pivfloor
                              ? piv : make_float2(pivfloor, 0.f);
      const float2 inv = cdiv(make_float2(1.f, 0.f), safe);
      const float2 rown = cmul(mp, inv);
      const float2 rowfix = lane == p ? inv : rown;
#pragma unroll
      for (int r = 0; r < kMaxD; ++r) {
        if (r >= D) break;
        const float2 col = shfl2(m[r], p);
        float2 v = csub(m[r], cmul(col, rown));
        if (r == p) {
          v = cadd(v, rowfix);
        } else if (lane == p) {
          v = cadd(v, cmul(make_float2(-col.x, -col.y), inv));
        }
        m[r] = v;
      }
      ld += logf(nanmax(piv.x, pivfloor));
    }
    return ld;
  }
#pragma unroll
  for (int p = 0; p < kMaxD; ++p) {
    if (p >= D) break;
    const float2 mp = pick(m, p, D);
    const float a = shfl2(mp, p).x;   // real for Hermitian input
    float pv, lg;
    if (MODE == kFltMin) {
      pv = lg = nanmax(a, FLT_MIN);
    } else {
      pv = a;
      lg = a < FLT_MIN ? 0.f : a;   // max(a, 1e-38) with 1e-38 flushed
    }
    const float inv = 1.0f / pv;
    ld += logf(lg);
    const float2 q0 = lane == p ? make_float2(1.f, 0.f) : mp;
    const float2 q = make_float2(q0.x * inv, q0.y * inv);
#pragma unroll
    for (int r = 0; r < kMaxD; ++r) {
      if (r >= D) break;
      const float2 f = shfl2(m[r], p);
      const float2 keep = lane == p ? make_float2(0.f, 0.f) : m[r];
      m[r] = r == p ? q : csub(keep, cmul(f, q));
    }
  }
  return ld;
}

// One warp per matrix n = blockIdx.x * warps + warp.  FINALIZE: `in` is
// S (F, K, D, D), n = f * K + k, `den` (F, K); otherwise `in` holds the
// matrices (N, D, D).
template <int MODE, bool FINALIZE>
__global__ void __launch_bounds__(kMaxWarps * 32)
gj_kernel(const float2* __restrict__ in, const float* __restrict__ den,
          float2* __restrict__ out, float* __restrict__ logdet,
          float* __restrict__ log_weight, int N, int D, int K,
          float diagonal_floor, float denom_floor) {
  extern __shared__ float2 smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n = blockIdx.x * (blockDim.x >> 5) + warp;
  if (n >= N) return;
  const int DD = D * D;
  const size_t base = (size_t)n * DD;
  const bool owner = lane < D;

  float2 m[kMaxD];
#pragma unroll
  for (int r = 0; r < kMaxD; ++r) m[r] = make_float2(0.f, 0.f);
  float lw = 0.f;

  if (FINALIZE) {
    const int k = n % K;
    const float* dens = den + (size_t)(n - k);
    float total = 0.f;
    for (int j = 0; j < K; ++j) total += dens[j];
    const float dk = dens[k];
    const float weight = total > 0.f ? dk / nanmax(total, FLT_MIN) : 0.f;
    lw = logf(nanmax(weight, FLT_MIN));
    const float2 scale =
        make_float2((1.0f / nanmax(dk, denom_floor)) * (float)D, 0.f);
    // stage S: coalesced rows into an odd row stride
    const int stride = D | 1;
    float2* sm = smem + (size_t)warp * D * stride;
    for (int e = lane; e < DD; e += 32)
      sm[(e / D) * stride + e % D] = in[base + e];
    __syncwarp();
    const float2 half = make_float2(0.5f, 0.f);
#pragma unroll
    for (int r = 0; r < kMaxD; ++r) {
      if (r >= D) break;
      if (owner) {
        const float2 x = cmul(sm[r * stride + lane], scale);
        const float2 y = cmul(sm[lane * stride + r], scale);
        m[r] = cmul(make_float2(x.x + y.x, x.y - y.y), half);
      }
    }
    // trace normalization; a class with zero trace gets B = I
    const float inv_d = 1.0f / (float)D;
    const float tr = torch_order_sum(pick(m, lane, D).x) * inv_d;
    const bool zero = tr <= FLT_MIN;
    const float2 div = make_float2(zero ? 1.f : tr, 0.f);
#pragma unroll
    for (int r = 0; r < kMaxD; ++r) {
      if (r >= D) break;
      m[r] = zero ? make_float2(r == lane ? 1.f : 0.f, 0.f)
                  : cdiv(m[r], div);
    }
    // the trace-scaled jitter
    const float jitter = nanmax(
        torch_order_sum(pick(m, lane, D).x) * diagonal_floor * inv_d,
        FLT_MIN);
#pragma unroll
    for (int r = 0; r < kMaxD; ++r) {
      if (r >= D) break;
      if (r == lane) m[r].x += jitter;
    }
  } else {
#pragma unroll
    for (int r = 0; r < kMaxD; ++r) {
      if (r >= D) break;
      if (owner) m[r] = in[base + r * D + lane];
    }
  }

  const float ld = invert<MODE>(m, lane, D);

  if (owner) {
#pragma unroll
    for (int r = 0; r < kMaxD; ++r) {
      if (r >= D) break;
      out[base + r * D + lane] = m[r];
    }
  }
  if (lane == 0) {
    logdet[n] = ld;
    if (FINALIZE) log_weight[n] = lw;
  }
}

// The finalize's dynamic shared memory: S of each class of a CTA, rows at an
// odd stride
size_t finalize_smem(int K, int D) {
  return (size_t)K * D * (D | 1) * sizeof(float2);
}

// Opts a finalize instantiation in, once per device, to the shared memory of
// its largest launch (K = kMaxK, D = kMaxD: 66 KB, above the 48 KB default)
template <int MODE>
cudaError_t opt_in() {
  static std::atomic<unsigned long long> done{0};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  const unsigned long long bit = 1ull << (device & 63);
  if (err != cudaSuccess || (done.load() & bit)) return err;
  err = cudaFuncSetAttribute(gj_kernel<MODE, true>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(finalize_smem(kMaxK, kMaxD)));
  if (err == cudaSuccess) done.fetch_or(bit);
  return err;
}

template <int MODE, bool FINALIZE>
int launch(const void* in, const void* den, void* out, void* logdet,
           void* log_weight, int N, int D, int K, float diagonal_floor,
           float denom_floor, int warps, size_t smem, cudaStream_t st) {
  const auto kernel = gj_kernel<MODE, FINALIZE>;
  if (FINALIZE) {
    const cudaError_t err = opt_in<MODE>();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<(N + warps - 1) / warps, warps * 32, smem, st>>>(
      static_cast<const float2*>(in), static_cast<const float*>(den),
      static_cast<float2*>(out), static_cast<float*>(logdet),
      static_cast<float*>(log_weight), N, D, K, diagonal_floor, denom_floor);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Inverse and logdet of N matrices (N, D, D) complex64 on `stream`.  mode:
// 0 = K4's flushed log floor, 1 = K3's FLT_MIN floor, 2 = the relative
// floor.  Returns the cudaError_t of the launch (0 = success).
int pb_gj_inverse(const void* in, void* out, void* logdet, int N, int D,
                  int mode, void* stream) {
  if (N < 1 || D < 1 || D > kMaxD)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case kFlushedLog:
      return launch<kFlushedLog, false>(in, nullptr, out, logdet, nullptr, N,
                                        D, 1, 0.f, 0.f, kInverseWarps, 0, st);
    case kFltMin:
      return launch<kFltMin, false>(in, nullptr, out, logdet, nullptr, N, D,
                                    1, 0.f, 0.f, kInverseWarps, 0, st);
    case kRelative:
      return launch<kRelative, false>(in, nullptr, out, logdet, nullptr, N,
                                      D, 1, 0.f, 0.f, kInverseWarps, 0, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The EM finalize of S (F, K, D, D) complex64 and den (F, K) float32 into
// precision (F, K, D, D), logdet (F, K) and log_weight (F, K) on `stream`;
// mode 1 (K3's FLT_MIN floor) or 2 (the relative floor).  denom_floor is
// the float32 value of 2 D / FLT_MAX.
int pb_em_finalize(const void* S, const void* den, void* precision,
                   void* logdet, void* log_weight, int F, int K, int D,
                   int mode, float diagonal_floor, float denom_floor,
                   void* stream) {
  if (F < 1 || K < 1 || K > kMaxK || D < 1 || D > kMaxD)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  static_assert(kMaxK <= kMaxWarps, "launch bound");
  const int warps = K;   // one CTA a frequency
  const size_t smem = finalize_smem(K, D);
  switch (mode) {
    case kFltMin:
      return launch<kFltMin, true>(S, den, precision, logdet, log_weight,
                                   F * K, D, K, diagonal_floor, denom_floor,
                                   warps, smem, st);
    case kRelative:
      return launch<kRelative, true>(S, den, precision, logdet, log_weight,
                                     F * K, D, K, diagonal_floor, denom_floor,
                                     warps, smem, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
