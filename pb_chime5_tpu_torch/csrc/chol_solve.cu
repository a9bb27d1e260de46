// Batched Hermitian / SPD solve A X = B by unpivoted blocked Cholesky,
// for Hopper (sm_90a), CUDA C++: the WPE filter solve R G = P.
//
// Replaces the Pallas TPU kernel K5, pb_chime5_tpu/ops/pallas/
// chol_solve.py (_kernel, called by chol_solve_real_spd), and computes
// what the JAX package's default WPE solve computes in XLA,
// pb_chime5_tpu/ops/linalg.py::hermitian_solve(method='chol')
// (_cholesky_panels + _solve_from_panels).  One source, two
// instantiations of one kernel, one CTA per frequency:
//
//   complex (pb_hermitian_solve_chol): A (F, d, d) complex64 Hermitian,
//     32 < d <= 256, B (F, d, E).  The kernel runs linalg.equilibrate
//     (scales floored at eps max(diag), an all-zero matrix unscaled), the
//     hermitize (A_ij s_i s_j and A_ji s_j s_i both read and averaged, as
//     the plain version rounds them), the diagonal load, the padding to a
//     multiple of 32 with an identity block, the factor with each pivot
//     floored relative to the matrix at eps^2 max(diag) (the padding's
//     ones counted, as JAX takes the maximum after padding), the two
//     substitutions, `refine` refinement steps against the unloaded
//     matrix and the unscale.
//   real (pb_chol_solve): A (F, S, S) float32 SPD, S % 32 == 0, B (F, S,
//     E), used as given, each pivot floored at FLT_MIN: the TPU kernel.
//
// Per frequency, right-looking in 32-wide panels j, JAX's
// _cholesky_panels and _solve_from_panels step for step:
//
//   factor the diagonal block in 32 steps: r = sqrt(max(pivot, floor)),
//     the column masked below the pivot and divided by r, the columns to
//     its right updated with multipliers taken from that column (never
//     from the pivot row: lower-triangle dataflow only), and row p of
//     inv(L11) = (e_p - L[p, :p] inv(L11)[:p, :]) / r;
//   L21 = A21 inv(L11)^H;   trailing update A22 -= L21 L21^H;
//   forward substitution, left-looking: y_j = inv(L11) (b_j - L[j, :j] y);
//   back substitution, left-looking: x_j = inv(L11)^H (y_j - L21_j^H x).
//
// Values are stored in float32; the diagonal block's steps, L21 and the
// applications of inv(L11) sum their products in float64, the trailing
// update and the substitutions' long sums in float32 without fused
// multiply-adds (below): the plain version performs the same roundings,
// so the two are bit-equal, and the card's chain agrees with the CPU's.
//
// What bounds it: at the WPE headline (513 frequencies, d = 240, E = 24)
// the complex factor and two substitutions are 15.1 GFLOP (0.226 ms at
// 67 TFLOP/s fp32) against 166 MB of R's lower triangle, P and G (0.05 ms
// at 3.35 TB/s): operations.  The design:
//
//   * the complex Hermitian form, lower triangle only: d = 240 is 8
//     panels; the padding rows are zero below the diagonal (their work is
//     done on zeros, their storage is part of the 32-row tiles);
//   * one CTA of 8 warps a frequency; the factor's lower 32 x 32 tiles
//     live in a packed global scratch (36 tiles, 288 KB per frequency;
//     ~38 MB for the 132 resident frequencies, inside the 50 MB L2); the
//     first panel reads the input A directly (equilibrated on the fly);
//     the scratch ends holding inv(L11) on each diagonal tile and L21
//     below it, for the substitutions and the refinement;
//   * the panel's L21 and the next panel's A21 (transposed, k-major) stay
//     in shared memory: the trailing update writes the next block
//     column's tiles straight into A21, the others to the scratch; every
//     warp owns whole tiles, each lane a 4 x 8 complex register tile;
//   * look-ahead: warp 0 updates the next diagonal tile first, into
//     shared memory, and factors it with warp 1 while warps 2-7 finish
//     the trailing update: warp 0 runs the 32 Cholesky steps (rolled: the
//     unrolled steps are ~10k instructions one warp streams once per
//     panel, and ran slower), warp 1 the rows of inv(L11) one step
//     behind, the two meeting at a named barrier each step;
//   * the right-hand sides stay in shared memory (d x E).
//
// No TF32, no fast math: float32 division and square root round
// correctly (a zero pivot gives exactly 1 / FLT_MIN in the real
// instantiation).  Every sum has a fixed order and there are no atomics:
// the result is the same run to run, and a frequency solved alone is bit
// equal to the same frequency inside a batch.

#include <cuda_runtime.h>
#include <float.h>
#include <math.h>

namespace {

constexpr int kB = 32;             // panel width (the TPU kernel's _BLOCK)
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxSmem = 232448;   // one block's shared memory on an H100

// ---- scalar arithmetic of the two instantiations -------------------------

__device__ __forceinline__ float unit_of(float, bool one) {
  return one ? 1.f : 0.f;
}
__device__ __forceinline__ float2 unit_of(float2, bool one) {
  return make_float2(one ? 1.f : 0.f, 0.f);
}
__device__ __forceinline__ float re(float a) { return a; }
__device__ __forceinline__ float re(float2 a) { return a.x; }
// Values are stored in float32.  Every product of JAX's graph (a matmul,
// or the diagonal block's rank-1 and row updates) is a sum in a fixed
// order, rounded to float32 once; the subtractions, divisions and square
// roots around the products run in float32 as JAX runs them.  The sums
// the solve's accuracy needs (the diagonal block's steps, L21 and the
// applications of inv(L11)) run in float64 fused multiply-adds on
// operands widened once: the product of two float32 values is exact in
// float64, so each step rounds as the plain version's separate float64
// multiply and add (ops/kernels/chol_solve.py::_dot).  The bulk (the
// trailing update, the substitutions' long sums) runs in float32 with
// each product and sum rounded, no fused multiply-add (_dot_own).  The
// two agree bit for bit.  In float32 arithmetic throughout, these panels
// with their explicit block inverses lose ~5x LAPACK's accuracy on WPE
// statistics.  The real instantiation (the TPU kernel's function, on no
// path of the chain) sums in float32 fused multiply-adds.
template <typename T> struct Wide;
template <> struct Wide<float> { using type = float; };
template <> struct Wide<float2> { using type = double2; };
template <typename T> using wide_t = typename Wide<T>::type;

__device__ __forceinline__ float wide(float a) { return a; }
__device__ __forceinline__ double2 wide(float2 a) {
  return make_double2(a.x, a.y);
}
__device__ __forceinline__ float rnd(float s) { return s; }
__device__ __forceinline__ float2 rnd(double2 s) {
  return make_float2(__double2float_rn(s.x), __double2float_rn(s.y));
}
// float64 sums (complex; the real instantiation fuses in float32):
// s += a b
__device__ __forceinline__ void madd(float& s, float a, float b) {
  s = fmaf(a, b, s);
}
__device__ __forceinline__ void madd(double2& s, double2 a, double2 b) {
  s.x = fma(a.x, b.x, s.x);
  s.x = fma(-a.y, b.y, s.x);
  s.y = fma(a.x, b.y, s.y);
  s.y = fma(a.y, b.x, s.y);
}
// s += a conj(b)
__device__ __forceinline__ void madd_cj(float& s, float a, float b) {
  s = fmaf(a, b, s);
}
__device__ __forceinline__ void madd_cj(double2& s, double2 a, double2 b) {
  s.x = fma(a.x, b.x, s.x);
  s.x = fma(a.y, b.y, s.x);
  s.y = fma(-a.x, b.y, s.y);
  s.y = fma(a.y, b.x, s.y);
}
// s += conj(a) b
__device__ __forceinline__ void madd_cja(float& s, float a, float b) {
  s = fmaf(a, b, s);
}
__device__ __forceinline__ void madd_cja(double2& s, double2 a, double2 b) {
  s.x = fma(a.x, b.x, s.x);
  s.x = fma(a.y, b.y, s.x);
  s.y = fma(a.x, b.y, s.y);
  s.y = fma(-a.y, b.x, s.y);
}
// float32 sums, each product and sum rounded (the plain version's order):
// s += a b
__device__ __forceinline__ void fadd(float& s, float a, float b) {
  s = fmaf(a, b, s);
}
__device__ __forceinline__ void fadd(float2& s, float2 a, float2 b) {
  s.x = __fadd_rn(s.x, __fmul_rn(a.x, b.x));
  s.x = __fsub_rn(s.x, __fmul_rn(a.y, b.y));
  s.y = __fadd_rn(s.y, __fmul_rn(a.x, b.y));
  s.y = __fadd_rn(s.y, __fmul_rn(a.y, b.x));
}
// s += a conj(b)
__device__ __forceinline__ void fadd_cj(float& s, float a, float b) {
  s = fmaf(a, b, s);
}
__device__ __forceinline__ void fadd_cj(float2& s, float2 a, float2 b) {
  s.x = __fadd_rn(s.x, __fmul_rn(a.x, b.x));
  s.x = __fadd_rn(s.x, __fmul_rn(a.y, b.y));
  s.y = __fsub_rn(s.y, __fmul_rn(a.x, b.y));
  s.y = __fadd_rn(s.y, __fmul_rn(a.y, b.x));
}
// s += conj(a) b
__device__ __forceinline__ void fadd_cja(float& s, float a, float b) {
  s = fmaf(a, b, s);
}
__device__ __forceinline__ void fadd_cja(float2& s, float2 a, float2 b) {
  s.x = __fadd_rn(s.x, __fmul_rn(a.x, b.x));
  s.x = __fadd_rn(s.x, __fmul_rn(a.y, b.y));
  s.y = __fadd_rn(s.y, __fmul_rn(a.x, b.y));
  s.y = __fsub_rn(s.y, __fmul_rn(a.y, b.x));
}
__device__ __forceinline__ float sub(float a, float b) {
  return __fsub_rn(a, b);
}
__device__ __forceinline__ float2 sub(float2 a, float2 b) {
  return make_float2(__fsub_rn(a.x, b.x), __fsub_rn(a.y, b.y));
}
__device__ __forceinline__ float2 add(float2 a, float2 b) {
  return make_float2(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y));
}
// a / r for real r, each part divided (JAX's complex division by a real
// value rounds so)
__device__ __forceinline__ float div_real(float a, float r) { return a / r; }
__device__ __forceinline__ float2 div_real(float2 a, float r) {
  return make_float2(a.x / r, a.y / r);
}
__device__ __forceinline__ float2 mul_real(float2 a, float s) {
  return make_float2(__fmul_rn(a.x, s), __fmul_rn(a.y, s));
}

// jnp.maximum: NaN propagates (fmaxf alone would drop it)
__device__ __forceinline__ float max_nan(float a, float b) {
  return isnan(a) ? a : (isnan(b) ? b : fmaxf(a, b));
}

// N consecutive elements in whole float4s (16-byte aligned source)
template <int N>
__device__ __forceinline__ void copy_vec(float (&dst)[N], const float* src) {
  static_assert(N % 4 == 0, "whole float4s");
#pragma unroll
  for (int q = 0; q < N / 4; ++q) {
    const float4 v = reinterpret_cast<const float4*>(src)[q];
    dst[4 * q] = v.x; dst[4 * q + 1] = v.y;
    dst[4 * q + 2] = v.z; dst[4 * q + 3] = v.w;
  }
}
template <int N>
__device__ __forceinline__ void copy_vec(float2 (&dst)[N], const float2* src) {
  static_assert(N % 2 == 0, "whole float4s");
#pragma unroll
  for (int q = 0; q < N / 2; ++q) {
    const float4 v = reinterpret_cast<const float4*>(src)[q];
    dst[2 * q] = make_float2(v.x, v.y);
    dst[2 * q + 1] = make_float2(v.z, v.w);
  }
}
template <int N>
__device__ __forceinline__ void store_vec(float* dst, const float (&src)[N]) {
#pragma unroll
  for (int q = 0; q < N / 4; ++q)
    reinterpret_cast<float4*>(dst)[q] = make_float4(
        src[4 * q], src[4 * q + 1], src[4 * q + 2], src[4 * q + 3]);
}
template <int N>
__device__ __forceinline__ void store_vec(float2* dst,
                                          const float2 (&src)[N]) {
#pragma unroll
  for (int q = 0; q < N / 2; ++q)
    reinterpret_cast<float4*>(dst)[q] = make_float4(
        src[2 * q].x, src[2 * q].y, src[2 * q + 1].x, src[2 * q + 1].y);
}

// ---- the matrix the factor sees -------------------------------------------

// real: A as given
__device__ __forceinline__ float as_elem(const float* A, const float*, int i,
                                         int k, int d, float, bool) {
  return A[(size_t)i * d + k];
}
// complex: hermitize((A s_i) s_j) + load I, identity-padded past d
// (`pad` false: zero past d, the unloaded As0 of the refinement)
__device__ __forceinline__ float2 as_elem(const float2* A, const float* sinv,
                                          int i, int k, int d, float load,
                                          bool pad) {
  if (i >= d || k >= d)
    return make_float2(pad && i == k ? 1.f : 0.f, 0.f);
  const float si = sinv[i], sk = sinv[k];
  const float2 u = A[(size_t)i * d + k], v = A[(size_t)k * d + i];
  const float ux = __fmul_rn(__fmul_rn(u.x, si), sk);
  const float uy = __fmul_rn(__fmul_rn(u.y, si), sk);
  const float vx = __fmul_rn(__fmul_rn(v.x, sk), si);
  const float vy = __fmul_rn(__fmul_rn(v.y, sk), si);
  float2 r = make_float2(__fmul_rn(0.5f, __fadd_rn(ux, vx)),
                         __fmul_rn(0.5f, __fsub_rn(uy, vy)));
  if (i == k) r.x = __fadd_rn(r.x, load);
  return r;
}

// ---- one frequency's state -----------------------------------------------

template <typename T>
struct Freq {
  const T* A;        // (d, d) input
  const T* B;        // (d, E) input
  T* W;              // packed lower tiles (nb (nb + 1) / 2, 32, 32)
  T* X;              // (d, E) output
  T* pt;             // [kB][ldp] the panel's L21, transposed
  T* a21;            // [kB][ldp] the panel's A21, transposed (staging)
  T* dg;             // [kB][kB]  the next diagonal block, row-major
                     //           (room for [kB][kB] widened: L's columns)
  wide_t<T>* inv;    // [kB][kB]  inv(L11) of the panel, row-major, widened
  T* y;              // [dp][E]   right-hand sides / solution
  T* yj;             // [kB][E]   one solved block
  float* sinv;       // [dp]      1 / scale (complex only)
  float* rp;         // [kB]      the diagonal block's pivot roots
  int d, dp, nb, ldp, E;
  float load, pivfloor;

  __device__ T* tile(int R, int C) const {
    return W + ((size_t)(R * (R + 1) / 2 + C) << 10);
  }
};

// The two warps of the diagonal-block factor meet at named barrier 1.
__device__ __forceinline__ void pair_sync() {
  asm volatile("bar.sync 1, 64;" ::: "memory");
}

// Cholesky steps p in [P0, P1) of the diagonal block (warp 0, lane = row
// r, its row of the block in registers): column p of L to col[p][r], the
// pivot's root to rp[p], then barrier 1.  Columns < P0 are final, so the
// updates start at P0; p stays a rolled loop (the 32 steps unrolled are
// ~10k instructions that one warp streams once per panel).
template <int P0, int P1, typename T>
__device__ __forceinline__ void chol_steps(T (&prow)[kB], wide_t<T>* col,
                                           float* rp, float pivfloor,
                                           int lane) {
#pragma unroll 1
  for (int p = P0; p < P1; ++p) {
    T pp = prow[P0];
#pragma unroll
    for (int c = P0 + 1; c < P1; ++c)
      if (c == p) pp = prow[c];
    const float rpiv =
        sqrtf(max_nan(__shfl_sync(kFull, re(pp), p), pivfloor));
    // rows above the pivot hold eliminated values: masked out
    const wide_t<T> lcol = wide(lane >= p ? div_real(pp, rpiv) : T{});
    col[p * kB + lane] = lcol;
    if (lane == 0) rp[p] = rpiv;
    __syncwarp();
    // the multipliers from the column (never from the pivot row)
#pragma unroll
    for (int c = P0 + 1; c < kB; ++c)
      if (c > p) {
        wide_t<T> a = {};
        madd_cj(a, lcol, col[p * kB + c]);
        prow[c] = sub(prow[c], rnd(a));
      }
    pair_sync();
  }
}

// Rows p in [P0, P1) of inv(L11) (warp 1, lane = column c), row p once
// step p is published: (e_p - L[p, :p] inv(L11)[:p, :]) / r_p, the
// plain version's formula; it runs beside warp 0's step p + 1.
template <int P0, int P1, typename T>
__device__ __forceinline__ void inverse_rows(const wide_t<T>* col,
                                             const float* rp,
                                             wide_t<T>* inv, T* w,
                                             int lane) {
#pragma unroll 1
  for (int p = P0; p < P1; ++p) {
    pair_sync();
    wide_t<T> acc = {};
#pragma unroll
    for (int s = 0; s < P1 - 1; ++s)
      if (s < p) madd(acc, col[s * kB + p], inv[s * kB + lane]);
    T v = div_real(sub(unit_of(T{}, lane == p), rnd(acc)), rp[p]);
    if (lane > p) v = T{};
    inv[p * kB + lane] = wide(v);
    w[p * kB + lane] = v;
    __syncwarp();
  }
}

// The 32-step factor of the diagonal block dg (row-major; once read, the
// buffer holds L's columns widened) by warps 0 and 1 together: inv(L11)
// widened to `inv`, and to the scratch's diagonal tile `w`.  Not inlined:
// one copy serves both call sites.
template <typename T>
__device__ __noinline__ void factor_block(T* dg, wide_t<T>* inv, float* rp,
                                          T* w, float pivfloor, int warp,
                                          int lane) {
  wide_t<T>* const col = reinterpret_cast<wide_t<T>*>(dg);
  if (warp == 0) {
    T prow[kB];
#pragma unroll
    for (int c = 0; c < kB; ++c) prow[c] = dg[lane * kB + c];
    __syncwarp();
    chol_steps<0, 8>(prow, col, rp, pivfloor, lane);
    chol_steps<8, 16>(prow, col, rp, pivfloor, lane);
    chol_steps<16, 24>(prow, col, rp, pivfloor, lane);
    chol_steps<24, 32>(prow, col, rp, pivfloor, lane);
  } else {
    inverse_rows<0, 8>(col, rp, inv, w, lane);
    inverse_rows<8, 16>(col, rp, inv, w, lane);
    inverse_rows<16, 24>(col, rp, inv, w, lane);
    inverse_rows<24, 32>(col, rp, inv, w, lane);
  }
}

// Each thread's outputs of a substitution step, kOut at a time for
// independent float64 chains.
constexpr int kOut = 3;

// Row block j of L left of the diagonal into lrow ([kB][c0], row-major).
template <typename T>
__device__ void stage_lrow(const Freq<T>& q, int j, T* lrow, int tid) {
  const int c0 = j * kB;
  for (int i = tid; i < kB * c0; i += kThreads) {
    const int c = i / c0, k = i - c * c0;
    lrow[i] = q.tile(j, k / kB)[c * kB + (k & (kB - 1))];
  }
}

// The forward substitution's right-hand side of block j, left-looking
// as the plain version: yj = y_j - L[j block, :c0] y[:c0], the sum over k
// in ascending order; L's row block from lrow (staged), or from the
// scratch when lrow is null.
template <typename T>
__device__ void forward_rhs(const Freq<T>& q, int j, const T* lrow,
                            int tid) {
  const int c0 = j * kB, E = q.E, n = kB * E;
  for (int i0 = tid; i0 < n; i0 += kOut * kThreads) {
    T acc[kOut];
    int c[kOut], e[kOut];
#pragma unroll
    for (int u = 0; u < kOut; ++u) {
      const int i = min(i0 + u * kThreads, n - 1);
      c[u] = i / E;
      e[u] = i - c[u] * E;
      acc[u] = T{};
    }
    for (int k = 0; k < c0; ++k) {
#pragma unroll
      for (int u = 0; u < kOut; ++u) {
        const T l = lrow ? lrow[c[u] * c0 + k]
                         : q.tile(j, k / kB)[c[u] * kB + (k & (kB - 1))];
        fadd(acc[u], l, q.y[k * E + e[u]]);
      }
    }
#pragma unroll
    for (int u = 0; u < kOut; ++u)
      if (i0 + u * kThreads < n)
        q.yj[c[u] * E + e[u]] = sub(q.y[(c0 + c[u]) * E + e[u]], acc[u]);
  }
}

// y_j = inv(L11) yj (the sum over k <= c in ascending order).
template <typename T>
__device__ void forward_apply(const Freq<T>& q, int j, int tid) {
  const int c0 = j * kB, E = q.E;
  for (int i = tid; i < kB * E; i += kThreads) {
    const int c = i / E, e = i - c * E;
    wide_t<T> acc = {};
    for (int k = 0; k <= c; ++k)
      madd(acc, q.inv[c * kB + k], wide(q.yj[k * E + e]));
    q.y[(c0 + c) * E + e] = rnd(acc);
  }
}

// Panel j after its diagonal block is factored: L21 = A21 inv(L11)^H into
// pt and the scratch, and block j of the forward substitution.  A21 is
// staged into a21 by rows (coalesced; after the first panel the complex
// form finds it there, left by the trailing update); the product is
// register-tiled (4 rows x 4 columns a thread, the triangle of inv(L11)
// skipped), L21 is written back by rows.  The real instantiation (S up
// to 992, no room for a second panel buffer) multiplies a row a thread in
// place in pt instead.
template <typename T>
__device__ void panel_l21(const Freq<T>& q, int j, int tid) {
  constexpr bool kTwoBuffers = sizeof(T) == 8;    // complex
  const int r0 = (j + 1) * kB, m = q.dp - r0;
  T* const a21 = kTwoBuffers ? q.a21 : q.pt;
  for (int i = tid; i < (kTwoBuffers && j > 0 ? 0 : m * kB); i += kThreads) {
    const int r = i >> 5, k = i & (kB - 1);
    a21[k * q.ldp + r] =
        j == 0 ? as_elem(q.A, q.sinv, r0 + r, k, q.d, q.load, true)
               : q.tile((r0 + r) / kB, j)[((r0 + r) % kB) * kB + k];
  }
  // complex: L's row block j staged in pt, free until the product below
  if constexpr (kTwoBuffers) {
    stage_lrow(q, j, q.pt, tid);
    __syncthreads();
  }
  forward_rhs(q, j, kTwoBuffers ? q.pt : nullptr, tid);
  __syncthreads();
  forward_apply(q, j, tid);
  if constexpr (!kTwoBuffers) {
    for (int r = tid; r < m; r += kThreads) {
      T v[kB];
#pragma unroll
      for (int k = 0; k < kB; ++k) v[k] = q.pt[k * q.ldp + r];
      // descending c: entry c reads v[0..c] only, so it is replaced in place
#pragma unroll
      for (int c = kB - 1; c >= 0; --c) {
        wide_t<T> acc = {};
#pragma unroll
        for (int k = 0; k <= c; ++k)
          madd_cj(acc, wide(v[k]), q.inv[c * kB + k]);
        q.pt[c * q.ldp + r] = rnd(acc);
      }
    }
  }
  const int nrg = kTwoBuffers ? m / 4 : 0;
  for (int it = tid; it < nrg * (kB / 4); it += kThreads) {
    const int cg = it / nrg, rg = it - cg * nrg;
    wide_t<T> acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int t = 0; t < 4; ++t) acc[i][t] = {};
#pragma unroll 2
    for (int k = 0; k < 4 * cg + 4; ++k) {
      T a[4];
      copy_vec(a, a21 + k * q.ldp + 4 * rg);
      wide_t<T> aw[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) aw[i] = wide(a[i]);
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const wide_t<T> b = q.inv[(4 * cg + t) * kB + k];
#pragma unroll
        for (int i = 0; i < 4; ++i) madd_cj(acc[i][t], aw[i], b);
      }
    }
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      T col[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) col[i] = rnd(acc[i][t]);
      store_vec(q.pt + (4 * cg + t) * q.ldp + 4 * rg, col);
    }
  }
  __syncthreads();
  for (int i = tid; i < m * kB; i += kThreads) {
    const int r = i >> 5, k = i & (kB - 1);
    q.tile((r0 + r) / kB, j)[((r0 + r) % kB) * kB + k] = q.pt[k * q.ldp + r];
  }
}

// The forward substitution from the stored factor (refinement), block by
// block.  Ends synchronized.
template <typename T>
__device__ void forward(const Freq<T>& q, int tid) {
  for (int j = 0; j < q.nb; ++j) {
    for (int i = tid; i < kB * kB; i += kThreads)
      q.inv[i] = wide(q.tile(j, j)[i]);
    stage_lrow(q, j, q.pt, tid);
    __syncthreads();
    forward_rhs(q, j, q.pt, tid);
    __syncthreads();
    forward_apply(q, j, tid);
    __syncthreads();
  }
}

// Back substitution L^H x = y from the stored factor, in place in y,
// left-looking as the plain version: yj = y_j - L21_j^H x_below (the sum
// over the rows below in ascending order, L21_j staged in pt transposed),
// then x_j = inv(L11_j)^H yj.
template <typename T>
__device__ void backward(const Freq<T>& q, int tid) {
  const int E = q.E, n = kB * E;
  for (int j = q.nb - 1; j >= 0; --j) {
    const int c0 = j * kB, r0 = c0 + kB, m = q.dp - r0;
    for (int i = tid; i < kB * kB; i += kThreads)
      q.inv[i] = wide(q.tile(j, j)[i]);
    for (int i = tid; i < m * kB; i += kThreads) {
      const int r = i >> 5, k = i & (kB - 1);
      q.pt[k * q.ldp + r] = q.tile((r0 + r) / kB, j)[((r0 + r) % kB) * kB + k];
    }
    __syncthreads();
    for (int i0 = tid; i0 < n; i0 += kOut * kThreads) {
      T acc[kOut];
      int k[kOut], e[kOut];
#pragma unroll
      for (int u = 0; u < kOut; ++u) {
        const int i = min(i0 + u * kThreads, n - 1);
        k[u] = i / E;
        e[u] = i - k[u] * E;
        acc[u] = T{};
      }
      for (int r = 0; r < m; ++r) {
#pragma unroll
        for (int u = 0; u < kOut; ++u)
          fadd_cja(acc[u], q.pt[k[u] * q.ldp + r], q.y[(r0 + r) * E + e[u]]);
      }
#pragma unroll
      for (int u = 0; u < kOut; ++u)
        if (i0 + u * kThreads < n)
          q.yj[k[u] * E + e[u]] = sub(q.y[(c0 + k[u]) * E + e[u]], acc[u]);
    }
    __syncthreads();
    for (int i = tid; i < n; i += kThreads) {
      const int c = i / E, e = i - c * E;
      wide_t<T> acc = {};
      for (int k = c; k < kB; ++k)
        madd_cja(acc, q.inv[k * kB + c], wide(q.yj[k * E + e]));
      q.y[(c0 + c) * E + e] = rnd(acc);
    }
    __syncthreads();
  }
}

// Tile (R, C) of the trailing update of panel j by one warp:
// out = old - L21[R] L21[C]^H, the old tile from the input (first panel)
// or the scratch; lane = 4 rows x 8 columns, the sums in float32.
template <typename T>
__device__ void update_tile(const Freq<T>& q, int j, int R, int C, T* out,
                            int lane) {
  const int r0 = (j + 1) * kB;
  const int ry = lane >> 2, cx = lane & 3;
  const int ra = R * kB - r0 + 4 * ry, cb = C * kB - r0 + 8 * cx;
  T acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) acc[i][jj] = T{};
#pragma unroll 4
  for (int k = 0; k < kB; ++k) {
    T av[4], bv[8];
    copy_vec(av, q.pt + k * q.ldp + ra);
    copy_vec(bv, q.pt + k * q.ldp + cb);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) fadd_cj(acc[i][jj], av[i], bv[jj]);
  }
  T prev[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (j == 0) {
#pragma unroll
      for (int jj = 0; jj < 8; ++jj)
        prev[i][jj] = as_elem(q.A, q.sinv, R * kB + 4 * ry + i,
                              C * kB + 8 * cx + jj, q.d, q.load, true);
    } else {
      copy_vec(prev[i], q.tile(R, C) + (4 * ry + i) * kB + 8 * cx);
    }
#pragma unroll
    for (int jj = 0; jj < 8; ++jj)
      prev[i][jj] = sub(prev[i][jj], acc[i][jj]);
  }
  if constexpr (sizeof(T) == 8) {
    // complex: the next panel's A21 goes straight to a21 (transposed)
    if (C == j + 1 && R > C) {
      const int rr = (R - j - 2) * kB + 4 * ry;
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < 8; ++jj)
          q.a21[(8 * cx + jj) * q.ldp + rr + i] = prev[i][jj];
      return;
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
    store_vec(out + (4 * ry + i) * kB + 8 * cx, prev[i]);
}

// The trailing update of panel j.  Warp 0 takes the next diagonal tile
// into dg, and warps 0 and 1 factor it (look-ahead); warps 2..7 share the
// other tiles.
template <typename T>
__device__ void trailing(const Freq<T>& q, int j, int warp, int lane) {
  const int j1 = j + 1;
  if (warp < 2) {
    if (warp == 0) {
      update_tile(q, j, j1, j1, q.dg, lane);
      __syncwarp();
    }
    factor_block(q.dg, q.inv, q.rp, q.tile(j1, j1), q.pivfloor, warp, lane);
    return;
  }
  int t = 0;
  for (int C = j1; C < q.nb; ++C) {
    for (int R = C; R < q.nb; ++R) {
      if (R == j1 && C == j1) continue;
      if (t++ % (kWarps - 2) == warp - 2)
        update_tile(q, j, R, C, q.tile(R, C), lane);
    }
  }
}

__device__ float block_max(float v, float* red, int tid) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = max_nan(v, __shfl_xor_sync(kFull, v, o));
  __syncthreads();
  if ((tid & 31) == 0) red[tid >> 5] = v;
  __syncthreads();
  float m = red[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) m = max_nan(m, red[w]);
  return m;
}

// The conditioning: the scales (complex), the pivot floor, B staged.
template <typename T, bool kCx>
__device__ void setup(Freq<T>& q, int tid, float* red) {
  const int d = q.d, E = q.E;
  if constexpr (kCx) {
    float m = -INFINITY;
    for (int i = tid; i < d; i += kThreads)
      m = max_nan(m, re(q.A[(size_t)i * d + i]));
    m = block_max(m, red, tid);
    // scale floor eps max(diag); an all-zero matrix is not scaled
    const float floor = m > 0.f ? m * FLT_EPSILON : 1.f;
    for (int i = tid; i < q.dp; i += kThreads)
      q.sinv[i] = i < d ? 1.f / sqrtf(max_nan(re(q.A[(size_t)i * d + i]),
                                              floor))
                        : 0.f;
    __syncthreads();
    // the pivot floor: eps^2 max(diag) of the loaded, padded matrix
    float m0 = q.dp > d ? 1.f : -INFINITY;
    for (int i = tid; i < d; i += kThreads)
      m0 = max_nan(m0, re(as_elem(q.A, q.sinv, i, i, d, q.load, true)));
    m0 = block_max(m0, red, tid);
    q.pivfloor = max_nan(m0 * (FLT_EPSILON * FLT_EPSILON), FLT_MIN);
  } else {
    q.pivfloor = FLT_MIN;
  }
  for (int i = tid; i < q.dp * E; i += kThreads) {
    const int r = i / E;
    T v = T{};
    if (r < d) {
      if constexpr (kCx) v = mul_real(q.B[i], q.sinv[r]);
      else v = q.B[i];
    }
    q.y[i] = v;
  }
  for (int i = tid; i < kB * kB; i += kThreads)
    q.dg[i] = as_elem(q.A, q.sinv, i / kB, i % kB, d, q.load, true);
  __syncthreads();
}

// One refinement step (complex): y = Bs - As0 X (X the unscaled solution
// in the output; As0's row block staged row-major over pt and a21, the
// sums in float64 over k ascending), then y = As^-1 y through the stored
// factor; X += y.
template <typename T>
__device__ void refine_step(const Freq<T>& q, int tid) {
  const int d = q.d, E = q.E, dp = q.dp;
  T* const rows = q.pt;                    // [kB][dp] <= 2 [kB][ldp]
  for (int R = 0; R < q.nb; ++R) {
    for (int i = tid; i < kB * dp; i += kThreads)
      rows[i] = as_elem(q.A, q.sinv, R * kB + i / dp, i % dp, d, 0.f, false);
    __syncthreads();
    for (int i = tid; i < kB * E; i += kThreads) {
      const int r = i / E, e = i - r * E, row = R * kB + r;
      wide_t<T> acc = {};
      for (int k = 0; k < d; ++k)
        madd(acc, wide(rows[r * dp + k]), wide(q.X[k * E + e]));
      q.y[row * E + e] =
          row < d ? sub(mul_real(q.B[(size_t)row * E + e], q.sinv[row]),
                        rnd(acc))
                  : T{};
    }
    __syncthreads();
  }
  forward(q, tid);
  backward(q, tid);
  for (int i = tid; i < d * E; i += kThreads) q.X[i] = add(q.X[i], q.y[i]);
  __syncthreads();
}

// The panel's row stride: dp - 32 rows and 16 bytes, so that a warp
// writing one row of 32 k (the staging by rows) spreads over the banks.
template <typename T>
__host__ __device__ int panel_ld(int dp) {
  return dp - kB + 16 / (int)sizeof(T);
}

template <typename T>
size_t smem_bytes(int dp, int E, bool cx) {
  return sizeof(T) * ((size_t)(cx ? 2 : 1) * kB * panel_ld<T>(dp)
                      + (size_t)dp * E + (size_t)kB * E)
         + sizeof(wide_t<T>) * 2 * kB * kB
         + sizeof(float) * ((cx ? dp : 0) + kWarps + kB);
}

template <typename T, bool kCx>
__global__ void __launch_bounds__(kThreads, 1)
chol_solve_kernel(const T* __restrict__ a_all, const T* __restrict__ b_all,
                  T* __restrict__ w_all, T* __restrict__ x_all, int d, int E,
                  float load, int refine) {
  extern __shared__ float4 smem4[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t f = blockIdx.x;
  Freq<T> q;
  q.d = d;
  q.E = E;
  q.dp = (d + kB - 1) / kB * kB;
  q.nb = q.dp / kB;
  q.ldp = panel_ld<T>(q.dp);
  q.load = load;
  q.A = a_all + f * d * d;
  q.B = b_all + f * d * E;
  q.X = x_all + f * d * E;
  q.W = w_all + f * (size_t)(q.nb * (q.nb + 1) / 2) * kB * kB;
  char* base = reinterpret_cast<char*>(smem4);
  q.pt = reinterpret_cast<T*>(base);
  base += sizeof(T) * kB * q.ldp;
  q.a21 = reinterpret_cast<T*>(base);        // complex only
  base += kCx ? sizeof(T) * kB * q.ldp : 0;
  q.dg = reinterpret_cast<T*>(base);
  base += sizeof(wide_t<T>) * kB * kB;
  q.inv = reinterpret_cast<wide_t<T>*>(base);
  base += sizeof(wide_t<T>) * kB * kB;
  q.y = reinterpret_cast<T*>(base);
  base += sizeof(T) * q.dp * E;
  q.yj = reinterpret_cast<T*>(base);
  base += sizeof(T) * kB * E;
  q.sinv = reinterpret_cast<float*>(base);
  float* red = q.sinv + (kCx ? q.dp : 0);   // [kWarps]
  q.rp = red + kWarps;

  setup<T, kCx>(q, tid, red);
  if (warp < 2)
    factor_block(q.dg, q.inv, q.rp, q.tile(0, 0), q.pivfloor, warp, lane);
  __syncthreads();
  for (int j = 0; j < q.nb; ++j) {
    panel_l21(q, j, tid);
    if (j + 1 < q.nb) trailing(q, j, warp, lane);
    __syncthreads();
  }
  backward(q, tid);
  if constexpr (kCx) {
    if (refine > 0) {                      // X holds the unscaled solution
      for (int i = tid; i < d * E; i += kThreads) q.X[i] = q.y[i];
      __syncthreads();
      for (int s = 0; s < refine; ++s) refine_step(q, tid);
    }
    const T* xs = refine > 0 ? q.X : q.y;
    for (int i = tid; i < d * E; i += kThreads)
      q.X[i] = mul_real(xs[i], q.sinv[i / E]);
  } else {
    for (int i = tid; i < d * E; i += kThreads) q.X[i] = q.y[i];
  }
}

template <typename T, bool kCx>
int launch(const void* a, const void* b, void* work, void* x, int F, int d,
           int E, float load, int refine, void* stream) {
  const int dp = (d + kB - 1) / kB * kB;
  const size_t smem = smem_bytes<T>(dp, E, kCx);
  if (F < 1 || E < 1 || smem > (size_t)kMaxSmem || refine < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  static bool opted[64] = {};             // once per instantiation, device
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (device < 0 || device >= 64)
    return static_cast<int>(cudaErrorInvalidDevice);
  if (!opted[device]) {
    err = cudaFuncSetAttribute(chol_solve_kernel<T, kCx>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kMaxSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    opted[device] = true;
  }
  chol_solve_kernel<T, kCx>
      <<<F, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const T*>(a), static_cast<const T*>(b),
          static_cast<T*>(work), static_cast<T*>(x), d, E, load, refine);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Real SPD (the TPU kernel): a (F, S, S), b (F, S, E) float32 contiguous,
// work (F, S/32 (S/32 + 1) / 2, 32, 32) float32 scratch, x (F, S, E)
// float32 output; S % 32 == 0.  Returns the cudaError_t of the launch.
int pb_chol_solve(const void* a, const void* b, void* work, void* x, int F,
                  int S, int E, void* stream) {
  if (S < kB || S % kB != 0) return static_cast<int>(cudaErrorInvalidValue);
  return launch<float, false>(a, b, work, x, F, S, E, 0.f, 0, stream);
}

// Complex Hermitian (JAX's hermitian_solve, method='chol'): a (F, d, d),
// b (F, d, E) complex64 contiguous, work (F, nb (nb + 1) / 2, 32, 32)
// complex64 scratch with nb = ceil(d / 32), x (F, d, E) complex64 output;
// 32 < d <= 256.
int pb_hermitian_solve_chol(const void* a, const void* b, void* work,
                            void* x, int F, int d, int E, float load,
                            int refine, void* stream) {
  if (d <= kB || d > 8 * kB) return static_cast<int>(cudaErrorInvalidValue);
  return launch<float2, true>(a, b, work, x, F, d, E, load, refine, stream);
}

}  // extern "C"
