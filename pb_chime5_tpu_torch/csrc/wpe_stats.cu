// WPE correlation statistics for Hopper (sm_90a), CUDA C++.
//
// Replaces the Pallas TPU kernel pb_chime5_tpu/ops/pallas/wpe_stats.py
// (_kernel, launched from _stats_call).  Per frequency f, over all frames t,
// with the weight w_t = 1 / lambda_t:
//
//   R[a, b] = sum_t w_t Yt[a, t] conj(Yt[b, t])     (dim x dim)
//   P[a, d] = sum_t w_t Yt[a, t] conj(Y[d, t])      (dim x D)
//
// The kernel reads the complex stacked signal Yt (F, dim, T), Y (F, D, T)
// and the weights (F, T) as they are (no real planes, no time-major copy,
// no padding), and it never writes the weighted copy w * Yt to device
// memory.  R is Hermitian: only its lower triangle is computed, and every
// entry a > b is also written, conjugated, to R[b, a], so the upper
// triangle is exactly the mirror of the lower one (the caller's hermitize
// then only zeroes the rounding left in the imaginary part of the diagonal).
//
// What bounds it on this card: the operations.  At the headline (F = 513,
// dim = 240, D = 24, T = 2504 with 2254 valid frames) the lower triangle of
// R plus P is 34,680 complex entries a frequency, 8 flops each a frame:
// 320.8 GFLOP over the valid frames, 4.79 ms at the 67 TFLOP/s fp32 rate of
// the CUDA cores, against 2.72 GB read once (0.81 ms at 3.35 TB/s).  IEEE
// fp32 FMA, its spans added in float64 (below; one DADD an entry every 64
// frames): no TF32, no tensor cores (reduced-precision statistics NaN the
// WPE on scenes with near-silent stretches).
//
// Design.  Rows go in quads of 4 and in blocks of 64 (16 quads).
//   * Work: a thread owns a 4 x 8 register tile of complex sums, one quad of
//     rows a by a pair of quads of columns b.  Per frame, 6 shared-memory
//     loads of a float4 feed its 128 FFMA (a 4 x 4 tile, 4 loads for 64
//     FFMA, ran 1.14x as long on an H100; PERF.md).  Only tiles
//     that hold needed entries get a thread: the lower triangle of R (a
//     tile on the diagonal also computes entries above it) and P at its own
//     width (D = 24: 3 quad pairs, no padding).  Issued at the headline: 36
//     warps of 32 tiles a frequency, 36,864 entries a frame against the
//     34,680 needed (1.063x); with the zero chunks skipped (below), 341.3
//     GFLOP on chip_smoke.py's inputs against the 356.4 GFLOP of the needed
//     entries over all T.  The FFMAs run over the columns b outside the rows
//     a: the compiler's schedule of that order issued 4 % faster than the
//     other (same sums in the same order; PERF.md).
//   * Tasks: one CTA of 4 warps per task of a frequency: a block (I, J),
//     J < I, of R (rows 64 I.., columns 64 J..); the diagonal block I of R
//     together with P's first 24 columns (both multiply the rows of block
//     I; 72 + 16 x 3 tiles fit 128 threads); P's further columns in blocks
//     of 64 (D > 24 only).  The headline has 10 tasks a frequency with 3 or
//     4 working warps each, 5130 CTAs, 2 CTAs an SM (255 registers a
//     thread with the float64 shadow below; 117 and 4 CTAs an SM
//     without it).  The tasks of a
//     frequency are adjacent in the grid, so they read its rows from L2 at
//     about the same time.
//   * Staging: T in chunks of 16 frames at fixed offsets (frames 16 c ..).
//     A chunk's rows of both blocks and its weights stream into shared
//     memory with cp.async, double-buffered: chunk c + 1 is in flight while
//     chunk c is weighted and multiplied.  The weight is applied once per
//     staged row of block I, into a buffer of its own (w * Yt rows; the
//     other operand stays unweighted), so the inner loop is loads and FFMAs
//     only.  L2 -> SM traffic at the headline: the 10 tasks stage 1056 rows
//     of a frequency a frame, 10.8 GB a call.
//   * Shared-memory layout: a frame's vector holds the first halves (rows
//     4q, 4q + 1) of every quad, then the second halves; consecutive frames
//     sit 4 banks apart, so the staging writes (4 rows x 8 frames a warp)
//     are free of bank conflicts.
//   * Zero chunks: a chunk whose weighted rows are all zero (the masked
//     tail, bucket padding) is skipped by the whole CTA (__syncthreads_or).
//     For finite inputs it would add exactly nothing.
//   * Two-level sum: each entry is one thread's sum over t in order, in two
//     levels.  The 4 x 8 tile sums kSpanChunks computed chunks (64 frames)
//     in float32 FFMA, then adds into a float64 shadow of the tile and
//     starts again from zero; the shadow is rounded to float32 once, at the
//     end.  A single float32 sum over all T frames drifts from the float64
//     sums of the same inputs by ~sqrt(T) roundings (4.75-5.97e-6 of R at
//     T = 4191, where the second WPE iteration's R then fell past the 1e-4
//     load at 3 frequencies and the solve returned NaN); a span of 64
//     frames drifts by ~sqrt(64).  No atomics and no split of T: the result
//     is bit-identical run to run, and frames of zero appended to T leave R
//     and P bit-identical (their chunks are skipped and do not count toward
//     a span).  On the stress scene's second WPE iteration (T = 4191) R lies
//     at most 2.86e-7 from the float64 sums (chip_smoke.py phase 14;
//     5.97e-6 with one float32 sum, scripts_dev/diag_stress_wpe_card.py),
//     at 10.53 against 8.68 ms at the headline: the shadow's registers
//     halve the CTAs an SM (H100 80GB HBM3, 700 W, in turns with the
//     one-level source, scripts_dev/diag_k2_card.py).  Float64 sums in
//     shared memory instead need 64 KB more a CTA, which leaves 2 CTAs an
//     SM as well: bit-identical, 10.46 ms at 208 registers, and 11.18 ms
//     where launch bounds of 4 CTAs force spills (same script and turns).

#include <atomic>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kChunk = 16;                  // frames per staged chunk
constexpr int kQuads = 16;                  // quads of 4 rows per block
constexpr int kBlockRows = 4 * kQuads;      // 64
constexpr int kRawQuads = 2 * kQuads;       // block I, then the other block
constexpr int kGroups = kRawQuads / 4;      // column groups of 2 quad pairs
constexpr int kFirstP = 24;                 // P's columns beside block I
constexpr int kSpanChunks = 4;              // float32 chunks per float64 add
constexpr int kMinBlocks = 2;               // the float64 shadow's registers
static_assert((kQuads / 2) * (kQuads / 2 + 1) + kQuads * (kFirstP / 8) <=
                  kThreads,
              "the diagonal block and P's first columns fit the threads");
static_assert(kQuads * kQuads / 2 <= kThreads, "a whole block fits");
// a frame's vector: both halves (a float4 each) of every quad, + 4 floats
constexpr int kRawStride = 2 * 4 * kRawQuads + 4;   // 260 floats
constexpr int kAStride = 2 * 4 * kQuads + 4;        // 132 floats
constexpr int kRawFloats = kChunk * kRawStride;
constexpr int kAFloats = kChunk * kAStride;
constexpr int kSmemBytes =
    (int)sizeof(float) * (2 * kRawFloats + kAFloats + 2 * kChunk);
static_assert(kRawStride % 32 == 4 && kAStride % 32 == 4,
              "consecutive frames 4 banks apart");
static_assert(kChunk % 8 == 0 && kThreads == 8 * kQuads,
              "staging: 8 frames x 16 row offsets");

enum Kind { kOffDiagonal = 0, kDiagonalAndP = 1, kPOnly = 2 };

__device__ __forceinline__ void cp_async8(void* dst, const void* src,
                                          int bytes) {   // zero-fills
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(s),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int bytes) {   // zero-fills
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// The needed quad pairs of row quad i among the 2 pairs of column group g
// (always a prefix of them): groups 0-3 are the pairs of block I (the
// diagonal block: pairs whose first quad is <= i), groups 4-7 those of the
// other block (all np1 of its pairs)
__device__ __forceinline__ int needed(int kind, int g, int i, int nq0,
                                      int np1) {
  if (i >= nq0) return 0;
  if (g < kGroups / 2)
    return kind == kDiagonalAndP ? min(max(i / 2 - 2 * g + 1, 0), 2) : 0;
  return min(max(np1 - 2 * (g - kGroups / 2), 0), 2);
}

__global__ void __launch_bounds__(kThreads, kMinBlocks)
wpe_stats_kernel(const float2* __restrict__ yt,   // (F, dim, T)
                 const float2* __restrict__ y,    // (F, D, T)
                 const float* __restrict__ w,     // (F, T)
                 float2* __restrict__ R,          // (F, dim, dim)
                 float2* __restrict__ P,          // (F, dim, D)
                 int dim, int D, int T, int nI, int nP, int tasks) {
  extern __shared__ float4 smem4[];
  float* sRaw = reinterpret_cast<float*>(smem4);   // 2 chunks, both blocks
  float* sA = sRaw + 2 * kRawFloats;               // w * rows of block I
  float* sW = sA + kAFloats;                       // 2 chunks of weights

  // the task: R's lower block triangle (I, J <= I) in row order, then P's
  // blocks of 64 columns past the first 24 (nP of them a row block)
  const int f = blockIdx.x / tasks;
  int task = blockIdx.x - f * tasks;
  int I = 0, J, kind;
  const int tri = nI * (nI + 1) / 2;
  if (task < tri) {
    while ((I + 1) * (I + 2) / 2 <= task) ++I;
    J = task - I * (I + 1) / 2;
    kind = J == I ? kDiagonalAndP : kOffDiagonal;
  } else {
    task -= tri;
    I = task / nP;
    J = task - I * nP;
    kind = kPOnly;
  }
  const int rows0 = min(kBlockRows, dim - kBlockRows * I);
  const float2* src0 = yt + ((size_t)f * dim + (size_t)kBlockRows * I) * T;
  int rows1;
  const float2* src1;
  if (kind == kOffDiagonal) {
    rows1 = kBlockRows;   // J < I: block J is whole
    src1 = yt + ((size_t)f * dim + (size_t)kBlockRows * J) * T;
  } else {
    const int d0 = kind == kPOnly ? kFirstP + kBlockRows * J : 0;
    rows1 = min(kind == kPOnly ? kBlockRows : kFirstP, D - d0);
    src1 = y + ((size_t)f * D + d0) * T;
  }
  const int nq0 = (rows0 + 3) / 4;
  const int np1 = (rows1 + 7) / 8;
  const float* wf = w + (size_t)f * T;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;

  // this thread's tile: entry tid of the needed tiles in the order (group,
  // row quad, pair of the group)
  int total = 0, qi = 0, qv = 0;
  bool own = false;
  for (int g = 0; g < kGroups; ++g) {
    for (int i = 0; i < kQuads; ++i) {
      const int n = needed(kind, g, i, nq0, np1);
      if (!own && tid < total + n) {
        own = true;
        qi = i;
        qv = 2 * g + tid - total;
      }
      total += n;
    }
  }
  const bool computes = warp * 32 < total;   // the same in the whole warp

  // staging: this thread copies frames st and st + 8 of rows sr + 16 m of
  // the two blocks (m < 4: block I, m >= 4: the other block), whole quad
  // pairs of each, zero past its rows and past T; the raw row 16 m + sr
  // sits at quad 4 m + sr / 4, row sr % 4 of it
  const int nchunks = (T + kChunk - 1) / kChunk;
  const int st = tid & 7;
  const int sr = tid >> 3;
  const int spos = st * kRawStride +
                   4 * (((sr & 3) >> 1) * kRawQuads + (sr >> 2)) +
                   2 * (sr & 1);
  const int staged0 = min(kBlockRows, 8 * ((nq0 + 1) / 2));
  const int staged1 = 8 * np1;
  // bit m of staged: raw row 16 m + sr is copied (whole quad pairs); of
  // present: it exists and is read (else zero-filled); roff[m]: its
  // element offset in its block at frame st (clamped to an existing row)
  unsigned staged = 0, present = 0;
  int roff[8];
#pragma unroll
  for (int m = 0; m < 8; ++m) {
    const int row = sr + 16 * (m & 3);
    const int rows = m < 4 ? rows0 : rows1;
    staged |= (unsigned)(row < (m < 4 ? staged0 : staged1)) << m;
    present |= (unsigned)(row < rows) << m;
    roff[m] = min(row, rows - 1) * T + st;
  }
  auto stage = [&](int c, int buf) {
    const int t0 = c * kChunk;
    float* dst = sRaw + buf * kRawFloats + spos;
    if (t0 + kChunk <= T) {   // no frame of the chunk past T
#pragma unroll
      for (int m = 0; m < 8; ++m) {
        if ((staged >> m) & 1u) {   // the same in the whole warp
          const float2* p = (m < 4 ? src0 : src1) + (roff[m] + t0);
          const int bytes = (present >> m) & 1u ? 8 : 0;
#pragma unroll
          for (int h = 0; h < kChunk / 8; ++h)
            cp_async8(dst + 16 * m + 8 * h * kRawStride, p + 8 * h, bytes);
        }
      }
    } else {
#pragma unroll
      for (int m = 0; m < 8; ++m) {
        if ((staged >> m) & 1u) {
          const float2* p = (m < 4 ? src0 : src1) + (roff[m] + t0);
#pragma unroll
          for (int h = 0; h < kChunk / 8; ++h) {
            const bool ok = ((present >> m) & 1u) && t0 + st + 8 * h < T;
            cp_async8(dst + 16 * m + 8 * h * kRawStride,
                      ok ? p + 8 * h : src0, ok ? 8 : 0);
          }
        }
      }
    }
    if (tid < kChunk) {
      const int tt = t0 + tid;
      cp_async4(sW + buf * kChunk + tid, tt < T ? wf + tt : wf,
                tt < T ? 4 : 0);
    }
    cp_async_commit();
  };

  // weighting: this thread's float4 (half wh of quad wq of block I) in
  // frames wt + 4 n of a chunk
  constexpr int kWeightStep = kThreads / (2 * kQuads);   // frames a pass
  const int wq = tid & (kQuads - 1);
  const int wh = (tid / kQuads) & 1;
  const int wt = tid / (2 * kQuads);
  const bool weights = wq < nq0;
  const int wraw = wt * kRawStride + 4 * (wh * kRawQuads + wq);
  float* const wa = sA + wt * kAStride + 4 * (wh * kQuads + wq);

  float re[4][8], im[4][8];      // this span's float32 sums
  double sre[4][8], sim[4][8];   // the spans' float64 sums
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      re[i][j] = im[i][j] = 0.f;
      sre[i][j] = sim[i][j] = 0.0;
    }
  auto flush = [&]() {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        sre[i][j] += re[i][j];
        sim[i][j] += im[i][j];
        re[i][j] = im[i][j] = 0.f;
      }
  };
  int span = 0;   // chunks summed in float32 since the last flush
  const float* pa = sA + 4 * qi;

  stage(0, 0);
  for (int c = 0; c < nchunks; ++c) {
    const int buf = c & 1;
    cp_async_wait_all();
    __syncthreads();   // chunk c landed; chunk c - 1's readers are done
    if (c + 1 < nchunks) stage(c + 1, buf ^ 1);   // overlaps chunk c

    // the weighted rows of block I
    const float* raw = sRaw + buf * kRawFloats;
    unsigned bits = 0;
    if (weights) {
#pragma unroll
      for (int n = 0; n < kChunk / kWeightStep; ++n) {
        const int t = wt + kWeightStep * n;
        float4 v = *reinterpret_cast<const float4*>(
            raw + wraw + kWeightStep * n * kRawStride);
        const float wgt = sW[buf * kChunk + t];
        v.x *= wgt;
        v.y *= wgt;
        v.z *= wgt;
        v.w *= wgt;
        bits |= __float_as_uint(v.x) | __float_as_uint(v.y) |
                __float_as_uint(v.z) | __float_as_uint(v.w);
        *reinterpret_cast<float4*>(wa + kWeightStep * n * kAStride) = v;
      }
    }
    const int nonzero = (bits << 1) != 0u;   // any value but +-0
    if (!__syncthreads_or(nonzero)) continue;   // adds exactly nothing

    if (computes) {
      const float* pb = raw + 8 * qv;   // quads 2 qv, 2 qv + 1
#pragma unroll 1
      for (int t = 0; t < kChunk; ++t) {
        const float* at = pa + t * kAStride;
        const float* bt = pb + t * kRawStride;
        const float4 a01 = *reinterpret_cast<const float4*>(at);
        const float4 a23 = *reinterpret_cast<const float4*>(at + 4 * kQuads);
        const float4 b01 = *reinterpret_cast<const float4*>(bt);
        const float4 b45 = *reinterpret_cast<const float4*>(bt + 4);
        const float4 b23 =
            *reinterpret_cast<const float4*>(bt + 4 * kRawQuads);
        const float4 b67 =
            *reinterpret_cast<const float4*>(bt + 4 * kRawQuads + 4);
        const float ar[4] = {a01.x, a01.z, a23.x, a23.z};
        const float ai[4] = {a01.y, a01.w, a23.y, a23.w};
        const float br[8] = {b01.x, b01.z, b23.x, b23.z,
                             b45.x, b45.z, b67.x, b67.z};
        const float bi[8] = {b01.y, b01.w, b23.y, b23.w,
                             b45.y, b45.w, b67.y, b67.w};
#pragma unroll
        for (int j = 0; j < 8; ++j) {   // columns outside rows (above)
#pragma unroll
          for (int i = 0; i < 4; ++i) {   // += a conj(b)
            re[i][j] = fmaf(ar[i], br[j], re[i][j]);
            re[i][j] = fmaf(ai[i], bi[j], re[i][j]);
            im[i][j] = fmaf(ai[i], br[j], im[i][j]);
            im[i][j] = fmaf(-ar[i], bi[j], im[i][j]);
          }
        }
      }
      if (++span == kSpanChunks) {
        flush();
        span = 0;
      }
    }
  }

  if (!own) return;
  flush();
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int a = kBlockRows * I + 4 * qi + i;
    if (a >= dim) break;
    float2* Ra = R + ((size_t)f * dim + a) * dim;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 v = make_float2((float)sre[i][j], (float)sim[i][j]);
      const int col = 8 * (qv % (kQuads / 2)) + j;   // column of its block
      if (qv < kQuads / 2 || kind == kOffDiagonal) {   // R
        const int b = kBlockRows * (qv < kQuads / 2 ? I : J) + col;
        if (b > a) continue;   // above the diagonal (or past dim)
        Ra[b] = v;
        if (b < a)
          R[((size_t)f * dim + b) * dim + a] = make_float2(v.x, -v.y);
      } else {                                         // P
        const int d = (kind == kPOnly ? kFirstP + kBlockRows * J : 0) + col;
        if (col < rows1) P[((size_t)f * dim + a) * D + d] = v;
      }
    }
  }
}

// The largest shared-memory carveout, so that the CTAs fit an SM (and the
// opt-in to more than 48 KB of dynamic shared memory, should the layout
// grow), once per device
cudaError_t opt_in() {
  static std::atomic<unsigned long long> done{0};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  const unsigned long long bit = 1ull << (device & 63);
  if (err != cudaSuccess || (done.load() & bit)) return err;
  err = cudaFuncSetAttribute(wpe_stats_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kSmemBytes);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(wpe_stats_kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err == cudaSuccess) done.fetch_or(bit);
  return err;
}

}  // namespace

extern "C" {

// Launch on `stream`; returns the cudaError_t of the launch (0 = success).
int pb_wpe_statistics(const void* yt, const void* y, const void* w, void* R,
                      void* P, int F, int dim, int D, int T, void* stream) {
  if (F < 1 || dim < 1 || D < 1 || T < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long nI = (dim + kBlockRows - 1) / kBlockRows;
  const long long nP =
      D > kFirstP ? (D - kFirstP + kBlockRows - 1) / kBlockRows : 0;
  const long long tasks = nI * (nI + 1) / 2 + nI * nP;
  const long long blocks = (long long)F * tasks;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = opt_in();
  if (err != cudaSuccess) return static_cast<int>(err);
  wpe_stats_kernel<<<(unsigned)blocks, kThreads, kSmemBytes,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(yt), static_cast<const float2*>(y),
      static_cast<const float*>(w), static_cast<float2*>(R),
      static_cast<float2*>(P), dim, D, T, (int)nI, (int)nP, (int)tasks);
  return static_cast<int>(cudaGetLastError());
}

// The kernel's dynamic shared memory per CTA and resident CTAs per SM on
// the current device; returns a cudaError_t (0 = success).
int pb_wpe_statistics_resources(int* smem_bytes, int* ctas_per_sm) {
  cudaError_t err = opt_in();
  if (err != cudaSuccess) return static_cast<int>(err);
  *smem_bytes = kSmemBytes;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      ctas_per_sm, wpe_stats_kernel, kThreads, kSmemBytes);
  return static_cast<int>(err);
}

}  // extern "C"
