// Fused cacGMM E+M accumulation for Hopper (sm_90a), CUDA C++.
//
// Replaces the Pallas TPU kernel pb_chime5_tpu/ops/pallas/fused_em.py
// (_kernel, launched from _scatter_call).  Per frequency f, over all
// frames t:
//
//   q_kt     = max(Re(z_t^H P_k z_t), tiny)
//   log_pdf  = lw_k - D log q_kt - ld_k, shifted by its max over ALL K
//   gamma_kt = exp(log_pdf) * act_kt;  gamma /= max(sum_k gamma, tiny)
//   gamma   *= fm_t
//   S_k     += sum_t (gamma_kt / q_kt) z_t z_t^H,   den_k += sum_t gamma_kt
//
// S is returned WITHOUT the 1/den_k and D factors (the caller's finalize
// applies them), exactly as the TPU kernel does.
//
// What bounds it on this card: at the headline shape (T = 2504, D = 24,
// K = 5) this kernel issues ~115 MFLOP per frequency and launch (for
// every frame and class a full D x D product P_k z_t and a full rank-1
// update, ~9.4 KFLOP each) against 0.5 MB of z read once: arithmetic, not
// memory.  The function needs less: the lower triangle of z_t z_t^H once
// per valid frame (3 D^2 flops), then for each active class the Hermitian
// form Re tr(P_k z_t z_t^H) and the update of S_k's lower triangle
// (4 D^2 flops), ~18 MFLOP per frequency at chip_smoke.py's activity;
// that is the bound it reports.  Of the kernel's own work, the E-step's
// P z products take the larger share: chains
// of dependent FMAs fed by shared-memory loads of P, latency-bound when
// few warps share an SM (with one block per SM the E-step measured ~65%
// of a launch on an H100).
//
// Design (simple and right first; tiling T across blocks, wgmma / TMA and
// the Hermitian half of S are later work):
//   * one block of 256 threads per frequency; the block loops over T in
//     chunks of 48 frames (K * 48 E-step items fill the block in one
//     round at K = 5), so z is read from device memory exactly once;
//   * shared memory holds P_f (K*D*D complex, 23 KB at the headline) and
//     the current z chunk;
//   * E-step: one thread per (k, t) forms P_k z_t with z_t held in
//     registers (P reads are warp broadcasts);
//   * softmax: one thread per frame, over K in registers;
//   * M-step: each thread owns one row segment S_k[d, e0:e0+12] in
//     registers and accumulates it in t order; one write at the end
//     (K * D * ceil(D / 12) <= 240 segments fit one block of 256);
//   * the kernel is instantiated per register bound on D (8, 16, 24), so
//     the headline shape runs at <= 128 registers and two blocks per SM,
//     which hides part of that latency.
// Supported sizes are what the product's configurations give: D <= 24
// channels (6 arrays x 4 mics) and K <= 5 classes (4 speakers + noise).
// No atomics and no cross-block reduction: the result is bit-identical
// run to run.  IEEE float32 FMA only (no TF32, no tensor cores, no fast
// math).

#include <cuda_runtime.h>
#include <float.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 48;    // frames per shared-memory chunk
constexpr int kMaxD = 24;
constexpr int kMaxK = 5;
constexpr int kSeg = 12;      // S entries (columns e) per row segment
static_assert(kMaxK * kMaxD * ((kMaxD + kSeg - 1) / kSeg) <= kThreads,
              "one row segment of S per thread");
static_assert(8 * (kMaxK * kMaxD * kMaxD + kChunk * kMaxD) + 4 * kChunk * kMaxK
                  <= 48 * 1024,
              "dynamic shared memory within the default 48 KB");

// MAXD: register bound on D (8, 16 or 24)
template <int MAXD>
__global__ void __launch_bounds__(kThreads, 2)
fused_em_kernel(const float2* __restrict__ z,      // (F, T, D)
                const float2* __restrict__ prec,   // (F, K, D, D)
                const float* __restrict__ lw,      // (F, K)
                const float* __restrict__ ld,      // (F, K)
                const float* __restrict__ act,     // (K, T)
                const float* __restrict__ fm,      // (T,)
                float2* __restrict__ S,            // (F, K, D, D)
                float* __restrict__ den,           // (F, K)
                int T, int D, int K) {
  extern __shared__ float4 smem_raw[];
  float2* sP = reinterpret_cast<float2*>(smem_raw);    // K*D*D
  float2* sZ = sP + K * D * D;                          // kChunk*D
  float* sQ = reinterpret_cast<float*>(sZ + kChunk * D);  // kChunk*K

  const int f = blockIdx.x;
  const int tid = threadIdx.x;
  const float tiny = FLT_MIN;
  const int KDD = K * D * D;

  const float2* Pf = prec + (size_t)f * KDD;
  for (int i = tid; i < KDD; i += kThreads) sP[i] = Pf[i];

  float lwk[kMaxK], ldk[kMaxK];
#pragma unroll
  for (int k = 0; k < kMaxK; ++k) {
    lwk[k] = k < K ? lw[f * K + k] : 0.f;
    ldk[k] = k < K ? ld[f * K + k] : 0.f;
  }

  // M-step ownership: this thread's row segment (row = k*D + d, columns
  // e0 .. e0 + kSeg - 1), if any
  const int segs = (D + kSeg - 1) / kSeg;
  const bool owner = tid < K * D * segs;
  const int row = owner ? tid / segs : 0;
  const int tk = row / D;
  const int td = row - tk * D;
  const int te0 = (owner ? tid - row * segs : 0) * kSeg;
  float2 acc[kSeg];
#pragma unroll
  for (int i = 0; i < kSeg; ++i) acc[i] = make_float2(0.f, 0.f);
  float dacc[kMaxK];
#pragma unroll
  for (int k = 0; k < kMaxK; ++k) dacc[k] = 0.f;

  const float2* zf = z + (size_t)f * T * D;
  for (int t0 = 0; t0 < T; t0 += kChunk) {
    const int tc = min(kChunk, T - t0);
    __syncthreads();  // the previous chunk's readers are done
    for (int i = tid; i < tc * D; i += kThreads) sZ[i] = zf[(size_t)t0 * D + i];
    __syncthreads();

    // E-step quadratic forms, one (k, t) per thread
    for (int it = tid; it < K * tc; it += kThreads) {
      const int k = it / tc;
      const int t = it - k * tc;
      const float2* zt = sZ + t * D;
      float2 zr[MAXD];
#pragma unroll
      for (int e = 0; e < MAXD; ++e)
        zr[e] = e < D ? zt[e] : make_float2(0.f, 0.f);
      const float2* Pk = sP + k * D * D;
      float q = 0.f;
#pragma unroll
      for (int d = 0; d < MAXD; ++d) {
        if (d < D) {
          const float2* Pkd = Pk + d * D;
          float vr = 0.f, vi = 0.f;
#pragma unroll
          for (int e = 0; e < MAXD; ++e) {
            if (e < D) {
              const float2 p = Pkd[e];
              vr = fmaf(p.x, zr[e].x, vr);
              vr = fmaf(-p.y, zr[e].y, vr);
              vi = fmaf(p.x, zr[e].y, vi);
              vi = fmaf(p.y, zr[e].x, vi);
            }
          }
          q = fmaf(zr[d].x, vr, q);  // Re(conj(z_d) * (P z)_d)
          q = fmaf(zr[d].y, vi, q);
        }
      }
      sQ[t * K + k] = fmaxf(q, tiny);
    }
    __syncthreads();

    // responsibilities, one frame per thread; sQ[t, k] becomes gamma / q
    if (tid < tc) {
      const int t = tid;
      float qk[kMaxK], lp[kMaxK];
      float m = -INFINITY;
#pragma unroll
      for (int k = 0; k < kMaxK; ++k) {
        if (k < K) {
          qk[k] = sQ[t * K + k];
          lp[k] = lwk[k] - (float)D * logf(qk[k]) - ldk[k];
          m = fmaxf(m, lp[k]);
        }
      }
      float g[kMaxK];
      float s = 0.f;
#pragma unroll
      for (int k = 0; k < kMaxK; ++k) {
        if (k < K) {
          g[k] = expf(lp[k] - m) * act[(size_t)k * T + t0 + t];
          s += g[k];
        }
      }
      const float norm = fmaxf(s, tiny);
      const float fmt = fm[t0 + t];
#pragma unroll
      for (int k = 0; k < kMaxK; ++k) {
        if (k < K) {
          const float gk = g[k] / norm * fmt;
          dacc[k] += gk;
          sQ[t * K + k] = gk / qk[k];
        }
      }
    }
    __syncthreads();

    // M-step: S_k[d, e] += (gamma/q)_kt z_d conj(z_e), in t order
    if (owner) {
      for (int t = 0; t < tc; ++t) {
        const float2* zt = sZ + t * D;
        const float c = sQ[t * K + tk];
        const float2 zd = zt[td];
        const float wr = c * zd.x;
        const float wi = c * zd.y;
#pragma unroll
        for (int i = 0; i < kSeg; ++i) {
          const int e = te0 + i;
          if (e < D) {
            const float2 ze = zt[e];
            acc[i].x = fmaf(wr, ze.x, fmaf(wi, ze.y, acc[i].x));
            acc[i].y = fmaf(wi, ze.x, fmaf(-wr, ze.y, acc[i].y));
          }
        }
      }
    }
  }

  if (owner) {
    float2* Srow = S + (size_t)f * KDD + (size_t)row * D;
#pragma unroll
    for (int i = 0; i < kSeg; ++i) {
      const int e = te0 + i;
      if (e < D) Srow[e] = acc[i];
    }
  }

  // den: per-thread partials over the frames each thread owned, summed
  // in thread order (fixed, so deterministic)
  __syncthreads();
  if (tid < kChunk) {
#pragma unroll
    for (int k = 0; k < kMaxK; ++k)
      if (k < K) sQ[tid * K + k] = dacc[k];
  }
  __syncthreads();
  if (tid < K) {
    float s = 0.f;
    for (int t = 0; t < kChunk; ++t) s += sQ[t * K + tid];
    den[f * K + tid] = s;
  }
}

template <int MAXD>
cudaError_t launch(const void* z, const void* prec, const void* lw,
                   const void* ld, const void* act, const void* fm, void* S,
                   void* den, int F, int T, int D, int K,
                   cudaStream_t stream) {
  const size_t smem = sizeof(float2) * (size_t)(K * D * D + kChunk * D) +
                      sizeof(float) * (size_t)(kChunk * K);
  fused_em_kernel<MAXD><<<F, kThreads, smem, stream>>>(
      static_cast<const float2*>(z), static_cast<const float2*>(prec),
      static_cast<const float*>(lw), static_cast<const float*>(ld),
      static_cast<const float*>(act), static_cast<const float*>(fm),
      static_cast<float2*>(S), static_cast<float*>(den), T, D, K);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launch on `stream`; returns the cudaError_t of the launch (0 = success).
int pb_fused_em_scatter(const void* z, const void* prec, const void* lw,
                        const void* ld, const void* act, const void* fm,
                        void* S, void* den, int F, int T, int D, int K,
                        void* stream) {
  if (F < 1 || T < 1 || D < 1 || D > kMaxD || K < 1 || K > kMaxK)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (D <= 8)
    err = launch<8>(z, prec, lw, ld, act, fm, S, den, F, T, D, K, st);
  else if (D <= 16)
    err = launch<16>(z, prec, lw, ld, act, fm, S, den, F, T, D, K, st);
  else
    err = launch<24>(z, prec, lw, ld, act, fm, S, den, F, T, D, K, st);
  return static_cast<int>(err);
}

}  // extern "C"
