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
// The E-step forms q as the plain version does: the rows of P_k z_t, each
// summed over e in order with four FMAs per complex product, then
// Re(conj(z_d) (P_k z_t)_d) summed over d.  On an EM's precisions
// (condition ~1e5, some not even positive definite where the Gauss-Jordan
// inverse met a near-singular covariance) the frames with a small q carry
// S, and a float32 q keeps only what its order of rounding leaves: another
// order (the Hermitian form's folded dot of the D^2 features of z z^H
// against P packed from both triangles) moved S by up to ~1e-3 against
// the plain version on a real EM state, this order by ~1e-6 (PERF.md).
//
// The M-step works in the Hermitian form: per valid frame the D^2 real
// "frame features" of z z^H (for each pair d > e of the lower triangle,
// row-major, Re and Im of z_d conj(z_e), interleaved, then |z_d|^2 for
// each d; ops/kernels/fused_em.py states the layout as frame_features),
// and S_k's lower triangle += c_kt * features_t, c_kt = gamma_kt / q_kt.
// S is written in full, its upper triangle the conjugate mirror.
//
// What bounds the function on this card: the operations.  At the headline
// shape (F = 513, T = 2504 with 2254 valid frames, D = 24, K = 5, ~2.8
// active classes per frame) it needs, per valid frame, 3 D^2 flops for the
// features, 2 D^2 per class for the forms (every class: the max shift runs
// over all K before the activity gate) and 2 D^2 per active class for the
// S update: ~12.4 GFLOP, 0.185 ms at 67 TFLOP/s (fp32, no tensor cores),
// against ~40 MB of z read once.  This kernel issues 8 D^2 flops per
// class for the forms (the plain version's products and rounding), 26.6
// GFLOP of the E-step alone at the headline.
//
// Design:
//   * a batch of B utterances is one launch over their B * F rows (the
//     JAX package's vmap of the pallas_call, which adds a grid axis): row
//     f reads the gate and mask of utterance f / fper, nothing else
//     changes, so B = 1 is the unbatched kernel;
//   * a cluster of kCluster CTAs per frequency; chunk c of kChunk frames
//     (frames 32c .. 32c + 31, fixed offsets) belongs to rank c % kCluster,
//     so padding T with fm == 0 frames changes nothing, bit for bit;
//   * each chunk's z, act and fm stream into shared memory with cp.async,
//     double-buffered: the copy of the rank's next chunk overlaps the work
//     on this one;
//   * a chunk without a valid frame is skipped; a frame with fm == 0 (its
//     gamma is exactly 0) gets no responsibilities and no M-step update;
//   * E-step: a register tile of 4 rows r = k D + d of P z x 4 frames per
//     thread (a warp: 16 rows x the chunk's 32 frames), so that per column
//     8 shared-memory loads feed 64 FMAs: the shared-memory bytes and the
//     FMAs take about the same time on this card, where a tile of one
//     frame (lane = frame) left the E-step bound by shared-memory bytes;
//     each row's term Re(conj(z_d) (P_k z)_d) goes to shared memory;
//   * responsibilities: q (the row terms summed over d in order) and log q
//     per (class, frame) on K warps, then one thread per frame over K in
//     registers;
//   * M-step: a thread keeps 6 features x all K classes in registers,
//     forms the features of its frame group's frames (t mod G) from z and
//     accumulates them in frame order; the update of a class whose
//     coefficient is exactly 0 (act == 0, or gamma underflowed) is
//     skipped, a branch uniform across the block;
//   * the G group partials and then the rank partials of S (over
//     distributed shared memory) are summed in a fixed order: one launch,
//     no atomics, no order that depends on scheduling, so the result is
//     bit-identical run to run.
// Supported sizes are what the product's configurations give: D <= 24
// channels (6 arrays x 4 mics) and K <= 5 classes (4 speakers + noise).
// IEEE float32 FMA only (no TF32, no tensor cores, no fast math).

#include <atomic>

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <float.h>
#include <math.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 32;      // frames per chunk
constexpr int kCluster = 2;     // CTAs per frequency
constexpr int kMaxD = 24;
constexpr int kMaxK = 5;
constexpr int kTile = 4;        // E-step: rows x frames of a thread's tile
constexpr int kWarpRows = 16;   // E-step: rows of P z per warp
constexpr int kRowStride = 34;  // row terms: conflict-free tile stores
constexpr int kCPad = 8;        // coefficients per frame, a float4 + 1
constexpr int kMFeat = 6;       // M-step: features per thread, even
constexpr int kMSlots = kMFeat / 2;   // M-step: feature pairs per thread
constexpr int kMaxGroups = 4;   // M-step frame groups
static_assert(kWarpRows * kChunk == 32 * kTile * kTile,
              "a warp's lanes tile its rows x the chunk's frames");
static_assert(kMaxK == 5, "the M-step loads a frame's coefficients as "
                          "one float4 and one float");

// Dynamic shared memory, in floats; every region starts at a multiple of
// 4.  MAXD: the instantiation's bound on D (even); the P and z row strides
// are MAXD + 1 (odd: the tile's loads are conflict-free) and fixed, so the
// E-step's loads sit at fixed offsets from one pointer.
struct Layout {
  int nf;      // D^2 features
  int nfp;     // nf rounded up to 4
  int prows;   // E-step rows: K D rounded up to whole warps
  int gwarps;  // warps of one M-step frame group
  int groups;  // M-step frame groups
  int p, z, act, fm, row, ql, c, total;
};

// den, lw and ld (3 x kCPad) come first; at the end the partial S
// (groups x K x nfp) takes the place of everything after them
constexpr int kSumAt = 3 * kCPad;

__host__ __device__ constexpr Layout layout(int D, int K, int MAXD) {
  Layout L{};
  L.nf = D * D;
  L.nfp = (L.nf + 3) / 4 * 4;
  L.prows = (K * D + kWarpRows - 1) / kWarpRows * kWarpRows;
  L.gwarps = (L.nfp + 32 * kMFeat - 1) / (32 * kMFeat);
  L.groups = kWarps / L.gwarps < kMaxGroups ? kWarps / L.gwarps : kMaxGroups;
  L.p = kSumAt;                                  // prows x (MAXD + 1) float2
  L.z = L.p + L.prows * (MAXD + 1) * 2;          // 2 x kChunk x (MAXD + 1)
  L.act = L.z + 2 * kChunk * (MAXD + 1) * 2;     // 2 x kMaxK x kChunk
  L.fm = L.act + 2 * kMaxK * kChunk;             // 2 x kChunk
  L.row = L.fm + 2 * kChunk;                     // prows x kRowStride
  L.ql = L.row + L.prows * kRowStride;           // 2 x kMaxK x kChunk
  L.c = L.ql + 2 * kMaxK * kChunk;               // kChunk x kCPad
  const int end = L.c + kChunk * kCPad;
  const int sum = kSumAt + L.groups * K * L.nfp;
  L.total = end > sum ? end : sum;
  return L;
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Code of feature pair h (features 2h, 2h + 1) of the layout: a (bits
// 0-7), b (bits 8-15), kind (bits 16-23) 0: Re, Im of z_a conj(z_b),
// a > b, the pairs of the lower triangle in row-major order; 1: |z_a|^2,
// |z_b|^2; 2: |z_a|^2 and a padding feature; 3: two padding features.
// Padding features (a = b = 0) are finite and never written out.
__device__ inline int feature_code(int h, int D) {
  const int j = 2 * h;
  if (j < D * (D - 1)) {
    int a = 1;
    while ((a + 1) * a / 2 <= h) ++a;
    return a | (h - a * (a - 1) / 2) << 8;
  }
  if (j < D * D) {
    const int a = j - D * (D - 1);
    return a + 1 < D ? a | (a + 1) << 8 | 1 << 16 : a | 2 << 16;
  }
  return 3 << 16;
}

// Features 2h, 2h + 1 of one frame, from its z row and the pair's code.
// Branch-free: the selects pick the operands, so the loads of many pairs
// can be in flight at once.
__device__ __forceinline__ float2 features2(const float2* zt, int code) {
  const bool off = (code >> 16) == 0;
  const float2 za = zt[code & 0xff];
  const float2 zb = zt[(code >> 8) & 0xff];
  const float2 w = off ? zb : za;
  const float m1 = off ? za.y : zb.x;
  const float m2 = off ? -za.x : zb.y;
  return make_float2(fmaf(za.x, w.x, za.y * w.y), fmaf(m1, zb.x, m2 * zb.y));
}

// MAXD: register bound on D (8, 16 or 24)
template <int MAXD>
__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads, 2)
fused_em_kernel(const float2* __restrict__ z,      // (F, T, D)
                const float2* __restrict__ prec,   // (F, K, D, D)
                const float* __restrict__ lw,      // (F, K)
                const float* __restrict__ ld,      // (F, K)
                const float* __restrict__ act_all, // (B, K, T)
                const float* __restrict__ fm_all,  // (B, T)
                float2* __restrict__ S,            // (F, K, D, D)
                float* __restrict__ den,           // (F, K)
                int T, int D, int K, int fper) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  constexpr int dp = MAXD + 1;   // row strides of P and z, in float2
  const Layout L = layout(D, K, MAXD);
  float* sDen = smem;
  float* sLw = smem + kCPad;
  float* sLd = smem + 2 * kCPad;
  float2* sP = reinterpret_cast<float2*>(smem + L.p);   // rows k D + d
  float2* sZ = reinterpret_cast<float2*>(smem + L.z);
  float* sAct = smem + L.act;
  float* sFm = smem + L.fm;
  float* sRow = smem + L.row;      // Re(conj(z_d) (P_k z)_d) per (row, frame)
  float* sQ = smem + L.ql;                  // 1 / q per (class, frame)
  float* sLp = sQ + kMaxK * kChunk;         // log-pdf per (class, frame)
  float* sC = smem + L.c;

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int f = blockIdx.x / kCluster;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const float tiny = FLT_MIN;
  const float2* zf = z + (size_t)f * T * D;
  // row f belongs to utterance f / fper of the batch: its gate and mask
  const float* act = act_all + (size_t)(f / fper) * K * T;
  const float* fm = fm_all + (size_t)(f / fper) * T;
  const int nchunks = (T + kChunk - 1) / kChunk;

  // chunk c's z rows, act columns and fm into buffer buf; fm is 0 past T
  auto fetch = [&](int c, int buf) {
    if (c < nchunks) {
      const int t0 = c * kChunk;
      const int tc = min(kChunk, T - t0);
      float2* dz = sZ + buf * kChunk * dp;
      const float2* src = zf + (size_t)t0 * D;
      for (int i = tid; i < tc * D; i += kThreads) {
        const int t = i / D;
        cp_async8(dz + t * dp + (i - t * D), src + i);
      }
      float* da = sAct + buf * kMaxK * kChunk;
      for (int i = tid; i < K * kChunk; i += kThreads) {
        const int k = i / kChunk;
        const int t = i - k * kChunk;
        if (t < tc) cp_async4(da + i, act + (size_t)k * T + t0 + t);
      }
      if (tid < kChunk) {
        float* dfm = sFm + buf * kChunk + tid;
        if (tid < tc)
          cp_async4(dfm, fm + t0 + tid);
        else
          *dfm = 0.f;
      }
    }
    cp_async_commit();
  };
  fetch(rank, 0);

  // prologue: this frequency's precisions, row r = k D + d of the K D rows
  // at stride dp (columns past D unused), zero rows past K D
  const float2* Pf = prec + (size_t)f * K * D * D;
  for (int i = tid; i < L.prows * dp; i += kThreads) {
    const int r = i / dp;
    const int e = i - r * dp;
    if (e < D)
      sP[i] = r < K * D ? Pf[r * D + e] : make_float2(0.f, 0.f);
  }
  if (tid < K) {
    sLw[tid] = lw[f * K + tid];
    sLd[tid] = ld[f * K + tid];
  }

  // M-step: this thread's kMFeat features (from column j0) in frame group
  // grp, which takes the frames t = grp (mod groups)
  const int grp = warp / L.gwarps;
  const int j0 = (tid - grp * L.gwarps * 32) * kMFeat;
  const bool mown = grp < L.groups && j0 < L.nfp;
  int code[kMSlots];
#pragma unroll
  for (int s = 0; s < kMSlots; ++s) code[s] = feature_code(j0 / 2 + s, D);
  float macc[kMaxK][kMFeat], dacc[kMaxK];   // dacc: warp 0
#pragma unroll
  for (int k = 0; k < kMaxK; ++k) {
#pragma unroll
    for (int i = 0; i < kMFeat; ++i) macc[k][i] = 0.f;
    dacc[k] = 0.f;
  }
  for (int i = tid; i < kChunk * kCPad; i += kThreads)
    sC[i] = 0.f;   // the coefficients of classes past K stay 0

  int it = 0;
  for (int c = rank; c < nchunks; c += kCluster, ++it) {
    const int buf = it & 1;
    cp_async_wait_all();
    __syncthreads();   // chunk c landed; the last M-step is done
    fetch(c + kCluster, buf ^ 1);   // overlaps the work on this chunk
    const float fmt = sFm[buf * kChunk + lane];
    // frame t0 + i is valid where bit i is set; the same in every warp
    const unsigned valid = __ballot_sync(0xffffffffu, fmt != 0.f);
    if (valid == 0u) continue;

    // E-step: warp w takes rows r = k D + d in [16 w, 16 w + 16) (rows past
    // K D are zeros), lane (rq, fq) the tile of rows 16 w + 4 rq + i and
    // frames fq + 8 j (i, j < 4): per column e four loads of P and four of
    // z feed 64 FMAs.  Each (P_k z)_d is summed over e in order with the
    // plain version's four FMAs per complex product; then its row term
    // Re(conj(z_d) (P_k z)_d).  Frames that are not valid are computed on
    // whatever their z rows hold; nothing reads their terms.
    if (kWarpRows * warp < K * D) {
      const int r0 = kWarpRows * warp + kTile * (lane >> 3);
      const int fq = lane & 7;
      const float2* prow = sP + r0 * dp;
      const float2* zq = sZ + (buf * kChunk + fq) * dp;   // frame fq
      float vr[kTile][kTile], vi[kTile][kTile];
#pragma unroll
      for (int i = 0; i < kTile; ++i)
#pragma unroll
        for (int j = 0; j < kTile; ++j) vr[i][j] = vi[i][j] = 0.f;
      auto column = [&](int e) {
        float2 p[kTile], x[kTile];
#pragma unroll
        for (int i = 0; i < kTile; ++i) p[i] = prow[i * dp + e];
#pragma unroll
        for (int j = 0; j < kTile; ++j) x[j] = zq[8 * j * dp + e];
#pragma unroll
        for (int i = 0; i < kTile; ++i) {
#pragma unroll
          for (int j = 0; j < kTile; ++j) {
            vr[i][j] = fmaf(p[i].x, x[j].x, vr[i][j]);
            vr[i][j] = fmaf(-p[i].y, x[j].y, vr[i][j]);
            vi[i][j] = fmaf(p[i].x, x[j].y, vi[i][j]);
            vi[i][j] = fmaf(p[i].y, x[j].x, vi[i][j]);
          }
        }
      };
      if (D == MAXD) {   // D at the instantiation's bound
#pragma unroll
        for (int e = 0; e < MAXD; ++e) column(e);
      } else {
#pragma unroll
        for (int e = 0; e < MAXD; ++e)
          if (e < D) column(e);
      }
#pragma unroll
      for (int i = 0; i < kTile; ++i) {
        const int r = r0 + i;
        const int d = r - r / D * D;
#pragma unroll
        for (int j = 0; j < kTile; ++j) {
          const float2 zd = zq[8 * j * dp + d];
          sRow[r * kRowStride + fq + 8 * j] =
              fmaf(zd.y, vi[i][j], zd.x * vr[i][j]);
        }
      }
    }
    __syncthreads();

    // q and log-pdf, one (class = warp, frame = lane) per thread: the row
    // terms of the class summed over d in order
    if (warp < K && ((valid >> lane) & 1u)) {
      const float* rk = sRow + warp * D * kRowStride + lane;
      float q = 0.f;
      for (int d = 0; d < D; ++d) q += rk[d * kRowStride];
      q = fmaxf(q, tiny);
      sQ[warp * kChunk + lane] = __frcp_rn(q);   // 1 / q, rounded
      sLp[warp * kChunk + lane] =
          sLw[warp] - (float)D * logf(q) - sLd[warp];
    }
    __syncthreads();

    // responsibilities, one frame per lane of warp 0, over K in
    // registers; sC[t][k] = gamma / q (products with correctly rounded
    // reciprocals: a short dependent chain)
    if (warp == 0 && ((valid >> lane) & 1u)) {
      const float* actc = sAct + buf * kMaxK * kChunk;
      float rq[kMaxK], g[kMaxK];
      float mx = -INFINITY;
#pragma unroll
      for (int k = 0; k < kMaxK; ++k) {
        if (k < K) {
          rq[k] = sQ[k * kChunk + lane];
          g[k] = sLp[k * kChunk + lane];
          mx = fmaxf(mx, g[k]);
        }
      }
      float sum = 0.f;
#pragma unroll
      for (int k = 0; k < kMaxK; ++k) {
        if (k < K) {
          g[k] = expf(g[k] - mx) * actc[k * kChunk + lane];
          sum += g[k];
        }
      }
      const float rnorm = __frcp_rn(fmaxf(sum, tiny));
#pragma unroll
      for (int k = 0; k < kMaxK; ++k) {
        if (k < K) {
          const float gk = g[k] * rnorm * fmt;
          dacc[k] += gk;
          sC[lane * kCPad + k] = gk * rq[k];
        }
      }
    }
    __syncthreads();

    // M-step, in frame order; a zero coefficient adds nothing
    if (mown) {
      for (int t = grp; t < kChunk; t += L.groups) {
        if (!((valid >> t) & 1u)) continue;
        const float4 c0 = *reinterpret_cast<const float4*>(sC + t * kCPad);
        const float ck[kMaxK] = {c0.x, c0.y, c0.z, c0.w, sC[t * kCPad + 4]};
        const float2* zt = sZ + (buf * kChunk + t) * dp;
        float x[kMFeat];
#pragma unroll
        for (int s = 0; s < kMSlots; ++s) {
          const float2 v = features2(zt, code[s]);
          x[2 * s] = v.x;
          x[2 * s + 1] = v.y;
        }
#pragma unroll
        for (int k = 0; k < kMaxK; ++k) {
          if (ck[k] != 0.f) {   // 0 past K
#pragma unroll
            for (int i = 0; i < kMFeat; ++i)
              macc[k][i] = fmaf(ck[k], x[i], macc[k][i]);
          }
        }
      }
    }
  }
  cp_async_wait_all();

  // this CTA's partials: den over warp 0's lanes (a fixed tree); S's
  // features per frame group, then summed over the groups in group order
  if (warp == 0) {
#pragma unroll
    for (int k = 0; k < kMaxK; ++k) {
      float v = dacc[k];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
      if (lane == 0 && k < K) sDen[k] = v;
    }
  }
  __syncthreads();   // every M-step is done with the chunk buffers
  float* sS = smem + kSumAt;  // groups x K x nfp
  if (mown) {
#pragma unroll
    for (int k = 0; k < kMaxK; ++k) {
      if (k < K) {
#pragma unroll
        for (int i = 0; i < kMFeat; ++i)
          if (j0 + i < L.nfp)
            sS[(grp * K + k) * L.nfp + j0 + i] = macc[k][i];
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < K * L.nfp; i += kThreads) {
    float v = sS[i];
    for (int g = 1; g < L.groups; ++g) v += sS[g * K * L.nfp + i];
    sS[i] = v;
  }
  cluster.sync();

  // S in full, summed over the ranks in rank order; each rank writes a
  // share of the elements
  const int DD = D * D;
  float2* Sf = S + (size_t)f * K * DD;
  for (int idx = rank * kThreads + tid; idx < K * DD;
       idx += kCluster * kThreads) {
    const int k = idx / DD;
    const int r = idx - k * DD;
    const int d = r / D;
    const int e = r - d * D;
    const int hi = max(d, e);
    const int lo = min(d, e);
    const int j = k * L.nfp +
                  (d == e ? D * (D - 1) + d : hi * (hi - 1) + 2 * lo);
    float re = 0.f, im = 0.f;
#pragma unroll
    for (int rr = 0; rr < kCluster; ++rr) {
      const float* part = cluster.map_shared_rank(sS, rr);
      re += part[j];
      if (d != e) im += part[j + 1];
    }
    Sf[idx] = make_float2(re, d < e ? -im : im);
  }
  if (rank == 0 && tid < K) {
    float s = 0.f;
#pragma unroll
    for (int rr = 0; rr < kCluster; ++rr)
      s += cluster.map_shared_rank(sDen, rr)[tid];
    den[f * K + tid] = s;
  }
  cluster.sync();   // no CTA leaves while another reads its shared memory
}

// The opt-in to more than 48 KB of dynamic shared memory, once per device
// and instantiation, at the instantiation's largest layout (D = MAXD,
// K = kMaxK: every region grows with D and K)
template <int MAXD>
cudaError_t opt_in() {
  static std::atomic<unsigned long long> done{0};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  const unsigned long long bit = 1ull << (device & 63);
  if (err != cudaSuccess || (done.load() & bit)) return err;
  err = cudaFuncSetAttribute(
      fused_em_kernel<MAXD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(sizeof(float) * layout(MAXD, kMaxK, MAXD).total));
  if (err == cudaSuccess) done.fetch_or(bit);
  return err;
}

template <int MAXD>
cudaError_t launch(const void* z, const void* prec, const void* lw,
                   const void* ld, const void* act, const void* fm, void* S,
                   void* den, int F, int T, int D, int K, int fper,
                   cudaStream_t stream) {
  const cudaError_t err = opt_in<MAXD>();
  if (err != cudaSuccess) return err;
  const size_t smem = sizeof(float) * (size_t)layout(D, K, MAXD).total;
  fused_em_kernel<MAXD><<<F * kCluster, kThreads, smem, stream>>>(
      static_cast<const float2*>(z), static_cast<const float2*>(prec),
      static_cast<const float*>(lw), static_cast<const float*>(ld),
      static_cast<const float*>(act), static_cast<const float*>(fm),
      static_cast<float2*>(S), static_cast<float*>(den), T, D, K, fper);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launch on `stream`; returns the cudaError_t of the launch (0 = success).
// A batch of B utterances: z, prec, lw, ld, S and den hold F = B * fper
// rows, utterance b's rows b * fper .. (b + 1) * fper - 1, which read
// act + b K T and fm + b T.  One launch for the whole batch; B = 1
// (fper = F) is the unbatched entry.
int pb_fused_em_scatter_batched(const void* z, const void* prec,
                                const void* lw, const void* ld,
                                const void* act, const void* fm, void* S,
                                void* den, int F, int T, int D, int K,
                                int fper, void* stream) {
  if (F < 1 || T < 1 || D < 1 || D > kMaxD || K < 1 || K > kMaxK ||
      fper < 1 || F % fper != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (D <= 8)
    err = launch<8>(z, prec, lw, ld, act, fm, S, den, F, T, D, K, fper, st);
  else if (D <= 16)
    err = launch<16>(z, prec, lw, ld, act, fm, S, den, F, T, D, K, fper, st);
  else
    err = launch<24>(z, prec, lw, ld, act, fm, S, den, F, T, D, K, fper, st);
  return static_cast<int>(err);
}

// The unbatched entry: act (K, T) and fm (T,) for all F rows.
int pb_fused_em_scatter(const void* z, const void* prec, const void* lw,
                        const void* ld, const void* act, const void* fm,
                        void* S, void* den, int F, int T, int D, int K,
                        void* stream) {
  return pb_fused_em_scatter_batched(z, prec, lw, ld, act, fm, S, den, F, T,
                                     D, K, F, stream);
}

}  // extern "C"
