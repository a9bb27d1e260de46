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
//     gamma is exactly 0) gets no responsibilities and a zero M-step
//     coefficient, which adds exactly 0 (z is finite; rows past T are 0);
//   * E-step: a register tile of 4 rows r = k D + d of P z x 4 frames per
//     thread (a warp: 16 rows x the chunk's 32 frames), so that per column
//     8 shared-memory loads feed 64 FMAs: the shared-memory bytes and the
//     FMAs take about the same time on this card, where a tile of one
//     frame (lane = frame) left the E-step bound by shared-memory bytes;
//     each row's term Re(conj(z_d) (P_k z)_d) goes to shared memory;
//   * responsibilities: q (the row terms summed over d in order) and log q
//     per (class, frame) on K warps, then one thread per frame over K in
//     registers;
//   * M-step: a rank-1 update per frame.  A thread owns a block of the
//     lower triangle of z z^H, kMRows rows a x C columns b, all K classes
//     in registers: per frame it loads the block's kMRows + C z entries
//     once and forms its kMRows C complex products (2 features each), so
//     that at 2 x 3 four z loads and two of the coefficients feed 60 FMAs
//     of the update, where a thread of 6 features (3 products, two z loads
//     each) fed 30 with 8 loads and left the M-step bound by shared-memory
//     loads.  Frame group g takes the frames t = g (mod G) in frame order,
//     two at a time; a class whose coefficients are all exactly 0 in the
//     chunk (act == 0, or gamma underflowed) is skipped, a branch uniform
//     across the block;
//   * the M-step's tile by instantiation (ptxas -v; CTAs an SM from the
//     occupancy calculator; PERF.md has the timings):
//       MAXD 24: 2 x 3, 56 blocks at D = 24 (2 warps a group, 4 groups);
//                128 registers, 148 B of spill stores, 2 CTAs an SM
//       MAXD 16: 2 x 2, 21 blocks at D = 12 (1 warp, 8 groups);
//                128 registers, 48 B of spill stores, 2 CTAs an SM
//       MAXD 8:  2 x 2, 3 blocks at D = 4 (1 warp, 8 groups);
//                128 registers, 44 B of spill stores, 2 CTAs an SM
//     The spills sit outside the E-step's and the M-step's loops (the
//     prologue and the responsibilities).  2 x 3 at MAXD 24: 2 x 2 there
//     took 2% longer.  MAXD 8 takes the block tile too: at D = 4 the
//     kernel with it took 0.41 ms where 6 features a thread took 0.51 (8
//     frame groups where there were 4, on the few threads D = 4 gives the
//     M-step);
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
constexpr int kMRows = 2;       // M-step: rows a of a thread's block
constexpr int kMFrames = 2;     // M-step: frames a thread loads together
constexpr int kMaxGroups = 8;   // M-step frame groups
static_assert(kWarpRows * kChunk == 32 * kTile * kTile,
              "a warp's lanes tile its rows x the chunk's frames");
static_assert(kMaxK == 5, "the M-step loads a frame's coefficients as "
                          "one float4 and one float");

// M-step: columns b of a thread's block, by the instantiation: 3 at
// MAXD 24, 2 below
__host__ __device__ constexpr int m_cols(int MAXD) {
  return MAXD > 16 ? 3 : 2;
}

// Blocks of kMRows x C that cover the lower triangle (b <= a) of z z^H,
// D x D: the blocks of the grid that hold at least one b <= a; row i of
// blocks, and all of them
__host__ __device__ constexpr int row_blocks(int i, int D, int C) {
  const int last = (kMRows * i + kMRows - 1) / C;
  const int cols = (D + C - 1) / C;
  return (last < cols ? last : cols - 1) + 1;
}

__host__ __device__ constexpr int mstep_blocks(int D, int C) {
  int n = 0;
  for (int i = 0; kMRows * i < D; ++i) n += row_blocks(i, D, C);
  return n;
}

// Dynamic shared memory, in floats; every region starts at a multiple of
// 4.  MAXD: the instantiation's bound on D (even); the P row stride is
// MAXD + 1 (odd: the tile's row loads are conflict-free), the z row stride
// MAXD + 2 (even: every z row starts at 16 bytes, so the M-step loads two
// entries at once; the E-step's 8 frames still fall on distinct banks),
// both fixed, so the E-step's loads sit at fixed offsets from one pointer.
struct Layout {
  int nf;      // D^2 features
  int nfp;     // nf rounded up to 4
  int prows;   // E-step rows: K D rounded up to whole warps
  int blocks;  // M-step blocks of one frame group, a thread each
  int gwarps;  // warps of one M-step frame group
  int groups;  // M-step frame groups
  int p, z, act, fm, row, ql, c, dacc, mask, total;
};

// den, lw and ld (3 x kCPad) come first; at the end the partial S
// (groups x K x nfp) takes the place of everything after them
constexpr int kSumAt = 3 * kCPad;

__host__ __device__ constexpr Layout layout(int D, int K, int MAXD) {
  Layout L{};
  L.nf = D * D;
  L.nfp = (L.nf + 3) / 4 * 4;
  L.prows = (K * D + kWarpRows - 1) / kWarpRows * kWarpRows;
  L.blocks = mstep_blocks(D, m_cols(MAXD));
  L.gwarps = (L.blocks + 31) / 32;
  L.groups = kWarps / L.gwarps < kMaxGroups ? kWarps / L.gwarps : kMaxGroups;
  L.p = kSumAt;                                  // prows x (MAXD + 1) float2
  L.z = L.p + L.prows * (MAXD + 1) * 2;          // 2 x kChunk x (MAXD + 2)
  L.act = L.z + 2 * kChunk * (MAXD + 2) * 2;     // 2 x kMaxK x kChunk
  L.fm = L.act + 2 * kMaxK * kChunk;             // 2 x kChunk
  L.row = L.fm + 2 * kChunk;                     // prows x kRowStride
  L.ql = L.row + L.prows * kRowStride;           // 2 x kMaxK x kChunk
  L.c = L.ql + 2 * kMaxK * kChunk;               // kChunk x kCPad
  L.dacc = L.c + kChunk * kCPad;                 // kMaxK x kChunk
  L.mask = L.dacc + kMaxK * kChunk;              // 1 (of 4)
  const int end = L.mask + 4;
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

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// N consecutive entries z_e0 .. z_e0+N-1 of a z row; e0 a multiple of N:
// an even N loads them two at a time (16-byte aligned)
template <int N>
__device__ __forceinline__ void load_run(const float2* zt, int e0,
                                         float2 (&v)[N]) {
  if constexpr (N % 2 == 0) {
#pragma unroll
    for (int i = 0; i < N; i += 2) {
      const float4 w = *reinterpret_cast<const float4*>(zt + e0 + i);
      v[i] = make_float2(w.x, w.y);
      v[i + 1] = make_float2(w.z, w.w);
    }
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) v[i] = zt[e0 + i];
  }
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
  constexpr int dp = MAXD + 1;   // row stride of P, in float2
  constexpr int zs = MAXD + 2;   // row stride of z, in float2
  constexpr int mc = m_cols(MAXD);
  constexpr int mfeat = 2 * kMRows * mc;   // M-step: features per thread
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
  float* sDacc = smem + L.dacc;   // den's partial per (class, lane)
  // bit k: class k has a coefficient that is not 0 in the chunk
  unsigned* sMask = reinterpret_cast<unsigned*>(smem + L.mask);

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
  // z rows in pieces of 16 bytes where every row starts at 16 bytes, else
  // of 8: a warp copies `per` rows at once, lane l piece `piece` of row
  // `prow` of them
  const bool pairs =
      D % 2 == 0 && (reinterpret_cast<size_t>(z) & 15) == 0;
  const int pieces = pairs ? D / 2 : D;
  const int per = 32 / pieces;
  const int prow = lane / pieces;
  const int piece = (lane - prow * pieces) * (pairs ? 2 : 1);

  // chunk c's z rows, act columns and fm into buffer buf; z rows and fm
  // are 0 past T (every z row the M-step reads is finite)
  auto fetch = [&](int c, int buf) {
    if (c < nchunks) {
      const int t0 = c * kChunk;
      const int tc = min(kChunk, T - t0);
      float2* dz = sZ + buf * kChunk * zs;
      const float2* src = zf + (size_t)t0 * D;
      for (int t = warp * per + prow; prow < per && t < kChunk;
           t += kWarps * per) {
        float2* dst = dz + t * zs + piece;
        if (t >= tc) {
          dst[0] = make_float2(0.f, 0.f);
          if (pairs) dst[1] = make_float2(0.f, 0.f);
        } else if (pairs) {
          cp_async16(dst, src + t * D + piece);
        } else {
          cp_async8(dst, src + t * D + piece);
        }
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

  // M-step: this thread's block, rows a0 .. a0 + kMRows - 1 x columns
  // b0 .. b0 + mc - 1 of z z^H, in frame group grp, which takes the
  // frames t = grp (mod groups); block n of the group in row-major order
  const int grp = warp / L.gwarps;
  int n = tid - grp * L.gwarps * 32;
  const bool mown = grp < L.groups && n < L.blocks;
  int a0 = 0;
  if (mown)
    for (int i = 0; n >= row_blocks(i, D, mc); ++i) {
      n -= row_blocks(i, D, mc);
      a0 += kMRows;
    }
  const int b0 = mc * n;
  float macc[kMaxK][mfeat];
#pragma unroll
  for (int k = 0; k < kMaxK; ++k)
#pragma unroll
    for (int i = 0; i < mfeat; ++i) macc[k][i] = 0.f;
  for (int i = tid; i < kMaxK * kChunk; i += kThreads) sDacc[i] = 0.f;

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
      const float2* zq = sZ + (buf * kChunk + fq) * zs;   // frame fq
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
        for (int j = 0; j < kTile; ++j) x[j] = zq[8 * j * zs + e];
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
      int d = r0 % D;   // row r0 + i is row d of its class
#pragma unroll
      for (int i = 0; i < kTile; ++i) {
        const int r = r0 + i;
#pragma unroll
        for (int j = 0; j < kTile; ++j) {
          const float2 zd = zq[8 * j * zs + d];
          sRow[r * kRowStride + fq + 8 * j] =
              fmaf(zd.y, vi[i][j], zd.x * vr[i][j]);
        }
        d = d + 1 == D ? 0 : d + 1;
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
    // reciprocals: a short dependent chain), 0 for a frame that is not
    // valid and for a class past K; the chunk's class mask
    if (warp == 0) {   // responsibilities
      float ck[kMaxK] = {};
      if ((valid >> lane) & 1u) {
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
            sDacc[k * kChunk + lane] += gk;
            ck[k] = gk * rq[k];
          }
        }
      }
      unsigned mask = 0u;
#pragma unroll
      for (int k = 0; k < kMaxK; ++k) {
        sC[lane * kCPad + k] = ck[k];
        if (__any_sync(0xffffffffu, ck[k] != 0.f)) mask |= 1u << k;
      }
      if (lane == 0) *sMask = mask;
    }
    __syncthreads();

    // M-step, in frame order: the block's rank-1 update from its rows'
    // and columns' z entries, loaded once a frame (features 2 (i C + j)
    // and 2 (i C + j) + 1: Re and Im of z_a conj(z_b)), kMFrames frames
    // t0 + u groups loaded together (kChunk / groups is a multiple of
    // kMFrames: groups <= 8).  A class whose coefficients are all 0 in
    // the chunk is skipped, a branch uniform across the block; in the
    // others a zero coefficient adds an exact 0 (the features are finite)
    if (mown) {
      const unsigned mask = *sMask;
      for (int t0 = grp; t0 < kChunk; t0 += kMFrames * L.groups) {
        float ck[kMFrames][kMaxK], x[kMFrames][mfeat];
#pragma unroll
        for (int u = 0; u < kMFrames; ++u) {
          const int t = t0 + u * L.groups;
          const float4 c0 =
              *reinterpret_cast<const float4*>(sC + t * kCPad);
          ck[u][0] = c0.x;
          ck[u][1] = c0.y;
          ck[u][2] = c0.z;
          ck[u][3] = c0.w;
          ck[u][4] = sC[t * kCPad + 4];
          const float2* zt = sZ + (buf * kChunk + t) * zs;
          float2 za[kMRows], zb[mc];
          load_run(zt, a0, za);
          load_run(zt, b0, zb);
#pragma unroll
          for (int i = 0; i < kMRows; ++i) {
#pragma unroll
            for (int j = 0; j < mc; ++j) {
              const int h = 2 * (i * mc + j);
              x[u][h] = fmaf(za[i].x, zb[j].x, za[i].y * zb[j].y);
              x[u][h + 1] = fmaf(za[i].y, zb[j].x, -za[i].x * zb[j].y);
            }
          }
        }
#pragma unroll
        for (int k = 0; k < kMaxK; ++k) {
          if ((mask >> k) & 1u) {
#pragma unroll
            for (int u = 0; u < kMFrames; ++u) {
#pragma unroll
              for (int i = 0; i < mfeat; ++i)
                macc[k][i] = fmaf(ck[u][k], x[u][i], macc[k][i]);
            }
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
      float v = sDacc[k * kChunk + lane];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
      if (lane == 0 && k < K) sDen[k] = v;
    }
  }
  __syncthreads();   // every M-step is done with the chunk buffers
  float* sS = smem + kSumAt;  // groups x K x nfp
  if (mown) {   // the block's entries of the lower triangle, a < D
#pragma unroll
    for (int i = 0; i < kMRows; ++i) {
#pragma unroll
      for (int j = 0; j < mc; ++j) {
        const int a = a0 + i;
        const int b = b0 + j;
        if (a < D && b <= a) {
          const int h = 2 * (i * mc + j);
          float* out = sS + grp * K * L.nfp +
                       (a == b ? D * (D - 1) + a : a * (a - 1) + 2 * b);
#pragma unroll
          for (int k = 0; k < kMaxK; ++k) {
            if (k < K) {
              out[k * L.nfp] = macc[k][h];
              if (a != b) out[k * L.nfp + 1] = macc[k][h + 1];
            }
          }
        }
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

// The instantiation's largest layout, in floats: K = kMaxK (every region
// grows with K), the largest over D (the partial S's frame groups do not
// grow with D)
constexpr int max_layout(int MAXD) {
  int most = 0;
  for (int D = 1; D <= MAXD; ++D)
    most = layout(D, kMaxK, MAXD).total > most ? layout(D, kMaxK, MAXD).total
                                               : most;
  return most;
}

// The opt-in to more than 48 KB of dynamic shared memory, once per device
// and instantiation, at the instantiation's largest layout
template <int MAXD>
cudaError_t opt_in() {
  static std::atomic<unsigned long long> done{0};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  const unsigned long long bit = 1ull << (device & 63);
  if (err != cudaSuccess || (done.load() & bit)) return err;
  err = cudaFuncSetAttribute(
      fused_em_kernel<MAXD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(sizeof(float) * max_layout(MAXD)));
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
