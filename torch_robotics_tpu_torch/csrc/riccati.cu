// The iLQR sweeps, batch in the minor (lane) axis.
//
// riccati_kernel: the square-root Riccati backward sweep.  It replaces the
// TPU kernel torch_robotics_tpu/ops/pallas_riccati.py
// (riccati_backward_pallas_factory); its plain PyTorch version is
// riccati_backward_lanes in torch_robotics_tpu_torch/solve/riccati_lanes.py.
// The value Hessian is carried as a factor S (Vxx = S^T S, S0 = sqrt(kg) I).
// Each step QR-factors, by Householder reflections, the stacked array
//   [[sqrt(r + mu) I, 0], [S B, S Phi], [0, F_t]]
// in two phases: d reflections over the u columns (F rows are zero there
// and the top block's pivot is the constant sqrt(r + mu), so they touch
// only the top d + m rows) give R11, R12; m reflections triangularize
// [S Phi; F_t] into the next S.  Then k = -R11^-1 R11^-T Qu,
// K = -R11^-1 R12 and Vx' = Qx + R12^T (R11 k).  S B and S Phi are
// elementwise in the double-integrator structure.
//   U (T, D, B), l (T, M, B), Fc (T, M, P, B) column-major F, Vx0 (M, B)
//   -> ks (T, D, B), Ks (T, D, M, B);  M = 2 D.
//
// rollout_kernel: the closed-loop line-search rollout of every step size.
// It replaces linesearch_rollout_pallas_factory in the same file; its
// plain version is linesearch_rollout_lanes.  Per step size alpha and step
// t: u = U[t] + alpha k[t] + K[t] (x - xs[t]), x stepped by the double
// integrator.
//   xs (T + 1, M, B), U, ks, Ks, alphas (A) -> xs_out (A, T, M, B) (the
//   states after step 0), U_out (A, T, D, B).
//
// What bounds the sweep on the H100: latency, not bytes or operations.  At
// the iLQR path's shapes (T = 31, D = 7, P = 27, B = 512) it must move ~32
// MB (Fc alone is 24 MB: 0.0096 ms at 3.35 TB/s) and do ~3.7e8 float ops
// (~0.006 ms at 67 TFLOP/s), but each lane is a chain of T dependent
// steps, each step a chain of D + M Householder pivots (a norm, a square
// root, a division and a dot product each).  The design before this one
// ran that chain in one thread per lane in 64-thread blocks (8 of the 132
// SMs at B = 512), spilled its ~500 floats of S, S Phi, S B and R past 255
// registers, and sent phase 2's F columns through a device-memory scratch
// for every pivot and column (~320 MB through L2 a launch, each load
// waiting on the store before it): 6.9-7.3 ms on an H100 80GB HBM3 at
// 700 W.  This design takes 0.36 ms there (0.20 ms at T = 15, P = 34, on
// the same card); its time is the same at B = 8 as at B = 512, so one
// lane's chain still sets it, with one compute warp per scheduler at B =
// 512 and nothing to hide each instruction's latency.
//
// Design: a group of G threads per lane (G the power of two >= M: 16 for
// D = 5..8, 8 for D = 3, 4, 4 for D = 2, 2 for D = 1), `lanes` groups per
// block (whole warps, at most kMaxCompute threads) and one producer warp;
// the host picks `lanes` and the ring's depth (riccati_launch_config in
// ops/riccati_kernel.py) so that the grid reaches every SM.  Thread c of a
// group owns column c of the stacked [S Phi; F_t] (S, upper triangular, in
// registers between steps; F_t in shared memory) and, for c < D, column c
// of G = S B in phase 1.  A pivot's column is broadcast inside the group by
// __shfl_sync (its S rows) or read by the whole group from shared memory
// (its F rows); every thread forms its own column's dot products, in four
// partial sums, and applies the reflection to its column.  Phase 2 makes
// one pass over the F rows per pivot: it reflects each column by pivot j
// and, from pivot j's column and column j + 1 (a broadcast read), forms
// column j + 1 after it and the sums pivot j + 1 needs, so that each
// pivot's chain holds one pass.  F_t is reflected in shared memory (one
// __syncwarp a pivot), 16 rows a pass in 16-byte loads: nothing but the
// outputs goes to device memory.  The pivot loops stay rolled (a pivot's
// index is a run-time value; registers are picked by selects), which
// keeps the kernel's code small enough for the instruction caches; fully
// unrolled pivots made it twice as long and slower.  The gains come out
// column by column: thread c back-substitutes column c of K against R11
// (gathered from its column owners by shuffles) and computes Vx'[c]; k,
// which every thread needs for Vx', is formed by every thread of the
// group.  Nothing spills (ptxas, every D).
//
// Loads: the producer warp stages step t - 1's F_t, U_t and l_t while the
// compute warps run step t, into a ring of two stages (one barrier a
// step).  Entry (c, p) of the block's lanes is `lanes` contiguous floats of
// Fc, read 16 bytes (4 lanes) at a time and written transposed, so that
// each lane's column is contiguous rows in shared memory, padded so that a
// quarter warp's 16-byte loads of 8 columns fall in distinct banks.  P is
// a run-time size: a stage holds (M + 1) P `lanes` floats (a spare column
// slot), so a large P takes fewer lanes per block, then one stage, and
// above what the fewest lanes of one stage fit in 227 KB the wrapper
// raises.
//
// A ragged batch: the last block's missing lanes are staged as zeros, run
// every instruction (so shuffles and __syncwarp take the full mask) and
// write nothing.  Each lane's arithmetic is the same wherever it sits in
// the batch and whatever `lanes` is.  sqrtf and divisions are correctly
// rounded (no fast math), as the TPU kernel's are.
//
// What bounds the rollout on the H100: latency.  At the iLQR path's shapes
// (T = 31, D = 7, A = 5 step sizes, B = 512) it must move ~14.7 MB (Ks,
// 6.2 MB, read once for all step sizes; the A rollouts' states and
// controls written): 0.0044 ms at 3.35 TB/s, and ~2.6e7 float ops, 0.0004
// ms at 67 TFLOP/s; but each (lane, step size) is a chain of T dependent
// steps, each a dot product of M = 2 D terms per joint.  The design before
// this one ran a thread per (lane, step size) in 64-thread blocks (40 of
// the 132 SMs at B = 512, two warps each), each thread reading its own
// copy of Ks and waiting on its loads at every step: 0.141 ms on an H100
// 80GB HBM3 at 700 W.
//
// Design: a block takes `lanes` lanes with all A step sizes; a group of G
// threads (the power of two >= D: 8 for D = 5..8) runs one (lane, step
// size), thread j of the group owning joint j: x[j], x[j + D] and u_j
// (threads j >= D, and groups past the block's A step sizes, run every
// instruction, so that shuffles take the full mask, and write nothing).  A
// step broadcasts dx inside the group by __shfl_sync, and
// thread j forms u_j = U + alpha k + K[j] dx in the order of the earlier
// kernel (so ptxas contracts the same FMAs and the outputs are its bits),
// then steps its joint's double integrator.  Later steps' rows of Ks, U,
// ks and xs for the block's lanes are copied into shared memory by
// cp.async while step t runs, a row's `lanes` floats (1, 2 or 4, B a
// multiple of it) in one copy: each row is read from device memory once
// for all A step sizes, into a ring of 8 steps, so that a step's loads
// are issued 7 steps before it runs; one barrier a step both publishes
// step t and frees step t - 1's slot for the next copy.  (A copy a float,
// with the lane's row found by a division, took half of each step:
// PERF.md section 6, K7.)  rollout_launch_config in ops/riccati_kernel.py
// picks the most lanes a block that divide B, the inputs' alignment allows
// and fit 1024 threads: 4 at B = 512, 128 blocks, though 4 SMs then get
// none (2 lanes a block, 256 blocks, took 34-35% longer at T = 31 and 15;
// 1 lane took longer at B = 100 and 4096 too: PERF.md, K7).  0.0162 ms at T = 31 on
// the card above, ~0.5 us a step: each step still waits on its barrier
// and its 14-term chain of shuffles and FMAs.
//
// Past eight joints (9 <= D <= 64): riccati_wide_kernel and
// rollout_wide_kernel, one kernel each, with D, the group and the ring's
// depth run-time values, so that nvcc builds two more kernels, not 56.
// A lane's arithmetic depends on D, P and its inputs alone, so its bits are
// the same at every group width and lanes a block.
//
// The wide sweep: a group of G = 32, 64 or 128 threads a lane (a power of
// two >= M), `lanes` groups a block and one producer warp.  Thread c owns
// column c, as above, but every column lives in shared memory: S (M x M)
// and G = S B (M x D) in a lane's own region, F_t in the ring, so that
// nothing spills whatever D is (S alone is 64 KB at D = 64).  A lane's
// region also holds R11, R12 (overwritten by K in place), Vx and k.  A
// pivot's column is read by the whole group from shared memory (a
// broadcast); every thread forms its own dot products serially, in four
// partial sums, over 16-byte loads of its own column and the pivot's, so
// no sum's order depends on G.  A group syncs once a pivot: by __syncwarp
// at G = 32, by named barrier (bar.sync 1 + lane, G) past a warp.  Each
// pivot takes two passes over the rows (the dot products, then the
// update), not the narrow route's one: simpler, and the columns' strides
// (4 past a multiple of 8 floats) keep a quarter warp's 16-byte loads in
// distinct banks.  Thread 0 of the group forms 1 / R11[i][i], k and R11 k
// for the gains; thread c back-substitutes column c of K.  The producer
// warp stages F_t, U_t and l_t by 4-byte cp.async (every copy of a step
// in flight at once; the missing lanes and the rows past P as zeros),
// into a ring of 2 stages where they fit, else 1.  Five Pandas (D = 35, P
// ~ 385) take one lane and one stage a block (~160 KB); the wrapper raises
// past riccati_p_cap(D).  What bounds it is still one lane's chain: each
// step is M pivots of two passes over M + P rows, each thread a column.
//
// The wide rollout: a group of the power of two >= D threads (16, 32 or
// 64) a (lane, step size), as rollout_kernel, but dx goes through shared
// memory (a group may span two warps), so a step has two barriers; the
// ring's depth is what fits (a step's rows are 2 D^2 + 4 D floats a lane,
// 33 KB at D = 64), at most 8 and at least 2 steps.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kMaxRolloutThreads = 1024;  // the rollout's block, at most
constexpr int kRollStages = 8;     // the rollout's ring: steps in flight
constexpr int kMaxCompute = 128;   // the sweep's compute threads per block
constexpr int kProducer = 32;      // and its one producer warp
constexpr int kMaxStages = 2;      // the sweep's deepest ring
constexpr int kMaxSmem = 232448;   // bytes of shared memory a block can use
constexpr int kRows = 16;          // F_t rows a pass loads at once

struct SweepConsts {
  float dt, half_dt2, r, ru2, sqrt_ru, sqrt_kg;
};

// compute threads per lane in the sweep: the power of two >= M (M <= 16)
__host__ __device__ constexpr int group_size(int M) {
  return M <= 2 ? 2 : M <= 4 ? 4 : M <= 8 ? 8 : 16;
}

// rows of a stage's F_t: P rounded up to whole passes of kRows, the rows
// past P zero
__host__ __device__ inline int f_rows(int P) {
  return (P + kRows - 1) / kRows * kRows;
}

// floats from one column of a stage's F_t to the next: f_rows(P), padded
// to 4 more than a multiple of 32, so that the 16-byte loads of a quarter
// warp (8 columns of one lane) fall in distinct banks
__host__ __device__ inline int f_col_stride(int P) {
  const int n = f_rows(P);
  return n + ((4 - n) % 32 + 32) % 32;
}

// floats of one stage of the ring, a multiple of 4: F_t ([lanes][M + 1]
// column slots of f_col_stride floats, one of them spare), U_t
// ([D][lanes]), l_t ([M][lanes]); ops/riccati_kernel.py's
// riccati_launch_config mirrors it
__host__ __device__ inline size_t stage_floats(int D, int P, int lanes) {
  const size_t n = static_cast<size_t>(2 * D + 1) * lanes * f_col_stride(P)
                   + static_cast<size_t>(3 * D) * lanes;
  return (n + 3) / 4 * 4;
}

__device__ __forceinline__ float sum4(const float (&s)[4]) {
  return (s[0] + s[1]) + (s[2] + s[3]);
}

// sum of x[i] y[i] over i in [from, N), in four partial sums; `from` may
// be a run-time value (the partial sums keep static indices)
template <int N>
__device__ __forceinline__ float dot_from(const float* x, const float* y,
                                          int from) {
  float s[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int i = 0; i < N; ++i)
    s[i & 3] = i >= from ? fmaf(x[i], y[i], s[i & 3]) : s[i & 3];
  return sum4(s);
}

// kRows consecutive rows of one column, 16 bytes at a time
__device__ __forceinline__ void load_rows(float (&x)[kRows],
                                          const float* src) {
#pragma unroll
  for (int u = 0; u < kRows; u += 4) {
    const float4 v = *reinterpret_cast<const float4*>(src + u);
    x[u] = v.x;
    x[u + 1] = v.y;
    x[u + 2] = v.z;
    x[u + 3] = v.w;
  }
}

__device__ __forceinline__ void store_rows(float* dst,
                                           const float (&x)[kRows]) {
#pragma unroll
  for (int u = 0; u < kRows; u += 4)
    *reinterpret_cast<float4*>(dst + u) =
        make_float4(x[u], x[u + 1], x[u + 2], x[u + 3]);
}

// The producer warp stages step t's F_t, U_t and l_t for the block's lanes
// (thread k of the warp).  Entry (c, p) of `lanes` consecutive lanes is
// `lanes` contiguous floats of Fc; it is read 16 bytes (4 lanes) at a time
// where `quad` (lanes, B and Fc 16-byte aligned), else float by float, and
// written transposed, so that each lane's column of F_t is contiguous rows
// in shared memory.  The block's missing lanes and the rows past P are
// staged as zeros.
template <int D>
__device__ __forceinline__ void stage_step(const float* __restrict__ U,
                                           const float* __restrict__ l,
                                           const float* __restrict__ Fc,
                                           float* st, int t, int P, int l0,
                                           int lanes, int B, int k,
                                           bool quad) {
  constexpr int M = 2 * D;
  const size_t sB = B;
  const int nv = B - l0 < lanes ? B - l0 : lanes;  // live lanes
  const int PR = f_rows(P), PS = f_col_stride(P);
  const float* Ft = Fc + static_cast<size_t>(t) * M * P * sB + l0;
  if (quad) {  // nv is a multiple of 4 too
    for (int q = 0; 4 * q < lanes; ++q) {
#pragma unroll 1
      for (int c = 0; c < M; ++c) {
        for (int p = k; p < PR; p += kProducer) {
          float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
          if (p < P && 4 * q < nv)
            v = __ldg(reinterpret_cast<const float4*>(
                Ft + (static_cast<size_t>(c) * P + p) * sB + 4 * q));
          float* dst = st + (4 * q * (M + 1) + c) * PS + p;
          dst[0] = v.x;
          dst[(M + 1) * PS] = v.y;
          dst[2 * (M + 1) * PS] = v.z;
          dst[3 * (M + 1) * PS] = v.w;
        }
      }
    }
  } else {
    for (int sl = 0; sl < lanes; ++sl) {
#pragma unroll 1
      for (int c = 0; c < M; ++c) {
        for (int p = k; p < PR; p += kProducer)
          st[(sl * (M + 1) + c) * PS + p] =
              p < P && sl < nv
                  ? __ldg(Ft + (static_cast<size_t>(c) * P + p) * sB + sl)
                  : 0.f;
      }
    }
  }
  // U_t and l_t: [i][lanes]
  float* Us = st + static_cast<size_t>(M + 1) * lanes * PS;
  for (int e = k; e < 3 * D * lanes; e += kProducer) {
    const int i = e / lanes, sl = e - i * lanes;
    const float* src = i < D ? U + (static_cast<size_t>(t) * D + i) * sB
                             : l + (static_cast<size_t>(t) * M + i - D) * sB;
    Us[e] = sl < nv ? __ldg(src + l0 + sl) : 0.f;
  }
}

template <int D>
__global__ void __launch_bounds__(kMaxCompute + kProducer, 1)
riccati_kernel(const float* __restrict__ U, const float* __restrict__ l,
               const float* __restrict__ Fc, const float* __restrict__ Vx0,
               float* __restrict__ ks, float* __restrict__ Ks, int P, int T,
               int B, int stages, SweepConsts c) {
  constexpr int M = 2 * D, G = group_size(M);
  // every thread of a compute warp runs every instruction of the sweep
  // (missing lanes and idle threads included), so shuffles take the full
  // mask
  constexpr unsigned kAll = 0xffffffffu;
  extern __shared__ float smem[];
  const int lanes = (blockDim.x - kProducer) / G;
  const int tid = threadIdx.x;
  const bool producer = tid >= lanes * G;  // the last warp
  const int ll = tid / G;                  // the group's lane in the block
  const int j0 = tid % G;
  const bool own = j0 < M;                 // idle threads write nothing
  const int jc = own ? j0 : M - 1;         // this thread's column
  const int partner = jc < D ? jc + D : jc - D;
  const int l0 = blockIdx.x * lanes;
  const int lane = l0 + ll;
  const bool live = !producer && lane < B;
  const size_t sB = B;
  const int PS = f_col_stride(P);
  const size_t ssz = stage_floats(D, P, lanes);
  const bool quad = lanes % 4 == 0 && B % 4 == 0 &&
                    (reinterpret_cast<size_t>(Fc) & 15) == 0;
  auto stage = [&](int n) {  // step n (t = T - 1 - n) into its slot
    stage_step<D>(U, l, Fc, smem + (n % stages) * ssz, T - 1 - n, P, l0,
                  lanes, B, tid - lanes * G, quad);
  };

  float a[M];   // column jc of S between steps, of S Phi, then of the next S
  float Vx[M];  // the value gradient (the same in every thread of a group)
#pragma unroll
  for (int i = 0; i < M; ++i) {
    a[i] = i == jc ? c.sqrt_kg : 0.f;
    Vx[i] = live ? Vx0[i * sB + lane] : 0.f;
  }
  float vx_own = live ? Vx0[jc * sB + lane] : 0.f;

  // The producer warp stages step n + 1 (in the order t = T - 1, ..., 0)
  // while the compute warps run step n; with one stage (a large P) it
  // stages step n + 1 once step n is done.
  if (producer) stage(0);
  for (int n = 0; n < T; ++n) {
    const int t = T - 1 - n;
    __syncthreads();  // step n staged; with two stages the other slot free
    if (producer) {
      if (stages == 2 && n + 1 < T) stage(n + 1);
    } else {
      float* Fs = smem + (n % stages) * ssz;
      const float* Us = Fs + static_cast<size_t>(M + 1) * lanes * PS;
      const float* ls = Us + D * lanes;

      // G = S B (column jc, for jc < D) and S Phi in place: the partner
      // column is jc + D or jc - D
      float g[M];
#pragma unroll
      for (int i = 0; i < M; ++i) {
        const float o = __shfl_sync(kAll, a[i], partner, G);
        g[i] = c.half_dt2 * a[i] + c.dt * o;
        a[i] = jc < D ? a[i] : c.dt * o + a[i];
      }

      // phase 1: D reflections over the u columns -> column jc of R11 (jc <
      // D) and of R12
      float r11[D], r12[D];
#pragma unroll 1
      for (int j = 0; j < D; ++j) {
        float gj[M];
#pragma unroll
        for (int i = 0; i < M; ++i) gj[i] = __shfl_sync(kAll, g[i], j, G);
        const float gg = dot_from<M>(gj, gj, 0);
        const float alpha = -sqrtf(c.ru2 + gg);
        const float v0 = c.sqrt_ru - alpha;  // > 0 always
        const float beta = 2.f / (v0 * v0 + gg);
        const float wx = dot_from<M>(gj, a, 0);
        const float wu = dot_from<M>(gj, g, 0);
        const float r12j = -(beta * v0) * wx;
        const float r11j = jc == j ? alpha : jc > j ? -(beta * v0) * wu : 0.f;
#pragma unroll
        for (int i = 0; i < D; ++i) {
          r12[i] = i == j ? r12j : r12[i];
          r11[i] = i == j ? r11j : r11[i];
        }
        const float bx = beta * wx, bu = beta * wu;
#pragma unroll
        for (int i = 0; i < M; ++i) {
          a[i] = fmaf(-bx, gj[i], a[i]);
          g[i] = fmaf(-bu, gj[i], g[i]);  // columns <= j are not used again
        }
      }

      // gains: R11 gathered from its column owners; w = R11^-T Qu and
      // k = -R11^-1 w in every thread; column jc of K = -R11^-1 R12 and
      // Vx'[jc] = Qx[jc] + R12[:, jc]^T (R11 k); Qx = l + Phi^T Vx,
      // Qu = r u + B^T Vx
      {
        float R[D][D];
#pragma unroll
        for (int k = 0; k < D; ++k)
#pragma unroll
          for (int i = 0; i <= k; ++i)
            R[i][k] = __shfl_sync(kAll, r11[i], k, G);
        float inv11[D], wv[D], kk[D];
#pragma unroll
        for (int i = 0; i < D; ++i) inv11[i] = 1.f / R[i][i];
#pragma unroll
        for (int i = 0; i < D; ++i) {
          float acc = c.r * Us[i * lanes + ll] + c.half_dt2 * Vx[i] +
                      c.dt * Vx[i + D];
#pragma unroll
          for (int l2 = 0; l2 < i; ++l2) acc = acc - R[l2][i] * wv[l2];
          wv[i] = acc * inv11[i];
        }
#pragma unroll
        for (int i = D - 1; i >= 0; --i) {
          float acc = -wv[i];
#pragma unroll
          for (int l2 = i + 1; l2 < D; ++l2) acc = acc - R[i][l2] * kk[l2];
          kk[i] = acc * inv11[i];
        }
        const float vx_p = __shfl_sync(kAll, vx_own, partner, G);
        const float lx = ls[jc * lanes + ll];
        float vn = jc < D ? lx + vx_own : lx + c.dt * vx_p + vx_own;
        float k_own = 0.f;
#pragma unroll
        for (int i = 0; i < D; ++i) {
          float y = R[i][i] * kk[i];
#pragma unroll
          for (int l2 = i + 1; l2 < D; ++l2) y = y + R[i][l2] * kk[l2];
          vn = vn + r12[i] * y;
          k_own = jc == i ? kk[i] : k_own;
        }
        float Kc[D];
#pragma unroll
        for (int i = D - 1; i >= 0; --i) {
          float acc = -r12[i];
#pragma unroll
          for (int l2 = i + 1; l2 < D; ++l2) acc = acc - R[i][l2] * Kc[l2];
          Kc[i] = acc * inv11[i];
        }
        if (live && own) {
#pragma unroll
          for (int i = 0; i < D; ++i)
            Ks[((static_cast<size_t>(t) * D + i) * M + jc) * sB + lane] = Kc[i];
          if (jc < D) ks[(static_cast<size_t>(t) * D + jc) * sB + lane] = k_own;
        }
#pragma unroll
        for (int i = 0; i < M; ++i) Vx[i] = __shfl_sync(kAll, vn, i, G);
        vx_own = vn;
      }

      // phase 2: M reflections triangularize [S Phi; F_t] -> the next S.
      // Thread jc reflects its column of F_t in shared memory, kRows rows
      // a pass in 16-byte loads (the zero rows past P change nothing); the
      // pivot column's S rows come by shuffles.  One pass per pivot j
      // applies reflection j to each column and, from the pivot column j
      // and column j + 1 before it (read by the whole group, a
      // broadcast), forms column j + 1 after it and the sums pivot j + 1
      // needs, |F_j+1|^2 and F_j+1 . F_jc.  Column j + 1 is written to a
      // spare slot meanwhile (the others still read it), and its old slot
      // becomes the spare: pivot j's column lies in slot 0 (j = 0), M (j
      // = 1) or j - 1.  Rows below thread jc's own pivot keep its
      // reflection vector until the step ends.
      float* Fl = Fs + static_cast<size_t>(ll) * (M + 1) * PS;  // the lane's
      const int PR = f_rows(P);
      float f[4] = {0.f, 0.f, 0.f, 0.f}, sf[4] = {0.f, 0.f, 0.f, 0.f};
      for (int p = 0; p < PR; p += kRows) {  // pivot 0's sums
        float x[kRows], y[kRows];
        load_rows(x, Fl + p);
        load_rows(y, Fl + jc * PS + p);
#pragma unroll
        for (int u = 0; u < kRows; ++u) {
          f[u & 3] = fmaf(x[u], x[u], f[u & 3]);
          sf[u & 3] = fmaf(x[u], y[u], sf[u & 3]);
        }
      }
#pragma unroll 1
      for (int j = 0; j < M; ++j) {
        // the pivot column's rows j.. (its head and reflection vector),
        // and row j of this thread's column
        float vj[M], aj = 0.f;
#pragma unroll
        for (int i = 0; i < M; ++i) {
          const float v = __shfl_sync(kAll, a[i], j, G);
          vj[i] = i >= j ? v : 0.f;
          aj = i == j ? a[i] : aj;
        }
        const float head = __shfl_sync(kAll, aj, j, G);
        const float rest2 = dot_from<M>(vj, vj, j + 1) + sum4(f);
        const float norm = sqrtf(head * head + rest2);
        const float alpha = head >= 0.f ? -norm : norm;
        const float v0 = head - alpha;
        const float vtv = v0 * v0 + rest2;
        const float beta = 2.f / (vtv > 0.f ? vtv : 1.f);
        const float w = fmaf(v0, aj, dot_from<M>(vj, a, j + 1) + sum4(sf));
        // the reflection of thread jc's column (none for jc <= j): rows
        // from j on, the head's with v0; then the pivot's own alpha
        const float bw = jc > j && vtv > 0.f ? beta * w : 0.f;
#pragma unroll
        for (int i = 0; i < M; ++i) {
          a[i] = fmaf(-bw, i == j ? v0 : vj[i], a[i]);
          a[i] = jc == j && i == j ? alpha : a[i];
        }
        if (j + 1 < M) {
          const float nb = __shfl_sync(kAll, bw, j + 1, G);  // column j + 1's
          const float* X = Fl + (j == 0 ? 0 : j == 1 ? M : j - 1) * PS;
          const float* X1 = Fl + (j + 1) * PS;
          const float* Y = Fl + jc * PS;
          float* Yw = jc == j + 1 ? Fl + (j == 0 ? M : j) * PS : Fl + jc * PS;
          const bool store = own && jc > j;
#pragma unroll
          for (int u = 0; u < 4; ++u) f[u] = sf[u] = 0.f;
          for (int p = 0; p < PR; p += kRows) {
            float x[kRows], x1[kRows], y[kRows];
            load_rows(x, X + p);
            load_rows(x1, X1 + p);
            load_rows(y, Y + p);
#pragma unroll
            for (int u = 0; u < kRows; ++u) {
              x1[u] = fmaf(-nb, x[u], x1[u]);
              y[u] = fmaf(-bw, x[u], y[u]);
              f[u & 3] = fmaf(x1[u], x1[u], f[u & 3]);
              sf[u & 3] = fmaf(x1[u], y[u], sf[u & 3]);
            }
            if (store) store_rows(Yw + p, y);
          }
          __syncwarp();  // column j + 1 of F_t is reflected for the group
        }
      }
#pragma unroll
      for (int i = 0; i < M; ++i) a[i] = i > jc ? 0.f : a[i];
    }
    if (stages == 1) {
      __syncthreads();  // the one slot is free
      if (producer && n + 1 < T) stage(n + 1);
    }
  }
}

// threads per (lane, step size) in the rollout: the power of two >= D
__host__ __device__ constexpr int rollout_group(int D) {
  return D <= 1 ? 1 : D <= 2 ? 2 : D <= 4 ? 4 : 8;
}

// floats of one lane's step in a slot of the rollout's ring: Ks (D M), U
// (D), ks (D) and xs (M) rows
__host__ __device__ constexpr int rollout_rows(int D) {
  return 2 * D * D + 4 * D;
}

// a copy of n = 1, 2 or 4 floats into shared memory, both addresses
// aligned to 4 n bytes
__device__ __forceinline__ void cp_async_n(float* dst, const float* src,
                                           int n) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if (n == 4)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
                 "l"(src)
                 : "memory");
  else if (n == 2)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s),
                 "l"(src)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
                 "l"(src)
                 : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N committed groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

template <int D>
__global__ void __launch_bounds__(kMaxRolloutThreads)
rollout_kernel(const float* __restrict__ xs, const float* __restrict__ U,
               const float* __restrict__ ks, const float* __restrict__ Ks,
               const float* __restrict__ alphas, float* __restrict__ xs_out,
               float* __restrict__ U_out, int T, int B, int A, int lanes,
               float dt, float half_dt2) {
  constexpr int M = 2 * D, G = rollout_group(D), R = rollout_rows(D);
  constexpr unsigned kAll = 0xffffffffu;
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int grp = tid / G, j = tid % G;
  const int ai = grp / lanes, ll = grp - ai * lanes;  // step size, lane
  const int l0 = blockIdx.x * lanes;
  const int b = l0 + ll;
  const bool live = ai < A && b < B && j < D;         // writes its joint's
  const int jc = j < D ? j : D - 1;                   // the joint it reads
  const int lc = ll < lanes ? ll : 0;                 // the lane it reads
  const size_t sB = B;
  const int stage = R * lanes;                        // floats a slot
  // step t's rows for the block's lanes into slot t % kRollStages,
  // [row][lanes], one copy of `lanes` floats a row (B is a multiple of
  // lanes): Ks (t, i, col) at row i M + col, U at D M + i, ks at D M + D +
  // i, xs (t, i) at D M + 2 D + i.  One commit group a step, empty past the
  // last step.
  auto fetch = [&](int t) {
    float* st = smem + (t % kRollStages) * stage;
    for (int row = tid; t < T && row < R; row += nthr) {
      const float* src =
          row < D * M ? Ks + (static_cast<size_t>(t) * D * M + row) * sB
          : row < D * M + D ? U + (static_cast<size_t>(t) * D + row - D * M) * sB
          : row < D * M + 2 * D
              ? ks + (static_cast<size_t>(t) * D + row - D * M - D) * sB
              : xs + (static_cast<size_t>(t) * M + row - D * M - 2 * D) * sB;
      cp_async_n(st + row * lanes, src + l0, lanes);
    }
    cp_async_commit();
  };

  const float alpha = ai < A ? alphas[ai] : 0.f;
  float xa = 0.f, xb = 0.f;  // x[jc], x[jc + D]
  for (int t = 0; t < kRollStages - 1; ++t) fetch(t);
  for (int t = 0; t < T; ++t) {
    cp_async_wait<kRollStages - 2>();  // step t's group is in
    // step t staged for every thread, and every thread done with step t -
    // 1, whose slot the next fetch takes: one barrier a step
    __syncthreads();
    fetch(t + kRollStages - 1);
    const float* st = smem + (t % kRollStages) * stage;
    const float* xrow = st + (D * M + 2 * D) * lanes + lc;
    if (t == 0) {  // the rollout starts at xs[0]
      xa = xrow[jc * lanes];
      xb = xrow[(jc + D) * lanes];
    }
    const float dxa = xa - xrow[jc * lanes], dxb = xb - xrow[(jc + D) * lanes];
    float acc = st[(D * M + jc) * lanes + lc] +
                alpha * st[(D * M + D + jc) * lanes + lc];
    const float* krow = st + jc * M * lanes + lc;
#pragma unroll
    for (int col = 0; col < M; ++col) {
      const float dcol =
          __shfl_sync(kAll, col < D ? dxa : dxb, col < D ? col : col - D, G);
      acc = acc + krow[col * lanes] * dcol;
    }
    const float u = acc;
    const float q = xa + dt * xb + half_dt2 * u;
    const float v = xb + dt * u;
    xa = q;
    xb = v;
    if (live) {
      const size_t at = static_cast<size_t>(ai) * T + t;
      U_out[(at * D + j) * sB + b] = u;
      xs_out[(at * M + j) * sB + b] = xa;
      xs_out[(at * M + j + D) * sB + b] = xb;
    }
  }
}

// ---------------------------------------------------------------------
// the wide routes, 9 <= D <= 64 (any D >= 1 runs)
// ---------------------------------------------------------------------
constexpr int kWideMaxDof = 64;        // the wide routes' joints, at most
constexpr int kWideMaxCompute = 512;   // the wide sweep's compute threads

// a column stride of the wide sweep: rows rounded up to 4 floats, then to
// 4 past a multiple of 8, so that a quarter warp's 16-byte loads of one
// row of 8 consecutive columns fall in distinct banks
__host__ __device__ inline int wide_stride(int rows) {
  const int n = (rows + 3) / 4 * 4;
  return n % 8 == 0 ? n + 4 : n;
}

// floats a lane keeps across steps, a multiple of 4: S ([M] columns of
// wide_stride(M)), G = S B ([D] columns), R11 ([D][D]), R12 and then K
// ([D][M]), Vx (M), k, R11 k and 1 / R11[i][i] (D each);
// ops/riccati_kernel.py's _wide_lane_floats mirrors it
__host__ __device__ inline int wide_lane_floats(int D) {
  const int M = 2 * D;
  const int n = (M + D) * wide_stride(M) + D * D + D * M + M + 3 * D;
  return (n + 3) / 4 * 4;
}

// floats of one stage of the wide ring, a multiple of 4: F_t ([lanes][M]
// columns of wide_stride(f_rows(P))), U_t ([D][lanes]), l_t ([M][lanes]);
// ops/riccati_kernel.py's _wide_stage_floats mirrors it
__host__ __device__ inline size_t wide_stage_floats(int D, int P,
                                                    int lanes) {
  const size_t n = static_cast<size_t>(2 * D) * lanes * wide_stride(f_rows(P))
                   + static_cast<size_t>(3 * D) * lanes;
  return (n + 3) / 4 * 4;
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void st4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

// a lane group's barrier: its warp (G = 32), or named barrier `id` of its
// G threads (whole warps)
__device__ __forceinline__ void group_sync(int G, int id) {
  if (G == 32)
    __syncwarp();
  else
    asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(G) : "memory");
}

// The producer warp (thread k) stages step t's F_t, U_t and l_t for the
// block's lanes by 4-byte cp.async, each lane's column of F_t contiguous
// rows; the missing lanes and the rows past P are zeros.  Returns once
// its copies have landed.
__device__ __forceinline__ void wide_stage(const float* __restrict__ U,
                                           const float* __restrict__ l,
                                           const float* __restrict__ Fc,
                                           float* st, int t, int D, int P,
                                           int l0, int lanes, int B, int k) {
  const int M = 2 * D;
  const size_t sB = B;
  const int nv = B - l0 < lanes ? B - l0 : lanes;  // live lanes
  const int PR = f_rows(P), PS = wide_stride(PR);
  const float* Ft = Fc + static_cast<size_t>(t) * M * P * sB + l0;
  for (int sl = 0; sl < lanes; ++sl) {
    for (int c = 0; c < M; ++c) {
      float* dst = st + (static_cast<size_t>(sl) * M + c) * PS;
      const float* src = Ft + static_cast<size_t>(c) * P * sB + sl;
      for (int p = k; p < PR; p += kProducer) {
        if (p < P && sl < nv)
          cp_async_n(dst + p, src + p * sB, 1);
        else
          dst[p] = 0.f;
      }
    }
  }
  float* Us = st + static_cast<size_t>(M) * lanes * PS;
  for (int e = k; e < 3 * D * lanes; e += kProducer) {
    const int i = e / lanes, sl = e - i * lanes;
    const float* src = i < D ? U + (static_cast<size_t>(t) * D + i) * sB
                             : l + (static_cast<size_t>(t) * M + i - D) * sB;
    if (sl < nv)
      cp_async_n(Us + e, src + l0 + sl, 1);
    else
      Us[e] = 0.f;
  }
  cp_async_commit();
  cp_async_wait<0>();
}

__global__ void __launch_bounds__(kWideMaxCompute + kProducer)
riccati_wide_kernel(const float* __restrict__ U, const float* __restrict__ l,
                    const float* __restrict__ Fc,
                    const float* __restrict__ Vx0, float* __restrict__ ks,
                    float* __restrict__ Ks, int D, int P, int T, int B, int G,
                    int stages, SweepConsts c) {
  extern __shared__ __align__(16) float smem[];
  const int M = 2 * D, M4 = (M + 3) / 4 * 4;
  const int lanes = (blockDim.x - kProducer) / G;
  const int tid = threadIdx.x;
  const bool producer = tid >= lanes * G;  // the last warp
  const int ll = producer ? 0 : tid / G;   // the group's lane in the block
  const int jc = tid % G;                  // this thread's column
  const bool own = !producer && jc < M;    // idle threads write nothing
  const int bar = ll + 1;                  // the group's named barrier
  const int l0 = blockIdx.x * lanes;
  const int lane = l0 + ll;
  const bool live = !producer && lane < B;
  const size_t sB = B;
  const int ls = wide_stride(M), PR = f_rows(P), PS = wide_stride(PR);
  const int lf = wide_lane_floats(D);
  float* S = smem + static_cast<size_t>(ll) * lf;  // the lane's region
  float* Gm = S + M * ls;
  float* R11 = Gm + D * ls;
  float* R12 = R11 + D * D;
  float* Vx = R12 + D * M;
  float* kv = Vx + M;
  float* yv = kv + D;
  float* inv = yv + D;
  float* ring = smem + static_cast<size_t>(lanes) * lf;
  const size_t ssz = wide_stage_floats(D, P, lanes);
  const int pk = tid - lanes * G;  // the producer warp's thread
  // step n (t = T - 1 - n) into its slot: written out at each of the three
  // places (a lambda called from three places was not inlined: ptxas gave
  // the kernel a stack frame and spilled around the call)
#define TRT_WIDE_STAGE(n)                                                 \
  wide_stage(U, l, Fc, ring + ((n) % stages) * ssz, T - 1 - (n), D, P, l0, \
             lanes, B, pk)

  // S0 = sqrt(kg) I, the rows past M zero
  if (own) {
    for (int i = 0; i < ls; ++i) S[jc * ls + i] = i == jc ? c.sqrt_kg : 0.f;
    Vx[jc] = live ? Vx0[jc * sB + lane] : 0.f;
  }

  if (producer) TRT_WIDE_STAGE(0);
  for (int n = 0; n < T; ++n) {
    const int t = T - 1 - n;
    __syncthreads();  // step n staged; with two stages the other slot free
    if (producer) {
      if (stages == 2 && n + 1 < T) TRT_WIDE_STAGE(n + 1);
    } else {
      float* Fs = ring + (n % stages) * ssz;
      float* Fl = Fs + static_cast<size_t>(ll) * M * PS;  // the lane's F_t
      const float* Us = Fs + static_cast<size_t>(M) * lanes * PS;
      const float* lsv = Us + D * lanes;

      // G = S B and S Phi in place: thread jc >= D reads column jc - D
      // (which no thread writes here) and writes column jc - D of G and
      // column jc of S Phi
      if (own && jc >= D) {
        float* Sc = S + jc * ls;
        const float* Sp = S + (jc - D) * ls;
        float* Gc = Gm + (jc - D) * ls;
        for (int i = 0; i < M4; i += 4) {
          const float4 a = ld4(Sc + i), o = ld4(Sp + i);
          st4(Gc + i, make_float4(c.half_dt2 * o.x + c.dt * a.x,
                                  c.half_dt2 * o.y + c.dt * a.y,
                                  c.half_dt2 * o.z + c.dt * a.z,
                                  c.half_dt2 * o.w + c.dt * a.w));
          st4(Sc + i, make_float4(c.dt * o.x + a.x, c.dt * o.y + a.y,
                                  c.dt * o.z + a.z, c.dt * o.w + a.w));
        }
      }
      group_sync(G, bar);

      // phase 1: D reflections over the u columns -> R11 and R12
      for (int j = 0; j < D; ++j) {
        if (own) {
          const float* g = Gm + j * ls;
          const bool ucol = jc < D && jc > j;
          float* Sc = S + jc * ls;
          float* Gc = Gm + (ucol ? jc : j) * ls;
          float sg[4] = {0.f, 0.f, 0.f, 0.f}, sx[4] = {0.f, 0.f, 0.f, 0.f},
                su[4] = {0.f, 0.f, 0.f, 0.f};
          for (int i = 0; i < M4; i += 4) {
            const float4 gv = ld4(g + i), xv = ld4(Sc + i), uv = ld4(Gc + i);
            sg[0] = fmaf(gv.x, gv.x, sg[0]);
            sg[1] = fmaf(gv.y, gv.y, sg[1]);
            sg[2] = fmaf(gv.z, gv.z, sg[2]);
            sg[3] = fmaf(gv.w, gv.w, sg[3]);
            sx[0] = fmaf(gv.x, xv.x, sx[0]);
            sx[1] = fmaf(gv.y, xv.y, sx[1]);
            sx[2] = fmaf(gv.z, xv.z, sx[2]);
            sx[3] = fmaf(gv.w, xv.w, sx[3]);
            su[0] = fmaf(gv.x, uv.x, su[0]);
            su[1] = fmaf(gv.y, uv.y, su[1]);
            su[2] = fmaf(gv.z, uv.z, su[2]);
            su[3] = fmaf(gv.w, uv.w, su[3]);
          }
          const float gg = sum4(sg);
          const float alpha = -sqrtf(c.ru2 + gg);
          const float v0 = c.sqrt_ru - alpha;  // > 0 always
          const float beta = 2.f / (v0 * v0 + gg);
          const float wx = sum4(sx), wu = sum4(su);
          R12[j * M + jc] = -(beta * v0) * wx;
          if (ucol) R11[j * D + jc] = -(beta * v0) * wu;
          if (jc == j) R11[j * D + j] = alpha;
          const float bx = beta * wx, bu = beta * wu;
          for (int i = 0; i < M4; i += 4) {
            const float4 gv = ld4(g + i), xv = ld4(Sc + i);
            st4(Sc + i, make_float4(fmaf(-bx, gv.x, xv.x),
                                    fmaf(-bx, gv.y, xv.y),
                                    fmaf(-bx, gv.z, xv.z),
                                    fmaf(-bx, gv.w, xv.w)));
            if (ucol) {
              const float4 uv = ld4(Gc + i);
              st4(Gc + i, make_float4(fmaf(-bu, gv.x, uv.x),
                                      fmaf(-bu, gv.y, uv.y),
                                      fmaf(-bu, gv.z, uv.z),
                                      fmaf(-bu, gv.w, uv.w)));
            }
          }
        }
        group_sync(G, bar);  // column j + 1 of G is reflected
      }

      // gains: thread 0 forms 1 / R11[i][i], w = R11^-T Qu (in yv),
      // k = -R11^-1 w and y = R11 k (Qu = r u + B^T Vx); every thread
      // Qx[jc] = l + Phi^T Vx; then column jc of K = -R11^-1 R12 in place
      // of R12's and Vx'[jc] = Qx[jc] + R12[:, jc]^T y
      if (own && jc == 0) {
        for (int i = 0; i < D; ++i) inv[i] = 1.f / R11[i * D + i];
        for (int i = 0; i < D; ++i) {
          float acc = c.r * Us[i * lanes + ll] + c.half_dt2 * Vx[i] +
                      c.dt * Vx[i + D];
          for (int l2 = 0; l2 < i; ++l2) acc = acc - R11[l2 * D + i] * yv[l2];
          yv[i] = acc * inv[i];
        }
        for (int i = D - 1; i >= 0; --i) {
          float acc = -yv[i];
          for (int l2 = i + 1; l2 < D; ++l2)
            acc = acc - R11[i * D + l2] * kv[l2];
          kv[i] = acc * inv[i];
        }
        for (int i = 0; i < D; ++i) {
          float y = R11[i * D + i] * kv[i];
          for (int l2 = i + 1; l2 < D; ++l2) y = y + R11[i * D + l2] * kv[l2];
          yv[i] = y;
        }
      }
      float qx = 0.f;
      if (own) {
        const float lx = lsv[jc * lanes + ll];
        qx = jc < D ? lx + Vx[jc] : lx + c.dt * Vx[jc - D] + Vx[jc];
      }
      group_sync(G, bar);  // k, y and 1 / R11[i][i]; Vx read
      if (own) {
        float vn = qx;
        for (int i = 0; i < D; ++i) vn = vn + R12[i * M + jc] * yv[i];
        for (int i = D - 1; i >= 0; --i) {
          float acc = -R12[i * M + jc];
          for (int l2 = i + 1; l2 < D; ++l2)
            acc = acc - R11[i * D + l2] * R12[l2 * M + jc];
          R12[i * M + jc] = acc * inv[i];
        }
        if (live) {
          for (int i = 0; i < D; ++i)
            Ks[((static_cast<size_t>(t) * D + i) * M + jc) * sB + lane] =
                R12[i * M + jc];
          if (jc < D) ks[(static_cast<size_t>(t) * D + jc) * sB + lane] = kv[jc];
        }
        Vx[jc] = vn;
      }

      // phase 2: M reflections triangularize [S Phi; F_t] -> the next S.
      // Pivot j: every thread forms |column j below its head|^2 and its
      // own column's dot with it (S rows past j, then F rows), then
      // reflects its own column (jc > j).  Column j keeps its reflection
      // vector until the step ends; its owner keeps the pivot's alpha.
      float diag = 0.f;
      for (int j = 0; j < M; ++j) {
        if (own && jc >= j) {  // columns left of the pivot are done
          const bool act = jc > j;
          const float* X = S + j * ls;
          const float* XF = Fl + j * PS;
          float* Y = S + (act ? jc : j) * ls;
          float* YF = Fl + (act ? jc : j) * PS;
          const float head = X[j];
          float fs[4] = {0.f, 0.f, 0.f, 0.f}, ss[4] = {0.f, 0.f, 0.f, 0.f};
          float ff[4] = {0.f, 0.f, 0.f, 0.f}, sf[4] = {0.f, 0.f, 0.f, 0.f};
          const int i0 = j & ~3;
          for (int i = i0; i < M4; i += 4) {
            const float4 xv = ld4(X + i), yv4 = ld4(Y + i);
            const float x[4] = {xv.x, xv.y, xv.z, xv.w};
            const float y[4] = {yv4.x, yv4.y, yv4.z, yv4.w};
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const float xe = i + e > j ? x[e] : 0.f;
              fs[e] = fmaf(xe, xe, fs[e]);
              ss[e] = fmaf(xe, y[e], ss[e]);
            }
          }
          for (int p = 0; p < PR; p += kRows) {
            float x[kRows], y[kRows];
            load_rows(x, XF + p);
            load_rows(y, YF + p);
#pragma unroll
            for (int u = 0; u < kRows; ++u) {
              ff[u & 3] = fmaf(x[u], x[u], ff[u & 3]);
              sf[u & 3] = fmaf(x[u], y[u], sf[u & 3]);
            }
          }
          const float rest2 = sum4(fs) + sum4(ff);
          const float norm = sqrtf(head * head + rest2);
          const float alpha = head >= 0.f ? -norm : norm;
          const float v0 = head - alpha;
          const float vtv = v0 * v0 + rest2;
          const float beta = 2.f / (vtv > 0.f ? vtv : 1.f);
          if (jc == j) diag = alpha;
          if (act) {
            const float w = fmaf(v0, Y[j], sum4(ss) + sum4(sf));
            const float bw = vtv > 0.f ? beta * w : 0.f;
            // rows from j on: the head's with v0, the rest with column j
            for (int i = i0; i < M4; i += 4) {
              const float4 xv = ld4(X + i), yv4 = ld4(Y + i);
              float x[4] = {xv.x, xv.y, xv.z, xv.w};
              float y[4] = {yv4.x, yv4.y, yv4.z, yv4.w};
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                const float xe = i + e == j ? v0 : x[e];
                y[e] = i + e >= j ? fmaf(-bw, xe, y[e]) : y[e];
              }
              st4(Y + i, make_float4(y[0], y[1], y[2], y[3]));
            }
            for (int p = 0; p < PR; p += kRows) {
              float x[kRows], y[kRows];
              load_rows(x, XF + p);
              load_rows(y, YF + p);
#pragma unroll
              for (int u = 0; u < kRows; ++u) y[u] = fmaf(-bw, x[u], y[u]);
              store_rows(YF + p, y);
            }
          }
        }
        group_sync(G, bar);  // column j + 1 is reflected for the group
      }
      // the next S: column jc's diagonal, zeros below it
      if (own) {
        S[jc * ls + jc] = diag;
        for (int i = jc + 1; i < ls; ++i) S[jc * ls + i] = 0.f;
      }
    }
    if (stages == 1) {
      __syncthreads();  // the one slot is free
      if (producer && n + 1 < T) TRT_WIDE_STAGE(n + 1);
    }
  }
#undef TRT_WIDE_STAGE
}

// wait until at most n (0..kRollStages - 2) committed groups are in flight
__device__ __forceinline__ void cp_async_wait_upto(int n) {
  switch (n) {
    case 0: cp_async_wait<0>(); break;
    case 1: cp_async_wait<1>(); break;
    case 2: cp_async_wait<2>(); break;
    case 3: cp_async_wait<3>(); break;
    case 4: cp_async_wait<4>(); break;
    case 5: cp_async_wait<5>(); break;
    default: cp_async_wait<6>(); break;
  }
}

__global__ void __launch_bounds__(kMaxRolloutThreads)
rollout_wide_kernel(const float* __restrict__ xs, const float* __restrict__ U,
                    const float* __restrict__ ks,
                    const float* __restrict__ Ks,
                    const float* __restrict__ alphas,
                    float* __restrict__ xs_out, float* __restrict__ U_out,
                    int T, int B, int A, int D, int G, int lanes, int stages,
                    float dt, float half_dt2) {
  extern __shared__ __align__(16) float smem[];
  const int M = 2 * D, R = rollout_rows(D);
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int grp = tid / G, j = tid % G;
  const int ai = grp / lanes, ll = grp - ai * lanes;  // step size, lane
  const int l0 = blockIdx.x * lanes;
  const int b = l0 + ll;
  const bool run = ai < A;                            // a (lane, alpha)
  const bool live = run && b < B && j < D;            // writes its joint's
  const int jc = j < D ? j : D - 1;                   // the joint it reads
  const int lc = ll < lanes ? ll : 0;                 // the lane it reads
  const size_t sB = B;
  const int stage = R * lanes;                        // floats a slot
  // the group's dx (M floats) after the ring
  float* dxs = smem + static_cast<size_t>(stages) * stage + (run ? grp : 0) * M;
  // step t's rows into slot t % stages, as rollout_kernel's fetch
  auto fetch = [&](int t) {
    float* st = smem + (t % stages) * stage;
    for (int row = tid; t < T && row < R; row += nthr) {
      const float* src =
          row < D * M ? Ks + (static_cast<size_t>(t) * D * M + row) * sB
          : row < D * M + D ? U + (static_cast<size_t>(t) * D + row - D * M) * sB
          : row < D * M + 2 * D
              ? ks + (static_cast<size_t>(t) * D + row - D * M - D) * sB
              : xs + (static_cast<size_t>(t) * M + row - D * M - 2 * D) * sB;
      cp_async_n(st + row * lanes, src + l0, lanes);
    }
    cp_async_commit();
  };

  const float alpha = run ? alphas[ai] : 0.f;
  float xa = 0.f, xb = 0.f;  // x[jc], x[jc + D]
  for (int t = 0; t < stages - 1; ++t) fetch(t);
  for (int t = 0; t < T; ++t) {
    cp_async_wait_upto(stages - 2);  // step t's group is in
    // step t staged for every thread, every thread done with step t - 1
    // (its slot and the dx it read)
    __syncthreads();
    fetch(t + stages - 1);
    const float* st = smem + (t % stages) * stage;
    const float* xrow = st + (D * M + 2 * D) * lanes + lc;
    if (t == 0) {  // the rollout starts at xs[0]
      xa = xrow[jc * lanes];
      xb = xrow[(jc + D) * lanes];
    }
    if (run && j < D) {
      dxs[j] = xa - xrow[j * lanes];
      dxs[j + D] = xb - xrow[(j + D) * lanes];
    }
    __syncthreads();  // the group's dx
    float acc = st[(D * M + jc) * lanes + lc] +
                alpha * st[(D * M + D + jc) * lanes + lc];
    const float* krow = st + jc * M * lanes + lc;
    for (int col = 0; col < M; ++col) acc = acc + krow[col * lanes] * dxs[col];
    const float u = acc;
    const float q = xa + dt * xb + half_dt2 * u;
    const float v = xb + dt * u;
    xa = q;
    xb = v;
    if (live) {
      const size_t at = static_cast<size_t>(ai) * T + t;
      U_out[(at * D + j) * sB + b] = u;
      xs_out[(at * M + j) * sB + b] = xa;
      xs_out[(at * M + j + D) * sB + b] = xb;
    }
  }
}

cudaError_t launch_sweep_wide(const float* U, const float* l, const float* Fc,
                              const float* Vx0, float* ks, float* Ks, int P,
                              int T, int B, int D, int G, int lanes,
                              int stages, SweepConsts c,
                              cudaStream_t stream) {
  // whole warps a group (named barriers 1 .. lanes past G = 32)
  if (D < 1 || D > kWideMaxDof || (G != 32 && G != 64 && G != 128) ||
      G < 2 * D || lanes < 1 || lanes * G > kWideMaxCompute || stages < 1 ||
      stages > kMaxStages || P < 0)
    return cudaErrorInvalidValue;
  const size_t smem =
      (static_cast<size_t>(lanes) * wide_lane_floats(D) +
       stages * wide_stage_floats(D, P, lanes)) * sizeof(float);
  if (smem > static_cast<size_t>(kMaxSmem)) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        riccati_wide_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const int blocks = (B + lanes - 1) / lanes;
  riccati_wide_kernel<<<blocks, lanes * G + kProducer, smem, stream>>>(
      U, l, Fc, Vx0, ks, Ks, D, P, T, B, G, stages, c);
  return cudaGetLastError();
}

cudaError_t launch_rollout_wide(const float* xs, const float* U,
                                const float* ks, const float* Ks,
                                const float* alphas, float* xs_out,
                                float* U_out, int T, int B, int A, int D,
                                int G, int lanes, int stages, float dt,
                                float half_dt2, cudaStream_t stream) {
  const int threads = (lanes * A * G + 31) / 32 * 32;
  if (D < 1 || D > kWideMaxDof || G < D || (G & (G - 1)) != 0 ||
      (lanes != 1 && lanes != 2 && lanes != 4) || B % lanes != 0 || A < 1 ||
      threads > kMaxRolloutThreads || stages < 2 || stages > kRollStages)
    return cudaErrorInvalidValue;
  const size_t smem = (static_cast<size_t>(stages) * rollout_rows(D) * lanes
                       + static_cast<size_t>(lanes) * A * 2 * D) * sizeof(float);
  if (smem > static_cast<size_t>(kMaxSmem)) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        rollout_wide_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  rollout_wide_kernel<<<(B + lanes - 1) / lanes, threads, smem, stream>>>(
      xs, U, ks, Ks, alphas, xs_out, U_out, T, B, A, D, G, lanes, stages, dt,
      half_dt2);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_sweep(const float* U, const float* l, const float* Fc,
                         const float* Vx0, float* ks, float* Ks, int P, int T,
                         int B, int lanes, int stages, SweepConsts c,
                         cudaStream_t stream) {
  constexpr int G = group_size(2 * D);
  // whole warps: the sweep's shuffles and __syncwarp take the full mask
  if (lanes < 1 || lanes * G > kMaxCompute || lanes * G % 32 != 0 ||
      stages < 1 || stages > kMaxStages || P < 0)
    return cudaErrorInvalidValue;
  const size_t smem = stages * stage_floats(D, P, lanes) * sizeof(float);
  if (smem > static_cast<size_t>(kMaxSmem)) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        riccati_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const int blocks = (B + lanes - 1) / lanes;
  riccati_kernel<D><<<blocks, lanes * G + kProducer, smem, stream>>>(
      U, l, Fc, Vx0, ks, Ks, P, T, B, stages, c);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_rollout(const float* xs, const float* U, const float* ks,
                           const float* Ks, const float* alphas, float* xs_out,
                           float* U_out, int T, int B, int A, int lanes,
                           float dt, float half_dt2, cudaStream_t stream) {
  constexpr int G = rollout_group(D);
  // whole warps: the shuffles take the full mask
  const int threads = (lanes * A * G + 31) / 32 * 32;
  if ((lanes != 1 && lanes != 2 && lanes != 4) || B % lanes != 0 || A < 1 ||
      threads > kMaxRolloutThreads)
    return cudaErrorInvalidValue;
  const size_t smem = static_cast<size_t>(kRollStages) * rollout_rows(D) *
                      lanes * sizeof(float);
  if (smem > static_cast<size_t>(kMaxSmem)) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        rollout_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  rollout_kernel<D><<<(B + lanes - 1) / lanes, threads, smem, stream>>>(
      xs, U, ks, Ks, alphas, xs_out, U_out, T, B, A, lanes, dt, half_dt2);
  return cudaGetLastError();
}

}  // namespace

// The sweep, `lanes` lanes per block and a ring of `stages` (1 or 2) steps
// in shared memory; returns a CUDA error code (cudaErrorInvalidValue for D
// outside 1..8, a block that is not whole warps of at most 128 threads, or
// more shared memory than a block can use).  ru2 = sqrt_ru^2 = r + mu.
extern "C" int trt_riccati_launch(const float* U, const float* l,
                                  const float* Fc, const float* Vx0,
                                  float* ks, float* Ks, int P, int T, int B,
                                  int D, int lanes, int stages, float dt,
                                  float half_dt2, float r, float ru2,
                                  float sqrt_ru, float sqrt_kg,
                                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const SweepConsts c{dt, half_dt2, r, ru2, sqrt_ru, sqrt_kg};
#define TRT_SWEEP(d) \
  launch_sweep<d>(U, l, Fc, Vx0, ks, Ks, P, T, B, lanes, stages, c, s)
  switch (D) {
    case 1: return TRT_SWEEP(1);
    case 2: return TRT_SWEEP(2);
    case 3: return TRT_SWEEP(3);
    case 4: return TRT_SWEEP(4);
    case 5: return TRT_SWEEP(5);
    case 6: return TRT_SWEEP(6);
    case 7: return TRT_SWEEP(7);
    case 8: return TRT_SWEEP(8);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef TRT_SWEEP
}

// The wide sweep (D <= 64): groups of G = 32, 64 or 128 threads (G >= 2 D),
// `lanes` lanes a block (lanes G <= 512) and a ring of `stages` (1 or 2);
// returns a CUDA error code (cudaErrorInvalidValue past those limits or
// the shared memory a block can use).  Any G and lanes give a lane the
// same bits.
extern "C" int trt_riccati_wide_launch(const float* U, const float* l,
                                       const float* Fc, const float* Vx0,
                                       float* ks, float* Ks, int P, int T,
                                       int B, int D, int G, int lanes,
                                       int stages, float dt, float half_dt2,
                                       float r, float ru2, float sqrt_ru,
                                       float sqrt_kg, void* stream) {
  const SweepConsts c{dt, half_dt2, r, ru2, sqrt_ru, sqrt_kg};
  return launch_sweep_wide(U, l, Fc, Vx0, ks, Ks, P, T, B, D, G, lanes,
                           stages, c, static_cast<cudaStream_t>(stream));
}

// The wide rollout (D <= 64): groups of G threads (a power of two >= D) a
// (lane, step size), `lanes` (1, 2 or 4, dividing B) lanes a block with
// all A step sizes, a ring of `stages` (2..8) steps; every input 4
// lanes-byte aligned; returns a CUDA error code.  Any G, lanes and stages
// give a lane the same bits.
extern "C" int trt_rollout_wide_launch(const float* xs, const float* U,
                                       const float* ks, const float* Ks,
                                       const float* alphas, float* xs_out,
                                       float* U_out, int T, int B, int A,
                                       int D, int G, int lanes, int stages,
                                       float dt, float half_dt2,
                                       void* stream) {
  return launch_rollout_wide(xs, U, ks, Ks, alphas, xs_out, U_out, T, B, A,
                             D, G, lanes, stages, dt, half_dt2,
                             static_cast<cudaStream_t>(stream));
}

// The rollout of A step sizes, `lanes` lanes (each with all A step sizes) a
// block; every input 4 lanes-byte aligned; returns a CUDA error code
// (cudaErrorInvalidValue for D outside 1..8, lanes not 1, 2 or 4 or not
// dividing B, or a block past 1024 threads or the shared memory a block
// can use).
extern "C" int trt_rollout_launch(const float* xs, const float* U,
                                  const float* ks, const float* Ks,
                                  const float* alphas, float* xs_out,
                                  float* U_out, int T, int B, int A, int D,
                                  int lanes, float dt, float half_dt2,
                                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define TRT_ROLLOUT(d)                                                    \
  case d:                                                                 \
    return launch_rollout<d>(xs, U, ks, Ks, alphas, xs_out, U_out, T, B, A, \
                             lanes, dt, half_dt2, s);
  switch (D) {
    TRT_ROLLOUT(1) TRT_ROLLOUT(2) TRT_ROLLOUT(3) TRT_ROLLOUT(4)
    TRT_ROLLOUT(5) TRT_ROLLOUT(6) TRT_ROLLOUT(7) TRT_ROLLOUT(8)
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef TRT_ROLLOUT
}
