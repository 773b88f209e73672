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
// The rollout keeps one thread per lane and step size (it moves ~15 MB at
// the path's shapes and is a short chain of mat-vecs per step).
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 64;       // the rollout's block
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

template <int D>
__global__ void __launch_bounds__(kThreads)
rollout_kernel(const float* __restrict__ xs, const float* __restrict__ U,
               const float* __restrict__ ks, const float* __restrict__ Ks,
               const float* __restrict__ alphas, float* __restrict__ xs_out,
               float* __restrict__ U_out, int T, int B, float dt,
               float half_dt2) {
  constexpr int M = 2 * D;
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  const int a = blockIdx.y;
  if (b >= B) return;
  const size_t sB = B;
  const float alpha = alphas[a];
  float x[M];
#pragma unroll
  for (int i = 0; i < M; ++i) x[i] = xs[i * sB + b];
  for (int t = 0; t < T; ++t) {
    float dx[M];
#pragma unroll
    for (int i = 0; i < M; ++i) dx[i] = x[i] - xs[((size_t)t * M + i) * sB + b];
    float u[D];
#pragma unroll
    for (int j = 0; j < D; ++j) {
      const size_t tj = (size_t)t * D + j;
      float acc = U[tj * sB + b] + alpha * ks[tj * sB + b];
#pragma unroll
      for (int col = 0; col < M; ++col)
        acc = acc + Ks[(tj * M + col) * sB + b] * dx[col];
      u[j] = acc;
      U_out[(((size_t)a * T + t) * D + j) * sB + b] = acc;
    }
#pragma unroll
    for (int i = 0; i < D; ++i) {
      const float q = x[i] + dt * x[i + D] + half_dt2 * u[i];
      const float v = x[i + D] + dt * u[i];
      x[i] = q;
      x[i + D] = v;
    }
#pragma unroll
    for (int i = 0; i < M; ++i)
      xs_out[(((size_t)a * T + t) * M + i) * sB + b] = x[i];
  }
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
                           float* U_out, int T, int B, int A, float dt,
                           float half_dt2, cudaStream_t stream) {
  const dim3 grid((B + kThreads - 1) / kThreads, A);
  rollout_kernel<D><<<grid, kThreads, 0, stream>>>(
      xs, U, ks, Ks, alphas, xs_out, U_out, T, B, dt, half_dt2);
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

// The rollout of A step sizes; returns a CUDA error code
// (cudaErrorInvalidValue for D outside 1..8).
extern "C" int trt_rollout_launch(const float* xs, const float* U,
                                  const float* ks, const float* Ks,
                                  const float* alphas, float* xs_out,
                                  float* U_out, int T, int B, int A, int D,
                                  float dt, float half_dt2, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 1: return launch_rollout<1>(xs, U, ks, Ks, alphas, xs_out, U_out, T, B, A,
                                     dt, half_dt2, s);
    case 2: return launch_rollout<2>(xs, U, ks, Ks, alphas, xs_out, U_out, T, B, A,
                                     dt, half_dt2, s);
    case 3: return launch_rollout<3>(xs, U, ks, Ks, alphas, xs_out, U_out, T, B, A,
                                     dt, half_dt2, s);
    case 4: return launch_rollout<4>(xs, U, ks, Ks, alphas, xs_out, U_out, T, B, A,
                                     dt, half_dt2, s);
    case 5: return launch_rollout<5>(xs, U, ks, Ks, alphas, xs_out, U_out, T, B, A,
                                     dt, half_dt2, s);
    case 6: return launch_rollout<6>(xs, U, ks, Ks, alphas, xs_out, U_out, T, B, A,
                                     dt, half_dt2, s);
    case 7: return launch_rollout<7>(xs, U, ks, Ks, alphas, xs_out, U_out, T, B, A,
                                     dt, half_dt2, s);
    case 8: return launch_rollout<8>(xs, U, ks, Ks, alphas, xs_out, U_out, T, B, A,
                                     dt, half_dt2, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
