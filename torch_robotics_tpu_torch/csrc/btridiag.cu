// Batched block-tridiagonal SPD solve, batch in the minor (lane) axis.
//
// Replaces three TPU kernels of torch_robotics_tpu/ops/pallas_btridiag.py:
//   btridiag_w_kernel<M, false>  solve_lanes_pallas_w (the _kernel_factor
//                                sweep with the _bwd_subst_loop backward
//                                pass; L, W and y in scratch);
//   btridiag_w_kernel<M, true>   solve_lanes_pallas_factor: the same sweep
//                                with L and W as the caller's outputs, L's
//                                strict upper triangle written zero;
//   btridiag_subst_kernel<M>     solve_lanes_pallas_subst (_kernel_subst):
//                                a fresh b against persisted L and W.
// Their plain PyTorch versions are solve_lanes_core,
// solve_lanes_factor_core and solve_lanes_subst_core in
// torch_robotics_tpu_torch/solve/btridiag_lanes.py.
//
// D (H, M, M, B), U (H, M, M) shared over the batch (the last block unused),
// b (H, M, B) -> x (H, M, B):
//   forward over k:  A = D_k - S;  L = chol(A);  y_k = L^-1 (b_k - Wy);
//                    W_k = L^-1 U_k;  S = W_k^T W_k;  Wy = W_k^T y_k
//   backward:        x_{H-1} = L^-T y_{H-1};  x_k = L^-T (y_k - W_k x_{k+1})
//
// What bounds the sweep on the H100: latency, not bytes or operations.  At
// (H, M, B) = (64, 14, 1024) the bytes it must move (D, U, b in, x out:
// 58.8 MB, 17.5 us at 3.35 TB/s) and its operations (0.52 GFLOP, 7.7 us at
// 67 TFLOP/s) are far below its time: each lane is a chain of H dependent
// block steps, each step a chain of M pivots (a square root and a
// broadcast each).  One thread per lane (the design before this one) ran
// that chain alone, 32 warps on 132 SMs with 2 M^2 floats of state spilled
// past 255 registers: 4.1 ms on an H100 80GB HBM3 at 700 W.  This design
// takes 0.23 ms there; its time does not change from B = 8 to B = 1024
// (one lane's chain sets it), and with B = 1024 lanes of 16 threads there
// is about one warp per scheduler, so each warp's dependent instructions
// (shuffles, loads, multiply-adds) are what remains.
//
// Design of btridiag_w_kernel: a group of G threads per lane (G the power of
// two >= M: 16 for M = 10..16, 8 for 6..8, 4, 2), `lanes` groups per block
// (at most 128 threads, whole warps; the host picks `lanes`,
// sweep_launch_config in ops/btridiag_kernel.py).  Thread j of a group
// owns column j of the step's blocks: S (between steps), A and then L
// (within one), U_k and then W_k; the right-hand side and y_k are held by
// every thread of the group.  A step is one right-looking elimination over
// the M pivots of [A | U_k | b]: pivot p's column is broadcast by
// __shfl_sync inside the group and every thread scales its row p and
// updates the rows below, with no branches (sqrtf and the reciprocal
// correctly rounded, then multiplications).  A stays exactly symmetric
// (thread j's A[p][j] is thread p's A[j][p] bit for bit), so thread j
// reads L[j][p] from its own column.
// S = W^T W and Wy = W^T y exchange the rows of W_k through shared memory,
// read back as float4s.  Registers hold ~4 M floats a thread: nothing
// spills.
//
// Loads are asynchronous: a ring of kStages steps in shared memory, filled
// by cp.async, so that the steps after k are in flight while step k
// computes.  In the forward pass a stage holds D_k (lower triangle), b_k
// and U_k for the block's lanes (entry (i, j) of `lanes` consecutive lanes
// is `lanes` contiguous floats); in the backward pass it holds L_k, W_k and
// y_k.
//
// What the backward pass reads (option (a): L and W through device
// memory).  The forward pass writes L's lower triangle, W_k and y (H (M (M
// + 1) / 2 + M^2 + M) B floats: 82.6 MB at (64, 14, 1024)); the backward
// pass stages whole L blocks, W_k and y back through the ring (106.4 MB);
// together ~56 us at 3.35 TB/s, hidden behind the steps' arithmetic.  The
// non-factor sweep keeps them in the layout (H, B, M, M), where a block's
// lanes are one contiguous run (16-byte copies); the factor sweep writes
// its outputs in the caller's (H, M, M, B).  Keeping L in shared memory
// instead (option (b)) would hold 27 KB a lane at H = 64: at most 8 lanes
// an SM, fewer than B = 1024 lanes need in one wave on 132 SMs.  In the
// backward pass thread i holds row i of W_k, column i of L_k and y_k[i];
// x_{k+1} is broadcast by shuffles and L_k^-T is a column-oriented back
// substitution (one shuffle a pivot).
//
// A ragged batch: the last block's missing lanes are staged as zeros, run
// every instruction (so shuffles and __syncwarp take the full mask) and
// write nothing.  Indefinite pivots give NaN, as in the reference.  Each
// lane's arithmetic is the same wherever it sits in the batch and whatever
// `lanes` is, so a ragged B gives each lane its full-batch bits.
//
// The substitution kernel does ~3 M^2 multiply-adds per block step against
// the sweep's ~1.7 M^3 and keeps only y and Wy (2 M floats) in registers;
// it reads L and W (2 M^2 floats per step and lane) once in each pass, so
// it is bound by those loads' latency at the few warps a batch of lanes
// gives, not by the card's byte rate.  One thread per lane, with the
// per-thread backward pass below.
#include <cuda_runtime.h>
#include <math.h>

#include "btridiag_sweep.cuh"

namespace {

using namespace trt;

constexpr int kThreads = 64;         // the substitution kernel's block
constexpr int kSweepThreads = 128;   // the sweep's largest block

constexpr int kStages = 5;           // the sweep's ring of staged steps

// threads per lane in the sweep: the power of two >= M (M <= 16)
__host__ __device__ constexpr int group_size(int M) {
  return M <= 2 ? 2 : M <= 4 ? 4 : M <= 8 ? 8 : 16;
}

// a row of W_k in shared memory: M rounded up to whole float4s
__host__ __device__ constexpr int w_row(int M) { return (M + 3) / 4 * 4; }

// one lane's W_k in shared memory, padded so that neighbouring lanes'
// float4 reads fall in other banks
__host__ __device__ constexpr int w_lane(int M) { return M * w_row(M) + 4; }

// floats of one stage of the sweep's ring: a forward step's D_k (rows of
// lanes + 1, padded against bank conflicts), b_k and U_k, or a backward
// step's L_k, W_k and y_k, whichever is larger
__host__ __device__ constexpr int stage_floats(int M, int lanes) {
  return M * M * (lanes + 1) + M * lanes + M * M > (2 * M * M + M) * lanes
             ? M * M * (lanes + 1) + M * lanes + M * M
             : (2 * M * M + M) * lanes;
}

// dynamic shared memory of the sweep, in floats (ops/btridiag_kernel.py's
// sweep_launch_config mirrors it): the W_k rows and Wy of each lane, and
// the ring of kStages stages
__host__ __device__ constexpr size_t sweep_smem_floats(int M, int lanes) {
  return static_cast<size_t>(lanes) * (w_lane(M) + M)
         + static_cast<size_t>(kStages) * stage_floats(M, lanes);
}

// backward substitution from the persisted L, W, y stacks:
//   x_{H-1} = L^-T y_{H-1};  x_k = L_k^-T (y_k - W_k x_{k+1})
template <int M>
__device__ __forceinline__ void backward_pass(const float* __restrict__ Ls,
                                              const float* __restrict__ Ws,
                                              const float* __restrict__ ys,
                                              float* __restrict__ x, int H,
                                              size_t sB, int lane) {
  float xn[M];
  for (int k = H - 1; k >= 0; --k) {
    float rhs[M];
#pragma unroll
    for (int i = 0; i < M; ++i) {
      float s = ys[vec_idx(k, i, M, sB, lane)];
      if (k < H - 1) {
#pragma unroll
        for (int j = 0; j < M; ++j)
          s -= Ws[mat_idx(k, i, j, M, sB, lane)] * xn[j];
      }
      rhs[i] = s;
    }
    float xk[M];
#pragma unroll
    for (int i = M - 1; i >= 0; --i) {
      float s = rhs[i];
#pragma unroll
      for (int t = i + 1; t < M; ++t)
        s -= Ls[mat_idx(k, t, i, M, sB, lane)] * xk[t];
      xk[i] = s / Ls[mat_idx(k, i, i, M, sB, lane)];
    }
#pragma unroll
    for (int i = 0; i < M; ++i) {
      x[vec_idx(k, i, M, sB, lane)] = xk[i];
      xn[i] = xk[i];
    }
  }
}

// ---------------------------------------------------------------------------
// the cooperative sweep

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

// 16 bytes, bypassing L1: both addresses 16-byte aligned
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most kStages - 2 committed groups are still in flight
__device__ __forceinline__ void cp_async_wait_staged() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 2) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// entry (i, j) of block k of an (H, M, M) stack of lane `lane`: the
// caller's (H, M, M, B) layout for the factor outputs, (H, B, M, M) for
// the sweep's own scratch
template <bool kFactorOut>
__device__ __forceinline__ size_t blk_idx(int k, int i, int j, int M,
                                          size_t sB, int lane) {
  return kFactorOut ? mat_idx(k, i, j, M, sB, lane)
                    : ((static_cast<size_t>(k) * sB + lane) * M + i) * M + j;
}

// y_k[i] of lane `lane` in the sweep's (H, B, M) scratch
__device__ __forceinline__ size_t y_idx(int k, int i, int M, size_t sB,
                                        int lane) {
  return (static_cast<size_t>(k) * sB + lane) * M + i;
}

// Stage forward step k's D_k (lower triangle), b_k and U_k for the block's
// lanes: thread t copies lane t % lanes, entries t / lanes + G n, so a
// warp's copies of one entry are consecutive lanes.
template <int M>
__device__ __forceinline__ void stage_forward(
    const float* __restrict__ D, const float* __restrict__ U,
    const float* __restrict__ b, float* st, int k, int l0, int lanes,
    int B) {
  constexpr int G = group_size(M);
  float* Dsm = st;
  float* bsm = Dsm + M * M * (lanes + 1);
  float* Usm = bsm + M * lanes;
  const int tid = threadIdx.x;
  const int sl = tid % lanes, e0 = tid / lanes;
  const int l = l0 + sl;
  const bool valid = l < B;
  const size_t sB = B;
  const float* Dk = D + static_cast<size_t>(k) * M * M * sB + (valid ? l : 0);
  const float* bk = b + static_cast<size_t>(k) * M * sB + (valid ? l : 0);
#pragma unroll
  for (int n = 0; n < (M * M + G - 1) / G; ++n) {
    const int e = e0 + n * G, i = e / M;
    if (e < M * M && e - i * M <= i)
      cp_async4(Dsm + e * (lanes + 1) + sl, Dk + e * sB, valid);
  }
#pragma unroll
  for (int n = 0; n < (M + G - 1) / G; ++n) {
    const int i = e0 + n * G;
    if (i < M) cp_async4(bsm + i * lanes + sl, bk + i * sB, valid);
  }
  for (int f = tid; f < M * M; f += blockDim.x)
    cp_async4(Usm + f, U + static_cast<size_t>(k) * M * M + f, true);
}

// Stage backward step k's L_k, W_k ([lanes][M][M]) and y_k ([lanes][M]) for
// the block's lanes.  The sweep's own (H, B, M, M) stacks hold the block's
// lanes contiguously; the factor outputs (H, M, M, B) hold entry (i, j) of
// consecutive lanes contiguously.
template <int M, bool kFactorOut>
__device__ __forceinline__ void stage_backward(
    const float* __restrict__ Ls, const float* __restrict__ Ws,
    const float* __restrict__ ys, float* st, int k, int l0, int lanes,
    int B) {
  float* Lst = st;
  float* Wst = Lst + lanes * M * M;
  float* yst = Wst + lanes * M * M;
  const int tid = threadIdx.x;
  const size_t sB = B;
  const int n_valid = B - l0 < lanes ? B - l0 : lanes;
  if constexpr (kFactorOut) {
    const int sl = tid % lanes;
    const bool valid = sl < n_valid;
    const size_t l = l0 + (valid ? sl : 0);
    for (int e = tid / lanes; e < M * M; e += blockDim.x / lanes) {
      const size_t src = (static_cast<size_t>(k) * M * M + e) * sB + l;
      cp_async4(Lst + sl * M * M + e, Ls + src, valid);
      cp_async4(Wst + sl * M * M + e, Ws + src, valid);
    }
  } else {
    // whole float4s: a lane's block is M^2 floats, M even
    const size_t base = (static_cast<size_t>(k) * sB + l0) * M * M;
    for (int f = 4 * tid; f < lanes * M * M; f += 4 * blockDim.x) {
      const bool valid = f < n_valid * M * M;
      cp_async16(Lst + f, Ls + base + (valid ? f : 0), valid);
      cp_async16(Wst + f, Ws + base + (valid ? f : 0), valid);
    }
  }
  const size_t ybase = (static_cast<size_t>(k) * sB + l0) * M;
  for (int f = tid; f < lanes * M; f += blockDim.x) {
    const bool valid = f < n_valid * M;
    cp_async4(yst + f, ys + ybase + (valid ? f : 0), valid);
  }
}

template <int M, bool kFactorOut>
__global__ void __launch_bounds__(kSweepThreads)
btridiag_w_kernel(const float* __restrict__ D, const float* __restrict__ U,
                  const float* __restrict__ b, float* __restrict__ x,
                  float* __restrict__ Ls, float* __restrict__ Ws,
                  float* __restrict__ ys, int H, int B) {
  constexpr int G = group_size(M);
  constexpr int WR = w_row(M);
  // every thread of a warp runs every instruction of the sweep (missing
  // lanes and idle threads included), so shuffles take the full mask
  constexpr unsigned kAll = 0xffffffffu;
  extern __shared__ float smem[];
  const int lanes = blockDim.x / G;
  const int tid = threadIdx.x;
  const int ll = tid / G;                // the group's lane in the block
  const int j = tid % G;                 // this thread's column
  const int jc = j < M ? j : M - 1;      // idle threads shadow column M - 1
  const int l0 = blockIdx.x * lanes;
  const int lane = l0 + ll;
  const bool live = lane < B;
  const size_t sB = B;

  float* Wl = smem + ll * w_lane(M);     // [lanes][M][WR] (+ 4): W_k[t][c]
  float* Wysm = smem + lanes * w_lane(M);   // [M][lanes]
  float* ring = Wysm + M * lanes;        // [kStages][stage_floats]
  const int ssz = stage_floats(M, lanes);

  float a[M];  // S's column jc between steps; A's, then L's, within one
  float u[M];  // U_k's column jc, then W_k's
  float r[M];  // b_k - Wy, then y_k (the same in every thread of the group)
#pragma unroll
  for (int i = 0; i < M; ++i) a[i] = 0.f;
  if (j < M) Wysm[j * lanes + ll] = 0.f;

  // a ring of kStages staged steps: step k + kStages - 1 is in flight
  // while step k computes (one commit per step, empty past the last)
#pragma unroll
  for (int k = 0; k < kStages - 1; ++k) {
    if (k < H)
      stage_forward<M>(D, U, b, ring + k * ssz, k, l0, lanes, B);
    cp_async_commit();
  }
  for (int k = 0; k < H; ++k) {
    cp_async_wait_staged();
    __syncthreads();  // step k staged; step k - 1's stage and Wy are free
    {
      const int kn = k + kStages - 1;
      if (kn < H)
        stage_forward<M>(D, U, b, ring + (kn % kStages) * ssz, kn, l0,
                         lanes, B);
      cp_async_commit();
    }

    const float* Dk = ring + (k % kStages) * ssz;
    const float* bk = Dk + M * M * (lanes + 1);
    const float* Uk = bk + M * lanes;
#pragma unroll
    for (int i = 0; i < M; ++i) {
      const int e = i >= jc ? i * M + jc : jc * M + i;   // the lower triangle
      a[i] = Dk[e * (lanes + 1) + ll] - a[i];
      u[i] = Uk[i * M + jc];
      r[i] = bk[i * lanes + ll] - Wysm[i * lanes + ll];
    }

    // right-looking elimination of [A | U_k | b_k - Wy] over the pivots,
    // without branches: every thread runs the same instructions.  Thread
    // jc's column stays unscaled from its own pivot on (it is scaled by
    // 1 / L[jc][jc] after the loop, as each pivot's receivers scale it)
    float inv_own = 0.f, lpp_own = 0.f;
#pragma unroll
    for (int p = 0; p < M; ++p) {
      // L[p][p] and its reciprocal correctly rounded: rsqrtf, even with a
      // Newton step, costs the GN systems a factor ~2 of accuracy
      const float lpp = sqrtf(__shfl_sync(kAll, a[p], p, G));
      const float inv = 1.f / lpp;
      float l[M];
#pragma unroll
      for (int i = p + 1; i < M; ++i)
        l[i] = __shfl_sync(kAll, a[i], p, G) * inv;
      u[p] *= inv;
      r[p] *= inv;
#pragma unroll
      for (int i = p + 1; i < M; ++i) {
        u[i] = fmaf(-l[i], u[p], u[i]);
        r[i] = fmaf(-l[i], r[p], r[i]);
      }
      const float lj = jc > p ? a[p] * inv : 0.f;        // L[jc][p] or 0
#pragma unroll
      for (int i = p + 1; i < M; ++i) a[i] = fmaf(-l[i], lj, a[i]);
      inv_own = jc == p ? inv : inv_own;
      lpp_own = jc == p ? lpp : lpp_own;
    }
#pragma unroll
    for (int i = 0; i < M; ++i)                          // L[i][jc], i >= jc
      a[i] = i == jc ? lpp_own : a[i] * inv_own;

    if (live && j < M) {
#pragma unroll
      for (int i = 0; i < M; ++i) {
        if (i >= j)
          Ls[blk_idx<kFactorOut>(k, i, j, M, sB, lane)] = a[i];
        else if (kFactorOut)
          Ls[blk_idx<kFactorOut>(k, i, j, M, sB, lane)] = 0.f;
        Ws[blk_idx<kFactorOut>(k, i, j, M, sB, lane)] = u[i];
      }
      if (j == 0) {
#pragma unroll
        for (int i = 0; i < M; ++i) ys[y_idx(k, i, M, sB, lane)] = r[i];
      }
    }

    // S = W_k^T W_k (column jc, full: it stays exactly symmetric) and
    // Wy = W_k^T y_k, the rows of W_k exchanged in shared memory and read
    // back four entries at a time (entries past M are never used)
    if (j < M) {
#pragma unroll
      for (int t = 0; t < M; ++t) Wl[t * WR + j] = u[t];
    }
    __syncwarp();
    {
      float s[WR];
#pragma unroll
      for (int i = 0; i < WR; ++i) s[i] = 0.f;
#pragma unroll
      for (int t = 0; t < M; ++t) {
#pragma unroll
        for (int q = 0; q < WR / 4; ++q) {
          const float4 w = *reinterpret_cast<const float4*>(Wl + t * WR
                                                            + 4 * q);
          s[4 * q] = fmaf(w.x, u[t], s[4 * q]);
          s[4 * q + 1] = fmaf(w.y, u[t], s[4 * q + 1]);
          s[4 * q + 2] = fmaf(w.z, u[t], s[4 * q + 2]);
          s[4 * q + 3] = fmaf(w.w, u[t], s[4 * q + 3]);
        }
      }
#pragma unroll
      for (int i = 0; i < M; ++i) a[i] = s[i];
    }
    float wy = 0.f;
#pragma unroll
    for (int t = 0; t < M; ++t) wy = fmaf(u[t], r[t], wy);
    if (j < M) Wysm[j * lanes + ll] = wy;
  }
  cp_async_wait_all();
  __syncthreads();  // the stacks written above are visible to the block

  // backward, through the same ring: thread j reads row j of W_k, column j
  // of L_k and y_k[j] of its lane, and holds x_k[j]
#pragma unroll
  for (int n = 0; n < kStages - 1; ++n) {
    if (n < H)
      stage_backward<M, kFactorOut>(Ls, Ws, ys, ring + n * ssz, H - 1 - n,
                                    l0, lanes, B);
    cp_async_commit();
  }
  float xj = 0.f;  // x_{k+1}[j]
  for (int n = 0; n < H; ++n) {
    const int k = H - 1 - n;
    cp_async_wait_staged();
    __syncthreads();  // step k staged; the last step's stage is free
    {
      const int nn = n + kStages - 1;
      if (nn < H)
        stage_backward<M, kFactorOut>(Ls, Ws, ys,
                                      ring + (nn % kStages) * ssz, H - 1 - nn,
                                      l0, lanes, B);
      cp_async_commit();
    }
    const float* Lk = ring + (n % kStages) * ssz + ll * M * M;
    const float* Wk = Lk + lanes * M * M;
    const float* yk = ring + (n % kStages) * ssz + 2 * lanes * M * M;
    float rj = yk[ll * M + jc];
    if (n > 0) {
#pragma unroll
      for (int c = 0; c < M; ++c)
        rj = fmaf(-Wk[jc * M + c], __shfl_sync(kAll, xj, c, G), rj);
    }
    const float inv = 1.f / Lk[jc * M + jc];
#pragma unroll
    for (int p = M - 1; p >= 0; --p) {
      const float xp = __shfl_sync(kAll, rj * inv, p, G);
      rj = jc < p ? fmaf(-Lk[p * M + jc], xp, rj) : rj;
      xj = jc == p ? xp : xj;
    }
    if (live && j < M) x[vec_idx(k, j, M, sB, lane)] = xj;
  }
}

template <int M>
__global__ void __launch_bounds__(kThreads)
btridiag_subst_kernel(const float* __restrict__ Ls,
                      const float* __restrict__ Ws,
                      const float* __restrict__ b, float* __restrict__ x,
                      float* __restrict__ ys, int H, int B) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= B) return;
  const size_t sB = B;
  float Wy[M];
#pragma unroll
  for (int i = 0; i < M; ++i) Wy[i] = 0.f;
  for (int k = 0; k < H; ++k) {
    // y_k = L_k^-1 (b_k - Wy), then Wy = W_k^T y_k
    float y[M];
#pragma unroll
    for (int i = 0; i < M; ++i) {
      float s = b[vec_idx(k, i, M, sB, lane)] - Wy[i];
#pragma unroll
      for (int t = 0; t < i; ++t)
        s -= Ls[mat_idx(k, i, t, M, sB, lane)] * y[t];
      y[i] = s / Ls[mat_idx(k, i, i, M, sB, lane)];
      ys[vec_idx(k, i, M, sB, lane)] = y[i];
    }
#pragma unroll
    for (int i = 0; i < M; ++i) {
      float s = Ws[mat_idx(k, 0, i, M, sB, lane)] * y[0];
#pragma unroll
      for (int t = 1; t < M; ++t)
        s += Ws[mat_idx(k, t, i, M, sB, lane)] * y[t];
      Wy[i] = s;
    }
  }
  backward_pass<M>(Ls, Ws, ys, x, H, sB, lane);
}

template <int M, bool kFactorOut>
cudaError_t launch(const float* D, const float* U, const float* b, float* x,
                   float* Ls, float* Ws, float* ys, int H, int B, int lanes,
                   cudaStream_t stream) {
  constexpr int G = group_size(M);
  // whole warps: the sweep's shuffles and __syncwarp take the full mask
  if (lanes < 1 || lanes * G > kSweepThreads || lanes * G % 32 != 0)
    return cudaErrorInvalidValue;
  const size_t smem = sweep_smem_floats(M, lanes) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        btridiag_w_kernel<M, kFactorOut>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const int blocks = (B + lanes - 1) / lanes;
  btridiag_w_kernel<M, kFactorOut><<<blocks, lanes * G, smem, stream>>>(
      D, U, b, x, Ls, Ws, ys, H, B);
  return cudaGetLastError();
}

template <int M>
cudaError_t launch_subst(const float* Ls, const float* Ws, const float* b,
                         float* x, float* ys, int H, int B,
                         cudaStream_t stream) {
  const int blocks = (B + kThreads - 1) / kThreads;
  btridiag_subst_kernel<M><<<blocks, kThreads, 0, stream>>>(Ls, Ws, b, x, ys,
                                                            H, B);
  return cudaGetLastError();
}

}  // namespace

// one case per instantiated M: CALL(m) returns the launch's error code
#define TRT_M_CASES(CALL)                                  \
  case 2: return CALL(2);                                  \
  case 4: return CALL(4);                                  \
  case 6: return CALL(6);                                  \
  case 8: return CALL(8);                                  \
  case 10: return CALL(10);                                \
  case 12: return CALL(12);                                \
  case 14: return CALL(14);                                \
  case 16: return CALL(16);                                \
  default: return static_cast<int>(cudaErrorInvalidValue);

// D (H, M, M, B), U (H, M, M), b (H, M, B) -> x (H, M, B), with L, W
// (H M^2 B floats each) and y (H M B) as device scratch, `lanes` lanes per
// block; returns a CUDA error code (cudaErrorInvalidValue for M outside
// {2, 4, ..., 16} or a block of more than 128 threads).
extern "C" int trt_btridiag_w_launch(const float* D, const float* U,
                                     const float* b, float* x, float* Ls,
                                     float* Ws, float* ys, int H, int M,
                                     int B, int lanes, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define TRT_W(m) launch<m, false>(D, U, b, x, Ls, Ws, ys, H, B, lanes, s)
  switch (M) { TRT_M_CASES(TRT_W) }
#undef TRT_W
}

// The same sweep with L, W (H, M, M, B) as outputs (L's strict upper
// triangle zero) and y (H M B floats) as device scratch.
extern "C" int trt_btridiag_factor_launch(const float* D, const float* U,
                                          const float* b, float* x,
                                          float* Ls, float* Ws, float* ys,
                                          int H, int M, int B, int lanes,
                                          void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define TRT_F(m) launch<m, true>(D, U, b, x, Ls, Ws, ys, H, B, lanes, s)
  switch (M) { TRT_M_CASES(TRT_F) }
#undef TRT_F
}

// L, W (H, M, M, B) from the factor sweep, a fresh b (H, M, B) -> x
// (H, M, B), with y (H, M, B) as device scratch.
extern "C" int trt_btridiag_subst_launch(const float* Ls, const float* Ws,
                                         const float* b, float* x, float* ys,
                                         int H, int M, int B, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define TRT_S(m) launch_subst<m>(Ls, Ws, b, x, ys, H, B, s)
  switch (M) { TRT_M_CASES(TRT_S) }
#undef TRT_S
}
