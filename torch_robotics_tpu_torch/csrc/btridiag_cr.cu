// Batched block-tridiagonal SPD solve by block cyclic reduction, batch in
// the minor (lane) axis.
//
// Replaces the TPU kernel torch_robotics_tpu/ops/pallas_btridiag.py
// solve_lanes_pallas_bcr (body _kernel_bcr).  Its plain PyTorch version is
// solve_lanes_bcr in torch_robotics_tpu_torch/solve/btridiag_bcr.py, whose
// head comment gives the elimination identities.
//
// D (H, M, M, B), U (H, M, M) shared over the batch (U_k couples block k to
// k+1; the last block unused), b (H, M, B) -> x (H2, M, B), H2 the power of
// two at or above H.  Blocks past H are identity blocks with b = 0, and the
// coupling out of block H-1 is zero: level 0 reads them so, and nothing is
// padded in memory.
//
// Design: one launch per stage, one thread per (block, lane), lanes minor so
// a warp's accesses to one block entry are 32 consecutive floats.  Level l
// (n = H2 >> l blocks) runs two launches:
//   odd:  thread (k, lane) factors D_{2k+1} (Cholesky in registers) and
//         solves it for the 2M+1 right-hand sides [U_{2k}^T | U_{2k+1} |
//         b_{2k+1}] one column at a time (a column is M floats; holding all
//         of them would spill at M = 14), writing A_k, C_k, beta_k;
//   even: thread (k, lane) forms the next level's block k from block 2k:
//         D' = D_{2k} - U_{2k-1}^T C_{k-1} - U_{2k} A_k (lower triangle, all
//         the next Cholesky reads), b', and U' = -U_{2k} C_k (zero for the
//         last block); after level 0 the coupling is per lane.
// Then one thread per lane solves the root block, and one launch per level,
// coarsest first, back-substitutes x_{2k+1} = beta_k - A_k x_{2k} - C_k
// x_{2k+2}.  Every block of every level keeps the index it has in the
// padded system (block k of level l is block k << l), so A, C, beta and x
// live in (H2, ...) arrays, and the next level's D, U, b overwrite the even
// blocks' slots in (H2 / 2, ...) work arrays (the thread that writes a slot
// is the only one that reads it).
//
// What bounds it on the H100: the levels' dependent chains, as in the
// sweeps, but over log2(H2) levels instead of H steps, with H2 / 2 x B
// threads at the first level (32 x 1024 at the main path's shape, against
// one thread per lane in the sweeps).  It moves more bytes than the sweeps:
// A, C and beta, ~H (2 M^2 + M) B floats, are written and read back, ~106
// MB at (64, 14, 1024); the even update reads its A and C columns through
// the L1 and L2 caches.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 128;

__device__ __forceinline__ size_t mat_idx(size_t blk, int i, int j, int M,
                                          size_t sB, int lane) {
  return ((blk * M + i) * M + j) * sB + lane;
}

__device__ __forceinline__ size_t vec_idx(size_t blk, int i, int M,
                                          size_t sB, int lane) {
  return (blk * M + i) * sB + lane;
}

// One level's system: block k lives at slot k << shift of D, U, b.  Level 0
// reads the caller's arrays (blocks at or past `real` are identity blocks
// with b = 0); later levels read the work arrays, where every block is real.
// SharedU (level 0 only) reads U shared over the batch, with couplings at or
// past real - 1 zero; after level 0 U is per lane and its last coupling is
// stored zero.
struct Level {
  const float* D;
  const float* U;
  const float* b;
  int shift;
  int real;
};

template <int M>
__device__ __forceinline__ float level_d(const Level& v, int blk, int i,
                                         int j, size_t sB, int lane) {
  if (blk >= v.real) return i == j ? 1.f : 0.f;
  return v.D[mat_idx(static_cast<size_t>(blk) << v.shift, i, j, M, sB, lane)];
}

template <int M, bool SharedU>
__device__ __forceinline__ float level_u(const Level& v, int blk, int i,
                                         int j, size_t sB, int lane) {
  if constexpr (SharedU) {
    if (blk >= v.real - 1) return 0.f;
    return __ldg(v.U + (static_cast<size_t>(blk) * M + i) * M + j);
  }
  return v.U[mat_idx(static_cast<size_t>(blk) << v.shift, i, j, M, sB, lane)];
}

template <int M>
__device__ __forceinline__ float level_b(const Level& v, int blk, int i,
                                         size_t sB, int lane) {
  if (blk >= v.real) return 0.f;
  return v.b[vec_idx(static_cast<size_t>(blk) << v.shift, i, M, sB, lane)];
}

// Cholesky of block blk (lower triangle in L, row-sequential).
template <int M>
__device__ __forceinline__ void chol_block(const Level& v, int blk,
                                           float (&L)[M][M], size_t sB,
                                           int lane) {
#pragma unroll
  for (int i = 0; i < M; ++i) {
#pragma unroll
    for (int j = 0; j <= i; ++j) {
      float s = level_d<M>(v, blk, i, j, sB, lane);
#pragma unroll
      for (int t = 0; t < j; ++t) s -= L[i][t] * L[j][t];
      L[i][j] = (i == j) ? sqrtf(s) : s / L[j][j];
    }
  }
}

// r <- L^-T L^-1 r
template <int M>
__device__ __forceinline__ void chol_solve(const float (&L)[M][M],
                                           float (&r)[M]) {
#pragma unroll
  for (int i = 0; i < M; ++i) {
    float s = r[i];
#pragma unroll
    for (int t = 0; t < i; ++t) s -= L[i][t] * r[t];
    r[i] = s / L[i][i];
  }
#pragma unroll
  for (int i = M - 1; i >= 0; --i) {
    float s = r[i];
#pragma unroll
    for (int t = i + 1; t < M; ++t) s -= L[t][i] * r[t];
    r[i] = s / L[i][i];
  }
}

// Level l's odd blocks: [A_k | C_k | beta_k] = D_{2k+1}^-1 [U_{2k}^T |
// U_{2k+1} | b_{2k+1}], stored at block (2k + 1) << l.
template <int M, bool SharedU>
__global__ void __launch_bounds__(kThreads)
cr_odd_kernel(Level v, int l, int half, float* __restrict__ Af,
              float* __restrict__ Cf, float* __restrict__ beta, int B) {
  const size_t idx = static_cast<size_t>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
  if (idx >= static_cast<size_t>(half) * B) return;
  const int k = static_cast<int>(idx / B), lane = static_cast<int>(idx % B);
  const size_t sB = B;
  const int o = 2 * k + 1, e = 2 * k;
  const size_t out = static_cast<size_t>(o) << l;
  float L[M][M];
  chol_block<M>(v, o, L, sB, lane);
  for (int c = 0; c < 2 * M + 1; ++c) {
    float r[M];
#pragma unroll
    for (int p = 0; p < M; ++p)
      r[p] = c < M ? level_u<M, SharedU>(v, e, c, p, sB, lane)
           : c < 2 * M ? level_u<M, SharedU>(v, o, p, c - M, sB, lane)
                       : level_b<M>(v, o, p, sB, lane);
    chol_solve<M>(L, r);
#pragma unroll
    for (int p = 0; p < M; ++p) {
      if (c < M) Af[mat_idx(out, p, c, M, sB, lane)] = r[p];
      else if (c < 2 * M) Cf[mat_idx(out, p, c - M, M, sB, lane)] = r[p];
      else beta[vec_idx(out, p, M, sB, lane)] = r[p];
    }
  }
}

// Level l's even blocks -> level l + 1's block k (at slot k << l of the
// work arrays): D', b' and U'.
template <int M, bool SharedU>
__global__ void __launch_bounds__(kThreads)
cr_even_kernel(Level v, int l, int half, const float* __restrict__ Af,
               const float* __restrict__ Cf, const float* __restrict__ beta,
               float* Dn, float* Un, float* bn, int B) {
  const size_t idx = static_cast<size_t>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
  if (idx >= static_cast<size_t>(half) * B) return;
  const int k = static_cast<int>(idx / B), lane = static_cast<int>(idx % B);
  const size_t sB = B;
  const int e = 2 * k;
  const size_t me = static_cast<size_t>(2 * k + 1) << l;       // A_k, C_k
  const size_t prev = static_cast<size_t>(2 * k - 1) << l;     // C_{k-1}
  const size_t slot = static_cast<size_t>(k) << l;
  // b' = b_e - U_{e-1}^T beta_{k-1} - U_e beta_k
  float bv[M];
#pragma unroll
  for (int i = 0; i < M; ++i) {
    float s = level_b<M>(v, e, i, sB, lane);
    if (k > 0) {
      float t = 0.f;
#pragma unroll
      for (int p = 0; p < M; ++p)
        t += level_u<M, SharedU>(v, e - 1, p, i, sB, lane) *
             beta[vec_idx(prev, p, M, sB, lane)];
      s -= t;
    }
    float t = 0.f;
#pragma unroll
    for (int p = 0; p < M; ++p)
      t += level_u<M, SharedU>(v, e, i, p, sB, lane) *
           beta[vec_idx(me, p, M, sB, lane)];
    bv[i] = s - t;
  }
  // D' = D_e - U_{e-1}^T C_{k-1} - U_e A_k, lower triangle, row by row
#pragma unroll 1
  for (int i = 0; i < M; ++i) {
    float ue[M], uo[M];
#pragma unroll
    for (int p = 0; p < M; ++p) {
      ue[p] = level_u<M, SharedU>(v, e, i, p, sB, lane);
      uo[p] = k > 0 ? level_u<M, SharedU>(v, e - 1, p, i, sB, lane) : 0.f;
    }
#pragma unroll 1
    for (int j = 0; j <= i; ++j) {
      float s = level_d<M>(v, e, i, j, sB, lane);
      if (k > 0) {
        float t = 0.f;
#pragma unroll
        for (int p = 0; p < M; ++p)
          t += uo[p] * Cf[mat_idx(prev, p, j, M, sB, lane)];
        s -= t;
      }
      float t = 0.f;
#pragma unroll
      for (int p = 0; p < M; ++p)
        t += ue[p] * Af[mat_idx(me, p, j, M, sB, lane)];
      Dn[mat_idx(slot, i, j, M, sB, lane)] = s - t;
    }
  }
#pragma unroll
  for (int i = 0; i < M; ++i) bn[vec_idx(slot, i, M, sB, lane)] = bv[i];
  // U' = -U_e C_k, row by row (row i of U_e is read before it is
  // overwritten in the same slot); zero for the last block
  const bool last = k == half - 1;
#pragma unroll 1
  for (int i = 0; i < M; ++i) {
    float ue[M];
#pragma unroll
    for (int p = 0; p < M; ++p)
      ue[p] = last ? 0.f : level_u<M, SharedU>(v, e, i, p, sB, lane);
#pragma unroll 1
    for (int j = 0; j < M; ++j) {
      float t = 0.f;
      if (!last) {
#pragma unroll
        for (int p = 0; p < M; ++p)
          t += ue[p] * Cf[mat_idx(me, p, j, M, sB, lane)];
      }
      Un[mat_idx(slot, i, j, M, sB, lane)] = -t;
    }
  }
}

// The root: x_0 = D_root^-1 b_root.
template <int M>
__global__ void __launch_bounds__(kThreads)
cr_root_kernel(Level v, float* __restrict__ x, int B) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= B) return;
  const size_t sB = B;
  float L[M][M], r[M];
  chol_block<M>(v, 0, L, sB, lane);
#pragma unroll
  for (int p = 0; p < M; ++p) r[p] = level_b<M>(v, 0, p, sB, lane);
  chol_solve<M>(L, r);
#pragma unroll
  for (int p = 0; p < M; ++p) x[vec_idx(0, p, M, sB, lane)] = r[p];
}

// Level l's back-substitution: x_{2k+1} = beta_k - A_k x_{2k} - C_k x_{2k+2}
// (x_{2k+2} = 0 past the last block), at padded-system indices.
template <int M>
__global__ void __launch_bounds__(kThreads)
cr_back_kernel(int l, int half, const float* __restrict__ Af,
               const float* __restrict__ Cf, const float* __restrict__ beta,
               float* __restrict__ x, int B) {
  const size_t idx = static_cast<size_t>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
  if (idx >= static_cast<size_t>(half) * B) return;
  const int k = static_cast<int>(idx / B), lane = static_cast<int>(idx % B);
  const size_t sB = B;
  const size_t me = static_cast<size_t>(2 * k + 1) << l;
  const size_t xe = static_cast<size_t>(2 * k) << l;
  const size_t xn = static_cast<size_t>(2 * k + 2) << l;
  const bool has_next = k + 1 < half;
  float a[M], c[M];
#pragma unroll
  for (int p = 0; p < M; ++p) {
    a[p] = x[vec_idx(xe, p, M, sB, lane)];
    c[p] = has_next ? x[vec_idx(xn, p, M, sB, lane)] : 0.f;
  }
#pragma unroll
  for (int i = 0; i < M; ++i) {
    float s = beta[vec_idx(me, i, M, sB, lane)];
    float t = 0.f;
#pragma unroll
    for (int p = 0; p < M; ++p) t += Af[mat_idx(me, i, p, M, sB, lane)] * a[p];
    s -= t;
    t = 0.f;
#pragma unroll
    for (int p = 0; p < M; ++p) t += Cf[mat_idx(me, i, p, M, sB, lane)] * c[p];
    x[vec_idx(me, i, M, sB, lane)] = s - t;
  }
}

inline unsigned grid_for(size_t threads) {
  return static_cast<unsigned>((threads + kThreads - 1) / kThreads);
}

template <int M>
cudaError_t launch(const float* D, const float* U, const float* b, float* x,
                   float* Af, float* Cf, float* beta, float* Dw, float* Uw,
                   float* bw, int H, int H2, int B, cudaStream_t stream) {
  Level v{D, U, b, 0, H};
  int l = 0;
  for (int n = H2; n > 1; n /= 2, ++l) {
    const int half = n / 2;
    const unsigned grid = grid_for(static_cast<size_t>(half) * B);
    if (l == 0) {
      cr_odd_kernel<M, true><<<grid, kThreads, 0, stream>>>(v, l, half, Af,
                                                            Cf, beta, B);
      cr_even_kernel<M, true><<<grid, kThreads, 0, stream>>>(
          v, l, half, Af, Cf, beta, Dw, Uw, bw, B);
    } else {
      cr_odd_kernel<M, false><<<grid, kThreads, 0, stream>>>(v, l, half, Af,
                                                             Cf, beta, B);
      cr_even_kernel<M, false><<<grid, kThreads, 0, stream>>>(
          v, l, half, Af, Cf, beta, Dw, Uw, bw, B);
    }
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return e;
    v = Level{Dw, Uw, bw, l, half};
  }
  cr_root_kernel<M><<<grid_for(B), kThreads, 0, stream>>>(v, x, B);
  for (--l; l >= 0; --l) {
    const int half = (H2 >> l) / 2;
    cr_back_kernel<M><<<grid_for(static_cast<size_t>(half) * B), kThreads, 0,
                        stream>>>(l, half, Af, Cf, beta, x, B);
  }
  return cudaGetLastError();
}

}  // namespace

// D (H, M, M, B), U (H, M, M), b (H, M, B) -> x (H2, M, B), H2 the power of
// two at or above H; A, C (H2, M, M, B), beta (H2, M, B) and the work
// arrays Dw, Uw (max(H2 / 2, 1), M, M, B), bw (max(H2 / 2, 1), M, B) are
// device scratch.  Returns a CUDA error code (cudaErrorInvalidValue for M
// outside {2, 4, ..., 16} or H2 not the power of two at or above H).
extern "C" int trt_btridiag_cr_launch(const float* D, const float* U,
                                      const float* b, float* x, float* Af,
                                      float* Cf, float* beta, float* Dw,
                                      float* Uw, float* bw, int H, int H2,
                                      int M, int B, void* stream) {
  if (H < 1 || H2 < H || (H2 & (H2 - 1)) != 0 || (H2 > 1 && H2 / 2 >= H))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define TRT_CR(m) launch<m>(D, U, b, x, Af, Cf, beta, Dw, Uw, bw, H, H2, B, s)
  switch (M) {
    case 2: return TRT_CR(2);
    case 4: return TRT_CR(4);
    case 6: return TRT_CR(6);
    case 8: return TRT_CR(8);
    case 10: return TRT_CR(10);
    case 12: return TRT_CR(12);
    case 14: return TRT_CR(14);
    case 16: return TRT_CR(16);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef TRT_CR
}
