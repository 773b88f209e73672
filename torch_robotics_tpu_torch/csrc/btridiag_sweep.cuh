// Device functions shared by the block-tridiagonal sweep kernels of
// btridiag.cu (the W-persisting and factor sweeps) and btridiag_sweep.cu
// (the sweep that keeps L and y only): the batch-minor indexing and one
// forward block step.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace trt {

__device__ __forceinline__ size_t mat_idx(int k, int i, int j, int M,
                                          size_t sB, int lane) {
  return ((static_cast<size_t>(k) * M + i) * M + j) * sB + lane;
}

__device__ __forceinline__ size_t vec_idx(int k, int i, int M, size_t sB,
                                          int lane) {
  return (static_cast<size_t>(k) * M + i) * sB + lane;
}

// One forward block step k of the sweep, for one lane:
//   A = D_k - S;  L = chol(A) (in A's lower triangle);  y_k = L^-1 (b_k - Wy);
//   W_k = L^-1 U_k;  S = W_k^T W_k (into A's lower triangle);  Wy = W_k^T y_k.
// A holds S on entry and on exit; L (lower) and y_k go to Ls and ys, W_k to
// Ws when kStoreW, and L's strict upper triangle is written zero when
// kZeroUpper (an output whose whole block is read).  U is shared over the
// batch: a broadcast load.
template <int M, bool kStoreW, bool kZeroUpper>
__device__ __forceinline__ void sweep_step(
    const float* __restrict__ D, const float* __restrict__ U,
    const float* __restrict__ b, float* __restrict__ Ls,
    float* __restrict__ Ws, float* __restrict__ ys, float (&A)[M][M],
    float (&W)[M][M], float (&y)[M], float (&Wy)[M], int k, size_t sB,
    int lane) {
  // A = D_k - S (lower triangle), Cholesky in place, row-sequential
#pragma unroll
  for (int i = 0; i < M; ++i)
#pragma unroll
    for (int j = 0; j <= i; ++j)
      A[i][j] = D[mat_idx(k, i, j, M, sB, lane)] - A[i][j];
#pragma unroll
  for (int i = 0; i < M; ++i) {
#pragma unroll
    for (int j = 0; j <= i; ++j) {
      float s = A[i][j];
#pragma unroll
      for (int t = 0; t < j; ++t) s -= A[i][t] * A[j][t];
      A[i][j] = (i == j) ? sqrtf(s) : s / A[j][j];
    }
  }
#pragma unroll
  for (int i = 0; i < M; ++i)
#pragma unroll
    for (int j = 0; j <= i; ++j) Ls[mat_idx(k, i, j, M, sB, lane)] = A[i][j];
  if constexpr (kZeroUpper) {
#pragma unroll
    for (int i = 0; i < M; ++i)
#pragma unroll
      for (int j = i + 1; j < M; ++j) Ls[mat_idx(k, i, j, M, sB, lane)] = 0.f;
  }

  // y_k = L^-1 (b_k - Wy)
#pragma unroll
  for (int i = 0; i < M; ++i) {
    float s = b[vec_idx(k, i, M, sB, lane)] - Wy[i];
#pragma unroll
    for (int t = 0; t < i; ++t) s -= A[i][t] * y[t];
    y[i] = s / A[i][i];
    ys[vec_idx(k, i, M, sB, lane)] = y[i];
  }

  // W_k = L^-1 U_k
  const float* Uk = U + static_cast<size_t>(k) * M * M;
#pragma unroll
  for (int j = 0; j < M; ++j) {
#pragma unroll
    for (int i = 0; i < M; ++i) {
      float s = __ldg(Uk + i * M + j);
#pragma unroll
      for (int t = 0; t < i; ++t) s -= A[i][t] * W[t][j];
      W[i][j] = s / A[i][i];
    }
  }
  if constexpr (kStoreW) {
#pragma unroll
    for (int i = 0; i < M; ++i)
#pragma unroll
      for (int j = 0; j < M; ++j) Ws[mat_idx(k, i, j, M, sB, lane)] = W[i][j];
  }

  // S = W^T W (lower triangle, into A), Wy = W^T y
#pragma unroll
  for (int i = 0; i < M; ++i) {
#pragma unroll
    for (int j = 0; j <= i; ++j) {
      float s = W[0][i] * W[0][j];
#pragma unroll
      for (int t = 1; t < M; ++t) s += W[t][i] * W[t][j];
      A[i][j] = s;
    }
    float s = W[0][i] * y[0];
#pragma unroll
    for (int t = 1; t < M; ++t) s += W[t][i] * y[t];
    Wy[i] = s;
  }
}

}  // namespace trt
