// Batched block-tridiagonal SPD solve that keeps only L and y, batch in the
// minor (lane) axis.
//
// Replaces the TPU kernel torch_robotics_tpu/ops/pallas_btridiag.py
// solve_lanes_pallas (body _kernel), with both of its backward tails:
//   btridiag_sweep_kernel<M, false>  W_k = L_k^-1 U_k recomputed by a
//                                    triangular solve (trsm) per step;
//   btridiag_sweep_kernel<M, true>   bwd_trsv: z = W_k x_{k+1} as
//                                    L_k^-1 (U_k x_{k+1}), a matvec and one
//                                    triangular vector solve.
// Its plain PyTorch version is solve_lanes_core in
// torch_robotics_tpu_torch/solve/btridiag_lanes.py.
//
// D (H, M, M, B), U (H, M, M) shared over the batch (the last block unused),
// b (H, M, B) -> x (H, M, B):
//   forward over k:  the W-persisting sweep's block step (sweep_step in
//                    btridiag_sweep.cuh) without the W store;
//   backward:        x_{H-1} = L^-T y_{H-1};  x_k = L^-T (y_k - W_k x_{k+1}),
//                    W_k x_{k+1} from the recomputed W_k or, with the trsv
//                    tail, from L_k^-1 (U_k x_{k+1}).
//
// Design: one thread per batch lane, as the W-persisting sweep (btridiag.cu):
// the L and y stacks go to device memory in the batch-minor layout, so a
// warp's accesses to one block entry are 32 consecutive floats.  The trsm
// tail streams W_k one column at a time (a column is M floats; subtracting
// column j's term from every row keeps each row's order of subtraction, j
// ascending) with L_k's lower triangle in registers.  A ragged batch masks
// the last warp; nothing is padded.
//
// What bounds it on the H100: as the W-persisting sweep, parallelism, not
// bytes or operations, at B = 1024: 32 warps on 132 SMs, each step a
// dependent chain of ~M^3/6 multiply-adds in the Cholesky.  It saves the W
// stack's store and load (H M^2 B floats each way) and pays the trsm tail
// (~M^3/2 multiply-adds a step) or the trsv tail (~1.5 M^2).
#include <cuda_runtime.h>
#include <math.h>

#include "btridiag_sweep.cuh"

namespace {

using namespace trt;

constexpr int kThreads = 64;

template <int M, bool kTrsv>
__global__ void __launch_bounds__(kThreads)
btridiag_sweep_kernel(const float* __restrict__ D,
                      const float* __restrict__ U,
                      const float* __restrict__ b, float* __restrict__ x,
                      float* __restrict__ Ls, float* __restrict__ ys, int H,
                      int B) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= B) return;
  const size_t sB = B;
  {
    float A[M][M];  // holds S between steps, A = D_k - S then L within one
    float W[M][M];
    float y[M], Wy[M];
#pragma unroll
    for (int i = 0; i < M; ++i) {
      Wy[i] = 0.f;
#pragma unroll
      for (int j = 0; j < M; ++j) A[i][j] = 0.f;
    }
    for (int k = 0; k < H; ++k)
      sweep_step<M, false, false>(D, U, b, Ls, nullptr, ys, A, W, y, Wy, k,
                                  sB, lane);
  }

  float xn[M];
  for (int k = H - 1; k >= 0; --k) {
    float L[M][M];  // lower triangle of L_k
#pragma unroll
    for (int i = 0; i < M; ++i)
#pragma unroll
      for (int j = 0; j <= i; ++j) L[i][j] = Ls[mat_idx(k, i, j, M, sB, lane)];
    float rhs[M];
#pragma unroll
    for (int i = 0; i < M; ++i) rhs[i] = ys[vec_idx(k, i, M, sB, lane)];
    if (k < H - 1) {
      const float* Uk = U + static_cast<size_t>(k) * M * M;
      if constexpr (kTrsv) {
        // z = L^-1 v, v = U_k x_{k+1};  rhs -= z
        float z[M];
#pragma unroll
        for (int i = 0; i < M; ++i) {
          float v = __ldg(Uk + i * M) * xn[0];
#pragma unroll
          for (int j = 1; j < M; ++j) v += __ldg(Uk + i * M + j) * xn[j];
#pragma unroll
          for (int t = 0; t < i; ++t) v -= L[i][t] * z[t];
          z[i] = v / L[i][i];
        }
#pragma unroll
        for (int i = 0; i < M; ++i) rhs[i] -= z[i];
      } else {
        // rhs_i -= sum_j W_k[i][j] x_{k+1}[j], W_k = L^-1 U_k by columns
#pragma unroll
        for (int j = 0; j < M; ++j) {
          float w[M];
#pragma unroll
          for (int i = 0; i < M; ++i) {
            float s = __ldg(Uk + i * M + j);
#pragma unroll
            for (int t = 0; t < i; ++t) s -= L[i][t] * w[t];
            w[i] = s / L[i][i];
            rhs[i] -= w[i] * xn[j];
          }
        }
      }
    }
    // x_k = L^-T rhs
#pragma unroll
    for (int i = M - 1; i >= 0; --i) {
      float s = rhs[i];
#pragma unroll
      for (int t = i + 1; t < M; ++t) s -= L[t][i] * xn[t];
      xn[i] = s / L[i][i];
    }
#pragma unroll
    for (int i = 0; i < M; ++i) x[vec_idx(k, i, M, sB, lane)] = xn[i];
  }
}

template <int M, bool kTrsv>
cudaError_t launch(const float* D, const float* U, const float* b, float* x,
                   float* Ls, float* ys, int H, int B, cudaStream_t stream) {
  const int blocks = (B + kThreads - 1) / kThreads;
  btridiag_sweep_kernel<M, kTrsv><<<blocks, kThreads, 0, stream>>>(
      D, U, b, x, Ls, ys, H, B);
  return cudaGetLastError();
}

}  // namespace

// D (H, M, M, B), U (H, M, M), b (H, M, B) -> x (H, M, B), with L
// (H, M, M, B) and y (H, M, B) as device scratch; trsv selects the backward
// tail (0: trsm, 1: trsv).  Returns a CUDA error code
// (cudaErrorInvalidValue for M outside {2, 4, ..., 16}).
extern "C" int trt_btridiag_sweep_launch(const float* D, const float* U,
                                         const float* b, float* x, float* Ls,
                                         float* ys, int H, int M, int B,
                                         int trsv, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define TRT_SW(m)                                                   \
  (trsv ? launch<m, true>(D, U, b, x, Ls, ys, H, B, s)              \
        : launch<m, false>(D, U, b, x, Ls, ys, H, B, s))
  switch (M) {
    case 2: return TRT_SW(2);
    case 4: return TRT_SW(4);
    case 6: return TRT_SW(6);
    case 8: return TRT_SW(8);
    case 10: return TRT_SW(10);
    case 12: return TRT_SW(12);
    case 14: return TRT_SW(14);
    case 16: return TRT_SW(16);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef TRT_SW
}
