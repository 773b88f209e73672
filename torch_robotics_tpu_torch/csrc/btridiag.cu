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
// Design: one thread per batch lane, the H-step sweep a loop inside the
// thread (its block step, sweep_step in btridiag_sweep.cuh, is shared with
// btridiag_sweep.cu).  The L, W and y stacks go to device memory in the batch-minor
// layout (H, M, M, B) that the wrapper allocates, so a warp's reads and
// writes of one block entry are 32 consecutive floats.  The running S / A
// block and the current W block are per-thread arrays (2 M^2 floats, more
// than the 255-register limit at M = 14, so part lives in local memory).
// A ragged batch masks the last warp; nothing is padded.  Indefinite
// pivots give NaN, as in the reference.
//
// What bounds it on the H100: neither bytes nor operations at B = 1024 but
// parallelism.  One thread per lane is 32 warps on 132 SMs, and each step's
// Cholesky is a dependent chain of ~M^3/6 multiply-adds plus M square
// roots; the known limit is recorded in PERF.md for a later PR.
//
// The substitution kernel does ~3 M^2 multiply-adds per block step against
// the sweep's ~1.7 M^3 and keeps only y and Wy (2 M floats) in registers;
// it reads L and W (2 M^2 floats per step and lane) once in each pass, so
// it is bound by those loads' latency at the few warps a batch of lanes
// gives, not by the card's byte rate.  One thread per lane as the sweep;
// the backward pass is the sweep's own (backward_pass below).
#include <cuda_runtime.h>
#include <math.h>

#include "btridiag_sweep.cuh"

namespace {

using namespace trt;

constexpr int kThreads = 64;

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

template <int M, bool kFactorOut>
__global__ void __launch_bounds__(kThreads)
btridiag_w_kernel(const float* __restrict__ D, const float* __restrict__ U,
                  const float* __restrict__ b, float* __restrict__ x,
                  float* __restrict__ Ls, float* __restrict__ Ws,
                  float* __restrict__ ys, int H, int B) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= B) return;
  const size_t sB = B;
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
    sweep_step<M, true, kFactorOut>(D, U, b, Ls, Ws, ys, A, W, y, Wy, k, sB,
                                    lane);
  backward_pass<M>(Ls, Ws, ys, x, H, sB, lane);
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
                   float* Ls, float* Ws, float* ys, int H, int B,
                   cudaStream_t stream) {
  const int blocks = (B + kThreads - 1) / kThreads;
  btridiag_w_kernel<M, kFactorOut><<<blocks, kThreads, 0, stream>>>(
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
// (H, M, M, B) and y (H, M, B) as device scratch; returns a CUDA error code
// (cudaErrorInvalidValue for M outside {2, 4, ..., 16}).
extern "C" int trt_btridiag_w_launch(const float* D, const float* U,
                                     const float* b, float* x, float* Ls,
                                     float* Ws, float* ys, int H, int M,
                                     int B, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define TRT_W(m) launch<m, false>(D, U, b, x, Ls, Ws, ys, H, B, s)
  switch (M) { TRT_M_CASES(TRT_W) }
#undef TRT_W
}

// The same sweep with L, W (H, M, M, B) as outputs (L's strict upper
// triangle zero) and y (H, M, B) as device scratch.
extern "C" int trt_btridiag_factor_launch(const float* D, const float* U,
                                          const float* b, float* x,
                                          float* Ls, float* Ws, float* ys,
                                          int H, int M, int B,
                                          void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define TRT_F(m) launch<m, true>(D, U, b, x, Ls, Ws, ys, H, B, s)
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
