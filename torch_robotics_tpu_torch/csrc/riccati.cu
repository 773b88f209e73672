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
// Design: one thread per batch lane (per lane and step size in the
// rollout), the T-step recursion a loop inside the thread, templated on D
// so the reflection loops unroll into registers.  Every global array is
// batch-minor, so a warp's loads and stores of one entry are 32
// consecutive floats.  The F columns change under phase 2's reflections;
// they go to a per-lane scratch Fw (M, P, B) in device memory (P is a run
// time size), read from Fc at the first reflection.  A ragged batch masks
// the last block's threads; nothing is padded.  Divisions are exact (no
// fast math), as the TPU kernel's reciprocal is.
//
// What bounds them on the H100: at the iLQR path's shapes (T = 31, D = 7,
// P = 27, B = 512) the sweep must move ~32 MB (Fc alone is 24 MB) and do
// ~3.7e8 float ops: bytes, ~10 us of HBM traffic; the rollout moves
// ~15 MB.  Both are latency bound instead: B = 512 lanes are 16 warps on
// 132 SMs, each thread a dependent chain of T steps, and the sweep's
// per-thread S, S Phi and S B blocks (~500 floats at D = 7) spill to local
// memory.  Splitting a lane's reflections over a warp comes first in a
// faster version.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 64;

struct SweepConsts {
  float dt, half_dt2, r, ru2, sqrt_ru, sqrt_kg;
};

template <int D>
__global__ void __launch_bounds__(kThreads)
riccati_kernel(const float* __restrict__ U, const float* __restrict__ l,
               const float* __restrict__ Fc, const float* __restrict__ Vx0,
               float* __restrict__ ks, float* __restrict__ Ks,
               float* __restrict__ Fw, int P, int T, int B, SweepConsts c) {
  constexpr int M = 2 * D;
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const size_t sB = B;

  // A holds S (upper triangular) between steps and S Phi within one.
  float A[M][M], Vx[M];
#pragma unroll
  for (int i = 0; i < M; ++i) {
    Vx[i] = Vx0[i * sB + b];
#pragma unroll
    for (int j = 0; j < M; ++j) A[i][j] = i == j ? c.sqrt_kg : 0.f;
  }

  for (int t = T - 1; t >= 0; --t) {
    // G = S B, then S Phi in place (its u block is S's own)
    float G[M][D];
#pragma unroll
    for (int i = 0; i < M; ++i)
#pragma unroll
      for (int j = 0; j < D; ++j)
        G[i][j] = c.half_dt2 * A[i][j] + c.dt * A[i][j + D];
#pragma unroll
    for (int i = 0; i < M; ++i)
#pragma unroll
      for (int j = D; j < M; ++j) A[i][j] = c.dt * A[i][j - D] + A[i][j];

    // phase 1: D reflections over the u columns -> R11, R12
    float R11[D][D], R12[D][M];
#pragma unroll
    for (int j = 0; j < D; ++j) {
      float gg = G[0][j] * G[0][j];
#pragma unroll
      for (int i = 1; i < M; ++i) gg += G[i][j] * G[i][j];
      const float alpha = -sqrtf(c.ru2 + gg);
      const float v0 = c.sqrt_ru - alpha;  // > 0 always
      const float beta = 2.f / (v0 * v0 + gg);
#pragma unroll
      for (int col = 0; col < M; ++col) {
        float w = G[0][j] * A[0][col];
#pragma unroll
        for (int i = 1; i < M; ++i) w += G[i][j] * A[i][col];
        R12[j][col] = -(beta * v0) * w;
        const float bw = beta * w;
#pragma unroll
        for (int i = 0; i < M; ++i) A[i][col] = A[i][col] - bw * G[i][j];
      }
      R11[j][j] = alpha;
#pragma unroll
      for (int col = j + 1; col < D; ++col) {
        float w = G[0][j] * G[0][col];
#pragma unroll
        for (int i = 1; i < M; ++i) w += G[i][j] * G[i][col];
        R11[j][col] = -(beta * v0) * w;
        const float bw = beta * w;
#pragma unroll
        for (int i = 0; i < M; ++i) G[i][col] = G[i][col] - bw * G[i][j];
      }
    }

    // gains: w = R11^-T Qu, k = -R11^-1 w, K = -R11^-1 R12, and
    // Vx' = Qx + R12^T (R11 k); Qx = l + Phi^T Vx, Qu = r u + B^T Vx
    float inv11[D], wv[D], k[D];
#pragma unroll
    for (int i = 0; i < D; ++i) inv11[i] = 1.f / R11[i][i];
#pragma unroll
    for (int i = 0; i < D; ++i) {
      float acc = c.r * U[((size_t)t * D + i) * sB + b] +
                  c.half_dt2 * Vx[i] + c.dt * Vx[i + D];
#pragma unroll
      for (int l2 = 0; l2 < i; ++l2) acc = acc - R11[l2][i] * wv[l2];
      wv[i] = acc * inv11[i];
    }
#pragma unroll
    for (int i = D - 1; i >= 0; --i) {
      float acc = -wv[i];
#pragma unroll
      for (int l2 = i + 1; l2 < D; ++l2) acc = acc - R11[i][l2] * k[l2];
      k[i] = acc * inv11[i];
      ks[((size_t)t * D + i) * sB + b] = k[i];
    }
    float y[D];
#pragma unroll
    for (int i = 0; i < D; ++i) {
      float acc = R11[i][i] * k[i];
#pragma unroll
      for (int l2 = i + 1; l2 < D; ++l2) acc = acc + R11[i][l2] * k[l2];
      y[i] = acc;
    }
    float Vn[M];
#pragma unroll
    for (int col = 0; col < M; ++col) {
      const float lx = l[((size_t)t * M + col) * sB + b];
      float acc = col < D ? lx + Vx[col] : lx + c.dt * Vx[col - D] + Vx[col];
#pragma unroll
      for (int i = 0; i < D; ++i) acc = acc + R12[i][col] * y[i];
      Vn[col] = acc;
      float Kc[D];
#pragma unroll
      for (int i = D - 1; i >= 0; --i) {
        float a = -R12[i][col];
#pragma unroll
        for (int l2 = i + 1; l2 < D; ++l2) a = a - R11[i][l2] * Kc[l2];
        Kc[i] = a * inv11[i];
        Ks[(((size_t)t * D + i) * M + col) * sB + b] = Kc[i];
      }
    }
#pragma unroll
    for (int i = 0; i < M; ++i) Vx[i] = Vn[i];

    // phase 2: M reflections triangularize [S Phi; F_t] -> the next S,
    // written over A's upper triangle; rows below the pivot keep the
    // reflection vectors until the step ends
    const float* Ft = Fc + (size_t)t * M * P * sB;
#pragma unroll
    for (int j = 0; j < M; ++j) {
      const float* Fj = (j == 0 ? Ft : Fw) + (size_t)j * P * sB + b;
      float rest2 = 0.f;
      for (int p = 0; p < P; ++p) rest2 += Fj[p * sB] * Fj[p * sB];
#pragma unroll
      for (int i = j + 1; i < M; ++i) rest2 += A[i][j] * A[i][j];
      const float head = A[j][j];
      const float norm = sqrtf(head * head + rest2);
      const float alpha = head >= 0.f ? -norm : norm;
      const float v0 = head - alpha;
      const float vtv = v0 * v0 + rest2;
      const float beta = vtv > 0.f ? 2.f / vtv : 0.f;
#pragma unroll
      for (int col = j + 1; col < M; ++col) {
        const float* Fs = (j == 0 ? Ft : Fw) + (size_t)col * P * sB + b;
        float* Fd = Fw + (size_t)col * P * sB + b;
        float fdot = 0.f;
        for (int p = 0; p < P; ++p) fdot += Fj[p * sB] * Fs[p * sB];
        float w = v0 * A[j][col] + fdot;
#pragma unroll
        for (int i = j + 1; i < M; ++i) w += A[i][j] * A[i][col];
        const float bw = beta * w;
        A[j][col] = A[j][col] - bw * v0;
#pragma unroll
        for (int i = j + 1; i < M; ++i) A[i][col] = A[i][col] - bw * A[i][j];
        for (int p = 0; p < P; ++p) Fd[p * sB] = Fs[p * sB] - bw * Fj[p * sB];
      }
      A[j][j] = alpha;
    }
#pragma unroll
    for (int i = 1; i < M; ++i)
#pragma unroll
      for (int j = 0; j < i; ++j) A[i][j] = 0.f;
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
                         const float* Vx0, float* ks, float* Ks, float* Fw,
                         int P, int T, int B, SweepConsts c,
                         cudaStream_t stream) {
  const int blocks = (B + kThreads - 1) / kThreads;
  riccati_kernel<D><<<blocks, kThreads, 0, stream>>>(U, l, Fc, Vx0, ks, Ks,
                                                     Fw, P, T, B, c);
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

// The sweep, with Fw (M, P, B) as device scratch; returns a CUDA error code
// (cudaErrorInvalidValue for D outside 1..8).  ru2 = sqrt_ru^2 = r + mu.
extern "C" int trt_riccati_launch(const float* U, const float* l,
                                  const float* Fc, const float* Vx0,
                                  float* ks, float* Ks, float* Fw, int P,
                                  int T, int B, int D, float dt,
                                  float half_dt2, float r, float ru2,
                                  float sqrt_ru, float sqrt_kg,
                                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const SweepConsts c{dt, half_dt2, r, ru2, sqrt_ru, sqrt_kg};
  switch (D) {
    case 1: return launch_sweep<1>(U, l, Fc, Vx0, ks, Ks, Fw, P, T, B, c, s);
    case 2: return launch_sweep<2>(U, l, Fc, Vx0, ks, Ks, Fw, P, T, B, c, s);
    case 3: return launch_sweep<3>(U, l, Fc, Vx0, ks, Ks, Fw, P, T, B, c, s);
    case 4: return launch_sweep<4>(U, l, Fc, Vx0, ks, Ks, Fw, P, T, B, c, s);
    case 5: return launch_sweep<5>(U, l, Fc, Vx0, ks, Ks, Fw, P, T, B, c, s);
    case 6: return launch_sweep<6>(U, l, Fc, Vx0, ks, Ks, Fw, P, T, B, c, s);
    case 7: return launch_sweep<7>(U, l, Fc, Vx0, ks, Ks, Fw, P, T, B, c, s);
    case 8: return launch_sweep<8>(U, l, Fc, Vx0, ks, Ks, Fw, P, T, B, c, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
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
