// Gauss-Newton assembly from materialized rows: r (P, N), Jr (P, D, N) ->
// g (D, N), the packed upper triangle Hu (D (D + 1) / 2, N) of Jr^T Jr and
// cost (N), per lane n:
//   g[j] = sum_p r[p] Jr[p, j],  Hu[u(i, j)] = sum_p Jr[p, i] Jr[p, j] (j >= i),
//   cost = 0.5 sum_p r[p]^2,
// with u(i, j) running over (i, j), j >= i, row by row
// (triu_index_pairs in ops/gn_assembly_kernel.py).
//
// Replaces the TPU kernel torch_robotics_tpu/ops/pallas_gn_assembly.py
// gn_assembly_pallas (body _kernel).  Its plain PyTorch version is
// gn_assembly_reference in torch_robotics_tpu_torch/ops/gn_assembly_kernel.py.
//
// Design: one thread per lane n, a loop over the P rows, the D + D (D + 1) /
// 2 + 1 sums in registers (45 at D = 8).  Row p's r and Jr entries of
// neighbouring lanes are neighbouring floats, so every load and store of a
// warp is 32 consecutive floats; a ragged N masks the last block, nothing
// is padded.
//
// What bounds it on the H100: bytes.  It reads P (D + 1) floats and writes
// D + D (D + 1) / 2 + 1 per lane, each once, for ~2 D (D + 1) P float ops:
// at D = 7 about 1.9 float ops a byte, far below the card's ~20.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;

template <int D>
__global__ void __launch_bounds__(kThreads)
gn_assembly_kernel(const float* __restrict__ r, const float* __restrict__ Jr,
                   float* __restrict__ g, float* __restrict__ hu,
                   float* __restrict__ cost, int P, int N) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  constexpr int kU = D * (D + 1) / 2;
  float ga[D], ha[kU], c = 0.f;
#pragma unroll
  for (int j = 0; j < D; ++j) ga[j] = 0.f;
#pragma unroll
  for (int u = 0; u < kU; ++u) ha[u] = 0.f;
  for (int p = 0; p < P; ++p) {
    const float rp = r[static_cast<size_t>(p) * N + n];
    float J[D];
#pragma unroll
    for (int j = 0; j < D; ++j)
      J[j] = Jr[(static_cast<size_t>(p) * D + j) * N + n];
    c += rp * rp;
#pragma unroll
    for (int j = 0; j < D; ++j) ga[j] += rp * J[j];
    int u = 0;
#pragma unroll
    for (int i = 0; i < D; ++i)
#pragma unroll
      for (int j = i; j < D; ++j, ++u) ha[u] += J[i] * J[j];
  }
#pragma unroll
  for (int j = 0; j < D; ++j) g[static_cast<size_t>(j) * N + n] = ga[j];
#pragma unroll
  for (int u = 0; u < kU; ++u) hu[static_cast<size_t>(u) * N + n] = ha[u];
  cost[n] = 0.5f * c;
}

template <int D>
cudaError_t launch(const float* r, const float* Jr, float* g, float* hu,
                   float* cost, int P, int N, cudaStream_t stream) {
  const int blocks = (N + kThreads - 1) / kThreads;
  gn_assembly_kernel<D><<<blocks, kThreads, 0, stream>>>(r, Jr, g, hu, cost,
                                                         P, N);
  return cudaGetLastError();
}

}  // namespace

// r (P, N), Jr (P, D, N) -> g (D, N), hu (D (D + 1) / 2, N), cost (N).
// Returns a CUDA error code (cudaErrorInvalidValue for D outside 1..8).
extern "C" int trt_gn_assembly_launch(const float* r, const float* Jr,
                                      float* g, float* hu, float* cost,
                                      int P, int D, int N, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define TRT_GN(d) launch<d>(r, Jr, g, hu, cost, P, N, s)
  switch (D) {
    case 1: return TRT_GN(1);
    case 2: return TRT_GN(2);
    case 3: return TRT_GN(3);
    case 4: return TRT_GN(4);
    case 5: return TRT_GN(5);
    case 6: return TRT_GN(6);
    case 7: return TRT_GN(7);
    case 8: return TRT_GN(8);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef TRT_GN
}
