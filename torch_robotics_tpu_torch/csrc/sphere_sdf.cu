// Point-cloud sphere SDF: sdf(p_i) = min_j ||p_i - c_j|| - r_j.
//
// Replaces the TPU kernel torch_robotics_tpu/ops/pallas_sdf.py
// (sphere_sdf_pallas).  Its plain PyTorch version is sphere_sdf_reference
// in torch_robotics_tpu_torch/ops/sdf_kernel.py.
//
// points (M, 3), centers (S, 3), radii (S,) -> (M,), float32.
//
// The TPU kernel expands |p|^2 + |c|^2 - 2 p.c to put the cross term on
// its matrix unit, at the highest matmul precision to tame the
// cancellation.  The card has no such reason: each thread takes one query
// point and runs the direct form sqrtf(|p - c|^2) - r over the spheres
// with a running fminf, which is what the plain version computes.  The
// spheres are staged through shared memory in tiles of kTile (one float4
// each: center and radius), read back as broadcasts.  A ragged M masks the
// last block's threads (they still help stage the tiles); a ragged S
// shortens the last tile's loop.
//
// What bounds it on the H100: operations.  Each (point, sphere) pair is
// ~11 float operations (the differences, the squared norm, a square root,
// the radius and the min), so M = 65536, S = 4096 is ~3e9 operations
// against ~1 MB of bytes; the square root is a multi-instruction sequence
// (round-to-nearest sqrtf), so the kernel sits a small factor above the
// operation bound at best.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 512;

__global__ void __launch_bounds__(kThreads)
sphere_sdf_kernel(const float* __restrict__ points,
                  const float* __restrict__ centers,
                  const float* __restrict__ radii, float* __restrict__ out,
                  int M, int S) {
  __shared__ float4 tile[kTile];
  const int i = blockIdx.x * kThreads + threadIdx.x;
  const bool live = i < M;
  float px = 0.f, py = 0.f, pz = 0.f;
  if (live) {
    px = points[3 * static_cast<size_t>(i)];
    py = points[3 * static_cast<size_t>(i) + 1];
    pz = points[3 * static_cast<size_t>(i) + 2];
  }
  float best = INFINITY;
  for (int base = 0; base < S; base += kTile) {
    const int n = min(kTile, S - base);
    __syncthreads();  // the previous tile is no longer read
    for (int j = threadIdx.x; j < n; j += kThreads) {
      const size_t s = static_cast<size_t>(base) + j;
      tile[j] = make_float4(centers[3 * s], centers[3 * s + 1],
                            centers[3 * s + 2], radii[s]);
    }
    __syncthreads();
#pragma unroll 8
    for (int j = 0; j < n; ++j) {
      const float4 c = tile[j];
      const float dx = px - c.x, dy = py - c.y, dz = pz - c.z;
      best = fminf(best, sqrtf(dx * dx + dy * dy + dz * dz) - c.w);
    }
  }
  if (live) out[i] = best;
}

}  // namespace

// points (M, 3), centers (S, 3), radii (S,) -> out (M,); returns a CUDA
// error code.
extern "C" int trt_sphere_sdf_launch(const float* points, const float* centers,
                                     const float* radii, float* out, int M,
                                     int S, void* stream) {
  const int blocks = (M + kThreads - 1) / kThreads;
  sphere_sdf_kernel<<<blocks, kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(points, centers,
                                                            radii, out, M, S);
  return static_cast<int>(cudaGetLastError());
}
