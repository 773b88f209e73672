// Point-cloud sphere SDF: sdf(p_i) = min_j ||p_i - c_j|| - r_j.
//
// Replaces the TPU kernel torch_robotics_tpu/ops/pallas_sdf.py
// (sphere_sdf_pallas).  Its plain PyTorch version is sphere_sdf_reference
// in torch_robotics_tpu_torch/ops/sdf_kernel.py.
//
// points (M, 3), centers (S, 3), radii (S,) -> (M,), float32.
//
// The TPU kernel expands |p|^2 + |c|^2 - 2 p.c to put the cross term on
// its matrix unit.  The card runs the direct form: each pair's value is
// sqrtf(dx * dx + dy * dy + dz * dz) - r, the plain version's arithmetic.
//
// What bounds it on the H100: operations, ~11 float operations a (point,
// sphere) pair (M = 65536, S = 4096 is ~3e9 against ~1 MB of bytes).  An
// earlier one-point-a-thread kernel's hot loop held 25 SASS instructions a
// pair: the correctly rounded sqrtf (MUFU.RSQ, a Newton fix-up and a range
// check) ran on every pair, one shared-memory load served one pair, and 256
// blocks of 8 warps left most SMs at 16 warps.  This design:
//
// - The root only where a sphere can still win.  A pair can lower a
//   point's running minimum `best` only if sqrtf(d2) - r < best, i.e.
//   d2 < (best + r)^2; with rmax >= r over a warp's 32 spheres the pair is
//   skipped where d2 > cull_limit(best, rmax) (no sphere wins where best +
//   rmax <= 0, as sqrtf(d2) >= 0).  The limit's margin 1 + 2^-20 covers
//   float32 rounding: with u = 2^-24, a winner has d2 < (best + rmax)^2 /
//   (1 - u)^4, and the computed limit is at least (best + rmax)^2 (1 -
//   u)^2 (1 + 2^-20) where it is normal (2 FLT_MIN below).  A warp tests
//   all its pairs against the limit and takes the root (per lane, under
//   the pair's own test) only where any lane of the warp passes
//   (__any_sync, a warp-uniform branch): in the scan's float32 model
//   (tests/test_torch_point_cloud.py) on a cloud like phase point_cloud's,
//   0.9% of the pairs take the root, in 15% of a warp's steps.  An
//   evaluated pair takes the earlier kernel's expression, and min is exact
//   in any order, so the output is its bit for bit.
// - Four points a thread: one broadcast load of a sphere (a float4 in
//   shared memory) serves four pairs, and the four chains are independent.
// - The card filled: a block is a tile of 128 points held by each of its
//   `warps` warps, which split the spheres (warp w takes spheres w * 32 ..
//   w * 32 + 31 of each stage of warps * 32), so that M = 65536 launches
//   512 blocks of 8 warps (sdf_launch_config in ops/sdf_kernel.py).  The
//   warps share their points' minima through shared memory (each warp's
//   atomic min on the float's bits at the end of a stage, read back at the
//   start of the next), so each warp culls against the minimum over every
//   sphere its block has seen by then; the last barrier leaves each
//   point's minimum there to be stored.  Stages of spheres are staged by
//   cp.async into a double buffer; past S a warp stops early (its slots
//   padded with spheres that never win, for its largest radius).
// The first stage starts from best = +inf, so nearly every pair of it
// takes the root, at more instructions than the earlier kernel's: where
// S is a stage or two (S = 129), that stage sets the time.
#include <cuda_runtime.h>
#include <float.h>
#include <math.h>

namespace {

constexpr int kLanes = 32;
constexpr int kPoints = 4;                       // query points a thread
constexpr int kTilePoints = kPoints * kLanes;    // query points a block
constexpr int kMaxWarps = 16;
constexpr float kMargin = 1.0f + 0x1p-20f;
constexpr float kTinyLimit = 2.0f * FLT_MIN;

// shared memory of a block of `warps` warps: two stages of warps * 32
// spheres (a float4 each) and the block's points' minima
__host__ __device__ constexpr int sdf_smem_bytes(int warps) {
  return 2 * warps * kLanes * 16 + kTilePoints * 4;
}

// the largest d2 at which a sphere of radius <= rmax can still lower best
// (any d2 >= 0 exceeds -1)
__device__ __forceinline__ float cull_limit(float best, float rmax) {
  const float b = best + rmax;
  return b > 0.f ? fmaxf(b * b * kMargin, kTinyLimit) : -1.f;
}

// min into a float in shared memory: ordered as signed ints where v >= +0,
// as unsigned ints where v's sign bit is set (a more negative float is a
// larger unsigned int)
__device__ __forceinline__ void atomic_min_float(float* addr, float v) {
  const int bits = __float_as_int(v);
  if (bits >= 0)
    atomicMin(reinterpret_cast<int*>(addr), bits);
  else
    atomicMax(reinterpret_cast<unsigned*>(addr), static_cast<unsigned>(bits));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// thread t stages sphere first + t as (cx, cy, cz, r); past S a sphere at
// infinity of radius -inf, whose value sqrtf(inf) + inf never wins
__device__ __forceinline__ void stage_spheres(float4* dst,
                                              const float* centers,
                                              const float* radii, int first,
                                              int S) {
  const int s = first + static_cast<int>(threadIdx.x);
  float4* d = dst + threadIdx.x;
  if (s < S) {
    const float* c = centers + 3 * static_cast<size_t>(s);
    cp_async4(&d->x, c);
    cp_async4(&d->y, c + 1);
    cp_async4(&d->z, c + 2);
    cp_async4(&d->w, radii + s);
  } else {
    *d = make_float4(INFINITY, INFINITY, INFINITY, -INFINITY);
  }
}

__global__ void __launch_bounds__(kMaxWarps * kLanes, 2)
sphere_sdf_kernel(const float* __restrict__ points,
                  const float* __restrict__ centers,
                  const float* __restrict__ radii, float* __restrict__ out,
                  int M, int S) {
  extern __shared__ float4 smem[];
  const int per_stage = static_cast<int>(blockDim.x);   // warps * 32
  float* best_sh = reinterpret_cast<float*>(smem + 2 * per_stage);
  const int lane = static_cast<int>(threadIdx.x) % kLanes;
  const int warp = static_cast<int>(threadIdx.x) / kLanes;
  const int tile = blockIdx.x * kTilePoints;
  if (threadIdx.x < kTilePoints) best_sh[threadIdx.x] = INFINITY;

  // points tile + k * 32 + lane (a ragged tile's extra slots take the
  // origin and are not stored)
  float px[kPoints], py[kPoints], pz[kPoints], best[kPoints], lim[kPoints];
#pragma unroll
  for (int k = 0; k < kPoints; ++k) {
    const int i = tile + k * kLanes + lane;
    px[k] = py[k] = pz[k] = 0.f;
    if (i < M) {
      px[k] = points[3 * static_cast<size_t>(i)];
      py[k] = points[3 * static_cast<size_t>(i) + 1];
      pz[k] = points[3 * static_cast<size_t>(i) + 2];
    }
    best[k] = INFINITY;
  }

  const int n_stages = (S + per_stage - 1) / per_stage;
  stage_spheres(smem, centers, radii, 0, S);
  cp_async_commit();
  for (int st = 0; st < n_stages; ++st) {
    if (st + 1 < n_stages)
      stage_spheres(smem + ((st + 1) & 1) * per_stage, centers, radii,
                    (st + 1) * per_stage, S);
    cp_async_commit();
    cp_async_wait_one();
    __syncthreads();  // stage st has landed; earlier minima are visible
    const float4* sph = smem + (st & 1) * per_stage + warp * kLanes;
    float rmax = sph[lane].w;
#pragma unroll
    for (int o = kLanes / 2; o > 0; o /= 2)
      rmax = fmaxf(rmax, __shfl_xor_sync(0xffffffffu, rmax, o));
#pragma unroll
    for (int k = 0; k < kPoints; ++k) {
      best[k] = fminf(best[k], *static_cast<volatile float*>(
                                   best_sh + k * kLanes + lane));
      lim[k] = cull_limit(best[k], rmax);
    }
    // one (sphere, four points) step: the pairs' d2 against their limits,
    // the root where any lane of the warp may win
    auto step = [&](int j) {
      const float4 c = sph[j];
      float d2[kPoints];
      bool hit = false;
#pragma unroll
      for (int k = 0; k < kPoints; ++k) {
        const float dx = px[k] - c.x, dy = py[k] - c.y, dz = pz[k] - c.z;
        d2[k] = dx * dx + dy * dy + dz * dz;
        hit |= d2[k] <= lim[k];
      }
      if (__any_sync(0xffffffffu, hit)) {
#pragma unroll
        for (int k = 0; k < kPoints; ++k) {
          if (d2[k] <= lim[k]) {
            best[k] = fminf(best[k], sqrtf(d2[k]) - c.w);
            lim[k] = cull_limit(best[k], rmax);
          }
        }
      }
    };
    // this warp's spheres of the stage: 32 but in the last stage
    const int n = min(kLanes, S - st * per_stage - warp * kLanes);
    if (n == kLanes) {
#pragma unroll 4
      for (int j = 0; j < kLanes; ++j) step(j);
    } else {
      for (int j = 0; j < n; ++j) step(j);
    }
#pragma unroll
    for (int k = 0; k < kPoints; ++k)
      atomic_min_float(best_sh + k * kLanes + lane, best[k]);
    __syncthreads();  // stage st is read: its buffer may be staged again
  }
  if (threadIdx.x < kTilePoints && tile + static_cast<int>(threadIdx.x) < M)
    out[tile + threadIdx.x] = best_sh[threadIdx.x];
}

}  // namespace

// points (M, 3), centers (S, 3), radii (S,) -> out (M,) with `warps`
// warps a block (4..16: a thread a point of the tile keeps and stores its
// minimum; sdf_launch_config); returns a CUDA error code.
extern "C" int trt_sphere_sdf_launch(const float* points, const float* centers,
                                     const float* radii, float* out, int M,
                                     int S, int warps, void* stream) {
  if (warps < kPoints || warps > kMaxWarps)
    return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (M + kTilePoints - 1) / kTilePoints;
  sphere_sdf_kernel<<<blocks, warps * kLanes, sdf_smem_bytes(warps),
                      static_cast<cudaStream_t>(stream)>>>(
      points, centers, radii, out, M, S);
  return static_cast<int>(cudaGetLastError());
}
