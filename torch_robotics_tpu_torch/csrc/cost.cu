// Value-only collision cost of a kinematic robot or a MultiRobot in a
// scene of analytic primitives and precomputed SDF grids: FK -> world
// collision points -> scene SDF,
// workspace and pair-distance hinge rows -> cost = 0.5 sum r^2 per
// waypoint lane, unscaled by the collision weight, with no Jacobian.
//
// Replaces the TPU kernel torch_robotics_tpu/ops/pallas_terms.py
// collision_cost_pallas_factory, both of its branches: a single robot (one
// member with the identity base) and a MultiRobot (one member per arm,
// each at its base pose), one kernel body over a unified member list as
// the reference has.  Its plain PyTorch version is the cost output of the
// unscaled plain terms (ops/lanes_fk.py: obstacle_terms_lanes_factory,
// obstacle_terms_lanes_multirobot_factory).
//
// What bounds it on the H100: operations.  A lane reads q (d floats) and
// writes one float, 32 bytes for the Panda and 84 for config 4's three arms
// (d = 20), against ~2k float ops a lane for the Panda (FK ~1.1k, five
// points' SDF against 10 spheres, 20 rows) and ~7.8k for config 4 (three
// FK chains, 16 points' SDF, 143 rows): the float work takes 3-5x the
// memory traffic at 67 TFLOP/s and 3.35 TB/s.
//
// Design, against what held the earlier kernels back (link transforms in
// per-thread local memory, 1.6 KB a thread; every model and scene entry a
// dependent load from device memory; half of a MultiRobot block idle):
//   - the block first copies its lanes' q and the packed parameters (the
//     wrapper's pack_cost_params: the members' FK steps, points, rows, a
//     row schedule and the scene) into shared memory, with 16-byte loads;
//     FK and SDF then read shared memory, a step's, an object's or a
//     sphere's data as 16-byte records, the same address in every thread
//     of a warp (broadcasts);
//   - phase 1: thread (lane, m), m < members, runs member m's FK chain in
//     registers: each step composes the previous step's transform with
//     its joint's, and only a transform that a later, non-adjacent step
//     reads (a branching tree; none for a chain) goes to shared memory,
//     with the world position of each collision point the step carries
//     (lane-minor, [(3 p + k) * lanes + lane]: no bank conflicts), a
//     grasped object's points at R o + t of their link's world transform
//     (kin_scene.cuh: offset_point, each offset a 16-byte record).  The
//     member's base pose is the root's parent, so a single robot (identity
//     base) gets the same points, bit for bit, as fk_links;
//   - phase 2: thread (lane, t) sums the rows [cuts[t], cuts[t + 1]) of the
//     lane in the rows' order (object SDF rows, workspace rows, pairs), a
//     static cut the wrapper balances by operation count; the T partial
//     sums of a lane are added in thread order, so a lane's bits depend
//     neither on the batch nor on the lanes a block.  A single robot takes
//     one thread a lane and so today's row order;
//   - a precomputed SDF grid is looked up in-kernel (kin_scene.cuh:
//     grid_sdf), one 16-byte load from the grid table in device memory
//     per object point and grid: a table of 128 MB (0.01 m cells) cannot
//     be staged, so only its header goes to shared memory with the scene;
//   - nothing is indexed by a run-time number in a per-thread array, and
//     sincosf's fast path is copied without its large-argument branch
//     (cost.cuh: sincos_rn), so no local memory.
// The wrapper's cost_launch_config picks the lanes a block and the
// threads a lane (T) from the packed sizes.
#include <cuda_runtime.h>
#include <math.h>

#include "cost.cuh"

namespace {

using namespace trt;

constexpr int kMaxThreads = 256;  // lanes * threads a lane, at most
// 4 blocks of 256 threads an SM: ptxas keeps a thread within 64 registers,
// with no spill, and that occupancy ran faster than 80 registers
constexpr int kMinBlocks = 4;

__global__ void __launch_bounds__(kMaxThreads, kMinBlocks)
cost_kernel(const float* __restrict__ q, float* __restrict__ cost_out, int N,
            int D, const int* __restrict__ ip, int n_ints,
            const float* __restrict__ fp, int n_floats,
            const float4* __restrict__ grid) {
  extern __shared__ __align__(16) float smem[];
  const int lanes = blockDim.x, lane = threadIdx.x, t = threadIdx.y;
  const int tid = t * lanes + lane, nthr = lanes * blockDim.y;
  const int n = blockIdx.x * lanes + lane;
  const bool valid = n < N;

  // ---- the block's q (D, lanes) and the parameters into shared memory ----
  int* ism = reinterpret_cast<int*>(smem);
  float* fsm = smem + round4(n_ints);
  float* qs = fsm + round4(n_floats);
  for (int j = t; j < D; j += blockDim.y)
    qs[j * lanes + lane] = valid ? q[(size_t)j * N + n] : 0.f;
  copy_words(ip, ism, n_ints, tid, nthr);
  copy_words(fp, fsm, n_floats, tid, nthr);
  __syncthreads();
  const CostLayout a = parse_layout(ism, fsm, grid);
  float* pts = qs + D * lanes;
  float* slots = pts + 3 * a.P * lanes;
  float* part = slots + 12 * a.n_slots * lanes;

  // ---- phase 1: member t's FK chain in registers -> world points ----
  if (t < a.n_mem) {
    float R[9], tv[3];  // the previous step's world transform
    for (int s = a.mem_step[t]; s < a.mem_step[t + 1]; ++s) {
      const int4 i0 = reinterpret_cast<const int4*>(a.step_i)[2 * s];
      const int4 i1 = reinterpret_cast<const int4*>(a.step_i)[2 * s + 1];
      const float4* fr = reinterpret_cast<const float4*>(a.step_f) + 5 * s;
      const float4 f0 = fr[0], f1 = fr[1], f2 = fr[2], f3 = fr[3];
      const float F[9] = {f0.x, f0.y, f0.z, f0.w, f1.x, f1.y, f1.z, f1.w, f2.x};
      const float axis[3] = {f3.x, f3.y, f3.z};
      float tr[3] = {f2.y, f2.z, f2.w};
      float Rl[9];
      const int src = i0.z;
      joint_transform(i0.x, F, axis, f3.w, fr[4].x,
                      i0.y >= 0 ? qs[i0.y * lanes + lane] : 0.f, Rl, tr);
      if (src == -1) {  // the root's parent: the member's base pose
#pragma unroll
        for (int k = 0; k < 9; ++k) R[k] = a.base_R[9 * t + k];
#pragma unroll
        for (int k = 0; k < 3; ++k) tv[k] = a.base_t[3 * t + k];
      } else if (src >= 0) {  // a stored transform
#pragma unroll
        for (int k = 0; k < 9; ++k) R[k] = slots[(12 * src + k) * lanes + lane];
#pragma unroll
        for (int k = 0; k < 3; ++k)
          tv[k] = slots[(12 * src + 9 + k) * lanes + lane];
      }
      float Rn[9], tn[3];
      compose(R, tv, Rl, tr, Rn, tn);
#pragma unroll
      for (int k = 0; k < 9; ++k) R[k] = Rn[k];
#pragma unroll
      for (int k = 0; k < 3; ++k) tv[k] = tn[k];
      const int sl = i0.w;
      if (sl >= 0) {
#pragma unroll
        for (int k = 0; k < 9; ++k) slots[(12 * sl + k) * lanes + lane] = R[k];
#pragma unroll
        for (int k = 0; k < 3; ++k)
          slots[(12 * sl + 9 + k) * lanes + lane] = tv[k];
      }
      const int first_off = i1.y - i1.z;
      for (int i = i1.x; i < first_off; ++i) {  // the link's origin
        const int p = a.pt_list[i];
#pragma unroll
        for (int k = 0; k < 3; ++k) pts[(3 * p + k) * lanes + lane] = tv[k];
      }
      for (int i = first_off; i < i1.y; ++i) {  // offset points: R o + t
        const float4 o4 =
            reinterpret_cast<const float4*>(a.offsets)[i1.w + i - first_off];
        const float o[3] = {o4.x, o4.y, o4.z};
        float x[3];
        offset_point(R, tv, o, x);
        const int p = a.pt_list[i];
#pragma unroll
        for (int k = 0; k < 3; ++k) pts[(3 * p + k) * lanes + lane] = x[k];
      }
    }
  }
  __syncthreads();

  // ---- phase 2: rows [cuts[t], cuts[t + 1]) of the lane, in row order ----
  auto point = [&](int p, float x[3]) {
#pragma unroll
    for (int k = 0; k < 3; ++k) x[k] = pts[(3 * p + k) * lanes + lane];
  };
  float cacc = 0.f;
  const int n_sdf = a.NOBJ > 0 ? a.NO : 0;  // NOBJ counts grids too
  const int end = a.cuts[t + 1];
  int r = a.cuts[t];
  for (; r < min(end, n_sdf); ++r) {  // object rows: scene SDF hinge
    float x[3];
    point(a.obj_pt[r], x);
    const float h = relu(a.obj_thresh[r] - scene_sdf_value(a, x));
    cacc += h * h;
  }
  for (; r < min(end, n_sdf + a.NO); ++r) {  // workspace rows: min face
    const int mi = r - n_sdf;
    float x[3];
    point(a.obj_pt[mi], x);
    float val = x[0] - a.ws_min[0];
    val = fminf(val, x[1] - a.ws_min[1]);
    val = fminf(val, x[2] - a.ws_min[2]);
    val = fminf(val, a.ws_max[0] - x[0]);
    val = fminf(val, a.ws_max[1] - x[1]);
    val = fminf(val, a.ws_max[2] - x[2]);
    const float h = relu(a.obj_thresh[mi] - val);
    cacc += h * h;
  }
  for (; r < end; ++r) {  // pair rows: distance hinge
    const int k = r - n_sdf - a.NO;
    float xa[3], xb[3];
    point(a.pair_a[k], xa);
    point(a.pair_b[k], xb);
    const float diff[3] = {xa[0] - xb[0], xa[1] - xb[1], xa[2] - xb[2]};
    const float d2 = diff[0] * diff[0] + diff[1] * diff[1] + diff[2] * diff[2];
    const float m = a.pair_margin[k];
    // d2 >= m^2 (1 + 1e-6) > m^2 gives sqrtf(d2) >= m, a zero row: adding
    // its 0 leaves the sum's bits as they are, so its root is skipped
    if (d2 > m * m * 1.000001f) continue;
    const float h = relu(m - sqrtf(d2));
    cacc += h * h;
  }

  // ---- the lane's partial sums, in thread order ----
  part[t * lanes + lane] = cacc;
  __syncthreads();
  if (t == 0 && valid) {
    float c = 0.f;
    for (int u = 0; u < a.T; ++u) c += part[u * lanes + lane];
    cost_out[n] = 0.5f * c;
  }
}

}  // namespace

// q (D, N) -> cost (N); ip (n_ints) / fp (n_floats) the packed parameters
// (pack_cost_params), lanes and threads_per_lane the block's shape and
// smem_bytes its dynamic shared memory (cost_launch_config), grid the
// scene's grid table (null without grids).  Returns a CUDA error code
// (cudaErrorInvalidValue for a block past kMaxThreads).
extern "C" int trt_cost_launch(const float* q, float* cost, int N, int D,
                               int lanes, int threads_per_lane, int smem_bytes,
                               const int* ip, int n_ints, const float* fp,
                               int n_floats, const void* grid, void* stream) {
  if (lanes < 1 || threads_per_lane < 1 ||
      lanes * threads_per_lane > kMaxThreads)
    return static_cast<int>(cudaErrorInvalidValue);
  if (smem_bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        cost_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 block(lanes, threads_per_lane);
  cost_kernel<<<(N + lanes - 1) / lanes, block, smem_bytes,
                static_cast<cudaStream_t>(stream)>>>(
      q, cost, N, D, ip, n_ints, fp, n_floats,
      static_cast<const float4*>(grid));
  return static_cast<int>(cudaGetLastError());
}
