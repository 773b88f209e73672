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
// points' SDF against 10 spheres, 20 rows), ~5k for the Panda holding a
// box (23 points, 104 rows) and ~7.8k for config 4 (three FK chains, 16
// points' SDF, 143 rows): the float work takes 3-5x the memory traffic at
// 67 TFLOP/s and 3.35 TB/s.  A grid scene adds one 16-byte row a point
// and grid from a table larger than the L2.
//
// Design.  The block copies its lanes' q and the packed parameters
// (pack_cost_kernel_params: the members' FK steps, points, rows, a row
// schedule, the scene, then K8's own sections) into shared memory, every
// load issued before the first store; FK and the rows read them there as
// 16-byte records, the same address in every thread of a warp.  The lanes
// a block are a template argument (32, 64, 96 or 128), so a lane's word k
// of a lane-minor array is one address and an immediate offset.  Measured
// on the H100 before this design (per-warp clock64 spans and stage cuts),
// the Panda's warps spent ~30% in the block's prologue and ~45% in FK,
// the grasped Panda's object rows waited on one dependent min chain a
// point, and every pair row made nine shared loads; so:
//   - phase 1: thread (lane, m), m < members, runs member m's FK chain in
//     registers.  Each step's class (packed) drops the work whose result
//     is known exactly: a revolute or continuous joint about +-x, +-y or
//     +-z builds only the nonzero entries of its rotation and of F Rj, in
//     the order of the terms that remain; a parent rotation that is
//     exactly the identity gives R = Rl, t = tr + tp; a fixed joint with
//     F = I keeps its parent's R; a step whose R nothing reads computes t
//     alone.  Every product dropped is by an exact zero or one, so the
//     world transforms are the general chain's (cost.cuh: joint_transform,
//     compose), bit for bit.  Only a transform that a later, non-adjacent
//     step reads (a branching tree) goes to shared memory, with the world
//     position of each collision point the step carries (lane-minor,
//     [(3 p + k) * lanes + lane]: no bank conflicts), a grasped object's
//     points at R o + t of their link's world transform (kin_scene.cuh:
//     offset_point).  The member's base pose is the root's parent, so a
//     single robot (identity base) gets fk_links' points;
//   - phase 2: thread (lane, t) sums the rows [cuts[t], cuts[t + 1]) of the
//     lane in the rows' order (object SDF rows, workspace rows, pairs), a
//     static cut the wrapper balances by operation count; the T partial
//     sums of a lane are added in thread order, so a lane's bits depend
//     neither on the batch nor on the lanes a block.  A single robot takes
//     one thread a lane.  Object rows go four points at a time, the last
//     one to three of a range together (cost.cuh: scene_sdf_values, which
//     K1 runs at one point as scene_sdf_value): one load of a sphere
//     serves them all, their min chains are independent, and a grid's
//     cell rows are in flight together.  A pair row is one 16-byte
//     record (a, b, margin, guard = m^2 (1 + 1e-6) rounded as the float
//     expression), four distances at a time; their hinges are added in
//     row order;
//   - a precomputed SDF grid is looked up in-kernel (kin_scene.cuh:
//     grid_sdf), one 16-byte load from the grid table in device memory
//     per object point and grid (measured: the gathers do not set the
//     grid kernel's time);
//   - nothing is indexed by a run-time number in a per-thread array, and
//     sincosf's fast path is copied without its large-argument branch
//     (cost.cuh: sincos_rn), so no local memory.
// Tried on the H100 and not kept (PERF.md, K8's findings): T = 2 or 4
// threads a lane for a single robot, 80 registers, blocks that stay
// resident over tiles of lanes (with and without the next tile's q staged
// by cp.async), the next step's sin and cos taken a step early, 2 or 8
// object rows a pass, a pair's point kept in registers from the row
// before.
// The wrapper's cost_launch_config picks the lanes a block and the
// threads a lane (T) from the packed sizes.
#include <cuda_runtime.h>
#include <math.h>

#include <type_traits>

#include "cost.cuh"

namespace {

using namespace trt;

constexpr int kMaxThreads = 256;  // lanes * threads a lane, at most
// 4 blocks of 256 threads an SM: ptxas keeps a thread within 64 registers,
// with no spill, and that occupancy ran faster than 80 registers
constexpr int kMinBlocks = 4;
constexpr int kBatch = 4;         // object rows a pass over the scene
// q columns a thread loads: D <= 8 T (pack_cost_params: at most 8 joints a
// member and at least a thread a member)
constexpr int kMaxQ = 8;

// A step's class (K8's step section, pack_cost_kernel_params): bits 0-1
// the coordinate axis of a revolute or continuous joint (1 x, 2 y, 3 z; 0
// any other joint), bit 2 that axis negative, bit 3 a later step or an
// offset point reads the step's R, bit 4 the parent's rotation is exactly
// the identity, bit 5 the joint's rotation is exactly F = I (a fixed or
// prismatic joint).
constexpr int kAxisMask = 3, kAxisNeg = 4, kKeepR = 8, kIdentityParent = 16,
              kIdentityF = 32;

// K8's own sections, located by the header's ints 14 (step classes) and
// 15 (pair records, 16-byte aligned).
struct CostRecords {
  const int* step_cls;
  const int4* pair_rec;  // (a, b, margin bits, guard bits)
};

// cost.cuh's copy_words for the two packed buffers at once: each
// thread's 16-byte loads of both issue before its stores (a store waits
// for its load, and a thread issues in order).
__device__ __forceinline__ void copy_params(const int* __restrict__ ip,
                                            int* __restrict__ ism, int n_ints,
                                            const float* __restrict__ fp,
                                            float* __restrict__ fsm,
                                            int n_floats, int tid, int nthr) {
  const bool al = ((reinterpret_cast<uintptr_t>(ip) |
                    reinterpret_cast<uintptr_t>(fp)) & 15) == 0;
  const int ni = al ? n_ints >> 2 : 0, nf = al ? n_floats >> 2 : 0;
  for (int k = tid; k < max(ni, nf); k += nthr) {
    int4 vi;
    float4 vf;
    if (k < ni) vi = __ldg(reinterpret_cast<const int4*>(ip) + k);
    if (k < nf) vf = __ldg(reinterpret_cast<const float4*>(fp) + k);
    if (k < ni) reinterpret_cast<int4*>(ism)[k] = vi;
    if (k < nf) reinterpret_cast<float4*>(fsm)[k] = vf;
  }
  for (int k = 4 * ni + tid; k < n_ints; k += nthr) ism[k] = ip[k];
  for (int k = 4 * nf + tid; k < n_floats; k += nthr) fsm[k] = fp[k];
}

// a0 b0 + a1 b1 as the general product's contraction leaves it when its
// third term is an exact zero: the product the contraction rounds alone
// depends on where that zero sits (kLast: the third term; else the first
// or second), so each case keeps the general expression's bits.
__device__ __forceinline__ float dot2_zero_last(float a0, float b0, float a1,
                                                float b1) {
  return __fmaf_rn(a0, b0, __fmul_rn(a1, b1));
}
__device__ __forceinline__ float dot2_zero_before(float a0, float b0,
                                                  float a1, float b1) {
  return __fmaf_rn(a1, b1, __fmul_rn(a0, b0));
}

// The local transform of a revolute or continuous joint about a signed
// coordinate axis: joint_transform's Rodrigues matrix Rj and F Rj with the
// exact zeros and ones of that axis taken out (Rj = I + s K + (1 - c) K^2
// has, for axis e_k, ones and zeros off the plane of rotation, c' = 1 -
// (1 - c) in it and +-s across it).
__device__ __forceinline__ void axis_joint(int cls, int jt, const float* F,
                                           float lo, float hi, float q,
                                           float Rl[9]) {
  float qi = q;
  if (jt == kRevolute) qi = fminf(fmaxf(qi, lo), hi);
  float s, c;
  sincos_rn(qi, &s, &c);
  const float oc = 1.f - c;
  const float C = 1.f - oc, S = (cls & kAxisNeg) ? -s : s;
  const int k = cls & kAxisMask;
  if (k == 3) {         // z: Rj = [C -S 0; S C 0; 0 0 1]
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      Rl[3 * i] = dot2_zero_last(F[3 * i], C, F[3 * i + 1], S);
      Rl[3 * i + 1] = dot2_zero_last(F[3 * i], -S, F[3 * i + 1], C);
      Rl[3 * i + 2] = F[3 * i + 2];
    }
  } else if (k == 2) {  // y: Rj = [C 0 S; 0 1 0; -S 0 C]
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      Rl[3 * i] = dot2_zero_before(F[3 * i], C, F[3 * i + 2], -S);
      Rl[3 * i + 1] = F[3 * i + 1];
      Rl[3 * i + 2] = dot2_zero_before(F[3 * i], S, F[3 * i + 2], C);
    }
  } else {              // x: Rj = [1 0 0; 0 C -S; 0 S C]
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      Rl[3 * i] = F[3 * i];
      Rl[3 * i + 1] = dot2_zero_before(F[3 * i + 1], C, F[3 * i + 2], S);
      Rl[3 * i + 2] = dot2_zero_before(F[3 * i + 1], -S, F[3 * i + 2], C);
    }
  }
}

// kLanes lanes a block (blockDim.x), a compile-time stride: a lane's word
// k of a lane-minor array is at [k * kLanes + lane], one address and
// immediate offsets.
template <int kLanes>
__global__ void __launch_bounds__(kMaxThreads, kMinBlocks)
cost_kernel(const float* __restrict__ q, float* __restrict__ cost_out, int N,
            int D, const int* __restrict__ ip, int n_ints,
            const float* __restrict__ fp, int n_floats,
            const float4* __restrict__ grid) {
  extern __shared__ __align__(16) float smem[];
  constexpr int lanes = kLanes;
  const int lane = threadIdx.x, t = threadIdx.y;
  const int tid = t * lanes + lane, nthr = lanes * blockDim.y;
  const int n = blockIdx.x * lanes + lane;
  const bool valid = n < N;

  // ---- the block's q (D, lanes) and the parameters into shared memory ----
  int* ism = reinterpret_cast<int*>(smem);
  float* fsm = smem + round4(n_ints);
  float* qs = fsm + round4(n_floats);
  // every load in flight before the first store (a store waits for its
  // load, and the loads issue in order): at most kMaxQ q a thread
  float qv[kMaxQ];
#pragma unroll
  for (int k = 0; k < kMaxQ; ++k) {
    const int j = t + k * blockDim.y;
    qv[k] = j < D && valid ? q[(size_t)j * N + n] : 0.f;
  }
  copy_params(ip, ism, n_ints, fp, fsm, n_floats, tid, nthr);
#pragma unroll
  for (int k = 0; k < kMaxQ; ++k) {
    const int j = t + k * blockDim.y;
    if (j < D) qs[j * lanes + lane] = qv[k];
  }
  __syncthreads();
  const CostLayout a = parse_layout(ism, fsm, grid);
  const CostRecords k8{ism + ism[14],
                       reinterpret_cast<const int4*>(ism + ism[15])};
  // this lane's columns: q, points (3 words each), stored transforms (12)
  const float* const ql = qs + lane;
  float* const pts = qs + D * lanes + lane;
  float* const slots = pts + 3 * a.P * lanes;
  float* const part = slots + 12 * a.n_slots * lanes - lane;

  // ---- phase 1: member t's FK chain in registers -> world points ----
  if (t < a.n_mem) {
    float R[9], tv[3];  // the previous step's world transform
    for (int s = a.mem_step[t]; s < a.mem_step[t + 1]; ++s) {
      const int4 i0 = reinterpret_cast<const int4*>(a.step_i)[2 * s];
      const int4 i1 = reinterpret_cast<const int4*>(a.step_i)[2 * s + 1];
      const int cls = k8.step_cls[s];
      const float4* fr = reinterpret_cast<const float4*>(a.step_f) + 5 * s;
      const float4 f0 = fr[0], f1 = fr[1], f2 = fr[2];
      const float F[9] = {f0.x, f0.y, f0.z, f0.w, f1.x,
                          f1.y, f1.z, f1.w, f2.x};
      float tr[3] = {f2.y, f2.z, f2.w};
      const float qj = i0.y >= 0 ? ql[i0.y * lanes] : 0.f;
      float Rl[9];
      const float4 f3 = fr[3];
      if (cls & kAxisMask) {
        axis_joint(cls, i0.x, F, f3.w, fr[4].x, qj, Rl);
      } else {
        const float axis[3] = {f3.x, f3.y, f3.z};
        joint_transform(i0.x, F, axis, f3.w, fr[4].x, qj, Rl, tr);
      }
      const int src = i0.z;
      float tp[3];  // the parent's translation, and its rotation into R
      if (src == -1) {  // the root's parent: the member's base pose
#pragma unroll
        for (int k = 0; k < 3; ++k) tp[k] = a.base_t[3 * t + k];
        if (!(cls & kIdentityParent)) {
#pragma unroll
          for (int k = 0; k < 9; ++k) R[k] = a.base_R[9 * t + k];
        }
      } else if (src >= 0) {  // a stored transform
#pragma unroll
        for (int k = 0; k < 3; ++k)
          tp[k] = slots[(12 * src + 9 + k) * lanes];
        if (!(cls & kIdentityParent)) {
#pragma unroll
          for (int k = 0; k < 9; ++k)
            R[k] = slots[(12 * src + k) * lanes];
        }
      } else {
#pragma unroll
        for (int k = 0; k < 3; ++k) tp[k] = tv[k];
      }
      if (cls & kIdentityParent) {  // R = I Rl, t = I tr + tp, exactly
#pragma unroll
        for (int k = 0; k < 9; ++k) R[k] = Rl[k];
#pragma unroll
        for (int k = 0; k < 3; ++k) tv[k] = tr[k] + tp[k];
      } else {  // compose's t = R tr + tp, and R Rl unless kept or unread
#pragma unroll
        for (int k = 0; k < 3; ++k)
          tv[k] = R[3 * k] * tr[0] + R[3 * k + 1] * tr[1] +
                  R[3 * k + 2] * tr[2] + tp[k];
        if ((cls & (kKeepR | kIdentityF)) == kKeepR) {
          float Rn[9];
          matmul3(R, Rl, Rn);
#pragma unroll
          for (int k = 0; k < 9; ++k) R[k] = Rn[k];
        }
      }
      const int sl = i0.w;
      if (sl >= 0) {
#pragma unroll
        for (int k = 0; k < 9; ++k) slots[(12 * sl + k) * lanes] = R[k];
#pragma unroll
        for (int k = 0; k < 3; ++k)
          slots[(12 * sl + 9 + k) * lanes] = tv[k];
      }
      const int first_off = i1.y - i1.z;
      for (int i = i1.x; i < first_off; ++i) {  // the link's origin
        const int p = a.pt_list[i];
#pragma unroll
        for (int k = 0; k < 3; ++k) pts[(3 * p + k) * lanes] = tv[k];
      }
      for (int i = first_off; i < i1.y; ++i) {  // offset points: R o + t
        const float4 o4 =
            reinterpret_cast<const float4*>(a.offsets)[i1.w + i - first_off];
        const float o[3] = {o4.x, o4.y, o4.z};
        float x[3];
        offset_point(R, tv, o, x);
        const int p = a.pt_list[i];
#pragma unroll
        for (int k = 0; k < 3; ++k) pts[(3 * p + k) * lanes] = x[k];
      }
    }
  }
  __syncthreads();

  // ---- phase 2: rows [cuts[t], cuts[t + 1]) of the lane, in row order ----
  auto point = [&](int p, float x[3]) {
#pragma unroll
    for (int k = 0; k < 3; ++k) x[k] = pts[(3 * p + k) * lanes];
  };
  float cacc = 0.f;
  const int n_sdf = a.NOBJ > 0 ? a.NO : 0;  // NOBJ counts grids too
  const int end = a.cuts[t + 1];
  int r = a.cuts[t];
  const int sdf_end = min(end, n_sdf);
  // object rows: NB points a pass over the scene, 4 at a time, then the
  // last 1-3 of the range together
  auto sdf_rows = [&](auto nb) {
    constexpr int NB = decltype(nb)::value;
    int p[NB];
    float v[NB];
#pragma unroll
    for (int k = 0; k < NB; ++k) p[k] = a.obj_pt[r + k];
    scene_sdf_values<NB>(a, point, p, v);
#pragma unroll
    for (int k = 0; k < NB; ++k) {
      const float h = relu(a.obj_thresh[r + k] - v[k]);
      cacc += h * h;
    }
  };
  for (; r + kBatch <= sdf_end; r += kBatch)
    sdf_rows(std::integral_constant<int, kBatch>());
  switch (sdf_end - r) {
    case 3: sdf_rows(std::integral_constant<int, 3>()); break;
    case 2: sdf_rows(std::integral_constant<int, 2>()); break;
    case 1: sdf_rows(std::integral_constant<int, 1>()); break;
  }
  r = max(r, sdf_end);
  const float lo0 = a.ws_min[0], lo1 = a.ws_min[1], lo2 = a.ws_min[2],
              hi0 = a.ws_max[0], hi1 = a.ws_max[1], hi2 = a.ws_max[2];
  for (; r < min(end, n_sdf + a.NO); ++r) {  // workspace rows: min face
    const int mi = r - n_sdf;
    float x[3];
    point(a.obj_pt[mi], x);
    float val = x[0] - lo0;
    val = fminf(val, x[1] - lo1);
    val = fminf(val, x[2] - lo2);
    val = fminf(val, hi0 - x[0]);
    val = fminf(val, hi1 - x[1]);
    val = fminf(val, hi2 - x[2]);
    const float h = relu(a.obj_thresh[mi] - val);
    cacc += h * h;
  }
  // pair rows, four distances at a time: d2 > guard = m^2 (1 + 1e-6) >
  // m^2 gives sqrtf(d2) >= m, a zero row, and adding its 0 leaves the
  // sum's bits as they are, so its root is skipped
  const int4* prec = k8.pair_rec - n_sdf - a.NO;
  auto pair_d2 = [&](const int4& rec) {
    float xa[3], xb[3];
    point(rec.x, xa);
    point(rec.y, xb);
    const float diff[3] = {xa[0] - xb[0], xa[1] - xb[1], xa[2] - xb[2]};
    return diff[0] * diff[0] + diff[1] * diff[1] + diff[2] * diff[2];
  };
  auto pair_add = [&](const int4& rec, float d2) {
    if (d2 > __int_as_float(rec.w)) return;
    const float h = relu(__int_as_float(rec.z) - sqrtf(d2));
    cacc += h * h;
  };
  for (; r + kBatch <= end; r += kBatch) {
    int4 rec[kBatch];
    float d2[kBatch];
#pragma unroll
    for (int k = 0; k < kBatch; ++k) rec[k] = prec[r + k];
#pragma unroll
    for (int k = 0; k < kBatch; ++k) d2[k] = pair_d2(rec[k]);
#pragma unroll
    for (int k = 0; k < kBatch; ++k) pair_add(rec[k], d2[k]);
  }
  for (; r < end; ++r) pair_add(prec[r], pair_d2(prec[r]));

  // ---- the lane's partial sums, in thread order ----
  part[t * lanes + lane] = cacc;
  __syncthreads();
  if (t == 0 && valid) {
    float c = 0.f;
    for (int u = 0; u < a.T; ++u) c += part[u * lanes + lane];
    cost_out[n] = 0.5f * c;
  }
}


template <int kLanes>
int launch_cost(const float* q, float* cost, int N, int D,
                int threads_per_lane, int smem_bytes, const int* ip,
                int n_ints, const float* fp, int n_floats, const void* grid,
                cudaStream_t stream) {
  if (smem_bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        cost_kernel<kLanes>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem_bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 block(kLanes, threads_per_lane);
  cost_kernel<kLanes><<<(N + kLanes - 1) / kLanes, block, smem_bytes,
                        stream>>>(q, cost, N, D, ip, n_ints, fp, n_floats,
                                  static_cast<const float4*>(grid));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q (D, N) -> cost (N); ip (n_ints) / fp (n_floats) the packed parameters
// (pack_cost_kernel_params), lanes (32, 64, 96 or 128) and
// threads_per_lane the block's shape and smem_bytes its dynamic shared
// memory (cost_launch_config), grid the scene's grid table (null without
// grids).  Returns a CUDA error code (cudaErrorInvalidValue for another
// lane count, a block past kMaxThreads or more than kMaxQ q a thread).
extern "C" int trt_cost_launch(const float* q, float* cost, int N, int D,
                               int lanes, int threads_per_lane, int smem_bytes,
                               const int* ip, int n_ints, const float* fp,
                               int n_floats, const void* grid, void* stream) {
  if (threads_per_lane < 1 || lanes * threads_per_lane > kMaxThreads ||
      D > kMaxQ * threads_per_lane)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (lanes) {
    case 32:
      return launch_cost<32>(q, cost, N, D, threads_per_lane, smem_bytes, ip,
                             n_ints, fp, n_floats, grid, st);
    case 64:
      return launch_cost<64>(q, cost, N, D, threads_per_lane, smem_bytes, ip,
                             n_ints, fp, n_floats, grid, st);
    case 96:
      return launch_cost<96>(q, cost, N, D, threads_per_lane, smem_bytes, ip,
                             n_ints, fp, n_floats, grid, st);
    case 128:
      return launch_cost<128>(q, cost, N, D, threads_per_lane, smem_bytes,
                              ip, n_ints, fp, n_floats, grid, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
