// Fused Gauss-Newton obstacle terms for one kinematic robot in a scene of
// analytic primitives and precomputed SDF grids: FK -> collision points ->
// analytic point Jacobians -> scene SDF + gradient -> hinge residuals ->
// g = sum r Jr, Hqq = Jr^T Jr, cost = 0.5 sum r^2, all unscaled by the
// collision weight.  (The same rows' cost alone is cost.cu's.)
//
// terms_kernel replaces the TPU kernel torch_robotics_tpu/ops/pallas_terms.py
// (obstacle_terms_pallas_factory, the pallas_call in _build_terms); its
// plain PyTorch version is obstacle_terms_lanes_factory in
// torch_robotics_tpu_torch/ops/lanes_fk.py.  A precomputed SDF grid in the
// scene is looked up in-kernel (kin_scene.cuh: grid_sdf, one 16-byte load
// per object point and grid), where the TPU kernel took rows gathered
// before it by XLA (Mosaic has no vector gather; _grid_extras_fn).
//
// What bounds it on the H100: bytes.  For the Panda in EnvSpheres3D on
// the MPC path's waypoints the function needs ~2.4k float ops a lane (FK,
// the SDF of 5 points against 10 spheres, and Jacobian and Hessian work
// only for the ~9% of rows that are active, over the joints that move
// their points) against 256 bytes of memory traffic (q in; g, the full
// Hqq and the cost out): at N = 65536 ~2.3 us of float32 work and ~5.0 us
// of HBM traffic.  The Panda holding a grasped box has 104 rows (19 object
// SDF, 19 workspace, 66 pairs), 4.4% of them active on the main path's q
// and no pair row active on it; in a grid scene each object point also
// reads one 16-byte table row a grid, a dependent load of one 32-byte
// sector from a table larger than the L2.
//
// Design, against what held the earlier kernel back (every row's Jacobian
// built and all 28 Hessian entries added, active or not; the link
// transforms, 1.6 KB a thread, in local memory; every model and scene
// entry a dependent load from device memory):
//   - the block copies the packed parameters into shared memory with
//     16-byte loads (the cost kernel's packing, pack_cost_params, with the
//     points' joint masks after it: pack_terms_params), and its lanes' q;
//     FK and the SDF read shared memory, a step's, an object's or a
//     sphere's data as 16-byte records, the same address in every thread
//     of a warp;
//   - one thread a lane runs the FK chain in registers (cost.cuh:
//     joint_transform, compose, sincos_rn): each step composes the
//     previous step's transform with its joint's, a transform that a
//     later, non-adjacent step reads goes to shared memory, and the step
//     writes the world position of each collision point on its link (a
//     grasped point at R o + t, kin_scene.cuh: offset_point) and, for a
//     joint, its world axis (zeroed outside the clamp) and origin, all
//     lane-minor ([(3 p + k) * lanes + lane]: no bank conflicts).  The
//     order of operations is fk_links', so points and axes are its bits;
//   - a row first takes its value alone (the object SDF by cost.cuh's
//     scene_sdf_value, a pair's distance only where d^2 <= m^2 (1 + 1e-6),
//     as cost.cu); only a row with r > 0 (or NaN) takes its gradient
//     (scene_sdf_grad), its Jacobian columns over the joints that move its
//     points, and adds r^2, r Jr and Jr^T Jr.  An inactive row would add
//     +-0 to g and Hqq and 0 to the cost, so the active rows, summed in
//     the rows' order, give the bits of summing every row;
//   - the g / Hqq accumulators are registers (the kernel is templated on
//     the number of joints D) and nothing is indexed by a run-time number
//     in a per-thread array, so no local memory.
// terms_launch_config in ops/terms_kernel.py picks the lanes a block from
// the packed sizes.
#include <cuda_runtime.h>
#include <math.h>

#include "cost.cuh"

namespace {

using namespace trt;

constexpr int kMaxLanes = 128;    // threads (lanes) a block, at most
// 4 blocks of 128 an SM: ptxas keeps a thread within 128 registers, and
// without the bound it spilled at D = 1, 2, 4 and 6 (16-32 bytes)
constexpr int kMinBlocks = 4;

template <int D>
__global__ void __launch_bounds__(kMaxLanes, kMinBlocks)
terms_kernel(const float* __restrict__ q, float* __restrict__ g_out,
             float* __restrict__ h_out, float* __restrict__ cost_out, int N,
             const int* __restrict__ ip, int n_ints,
             const float* __restrict__ fp, int n_floats,
             const float4* __restrict__ grid) {
  extern __shared__ __align__(16) float smem[];
  const int lanes = blockDim.x, lane = threadIdx.x;
  const int n = blockIdx.x * lanes + lane;
  const bool valid = n < N;

  // ---- the parameters and the block's q (D, lanes) into shared memory ----
  int* ism = reinterpret_cast<int*>(smem);
  float* fsm = smem + round4(n_ints);
  float* qs = fsm + round4(n_floats);
#pragma unroll
  for (int j = 0; j < D; ++j)
    qs[j * lanes + lane] = valid ? q[(size_t)j * N + n] : 0.f;
  copy_words(ip, ism, n_ints, lane, lanes);
  copy_words(fp, fsm, n_floats, lane, lanes);
  __syncthreads();
  // the cost kernel's layout (cost.cuh; its base pose and row cuts are not
  // read here), then anc_of[P], the joints that move each point as a bit mask
  const CostLayout a = parse_layout(ism, fsm, grid);
  const int* anc_of = ism + n_ints - a.P;
  float* zo = qs + D * lanes;            // [6 D][lanes]: axis z_j, origin o_j
  float* pts = zo + 6 * D * lanes;       // [3 P][lanes]
  float* slots = pts + 3 * a.P * lanes;  // [12 n_slots][lanes]
  // a joint that moves no point keeps a zero axis (its columns are masked)
#pragma unroll
  for (int k = 0; k < 6 * D; ++k) zo[k * lanes + lane] = 0.f;

  // ---- FK in registers -> joint axes and origins, world points ----
  unsigned prism = 0;                    // bit j: joint j is prismatic
  {
    float R[9], tv[3];  // the previous step's world transform
    for (int s = 0; s < a.S; ++s) {
      const int4 i0 = reinterpret_cast<const int4*>(a.step_i)[2 * s];
      const int4 i1 = reinterpret_cast<const int4*>(a.step_i)[2 * s + 1];
      const float4* fr = reinterpret_cast<const float4*>(a.step_f) + 5 * s;
      const float4 f0 = fr[0], f1 = fr[1], f2 = fr[2], f3 = fr[3];
      const float F[9] = {f0.x, f0.y, f0.z, f0.w, f1.x,
                          f1.y, f1.z, f1.w, f2.x};
      const float axis[3] = {f3.x, f3.y, f3.z};
      const float lo = f3.w, hi = fr[4].x;
      float tr[3] = {f2.y, f2.z, f2.w};
      float Rl[9];
      const float qj = i0.y >= 0 ? qs[i0.y * lanes + lane] : 0.f;
      joint_transform(i0.x, F, axis, lo, hi, qj, Rl, tr);
      if (i0.z == -1) {  // the root, at the identity base: as fk_links, its
                         // local transform (no product with the base)
#pragma unroll
        for (int k = 0; k < 9; ++k) R[k] = Rl[k];
#pragma unroll
        for (int k = 0; k < 3; ++k) tv[k] = tr[k];
      } else {
        if (i0.z >= 0) {  // a stored transform
#pragma unroll
          for (int k = 0; k < 9; ++k)
            R[k] = slots[(12 * i0.z + k) * lanes + lane];
#pragma unroll
          for (int k = 0; k < 3; ++k)
            tv[k] = slots[(12 * i0.z + 9 + k) * lanes + lane];
        }
        float Rn[9], tn[3];
        compose(R, tv, Rl, tr, Rn, tn);
#pragma unroll
        for (int k = 0; k < 9; ++k) R[k] = Rn[k];
#pragma unroll
        for (int k = 0; k < 3; ++k) tv[k] = tn[k];
      }
      if (i0.w >= 0) {
#pragma unroll
        for (int k = 0; k < 9; ++k)
          slots[(12 * i0.w + k) * lanes + lane] = R[k];
#pragma unroll
        for (int k = 0; k < 3; ++k)
          slots[(12 * i0.w + 9 + k) * lanes + lane] = tv[k];
      }
      if (i0.y >= 0) {  // joint i0.y: world axis (0 outside the clamp)
        const float in_lim = (qj >= lo && qj <= hi) ? 1.f : 0.f;
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          zo[(6 * i0.y + k) * lanes + lane] =
              (R[3 * k] * axis[0] + R[3 * k + 1] * axis[1] +
               R[3 * k + 2] * axis[2]) * in_lim;
          zo[(6 * i0.y + 3 + k) * lanes + lane] = tv[k];
        }
        prism |= (i0.x == kPrismatic ? 1u : 0u) << i0.y;
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
  // every array above is this thread's own lane: no barrier before the rows

  auto point = [&](int p, float x[3]) {
#pragma unroll
    for (int k = 0; k < 3; ++k) x[k] = pts[(3 * p + k) * lanes + lane];
  };

  // Jacobian column j of a point at world position x whose joint mask is
  // anc (zero unless joint j moves it)
  auto jac = [&](unsigned anc, const float x[3], int j, float out[3]) {
    if (!((anc >> j) & 1)) {
      out[0] = out[1] = out[2] = 0.f;
      return;
    }
    const float z[3] = {zo[(6 * j) * lanes + lane],
                        zo[(6 * j + 1) * lanes + lane],
                        zo[(6 * j + 2) * lanes + lane]};
    if ((prism >> j) & 1) {
      out[0] = z[0]; out[1] = z[1]; out[2] = z[2];
      return;
    }
    const float d0 = x[0] - zo[(6 * j + 3) * lanes + lane],
                d1 = x[1] - zo[(6 * j + 4) * lanes + lane],
                d2 = x[2] - zo[(6 * j + 5) * lanes + lane];
    out[0] = z[1] * d2 - z[2] * d1;
    out[1] = z[2] * d0 - z[0] * d2;
    out[2] = z[0] * d1 - z[1] * d0;
  };

  float gacc[D], hacc[D * (D + 1) / 2], cacc = 0.f;
#pragma unroll
  for (int j = 0; j < D; ++j) gacc[j] = 0.f;
#pragma unroll
  for (int j = 0; j < D * (D + 1) / 2; ++j) hacc[j] = 0.f;

  auto add_row = [&](float r, const float* Jr) {
    cacc += r * r;
#pragma unroll
    for (int i = 0; i < D; ++i) gacc[i] += r * Jr[i];
    int t = 0;
#pragma unroll
    for (int i = 0; i < D; ++i)
#pragma unroll
      for (int j = i; j < D; ++j) hacc[t++] += Jr[i] * Jr[j];
  };

  // an active point row r with Jr_j = -[r > 0] grad . J[p][j]
  auto hinge = [&](int p, const float x[3], float r, const float grad[3]) {
    const float act = r > 0.f ? 1.f : 0.f;
    const unsigned anc = static_cast<unsigned>(anc_of[p]);
    float Jr[D];
#pragma unroll
    for (int j = 0; j < D; ++j) {
      float c[3];
      jac(anc, x, j, c);
      Jr[j] = -act * (grad[0] * c[0] + grad[1] * c[1] + grad[2] * c[2]);
    }
    add_row(r, Jr);
  };

  // ---- object rows: scene SDF hinge per object point (NOBJ counts the
  // scene's analytic objects and grids alike) ----
  const int n_sdf = a.NOBJ > 0 ? a.NO : 0;
  for (int mi = 0; mi < n_sdf; ++mi) {
    const int p = a.obj_pt[mi];
    float x[3];
    point(p, x);
    const float r = relu(a.obj_thresh[mi] - scene_sdf_value(a, x));
    if (r <= 0.f) continue;
    float grad[3];
    scene_sdf_grad(a, x, grad);
    hinge(p, x, r, grad);
  }

  // ---- workspace rows: min-face distance, first minimal face wins ----
  for (int mi = 0; mi < a.NO; ++mi) {
    const int p = a.obj_pt[mi];
    float x[3];
    point(p, x);
    const float faces[6] = {x[0] - a.ws_min[0], x[1] - a.ws_min[1],
                            x[2] - a.ws_min[2], a.ws_max[0] - x[0],
                            a.ws_max[1] - x[1], a.ws_max[2] - x[2]};
    float val = faces[0];
#pragma unroll
    for (int f = 1; f < 6; ++f) val = fminf(val, faces[f]);
    const float r = relu(a.obj_thresh[mi] - val);
    if (r <= 0.f) continue;
    int fi = 5;  // the first face f < 5 with faces[f] <= val, else 5
#pragma unroll
    for (int f = 4; f >= 0; --f) fi = faces[f] <= val ? f : fi;
    float grad[3];
#pragma unroll
    for (int k = 0; k < 3; ++k)
      grad[k] = fi == k ? 1.f : (fi == k + 3 ? -1.f : 0.f);
    hinge(p, x, r, grad);
  }

  // ---- self-collision pair rows ----
  for (int k = 0; k < a.K; ++k) {
    const int pa = a.pair_a[k], pb = a.pair_b[k];
    float xa[3], xb[3];
    point(pa, xa);
    point(pb, xb);
    const float diff[3] = {xa[0] - xb[0], xa[1] - xb[1], xa[2] - xb[2]};
    const float d2 = diff[0] * diff[0] + diff[1] * diff[1] + diff[2] * diff[2];
    const float m = a.pair_margin[k];
    // d2 >= m^2 (1 + 1e-6) > m^2 gives sqrtf(d2) >= m, a zero row
    if (d2 > m * m * 1.000001f) continue;
    const float dist = d2 > 0.f ? sqrtf(d2) : 0.f;
    const float r = relu(m - dist);
    if (r <= 0.f) continue;
    const float inv = d2 > 0.f ? 1.f / fmaxf(dist, 1e-9f) : 0.f;
    const float u[3] = {diff[0] * inv, diff[1] * inv, diff[2] * inv};
    const float act = r > 0.f ? 1.f : 0.f;
    const unsigned anc_a = static_cast<unsigned>(anc_of[pa]),
                   anc_b = static_cast<unsigned>(anc_of[pb]);
    float Jr[D];
#pragma unroll
    for (int j = 0; j < D; ++j) {
      float ca[3], cb[3];
      jac(anc_a, xa, j, ca);
      jac(anc_b, xb, j, cb);
      Jr[j] = -act * (u[0] * (ca[0] - cb[0]) + u[1] * (ca[1] - cb[1]) +
                      u[2] * (ca[2] - cb[2]));
    }
    add_row(r, Jr);
  }

  // ---- outputs: unscaled g (D, N), Hqq (D, D, N), cost (N) ----
  if (!valid) return;
#pragma unroll
  for (int j = 0; j < D; ++j) g_out[(size_t)j * N + n] = gacc[j];
  int t = 0;
#pragma unroll
  for (int i = 0; i < D; ++i)
#pragma unroll
    for (int j = i; j < D; ++j) {
      const float v = hacc[t++];
      h_out[((size_t)i * D + j) * N + n] = v;
      h_out[((size_t)j * D + i) * N + n] = v;
    }
  cost_out[n] = 0.5f * cacc;
}

template <int D>
cudaError_t launch(const float* q, float* g, float* h, float* cost, int N,
                   int lanes, int smem, const int* ip, int n_ints,
                   const float* fp, int n_floats, const float4* grid,
                   cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        terms_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
  }
  terms_kernel<D><<<(N + lanes - 1) / lanes, lanes, smem, stream>>>(
      q, g, h, cost, N, ip, n_ints, fp, n_floats, grid);
  return cudaGetLastError();
}

}  // namespace

// q (D, N) -> g (D, N), h (D, D, N), cost (N); ip (n_ints) / fp (n_floats)
// the packed parameters (pack_terms_params), lanes the block's threads and
// smem_bytes its dynamic shared memory (terms_launch_config), grid the
// scene's grid table ((C, 4) float32, null for a scene without grids).
// Returns a CUDA error code (cudaErrorInvalidValue for D outside 1..8 or a
// block of more than kMaxLanes threads).
extern "C" int trt_terms_launch(const float* q, float* g, float* h,
                                float* cost, int N, int D, int lanes,
                                int smem_bytes, const int* ip, int n_ints,
                                const float* fp, int n_floats,
                                const void* grid, void* stream) {
  if (lanes < 1 || lanes > kMaxLanes)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float4* t = static_cast<const float4*>(grid);
#define TRT_D(d)                                                        \
  case d:                                                               \
    return launch<d>(q, g, h, cost, N, lanes, smem_bytes, ip, n_ints, fp, \
                     n_floats, t, s);
  switch (D) {
    TRT_D(1) TRT_D(2) TRT_D(3) TRT_D(4) TRT_D(5) TRT_D(6) TRT_D(7) TRT_D(8)
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef TRT_D
}
