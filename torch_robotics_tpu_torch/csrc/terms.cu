// Fused Gauss-Newton obstacle terms for one kinematic robot in an analytic
// primitive scene: FK -> collision points -> analytic point Jacobians ->
// scene SDF + gradient -> hinge residuals -> g = sum r Jr, Hqq = Jr^T Jr,
// cost = 0.5 sum r^2, all unscaled by the collision weight.  (The same
// rows' cost alone is cost.cu's.)
//
// terms_kernel replaces the TPU kernel torch_robotics_tpu/ops/pallas_terms.py
// (obstacle_terms_pallas_factory, the pallas_call in _build_terms); its
// plain PyTorch version is obstacle_terms_lanes_factory in
// torch_robotics_tpu_torch/ops/lanes_fk.py.  A precomputed SDF grid in the
// scene is looked up in-kernel (kin_scene.cuh: grid_sdf, one 16-byte load
// per object point and grid), where the TPU kernel took rows gathered
// before it by XLA (Mosaic has no vector gather; _grid_extras_fn).
//
// Design: one thread per waypoint lane n.  Loads of q_cols (d, N) and the
// stores of g (d, N), Hqq (d, d, N), cost (N) are lane-minor, so a warp's
// accesses coalesce.  Instead of generating code per robot, the model and
// scene live in two small device buffers (ints, floats) packed once by the
// wrapper; every thread reads the same entries (broadcast, cached).  Link
// transforms sit in per-thread local memory.  The g / Hqq accumulators are
// registers: the kernel is templated on the number of joints D.  It shares
// the FK chain (fk_links) and the scene SDF (scene_sdf) of kin_scene.cuh
// with the MultiRobot terms kernel (mr_terms.cu).
//
// What bounds terms_kernel on the H100: bytes.  For the Panda in
// EnvSpheres3D on the MPC path's waypoints the function needs ~2.4k float
// ops per lane (FK, the SDF of 5 points against 10 spheres, and Jacobian
// and Hessian work only for the ~9% of rows that are active, over the
// joints that move their points) against 256 bytes of memory traffic: at
// N = 65536 that is ~2.3 us of float32 work and ~5.0 us of HBM traffic.
// This kernel does more than the function needs: it builds every row's
// Jacobian and adds every row's 28 Hessian entries, active or not, and
// keeps the link transforms in local memory, so it runs well above the
// bound; skipping inactive rows and keeping the transforms in registers
// come first in a faster version.  A robot that holds a grasped object
// has G more points (14 for GraspedObjectPandaBox), each fixed in the
// grasped link's frame: a row computes such a point from the link's
// transform when it needs it (kin_scene.cuh: offset_point, 15 float ops)
// rather than keeping P world points a thread, which would add 12 bytes a
// point of local memory beside the link transforms.  The grasped Panda's
// 104 rows (19 object SDF, 19 workspace, 66 pairs) are ~5x the 20 rows of
// the Panda without it.  In a grid scene the function also
// reads one 16-byte table row per object point and grid, 80 bytes a lane
// for the Panda, scattered over a table larger than the L2 at 0.01 m
// cells: each lookup is a dependent load of one 32-byte sector.
#include <cuda_runtime.h>
#include <math.h>

#include "kin_scene.cuh"

namespace {

using namespace trt;

constexpr int kMaxLinks = 32;
constexpr int kThreads = 128;

// Views into the packed buffers; the section order is fixed by
// pack_terms_params in torch_robotics_tpu_torch/ops/terms_kernel.py.  Of
// the P points the first P - G are link origins, the last G (grasped
// points) are fixed at pt_off[3 (p - (P - G))..] in their link's frame.
// A grid object o (obj_grid[o] >= 0) reads its header from grid_i / grid_f
// and its cells from the scene's grid table (kin_scene.cuh: grid_sdf).
struct Layout {
  int L, D, P, NO, K, NOBJ, NG, NGRID, G;
  const int *topo, *parent, *jtype, *qidx, *ctrl, *point_link, *anc, *obj_pt,
      *pair_a, *pair_b, *obj_group_begin, *group_kind, *group_count,
      *group_off, *obj_grid, *grid_i;
  const float *trans, *frot, *axis, *clo, *chi, *obj_thresh, *pair_margin,
      *ws_min, *ws_max, *pt_off, *obj_rot, *obj_pos, *grid_f, *prims;
  const float4* grid;
};

__device__ Layout parse_layout(const int* ip, const float* fp,
                               const float4* grid) {
  Layout a;
  a.L = ip[0]; a.D = ip[1]; a.P = ip[2]; a.NO = ip[3]; a.K = ip[4];
  a.NOBJ = ip[5]; a.NG = ip[6]; a.NGRID = ip[7]; a.G = ip[8];
  const int* p = ip + 9;
  a.topo = p; p += a.L;
  a.parent = p; p += a.L;
  a.jtype = p; p += a.L;
  a.qidx = p; p += a.L;
  a.ctrl = p; p += a.D;
  a.point_link = p; p += a.P;
  a.anc = p; p += a.P;
  a.obj_pt = p; p += a.NO;
  a.pair_a = p; p += a.K;
  a.pair_b = p; p += a.K;
  a.obj_group_begin = p; p += a.NOBJ + 1;
  a.group_kind = p; p += a.NG;
  a.group_count = p; p += a.NG;
  a.group_off = p; p += a.NG;
  a.obj_grid = p; p += a.NOBJ;
  a.grid_i = p;
  const float* f = fp;
  a.trans = f; f += 3 * a.L;
  a.frot = f; f += 9 * a.L;
  a.axis = f; f += 3 * a.L;
  a.clo = f; f += a.L;
  a.chi = f; f += a.L;
  a.obj_thresh = f; f += a.NO;
  a.pair_margin = f; f += a.K;
  a.ws_min = f; f += 3;
  a.ws_max = f; f += 3;
  a.pt_off = f; f += 3 * a.G;
  a.obj_rot = f; f += 9 * a.NOBJ;
  a.obj_pos = f; f += 3 * a.NOBJ;
  a.grid_f = f; f += 8 * a.NGRID;
  a.prims = f;
  a.grid = grid;
  return a;
}

template <int D>
__global__ void __launch_bounds__(kThreads)
terms_kernel(const float* __restrict__ q, float* __restrict__ g_out,
             float* __restrict__ h_out, float* __restrict__ cost_out, int N,
             const int* __restrict__ ip, const float* __restrict__ fp,
             const float4* __restrict__ grid) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  const Layout a = parse_layout(ip, fp, grid);

  float qv[D];
#pragma unroll
  for (int j = 0; j < D; ++j) qv[j] = q[(size_t)j * N + n];

  float Rw[kMaxLinks][9], tw[kMaxLinks][3];
  fk_links(a, qv, Rw, tw);

  // ---- world joint axes (zeroed outside the clamp, bounds inclusive) ----
  float z[D][3], o[D][3];
  bool prism[D];
#pragma unroll
  for (int j = 0; j < D; ++j) {
    const int li = a.ctrl[j];
    const float in_lim =
        (qv[j] >= a.clo[li] && qv[j] <= a.chi[li]) ? 1.f : 0.f;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      z[j][k] = (Rw[li][3 * k] * a.axis[3 * li] +
                 Rw[li][3 * k + 1] * a.axis[3 * li + 1] +
                 Rw[li][3 * k + 2] * a.axis[3 * li + 2]) * in_lim;
      o[j][k] = tw[li][k];
    }
    prism[j] = a.jtype[li] == kPrismatic;
  }

  // World position of point p: its link's origin, or for a grasped point
  // its offset carried by the link's frame.
  const int n_origin = a.P - a.G;
  auto point = [&](int p, float x[3]) {
    const int l = a.point_link[p];
    if (p < n_origin) {
      x[0] = tw[l][0]; x[1] = tw[l][1]; x[2] = tw[l][2];
    } else {
      offset_point(Rw[l], tw[l], a.pt_off + 3 * (p - n_origin), x);
    }
  };

  // Jacobian column j of point p at world position x (zero unless joint j
  // moves p's link).
  auto jac = [&](int p, const float x[3], int j, float out[3]) {
    if (!((a.anc[p] >> j) & 1)) {
      out[0] = out[1] = out[2] = 0.f;
      return;
    }
    if (prism[j]) {
      out[0] = z[j][0]; out[1] = z[j][1]; out[2] = z[j][2];
      return;
    }
    const float d0 = x[0] - o[j][0], d1 = x[1] - o[j][1], d2 = x[2] - o[j][2];
    out[0] = z[j][1] * d2 - z[j][2] * d1;
    out[1] = z[j][2] * d0 - z[j][0] * d2;
    out[2] = z[j][0] * d1 - z[j][1] * d0;
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

  // hinge row relu(thresh - val) with Jr_j = -[r > 0] grad . J[p][j]
  auto hinge = [&](int p, const float x[3], float thresh, float val,
                   const float grad[3]) {
    const float r = relu(thresh - val);
    const float act = r > 0.f ? 1.f : 0.f;
    float Jr[D];
#pragma unroll
    for (int j = 0; j < D; ++j) {
      float c[3];
      jac(p, x, j, c);
      Jr[j] = -act * (grad[0] * c[0] + grad[1] * c[1] + grad[2] * c[2]);
    }
    add_row(r, Jr);
  };

  // ---- object rows: scene SDF hinge per object point (NOBJ counts the
  // scene's analytic objects and grids alike) ----
  if (a.NOBJ > 0) {
    for (int mi = 0; mi < a.NO; ++mi) {
      const int p = a.obj_pt[mi];
      float x[3], val, grad[3];
      point(p, x);
      scene_sdf<true>(a, x, val, grad);
      hinge(p, x, a.obj_thresh[mi], val, grad);
    }
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
    int fi = 0;
    while (fi < 5 && !(faces[fi] <= val)) ++fi;
    float grad[3] = {0.f, 0.f, 0.f};
    grad[fi % 3] = fi < 3 ? 1.f : -1.f;
    hinge(p, x, a.obj_thresh[mi], val, grad);
  }

  // ---- self-collision pair rows ----
  for (int k = 0; k < a.K; ++k) {
    const int pa = a.pair_a[k], pb = a.pair_b[k];
    float xa[3], xb[3];
    point(pa, xa);
    point(pb, xb);
    const float diff[3] = {xa[0] - xb[0], xa[1] - xb[1], xa[2] - xb[2]};
    const float d2 = diff[0] * diff[0] + diff[1] * diff[1] + diff[2] * diff[2];
    const float dist = d2 > 0.f ? sqrtf(d2) : 0.f;
    const float inv = d2 > 0.f ? 1.f / fmaxf(dist, 1e-9f) : 0.f;
    const float u[3] = {diff[0] * inv, diff[1] * inv, diff[2] * inv};
    const float r = relu(a.pair_margin[k] - dist);
    const float act = r > 0.f ? 1.f : 0.f;
    float Jr[D];
#pragma unroll
    for (int j = 0; j < D; ++j) {
      float ca[3], cb[3];
      jac(pa, xa, j, ca);
      jac(pb, xb, j, cb);
      Jr[j] = -act * (u[0] * (ca[0] - cb[0]) + u[1] * (ca[1] - cb[1]) +
                      u[2] * (ca[2] - cb[2]));
    }
    add_row(r, Jr);
  }

  // ---- outputs: unscaled g (D, N), Hqq (D, D, N), cost (N) ----
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
                   const int* ip, const float* fp, const float4* grid,
                   cudaStream_t stream) {
  const int blocks = (N + kThreads - 1) / kThreads;
  terms_kernel<D><<<blocks, kThreads, 0, stream>>>(q, g, h, cost, N, ip, fp,
                                                   grid);
  return cudaGetLastError();
}

}  // namespace

// q (D, N) -> g (D, N), h (D, D, N), cost (N); grid the scene's grid table
// ((C, 4) float32, null for a scene without grids); returns a CUDA error
// code (cudaErrorInvalidValue for D outside 1..8).
extern "C" int trt_terms_launch(const float* q, float* g, float* h,
                                float* cost, int N, int D, const int* ip,
                                const float* fp, const void* grid,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float4* t = static_cast<const float4*>(grid);
  switch (D) {
    case 1: return launch<1>(q, g, h, cost, N, ip, fp, t, s);
    case 2: return launch<2>(q, g, h, cost, N, ip, fp, t, s);
    case 3: return launch<3>(q, g, h, cost, N, ip, fp, t, s);
    case 4: return launch<4>(q, g, h, cost, N, ip, fp, t, s);
    case 5: return launch<5>(q, g, h, cost, N, ip, fp, t, s);
    case 6: return launch<6>(q, g, h, cost, N, ip, fp, t, s);
    case 7: return launch<7>(q, g, h, cost, N, ip, fp, t, s);
    case 8: return launch<8>(q, g, h, cost, N, ip, fp, t, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
