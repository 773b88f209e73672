// Fused Gauss-Newton obstacle terms of a MultiRobot (several arms, each at
// a fixed base pose, in one configuration space) in an analytic primitive
// scene: per-member FK with the base pose applied -> world collision points
// and member-width point Jacobians -> scene SDF and gradient, workspace
// bounds, own and mutual pair distances -> hinge rows -> g = sum r Jr,
// Hqq = Jr^T Jr and cost = 0.5 sum r^2, unscaled by the collision weight.
//
// Replaces the TPU kernel _multirobot_terms_pallas_factory of
// torch_robotics_tpu/ops/pallas_terms.py (whose pallas_call is the one in
// _build_terms); the value-only MultiRobot cost is cost.cu's.  A
// precomputed SDF grid in the scene is looked up in-kernel
// (kin_scene.cuh: grid_sdf), where the TPU kernel took rows gathered by
// XLA before it.  Its plain
// PyTorch version is obstacle_terms_lanes_multirobot_factory in
// torch_robotics_tpu_torch/ops/lanes_fk.py.  The residual set is the
// same; g, Hqq and the cost are symmetric reductions over the rows, so
// row order is free.
//
// Structure of the work.  Every collision point moves with one member, so
// a row touches one member's columns (object, workspace and own-pair rows
// of member i: the diagonal block H_ii) or two (a mutual pair of members i
// and j: H_ii, H_jj and the cross block H_ij).  At the 3-arm config-4 shape
// (d = 7 + 7 + 6, 143 rows) one lane needs 210 distinct Hessian entries, so
// one thread per lane would hold ~250 accumulators, three FK chains and 38
// points' Jacobians and spill heavily, and N = 8192 lanes are only ~2 warps
// per SM.
//
// Design: a block takes 32 lanes (waypoints); warp w of the block takes
// output block pair w (the n_mem diagonal blocks first, then the cross
// blocks (i, j), i < j), so every warp runs one code path over 32 lanes and
// the stores of g (d, N), Hqq (d, d, N) and cost (N) coalesce.
//   phase 1: warp i < n_mem runs member i's FK chain for its 32 lanes and
//            writes the world points of member i and its world joint axes
//            and origins to shared memory (lane-minor, no bank conflicts);
//   phase 2: a diagonal warp i builds member i's rows (SDF and workspace
//            hinges of its object points, its own pairs) and its side of
//            every mutual row that involves it, accumulating g_i, H_ii and
//            the cost of its member rows; a cross warp (i, j) builds the
//            rows of mutual group (i, j), both sides, accumulating H_ij and
//            the cost of those rows.  Rows with r == 0 contribute exactly
//            zero and skip their Jacobian work;
//   then warp 0 sums the warps' cost shares in a fixed order.
// Mutual distances are recomputed by the three warps that need them (12
// flops a row).  The kernel is sized at run time from the packed buffers;
// accumulators are registers over at most kMaxDof = 8 joints per member,
// with predicated unrolled loops, so one instantiation serves every robot.
//
// What bounds it on the H100: bytes.  Per lane it moves q (d floats) in and
// g, Hqq, cost (d + d^2 + 1 floats) out: 1764 bytes at d = 20, 14.4 MB at
// N = 8192, ~4.3 us at 3.35 TB/s.  The float work a lane needs is ~15k ops
// (three FK chains, 16 points' SDF against 10 spheres, 111 pair distances,
// and Jacobian and Hessian work only for the active rows), ~1.9 us at 67
// TFLOP/s.  At one block of 6 warps per 32 lanes the launch is 256 blocks,
// under 2 per SM, so it runs well above the byte bound; more lanes per
// block and register-resident link transforms come first in a faster one.
// A member that holds a grasped object has its grasped points (14 for
// GraspedObjectPandaBox) in its object section and, with self-collision
// links, in its self section: phase 1 places each at R o + t of its link's
// world frame (kin_scene.cuh: offset_point), and from then on it is a
// point like any other, in its member's own pairs and, as an object point,
// in every mutual pair with another member's object points.
#include <cuda_runtime.h>
#include <math.h>

#include "kin_scene.cuh"

namespace {

using namespace trt;

constexpr int kLanes = 32;       // lanes (waypoints) per block
constexpr int kMaxMembers = 4;   // block pairs <= 10: 320 threads a block
constexpr int kMaxBlockPairs = kMaxMembers * (kMaxMembers + 1) / 2;
constexpr int kMaxDof = 8;       // joints per member
constexpr int kMaxLinks = 32;    // links per member

// Views into the packed buffers; the section order is fixed by
// pack_multirobot_params in torch_robotics_tpu_torch/ops/terms_kernel.py.
// A grid object o (obj_grid[o] >= 0) reads its header from grid_i / grid_f
// and its cells from the scene's grid table (kin_scene.cuh: grid_sdf).
// Point p is its link's origin where pt_goff[p] < 0, else fixed at
// goff[3 pt_goff[p]..] in its link's frame (a grasped point).
struct MRLayout {
  int n_mem, D, P, NO, K_own, K_mut, NOBJ, NG, n_bp, L_sum, NGRID, NGP;
  const int *mem_L, *mem_D, *mem_doff, *mem_loff, *mem_obj_begin,
      *mem_obj_end, *mem_own_begin, *mem_own_end, *bp_i, *bp_j, *bp_begin,
      *bp_end, *topo, *parent, *jtype, *qidx, *ctrl, *pt_member, *pt_link,
      *pt_anc, *pt_goff, *own_a, *own_b, *mut_a, *mut_b, *obj_group_begin,
      *group_kind, *group_count, *group_off, *obj_grid, *grid_i;
  const float *trans, *frot, *axis, *clo, *chi, *base_R, *base_t,
      *obj_thresh, *own_margin, *mut_margin, *ws_min, *ws_max, *goff,
      *obj_rot, *obj_pos, *grid_f, *prims;
  const float4* grid;
};

__device__ MRLayout parse_layout(const int* ip, const float* fp,
                                 const float4* grid) {
  MRLayout a;
  a.n_mem = ip[0]; a.D = ip[1]; a.P = ip[2]; a.NO = ip[3]; a.K_own = ip[4];
  a.K_mut = ip[5]; a.NOBJ = ip[6]; a.NG = ip[7]; a.n_bp = ip[8];
  a.L_sum = ip[9]; a.NGRID = ip[10]; a.NGP = ip[11];
  const int* p = ip + 16;
  a.mem_L = p; p += a.n_mem;
  a.mem_D = p; p += a.n_mem;
  a.mem_doff = p; p += a.n_mem;
  a.mem_loff = p; p += a.n_mem;
  a.mem_obj_begin = p; p += a.n_mem;
  a.mem_obj_end = p; p += a.n_mem;
  a.mem_own_begin = p; p += a.n_mem;
  a.mem_own_end = p; p += a.n_mem;
  a.bp_i = p; p += a.n_bp;
  a.bp_j = p; p += a.n_bp;
  a.bp_begin = p; p += a.n_bp;
  a.bp_end = p; p += a.n_bp;
  a.topo = p; p += a.L_sum;
  a.parent = p; p += a.L_sum;
  a.jtype = p; p += a.L_sum;
  a.qidx = p; p += a.L_sum;
  a.ctrl = p; p += a.D;
  a.pt_member = p; p += a.P;
  a.pt_link = p; p += a.P;
  a.pt_anc = p; p += a.P;
  a.pt_goff = p; p += a.P;
  a.own_a = p; p += a.K_own;
  a.own_b = p; p += a.K_own;
  a.mut_a = p; p += a.K_mut;
  a.mut_b = p; p += a.K_mut;
  a.obj_group_begin = p; p += a.NOBJ + 1;
  a.group_kind = p; p += a.NG;
  a.group_count = p; p += a.NG;
  a.group_off = p; p += a.NG;
  a.obj_grid = p; p += a.NOBJ;
  a.grid_i = p;
  const float* f = fp;
  a.trans = f; f += 3 * a.L_sum;
  a.frot = f; f += 9 * a.L_sum;
  a.axis = f; f += 3 * a.L_sum;
  a.clo = f; f += a.L_sum;
  a.chi = f; f += a.L_sum;
  a.base_R = f; f += 9 * a.n_mem;
  a.base_t = f; f += 3 * a.n_mem;
  a.obj_thresh = f; f += a.NO;
  a.own_margin = f; f += a.K_own;
  a.mut_margin = f; f += a.K_mut;
  a.ws_min = f; f += 3;
  a.ws_max = f; f += 3;
  a.goff = f; f += 3 * a.NGP;
  a.obj_rot = f; f += 9 * a.NOBJ;
  a.obj_pos = f; f += 3 * a.NOBJ;
  a.grid_f = f; f += 8 * a.NGRID;
  a.prims = f;
  a.grid = grid;
  return a;
}

// One member's kinematic tree, in the field names fk_links reads; link
// indices are member-local.
struct MemberModel {
  int L;
  const int *topo, *parent, *jtype, *qidx;
  const float *trans, *frot, *axis, *clo, *chi;
};

__device__ MemberModel member_model(const MRLayout& a, int m) {
  const int o = a.mem_loff[m];
  MemberModel v;
  v.L = a.mem_L[m];
  v.topo = a.topo + o; v.parent = a.parent + o; v.jtype = a.jtype + o;
  v.qidx = a.qidx + o;
  v.trans = a.trans + 3 * o; v.frot = a.frot + 9 * o;
  v.axis = a.axis + 3 * o; v.clo = a.clo + o; v.chi = a.chi + o;
  return v;
}

// Shared-memory views, lane-minor: point p's coordinate k of lane l is
// pts[(3 p + k) * kLanes + l]; joint axes z and origins o likewise by the
// global joint column.
struct Shared {
  float *pts, *z, *o, *cost;
};

__global__ void __launch_bounds__(kLanes * kMaxBlockPairs)
mr_terms_kernel(const float* __restrict__ q, float* __restrict__ g_out,
                float* __restrict__ h_out, float* __restrict__ cost_out,
                int N, const int* __restrict__ ip,
                const float* __restrict__ fp,
                const float4* __restrict__ grid) {
  extern __shared__ float smem[];
  const MRLayout a = parse_layout(ip, fp, grid);
  const int lane = threadIdx.x, w = threadIdx.y;
  const int n = blockIdx.x * kLanes + lane;
  const bool valid = n < N;
  Shared s;
  s.pts = smem;
  s.z = s.pts + 3 * a.P * kLanes;
  s.o = s.z + 3 * a.D * kLanes;
  s.cost = s.o + 3 * a.D * kLanes;

  // ---- phase 1: member w's FK -> world points, joint axes and origins ----
  if (w < a.n_mem && valid) {
    const MemberModel mv = member_model(a, w);
    const int dm = a.mem_D[w], doff = a.mem_doff[w];
    float qv[kMaxDof];
#pragma unroll
    for (int j = 0; j < kMaxDof; ++j)
      qv[j] = j < dm ? q[(size_t)(doff + j) * N + n] : 0.f;
    float Rw[kMaxLinks][9], tw[kMaxLinks][3];
    fk_links(mv, qv, Rw, tw);
    const float* Rb = a.base_R + 9 * w;
    const float* tb = a.base_t + 3 * w;
    for (int c = 0; c < dm; ++c) {
      const int li = a.ctrl[doff + c];
      const float* ax = mv.axis + 3 * li;
      const float in_lim =
          (qv[c] >= mv.clo[li] && qv[c] <= mv.chi[li]) ? 1.f : 0.f;
      float RwW[9];
      matmul3(Rb, Rw[li], RwW);
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        s.z[(3 * (doff + c) + k) * kLanes + lane] =
            (RwW[3 * k] * ax[0] + RwW[3 * k + 1] * ax[1] +
             RwW[3 * k + 2] * ax[2]) * in_lim;
        s.o[(3 * (doff + c) + k) * kLanes + lane] =
            Rb[3 * k] * tw[li][0] + Rb[3 * k + 1] * tw[li][1] +
            Rb[3 * k + 2] * tw[li][2] + tb[k];
      }
    }
    for (int p = 0; p < a.P; ++p) {
      if (a.pt_member[p] != w) continue;
      const int l = a.pt_link[p];
      const float* t = tw[l];
      float x[3];
#pragma unroll
      for (int k = 0; k < 3; ++k)
        x[k] = Rb[3 * k] * t[0] + Rb[3 * k + 1] * t[1] + Rb[3 * k + 2] * t[2] +
               tb[k];
      if (a.pt_goff[p] >= 0) {  // R_wW o + t_wW, R_wW = Rb Rw[l], t_wW = x
        float RwW[9];
        const float tW[3] = {x[0], x[1], x[2]};
        matmul3(Rb, Rw[l], RwW);
        offset_point(RwW, tW, a.goff + 3 * a.pt_goff[p], x);
      }
#pragma unroll
      for (int k = 0; k < 3; ++k) s.pts[(3 * p + k) * kLanes + lane] = x[k];
    }
  }
  __syncthreads();

  // ---- phase 2: the rows of block pair w ----
  float cacc = 0.f;
  if (w < a.n_bp && valid) {
    auto point = [&](int p, float x[3]) {
#pragma unroll
      for (int k = 0; k < 3; ++k) x[k] = s.pts[(3 * p + k) * kLanes + lane];
    };
    // v . J[p][:, c] for member m's local joint column c: zero unless the
    // joint moves p's link; the axis itself for a prismatic joint, else
    // z x (x_p - o).
    auto jdot = [&](int m, int p, int c, const float x[3], const float v[3]) {
      if (!((a.pt_anc[p] >> c) & 1)) return 0.f;
      const int col = a.mem_doff[m] + c;
      float z[3], o[3];
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        z[k] = s.z[(3 * col + k) * kLanes + lane];
        o[k] = s.o[(3 * col + k) * kLanes + lane];
      }
      const int li = a.ctrl[col] + a.mem_loff[m];
      if (a.jtype[li] == kPrismatic)
        return v[0] * z[0] + v[1] * z[1] + v[2] * z[2];
      const float d0 = x[0] - o[0], d1 = x[1] - o[1], d2 = x[2] - o[2];
      return v[0] * (z[1] * d2 - z[2] * d1) + v[1] * (z[2] * d0 - z[0] * d2) +
             v[2] * (z[0] * d1 - z[1] * d0);
    };
    // pair distance row: r = relu(margin - |x_a - x_b|), u the unit
    // direction (zero at coincident points)
    auto pair_row = [&](int pa, int pb, float margin, float xa[3], float xb[3],
                        float u[3]) {
      point(pa, xa);
      point(pb, xb);
      const float diff[3] = {xa[0] - xb[0], xa[1] - xb[1], xa[2] - xb[2]};
      const float d2 =
          diff[0] * diff[0] + diff[1] * diff[1] + diff[2] * diff[2];
      const float dist = d2 > 0.f ? sqrtf(d2) : 0.f;
      const float inv = d2 > 0.f ? 1.f / fmaxf(dist, 1e-9f) : 0.f;
#pragma unroll
      for (int k = 0; k < 3; ++k) u[k] = diff[k] * inv;
      return relu(margin - dist);
    };

    const int bi = a.bp_i[w], bj = a.bp_j[w];
    if (bi == bj) {
      // -------- diagonal block H_ii, g_i and member i's cost --------
      const int m = bi, dm = a.mem_D[m];
      float gacc[kMaxDof], hacc[kMaxDof * (kMaxDof + 1) / 2];
#pragma unroll
      for (int c = 0; c < kMaxDof; ++c) gacc[c] = 0.f;
#pragma unroll
      for (int t = 0; t < kMaxDof * (kMaxDof + 1) / 2; ++t) hacc[t] = 0.f;
      auto add_row = [&](float r, const float* Jr) {
#pragma unroll
        for (int c = 0; c < kMaxDof; ++c)
          if (c < dm) gacc[c] += r * Jr[c];
        int t = 0;
#pragma unroll
        for (int c1 = 0; c1 < kMaxDof; ++c1)
#pragma unroll
          for (int c2 = c1; c2 < kMaxDof; ++c2, ++t)
            if (c2 < dm) hacc[t] += Jr[c1] * Jr[c2];
      };
      // hinge row relu(thresh - val), Jr_c = -[r > 0] grad . J[p][:, c]
      auto hinge = [&](int p, const float x[3], float thresh, float val,
                       const float grad[3]) {
        const float r = relu(thresh - val);
        cacc += r * r;
        if (r == 0.f) return;
        const float act = r > 0.f ? 1.f : 0.f;
        float Jr[kMaxDof];
#pragma unroll
        for (int c = 0; c < kMaxDof; ++c)
          Jr[c] = c < dm ? -act * jdot(m, p, c, x, grad) : 0.f;
        add_row(r, Jr);
      };
      for (int p = a.mem_obj_begin[m]; p < a.mem_obj_end[m]; ++p) {
        float x[3];
        point(p, x);
        if (a.NOBJ > 0) {
          float val, grad[3];
          scene_sdf<true>(a, x, val, grad);
          hinge(p, x, a.obj_thresh[p], val, grad);
        }
        // workspace: min-face distance, first minimal face wins
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
        hinge(p, x, a.obj_thresh[p], val, grad);
      }
      // own pairs: Jr_c = -[r > 0] u . (J[pa][:, c] - J[pb][:, c])
      for (int k = a.mem_own_begin[m]; k < a.mem_own_end[m]; ++k) {
        float xa[3], xb[3], u[3];
        const float r = pair_row(a.own_a[k], a.own_b[k], a.own_margin[k], xa,
                                 xb, u);
        cacc += r * r;
        if (r == 0.f) continue;
        const float act = r > 0.f ? 1.f : 0.f;
        float Jr[kMaxDof];
#pragma unroll
        for (int c = 0; c < kMaxDof; ++c)
          Jr[c] = c < dm ? -act * (jdot(m, a.own_a[k], c, xa, u) -
                                   jdot(m, a.own_b[k], c, xb, u))
                         : 0.f;
        add_row(r, Jr);
      }
      // member i's side of the mutual rows (their cost is the cross
      // warp's): -[r > 0] u . J[pa] on the first member, +[r > 0] u . J[pb]
      // on the second
      for (int b = a.n_mem; b < a.n_bp; ++b) {
        const bool first = a.bp_i[b] == m;
        if (!first && a.bp_j[b] != m) continue;
        for (int k = a.bp_begin[b]; k < a.bp_end[b]; ++k) {
          float xa[3], xb[3], u[3];
          const float r = pair_row(a.mut_a[k], a.mut_b[k], a.mut_margin[k],
                                   xa, xb, u);
          if (r == 0.f) continue;
          const float act = r > 0.f ? 1.f : 0.f;
          float Jr[kMaxDof];
#pragma unroll
          for (int c = 0; c < kMaxDof; ++c)
            Jr[c] = c >= dm ? 0.f
                    : first ? -act * jdot(m, a.mut_a[k], c, xa, u)
                            : act * jdot(m, a.mut_b[k], c, xb, u);
          add_row(r, Jr);
        }
      }
      const int doff = a.mem_doff[m];
#pragma unroll
      for (int c = 0; c < kMaxDof; ++c)
        if (c < dm) g_out[(size_t)(doff + c) * N + n] = gacc[c];
      int t = 0;
#pragma unroll
      for (int c1 = 0; c1 < kMaxDof; ++c1)
#pragma unroll
        for (int c2 = c1; c2 < kMaxDof; ++c2, ++t) {
          if (c2 >= dm) continue;
          const float v = hacc[t];
          h_out[((size_t)(doff + c1) * a.D + doff + c2) * N + n] = v;
          h_out[((size_t)(doff + c2) * a.D + doff + c1) * N + n] = v;
        }
    } else {
      // -------- cross block H_ij and the cost of group (i, j) --------
      const int di = a.mem_D[bi], dj = a.mem_D[bj];
      float hacc[kMaxDof][kMaxDof];
#pragma unroll
      for (int c1 = 0; c1 < kMaxDof; ++c1)
#pragma unroll
        for (int c2 = 0; c2 < kMaxDof; ++c2) hacc[c1][c2] = 0.f;
      for (int k = a.bp_begin[w]; k < a.bp_end[w]; ++k) {
        float xa[3], xb[3], u[3];
        const float r = pair_row(a.mut_a[k], a.mut_b[k], a.mut_margin[k], xa,
                                 xb, u);
        cacc += r * r;
        if (r == 0.f) continue;
        const float act = r > 0.f ? 1.f : 0.f;
        float A[kMaxDof], Bv[kMaxDof];
#pragma unroll
        for (int c = 0; c < kMaxDof; ++c) {
          A[c] = c < di ? -act * jdot(bi, a.mut_a[k], c, xa, u) : 0.f;
          Bv[c] = c < dj ? act * jdot(bj, a.mut_b[k], c, xb, u) : 0.f;
        }
#pragma unroll
        for (int c1 = 0; c1 < kMaxDof; ++c1)
#pragma unroll
          for (int c2 = 0; c2 < kMaxDof; ++c2) hacc[c1][c2] += A[c1] * Bv[c2];
      }
      const int oi = a.mem_doff[bi], oj = a.mem_doff[bj];
#pragma unroll
      for (int c1 = 0; c1 < kMaxDof; ++c1)
#pragma unroll
        for (int c2 = 0; c2 < kMaxDof; ++c2) {
          if (c1 >= di || c2 >= dj) continue;
          const float v = hacc[c1][c2];
          h_out[((size_t)(oi + c1) * a.D + oj + c2) * N + n] = v;
          h_out[((size_t)(oj + c2) * a.D + oi + c1) * N + n] = v;
        }
    }
  }
  s.cost[w * kLanes + lane] = cacc;
  __syncthreads();
  if (w == 0 && valid) {
    float c = 0.f;
    for (int b = 0; b < a.n_bp; ++b) c += s.cost[b * kLanes + lane];
    cost_out[n] = 0.5f * c;
  }
}

}  // namespace

// q (D, N) -> g (D, N), h (D, D, N), cost (N); ip / fp the packed
// parameters, n_bp their block-pair count, shared_bytes the dynamic shared
// memory (the wrapper computes both from the packed header), grid the
// scene's grid table (null without grids).  Returns a
// CUDA error code (cudaErrorInvalidValue for more than kMaxMembers
// members).
extern "C" int trt_mr_terms_launch(const float* q, float* g, float* h,
                                   float* cost, int N, int n_bp,
                                   int shared_bytes, const int* ip,
                                   const float* fp, const void* grid,
                                   void* stream) {
  if (n_bp < 1 || n_bp > kMaxBlockPairs)
    return static_cast<int>(cudaErrorInvalidValue);
  if (shared_bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        mr_terms_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        shared_bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 block(kLanes, n_bp);
  const int blocks = (N + kLanes - 1) / kLanes;
  mr_terms_kernel<<<blocks, block, shared_bytes,
                    static_cast<cudaStream_t>(stream)>>>(
      q, g, h, cost, N, ip, fp, static_cast<const float4*>(grid));
  return static_cast<int>(cudaGetLastError());
}
