// Fused Gauss-Newton obstacle terms of a MultiRobot (several arms, each at
// a fixed base pose, in one configuration space) in a scene of analytic
// primitives and precomputed SDF grids: per-member FK with the base pose
// applied -> world collision points, joint axes and origins -> scene SDF,
// workspace bounds, own and mutual pair distances -> hinge rows -> g =
// sum r Jr, Hqq = Jr^T Jr and cost = 0.5 sum r^2, unscaled by the
// collision weight.
//
// Replaces the TPU kernel _multirobot_terms_pallas_factory of
// torch_robotics_tpu/ops/pallas_terms.py (whose pallas_call is the one in
// _build_terms); the value-only MultiRobot cost is cost.cu's.  A
// precomputed SDF grid in the scene is looked up in-kernel (kin_scene.cuh:
// grid_sdf), where the TPU kernel took rows gathered by XLA before it.
// Its plain PyTorch version is obstacle_terms_lanes_multirobot_factory in
// torch_robotics_tpu_torch/ops/lanes_fk.py.
//
// Structure of the work.  Every collision point moves with one member, so
// a row touches one member's columns (object, workspace and own-pair rows
// of member i: the diagonal block H_ii) or two (a mutual pair of members i
// and j: H_ii, H_jj and the cross block H_ij).  At config 4's shape (d = 7
// + 7 + 6, 38 points, 143 rows) a lane needs 210 distinct Hessian entries,
// so one thread a lane would hold ~250 accumulators.
//
// What bounds it on the H100: bytes.  Per lane it moves q (d floats) in and
// g, Hqq, cost (d + d^2 + 1 floats) out: 1764 bytes at d = 20, 14.4 MB at
// N = 8192, ~4.3 us at 3.35 TB/s.  The float work a lane needs is ~12k ops
// (three FK chains, 16 points' SDF against 10 spheres, 111 pair distances,
// and Jacobian and Hessian work only for the active rows, ~1-6% of them
// on the MPC path), ~1.5 us at 67 TFLOP/s.  N = 8192 lanes at one thread
// a lane and block pair are 49,152 threads, ~12 warps an SM: each warp's
// chain of dependent steps sets the time, not the issue rate, and the
// outputs' 14.4 MB go out as the blocks end, together.
//
// Design, against what held the earlier kernel back (the link transforms,
// 1.6 KB a thread, in local memory; every model and scene entry a
// dependent load from device memory; every row's SDF gradient computed,
// active or not; each mutual row's distance taken three times, and a
// diagonal warp carrying its member's rows and its side of every mutual
// row while a cross warp carried only its group):
//   - a block takes 32 lanes (waypoints) and one warp a block pair (the
//     n_mem diagonal blocks first, then the cross blocks (i, j), i < j;
//     past 10 block pairs a warp walks several, below), so a warp runs
//     one code path and its stores of g (d, N), Hqq (d, d,
//     N) and cost (N) coalesce; it first copies the packed parameters into
//     shared memory with 16-byte loads: the members' cost packing
//     (pack_cost_params: FK steps, points, rows, scene), which cost.cu
//     reads too, and after it the terms' sections (pack_multirobot_params:
//     the block pairs, the row cuts, each point's joint mask and every
//     block's row entries);
//   - phase 1: warp m < n_mem runs member m's FK chain in registers
//     (cost.cuh: joint_transform, compose, sincos_rn) from the member's
//     own root, as fk_links does, and applies the base pose to what each
//     step writes, in fk_links' and the earlier kernel's operation order:
//     its joint's world axis (zeroed outside the clamp) and origin, and
//     its collision points (a grasped point at R o + t, kin_scene.cuh:
//     offset_point), lane-minor in shared memory ([(3 p + k) * lanes +
//     lane]: no bank conflicts); a transform that a later, non-adjacent
//     step reads goes to a shared-memory slot;
//   - phase 2: every warp takes the values of a range of rows, cut so
//     that the ranges' operation counts balance (cost_row_ops), and
//     writes r = relu(...) of each to shared memory: an object row's SDF
//     with the primitive that attains it (cost.cuh: scene_sdf_pick, the
//     bits of scene_sdf_value; taking the value first and the primitive
//     only for an active row spilled), a pair's distance root only where
//     d^2 <= m^2 (1 + 1e-6) (past it r = 0, as cost.cu);
//   - phase 3: warp w walks its block's row entries in the earlier
//     kernel's order and reads each row's r: only a row with r != 0 takes
//     its gradient (the picked primitive's, cost.cuh: scene_sdf_grad_at,
//     the workspace face, or the pair's unit direction, recomputed from
//     the points), its Jacobian columns over the joints that move its
//     points, and its g and H updates.  An inactive row would add +-0 to g
//     and Hqq and 0 to the cost, so each accumulator, summing its active
//     rows in its rows' order, gives the earlier kernel's bits.  A warp
//     takes a row where any of its lanes has it active, 7-8 of a diagonal
//     block's ~75 rows on config 4's MPC q (up to 20 in a block); this
//     walk is about half of the kernel's time (PERF.md section 6, K5), so
//     an active row's work is kept short: its SDF gradient at the picked
//     primitive, not a second pass over the scene.  (Each lane walking to
//     its own next active row was slower: a warp then waits, at every
//     lane's active row, for its longest walk);
//   - the accumulators are registers over at most kNarrowDof = 8 joints a
//     member (mr_terms_kernel<8>), with predicated unrolled loops (one
//     instantiation serves every robot), and nothing is indexed by a
//     run-time number in a per-thread array, so no local memory.
//
// Members past eight joints (the route mr_terms_kernel<16, 24, 32>, kDM
// the widest member's joints rounded up).  A diagonal block's packed
// triangle is 105 floats a lane at 14 joints (the dual-arm TIAGo), a cross
// block's d_i x d_j 98 against a Panda: past what registers hold.  As K1's
// terms_wide_kernel does (terms.cu), a row's Jr (a mutual row's two member
// Jacobians) stays in registers, unrolled to kDM and guarded by c < d_i,
// and a block's sums go to shared memory, lane-minor, in a warp's own
// scratch of the packed header's xs[3] floats a lane (the largest block:
// a diagonal block's g_i and packed triangle, d_i (d_i + 3) / 2 floats, or
// a cross block's d_i d_j); each active row adds there in the rows' order,
// as the register route adds in registers.  g_i too lives in shared
// memory: in registers beside Jr it spilled at kDM = 32 (ptxas, 255
// registers).  The wide route takes at most kWideMaxThreads threads a
// block, so ptxas may give a thread up to 255 registers.
//
// More block pairs than warps.  The block pairs grow as n (n + 1) / 2 with
// the members (15 at five, 36 at eight), a block takes at most 10 warps
// (8 on the wide route, fewer where the wide scratch does not fit), so
// warp w walks block pairs w, w + W, ... in turn (W = blockDim.y warps,
// mr_terms_launch_config) and FK chains m = w, w + W, ...; the value
// phase's row cuts are W ranges.  Each block pair keeps its own cost
// share, added in block-pair order as before, so a lane's bits do not
// depend on W.  A warp with fewer block pairs than another waits at the
// block's last barrier: the simple schedule, not a balanced one.
//
// Each block pair's member-local prismatic bits are read from its
// members' FK steps in shared memory (a joint's column and type), so a
// MultiRobot's joint columns are not limited to the 32 bits of a mask;
// a point's joint mask covers its member's columns, at most 32.
// mr_terms_launch_config in ops/terms_kernel.py gives the launch shape.
#include <cuda_runtime.h>
#include <math.h>

#include "cost.cuh"

namespace {

using namespace trt;

constexpr int kMaxThreads = 320;      // 32 lanes x 10 warps
constexpr int kWideMaxThreads = 256;  // 8 warps past eight joints a member
constexpr int kNarrowDof = 8;         // joints a member in registers
constexpr int kExtras = 13;           // the cost header's int: where ours start
constexpr int kSwap = 1, kSecond = 2, kSide = 4;  // row entry flags

template <int kDM>
__global__ void __launch_bounds__(kDM == kNarrowDof ? kMaxThreads
                                                    : kWideMaxThreads)
mr_terms_kernel(const float* __restrict__ q, float* __restrict__ g_out,
                float* __restrict__ h_out, float* __restrict__ cost_out,
                int N, int D, const int* __restrict__ ip, int n_ints,
                const float* __restrict__ fp, int n_floats,
                const float4* __restrict__ grid) {
  constexpr bool kWide = kDM > kNarrowDof;
  extern __shared__ __align__(16) float smem[];
  const int lanes = blockDim.x, lane = threadIdx.x, w = threadIdx.y;
  const int n_warps = blockDim.y;
  const int tid = w * lanes + lane, nthr = lanes * n_warps;
  const int n = blockIdx.x * lanes + lane;
  const bool valid = n < N;

  // ---- the parameters and the block's q (D, lanes) into shared memory ----
  int* ism = reinterpret_cast<int*>(smem);
  float* fsm = smem + round4(n_ints);
  float* qs = fsm + round4(n_floats);
  float* zo = qs + D * lanes;  // [6 D][lanes]: axis z_j, origin o_j
  for (int j = w; j < D; j += n_warps)
    qs[j * lanes + lane] = valid ? q[(size_t)j * N + n] : 0.f;
  // a joint that moves no point keeps a zero axis (its columns are masked)
  for (int k = w; k < 6 * D; k += n_warps) zo[k * lanes + lane] = 0.f;
  copy_words(ip, ism, n_ints, tid, nthr);
  copy_words(fp, fsm, n_floats, tid, nthr);
  __syncthreads();
  const CostLayout a = parse_layout(ism, fsm, grid);
  // the terms' sections (pack_multirobot_params)
  const int* xs = ism + ism[kExtras];
  const int n_bp = xs[0];
  const int n_scratch = xs[3];  // a warp's scratch floats a lane (wide)
  const int* mem_D = xs + 8;
  const int* mem_doff = mem_D + a.n_mem;
  const int* bp_i = mem_doff + a.n_mem;
  const int* bp_j = bp_i + n_bp;
  const int* bp_begin = bp_j + n_bp;
  const int* vcuts = bp_begin + n_bp + 1;  // n_warps + 1 row cuts
  const int* anc_of = vcuts + n_warps + 1;
  const int* entries = anc_of + a.P;
  const int n_sdf = a.NOBJ > 0 ? a.NO : 0;  // NOBJ counts grids too
  float* pts = zo + 6 * D * lanes;                // [3 P][lanes]
  float* slots = pts + 3 * a.P * lanes;           // [12 n_slots][lanes]
  float* rs = slots + 12 * a.n_slots * lanes;     // [rows][lanes]: r
  float* part = rs + (n_sdf + a.NO + a.K) * lanes;  // [n_bp][lanes]
  // [n_sdf][lanes]: each object row's minimizing primitive (scene_sdf_pick)
  int* pick = reinterpret_cast<int*>(part + n_bp * lanes);
  // [n_warps][n_scratch][lanes]: a warp's block sums on the wide route
  float* hw = reinterpret_cast<float*>(pick + n_sdf * lanes) +
              (size_t)w * n_scratch * lanes + lane;

  // ---- phase 1: member chains m = w, w + W, ... -> axes, origins, points
  for (int m = w; m < a.n_mem; m += n_warps) {
    const float* Rb = a.base_R + 9 * m;
    const float* tb = a.base_t + 3 * m;
    float R[9], tv[3];  // the previous step's transform in the member frame
    for (int s = a.mem_step[m]; s < a.mem_step[m + 1]; ++s) {
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
      if (i0.z == -1) {  // the member's root: its local transform, as
                         // fk_links (the base pose comes after)
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
      // the step's link origin in the world, Rb t + tb
      float x[3];
#pragma unroll
      for (int k = 0; k < 3; ++k)
        x[k] = Rb[3 * k] * tv[0] + Rb[3 * k + 1] * tv[1] +
               Rb[3 * k + 2] * tv[2] + tb[k];
      const int first_off = i1.y - i1.z;
      const bool world_R = i0.y >= 0 || i1.z > 0;
      float RwW[9];  // the world rotation Rb R, where a joint or an
                     // offset point needs it
      if (world_R) matmul3(Rb, R, RwW);
      if (i0.y >= 0) {  // joint i0.y: world axis (0 outside the clamp)
        const float in_lim = (qj >= lo && qj <= hi) ? 1.f : 0.f;
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          zo[(6 * i0.y + k) * lanes + lane] =
              (RwW[3 * k] * axis[0] + RwW[3 * k + 1] * axis[1] +
               RwW[3 * k + 2] * axis[2]) * in_lim;
          zo[(6 * i0.y + 3 + k) * lanes + lane] = x[k];
        }
      }
      for (int i = i1.x; i < first_off; ++i) {  // the link's origin
        const int p = a.pt_list[i];
#pragma unroll
        for (int k = 0; k < 3; ++k) pts[(3 * p + k) * lanes + lane] = x[k];
      }
      for (int i = first_off; i < i1.y; ++i) {  // offset points: R o + t
        const float4 o4 =
            reinterpret_cast<const float4*>(a.offsets)[i1.w + i - first_off];
        const float o[3] = {o4.x, o4.y, o4.z};
        float xo[3];
        offset_point(RwW, x, o, xo);
        const int p = a.pt_list[i];
#pragma unroll
        for (int k = 0; k < 3; ++k) pts[(3 * p + k) * lanes + lane] = xo[k];
      }
    }
  }
  __syncthreads();

  auto point = [&](int p, float x[3]) {
#pragma unroll
    for (int k = 0; k < 3; ++k) x[k] = pts[(3 * p + k) * lanes + lane];
  };

  // ---- phase 2: the values of rows [vcuts[w], vcuts[w + 1]) ----
  {
    const int end = vcuts[w + 1];
    int r = vcuts[w];
    for (; r < min(end, n_sdf); ++r) {  // object rows: scene SDF hinge
      float x[3], val;
      point(a.obj_pt[r], x);
      pick[r * lanes + lane] = scene_sdf_pick(a, x, val);
      rs[r * lanes + lane] = relu(a.obj_thresh[r] - val);
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
      rs[r * lanes + lane] = relu(a.obj_thresh[mi] - val);
    }
    for (; r < end; ++r) {  // pair rows: distance hinge
      const int k = r - n_sdf - a.NO;
      float xa[3], xb[3];
      point(a.pair_a[k], xa);
      point(a.pair_b[k], xb);
      const float diff[3] = {xa[0] - xb[0], xa[1] - xb[1], xa[2] - xb[2]};
      const float d2 =
          diff[0] * diff[0] + diff[1] * diff[1] + diff[2] * diff[2];
      const float m = a.pair_margin[k];
      // d2 >= m^2 (1 + 1e-6) > m^2 gives sqrtf(d2) >= m, a zero row
      rs[r * lanes + lane] =
          d2 > m * m * 1.000001f ? 0.f : relu(m - sqrtf(d2));
    }
  }
  __syncthreads();

  // ---- phase 3: block pairs w, w + W, ...: active rows in entry order ----
  // a member's prismatic joints, bit c for its column c (from its steps)
  auto member_prism = [&](int m) {
    unsigned pm = 0u;
    for (int s = a.mem_step[m]; s < a.mem_step[m + 1]; ++s) {
      const int4 i0 = reinterpret_cast<const int4*>(a.step_i)[2 * s];
      if (i0.x == kPrismatic && i0.y >= 0) pm |= 1u << (i0.y - mem_doff[m]);
    }
    return pm;
  };
  // v . J[p][:, c] for member-local joint column c of a point at world
  // position x (its member's first column doff, prismatic bits pm): zero
  // unless the joint moves p's link; the axis itself for a prismatic
  // joint, else z x (x_p - o)
  auto jdot = [&](int doff, unsigned pm, int p, int c, const float x[3],
                  const float v[3]) {
    if (!((anc_of[p] >> c) & 1)) return 0.f;
    const int col = doff + c;
    float z[3], o[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      z[k] = zo[(6 * col + k) * lanes + lane];
      o[k] = zo[(6 * col + 3 + k) * lanes + lane];
    }
    if ((pm >> c) & 1) return v[0] * z[0] + v[1] * z[1] + v[2] * z[2];
    const float d0 = x[0] - o[0], d1 = x[1] - o[1], d2 = x[2] - o[2];
    return v[0] * (z[1] * d2 - z[2] * d1) + v[1] * (z[2] * d0 - z[0] * d2) +
           v[2] * (z[0] * d1 - z[1] * d0);
  };
  // an active pair row k, its points in the block's order: the points'
  // positions and the unit direction (zero at coincident points)
  auto pair_dir = [&](int k, bool swap, int& pa, int& pb, float xa[3],
                      float xb[3], float u[3]) {
    pa = swap ? a.pair_b[k] : a.pair_a[k];
    pb = swap ? a.pair_a[k] : a.pair_b[k];
    point(pa, xa);
    point(pb, xb);
    const float diff[3] = {xa[0] - xb[0], xa[1] - xb[1], xa[2] - xb[2]};
    const float d2 = diff[0] * diff[0] + diff[1] * diff[1] + diff[2] * diff[2];
    const float dist = d2 > 0.f ? sqrtf(d2) : 0.f;
    const float inv = d2 > 0.f ? 1.f / fmaxf(dist, 1e-9f) : 0.f;
#pragma unroll
    for (int c = 0; c < 3; ++c) u[c] = diff[c] * inv;
  };

  for (int b = w; b < n_bp; b += n_warps) {
    float cacc = 0.f;
    const int bi = bp_i[b], bj = bp_j[b];
    const int e_end = bp_begin[b + 1];
    if (bi == bj) {
      // -------- diagonal block H_ii, g_i and member i's cost --------
      const int dm = mem_D[bi], doff = mem_doff[bi];
      const unsigned pm = member_prism(bi);
      // the register route's g_i and packed triangle (one float each on
      // the wide route, whose scratch holds g_i, then the triangle)
      float gacc[kWide ? 1 : kDM];
      float hacc[kWide ? 1 : kDM * (kDM + 1) / 2];
      if constexpr (kWide) {
        for (int t = 0; t < dm * (dm + 3) / 2; ++t) hw[t * lanes] = 0.f;
      } else {
#pragma unroll
        for (int c = 0; c < kDM; ++c) gacc[c] = 0.f;
#pragma unroll
        for (int t = 0; t < kDM * (kDM + 1) / 2; ++t) hacc[t] = 0.f;
      }
      for (int e = bp_begin[b]; e < e_end; ++e) {
        const int ent = entries[e], row = ent >> 3;
        const float r = rs[row * lanes + lane];
        if (!(ent & kSide)) cacc += r * r;
        if (r == 0.f) continue;
        const float act = r > 0.f ? 1.f : 0.f;
        float Jr[kDM];
        if (row < n_sdf + a.NO) {
          // hinge row relu(thresh - val), Jr_c = -[r > 0] grad . J[p][:, c]
          const int mi = row < n_sdf ? row : row - n_sdf;
          const int p = a.obj_pt[mi];
          float x[3], grad[3];
          point(p, x);
          if (row < n_sdf) {  // the minimizing primitive's gradient
            scene_sdf_grad_at(a, x, pick[row * lanes + lane], grad);
          } else {  // workspace: the first minimal face
            const float faces[6] = {x[0] - a.ws_min[0], x[1] - a.ws_min[1],
                                    x[2] - a.ws_min[2], a.ws_max[0] - x[0],
                                    a.ws_max[1] - x[1], a.ws_max[2] - x[2]};
            float val = faces[0];
#pragma unroll
            for (int f = 1; f < 6; ++f) val = fminf(val, faces[f]);
            int fi = 5;  // the first face f < 5 with faces[f] <= val, else 5
#pragma unroll
            for (int f = 4; f >= 0; --f) fi = faces[f] <= val ? f : fi;
#pragma unroll
            for (int k = 0; k < 3; ++k)
              grad[k] = fi == k ? 1.f : (fi == k + 3 ? -1.f : 0.f);
          }
#pragma unroll
          for (int c = 0; c < kDM; ++c)
            Jr[c] = c < dm ? -act * jdot(doff, pm, p, c, x, grad) : 0.f;
        } else {
          int pa, pb;
          float xa[3], xb[3], u[3];
          pair_dir(row - n_sdf - a.NO, ent & kSwap, pa, pb, xa, xb, u);
          if (!(ent & kSide)) {
            // own pair, or a mutual pair within the member:
            // Jr_c = -[r > 0] u . (J[pa][:, c] - J[pb][:, c])
#pragma unroll
            for (int c = 0; c < kDM; ++c)
              Jr[c] = c < dm ? -act * (jdot(doff, pm, pa, c, xa, u) -
                                       jdot(doff, pm, pb, c, xb, u))
                             : 0.f;
          } else {
            // this member's side of a mutual row: -[r > 0] u . J[pa] on the
            // first member, +[r > 0] u . J[pb] on the second
            const bool second = ent & kSecond;
#pragma unroll
            for (int c = 0; c < kDM; ++c)
              Jr[c] = c >= dm ? 0.f
                      : second ? act * jdot(doff, pm, pb, c, xb, u)
                               : -act * jdot(doff, pm, pa, c, xa, u);
          }
        }
        if constexpr (kWide) {
#pragma unroll
          for (int c = 0; c < kDM; ++c)
            if (c < dm) hw[c * lanes] += r * Jr[c];
          // row c1 of the packed triangle starts at dm + c1 dm - c1 (c1 +
          // 1) / 2
#pragma unroll
          for (int c1 = 0; c1 < kDM; ++c1) {
            if (c1 < dm) {
              float* hrow = hw + (dm + c1 * dm - c1 * (c1 + 1) / 2) * lanes;
#pragma unroll
              for (int c2 = c1; c2 < kDM; ++c2)
                if (c2 < dm) hrow[c2 * lanes] += Jr[c1] * Jr[c2];
            }
          }
        } else {
#pragma unroll
          for (int c = 0; c < kDM; ++c)
            if (c < dm) gacc[c] += r * Jr[c];
          int t = 0;
#pragma unroll
          for (int c1 = 0; c1 < kDM; ++c1)
#pragma unroll
            for (int c2 = c1; c2 < kDM; ++c2, ++t)
              if (c2 < dm) hacc[t] += Jr[c1] * Jr[c2];
        }
      }
      if (valid) {
        if constexpr (kWide) {
          for (int c = 0; c < dm; ++c)
            g_out[(size_t)(doff + c) * N + n] = hw[c * lanes];
          int t = dm;
          for (int c1 = 0; c1 < dm; ++c1)
            for (int c2 = c1; c2 < dm; ++c2) {
              const float v = hw[(t++) * lanes];
              h_out[((size_t)(doff + c1) * D + doff + c2) * N + n] = v;
              h_out[((size_t)(doff + c2) * D + doff + c1) * N + n] = v;
            }
        } else {
#pragma unroll
          for (int c = 0; c < kDM; ++c)
            if (c < dm) g_out[(size_t)(doff + c) * N + n] = gacc[c];
          int t = 0;
#pragma unroll
          for (int c1 = 0; c1 < kDM; ++c1)
#pragma unroll
            for (int c2 = c1; c2 < kDM; ++c2, ++t) {
              if (c2 >= dm) continue;
              const float v = hacc[t];
              h_out[((size_t)(doff + c1) * D + doff + c2) * N + n] = v;
              h_out[((size_t)(doff + c2) * D + doff + c1) * N + n] = v;
            }
        }
      }
    } else {
      // -------- cross block H_ij and the cost of group (i, j) --------
      const int di = mem_D[bi], dj = mem_D[bj];
      const int oi = mem_doff[bi], oj = mem_doff[bj];
      const unsigned pi = member_prism(bi), pj = member_prism(bj);
      // the register route's block (one float on the wide route)
      float hacc[kWide ? 1 : kDM][kWide ? 1 : kDM];
      if constexpr (kWide) {
        for (int t = 0; t < di * dj; ++t) hw[t * lanes] = 0.f;
      } else {
#pragma unroll
        for (int c1 = 0; c1 < kDM; ++c1)
#pragma unroll
          for (int c2 = 0; c2 < kDM; ++c2) hacc[c1][c2] = 0.f;
      }
      for (int e = bp_begin[b]; e < e_end; ++e) {
        const int ent = entries[e], row = ent >> 3;
        const float r = rs[row * lanes + lane];
        cacc += r * r;
        if (r == 0.f) continue;
        const float act = r > 0.f ? 1.f : 0.f;
        int pa, pb;
        float xa[3], xb[3], u[3];
        pair_dir(row - n_sdf - a.NO, ent & kSwap, pa, pb, xa, xb, u);
        // the row's Jacobian on member i's columns, -[r > 0] u . J[pa], and
        // on member j's, +[r > 0] u . J[pb]: one loop on the wide route,
        // member j's first on the register route (as ptxas allocates each
        // without a spill)
        float A[kDM], Bv[kDM];
        if constexpr (kWide) {
#pragma unroll
          for (int c = 0; c < kDM; ++c) {
            A[c] = c < di ? -act * jdot(oi, pi, pa, c, xa, u) : 0.f;
            Bv[c] = c < dj ? act * jdot(oj, pj, pb, c, xb, u) : 0.f;
          }
#pragma unroll
          for (int c1 = 0; c1 < kDM; ++c1) {
            if (c1 < di) {
              float* hrow = hw + c1 * dj * lanes;
#pragma unroll
              for (int c2 = 0; c2 < kDM; ++c2)
                if (c2 < dj) hrow[c2 * lanes] += A[c1] * Bv[c2];
            }
          }
        } else {
#pragma unroll
          for (int c = 0; c < kDM; ++c)
            Bv[c] = c < dj ? act * jdot(oj, pj, pb, c, xb, u) : 0.f;
#pragma unroll
          for (int c = 0; c < kDM; ++c)
            A[c] = c < di ? -act * jdot(oi, pi, pa, c, xa, u) : 0.f;
#pragma unroll
          for (int c1 = 0; c1 < kDM; ++c1)
#pragma unroll
            for (int c2 = 0; c2 < kDM; ++c2) hacc[c1][c2] += A[c1] * Bv[c2];
        }
      }
      if (valid) {
        if constexpr (kWide) {
          for (int c1 = 0; c1 < di; ++c1)
            for (int c2 = 0; c2 < dj; ++c2) {
              const float v = hw[(c1 * dj + c2) * lanes];
              h_out[((size_t)(oi + c1) * D + oj + c2) * N + n] = v;
              h_out[((size_t)(oj + c2) * D + oi + c1) * N + n] = v;
            }
        } else {
#pragma unroll
          for (int c1 = 0; c1 < kDM; ++c1)
#pragma unroll
            for (int c2 = 0; c2 < kDM; ++c2) {
              if (c1 >= di || c2 >= dj) continue;
              const float v = hacc[c1][c2];
              h_out[((size_t)(oi + c1) * D + oj + c2) * N + n] = v;
              h_out[((size_t)(oj + c2) * D + oi + c1) * N + n] = v;
            }
        }
      }
    }
    part[b * lanes + lane] = cacc;
  }
  __syncthreads();
  if (w == 0 && valid) {
    float c = 0.f;
    for (int b = 0; b < n_bp; ++b) c += part[b * lanes + lane];
    cost_out[n] = 0.5f * c;
  }
}

template <int kDM>
int launch_mr(const float* q, float* g, float* h, float* cost, int N, int D,
              int lanes, int warps, int smem_bytes, const int* ip,
              int n_ints, const float* fp, int n_floats, const void* grid,
              cudaStream_t stream) {
  if (smem_bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        mr_terms_kernel<kDM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem_bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 block(lanes, warps);
  mr_terms_kernel<kDM><<<(N + lanes - 1) / lanes, block, smem_bytes,
                         stream>>>(q, g, h, cost, N, D, ip, n_ints, fp,
                                   n_floats, static_cast<const float4*>(grid));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q (D, N) -> g (D, N), h (D, D, N), cost (N); ip (n_ints) / fp (n_floats)
// the packed parameters (pack_multirobot_params), lanes the lanes a block,
// warps its warps of lanes (each walks block pairs w, w + warps, ...; the
// packing's row cuts are for this count), member_dof the widest member's
// joints (1-8 the register route, 9-32 the route with H in shared memory)
// and smem_bytes its dynamic shared memory (mr_terms_launch_config), grid
// the scene's grid table ((C, 4) float32, null without grids).  Returns a
// CUDA error code (cudaErrorInvalidValue for a block that is not whole
// warps of lanes or passes its route's threads, or member_dof outside
// 1..32).
extern "C" int trt_mr_terms_launch(const float* q, float* g, float* h,
                                   float* cost, int N, int D, int lanes,
                                   int warps, int member_dof, int smem_bytes,
                                   const int* ip, int n_ints, const float* fp,
                                   int n_floats, const void* grid,
                                   void* stream) {
  const int max_threads =
      member_dof <= kNarrowDof ? kMaxThreads : kWideMaxThreads;
  if (lanes < 32 || lanes % 32 != 0 || warps < 1 ||
      lanes * warps > max_threads || member_dof < 1 || member_dof > 32)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (member_dof <= kNarrowDof)
    return launch_mr<kNarrowDof>(q, g, h, cost, N, D, lanes, warps,
                                 smem_bytes, ip, n_ints, fp, n_floats, grid,
                                 s);
  if (member_dof <= 16)
    return launch_mr<16>(q, g, h, cost, N, D, lanes, warps, smem_bytes, ip,
                         n_ints, fp, n_floats, grid, s);
  if (member_dof <= 24)
    return launch_mr<24>(q, g, h, cost, N, D, lanes, warps, smem_bytes, ip,
                         n_ints, fp, n_floats, grid, s);
  return launch_mr<32>(q, g, h, cost, N, D, lanes, warps, smem_bytes, ip,
                       n_ints, fp, n_floats, grid, s);
}
