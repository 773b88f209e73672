// Device helpers shared by the terms kernels (terms.cu, mr_terms.cu) and
// the cost kernel (cost.cu): the FK chain over a kinematic tree, the world
// position of a point fixed in a link's frame, the min-over-scene SDF with
// the gradient of its minimizing primitive, the nearest-cell lookup of a
// precomputed SDF grid, and small 3x3 helpers.
// The model and scene arguments are views into packed parameter buffers;
// any struct with the field names used below will do.
#pragma once
#include <cuda_runtime.h>
#include <math.h>

namespace trt {

enum JointType { kFixed = 0, kRevolute = 1, kContinuous = 2, kPrismatic = 3 };
enum GroupKind { kSpheres = 0, kRoundedBoxes = 1, kSharpBoxes = 2 };

__device__ __forceinline__ float relu(float x) {
  return x > 0.f ? x : (isnan(x) ? x : 0.f);
}

__device__ __forceinline__ float sgn(float x) {
  return x > 0.f ? 1.f : (x < 0.f ? -1.f : 0.f);
}

// C = A B for row-major 3x3 matrices.
__device__ __forceinline__ void matmul3(const float* A, const float* B,
                                        float* C) {
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      C[3 * i + j] = A[3 * i] * B[j] + A[3 * i + 1] * B[3 + j] +
                     A[3 * i + 2] * B[6 + j];
}

// World position x = R o + t of a collision point fixed at offset o in the
// frame (R row-major, t) of its link: a grasped object's point.  Each
// coordinate is ((R0 o0 + R1 o1) + R2 o2) + t with every product and sum
// rounded on its own (no contraction into FMAs), the plain version's order
// (ops/lanes_fk.py: offset_points), so from the same (R, t) it gives the
// plain version's bits.  A link-origin point is t itself: the kernels
// copy t for it and never call this, so its bits are the origin's.
__device__ __forceinline__ void offset_point(const float* R, const float* t,
                                             const float* o, float x[3]) {
#pragma unroll
  for (int k = 0; k < 3; ++k)
    x[k] = __fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(R[3 * k], o[0]),
                                         __fmul_rn(R[3 * k + 1], o[1])),
                               __fmul_rn(R[3 * k + 2], o[2])),
                     t[k]);
}

// Nearest-cell lookup of a precomputed SDF grid (geom/grid_sdf.py):
// returns the cell's SDF and, with kGrad, writes the cell's gradient (the
// reference's surrogate gradient).  gi = (first row of the grid in the
// scene's table, cmap_dim[3]), gf = (lower limits[3], 0, float32
// extent[3], 0); table rows are (sdf, gx, gy, gz) in 'ij' flat order.
// The cell coordinate is the reference's, operation for operation:
// floor((x - lim0) / extent * cmap), a correctly rounded division (no
// reciprocal), clamped to [0, cmap - 1] before the conversion to int.  One
// 16-byte load a lookup; the table stays in device memory (128 MB at 0.01
// m over [-1, 1]^3, past the 50 MB L2).
template <bool kGrad>
__device__ __forceinline__ float grid_sdf(const float4* __restrict__ table,
                                          const int* gi, const float* gf,
                                          const float x[3], float grad[3]) {
  int flat = 0;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float c = static_cast<float>(gi[1 + k]);
    const float v = floorf(__fdiv_rn(x[k] - gf[k], gf[4 + k]) * c);
    flat = flat * gi[1 + k] +
           static_cast<int>(fminf(fmaxf(v, 0.f), c - 1.f));
  }
  const float4 row = __ldg(table + static_cast<size_t>(gi[0]) + flat);
  if constexpr (kGrad) {
    grad[0] = row.y; grad[1] = row.z; grad[2] = row.w;
  }
  return row.x;
}

// Min-over-scene SDF at world point x and, with kGrad, the gradient of the
// minimizing primitive, rotated back to the world frame, or of the
// minimizing grid cell (objects and grids in the scene's order; the first
// minimum wins on ties).
template <bool kGrad, class Scene>
__device__ void scene_sdf(const Scene& a, const float x[3], float& best,
                          float grad[3]) {
  best = INFINITY;
  if constexpr (kGrad) grad[0] = grad[1] = grad[2] = 0.f;
  for (int o = 0; o < a.NOBJ; ++o) {
    const int gidx = a.obj_grid[o];
    if (gidx >= 0) {  // a grid: one cell lookup
      float gg[3];
      const float s = grid_sdf<kGrad>(a.grid, a.grid_i + 4 * gidx,
                                      a.grid_f + 8 * gidx, x, gg);
      if (s < best) {
        best = s;
        if constexpr (kGrad) {
          grad[0] = gg[0]; grad[1] = gg[1]; grad[2] = gg[2];
        }
      }
      continue;
    }
    const float* R = a.obj_rot + 9 * o;
    const float* pos = a.obj_pos + 3 * o;
    const float dx[3] = {x[0] - pos[0], x[1] - pos[1], x[2] - pos[2]};
    float xo[3];
#pragma unroll
    for (int i = 0; i < 3; ++i)  // R^T (x - pos)
      xo[i] = R[i] * dx[0] + R[3 + i] * dx[1] + R[6 + i] * dx[2];
    for (int g = a.obj_group_begin[o]; g < a.obj_group_begin[o + 1]; ++g) {
      const int kind = a.group_kind[g];
      const int count = a.group_count[g];
      const float* pr = a.prims + a.group_off[g];
      for (int j = 0; j < count; ++j) {
        float s, go[3];
        const float d0 = xo[0] - pr[0], d1 = xo[1] - pr[1],
                    d2 = xo[2] - pr[2];
        if (kind == kSpheres) {
          const float r2 = d0 * d0 + d1 * d1 + d2 * d2;
          const float dist = r2 > 0.f ? sqrtf(r2) : 0.f;
          s = dist - pr[3];
          pr += 4;
          if (!(s < best)) continue;
          if constexpr (!kGrad) { best = s; continue; }
          const float inv = dist > 0.f ? 1.f / dist : 0.f;
          go[0] = d0 * inv; go[1] = d1 * inv; go[2] = d2 * inv;
        } else if (kind == kRoundedBoxes) {
          const float rr = pr[6];
          const float q[3] = {(fabsf(d0) - pr[3]) + rr,
                              (fabsf(d1) - pr[4]) + rr,
                              (fabsf(d2) - pr[5]) + rr};
          int am = 0;
          float mq = q[0];
          if (q[1] > mq) { mq = q[1]; am = 1; }
          if (q[2] > mq) { mq = q[2]; am = 2; }
          const float r0 = relu(q[0]), r1 = relu(q[1]), r2 = relu(q[2]);
          const float n2 = r0 * r0 + r1 * r1 + r2 * r2;
          const float norm = n2 > 0.f ? sqrtf(n2) : 0.f;
          s = (fminf(mq, 0.f) + norm) - rr;
          pr += 7;
          if (!(s < best)) continue;
          if constexpr (!kGrad) { best = s; continue; }
          const float rq[3] = {r0, r1, r2};
          const float dd[3] = {d0, d1, d2};
#pragma unroll
          for (int k = 0; k < 3; ++k) {
            const float in = mq < 0.f ? (k == am ? 1.f : 0.f)
                                      : (norm > 0.f ? rq[k] / norm : 0.f);
            go[k] = sgn(dd[k]) * in;
          }
        } else {  // sharp boxes
          const float t[3] = {fabsf(d0) - pr[3], fabsf(d1) - pr[4],
                              fabsf(d2) - pr[5]};
          int am = 0;
          float mt = t[0];
          if (t[1] > mt) { mt = t[1]; am = 1; }
          if (t[2] > mt) { mt = t[2]; am = 2; }
          s = mt;
          pr += 6;
          if (!(s < best)) continue;
          if constexpr (!kGrad) { best = s; continue; }
          const float dd[3] = {d0, d1, d2};
#pragma unroll
          for (int k = 0; k < 3; ++k) go[k] = k == am ? sgn(dd[k]) : 0.f;
        }
        best = s;
        if constexpr (kGrad) {
#pragma unroll
          for (int i = 0; i < 3; ++i)  // R g_obj
            grad[i] = R[3 * i] * go[0] + R[3 * i + 1] * go[1] +
                      R[3 * i + 2] * go[2];
        }
      }
    }
  }
}

// World rotations Rw (row-major 3x3) and translations tw of every link,
// over the topological order; revolute and prismatic q are clamped to
// their limits first, continuous joints are not.
template <class Model>
__device__ __forceinline__ void fk_links(const Model& a, const float* qv,
                                         float (*Rw)[9], float (*tw)[3]) {
  for (int ii = 0; ii < a.L; ++ii) {
    const int i = a.topo[ii];
    const int jt = a.jtype[i];
    const float* F = a.frot + 9 * i;
    float tr[3] = {a.trans[3 * i], a.trans[3 * i + 1], a.trans[3 * i + 2]};
    float Rl[9];
    if (jt == kRevolute || jt == kContinuous) {
      float qi = qv[a.qidx[i]];
      if (jt == kRevolute) qi = fminf(fmaxf(qi, a.clo[i]), a.chi[i]);
      const float c = cosf(qi), s = sinf(qi), oc = 1.f - c;
      const float ax = a.axis[3 * i], ay = a.axis[3 * i + 1],
                  az = a.axis[3 * i + 2];
      // Rodrigues: R = I + s K + (1 - c) K^2, K = skew(axis)
      const float Rj[9] = {1.f + oc * (ax * ax - 1.f), -s * az + oc * (ax * ay),
                           s * ay + oc * (ax * az),    s * az + oc * (ax * ay),
                           1.f + oc * (ay * ay - 1.f), -s * ax + oc * (ay * az),
                           -s * ay + oc * (ax * az),   s * ax + oc * (ay * az),
                           1.f + oc * (az * az - 1.f)};
      matmul3(F, Rj, Rl);
    } else {
#pragma unroll
      for (int k = 0; k < 9; ++k) Rl[k] = F[k];
      if (jt == kPrismatic) {
        const float qi = fminf(fmaxf(qv[a.qidx[i]], a.clo[i]), a.chi[i]);
#pragma unroll
        for (int k = 0; k < 3; ++k) tr[k] += a.axis[3 * i + k] * qi;
      }
    }
    const int p = a.parent[i];
    if (p < 0) {
#pragma unroll
      for (int k = 0; k < 9; ++k) Rw[i][k] = Rl[k];
#pragma unroll
      for (int k = 0; k < 3; ++k) tw[i][k] = tr[k];
    } else {
      matmul3(Rw[p], Rl, Rw[i]);
#pragma unroll
      for (int k = 0; k < 3; ++k)
        tw[i][k] = Rw[p][3 * k] * tr[0] + Rw[p][3 * k + 1] * tr[1] +
                   Rw[p][3 * k + 2] * tr[2] + tw[p][k];
    }
  }
}

}  // namespace trt
