// Block-tridiagonal SPD solve for state blocks wider than the column
// sweep's registers hold (64 < m <= 128): forward block-Cholesky sweep,
// then the backward pass in its matvec + triangular-vector-solve form.
//
// Replaces the TPU kernel torch_robotics_tpu/ops/pallas_btridiag.py
// (solve_lanes_pallas_cols, body _kernel_cols, with bwd_trsv=True) past
// the m = 64 of btridiag_cols.cu; the reference's own routing
// (solve_lanes_auto) gives such an m to XLA's solve_lanes_core where its
// tile passes its VMEM budget.  Its plain PyTorch version is
// solve_lanes_core in torch_robotics_tpu_torch/solve/btridiag_lanes.py.
//
// The system per lane b: diagonal blocks D_k (m x m), off-diagonal blocks
// U_k shared over the batch, right-hand side b_k, k = 0..H-1.  Forward:
//   A_k = D_k - S,  L_k = chol(A_k),  y_k = L_k^-1 (b_k - Wy),
//   W_k = L_k^-1 U_k,  S = W_k^T W_k,  Wy = W_k^T y_k.
// Backward: x_{H-1} = L^-T y_{H-1};  x_k = L_k^-T (y_k - W_k x_{k+1}).
// No pivot guard: an indefinite pivot gives NaN, as in the reference.
//
// Arithmetic.  Each block step is one Cholesky of the bordered matrix
// (n2 = 2m + 1, lower triangle), as in btridiag_cols.cu,
//       [ A    .    . ]        A = D_k - S,
//       [ U^T  0    . ]        c = b_k - Wy,
//       [ c^T  0    0 ]
// over its first m columns, blocked right-looking in panels of kPanel =
// 16 columns, each panel in double:
//   1. its diagonal block (16 x 16) is factored inside one warp, lane r
//      holding row r in registers: pivot j's reciprocal square root
//      (rsqrt in double) of lane j's diagonal, lane r's entry times it,
//      and each later entry a[r][c] -= l[r][j] l[c][j] (an fma each, in
//      the order of j);
//   2. every row below the block (L's, W^T's and y^T's rows) is solved
//      against it by one thread, right-looking in the same order:
//      l[r][j] = a[r][j] / l[j][j] (times the reciprocal), then
//      a[r][c] -= l[r][j] l[c][j];
//   3. the trailing entries (c past the panel, r >= c) take
//        M[r][c] -= sum over the panel's columns of l[r][j] l[c][j]
//      as 8 x 8 tiles on the FP64 tensor cores (mma.m8n8k4.f64): the
//      panel's rows in double, four mma steps summed onto the entry in
//      double and rounded once a panel.
// The factors are stored rounded to float32 (the reciprocal of L's
// diagonal in its diagonal's place), so an entry of S is m / 16 roundings
// of a double sum each, not a chain of m float sums.  After m pivots the
// trailing block holds -S and -Wy, which seed the next step's A and c.
// The backward pass keeps W_k, which the forward pass formed, and sums in
// double.  The order of every entry's operations depends on m alone, not
// on the width the kernel is built for or on its threads a lane.
//
// Design: one block a lane, of 256 threads at widths 80 and 96 (two lanes
// an SM, as many as the shared memory holds) and 512 at widths 112 and
// 128 (one lane an SM: the warps it leaves idle go to that lane's rows
// and tiles); the bordered matrix's lower triangle packed by columns in
// shared memory (entry (r, c) at c (2 n2 - 1 - c) / 2 + r; 52 KB at
// width 80), beside the panel's rows
// below it in double (16 a row, laid out for 16-byte fragment loads
// without bank conflicts) and the diagonal block's factor by columns (Lt,
// the reciprocals on its diagonal).  A step is: wait for its D_k, b_k and
// U_k^T (cp.async, issued by the step before as each panel's columns
// freed up), A = D_k + (-S) and c = b_k + (-Wy) each by the thread that
// clears the -S entry it read, one barrier, the first panel's diagonal
// block in warp 0, one barrier, then per panel its rows below (all
// threads), one barrier, and the trailing tiles, one barrier.  Look-ahead:
// warp 0 takes the three tiles that hold the next panel's diagonal block
// first and factors that block while the other warps take the rest of the
// tiles (contiguous runs of the row-numbered tiles, two tiles at a time,
// so a warp reloads its rows' fragments only when the row changes).  In
// the diagonal block the chain is a shuffle, the reciprocal square root,
// a product and an fma a pivot (the next pivot's shuffle and root issue
// before this column's broadcast, which goes through Lt); the rows below
// read Lt's columns by 16-byte broadcast loads, one column ahead.  Two
// block barriers a panel, 2 m / 16 + 2 a step, and none a pivot.  The
// factors go straight to a global (B, H, step_floats(m)) scratch in the
// layouts a warp writes whole: L_k packed by columns, W_k's rows, y_k.
//
// Widths: built for padded widths MP = 80, 96, 112 and 128 (the shared
// memory, the threads and the rows a thread takes follow MP), and takes
// any m <= MP.  The matrix is laid out at the lane's own m: a padded
// column of btridiag_cols.cu's rule (an identity column never pivoted,
// zero rows and columns of U, a zero right-hand side) only ever takes
// x - 0 = x, so leaving it out changes no bit, and a real lane's x
// depends on neither MP nor the threads (tests/test_torch_cols_wide.py
// models both).
//
// Backward: x_k = L_k^-T (y_k - W_k x_{k+1}).  Per step every thread c < m
// forms (W_k x_{k+1})[c] from W_k's row c (four double sums over the
// columns, from column c on, added as (s0 + s1) + (s2 + s3)), one
// barrier, then warp 0 solves L_k^T x = r by columns, lane i holding rows
// i, i + 32, ... in double (x_c from its owner by a shuffle, times the
// kept reciprocal; two columns' entries loaded while the two before them
// are solved), while the other threads stage step k - 1's L, W and y into
// shared memory by cp.async (two buffers of L, one of W and y, in the
// forward pass's space), one barrier.
//
// What bounds it on the H100: neither bytes nor operations but one lane's
// chain: H m pivots inside a warp and 2 H m / 16 block barriers forward,
// H m dependent column steps of one warp backward, and the instructions a
// warp issues between them.  chip_smoke.py's cols_solve_work counts what
// the solve needs at five Pandas' MPC shape (H = 32, m = 70, B = 256): D,
// U, b in and x out, 0.17 GB (0.049 ms at 3.35 TB/s), and 6.9 GFLOP
// (0.103 ms at 67 TFLOP/s), so operations are the larger term of the
// bound; the scratch (0.25 GB written and read back) is not counted in
// it.  Times against the bound: PERF.md, K4's rows.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kMaxM = 128;
constexpr int kPanel = 16;          // pivots a panel
constexpr unsigned kWarpMask = 0xffffffffu;
constexpr int kSmemSM = 233472;     // shared memory of one H100 SM
constexpr int kSmemReserved = 1024;  // of it reserved by CUDA for a block

__host__ __device__ constexpr int tri(int n) { return n * (n + 1) / 2; }
__host__ __device__ constexpr int round4(int n) { return (n + 3) / 4 * 4; }

// A lane's scratch a step, in floats: L_k packed by columns (column c's
// rows c..m-1 from lcol(c), its diagonal slot holding 1 / L_k[c][c]),
// then W_k's m rows at a stride of round4(m) (row c: W_k[c][.]), then
// y_k.  The layouts the forward pass writes with whole warps: a warp's
// threads hold consecutive rows of the bordered matrix.
__host__ __device__ constexpr int lcol(int c, int m) {
  return c * (2 * m - c + 1) / 2;
}
__host__ __device__ constexpr int scratch_w(int m) { return round4(tri(m)); }
__host__ __device__ constexpr int scratch_y(int m) {
  return round4(tri(m)) + m * round4(m);
}
__host__ __device__ constexpr int step_floats(int m) {
  return round4(tri(m)) + (m + 1) * round4(m);
}

// offset of column c's row 0 in the packed triangle of an n2 x n2 matrix
// (entry (r, c), r >= c, at col_base(c) + r)
__device__ __forceinline__ int col_base(int c, int n2) {
  return c * (2 * n2 - 1 - c) / 2;
}

// (I, J <= I) of entry u of a triangle numbered by rows
__device__ __forceinline__ void tri_index(int u, int& I, int& J) {
  int q = static_cast<int>((sqrtf(8.f * u + 1.f) - 1.f) * 0.5f);
  q += tri(q + 1) <= u;
  q -= tri(q) > u;
  I = q;
  J = u - tri(q);
}

// The panel's rows below it, in double, 16 a row, laid out for the
// tensor cores' fragments: entry (row, 4 kk + q) in the row's 16-byte
// unit 2 q + kk / 2 (half kk % 2), the units permuted by the row's low
// three bits, so that a lane's four entries of a fragment are two 16-byte
// loads, and neither a fragment's 8 rows nor a warp's stores of 32 rows
// take a bank conflict.
__device__ __forceinline__ int pd_unit(int row, int u) {
  return row * kPanel + 2 * (u ^ (row & 7));
}

template <int MP>
struct WideShape {
  static constexpr int kN2 = 2 * MP + 1;
  // forward, in floats: the packed triangle, the panel's rows below it
  // (double; at most n2 - 16 rows, rounded to a tile of 8) and the
  // diagonal block's factor by columns (16 x 16 double, the reciprocals
  // on its diagonal)
  static constexpr int kPdRows = (kN2 - kPanel + 7) / 8 * 8;
  static constexpr int kPdOff = round4(tri(kN2));
  static constexpr int kLtOff = kPdOff + 2 * kPanel * kPdRows;
  static constexpr int kFwdFloats = kLtOff + 2 * kPanel * kPanel;
  // backward: two buffers of L_k (packed), one of W_k and y_k, then
  // x_{k+1} and r (double)
  static constexpr int kLb = round4(tri(MP));
  static constexpr int kWyOff = 2 * kLb;
  static constexpr int kXsOff = kWyOff + (MP + 1) * round4(MP);
  static constexpr int kBwdFloats = kXsOff + 2 * 2 * MP;
  static constexpr int kFloats =
      kFwdFloats > kBwdFloats ? kFwdFloats : kBwdFloats;
  static constexpr int kBytes = 4 * kFloats;
  static constexpr int kFit = kSmemSM / (kBytes + kSmemReserved);
  // lanes an SM: as many as the shared memory holds, at most two (each
  // 256 threads at up to 128 registers); a lane alone on its SM takes 512
  static constexpr int kBlocksPerSM = kFit > 2 ? 2 : kFit > 0 ? kFit : 1;
  static constexpr int kThreads = kBlocksPerSM > 1 ? 256 : 512;
};

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// D (8 x 8) = A (8 x 4, row) B (4 x 8, col) + C on the FP64 tensor cores:
// lane l holds A[l / 4][l % 4], B[l % 4][l / 4] and C[l / 4][2 (l % 4) + i]
__device__ __forceinline__ void mma_f64(double& d0, double& d1, double a,
                                        double b, double c0, double c1) {
  asm volatile(
      "mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 {%0, %1}, {%2}, "
      "{%3}, {%4, %5};\n"
      : "=d"(d0), "=d"(d1)
      : "d"(a), "d"(b), "d"(c0), "d"(c1));
}

// Step k's D_k (lower triangle), b_k and U_k^T in columns c0..c1-1 of the
// bordered matrix, copied into their places by cp.async (one group).
// Step k - 1 issues each panel's columns once its rows below are solved,
// so the loads overlap the rest of that step.
template <int T>
__device__ __forceinline__ void prefetch_cols(float* M, const float* D,
                                              const float* U,
                                              const float* bvec, int k,
                                              int m, int B, int lane_b,
                                              int c0, int c1, int tid) {
  const int n2 = 2 * m + 1;
  for (int c = c0; c < c1; ++c) {
    float* col = M + col_base(c, n2);
    for (int r = c + tid; r < m; r += T)
      cp_async4(col + r, D + (((size_t)k * m + r) * m + c) * B + lane_b);
  }
  for (int e = tid; e < (c1 - c0) * m; e += T) {
    const int c = c0 + e / m, a = e % m;
    cp_async4(M + col_base(c, n2) + m + a, U + ((size_t)k * m + c) * m + a);
  }
  for (int c = c0 + tid; c < c1; c += T)
    cp_async4(M + col_base(c, n2) + 2 * m,
              bvec + ((size_t)k * m + c) * B + lane_b);
  cp_async_commit();
}

// The diagonal block of the panel at column j0 (w <= 16 columns; kWhole:
// w = 16), inside one warp: lane r holds row r in double.  Pivot j's
// diagonal comes from lane j by one shuffle; lane j + 1 forms its next
// diagonal from its own entry first, and the next pivot's shuffle and
// reciprocal square root issue before this column's broadcast, so the
// chain is a shuffle, the reciprocal square root, a product and an fma a
// pivot.  The column goes through shared memory (Lt, the block by
// columns: one store a lane, then 16-byte broadcast loads), off the
// chain.  Leaves the block in Lt (the reciprocals on its diagonal) and
// writes its columns to the step's scratch (the reciprocal in the
// diagonal's place).
template <bool kWhole>
__device__ __forceinline__ void factor_diag(const float* __restrict__ M,
                                            int n2, int m, int j0, int w,
                                            double* __restrict__ Lt,
                                            float* __restrict__ Ls, int r) {
  if (kWhole) w = kPanel;
  double a[kPanel];
  int off = col_base(j0, n2) + j0 + r;
#pragma unroll
  for (int c = 0; c < kPanel; ++c) {
    a[c] = c <= r && r < w ? static_cast<double>(M[off]) : 0.0;
    off += n2 - 1 - (j0 + c);                 // next column, same row
  }
  double inv = rsqrt(__shfl_sync(kWarpMask, a[0], 0));
#pragma unroll
  for (int j = 0; j < kPanel; ++j) {
    if (!kWhole && j >= w) break;
    const double l = a[j] * inv;
    double inv_next = 0.0;
    if (j + 1 < kPanel) {
      // lane j + 1's next diagonal, from its own entry
      const double dn = __fma_rn(-l, l, a[j + 1]);
      inv_next = rsqrt(__shfl_sync(kWarpMask, dn, j + 1));
    }
    a[j] = r == j ? inv : l;
    if (r < kPanel) Lt[j * kPanel + r] = a[j];
    __syncwarp();
#pragma unroll
    for (int p = (j + 1) / 2; p < kPanel / 2; ++p) {
      const double2 lp =
          *reinterpret_cast<const double2*>(Lt + j * kPanel + 2 * p);
      if (2 * p > j)
        a[2 * p] = 2 * p <= r ? __fma_rn(-l, lp.x, a[2 * p]) : a[2 * p];
      a[2 * p + 1] =
          2 * p + 1 <= r ? __fma_rn(-l, lp.y, a[2 * p + 1]) : a[2 * p + 1];
    }
    inv = inv_next;
  }
  if (r < w) {
#pragma unroll
    for (int c = 0; c < kPanel; ++c)
      if (c <= r) Ls[lcol(j0 + c, m) + r - c] = static_cast<float>(a[c]);
  }
}

__device__ __forceinline__ void factor_diag_any(const float* M, int n2,
                                                int m, int j0, int w,
                                                double* Lt, float* Ls,
                                                int r) {
  if (w == kPanel)
    factor_diag<true>(M, n2, m, j0, w, Lt, Ls, r);
  else
    factor_diag<false>(M, n2, m, j0, w, Lt, Ls, r);
}

// The panel's rows below its diagonal block (rows j1..n2-1), each by one
// thread (kSlots rows a thread, T apart), against the block's factor (Lt,
// by columns: 16-byte broadcast loads), right-looking: stored rounded to
// the scratch (L's column, W's row or y) and, in double, to Pd for the
// trailing tiles (zero past the panel's w columns).  Branch-free over a
// whole panel (kWhole).
template <int MP, int T, bool kWhole>
__device__ __forceinline__ void panel_rows(const float* __restrict__ M,
                                           int n2, int m, int j0, int j1,
                                           const double* __restrict__ Lt,
                                           double* __restrict__ Pd,
                                           float* __restrict__ Ls, int tid) {
  constexpr int kSlots = (2 * MP + 1 - kPanel + T - 1) / T;
  const int w = kWhole ? kPanel : j1 - j0;
  const int base = col_base(j0, n2);
  double a[kSlots][kPanel];
#pragma unroll
  for (int s = 0; s < kSlots; ++s) {
    // a row past the matrix repeats its last (and stores nothing)
    const int R = j1 + tid + s * T < n2 ? j1 + tid + s * T : n2 - 1;
    int off = base + R;
#pragma unroll
    for (int g = 0; g < kPanel; ++g) {
      a[s][g] = kWhole || g < w ? static_cast<double>(M[off]) : 0.0;
      off += n2 - 1 - (j0 + g);               // next column, same row
    }
  }
  // column j's pairs of rows (2 p, 2 p + 1) from p = j / 2 on, loaded one
  // column ahead; the compiler barrier keeps later columns' loads from
  // piling up in registers
  double2 cur[kPanel / 2], nxt[kPanel / 2];
#pragma unroll
  for (int p = 0; p < kPanel / 2; ++p)
    cur[p] = *reinterpret_cast<const double2*>(Lt + 2 * p);
#pragma unroll
  for (int j = 0; j < kPanel; ++j) {
    if (!kWhole && j >= w) break;
    if (j + 1 < kPanel) {
#pragma unroll
      for (int p = (j + 1) / 2; p < kPanel / 2; ++p)
        nxt[p] = *reinterpret_cast<const double2*>(Lt + (j + 1) * kPanel +
                                                   2 * p);
    }
    const double dj = j % 2 ? cur[j / 2].y : cur[j / 2].x;
#pragma unroll
    for (int s = 0; s < kSlots; ++s) a[s][j] *= dj;
#pragma unroll
    for (int p = (j + 1) / 2; p < kPanel / 2; ++p) {
      const double l0 = kWhole || 2 * p < w ? cur[p].x : 0.0;
      const double l1 = kWhole || 2 * p + 1 < w ? cur[p].y : 0.0;
#pragma unroll
      for (int s = 0; s < kSlots; ++s) {
        if (2 * p > j) a[s][2 * p] = __fma_rn(-a[s][j], l0, a[s][2 * p]);
        a[s][2 * p + 1] = __fma_rn(-a[s][j], l1, a[s][2 * p + 1]);
      }
    }
#pragma unroll
    for (int p = (j + 1) / 2; p < kPanel / 2; ++p) cur[p] = nxt[p];
    asm volatile("" ::: "memory");
  }
#pragma unroll
  for (int s = 0; s < kSlots; ++s) {
    const int R = j1 + tid + s * T;
    if (R < n2) {
      // the row's place in the scratch and its step between columns: L's
      // column j0 + g (packed by columns), W's row j0 + g, or y
      int off, step, dec;
      if (R < m) {
        off = lcol(j0, m) + R - j0;
        step = m - j0 - 1;
        dec = 1;
      } else if (R < 2 * m) {
        off = scratch_w(m) + j0 * round4(m) + R - m;
        step = round4(m);
        dec = 0;
      } else {
        off = scratch_y(m) + j0;
        step = 1;
        dec = 0;
      }
#pragma unroll
      for (int g = 0; g < kPanel; ++g) {
        if (kWhole || g < w) Ls[off] = static_cast<float>(a[s][g]);
        off += step;
        step -= dec;
      }
#pragma unroll
      for (int u = 0; u < kPanel / 2; ++u) {
        const int q = u >> 1, kk = 2 * (u & 1);
        const int k0 = 4 * kk + q, k1 = 4 * (kk + 1) + q;
        *reinterpret_cast<double2*>(Pd + pd_unit(R - j1, u)) =
            make_double2(kWhole || k0 < w ? a[s][k0] : 0.0,
                         kWhole || k1 < w ? a[s][k1] : 0.0);
      }
    }
  }
}

// One or two 8 x 8 tiles (I, J) and (I, J + 1) of one row of the trailing
// triangle at j1 (the second only if ``two``), in mma's C layout: lane
// (g, q) holds entries (8 I + g, 8 J + 2 q + i); the row's A fragments af,
// each tile its own chain of four mma steps (16 columns, zero past the
// panel's) summed onto its entries in double.  Entries above the
// diagonal or past the matrix are neither read nor written.
__device__ __forceinline__ void tile_pair(float* __restrict__ M,
                                          const double* __restrict__ Pd,
                                          int n2, int j1, int nt, int I,
                                          int J, bool two,
                                          const double (&af)[4], int g,
                                          int q) {
  double bf[2][4], c[2][2];
  float* e[2][2];
  bool ok[2][2];
  const int r = 8 * I + g;
#pragma unroll
  for (int t = 0; t < 2; ++t) {
    const int cc = 8 * (J + t) + 2 * q;
    const bool live = t == 0 || two;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const double2 v =
          live ? *reinterpret_cast<const double2*>(
                     Pd + pd_unit(8 * (J + t) + g, 2 * q + h))
               : make_double2(0.0, 0.0);
      bf[t][2 * h] = v.x;
      bf[t][2 * h + 1] = v.y;
    }
    e[t][0] = M + col_base(j1 + cc, n2) + j1 + r;
    e[t][1] = e[t][0] + (n2 - 1 - (j1 + cc));      // entry (r, cc + 1)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      ok[t][i] = live && r < nt && cc + i <= r;
      c[t][i] = ok[t][i] ? static_cast<double>(*e[t][i]) : 0.0;
    }
  }
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int t = 0; t < 2; ++t)
      mma_f64(c[t][0], c[t][1], af[kk], bf[t][kk], c[t][0], c[t][1]);
#pragma unroll
  for (int t = 0; t < 2; ++t)
#pragma unroll
    for (int i = 0; i < 2; ++i)
      if (ok[t][i]) *e[t][i] = static_cast<float>(c[t][i]);
}

// Tiles u0..u1-1 (numbered by rows) of the trailing triangle after the
// panel ending at j1: each 8 x 8 tile of entries (j1 + 8 I + .., j1 + 8 J
// + ..) less the panel rows' products.  A row's A fragments are loaded
// once; its tiles go two at a time, two independent mma chains.
__device__ __forceinline__ void trailing_tiles(float* __restrict__ M,
                                               const double* __restrict__ Pd,
                                               int n2, int j1, int u0, int u1,
                                               int lane) {
  if (u0 >= u1) return;
  const int nt = n2 - j1;
  const int g = lane >> 2, q = lane & 3;
  int I, J;
  tri_index(u0, I, J);
  for (int u = u0; u < u1; ++I, J = 0) {
    const int jend = I < J + (u1 - u) - 1 ? I : J + (u1 - u) - 1;
    u += jend - J + 1;
    double af[4];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const double2 v = *reinterpret_cast<const double2*>(
          Pd + pd_unit(8 * I + g, 2 * q + h));
      af[2 * h] = -v.x;
      af[2 * h + 1] = -v.y;
    }
    for (; J <= jend; J += 2)
      tile_pair(M, Pd, n2, j1, nt, I, J, J + 1 <= jend, af, g, q);
  }
}

// Entries of columns c and c - 1 (those >= 0) of L_k^T x = r for the rows
// i = lane + 32 q2 below them, and their reciprocals (L_k packed by
// columns, the reciprocals on its diagonal).
template <int R>
__device__ __forceinline__ void lt_block(const float* __restrict__ L,
                                         int m, int c, int lane,
                                         double (&inv)[2],
                                         double (&lv)[2][R]) {
#pragma unroll
  for (int t = 0; t < 2; ++t) {
    const int cc = c - t;
    inv[t] = cc >= 0 ? static_cast<double>(L[lcol(cc, m)]) : 0.0;
#pragma unroll
    for (int q2 = 0; q2 < R; ++q2) {
      const int i = lane + 32 * q2;
      lv[t][q2] = cc >= 0 && i < cc
                      ? static_cast<double>(L[lcol(i, m) + cc - i])
                      : 0.0;
    }
  }
}

// Rows i = lane, lane + 32, ... of L_k^T x = r (L_k packed by columns,
// the reciprocals on its diagonal), by columns from the last, in double:
// x_c from its owner lane by a shuffle, times the reciprocal, then every
// row i < c less L_k[c][i] x_c.  Two columns' entries are loaded while
// the two before them are solved.
template <int MP>
__device__ __forceinline__ void solve_lt(const float* __restrict__ L,
                                         const double* __restrict__ rs,
                                         double* __restrict__ xs,
                                         float* __restrict__ x, int k, int m,
                                         int B, int lane_b, int lane) {
  constexpr int R = (MP + 31) / 32;
  double v[R];
#pragma unroll
  for (int q = 0; q < R; ++q) {
    const int i = lane + 32 * q;
    v[q] = i < m ? rs[i] : 0.0;
  }
#pragma unroll
  for (int q = R - 1; q >= 0; --q) {
    const int top = m - 32 * q < 32 ? m - 32 * q : 32;
    if (top <= 0) continue;
    double inv[2], lv[2][R];
    lt_block<R>(L, m, 32 * q + top - 1, lane, inv, lv);
    for (int c2 = top - 1; c2 >= 0; c2 -= 2) {
      double ninv[2], nlv[2][R];
      lt_block<R>(L, m, c2 >= 2 ? 32 * q + c2 - 2 : -1, lane, ninv, nlv);
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        if (c2 - t < 0) break;
        const int cc = c2 - t;
        const double xc = __shfl_sync(kWarpMask, v[q], cc) * inv[t];
        if (lane == cc) v[q] = xc;
#pragma unroll
        for (int q2 = 0; q2 <= q; ++q2)
          if (lane + 32 * q2 < 32 * q + cc)
            v[q2] = __fma_rn(-lv[t][q2], xc, v[q2]);
      }
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        inv[t] = ninv[t];
#pragma unroll
        for (int q2 = 0; q2 < R; ++q2) lv[t][q2] = nlv[t][q2];
      }
    }
  }
#pragma unroll
  for (int q = 0; q < R; ++q) {
    const int i = lane + 32 * q;
    if (i < m) {
      xs[i] = v[q];
      x[((size_t)k * m + i) * B + lane_b] = static_cast<float>(v[q]);
    }
  }
}

template <int MP>
__global__ void
__launch_bounds__(WideShape<MP>::kThreads, WideShape<MP>::kBlocksPerSM)
btridiag_cols_wide_kernel(const float* __restrict__ D,
                          const float* __restrict__ U,
                          const float* __restrict__ bvec,
                          float* __restrict__ x, float* __restrict__ Lg, int H,
                          int m, int B) {
  using S = WideShape<MP>;
  constexpr int T = S::kThreads;
  constexpr int kWarps = T / 32;
  static_assert(kWarps >= 2, "look-ahead needs a second warp");
  extern __shared__ __align__(16) float sm[];
  float* M = sm;
  double* Pd = reinterpret_cast<double*>(sm + S::kPdOff);
  double* Lt = reinterpret_cast<double*>(sm + S::kLtOff);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int lane_b = blockIdx.x;
  const int n2 = 2 * m + 1;
  const int nA = tri(m);
  const int sf = step_floats(m);
  float* L_lane = Lg + (size_t)lane_b * H * sf;

  for (int t = tid; t < tri(n2); t += T) M[t] = 0.f;
  __syncthreads();
  prefetch_cols<T>(M, D, U, bvec, 0, m, B, lane_b, 0, m, tid);

  for (int k = 0; k < H; ++k) {
    float* Ls = L_lane + (size_t)k * sf;
    // ---- D_k, b_k and U_k^T are in place (prefetched); A = D_k + (-S)
    // and c = b_k + (-Wy), each entry by the thread that clears the -S
    // (-Wy) entry it read ----
    cp_async_wait_all();
    __syncthreads();
    for (int e = tid; e < nA + m; e += T) {
      int r, c;
      if (e < nA) {
        tri_index(e, r, c);
      } else {
        c = e - nA;
        r = m;                               // row 2m: m + r
      }
      float* t = M + col_base(m + c, n2) + m + r;
      M[col_base(c, n2) + (e < nA ? r : 2 * m)] += *t;
      *t = 0.f;
    }
    if (tid == 0) M[col_base(2 * m, n2) + 2 * m] = 0.f;
    __syncthreads();
    if (warp == 0)
      factor_diag_any(M, n2, m, 0, m < kPanel ? m : kPanel, Lt, Ls, lane);
    __syncthreads();

    for (int j0 = 0; j0 < m; j0 += kPanel) {
      const int j1 = j0 + kPanel < m ? j0 + kPanel : m;
      if (j1 - j0 == kPanel)
        panel_rows<MP, T, true>(M, n2, m, j0, j1, Lt, Pd, Ls, tid);
      else
        panel_rows<MP, T, false>(M, n2, m, j0, j1, Lt, Pd, Ls, tid);
      __syncthreads();
      // the panel's columns are done with: the next step's come in
      if (k + 1 < H)
        prefetch_cols<T>(M, D, U, bvec, k + 1, m, B, lane_b, j0, j1, tid);
      const int nt8 = (n2 - j1 + 7) >> 3, tiles = tri(nt8);
      if (j1 < m) {
        // warp 0: the tiles of rows < 16 (the next panel's diagonal
        // block), then that block; the other warps: the rest
        const int head = tiles < 3 ? tiles : 3, rest = tiles - head;
        if (warp == 0) {
          trailing_tiles(M, Pd, n2, j1, 0, head, lane);
          __syncwarp();
          const int w2 = m - j1 < kPanel ? m - j1 : kPanel;
          factor_diag_any(M, n2, m, j1, w2, Lt, Ls, lane);
        } else {
          trailing_tiles(M, Pd, n2, j1,
                         head + (warp - 1) * rest / (kWarps - 1),
                         head + warp * rest / (kWarps - 1), lane);
        }
      } else {
        trailing_tiles(M, Pd, n2, j1, warp * tiles / kWarps,
                       (warp + 1) * tiles / kWarps, lane);
      }
      __syncthreads();
    }
  }

  // ---- backward: r = y_k - W_k x_{k+1} by all threads, then L_k^T x = r
  // in warp 0 while the others stage step k - 1 ----
  float* Lb = sm;
  float* Wyb = sm + S::kWyOff;
  double* xs = reinterpret_cast<double*>(sm + S::kXsOff);
  double* rs = xs + MP;
  const int tri4 = round4(nA), ldw = round4(m), wy = (m + 1) * ldw;
  auto stage = [&](int kk) {
    const float* src = L_lane + (size_t)kk * sf;
    float* dst = Lb + (kk & 1) * S::kLb;
    for (int i = 4 * tid; i < tri4; i += 4 * T) cp_async16(dst + i, src + i);
    for (int i = 4 * tid; i < wy; i += 4 * T)
      cp_async16(Wyb + i, src + tri4 + i);
    cp_async_commit();
  };
  stage(H - 1);
  cp_async_wait_all();
  __syncthreads();
  for (int k = H - 1; k >= 0; --k) {
    if (tid < m) {
      // row c of W_k from column c on (a = c, c + 1, ..., c - 1 mod m):
      // the warp's loads take no bank conflict
      double s0 = 0.0, s1 = 0.0, s2 = 0.0, s3 = 0.0;
      if (k < H - 1) {
        const float* row = Wyb + tid * ldw;
        int a = tid;
        for (int i = 0; i < m; i += 4) {
          s0 = __fma_rn(static_cast<double>(row[a]), xs[a], s0);
          if (++a == m) a = 0;
          if (i + 1 < m) {
            s1 = __fma_rn(static_cast<double>(row[a]), xs[a], s1);
            if (++a == m) a = 0;
          }
          if (i + 2 < m) {
            s2 = __fma_rn(static_cast<double>(row[a]), xs[a], s2);
            if (++a == m) a = 0;
          }
          if (i + 3 < m) {
            s3 = __fma_rn(static_cast<double>(row[a]), xs[a], s3);
            if (++a == m) a = 0;
          }
        }
      }
      rs[tid] =
          static_cast<double>(Wyb[m * ldw + tid]) - ((s0 + s1) + (s2 + s3));
    }
    __syncthreads();
    if (k > 0) stage(k - 1);
    if (warp == 0)
      solve_lt<MP>(Lb + (k & 1) * S::kLb, rs, xs, x, k, m, B, lane_b, lane);
    cp_async_wait_all();
    __syncthreads();
  }
}

template <int MP>
int launch_width(const float* D, const float* U, const float* b, float* x,
                 float* Lg, int H, int m, int B, cudaStream_t stream) {
  using S = WideShape<MP>;
  if (S::kBytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        btridiag_cols_wide_kernel<MP>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, S::kBytes);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  btridiag_cols_wide_kernel<MP><<<B, S::kThreads, S::kBytes, stream>>>(
      D, U, b, x, Lg, H, m, B);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// D (H, m, m, B), U (H, m, m) shared over the batch (last block unused),
// b (H, m, B) -> x (H, m, B); Lg a (B, H, step_floats(m)) scratch (L_k's
// rows packed by columns, W_k's rows at a stride of round4(m), y_k);
// `width` the padded width to run in (80, 96, 112 or 128, at least m), as
// cols_launch_config in ops/btridiag_kernel.py gives it.  Returns a CUDA
// error code (cudaErrorInvalidValue for m outside 1..width or another
// width).
extern "C" int trt_btridiag_cols_wide_launch(const float* D, const float* U,
                                             const float* b, float* x,
                                             float* Lg, int H, int m, int B,
                                             int width, void* stream) {
  if (m < 1 || m > width || m > kMaxM)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (width) {
    case 80: return launch_width<80>(D, U, b, x, Lg, H, m, B, s);
    case 96: return launch_width<96>(D, U, b, x, Lg, H, m, B, s);
    case 112: return launch_width<112>(D, U, b, x, Lg, H, m, B, s);
    case 128: return launch_width<128>(D, U, b, x, Lg, H, m, B, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
