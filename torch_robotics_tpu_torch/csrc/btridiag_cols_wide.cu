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
// Backward: x_{H-1} = L^-T y_{H-1};
//           x_k = L_k^-T (y_k - L_k^-1 (U_k x_{k+1})).
// No pivot guard: an indefinite pivot gives NaN, as in the reference.
//
// Arithmetic.  Each block step is one Cholesky of the bordered matrix
// (n2 = 2m + 1, lower triangle), as in btridiag_cols.cu,
//       [ A    .    . ]        A = D_k - S,
//       [ U^T  0    . ]        c = b_k - Wy,
//       [ c^T  0    0 ]
// over its first m columns, but blocked, with sums formed apart.  The
// pivots go in panels of kPanel = 16.  In a panel, column j is formed
// left-looking: each of its entries less the panel's earlier columns'
// products, summed in double; its diagonal's square root and the
// entries below scaled by the reciprocal (in double, then rounded) give
// column j of the factor.  After the panel every trailing entry (c past
// the panel) takes
//   M[r][c] -= sum over the panel's columns of l[r][j] l[c][j],
// the 16 products summed by a fixed tree.  After m pivots the first m
// columns hold L_k, W_k^T and y_k^T, and the trailing block holds -S and
// -Wy, which seed the next step's A and c.  So an entry of S is m / 16
// roundings of one tree sum each, not a chain of m: the right-looking,
// one-pivot-at-a-time order of btridiag_cols.cu left float64 1.4-1.5x as
// far as the plain version on five Pandas' GN systems, this one as far
// or nearer (PERF.md, PR 25).  The backward pass accumulates in double.
//
// Design: one block of 512 threads a lane, the bordered matrix's lower
// triangle packed by columns in shared memory (entry (r, c) at
// c (2 n2 - 1 - c) / 2 + r; 132,612 bytes at m = 128, where the full
// square, 264 KB, would not fit), and the panel's finished columns copied
// by row (16 floats a row, as four float4 arrays: a warp's loads of rows
// r, r + 1, ... take no bank conflict).  btridiag_cols.cu keeps a column
// in a thread's registers, which past m = 64 holds more rows than 255
// registers.  Thread r owns row r of the panel's columns: pivot j is one
// barrier, in which each thread finishes its row of column j - 1 (the
// diagonal's value and row j's, published in pivot j - 1, give the
// square root and row j's factor entry to every thread) and forms its
// row of column j; the panel's trailing pass is one more.  The trailing
// entries after a panel ending at j1 are the first T(n2 - j1) entries
// counted from the matrix's end backwards (T(n) = n (n + 1) / 2): thread
// t takes entries t, t + 512, ..., each decoded by a float32 square root
// and two integer fix-ups.  At a step's end each entry of A and of c is
// written out to a global (B, H, m + 1, m) scratch (L_k's rows, then y_k)
// by the thread that then loads the next step's D_k + (-S) into it; U_k^T
// replaces W_k^T, and the trailing block is cleared behind a barrier.
//
// Widths: built for padded widths MP = 80, 96, 112 and 128 (the backward
// pass's rows a warp lane and the shared memory follow MP), and takes any
// m <= MP.  The matrix is laid out at the lane's own m: a padded column
// of btridiag_cols.cu's rule (an identity column never pivoted, zero rows
// and columns of U, a zero right-hand side) only ever takes x - 0 = x, so
// leaving it out changes no bit, and a real lane's x does not depend on
// MP (tests/test_torch_cols_wide.py models both).
//
// Backward: per step the block stages L_k, y_k and U_k into shared memory
// (rows padded to m + 1 floats), then one warp solves in
// btridiag_cols.cu's order, holding rows r, r + 32, ... of the vectors in
// double.
//
// What bounds it on the H100: neither bytes nor operations but one lane's
// chain of H m pivots and H m / 16 trailing passes, each a barrier.
// chip_smoke.py's cols_solve_work counts what the solve needs at five
// Pandas' MPC shape (H = 32, m = 70, B = 256): D, U, b in and x out, 0.17
// GB (0.049 ms at 3.35 TB/s), and 6.9 GFLOP (0.103 ms at 67 TFLOP/s), so
// operations are the larger term of the bound; the kernel runs far above
// it (PERF.md, K4's rows).
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 512;
constexpr int kMaxM = 128;
constexpr int kPanel = 16;          // pivots a panel
constexpr int kQuads = kPanel / 4;  // float4s of a panel row

__host__ __device__ constexpr int tri(int n) { return n * (n + 1) / 2; }

// offset of column c's row 0 in the packed triangle of an n2 x n2 matrix
// (entry (r, c), r >= c, at col_base(c) + r)
__device__ __forceinline__ int col_base(int c, int n2) {
  return c * (2 * n2 - 1 - c) / 2;
}

template <int MP>
struct WideShape {
  static constexpr int kN2 = 2 * MP + 1;
  static constexpr int kTri = tri(kN2);
  static constexpr int kRows = (MP + 31) / 32;   // backward: rows a lane
  // the backward pass's staging (L_k and U_k in rows of MP + 1, y_k) fits
  // in the matrix's place
  static_assert(2 * MP * (MP + 1) + MP <= kTri, "staging past the matrix");
  // the matrix, rounded to float4, then the panel's finished columns by
  // row (kPanel floats a row of the matrix), then 4 doubles: the two
  // values a panel pivot publishes
  static constexpr int kMat = (kTri + 3) / 4 * 4;
  static constexpr int kFloats = kMat + kPanel * kN2 + 8;
};

// entry u of a trailing triangle counted from the matrix's end: column
// n2 - 1 - q where T(q) <= u < T(q + 1), row n2 - 1 - (u - T(q))
__device__ __forceinline__ void trailing_entry(int u, int n2, int& r,
                                               int& c) {
  int q = static_cast<int>((sqrtf(8.f * u + 1.f) - 1.f) * 0.5f);
  q += tri(q + 1) <= u;
  q -= tri(q) > u;
  c = n2 - 1 - q;
  r = n2 - 1 - (u - tri(q));
}

// v[i] of a lane's rows with a run-time i, kept in registers.
template <typename T, int R>
__device__ __forceinline__ T pick(const T (&v)[R], int i) {
  T out = v[0];
#pragma unroll
  for (int k = 1; k < R; ++k)
    if (i == k) out = v[k];
  return out;
}

template <int MP>
__global__ void __launch_bounds__(kThreads, 1)
btridiag_cols_wide_kernel(const float* __restrict__ D,
                          const float* __restrict__ U,
                          const float* __restrict__ bvec,
                          float* __restrict__ x, float* __restrict__ Lg, int H,
                          int m, int B) {
  using S = WideShape<MP>;
  constexpr int R = S::kRows;
  extern __shared__ __align__(16) float M[];
  const int tid = threadIdx.x;
  const int lane_b = blockIdx.x;
  const int n2 = 2 * m + 1;
  const int step_floats = (m + 1) * m;        // scratch: L_k rows, y_k
  float* L_lane = Lg + (size_t)lane_b * H * step_floats;

  // the panel's finished columns: quad q (columns j0 + 4q .. 4q + 3) of
  // row r at P[q n2 + r] (rows 16 bytes apart: a warp's loads of rows r,
  // r + 1, ... take no bank conflict); pub[j & 1] the diagonal's and
  // pub[2 + (j & 1)] row j + 1's value of column j before its scaling
  float4* P = reinterpret_cast<float4*>(M + S::kMat);
  float* Pf = reinterpret_cast<float*>(P);
  double* pub = reinterpret_cast<double*>(M + S::kMat + kPanel * n2);
  for (int t = tid; t < tri(n2); t += kThreads) M[t] = 0.f;
  __syncthreads();

  for (int k = 0; k < H; ++k) {
    // ---- L_{k-1} and y_{k-1} out; A = D_k + (-S), c = b_k + (-Wy) in
    // their place, each entry by one thread; U_k^T below A ----
    float* Lp = L_lane + (size_t)(k - 1) * step_floats;
    for (int t = tid; t < m * m; t += kThreads) {
      const int r = t / m, c = t - r * m;
      if (c > r) continue;
      float* e = M + col_base(c, n2) + r;
      if (k > 0) Lp[r * m + c] = *e;
      *e = D[(((size_t)k * m + r) * m + c) * B + lane_b] +
           M[col_base(m + c, n2) + m + r];
    }
    for (int c = tid; c < m; c += kThreads) {
      float* e = M + col_base(c, n2) + 2 * m;
      if (k > 0) Lp[m * m + c] = *e;
      *e = bvec[((size_t)k * m + c) * B + lane_b] +
           M[col_base(m + c, n2) + 2 * m];
    }
    for (int t = tid; t < m * m; t += kThreads) {
      const int c = t / m, a = t - c * m;
      M[col_base(c, n2) + m + a] = U[((size_t)k * m + c) * m + a];
    }
    __syncthreads();
    for (int t = tid; t < (m + 1) * (m + 1); t += kThreads) {
      const int r = t / (m + 1), c = t - r * (m + 1);
      if (c <= r) M[col_base(m + c, n2) + m + r] = 0.f;
    }
    __syncthreads();

    // ---- m pivots in panels of kPanel.  Thread r owns row r of the
    // panel's columns.  Pivot j (one barrier) finishes column j - 1 (its
    // square root and scaling, into M and the panel's row copies) and
    // forms column j left-looking: its row r's value less the panel's
    // earlier columns' products, summed in double.  After the panel
    // every trailing entry takes the panel's kPanel products, summed by
    // a fixed tree, in one pass ----
    const int r = tid;                        // this thread's row
    for (int j0 = 0; j0 < m; j0 += kPanel) {
      const int j1 = j0 + kPanel < m ? j0 + kPanel : m;
      for (int t = tid; t < kQuads * n2; t += kThreads)
        P[t] = make_float4(0.f, 0.f, 0.f, 0.f);
      double v = 0.0;                         // row r of column j, unscaled
      float lr = 0.f;                         // row r of column j - 1
      for (int j = j0; j <= j1; ++j) {
        float lj = 0.f;                       // row j of column j - 1
        if (j > j0) {
          const double p = sqrt(pub[(j - 1) & 1]);
          const double inv = 1.0 / p;
          lj = static_cast<float>(pub[2 + ((j - 1) & 1)] * inv);
          if (r >= j - 1 && r < n2) {
            lr = r == j - 1 ? static_cast<float>(p)
                            : static_cast<float>(v * inv);
            M[col_base(j - 1, n2) + r] = lr;
            if (r >= j) Pf[(((j - 1 - j0) >> 2) * n2 + r) * 4 +
                           ((j - 1 - j0) & 3)] = lr;
          }
        }
        if (j == j1) break;
        if (r >= j && r < n2) {
          double acc = M[col_base(j, n2) + r];
          for (int g = 0; g + 1 < j - j0; ++g) {
            const int o = ((g >> 2) * n2) * 4 + (g & 3);
            acc = __fma_rn(-static_cast<double>(Pf[o + 4 * r]),
                           static_cast<double>(Pf[o + 4 * j]), acc);
          }
          if (j > j0)
            acc = __fma_rn(-static_cast<double>(lr), static_cast<double>(lj),
                           acc);
          v = acc;
          if (r == j) pub[j & 1] = v;
          if (r == j + 1) pub[2 + (j & 1)] = v;
        }
        __syncthreads();
      }
      __syncthreads();
      for (int u = tid; u < tri(n2 - j1); u += kThreads) {
        int rr, cc;
        trailing_entry(u, n2, rr, cc);
        float q[kPanel / 2];
#pragma unroll
        for (int k4 = 0; k4 < kQuads; ++k4) {
          const float4 a = P[k4 * n2 + rr], c = P[k4 * n2 + cc];
          q[2 * k4] = __fmaf_rn(a.y, c.y, a.x * c.x);
          q[2 * k4 + 1] = __fmaf_rn(a.w, c.w, a.z * c.z);
        }
#pragma unroll
        for (int w = 1; w < kPanel / 2; w *= 2)
#pragma unroll
          for (int i = 0; i < kPanel / 2; i += 2 * w) q[i] += q[i + w];
        M[col_base(cc, n2) + rr] -= q[0];
      }
      __syncthreads();
    }
  }
  {
    float* Lp = L_lane + (size_t)(H - 1) * step_floats;
    for (int t = tid; t < m * m; t += kThreads) {
      const int r = t / m, c = t - r * m;
      if (c <= r) Lp[r * m + c] = M[col_base(c, n2) + r];
    }
    for (int c = tid; c < m; c += kThreads)
      Lp[m * m + c] = M[col_base(c, n2) + 2 * m];
  }
  __syncthreads();

  // ---- backward pass: the block stages step k (L_k's rows at [r ld], y_k
  // at [m ld], U_k's rows at [m ld + m + r ld]; ld = m + 1), then warp 0
  // solves in double ----
  const int ld = m + 1;
  float* Ls = M;
  float* ys = M + m * ld;
  float* Us = ys + m;
  const int lane = tid & 31;
  double xr[R];                        // x_{k+1}, rows lane + 32 i
#pragma unroll
  for (int i = 0; i < R; ++i) xr[i] = 0.0;
  for (int k = H - 1; k >= 0; --k) {
    const float* Lk = L_lane + (size_t)k * step_floats;
    for (int t = tid; t < m * m; t += kThreads) {
      const int r = t / m, c = t - r * m;
      if (c <= r) Ls[r * ld + c] = Lk[t];
      if (k < H - 1) Us[r * ld + c] = U[(size_t)k * m * m + t];
    }
    for (int i = tid; i < m; i += kThreads) ys[i] = Lk[m * m + i];
    __syncthreads();
    if (tid < 32) {
      double cv[R];
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const int r = lane + 32 * i;
        cv[i] = r < m ? ys[r] : 0.f;
      }
      if (k < H - 1) {
        // v = U_k x_{k+1}; z = L_k^-1 v (forward, right-looking)
        double v[R];
#pragma unroll
        for (int i = 0; i < R; ++i) v[i] = 0.f;
        for (int jj = 0; jj < m; ++jj) {
          const double xj = __shfl_sync(0xffffffffu, pick(xr, jj >> 5),
                                        jj & 31);
#pragma unroll
          for (int i = 0; i < R; ++i) {
            const int r = lane + 32 * i;
            if (r < m) v[i] = __fma_rn(Us[r * ld + jj], xj, v[i]);
          }
        }
        for (int i2 = 0; i2 < m; ++i2) {
          const double zi =
              __shfl_sync(0xffffffffu, pick(v, i2 >> 5), i2 & 31) /
              static_cast<double>(Ls[i2 * ld + i2]);
#pragma unroll
          for (int i = 0; i < R; ++i) {
            const int r = lane + 32 * i;
            if (r == i2) {
              v[i] = zi;
            } else if (r > i2 && r < m) {
              v[i] = __fma_rn(-static_cast<double>(Ls[r * ld + i2]), zi,
                              v[i]);
            }
          }
        }
#pragma unroll
        for (int i = 0; i < R; ++i) cv[i] -= v[i];
      }
      // L_k^T x = c (backward, right-looking)
      for (int i2 = m - 1; i2 >= 0; --i2) {
        const double xi =
            __shfl_sync(0xffffffffu, pick(cv, i2 >> 5), i2 & 31) /
            static_cast<double>(Ls[i2 * ld + i2]);
#pragma unroll
        for (int i = 0; i < R; ++i) {
          const int r = lane + 32 * i;
          if (r == i2) {
            cv[i] = xi;
          } else if (r < i2) {
            cv[i] = __fma_rn(-static_cast<double>(Ls[i2 * ld + r]), xi,
                             cv[i]);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const int r = lane + 32 * i;
        xr[i] = cv[i];
        if (r < m)
          x[((size_t)k * m + r) * B + lane_b] = static_cast<float>(cv[i]);
      }
    }
    __syncthreads();
  }
}

template <int MP>
int launch_width(const float* D, const float* U, const float* b, float* x,
                 float* Lg, int H, int m, int B, cudaStream_t stream) {
  const int smem = 4 * WideShape<MP>::kFloats;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        btridiag_cols_wide_kernel<MP>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  btridiag_cols_wide_kernel<MP><<<B, kThreads, smem, stream>>>(D, U, b, x, Lg,
                                                               H, m, B);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// D (H, m, m, B), U (H, m, m) shared over the batch (last block unused),
// b (H, m, B) -> x (H, m, B); Lg a (B, H, m + 1, m) scratch (L_k's rows,
// then y_k); `width` the padded width to run in (cols_launch_config in
// ops/btridiag_kernel.py: 80, 96, 112 or 128, at least m).  Returns a CUDA
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
