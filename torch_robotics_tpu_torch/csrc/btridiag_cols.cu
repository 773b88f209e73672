// Block-tridiagonal SPD solve for large state blocks (m > 16): forward
// block-Cholesky sweep, then the backward pass in its matvec +
// triangular-vector-solve form.
//
// Replaces the TPU kernel torch_robotics_tpu/ops/pallas_btridiag.py
// (solve_lanes_pallas_cols, body _kernel_cols, with bwd_trsv=True, the
// form the config-4 path uses).  Its plain PyTorch version is
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
// Arithmetic.  Each block step is one right-looking Cholesky of the
// bordered matrix (n2 = 2m + 1, lower triangle)
//       [ A    .    . ]        A = D_k - S,
//       [ U^T  0    . ]        c = b_k - Wy,
//       [ c^T  0    0 ]
// over its first m columns.  Pivot j subtracts
//   M[r][c] -= (M[r][j] * inv) * (M[c][j] * inv),  inv = 1 / sqrtf(M[j][j]),
// from every trailing entry c > j, r >= c, then column j is scaled by inv
// and its diagonal becomes sqrtf(M[j][j]).  After m pivots the first m
// columns hold L_k, W_k^T and y_k^T, and the trailing block holds -S and
// -Wy, which seed the next step's A and c.  This is the reference's
// Cholesky, trsv and trsm (and its S and Wy sums, in another order).
//
// Design: one thread per column of the bordered matrix, the column in
// registers.  A lane takes a group of G threads, the whole warps that
// cover its n2 columns (G = 96 at m = 40); thread c owns rows c..n2-1 of
// column c (the diagonal in a register of its own, the rows below in an
// array indexed only by compile-time constants: unrolled row loops).
// Pivot j's column is published, scaled, to a shared slot by its owner
// (look-ahead: in pivot j - 1's pass, right after the owner's own update,
// with its square root and reciprocal); the group meets at one named
// barrier (bar.sync with the group's own id, so the lane groups of a
// block never wait on each other); then every thread c > j reads the slot
// by broadcast 16-byte loads and updates its rows.  Two slots alternate,
// so one barrier a pivot is enough: the slot that pivot j + 2 overwrites
// was last read before barrier j + 1.  A warp skips the 32-row blocks
// that none of its columns needs (below row j + 1 and below its first
// column); a block's eight loads issue together, then its fmas.  At the
// end of a step thread m + c hands its column (-S[c..m-1][c], -Wy[c]) to
// thread c through shared memory, which adds it to D_{k+1}'s column c and
// b_{k+1}[c], and threads c < m write L_k's rows and y_k (coalesced rows
// of a (B, H, m + 1, m) scratch).  Step k + 1's D column, b entry and U
// row reach shared memory by cp.async, issued by the column's thread at
// the start of step k (two stages), so a step's loads wait on no device
// memory.  Every entry sees the operations of the design before this one
// (one block of 256 threads per lane, the matrix in shared memory, one
// __syncthreads a pivot) in the same order, and x is the same bits.
//
// Widths: the kernel is built for padded widths MP = 24, 32, 40, 48 and
// 64 (m = 40 exact) and takes any m <= 64.  Between m and MP the columns
// of A are identity columns that are never pivoted, the rows of U and its
// columns are zero, and so is the right-hand side; a pivot's update of a
// padded row or padded trailing column is x - 0 * a, which leaves the zero
// a zero, and the real entries see only the real pivots: a real lane's
// bits do not depend on MP (tests/test_torch_btridiag_cols.py models it).
//
// Backward: one warp per lane solves, holding rows r and r + 32 of the
// vectors; the group's other warps stage the next step's L_k, y_k and U_k
// into shared memory by cp.async one step ahead (rows padded to m + 1
// floats, so that at an even m a column read across the warp hits
// distinct banks),
// with the reciprocals of L_k's diagonal that the solve multiplies by
// (two buffers in the forward pass's space, one group barrier a step).
//
// What bounds it on the H100: neither bytes nor operations but one lane's
// chain of pivots.  chip_smoke.py's cols_solve_work counts what the solve
// needs at the config-4 shape (H = 32, m = 40, B = 256): D, U, b in and x
// out, 55 MB (0.0165 ms at 3.35 TB/s), and 1.33 GFLOP (0.0199 ms at 67
// TFLOP/s), so operations are the larger term of the bound.  The kernel
// takes ~1.06 ms there on an H100 80GB HBM3 at 700 W (the design before
// it 1.74), and about as long at B = 8, one lane an SM: a lane is H m =
// 1280 dependent pivots, each a publish (square root, division, scaled
// column stored), a barrier and an update pass of up to 21 broadcast
// loads and 84 fmas in the slowest warp, under 1 us in all, with nothing
// to overlap it (chip_sweep_ab.py --kernels cols; PERF.md).
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kMaxM = 64;
constexpr int kRowsPerLane = 2;     // backward pass: 2 rows per warp lane

// One barrier of the lane group: its own id (1 + group), its thread count.
__device__ __forceinline__ void group_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

template <int MP>
struct ColsShape {
  static constexpr int kN2 = 2 * MP + 1;               // bordered size
  static constexpr int kSlot = (kN2 + 3) / 4 * 4;      // published column
  static constexpr int kGroup = (kN2 + 31) / 32 * 32;  // threads a lane
  // lane groups a block: at most 8 warps, so that a scheduler holds two
  // and each thread may take 255 registers
  static constexpr int kMaxLanes = kGroup <= 128 ? 2 : 1;
  // per lane, in floats: forward two slots, the (MP + 1) x MP hand-off
  // and two stages of a step's D, U and b; backward two buffers of L, y,
  // U and L's reciprocal diagonal (rows of m + 1)
  static constexpr int kStage = 2 * MP * MP + MP;
  static constexpr int kFwd = 2 * kSlot + (MP + 1) * MP + 2 * kStage;
  static constexpr int kBuf = 2 * MP * (MP + 1) + 2 * MP;
  static constexpr int kLaneFloats = kFwd > 2 * kBuf ? kFwd : 2 * kBuf;
};

// v[i] of a lane's two rows with a run-time i, kept in registers.
__device__ __forceinline__ float pick(const float (&v)[kRowsPerLane], int i) {
  return i ? v[1] : v[0];
}

template <int MP>
__global__ void __launch_bounds__(ColsShape<MP>::kGroup *
                                      ColsShape<MP>::kMaxLanes, 1)
btridiag_cols_kernel(const float* __restrict__ D, const float* __restrict__ U,
                     const float* __restrict__ bvec, float* __restrict__ x,
                     float* __restrict__ Lg, int H, int m, int B, int lanes) {
  using S = ColsShape<MP>;
  constexpr int N2 = S::kN2, G = S::kGroup, NQ = S::kSlot / 4;
  constexpr int NB = (NQ + 7) / 8;            // blocks of 32 rows
  extern __shared__ __align__(16) float smem[];
  const int grp = threadIdx.x / G;
  const int c = threadIdx.x - grp * G;        // this thread's column
  const int lane_b = blockIdx.x * lanes + grp;
  // a missing lane's whole group leaves: no other group waits on its id
  if (lane_b >= B) return;
  const int bar = 1 + grp;
  float* sh = smem + grp * S::kLaneFloats;
  float* slots = sh;                          // 2 x kSlot
  float* X = slots + 2 * S::kSlot;            // hand-off, (MP + 1) x MP
  float* stg = X + (MP + 1) * MP;             // 2 x kStage: D, U, b of a step
  const int step_floats = (m + 1) * m;        // scratch: L_k rows, y_k
  float* L_lane = Lg + (size_t)lane_b * H * step_floats;
  const int wfirst = c & ~31;                 // the warp's first column

  // step k's column c of D (rows c..m-1, at [r * MP + c]), row c of U_k
  // (at [MP * MP + a * MP + c]) and b_k[c] (at [2 MP * MP + c]), copied
  // asynchronously by the column's own thread into buffer k & 1
  auto prefetch = [&](int k) {
    if (c < m) {
      float* dst = stg + (k & 1) * S::kStage;
      const float* Dc = D + ((size_t)k * m * m + c) * B + lane_b;
      for (int r = c; r < m; ++r)
        cp_async4(dst + r * MP + c, Dc + (size_t)r * m * B);
      const float* Uk = U + ((size_t)k * m + c) * m;
      for (int a = 0; a < m; ++a)
        cp_async4(dst + MP * MP + a * MP + c, Uk + a);
      cp_async4(dst + 2 * MP * MP + c, bvec + ((size_t)k * m + c) * B + lane_b);
    }
  };

  for (int t = c; t < (MP + 1) * MP; t += G) X[t] = 0.f;
  prefetch(0);
  cp_async_wait_all();
  group_sync(bar, G);

  float col[N2];      // col[r] = M[r][c] for r > c (rows <= c unused)
  float diag;         // M[c][c]
  for (int k = 0; k < H; ++k) {
    // ---- column c of step k: A = D_k - S and c = b_k - Wy (D + hand-off),
    // U_k^T below A; padded and trailing columns start at identity / 0.
    // Every shared load is unconditional (rows past m read row m - 1) so
    // that all are in flight at once; the selects keep the real rows ----
    if (c < m) {
      const float* Dn = stg + (k & 1) * S::kStage;
#pragma unroll
      for (int r = 0; r < MP; ++r) {
        const int rr = r < m ? r : m - 1;
        const float d = Dn[rr * MP + c];
        col[r] = (r > c && r < m) ? d + X[rr * MP + c] : 0.f;
      }
      diag = Dn[c * MP + c] + X[c * MP + c];
#pragma unroll
      for (int a = 0; a < MP; ++a) {
        const float u = Dn[MP * MP + a * MP + c];
        col[MP + a] = a < m ? u : 0.f;
      }
      col[2 * MP] = Dn[2 * MP * MP + c] + X[MP * MP + c];
    } else {
#pragma unroll
      for (int r = 0; r < N2; ++r) col[r] = 0.f;
      diag = c < MP ? 1.f : 0.f;
    }
    if (k + 1 < H) prefetch(k + 1);           // lands during the pivots

    // ---- m pivots, one group barrier each.  Iteration j applies pivot j
    // (published to slot j & 1) to every column c > j, and thread j + 1,
    // right after its own update, takes its square root and publishes its
    // scaled column for pivot j + 1 (iteration -1 publishes pivot 0) ----
    for (int j = -1; j < m; ++j) {
      if (j >= 0) group_sync(bar, G);
      if (c > j && c < N2) {
        const bool pub = c == j + 1 && c < m;
        if (j >= 0) {
          const float* slot = slots + (j & 1) * S::kSlot;
          const int lo = j + 1 > wfirst ? j + 1 : wfirst;
          const float a = slot[c];
          diag -= a * a;
          // a block's eight 16-byte loads issue together, then its fmas
#pragma unroll
          for (int blk = 0; blk < NB; ++blk) {
            if (32 * blk + 31 >= lo) {
#pragma unroll
              for (int q = 8 * blk; q < 8 * blk + 8 && q < NQ; ++q) {
                const float4 sq =
                    *reinterpret_cast<const float4*>(slot + 4 * q);
                const float sv[4] = {sq.x, sq.y, sq.z, sq.w};
#pragma unroll
                for (int e = 0; e < 4; ++e)
                  if (4 * q + e < N2) col[4 * q + e] -= sv[e] * a;
              }
            }
          }
        }
        if (pub) {                            // publish column j + 1, scaled
          float* slot = slots + ((j + 1) & 1) * S::kSlot;
          const float p = sqrtf(diag);
          const float inv = 1.f / p;
#pragma unroll
          for (int blk = 0; blk < NB; ++blk) {
            if (32 * blk + 31 > c) {
#pragma unroll
              for (int q = 8 * blk; q < 8 * blk + 8 && q < NQ; ++q) {
                float v[4];
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                  const int r = 4 * q + e;
                  if (r < N2) col[r] *= inv;
                  v[e] = r < N2 ? col[r] : 0.f;
                }
                *reinterpret_cast<float4*>(slot + 4 * q) =
                    make_float4(v[0], v[1], v[2], v[3]);
              }
            }
          }
          diag = p;
        }
      }
    }

    // ---- L_k (row r of the scratch: column c's entry) and y_k out; the
    // trailing columns' -S and -Wy to the hand-off ----
    float* Lk = L_lane + (size_t)k * step_floats;
    if (c < m) {
#pragma unroll
      for (int r = 0; r < MP; ++r)
        if (r < m) Lk[r * m + c] = r > c ? col[r] : (r == c ? diag : 0.f);
      Lk[m * m + c] = col[2 * MP];
      cp_async_wait_all();                    // step k + 1's column
    } else if (c >= MP && c < MP + m) {
      const int cc = c - MP;
#pragma unroll
      for (int r = 0; r < MP; ++r)
        if (r >= cc && r < m)
          X[r * MP + cc] = r == cc ? diag : col[MP + r];
      X[MP * MP + cc] = col[2 * MP];
    }
    group_sync(bar, G);
  }

  // ---- backward pass: warp 0 solves, the other warps stage ahead.  Two
  // buffers at sh and sh + kBuf, each (ld = m + 1, odd at an even m, so
  // that a column read across the warp hits distinct banks): L_k's rows
  // at [r ld], y_k at [m ld], U_k's rows at [m ld + m + r ld], the
  // reciprocals of L_k's diagonal at [2 m ld + m].  The staging warps'
  // copies are asynchronous, waited for before the barrier ----
  const int ld = m + 1;
  const int lane = c & 31;
  auto stage = [&](int k, float* dst) {
    const float* src = L_lane + (size_t)k * step_floats;
    const int sw = (c >> 5) - 1, nsw = G / 32 - 1;
    for (int r = sw; r <= m; r += nsw)
      for (int cc = lane; cc < m; cc += 32)
        cp_async4(dst + r * ld + cc, src + r * m + cc);
    if (k < H - 1) {
      const float* Uk = U + (size_t)k * m * m;
      float* Ud = dst + m * ld + m;
      for (int r = sw; r < m; r += nsw)
        for (int cc = lane; cc < m; cc += 32)
          cp_async4(Ud + r * ld + cc, Uk + r * m + cc);
    }
    for (int i = c - 32; i < m; i += G - 32)
      dst[2 * m * ld + m + i] = 1.f / src[i * m + i];
  };
  if (c >= 32) {
    stage(H - 1, sh + ((H - 1) & 1) * S::kBuf);
    cp_async_wait_all();
  }
  group_sync(bar, G);
  float xr[kRowsPerLane];             // x_{k+1}, rows lane + 32 i
#pragma unroll
  for (int i = 0; i < kRowsPerLane; ++i) xr[i] = 0.f;
  for (int k = H - 1; k >= 0; --k) {
    const float* Lk = sh + (k & 1) * S::kBuf;
    const float* yk = Lk + m * ld;
    const float* Uk = yk + m;
    const float* dinv = Lk + 2 * m * ld + m;
    if (k > 0 && c >= 32) stage(k - 1, sh + ((k - 1) & 1) * S::kBuf);
    if (c < 32) {
      float cv[kRowsPerLane];
#pragma unroll
      for (int i = 0; i < kRowsPerLane; ++i) {
        const int r = lane + 32 * i;
        cv[i] = r < m ? yk[r] : 0.f;
      }
      if (k < H - 1) {
        // v = U_k x_{k+1}; z = L_k^-1 v (forward, right-looking)
        float v[kRowsPerLane];
#pragma unroll
        for (int i = 0; i < kRowsPerLane; ++i) v[i] = 0.f;
        for (int jj = 0; jj < m; ++jj) {
          const float xj =
              __shfl_sync(0xffffffffu, pick(xr, jj >> 5), jj & 31);
#pragma unroll
          for (int i = 0; i < kRowsPerLane; ++i) {
            const int r = lane + 32 * i;
            if (r < m) v[i] += Uk[r * ld + jj] * xj;
          }
        }
        for (int i2 = 0; i2 < m; ++i2) {
          const float zi =
              __shfl_sync(0xffffffffu, pick(v, i2 >> 5), i2 & 31) *
              dinv[i2];
#pragma unroll
          for (int i = 0; i < kRowsPerLane; ++i) {
            const int r = lane + 32 * i;
            if (r == i2) {
              v[i] = zi;
            } else if (r > i2 && r < m) {
              v[i] -= Lk[r * ld + i2] * zi;
            }
          }
        }
#pragma unroll
        for (int i = 0; i < kRowsPerLane; ++i) cv[i] -= v[i];
      }
      // L_k^T x = c (backward, right-looking)
      for (int i2 = m - 1; i2 >= 0; --i2) {
        const float xi = __shfl_sync(0xffffffffu, pick(cv, i2 >> 5), i2 & 31) *
                         dinv[i2];
#pragma unroll
        for (int i = 0; i < kRowsPerLane; ++i) {
          const int r = lane + 32 * i;
          if (r == i2) {
            cv[i] = xi;
          } else if (r < i2) {
            cv[i] -= Lk[i2 * ld + r] * xi;
          }
        }
      }
#pragma unroll
      for (int i = 0; i < kRowsPerLane; ++i) {
        const int r = lane + 32 * i;
        xr[i] = cv[i];
        if (r < m) x[((size_t)k * m + r) * B + lane_b] = cv[i];
      }
    } else {
      cp_async_wait_all();
    }
    group_sync(bar, G);
  }
}

template <int MP>
int launch_width(const float* D, const float* U, const float* b, float* x,
                 float* Lg, int H, int m, int B, int lanes,
                 cudaStream_t stream) {
  using S = ColsShape<MP>;
  if (lanes > S::kMaxLanes) return static_cast<int>(cudaErrorInvalidValue);
  const int smem = 4 * S::kLaneFloats * lanes;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        btridiag_cols_kernel<MP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  btridiag_cols_kernel<MP><<<(B + lanes - 1) / lanes, S::kGroup * lanes,
                             smem, stream>>>(D, U, b, x, Lg, H, m, B, lanes);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// D (H, m, m, B), U (H, m, m) shared over the batch (last block unused),
// b (H, m, B) -> x (H, m, B); Lg a (B, H, m + 1, m) scratch (L_k's rows,
// then y_k); `lanes` lane groups a block (cols_launch_config in
// ops/btridiag_kernel.py).  Returns a CUDA error code
// (cudaErrorInvalidValue for m outside 1..64, or more lanes than the
// width's kMaxLanes).
extern "C" int trt_btridiag_cols_launch(const float* D, const float* U,
                                        const float* b, float* x, float* Lg,
                                        int H, int m, int B, int lanes,
                                        void* stream) {
  if (m < 1 || m > kMaxM || lanes < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (m <= 24) return launch_width<24>(D, U, b, x, Lg, H, m, B, lanes, s);
  if (m <= 32) return launch_width<32>(D, U, b, x, Lg, H, m, B, lanes, s);
  if (m <= 40) return launch_width<40>(D, U, b, x, Lg, H, m, B, lanes, s);
  if (m <= 48) return launch_width<48>(D, U, b, x, Lg, H, m, B, lanes, s);
  return launch_width<64>(D, U, b, x, Lg, H, m, B, lanes, s);
}
