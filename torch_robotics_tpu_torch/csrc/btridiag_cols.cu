// Block-tridiagonal SPD solve for large state blocks (m > 16), one lane per
// thread block: forward block-Cholesky sweep, then the backward pass in its
// matvec + triangular-vector-solve form.
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
// Design.  At the config-4 shape (H = 32, m = 40, B = 256) a lane's 40 x 40
// blocks do not fit in one thread's registers, and 256 lanes at one thread
// each would use 2% of the card, so one thread block takes one lane.  Each
// block step is one right-looking Cholesky of the bordered matrix
//       [ A    U    c ]        c = b_k - Wy,
//       [ U^T  0    0 ]
//       [ c^T  0    0 ]
// over its first m columns, held in shared memory ((2m+1)^2 floats, 26 KB
// at m = 40; lower triangle only).  Eliminating column j scales it by
// 1/sqrt(pivot) and subtracts its outer product from the trailing lower
// triangle, so after m columns the factor's first m columns hold L_k, W_k^T
// and y_k^T, and the trailing block holds -S and -Wy, which seed the next
// step's A and c.  This is the same arithmetic as the reference's Cholesky,
// trsv and trsm (and its S and Wy sums, in another order), with one
// __syncthreads per column: a column is scaled in place while the next
// column is eliminated, since no thread reads it then.  The trailing
// entries of step j are the first P_j entries of a pair table ordered from
// the last column backwards, so the 256 threads take consecutive entries.
// L_k goes to a global scratch (B, H, m, m) that the backward pass reads
// back, as the reference keeps its L stack in VMEM; y stays in shared
// memory.  The backward pass runs in one warp (each lane owns rows r and
// r + 32 of the vectors), with L_k and U_k staged in shared memory by the
// whole block one step ahead (double-buffered in the matrix's space).
//
// What bounds it on the H100: operations.  It reads D (H m^2 B floats,
// 52 MB at the config-4 shape) and writes x: ~16 us at 3.35 TB/s; its
// ~7 m^3 / 6 multiply-adds per block step are ~1.2 GFLOP over the batch,
// ~18 us at 67 TFLOP/s.  This kernel runs far above that: each block step
// is m dependent elimination steps of one block barrier each, and only
// B = 256 blocks (under 2 per SM) are resident, so latency, not
// throughput, bounds it; D is read lane by lane (stride B), which the L2
// serves across neighbouring blocks.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxM = 64;           // backward pass: 2 rows per warp lane
constexpr int kRowsPerLane = 2;

__host__ __device__ __forceinline__ int tri_count(int n) {
  return n * (n + 1) / 2;
}

// v[i] of a lane's two rows with a run-time i, kept in registers.
__device__ __forceinline__ float pick(const float (&v)[kRowsPerLane], int i) {
  return i ? v[1] : v[0];
}

__global__ void __launch_bounds__(kThreads)
btridiag_cols_kernel(const float* __restrict__ D, const float* __restrict__ U,
                     const float* __restrict__ bvec, float* __restrict__ x,
                     float* __restrict__ Lg, int H, int m, int B) {
  extern __shared__ float smem[];
  const int n2 = 2 * m + 1;           // bordered matrix size
  float* M = smem;                    // n2 x n2, row-major, lower used
  float* ys = M + n2 * n2;            // H x m
  float* pinv = ys + H * m;           // m: 1 / sqrt(pivot) of each column
  float* pdiag = pinv + m;            // m: sqrt(pivot)
  unsigned char* pr = reinterpret_cast<unsigned char*>(pdiag + m);
  const int n_pairs = tri_count(2 * m);   // trailing pairs at j = 0
  const int tid = threadIdx.x;
  const int lane_b = blockIdx.x;      // the batch lane of this block
  float* L_lane = Lg + (size_t)lane_b * H * m * m;

  // pair table: (r, c), r >= c >= 1, ordered from the last column back, so
  // the trailing triangle of step j (c > j) is its first tri_count(2m - j)
  // entries
  for (int t = tid; t < n_pairs; t += kThreads) {
    int c = 2 * m, base = 0;
    while (t >= base + (n2 - c)) {
      base += n2 - c;
      --c;
    }
    pr[2 * t] = static_cast<unsigned char>(c + (t - base));   // row
    pr[2 * t + 1] = static_cast<unsigned char>(c);            // column
  }
  for (int t = tid; t < n2 * n2; t += kThreads) M[t] = 0.f;
  __syncthreads();

  for (int k = 0; k < H; ++k) {
    // ---- load A = D_k - S (top-left) and c = b_k - Wy (row 2m); keep the
    // previous step's L_k-1 and y_k-1 on the way out ----
    for (int t = tid; t < m * m; t += kThreads) {
      const int r = t / m, c = t % m;
      if (c > r) continue;
      if (k > 0) L_lane[(size_t)(k - 1) * m * m + r * m + c] = M[r * n2 + c];
      M[r * n2 + c] = D[(((size_t)k * m + r) * m + c) * B + lane_b] +
                      M[(m + r) * n2 + m + c];
    }
    for (int c = tid; c < m; c += kThreads) {
      if (k > 0) ys[(k - 1) * m + c] = M[2 * m * n2 + c];
      M[2 * m * n2 + c] = bvec[((size_t)k * m + c) * B + lane_b] +
                          M[2 * m * n2 + m + c];
    }
    __syncthreads();
    // ---- U_k^T below A; clear the trailing block ----
    for (int t = tid; t < m * n2; t += kThreads) {
      const int a = t / n2, c = t % n2;      // row m + a, column c
      float v = 0.f;
      if (c < m) v = U[((size_t)k * m + c) * m + a];
      if (c <= m + a) M[(m + a) * n2 + c] = v;
    }
    for (int c = m + tid; c < n2; c += kThreads) M[2 * m * n2 + c] = 0.f;
    __syncthreads();

    // ---- m elimination steps of the bordered matrix ----
    for (int j = 0; j < m; ++j) {
      const float p = sqrtf(M[j * n2 + j]);
      const float inv = 1.f / p;
      if (tid == 0) {
        pinv[j] = inv;
        pdiag[j] = p;
      }
      const int cnt = tri_count(2 * m - j);
      for (int t = tid; t < cnt; t += kThreads) {
        const int r = pr[2 * t], c = pr[2 * t + 1];
        M[r * n2 + c] -= (M[r * n2 + j] * inv) * (M[c * n2 + j] * inv);
      }
      if (j > 0) {                      // scale column j - 1 in place
        const float iv = pinv[j - 1];
        for (int r = j + tid; r < n2; r += kThreads)
          M[r * n2 + j - 1] *= iv;
        if (tid == 0) M[(j - 1) * n2 + j - 1] = pdiag[j - 1];
      }
      __syncthreads();
    }
    {
      const float iv = pinv[m - 1];
      for (int r = m + tid; r < n2; r += kThreads) M[r * n2 + m - 1] *= iv;
      if (tid == 0) M[(m - 1) * n2 + m - 1] = pdiag[m - 1];
    }
    __syncthreads();
  }
  // the last step's L and y
  for (int t = tid; t < m * m; t += kThreads) {
    const int r = t / m, c = t % m;
    if (c <= r) L_lane[(size_t)(H - 1) * m * m + r * m + c] = M[r * n2 + c];
  }
  for (int c = tid; c < m; c += kThreads)
    ys[(H - 1) * m + c] = M[2 * m * n2 + c];
  __syncthreads();

  // ---- backward pass: warp 0 solves, the block stages L_k, U_k ahead ----
  float* buf[2] = {M, M + 2 * m * m};   // each: L (m x m), then U (m x m)
  auto stage = [&](int k, float* dst) {
    for (int t = tid; t < m * m; t += kThreads) {
      const int r = t / m, c = t % m;
      dst[t] = c <= r ? L_lane[(size_t)k * m * m + t] : 0.f;
      dst[m * m + t] = k < H - 1 ? U[(size_t)k * m * m + t] : 0.f;
    }
  };
  stage(H - 1, buf[(H - 1) & 1]);
  __syncthreads();
  const int lane = tid & 31;
  float xr[kRowsPerLane];             // x_{k+1}, rows lane + 32 i
#pragma unroll
  for (int i = 0; i < kRowsPerLane; ++i) xr[i] = 0.f;
  for (int k = H - 1; k >= 0; --k) {
    const float* Lk = buf[k & 1];
    const float* Uk = Lk + m * m;
    if (k > 0) stage(k - 1, buf[(k - 1) & 1]);
    if (tid < 32) {
      float c[kRowsPerLane];
#pragma unroll
      for (int i = 0; i < kRowsPerLane; ++i) {
        const int r = lane + 32 * i;
        c[i] = r < m ? ys[k * m + r] : 0.f;
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
            if (r < m) v[i] += Uk[r * m + jj] * xj;
          }
        }
        for (int i2 = 0; i2 < m; ++i2) {
          const float zi =
              __shfl_sync(0xffffffffu, pick(v, i2 >> 5), i2 & 31) *
              (1.f / Lk[i2 * m + i2]);
#pragma unroll
          for (int i = 0; i < kRowsPerLane; ++i) {
            const int r = lane + 32 * i;
            if (r == i2) {
              v[i] = zi;
            } else if (r > i2 && r < m) {
              v[i] -= Lk[r * m + i2] * zi;
            }
          }
        }
#pragma unroll
        for (int i = 0; i < kRowsPerLane; ++i) c[i] -= v[i];
      }
      // L_k^T x = c (backward, right-looking)
      for (int i2 = m - 1; i2 >= 0; --i2) {
        const float xi = __shfl_sync(0xffffffffu, pick(c, i2 >> 5), i2 & 31) *
                         (1.f / Lk[i2 * m + i2]);
#pragma unroll
        for (int i = 0; i < kRowsPerLane; ++i) {
          const int r = lane + 32 * i;
          if (r == i2) {
            c[i] = xi;
          } else if (r < i2) {
            c[i] -= Lk[i2 * m + r] * xi;
          }
        }
      }
#pragma unroll
      for (int i = 0; i < kRowsPerLane; ++i) {
        const int r = lane + 32 * i;
        xr[i] = c[i];
        if (r < m) x[((size_t)k * m + r) * B + lane_b] = c[i];
      }
    }
    __syncthreads();
  }
}

// Dynamic shared memory of one block: the bordered matrix, the y stack,
// the pivots and the pair table.
int smem_bytes(int H, int m) {
  const int n2 = 2 * m + 1;
  return 4 * (n2 * n2 + H * m + 2 * m) + 2 * tri_count(2 * m);
}

}  // namespace

// D (H, m, m, B), U (H, m, m) shared over the batch (last block unused),
// b (H, m, B) -> x (H, m, B); Lg a (B, H, m, m) scratch.  Returns a CUDA
// error code (cudaErrorInvalidValue for m outside 1..64).
extern "C" int trt_btridiag_cols_launch(const float* D, const float* U,
                                        const float* b, float* x, float* Lg,
                                        int H, int m, int B, void* stream) {
  if (m < 1 || m > kMaxM) return static_cast<int>(cudaErrorInvalidValue);
  const int smem = smem_bytes(H, m);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        btridiag_cols_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  btridiag_cols_kernel<<<B, kThreads, smem,
                         static_cast<cudaStream_t>(stream)>>>(D, U, b, x, Lg,
                                                              H, m, B);
  return static_cast<int>(cudaGetLastError());
}
