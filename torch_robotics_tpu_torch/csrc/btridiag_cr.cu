// Batched block-tridiagonal SPD solve by block cyclic reduction, batch in
// the minor (lane) axis.
//
// Replaces the TPU kernel torch_robotics_tpu/ops/pallas_btridiag.py
// solve_lanes_pallas_bcr (body _kernel_bcr).  Its plain PyTorch version is
// solve_lanes_bcr in torch_robotics_tpu_torch/solve/btridiag_bcr.py, whose
// head comment gives the elimination identities.
//
// D (H, M, M, B), U (H, M, M) shared over the batch (U_k couples block k to
// k+1; the last block unused), b (H, M, B) -> x (H2, M, B), H2 the power of
// two at or above H.  Blocks past H are identity blocks with b = 0, and the
// coupling out of block H-1 is zero: level 0 reads them so, and nothing is
// padded in memory.
//
// What bounds it on the H100: latency and instruction issue, not bytes.
// The solve needs D, U, b in and x out (58.8 MB at (64, 14, 1024), 17.5 us
// at 3.35 TB/s); CR's own arithmetic is ~1.5 GFLOP there (23 us at 67
// TFLOP/s).  Its chain is log2(H2) levels deep, each level a Cholesky of M
// pivots and triangular solves of 2 M + 1 columns per odd block.  The
// design before this one ran one thread per (block, lane) in 19 launches
// at H = 64 (6 levels x (odd, even), a root, 6 back-substitutions): a
// whole M x M factor and a right-hand column a thread (no room for more
// than one column at a time at M = 14), the even update re-reading A_k
// and C_k from device memory in rolled triple loops, and the coarse levels
// on a few warps: 2.45 ms on an H100 80GB HBM3 at 700 W.
//
// Design: one launch.  A block owns a tile of `lanes` lanes through every
// level, the root and the back-substitution, so levels need no launch of
// their own and the coarse levels run inside the block that made them
// (__syncthreads between stages; block-scope ordering makes the block's
// own device-memory writes visible to it).  Its threads form groups of G
// (the power of two >= M) as in the sweeps of btridiag.cu; a level's units
// are (pair k, lane), pair k = (even block 2k, odd block 2k + 1), taken in
// chunks of one unit a group.  Per unit, in two phases:
//   odd:  thread j owns column j of D_{2k+1} and of the right-hand sides
//         [U_{2k}^T | U_{2k+1}] and all of b_{2k+1}; a right-looking
//         elimination broadcasts each pivot column by __shfl_sync inside
//         the group (btridiag.cu's, with two more columns), L goes to
//         shared memory and each thread back-solves L^T on its own three
//         columns.  Thread j then holds column j of A_k = D^-1 U_{2k}^T,
//         C_k = D^-1 U_{2k+1} and beta_k, written once to device memory
//         for the back-substitution, and forms its columns of the even
//         update's terms from rows of U_{2k} and U_{2k+1}^T staged in
//         shared memory: U'_k = -U_{2k} C_k (straight to the next level),
//         P_k = U_{2k} A_k (to shared memory, where L was), p_k = U_{2k}
//         beta_k, and Q_k = U_{2k+1}^T C_k, q_k = U_{2k+1}^T beta_k (to a
//         ring of slots in shared memory, read by unit (k + 1, lane));
//   even: D'_k = D_{2k} - Q_{k-1} - P_k, b'_k = b_{2k} - q_{k-1} - p_k and
//         U'_k (zero for the last pair) go to the next level's region of
//         the work arrays.
// So A_k and C_k reach the even update through registers and shared
// memory, not device memory.  D' is read back by its lower triangle only
// (thread j's column stores rows >= j of it in its own column; the entry
// above reads thread i's), which keeps every level's D exactly symmetric
// as the elimination assumes.  A root block per lane, then the
// back-substitution level by level, coarsest first: thread i of a unit's
// group forms row i of x_{2k+1} = beta_k - A_k x_{2k} - C_k x_{2k+2}.
//
// Layouts: level 0 reads the caller's arrays; level l >= 1's block k is
// slot H2 - 2 (H2 >> l) + k of the work arrays Dw, Uw (column-major M x M
// blocks, a lane's block contiguous: [slot][B][M][M]) and bw ([slot][B][M]);
// A_k, C_k ([H2][B][M][M], column-major) and beta_k ([H2][B][M]) sit at the
// padded-system index (2k + 1) << l of their odd block, x (H2, M, B) at
// its own.  A lane past B runs nothing.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kMaxThreads = 256;

// threads per unit: the power of two >= M (M <= 16)
__host__ __device__ constexpr int group_size(int M) {
  return M <= 2 ? 2 : M <= 4 ? 4 : M <= 8 ? 8 : 16;
}

// shared floats of a group: L (row-major, its diagonal replaced by the
// reciprocal; then P_k and D'_k, column-major), U_{2k} and U_{2k+1}^T
// (row-major; then A_k and C_k, column-major) and U'_k (then D_{2k})
__host__ __device__ constexpr int group_floats(int M) { return 4 * M * M; }

// a ring slot: Q_k (column j at j M) and q_k
__host__ __device__ constexpr int slot_floats(int M) { return M * M + M; }

// dynamic shared memory of a block, in floats (ops/btridiag_kernel.py's
// cr_launch_config mirrors it): the groups' areas and a ring of groups +
// lanes slots (a chunk's units and the `lanes` before them)
__host__ __device__ constexpr size_t cr_smem_floats(int M, int groups,
                                                    int lanes) {
  return static_cast<size_t>(groups) * group_floats(M)
         + static_cast<size_t>(groups + lanes) * slot_floats(M);
}

// The level-0 system, the caller's arrays: block k's entry (i, j) of D,
// of U (shared over the batch) and entry i of b; identity blocks at or
// past H, zero coupling at or past H - 1.
template <int M>
__device__ __forceinline__ float caller_d(const float* D, int k, int i,
                                          int j, int H, size_t sB, int lane) {
  if (k >= H) return i == j ? 1.f : 0.f;
  return D[((static_cast<size_t>(k) * M + i) * M + j) * sB + lane];
}

template <int M>
__device__ __forceinline__ float caller_u(const float* U, int k, int i,
                                          int j, int H) {
  if (k >= H - 1) return 0.f;
  return __ldg(U + (static_cast<size_t>(k) * M + i) * M + j);
}

template <int M>
__device__ __forceinline__ float caller_b(const float* b, int k, int i,
                                          int H, size_t sB, int lane) {
  if (k >= H) return 0.f;
  return b[(static_cast<size_t>(k) * M + i) * sB + lane];
}

// a group's copy of an M x M block between device and shared memory, its
// threads on consecutive floats
template <int M>
__device__ __forceinline__ void copy_block(float* dst, const float* src,
                                           int j) {
  constexpr int G = group_size(M);
#pragma unroll
  for (int f = j; f < M * M; f += G) dst[f] = src[f];
}

// Cholesky of the group's block and the solve of NC right-hand columns:
// thread jc holds column jc of the block in a[] and its own NC columns in
// c[][] (columns the group shares, as b, are held by every thread).  A
// right-looking elimination over the pivots (btridiag.cu's, the pivot
// column broadcast by shuffles inside the group) gives L^-1 c; L goes to
// Lsm (row-major, the reciprocal of each pivot on the diagonal) and each
// thread solves L^T on its own columns -> c = D^-1 c.
template <int M, int NC>
__device__ __forceinline__ void factor_solve(float (&a)[M],
                                             float (&c)[NC][M], float* Lsm,
                                             int j, int jc, unsigned gmask) {
  constexpr int G = group_size(M);
  float inv_own = 0.f;
#pragma unroll
  for (int p = 0; p < M; ++p) {
    const float inv = 1.f / sqrtf(__shfl_sync(gmask, a[p], p, G));
    float lc[M];
#pragma unroll
    for (int i = p + 1; i < M; ++i)
      lc[i] = __shfl_sync(gmask, a[i], p, G) * inv;
#pragma unroll
    for (int n = 0; n < NC; ++n) {
      c[n][p] *= inv;
#pragma unroll
      for (int i = p + 1; i < M; ++i) c[n][i] = fmaf(-lc[i], c[n][p], c[n][i]);
    }
    const float lj = jc > p ? a[p] * inv : 0.f;          // L[jc][p] or 0
#pragma unroll
    for (int i = p + 1; i < M; ++i) a[i] = fmaf(-lc[i], lj, a[i]);
    inv_own = jc == p ? inv : inv_own;
  }
  if (j < M) {
#pragma unroll
    for (int i = 0; i < M; ++i)
      if (i >= j) Lsm[i * M + j] = i == j ? inv_own : a[i] * inv_own;
  }
  __syncwarp(gmask);
  // L^T, right-looking as the elimination: x_t, then every row above it
  // takes its term, so the dependent chain is M links, not M^2 / 2
#pragma unroll
  for (int t = M - 1; t >= 0; --t) {
    const float inv_t = Lsm[t * M + t];
#pragma unroll
    for (int n = 0; n < NC; ++n) c[n][t] *= inv_t;
#pragma unroll
    for (int i = 0; i < t; ++i) {
      const float lt = Lsm[t * M + i];                   // L[t][i]
#pragma unroll
      for (int n = 0; n < NC; ++n) c[n][i] = fmaf(-lt, c[n][t], c[n][i]);
    }
  }
}

template <int M>
__global__ void __launch_bounds__(kMaxThreads, 1)
cr_kernel(const float* __restrict__ D, const float* __restrict__ U,
          const float* __restrict__ b, float* x, float* Af, float* Cf,
          float* beta, float* Dw, float* Uw, float* bw, int H, int H2, int B,
          int lanes) {
  constexpr int G = group_size(M);
  constexpr int MM = M * M;
  extern __shared__ float smem[];
  const int tid = threadIdx.x;
  const int groups = blockDim.x / G;
  const int g = tid / G;                 // this thread's group
  const int j = tid % G;                 // its column (or row)
  const int jc = j < M ? j : M - 1;      // idle threads shadow M - 1
  const unsigned gmask = ((1u << G) - 1u) << ((tid & 31) & ~(G - 1));
  const int l0 = blockIdx.x * lanes;
  const int n_lanes = B - l0 < lanes ? B - l0 : lanes;
  const size_t sB = B;
  float* Lsm = smem + g * group_floats(M);   // L, then P_k, then D'_k
  float* Uesm = Lsm + MM;       // U_{2k} row-major, then A_k column-major
  float* UoTsm = Uesm + MM;     // U_{2k+1}^T row-major, then C_k
  float* Xsm = UoTsm + MM;      // U'_k, then D_{2k} (column-major)
  float* ring = smem + groups * group_floats(M);
  const int n_slots = groups + lanes;
  // block k of level l >= 1 of lane `lane` in the work arrays
  auto work = [&](float* w, int base, int k, int lane, int n) {
    return w + (static_cast<size_t>(base + k) * sB + lane) * n;
  };

  int l = 0, base = 0;                   // level l's first work slot
  for (int n = H2; n > 1; n /= 2, ++l) {
    const int half = n / 2;
    const int units = half * lanes;
    const int next_base = H2 - n;        // level l + 1's first slot
    for (int c0 = 0; c0 < units; c0 += groups) {
      const int u = c0 + g;
      const int k = u / lanes, ll = u - k * lanes;
      const int lane = l0 + ll;
      const bool active = u < units && ll < n_lanes;
      float de[M], bj = 0.f, pj = 0.f;
      if (active) {
        // odd: [A_k | C_k | beta_k] = D_{2k+1}^-1 [U_{2k}^T | U_{2k+1} |
        // b_{2k+1}], with U_{2k} and U_{2k+1}^T staged row-major
        float a[M], c[3][M];
        if (l == 0) {
          if (j < M) {
#pragma unroll
            for (int i = 0; i < M; ++i) {
              Uesm[i * M + j] = caller_u<M>(U, 2 * k, i, j, H);
              UoTsm[j * M + i] = caller_u<M>(U, 2 * k + 1, i, j, H);
            }
          }
#pragma unroll
          for (int i = 0; i < M; ++i) {
            a[i] = i >= jc ? caller_d<M>(D, 2 * k + 1, i, jc, H, sB, lane)
                           : caller_d<M>(D, 2 * k + 1, jc, i, H, sB, lane);
            c[2][i] = caller_b<M>(b, 2 * k + 1, i, H, sB, lane);
          }
          __syncwarp(gmask);
        } else {
          const float* Ue = work(Uw, base, 2 * k, lane, MM);
#pragma unroll
          for (int f = j; f < MM; f += G) {
            Lsm[f] = work(Dw, base, 2 * k + 1, lane, MM)[f];
            Uesm[(f % M) * M + f / M] = Ue[f];
            UoTsm[f] = work(Uw, base, 2 * k + 1, lane, MM)[f];
          }
          const float* bo = work(bw, base, 2 * k + 1, lane, M);
#pragma unroll
          for (int i = 0; i < M; ++i) c[2][i] = bo[i];
          __syncwarp(gmask);
#pragma unroll
          for (int i = 0; i < M; ++i)
            a[i] = i >= jc ? Lsm[jc * M + i] : Lsm[i * M + jc];
          __syncwarp(gmask);             // Lsm takes L next
        }
#pragma unroll
        for (int i = 0; i < M; ++i) {
          c[0][i] = Uesm[jc * M + i];
          c[1][i] = UoTsm[jc * M + i];
        }
        factor_solve<M, 3>(a, c, Lsm, j, jc, gmask);
        __syncwarp(gmask);  // L is read; P_k takes its place
        // the even update's terms from rows of U_{2k} and U_{2k+1}^T:
        // P_k (column jc to Lsm), U'_k (to Xsm), p_k here, Q_k and q_k to
        // the ring for unit (k + 1, lane)
        float* slot = ring + (u % n_slots) * slot_floats(M);
        // (rolled over the rows i: unrolled, the rows' loads are hoisted
        // and M = 16 runs out of registers)
#pragma unroll 1
        for (int i = 0; i < M; ++i) {
          float pa = 0.f, pc = 0.f, qc = 0.f;
#pragma unroll
          for (int t = 0; t < M; t += 2) {
            const float2 ue =
                *reinterpret_cast<const float2*>(Uesm + i * M + t);
            const float2 uo =
                *reinterpret_cast<const float2*>(UoTsm + i * M + t);
            pa = fmaf(ue.y, c[0][t + 1], fmaf(ue.x, c[0][t], pa));
            pc = fmaf(ue.y, c[1][t + 1], fmaf(ue.x, c[1][t], pc));
            qc = fmaf(uo.y, c[1][t + 1], fmaf(uo.x, c[1][t], qc));
          }
          if (j < M) {
            Lsm[j * M + i] = pa;
            Xsm[j * M + i] = -pc;
            slot[j * M + i] = qc;
          }
        }
        float qj = 0.f;
#pragma unroll
        for (int i = 0; i < M; ++i) {
          pj = fmaf(Uesm[jc * M + i], c[2][i], pj);
          qj = fmaf(UoTsm[jc * M + i], c[2][i], qj);
        }
        float betaj = 0.f;
#pragma unroll
        for (int i = 0; i < M; ++i) betaj = i == jc ? c[2][i] : betaj;
        if (j < M) slot[MM + j] = qj;
        __syncwarp(gmask);  // U_{2k}, U_{2k+1}^T are read
        if (j < M) {
#pragma unroll
          for (int i = 0; i < M; ++i) {
            Uesm[j * M + i] = c[0][i];
            UoTsm[j * M + i] = c[1][i];
          }
        }
        __syncwarp(gmask);
        // A_k, C_k and beta_k for the back-substitution, U'_k (zero for
        // the last pair) for level l + 1, in whole rows of floats
        const size_t odd = static_cast<size_t>(2 * k + 1) << l;
        const bool last = k == half - 1;
        float* un = work(Uw, next_base, k, lane, MM);
#pragma unroll
        for (int f = j; f < MM; f += G) {
          Af[(odd * sB + lane) * MM + f] = Uesm[f];
          Cf[(odd * sB + lane) * MM + f] = UoTsm[f];
          un[f] = last ? 0.f : Xsm[f];
        }
        if (j < M) beta[(odd * sB + lane) * M + j] = betaj;
        // level l + 1's block k starts from D_{2k}, b_{2k}: loads in flight
        // over the barrier
        if (l == 0) {
#pragma unroll
          for (int i = 0; i < M; ++i)
            de[i] = i >= jc ? caller_d<M>(D, 2 * k, i, jc, H, sB, lane)
                            : caller_d<M>(D, 2 * k, jc, i, H, sB, lane);
          bj = caller_b<M>(b, 2 * k, jc, H, sB, lane);
        } else {
          __syncwarp(gmask);             // U'_k is out of Xsm
          copy_block<M>(Xsm, work(Dw, base, 2 * k, lane, MM), j);
          bj = work(bw, base, 2 * k, lane, M)[jc];
        }
      }
      __syncthreads();  // the chunk's Q, q are in the ring
      if (active) {
        // even: D'_k = D_{2k} - Q_{k-1} - P_k (column j to Lsm, over P_k),
        // b'_k = b_{2k} - q_{k-1} - p_k
        if (l > 0) {
#pragma unroll
          for (int i = 0; i < M; ++i)
            de[i] = i >= jc ? Xsm[jc * M + i] : Xsm[i * M + jc];
        }
        if (k > 0) {
          const float* prev =
              ring + ((u - lanes) % n_slots) * slot_floats(M);
#pragma unroll
          for (int i = 0; i < M; ++i) de[i] -= prev[jc * M + i];
          bj -= prev[MM + jc];
        }
        if (j < M) {
#pragma unroll
          for (int i = 0; i < M; ++i) Lsm[j * M + i] = de[i] - Lsm[j * M + i];
          work(bw, next_base, k, lane, M)[j] = bj - pj;
        }
        __syncwarp(gmask);
        copy_block<M>(work(Dw, next_base, k, lane, MM), Lsm, j);
      }
      __syncthreads();  // the ring is free; level l + 1's block k is out
    }
    base = next_base;
  }

  // the root: x_0 = D_root^-1 b_root
  for (int c0 = 0; c0 < lanes; c0 += groups) {
    const int ll = c0 + g;
    if (ll < n_lanes) {
      const int lane = l0 + ll;
      float a[M], c[1][M];
#pragma unroll
      for (int i = 0; i < M; ++i) {
        if (l == 0) {
          a[i] = i >= jc ? caller_d<M>(D, 0, i, jc, H, sB, lane)
                         : caller_d<M>(D, 0, jc, i, H, sB, lane);
          c[0][i] = caller_b<M>(b, 0, i, H, sB, lane);
        } else {
          const float* Dr = work(Dw, base, 0, lane, MM);
          a[i] = i >= jc ? Dr[jc * M + i] : Dr[i * M + jc];
          c[0][i] = work(bw, base, 0, lane, M)[i];
        }
      }
      factor_solve<M, 1>(a, c, Lsm, j, jc, gmask);
      float xj = 0.f;
#pragma unroll
      for (int i = 0; i < M; ++i) xj = i == jc ? c[0][i] : xj;
      if (j < M) x[static_cast<size_t>(j) * sB + lane] = xj;
    }
    __syncwarp();
  }
  __syncthreads();

  // back-substitution, coarsest level first: row jc of
  // x_{2k+1} = beta_k - A_k x_{2k} - C_k x_{2k+2} (x_{2k+2} = 0 past the
  // last block), at padded-system indices
  for (--l; l >= 0; --l) {
    const int half = (H2 >> l) / 2;
    const int units = half * lanes;
    for (int c0 = 0; c0 < units; c0 += groups) {
      const int u = c0 + g;
      const int k = u / lanes, ll = u - k * lanes;
      if (u < units && ll < n_lanes && j < M) {
        const int lane = l0 + ll;
        const size_t odd = static_cast<size_t>(2 * k + 1) << l;
        const size_t ev = static_cast<size_t>(2 * k) << l;
        const size_t nx = static_cast<size_t>(2 * k + 2) << l;
        const size_t m0 = (odd * sB + lane) * MM;
        float ta = 0.f, tc = 0.f;
#pragma unroll
        for (int p = 0; p < M; ++p)
          ta = fmaf(Af[m0 + p * M + j], x[(ev * M + p) * sB + lane], ta);
        if (k + 1 < half) {
#pragma unroll
          for (int p = 0; p < M; ++p)
            tc = fmaf(Cf[m0 + p * M + j], x[(nx * M + p) * sB + lane], tc);
        }
        x[(odd * M + j) * sB + lane] =
            beta[(odd * sB + lane) * M + j] - ta - tc;
      }
    }
    __syncthreads();  // this level's x is read by the next
  }
}

template <int M>
cudaError_t launch(const float* D, const float* U, const float* b, float* x,
                   float* Af, float* Cf, float* beta, float* Dw, float* Uw,
                   float* bw, int H, int H2, int B, int lanes, int threads,
                   cudaStream_t stream) {
  constexpr int G = group_size(M);
  if (lanes < 1 || threads < 32 || threads > kMaxThreads || threads % 32)
    return cudaErrorInvalidValue;
  const size_t smem = cr_smem_floats(M, threads / G, lanes) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        cr_kernel<M>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const int blocks = (B + lanes - 1) / lanes;
  cr_kernel<M><<<blocks, threads, smem, stream>>>(D, U, b, x, Af, Cf, beta,
                                                  Dw, Uw, bw, H, H2, B,
                                                  lanes);
  return cudaGetLastError();
}

}  // namespace

// D (H, M, M, B), U (H, M, M), b (H, M, B) -> x (H2, M, B), H2 the power of
// two at or above H; A, C (H2 M^2 B floats each), beta (H2 M B) and the
// work arrays Dw, Uw (max(H2 - 1, 1) M^2 B), bw (max(H2 - 1, 1) M B) are
// device scratch; `lanes` lanes a block of `threads` threads (a multiple of
// 32, at most 256).  Returns a CUDA error code (cudaErrorInvalidValue for
// M outside {2, 4, ..., 16}, H2 not the power of two at or above H, or a
// bad block).
extern "C" int trt_btridiag_cr_launch(const float* D, const float* U,
                                      const float* b, float* x, float* Af,
                                      float* Cf, float* beta, float* Dw,
                                      float* Uw, float* bw, int H, int H2,
                                      int M, int B, int lanes, int threads,
                                      void* stream) {
  if (H < 1 || H2 < H || (H2 & (H2 - 1)) != 0 || (H2 > 1 && H2 / 2 >= H))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define TRT_CR(m)                                                          \
  launch<m>(D, U, b, x, Af, Cf, beta, Dw, Uw, bw, H, H2, B, lanes, threads, \
            s)
  switch (M) {
    case 2: return TRT_CR(2);
    case 4: return TRT_CR(4);
    case 6: return TRT_CR(6);
    case 8: return TRT_CR(8);
    case 10: return TRT_CR(10);
    case 12: return TRT_CR(12);
    case 14: return TRT_CR(14);
    case 16: return TRT_CR(16);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef TRT_CR
}
