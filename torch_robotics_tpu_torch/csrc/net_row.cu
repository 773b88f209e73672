// The learned self-collision row of the GN obstacle terms and of the
// value-only collision cost: per waypoint lane n of q_cols (d, N), the MLP
// signed distance sd(q), the hinge r = relu(cutoff - sd) with act = r > 0,
// and (terms) the gradient d sd/dq by the explicit backward chain.
//
//   The terms kernels (trt_net_terms_launch) add the row's exact
//     contribution to the terms kernel's unscaled outputs: 0.5 r^2 to
//     cost[n], r Jr_j to g[j, n] and Jr_i Jr_j to Hqq[i, j, n], where
//     Jr_j = -act d sd/dq_j;
//   the cost kernels (trt_net_cost_launch) add 0.5 r^2 to cost[n].
//
// They replace the net row of the TPU kernels in
// torch_robotics_tpu/ops/pallas_terms.py: _scalarize_net and
// _net_signed_distance evaluated inside obstacle_terms_pallas_factory's
// tile body (the vjp row; pallas_call of _build_terms) and inside
// collision_cost_pallas_factory's (value only).  Their plain PyTorch
// version is torch_robotics_tpu_torch/ops/net_kernel.py's net_rows (the
// module's own matmul chain and its explicit backward).  The row is the
// last of the reference's sums and is additive, so it runs after the terms
// kernel (terms.cu) or the cost kernel (cost.cu) and adds into their
// outputs: the order of summation is the reference's (x 0.5 is exact),
// and those kernels' bits on every other path stay untouched.
//
// What bounds it on the H100: float operations.  The bundled net
// 7-256-128-64-1 takes 42,816 multiply-adds a lane forward and as many
// backward, so K1's row needs ~171 kflop a lane (the backward only where
// the hinge is active) against ~240 bytes of traffic; at N = 65,536 that is
// ~0.17 ms of FP32 work at 67 TFLOP/s and ~5 us of HBM traffic.  The
// tensor cores are the only way under that FP32 bound.
//
// Two routes, picked from the widths and the activation alone by
// net_launch_config (ops/net_kernel.py), each with its own packing
// (pack_net_params):
//
// tf32x3 (net_terms_tc_kernel / net_cost_tc_kernel<H1, H2, H3>, the
//   bundled widths d <= 8, 256, 128, 64, 1, relu or tanh).  Every hidden
//   layer's product (and the terms' backward products) runs on the tensor
//   cores (mma.sync.m16n8k8 TF32, FP32 accumulate) in three passes that
//   carry float32's accuracy: a = a_hi + a_lo with a_hi = rna_tf32(a) and
//   a_lo = rna_tf32(a - a_hi), and D += a_lo b_hi + a_hi b_lo + a_hi b_hi
//   (the dropped a_lo b_lo is ~2^-22 of a b), the counterpart of the
//   reference's precision=HIGHEST products.  mma.sync, not wgmma: a 16-
//   lane tile keeps every activation in registers and chains the layers
//   fragment to fragment, where wgmma's 64-row tiles would put them in
//   shared memory beside the staged net, which it nearly fills.  The
//   output layer (64 -> 1) and the hinge stay FP32 on the CUDA cores.
//   One persistent block a multiprocessor stages the whole packed net
//   (~177 KB: each W as (out, in), the reference's layout, rows padded to
//   a stride that is 8 mod 16 so that both the forward's float2 fragment
//   loads and the backward's transposed scalar loads hit 32 banks) into
//   shared memory once with cp.async; its warps then walk over tiles of
//   lanes (16 for the terms, 32 for the cost: two m-tiles that share each
//   B fragment's split), one tile a warp at a time, with every activation
//   in registers: an accumulator fragment of one layer is the A fragment
//   of the next when the k index of that A fragment is read as the
//   permutation t <-> 2t, t + 4 <-> 2t + 1 (the B fragments load rows 2t
//   and 2t + 1 to match).  Layer 1 (8 -> 256) is computed 8 units at a
//   time and fed straight into layer 2's product, so the 256-wide
//   activation is never held whole; the backward recomputes those chunks.
//   The terms kernel answers two faults that the plain version on the
//   card (cuBLAS, bit for bit a sequential FMA over k) does not have:
//   relu'(h) is a decision on h's sign, so its layer 1 runs in that order
//   in FP32 and an active lane with a relu unit of layer 2 or 3 near its
//   kink is recomputed in that order (near_kink); and the tensor cores
//   truncate when they accumulate, so it sums 4 k-tiles at a time into a
//   fresh accumulator (add_frag).  A warp whose 16 lanes are all inactive
//   skips the backward.
//
// simt (net_row_kernel<kTerms>, any other net whose tile fits; the
//   first, FP32 design): a block owns a tile of TL lanes (32, halved for
//   wide nets) and keeps every layer's activations for the tile in shared
//   memory, feature-major (rows of TL floats), so the backward pass
//   overwrites each layer's stored activation with its delta in place.
//   Each layer is a small FP32 GEMM: a thread computes 4 outputs x 4 lanes
//   at a time, summing over the inputs in ascending order with fmaf, weight
//   rows read as 16-byte loads through L1 / L2, activations as 16-byte
//   shared loads.
//   Every width is padded to a multiple of 4 with zero weights.  The last
//   layer (one output) and the input gradient (d outputs) are one dot
//   product a thread.
//
// Both: padded features and lanes past N are exact zeros; an inactive
// lane's outputs are never written (its contribution is exactly zero), so
// skipping the backward changes no bit; (q - mean) / std uses correctly
// rounded division; relu'(h) is h > 0 on the stored activation; the row's
// adds (add_row_item) are the same code in the reference's order.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

// Packed parameters, written by pack_net_params in
// torch_robotics_tpu_torch/ops/net_kernel.py.
//   ints:   [L, activation (0 relu, 1 tanh), d, route (0 simt, 1 tf32x3),
//           wp_0, ..., wp_L] (L layers, wp_l the padded widths)
//   simt floats: [scale, shift, cutoff, 0, mean (wp_0), std (wp_0), then
//           per layer l: W_l (wp_l, wp_{l+1}) row-major, b_l (wp_{l+1})],
//           widths padded to a multiple of 4
//   tf32x3 floats: [scale, shift, cutoff, 0, mean (8), std (8), then per
//           hidden layer l: W_l^T (out, in) with rows of TcStride(in)
//           floats, b_l (out); then w_L (H3), b_L padded to 4] (TcLayout)
constexpr int kIntHeader = 4;
constexpr int kFloatHeader = 4;

__device__ __forceinline__ float activate(float v, int act) {
  return act == 0 ? fmaxf(v, 0.f) : tanhf(v);
}

// act'(pre-activation) from the stored activation h: relu'(0) = 0.
__device__ __forceinline__ float activate_grad(float h, int act) {
  return act == 0 ? (h > 0.f ? 1.f : 0.f) : 1.f - h * h;
}

__device__ __forceinline__ float4 lds4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 ldg4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

__device__ __forceinline__ float comp(const float4& v, int i) {
  return i == 0 ? v.x : (i == 1 ? v.y : (i == 2 ? v.z : v.w));
}

// y (wo, TL) = act(W^T x + b) for x (wi, TL), W (wi, wo), b (wo).
__device__ void dense_forward(const float* __restrict__ W,
                              const float* __restrict__ b, const float* x,
                              float* y, int wi, int wo, int TL, int act) {
  const int ng = TL >> 2;
  const int items = (wo >> 2) * ng;
  for (int it = threadIdx.x; it < items; it += blockDim.x) {
    const int f0 = (it / ng) << 2, n0 = (it % ng) << 2;
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll 4
    for (int k = 0; k < wi; ++k) {
      const float4 w = ldg4(W + (size_t)k * wo + f0);
      const float4 v = lds4(x + k * TL + n0);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          acc[i][j] = fmaf(comp(w, i), comp(v, j), acc[i][j]);
    }
    const float4 bb = ldg4(b + f0);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float bi = comp(bb, i);
      float4 out;
      out.x = activate(acc[i][0] + bi, act);
      out.y = activate(acc[i][1] + bi, act);
      out.z = activate(acc[i][2] + bi, act);
      out.w = activate(acc[i][3] + bi, act);
      *reinterpret_cast<float4*>(y + (f0 + i) * TL + n0) = out;
    }
  }
}

// h (wi, TL) <- (W delta) * act'(h) for delta (wo, TL), W (wi, wo): the
// stored activation becomes its layer's delta, in place (each thread reads
// and writes only its own entries of h).
__device__ void dense_backward(const float* __restrict__ W,
                               const float* delta, float* h, int wi, int wo,
                               int TL, int act) {
  const int ng = TL >> 2;
  const int items = (wi >> 2) * ng;
  for (int it = threadIdx.x; it < items; it += blockDim.x) {
    const int k0 = (it / ng) << 2, n0 = (it % ng) << 2;
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    for (int f = 0; f < wo; f += 4) {
      float4 w[4], dv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) w[i] = ldg4(W + (size_t)(k0 + i) * wo + f);
#pragma unroll
      for (int t = 0; t < 4; ++t) dv[t] = lds4(delta + (f + t) * TL + n0);
#pragma unroll
      for (int t = 0; t < 4; ++t)
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            acc[i][j] = fmaf(comp(w[i], t), comp(dv[t], j), acc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float4 hv = lds4(h + (k0 + i) * TL + n0);
      hv.x = acc[i][0] * activate_grad(hv.x, act);
      hv.y = acc[i][1] * activate_grad(hv.y, act);
      hv.z = acc[i][2] * activate_grad(hv.z, act);
      hv.w = acc[i][3] * activate_grad(hv.w, act);
      *reinterpret_cast<float4*>(h + (k0 + i) * TL + n0) = hv;
    }
  }
}

// Item e of lane gn's exact row contribution, per_lane = d + d (d + 1) / 2
// + 1 items a lane: r Jr_e to g (e < d), Jr_i Jr_j to Hqq[i, j] and
// Hqq[j, i] (the next d (d + 1) / 2, upper triangle row by row), 0.5 r^2
// to cost (the last); gq[j * stride] is d sd/dq_j, Jr = -gq.  Called only
// for an active lane (r > 0).
__device__ __forceinline__ void add_row_item(int e, int d, float r,
                                             const float* gq, int stride,
                                             size_t gn, int N, float* g_out,
                                             float* h_out, float* cost_out) {
  const int n_h = d * (d + 1) / 2;
  if (e < d) {
    const float jr = -gq[e * stride];
    g_out[(size_t)e * N + gn] += r * jr;
  } else if (e < d + n_h) {
    int t = e - d, i = 0;
    while (t >= d - i) {
      t -= d - i;
      ++i;
    }
    const int j = i + t;
    const float v = (-gq[i * stride]) * (-gq[j * stride]);
    h_out[((size_t)i * d + j) * N + gn] += v;
    if (i != j) h_out[((size_t)j * d + i) * N + gn] += v;
  } else {
    const float r2 = __fmul_rn(r, r);
    cost_out[gn] += 0.5f * r2;
  }
}

template <bool kTerms>
__global__ void __launch_bounds__(kThreads)
net_row_kernel(const float* __restrict__ q, float* __restrict__ g_out,
               float* __restrict__ h_out, float* __restrict__ cost_out,
               int N, const int* __restrict__ ip,
               const float* __restrict__ fp, int TL) {
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  const int L = ip[0], act = ip[1], d = ip[2];
  const int* wp = ip + kIntHeader;
  const int tile0 = blockIdx.x * TL;
  const float scale = fp[0], shift = fp[1], cutoff = fp[2];
  const float* mean = fp + kFloatHeader;
  const float* stdv = mean + wp[0];
  const float* W0 = stdv + wp[0];

  // ---- normalized input x0 (wp_0, TL); padded rows and lanes are 0 ----
  for (int it = threadIdx.x; it < wp[0] * TL; it += blockDim.x) {
    const int j = it / TL, n = tile0 + it % TL;
    sm[it] = (j < d && n < N) ? (q[(size_t)j * N + n] - mean[j]) / stdv[j]
                              : 0.f;
  }
  __syncthreads();

  // ---- forward: hidden layers 1 .. L-1, each buffer after the last ----
  const float* W = W0;
  float* x = sm;
  for (int l = 0; l + 1 < L; ++l) {
    const float* b = W + wp[l] * wp[l + 1];
    float* y = x + wp[l] * TL;
    dense_forward(W, b, x, y, wp[l], wp[l + 1], TL, act);
    __syncthreads();
    W = b + wp[l + 1];
    x = y;
  }
  // the last layer (one output, stored padded to 4 columns): sd and r
  const float* w_last = W;
  const int wl = wp[L - 1];
  float* rbuf = x + wl * TL;
  bool my_active = false;
  if (threadIdx.x < TL) {
    const int n = threadIdx.x;
    float s = 0.f;
    for (int k = 0; k < wl; ++k) s = fmaf(w_last[k * 4], x[k * TL + n], s);
    const float sd = -((s + w_last[wl * 4]) * scale + shift);
    const float r = fmaxf(cutoff - sd, 0.f);
    my_active = tile0 + n < N && r > 0.f;
    rbuf[n] = my_active ? r : 0.f;
    if (!kTerms && my_active) {
      const float r2 = __fmul_rn(r, r);
      cost_out[tile0 + n] += 0.5f * r2;
    }
  }
  if (!kTerms) return;
  if (!__syncthreads_or(my_active)) return;

  // ---- backward: delta of the last hidden layer, then down the chain ----
  for (int it = threadIdx.x; it < wl * TL; it += blockDim.x)
    x[it] = w_last[(it / TL) * 4] * activate_grad(x[it], act);
  __syncthreads();
  // the buffers' offsets and the weights' offsets, walked from the start
  for (int l = L - 2; l >= 1; --l) {
    const float* Wl = W0;
    float* hl = sm;
    for (int i = 0; i < l; ++i) {
      Wl += wp[i] * wp[i + 1] + wp[i + 1];
      hl += wp[i] * TL;
    }
    dense_backward(Wl, hl + wp[l] * TL, hl, wp[l], wp[l + 1], TL, act);
    __syncthreads();
  }
  // input gradient: d sd/dq_j = -scale (W_0 delta_1)_j / std_j, over x0
  const float* delta1 = sm + wp[0] * TL;
  for (int it = threadIdx.x; it < d * TL; it += blockDim.x) {
    const int j = it / TL, n = it % TL;
    const float* wrow = W0 + j * wp[1];
    float s = 0.f;
    for (int f = 0; f < wp[1]; ++f) s = fmaf(wrow[f], delta1[f * TL + n], s);
    sm[it] = (-scale * s) / stdv[j];
  }
  __syncthreads();

  // ---- epilogue: the row's exact contribution, active lanes only ----
  const int per_lane = d + d * (d + 1) / 2 + 1;
  for (int it = threadIdx.x; it < per_lane * TL; it += blockDim.x) {
    const int e = it / TL, n = it % TL;
    const float r = rbuf[n];
    if (!(r > 0.f)) continue;
    add_row_item(e, d, r, sm + n, TL, (size_t)tile0 + n, N, g_out, h_out,
                 cost_out);
  }
}

// ---------------------------------------------------------------------
// The tf32x3 route: tensor cores, weights staged on chip, lane tiles
// ---------------------------------------------------------------------
constexpr int kTcThreads = 256;   // 8 warps, one block a multiprocessor
constexpr int kTcIn = 8;          // the input width, padded (one k step)
// scratch floats a warp (terms only): r and d sd/dq of 16 lanes, their
// inputs x0 (16 x 8), then one lane's sequential FP32 forward (x0, h1, h2,
// h3) for the repair
template <int H1, int H2, int H3>
__host__ __device__ constexpr int TcScratch() {
  return 16 * (kTcIn + 1) + 16 * kTcIn + kTcIn + H1 + H2 + H3;
}

// Row stride of a (out, in) weight in shared memory: the least >= in that
// is 8 mod 16, so that 8 consecutive rows start in 4 distinct bank octets.
__host__ __device__ constexpr int TcStride(int in) {
  return in + ((8 - in) % 16 + 16) % 16;
}

// Offsets (floats) of the tf32x3 packing; every section starts 16-byte
// aligned.  wn2 / wn3: the 2-norm of each column of W1 / W2 (a unit's
// weights), for the repair's bound.
template <int H1, int H2, int H3>
struct TcLayout {
  static constexpr int S0 = TcStride(kTcIn), S1 = TcStride(H1),
                       S2 = TcStride(H2);
  static constexpr int mean = 4, stdv = mean + kTcIn, W0 = stdv + kTcIn;
  static constexpr int b0 = W0 + H1 * S0, W1 = b0 + H1;
  static constexpr int b1 = W1 + H2 * S1, W2 = b1 + H2;
  static constexpr int b2 = W2 + H3 * S2, w3 = b2 + H3, b3 = w3 + H3;
  static constexpr int wn2 = b3 + 4, wn3 = wn2 + H2;
  static constexpr int n_floats = wn3 + H3;
  static_assert(H1 % 32 == 0 && H2 % 32 == 0 && H3 % 32 == 0,
                "hidden widths are whole groups of kGroup k-tiles");
  static_assert(n_floats % 4 == 0 && W0 % 4 == 0, "16-byte sections");
};

// cvt.rna.tf32.f32 for a finite x (round to nearest, ties away from zero,
// on the 13 low mantissa bits) as two integer operations: ptxas expands
// the cvt itself with an inf / NaN test and a select around the same add
// and mask.  The results are TF32 bit patterns (low 13 bits 0).
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

// x = hi + lo, both TF32 (lo rounded too: x - hi - lo is ~2^-22 of x)
struct Split {
  uint32_t hi, lo;
  __device__ __forceinline__ explicit Split(float x) {
    hi = tf32_rna(x);
    lo = tf32_rna(x - __uint_as_float(hi));
  }
};

// d += A (16 x 8) B (8 x 8), TF32 operands, FP32 accumulate.  Fragments
// (g = lane / 4, t = lane % 4): a = {A[g][t], A[g+8][t], A[g][t+4],
// A[g+8][t+4]}, b = {B[t][g], B[t+4][g]}, d = {D[g][2t], D[g][2t+1],
// D[g+8][2t], D[g+8][2t+1]}.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// An A fragment, split, from the accumulator fragment c of the layer
// before: k index t reads c's column 2t, k index t + 4 column 2t + 1
// (forward), or, with swap = t / 2 (backward, to match frag_bwd's rows),
// columns 2t + swap and 2t + 1 - swap.
struct FragA {
  uint32_t hi[4], lo[4];
  __device__ __forceinline__ void set(float a0, float a1, float a2,
                                      float a3) {
    const float a[4] = {a0, a1, a2, a3};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const Split s(a[i]);
      hi[i] = s.hi;
      lo[i] = s.lo;
    }
  }
  __device__ __forceinline__ void from_acc(const float (&c)[4]) {
    set(c[0], c[2], c[1], c[3]);
  }
  __device__ __forceinline__ void from_acc_bwd(const float (&c)[4],
                                               bool swap) {
    set(swap ? c[1] : c[0], swap ? c[3] : c[2], swap ? c[0] : c[1],
        swap ? c[2] : c[3]);
  }
};

// A B fragment (rows 2t, 2t + 1 of the k-tile, the permuted k order of
// FragA), split once for every m-tile that uses it.
struct FragB {
  Split b0, b1;
  __device__ __forceinline__ explicit FragB(float2 w) : b0(w.x), b1(w.y) {}
};

// d += A B in three TF32 passes, smallest terms first.
__device__ __forceinline__ void mma3(float (&d)[4], const FragA& a,
                                     const FragB& b) {
  mma_tf32(d, a.lo, b.b0.hi, b.b1.hi);
  mma_tf32(d, a.hi, b.b0.lo, b.b1.lo);
  mma_tf32(d, a.hi, b.b0.hi, b.b1.hi);
}

// acc += tmp, four FP32 adds rounded to nearest.  The tensor cores
// truncate when they accumulate, so a long chain of products into one
// accumulator drifts toward zero: in tests/test_torch_net_tc.py's model of
// truncation the terms row's one-chain products miss its 2e-6 of max hold
// (3.2e-6), its kGroup groups do not (1.4e-6).  So the terms kernel sums
// kGroup k-tiles into a fresh accumulator and adds them here.  The value-
// only row keeps one chain: its value is not differentiated, and its cost
// stays within the same hold under that model (1.3e-6).
constexpr int kGroup = 4;
__device__ __forceinline__ void add_frag(float (&acc)[4],
                                         const float (&tmp)[4]) {
#pragma unroll
  for (int e = 0; e < 4; ++e) acc[e] += tmp[e];
}

// Forward B fragment of k-tile kt, n-tile nt from W^T (out, in), stride S:
// B[k][n] = W^T[n][k] at rows (in) 2t, 2t + 1: one float2.
__device__ __forceinline__ float2 frag_fwd(const float* Wt, int S, int kt,
                                           int nt, int g, int t) {
  return *reinterpret_cast<const float2*>(Wt + (nt * 8 + g) * S + kt * 8 +
                                          2 * t);
}

// Backward B fragment (B = W^T's transpose: B[k = out][n = in]) of k-tile
// kt, n-tile nt: rows kt*8 + 2t and 2t + 1 of W^T at column nt*8 + g.
// Threads t = 2, 3 take the two rows in the other order (k index t reads
// row 2t + 1; FragA::from_acc_bwd matches it), so that each of the two
// loads' 32 threads fall in 32 banks (S is 8 mod 16).
__device__ __forceinline__ float2 frag_bwd(const float* Wt, int S, int kt,
                                           int nt, int g, int t) {
  const int swap = t >> 1;
  const float* p = Wt + (kt * 8 + 2 * t) * S + nt * 8 + g;
  return make_float2(p[swap * S], p[(1 - swap) * S]);
}

__device__ __forceinline__ float2 lds2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}

// The whole packed net into shared memory, once a block.
template <class Lay>
__device__ __forceinline__ void stage_net(float* sm, const float* fp) {
  for (int i = threadIdx.x; i < Lay::n_floats / 4; i += blockDim.x)
    cp_async16(sm + 4 * i, fp + 4 * i);
  cp_async_wait_all();
  __syncthreads();
}

// x0 = (q - mean) / std of lane n, input j (0 past d or N)
__device__ __forceinline__ float input(const float* q, const float* mean,
                                       const float* stdv, int j, int d,
                                       int n, int N) {
  return (j < d && n < N) ? (q[(size_t)j * N + n] - mean[j]) / stdv[j] : 0.f;
}

// act(c + b) in place on an accumulator fragment of n-tile nt (columns 2t,
// 2t + 1), with the bias of those columns
__device__ __forceinline__ void bias_act(float (&c)[4], const float* b, int nt,
                                         int t, int act) {
  const float2 bb = lds2(b + nt * 8 + 2 * t);
  c[0] = activate(c[0] + bb.x, act);
  c[1] = activate(c[1] + bb.y, act);
  c[2] = activate(c[2] + bb.x, act);
  c[3] = activate(c[3] + bb.y, act);
}

// The output layer (FP32) of a 16-lane m-tile from h3: the lane sums of
// w_L h3 for rows g and g + 8, reduced over the quad (every thread of the
// quad gets the same bits).
template <int NT3>
__device__ __forceinline__ float2 out_sums(const float (&h3)[NT3][4],
                                           const float* w3, int t) {
  float sa = 0.f, sb = 0.f;
#pragma unroll
  for (int nt = 0; nt < NT3; ++nt) {
    const float2 w = lds2(w3 + nt * 8 + 2 * t);
    sa = fmaf(w.x, h3[nt][0], sa);
    sa = fmaf(w.y, h3[nt][1], sa);
    sb = fmaf(w.x, h3[nt][2], sb);
    sb = fmaf(w.y, h3[nt][3], sb);
  }
  sa += __shfl_xor_sync(0xffffffffu, sa, 1);
  sa += __shfl_xor_sync(0xffffffffu, sa, 2);
  sb += __shfl_xor_sync(0xffffffffu, sb, 1);
  sb += __shfl_xor_sync(0xffffffffu, sb, 2);
  return make_float2(sa, sb);
}

// The value-only row (K8's): tiles of 32 lanes a warp, two m-tiles that
// share every B fragment and its split; every layer 3xTF32, one
// accumulator a product (add_frag says why that holds), and no relu'
// decision is taken (a pre-activation near 0 moves the value by as
// little).  The terms kernel's signature; g and h are not read.
template <int H1, int H2, int H3>
__global__ void __launch_bounds__(kTcThreads, 1)
net_cost_tc_kernel(const float* __restrict__ q, float*, float*,
                   float* __restrict__ cost_out, int N,
                   const int* __restrict__ ip,
                   const float* __restrict__ fp) {
  using Lay = TcLayout<H1, H2, H3>;
  constexpr int NT1 = H1 / 8, NT2 = H2 / 8, NT3 = H3 / 8, MT = 2;
  constexpr int kLanes = 16 * MT;
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  stage_net<Lay>(sm, fp);
  const int act = ip[1], d = ip[2];
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int warps = blockDim.x >> 5;
  const float scale = sm[0], shift = sm[1], cutoff = sm[2];
  const int n_tiles = (N + kLanes - 1) / kLanes;

  for (int tile = blockIdx.x * warps + (threadIdx.x >> 5); tile < n_tiles;
       tile += gridDim.x * warps) {
    const int n0 = tile * kLanes + g;   // m-tile i: lanes n0 + 16 i (+ 8)
    FragA x[MT];
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      float c[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        c[e] = input(q, sm + Lay::mean, sm + Lay::stdv, 2 * t + (e & 1), d,
                     n0 + 16 * i + (e < 2 ? 0 : 8), N);
      x[i].from_acc(c);
    }
    // layers 1 and 2: each 8-unit chunk of layer 1 is a k-tile of layer 2
    float h2[MT][NT2][4];
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int nt = 0; nt < NT2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) h2[i][nt][e] = 0.f;
#pragma unroll 1
    for (int kc = 0; kc < NT1; ++kc) {
      const FragB w0(frag_fwd(sm + Lay::W0, Lay::S0, 0, kc, g, t));
      FragA a[MT];
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        float c[4] = {0.f, 0.f, 0.f, 0.f};
        mma3(c, x[i], w0);
        bias_act(c, sm + Lay::b0, kc, t, act);
        a[i].from_acc(c);
      }
#pragma unroll
      for (int nt = 0; nt < NT2; ++nt) {
        const FragB w(frag_fwd(sm + Lay::W1, Lay::S1, kc, nt, g, t));
#pragma unroll
        for (int i = 0; i < MT; ++i) mma3(h2[i][nt], a[i], w);
      }
    }
    float h3[MT][NT3][4];
#pragma unroll
    for (int i = 0; i < MT; ++i) {
#pragma unroll
      for (int nt = 0; nt < NT2; ++nt)
        bias_act(h2[i][nt], sm + Lay::b1, nt, t, act);
#pragma unroll
      for (int nt = 0; nt < NT3; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) h3[i][nt][e] = 0.f;
    }
    // layer 3
#pragma unroll
    for (int kt = 0; kt < NT2; ++kt) {
      FragA a[MT];
#pragma unroll
      for (int i = 0; i < MT; ++i) a[i].from_acc(h2[i][kt]);
#pragma unroll
      for (int nt = 0; nt < NT3; ++nt) {
        const FragB w(frag_fwd(sm + Lay::W2, Lay::S2, kt, nt, g, t));
#pragma unroll
        for (int i = 0; i < MT; ++i) mma3(h3[i][nt], a[i], w);
      }
    }
    // layer 3's activation, the output layer (FP32) and the hinge
#pragma unroll
    for (int i = 0; i < MT; ++i) {
#pragma unroll
      for (int nt = 0; nt < NT3; ++nt)
        bias_act(h3[i][nt], sm + Lay::b2, nt, t, act);
      const float2 s = out_sums<NT3>(h3[i], sm + Lay::w3, t);
      const float sum = t == 0 ? s.x : s.y;      // t 0: row g, t 1: g + 8
      const int n = n0 + 16 * i + (t == 0 ? 0 : 8);
      const float sd = -((sum + sm[Lay::b3]) * scale + shift);
      const float r = fmaxf(cutoff - sd, 0.f);
      if (t < 2 && n < N && r > 0.f) cost_out[n] += 0.5f * __fmul_rn(r, r);
    }
  }
}

// Layer 1 (8 -> H1) chunk kc for rows g, g + 8 (inputs xs[g], xs[g + 8],
// rows of 8 in shared memory) in FP32, each pre-activation the sequential
// FMA over the inputs, then + b: the plain chain's own order, so its bits
// and its relu' decisions are the plain version's.  Returns act(pre) as an
// accumulator fragment.
template <class Lay>
__device__ __forceinline__ void layer1_exact(float (&c)[4], const float* sm,
                                             const float* xs, int kc, int g,
                                             int t, int act) {
  const float4 xa0 = *reinterpret_cast<const float4*>(xs + g * kTcIn);
  const float4 xa1 = *reinterpret_cast<const float4*>(xs + g * kTcIn + 4);
  const float4 xb0 = *reinterpret_cast<const float4*>(xs + (g + 8) * kTcIn);
  const float4 xb1 =
      *reinterpret_cast<const float4*>(xs + (g + 8) * kTcIn + 4);
  const float xa[8] = {xa0.x, xa0.y, xa0.z, xa0.w, xa1.x, xa1.y, xa1.z, xa1.w};
  const float xb[8] = {xb0.x, xb0.y, xb0.z, xb0.w, xb1.x, xb1.y, xb1.z, xb1.w};
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const float* w = sm + Lay::W0 + (kc * 8 + 2 * t + u) * Lay::S0;
    const float4 wa = *reinterpret_cast<const float4*>(w);
    const float4 wb = *reinterpret_cast<const float4*>(w + 4);
    const float ws[8] = {wa.x, wa.y, wa.z, wa.w, wb.x, wb.y, wb.z, wb.w};
    float s0 = 0.f, s1 = 0.f;
#pragma unroll
    for (int j = 0; j < kTcIn; ++j) {
      s0 = fmaf(xa[j], ws[j], s0);
      s1 = fmaf(xb[j], ws[j], s1);
    }
    const float b = sm[Lay::b0 + kc * 8 + 2 * t + u];
    c[u] = activate(s0 + b, act);
    c[2 + u] = activate(s1 + b, act);
  }
}

// One layer of one lane in sequential FP32 (the plain chain's order: per
// unit, FMAs over k ascending from 0, then + b), by the whole warp: unit
// lane + 32 i for i < U, the U chains interleaved; in (K) and the weights'
// rows read as float4 from shared memory.
template <int U, int K>
__device__ __forceinline__ void layer_exact(float* out, const float* in,
                                            const float* Wt, int S,
                                            const float* b, int lane,
                                            int act) {
  float s[U];
#pragma unroll
  for (int i = 0; i < U; ++i) s[i] = 0.f;
#pragma unroll 2
  for (int k = 0; k < K; k += 4) {
    const float4 a = *reinterpret_cast<const float4*>(in + k);
#pragma unroll
    for (int i = 0; i < U; ++i) {
      const float4 w =
          *reinterpret_cast<const float4*>(Wt + (lane + 32 * i) * S + k);
      s[i] = fmaf(a.x, w.x, s[i]);
      s[i] = fmaf(a.y, w.y, s[i]);
      s[i] = fmaf(a.z, w.z, s[i]);
      s[i] = fmaf(a.w, w.w, s[i]);
    }
  }
#pragma unroll
  for (int i = 0; i < U; ++i)
    out[lane + 32 * i] = activate(s[i] + b[lane + 32 * i], act);
}

// One lane's x0 (8) and h1 (H1) in sequential FP32 (the plain chain's
// order), by the whole warp, into the warp's scratch hs.
template <class Lay, int H1>
__device__ void lane_layer1_exact(float* hs, const float* sm, const float* q,
                                  int d, int n, int N, int lane, int act) {
  if (lane < kTcIn)
    hs[lane] = input(q, sm + Lay::mean, sm + Lay::stdv, lane, d, n, N);
  __syncwarp();
  layer_exact<H1 / 32, kTcIn>(hs + kTcIn, hs, sm + Lay::W0, Lay::S0,
                              sm + Lay::b0, lane, act);
  __syncwarp();
}

// One lane's forward in sequential FP32 (the plain chain's order), by the
// whole warp: x0 (8), h1 (H1), h2 (H2), h3 (H3) of lane n into the warp's
// scratch hs.
template <class Lay, int H1, int H2, int H3>
__device__ void lane_forward_exact(float* hs, const float* sm, const float* q,
                                   int d, int n, int N, int lane, int act) {
  static_assert(H1 % 32 == 0 && H2 % 32 == 0 && H3 % 32 == 0,
                "a whole number of units a thread");
  lane_layer1_exact<Lay, H1>(hs, sm, q, d, n, N, lane, act);
  float* h1 = hs + kTcIn;
  layer_exact<H2 / 32, H1>(h1 + H1, h1, sm + Lay::W1, Lay::S1, sm + Lay::b1,
                           lane, act);
  __syncwarp();
  layer_exact<H3 / 32, H2>(h1 + H1 + H2, h1 + H1, sm + Lay::W2, Lay::S2,
                           sm + Lay::b2, lane, act);
  __syncwarp();
}

// The 2-norm of row g and of row g + 8 of a fragment array (over the quad)
template <int NT>
__device__ __forceinline__ float2 row_norms(const float (&h)[NT][4]) {
  float a = 0.f, b = 0.f;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    a = fmaf(h[nt][0], h[nt][0], fmaf(h[nt][1], h[nt][1], a));
    b = fmaf(h[nt][2], h[nt][2], fmaf(h[nt][3], h[nt][3], b));
  }
  a += __shfl_xor_sync(0xffffffffu, a, 1);
  a += __shfl_xor_sync(0xffffffffu, a, 2);
  b += __shfl_xor_sync(0xffffffffu, b, 1);
  b += __shfl_xor_sync(0xffffffffu, b, 2);
  return make_float2(sqrtf(a), sqrtf(b));
}

// Pre-activations pre = c + b of n-tile nt: which of them lie within the
// repair bound of 0 (relu's kink), as bits (0: row g, column 2t; 1: row g,
// 2t + 1; 2, 3: row g + 8).  The bound is 2^-17 |a_row| |w_unit|
// (Cauchy-Schwarz over the unit's inputs a and weights w): 37 times the
// largest distance between the 3xTF32 sum and the sequential FP32 sum
// that a numpy model of both found over the main path's 12.6 million
// layer-2 and layer-3 pre-activations of the relu spread net (2^-22.2 |a|
// |w|); tests/test_torch_net_tc.py holds the margin (8x) with a rounding
// and a truncating accumulator, on other nets and q.  Both sums' worst
// case (~650 u sum|a w|, with a truncating tensor-core accumulator) is
// never approached: the roundings are random.
__device__ __forceinline__ unsigned near_kink(const float (&c)[4],
                                              const float* b, const float* wn,
                                              int nt, int t, float2 a_norm) {
  constexpr float kBound = 1.f / 131072.f;
  const float2 bb = lds2(b + nt * 8 + 2 * t);
  const float2 w = lds2(wn + nt * 8 + 2 * t);
  return (fabsf(c[0] + bb.x) < kBound * a_norm.x * w.x ? 1u : 0u) |
         (fabsf(c[1] + bb.y) < kBound * a_norm.x * w.y ? 2u : 0u) |
         (fabsf(c[2] + bb.x) < kBound * a_norm.y * w.x ? 4u : 0u) |
         (fabsf(c[3] + bb.y) < kBound * a_norm.y * w.y ? 8u : 0u);
}

// The rows (bit r: lane r of the tile) whose quad flags them: each quad
// ORs its threads' fa (row g) and fb (row g + 8), and the warp gathers them.
__device__ __forceinline__ unsigned flagged_rows(bool fa, bool fb, int t) {
  int a = fa, b = fb;
  a |= __shfl_xor_sync(0xffffffffu, a, 1);
  a |= __shfl_xor_sync(0xffffffffu, a, 2);
  b |= __shfl_xor_sync(0xffffffffu, b, 1);
  b |= __shfl_xor_sync(0xffffffffu, b, 2);
  const unsigned ba = __ballot_sync(0xffffffffu, t == 0 && a);
  const unsigned bb = __ballot_sync(0xffffffffu, t == 0 && b);
  unsigned rows = 0;
#pragma unroll
  for (int r = 0; r < 8; ++r)
    rows |= ((ba >> (4 * r)) & 1u) << r | ((bb >> (4 * r)) & 1u) << (r + 8);
  return rows;
}

// Sequential FMA over k of x[k] w[k] (k ascending from 0, n a multiple of
// 4), both read as float4 from shared memory: the plain chain's order.
__device__ __forceinline__ float dot_seq(const float* x, const float* w,
                                         int n) {
  float s = 0.f;
  for (int k = 0; k < n; k += 4) {
    const float4 a = *reinterpret_cast<const float4*>(x + k);
    const float4 b = *reinterpret_cast<const float4*>(w + k);
    s = fmaf(a.x, b.x, s);
    s = fmaf(a.y, b.y, s);
    s = fmaf(a.z, b.z, s);
    s = fmaf(a.w, b.w, s);
  }
  return s;
}

// The GN terms row (K1's): tiles of 16 lanes a warp.  Layer 1 in FP32 in
// the plain order (cheap: 8 inputs), layers 2 and 3 and the whole backward
// 3xTF32.  relu'(h) is a decision on h's sign, and two correct float32
// sums of a pre-activation within ~1e-7 of 0 can decide it differently:
// so an active lane with a relu unit of layer 2 or 3 within the repair
// bound of 0 is recomputed whole in FP32 in the plain order
// (lane_forward_exact), which carries the plain version's decisions.
template <int H1, int H2, int H3>
__global__ void __launch_bounds__(kTcThreads, 1)
net_terms_tc_kernel(const float* __restrict__ q, float* __restrict__ g_out,
                    float* __restrict__ h_out, float* __restrict__ cost_out,
                    int N, const int* __restrict__ ip,
                    const float* __restrict__ fp) {
  using Lay = TcLayout<H1, H2, H3>;
  constexpr int NT1 = H1 / 8, NT2 = H2 / 8, NT3 = H3 / 8;
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  stage_net<Lay>(sm, fp);
  const int act = ip[1], d = ip[2];
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int warp = threadIdx.x >> 5, warps = blockDim.x >> 5;
  const float scale = sm[0], shift = sm[1], cutoff = sm[2];
  const float* stdv = sm + Lay::stdv;
  float* scratch = sm + Lay::n_floats + warp * TcScratch<H1, H2, H3>();
  const int n_tiles = (N + 15) / 16;

  for (int tile = blockIdx.x * warps + warp; tile < n_tiles;
       tile += gridDim.x * warps) {
    const int n_a = tile * 16 + g, n_b = n_a + 8;
    float* xs = scratch + 16 * (kTcIn + 1);   // the tile's x0, rows of 8
    __syncwarp();
#pragma unroll
    for (int i = 0; i < 16 * kTcIn / 32; ++i) {
      const int e = lane + 32 * i;
      xs[e] = input(q, sm + Lay::mean, stdv, e % kTcIn, d,
                    tile * 16 + e / kTcIn, N);
    }
    __syncwarp();
    // ---- layers 1 and 2: each 8-unit chunk of layer 1 is a k-tile ----
    float h2[NT2][4];
#pragma unroll
    for (int nt = 0; nt < NT2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) h2[nt][e] = 0.f;
    float h1_sq[2] = {0.f, 0.f};
#pragma unroll 1
    for (int kc0 = 0; kc0 < NT1; kc0 += kGroup) {
      FragA a[kGroup];
#pragma unroll
      for (int j = 0; j < kGroup; ++j) {
        float c[4];
        layer1_exact<Lay>(c, sm, xs, kc0 + j, g, t, act);
        h1_sq[0] = fmaf(c[0], c[0], fmaf(c[1], c[1], h1_sq[0]));
        h1_sq[1] = fmaf(c[2], c[2], fmaf(c[3], c[3], h1_sq[1]));
        a[j].from_acc(c);
      }
#pragma unroll
      for (int nt = 0; nt < NT2; ++nt) {
        float tmp[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int j = 0; j < kGroup; ++j)
          mma3(tmp, a[j],
               FragB(frag_fwd(sm + Lay::W1, Lay::S1, kc0 + j, nt, g, t)));
        add_frag(h2[nt], tmp);
      }
    }
    // relu units near their kink: layer 2's by unit (bit 2 nt + e of row
    // g / g + 8), layer 3's by row
    unsigned kink2_a = 0, kink2_b = 0;
    bool kink3_a = false, kink3_b = false;
    if (act == 0) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        h1_sq[i] += __shfl_xor_sync(0xffffffffu, h1_sq[i], 1);
        h1_sq[i] += __shfl_xor_sync(0xffffffffu, h1_sq[i], 2);
      }
      const float2 a_norm = make_float2(sqrtf(h1_sq[0]), sqrtf(h1_sq[1]));
#pragma unroll
      for (int nt = 0; nt < NT2; ++nt) {
        const unsigned k = near_kink(h2[nt], sm + Lay::b1, sm + Lay::wn2, nt,
                                     t, a_norm);
        kink2_a |= (k & 3u) << (2 * nt);
        kink2_b |= (k >> 2) << (2 * nt);
      }
    }
#pragma unroll
    for (int nt = 0; nt < NT2; ++nt)
      bias_act(h2[nt], sm + Lay::b1, nt, t, act);

    // ---- layer 3 ----
    float h3[NT3][4];
#pragma unroll
    for (int nt = 0; nt < NT3; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) h3[nt][e] = 0.f;
#pragma unroll
    for (int kt0 = 0; kt0 < NT2; kt0 += kGroup) {
      FragA a[kGroup];
#pragma unroll
      for (int j = 0; j < kGroup; ++j) a[j].from_acc(h2[kt0 + j]);
#pragma unroll
      for (int nt = 0; nt < NT3; ++nt) {
        float tmp[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int j = 0; j < kGroup; ++j)
          mma3(tmp, a[j],
               FragB(frag_fwd(sm + Lay::W2, Lay::S2, kt0 + j, nt, g, t)));
        add_frag(h3[nt], tmp);
      }
    }
    if (act == 0) {
      const float2 a_norm = row_norms<NT2>(h2);
#pragma unroll
      for (int nt = 0; nt < NT3; ++nt) {
        const unsigned k = near_kink(h3[nt], sm + Lay::b2, sm + Lay::wn3, nt,
                                     t, a_norm);
        kink3_a |= (k & 3u) != 0;
        kink3_b |= (k >> 2) != 0;
      }
    }
#pragma unroll
    for (int nt = 0; nt < NT3; ++nt)
      bias_act(h3[nt], sm + Lay::b2, nt, t, act);

    // ---- the output layer (FP32), the hinge ----
    const float2 s = out_sums<NT3>(h3, sm + Lay::w3, t);
    const float b3 = sm[Lay::b3];
    const float r_a = fmaxf(cutoff - (-((s.x + b3) * scale + shift)), 0.f);
    const float r_b = fmaxf(cutoff - (-((s.y + b3) * scale + shift)), 0.f);
    const bool on_a = n_a < N && r_a > 0.f, on_b = n_b < N && r_b > 0.f;
    if (!__any_sync(0xffffffffu, on_a || on_b)) continue;

    // ---- repair: active lanes near a kink, in the plain order: the whole
    // forward where a layer-3 unit is near (its inputs h2 must all be the
    // plain's), else each flagged layer-2 unit over the plain h1 (the
    // whole forward for those lanes too made the row 5.9% slower on the
    // relu spread net, chip_sweep_ab.py --kernels net on an H100) ----
    if (act == 0) {
      float* hs = xs + 16 * kTcIn;
      unsigned rows3 = flagged_rows(kink3_a && on_a, kink3_b && on_b, t);
      const unsigned rows2 =
          flagged_rows(kink2_a != 0 && on_a, kink2_b != 0 && on_b, t) &
          ~rows3;
      while (rows3) {
        const int row = __ffs(rows3) - 1;
        rows3 &= rows3 - 1;
        lane_forward_exact<Lay, H1, H2, H3>(hs, sm, q, d, tile * 16 + row, N,
                                            lane, act);
        // (constant register indices: a runtime one would put h2 and h3
        // in local memory)
        if (row == g || row == g + 8) {
          const bool top = row == g;
#pragma unroll
          for (int nt = 0; nt < NT2; ++nt) {
            const float2 v = lds2(hs + kTcIn + H1 + nt * 8 + 2 * t);
            h2[nt][0] = top ? v.x : h2[nt][0];
            h2[nt][1] = top ? v.y : h2[nt][1];
            h2[nt][2] = top ? h2[nt][2] : v.x;
            h2[nt][3] = top ? h2[nt][3] : v.y;
          }
#pragma unroll
          for (int nt = 0; nt < NT3; ++nt) {
            const float2 v = lds2(hs + kTcIn + H1 + H2 + nt * 8 + 2 * t);
            h3[nt][0] = top ? v.x : h3[nt][0];
            h3[nt][1] = top ? v.y : h3[nt][1];
            h3[nt][2] = top ? h3[nt][2] : v.x;
            h3[nt][3] = top ? h3[nt][3] : v.y;
          }
        }
        __syncwarp();
      }
      for (unsigned rows = rows2; rows; rows &= rows - 1) {
        const int row = __ffs(rows) - 1;
        lane_layer1_exact<Lay, H1>(hs, sm, q, d, tile * 16 + row, N, lane,
                                   act);
        const unsigned mine =
            row == g ? kink2_a : (row == g + 8 ? kink2_b : 0u);
        float* h2s = hs + kTcIn + H1;
        for (unsigned m = mine; m; m &= m - 1) {
          const int bit = __ffs(m) - 1;
          const int u = (bit >> 1) * 8 + 2 * t + (bit & 1);
          h2s[u] = activate(dot_seq(hs + kTcIn, sm + Lay::W1 + u * Lay::S1,
                                    H1) + sm[Lay::b1 + u], act);
        }
        const int e0 = row == g ? 0 : 2;
#pragma unroll
        for (int nt = 0; nt < NT2; ++nt) {
          const float2 v = lds2(h2s + nt * 8 + 2 * t);
          const bool b0 = (mine >> (2 * nt)) & 1u;
          const bool b1 = (mine >> (2 * nt + 1)) & 1u;
          if (e0 == 0) {
            h2[nt][0] = b0 ? v.x : h2[nt][0];
            h2[nt][1] = b1 ? v.y : h2[nt][1];
          } else {
            h2[nt][2] = b0 ? v.x : h2[nt][2];
            h2[nt][3] = b1 ? v.y : h2[nt][3];
          }
        }
        __syncwarp();
      }
    }

    // ---- backward: delta3 = w3 * act'(h3), in place ----
#pragma unroll
    for (int nt = 0; nt < NT3; ++nt) {
      const float2 w = lds2(sm + Lay::w3 + nt * 8 + 2 * t);
      h3[nt][0] = w.x * activate_grad(h3[nt][0], act);
      h3[nt][1] = w.y * activate_grad(h3[nt][1], act);
      h3[nt][2] = w.x * activate_grad(h3[nt][2], act);
      h3[nt][3] = w.y * activate_grad(h3[nt][3], act);
    }
    // delta2 = (delta3 W2^T) * act'(h2), each n-tile into h2's registers
    {
      FragA d3[NT3];
#pragma unroll
      for (int kt = 0; kt < NT3; ++kt) d3[kt].from_acc_bwd(h3[kt], t >> 1);
#pragma unroll
      for (int nt = 0; nt < NT2; ++nt) {
        float c[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int kt0 = 0; kt0 < NT3; kt0 += kGroup) {
          float tmp[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
          for (int kt = kt0; kt < kt0 + kGroup; ++kt)
            mma3(tmp, d3[kt],
                 FragB(frag_bwd(sm + Lay::W2, Lay::S2, kt, nt, g, t)));
          add_frag(c, tmp);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e)
          h2[nt][e] = c[e] * activate_grad(h2[nt][e], act);
      }
    }
    // delta1 = (delta2 W1^T) * act'(h1), kChunks chunks of 8 units at a
    // time (independent accumulator chains; layer 1 recomputed), and the
    // input gradient gx += delta1 W0^T (one group of kChunks k-tiles)
    constexpr int kChunks = kGroup;
    FragA d2[NT2];
#pragma unroll
    for (int kt = 0; kt < NT2; ++kt) d2[kt].from_acc_bwd(h2[kt], t >> 1);
    float gx[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 1
    for (int kc0 = 0; kc0 < NT1; kc0 += kChunks) {
      float c[kChunks][4];
#pragma unroll
      for (int j = 0; j < kChunks; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) c[j][e] = 0.f;
#pragma unroll
      for (int kt0 = 0; kt0 < NT2; kt0 += kGroup) {
        float tmp[kChunks][4];
#pragma unroll
        for (int j = 0; j < kChunks; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) tmp[j][e] = 0.f;
#pragma unroll
        for (int kt = kt0; kt < kt0 + kGroup; ++kt)
#pragma unroll
          for (int j = 0; j < kChunks; ++j)
            mma3(tmp[j], d2[kt],
                 FragB(frag_bwd(sm + Lay::W1, Lay::S1, kt, kc0 + j, g, t)));
#pragma unroll
        for (int j = 0; j < kChunks; ++j) add_frag(c[j], tmp[j]);
      }
      float gtmp[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int j = 0; j < kChunks; ++j) {
        float h1[4];
        layer1_exact<Lay>(h1, sm, xs, kc0 + j, g, t, act);
#pragma unroll
        for (int e = 0; e < 4; ++e) c[j][e] *= activate_grad(h1[e], act);
        FragA a;
        a.from_acc_bwd(c[j], t >> 1);
        mma3(gtmp, a,
             FragB(frag_bwd(sm + Lay::W0, Lay::S0, kc0 + j, 0, g, t)));
      }
      add_frag(gx, gtmp);
    }

    // ---- epilogue: d sd/dq_j = -scale gx_j / std_j, then the row ----
    float* rb = scratch;          // r (16), 0 where inactive
    float* gq = scratch + 16;     // d sd/dq (kTcIn, 16)
    if (t == 0) {
      rb[g] = on_a ? r_a : 0.f;
      rb[g + 8] = on_b ? r_b : 0.f;
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int j = 2 * t + (e & 1), n = g + (e < 2 ? 0 : 8);
      gq[j * 16 + n] = (-scale * gx[e]) / stdv[j];
    }
    __syncwarp();
    const int per_lane = d + d * (d + 1) / 2 + 1;
    for (int it = lane; it < per_lane * 16; it += 32) {
      const int e = it / 16, n = it % 16;
      const float r = rb[n];
      if (!(r > 0.f)) continue;
      add_row_item(e, d, r, gq + n, 16, (size_t)tile * 16 + n, N, g_out,
                   h_out, cost_out);
    }
    __syncwarp();
  }
}

// The bundled widths' instantiation (the only tf32x3 one).
constexpr int kH1 = 256, kH2 = 128, kH3 = 64;

template <bool kTerms>
auto tc_kernel() {
  if constexpr (kTerms)
    return net_terms_tc_kernel<kH1, kH2, kH3>;
  else
    return net_cost_tc_kernel<kH1, kH2, kH3>;
}

template <bool kTerms>
cudaError_t launch(const float* q, float* g, float* h, float* cost, int N,
                   int route, int TL, int smem, const int* ip,
                   const float* fp, int n_floats, cudaStream_t stream) {
  if (route == 0) {
    cudaError_t err = cudaFuncSetAttribute(
        net_row_kernel<kTerms>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return err;
    const int blocks = (N + TL - 1) / TL;
    net_row_kernel<kTerms><<<blocks, kThreads, smem, stream>>>(
        q, g, h, cost, N, ip, fp, TL);
    return cudaGetLastError();
  }
  using Lay = TcLayout<kH1, kH2, kH3>;
  const int lanes = kTerms ? 16 : 32;
  const int need = 4 * (Lay::n_floats +
                        (kTerms ? kTcThreads / 32 * TcScratch<kH1, kH2, kH3>()
                                : 0));
  if (route != 1 || TL != lanes || n_floats != Lay::n_floats || smem < need)
    return cudaErrorInvalidValue;
  auto kernel = tc_kernel<kTerms>();
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const int tiles = (N + lanes - 1) / lanes;
  const int warps = kTcThreads / 32;
  const int want = (tiles + warps - 1) / warps;
  const int blocks = want < sms ? want : sms;
  kernel<<<blocks, kTcThreads, smem, stream>>>(q, g, h, cost, N, ip, fp);
  return cudaGetLastError();
}

}  // namespace

// q (d, N) -> adds the net row to g (d, N), h (d, d, N), cost (N) in place;
// route (0 simt, 1 tf32x3), TL lanes a tile and smem dynamic shared bytes
// (all from net_launch_config), n_floats the length of fp (checked against
// the tf32x3 layout); returns a CUDA error code.
extern "C" int trt_net_terms_launch(const float* q, float* g, float* h,
                                    float* cost, int N, int route, int TL,
                                    int smem, const int* ip, const float* fp,
                                    int n_floats, void* stream) {
  return static_cast<int>(launch<true>(q, g, h, cost, N, route, TL, smem, ip,
                                       fp, n_floats,
                                       static_cast<cudaStream_t>(stream)));
}

// q (d, N) -> adds 0.5 r^2 of the net row to cost (N) in place.
extern "C" int trt_net_cost_launch(const float* q, float* cost, int N,
                                   int route, int TL, int smem, const int* ip,
                                   const float* fp, int n_floats,
                                   void* stream) {
  return static_cast<int>(launch<false>(q, nullptr, nullptr, cost, N, route,
                                        TL, smem, ip, fp, n_floats,
                                        static_cast<cudaStream_t>(stream)));
}
