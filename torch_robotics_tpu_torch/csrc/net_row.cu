// The learned self-collision row of the GN obstacle terms and of the
// value-only collision cost: per waypoint lane n of q_cols (d, N), the MLP
// signed distance sd(q), the hinge r = relu(cutoff - sd) with act = r > 0,
// and (terms) the gradient d sd/dq by the explicit backward chain.
//
//   net_row_kernel<true>  (trt_net_terms_launch) adds the row's exact
//     contribution to the terms kernel's unscaled outputs: 0.5 r^2 to
//     cost[n], r Jr_j to g[j, n] and Jr_i Jr_j to Hqq[i, j, n], where
//     Jr_j = -act d sd/dq_j;
//   net_row_kernel<false> (trt_net_cost_launch) adds 0.5 r^2 to cost[n].
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
// ~0.17 ms of FP32 work at 67 TFLOP/s and ~5 us of HBM traffic.
//
// Design: a block owns a tile of TL lanes (32 by default) and keeps every
// layer's activations for the tile in shared memory, feature-major
// (rows of TL floats), so the backward pass overwrites each layer's stored
// activation with its delta in place.  Each layer is a small FP32 GEMM:
// a thread computes 4 outputs x 4 lanes at a time, summing over the inputs
// in ascending order with fmaf, weight rows read as 16-byte loads through
// L1 / L2 (the 173 KB of weights stay in L2), activations as 16-byte
// shared loads.  Every width is padded to a multiple of 4 with zero
// weights, so the padded features are exact zeros.  The last layer (one
// output) and the input gradient (d outputs) are one dot product a thread.
// A tile whose lanes are all inactive skips the backward pass; an inactive
// lane's outputs are never written (its contribution is exactly zero), so
// the skip changes no bit.  (q - mean) / std uses correctly rounded
// division.  Tensor cores (3xTF32 or wgmma) are later work.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;

// Packed parameters, written by pack_net_params in
// torch_robotics_tpu_torch/ops/net_kernel.py.
//   ints:   [L, activation (0 relu, 1 tanh), d, 0, wp_0, ..., wp_L]
//           (L layers, wp_l the widths padded to a multiple of 4)
//   floats: [scale, shift, cutoff, 0, mean (wp_0), std (wp_0), then per
//           layer l: W_l (wp_l, wp_{l+1}) row-major, b_l (wp_{l+1})]
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
  const int n_h = d * (d + 1) / 2;
  const int per_lane = d + n_h + 1;
  for (int it = threadIdx.x; it < per_lane * TL; it += blockDim.x) {
    const int e = it / TL, n = it % TL;
    const float r = rbuf[n];
    if (!(r > 0.f)) continue;
    const size_t gn = (size_t)tile0 + n;
    if (e < d) {
      const float jr = -sm[e * TL + n];
      g_out[(size_t)e * N + gn] += r * jr;
    } else if (e < d + n_h) {
      int t = e - d, i = 0;
      while (t >= d - i) {
        t -= d - i;
        ++i;
      }
      const int j = i + t;
      const float v = (-sm[i * TL + n]) * (-sm[j * TL + n]);
      h_out[((size_t)i * d + j) * N + gn] += v;
      if (i != j) h_out[((size_t)j * d + i) * N + gn] += v;
    } else {
      const float r2 = __fmul_rn(r, r);
      cost_out[gn] += 0.5f * r2;
    }
  }
}

template <bool kTerms>
cudaError_t launch(const float* q, float* g, float* h, float* cost, int N,
                   int TL, int smem, const int* ip, const float* fp,
                   cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      net_row_kernel<kTerms>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  const int blocks = (N + TL - 1) / TL;
  net_row_kernel<kTerms><<<blocks, kThreads, smem, stream>>>(q, g, h, cost, N,
                                                             ip, fp, TL);
  return cudaGetLastError();
}

}  // namespace

// q (d, N) -> adds the net row to g (d, N), h (d, d, N), cost (N) in place;
// TL lanes a block (a multiple of 4), smem dynamic shared bytes (both from
// net_launch_config); returns a CUDA error code.
extern "C" int trt_net_terms_launch(const float* q, float* g, float* h,
                                    float* cost, int N, int TL, int smem,
                                    const int* ip, const float* fp,
                                    void* stream) {
  return static_cast<int>(launch<true>(q, g, h, cost, N, TL, smem, ip, fp,
                                       static_cast<cudaStream_t>(stream)));
}

// q (d, N) -> adds 0.5 r^2 of the net row to cost (N) in place.
extern "C" int trt_net_cost_launch(const float* q, float* cost, int N, int TL,
                                   int smem, const int* ip, const float* fp,
                                   void* stream) {
  return static_cast<int>(launch<false>(q, nullptr, nullptr, cost, N, TL,
                                        smem, ip, fp,
                                        static_cast<cudaStream_t>(stream)));
}
