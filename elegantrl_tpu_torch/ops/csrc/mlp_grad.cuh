// Device pieces of the per-block MLP passes (ppo_update.cu, kernels.cu; the
// GELU and warp sum also for grid_gemm.cuh): dense forward passes and
// hand-written backward passes over a tile of TB samples.
//
// Activation tiles are sample-major, (TB samples, features), in shared
// memory with an odd leading dimension (ld(k) = k | 1), so that the passes
// with lane = sample and those with lane = feature both read without bank
// conflicts.  Weights are row-major (out, in), as the port's flat buffers
// keep them, read from global memory through L1 as warp-wide broadcasts.
// GELU is the tanh form, matching jax.nn.gelu's default.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace mlp {

constexpr int TB = 32;        // samples per fwd_bwd block (one per lane of warp 0)
constexpr int THREADS = 256;  // threads per block
constexpr int RJ = 8;         // output rows per warp pass
constexpr float GELU_K = 0.79788456080286535588f;  // sqrt(2/pi)

__host__ __device__ __forceinline__ int ld(int k) { return k | 1; }

__device__ __forceinline__ float gelu_tanh(float x) {
  return 0.5f * x * (1.0f + tanhf(GELU_K * (x + 0.044715f * x * x * x)));
}

__device__ __forceinline__ float gelu_tanh_grad(float x) {
  const float t = tanhf(GELU_K * (x + 0.044715f * x * x * x));
  return 0.5f * (1.0f + t) +
         0.5f * x * (1.0f - t * t) * GELU_K * (1.0f + 3.0f * 0.044715f * x * x);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// out[e][j] = W[j,:] . in[e,:] + b[j] (pre keeps it; out gets gelu of it
// when GELU).  Lane = sample e; warps take RJ rows j at a time.
template <bool GELU>
__device__ void fwd(const float* __restrict__ W, const float* __restrict__ b,
                    const float* in, int ldi, float* pre, float* out, int ldo,
                    int J, int K) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  for (int j0 = warp * RJ; j0 < J; j0 += nwarps * RJ) {
    const int rows = min(RJ, J - j0);
    float acc[RJ];
#pragma unroll
    for (int r = 0; r < RJ; ++r) acc[r] = 0.f;
    for (int k = 0; k < K; ++k) {
      const float x = in[lane * ldi + k];
#pragma unroll
      for (int r = 0; r < RJ; ++r)
        if (r < rows) acc[r] = fmaf(__ldg(W + (j0 + r) * K + k), x, acc[r]);
    }
#pragma unroll
    for (int r = 0; r < RJ; ++r) {
      if (r < rows) {
        const float v = acc[r] + __ldg(b + j0 + r);
        if (GELU) {
          pre[lane * ldo + j0 + r] = v;
          out[lane * ldo + j0 + r] = gelu_tanh(v);
        } else {
          out[lane * ldo + j0 + r] = v;
        }
      }
    }
  }
}

// The gradient at the layer's input from dout[e][j], K columns: MODE 0
// writes (sum_j W[j][k] * dout[e][j]) * gelu'(pre[e][k]) over pre; MODE 1
// writes the plain sum into pre; MODE 2 adds it to pre.  Each (e, k) cell
// belongs to one thread whatever J is, so consecutive calls over the same
// tile need no barrier between them.
template <int MODE>
__device__ void bwd_in(const float* __restrict__ W, const float* dout, int ldo,
                       float* pre, int ldp, int J, int K) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  for (int k0 = warp * RJ; k0 < K; k0 += nwarps * RJ) {
    const int cols = min(RJ, K - k0);
    float acc[RJ];
#pragma unroll
    for (int r = 0; r < RJ; ++r) acc[r] = 0.f;
    for (int j = 0; j < J; ++j) {
      const float d = dout[lane * ldo + j];
#pragma unroll
      for (int r = 0; r < RJ; ++r)
        if (r < cols) acc[r] = fmaf(__ldg(W + j * K + k0 + r), d, acc[r]);
    }
#pragma unroll
    for (int r = 0; r < RJ; ++r) {
      if (r < cols) {
        float* p = pre + lane * ldp + k0 + r;
        if (MODE == 0) *p = acc[r] * gelu_tanh_grad(*p);
        else if (MODE == 1) *p = acc[r];
        else *p += acc[r];
      }
    }
  }
}

// pre[e][k] <- (sum_j W[j][k] * dout[e][j]) * gelu'(pre[e][k]): the
// gradient at the previous layer's pre-activation, written over it.
__device__ __forceinline__ void bwd_data(const float* __restrict__ W, const float* dout,
                                         int ldo, float* pre, int ldp, int J, int K) {
  bwd_in<0>(W, dout, ldo, pre, ldp, J, K);
}

// gW[j][k] = sum_e d[e][j] * in[e][k]; gb[j] = sum_e d[e][j].
__device__ void wgrad(const float* d, int ldd, const float* in, int ldi,
                      float* __restrict__ gW, float* __restrict__ gb, int J, int K) {
  for (int idx = threadIdx.x; idx < J * K + J; idx += blockDim.x) {
    float s = 0.f;
    if (idx < J * K) {
      const int j = idx / K, k = idx - j * K;
#pragma unroll 8
      for (int e = 0; e < TB; ++e) s = fmaf(d[e * ldd + j], in[e * ldi + k], s);
      gW[idx] = s;
    } else {
      const int j = idx - J * K;
#pragma unroll 8
      for (int e = 0; e < TB; ++e) s += d[e * ldd + j];
      gb[j] = s;
    }
  }
}

// Activation tiles of one 3-layer MLP.
struct Tiles {
  float *xn, *z1, *h1, *z2, *h2, *head;
  int lds, ld1, ld2, ldh;
};

// Forward of one MLP (W1 b1 W2 b2 Wo bo at the start of `flat`, input of
// width S in tiles.xn); the O outputs per sample land in tiles.head.  GELU2
// is false for an encoder whose second layer is raw (z2 is then unused).
template <bool GELU2 = true>
__device__ void net_forward(const float* flat, const Tiles& t, int S, int D1, int D2,
                            int O) {
  const float* W1 = flat;
  const float* b1 = W1 + D1 * S;
  const float* W2 = b1 + D1;
  const float* b2 = W2 + D2 * D1;
  const float* Wo = b2 + D2;
  const float* bo = Wo + O * D2;
  fwd<true>(W1, b1, t.xn, t.lds, t.z1, t.h1, t.ld1, D1, S);
  __syncthreads();
  fwd<GELU2>(W2, b2, t.h1, t.ld1, t.z2, t.h2, t.ld2, D2, D1);
  __syncthreads();
  fwd<false>(Wo, bo, t.h2, t.ld2, nullptr, t.head, t.ldh, O, D2);
  __syncthreads();
}

// Backward of one 3-layer MLP from d(loss)/d(output) in tiles.head; the
// block's partial gradients go to g (same leaf layout as the flat buffer).
__device__ void net_backward(const float* flat, float* g, const Tiles& t, int S,
                             int D1, int D2, int O) {
  const float* W2 = flat + D1 * S + D1;
  const float* Wo = W2 + D2 * D1 + D2;
  float* gW1 = g;
  float* gb1 = gW1 + D1 * S;
  float* gW2 = gb1 + D1;
  float* gb2 = gW2 + D2 * D1;
  float* gWo = gb2 + D2;
  float* gbo = gWo + O * D2;
  wgrad(t.head, t.ldh, t.h2, t.ld2, gWo, gbo, O, D2);
  bwd_data(Wo, t.head, t.ldh, t.z2, t.ld2, O, D2);  // z2 <- dz2
  __syncthreads();
  wgrad(t.z2, t.ld2, t.h1, t.ld1, gW2, gb2, D2, D1);
  bwd_data(W2, t.z2, t.ld2, t.z1, t.ld1, D2, D1);  // z1 <- dz1
  __syncthreads();
  wgrad(t.z1, t.ld1, t.xn, t.lds, gW1, gb1, D1, S);
  __syncthreads();
}

}  // namespace mlp
