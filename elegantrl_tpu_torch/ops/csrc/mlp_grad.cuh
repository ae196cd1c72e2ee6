// Device pieces shared by the kernels that run an MLP's forward or backward
// pass (kernels.cu, grid_gemm.cuh and the update kernels on it): the GELU,
// its derivative and the warp sum.  GELU is the tanh form, matching
// jax.nn.gelu's default.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace mlp {

constexpr float GELU_K = 0.79788456080286535588f;  // sqrt(2/pi)

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

}  // namespace mlp
