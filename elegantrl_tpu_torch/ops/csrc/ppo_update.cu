// Fused PPO update: U sequential minibatch steps of the critic MSE and the
// clipped-surrogate actor loss, each followed by optax's clip-by-global-norm
// and Adam, in place on flat parameter and moment buffers.
//
// Replaces: elegantrl_tpu/ops/pallas_update.py, _make_kernel (built by
// make_ppo_fused_update, continuous and discrete heads).
//
// Bound on this card: launches and latency at the main shape.  One
// minibatch of B = 512 at (128, 128) is about 104 MFLOP of forward and
// backward (about 1.6 us of FP32 CUDA-core time) and moves about 0.8 MB of
// parameters, moments and partial gradients; the three launches per step
// cost more than that.
//
// Design:
// - On the TPU the whole update ran in one kernel with params, both Adam
//   moments and the minibatch block resident in ~16 MB of VMEM.  Here
//   p + mu + nu alone are 412 KB at (128, 128), more than one SM holds, so
//   each minibatch step is three launches, issued back to back on one
//   stream by ppo_update():
//   1. fwd_bwd: one block per TB = 32 samples computes both nets' forward
//      and hand-written backward passes and writes its per-block partial
//      gradients and objective sums (no atomics, so results are
//      deterministic);
//   2. reduce: sums the partials per parameter and each block's share of
//      the squared gradient norm of each net;
//   3. adam: sums those shares in a fixed order, applies the optax clip
//      (keep g below the norm limit, g * limit / norm otherwise) and Adam
//      with bias corrections 1 - beta^(count+u+1), and writes row u of the
//      objectives.
// - Activations are sample-major tiles in shared memory with an odd
//   leading dimension, so both the per-sample passes (lane = sample) and
//   the weight-gradient passes (lane = feature) read without bank
//   conflicts.  Weights are read from global memory through L1 as warp-wide
//   broadcasts.  The passes are shared with the off-policy update kernels
//   (mlp_grad.cuh).
// - Gradients follow JAX's autodiff rules exactly where they are not
//   smooth: jnp.minimum and jnp.maximum split the gradient evenly at a tie,
//   so the clipped surrogate's derivative at ratio == 1 +- clip is taken as
//   JAX takes it.  The mean runs over the full B.
// - Discrete head: the actor's A outputs are logits and the action block is
//   one-hot, (A, B) per step, as in the TPU kernel.  With logp =
//   log_softmax(logits) and p = exp(logp): new_lp = sum(logp * onehot),
//   entropy = -sum(p * logp), d new_lp / d logits = onehot - p * sum(onehot)
//   and d entropy / d logits = -p * (logp + entropy).  The actor's flat
//   buffer then has no std_log leaf.  Ratio, clip and everything after the
//   head are shared with the continuous head.
// - GELU is the tanh form, matching jax.nn.gelu's default.

#include <cuda_runtime.h>
#include <stdint.h>

#include "mlp_grad.cuh"

namespace {

using namespace mlp;  // TB, THREADS, fwd/bwd passes, net_forward/net_backward

constexpr float LOG_SQRT_2PI = 0.91893853320467274178f;

__global__ void __launch_bounds__(THREADS)
fwd_bwd_kernel(const float* __restrict__ act, const float* __restrict__ cri,
               const float* __restrict__ norm_avg, const float* __restrict__ norm_std,
               const float* __restrict__ sb, const float* __restrict__ ab,
               const float* __restrict__ lp, const float* __restrict__ adv,
               const float* __restrict__ rs, const float* __restrict__ um,
               float* __restrict__ partial, float* __restrict__ objpart, int B,
               int S, int A, int D1, int D2, int P, int Pa, float ratio_clip,
               float lambda_entropy, int single_sided, int discrete) {
  extern __shared__ float smem[];
  Tiles t;
  t.lds = ld(S);
  t.ld1 = ld(D1);
  t.ld2 = ld(D2);
  t.ldh = ld(A);
  t.xn = smem;
  t.z1 = t.xn + TB * t.lds;
  t.h1 = t.z1 + TB * t.ld1;
  t.z2 = t.h1 + TB * t.ld1;
  t.h2 = t.z2 + TB * t.ld2;
  t.head = t.h2 + TB * t.ld2;

  const int b0 = blockIdx.x * TB;
  for (int idx = threadIdx.x; idx < TB * S; idx += blockDim.x) {
    const int e = idx / S, s = idx - e * S;
    const int b = b0 + e;
    t.xn[e * t.lds + s] =
        b < B ? (sb[(size_t)s * B + b] - norm_avg[s]) / (norm_std[s] + 1e-4f) : 0.f;
  }
  __syncthreads();

  const int e = threadIdx.x;  // sample slot when e < TB (warp 0)
  const int b = b0 + e;
  const bool live = e < TB && b < B;
  const float inv_B = 1.0f / (float)B;
  float* g = partial + (size_t)blockIdx.x * P;

  // ---- critic: mean((v - rs)^2 * um)
  net_forward(cri, t, S, D1, D2, 1);
  if (e < TB) {
    float obj = 0.f, dv = 0.f;
    if (live) {
      const float diff = t.head[e * t.ldh] - rs[b];
      obj = diff * diff * um[b];
      dv = 2.0f * diff * um[b] * inv_B;
    }
    t.head[e * t.ldh] = dv;
    obj = warp_sum(obj);
    if (e == 0) objpart[blockIdx.x * 3 + 0] = obj;
  }
  __syncthreads();
  net_backward(cri, g + Pa, t, S, D1, D2, 1);

  // ---- actor: -(mean(surrogate * um) - lambda * mean(entropy * um))
  const float* std_log = act + (Pa - A);  // continuous head only
  net_forward(act, t, S, D1, D2, A);
  if (e < TB) {
    float new_lp = 0.f, ent = 0.f, lse = 0.f, soh = 0.f;
    const float w = live ? um[b] : 0.f;
    float* head = t.head + e * t.ldh;  // A means, or A logits
    if (discrete) {
      float m = head[0];
      for (int a = 1; a < A; ++a) m = fmaxf(m, head[a]);
      float sum = 0.f;
      for (int a = 0; a < A; ++a) sum += expf(head[a] - m);
      lse = m + logf(sum);
      for (int a = 0; a < A; ++a) {
        const float logp = head[a] - lse;
        const float oh = live ? ab[(size_t)a * B + b] : 0.f;
        new_lp += logp * oh;
        soh += oh;
        ent -= expf(logp) * logp;
      }
    } else {
      for (int a = 0; a < A; ++a) {
        const float sd = expf(std_log[a]);
        const float lsd = logf(sd);
        const float z = live ? (ab[(size_t)a * B + b] - head[a]) / sd : 0.f;
        new_lp += -0.5f * z * z - lsd - LOG_SQRT_2PI;
        ent += 0.5f + LOG_SQRT_2PI + lsd;
      }
    }
    float surr = 0.f, g_lp = 0.f;
    if (live) {
      const float ratio = expf(new_lp - lp[b]);
      const float ad = adv[b];
      float dsurr;
      if (single_sided) {
        const float cw = ad > 0.f ? 1.0f - ratio_clip : 1.0f + ratio_clip;
        surr = ad * ratio * cw;
        dsurr = ad * cw;
      } else {
        const float lo = 1.0f - ratio_clip, hi = 1.0f + ratio_clip;
        const float m = fmaxf(ratio, lo);
        const float rc = fminf(m, hi);
        // jnp.maximum / jnp.minimum give half the gradient at a tie
        const float dmax = ratio > lo ? 1.f : (ratio == lo ? 0.5f : 0.f);
        const float dmin = m < hi ? 1.f : (m == hi ? 0.5f : 0.f);
        const float x = ad * ratio, y = ad * rc;
        surr = fminf(x, y);
        const float dy = ad * dmax * dmin;
        dsurr = x < y ? ad : (x > y ? dy : 0.5f * ad + 0.5f * dy);
      }
      g_lp = -w * inv_B * dsurr * ratio;
    }
    const float obj_s = warp_sum(surr * w);
    const float obj_e = warp_sum(ent * w);
    if (e == 0) {
      objpart[blockIdx.x * 3 + 1] = obj_s;
      objpart[blockIdx.x * 3 + 2] = obj_e;
    }
    if (discrete) {
      const float g_ent = lambda_entropy * w * inv_B;  // d loss / d entropy
      for (int a = 0; a < A; ++a) {
        const float logp = head[a] - lse;
        const float p = expf(logp);
        const float oh = live ? ab[(size_t)a * B + b] : 0.f;
        head[a] = g_lp * (oh - p * soh) - g_ent * p * (logp + ent);  // d loss / d logit
      }
    } else {
      for (int a = 0; a < A; ++a) {
        const float sd = expf(std_log[a]);
        const float z = live ? (ab[(size_t)a * B + b] - head[a]) / sd : 0.f;
        const float d_sl = warp_sum(g_lp * (z * z - 1.0f) + lambda_entropy * w * inv_B);
        if (e == 0) g[Pa - A + a] = d_sl;
        head[a] = g_lp * z / sd;  // d loss / d mean
      }
    }
  }
  __syncthreads();
  net_backward(act, g, t, S, D1, D2, A);
}

__global__ void reduce_kernel(const float* __restrict__ partial, int nb, int P,
                              int Pa, float* __restrict__ grad,
                              float* __restrict__ normpart) {
  __shared__ float red[2][THREADS];
  float sa = 0.f, sc = 0.f;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < P; i += gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int k = 0; k < nb; ++k) s += partial[(size_t)k * P + i];
    grad[i] = s;
    if (i < Pa) sa += s * s; else sc += s * s;
  }
  red[0][threadIdx.x] = sa;
  red[1][threadIdx.x] = sc;
  __syncthreads();
  for (int w = blockDim.x / 2; w > 0; w >>= 1) {
    if (threadIdx.x < w) {
      red[0][threadIdx.x] += red[0][threadIdx.x + w];
      red[1][threadIdx.x] += red[1][threadIdx.x + w];
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    normpart[blockIdx.x * 2 + 0] = red[0][0];
    normpart[blockIdx.x * 2 + 1] = red[1][0];
  }
}

__global__ void adam_kernel(float* __restrict__ act, float* __restrict__ act_mu,
                            float* __restrict__ act_nu, float* __restrict__ cri,
                            float* __restrict__ cri_mu, float* __restrict__ cri_nu,
                            const float* __restrict__ grad,
                            const float* __restrict__ normpart, int nr,
                            const float* __restrict__ objpart, int nb,
                            float* __restrict__ objs_u, int P, int Pa, int B,
                            int step_a, int step_c, float lr, float clip_grad,
                            float b1, float b2, float eps) {
  __shared__ float scale[2];
  if (threadIdx.x < 2) {
    float s = 0.f;
    for (int r = 0; r < nr; ++r) s += normpart[r * 2 + threadIdx.x];
    const float gn = sqrtf(s);
    scale[threadIdx.x] = gn < clip_grad ? 1.0f : clip_grad / gn;
  }
  if (blockIdx.x == 0 && threadIdx.x >= 32 && threadIdx.x < 35) {
    const int c = threadIdx.x - 32;
    float s = 0.f;
    for (int k = 0; k < nb; ++k) s += objpart[k * 3 + c];
    objs_u[c] = s / (float)B;
  }
  __syncthreads();
  const float bc1a = 1.0f - powf(b1, (float)step_a), bc2a = 1.0f - powf(b2, (float)step_a);
  const float bc1c = 1.0f - powf(b1, (float)step_c), bc2c = 1.0f - powf(b2, (float)step_c);
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < P; i += gridDim.x * blockDim.x) {
    const bool is_act = i < Pa;
    const int j = is_act ? i : i - Pa;
    float* p = is_act ? act : cri;
    float* mu = is_act ? act_mu : cri_mu;
    float* nu = is_act ? act_nu : cri_nu;
    const float g = grad[i] * scale[is_act ? 0 : 1];
    const float m = b1 * mu[j] + (1.0f - b1) * g;
    const float v = b2 * nu[j] + (1.0f - b2) * g * g;
    mu[j] = m;
    nu[j] = v;
    const float bc1 = is_act ? bc1a : bc1c, bc2 = is_act ? bc2a : bc2c;
    p[j] -= lr * (m / bc1) / (sqrtf(v / bc2) + eps);
  }
}

}  // namespace

// Dynamic shared memory of one fwd_bwd block, in bytes.
extern "C" int ppo_update_smem_bytes(int S, int A, int D1, int D2) {
  return (int)sizeof(float) * TB * (ld(S) + 2 * ld(D1) + 2 * ld(D2) + ld(A));
}

// Scratch sizes: partial gradients (nb, P), objective partials (nb, 3),
// gradient (P), norm partials (nr, 2).
extern "C" int ppo_update_blocks(int B) { return (B + TB - 1) / TB; }
extern "C" int ppo_update_reduce_blocks(int P) {
  const int n = (P + THREADS - 1) / THREADS;
  return n < 264 ? n : 264;
}

extern "C" int ppo_update(
    void* act, void* act_mu, void* act_nu, void* cri, void* cri_mu, void* cri_nu,
    const void* norm_avg, const void* norm_std, const void* sb, const void* ab,
    const void* lp, const void* adv, const void* rs, const void* um, void* partial,
    void* objpart, void* grad, void* normpart, void* objs, int U, int B, int S,
    int A, int D1, int D2, int count_a, int count_c, int single_sided,
    int discrete, float ratio_clip, float lambda_entropy, float lr, float clip_grad, float b1,
    float b2, float eps, void* stream) {
  const int smem = ppo_update_smem_bytes(S, A, D1, D2);
  cudaError_t err = cudaFuncSetAttribute(
      fwd_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  // the actor's leaves: the MLP's, then std_log (A) for the continuous head
  const int Pa = D1 * S + D1 + D2 * D1 + D2 + A * D2 + A + (discrete ? 0 : A);
  const int P = Pa + D1 * S + D1 + D2 * D1 + D2 + D2 + 1;
  const int nb = ppo_update_blocks(B), nr = ppo_update_reduce_blocks(P);
  cudaStream_t st = (cudaStream_t)stream;
  for (int u = 0; u < U; ++u) {
    const size_t o = (size_t)u * B;
    fwd_bwd_kernel<<<nb, THREADS, smem, st>>>(
        (const float*)act, (const float*)cri, (const float*)norm_avg,
        (const float*)norm_std, (const float*)sb + o * S, (const float*)ab + o * A,
        (const float*)lp + o, (const float*)adv + o, (const float*)rs + o,
        (const float*)um + o, (float*)partial, (float*)objpart, B, S, A, D1, D2, P,
        Pa, ratio_clip, lambda_entropy, single_sided, discrete);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    reduce_kernel<<<nr, THREADS, 0, st>>>((const float*)partial, nb, P, Pa,
                                          (float*)grad, (float*)normpart);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    adam_kernel<<<nr, THREADS, 0, st>>>(
        (float*)act, (float*)act_mu, (float*)act_nu, (float*)cri, (float*)cri_mu,
        (float*)cri_nu, (const float*)grad, (const float*)normpart, nr,
        (const float*)objpart, nb, (float*)objs + (size_t)u * 3, P, Pa, B,
        count_a + u + 1, count_c + u + 1, lr, clip_grad, b1, b2, eps);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  return (int)cudaGetLastError();
}
