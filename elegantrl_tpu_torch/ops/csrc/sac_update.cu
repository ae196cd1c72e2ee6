// Fused SAC/ModSAC update chunk: C sequential updates, each a critic step
// on the entropy-regularised TD loss, a temperature (alpha) step, and an
// actor step (ModSAC: gated) against the freshly averaged target critic,
// with optax's clip-by-global-norm + Adam on each net and the Polyak steps,
// in place on flat parameter, target and moment buffers.
//
// Replaces: elegantrl_tpu/ops/pallas_update.py, make_sac_fused_chunk
// (kernel at :919, step body :936-1049, pallas_call at :1075).
//
// Bound on this card: operations at the main shape.  One update at B =
// 1024, S = 6, A = 2, E = 4 and (128, 128) is about 0.49 M multiply-adds
// per sample (two actor forwards and the target ensemble's forward for the
// label and alpha, the online ensemble's forward and backward, then the
// fresh target ensemble forward and backward to its action inputs and the
// actor backward), about 1.0 GFLOP, 15 us of the card's FP32 CUDA-core
// rate; it moves about 1.3 MB of parameters, targets and moments, 0.4 us
// of memory time.  In practice the grid barriers and the L2 latency of
// each tile step set it.
//
// Design: one cooperative launch per chunk, one persistent block per SM,
// every phase spread over all blocks with a grid barrier (grid_gemm.cuh)
// between phases, as ddpg_update.cu: the nets, targets and moments stay in
// L2 (1.08 MB for the critic at E = 4), the activations of an update in a
// workspace, weight gradients split over the batch into KSPLIT-sample parts
// summed in split order.  The critic is a linear encoder S + A -> D1 and E
// heads D1 -> D2 -> 1 (GELU between); a head's first layer is one job of a
// phase's job list, E of them side by side in one (B, E D2) activation,
// and the data gradient into the encoding sums over all heads in one
// product whose depth walks the heads' stacked first layers (rows blocked
// by D2, a head's floats apart), so any E runs.  The actor's forward on x
// with the policy noise is the same before and after the alpha step (the
// actor has not moved): it is computed once, for alpha's logprob and for
// the actor step.  alpha_log, its moments, the actor's Adam count and
// ModSAC's update_a live in `misc` on the device for the whole chunk.  Per
// update, 20 phases:
//    1. layer 1 of the actor on nx and on x; the online encoder on [x, a];
//    2. layer 2 of the actor on both (SAC: GELU; ModSAC: raw); the online
//       heads' first layers;
//    3. per sample (one warp each): the actor's draw on nx with the
//       next-action noise, a' and logp(a'); on x with the policy noise, a_pi,
//       logp(a_pi) (the block's sum for alpha) and the head's raw outputs;
//       the online heads' values q_e;
//    4. the target encoder on [nx, a'];
//    5. the target heads' first layers;
//    6. per sample: min_e of the target's values, the label r + ud gamma
//       (min_e Q - alpha logp(a')), each head's TD gradient 2 (q_e - label)
//       um / (E B), back through its output weight and GELU; block 0 takes
//       the temperature's step, ModSAC's gate and the actor's Adam row;
//    7. the heads' weight gradients, and the gradient into the encoding;
//    8. the encoder's weight gradient;
//    9. the critic's gradient from the splits, and the norm's partials;
//   10. clip + Adam + Polyak of the critic and the temperature's state,
//       skipped when the step is invalid;
//   11. the fresh target encoder on [x, a_pi];
//   12. the fresh target heads' first layers;
//   13. per sample: the actor objective mean_E(q) - alpha' logp(a_pi); dq_e =
//       -1 / (E B) back through each head's output weight and GELU;
//   14. the gradient into the encoding;
//   15. per sample: the gradient at a_pi (the encoder's action columns),
//       then through tanh, the logprob (SAC's density at the mean; ModSAC's
//       softplus form; the noise is a constant) and the log_std clip (zero
//       gradient outside its range) into the actor's head outputs;
//   16. the actor head's weight gradients (ModSAC: avg and std heads), and
//       the gradient at layer 2's output;
//   17. layer 2's weight gradient, and the gradient at layer 1's output;
//   18. layer 1's weight gradient;
//   19. the actor's gradient from the splits, and the norm's partials;
//   20. clip + Adam of the actor (ModSAC: and its target's Polyak step),
//       skipped unless valid * do_act; block 0 writes the objectives.
// With a trace buffer, block 0 stamps %globaltimer at the start and after
// each phase, NPH + 1 stamps an update.

#include <cuda_runtime.h>
#include <stdint.h>

#include "grid_gemm.cuh"

namespace {

using gg::Job;
using gg::mat;
using gg::mat2;

constexpr int NPH = 20;      // phases an update
constexpr int KSPLIT = 128;  // samples per depth split of a weight gradient

constexpr float LOG_SQRT_2PI = 0.91893853320467274178f;
constexpr float LOG_2 = 0.69314718055994530942f;

// The step row, written by block 0 in phase 6.
enum Step { ST_AL, ST_MU, ST_NU, ST_UPD, ST_COUNT, ST_BC1, ST_BC2, ST_DO, ST_ALPHA, ST_N };

struct Args {
  float *pa, *pc, *ta, *tc, *mua, *muc, *nua, *nuc, *misc;
  const float *sb, *nsb, *ab, *rb, *ud, *um, *nzn, *nzp, *bcv;
  float* objs;
  // workspace: the activations of one update, then the gradient and partials
  float *h1n, *z1x, *h1x, *enc, *enct, *encq, *denc;  // (B, D1)
  float *h2n, *z2x, *h2x;                             // (B, D2)
  float *zc, *hc, *hct, *zq, *hq;                     // (B, E D2)
  float *na, *apg;                                    // (A, B)
  float *nlp, *lpx;                                   // (B)
  float *outx, *gout;                                 // (B, 2A)
  float *qo;                                          // (B, E)
  float *gq;                                          // (B, E)
  float *part, *grad, *normpart, *objpart, *lppart, *step;
  unsigned int* bar;
  unsigned long long* trace;  // (C, NPH + 1) stamps, or null
  int C, B, S, A, D1, D2, E, modsac, nsplit;
  long long Pa, Pc;
  float gamma, tau, lr, clip_grad, b1, b2, eps, target_entropy, lo, hi, reliable;
};

// The actor: encoder S -> D1 -> D2, then 2A outputs (SAC's one head, or
// ModSAC's avg and std heads: the same count of floats).
__host__ __device__ inline long long act_w2(int S, int D1) { return (long long)D1 * S + D1; }
__host__ __device__ inline long long act_wo(int S, int D1, int D2) {
  return act_w2(S, D1) + (long long)D2 * D1 + D2;
}
__host__ __device__ inline long long act_floats(int S, int A, int D1, int D2) {
  return act_wo(S, D1, D2) + 2LL * (A * (long long)D2 + A);
}
// Output row r < 2A of the actor's head(s): its weight row and bias, from
// the head's start.
__device__ __forceinline__ long long head_w(int r, int A, int D2, bool modsac) {
  return (!modsac || r < A) ? (long long)r * D2
                            : (long long)A * D2 + A + (long long)(r - A) * D2;
}
__device__ __forceinline__ long long head_b(int r, int A, int D2, bool modsac) {
  if (!modsac) return 2LL * A * D2 + r;
  return r < A ? (long long)A * D2 + r : 2LL * A * D2 + A + (r - A);
}

// The critic: the linear encoder S + A -> D1, then E heads D1 -> D2 -> 1,
// each W1 (D2, D1), b1 (D2), w2 (D2), b2 (1).
__host__ __device__ inline long long head_floats(int D1, int D2) {
  return (long long)D2 * D1 + 2LL * D2 + 1;
}
__host__ __device__ inline long long cri_heads(int S, int A, int D1) {
  return (long long)D1 * (S + A) + D1;
}
__host__ __device__ inline long long cri_floats(int S, int A, int D1, int D2, int E) {
  return cri_heads(S, A, D1) + E * head_floats(D1, D2);
}

__device__ __forceinline__ float softplus(float x) {  // logaddexp(x, 0)
  return fmaxf(x, 0.f) + log1pf(expf(-fabsf(x)));
}

// The tanh-Gaussian draw of one action component from the head's mean and
// raw log_std and the noise z: returns tanh(pre), adds its logprob to lp.
__device__ __forceinline__ float draw(float mean, float raw, float z, bool modsac, float lo,
                                      float hi, float& lp) {
  const float ls = fminf(fmaxf(raw, lo), hi);
  const float std = expf(ls);
  const float pre = mean + std * z;
  const float t = tanhf(pre);
  if (modsac)
    lp += -ls - 0.5f * z * z - LOG_SQRT_2PI - 2.0f * (LOG_2 - pre - softplus(-2.0f * pre));
  else
    lp += -logf(std) - LOG_SQRT_2PI - logf(1.000001f - t * t);
  return t;
}

// Sum of head e's output layer, w2_e . h + b2_e, by one warp.
__device__ __forceinline__ float head_value(const float* cri, long long oH, long long HF, int e,
                                            int D1, int D2, const float* h) {
  const float* w2 = cri + oH + e * HF + (long long)D2 * D1 + D2;
  return gg::warp_dot(w2, h, D2) + __ldcg(w2 + D2);
}

// Phase 3: the actor's draws on nx and x, and the online heads' values.
__device__ void actor_phase(const Args& a, int u, gg::Smem& sm) {
  const int lane = threadIdx.x & 31, nw = gridDim.x * (gg::THREADS / 32);
  const int B = a.B, A = a.A, D1 = a.D1, D2 = a.D2, E = a.E;
  const bool modsac = a.modsac != 0;
  const float* nzn = a.nzn + (size_t)u * A * B;
  const float* nzp = a.nzp + (size_t)u * A * B;
  const float* Wo = a.pa + act_wo(a.S, D1, D2);
  const long long oH = cri_heads(a.S, A, D1), HF = head_floats(D1, D2);
  float lp_sum = 0.f;
  for (int b = blockIdx.x * (gg::THREADS / 32) + (threadIdx.x >> 5); b < B; b += nw) {
    const float* hn = a.h2n + (size_t)b * D2;
    const float* hx = a.h2x + (size_t)b * D2;
    float lpn = 0.f, lpx = 0.f;
    for (int k = 0; k < A; ++k) {
      const int r = A + k;
      const float mn = gg::warp_dot(Wo + head_w(k, A, D2, modsac), hn, D2) +
                       __ldcg(Wo + head_b(k, A, D2, modsac));
      const float rn = gg::warp_dot(Wo + head_w(r, A, D2, modsac), hn, D2) +
                       __ldcg(Wo + head_b(r, A, D2, modsac));
      const float an = draw(mn, rn, __ldg(nzn + (size_t)k * B + b), modsac, a.lo, a.hi, lpn);
      const float mx = gg::warp_dot(Wo + head_w(k, A, D2, modsac), hx, D2) +
                       __ldcg(Wo + head_b(k, A, D2, modsac));
      const float rx = gg::warp_dot(Wo + head_w(r, A, D2, modsac), hx, D2) +
                       __ldcg(Wo + head_b(r, A, D2, modsac));
      const float ax = draw(mx, rx, __ldg(nzp + (size_t)k * B + b), modsac, a.lo, a.hi, lpx);
      if (lane == 0) {
        a.na[(size_t)k * B + b] = an;
        a.apg[(size_t)k * B + b] = ax;
        a.outx[(size_t)b * 2 * A + k] = mx;
        a.outx[(size_t)b * 2 * A + r] = rx;
      }
    }
    const float* hc = a.hc + (size_t)b * E * D2;
    for (int e = 0; e < E; ++e) {
      const float q = head_value(a.pc, oH, HF, e, D1, D2, hc + (size_t)e * D2);
      if (lane == 0) a.qo[(size_t)b * E + e] = q;
    }
    if (lane == 0) {
      a.nlp[b] = lpn;
      a.lpx[b] = lpx;
      lp_sum += lpx;
    }
  }
  const float s = gg::block_sum2(lp_sum, 0.f, sm).x;
  if (threadIdx.x == 0) a.lppart[blockIdx.x] = s;
}

// Block 0, phase 6: the temperature's step on the gradient te - mean(logp
// (a_pi)) (clip-by-norm, Adam with its own moments, alpha_log clipped to
// [-16, 2]), ModSAC's gate (update_a restarts at update 0; the actor steps
// when update_a / (t + 1) < 1 / (2 - e^-1)) and the actor's bias
// corrections from its own count, into the step row.  misc is written
// later (phases 10 and 20), after every block has read alpha_log.
__device__ void alpha_step(const Args& a, int u, gg::Smem& sm) {
  float s = 0.f;
  for (int k = threadIdx.x; k < (int)gridDim.x; k += blockDim.x) s += __ldcg(a.lppart + k);
  s = gg::block_sum2(s, 0.f, sm).x;
  if (threadIdx.x != 0) return;
  const float* row = a.bcv + (size_t)u * 7;
  const float t = __ldg(row + 5);
  float g = a.target_entropy - s / (float)a.B;
  const float gn = sqrtf(g * g);
  g *= gn < a.clip_grad ? 1.0f : a.clip_grad / gn;
  const float mu = a.b1 * __ldcg(a.misc + 1) + (1.0f - a.b1) * g;
  const float nu = a.b2 * __ldcg(a.misc + 2) + (1.0f - a.b2) * g * g;
  const float al = fminf(
      fmaxf(__ldcg(a.misc) - a.lr * (mu / __ldg(row + 2)) / (sqrtf(nu / __ldg(row + 3)) + a.eps),
            -16.0f),
      2.0f);
  float do_act = 1.0f, upd = __ldcg(a.misc + 4);
  if (a.modsac) {
    const float u0 = t == 0.0f ? 0.0f : upd;
    do_act = u0 / (t + 1.0f) < a.reliable ? 1.0f : 0.0f;
    upd = u0 + do_act;
  }
  const float count = __ldcg(a.misc + 3) + 1.0f;
  a.step[ST_AL] = al;
  a.step[ST_MU] = mu;
  a.step[ST_NU] = nu;
  a.step[ST_UPD] = upd;
  a.step[ST_COUNT] = count;
  a.step[ST_BC1] = 1.0f - expf(count * logf(a.b1));
  a.step[ST_BC2] = 1.0f - expf(count * logf(a.b2));
  a.step[ST_DO] = do_act;
  a.step[ST_ALPHA] = expf(al);
}

// Phase 6: the label, each head's TD gradient back through its output
// weight and GELU (over zc), the block's share of the critic loss.
__device__ void loss_phase(const Args& a, int u, gg::Smem& sm) {
  if (blockIdx.x == 0) alpha_step(a, u, sm);
  const int lane = threadIdx.x & 31, nw = gridDim.x * (gg::THREADS / 32);
  const int B = a.B, D1 = a.D1, D2 = a.D2, E = a.E;
  const float* rb = a.rb + (size_t)u * B;
  const float* ud = a.ud + (size_t)u * B;
  const float* um = a.um + (size_t)u * B;
  const long long oH = cri_heads(a.S, a.A, D1), HF = head_floats(D1, D2);
  const float alpha = expf(__ldcg(a.misc));
  const float inv_B = 1.0f / (float)B;
  float obj = 0.f;
  for (int b = blockIdx.x * (gg::THREADS / 32) + (threadIdx.x >> 5); b < B; b += nw) {
    const float* ht = a.hct + (size_t)b * E * D2;
    float nq = 0.f;
    for (int e = 0; e < E; ++e) {
      const float v = head_value(a.tc, oH, HF, e, D1, D2, ht + (size_t)e * D2);
      nq = e == 0 ? v : fminf(nq, v);
    }
    const float label =
        __ldg(rb + b) + __ldg(ud + b) * a.gamma * (nq - __ldcg(a.nlp + b) * alpha);
    const float w = __ldg(um + b);
    float td = 0.f;
    for (int e = 0; e < E; ++e) {
      const float diff = __ldcg(a.qo + (size_t)b * E + e) - label;
      td += diff * diff;
      const float g = 2.0f * diff * w / (float)E * inv_B;  // d loss / d q_e
      if (lane == 0) a.gq[(size_t)b * E + e] = g;
      const float* w2 = a.pc + oH + e * HF + (long long)D2 * D1 + D2;
      float* z = a.zc + (size_t)b * E * D2 + (size_t)e * D2;
      for (int j = lane; j < D2; j += 32)
        z[j] = __ldcg(w2 + j) * g * mlp::gelu_tanh_grad(__ldcg(z + j));
    }
    if (lane == 0) obj += td / (float)E * w;
  }
  const float s = gg::block_sum2(obj, 0.f, sm).x;
  if (threadIdx.x == 0) a.objpart[blockIdx.x * 2] = s;
}

// Phase 13: the block's share of the actor objective, and dq_e = -1 / (E B)
// back through each fresh target head's output weight and GELU (over zq).
__device__ void actor_q_phase(const Args& a, gg::Smem& sm) {
  const int lane = threadIdx.x & 31, nw = gridDim.x * (gg::THREADS / 32);
  const int B = a.B, D1 = a.D1, D2 = a.D2, E = a.E;
  const long long oH = cri_heads(a.S, a.A, D1), HF = head_floats(D1, D2);
  const float alpha = __ldcg(a.step + ST_ALPHA);
  const float g = -1.0f / (float)B / (float)E;
  float obj = 0.f;
  for (int b = blockIdx.x * (gg::THREADS / 32) + (threadIdx.x >> 5); b < B; b += nw) {
    float qs = 0.f;
    for (int e = 0; e < E; ++e) {
      qs += head_value(a.tc, oH, HF, e, D1, D2, a.hq + (size_t)b * E * D2 + (size_t)e * D2);
      const float* w2 = a.tc + oH + e * HF + (long long)D2 * D1 + D2;
      float* z = a.zq + (size_t)b * E * D2 + (size_t)e * D2;
      for (int j = lane; j < D2; j += 32)
        z[j] = __ldcg(w2 + j) * g * mlp::gelu_tanh_grad(__ldcg(z + j));
    }
    if (lane == 0) obj += qs / (float)E - alpha * __ldcg(a.lpx + b);
  }
  const float s = gg::block_sum2(obj, 0.f, sm).x;
  if (threadIdx.x == 0) a.objpart[blockIdx.x * 2 + 1] = s;
}

// Phase 15: the gradient at a_pi from the encoding's gradient and the fresh
// target encoder's action columns, then through tanh, the logprob and the
// log_std clip into the actor's raw head outputs (gout).
__device__ void action_grad_phase(const Args& a, int u) {
  const int lane = threadIdx.x & 31, nw = gridDim.x * (gg::THREADS / 32);
  const int B = a.B, A = a.A, S = a.S, D1 = a.D1, K = S + A;
  const bool modsac = a.modsac != 0;
  const float* nzp = a.nzp + (size_t)u * A * B;
  const float w = __ldcg(a.step + ST_ALPHA) / (float)B;  // d loss / d logp
  for (int b = blockIdx.x * (gg::THREADS / 32) + (threadIdx.x >> 5); b < B; b += nw) {
    const float* g1 = a.denc + (size_t)b * D1;
    for (int k = 0; k < A; ++k) {
      float s = 0.f;
      for (int j = lane; j < D1; j += 32)
        s = fmaf(__ldcg(a.tc + (long long)j * K + S + k), __ldcg(g1 + j), s);
      const float ga = mlp::warp_sum(s);
      const float mean = __ldcg(a.outx + (size_t)b * 2 * A + k);
      const float raw = __ldcg(a.outx + (size_t)b * 2 * A + A + k);
      const float std = expf(fminf(fmaxf(raw, a.lo), a.hi));
      const float z = __ldg(nzp + (size_t)k * B + b);
      const float pre = mean + std * z;
      const float t = tanhf(pre);
      const float dlp = modsac ? 2.0f - 4.0f / (1.0f + expf(2.0f * pre))  // 4 sigmoid(-2 pre)
                               : 2.0f * t * (1.0f - t * t) / (1.000001f - t * t);
      const float G = ga * (1.0f - t * t) + w * dlp;
      if (lane == 0) {
        a.gout[(size_t)b * 2 * A + k] = G;
        a.gout[(size_t)b * 2 * A + A + k] = (raw >= a.lo && raw <= a.hi) ? G * std * z - w : 0.f;
      }
    }
  }
}

__global__ void __launch_bounds__(gg::THREADS, 1) sac_chunk_kernel(const Args a) {
  __shared__ gg::Smem sm;
  const int B = a.B, S = a.S, A = a.A, D1 = a.D1, D2 = a.D2, E = a.E, K = S + A;
  const int ED2 = E * D2, A2 = 2 * A;
  const bool modsac = a.modsac != 0;
  const long long oW2 = act_w2(S, D1), oWo = act_wo(S, D1, D2);
  const long long oH = cri_heads(S, A, D1), HF = head_floats(D1, D2);
  int ph = 0;
  auto sync = [&](int u) {
    gg::grid_sync(a.bar);
    gg::stamp(a.trace, u, NPH + 1, ++ph);
  };
  // head e's first layer (D2, D1) on the encoding enc, into column block e
  // of the (B, E D2) activations
  auto head_fwd = [&](const float* cri, const float* enc, int e, float* out, float* pre) {
    return gg::fwd_job(mat(enc, D1, 1, B, D1), cri + oH + e * HF, D2, D1, B, out + e * D2,
                       pre != nullptr ? pre + e * D2 : nullptr, 1, ED2);
  };
  for (int u = 0; u < a.C; ++u) {
    const float* x = a.sb + (size_t)u * S * B;
    const float* nx = a.nsb + (size_t)u * S * B;
    const float* ab = a.ab + (size_t)u * A * B;
    const float* row = a.bcv + (size_t)u * 7;
    ph = 0;
    gg::stamp(a.trace, u, NPH + 1, 0);
    // ---- 1. layer 1 of the actor on nx and x; the online encoder on [x, a]
    gg::run_list([&](int j) -> Job {
      if (j == 0) return gg::fwd_job(mat(nx, 1, B, B, S), a.pa, D1, S, B, a.h1n, nullptr, 1, D1);
      if (j == 1) return gg::fwd_job(mat(x, 1, B, B, S), a.pa, D1, S, B, a.h1x, a.z1x, 1, D1);
      return gg::fwd_job(mat2(x, ab, S, 1, B, B, K), a.pc, D1, K, B, a.enc, nullptr, 0, D1);
    }, 3, sm);
    sync(u);
    // ---- 2. layer 2 of the actor on both; the online heads' first layers
    gg::run_list([&](int j) -> Job {
      if (j == 0)
        return gg::fwd_job(mat(a.h1n, D1, 1, B, D1), a.pa + oW2, D2, D1, B, a.h2n, nullptr,
                           !modsac, D2);
      if (j == 1)
        return gg::fwd_job(mat(a.h1x, D1, 1, B, D1), a.pa + oW2, D2, D1, B, a.h2x, a.z2x,
                           !modsac, D2);
      return head_fwd(a.pc, a.enc, j - 2, a.hc, a.zc);
    }, 2 + E, sm);
    sync(u);
    // ---- 3. the actor's draws, the online heads' values
    actor_phase(a, u, sm);
    sync(u);
    // ---- 4-5. the target critic on [nx, a']
    gg::run_list([&](int) -> Job {
      return gg::fwd_job(mat2(nx, a.na, S, 1, B, B, K), a.tc, D1, K, B, a.enct, nullptr, 0, D1);
    }, 1, sm);
    sync(u);
    gg::run_list([&](int e) -> Job { return head_fwd(a.tc, a.enct, e, a.hct, nullptr); }, E, sm);
    sync(u);
    // ---- 6. label, loss, the heads' gradients; alpha's step (block 0)
    loss_phase(a, u, sm);
    sync(u);
    // ---- 7-8. the critic's backward into the split partials
    gg::run_list([&](int j) -> Job {
      if (j < E)  // head j's first layer
        return gg::wgrad_job(a.zc + j * D2, ED2, D2, mat(a.enc, D1, 1, B, D1 + 1, D1), D1, B,
                             a.part, oH + j * HF, a.Pc, KSPLIT);
      if (j < 2 * E) {  // head e's output layer
        const int e = j - E;
        return gg::wgrad_job(a.gq + e, E, 1, mat(a.hc + e * D2, ED2, 1, B, D2 + 1, D2), D2, B,
                             a.part, oH + e * HF + (long long)D2 * D1 + D2, a.Pc, KSPLIT);
      }
      return gg::dgrad_job(a.zc, ED2, ED2, gg::mat_blocked(a.pc + oH, D1, ED2, D1, D2, HF), D1, B,
                           a.denc, D1, 0);
    }, 2 * E + 1, sm);
    sync(u);
    gg::run_list([&](int) -> Job {
      return gg::wgrad_job(a.denc, D1, D1, mat2(x, ab, S, 1, B, B, K + 1, K), K, B, a.part, 0,
                           a.Pc, KSPLIT);
    }, 1, sm);
    sync(u);
    // ---- 9-10. the critic's gradient and norm; clip + Adam + Polyak; the
    // temperature's state
    gg::reduce_parts(a.part, a.nsplit, a.Pc, a.grad, a.normpart, sm);
    sync(u);
    const bool valid = __ldg(row + 4) > 0.f;
    gg::clip_adam(a.pc, a.tc, a.muc, a.nuc, a.grad, a.normpart, a.Pc, valid, __ldg(row),
                  __ldg(row + 1), a.lr, a.clip_grad, a.b1, a.b2, a.eps, a.tau, sm);
    if (valid && blockIdx.x == 0 && threadIdx.x == 0) {
      a.misc[0] = __ldcg(a.step + ST_AL);
      a.misc[1] = __ldcg(a.step + ST_MU);
      a.misc[2] = __ldcg(a.step + ST_NU);
      a.misc[4] = __ldcg(a.step + ST_UPD);
    }
    sync(u);
    // ---- 11-12. the fresh target critic on [x, a_pi]
    gg::run_list([&](int) -> Job {
      return gg::fwd_job(mat2(x, a.apg, S, 1, B, B, K), a.tc, D1, K, B, a.encq, nullptr, 0, D1);
    }, 1, sm);
    sync(u);
    gg::run_list([&](int e) -> Job { return head_fwd(a.tc, a.encq, e, a.hq, a.zq); }, E, sm);
    sync(u);
    // ---- 13-15. back to the actor's head outputs
    actor_q_phase(a, sm);
    sync(u);
    gg::run_list([&](int) -> Job {
      return gg::dgrad_job(a.zq, ED2, ED2, gg::mat_blocked(a.tc + oH, D1, ED2, D1, D2, HF), D1, B,
                           a.denc, D1, 0);
    }, 1, sm);
    sync(u);
    action_grad_phase(a, u);
    sync(u);
    // ---- 16-18. the actor's backward into the split partials
    if (modsac) {  // avg and std heads on the raw trunk
      gg::run_list([&](int j) -> Job {
        if (j < 2)
          return gg::wgrad_job(a.gout + j * A, A2, A, mat(a.h2x, D2, 1, B, D2 + 1, D2), D2, B,
                               a.part, oWo + j * ((long long)A * D2 + A), a.Pa, KSPLIT);
        return gg::dgrad_job(a.gout, A2, A2,
                             gg::mat_blocked(a.pa + oWo, D2, A2, D2, A, (long long)A * D2 + A),
                             D2, B, a.z2x, D2, 0);
      }, 3, sm);
    } else {  // one 2A head on gelu(z2)
      gg::run_list([&](int j) -> Job {
        if (j == 0)
          return gg::wgrad_job(a.gout, A2, A2, mat(a.h2x, D2, 1, B, D2 + 1, D2), D2, B, a.part,
                               oWo, a.Pa, KSPLIT);
        return gg::dgrad_job(a.gout, A2, A2, mat(a.pa + oWo, D2, 1, A2, D2), D2, B, a.z2x, D2, 1);
      }, 2, sm);
    }
    sync(u);
    gg::run_list([&](int j) -> Job {
      if (j == 0)
        return gg::wgrad_job(a.z2x, D2, D2, mat(a.h1x, D1, 1, B, D1 + 1, D1), D1, B, a.part,
                             oW2, a.Pa, KSPLIT);
      return gg::dgrad_job(a.z2x, D2, D2, mat(a.pa + oW2, D1, 1, D2, D1), D1, B, a.z1x, D1, 1);
    }, 2, sm);
    sync(u);
    gg::run_list([&](int) -> Job {
      return gg::wgrad_job(a.z1x, D1, D1, mat(x, 1, B, B, S + 1, S), S, B, a.part, 0, a.Pa,
                           KSPLIT);
    }, 1, sm);
    sync(u);
    // ---- 19-20. the actor's gradient and norm; clip + Adam (+ Polyak);
    // objectives
    gg::reduce_parts(a.part, a.nsplit, a.Pa, a.grad, a.normpart, sm);
    sync(u);
    const float do_act = __ldcg(a.step + ST_DO);
    const bool act_on = valid && do_act > 0.f;
    if (blockIdx.x == 0) {
      float o0 = 0.f, o1 = 0.f;
      for (int k = threadIdx.x; k < (int)gridDim.x; k += blockDim.x) {
        o0 += __ldcg(a.objpart + 2 * k);
        o1 += __ldcg(a.objpart + 2 * k + 1);
      }
      const float2 o = gg::block_sum2(o0, o1, sm);
      if (threadIdx.x == 0) {
        a.objs[(size_t)u * 3] = o.x / (float)B;
        a.objs[(size_t)u * 3 + 1] = o.y / (float)B;
        a.objs[(size_t)u * 3 + 2] = __ldg(row + 4) * do_act;
        if (act_on) a.misc[3] = __ldcg(a.step + ST_COUNT);
      }
    }
    gg::clip_adam(a.pa, modsac ? a.ta : nullptr, a.mua, a.nua, a.grad, a.normpart, a.Pa, act_on,
                  __ldcg(a.step + ST_BC1), __ldcg(a.step + ST_BC2), a.lr, a.clip_grad, a.b1, a.b2,
                  a.eps, a.tau, sm);
    if (u + 1 < a.C) gg::grid_sync(a.bar);
    gg::stamp(a.trace, u, NPH + 1, NPH);
  }
}

// The workspace's layout (each buffer's place when ws is given); returns
// the floats it takes.
long long carve(Args* a, float* ws, int B, int S, int A, int D1, int D2, int E, int grid,
                int nsplit) {
  long long off = 0;
  auto take = [&](long long n) -> float* {
    float* p = ws != nullptr ? ws + off : nullptr;
    off += gg::round4(n);
    return p;
  };
  const long long Pa = act_floats(S, A, D1, D2), Pc = cri_floats(S, A, D1, D2, E);
  const long long P = Pa > Pc ? Pa : Pc;
  float** d1[7] = {&a->h1n, &a->z1x, &a->h1x, &a->enc, &a->enct, &a->encq, &a->denc};
  float** d2[3] = {&a->h2n, &a->z2x, &a->h2x};
  float** ed2[5] = {&a->zc, &a->hc, &a->hct, &a->zq, &a->hq};
  for (int i = 0; i < 7; ++i) *d1[i] = take((long long)B * D1);
  for (int i = 0; i < 3; ++i) *d2[i] = take((long long)B * D2);
  for (int i = 0; i < 5; ++i) *ed2[i] = take((long long)B * E * D2);
  a->na = take((long long)A * B);
  a->apg = take((long long)A * B);
  a->nlp = take(B);
  a->lpx = take(B);
  a->outx = take(2LL * B * A);
  a->gout = take(2LL * B * A);
  a->qo = take((long long)B * E);
  a->gq = take((long long)B * E);
  a->part = take(nsplit * P);
  a->grad = take(P);
  a->normpart = take(grid);
  a->objpart = take(2LL * grid);
  a->lppart = take(grid);
  a->step = take(ST_N);
  a->bar = (unsigned int*)take(4);
  return off;
}

int splits(int B) { return (B + KSPLIT - 1) / KSPLIT; }

}  // namespace

// Static shared memory of one block: the operand tiles and reduction slots
// (gg::Smem), whatever the widths, the batch or the ensemble.
extern "C" int sac_update_smem_bytes() { return (int)sizeof(gg::Smem); }

// Blocks of the cooperative launch: one per SM (negative: minus the CUDA
// error when the card cannot launch it).
extern "C" int sac_update_grid() { return gg::coop_grid(sac_chunk_kernel); }

// Floats of the workspace for a launch of `grid` blocks.
extern "C" long long sac_update_workspace_floats(int B, int S, int A, int D1, int D2, int E,
                                                 int grid) {
  Args a;
  return carve(&a, nullptr, B, S, A, D1, D2, E, grid, splits(B));
}

// Phases an update (the trace holds NPH + 1 stamps an update).
extern "C" int sac_update_phases() { return NPH; }

// bcv: (C, 7) float rows (bc1_c, bc2_c, bc1_alpha, bc2_alpha, valid,
// update_t, 0).  misc: (5,) (alpha_log, alpha_mu, alpha_nu, act_count,
// update_a).  Blocks: sb, nsb (C, S, B), ab, nzn, nzp (C, A, B), rb, ud, um
// (C, B).  ta is null for SAC.  objs: (C, 3), the critic loss, the actor
// objective and valid * do_act.  ws: sac_update_workspace_floats(...)
// floats; grid from sac_update_grid(); trace null or (C, NPH + 1) uint64
// stamps.  One cooperative launch; returns its CUDA status.
extern "C" int sac_update(void* pa, void* pc, void* ta, void* tc, void* mua, void* muc,
                          void* nua, void* nuc, void* misc, const void* sb, const void* nsb,
                          const void* ab, const void* rb, const void* ud, const void* um,
                          const void* nzn, const void* nzp, const void* bcv, void* ws,
                          void* objs, void* trace, int grid, int C, int B, int S, int A, int D1,
                          int D2, int E, int modsac, float gamma, float tau, float lr,
                          float clip_grad, float b1, float b2, float eps, float target_entropy,
                          float std_lo, float std_hi, float reliable, void* stream) {
  if (grid < 1 || C < 1 || B < 1 || E < 1) return (int)cudaErrorInvalidValue;
  Args a;
  a.pa = (float*)pa;
  a.pc = (float*)pc;
  a.ta = (float*)ta;
  a.tc = (float*)tc;
  a.mua = (float*)mua;
  a.muc = (float*)muc;
  a.nua = (float*)nua;
  a.nuc = (float*)nuc;
  a.misc = (float*)misc;
  a.sb = (const float*)sb;
  a.nsb = (const float*)nsb;
  a.ab = (const float*)ab;
  a.rb = (const float*)rb;
  a.ud = (const float*)ud;
  a.um = (const float*)um;
  a.nzn = (const float*)nzn;
  a.nzp = (const float*)nzp;
  a.bcv = (const float*)bcv;
  a.objs = (float*)objs;
  a.nsplit = splits(B);
  carve(&a, (float*)ws, B, S, A, D1, D2, E, grid, a.nsplit);
  a.trace = (unsigned long long*)trace;
  a.C = C;
  a.B = B;
  a.S = S;
  a.A = A;
  a.D1 = D1;
  a.D2 = D2;
  a.E = E;
  a.modsac = modsac;
  a.Pa = act_floats(S, A, D1, D2);
  a.Pc = cri_floats(S, A, D1, D2, E);
  a.gamma = gamma;
  a.tau = tau;
  a.lr = lr;
  a.clip_grad = clip_grad;
  a.b1 = b1;
  a.b2 = b2;
  a.eps = eps;
  a.target_entropy = target_entropy;
  a.lo = std_lo;
  a.hi = std_hi;
  a.reliable = reliable;
  return gg::coop_launch(sac_chunk_kernel, a, a.bar, grid, (cudaStream_t)stream);
}
