// Fused PPO update: U sequential minibatch steps of the critic MSE and the
// clipped-surrogate actor loss, each followed by optax's clip-by-global-norm
// and Adam, in place on flat parameter and moment buffers.
//
// Replaces: elegantrl_tpu/ops/pallas_update.py, _make_kernel (built by
// make_ppo_fused_update, continuous and discrete heads; pallas_call at
// :313).
//
// Bound on this card: operations at the main shape, by far not reached.
// One minibatch of B = 512 at (128, 128) is about 104 MFLOP of forward and
// backward (about 1.6 us of FP32 CUDA-core time) and moves about 1.2 MB of
// parameters and moments; in practice the grid barriers and the L2 latency
// of each tile step set the time.
//
// Design: one cooperative launch for all U steps, one persistent block per
// SM (grid_gemm.cuh), as the TPU kernel runs the whole update in one
// kernel.  Both nets, both Adam moments, the activations of a step and the
// gradients stay in device memory, which L2 holds (412 KB of parameters and
// moments at (128, 128)); data written during the launch is read through
// L2.  Before the first step every block normalises its share of the U
// minibatches' states; then, per step, 8 phases with a grid barrier after
// each:
//   1. layer 1 of the actor and of the critic (one job list);
//   2. layer 2 of both;
//   3. per sample (one warp each): the critic's value and the actor's A
//      means or logits, both losses and their gradients at the heads, the
//      per-sample std_log gradient (continuous head) and the block's share
//      of the three objectives;
//   4. both heads' weight gradients; the gradients at both layer-2 outputs;
//   5. both layer-2 weight gradients; the gradients at both layer-1 outputs;
//   6. both layer-1 weight gradients;
//   7. the flat gradient of both nets from the split partials (the std_log
//      entries from the per-sample rows) and each block's share of each
//      net's squared norm;
//   8. clip + Adam of each net, bias corrections at count + u + 1; block 0
//      writes row u of the objectives.
// Products are 32 x 32 output tiles spread over all blocks (gg::run_list).
// A weight gradient's depth (the batch) is split into KSPLIT-sample parts,
// each written to its own copy of the flat gradient and summed in split
// order in phase 7, so that two runs are bitwise equal: no atomics.
// With a trace buffer, block 0 stamps %globaltimer at the start of a step
// and after each phase, NPH + 1 stamps a step.
//
// Heads (phase 3) keep the TPU kernel's arithmetic and JAX's autodiff rules
// where it is not smooth: jnp.minimum and jnp.maximum split the gradient
// evenly at a tie, so the clipped surrogate's derivative at ratio == 1 +-
// clip is taken as JAX takes it.  The mean runs over the full B.
// Discrete head: the actor's A outputs are logits and the action block is
// one-hot, (A, B) per step.  With logp = log_softmax(logits) and p =
// exp(logp): new_lp = sum(logp * onehot), entropy = -sum(p * logp), d new_lp
// / d logits = onehot - p * sum(onehot) and d entropy / d logits = -p *
// (logp + entropy).  The actor's flat buffer then has no std_log leaf.
// GELU is the tanh form, matching jax.nn.gelu's default.

#include <cuda_runtime.h>
#include <stdint.h>

#include "grid_gemm.cuh"

namespace {

using gg::Job;
using gg::mat;

constexpr int NPH = 8;       // phases a step
constexpr int KSPLIT = 128;  // samples per depth split of a weight gradient
constexpr int WARPS = gg::THREADS / 32;
constexpr float LOG_SQRT_2PI = 0.91893853320467274178f;

struct Args {
  float *pa, *pc, *mua, *muc, *nua, *nuc;
  const float *norm_avg, *norm_std, *sb, *ab, *lp, *adv, *rs, *um;
  float* objs;
  // workspace: the normalised states of all U steps, the activations of a
  // step, the head gradients, then the gradient and the partials
  float* xn;                        // (U, S, B)
  float *z1a, *h1a, *z1c, *h1c;     // (B, D1)
  float *z2a, *h2a, *z2c, *h2c;     // (B, D2)
  float *ga, *gv, *gsl;             // (B, A), (B), (B, A)
  float *part, *grad, *normpart, *objpart;
  unsigned int* bar;
  unsigned long long* trace;  // (U, NPH + 1) stamps, or null
  int U, B, S, A, D1, D2, discrete, single_sided, nsplit, count_a, count_c;
  long long Pa, Pc;
  float ratio_clip, lambda_entropy, lr, clip_grad, b1, b2, eps;
};

// Offsets in a flat 3-layer MLP K -> D1 -> D2 -> O.
__host__ __device__ inline long long off_w2(int K, int D1) { return (long long)D1 * K + D1; }
__host__ __device__ inline long long off_wo(int K, int D1, int D2) {
  return off_w2(K, D1) + (long long)D2 * D1 + D2;
}
__host__ __device__ inline long long net_floats(int K, int D1, int D2, int O) {
  return off_wo(K, D1, D2) + (long long)O * D2 + O;
}

// Phase 3: the heads, the losses and their gradients at the heads.
__device__ void head_phase(const Args& a, int u, gg::Smem& sm) {
  const int lane = threadIdx.x & 31, nw = gridDim.x * WARPS;
  const int B = a.B, A = a.A, D2 = a.D2;
  const float* rs = a.rs + (size_t)u * B;
  const float* um = a.um + (size_t)u * B;
  const float* lpb = a.lp + (size_t)u * B;
  const float* advb = a.adv + (size_t)u * B;
  const float* ab = a.ab + (size_t)u * A * B;
  const float* Wa = a.pa + off_wo(a.S, a.D1, D2);  // (A, D2), then the A biases
  const float* Wc = a.pc + off_wo(a.S, a.D1, D2);  // (1, D2), then the bias
  const float* std_log = a.pa + (a.Pa - A);         // continuous head only
  const float inv_B = 1.0f / (float)B;
  const float lambda_entropy = a.lambda_entropy;
  float oc = 0.f, os = 0.f, oe = 0.f;
  for (int b = blockIdx.x * WARPS + (threadIdx.x >> 5); b < B; b += nw) {
    // ---- critic: mean((v - rs)^2 * um)
    const float v = gg::warp_dot(Wc, a.h2c + (size_t)b * D2, D2) + __ldcg(Wc + D2);
    const float w = __ldg(um + b);
    const float diff = v - __ldg(rs + b);
    // ---- actor: the A means or logits, into this sample's row of ga
    float* head = a.ga + (size_t)b * A;
    const float* ha = a.h2a + (size_t)b * D2;
    for (int k = 0; k < A; ++k) {
      const float hk =
          gg::warp_dot(Wa + (long long)k * D2, ha, D2) + __ldcg(Wa + (long long)A * D2 + k);
      if (lane == 0) head[k] = hk;
    }
    if (lane == 0) {  // the losses, one sample's serial arithmetic
      oc += diff * diff * w;
      a.gv[b] = 2.0f * diff * w * inv_B;
      // -(mean(surrogate * um) - lambda * mean(entropy * um))
      float new_lp = 0.f, ent = 0.f, lse = 0.f, soh = 0.f;
      if (a.discrete) {
        float m = head[0];
        for (int k = 1; k < A; ++k) m = fmaxf(m, head[k]);
        float sum = 0.f;
        for (int k = 0; k < A; ++k) sum += expf(head[k] - m);
        lse = m + logf(sum);
        for (int k = 0; k < A; ++k) {
          const float logp = head[k] - lse;
          const float oh = __ldg(ab + (size_t)k * B + b);
          new_lp += logp * oh;
          soh += oh;
          ent -= expf(logp) * logp;
        }
      } else {
        for (int k = 0; k < A; ++k) {
          const float sd = expf(__ldcg(std_log + k));
          const float lsd = logf(sd);
          const float z = (__ldg(ab + (size_t)k * B + b) - head[k]) / sd;
          new_lp += -0.5f * z * z - lsd - LOG_SQRT_2PI;
          ent += 0.5f + LOG_SQRT_2PI + lsd;
        }
      }
      const float ratio = expf(new_lp - __ldg(lpb + b));
      const float ad = __ldg(advb + b);
      float surr, dsurr;
      if (a.single_sided) {
        const float cw = ad > 0.f ? 1.0f - a.ratio_clip : 1.0f + a.ratio_clip;
        surr = ad * ratio * cw;
        dsurr = ad * cw;
      } else {
        const float lo = 1.0f - a.ratio_clip, hi = 1.0f + a.ratio_clip;
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
      const float g_lp = -w * inv_B * dsurr * ratio;
      os += surr * w;
      oe += ent * w;
      if (a.discrete) {
        const float g_ent = lambda_entropy * w * inv_B;  // d loss / d entropy
        for (int k = 0; k < A; ++k) {
          const float logp = head[k] - lse;
          const float p = expf(logp);
          const float oh = __ldg(ab + (size_t)k * B + b);
          head[k] = g_lp * (oh - p * soh) - g_ent * p * (logp + ent);  // d loss / d logit
        }
      } else {
        float* gsl = a.gsl + (size_t)b * A;
        for (int k = 0; k < A; ++k) {
          const float sd = expf(__ldcg(std_log + k));
          const float z = (__ldg(ab + (size_t)k * B + b) - head[k]) / sd;
          gsl[k] = g_lp * (z * z - 1.0f) + lambda_entropy * w * inv_B;  // d loss / d std_log
          head[k] = g_lp * z / sd;                                       // d loss / d mean
        }
      }
    }
  }
  const float2 s01 = gg::block_sum2(oc, os, sm);
  const float s2 = gg::block_sum2(oe, 0.f, sm).x;
  if (threadIdx.x == 0) {
    a.objpart[blockIdx.x * 3 + 0] = s01.x;
    a.objpart[blockIdx.x * 3 + 1] = s01.y;
    a.objpart[blockIdx.x * 3 + 2] = s2;
  }
}

// Phase 7: grad[i] = the split partials of entry i summed in split order;
// the continuous head's std_log entries by one warp each, from the
// per-sample rows (lanes stride the samples, then the xor tree); and this
// block's share of each net's squared norm.
__device__ void reduce_phase(const Args& a, gg::Smem& sm) {
  const long long P = a.Pa + a.Pc, sl0 = a.discrete ? a.Pa : a.Pa - a.A;
  float sqa = 0.f, sqc = 0.f;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < P;
       i += (long long)gridDim.x * blockDim.x) {
    if (i >= sl0 && i < a.Pa) continue;
    float s = 0.f;
    for (int k = 0; k < a.nsplit; ++k) s += __ldcg(a.part + k * P + i);
    a.grad[i] = s;
    if (i < a.Pa) sqa = fmaf(s, s, sqa);
    else sqc = fmaf(s, s, sqc);
  }
  const int lane = threadIdx.x & 31, nw = gridDim.x * WARPS;
  for (int k = blockIdx.x * WARPS + (threadIdx.x >> 5); k < (int)(a.Pa - sl0); k += nw) {
    float s = 0.f;
    for (int b = lane; b < a.B; b += 32) s += __ldcg(a.gsl + (size_t)b * a.A + k);
    s = mlp::warp_sum(s);
    if (lane == 0) {
      a.grad[sl0 + k] = s;
      sqa = fmaf(s, s, sqa);
    }
  }
  const float2 n = gg::block_sum2(sqa, sqc, sm);
  if (threadIdx.x == 0) {
    a.normpart[blockIdx.x] = n.x;
    a.normpart[gridDim.x + blockIdx.x] = n.y;
  }
}

__global__ void __launch_bounds__(gg::THREADS, 1) ppo_update_kernel(const Args a) {
  __shared__ gg::Smem sm;
  const int B = a.B, S = a.S, A = a.A, D1 = a.D1, D2 = a.D2;
  const long long oW2 = off_w2(S, D1), oWo = off_wo(S, D1, D2), Pa = a.Pa;
  const long long P = a.Pa + a.Pc;
  // ---- the U minibatches' states, normalised once
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < (long long)a.U * S * B; i += (long long)gridDim.x * blockDim.x) {
    const int s = (int)((i / B) % S);
    a.xn[i] = (__ldg(a.sb + i) - __ldg(a.norm_avg + s)) / (__ldg(a.norm_std + s) + 1e-4f);
  }
  gg::grid_sync(a.bar);
  int ph = 0;
  auto sync = [&](int u) {
    gg::grid_sync(a.bar);
    gg::stamp(a.trace, u, NPH + 1, ++ph);
  };
  for (int u = 0; u < a.U; ++u) {
    const float* xn = a.xn + (size_t)u * S * B;
    ph = 0;
    gg::stamp(a.trace, u, NPH + 1, 0);
    // ---- 1-2. the forward passes of both nets
    gg::run_list<false>([&](int j) -> Job {
      if (j == 0) return gg::fwd_job(mat(xn, 1, B, B, S), a.pa, D1, S, B, a.h1a, a.z1a, 1, D1);
      return gg::fwd_job(mat(xn, 1, B, B, S), a.pc, D1, S, B, a.h1c, a.z1c, 1, D1);
    }, 2, sm);
    sync(u);
    gg::run_list<false>([&](int j) -> Job {
      if (j == 0)
        return gg::fwd_job(mat(a.h1a, D1, 1, B, D1), a.pa + oW2, D2, D1, B, a.h2a, a.z2a, 1, D2);
      return gg::fwd_job(mat(a.h1c, D1, 1, B, D1), a.pc + oW2, D2, D1, B, a.h2c, a.z2c, 1, D2);
    }, 2, sm);
    sync(u);
    // ---- 3. heads, losses, the gradients at the heads
    head_phase(a, u, sm);
    sync(u);
    // ---- 4-6. the backward passes of both nets into the split partials
    gg::run_list<false>([&](int j) -> Job {
      if (j == 0)
        return gg::wgrad_job(a.ga, A, A, mat(a.h2a, D2, 1, B, D2 + 1, D2), D2, B, a.part, oWo,
                             P, KSPLIT);
      if (j == 1)
        return gg::wgrad_job(a.gv, 1, 1, mat(a.h2c, D2, 1, B, D2 + 1, D2), D2, B, a.part,
                             Pa + oWo, P, KSPLIT);
      if (j == 2)
        return gg::dgrad_job(a.ga, A, A, mat(a.pa + oWo, D2, 1, A, D2), D2, B, a.z2a, D2, 1);
      return gg::dgrad_job(a.gv, 1, 1, mat(a.pc + oWo, D2, 1, 1, D2), D2, B, a.z2c, D2, 1);
    }, 4, sm);
    sync(u);
    gg::run_list<false>([&](int j) -> Job {
      if (j == 0)
        return gg::wgrad_job(a.z2a, D2, D2, mat(a.h1a, D1, 1, B, D1 + 1, D1), D1, B, a.part,
                             oW2, P, KSPLIT);
      if (j == 1)
        return gg::wgrad_job(a.z2c, D2, D2, mat(a.h1c, D1, 1, B, D1 + 1, D1), D1, B, a.part,
                             Pa + oW2, P, KSPLIT);
      if (j == 2)
        return gg::dgrad_job(a.z2a, D2, D2, mat(a.pa + oW2, D1, 1, D2, D1), D1, B, a.z1a, D1, 1);
      return gg::dgrad_job(a.z2c, D2, D2, mat(a.pc + oW2, D1, 1, D2, D1), D1, B, a.z1c, D1, 1);
    }, 4, sm);
    sync(u);
    gg::run_list<false>([&](int j) -> Job {
      return gg::wgrad_job(j == 0 ? a.z1a : a.z1c, D1, D1, mat(xn, 1, B, B, S + 1, S), S, B,
                           a.part, j == 0 ? 0 : Pa, P, KSPLIT);
    }, 2, sm);
    sync(u);
    // ---- 7-8. the gradients and their norms; clip + Adam; the objectives
    reduce_phase(a, sm);
    sync(u);
    const int step_a = a.count_a + u + 1, step_c = a.count_c + u + 1;
    gg::clip_adam(a.pa, nullptr, a.mua, a.nua, a.grad, a.normpart, Pa, true,
                  1.0f - powf(a.b1, (float)step_a), 1.0f - powf(a.b2, (float)step_a), a.lr,
                  a.clip_grad, a.b1, a.b2, a.eps, 0.f, sm);
    gg::clip_adam(a.pc, nullptr, a.muc, a.nuc, a.grad + Pa, a.normpart + gridDim.x, a.Pc, true,
                  1.0f - powf(a.b1, (float)step_c), 1.0f - powf(a.b2, (float)step_c), a.lr,
                  a.clip_grad, a.b1, a.b2, a.eps, 0.f, sm);
    if (blockIdx.x == 0) {
      float o0 = 0.f, o1 = 0.f, o2 = 0.f;
      for (int k = threadIdx.x; k < (int)gridDim.x; k += blockDim.x) {
        o0 += __ldcg(a.objpart + 3 * k);
        o1 += __ldcg(a.objpart + 3 * k + 1);
        o2 += __ldcg(a.objpart + 3 * k + 2);
      }
      const float2 o = gg::block_sum2(o0, o1, sm);
      const float oe = gg::block_sum2(o2, 0.f, sm).x;
      if (threadIdx.x == 0) {
        a.objs[(size_t)u * 3 + 0] = o.x / (float)B;
        a.objs[(size_t)u * 3 + 1] = o.y / (float)B;
        a.objs[(size_t)u * 3 + 2] = oe / (float)B;
      }
    }
    if (u + 1 < a.U) gg::grid_sync(a.bar);
    gg::stamp(a.trace, u, NPH + 1, NPH);
  }
}

int splits(int B) { return (B + KSPLIT - 1) / KSPLIT; }

// The workspace's layout: each buffer's offset (in floats, from ws) when
// ws is given; returns the floats it takes.
long long carve(Args* a, float* ws, int U, int B, int S, int A, int D1, int D2, int discrete,
                int grid) {
  long long off = 0;
  auto take = [&](long long n) -> float* {
    float* p = ws != nullptr ? ws + off : nullptr;
    off += gg::round4(n);
    return p;
  };
  const long long P = net_floats(S, D1, D2, A) + (discrete ? 0 : A) + net_floats(S, D1, D2, 1);
  a->xn = take((long long)U * S * B);
  float** d1[4] = {&a->z1a, &a->h1a, &a->z1c, &a->h1c};
  float** d2[4] = {&a->z2a, &a->h2a, &a->z2c, &a->h2c};
  for (int i = 0; i < 4; ++i) *d1[i] = take((long long)B * D1);
  for (int i = 0; i < 4; ++i) *d2[i] = take((long long)B * D2);
  a->ga = take((long long)B * A);
  a->gv = take(B);
  a->gsl = take((long long)B * A);
  a->part = take(splits(B) * P);
  a->grad = take(P);
  a->normpart = take(2LL * grid);
  a->objpart = take(3LL * grid);
  a->bar = (unsigned int*)take(4);
  return off;
}

}  // namespace

// Static shared memory of one block: the operand tiles and reduction slots
// (gg::Smem), whatever the widths, the batch or U.
extern "C" int ppo_update_smem_bytes() { return (int)sizeof(gg::Smem); }

// Blocks of the cooperative launch: one per SM (negative: minus the CUDA
// error when the card cannot launch it).
extern "C" int ppo_update_grid() { return gg::coop_grid(ppo_update_kernel); }

// Floats of the workspace for a launch of `grid` blocks.
extern "C" long long ppo_update_workspace_floats(int U, int B, int S, int A, int D1, int D2,
                                                 int discrete, int grid) {
  Args a;
  return carve(&a, nullptr, U, B, S, A, D1, D2, discrete, grid);
}

// Phases a step (the trace holds NPH + 1 stamps a step).
extern "C" int ppo_update_phases() { return NPH; }

// act / cri: flat parameters (the actor's ends with std_log (A) for the
// continuous head), with their Adam moments; blocks sb (U, S, B), ab (U, A,
// B), lp, adv, rs, um (U, B); objs (U, 3).  ws: ppo_update_workspace_floats
// floats; grid from ppo_update_grid(); trace null or (U, NPH + 1) uint64
// stamps.  One cooperative launch; returns its CUDA status.
extern "C" int ppo_update(void* act, void* act_mu, void* act_nu, void* cri, void* cri_mu,
                          void* cri_nu, const void* norm_avg, const void* norm_std,
                          const void* sb, const void* ab, const void* lp, const void* adv,
                          const void* rs, const void* um, void* ws, void* objs, void* trace,
                          int grid, int U, int B, int S, int A, int D1, int D2, int count_a,
                          int count_c, int single_sided, int discrete, float ratio_clip,
                          float lambda_entropy, float lr, float clip_grad, float b1, float b2,
                          float eps, void* stream) {
  if (grid < 1 || U < 1 || B < 1 || A < 1) return (int)cudaErrorInvalidValue;
  Args a;
  a.pa = (float*)act;
  a.mua = (float*)act_mu;
  a.nua = (float*)act_nu;
  a.pc = (float*)cri;
  a.muc = (float*)cri_mu;
  a.nuc = (float*)cri_nu;
  a.norm_avg = (const float*)norm_avg;
  a.norm_std = (const float*)norm_std;
  a.sb = (const float*)sb;
  a.ab = (const float*)ab;
  a.lp = (const float*)lp;
  a.adv = (const float*)adv;
  a.rs = (const float*)rs;
  a.um = (const float*)um;
  a.objs = (float*)objs;
  carve(&a, (float*)ws, U, B, S, A, D1, D2, discrete, grid);
  a.trace = (unsigned long long*)trace;
  a.U = U;
  a.B = B;
  a.S = S;
  a.A = A;
  a.D1 = D1;
  a.D2 = D2;
  a.discrete = discrete;
  a.single_sided = single_sided;
  a.nsplit = splits(B);
  a.count_a = count_a;
  a.count_c = count_c;
  a.Pa = net_floats(S, D1, D2, A) + (discrete ? 0 : A);
  a.Pc = net_floats(S, D1, D2, 1);
  a.ratio_clip = ratio_clip;
  a.lambda_entropy = lambda_entropy;
  a.lr = lr;
  a.clip_grad = clip_grad;
  a.b1 = b1;
  a.b2 = b2;
  a.eps = eps;
  return gg::coop_launch(ppo_update_kernel, a, a.bar, grid, (cudaStream_t)stream);
}
