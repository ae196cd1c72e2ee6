// Fused DDPG/TD3 update chunk: C sequential updates, each a critic step on
// the TD loss followed by an actor step through the updated critic, with
// optax's clip-by-global-norm + Adam and the Polyak step on each net, in
// place on flat parameter, target and moment buffers.
//
// Replaces: elegantrl_tpu/ops/pallas_update.py, make_ddpg_fused_chunk with
// per=False (kernel at :640, step body :657-722, pallas_call at :747) and,
// with the importance weights given, per=True (K7': :604-615, 641-653, 666,
// 689-696, 730-757).
//
// Bound on this card: operations at the main shape.  One update at B =
// 1024, S = 6, A = 2, E = 8 and (128, 128) is about 0.36 GFLOP (target
// actor and critic forward, critic forward and backward, actor forward,
// critic forward and backward to its action inputs, actor backward), about
// 5.4 us of the card's FP32 CUDA-core rate; it moves about 1.3 MB of
// parameters, moments and targets, about 0.4 us of memory time.  In
// practice the grid barriers and the L2 latency of each tile step set it.
//
// Design: one cooperative launch per chunk, one persistent block per SM,
// every phase of every update spread over all blocks with a grid barrier
// (grid_gemm.cuh) between phases.  On the TPU one kernel kept both nets,
// their targets and moments (582 KB at the main shape) in VMEM for all C
// steps; here they stay in the 50 MB L2, with the activations of an update
// in a workspace beside them.  Products are 32 x 32 output tiles over all
// blocks; a weight gradient's depth (the batch) is split into KSPLIT-sample
// parts, each part's partial sums written to its own copy of the flat
// gradient, summed in split order by the next phase with the norm's
// per-block partials, so that two runs are bitwise equal and no SM idles
// through a 1024-deep sum.  Per update, 21 phases:
//    1. layer 1 of the actor on nx and on x, of the critic on [x, a];
//    2. layer 2 of the three;
//    3. per sample (one warp each): the actor's outputs on nx, a' = tanh(.)
//       (TD3: clip(a' + nz, -1, 1)), and on x, a_pi = tanh(.); the online
//       critic's E values q_e;
//    4. layer 1 of the target critic on [nx, a'];
//    5. its layer 2;
//    6. per sample: the target's E values, their min (TD3) or mean (DDPG),
//       the label r + ud gamma nq, the loss and its gradient at q_e (TD3:
//       mean_E((q_e - label)^2) um; DDPG: (mean_E(q_e) um - label)^2 um, the
//       unmask twice as the reference writes it; times PER's weight iw[b]),
//       the unweighted TD error to td_out;
//    7. the critic's head weight gradient; the gradient at layer 2's output;
//    8. layer 2's weight gradient; the gradient at layer 1's output;
//    9. layer 1's weight gradient;
//   10. the critic's gradient from the splits, and the norm's partials;
//   11. clip + Adam + Polyak of the critic, skipped when the step is invalid;
//   12. the updated critic's layer 1 on [x, a_pi];
//   13. its layer 2;
//   14. per sample: mean_E(q) for the objective; d(-mean(q)) back through the
//       output layer and GELU;
//   15. the gradient at layer 1's output;
//   16. per sample: the gradient at a_pi (the critic's W1 action columns)
//       through tanh' = 1 - a_pi^2;
//   17-19. the actor's backward, as 7-9;
//   20. the actor's gradient from the splits, and the norm's partials;
//   21. clip + Adam + Polyak of the actor, computed every step and skipped
//       unless valid * do_act (as the TPU kernel masks it); block 0 writes
//       the step's objectives.
// With a trace buffer, block 0 stamps %globaltimer at the start and after
// each phase, NPH + 1 stamps an update, to show what sets the time.

#include <cuda_runtime.h>
#include <stdint.h>

#include "grid_gemm.cuh"

namespace {

using gg::Job;
using gg::mat;
using gg::mat2;

constexpr int NPH = 21;      // phases an update
constexpr int KSPLIT = 128;  // samples per depth split of a weight gradient

struct Args {
  float *pa, *pc, *ta, *tc, *mua, *muc, *nua, *nuc;
  const float *sb, *nsb, *ab, *rb, *ud, *um, *nz, *bcv, *iw;
  float *td_out, *objs;
  // workspace: the activations of one update, then the gradient and partials
  float *h1n, *z1x, *h1x, *z1c, *h1c, *h1t, *z1q, *h1q;  // (B, D1)
  float *h2n, *z2x, *h2x, *z2c, *h2c, *h2t, *z2q, *h2q;  // (B, D2)
  float *na, *api;                                       // (A, B)
  float *qo, *gq;                                        // (B, E)
  float* gao;                                            // (B, A)
  float *part, *grad, *normpart, *objpart;
  unsigned int* bar;
  unsigned long long* trace;  // (C, NPH + 1) stamps, or null
  int C, B, S, A, D1, D2, E, td3, nsplit;
  long long Pa, Pc;
  float gamma, tau, lr, clip_grad, b1, b2, eps;
};

// Offsets in a flat 3-layer MLP K -> D1 -> D2 -> O.
__host__ __device__ inline long long off_w2(int K, int D1) { return (long long)D1 * K + D1; }
__host__ __device__ inline long long off_wo(int K, int D1, int D2) {
  return off_w2(K, D1) + (long long)D2 * D1 + D2;
}
__host__ __device__ inline long long net_floats(int K, int D1, int D2, int O) {
  return off_wo(K, D1, D2) + (long long)O * D2 + O;
}

// Phase 3: the actor's outputs on nx and x and the online critic's values.
__device__ void heads_phase(const Args& a, int u) {
  const int lane = threadIdx.x & 31, nw = gridDim.x * (gg::THREADS / 32);
  const int B = a.B, A = a.A, D2 = a.D2, E = a.E;
  const float* nz = a.nz + (size_t)u * A * B;
  const float* Wa = a.pa + off_wo(a.S, a.D1, D2);
  const float* Wc = a.pc + off_wo(a.S + A, a.D1, D2);
  for (int b = blockIdx.x * (gg::THREADS / 32) + (threadIdx.x >> 5); b < B; b += nw) {
    const float* hn = a.h2n + (size_t)b * D2;
    const float* hx = a.h2x + (size_t)b * D2;
    const float* hc = a.h2c + (size_t)b * D2;
    for (int k = 0; k < A; ++k) {
      const float bo = __ldcg(Wa + (long long)A * D2 + k);
      float an = tanhf(gg::warp_dot(Wa + (long long)k * D2, hn, D2) + bo);
      if (a.td3) an = fminf(fmaxf(an + __ldg(nz + (size_t)k * B + b), -1.0f), 1.0f);
      const float ax = tanhf(gg::warp_dot(Wa + (long long)k * D2, hx, D2) + bo);
      if (lane == 0) {
        a.na[(size_t)k * B + b] = an;
        a.api[(size_t)k * B + b] = ax;
      }
    }
    for (int e = 0; e < E; ++e) {
      const float q = gg::warp_dot(Wc + (long long)e * D2, hc, D2) +
                      __ldcg(Wc + (long long)E * D2 + e);
      if (lane == 0) a.qo[(size_t)b * E + e] = q;
    }
  }
}

// Phase 6: the label, the loss, the gradient at the critic's E values, the
// TD errors and the block's share of the critic loss.
__device__ void loss_phase(const Args& a, int u, gg::Smem& sm) {
  const int lane = threadIdx.x & 31, nw = gridDim.x * (gg::THREADS / 32);
  const int B = a.B, D2 = a.D2, E = a.E;
  const float* rb = a.rb + (size_t)u * B;
  const float* ud = a.ud + (size_t)u * B;
  const float* um = a.um + (size_t)u * B;
  const float* iw = a.iw != nullptr ? a.iw + (size_t)u * B : nullptr;
  float* td_out = a.td_out != nullptr ? a.td_out + (size_t)u * B : nullptr;
  const float* Wt = a.tc + off_wo(a.S + a.A, a.D1, D2);
  const float inv_B = 1.0f / (float)B;
  float obj = 0.f;
  for (int b = blockIdx.x * (gg::THREADS / 32) + (threadIdx.x >> 5); b < B; b += nw) {
    const float* ht = a.h2t + (size_t)b * D2;
    const float* q = a.qo + (size_t)b * E;
    float* g = a.gq + (size_t)b * E;
    float nq = 0.f;
    for (int e = 0; e < E; ++e) {
      const float v = gg::warp_dot(Wt + (long long)e * D2, ht, D2) +
                      __ldcg(Wt + (long long)E * D2 + e);
      nq = e == 0 ? v : (a.td3 ? fminf(nq, v) : nq + v);
    }
    if (!a.td3) nq /= (float)E;
    const float label = __ldg(rb + b) + __ldg(ud + b) * a.gamma * nq;
    const float w = __ldg(um + b);
    const float is_w = iw != nullptr ? __ldg(iw + b) : 1.0f;  // PER's weight, else 1
    float td = 0.f;
    if (a.td3) {
      for (int e = 0; e < E; ++e) {
        const float diff = __ldcg(q + e) - label;
        td += diff * diff;
        if (lane == 0) g[e] = 2.0f * diff / (float)E * w * is_w * inv_B;
      }
      td = td / (float)E * w;
    } else {
      float qm = 0.f;
      for (int e = 0; e < E; ++e) qm += __ldcg(q + e);
      qm = qm / (float)E * w;
      const float diff = qm - label;
      td = diff * diff * w;
      const float gv = 2.0f * diff * w * w / (float)E * is_w * inv_B;
      if (lane == 0)
        for (int e = 0; e < E; ++e) g[e] = gv;
    }
    if (lane == 0) {
      if (td_out != nullptr) td_out[b] = td;
      obj += td * is_w;
    }
  }
  const float s = gg::block_sum2(obj, 0.f, sm).x;
  if (threadIdx.x == 0) a.objpart[blockIdx.x * 2] = s;
}

// Phase 14: the block's share of mean_E(q) of the actor step, and d(-mean(q))
// / d q_e = -1 / (E B) back through the output layer and GELU, over z2q.
__device__ void actor_q_phase(const Args& a, gg::Smem& sm) {
  const int lane = threadIdx.x & 31, nw = gridDim.x * (gg::THREADS / 32);
  const int B = a.B, D2 = a.D2, E = a.E;
  const float* W = a.pc + off_wo(a.S + a.A, a.D1, D2);
  const float g = -1.0f / (float)B / (float)E;
  float obj = 0.f;
  for (int b = blockIdx.x * (gg::THREADS / 32) + (threadIdx.x >> 5); b < B; b += nw) {
    const float* h = a.h2q + (size_t)b * D2;
    float qs = 0.f;
    for (int e = 0; e < E; ++e)
      qs += gg::warp_dot(W + (long long)e * D2, h, D2) + __ldcg(W + (long long)E * D2 + e);
    if (lane == 0) obj += qs / (float)E;
    float* z = a.z2q + (size_t)b * D2;
    for (int j = lane; j < D2; j += 32) {
      float cs = 0.f;
      for (int e = 0; e < E; ++e) cs += __ldcg(W + (long long)e * D2 + j);
      z[j] = cs * g * mlp::gelu_tanh_grad(__ldcg(z + j));
    }
  }
  const float s = gg::block_sum2(obj, 0.f, sm).x;
  if (threadIdx.x == 0) a.objpart[blockIdx.x * 2 + 1] = s;
}

// Phase 16: the gradient at the actor's output pre-activation, (d loss / d
// a_pi) (1 - a_pi^2), from the gradient at the critic's layer-1 output and
// W1's action columns.
__device__ void action_grad_phase(const Args& a) {
  const int lane = threadIdx.x & 31, nw = gridDim.x * (gg::THREADS / 32);
  const int B = a.B, A = a.A, S = a.S, D1 = a.D1, K = S + A;
  for (int b = blockIdx.x * (gg::THREADS / 32) + (threadIdx.x >> 5); b < B; b += nw) {
    const float* g1 = a.z1q + (size_t)b * D1;
    for (int k = 0; k < A; ++k) {
      float s = 0.f;
      for (int j = lane; j < D1; j += 32)
        s = fmaf(__ldcg(a.pc + (long long)j * K + S + k), __ldcg(g1 + j), s);
      s = mlp::warp_sum(s);
      const float y = __ldcg(a.api + (size_t)k * B + b);
      if (lane == 0) a.gao[(size_t)b * A + k] = s * (1.0f - y * y);
    }
  }
}

__global__ void __launch_bounds__(gg::THREADS, 1) ddpg_chunk_kernel(const Args a) {
  __shared__ gg::Smem sm;
  const int B = a.B, S = a.S, A = a.A, D1 = a.D1, D2 = a.D2, E = a.E, K = S + A;
  const long long oW2a = off_w2(S, D1), oWoa = off_wo(S, D1, D2);
  const long long oW2c = off_w2(K, D1), oWoc = off_wo(K, D1, D2);
  int ph = 0;
  auto sync = [&](int u) {
    gg::grid_sync(a.bar);
    gg::stamp(a.trace, u, NPH + 1, ++ph);
  };
  for (int u = 0; u < a.C; ++u) {
    const float* x = a.sb + (size_t)u * S * B;
    const float* nx = a.nsb + (size_t)u * S * B;
    const float* ab = a.ab + (size_t)u * A * B;
    const float* row = a.bcv + (size_t)u * 7;
    ph = 0;
    gg::stamp(a.trace, u, NPH + 1, 0);
    // ---- 1. layer 1 of the actor on nx and x, of the critic on [x, a]
    gg::run_list([&](int j) -> Job {
      if (j == 0) return gg::fwd_job(mat(nx, 1, B, B, S), a.pa, D1, S, B, a.h1n, nullptr, 1, D1);
      if (j == 1) return gg::fwd_job(mat(x, 1, B, B, S), a.pa, D1, S, B, a.h1x, a.z1x, 1, D1);
      return gg::fwd_job(mat2(x, ab, S, 1, B, B, K), a.pc, D1, K, B, a.h1c, a.z1c, 1, D1);
    }, 3, sm);
    sync(u);
    // ---- 2. layer 2 of the three
    gg::run_list([&](int j) -> Job {
      if (j == 0)
        return gg::fwd_job(mat(a.h1n, D1, 1, B, D1), a.pa + oW2a, D2, D1, B, a.h2n, nullptr, 1,
                           D2);
      if (j == 1)
        return gg::fwd_job(mat(a.h1x, D1, 1, B, D1), a.pa + oW2a, D2, D1, B, a.h2x, a.z2x, 1,
                           D2);
      return gg::fwd_job(mat(a.h1c, D1, 1, B, D1), a.pc + oW2c, D2, D1, B, a.h2c, a.z2c, 1, D2);
    }, 3, sm);
    sync(u);
    // ---- 3. a', a_pi and the online critic's values
    heads_phase(a, u);
    sync(u);
    // ---- 4-5. the target critic on [nx, a']
    gg::run_list([&](int) -> Job {
      return gg::fwd_job(mat2(nx, a.na, S, 1, B, B, K), a.tc, D1, K, B, a.h1t, nullptr, 1, D1);
    }, 1, sm);
    sync(u);
    gg::run_list([&](int) -> Job {
      return gg::fwd_job(mat(a.h1t, D1, 1, B, D1), a.tc + oW2c, D2, D1, B, a.h2t, nullptr, 1,
                         D2);
    }, 1, sm);
    sync(u);
    // ---- 6. label, loss, the gradient at q_e
    loss_phase(a, u, sm);
    sync(u);
    // ---- 7-9. the critic's backward into the split partials
    gg::run_list([&](int j) -> Job {
      if (j == 0)
        return gg::wgrad_job(a.gq, E, E, mat(a.h2c, D2, 1, B, D2 + 1, D2), D2, B, a.part, oWoc,
                             a.Pc, KSPLIT);
      return gg::dgrad_job(a.gq, E, E, mat(a.pc + oWoc, D2, 1, E, D2), D2, B, a.z2c, D2, 1);
    }, 2, sm);
    sync(u);
    gg::run_list([&](int j) -> Job {
      if (j == 0)
        return gg::wgrad_job(a.z2c, D2, D2, mat(a.h1c, D1, 1, B, D1 + 1, D1), D1, B, a.part,
                             oW2c, a.Pc, KSPLIT);
      return gg::dgrad_job(a.z2c, D2, D2, mat(a.pc + oW2c, D1, 1, D2, D1), D1, B, a.z1c, D1, 1);
    }, 2, sm);
    sync(u);
    gg::run_list([&](int) -> Job {
      return gg::wgrad_job(a.z1c, D1, D1, mat2(x, ab, S, 1, B, B, K + 1, K), K, B, a.part, 0,
                           a.Pc, KSPLIT);
    }, 1, sm);
    sync(u);
    // ---- 10-11. the critic's gradient and norm; clip + Adam + Polyak
    gg::reduce_parts(a.part, a.nsplit, a.Pc, a.grad, a.normpart, sm);
    sync(u);
    gg::clip_adam(a.pc, a.tc, a.muc, a.nuc, a.grad, a.normpart, a.Pc, __ldg(row + 4) > 0.f,
                  __ldg(row), __ldg(row + 1), a.lr, a.clip_grad, a.b1, a.b2, a.eps, a.tau, sm);
    sync(u);
    // ---- 12-13. the updated critic on [x, a_pi]
    gg::run_list([&](int) -> Job {
      return gg::fwd_job(mat2(x, a.api, S, 1, B, B, K), a.pc, D1, K, B, a.h1q, a.z1q, 1, D1);
    }, 1, sm);
    sync(u);
    gg::run_list([&](int) -> Job {
      return gg::fwd_job(mat(a.h1q, D1, 1, B, D1), a.pc + oW2c, D2, D1, B, a.h2q, a.z2q, 1, D2);
    }, 1, sm);
    sync(u);
    // ---- 14-16. back to the actor's outputs
    actor_q_phase(a, sm);
    sync(u);
    gg::run_list([&](int) -> Job {
      return gg::dgrad_job(a.z2q, D2, D2, mat(a.pc + oW2c, D1, 1, D2, D1), D1, B, a.z1q, D1, 1);
    }, 1, sm);
    sync(u);
    action_grad_phase(a);
    sync(u);
    // ---- 17-19. the actor's backward into the split partials
    gg::run_list([&](int j) -> Job {
      if (j == 0)
        return gg::wgrad_job(a.gao, A, A, mat(a.h2x, D2, 1, B, D2 + 1, D2), D2, B, a.part, oWoa,
                             a.Pa, KSPLIT);
      return gg::dgrad_job(a.gao, A, A, mat(a.pa + oWoa, D2, 1, A, D2), D2, B, a.z2x, D2, 1);
    }, 2, sm);
    sync(u);
    gg::run_list([&](int j) -> Job {
      if (j == 0)
        return gg::wgrad_job(a.z2x, D2, D2, mat(a.h1x, D1, 1, B, D1 + 1, D1), D1, B, a.part,
                             oW2a, a.Pa, KSPLIT);
      return gg::dgrad_job(a.z2x, D2, D2, mat(a.pa + oW2a, D1, 1, D2, D1), D1, B, a.z1x, D1, 1);
    }, 2, sm);
    sync(u);
    gg::run_list([&](int) -> Job {
      return gg::wgrad_job(a.z1x, D1, D1, mat(x, 1, B, B, S + 1, S), S, B, a.part, 0, a.Pa,
                           KSPLIT);
    }, 1, sm);
    sync(u);
    // ---- 20-21. the actor's gradient and norm; clip + Adam + Polyak; objectives
    gg::reduce_parts(a.part, a.nsplit, a.Pa, a.grad, a.normpart, sm);
    sync(u);
    if (blockIdx.x == 0) {
      float o0 = 0.f, o1 = 0.f;
      for (int k = threadIdx.x; k < (int)gridDim.x; k += blockDim.x) {
        o0 += __ldcg(a.objpart + 2 * k);
        o1 += __ldcg(a.objpart + 2 * k + 1);
      }
      const float2 o = gg::block_sum2(o0, o1, sm);
      if (threadIdx.x == 0) {
        a.objs[(size_t)u * 2] = o.x / (float)B;
        a.objs[(size_t)u * 2 + 1] = o.y / (float)B;
      }
    }
    gg::clip_adam(a.pa, a.ta, a.mua, a.nua, a.grad, a.normpart, a.Pa,
                  __ldg(row + 4) > 0.f && __ldg(row + 5) > 0.f, __ldg(row + 2), __ldg(row + 3),
                  a.lr, a.clip_grad, a.b1, a.b2, a.eps, a.tau, sm);
    if (u + 1 < a.C) gg::grid_sync(a.bar);
    gg::stamp(a.trace, u, NPH + 1, NPH);
  }
}

// The workspace's layout: each buffer's offset (in floats, from ws) when
// ws is given; returns the floats it takes.
long long carve(Args* a, float* ws, int B, int S, int A, int D1, int D2, int E, int grid,
                int nsplit) {
  long long off = 0;
  auto take = [&](long long n) -> float* {
    float* p = ws != nullptr ? ws + off : nullptr;
    off += gg::round4(n);
    return p;
  };
  const long long Pa = net_floats(S, D1, D2, A), Pc = net_floats(S + A, D1, D2, E);
  const long long P = Pa > Pc ? Pa : Pc;
  float** d1[8] = {&a->h1n, &a->z1x, &a->h1x, &a->z1c, &a->h1c, &a->h1t, &a->z1q, &a->h1q};
  float** d2[8] = {&a->h2n, &a->z2x, &a->h2x, &a->z2c, &a->h2c, &a->h2t, &a->z2q, &a->h2q};
  for (int i = 0; i < 8; ++i) *d1[i] = take((long long)B * D1);
  for (int i = 0; i < 8; ++i) *d2[i] = take((long long)B * D2);
  a->na = take((long long)A * B);
  a->api = take((long long)A * B);
  a->qo = take((long long)B * E);
  a->gq = take((long long)B * E);
  a->gao = take((long long)B * A);
  a->part = take(nsplit * P);
  a->grad = take(P);
  a->normpart = take(grid);
  a->objpart = take(2LL * grid);
  a->bar = (unsigned int*)take(4);
  return off;
}

int splits(int B) { return (B + KSPLIT - 1) / KSPLIT; }

}  // namespace

// Static shared memory of one block: the operand tiles and reduction slots
// (gg::Smem), whatever the widths, the batch or the ensemble.
extern "C" int ddpg_update_smem_bytes() {
  return (int)sizeof(gg::Smem);
}

// Blocks of the cooperative launch: one per SM (negative: minus the CUDA
// error when the card cannot launch it).
extern "C" int ddpg_update_grid() { return gg::coop_grid(ddpg_chunk_kernel); }

// Floats of the workspace for a launch of `grid` blocks.
extern "C" long long ddpg_update_workspace_floats(int B, int S, int A, int D1, int D2, int E,
                                                  int grid) {
  Args a;
  return carve(&a, nullptr, B, S, A, D1, D2, E, grid, splits(B));
}

// Phases an update (the trace holds NPH + 1 stamps an update).
extern "C" int ddpg_update_phases() { return NPH; }

// bcv: (C, 7) float rows (bc1_c, bc2_c, bc1_a, bc2_a, valid, do_act, 0).
// Blocks: sb, nsb (C, S, B), ab, nz (C, A, B), rb, ud, um (C, B).  objs:
// (C, 2), the critic loss and the actor step's mean Q.  iw and td_out:
// (C, B) PER importance weights in and per-sample TD errors out, or both
// null.  ws: ddpg_update_workspace_floats(...) floats; grid from
// ddpg_update_grid(); trace null or (C, NPH + 1) uint64 stamps.  One
// cooperative launch; returns its CUDA status.
extern "C" int ddpg_update(void* pa, void* pc, void* ta, void* tc, void* mua, void* muc,
                           void* nua, void* nuc, const void* sb, const void* nsb,
                           const void* ab, const void* rb, const void* ud, const void* um,
                           const void* nz, const void* bcv, const void* iw, void* td_out,
                           void* ws, void* objs, void* trace, int grid, int C, int B, int S,
                           int A, int D1, int D2, int E, int td3, float gamma, float tau,
                           float lr, float clip_grad, float b1, float b2, float eps,
                           void* stream) {
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
  a.sb = (const float*)sb;
  a.nsb = (const float*)nsb;
  a.ab = (const float*)ab;
  a.rb = (const float*)rb;
  a.ud = (const float*)ud;
  a.um = (const float*)um;
  a.nz = (const float*)nz;
  a.bcv = (const float*)bcv;
  a.iw = (const float*)iw;
  a.td_out = (float*)td_out;
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
  a.td3 = td3;
  a.Pa = net_floats(S, D1, D2, A);
  a.Pc = net_floats(S + A, D1, D2, E);
  a.gamma = gamma;
  a.tau = tau;
  a.lr = lr;
  a.clip_grad = clip_grad;
  a.b1 = b1;
  a.b2 = b2;
  a.eps = eps;
  return gg::coop_launch(ddpg_chunk_kernel, a, a.bar, grid, (cudaStream_t)stream);
}
