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
// parameters, moments and targets, about 0.4 us of memory time.
//
// Design:
// - On the TPU one kernel kept both nets, their targets and their Adam
//   moments (582 KB at the main shape) in VMEM for all C steps.  Here they
//   do not fit one block, and the actor step depends on the critic step of
//   the same update, so each update is six launches, one after another on
//   one stream: critic fwd_bwd, reduce, clip + Adam + Polyak of the critic
//   (masked by the step's valid flag), then actor fwd_bwd, reduce, clip +
//   Adam + Polyak of the actor (masked by valid * do_act).  The actor step
//   is computed every step and masked, as the TPU kernel does.
// - critic fwd_bwd, one block per TB = 32 samples: the online actor on nx
//   gives a' = tanh(.) (TD3: clip(a' + nz, -1, 1)); the target critic on
//   [nx, a'] gives E values, their min (TD3) or mean (DDPG) makes the label
//   r + ud gamma nq.  The online critic on [x, a] gives q_e; TD3's loss is
//   mean_E((q_e - label)^2) um, DDPG's (mean_E(q_e) um - label)^2 um (the
//   unmask twice, as the reference writes it); its gradient at q_e goes
//   back through the critic to the block's partial gradients.
// - actor fwd_bwd: a = tanh(actor(x)); the updated critic on [x, a] gives
//   q_e and the loss -mean(q); the backward runs through the critic's
//   layers to its action inputs only (no critic gradient is kept), through
//   tanh' = 1 - a^2 and then the actor.  The actor and the critic keep
//   separate activation tiles, since both backward passes need them.
// - Per-sample work (labels, losses, head gradients) runs on warp 0, lane =
//   sample.  Partial gradients are per block, without atomics, so results
//   are deterministic.
// - Prioritised replay (K7'): the critic fwd_bwd takes the importance weights
//   iw (C, B) and weighs sample b's loss summand and head gradient by iw[b],
//   the gradient of mean(td * iw); it stores the unweighted td (after the
//   unmask) of every step, valid or not, to td_out (C, B) for the caller's
//   priority fold.  Both pointers are null without PER; the launches stay
//   six per update.

#include <cuda_runtime.h>
#include <stdint.h>

#include "mlp_grad.cuh"

namespace {

using namespace mlp;

__host__ __device__ inline int net_floats(int K, int D1, int D2, int O) {
  return D1 * K + D1 + D2 * D1 + D2 + O * D2 + O;
}

__host__ __device__ inline int max_i(int a, int b) { return a > b ? a : b; }

// The block's shared tiles: xin and dx (ld(S + A)), the actor's z1 h1 z2 h2
// and the critic's, the head tile (ld(max(E, A))), aa (ld(A)) and the labels.
struct Smem {
  Tiles act, cri;
  float *dx, *aa, *label;
  int ldsa, lda;
};

__device__ Smem carve(float* smem, int S, int A, int D1, int D2, int E) {
  Smem m;
  m.ldsa = ld(S + A);
  m.lda = ld(A);
  const int ld1 = ld(D1), ld2 = ld(D2), ldh = ld(max_i(E, A));
  float* xin = smem;
  m.dx = xin + TB * m.ldsa;
  float* cur = m.dx + TB * m.ldsa;
  Tiles* both[2] = {&m.act, &m.cri};
  for (int n = 0; n < 2; ++n) {
    Tiles* t = both[n];
    t->xn = xin;
    t->lds = m.ldsa;
    t->ld1 = ld1;
    t->ld2 = ld2;
    t->ldh = ldh;
    t->z1 = cur;
    t->h1 = cur + TB * ld1;
    t->z2 = cur + 2 * TB * ld1;
    t->h2 = cur + 2 * TB * ld1 + TB * ld2;
    cur += 2 * TB * ld1 + 2 * TB * ld2;
  }
  m.act.head = m.cri.head = cur;
  m.aa = cur + TB * ldh;
  m.label = m.aa + TB * m.lda;
  return m;
}

// xin[e][0:S] <- the block's samples of blk (S, B); xin[e][S:S+A] <- of
// act (A, B) when given.
__device__ void load_x(float* xin, int ldsa, const float* __restrict__ blk,
                       const float* __restrict__ act, int S, int A, int B, int b0) {
  const int K = act != nullptr ? S + A : S;
  for (int idx = threadIdx.x; idx < TB * K; idx += blockDim.x) {
    const int i = idx / K, s = idx - i * K;
    float v = 0.f;
    if (b0 + i < B) v = s < S ? blk[(size_t)s * B + b0 + i] : act[(size_t)(s - S) * B + b0 + i];
    xin[i * ldsa + s] = v;
  }
  __syncthreads();
}

__global__ void __launch_bounds__(THREADS)
critic_kernel(const float* __restrict__ pa, const float* __restrict__ pc,
              const float* __restrict__ tc, const float* __restrict__ sb,
              const float* __restrict__ nsb, const float* __restrict__ ab,
              const float* __restrict__ rb, const float* __restrict__ ud,
              const float* __restrict__ um, const float* __restrict__ nz,
              const float* __restrict__ iw, float* __restrict__ td_out,
              float* __restrict__ partial, float* __restrict__ objpart, int B, int S, int A,
              int D1, int D2, int E, int Pc, int td3, float gamma) {
  extern __shared__ float smem[];
  Smem m = carve(smem, S, A, D1, D2, E);
  Tiles& t = m.cri;
  float* xin = t.xn;
  const int b0 = blockIdx.x * TB;
  const int e = threadIdx.x;
  const int b = b0 + e;
  const bool live = e < TB && b < B;
  const float inv_B = 1.0f / (float)B;

  // ---- label: the online actor and the target critic on nx
  load_x(xin, m.ldsa, nsb, nullptr, S, A, B, b0);
  net_forward(pa, t, S, D1, D2, A);
  if (e < TB) {
    for (int a = 0; a < A; ++a) {
      float na = tanhf(t.head[e * t.ldh + a]);
      if (td3) na = fminf(fmaxf(na + (live ? nz[(size_t)a * B + b] : 0.f), -1.0f), 1.0f);
      xin[e * m.ldsa + S + a] = live ? na : 0.f;
    }
  }
  __syncthreads();
  net_forward(tc, t, S + A, D1, D2, E);
  if (e < TB) {
    const float* q = t.head + e * t.ldh;
    float nq = q[0];
    for (int k = 1; k < E; ++k) nq = td3 ? fminf(nq, q[k]) : nq + q[k];
    if (!td3) nq /= (float)E;
    m.label[e] = live ? rb[b] + ud[b] * gamma * nq : 0.f;
  }
  __syncthreads();

  // ---- the critic loss on [x, a] and its gradient at the E outputs
  load_x(xin, m.ldsa, sb, ab, S, A, B, b0);
  net_forward(pc, t, S + A, D1, D2, E);
  if (e < TB) {
    float* q = t.head + e * t.ldh;
    const float w = live ? um[b] : 0.f;
    const float is_w = (live && iw != nullptr) ? iw[b] : 1.0f;  // PER's weight, else 1
    const float l = m.label[e];
    float td = 0.f;
    if (td3) {
      for (int k = 0; k < E; ++k) {
        const float diff = q[k] - l;
        td += diff * diff;
        q[k] = 2.0f * diff / (float)E * w * is_w * inv_B;
      }
      td = td / (float)E * w;
    } else {
      float qm = 0.f;
      for (int k = 0; k < E; ++k) qm += q[k];
      qm = qm / (float)E * w;
      const float diff = qm - l;
      td = diff * diff * w;
      for (int k = 0; k < E; ++k) q[k] = 2.0f * diff * w * w / (float)E * is_w * inv_B;
    }
    if (live && td_out != nullptr) td_out[b] = td;
    const float obj = warp_sum(live ? td * is_w : 0.f);
    if (e == 0) {
      objpart[blockIdx.x * 2 + 0] = obj;
      objpart[blockIdx.x * 2 + 1] = 0.f;
    }
  }
  __syncthreads();
  net_backward(pc, partial + (size_t)blockIdx.x * Pc, t, S + A, D1, D2, E);
}

__global__ void __launch_bounds__(THREADS)
actor_kernel(const float* __restrict__ pa, const float* __restrict__ pc,
             const float* __restrict__ sb, float* __restrict__ partial,
             float* __restrict__ objpart, int B, int S, int A, int D1, int D2, int E,
             int Pa) {
  extern __shared__ float smem[];
  Smem m = carve(smem, S, A, D1, D2, E);
  float* xin = m.act.xn;
  const int b0 = blockIdx.x * TB;
  const int e = threadIdx.x;
  const int b = b0 + e;
  const bool live = e < TB && b < B;
  const float inv_B = 1.0f / (float)B;

  load_x(xin, m.ldsa, sb, nullptr, S, A, B, b0);
  net_forward(pa, m.act, S, D1, D2, A);
  if (e < TB) {
    for (int a = 0; a < A; ++a) {
      const float aa = tanhf(m.act.head[e * m.act.ldh + a]);
      m.aa[e * m.lda + a] = aa;
      xin[e * m.ldsa + S + a] = aa;
    }
  }
  __syncthreads();
  Tiles& c = m.cri;
  net_forward(pc, c, S + A, D1, D2, E);
  if (e < TB) {
    float* q = c.head + e * c.ldh;
    float qm = 0.f;
    for (int k = 0; k < E; ++k) {
      qm += q[k];
      q[k] = live ? -inv_B / (float)E : 0.f;  // d(-mean(q)) / d q_e
    }
    const float obj = warp_sum(live ? qm / (float)E : 0.f);
    if (e == 0) {
      objpart[blockIdx.x * 2 + 0] = 0.f;
      objpart[blockIdx.x * 2 + 1] = obj;
    }
  }
  __syncthreads();
  // through the critic to its inputs; no critic gradient is kept
  const int K = S + A;
  const float* W2c = pc + D1 * K + D1;
  const float* Woc = W2c + D2 * D1 + D2;
  bwd_data(Woc, c.head, c.ldh, c.z2, c.ld2, E, D2);
  __syncthreads();
  bwd_data(W2c, c.z2, c.ld2, c.z1, c.ld1, D2, D1);
  __syncthreads();
  bwd_in<1>(pc, c.z1, c.ld1, m.dx, m.ldsa, D1, K);
  __syncthreads();
  if (e < TB) {
    for (int a = 0; a < A; ++a) {
      const float aa = m.aa[e * m.lda + a];
      m.act.head[e * m.act.ldh + a] = live ? m.dx[e * m.ldsa + S + a] * (1.0f - aa * aa) : 0.f;
    }
  }
  __syncthreads();
  net_backward(pa, partial + (size_t)blockIdx.x * Pa, m.act, S, D1, D2, A);
}

}  // namespace

// Dynamic shared memory of one fwd_bwd block, in bytes (the layout of carve).
extern "C" int ddpg_update_smem_bytes(int S, int A, int D1, int D2, int E) {
  return (int)sizeof(float) * TB *
         (2 * ld(S + A) + 4 * ld(D1) + 4 * ld(D2) + ld(max_i(E, A)) + ld(A) + 1);
}

// Scratch sizes: partial gradients (nb, max(Pa, Pc)), objective partials
// (nb, 2), gradient (max(Pa, Pc)), norm partials (nr).
extern "C" int ddpg_update_blocks(int B) { return (B + TB - 1) / TB; }
extern "C" int ddpg_update_reduce_blocks(int P) { return reduce_blocks(P); }

// bcv: (C, 7) float rows (bc1_c, bc2_c, bc1_a, bc2_a, valid, do_act, 0).
// Blocks: sb, nsb (C, S, B), ab, nz (C, A, B), rb, ud, um (C, B).  objs:
// (C, 2), the critic loss and the actor step's mean Q.  iw and td_out:
// (C, B) PER importance weights in and per-sample TD errors out, or both
// null.
extern "C" int ddpg_update(void* pa, void* pc, void* ta, void* tc, void* mua, void* muc,
                           void* nua, void* nuc, const void* sb, const void* nsb,
                           const void* ab, const void* rb, const void* ud, const void* um,
                           const void* nz, const void* bcv, void* partial, void* objpart,
                           void* grad, void* normpart, void* objs, const void* iw,
                           void* td_out, int C, int B, int S,
                           int A, int D1, int D2, int E, int td3, float gamma, float tau,
                           float lr, float clip_grad, float b1, float b2, float eps,
                           void* stream) {
  const int smem = ddpg_update_smem_bytes(S, A, D1, D2, E);
  cudaError_t err = cudaFuncSetAttribute(
      critic_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(actor_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return (int)err;
  const int Pa = net_floats(S, D1, D2, A), Pc = net_floats(S + A, D1, D2, E);
  const int nb = ddpg_update_blocks(B);
  const int nra = ddpg_update_reduce_blocks(Pa), nrc = ddpg_update_reduce_blocks(Pc);
  cudaStream_t st = (cudaStream_t)stream;
  for (int u = 0; u < C; ++u) {
    const size_t o = (size_t)u * B;
    const float* row = (const float*)bcv + (size_t)u * 7;
    float* obj_u = (float*)objs + (size_t)u * 2;
    critic_kernel<<<nb, THREADS, smem, st>>>(
        (const float*)pa, (const float*)pc, (const float*)tc, (const float*)sb + o * S,
        (const float*)nsb + o * S, (const float*)ab + o * A, (const float*)rb + o,
        (const float*)ud + o, (const float*)um + o, (const float*)nz + o * A,
        iw != nullptr ? (const float*)iw + o : nullptr,
        td_out != nullptr ? (float*)td_out + o : nullptr,
        (float*)partial, (float*)objpart, B, S, A, D1, D2, E, Pc, td3, gamma);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    reduce_one_kernel<<<nrc, THREADS, 0, st>>>((const float*)partial, nb, Pc, (float*)grad,
                                               (float*)normpart);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    clip_adam_polyak_kernel<<<nrc, THREADS, 0, st>>>(
        (float*)pc, (float*)muc, (float*)nuc, (float*)tc, (const float*)grad,
        (const float*)normpart, nrc, Pc, row, 0, 1, 4, -1, (const float*)objpart, nb, obj_u,
        0, 1, B, lr, clip_grad, b1, b2, eps, tau);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    actor_kernel<<<nb, THREADS, smem, st>>>((const float*)pa, (const float*)pc,
                                            (const float*)sb + o * S, (float*)partial,
                                            (float*)objpart, B, S, A, D1, D2, E, Pa);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    reduce_one_kernel<<<nra, THREADS, 0, st>>>((const float*)partial, nb, Pa, (float*)grad,
                                               (float*)normpart);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    clip_adam_polyak_kernel<<<nra, THREADS, 0, st>>>(
        (float*)pa, (float*)mua, (float*)nua, (float*)ta, (const float*)grad,
        (const float*)normpart, nra, Pa, row, 2, 3, 4, 5, (const float*)objpart, nb, obj_u,
        1, 1, B, lr, clip_grad, b1, b2, eps, tau);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  return (int)cudaGetLastError();
}
