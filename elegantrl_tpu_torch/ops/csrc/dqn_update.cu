// Fused DQN-family update chunk: C sequential minibatch updates of the TD
// loss against the Polyak-averaged target net, each followed by optax's
// clip-by-global-norm + Adam over the whole Q-net and the Polyak step, in
// place on flat parameter, target and moment buffers, for the four nets
// (plain DQN; twin = DoubleDQN; duel = DuelingDQN; twin + duel = D3QN).
//
// Replaces: elegantrl_tpu/ops/pallas_update.py, make_dqn_fused_chunk
// (kernel at :476, pallas_call at :560).
//
// Bound on this card: operations by the roofline, launches and latency in
// practice.  One update at B = 128 and (128, 128) is about 17.6 MFLOP (the
// target forward, the online forward and its backward), about 0.26 us of
// FP32 CUDA-core time for the whole card, and moves about 0.5 MB (p, t, mu,
// nu read and written once), about 0.15 us; the three launches of a step,
// and the 4 blocks that B = 128 fills, cost far more than either.
//
// Design:
// - On the TPU one kernel kept p, t, mu and nu (279 KB at (128, 128)) and
//   the minibatch block resident in VMEM for all C steps.  Here they do not
//   fit one block's 227 KB of shared memory, so each step is three launches
//   launched one after another on one stream (as the PPO update's):
//   1. fwd_bwd: one block per TB = 32 samples computes the target net's
//      forward on nx (the TD label), the online net's forward on x, the loss
//      and the hand-written backward, and writes its partial gradients and
//      objective sums (no atomics, so results are deterministic);
//   2. reduce: sums the partials per parameter and the squared norm;
//   3. clip + Adam + Polyak with the step's bias corrections from the
//      (C, 3) table, skipped entirely when the step's valid flag is 0 (every
//      buffer then stays bit-identical), and the step's objectives.
// - The nets are a trunk and heads.  Plain DQN: the trunk is two GELU
//   layers and the one head is the output layer (A).  The other nets: the
//   trunk is the encoder, GELU after layer 1 only, and the heads are val1
//   (A), adv1 (1) when duel, val2 (A) and adv2 (1) when twin, in the flat
//   buffer's leaf order.  Head outputs share one tile, one column range per
//   head.
// - Per sample (warp 0, lane = sample): q = val - mean(val) + adv for the
//   twin dueling net (D3QN); the dueling net without a twin reads its value
//   head alone on the TD path, as the reference's QNetDuel.get_q_value, so
//   its adv1 head gets a zero gradient; the label is r + ud gamma max_a of
//   the target's q (twin: of the min of both heads).  With q_a = sum(q *
//   onehot) and d = 2 (q_a - label) um / B, the gradient into head values is
//   onehot * d, through the dueling combine g - mean(g) into val and sum(g)
//   into adv.  The heads' gradients at the encoding are summed (no GELU
//   after the encoder), then the trunk's backward as for any MLP.
// - No gradient passes through the target net: the label is a constant.

#include <cuda_runtime.h>
#include <stdint.h>

#include "mlp_grad.cuh"

namespace {

using namespace mlp;

struct Heads {
  int n;          // number of heads
  int width[4];   // outputs of each head
  int col[4];     // first column of each head in the head tile
  int off[4];     // offset of each head's W in the flat buffer
};

__host__ __device__ inline int trunk_floats(int S, int D1, int D2) {
  return D1 * S + D1 + D2 * D1 + D2;
}

__host__ __device__ inline Heads make_heads(int S, int A, int D1, int D2, int twin,
                                            int duel) {
  Heads h;
  h.n = 0;
  const int w_all[4] = {A, 1, A, 1};
  const bool on[4] = {true, duel != 0, twin != 0, twin != 0 && duel != 0};
  int col = 0, off = trunk_floats(S, D1, D2);
  for (int k = 0; k < 4; ++k) {
    if (!on[k]) continue;
    h.width[h.n] = w_all[k];
    h.col[h.n] = col;
    h.off[h.n] = off;
    col += w_all[k];
    off += w_all[k] * D2 + w_all[k];
    ++h.n;
  }
  return h;
}

__host__ __device__ inline int head_cols(int A) { return 2 * A + 2; }

// Forward of the trunk and every head for the input in t.xn; head outputs
// land in t.head.  enc: the second trunk layer is raw.
__device__ void q_forward(const float* flat, const Tiles& t, const Heads& hd, int S,
                          int D1, int D2, bool enc) {
  const float* W1 = flat;
  const float* b1 = W1 + D1 * S;
  const float* W2 = b1 + D1;
  const float* b2 = W2 + D2 * D1;
  fwd<true>(W1, b1, t.xn, t.lds, t.z1, t.h1, t.ld1, D1, S);
  __syncthreads();
  if (enc) fwd<false>(W2, b2, t.h1, t.ld1, nullptr, t.h2, t.ld2, D2, D1);
  else fwd<true>(W2, b2, t.h1, t.ld1, t.z2, t.h2, t.ld2, D2, D1);
  __syncthreads();
  for (int k = 0; k < hd.n; ++k) {  // distinct columns: no barrier between heads
    const float* W = flat + hd.off[k];
    fwd<false>(W, W + hd.width[k] * D2, t.h2, t.ld2, nullptr, t.head + hd.col[k], t.ldh,
               hd.width[k], D2);
  }
  __syncthreads();
}

// The TD-path q of head pair 0 (head 0, and head 1 when twin) for action a
// of one sample's head row; means are precomputed.
__device__ __forceinline__ float q_td(const float* row, const Heads& hd, int pair, int a,
                                      bool combine, float mean) {
  const int k = combine ? 2 * pair : pair;  // value head of the pair
  const float v = row[hd.col[k] + a];
  return combine ? v - mean + row[hd.col[k + 1]] : v;
}

__global__ void __launch_bounds__(THREADS)
fwd_bwd_kernel(const float* __restrict__ p, const float* __restrict__ t,
               const float* __restrict__ sb, const float* __restrict__ nsb,
               const float* __restrict__ oh, const float* __restrict__ rb,
               const float* __restrict__ ud, const float* __restrict__ um,
               float* __restrict__ partial, float* __restrict__ objpart, int B, int S,
               int A, int D1, int D2, int P, int twin, int duel, float gamma) {
  extern __shared__ float smem[];
  Tiles tl;
  tl.lds = ld(S);
  tl.ld1 = ld(D1);
  tl.ld2 = ld(D2);
  tl.ldh = ld(head_cols(A));
  tl.xn = smem;
  tl.z1 = tl.xn + TB * tl.lds;
  tl.h1 = tl.z1 + TB * tl.ld1;
  tl.z2 = tl.h1 + TB * tl.ld1;
  tl.h2 = tl.z2 + TB * tl.ld2;
  tl.head = tl.h2 + TB * tl.ld2;
  float* label = tl.head + TB * tl.ldh;

  const Heads hd = make_heads(S, A, D1, D2, twin, duel);
  const bool enc = twin || duel;
  const bool combine = twin && duel;
  const int b0 = blockIdx.x * TB;
  const int e = threadIdx.x;  // sample slot when e < TB (warp 0)
  const int b = b0 + e;
  const bool live = e < TB && b < B;
  const float inv_B = 1.0f / (float)B;

  // ---- the TD label from the target net on nx
  for (int idx = threadIdx.x; idx < TB * S; idx += blockDim.x) {
    const int i = idx / S, s = idx - i * S;
    tl.xn[i * tl.lds + s] = b0 + i < B ? nsb[(size_t)s * B + b0 + i] : 0.f;
  }
  __syncthreads();
  q_forward(t, tl, hd, S, D1, D2, enc);
  if (e < TB) {
    const float* row = tl.head + e * tl.ldh;
    float m1 = 0.f, m2 = 0.f;
    if (combine) {
      for (int a = 0; a < A; ++a) {
        m1 += row[hd.col[0] + a];
        m2 += row[hd.col[2] + a];
      }
      m1 /= (float)A;
      m2 /= (float)A;
    }
    float best = 0.f;
    for (int a = 0; a < A; ++a) {
      float q = q_td(row, hd, 0, a, combine, m1);
      if (twin) q = fminf(q, q_td(row, hd, 1, a, combine, m2));
      best = a == 0 ? q : fmaxf(best, q);
    }
    label[e] = live ? rb[b] + ud[b] * gamma * best : 0.f;
  }
  __syncthreads();

  // ---- the online net on x: loss, objectives, gradients at the heads
  for (int idx = threadIdx.x; idx < TB * S; idx += blockDim.x) {
    const int i = idx / S, s = idx - i * S;
    tl.xn[i * tl.lds + s] = b0 + i < B ? sb[(size_t)s * B + b0 + i] : 0.f;
  }
  __syncthreads();
  q_forward(p, tl, hd, S, D1, D2, enc);
  if (e < TB) {
    float* row = tl.head + e * tl.ldh;
    float m[2] = {0.f, 0.f};
    if (combine) {
      for (int a = 0; a < A; ++a) {
        m[0] += row[hd.col[0] + a];
        m[1] += row[hd.col[2] + a];
      }
      m[0] /= (float)A;
      m[1] /= (float)A;
    }
    const int pairs = twin ? 2 : 1;
    float qa[2] = {0.f, 0.f};
    for (int pr = 0; pr < pairs; ++pr)
      for (int a = 0; a < A; ++a)
        qa[pr] += q_td(row, hd, pr, a, combine, m[pr]) * (live ? oh[(size_t)a * B + b] : 0.f);
    const float w = live ? um[b] : 0.f;
    float td = 0.f;
    float d[2] = {0.f, 0.f};
    for (int pr = 0; pr < pairs; ++pr) {
      const float diff = qa[pr] - label[e];
      td += diff * diff * w;
      d[pr] = 2.0f * diff * w * inv_B;
    }
    // gradients into the head values: onehot * d, through the combine
    for (int pr = 0; pr < pairs; ++pr) {
      const int k = combine ? 2 * pr : pr;
      float gsum = 0.f;
      for (int a = 0; a < A; ++a) gsum += (live ? oh[(size_t)a * B + b] : 0.f) * d[pr];
      for (int a = 0; a < A; ++a) {
        const float g = (live ? oh[(size_t)a * B + b] : 0.f) * d[pr];
        row[hd.col[k] + a] = combine ? g - gsum / (float)A : g;
      }
      if (combine) row[hd.col[k + 1]] = gsum;
    }
    if (duel && !twin) row[hd.col[1]] = 0.f;  // the TD path does not read adv1
    const float obj_td = warp_sum(td);
    const float obj_q = warp_sum(live ? qa[0] : 0.f);
    if (e == 0) {
      objpart[blockIdx.x * 2 + 0] = obj_td;
      objpart[blockIdx.x * 2 + 1] = obj_q;
    }
  }
  __syncthreads();

  // ---- backward: heads, then the trunk
  float* g = partial + (size_t)blockIdx.x * P;
  for (int k = 0; k < hd.n; ++k) {
    const float* W = p + hd.off[k];
    const int J = hd.width[k];
    wgrad(tl.head + hd.col[k], tl.ldh, tl.h2, tl.ld2, g + hd.off[k], g + hd.off[k] + J * D2,
          J, D2);
    if (!enc) bwd_in<0>(W, tl.head + hd.col[k], tl.ldh, tl.z2, tl.ld2, J, D2);
    else if (k == 0) bwd_in<1>(W, tl.head + hd.col[k], tl.ldh, tl.z2, tl.ld2, J, D2);
    else bwd_in<2>(W, tl.head + hd.col[k], tl.ldh, tl.z2, tl.ld2, J, D2);
  }
  __syncthreads();  // z2 holds d loss / d (layer-2 pre-activation)
  const float* W2 = p + D1 * S + D1;
  wgrad(tl.z2, tl.ld2, tl.h1, tl.ld1, g + D1 * S + D1, g + D1 * S + D1 + D2 * D1, D2, D1);
  bwd_data(W2, tl.z2, tl.ld2, tl.z1, tl.ld1, D2, D1);
  __syncthreads();
  wgrad(tl.z1, tl.ld1, tl.xn, tl.lds, g, g + D1 * S, D1, S);
}

}  // namespace

// Dynamic shared memory of one fwd_bwd block, in bytes.
extern "C" int dqn_update_smem_bytes(int S, int A, int D1, int D2) {
  return (int)sizeof(float) * TB *
         (ld(S) + 2 * ld(D1) + 2 * ld(D2) + ld(head_cols(A)) + 1);
}

// Scratch sizes: partial gradients (nb, P), objective partials (nb, 2),
// gradient (P), norm partials (nr).
extern "C" int dqn_update_blocks(int B) { return (B + TB - 1) / TB; }
extern "C" int dqn_update_reduce_blocks(int P) { return reduce_blocks(P); }

// bcv: (C, 3) float rows (1 - b1^step, 1 - b2^step, valid).  Blocks: sb,
// nsb (C, S, B), oh (C, A, B), rb, ud, um (C, B).  objs: (C, 2).
extern "C" int dqn_update(void* p, void* t, void* mu, void* nu, const void* sb,
                          const void* nsb, const void* oh, const void* rb, const void* ud,
                          const void* um, const void* bcv, void* partial, void* objpart,
                          void* grad, void* normpart, void* objs, int C, int B, int S, int A,
                          int D1, int D2, int twin, int duel, float gamma, float tau,
                          float lr, float clip_grad, float b1, float b2, float eps,
                          void* stream) {
  const int smem = dqn_update_smem_bytes(S, A, D1, D2);
  cudaError_t err = cudaFuncSetAttribute(
      fwd_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const Heads hd = make_heads(S, A, D1, D2, twin, duel);
  const int P = hd.off[hd.n - 1] + hd.width[hd.n - 1] * (D2 + 1);
  const int nb = dqn_update_blocks(B), nr = dqn_update_reduce_blocks(P);
  cudaStream_t st = (cudaStream_t)stream;
  for (int u = 0; u < C; ++u) {
    const size_t o = (size_t)u * B;
    fwd_bwd_kernel<<<nb, THREADS, smem, st>>>(
        (const float*)p, (const float*)t, (const float*)sb + o * S,
        (const float*)nsb + o * S, (const float*)oh + o * A, (const float*)rb + o,
        (const float*)ud + o, (const float*)um + o, (float*)partial, (float*)objpart, B, S,
        A, D1, D2, P, twin, duel, gamma);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    reduce_one_kernel<<<nr, THREADS, 0, st>>>((const float*)partial, nb, P, (float*)grad,
                                              (float*)normpart);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    clip_adam_polyak_kernel<<<nr, THREADS, 0, st>>>(
        (float*)p, (float*)mu, (float*)nu, (float*)t, (const float*)grad,
        (const float*)normpart, nr, P, (const float*)bcv + (size_t)u * 3, 0, 1, 2, -1,
        (const float*)objpart, nb, (float*)objs + (size_t)u * 2, 0, 2, B, lr, clip_grad, b1,
        b2, eps, tau);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  return (int)cudaGetLastError();
}
