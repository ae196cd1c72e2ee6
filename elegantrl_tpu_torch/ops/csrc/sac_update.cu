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
// actor forward, the fresh target ensemble forward and backward to its
// action inputs and the actor backward), about 1.0 GFLOP, 15 us of the
// card's FP32 CUDA-core rate; it moves about 1.3 MB of parameters, targets
// and moments, 0.4 us of memory time.
//
// Design:
// - On the TPU one kernel kept both nets, the critic target and all the Adam
//   moments in VMEM for all C steps (the critic alone is 271 KB at E = 4,
//   1.08 MB with its target and moments).  Here they do not fit one block,
//   and each step's actor update reads the critic step's result, so each
//   update is seven launches, one after another on one stream, following
//   ddpg_update.cu: critic fwd_bwd, reduce, clip + Adam + Polyak of the
//   critic (masked by the step's valid flag), the alpha step, actor
//   fwd_bwd, reduce, clip + Adam of the actor (masked by valid * do_act;
//   ModSAC also moves its actor target).
// - The alpha step is a separate launch of one thread: it needs the
//   batch mean of the pre-update actor's logprob, which the critic fwd_bwd
//   blocks leave as partial sums, and the actor fwd_bwd needs the stepped
//   alpha.  It also takes ModSAC's gate (upd_a restarts at update 0; the
//   actor steps when upd_a / (t + 1) < 1 / (2 - e^-1)) and the actor's own
//   Adam count, and writes the actor step's bias corrections, masks and
//   alpha into a small device row that the actor's kernels read.  alpha_log,
//   its moments, the actor count and upd_a live in `misc` on the device for
//   the whole chunk: no host sync inside a chunk.
// - The ensemble goes head by head: the critic's activation tiles for all
//   E heads at once would need 32 x E D2 x 2 floats per block (256 KB at E =
//   8, ModSAC's default), over the block's limit.  Each head's TD gradient,
//   2 (q_e - label) um / (E B), needs only its own q_e and the label; the
//   label's min over the target heads is forward only; the actor's gradient
//   at its action is a sum over the heads, accumulated into the encoding's
//   gradient tile one head at a time.
// - critic fwd_bwd, one block per TB = 32 samples: the actor on nx with the
//   next-action noise gives a' and logp(a'); the target ensemble on [nx, a']
//   gives min_e Q, the label r + ud gamma (min_e Q - alpha logp(a')); the
//   actor on x with the policy noise gives the block's sum of logp for
//   alpha; then the online ensemble on [x, a], forward and backward head by
//   head, into the block's partial gradients.
// - actor fwd_bwd: the actor on x with the policy noise (SAC: trailing GELU
//   on the trunk and one 2A head; ModSAC: the raw trunk into avg and std
//   heads; log_std clipped to (-16, 2) or (-20, 2)), the fresh target
//   ensemble on [x, tanh(pre)] and back to its action inputs (dq_e =
//   -1 / (E B)), then through tanh, the logprob (SAC's density at the mean;
//   ModSAC's softplus form; the noise is a constant) and the clip (zero
//   gradient outside its range) into the actor's partial gradients.
// - Per-sample work runs on warp 0, lane = sample.  Partial gradients are
//   per block, without atomics, so results are deterministic.

#include <cuda_runtime.h>
#include <stdint.h>

#include "mlp_grad.cuh"

namespace {

using namespace mlp;

constexpr float LOG_SQRT_2PI = 0.91893853320467274178f;
constexpr float LOG_2 = 0.69314718055994530942f;

// The actor: encoder S -> D1 -> D2, then 2A outputs (SAC's one head, or
// ModSAC's avg and std heads: the same count of floats).
__host__ __device__ inline int act_floats(int S, int A, int D1, int D2) {
  return D1 * S + D1 + D2 * D1 + D2 + 2 * (A * D2 + A);
}

// One critic head D1 -> D2 -> 1; the critic is the linear encoder S + A ->
// D1 followed by E heads.
__host__ __device__ inline int head_floats(int D1, int D2) { return D2 * D1 + 2 * D2 + 1; }

__host__ __device__ inline int cri_floats(int S, int A, int D1, int D2, int E) {
  return D1 * (S + A) + D1 + E * head_floats(D1, D2);
}

// The block's shared tiles, sample-major: xin and dx (ld(S + A)); the
// actor's z1, h1 (ld(D1)), z2, h2 (ld(D2)); the critic's encoding and its
// gradient (ld(D1)), one head's zc, hc (ld(D2)); the actor outputs
// (ld(2A)), the heads' q (ld(E)), and two per-sample columns.
struct Smem {
  float *xin, *dx, *z1, *h1, *z2, *h2, *enc, *denc, *zc, *hc, *out, *q, *label, *lp;
  int ldsa, ld1, ld2, ldo, ldq;
};

__device__ Smem carve(float* smem, int S, int A, int D1, int D2, int E) {
  Smem m;
  m.ldsa = ld(S + A);
  m.ld1 = ld(D1);
  m.ld2 = ld(D2);
  m.ldo = ld(2 * A);
  m.ldq = ld(E);
  float* cur = smem;
  float** d1_tiles[4] = {&m.z1, &m.h1, &m.enc, &m.denc};
  float** d2_tiles[4] = {&m.z2, &m.h2, &m.zc, &m.hc};
  m.xin = cur;
  m.dx = cur + TB * m.ldsa;
  cur += 2 * TB * m.ldsa;
  for (int i = 0; i < 4; ++i, cur += TB * m.ld1) *d1_tiles[i] = cur;
  for (int i = 0; i < 4; ++i, cur += TB * m.ld2) *d2_tiles[i] = cur;
  m.out = cur;
  m.q = m.out + TB * m.ldo;
  m.label = m.q + TB * m.ldq;
  m.lp = m.label + TB;
  return m;
}

// xin[i][0:S] <- the block's samples of blk (S, B); xin[i][S:S+A] <- of act
// (A, B) when given.
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

// The actor on xin[:, 0:S]; m.out gets (mean, log_std before the clip) per
// sample.  SAC keeps z2 and h2 = gelu(z2); ModSAC's trunk output is z2, raw.
__device__ void actor_forward(const float* pa, const Smem& m, int S, int A, int D1, int D2,
                              bool modsac) {
  const float* W1 = pa;
  const float* b1 = W1 + D1 * S;
  const float* W2 = b1 + D1;
  const float* b2 = W2 + D2 * D1;
  const float* Wo = b2 + D2;
  fwd<true>(W1, b1, m.xin, m.ldsa, m.z1, m.h1, m.ld1, D1, S);
  __syncthreads();
  if (modsac) {
    fwd<false>(W2, b2, m.h1, m.ld1, nullptr, m.z2, m.ld2, D2, D1);
    __syncthreads();
    const float* ba = Wo + A * D2;
    const float* Ws = ba + A;
    fwd<false>(Wo, ba, m.z2, m.ld2, nullptr, m.out, m.ldo, A, D2);
    fwd<false>(Ws, Ws + A * D2, m.z2, m.ld2, nullptr, m.out + A, m.ldo, A, D2);
  } else {
    fwd<true>(W2, b2, m.h1, m.ld1, m.z2, m.h2, m.ld2, D2, D1);
    __syncthreads();
    fwd<false>(Wo, Wo + 2 * A * D2, m.h2, m.ld2, nullptr, m.out, m.ldo, 2 * A, D2);
  }
  __syncthreads();
}

__device__ __forceinline__ float softplus(float x) {  // logaddexp(x, 0)
  return fmaxf(x, 0.f) + log1pf(expf(-fabsf(x)));
}

// Warp 0, lane e: the tanh-Gaussian draw of sample e from m.out and the
// noise column b of nz (A, B).  Writes the actions to act (stride 1) when
// given; returns the logprob summed over the action axis.
__device__ float sample_action(const Smem& m, int e, const float* __restrict__ nz, int B,
                               int b, int A, bool live, bool modsac, float lo, float hi,
                               float* act) {
  float lp = 0.f;
  for (int a = 0; a < A; ++a) {
    const float mean = m.out[e * m.ldo + a];
    const float ls = fminf(fmaxf(m.out[e * m.ldo + A + a], lo), hi);
    const float std = expf(ls);
    const float z = live ? nz[(size_t)a * B + b] : 0.f;
    const float pre = mean + std * z;
    const float t = tanhf(pre);
    if (modsac)
      lp += -ls - 0.5f * z * z - LOG_SQRT_2PI - 2.0f * (LOG_2 - pre - softplus(-2.0f * pre));
    else
      lp += -logf(std) - LOG_SQRT_2PI - logf(1.000001f - t * t);
    if (act != nullptr) act[a] = live ? t : 0.f;
  }
  return lp;
}

// One critic head (W1 b1 w2 b2 at hp) on m.enc: m.zc, m.hc and q_e in
// column e of m.q.
__device__ void head_forward(const float* hp, const Smem& m, int D1, int D2, int e) {
  const float* w2 = hp + D2 * D1 + D2;
  fwd<true>(hp, hp + D2 * D1, m.enc, m.ld1, m.zc, m.hc, m.ld2, D2, D1);
  __syncthreads();
  fwd<false>(w2, w2 + D2, m.hc, m.ld2, nullptr, m.q + e, m.ldq, 1, D2);
  __syncthreads();
}

// zc[i][j] <- w2[j] * g_i * gelu'(zc[i][j]), g_i = q[i][e] scaled by the
// row's weight: a head's gradient at its hidden pre-activation.
__device__ void head_hidden_grad(const float* hp, const Smem& m, int D1, int D2, int e,
                                 float fixed, bool use_q, int B, int b0) {
  const float* w2 = hp + D2 * D1 + D2;
  for (int idx = threadIdx.x; idx < TB * D2; idx += blockDim.x) {
    const int i = idx / D2, j = idx - i * D2;
    float g = use_q ? m.q[i * m.ldq + e] : (b0 + i < B ? fixed : 0.f);
    float* z = m.zc + i * m.ld2 + j;
    *z = w2[j] * g * gelu_tanh_grad(*z);
  }
  __syncthreads();
}

__global__ void __launch_bounds__(THREADS)
critic_kernel(const float* __restrict__ pa, const float* __restrict__ pc,
              const float* __restrict__ tc, const float* __restrict__ misc,
              const float* __restrict__ sb, const float* __restrict__ nsb,
              const float* __restrict__ ab, const float* __restrict__ rb,
              const float* __restrict__ ud, const float* __restrict__ um,
              const float* __restrict__ nzn, const float* __restrict__ nzp,
              float* __restrict__ partial, float* __restrict__ objpart, int B, int S, int A,
              int D1, int D2, int E, int Pc, int modsac, float gamma, float lo, float hi) {
  extern __shared__ float smem[];
  Smem m = carve(smem, S, A, D1, D2, E);
  const int b0 = blockIdx.x * TB;
  const int e = threadIdx.x;
  const int b = b0 + e;
  const bool live = e < TB && b < B;
  const float inv_B = 1.0f / (float)B;
  const int K = S + A, HF = head_floats(D1, D2);
  const float alpha = expf(misc[0]);

  // ---- label: the actor's draw on nx and the target ensemble's min
  load_x(m.xin, m.ldsa, nsb, nullptr, S, A, B, b0);
  actor_forward(pa, m, S, A, D1, D2, modsac);
  if (e < TB)
    m.lp[e] = sample_action(m, e, nzn, B, b, A, live, modsac, lo, hi, m.xin + e * m.ldsa + S);
  __syncthreads();
  fwd<false>(tc, tc + D1 * K, m.xin, m.ldsa, nullptr, m.enc, m.ld1, D1, K);
  __syncthreads();
  for (int k = 0; k < E; ++k) head_forward(tc + D1 * K + D1 + k * HF, m, D1, D2, k);
  if (e < TB) {
    float nq = m.q[e * m.ldq];
    for (int k = 1; k < E; ++k) nq = fminf(nq, m.q[e * m.ldq + k]);
    m.label[e] = live ? rb[b] + ud[b] * gamma * (nq - m.lp[e] * alpha) : 0.f;
  }
  __syncthreads();

  // ---- alpha's input: the block's sum of logp on x with the policy noise
  load_x(m.xin, m.ldsa, sb, nullptr, S, A, B, b0);
  actor_forward(pa, m, S, A, D1, D2, modsac);
  if (e < TB) {
    const float lp = sample_action(m, e, nzp, B, b, A, live, modsac, lo, hi, nullptr);
    const float s = warp_sum(live ? lp : 0.f);
    if (e == 0) objpart[blockIdx.x * 2 + 1] = s;
  }
  __syncthreads();

  // ---- the TD loss on [x, a], head by head
  load_x(m.xin, m.ldsa, sb, ab, S, A, B, b0);
  fwd<false>(pc, pc + D1 * K, m.xin, m.ldsa, nullptr, m.enc, m.ld1, D1, K);
  __syncthreads();
  float* g = partial + (size_t)blockIdx.x * Pc;
  float td = 0.f;
  for (int k = 0; k < E; ++k) {
    const float* hp = pc + D1 * K + D1 + k * HF;
    float* gh = g + D1 * K + D1 + k * HF;
    head_forward(hp, m, D1, D2, k);
    if (e < TB) {
      float* q = m.q + e * m.ldq + k;
      const float diff = *q - m.label[e];
      td += diff * diff;
      *q = live ? 2.0f * diff * um[b] / (float)E * inv_B : 0.f;  // d loss / d q_k
    }
    __syncthreads();
    wgrad(m.q + k, m.ldq, m.hc, m.ld2, gh + D2 * D1 + D2, gh + D2 * D1 + 2 * D2, 1, D2);
    head_hidden_grad(hp, m, D1, D2, k, 0.f, true, B, b0);
    wgrad(m.zc, m.ld2, m.enc, m.ld1, gh, gh + D2 * D1, D2, D1);
    if (k == 0) bwd_in<1>(hp, m.zc, m.ld2, m.denc, m.ld1, D2, D1);
    else bwd_in<2>(hp, m.zc, m.ld2, m.denc, m.ld1, D2, D1);
    __syncthreads();
  }
  if (e < TB) {
    const float obj = warp_sum(live ? td / (float)E * um[b] : 0.f);
    if (e == 0) objpart[blockIdx.x * 2 + 0] = obj;
  }
  wgrad(m.denc, m.ld1, m.xin, m.ldsa, g, g + D1 * K, D1, K);
}

// One thread: the temperature's step, ModSAC's gate and the actor step's
// row.  step = (bc1_a, bc2_a, valid, do_act, alpha after the step).
__global__ void alpha_kernel(float* __restrict__ misc, const float* __restrict__ objpart,
                             int nb, const float* __restrict__ bcv_row,
                             float* __restrict__ step, float* __restrict__ obj_u, int B,
                             int modsac, float target_entropy, float lr, float clip_grad,
                             float b1, float b2, float eps, float reliable) {
  if (blockIdx.x != 0 || threadIdx.x != 0) return;
  float s = 0.f;
  for (int k = 0; k < nb; ++k) s += objpart[k * 2 + 1];
  const float valid = bcv_row[4], t = bcv_row[5];
  float g = target_entropy - s / (float)B;
  const float gn = sqrtf(g * g);
  g *= gn < clip_grad ? 1.0f : clip_grad / gn;
  const float mu = b1 * misc[1] + (1.0f - b1) * g;
  const float nu = b2 * misc[2] + (1.0f - b2) * g * g;
  const float al = fminf(fmaxf(misc[0] - lr * (mu / bcv_row[2]) / (sqrtf(nu / bcv_row[3]) + eps),
                               -16.0f), 2.0f);
  float do_act = 1.0f, upd = misc[4];
  if (modsac) {
    const float u0 = t == 0.0f ? 0.0f : misc[4];
    do_act = u0 / (t + 1.0f) < reliable ? 1.0f : 0.0f;
    upd = u0 + do_act;
  }
  const float count = misc[3] + 1.0f;
  step[0] = 1.0f - expf(count * logf(b1));
  step[1] = 1.0f - expf(count * logf(b2));
  step[2] = valid;
  step[3] = do_act;
  step[4] = expf(al);
  obj_u[2] = valid * do_act;
  if (valid > 0.f) {
    misc[0] = al;
    misc[1] = mu;
    misc[2] = nu;
    misc[4] = upd;
    if (do_act > 0.f) misc[3] = count;
  }
}

__global__ void __launch_bounds__(THREADS)
actor_kernel(const float* __restrict__ pa, const float* __restrict__ tc,
             const float* __restrict__ step, const float* __restrict__ sb,
             const float* __restrict__ nzp, float* __restrict__ partial,
             float* __restrict__ objpart, int B, int S, int A, int D1, int D2, int E, int Pa,
             int modsac, float lo, float hi) {
  extern __shared__ float smem[];
  Smem m = carve(smem, S, A, D1, D2, E);
  const int b0 = blockIdx.x * TB;
  const int e = threadIdx.x;
  const int b = b0 + e;
  const bool live = e < TB && b < B;
  const float inv_B = 1.0f / (float)B;
  const int K = S + A, HF = head_floats(D1, D2);
  const float alpha = step[4];

  load_x(m.xin, m.ldsa, sb, nullptr, S, A, B, b0);
  actor_forward(pa, m, S, A, D1, D2, modsac);
  if (e < TB)
    m.lp[e] = sample_action(m, e, nzp, B, b, A, live, modsac, lo, hi, m.xin + e * m.ldsa + S);
  __syncthreads();

  // ---- the fresh target ensemble on [x, a], back to its inputs
  fwd<false>(tc, tc + D1 * K, m.xin, m.ldsa, nullptr, m.enc, m.ld1, D1, K);
  __syncthreads();
  for (int k = 0; k < E; ++k) {
    const float* hp = tc + D1 * K + D1 + k * HF;
    head_forward(hp, m, D1, D2, k);
    head_hidden_grad(hp, m, D1, D2, k, -inv_B / (float)E, false, B, b0);
    if (k == 0) bwd_in<1>(hp, m.zc, m.ld2, m.denc, m.ld1, D2, D1);
    else bwd_in<2>(hp, m.zc, m.ld2, m.denc, m.ld1, D2, D1);
    __syncthreads();
  }
  bwd_in<1>(tc, m.denc, m.ld1, m.dx, m.ldsa, D1, K);
  __syncthreads();

  // ---- the objective and the gradient at the actor's outputs
  if (e < TB) {
    float qm = 0.f;
    for (int k = 0; k < E; ++k) qm += m.q[e * m.ldq + k];
    const float obj = warp_sum(live ? qm / (float)E - alpha * m.lp[e] : 0.f);
    if (e == 0) {
      objpart[blockIdx.x * 2 + 0] = 0.f;
      objpart[blockIdx.x * 2 + 1] = obj;
    }
    const float w = live ? alpha * inv_B : 0.f;  // d loss / d logp
    for (int a = 0; a < A; ++a) {
      const float mean = m.out[e * m.ldo + a];
      const float raw = m.out[e * m.ldo + A + a];
      const float std = expf(fminf(fmaxf(raw, lo), hi));
      const float z = live ? nzp[(size_t)a * B + b] : 0.f;
      const float pre = mean + std * z;
      const float t = tanhf(pre);
      const float dlp = modsac ? 2.0f - 4.0f / (1.0f + expf(2.0f * pre))   // 4 sigmoid(-2 pre)
                               : 2.0f * t * (1.0f - t * t) / (1.000001f - t * t);
      const float ga = live ? m.dx[e * m.ldsa + S + a] : 0.f;
      const float G = ga * (1.0f - t * t) + w * dlp;
      m.out[e * m.ldo + a] = G;
      m.out[e * m.ldo + A + a] = (raw >= lo && raw <= hi) ? G * std * z - w : 0.f;
    }
  }
  __syncthreads();

  // ---- the actor's backward into the block's partial gradients
  float* g = partial + (size_t)blockIdx.x * Pa;
  if (!modsac) {
    Tiles t;
    t.xn = m.xin;
    t.z1 = m.z1;
    t.h1 = m.h1;
    t.z2 = m.z2;
    t.h2 = m.h2;
    t.head = m.out;
    t.lds = m.ldsa;
    t.ld1 = m.ld1;
    t.ld2 = m.ld2;
    t.ldh = m.ldo;
    net_backward(pa, g, t, S, D1, D2, 2 * A);
    return;
  }
  const float* W2 = pa + D1 * S + D1;
  const float* Wa = W2 + D2 * D1 + D2;
  const float* Ws = Wa + A * D2 + A;
  float* gW2 = g + D1 * S + D1;
  float* gWa = gW2 + D2 * D1 + D2;
  float* gWs = gWa + A * D2 + A;
  wgrad(m.out, m.ldo, m.z2, m.ld2, gWa, gWa + A * D2, A, D2);
  wgrad(m.out + A, m.ldo, m.z2, m.ld2, gWs, gWs + A * D2, A, D2);
  __syncthreads();
  bwd_in<1>(Wa, m.out, m.ldo, m.z2, m.ld2, A, D2);      // z2 <- d z2 (the trunk is raw)
  bwd_in<2>(Ws, m.out + A, m.ldo, m.z2, m.ld2, A, D2);
  __syncthreads();
  wgrad(m.z2, m.ld2, m.h1, m.ld1, gW2, gW2 + D2 * D1, D2, D1);
  bwd_data(W2, m.z2, m.ld2, m.z1, m.ld1, D2, D1);       // z1 <- d z1
  __syncthreads();
  wgrad(m.z1, m.ld1, m.xin, m.ldsa, g, g + D1 * S, D1, S);
}

}  // namespace

// Dynamic shared memory of one fwd_bwd block, in bytes (the layout of carve).
extern "C" int sac_update_smem_bytes(int S, int A, int D1, int D2, int E) {
  return (int)sizeof(float) * TB *
         (2 * ld(S + A) + 4 * ld(D1) + 4 * ld(D2) + ld(2 * A) + ld(E) + 2);
}

// Scratch sizes: partial gradients (nb, max(Pa, Pc)), objective partials
// (nb, 2), gradient (max(Pa, Pc)), norm partials (nr), and the step row (8).
extern "C" int sac_update_blocks(int B) { return (B + TB - 1) / TB; }
extern "C" int sac_update_reduce_blocks(int P) { return reduce_blocks(P); }

// bcv: (C, 7) float rows (bc1_c, bc2_c, bc1_alpha, bc2_alpha, valid,
// update_t, 0).  misc: (5,) (alpha_log, alpha_mu, alpha_nu, act_count,
// update_a).  Blocks: sb, nsb (C, S, B), ab, nzn, nzp (C, A, B), rb, ud, um
// (C, B).  ta is null for SAC.  objs: (C, 3), the critic loss, the actor
// objective and valid * do_act.
extern "C" int sac_update(void* pa, void* pc, void* ta, void* tc, void* mua, void* muc,
                          void* nua, void* nuc, void* misc, const void* sb, const void* nsb,
                          const void* ab, const void* rb, const void* ud, const void* um,
                          const void* nzn, const void* nzp, const void* bcv, void* partial,
                          void* objpart, void* grad, void* normpart, void* step, void* objs,
                          int C, int B, int S, int A, int D1, int D2, int E, int modsac,
                          float gamma, float tau, float lr, float clip_grad, float b1,
                          float b2, float eps, float target_entropy, float std_lo,
                          float std_hi, float reliable, void* stream) {
  const int smem = sac_update_smem_bytes(S, A, D1, D2, E);
  cudaError_t err = cudaFuncSetAttribute(
      critic_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(actor_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return (int)err;
  const int Pa = act_floats(S, A, D1, D2), Pc = cri_floats(S, A, D1, D2, E);
  const int nb = sac_update_blocks(B);
  const int nra = sac_update_reduce_blocks(Pa), nrc = sac_update_reduce_blocks(Pc);
  cudaStream_t st = (cudaStream_t)stream;
  const float* f_pa = (const float*)pa;
  for (int u = 0; u < C; ++u) {
    const size_t o = (size_t)u * B;
    const float* row = (const float*)bcv + (size_t)u * 7;
    float* obj_u = (float*)objs + (size_t)u * 3;
    critic_kernel<<<nb, THREADS, smem, st>>>(
        f_pa, (const float*)pc, (const float*)tc, (const float*)misc,
        (const float*)sb + o * S, (const float*)nsb + o * S, (const float*)ab + o * A,
        (const float*)rb + o, (const float*)ud + o, (const float*)um + o,
        (const float*)nzn + o * A, (const float*)nzp + o * A, (float*)partial,
        (float*)objpart, B, S, A, D1, D2, E, Pc, modsac, gamma, std_lo, std_hi);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    reduce_one_kernel<<<nrc, THREADS, 0, st>>>((const float*)partial, nb, Pc, (float*)grad,
                                               (float*)normpart);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    clip_adam_polyak_kernel<<<nrc, THREADS, 0, st>>>(
        (float*)pc, (float*)muc, (float*)nuc, (float*)tc, (const float*)grad,
        (const float*)normpart, nrc, Pc, row, 0, 1, 4, -1, (const float*)objpart, nb, obj_u,
        0, 1, B, lr, clip_grad, b1, b2, eps, tau);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    alpha_kernel<<<1, 32, 0, st>>>((float*)misc, (const float*)objpart, nb, row,
                                   (float*)step, obj_u, B, modsac, target_entropy, lr,
                                   clip_grad, b1, b2, eps, reliable);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    actor_kernel<<<nb, THREADS, smem, st>>>(
        f_pa, (const float*)tc, (const float*)step, (const float*)sb + o * S,
        (const float*)nzp + o * A, (float*)partial, (float*)objpart, B, S, A, D1, D2, E, Pa,
        modsac, std_lo, std_hi);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    reduce_one_kernel<<<nra, THREADS, 0, st>>>((const float*)partial, nb, Pa, (float*)grad,
                                               (float*)normpart);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    clip_adam_polyak_kernel<<<nra, THREADS, 0, st>>>(
        (float*)pa, (float*)mua, (float*)nua, (float*)ta, (const float*)grad,
        (const float*)normpart, nra, Pa, (const float*)step, 0, 1, 2, 3,
        (const float*)objpart, nb, obj_u, 1, 1, B, lr, clip_grad, b1, b2, eps, tau);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  return (int)cudaGetLastError();
}
