// Fused DQN-family update chunk: C sequential minibatch updates of the TD
// loss against the Polyak-averaged target net, each followed by optax's
// clip-by-global-norm + Adam over the whole Q-net and the Polyak step, in
// place on flat parameter, target and moment buffers, for the four nets
// (plain DQN; twin = DoubleDQN; duel = DuelingDQN; twin + duel = D3QN).
//
// Replaces: elegantrl_tpu/ops/pallas_update.py, make_dqn_fused_chunk
// (kernel at :476, pallas_call at :560).
//
// Bound on this card: operations by the roofline (4 forward-equivalents an
// update: about 17.6 MFLOP at B = 128 and (128, 128), 0.26 us of the card's
// FP32 rate; 0.5 MB of p, t, mu, nu, 0.15 us), grid barriers and latency in
// practice.
//
// Design: one cooperative launch per chunk, one persistent block per SM,
// every phase of every update spread over all blocks with a grid barrier
// (grid_gemm.cuh) between phases.  On the TPU one kernel kept p, t, mu, nu
// and the minibatch block resident in VMEM for all C steps; here they stay
// in the 50 MB L2 across the chunk (about 1.1 MB at (256, 256)), with the
// activations of the update in a workspace beside them.  Per update, seven
// phases:
//   1. layer 1 of the target net on nx and of the online net on x;
//   2. layer 2 of both;
//   3. per sample (one warp each): every head's outputs of both nets, the
//      TD label from the target's, the loss, the objectives and the
//      gradient at the online heads' outputs;
//   4. the heads' weight gradients, and the gradient at layer 2's output
//      (through GELU for plain DQN);
//   5. layer 2's weight gradient, and the gradient at layer 1's output;
//   6. layer 1's weight gradient; each block's share of the squared norm;
//   7. clip + Adam + Polyak, elementwise over P, with the step's bias
//      corrections from the (C, 3) table, skipped entirely when the step's
//      valid flag is 0 (every buffer then stays bit-identical); block 0
//      writes the step's objectives.
// Products are 32 x 32 output tiles over all blocks (samples x features
// forward and for the data gradients, out x in for the weight gradients),
// each tile summing its whole depth, all B samples for a weight gradient,
// inside one block: no partial gradients are written and read back, and
// with the norm's per-block partials summed in block order, two runs are
// bitwise equal.  Shared memory is one pair of operand tiles and 64 head
// rows a warp (the workspace holds wider head tables), whatever D1, D2 or
// B.  With a trace buffer, block 0 stamps %globaltimer as it passes each
// phase's barrier, eight stamps an update, to show what sets the time.
//
// The nets are a trunk and heads.  Plain DQN: the trunk is two GELU layers
// and the one head is the output layer (A).  The other nets: the trunk is
// the encoder, GELU after layer 1 only, and the heads are val1 (A), adv1 (1)
// when duel, val2 (A) and adv2 (1) when twin, in the flat buffer's leaf
// order, stacked as the rows of one head table.  Per sample: q = val -
// mean(val) + adv for the twin dueling net (D3QN); the dueling net without a
// twin reads its value head alone on the TD path, as the reference's
// QNetDuel.get_q_value, so its adv1 head gets a zero gradient; the label is
// r + ud gamma max_a of the target's q (twin: of the min of both heads).
// With q_a = sum(q * onehot) and d = 2 (q_a - label) um / B, the gradient
// into head values is onehot * d, through the dueling combine g - mean(g)
// into val and sum(g) into adv.  No gradient passes through the target net:
// the label is a constant.

#include <cuda_runtime.h>
#include <stdint.h>

#include "grid_gemm.cuh"

namespace {

using gg::dgrad_job;
using gg::fwd_job;
using gg::Job;
using gg::mat;
using gg::wgrad_job;

struct Heads {
  int n;          // number of heads
  int width[4];   // outputs of each head
  int col[4];     // first row of each head in the head table
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

__host__ __device__ inline int head_rows(const Heads& h) {
  return h.col[h.n - 1] + h.width[h.n - 1];
}

struct Args {
  float *p, *t, *mu, *nu;
  const float *sb, *nsb, *oh, *rb, *ud, *um, *bcv;
  float* objs;
  // workspace: activations of one update, then the gradient and partials
  float *h1t, *h2t, *z1, *h1, *z2, *h2, *qt, *qo, *g, *grad, *normpart, *objpart;
  unsigned int* bar;
  unsigned long long* trace;  // (C, 8) stamps, or null
  int C, B, S, A, D1, D2, twin, duel, P;
  float gamma, tau, lr, clip_grad, b1, b2, eps;
};

// The TD-path q of head pair `pair` (head 0, and head 1 when twin) for
// action a of one sample's head row; means are precomputed.
__device__ __forceinline__ float q_td(const float* row, const Heads& hd, int pair, int a,
                                      bool combine, float mean) {
  const int k = combine ? 2 * pair : pair;  // value head of the pair
  const float v = row[hd.col[k] + a];
  return combine ? v - mean + row[hd.col[k + 1]] : v;
}

constexpr int ROW_CAP = 64;  // head-table rows a warp keeps in shared memory

// Phase 3: the heads of both nets, the label and the loss, one warp per
// sample.  The sample's head rows live in the warp's shared-memory slots
// (in the workspace when the table has more than ROW_CAP rows).
__device__ void heads_phase(const Args& a, const Heads& hd, const gg::HeadMap& hm, int u,
                            gg::Smem& sm, float (*rows)[2][ROW_CAP]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = gridDim.x * (gg::THREADS / 32);
  const int B = a.B, A = a.A, D2 = a.D2, nc = head_rows(hd);
  const bool twin = a.twin != 0, duel = a.duel != 0, combine = twin && duel;
  const float* oh = a.oh + (size_t)u * A * B;
  const float* rb = a.rb + (size_t)u * B;
  const float* ud = a.ud + (size_t)u * B;
  const float* um = a.um + (size_t)u * B;
  float td_sum = 0.f, q_sum = 0.f;
  for (int b = blockIdx.x * (gg::THREADS / 32) + warp; b < B; b += nw) {
    const float* ht = a.h2t + (size_t)b * D2;
    const float* ho = a.h2 + (size_t)b * D2;
    float* rowt = nc <= ROW_CAP ? rows[warp][0] : a.qt + (size_t)b * nc;
    float* row = nc <= ROW_CAP ? rows[warp][1] : a.qo + (size_t)b * nc;
    for (int r = 0; r < nc; ++r) {
      const int k = gg::head_of(hm, r), j = r - hm.col[k];
      const long long wo = hm.off[k] + (long long)j * D2;
      float st = 0.f, so = 0.f;
#pragma unroll 4
      for (int i = lane; i < D2; i += 32) {
        st = fmaf(__ldcg(a.t + wo + i), __ldcg(ht + i), st);
        so = fmaf(__ldcg(a.p + wo + i), __ldcg(ho + i), so);
      }
      st = mlp::warp_sum(st);
      so = mlp::warp_sum(so);
      if (lane == 0) {
        const long long bo = hm.off[k] + (long long)hm.width[k] * D2 + j;
        rowt[r] = st + __ldcg(a.t + bo);
        row[r] = so + __ldcg(a.p + bo);
      }
    }
    if (lane != 0) continue;
    // ---- the TD label from the target's heads
    float m1 = 0.f, m2 = 0.f;
    if (combine) {
      for (int c = 0; c < A; ++c) {
        m1 += rowt[hd.col[0] + c];
        m2 += rowt[hd.col[2] + c];
      }
      m1 /= (float)A;
      m2 /= (float)A;
    }
    float best = 0.f;
    for (int c = 0; c < A; ++c) {
      float q = q_td(rowt, hd, 0, c, combine, m1);
      if (twin) q = fminf(q, q_td(rowt, hd, 1, c, combine, m2));
      best = c == 0 ? q : fmaxf(best, q);
    }
    const float label = __ldg(rb + b) + __ldg(ud + b) * a.gamma * best;
    // ---- the online heads: loss, objectives, gradient at the head values
    float m[2] = {0.f, 0.f};
    if (combine) {
      for (int c = 0; c < A; ++c) {
        m[0] += row[hd.col[0] + c];
        m[1] += row[hd.col[2] + c];
      }
      m[0] /= (float)A;
      m[1] /= (float)A;
    }
    const int pairs = twin ? 2 : 1;
    float qa[2] = {0.f, 0.f};
#pragma unroll
    for (int pr = 0; pr < 2; ++pr)
      if (pr < pairs)
        for (int c = 0; c < A; ++c)
          qa[pr] += q_td(row, hd, pr, c, combine, m[pr]) * __ldg(oh + (size_t)c * B + b);
    const float w = __ldg(um + b);
    float td = 0.f;
    float d[2] = {0.f, 0.f};
#pragma unroll
    for (int pr = 0; pr < 2; ++pr) {
      if (pr >= pairs) continue;
      const float diff = qa[pr] - label;
      td += diff * diff * w;
      d[pr] = 2.0f * diff * w / (float)B;
    }
    float* grow = a.g + (size_t)b * nc;
#pragma unroll
    for (int pr = 0; pr < 2; ++pr) {
      if (pr >= pairs) continue;
      const int k = combine ? 2 * pr : pr;
      float gsum = 0.f;
      for (int c = 0; c < A; ++c) gsum += __ldg(oh + (size_t)c * B + b) * d[pr];
      for (int c = 0; c < A; ++c) {
        const float gv = __ldg(oh + (size_t)c * B + b) * d[pr];
        grow[hd.col[k] + c] = combine ? gv - gsum / (float)A : gv;
      }
      if (combine) grow[hd.col[k + 1]] = gsum;
    }
    if (duel && !twin) grow[hd.col[1]] = 0.f;  // the TD path does not read adv1
    td_sum += td;
    q_sum += qa[0];
  }
  const float2 s = gg::block_sum2(td_sum, q_sum, sm);
  if (threadIdx.x == 0) {
    a.objpart[blockIdx.x * 2 + 0] = s.x;
    a.objpart[blockIdx.x * 2 + 1] = s.y;
  }
}

// Phase 7: the objectives, then clip + Adam + Polyak unless the step is
// invalid.  The per-block partials are summed by every block in one fixed
// order, so every block scales by the same norm.
__device__ void adam_phase(const Args& a, int u, gg::Smem& sm) {
  const float* bcv = a.bcv + (size_t)u * 3;
  if (blockIdx.x == 0) {
    float o0 = 0.f, o1 = 0.f;
    for (int k = threadIdx.x; k < (int)gridDim.x; k += blockDim.x) {
      o0 += __ldcg(a.objpart + 2 * k);
      o1 += __ldcg(a.objpart + 2 * k + 1);
    }
    const float2 o = gg::block_sum2(o0, o1, sm);
    if (threadIdx.x == 0) {
      a.objs[(size_t)u * 2] = o.x / (float)a.B;
      a.objs[(size_t)u * 2 + 1] = o.y / (float)a.B;
    }
  }
  if (!(__ldg(bcv + 2) > 0.f)) return;
  float n = 0.f;
  for (int k = threadIdx.x; k < (int)gridDim.x; k += blockDim.x) n += __ldcg(a.normpart + k);
  const float gn = sqrtf(gg::block_sum2(n, 0.f, sm).x);
  const float scale = gn < a.clip_grad ? 1.0f : a.clip_grad / gn;
  const float bc1 = __ldg(bcv), bc2 = __ldg(bcv + 1);
  const float b1 = a.b1, b2 = a.b2;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < a.P; i += gridDim.x * blockDim.x) {
    const float g = __ldcg(a.grad + i) * scale;
    const float m = b1 * __ldcg(a.mu + i) + (1.0f - b1) * g;
    const float v = b2 * __ldcg(a.nu + i) + (1.0f - b2) * g * g;
    a.mu[i] = m;
    a.nu[i] = v;
    const float pn = __ldcg(a.p + i) - a.lr * (m / bc1) / (sqrtf(v / bc2) + a.eps);
    a.p[i] = pn;
    a.t[i] = __ldcg(a.t + i) * (1.0f - a.tau) + pn * a.tau;
  }
}

__device__ __forceinline__ void stamp(const Args& a, int u, int k) {
  if (a.trace != nullptr && blockIdx.x == 0 && threadIdx.x == 0) {
    unsigned long long ns;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(ns));
    a.trace[u * 8 + k] = ns;
  }
}

__global__ void __launch_bounds__(gg::THREADS, 1) dqn_chunk_kernel(const Args a) {
  __shared__ gg::Smem sm;
  __shared__ float rows[gg::THREADS / 32][2][ROW_CAP];
  __shared__ Heads hd;       // indexed by computed heads: kept out of local memory
  __shared__ gg::HeadMap hm;
  const int B = a.B, S = a.S, D1 = a.D1, D2 = a.D2;
  if (threadIdx.x == 0) {
    hd = make_heads(S, a.A, D1, D2, a.twin, a.duel);
    hm.n = hd.n;
    hm.d = D2;
    for (int k = 0; k < 4; ++k) {
      hm.col[k] = hd.col[k];
      hm.width[k] = hd.width[k];
      hm.off[k] = hd.off[k];
    }
  }
  __syncthreads();
  const int nc = head_rows(hd);
  const bool enc = a.twin || a.duel;
  const long long oW2 = (long long)D1 * S + D1;  // layer 2's W in the flat buffer
  for (int u = 0; u < a.C; ++u) {
    const float* x = a.sb + (size_t)u * S * B;
    const float* nx = a.nsb + (size_t)u * S * B;
    float sq = 0.f;  // this thread's share of the squared gradient norm
    stamp(a, u, 0);
    // ---- 1. layer 1 of the target on nx and the online net on x
    gg::run_list<false>([&](int j) -> Job {
      return j == 0 ? fwd_job(mat(nx, 1, B, B, S), a.t, D1, S, B, a.h1t, nullptr, 1, D1)
                    : fwd_job(mat(x, 1, B, B, S), a.p, D1, S, B, a.h1, a.z1, 1, D1);
    }, 2, sm, &hm, &sq);
    gg::grid_sync(a.bar);
    stamp(a, u, 1);
    // ---- 2. layer 2 of both
    gg::run_list<false>([&](int j) -> Job {
      return j == 0
                 ? fwd_job(mat(a.h1t, D1, 1, B, D1), a.t + oW2, D2, D1, B, a.h2t, nullptr, !enc, D2)
                 : fwd_job(mat(a.h1, D1, 1, B, D1), a.p + oW2, D2, D1, B, a.h2, a.z2, !enc, D2);
    }, 2, sm, &hm, &sq);
    gg::grid_sync(a.bar);
    stamp(a, u, 2);
    // ---- 3. heads, label, loss, the gradient at the heads (g, (B, nc))
    heads_phase(a, hd, hm, u, sm, rows);
    gg::grid_sync(a.bar);
    stamp(a, u, 3);
    // ---- 4. the heads' weight gradients (each head row at its head); the
    // gradient at layer 2's output
    gg::run_list<false>([&](int j) -> Job {
      if (j == 1)
        return dgrad_job(a.g, nc, nc, mat(a.p, 0, 1, nc, D2, -1, 1), D2, B, a.z2, D2, !enc);
      Job w = wgrad_job(a.g, nc, nc, mat(a.h2, D2, 1, B, D2 + 1, D2), D2, B, a.grad, 0, 0, 0);
      w.e.heads = 1;
      return w;
    }, 2, sm, &hm, &sq);
    gg::grid_sync(a.bar);
    stamp(a, u, 4);
    // ---- 5. layer 2's weight gradient; the gradient at layer 1's output
    gg::run_list<false>([&](int j) -> Job {
      return j == 0 ? wgrad_job(a.z2, D2, D2, mat(a.h1, D1, 1, B, D1 + 1, D1), D1, B, a.grad,
                                oW2, 0, 0)
                    : dgrad_job(a.z2, D2, D2, mat(a.p + oW2, D1, 1, D2, D1), D1, B, a.z1, D1, 1);
    }, 2, sm, &hm, &sq);
    gg::grid_sync(a.bar);
    stamp(a, u, 5);
    // ---- 6. layer 1's weight gradient, then this block's norm partial
    gg::run_list<false>([&](int) -> Job {
      return wgrad_job(a.z1, D1, D1, mat(x, 1, B, B, S + 1, S), S, B, a.grad, 0, 0, 0);
    }, 1, sm, &hm, &sq);
    {
      const float s = gg::block_sum2(sq, 0.f, sm).x;
      if (threadIdx.x == 0) a.normpart[blockIdx.x] = s;
    }
    gg::grid_sync(a.bar);
    stamp(a, u, 6);
    // ---- 7. clip + Adam + Polyak
    adam_phase(a, u, sm);
    if (u + 1 < a.C) gg::grid_sync(a.bar);
    stamp(a, u, 7);
  }
}

}  // namespace

// Shared memory of one block's operand tiles, reduction slots and warps'
// head rows, in bytes (the two head tables add 136), whatever the widths or
// the batch.
extern "C" int dqn_update_smem_bytes() {
  return (int)(sizeof(gg::Smem) + sizeof(float) * (gg::THREADS / 32) * 2 * ROW_CAP);
}

// Blocks of the cooperative launch: one per SM.  Negative (minus the CUDA
// error) when the card cannot launch cooperatively or cannot hold a block
// on every SM.
extern "C" int dqn_update_grid() { return gg::coop_grid(dqn_chunk_kernel); }

// Phases an update (the trace holds 8 stamps an update).
extern "C" int dqn_update_phases() { return 7; }

// Floats of the workspace for a launch of `grid` blocks.
extern "C" long long dqn_update_workspace_floats(int B, int S, int A, int D1, int D2, int twin,
                                                 int duel, int grid) {
  const Heads hd = make_heads(S, A, D1, D2, twin, duel);
  const long long P = hd.off[hd.n - 1] + (long long)hd.width[hd.n - 1] * (D2 + 1);
  const long long nc = head_rows(hd);
  return 3LL * gg::round4((long long)B * D1) + 3LL * gg::round4((long long)B * D2) +
         3LL * gg::round4((long long)B * nc) + gg::round4(P) + gg::round4(grid) +
         gg::round4(2LL * grid) + 4;
}

// bcv: (C, 3) float rows (1 - b1^step, 1 - b2^step, valid).  Blocks: sb,
// nsb (C, S, B), oh (C, A, B), rb, ud, um (C, B).  objs: (C, 2).  ws: the
// workspace, dqn_update_workspace_floats(...) floats; grid from
// dqn_update_grid(); trace null or (C, 8) uint64 phase stamps.  One
// cooperative launch; returns its CUDA status.
extern "C" int dqn_update(void* p, void* t, void* mu, void* nu, const void* sb,
                          const void* nsb, const void* oh, const void* rb, const void* ud,
                          const void* um, const void* bcv, void* ws, void* objs, void* trace,
                          int grid,
                          int C, int B, int S, int A, int D1, int D2, int twin, int duel,
                          float gamma, float tau, float lr, float clip_grad, float b1, float b2,
                          float eps, void* stream) {
  if (grid < 1 || C < 1 || B < 1) return (int)cudaErrorInvalidValue;
  const Heads hd = make_heads(S, A, D1, D2, twin, duel);
  Args a;
  a.p = (float*)p;
  a.t = (float*)t;
  a.mu = (float*)mu;
  a.nu = (float*)nu;
  a.sb = (const float*)sb;
  a.nsb = (const float*)nsb;
  a.oh = (const float*)oh;
  a.rb = (const float*)rb;
  a.ud = (const float*)ud;
  a.um = (const float*)um;
  a.bcv = (const float*)bcv;
  a.objs = (float*)objs;
  const long long nc = head_rows(hd);
  float* w = (float*)ws;
  a.h1t = w; w += gg::round4((long long)B * D1);
  a.z1 = w; w += gg::round4((long long)B * D1);
  a.h1 = w; w += gg::round4((long long)B * D1);
  a.h2t = w; w += gg::round4((long long)B * D2);
  a.z2 = w; w += gg::round4((long long)B * D2);
  a.h2 = w; w += gg::round4((long long)B * D2);
  a.qt = w; w += gg::round4((long long)B * nc);
  a.qo = w; w += gg::round4((long long)B * nc);
  a.g = w; w += gg::round4((long long)B * nc);
  a.P = hd.off[hd.n - 1] + hd.width[hd.n - 1] * (D2 + 1);
  a.grad = w; w += gg::round4(a.P);
  a.normpart = w; w += gg::round4(grid);
  a.objpart = w; w += gg::round4(2LL * grid);
  a.bar = (unsigned int*)w;
  a.trace = (unsigned long long*)trace;
  a.C = C;
  a.B = B;
  a.S = S;
  a.A = A;
  a.D1 = D1;
  a.D2 = D2;
  a.twin = twin;
  a.duel = duel;
  a.gamma = gamma;
  a.tau = tau;
  a.lr = lr;
  a.clip_grad = clip_grad;
  a.b1 = b1;
  a.b2 = b2;
  a.eps = eps;
  return gg::coop_launch(dqn_chunk_kernel, a, a.bar, grid, (cudaStream_t)stream);
}
