// Fused whole-rollout kernel: actor + critic MLPs, the Gaussian or the
// categorical head and an inlined env step, for every env lane and all H
// steps in one launch.  One instantiation per env body: Pendulum-v1,
// CartPole-v1, HopperSlip-v0 and PointChasing (continuous and discrete);
// StockTradingEnv-v2's actor runs in stock_actor_kernel (K4, below), its
// critic in critic_values_kernel.
// Below it, offpolicy_rollout_kernel: the same design for the off-policy
// agents' exploration (one net, the ddpg, sac and DQN heads; the stock
// body's heads run in stock_actor_kernel<HEAD>).
//
// Replaces: elegantrl_tpu/ops/pallas_rollout.py, _make_kernel (built by
// make_fused_rollout with PENDULUM_BODY, CARTPOLE_BODY, HOPPER_BODY,
// CHASING_BODY, CHASING_DISCRETE_BODY or make_stock_body's body, and either
// head).
//
// Bound on this card: operations.  Each env-step runs both MLPs,
// 2 x 2 x (S*D1 + D1*D2 + D2) FLOP plus the head (67,584 at S=3,
// D1=D2=128); the outputs are S + 6 or S + A + 5 floats per env-step.  At
// 4096 envs x 64 steps that is about 18 GFLOP against about 10 MB written,
// far on the compute side of the roofline, and the FLOP run on the FP32
// CUDA cores (the critic pass runs on the tensor cores).
//
// Design:
// - A group of TE = 32 env lanes loops over all H steps itself.  On the TPU
//   the grid's time-chunk axis and a VMEM scratch carry existed because the
//   outputs had to fit in VMEM; here the outputs stream to device memory as
//   they are made, so no state carries between groups.
// - In fused_rollout_kernel (below) a group runs on a thread-block
//   cluster of c blocks, each holding a slice of every layer of both nets
//   in shared memory (cluster_mlp.cuh), so widths up to what a cluster of 8
//   holds fit and two or more blocks can share an SM; products are tiles of
//   4 x 4 outputs a thread (cm::tile_dense); the off-policy kernel below
//   takes the same design.
// - The env body and the head are template parameters: a body is a struct
//   with its dimensions and obs/step/reset functions over a register array
//   of its F float rows and one step counter, so each instantiation keeps
//   its env state in registers of the env's thread; the env step runs on
//   warp 0 (one thread per env).
// - Noise: either injected, a (H, A + N_STEP + N_RESET, N) tensor (Gaussian
//   head: A normals, then the env's uniforms; categorical head: all
//   uniforms), or drawn in-kernel with Philox4x32-10, key = seed: uniform j
//   of a (lane, step) is word j % 4 of the block with counter
//   (lane, step, j / 4, 0).  Uniforms keep the top 24 bits, u in [0, 1), and
//   Box-Muller takes log(1 - u), so log(0) never occurs.
// - Categorical head: Gumbel-max, g = -log(-log(max(u, 1e-12)) + 1e-12), the
//   first maximum wins a tie, logp = logits[a] - logsumexp(logits); the
//   action index is stored as int32 and handed to the env as a float.
// - GELU is the tanh form, matching jax.nn.gelu's default.

#include <cuda_runtime.h>
#include <stdint.h>

#include "cluster_mlp.cuh"

// The stock body's tables and constants (ops/fused_rollout.py:_StockArgs),
// passed by the host to stock_rollout and offpolicy_stock_rollout.
struct StockArgs {
  const float* close;  // (T, NS)
  const float* tech;   // (T, 8 NS)
  int T;
  float initial_amount, max_stock, buy_cost, sell_cost, one_minus_gamma;
  int random_reset;
};

namespace {

constexpr int TE = 32;        // env lanes per group
constexpr int STREAM_LANES = 16;  // env lanes per group of the streamed K1 (G below)

// The template parameter ST of the rollout kernels: 0 the resident design,
// 1 the streamed one at its widest lane group, and each step past 1 halves
// the group (the narrower streamed groups, which hold less of h1 and h2 in
// shared memory: same products, same order, smaller tiles and more of them).
// A group keeps at least 4 lanes: cm::tile_dense works on 4 x 4 register
// tiles over float4 rows, so a tile row of fewer lanes takes as much shared
// memory as one of 4.
__host__ __device__ constexpr int narrow_lanes(int lanes, int st) {
  return st > 1 ? lanes >> (st - 1) : lanes;
}
// K1/K3's lanes a group: TE resident, STREAM_LANES (16), 8, 4 streamed
__host__ __device__ constexpr int rollout_lanes(int st) {
  return st ? narrow_lanes(STREAM_LANES, st) : TE;
}

// The streamed designs (ST) read layer 2's weights from device memory (L2)
// instead of holding their slices in shared memory: each net's W2 zero-padded
// to (round32(D2), round32(D1)) rows and columns, in the compute type, one net
// after the other (ops/fused_rollout.py:stream_weights), so the rows and inputs
// of every cluster size's slice lie inside it.
__host__ __device__ constexpr int round32(int n) { return (n + 31) / 32 * 32; }
constexpr float PI_F = 3.14159265358979323846f;
constexpr float TWO_PI_F = 6.28318530717958647692f;
constexpr float LOG_SQRT_2PI = 0.91893853320467274178f;

__device__ __forceinline__ float gelu_tanh(float x) {
  const float k = 0.79788456080286535588f;  // sqrt(2/pi)
  return 0.5f * x * (1.0f + tanhf(k * (x + 0.044715f * x * x * x)));
}

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint2 k) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    const uint32_t hi0 = __umulhi(0xD2511F53u, c.x), lo0 = 0xD2511F53u * c.x;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c.z), lo1 = 0xCD9E8D57u * c.z;
    c = make_uint4(hi1 ^ c.y ^ k.x, lo1, hi0 ^ c.w ^ k.y, lo0);
    k.x += 0x9E3779B9u;
    k.y += 0xBB67AE85u;
  }
  return c;
}

__device__ __forceinline__ float uniform24(uint32_t bits) {
  return (float)(bits >> 8) * 5.9604644775390625e-08f;  // 2^-24
}

__device__ __forceinline__ float clampf(float x, float lo, float hi) {
  return fminf(fmaxf(x, lo), hi);
}

// ------------------------------------------------------------- env bodies
// f holds the body's F float rows of one env, tc its step counter.  step
// does not reset; reset re-initialises from N_RESET uniforms.  `a` is the
// env's action: A values for a continuous body (already through tanh), the
// action index as one float for a discrete one.

struct PendulumBody {
  static constexpr int S = 3, A = 1, F = 2, N_STEP = 0, N_RESET = 2;
  static constexpr bool DISCRETE = false;
  __device__ static void obs(const float* f, float* x) {
    x[0] = cosf(f[0]);
    x[1] = sinf(f[0]);
    x[2] = f[1];
  }
  __device__ static void step(float* f, int& tc, const float* a, const float*,
                              float& reward, bool& terminal, bool& trunc) {
    const float th = f[0], thdot = f[1];
    const float u_trq = clampf(a[0] * 2.0f, -2.0f, 2.0f);
    const float y = th + PI_F;  // floor-form angle wrap
    const float wrapped = y - floorf(y / TWO_PI_F) * TWO_PI_F - PI_F;
    const float cost = wrapped * wrapped + 0.1f * thdot * thdot + 0.001f * u_trq * u_trq;
    reward = -0.5f * cost;
    const float thdot2 =
        clampf(thdot + (15.0f * sinf(th) + 3.0f * u_trq) * 0.05f, -8.0f, 8.0f);
    f[0] = th + thdot2 * 0.05f;
    f[1] = thdot2;
    tc += 1;
    terminal = false;
    trunc = tc >= 200;
  }
  __device__ static void reset(float* f, const float* u) {
    f[0] = -PI_F + TWO_PI_F * u[0];
    f[1] = -1.0f + 2.0f * u[1];
  }
};

struct CartPoleBody {
  static constexpr int S = 4, A = 2, F = 4, N_STEP = 0, N_RESET = 4;
  static constexpr bool DISCRETE = true;
  __device__ static void obs(const float* f, float* x) {
#pragma unroll
    for (int k = 0; k < 4; ++k) x[k] = f[k];
  }
  __device__ static void step(float* f, int& tc, const float* a, const float*,
                              float& reward, bool& terminal, bool& trunc) {
    const float x = f[0], x_dot = f[1], theta = f[2], theta_dot = f[3];
    const float force = a[0] > 0.5f ? 10.0f : -10.0f;
    const float cos_t = cosf(theta), sin_t = sinf(theta);
    const float temp = (force + 0.05f * (theta_dot * theta_dot) * sin_t) / 1.1f;
    const float theta_acc =
        (9.8f * sin_t - cos_t * temp) /
        (0.5f * (4.0f / 3.0f - 0.1f * (cos_t * cos_t) / 1.1f));
    const float x_acc = temp - 0.05f * theta_acc * cos_t / 1.1f;
    f[0] = x + 0.02f * x_dot;
    f[1] = x_dot + 0.02f * x_acc;
    f[2] = theta + 0.02f * theta_dot;
    f[3] = theta_dot + 0.02f * theta_acc;
    tc += 1;
    const float theta_limit = 0.20943951023931953f;  // 12 degrees
    terminal = fabsf(f[0]) > 2.4f || fabsf(f[2]) > theta_limit;
    trunc = tc >= 500 && !terminal;
    reward = 1.0f;
  }
  __device__ static void reset(float* f, const float* u) {
#pragma unroll
    for (int k = 0; k < 4; ++k) f[k] = -0.05f + 0.1f * u[k];
  }
};

// atan2 by the JAX hopper body's 9-term odd polynomial, so that kernel,
// plain version and JAX agree to rounding.
__device__ __forceinline__ float atan2_poly(float y, float x) {
  const float ax = fabsf(x), ay = fabsf(y);
  const float t = fminf(ax, ay) / fmaxf(fmaxf(ax, ay), 1e-30f);
  const float t2 = t * t;
  float p = 2.4682466247e-03f;
  p = p * t2 + -1.4458697067e-02f;
  p = p * t2 + 3.9899560039e-02f;
  p = p * t2 + -7.2479506621e-02f;
  p = p * t2 + 1.0507319787e-01f;
  p = p * t2 + -1.4164333375e-01f;
  p = p * t2 + 1.9986537489e-01f;
  p = p * t2 + -3.3332657853e-01f;
  p = p * t2 + 9.9999990555e-01f;
  float r = p * t;
  r = ay > ax ? 0.5f * PI_F - r : r;
  r = x < 0.f ? PI_F - r : r;
  return y < 0.f ? -r : r;
}

struct HopperBody {
  // rows: x, z, vx, vz, leg_angle, leg_len, foot_x, stance (0/1)
  static constexpr int S = 6, A = 2, F = 8, N_STEP = 0, N_RESET = 2;
  static constexpr bool DISCRETE = false;
  __device__ static void obs(const float* f, float* x) {
    x[0] = f[1];
    x[1] = f[2];
    x[2] = f[3];
    x[3] = f[4];
    x[4] = f[5] / 0.55f;
    x[5] = f[7];
  }
  __device__ static void step(float* f, int& tc, const float* a, const float*,
                              float& reward, bool& terminal, bool& trunc) {
    const float DT = 0.01f, G = 9.8f, LEG = 0.55f, K = 300.0f, THR = 60.0f;
    const float x = f[0], z = f[1], vx = f[2], vz = f[3];
    const float leg_angle = f[4], foot_x = f[6];
    const bool in_st = f[7] > 0.5f;
    const float target_angle = clampf(a[0], -1.0f, 1.0f) * 0.5f;
    const float thrust = clampf(a[1], -1.0f, 1.0f) * 0.5f + 0.5f;
    // flight branch
    const float fl_angle = leg_angle + 10.0f * (target_angle - leg_angle) * DT;
    const float fl_vz = vz - G * DT;
    const float fl_z = z + fl_vz * DT;
    const float fl_x = x + vx * DT;
    const float foot_z = fl_z - LEG * cosf(fl_angle);
    const bool touchdown = foot_z <= 0.0f && fl_vz < 0.f;
    const float fl_foot_x = touchdown ? fl_x + LEG * sinf(fl_angle) : foot_x;
    // stance branch
    const float dx = x - foot_x;
    const float st_len = sqrtf(dx * dx + z * z);
    const float compress = fmaxf(LEG - st_len, 0.0f);
    const float force = K * compress + THR * thrust;
    const float ux = dx / (st_len + 1e-6f), uz = z / (st_len + 1e-6f);
    const float st_vx = vx + force * ux * DT;
    const float st_vz = vz + (force * uz - G) * DT;
    const float st_x = x + st_vx * DT;
    const float st_z = z + st_vz * DT;
    const float ddx = st_x - foot_x;
    const float new_len = sqrtf(ddx * ddx + st_z * st_z);
    const bool liftoff = new_len >= LEG && st_vz > 0.f;
    const float st_angle = atan2_poly(ddx, st_z);
    f[0] = in_st ? st_x : fl_x;
    f[1] = in_st ? st_z : fl_z;
    f[2] = in_st ? st_vx : vx;
    f[3] = in_st ? st_vz : fl_vz;
    f[4] = in_st ? st_angle : fl_angle;
    f[5] = in_st ? new_len : LEG;
    f[6] = in_st ? foot_x : fl_foot_x;
    f[7] = in_st ? (liftoff ? 0.0f : 1.0f) : (touchdown ? 1.0f : 0.0f);
    tc += 1;
    reward = f[2] + 0.5f - 0.05f * (a[0] * a[0] + a[1] * a[1]);
    terminal = f[1] < 0.25f;
    trunc = tc >= 1000 && !terminal;
  }
  __device__ static void reset(float* f, const float* u) {
    f[0] = 0.f;
    f[1] = 0.9f + (-0.05f + 0.1f * u[0]);
    f[2] = -0.1f + 0.2f * u[1];
    f[3] = 0.f;
    f[4] = 0.f;
    f[5] = 0.55f;
    f[6] = 0.f;
    f[7] = 0.f;
  }
};

// PointChasing at dim 2; rows: p0 (2), v0 (2), p1 (2), v1 (2), distance.
struct ChasingBase {
  static constexpr int S = 8, F = 9, N_STEP = 2, N_RESET = 4;
  __device__ static void obs(const float* f, float* x) {
#pragma unroll
    for (int k = 0; k < 8; ++k) x[k] = f[k];
  }
  __device__ static void chase(float* f, int& tc, float a0, float a1, const float* u,
                               float& reward, bool& terminal, bool& trunc) {
    const float action_l2 = fmaxf(sqrtf(a0 * a0 + a1 * a1), 1.0f);
    const float an0 = a0 / action_l2, an1 = a1 / action_l2;
    const float v1x = f[6] * 0.75f + an0, v1y = f[7] * 0.75f + an1;
    const float p1x = f[4] + v1x * 0.01f, p1y = f[5] + v1y * 0.01f;
    const float v0x = f[2] * 0.50f + u[0], v0y = f[3] * 0.50f + u[1];
    const float p0x = f[0] + v0x * 0.01f, p0y = f[1] + v0y * 0.01f;
    const float ex = p0x - p1x, ey = p0y - p1y;
    const float dist = sqrtf(ex * ex + ey * ey);
    reward = f[8] - dist - action_l2 * 0.02f;
    f[0] = p0x; f[1] = p0y; f[2] = v0x; f[3] = v0y;
    f[4] = p1x; f[5] = p1y; f[6] = v1x; f[7] = v1y;
    f[8] = dist;
    tc += 1;
    terminal = dist < 2.0f || tc >= 1024;
    trunc = false;
  }
  // normals by Box-Muller from the 4 reset uniforms: cos row to p0, sin row
  // to p1 - 8
  __device__ static void reset(float* f, const float* u) {
    float p0[2], p1[2];
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const float r = sqrtf(-2.0f * logf(1.0f - u[k]));
      const float ang = TWO_PI_F * u[2 + k];
      p0[k] = r * cosf(ang);
      p1[k] = r * sinf(ang) - 8.0f;
    }
    const float ex = p0[0] - p1[0], ey = p0[1] - p1[1];
    f[0] = p0[0]; f[1] = p0[1]; f[2] = 0.f; f[3] = 0.f;
    f[4] = p1[0]; f[5] = p1[1]; f[6] = 0.f; f[7] = 0.f;
    f[8] = sqrtf(ex * ex + ey * ey);
  }
};

struct ChasingBody : ChasingBase {
  static constexpr int A = 2;
  static constexpr bool DISCRETE = false;
  __device__ static void step(float* f, int& tc, const float* a, const float* u,
                              float& reward, bool& terminal, bool& trunc) {
    chase(f, tc, a[0], a[1], u, reward, terminal, trunc);
  }
};

struct ChasingDiscreteBody : ChasingBase {
  static constexpr int A = 9;
  static constexpr bool DISCRETE = true;
  __device__ static void step(float* f, int& tc, const float* a, const float* u,
                              float& reward, bool& terminal, bool& trunc) {
    // base-3 digits of the index by the floor form, each mapped to -1, 0, +1
    const float idx = a[0];
    const float q1 = floorf(idx / 3.0f);
    const float d0 = idx - 3.0f * floorf(idx / 3.0f) - 1.0f;
    const float d1 = q1 - 3.0f * floorf(q1 / 3.0f) - 1.0f;
    chase(f, tc, d0, d1, u, reward, terminal, trunc);
  }
};

// StockTradingEnv-v2 (replaces pallas_rollout.py:451 make_stock_body).
// Rows: cash, NS share counts, total asset, the episode's reward sum, the
// recorded cumulative return; the step counter is the lane's day.  The obs
// is tanh(cash 2^-18), tanh(shares 2^-10) (the S_LANE per-lane rows), then
// close[day] 2^-7 and tech[day] 2^-6: the day is the same on every lane of
// a group of TE lanes (every env starts at day 0 and ends at the shared last
// day), so the kernels read it from the group's first lane, carry it as a
// scalar and wrap it to 0 at the last day, and fill the 135 market rows
// once for the group.  The tables stay in device memory (read through
// L2/L1: one row of each per step, the same row for every lane).
//
// Numbers: lots are floor(cash / price) with cash near 1e6, where one f32
// ulp is 0.0625, so the trade loop and the total are written with _rn
// intrinsics (IEEE division, no FMA contraction) in the plain version's
// order: stock by stock, the cash moved by (price * buy) * (1 + c) and
// (price * sell) * (1 - c), and total = sum_k price_k * shares_k (k in
// order) + cash.
struct StockBody {
  static constexpr int NS = 15;                  // stocks the body is built for
  static constexpr int NTECH = 8 * NS;
  static constexpr int S = 1 + 2 * NS + NTECH, A = NS, F = 4 + NS;
  static constexpr int S_LANE = 1 + NS;          // per-lane obs rows
  static constexpr int N_PAIRS = (NS + 1) / 2;   // Box-Muller pairs of the reset
  static constexpr int N_STEP = 0, N_RESET = 1 + 2 * N_PAIRS;
  static constexpr bool DISCRETE = false;
  StockArgs p;

  // obs row s (< S_LANE) from the lane's row f[s]: cash 2^-18, shares 2^-10
  __device__ static float obs_row(int s, float v) {
    return tanhf(v * (s == 0 ? 3.814697265625e-06f : 9.765625e-04f));
  }
  __device__ void obs(const float* f, float* x) const {
#pragma unroll
    for (int s = 0; s < S_LANE; ++s) x[s] = obs_row(s, f[s]);
  }
  // market row r (S_LANE <= r < S) of the obs on `day`
  __device__ float market(int day, int r) const {
    const int k = r - S_LANE;
    return k < NS ? __ldg(p.close + (size_t)day * NS + k) * 7.8125e-03f            // 2^-7
                  : __ldg(p.tech + (size_t)day * NTECH + (k - NS)) * 1.5625e-02f;  // 2^-6
  }
  __device__ float total(const float* prices, const float* shares, float cash) const {
    float t = __fmul_rn(prices[0], shares[0]);
#pragma unroll
    for (int k = 1; k < NS; ++k) t = __fadd_rn(t, __fmul_rn(prices[k], shares[k]));
    return __fadd_rn(t, cash);
  }
  __device__ void step(float* f, int& tc, int day, const float* a, float& reward,
                       bool& terminal, bool& trunc) const {
    float prices[NS];
#pragma unroll
    for (int k = 0; k < NS; ++k) prices[k] = __ldg(p.close + (size_t)(day + 1) * NS + k);
    step_at(f, tc, prices, a, reward, terminal, trunc);
  }
  // the step at the next day's close prices
  __device__ void step_at(float* f, int& tc, const float* prices, const float* a, float& reward,
                          bool& terminal, bool& trunc) const {
    float cash = f[0];
#pragma unroll
    for (int k = 0; k < NS; ++k) {  // sequential: buys compete for the same cash
      const float ak = fabsf(a[k]) < 0.1f ? 0.0f : a[k];
      const float lots = truncf(__fmul_rn(ak, p.max_stock));
      const float can_buy = floorf(__fdiv_rn(cash, prices[k]));
      const float buy = lots > 0.f ? fminf(can_buy, lots) : 0.0f;
      const float sell = lots > 0.f ? 0.0f : fminf(fmaxf(-lots, 0.0f), f[1 + k]);
      cash = __fadd_rn(__fsub_rn(cash, __fmul_rn(__fmul_rn(prices[k], buy), p.buy_cost)),
                       __fmul_rn(__fmul_rn(prices[k], sell), p.sell_cost));
      f[1 + k] = __fsub_rn(__fadd_rn(f[1 + k], buy), sell);
    }
    const float tot = total(prices, f + 1, cash);
    const float r = __fmul_rn(__fsub_rn(tot, f[1 + NS]), 2.44140625e-04f);  // 2^-12
    const float rsum = __fadd_rn(f[2 + NS], r);
    tc += 1;
    terminal = tc >= p.T - 1;
    const float bonus = __fdiv_rn(__fdiv_rn(rsum, (float)tc), p.one_minus_gamma);
    reward = terminal ? __fadd_rn(r, bonus) : r;
    if (terminal) f[3 + NS] = __fmul_rn(__fdiv_rn(tot, p.initial_amount), 100.0f);
    f[0] = cash;
    f[1 + NS] = tot;
    f[2 + NS] = rsum;
    trunc = false;
  }
  __device__ void reset(float* f, const float* u) const {
    float prices[NS];
#pragma unroll
    for (int k = 0; k < NS; ++k) prices[k] = __ldg(p.close + k);   // day 0
    if (p.random_reset) {
      f[0] = __fmul_rn(p.initial_amount, __fadd_rn(__fmul_rn(u[0], 0.5f), 0.75f));
#pragma unroll
      for (int q = 0; q < N_PAIRS; ++q) {
        const float r = sqrtf(-2.0f * logf(1.0f - u[1 + q]));
        const float ang = TWO_PI_F * u[1 + N_PAIRS + q];
        const float zc = r * cosf(ang), zs = r * sinf(ang);
        f[1 + q] = floorf(fabsf(clampf(zc, -2.0f, 2.0f))) * 128.0f;
        if (N_PAIRS + q < NS) f[1 + N_PAIRS + q] = floorf(fabsf(clampf(zs, -2.0f, 2.0f))) * 128.0f;
      }
    } else {
      f[0] = p.initial_amount;
#pragma unroll
      for (int k = 0; k < NS; ++k) f[1 + k] = 0.0f;
    }
    f[1 + NS] = total(prices, f + 1, f[0]);
    f[2 + NS] = 0.0f;
    f[3 + NS] = 0.0f;
  }
};

// What the kernels need to know of a body beyond its dimensions: whether it
// reads market tables (and carries the block's day), and how many obs rows
// belong to the lane (the rest are the day's market rows).
template <class Body>
struct BodyInfo {
  static constexpr bool TABLES = false;
  static constexpr int S_LANE = Body::S;
};
template <>
struct BodyInfo<StockBody> {
  static constexpr bool TABLES = true;
  static constexpr int S_LANE = StockBody::S_LANE;
};

// ----------------------------------------------------------------- kernel
// K1/K3 for the bodies without market tables (the stock body's actor runs
// in stock_actor_kernel below).  A group of TE = 32 env lanes runs on a
// thread-block cluster of c blocks (c = 1, 2, 4 or 8, from the card's
// occupancy: rollout_cluster); block r of a cluster owns slice(D, c) hidden
// units of every layer of both nets (cluster_mlp.cuh), loaded once a launch
// with cp.async.  Per step, two cluster barriers:
// - layer 1 of both nets as one product (the actor's rows of W1 stacked on
//   the critic's) over the normalised obs tile; each block pushes its rows
//   of h1 to every block (store_cluster); cluster barrier;
// - layer 2 of both nets over the whole h1, then this block's part of the
//   actor's means or logits and of the critic's value from its rows of h2
//   (the third layer split by its inputs), pushed to every block; cluster
//   barrier; the parts added in rank order, so every block holds the same
//   bits of the heads;
// - every block then runs the head's sampling and the env step from those
//   bitwise-equal inputs, one thread per lane on warp 0 (the bodies'
//   arithmetic unchanged), and keeps the lanes' env rows itself, so no
//   broadcast and no third barrier is needed; rank 0 stores the outputs.
//   Meanwhile warps 1-7 draw the next step's Philox words (or copy the
//   injected noise rows), and at the top of a step all warps turn them into
//   the head's normals (Box-Muller) or Gumbel noise.  (Rank 0 alone running
//   the env step and pushing the obs tile, a third cluster barrier a step,
//   measured slower: scripts/torch_cluster_kernels.py --push-obs.)
// Products are cm::tile_dense: 4 x 4 outputs a thread, split-K parts added
// in a fixed order, so a launch is deterministic.  Sums run in another
// order than the plain version's, so outputs agree to rounding (a lane can
// part at a hard threshold: chip_smoke.py's k1/k3 checks).

// Shared memory of one block (floats), clusters of c, a body with NH head
// words and NE env uniforms a (lane, step): the weight slices row by row
// (both nets' W1 rows, W2a rows, W2c rows, the heads' columns:
// cluster_mlp.cuh) and biases, exp(std_log), the normalisation, then
// (rows, TE) tiles: xn, both h1 (every block's rows), this block's rows of
// both h2, every block's part of the heads, two steps' head words and env
// uniforms, the head noise, the summed heads, and the split-K scratch of
// the widest product (tile_scratch; products that share it are a block
// barrier apart).
// With st (the streamed design) the W2 slices are not held (they are read
// from the stream_weights copy in device memory) and a group has G =
// STREAM_LANES lanes, so the whole h1 of both nets fits a block up to a first
// width past 1024 in float32; else G = TE.
// Floats of split-K scratch that cm::tile_dense takes for a product of J
// rows over K inputs and M lanes, at most ks_max parts (its rule for the
// count of parts ks).
__host__ __device__ inline int tile_scratch(int K, int J, int M = TE, int ks_max = cm::THREADS) {
  const int tiles = (J / 4) * (M / 4);
  int ks = 1;
  while (2 * ks * tiles <= cm::THREADS && 8 * ks <= K) ks *= 2;
  if (ks > ks_max) ks = ks_max;
  return ks > 1 ? ks * J * M : 0;
}

// With bf (bf16 compute) the weight slices and the activation tiles (xn, h1,
// h2) hold bf16 values (cm::wrow, cm::vals); where that layout with layer 2's
// split-K scratch does not fit a block, layer 2 runs unsplit (cap2) and the
// scratch only serves the other products.
constexpr int SMEM_FLOATS = 232448 / 4;  // shared memory a Hopper block can hold

struct RolloutLayout {
  int s4, ap, js1, js2, k2, w1, b1, w2a, w2c, b2a, b2c, woa, woc, bo, stdv, nrm, xn, h1a, h1c,
      h2a, h2c, outp, hraw, uenv, hz, headv, scratch, split2, rest, cap2, floats, nh4, ne4;
  __host__ __device__ RolloutLayout(int S, int A, int NH, int NE, int D1, int D2, int c,
                                    int G, int bf, int st) {
    s4 = cm::round4(S);
    ap = cm::round4(A);
    nh4 = cm::round4(NH);
    ne4 = cm::round4(max(NE, 1));
    js1 = cm::slice(D1, c);
    js2 = cm::slice(D2, c);
    k2 = c * js1;
    int o = 0;
    w1 = o; o += 2 * js1 * cm::wrow(S, bf);
    b1 = o; o += 2 * js1;
    w2a = o; o += (1 - st) * js2 * cm::wrow(k2, bf);
    w2c = o; o += (1 - st) * js2 * cm::wrow(k2, bf);
    b2a = o; o += js2;
    b2c = o; o += js2;
    woa = o; o += ap * cm::wrow(js2, bf);
    woc = o; o += 4 * cm::wrow(js2, bf);
    bo = o; o += ap + 4;
    stdv = o; o += ap;
    nrm = o; o += 2 * s4;
    xn = o; o += cm::vals(s4 * G, bf);
    h1a = o; o += cm::vals(k2 * G, bf);
    h1c = o; o += cm::vals(k2 * G, bf);
    h2a = o; o += cm::vals(js2 * G, bf);
    h2c = o; o += cm::vals(js2 * G, bf);
    outp = o; o += c * (ap + 4) * G;
    hraw = o; o += 2 * nh4 * G;
    uenv = o; o += 2 * ne4 * G;
    hz = o; o += ap * G;
    headv = o; o += cm::round4(A + 1) * G;
    scratch = o;
    split2 = tile_scratch(k2, js2, G);
    rest = max(tile_scratch(s4, 2 * js1, G), max(tile_scratch(js2, ap, G), tile_scratch(js2, 4, G)));
    cap2 = bf * (o + cm::round4(max(split2, rest)) > SMEM_FLOATS);
    o += cm::round4(max(split2 * (1 - cap2), rest));
    floats = o;
  }
};

template <class Body, bool BF, int ST>
__host__ __device__ inline RolloutLayout body_layout(int D1, int D2, int c) {
  return RolloutLayout(Body::S, Body::A, Body::DISCRETE ? Body::A : 2 * Body::A,
                       Body::N_STEP + Body::N_RESET, D1, D2, c, rollout_lanes(ST), BF, ST != 0);
}

// BF: bf16 compute (elegantrl_tpu/ops/pallas_rollout.py:_bf16_dot): each
// product's operands are rounded to bf16 (the weights as they are loaded,
// xn, h1 and h2 as they are stored) and summed in f32; biases, GELU and the
// heads stay f32.  quant (store_dtype bf16): the obs is rounded to bf16
// before it is normalised and acted on, and stored as bf16.  ST: the streamed
// design (RolloutLayout's st; w2g the stream_weights copy of both nets' W2,
// which tile_dense reads through L1 from L2 as it reads shared memory in the
// resident design); the same products in the same order at G lanes a group
// (rollout_lanes: 16, or 8 and 4 for the narrower groups).
template <class Body, bool BF, int ST>
__global__ void __launch_bounds__(cm::THREADS, 2)
fused_rollout_kernel(const Body body, const float* __restrict__ act_flat,
                     const float* __restrict__ cri_flat,
                     const float* __restrict__ norm_avg,
                     const float* __restrict__ norm_std,
                     const float* __restrict__ env_f,
                     const int* __restrict__ env_i,
                     const float* __restrict__ noise,
                     const int* __restrict__ seed,
                     void* __restrict__ states_o, void* __restrict__ actions_o,
                     float* __restrict__ logp_o, float* __restrict__ rew_o,
                     float* __restrict__ term_o, float* __restrict__ trunc_o,
                     float* __restrict__ val_o, float* __restrict__ env_f_o,
                     int* __restrict__ env_i_o, int N, int H, int D1, int D2,
                     float reward_scale, int quant,
                     const cm::elem_t<BF>* __restrict__ w2g) {
  constexpr int S = Body::S, A = Body::A, F = Body::F, G = rollout_lanes(ST);
  constexpr bool DISCRETE = Body::DISCRETE;
  constexpr int N_ENV = Body::N_STEP + Body::N_RESET;  // the env's uniforms
  constexpr int NZ = A + N_ENV;                        // injected rows
  constexpr int N_HEAD = DISCRETE ? A : 2 * A;         // internal head uniforms
  constexpr int NB = (N_HEAD + N_ENV + 3) / 4;         // Philox blocks per step
  constexpr int AE = DISCRETE ? 1 : A;                 // values of the env's action
  static_assert(!BodyInfo<Body>::TABLES, "the stock body runs stock_actor_kernel");

  cm::cg::cluster_group cluster = cm::cg::this_cluster();
  const int c = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int grp = blockIdx.x / c;
  const RolloutLayout Ly = body_layout<Body, BF, ST>(D1, D2, c);
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  using WT = cm::elem_t<BF>;
  auto wt = [&](int off) { return reinterpret_cast<WT*>(sm + off); };
  WT *w1s = wt(Ly.w1), *woa = wt(Ly.woa), *woc = wt(Ly.woc);
  WT *xn = wt(Ly.xn), *h1a = wt(Ly.h1a), *h1c = wt(Ly.h1c), *h2a = wt(Ly.h2a),
     *h2c = wt(Ly.h2c);
  float *b1s = sm + Ly.b1, *b2a = sm + Ly.b2a, *b2c = sm + Ly.b2c;
  float *bos = sm + Ly.bo, *stdv = sm + Ly.stdv, *avg = sm + Ly.nrm, *nstd = sm + Ly.nrm + Ly.s4;
  float *outp = sm + Ly.outp, *hz = sm + Ly.hz, *headv = sm + Ly.headv;
  float* scr = sm + Ly.scratch;
  const int ks2 = Ly.cap2 ? 1 : cm::THREADS;  // layer 2's split-K parts at most
  const int js1 = Ly.js1, js2 = Ly.js2, k2 = Ly.k2, j1 = rank * js1, j2 = rank * js2;
  const int AP = Ly.ap, R = Ly.ap + 4;  // rows of a rank's part: AP actor rows, the value
  // a cluster barrier, or a block barrier for a cluster of one block (a
  // cluster barrier costs ~0.5 us more on an H100)
  auto sync_group = [&]() {
    if (c == 1) __syncthreads();
    else cluster.sync();
  };
  cm::cluster_arrive();  // this block has started

  // the leaves: W1 (D1, S), b1, W2 (D2, D1), b2, Wo (O, D2), bo (, std_log)
  const float* W1a = act_flat;
  const float* W2a = W1a + D1 * S + D1;
  const float* Woa = W2a + D2 * D1 + D2;
  const float* W1c = cri_flat;
  const float* W2c = W1c + D1 * S + D1;
  const float* Woc = W2c + D2 * D1 + D2;
  const int ld1 = cm::wld<BF>(S), ld2 = ST ? round32(D1) : cm::wld<BF>(k2),
            ldo = cm::wld<BF>(js2);
  // this block's rows of both W2: slices in shared memory, or (ST) rows of
  // the stream_weights copy, the critic's after the actor's round32(D2) rows
  const WT* w2a = ST ? w2g + (size_t)j2 * ld2 : wt(Ly.w2a);
  const WT* w2c = ST ? w2g + (size_t)(round32(D2) + j2) * ld2 : wt(Ly.w2c);
  cm::load_rows<true>(W1a, D1, S, j1, js1, 0, S, w1s, ld1);
  cm::load_rows<true>(W1c, D1, S, j1, js1, 0, S, w1s + js1 * ld1, ld1);
  cm::load_vec<true>(W1a + D1 * S, D1, j1, js1, b1s);
  cm::load_vec<true>(W1c + D1 * S, D1, j1, js1, b1s + js1);
  if constexpr (!ST) {
    cm::load_rows<true>(W2a, D2, D1, j2, js2, 0, k2, wt(Ly.w2a), ld2);
    cm::load_rows<true>(W2c, D2, D1, j2, js2, 0, k2, wt(Ly.w2c), ld2);
  }
  cm::load_vec<true>(W2a + D2 * D1, D2, j2, js2, b2a);
  cm::load_vec<true>(W2c + D2 * D1, D2, j2, js2, b2c);
  cm::load_rows<true>(Woa, A, D2, 0, AP, j2, js2, woa, ldo);
  cm::load_rows<true>(Woc, 1, D2, 0, 4, j2, js2, woc, ldo);
  cm::cp_async_commit();
  for (int i = threadIdx.x; i < R; i += cm::THREADS) {
    bos[i] = i < A ? __ldg(Woa + A * D2 + i) : (i == AP ? __ldg(Woc + D2) : 0.f);
    if (i < AP) stdv[i] = !DISCRETE && i < A ? expf(__ldg(Woa + A * D2 + A + i)) : 1.f;
  }
  for (int s = threadIdx.x; s < Ly.s4; s += cm::THREADS) {
    avg[s] = s < S ? __ldg(norm_avg + s) : 0.f;
    nstd[s] = s < S ? __ldg(norm_std + s) + 1e-4f : 1.f;
  }
  for (int i = threadIdx.x; i < (Ly.s4 - S) * G; i += cm::THREADS) cm::st1(xn + S * G + i, 0.f);
  __syncthreads();  // avg and nstd, before warp 0 reads them

  // warp 0 holds the env rows of the group's lanes (every block of the cluster)
  const int e = threadIdx.x;  // the lane of a warp-0 thread
  const bool w0 = threadIdx.x < G;
  const int n = grp * G + (threadIdx.x & (G - 1));
  const bool live = w0 && n < N;
  float f[F];
#pragma unroll
  for (int k = 0; k < F; ++k) f[k] = 0.f;
  int tc = 0;
  if (live) {
#pragma unroll
    for (int k = 0; k < F; ++k) f[k] = env_f[(size_t)k * N + n];
    tc = env_i[n];
  }
  uint2 key = make_uint2(0u, 0u);
  if (noise == nullptr) key = make_uint2((uint32_t)seed[0], (uint32_t)seed[1]);

  // warp 0: the obs of step t (rounded to bf16 first when quant), normalised
  // into xn; rank 0 stores it
  auto observe = [&](int t) {
    float x[S];
    body.obs(f, x);
#pragma unroll
    for (int s = 0; s < S; ++s) {
      if (quant) x[s] = cm::bf16_round(x[s]);
      const float v = live ? (x[s] - avg[s]) / nstd[s] : 0.f;
      cm::st1(xn + s * G + e, v);
      if (live && rank == 0) {
        const size_t i = ((size_t)t * S + s) * N + n;
        if (quant) cm::st1((__nv_bfloat16*)states_o + i, x[s]);
        else ((float*)states_o)[i] = x[s];
      }
    }
  };
  // threads from `first` on: step t's head words and env uniforms, drawn
  // (Philox, counter (lane, step, j / 4, 0)) or copied from the noise rows
  auto prepare = [&](int t, int first) {
    const int i0 = (int)threadIdx.x - first, nth = cm::THREADS - first;
    if (i0 < 0) return;
    float* hr = sm + Ly.hraw + (t & 1) * Ly.nh4 * G;
    float* ue = sm + Ly.uenv + (t & 1) * Ly.ne4 * G;
    if (noise == nullptr) {
      for (int i = i0; i < NB * G; i += nth) {
        const int b = i / G, e2 = i % G;
        const uint4 q = philox4x32_10(
            make_uint4((uint32_t)(grp * G + e2), (uint32_t)t, (uint32_t)b, 0u), key);
        const float w[4] = {uniform24(q.x), uniform24(q.y), uniform24(q.z), uniform24(q.w)};
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int j = 4 * b + k;
          if (j < N_HEAD) hr[j * G + e2] = w[k];
          else if (j < N_HEAD + N_ENV) ue[(j - N_HEAD) * G + e2] = w[k];
        }
      }
    } else {
      for (int i = i0; i < NZ * G; i += nth) {
        const int r = i / G, e2 = i % G, n2 = grp * G + e2;
        const float v = n2 < N ? noise[((size_t)t * NZ + r) * N + n2] : 0.f;
        if (r < A) hr[r * G + e2] = v;
        else ue[(r - A) * G + e2] = v;
      }
    }
  };
  if (w0 && H > 0) observe(0);
  if (H > 0) prepare(0, 0);
  cm::cp_async_wait<0>();
  cm::cluster_wait();  // every block has started: h1 rows and head parts may be pushed

  for (int t = 0; t < H; ++t) {
    __syncthreads();  // step t's obs tile and noise words; the weights at t = 0
    // ---- layer 1 of both nets: the actor's js1 rows, then the critic's
    cm::tile_dense<G>(w1s, ld1, xn, Ly.s4, 2 * js1, scr, [&](int j, int m0, float4 v) {
      const float b = b1s[j];
      WT* h1 = j < js1 ? h1a : h1c;
      const int row = j1 + (j < js1 ? j : j - js1);
      cm::store_cluster(cluster, c, h1, row * G + m0,
                        make_float4(gelu_tanh(v.x + b), gelu_tanh(v.y + b), gelu_tanh(v.z + b),
                                    gelu_tanh(v.w + b)));
    });
    // the head's noise: the Gaussian's normals, or the categorical's Gumbel
    const float* hr = sm + Ly.hraw + (t & 1) * Ly.nh4 * G;
    for (int i = threadIdx.x; i < A * G; i += cm::THREADS) {
      const int a = i / G, e2 = i % G;
      float z;
      if (DISCRETE) {
        z = -logf(-logf(fmaxf(hr[i], 1e-12f)) + 1e-12f);
      } else if (noise != nullptr) {
        z = hr[i];
      } else {
        z = sqrtf(-2.0f * logf(1.0f - hr[i])) * cosf(TWO_PI_F * hr[(A + a) * G + e2]);
      }
      hz[i] = z;
    }
    sync_group();  // h1: every block's rows, in every block
    // ---- layer 2 of both nets; this block's parts of the heads
    cm::tile_dense<G>(w2a, ld2, h1a, k2, js2, scr, [&](int j, int m0, float4 v) {
      const float b = b2a[j];
      cm::st4(h2a + j * G + m0, make_float4(gelu_tanh(v.x + b), gelu_tanh(v.y + b),
                                             gelu_tanh(v.z + b), gelu_tanh(v.w + b)));
    }, ks2);
    __syncthreads();  // the scratch is free
    cm::tile_dense<G>(w2c, ld2, h1c, k2, js2, scr, [&](int j, int m0, float4 v) {
      const float b = b2c[j];
      cm::st4(h2c + j * G + m0, make_float4(gelu_tanh(v.x + b), gelu_tanh(v.y + b),
                                             gelu_tanh(v.z + b), gelu_tanh(v.w + b)));
    }, ks2);
    __syncthreads();
    cm::tile_dense<G>(woa, ldo, h2a, js2, AP, scr, [&](int j, int m0, float4 v) {
      cm::store_cluster(cluster, c, outp, (rank * R + j) * G + m0, v);
    });
    __syncthreads();
    cm::tile_dense<G>(woc, ldo, h2c, js2, 4, scr, [&](int j, int m0, float4 v) {
      cm::store_cluster(cluster, c, outp, (rank * R + AP + j) * G + m0, v);
    });
    sync_group();  // every block's parts of the heads, in every block
    // ---- the heads: the parts in rank order, plus the bias
    for (int i = threadIdx.x; i < (A + 1) * G; i += cm::THREADS) {
      const int a = i / G, row = a < A ? a : AP, o = row * G + i % G;
      float v = outp[o];
      for (int q = 1; q < c; ++q) v += outp[q * R * G + o];
      headv[i] = v + bos[row];  // rows: the A means or logits, then the value
    }
    __syncthreads();
    if (w0) {
      if (live) {
        const float* ue = sm + Ly.uenv + (t & 1) * Ly.ne4 * G;
        float u_env[N_ENV > 0 ? N_ENV : 1];
#pragma unroll
        for (int k = 0; k < N_ENV; ++k) u_env[k] = ue[k * G + e];
        const size_t o = (size_t)t * N + n;
        float env_a[AE], logp;
        if constexpr (DISCRETE) {
          float best = 0.f, m = 0.f;
          int index = 0;
#pragma unroll
          for (int a = 0; a < A; ++a) {
            const float logit = headv[a * G + e];
            const float p = logit + hz[a * G + e];
            if (a == 0 || p > best) {  // strict: the first maximum wins a tie
              best = p;
              index = a;
            }
            m = a == 0 ? logit : fmaxf(m, logit);
          }
          float sum = 0.f, chosen = 0.f;
#pragma unroll
          for (int a = 0; a < A; ++a) {
            const float logit = headv[a * G + e];
            sum += expf(logit - m);
            if (a == index) chosen = logit;
          }
          logp = chosen - (m + logf(sum));
          if (rank == 0) ((int*)actions_o)[o] = index;
          env_a[0] = (float)index;
        } else {
          logp = 0.f;
#pragma unroll
          for (int a = 0; a < A; ++a) logp -= logf(stdv[a]);
#pragma unroll
          for (int a = 0; a < A; ++a) {
            const float z = hz[a * G + e];
            const float action = headv[a * G + e] + stdv[a] * z;
            logp += -0.5f * z * z - LOG_SQRT_2PI;
            if (rank == 0) ((float*)actions_o)[((size_t)t * A + a) * N + n] = action;
            env_a[a] = tanhf(action);
          }
        }
        float reward;
        bool terminal, trunc;
        body.step(f, tc, env_a, u_env, reward, terminal, trunc);
        if (rank == 0) {
          logp_o[o] = logp;
          rew_o[o] = reward * reward_scale;
          term_o[o] = terminal ? 1.0f : 0.0f;
          trunc_o[o] = trunc ? 1.0f : 0.0f;
          val_o[o] = headv[A * G + e];
        }
        if (terminal || trunc) {  // masked reset from the reset uniforms
          body.reset(f, u_env + Body::N_STEP);
          tc = 0;
        }
      }
      if (t + 1 < H) observe(t + 1);
    } else if (t + 1 < H) {
      prepare(t + 1, 32);  // the other warps, meanwhile
    }
  }
  if (rank == 0 && live) {
#pragma unroll
    for (int k = 0; k < F; ++k) env_f_o[(size_t)k * N + n] = f[k];
    env_i_o[n] = tc;
  }
}

template <class Body, bool BF, int ST>
int rollout_smem(int D1, int D2, int c) {
  return (int)sizeof(float) * body_layout<Body, BF, ST>(D1, D2, c).floats;
}

// Raises KERNEL's dynamic shared-memory ceiling on the current device to
// smem bytes.  The ceiling only grows, so it is set once for each larger
// size a (kernel, device) meets, not at every launch.
template <auto KERNEL>
cudaError_t allow_smem(int smem) {
  static int ceiling[64] = {0};
  int dev = 0;
  const cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const bool known = dev >= 0 && dev < 64;
  if (known && ceiling[dev] >= smem) return cudaSuccess;
  const cudaError_t set =
      cudaFuncSetAttribute(KERNEL, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (set == cudaSuccess && known) ceiling[dev] = smem;
  return set;
}

// The cluster size for `groups` lane groups of KERNEL, whose block takes
// smem_of(c) bytes in clusters of c: `cluster` when it is 1, 2, 4 or 8 and
// its layout fits; with 0, the largest of 8, 4, 2, 1 whose layout fits and
// whose clusters the card holds all at once, else the largest that fits of
// 2 and 1, else 4 or 8 (wide nets: only a wide cluster holds the slices).
// With whole_sm that rule comes second: first the largest whose clusters
// the card holds all at once with one block an SM (asked of the occupancy
// calculator with more than half an SM's shared memory a block).  0 when
// none fits or on a CUDA error.
template <auto KERNEL, class SmemOf>
int pick_cluster(int groups, int cluster, SmemOf smem_of, bool whole_sm) {
  constexpr int SMEM_LIMIT = 232448, WHOLE_SM = 116 * 1024;
  if (cluster == 1 || cluster == 2 || cluster == 4 || cluster == 8)
    return smem_of(cluster) <= SMEM_LIMIT ? cluster : 0;
  if (cluster != 0) return 0;
  for (int c : {8, 4, 2, 1}) {
    const int smem = smem_of(c);
    if (!whole_sm) break;
    if (smem > SMEM_LIMIT) continue;
    const int whole = smem > WHOLE_SM ? smem : WHOLE_SM;
    if (allow_smem<KERNEL>(whole) != cudaSuccess) return 0;
    const int active = cm::active_clusters(KERNEL, c, whole);
    if (active == 0) return 0;
    if (groups <= active) return c;
  }
  int small = 0, wide = 0;  // the largest that fits of 2 and 1; of 8 and 4
  for (int c : {8, 4, 2, 1}) {
    const int smem = smem_of(c);
    if (smem > SMEM_LIMIT) continue;
    if (c <= 2 && small == 0) small = c;
    if (c > 2 && wide == 0) wide = c;
    if (allow_smem<KERNEL>(smem) != cudaSuccess) return 0;
    const int active = cm::active_clusters(KERNEL, c, smem);
    if (active == 0) return 0;
    if (groups <= active) return c;
  }
  return small != 0 ? small : wide;
}

// The rollout kernel's cluster size for N lanes (pick_cluster).
template <class Body, bool BF, int ST>
int rollout_cluster(int N, int D1, int D2, int cluster) {
  constexpr int G = rollout_lanes(ST);
  return pick_cluster<fused_rollout_kernel<Body, BF, ST>>(
      (N + G - 1) / G, cluster, [=](int c) { return rollout_smem<Body, BF, ST>(D1, D2, c); },
      false);
}

template <class Body, bool BF, int ST>
int launch(const void* act_flat, const void* cri_flat, const void* norm_avg,
           const void* norm_std, const void* env_f, const void* env_i,
           const void* noise, const void* seed, void* states, void* actions,
           void* logp, void* rew, void* term, void* trunc, void* val,
           void* env_f_o, void* env_i_o, int N, int H, int D1, int D2,
           float reward_scale, int cluster, int quant, const void* w2, cudaStream_t stream) {
  if (N == 0) return 0;
  const int c = rollout_cluster<Body, BF, ST>(N, D1, D2, cluster);
  if (c == 0) {
    const cudaError_t err = cudaGetLastError();
    return (int)(err != cudaSuccess ? err : cudaErrorInvalidValue);
  }
  const int smem = rollout_smem<Body, BF, ST>(D1, D2, c);
  const cudaError_t err = allow_smem<fused_rollout_kernel<Body, BF, ST>>(smem);
  if (err != cudaSuccess) return (int)err;
  constexpr int G = rollout_lanes(ST);
  const int groups = (N + G - 1) / G;
  return (int)cm::launch_clusters(
      fused_rollout_kernel<Body, BF, ST>, groups * c, c, smem, stream, Body{},
      (const float*)act_flat, (const float*)cri_flat, (const float*)norm_avg,
      (const float*)norm_std, (const float*)env_f, (const int*)env_i, (const float*)noise,
      (const int*)seed, states, actions, (float*)logp, (float*)rew, (float*)term,
      (float*)trunc, (float*)val, (float*)env_f_o, (int*)env_i_o, N, H, D1, D2, reward_scale,
      quant, (const cm::elem_t<BF>*)w2);
}

// ------------------------------------------------- off-policy exploration
// Replaces: elegantrl_tpu/ops/pallas_rollout.py, _make_offpolicy_kernel
// (built by make_fused_offpolicy_rollout) with the heads ddpg, dqn, dqn_enc,
// dqn_duel, sac and modsac (pallas_rollout.py:1054-1083).  One net, no
// critic, no logprob and no observation normalisation; the trunk is l2 = W2
// gelu(W1 x + b1) + b2 and the heads
//   HEAD_DDPG     a = clip(tanh(Wo gelu(l2) + bo) + noise_std z, -1, 1)
//   HEAD_DQN      q = Wo gelu(l2) + bo
//   HEAD_DQN_ENC  q = Wo l2 + bo
//   HEAD_DQN_DUEL q = val - mean(val) + adv, val = Wo l2 + bo, adv = W4 l2 + b4
//   HEAD_SAC      a = tanh(mean + exp(clip(log_std, lo, hi)) z),
//                 [mean, log_std] = Wo gelu(l2) + bo (2A rows)
//   HEAD_MODSAC   the same with mean = Wa l2 + ba, log_std = Ws l2 + bs
// with the DQN heads acting epsilon-greedily: u0 < explore_rate ?
// min(floor(u1 A), A - 1) : argmax q (the first maximum on a tie).  The
// outputs are written in the (H, N, dim) layout the replay buffer takes.
// Noise: injected (H, NZ, N) with A normals (ddpg, sac, modsac) or the coin
// and the random-action uniform (DQN) first, then the env's uniforms;
// internal Philox draws 2A (the continuous heads, Box-Muller) or 2 head
// uniforms per (lane, step), counter (lane, step, j / 4, 0).  The stock
// body's heads run in stock_actor_kernel<HEAD> below.
//
// Bound: operations, one net's 2 (S D1 + D1 D2 + D2 O) FLOP per env-step (O
// head rows); at the off-policy shapes (64 or 1024 envs) far less work than
// the card holds, so a step's latency sets the time.
//
// What held the first design back (one 8-warp block per 32 lanes, the whole
// net in shared memory, `dense`, ~25 us a step): 2 blocks on 132 SMs at 64
// envs, 32 at 1024; one shared-memory weight load per FMA; the Philox draws,
// head, sampling and env step on 32 threads while seven warps waited; and
// (256, 256) did not fit one block.  This design is fused_rollout_kernel's:
// - a group of OFF_LANES env lanes runs on a thread-block cluster of c
//   blocks (c = 1, 2, 4 or 8 from the card's occupancy: offpolicy_cluster);
//   block r owns slice(D, c) rows of W1 and W2 and the same slice of the
//   head's columns (cluster_mlp.cuh), loaded once a launch with cp.async;
// - per step, two cluster barriers: layer 1 over the obs tile, each block's
//   rows of h1 pushed to every block (store_cluster); layer 2 over the whole
//   h1, then this block's part of the O head rows from its rows of h2,
//   pushed likewise; the parts added in rank order, so every block holds
//   the same bits and steps its own copy of the lanes' envs on warp 0 (the
//   bodies' arithmetic unchanged); rank 0 stores the outputs;
// - warps 1-7 draw the next step's Philox words (or copy the injected noise
//   rows) meanwhile, and all warps turn the head's words into normals at
//   the top of a step.
// Products are cm::tile_dense (4 x 4 outputs a thread, split-K parts in a
// fixed order), so a launch is deterministic; sums run in another order
// than the plain version's, so outputs agree to rounding.

constexpr int HEAD_DDPG = 0, HEAD_DQN = 1, HEAD_DQN_ENC = 2, HEAD_DQN_DUEL = 3,
              HEAD_SAC = 4, HEAD_MODSAC = 5;
constexpr int HEAD_PPO = 6;   // stock_actor_kernel's on-policy Gaussian head
constexpr int OFF_LANES = 16; // env lanes per off-policy group (32 measured slower)

__host__ __device__ constexpr bool sac_head(int head) {
  return head == HEAD_SAC || head == HEAD_MODSAC;
}
__host__ __device__ constexpr bool dqn_head(int head) {
  return head == HEAD_DQN || head == HEAD_DQN_ENC || head == HEAD_DQN_DUEL;
}
// Rows of the head's output: 2A (sac, modsac: mean, then log_std), A + 1
// (dqn_duel: the values, then the advantage) or A.
__host__ __device__ constexpr int offpolicy_out_rows(int A, int head) {
  return sac_head(head) ? 2 * A : (head == HEAD_DQN_DUEL ? A + 1 : A);
}

// Shared memory of one block (floats), clusters of c, S obs rows, O head
// rows, NH head words and NE env uniforms a (lane, step), G lanes a group:
// the weight slices row by row (W1's rows, W2's rows, the head's columns:
// cluster_mlp.cuh) and biases, then (rows, G) tiles: the obs, the whole h1,
// this block's rows of h2, every block's part of the head rows, two steps'
// head words and env uniforms, the head's normals, the summed head rows, and
// the split-K scratch of the widest product.
// With bf (bf16 compute) the weight slices and the tiles xn, h1 and h2 hold
// bf16 values (cm::wrow, cm::vals); with st (the streamed design) W2's slice
// is not held (it is read from the stream_weights copy in device memory).
struct OffLayout {
  int s4, op, js1, js2, k2, w1, b1, w2, b2, wo, bo, xn, h1, h2, outp, hraw, uenv, hz, headv,
      scratch, floats, nh4, ne4;
  __host__ __device__ OffLayout(int S, int A, int O, int NH, int NE, int D1, int D2, int c,
                                int G, int bf, int st) {
    s4 = cm::round4(S);
    op = cm::round4(O);
    nh4 = cm::round4(NH);
    ne4 = cm::round4(max(NE, 1));
    js1 = cm::slice(D1, c);
    js2 = cm::slice(D2, c);
    k2 = c * js1;
    int o = 0;
    w1 = o; o += js1 * cm::wrow(S, bf);
    b1 = o; o += js1;
    w2 = o; o += (1 - st) * js2 * cm::wrow(k2, bf);
    b2 = o; o += js2;
    wo = o; o += op * cm::wrow(js2, bf);
    bo = o; o += op;
    xn = o; o += cm::vals(s4 * G, bf);
    h1 = o; o += cm::vals(k2 * G, bf);
    h2 = o; o += cm::vals(js2 * G, bf);
    outp = o; o += c * op * G;
    hraw = o; o += 2 * nh4 * G;
    uenv = o; o += 2 * ne4 * G;
    hz = o; o += cm::round4(A) * G;
    headv = o; o += op * G;
    scratch = o;
    o += cm::round4(max(max(tile_scratch(s4, js1, G), tile_scratch(k2, js2, G)),
                        tile_scratch(js2, op, G)));
    floats = o;
  }
};

template <class Body, int HEAD, bool BF, int ST>
__host__ __device__ inline OffLayout off_layout(int D1, int D2, int c) {
  constexpr bool DISCRETE = dqn_head(HEAD);
  return OffLayout(Body::S, Body::A, offpolicy_out_rows(Body::A, HEAD),
                   DISCRETE ? 2 : 2 * Body::A, Body::N_STEP + Body::N_RESET, D1, D2, c,
                   narrow_lanes(OFF_LANES, ST), BF, ST != 0);
}

// BF and quant as for fused_rollout_kernel (_bf16_dot in
// pallas_rollout.py:_make_offpolicy_kernel); under quant the continuous
// heads' stored actions are bf16 too, the env stepping with the f32 action.
// ST: the streamed design, W2 read from w2g (stream_weights) as in
// fused_rollout_kernel; its groups of OFF_LANES lanes, or 8 and 4 for the
// narrower streamed groups (ST 2, 3).
template <class Body, int HEAD, bool BF, int ST>
__global__ void __launch_bounds__(cm::THREADS, 2)
offpolicy_rollout_kernel(const Body body, const float* __restrict__ flat,
                         const float* __restrict__ env_f,
                         const int* __restrict__ env_i, const float* __restrict__ noise,
                         const int* __restrict__ seed, void* __restrict__ states_o,
                         void* __restrict__ actions_o, float* __restrict__ rew_o,
                         float* __restrict__ term_o, float* __restrict__ trunc_o,
                         float* __restrict__ env_f_o, int* __restrict__ env_i_o, int N,
                         int H, int D1, int D2, float reward_scale, float noise_std,
                         float explore_rate, float std_lo, float std_hi, int quant,
                         const cm::elem_t<BF>* __restrict__ w2g) {
  constexpr int S = Body::S, A = Body::A, F = Body::F, G = narrow_lanes(OFF_LANES, ST);
  constexpr bool SAC = sac_head(HEAD), DISCRETE = dqn_head(HEAD);
  static_assert(DISCRETE == Body::DISCRETE, "the head must fit the body's action space");
  static_assert(!BodyInfo<Body>::TABLES, "the stock body runs stock_actor_kernel<HEAD>");
  static_assert(G % 4 == 0 && G <= 32, "a group's lanes sit on warp 0");
  constexpr bool GELU2 = HEAD == HEAD_DDPG || HEAD == HEAD_DQN || HEAD == HEAD_SAC;
  constexpr int O = offpolicy_out_rows(A, HEAD);
  constexpr int N_ENV = Body::N_STEP + Body::N_RESET;
  constexpr int N_HEAD_INJ = DISCRETE ? 2 : A;      // injected head rows
  constexpr int NZ = N_HEAD_INJ + N_ENV;
  constexpr int N_HEAD = DISCRETE ? 2 : 2 * A;      // internal head uniforms
  constexpr int NB = (N_HEAD + N_ENV + 3) / 4;      // Philox blocks per step
  constexpr int AE = DISCRETE ? 1 : A;              // values of the env's action

  cm::cg::cluster_group cluster = cm::cg::this_cluster();
  const int c = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int grp = blockIdx.x / c;
  const OffLayout Ly = off_layout<Body, HEAD, BF, ST>(D1, D2, c);
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  using WT = cm::elem_t<BF>;
  auto wt = [&](int off) { return reinterpret_cast<WT*>(sm + off); };
  WT *w1s = wt(Ly.w1), *wos = wt(Ly.wo), *xn = wt(Ly.xn), *h1 = wt(Ly.h1), *h2 = wt(Ly.h2);
  float *b1s = sm + Ly.b1, *b2s = sm + Ly.b2, *bos = sm + Ly.bo;
  float *outp = sm + Ly.outp, *hz = sm + Ly.hz, *headv = sm + Ly.headv;
  float* scr = sm + Ly.scratch;
  const int js1 = Ly.js1, js2 = Ly.js2, k2 = Ly.k2, j1 = rank * js1, j2 = rank * js2;
  const int OP = Ly.op;
  auto sync_group = [&]() {
    if (c == 1) __syncthreads();
    else cluster.sync();
  };
  cm::cluster_arrive();  // this block has started

  // the leaves: W1 (D1, S), b1, W2 (D2, D1), b2, then the head: Wo (A, D2)
  // and bo (A) (ddpg, DQN), Wo (2A, D2) and bo (2A) (sac), plus W4 (1, D2)
  // and b4 (dqn_duel) or W4 (A, D2) and b4 (A) (modsac): rows >= A of the
  // head's output come from W4 (from Wo's second half for sac)
  const float* W1 = flat;
  const float* W2 = W1 + D1 * S + D1;
  const float* Wo = W2 + D2 * D1 + D2;
  const float* bo = Wo + (HEAD == HEAD_SAC ? 2 : 1) * A * D2;
  const float* W4 = HEAD == HEAD_SAC ? Wo + A * D2 : bo + A;
  const float* b4 = HEAD == HEAD_SAC ? bo + A : W4 + (O - A) * D2;
  const int ld1 = cm::wld<BF>(S), ld2 = ST ? round32(D1) : cm::wld<BF>(k2),
            ldo = cm::wld<BF>(js2);
  const WT* w2s = ST ? w2g + (size_t)j2 * ld2 : wt(Ly.w2);  // this block's rows of W2
  cm::load_rows<true>(W1, D1, S, j1, js1, 0, S, w1s, ld1);
  cm::load_vec<true>(W1 + D1 * S, D1, j1, js1, b1s);
  if constexpr (!ST) cm::load_rows<true>(W2, D2, D1, j2, js2, 0, k2, wt(Ly.w2), ld2);
  cm::load_vec<true>(W2 + D2 * D1, D2, j2, js2, b2s);
  cm::load_rows<true>(Wo, A, D2, 0, A, j2, js2, wos, ldo);
  cm::load_rows<true>(W4, O - A, D2, 0, OP - A, j2, js2, wos + A * ldo, ldo);
  cm::cp_async_commit();
  for (int i = threadIdx.x; i < OP; i += cm::THREADS)
    bos[i] = i < A ? __ldg(bo + i) : (i < O ? __ldg(b4 + i - A) : 0.f);
  for (int i = threadIdx.x; i < (Ly.s4 - S) * G; i += cm::THREADS) cm::st1(xn + S * G + i, 0.f);

  // warp 0 holds the env rows of the group's lanes (every block of the cluster)
  const int e = threadIdx.x;  // the lane of a warp-0 thread
  const bool w0 = threadIdx.x < G;
  const int n = grp * G + (threadIdx.x & (G - 1));
  const bool live = w0 && n < N;
  float f[F];
#pragma unroll
  for (int k = 0; k < F; ++k) f[k] = 0.f;
  int tc = 0;
  if (live) {
#pragma unroll
    for (int k = 0; k < F; ++k) f[k] = env_f[(size_t)k * N + n];
    tc = env_i[n];
  }
  uint2 key = make_uint2(0u, 0u);
  if (noise == nullptr) key = make_uint2((uint32_t)seed[0], (uint32_t)seed[1]);

  // warp 0: the obs of step t (rounded to bf16 first when quant) into xn;
  // rank 0 stores it
  auto observe = [&](int t) {
    float x[S];
    body.obs(f, x);
#pragma unroll
    for (int s = 0; s < S; ++s) {
      if (quant) x[s] = cm::bf16_round(x[s]);
      cm::st1(xn + s * G + e, live ? x[s] : 0.f);
      if (live && rank == 0) {
        const size_t i = ((size_t)t * N + n) * S + s;
        if (quant) cm::st1((__nv_bfloat16*)states_o + i, x[s]);
        else ((float*)states_o)[i] = x[s];
      }
    }
  };
  // threads from `first` on: step t's head words and env uniforms, drawn
  // (Philox, counter (lane, step, j / 4, 0)) or copied from the noise rows
  auto prepare = [&](int t, int first) {
    const int i0 = (int)threadIdx.x - first, nth = cm::THREADS - first;
    if (i0 < 0) return;
    float* hr = sm + Ly.hraw + (t & 1) * Ly.nh4 * G;
    float* ue = sm + Ly.uenv + (t & 1) * Ly.ne4 * G;
    if (noise == nullptr) {
      for (int i = i0; i < NB * G; i += nth) {
        const int b = i / G, e2 = i % G;
        const uint4 q = philox4x32_10(
            make_uint4((uint32_t)(grp * G + e2), (uint32_t)t, (uint32_t)b, 0u), key);
        const float w[4] = {uniform24(q.x), uniform24(q.y), uniform24(q.z), uniform24(q.w)};
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int j = 4 * b + k;
          if (j < N_HEAD) hr[j * G + e2] = w[k];
          else if (j < N_HEAD + N_ENV) ue[(j - N_HEAD) * G + e2] = w[k];
        }
      }
    } else {
      for (int i = i0; i < NZ * G; i += nth) {
        const int r = i / G, e2 = i % G, n2 = grp * G + e2;
        const float v = n2 < N ? noise[((size_t)t * NZ + r) * N + n2] : 0.f;
        if (r < N_HEAD_INJ) hr[r * G + e2] = v;
        else ue[(r - N_HEAD_INJ) * G + e2] = v;
      }
    }
  };
  if (w0 && H > 0) observe(0);
  if (H > 0) prepare(0, 0);
  cm::cp_async_wait<0>();
  cm::cluster_wait();  // every block has started: h1 and head-row parts may be pushed

  for (int t = 0; t < H; ++t) {
    __syncthreads();  // step t's obs and noise words (the weights at t = 0)
    // ---- layer 1
    cm::tile_dense<G>(w1s, ld1, xn, Ly.s4, js1, scr, [&](int j, int m0, float4 v) {
      const float b = b1s[j];
      cm::store_cluster(cluster, c, h1, (j1 + j) * G + m0,
                        make_float4(gelu_tanh(v.x + b), gelu_tanh(v.y + b), gelu_tanh(v.z + b),
                                    gelu_tanh(v.w + b)));
    });
    const float* hr = sm + Ly.hraw + (t & 1) * Ly.nh4 * G;
    if constexpr (!DISCRETE) {  // the head's normals: injected, or Box-Muller
      for (int i = threadIdx.x; i < A * G; i += cm::THREADS) {
        const int a = i / G, e2 = i % G;
        hz[i] = noise != nullptr ? hr[i]
                                 : sqrtf(-2.0f * logf(1.0f - hr[i])) *
                                       cosf(TWO_PI_F * hr[(A + a) * G + e2]);
      }
    }
    sync_group();  // every block's rows of h1, in every block
    // ---- layer 2 (the trunk l2, through GELU for the heads that take it)
    cm::tile_dense<G>(w2s, ld2, h1, k2, js2, scr, [&](int j, int m0, float4 v) {
      const float b = b2s[j];
      cm::st4(h2 + j * G + m0,
              GELU2 ? make_float4(gelu_tanh(v.x + b), gelu_tanh(v.y + b), gelu_tanh(v.z + b),
                                  gelu_tanh(v.w + b))
                    : make_float4(v.x + b, v.y + b, v.z + b, v.w + b));
    });
    __syncthreads();
    // ---- this block's part of the head rows
    cm::tile_dense<G>(wos, ldo, h2, js2, OP, scr, [&](int j, int m0, float4 v) {
      cm::store_cluster(cluster, c, outp, (rank * OP + j) * G + m0, v);
    });
    sync_group();  // every block's parts of the head rows, in every block
    for (int i = threadIdx.x; i < O * G; i += cm::THREADS) {
      float v = outp[i];
      for (int q = 1; q < c; ++q) v += outp[q * OP * G + i];
      headv[i] = v + bos[i / G];
    }
    __syncthreads();
    if (w0) {
      if (live) {  // the head's action and the env step
        const float* ue = sm + Ly.uenv + (t & 1) * Ly.ne4 * G;
        float u_env[N_ENV > 0 ? N_ENV : 1];
#pragma unroll
        for (int k = 0; k < N_ENV; ++k) u_env[k] = ue[k * G + e];
        const size_t o = (size_t)t * N + n;
        float env_a[AE];
        if constexpr (DISCRETE) {
          float mean = 0.f, adv = 0.f;
          if (HEAD == HEAD_DQN_DUEL) {
#pragma unroll
            for (int a = 0; a < A; ++a) mean += headv[a * G + e];
            mean /= (float)A;
            adv = headv[A * G + e];
          }
          float best = 0.f;
          int greedy = 0;
#pragma unroll
          for (int a = 0; a < A; ++a) {
            float q = headv[a * G + e];
            if (HEAD == HEAD_DQN_DUEL) q = q - mean + adv;
            if (a == 0 || q > best) {  // strict: the first maximum wins a tie
              best = q;
              greedy = a;
            }
          }
          const int rnd = min((int)floorf(hr[G + e] * (float)A), A - 1);
          const int index = hr[e] < explore_rate ? rnd : greedy;
          if (rank == 0) ((int*)actions_o)[o] = index;
          env_a[0] = (float)index;
        } else {
#pragma unroll
          for (int a = 0; a < A; ++a) {
            const float z = hz[a * G + e];
            float act;
            if constexpr (SAC) {
              const float log_std = clampf(headv[(A + a) * G + e], std_lo, std_hi);
              act = tanhf(headv[a * G + e] + expf(log_std) * z);
            } else {
              act = clampf(tanhf(headv[a * G + e]) + noise_std * z, -1.0f, 1.0f);
            }
            if (rank == 0) {
              if (quant) cm::st1((__nv_bfloat16*)actions_o + o * A + a, act);
              else ((float*)actions_o)[o * A + a] = act;
            }
            env_a[a] = act;
          }
        }
        float reward;
        bool terminal, trunc;
        body.step(f, tc, env_a, u_env, reward, terminal, trunc);
        if (rank == 0) {
          rew_o[o] = reward * reward_scale;
          term_o[o] = terminal ? 1.0f : 0.0f;
          trunc_o[o] = trunc ? 1.0f : 0.0f;
        }
        if (terminal || trunc) {  // masked reset from the reset uniforms
          body.reset(f, u_env + Body::N_STEP);
          tc = 0;
        }
      }
      if (t + 1 < H) observe(t + 1);  // the next obs tile
    } else if (t + 1 < H) {
      prepare(t + 1, 32);  // the other warps, meanwhile
    }
  }
  if (rank == 0 && live) {  // the final env rows
#pragma unroll
    for (int k = 0; k < F; ++k) env_f_o[(size_t)k * N + n] = f[k];
    env_i_o[n] = tc;
  }
}

template <class Body, int HEAD, bool BF, int ST>
int offpolicy_smem(int D1, int D2, int c) {
  return (int)sizeof(float) * off_layout<Body, HEAD, BF, ST>(D1, D2, c).floats;
}

// The cluster size for N lanes (pick_cluster): one block an SM first, as a
// step's latency, not the card's throughput, sets the time (two blocks on
// an SM measured up to 1.8x slower).
template <class Body, int HEAD, bool BF, int ST>
int offpolicy_cluster(int N, int D1, int D2, int cluster) {
  constexpr int G = narrow_lanes(OFF_LANES, ST);
  return pick_cluster<offpolicy_rollout_kernel<Body, HEAD, BF, ST>>(
      (N + G - 1) / G, cluster,
      [=](int c) { return offpolicy_smem<Body, HEAD, BF, ST>(D1, D2, c); }, true);
}

template <class Body, int HEAD, bool BF, int ST>
int launch_offpolicy(const void* flat, const void* env_f, const void* env_i,
                     const void* noise, const void* seed, void* states, void* actions,
                     void* rew, void* term, void* trunc, void* env_f_o, void* env_i_o, int N,
                     int H, int D1, int D2, float reward_scale, float noise_std,
                     float explore_rate, float std_lo, float std_hi, int cluster, int quant,
                     const void* w2, cudaStream_t stream) {
  if (N == 0) return 0;
  const int c = offpolicy_cluster<Body, HEAD, BF, ST>(N, D1, D2, cluster);
  if (c == 0) {
    const cudaError_t err = cudaGetLastError();
    return (int)(err != cudaSuccess ? err : cudaErrorInvalidValue);
  }
  const int smem = offpolicy_smem<Body, HEAD, BF, ST>(D1, D2, c);
  const cudaError_t err = allow_smem<offpolicy_rollout_kernel<Body, HEAD, BF, ST>>(smem);
  if (err != cudaSuccess) return (int)err;
  const int groups = (N + narrow_lanes(OFF_LANES, ST) - 1) / narrow_lanes(OFF_LANES, ST);
  return (int)cm::launch_clusters(
      offpolicy_rollout_kernel<Body, HEAD, BF, ST>, groups * c, c, smem, stream, Body{},
      (const float*)flat, (const float*)env_f, (const int*)env_i, (const float*)noise,
      (const int*)seed, states, actions, (float*)rew, (float*)term, (float*)trunc,
      (float*)env_f_o, (int*)env_i_o, N, H, D1, D2, reward_scale, noise_std, explore_rate,
      std_lo, std_hi, quant, (const cm::elem_t<BF>*)w2);
}

// ------------------------------------------------------------ critic pass
// The stock body's second kernel (replaces the critic half of
// elegantrl_tpu/ops/pallas_rollout.py:600 _make_kernel with make_stock_body
// :451, called at :829): val = mlp(cri, (x - avg) / (std + 1e-4)) over the
// rollout's stored (H, S, N) states.
//
// Precondition: the lanes of a group of TE = 32 (n / 32 equal) share the
// step's market rows (rows S_LANE .. S - 1): every env starts at day 0 and
// ends at the shared last day, so the stock rollouts' stored states always
// meet it (the kernels and the plain body read the day of a group's first
// lane, ops/fused_rollout.py:block_day).  W1's 135 market columns are
// applied once per (step, group), to the group's first lane, and each
// sample applies only its 16 lane columns, layer 2 and the value head.
//
// Bound: operations, 2 (16 D1 + D1 D2 + D2) FLOP a sample plus 2 (135 D1)
// a (step, group); on the tensor cores in split-3xTF32, three TF32 products
// of the layers' FLOP.
//
// Design: a GEMM over M = H N samples on the tensor cores.  A persistent
// block (one or two an SM) takes tiles of CT = 128 samples of one step
// (lanes n0 .. n0 + 127, four groups; 64 samples, two groups, where the
// first width is too wide for the 128-sample h1 tile: critic_tile):
// - the tile's lane rows, normalised, into shared memory (samples x 16),
//   and each group's normalised market rows (from its first lane);
// - W1's market columns times each group's rows (8 threads a row of W1,
//   four groups each, summed in a fixed tree), once per (step, group);
// - layer 1's lane columns and layer 2 with mma.sync m16n8k8 in TF32, each
//   f32 operand split into a TF32 high part and a TF32 residual and three
//   products summed in f32 (lo x hi, hi x lo, hi x hi), which keeps f32
//   accuracy; 8 warps as CT / 32 (samples) x 256 / CT (features), a warp
//   32 samples of a 64-feature chunk;
// - W2 is streamed in K-tiles of 64 features x 32 inputs through a
//   two-stage cp.async ring (the next tile's first stage in flight during
//   the tile's own first layer); W1's lane columns, the biases and the
//   value head stay in shared memory;
// - layer 2's epilogue applies GELU and the value head's weights and sums
//   each sample's row in a fixed order, so a launch is deterministic.
// Widths are padded with zeros to multiples of 64 (a GELU of 0 is 0).
// The streamed design (tiles of CT_STREAM = 32 samples, where the 64-sample
// tile does not fit a block) streams W1's lane columns through the same
// ring, one 64-feature chunk a stage ahead of W2's stages, so shared memory
// holds no weight matrix and only h1 grows with the first width: the same
// products in the same order.  Past that, tiles of CT_NARROW = 16 samples
// (half a group): each warp one m16 row of fragments instead of two, the
// same eight feature warps, so the same products in the same order again.
// No narrower tile: an m16 fragment reads 16 rows of h1, so a tile of 8
// samples would hold as much h1 as one of 16.
constexpr int CNC = 64;   // features a chunk of a product's outputs
constexpr int CKT = 32;   // inputs a K-tile of W2
constexpr int CLD = StockBody::S_LANE + 4;  // row stride of the lane rows and W1's lane columns
constexpr int CKLD = CKT + 4;               // row stride of a W2 K-tile
constexpr int CT_STREAM = 32;               // samples a tile of the streamed design
constexpr int CT_NARROW = 16;               // samples a tile of its narrower design

__host__ __device__ constexpr int round64(int n) { return (n + 63) / 64 * 64; }

// Shared memory of one critic-pass block (floats), tiles of CT samples: W1's
// lane columns (D1p rows), b1, b2 and the value head's weights, the W2
// ring, the tile's lane rows, the groups' market rows (the CT / TE groups'
// values of a row side by side) and market products, h1 (CT x D1p) and the
// value partials of the feature warps; st (the streamed design): no W1 lane
// columns.
struct CriticLayout {
  int d1p, d2p, w1l, b1, b2, wo, ring, xl, xm, mk, h1, vpart, floats;
  __host__ __device__ CriticLayout(int D1, int D2, int CT, int st) {
    const int NM = StockBody::S - StockBody::S_LANE, NQ = max(CT / TE, 1);
    d1p = round64(D1);
    d2p = round64(D2);
    int o = 0;
    w1l = o; o += (1 - st) * d1p * CLD;
    b1 = o; o += d1p;
    b2 = o; o += d2p;
    wo = o; o += d2p;
    ring = o; o += 2 * CNC * CKLD;
    xl = o; o += CT * CLD;
    xm = o; o += cm::round4(NQ * NM);
    mk = o; o += NQ * d1p;
    h1 = o; o += CT * (d1p + 4);
    vpart = o; o += 8 * TE;
    floats = o;
  }
};

__device__ __forceinline__ uint32_t tf32_bits(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}
// x as a TF32 high part and the TF32 residual
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_bits(x);
  lo = tf32_bits(x - __uint_as_float(hi));
}
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// acc[mt][nt] += X[m0 + 16 mt .. ][k0 .. k0 + 8) W[n0 + 8 nt ..][k0 .. k0 + 8)^T
// in split-3xTF32 for a warp's 16 MT samples x 8 NT features: X is (samples,
// inputs) with row stride ldx, W (features, inputs) with row stride ldw;
// the mma.sync m16n8k8 fragments (g = lane / 4, q = lane % 4): A (g, q),
// (g + 8, q), (g, q + 4), (g + 8, q + 4); B (k = q, n = g), (q + 4, g).
template <int NT, int MT = 2>
__device__ __forceinline__ void mma_k8(float (&acc)[MT][NT][4], const float* X, int ldx,
                                       const float* W, int ldw, int k0) {
  const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
  uint32_t ah[MT][4], al[MT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    const float* x = X + (16 * mt + g) * ldx + k0 + q;
    split_tf32(x[0], ah[mt][0], al[mt][0]);
    split_tf32(x[8 * ldx], ah[mt][1], al[mt][1]);
    split_tf32(x[4], ah[mt][2], al[mt][2]);
    split_tf32(x[8 * ldx + 4], ah[mt][3], al[mt][3]);
  }
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const float* w = W + (8 * nt + g) * ldw + k0 + q;
    uint32_t bh[2], bl[2];
    split_tf32(w[0], bh[0], bl[0]);
    split_tf32(w[4], bh[1], bl[1]);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      mma_tf32(acc[mt][nt], al[mt], bh);
      mma_tf32(acc[mt][nt], ah[mt], bl);
      mma_tf32(acc[mt][nt], ah[mt], bh);
    }
  }
}

// bf16 pairs (lo, hi) in one register, lo in the low half: the operands of
// mma.sync m16n8k16 rounded to the nearest bf16
__device__ __forceinline__ uint32_t bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// mma_k8's product over 16 inputs k0 .. k0 + 16 in bf16 (the bf16 variant):
// the f32 operands in shared memory are rounded to bf16 as the fragments are
// built, one m16n8k16 product each (exact products, f32 sums).  Fragments
// (g = lane / 4, q = lane % 4): A rows g and g + 8 at inputs 2q, 2q + 1 and
// 2q + 8, 2q + 9; B (k = 2q, 2q + 1 and 2q + 8, 2q + 9; n = g).
template <int NT, int MT = 2>
__device__ __forceinline__ void mma_k16(float (&acc)[MT][NT][4], const float* X, int ldx,
                                        const float* W, int ldw, int k0) {
  const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
  uint32_t a[MT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    const float* x = X + (16 * mt + g) * ldx + k0 + 2 * q;
    const float2 x0 = *reinterpret_cast<const float2*>(x);
    const float2 x1 = *reinterpret_cast<const float2*>(x + 8 * ldx);
    const float2 x2 = *reinterpret_cast<const float2*>(x + 8);
    const float2 x3 = *reinterpret_cast<const float2*>(x + 8 * ldx + 8);
    a[mt][0] = bf16x2(x0.x, x0.y);
    a[mt][1] = bf16x2(x1.x, x1.y);
    a[mt][2] = bf16x2(x2.x, x2.y);
    a[mt][3] = bf16x2(x3.x, x3.y);
  }
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const float* w = W + (8 * nt + g) * ldw + k0 + 2 * q;
    const float2 w0 = *reinterpret_cast<const float2*>(w);
    const float2 w1 = *reinterpret_cast<const float2*>(w + 8);
    const uint32_t b[2] = {bf16x2(w0.x, w0.y), bf16x2(w1.x, w1.y)};
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) mma_bf16(acc[mt][nt], a[mt], b);
  }
}

// BF: the bf16 variant (the JAX kernel's _bf16_dot): each product's operands
// rounded to bf16 (W1, the normalised rows, h1, W2, the value head's weights
// and the GELU of layer 2) with f32 sums, the lane columns and layer 2 one
// mma.sync m16n8k16 where the f32 pass issues three m16n8k8 in TF32; the
// market columns on the CUDA cores from rounded operands.  sbf: the stored
// states are bf16 (storage_dtype bfloat16; already rounded, read as they
// are).
template <int CT, bool BF>
__global__ void __launch_bounds__(cm::THREADS, 2)
critic_values_kernel(const float* __restrict__ cri_flat, const float* __restrict__ norm_avg,
                     const float* __restrict__ norm_std, const void* __restrict__ states,
                     float* __restrict__ val, int N, int H, int D1, int D2, int sbf) {
  constexpr int S = StockBody::S, L = StockBody::S_LANE, NM = S - L;
  constexpr int NQ = CT >= TE ? CT / TE : 1;  // the groups a tile meets
  constexpr int MT = CT >= 32 ? 2 : 1;        // a warp's m16 rows of fragments
  constexpr int WM = CT >= 32 ? CT / 32 : 1, WN = 8 / WM;  // warps across the samples; the features
  constexpr int FW = CNC / WN, NT = FW / 8;  // a warp's features of a chunk, n8 tiles
  constexpr bool ST = CT <= CT_STREAM;       // the streamed designs
  const CriticLayout Ly(D1, D2, CT, ST);
  const int d1p = Ly.d1p, d2p = Ly.d2p, ldh = d1p + 4;
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  float *w1l = sm + Ly.w1l, *b1 = sm + Ly.b1, *b2 = sm + Ly.b2, *wo = sm + Ly.wo;
  float *ring = sm + Ly.ring, *xl = sm + Ly.xl, *xm = sm + Ly.xm, *mk = sm + Ly.mk;
  float *h1 = sm + Ly.h1, *vpart = sm + Ly.vpart;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
  const int wm = warp % WM, wn = warp / WM;  // the warp's 32 samples and FW features of a chunk

  // the leaves: W1 (D1, S), b1, W2 (D2, D1), b2, Wo (1, D2), bo
  const float* W1 = cri_flat;
  const float* W2 = W1 + D1 * S + D1;
  const float* Wo = W2 + D2 * D1 + D2;
  const float bo = __ldg(Wo + D2);
  auto opnd = [](float x) { return BF ? cm::bf16_round(x) : x; };
  // stored state (t, row k, lane n)
  auto state = [&](int t, int k, int n) {
    const size_t i = ((size_t)t * S + k) * N + n;
    return sbf ? __bfloat162float(((const __nv_bfloat16*)states)[i]) : ((const float*)states)[i];
  };
  if constexpr (!ST) cm::load_rows<false>(W1, D1, S, 0, d1p, 0, L, w1l, CLD);
  cm::load_vec<false>(W1 + D1 * S, D1, 0, d1p, b1);
  cm::load_vec<false>(W2 + D2 * D1, D2, 0, d2p, b2);
  cm::load_vec<false>(Wo, D2, 0, d2p, wo);

  const int per_step = (N + CT - 1) / CT;
  const long long tiles = (long long)H * per_step;
  // the ring's stages a tile: (ST) W1's lane columns of each 64-feature
  // chunk, then W2's (chunk, K-tile) stages
  const int kts = d1p / CKT, s1 = ST ? d1p / CNC : 0, stages = s1 + (d2p / CNC) * kts;
  // stage s of a tile into ring slot b: W1's lane columns of chunk s (s <
  // s1), else W2's chunk u / kts, K-tile u % kts (u = s - s1)
  auto issue = [&](int s, int b) {
    float* dst = ring + b * CNC * CKLD;
    if (s < s1) {
      cm::load_rows<true>(W1, D1, S, s * CNC, CNC, 0, L, dst, CKLD);
    } else {
      const int u = s - s1;
      cm::load_rows<true>(W2, D2, D1, (u / kts) * CNC, CNC, (u % kts) * CKT, CKT, dst, CKLD);
    }
    cm::cp_async_commit();
  };
  int slot = 0;  // the ring slot of the next stage to compute
  if ((long long)blockIdx.x < tiles) issue(0, 0);
  // stage s: the next stage (or the next tile's first) in flight, stage s in
  // its slot for every thread; end_stage frees the slot
  auto begin_stage = [&](int s, bool more) {
    if (s + 1 < stages) issue(s + 1, slot ^ 1);
    else if (more) issue(0, slot ^ 1);  // the next tile's first stage
    if (s + 1 < stages || more) cm::cp_async_wait<1>();
    else cm::cp_async_wait<0>();
    __syncthreads();
  };
  auto end_stage = [&]() {
    __syncthreads();  // the slot is free for stage s + 2
    slot ^= 1;
  };

  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int t = (int)(tile / per_step), n0 = (int)(tile % per_step) * CT;
    const bool more = tile + gridDim.x < tiles;
    __syncthreads();  // the previous tile's reads of xl, xm, mk and h1; the weights
    // ---- the tile's normalised lane rows, and each group's market rows
    for (int i = threadIdx.x; i < L * CT; i += cm::THREADS) {
      const int k = i / CT, m = i % CT, n = n0 + m;
      xl[m * CLD + k] =
          n < N ? (state(t, k, n) - __ldg(norm_avg + k)) / (__ldg(norm_std + k) + 1e-4f) : 0.f;
    }
    for (int i = threadIdx.x; i < NQ * NM; i += cm::THREADS) {
      const int r = i / NQ, grp = i % NQ, n = n0 + grp * TE;
      xm[i] = n < N ? opnd((state(t, L + r, n) - __ldg(norm_avg + L + r)) /
                           (__ldg(norm_std + L + r) + 1e-4f))
                    : 0.f;
    }
    __syncthreads();
    // ---- W1's market columns times each group's rows: 8 threads a row,
    // each its 17 columns for the NQ groups, then a fixed tree
    for (int i = threadIdx.x; i < d1p * 8; i += cm::THREADS) {
      const int j = i >> 3, p = i & 7;
      float v[NQ];
#pragma unroll
      for (int k = 0; k < NQ; ++k) v[k] = 0.f;
      if (j < D1) {
        const float* w = W1 + (size_t)j * S + L;
#pragma unroll
        for (int u = 0; u < (NM + 7) / 8; ++u) {
          const int r = p + 8 * u;
          if (r < NM) {
            const float wv = opnd(__ldg(w + r));
#pragma unroll
            for (int k = 0; k < NQ; ++k) v[k] = fmaf(wv, xm[r * NQ + k], v[k]);
          }
        }
      }
#pragma unroll
      for (int k = 0; k < NQ; ++k) {
        v[k] += __shfl_xor_sync(0xffffffffu, v[k], 4);
        v[k] += __shfl_xor_sync(0xffffffffu, v[k], 2);
        v[k] += __shfl_xor_sync(0xffffffffu, v[k], 1);
      }
      if (p == 0) {
#pragma unroll
        for (int k = 0; k < NQ; ++k) mk[k * d1p + j] = v[k];
      }
    }
    __syncthreads();
    // ---- layer 1: the lane columns on the tensor cores, plus the group's
    // market product and the bias, through GELU into h1 (samples x D1p)
    int s = 0;
    for (int n0c = 0; n0c < d1p; n0c += CNC) {
      float acc[MT][NT][4] = {};
      const float* X = xl + (32 * wm) * CLD;
      if constexpr (ST) begin_stage(s, more);
      const float* W = ST ? ring + slot * CNC * CKLD + (FW * wn) * CKLD
                          : w1l + (n0c + FW * wn) * CLD;
      const int ldw = ST ? CKLD : CLD;
      if constexpr (BF) {
        mma_k16(acc, X, CLD, W, ldw, 0);
      } else {
        mma_k8(acc, X, CLD, W, ldw, 0);
        mma_k8(acc, X, CLD, W, ldw, 8);
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int m = 32 * wm + 16 * mt + g + 8 * h, j = n0c + FW * wn + 8 * nt + 2 * q;
            const float* mkq = mk + (m / TE) * d1p;
            float2 out;
            out.x = gelu_tanh((acc[mt][nt][2 * h] + mkq[j]) + b1[j]);
            out.y = gelu_tanh((acc[mt][nt][2 * h + 1] + mkq[j + 1]) + b1[j + 1]);
            *reinterpret_cast<float2*>(h1 + m * ldh + j) = out;
          }
      if constexpr (ST) {
        end_stage();
        ++s;
      }
    }
    // ---- layer 2 over the W2 ring, GELU and the value head's weights
    float vrow[MT][2] = {};  // this thread's samples (mt, h): its features' terms
    for (int chunk = 0; chunk < d2p / CNC; ++chunk) {
      float acc[MT][NT][4] = {};
      for (int kt = 0; kt < kts; ++kt, ++s) {
        begin_stage(s, more);  // h1 too at W2's first stage
        const float* X = h1 + (32 * wm) * ldh + kt * CKT;
        const float* W = ring + slot * CNC * CKLD + (FW * wn) * CKLD;
        if constexpr (BF) {
#pragma unroll
          for (int k16 = 0; k16 < CKT; k16 += 16) mma_k16(acc, X, ldh, W, CKLD, k16);
        } else {
#pragma unroll
          for (int k8 = 0; k8 < CKT; k8 += 8) mma_k8(acc, X, ldh, W, CKLD, k8);
        }
        end_stage();
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int j = chunk * CNC + FW * wn + 8 * nt + 2 * q;
            vrow[mt][h] =
                fmaf(opnd(wo[j]), opnd(gelu_tanh(acc[mt][nt][2 * h] + b2[j])), vrow[mt][h]);
            vrow[mt][h] = fmaf(opnd(wo[j + 1]), opnd(gelu_tanh(acc[mt][nt][2 * h + 1] + b2[j + 1])),
                               vrow[mt][h]);
          }
    }
    // a sample's terms: the 4 threads of its row (fixed tree), then the WN
    // feature warps in order, plus the bias
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float v = vrow[mt][h];
        v += __shfl_xor_sync(0xffffffffu, v, 1);
        v += __shfl_xor_sync(0xffffffffu, v, 2);
        if (q == 0) vpart[wn * CT + 32 * wm + 16 * mt + g + 8 * h] = v;
      }
    __syncthreads();
    for (int m = threadIdx.x; m < CT; m += cm::THREADS) {
      float v = vpart[m];
      for (int w = 1; w < WN; ++w) v += vpart[w * CT + m];
      if (n0 + m < N) val[(size_t)t * N + n0 + m] = v + bo;
    }
  }
}

// The critic pass's tile: 128 samples where its layout fits a block, else 64
// (a first width past 320), else the streamed design's 32 (past 576), else
// its narrower 16 (past 1408).
constexpr int SMEM_BLOCK = 232448;
inline int critic_tile(int D1, int D2) {
  for (int ct : {128, 64})
    if ((int)sizeof(float) * CriticLayout(D1, D2, ct, 0).floats <= SMEM_BLOCK) return ct;
  if ((int)sizeof(float) * CriticLayout(D1, D2, CT_STREAM, 1).floats <= SMEM_BLOCK)
    return CT_STREAM;
  return CT_NARROW;
}
int critic_smem(int D1, int D2) {
  const int ct = critic_tile(D1, D2);
  return (int)sizeof(float) * CriticLayout(D1, D2, ct, ct <= CT_STREAM).floats;
}

// ------------------------------------------------- K4: the stock actor
// The on-policy stock rollout's actor kernel (HEAD_PPO: replaces the actor
// half of pallas_rollout.py:_make_kernel :600 with make_stock_body :451; the
// critic runs afterwards in critic_values_kernel).  The function is that of
// fused_rollout_kernel<StockBody> without the critic: the same outputs, the
// same Philox bits, the same trade loop with its _rn intrinsics.  With
// HEAD_DDPG, HEAD_SAC or HEAD_MODSAC it is the off-policy exploration
// rollout on the stock body (replaces _make_offpolicy_kernel :1006 with
// make_stock_body): no normalisation, no logprob, the head's rule of
// offpolicy_rollout_kernel, the outputs in the replay buffer's (H, N, dim)
// layout; the noise (A normals or 2A head uniforms, then the reset's) is
// the same.
//
// Bound: operations.  The work the function needs per step and group of
// TE = 32 lanes is the actor's per-lane rows, 2 TE (L D1 + D1 D2 + D2 A)
// FLOP, plus W1's market columns once, 2 (S - L) D1: the day, and so the
// S - L = 135 market rows of the obs, is the same on every lane of a group
// (every env starts at day 0 and ends at the shared last day; the JAX
// kernel relies on it too, pallas_rollout.py:466-469).
//
// What held the first design back (fused_rollout_kernel<StockBody, false>,
// one 8-warp block per 32 lanes, 205,756 B, ~61 us a step): 8 of 132 SMs at
// 256 envs and 8 warps an SM at 4096; layer 1 applied the market rows on
// every lane (46% of the FMA); `dense` issued one shared load per FMA; warp
// 0 drew 12 Philox blocks, 15 Box-Muller pairs and 15 tanhf per lane while
// seven warps waited.  This design:
// - A group of 32 lanes runs on a cluster of c blocks (c = 8, 4, 2 or 1:
//   the largest whose clusters all fit on the card at once, so 256 envs take
//   64 SMs and 4096 envs two blocks an SM).  Block r owns 1/c of W1's and
//   W2's rows and of Wo's columns (cluster_mlp.cuh); every block runs the
//   env step of all 32 lanes on its warp 0 from the same inputs, so the
//   blocks agree bit for bit and only rank 0 stores per-lane outputs.
// - Per step: W1's market columns times the day's normalised market rows
//   (8 threads a row, read through L1/L2, summed in a fixed tree) once per
//   block; the lanes' 16 rows through tile_dense; each block's rows of h1
//   pushed into every block (distributed shared memory stores) before a
//   cluster barrier; h2; the head's part of the mean pushed likewise; the
//   parts added in rank order after the second barrier.
// - The head's 8 Philox blocks a lane and its Box-Muller, and the lanes'
//   obs rows (tanh and normalisation), run on all warps into shared memory;
//   the reset's 5 blocks are drawn only on a lane that resets (counter
//   (lane, step, j / 4, 0): the same bits).  Warp 0 runs only the
//   sequential trade loop, from the next day's close prices in shared
//   memory, while the other warps fetch the next step's market rows and
//   prices and draw its uniforms.
// Sums run in another order than fused_rollout_kernel's, so an action can
// differ in its last bit (and a lot at a lot edge: chip_smoke.py's
// k4_vs_plain); a launch is deterministic for a given N.

constexpr int STOCK_STREAM_KS = 2;  // split-K parts at most, streamed stock actor

// Shared memory of one block (floats), clusters of c: the weight slices row
// by row (W1's rows at the lane columns, W2's rows, Wo's columns:
// cluster_mlp.cuh) and biases, exp(std_log), the day's normalised market
// rows and W1's market columns times them, the next day's close prices (two
// steps' worth), then (rows, TE) tiles: the lanes' raw and normalised obs
// rows, the whole h1, this block's rows of h2, every block's part of the
// mean, the head's uniforms and normals, the env actions, and the split-K
// scratch; (rows, G) for the narrower streamed groups of G lanes.  With bf
// (bf16 compute) the weight slices and the tiles xl, h1 and h2 hold bf16
// values (cm::wrow, cm::vals); with st (the streamed
// design) W2's slice is not held (it is read from the stream_weights copy)
// and the scratch is only as large as the products need.
struct StockActorLayout {
  int js1, js2, k2, w1l, b1, w2, b2, wo, bo, stdv, xm, msm, pnext, xraw, xl, h1, h2, outp, ubuf,
      zbuf, ea, scratch, floats;
  // OP: the head's output rows rounded to 4 (A, or 2A for the SAC heads)
  __host__ __device__ StockActorLayout(int D1, int D2, int c, int OP, int bf, int st,
                                        int G = TE) {
    constexpr int L = StockBody::S_LANE, AP = cm::round4(StockBody::A);
    js1 = cm::slice(D1, c);
    js2 = cm::slice(D2, c);
    k2 = c * js1;
    int o = 0;
    w1l = o; o += js1 * cm::wrow(L, bf);
    b1 = o; o += js1;
    w2 = o; o += (1 - st) * js2 * cm::wrow(k2, bf);
    b2 = o; o += js2;
    wo = o; o += OP * cm::wrow(js2, bf);
    bo = o; o += OP;
    stdv = o; o += AP;
    xm = o; o += cm::round4(StockBody::S - L);
    msm = o; o += js1;
    pnext = o; o += 2 * cm::round4(StockBody::NS);
    xraw = o; o += L * G;
    xl = o; o += cm::vals(L * G, bf);
    h1 = o; o += cm::vals(k2 * G, bf);
    h2 = o; o += cm::vals(js2 * G, bf);
    outp = o; o += c * OP * G;
    ubuf = o; o += 32 * G;
    zbuf = o; o += AP * G;
    ea = o; o += AP * G;
    // the split-K scratch: cm::SCRATCH, or (st) what the block's three
    // products take in at most STOCK_STREAM_KS parts, which lets the widest
    // nets fit
    scratch = o;
    o += st * cm::round4(max(max(tile_scratch(L, js1, G, STOCK_STREAM_KS),
                                 tile_scratch(k2, js2, G, STOCK_STREAM_KS)),
                             tile_scratch(js2, OP, G, STOCK_STREAM_KS))) +
         (1 - st) * cm::SCRATCH;
    floats = o;
  }
};

template <int HEAD>
__host__ __device__ constexpr int stock_out_rows() {
  return cm::round4(sac_head(HEAD) ? 2 * StockBody::A : StockBody::A);
}

// BF and quant as for fused_rollout_kernel (_bf16_dot and the quantised
// store of pallas_rollout.py:_make_kernel :600 and _make_offpolicy_kernel
// :1006): under BF the weight slices, the lanes' normalised rows, h1 and h2
// are bf16, the day's normalised market rows are rounded to bf16 once a
// step and W1's market columns as they are read, every product summed in
// f32; under quant the obs (lane and market rows) is rounded to bf16 before
// it is normalised and acted on and stored as bf16, and the off-policy
// heads store their actions as bf16 (the env steps on the f32 action).
// ST: the streamed design, W2 read from w2g (stream_weights) as in
// fused_rollout_kernel.
template <int HEAD, bool BF, int ST>
__global__ void __launch_bounds__(cm::THREADS, 2)
stock_actor_kernel(const StockBody body, const float* __restrict__ act_flat,
                   const float* __restrict__ norm_avg, const float* __restrict__ norm_std,
                   const float* __restrict__ env_f, const int* __restrict__ env_i,
                   const float* __restrict__ noise, const int* __restrict__ seed,
                   void* __restrict__ states_o, void* __restrict__ actions_o,
                   float* __restrict__ logp_o, float* __restrict__ rew_o,
                   float* __restrict__ term_o, float* __restrict__ trunc_o,
                   float* __restrict__ env_f_o, int* __restrict__ env_i_o, int N, int H, int D1,
                   int D2, float reward_scale, float noise_std, float std_lo, float std_hi,
                   int quant, const cm::elem_t<BF>* __restrict__ w2g) {
  constexpr int S = StockBody::S, A = StockBody::A, F = StockBody::F, NS = StockBody::NS;
  constexpr int L = StockBody::S_LANE, NM = S - L, AP = cm::round4(A), NP = cm::round4(NS);
  constexpr bool ON = HEAD == HEAD_PPO;              // the on-policy head
  constexpr int OP = stock_out_rows<HEAD>();         // head rows, rounded to 4
  static_assert(ON || HEAD == HEAD_DDPG || sac_head(HEAD), "a continuous head");
  constexpr int N_ENV = StockBody::N_RESET;           // no step uniforms
  constexpr int NZ = A + N_ENV;                       // injected rows
  constexpr int N_HEAD = 2 * A;                       // head uniforms: words 0 .. 29
  constexpr int HB = (N_HEAD + 3) / 4;                // head Philox blocks
  constexpr int RB0 = N_HEAD / 4, RB1 = (N_HEAD + N_ENV + 3) / 4;  // the reset's blocks
  static_assert(4 * HB <= 32, "ubuf holds 32 words a lane");
  constexpr int KS = ST ? STOCK_STREAM_KS : cm::THREADS;  // split-K parts at most
  constexpr int G = narrow_lanes(TE, ST);  // lanes a group: 32, or 16, 8, 4 narrower

  cm::cg::cluster_group cluster = cm::cg::this_cluster();
  const int c = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int grp = blockIdx.x / c;
  const StockActorLayout Ly(D1, D2, c, OP, BF, ST != 0, G);
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  using WT = cm::elem_t<BF>;
  auto wt = [&](int off) { return reinterpret_cast<WT*>(sm + off); };
  WT *w1l = wt(Ly.w1l), *wos = wt(Ly.wo);
  WT *xl = wt(Ly.xl), *h1 = wt(Ly.h1), *h2 = wt(Ly.h2);
  float *b1s = sm + Ly.b1, *b2s = sm + Ly.b2;
  float *bos = sm + Ly.bo, *stdv = sm + Ly.stdv, *xm = sm + Ly.xm;
  float *msm = sm + Ly.msm, *pnext = sm + Ly.pnext, *xraw = sm + Ly.xraw;
  float *outp = sm + Ly.outp, *ubuf = sm + Ly.ubuf;
  float *zbuf = sm + Ly.zbuf, *ea = sm + Ly.ea, *scratch = sm + Ly.scratch;
  const int js1 = Ly.js1, js2 = Ly.js2, j1 = rank * js1, j2 = rank * js2;
  const int ld1 = cm::wld<BF>(L), ld2 = ST ? round32(D1) : cm::wld<BF>(Ly.k2),
            ldo = cm::wld<BF>(js2);
  const WT* w2s = ST ? w2g + (size_t)j2 * ld2 : wt(Ly.w2);  // this block's rows of W2
  // a product's operand as the kernel takes it: rounded to bf16 under BF
  auto opnd = [](float x) { return BF ? cm::bf16_round(x) : x; };
  // an obs value as it is stored and acted on: rounded to bf16 under quant
  auto qobs = [&](float x) { return quant ? cm::bf16_round(x) : x; };
  cm::cluster_arrive();  // this block has started

  // the actor's leaves: W1 (D1, S), b1, W2 (D2, D1), b2, then the head: Wo
  // (A, D2), bo, std_log (on-policy); Wo (A, D2), bo (ddpg); Wo (2A, D2),
  // bo (2A) (sac); Wo (A, D2), bo, Ws (A, D2), bs (modsac)
  const float* W1 = act_flat;
  const float* W2 = W1 + D1 * S + D1;
  const float* Wo = W2 + D2 * D1 + D2;
  const float* std_log = Wo + A * D2 + A;
  cm::load_rows<false>(W1, D1, S, j1, js1, 0, L, w1l, ld1);
  cm::load_vec<false>(W1 + D1 * S, D1, j1, js1, b1s);
  if constexpr (!ST) cm::load_rows<false>(W2, D2, D1, j2, js2, 0, Ly.k2, wt(Ly.w2), ld2);
  cm::load_vec<false>(W2 + D2 * D1, D2, j2, js2, b2s);
  if constexpr (HEAD == HEAD_SAC) {
    cm::load_rows<false>(Wo, 2 * A, D2, 0, OP, j2, js2, wos, ldo);
    cm::load_vec<false>(Wo + 2 * A * D2, 2 * A, 0, OP, bos);
  } else if constexpr (HEAD == HEAD_MODSAC) {
    const float* Ws = Wo + A * D2 + A;
    cm::load_rows<false>(Wo, A, D2, 0, A, j2, js2, wos, ldo);
    cm::load_rows<false>(Ws, A, D2, 0, OP - A, j2, js2, wos + A * ldo, ldo);
    cm::load_vec<false>(Wo + A * D2, A, 0, A, bos);
    cm::load_vec<false>(Ws + A * D2, A, 0, OP - A, bos + A);
  } else {
    cm::load_rows<false>(Wo, A, D2, 0, AP, j2, js2, wos, ldo);
    cm::load_vec<false>(Wo + A * D2, A, 0, AP, bos);
  }
  if constexpr (ON)
    for (int a = threadIdx.x; a < AP; a += blockDim.x) stdv[a] = a < A ? expf(std_log[a]) : 0.f;

  // warp 0 holds the env rows of the group's lanes (every block of the cluster)
  const int e = threadIdx.x;  // the lane of a warp-0 thread
  const bool w0 = threadIdx.x < G;
  const int n = grp * G + (threadIdx.x & (G - 1));
  const bool live = w0 && n < N;
  int day = env_i[grp * G];  // the group's day: its first lane's
  float f[F];
#pragma unroll
  for (int k = 0; k < F; ++k) f[k] = 0.f;
  int tc = 0;
  float log_std_sum = 0.f;
  if (w0) {
    if (live) {
#pragma unroll
      for (int k = 0; k < F; ++k) f[k] = env_f[(size_t)k * N + n];
      tc = env_i[n];
    }
#pragma unroll
    if constexpr (ON)
      for (int a = 0; a < A; ++a) log_std_sum += logf(expf(std_log[a]));
  }
  uint2 key = make_uint2(0u, 0u);
  if (noise == nullptr) key = make_uint2((uint32_t)seed[0], (uint32_t)seed[1]);

  // warp 0: the lanes' rows the next obs reads (all warps turn them into obs)
  auto lane_rows = [&]() {
#pragma unroll
    for (int s = 0; s < L; ++s) xraw[s * G + e] = f[s];
  };
  // store obs row r of lane n2 at step t: (H, S, N) on-policy, (H, N, S)
  // off; bf16 under quant (x is rounded already)
  auto put_state = [&](int t, int r, int n2, float x) {
    const size_t i = ON ? ((size_t)t * S + r) * N + n2 : ((size_t)t * N + n2) * S + r;
    if (quant) cm::st1((__nv_bfloat16*)states_o + i, x);
    else ((float*)states_o)[i] = x;
  };
  // the normalisation of obs row r (on-policy only)
  auto normalise = [&](int r, float x) {
    return ON ? (x - __ldg(norm_avg + r)) / (__ldg(norm_std + r) + 1e-4f) : x;
  };
  // threads from `first` on, for step t on day d: the normalised market rows
  // (stored too, rows r = rank mod c; under BF rounded to bf16 here, once a
  // step), the next day's close prices and the head's uniforms (internal
  // noise)
  auto prepare = [&](int t, int d, int first) {
    const int i0 = (int)threadIdx.x - first, nth = cm::THREADS - first;
    if (i0 < 0) return;
    for (int r = i0; r < NM; r += nth)
      xm[r] = opnd(normalise(L + r, qobs(body.market(d, L + r))));
    for (int k = i0; k < NS; k += nth)
      pnext[(t & 1) * NP + k] = __ldg(body.p.close + (size_t)(d + 1) * NS + k);
    const int mine = (NM - rank + c - 1) / c;
    for (int i = i0; i < mine * G; i += nth) {
      const int r = L + rank + c * (i / G), n2 = grp * G + i % G;
      if (n2 < N) put_state(t, r, n2, qobs(body.market(d, r)));
    }
    if (noise == nullptr) {
      for (int i = i0; i < HB * G; i += nth) {
        const int b = i / G, e2 = i % G;
        const uint4 q = philox4x32_10(
            make_uint4((uint32_t)(grp * G + e2), (uint32_t)t, (uint32_t)b, 0u), key);
        ubuf[(4 * b + 0) * G + e2] = uniform24(q.x);
        ubuf[(4 * b + 1) * G + e2] = uniform24(q.y);
        ubuf[(4 * b + 2) * G + e2] = uniform24(q.z);
        ubuf[(4 * b + 3) * G + e2] = uniform24(q.w);
      }
    }
  };
  if (w0) lane_rows();
  if (H > 0) prepare(0, day, 0);
  cm::cluster_wait();  // every block has started: h1 and the parts may be pushed

  for (int t = 0; t < H; ++t) {
    __syncthreads();  // step t's rows, prices and uniforms; the weights at t = 0
    // W1's market columns times the day's rows: 8 threads a row, each two
    // chains, summed in a fixed tree (js1 is a multiple of 4, so whole warps
    // take part)
    for (int i = threadIdx.x; i < js1 * 8; i += cm::THREADS) {
      const int j = i >> 3, q = i & 7;
      float v0 = 0.f, v1 = 0.f;
      if (j1 + j < D1) {  // a fixed trip count, so every load issues up front
        const float* w = W1 + (size_t)(j1 + j) * S + L;
#pragma unroll
        for (int u = 0; u < (NM + 15) / 16; ++u) {
          const int k = q + 16 * u;
          if (k < NM) v0 = fmaf(opnd(__ldg(w + k)), xm[k], v0);
          if (k + 8 < NM) v1 = fmaf(opnd(__ldg(w + k + 8)), xm[k + 8], v1);
        }
      }
      float v = v0 + v1;
      v += __shfl_xor_sync(0xffffffffu, v, 4);
      v += __shfl_xor_sync(0xffffffffu, v, 2);
      v += __shfl_xor_sync(0xffffffffu, v, 1);
      if (q == 0) msm[j] = v;
    }
    // the lanes' obs rows (stored by rank 0) and the head's normals:
    // injected, or Box-Muller on the Philox uniforms
    for (int i = threadIdx.x; i < (L + A) * G; i += cm::THREADS) {
      const int e2 = i % G, n2 = grp * G + e2;
      if (i < L * G) {
        const int s2 = i / G;
        const float x = qobs(StockBody::obs_row(s2, xraw[i]));
        cm::st1(xl + i, n2 < N ? normalise(s2, x) : 0.f);
        if (rank == 0 && n2 < N) put_state(t, s2, n2, x);
      } else {
        const int a = i / G - L;
        float z = 0.f;
        if (noise != nullptr) {
          if (n2 < N) z = noise[((size_t)t * NZ + a) * N + n2];
        } else {
          z = sqrtf(-2.0f * logf(1.0f - ubuf[a * G + e2])) *
              cosf(TWO_PI_F * ubuf[(A + a) * G + e2]);
        }
        zbuf[a * G + e2] = z;
      }
    }
    __syncthreads();
    cm::tile_dense<G>(w1l, ld1, xl, L, js1, scratch, [&](int j, int m0, float4 v) {
      const float mj = msm[j], b = b1s[j];
      cm::store_cluster(cluster, c, h1, (j1 + j) * G + m0,
                        make_float4(gelu_tanh((mj + v.x) + b), gelu_tanh((mj + v.y) + b),
                                    gelu_tanh((mj + v.z) + b), gelu_tanh((mj + v.w) + b)));
    }, KS);
    cluster.sync();  // every block's rows of h1, in every block
    cm::tile_dense<G>(w2s, ld2, h1, Ly.k2, js2, scratch, [&](int j, int m0, float4 v) {
      const float b = b2s[j];
      cm::st4(h2 + j * G + m0,
              HEAD == HEAD_MODSAC  // ModSAC's heads read the raw trunk
                  ? make_float4(v.x + b, v.y + b, v.z + b, v.w + b)
                  : make_float4(gelu_tanh(v.x + b), gelu_tanh(v.y + b), gelu_tanh(v.z + b),
                                gelu_tanh(v.w + b)));
    }, KS);
    __syncthreads();
    cm::tile_dense<G>(wos, ldo, h2, js2, OP, scratch, [&](int j, int m0, float4 v) {
      cm::store_cluster(cluster, c, outp, (rank * OP + j) * G + m0, v);
    }, KS);
    cluster.sync();  // every block's part of the head rows, in every block
    for (int i = threadIdx.x; i < A * G; i += cm::THREADS) {
      const int a = i / G, n2 = grp * G + i % G;
      float v = outp[i];
      for (int q = 1; q < c; ++q) v += outp[q * OP * G + i];
      if constexpr (ON) {
        const float action = (v + bos[a]) + stdv[a] * zbuf[i];
        ea[i] = tanhf(action);
        if (rank == 0 && n2 < N) ((float*)actions_o)[((size_t)t * A + a) * N + n2] = action;
      } else {
        float act;
        if constexpr (sac_head(HEAD)) {
          float ls = outp[i + A * G];
          for (int q = 1; q < c; ++q) ls += outp[q * OP * G + i + A * G];
          const float log_std = clampf(ls + bos[A + a], std_lo, std_hi);
          act = tanhf((v + bos[a]) + expf(log_std) * zbuf[i]);
        } else {
          act = clampf(tanhf(v + bos[a]) + noise_std * zbuf[i], -1.0f, 1.0f);
        }
        ea[i] = act;
        if (rank == 0 && n2 < N) {
          const size_t o = ((size_t)t * N + n2) * A + a;
          if (quant) cm::st1((__nv_bfloat16*)actions_o + o, act);
          else ((float*)actions_o)[o] = act;
        }
      }
    }
    __syncthreads();
    day = day + 1 >= body.p.T - 1 ? 0 : day + 1;
    if (w0) {
      if (live) {
        float env_a[A], logp = -log_std_sum;
#pragma unroll
        for (int a = 0; a < A; ++a) {
          const float z = zbuf[a * G + e];
          if (ON) logp += -0.5f * z * z - LOG_SQRT_2PI;
          env_a[a] = ea[a * G + e];
        }
        float reward;
        bool terminal, trunc;
        body.step_at(f, tc, pnext + (t & 1) * NP, env_a, reward, terminal, trunc);
        if (rank == 0) {
          const size_t o = (size_t)t * N + n;
          if (ON) logp_o[o] = logp;
          rew_o[o] = reward * reward_scale;
          term_o[o] = terminal ? 1.0f : 0.0f;
          trunc_o[o] = trunc ? 1.0f : 0.0f;
        }
        if (terminal || trunc) {  // masked reset, its uniforms drawn here only
          float u_env[N_ENV];
          if (noise != nullptr) {
#pragma unroll
            for (int k = 0; k < N_ENV; ++k) u_env[k] = noise[((size_t)t * NZ + A + k) * N + n];
          } else {
            float u[4 * (RB1 - RB0)];
#pragma unroll
            for (int b = RB0; b < RB1; ++b) {
              const uint4 q = philox4x32_10(
                  make_uint4((uint32_t)n, (uint32_t)t, (uint32_t)b, 0u), key);
              u[4 * (b - RB0) + 0] = uniform24(q.x);
              u[4 * (b - RB0) + 1] = uniform24(q.y);
              u[4 * (b - RB0) + 2] = uniform24(q.z);
              u[4 * (b - RB0) + 3] = uniform24(q.w);
            }
#pragma unroll
            for (int k = 0; k < N_ENV; ++k) u_env[k] = u[N_HEAD - 4 * RB0 + k];
          }
          body.reset(f, u_env);
          tc = 0;
        }
      }
      lane_rows();
    }
    if (t + 1 < H) prepare(t + 1, day, 32);  // the other warps, meanwhile
  }
  if (live && rank == 0) {
#pragma unroll
    for (int k = 0; k < F; ++k) env_f_o[(size_t)k * N + n] = f[k];
    env_i_o[n] = tc;
  }
}

template <int HEAD, bool BF, int ST>
int stock_actor_smem(int D1, int D2, int c) {
  return (int)sizeof(float) *
         StockActorLayout(D1, D2, c, stock_out_rows<HEAD>(), BF, ST != 0, narrow_lanes(TE, ST))
             .floats;
}

}  // namespace

// The on-policy bodies (KernelEnvBody.kernel_id of ops/fused_rollout.py):
// 0 Pendulum-v1, 1 CartPole-v1, 2 HopperSlip-v0, 3 PointChasingVecEnv,
// 4 PointChasingDiscreteEnv.
#define ELEGANTRL_BODIES(X) X(0, PendulumBody) X(1, CartPoleBody) X(2, HopperBody) \
  X(3, ChasingBody) X(4, ChasingDiscreteBody)

// `variant` of the size, cluster and launch entries below: bit 0 bf16
// compute, bits 1 and up the design ST (0 resident, 1 streamed, 2 and up its
// narrower lane groups; STREAMED of ops/fused_rollout.py is ST 1).
// FN<BF, ST>(args) for the variant; -2 for a variant this library does not
// build: the resident and streamed designs build into onpolicy_rollout.cu
// and offpolicy_rollout.cu, the narrower groups (ST 2 and 3; the stock actor
// also ST 4, ELEGANTRL_STOCK_VARIANT) into onpolicy_narrow.cu and
// offpolicy_narrow.cu (ELEGANTRL_NARROW), four nvcc runs side by side.
#if defined(ELEGANTRL_NARROW)
#define ELEGANTRL_VARIANT(variant, FN, ...)                                          \
  ((variant) == 4   ? FN<false, 2>(__VA_ARGS__)                                      \
   : (variant) == 5 ? FN<true, 2>(__VA_ARGS__)                                       \
   : (variant) == 6 ? FN<false, 3>(__VA_ARGS__)                                      \
   : (variant) == 7 ? FN<true, 3>(__VA_ARGS__)                                       \
                    : -2)
#define ELEGANTRL_STOCK_VARIANT(variant, FN, ...)                                    \
  ((variant) == 8   ? FN<false, 4>(__VA_ARGS__)                                      \
   : (variant) == 9 ? FN<true, 4>(__VA_ARGS__)                                       \
                    : ELEGANTRL_VARIANT(variant, FN, __VA_ARGS__))
#else
#define ELEGANTRL_VARIANT(variant, FN, ...)                                          \
  ((variant) == 0   ? FN<false, 0>(__VA_ARGS__)                                      \
   : (variant) == 1 ? FN<true, 0>(__VA_ARGS__)                                       \
   : (variant) == 2 ? FN<false, 1>(__VA_ARGS__)                                      \
   : (variant) == 3 ? FN<true, 1>(__VA_ARGS__)                                       \
                    : -2)
#define ELEGANTRL_STOCK_VARIANT ELEGANTRL_VARIANT
#endif

template <class Body>
struct OnPolicy {
  template <bool BF, int ST>
  static int smem(int D1, int D2, int c) { return rollout_smem<Body, BF, ST>(D1, D2, c); }
  template <bool BF, int ST>
  static int cluster(int N, int D1, int D2, int k) {
    return rollout_cluster<Body, BF, ST>(N, D1, D2, k);
  }
  template <bool BF, int ST>
  static int go(const void* act_flat, const void* cri_flat, const void* norm_avg,
                const void* norm_std, const void* env_f, const void* env_i, const void* noise,
                const void* seed, void* states, void* actions, void* logp, void* rew,
                void* term, void* trunc, void* val, void* env_f_o, void* env_i_o, int N, int H,
                int D1, int D2, float reward_scale, int cluster, int quant, const void* w2,
                cudaStream_t stream) {
    return launch<Body, BF, ST>(act_flat, cri_flat, norm_avg, norm_std, env_f, env_i, noise,
                                seed, states, actions, logp, rew, term, trunc, val, env_f_o,
                                env_i_o, N, H, D1, D2, reward_scale, cluster, quant, w2, stream);
  }
};
template <class Body, int HEAD>
struct OffPolicy {
  template <bool BF, int ST>
  static int smem(int D1, int D2, int c) { return offpolicy_smem<Body, HEAD, BF, ST>(D1, D2, c); }
  template <bool BF, int ST>
  static int cluster(int N, int D1, int D2, int k) {
    return offpolicy_cluster<Body, HEAD, BF, ST>(N, D1, D2, k);
  }
  template <bool BF, int ST>
  static int go(const void* flat, const void* env_f, const void* env_i, const void* noise,
                const void* seed, void* states, void* actions, void* rew, void* term,
                void* trunc, void* env_f_o, void* env_i_o, int N, int H, int D1, int D2,
                float reward_scale, float noise_std, float explore_rate, float std_lo,
                float std_hi, int cluster, int quant, const void* w2, cudaStream_t stream) {
    return launch_offpolicy<Body, HEAD, BF, ST>(flat, env_f, env_i, noise, seed, states, actions,
                                                rew, term, trunc, env_f_o, env_i_o, N, H, D1, D2,
                                                reward_scale, noise_std, explore_rate, std_lo,
                                                std_hi, cluster, quant, w2, stream);
  }
};

// The port builds this file as libraries whose nvcc runs go side by side:
// onpolicy_rollout.cu (K1/K3, K4's on-policy actor and the critic pass) and
// offpolicy_rollout.cu (K6/K6' and K4 under the off-policy heads), each
// defining one of these, and their narrower groups (onpolicy_narrow.cu,
// offpolicy_narrow.cu, with ELEGANTRL_NARROW too); built alone, the file
// holds both halves' resident and streamed designs.
#if !defined(ELEGANTRL_OFFPOLICY_ONLY)
// Dynamic shared memory of one block of the rollout kernel for clusters of
// c blocks (RolloutLayout) in the variant; -1 for an unknown body.
extern "C" int fused_rollout_smem_bytes(int body, int D1, int D2, int c, int variant) {
#define ELEGANTRL_SMEM(ID, BODY) \
  if (body == ID) return ELEGANTRL_VARIANT(variant, OnPolicy<BODY>::template smem, D1, D2, c);
  ELEGANTRL_BODIES(ELEGANTRL_SMEM)
#undef ELEGANTRL_SMEM
  return -1;
}

// The cluster size the kernel takes for N lanes (rollout_cluster; `cluster`
// 0 picks from the card's occupancy) in the variant; 0 when none fits, -1
// for an unknown body.
extern "C" int fused_rollout_cluster(int body, int N, int D1, int D2, int cluster, int variant) {
#define ELEGANTRL_CLUSTER(ID, BODY)                                                      \
  if (body == ID)                                                                        \
    return ELEGANTRL_VARIANT(variant, OnPolicy<BODY>::template cluster, N, D1, D2, cluster);
  ELEGANTRL_BODIES(ELEGANTRL_CLUSTER)
#undef ELEGANTRL_CLUSTER
  return -1;
}

// variant: bf16 compute and the design, as above; quant: the obs rounded to
// bf16 before acting and the states stored as bf16; w2: null for the
// resident design, else the streamed designs' stream_weights copy of both
// nets' W2 (f32, or bf16 under bf16 compute).  Returns the CUDA error of the
// launch, -1 for an unknown body, -2 for a variant this library lacks.
extern "C" int fused_rollout(
    int body, const void* act_flat, const void* cri_flat, const void* norm_avg,
    const void* norm_std, const void* env_f, const void* env_i,
    const void* noise, const void* seed, void* states, void* actions,
    void* logp, void* rew, void* term, void* trunc, void* val, void* env_f_o,
    void* env_i_o, int N, int H, int D1, int D2, float reward_scale, int cluster,
    int variant, int quant, const void* w2, void* stream) {
  if ((variant >> 1 != 0) != (w2 != nullptr)) return (int)cudaErrorInvalidValue;
#define ELEGANTRL_LAUNCH(ID, BODY)                                                       \
  if (body == ID)                                                                        \
    return ELEGANTRL_VARIANT(variant, OnPolicy<BODY>::template go, act_flat, cri_flat,   \
                             norm_avg, norm_std, env_f, env_i, noise, seed, states,      \
                             actions, logp, rew, term, trunc, val, env_f_o, env_i_o, N,  \
                             H, D1, D2, reward_scale, cluster, quant, w2,                \
                             (cudaStream_t)stream);
  ELEGANTRL_BODIES(ELEGANTRL_LAUNCH)
#undef ELEGANTRL_LAUNCH
  return -1;
}
#endif

// The off-policy (body, head) pairs of offpolicy_rollout_kernel: ddpg, sac
// and modsac on Pendulum-v1 (0), HopperSlip-v0 (2) and PointChasingVecEnv
// (3); dqn, dqn_enc and dqn_duel on CartPole-v1 (1) and
// PointChasingDiscreteEnv (4).  head: 0 ddpg, 1 dqn, 2 dqn_enc, 3 dqn_duel,
// 4 sac, 5 modsac (OFFPOLICY_HEADS of ops/fused_rollout.py).
#define ELEGANTRL_OFF_PAIRS(X)                                                        \
  X(0, PendulumBody, HEAD_DDPG) X(2, HopperBody, HEAD_DDPG) X(3, ChasingBody, HEAD_DDPG) \
  X(0, PendulumBody, HEAD_SAC) X(2, HopperBody, HEAD_SAC) X(3, ChasingBody, HEAD_SAC)    \
  X(0, PendulumBody, HEAD_MODSAC) X(2, HopperBody, HEAD_MODSAC)                          \
  X(3, ChasingBody, HEAD_MODSAC) X(1, CartPoleBody, HEAD_DQN)                            \
  X(1, CartPoleBody, HEAD_DQN_ENC) X(1, CartPoleBody, HEAD_DQN_DUEL)                     \
  X(4, ChasingDiscreteBody, HEAD_DQN) X(4, ChasingDiscreteBody, HEAD_DQN_ENC)            \
  X(4, ChasingDiscreteBody, HEAD_DQN_DUEL)
// The stock body's heads (stock_actor_kernel<HEAD>), body 5.
#define ELEGANTRL_STOCK_HEADS(X) X(HEAD_DDPG) X(HEAD_SAC) X(HEAD_MODSAC)

// The stock actor kernel's cluster size for N lanes (pick_cluster).
template <int HEAD, bool BF, int ST>
int stock_cluster(int N, int D1, int D2, int cluster) {
  constexpr int G = narrow_lanes(TE, ST);
  return pick_cluster<stock_actor_kernel<HEAD, BF, ST>>(
      (N + G - 1) / G, cluster,
      [=](int c) { return stock_actor_smem<HEAD, BF, ST>(D1, D2, c); }, false);
}
template <int HEAD, bool BF, int ST>
int launch_stock(const StockBody& body, const void* act_flat, const void* norm_avg,
                 const void* norm_std, const void* env_f, const void* env_i, const void* noise,
                 const void* seed, void* states, void* actions, void* logp, void* rew,
                 void* term, void* trunc, void* env_f_o, void* env_i_o, int N, int H, int D1,
                 int D2, float reward_scale, float noise_std, float std_lo, float std_hi,
                 int cluster, int quant, const void* w2, cudaStream_t stream);
template <int HEAD>
struct StockHead {
  template <bool BF, int ST>
  static int smem(int D1, int D2, int c) { return stock_actor_smem<HEAD, BF, ST>(D1, D2, c); }
  template <bool BF, int ST>
  static int cluster(int N, int D1, int D2, int k) {
    return stock_cluster<HEAD, BF, ST>(N, D1, D2, k);
  }
  template <bool BF, int ST>
  static int go(const StockBody& body, const void* act_flat, const void* norm_avg,
                const void* norm_std, const void* env_f, const void* env_i, const void* noise,
                const void* seed, void* states, void* actions, void* logp, void* rew,
                void* term, void* trunc, void* env_f_o, void* env_i_o, int N, int H, int D1,
                int D2, float reward_scale, float noise_std, float std_lo, float std_hi,
                int cluster, int quant, const void* w2, cudaStream_t stream) {
    return launch_stock<HEAD, BF, ST>(body, act_flat, norm_avg, norm_std, env_f, env_i, noise,
                                      seed, states, actions, logp, rew, term, trunc, env_f_o,
                                      env_i_o, N, H, D1, D2, reward_scale, noise_std, std_lo,
                                      std_hi, cluster, quant, w2, stream);
  }
};

#if !defined(ELEGANTRL_ONPOLICY_ONLY)
// Dynamic shared memory of one block of the off-policy rollout for clusters
// of c blocks (OffLayout; the stock body's StockActorLayout) in the variant;
// -1 for a pair it does not have.
extern "C" int offpolicy_rollout_smem_bytes(int body, int head, int D1, int D2, int c,
                                            int variant) {
#define ELEGANTRL_SMEM(ID, BODY, HEAD)                                  \
  if (body == ID && head == HEAD) {                                     \
    using P = OffPolicy<BODY, HEAD>;                                    \
    return ELEGANTRL_VARIANT(variant, P::template smem, D1, D2, c);     \
  }
  ELEGANTRL_OFF_PAIRS(ELEGANTRL_SMEM)
#undef ELEGANTRL_SMEM
#define ELEGANTRL_SMEM(HEAD)                                                      \
  if (body == 5 && head == HEAD)                                                  \
    return ELEGANTRL_STOCK_VARIANT(variant, StockHead<HEAD>::template smem, D1, D2, c);
  ELEGANTRL_STOCK_HEADS(ELEGANTRL_SMEM)
#undef ELEGANTRL_SMEM
  return -1;
}

// The cluster size the off-policy rollout takes for N lanes (`cluster` 0
// picks from the card's occupancy) in the variant; 0 when none fits, -1 for
// a pair it does not have.
extern "C" int offpolicy_rollout_cluster(int body, int head, int N, int D1, int D2,
                                         int cluster, int variant) {
#define ELEGANTRL_CLUSTER(ID, BODY, HEAD)                                       \
  if (body == ID && head == HEAD) {                                             \
    using P = OffPolicy<BODY, HEAD>;                                            \
    return ELEGANTRL_VARIANT(variant, P::template cluster, N, D1, D2, cluster); \
  }
  ELEGANTRL_OFF_PAIRS(ELEGANTRL_CLUSTER)
#undef ELEGANTRL_CLUSTER
#define ELEGANTRL_CLUSTER(HEAD)    \
  if (body == 5 && head == HEAD)   \
    return ELEGANTRL_STOCK_VARIANT(variant, StockHead<HEAD>::template cluster, N, D1, D2, \
                                   cluster);
  ELEGANTRL_STOCK_HEADS(ELEGANTRL_CLUSTER)
#undef ELEGANTRL_CLUSTER
  return -1;
}

// The off-policy exploration rollout for the fifteen pairs above.  std_lo
// and std_hi clip the SAC heads' log_std; `cluster` as for
// offpolicy_rollout_cluster; variant, quant and w2 (one net's W2) as for
// fused_rollout.  Returns the CUDA error of the launch, -1 for a pair it
// does not have, -2 for a variant this library lacks.
extern "C" int offpolicy_rollout(int body, int head, const void* flat, const void* env_f,
                                 const void* env_i, const void* noise, const void* seed,
                                 void* states, void* actions, void* rew, void* term,
                                 void* trunc, void* env_f_o, void* env_i_o, int N, int H,
                                 int D1, int D2, float reward_scale, float noise_std,
                                 float explore_rate, float std_lo, float std_hi, int cluster,
                                 int variant, int quant, const void* w2, void* stream) {
  if ((variant >> 1 != 0) != (w2 != nullptr)) return (int)cudaErrorInvalidValue;
#define ELEGANTRL_OFF(ID, BODY, HEAD)                                                       \
  if (body == ID && head == HEAD) {                                                         \
    using P = OffPolicy<BODY, HEAD>;                                                        \
    return ELEGANTRL_VARIANT(variant, P::template go, flat, env_f, env_i, noise, seed,      \
                             states, actions, rew, term, trunc, env_f_o, env_i_o, N, H, D1, \
                             D2, reward_scale, noise_std, explore_rate, std_lo, std_hi,     \
                             cluster, quant, w2, (cudaStream_t)stream);                     \
  }
  ELEGANTRL_OFF_PAIRS(ELEGANTRL_OFF)
#undef ELEGANTRL_OFF
  return -1;
}
#endif

// Launches stock_actor_kernel<HEAD, BF, ST> on the cluster size stock_cluster
// picks.
template <int HEAD, bool BF, int ST>
int launch_stock(const StockBody& body, const void* act_flat, const void* norm_avg,
                 const void* norm_std, const void* env_f, const void* env_i, const void* noise,
                 const void* seed, void* states, void* actions, void* logp, void* rew,
                 void* term, void* trunc, void* env_f_o, void* env_i_o, int N, int H, int D1,
                 int D2, float reward_scale, float noise_std, float std_lo, float std_hi,
                 int cluster, int quant, const void* w2, cudaStream_t stream) {
  if (N == 0) return 0;
  const int c = stock_cluster<HEAD, BF, ST>(N, D1, D2, cluster);
  if (c == 0) {
    const cudaError_t err = cudaGetLastError();
    return (int)(err != cudaSuccess ? err : cudaErrorInvalidValue);
  }
  const int smem = stock_actor_smem<HEAD, BF, ST>(D1, D2, c);
  const cudaError_t err = allow_smem<stock_actor_kernel<HEAD, BF, ST>>(smem);
  if (err != cudaSuccess) return (int)err;
  constexpr int G = narrow_lanes(TE, ST);
  const int groups = (N + G - 1) / G;
  return (int)cm::launch_clusters(
      stock_actor_kernel<HEAD, BF, ST>, groups * c, c, smem, stream, body,
      (const float*)act_flat, (const float*)norm_avg, (const float*)norm_std,
      (const float*)env_f, (const int*)env_i, (const float*)noise, (const int*)seed, states,
      actions, (float*)logp, (float*)rew, (float*)term, (float*)trunc, (float*)env_f_o,
      (int*)env_i_o, N, H, D1, D2, reward_scale, noise_std, std_lo, std_hi, quant,
      (const cm::elem_t<BF>*)w2);
}
// launch_stock in the variant (compute type and design; w2 null exactly
// for the resident design)
template <int HEAD>
int launch_stock_any(int variant, const void* w2, const StockBody& body, const void* act_flat,
                     const void* norm_avg, const void* norm_std, const void* env_f,
                     const void* env_i, const void* noise, const void* seed, void* states,
                     void* actions, void* logp, void* rew, void* term, void* trunc,
                     void* env_f_o, void* env_i_o, int N, int H, int D1, int D2,
                     float reward_scale, float noise_std, float std_lo, float std_hi,
                     int cluster, int quant, cudaStream_t stream) {
  if ((variant >> 1 != 0) != (w2 != nullptr)) return (int)cudaErrorInvalidValue;
  return ELEGANTRL_STOCK_VARIANT(variant, StockHead<HEAD>::template go, body, act_flat, norm_avg,
                                 norm_std, env_f, env_i, noise, seed, states, actions, logp,
                                 rew, term, trunc, env_f_o, env_i_o, N, H, D1, D2, reward_scale,
                                 noise_std, std_lo, std_hi, cluster, quant, w2, stream);
}

#if !defined(ELEGANTRL_OFFPOLICY_ONLY)
// StockTradingEnv-v2: the actor-only rollout (K4, stock_actor_kernel<HEAD_PPO,
// BF, ST>; values are left to critic_values).  Shared memory of one block for
// clusters of c blocks, and the cluster size for N lanes (stock_cluster), in
// the variant; bf, quant and w2 (the actor's W2) as for fused_rollout.
extern "C" int stock_rollout_smem_bytes(int D1, int D2, int c, int variant) {
  return ELEGANTRL_STOCK_VARIANT(variant, StockHead<HEAD_PPO>::template smem, D1, D2, c);
}

extern "C" int stock_rollout_cluster(int N, int D1, int D2, int cluster, int variant) {
  return ELEGANTRL_STOCK_VARIANT(variant, StockHead<HEAD_PPO>::template cluster, N, D1, D2,
                                 cluster);
}

extern "C" int stock_rollout(const void* act_flat, const void* norm_avg, const void* norm_std,
                             const void* env_f, const void* env_i, const void* noise,
                             const void* seed, void* states, void* actions, void* logp,
                             void* rew, void* term, void* trunc, void* env_f_o, void* env_i_o,
                             int N, int H, int D1, int D2, float reward_scale, int cluster,
                             int variant, int quant, const StockArgs* args, const void* w2,
                             void* stream) {
  return launch_stock_any<HEAD_PPO>(
      variant, w2, StockBody{*args}, act_flat, norm_avg, norm_std, env_f, env_i, noise, seed, states,
      actions, logp, rew, term, trunc, env_f_o, env_i_o, N, H, D1, D2, reward_scale, 0.f, 0.f,
      0.f, cluster, quant, (cudaStream_t)stream);
}
#endif

#if !defined(ELEGANTRL_ONPOLICY_ONLY)
// The off-policy exploration rollout on StockBody: the ddpg, sac and modsac
// heads (stock_actor_kernel<HEAD, BF, ST>; no normalisation, no logprob);
// variant, quant and w2 as for fused_rollout.  Returns the CUDA error of the launch,
// or -1 for another head.
extern "C" int offpolicy_stock_rollout(int head, const void* flat, const void* env_f,
                                       const void* env_i, const void* noise, const void* seed,
                                       void* states, void* actions, void* rew, void* term,
                                       void* trunc, void* env_f_o, void* env_i_o, int N, int H,
                                       int D1, int D2, float reward_scale, float noise_std,
                                       float std_lo, float std_hi, int cluster,
                                       int variant, int quant, const StockArgs* args,
                                       const void* w2, void* stream) {
#define ELEGANTRL_STOCK(HEAD)                                                                  \
  if (head == HEAD)                                                                            \
    return launch_stock_any<HEAD>(                                                             \
        variant, w2, StockBody{*args}, flat, nullptr, nullptr, env_f, env_i, noise, seed, states,   \
        actions, nullptr, rew, term, trunc, env_f_o, env_i_o, N, H, D1, D2, reward_scale,      \
        noise_std, std_lo, std_hi, cluster, quant, (cudaStream_t)stream);
  ELEGANTRL_STOCK_HEADS(ELEGANTRL_STOCK)
#undef ELEGANTRL_STOCK
  return -1;
}
#endif

#if !defined(ELEGANTRL_OFFPOLICY_ONLY)
// Blocks of critic_values_kernel<CT> an SM holds at smem bytes a block into
// per_sm: asked of the occupancy calculator once per (CT, device, smem) and
// kept, not at every launch.
template <int CT, bool BF>
cudaError_t critic_blocks_per_sm(int smem, int& per_sm) {
  static int kept_smem[64] = {0}, kept[64] = {0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const bool known = dev >= 0 && dev < 64;
  if (known && kept_smem[dev] == smem) {
    per_sm = kept[dev];
    return cudaSuccess;
  }
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, critic_values_kernel<CT, BF>,
                                                      cm::THREADS, smem);
  if (err == cudaSuccess && known) {
    kept_smem[dev] = smem;
    kept[dev] = per_sm;
  }
  return err;
}

// Launches critic_values_kernel<CT, BF>: persistent blocks, as many as the
// card holds at once, or one a tile.
template <int CT, bool BF>
int launch_critic(const void* cri_flat, const void* norm_avg, const void* norm_std,
                  const void* states, void* val, int N, int H, int D1, int D2, int sbf,
                  cudaStream_t stream) {
  const int smem = critic_smem(D1, D2);
  cudaError_t err = allow_smem<critic_values_kernel<CT, BF>>(smem);
  if (err != cudaSuccess) return (int)err;
  int per_sm = 0;
  err = critic_blocks_per_sm<CT, BF>(smem, per_sm);
  if (err != cudaSuccess) return (int)err;
  if (per_sm == 0) return (int)cudaErrorInvalidConfiguration;
  const long long tiles = (long long)H * ((N + CT - 1) / CT);
  const long long most = (long long)cm::sm_count() * per_sm;  // persistent blocks
  const int blocks = (int)(tiles < most ? tiles : most);
  critic_values_kernel<CT, BF><<<blocks, cm::THREADS, smem, stream>>>(
      (const float*)cri_flat, (const float*)norm_avg, (const float*)norm_std, states,
      (float*)val, N, H, D1, D2, sbf);
  return (int)cudaGetLastError();
}

// The critic pass: val (H, N) from the stored states (H, S, N) of the stock
// body (S = StockBody::S; bf16 when sbf); its lanes' groups of TE share each
// step's market rows (critic_values_kernel's precondition); bf: the bf16
// variant.  Shared memory of one block (the same in both variants).
extern "C" int critic_values_smem_bytes(int D1, int D2) { return critic_smem(D1, D2); }

extern "C" int critic_values(const void* cri_flat, const void* norm_avg, const void* norm_std,
                             const void* states, void* val, int N, int H, int D1, int D2,
                             int bf, int sbf, void* stream) {
  if ((long long)H * N == 0) return 0;
  const int ct = critic_tile(D1, D2);
#if defined(ELEGANTRL_NARROW)
  if (ct != CT_NARROW) return -2;  // onpolicy_rollout.cu's tiles
  auto go = bf ? launch_critic<CT_NARROW, true> : launch_critic<CT_NARROW, false>;
#else
  if (ct == CT_NARROW) return -2;  // onpolicy_narrow.cu's tile
  auto go = ct == CT_STREAM ? (bf ? launch_critic<CT_STREAM, true> : launch_critic<CT_STREAM, false>)
            : ct == 64      ? (bf ? launch_critic<64, true> : launch_critic<64, false>)
                            : (bf ? launch_critic<128, true> : launch_critic<128, false>);
#endif
  return go(cri_flat, norm_avg, norm_std, states, val, N, H, D1, D2, sbf, (cudaStream_t)stream);
}
#endif
