// Fused whole-rollout kernel: actor + critic MLPs, the Gaussian or the
// categorical head and an inlined env step, for every env lane and all H
// steps in one launch.  One instantiation per env body: Pendulum-v1,
// CartPole-v1, HopperSlip-v0 and PointChasing (continuous and discrete);
// StockTradingEnv-v2's actor runs in stock_actor_kernel (K4, below), its
// critic in critic_values_kernel.
// Below it, offpolicy_rollout_kernel: the same template for the off-policy
// agents' exploration (one net, the ddpg and DQN heads).
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
// CUDA cores (no tensor cores in this version).
//
// Design:
// - One block owns TE = 32 env lanes and loops over all H steps itself.  On
//   the TPU the grid's time-chunk axis and a VMEM scratch carry existed
//   because the outputs had to fit in VMEM; here the outputs stream to
//   device memory as they are made, so no state carries between blocks.
// - Both nets' weights (137 KB at 128x128) are loaded once into dynamic
//   shared memory and reused for all H steps; the wrapper raises for widths
//   that do not fit in the 227 KB of one block.
// - Activations are (features, TE) tiles in shared memory: lane = env, so
//   the activation reads are conflict-free and each weight read is one
//   broadcast for the warp.  Each warp computes RJ output rows at a time,
//   holding RJ sums in registers.
// - The env body and the head are template parameters: a body is a struct
//   with its dimensions and obs/step/reset functions over a register array
//   of its F float rows and one step counter, so each instantiation keeps
//   its env state in registers of the env's thread; the env step, the
//   sampling and the output stores run on warp 0 (one thread per env).
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

constexpr int TE = 32;        // env lanes per block
constexpr int THREADS = 256;  // threads per block
constexpr int RJ = 8;         // output rows per warp pass
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

// -------------------------------------------------------------------- MLP

// out[j][e] = act(sum_k W[j][k] * in[k][e] + b[j]) for j < J, e < TE.
// Tiles are (rows, TE) in shared memory; W is row-major (J, K).
template <bool GELU>
__device__ void dense(const float* W, const float* b, const float* in,
                      float* out, int J, int K) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  for (int j0 = warp * RJ; j0 < J; j0 += nwarps * RJ) {
    float acc[RJ];
#pragma unroll
    for (int r = 0; r < RJ; ++r) acc[r] = 0.f;
    const int rows = min(RJ, J - j0);
    for (int k = 0; k < K; ++k) {
      const float x = in[k * TE + lane];
#pragma unroll
      for (int r = 0; r < RJ; ++r)
        if (r < rows) acc[r] = fmaf(W[(j0 + r) * K + k], x, acc[r]);
    }
#pragma unroll
    for (int r = 0; r < RJ; ++r) {
      if (r < rows) {
        const float v = acc[r] + b[j0 + r];
        out[(j0 + r) * TE + lane] = GELU ? gelu_tanh(v) : v;
      }
    }
  }
}

struct Net {
  const float *W1, *b1, *W2, *b2, *Wo, *bo;
};

// Copy one net's leaves from the flat buffer into shared memory.
__device__ Net load_net(const float* __restrict__ flat, float* smem, int S,
                        int D1, int D2, int O) {
  const int n = D1 * S + D1 + D2 * D1 + D2 + O * D2 + O;
  for (int i = threadIdx.x; i < n; i += blockDim.x) smem[i] = flat[i];
  Net net;
  net.W1 = smem;
  net.b1 = net.W1 + D1 * S;
  net.W2 = net.b1 + D1;
  net.b2 = net.W2 + D2 * D1;
  net.Wo = net.b2 + D2;
  net.bo = net.Wo + O * D2;
  return net;
}

__device__ void mlp(const Net& net, const float* xn, float* h1, float* h2,
                    float* out, int S, int D1, int D2, int O) {
  dense<true>(net.W1, net.b1, xn, h1, D1, S);
  __syncthreads();
  dense<true>(net.W2, net.b2, h1, h2, D2, D1);
  __syncthreads();
  dense<false>(net.Wo, net.bo, h2, out, O, D2);
}

// ----------------------------------------------------------------- kernel

// The bodies without market tables (the stock body's actor runs in
// stock_actor_kernel below).
template <class Body>
__global__ void __launch_bounds__(THREADS)
fused_rollout_kernel(const Body body, const float* __restrict__ act_flat,
                     const float* __restrict__ cri_flat,
                     const float* __restrict__ norm_avg,
                     const float* __restrict__ norm_std,
                     const float* __restrict__ env_f,
                     const int* __restrict__ env_i,
                     const float* __restrict__ noise,
                     const int* __restrict__ seed,
                     float* __restrict__ states_o, void* __restrict__ actions_o,
                     float* __restrict__ logp_o, float* __restrict__ rew_o,
                     float* __restrict__ term_o, float* __restrict__ trunc_o,
                     float* __restrict__ val_o, float* __restrict__ env_f_o,
                     int* __restrict__ env_i_o, int N, int H, int D1, int D2,
                     float reward_scale) {
  constexpr int S = Body::S, A = Body::A, F = Body::F;
  constexpr bool DISCRETE = Body::DISCRETE;
  constexpr int N_ENV = Body::N_STEP + Body::N_RESET;  // the env's uniforms
  constexpr int NZ = A + N_ENV;                        // injected rows
  constexpr int N_HEAD = DISCRETE ? A : 2 * A;         // internal head uniforms
  constexpr int NB = (N_HEAD + N_ENV + 3) / 4;         // Philox blocks per step
  constexpr int AE = DISCRETE ? 1 : A;                 // values of the env's action
  static_assert(!BodyInfo<Body>::TABLES, "the stock body runs stock_actor_kernel");

  extern __shared__ float smem[];
  const int net_floats = D1 * S + D1 + D2 * D1 + D2;
  const Net actor = load_net(act_flat, smem, S, D1, D2, A);
  const Net critic = load_net(cri_flat, smem + net_floats + A * D2 + A, S, D1, D2, 1);
  float* xn = smem + 2 * net_floats + A * D2 + A + D2 + 1;  // (S, TE)
  float* h1 = xn + S * TE;                                  // (D1, TE)
  float* h2 = h1 + D1 * TE;                                 // (D2, TE)
  float* out = h2 + D2 * TE;                                // (A + 1, TE)

  const int e = threadIdx.x;  // env slot of this thread when e < TE
  const int n = blockIdx.x * TE + e;
  const bool owner = e < TE;
  const bool live = owner && n < N;

  float f[F];
#pragma unroll
  for (int k = 0; k < F; ++k) f[k] = 0.f;
  int tc = 0;
  float std_a[A], log_std_sum = 0.f, avg[S], nstd[S];
  if (owner) {
    if (live) {
#pragma unroll
      for (int k = 0; k < F; ++k) f[k] = env_f[(size_t)k * N + n];
      tc = env_i[n];
    }
#pragma unroll
    for (int a = 0; a < A; ++a) {
      std_a[a] = 1.f;
      if constexpr (!DISCRETE) {  // std_log is the actor's last leaf
        std_a[a] = expf(act_flat[net_floats + A * D2 + A + a]);
        log_std_sum += logf(std_a[a]);
      }
    }
#pragma unroll
    for (int s = 0; s < S; ++s) {
      avg[s] = norm_avg[s];
      nstd[s] = norm_std[s] + 1e-4f;
    }
  }
  uint2 key = make_uint2(0u, 0u);
  if (noise == nullptr) key = make_uint2((uint32_t)seed[0], (uint32_t)seed[1]);
  __syncthreads();

  for (int t = 0; t < H; ++t) {
    if (owner) {
      float x[S];
      body.obs(f, x);
#pragma unroll
      for (int s = 0; s < S; ++s) {
        xn[s * TE + e] = live ? (x[s] - avg[s]) / nstd[s] : 0.f;
        if (live) states_o[((size_t)t * S + s) * N + n] = x[s];
      }
    }
    __syncthreads();
    mlp(actor, xn, h1, h2, out, S, D1, D2, A);
    __syncthreads();
    mlp(critic, xn, h1, h2, out + A * TE, S, D1, D2, 1);
    __syncthreads();
    if (live) {
      // head[0:A]: normals (Gaussian, injected), or uniforms; u_env: the
      // env's N_STEP step uniforms, then its N_RESET reset uniforms
      float head[N_HEAD], u_env[N_ENV > 0 ? N_ENV : 1];
      if (noise != nullptr) {
        const float* nz = noise + (size_t)t * NZ * N + n;
#pragma unroll
        for (int a = 0; a < A; ++a) head[a] = nz[(size_t)a * N];
#pragma unroll
        for (int k = 0; k < N_ENV; ++k) u_env[k] = nz[(size_t)(A + k) * N];
      } else {
        float u[4 * NB];
#pragma unroll
        for (int b = 0; b < NB; ++b) {
          const uint4 r = philox4x32_10(
              make_uint4((uint32_t)n, (uint32_t)t, (uint32_t)b, 0u), key);
          u[4 * b + 0] = uniform24(r.x);
          u[4 * b + 1] = uniform24(r.y);
          u[4 * b + 2] = uniform24(r.z);
          u[4 * b + 3] = uniform24(r.w);
        }
#pragma unroll
        for (int a = 0; a < N_HEAD; ++a) head[a] = u[a];
#pragma unroll
        for (int k = 0; k < N_ENV; ++k) u_env[k] = u[N_HEAD + k];
      }
      const size_t o = (size_t)t * N + n;
      float env_a[AE], logp;
      if constexpr (DISCRETE) {
        float best = 0.f, m = 0.f;
        int index = 0;
#pragma unroll
        for (int a = 0; a < A; ++a) {
          const float logit = out[a * TE + e];
          const float g = -logf(-logf(fmaxf(head[a], 1e-12f)) + 1e-12f);
          const float p = logit + g;
          if (a == 0 || p > best) {  // strict: the first maximum wins a tie
            best = p;
            index = a;
          }
          m = a == 0 ? logit : fmaxf(m, logit);
        }
        float sum = 0.f, chosen = 0.f;
#pragma unroll
        for (int a = 0; a < A; ++a) {
          const float logit = out[a * TE + e];
          sum += expf(logit - m);
          if (a == index) chosen = logit;
        }
        logp = chosen - (m + logf(sum));
        ((int*)actions_o)[o] = index;
        env_a[0] = (float)index;
      } else {
        logp = -log_std_sum;
#pragma unroll
        for (int a = 0; a < A; ++a) {
          float z;
          if (noise != nullptr) {
            z = head[a];
          } else {
            z = sqrtf(-2.0f * logf(1.0f - head[a])) * cosf(TWO_PI_F * head[A + a]);
          }
          const float action = out[a * TE + e] + std_a[a] * z;
          logp += -0.5f * z * z - LOG_SQRT_2PI;
          ((float*)actions_o)[((size_t)t * A + a) * N + n] = action;
          env_a[a] = tanhf(action);
        }
      }
      float reward;
      bool terminal, trunc;
      body.step(f, tc, env_a, u_env, reward, terminal, trunc);
      logp_o[o] = logp;
      rew_o[o] = reward * reward_scale;
      term_o[o] = terminal ? 1.0f : 0.0f;
      trunc_o[o] = trunc ? 1.0f : 0.0f;
      val_o[o] = out[A * TE + e];
      if (terminal || trunc) {  // masked reset from the reset uniforms
        body.reset(f, u_env + Body::N_STEP);
        tc = 0;
      }
    }
    // the next step's xn write and dense passes reuse the shared tiles
    __syncthreads();
  }
  if (live) {
#pragma unroll
    for (int k = 0; k < F; ++k) env_f_o[(size_t)k * N + n] = f[k];
    env_i_o[n] = tc;
  }
}

template <class Body>
int launch(const void* act_flat, const void* cri_flat, const void* norm_avg,
           const void* norm_std, const void* env_f, const void* env_i,
           const void* noise, const void* seed, void* states, void* actions,
           void* logp, void* rew, void* term, void* trunc, void* val,
           void* env_f_o, void* env_i_o, int N, int H, int D1, int D2,
           float reward_scale, int smem_bytes, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      fused_rollout_kernel<Body>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (N + TE - 1) / TE;
  fused_rollout_kernel<Body><<<blocks, THREADS, smem_bytes, stream>>>(
      Body{}, (const float*)act_flat, (const float*)cri_flat, (const float*)norm_avg,
      (const float*)norm_std, (const float*)env_f, (const int*)env_i,
      (const float*)noise, (const int*)seed, (float*)states, actions,
      (float*)logp, (float*)rew, (float*)term, (float*)trunc, (float*)val,
      (float*)env_f_o, (int*)env_i_o, N, H, D1, D2, reward_scale);
  return (int)cudaGetLastError();
}

// ------------------------------------------------- off-policy exploration
// Replaces: elegantrl_tpu/ops/pallas_rollout.py, _make_offpolicy_kernel
// (built by make_fused_offpolicy_rollout) with the heads ddpg, dqn, dqn_enc,
// dqn_duel, sac and modsac (pallas_rollout.py:1059-1069).  One net, no
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
// weights, the tiles and the step loop are those of the on-policy kernel;
// the outputs are written in the (H, N, dim) layout the replay buffer takes.
// Noise: injected (H, NZ, N) with A normals (ddpg, sac, modsac) or the coin
// and the random-action uniform (DQN) first, then the env's uniforms;
// internal Philox draws 2A (the continuous heads, Box-Muller) or 2 head
// uniforms per (lane, step).
// Bound: operations, one net's 2 (S D1 + D1 D2 + D2 A) FLOP per env-step;
// at 1024 envs only 32 blocks run, and at 64 envs 2, so the kernel is
// latency-bound at the off-policy shapes.

constexpr int HEAD_DDPG = 0, HEAD_DQN = 1, HEAD_DQN_ENC = 2, HEAD_DQN_DUEL = 3,
              HEAD_SAC = 4, HEAD_MODSAC = 5;

__host__ __device__ inline bool sac_head(int head) {
  return head == HEAD_SAC || head == HEAD_MODSAC;
}

// The head's weights: the trunk, then A rows (ddpg, DQN; dqn_duel adds the
// advantage row) or 2A rows (SAC's head; ModSAC's avg and std heads).
__host__ __device__ inline int offpolicy_net_floats(int S, int A, int D1, int D2, int head) {
  const int heads = sac_head(head) ? 2 * (A * D2 + A)
                                   : A * D2 + A + (head == HEAD_DQN_DUEL ? D2 + 1 : 0);
  return D1 * S + D1 + D2 * D1 + D2 + heads;
}

// Rows of the out tile: the 2A SAC outputs, or A (+ the advantage).
__host__ __device__ inline int offpolicy_out_rows(int A, int head) {
  return sac_head(head) ? 2 * A : A + 1;
}

template <class Body, int HEAD>
__global__ void __launch_bounds__(THREADS)
offpolicy_rollout_kernel(const Body body, const float* __restrict__ flat,
                         const float* __restrict__ env_f,
                         const int* __restrict__ env_i, const float* __restrict__ noise,
                         const int* __restrict__ seed, float* __restrict__ states_o,
                         void* __restrict__ actions_o, float* __restrict__ rew_o,
                         float* __restrict__ term_o, float* __restrict__ trunc_o,
                         float* __restrict__ env_f_o, int* __restrict__ env_i_o, int N,
                         int H, int D1, int D2, float reward_scale, float noise_std,
                         float explore_rate, float std_lo, float std_hi) {
  constexpr int S = Body::S, A = Body::A, F = Body::F;
  constexpr bool SAC = HEAD == HEAD_SAC || HEAD == HEAD_MODSAC;
  constexpr bool DISCRETE = HEAD != HEAD_DDPG && !SAC;
  static_assert(DISCRETE == Body::DISCRETE, "the head must fit the body's action space");
  constexpr int N_ENV = Body::N_STEP + Body::N_RESET;
  constexpr int N_HEAD_INJ = DISCRETE ? 2 : A;      // injected head rows
  constexpr int NZ = N_HEAD_INJ + N_ENV;
  constexpr int N_HEAD = DISCRETE ? 2 : 2 * A;      // internal head uniforms
  constexpr int NB = (N_HEAD + N_ENV + 3) / 4;
  constexpr bool TABLES = BodyInfo<Body>::TABLES;
  constexpr int L = BodyInfo<Body>::S_LANE;

  extern __shared__ float smem[];
  const int n_w = offpolicy_net_floats(S, A, D1, D2, HEAD);
  for (int i = threadIdx.x; i < n_w; i += blockDim.x) smem[i] = flat[i];
  const float* W1 = smem;
  const float* b1 = W1 + D1 * S;
  const float* W2 = b1 + D1;
  const float* b2 = W2 + D2 * D1;
  const float* Wo = b2 + D2;
  const float* bo = Wo + A * D2;
  const float* W4 = bo + A;  // the advantage head (HEAD_DQN_DUEL), ModSAC's std head
  const float* b4 = W4 + (HEAD == HEAD_MODSAC ? A * D2 : D2);
  float* xn = smem + n_w;    // (S, TE)
  float* h1 = xn + S * TE;   // (D1, TE)
  float* h2 = h1 + D1 * TE;  // (D2, TE)
  float* out = h2 + D2 * TE; // (A + 1, TE), or (2A, TE) for the SAC heads

  const int e = threadIdx.x;
  const int n = blockIdx.x * TE + e;
  const bool owner = e < TE;
  const bool live = owner && n < N;
  int day = 0;   // the block's day (TABLES): its first lane's
  if (TABLES) day = env_i[blockIdx.x * TE];
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
  __syncthreads();

  for (int t = 0; t < H; ++t) {
    if constexpr (TABLES) {  // the day's market rows, the same on every lane
      for (int idx = threadIdx.x; idx < (S - L) * TE; idx += blockDim.x) {
        const int r = L + idx / TE, e2 = idx % TE, n2 = blockIdx.x * TE + e2;
        const float x = body.market(day, r);
        xn[r * TE + e2] = n2 < N ? x : 0.f;
        if (n2 < N) states_o[((size_t)t * N + n2) * S + r] = x;
      }
    }
    if (owner) {
      float x[L];
      body.obs(f, x);
#pragma unroll
      for (int s = 0; s < L; ++s) {
        xn[s * TE + e] = live ? x[s] : 0.f;
        if (live) states_o[((size_t)t * N + n) * S + s] = x[s];
      }
    }
    __syncthreads();
    dense<true>(W1, b1, xn, h1, D1, S);
    __syncthreads();
    dense<HEAD == HEAD_DDPG || HEAD == HEAD_DQN || HEAD == HEAD_SAC>(W2, b2, h1, h2, D2, D1);
    __syncthreads();
    if (HEAD == HEAD_SAC) {
      dense<false>(Wo, Wo + 2 * A * D2, h2, out, 2 * A, D2);  // [mean, log_std]
    } else {
      dense<false>(Wo, bo, h2, out, A, D2);
      if (HEAD == HEAD_DQN_DUEL) dense<false>(W4, b4, h2, out + A * TE, 1, D2);
      if (HEAD == HEAD_MODSAC) dense<false>(W4, b4, h2, out + A * TE, A, D2);
    }
    __syncthreads();
    if (live) {
      float head[N_HEAD], u_env[N_ENV > 0 ? N_ENV : 1];
      if (noise != nullptr) {
        const float* nz = noise + (size_t)t * NZ * N + n;
#pragma unroll
        for (int a = 0; a < N_HEAD_INJ; ++a) head[a] = nz[(size_t)a * N];
#pragma unroll
        for (int k = 0; k < N_ENV; ++k) u_env[k] = nz[(size_t)(N_HEAD_INJ + k) * N];
      } else {
        float u[4 * NB];
#pragma unroll
        for (int b = 0; b < NB; ++b) {
          const uint4 r = philox4x32_10(
              make_uint4((uint32_t)n, (uint32_t)t, (uint32_t)b, 0u), key);
          u[4 * b + 0] = uniform24(r.x);
          u[4 * b + 1] = uniform24(r.y);
          u[4 * b + 2] = uniform24(r.z);
          u[4 * b + 3] = uniform24(r.w);
        }
#pragma unroll
        for (int a = 0; a < N_HEAD; ++a) head[a] = u[a];
#pragma unroll
        for (int k = 0; k < N_ENV; ++k) u_env[k] = u[N_HEAD + k];
      }
      const size_t o = (size_t)t * N + n;
      float env_a[DISCRETE ? 1 : A];
      if constexpr (DISCRETE) {
        float mean = 0.f, adv = 0.f;
        if (HEAD == HEAD_DQN_DUEL) {
#pragma unroll
          for (int a = 0; a < A; ++a) mean += out[a * TE + e];
          mean /= (float)A;
          adv = out[A * TE + e];
        }
        float best = 0.f;
        int greedy = 0;
#pragma unroll
        for (int a = 0; a < A; ++a) {
          float q = out[a * TE + e];
          if (HEAD == HEAD_DQN_DUEL) q = q - mean + adv;
          if (a == 0 || q > best) {  // strict: the first maximum wins a tie
            best = q;
            greedy = a;
          }
        }
        const int rnd = min((int)floorf(head[1] * (float)A), A - 1);
        const int index = head[0] < explore_rate ? rnd : greedy;
        ((int*)actions_o)[o] = index;
        env_a[0] = (float)index;
      } else {
#pragma unroll
        for (int a = 0; a < A; ++a) {
          const float z = noise != nullptr
                              ? head[a]
                              : sqrtf(-2.0f * logf(1.0f - head[a])) *
                                    cosf(TWO_PI_F * head[A + a]);
          float act;
          if constexpr (SAC) {
            const float log_std = clampf(out[(A + a) * TE + e], std_lo, std_hi);
            act = tanhf(out[a * TE + e] + expf(log_std) * z);
          } else {
            act = clampf(tanhf(out[a * TE + e]) + noise_std * z, -1.0f, 1.0f);
          }
          ((float*)actions_o)[o * A + a] = act;
          env_a[a] = act;
        }
      }
      float reward;
      bool terminal, trunc;
      if constexpr (TABLES) {
        body.step(f, tc, day, env_a, reward, terminal, trunc);
      } else {
        body.step(f, tc, env_a, u_env, reward, terminal, trunc);
      }
      rew_o[o] = reward * reward_scale;
      term_o[o] = terminal ? 1.0f : 0.0f;
      trunc_o[o] = trunc ? 1.0f : 0.0f;
      if (terminal || trunc) {
        body.reset(f, u_env + Body::N_STEP);
        tc = 0;
      }
    }
    if constexpr (TABLES) day = day + 1 >= body.p.T - 1 ? 0 : day + 1;
    __syncthreads();
  }
  if (live) {
#pragma unroll
    for (int k = 0; k < F; ++k) env_f_o[(size_t)k * N + n] = f[k];
    env_i_o[n] = tc;
  }
}

__host__ __device__ inline int offpolicy_smem(int S, int A, int D1, int D2, int head) {
  return (int)sizeof(float) * (offpolicy_net_floats(S, A, D1, D2, head) +
                               (S + D1 + D2 + offpolicy_out_rows(A, head)) * TE);
}

template <class Body, int HEAD>
int launch_offpolicy(const void* flat, const void* env_f, const void* env_i,
                     const void* noise, const void* seed, void* states, void* actions,
                     void* rew, void* term, void* trunc, void* env_f_o, void* env_i_o, int N,
                     int H, int D1, int D2, float reward_scale, float noise_std,
                     float explore_rate, float std_lo, float std_hi, cudaStream_t stream,
                     const Body body = Body{}) {
  const int smem_bytes = offpolicy_smem(Body::S, Body::A, D1, D2, HEAD);
  cudaError_t err = cudaFuncSetAttribute(offpolicy_rollout_kernel<Body, HEAD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         smem_bytes);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (N + TE - 1) / TE;
  offpolicy_rollout_kernel<Body, HEAD><<<blocks, THREADS, smem_bytes, stream>>>(
      body, (const float*)flat, (const float*)env_f, (const int*)env_i, (const float*)noise,
      (const int*)seed, (float*)states, actions, (float*)rew, (float*)term, (float*)trunc,
      (float*)env_f_o, (int*)env_i_o, N, H, D1, D2, reward_scale, noise_std, explore_rate,
      std_lo, std_hi);
  return (int)cudaGetLastError();
}

// ------------------------------------------------------------ critic pass
// The stock body's second kernel: the critic over the rollout's stored
// (H, S, N) states, val = mlp(cri, (x - avg) / (std + 1e-4)), the function
// fused_rollout_kernel computes in-loop when both nets fit one block.
// Nothing in it is sequential, so it runs as a chain of tiled products over
// the M = H N samples: one block per SM holds the critic, transposed to
// (K, J) per layer, in shared memory and loops over tiles of CM = 64
// samples, so the weights are loaded once per block, not once per tile.  In
// a layer each thread computes CR x CC = 8 x 4 outputs (rows x samples) from
// two float4 weight reads and one float4 activation read per k: 32 FMA per 3
// shared-memory reads, where `dense` (1 lane = 1 sample) does 8 per 9.
// Bound: operations, 2 (S D1 + D1 D2 + D2) FLOP per sample.
constexpr int CM = 64, CR = 8, CC = 4;
constexpr int C_COLS = CM / CC;            // threads across the samples of a tile
constexpr int C_ROWS = THREADS / C_COLS;   // threads across a layer's rows
static_assert(THREADS % CM == 0 && CM <= THREADS, "a thread loads one sample of a tile");

// floats of the critic's leaves in shared memory, padded to a float4
__host__ __device__ inline int critic_weight_floats(int S, int D1, int D2) {
  return (S * D1 + D1 + D1 * D2 + D2 + D2 + 1 + 3) / 4 * 4;
}

// the weights, then the (S, CM) input tile (the second layer's output in
// its place) and the (D1, CM) first-layer tile
__host__ __device__ inline int critic_smem(int S, int D1, int D2) {
  return (int)sizeof(float) *
         (critic_weight_floats(S, D1, D2) + ((S > D2 ? S : D2) + D1) * CM);
}

// dst[k * J + j] = src[j * K + k]: a row-major (J, K) leaf, transposed
__device__ void load_transposed(const float* __restrict__ src, float* dst, int J, int K) {
  for (int i = threadIdx.x; i < J * K; i += blockDim.x) {
    const int k = i / J, j = i - k * J;
    dst[i] = __ldg(src + (size_t)j * K + k);
  }
}

// out[j][m] = gelu(sum_k WT[k][j] in[k][m] + b[j]) for j < J, m < CM: the
// thread's rows j0 .. j0 + CR - 1 (J a multiple of CR) and samples
// c0 .. c0 + CC - 1
__device__ void dense_tile(const float* WT, const float* b, const float* in, float* out,
                           int J, int K) {
  const int c0 = (threadIdx.x % C_COLS) * CC;
  for (int j0 = (threadIdx.x / C_COLS) * CR; j0 < J; j0 += C_ROWS * CR) {
    float acc[CR][CC];
#pragma unroll
    for (int r = 0; r < CR; ++r)
#pragma unroll
      for (int c = 0; c < CC; ++c) acc[r][c] = 0.f;
#pragma unroll 4
    for (int k = 0; k < K; ++k) {
      const float4 x = *reinterpret_cast<const float4*>(in + k * CM + c0);
      const float4 wa = *reinterpret_cast<const float4*>(WT + k * J + j0);
      const float4 wb = *reinterpret_cast<const float4*>(WT + k * J + j0 + 4);
      const float w[CR] = {wa.x, wa.y, wa.z, wa.w, wb.x, wb.y, wb.z, wb.w};
      const float xs[CC] = {x.x, x.y, x.z, x.w};
#pragma unroll
      for (int r = 0; r < CR; ++r)
#pragma unroll
        for (int c = 0; c < CC; ++c) acc[r][c] = fmaf(w[r], xs[c], acc[r][c]);
    }
#pragma unroll
    for (int r = 0; r < CR; ++r) {
      const float bj = b[j0 + r];
      float4 v;
      v.x = gelu_tanh(acc[r][0] + bj);
      v.y = gelu_tanh(acc[r][1] + bj);
      v.z = gelu_tanh(acc[r][2] + bj);
      v.w = gelu_tanh(acc[r][3] + bj);
      *reinterpret_cast<float4*>(out + (j0 + r) * CM + c0) = v;
    }
  }
}

__global__ void __launch_bounds__(THREADS)
critic_values_kernel(const float* __restrict__ cri_flat, const float* __restrict__ norm_avg,
                     const float* __restrict__ norm_std, const float* __restrict__ states,
                     float* __restrict__ val, int S, int N, int H, int D1, int D2) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  // the flat leaves: W1 (D1, S), b1, W2 (D2, D1), b2, Wo (1, D2), bo
  float* W1T = smem;                 // (S, D1)
  float* b1 = W1T + S * D1;
  float* W2T = b1 + D1;              // (D1, D2)
  float* b2 = W2T + D1 * D2;
  float* wo = b2 + D2;
  float* xn = smem + critic_weight_floats(S, D1, D2);   // (S, CM), then h2 (D2, CM)
  float* h1 = xn + (S > D2 ? S : D2) * CM;              // (D1, CM)
  load_transposed(cri_flat, W1T, D1, S);
  const float* rest = cri_flat + D1 * S;
  for (int i = threadIdx.x; i < D1; i += blockDim.x) b1[i] = rest[i];
  load_transposed(rest + D1, W2T, D2, D1);
  rest += D1 + D2 * D1;
  for (int i = threadIdx.x; i < 2 * D2 + 1; i += blockDim.x) b2[i] = rest[i];  // b2, Wo, bo
  const long long M = (long long)H * N;
  // THREADS is a multiple of CM, so a thread loads one sample's rows of a tile
  const int c = threadIdx.x % CM;
  for (long long m0 = (long long)blockIdx.x * CM; m0 < M; m0 += (long long)gridDim.x * CM) {
    __syncthreads();   // the weights, or the previous tile's reads of xn
    const long long m = m0 + c;
    const long long t = m / N;
    const float* x = states + (t * S) * N + (m - t * N);   // row s at x[s * N]
    for (int s = threadIdx.x / CM; s < S; s += THREADS / CM)
      xn[s * CM + c] = m < M ? (x[(size_t)s * N] - __ldg(norm_avg + s)) /
                                   (__ldg(norm_std + s) + 1e-4f)
                             : 0.f;
    __syncthreads();
    dense_tile(W1T, b1, xn, h1, D1, S);
    __syncthreads();
    dense_tile(W2T, b2, h1, xn, D2, D1);   // h2 over the input tile
    __syncthreads();
    if (threadIdx.x < CM && m0 + threadIdx.x < M) {
      float v = wo[D2];
      for (int k = 0; k < D2; ++k) v = fmaf(wo[k], xn[k * CM + threadIdx.x], v);
      val[m0 + threadIdx.x] = v;
    }
  }
}

// ------------------------------------------------- K4: the stock actor
// The on-policy stock rollout's actor kernel (replaces the actor half of
// pallas_rollout.py:_make_kernel :600 with make_stock_body :451; the critic
// runs afterwards in critic_values_kernel).  The function is that of
// fused_rollout_kernel<StockBody> without the critic: the same outputs, the
// same Philox bits, the same trade loop with its _rn intrinsics.
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

// Shared memory of one block (floats), clusters of c: the weight slices row
// by row (W1's rows at the lane columns, W2's rows, Wo's columns:
// cluster_mlp.cuh) and biases, exp(std_log), the day's normalised market
// rows and W1's market columns times them, the next day's close prices (two
// steps' worth), then (rows, TE) tiles: the lanes' raw and normalised obs
// rows, the whole h1, this block's rows of h2, every block's part of the
// mean, the head's uniforms and normals, the env actions, and the split-K
// scratch.
struct StockActorLayout {
  int js1, js2, k2, w1l, b1, w2, b2, wo, bo, stdv, xm, msm, pnext, xraw, xl, h1, h2, outp, ubuf,
      zbuf, ea, scratch, floats;
  __host__ __device__ StockActorLayout(int D1, int D2, int c) {
    constexpr int L = StockBody::S_LANE, AP = cm::round4(StockBody::A);
    js1 = cm::slice(D1, c);
    js2 = cm::slice(D2, c);
    k2 = c * js1;
    int o = 0;
    w1l = o; o += js1 * cm::ldk(L);
    b1 = o; o += js1;
    w2 = o; o += js2 * cm::ldk(k2);
    b2 = o; o += js2;
    wo = o; o += AP * cm::ldk(js2);
    bo = o; o += AP;
    stdv = o; o += AP;
    xm = o; o += cm::round4(StockBody::S - L);
    msm = o; o += js1;
    pnext = o; o += 2 * cm::round4(StockBody::NS);
    xraw = o; o += L * TE;
    xl = o; o += L * TE;
    h1 = o; o += k2 * TE;
    h2 = o; o += js2 * TE;
    outp = o; o += c * AP * TE;
    ubuf = o; o += 32 * TE;
    zbuf = o; o += AP * TE;
    ea = o; o += AP * TE;
    scratch = o; o += cm::SCRATCH;
    floats = o;
  }
};

__global__ void __launch_bounds__(cm::THREADS, 2)
stock_actor_kernel(const StockBody body, const float* __restrict__ act_flat,
                   const float* __restrict__ norm_avg, const float* __restrict__ norm_std,
                   const float* __restrict__ env_f, const int* __restrict__ env_i,
                   const float* __restrict__ noise, const int* __restrict__ seed,
                   float* __restrict__ states_o, float* __restrict__ actions_o,
                   float* __restrict__ logp_o, float* __restrict__ rew_o,
                   float* __restrict__ term_o, float* __restrict__ trunc_o,
                   float* __restrict__ env_f_o, int* __restrict__ env_i_o, int N, int H, int D1,
                   int D2, float reward_scale) {
  constexpr int S = StockBody::S, A = StockBody::A, F = StockBody::F, NS = StockBody::NS;
  constexpr int L = StockBody::S_LANE, NM = S - L, AP = cm::round4(A), NP = cm::round4(NS);
  constexpr int N_ENV = StockBody::N_RESET;           // no step uniforms
  constexpr int NZ = A + N_ENV;                       // injected rows
  constexpr int N_HEAD = 2 * A;                       // head uniforms: words 0 .. 29
  constexpr int HB = (N_HEAD + 3) / 4;                // head Philox blocks
  constexpr int RB0 = N_HEAD / 4, RB1 = (N_HEAD + N_ENV + 3) / 4;  // the reset's blocks
  static_assert(4 * HB <= 32, "ubuf holds 32 words a lane");

  cm::cg::cluster_group cluster = cm::cg::this_cluster();
  const int c = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int grp = blockIdx.x / c;
  const StockActorLayout Ly(D1, D2, c);
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  float *w1l = sm + Ly.w1l, *b1s = sm + Ly.b1, *w2s = sm + Ly.w2, *b2s = sm + Ly.b2;
  float *wos = sm + Ly.wo, *bos = sm + Ly.bo, *stdv = sm + Ly.stdv, *xm = sm + Ly.xm;
  float *msm = sm + Ly.msm, *pnext = sm + Ly.pnext, *xraw = sm + Ly.xraw, *xl = sm + Ly.xl;
  float *h1 = sm + Ly.h1, *h2 = sm + Ly.h2, *outp = sm + Ly.outp, *ubuf = sm + Ly.ubuf;
  float *zbuf = sm + Ly.zbuf, *ea = sm + Ly.ea, *scratch = sm + Ly.scratch;
  const int js1 = Ly.js1, js2 = Ly.js2, j1 = rank * js1, j2 = rank * js2;
  cm::cluster_arrive();  // this block has started

  // the actor's leaves: W1 (D1, S), b1, W2 (D2, D1), b2, Wo (A, D2), bo, std_log
  const float* W1 = act_flat;
  const float* W2 = W1 + D1 * S + D1;
  const float* Wo = W2 + D2 * D1 + D2;
  const float* std_log = Wo + A * D2 + A;
  cm::load_rows<false>(W1, D1, S, j1, js1, 0, L, w1l, cm::ldk(L));
  cm::load_vec<false>(W1 + D1 * S, D1, j1, js1, b1s);
  cm::load_rows<false>(W2, D2, D1, j2, js2, 0, Ly.k2, w2s, cm::ldk(Ly.k2));
  cm::load_vec<false>(W2 + D2 * D1, D2, j2, js2, b2s);
  cm::load_rows<false>(Wo, A, D2, 0, AP, j2, js2, wos, cm::ldk(js2));
  cm::load_vec<false>(Wo + A * D2, A, 0, AP, bos);
  for (int a = threadIdx.x; a < AP; a += blockDim.x) stdv[a] = a < A ? expf(std_log[a]) : 0.f;

  // warp 0 holds the env rows of the group's lanes (every block of the cluster)
  const int e = threadIdx.x;  // the lane of a warp-0 thread
  const bool w0 = threadIdx.x < TE;
  const int n = grp * TE + (threadIdx.x & (TE - 1));
  const bool live = w0 && n < N;
  int day = env_i[grp * TE];  // the group's day: its first lane's
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
    for (int a = 0; a < A; ++a) log_std_sum += logf(expf(std_log[a]));
  }
  uint2 key = make_uint2(0u, 0u);
  if (noise == nullptr) key = make_uint2((uint32_t)seed[0], (uint32_t)seed[1]);

  // warp 0: the lanes' rows the next obs reads (all warps turn them into obs)
  auto lane_rows = [&]() {
#pragma unroll
    for (int s = 0; s < L; ++s) xraw[s * TE + e] = f[s];
  };
  // threads from `first` on, for step t on day d: the normalised market rows
  // (stored too, rows r = rank mod c), the next day's close prices and the
  // head's uniforms (internal noise)
  auto prepare = [&](int t, int d, int first) {
    const int i0 = (int)threadIdx.x - first, nth = cm::THREADS - first;
    if (i0 < 0) return;
    for (int r = i0; r < NM; r += nth)
      xm[r] = (body.market(d, L + r) - __ldg(norm_avg + L + r)) / (__ldg(norm_std + L + r) + 1e-4f);
    for (int k = i0; k < NS; k += nth)
      pnext[(t & 1) * NP + k] = __ldg(body.p.close + (size_t)(d + 1) * NS + k);
    const int mine = (NM - rank + c - 1) / c;
    for (int i = i0; i < mine * TE; i += nth) {
      const int r = L + rank + c * (i / TE), n2 = grp * TE + i % TE;
      if (n2 < N) states_o[((size_t)t * S + r) * N + n2] = body.market(d, r);
    }
    if (noise == nullptr) {
      for (int i = i0; i < HB * TE; i += nth) {
        const int b = i / TE, e2 = i % TE;
        const uint4 q = philox4x32_10(
            make_uint4((uint32_t)(grp * TE + e2), (uint32_t)t, (uint32_t)b, 0u), key);
        ubuf[(4 * b + 0) * TE + e2] = uniform24(q.x);
        ubuf[(4 * b + 1) * TE + e2] = uniform24(q.y);
        ubuf[(4 * b + 2) * TE + e2] = uniform24(q.z);
        ubuf[(4 * b + 3) * TE + e2] = uniform24(q.w);
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
          if (k < NM) v0 = fmaf(__ldg(w + k), xm[k], v0);
          if (k + 8 < NM) v1 = fmaf(__ldg(w + k + 8), xm[k + 8], v1);
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
    for (int i = threadIdx.x; i < (L + A) * TE; i += cm::THREADS) {
      const int e2 = i % TE, n2 = grp * TE + e2;
      if (i < L * TE) {
        const int s2 = i / TE;
        const float x = StockBody::obs_row(s2, xraw[i]);
        xl[i] = n2 < N ? (x - __ldg(norm_avg + s2)) / (__ldg(norm_std + s2) + 1e-4f) : 0.f;
        if (rank == 0 && n2 < N) states_o[((size_t)t * S + s2) * N + n2] = x;
      } else {
        const int a = i / TE - L;
        float z = 0.f;
        if (noise != nullptr) {
          if (n2 < N) z = noise[((size_t)t * NZ + a) * N + n2];
        } else {
          z = sqrtf(-2.0f * logf(1.0f - ubuf[a * TE + e2])) *
              cosf(TWO_PI_F * ubuf[(A + a) * TE + e2]);
        }
        zbuf[a * TE + e2] = z;
      }
    }
    __syncthreads();
    cm::tile_dense<TE>(w1l, cm::ldk(L), xl, L, js1, scratch, [&](int j, int m0, float4 v) {
      const float mj = msm[j], b = b1s[j];
      cm::store_cluster(cluster, c, h1, (j1 + j) * TE + m0,
                        make_float4(gelu_tanh((mj + v.x) + b), gelu_tanh((mj + v.y) + b),
                                    gelu_tanh((mj + v.z) + b), gelu_tanh((mj + v.w) + b)));
    });
    cluster.sync();  // every block's rows of h1, in every block
    cm::tile_dense<TE>(w2s, cm::ldk(Ly.k2), h1, Ly.k2, js2, scratch, [&](int j, int m0, float4 v) {
      const float b = b2s[j];
      *reinterpret_cast<float4*>(h2 + j * TE + m0) =
          make_float4(gelu_tanh(v.x + b), gelu_tanh(v.y + b), gelu_tanh(v.z + b),
                      gelu_tanh(v.w + b));
    });
    __syncthreads();
    cm::tile_dense<TE>(wos, cm::ldk(js2), h2, js2, AP, scratch, [&](int j, int m0, float4 v) {
      cm::store_cluster(cluster, c, outp, (rank * AP + j) * TE + m0, v);
    });
    cluster.sync();  // every block's part of the mean, in every block
    for (int i = threadIdx.x; i < A * TE; i += cm::THREADS) {
      const int a = i / TE, n2 = grp * TE + i % TE;
      float v = outp[i];
      for (int q = 1; q < c; ++q) v += outp[q * AP * TE + i];
      const float action = (v + bos[a]) + stdv[a] * zbuf[i];
      ea[i] = tanhf(action);
      if (rank == 0 && n2 < N) actions_o[((size_t)t * A + a) * N + n2] = action;
    }
    __syncthreads();
    day = day + 1 >= body.p.T - 1 ? 0 : day + 1;
    if (w0) {
      if (live) {
        float env_a[A], logp = -log_std_sum;
#pragma unroll
        for (int a = 0; a < A; ++a) {
          const float z = zbuf[a * TE + e];
          logp += -0.5f * z * z - LOG_SQRT_2PI;
          env_a[a] = ea[a * TE + e];
        }
        float reward;
        bool terminal, trunc;
        body.step_at(f, tc, pnext + (t & 1) * NP, env_a, reward, terminal, trunc);
        if (rank == 0) {
          const size_t o = (size_t)t * N + n;
          logp_o[o] = logp;
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
    if (t + 1 < H) prepare(t + 1, day, TE);  // the other warps, meanwhile
  }
  if (live && rank == 0) {
#pragma unroll
    for (int k = 0; k < F; ++k) env_f_o[(size_t)k * N + n] = f[k];
    env_i_o[n] = tc;
  }
}

int stock_actor_smem(int D1, int D2, int c) {
  return (int)sizeof(float) * StockActorLayout(D1, D2, c).floats;
}

}  // namespace

// Dynamic shared memory of one block, in bytes: both nets' weights (the
// actor's without std_log), then the xn, h1, h2 and out tiles (the layout
// of fused_rollout_kernel).
extern "C" int fused_rollout_smem_bytes(int S, int A, int D1, int D2) {
  const int net_floats = D1 * S + D1 + D2 * D1 + D2;
  return (int)sizeof(float) *
         (2 * net_floats + A * D2 + A + D2 + 1 + (S + D1 + D2 + A + 1) * TE);
}

// body: 0 Pendulum-v1, 1 CartPole-v1, 2 HopperSlip-v0, 3 PointChasingVecEnv,
// 4 PointChasingDiscreteEnv (KernelEnvBody.kernel_id of ops/fused_rollout.py).
// Returns the CUDA error of the launch, or -1 for an unknown body.
extern "C" int fused_rollout(
    int body, const void* act_flat, const void* cri_flat, const void* norm_avg,
    const void* norm_std, const void* env_f, const void* env_i,
    const void* noise, const void* seed, void* states, void* actions,
    void* logp, void* rew, void* term, void* trunc, void* val, void* env_f_o,
    void* env_i_o, int N, int H, int D1, int D2, float reward_scale,
    void* stream) {
#define ELEGANTRL_LAUNCH(BODY)                                                  \
  return launch<BODY>(act_flat, cri_flat, norm_avg, norm_std, env_f, env_i,     \
                      noise, seed, states, actions, logp, rew, term, trunc,     \
                      val, env_f_o, env_i_o, N, H, D1, D2, reward_scale,        \
                      fused_rollout_smem_bytes(BODY::S, BODY::A, D1, D2),       \
                      (cudaStream_t)stream)
  switch (body) {
    case 0: ELEGANTRL_LAUNCH(PendulumBody);
    case 1: ELEGANTRL_LAUNCH(CartPoleBody);
    case 2: ELEGANTRL_LAUNCH(HopperBody);
    case 3: ELEGANTRL_LAUNCH(ChasingBody);
    case 4: ELEGANTRL_LAUNCH(ChasingDiscreteBody);
    default: return -1;
  }
#undef ELEGANTRL_LAUNCH
}

// Dynamic shared memory of one off-policy block, in bytes: the head's
// weights, then the xn, h1, h2 and out tiles.  head: 0 ddpg, 1 dqn,
// 2 dqn_enc, 3 dqn_duel, 4 sac, 5 modsac (OFFPOLICY_HEADS of
// ops/fused_rollout.py).
extern "C" int offpolicy_rollout_smem_bytes(int S, int A, int D1, int D2, int head) {
  return offpolicy_smem(S, A, D1, D2, head);
}

// The off-policy exploration rollout for the fifteen (body, head) pairs:
// ddpg, sac and modsac on Pendulum-v1 (0), HopperSlip-v0 (2) and
// PointChasingVecEnv (3); dqn, dqn_enc and dqn_duel on CartPole-v1 (1) and
// PointChasingDiscreteEnv (4).  std_lo and std_hi clip the SAC heads'
// log_std.  Returns the CUDA error of the launch, or -1 for a pair it does
// not have.
extern "C" int offpolicy_rollout(int body, int head, const void* flat, const void* env_f,
                                 const void* env_i, const void* noise, const void* seed,
                                 void* states, void* actions, void* rew, void* term,
                                 void* trunc, void* env_f_o, void* env_i_o, int N, int H,
                                 int D1, int D2, float reward_scale, float noise_std,
                                 float explore_rate, float std_lo, float std_hi,
                                 void* stream) {
#define ELEGANTRL_OFF(BODY, HEAD)                                                     \
  return launch_offpolicy<BODY, HEAD>(flat, env_f, env_i, noise, seed, states,        \
                                      actions, rew, term, trunc, env_f_o, env_i_o, N, \
                                      H, D1, D2, reward_scale, noise_std,             \
                                      explore_rate, std_lo, std_hi, (cudaStream_t)stream)
  switch (body * 8 + head) {
    case 0 * 8 + HEAD_DDPG: ELEGANTRL_OFF(PendulumBody, HEAD_DDPG);
    case 2 * 8 + HEAD_DDPG: ELEGANTRL_OFF(HopperBody, HEAD_DDPG);
    case 3 * 8 + HEAD_DDPG: ELEGANTRL_OFF(ChasingBody, HEAD_DDPG);
    case 0 * 8 + HEAD_SAC: ELEGANTRL_OFF(PendulumBody, HEAD_SAC);
    case 2 * 8 + HEAD_SAC: ELEGANTRL_OFF(HopperBody, HEAD_SAC);
    case 3 * 8 + HEAD_SAC: ELEGANTRL_OFF(ChasingBody, HEAD_SAC);
    case 0 * 8 + HEAD_MODSAC: ELEGANTRL_OFF(PendulumBody, HEAD_MODSAC);
    case 2 * 8 + HEAD_MODSAC: ELEGANTRL_OFF(HopperBody, HEAD_MODSAC);
    case 3 * 8 + HEAD_MODSAC: ELEGANTRL_OFF(ChasingBody, HEAD_MODSAC);
    case 1 * 8 + HEAD_DQN: ELEGANTRL_OFF(CartPoleBody, HEAD_DQN);
    case 1 * 8 + HEAD_DQN_ENC: ELEGANTRL_OFF(CartPoleBody, HEAD_DQN_ENC);
    case 1 * 8 + HEAD_DQN_DUEL: ELEGANTRL_OFF(CartPoleBody, HEAD_DQN_DUEL);
    case 4 * 8 + HEAD_DQN: ELEGANTRL_OFF(ChasingDiscreteBody, HEAD_DQN);
    case 4 * 8 + HEAD_DQN_ENC: ELEGANTRL_OFF(ChasingDiscreteBody, HEAD_DQN_ENC);
    case 4 * 8 + HEAD_DQN_DUEL: ELEGANTRL_OFF(ChasingDiscreteBody, HEAD_DQN_DUEL);
    default: return -1;
  }
#undef ELEGANTRL_OFF
}

// StockTradingEnv-v2: the actor-only rollout (K4, stock_actor_kernel;
// values are left to critic_values).  Shared memory of one block for
// clusters of c blocks.
extern "C" int stock_rollout_smem_bytes(int D1, int D2, int c) { return stock_actor_smem(D1, D2, c); }

// The cluster size for N lanes: `cluster` when it is 1, 2, 4 or 8; with 0,
// the largest of 8, 4, 2, 1 whose layout fits and whose clusters of the
// ceil(N / 32) groups the card holds all at once (else the largest that
// fits of 2 and 1).  Returns 0 when none fits or on a CUDA error.
int stock_cluster(int N, int D1, int D2, int cluster) {
  constexpr int SMEM_LIMIT = 232448;
  if (cluster == 1 || cluster == 2 || cluster == 4 || cluster == 8)
    return stock_actor_smem(D1, D2, cluster) <= SMEM_LIMIT ? cluster : 0;
  if (cluster != 0) return 0;
  const int groups = (N + TE - 1) / TE;
  int fallback = 0;
  for (int c : {8, 4, 2, 1}) {
    const int smem = stock_actor_smem(D1, D2, c);
    if (smem > SMEM_LIMIT) continue;
    if (c <= 2 && fallback == 0) fallback = c;
    if (cudaFuncSetAttribute(stock_actor_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem) != cudaSuccess)
      return 0;
    const int active = cm::active_clusters(stock_actor_kernel, c, smem);
    if (active == 0) return 0;
    if (groups <= active) return c;
  }
  return fallback;
}

extern "C" int stock_rollout_cluster(int N, int D1, int D2, int cluster) {
  return stock_cluster(N, D1, D2, cluster);
}

extern "C" int stock_rollout(const void* act_flat, const void* norm_avg, const void* norm_std,
                             const void* env_f, const void* env_i, const void* noise,
                             const void* seed, void* states, void* actions, void* logp,
                             void* rew, void* term, void* trunc, void* env_f_o, void* env_i_o,
                             int N, int H, int D1, int D2, float reward_scale, int cluster,
                             const StockArgs* args, void* stream) {
  const StockBody body{*args};
  if (N == 0) return 0;
  const int c = stock_cluster(N, D1, D2, cluster);
  if (c == 0) {
    const cudaError_t err = cudaGetLastError();
    return (int)(err != cudaSuccess ? err : cudaErrorInvalidValue);
  }
  const int smem = stock_actor_smem(D1, D2, c);
  cudaError_t err = cudaFuncSetAttribute(
      stock_actor_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int groups = (N + TE - 1) / TE;
  return (int)cm::launch_clusters(
      stock_actor_kernel, groups * c, c, smem, (cudaStream_t)stream, body,
      (const float*)act_flat, (const float*)norm_avg, (const float*)norm_std,
      (const float*)env_f, (const int*)env_i, (const float*)noise, (const int*)seed,
      (float*)states, (float*)actions, (float*)logp, (float*)rew, (float*)term, (float*)trunc,
      (float*)env_f_o, (int*)env_i_o, N, H, D1, D2, reward_scale);
}

// The critic pass: val (H, N) from the stored states (H, S, N).
extern "C" int critic_values_smem_bytes(int S, int D1, int D2) { return critic_smem(S, D1, D2); }

extern "C" int critic_values(const void* cri_flat, const void* norm_avg, const void* norm_std,
                             const void* states, void* val, int S, int N, int H, int D1, int D2,
                             void* stream) {
  const int smem_bytes = critic_smem(S, D1, D2);
  cudaError_t err = cudaFuncSetAttribute(
      critic_values_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)err;
  const long long tiles = ((long long)H * N + CM - 1) / CM;
  const int blocks = (int)(tiles < sms ? tiles : sms);   // one block per SM, looping over tiles
  critic_values_kernel<<<blocks, THREADS, smem_bytes, (cudaStream_t)stream>>>(
      (const float*)cri_flat, (const float*)norm_avg, (const float*)norm_std,
      (const float*)states, (float*)val, S, N, H, D1, D2);
  return (int)cudaGetLastError();
}

// The off-policy exploration rollout on StockBody: the ddpg, sac and modsac
// heads.  Returns the CUDA error of the launch, or -1 for another head.
extern "C" int offpolicy_stock_rollout(int head, const void* flat, const void* env_f,
                                       const void* env_i, const void* noise, const void* seed,
                                       void* states, void* actions, void* rew, void* term,
                                       void* trunc, void* env_f_o, void* env_i_o, int N, int H,
                                       int D1, int D2, float reward_scale, float noise_std,
                                       float explore_rate, float std_lo, float std_hi,
                                       const StockArgs* args, void* stream) {
  const StockBody body{*args};
#define ELEGANTRL_STOCK(HEAD)                                                               \
  return launch_offpolicy<StockBody, HEAD>(flat, env_f, env_i, noise, seed, states, actions, \
                                           rew, term, trunc, env_f_o, env_i_o, N, H, D1, D2, \
                                           reward_scale, noise_std, explore_rate, std_lo,    \
                                           std_hi, (cudaStream_t)stream, body)
  switch (head) {
    case HEAD_DDPG: ELEGANTRL_STOCK(HEAD_DDPG);
    case HEAD_SAC: ELEGANTRL_STOCK(HEAD_SAC);
    case HEAD_MODSAC: ELEGANTRL_STOCK(HEAD_MODSAC);
    default: return -1;
  }
#undef ELEGANTRL_STOCK
}
