"""Fused whole-rollout kernel for the on-policy agents (counterpart of
``elegantrl_tpu/ops/pallas_rollout.py``: ``_make_kernel`` with the Pendulum,
CartPole, HopperSlip, PointChasing and StockTrading bodies and the Gaussian
and categorical heads).

For every env lane and each of H steps: normalise the obs, run the actor
and critic MLPs (two tanh-GELU hidden layers), sample an action, store it
with its logprob and the critic value, step the env, scale the reward,
record terminal/truncate and reset the done lanes from uniforms.

- Gaussian head: ``z ~ N(0, 1)``, the raw action ``mean + std*z`` is stored
  with ``logp = sum(-z^2/2 - log std - log sqrt(2 pi))`` and the env acts on
  ``tanh(action)``.
- Categorical head: Gumbel-max, ``g = -log(-log(max(u, 1e-12)) + 1e-12)``,
  ``action = argmax(logits + g)`` (first maximum on a tie), ``logp =
  logits[action] - logsumexp(logits)``; the action index is stored as int32
  ``(H, N)`` and the env receives it as a float row.

Outputs keep the kernel-native ``(H, S, N)`` layout, flagged by the
``'tsn'`` extras marker all the way into the update.

The stock body (:func:`make_stock_body`, one instance per env, holding its
market tables) has a 151-wide obs, and both nets with their tiles need
350,144 bytes of shared memory, more than a Hopper block holds.  On the card
its rollout is therefore two kernels: the actor kernel (K4's
``stock_actor_kernel``: a group of ``_TE`` lanes on a thread-block cluster
whose blocks each hold a slice of the actor, :func:`actor_smem_bytes`),
which leaves the values alone, then :func:`critic_values`, the critic over
the stored ``(H, S, N)`` states (215,824 bytes, tiles of 64 samples).  The
outputs are those of the one-kernel route.  The body reads the day of its
group's first lane (:func:`block_day`): every env starts at day 0 and ends
at the shared last day, so the day is the same on every lane of a group,
its 135 market rows are filled once for all lanes, and the kernel applies
the actor's first layer to them once per step.

Three pieces, as for every kernel of the port:

- :func:`rollout_reference`, the plain PyTorch version;
- :func:`rollout`, the wrapper: for CPU tensors it runs the plain version,
  for CUDA tensors it launches ``csrc/fused_rollout.cu`` (or raises);
- ``rollout.launches``, the count of kernel launches (``rollout.launches_by_body``
  splits it by env body).

Noise has two modes, as in the JAX package: *injected*, a ``(H, A +
n_step + n_reset, N)`` tensor (Gaussian head: A normals, then the env's
step and reset uniforms; categorical head: all uniforms), and *internal*, a
Philox4x32-10 counter-based generator keyed by a ``(2,)`` int32 seed tensor.
Internal mode needs ``2A`` (Gaussian, Box-Muller: ``z = sqrt(-2 log(1-u))
cos(2 pi u')`` with u in [0, 1), so the log never sees 0) or ``A``
(categorical) uniforms plus ``n_step + n_reset`` per (lane, step); uniform
``j`` is word ``j % 4`` of the Philox block with counter ``(lane, step,
j // 4, 0)``.  The plain version implements the same Philox, so both modes
give the same bits on either side.
"""

from __future__ import annotations

import ctypes
import math
from typing import Any, Callable, NamedTuple, Optional, Sequence

import torch

from .dists import LOG_SQRT_2PI
from .nets import mlp_apply_leaves, ppo_param_shapes, split_flat

_TWO_PI = 2.0 * math.pi

# shared memory a block may use on Hopper (sm_90), bytes
SMEM_LIMIT = 232448
# env lanes per CUDA block (one warp lane per env), as csrc/fused_rollout.cu
_TE = 32


class KernelEnvBody(NamedTuple):
    """An env inlined into the fused rollout, on ``(rows, N)`` tensors.
    ``step`` does not reset; ``reset`` applies the masked re-init from
    ``n_reset`` uniform rows.  ``action_dim`` is the env's action dim, or
    the number of actions when ``discrete`` (the categorical head)."""
    env_name: str
    state_dim: int
    action_dim: int
    n_f32: int
    n_i32: int
    n_reset: int
    pack: Callable      # env_state -> (f32 (n_f32, N), int32 (n_i32, N))
    unpack: Callable    # (f32, int32) -> env_state
    obs: Callable       # (f32, int32) -> (S, N)
    step: Callable      # (f32, int32, env_action, u (n_step, N)) ->
    #                     (f32', int32', reward (1, N), terminal, truncate);
    #                     env_action is (A, N), or the (1, N) index row
    reset: Callable     # (f32', int32', u (n_reset, N), done (1, N)) -> (f32, int32)
    n_step: int = 0     # uniforms the step itself consumes (env randomness)
    discrete: bool = False
    kernel_id: int = 0  # the body's number in csrc/fused_rollout.cu
    # market-data bodies (the stock env, an instance per env): the tables
    # (envs/stock_trading.py:MarketTables), which obs, step and reset read
    # on the device of their rows, and the env's constants
    tables: Any = None
    params: Any = None


def _masked_reset(f, i, fresh, done):
    return torch.where(done, fresh, f), torch.where(done, torch.zeros_like(i[0:1]), i[0:1])


# ---------------------------------------------------------------- Pendulum

def _pend_pack(s):
    return torch.stack([s.theta, s.theta_dot]), s.t.reshape(1, -1).to(torch.int32)


def _pend_unpack(f, i):
    from ..envs.pendulum import PendulumState
    return PendulumState(theta=f[0], theta_dot=f[1], t=i[0])


def _pend_obs(f, i):
    th, thdot = f[0:1], f[1:2]
    return torch.cat([torch.cos(th), torch.sin(th), thdot], dim=0)


def _wrap_angle(x):
    """The JAX kernel body's floor form of ``((x + pi) mod 2pi) - pi``."""
    y = x + math.pi
    return y - torch.floor(y / _TWO_PI) * _TWO_PI - math.pi


def _pend_step(f, i, a, u=None):
    th, thdot = f[0:1], f[1:2]
    u_trq = torch.clamp(a[0:1] * 2.0, -2.0, 2.0)
    cost = (torch.square(_wrap_angle(th)) + 0.1 * torch.square(thdot)
            + 0.001 * torch.square(u_trq))
    reward = -0.5 * cost
    thdot2 = torch.clamp(thdot + (15.0 * torch.sin(th) + 3.0 * u_trq) * 0.05, -8.0, 8.0)
    th2 = th + thdot2 * 0.05
    tc2 = i[0:1] + 1
    trunc = tc2 >= 200
    return torch.cat([th2, thdot2], dim=0), tc2, reward, torch.zeros_like(trunc), trunc


def _pend_reset(f, i, u, done):
    fresh = torch.cat([-math.pi + _TWO_PI * u[0:1], -1.0 + 2.0 * u[1:2]], dim=0)
    return _masked_reset(f, i, fresh, done)


PENDULUM_BODY = KernelEnvBody(
    env_name='Pendulum-v1', state_dim=3, action_dim=1, n_f32=2, n_i32=1,
    n_reset=2, pack=_pend_pack, unpack=_pend_unpack, obs=_pend_obs,
    step=_pend_step, reset=_pend_reset, kernel_id=0)


# ---------------------------------------------------------------- CartPole

def _cp_pack(s):
    return (torch.stack([s.x, s.x_dot, s.theta, s.theta_dot]),
            s.t.reshape(1, -1).to(torch.int32))


def _cp_unpack(f, i):
    from ..envs.cartpole import CartPoleState
    return CartPoleState(x=f[0], x_dot=f[1], theta=f[2], theta_dot=f[3], t=i[0])


def _cp_obs(f, i):
    return f   # the obs is the 4 state rows


_CP_THETA_LIMIT = 12.0 * 2.0 * math.pi / 360.0


def _cp_step(f, i, a, u=None):
    """Euler dt = 0.02, force +-10 N (the action row carries 0/1), terminal
    on |x| > 2.4 or |theta| > 12 deg, truncation at 500, reward 1."""
    x, x_dot, theta, theta_dot = f[0:1], f[1:2], f[2:3], f[3:4]
    force = torch.where(a[0:1] > 0.5, 10.0, -10.0)
    cos_t, sin_t = torch.cos(theta), torch.sin(theta)
    temp = (force + 0.05 * torch.square(theta_dot) * sin_t) / 1.1
    theta_acc = (9.8 * sin_t - cos_t * temp) / (
        0.5 * (4.0 / 3.0 - 0.1 * torch.square(cos_t) / 1.1))
    x_acc = temp - 0.05 * theta_acc * cos_t / 1.1
    x2 = x + 0.02 * x_dot
    x_dot2 = x_dot + 0.02 * x_acc
    theta2 = theta + 0.02 * theta_dot
    theta_dot2 = theta_dot + 0.02 * theta_acc
    t2 = i[0:1] + 1
    terminal = (torch.abs(x2) > 2.4) | (torch.abs(theta2) > _CP_THETA_LIMIT)
    trunc = (t2 >= 500) & ~terminal
    return (torch.cat([x2, x_dot2, theta2, theta_dot2], dim=0), t2,
            torch.ones_like(x2), terminal, trunc)


def _cp_reset(f, i, u, done):
    return _masked_reset(f, i, -0.05 + 0.1 * u, done)   # 4 rows in [-0.05, 0.05)


CARTPOLE_BODY = KernelEnvBody(
    env_name='CartPole-v1', state_dim=4, action_dim=2, n_f32=4, n_i32=1,
    n_reset=4, pack=_cp_pack, unpack=_cp_unpack, obs=_cp_obs,
    step=_cp_step, reset=_cp_reset, discrete=True, kernel_id=1)


# ------------------------------------------------------------------ Hopper

_ATAN_C = (9.9999990555e-01, -3.3332657853e-01, 1.9986537489e-01,
           -1.4164333375e-01, 1.0507319787e-01, -7.2479506621e-02,
           3.9899560039e-02, -1.4458697067e-02, 2.4682466247e-03)


def _atan2(y, x):
    """The JAX hopper body's atan2: a 9-term odd polynomial in
    ``t = min(|x|, |y|) / max(|x|, |y|)`` (Horner), ``pi/2 - r`` where
    ``|y| > |x|``, then the quadrant from the signs.  The kernel evaluates
    the same polynomial, so the three agree to rounding."""
    ax, ay = torch.abs(x), torch.abs(y)
    t = torch.minimum(ax, ay) / torch.clamp(torch.maximum(ax, ay), min=1e-30)
    t2 = t * t
    p = torch.full_like(t, _ATAN_C[-1])
    for c in _ATAN_C[-2::-1]:
        p = p * t2 + c
    r = p * t
    r = torch.where(ay > ax, 0.5 * math.pi - r, r)
    r = torch.where(x < 0, math.pi - r, r)
    return torch.where(y < 0, -r, r)


def _hop_pack(s):
    return (torch.stack([s.x, s.z, s.vx, s.vz, s.leg_angle, s.leg_len, s.foot_x,
                         s.stance.float()]), s.t.reshape(1, -1).to(torch.int32))


def _hop_unpack(f, i):
    from ..envs.hopper import HopperState
    return HopperState(x=f[0], z=f[1], vx=f[2], vz=f[3], leg_angle=f[4], leg_len=f[5],
                       foot_x=f[6], stance=f[7] > 0.5, t=i[0])


def _hop_obs(f, i):
    return torch.cat([f[1:2], f[2:3], f[3:4], f[4:5], f[5:6] / 0.55, f[7:8]], dim=0)


def _hop_step(f, i, a, u=None):
    """The SLIP step of ``envs/hopper.py``: flight and stance branches are
    both computed and blended; the stance flag is a float row."""
    x, z, vx, vz = f[0:1], f[1:2], f[2:3], f[3:4]
    leg_angle, foot_x, stance = f[4:5], f[6:7], f[7:8]
    target_angle = torch.clamp(a[0:1], -1.0, 1.0) * 0.5
    thrust = torch.clamp(a[1:2], -1.0, 1.0) * 0.5 + 0.5
    DT, G, LEG, K, THR = 0.01, 9.8, 0.55, 300.0, 60.0

    fl_angle = leg_angle + 10.0 * (target_angle - leg_angle) * DT
    fl_vz = vz - G * DT
    fl_z = z + fl_vz * DT
    fl_x = x + vx * DT
    foot_z = fl_z - LEG * torch.cos(fl_angle)
    touchdown = (foot_z <= 0.0) & (fl_vz < 0)
    fl_foot_x = torch.where(touchdown, fl_x + LEG * torch.sin(fl_angle), foot_x)

    dx = x - foot_x
    st_len = torch.sqrt(dx * dx + z * z)
    compress = torch.clamp(LEG - st_len, min=0.0)
    force = K * compress + THR * thrust
    ux, uz = dx / (st_len + 1e-6), z / (st_len + 1e-6)
    st_vx = vx + force * ux * DT
    st_vz = vz + (force * uz - G) * DT
    st_x = x + st_vx * DT
    st_z = z + st_vz * DT
    new_len = torch.sqrt(torch.square(st_x - foot_x) + torch.square(st_z))
    liftoff = (new_len >= LEG) & (st_vz > 0)
    st_angle = _atan2(st_x - foot_x, st_z)

    in_st = stance > 0.5
    x2 = torch.where(in_st, st_x, fl_x)
    z2 = torch.where(in_st, st_z, fl_z)
    vx2 = torch.where(in_st, st_vx, vx)
    vz2 = torch.where(in_st, st_vz, fl_vz)
    angle2 = torch.where(in_st, st_angle, fl_angle)
    len2 = torch.where(in_st, new_len, torch.full_like(new_len, LEG))
    foot2 = torch.where(in_st, foot_x, fl_foot_x)
    stance2 = torch.where(in_st, 1.0 - liftoff.float(), touchdown.float())
    t2 = i[0:1] + 1
    reward = vx2 + 0.5 - 0.05 * (torch.square(a[0:1]) + torch.square(a[1:2]))
    terminal = z2 < 0.25
    trunc = (t2 >= 1000) & ~terminal
    f2 = torch.cat([x2, z2, vx2, vz2, angle2, len2, foot2, stance2], dim=0)
    return f2, t2, reward, terminal, trunc


def _hop_reset(f, i, u, done):
    z0 = 0.9 + (-0.05 + 0.1 * u[0:1])
    vx0 = -0.1 + 0.2 * u[1:2]
    zero = torch.zeros_like(z0)
    fresh = torch.cat([zero, z0, vx0, zero, zero, torch.full_like(z0, 0.55), zero, zero],
                      dim=0)
    return _masked_reset(f, i, fresh, done)


HOPPER_BODY = KernelEnvBody(
    env_name='HopperSlip-v0', state_dim=6, action_dim=2, n_f32=8, n_i32=1,
    n_reset=2, pack=_hop_pack, unpack=_hop_unpack, obs=_hop_obs,
    step=_hop_step, reset=_hop_reset, kernel_id=2)


# ------------------------------------------------------------ PointChasing

_CHASE_DIM = 2   # the body is fixed to the env's default dim; rows are
#                  [p0 (dim), v0 (dim), p1 (dim), v1 (dim), distance (1)]
_INIT_DIST = 8.0


def _chase_pack(s):
    return (torch.cat([s.p0.T, s.v0.T, s.p1.T, s.v1.T, s.distance[None]], dim=0),
            s.t.reshape(1, -1).to(torch.int32))


def _chase_unpack(f, i):
    from ..envs.point_chasing import ChasingState
    d = _CHASE_DIM
    return ChasingState(p0=f[0:d].T, v0=f[d:2 * d].T, p1=f[2 * d:3 * d].T,
                        v1=f[3 * d:4 * d].T, distance=f[4 * d], t=i[0])


def _chase_obs(f, i):
    return f[0:4 * _CHASE_DIM]   # the obs is [p0, v0, p1, v1]


def _chase_cont_step(f, i, a, u):
    """L2-capped chase action, leaky-integrator velocities, the walker fed
    by the ``n_step`` uniform rows ``u``; terminal on ``distance < dim`` or
    at 1024 steps, never truncates."""
    d = _CHASE_DIM
    action_l2 = torch.clamp(torch.sqrt(torch.sum(torch.square(a), dim=0, keepdim=True)),
                            min=1.0)
    an = a / action_l2
    v1 = f[3 * d:4 * d] * 0.75 + an
    p1 = f[2 * d:3 * d] + v1 * 0.01
    v0 = f[d:2 * d] * 0.50 + u
    p0 = f[0:d] + v0 * 0.01
    dist = torch.sqrt(torch.sum(torch.square(p0 - p1), dim=0, keepdim=True))
    reward = f[4 * d:4 * d + 1] - dist - action_l2 * 0.02
    t2 = i[0:1] + 1
    terminal = (dist < float(d)) | (t2 >= 1024)
    f2 = torch.cat([p0, v0, p1, v1, dist], dim=0)
    return f2, t2, reward, terminal, torch.zeros_like(terminal)


def _chase_disc_step(f, i, a, u):
    """Base-3 digit decode of the action index (a float row) by the floor
    form, each digit mapped to {-1, 0, +1}, then the continuous step."""
    idx = a[0:1]
    rows = []
    for k in range(_CHASE_DIM):
        q = torch.floor(idx / float(3 ** k))
        rows.append(q - 3.0 * torch.floor(q / 3.0) - 1.0)
    return _chase_cont_step(f, i, torch.cat(rows, dim=0), u)


def _chase_reset(f, i, u, done):
    """p0 ~ N(0, 1)^dim, p1 ~ N(0, 1)^dim - 8, v = 0: normals by Box-Muller
    from the 2*dim reset uniforms (cos row to p0, sin row to p1)."""
    d = _CHASE_DIM
    r = torch.sqrt(-2.0 * torch.log(1.0 - u[0:d]))
    ang = _TWO_PI * u[d:2 * d]
    p0 = r * torch.cos(ang)
    p1 = r * torch.sin(ang) - _INIT_DIST
    dist = torch.sqrt(torch.sum(torch.square(p0 - p1), dim=0, keepdim=True))
    zero = torch.zeros_like(p0)
    return _masked_reset(f, i, torch.cat([p0, zero, p1, zero, dist], dim=0), done)


CHASING_BODY = KernelEnvBody(
    env_name='PointChasingVecEnv', state_dim=4 * _CHASE_DIM, action_dim=_CHASE_DIM,
    n_f32=4 * _CHASE_DIM + 1, n_i32=1, n_reset=2 * _CHASE_DIM, n_step=_CHASE_DIM,
    pack=_chase_pack, unpack=_chase_unpack, obs=_chase_obs,
    step=_chase_cont_step, reset=_chase_reset, kernel_id=3)

CHASING_DISCRETE_BODY = CHASING_BODY._replace(
    env_name='PointChasingDiscreteEnv', action_dim=3 ** _CHASE_DIM,
    step=_chase_disc_step, discrete=True, kernel_id=4)

KERNEL_ENV_BODIES = {b.env_name: b for b in
                     (PENDULUM_BODY, CARTPOLE_BODY, HOPPER_BODY, CHASING_BODY,
                      CHASING_DISCRETE_BODY)}

STOCK_KERNEL_STOCKS = 15   # the stock count csrc/fused_rollout.cu's StockBody is built for


def kernel_has_body(body: KernelEnvBody) -> bool:
    """Whether csrc/fused_rollout.cu implements this body: a registered one,
    or a market-data body of ``STOCK_KERNEL_STOCKS`` stocks (an env's own)."""
    if body.tables is not None:
        return body.action_dim == STOCK_KERNEL_STOCKS
    return KERNEL_ENV_BODIES.get(body.env_name) is body


def kernel_bodies_text(body: Optional[KernelEnvBody] = None) -> str:
    """The bodies the kernels implement, for an error's scope text; says why
    a market-data ``body`` of another stock count is not among them."""
    text = (f'{sorted(KERNEL_ENV_BODIES)} and the market-data body of '
            f'{STOCK_KERNEL_STOCKS} stocks')
    if body is not None and body.tables is not None and not kernel_has_body(body):
        text += (f' (the CUDA stock body is built for {STOCK_KERNEL_STOCKS} stocks; this '
                 f'market has {body.action_dim})')
    return text


# --------------------------------------------------------------- StockTrading
# The day is the same on every lane of a group: every env starts at day 0
# and ends only at the shared last day, so the body reads the day row of its
# group's first lane (``block_day``), as the CUDA kernels do per group.


def block_day(i: torch.Tensor) -> torch.Tensor:
    """(N,) day of each lane's group: the day row of the group's first lane
    (groups of ``_TE`` lanes, as the kernels')."""
    first = torch.div(torch.arange(i.shape[1], device=i.device), _TE,
                      rounding_mode='floor') * _TE
    return i[0, first].long()


def make_stock_body(tables, initial_amount: float = 1e6, max_stock: float = 1e2,
                    cost_pct: float = 1e-3, gamma: float = 0.99,
                    if_random_reset: bool = True) -> KernelEnvBody:
    """The fused-rollout body of ``envs/stock_trading.py:make_stock_trading``
    (the JAX package's ``pallas_rollout.py:make_stock_body``).

    Rows: cash, the S share counts, total asset, the episode's reward sum
    and the recorded cumulative return (f32); the day (int32).  The obs is
    ``tanh(cash 2^-18)``, ``tanh(shares 2^-10)``, ``close[day] 2^-7``,
    ``tech[day] 2^-6``; the step is the env's sequential trade loop, reward
    and terminal bonus; the reset jitters the cash by ``u0`` and draws the
    share lots from ``S`` normals made by Box-Muller from ``(S + 1) // 2``
    pairs of uniforms (``n_reset = 1 + 2 * pairs``)."""
    from ..envs.stock_trading import StockState, action_lots, total_asset, trade
    T, S = tables.close.shape
    TECH = tables.tech.shape[1]
    max_step = T - 1
    n_pairs = (S + 1) // 2

    def pack(s):
        return (torch.cat([s.amount[None], s.shares.T, s.total_asset[None], s.reward_sum[None],
                           s.cumulative_returns[None]]), s.day.reshape(1, -1).to(torch.int32))

    def unpack(f, i):
        return StockState(day=i[0], amount=f[0], shares=f[1:1 + S].T, total_asset=f[1 + S],
                          reward_sum=f[2 + S], cumulative_returns=f[3 + S])

    def obs(f, i):
        close, tech = tables.on(f.device)
        day = block_day(i)
        return torch.cat([torch.tanh(f[0:1] * 2.0 ** -18), torch.tanh(f[1:1 + S] * 2.0 ** -10),
                          close[day].T * 2.0 ** -7, tech[day].T * 2.0 ** -6])

    def step(f, i, a, u):
        close, _ = tables.on(f.device)
        day2 = block_day(i) + 1
        prices = close[day2].T                                  # (S, N)
        amount, shares = trade(f[0], f[1:1 + S], action_lots(a, max_stock), prices, cost_pct)
        total = total_asset(prices, shares, amount)
        reward = (total - f[1 + S]) * 2.0 ** -12
        reward_sum = f[2 + S] + reward
        i2 = i[0:1] + 1
        terminal = i2 >= max_step
        bonus = (reward_sum / i2[0].float()) / (1.0 - gamma)
        reward = torch.where(terminal[0], reward + bonus, reward)
        cum = torch.where(terminal[0], total / initial_amount * 100.0, f[3 + S])
        f2 = torch.cat([amount[None], shares, total[None], reward_sum[None], cum[None]])
        return f2, i2, reward[None], terminal, torch.zeros_like(terminal)

    def reset(f, i, u, done):
        close, _ = tables.on(f.device)
        if if_random_reset:
            amount0 = initial_amount * (u[0] * 0.5 + 0.75)
            r = torch.sqrt(-2.0 * torch.log(1.0 - u[1:1 + n_pairs]))
            ang = _TWO_PI * u[1 + n_pairs:1 + 2 * n_pairs]
            z = torch.cat([r * torch.cos(ang), r * torch.sin(ang)])[0:S]
            shares0 = torch.floor(torch.abs(torch.clamp(z, -2.0, 2.0))) * 2.0 ** 7
        else:
            amount0 = torch.full_like(u[0], initial_amount)
            shares0 = torch.zeros((S, u.shape[1]), device=u.device)
        total0 = total_asset(close[0][:, None], shares0, amount0)
        zero = torch.zeros_like(amount0)
        fresh = torch.cat([amount0[None], shares0, total0[None], zero[None], zero[None]])
        return _masked_reset(f, i, fresh, done)

    return KernelEnvBody(
        env_name='StockTradingEnv-v2', state_dim=1 + 2 * S + TECH, action_dim=S, n_f32=4 + S,
        n_i32=1, n_reset=1 + 2 * n_pairs, pack=pack, unpack=unpack, obs=obs, step=step,
        reset=reset, n_step=0, kernel_id=5, tables=tables,
        params=dict(initial_amount=float(initial_amount), max_stock=float(max_stock),
                    cost_pct=float(cost_pct), gamma=float(gamma),
                    if_random_reset=bool(if_random_reset)))


def noise_rows(body: KernelEnvBody) -> int:
    """Rows of the injected-noise tensor: A, then the env's uniforms."""
    return body.action_dim + body.n_step + body.n_reset


def uniforms_per_step(body: KernelEnvBody) -> int:
    """Uniforms the internal generator draws per (lane, step)."""
    head = body.action_dim if body.discrete else 2 * body.action_dim
    return head + body.n_step + body.n_reset


# ------------------------------------------------------------------ Philox

_M0, _M1 = 0xD2511F53, 0xCD9E8D57
_W0, _W1 = 0x9E3779B9, 0xBB67AE85
_MASK = 0xFFFFFFFF


def _mulhilo(a: torch.Tensor, m: int):
    """(hi, lo) 32-bit halves of ``a * m`` for ``a`` < 2^32 held in int64."""
    p1 = a * (m & 0xFFFF)
    p2 = a * (m >> 16)
    low = p1 + ((p2 & 0xFFFF) << 16)
    return ((p2 >> 16) + (low >> 32)) & _MASK, low & _MASK


def philox4x32(c0, c1, c2, c3, k0, k1):
    """Philox4x32-10 on int64 tensors holding uint32 values."""
    for _ in range(10):
        hi0, lo0 = _mulhilo(c0, _M0)
        hi1, lo1 = _mulhilo(c2, _M1)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0 = (k0 + _W0) & _MASK
        k1 = (k1 + _W1) & _MASK
    return c0, c1, c2, c3


def philox_uniforms(seed: torch.Tensor, horizon: int, num_envs: int,
                    count: int = 4) -> torch.Tensor:
    """The kernel's internal draws: ``(H, count, N)`` uniforms in [0, 1) with
    24-bit resolution; uniform ``j`` is word ``j % 4`` of the block with
    counter ``(lane, step, j // 4, 0)`` and key ``seed``."""
    dev = seed.device
    k = seed.to(torch.int64) & _MASK
    lane = torch.arange(num_envs, device=dev, dtype=torch.int64)[None, :]
    step = torch.arange(horizon, device=dev, dtype=torch.int64)[:, None]
    c0 = lane.expand(horizon, num_envs)
    c1 = step.expand(horizon, num_envs)
    zero = torch.zeros_like(c0)
    words = []
    for block in range((count + 3) // 4):
        words += philox4x32(c0, c1, zero + block, zero, k[0], k[1])
    return torch.stack([(w >> 8).to(torch.float32) * 2.0 ** -24 for w in words[:count]],
                       dim=1)


# --------------------------------------------------------- plain version

class RolloutOutputs(NamedTuple):
    states: torch.Tensor     # (H, S, N)
    actions: torch.Tensor    # (H, A, N) raw (pre-tanh); int32 (H, N) when discrete
    logprobs: torch.Tensor   # (H, N)
    rewards: torch.Tensor    # (H, N), times reward_scale
    terminals: torch.Tensor  # (H, N) float
    truncates: torch.Tensor  # (H, N) float
    values: torch.Tensor     # (H, N)
    env_f: torch.Tensor      # (n_f32, N) final env rows
    env_i: torch.Tensor      # (n_i32, N)


def _check_noise_mode(noise, seed):
    if (noise is None) == (seed is None):
        raise ValueError('give exactly one of noise (injected) and seed (internal)')


def rollout_reference(act_flat: torch.Tensor, cri_flat: torch.Tensor,
                      norm_avg: torch.Tensor, norm_std: torch.Tensor,
                      env_f: torch.Tensor, env_i: torch.Tensor, *,
                      net_dims: Sequence[int], horizon_len: int,
                      reward_scale: float, noise: Optional[torch.Tensor] = None,
                      seed: Optional[torch.Tensor] = None,
                      body: KernelEnvBody = PENDULUM_BODY,
                      env_trace: Optional[list] = None) -> RolloutOutputs:
    """Plain PyTorch version of the fused rollout kernel.  ``env_trace``, a
    list, receives the ``(env_f, env_i)`` rows each step starts from."""
    S, A = body.state_dim, body.action_dim
    act_shapes, cri_shapes = ppo_param_shapes(S, net_dims, A, body.discrete)
    act = split_flat(act_flat, act_shapes)
    cri = split_flat(cri_flat, cri_shapes)
    if not body.discrete:
        std = torch.exp(act[-1]).reshape(A, 1)
        log_std = torch.log(std)
        act = act[:-1]
    nstd = norm_std.reshape(S, 1) + 1e-4
    avg = norm_avg.reshape(S, 1)
    _check_noise_mode(noise, seed)
    if seed is not None:
        u_all = philox_uniforms(seed, horizon_len, env_f.shape[1], uniforms_per_step(body))
    f, i = env_f, env_i
    outs = {k: [] for k in RolloutOutputs._fields[:7]}
    for t in range(horizon_len):
        if env_trace is not None:
            env_trace.append((f, i))
        x = body.obs(f, i)                                   # (S, N)
        xn = ((x - avg) / nstd).T                            # (N, S)
        out = mlp_apply_leaves(act, xn).T                    # (A, N) mean or logits
        value = mlp_apply_leaves(cri, xn)[:, 0]              # (N,)
        if body.discrete:
            u = noise[t] if seed is None else u_all[t]
            g = -torch.log(-torch.log(torch.clamp(u[0:A], min=1e-12)) + 1e-12)
            index = torch.argmax(out + g, dim=0, keepdim=True)       # first max on a tie
            m = torch.max(out, dim=0, keepdim=True).values
            lse = m + torch.log(torch.sum(torch.exp(out - m), dim=0, keepdim=True))
            logp = (torch.gather(out, 0, index) - lse)[0]
            action = index[0].to(torch.int32)
            env_a = index.float()
            u_env = u[A:]
        else:
            if seed is None:
                z, u_env = noise[t, :A], noise[t, A:]
            else:
                u = u_all[t]
                z = torch.sqrt(-2.0 * torch.log(1.0 - u[0:A])) * torch.cos(_TWO_PI * u[A:2 * A])
                u_env = u[2 * A:]
            action = out + std * z
            logp = torch.sum(-0.5 * torch.square(z) - log_std - LOG_SQRT_2PI, dim=0)
            env_a = torch.tanh(action)
        f2, i2, reward, terminal, trunc = body.step(f, i, env_a, u_env[0:body.n_step])
        f, i = body.reset(f2, i2, u_env[body.n_step:body.n_step + body.n_reset],
                          terminal | trunc)
        outs['states'].append(x)
        outs['actions'].append(action)
        outs['logprobs'].append(logp)
        outs['rewards'].append(reward[0] * reward_scale)
        outs['terminals'].append(terminal[0].float())
        outs['truncates'].append(trunc[0].float())
        outs['values'].append(value)
    return RolloutOutputs(*[torch.stack(v) for v in outs.values()], f, i)


# ---------------------------------------------------------------- wrapper

ROLLOUT_CLUSTERS = (1, 2, 4, 8)   # the cluster sizes the rollout kernel takes


def rollout_smem_bytes(body: KernelEnvBody, net_dims: Sequence[int], cluster: int) -> int:
    """Shared memory of one block of the rollout kernel (K1, K3) for clusters
    of ``cluster`` blocks over a group of ``_TE`` lanes: the block's slices
    of both nets' weights row by row (a row of K inputs takes
    ``kernels.ldk(K)`` floats: both W1's rows, both W2's rows, the heads'
    columns), the biases, stds and the normalisation, then the lane tiles
    (the obs, both whole h1, the block's rows of both h2, every block's part
    of the heads, two steps' noise words, the head noise and sums) and the
    split-K scratch of the widest product (``cm::tile_dense``'s count of
    parts: :func:`tile_scratch`).  ``csrc/fused_rollout.cu``
    owns the layout (``RolloutLayout``, ``fused_rollout_smem_bytes``); this
    copy judges eligibility where the library is not built (the CPU)."""
    from .kernels import ldk
    D1, D2 = (int(d) for d in net_dims)
    S, A, c = body.state_dim, body.action_dim, int(cluster)
    r4 = lambda n: (n + 3) // 4 * 4  # noqa: E731
    s4, ap = r4(S), r4(A)
    nh4 = r4(A if body.discrete else 2 * A)
    ne4 = r4(max(body.n_step + body.n_reset, 1))
    js1, js2 = r4(-(-D1 // c)), r4(-(-D2 // c))
    k2 = c * js1
    weights = (2 * js1 * ldk(S) + 2 * js1 + 2 * js2 * ldk(k2) + 2 * js2 + ap * ldk(js2)
               + 4 * ldk(js2) + 2 * ap + 4 + 2 * s4)
    tiles = (s4 + 2 * k2 + 2 * js2 + c * (ap + 4) + 2 * nh4 + 2 * ne4 + ap + r4(A + 1)) * _TE
    scratch = max(tile_scratch(s4, 2 * js1), tile_scratch(k2, js2), tile_scratch(js2, ap),
                  tile_scratch(js2, 4))
    return 4 * (weights + tiles + r4(scratch))


def tile_scratch(k: int, j: int, lanes: int = _TE, threads: int = 256) -> int:
    """Floats of split-K scratch that ``cm::tile_dense`` (csrc/cluster_mlp.cuh)
    takes for a product of ``j`` rows over ``k`` inputs and ``lanes`` lanes:
    it cuts K into ``ks`` parts, doubling ``ks`` while ``2 ks tiles <=
    threads`` and ``8 ks <= k``, each part's sums ``(j, lanes)`` floats."""
    tiles = (j // 4) * (lanes // 4)
    ks = 1
    while 2 * ks * tiles <= threads and 8 * ks <= k:
        ks *= 2
    return ks * j * lanes if ks > 1 else 0


def actor_smem_bytes(state_dim: int, net_dims: Sequence[int], action_dim: int,
                     cluster: int = 1) -> int:
    """Shared memory of one block of the stock actor kernel (K4's on-policy
    route, ``stock_rollout_smem_bytes``) for clusters of ``cluster`` blocks
    over a group of ``_TE`` lanes: the block's slices of the actor's weights
    row by row (W1's rows at the ``1 + A`` lane columns, W2's rows, Wo's
    columns; a row of K inputs takes ``kernels.ldk(K)`` floats), the biases
    and stds, the day's market rows, two steps' close prices, then the lane
    tiles (every block's part of the mean among them) and the split-K
    scratch.  ``csrc/fused_rollout.cu`` owns the layout
    (``StockActorLayout``); the critic runs afterwards in
    :func:`critic_values`.  ``cluster = 1`` is the largest layout; the
    wrapper needs it to fit."""
    from .kernels import ldk
    D1, D2 = net_dims
    S, A, c = state_dim, action_dim, cluster
    r4 = lambda n: (n + 3) // 4 * 4  # noqa: E731
    L, ap = 1 + A, r4(A)
    js1, js2 = r4(-(-D1 // c)), r4(-(-D2 // c))
    k2 = c * js1
    floats = (js1 * ldk(L) + js1 + js2 * ldk(k2) + js2 + ap * ldk(js2) + 2 * ap + r4(S - L)
              + js1 + 2 * r4(A) + (2 * L + k2 + js2 + c * ap + 32 + 2 * ap) * _TE + 256 * 16)
    return 4 * floats


_CM, _CR = 64, 8   # the critic pass's samples per tile and rows per thread (csrc/fused_rollout.cu)


def critic_smem_bytes(state_dim: int, net_dims: Sequence[int]) -> int:
    """Shared memory of one block of the critic pass
    (``critic_values_smem_bytes``): the critic's weights, padded to a
    float4, then the input tile (the second layer's output in its place)
    and the first layer's tile, ``_CM`` samples each."""
    D1, D2 = net_dims
    S = state_dim
    weights = (S * D1 + D1 + D1 * D2 + D2 + D2 + 1 + 3) // 4 * 4
    return 4 * (weights + (max(S, D2) + D1) * _CM)


def rollout_fits(body: KernelEnvBody, net_dims: Sequence[int]) -> bool:
    """Whether the CUDA kernel takes this body at these widths: the
    registered bodies where a cluster of 8 blocks holds both nets' slices
    (:func:`rollout_smem_bytes`; (256, 256) and more, ``ROADMAP.md`` lists
    the limit); a market-data body (built for ``STOCK_KERNEL_STOCKS``
    stocks) as the actor-only rollout plus the critic pass, each fitting one
    block, the critic's widths multiples of ``_CR``."""
    if len(tuple(net_dims)) != 2:
        return False
    S, A = body.state_dim, body.action_dim
    if not kernel_has_body(body):
        return False
    if body.tables is not None:
        return (actor_smem_bytes(S, net_dims, A) <= SMEM_LIMIT
                and critic_smem_bytes(S, net_dims) <= SMEM_LIMIT
                and all(int(d) % _CR == 0 for d in net_dims))
    return rollout_smem_bytes(body, net_dims, 8) <= SMEM_LIMIT


class _StockArgs(ctypes.Structure):
    """``struct StockArgs`` of csrc/fused_rollout.cu."""
    _fields_ = [('close', ctypes.c_void_p), ('tech', ctypes.c_void_p), ('T', ctypes.c_int),
                ('initial_amount', ctypes.c_float), ('max_stock', ctypes.c_float),
                ('buy_cost', ctypes.c_float), ('sell_cost', ctypes.c_float),
                ('one_minus_gamma', ctypes.c_float), ('random_reset', ctypes.c_int)]


def _stock_args(body: KernelEnvBody, device) -> _StockArgs:
    """The stock body's kernel arguments (the tables on ``device``, which
    ``MarketTables`` keeps) after checking the stock count it was built for."""
    S, A = body.state_dim, body.action_dim
    if A != STOCK_KERNEL_STOCKS or S != 1 + 2 * A + 8 * A:
        raise ValueError(f'the CUDA stock body is built for {STOCK_KERNEL_STOCKS} stocks with 8 '
                         f'factors each (state_dim {1 + 10 * STOCK_KERNEL_STOCKS}); this market '
                         f'has {A} stocks and state_dim {S}')
    close, tech = body.tables.on(device)
    p = body.params
    return _StockArgs(close.data_ptr(), tech.data_ptr(), close.shape[0], p['initial_amount'],
                      p['max_stock'], 1.0 + p['cost_pct'], 1.0 - p['cost_pct'],
                      1.0 - p['gamma'], int(p['if_random_reset']))


def critic_values_reference(cri_flat: torch.Tensor, norm_avg: torch.Tensor,
                            norm_std: torch.Tensor, states: torch.Tensor, *,
                            net_dims: Sequence[int]) -> torch.Tensor:
    """Plain version of the critic pass: ``(H, N)`` values of the stored
    ``(H, S, N)`` states."""
    S = states.shape[1]
    shapes = ppo_param_shapes(S, net_dims, 1, True)[1]
    xn = (states.transpose(1, 2) - norm_avg) / (norm_std + 1e-4)
    return mlp_apply_leaves(split_flat(cri_flat, shapes), xn)[..., 0]


def critic_values(cri_flat: torch.Tensor, norm_avg: torch.Tensor, norm_std: torch.Tensor,
                  states: torch.Tensor, values: Optional[torch.Tensor] = None, *,
                  net_dims: Sequence[int]) -> torch.Tensor:
    """The critic pass of the actor-only rollout: the CUDA kernel for CUDA
    tensors (writing into ``values`` when given), the plain version for CPU
    tensors."""
    if cri_flat.device.type == 'cpu':
        return critic_values_reference(cri_flat, norm_avg, norm_std, states, net_dims=net_dims)
    if cri_flat.device.type != 'cuda':
        raise ValueError(f'critic_values: unsupported device {cri_flat.device}')
    if len(net_dims) != 2:
        raise ValueError(f'critic_values: the CUDA kernel takes 2 hidden layers, got {net_dims}')
    from ._cuda_build import check, check_tensor, ptr
    D1, D2 = (int(d) for d in net_dims)
    if D1 % _CR or D2 % _CR:
        raise ValueError(f'critic_values: the CUDA kernel takes widths that are multiples of '
                         f'{_CR}, got {tuple(net_dims)}')
    H, S, N = states.shape
    lib = _library()
    smem = lib.critic_values_smem_bytes(S, D1, D2)
    if smem > SMEM_LIMIT:
        raise ValueError(f'critic_values: net_dims={tuple(net_dims)} needs {smem} bytes of '
                         f'shared memory per block, more than the {SMEM_LIMIT} a Hopper block '
                         'can hold')
    dev, f32 = cri_flat.device, torch.float32
    n_cri = sum(math.prod(sh) for sh in ppo_param_shapes(S, (D1, D2), 1, True)[1])
    check_tensor('critic_values', 'cri_flat', cri_flat, (n_cri,), f32, dev)
    check_tensor('critic_values', 'norm_avg', norm_avg, (S,), f32, dev)
    check_tensor('critic_values', 'norm_std', norm_std, (S,), f32, dev)
    check_tensor('critic_values', 'states', states, (H, S, N), f32, dev)
    if values is None:
        values = torch.empty((H, N), dtype=f32, device=dev)
    check_tensor('critic_values', 'values', values, (H, N), f32, dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    check(lib.critic_values(ptr(cri_flat), ptr(norm_avg), ptr(norm_std), ptr(states),
                            ptr(values), S, N, H, D1, D2, ctypes.c_void_p(stream)),
          'critic_values')
    critic_values.launches += 1
    return values


critic_values.launches = 0


def rollout(act_flat: torch.Tensor, cri_flat: torch.Tensor,
            norm_avg: torch.Tensor, norm_std: torch.Tensor,
            env_f: torch.Tensor, env_i: torch.Tensor, *,
            net_dims: Sequence[int], horizon_len: int, reward_scale: float,
            noise: Optional[torch.Tensor] = None,
            seed: Optional[torch.Tensor] = None,
            body: KernelEnvBody = PENDULUM_BODY, stock_cluster: int = 0,
            cluster: int = 0) -> RolloutOutputs:
    """The fused rollout: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors.  ``cluster`` and ``stock_cluster`` set the
    cluster size of the rollout kernel and of the stock actor kernel (1, 2,
    4 or 8; 0, the default, lets the kernel choose from the card's
    occupancy, the rollout kernel's choice kept per body, env count, widths
    and device); knobs for measuring the options."""
    kw = dict(net_dims=net_dims, horizon_len=horizon_len,
              reward_scale=reward_scale, noise=noise, seed=seed, body=body)
    if act_flat.device.type == 'cpu':
        return rollout_reference(act_flat, cri_flat, norm_avg, norm_std,
                                 env_f, env_i, **kw)
    if act_flat.device.type != 'cuda':
        raise ValueError(f'rollout: unsupported device {act_flat.device}')
    stock = body.tables is not None
    if not kernel_has_body(body):
        raise ValueError(f'rollout: the CUDA kernel implements the bodies of '
                         f'{kernel_bodies_text(body)}, not {body.env_name}')
    if len(net_dims) != 2:
        raise ValueError(f'rollout: the CUDA kernel takes 2 hidden layers, got {net_dims}')
    _check_noise_mode(noise, seed)
    D1, D2 = (int(d) for d in net_dims)
    S, A = body.state_dim, body.action_dim
    H, N = int(horizon_len), env_f.shape[1]
    from ._cuda_build import check, check_tensor, ptr
    lib = _library()
    if stock:    # the actor-only rollout; the critic pass fills the values
        stock_args = _stock_args(body, act_flat.device)
        smem = lib.stock_rollout_smem_bytes(D1, D2, 1)
        if smem > SMEM_LIMIT:
            raise ValueError(f'rollout: net_dims={tuple(net_dims)} needs {smem} bytes of '
                             f'shared memory per block, more than the {SMEM_LIMIT} a '
                             'Hopper block can hold')
    else:
        smem = lib.fused_rollout_smem_bytes(body.kernel_id, D1, D2, 8)
        if smem > SMEM_LIMIT:
            raise ValueError(f'rollout: net_dims={tuple(net_dims)} needs {smem} bytes of '
                             f'shared memory in each block of a cluster of 8, the widest '
                             f'the kernel takes, more than the {SMEM_LIMIT} a Hopper block '
                             'can hold')
        if not cluster:
            cluster = _rollout_cluster(lib, body, N, D1, D2, act_flat.device)
    dev = act_flat.device
    act_shapes, cri_shapes = ppo_param_shapes(S, (D1, D2), A, body.discrete)
    f32 = torch.float32

    def _check(name, t, shape, dtype, device):
        check_tensor('rollout', name, t, shape, dtype, device)

    _check('act_flat', act_flat, (sum(math.prod(s) for s in act_shapes),), f32, dev)
    _check('cri_flat', cri_flat, (sum(math.prod(s) for s in cri_shapes),), f32, dev)
    _check('norm_avg', norm_avg, (S,), f32, dev)
    _check('norm_std', norm_std, (S,), f32, dev)
    _check('env_f', env_f, (body.n_f32, N), f32, dev)
    _check('env_i', env_i, (body.n_i32, N), torch.int32, dev)
    if noise is not None:
        _check('noise', noise, (H, noise_rows(body), N), f32, dev)
    else:
        _check('seed', seed, (2,), torch.int32, dev)

    if body.discrete:
        actions = torch.empty((H, N), dtype=torch.int32, device=dev)
    else:
        actions = torch.empty((H, A, N), dtype=f32, device=dev)
    out = RolloutOutputs(
        states=torch.empty((H, S, N), dtype=f32, device=dev),
        actions=actions,
        logprobs=torch.empty((H, N), dtype=f32, device=dev),
        rewards=torch.empty((H, N), dtype=f32, device=dev),
        terminals=torch.empty((H, N), dtype=f32, device=dev),
        truncates=torch.empty((H, N), dtype=f32, device=dev),
        values=torch.empty((H, N), dtype=f32, device=dev),
        env_f=torch.empty_like(env_f), env_i=torch.empty_like(env_i))
    stream = torch.cuda.current_stream(dev).cuda_stream
    if stock:
        status = lib.stock_rollout(
            ptr(act_flat), ptr(norm_avg), ptr(norm_std), ptr(env_f), ptr(env_i), ptr(noise),
            ptr(seed), *[ptr(t) for t in out if t is not out.values], N, H, D1, D2,
            ctypes.c_float(reward_scale), int(stock_cluster), ctypes.byref(stock_args),
            ctypes.c_void_p(stream))
    else:
        status = lib.fused_rollout(
            body.kernel_id,
            ptr(act_flat), ptr(cri_flat), ptr(norm_avg), ptr(norm_std),
            ptr(env_f), ptr(env_i), ptr(noise), ptr(seed),
            *[ptr(t) for t in out],
            N, H, D1, D2, ctypes.c_float(reward_scale), int(cluster), ctypes.c_void_p(stream))
    check(status, f'fused_rollout[{body.env_name}]')
    rollout.launches += 1
    rollout.launches_by_body[body.env_name] = rollout.launches_by_body.get(body.env_name, 0) + 1
    if stock:
        critic_values(cri_flat, norm_avg, norm_std, out.states, out.values, net_dims=(D1, D2))
    return out


rollout.launches = 0
rollout.launches_by_body = {}

_CLUSTER_PICKS = {}   # (body, envs, D1, D2, device index) -> the rollout kernel's cluster size


def _rollout_cluster(lib, body: KernelEnvBody, N: int, D1: int, D2: int, device) -> int:
    """The cluster size the rollout kernel picks from the card's occupancy
    (``fused_rollout_cluster``), asked once per body, env count, widths and
    device: the pick makes up to eight CUDA runtime calls.  0 where nothing fits
    (the launch then reports the error)."""
    key = (body.kernel_id, N, D1, D2, device.index)
    if key not in _CLUSTER_PICKS:
        c = lib.fused_rollout_cluster(body.kernel_id, N, D1, D2, 0)
        if c <= 0:
            return 0
        _CLUSTER_PICKS[key] = c
    return _CLUSTER_PICKS[key]


def _library():
    from ._cuda_build import load
    lib = load('fused_rollout')
    fn = lib.fused_rollout
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 17 + [ctypes.c_int] * 4
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib.fused_rollout_smem_bytes.argtypes = [ctypes.c_int] * 4
        lib.fused_rollout_smem_bytes.restype = ctypes.c_int
        lib.fused_rollout_cluster.argtypes = [ctypes.c_int] * 5
        lib.fused_rollout_cluster.restype = ctypes.c_int
        lib.offpolicy_rollout.argtypes = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 12
                                          + [ctypes.c_int] * 4 + [ctypes.c_float] * 5
                                          + [ctypes.c_void_p])
        lib.offpolicy_rollout.restype = ctypes.c_int
        lib.offpolicy_rollout_smem_bytes.argtypes = [ctypes.c_int] * 5
        lib.offpolicy_rollout_smem_bytes.restype = ctypes.c_int
        lib.stock_rollout.argtypes = ([ctypes.c_void_p] * 15 + [ctypes.c_int] * 4
                                      + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p,
                                         ctypes.c_void_p])
        lib.stock_rollout.restype = ctypes.c_int
        lib.stock_rollout_smem_bytes.argtypes = [ctypes.c_int] * 3
        lib.stock_rollout_smem_bytes.restype = ctypes.c_int
        lib.stock_rollout_cluster.argtypes = [ctypes.c_int] * 4
        lib.stock_rollout_cluster.restype = ctypes.c_int
        lib.critic_values.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        lib.critic_values.restype = ctypes.c_int
        lib.critic_values_smem_bytes.argtypes = [ctypes.c_int] * 3
        lib.critic_values_smem_bytes.restype = ctypes.c_int
        lib.offpolicy_stock_rollout.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 12
                                                + [ctypes.c_int] * 4 + [ctypes.c_float] * 5
                                                + [ctypes.c_void_p] * 2)
        lib.offpolicy_stock_rollout.restype = ctypes.c_int
    return lib


# ---------------------------------------------------- runner integration

def make_fused_rollout(body: KernelEnvBody, net_dims, horizon_len: int,
                       num_envs: int, reward_scale: float):
    """``rollout_fn(agent_state, env_state, gen, noise=None) -> (Rollout,
    env_state', last_obs)``: the fast path for ``collect_rollout`` on the
    on-policy agents with a kernel-body env.  Without ``noise`` the kernel's
    internal Philox draws are keyed by a seed taken from ``gen``."""
    from ..agents.base import Rollout
    H = int(horizon_len)
    net_dims = tuple(int(d) for d in net_dims)

    def rollout_fn(agent_state, env_state, gen, noise=None):
        f0, i0 = body.pack(env_state)
        seed = None
        if noise is None:
            seed = torch.randint(-2 ** 31, 2 ** 31 - 1, (2,), generator=gen,
                                 device=f0.device, dtype=torch.int32)
        out = rollout(agent_state.act_flat, agent_state.cri_flat,
                      agent_state.norm_avg, agent_state.norm_std,
                      f0.contiguous(), i0.contiguous(), net_dims=net_dims,
                      horizon_len=H, reward_scale=reward_scale, noise=noise,
                      seed=seed, body=body)
        ro = Rollout(states=out.states, actions=out.actions, logprobs=out.logprobs,
                     rewards=out.rewards, undones=1.0 - out.terminals,
                     unmasks=1.0 - out.truncates,
                     extras={'values': out.values, 'tsn': True})
        last_obs = body.obs(out.env_f, out.env_i).T
        return ro, body.unpack(out.env_f, out.env_i), last_obs

    return rollout_fn


# ====================================================== off-policy heads
# The same kernel family for the off-policy agents' exploration
# (``elegantrl_tpu/ops/pallas_rollout.py:_make_offpolicy_kernel``): one net,
# no critic, no logprob, no observation normalisation, and one of six heads
# on the trunk ``l2 = W2 gelu(W1 x + b1) + b2``:
#   'ddpg'     clip(tanh(Wo gelu(l2) + bo) + noise_std * z, -1, 1), stored and
#              stepped as is (DDPG, TD3);
#   'sac'      tanh(mean + exp(clip(log_std)) * z), [mean, log_std] = Wo
#              gelu(l2) + bo (SAC; std_clip (-16, 2));
#   'modsac'   the same with mean = Wa l2 + ba, log_std = Ws l2 + bs over the
#              raw trunk (ModSAC; std_clip (-20, 2));
#   'dqn'      q = Wo gelu(l2) + bo                       (DQN)
#   'dqn_enc'  q = Wo l2 + bo, the raw encoding           (DoubleDQN: head val1)
#   'dqn_duel' q = val - mean(val) + adv over the raw encoding, adv = W4 l2 + b4
#              (DuelingDQN, D3QN: heads val1 and adv1)
# and the DQN heads act epsilon-greedily, ``u0 < explore_rate ?
# min(floor(u1 * A), A - 1) : argmax q`` (the first maximum on a tie; the min
# only guards an injected u1 of exactly 1), the index stored as int32
# ``(H, N)`` and stepped as a float row.  The kernel reads the head's leaves
# from the front of the agent's flat buffer: the DQN nets' flat layout
# (``ops/nets.py:dqn_param_shapes``) keeps enc, val1 and adv1 first, and the
# SAC actors' (``sac_act_shapes``) are the head's net.
# Outputs are the ``(H, N, dim)`` layout the replay buffer takes.
# Noise: injected ``(H, NZ, N)``, continuous: A normals then the env's
# uniforms; discrete: the coin, the random-action uniform, then the env's
# uniforms.  Internal Philox: ``2A + n_env`` (the continuous heads,
# Box-Muller) or ``2 + n_env`` uniforms per (lane, step), in the scheme of
# the on-policy heads.

OFFPOLICY_HEADS = {'ddpg': 0, 'dqn': 1, 'dqn_enc': 2, 'dqn_duel': 3, 'sac': 4, 'modsac': 5}
CONTINUOUS_HEADS = ('ddpg', 'sac', 'modsac')


def offpolicy_head_shapes(state_dim: int, net_dims: Sequence[int], action_dim: int,
                          head: str) -> list:
    """Leaf shapes of the head's net: the prefix of the agent's flat buffer
    that the kernel reads."""
    from .nets import dqn_param_shapes, mlp_shapes, sac_act_shapes
    if head in ('sac', 'modsac'):
        return sac_act_shapes(state_dim, net_dims, action_dim, head == 'modsac')
    if head == 'dqn_duel':
        return dqn_param_shapes(state_dim, net_dims, action_dim, twin=False, duel=True)
    # ddpg and dqn: one MLP; dqn_enc: the encoder and val1, the same leaf shapes
    return mlp_shapes((state_dim, *net_dims, action_dim))


def offpolicy_noise_rows(body: KernelEnvBody, head: str) -> int:
    """Rows of the injected-noise tensor."""
    cont = head in CONTINUOUS_HEADS
    return (body.action_dim if cont else 2) + body.n_step + body.n_reset


def offpolicy_uniforms_per_step(body: KernelEnvBody, head: str) -> int:
    cont = head in CONTINUOUS_HEADS
    return (2 * body.action_dim if cont else 2) + body.n_step + body.n_reset


def offpolicy_pair_fits(body: KernelEnvBody, head: str) -> bool:
    """Whether the kernel has this (body, head) instantiation: the ddpg, sac
    and modsac heads on the continuous bodies (the stock body built for
    ``STOCK_KERNEL_STOCKS`` stocks among them), the DQN heads on the
    discrete ones."""
    return (kernel_has_body(body) and head in OFFPOLICY_HEADS
            and body.discrete == (head not in CONTINUOUS_HEADS))


class OffPolicyRolloutOutputs(NamedTuple):
    states: torch.Tensor     # (H, N, S)
    actions: torch.Tensor    # (H, N, A) float32; int32 (H, N) for the DQN heads
    rewards: torch.Tensor    # (H, N), times reward_scale
    terminals: torch.Tensor  # (H, N) float
    truncates: torch.Tensor  # (H, N) float
    env_f: torch.Tensor      # (n_f32, N) final env rows
    env_i: torch.Tensor      # (n_i32, N)


def offpolicy_rollout_reference(flat: torch.Tensor, env_f: torch.Tensor, env_i: torch.Tensor,
                                *, body: KernelEnvBody, head: str, net_dims: Sequence[int],
                                horizon_len: int, reward_scale: float, noise_std: float = 0.05,
                                explore_rate: float = 0.25, std_clip=(-16.0, 2.0),
                                noise: Optional[torch.Tensor] = None,
                                seed: Optional[torch.Tensor] = None,
                                env_trace: Optional[list] = None) -> OffPolicyRolloutOutputs:
    """Plain PyTorch version of the off-policy rollout kernel.  ``flat`` is
    the agent's flat actor (ddpg, sac, modsac) or Q buffer; ``env_trace`` as
    in :func:`rollout_reference`."""
    from .fused_offpolicy_update import dqn_q_greedy, sac_actor_dist
    S, A = body.state_dim, body.action_dim
    shapes = offpolicy_head_shapes(S, net_dims, A, head)
    n = sum(math.prod(s) for s in shapes)
    leaves = split_flat(flat[:n], shapes)
    _check_noise_mode(noise, seed)
    if seed is not None:
        u_all = philox_uniforms(seed, horizon_len, env_f.shape[1],
                                offpolicy_uniforms_per_step(body, head))
    f, i = env_f, env_i
    outs = {k: [] for k in OffPolicyRolloutOutputs._fields[:5]}
    for t in range(horizon_len):
        if env_trace is not None:
            env_trace.append((f, i))
        x = body.obs(f, i)                                   # (S, N)
        u = noise[t] if seed is None else u_all[t]
        if head in CONTINUOUS_HEADS:
            if seed is None:
                z, u_env = u[:A], u[A:]
            else:
                z = torch.sqrt(-2.0 * torch.log(1.0 - u[0:A])) * torch.cos(_TWO_PI * u[A:2 * A])
                u_env = u[2 * A:]
            if head == 'ddpg':
                out = mlp_apply_leaves(leaves, x.T).T        # (A, N)
                action = torch.clamp(torch.tanh(out) + noise_std * z, -1.0, 1.0)
            else:
                mean, log_std = sac_actor_dist(leaves, x.T, head == 'modsac', std_clip)
                action = torch.tanh(mean.T + torch.exp(log_std.T) * z)
            env_a, stored = action, action.T
        else:
            q = dqn_q_greedy(leaves, x.T, head == 'dqn_enc', head == 'dqn_duel')  # (N, A)
            greedy = torch.argmax(q, dim=1)                  # first max on a tie
            rand = torch.clamp(torch.floor(u[1] * A), max=A - 1).long()
            index = torch.where(u[0] < explore_rate, rand, greedy)
            env_a, stored = index[None].float(), index.to(torch.int32)
            u_env = u[2:]
        f2, i2, reward, terminal, trunc = body.step(f, i, env_a, u_env[0:body.n_step])
        f, i = body.reset(f2, i2, u_env[body.n_step:body.n_step + body.n_reset],
                          terminal | trunc)
        outs['states'].append(x.T)
        outs['actions'].append(stored)
        outs['rewards'].append(reward[0] * reward_scale)
        outs['terminals'].append(terminal[0].float())
        outs['truncates'].append(trunc[0].float())
    return OffPolicyRolloutOutputs(*[torch.stack(v) for v in outs.values()], f, i)


def offpolicy_smem_bytes(state_dim: int, net_dims: Sequence[int], action_dim: int,
                         head: str) -> int:
    """Dynamic shared memory of one off-policy kernel block: the head's
    weights plus the activation tiles (``offpolicy_rollout_smem_bytes`` of
    ``csrc/fused_rollout.cu`` owns the layout; this copy judges eligibility
    where the library is not built)."""
    D1, D2 = net_dims
    S, A = state_dim, action_dim
    sac = head in ('sac', 'modsac')
    heads = 2 * (A * D2 + A) if sac else A * D2 + A + (D2 + 1 if head == 'dqn_duel' else 0)
    floats = (D1 * S + D1 + D2 * D1 + D2 + heads
              + (S + D1 + D2 + (2 * A if sac else A + 1)) * _TE)
    return 4 * floats


def offpolicy_rollout(flat: torch.Tensor, env_f: torch.Tensor, env_i: torch.Tensor, *,
                      body: KernelEnvBody, head: str, net_dims: Sequence[int],
                      horizon_len: int, reward_scale: float, noise_std: float = 0.05,
                      explore_rate: float = 0.25, std_clip=(-16.0, 2.0),
                      noise: Optional[torch.Tensor] = None,
                      seed: Optional[torch.Tensor] = None) -> OffPolicyRolloutOutputs:
    """The off-policy fused rollout: the CUDA kernel for CUDA tensors, the
    plain version for CPU tensors."""
    kw = dict(body=body, head=head, net_dims=net_dims, horizon_len=horizon_len,
              reward_scale=reward_scale, noise_std=noise_std, explore_rate=explore_rate,
              std_clip=std_clip, noise=noise, seed=seed)
    if flat.device.type == 'cpu':
        return offpolicy_rollout_reference(flat, env_f, env_i, **kw)
    if flat.device.type != 'cuda':
        raise ValueError(f'offpolicy_rollout: unsupported device {flat.device}')
    stock = body.tables is not None
    if stock:
        stock_args = _stock_args(body, flat.device)
    if not offpolicy_pair_fits(body, head):
        raise ValueError(f'offpolicy_rollout: the CUDA kernel has no instantiation for head '
                         f'{head!r} on {body.env_name}')
    if len(net_dims) != 2:
        raise ValueError(f'offpolicy_rollout: the CUDA kernel takes 2 hidden layers, '
                         f'got {net_dims}')
    _check_noise_mode(noise, seed)
    D1, D2 = (int(d) for d in net_dims)
    S, A = body.state_dim, body.action_dim
    H, N = int(horizon_len), env_f.shape[1]
    from ._cuda_build import check, check_tensor, ptr
    lib = _library()
    smem = lib.offpolicy_rollout_smem_bytes(S, A, D1, D2, OFFPOLICY_HEADS[head])
    if smem > SMEM_LIMIT:
        raise ValueError(f'offpolicy_rollout: net_dims={tuple(net_dims)} needs {smem} bytes '
                         f'of shared memory per block, more than the {SMEM_LIMIT} a Hopper '
                         'block can hold')
    dev = flat.device
    f32 = torch.float32
    n_head = sum(math.prod(s) for s in offpolicy_head_shapes(S, (D1, D2), A, head))
    if flat.dtype != f32 or not flat.is_contiguous() or flat.dim() != 1 \
            or flat.numel() < n_head:
        raise ValueError(f'offpolicy_rollout: flat must be a contiguous float32 vector of at '
                         f'least {n_head} values; got {flat.dtype} {tuple(flat.shape)}')
    check_tensor('offpolicy_rollout', 'env_f', env_f, (body.n_f32, N), f32, dev)
    check_tensor('offpolicy_rollout', 'env_i', env_i, (body.n_i32, N), torch.int32, dev)
    if noise is not None:
        check_tensor('offpolicy_rollout', 'noise', noise,
                     (H, offpolicy_noise_rows(body, head), N), f32, dev)
    else:
        check_tensor('offpolicy_rollout', 'seed', seed, (2,), torch.int32, dev)
    actions = (torch.empty((H, N, A), dtype=f32, device=dev) if head in CONTINUOUS_HEADS
               else torch.empty((H, N), dtype=torch.int32, device=dev))
    out = OffPolicyRolloutOutputs(
        states=torch.empty((H, N, S), dtype=f32, device=dev), actions=actions,
        rewards=torch.empty((H, N), dtype=f32, device=dev),
        terminals=torch.empty((H, N), dtype=f32, device=dev),
        truncates=torch.empty((H, N), dtype=f32, device=dev),
        env_f=torch.empty_like(env_f), env_i=torch.empty_like(env_i))
    stream = torch.cuda.current_stream(dev).cuda_stream
    hyper = [ctypes.c_float(v) for v in (reward_scale, noise_std, explore_rate, *std_clip)]
    if stock:
        status = lib.offpolicy_stock_rollout(
            OFFPOLICY_HEADS[head], ptr(flat), ptr(env_f), ptr(env_i), ptr(noise), ptr(seed),
            *[ptr(x) for x in out], N, H, D1, D2, *hyper, ctypes.byref(stock_args),
            ctypes.c_void_p(stream))
    else:
        status = lib.offpolicy_rollout(
            body.kernel_id, OFFPOLICY_HEADS[head], ptr(flat), ptr(env_f), ptr(env_i),
            ptr(noise), ptr(seed), *[ptr(x) for x in out], N, H, D1, D2, *hyper,
            ctypes.c_void_p(stream))
    tag = f'{body.env_name},{head}'
    check(status, f'offpolicy_rollout[{tag}]')
    offpolicy_rollout.launches += 1
    offpolicy_rollout.launches_by_kernel[tag] = offpolicy_rollout.launches_by_kernel.get(tag, 0) + 1
    return out


offpolicy_rollout.launches = 0
offpolicy_rollout.launches_by_kernel = {}


def make_fused_offpolicy_rollout(body: KernelEnvBody, head: str, net_dims, horizon_len: int,
                                 num_envs: int, reward_scale: float, noise_std: float,
                                 explore_rate: float, std_clip=(-16.0, 2.0)):
    """``rollout_fn(agent_state, env_state, gen, noise=None) -> (Rollout,
    env_state', last_obs)`` for the off-policy agents: the flat buffer is the
    agent state's ``act`` (ddpg, sac, modsac) or ``q``; without ``noise`` the
    kernel's Philox draws are keyed by a seed taken from ``gen``."""
    from ..agents.base import Rollout
    H = int(horizon_len)
    net_dims = tuple(int(d) for d in net_dims)

    def rollout_fn(agent_state, env_state, gen, noise=None):
        f0, i0 = body.pack(env_state)
        seed = None
        if noise is None:
            seed = torch.randint(-2 ** 31, 2 ** 31 - 1, (2,), generator=gen,
                                 device=f0.device, dtype=torch.int32)
        flat = agent_state.act if head in CONTINUOUS_HEADS else agent_state.q
        out = offpolicy_rollout(flat, f0.contiguous(), i0.contiguous(), body=body, head=head,
                                net_dims=net_dims, horizon_len=H, reward_scale=reward_scale,
                                noise_std=noise_std, explore_rate=explore_rate,
                                std_clip=std_clip, noise=noise, seed=seed)
        ro = Rollout(states=out.states, actions=out.actions, logprobs=None,
                     rewards=out.rewards, undones=1.0 - out.terminals,
                     unmasks=1.0 - out.truncates)
        last_obs = body.obs(out.env_f, out.env_i).T
        return ro, body.unpack(out.env_f, out.env_i), last_obs

    return rollout_fn
