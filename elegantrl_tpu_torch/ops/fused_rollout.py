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
market tables) has a 151-wide obs.  On the card its rollout is two kernels:
the actor kernel (K4's ``stock_actor_kernel``: a group of ``_TE`` lanes on a
thread-block cluster whose blocks each hold a slice of the actor,
:func:`actor_smem_bytes`), which leaves the values alone, then
:func:`critic_values`, the critic over the stored ``(H, S, N)`` states on
the tensor cores (:func:`critic_smem_bytes`).  The outputs are those of the
one-kernel route.  The body reads the day of its group's first lane
(:func:`block_day`): every env starts at day 0 and ends at the shared last
day, so the day is the same on every lane of a group, its 135 market rows
are filled once for all lanes, and both kernels apply their first layer's
market columns to them once per step and group.

Three pieces, as for every kernel of the port:

- :func:`rollout_reference`, the plain PyTorch version;
- :func:`rollout`, the wrapper: for CPU tensors it runs the plain version,
  for CUDA tensors it launches ``csrc/fused_rollout.cu`` (or raises);
- ``rollout.launches``, the count of kernel launches (``rollout.launches_by_body``
  splits it by env body, the bf16 variants as ``'<env>,bf16'`` and the
  streamed design with ``',streamed'`` after it).

Two designs of each rollout kernel.  The *resident* one holds every block's
slice of the weights in shared memory; where no cluster of up to 8 blocks
holds them, the *streamed* one reads layer 2's weights from a copy in
device memory (:func:`stream_weights`, which stays in the card's 50 MB L2)
and holds only the activation tiles, W1's slices and the heads in shared
memory (the critic pass streams W1's lane columns through its ring too).
Each width takes the resident design where it fits (``*_fits_resident``)
and the streamed one elsewhere, up to what a block's activation tiles allow
(:func:`rollout_width_limit`, :func:`stock_width_limit`): a first width of
1024 and more for every body and head in both compute types.

Compute and storage types, as the JAX kernel's ``compute_dtype`` and
``store_dtype``: with ``compute_dtype=torch.bfloat16`` every product takes
its operands rounded to bf16 (weights, the normalised obs, each hidden
activation) and sums in float32 (``pallas_rollout.py:_bf16_dot``; biases,
GELU and the heads stay float32); with ``store_dtype=torch.bfloat16`` the
obs is rounded to bf16 before it is acted on and the states are stored in
bf16 (off-policy also the float actions).  The kernels' bf16 variants hold
the weight slices and activation tiles in bf16 (half the shared memory);
the stock body's critic pass rounds its tensor-core operands to bf16
(``mma.sync`` m16n8k16 where the float32 pass runs split-3xTF32) and reads
the stored states in either type.

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
STREAM_LANES = 16   # env lanes of a group of the streamed K1/K3 (csrc/fused_rollout.cu)
STREAMED = 2        # the streamed design's bit of the library's size and cluster queries
_STOCK_STREAM_KS = 2   # split-K parts at most in the streamed stock actor (STOCK_STREAM_KS)
# The designs of a kernel (``ST`` of csrc/fused_rollout.cu, a variant's bits 1
# and up): 0 resident, 1 streamed, and each level past 1 halves the streamed
# lane group, down to 4 lanes (``cm::tile_dense``'s 4 x 4 register tiles make
# a tile row of fewer lanes as large as one of 4).  The last level of each:
ROLLOUT_LEVELS = 3   # K1/K3: 32 lanes resident, 16, 8, 4 streamed
OFF_LEVELS = 3       # K6/K6': 16 resident, 16, 8, 4 streamed
STOCK_LEVELS = 4     # K4's actor: 32 resident, 32, 16, 8, 4 streamed


def narrow_lanes(lanes: int, level: int) -> int:
    """The lanes of a group at design ``level`` whose streamed design has
    ``lanes`` at its widest (``narrow_lanes`` of the source)."""
    return lanes >> (level - 1) if level > 1 else lanes


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


def _check_dtypes(what: str, compute_dtype, store_dtype) -> None:
    for name, dt in (('compute_dtype', compute_dtype), ('store_dtype', store_dtype)):
        if dt not in (None, torch.bfloat16):
            raise ValueError(f'{what}: {name} must be None (float32) or torch.bfloat16, '
                             f'got {dt}')


def rollout_reference(act_flat: torch.Tensor, cri_flat: torch.Tensor,
                      norm_avg: torch.Tensor, norm_std: torch.Tensor,
                      env_f: torch.Tensor, env_i: torch.Tensor, *,
                      net_dims: Sequence[int], horizon_len: int,
                      reward_scale: float, noise: Optional[torch.Tensor] = None,
                      seed: Optional[torch.Tensor] = None,
                      body: KernelEnvBody = PENDULUM_BODY,
                      env_trace: Optional[list] = None,
                      compute_dtype: Optional[torch.dtype] = None,
                      store_dtype: Optional[torch.dtype] = None,
                      env_actions: Optional[list] = None) -> RolloutOutputs:
    """Plain PyTorch version of the fused rollout kernel.  ``env_trace``, a
    list, receives the ``(env_f, env_i)`` rows each step starts from, and
    ``env_actions`` the float32 ``(A, N)`` action each step's env steps on;
    ``compute_dtype`` and ``store_dtype`` as the module says."""
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
        if store_dtype is not None:                          # round before acting
            x = x.to(store_dtype).float()
        xn = ((x - avg) / nstd).T                            # (N, S)
        out = mlp_apply_leaves(act, xn, compute_dtype).T     # (A, N) mean or logits
        value = mlp_apply_leaves(cri, xn, compute_dtype)[:, 0]   # (N,)
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
        if env_actions is not None:
            env_actions.append(env_a)
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
    out = RolloutOutputs(*[torch.stack(v) for v in outs.values()], f, i)
    return out if store_dtype is None else out._replace(states=out.states.to(store_dtype))


# ---------------------------------------------------------------- wrapper

ROLLOUT_CLUSTERS = (1, 2, 4, 8)   # the cluster sizes the rollout kernel takes


def wrow(k: int, bf16: bool) -> int:
    """4-byte words of shared memory that a weight row of ``k`` inputs takes
    (``cm::wrow`` of csrc/cluster_mlp.cuh): ``kernels.ldk(k)`` floats, or in
    bf16 ``k`` rounded up to 8 values, plus 8 where that count of 16-byte
    chunks is even, two values a word."""
    from .kernels import ldk
    if not bf16:
        return ldk(k)
    k8 = (k + 7) // 8 * 8
    return (k8 + (8 if k8 // 8 % 2 == 0 else 0)) // 2


def rollout_smem_bytes(body: KernelEnvBody, net_dims: Sequence[int], cluster: int,
                       bf16: bool = False, streamed: int = 0) -> int:
    """Shared memory of one block of the rollout kernel (K1, K3) for clusters
    of ``cluster`` blocks over a group of ``_TE`` lanes: the block's slices
    of both nets' weights row by row (a row of K inputs takes
    ``kernels.ldk(K)`` floats: both W1's rows, both W2's rows, the heads'
    columns), the biases, stds and the normalisation, then the lane tiles
    (the obs, both whole h1, the block's rows of both h2, every block's part
    of the heads, two steps' noise words, the head noise and sums) and the
    split-K scratch of the widest product (``cm::tile_dense``'s count of
    parts: :func:`tile_scratch`).  With ``bf16`` the weight slices and the
    tiles xn, h1 and h2 hold bf16 values, and where the layout with layer 2's
    split-K scratch would not fit a block layer 2 runs unsplit.  With
    ``streamed`` (the design level: 1 the streamed design, 2 and 3 its
    narrower groups) the W2 slices are not held and a group has
    ``STREAM_LANES`` lanes, 8 or 4.
    ``csrc/fused_rollout.cu`` owns the layout (``RolloutLayout``,
    ``fused_rollout_smem_bytes``); this copy judges eligibility where the
    library is not built (the CPU)."""
    D1, D2 = (int(d) for d in net_dims)
    S, A, c, bf = body.state_dim, body.action_dim, int(cluster), bool(bf16)
    G, st = (narrow_lanes(STREAM_LANES, int(streamed)), 1) if streamed else (_TE, 0)
    r4 = lambda n: (n + 3) // 4 * 4  # noqa: E731
    half = lambda n: n // 2 if bf else n  # noqa: E731
    s4, ap = r4(S), r4(A)
    nh4 = r4(A if body.discrete else 2 * A)
    ne4 = r4(max(body.n_step + body.n_reset, 1))
    js1, js2 = r4(-(-D1 // c)), r4(-(-D2 // c))
    k2 = c * js1
    weights = (2 * js1 * wrow(S, bf) + 2 * js1 + (1 - st) * 2 * js2 * wrow(k2, bf) + 2 * js2
               + ap * wrow(js2, bf) + 4 * wrow(js2, bf) + 2 * ap + 4 + 2 * s4)
    tiles = (half((s4 + 2 * k2 + 2 * js2) * G)
             + (c * (ap + 4) + 2 * nh4 + 2 * ne4 + ap + r4(A + 1)) * G)
    split2 = tile_scratch(k2, js2, G)
    rest = max(tile_scratch(s4, 2 * js1, G), tile_scratch(js2, ap, G), tile_scratch(js2, 4, G))
    if bf and 4 * (weights + tiles + r4(max(split2, rest))) > SMEM_LIMIT:
        split2 = 0   # layer 2 unsplit
    return 4 * (weights + tiles + r4(max(split2, rest)))


def tile_scratch(k: int, j: int, lanes: int = _TE, ks_max: int = 256,
                 threads: int = 256) -> int:
    """Floats of split-K scratch that ``cm::tile_dense`` (csrc/cluster_mlp.cuh)
    takes for a product of ``j`` rows over ``k`` inputs and ``lanes`` lanes:
    it cuts K into ``ks`` parts, doubling ``ks`` while ``2 ks tiles <=
    threads`` and ``8 ks <= k``, at most ``ks_max``, each part's sums ``(j,
    lanes)`` floats."""
    tiles = (j // 4) * (lanes // 4)
    ks = 1
    while 2 * ks * tiles <= threads and 8 * ks <= k:
        ks *= 2
    ks = min(ks, ks_max)
    return ks * j * lanes if ks > 1 else 0


def actor_smem_bytes(state_dim: int, net_dims: Sequence[int], action_dim: int,
                     cluster: int = 1, head: Optional[str] = None, bf16: bool = False,
                     streamed: int = 0) -> int:
    """Shared memory of one block of the stock actor kernel (K4: the
    on-policy route, ``stock_rollout_smem_bytes``, ``head`` None; the
    off-policy heads, ``offpolicy_rollout_smem_bytes``) for clusters of
    ``cluster`` blocks over a group of ``_TE`` lanes: the block's slices of
    the actor's weights row by row (W1's rows at the ``1 + A`` lane
    columns, W2's rows unless ``streamed``, the head's columns, A rows or 2A
    for the SAC heads; a row of K inputs takes ``kernels.ldk(K)`` floats),
    the biases and stds, the day's market rows, two steps' close prices,
    then the lane tiles (every block's part of the head rows among them) and
    the split-K scratch (``cm::SCRATCH``, or in the streamed design what its
    products take in at most ``_STOCK_STREAM_KS`` parts).  With ``bf16`` the weight slices and the tiles of
    the lanes' normalised rows, h1 and h2 hold bf16 values.  ``streamed``
    is the design level: 1 the streamed design, 2 to 4 its narrower groups
    of 16, 8 and 4 lanes.
    ``csrc/fused_rollout.cu`` owns the layout (``StockActorLayout``); the
    critic runs afterwards in :func:`critic_values`.  The wrapper needs one
    cluster size's layout to fit."""
    D1, D2 = net_dims
    S, A, c, bf, st = state_dim, action_dim, cluster, bool(bf16), int(bool(streamed))
    G = narrow_lanes(_TE, int(streamed))
    r4 = lambda n: (n + 3) // 4 * 4  # noqa: E731
    half = lambda n: n // 2 if bf else n  # noqa: E731
    L, ap = 1 + A, r4(A)
    op = r4(2 * A) if head in ('sac', 'modsac') else ap
    js1, js2 = r4(-(-D1 // c)), r4(-(-D2 // c))
    k2 = c * js1
    ks = _STOCK_STREAM_KS
    scratch = (r4(max(tile_scratch(L, js1, G, ks), tile_scratch(k2, js2, G, ks),
                      tile_scratch(js2, op, G, ks))) if st else 256 * 16)
    floats = (js1 * wrow(L, bf) + js1 + (1 - st) * js2 * wrow(k2, bf) + js2 + op * wrow(js2, bf)
              + op + ap + r4(S - L) + js1 + 2 * r4(A) + half((L + k2 + js2) * G)
              + (L + c * op + 32 + 2 * ap) * G + scratch)
    return 4 * floats


# the critic pass's tiles: samples (128, or 64 where that layout does not
# fit, or the streamed design's 32, or its narrower 16), the features of a
# product's chunk, W2's K-tile (csrc/fused_rollout.cu: critic_tile, CNC,
# CKT), and the row strides of the lane rows (CLD) and of a K-tile (CKLD)
_CTS, _CNC, _CKT = (128, 64), 64, 32
_CT_STREAM, _CT_NARROW = 32, 16
_CLD, _CKLD = 1 + STOCK_KERNEL_STOCKS + 4, _CKT + 4
_STOCK_S = 1 + 10 * STOCK_KERNEL_STOCKS   # the stock body's obs rows


def critic_tile(net_dims: Sequence[int]) -> int:
    """The critic pass's samples a tile (``critic_tile`` of the source): 128
    where that resident layout fits a block, else 64, else the streamed
    design's 32 (``_CT_STREAM``), else its narrower 16 (``_CT_NARROW``)."""
    for ct in _CTS + (_CT_STREAM,):
        if critic_smem_bytes(net_dims, ct) <= SMEM_LIMIT:
            return ct
    return _CT_NARROW


def critic_smem_bytes(net_dims: Sequence[int], tile: Optional[int] = None) -> int:
    """Shared memory of one block of the critic pass
    (``critic_values_smem_bytes``; ``CriticLayout`` of
    ``csrc/fused_rollout.cu`` owns it) with tiles of ``tile`` samples, by
    default the kernel's (:func:`critic_tile`): W1's lane columns (not in the
    streamed design, tiles of 32, which streams them through the ring), b1,
    b2 and the value head's weights at the widths padded to 64, the
    two-stage ring, the tile's lane rows, the groups' market rows and
    products, h1 and the value partials.  W2 streams through the ring, so
    only h1 grows with both widths: the widest ``D1`` is 320 at 128
    samples, 576 at 64, 1408 in the streamed design, 2624 at 16."""
    if tile is None:
        tile = critic_tile(net_dims)
    st = int(tile <= _CT_STREAM)
    d1p, d2p = (-(-int(d) // 64) * 64 for d in net_dims)
    nm, nq = _STOCK_S - (1 + STOCK_KERNEL_STOCKS), max(tile // _TE, 1)
    r4 = lambda n: (n + 3) // 4 * 4  # noqa: E731
    floats = ((1 - st) * d1p * _CLD + d1p + 2 * d2p + 2 * _CNC * _CKLD + tile * _CLD
              + r4(nq * nm) + nq * d1p + tile * (d1p + 4) + 8 * _TE)
    return 4 * floats


_WIDEST = {}   # the searches' answers, per their key


def _widest(fits, key=None) -> int:
    """The widest square width (a multiple of 4) at which ``fits((d, d))``
    holds (0 where it does not at 4): doubling from 4 to a width that does
    not fit, then bisecting, as a block's shared memory only grows with the
    widths; kept per ``key``."""
    if key in _WIDEST:
        return _WIDEST[key]
    lo, hi = 0, 4          # fits at lo (or lo is 0), not known at hi
    while fits((hi, hi)):
        lo, hi = hi, 2 * hi
    while hi - lo > 4:     # fits at lo, not at hi
        mid = (lo + hi) // 8 * 4
        lo, hi = (mid, hi) if fits((mid, mid)) else (lo, mid)
    if key is not None:
        _WIDEST[key] = lo
    return lo


def _body_key(body: KernelEnvBody) -> tuple:
    """What the layouts read of a body."""
    return (body.kernel_id, body.state_dim, body.action_dim, body.discrete, body.n_step,
            body.n_reset, body.tables is not None)


def rollout_level(body: KernelEnvBody, net_dims: Sequence[int], bf16: bool = False) -> int:
    """The design level the rollout kernel takes for this body at these
    widths, as the wrapper picks it on the card (``_design``) in this copy
    of the library's reckoning: the first of 0 (resident: a cluster of 8
    holds the slices), 1 (streamed) and the narrower streamed groups up to
    ``ROLLOUT_LEVELS`` (``STOCK_LEVELS`` for a market-data body's actor
    kernel) whose block fits; -1 where none does, or the body or depth has
    no kernel."""
    if len(tuple(net_dims)) != 2 or not kernel_has_body(body):
        return -1
    if body.tables is not None:
        smem = lambda lv: min(actor_smem_bytes(  # noqa: E731
            body.state_dim, net_dims, body.action_dim, c, bf16=bf16, streamed=lv)
            for c in ROLLOUT_CLUSTERS)
        last = STOCK_LEVELS
    else:
        smem = lambda lv: min(rollout_smem_bytes(body, net_dims, c, bf16, lv)  # noqa: E731
                              for c in (ROLLOUT_CLUSTERS if lv else (8,)))
        last = ROLLOUT_LEVELS
    return next((lv for lv in range(last + 1) if smem(lv) <= SMEM_LIMIT), -1)


def rollout_group_lanes(body: KernelEnvBody, net_dims: Sequence[int], bf16: bool = False) -> int:
    """The env lanes of a group of the rollout kernel's design at these
    widths (:func:`rollout_level`; the stock body's actor kernel); 0 where
    no design fits."""
    level = rollout_level(body, net_dims, bf16)
    if level < 0:
        return 0
    if body.tables is not None:
        return narrow_lanes(_TE, level)
    return narrow_lanes(STREAM_LANES, level) if level else _TE


def _rollout_fits(body: KernelEnvBody, net_dims: Sequence[int], bf16: bool,
                  streamed: bool) -> bool:
    """One design of the rollout kernel holds this body at these widths:
    the actor kernel and the critic pass for a market-data body, else a
    cluster of 8 (the resident design) or of any size (the streamed one,
    in any of its lane groups)."""
    level = rollout_level(body, net_dims, bf16)
    if level < 0:
        return False
    if body.tables is not None:   # the critic pass: resident tiles, or (streamed) any
        return (critic_smem_bytes(net_dims) <= SMEM_LIMIT
                and (streamed or (level == 0 and critic_tile(net_dims) > _CT_STREAM)))
    return streamed or level == 0


def rollout_fits_resident(body: KernelEnvBody, net_dims: Sequence[int],
                          bf16: bool = False) -> bool:
    """Whether the resident design of the CUDA kernel takes this body at these
    widths (``bf16``: its bf16-compute variant): the registered bodies where
    a cluster of 8 blocks holds both nets' slices (:func:`rollout_smem_bytes`;
    (256, 256) and more in float32, (512, 512) in bf16 but on
    PointChasingDiscreteEnv); a market-data body (built for
    ``STOCK_KERNEL_STOCKS`` stocks) as the actor-only rollout, where a
    cluster holds the actor's slices (:func:`actor_smem_bytes`), plus the
    critic pass with W1's lane columns held (:func:`critic_smem_bytes`)."""
    return _rollout_fits(body, net_dims, bf16, False)


def rollout_fits(body: KernelEnvBody, net_dims: Sequence[int], bf16: bool = False) -> bool:
    """Whether the CUDA kernel takes this body at these widths in one of its
    designs: the resident one (:func:`rollout_fits_resident`) or the
    streamed one, whose activation tiles a block holds up to a first width
    past 1024 (:func:`rollout_width_limit`)."""
    return _rollout_fits(body, net_dims, bf16, False) or _rollout_fits(body, net_dims, bf16, True)


def rollout_width_limit(body: KernelEnvBody, bf16: bool = False, resident: bool = False) -> int:
    """The widest square net (a multiple of 4) that the rollout kernel takes
    (:func:`rollout_fits`; ``resident``: that the resident design takes,
    :func:`rollout_fits_resident`)."""
    fits = rollout_fits_resident if resident else rollout_fits
    return _widest(lambda dims: fits(body, dims, bf16),
                   ('rollout', _body_key(body), bool(bf16), resident))


def stock_width_limit(head: Optional[str] = None, bf16: bool = False,
                      critic: bool = True, resident: bool = False) -> int:
    """The widest square net (a multiple of 4) whose actor a cluster of the
    stock actor kernel takes (:func:`actor_smem_bytes`; ``head`` None
    on-policy, else the off-policy head) in either design, on-policy with
    ``critic`` the critic pass too (:func:`critic_smem_bytes`).  With
    ``resident`` the widest the resident designs take: in float32 448 (416
    for sac and modsac); in bf16 576 on-policy (the critic pass; the actor
    kernel alone 704), 704 for ddpg, 640 for sac and modsac."""
    S, A = _STOCK_S, STOCK_KERNEL_STOCKS
    with_critic = head is None and critic
    designs = (0,) if resident else range(STOCK_LEVELS + 1)

    def fits(dims):
        return (any(min(actor_smem_bytes(S, dims, A, c, head, bf16, st) for c in ROLLOUT_CLUSTERS)
                    <= SMEM_LIMIT for st in designs)
                and (not with_critic or critic_smem_bytes(
                    dims, None if not resident else _CTS[1]) <= SMEM_LIMIT))
    return _widest(fits, ('stock', head, bool(bf16), with_critic, resident))


def stream_weights(flats: Sequence[torch.Tensor], in_dim: int, net_dims: Sequence[int],
                   bf16: bool = False) -> torch.Tensor:
    """The streamed design's copy of layer 2's weights: W2 ``(D2, D1)`` of
    each flat net (leaves W1 ``(D1, in_dim)``, b1, W2, ...) zero-padded to
    ``(round32(D2), round32(D1))``, one net after the other, in bf16 (rounded
    to the nearest, as the resident design rounds its slices) under
    ``bf16``.  The kernels read every cluster size's slices of it."""
    D1, D2 = (int(d) for d in net_dims)
    r32 = lambda n: -(-n // 32) * 32  # noqa: E731
    o = D1 * int(in_dim) + D1
    out = torch.zeros((len(flats), r32(D2), r32(D1)), device=flats[0].device,
                      dtype=torch.bfloat16 if bf16 else torch.float32)
    for i, flat in enumerate(flats):
        out[i, :D2, :D1] = flat[o:o + D2 * D1].view(D2, D1)
    return out


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
                            net_dims: Sequence[int],
                            compute_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Plain version of the critic pass: ``(H, N)`` values of the stored
    ``(H, S, N)`` states (float32 or bf16), the full MLP on every sample in
    ``compute_dtype`` (as the module says)."""
    S = states.shape[1]
    shapes = ppo_param_shapes(S, net_dims, 1, True)[1]
    xn = (states.float().transpose(1, 2) - norm_avg) / (norm_std + 1e-4)
    return mlp_apply_leaves(split_flat(cri_flat, shapes), xn, compute_dtype)[..., 0]


def critic_values(cri_flat: torch.Tensor, norm_avg: torch.Tensor, norm_std: torch.Tensor,
                  states: torch.Tensor, values: Optional[torch.Tensor] = None, *,
                  net_dims: Sequence[int],
                  compute_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """The critic pass of the actor-only stock rollout: the CUDA kernel for
    CUDA tensors (writing into ``values`` when given; its bf16 variant under
    ``compute_dtype=torch.bfloat16``; ``states`` float32 or bf16), the plain
    version for CPU tensors.

    Precondition of the kernel: ``states`` are the stock body's (``S =
    151``), and the lanes of a group of ``_TE`` (``n // 32`` equal) share
    each step's market rows, which the kernel applies once per (step,
    group), from the group's first lane.  The stock rollouts' stored states
    always meet it (:func:`block_day`)."""
    _check_dtypes('critic_values', compute_dtype, None)
    if cri_flat.device.type == 'cpu':   # the plain version, only for CPU tensors
        return critic_values_reference(cri_flat, norm_avg, norm_std, states, net_dims=net_dims,
                                       compute_dtype=compute_dtype)
    if cri_flat.device.type != 'cuda':
        raise ValueError(f'critic_values: unsupported device {cri_flat.device}')
    if len(net_dims) != 2:
        raise ValueError(f'critic_values: the CUDA kernel takes 2 hidden layers, got {net_dims}')
    from ._cuda_build import check, check_tensor, ptr
    D1, D2 = (int(d) for d in net_dims)
    H, S, N = states.shape
    if S != _STOCK_S:
        raise ValueError(f'critic_values: the CUDA kernel takes the stock body\'s {_STOCK_S} '
                         f'obs rows, got {S}')
    tile = critic_tile((D1, D2))
    lib = _library(4 if tile == _CT_NARROW else 0)   # the 16-sample tile: the narrow library
    smem = lib.critic_values_smem_bytes(D1, D2)
    if smem > SMEM_LIMIT:
        raise ValueError(f'critic_values: net_dims={tuple(net_dims)} needs {smem} bytes of '
                         f'shared memory per block even on tiles of {_CT_NARROW} samples, more '
                         f'than the {SMEM_LIMIT} a Hopper block can hold (the first width is '
                         f'at most {_widest(lambda d: critic_smem_bytes(d) <= SMEM_LIMIT)})')
    dev, f32 = cri_flat.device, torch.float32
    n_cri = sum(math.prod(sh) for sh in ppo_param_shapes(S, (D1, D2), 1, True)[1])
    check_tensor('critic_values', 'cri_flat', cri_flat, (n_cri,), f32, dev)
    check_tensor('critic_values', 'norm_avg', norm_avg, (S,), f32, dev)
    check_tensor('critic_values', 'norm_std', norm_std, (S,), f32, dev)
    sbf = int(states.dtype == torch.bfloat16)
    check_tensor('critic_values', 'states', states, (H, S, N), (f32, torch.bfloat16)[sbf], dev)
    if values is None:
        values = torch.empty((H, N), dtype=f32, device=dev)
    check_tensor('critic_values', 'values', values, (H, N), f32, dev)
    bf = int(compute_dtype is not None)
    stream = torch.cuda.current_stream(dev).cuda_stream
    check(lib.critic_values(ptr(cri_flat), ptr(norm_avg), ptr(norm_std), ptr(states),
                            ptr(values), N, H, D1, D2, bf, sbf, ctypes.c_void_p(stream)),
          'critic_values')
    critic_values.launches += 1
    # the bf16 variant and the streamed designs count apart
    kind = ('float32', 'bf16')[bf] + {_CT_STREAM: ',streamed',
                                      _CT_NARROW: f',streamed{_CT_NARROW}'}.get(tile, '')
    critic_values.launches_by_kind[kind] = critic_values.launches_by_kind.get(kind, 0) + 1
    return values


critic_values.launches = 0
critic_values.launches_by_kind = {}


def rollout(act_flat: torch.Tensor, cri_flat: torch.Tensor,
            norm_avg: torch.Tensor, norm_std: torch.Tensor,
            env_f: torch.Tensor, env_i: torch.Tensor, *,
            net_dims: Sequence[int], horizon_len: int, reward_scale: float,
            noise: Optional[torch.Tensor] = None,
            seed: Optional[torch.Tensor] = None,
            body: KernelEnvBody = PENDULUM_BODY, stock_cluster: int = 0,
            cluster: int = 0, compute_dtype: Optional[torch.dtype] = None,
            store_dtype: Optional[torch.dtype] = None) -> RolloutOutputs:
    """The fused rollout: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors.  ``compute_dtype`` and ``store_dtype`` (None or
    ``torch.bfloat16``) as the module says.  ``cluster`` and
    ``stock_cluster`` set the cluster size of the rollout kernel and of the
    stock actor kernel (1, 2, 4 or 8; 0, the default, lets the kernel choose
    from the card's occupancy, the choice kept per body, env count, widths,
    compute type and device); knobs for measuring the options."""
    _check_dtypes('rollout', compute_dtype, store_dtype)
    kw = dict(net_dims=net_dims, horizon_len=horizon_len,
              reward_scale=reward_scale, noise=noise, seed=seed, body=body,
              compute_dtype=compute_dtype, store_dtype=store_dtype)
    if act_flat.device.type == 'cpu':
        return rollout_reference(act_flat, cri_flat, norm_avg, norm_std,
                                 env_f, env_i, **kw)
    if act_flat.device.type != 'cuda':
        raise ValueError(f'rollout: unsupported device {act_flat.device}')
    stock = body.tables is not None
    bf, quant = int(compute_dtype is not None), int(store_dtype is not None)
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
    if stock:    # the actor-only rollout; the critic pass fills the values
        stock_args = _stock_args(body, act_flat.device)
        design = _design(lambda v: min(_library(v).stock_rollout_smem_bytes(D1, D2, c, v)
                                       for c in ROLLOUT_CLUSTERS), bf, 'rollout', net_dims,
                         lambda: f'{stock_width_limit(None, bf, critic=False)} in '
                                 f'{("float32", "bf16")[bf]} on {body.env_name}', STOCK_LEVELS)
        lib = _library(bf | design)
        if not stock_cluster:
            stock_cluster = _rollout_cluster(lib, body, N, D1, D2, act_flat.device, bf | design)
    else:
        design = _design(lambda v: min(_library(v).fused_rollout_smem_bytes(body.kernel_id, D1,
                                                                            D2, c, v)
                                       for c in ((8,) if v == bf else ROLLOUT_CLUSTERS)),
                         bf, 'rollout', net_dims,
                         lambda: f'{rollout_width_limit(body, bf)} in '
                                 f'{("float32", "bf16")[bf]} on {body.env_name}', ROLLOUT_LEVELS)
        lib = _library(bf | design)
        if not cluster:
            cluster = _rollout_cluster(lib, body, N, D1, D2, act_flat.device, bf | design)
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
        states=torch.empty((H, S, N), dtype=store_dtype or f32, device=dev),
        actions=actions,
        logprobs=torch.empty((H, N), dtype=f32, device=dev),
        rewards=torch.empty((H, N), dtype=f32, device=dev),
        terminals=torch.empty((H, N), dtype=f32, device=dev),
        truncates=torch.empty((H, N), dtype=f32, device=dev),
        values=torch.empty((H, N), dtype=f32, device=dev),
        env_f=torch.empty_like(env_f), env_i=torch.empty_like(env_i))
    stream = torch.cuda.current_stream(dev).cuda_stream
    w2 = None    # the resident design; else the streamed designs' copy of W2
    if design:
        w2 = stream_weights((act_flat,) if stock else (act_flat, cri_flat), S, (D1, D2), bf)
    if stock:
        status = lib.stock_rollout(
            ptr(act_flat), ptr(norm_avg), ptr(norm_std), ptr(env_f), ptr(env_i), ptr(noise),
            ptr(seed), *[ptr(t) for t in out if t is not out.values], N, H, D1, D2,
            ctypes.c_float(reward_scale), int(stock_cluster), bf | design, quant,
            ctypes.byref(stock_args), ptr(w2), ctypes.c_void_p(stream))
    else:
        status = lib.fused_rollout(
            body.kernel_id,
            ptr(act_flat), ptr(cri_flat), ptr(norm_avg), ptr(norm_std),
            ptr(env_f), ptr(env_i), ptr(noise), ptr(seed),
            *[ptr(t) for t in out],
            N, H, D1, D2, ctypes.c_float(reward_scale), int(cluster), bf | design, quant,
            ptr(w2), ctypes.c_void_p(stream))
    # the bf16 variant and the streamed designs count apart
    tag = (body.env_name + (',bf16' if bf else '')
           + _design_tag(design, _TE if stock else STREAM_LANES))
    check(status, f'fused_rollout[{tag}]')
    rollout.launches += 1
    rollout.launches_by_body[tag] = rollout.launches_by_body.get(tag, 0) + 1
    if stock:
        critic_values(cri_flat, norm_avg, norm_std, out.states, out.values, net_dims=(D1, D2),
                      compute_dtype=compute_dtype)
    return out


rollout.launches = 0
rollout.launches_by_body = {}

_CLUSTER_PICKS = {}   # (body, envs, D1, D2, device index, bf) -> the rollout kernel's cluster size


def _design(smem_of, bf: int, what: str, net_dims, limit,
            last: int = ROLLOUT_LEVELS) -> int:
    """The design a kernel takes, as a variant's design bits (``level <<
    1``): the first level from 0 (resident) over 1 (``STREAMED``) to
    ``last`` (the narrowest streamed group, 4 lanes) at which ``smem_of(bf
    | level << 1)``, the least shared memory a block of it takes in its
    library's reckoning, fits a block; raises past all of them, naming the
    widest square width ``limit()`` (a search, reckoned only then: the
    wrapper asks at every launch)."""
    for level in range(last + 1):
        smem = smem_of(bf | level << 1)
        if 0 < smem <= SMEM_LIMIT:
            return level << 1
    raise ValueError(f'{what}: net_dims={tuple(net_dims)} needs {smem} bytes of shared memory '
                     f'in each block even with layer 2 streamed from device memory on lane '
                     f'groups of 4 lanes, more than the {SMEM_LIMIT} a Hopper block can hold '
                     f'(square widths up to {limit()}, ROADMAP.md)')


def _design_tag(design: int, widest: int) -> str:
    """What a launch counts under for its design bits: nothing for the
    resident design, ``',streamed'`` for the streamed one at its widest
    group of ``widest`` lanes, ``',streamed<lanes>'`` for its narrower
    groups."""
    level = design >> 1
    if level == 0:
        return ''
    return ',streamed' if level == 1 else f',streamed{narrow_lanes(widest, level)}'



def _kept_pick(picks: dict, key, ask) -> int:
    """``ask()``, a kernel's cluster pick from the card's occupancy, asked once
    per ``key`` and kept in ``picks``: a pick makes up to sixteen CUDA runtime
    calls.  0 where nothing fits (not kept; the launch then reports the
    error)."""
    if key not in picks:
        c = ask()
        if c <= 0:
            return 0
        picks[key] = c
    return picks[key]


def _rollout_cluster(lib, body: KernelEnvBody, N: int, D1: int, D2: int, device,
                     bf: int = 0) -> int:
    """The rollout kernel's cluster size (``fused_rollout_cluster``; for the
    stock body the actor kernel's, ``stock_rollout_cluster``), kept per body,
    env count, widths, device and variant (``bf``: bit 0 bf16, ``STREAMED``
    the streamed design)."""
    if body.tables is not None:
        ask = lambda: lib.stock_rollout_cluster(N, D1, D2, 0, bf)  # noqa: E731
    else:
        ask = lambda: lib.fused_rollout_cluster(body.kernel_id, N, D1, D2, 0, bf)  # noqa: E731
    return _kept_pick(_CLUSTER_PICKS, (body.kernel_id, N, D1, D2, device.index, bf), ask)


# the entry points of csrc/fused_rollout.cu that offpolicy_rollout.cu (and
# offpolicy_narrow.cu) builds; onpolicy_rollout.cu (onpolicy_narrow.cu) builds
# the others (their nvcc runs side by side)
_OFFPOLICY_ENTRIES = ('offpolicy_rollout', 'offpolicy_rollout_smem_bytes',
                      'offpolicy_rollout_cluster', 'offpolicy_stock_rollout')
# the libraries of csrc/fused_rollout.cu: (on-policy, off-policy) halves of the
# resident and streamed designs, and of the narrower streamed groups
ROLLOUT_LIBRARIES = (('onpolicy_rollout', 'offpolicy_rollout'),
                     ('onpolicy_narrow', 'offpolicy_narrow'))


def _library(variant: int = 0):
    """The rollout kernels' library for a variant: ``onpolicy_rollout``'s
    entry points with ``offpolicy_rollout``'s beside them (both built from
    ``csrc/fused_rollout.cu``, their ``nvcc`` runs started together), or for
    a narrower streamed group (design level 2 and up) ``onpolicy_narrow``'s
    with ``offpolicy_narrow``'s, built at its first use."""
    from . import _cuda_build
    names = ROLLOUT_LIBRARIES[int(variant >> 1 >= 2)]
    if not all(n in _cuda_build._loaded for n in names):
        _cuda_build.build(list(names))
    lib = _cuda_build.load(names[0])
    fn = lib.fused_rollout
    if fn.argtypes is None:
        off = _cuda_build.load(names[1])
        for name in _OFFPOLICY_ENTRIES:
            setattr(lib, name, getattr(off, name))
        fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 17 + [ctypes.c_int] * 4
                       + [ctypes.c_float] + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 2)
        fn.restype = ctypes.c_int
        lib.fused_rollout_smem_bytes.argtypes = [ctypes.c_int] * 5
        lib.fused_rollout_smem_bytes.restype = ctypes.c_int
        lib.fused_rollout_cluster.argtypes = [ctypes.c_int] * 6
        lib.fused_rollout_cluster.restype = ctypes.c_int
        lib.offpolicy_rollout.argtypes = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 12
                                          + [ctypes.c_int] * 4 + [ctypes.c_float] * 5
                                          + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 2)
        lib.offpolicy_rollout.restype = ctypes.c_int
        lib.offpolicy_rollout_smem_bytes.argtypes = [ctypes.c_int] * 6
        lib.offpolicy_rollout_smem_bytes.restype = ctypes.c_int
        lib.offpolicy_rollout_cluster.argtypes = [ctypes.c_int] * 7
        lib.offpolicy_rollout_cluster.restype = ctypes.c_int
        lib.stock_rollout.argtypes = ([ctypes.c_void_p] * 15 + [ctypes.c_int] * 4
                                      + [ctypes.c_float] + [ctypes.c_int] * 3
                                      + [ctypes.c_void_p] * 3)
        lib.stock_rollout.restype = ctypes.c_int
        lib.stock_rollout_smem_bytes.argtypes = [ctypes.c_int] * 4
        lib.stock_rollout_smem_bytes.restype = ctypes.c_int
        lib.stock_rollout_cluster.argtypes = [ctypes.c_int] * 5
        lib.stock_rollout_cluster.restype = ctypes.c_int
        lib.critic_values.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
        lib.critic_values.restype = ctypes.c_int
        lib.critic_values_smem_bytes.argtypes = [ctypes.c_int] * 2
        lib.critic_values_smem_bytes.restype = ctypes.c_int
        lib.offpolicy_stock_rollout.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 12
                                                + [ctypes.c_int] * 4 + [ctypes.c_float] * 4
                                                + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 3)
        lib.offpolicy_stock_rollout.restype = ctypes.c_int
    return lib


# ---------------------------------------------------- runner integration

def make_fused_rollout(body: KernelEnvBody, net_dims, horizon_len: int,
                       num_envs: int, reward_scale: float,
                       compute_dtype: Optional[torch.dtype] = None,
                       store_dtype: Optional[torch.dtype] = None):
    """``rollout_fn(agent_state, env_state, gen, noise=None) -> (Rollout,
    env_state', last_obs)``: the fast path for ``collect_rollout`` on the
    on-policy agents with a kernel-body env, in the given compute and
    storage types.  Without ``noise`` the kernel's internal Philox draws are
    keyed by a seed taken from ``gen``."""
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
                      seed=seed, body=body, compute_dtype=compute_dtype,
                      store_dtype=store_dtype)
        ro = Rollout(states=out.states, actions=out.actions, logprobs=out.logprobs,
                     rewards=out.rewards, undones=1.0 - out.terminals,
                     unmasks=1.0 - out.truncates,
                     extras={'values': out.values, 'tsn': True})
        last_obs = body.obs(out.env_f, out.env_i).T
        return ro, body.unpack(out.env_f, out.env_i), last_obs

    return rollout_fn


# ------------------------------------------------------- mesh data parallel
# The JAX package's sharded wrappers (``pallas_rollout.py:908, 1308``)
# ``shard_map`` the one-chip kernel over the env shards, each shard keyed by
# ``fold_in(key, axis_index)``.  Here each shard is one launch of the same
# kernel at ``num_envs / n`` envs on its shard's device, keyed by the round's
# seed folded with the shard's global index; the outputs are concatenated in
# the kernel's layout (and across processes all-gathered,
# ``parallel/mesh.py:gather_env_axis``) for the update, which runs on the
# union.

_FOLD_MULT = (0x85EBCA6B, 0xC2B2AE35)


def fold_seed(seed: torch.Tensor, index) -> torch.Tensor:
    """The Philox key of shard ``index`` (an int: ``(2,)``; a sequence:
    ``(len, 2)``) from the round's ``(2,)`` int32 key ``seed``: word ``w``
    is ``seed[w] + (index + 1) * M[w] mod 2^32`` with the odd constants
    ``M = (0x85EBCA6B, 0xC2B2AE35)``, as int32.  Every shard, shard 0 too,
    gets a key other than the round's, as ``jax.random.fold_in(key,
    axis_index)`` does; the keys of two shards differ in both words."""
    dev = seed.device
    r = torch.as_tensor(index, dtype=torch.int64, device=dev)
    k = (seed.to(torch.int64) + (r[..., None] + 1)
         * torch.tensor(_FOLD_MULT, dtype=torch.int64, device=dev)) & _MASK
    return torch.where(k >= 2 ** 31, k - 2 ** 32, k).to(torch.int32)


def shard_fits(body: Optional[KernelEnvBody], num_envs: int, shards: int) -> bool:
    """Whether ``num_envs`` in ``shards`` shards suits the body: any body
    but the stock one, whose shards must hold whole ``_TE``-lane groups."""
    return shards == 1 or body is None or body.tables is None or (num_envs // shards) % _TE == 0


def _shard_envs(mesh, num_envs: int, body: KernelEnvBody, what: str) -> int:
    """The envs of one shard; raises where they do not divide, and on the
    stock body where a shard would part a lane group (its days and market
    rows are per group of ``_TE`` lanes, as the critic pass's precondition)."""
    if num_envs % mesh.size:
        raise ValueError(f"{what}: num_envs={num_envs} not divisible by the mesh's "
                         f'{mesh.size} shards')
    local = num_envs // mesh.size
    if body.tables is not None and local % _TE:
        raise ValueError(f"{what}: the stock body needs each shard's envs, "
                         f'{num_envs} / {mesh.size} = {local}, to be a multiple of its '
                         f'{_TE}-lane group')
    return local


def _shard_inputs(mesh, local: int, gen, noise):
    """Each shard's noise columns (the union's ``(H, rows, N)`` tensor) or
    its folded seed, drawn once from ``gen`` for the round."""
    if noise is not None:
        return [(noise[..., r * local:(r + 1) * local].to(dev).contiguous(), None)
                for r, dev in zip(mesh.shards, mesh.devices)]
    seed = torch.randint(-2 ** 31, 2 ** 31 - 1, (2,), generator=gen, device=gen.device,
                         dtype=torch.int32)
    seeds = fold_seed(seed, list(mesh.shards))
    return [(None, seeds[j].to(dev)) for j, dev in enumerate(mesh.devices)]


def _sharded(mesh, num_envs: int, body: KernelEnvBody, what: str, reads, launch_one,
             to_rollout):
    """The rollout function of both sharded wrappers.  ``reads(agent_state)``
    are the tensors the kernel reads, copied to the shards on other devices
    (``parallel/mesh.py:replicate``); ``launch_one(tensors, f0, i0, noise,
    seed, launch)`` is one shard's launch, made with the shard's device
    current (``device_scope``); ``to_rollout(cat)`` builds the union's
    Rollout, where ``cat(name, dim)`` is the outputs ``name`` of the shards
    concatenated along ``dim`` on the lead device."""
    from ..parallel import mesh as pm
    local = _shard_envs(mesh, num_envs, body, what)

    def rollout_fn(agent_state, env_state, gen, noise=None, **launch):
        reps = pm.replicate(mesh, reads(agent_state))
        outs = []
        for j, (nz, seed) in enumerate(_shard_inputs(mesh, local, gen, noise)):
            with pm.device_scope(mesh.devices[j]):
                f0, i0 = body.pack(env_state[j])
                outs.append(launch_one(reps[j], f0.contiguous(), i0.contiguous(), nz, seed,
                                       launch))

        def cat(name, dim):
            return pm.gather_env_axis(pm.Shards([getattr(o, name) for o in outs], mesh), dim)

        last_obs = pm.gather_env_axis(pm.Shards([body.obs(o.env_f, o.env_i).T for o in outs],
                                                mesh))
        env_shards = pm.Shards([body.unpack(o.env_f, o.env_i) for o in outs], mesh)
        return to_rollout(cat), env_shards, last_obs

    return rollout_fn


def make_sharded_fused_rollout(body: KernelEnvBody, net_dims, horizon_len: int,
                               num_envs: int, reward_scale: float, mesh,
                               compute_dtype: Optional[torch.dtype] = None,
                               store_dtype: Optional[torch.dtype] = None):
    """``rollout_fn(agent_state, env_shards, gen, noise=None, **launch) ->
    (Rollout, env_shards', last_obs)`` over a mesh (``parallel/mesh.py``):
    one launch of the fused rollout kernel per shard at ``num_envs /
    mesh.size`` envs, on the shard's env state (``Shards``) and device;
    without ``noise`` shard ``r`` is keyed by :func:`fold_seed` of one seed
    taken from ``gen``, with ``noise`` (the union's) it takes its columns.
    The rollout and ``last_obs`` are the union's, the ``(H, S, N)`` layout
    concatenated along its trailing env axis, on the lead device;
    ``launch`` goes to :func:`rollout` (``cluster``, ``stock_cluster``)."""
    from ..agents.base import Rollout
    H = int(horizon_len)
    net_dims = tuple(int(d) for d in net_dims)

    def launch_one(t, f0, i0, noise, seed, launch):
        return rollout(*t, f0, i0, net_dims=net_dims, horizon_len=H,
                       reward_scale=reward_scale, noise=noise, seed=seed, body=body,
                       compute_dtype=compute_dtype, store_dtype=store_dtype, **launch)

    def to_rollout(cat):
        return Rollout(states=cat('states', -1), actions=cat('actions', -1),
                       logprobs=cat('logprobs', -1), rewards=cat('rewards', -1),
                       undones=1.0 - cat('terminals', -1), unmasks=1.0 - cat('truncates', -1),
                       extras={'values': cat('values', -1), 'tsn': True})

    return _sharded(mesh, num_envs, body, 'make_sharded_fused_rollout',
                    lambda s: (s.act_flat, s.cri_flat, s.norm_avg, s.norm_std),
                    launch_one, to_rollout)


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
                                env_trace: Optional[list] = None,
                                compute_dtype: Optional[torch.dtype] = None,
                                store_dtype: Optional[torch.dtype] = None,
                                env_actions: Optional[list] = None
                                ) -> OffPolicyRolloutOutputs:
    """Plain PyTorch version of the off-policy rollout kernel.  ``flat`` is
    the agent's flat actor (ddpg, sac, modsac) or Q buffer; ``env_trace``,
    ``env_actions``, ``compute_dtype`` and ``store_dtype`` as in
    :func:`rollout_reference` (the stored float actions in ``store_dtype``
    too, while the env steps on the float32 ones)."""
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
        if store_dtype is not None:                          # round before acting
            x = x.to(store_dtype).float()
        u = noise[t] if seed is None else u_all[t]
        if head in CONTINUOUS_HEADS:
            if seed is None:
                z, u_env = u[:A], u[A:]
            else:
                z = torch.sqrt(-2.0 * torch.log(1.0 - u[0:A])) * torch.cos(_TWO_PI * u[A:2 * A])
                u_env = u[2 * A:]
            if head == 'ddpg':
                out = mlp_apply_leaves(leaves, x.T, compute_dtype).T   # (A, N)
                action = torch.clamp(torch.tanh(out) + noise_std * z, -1.0, 1.0)
            else:
                mean, log_std = sac_actor_dist(leaves, x.T, head == 'modsac', std_clip,
                                               compute_dtype)
                action = torch.tanh(mean.T + torch.exp(log_std.T) * z)
            env_a, stored = action, action.T
        else:
            q = dqn_q_greedy(leaves, x.T, head == 'dqn_enc', head == 'dqn_duel',
                             compute_dtype)                  # (N, A)
            greedy = torch.argmax(q, dim=1)                  # first max on a tie
            rand = torch.clamp(torch.floor(u[1] * A), max=A - 1).long()
            index = torch.where(u[0] < explore_rate, rand, greedy)
            env_a, stored = index[None].float(), index.to(torch.int32)
            u_env = u[2:]
        if env_actions is not None:
            env_actions.append(env_a)
        f2, i2, reward, terminal, trunc = body.step(f, i, env_a, u_env[0:body.n_step])
        f, i = body.reset(f2, i2, u_env[body.n_step:body.n_step + body.n_reset],
                          terminal | trunc)
        outs['states'].append(x.T)
        outs['actions'].append(stored)
        outs['rewards'].append(reward[0] * reward_scale)
        outs['terminals'].append(terminal[0].float())
        outs['truncates'].append(trunc[0].float())
    out = OffPolicyRolloutOutputs(*[torch.stack(v) for v in outs.values()], f, i)
    if store_dtype is None:
        return out
    return out._replace(states=out.states.to(store_dtype),
                        actions=(out.actions.to(store_dtype) if head in CONTINUOUS_HEADS
                                 else out.actions))


OFF_LANES = 16   # env lanes of an off-policy group (csrc/fused_rollout.cu: OFF_LANES)


def offpolicy_out_rows(action_dim: int, head: str) -> int:
    """Rows of the head's output: 2A (sac, modsac), A + 1 (dqn_duel), A."""
    A = action_dim
    return 2 * A if head in ('sac', 'modsac') else A + 1 if head == 'dqn_duel' else A


def offpolicy_smem_bytes(body: KernelEnvBody, net_dims: Sequence[int], head: str,
                         cluster: int = 8, bf16: bool = False, streamed: int = 0) -> int:
    """Shared memory of one block of the off-policy rollout for clusters of
    ``cluster`` blocks over a group of ``OFF_LANES`` lanes: the block's
    slices of W1's and W2's rows and of the head's columns (a row of K
    inputs takes ``kernels.ldk(K)`` floats) and biases, then the lane tiles
    (the obs, the whole h1, the block's rows of h2, every block's part of
    the head rows, two steps' noise words, the normals, the summed head
    rows) and the split-K scratch of the widest product
    (``offpolicy_rollout_smem_bytes`` of ``csrc/fused_rollout.cu``:
    ``OffLayout``), with ``bf16`` the weight slices and the tiles xn, h1 and
    h2 in bf16, and with ``streamed`` (the design level: 1 the streamed
    design, 2 and 3 its narrower groups of 8 and 4 lanes) no W2 slice.
    The stock body runs the stock actor kernel (:func:`actor_smem_bytes`)."""
    D1, D2 = (int(d) for d in net_dims)
    S, A, c, bf = body.state_dim, body.action_dim, int(cluster), bool(bf16)
    G, st = narrow_lanes(OFF_LANES, int(streamed)), int(bool(streamed))
    if body.tables is not None:
        return actor_smem_bytes(S, (D1, D2), A, c, head, bf, streamed)
    r4 = lambda n: (n + 3) // 4 * 4  # noqa: E731
    half = lambda n: n // 2 if bf else n  # noqa: E731
    s4, op = r4(S), r4(offpolicy_out_rows(A, head))
    nh4 = r4(2 * A if head in CONTINUOUS_HEADS else 2)
    ne4 = r4(max(body.n_step + body.n_reset, 1))
    js1, js2 = r4(-(-D1 // c)), r4(-(-D2 // c))
    k2 = c * js1
    weights = (js1 * wrow(S, bf) + js1 + (1 - st) * js2 * wrow(k2, bf) + js2
               + op * wrow(js2, bf) + op)
    tiles = half((s4 + k2 + js2) * G) + (c * op + 2 * nh4 + 2 * ne4 + r4(A) + op) * G
    scratch = max(tile_scratch(s4, js1, G), tile_scratch(k2, js2, G), tile_scratch(js2, op, G))
    return 4 * (weights + tiles + r4(scratch))


def offpolicy_fits_resident(body: KernelEnvBody, head: str, net_dims: Sequence[int],
                            bf16: bool = False) -> bool:
    """Whether the resident design of the CUDA kernel takes this (body, head)
    pair at these widths (``bf16``: its bf16-compute variant): two hidden
    layers whose slices a cluster of 1, 2, 4 or 8 blocks holds (to (576, 576),
    and (544, 544) on PointChasingDiscreteEnv; on the stock body
    ``stock_width_limit(head, resident=True)``: 448 for ddpg and 416 for sac
    and modsac in float32, 704 and 640 in bf16)."""
    return (offpolicy_pair_fits(body, head) and len(tuple(net_dims)) == 2
            and min(offpolicy_smem_bytes(body, net_dims, head, c, bf16)
                    for c in ROLLOUT_CLUSTERS) <= SMEM_LIMIT)


def offpolicy_level(body: KernelEnvBody, head: str, net_dims: Sequence[int],
                    bf16: bool = False) -> int:
    """The design level the off-policy rollout takes for this pair at these
    widths, as the wrapper picks it on the card: the first of 0 (resident),
    1 (streamed) and the narrower streamed groups (up to ``OFF_LEVELS``;
    ``STOCK_LEVELS`` on the stock body) whose block fits at some cluster
    size; -1 where none does."""
    if not offpolicy_pair_fits(body, head) or len(tuple(net_dims)) != 2:
        return -1
    last = STOCK_LEVELS if body.tables is not None else OFF_LEVELS
    return next((lv for lv in range(last + 1)
                 if min(offpolicy_smem_bytes(body, net_dims, head, c, bf16, lv)
                        for c in ROLLOUT_CLUSTERS) <= SMEM_LIMIT), -1)


def offpolicy_group_lanes(body: KernelEnvBody, head: str, net_dims: Sequence[int],
                          bf16: bool = False) -> int:
    """The env lanes of a group of the off-policy design at these widths
    (:func:`offpolicy_level`); 0 where no design fits."""
    level = offpolicy_level(body, head, net_dims, bf16)
    if level < 0:
        return 0
    return narrow_lanes(_TE if body.tables is not None else OFF_LANES, level)


def offpolicy_fits(body: KernelEnvBody, head: str, net_dims: Sequence[int],
                   bf16: bool = False) -> bool:
    """Whether the CUDA kernel takes this (body, head) pair at these widths
    in one of its designs: the resident one (:func:`offpolicy_fits_resident`)
    or the streamed one in one of its lane groups, whose activation tiles a
    block holds up to a first width past 2048 (:func:`offpolicy_width_limit`)."""
    return offpolicy_level(body, head, net_dims, bf16) >= 0


def offpolicy_width_limit(body: KernelEnvBody, head: str, bf16: bool = False,
                          resident: bool = False) -> int:
    """The widest square net (a multiple of 4) that the off-policy rollout
    takes for this pair (``resident``: its resident design)."""
    fits = offpolicy_fits_resident if resident else offpolicy_fits
    return _widest(lambda dims: fits(body, head, dims, bf16),
                   ('offpolicy', _body_key(body), head, bool(bf16), resident))


def offpolicy_rollout(flat: torch.Tensor, env_f: torch.Tensor, env_i: torch.Tensor, *,
                      body: KernelEnvBody, head: str, net_dims: Sequence[int],
                      horizon_len: int, reward_scale: float, noise_std: float = 0.05,
                      explore_rate: float = 0.25, std_clip=(-16.0, 2.0),
                      noise: Optional[torch.Tensor] = None,
                      seed: Optional[torch.Tensor] = None,
                      cluster: int = 0, compute_dtype: Optional[torch.dtype] = None,
                      store_dtype: Optional[torch.dtype] = None) -> OffPolicyRolloutOutputs:
    """The off-policy fused rollout: the CUDA kernel for CUDA tensors, the
    plain version for CPU tensors.  ``compute_dtype`` and ``store_dtype`` as
    for :func:`rollout`.
    ``cluster`` sets the cluster size (1, 2, 4 or 8; 0, the default, lets
    the kernel choose from the card's occupancy, the choice kept per body,
    head, env count, widths, compute type and device); a knob for measuring
    the options."""
    _check_dtypes('offpolicy_rollout', compute_dtype, store_dtype)
    kw = dict(body=body, head=head, net_dims=net_dims, horizon_len=horizon_len,
              reward_scale=reward_scale, noise_std=noise_std, explore_rate=explore_rate,
              std_clip=std_clip, noise=noise, seed=seed, compute_dtype=compute_dtype,
              store_dtype=store_dtype)
    if flat.device.type == 'cpu':
        return offpolicy_rollout_reference(flat, env_f, env_i, **kw)
    if flat.device.type != 'cuda':
        raise ValueError(f'offpolicy_rollout: unsupported device {flat.device}')
    stock = body.tables is not None
    bf, quant = int(compute_dtype is not None), int(store_dtype is not None)
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
    head_id = OFFPOLICY_HEADS[head]
    design = _design(lambda v: min(_library(v).offpolicy_rollout_smem_bytes(
                                       body.kernel_id, head_id, D1, D2, c, v)
                                   for c in ROLLOUT_CLUSTERS), bf, 'offpolicy_rollout', net_dims,
                     lambda: f'{offpolicy_width_limit(body, head, bf)} for {head} in '
                             f'{("float32", "bf16")[bf]} on {body.env_name}',
                     STOCK_LEVELS if stock else OFF_LEVELS)
    lib = _library(bf | design)
    if not cluster:
        cluster = _offpolicy_cluster(lib, body, head_id, N, D1, D2, flat.device, bf | design)
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
    actions = (torch.empty((H, N, A), dtype=store_dtype or f32, device=dev)
               if head in CONTINUOUS_HEADS
               else torch.empty((H, N), dtype=torch.int32, device=dev))
    out = OffPolicyRolloutOutputs(
        states=torch.empty((H, N, S), dtype=store_dtype or f32, device=dev), actions=actions,
        rewards=torch.empty((H, N), dtype=f32, device=dev),
        terminals=torch.empty((H, N), dtype=f32, device=dev),
        truncates=torch.empty((H, N), dtype=f32, device=dev),
        env_f=torch.empty_like(env_f), env_i=torch.empty_like(env_i))
    stream = torch.cuda.current_stream(dev).cuda_stream
    w2 = stream_weights((flat,), S, (D1, D2), bf) if design else None
    if stock:
        hyper = [ctypes.c_float(v) for v in (reward_scale, noise_std, *std_clip)]
        status = lib.offpolicy_stock_rollout(
            head_id, ptr(flat), ptr(env_f), ptr(env_i), ptr(noise), ptr(seed),
            *[ptr(x) for x in out], N, H, D1, D2, *hyper, int(cluster), bf | design, quant,
            ctypes.byref(stock_args), ptr(w2), ctypes.c_void_p(stream))
    else:
        hyper = [ctypes.c_float(v) for v in (reward_scale, noise_std, explore_rate, *std_clip)]
        status = lib.offpolicy_rollout(
            body.kernel_id, head_id, ptr(flat), ptr(env_f), ptr(env_i),
            ptr(noise), ptr(seed), *[ptr(x) for x in out], N, H, D1, D2, *hyper,
            int(cluster), bf | design, quant, ptr(w2), ctypes.c_void_p(stream))
    # the bf16 variant and the streamed designs count apart
    tag = (f'{body.env_name},{head}' + (',bf16' if bf else '')
           + _design_tag(design, _TE if stock else OFF_LANES))
    check(status, f'offpolicy_rollout[{tag}]')
    offpolicy_rollout.launches += 1
    offpolicy_rollout.launches_by_kernel[tag] = offpolicy_rollout.launches_by_kernel.get(tag, 0) + 1
    return out


offpolicy_rollout.launches = 0
offpolicy_rollout.launches_by_kernel = {}

# (body, head, envs, D1, D2, device index, bf) -> the off-policy kernel's cluster size
_OFF_CLUSTER_PICKS = {}


def _offpolicy_cluster(lib, body: KernelEnvBody, head_id: int, N: int, D1: int, D2: int,
                       device, bf: int = 0) -> int:
    """The off-policy kernel's cluster size (``offpolicy_rollout_cluster``),
    kept per body, head, env count, widths, device and variant (as
    :func:`_rollout_cluster`)."""
    return _kept_pick(_OFF_CLUSTER_PICKS,
                      (body.kernel_id, head_id, N, D1, D2, device.index, bf),
                      lambda: lib.offpolicy_rollout_cluster(body.kernel_id, head_id, N, D1, D2,
                                                            0, bf))


def make_fused_offpolicy_rollout(body: KernelEnvBody, head: str, net_dims, horizon_len: int,
                                 num_envs: int, reward_scale: float, noise_std: float,
                                 explore_rate: float, std_clip=(-16.0, 2.0),
                                 compute_dtype: Optional[torch.dtype] = None,
                                 store_dtype: Optional[torch.dtype] = None):
    """``rollout_fn(agent_state, env_state, gen, noise=None) -> (Rollout,
    env_state', last_obs)`` for the off-policy agents, in the given compute
    and storage types: the flat buffer is the agent state's ``act`` (ddpg,
    sac, modsac) or ``q``; without ``noise`` the kernel's Philox draws are
    keyed by a seed taken from ``gen``."""
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
                                std_clip=std_clip, noise=noise, seed=seed,
                                compute_dtype=compute_dtype, store_dtype=store_dtype)
        ro = Rollout(states=out.states, actions=out.actions, logprobs=None,
                     rewards=out.rewards, undones=1.0 - out.terminals,
                     unmasks=1.0 - out.truncates)
        last_obs = body.obs(out.env_f, out.env_i).T
        return ro, body.unpack(out.env_f, out.env_i), last_obs

    return rollout_fn


def make_sharded_offpolicy_rollout(body: KernelEnvBody, head: str, net_dims,
                                   horizon_len: int, num_envs: int, reward_scale: float,
                                   mesh, noise_std: float, explore_rate: float,
                                   std_clip=(-16.0, 2.0),
                                   compute_dtype: Optional[torch.dtype] = None,
                                   store_dtype: Optional[torch.dtype] = None):
    """:func:`make_sharded_fused_rollout` for the off-policy heads: one
    launch of the off-policy kernel per shard, the union's ``(H, N, dim)``
    outputs concatenated along axis 1 (the replay ring's ``num_seqs``)."""
    from ..agents.base import Rollout
    H = int(horizon_len)
    net_dims = tuple(int(d) for d in net_dims)

    def launch_one(t, f0, i0, noise, seed, launch):
        return offpolicy_rollout(t[0], f0, i0, body=body, head=head, net_dims=net_dims,
                                 horizon_len=H, reward_scale=reward_scale, noise_std=noise_std,
                                 explore_rate=explore_rate, std_clip=std_clip, noise=noise,
                                 seed=seed, compute_dtype=compute_dtype,
                                 store_dtype=store_dtype, **launch)

    def to_rollout(cat):
        return Rollout(states=cat('states', 1), actions=cat('actions', 1), logprobs=None,
                       rewards=cat('rewards', 1), undones=1.0 - cat('terminals', 1),
                       unmasks=1.0 - cat('truncates', 1))

    return _sharded(mesh, num_envs, body, 'make_sharded_offpolicy_rollout',
                    lambda s: (s.act if head in CONTINUOUS_HEADS else s.q,),
                    launch_one, to_rollout)
