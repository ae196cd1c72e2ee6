"""LunarLander, discrete and continuous, as batched tensors (counterpart of
``elegantrl_tpu/envs/lunar_lander.py``).

A point-mass + rotation lander with leg-contact landing, calibrated in
observation units against gymnasium's Box2D LunarLander (the JAX module's
docstring gives the measurements):

- gravity d(vy)/step = -0.0267; full main engine +0.0372 along body up
  (throttle in [0.5, 1]); full side engine +-0.0359 on omega and 0.0089
  lateral on vx; obs vx and vy use different unit scales (``_VXY_RATIO``);
- semi-implicit Euler: velocities first, then ``dx = 0.0100 vx``,
  ``dy = 0.0225 vy``, ``dtheta = 0.05 omega``;
- reset: ``y = 1.41``, ``vx ~ U(+-0.84)``, ``vy ~ U(+-0.55)``, ``omega ~
  U(+-0.19)`` (the only draws; the step is deterministic);
- obs (8,) ``[x, y, vx, vy, theta, omega, leg1, leg2]``; continuous action
  ``[main (fires if > 0, throttle 0.5 + 0.5 a), side (fires if |a| > 0.5)]``;
  discrete ``{noop, left, main, right}``;
- reward: the change of gym's shaping (``-100 dist - 100 speed - 100
  |theta| + 10 per leg``, on the pre-damping velocities) minus fuel (0.3
  main, 0.03 side), -100 on a crash or ``|x| >= 1``, +100 on landing;
  truncation at 1000 steps.

No kernel body: the JAX package has none for this env, so its rollout is
the generic ``collect_rollout`` in both packages.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .base import EnvDef, EnvSpec, VecEnv

_MAX_STEP = 1000

# calibrated per-step deltas in observation units (the JAX module's :37-56)
_GRAVITY_DVY = -0.0267
_MAIN_DV = 0.0372
_VXY_RATIO = 0.0089 / 0.00592
_SIDE_DVX = 0.0089
_SIDE_DOMEGA = 0.0359
_DX_PER_VX = 0.0100
_DY_PER_VY = 0.0225
_DTHETA_PER_OMEGA = 0.05

_INIT_Y = 1.41
_INIT_VX = 0.84
_INIT_VY = 0.55
_INIT_OMEGA = 0.19
_LEG_DX = 0.12
_BODY_CLEARANCE = 0.05


class LanderState(NamedTuple):
    x: torch.Tensor             # (N,) f32
    y: torch.Tensor
    vx: torch.Tensor
    vy: torch.Tensor
    theta: torch.Tensor
    omega: torch.Tensor
    t: torch.Tensor             # (N,) int32 step counter
    prev_shaping: torch.Tensor


def _leg_contacts(x, y, theta):
    """Leg tips at or below the pad (obs y = 0 is the pad at leg level)."""
    s = torch.sin(theta)
    return (y - _LEG_DX * s) <= 0.0, (y + _LEG_DX * s) <= 0.0


def _shaping(x, y, vx, vy, theta, leg1, leg2):
    return (-100.0 * torch.sqrt(x * x + y * y)
            - 100.0 * torch.sqrt(vx * vx + vy * vy)
            - 100.0 * torch.abs(theta)
            + 10.0 * leg1.float()
            + 10.0 * leg2.float())


def _init(gen: torch.Generator, num_envs: int, device) -> LanderState:
    u = torch.rand((3, num_envs), generator=gen, device=device)
    zero = torch.zeros(num_envs, device=device)
    y = torch.full((num_envs,), _INIT_Y, device=device)
    vx = -_INIT_VX + (2 * _INIT_VX) * u[0]
    vy = -_INIT_VY + (2 * _INIT_VY) * u[1]
    omega = -_INIT_OMEGA + (2 * _INIT_OMEGA) * u[2]
    l1, l2 = _leg_contacts(zero, y, zero)
    return LanderState(zero, y, vx, vy, zero, omega,
                       torch.zeros(num_envs, dtype=torch.int32, device=device),
                       _shaping(zero, y, vx, vy, zero, l1, l2))


def _obs(s: LanderState) -> torch.Tensor:
    l1, l2 = _leg_contacts(s.x, s.y, s.theta)
    return torch.stack([s.x, s.y, s.vx, s.vy, s.theta, s.omega, l1.float(), l2.float()],
                       dim=-1)


def _dynamics(s: LanderState, main: torch.Tensor, side: torch.Tensor):
    """``main``: throttle in {0} u [0.5, 1]; ``side``: signed throttle in
    {0} u +-[0.5, 1]."""
    c, sn = torch.cos(s.theta), torch.sin(s.theta)
    dvx = -sn * main * _MAIN_DV * _VXY_RATIO + c * side * _SIDE_DVX
    dvy = c * main * _MAIN_DV + sn * side * _SIDE_DVX / _VXY_RATIO + _GRAVITY_DVY
    domega = -side * _SIDE_DOMEGA

    vx = s.vx + dvx
    vy = s.vy + dvy
    omega = s.omega + domega
    x = s.x + _DX_PER_VX * vx
    y = s.y + _DY_PER_VY * vy
    theta = s.theta + _DTHETA_PER_OMEGA * omega

    l1, l2 = _leg_contacts(x, y, theta)
    grounded = l1 | l2
    vy_impact, vx_impact = vy, vx       # pre-damping velocities at contact
    vy = torch.where(grounded & (vy < 0), 0.0, vy)
    vx = torch.where(grounded, vx * 0.5, vx)
    omega = torch.where(grounded, omega * 0.5, omega)
    settling = grounded & (torch.abs(theta) < 0.4)
    theta = torch.where(settling, theta * 0.8, theta)
    y = torch.where(settling & (y < 0), 0.0, y)
    t = s.t + 1

    # the shaping reads the pre-damping velocities, so a hard impact keeps
    # its -100 * speed penalty
    shaping = _shaping(x, y, vx_impact, vy_impact, theta, l1, l2)
    reward = shaping - s.prev_shaping
    reward = reward - 0.30 * main - 0.03 * torch.abs(side)

    body_hit = (y - torch.abs(_LEG_DX * torch.sin(theta))) < -_BODY_CLEARANCE
    hard_impact = grounded & (vy_impact < -0.55)
    crashed = body_hit | hard_impact | (grounded & (torch.abs(theta) > 0.4))
    out = torch.abs(x) >= 1.0
    landed = (grounded & (torch.abs(theta) < 0.1) & (torch.abs(vx) < 0.02)
              & (torch.abs(vy) < 0.02) & (torch.abs(omega) < 0.02))
    terminal = crashed | out | landed
    reward = torch.where(crashed | out, reward - 100.0, reward)
    reward = torch.where(landed, reward + 100.0, reward)
    truncate = (t >= _MAX_STEP) & ~terminal
    return LanderState(x, y, vx, vy, theta, omega, t, shaping), reward, terminal, truncate


def _step_continuous(s: LanderState, action: torch.Tensor, gen=None):
    a0, a1 = action[..., 0], action[..., 1]
    main = torch.where(a0 > 0.0, 0.5 + 0.5 * torch.clamp(a0, 0, 1), 0.0)
    side = torch.where(torch.abs(a1) > 0.5,
                       torch.sign(a1) * torch.clamp(torch.abs(a1), 0.5, 1.0), 0.0)
    return _dynamics(s, main, side)


def _step_discrete(s: LanderState, action: torch.Tensor, gen=None):
    a = action.to(torch.int32)
    one = torch.ones_like(s.x)
    main = torch.where(a == 2, one, 0.0)
    side = torch.where(a == 1, -one, torch.where(a == 3, one, 0.0))
    return _dynamics(s, main, side)


def make_lunar_lander(continuous: bool = False) -> EnvDef:
    if continuous:
        spec = EnvSpec(env_name='LunarLanderContinuous-v2', num_envs=1, max_step=_MAX_STEP,
                       state_dim=8, action_dim=2, if_discrete=False)
        return EnvDef(spec=spec, init=_init, obs=_obs, step=_step_continuous)
    spec = EnvSpec(env_name='LunarLander-v2', num_envs=1, max_step=_MAX_STEP,
                   state_dim=8, action_dim=4, if_discrete=True)
    return EnvDef(spec=spec, init=_init, obs=_obs, step=_step_discrete)


class LunarLanderEnv(VecEnv):
    def __init__(self, num_envs: int = 1, seed: int = 0, device: str = 'cpu', **_kwargs):
        super().__init__(make_lunar_lander(False), num_envs=num_envs, seed=seed, device=device)


class LunarLanderContinuousEnv(VecEnv):
    def __init__(self, num_envs: int = 1, seed: int = 0, device: str = 'cpu', **_kwargs):
        super().__init__(make_lunar_lander(True), num_envs=num_envs, seed=seed, device=device)
