"""CartPole-v1 as batched tensors (counterpart of ``elegantrl_tpu/envs/cartpole.py``).

Classic cart-pole equations, Euler integration with dt = 0.02, force +-10 N
chosen by the discrete action (1 pushes right).  Terminal when ``|x| > 2.4``
or ``|theta| > 12 deg``; truncation at 500 steps when not terminal; reward
1.0 every step.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from .base import EnvDef, EnvSpec, VecEnv

_GRAVITY = 9.8
_M_CART = 1.0
_M_POLE = 0.1
_M_TOTAL = _M_CART + _M_POLE
_L_HALF = 0.5  # half pole length
_POLEMASS_LENGTH = _M_POLE * _L_HALF
_FORCE = 10.0
_DT = 0.02
_THETA_LIMIT = 12.0 * 2.0 * math.pi / 360.0
_X_LIMIT = 2.4
_MAX_STEP = 500


class CartPoleState(NamedTuple):
    x: torch.Tensor          # (N,) f32
    x_dot: torch.Tensor
    theta: torch.Tensor
    theta_dot: torch.Tensor
    t: torch.Tensor          # (N,) int32 step counter


def _init(gen: torch.Generator, num_envs: int, device) -> CartPoleState:
    v = -0.05 + 0.1 * torch.rand((4, num_envs), generator=gen, device=device)
    return CartPoleState(v[0], v[1], v[2], v[3],
                         torch.zeros(num_envs, dtype=torch.int32, device=device))


def _obs(s: CartPoleState) -> torch.Tensor:
    return torch.stack([s.x, s.x_dot, s.theta, s.theta_dot], dim=-1)


def _step(s: CartPoleState, action: torch.Tensor, gen=None):
    force = torch.where(action.to(torch.int32) == 1, _FORCE, -_FORCE)
    cos_t = torch.cos(s.theta)
    sin_t = torch.sin(s.theta)
    temp = (force + _POLEMASS_LENGTH * torch.square(s.theta_dot) * sin_t) / _M_TOTAL
    theta_acc = (_GRAVITY * sin_t - cos_t * temp) / (
        _L_HALF * (4.0 / 3.0 - _M_POLE * torch.square(cos_t) / _M_TOTAL))
    x_acc = temp - _POLEMASS_LENGTH * theta_acc * cos_t / _M_TOTAL

    x = s.x + _DT * s.x_dot
    x_dot = s.x_dot + _DT * x_acc
    theta = s.theta + _DT * s.theta_dot
    theta_dot = s.theta_dot + _DT * theta_acc
    t = s.t + 1

    terminal = (torch.abs(x) > _X_LIMIT) | (torch.abs(theta) > _THETA_LIMIT)
    truncate = (t >= _MAX_STEP) & ~terminal
    reward = torch.ones_like(x)
    return CartPoleState(x, x_dot, theta, theta_dot, t), reward, terminal, truncate


def make_cartpole() -> EnvDef:
    spec = EnvSpec(env_name='CartPole-v1', num_envs=1, max_step=_MAX_STEP,
                   state_dim=4, action_dim=2, if_discrete=True)
    return EnvDef(spec=spec, init=_init, obs=_obs, step=_step)


class CartPoleEnv(VecEnv):
    def __init__(self, num_envs: int = 1, seed: int = 0, device: str = None, **_kwargs):
        super().__init__(make_cartpole(), num_envs=num_envs, seed=seed, device=device)
