"""Pendulum-v1 as batched tensors (counterpart of ``elegantrl_tpu/envs/pendulum.py``).

Same dynamics (g=10, m=1, l=1, dt=0.05), torque ``clip(2*action, +-2)``,
reward ``-cost/2``, truncation at 200 steps, never terminal.

The angle wrap here follows the env module's ``%`` form
(``torch.remainder``).  The fused rollout's body
(``ops/fused_rollout.py:PENDULUM_BODY`` and the CUDA kernel) follows the
JAX kernel body's floor form ``y - floor(y/2pi)*2pi``; the two agree to f32
rounding.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from .base import EnvDef, EnvSpec, VecEnv

_G = 10.0
_M = 1.0
_L = 1.0
_DT = 0.05
_MAX_SPEED = 8.0
_MAX_TORQUE = 2.0
_MAX_STEP = 200


class PendulumState(NamedTuple):
    theta: torch.Tensor      # (N,) f32
    theta_dot: torch.Tensor  # (N,) f32
    t: torch.Tensor          # (N,) int32 step counter for truncation


def _wrap_angle(x: torch.Tensor) -> torch.Tensor:
    return torch.remainder(x + math.pi, 2.0 * math.pi) - math.pi


def _init(gen: torch.Generator, num_envs: int, device) -> PendulumState:
    u = torch.rand((2, num_envs), generator=gen, device=device)
    theta = -math.pi + 2.0 * math.pi * u[0]
    theta_dot = -1.0 + 2.0 * u[1]
    return PendulumState(theta, theta_dot,
                         torch.zeros(num_envs, dtype=torch.int32, device=device))


def _obs(s: PendulumState) -> torch.Tensor:
    return torch.stack([torch.cos(s.theta), torch.sin(s.theta), s.theta_dot], dim=-1)


def _step(s: PendulumState, action: torch.Tensor, gen=None):
    u = torch.clamp(action[..., 0] * 2.0, -_MAX_TORQUE, _MAX_TORQUE)
    cost = (torch.square(_wrap_angle(s.theta))
            + 0.1 * torch.square(s.theta_dot)
            + 0.001 * torch.square(u))
    theta_dot = s.theta_dot + (3.0 * _G / (2.0 * _L) * torch.sin(s.theta)
                               + 3.0 / (_M * _L ** 2) * u) * _DT
    theta_dot = torch.clamp(theta_dot, -_MAX_SPEED, _MAX_SPEED)
    theta = s.theta + theta_dot * _DT
    t = s.t + 1
    reward = -cost * 0.5
    truncate = t >= _MAX_STEP
    return PendulumState(theta, theta_dot, t), reward, torch.zeros_like(truncate), truncate


def make_pendulum() -> EnvDef:
    spec = EnvSpec(env_name='Pendulum-v1', num_envs=1, max_step=_MAX_STEP,
                   state_dim=3, action_dim=1, if_discrete=False)
    return EnvDef(spec=spec, init=_init, obs=_obs, step=_step)


class PendulumEnv(VecEnv):
    """Stateful wrapper with the ``reset/step`` protocol."""

    def __init__(self, num_envs: int = 1, seed: int = 0, device: str = None, **_kwargs):
        super().__init__(make_pendulum(), num_envs=num_envs, seed=seed, device=device)
