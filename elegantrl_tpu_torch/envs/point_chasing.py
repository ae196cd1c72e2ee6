"""Point-chasing pursuit env as batched tensors (counterpart of
``elegantrl_tpu/envs/point_chasing.py``): point 1 (the agent) chases point 0
(a random walker).

    a       <- a / max(||a||, 1)
    v1      <- 0.75 v1 + a;          p1 += 0.01 v1
    v0      <- 0.50 v0 + U[0,1)^dim; p0 += 0.01 v0
    reward  =  prev_distance - distance - 0.02 ||a||
    terminal = distance < dim  or  step == 2^10      (never truncates)

The discrete variant takes an index into the 3^dim action grid: base-3 digit
``d`` of the index maps to {-1, 0, +1} on axis ``d``.  The walker's uniforms
come from the ``gen`` argument of ``step``; :func:`chasing_step` takes them
explicitly (the parity tests hand it the JAX package's draws).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .base import EnvDef, EnvSpec, VecEnv

_MAX_STEP = 2 ** 10
_INIT_DISTANCE = 8.0


class ChasingState(NamedTuple):
    p0: torch.Tensor        # (N, dim) position of the random walker
    v0: torch.Tensor
    p1: torch.Tensor        # (N, dim) position of the chaser (agent)
    v1: torch.Tensor
    distance: torch.Tensor  # (N,) previous-step distance, for the delta reward
    t: torch.Tensor         # (N,) int32


def _make_init(dim: int):
    def init(gen: torch.Generator, num_envs: int, device) -> ChasingState:
        z = torch.randn((2, num_envs, dim), generator=gen, device=device)
        p0, p1 = z[0], z[1] - _INIT_DISTANCE
        zero = torch.zeros((num_envs, dim), device=device)
        distance = torch.sqrt(torch.sum(torch.square(p0 - p1), dim=-1))
        return ChasingState(p0, zero, p1, zero, distance,
                            torch.zeros(num_envs, dtype=torch.int32, device=device))
    return init


def _obs(s: ChasingState) -> torch.Tensor:
    return torch.cat([s.p0, s.v0, s.p1, s.v1], dim=-1)


def chasing_step(s: ChasingState, action: torch.Tensor, u: torch.Tensor):
    """One step with the walker's uniforms ``u (N, dim)`` given."""
    dim = s.p0.shape[-1]
    action_l2 = torch.clamp(torch.sqrt(torch.sum(torch.square(action), dim=-1)), min=1.0)
    action = action / action_l2[..., None]

    v1 = s.v1 * 0.75 + action
    p1 = s.p1 + v1 * 0.01
    v0 = s.v0 * 0.50 + u
    p0 = s.p0 + v0 * 0.01

    distance = torch.sqrt(torch.sum(torch.square(p0 - p1), dim=-1))
    reward = s.distance - distance - action_l2 * 0.02
    t = s.t + 1
    terminal = (distance < dim) | (t >= _MAX_STEP)
    return (ChasingState(p0, v0, p1, v1, distance, t), reward, terminal,
            torch.zeros_like(terminal))


def grid_action(index: torch.Tensor, dim: int) -> torch.Tensor:
    """The 3^dim grid's action for an index: digit d (base 3) -> {-1, 0, +1}."""
    powers = 3 ** torch.arange(dim, device=index.device)
    digits = (index.to(torch.int64)[..., None] // powers) % 3
    return digits.float() - 1.0


def _walker_uniforms(s: ChasingState, gen) -> torch.Tensor:
    return torch.rand(s.p0.shape, generator=gen, device=s.p0.device)


def _step(s: ChasingState, action: torch.Tensor, gen=None):
    return chasing_step(s, action, _walker_uniforms(s, gen))


def make_point_chasing(dim: int = 2) -> EnvDef:
    spec = EnvSpec(env_name='PointChasingVecEnv', num_envs=1, max_step=_MAX_STEP,
                   state_dim=dim * 4, action_dim=dim, if_discrete=False)
    return EnvDef(spec=spec, init=_make_init(dim), obs=_obs, step=_step)


def make_point_chasing_discrete(dim: int = 2) -> EnvDef:
    def step(s: ChasingState, action: torch.Tensor, gen=None):
        return chasing_step(s, grid_action(action, dim), _walker_uniforms(s, gen))

    spec = EnvSpec(env_name='PointChasingDiscreteEnv', num_envs=1, max_step=_MAX_STEP,
                   state_dim=dim * 4, action_dim=3 ** dim, if_discrete=True)
    return EnvDef(spec=spec, init=_make_init(dim), obs=_obs, step=step)


class PointChasingVecEnv(VecEnv):
    def __init__(self, dim: int = 2, env_num: int = 32, num_envs: int = None,
                 seed: int = 0, device: str = None, **_kwargs):
        super().__init__(make_point_chasing(dim), num_envs=num_envs or env_num,
                         seed=seed, device=device)


class PointChasingEnv(PointChasingVecEnv):
    def __init__(self, dim: int = 2, seed: int = 0, device: str = None, **_kwargs):
        super().__init__(dim=dim, env_num=1, seed=seed, device=device)


class PointChasingDiscreteEnv(VecEnv):
    def __init__(self, dim: int = 2, num_envs: int = 1, seed: int = 0,
                 device: str = None, **_kwargs):
        super().__init__(make_point_chasing_discrete(dim), num_envs=num_envs, seed=seed,
                         device=device)
