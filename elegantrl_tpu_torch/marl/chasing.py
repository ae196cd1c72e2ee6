"""Cooperative team chasing: M chasers corner one random walker
(counterpart of ``elegantrl_tpu/marl/chasing.py``).

The shared team reward is the decrease of the closest chaser's distance
minus the action costs; an episode ends when a chaser comes within the
capture radius or at ``_MAX_STEP``.  Batched over envs (leading axis).
Draws, from ``gen`` or injected (``noise=``): at init the walker's normal
position ``(N, dim)`` and the chasers' ``(N, M, dim)`` (each offset by
``-_INIT_DISTANCE``), at each step the walker's uniform kick ``(N, dim)``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .env import MultiAgentEnvDef

_MAX_STEP = 256
_INIT_DISTANCE = 6.0


class TeamChaseState(NamedTuple):
    target_p: torch.Tensor   # (N, dim)
    target_v: torch.Tensor   # (N, dim)
    chaser_p: torch.Tensor   # (N, M, dim)
    chaser_v: torch.Tensor   # (N, M, dim)
    min_dist: torch.Tensor   # (N,)
    t: torch.Tensor          # (N,) int32


def make_team_chasing(num_agents: int = 3, dim: int = 2) -> MultiAgentEnvDef:
    capture_radius = float(dim)
    M = num_agents

    def init(gen, num_envs: int, device=None, noise=None) -> TeamChaseState:
        """``noise``: ``(z_target (N, dim), z_chaser (N, M, dim))`` normals."""
        if noise is None:
            device = gen.device if device is None else device
            noise = (torch.randn((num_envs, dim), generator=gen, device=device),
                     torch.randn((num_envs, M, dim), generator=gen, device=device))
        target_p, z_chaser = noise
        chaser_p = z_chaser - _INIT_DISTANCE
        min_dist = torch.linalg.norm(target_p[:, None] - chaser_p, dim=-1).amin(-1)
        zeros = torch.zeros_like
        return TeamChaseState(target_p, zeros(target_p), chaser_p, zeros(chaser_p), min_dist,
                              torch.zeros(target_p.shape[0], dtype=torch.int32,
                                          device=target_p.device))

    def obs(s: TeamChaseState) -> torch.Tensor:
        """Per agent: own p, own v, the walker's relative p, its v, the team
        centre's relative p: ``(N, M, 5 dim)``."""
        rel_target = s.target_p[:, None] - s.chaser_p
        rel_team = s.chaser_p.mean(dim=1, keepdim=True) - s.chaser_p
        return torch.cat([s.chaser_p, s.chaser_v, rel_target,
                          s.target_v[:, None].expand(-1, M, -1), rel_team], dim=-1)

    def global_state(s: TeamChaseState) -> torch.Tensor:
        n = s.target_p.shape[0]
        return torch.cat([s.target_p, s.target_v, s.chaser_p.reshape(n, -1),
                          s.chaser_v.reshape(n, -1)], dim=-1)

    def step(s: TeamChaseState, actions, gen=None, noise=None):
        """``noise``: the walker's ``(N, dim)`` uniforms."""
        if noise is None:
            noise = torch.rand(s.target_p.shape, generator=gen, device=s.target_p.device)
        a_norm = torch.clamp(torch.linalg.norm(actions, dim=-1, keepdim=True), min=1.0)
        a = actions / a_norm
        chaser_v = s.chaser_v * 0.75 + a
        chaser_p = s.chaser_p + chaser_v * 0.02
        target_v = s.target_v * 0.5 + noise
        target_p = s.target_p + target_v * 0.02
        min_dist = torch.linalg.norm(target_p[:, None] - chaser_p, dim=-1).amin(-1)
        reward = s.min_dist - min_dist - 0.01 * a_norm[..., 0].mean(-1)
        t = s.t + 1
        terminal = (min_dist < capture_radius) | (t >= _MAX_STEP)
        return (TeamChaseState(target_p, target_v, chaser_p, chaser_v, min_dist, t),
                reward, terminal, torch.zeros_like(terminal))

    return MultiAgentEnvDef(
        env_name='TeamChasingEnv', num_agents=M, obs_dim=5 * dim,
        state_dim=2 * dim + 2 * M * dim, action_dim=dim, if_discrete=False,
        max_step=_MAX_STEP, init=init, obs=obs, global_state=global_state, step=step)


def make_team_chasing_discrete(num_agents: int = 3, dim: int = 2) -> MultiAgentEnvDef:
    """Discrete actions: each agent's index in a 3^dim grid, its base-3
    digits mapped to {-1, 0, +1} (as the single-agent
    PointChasingDiscreteEnv)."""
    cont = make_team_chasing(num_agents, dim)

    def step(s, actions, gen=None, noise=None):
        powers = 3 ** torch.arange(dim, device=actions.device)
        digits = (actions.long()[..., None] // powers) % 3
        return cont.step(s, digits.float() - 1.0, gen, noise)

    return cont._replace(env_name='TeamChasingDiscreteEnv', action_dim=3 ** dim,
                         if_discrete=True, step=step)
