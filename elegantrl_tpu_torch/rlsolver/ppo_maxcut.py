"""PPO on node flips for MaxCut (counterpart of
``elegantrl_tpu/rlsolver/ppo_maxcut.py``).

The env observes the spins ``x in {0,1}^N`` and their flip gains, an action
flips one node, the reward is the cut's change, and an episode truncates
after ``num_steps`` flips.  It is a batched :class:`~..envs.base.EnvDef`
(the cut's change from one adjacency row per env), so the framework's own
``train_agent`` and ``AgentDiscretePPO`` train it: the generic rollout and
the autograd update, as the JAX package runs its scan and autograd update
for a net of one hidden layer, with the V-trace advantages on K10 on the
card.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..envs.base import EnvDef, EnvSpec
from ._draws import as_draws
from .maxcut import MaxCutSimulator


class FlipState(NamedTuple):
    x: torch.Tensor   # (num_envs, N) spins in {0, 1}
    t: torch.Tensor   # (num_envs,) int32 flips so far


def maxcut_flip_env(sim: MaxCutSimulator, num_steps: int, num_envs: int = 1,
                    continuing: bool = True) -> EnvDef:
    """Node-flip MaxCut over the simulator's graph.  Reward: the cut's
    change of the flipped node, ``s_i (adj_i . s)`` with ``s = 2x - 1``.

    ``continuing=True``: the env never ends (each round bootstraps through
    its last obs, and the spins persist), the reference driver's dynamics;
    ``continuing=False``: episodes truncate after ``num_steps`` flips and
    restart from random spins.  Observation: ``concat(x, flip_gains(x))``
    (dim ``2N``), so each action's value is in view of an MLP policy."""
    n = sim.num_nodes
    spec = EnvSpec(env_name='MaxCutFlip', num_envs=num_envs, max_step=num_steps,
                   state_dim=2 * n, action_dim=n, if_discrete=True)

    def init(gen: torch.Generator, num: int, device) -> FlipState:
        x = (torch.rand((num, n), generator=gen, device=device) < 0.5).to(torch.float32)
        return FlipState(x=x, t=torch.zeros(num, dtype=torch.int32, device=device))

    def obs(s: FlipState) -> torch.Tensor:
        return torch.cat([s.x, sim.flip_gains(s.x)], dim=-1)

    def step(s: FlipState, action: torch.Tensor, gen=None):
        a = action.to(torch.int64)
        rows = torch.arange(s.x.shape[0], device=s.x.device)
        signs = 2.0 * s.x - 1.0
        gain = signs[rows, a] * torch.sum(sim.adj[a] * signs, dim=-1)   # the cut's change
        x = s.x.clone()
        x[rows, a] = 1.0 - x[rows, a]
        t = s.t + 1
        terminal = torch.zeros_like(t, dtype=torch.bool)
        truncate = terminal if continuing else t >= num_steps
        return FlipState(x=x, t=t), gain, terminal, truncate

    return EnvDef(spec=spec, init=init, obs=obs, step=step)


def greedy_flip_rollout(sim: MaxCutSimulator, greedy_action, agent_state, xs: torch.Tensor,
                        num_steps: int):
    """The greedy policy flipping from each of ``xs`` for ``num_steps``
    steps; each sim keeps its best configuration ever visited (the start
    counts), so the returned x attains the returned cut.  Returns the best
    sim's ``(cut, x)``."""
    rows = torch.arange(xs.shape[0], device=xs.device)
    best_obj, best_xs = sim.obj(xs), xs
    for _ in range(int(num_steps)):
        a = greedy_action(agent_state, torch.cat([xs, sim.flip_gains(xs)], dim=-1)).long()
        xs = xs.clone()
        xs[rows, a] = 1.0 - xs[rows, a]
        objs = sim.obj(xs)
        better = objs > best_obj
        best_obj = torch.where(better, objs, best_obj)
        best_xs = torch.where(better[:, None], xs, best_xs)
    i = torch.argmax(best_obj)
    return best_obj[i], best_xs[i]


def ppo_maxcut_solve(sim: MaxCutSimulator, seed: int = 0, num_envs: int = 64,
                     num_steps: Optional[int] = None, break_step: int = 200_000,
                     net_dims=(64,), learning_rate: float = 1e-3,
                     lambda_entropy: float = 0.02, cwd: Optional[str] = None,
                     eval_rounds: int = 4, draws=None):
    """Train ``AgentDiscretePPO`` on the episodic flip env on the
    simulator's device, then report the best cut the greedy policy reaches
    from fresh random spins (``'rand_xs'``, one draw an evaluation round,
    from a generator seeded ``seed + 1``) over ``eval_rounds`` rounds.

    The reference driver's hyper-parameters: gamma 0.99, 16 SGD updates a
    round (4 epochs of 4 minibatches of the horizon), a one-flip-per-node
    horizon by default.  Returns ``{'best_cut', 'best_x', 'recorder'}``."""
    from ..agents import AgentDiscretePPO
    from ..agents.ppo import make_ppo
    from ..config import Config
    from ..train.runner import train_agent

    n = sim.num_nodes
    if num_steps is None:
        num_steps = n
    env_def = maxcut_flip_env(sim, num_steps, num_envs=num_envs, continuing=False)
    args = Config(agent_class=AgentDiscretePPO, env_class=env_def,
                  env_args={'env_name': 'MaxCutFlip', 'num_envs': num_envs,
                            'max_step': num_steps, 'state_dim': 2 * n,
                            'action_dim': n, 'if_discrete': True})
    args.device = str(sim.device)
    args.random_seed = seed
    args.net_dims = tuple(net_dims)
    args.learning_rate = learning_rate
    args.gamma = 0.99
    args.horizon_len = num_steps
    args.batch_size = max(64, num_steps * num_envs // 4)
    args.repeat_times = 16.0 * args.batch_size / num_steps   # 16 updates a round
    args.lambda_entropy = lambda_entropy
    args.eval_per_step = max(break_step // 4, num_steps * num_envs)
    args.eval_times = 4
    args.break_step = break_step
    if cwd is not None:
        args.cwd = cwd
    result = train_agent(args)

    agent = make_ppo(args.net_dims, 2 * n, n, args, discrete=True)
    d = as_draws(seed + 1, sim.device, draws)
    best_cut, best_x = -float('inf'), None
    with torch.no_grad():
        for _ in range(int(eval_rounds)):
            obj_r, x_r = greedy_flip_rollout(sim, agent.greedy_action, result['agent_state'],
                                             sim.rand_xs(d, num_envs), num_steps)
            if float(obj_r) > best_cut:
                best_cut, best_x = float(obj_r), x_r
    return {'best_cut': float(best_cut),
            'best_x': None if best_x is None else best_x.cpu().numpy(),
            'recorder': result['recorder']}
