"""Tutorial 5 — creating your own vectorized environment, PyTorch port.

The PyTorch counterpart of ``examples/tutorial_Creating_VecEnv.py``
(itself a port of the reference's ``tutorial_Creating_ChasingVecEnv.ipynb``
flow), written for the port's batched env protocol
(``elegantrl_tpu_torch/envs/base.py``): an env is three functions over the
WHOLE batch, a state NamedTuple of ``(N,)`` tensors; randomness comes from
a ``torch.Generator``; the framework applies the masked auto-reset.  One
definition gives you 1 env or 100k envs on the card.

The example task: a 1-D "reach the target" toy (position + velocity,
acceleration action) built from scratch below, then trained with PPO.

Run:  python examples_torch/tutorial_Creating_VecEnv.py
Expected: avgR rises above -2 within ~3e4 steps (a random policy sits
around -10), printing the eval table along the way.
"""

import os
import sys
from typing import NamedTuple

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                os.pardir))

import torch                                                # noqa: E402

from elegantrl_tpu_torch.config import Config               # noqa: E402
from elegantrl_tpu_torch.agents import AgentPPO             # noqa: E402
from elegantrl_tpu_torch.envs.base import EnvDef, EnvSpec, VecEnv  # noqa: E402
from elegantrl_tpu_torch.train.runner import train_agent    # noqa: E402


# ---- Step 1: the state.  A batch of N instances: every field is an (N,)
# tensor on the run's device.
class ReachState(NamedTuple):
    pos: torch.Tensor      # (N,)
    vel: torch.Tensor      # (N,)
    target: torch.Tensor   # (N,)
    t: torch.Tensor        # (N,) int32


# ---- Step 2: three functions over the batch.
def reach_init(gen: torch.Generator, num_envs: int, device) -> ReachState:
    u = torch.rand((2, num_envs), generator=gen, device=device)
    return ReachState(pos=u[0] * 2.0 - 1.0,
                      vel=torch.zeros(num_envs, device=device),
                      target=u[1] * 4.0 - 2.0,
                      t=torch.zeros(num_envs, dtype=torch.int32, device=device))


def reach_obs(s: ReachState) -> torch.Tensor:
    return torch.stack([s.pos, s.vel, s.target - s.pos], dim=-1)


def reach_step(s: ReachState, action: torch.Tensor, gen: torch.Generator):
    del gen                                   # deterministic dynamics
    acc = torch.clamp(action[:, 0], -1.0, 1.0)
    vel = s.vel * 0.9 + acc * 0.2
    pos = s.pos + vel * 0.1
    dist = torch.abs(s.target - pos)
    reward = -dist * 0.1 + (dist < 0.05).float()
    t = s.t + 1
    terminal = dist < 0.05
    truncate = (t >= 100) & ~terminal
    return ReachState(pos, vel, s.target, t), reward, terminal, truncate


# ---- Step 3: bundle as an EnvDef with the six protocol attributes the
# reference stamps onto every env (config.py:134-135).
def make_reach() -> EnvDef:
    spec = EnvSpec(env_name='Reach1D-v0', num_envs=1, max_step=100,
                   state_dim=3, action_dim=1, if_discrete=False)
    return EnvDef(spec=spec, init=reach_init, obs=reach_obs, step=reach_step)


# Optional: a stateful adapter with gym-style reset()/step() for external
# tooling (the framework itself consumes the EnvDef directly).
class ReachEnv(VecEnv):
    def __init__(self, num_envs: int = 1, seed: int = 0, device: str = None, **_kwargs):
        super().__init__(make_reach(), num_envs=num_envs, seed=seed, device=device)


# ---- Step 4: train on it — nothing else to write.
def main():
    args = Config(AgentPPO, ReachEnv,
                  {'env_name': 'Reach1D-v0', 'num_envs': 32, 'max_step': 100,
                   'state_dim': 3, 'action_dim': 1, 'if_discrete': False})
    args.net_dims = (32, 32)
    args.gamma = 0.95
    args.horizon_len = 100
    args.repeat_times = 16
    args.batch_size = 128
    args.learning_rate = 1e-3
    args.eval_per_step = 6400
    args.eval_times = 16
    args.break_step = int(4e4)
    return train_agent(args)


if __name__ == '__main__':
    main()
