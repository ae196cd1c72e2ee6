"""PPO / A2C on Pendulum and PointChasing (continuous control), on the card.

The PyTorch counterpart of ``examples/demo_A2C_PPO.py``, with its
hyper-parameters: the reference demo's Pendulum recipe (avgR from ~-1200
toward -80..-240 within 8e4 env steps, reference docstring
demo_A2C_PPO.py:44-53), a throughput recipe of thousands of envs on one
card, and PointChasing.  Every env of a run steps in one batch on the card.

Run: python examples_torch/demo_A2C_PPO.py [ppo|a2c|big|chase]
"""

import sys

from elegantrl_tpu_torch.config import Config
from elegantrl_tpu_torch.agents import AgentA2C, AgentPPO
from elegantrl_tpu_torch.envs import PendulumEnv, PointChasingVecEnv
from elegantrl_tpu_torch.train.runner import train_agent


def train_ppo_a2c_for_pendulum(agent_class=AgentPPO, num_envs: int = 8):
    env_args = {'env_name': 'Pendulum-v1', 'num_envs': num_envs,
                'max_step': 200, 'state_dim': 3, 'action_dim': 1,
                'if_discrete': False}
    args = Config(agent_class, PendulumEnv, env_args)
    args.break_step = int(8e4)
    args.net_dims = (128, 64)
    args.gamma = 0.97
    args.horizon_len = args.max_step * 4
    args.repeat_times = 32
    args.learning_rate = 2e-4
    args.eval_times = 16
    args.eval_per_step = int(1e4)
    return train_agent(args)


def train_ppo_for_pendulum_many_envs(num_envs: int = 4096):
    """Throughput configuration: thousands of envs, one card.

    NOTE on the update-count formula: the reference's
    ``update_times = horizon * repeat_times / batch_size`` ignores num_envs
    (it was designed for <=64 envs), so at 4096 envs ``repeat_times`` must
    scale with the env count or almost no SGD happens per round.  Here
    horizon 128 x repeat 512 / batch 4096 = 16 updates per 0.5M-step round.
    """
    env_args = {'env_name': 'Pendulum-v1', 'num_envs': num_envs,
                'max_step': 200, 'state_dim': 3, 'action_dim': 1,
                'if_discrete': False}
    args = Config(AgentPPO, PendulumEnv, env_args)
    args.break_step = int(3e7)
    args.net_dims = (128, 64)
    args.gamma = 0.97
    args.horizon_len = 128
    args.batch_size = 4096
    args.repeat_times = 512
    args.learning_rate = 1e-3
    args.eval_times = 16
    args.eval_per_step = int(2e6)
    return train_agent(args)


def train_ppo_for_point_chasing(num_envs: int = 64):
    env_args = {'env_name': 'PointChasingVecEnv', 'num_envs': num_envs,
                'max_step': 1024, 'state_dim': 8, 'action_dim': 2,
                'if_discrete': False}
    args = Config(AgentPPO, PointChasingVecEnv, env_args)
    args.break_step = int(4e5)
    args.net_dims = (128, 128)
    args.gamma = 0.985
    args.horizon_len = 256
    args.repeat_times = 16
    args.learning_rate = 4e-4
    args.eval_times = 8
    args.eval_per_step = int(5e4)
    return train_agent(args)


if __name__ == '__main__':
    which = sys.argv[1] if len(sys.argv) > 1 else 'ppo'
    if which == 'ppo':
        train_ppo_a2c_for_pendulum(AgentPPO)
    elif which == 'a2c':
        train_ppo_a2c_for_pendulum(AgentA2C)
    elif which == 'big':
        train_ppo_for_pendulum_many_envs()
    elif which == 'chase':
        train_ppo_for_point_chasing()
