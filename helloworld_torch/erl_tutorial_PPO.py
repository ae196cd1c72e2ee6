"""Tutorial: train PPO on Pendulum with the full framework
(mirror of reference ``helloworld/erl_tutorial_PPO.py``),
run on the CUDA card (`Config.device` defaults to it)."""
import sys
import os
sys.path.insert(0, os.path.join(os.path.dirname(__file__), '..'))

from elegantrl_tpu_torch.config import Config
from elegantrl_tpu_torch.agents import AgentPPO
from elegantrl_tpu_torch.envs import PendulumEnv
from elegantrl_tpu_torch.train.runner import train_agent


def train_ppo_for_pendulum():
    env_args = {'env_name': 'Pendulum-v1', 'num_envs': 8, 'max_step': 200,
                'state_dim': 3, 'action_dim': 1, 'if_discrete': False}
    args = Config(AgentPPO, PendulumEnv, env_args)
    args.break_step = int(1e5)
    args.net_dims = (64, 64)
    args.gamma = 0.97
    args.horizon_len = 400
    args.repeat_times = 32
    args.learning_rate = 4e-4
    args.eval_times = 16
    args.eval_per_step = int(1e4)
    return train_agent(args)


if __name__ == '__main__':
    train_ppo_for_pendulum()
