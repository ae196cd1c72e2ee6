"""Tutorial: train DQN on CartPole with the full framework
(mirror of reference ``helloworld/erl_tutorial_DQN.py``),
run on the CUDA card (`Config.device` defaults to it)."""
import sys
import os
sys.path.insert(0, os.path.join(os.path.dirname(__file__), '..'))

from elegantrl_tpu_torch.config import Config
from elegantrl_tpu_torch.agents import AgentDQN
from elegantrl_tpu_torch.envs import CartPoleEnv
from elegantrl_tpu_torch.train.runner import train_agent


def train_dqn_for_cartpole():
    env_args = {'env_name': 'CartPole-v1', 'num_envs': 16, 'max_step': 500,
                'state_dim': 4, 'action_dim': 2, 'if_discrete': True}
    args = Config(AgentDQN, CartPoleEnv, env_args)
    args.break_step = int(5e4)
    args.net_dims = (128, 128)
    args.horizon_len = 64
    args.buffer_size = int(5e4)
    args.batch_size = 64
    args.learning_rate = 1e-3
    args.eval_times = 16
    args.eval_per_step = int(8e3)
    return train_agent(args)


if __name__ == '__main__':
    train_dqn_for_cartpole()
