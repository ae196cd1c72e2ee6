"""Discrete PPO / A2C on CartPole and discrete LunarLander, on the card.

The PyTorch counterpart of ``examples/demo_A2C_PPO_discrete.py``, with its
hyper-parameters.

Run: python examples_torch/demo_A2C_PPO_discrete.py [cartpole|lunar] [a2c]
"""

import sys

from elegantrl_tpu_torch.config import Config
from elegantrl_tpu_torch.agents import AgentDiscreteA2C, AgentDiscretePPO
from elegantrl_tpu_torch.envs import CartPoleEnv, LunarLanderEnv
from elegantrl_tpu_torch.train.runner import train_agent


def train_discrete_ppo_for_cartpole(agent_class=AgentDiscretePPO,
                                    num_envs: int = 32):
    env_args = {'env_name': 'CartPole-v1', 'num_envs': num_envs,
                'max_step': 500, 'state_dim': 4, 'action_dim': 2,
                'if_discrete': True}
    args = Config(agent_class, CartPoleEnv, env_args)
    args.break_step = int(2e5)
    args.net_dims = (64, 64)
    args.horizon_len = 128
    args.repeat_times = 16
    args.learning_rate = 6e-4
    args.batch_size = 256
    args.eval_times = 16
    args.eval_per_step = int(2e4)
    return train_agent(args)


def train_discrete_ppo_for_lunar_lander(agent_class=AgentDiscretePPO,
                                        num_envs: int = 64):
    env_args = {'env_name': 'LunarLander-v2', 'num_envs': num_envs,
                'max_step': 1000, 'state_dim': 8, 'action_dim': 4,
                'if_discrete': True}
    args = Config(agent_class, LunarLanderEnv, env_args)
    args.break_step = int(6e6)
    args.net_dims = (128, 128)
    args.gamma = 0.99
    args.horizon_len = 256
    args.repeat_times = 16
    args.learning_rate = 3e-4
    args.batch_size = 512
    args.lambda_entropy = 0.02
    args.eval_times = 16
    args.eval_per_step = int(4e5)
    return train_agent(args)


if __name__ == '__main__':
    which = sys.argv[1] if len(sys.argv) > 1 else 'cartpole'
    agent = AgentDiscreteA2C if 'a2c' in sys.argv[2:] else AgentDiscretePPO
    if which == 'cartpole':
        train_discrete_ppo_for_cartpole(agent)
    else:
        train_discrete_ppo_for_lunar_lander(agent)
