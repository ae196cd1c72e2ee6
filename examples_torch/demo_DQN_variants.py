"""DQN / DoubleDQN / DuelingDQN / D3QN / EmbedDQN / EnsembleDQN on CartPole
and discrete PointChasing, on the card.

The PyTorch counterpart of ``examples/demo_DQN_variants.py``, with its
hyper-parameters.

Run: python examples_torch/demo_DQN_variants.py [dqn|double|duel|d3qn|embed|ensemble|chase]
"""

import sys

from elegantrl_tpu_torch.config import Config
from elegantrl_tpu_torch.agents import (AgentD3QN, AgentDQN, AgentDoubleDQN,
                                  AgentDuelingDQN, AgentEmbedDQN,
                                  AgentEnsembleDQN)
from elegantrl_tpu_torch.envs import CartPoleEnv, PointChasingDiscreteEnv
from elegantrl_tpu_torch.train.runner import train_agent

AGENTS = {'dqn': AgentDQN, 'double': AgentDoubleDQN, 'duel': AgentDuelingDQN,
          'd3qn': AgentD3QN, 'embed': AgentEmbedDQN, 'ensemble': AgentEnsembleDQN}


def train_dqn_for_cartpole(agent_class=AgentDoubleDQN, num_envs: int = 64):
    env_args = {'env_name': 'CartPole-v1', 'num_envs': num_envs,
                'max_step': 500, 'state_dim': 4, 'action_dim': 2,
                'if_discrete': True}
    args = Config(agent_class, CartPoleEnv, env_args)
    args.break_step = int(2e5)
    args.net_dims = (128, 64)
    args.gamma = 0.99
    args.horizon_len = 64
    args.buffer_size = int(2e5)
    args.batch_size = 256
    args.learning_rate = 1e-3
    args.explore_rate = 0.1
    args.eval_times = 16
    args.eval_per_step = int(2e4)
    return train_agent(args)


def train_dqn_for_point_chasing(agent_class=AgentD3QN, num_envs: int = 64):
    env_args = {'env_name': 'PointChasingDiscreteEnv', 'num_envs': num_envs,
                'max_step': 1024, 'state_dim': 8, 'action_dim': 9,
                'if_discrete': True}
    args = Config(agent_class, PointChasingDiscreteEnv, env_args)
    args.break_step = int(4e5)
    args.net_dims = (128, 128)
    args.gamma = 0.985
    args.horizon_len = 64
    args.buffer_size = int(4e5)
    args.batch_size = 256
    args.learning_rate = 5e-4
    args.eval_times = 8
    args.eval_per_step = int(5e4)
    return train_agent(args)


if __name__ == '__main__':
    name = sys.argv[1] if len(sys.argv) > 1 else 'double'
    if name == 'chase':
        train_dqn_for_point_chasing()
    else:
        train_dqn_for_cartpole(AGENTS[name])
