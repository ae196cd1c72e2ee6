"""DDPG / TD3 / SAC / ModSAC on Pendulum (+ PER variant), on the card.

The PyTorch counterpart of ``examples/demo_DDPG_TD3_SAC.py``, with its
hyper-parameters (the reference demo's own recipe,
demo_DDPG_TD3_SAC.py:31-40); ``demo_DDPG_TD3_SAC_with_PER.py`` adds
prioritised replay.

Run: python examples_torch/demo_DDPG_TD3_SAC.py [ddpg|td3|sac|modsac] [per]
"""

import sys

from elegantrl_tpu_torch.config import Config
from elegantrl_tpu_torch.agents import AgentDDPG, AgentModSAC, AgentSAC, AgentTD3
from elegantrl_tpu_torch.envs import PendulumEnv
from elegantrl_tpu_torch.train.runner import train_agent

AGENTS = {'ddpg': AgentDDPG, 'td3': AgentTD3, 'sac': AgentSAC,
          'modsac': AgentModSAC}


def train_for_pendulum(agent_class=AgentModSAC, num_envs: int = 8,
                       if_use_per: bool = False):
    """The reference demo's own recipe (demo_DDPG_TD3_SAC.py:31-40); its
    curves dip until ~1e5 steps.  The port's learning rows on this recipe
    are ``scripts/torch_verify_learning.py``'s ``*_pendulum``."""
    env_args = {'env_name': 'Pendulum-v1', 'num_envs': num_envs,
                'max_step': 200, 'state_dim': 3, 'action_dim': 1,
                'if_discrete': False}
    args = Config(agent_class, PendulumEnv, env_args)
    args.break_step = int(2e5)
    args.net_dims = (64, 64)
    args.gamma = 0.97
    args.horizon_len = 100
    args.buffer_size = int(1e6)
    args.batch_size = 256
    args.repeat_times = 1.0
    args.learning_rate = 5e-4
    args.if_use_per = if_use_per
    args.eval_times = 16
    args.eval_per_step = int(2e4)
    return train_agent(args)


if __name__ == '__main__':
    name = sys.argv[1] if len(sys.argv) > 1 else 'modsac'
    per = len(sys.argv) > 2 and sys.argv[2] == 'per'
    train_for_pendulum(AGENTS[name], if_use_per=per)
