"""DDPG / TD3 / SAC / ModSAC with Prioritized Experience Replay, on the card.

The PyTorch counterpart of ``examples/demo_DDPG_TD3_SAC_with_PER.py``
(if_use_per=True on the sibling demo's recipe).  The priorities live in
the fanout-256 segment tree of ``elegantrl_tpu_torch/ops/per.py``; the
port's learning row is ``td3_pendulum_per``
(``scripts/torch_verify_learning.py``).

Run: python examples_torch/demo_DDPG_TD3_SAC_with_PER.py [ddpg|td3|sac|modsac]
"""

import sys

from demo_DDPG_TD3_SAC import AGENTS, train_for_pendulum


def train_with_per(agent_class, num_envs: int = 8):
    return train_for_pendulum(agent_class, num_envs=num_envs,
                              if_use_per=True)


if __name__ == '__main__':
    name = sys.argv[1] if len(sys.argv) > 1 else 'td3'
    train_with_per(AGENTS[name])
