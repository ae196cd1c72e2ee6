"""Tutorial 1 — the helloworld tutorials (DQN, DDPG, PPO), on the card.

The PyTorch counterpart of ``examples/tutorial_helloworld_DQN_DDPG_PPO.py``:
train three algorithm families through ``helloworld_torch``'s tutorials,
which configure the full framework in a few lines each.

Run:  python examples_torch/tutorial_helloworld_DQN_DDPG_PPO.py [dqn|ddpg|ppo|all]

Expected outcomes:
- DQN solves CartPole-v1: avgR climbs past 150 (often to ~300-500)
- DDPG reaches avgR > -200 on Pendulum-v1
- PPO reaches avgR > -400 on Pendulum-v1 with this tiny budget
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                os.pardir))


def tutorial_dqn():
    """Step 1: value-based control on CartPole.

    ``train_agent`` is a plain Python loop over explore/update/evaluate
    (``elegantrl_tpu_torch/train/runner.py``)."""
    from helloworld_torch.erl_tutorial_DQN import train_dqn_for_cartpole
    train_dqn_for_cartpole()


def tutorial_ddpg():
    """Step 2: off-policy continuous control (replay buffer + target nets +
    deterministic actor)."""
    from helloworld_torch.erl_tutorial_DDPG_TD3_SAC import train_for_pendulum
    from elegantrl_tpu_torch.agents import AgentDDPG
    train_for_pendulum(AgentDDPG)


def tutorial_ppo():
    """Step 3: on-policy continuous control (GAE + clipped surrogate)."""
    from helloworld_torch.erl_tutorial_PPO import train_ppo_for_pendulum
    train_ppo_for_pendulum()


if __name__ == '__main__':
    which = sys.argv[1] if len(sys.argv) > 1 else 'all'
    if which in ('dqn', 'all'):
        tutorial_dqn()
    if which in ('ddpg', 'all'):
        tutorial_ddpg()
    if which in ('ppo', 'all'):
        tutorial_ppo()
