"""H-term DDPG/TD3/SAC entry: the reference's off-policy H-term experiment, on the card.

The PyTorch counterpart of ``examples/plan_DDPG_H.py``: plain vs H-term
off-policy agents on the HopperSlip locomotion task.  All four H-term
agents exist (``elegantrl_tpu_torch/agents/hterm.py``): the
stochastic-policy form adds a return-weighted likelihood of rehearsed
high-return k-step windows to the actor objective; the deterministic form
adds a return-weighted action regression.

Run:  python examples_torch/plan_DDPG_H.py [ddpg|ddpg_h|td3_h|sac_h|modsac_h] [quick]
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                os.pardir))

from elegantrl_tpu_torch.config import Config                       # noqa: E402
from elegantrl_tpu_torch.agents import (                            # noqa: E402
    AgentDDPG, AgentDDPGHterm, AgentTD3Hterm, AgentSACHterm, AgentModSACHterm)
from elegantrl_tpu_torch.envs import HopperEnv                      # noqa: E402
from elegantrl_tpu_torch.train.runner import train_agent            # noqa: E402

AGENTS = {'ddpg': AgentDDPG, 'ddpg_h': AgentDDPGHterm, 'td3_h': AgentTD3Hterm,
          'sac_h': AgentSACHterm, 'modsac_h': AgentModSACHterm}


def demo_offpolicy_h_term(agent_class=AgentDDPGHterm, num_envs: int = 1024,
                          break_step: int = int(6e6)):
    """Same env and scale as the off-policy Hopper learning rows
    (``scripts/torch_verify_learning.py`` td3_hopper / sac_hopper)."""
    env_args = {'env_name': 'HopperSlip-v0', 'num_envs': num_envs,
                'max_step': 1000, 'state_dim': 6, 'action_dim': 2,
                'if_discrete': False}
    args = Config(agent_class, HopperEnv, env_args)
    args.net_dims = (128, 128)
    args.gamma = 0.99
    args.horizon_len = 64
    args.buffer_size = int(2e6)
    args.batch_size = 512
    args.repeat_times = 1.0
    args.learning_rate = 2e-4
    # H-term hypers (surface shared with plan_PPO_H.py:53-57)
    args.h_term_lambda = 2 ** -3
    args.h_term_drop_rate = 2 ** -2
    args.h_term_k_step = 16
    args.eval_per_step = min(int(5e5), max(break_step // 4, 1))
    args.eval_times = 16
    args.break_step = break_step
    result = train_agent(args)
    print(f"{agent_class.__name__}: best avgR {result['max_r']:.1f} "
          f"in {result['used_time']:.0f} s")
    return result


if __name__ == '__main__':
    which = next((a for a in sys.argv[1:] if a in AGENTS), 'ddpg_h')
    quick = 'quick' in sys.argv
    demo_offpolicy_h_term(AGENTS[which],
                          num_envs=16 if quick else 1024,
                          break_step=int(1e5) if quick else int(6e6))
