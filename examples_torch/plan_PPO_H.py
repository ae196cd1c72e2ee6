"""H-term PPO entry: the reference's headline "PPO + H-term" experiment, on the card.

The PyTorch counterpart of ``examples/plan_PPO_H.py``: AgentPPO vs
AgentPPOHterm on HopperSlip with the H-term hypers
``h_term_lambda/drop_rate/k_step`` (reference :53-57).  The port's learning
row on this recipe is ``ppohterm_hopper``
(``scripts/torch_verify_learning.py``).

Run:  python examples_torch/plan_PPO_H.py [ppo|hterm] [quick]
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                os.pardir))

from elegantrl_tpu_torch.config import Config                      # noqa: E402
from elegantrl_tpu_torch.agents import AgentPPO, AgentPPOHterm     # noqa: E402
from elegantrl_tpu_torch.envs import HopperEnv                     # noqa: E402
from elegantrl_tpu_torch.train.runner import train_agent           # noqa: E402


def demo_ppo_h_term(agent_class=AgentPPOHterm, num_envs: int = 1024,
                    break_step: int = int(1.5e7)):
    """The ``ppohterm_hopper`` learning recipe."""
    env_args = {'env_name': 'HopperSlip-v0', 'num_envs': num_envs,
                'max_step': 1000, 'state_dim': 6, 'action_dim': 2,
                'if_discrete': False}
    args = Config(agent_class, HopperEnv, env_args)
    args.net_dims = (128, 128)
    args.gamma = 0.99
    args.horizon_len = 128
    args.repeat_times = 128
    args.learning_rate = 3e-4
    args.batch_size = 2048
    args.lambda_gae_adv = 0.95
    # H-term hypers (names/defaults per the reference entry, plan_PPO_H.py:53-57)
    args.h_term_lambda = 2 ** -3
    args.h_term_drop_rate = 2 ** -2
    args.h_term_k_step = 16
    # eval cadence also bounds the host dispatch chunk — keep it below
    # break_step or the loop overruns the budget by one chunk
    args.eval_per_step = min(int(1e6), max(break_step // 4, 1))
    args.eval_times = 16
    args.break_step = break_step
    result = train_agent(args)
    print(f"{agent_class.__name__}: best avgR {result['max_r']:.1f} "
          f"in {result['used_time']:.0f} s")
    return result


if __name__ == '__main__':
    which = sys.argv[1] if len(sys.argv) > 1 else 'hterm'
    quick = 'quick' in sys.argv
    demo_ppo_h_term(AgentPPO if which == 'ppo' else AgentPPOHterm,
                    num_envs=16 if quick else 1024,
                    break_step=int(2e5) if quick else int(1.5e7))
