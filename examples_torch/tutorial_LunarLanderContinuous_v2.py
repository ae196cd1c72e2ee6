"""Tutorial 3 — LunarLanderContinuous: the native lander on the card + real-Box2D transfer, PyTorch port.

The PyTorch counterpart of ``examples/tutorial_LunarLanderContinuous_v2.py``:

1. train PPO on the native lander (``envs/lunar_lander.py``, dynamics
   calibrated against Box2D in observation units — see PARITY.md and
   scripts/physics_parity.py) at 64 vectorized envs on the card;
2. re-evaluate the trained policy on the REAL Box2D physics through the
   host-env path — the cross-sim transfer check.  It needs gymnasium and
   Box2D, which the card's machine lacks: run that half on a host that has
   them (``args.device = 'cpu'`` for the CPU).

Run:  python examples_torch/tutorial_LunarLanderContinuous_v2.py [quick]
Expected: avgR climbs from ~-200 to >150 within ~5e6 steps; the Box2D
re-evaluation prints a comparable mean return.
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                os.pardir))

import numpy as np                                          # noqa: E402
import torch                                                # noqa: E402

from elegantrl_tpu_torch.config import Config, resolve_device   # noqa: E402
from elegantrl_tpu_torch.agents import AgentPPO                   # noqa: E402
from elegantrl_tpu_torch.envs import LunarLanderContinuousEnv     # noqa: E402
from elegantrl_tpu_torch.train.runner import build_training, train_agent  # noqa: E402


def train_native(break_step=int(5e6)):
    env_args = {'env_name': 'LunarLanderContinuous-v2', 'num_envs': 64,
                'max_step': 1000, 'state_dim': 8, 'action_dim': 2,
                'if_discrete': False}
    args = Config(AgentPPO, LunarLanderContinuousEnv, env_args)
    args.net_dims = (128, 128)
    args.gamma = 0.99
    args.horizon_len = 256
    args.repeat_times = 16
    args.batch_size = 512
    args.learning_rate = 3e-4
    args.eval_per_step = int(4e5)
    args.eval_times = 16
    args.break_step = break_step
    result = train_agent(args)
    print(f"native lander: best avgR {result['max_r']:.1f}")
    return args, result


def evaluate_on_box2d(args, result, episodes=16):
    """Cross-sim transfer: the greedy policy trained on the native lander,
    scored on real Box2D (requires gymnasium + Box2D) on ``args.device``."""
    from elegantrl_tpu_torch.envs import gym_lunar_lander_continuous
    from elegantrl_tpu_torch.train.evaluator import make_eval_fn

    ctx = build_training(args)
    env = gym_lunar_lander_continuous()
    device = resolve_device(args)
    eval_fn = make_eval_fn(env, ctx.agent.greedy_action, episodes, 1000, device)
    returns, steps = eval_fn(result['agent_state'],
                             torch.Generator(device=device).manual_seed(7))
    returns = np.asarray(returns)
    print(f"real Box2D re-eval: mean {returns.mean():.1f} "
          f"std {returns.std():.1f} over {episodes} episodes")


if __name__ == '__main__':
    quick = 'quick' in sys.argv
    args, result = train_native(break_step=int(4e5) if quick else int(5e6))
    evaluate_on_box2d(args, result)
