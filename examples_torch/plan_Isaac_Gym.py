"""External massively-parallel sim entry: the reference's Isaac Gym plan, on the card.

The PyTorch counterpart of ``examples/plan_Isaac_Gym.py``: train PPO on an
Isaac Gym vectorized task through the IsaacVecEnv adapter (reference
:20-52 builds ``IsaacVecEnv('Ant', env_num=2**10)``).  Any external batched
simulator with the Isaac VecTask surface (``reset()``/``step()`` over
whole-batch tensors, obs dicts, ``info['time_outs']``) plugs into the
host-rollout training path through ``make_isaac_env``.  With
``isaacgymenvs`` installed, ``load_isaac_task('Ant', env_num=1024)`` builds
the same EnvDef; without it, this demo trains on the port's mock VecTask
(``envs/isaac.py:mock_vectask``, a point-mass reach task) whose tensors
live on the run's device (``args.device``), built at the first reset.

Run:  python examples_torch/plan_Isaac_Gym.py [Ant|mock] [quick]
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                os.pardir))

from elegantrl_tpu_torch.config import Config                 # noqa: E402
from elegantrl_tpu_torch.agents import AgentPPO               # noqa: E402
from elegantrl_tpu_torch.envs import (                        # noqa: E402
    EnvSpec, SimUnavailable, load_isaac_task, make_isaac_env)
from elegantrl_tpu_torch.envs.isaac import mock_vectask       # noqa: E402
from elegantrl_tpu_torch.train.runner import train_agent      # noqa: E402


def plan_isaac(task: str = 'mock', quick: bool = False):
    # real Isaac tasks want thousands of sub-envs (reference plans 2**10);
    # the mock stays at the 64-env calibrated recipe
    num_envs = 64 if (quick or task == 'mock') else 1024
    if task == 'mock':
        # the mock's tensors on the run's device: args is read when the
        # sim is built, at the first reset
        spec = EnvSpec(env_name='MockVecTask-v0', num_envs=num_envs, max_step=40,
                       state_dim=2, action_dim=2, if_discrete=False)
        env = make_isaac_env(lambda: mock_vectask(num_envs, args.device),
                             env_name='MockVecTask-v0', spec=spec)
    else:
        try:
            env = load_isaac_task(task, env_num=num_envs)
        except SimUnavailable as e:
            print(f"| plan_Isaac_Gym: {e}\n| falling back to the mock sim")
            return plan_isaac('mock', quick=quick)
    spec = env.spec
    args = Config(AgentPPO, env, {
        'env_name': spec.env_name, 'num_envs': num_envs,
        'max_step': spec.max_step, 'state_dim': spec.state_dim,
        'action_dim': spec.action_dim, 'if_discrete': spec.if_discrete})
    args.net_dims = (128, 128)
    args.horizon_len = spec.max_step
    args.batch_size = 512
    # the mock reach task needs a high update-to-data ratio + reward scaling
    # (its scripted optimum reads about -2.3, a random policy about -28)
    args.repeat_times = 32
    args.learning_rate = 1e-3
    args.reward_scale = 4.0
    args.gamma = 0.95
    args.break_step = int(2e4 if quick else 3e5)
    args.eval_per_step = int(5e3 if quick else 5e4)
    args.cwd = f'./Isaac_{spec.env_name.replace(":", "_")}_PPO'
    return train_agent(args)


if __name__ == '__main__':
    task_arg = sys.argv[1] if len(sys.argv) > 1 else 'mock'
    quick_arg = 'quick' in sys.argv[2:]
    plan_isaac(task_arg, quick=quick_arg)
