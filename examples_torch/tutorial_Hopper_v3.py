"""Tutorial — Hopper locomotion: native SLIP hopper + optional real MuJoCo, PyTorch port.

The PyTorch counterpart of ``examples/tutorial_Hopper_v3.py`` (the
reference's ``examples/tutorial_Hopper-v3.py`` calls ``gym.make('Hopper-v3')``
and needs mujoco_py).  Two paths:

1. the native SLIP hopper (``envs/hopper.py``) trained on the card at 1024
   vectorized envs in the fused rollout kernel;
2. if the ``mujoco`` package is importable, the REAL ``Hopper-v5`` through
   the host-env path (``envs/gym_parity.py:gym_hopper``), at whatever
   throughput the host sim allows.  The card's machine has no MuJoCo, so
   there this half prints that it is unavailable.

Run:  python examples_torch/tutorial_Hopper_v3.py [quick]
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                os.pardir))

from elegantrl_tpu_torch.config import Config               # noqa: E402
from elegantrl_tpu_torch.agents import AgentPPO             # noqa: E402
from elegantrl_tpu_torch.envs import HopperEnv              # noqa: E402
from elegantrl_tpu_torch.train.runner import train_agent    # noqa: E402


def train_native_hopper(num_envs=1024, break_step=int(1e7)):
    env_args = {'env_name': 'HopperSlip-v0', 'num_envs': num_envs,
                'max_step': 1000, 'state_dim': 6, 'action_dim': 2,
                'if_discrete': False}
    args = Config(AgentPPO, HopperEnv, env_args)
    args.net_dims = (128, 128)
    args.gamma = 0.99
    args.horizon_len = 128
    args.repeat_times = 64
    args.learning_rate = 3e-4
    args.batch_size = 2048
    args.eval_per_step = min(int(1e6), max(break_step // 4, 1))
    args.eval_times = 16
    args.break_step = break_step
    result = train_agent(args)
    print(f"native SLIP hopper: best avgR {result['max_r']:.1f}")
    return result


def train_real_mujoco_hopper(break_step=int(2e5)):
    """The reference tutorial's actual env, through the host-env hatch.
    Requires the ``mujoco`` package (not baked into every image)."""
    try:
        from elegantrl_tpu_torch.envs import gym_hopper
        env = gym_hopper()
    except Exception as exc:  # mujoco/gymnasium missing
        print(f"real MuJoCo Hopper unavailable ({exc}); "
              "the native SLIP path above covers the capability")
        return None
    args = Config(AgentPPO, env, dict(env.spec._asdict()))
    args.net_dims = (128, 128)
    args.gamma = 0.99
    args.horizon_len = 512
    args.repeat_times = 16
    args.learning_rate = 3e-4
    args.batch_size = 256
    args.eval_per_step = int(5e4)
    args.eval_times = 4
    args.break_step = break_step
    result = train_agent(args)
    print(f"real MuJoCo hopper: best avgR {result['max_r']:.1f}")
    return result


if __name__ == '__main__':
    quick = 'quick' in sys.argv
    train_native_hopper(num_envs=16 if quick else 1024,
                        break_step=int(2e5) if quick else int(1e7))
    train_real_mujoco_hopper()
