"""Tutorial 4 — BipedalWalker-v3 through the host-env path, PyTorch port.

The PyTorch counterpart of ``examples/tutorial_BipedalWalker_v3.py``.
There is no native BipedalWalker here (an articulated Box2D terrain
walker); this shows the general recipe for training on ANY gymnasium env:
``gym_env_def`` wraps a pool of gymnasium envs stepped on the host, while
the agent's forward passes and updates run on the run's device.

Every env step crosses the host boundary, so host envs are for parity and
medium-scale runs, not throughput.  It needs gymnasium and Box2D, which
the card's machine lacks: run it on a host that has them, on the card or
(``args.device = 'cpu'``) on the CPU.

    python examples_torch/tutorial_BipedalWalker_v3.py [quick]

Expected: with the full budget (~3e5 steps) ModSAC's avgR climbs from ~-100
toward 200+ (solved is 300 over 100 episodes).  `quick` just proves the
plumbing.
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                os.pardir))

from elegantrl_tpu_torch.config import Config                     # noqa: E402
from elegantrl_tpu_torch.agents import AgentModSAC                # noqa: E402
from elegantrl_tpu_torch.envs import get_env_args, gym_env_def    # noqa: E402
from elegantrl_tpu_torch.train.runner import train_agent          # noqa: E402


def main(quick=False):
    env = gym_env_def('BipedalWalker-v3')    # version-resolving gym wrapper
    args = Config(AgentModSAC, env, get_env_args(env, num_envs=16))
    args.net_dims = (256, 256)
    args.gamma = 0.98
    args.horizon_len = 64
    args.buffer_size = int(1e5)
    args.batch_size = 256
    args.repeat_times = 0.5
    args.learning_rate = 3e-4
    args.eval_per_step = int(2e4)
    args.eval_times = 8
    args.break_step = int(2e4) if quick else int(3e5)
    args.break_score = 300.0                 # stop early when solved
    return train_agent(args)


if __name__ == '__main__':
    main(quick='quick' in sys.argv)
