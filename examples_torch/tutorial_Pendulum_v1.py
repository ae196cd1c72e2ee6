"""Tutorial 2 — Pendulum-v1 end to end with the full framework, on the card.

The PyTorch counterpart of ``examples/tutorial_Pendulum_v1.py``:
configure -> train -> inspect the learning curve -> reload the saved agent
and play greedy episodes.  Each training round is the fused rollout kernel,
the advantage kernel and the fused PPO update on the card; the host loop
only sequences launches and logs.

Run:  python examples_torch/tutorial_Pendulum_v1.py     (the card)

Expected output: the eval table prints avgR rising from ~-1200 toward
-150..-250 by ~1e5 steps; files land in ./Pendulum-v1_PPO_0/
(recorder.npy, LearningCurve.jpg where matplotlib is installed,
actor__*.npz, agent.npz), and the final section replays the saved agent
with per-episode returns.
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                os.pardir))

from elegantrl_tpu_torch.config import Config                    # noqa: E402
from elegantrl_tpu_torch.agents import AgentPPO                  # noqa: E402
from elegantrl_tpu_torch.envs import PendulumEnv                 # noqa: E402
from elegantrl_tpu_torch.train.runner import train_agent, valid_agent  # noqa: E402


def main():
    '''Step 1: describe the env.  The six protocol attributes mirror the
    reference exactly (env_name/num_envs/max_step/state_dim/action_dim/
    if_discrete) — get_gym_env_args(env) prints this dict for any env.'''
    env_args = {'env_name': 'Pendulum-v1', 'num_envs': 16, 'max_step': 200,
                'state_dim': 3, 'action_dim': 1, 'if_discrete': False}

    '''Step 2: configure.  Config carries the same hyper names and defaults
    as the reference; anything extra can be attached as an attribute.'''
    args = Config(AgentPPO, PendulumEnv, env_args)
    args.net_dims = (64, 64)       # MLP hidden sizes, actor and critic
    args.gamma = 0.97              # discount (Pendulum's short horizon)
    args.horizon_len = 400         # env steps collected per round
    args.repeat_times = 32         # SGD epochs over each rollout
    args.batch_size = 128
    args.learning_rate = 4e-4
    args.eval_times = 16           # parallel greedy episodes per eval
    args.eval_per_step = int(2e4)
    args.break_step = int(1.2e5)   # stop after this many env steps

    '''Step 3: train.  One call; all three reference execution modes
    (single-process / multiprocess / multi-GPU) collapse onto this loop:
    pass args.mesh_axes = {'dp': N} to shard the envs across cards.'''
    result = train_agent(args)
    print(f"\nbest avgR {result['max_r']:.1f} after {result['total_step']:.0f} "
          f"steps at {result['steps_per_second']:.0f} env-steps/s")

    '''Step 4: reload the final checkpoint and play greedy episodes
    (the reference's valid_agent/render_agent).'''
    actor_path = os.path.join(args.cwd, 'agent.npz')
    valid_agent(PendulumEnv, env_args, args.net_dims, AgentPPO, actor_path,
                render_times=4, device=args.device)


if __name__ == '__main__':
    main()
