"""Learning checks of the PyTorch port: recipes of
``scripts/verify_learning.py`` trained through
``elegantrl_tpu_torch.train_agent``.

    python scripts/torch_verify_learning.py [--only NAME ...] [--seeds 0 1 2]
                                            [--device cuda|cpu]

On-policy:

- ``discreteppo_cartpole``: AgentDiscretePPO on CartPole-v1, 16 envs, net
  (64, 64), horizon 128, repeat 16, lr 6e-4, batch 256, 4e5 steps, stops at
  450; target max avgR >= 400;
- ``ppo_hopper``: AgentPPO on HopperSlip-v0, 1024 envs, net (128, 128),
  horizon 128, repeat 128, lr 3e-4, batch 2048, 1.5e7 steps; target 2000;
- ``a2c_pendulum``: AgentA2C on Pendulum-v1, 16 envs, net (64, 64), gamma
  0.9, horizon 8, one pass, lr 7e-4, batch 8, lambda_gae_adv 1, no entropy
  term, 5e5 steps; target -250.  The JAX recipe pins seed 2 because
  unclipped A2C at this recipe is seed-bimodal; here every seed asked for is
  run and reported as it falls.

Off-policy (``scripts/verify_learning.py:97-103,125-136,199-200,234-287``):

- ``td3_pendulum`` (target -150) and ``ddpg_pendulum`` (-200): 8 envs, net
  (64, 64), gamma 0.97, horizon 100, buffer 1e6, batch 256, repeat 1, lr
  5e-4, 2e5 steps;
- ``td3_hopper`` and ``ddpg_hopper`` (1000): HopperSlip-v0, 1024 envs, net
  (128, 128), gamma 0.99, horizon 32, buffer 4e3, batch 1024, repeat 4, lr
  3e-4, 6e6 steps;
- ``dqn_cartpole``, ``doubledqn_cartpole``, ``duelingdqn_cartpole`` and
  ``d3qn_cartpole`` (300): CartPole-v1, 16 envs, net (128, 128), horizon 64,
  buffer 2e5, batch 64, lr 1e-3, 2e5 steps.  Batch 64 is outside the JAX
  package's DQN chunk, so the update is PyTorch autograd; the rollout is the
  fused kernel;
- ``dqn_cartpole_b128``: the DQN recipe at batch 128, where the update is
  the fused DQN chunk;
- ``sac_pendulum`` and ``modsac_pendulum`` (-200): the Pendulum recipe above
  (batch 256 at (64, 64): the fused SAC chunk; E = 4 for SAC, 8 for
  ModSAC); ``sac_hopper`` (1000): the Hopper recipe above with SAC (E = 4)
  (``scripts/verify_learning.py:97-100,132-133,257-266``);
- ``td3_pendulum_per`` (-150): ``td3_pendulum`` with prioritised replay,
  ``per_alpha`` 0.6, ``per_beta`` 0.4 (the PER variant of the DDPG/TD3
  chunk); ``embeddqn_cartpole`` (300): AgentEmbedDQN on the DQN recipe at lr
  5e-4 and 5e5 steps (PyTorch rollout and update, as the JAX package runs
  it on XLA ops); ``ddpgh_hopper`` and ``sach_hopper`` (1000): the Hopper
  recipe with AgentDDPGHterm and AgentSACHterm (the rollout kernel, a
  PyTorch update); ``ppohterm_hopper`` (2000): the ``ppo_hopper`` recipe
  with AgentPPOHterm, ``h_term_k_step`` 16 (PyTorch rollout and update)
  (``scripts/verify_learning.py:129-131,137-139,247-256,268-277,302-311``).

Evaluation is over 16 greedy episodes, as the JAX script's.  Prints one JSON
line per (recipe, seed) with the result, the device and the kernel launches.
"""

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


PENDULUM = {'env_name': 'Pendulum-v1', 'num_envs': 8, 'max_step': 200, 'state_dim': 3,
            'action_dim': 1, 'if_discrete': False}
HOPPER = {'env_name': 'HopperSlip-v0', 'num_envs': 1024, 'max_step': 1000, 'state_dim': 6,
          'action_dim': 2, 'if_discrete': False}
CARTPOLE = {'env_name': 'CartPole-v1', 'num_envs': 16, 'max_step': 500, 'state_dim': 4,
            'action_dim': 2, 'if_discrete': True}
OFFPOL_PEND = dict(net_dims=(64, 64), gamma=0.97, horizon_len=100, buffer_size=int(1e6),
                   batch_size=256, repeat_times=1.0, learning_rate=5e-4,
                   eval_per_step=int(2e4), break_step=int(2e5))
OFFPOL_HOP = dict(net_dims=(128, 128), gamma=0.99, horizon_len=32, buffer_size=int(4e3),
                  batch_size=1024, repeat_times=4.0, learning_rate=3e-4,
                  eval_per_step=int(4e5), break_step=int(6e6))
DQN_CART = dict(net_dims=(128, 128), horizon_len=64, buffer_size=int(2e5), batch_size=64,
                learning_rate=1e-3, eval_per_step=int(2e4), break_step=int(2e5))


def recipes():
    from elegantrl_tpu_torch.agents import (AgentA2C, AgentD3QN, AgentDDPG, AgentDDPGHterm,
                                            AgentDiscretePPO, AgentDoubleDQN, AgentDQN,
                                            AgentDuelingDQN, AgentEmbedDQN, AgentModSAC,
                                            AgentPPO, AgentPPOHterm, AgentSAC, AgentSACHterm,
                                            AgentTD3)
    from elegantrl_tpu_torch.envs import CartPoleEnv, HopperEnv, PendulumEnv
    return {
        'td3_pendulum': (AgentTD3, PendulumEnv, PENDULUM, -150.0, OFFPOL_PEND),
        'ddpg_pendulum': (AgentDDPG, PendulumEnv, PENDULUM, -200.0, OFFPOL_PEND),
        'td3_hopper': (AgentTD3, HopperEnv, HOPPER, 1000.0, OFFPOL_HOP),
        'ddpg_hopper': (AgentDDPG, HopperEnv, HOPPER, 1000.0, OFFPOL_HOP),
        'sac_pendulum': (AgentSAC, PendulumEnv, PENDULUM, -200.0, OFFPOL_PEND),
        'modsac_pendulum': (AgentModSAC, PendulumEnv, PENDULUM, -200.0, OFFPOL_PEND),
        'sac_hopper': (AgentSAC, HopperEnv, HOPPER, 1000.0, OFFPOL_HOP),
        'td3_pendulum_per': (AgentTD3, PendulumEnv, PENDULUM, -150.0,
                             dict(OFFPOL_PEND, if_use_per=True, per_alpha=0.6, per_beta=0.4)),
        'embeddqn_cartpole': (AgentEmbedDQN, CartPoleEnv, CARTPOLE, 300.0,
                              dict(DQN_CART, learning_rate=5e-4, break_step=int(5e5))),
        'ddpgh_hopper': (AgentDDPGHterm, HopperEnv, HOPPER, 1000.0, OFFPOL_HOP),
        'sach_hopper': (AgentSACHterm, HopperEnv, HOPPER, 1000.0, OFFPOL_HOP),
        'ppohterm_hopper': (
            AgentPPOHterm, HopperEnv, HOPPER, 2000.0,
            dict(net_dims=(128, 128), gamma=0.99, horizon_len=128, repeat_times=128,
                 learning_rate=3e-4, batch_size=2048, eval_per_step=int(1e6),
                 break_step=int(1.5e7), h_term_k_step=16)),
        'dqn_cartpole': (AgentDQN, CartPoleEnv, CARTPOLE, 300.0, DQN_CART),
        'doubledqn_cartpole': (AgentDoubleDQN, CartPoleEnv, CARTPOLE, 300.0, DQN_CART),
        'duelingdqn_cartpole': (AgentDuelingDQN, CartPoleEnv, CARTPOLE, 300.0, DQN_CART),
        'd3qn_cartpole': (AgentD3QN, CartPoleEnv, CARTPOLE, 300.0, DQN_CART),
        'dqn_cartpole_b128': (AgentDQN, CartPoleEnv, CARTPOLE, 300.0,
                              dict(DQN_CART, batch_size=128)),
        'discreteppo_cartpole': (
            AgentDiscretePPO, CartPoleEnv,
            {'env_name': 'CartPole-v1', 'num_envs': 16, 'max_step': 500, 'state_dim': 4,
             'action_dim': 2, 'if_discrete': True}, 400.0,
            dict(net_dims=(64, 64), horizon_len=128, repeat_times=16, learning_rate=6e-4,
                 batch_size=256, eval_per_step=int(2e4), break_step=int(4e5),
                 break_score=450.0)),
        'ppo_hopper': (
            AgentPPO, HopperEnv,
            {'env_name': 'HopperSlip-v0', 'num_envs': 1024, 'max_step': 1000, 'state_dim': 6,
             'action_dim': 2, 'if_discrete': False}, 2000.0,
            dict(net_dims=(128, 128), gamma=0.99, horizon_len=128, repeat_times=128,
                 learning_rate=3e-4, batch_size=2048, eval_per_step=int(1e6),
                 break_step=int(1.5e7))),
        'a2c_pendulum': (
            AgentA2C, PendulumEnv,
            {'env_name': 'Pendulum-v1', 'num_envs': 16, 'max_step': 200, 'state_dim': 3,
             'action_dim': 1, 'if_discrete': False}, -250.0,
            dict(net_dims=(64, 64), gamma=0.9, horizon_len=8, repeat_times=1,
                 learning_rate=7e-4, batch_size=8, lambda_gae_adv=1.0, lambda_entropy=0.0,
                 eval_per_step=int(5e4), break_step=int(5e5))),
    }


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument('--device', default='cuda')
    parser.add_argument('--only', nargs='*', default=None)
    parser.add_argument('--seeds', nargs='*', type=int, default=[0, 1, 2])
    opts = parser.parse_args()

    import torch
    from elegantrl_tpu_torch import Config, train_agent
    from elegantrl_tpu_torch.ops.fused_offpolicy_update import ddpg_chunk, dqn_chunk, sac_chunk
    from elegantrl_tpu_torch.ops.fused_rollout import offpolicy_rollout, rollout
    from elegantrl_tpu_torch.ops.fused_update import ppo_update
    counted = {'fused_rollout': rollout, 'offpolicy_rollout': offpolicy_rollout,
               'ppo_update': ppo_update, 'dqn_update': dqn_chunk, 'ddpg_update': ddpg_chunk,
               'sac_update': sac_chunk}

    if opts.device == 'cuda':
        device = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                                 '--format=csv,noheader'], capture_output=True,
                                text=True, check=True).stdout.strip().splitlines()[0]
    else:
        device = f'cpu ({torch.get_num_threads()} threads)'
    table = recipes()
    for name in (opts.only or list(table)):
        agent_class, env_class, env_args, target, hypers = table[name]
        for seed in opts.seeds:
            args = Config(agent_class, env_class, dict(env_args))
            for k, v in hypers.items():
                setattr(args, k, v)
            args.device, args.random_seed, args.eval_times = opts.device, seed, 16
            before = {k: fn.launches for k, fn in counted.items()}
            with tempfile.TemporaryDirectory() as cwd:
                args.cwd = cwd
                t0 = time.time()
                res = train_agent(args)
                seconds = time.time() - t0
            print(json.dumps({
                'config': name, 'agent': agent_class.__name__, 'env': env_args['env_name'],
                'device': device, 'seed': seed, 'max_r': float(res['max_r']),
                'target': target, 'pass': bool(res['max_r'] >= target),
                'curve': [[int(r[0]), round(float(r[1]), 1)] for r in res['recorder']],
                'steps': int(res['total_step']), 'seconds': round(seconds, 1),
                'kernel_launches': {k: fn.launches - before[k] for k, fn in counted.items()
                                    if fn.launches > before[k]}}),
                flush=True)


if __name__ == '__main__':
    main()
