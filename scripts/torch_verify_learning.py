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
- ``ppo_stock``: AgentPPO on StockTradingEnv-v2, 256 envs, net (128, 128),
  gamma 0.99, horizon 128, repeat 8, lr 2e-4, batch 512, 2e6 steps; target
  a max cumulative return of 100.0 (the evaluator reports the env's
  ``cumulative_returns``, 100 x final asset over initial cash); the rollout
  takes the stock body's kernel and the update the fused update kernel;
- ``ppo_stock_4k``: the same at 4096 envs, repeat 64, batch 4096, 2e7
  steps, eval every 4e6; the rollout kernel with an autograd update (batch
  4096 is outside the JAX package's fused update)
  (``scripts/verify_learning.py:170-178, 313-321``);
- ``a2c_pendulum``: AgentA2C on Pendulum-v1, 16 envs, net (64, 64), gamma
  0.9, horizon 8, one pass, lr 7e-4, batch 8, lambda_gae_adv 1, no entropy
  term, 5e5 steps; target -250.  The JAX recipe pins seed 2 because
  unclipped A2C at this recipe is seed-bimodal; here every seed asked for is
  run and reported as it falls.

LunarLander (``scripts/verify_learning.py:161-168, 209-232``; target 150,
the JAX rows ``RESULTS.md:23, 29, 30``):

- ``ppo_lunarlander_cont``: AgentPPO on LunarLanderContinuous-v2, 64 envs,
  net (128, 128), horizon 256, repeat 16, lr 3e-4, batch 512, 5e6 steps,
  eval every 4e5: the generic rollout with K11b, K10 and the fused update
  at U = 8;
- ``dqn_lunarlander`` and ``d3qn_lunarlander``: AgentDQN and AgentD3QN on
  LunarLander-v2, 64 envs, net (256, 256), horizon 64, ring 3e4 (DQN) or
  8e3 (D3QN) rows, batch 256, lr 5e-4, explore rate 0.2, 8e6 steps, eval
  every 2e5: the generic rollout (K11b for DQN's Q net; D3QN's encoder and
  heads run PyTorch ops), K11a under row sampling and the DQN chunk at
  (256, 256).

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
The stock recipes' lines also hold ``market``: what every evaluation would
have read for a holding policy (zero actions, all in the 0.1 dead zone, so
no trade) on the same episodes, and the trained policy's return and share
of actions outside the dead zone on the first evaluation's episodes; a
policy that learned to trade beats holding there.
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
    from elegantrl_tpu_torch.envs import (CartPoleEnv, HopperEnv, LunarLanderContinuousEnv,
                                          LunarLanderEnv, PendulumEnv, StockTradingVecEnv)
    stock = {'env_name': 'StockTradingEnv-v2', 'num_envs': 256, 'max_step': 1112,
             'state_dim': 151, 'action_dim': 15, 'if_discrete': False}
    lunar = {'env_name': 'LunarLander-v2', 'num_envs': 64, 'max_step': 1000, 'state_dim': 8,
             'action_dim': 4, 'if_discrete': True}
    lunar_dqn = dict(net_dims=(256, 256), horizon_len=64, batch_size=256, learning_rate=5e-4,
                     explore_rate=0.2, eval_per_step=int(2e5), break_step=int(8e6))
    return {
        'ppo_lunarlander_cont': (
            AgentPPO, LunarLanderContinuousEnv,
            dict(lunar, env_name='LunarLanderContinuous-v2', action_dim=2, if_discrete=False),
            150.0,
            dict(net_dims=(128, 128), gamma=0.99, horizon_len=256, repeat_times=16,
                 learning_rate=3e-4, batch_size=512, eval_per_step=int(4e5),
                 break_step=int(5e6))),
        'dqn_lunarlander': (AgentDQN, LunarLanderEnv, lunar, 150.0,
                            dict(lunar_dqn, buffer_size=int(3e4))),
        'd3qn_lunarlander': (AgentD3QN, LunarLanderEnv, lunar, 150.0,
                             dict(lunar_dqn, buffer_size=int(8e3))),
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
        'ppo_stock': (
            AgentPPO, StockTradingVecEnv, stock, 100.0,
            dict(net_dims=(128, 128), gamma=0.99, horizon_len=128, repeat_times=8,
                 learning_rate=2e-4, batch_size=512, eval_per_step=int(4e5),
                 break_step=int(2e6))),
        'ppo_stock_4k': (
            AgentPPO, StockTradingVecEnv, dict(stock, num_envs=4096), 100.0,
            dict(net_dims=(128, 128), gamma=0.99, horizon_len=128, repeat_times=64,
                 learning_rate=2e-4, batch_size=4096, eval_per_step=int(4e6),
                 break_step=int(2e7))),
        'a2c_pendulum': (
            AgentA2C, PendulumEnv,
            {'env_name': 'Pendulum-v1', 'num_envs': 16, 'max_step': 200, 'state_dim': 3,
             'action_dim': 1, 'if_discrete': False}, -250.0,
            dict(net_dims=(64, 64), gamma=0.9, horizon_len=8, repeat_times=1,
                 learning_rate=7e-4, batch_size=8, lambda_gae_adv=1.0, lambda_entropy=0.0,
                 eval_per_step=int(5e4), break_step=int(5e5))),
    }


def market_check(args, agent_state, evaluations: int) -> dict:
    """Holding against the trained greedy policy on the evaluator's episodes:
    its generator, seeded as the evaluator seeds it, draws each evaluation's
    episodes in turn (the stock env's draws do not depend on the actions)."""
    import torch
    from elegantrl_tpu_torch.config import build_env
    from elegantrl_tpu_torch.train.evaluator import make_eval_fn
    env = build_env(args.env_class, args.env_args)._def
    make = getattr(args.agent_class, 'make', None) or args.agent_class
    greedy = make(args.net_dims, args.state_dim, args.action_dim, args, buffer=None).greedy_action
    device = agent_state.act_flat.device
    counts = torch.zeros(2, device=device)      # actions outside the dead zone, all actions

    def counted(s, obs):
        a = greedy(s, obs)
        counts[0] += (a.abs() >= 0.1).sum()
        counts[1] += a.numel()
        return a

    def hold(s, obs):
        return torch.zeros((obs.shape[0], args.action_dim), device=obs.device)

    def runs(policy, n):
        fn = make_eval_fn(env, policy, args.eval_times, args.max_step, device)
        gen = torch.Generator(device=device)
        gen.manual_seed(int(args.random_seed) + 1943)
        return [float(fn(agent_state, gen)[0].mean()) for _ in range(n)]

    hold_curve = runs(hold, evaluations)
    policy_first = runs(counted, 1)[0]
    return {'hold_curve': [round(r, 2) for r in hold_curve], 'hold_max': max(hold_curve),
            'first_episodes': {'hold': hold_curve[0], 'policy': policy_first,
                               'policy_trade_share': float(counts[0] / counts[1])}}


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument('--device', default='cuda')
    parser.add_argument('--only', nargs='*', default=None)
    parser.add_argument('--seeds', nargs='*', type=int, default=[0, 1, 2])
    opts = parser.parse_args()

    import torch
    from elegantrl_tpu_torch import Config, train_agent
    from elegantrl_tpu_torch.ops.fused_offpolicy_update import ddpg_chunk, dqn_chunk, sac_chunk
    from elegantrl_tpu_torch.ops.fused_rollout import critic_values, offpolicy_rollout, rollout
    from elegantrl_tpu_torch.ops.fused_update import ppo_update
    from elegantrl_tpu_torch.ops.kernels import buffer_gather, fused_mlp3, gae_vtrace_kernel
    counted = {'fused_rollout': rollout, 'critic_values': critic_values,
               'offpolicy_rollout': offpolicy_rollout, 'ppo_update': ppo_update,
               'dqn_update': dqn_chunk, 'ddpg_update': ddpg_chunk, 'sac_update': sac_chunk,
               'gae_vtrace': gae_vtrace_kernel, 'buffer_gather': buffer_gather,
               'fused_mlp3': fused_mlp3}

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
            extra = {}
            if env_args['env_name'] == 'StockTradingEnv-v2':
                extra['market'] = market_check(args, res['agent_state'], len(res['recorder']))
            print(json.dumps({
                'config': name, 'agent': agent_class.__name__, 'env': env_args['env_name'],
                'device': device, 'seed': seed, 'max_r': float(res['max_r']),
                'target': target, 'pass': bool(res['max_r'] >= target),
                'curve': [[int(r[0]), round(float(r[1]), 1)] for r in res['recorder']],
                'steps': int(res['total_step']), 'seconds': round(seconds, 1),
                'kernel_launches': {k: fn.launches - before[k] for k, fn in counted.items()
                                    if fn.launches > before[k]}, **extra}),
                flush=True)


if __name__ == '__main__':
    main()
