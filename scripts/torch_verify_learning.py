"""Learning checks of the PyTorch port: recipes of
``scripts/verify_learning.py`` trained through
``elegantrl_tpu_torch.train_agent``.

    python scripts/torch_verify_learning.py [--only NAME ...] [--seeds 0 1 2]
                                            [--device cuda|cpu]

Multi-agent (``MARL_ROWS``): ``mappo_chasing``, ``maddpg_chasing``,
``qmix_chasing``, ``vdn_chasing``, ``mappornn_chasing`` and
``qmixrnn_chasing`` on TeamChasing (2 agents, dim 2) through
``elegantrl_tpu_torch.marl``'s trainers at the JAX recipes; targets 3.5,
or 3.0 for the two recurrent rows.

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
- ``ppo_pendulum_bf16``: AgentPPO on Pendulum-v1, 4096 envs, net (128, 64),
  gamma 0.97, horizon 128, repeat 512, lr 1e-3, batch 4096, 3e7 steps, eval
  every 2e6, ``compute_dtype='bfloat16'``; target -120 (``RESULTS.md:22``,
  ``scripts/verify_learning.py:155-160``): the rollout kernel's bf16
  variant with the autograd update in bf16 (the JAX package runs its scan
  under bf16);
- ``ppo_pendulum_4k``: AgentPPO on Pendulum-v1, 4096 envs, net (128, 64),
  gamma 0.97, horizon 128, repeat 512, lr 1e-3, batch 4096, 3e7 steps, eval
  every 2e6; target -120; ``ppo_pendulum_16k``: the same at 16,384 envs,
  repeat 1024, batch 8192, 6e7 steps, eval every 8e6; target -120;
  ``ppo_pendulum_tts``: ``ppo_pendulum_4k`` evaluated every 5e5 steps and
  stopped at -150, its target, the line's ``tts`` the seconds to it
  (``scripts/verify_learning.py:148-152, 326-338``; K1 with the autograd
  update: the JAX package runs its scan at these batches);
- ``discretea2c_cartpole``: AgentDiscreteA2C on CartPole-v1, 16 envs, net
  (64, 64), horizon 128, repeat 8, lr 3e-4, batch 256, 2e5 steps; target
  150 (``:203-208``);
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
  it on XLA ops); ``ensembledqn_cartpole`` (400): AgentEnsembleDQN on the
  DQN recipe (PyTorch rollout and update; ``:199-200``); ``ddpgh_hopper`` and ``sach_hopper`` (1000): the Hopper
  recipe with AgentDDPGHterm and AgentSACHterm (the rollout kernel, a
  PyTorch update); ``ppohterm_hopper`` (2000): the ``ppo_hopper`` recipe
  with AgentPPOHterm, ``h_term_k_step`` 16 (PyTorch rollout and update)
  (``scripts/verify_learning.py:129-131,137-139,247-256,268-277,302-311``).

bf16, host envs and pixels:

- ``ppo_stock_bf16``: the ``ppo_stock`` recipe with ``compute_dtype=
  'bfloat16'`` (target 100.0, with its ``market`` line): K4's bf16
  variants (the stock actor kernel and the critic pass) and the autograd
  update (the JAX package runs its scan under bf16 compute);
- ``ppo_isaac_mock``: AgentPPO through ``make_isaac_env`` on the mock
  VecTask (``envs/isaac.py:mock_vectask``, its tensors on the run's
  device), 64 envs, net (128, 128), horizon 40, batch 512, repeat 32, lr
  1e-3, reward scale 4, gamma 0.95, 3e5 steps, eval every 5e4; target -6.0
  (``examples/plan_Isaac_Gym.py:85-97``, ``RESULTS.md:46``);
- ``pixelppo_chasing``: AgentPixelPPO on PixelChasing-v0, 128 envs, net
  (128,), encoder 128, gamma 0.97, horizon 64, repeat 256, lr 3e-4, batch
  512, 6e6 steps, eval every 2e5, stops at 1.02; target 0.9
  (``scripts/verify_learning.py:186-197``, ``RESULTS.md:25``);
- the ``*_host`` rows (``scripts/verify_learning.py:445-610``): ModSAC on
  gymnasium's Box2D LunarLanderContinuous (``modsac_lander_host``, 150),
  H-term PPO and SAC on MuJoCo Hopper (``ppoh_hopper_mujoco_host``,
  ``sac_hopper_mujoco_host``, 1000), SAC on BipedalWalker (300),
  HalfCheetah and Ant (2000), Walker2d and Humanoid (1500), through
  ``gym_env_def`` and the host-rollout mode.  They need gymnasium (and
  Box2D or mujoco): without it the gym factory's ``ImportError`` stops the
  row.

Population (``scripts/verify_learning.py:398-445``, ``RESULTS.md:48-49``),
through ``parallel/population.py:train_agent_population`` (8 greedy
episodes a member evaluation, the JAX default); the line's ``max_r`` is the
best member's score of the last generation, as the JAX row reads it:

- ``population_ppo``: AgentPPO on Pendulum-v1, 8 members x 128 envs, net
  (64, 64), gamma 0.97, horizon 200, repeat 64 (U = 25), lr 4e-4, batch 512,
  8 generations of 12 rounds; target -200;
- ``population_stock``: AgentPPO on StockTradingEnv-v2, 8 members x 256
  envs, net (128, 128), gamma 0.99, horizon 128, repeat 8 (U = 2), lr 2e-4,
  batch 512, 6 generations of 8 rounds; target 100.0, with ``market``: the
  holding policy's reading on the best member's last evaluation episodes.

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


class Lazy:
    """An env made when its row runs (a host pool, an external sim), not
    when the table is read: a gym row without gymnasium stops at its own
    run with the gym factory's ``ImportError``."""

    def __init__(self, make):
        self.make = make


def isaac_mock():
    from elegantrl_tpu_torch.envs import make_isaac_env
    from elegantrl_tpu_torch.envs.isaac import mock_vectask
    device = RUN_DEVICE[0]
    return make_isaac_env(lambda: mock_vectask(64, device), env_name='MockVecTask-v0')


RUN_DEVICE = ['cuda']   # the --device of the run, where the mock sim keeps its tensors
ISAAC_ARGS = {'env_name': 'MockVecTask-v0', 'num_envs': 64, 'max_step': 40, 'state_dim': 2,
              'action_dim': 2, 'if_discrete': False}

# the *_host rows of scripts/verify_learning.py:445-610: (agent, gym id,
# pool threads, env_args overrides, target, hypers)
_SAC_HOST = dict(net_dims=(256, 256), gamma=0.99, horizon_len=32, repeat_times=2048,
                 learning_rate=3e-4, batch_size=512, buffer_size=int(3.2e4),
                 reward_scale=2 ** -2, eval_per_step=int(5e4), eval_times=4,
                 replay_row_sample=False)
HOST_ROWS = {
    'modsac_lander_host': ('AgentModSAC', 'LunarLanderContinuous-v3', 0, 16, 150.0, dict(
        net_dims=(256, 256), gamma=0.99, horizon_len=64, buffer_size=int(5e4),
        batch_size=1024, repeat_times=1.0, reward_scale=2 ** -1, learning_rate=1e-4,
        eval_per_step=int(2e4), eval_times=8, break_step=int(1.2e6), break_score=200.0)),
    'ppoh_hopper_mujoco_host': ('AgentPPOHterm', 'Hopper-v5', 16, 64, 1000.0, dict(
        net_dims=(128, 128), gamma=0.99, horizon_len=128, repeat_times=320,
        learning_rate=3e-4, batch_size=2048, eval_per_step=int(1e5), eval_times=4,
        break_step=int(6e6), break_score=2500.0)),
    'sac_hopper_mujoco_host': ('AgentSAC', 'Hopper-v5', 16, 64, 1000.0,
                               dict(_SAC_HOST, break_step=int(1.2e6), break_score=1500.0)),
    'sac_bipedal_host': ('AgentSAC', 'BipedalWalker-v3', 16, 64, 300.0,
                         dict(_SAC_HOST, break_step=int(2e6), break_score=301.0)),
    'sac_halfcheetah_mujoco_host': ('AgentSAC', 'HalfCheetah-v5', 16, 64, 2000.0,
                                    dict(_SAC_HOST, break_step=int(1.2e6), break_score=4000.0)),
    'sac_ant_mujoco_host': ('AgentSAC', 'Ant-v5', 16, 64, 2000.0,
                            dict(_SAC_HOST, break_step=int(8e5), break_score=2500.0)),
    'sac_walker_mujoco_host': ('AgentSAC', 'Walker2d-v5', 16, 64, 1500.0,
                               dict(_SAC_HOST, break_step=int(1.2e6), break_score=2500.0)),
    'sac_humanoid_mujoco_host': ('AgentSAC', 'Humanoid-v5', 16, 64, 1500.0,
                                 dict(_SAC_HOST, break_step=int(8e5), break_score=3000.0)),
}


def host_row(name):
    """A ``*_host`` recipe: the gym env made when the row runs."""
    from elegantrl_tpu_torch import agents
    agent, env_id, threads, num_envs, target, hypers = HOST_ROWS[name]

    def make():
        from elegantrl_tpu_torch.envs import gym_env_def
        return gym_env_def(env_id, num_threads=threads)

    return (getattr(agents, agent), Lazy(make), {'num_envs': num_envs}, target, hypers)


# the Pendulum scale recipe (scripts/verify_learning.py:148-152, 326-338):
# 4096 envs, the update count scaled with the env count
PEND_SCALE = dict(net_dims=(128, 64), gamma=0.97, horizon_len=128, repeat_times=512,
                  learning_rate=1e-3, batch_size=4096, eval_per_step=int(2e6),
                  break_step=int(3e7))


def recipes():
    from elegantrl_tpu_torch.agents import (AgentA2C, AgentD3QN, AgentDDPG, AgentDDPGHterm,
                                            AgentDiscreteA2C, AgentDiscretePPO, AgentDoubleDQN,
                                            AgentDQN, AgentDuelingDQN, AgentEmbedDQN,
                                            AgentEnsembleDQN, AgentModSAC, AgentPPO,
                                            AgentPPOHterm, AgentSAC, AgentSACHterm, AgentTD3)
    from elegantrl_tpu_torch.agents import AgentPixelPPO
    from elegantrl_tpu_torch.envs import (CartPoleEnv, HopperEnv, LunarLanderContinuousEnv,
                                          LunarLanderEnv, PendulumEnv, PixelChasingEnv,
                                          StockTradingVecEnv)
    stock = {'env_name': 'StockTradingEnv-v2', 'num_envs': 256, 'max_step': 1112,
             'state_dim': 151, 'action_dim': 15, 'if_discrete': False}
    lunar = {'env_name': 'LunarLander-v2', 'num_envs': 64, 'max_step': 1000, 'state_dim': 8,
             'action_dim': 4, 'if_discrete': True}
    lunar_dqn = dict(net_dims=(256, 256), horizon_len=64, batch_size=256, learning_rate=5e-4,
                     explore_rate=0.2, eval_per_step=int(2e5), break_step=int(8e6))
    ppo_stock = dict(net_dims=(128, 128), gamma=0.99, horizon_len=128, repeat_times=8,
                     learning_rate=2e-4, batch_size=512, eval_per_step=int(4e5),
                     break_step=int(2e6))
    host = {**{name: host_row(name) for name in HOST_ROWS}, 'ppo_isaac_mock': (
        AgentPPO, Lazy(isaac_mock), ISAAC_ARGS, -6.0,
        dict(net_dims=(128, 128), horizon_len=40, batch_size=512, repeat_times=32,
             learning_rate=1e-3, reward_scale=4.0, gamma=0.95, break_step=int(3e5),
             eval_per_step=int(5e4)))}
    return {**host,
        'ppo_stock_bf16': (AgentPPO, StockTradingVecEnv, stock, 100.0,
                           dict(ppo_stock, compute_dtype='bfloat16')),
        'pixelppo_chasing': (
            AgentPixelPPO, PixelChasingEnv,
            {'env_name': 'PixelChasing-v0', 'num_envs': 128, 'max_step': 200,
             'state_dim': (64, 64, 2), 'action_dim': 2, 'if_discrete': False}, 0.9,
            dict(net_dims=(128,), encoder_dim=128, gamma=0.97, horizon_len=64,
                 repeat_times=256, learning_rate=3e-4, batch_size=512,
                 eval_per_step=int(2e5), break_step=int(6e6), break_score=1.02)),
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
        'ppo_stock': (AgentPPO, StockTradingVecEnv, stock, 100.0, ppo_stock),
        'ppo_stock_4k': (
            AgentPPO, StockTradingVecEnv, dict(stock, num_envs=4096), 100.0,
            dict(net_dims=(128, 128), gamma=0.99, horizon_len=128, repeat_times=64,
                 learning_rate=2e-4, batch_size=4096, eval_per_step=int(4e6),
                 break_step=int(2e7))),
        'ppo_pendulum_bf16': (
            AgentPPO, PendulumEnv, dict(PENDULUM, num_envs=4096), -120.0,
            dict(net_dims=(128, 64), gamma=0.97, horizon_len=128, repeat_times=512,
                 learning_rate=1e-3, batch_size=4096, eval_per_step=int(2e6),
                 break_step=int(3e7), compute_dtype='bfloat16')),
        'ensembledqn_cartpole': (AgentEnsembleDQN, CartPoleEnv, CARTPOLE, 400.0, DQN_CART),
        'discretea2c_cartpole': (
            AgentDiscreteA2C, CartPoleEnv, CARTPOLE, 150.0,
            dict(net_dims=(64, 64), horizon_len=128, repeat_times=8, learning_rate=3e-4,
                 batch_size=256, eval_per_step=int(2e4), break_step=int(2e5))),
        'ppo_pendulum_4k': (AgentPPO, PendulumEnv, dict(PENDULUM, num_envs=4096), -120.0,
                            dict(PEND_SCALE)),
        'ppo_pendulum_16k': (AgentPPO, PendulumEnv, dict(PENDULUM, num_envs=16384), -120.0,
                             dict(PEND_SCALE, repeat_times=1024, batch_size=8192,
                                  eval_per_step=int(8e6), break_step=int(6e7))),
        'ppo_pendulum_tts': (AgentPPO, PendulumEnv, dict(PENDULUM, num_envs=4096), -150.0,
                             dict(PEND_SCALE, eval_per_step=int(5e5), break_score=-150.0)),
        'a2c_pendulum': (
            AgentA2C, PendulumEnv,
            {'env_name': 'Pendulum-v1', 'num_envs': 16, 'max_step': 200, 'state_dim': 3,
             'action_dim': 1, 'if_discrete': False}, -250.0,
            dict(net_dims=(64, 64), gamma=0.9, horizon_len=8, repeat_times=1,
                 learning_rate=7e-4, batch_size=8, lambda_gae_adv=1.0, lambda_entropy=0.0,
                 eval_per_step=int(5e4), break_step=int(5e5))),
    }


# name: (agent, env, env_args, target, hypers, population_size, generations, rounds)
POPULATION_ROWS = {
    'population_ppo': ('AgentPPO', 'PendulumEnv', dict(PENDULUM, num_envs=128), -200.0,
                       dict(net_dims=(64, 64), gamma=0.97, horizon_len=200, repeat_times=64,
                            learning_rate=4e-4, batch_size=512), 8, 8, 12),
    'population_stock': ('AgentPPO', 'StockTradingVecEnv',
                         {'env_name': 'StockTradingEnv-v2', 'num_envs': 256, 'max_step': 1112,
                          'state_dim': 151, 'action_dim': 15, 'if_discrete': False}, 100.0,
                         dict(net_dims=(128, 128), gamma=0.99, horizon_len=128, repeat_times=8,
                              learning_rate=2e-4, batch_size=512), 8, 6, 8),
}


def run_population(name, seed, device):
    """One population row: ``(line fields, seconds)``."""
    import numpy as np
    import torch
    from elegantrl_tpu_torch import Config, agents, envs
    from elegantrl_tpu_torch.config import build_env
    from elegantrl_tpu_torch.parallel.population import member_seed, train_agent_population
    from elegantrl_tpu_torch.train.evaluator import make_eval_fn
    agent, env_class, env_args, target, hypers, P, G, R = POPULATION_ROWS[name]
    args = Config(getattr(agents, agent), getattr(envs, env_class), dict(env_args))
    for k, v in hypers.items():
        setattr(args, k, v)
    args.device, args.random_seed = device, seed
    t0 = time.time()
    res = train_agent_population(args, population_size=P, generations=G,
                                 rounds_per_generation=R, verbose=True)
    seconds = time.time() - t0
    history = res['history']
    fields = {'config': name, 'agent': agent, 'env': env_args['env_name'],
              'max_r': float(np.max(history[-1])), 'target': target,
              'curve': [[int((g + 1) * R * args.horizon_len * env_args['num_envs']),
                         round(float(np.max(h)), 2), round(float(np.median(h)), 2)]
                        for g, h in enumerate(history)],
              'steps': int(P * G * R * args.horizon_len * env_args['num_envs'])}
    if env_args['env_name'] == 'StockTradingEnv-v2':   # holding, on the best's last episodes
        env = build_env(args.env_class, args.env_args)._def
        best = int(np.argmax(history[-1]))
        gen = torch.Generator(device=device)
        gen.manual_seed(member_seed(1000 + G - 1, best))
        hold = make_eval_fn(env, lambda s, obs: torch.zeros((obs.shape[0], 15),
                                                            device=obs.device),
                            8, int(args.max_step), torch.device(device))(None, gen)[0]
        fields['market'] = {'hold_last_episodes': float(np.mean(hold))}
    return fields, seconds


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


# The multi-agent rows (``scripts/verify_learning.py:342-395, 618-630``;
# targets ``RESULTS.md:41-45, 47``): TeamChasing with 2 agents in 2
# dimensions, each trainer at its JAX recipe, the score the best of the
# last evaluations (3, or 5 for the QMIX family) of eight evenly spaced
# ones.  (name -> (trainer, discrete env, keyword arguments, evaluations
# counted, steps, target))
MARL_ROWS = {
    'mappo_chasing': ('train_mappo', False, dict(num_envs=64, horizon=64, batch_size=512,
                                                 repeat_times=4, num_rounds=40), 3,
                      40 * 64 * 64, 3.5),
    'maddpg_chasing': ('train_maddpg', False, dict(num_envs=64, num_rounds=120), 3,
                       120 * 64 * 32, 3.5),
    'qmix_chasing': ('train_qmix', True, dict(num_envs=32, horizon=64, num_rounds=240,
                                              mixer='qmix'), 5, 240 * 32 * 64, 3.5),
    'vdn_chasing': ('train_qmix', True, dict(num_envs=32, horizon=64, num_rounds=240,
                                             mixer='vdn'), 5, 240 * 32 * 64, 3.5),
    'mappornn_chasing': ('train_mappo_rnn', False, dict(num_envs=64, horizon=64, seq_batch=16,
                                                        repeat_times=4, num_rounds=40), 3,
                         40 * 64 * 64, 3.0),
    'qmixrnn_chasing': ('train_qmix_rnn', True, dict(num_envs=32, horizon=64, num_rounds=120),
                        5, 120 * 32 * 64, 3.0),
}


def run_marl(name, seed, device):
    """One multi-agent row: ``(line fields, seconds)``.  Its trainer runs
    PyTorch ops on ``device`` (the JAX package runs XLA ops there)."""
    from elegantrl_tpu_torch import marl
    trainer, discrete, kw, last, steps, target = MARL_ROWS[name]
    make = marl.make_team_chasing_discrete if discrete else marl.make_team_chasing
    t0 = time.time()
    _, history = getattr(marl, trainer)(make(num_agents=2, dim=2), seed=seed, verbose=False,
                                        device=device, **kw)
    seconds = time.time() - t0
    return {'config': name, 'agent': name.split('_')[0].upper(), 'env': 'TeamChasing',
            'max_r': float(max(history[-last:])), 'target': target,
            'curve': [round(float(h), 3) for h in history], 'steps': steps}, seconds


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument('--device', default='cuda')
    parser.add_argument('--only', nargs='*', default=None)
    parser.add_argument('--seeds', nargs='*', type=int, default=[0, 1, 2])
    opts = parser.parse_args()

    import torch
    from elegantrl_tpu_torch import Config, get_env_args, train_agent
    from elegantrl_tpu_torch.ops.fused_offpolicy_update import ddpg_chunk, dqn_chunk, sac_chunk
    from elegantrl_tpu_torch.ops.fused_rollout import critic_values, offpolicy_rollout, rollout
    from elegantrl_tpu_torch.ops.fused_update import ppo_update
    from elegantrl_tpu_torch.ops.kernels import buffer_gather_fields, fused_mlp3, gae_vtrace_kernel
    counted = {'fused_rollout': rollout, 'critic_values': critic_values,
               'offpolicy_rollout': offpolicy_rollout, 'ppo_update': ppo_update,
               'dqn_update': dqn_chunk, 'ddpg_update': ddpg_chunk, 'sac_update': sac_chunk,
               'gae_vtrace': gae_vtrace_kernel, 'buffer_gather_fields': buffer_gather_fields,
               'fused_mlp3': fused_mlp3}

    if opts.device == 'cuda':
        device = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                                 '--format=csv,noheader'], capture_output=True,
                                text=True, check=True).stdout.strip().splitlines()[0]
    else:
        device = f'cpu ({torch.get_num_threads()} threads)'
    RUN_DEVICE[0] = opts.device
    table = recipes()
    for name in (opts.only or list(table) + list(POPULATION_ROWS) + list(MARL_ROWS)):
        if name in POPULATION_ROWS or name in MARL_ROWS:
            run = run_population if name in POPULATION_ROWS else run_marl
            for seed in opts.seeds:
                before = {k: fn.launches for k, fn in counted.items()}
                fields, seconds = run(name, seed, opts.device)
                print(json.dumps({**fields, 'device': device, 'seed': seed,
                                  'pass': bool(fields['max_r'] >= fields['target']),
                                  'seconds': round(seconds, 1),
                                  'kernel_launches': {k: fn.launches - before[k]
                                                      for k, fn in counted.items()
                                                      if fn.launches > before[k]}}),
                      flush=True)
            continue
        agent_class, env_class, env_args, target, hypers = table[name]
        for seed in opts.seeds:
            if isinstance(env_class, Lazy):   # a fresh pool or sim for each run
                env = env_class.make()
                env_args = dict(get_env_args(env, env_args['num_envs']), **env_args)
                args = Config(agent_class, env, env_args)
            else:
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
            # time to score: wall seconds to the first evaluation at or above
            # the target (the JAX script's ``tts``)
            tts = next((round(float(t), 1) for r, t in zip(res['recorder'],
                                                           res['recorder_times'])
                        if r[1] >= target), None)
            print(json.dumps({
                'config': name, 'agent': agent_class.__name__, 'env': env_args['env_name'],
                'device': device, 'seed': seed, 'max_r': float(res['max_r']),
                'target': target, 'pass': bool(res['max_r'] >= target), 'tts': tts,
                'curve': [[int(r[0]), round(float(r[1]), 1)] for r in res['recorder']],
                'steps': int(res['total_step']), 'seconds': round(seconds, 1),
                'kernel_launches': {k: fn.launches - before[k] for k, fn in counted.items()
                                    if fn.launches > before[k]}, **extra}),
                flush=True)


if __name__ == '__main__':
    main()
