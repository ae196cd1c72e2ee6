"""Where a training round of the PyTorch port spends its time on the card.

    python scripts/torch_profile_round.py [--rounds 5] [--env pendulum|cartpole|hopper|
        chasing|chasing_discrete] [--agent AgentPPO|AgentDiscretePPO|AgentA2C|AgentDiscreteA2C]
    python scripts/torch_profile_round.py --path td3_hopper|dqn_cartpole|sac_hopper|
        td3_per_hopper|ppo_stock|ppo_stock_4k|ppo_lunar|dqn_lunar [--rounds 5]

Builds a main path (by default PPO on Pendulum-v1; ``--env cartpole --agent
AgentDiscretePPO`` is the discrete one) at 4096 envs, horizon 64, batch
512, repeat 8, net (128, 128), warms it up, then runs ``--rounds`` rounds
under ``torch.profiler`` and prints one JSON line: the host-clock round
time, the device-busy time per round (the sum of kernel durations; one
stream, so kernels do not overlap), the idle share, and the kernels
grouped by name with their count and total time.

``--path`` builds an off-policy main path instead: ``td3_hopper`` (TD3 on
HopperSlip-v0, 1024 envs, horizon 32, ring 4000 rows, batch 1024, repeat 4,
15 updates per round at a full ring), ``dqn_cartpole`` (DQN on CartPole-v1,
64 envs, horizon 64, ring 20,000 rows, batch 128, repeat 1, 156 updates per
round), ``sac_hopper`` (SAC on HopperSlip-v0 at td3_hopper's sizes, 4
critic heads) or ``td3_per_hopper`` (td3_hopper with prioritised replay: the
PER variant of the DDPG/TD3 chunk and the priority tree's ops), net (128,
128), and runs rounds until the ring is full before the profiled ones; or
PPO on StockTradingEnv-v2 at the ``ppo_stock`` recipe's shape (256 envs,
horizon 128, batch 512, repeat 8: the stock rollout kernel, its critic pass
and the fused update) or ``ppo_stock_4k``'s (4096 envs, batch 4096, repeat
64: the autograd update); or the LunarLander recipes: ``ppo_lunar``
(``ppo_lunarlander_cont``: AgentPPO on LunarLanderContinuous-v2, 64 envs,
horizon 256, batch 512, repeat 16: the generic rollout with K11b, K10 and
the fused update at U = 8) and ``dqn_lunar`` (``dqn_lunarlander``: AgentDQN
on LunarLander-v2, 64 envs, horizon 64, ring 30,000 rows, batch 256, repeat
1, explore rate 0.2, net (256, 256): the generic rollout with K11b, K11a
and the DQN chunk at 117 updates per round).  The ring of ``dqn_lunar`` is
filled with transitions drawn on the card from a seed (the round time does
not depend on their values) instead of 469 warm-up rounds.  The line also
holds the count of kernel launches per round by wrapper.
"""

import argparse
import json
import os
import subprocess
import sys
import time
from collections import defaultdict

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


# env key -> (class in elegantrl_tpu_torch.envs, env_name, max_step, S, A, discrete)
ENVS = {'pendulum': ('PendulumEnv', 'Pendulum-v1', 200, 3, 1, False),
        'cartpole': ('CartPoleEnv', 'CartPole-v1', 500, 4, 2, True),
        'hopper': ('HopperEnv', 'HopperSlip-v0', 1000, 6, 2, False),
        'chasing': ('PointChasingVecEnv', 'PointChasingVecEnv', 1024, 8, 2, False),
        'chasing_discrete': ('PointChasingDiscreteEnv', 'PointChasingDiscreteEnv', 1024, 8, 9,
                             True),
        'stock': ('StockTradingVecEnv', 'StockTradingEnv-v2', 1112, 151, 15, False),
        'lunar_cont': ('LunarLanderContinuousEnv', 'LunarLanderContinuous-v2', 1000, 8, 2,
                       False),
        'lunar': ('LunarLanderEnv', 'LunarLander-v2', 1000, 8, 4, True)}
# off-policy main path -> (agent, env key, envs, horizon, ring rows, batch, repeat, lr, gamma)
PATHS = {'td3_hopper': ('AgentTD3', 'hopper', 1024, 32, 4000, 1024, 4.0, 3e-4, 0.99),
         'dqn_cartpole': ('AgentDQN', 'cartpole', 64, 64, 20000, 128, 1.0, 1e-3, 0.99),
         'sac_hopper': ('AgentSAC', 'hopper', 1024, 32, 4000, 1024, 4.0, 3e-4, 0.99),
         'td3_per_hopper': ('AgentTD3', 'hopper', 1024, 32, 4000, 1024, 4.0, 3e-4, 0.99),
         # on-policy (no ring): the ppo_stock and ppo_stock_4k recipes
         'ppo_stock': ('AgentPPO', 'stock', 256, 128, None, 512, 8.0, 2e-4, 0.99),
         'ppo_stock_4k': ('AgentPPO', 'stock', 4096, 128, None, 4096, 64.0, 2e-4, 0.99),
         'ppo_lunar': ('AgentPPO', 'lunar_cont', 64, 256, None, 512, 16.0, 3e-4, 0.99),
         'dqn_lunar': ('AgentDQN', 'lunar', 64, 64, 30000, 256, 1.0, 5e-4, 0.99)}
NET_DIMS = {'dqn_lunar': (256, 256)}


def launch_counters():
    """Every kernel wrapper's launch counter, by name."""
    from elegantrl_tpu_torch.ops import fused_offpolicy_update as fo, fused_rollout as fr
    from elegantrl_tpu_torch.ops import kernels
    from elegantrl_tpu_torch.ops.fused_update import ppo_update
    return {'fused_rollout': fr.rollout, 'critic_values': fr.critic_values,
            'offpolicy_rollout': fr.offpolicy_rollout, 'ppo_update': ppo_update,
            'dqn_update': fo.dqn_chunk, 'ddpg_update': fo.ddpg_chunk, 'sac_update': fo.sac_chunk,
            'gae_vtrace': kernels.gae_vtrace_kernel, 'buffer_gather': kernels.buffer_gather,
            'fused_mlp3': kernels.fused_mlp3}


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument('--rounds', type=int, default=5)
    parser.add_argument('--env', default='pendulum', choices=sorted(ENVS))
    parser.add_argument('--agent', default='AgentPPO')
    parser.add_argument('--path', default=None, choices=sorted(PATHS))
    opts = parser.parse_args()
    if opts.path:
        opts.agent, opts.env, num_envs, horizon, ring, batch, repeat, lr, gamma = PATHS[opts.path]
    else:
        num_envs, horizon, ring, batch, repeat, lr, gamma = 4096, 64, None, 512, 8.0, None, None

    import torch
    from torch.profiler import ProfilerActivity, profile
    from elegantrl_tpu_torch import Config, agents, build_training, envs

    if not torch.cuda.is_available():
        sys.exit('torch_profile_round: needs a CUDA card')
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    env_class, env_name, max_step, state_dim, action_dim, if_discrete = ENVS[opts.env]
    args = Config(getattr(agents, opts.agent), getattr(envs, env_class),
                  {'env_name': env_name, 'num_envs': num_envs, 'max_step': max_step,
                   'state_dim': state_dim, 'action_dim': action_dim,
                   'if_discrete': if_discrete})
    args.horizon_len, args.batch_size, args.repeat_times = horizon, batch, repeat
    args.net_dims, args.random_seed = NET_DIMS.get(opts.path, (128, 128)), 0
    if opts.path:
        args.learning_rate, args.gamma = lr, gamma
        if ring is not None:
            args.buffer_size = ring
        args.if_use_per = opts.path == 'td3_per_hopper'
        if opts.path == 'dqn_lunar':
            args.explore_rate = 0.2
    ctx = build_training(args)
    carry = ctx.carry
    warmup = 3 if ctx.rb is None else -(-ctx.rb.max_size // horizon) + 1
    if opts.path == 'dqn_lunar':
        from chip_smoke import synthetic_ring
        carry = carry._replace(buf_state=synthetic_ring(torch, ctx.rb, carry.buf_state))
        warmup = 2
    t0 = time.perf_counter()
    for _ in range(warmup):
        carry, _ = ctx.round_fn(carry)
    torch.cuda.synchronize()
    warmup_s = time.perf_counter() - t0

    counted = launch_counters()
    before = {k: fn.launches for k, fn in counted.items()}
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(opts.rounds):
            carry, _ = ctx.round_fn(carry)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    launches = {k: (fn.launches - before[k]) / opts.rounds for k, fn in counted.items()
                if fn.launches > before[k]}

    kernels = defaultdict(lambda: [0, 0.0])       # name -> [count, total us]
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            kernels[evt.name][0] += 1
            kernels[evt.name][1] += evt.time_range.elapsed_us()
    busy_ms = sum(v[1] for v in kernels.values()) / 1e3
    top = sorted(kernels.items(), key=lambda kv: -kv[1][1])
    print(json.dumps({
        'device': smi, 'env': env_name, 'agent': opts.agent, 'path': opts.path,
        'envs': num_envs, 'horizon': horizon, 'batch': batch,
        'ring_rows': None if ctx.rb is None else carry.buf_state.size,
        'warmup_rounds': warmup, 'warmup_s': warmup_s, 'rounds': opts.rounds,
        'round_ms_host': wall_ms / opts.rounds,
        'device_busy_ms_per_round': busy_ms / opts.rounds,
        'idle_share': 1.0 - busy_ms / wall_ms,
        'device_events_per_round': sum(v[0] for v in kernels.values()) / opts.rounds,
        'wrapper_launches_per_round': launches,
        'kernels': [{'name': k[:80], 'count_per_round': c / opts.rounds,
                     'ms_per_round': us / 1e3 / opts.rounds} for k, (c, us) in top[:15]],
    }), flush=True)


if __name__ == '__main__':
    main()
