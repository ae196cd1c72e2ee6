"""List every environment this framework can train on.

The PyTorch counterpart of ``examples/list_gym_envs.py``.  Prints the
port's native batched env families first (their state is a batch of
tensors on the card, stepped in the fused rollout kernels where a kernel
body exists), then, when gymnasium is importable, the registry ids
reachable through the host-env path (``envs/host_env.py``).

Run:  python examples_torch/list_gym_envs.py
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                os.pardir))

NATIVE = [
    ('Pendulum-v1', 'envs/pendulum.py', 'gymnasium Pendulum-v1 dynamics'),
    ('CartPole-v1', 'envs/cartpole.py', 'discrete control'),
    ('LunarLander-v2 (discrete)', 'envs/lunar_lander.py',
     'dynamics calibrated against Box2D'),
    ('LunarLanderContinuous-v2', 'envs/lunar_lander.py', ''),
    ('HopperSlip-v0', 'envs/hopper.py', 'SLIP locomotion template'),
    ('StockTradingEnv / StockTradingVecEnv', 'envs/stock_trading.py',
     'FinRL-style cash-constrained trading'),
    ('PointChasingEnv (+Vec, +Discrete)', 'envs/point_chasing.py', ''),
    ('PixelPointChasing', 'envs/pixel_chasing.py', '64x64 pixel obs, ConvNet'),
    ('team chasing (continuous + discrete)', 'marl/env.py', 'multi-agent'),
]


def main():
    print('Native batched PyTorch envs (a batch of tensors on the card):')
    for name, path, note in NATIVE:
        suffix = f'  -- {note}' if note else ''
        print(f'  {name:42s} elegantrl_tpu_torch/{path}{suffix}')

    try:
        import gymnasium
        ids = sorted(gymnasium.registry.keys())
    except Exception as exc:
        print(f'\ngymnasium not importable ({exc}); host-env path unavailable')
        return
    print(f'\nHost-env escape hatch (envs/host_env.py) reaches all '
          f'{len(ids)} registered gymnasium envs:')
    for env_id in ids:
        print(f'  {env_id}')


if __name__ == '__main__':
    main()
