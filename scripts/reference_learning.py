"""Run a learning recipe of ``scripts/verify_learning.py`` through the JAX
package, with hyper-parameters overridden and several seeds, so a learning
check of the PyTorch port (``scripts/torch_verify_learning.py``) can be held
against the reference on the same recipe.

    JAX_PLATFORMS=cpu python scripts/reference_learning.py dqn_cartpole \\
        --set batch_size=128 --seeds 0 1 2

Prints one JSON line per seed: the recipe, the overrides, the JAX platform,
max avgR over 16 greedy episodes against the recipe's target, the curve and
the wall time.
"""

import argparse
import ast
import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument('name')
    parser.add_argument('--set', nargs='*', default=[], metavar='KEY=VALUE')
    parser.add_argument('--seeds', nargs='*', type=int, default=[0])
    opts = parser.parse_args()
    sys.argv = sys.argv[:1]          # verify_learning reads sys.argv at import

    import jax
    from elegantrl_tpu import Config, train_agent
    from scripts.verify_learning import CONFIGS

    agent_class, env_kw, target, hp = CONFIGS[opts.name]
    overrides = {k: ast.literal_eval(v) for k, v in (s.split('=', 1) for s in opts.set)}
    for seed in opts.seeds:
        args = Config(agent_class, env_kw['env_class'], dict(env_kw['env_args']))
        for k, v in {**hp, **overrides}.items():
            setattr(args, k, v)
        args.random_seed, args.eval_times = seed, 16
        with tempfile.TemporaryDirectory() as cwd:
            args.cwd = cwd
            t0 = time.time()
            res = train_agent(args)
            seconds = time.time() - t0
        print(json.dumps({
            'config': opts.name, 'overrides': overrides, 'package': 'elegantrl_tpu',
            'platform': jax.devices()[0].platform, 'seed': seed,
            'max_r': float(res['max_r']), 'target': target,
            'pass': bool(res['max_r'] >= target),
            'curve': [[int(r[0]), round(float(r[1]), 1)] for r in res['recorder']],
            'steps': int(res['total_step']), 'seconds': round(seconds, 1)}), flush=True)


if __name__ == '__main__':
    main()
