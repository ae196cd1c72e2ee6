"""The PPO single file's learning result over training seeds, in either tree.

    python scripts/torch_single_file_seeds.py --seeds 0 1 2 3              (the port, the card)
    python scripts/torch_single_file_seeds.py --seeds 0 1 2 3 --device cpu
    JAX_PLATFORMS=cpu python scripts/torch_single_file_seeds.py --tree helloworld --seeds 0 1 2 3

``--tree helloworld_torch`` (the default) runs
``helloworld_torch/helloworld_PPO_single_file.py``'s ``main(device, seed)``.
``--tree helloworld`` runs the JAX reference file on the CPU with its
training key ``jax.random.key(0)`` replaced by ``key(seed)`` (its
evaluation keys ``key(100 + i)`` kept); that tree is the reference, run
on the CPU only.  Each seed prints one JSON line: the final avgR the file's
assert reads (> -400), whether it passed, and the seconds.
"""

import argparse
import contextlib
import importlib.util
import io
import json
import os
import re
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
THRESHOLD = -400.0


def load(tree: str):
    path = os.path.join(ROOT, tree, 'helloworld_PPO_single_file.py')
    spec = importlib.util.spec_from_file_location(f'{tree}_ppo_single_file', path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_port(mod, seed: int, device):
    return lambda: mod.main(device, seed)


def run_reference(mod, seed: int):
    rnd = mod.jax.random
    key = rnd.key

    def main():
        rnd.key = lambda n, *a, **k: key(seed if n == 0 else n, *a, **k)
        try:
            mod.main()
        finally:
            rnd.key = key
    return main


def card_name() -> str:
    try:
        return subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                               '--format=csv,noheader'], capture_output=True, text=True,
                              timeout=30).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.TimeoutExpired):
        return 'cpu'


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument('--tree', default='helloworld_torch',
                        choices=('helloworld_torch', 'helloworld'))
    parser.add_argument('--device', default=None, help="the port's: 'cuda' (default) or 'cpu'")
    parser.add_argument('--seeds', nargs='*', type=int, default=[0, 1, 2, 3])
    opts = parser.parse_args()
    mod = load(opts.tree)
    on = 'cpu' if opts.tree == 'helloworld' or opts.device == 'cpu' else card_name()
    for seed in opts.seeds:
        fn = run_reference(mod, seed) if opts.tree == 'helloworld' else run_port(
            mod, seed, opts.device)
        out, t0, passed = io.StringIO(), time.time(), True
        with contextlib.redirect_stdout(out):
            try:
                fn()
            except AssertionError as e:
                if 'failed to learn' not in str(e):
                    raise
                passed = False
        avg = [float(x) for x in re.findall(r'avgR\s+(-?[0-9.]+)', out.getvalue())]
        print(json.dumps({'tree': opts.tree, 'seed': seed, 'avgR': avg, 'final': avg[-1],
                          'threshold': THRESHOLD, 'passed': passed,
                          'seconds': round(time.time() - t0, 1), 'device': on}), flush=True)


if __name__ == '__main__':
    sys.exit(main())
