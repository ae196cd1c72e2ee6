"""The PyTorch port stands alone: importing every module of
``elegantrl_tpu_torch`` and ``chip_smoke.py`` loads neither JAX nor the JAX
package, and no source of the port names them (which would catch an
import made lazily inside a function)."""
import os
import re
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, 'elegantrl_tpu_torch')

_PROBE = r"""
import importlib, pkgutil, sys
import elegantrl_tpu_torch
names = [m.name for m in pkgutil.walk_packages(elegantrl_tpu_torch.__path__,
                                                'elegantrl_tpu_torch.')]
for name in names:
    importlib.import_module(name)
import chip_smoke
bad = sorted(m for m in sys.modules
             if m == 'jax' or m.startswith('jax.') or m == 'optax'
             or m == 'elegantrl_tpu' or m.startswith('elegantrl_tpu.'))
print(len(names), bad)
"""


def test_imports_load_no_jax():
    out = subprocess.run([sys.executable, '-c', _PROBE], cwd=ROOT, capture_output=True,
                         text=True, timeout=120, check=True).stdout.split()
    assert int(out[0]) >= 32, out    # the off-policy, PER and stock modules among them
    assert out[1:] == ['[]'], out


def test_off_policy_modules_are_probed():
    names = {'agents.dqn', 'agents.ddpg_td3', 'agents.off_policy', 'train.replay_buffer',
             'ops.fused_offpolicy_update', 'agents.sac', 'ops.per', 'agents.hterm',
             'agents.embed_dqn'}
    for name in names:
        assert os.path.isfile(os.path.join(PKG, *name.split('.')) + '.py'), name


def test_stock_module_is_probed():
    assert os.path.isfile(os.path.join(PKG, 'envs', 'stock_trading.py'))


def test_lunar_lander_and_kernel_modules_are_probed():
    """The LunarLander env and the module of K10, K11a and K11b, whose CUDA
    source is read by the source scan below."""
    for rel in (('envs', 'lunar_lander.py'), ('ops', 'kernels.py'),
                ('ops', 'csrc', 'kernels.cu')):
        assert os.path.isfile(os.path.join(PKG, *rel)), rel


def test_probe_module_and_script_are_probed():
    """The Mosaic probes' module and CUDA source (read by the source scan
    below) and their script, which imports no JAX either."""
    for rel in (('ops', 'probes.py'), ('ops', 'csrc', 'probes.cu'),
                ('ops', 'csrc', 'grid_gemm.cuh')):
        assert os.path.isfile(os.path.join(PKG, *rel)), rel
    with open(os.path.join(ROOT, 'scripts', 'torch_probe_ops.py')) as f:
        text = f.read()
    assert not re.search(r'^\s*(import|from)\s+(jax|elegantrl_tpu)\b', text, re.M)


def test_parallel_modules_are_probed():
    """The mesh, the process group and the population, whose modules the
    probe above imports and the source scan below reads."""
    for name in ('__init__', 'mesh', 'distributed', 'population'):
        assert os.path.isfile(os.path.join(PKG, 'parallel', name + '.py')), name


def _sources():
    for dirpath, _, files in os.walk(PKG):
        for f in files:
            if f.endswith(('.py', '.cu', '.cuh')):
                yield os.path.join(dirpath, f)
    yield os.path.join(ROOT, 'chip_smoke.py')


@pytest.mark.parametrize('pattern', [
    r'^\s*(import|from)\s+jax\b',
    r'^\s*(import|from)\s+optax\b',
    r'^\s*(import|from)\s+elegantrl_tpu(?!_torch)\b',
    r'^\s*from\s+\.\.\.',   # nothing reaches above the package
])
def test_sources_name_no_jax_import(pattern):
    hits = [f'{path}:{i}' for path in _sources()
            for i, line in enumerate(open(path, encoding='utf-8'), 1)
            if re.search(pattern, line)]
    assert not hits, hits
