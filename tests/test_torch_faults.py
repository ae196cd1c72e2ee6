"""Settings and names of the JAX package that the port used to drop or
ignore without a word: the off-policy rollout's compute type, the
evaluator's TensorBoard scalars, ``if_remove=None``, the packages' public
names, ``mesh_axes``, the CUDA sources as package data and where their
libraries are built.  Each is held against the JAX package where it has the
behaviour (the TensorBoard tags and values, the prompt, the names)."""
import builtins
import fnmatch
import os
import tomllib
from pathlib import Path

import numpy as np
import pytest
import torch

from elegantrl_tpu.config import Config as JConfig
from elegantrl_tpu.envs import PendulumEnv as JPendulumEnv
from elegantrl_tpu.train.evaluator import Evaluator as JEvaluator
from elegantrl_tpu_torch import Config, build_training
from elegantrl_tpu_torch.agents import AgentPPO, AgentTD3
from elegantrl_tpu_torch.envs import PendulumEnv
from elegantrl_tpu_torch.ops import _cuda_build
from elegantrl_tpu_torch.train.evaluator import Evaluator

REPO = Path(__file__).resolve().parents[1]
PEND = {'env_name': 'Pendulum-v1', 'num_envs': 8, 'max_step': 200, 'state_dim': 3,
        'action_dim': 1, 'if_discrete': False}


def _td3_args(tmp_path, net_dims, compute_dtype):
    args = Config(AgentTD3, PendulumEnv, dict(PEND))
    args.device, args.cwd, args.net_dims = 'cpu', str(tmp_path / 'run'), net_dims
    args.horizon_len, args.buffer_size, args.batch_size = 8, 256, 32
    args.compute_dtype = compute_dtype
    return args


@pytest.mark.parametrize('net_dims,compute_dtype', [((512, 512), 'auto'),
                                                    ((16, 16), 'bfloat16')],
                         ids=['auto_wide', 'bfloat16'])
def test_offpolicy_rollout_refuses_bf16(tmp_path, net_dims, compute_dtype):
    """Where the JAX runner takes its off-policy rollout kernel and hands it a
    bf16 compute type, the port raises as ``make_ppo`` does; float32 builds."""
    with pytest.raises(NotImplementedError, match='float32 only'):
        build_training(_td3_args(tmp_path, net_dims, compute_dtype))
    assert build_training(_td3_args(tmp_path, (16, 16), 'float32')).fused_rollout


def _scalars(logdir):
    from tensorboard.backend.event_processing.event_accumulator import EventAccumulator
    acc = EventAccumulator(str(logdir))
    acc.Reload()
    return {tag: [(e.step, e.value) for e in acc.Scalars(tag)] for tag in acc.Tags()['scalars']}


@pytest.mark.parametrize('switch', ['argument', 'args'])
def test_evaluator_tensorboard_as_jax(tmp_path, switch):
    """The same five scalars, tags, steps and values as the JAX evaluator,
    under ``{cwd}/tensorboard``."""
    returns = np.array([-300.0, -250.0, -200.0], np.float32)
    steps = np.array([200.0, 200.0, 200.0], np.float32)
    logging = (1.5, -0.25)

    jargs = JConfig(None, JPendulumEnv, dict(PEND))
    jargs.if_keep_save, jargs.eval_per_step = False, 1
    jcwd = tmp_path / 'jax'
    jev = JEvaluator(str(jcwd), JPendulumEnv(num_envs=1)._def, lambda p, x: x[:, :1], jargs,
                     if_tensorboard=True)
    jev.finish((96, returns, steps, None), -1.25, logging)
    jev.tensorboard.flush()

    args = Config(AgentPPO, PendulumEnv, dict(PEND))
    args.if_keep_save, args.eval_per_step = False, 1
    kw = {'if_tensorboard': True}
    if switch == 'args':
        args.if_tensorboard, kw = True, {}
    cwd = tmp_path / 'port'
    ev = Evaluator(str(cwd), PendulumEnv(num_envs=1)._def, lambda s, x: x[:, :1], args, 'cpu',
                   **kw)
    ev._eval_fn = lambda state, gen: (returns, steps)
    ev.evaluate_and_save(None, 96, -1.25, logging, to_numpy=None)
    ev.tensorboard.flush()

    want = _scalars(jcwd / 'tensorboard')
    assert len(want) == 5
    assert _scalars(cwd / 'tensorboard') == want


def test_evaluator_without_tensorboard_writes_nothing(tmp_path):
    args = Config(AgentPPO, PendulumEnv, dict(PEND))
    ev = Evaluator(str(tmp_path), PendulumEnv(num_envs=1)._def, lambda s, x: x[:, :1], args, 'cpu')
    assert ev.tensorboard is None and not (tmp_path / 'tensorboard').exists()


@pytest.mark.parametrize('answer', ['y', 'n'])
def test_if_remove_none_asks_as_jax(tmp_path, monkeypatch, answer):
    """``if_remove=None`` asks on stdin with the JAX package's prompt and
    removes ``cwd`` only on 'y'."""
    prompts = {}
    for name, cls in (('jax', JConfig), ('port', Config)):
        cwd = tmp_path / 'run'
        cwd.mkdir(exist_ok=True)
        (cwd / 'keep.txt').write_text('x')
        args = cls(None, None, dict(PEND))
        args.cwd, args.if_remove = str(cwd), None

        def ask(prompt, name=name):
            prompts[name] = prompt
            return answer

        monkeypatch.setattr(builtins, 'input', ask)
        args.init_before_training()
        assert args.if_remove is (answer == 'y')
        assert (cwd / 'keep.txt').exists() is (answer != 'y')
    assert prompts['port'] == prompts['jax']


def test_public_names_as_jax():
    """The JAX package's public names of ``train``, ``utils`` and ``ops``,
    the port's own kept beside them."""
    import elegantrl_tpu.ops as jops
    import elegantrl_tpu.train as jtrain
    import elegantrl_tpu.utils as jutils
    import elegantrl_tpu_torch.ops as ops
    import elegantrl_tpu_torch.train as train
    import elegantrl_tpu_torch.utils as utils
    for jmod, mod in ((jtrain, train), (jutils, utils), (jops, ops)):
        public = {n for n in vars(jmod) if not n.startswith('_')}
        public -= {n for n in public if type(getattr(jmod, n)).__name__ == 'module'
                   and n not in ('nets', 'dists', 'gae')}   # submodules imported as a side effect
        missing = sorted(n for n in public if not hasattr(mod, n))
        assert not missing, (mod.__name__, missing)
    assert train.ReplayBuffer.__module__.endswith('train.replay_buffer')
    assert utils.save_pytree is utils.save_tree and utils.load_pytree is utils.load_tree
    assert {ops.nets.__name__, ops.dists.__name__, ops.gae.__name__} == {
        'elegantrl_tpu_torch.ops.nets', 'elegantrl_tpu_torch.ops.dists',
        'elegantrl_tpu_torch.ops.gae'}


def test_save_pytree_round_trip(tmp_path):
    from elegantrl_tpu_torch.utils import load_pytree, save_pytree
    tree = {'w': torch.arange(6.0).reshape(2, 3), 'b': (torch.ones(2), torch.zeros(1))}
    save_pytree(str(tmp_path / 't.npz'), tree)
    got = load_pytree(str(tmp_path / 't.npz'), tree)
    np.testing.assert_array_equal(np.asarray(got['w']), tree['w'].numpy())
    np.testing.assert_array_equal(np.asarray(got['b'][0]), tree['b'][0].numpy())


def test_mesh_axes_raises(tmp_path):
    args = Config(AgentPPO, PendulumEnv, dict(PEND))
    args.device, args.cwd, args.mesh_axes = 'cpu', str(tmp_path), {'dp': 4}
    with pytest.raises(NotImplementedError, match="ROADMAP.md's parallel item"):
        build_training(args)


def test_package_data_names_every_cuda_source():
    """A wheel carries every file of ``ops/csrc`` (no wheel is built here:
    the globs of ``pyproject.toml`` are matched against the directory)."""
    meta = tomllib.loads((REPO / 'pyproject.toml').read_text())
    globs = meta['tool']['setuptools']['package-data']['elegantrl_tpu_torch']
    files = sorted(p.relative_to(REPO / 'elegantrl_tpu_torch').as_posix()
                   for p in (REPO / 'elegantrl_tpu_torch' / 'ops' / 'csrc').iterdir())
    assert files and all(any(fnmatch.fnmatch(f, g) for g in globs) for f in files), files
    assert 'elegantrl_tpu' not in meta['tool']['setuptools']['package-data']


def test_build_dir_in_a_checkout_and_installed(tmp_path, monkeypatch):
    assert _cuda_build.BUILD_DIR == REPO / 'build' / 'kernels'
    checkout = tmp_path / 'checkout'
    (checkout / 'elegantrl_tpu_torch').mkdir(parents=True)
    (checkout / 'pyproject.toml').write_text('')
    assert _cuda_build.build_dir(checkout / 'elegantrl_tpu_torch') == checkout / 'build' / 'kernels'
    site = tmp_path / 'site-packages' / 'elegantrl_tpu_torch'
    site.mkdir(parents=True)
    monkeypatch.setenv('XDG_CACHE_HOME', str(tmp_path / 'cache'))
    assert _cuda_build.build_dir(site) == tmp_path / 'cache' / 'elegantrl_tpu_torch' / 'kernels'
    monkeypatch.delenv('XDG_CACHE_HOME')
    monkeypatch.setenv('HOME', str(tmp_path / 'home'))
    assert _cuda_build.build_dir(site) == (tmp_path / 'home' / '.cache' / 'elegantrl_tpu_torch'
                                           / 'kernels')
    assert os.access(tmp_path, os.W_OK)
