"""Settings and names of the JAX package that the port used to drop or
ignore without a word, or refused: the compute and storage types (fault
12: bf16 raised; the off-policy rollout's compute type before it), the
evaluator's TensorBoard scalars, ``if_remove=None``, the packages' public
names, ``mesh_axes`` (fault 10, which trains now), the CUDA sources as
package data, where their libraries are built, and the env classes' and the
replay buffer's device (the card unless the caller asks for the CPU, as
``Config``; fault 14 for the buffer).  Each is held against the JAX package where it has the
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
from elegantrl_tpu_torch import Config, build_training, train_agent
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
def test_offpolicy_rollout_refuses_bf16(tmp_path, net_dims, compute_dtype, monkeypatch):
    """Where the JAX runner takes its off-policy rollout kernel and hands it a
    bf16 compute type, the port used to raise (fault 6: rather than compute
    in float32 without a word); since fault 12's repair it hands its kernel
    the bf16 type, as the JAX runner; float32 builds as before."""
    from elegantrl_tpu_torch.ops import fused_rollout as fr
    made = []
    real = fr.make_fused_offpolicy_rollout
    monkeypatch.setattr(fr, 'make_fused_offpolicy_rollout',
                        lambda *a, **k: made.append(k) or real(*a, **k))
    ctx = build_training(_td3_args(tmp_path, net_dims, compute_dtype))
    assert ctx.fused_rollout and made[-1]['compute_dtype'] == torch.bfloat16
    assert build_training(_td3_args(tmp_path, (16, 16), 'float32')).fused_rollout
    assert made[-1]['compute_dtype'] is None


@pytest.mark.parametrize('agent,net_dims,compute,storage', [
    ('AgentPPO', (512, 512), 'auto', 'float32'),
    ('AgentPPO', (16, 16), 'bfloat16', 'bfloat16'),
    ('AgentDiscretePPO', (16, 16), 'bfloat16', 'bfloat16'),
    ('AgentTD3', (16, 16), 'bfloat16', 'bfloat16'),
    ('AgentDQN', (16, 16), 'float32', 'bfloat16')])
def test_bf16_compute_and_storage_build_and_run(tmp_path, agent, net_dims, compute, storage):
    """Fault 12: ``compute_dtype='bfloat16'`` (also the default 'auto' at
    widths of 512), and ``storage_dtype='bfloat16'`` raised in ``make_ppo``,
    the off-policy rollout selection and ``ReplayBuffer``; the JAX package
    trains with them.  Each builds and runs a round on the CPU now, in the
    types asked for."""
    import elegantrl_tpu_torch.agents as agents
    from elegantrl_tpu_torch.envs import CartPoleEnv
    env = CartPoleEnv if 'Discrete' in agent or 'DQN' in agent else PendulumEnv
    env_args = (dict(PEND) if env is PendulumEnv else
                {'env_name': 'CartPole-v1', 'num_envs': 8, 'max_step': 500, 'state_dim': 4,
                 'action_dim': 2, 'if_discrete': True})
    args = Config(getattr(agents, agent), env, env_args)
    args.device, args.cwd, args.net_dims = 'cpu', str(tmp_path / 'run'), net_dims
    args.horizon_len, args.buffer_size, args.batch_size = 8, 256, 32
    args.compute_dtype, args.storage_dtype = compute, storage
    ctx = build_training(args)
    carry, m = ctx.round_fn(ctx.carry)
    assert np.isfinite(float(m['obj_critic']))
    if storage == 'bfloat16' and ctx.rb is not None:
        assert carry.buf_state.states.dtype == torch.bfloat16


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


def test_mesh_axes_trains_on_cpu_shards(tmp_path, capsys):
    """``mesh_axes`` (fault 10: it raised) shards the env axis: ``train_agent``
    with ``{'dp': 2}`` on the CPU takes two shards on ``'cpu'``, the fused
    rollout once per shard, and writes a carry in the union's layout."""
    args = Config(AgentPPO, PendulumEnv, dict(PEND))
    args.device, args.cwd, args.mesh_axes = 'cpu', str(tmp_path / 'run'), {'dp': 2}
    args.net_dims, args.horizon_len, args.batch_size = (16, 16), 16, 64
    args.eval_per_step, args.break_step, args.eval_times = 16 * 8, 16 * 8, 2
    out = train_agent(args)
    assert 'sharded x2' in capsys.readouterr().out
    assert out['total_step'] == 2 * 16 * 8 and np.isfinite(out['recorder']).all()
    args.continue_train, args.mesh_axes = True, None
    ctx = build_training(args)     # the dp = 2 run's carry restores without a mesh
    assert ctx.carry.obs.shape == (8, 3)


def test_replay_buffer_defaults_to_the_card(monkeypatch):
    """Fault 14: ``ReplayBuffer`` without a device put its ring on the CPU.
    It is the card now, as ``Config``: without a GPU the constructor raises,
    naming the way out; ``device='cpu'`` asks for the CPU."""
    from elegantrl_tpu_torch.train.replay_buffer import ReplayBuffer
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ReplayBuffer(16, 3, 1, num_seqs=2)
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: True)
    assert ReplayBuffer(16, 3, 1, num_seqs=2).device.type == 'cuda'
    buf = ReplayBuffer(16, 3, 1, num_seqs=2, device='cpu').init()
    assert buf.states.device.type == 'cpu'


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


def test_env_classes_default_to_the_card(monkeypatch):
    """An env runs where ``Config`` does: on the card unless ``device='cpu'``
    is given.  Without a GPU its first ``reset`` raises, naming the way out;
    building it to read its definition touches no device."""
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    env = PendulumEnv(num_envs=2)
    assert env.device.type == 'cuda' and env._def.spec.state_dim == 3
    with pytest.raises(RuntimeError, match="device='cpu'"):
        env.reset()
    obs, _ = PendulumEnv(num_envs=2, device='cpu').reset()
    assert obs.shape == (2, 3) and obs.device.type == 'cpu'


def test_mock_vectask_defaults_to_the_card(monkeypatch):
    """Fault 18: ``mock_vectask`` without a device built its tensors on the
    CPU.  It is the card now, as ``Config``: without a GPU it raises, naming
    ``device='cpu'``; a device given is taken as given."""
    from elegantrl_tpu_torch.envs.isaac import mock_vectask
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mock_vectask(4)
    task = mock_vectask(4, device='cpu')
    obs = task.reset()['obs']
    assert obs.shape == (4, 2) and obs.device.type == 'cpu'
    obs, rew, _, info = task.step(torch.zeros((4, 2)))
    assert obs['obs'].device.type == 'cpu' and rew.shape == (4,)


# fault 16: past the rollouts' shared-memory widths the card raised; the JAX
# runner takes its kernel there.  The streamed design takes every width to
# (1024, 1024) and past it, for every body and head in both compute types.

def test_card_takes_a_rollout_kernel_past_the_resident_widths(monkeypatch):
    from elegantrl_tpu_torch.agents import AgentSAC
    from elegantrl_tpu_torch.envs import HopperEnv
    from elegantrl_tpu_torch.ops import fused_rollout as fr
    from elegantrl_tpu_torch.train import runner
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: True)
    monkeypatch.setattr(fr, 'make_fused_rollout', lambda *a, **k: 'fused')
    monkeypatch.setattr(fr, 'make_fused_offpolicy_rollout', lambda *a, **k: 'fused')
    hop = {'env_name': 'HopperSlip-v0', 'num_envs': 1024, 'max_step': 1000, 'state_dim': 6,
           'action_dim': 2, 'if_discrete': False}
    for agent, env_class, env_args, dims in ((AgentPPO, PendulumEnv, dict(PEND), (384, 384)),
                                             (AgentTD3, HopperEnv, hop, (1024, 1024)),
                                             (AgentSAC, HopperEnv, hop, (1024, 256))):
        for dtype in ('float32', 'bfloat16'):
            args = Config(agent, env_class, dict(env_args))
            args.device, args.net_dims, args.compute_dtype = 'cuda', dims, dtype
            args.horizon_len = 32
            env = runner._resolve_env_def(args)
            for k in ('state_dim', 'action_dim', 'if_discrete'):
                setattr(args, k, getattr(env.spec, k))
            rb = None
            if args.if_off_policy:
                from elegantrl_tpu_torch.train.replay_buffer import ReplayBuffer
                rb = ReplayBuffer(max_size=64, state_dim=args.state_dim,
                                  action_dim=args.action_dim, num_seqs=args.num_envs,
                                  args=args, device='cpu')
            assert runner._maybe_fused_rollout(args, env, runner._make_agent(args, rb),
                                               torch.device('cuda'), args.num_envs, 32,
                                               1.0) == 'fused', (agent.__name__, dims, dtype)
    # the wrapper's choice: the resident design where it fits, else the
    # streamed one, else a raise naming the widest width
    assert fr._design(lambda v: 1000 if v & fr.STREAMED else 10 ** 6, 1, 'rollout', (8, 8),
                      lambda: '8') == fr.STREAMED
    assert fr._design(lambda v: 1000, 0, 'rollout', (8, 8), lambda: '8') == 0
    with pytest.raises(ValueError, match='square widths up to 1408'):
        fr._design(lambda v: 10 ** 6, 0, 'rollout', (1412, 1412), lambda: '1408')


@pytest.mark.parametrize('bf16', [False, True])
def test_stream_weights_pads_and_rounds_layer_2(bf16):
    """The streamed design's copy of W2: each net's (D2, D1) block zero-padded
    to multiples of 32, one net after the other, rounded to bf16 (to the
    nearest) under bf16, so every cluster size's slices lie inside it."""
    from elegantrl_tpu_torch.ops import fused_rollout as fr
    S, D1, D2 = 5, 40, 70
    rng = np.random.default_rng(0)
    flats = [torch.from_numpy(rng.standard_normal(D1 * S + D1 + D2 * D1 + D2 + 9)
                              .astype(np.float32)) for _ in range(2)]
    w = fr.stream_weights(flats, S, (D1, D2), bf16)
    assert w.shape == (2, 96, 64) and w.dtype == (torch.bfloat16 if bf16 else torch.float32)
    for i, flat in enumerate(flats):
        w2 = flat[D1 * S + D1:D1 * S + D1 + D2 * D1].view(D2, D1)
        want = w2.to(torch.bfloat16).float() if bf16 else w2
        assert torch.equal(w[i, :D2, :D1].float(), want)
        assert not w[i, D2:].any() and not w[i, :, D1:].any()


# fault 15: a host env under a mesh of several processes raised; the JAX
# runner trains there.  Each process's pool now holds its shard's envs.

_HOST_TRAIN_WORKER = r"""
import sys
import numpy as np
import torch
from elegantrl_tpu_torch import Config, train_agent
from elegantrl_tpu_torch.agents import AgentPPO
from elegantrl_tpu_torch.envs import EnvSpec, make_host_env
from elegantrl_tpu_torch.parallel.distributed import init_distributed


class ToyEnv:
    def reset(self, seed=None, options=None):
        if seed is not None:
            self.x0 = np.array([0.01 * seed, 0.0, 1.0], np.float32)
        self.x = self.x0.copy()
        return self.x, {}

    def step(self, action):
        self.x = (self.x * 0.9 + float(np.sum(action))).astype(np.float32)
        return self.x, -float(np.sum(np.square(self.x))), False, False, {}


torch.set_num_threads(1)
rank, url, cwd = int(sys.argv[1]), sys.argv[2], sys.argv[3]
assert init_distributed(url, 2, rank, backend='gloo') == 2
env = make_host_env(ToyEnv, EnvSpec('Toy-v0', 3, 50, 3, 1, False))
args = Config(AgentPPO, env, {'env_name': 'Toy-v0', 'num_envs': 4, 'max_step': 50,
                              'state_dim': 3, 'action_dim': 1, 'if_discrete': False})
args.device, args.net_dims, args.horizon_len, args.batch_size = 'cpu', (8, 8), 8, 16
args.mesh_axes, args.cwd = {'dp': 2}, cwd
args.eval_per_step, args.break_step, args.eval_times = 64, 64, 1
res = train_agent(args)
assert env.host_pool.offset == 2 * rank, env.host_pool.offset
env.host_pool.close()
print('WORKER-OK', rank, res['total_step'], flush=True)
"""


def test_host_env_trains_under_a_mesh_of_two_processes(tmp_path):
    import subprocess
    import sys
    url = 'file://' + str(tmp_path / 'rendezvous')
    env = dict(os.environ, PYTHONPATH=str(REPO) + os.pathsep + os.environ.get('PYTHONPATH', ''))
    env.pop('LOCAL_RANK', None)
    procs = [subprocess.Popen([sys.executable, '-c', _HOST_TRAIN_WORKER, str(r), url,
                               str(tmp_path / 'run')], cwd=str(REPO), env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=120)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0 and 'WORKER-OK' in out, f'rank {r}:\n{out[-3000:]}'
    assert (tmp_path / 'run' / 'agent.npz').is_file()


def test_stock_env_steps_past_its_last_day_as_jax():
    """Fault 19: the stock env's ``step`` indexed its price table with the
    next day unclamped, so stepping an episode already at its last day (a
    frozen episode of an evaluation longer than the table: the FinRL demo
    evaluates its 279-day tail for the training env's 833 steps) raised,
    where the JAX env's gather clamps and reads the last day again.  Now the
    day index is clamped as JAX's is; the step and the evaluation match."""
    import jax
    import jax.numpy as jnp
    from elegantrl_tpu.envs.stock_trading import make_stock_trading as j_make
    from elegantrl_tpu_torch.envs.stock_trading import make_stock_trading
    from elegantrl_tpu_torch.train.evaluator import make_eval_fn
    je = j_make(beg_idx=834, end_idx=1113, if_random_reset=False)
    te = make_stock_trading(beg_idx=834, end_idx=1113, if_random_reset=False)
    assert te.spec.max_step == je.spec.max_step == 278
    js = je.init(jax.random.key(0))
    ts = te.init(torch.Generator().manual_seed(0), 1, torch.device('cpu'))
    action = np.linspace(-1, 1, 15).astype(np.float32)
    for day in (277, 278):
        js2, jr, jt, _ = je.step(js._replace(day=jnp.asarray(day, js.day.dtype)),
                                 jnp.asarray(action), jax.random.key(1))
        ts2, tr, tt, _ = te.step(ts._replace(day=torch.full((1,), day, dtype=ts.day.dtype)),
                                 torch.as_tensor(action)[None], None)
        assert int(ts2.day[0]) == int(js2.day) == day + 1 and bool(tt[0]) == bool(jt)
        np.testing.assert_allclose(float(tr[0]), float(jr), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(ts2.total_asset[0].item(), float(js2.total_asset), rtol=1e-6)
        np.testing.assert_allclose(te.obs(ts2)[0].numpy(), np.asarray(je.obs(js2)),
                                   rtol=1e-5, atol=1e-6)
    # an evaluation 833 steps long on the 279-day tail: done at day 278
    eval_fn = make_eval_fn(te, lambda st, o: torch.zeros((o.shape[0], 15)), 2, 833,
                           torch.device('cpu'))
    returns, steps = eval_fn(None, torch.Generator().manual_seed(0))
    assert np.all(steps == 278) and np.all(np.isfinite(returns))
