"""``helloworld_torch/`` and ``examples_torch/`` against ``helloworld/`` and
``examples/`` on the CPU.

Every file of the JAX trees has a port of the same name.  Every driver
function of both trees (each ``sys.argv`` variant's call) runs with
``train_agent`` / ``build_training`` (and ``valid_agent``) replaced in its
module's namespace by a recorder; the two ``Config`` objects it built are
equal field by field (the agent's name, the env and its args, every
hyper-parameter; the JAX-only ``compilation_cache_dir`` and
``rollout_unroll`` aside), and the port's leaves ``device`` and the kernel
switches at their defaults (``'cuda'``, the card; ``'auto'``).  Then an
on-policy driver (``tutorial_Pendulum_v1``, with its ``valid_agent``), an
off-policy one (``erl_tutorial_DQN``), ``tutorial_Creating_VecEnv``, the
paper-trading loop and the Box2D re-evaluation run for real on the CPU,
the ``Config`` each driver built cut to 2 rounds.  No port file names JAX
or the JAX package."""
import importlib
import importlib.util
import os
import re
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TREES = {'helloworld': 'helloworld_torch', 'examples': 'examples_torch'}
# a JAX driver function whose port counterpart has another name
PORT_NAMES = {'train_pure_jax': 'train_native'}
JAX_ONLY = {'compilation_cache_dir', 'rollout_unroll'}
PORT_ONLY = {'device': 'cuda', 'use_fused_rollout': 'auto', 'use_fused_update': 'auto',
             'use_gae_kernel': 'auto', 'use_gather_kernel': 'auto', 'use_mlp3_kernel': 'auto'}


def test_every_driver_file_has_a_port_of_the_same_name():
    for jax_tree, port_tree in TREES.items():
        want = sorted(f for f in os.listdir(os.path.join(ROOT, jax_tree)) if f.endswith('.py'))
        got = sorted(f for f in os.listdir(os.path.join(ROOT, port_tree)) if f.endswith('.py'))
        assert got == want and len(want) in (7, 18)


def test_no_port_file_names_jax():
    for tree in TREES.values():
        for f in os.listdir(os.path.join(ROOT, tree)):
            if f.endswith('.py'):
                src = open(os.path.join(ROOT, tree, f)).read()
                assert not re.search(r'\b(jax|optax|flax)\b', src), f
                assert not re.search(r'elegantrl_tpu(?!_torch)', src), f
                assert not re.search(r'^\s*(from|import) helloworld\b(?!_torch)', src, re.M), f


# ---------------------------------------------------------------- loading

def _load(tree, name):
    """``tree/name.py`` as a module of its own (a sibling it imports by name,
    ``demo_DDPG_TD3_SAC``, is loaded from the same tree first)."""
    key = f'_drv_{tree}_{name}'
    if key in sys.modules:
        return sys.modules[key]
    path = os.path.join(ROOT, tree, name + '.py')
    spec = importlib.util.spec_from_file_location(key, path)
    mod = importlib.util.module_from_spec(spec)
    saved = sys.modules.get('demo_DDPG_TD3_SAC')
    if name == 'demo_DDPG_TD3_SAC_with_PER':
        sys.modules['demo_DDPG_TD3_SAC'] = _load(tree, 'demo_DDPG_TD3_SAC')
    try:
        spec.loader.exec_module(mod)
    finally:
        if saved is None:
            sys.modules.pop('demo_DDPG_TD3_SAC', None)
        else:
            sys.modules['demo_DDPG_TD3_SAC'] = saved
    sys.modules[key] = mod
    return mod


class Recorder:
    """Stands in for ``train_agent`` / ``build_training`` / ``valid_agent``:
    keeps the ``Config`` and returns a result the drivers can print."""

    def __init__(self):
        self.configs = []

    def __call__(self, args, *a, **k):
        args.init_before_training()     # cwd and seed, as train_agent's first step
        self.configs.append(args)
        return {'max_r': 0.0, 'used_time': 0.0, 'total_step': 0, 'steps_per_second': 0.0,
                'agent_state': None, 'recorder': np.zeros((0, 3))}


def _patched(mod, rec, monkeypatch):
    for name in ('train_agent', 'build_training'):
        if hasattr(mod, name):
            monkeypatch.setattr(mod, name, rec)
    if hasattr(mod, 'valid_agent'):
        monkeypatch.setattr(mod, 'valid_agent', lambda *a, **k: None)
    # the helloworld tutorial calls the erl tutorials' train_agent
    if hasattr(mod, 'tutorial_dqn'):
        pkg = 'helloworld_torch' if 'torch' in mod.__name__ else 'helloworld'
        for erl in ('erl_tutorial_DQN', 'erl_tutorial_PPO', 'erl_tutorial_DDPG_TD3_SAC'):
            monkeypatch.setattr(importlib.import_module(f'{pkg}.{erl}'), 'train_agent', rec)


def record(tree, name, fn, args, monkeypatch):
    """The Configs ``tree/name.py:fn(*args)`` builds; an argument that is a
    string naming an ``Agent*`` class is that module's class."""
    mod = _load(tree, name)
    rec = Recorder()
    _patched(mod, rec, monkeypatch)
    if name == 'demo_DDPG_TD3_SAC_with_PER':   # it trains through its sibling
        _patched(_load(tree, 'demo_DDPG_TD3_SAC'), rec, monkeypatch)
    resolved = []
    for a in args:
        if isinstance(a, str) and a.startswith('Agent'):
            a = getattr(mod, a, None) or getattr(
                importlib.import_module('elegantrl_tpu_torch.agents' if 'torch' in tree
                                        else 'elegantrl_tpu.agents'), a)
        resolved.append(a)
    getattr(mod, fn)(*resolved)
    return rec.configs


# (tree, file, function, arguments): every sys.argv variant's call
H, E = 'helloworld', 'examples'
_OFF = ('AgentDDPG', 'AgentTD3', 'AgentSAC', 'AgentModSAC')
DRIVERS = (
    [(H, 'erl_tutorial_DQN', 'train_dqn_for_cartpole', ()),
     (H, 'erl_tutorial_PPO', 'train_ppo_for_pendulum', ())]
    + [(H, 'erl_tutorial_DDPG_TD3_SAC', 'train_for_pendulum', (a,)) for a in _OFF]
    + [(E, 'demo_A2C_PPO', 'train_ppo_a2c_for_pendulum', (a,)) for a in ('AgentPPO', 'AgentA2C')]
    + [(E, 'demo_A2C_PPO', 'train_ppo_for_pendulum_many_envs', ()),
       (E, 'demo_A2C_PPO', 'train_ppo_for_point_chasing', ())]
    + [(E, 'demo_A2C_PPO_discrete', f, (a,))
       for f in ('train_discrete_ppo_for_cartpole', 'train_discrete_ppo_for_lunar_lander')
       for a in ('AgentDiscretePPO', 'AgentDiscreteA2C')]
    + [(E, 'demo_DDPG_TD3_SAC', 'train_for_pendulum', (a, 8, per))
       for a in _OFF for per in (False, True)]
    + [(E, 'demo_DDPG_TD3_SAC_with_PER', 'train_with_per', (a,)) for a in _OFF]
    + [(E, 'demo_DQN_variants', 'train_dqn_for_cartpole', (a,))
       for a in ('AgentDQN', 'AgentDoubleDQN', 'AgentDuelingDQN', 'AgentD3QN', 'AgentEmbedDQN',
                 'AgentEnsembleDQN')]
    + [(E, 'demo_DQN_variants', 'train_dqn_for_point_chasing', ()),
       (E, 'demo_FinRL_stock_trading', 'train_ppo_for_stock_trading', ())]
    + [(E, 'plan_DDPG_H', 'demo_offpolicy_h_term', (a, n, b))
       for a in ('AgentDDPG', 'AgentDDPGHterm', 'AgentTD3Hterm', 'AgentSACHterm', 'AgentModSACHterm')
       for n, b in ((16, int(1e5)), (1024, int(6e6)))]
    + [(E, 'plan_PPO_H', 'demo_ppo_h_term', (a, n, b)) for a in ('AgentPPO', 'AgentPPOHterm')
       for n, b in ((16, int(2e5)), (1024, int(1.5e7)))]
    + [(E, 'plan_Isaac_Gym', 'plan_isaac', ('mock', q)) for q in (False, True)]
    + [(E, 'plan_PaperTradingEnv_PPO', 'train', (q,)) for q in (False, True)]
    + [(E, 'tutorial_BipedalWalker_v3', 'main', (q,)) for q in (False, True)]
    + [(E, 'tutorial_Creating_VecEnv', 'main', ()),
       (E, 'tutorial_Hopper_v3', 'train_native_hopper', (16, int(2e5))),
       (E, 'tutorial_Hopper_v3', 'train_native_hopper', ()),
       (E, 'tutorial_Hopper_v3', 'train_real_mujoco_hopper', ()),
       (E, 'tutorial_LunarLanderContinuous_v2', 'train_pure_jax', (int(4e5),)),
       (E, 'tutorial_Pendulum_v1', 'main', ())]
    + [(E, 'tutorial_helloworld_DQN_DDPG_PPO', f, ())
       for f in ('tutorial_dqn', 'tutorial_ddpg', 'tutorial_ppo')]
)


def _env_key(env):
    """An env class by name; an EnvDef (or its maker's instance) by its spec."""
    if env is None:
        return None
    if isinstance(env, type):
        return env.__name__
    spec = getattr(env, 'spec', None)
    return ('EnvDef', tuple(spec)) if spec is not None else type(env).__name__


def same_config(j, t):
    jv, tv = vars(j), vars(t)
    assert set(jv) - JAX_ONLY == set(tv) - set(PORT_ONLY), (set(jv) ^ set(tv))
    for k, want in jv.items():
        if k in JAX_ONLY:
            continue
        got = tv[k]
        if k == 'agent_class':
            assert got.__name__ == want.__name__
        elif k in ('env_class', 'eval_env_class'):
            assert _env_key(got) == _env_key(want), k
        elif k == 'env_args' or k == 'eval_env_args':
            assert (got is None) == (want is None), k
            assert want is None or {a: tuple(b) if isinstance(b, (list, tuple)) else b
                                    for a, b in got.items()} == \
                {a: tuple(b) if isinstance(b, (list, tuple)) else b for a, b in want.items()}, k
        elif isinstance(want, (list, tuple)):
            assert tuple(got) == tuple(want), k
        else:
            assert got == want or (got != got and want != want), (k, got, want)
    for k, default in PORT_ONLY.items():
        assert tv[k] == default, k


@pytest.mark.parametrize('tree,name,fn,args', DRIVERS,
                         ids=[f'{d[1]}.{d[2]}{d[3]}' for d in DRIVERS])
def test_driver_builds_the_jax_config(tree, name, fn, args, monkeypatch, tmp_path):
    monkeypatch.chdir(tmp_path)
    if name in ('tutorial_BipedalWalker_v3', 'tutorial_Hopper_v3') and fn != 'train_native_hopper':
        pytest.importorskip('gymnasium')
    jax_cfgs = record(tree, name, fn, args, monkeypatch)
    port_cfgs = record(TREES[tree], name, PORT_NAMES.get(fn, fn), args, monkeypatch)
    assert len(port_cfgs) == len(jax_cfgs) >= (0 if fn == 'train_real_mujoco_hopper' else 1)
    for j, t in zip(jax_cfgs, port_cfgs):
        same_config(j, t)


def test_list_gym_envs_lists_the_same_envs(capsys):
    j, t = _load('examples', 'list_gym_envs'), _load('examples_torch', 'list_gym_envs')
    assert [n for n, _, _ in t.NATIVE] == [n for n, _, _ in j.NATIVE]
    assert all(os.path.isfile(os.path.join(ROOT, 'elegantrl_tpu_torch', p)) for _, p, _ in t.NATIVE)
    t.main()
    out = capsys.readouterr().out
    assert 'elegantrl_tpu_torch/envs/pendulum.py' in out


# ---------------------------------------------------------------- real runs

def _two_rounds(args, tmp_path):
    """The driver's Config on the CPU, cut to two rounds of one evaluation each."""
    args.device = 'cpu'
    args.cwd = str(tmp_path / 'run')
    spr = args.num_envs * args.horizon_len
    args.eval_per_step = spr
    args.break_step = spr
    args.eval_times = min(args.eval_times, 2)
    return args


def _captured(tree, name, fn, args):
    """The last Config ``tree/name.py:fn(*args)`` builds, the recorders
    taken out again."""
    with pytest.MonkeyPatch.context() as mp:
        return record(tree, name, fn, args, mp)[-1]


@pytest.mark.parametrize('name,fn', [('tutorial_Pendulum_v1', 'main'),
                                     ('tutorial_Creating_VecEnv', 'main')])
def test_onpolicy_drivers_train_two_rounds_on_the_cpu(name, fn, monkeypatch, tmp_path):
    from elegantrl_tpu_torch.train.runner import train_agent, valid_agent
    monkeypatch.chdir(tmp_path)
    torch.set_num_threads(2)
    args = _two_rounds(_captured('examples_torch', name, fn, ()), tmp_path)
    res = train_agent(args)
    assert res['recorder'].shape[0] == 2 and np.isfinite(res['max_r'])
    assert res['total_step'] == 2 * args.num_envs * args.horizon_len
    if name == 'tutorial_Pendulum_v1':
        mod = _load('examples_torch', name)
        rows = valid_agent(mod.PendulumEnv, dict(args.env_args), args.net_dims, mod.AgentPPO,
                           os.path.join(args.cwd, 'agent.npz'), render_times=2, device='cpu')
        assert len(rows) == 2 and all(st == 200 for _, st in rows)


def test_offpolicy_driver_trains_two_rounds_on_the_cpu(monkeypatch, tmp_path):
    from elegantrl_tpu_torch.train.runner import train_agent
    monkeypatch.chdir(tmp_path)
    torch.set_num_threads(2)
    args = _two_rounds(_captured('helloworld_torch', 'erl_tutorial_DQN',
                                 'train_dqn_for_cartpole', ()), tmp_path)
    res = train_agent(args)
    assert res['recorder'].shape[0] == 2 and np.isfinite(res['max_r'])
    assert os.path.isfile(os.path.join(args.cwd, 'agent.npz'))


def test_isaac_mock_builds_on_the_runs_device(monkeypatch, tmp_path):
    """The mock VecTask is built at the first reset, on ``args.device``."""
    from elegantrl_tpu_torch.train.runner import build_training
    monkeypatch.chdir(tmp_path)
    args = _captured('examples_torch', 'plan_Isaac_Gym', 'plan_isaac', ('mock', True))
    args.device = 'cpu'
    ctx = build_training(args)
    carry, metrics = ctx.round_fn(ctx.carry)
    assert carry.obs.device.type == 'cpu' and torch.isfinite(metrics['exp_r'])


def test_paper_trading_serves_the_trained_policy_on_the_cpu(monkeypatch, tmp_path):
    from elegantrl_tpu_torch.train.runner import train_agent
    monkeypatch.chdir(tmp_path)
    torch.set_num_threads(2)
    mod = _load('examples_torch', 'plan_PaperTradingEnv_PPO')
    args = _two_rounds(_captured('examples_torch', 'plan_PaperTradingEnv_PPO', 'train',
                                 (True,)), tmp_path)
    args.eval_times = 1
    train_agent(args)
    cr = mod.paper_trade(args)
    assert np.isfinite(cr) and cr > 0


def test_box2d_reevaluation_runs_on_the_cpu(monkeypatch, tmp_path):
    pytest.importorskip('gymnasium')
    pytest.importorskip('Box2D')
    from elegantrl_tpu_torch.train.runner import build_training
    monkeypatch.chdir(tmp_path)
    mod = _load('examples_torch', 'tutorial_LunarLanderContinuous_v2')
    args = _captured('examples_torch', 'tutorial_LunarLanderContinuous_v2', 'train_native',
                     (int(4e5),))
    args.device, args.cwd = 'cpu', str(tmp_path / 'run')
    args.init_before_training()
    state = build_training(args).carry.agent_state
    mod.evaluate_on_box2d(args, {'agent_state': state}, episodes=2)


def test_drivers_run_on_the_card_by_default(monkeypatch, tmp_path):
    """Without a GPU the port's entry points raise, naming the CPU choice."""
    if torch.cuda.is_available():
        pytest.skip('a card is present')
    monkeypatch.chdir(tmp_path)
    mod = _load('examples_torch', 'tutorial_Creating_VecEnv')
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mod.main()
    rls = _load('examples_torch', 'tutorial_rlsolver')
    with pytest.raises(RuntimeError, match="device='cpu'"):
        rls.main()


def test_rlsolver_tutorial_runs_on_the_cpu(monkeypatch, tmp_path):
    import tempfile
    monkeypatch.setattr(tempfile, 'tempdir', str(tmp_path))
    torch.set_num_threads(2)
    out = _load('examples_torch', 'tutorial_rlsolver').main(device='cpu')
    r, g, s, m = out['maxcut']
    assert r <= g and r <= m and np.isfinite(out['tsp'])
    dist, veh = out['vrptw']
    assert np.isfinite(dist) and veh <= 6
    ga, exact = out['knapsack']
    assert 0 < ga <= exact * 1.05
    assert np.isclose(2.0 ** out['tnco'][0], out['tnco'][1], rtol=1e-4)
    assert os.listdir(tmp_path / 'rlsolver_tutorial')
