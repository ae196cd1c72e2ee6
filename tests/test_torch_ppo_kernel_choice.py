"""Where the port's PPO family takes a kernel: exactly where the JAX package
takes its Pallas kernel (``elegantrl_tpu/train/runner.py:_maybe_pallas_rollout``
for the rollout, ``elegantrl_tpu/agents/ppo.py:_fused_update`` for the
update), and PyTorch ops wherever the JAX package runs XLA ops, on a card
too.  Then the autograd PPO update that runs where the JAX package runs its
minibatch scan, one whole ``ppo_stock`` round, and ``train_agent`` on the
stock env.

The decisions are compared under ``device='cuda'`` on the CPU: both are made
before anything launches.  The JAX package's are read without a TPU: its
rollout with ``use_pallas_rollout=True``, which past every eligibility term
raises only for the missing TPU; its update in interpret mode, traced with
``jax.eval_shape`` and its kernel builder replaced by one that records the
call.

Tolerances: the updates as the JAX package's own update tests, parameter
updates (new - old) rtol 5e-3 (atol 4e-7) and objectives rtol 1e-4 (atol
1e-6); the ``ppo_stock`` round's rollout as ``test_torch_stock_rollout.py``
(1e-4; rewards also rtol 1e-4 for the terminal bonus).
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import elegantrl_tpu.ops.pallas_update as jpu
from elegantrl_tpu.agents import AgentA2C as JAgentA2C, AgentPPO as JAgentPPO
from elegantrl_tpu.agents import AgentDiscretePPO as JAgentDiscretePPO
from elegantrl_tpu.agents import AgentPPOHterm as JAgentPPOHterm
from elegantrl_tpu.agents.base import Rollout as JRollout
from elegantrl_tpu.config import Config as JConfig
from elegantrl_tpu.agents import AgentDoubleDQN as JAgentDoubleDQN, AgentDQN as JAgentDQN
from elegantrl_tpu.agents import AgentDuelingDQN as JAgentDuelingDQN
from elegantrl_tpu.agents import AgentModSAC as JAgentModSAC, AgentSAC as JAgentSAC
from elegantrl_tpu.agents import AgentTD3 as JAgentTD3
from elegantrl_tpu.envs import CartPoleEnv as JCartPoleEnv
from elegantrl_tpu.envs import HopperEnv as JHopperEnv
from elegantrl_tpu.envs import LunarLanderContinuousEnv as JLanderCont
from elegantrl_tpu.envs import PendulumEnv as JPendulumEnv
from elegantrl_tpu.envs import PointChasingDiscreteEnv as JChasingDiscEnv
from elegantrl_tpu.envs import PointChasingVecEnv as JChasingEnv
from elegantrl_tpu.envs.stock_trading import StockTradingVecEnv as JStockEnv
from elegantrl_tpu.train import runner as jrunner
from elegantrl_tpu_torch import Config, build_training, train_agent
from elegantrl_tpu_torch.agents import AgentA2C, AgentDiscretePPO, AgentPPO, AgentPPOHterm
from elegantrl_tpu_torch.agents import (AgentDoubleDQN, AgentDQN, AgentDuelingDQN,
                                        AgentModSAC, AgentSAC, AgentTD3)
from elegantrl_tpu_torch.agents import ppo as pppo
from elegantrl_tpu_torch.agents.base import Rollout
from elegantrl_tpu_torch.envs import (CartPoleEnv, HopperEnv, LunarLanderContinuousEnv,
                                      PendulumEnv, PointChasingDiscreteEnv, PointChasingVecEnv,
                                      StockTradingVecEnv)
from elegantrl_tpu_torch.ops import fused_rollout as fr
from elegantrl_tpu_torch.train import runner
from elegantrl_tpu_torch.utils.checkpoint import tree_leaves
from elegantrl_tpu_torch.utils.jax_params import env_state_from_numpy

torch.set_num_threads(1)
AGENTS = {'ppo': (AgentPPO, JAgentPPO), 'a2c': (AgentA2C, JAgentA2C),
          'hterm': (AgentPPOHterm, JAgentPPOHterm),
          'dppo': (AgentDiscretePPO, JAgentDiscretePPO),
          'td3': (AgentTD3, JAgentTD3), 'sac': (AgentSAC, JAgentSAC),
          'modsac': (AgentModSAC, JAgentModSAC), 'dqn': (AgentDQN, JAgentDQN),
          'ddqn': (AgentDoubleDQN, JAgentDoubleDQN), 'duel': (AgentDuelingDQN, JAgentDuelingDQN)}
ENVS = {
    'pendulum': (PendulumEnv, JPendulumEnv, {'env_name': 'Pendulum-v1', 'max_step': 200,
                                             'state_dim': 3, 'action_dim': 1}),
    'cartpole': (CartPoleEnv, JCartPoleEnv, {'env_name': 'CartPole-v1', 'max_step': 500,
                                             'state_dim': 4, 'action_dim': 2,
                                             'if_discrete': True}),
    'hopper': (HopperEnv, JHopperEnv, {'env_name': 'HopperSlip-v0', 'max_step': 1000,
                                       'state_dim': 6, 'action_dim': 2}),
    'chasing': (PointChasingVecEnv, JChasingEnv, {'env_name': 'PointChasingVecEnv',
                                                  'max_step': 1024, 'state_dim': 8,
                                                  'action_dim': 2}),
    'chasing_disc': (PointChasingDiscreteEnv, JChasingDiscEnv,
                     {'env_name': 'PointChasingDiscreteEnv', 'max_step': 1024,
                      'state_dim': 8, 'action_dim': 5, 'if_discrete': True}),
    'stock': (StockTradingVecEnv, JStockEnv, {'env_name': 'StockTradingEnv-v2',
                                              'max_step': 1112, 'state_dim': 151,
                                              'action_dim': 15}),
    # no kernel body in either package: the generic rollout
    'lunar_cont': (LunarLanderContinuousEnv, JLanderCont,
                   {'env_name': 'LunarLanderContinuous-v2', 'max_step': 1000, 'state_dim': 8,
                    'action_dim': 2}),
    # dim 3: no kernel body in either package (the chasing body is built for dim 2)
    'chasing3': (PointChasingVecEnv, JChasingEnv, {'env_name': 'PointChasingVecEnv',
                                                   'max_step': 1024, 'state_dim': 12,
                                                   'action_dim': 3, 'dim': 3}),
}
# (agent, env, net_dims, num_envs, horizon, batch, repeat[, extra settings])
GRID = {
    'ppo_stock': ('ppo', 'stock', (128, 128), 256, 128, 512, 8),
    'ppo_stock_4k': ('ppo', 'stock', (128, 128), 4096, 128, 4096, 64),
    'stock_b2048': ('ppo', 'stock', (16, 16), 256, 128, 2048, 8),
    'stock_b2176': ('ppo', 'stock', (16, 16), 256, 128, 2176, 8),
    'stock_blocks_over_8mib': ('ppo', 'stock', (16, 16), 256, 256, 2048, 64),
    'pendulum_main': ('ppo', 'pendulum', (128, 128), 4096, 64, 512, 8),
    'pendulum_3_layers': ('ppo', 'pendulum', (64, 64, 64), 4096, 64, 512, 8),
    'stock_3_layers': ('ppo', 'stock', (16, 16, 16), 256, 128, 512, 8),
    'a2c_pendulum': ('a2c', 'pendulum', (128, 128), 1024, 64, 512, 8),
    'hterm_pendulum': ('hterm', 'pendulum', (128, 128), 1024, 64, 512, 8),
    'chasing_no_body': ('ppo', 'chasing3', (128, 128), 1024, 64, 512, 8),
    # ppo_lunarlander_cont (RESULTS.md:23): the generic rollout and K2 at U = 8
    'ppo_lunarlander_cont': ('ppo', 'lunar_cont', (128, 128), 64, 256, 512, 16),
    # widths the first rollout design refused (both nets in one block); the
    # JAX runner takes its kernel at any width
    'pendulum_256': ('ppo', 'pendulum', (256, 256), 4096, 64, 512, 8),
    'cartpole_256': ('dppo', 'cartpole', (256, 256), 4096, 64, 512, 8),
    # a width the first update design refused (shared memory); float32, as the
    # JAX package takes its kernel only then ('auto' picks bf16 from 512).  The
    # rollout kernel's resident design stops at (320, 320): the streamed one
    # takes it
    'pendulum_512_b512': ('ppo', 'pendulum', (512, 512), 1024, 64, 512, 8,
                          {'compute_dtype': 'float32'}),
    # the stock rollout at widths its first critic pass refused (its whole
    # critic in one block), and past the resident actor's limit (448), where
    # the streamed design takes it
    'ppo_stock_256': ('ppo', 'stock', (256, 256), 256, 128, 512, 8),
    'ppo_stock_452': ('ppo', 'stock', (452, 452), 256, 128, 512, 8),
    # past the streamed design's 16-lane groups (1408 on Pendulum in
    # float32): its 8-lane groups take it
    'pendulum_1412': ('ppo', 'pendulum', (1412, 1412), 1024, 64, 512, 8,
                      {'compute_dtype': 'float32'}),
    # past even its narrowest groups' widest square net (4832): the card raises
    'pendulum_4836': ('ppo', 'pendulum', (4836, 4836), 1024, 64, 512, 8,
                      {'compute_dtype': 'float32'}),
}
# every on-policy body at widths past the resident designs, in both compute
# types: the JAX runner takes its kernel at any width, the port its streamed
# design
WIDE = ((384, 384), (1024, 256), (1024, 1024))
WIDE_DTYPES = ('float32', 'bfloat16')
for _agent, _env, _n, _h in (('ppo', 'pendulum', 1024, 64), ('dppo', 'cartpole', 1024, 64),
                             ('ppo', 'hopper', 1024, 64), ('ppo', 'chasing', 1024, 64),
                             ('dppo', 'chasing_disc', 1024, 64), ('ppo', 'stock', 256, 128)):
    for _dims in WIDE:
        for _dt in WIDE_DTYPES:
            GRID[f'{_env}_{_dims[0]}x{_dims[1]}_{_dt}'] = (
                _agent, _env, _dims, _n, _h, 512, 8, {'compute_dtype': _dt})
PAST_STREAMED = ('pendulum_4836',)   # the card raises


def _configs(case, device='cuda'):
    agent, env, net_dims, num_envs, horizon, batch, repeat, *extra = GRID[case]
    (cls, jcls), (env_cls, jenv_cls, env_args) = AGENTS[agent], ENVS[env]
    env_args = dict({'if_discrete': False}, **env_args, num_envs=num_envs)
    out = []
    for c, a_cls, e_cls in ((Config, cls, env_cls), (JConfig, jcls, jenv_cls)):
        a = c(a_cls, e_cls, dict(env_args))
        a.net_dims, a.horizon_len, a.batch_size, a.repeat_times = net_dims, horizon, batch, repeat
        for k, v in (extra[0] if extra else {}).items():
            setattr(a, k, v)
        out.append(a)
    out[0].device = device
    return out


def _jax_decisions(case, monkeypatch):
    _, jargs = _configs(case)
    jargs.use_pallas_rollout, jargs.use_pallas_update = True, 'interpret'
    jenv = jrunner._resolve_env_def(jargs)
    jagent = jrunner._make_agent(jargs, None)
    try:
        jrunner._maybe_pallas_rollout(jargs, jenv, jagent, jargs.num_envs, jargs.horizon_len,
                                      1.0, None, None)
        raise AssertionError('a CPU backend cannot build the Mosaic kernel')
    except ValueError as e:
        rollout_kernel = 'need a real TPU' in str(e)
    calls = []

    class Taken(Exception):
        pass

    def record(*a, **k):
        calls.append(a)
        raise Taken

    monkeypatch.setattr(jpu, 'make_ppo_fused_update', record)
    H, N, S, A = (jargs.horizon_len, jargs.num_envs, jargs.state_dim, jargs.action_dim)
    f = lambda *shape: jax.ShapeDtypeStruct(shape, jnp.float32)  # noqa: E731
    # a discrete rollout stores action indices (where the JAX update runs its
    # scan, it gathers the logits with them)
    actions = (jax.ShapeDtypeStruct((H, N), jnp.int32) if jargs.if_discrete
               else f(H, N, A))
    rollout = JRollout(f(H, N, S), actions, f(H, N), f(H, N), f(H, N), f(H, N),
                       extras={'values': f(H, N)})
    state = jax.eval_shape(jagent.init, jax.random.PRNGKey(0))
    try:
        jax.eval_shape(jagent.update, state, rollout, f(N, S), jax.random.PRNGKey(1))
    except Taken:
        pass
    return rollout_kernel, bool(calls)


@pytest.mark.parametrize('case', list(GRID))
def test_kernel_choice_as_jax(case, monkeypatch):
    """Under ``device='cuda'`` nothing raises and each kernel is taken
    exactly where the JAX package takes its own."""
    jax_rollout, jax_update = _jax_decisions(case, monkeypatch)
    args, _ = _configs(case)
    chosen = []
    real = pppo.select_kernel

    def spy(a, flag, *rest, **kw):
        out = real(a, flag, *rest, **kw)
        chosen.append((flag, out))
        return out

    monkeypatch.setattr(pppo, 'select_kernel', spy)
    env = runner._resolve_env_def(args)
    for k in ('state_dim', 'action_dim', 'if_discrete'):
        setattr(args, k, getattr(env.spec, k))
    agent = runner._make_agent(args, None)
    port_update = any(out for flag, out in chosen if flag == 'use_fused_update')
    if case in PAST_STREAMED:
        assert jax_rollout and port_update == jax_update
        with pytest.raises(ValueError, match='square widths up to 4832 on Pendulum-v1'):
            runner._maybe_fused_rollout(args, env, agent, torch.device('cuda'), args.num_envs,
                                        args.horizon_len, 1.0)
        return
    fast = runner._maybe_fused_rollout(args, env, agent, torch.device('cuda'), args.num_envs,
                                       args.horizon_len, 1.0)
    assert (fast is not None, port_update) == (jax_rollout, jax_update)
    if case in ('pendulum_512_b512', 'ppo_stock_452', 'pendulum_1412') or args.net_dims in WIDE:
        # past the resident design: the streamed one takes it
        body = env.kernel_body or fr.KERNEL_ENV_BODIES[env.spec.env_name]
        bf = args.compute_dtype == 'bfloat16'
        assert jax_rollout and fast is not None
        assert fr.rollout_fits(body, args.net_dims, bf)
        assert not fr.rollout_fits_resident(body, args.net_dims, bf) or args.net_dims[0] <= 512
    if case == 'ppo_stock':
        assert jax_rollout and jax_update
    if case == 'ppo_stock_4k':
        assert jax_rollout and not jax_update
    if case == 'ppo_lunarlander_cont':
        assert not jax_rollout and jax_update
    if case in ('pendulum_256', 'cartpole_256', 'ppo_stock_256'):
        assert jax_rollout and fast is not None


OFF_PAIRS = [(a, e) for a in ('td3', 'sac', 'modsac')
             for e in ('pendulum', 'hopper', 'chasing', 'stock')]
OFF_PAIRS += [(a, e) for a in ('dqn', 'ddqn', 'duel') for e in ('cartpole', 'chasing_disc')]


@pytest.mark.parametrize('agent,env_key', OFF_PAIRS, ids=lambda x: x)
def test_offpolicy_rollout_choice_as_jax_at_wide_widths(agent, env_key):
    """The off-policy heads on every body they have, at each of ``WIDE`` in
    both compute types: the port takes its rollout kernel (the streamed
    design where the resident one does not fit) exactly where the JAX runner
    takes its own."""
    from elegantrl_tpu_torch.train.replay_buffer import ReplayBuffer
    (cls, jcls), (env_cls, jenv_cls, env_args) = AGENTS[agent], ENVS[env_key]
    n, h = (256, 32) if env_key == 'stock' else (1024, 32)
    env_args = dict({'if_discrete': False}, **env_args, num_envs=n)
    for dims in WIDE:
        for dt in WIDE_DTYPES:
            jargs = JConfig(jcls, jenv_cls, dict(env_args))
            args = Config(cls, env_cls, dict(env_args))
            for a in (args, jargs):
                a.net_dims, a.horizon_len, a.compute_dtype = dims, h, dt
            jargs.use_pallas_rollout = True
            jenv = jrunner._resolve_env_def(jargs)
            try:
                jrunner._maybe_pallas_rollout(jargs, jenv, jrunner._make_agent(jargs, None), n,
                                              h, 1.0, None, None)
                raise AssertionError('a CPU backend cannot build the Mosaic kernel')
            except ValueError as e:
                jax_rollout = 'need a real TPU' in str(e)
            args.device = 'cuda'
            env = runner._resolve_env_def(args)
            for k in ('state_dim', 'action_dim', 'if_discrete'):
                setattr(args, k, getattr(env.spec, k))
            rb = ReplayBuffer(max_size=64, state_dim=args.state_dim,
                              action_dim=1 if args.if_discrete else args.action_dim,
                              num_seqs=n, args=args, device='cpu')
            fast = runner._maybe_fused_rollout(args, env, runner._make_agent(args, rb),
                                               torch.device('cuda'), n, h, 1.0)
            assert jax_rollout and fast is not None, (dims, dt)


def test_make_ppo_three_layers_on_cuda_builds():
    args = Config()
    args.device, args.net_dims = 'cuda', (64, 64, 64)
    agent = pppo.make_ppo((64, 64, 64), 3, 1, args)
    assert agent.name == 'AgentPPO'


def _update_pair(net_dims, batch, repeat, H=16, N=16, S=5, A=2):
    """One update of the port's autograd loop and of the JAX scan, on the
    same weights, rollout and minibatch ids."""
    jargs, args = JConfig(), Config()
    for a in (jargs, args):
        a.net_dims, a.batch_size, a.repeat_times, a.learning_rate = net_dims, batch, repeat, 1e-3
        a.horizon_len = H
    args.device = 'cpu'
    jagent = JAgentPPO.make(net_dims, S, A, jargs)
    js = jax.jit(jagent.init)(jax.random.PRNGKey(0))
    rng = np.random.default_rng(1)
    items = (rng.standard_normal((H, N, S)).astype(np.float32),
             rng.standard_normal((H, N, A)).astype(np.float32),
             (-np.abs(rng.standard_normal((H, N)))).astype(np.float32),
             rng.standard_normal((H, N)).astype(np.float32),
             (rng.random((H, N)) > 0.1).astype(np.float32),
             (rng.random((H, N)) > 0.05).astype(np.float32))
    last = rng.standard_normal((N, S)).astype(np.float32)
    key = jax.random.PRNGKey(5)
    js2, jm = jax.jit(jagent.update)(js, JRollout(*[jnp.asarray(x) for x in items]),
                                     jnp.asarray(last), key)
    U = max(1, int(H * repeat / batch))
    ids = jax.jit(lambda k: jax.vmap(lambda kk: jax.random.randint(kk, (batch,), 0, H * N))(
        jax.random.split(k, U)))(key)
    agent = AgentPPO.make(net_dims, S, A, args)
    np_tree = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    s = agent.state_from_numpy(np_tree(js), 'cpu')
    s2, m = agent.update(s, Rollout(*[torch.tensor(x) for x in items]), torch.tensor(last),
                         None, ids=torch.tensor(np.asarray(ids)).long())
    return np_tree(js), np_tree(js2), jm, agent.state_to_numpy(s2), m


@pytest.mark.parametrize('net_dims,batch,repeat', [((16, 16), 2176, 2.0),
                                                   ((16, 16, 16), 128, 16.0)],
                         ids=['batch_2176', 'three_layers'])
def test_autograd_update_matches_jax_scan(net_dims, batch, repeat):
    js, js2, jm, got, m = _update_pair(net_dims, batch, repeat)
    for name in ('act', 'cri'):
        old, want = jax.tree.leaves(getattr(js, name)), jax.tree.leaves(getattr(js2, name))
        leaves = tree_leaves(getattr(got, name))
        assert len(leaves) == len(old)
        for o, a, b in zip(old, want, leaves):
            np.testing.assert_allclose(b - o, a - o, rtol=5e-3, atol=4e-7, err_msg=name)
    for k in ('obj_critic', 'obj_actor', 'obj_entropy'):
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-4, atol=1e-6)


def test_ppo_stock_round_matches_jax():
    """One round at ``ppo_stock``'s hypers, cut to 8 envs, horizon 12,
    (16, 16), a 10-day market and batch 128: the JAX round through both Pallas
    kernels in interpret mode, the port's through both plain versions."""
    from elegantrl_tpu_torch.envs import StockState
    env_args = {'env_name': 'StockTradingEnv-v2', 'num_envs': 8, 'max_step': 9,
                'state_dim': 151, 'action_dim': 15, 'if_discrete': False, 'end_idx': 10}
    H, N, B, U = 12, 8, 128, 1

    def configure(a):
        a.net_dims, a.horizon_len, a.batch_size, a.repeat_times = (16, 16), H, B, 8
        a.learning_rate, a.random_seed = 2e-4, 0
        return a

    jargs = configure(JConfig(JAgentPPO, JStockEnv, dict(env_args)))
    jargs.use_pallas_rollout = jargs.use_pallas_update = 'interpret'
    jctx = jrunner.build_training(jargs)
    jc = jctx.carry
    _, k_roll, k_upd = jax.random.split(jc.key, 3)
    kz, ku = jax.random.split(k_roll)
    noise = np.asarray(jnp.concatenate([jax.random.normal(kz, (H, 15, N), jnp.float32),
                                        jax.random.uniform(ku, (H, 17, N), jnp.float32)], 1))
    ids = np.asarray(jax.vmap(lambda k: jax.random.randint(k, (B,), 0, H * N))(
        jax.random.split(k_upd, U)))
    jc2, jm = jax.jit(jctx.round_fn)(jc, None)

    args = configure(Config(AgentPPO, StockTradingVecEnv, dict(env_args)))
    args.device = 'cpu'
    ctx = build_training(args)
    assert ctx.fused_rollout
    np_tree = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    state = ctx.agent.state_from_numpy(np_tree(jc.agent_state), 'cpu')
    old = ctx.agent.state_to_numpy(state)
    env_state = env_state_from_numpy(StockState, np_tree(jc.env_state), 'cpu')
    carry = ctx.carry._replace(agent_state=state, env_state=env_state,
                               obs=torch.tensor(np.asarray(jc.obs)))
    c2, m = ctx.round_fn(carry, noise=torch.tensor(noise), ids=torch.tensor(ids).long())
    for k in ('obj_critic', 'obj_actor', 'obj_entropy', 'exp_r'):
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-4, atol=1e-6)
    jold, jnew = np_tree(jc.agent_state), np_tree(jc2.agent_state)
    new = ctx.agent.state_to_numpy(c2.agent_state)
    for part in ('act', 'cri'):
        for a, b, ja, jb in zip(tree_leaves(getattr(new, part)), tree_leaves(getattr(old, part)),
                                jax.tree.leaves(getattr(jnew, part)),
                                jax.tree.leaves(getattr(jold, part))):
            np.testing.assert_allclose(a - b, ja - jb, rtol=5e-3, atol=4e-7)
    np.testing.assert_array_equal(c2.env_state.shares.numpy(), np.asarray(jc2.env_state.shares))
    np.testing.assert_array_equal(c2.env_state.day.numpy(), np.asarray(jc2.env_state.day))
    np.testing.assert_allclose(c2.obs.numpy(), np.asarray(jc2.obs), rtol=1e-5, atol=1e-5)


def test_train_agent_on_stock_records_cumulative_returns(tmp_path):
    """The evaluator reports the stock env's ``cumulative_returns`` (100 x
    final total asset / initial cash) in place of the summed reward: with
    the actions in the dead zone nothing trades, so each episode's return is
    its reset holdings valued at the last day's close."""
    env_args = {'env_name': 'StockTradingEnv-v2', 'num_envs': 8, 'max_step': 19,
                'state_dim': 151, 'action_dim': 15, 'if_discrete': False, 'end_idx': 20}
    args = Config(AgentPPO, StockTradingVecEnv, dict(env_args))
    args.device, args.cwd, args.net_dims = 'cpu', str(tmp_path / 'run'), (16, 16)
    args.horizon_len, args.batch_size, args.eval_times = 12, 128, 3
    args.eval_per_step, args.break_step = 96, 96
    out = train_agent(args)
    assert out['recorder'].shape[0] == 2
    assert np.all((out['recorder'][:, 1] > 50) & (out['recorder'][:, 1] < 200))
    assert os.path.isfile(os.path.join(args.cwd, 'train_carry.npz'))

    from elegantrl_tpu_torch.train.evaluator import make_eval_fn
    env = runner._resolve_env_def(args)
    returns, steps = make_eval_fn(env, lambda s, obs: torch.zeros(obs.shape[0], 15), 3, 19,
                                  'cpu')(None, torch.Generator().manual_seed(4))
    s0 = env.init(torch.Generator().manual_seed(4), 3, 'cpu')
    close = torch.from_numpy(env.kernel_body.tables.close)
    want = (close[19] * s0.shares).sum(1) + s0.amount
    np.testing.assert_allclose(returns, (want / 1e6 * 100).numpy(), rtol=1e-5)
    assert np.all(steps == 19)
