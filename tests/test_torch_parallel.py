"""Env-axis data parallelism of the port (``elegantrl_tpu_torch/parallel``,
``ops/fused_rollout.py:make_sharded_fused_rollout`` and
``make_sharded_offpolicy_rollout``, the runner under a mesh) on the CPU,
with the shards on ``'cpu'``.

The JAX side of a sharded rollout is the body of its ``shard_fn``
(``pallas_rollout.py:947-949, 1337-1339``) without ``shard_map``: the
one-chip kernel in interpret mode on each shard's envs, keyed by
``fold_in(key, r)``.  Its noise (``kz, ku = split(key)``: normals ``(H, A,
n)``, then the env's uniforms) is recomputed here per shard, concatenated
along the env axis and handed to the port as the union's injected noise; the
port's shard ``r`` takes its columns.  No test calls the JAX package's
sharded wrappers or its ``build_training`` with a mesh.

Tolerances, as ``test_torch_train_round.py``: rollouts, env states and
metrics 1e-4 (the stock body's final rows rtol 1e-5 / atol 1e-3: cash and
totals near 1e6; its terminal rewards 20x, the bonus's 1 / (d (1 - gamma))
at d = 5 over the reward sum); parameter updates rtol 5e-3; the replicas
bitwise.
"""
import contextlib
import os
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elegantrl_tpu.agents import AgentPPO as JAgentPPO
from elegantrl_tpu.agents.ddpg_td3 import _make as jmake_ddpg_td3
from elegantrl_tpu.agents.ppo import make_ppo as jmake_ppo
from elegantrl_tpu.config import Config as JConfig
from elegantrl_tpu.envs import PendulumEnv as JPendulumEnv
from elegantrl_tpu.envs.pendulum import make_pendulum as jmake_pendulum
from elegantrl_tpu.envs.stock_trading import make_stock_trading as jmake_stock
from elegantrl_tpu.ops import pallas_rollout as jpr
from elegantrl_tpu.train.runner import build_training as jbuild_training
from elegantrl_tpu_torch import Config, build_training
from elegantrl_tpu_torch.agents import AgentPPO, AgentSAC
from elegantrl_tpu_torch.envs import PendulumEnv, PendulumState, StockTradingVecEnv
from elegantrl_tpu_torch.envs import stock_trading as st
from elegantrl_tpu_torch.ops import fused_rollout as fr
from elegantrl_tpu_torch.parallel import make_mesh
from elegantrl_tpu_torch.parallel.distributed import elastic_restore
from elegantrl_tpu_torch.parallel import mesh as pmesh
from elegantrl_tpu_torch.parallel.mesh import (Shards, gather_env_axis, gather_train_carry,
                                               replicate, split_env_axis)
from elegantrl_tpu_torch.train import runner
from elegantrl_tpu_torch.utils.checkpoint import tree_leaves
from elegantrl_tpu_torch.utils.jax_params import (ddpg_state_from_numpy, env_state_from_numpy,
                                                  ppo_state_from_numpy, ppo_state_to_numpy)

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NET = (16, 16)
H, N, B, RS = 32, 16, 128, 0.5
U = int(H * 8 / B)
PEND = {'env_name': 'Pendulum-v1', 'num_envs': N, 'max_step': 200, 'state_dim': 3,
        'action_dim': 1, 'if_discrete': False}


def _t(a):
    return torch.from_numpy(np.array(a))


def _mesh(n):
    return make_mesh({'dp': n}, devices=['cpu'] * n)


def _args(agent=AgentPPO, num_envs=N, **kw):
    args = Config(agent, PendulumEnv, dict(PEND, num_envs=num_envs))
    args.device, args.net_dims, args.horizon_len = 'cpu', NET, H
    args.batch_size, args.repeat_times, args.random_seed, args.reward_scale = B, 8.0, 0, RS
    if args.if_off_policy:
        args.buffer_size, args.batch_size, args.repeat_times = 512, 16, 1.0
    for k, v in kw.items():
        setattr(args, k, v)
    return args


def _jnoise(key, h, A, n_env, n):
    """The JAX wrappers' interpret-mode draws from ``key`` (on- and off-policy
    Gaussian heads alike)."""
    kz, ku = jax.random.split(key)
    return jnp.concatenate([jax.random.normal(kz, (h, A, n), jnp.float32),
                            jax.random.uniform(ku, (h, n_env, n), jnp.float32)], 1)


def _slice(tree, r, n):
    return jax.tree.map(lambda x: x[r * n:(r + 1) * n], tree)


def _cat(trees, axis):
    return jax.tree.map(lambda *xs: jnp.concatenate(xs, axis), *trees)


# ---------------------------------------------------------------- the fold

def test_fold_seed_is_the_stated_formula():
    seed = torch.tensor([-5, 2 ** 31 - 7], dtype=torch.int32)
    got = fr.fold_seed(seed, [0, 1, 2, 3]).numpy()
    for r in range(4):
        for w, m in enumerate((0x85EBCA6B, 0xC2B2AE35)):
            want = (int(seed[w]) % 2 ** 32 + (r + 1) * m) % 2 ** 32
            assert int(got[r, w]) % 2 ** 32 == want
    assert np.array_equal(fr.fold_seed(seed, 2).numpy(), got[2])
    assert len({tuple(row) for row in got.tolist()} | {tuple(seed.tolist())}) == 5
    assert (got[:, None, :] != got[None, :, :]).all(-1)[~np.eye(4, dtype=bool)].all()


@pytest.mark.parametrize('kind', ['onpolicy', 'offpolicy'])
def test_sharded_internal_draws_are_folded_launches(kind):
    """Without noise, shard ``r`` is one launch of the plain rollout on its
    envs keyed by ``fold_seed(seed, r)`` of one seed from the generator."""
    mesh = _mesh(2)
    env = jmake_pendulum()
    js = jax.vmap(env.init)(jax.random.split(jax.random.PRNGKey(9), N))
    state = env_state_from_numpy(PendulumState, jax.tree.map(np.asarray, js), 'cpu')
    if kind == 'onpolicy':
        agent = ppo_state_from_numpy(jax.tree.map(np.asarray, jmake_ppo(
            NET, 3, 1, JConfig()).init(jax.random.PRNGKey(0))), 'cpu')
        fn = fr.make_sharded_fused_rollout(fr.PENDULUM_BODY, NET, H, N, RS, mesh)

        def one(f, i, seed):
            return fr.rollout(agent.act_flat, agent.cri_flat, agent.norm_avg, agent.norm_std,
                              f, i, net_dims=NET, horizon_len=H, reward_scale=RS, seed=seed)
    else:
        agent = ddpg_state_from_numpy(jax.tree.map(np.asarray, jmake_ddpg_td3(
            NET, 3, 1, JConfig(), None, td3=True).init(jax.random.PRNGKey(0))), 'cpu')
        fn = fr.make_sharded_offpolicy_rollout(fr.PENDULUM_BODY, 'ddpg', NET, H, N, RS, mesh,
                                               noise_std=0.1, explore_rate=0.25)

        def one(f, i, seed):
            return fr.offpolicy_rollout(agent.act, f, i, body=fr.PENDULUM_BODY, head='ddpg',
                                        net_dims=NET, horizon_len=H, reward_scale=RS,
                                        noise_std=0.1, seed=seed)
    gen = torch.Generator().manual_seed(4)
    twin = torch.Generator()
    twin.set_state(gen.get_state())
    ro, env2, last = fn(agent, split_env_axis(mesh, state), gen)
    seed = torch.randint(-2 ** 31, 2 ** 31 - 1, (2,), generator=twin, dtype=torch.int32)
    assert torch.equal(gen.get_state(), twin.get_state())   # one draw a round
    n = N // 2
    for r in range(2):
        f, i = fr.PENDULUM_BODY.pack(split_env_axis(mesh, state)[r])
        out = one(f, i, fr.fold_seed(seed, r))
        cols = slice(r * n, (r + 1) * n)
        states = ro.states[..., cols] if kind == 'onpolicy' else ro.states[:, cols]
        assert torch.equal(states, out.states)
        assert torch.equal(ro.rewards[:, cols], out.rewards)
        assert torch.equal(env2[r].theta, fr.PENDULUM_BODY.unpack(out.env_f, out.env_i).theta)


@pytest.fixture
def cuda_device_stub(monkeypatch):
    """``torch.cuda.device`` replaced by a recorder: ``entered`` lists the
    devices made current, ``current[0]`` the index into it of the scope in
    force (None outside every scope)."""
    rec = {'entered': [], 'current': [None]}

    @contextlib.contextmanager
    def cuda_device(dev):
        rec['entered'].append(str(torch.device(dev)))
        before, rec['current'][0] = rec['current'][0], len(rec['entered']) - 1
        try:
            yield
        finally:
            rec['current'][0] = before

    monkeypatch.setattr(torch.cuda, 'device', cuda_device)
    return rec


def test_device_scope_makes_the_card_current(cuda_device_stub):
    with pmesh.device_scope(torch.device('cuda', 1)):
        assert cuda_device_stub['current'][0] == 0
    with pmesh.device_scope('cpu'):
        assert cuda_device_stub['current'][0] is None
    assert cuda_device_stub['entered'] == ['cuda:1']


@pytest.mark.parametrize('kind', ['onpolicy', 'offpolicy'])
def test_each_shard_launches_under_its_own_device(kind, cuda_device_stub, monkeypatch):
    """With several cards in one process, shard ``r``'s kernel is set up and
    launched with its own device current: the kernels read the current
    device (``cudaGetDevice``), and a launch on another card's stream fails.
    Here the CPU shards take the scope a card would (``device_scope`` made to
    enter the stub for every device), and each launch records the scope in
    force."""
    monkeypatch.setattr(pmesh, 'device_scope', torch.cuda.device)
    mesh = make_mesh({'dp': 2}, devices=['cpu', 'cpu'])
    name = 'rollout' if kind == 'onpolicy' else 'offpolicy_rollout'
    real, launches = getattr(fr, name), []

    def launch(*a, **k):
        launches.append(cuda_device_stub['current'][0])
        return real(*a, **k)

    monkeypatch.setattr(fr, name, launch)
    env = jmake_pendulum()
    js = jax.vmap(env.init)(jax.random.split(jax.random.PRNGKey(9), N))
    state = env_state_from_numpy(PendulumState, jax.tree.map(np.asarray, js), 'cpu')
    if kind == 'onpolicy':
        agent = ppo_state_from_numpy(jax.tree.map(np.asarray, jmake_ppo(
            NET, 3, 1, JConfig()).init(jax.random.PRNGKey(0))), 'cpu')
        fn = fr.make_sharded_fused_rollout(fr.PENDULUM_BODY, NET, 4, N, RS, mesh)
    else:
        agent = ddpg_state_from_numpy(jax.tree.map(np.asarray, jmake_ddpg_td3(
            NET, 3, 1, JConfig(), None, td3=True).init(jax.random.PRNGKey(0))), 'cpu')
        fn = fr.make_sharded_offpolicy_rollout(fr.PENDULUM_BODY, 'ddpg', NET, 4, N, RS, mesh,
                                               noise_std=0.1, explore_rate=0.25)
    fn(agent, split_env_axis(mesh, state), torch.Generator().manual_seed(4))
    assert cuda_device_stub['entered'] == ['cpu', 'cpu']
    assert launches == [0, 1]


def test_rounds_run_under_the_carrys_device(cuda_device_stub, monkeypatch):
    """``round_fn`` runs with its carry's device current (a population
    member's card, or the mesh's lead), so the update's kernels launch
    there; ``device_scope`` made to enter the stub for the CPU too."""
    monkeypatch.setattr(runner, 'device_scope', torch.cuda.device)
    seen = []
    broadcast = runner.broadcast_agent_state

    def after_the_update(*a):     # update_half's last step under a mesh
        seen.append(cuda_device_stub['current'][0])
        return broadcast(*a)

    monkeypatch.setattr(runner, 'broadcast_agent_state', after_the_update)
    ctx = build_training(_args(), mesh=_mesh(2))
    ctx.round_fn(ctx.carry)
    assert cuda_device_stub['entered'] == ['cpu'] and seen == [0]


# ------------------------------------------ sharded rollouts against JAX

def _pendulum_states():
    env = jmake_pendulum()
    js = jax.vmap(env.init)(jax.random.split(jax.random.PRNGKey(9), N))
    js = js._replace(t=jnp.where(jnp.arange(N) % 8 >= 6, 190, jnp.arange(N) * 11).astype(
        jnp.int32))   # some lanes of each shard truncate in the horizon
    return js, jax.vmap(env.obs)(js), env_state_from_numpy(
        PendulumState, jax.tree.map(np.asarray, js), 'cpu')


def _case_ppo_pendulum():
    js, jobs, state = _pendulum_states()
    jag = jmake_ppo(NET, 3, 1, JConfig()).init(jax.random.PRNGKey(0))
    agent = ppo_state_from_numpy(jax.tree.map(np.asarray, jag), 'cpu')
    local = jax.jit(jpr.make_fused_rollout(jpr.PENDULUM_BODY, NET, H, N // 2, RS,
                                           discrete=False, block=8, interpret=True))
    fn = fr.make_sharded_fused_rollout(fr.PENDULUM_BODY, NET, H, N, RS, _mesh(2))
    return dict(js=js, jobs=jobs, jag=jag, local=local, state=state, agent=agent, fn=fn,
                A=1, n_env=2, n=N // 2, onpolicy=True, body=jpr.PENDULUM_BODY, h=H)


def _case_ddpg_pendulum():
    js, jobs, state = _pendulum_states()
    jag = jmake_ddpg_td3(NET, 3, 1, JConfig(), None, td3=False).init(jax.random.PRNGKey(1))
    agent = ddpg_state_from_numpy(jax.tree.map(np.asarray, jag), 'cpu')
    cfg = {'noise_std': 0.1, 'explore_rate': 0.25, 'std_clip': (-16.0, 2.0)}
    local = jax.jit(jpr.make_fused_offpolicy_rollout(jpr.PENDULUM_BODY, NET, H, N // 2, RS,
                                                     head='ddpg', head_cfg=cfg, block=8,
                                                     interpret=True))
    fn = fr.make_sharded_offpolicy_rollout(fr.PENDULUM_BODY, 'ddpg', NET, H, N, RS, _mesh(2),
                                           **cfg)
    return dict(js=js, jobs=jobs, jag=jag, local=local, state=state, agent=agent, fn=fn,
                A=1, n_env=2, n=N // 2, onpolicy=False, body=jpr.PENDULUM_BODY, h=H)


def _case_ppo_stock():
    """64 envs, two shards of 32 (whole lane groups), 8 steps over a market
    cut to 10 days: the terminal day and a reset in the horizon."""
    n_all, h, end = 64, 8, 10
    jenv, env = jmake_stock(end_idx=end), st.make_stock_trading(end_idx=end)
    js = jax.jit(jax.vmap(jenv.init))(jax.random.split(jax.random.PRNGKey(9), n_all))
    js = js._replace(day=jnp.full((n_all,), 4, jnp.int32))
    jobs = None    # the JAX kernel reads the packed rows, not the obs
    state = env_state_from_numpy(st.StockState, jax.tree.map(np.asarray, js), 'cpu')
    jag = jmake_ppo(NET, 151, 15, JConfig()).init(jax.random.PRNGKey(0))
    agent = ppo_state_from_numpy(jax.tree.map(np.asarray, jag), 'cpu')
    local = jax.jit(jpr.make_fused_rollout(jenv.kernel_body, NET, h, n_all // 2, RS,
                                           discrete=False, block=8, interpret=True))
    fn = fr.make_sharded_fused_rollout(env.kernel_body, NET, h, n_all, RS, _mesh(2))
    return dict(js=js, jobs=jobs, jag=jag, local=local, state=state, agent=agent, fn=fn,
                A=15, n_env=17, n=n_all // 2, onpolicy=True, body=jenv.kernel_body, h=h)


CASES = {'ppo_pendulum': _case_ppo_pendulum, 'ddpg_pendulum': _case_ddpg_pendulum,
         'ppo_stock': _case_ppo_stock}


@pytest.fixture(scope='module', params=list(CASES))
def sharded(request):
    c = CASES[request.param]()
    key = jax.random.PRNGKey(21)
    outs, noises = [], []
    for r in range(2):
        k_r = jax.random.fold_in(key, r)            # shard_fn's key
        jobs_r = None if c['jobs'] is None else _slice(c['jobs'], r, c['n'])
        outs.append(c['local'](c['jag'], _slice(c['js'], r, c['n']), jobs_r, k_r))
        noises.append(_jnoise(k_r, c['h'], c['A'], c['n_env'], c['n']))
    noise = _t(jnp.concatenate(noises, 2))
    mesh = _mesh(2)
    ro, env2, last = c['fn'](c['agent'], split_env_axis(mesh, c['state']), None, noise=noise)
    axis = 1
    jro = _cat([o[0]._replace(extras=None) for o in outs], axis)
    if c['onpolicy']:   # (H, S, N) and (H, A, N): the env axis last
        jro = jro._replace(states=jnp.concatenate([o[0].states for o in outs], 2),
                           actions=jnp.concatenate([o[0].actions for o in outs], 2))
        values = jnp.concatenate([o[0].extras['values'] for o in outs], 1)
    else:
        values = None
    return dict(name=request.param, ro=ro, env2=env2, last=last, jro=jro, values=values,
                jenv=_cat([o[1] for o in outs], 0), jlast=jnp.concatenate([o[2] for o in outs]),
                stock=request.param == 'ppo_stock')


def test_sharded_rollout_matches_jax_per_shard(sharded):
    ro, jro = sharded['ro'], sharded['jro']
    for f in ('states', 'actions', 'undones', 'unmasks'):
        np.testing.assert_allclose(getattr(ro, f).float().numpy(), np.asarray(getattr(jro, f)),
                                   rtol=1e-4, atol=1e-4, err_msg=f)
    rewards, jrewards = ro.rewards.numpy(), np.asarray(jro.rewards)
    terminal = np.asarray(jro.undones) == 0
    np.testing.assert_allclose(rewards[~terminal], jrewards[~terminal], rtol=1e-4, atol=1e-4)
    # the stock body's terminal bonus is the episode's reward sum times
    # 1 / (d (1 - gamma)) = 20 at d = 5: its rounding, 20x the steps'
    np.testing.assert_allclose(rewards[terminal], jrewards[terminal], rtol=1e-4,
                               atol=20 * 1e-4 if sharded['stock'] else 1e-4)
    if sharded['values'] is not None:
        np.testing.assert_allclose(ro.logprobs.numpy(), np.asarray(jro.logprobs),
                                   rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(ro.extras['values'].numpy(), np.asarray(sharded['values']),
                                   rtol=1e-4, atol=1e-4)


def test_sharded_final_env_state_and_obs_match_jax(sharded):
    env2 = sharded['env2']
    assert isinstance(env2, Shards) and len(env2) == 2
    union = gather_env_axis(env2)
    tol = dict(rtol=1e-5, atol=1e-3) if sharded['stock'] else dict(rtol=1e-4, atol=1e-4)
    for name in type(union)._fields:
        got, want = getattr(union, name).numpy(), np.asarray(getattr(sharded['jenv'], name))
        if got.dtype.kind in 'iub':
            np.testing.assert_array_equal(got, want, err_msg=name)
        else:
            np.testing.assert_allclose(got, want, err_msg=name, **tol)
    np.testing.assert_allclose(sharded['last'].numpy(), np.asarray(sharded['jlast']), **tol)


# ------------------------------------------------ a dp = 2 round, PPO Pendulum

@pytest.fixture(scope='module')
def rounds():
    """The JAX round on the union with the per-shard draws of its sharded
    kernel replayed (the per-shard interpret kernels, concatenated, then
    ``update_from_rollout``); the port's dp = 2 and dp = 1 rounds on the
    same weights, env state and draws."""
    jargs = JConfig(JAgentPPO, JPendulumEnv, dict(PEND))
    jargs.horizon_len, jargs.net_dims, jargs.batch_size = H, NET, B
    jargs.repeat_times, jargs.random_seed, jargs.reward_scale = 8.0, 0, RS
    jargs.use_pallas_rollout = jargs.use_pallas_update = 'interpret'
    jctx = jbuild_training(jargs)
    jc = jctx.carry
    _, k_roll, _ = jax.random.split(jc.key, 3)
    local = jax.jit(jpr.make_fused_rollout(jpr.PENDULUM_BODY, NET, H, N // 2, RS,
                                           discrete=False, block=8, interpret=True))
    outs, noises = [], []
    for r in range(2):
        k_r = jax.random.fold_in(k_roll, r)
        outs.append(local(jc.agent_state, _slice(jc.env_state, r, N // 2),
                          _slice(jc.obs, r, N // 2), k_r))
        noises.append(_jnoise(k_r, H, 1, 2, N // 2))
    ro = outs[0][0]
    jro = ro._replace(**{f: jnp.concatenate([getattr(o[0], f) for o in outs],
                                            getattr(ro, f).ndim - 1)
                         for f in ('states', 'actions', 'logprobs', 'rewards', 'undones',
                                   'unmasks')},
                      extras={'values': jnp.concatenate([o[0].extras['values'] for o in outs],
                                                        1),
                              'tsn': ro.extras['tsn']})
    jlast = jnp.concatenate([o[2] for o in outs])
    jenv2 = _cat([o[1] for o in outs], 0)
    ku = jax.random.PRNGKey(77)
    ids = np.asarray(jax.vmap(lambda k: jax.random.randint(k, (B,), 0, H * N))(
        jax.random.split(jax.random.split(ku)[1], U)))
    jold = jax.tree.map(np.asarray, jc.agent_state)
    jc2, jm = jax.jit(jctx.update_from_rollout)(jc._replace(key=ku), jro, jlast)
    noise = _t(jnp.concatenate(noises, 2))

    def port(mesh):
        ctx = build_training(_args(), mesh=mesh)
        assert ctx.fused_rollout
        state = ppo_state_from_numpy(jold, 'cpu')
        env_state = env_state_from_numpy(PendulumState, jax.tree.map(np.asarray, jc.env_state),
                                         'cpu')
        obs = _t(jc.obs)
        if mesh is not None:
            env_state, obs = split_env_axis(mesh, env_state), split_env_axis(mesh, obs)
        carry = ctx.carry._replace(agent_state=state, env_state=env_state, obs=obs)
        c2, m = ctx.round_fn(carry, noise=noise.clone(), ids=_t(ids).long())
        return ctx, c2, m

    mesh = _mesh(2)
    return dict(jold=jold, jc2=jc2, jm=jm, jenv2=jenv2, jlast=jlast, mesh=mesh,
                dp2=port(mesh), dp1=port(None))


def _params(state):
    s = ppo_state_to_numpy(state)
    return tree_leaves(s.act) + tree_leaves(s.cri)


def test_dp2_round_matches_dp1_round(rounds):
    (_, c2, m2), (_, c1, m1) = rounds['dp2'], rounds['dp1']
    for k in m1:
        np.testing.assert_allclose(m2[k].numpy(), m1[k].numpy(), rtol=1e-4, atol=1e-6,
                                   err_msg=k)
    for a, b in zip(_params(c2.agent_state), _params(c1.agent_state)):
        np.testing.assert_allclose(a, b, rtol=5e-3, atol=1e-8)
    np.testing.assert_allclose(gather_env_axis(c2.obs).numpy(), c1.obs.numpy(), atol=1e-4)


def test_dp2_round_metrics_match_jax(rounds):
    _, _, m = rounds['dp2']
    for k in ('obj_critic', 'obj_actor', 'obj_entropy', 'exp_r'):
        np.testing.assert_allclose(float(m[k]), float(rounds['jm'][k]), rtol=1e-4, atol=1e-6,
                                   err_msg=k)


def test_dp2_round_parameter_updates_match_jax(rounds):
    _, c2, _ = rounds['dp2']
    jnew = jax.tree.map(np.asarray, rounds['jc2'].agent_state)
    jold = rounds['jold']
    old = ppo_state_to_numpy(ppo_state_from_numpy(jold, 'cpu'))
    new = ppo_state_to_numpy(c2.agent_state)
    for part in ('act', 'cri'):
        for a, b, ja, jb in zip(tree_leaves(getattr(new, part)), tree_leaves(getattr(old, part)),
                                tree_leaves(getattr(jnew, part)),
                                tree_leaves(getattr(jold, part))):
            np.testing.assert_allclose(a - b, ja - jb, rtol=5e-3, atol=1e-8)
    assert c2.agent_state.act_opt.count == U


def test_dp2_round_env_state_and_obs_match_jax(rounds):
    ctx, c2, _ = rounds['dp2']
    assert isinstance(c2.env_state, Shards) and isinstance(c2.obs, Shards)
    env = gather_env_axis(c2.env_state)
    np.testing.assert_allclose(env.theta.numpy(), np.asarray(rounds['jenv2'].theta), atol=1e-4)
    np.testing.assert_array_equal(env.t.numpy(), np.asarray(rounds['jenv2'].t))
    np.testing.assert_allclose(gather_env_axis(c2.obs).numpy(), np.asarray(rounds['jlast']),
                               atol=1e-4)


def test_replicas_equal_after_the_round(rounds):
    """What each shard's rollout reads after the round (the flat buffers
    and the normaliser, ``replicate``) is the updated agent state's, bitwise;
    shards that share a device share the tensors."""
    ctx, c2, _ = rounds['dp2']
    s = c2.agent_state
    lead = (s.act_flat, s.cri_flat, s.norm_avg, s.norm_std)
    replicas = replicate(rounds['mesh'], lead)
    assert len(replicas) == 2
    for rep in replicas:
        assert all(torch.equal(a, b) for a, b in zip(rep, lead))
        assert all(a is b for a, b in zip(rep, lead))


# ---------------------------------------------------------------- off-policy

def test_offpolicy_sac_dp2_trains():
    """As ``tests/test_parallel.py:43-48``: SAC under ``{'dp': 2}``, ring of
    512 rows, two rounds; the ring is held whole, filled from the union."""
    ctx = build_training(_args(AgentSAC), mesh=_mesh(2))
    assert ctx.fused_rollout
    carry = ctx.carry
    for _ in range(2):
        carry, m = ctx.round_fn(carry)
    assert np.isfinite(gather_env_axis(carry.obs).numpy()).all()
    assert carry.buf_state.size == 2 * H and carry.buf_state.states.shape[1] == N
    assert np.isfinite(float(m['obj_critic']))


# ----------------------------------------------------------- the mesh's errors

def test_mesh_num_envs_not_divisible_raises():
    mesh = make_mesh({'dp': 3}, devices=['cpu'] * 3)
    with pytest.raises(ValueError, match='use_fused_rollout=True under a mesh'):
        build_training(_args(use_fused_rollout=True), mesh=mesh)
    with pytest.raises(ValueError, match='num_envs=16 does not divide'):
        build_training(_args(), mesh=mesh)


def test_mesh_two_axes_takes_no_kernel(capsys):
    mesh = make_mesh({'dp': 2, 'mp': 2}, devices=['cpu'] * 4)
    assert mesh.size == 4 and mesh.axis_names == ('dp', 'mp')
    with pytest.raises(ValueError, match='a single mesh axis'):
        build_training(_args(use_fused_rollout=True), mesh=mesh)
    ctx = build_training(_args(), mesh=mesh)     # 'auto': the generic rollout on the union
    assert not ctx.fused_rollout
    assert 'use_fused_rollout: PyTorch path' in capsys.readouterr().out
    carry, m = ctx.round_fn(ctx.carry)
    assert len(carry.obs) == 4 and np.isfinite(float(m['obj_critic']))


def test_mesh_larger_than_the_devices_raises():
    with pytest.raises(ValueError, match=r'asks for 4 devices, the processes have 2'):
        make_mesh({'dp': 4}, devices=['cpu', 'cpu'])
    mesh = make_mesh({'dp': -1}, devices=['cpu', 'cpu'])
    assert mesh.size == 2 and mesh.shards == (0, 1) and mesh.world_size == 1
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="devices=\\['cpu'"):
            make_mesh({'dp': 2})


def test_stock_shards_must_hold_whole_lane_groups(monkeypatch):
    """A shard of 16 stock envs would part a 32-lane group: the sharded
    wrapper raises; the card raises where the JAX runner takes its kernel;
    the CPU takes the generic rollout."""
    env = st.make_stock_trading(end_idx=10)
    with pytest.raises(ValueError, match='multiple of its 32-lane group'):
        fr.make_sharded_fused_rollout(env.kernel_body, NET, 8, 32, 1.0, _mesh(2))
    args = Config(AgentPPO, StockTradingVecEnv,
                  {'env_name': 'StockTradingEnv-v2', 'num_envs': 32, 'max_step': 1112,
                   'state_dim': 151, 'action_dim': 15, 'if_discrete': False})
    args.device, args.net_dims, args.horizon_len, args.batch_size = 'cuda', NET, 8, 128
    monkeypatch.setattr(runner, 'resolve_device', lambda a: torch.device('cuda'))
    with pytest.raises(ValueError, match='use_fused_rollout: on cuda'):
        build_training(args, mesh=make_mesh({'dp': 2}, devices=['cuda', 'cuda']))


class _HostEnv:
    """A numpy env of the gym protocol (no gymnasium needed)."""

    def reset(self, seed=None, options=None):
        self.x = np.zeros(3, np.float32)
        return self.x, {}

    def step(self, action):
        self.x = self.x + 0.1
        return self.x, float(np.sum(action)), False, False, {}


def test_host_env_keeps_host_rollout_under_a_one_process_mesh():
    from elegantrl_tpu_torch.envs import EnvSpec, make_host_env
    env = make_host_env(_HostEnv, EnvSpec('HostToy-v0', 4, 200, 3, 1, False))
    args = Config(AgentPPO, env, dict(PEND, env_name='HostToy-v0', num_envs=4))
    args.device, args.net_dims, args.horizon_len, args.batch_size = 'cpu', NET, 8, 16
    ctx = build_training(args, mesh=_mesh(2))
    assert ctx.use_host_rollout and not ctx.fused_rollout
    carry = ctx.carry
    for _ in range(2):
        carry, m = ctx.round_fn(carry)
    np.testing.assert_allclose(gather_env_axis(carry.obs).numpy(), np.full((4, 3), 1.6),
                               rtol=1e-6)
    assert len(carry.obs) == 2 and np.isfinite(float(m['obj_critic']))


# --------------------------------------------------------- elastic restore

def _saved_dp2_run(tmp_path):
    ctx = build_training(_args(), mesh=_mesh(2))
    carry, _ = ctx.round_fn(ctx.carry)
    path = str(tmp_path / 'train_carry.npz')
    runner._save_carry(path, carry, ctx.agent)
    return ctx, gather_train_carry(carry), path


def _assert_same_carry(agent, a, b):
    for x, y in zip(tree_leaves(agent.state_to_numpy(a.agent_state)),
                    tree_leaves(agent.state_to_numpy(b.agent_state))):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
    for x, y in zip(tree_leaves(a.env_state), tree_leaves(b.env_state)):
        np.testing.assert_array_equal(x.numpy(), y.numpy())
    np.testing.assert_array_equal(a.obs.numpy(), b.obs.numpy())
    assert torch.equal(a.gen.get_state(), b.gen.get_state())


def test_elastic_restore_dp2_onto_dp4(tmp_path):
    ctx, saved, path = _saved_dp2_run(tmp_path)
    mesh4 = _mesh(4)
    ctx4 = build_training(_args(), mesh=mesh4)
    restored, mesh = elastic_restore(path, ctx4, {'dp': 4}, devices=['cpu'] * 4)
    assert mesh.size == 4 and len(restored.obs) == 4
    _assert_same_carry(ctx.agent, gather_train_carry(restored), saved)
    out, m = ctx4.round_fn(restored)
    assert np.isfinite(gather_env_axis(out.obs).numpy()).all()
    assert np.isfinite(float(m['obj_critic']))
    with pytest.raises(ValueError, match='not built with'):
        build_training(_args()).round_fn(restored)


def test_dp2_carry_restores_without_a_mesh(tmp_path):
    ctx, saved, path = _saved_dp2_run(tmp_path)
    args = _args(continue_train=True, cwd=str(tmp_path))
    plain = build_training(args)
    _assert_same_carry(ctx.agent, plain.carry, saved)
    out, m = plain.round_fn(plain.carry)
    assert np.isfinite(out.obs.numpy()).all() and np.isfinite(float(m['obj_critic']))


# ----------------------------------------------- two processes through gloo
# Each rank is a subprocess; a rank passes when it prints WORKER-OK and
# exits with 0.  Under six busy test workers a rank once printed WORKER-OK
# and then aborted in the interpreter's teardown ("terminate called without
# an active exception", rc -6): its gloo group was still live.
# init_distributed now registers shutdown_distributed at exit
# (test_init_distributed_tears_the_group_down_at_exit).

RANK_TIMEOUT = 240   # seconds for both ranks together; ~11 s on a loaded box


def _run_ranks(code, argvs, env):
    procs = [subprocess.Popen([sys.executable, '-c', code, *argv], cwd=ROOT, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for argv in argvs]
    outs, deadline = [], time.monotonic() + RANK_TIMEOUT
    try:
        for r, p in enumerate(procs):
            try:
                outs.append(p.communicate(timeout=max(deadline - time.monotonic(), 1.0))[0])
            except subprocess.TimeoutExpired:
                for q in procs:
                    q.kill()
                tails = [q.communicate()[0][-1500:] for q in procs]
                raise AssertionError(f'rank {r} still ran after {RANK_TIMEOUT} s; output:\n'
                                     + '\n'.join(f'rank {i}:\n{t}' for i, t in enumerate(tails)))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0 and 'WORKER-OK' in out, \
            f'rank {r} (rc {p.returncode}):\n{out[-3000:]}'


_EXIT_WORKER = r"""
import atexit, sys
import torch.distributed as dist
from elegantrl_tpu_torch.parallel.distributed import init_distributed
assert init_distributed(sys.argv[1], 1, 0, backend='gloo') == 1 and dist.is_initialized()
atexit._run_exitfuncs()      # what the interpreter runs at exit, before its teardown
print('WORKER-OK' if not dist.is_initialized() else 'the group is still live', flush=True)
"""


def test_init_distributed_tears_the_group_down_at_exit(tmp_path):
    """Fault 17's cause: the group must be destroyed by the exit hooks, while
    the interpreter still runs, not left to its teardown."""
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.environ.get('PYTHONPATH', ''))
    _run_ranks(_EXIT_WORKER, [['file://' + str(tmp_path / 'rendezvous')]], env)


_WORKER = r"""
import sys
import numpy as np
import torch
from elegantrl_tpu_torch import Config, build_training, train_agent
from elegantrl_tpu_torch.agents import AgentPPO
from elegantrl_tpu_torch.envs import PendulumEnv
from elegantrl_tpu_torch.parallel import make_mesh
from elegantrl_tpu_torch.parallel.distributed import init_distributed
from elegantrl_tpu_torch.parallel.mesh import gather_env_axis
from elegantrl_tpu_torch.utils.checkpoint import tree_leaves

torch.set_num_threads(1)
rank, world, url, out, cwd = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4], sys.argv[5]
assert init_distributed(url, world, rank, backend='gloo') == world
PEND = {'env_name': 'Pendulum-v1', 'num_envs': 16, 'max_step': 200, 'state_dim': 3,
        'action_dim': 1, 'if_discrete': False}
args = Config(AgentPPO, PendulumEnv, dict(PEND))
args.device, args.net_dims, args.horizon_len, args.batch_size = 'cpu', (16, 16), 32, 128
args.repeat_times, args.random_seed, args.reward_scale = 8.0, 0, 0.5
mesh = make_mesh({'dp': 2}, devices=['cpu'])
assert mesh.shards == (rank,) and mesh.world_size == world
ctx = build_training(args, mesh=mesh)
rng = np.random.default_rng(5)
noise = torch.from_numpy(np.concatenate([rng.standard_normal((32, 1, 16)),
                                         rng.uniform(size=(32, 2, 16))], 1).astype(np.float32))
ids = torch.from_numpy(rng.integers(0, 32 * 16, (2, 128)))
carry, m1 = ctx.round_fn(ctx.carry, noise=noise, ids=ids)
carry, m2 = ctx.round_fn(carry)        # the folded internal draws
leaves = [np.asarray(x) for x in tree_leaves(ctx.agent.state_to_numpy(carry.agent_state))]
np.savez(out, obs=gather_env_axis(carry.obs).numpy(), m1=m1['obj_critic'].numpy(),
         m2=m2['obj_critic'].numpy(), *leaves)
args.mesh_axes, args.cwd = {'dp': 2}, cwd
args.eval_per_step, args.break_step, args.eval_times = 32 * 16, 32 * 16, 2
res = train_agent(args)
print('WORKER-OK', rank, res['total_step'], flush=True)
"""


def test_two_gloo_processes_match_the_in_process_round(tmp_path):
    url = 'file://' + str(tmp_path / 'rendezvous')
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.environ.get('PYTHONPATH', ''))
    env.pop('LOCAL_RANK', None)
    _run_ranks(_WORKER, [[str(r), '2', url, str(tmp_path / f'rank{r}.npz'),
                          str(tmp_path / 'run')] for r in range(2)], env)
    ranks = [np.load(tmp_path / f'rank{r}.npz') for r in range(2)]
    for k in ranks[0].files:               # the replicas, bitwise
        np.testing.assert_array_equal(ranks[0][k], ranks[1][k], err_msg=k)
    # the in-process dp = 2 round on the same draws
    ctx = build_training(_args(), mesh=_mesh(2))
    rng = np.random.default_rng(5)
    noise = torch.from_numpy(np.concatenate([rng.standard_normal((H, 1, N)),
                                             rng.uniform(size=(H, 2, N))], 1).astype(np.float32))
    ids = torch.from_numpy(rng.integers(0, H * N, (2, B)))
    carry, m1 = ctx.round_fn(ctx.carry, noise=noise, ids=ids)
    carry, m2 = ctx.round_fn(carry)
    np.testing.assert_allclose(ranks[0]['m1'], m1['obj_critic'].numpy(), rtol=1e-4)
    np.testing.assert_allclose(ranks[0]['m2'], m2['obj_critic'].numpy(), rtol=1e-4)
    np.testing.assert_allclose(ranks[0]['obs'], gather_env_axis(carry.obs).numpy(), atol=1e-4)
    leaves = [np.asarray(x) for x in tree_leaves(ctx.agent.state_to_numpy(carry.agent_state))]
    for i, want in enumerate(leaves):
        np.testing.assert_allclose(ranks[0][f'arr_{i}'], want, rtol=5e-3, atol=1e-6)
    # rank 0 alone wrote the run's files, the carry in the union's layout
    saved = np.load(tmp_path / 'run' / 'train_carry.npz')
    assert any(v.shape == (N, 3) for v in (saved[k] for k in saved.files))
    assert (tmp_path / 'run' / 'agent.npz').is_file()


# ------------------------- a host env under two processes (fault 15 repaired)
# Each process's pool holds its shard's envs, seeded as in the one-process
# layout (env i from seed + i): the seeded first obs show each process built
# the right envs.  The continuous agent takes its rows of the union's normals,
# so the two processes give the in-process dp = 2 host round bitwise.

_SEEDED_HOST_ENV = r"""
import numpy as np


class SeededHostEnv:
    '''A numpy env of the gym protocol whose first obs shows its seed.'''

    def reset(self, seed=None, options=None):
        if seed is not None:
            self.x0 = np.array([0.01 * seed, -0.02 * seed, 0.5], np.float32)
        self.x = self.x0.copy()
        return self.x, {}

    def step(self, action):
        a = float(np.sum(action))
        self.x = (self.x * 0.9 + np.array([a, -a, 0.1], np.float32)).astype(np.float32)
        return self.x, -float(np.sum(np.square(self.x))), False, False, {}
"""
exec(_SEEDED_HOST_ENV)   # SeededHostEnv, the same code as the workers'

_HOST_ARGS = dict(num_envs=4, net=(16, 16), horizon=8, batch=16, seed=3)

_HOST_WORKER = _SEEDED_HOST_ENV + r"""
import sys
import torch
from elegantrl_tpu_torch import Config, build_training
from elegantrl_tpu_torch.agents import AgentPPO
from elegantrl_tpu_torch.envs import EnvSpec, make_host_env
from elegantrl_tpu_torch.parallel import make_mesh
from elegantrl_tpu_torch.parallel.distributed import init_distributed
from elegantrl_tpu_torch.parallel.mesh import gather_env_axis
from elegantrl_tpu_torch.utils.checkpoint import tree_leaves

torch.set_num_threads(1)
rank, url, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
assert init_distributed(url, 2, rank, backend='gloo') == 2
env = make_host_env(SeededHostEnv, EnvSpec('SeededHost-v0', 3, 200, 3, 1, False))
args = Config(AgentPPO, env, {'env_name': 'SeededHost-v0', 'num_envs': 4, 'max_step': 200,
                              'state_dim': 3, 'action_dim': 1, 'if_discrete': False})
args.device, args.net_dims, args.horizon_len, args.batch_size = 'cpu', (16, 16), 8, 16
args.random_seed = 3
ctx = build_training(args, mesh=make_mesh({'dp': 2}, devices=['cpu']))
assert ctx.use_host_rollout and env.host_pool.offset == 2 * rank
first = gather_env_axis(ctx.carry.obs).numpy()
rng = np.random.default_rng(7)
noise = torch.from_numpy(rng.standard_normal((8, 4, 1)).astype(np.float32))
ids = torch.from_numpy(rng.integers(0, 8 * 4, (4, 16)))
carry, m1 = ctx.round_fn(ctx.carry, noise=noise, ids=ids)
carry, m2 = ctx.round_fn(carry)        # the union's normals from the round's generator
leaves = [np.asarray(x) for x in tree_leaves(ctx.agent.state_to_numpy(carry.agent_state))]
np.savez(out, first=first, obs=gather_env_axis(carry.obs).numpy(),
         m1=np.array([float(v) for k, v in sorted(m1.items())]),
         m2=np.array([float(v) for k, v in sorted(m2.items())]), *leaves)
env.host_pool.close()
print('WORKER-OK', rank, flush=True)
"""


def test_two_gloo_processes_with_a_host_env_match_the_in_process_round(tmp_path):
    url = 'file://' + str(tmp_path / 'rendezvous')
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.environ.get('PYTHONPATH', ''))
    env.pop('LOCAL_RANK', None)
    _run_ranks(_HOST_WORKER, [[str(r), url, str(tmp_path / f'rank{r}.npz')] for r in range(2)],
               env)
    ranks = [np.load(tmp_path / f'rank{r}.npz') for r in range(2)]
    for k in ranks[0].files:               # the replicas, bitwise
        np.testing.assert_array_equal(ranks[0][k], ranks[1][k], err_msg=k)
    # the in-process dp = 2 host round (one pool of all 4 envs) on the same draws
    from elegantrl_tpu_torch.envs import EnvSpec, make_host_env
    host = make_host_env(SeededHostEnv, EnvSpec('SeededHost-v0', 3, 200, 3, 1, False))
    args = Config(AgentPPO, host, {'env_name': 'SeededHost-v0', 'num_envs': 4,
                                   'max_step': 200, 'state_dim': 3, 'action_dim': 1,
                                   'if_discrete': False})
    args.device, args.net_dims, args.horizon_len, args.batch_size = 'cpu', (16, 16), 8, 16
    args.random_seed = 3
    ctx = build_training(args, mesh=_mesh(2))
    assert ctx.use_host_rollout and host.host_pool.offset == 0
    # the seeds of the one-process layout: env i reset from seed + i
    np.testing.assert_array_equal(ranks[0]['first'], gather_env_axis(ctx.carry.obs).numpy())
    np.testing.assert_array_equal(ranks[0]['first'][:, 0], 0.01 * np.arange(4, dtype=np.float32))
    rng = np.random.default_rng(7)
    noise = torch.from_numpy(rng.standard_normal((8, 4, 1)).astype(np.float32))
    ids = torch.from_numpy(rng.integers(0, 8 * 4, (4, 16)))
    carry, m1 = ctx.round_fn(ctx.carry, noise=noise, ids=ids)
    carry, m2 = ctx.round_fn(carry)
    np.testing.assert_array_equal(ranks[0]['obs'], gather_env_axis(carry.obs).numpy())
    for name, m in (('m1', m1), ('m2', m2)):
        np.testing.assert_array_equal(ranks[0][name],
                                      np.array([float(v) for k, v in sorted(m.items())]))
    leaves = [np.asarray(x) for x in tree_leaves(ctx.agent.state_to_numpy(carry.agent_state))]
    for i, want in enumerate(leaves):
        np.testing.assert_array_equal(ranks[0][f'arr_{i}'], want)
