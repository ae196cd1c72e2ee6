"""The port's off-policy agents (``agents/dqn.py``, ``agents/ddpg_td3.py``)
against the JAX package's on the same states, buffers and draws.

- Each agent's update, the scan path and the chunked path (the CPU runs the
  chunk's plain version), against the JAX agent's scan update: 20 updates
  (40 rows x 8 envs, batch 128, repeat 64), so the chunked path crosses a
  chunk boundary; the minibatch rows and TD3's smoothing noise are the JAX
  agent's own, drawn from ``fold_in(key, i)`` (DDPG/TD3: ``split`` of it
  into a sample key and a noise key) and passed in.  This holds the update
  count, TD3's delay and Adam counts and DDPG's warm-up gate.
- One whole round on the CPU for TD3 on HopperSlip (iid sampling) and DQN on
  CartPole (row sampling) against the JAX round (rollout kernel in
  interpret mode, scan update), from the same carry and the same draws.
- ``train_agent`` for two periods, the kernel-selection rule, and the
  checkpoint round trip of ``DQNState``, ``DDPGState`` and ``BufferState``
  in the JAX leaf order.

Tolerances, as the JAX package's own update tests: parameter and target
updates (new - old) and Adam moments to rtol 5e-3 (atol 4e-7), metrics to
rtol 1e-4 (atol 1e-6); rollouts and buffers 1e-5.
"""
import os
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elegantrl_tpu.agents.ddpg_td3 import _make as jmake_ddpg_td3
from elegantrl_tpu.agents.dqn import make_dqn as jmake_dqn
from elegantrl_tpu.config import Config as JConfig
from elegantrl_tpu.envs import CartPoleEnv as JCartPoleEnv, HopperEnv as JHopperEnv
from elegantrl_tpu.ops.pallas_update import _adam_parts
from elegantrl_tpu.train.replay_buffer import ReplayBuffer as JReplayBuffer
from elegantrl_tpu.train.runner import build_training as jbuild_training
from elegantrl_tpu_torch import Config, build_training, train_agent
from elegantrl_tpu_torch.agents import AgentDDPG, AgentDoubleDQN, AgentDQN, AgentTD3
from elegantrl_tpu_torch.agents.ddpg_td3 import _make as make_ddpg_td3
from elegantrl_tpu_torch.agents.dqn import make_dqn
from elegantrl_tpu_torch.envs import CartPoleEnv, CartPoleState, HopperEnv, HopperState
from elegantrl_tpu_torch.train.replay_buffer import ReplayBuffer
from elegantrl_tpu_torch.utils.checkpoint import load_tree, save_tree, tree_leaves
from elegantrl_tpu_torch.utils.jax_params import (buffer_state_from_numpy,
                                                  buffer_state_to_numpy, env_state_from_numpy)

torch.set_num_threads(1)
NET_DIMS = (16, 16)
NS, HB, BATCH, REPEAT = 8, 40, 128, 64.0     # 40 * 64 / 128 = 20 updates
KINDS = {'dqn': (False, False), 'doubledqn': (True, False), 'duelingdqn': (False, True),
         'd3qn': (True, True), 'ddpg': False, 'td3': True}


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _make(kind, S, A, args, buffer, port):
    flags = KINDS[kind]
    if isinstance(flags, tuple):
        return (make_dqn if port else jmake_dqn)(NET_DIMS, S, A, args, twin=flags[0],
                                                 duel=flags[1], buffer=buffer)
    return (make_ddpg_td3 if port else jmake_ddpg_td3)(NET_DIMS, S, A, args, buffer, td3=flags)


def _args(cls, **kw):
    args = cls()
    args.batch_size, args.repeat_times, args.buffer_init_size = BATCH, REPEAT, 16
    args.learning_rate = 1e-3
    for k, v in kw.items():
        setattr(args, k, v)
    return args


@pytest.fixture(scope='module', params=list(KINDS))
def updates(request):
    kind = request.param
    discrete = isinstance(KINDS[kind], tuple)
    S, A = (4, 3) if discrete else (3, 2)
    jargs = _args(JConfig, use_pallas_update=False)
    jrb = JReplayBuffer(256, S, A, num_seqs=NS, if_discrete=discrete, args=jargs)
    jagent = _make(kind, S, A, jargs, jrb, port=False)
    js = jagent.init(jax.random.PRNGKey(0))
    rng = np.random.default_rng(5)
    actions = (rng.integers(0, A, (HB, NS)).astype(np.int32) if discrete
               else rng.uniform(-1, 1, (HB, NS, A)).astype(np.float32))
    items = (rng.standard_normal((HB, NS, S)).astype(np.float32), actions,
             rng.standard_normal((HB, NS)).astype(np.float32),
             (rng.random((HB, NS)) > 0.1).astype(np.float32), np.ones((HB, NS), np.float32))
    jbuf = jrb.update(jrb.init(), tuple(jnp.asarray(x) for x in items))
    k_upd = jax.random.PRNGKey(11)
    js2, _, jm = jax.jit(jagent.update)(js, jbuf, k_upd)
    # the JAX agent's draws: R = B / NS whole rows per update (row sampling)
    sample_len = HB - 1
    rows, noise = [], []
    for i in range(20):
        k = jax.random.fold_in(k_upd, i)
        if not discrete:
            k, k_noise = jax.random.split(k)
            noise.append(0.1 * jax.random.normal(k_noise, (BATCH, A)))
        rows.append(jax.random.randint(k, (BATCH // NS,), 0, sample_len))
    rows = torch.tensor(np.asarray(jnp.stack(rows))).long()
    noise = torch.tensor(np.asarray(jnp.stack(noise))) if noise else None
    out = {}
    for path in ('scan', 'chunk'):
        args = _args(Config, device='cpu', use_fused_update=path == 'chunk')
        rb = ReplayBuffer(256, S, A, num_seqs=NS, if_discrete=discrete, device='cpu')
        agent = _make(kind, S, A, args, rb, port=True)
        s = agent.state_from_numpy(_np(js), 'cpu')
        buf = buffer_state_from_numpy(_np(jbuf), 'cpu')
        s2, _, m = agent.update(s, buf, None, ids=rows, noise=noise)
        out[path] = (agent.state_to_numpy(s2), {k: float(v) for k, v in m.items()})
    return kind, _np(js), _np(js2), {k: float(v) for k, v in jm.items()}, out


def _params(kind, tree):
    if isinstance(KINDS[kind], tuple):
        return tree.q, tree.q_target
    return tree.act, tree.act_target, tree.cri, tree.cri_target


def _opts(kind, tree):
    return (tree.opt,) if isinstance(KINDS[kind], tuple) else (tree.act_opt, tree.cri_opt)


@pytest.mark.parametrize('path', ['scan', 'chunk'])
def test_update_params_like_jax(updates, path):
    kind, js, js2, _, out = updates
    got = out[path][0]
    for old, a, b in zip(jax.tree.leaves(_params(kind, js)), jax.tree.leaves(_params(kind, js2)),
                         tree_leaves(_params(kind, got))):
        np.testing.assert_allclose(b - old, a - old, rtol=5e-3, atol=4e-7)


@pytest.mark.parametrize('path', ['scan', 'chunk'])
def test_update_adam_like_jax(updates, path):
    kind, _, js2, _, out = updates
    got = out[path][0]
    for jopt, opt in zip(_opts(kind, js2), _opts(kind, got)):
        count, mu, nu = _adam_parts(jopt)
        adam = opt[1][0]
        assert int(adam.count) == int(count)
        for a, b in zip(jax.tree.leaves((mu, nu)), tree_leaves((adam.mu, adam.nu))):
            np.testing.assert_allclose(b, a, rtol=5e-3, atol=4e-7)
    # 20 updates: TD3's actor takes every second one, DDPG's all of them
    counts = [int(_adam_parts(o)[0]) for o in _opts(kind, js2)]
    assert counts == {'td3': [10, 20], 'ddpg': [20, 20]}.get(kind, [20])


@pytest.mark.parametrize('path', ['scan', 'chunk'])
def test_update_metrics_like_jax(updates, path):
    _, _, _, jm, out = updates
    for k in ('obj_critic', 'obj_actor'):
        np.testing.assert_allclose(out[path][1][k], jm[k], rtol=1e-4, atol=1e-6)


# ------------------------------------------------------------ whole rounds

H, N = 8, 16
ROUND_CASES = {
    'td3_hopper': (AgentTD3, HopperEnv, HopperState,
                   {'env_name': 'HopperSlip-v0', 'num_envs': N, 'max_step': 1000,
                    'state_dim': 6, 'action_dim': 2, 'if_discrete': False},
                   dict(replay_row_sample=False)),
    'dqn_cartpole': (AgentDQN, CartPoleEnv, CartPoleState,
                     {'env_name': 'CartPole-v1', 'num_envs': N, 'max_step': 500,
                      'state_dim': 4, 'action_dim': 2, 'if_discrete': True}, {}),
}
JCLASSES = {'AgentTD3': ('AgentTD3', JHopperEnv), 'AgentDQN': ('AgentDQN', JCartPoleEnv)}


def _round_args(cls, agent_class, env_class, env_args, extra):
    args = cls(agent_class, env_class, dict(env_args))
    args.net_dims, args.horizon_len, args.batch_size = NET_DIMS, H, BATCH
    args.repeat_times, args.buffer_size, args.random_seed = 48.0, 64, 0   # 3 updates
    args.reward_scale, args.buffer_init_size = 0.5, 16
    for k, v in extra.items():
        setattr(args, k, v)
    return args


@pytest.fixture(scope='module', params=list(ROUND_CASES))
def rounds(request):
    import elegantrl_tpu.agents as jagents
    agent_class, env_class, state_class, env_args, extra = ROUND_CASES[request.param]
    jname, jenv = JCLASSES[agent_class.__name__]
    jargs = _round_args(JConfig, getattr(jagents, jname), jenv, env_args, extra)
    jargs.use_pallas_rollout, jargs.use_pallas_update = 'interpret', False
    jctx = jbuild_training(jargs)
    jc = jctx.carry
    _, k_roll, k_upd = jax.random.split(jc.key, 3)
    S, A = env_args['state_dim'], env_args['action_dim']
    discrete = env_args['if_discrete']
    body = jctx.env.kernel_body if getattr(jctx.env, 'kernel_body', None) else None
    from elegantrl_tpu.ops.pallas_rollout import KERNEL_ENV_BODIES
    body = body or KERNEL_ENV_BODIES[env_args['env_name']]
    n_env = body.n_step + body.n_reset
    if discrete:
        noise = jax.random.uniform(k_roll, (H, 2 + n_env, N), jnp.float32)
    else:
        kz, ku = jax.random.split(k_roll)
        noise = jnp.concatenate([jax.random.normal(kz, (H, A, N), jnp.float32),
                                 jax.random.uniform(ku, (H, n_env, N), jnp.float32)], axis=1)
    jc2, jm = jax.jit(jctx.round_fn)(jc, None)
    # the update's draws: iid ids (TD3) or rows (DQN) from fold_in(k_upd, i)
    ids, unoise = [], []
    for i in range(3):
        k = jax.random.fold_in(k_upd, i)
        if not discrete:
            k, k_noise = jax.random.split(k)
            unoise.append(0.1 * jax.random.normal(k_noise, (BATCH, A)))
        ids.append(jax.random.randint(k, (BATCH // N,), 0, H - 1) if discrete
                   else jax.random.randint(k, (BATCH,), 0, (H - 1) * N))
    args = _round_args(Config, agent_class, env_class, env_args, extra)
    args.device = 'cpu'
    ctx = build_training(args)
    carry = ctx.carry._replace(
        agent_state=ctx.agent.state_from_numpy(_np(jc.agent_state), 'cpu'),
        env_state=env_state_from_numpy(state_class, _np(jc.env_state), 'cpu'))
    carry2, m = ctx.round_fn(
        carry, noise=torch.tensor(np.asarray(noise)),
        ids=torch.tensor(np.asarray(jnp.stack(ids))).long(),
        update_noise=torch.tensor(np.asarray(jnp.stack(unoise))) if unoise else None)
    jm = {k: float(v) for k, v in jm.items() if k != 'action_hist'}
    return (_np(jc.agent_state), _np(jc2._replace(key=None)), jm,
            ctx.agent.state_to_numpy(carry2.agent_state), carry2, m)


def test_round_buffer_like_jax(rounds):
    _, jc2, _, _, carry2, _ = rounds
    got = buffer_state_to_numpy(carry2.buf_state)
    for name in ('states', 'actions', 'rewards', 'undones', 'unmasks'):
        np.testing.assert_allclose(getattr(got, name), getattr(jc2.buf_state, name), rtol=0,
                                   atol=1e-5, err_msg=name)
    assert int(got.size) == int(jc2.buf_state.size) == H


def test_round_update_like_jax(rounds):
    js, jc2, jm, got, _, m = rounds
    for old, a, b in zip(jax.tree.leaves(js), jax.tree.leaves(jc2.agent_state),
                         tree_leaves(got)):
        np.testing.assert_allclose(b - old, a - old, rtol=5e-3, atol=1e-6)
    for k in ('obj_critic', 'obj_actor', 'exp_r'):
        np.testing.assert_allclose(float(m[k]), jm[k], rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize('agent_class,batch', [(AgentDoubleDQN, 64), (AgentDDPG, 128)])
def test_train_agent_two_periods(agent_class, batch):
    env_class, env_args = ((CartPoleEnv, ROUND_CASES['dqn_cartpole'][3])
                           if agent_class is AgentDoubleDQN
                           else (HopperEnv, ROUND_CASES['td3_hopper'][3]))
    with tempfile.TemporaryDirectory() as cwd:
        args = _round_args(Config, agent_class, env_class, env_args, {})
        args.device, args.cwd, args.batch_size, args.eval_times = 'cpu', cwd, batch, 2
        args.if_save_buffer = True     # an off-policy run writes its carry when resumable
        args.eval_per_step = H * N
        args.break_step = H * N
        res = train_agent(args)
        assert res['recorder'].shape[0] == 2 and np.isfinite(res['recorder'][:, 1:]).all()
        assert os.path.isfile(os.path.join(cwd, 'agent.npz'))
        args.continue_train = True     # resumes agent, buffer, env and generator
        ctx = build_training(args)
        assert ctx.carry.buf_state.size == 2 * H


# --------------------------------------------------------- kernel selection

@pytest.mark.parametrize('kind', ['dqn', 'td3'])
def test_selection_rule(kind, capsys):
    """Batch 64 is outside the JAX package's chunk: the PyTorch update on
    either device, said so.  Batch 128 on a card with the kernel refused
    raises; a kernel asked for outside the JAX scope raises too."""
    S, A = (4, 2) if kind == 'dqn' else (6, 2)
    rb = ReplayBuffer(64, S, A, num_seqs=N, if_discrete=kind == 'dqn', device='cpu')
    for device in ('cpu', 'cuda'):
        _make(kind, S, A, _args(Config, device=device, batch_size=64), rb, port=True)
        assert 'use_fused_update: PyTorch path' in capsys.readouterr().out
    _make(kind, S, A, _args(Config, device='cuda'), rb, port=True)      # takes the kernel
    assert 'PyTorch path' not in capsys.readouterr().out
    with pytest.raises(ValueError, match='use_fused_update=False .* CPU only'):
        _make(kind, S, A, _args(Config, device='cuda', use_fused_update=False), rb, port=True)
    with pytest.raises(ValueError, match='use_fused_update=True requires'):
        _make(kind, S, A, _args(Config, device='cpu', batch_size=64, use_fused_update=True),
              rb, port=True)


# ------------------------------------------------------------- checkpoints

@pytest.mark.parametrize('kind', list(KINDS))
def test_checkpoint_round_trip(kind):
    """JAX state -> numpy -> port -> numpy keeps JAX's leaves in JAX's order,
    and an npz written by ``save_tree`` loads back into the same state."""
    discrete = isinstance(KINDS[kind], tuple)
    S, A = (4, 3) if discrete else (3, 2)
    js = _np(_make(kind, S, A, JConfig(), None, port=False).init(jax.random.PRNGKey(3)))
    agent = _make(kind, S, A, _args(Config, device='cpu'), None, port=True)
    tree = agent.state_to_numpy(agent.state_from_numpy(js, 'cpu'))
    for a, b in zip(jax.tree.leaves(js), tree_leaves(tree), strict=True):
        np.testing.assert_array_equal(b, a)
    with tempfile.TemporaryDirectory() as d:
        save_tree(os.path.join(d, 'agent.npz'), tree)
        back = agent.state_from_numpy(load_tree(os.path.join(d, 'agent.npz'), tree), 'cpu')
    for a, b in zip(jax.tree.leaves(js), tree_leaves(agent.state_to_numpy(back))):
        np.testing.assert_array_equal(b, a)


def test_buffer_checkpoint_round_trip():
    jrb = JReplayBuffer(12, 3, 2, num_seqs=4, args=JConfig())
    rng = np.random.default_rng(0)
    items = tuple(jnp.asarray(x) for x in (rng.standard_normal((5, 4, 3)),
                                           rng.standard_normal((5, 4, 2)),
                                           rng.standard_normal((5, 4)), np.ones((5, 4)),
                                           np.ones((5, 4))))
    jbuf = _np(jrb.update(jrb.init(), items))
    tree = buffer_state_to_numpy(buffer_state_from_numpy(jbuf, 'cpu'))
    for a, b in zip(jax.tree.leaves(jbuf), tree_leaves(tree), strict=True):
        np.testing.assert_array_equal(b, a)
