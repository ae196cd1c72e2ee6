"""The port's off-policy agents under prioritised replay and the
cumulative-return fit against the JAX package's, on the same states,
buffers and draws; and the entry point's buffer persistence.

- TD3 and DDPG with PER, one update (``update_times = 1``, the JAX package's
  own case ``tests/test_pallas_update.py:379``, where the fused path's
  chunk-start draw coincides with the scan path's): the port's scan path
  and its fused path (the CPU runs K7''s plain version) against the JAX
  scan update: parameters, the priority tree after the TD-error write, and
  the objective.
- TD3 with PER over two fused chunks (20 updates) against the JAX fused
  path (its Pallas chunk in interpret mode): the draws of a chunk are made
  against the tree at the chunk's start and the TD errors folded in after
  it, so the priorities lag as in the JAX package.
- DQN (with ``lambda_fit_cum_r`` too) and SAC with PER, four updates of the
  scan path (the JAX package keeps them off its chunks).
- ``train_agent`` with PER, ``lambda_fit_cum_r`` and ``if_save_buffer``,
  then ``continue_train`` resuming the carry with its PER tree unchanged.

The stratified uniforms and the update noise are the JAX agents' own,
drawn from ``fold_in(key, i)`` as their scan paths split it, and passed in.
The filled trees hold exactly-summable priorities.  Tolerances, as the JAX
package's own update tests: parameter updates (new - old) and Adam moments
to rtol 5e-3 (atol 4e-7), metrics to rtol 1e-4 (atol 1e-6).  The priority
tree after one update to rtol 1e-5 (atol 1e-7), as the JAX package's
scan-against-fused PER test; after several updates to rtol 1e-4 (atol
1e-6): a priority is ``td^0.6`` of a squared difference whose relative
rounding error grows where a head's value is near its label, and the
parameters it is computed from already differ by f32 rounding.
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
from elegantrl_tpu.agents.sac import make_sac as jmake_sac
from elegantrl_tpu.config import Config as JConfig
from elegantrl_tpu.train.replay_buffer import ReplayBuffer as JReplayBuffer
from elegantrl_tpu_torch import Config, build_training, train_agent
from elegantrl_tpu_torch.agents import AgentTD3
from elegantrl_tpu_torch.agents.ddpg_td3 import _make as make_ddpg_td3
from elegantrl_tpu_torch.agents.dqn import make_dqn
from elegantrl_tpu_torch.agents.sac import make_sac
from elegantrl_tpu_torch.envs import PendulumEnv
from elegantrl_tpu_torch.train.replay_buffer import ReplayBuffer
from elegantrl_tpu_torch.utils.checkpoint import tree_leaves
from elegantrl_tpu_torch.utils.jax_params import buffer_state_from_numpy

torch.set_num_threads(1)
NET_DIMS = (16, 16)
NS, HB, BATCH = 8, 40, 128
SUB = BATCH // NS


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _args(cls, repeat, **kw):
    args = cls()
    args.batch_size, args.repeat_times, args.buffer_init_size = BATCH, repeat, 16
    args.learning_rate = 1e-3
    for k, v in kw.items():
        setattr(args, k, v)
    return args


def _agent(kind, S, A, args, buffer, port):
    if kind in ('td3', 'ddpg'):
        return (make_ddpg_td3 if port else jmake_ddpg_td3)(NET_DIMS, S, A, args, buffer,
                                                           td3=kind == 'td3')
    if kind == 'sac':
        return (make_sac if port else jmake_sac)(NET_DIMS, S, A, args, buffer)
    return (make_dqn if port else jmake_dqn)(NET_DIMS, S, A, args, buffer=buffer)


def _draws(kind, key, count, A):
    """The JAX scan path's draws of ``count`` updates, from ``fold_in(key,
    i)`` split as the agent splits it: the PER uniforms ``(U, N, sub)`` and
    the update noise (None for DQN)."""
    def one(i):
        k = jax.random.fold_in(key, i)
        noise = jnp.zeros(())
        if kind in ('td3', 'ddpg'):
            k, k_noise = jax.random.split(k)
            noise = 0.1 * jax.random.normal(k_noise, (BATCH, A))
        elif kind == 'sac':
            k, k_next, k_pg = jax.random.split(k, 3)
            noise = jnp.stack([jax.random.normal(kk, (BATCH, A)) for kk in (k_next, k_pg)])
        return jax.random.uniform(k, (NS, SUB)), noise

    u, noise = jax.jit(jax.vmap(one))(jnp.arange(count))
    return torch.tensor(np.asarray(u)), None if kind == 'dqn' else torch.tensor(np.asarray(noise))


def _run(kind, repeat, jmode='scan', paths=('scan',), cum=False, key=11):
    """The JAX agent's update and the port's on each path, from the same
    state, buffer and draws."""
    discrete = kind == 'dqn'
    S, A = (4, 3) if discrete else (3, 2)
    extra = dict(if_use_per=True, lambda_fit_cum_r=0.1 if cum else 0.0,
                 replay_row_sample=False)
    jargs = _args(JConfig, repeat, use_pallas_update='interpret' if jmode == 'fused' else False,
                  **extra)
    jrb = JReplayBuffer(256, S, A, num_seqs=NS, if_use_per=True, if_discrete=discrete,
                        args=jargs)
    jagent = _agent(kind, S, A, jargs, jrb, port=False)
    js = jax.jit(jagent.init)(jax.random.PRNGKey(0))
    rng = np.random.default_rng(5)
    actions = (rng.integers(0, A, (HB, NS)).astype(np.int32) if discrete
               else rng.uniform(-1, 1, (HB, NS, A)).astype(np.float32))
    items = (rng.standard_normal((HB, NS, S)).astype(np.float32), actions,
             rng.standard_normal((HB, NS)).astype(np.float32),
             (rng.random((HB, NS)) > 0.1).astype(np.float32), np.ones((HB, NS), np.float32))
    cum_r = rng.standard_normal((HB, NS)).astype(np.float32)

    @jax.jit
    def fill(items, cum_r):
        jbuf = jrb.update(jrb.init(), items)
        # exactly-summable priorities, so the draws are non-trivial
        prob = 0.5 + jnp.arange(HB * NS, dtype=jnp.float32).reshape(HB, NS) % 7.0
        jbuf = jbuf._replace(per_tree=jrb.tree.update(
            jbuf.per_tree, jnp.arange(HB, dtype=jnp.int32), prob))
        return jrb.update_cum_rewards(jbuf, HB, cum_r) if cum else jbuf

    jbuf = fill(tuple(jnp.asarray(x) for x in items), jnp.asarray(cum_r))
    k_upd = jax.random.PRNGKey(key)
    js2, jbuf2, jm = jax.jit(jagent.update)(js, jbuf, k_upd)
    ids, noise = _draws(kind, k_upd, max(int(HB * repeat / BATCH), 1), A)
    out = {}
    for path in paths:
        args = _args(Config, repeat, device='cpu', use_fused_update=path == 'fused', **extra)
        rb = ReplayBuffer(256, S, A, num_seqs=NS, if_use_per=True, if_discrete=discrete,
                          args=args, device='cpu')
        agent = _agent(kind, S, A, args, rb, port=True)
        assert (agent.update.__name__ == 'fused_update') == (path == 'fused')
        s = agent.state_from_numpy(_np(js), 'cpu')
        buf = buffer_state_from_numpy(_np(jbuf), 'cpu')
        s2, buf2, m = agent.update(s, buf, None, ids=ids, noise=noise)
        out[path] = (agent.state_to_numpy(s2), buf2, {k: float(v) for k, v in m.items()})
    return _np(js), _np(js2), _np(jbuf2), {k: float(v) for k, v in jm.items()}, out


def _params(tree):
    names = ('act', 'act_target', 'cri', 'cri_target', 'q', 'q_target')
    return tuple(getattr(tree, n) for n in names if getattr(tree, n, None) is not None)


def _assert_like_jax(result, path, metrics=('obj_critic', 'obj_actor'), tree_tol=(1e-4, 1e-6)):
    js, js2, jbuf2, jm, out = result
    got, buf2, m = out[path]
    old, want, leaves = (jax.tree.leaves(_params(js)), jax.tree.leaves(_params(js2)),
                         tree_leaves(_params(got)))
    assert len(leaves) == len(old)
    for o, a, b in zip(old, want, leaves):
        np.testing.assert_allclose(b - o, a - o, rtol=5e-3, atol=4e-7)
    for a, b in zip(jbuf2.per_tree, buf2.per_tree):
        np.testing.assert_allclose(b.numpy(), a, rtol=tree_tol[0], atol=tree_tol[1])
    for k in metrics:
        np.testing.assert_allclose(m[k], jm[k], rtol=1e-4, atol=1e-6)


@pytest.fixture(scope='module', params=['td3', 'ddpg'])
def one_update(request):
    return _run(request.param, 3.2, paths=('scan', 'fused'))   # 40 * 3.2 / 128 = 1 update


@pytest.mark.parametrize('path', ['scan', 'fused'])
def test_per_one_update_like_jax(one_update, path):
    _assert_like_jax(one_update, path, metrics=('obj_critic',), tree_tol=(1e-5, 1e-7))


def test_per_two_fused_chunks_like_jax_fused():
    """20 updates on the fused path of both packages: the chunk-start draws,
    K7''s weighted loss and the step-by-step fold of its TD errors."""
    _assert_like_jax(_run('td3', 64.0, jmode='fused', paths=('fused',)), 'fused')


@pytest.mark.parametrize('kind', ['dqn', 'sac'])
def test_per_scan_like_jax(kind):
    """Four updates; DQN also fits the buffer's cumulative-return column
    (``lambda_fit_cum_r``)."""
    _assert_like_jax(_run(kind, 12.8, cum=kind == 'dqn', key=13), 'scan')


def test_train_agent_saves_buffer_and_resumes_tree():
    """``train_agent`` with PER, ``lambda_fit_cum_r`` and ``if_save_buffer``
    writes ``replay_buffer.npz`` and the carry; ``continue_train`` resumes
    the carry with its PER tree and cumulative-return column as saved."""
    env_args = {'env_name': 'Pendulum-v1', 'num_envs': 4, 'max_step': 200, 'state_dim': 3,
                'action_dim': 1, 'if_discrete': False}

    def args_for(cwd, resume):
        a = Config(AgentTD3, PendulumEnv, dict(env_args))
        a.device, a.net_dims, a.horizon_len, a.batch_size = 'cpu', NET_DIMS, 16, 32
        a.buffer_size, a.repeat_times, a.eval_times, a.random_seed = 128, 1.0, 1, 0
        a.eval_per_step, a.break_step, a.cwd = 64, 64, cwd
        a.if_use_per, a.lambda_fit_cum_r, a.if_save_buffer = True, 0.1, True
        a.continue_train = resume
        return a

    with tempfile.TemporaryDirectory() as cwd:
        res = train_agent(args_for(cwd, False))
        assert np.isfinite(res['max_r'])
        with np.load(os.path.join(cwd, 'replay_buffer.npz')) as d:
            leaves, cum, size = d['per_leaves'], d['cum_rewards'], int(d['size'])
        assert size == 32 and leaves.shape == (4, 128)
        assert np.all(leaves[:, :size] > 0) and np.any(leaves[:, :size] != 10.0)
        assert np.any(cum[:size] != 0)
        ctx = build_training(args_for(cwd, True))
        buf = ctx.carry.buf_state
        np.testing.assert_array_equal(ctx.rb.tree.leaves(buf.per_tree).numpy(), leaves)
        np.testing.assert_array_equal(buf.cum_rewards.numpy(), cum)
        assert buf.size == size
