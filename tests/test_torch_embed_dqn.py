"""The port's ``AgentEmbedDQN`` and ``AgentEnsembleDQN``
(``elegantrl_tpu_torch/agents/embed_dqn.py``) against the JAX package's.

- Four updates of each class against the JAX agent's scan update, from the
  same state and buffer, with the JAX agent's own draws passed in: whole
  time rows for ``AgentEnsembleDQN``, prioritised replay's stratified
  uniforms for ``AgentEmbedDQN`` (and its priority tree after the
  TD-error writes).
- ``cum_returns`` on the same rollout, and the JAX leaf order of both
  states through the checkpoint converters.
- ``train_agent`` on the CPU: the update and the rollout are PyTorch ops
  (no kernel in either package), said so.

Tolerances, as the JAX package's own update tests: parameter updates (new -
old) and Adam moments to rtol 5e-3 (atol 4e-7), metrics to rtol 1e-4 (atol
1e-6), the priority tree to rtol 1e-4 (atol 1e-6) (``td^0.6`` of squared
differences, see ``tests/test_torch_per_agents.py``), returns to 1e-5
relative.
"""
import contextlib
import io
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elegantrl_tpu.agents.base import Rollout as JRollout
from elegantrl_tpu.agents.embed_dqn import make_embed_dqn as jmake_embed_dqn
from elegantrl_tpu.config import Config as JConfig
from elegantrl_tpu.ops.pallas_update import _adam_parts
from elegantrl_tpu.train.replay_buffer import ReplayBuffer as JReplayBuffer
from elegantrl_tpu_torch import Config, train_agent
from elegantrl_tpu_torch.agents import AgentEmbedDQN, AgentEnsembleDQN
from elegantrl_tpu_torch.agents.base import Rollout
from elegantrl_tpu_torch.agents.embed_dqn import make_embed_dqn
from elegantrl_tpu_torch.envs import CartPoleEnv
from elegantrl_tpu_torch.train.replay_buffer import ReplayBuffer
from elegantrl_tpu_torch.utils.checkpoint import tree_leaves
from elegantrl_tpu_torch.utils.jax_params import buffer_state_from_numpy

torch.set_num_threads(1)
NET_DIMS = (16, 16)
NS, HB, BATCH, REPEAT, S, A = 8, 40, 128, 12.8, 4, 3     # 4 updates
U = 4


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _args(cls, per, **kw):
    args = cls()
    args.batch_size, args.repeat_times, args.learning_rate = BATCH, REPEAT, 1e-3
    args.if_use_per, args.lambda_fit_cum_r = per, 0.0
    for k, v in kw.items():
        setattr(args, k, v)
    return args


@pytest.fixture(scope='module', params=[(False, True), (True, False)],
                ids=['embed_per', 'ensemble_rows'])
def updates(request):
    ensemble, per = request.param
    jargs = _args(JConfig, per)
    jrb = JReplayBuffer(256, S, A, num_seqs=NS, if_use_per=per, if_discrete=True, args=jargs)
    jagent = jmake_embed_dqn(NET_DIMS, S, A, jargs, buffer=jrb, ensemble=ensemble)
    js = jax.jit(jagent.init)(jax.random.PRNGKey(0))
    rng = np.random.default_rng(5)
    items = (rng.standard_normal((HB, NS, S)).astype(np.float32),
             rng.integers(0, A, (HB, NS)).astype(np.int32),
             rng.standard_normal((HB, NS)).astype(np.float32),
             (rng.random((HB, NS)) > 0.1).astype(np.float32), np.ones((HB, NS), np.float32))
    jbuf = jax.jit(jrb.update)(jrb.init(), tuple(jnp.asarray(x) for x in items))
    k_upd = jax.random.PRNGKey(11)
    js2, jbuf2, jm = jax.jit(jagent.update)(js, jbuf, k_upd)

    @jax.jit
    def draws(key):   # the scan path's draw from fold_in(key, i)
        keys = jax.vmap(lambda i: jax.random.fold_in(key, i))(jnp.arange(U))
        if per:
            return jax.vmap(lambda k: jax.random.uniform(k, (NS, BATCH // NS)))(keys)
        return jax.vmap(lambda k: jax.random.randint(k, (BATCH // NS,), 0, HB - 1))(keys)

    ids = torch.tensor(np.asarray(draws(k_upd)))
    ids = ids if per else ids.long()
    args = _args(Config, per, device='cpu')
    rb = ReplayBuffer(256, S, A, num_seqs=NS, if_use_per=per, if_discrete=True, args=args,
                      device='cpu')
    agent = make_embed_dqn(NET_DIMS, S, A, args, buffer=rb, ensemble=ensemble)
    s = agent.state_from_numpy(_np(js), 'cpu')
    s2, buf2, m = agent.update(s, buffer_state_from_numpy(_np(jbuf), 'cpu'), None, ids=ids)
    # cum_returns on one rollout from the updated state
    ro = (rng.standard_normal((6, NS)).astype(np.float32),
          (rng.random((6, NS)) > 0.2).astype(np.float32))
    last = rng.standard_normal((NS, S)).astype(np.float32)
    jret = jax.jit(jagent.cum_returns)(
        js2, JRollout(None, None, None, jnp.asarray(ro[0]), jnp.asarray(ro[1]), None),
        jnp.asarray(last))
    ret = agent.cum_returns(s2, Rollout(None, None, None, torch.tensor(ro[0]),
                                        torch.tensor(ro[1]), None), torch.tensor(last))
    return (per, _np(js), _np(js2), _np(jbuf2), {k: float(v) for k, v in jm.items()},
            agent.state_to_numpy(s2), buf2, {k: float(v) for k, v in m.items()},
            np.asarray(jret), ret.numpy())


def test_update_params_like_jax(updates):
    _, js, js2, _, _, got = updates[:6]
    for name in ('q', 'q_target'):
        old, want = jax.tree.leaves(getattr(js, name)), jax.tree.leaves(getattr(js2, name))
        leaves = tree_leaves(getattr(got, name))
        assert len(leaves) == len(old)
        for o, a, b in zip(old, want, leaves):
            np.testing.assert_allclose(b - o, a - o, rtol=5e-3, atol=4e-7, err_msg=name)


def test_update_adam_and_metrics_like_jax(updates):
    _, _, js2, _, jm, got, _, m = updates[:8]
    count, mu, nu = _adam_parts(js2.opt)
    adam = got.opt[1][0]
    assert int(adam.count) == int(count) == U
    for a, b in zip(jax.tree.leaves((mu, nu)), tree_leaves((adam.mu, adam.nu))):
        np.testing.assert_allclose(b, a, rtol=5e-3, atol=4e-7)
    for k in ('obj_critic', 'obj_actor'):
        np.testing.assert_allclose(m[k], jm[k], rtol=1e-4, atol=1e-6)


def test_per_tree_like_jax(updates):
    per, _, _, jbuf2, _, _, buf2 = updates[:7]
    if not per:
        assert buf2.per_tree is None
        return
    for a, b in zip(jbuf2.per_tree, buf2.per_tree):
        np.testing.assert_allclose(b.numpy(), a, rtol=1e-4, atol=1e-6)


def test_cum_returns_like_jax(updates):
    np.testing.assert_allclose(updates[9], updates[8], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize('agent_class', [AgentEmbedDQN, AgentEnsembleDQN])
def test_train_agent_on_cpu(agent_class):
    args = Config(agent_class, CartPoleEnv,
                  {'env_name': 'CartPole-v1', 'num_envs': 4, 'max_step': 500, 'state_dim': 4,
                   'action_dim': 2, 'if_discrete': True})
    args.device, args.net_dims, args.horizon_len, args.batch_size = 'cpu', NET_DIMS, 16, 32
    args.buffer_size, args.eval_times, args.eval_per_step, args.break_step = 128, 1, 64, 0
    args.lambda_fit_cum_r = 0.1
    text = io.StringIO()
    with tempfile.TemporaryDirectory() as cwd, contextlib.redirect_stdout(text):
        args.cwd = cwd
        res = train_agent(args)
    assert np.isfinite(res['max_r']) and res['recorder'].shape[0] == 1
    assert 'use_fused_update: PyTorch path' in text.getvalue()
    assert 'use_fused_rollout: PyTorch path' in text.getvalue()
