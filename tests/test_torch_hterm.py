"""The port's H-term rehearsal (``elegantrl_tpu_torch/agents/hterm.py``) and
its five H-term agents against the JAX package's.

- The ring's functions on the same inputs: window returns, the best-window
  insert (its masks at episode ends, the top-K keep when there are more envs
  than slots, ties to the lower env index), the weight bounds and the
  rehearsal sample (zero weights on an empty ring); the JAX cases of
  ``tests/test_hterm_offpolicy.py`` among them.
- One update of ``AgentDDPGHterm``, ``AgentTD3Hterm``, ``AgentSACHterm``,
  ``AgentModSACHterm`` and ``AgentPPOHterm`` against the JAX agent with
  copied weights, after the same window harvest, with the JAX agent's
  minibatch, noise and rehearsal draws passed in.
- Where the rollouts run: the off-policy H-term agents ride the rollout
  kernel's heads (its plain version on the CPU), ``AgentPPOHterm`` the
  generic loop, as in the JAX runner.

Tolerances: the ring's contents exactly (PPO's labels, GAE targets, to 1e-5
relative: the JAX package sums them with an associative scan), window
returns to 1e-6 relative;
the updates as the JAX package's own update tests: parameter updates (new -
old) to rtol 5e-3 (atol 4e-7), metrics to rtol 1e-4 (atol 1e-6).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elegantrl_tpu.agents import hterm as jh
from elegantrl_tpu.agents.base import Rollout as JRollout
from elegantrl_tpu.agents.ddpg_td3 import _make as jmake_ddpg_td3
from elegantrl_tpu.agents.ppo import make_ppo as jmake_ppo
from elegantrl_tpu.agents.sac import make_sac as jmake_sac
from elegantrl_tpu.config import Config as JConfig
from elegantrl_tpu.train.replay_buffer import ReplayBuffer as JReplayBuffer
from elegantrl_tpu_torch import Config, build_training
from elegantrl_tpu_torch.agents import AgentDDPGHterm, AgentPPOHterm, AgentSACHterm
from elegantrl_tpu_torch.agents import hterm as ph
from elegantrl_tpu_torch.agents.base import Rollout
from elegantrl_tpu_torch.agents.ddpg_td3 import _make as make_ddpg_td3
from elegantrl_tpu_torch.agents.ppo import make_ppo
from elegantrl_tpu_torch.agents.sac import make_sac
from elegantrl_tpu_torch.envs import PendulumEnv
from elegantrl_tpu_torch.train.replay_buffer import ReplayBuffer
from elegantrl_tpu_torch.utils.checkpoint import tree_leaves
from elegantrl_tpu_torch.utils.jax_params import buffer_state_from_numpy

torch.set_num_threads(1)


def _t(x):
    return torch.tensor(np.asarray(x))


def _assert_ring_equal(jbuf, buf, returns_rtol=0.0):
    """The port's ring (tensors, or numpy as ``state_to_numpy`` gives it)
    equals the JAX one; the labels to ``returns_rtol``."""
    for name in ('states', 'actions', 'masks', 'returns'):
        x = getattr(buf, name)
        x = x.numpy() if isinstance(x, torch.Tensor) else x
        rtol = returns_rtol if name == 'returns' else 0.0
        np.testing.assert_allclose(x, np.asarray(getattr(jbuf, name)), rtol=rtol, atol=0,
                                   err_msg=name)
    assert (int(buf.ptr), int(buf.count)) == (int(jbuf.ptr), int(jbuf.count))


# jitted once per shape: eager JAX compiles every primitive on its own
_jinsert = jax.jit(jh.insert_best_windows, static_argnums=6)
_jwindow_returns = jax.jit(jh.discounted_window_returns, static_argnums=(3, 4))


def test_discounted_window_returns_like_jax():
    rng = np.random.default_rng(0)
    r = rng.standard_normal((12, 5)).astype(np.float32)
    ud = (rng.random((12, 5)) > 0.2).astype(np.float32)
    um = (rng.random((12, 5)) > 0.1).astype(np.float32)
    for k in (4, 20):
        want = _jwindow_returns(jnp.asarray(r), jnp.asarray(ud), jnp.asarray(um), 0.9, k)
        got = ph.discounted_window_returns(_t(r), _t(ud), _t(um), 0.9, k)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-7)


def _windows(rng, H, N, S=2, A=1):
    return (rng.standard_normal((H, N, S)).astype(np.float32),
            rng.standard_normal((H, N, A)).astype(np.float32),
            (rng.random((H, N)) > 0.25).astype(np.float32),
            (rng.random((H, N)) > 0.1).astype(np.float32))


@pytest.mark.parametrize('N,K,k', [(4, 8, 3), (6, 4, 2), (7, 16, 9)],
                         ids=['fits', 'top_k', 'short_horizon'])
def test_insert_best_windows_like_jax(N, K, k):
    """Two inserts into a ring of K slots; with N > K the top-K windows are
    kept, and the labels below repeat values so ties decide the order."""
    rng = np.random.default_rng(N * K)
    H = 6
    jbuf, buf = jh.init_hterm_buffer(K, k, 2, 1), ph.init_hterm_buffer(K, k, 2, 1, 'cpu')
    for _ in range(2):
        s, a, ud, um = _windows(rng, H, N)
        q = rng.integers(0, 4, (max(H - min(k, H) + 1, 1), N)).astype(np.float32)
        jbuf = _jinsert(jbuf, *[jnp.asarray(x) for x in (s, a, ud, um, q)], k)
        buf = ph.insert_best_windows(buf, *[_t(x) for x in (s, a, ud, um, q)], k)
        _assert_ring_equal(jbuf, buf)


def test_top_k_ties_keep_the_lower_env_index():
    h_buf = ph.init_hterm_buffer(3, 1, 1, 1, 'cpu')
    states = torch.arange(6.0).reshape(1, 6, 1)
    q = torch.tensor([[5.0, 7.0, 5.0, 7.0, 5.0, 1.0]])
    out = ph.insert_best_windows(h_buf, states, states, torch.ones(1, 6), torch.ones(1, 6), q, 1)
    assert out.returns.tolist() == [7.0, 7.0, 5.0]
    assert out.states[:, 0, 0].tolist() == [1.0, 3.0, 0.0]


def test_rehearsal_sample_and_bounds_like_jax():
    rng = np.random.default_rng(3)
    s, a, ud, um = _windows(rng, 6, 5)
    q = rng.standard_normal((4, 5)).astype(np.float32)
    jbuf = _jinsert(jh.init_hterm_buffer(8, 3, 2, 1), *[jnp.asarray(x) for x in (s, a, ud, um, q)],
                    3)
    buf = ph.insert_best_windows(ph.init_hterm_buffer(8, 3, 2, 1, 'cpu'),
                                 *[_t(x) for x in (s, a, ud, um, q)], 3)
    for x, y in zip(jax.jit(jh.return_bounds)(jbuf), ph.return_bounds(buf)):
        assert float(y) == float(x)
    key = jax.random.PRNGKey(4)
    want = jax.jit(jh.rehearsal_sample, static_argnums=2)(jbuf, key, 7)
    ids = _t(jax.jit(lambda k: jax.random.randint(k, (7,), 0, max(int(jbuf.count), 1)))(key))
    got = ph.rehearsal_sample(buf, ids)
    for x, y in zip(want, got):
        np.testing.assert_allclose(y.numpy(), np.asarray(x), rtol=1e-6, atol=0)
    _, _, _, w, valid = ph.rehearsal_sample(ph.init_hterm_buffer(8, 4, 2, 1, 'cpu'),
                                            torch.zeros(5, dtype=torch.long))
    assert valid.tolist() == [0.0] * 5 and w.tolist() == [0.0] * 5   # not NaN


# ------------------------------------------------------------ the agents

NET_DIMS = (16, 16)
NS, HB, BATCH, S, A = 8, 40, 128, 3, 2
HT = dict(h_term_k_step=4, h_term_buffer_size=16)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _off_args(cls, **kw):
    args = cls()
    args.batch_size, args.repeat_times, args.buffer_init_size = BATCH, 3.2, 16   # 1 update
    args.learning_rate = 1e-3
    for k, v in {**HT, **kw}.items():
        setattr(args, k, v)
    return args


def _off_agent(kind, args, buffer, port):
    if kind in ('ddpg', 'td3'):
        return (make_ddpg_td3 if port else jmake_ddpg_td3)(NET_DIMS, S, A, args, buffer,
                                                           td3=kind == 'td3', hterm=True)
    return (make_sac if port else jmake_sac)(NET_DIMS, S, A, args, buffer,
                                             modsac=kind == 'modsac', hterm=True)


@pytest.fixture(scope='module', params=['ddpg', 'td3', 'sac', 'modsac'])
def off_update(request):
    """The window harvest of one rollout, then one update, in both packages."""
    kind = request.param
    jargs = _off_args(JConfig, use_pallas_update=False)
    jrb = JReplayBuffer(256, S, A, num_seqs=NS, args=jargs)
    jagent = _off_agent(kind, jargs, jrb, port=False)
    js0 = jax.jit(jagent.init)(jax.random.PRNGKey(0))
    rng = np.random.default_rng(5)
    items = (rng.standard_normal((HB, NS, S)).astype(np.float32),
             rng.uniform(-0.9, 0.9, (HB, NS, A)).astype(np.float32),
             rng.standard_normal((HB, NS)).astype(np.float32),
             (rng.random((HB, NS)) > 0.1).astype(np.float32),
             (rng.random((HB, NS)) > 0.05).astype(np.float32))
    jro = JRollout(*[jnp.asarray(x) for x in items[:2]], None,
                   *[jnp.asarray(x) for x in items[2:]])
    js = jax.jit(jagent.pre_update)(js0, jro, jro.states[-1])
    jbuf = jax.jit(jrb.update)(jrb.init(), tuple(jnp.asarray(x) for x in items))
    k_upd = jax.random.PRNGKey(11)
    js2, _, jm = jax.jit(jagent.update)(js, jbuf, k_upd)

    @jax.jit
    def draws(k_upd):
        """The JAX agent's draws: fold_in, the H-term key split off first."""
        key, k_h = jax.random.split(jax.random.fold_in(k_upd, 0))
        if kind in ('ddpg', 'td3'):
            k_sample, k_noise = jax.random.split(key)
            noise = 0.1 * jax.random.normal(k_noise, (BATCH, A))
        else:
            k_sample, k_next, k_pg = jax.random.split(key, 3)
            noise = jnp.stack([jax.random.normal(k, (BATCH, A)) for k in (k_next, k_pg)])
        return (noise, jax.random.randint(k_sample, (1, BATCH // NS), 0, HB - 1),
                jax.random.randint(k_h, (1, BATCH // 4), 0, int(js.h_buf.count)))

    noise, rows, h_ids = (_t(x) for x in draws(k_upd))
    rows, h_ids = rows.long(), h_ids.long()
    args = _off_args(Config, device='cpu')
    rb = ReplayBuffer(256, S, A, num_seqs=NS, device='cpu')
    agent = _off_agent(kind, args, rb, port=True)
    assert agent.update.__name__ == 'scan_update'
    s = agent.pre_update(agent.state_from_numpy(_np(js0), 'cpu'),
                         Rollout(*[_t(x) for x in items[:2]], None, *[_t(x) for x in items[2:]]),
                         None)
    _assert_ring_equal(js.h_buf, s.h_buf)
    s2, _, m = agent.update(s, buffer_state_from_numpy(_np(jbuf), 'cpu'), None, ids=rows,
                            noise=ph.HtermDraws(_t(noise)[None], h_ids))
    return _np(js), _np(js2), {k: float(v) for k, v in jm.items()}, agent.state_to_numpy(s2), \
        {k: float(v) for k, v in m.items()}


def _assert_update_like_jax(js, js2, jm, got, m, names):
    for name in names:
        old, want = jax.tree.leaves(getattr(js, name)), jax.tree.leaves(getattr(js2, name))
        leaves = tree_leaves(getattr(got, name))
        assert len(leaves) == len(old), name
        for o, a, b in zip(old, want, leaves):
            np.testing.assert_allclose(b - o, a - o, rtol=5e-3, atol=4e-7, err_msg=name)
    for k in ('obj_critic', 'obj_actor'):
        np.testing.assert_allclose(m[k], jm[k], rtol=1e-4, atol=1e-6)


def test_offpolicy_hterm_update_like_jax(off_update):
    js, js2, jm, got, m = off_update
    names = [n for n in ('act', 'act_target', 'cri', 'cri_target')
             if getattr(js, n) is not None]
    _assert_update_like_jax(js, js2, jm, got, m, names)
    _assert_ring_equal(js2.h_buf, got.h_buf)


def test_ppo_hterm_update_like_jax():
    """One PPO-H update: the harvest of the GAE targets' best windows, then a
    minibatch step whose actor loss carries the rehearsal term."""
    H, N, Sp, Ap, B = 16, 8, 3, 1, 32
    hyp = dict(batch_size=B, repeat_times=2.0, learning_rate=1e-3, **HT)   # 1 minibatch

    def args_of(cls, **kw):
        a = cls()
        for k, v in {**hyp, **kw}.items():
            setattr(a, k, v)
        return a

    jagent = jmake_ppo(NET_DIMS, Sp, Ap, args_of(JConfig), hterm=True)
    js = jax.jit(jagent.init)(jax.random.PRNGKey(0))
    rng = np.random.default_rng(9)
    items = (rng.standard_normal((H, N, Sp)).astype(np.float32),
             rng.standard_normal((H, N, Ap)).astype(np.float32),
             (-np.abs(rng.standard_normal((H, N)))).astype(np.float32),
             rng.standard_normal((H, N)).astype(np.float32),
             (rng.random((H, N)) > 0.1).astype(np.float32),
             (rng.random((H, N)) > 0.05).astype(np.float32))
    last = rng.standard_normal((N, Sp)).astype(np.float32)
    key = jax.random.PRNGKey(21)
    js2, jm = jax.jit(jagent.update)(js, JRollout(*[jnp.asarray(x) for x in items]),
                                     jnp.asarray(last), key)

    @jax.jit
    def draws(key):
        key_t, key_h = jax.random.split(jax.random.split(key, 1)[0])
        return (jax.random.randint(key_t, (1, B), 0, H * N),
                jax.random.randint(key_h, (1, B // 4), 0, min(N, 16)))

    ids, h_ids = (_t(x).long() for x in draws(key))
    agent = make_ppo(NET_DIMS, Sp, Ap, args_of(Config, device='cpu'), hterm=True)
    s = agent.state_from_numpy(_np(js), 'cpu')
    s2, m = agent.update(s, Rollout(*[_t(x) for x in items]), _t(last), None, ids=ids,
                         h_ids=h_ids)
    js, js2 = _np(js), _np(js2)
    got = agent.state_to_numpy(s2)
    _assert_update_like_jax(js, js2, {k: float(v) for k, v in jm.items()}, got,
                            {k: float(v) for k, v in m.items()}, ('act', 'cri'))
    # the labels are GAE targets, which the JAX package sums with an
    # associative scan at this horizon: equal to f32 reassociation
    _assert_ring_equal(js2.h_buf, got.h_buf, returns_rtol=1e-5)


@pytest.mark.parametrize('agent_class,fused', [(AgentDDPGHterm, True), (AgentSACHterm, True),
                                               (AgentPPOHterm, False)])
def test_hterm_rollout_path_as_jax(agent_class, fused):
    args = Config(agent_class, PendulumEnv,
                  {'env_name': 'Pendulum-v1', 'num_envs': 4, 'max_step': 200, 'state_dim': 3,
                   'action_dim': 1, 'if_discrete': False})
    args.device, args.net_dims, args.horizon_len, args.batch_size = 'cpu', NET_DIMS, 8, 16
    args.buffer_size, args.h_term_k_step, args.h_term_buffer_size = 64, 4, 8
    ctx = build_training(args)
    assert ctx.fused_rollout == fused
    carry, metrics = ctx.round_fn(ctx.carry)
    assert np.isfinite(float(metrics['obj_critic']))
    assert carry.agent_state.h_buf.count == 4       # one window per env


def test_hterm_ring_resumes_with_the_carry(tmp_path):
    """``train_agent`` saves the H-term ring in ``train_carry.npz`` (an
    off-policy run writes the carry when it is resumable: here
    ``if_save_buffer``); ``continue_train`` restores it, ``ptr`` and
    ``count`` included."""
    from elegantrl_tpu_torch import train_agent

    def args_for(resume):
        a = Config(AgentSACHterm, PendulumEnv,
                   {'env_name': 'Pendulum-v1', 'num_envs': 4, 'max_step': 200, 'state_dim': 3,
                    'action_dim': 1, 'if_discrete': False})
        a.device, a.net_dims, a.horizon_len, a.batch_size = 'cpu', NET_DIMS, 8, 16
        a.buffer_size, a.h_term_k_step, a.h_term_buffer_size = 64, 4, 8
        a.eval_times, a.eval_per_step, a.break_step, a.random_seed = 1, 32, 32, 0
        a.cwd, a.continue_train = str(tmp_path), resume
        return a

    first = args_for(False)
    first.if_save_buffer = True
    out = train_agent(first)['agent_state'].h_buf
    assert out.count == 8 and out.ptr == 0              # two rounds of 4 windows
    resumed = build_training(args_for(True)).carry.agent_state.h_buf
    for a, b in zip(out, resumed):
        assert (torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b)
