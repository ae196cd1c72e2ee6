"""``elegantrl_tpu_torch/marl`` against ``elegantrl_tpu/marl`` on the CPU:
the team-chasing env, one ``train_round`` of each trainer and the
evaluators, on the same weights (carried through ``utils/jax_params.py``)
and the same draws (the JAX keys split as the JAX round splits them, the
draws computed with JAX and handed to the port as ``draws``).  Small sizes:
2 agents, 4-8 envs, horizon 8, nets of (16, 16), hid 16.

Tolerances: the env, float32 arithmetic of the same formulas, 1e-6; a
round's parameters, Adam moments, PopArt statistics and metrics, rtol 1e-5
/ atol 1e-6 (float32 sums in another order: XLA's dots against PyTorch's);
the evaluators, 1e-5.  One exception, named where it applies
(``_close_state``): a parameter whose gradient is at float32's noise floor
(the JAX first moment ``|mu| <= 1e-6``: cancelling terms, as for an obs
feature that is zero in most samples) moves by Adam's normalised step,
``lr mu / (sqrt(nu) + eps)``, which turns a last-bit difference of the
gradient into up to ``lr`` a step; such parameters, at most 2% of a leaf,
are held within ``lr`` per SGD step.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elegantrl_tpu import marl as jmarl
from elegantrl_tpu_torch import marl
from elegantrl_tpu_torch.utils import jax_params as jp
from marl_jax_draws import (ATOL, DIM, H, M, N, RTOL, _close, _close_state, _env_state,
                            _eval_draws, _init_draws, _ppo_rollout_draws, _qmix_draws,
                            _rollout_keys, _step_draws, _t)

torch.set_num_threads(1)


@pytest.mark.parametrize('discrete', [False, True])
def test_team_chasing_as_jax(discrete):
    """init, obs, global_state and step (with a masked reset's fresh rows),
    both action spaces, within 1e-6."""
    make, jmake = ((marl.make_team_chasing_discrete, jmarl.make_team_chasing_discrete)
                   if discrete else (marl.make_team_chasing, jmarl.make_team_chasing))
    env, jenv = make(M, DIM), jmake(M, DIM)
    for f in ('num_agents', 'obs_dim', 'state_dim', 'action_dim', 'if_discrete', 'max_step',
              'env_name'):
        assert getattr(env, f) == getattr(jenv, f), f
    key = jax.random.PRNGKey(0)
    js = jax.vmap(jenv.init)(jax.random.split(key, N))
    s = env.init(None, N, 'cpu', tuple(map(_t, _init_draws(key, N))))
    _close(s, js, 1e-6, 1e-6, 'init')
    rng = np.random.default_rng(0)
    for t in range(12):
        a = (rng.integers(0, env.action_dim, (N, M)).astype(np.int32) if discrete
             else rng.normal(size=(N, M, DIM)).astype(np.float32) * 2)
        _close(env.obs(s), jax.vmap(jenv.obs)(js), 1e-6, 1e-6, 'obs')
        _close(env.global_state(s), jax.vmap(jenv.global_state)(js), 1e-6, 1e-6, 'gs')
        kt = jax.random.fold_in(key, t + 1)
        js2, jr, jterm, jtrunc = jax.vmap(jenv.step)(js, jnp.asarray(a), jax.random.split(kt, N))
        s2, r, term, trunc = env.step(s, _t(a), None, _t(_step_draws(kt, N)))
        _close(s2, js2, 1e-6, 1e-6, f'step {t}')
        np.testing.assert_allclose(r.numpy(), np.asarray(jr), rtol=1e-6, atol=1e-6)
        assert np.array_equal(term.numpy(), np.asarray(jterm))
        assert np.array_equal(trunc.numpy(), np.asarray(jtrunc))
        s, js = s2, js2
    # a generator draws the same shapes
    g = torch.Generator().manual_seed(0)
    s = env.init(g, 3, 'cpu')
    s2, r, _, _ = env.step(s, torch.zeros((3, M), dtype=torch.int32) if discrete
                           else torch.zeros((3, M, DIM)), g)
    assert s2.target_p.shape == (3, DIM) and r.shape == (3,)


def test_mappo_round_as_jax():
    B, R = 16, 2
    jenv, env = jmarl.make_team_chasing(M, DIM), marl.make_team_chasing(M, DIM)
    jinit, jround, jevaluate, _ = jmarl.make_mappo(jenv, net_dims=(16, 16))
    init, train_round, evaluate, _ = marl.make_mappo(env, net_dims=(16, 16), device='cpu')
    js = jinit(jax.random.PRNGKey(1))
    jenvs = jax.vmap(jenv.init)(jax.random.split(jax.random.PRNGKey(2), N))
    key = jax.random.PRNGKey(3)
    js2, jenvs2, jr = jround(js, jenvs, key, N, H, B, R)
    k_roll, k_upd, _ = jax.random.split(key, 3)
    n_upd = max(1, H * N * R // B)
    draws = _ppo_rollout_draws(k_roll, H, N)
    draws['ids'] = _t(jax.vmap(lambda k: jax.random.randint(k, (B,), 0, H * N))(
        jax.random.split(k_upd, n_upd)))
    s = jp.mappo_state_from_numpy(jax.tree.map(np.asarray, js), 'cpu')
    _close(jp.mappo_state_to_numpy(s), js, 0, 0, 'round trip')
    s2, envs2, r = train_round(s, _env_state(jenvs), None, N, H, B, R, draws=draws)
    np.testing.assert_allclose(float(r), float(jr), rtol=RTOL, atol=ATOL)
    _close(envs2, jenvs2, RTOL, ATOL, 'env states')
    _close_state(jp.mappo_state_to_numpy(s2), js2,
                 {'actor': 'act_opt/1/0/mu', 'critic': 'cri_opt/1/0/mu'}, 3e-4,
                 H * N * R // B, 'state')
    # the evaluator on fixed draws
    ek = jax.random.PRNGKey(4)
    want = float(jevaluate(js2, ek, 4))
    got = float(evaluate(s2, None, 4, draws=_eval_draws(ek, 4, env.max_step)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_maddpg_round_as_jax():
    B, BUF = 16, 32
    jenv, env = jmarl.make_team_chasing(M, DIM), marl.make_team_chasing(M, DIM)
    kw = dict(net_dims=(16, 16), buf_size=BUF, batch_size=B, num_envs=N)
    jinit, jround, jevaluate = jmarl.make_maddpg(jenv, **kw)
    init, train_round, evaluate = marl.make_maddpg(env, **kw, device='cpu')
    js = jinit(jax.random.PRNGKey(1))
    key = jax.random.PRNGKey(3)
    js2, jr = jround(js, key, H, 1)
    k_roll, k_upd = jax.random.split(key)
    ks, env_u, reset = _rollout_keys(k_roll, H, N, 3)
    size = int(np.asarray(js2.buf[-1]))
    draws = {'act': _t(jax.vmap(lambda k: jax.random.normal(k, (N, M, DIM)))(ks[:, 0])),
             'env': _t(env_u), 'reset': tuple(map(_t, reset)),
             'ids': _t(jax.vmap(lambda k: jax.random.randint(k, (B,), 0, size * N))(
                 jax.random.split(k_upd, H)))}
    s = jp.maddpg_state_from_numpy(jax.tree.map(np.asarray, js), 'cpu')
    _close(jp.maddpg_state_to_numpy(s), js, 0, 0, 'round trip')
    s2, r = train_round(s, None, H, 1, draws=draws)
    np.testing.assert_allclose(float(r), float(jr), rtol=RTOL, atol=ATOL)
    _close_state(jp.maddpg_state_to_numpy(s2), js2, {'actor': 'a_opt/1/0/mu',
                                                     'critic': 'c_opt/1/0/mu',
                                                     'actor_target': 'a_opt/1/0/mu',
                                                     'critic_target': 'c_opt/1/0/mu'},
                 5e-4, H, 'state')
    ek = jax.random.PRNGKey(4)
    np.testing.assert_allclose(float(evaluate(s2, None, 4, draws=_eval_draws(ek, 4, 256))),
                               float(jevaluate(js2, ek, 4)), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize('mixer', ['qmix', 'vdn'])
def test_qmix_round_as_jax(mixer):
    B, G, BUF = 16, 2, 32
    jenv = jmarl.make_team_chasing_discrete(M, DIM)
    env = marl.make_team_chasing_discrete(M, DIM)
    kw = dict(net_dims=(16, 16), mix_dim=8, mixer=mixer, buffer_len=BUF, batch_size=B,
              grad_steps=G, explore_rate=0.5)
    jinit, jinit_buffer, jround, jevaluate = jmarl.make_qmix(jenv, **kw)
    init, init_buffer, train_round, evaluate = marl.make_qmix(env, **kw, device='cpu')
    js = jinit(jax.random.PRNGKey(1))
    jenvs = jax.vmap(jenv.init)(jax.random.split(jax.random.PRNGKey(2), N))
    jbuf = jinit_buffer(N)
    key = jax.random.PRNGKey(3)
    js2, jenvs2, jbuf2, jloss = jround(js, jenvs, jbuf, key, N, H)
    k_roll, k_sgd = jax.random.split(key)
    draws = _qmix_draws(k_roll, H, N, env.action_dim)
    size = int(np.asarray(jbuf2[2]))
    draws['ids'] = _t(jax.vmap(lambda k: jax.random.randint(k, (B,), 0, size * N))(
        jax.random.split(k_sgd, G)))
    s = jp.qmix_state_from_numpy(jax.tree.map(np.asarray, js), 'cpu')
    _close(jp.qmix_state_to_numpy(s), js, 0, 0, 'round trip')
    s2, envs2, buf2, loss = train_round(s, _env_state(jenvs), init_buffer(N), None, N, H,
                                        draws=draws)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=RTOL, atol=ATOL)
    _close(envs2, jenvs2, RTOL, ATOL, 'env states')
    _close(buf2, jbuf2, RTOL, ATOL, 'ring')
    _close_state(jp.qmix_state_to_numpy(s2), js2, {'params': 'opt/1/0/mu',
                                                   'target': 'opt/1/0/mu'}, 5e-4, G, 'state')
    ek = jax.random.PRNGKey(4)
    np.testing.assert_allclose(float(evaluate(s2, None, 4, draws=_eval_draws(ek, 4, 256))),
                               float(jevaluate(js2, ek, 4)), rtol=1e-5, atol=1e-5)


def test_qmix_mixers_as_jax():
    """The monotonic mixer (|hypernetwork| weights, ELU) and VDN's sum on the
    same parameters and inputs, within 1e-5; QMIX's Q_tot never falls as an
    agent's Q rises."""
    from elegantrl_tpu_torch.marl.qmix import make_mixer
    from elegantrl_tpu.marl.qmix import QMixParams as JP
    jenv = jmarl.make_team_chasing_discrete(M, DIM)
    jinit = jmarl.make_qmix(jenv, net_dims=(16, 16), mix_dim=8)[0]
    js = jinit(jax.random.PRNGKey(5))
    s = jp.qmix_state_from_numpy(jax.tree.map(np.asarray, js), 'cpu')
    rng = np.random.default_rng(1)
    q = rng.standard_normal((6, M)).astype(np.float32)
    gs = rng.standard_normal((6, jenv.state_dim)).astype(np.float32)
    for mixer in ('qmix', 'vdn'):
        mix = make_mixer(mixer, M, 8)
        got = mix(s.params, torch.from_numpy(q), torch.from_numpy(gs)).numpy()
        # the JAX mixer, through a round's mix: rebuilt here from its formula
        p = JP(*js.params)
        if mixer == 'vdn':
            want = q.sum(-1)
        else:
            from elegantrl_tpu.ops.nets import mlp_apply
            w1 = np.abs(np.asarray(mlp_apply(p.hyper_w1, gs))).reshape(6, M, 8)
            b1 = np.asarray(mlp_apply(p.hyper_b1, gs))
            w2 = np.abs(np.asarray(mlp_apply(p.hyper_w2, gs)))
            b2 = np.asarray(mlp_apply(p.hyper_b2, gs))[..., 0]
            want = (np.asarray(jax.nn.elu(np.einsum('bm,bmd->bd', q, w1) + b1)) * w2).sum(-1) + b2
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
        up = mix(s.params, torch.from_numpy(q + np.array([1.0, 0.0], np.float32)),
                 torch.from_numpy(gs)).numpy()
        assert (up >= got).all()


def test_exports_and_devices_as_jax():
    """The package exports what the JAX package's does; a trainer asked for
    the card without one raises and names ``device='cpu'``; on the CPU each
    trainer runs a round from its own generator with finite metrics."""
    names = {n for n in dir(jmarl) if not n.startswith('_')}
    assert names - {'env', 'chasing', 'mappo', 'mappo_rnn', 'qmix', 'qmix_rnn', 'maddpg'} <= \
        set(dir(marl))
    env, denv = marl.make_team_chasing(M, DIM), marl.make_team_chasing_discrete(M, DIM)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            marl.train_mappo(env, num_rounds=1)
    _, hist = marl.train_mappo(env, num_envs=4, horizon=4, batch_size=8, repeat_times=1,
                               num_rounds=1, verbose=False, device='cpu')
    assert np.isfinite(hist).all()
    _, hist = marl.train_qmix(denv, num_envs=4, horizon=4, num_rounds=1, verbose=False,
                              mixer='vdn', device='cpu')
    assert np.isfinite(hist).all()
