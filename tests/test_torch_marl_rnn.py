"""The recurrent trainers of ``elegantrl_tpu_torch/marl`` (``mappo_rnn``,
``qmix_rnn``) against the JAX package's on the CPU: ``gru_step``,
``popart_update`` and one ``train_round`` of each, as
``test_torch_marl.py`` holds the others (the same sizes, draws and
tolerances: ``marl_jax_draws.py``)."""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from elegantrl_tpu import marl as jmarl
from elegantrl_tpu_torch import marl
from elegantrl_tpu_torch.utils import jax_params as jp
from marl_jax_draws import (ATOL, DIM, H, M, N, RTOL, _close, _close_state, _env_state,
                            _eval_draws, _ppo_rollout_draws, _qmix_draws, _t)

torch.set_num_threads(1)


def test_gru_step_and_popart_update_as_jax():
    from elegantrl_tpu.marl.mappo_rnn import (PopArt as JPopArt, gru_init as jgru_init,
                                              gru_step as jgru_step,
                                              popart_update as jpopart_update)
    from elegantrl_tpu_torch.marl.mappo_rnn import PopArt, gru_step, popart_update
    jp_ = jgru_init(jax.random.PRNGKey(0), 5, 16)
    rng = np.random.default_rng(2)
    h = rng.standard_normal((3, M, 16)).astype(np.float32)
    x = rng.standard_normal((3, M, 5)).astype(np.float32)
    want = np.asarray(jgru_step(jp_, jnp.asarray(h), jnp.asarray(x)))
    p = jax.tree.map(lambda a: torch.from_numpy(np.asarray(a).copy()), jp_)
    got = gru_step(p, torch.from_numpy(h), torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    mine = marl.mappo_rnn.gru_init(torch.Generator().manual_seed(0), 5, 16)
    assert {k: v['w'].shape for k, v in mine.items()} == {k: (21, 16) for k in 'rzn'}
    pa = JPopArt(jnp.asarray(0.3), jnp.asarray(1.5), jnp.asarray(rng.standard_normal((16, 1)),
                                                                jnp.float32),
                 jnp.asarray([0.2], jnp.float32))
    targets = rng.standard_normal((8, 4)).astype(np.float32) * 3 + 1
    want = jpopart_update(pa, jnp.asarray(targets), beta=0.1)
    got = popart_update(PopArt(*[torch.from_numpy(np.asarray(v)) for v in pa]),
                        torch.from_numpy(targets), beta=0.1)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-6)
    # the head's unnormalized outputs are kept across the update
    feat = torch.from_numpy(rng.standard_normal((5, 16)).astype(np.float32))
    old = PopArt(*[torch.from_numpy(np.asarray(v)) for v in pa])
    before = ((feat @ old.w)[..., 0] + old.b[0]) * old.sigma + old.mu
    after = ((feat @ got.w)[..., 0] + got.b[0]) * got.sigma + got.mu
    torch.testing.assert_close(after, before, rtol=1e-5, atol=1e-5)


def test_mappo_rnn_round_as_jax():
    SB, R, HID = 4, 1, 16
    jenv, env = jmarl.make_team_chasing(M, DIM), marl.make_team_chasing(M, DIM)
    jinit, jround, jevaluate = jmarl.make_mappo_rnn(jenv, hid=HID)
    init, train_round, evaluate = marl.make_mappo_rnn(env, hid=HID, device='cpu')
    js = jinit(jax.random.PRNGKey(1))
    jenvs = jax.vmap(jenv.init)(jax.random.split(jax.random.PRNGKey(2), N))
    rng = np.random.default_rng(3)
    hid0 = (rng.standard_normal((N, M, HID)).astype(np.float32) * 0.1,
            rng.standard_normal((N, HID)).astype(np.float32) * 0.1)
    key = jax.random.PRNGKey(3)
    js2, jenvs2, (jha, jhc), jr = jround(js, jenvs, tuple(map(jnp.asarray, hid0)), key, N, H,
                                         SB, R)
    k_roll, k_upd = jax.random.split(key)
    draws = _ppo_rollout_draws(k_roll, H, N)
    n_upd = max(1, N * R // SB)
    draws['ids'] = _t(jax.vmap(lambda k: jax.random.randint(k, (SB,), 0, N))(
        jax.random.split(k_upd, n_upd)))
    s = jp.mappo_rnn_state_from_numpy(jax.tree.map(np.asarray, js), 'cpu')
    _close(jp.mappo_rnn_state_to_numpy(s), js, 0, 0, 'round trip')
    s2, envs2, (ha, hc), r = train_round(s, _env_state(jenvs), tuple(map(torch.from_numpy, hid0)),
                                         None, N, H, SB, R, draws=draws)
    np.testing.assert_allclose(float(r), float(jr), rtol=RTOL, atol=ATOL)
    _close(envs2, jenvs2, RTOL, ATOL, 'env states')
    _close((ha, hc), (jha, jhc), RTOL, ATOL, 'hiddens')
    # the PopArt statistics (critic/popart/mu, nu) are among the compared leaves
    _close_state(jp.mappo_rnn_state_to_numpy(s2), js2, {'actor': 'act_opt/1/0/mu',
                                                        'critic': 'cri_opt/1/0/mu'},
                 3e-4, n_upd, 'state')
    ek = jax.random.PRNGKey(4)
    np.testing.assert_allclose(float(evaluate(s2, None, 4, draws=_eval_draws(ek, 4, 256))),
                               float(jevaluate(js2, ek, 4)), rtol=1e-5, atol=1e-5)


def test_qmix_rnn_round_as_jax():
    SB, G, HID = 4, 2, 16
    jenv = jmarl.make_team_chasing_discrete(M, DIM)
    env = marl.make_team_chasing_discrete(M, DIM)
    kw = dict(hid=HID, mix_dim=8, slots=3, seq_batch=SB, grad_steps=G, explore_rate=0.5)
    jinit, jinit_buffer, jround, jevaluate = jmarl.make_qmix_rnn(jenv, **kw)
    init, init_buffer, train_round, evaluate = marl.make_qmix_rnn(env, **kw, device='cpu')
    js = jinit(jax.random.PRNGKey(1))
    jenvs = jax.vmap(jenv.init)(jax.random.split(jax.random.PRNGKey(2), N))
    h0 = np.random.default_rng(4).standard_normal((N, M, HID)).astype(np.float32) * 0.1
    key = jax.random.PRNGKey(3)
    js2, jenvs2, jh, jbuf2, jloss = jround(js, jenvs, jnp.asarray(h0), jinit_buffer(N, H),
                                           key, N, H)
    k_roll, k_sgd = jax.random.split(key)
    draws = _qmix_draws(k_roll, H, N, env.action_dim)
    size = int(np.asarray(jbuf2[2]))

    def sgd_keys(kt):
        k_slot, k_env = jax.random.split(kt)
        return (jax.random.randint(k_slot, (), 0, size),
                jax.random.randint(k_env, (SB,), 0, N))
    slot, ids = jax.vmap(sgd_keys)(jax.random.split(k_sgd, G))
    draws['slot'], draws['ids'] = _t(slot), _t(ids)
    s = jp.qmix_rnn_state_from_numpy(jax.tree.map(np.asarray, js), 'cpu')
    _close(jp.qmix_rnn_state_to_numpy(s), js, 0, 0, 'round trip')
    s2, envs2, h, buf2, loss = train_round(s, _env_state(jenvs), torch.from_numpy(h0),
                                           init_buffer(N, H), None, N, H, draws=draws)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=RTOL, atol=ATOL)
    _close(envs2, jenvs2, RTOL, ATOL, 'env states')
    _close(h, jh, RTOL, ATOL, 'hidden')
    _close(buf2, jbuf2, RTOL, ATOL, 'ring')
    _close_state(jp.qmix_rnn_state_to_numpy(s2), js2, {'params': 'opt/1/0/mu',
                                                       'target': 'opt/1/0/mu'}, 5e-4, G,
                 'state')
    ek = jax.random.PRNGKey(4)
    np.testing.assert_allclose(float(evaluate(s2, None, 4, draws=_eval_draws(ek, 4, 256))),
                               float(jevaluate(js2, ek, 4)), rtol=1e-5, atol=1e-5)
