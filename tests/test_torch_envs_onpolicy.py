"""Parity of the port's CartPole, HopperSlip and PointChasing envs
(``elegantrl_tpu_torch.envs``) and their fused-rollout bodies
(``ops/fused_rollout.py``) with the JAX package's env modules and kernel
bodies, on the same states, actions and uniforms (numpy, seeded).  The
states are spread so that terminals, truncations, touchdowns and liftoffs
all fire.

Tolerance 1e-6 absolute on one step (the same f32 arithmetic in another
framework); flags agree exactly.  The hopper env takes ``atan2`` from the
library and its body takes the JAX body's polynomial, which agree to 1e-6.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elegantrl_tpu.envs import base as jbase
from elegantrl_tpu.envs.cartpole import CartPoleState as JCartPole, make_cartpole as jmake_cartpole
from elegantrl_tpu.envs.hopper import HopperState as JHopper, make_hopper as jmake_hopper
from elegantrl_tpu.envs.point_chasing import (ChasingState as JChasing,
                                              make_point_chasing as jmake_chasing,
                                              make_point_chasing_discrete as jmake_chasing_disc)
from elegantrl_tpu.ops import pallas_rollout as jpr
from elegantrl_tpu_torch import build_env, get_gym_env_args
from elegantrl_tpu_torch.envs import (CartPoleEnv, CartPoleState, ChasingState, HopperEnv,
                                      HopperState, PointChasingDiscreteEnv, PointChasingEnv,
                                      PointChasingVecEnv, make_cartpole, make_hopper,
                                      make_point_chasing, make_point_chasing_discrete,
                                      vec_step)
from elegantrl_tpu_torch.envs.point_chasing import chasing_step, grid_action
from elegantrl_tpu_torch.ops import fused_rollout as fr
from elegantrl_tpu_torch.utils.jax_params import env_state_from_numpy

torch.set_num_threads(1)
N = 96
ENVS = ['cartpole', 'hopper', 'chasing', 'chasing_discrete']


def _cartpole_state(rng):
    s = dict(x=rng.uniform(-2.45, 2.45, N), x_dot=rng.uniform(-2, 2, N),
             theta=rng.uniform(-0.22, 0.22, N), theta_dot=rng.uniform(-2, 2, N))
    t = np.arange(N) * 11 % 500
    t[:6] = 499                                    # these truncate unless terminal
    s['x'][:3], s['theta'][:3] = 0.1, 0.01
    return {k: v.astype(np.float32) for k, v in s.items()} | {'t': t.astype(np.int32)}


def _hopper_state(rng):
    stance = rng.uniform(size=N) < 0.5
    z = np.where(stance, rng.uniform(0.2, 0.56, N), rng.uniform(0.2, 1.0, N))
    z[:8] = rng.uniform(0.45, 0.56, 8)             # flight, foot near the ground
    stance[:8] = False
    s = dict(x=rng.uniform(-1, 5, N), z=z, vx=rng.uniform(-1, 2, N),
             vz=rng.uniform(-3, 3, N), leg_angle=rng.uniform(-0.5, 0.5, N),
             leg_len=rng.uniform(0.4, 0.55, N))
    s['foot_x'] = s['x'] + rng.uniform(-0.3, 0.3, N)
    t = np.arange(N) * 13 % 1000
    t[-6:] = 999
    out = {k: v.astype(np.float32) for k, v in s.items()}
    out['stance'] = stance
    out['t'] = t.astype(np.int32)
    return out


def _chasing_state(rng):
    p0 = rng.standard_normal((N, 2))
    p1 = p0 + rng.uniform(1.0, 3.5, (N, 1)) * np.array([[0.6, 0.8]])   # distance 1 .. 3.5
    s = dict(p0=p0, v0=rng.uniform(0, 2, (N, 2)), p1=p1, v1=rng.uniform(-2, 2, (N, 2)))
    s['distance'] = np.sqrt(((s['p0'] - s['p1']) ** 2).sum(-1)) + rng.uniform(-.1, .1, N)
    t = np.arange(N) * 17 % 1024
    t[:5] = 1023
    return {k: v.astype(np.float32) for k, v in s.items()} | {'t': t.astype(np.int32)}


CASES = {
    'cartpole': dict(make=make_cartpole, jmake=jmake_cartpole, state=_cartpole_state,
                     cls=CartPoleState, jcls=JCartPole, body=fr.CARTPOLE_BODY,
                     jbody=jpr.CARTPOLE_BODY, env_class=CartPoleEnv),
    'hopper': dict(make=make_hopper, jmake=jmake_hopper, state=_hopper_state,
                   cls=HopperState, jcls=JHopper, body=fr.HOPPER_BODY,
                   jbody=jpr.HOPPER_BODY, env_class=HopperEnv),
    'chasing': dict(make=make_point_chasing, jmake=jmake_chasing, state=_chasing_state,
                    cls=ChasingState, jcls=JChasing, body=fr.CHASING_BODY,
                    jbody=jpr.CHASING_BODY, env_class=PointChasingVecEnv),
    'chasing_discrete': dict(make=make_point_chasing_discrete, jmake=jmake_chasing_disc,
                             state=_chasing_state, cls=ChasingState, jcls=JChasing,
                             body=fr.CHASING_DISCRETE_BODY,
                             jbody=jpr.CHASING_DISCRETE_BODY,
                             env_class=PointChasingDiscreteEnv),
}


def _setup(name, seed):
    """(case, env, jenv, port state, JAX state, action as numpy)."""
    case = CASES[name]
    rng = np.random.default_rng(seed)
    raw = case['state'](rng)
    env, jenv = case['make'](), case['jmake']()
    js = case['jcls'](**{k: jnp.asarray(v) for k, v in raw.items()})
    s = env_state_from_numpy(case['cls'], js, 'cpu')
    if env.spec.if_discrete:
        action = rng.integers(0, env.spec.action_dim, N).astype(np.int32)
    else:
        action = rng.uniform(-1.5, 1.5, (N, env.spec.action_dim)).astype(np.float32)
    return case, env, jenv, s, js, action


def _assert_states_close(s, js, atol=1e-6):
    for name in type(s)._fields:
        got, want = getattr(s, name).numpy(), np.asarray(getattr(js, name))
        if got.dtype.kind in 'bi':
            np.testing.assert_array_equal(got, want, err_msg=name)
        else:
            np.testing.assert_allclose(got, want, atol=atol, err_msg=name)


def _walker_uniforms(keys):
    """The draws ``make_point_chasing``'s step makes from its per-env keys."""
    return np.array(jax.vmap(lambda k: jax.random.uniform(k, (2,), jnp.float32))(keys))


@pytest.mark.parametrize('name', ENVS)
def test_env_step_and_obs_match_jax_env(name):
    case, env, jenv, s, js, action = _setup(name, 0)
    keys = jax.random.split(jax.random.PRNGKey(1), N)
    js2, jr, jterm, jtrunc = jax.vmap(jenv.step)(js, jnp.asarray(action), keys)
    a = torch.from_numpy(action)
    if name.startswith('chasing'):
        u = torch.from_numpy(_walker_uniforms(keys))
        a = grid_action(a, 2) if name == 'chasing_discrete' else a
        s2, r, term, trunc = chasing_step(s, a, u)
    else:
        s2, r, term, trunc = env.step(s, a)
    np.testing.assert_allclose(r.numpy(), np.asarray(jr), atol=1e-6)
    np.testing.assert_array_equal(term.numpy(), np.asarray(jterm))
    np.testing.assert_array_equal(trunc.numpy(), np.asarray(jtrunc))
    _assert_states_close(s2, js2)
    np.testing.assert_allclose(env.obs(s2).numpy(), np.asarray(jax.vmap(jenv.obs)(js2)),
                               atol=1e-6)
    assert term.any() and not term.all()
    if name in ('cartpole', 'hopper'):
        assert trunc.any()


@pytest.mark.parametrize('name', ENVS)
def test_kernel_body_matches_jax_body(name):
    case, env, _, s, js, action = _setup(name, 1)
    body, jbody = case['body'], case['jbody']
    rng = np.random.default_rng(11)
    u_step = rng.uniform(0, 1, (body.n_step, N)).astype(np.float32)
    u_reset = rng.uniform(0, 1, (body.n_reset, N)).astype(np.float32)
    env_a = (action[None].astype(np.float32) if body.discrete
             else np.tanh(action.T).astype(np.float32))
    jf, ji = jbody.pack(js)
    jf2, ji2, jr, jterm, jtrunc = jbody.step(jf, ji, jnp.asarray(env_a), jnp.asarray(u_step))
    jf3, ji3 = jbody.reset(jf2, ji2, jnp.asarray(u_reset), jterm | jtrunc)
    f, i = body.pack(s)
    np.testing.assert_array_equal(f.numpy(), np.asarray(jf))
    f2, i2, r, term, trunc = body.step(f, i, torch.from_numpy(env_a), torch.from_numpy(u_step))
    f3, i3 = body.reset(f2, i2, torch.from_numpy(u_reset), term | trunc)
    np.testing.assert_allclose(r.numpy(), np.asarray(jr), atol=1e-6)
    np.testing.assert_array_equal(term.numpy(), np.asarray(jterm))
    np.testing.assert_array_equal(trunc.numpy(), np.asarray(jtrunc))
    np.testing.assert_allclose(f2.numpy(), np.asarray(jf2), atol=1e-6)
    np.testing.assert_allclose(f3.numpy(), np.asarray(jf3), atol=2e-6)
    np.testing.assert_array_equal(i3.numpy(), np.asarray(ji3))
    np.testing.assert_allclose(body.obs(f3, i3).numpy(), np.asarray(jbody.obs(jf3, ji3)),
                               atol=2e-6)
    done = (term | trunc)[0].numpy()
    assert done.any() and not done.all() and (i3[0].numpy()[done] == 0).all()
    # unpack is pack's inverse
    _assert_states_close(body.unpack(f, i), js, atol=0)


@pytest.mark.parametrize('name', ENVS)
def test_env_and_kernel_body_agree(name):
    """The env module and its kernel body compute the same step."""
    case, env, _, s, _, action = _setup(name, 2)
    body = case['body']
    a = torch.from_numpy(action)
    u = torch.from_numpy(np.random.default_rng(5).uniform(0, 1, (N, 2)).astype(np.float32))
    if name.startswith('chasing'):
        s2, r, term, trunc = chasing_step(
            s, grid_action(a, 2) if name == 'chasing_discrete' else a, u)
    else:
        s2, r, term, trunc = env.step(s, a)
    f, i = body.pack(s)
    env_a = a[None].float() if body.discrete else a.T
    f2, i2, r_b, term_b, trunc_b = body.step(f, i, env_a, u.T[:body.n_step])
    np.testing.assert_allclose(r_b[0].numpy(), r.numpy(), atol=1e-6)
    np.testing.assert_array_equal(term_b[0].numpy(), term.numpy())
    np.testing.assert_array_equal(trunc_b[0].numpy(), trunc.numpy())
    want_f, want_i = body.pack(s2)
    np.testing.assert_allclose(f2.numpy(), want_f.numpy(), atol=1e-6)
    np.testing.assert_array_equal(i2.numpy(), want_i.numpy())


@pytest.mark.parametrize('name', ENVS)
def test_vec_step_masked_reset(name):
    """``vec_step`` returns the JAX ``vec_step``'s rewards and flags, keeps
    the stepped state where the episode goes on and a fresh one elsewhere."""
    case, env, jenv, s, js, action = _setup(name, 3)
    a = torch.from_numpy(action)
    s3, obs, r, term, trunc = vec_step(env, s, a, torch.Generator().manual_seed(0))
    done = (term | trunc).numpy()
    assert done.any() and not done.all()
    np.testing.assert_array_equal(s3.t.numpy()[done], 0)
    np.testing.assert_allclose(obs.numpy(), env.obs(s3).numpy())
    fresh = env.init(torch.Generator().manual_seed(0), N, 'cpu')
    for got, init in zip(s3, fresh):                 # fresh states have init's ranges
        if got.dtype.is_floating_point:
            assert float(got[done].abs().max()) <= float(init.abs().max()) * 3 + 1e-6
    if not name.startswith('chasing'):               # chasing's walker draws differ
        _, _, jr, jterm, jtrunc = jbase.vec_step(jenv, js, jnp.asarray(action),
                                                 jax.random.PRNGKey(2))
        stepped, _, _, _ = env.step(s, a)
        np.testing.assert_allclose(r.numpy(), np.asarray(jr), atol=1e-6)
        np.testing.assert_array_equal(term.numpy(), np.asarray(jterm))
        np.testing.assert_array_equal(trunc.numpy(), np.asarray(jtrunc))
        for got, want in zip(s3, stepped):
            np.testing.assert_array_equal(got.numpy()[~done], want.numpy()[~done])


@pytest.mark.parametrize('name', ENVS)
def test_init_matches_jax_init_in_distribution(name):
    """Fresh states: the same fields, shapes and dtypes as the JAX env's,
    with means and spreads that agree (4096 draws each)."""
    case = CASES[name]
    n = 4096
    s = case['make']().init(torch.Generator().manual_seed(0), n, 'cpu')
    js = jax.vmap(case['jmake']().init)(jax.random.split(jax.random.PRNGKey(0), n))
    assert type(s)._fields == type(js)._fields
    for f in type(s)._fields:
        got, want = getattr(s, f).numpy(), np.asarray(getattr(js, f))
        assert got.shape == want.shape and got.dtype == want.dtype, f
        np.testing.assert_allclose(got.mean(0), want.mean(0), atol=0.06, err_msg=f)
        np.testing.assert_allclose(got.std(0), want.std(0), atol=0.06, err_msg=f)


@pytest.mark.parametrize('name', ENVS)
def test_vec_env_adapter_and_build_env(name):
    case = CASES[name]
    spec = case['make']().spec
    env = build_env(case['env_class'], {'num_envs': 4, 'seed': 3, 'max_step': spec.max_step,
                                           'device': 'cpu'})
    env_args = get_gym_env_args(env, if_print=False)
    assert env_args == {'env_name': spec.env_name, 'num_envs': 4, 'max_step': spec.max_step,
                        'state_dim': spec.state_dim, 'action_dim': spec.action_dim,
                        'if_discrete': spec.if_discrete}
    obs, _ = env.reset()
    assert obs.shape == (4, spec.state_dim)
    action = (np.ones(4, np.int64) if spec.if_discrete
              else np.zeros((4, spec.action_dim), np.float32))
    obs, r, term, trunc, _ = env.step(action)
    assert obs.shape == (4, spec.state_dim) and r.shape == (4,)
    assert term.dtype == torch.bool and trunc.dtype == torch.bool


def test_atan2_polynomial_matches_jax():
    rng = np.random.default_rng(0)
    y = np.concatenate([rng.standard_normal(4000), [0.0, 0.0, 1.0, -1.0, 1e-20]])
    x = np.concatenate([rng.standard_normal(4000), [1.0, -1.0, 0.0, 0.0, 1e-20]])
    y, x = y.astype(np.float32), x.astype(np.float32)
    got = fr._atan2(torch.from_numpy(y), torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jpr._atan2(jnp.asarray(y), jnp.asarray(x))),
                               atol=1e-6)
    np.testing.assert_allclose(got, np.arctan2(y, x), atol=1e-6)


def test_grid_action_decodes_base_three():
    idx = torch.arange(9)
    want = np.array([[-1, -1], [0, -1], [1, -1], [-1, 0], [0, 0], [1, 0],
                     [-1, 1], [0, 1], [1, 1]], np.float32)
    np.testing.assert_array_equal(grid_action(idx, 2).numpy(), want)
    # the body's floor-form decode gives the same grid
    f = torch.zeros(9, 9)
    f[8] = 8.0
    stepped = fr.CHASING_DISCRETE_BODY.step(f, torch.zeros(1, 9, dtype=torch.int32),
                                            idx[None].float(), torch.zeros(2, 9))
    l2 = np.maximum(np.sqrt((want ** 2).sum(-1)), 1.0)
    np.testing.assert_allclose(stepped[0][6:8].T.numpy(), want / l2[:, None], atol=1e-7)


def test_single_env_and_other_dims():
    env = PointChasingEnv(seed=1, device='cpu')
    assert env.num_envs == 1 and env.reset()[0].shape == (1, 8)
    env3 = PointChasingVecEnv(dim=3, env_num=5, device='cpu')
    assert env3.state_dim == 12 and env3.action_dim == 3
    obs, r, term, _, _ = env3.step(np.zeros((5, 3), np.float32)) if env3.reset() else None
    assert obs.shape == (5, 12) and math.isfinite(float(r.sum())) and not term.any()
