"""LunarLander, discrete and continuous (``elegantrl_tpu_torch/envs/lunar_lander.py``),
against the JAX package's env (``elegantrl_tpu/envs/lunar_lander.py``).

- The step: 16 landers from injected states (some near the pad, some near
  the 1000-step truncation) take 200 steps of the same random actions
  through both packages' ``step``; the port steps from every state of the
  JAX trajectory, so a flag that one package's last bit flips cannot carry
  into the next step.  obs, terminal and truncate agree to 1e-5 (f32 sin, cos and
  sqrt of two libraries), the reward to 1e-5 of the two shapings it is the
  difference of (|shaping| up to ~300, where one f32 ulp is 3e-5).
- The reset: the three uniforms' ranges, and the initial shaping equal to
  the JAX package's ``_shaping`` of the same draws.
- The auto-reset of ``vec_step``: done landers restart, the others go on.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elegantrl_tpu.envs import lunar_lander as jll
from elegantrl_tpu_torch.config import build_env
from elegantrl_tpu_torch.envs import (LanderState, LunarLanderContinuousEnv, LunarLanderEnv,
                                      make_lunar_lander, vec_step)

torch.set_num_threads(1)
N, STEPS = 16, 200


def _injected(rng):
    """Landers in flight, near the pad and near the step limit."""
    f = lambda lo, hi: rng.uniform(lo, hi, N).astype(np.float32)  # noqa: E731
    x, y = f(-0.9, 0.9), f(-0.02, 1.4)
    y[:4] = f(0.0, 0.03)[:4]                       # about to touch down
    return dict(x=x, y=y, vx=f(-0.5, 0.5), vy=f(-0.8, 0.3), theta=f(-0.5, 0.5),
                omega=f(-0.3, 0.3),
                t=rng.integers(0, 999, N).astype(np.int32) * (rng.random(N) < 0.7)
                + np.int32(990) * (rng.random(N) >= 0.7).astype(np.int32),
                prev_shaping=f(-200.0, 0.0))


@pytest.mark.parametrize('continuous', [False, True], ids=['discrete', 'continuous'])
def test_step_matches_jax(continuous):
    rng = np.random.default_rng(7 + continuous)
    jenv = jll.make_lunar_lander(continuous)
    env = make_lunar_lander(continuous)
    if continuous:
        actions = rng.uniform(-1, 1, (STEPS, N, 2)).astype(np.float32)
    else:
        actions = rng.integers(0, 4, (STEPS, N)).astype(np.int32)
    fresh = [_injected(rng) for _ in range(STEPS)]
    fresh = jll.LanderState(**{k: jnp.asarray(np.stack([f[k] for f in fresh]))
                               for k in fresh[0]})
    keys = jax.random.split(jax.random.PRNGKey(0), N)

    @jax.jit
    def run(s0):
        def body(s, xs):
            a, new = xs
            s2, r, term, trunc = jax.vmap(jenv.step)(s, a, keys)
            # landers that ended are put back in flight, so every step
            # exercises the dynamics
            done = term | trunc
            nxt = jax.tree.map(lambda x, y: jnp.where(done, y, x), s2, new)
            return nxt, (s, s2, r, term, trunc)
        return jax.lax.scan(body, s0, (jnp.asarray(actions), fresh))[1]

    s0 = jll.LanderState(**{k: jnp.asarray(v) for k, v in _injected(rng).items()})
    js, js2, jr, jterm, jtrunc = jax.tree.map(np.asarray, run(s0))
    # the port steps every (state, action) of the JAX trajectory in one batch
    flat = lambda x: torch.tensor(x.reshape((STEPS * N,) + x.shape[2:]))  # noqa: E731
    s = LanderState(*[flat(getattr(js, k)) for k in LanderState._fields])
    s2, r, term, trunc = env.step(s, flat(actions), None)
    jobs = jax.vmap(jenv.obs)(jax.tree.map(lambda x: x.reshape((STEPS * N,) + x.shape[2:]),
                                           js2))
    np.testing.assert_allclose(env.obs(s2).numpy(), np.asarray(jobs), rtol=1e-5, atol=1e-5)
    # the reward is a difference of shapings of up to ~300 in size: 1e-5 of them
    scale = np.abs(js.prev_shaping) + np.abs(js2.prev_shaping) + 1.0
    assert np.all(np.abs(r.numpy() - jr.reshape(-1)) <= 1e-5 * scale.reshape(-1))
    np.testing.assert_array_equal(term.numpy(), jterm.reshape(-1))
    np.testing.assert_array_equal(trunc.numpy(), jtrunc.reshape(-1))
    np.testing.assert_allclose(s2.prev_shaping.numpy(), js2.prev_shaping.reshape(-1),
                               rtol=1e-5, atol=1e-5)
    assert jterm.sum() > 0 and jtrunc.sum() > 0 and np.abs(jr).max() > 50


def test_reset_ranges_and_shaping_match_jax():
    env = make_lunar_lander(True)
    gen = torch.Generator().manual_seed(3)
    s = env.init(gen, 4096, 'cpu')
    assert float(s.x.abs().max()) == 0 and float(s.theta.abs().max()) == 0
    assert torch.all(s.y == np.float32(1.41)) and int(s.t.abs().max()) == 0
    for field, bound in (('vx', 0.84), ('vy', 0.55), ('omega', 0.19)):
        v = getattr(s, field)
        assert float(v.abs().max()) <= bound and float(v.abs().max()) > 0.97 * bound, field
        assert abs(float(v.mean())) < 0.05 * bound, field
    j = jax.jit(jax.vmap(jll._init))(jax.random.split(jax.random.PRNGKey(0), 4096))
    for field, bound in (('vx', 0.84), ('vy', 0.55), ('omega', 0.19)):
        assert float(jnp.max(jnp.abs(getattr(j, field)))) <= bound
    l1, l2 = jll._leg_contacts(jnp.asarray(s.x.numpy()), jnp.asarray(s.y.numpy()),
                               jnp.asarray(s.theta.numpy()))
    want = jll._shaping(*[jnp.asarray(getattr(s, k).numpy()) for k in
                          ('x', 'y', 'vx', 'vy', 'theta')], l1, l2)
    np.testing.assert_allclose(s.prev_shaping.numpy(), np.asarray(want), rtol=1e-6, atol=1e-4)
    np.testing.assert_allclose(env.obs(s).numpy(), np.asarray(jax.vmap(jll._obs)(
        jll.LanderState(*[jnp.asarray(getattr(s, k).numpy()) for k in LanderState._fields]))),
        rtol=0, atol=0)


def test_auto_reset():
    env = make_lunar_lander(False)
    gen = torch.Generator().manual_seed(0)
    s = env.init(gen, 8, 'cpu')
    # lander 0 is out of bounds, lander 1 at its last step, the rest fly on
    s = s._replace(x=s.x.clone().index_fill_(0, torch.tensor([0]), 0.999),
                   vx=s.vx.clone().index_fill_(0, torch.tensor([0]), 0.8),
                   t=s.t.clone().index_fill_(0, torch.tensor([1]), 999))
    action = torch.zeros(8, dtype=torch.int32)
    stepped, _, term, trunc = env.step(s, action, None)
    s3, obs, _, term2, trunc2 = vec_step(env, s, action, gen)
    assert term.tolist()[:2] == [True, False] and trunc.tolist()[:2] == [False, True]
    assert torch.equal(term, term2) and torch.equal(trunc, trunc2)
    done = term | trunc
    assert torch.all(s3.t[done] == 0) and torch.all(s3.x[done] == 0)
    assert torch.all(s3.y[done] == np.float32(1.41))
    for k in LanderState._fields:
        assert torch.equal(getattr(s3, k)[~done], getattr(stepped, k)[~done]), k
    assert torch.equal(obs, env.obs(s3))


@pytest.mark.parametrize('cls,name,A,discrete', [
    (LunarLanderEnv, 'LunarLander-v2', 4, True),
    (LunarLanderContinuousEnv, 'LunarLanderContinuous-v2', 2, False)])
def test_vec_env_protocol(cls, name, A, discrete):
    env = build_env(cls, {'env_name': name, 'num_envs': 3, 'state_dim': 8, 'action_dim': A,
                          'if_discrete': discrete})
    assert (env.env_name, env.num_envs, env.max_step, env.state_dim, env.action_dim,
            env.if_discrete) == (name, 3, 12345, 8, A, discrete)
    assert env.spec.max_step == 1000 and env._def.kernel_body is None
    obs, _ = env.reset()
    action = torch.zeros(3, dtype=torch.int32) if discrete else torch.zeros(3, A)
    obs2, r, term, trunc, _ = env.step(action)
    assert obs.shape == obs2.shape == (3, 8) and r.shape == (3,)
