"""Parity of the port's Pendulum-v1 (``elegantrl_tpu_torch.envs``) and its
fused-rollout body (``ops/fused_rollout.py:PENDULUM_BODY``) with the JAX
package's ``make_pendulum()`` and ``PENDULUM_BODY``, on the same states,
actions and reset uniforms (numpy, seeded).  Step counters are staggered
so that truncation fires.

Tolerance 1e-5 absolute: the angle wrap is ``%`` in the env modules and a
floor form in the kernel bodies, which agree to f32 rounding; everything
else is the same f32 arithmetic.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import torch

from elegantrl_tpu.envs.pendulum import PendulumState as JState, make_pendulum as jmake
from elegantrl_tpu.ops.pallas_rollout import PENDULUM_BODY as JBODY
from elegantrl_tpu_torch.envs import PendulumEnv, PendulumState, make_pendulum, vec_step
from elegantrl_tpu_torch.ops.fused_rollout import PENDULUM_BODY

torch.set_num_threads(1)
N = 64


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    theta = rng.uniform(-3 * math.pi, 3 * math.pi, N).astype(np.float32)
    theta_dot = rng.uniform(-8, 8, N).astype(np.float32)
    t = (np.arange(N) * 7 % 200).astype(np.int32)
    t[:4] = 199                                        # these truncate now
    action = rng.uniform(-1, 1, (N, 1)).astype(np.float32)
    u_reset = rng.uniform(0, 1, (2, N)).astype(np.float32)
    return theta, theta_dot, t, action, u_reset


def test_step_and_obs_match_jax_env():
    theta, theta_dot, t, action, _ = _inputs()
    jenv = jmake()
    js = JState(jnp.asarray(theta), jnp.asarray(theta_dot), jnp.asarray(t))
    js2, jr, jterm, jtrunc = jax.vmap(jenv.step)(js, jnp.asarray(action),
                                                  jax.random.split(jax.random.PRNGKey(0), N))
    env = make_pendulum()
    s = PendulumState(torch.from_numpy(theta), torch.from_numpy(theta_dot), torch.from_numpy(t))
    s2, r, term, trunc = env.step(s, torch.from_numpy(action))
    np.testing.assert_allclose(r.numpy(), np.asarray(jr), atol=1e-5)
    np.testing.assert_allclose(s2.theta.numpy(), np.asarray(js2.theta), atol=1e-5)
    np.testing.assert_allclose(s2.theta_dot.numpy(), np.asarray(js2.theta_dot), atol=1e-5)
    np.testing.assert_array_equal(s2.t.numpy(), np.asarray(js2.t))
    np.testing.assert_array_equal(trunc.numpy(), np.asarray(jtrunc))
    np.testing.assert_array_equal(term.numpy(), np.asarray(jterm))
    assert trunc[:4].all() and not trunc[4:].all()
    np.testing.assert_allclose(env.obs(s2).numpy(), np.asarray(jax.vmap(jenv.obs)(js2)),
                               atol=1e-6)


def test_kernel_body_matches_jax_body():
    theta, theta_dot, t, action, u_reset = _inputs(1)
    jf = jnp.stack([jnp.asarray(theta), jnp.asarray(theta_dot)])
    ji = jnp.asarray(t)[None]
    ja = jnp.tanh(jnp.asarray(action).T)
    jf2, ji2, jr, jterm, jtrunc = JBODY.step(jf, ji, ja, None)
    jf3, ji3 = JBODY.reset(jf2, ji2, jnp.asarray(u_reset), jterm | jtrunc)
    f = torch.from_numpy(np.stack([theta, theta_dot]))
    i = torch.from_numpy(t)[None]
    f2, i2, r, term, trunc = PENDULUM_BODY.step(f, i, torch.tanh(torch.from_numpy(action.T)))
    f3, i3 = PENDULUM_BODY.reset(f2, i2, torch.from_numpy(u_reset), term | trunc)
    np.testing.assert_allclose(r.numpy(), np.asarray(jr), atol=1e-5)
    np.testing.assert_array_equal(trunc.numpy(), np.asarray(jtrunc))
    np.testing.assert_allclose(f3.numpy(), np.asarray(jf3), atol=1e-5)
    np.testing.assert_array_equal(i3.numpy(), np.asarray(ji3))
    np.testing.assert_allclose(PENDULUM_BODY.obs(f3, i3).numpy(),
                               np.asarray(JBODY.obs(jf3, ji3)), atol=1e-6)


def test_env_and_kernel_body_agree():
    """The env's ``%`` wrap and the body's floor wrap give the same step."""
    theta, theta_dot, t, action, _ = _inputs(2)
    a = torch.tanh(torch.from_numpy(action))
    s2, r, _, trunc = make_pendulum().step(
        PendulumState(torch.from_numpy(theta), torch.from_numpy(theta_dot), torch.from_numpy(t)), a)
    f2, i2, r_b, _, trunc_b = PENDULUM_BODY.step(
        torch.from_numpy(np.stack([theta, theta_dot])), torch.from_numpy(t)[None], a.T)
    np.testing.assert_allclose(r_b[0].numpy(), r.numpy(), atol=1e-5)
    np.testing.assert_allclose(f2[0].numpy(), s2.theta.numpy(), atol=1e-6)
    np.testing.assert_array_equal(trunc_b[0].numpy(), trunc.numpy())


def test_vec_step_masked_reset():
    theta, theta_dot, t, action, _ = _inputs(3)
    env = make_pendulum()
    s = PendulumState(torch.from_numpy(theta), torch.from_numpy(theta_dot), torch.from_numpy(t))
    stepped, _, _, _ = env.step(s, torch.from_numpy(action))
    s3, obs, _, term, trunc = vec_step(env, s, torch.from_numpy(action),
                                       torch.Generator().manual_seed(0))
    done = (term | trunc).numpy()
    assert done.any() and not done.all()
    np.testing.assert_array_equal(s3.t.numpy()[done], 0)
    assert np.all(np.abs(s3.theta.numpy()[done]) <= math.pi)
    assert np.all(np.abs(s3.theta_dot.numpy()[done]) <= 1.0)
    np.testing.assert_array_equal(s3.theta.numpy()[~done], stepped.theta.numpy()[~done])
    np.testing.assert_allclose(obs.numpy(), env.obs(s3).numpy())


def test_vec_env_adapter():
    env = PendulumEnv(num_envs=4, seed=0, device='cpu')
    obs, _ = env.reset()
    assert obs.shape == (4, 3)
    obs, r, term, trunc, _ = env.step(np.zeros((4, 1), np.float32))
    assert obs.shape == (4, 3) and r.shape == (4,) and not term.any() and not trunc.any()
