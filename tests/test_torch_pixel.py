"""The pixel path of the port (``envs/pixel_chasing.py``, ``ops/nets.py``'s
ConvNet, ``agents/pixel.py``) against the JAX package's:

- ``_render`` on the same chasing states within 1e-3 of images that reach
  255: the two linspace grids differ by up to 2 ulp of 14 (XLA's jitted
  ``jnp.linspace`` rounds otherwise than ``torch.linspace``), which the
  blob's slope, up to ~300 a world unit at 255, turns into up to ~7.5e-4;
- ``convnet_apply`` at 64 and 112 px on the same weights (HWIO carried to
  OIHW through numpy) within 1e-5;
- one pixel-PPO update from the same rollout, with the JAX scan's minibatch
  ids (``randint`` per ``split(key, U)`` key), parameters and Adam moments
  within 1e-5;
- the state's conversion both ways, and a ``train_agent`` round.

Tolerance: f32 sums in another order (a convolution's and a matmul's),
through a few Adam steps of learning rate 3e-4.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elegantrl_tpu.agents.pixel import make_pixel_ppo as jmake_pixel_ppo
from elegantrl_tpu.agents.base import Rollout as JRollout
from elegantrl_tpu.config import Config as JConfig
from elegantrl_tpu.envs.pixel_chasing import _render as jrender
from elegantrl_tpu.envs.point_chasing import ChasingState as JChasingState
from elegantrl_tpu.ops import nets as jnets
from elegantrl_tpu_torch import AgentPixelPPO, Config, PixelChasingEnv, train_agent
from elegantrl_tpu_torch.agents.base import Rollout
from elegantrl_tpu_torch.agents.pixel import make_pixel_ppo
from elegantrl_tpu_torch.envs.pixel_chasing import _render
from elegantrl_tpu_torch.envs.point_chasing import ChasingState
from elegantrl_tpu_torch.ops import nets
from elegantrl_tpu_torch.utils.jax_params import pixel_ppo_state_from_numpy

torch.set_num_threads(1)
SHAPE = (64, 64, 2)
H, N, B, U = 4, 4, 8, 2


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def test_render_matches_jax():
    rng = np.random.default_rng(0)
    p0, p1 = rng.uniform(-15, 15, (2, 5, 2)).astype(np.float32)
    z = np.zeros((5, 2), np.float32)
    want = np.asarray(jax.jit(jax.vmap(jrender))(JChasingState(
        p0=jnp.asarray(p0), v0=jnp.asarray(z), p1=jnp.asarray(p1), v1=jnp.asarray(z),
        distance=jnp.zeros(5), t=jnp.zeros(5, jnp.int32))))
    got = _render(ChasingState(*[torch.from_numpy(x) for x in (p0, z, p1, z)],
                               torch.zeros(5), torch.zeros(5, dtype=torch.int32)))
    assert got.shape == (5,) + SHAPE and float(got.max()) > 100.0
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-3)


@pytest.mark.parametrize('size', [64, 112])
def test_convnet_apply_matches_jax(size):
    params = jnets.convnet_init(jax.random.PRNGKey(size), 2, 32, size)
    x = np.random.default_rng(1).uniform(0, 255, (3, size, size, 2)).astype(np.float32)
    want = np.asarray(jax.jit(lambda p, xx: jnets.convnet_apply(p, xx, size))(params, x))
    leaves = []
    for w, b in params[:-1]:
        leaves += [torch.from_numpy(np.asarray(w)).permute(3, 2, 0, 1).contiguous(),
                   torch.from_numpy(np.asarray(b))]
    leaves += [torch.from_numpy(np.asarray(params[-1][0]).T.copy()),
               torch.from_numpy(np.asarray(params[-1][1]))]
    assert [tuple(t.shape) for t in leaves] == [tuple(s) for s in nets.convnet_shapes(2, 32, size)]
    got = nets.convnet_apply(leaves, torch.from_numpy(x), size)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


def _args(cls):
    a = cls()
    a.net_dims, a.encoder_dim, a.batch_size, a.repeat_times = (16,), 16, B, 4.0
    a.learning_rate, a.gamma = 3e-4, 0.97
    return a


def test_update_matches_jax_scan():
    jagent = jmake_pixel_ppo((16,), SHAPE, 2, _args(JConfig))
    js = jagent.init(jax.random.PRNGKey(0))
    rng = np.random.default_rng(2)
    ro = dict(states=rng.uniform(0, 255, (H, N) + SHAPE).astype(np.float32),
              actions=rng.standard_normal((H, N, 2)).astype(np.float32),
              logprobs=(rng.standard_normal((H, N)) * 0.3 - 2.0).astype(np.float32),
              rewards=rng.standard_normal((H, N)).astype(np.float32),
              undones=(rng.random((H, N)) > 0.2).astype(np.float32),
              unmasks=(rng.random((H, N)) > 0.1).astype(np.float32))
    last = rng.uniform(0, 255, (N,) + SHAPE).astype(np.float32)
    key = jax.random.PRNGKey(5)
    js2, jm = jax.jit(jagent.update)(js, JRollout(**{k: jnp.asarray(v) for k, v in ro.items()}),
                                     jnp.asarray(last), key)
    ids = np.asarray(jax.vmap(lambda k: jax.random.randint(k, (B,), 0, H * N))(
        jax.random.split(key, U)))
    agent = make_pixel_ppo((16,), SHAPE, 2, _args(Config))
    s = pixel_ppo_state_from_numpy(_np(js), 'cpu')
    s2, m = agent.update(s, Rollout(**{k: torch.from_numpy(v) for k, v in ro.items()}),
                         torch.from_numpy(last), None, ids=torch.from_numpy(ids).long())
    got, want = jax.tree.leaves(agent.state_to_numpy(s2)), jax.tree.leaves(_np(js2))
    assert len(got) == len(want)
    for x, y in zip(got, want):
        np.testing.assert_allclose(np.asarray(x, np.float64), np.asarray(y, np.float64),
                                   rtol=0, atol=1e-5)
    for k in ('obj_critic', 'obj_actor'):
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-4, atol=1e-6)


def test_state_conversion_round_trip():
    jagent = jmake_pixel_ppo((16,), SHAPE, 2, _args(JConfig))
    js = _np(jagent.init(jax.random.PRNGKey(3)))
    agent = make_pixel_ppo((16,), SHAPE, 2, _args(Config))
    back = agent.state_to_numpy(pixel_ppo_state_from_numpy(js, 'cpu'))
    assert len(jax.tree.leaves(back)) == len(jax.tree.leaves(js))
    for x, y in zip(jax.tree.leaves(back), jax.tree.leaves(js)):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def test_train_agent_round(tmp_path):
    args = Config(AgentPixelPPO, PixelChasingEnv,
                  {'env_name': 'PixelChasing-v0', 'num_envs': 4, 'max_step': 200,
                   'state_dim': SHAPE, 'action_dim': 2, 'if_discrete': False})
    args.device, args.net_dims, args.encoder_dim = 'cpu', (16,), 16
    args.horizon_len, args.batch_size, args.repeat_times = 16, 32, 2
    args.eval_per_step, args.eval_times, args.break_step = 64, 2, 64
    args.cwd = str(tmp_path / 'pixel')
    r = train_agent(args)
    assert r['recorder'].shape[0] == 2 and np.isfinite(r['recorder']).all()
