"""The helpers of ``elegantrl_tpu_torch/ops/nets.py`` that answer to the last
public functions of ``elegantrl_tpu/ops/nets.py`` (``soft_update``,
``ensemble_init``, ``global_norm``, ``densenet_init``/``densenet_apply``,
``ou_noise_step``), held against the JAX package on the same inputs (made
with numpy from a seed; the JAX draws handed to the port).

Tolerances: float32 arithmetic of the same formula, rtol 1e-6 / atol 1e-7;
the DenseNet's two products, rtol 1e-5 / atol 1e-6.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elegantrl_tpu.ops import nets as jnets
from elegantrl_tpu_torch.ops import nets

RTOL, ATOL = 1e-6, 1e-7


def _tree(rng):
    return {'a': [rng.standard_normal((3, 4)).astype(np.float32),
                  rng.standard_normal(4).astype(np.float32)],
            'b': (rng.standard_normal((2,)).astype(np.float32),)}


def _to_torch(tree):
    return jax.tree.map(torch.from_numpy, tree)


def test_soft_update_as_jax():
    rng = np.random.default_rng(0)
    target, online = _tree(rng), _tree(rng)
    want = jnets.soft_update(jax.tree.map(jnp.asarray, target),
                             jax.tree.map(jnp.asarray, online), 0.3)
    got = nets.soft_update(_to_torch(target), _to_torch(online), 0.3)
    assert isinstance(got['b'], tuple) and isinstance(got['a'], list)
    for g, w in zip(jax.tree.leaves(jax.tree.map(lambda x: x.numpy(), got,
                                                 is_leaf=lambda x: isinstance(x, torch.Tensor))),
                    jax.tree.leaves(want)):
        np.testing.assert_allclose(g, np.asarray(w), rtol=RTOL, atol=ATOL)
    # a flat buffer, as the in-place soft_update_ updates it
    t, o = torch.from_numpy(target['a'][0]).flatten(), torch.from_numpy(online['a'][0]).flatten()
    out = nets.soft_update(t, o, 0.3)
    nets.soft_update_(t, o, 0.3)
    assert torch.equal(out, t)


def test_global_norm_as_jax():
    tree = _tree(np.random.default_rng(1))
    want = float(jnets.global_norm(jax.tree.map(jnp.asarray, tree)))
    np.testing.assert_allclose(float(nets.global_norm(_to_torch(tree))), want, rtol=RTOL)


def test_ensemble_init_stacks_independent_members():
    gen = torch.Generator().manual_seed(0)
    params = nets.ensemble_init(gen, 4, lambda g: nets.densenet_init(g, 8))
    jparams = jnets.ensemble_init(jax.random.key(0), 4, lambda k: jnets.densenet_init(k, 8))
    for name in ('dense1', 'dense2'):
        (w, b), (jw, jb) = params[name], jparams[name]
        assert w.shape == (4, *np.asarray(jw).shape[1:][::-1])   # W (out, in) per member
        assert b.shape == np.asarray(jb).shape
        assert float((w[0] - w[1]).abs().sum()) > 0              # the members differ
        bound = 1 / np.sqrt(w.shape[-1])                          # linear_init's range
        assert float(w.abs().max()) <= bound and float(np.abs(np.asarray(jw)).max()) <= bound


def test_densenet_as_jax():
    jp = jnets.densenet_init(jax.random.key(3), 16)
    x = np.random.default_rng(2).standard_normal((5, 16)).astype(np.float32)
    want = np.asarray(jnets.densenet_apply(jp, jnp.asarray(x)))
    params = {k: (torch.from_numpy(np.asarray(w).T.copy()), torch.from_numpy(np.asarray(b)))
              for k, (w, b) in jp.items()}
    got = nets.densenet_apply(params, torch.from_numpy(x))
    assert got.shape == (5, 64)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    mine = nets.densenet_init(torch.Generator().manual_seed(0), 16)
    assert mine['dense1'][0].shape == (16, 16) and mine['dense2'][0].shape == (32, 32)


@pytest.mark.parametrize('theta,sigma,dt', [(0.15, 0.3, 1e-2), (0.5, 1.0, 0.1)])
def test_ou_noise_step_as_jax(theta, sigma, dt):
    key = jax.random.key(4)
    n = jnp.asarray(np.random.default_rng(3).standard_normal(6).astype(np.float32))
    want = jnets.ou_noise_step(n, key, theta, sigma, dt)
    z = jax.random.normal(key, n.shape)          # the draw ou_noise_step takes
    got = nets.ou_noise_step(torch.from_numpy(np.asarray(n)), theta=theta, sigma=sigma, dt=dt,
                             normal=torch.from_numpy(np.asarray(z)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
    # from a generator: the stationary scale sigma / sqrt(2 theta)
    gen = torch.Generator().manual_seed(0)
    x, vals = torch.zeros(4), []
    for _ in range(3000):
        x = nets.ou_noise_step(x, gen, 0.15, 0.3, 1e-2)
        vals.append(x)
    std = float(torch.stack(vals)[500:].std())
    assert 0.5 * 0.3 / np.sqrt(0.3) < std < 1.5 * 0.3 / np.sqrt(0.3)
