"""Shared pieces of ``test_torch_marl.py`` and ``test_torch_marl_rnn.py``:
the JAX draws of the multi-agent rounds (the keys split as the JAX rounds
split them) and the comparisons with their tolerances (see
``test_torch_marl.py``)."""
import jax
import numpy as np
import torch

from elegantrl_tpu_torch.marl.chasing import TeamChaseState
from elegantrl_tpu_torch.utils.checkpoint import tree_leaves, tree_leaves_with_path

M, DIM, N, H = 2, 2, 8, 8
RTOL, ATOL = 1e-5, 1e-6


def _init_draws(key, n):
    """The normals ``vmap(env.init)(split(key, n))`` takes."""
    def one(k):
        k1, k2 = jax.random.split(k)
        return jax.random.normal(k1, (DIM,)), jax.random.normal(k2, (M, DIM))
    return jax.vmap(one)(jax.random.split(key, n))


def _step_draws(key, n):
    """The uniforms ``vmap(env.step)(..., split(key, n))`` takes."""
    return jax.vmap(lambda k: jax.random.uniform(k, (DIM,)))(jax.random.split(key, n))


def _t(x, dtype=None):
    return torch.tensor(np.asarray(x), dtype=dtype)


def _env_state(jstate):
    return TeamChaseState(*[_t(getattr(jstate, f)) for f in TeamChaseState._fields])


def _close(got, want, rtol=RTOL, atol=ATOL, what=''):
    g, w = tree_leaves(got), jax.tree.leaves(want)
    assert len(g) == len(w), (what, len(g), len(w))
    for i, (a, b) in enumerate(zip(g, w)):
        np.testing.assert_allclose(np.asarray(a, np.float64), np.asarray(b, np.float64),
                                   rtol=rtol, atol=atol, err_msg=f'{what} leaf {i}')


def _close_state(got, want, groups, lr, steps, what=''):
    """``got`` (a port state's numpy tree) against ``want`` (the JAX state)
    within RTOL / ATOL, but for the parameters at the gradient's noise
    floor: ``groups`` maps each optimised group's path prefix to its Adam
    first moment's (``{'actor': 'act_opt/1/0/mu'}``), and an element of such
    a group that is off by more may differ by up to ``lr * steps`` where the
    JAX first moment is within 1e-6 of zero."""
    paths = [p for p, _ in tree_leaves_with_path(got)]
    g, w = tree_leaves(got), jax.tree.leaves(want)
    assert len(g) == len(w), (what, len(g), len(w))
    index = {p: i for i, p in enumerate(paths)}
    for i, (path, a, b) in enumerate(zip(paths, g, w)):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        off = np.abs(a - b) > ATOL + RTOL * np.abs(b)
        group = next((k for k in groups if path.startswith(k + '/')), None)
        if group is not None and off.any():
            mu = np.abs(np.asarray(w[index[groups[group] + path[len(group):]]], np.float64))
            assert (mu[off] <= 1e-6).all() and off.mean() <= 0.02, (what, path, mu[off])
            assert (np.abs(a - b)[off] <= lr * steps).all(), (what, path)
            continue
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL, err_msg=f'{what} {path}')


def _ppo_rollout_draws(k_roll, horizon, n, extra_keys=0):
    """The per-step draws of the MAPPO rounds: action normals ``(H, N, M,
    A)`` from ``ka``, the env's uniforms from ``ke``, the fresh envs' normals
    from ``kr`` (``ka, ke, kr = split(kt, 3)`` for ``kt`` in ``split(k_roll,
    H)``)."""
    def per_step(kt):
        ka, ke, kr = jax.random.split(kt, 3)
        return (jax.random.normal(ka, (n, M, DIM)), _step_draws(ke, n), _init_draws(kr, n))
    act, env_u, reset = jax.vmap(per_step)(jax.random.split(k_roll, horizon))
    return {'act': _t(act), 'env': _t(env_u), 'reset': tuple(map(_t, reset))}


def _eval_draws(key, episodes, max_step):
    return {'init': tuple(map(_t, _init_draws(key, episodes))),
            'env': _t(jax.vmap(lambda k: _step_draws(k, episodes))(
                jax.random.split(key, max_step)))}


def _rollout_keys(k_roll, horizon, n, n_keys):
    """Per step ``split(kt, n_keys)`` for ``kt`` in ``split(k_roll, H)``:
    the env's uniforms from the second key, the fresh envs' normals from the
    third (``ka, ke, kr[, kg]``)."""
    def per_step(kt):
        ks = jax.random.split(kt, n_keys)
        return ks, _step_draws(ks[1], n), _init_draws(ks[2], n)
    return jax.vmap(per_step)(jax.random.split(k_roll, horizon))


def _qmix_draws(k_roll, horizon, n, A):
    """QMIX's per-step draws: ``ka, ke, kr, kg = split(kt, 4)``, the coin
    uniforms from ``ka``, the random actions from ``kg``."""
    ks, env_u, reset = _rollout_keys(k_roll, horizon, n, 4)
    return {'coin': _t(jax.vmap(lambda k: jax.random.uniform(k, (n, M)))(ks[:, 0])),
            'rand': _t(jax.vmap(lambda k: jax.random.randint(k, (n, M), 0, A))(ks[:, 3])),
            'env': _t(env_u), 'reset': tuple(map(_t, reset))}


