"""Parity of the port's ``ops/gae.py`` with the JAX package's, at H=12
(where JAX runs its sequential scan) and H=32 (its associative scan).

Tolerance: 1e-5 relative and absolute.  The port runs a plain reverse
loop; JAX's associative form reassociates the f32 sums.
"""
import numpy as np
import pytest
import torch

from elegantrl_tpu.ops import gae as jgae
from elegantrl_tpu_torch.ops import gae

torch.set_num_threads(1)
N = 16
TOL = dict(rtol=1e-5, atol=1e-5)


def _inputs(h, seed=0):
    rng = np.random.default_rng(seed)
    rewards = rng.standard_normal((h, N)).astype(np.float32)
    values = rng.standard_normal((h, N)).astype(np.float32)
    undones = (rng.uniform(size=(h, N)) > 0.1).astype(np.float32)
    unmasks = (rng.uniform(size=(h, N)) > 0.1).astype(np.float32)
    next_value = rng.standard_normal(N).astype(np.float32)
    return rewards, undones, unmasks, values, next_value


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize('h', [12, 32])
def test_truncation_bootstrap(h):
    r, d, m, v, _ = _inputs(h)
    want = jgae.apply_truncation_bootstrap(r, d, m, v)
    got = gae.apply_truncation_bootstrap(*_t(r, d, m, v))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


@pytest.mark.parametrize('h', [12, 32])
def test_gae_vtrace(h):
    r, d, m, v, nv = _inputs(h, 1)
    want = jgae.gae_vtrace(r, d, v, nv, 0.99, 0.95)
    got = gae.gae_vtrace(*_t(r, d, v, nv), 0.99, 0.95)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize('h', [12, 32])
def test_gae_plain(h):
    r, d, m, v, _ = _inputs(h, 2)
    want = jgae.gae_plain(r, d, v, 0.99, 0.95)
    got = gae.gae_plain(*_t(r, d, v), 0.99, 0.95)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize('h', [12, 32])
def test_normalize_advantages(h):
    adv = np.random.default_rng(3).standard_normal((h, N)).astype(np.float32) * 3 + 1
    want = jgae.normalize_advantages(adv)
    got = gae.normalize_advantages(torch.from_numpy(adv))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize('h', [12, 32, 37])
def test_vtrace_advantages_fused_matches_composition_and_jax(h):
    """The PPO advantage step as K10 now takes it (the bootstrap, the
    recursion and the reward sums in one pass; on the CPU its plain
    version) is bitwise the composition it replaces
    (``apply_truncation_bootstrap``, the reverse loop, ``adv + v``), and
    agrees with the JAX package's composition to 1e-5."""
    r, d, m, v, nv = _inputs(h, 4)
    adv, sums = gae.vtrace_advantages(*_t(r, d, m, v, nv), 0.99, 0.95, use_kernel=True)
    rb, db = gae.apply_truncation_bootstrap(*_t(r, d, m, v))
    want = gae.gae_vtrace(rb, db, torch.from_numpy(v), torch.from_numpy(nv), 0.99, 0.95)
    assert torch.equal(adv, want)
    assert torch.equal(sums, want + torch.from_numpy(v))
    for got in (gae.vtrace_advantages(*_t(r, d, m, v, nv), 0.99, 0.95),):
        assert torch.equal(got[0], adv) and torch.equal(got[1], sums)
    jr, jd = jgae.apply_truncation_bootstrap(r, d, m, v)
    jadv = jgae.gae_vtrace(jr, jd, v, nv, 0.99, 0.95)
    np.testing.assert_allclose(adv.numpy(), np.asarray(jadv), **TOL)
    np.testing.assert_allclose(sums.numpy(), np.asarray(jadv + v), **TOL)
