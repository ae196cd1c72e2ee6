"""Parity of the port's nets and distributions (``elegantrl_tpu_torch.ops``)
with the JAX package's ``ops/nets.py`` and ``ops/dists.py`` on the same
inputs, made with numpy from a seed.

Tolerance: 1e-6 absolute (plus 1e-5 relative for the MLP, whose f32 dot
products are summed in another order by the two libraries).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elegantrl_tpu.ops import dists as jdists
from elegantrl_tpu.ops.nets import mlp_apply as jmlp_apply, mlp_init as jmlp_init
from elegantrl_tpu_torch.ops import dists
from elegantrl_tpu_torch.ops.nets import (MLP, bind_flat, gelu, linear_init, mlp_apply,
                                          mlp_init, orthogonal_init)

torch.set_num_threads(1)
RNG = np.random.default_rng(0)


def _port_mlp(jparams):
    """A port MLP holding the JAX params (``w`` (in, out) -> weight (out, in))."""
    layers = []
    for w, b in jparams:
        w, b = np.array(w), np.array(b)
        layer = torch.nn.Linear(*w.shape)
        with torch.no_grad():
            layer.weight.copy_(torch.from_numpy(w.T.copy()))
            layer.bias.copy_(torch.from_numpy(b))
        layers.append(layer)
    return MLP(layers)


@pytest.mark.parametrize('dims', [(3, 16, 16, 1), (3, 16, 16, 2), (5, 32, 8, 3)])
def test_mlp_apply_matches_jax(dims):
    jparams = jmlp_init(jax.random.PRNGKey(1), dims, out_std=0.1)
    x = RNG.standard_normal((64, dims[0])).astype(np.float32)
    want = np.asarray(jmlp_apply(jparams, jnp.asarray(x)))
    with torch.no_grad():
        got = mlp_apply(_port_mlp(jparams), torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_gelu_is_the_tanh_form():
    x = np.linspace(-6, 6, 1001, dtype=np.float32)
    np.testing.assert_allclose(gelu(torch.from_numpy(x)).numpy(),
                               np.asarray(jax.nn.gelu(jnp.asarray(x))), atol=1e-6)


def test_normal_logprob_entropy_match_jax():
    x, mean = RNG.standard_normal((2, 128, 2)).astype(np.float32)
    std = np.exp(RNG.uniform(-1, 0.5, (1, 2))).astype(np.float32)
    t = torch.from_numpy
    np.testing.assert_allclose(
        dists.normal_logprob(t(x), t(mean), t(std)).numpy(),
        np.asarray(jdists.normal_logprob(x, mean, std)), atol=1e-6)
    np.testing.assert_allclose(
        dists.normal_entropy(t(std)).numpy(),
        np.asarray(jdists.normal_entropy(std)), atol=1e-6)


def test_categorical_logprob_entropy_match_jax():
    logits = RNG.standard_normal((128, 5)).astype(np.float32)
    action = RNG.integers(0, 5, 128)
    np.testing.assert_allclose(
        dists.categorical_logprob(torch.from_numpy(logits), torch.from_numpy(action)).numpy(),
        np.asarray(jdists.categorical_logprob(logits, jnp.asarray(action))), atol=1e-6)
    np.testing.assert_allclose(
        dists.categorical_entropy(torch.from_numpy(logits)).numpy(),
        np.asarray(jdists.categorical_entropy(logits)), atol=1e-6)


def test_samplers_are_distributed_as_stated():
    gen = torch.Generator().manual_seed(0)
    mean, std = torch.full((20000, 1), 0.5), torch.full((20000, 1), 2.0)
    z = (dists.normal_sample(gen, mean, std) - mean) / std
    assert abs(float(z.mean())) < 0.03 and abs(float(z.std()) - 1.0) < 0.03
    logits = torch.log(torch.tensor([[0.2, 0.3, 0.5]])).expand(20000, 3)
    freq = torch.bincount(dists.categorical_sample(gen, logits), minlength=3) / 20000.0
    np.testing.assert_allclose(freq.numpy(), [0.2, 0.3, 0.5], atol=0.02)


def test_inits_follow_the_jax_package():
    gen = torch.Generator().manual_seed(0)
    hidden = linear_init(gen, 16, 32)
    bound = 1.0 / np.sqrt(16)
    assert hidden.weight.shape == (32, 16)
    assert float(hidden.weight.detach().abs().max()) <= bound
    assert float(hidden.bias.detach().abs().max()) <= bound
    out = orthogonal_init(gen, 32, 4, std=0.5)
    w = out.weight.detach()
    np.testing.assert_allclose((w @ w.T).numpy(), 0.25 * np.eye(4), atol=1e-5)
    np.testing.assert_allclose(out.bias.detach().numpy(), 1e-6)


def test_bind_flat_makes_params_views():
    mlp = mlp_init(torch.Generator().manual_seed(0), (3, 8, 8, 1), out_std=0.5)
    before = [p.detach().clone() for p in mlp.leaves()]
    flat = bind_flat(mlp.leaves(), torch.device('cpu'))
    assert flat.numel() == sum(p.numel() for p in before)
    for p, b in zip(mlp.leaves(), before):
        assert torch.equal(p, b)
    flat.add_(1.0)
    for p, b in zip(mlp.leaves(), before):
        assert torch.allclose(p, b + 1.0)


@pytest.mark.parametrize('form', ['simple', 'softplus'])
def test_tanh_normal_logprobs_match_jax(form):
    """The two squashed-Gaussian logprobs (the ``ActorSAC`` form at the mean
    and the stable softplus form), rtol 1e-5; the softplus form also at
    |x| = 9, where ``1 - tanh(x)^2`` underflows in f32 and the simple form
    is left with the rounding of its 1e-6 guard."""
    rng = np.random.default_rng(4)
    mean = rng.standard_normal((32, 3)).astype(np.float32)
    log_std = rng.uniform(-2, 0.5, (32, 3)).astype(np.float32)
    noise = rng.standard_normal((32, 3)).astype(np.float32)
    pre = (mean + np.exp(log_std) * noise).astype(np.float32)
    pre[0] = [2.0, -2.0, 0.0] if form == 'simple' else [9.0, -9.0, 0.0]
    if form == 'simple':
        got = dists.tanh_normal_logprob_simple(torch.from_numpy(mean),
                                               torch.from_numpy(np.exp(log_std)),
                                               torch.from_numpy(pre))
        want = jdists.tanh_normal_logprob_simple(jnp.asarray(mean), jnp.asarray(np.exp(log_std)),
                                                 jnp.asarray(pre))
    else:
        got = dists.tanh_normal_logprob(torch.from_numpy(log_std), torch.from_numpy(noise),
                                        torch.from_numpy(pre))
        want = jdists.tanh_normal_logprob(jnp.asarray(log_std), jnp.asarray(noise),
                                          jnp.asarray(pre))
    assert got.shape == (32,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
