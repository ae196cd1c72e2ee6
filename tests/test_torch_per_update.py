"""Parity of the PER variant of the port's DDPG/TD3 chunk (K7'; the plain
version ``ddpg_chunk_reference`` with importance weights ``iw``) with the
JAX package's Pallas chunk ``make_ddpg_fused_chunk(per=True)`` called
directly in interpret mode, on identical pre-gathered blocks, weights,
targets, Adam moments, per-step tables and importance weights, with the
last two of five steps invalid; then the weighted TD head gradient that
``csrc/ddpg_update.cu`` writes by hand, against autograd.

Tolerances, as the K7 tests (``tests/test_torch_offpolicy_update.py``):
parameter and target updates (new - old) and Adam moments to rtol 5e-3,
atol 4e-7; objectives to 1e-5; the per-sample TD errors to 1e-5 relative.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elegantrl_tpu.ops.pallas_update import make_ddpg_fused_chunk
from elegantrl_tpu_torch.ops import fused_offpolicy_update as fo
from elegantrl_tpu_torch.ops.nets import ddpg_param_shapes, split_flat

torch.set_num_threads(1)
NET_DIMS = (16, 16)
C, VALID, B = 5, 3, 128
HP = dict(gamma=0.99, tau=5e-3, lr=1e-3, clip_grad=3.0)


def _to_kernel(flat, shapes):
    return tuple(jnp.asarray(x.reshape(-1, 1) if x.dim() == 1 else x)
                 for x in split_flat(torch.as_tensor(flat), shapes))


def _from_kernel(leaves):
    return np.concatenate([np.asarray(x).reshape(-1) for x in leaves])


def _buffers(rng, n):
    p = rng.normal(0, 0.3, n).astype(np.float32)
    return [p, (p + rng.normal(0, 0.01, n)).astype(np.float32),
            rng.normal(0, 1e-3, n).astype(np.float32), rng.uniform(0, 1e-6, n).astype(np.float32)]


@pytest.fixture(scope='module', params=[False, True], ids=['ddpg', 'td3'])
def per_pair(request):
    td3 = request.param
    S, A, E = 3, 2, 8 if td3 else 1
    rng = np.random.default_rng(13)
    act_shapes, cri_shapes = ddpg_param_shapes(S, NET_DIMS, A, E)
    na, nc = (sum(math.prod(s) for s in sh) for sh in (act_shapes, cri_shapes))
    pa, ta, mua, nua = _buffers(rng, na)
    pc, tc, muc, nuc = _buffers(rng, nc)
    base = [pa, pc, ta, tc, mua, muc, nua, nuc]
    shapes = [act_shapes, cri_shapes] * 4
    sb = rng.standard_normal((C, S, B)).astype(np.float32)
    nsb = rng.standard_normal((C, S, B)).astype(np.float32)
    ab = rng.uniform(-1, 1, (C, A, B)).astype(np.float32)
    rb = rng.standard_normal((C, B)).astype(np.float32)
    ud = (rng.random((C, B)) > 0.1).astype(np.float32)
    um = (rng.random((C, B)) > 0.1).astype(np.float32)
    nz = (0.1 * rng.standard_normal((C, A, B))).astype(np.float32)
    iw = rng.uniform(0.2, 1.0, (C, B)).astype(np.float32)
    idx = torch.arange(C)
    bcv = fo.ddpg_bcv(7, 4, idx, VALID, idx % 2 == 0, (idx + 1) // 2 + 1).numpy()
    chunk = make_ddpg_fused_chunk(S, A, B, C, td3=td3, num_ensembles=E, per=True,
                                  interpret=True, **HP)
    out = chunk(*[_to_kernel(x, sh) for x, sh in zip(base, shapes)],
                *[jnp.asarray(x) for x in (sb, nsb, ab)],
                *[jnp.asarray(x[:, None, :]) for x in (rb, ud, um)], jnp.asarray(nz),
                jnp.asarray(bcv), iw=jnp.asarray(iw[:, None, :]))
    want = [_from_kernel(g) for g in out[:8]] + [np.asarray(out[8]), np.asarray(out[9])[:, 0]]
    got = [torch.tensor(x) for x in base]
    objs, td = fo.ddpg_chunk(*got, *[torch.tensor(x) for x in (sb, nsb, ab, rb, ud, um, nz, bcv)],
                             net_dims=NET_DIMS, td3=td3, num_ensembles=E, iw=torch.tensor(iw),
                             **HP)
    return base, want, [x.numpy() for x in got] + [objs.numpy(), td.numpy()]


def test_per_params_and_targets(per_pair):
    base, want, got = per_pair
    for i in range(4):
        np.testing.assert_allclose(got[i] - base[i], want[i] - base[i], rtol=5e-3, atol=4e-7,
                                   err_msg=f'buffer {i}')


def test_per_adam_moments(per_pair):
    _, want, got = per_pair
    for i in range(4, 8):
        np.testing.assert_allclose(got[i], want[i], rtol=5e-3, atol=4e-7, err_msg=f'buffer {i}')


def test_per_objectives(per_pair):
    """The IS-weighted critic loss and the actor's objective on the valid
    steps (on an invalid step the TPU kernel's actor objective reads the
    critic update it discards; the callers weigh it by 0)."""
    _, want, got = per_pair
    np.testing.assert_allclose(got[8][:VALID], want[8][:VALID], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got[8][:, 0], want[8][:, 0], rtol=1e-5, atol=1e-5)


def test_per_td_every_step(per_pair):
    """The per-sample TD errors of all five steps, valid or not."""
    _, want, got = per_pair
    np.testing.assert_allclose(got[9], want[9], rtol=1e-5, atol=1e-5 * np.abs(want[9]).max())


@pytest.mark.parametrize('td3', [False, True], ids=['ddpg', 'td3'])
def test_weighted_td_head_gradient(td3):
    """``d mean(td * iw) / d q`` at the critic's heads, as the kernel writes
    it, against autograd."""
    gen = torch.Generator().manual_seed(3)
    E = 8 if td3 else 1
    qs = torch.randn(32, E, generator=gen)
    label = torch.randn(32, generator=gen)
    um = (torch.rand(32, generator=gen) > 0.2).float()
    iw = torch.rand(32, generator=gen)

    def loss(q):
        if td3:
            td = torch.mean(torch.square(q - label[:, None]), dim=-1) * um
        else:
            td = torch.square(torch.mean(q, dim=-1) * um - label) * um
        return torch.mean(td * iw)

    q = qs.clone().requires_grad_(True)
    want, = torch.autograd.grad(loss(q), q)
    torch.testing.assert_close(fo.ddpg_td_head_grad(qs, label, um, td3, iw), want, rtol=1e-6,
                               atol=1e-7)
