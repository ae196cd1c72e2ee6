"""Parity of the port's off-policy update chunks' plain versions
(``elegantrl_tpu_torch/ops/fused_offpolicy_update.py``: ``dqn_chunk_reference``
for the four DQN nets, ``ddpg_chunk_reference`` for DDPG and TD3) with the
JAX package's Pallas chunks called directly in interpret mode
(``make_dqn_fused_chunk``, ``make_ddpg_fused_chunk``) on identical
pre-gathered blocks, weights, targets, Adam moments and per-step tables,
with the last steps of the chunk invalid; then the backward formulas that
the CUDA kernels write by hand, against autograd.

Tolerances, as the JAX package's own chunk tests
(``tests/test_pallas_update.py:238,297``): parameter and target UPDATES
(new - old) and Adam moments to rtol 5e-3, atol 4e-7; objectives to 1e-5.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elegantrl_tpu.ops.pallas_update import make_ddpg_fused_chunk, make_dqn_fused_chunk
from elegantrl_tpu_torch.ops import fused_offpolicy_update as fo
from elegantrl_tpu_torch.ops.nets import ddpg_param_shapes, dqn_param_shapes, split_flat

torch.set_num_threads(1)
NET_DIMS = (16, 16)
C, VALID, B = 5, 3, 128          # steps 3 and 4 of the chunk are invalid
HP = dict(gamma=0.99, tau=5e-3, lr=1e-3, clip_grad=3.0)


def _to_kernel(flat, shapes):
    """Kernel-layout leaves of a flat buffer: W (out, in), biases (out, 1)."""
    return tuple(jnp.asarray(x.reshape(-1, 1) if x.dim() == 1 else x)
                 for x in split_flat(torch.as_tensor(flat), shapes))


def _from_kernel(leaves):
    return np.concatenate([np.asarray(x).reshape(-1) for x in leaves])


def _buffers(rng, n, count):
    """``count`` flat buffers of n values: params, a nearby target, and warm
    Adam moments (a later step: count 7)."""
    p = rng.normal(0, 0.3, n).astype(np.float32)
    t = (p + rng.normal(0, 0.01, n)).astype(np.float32)
    mu = rng.normal(0, 1e-3, n).astype(np.float32)
    nu = rng.uniform(0, 1e-6, n).astype(np.float32)
    return [p, t, mu, nu][:count]


def _blocks(rng, S, A, discrete):
    sb = rng.standard_normal((C, S, B)).astype(np.float32)
    nsb = rng.standard_normal((C, S, B)).astype(np.float32)
    if discrete:
        act = np.eye(A, dtype=np.float32)[rng.integers(0, A, (C, B))].transpose(0, 2, 1)
    else:
        act = rng.uniform(-1, 1, (C, A, B)).astype(np.float32)
    rb = rng.standard_normal((C, B)).astype(np.float32)
    ud = (rng.random((C, B)) > 0.1).astype(np.float32)
    um = (rng.random((C, B)) > 0.1).astype(np.float32)
    return sb, nsb, np.ascontiguousarray(act), rb, ud, um


@pytest.fixture(scope='module', params=[(False, False), (True, False), (False, True),
                                        (True, True)],
                ids=['dqn', 'doubledqn', 'duelingdqn', 'd3qn'])
def dqn_pair(request):
    twin, duel = request.param
    S, A = 4, 3
    rng = np.random.default_rng(7)
    shapes = dqn_param_shapes(S, NET_DIMS, A, twin, duel)
    n = sum(math.prod(s) for s in shapes)
    base = _buffers(rng, n, 4)
    sb, nsb, oh, rb, ud, um = _blocks(rng, S, A, discrete=True)
    bcv = fo.dqn_bcv(7, torch.arange(C), VALID).numpy()
    chunk = make_dqn_fused_chunk(S, A, B, C, twin=twin, duel=duel, interpret=True, **HP)
    out = chunk(*[_to_kernel(x, shapes) for x in base], jnp.asarray(sb), jnp.asarray(nsb),
                jnp.asarray(oh), *[jnp.asarray(x[:, None, :]) for x in (rb, ud, um)],
                jnp.asarray(bcv))
    want = [_from_kernel(g) for g in out[:4]] + [np.asarray(out[4])]
    got = [torch.tensor(x) for x in base]
    objs = fo.dqn_chunk(*got, *[torch.tensor(x) for x in (sb, nsb, oh, rb, ud, um, bcv)],
                        net_dims=NET_DIMS, twin=twin, duel=duel, **HP)
    return base, want, [x.numpy() for x in got] + [objs.numpy()], (shapes, sb, nsb, oh, rb,
                                                                    ud, um, bcv, twin, duel)


@pytest.fixture(scope='module', params=[False, True], ids=['ddpg', 'td3'])
def ddpg_pair(request):
    td3 = request.param
    S, A, E = 3, 2, 8 if td3 else 1
    rng = np.random.default_rng(11)
    act_shapes, cri_shapes = ddpg_param_shapes(S, NET_DIMS, A, E)
    na, nc = (sum(math.prod(s) for s in sh) for sh in (act_shapes, cri_shapes))
    pa, ta, mua, nua = _buffers(rng, na, 4)
    pc, tc, muc, nuc = _buffers(rng, nc, 4)
    base = [pa, pc, ta, tc, mua, muc, nua, nuc]
    shapes = [act_shapes, cri_shapes] * 4
    sb, nsb, ab, rb, ud, um = _blocks(rng, S, A, discrete=False)
    nz = (0.1 * rng.standard_normal((C, A, B))).astype(np.float32)
    idx = torch.arange(C)
    do_act = idx % 2 == 0
    bcv = fo.ddpg_bcv(7, 4, idx, VALID, do_act, (idx + 1) // 2 + 1).numpy()
    chunk = make_ddpg_fused_chunk(S, A, B, C, td3=td3, num_ensembles=E, interpret=True, **HP)
    out = chunk(*[_to_kernel(x, sh) for x, sh in zip(base, shapes)],
                *[jnp.asarray(x) for x in (sb, nsb, ab)],
                *[jnp.asarray(x[:, None, :]) for x in (rb, ud, um)], jnp.asarray(nz),
                jnp.asarray(bcv))
    want = [_from_kernel(g) for g in out[:8]] + [np.asarray(out[8])]
    got = [torch.tensor(x) for x in base]
    objs = fo.ddpg_chunk(*got, *[torch.tensor(x) for x in (sb, nsb, ab, rb, ud, um, nz, bcv)],
                         net_dims=NET_DIMS, td3=td3, num_ensembles=E, **HP)
    return base, want, [x.numpy() for x in got] + [objs.numpy()], td3


def _assert_updates(base, want, got, n):
    for i in range(n):
        np.testing.assert_allclose(got[i] - base[i], want[i] - base[i], rtol=5e-3, atol=4e-7,
                                   err_msg=f'buffer {i}')


def test_dqn_params_and_target(dqn_pair):
    _assert_updates(*dqn_pair[:3], 2)


def test_dqn_adam_moments(dqn_pair):
    base, want, got, _ = dqn_pair
    for i in (2, 3):
        np.testing.assert_allclose(got[i], want[i], rtol=5e-3, atol=4e-7)


def test_dqn_objectives(dqn_pair):
    _, want, got, _ = dqn_pair
    np.testing.assert_allclose(got[4], want[4], rtol=1e-5, atol=1e-5)


def test_dqn_invalid_steps_leave_state(dqn_pair):
    """The chunk with its last two steps invalid ends bit-identical to the
    first three steps alone."""
    base, _, got, (shapes, sb, nsb, oh, rb, ud, um, bcv, twin, duel) = dqn_pair
    bufs = [torch.tensor(x) for x in base]
    fo.dqn_chunk(*bufs, *[torch.tensor(x[:VALID]) for x in (sb, nsb, oh, rb, ud, um, bcv)],
                 net_dims=NET_DIMS, twin=twin, duel=duel, **HP)
    for a, b in zip(bufs, got):
        np.testing.assert_array_equal(a.numpy(), b)


def test_ddpg_params_and_targets(ddpg_pair):
    _assert_updates(*ddpg_pair[:3], 4)


def test_ddpg_adam_moments(ddpg_pair):
    base, want, got, _ = ddpg_pair
    for i in range(4, 8):
        np.testing.assert_allclose(got[i], want[i], rtol=5e-3, atol=4e-7, err_msg=f'buffer {i}')


def test_ddpg_objectives(ddpg_pair):
    """On the valid steps.  On an invalid step the TPU kernel takes the
    actor's objective through the critic update it then discards; the port
    leaves that critic as it was.  The callers weigh every objective by its
    valid flag, so neither value is used."""
    _, want, got, _ = ddpg_pair
    np.testing.assert_allclose(got[8][:VALID], want[8][:VALID], rtol=1e-5, atol=1e-5)


def test_ddpg_actor_moves_only_on_its_steps(ddpg_pair):
    """Steps 0 and 2 take the actor step, 1 does not, 3 and 4 are invalid: the
    actor and its target moved, the critic moved too."""
    base, _, got, _ = ddpg_pair
    for i in range(4):
        assert np.abs(got[i] - base[i]).max() > 0


# ------------------------------------------- hand-written backward formulas

def _autograd(fn, *xs):
    xs = [x.detach().clone().requires_grad_(True) for x in xs]
    y = fn(*xs)
    return torch.autograd.grad(y, xs)


@pytest.mark.parametrize('A', [2, 9])
def test_dueling_combine_backward(A):
    gen = torch.Generator().manual_seed(A)
    val, adv = torch.randn(6, A, generator=gen), torch.randn(6, 1, generator=gen)
    g = torch.randn(6, A, generator=gen)
    want = _autograd(lambda v, a: torch.sum(fo.dueling_combine(v, a) * g), val, adv)
    got = fo.dueling_combine_backward(g)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize('A', [2, 9])
def test_one_hot_td_gradient(A):
    gen = torch.Generator().manual_seed(A)
    q = torch.randn(32, A, generator=gen)
    onehot = torch.nn.functional.one_hot(torch.randint(0, A, (32,), generator=gen), A).float()
    label, um = torch.randn(32, generator=gen), (torch.rand(32, generator=gen) > 0.2).float()
    want, = _autograd(lambda x: torch.mean(torch.square(torch.sum(x * onehot, -1) - label) * um),
                      q)
    torch.testing.assert_close(fo.td_head_grad(q, onehot, label, um), want, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize('E', [1, 8])
def test_critic_to_action_gradient(E):
    """The actor step's backward through the critic to its inputs (the
    action columns feed tanh' and the actor), as ``csrc/ddpg_update.cu``."""
    S, A = 6, 2
    gen = torch.Generator().manual_seed(E)
    _, shapes = ddpg_param_shapes(S, NET_DIMS, A, E)
    leaves = [torch.randn(s, generator=gen) * 0.4 for s in shapes]
    xin = torch.randn(10, S + A, generator=gen)
    g_out = torch.full((10, E), -1.0 / (10 * E))
    from elegantrl_tpu_torch.ops.nets import mlp_apply_leaves
    want, = _autograd(lambda x: torch.sum(mlp_apply_leaves(leaves, x) * g_out), xin)
    torch.testing.assert_close(fo.mlp_input_grad(leaves, xin, g_out), want, rtol=1e-5,
                               atol=1e-7)


def test_tanh_backward():
    gen = torch.Generator().manual_seed(0)
    pre, g = torch.randn(10, 3, generator=gen), torch.randn(10, 3, generator=gen)
    want, = _autograd(lambda x: torch.sum(torch.tanh(x) * g), pre)
    torch.testing.assert_close(fo.tanh_backward(torch.tanh(pre), g), want, rtol=1e-6,
                               atol=1e-7)
